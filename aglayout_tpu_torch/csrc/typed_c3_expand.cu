// Typed c3 of the 128^2 layout encoder: the c3 conv on an object's c2 type
// grid, bn3 affine + relu, and the expansion to the dense c3 output.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_typed_expand.py::typed_c3_expand_v4. Per object
// (one of B * O), with z2 its (12, 12, c2) grid of c2 values by (row type,
// col type) and w3 the (c4, c2, 4, 4) c3 weight:
//   W3z[a, l, w, C] = sum_{h, c} z2[idxR[a, h], l, c] * w3[C, c, h, w]
//                     (a < 14 row windows, l < 12; idxR == 12 gives zero)
//   V3[a, b, C]     = relu(a3[C] * sum_w W3z[a, lsel[b, w], w, C] + b3[C])
//                     (lsel >= 12 gives zero)
//   out[C, y, x]    = V3[selR[y], selC[x], C]           (NCHW, s3 x s3)
// The Pallas kernel writes every stage as a matmul with block-diagonal
// one-hot selectors, the TPU's way to gather; here the gathers are
// addresses.
//
// What bounds it on the H100: at 128^2, B*O = 1280, c2 = 128, c4 = 256 the
// first stage is a (168 x 512) x (512 x 1024) product per object, 225 GFLOP
// per batch: 0.23 ms at the bf16 tensor-core peak. The output is 671 MB in
// bf16, 0.2 ms at 3.35 TB/s. Run one after the other by all the threads of a
// block (copy the weights, multiply, sum the windows, store), the stages
// leave every unit idle most of the time: no tensor core works while the
// weights come, no store is in flight while the tensor cores work (the f32
// kernel below is built so). The bf16 kernel (namespace tc) is one
// persistent block an SM that walks over the objects, its warps specialised
// and joined by mbarriers, so that all the stages run at once:
//   - one warp asks the copy engine for the weights, a 16 KB slice (128
//     columns (w, ci) of a 32-channel chunk x 64 of the reduction) per
//     descriptor-free cp.async.bulk, into a ring of three stages, as far
//     ahead of the product as the ring has room, across chunk and object
//     boundaries. The host packs the weights in exactly this order, each row
//     with the 128-byte swizzle the tensor cores read without bank conflicts
//     (ops/typed_expand.pack_typed_c3_weights);
//   - three warpgroups multiply, 64 of the 168 (padded to 192) rows (a, l)
//     each, on wgmma m64n128k16: the A operand from registers, loaded by
//     ldmatrix straight from the gathered rows of the object's grid tile in
//     shared memory (the gather stays an address; rows past 168 and taps
//     outside the image read a zero row), the B operand read from the ring by
//     the tensor cores themselves, f32 sums in 64 registers a thread. mma.sync
//     with ldmatrix for both operands would ask shared memory for 256
//     wavefronts per 192 tensor-core clocks; wgmma asks for 144. A finished
//     chunk's W3z, rounded to bf16, goes to shared memory for the epilogue
//     warps;
//   - three epilogue warps turn W3z into V3 (the sum over the column windows,
//     affine, relu) and V3 into the chunk's part of the output, while the
//     next chunk is multiplied. The output rows of one channel and row type
//     are equal, so each row type is expanded along x once and every output
//     row is a 16-byte-a-thread copy of one of them into a staging buffer of 8
//     channels' planes, which leaves as one 16 KB copy by the copy engine:
//     the warps never wait for the 671 MB to drain.
// W3z and V3 never leave the SM, and the kernel needs no device scratch.
// The registers set the shape: 16 warps, four a scheduler, have 128 each,
// which the consumers' 64 accumulators and A fragments need; so there are
// only three epilogue warps, and their latency chains, not the tensor cores,
// bound the kernel (PERF.md has the stage times).
// In f32 the product runs on FMAs (CC = 8), one block an object, the stages
// one after the other: a reference path.
// Shapes: any c2 % 16 == 0 (c2 / 16 slices of 64 k), c4 % 16 == 0 (a last
// chunk of 16 channels multiplies zero weights in its upper half) and s3 % 8
// == 0, as far as a block's shared memory holds the grid tile: where K5's
// buffers do not fit beside a wide grid tile or a large s3, the row types
// along x are held for 16 or 8 channels at a time and the staging buffers
// shrink to 8 KB (`Layout`); the sums are the same, so are the bits. At the
// 128^2 model that takes conv_dim 64, 96 and 128 (c2 = 2 conv_dim).
// The same kernel replaces pallas_typed_expand.py::typed_c3_expand_v5, whose
// one product over all row types of an object is what its three warpgroups
// already do: typed_c3_expand_v5 launches it as it is, bit for bit K5.
// It replaces pallas_typed_expand.py::typed_c3_expand (v3) too, which takes
// the grid zero-padded to 13 x 13: the kernel reads the 12 x 12 grid in
// place from each 13-wide row (the `side` argument), and its taps of row
// and column 12 are the zeros it gives idxR == 12 and lsel >= 12 (as JAX's
// v4 reads a padded grid, pallas_typed_expand.py:349-357); v3's group of
// objects a program is the TPU's way to fill the MXU and has no counterpart
// in the persistent schedule. typed_c3_expand_v3 launches it as it is, bit
// for bit K5 on the grid's inner 12 x 12.
// It also replaces pallas_typed_expand.py::typed_c3_expand_v6, whose
// idea is to skip a row type that no output row has (typed_c3_expand_v6, the
// V6 instantiation): the present types' rows are compacted, so a warpgroup
// whose 64 rows hold none only lets the weight stages pass, and the epilogue
// sums V3 and expands along x those types alone. The rows' sums are K5's, in
// K5's order, so the two agree bit for bit. On the layouts the 128^2 path
// makes, an object has about 8 of the 14 types (two warpgroups of three).
// Numerics, as the Pallas kernel: products of compute-dtype operands summed
// in f32, W3z rounded to the compute dtype; the sum over w in f32, affine
// and relu in f32, V3 rounded to the compute dtype; the expansion copies.

#include "typed_c3.cuh"

namespace {

using namespace typed;

constexpr int M = NA * NZ;     // rows (a, l) of W3z
constexpr int ZROW = NZ * NZ;  // index of the zero row of the grid tile

// The f32 kernel. Shared memory, in bytes: the grid tile; then the chunk's w3
// slice, which W3z and V3 overwrite after the product; then the index tables.
template <typename T>
__host__ __device__ inline size_t big_bytes(int c2) {
  constexpr int N = Cfg<T>::CC * KW;
  const size_t w3z = (size_t)M * N * sizeof(T), v3 = (size_t)Cfg<T>::CC * NA * NA * sizeof(T);
  const size_t bt = btile_bytes<T>(c2);
  return align16(bt > w3z + v3 ? bt : w3z + v3);
}
template <typename T>
__host__ __device__ inline size_t smem_bytes(int c2, int s3) {
  return align16((size_t)(ZROW + 1) * zstride(c2) * sizeof(T)) + big_bytes<T>(c2) +
         (size_t)(2 * NA * KW + 2 * s3) * sizeof(int);
}

// z2: (n, side, side, c2) T, side 12 or 13 (of which the 12 x 12 are read);
// idxR, lsel: (n, 14, 4) i32; selR, selC: (n, s3) i32; ab: (n, 2, c4) f32;
// wk: (c4, KW, KW * c2) T, rows (C, w), columns (h, c); out: (n, c4, s3, s3)
// T. Grid (n).
template <typename T>
__global__ void __launch_bounds__(THREADS)
typed_c3_expand_kernel(const T* __restrict__ z2, const int* __restrict__ idxR,
                       const int* __restrict__ lsel, const int* __restrict__ selR,
                       const int* __restrict__ selC, const float* __restrict__ ab,
                       const T* __restrict__ wk, T* __restrict__ out, int c2, int c4, int s3,
                       int side) {
  constexpr int CC = Cfg<T>::CC, N = CC * KW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);
  unsigned char* big = smem_raw + align16((size_t)(ZROW + 1) * zstride(c2) * sizeof(T));
  T* bs = reinterpret_cast<T*>(big);
  T* ws = reinterpret_cast<T*>(big);                   // [M][N], after the product
  T* v3 = reinterpret_cast<T*>(big + M * N * sizeof(T));  // [CC][NA][NA]
  int* zrow0 = reinterpret_cast<int*>(big + big_bytes<T>(c2));  // [NA][KW]
  int* lsl = zrow0 + NA * KW;                                   // [NA][KW]
  int* sr = lsl + NA * KW;                                      // [s3]
  int* sc = sr + s3;                                            // [s3]
  const int obj = blockIdx.x, tid = threadIdx.x;

  for (int i = tid; i < NA * KW; i += THREADS) {
    const int idx = idxR[obj * NA * KW + i];
    zrow0[i] = (idx >= 0 && idx < NZ) ? idx * NZ : -1;
    lsl[i] = lsel[obj * NA * KW + i];
  }
  for (int i = tid; i < s3; i += THREADS) {
    sr[i] = selR[obj * s3 + i];
    sc[i] = selC[obj * s3 + i];
  }
  load_grid(z2 + (size_t)obj * side * side * c2, zs, c2, side, tid, THREADS);
  for (int i = tid; i < c2; i += THREADS) zs[ZROW * zstride(c2) + i] = agl::from_f<T>(0.f);

  const float* a3 = ab + (size_t)obj * 2 * c4;
  const float* b3 = a3 + c4;
  for (int c0 = 0; c0 < c4; c0 += CC) {
    __syncthreads();  // the tables and zs are in; the previous chunk is written out
    load_w3<CC>(wk, bs, c0, c2);
    __syncthreads();
    chunk_product<NZ>(zs, bs, ws, zrow0, c2, ZROW);
    __syncthreads();
    v3_from_w3z<T, NZ>(ws, lsl, a3 + c0, b3 + c0, v3, CC);
    __syncthreads();
    expand_store(v3, sr, sc, out + ((size_t)obj * c4 + c0) * s3 * s3, CC, s3);
  }
}

template <typename T>
cudaError_t launch(const void* z2, const void* idxR, const void* lsel, const void* selR,
                   const void* selC, const void* ab, const void* wk, void* out, int n, int c2,
                   int c4, int s3, int side, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(c2, s3);
  cudaError_t err = cudaFuncSetAttribute(typed_c3_expand_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  typed_c3_expand_kernel<T><<<n, THREADS, smem, stream>>>(
      static_cast<const T*>(z2), static_cast<const int*>(idxR), static_cast<const int*>(lsel),
      static_cast<const int*>(selR), static_cast<const int*>(selC), static_cast<const float*>(ab),
      static_cast<const T*>(wk), static_cast<T*>(out), c2, c4, s3, side);
  return cudaGetLastError();
}

// ---- bf16: one persistent, warp-specialised block an SM -------------------
namespace tc {

// wgmma: the warpgroup-wide asynchronous product of Hopper's tensor cores.
// d (64 x 128 f32, spread over the 128 threads: thread (warp w, lane l) holds
// rows 16 w + l / 4 and + 8, and of column tile j the columns 8 j + 2 (l % 4)
// and + 1, in d[4 j .. 4 j + 3] as mma.sync would) (+)= a (64 x 16 bf16 from
// registers, each warp its 16 rows as an mma.sync m16n8k16 A fragment) times
// b (16 x 128 bf16 in shared memory, named by a descriptor). With scale_d == 0
// d is overwritten.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
// Orders earlier register writes (A fragments, accumulators) before the wgmmas that follow.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Waits until every committed group of wgmmas is done: their results are in
// the registers, and their operands may be overwritten.
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Descriptor of a K-major operand tile in shared memory with the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), the 16-byte pieces of row n at piece ^
// (n % 8), groups of 8 rows 1024 bytes apart; the tile 1024-byte aligned, or
// advanced by 32 bytes per 16 k inside a row.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

constexpr int WGS = 3;               // consumer warpgroups, 64 rows of W3z each (192 >= 168)
constexpr int CONSUMERS = 4 * WGS;   // warps that multiply
constexpr int EPILOGUE = 3;          // warps that turn W3z into V3 and store the expansion
// ... and one that asks for the weights: 16 warps, 4 a scheduler, 128 registers each
constexpr int THREADS = 32 * (CONSUMERS + EPILOGUE + 1);
constexpr int CC = 32, N = CC * KW;  // channels and W3z columns (w, ci) a chunk
constexpr int KS = 64;               // reduction depth of a ring stage
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = N * KS * 2;
constexpr int WSTRIDE = N + 8;  // elements between two W3z rows: fragment stores meet no conflict
constexpr int V3A = NA + 1, V3B = 16;  // V3 rows and columns a channel, with the zero ones
constexpr int PLANE_BYTES = 16384;     // one of the two staging buffers of finished output planes

// ech: channels whose row types along x are held at a time (erows); plane:
// bytes of a staging buffer. K5's own (32, 16 KB) wherever they fit, so that
// the shapes it always took keep its schedule; at a wider c2, s3 or c4 the
// largest that fit.
struct Layout {
  int ech, plane, bars, ring, zs, w3z, v3, erows, rows, ab, ints, total;
};
__host__ __device__ inline Layout layout_at(int c2, int c4, int s3, int ech, int plane) {
  Layout l;
  l.ech = ech;
  l.plane = plane;
  l.bars = 0;     // full[STAGES], empty[STAGES], wfull, wempty
  l.ring = 1024;  // [STAGES][N][KS] bf16, the 16-byte pieces of row n at piece ^ (n % 8)
  l.zs = l.ring + STAGES * STAGE_BYTES;                               // [145][c2 + 8] bf16
  l.w3z = l.zs + (int)align16((size_t)(ZROW + 1) * zstride(c2) * 2);  // [M][WSTRIDE] bf16
  l.v3 = l.w3z + M * WSTRIDE * 2;                                     // [CC][V3A][V3B] bf16
  l.erows = l.v3 + CC * V3A * V3B * 2;    // [ech][V3A][s3] bf16: a channel group's row types along x
  l.rows = l.erows + ech * V3A * s3 * 2;  // [2][channels][s3][s3] bf16: output planes on their way out
  l.ab = l.rows + 2 * plane;              // [2][c4] f32: the object's bn3 affine
  l.ints = l.ab + 2 * c4 * 4;              // zrow0[56], lsl[56], sr[s3]
  l.total = l.ints + (2 * NA * KW + s3) * 4;
  return l;
}
__host__ __device__ inline Layout layout(int c2, int c4, int s3) {
  for (int plane = PLANE_BYTES; plane >= PLANE_BYTES / 2; plane /= 2)
    for (int ech = CC; ech >= 8; ech /= 2) {
      const Layout l = layout_at(c2, c4, s3, ech, plane);
      if (l.total <= agl::SMEM_LIMIT && 2 * s3 * s3 <= plane) return l;
    }
  Layout l = layout_at(c2, c4, s3, 8, PLANE_BYTES / 2);
  l.total = agl::SMEM_LIMIT + 1;  // nothing fits: the launch is refused
  return l;
}

// The row types of an object's output rows (selR) in increasing order, four
// bits each (slot j in bits 4 j .. 4 j + 3), and their count; a type outside
// [0, 14) is no row type. Called by whole warps: each lane reads s3 / 32 rows.
__device__ __forceinline__ uint64_t present_types(const int* sel, int s3, int& count) {
  unsigned m = 0;
  for (int y = threadIdx.x & 31; y < s3; y += 32) {
    const int a = sel[y];
    if (a >= 0 && a < NA) m |= 1u << a;
  }
  m = __reduce_or_sync(0xffffffffu, m);
  uint64_t slots = 0;
  count = 0;
  for (int a = 0; a < NA; ++a)
    if (m >> a & 1) slots |= (uint64_t)a << (4 * count++);
  return slots;
}
__device__ __forceinline__ int type_at(uint64_t slots, int j) { return (int)(slots >> (4 * j)) & 15; }

// z2: (n, side, side, c2), side 12 or 13 (v3's zero-padded grid, whose 12 x
// 12 are read in place); idxR, lsel: (n, 14, 4) i32; selR, selC: (n, s3) i32;
// ab: (n, 2, c4) f32; wp: (c4 / 32, 4 c2 / 64, 128, 64) bf16, the packed
// weights [chunk][k slice][(w, ci)][k], k = h * c2 + c, the 16-byte pieces of
// a row swizzled as in the ring; out: (n, c4, s3, s3). Grid: one block an SM,
// each walking over objects blockIdx.x, blockIdx.x + gridDim.x, ...
// V6 (typed_c3_expand_v6's schedule): W3z only for the row types the
// object's selR names, their rows (a, l) compacted in the order of a, so
// that a warpgroup whose 64 rows hold none of them skips the product, and
// the epilogue sums V3 and expands along x those types alone. The row sums
// are K5's, taken in K5's order.
// G: the general epilogue and `layout`'s buffers, for a chunk group of fewer
// than 32 channels, 8 KB staging buffers, an s3 that is not a power of two or
// whose column groups do not divide the 96 epilogue threads, and a last chunk
// of 16; K5's own shapes keep the instructions the kernel always ran
// (`launch` chooses).
template <bool V6, bool G>
__global__ void __launch_bounds__(THREADS, 1)
typed_c3_expand_tc_kernel(const __nv_bfloat16* __restrict__ z2, const int* __restrict__ idxR,
                          const int* __restrict__ lsel, const int* __restrict__ selR,
                          const int* __restrict__ selC, const float* __restrict__ ab,
                          const __nv_bfloat16* __restrict__ wp, __nv_bfloat16* __restrict__ out,
                          int n, int c2, int c4, int s3, int side) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char smem[];
  // K5's shapes: K5's layout in closed form (a choice made in a loop would
  // hold its offsets in registers the V6 schedule does not have)
  const Layout L = G ? layout(c2, c4, s3) : layout_at(c2, c4, s3, CC, PLANE_BYTES);
  T* zs = reinterpret_cast<T*>(smem + L.zs);
  T* v3 = reinterpret_cast<T*>(smem + L.v3);
  int* zrow0 = reinterpret_cast<int*>(smem + L.ints);  // [NA][KW]
  int* lsl = zrow0 + NA * KW;                          // [NA][KW]
  int* sr = lsl + NA * KW;                             // [s3]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto full = [&](int st) { return agl::smem_u32(smem + L.bars + st * 8); };
  auto empty = [&](int st) { return agl::smem_u32(smem + L.bars + (STAGES + st) * 8); };
  const uint32_t wfull = agl::smem_u32(smem + L.bars + 2 * STAGES * 8);
  const uint32_t wempty = wfull + 8;
  T* w3z = reinterpret_cast<T*>(smem + L.w3z);
  const int nslices = KW * c2 / KS, nchunks = (c4 + CC - 1) / CC;  // a last chunk may hold 16

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      agl::mbar_init(full(st), 1);           // the producer's arrival, with the bytes
      agl::mbar_init(empty(st), CONSUMERS);  // one arrival a consumer warp
    }
    agl::mbar_init(wfull, CONSUMERS);
    agl::mbar_init(wempty, 1);
    agl::mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS + EPILOGUE) {
    // ---- producer: the weight slices of every chunk of every object, in the
    // order the consumers take them, as far ahead as the ring has room
    if (lane != 0) return;
    int it = 0;
    for (int obj = blockIdx.x; obj < n; obj += gridDim.x)
      for (int sl = 0; sl < nchunks * nslices; ++sl, ++it) {
        const int st = it % STAGES;
        agl::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);  // passes at once the first time round
        agl::mbar_arrive_expect_tx(full(st), STAGE_BYTES);
        agl::bulk_copy_g2s(agl::smem_u32(smem + L.ring + st * STAGE_BYTES),
                           wp + (size_t)sl * N * KS, STAGE_BYTES, full(st));
      }
    return;
  }

  if (warp < CONSUMERS) {
    // ---- consumers: W3z of a chunk = (192 x 4 c2) x (4 c2 x 128) on wgmma,
    // warpgroup wg rows 64 wg .. 64 wg + 63 (rows past 168 read the zero row).
    // A comes from registers, loaded by ldmatrix straight from the gathered
    // grid rows, so the gather stays an address; B is the ring stage, read by
    // the tensor cores themselves.
    constexpr int CT = 32 * CONSUMERS;
    const int g = lane >> 2, t = lane & 3, zs_ = zstride(c2);
    const int mrow = warp * 16;  // this warp's 16 rows of W3z
    // ldmatrix x4: lane supplies row lane % 16 of the warp's tile, k offset 8 (lane / 16)
    auto rowaddr = [&](int h) {
      return agl::smem_u32(zs + zrow<NZ>(zrow0, mrow + (lane & 15), h, ZROW) * zs_ + (lane >> 4) * 8);
    };
    int it = 0, q = 0;
    for (int obj = blockIdx.x; obj < n; obj += gridDim.x) {
      agl::named_barrier(1, CT);  // every consumer is done with the previous grid
      uint64_t types = 0;
      int tcount = NA;
      if constexpr (V6) types = present_types(selR + obj * s3, s3, tcount);
      // this warpgroup's 64 rows hold a row type to multiply
      const bool active = !V6 || 64 * (warp >> 2) < tcount * NZ;
      for (int i = tid; i < NA * KW; i += CT) {
        if constexpr (V6) {  // slot j holds the j-th present type; slots past them the zero row
          const int j = i / KW;
          const int idx = j < tcount ? idxR[(obj * NA + type_at(types, j)) * KW + i % KW] : -1;
          zrow0[i] = (idx >= 0 && idx < NZ) ? idx * NZ : -1;
        } else {
          const int idx = idxR[obj * NA * KW + i];
          zrow0[i] = (idx >= 0 && idx < NZ) ? idx * NZ : -1;
        }
      }
      load_grid(z2 + (size_t)obj * side * side * c2, zs, c2, side, tid, CT);
      for (int i = tid; i < c2; i += CT) zs[ZROW * zs_ + i] = __float2bfloat16_rn(0.f);
      agl::named_barrier(1, CT);

      for (int ch = 0; ch < nchunks; ++ch, ++q) {
        if (!active) {  // v6: no row of this warpgroup's 64 has a type; the stages pass by
          for (int sl = 0; sl < nslices; ++sl, ++it) {
            agl::mbar_wait(full(it % STAGES), (it / STAGES) & 1);
            if (lane == 0) agl::mbar_arrive(empty(it % STAGES));
          }
          agl::mbar_wait(wempty, (q & 1) ^ 1);
          __syncwarp();
          if (lane == 0) agl::mbar_arrive(wfull);
          continue;
        }
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        uint32_t afr[2][KS / 16][4];  // the A fragments of two slices
        int hn = 0, cn = 0;           // k = hn * c2 + cn: the next 16 k to load
        uint32_t arow = rowaddr(0);
        auto load_a = [&](uint32_t (&dst)[KS / 16][4]) {
#pragma unroll
          for (int kk = 0; kk < KS / 16; ++kk) {
            agl::ldmatrix_x4(arow + cn * 2, dst[kk]);
            cn += 16;
            if (cn == c2) {
              cn = 0;
              if (++hn < KW) arow = rowaddr(hn);
            }
          }
        };
        // One slice: its four wgmmas go off, the next slice's A fragments are
        // loaded into the other registers while they run, then the stage is
        // handed back.
        auto slice = [&](int sl, const uint32_t (&cur)[KS / 16][4], uint32_t (&next)[KS / 16][4]) {
          const int st = it % STAGES;
          agl::mbar_wait(full(st), (it / STAGES) & 1);
          const uint32_t bbase = agl::smem_u32(smem + L.ring + st * STAGE_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS / 16; ++kk)
            wgmma_m64n128k16(acc, cur[kk], wgmma_desc_sw128(bbase + kk * 32), (sl | kk) != 0);
          wgmma_commit();
          if (sl + 1 < nslices) load_a(next);
          wgmma_wait_all();
          if (lane == 0) agl::mbar_arrive(empty(st));  // this warp's share of the stage is read
          ++it;
        };
        load_a(afr[0]);
        for (int sl = 0; sl < nslices; sl += 2) {
          slice(sl, afr[0], afr[1]);
          if (sl + 1 < nslices) slice(sl + 1, afr[1], afr[0]);
        }
        // hand the chunk's W3z, rounded once, to the epilogue warps, which
        // took the previous chunk's while this one was multiplied
        agl::mbar_wait(wempty, (q & 1) ^ 1);
        T* ws = w3z;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = mrow + g + 8 * half;
            if (m < M)
              *reinterpret_cast<__nv_bfloat162*>(ws + m * WSTRIDE + j * 8 + 2 * t) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
          }
        __syncwarp();
        if (lane == 0) agl::mbar_arrive(wfull);
      }
    }
    return;
  }

  // ---- epilogue: V3 of a chunk from its W3z, then the expansion, while the
  // consumers multiply the next chunk. Three warps, one a scheduler, so each
  // operation and each exposed latency counts:
  //   - the W3z columns are (w, ci), which makes a V3 item 8 channels wide
  //     (four 16-byte loads); two items at a time, every load written ahead
  //     of the first store (the compiler cannot tell the buffers apart and
  //     keeps a load behind an earlier store);
  //   - V3 has a zero row and zero columns 14, 15 for the types outside
  //     [0, 14), so the expansion selects nothing;
  //   - the output rows of one channel and row type are equal: the 15 row
  //     types of a group of the chunk's channels (all 32 where shared memory
  //     allows, `Layout::ech`) are expanded along x once, 8 two-byte gathers
  //     a 16-byte vector with the thread's 8 column offsets in registers, and
  //     every output row is then a copy of one of them, 16 bytes a load and a
  //     store, into a staging buffer of a few channels' planes (a piece, 16 KB
  //     or, where shared memory is short, 8 KB);
  //   - each piece leaves as one copy by the copy engine while the next is
  //     written: the warps do not wait for the 671 MB to drain, which stores
  //     from registers made them do.
  // Any s3 % 8 == 0: an output row index is split into (channel, y) by a
  // multiplication (`s3inv`), and where s3 / 8 does not divide the 96 threads
  // the last few skip the row loops. A last chunk of 16 channels (c4 % 32 ==
  // 16) multiplies zero weights in its upper half and expands its 16 alone.
  constexpr int ET = 32 * EPILOGUE, U = 4;
  const int et = tid - 32 * CONSUMERS;
  float* abs_ = reinterpret_cast<float*>(smem + L.ab);
  const int xv = s3 / 8, x8 = et % xv, rstep = ET / xv;  // a thread keeps one 16-byte column group
  const int rfirst = et < rstep * xv ? et / xv : 1 << 30;  // this thread's first row, if any
  const uint32_t s3inv = 0xffffffffu / s3 + 1;  // r / s3 == __umulhi(r, s3inv) for r < 2^16
  const int ls3 = 31 - __clz(s3);               // ... == r >> ls3 where s3 is a power of two
  char* erows = reinterpret_cast<char*>(smem + L.erows);
  const int ech = L.ech;
  int sch = CC;  // channels a piece
  while (sch * s3 * s3 * 2 > L.plane) sch >>= 1;
  auto pack2 = [](T lo, T hi) {
    const __nv_bfloat162 h = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  };
  for (int i = et; i < CC * V3A * V3B; i += ET) v3[i] = __float2bfloat16_rn(0.f);
  int q = 0, piece = 0;
  for (int obj = blockIdx.x; obj < n; obj += gridDim.x) {
    uint64_t types = 0;
    int tcount = NA;
    if constexpr (V6) types = present_types(selR + obj * s3, s3, tcount);
    agl::named_barrier(2, ET);  // the previous object's planes are written: sr is free
    for (int i = et; i < NA * KW; i += ET) lsl[i] = lsel[obj * NA * KW + i];
    for (int i = et; i < s3; i += ET) {
      const int a = selR[obj * s3 + i];
      sr[i] = (a >= 0 && a < NA) ? a : NA;  // NA: the zero row
    }
    for (int i = et; i < 2 * c4; i += ET) abs_[i] = ab[(size_t)obj * 2 * c4 + i];
    int soff[8];  // byte offsets of this thread's 8 column types in a V3 row; NA: a zero column
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int bcol = selC[obj * s3 + x8 * 8 + e];
      soff[e] = ((bcol >= 0 && bcol < NA) ? bcol : NA) * 2;
    }
    agl::named_barrier(2, ET);
    for (int ch = 0; ch < nchunks; ++ch, ++q) {
      const float* a3 = abs_ + ch * CC;
      const float* b3 = a3 + c4;
      const int cch = G && c4 - ch * CC < CC ? c4 - ch * CC : CC;  // the chunk's channels
      agl::mbar_wait(wfull, q & 1);
      const T* ws = w3z;
      constexpr int ITEMS = NA * NA * (CC / 8);  // item: (a, bcol, 8 channels)
      const int items = V6 ? tcount * NA * (CC / 8) : ITEMS;  // v6: a is the compact slot
      for (int i0 = et; i0 < items; i0 += 2 * ET) {
        agl::Vec16<T> v[2][KW];
        float av[2][8], bv[2][8];
        int dst[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u * ET < items ? i0 + u * ET : i0;
          const int cg = i % (CC / 8), bcol = (i / (CC / 8)) % NA, a = i / (CC / 8 * NA);
          dst[u] = (cg * 8 * V3A + (V6 ? type_at(types, a) : a)) * V3B + bcol;
#pragma unroll
          for (int w = 0; w < KW; ++w) {
            const int l = lsl[bcol * KW + w];
            v[u][w].raw = make_uint4(0, 0, 0, 0);  // a tap outside the image adds zero
            if (l >= 0 && l < NZ)
              v[u][w].raw =
                  *reinterpret_cast<const uint4*>(ws + (a * NZ + l) * WSTRIDE + w * CC + cg * 8);
          }
          agl::load4(a3 + cg * 8, av[u]);
          agl::load4(a3 + cg * 8 + 4, av[u] + 4);
          agl::load4(b3 + cg * 8, bv[u]);
          agl::load4(b3 + cg * 8 + 4, bv[u] + 4);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (i0 + u * ET < items && (!G || (i0 + u * ET) % (CC / 8) * 8 < cch))
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              float sum = 0.f;
#pragma unroll
              for (int w = 0; w < KW; ++w) sum += __bfloat162float(v[u][w].v()[e]);
              v3[dst[u] + e * V3A * V3B] =
                  __float2bfloat16_rn(fmaxf(sum * av[u][e] + bv[u][e], 0.f));
            }
      }
      agl::named_barrier(2, ET);  // V3 is whole, and nobody reads this W3z any more
      if (et == 0) agl::mbar_arrive(wempty);
      for (int e0 = 0; e0 < (G ? cch : CC); e0 += (G ? ech : CC)) {
        // the group's channels, a power of two
        const int gsz = !G ? CC : cch - e0 < ech ? cch - e0 : ech;
        const int lg = G ? 31 - __clz(gsz) : 5;
        // the group's row types (ci, a), a = 14 the zero row, along x: row j
        // of `erows` is row (ci - e0, a) of V3 gathered at this thread's
        // columns (v6: the present types and the zero row only, j = slot *
        // gsz + ci - e0)
        const int nrows = V6 ? gsz * (tcount + 1) : gsz * V3A;
        auto erow = [&](int j) {  // (the V3 row, the erows row) of j
          if constexpr (V6) {
            const int slot = j >> lg, cl = j & (gsz - 1);
            const int a = slot < tcount ? type_at(types, slot) : NA;
            return make_int2((e0 + cl) * V3A + a, cl * V3A + a);
          } else {
            return make_int2(e0 * V3A + j, j);
          }
        };
        for (int j = G ? rfirst : et / xv; j < nrows; j += rstep * U) {
          uint4 v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int ju = erow(j + u * rstep < nrows ? j + u * rstep : j).x;
            const char* src = reinterpret_cast<const char*>(v3) + ju * (V3B * 2);
            T g[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) g[e] = *reinterpret_cast<const T*>(src + soff[e]);
            v[u] = make_uint4(pack2(g[0], g[1]), pack2(g[2], g[3]), pack2(g[4], g[5]), pack2(g[6], g[7]));
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (j + u * rstep < nrows)
              *reinterpret_cast<uint4*>(erows + (erow(j + u * rstep).y * s3 + x8 * 8) * 2) = v[u];
        }
        const int psz = sch < gsz ? sch : gsz;  // channels a piece
        for (int c0 = e0; c0 < e0 + gsz; c0 += psz, ++piece) {
          char* plane = reinterpret_cast<char*>(smem + L.rows + (piece & 1) * L.plane);
          if (et == 0) agl::bulk_wait_read<1>();  // the copy before the last has read this buffer
          agl::named_barrier(2, ET);  // the row types are whole, the staging buffer is free
          // output row r = (ci, y) of the piece: a copy of row type (ci, selR[y])
          const int nr = psz * s3, cl0 = c0 - e0;
          for (int r = G ? rfirst : et / xv; r < nr; r += rstep * U) {
            uint4 v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int ru = r + u * rstep < nr ? r + u * rstep : r;
              const int ci = G ? (int)__umulhi(ru, s3inv) : ru >> ls3;
              const int y = G ? ru - ci * s3 : ru & (s3 - 1);
              v[u] = *reinterpret_cast<const uint4*>(erows + (((cl0 + ci) * V3A + sr[y]) * s3 + x8 * 8) * 2);
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (r + u * rstep < nr)
                *reinterpret_cast<uint4*>(plane + ((r + u * rstep) * s3 + x8 * 8) * 2) = v[u];
          }
          agl::fence_proxy_async();   // the copy engine reads what these threads wrote
          agl::named_barrier(2, ET);  // the piece is whole (after the group's last: the row types are free)
          if (et == 0) {
            agl::bulk_copy_s2g(out + ((size_t)obj * c4 + ch * CC + c0) * s3 * s3, agl::smem_u32(plane),
                               psz * s3 * s3 * 2);
            agl::bulk_commit();
          }
        }
      }
    }
  }
  if (et == 0) agl::bulk_wait_read<0>();  // the copy engine is done with this block's shared memory
}

template <bool V6>
cudaError_t launch(const void* z2, const void* idxR, const void* lsel, const void* selR,
                   const void* selC, const void* ab, const void* wp, void* out, int n, int c2,
                   int c4, int s3, int side, cudaStream_t stream) {
  using T = __nv_bfloat16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const Layout l = layout(c2, c4, s3);
  // the kernel without G places its buffers by layout_at(c2, c4, s3, CC, PLANE_BYTES)
  const bool general = l.ech != CC || l.plane != PLANE_BYTES || (s3 & (s3 - 1)) ||
                       (32 * EPILOGUE) % (s3 / 8) || c4 % CC;
  auto kernel = general ? typed_c3_expand_tc_kernel<V6, true> : typed_c3_expand_tc_kernel<V6, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.total);
  if (err != cudaSuccess) return err;
  kernel<<<n < sms ? n : sms, THREADS, l.total, stream>>>(
      static_cast<const T*>(z2), static_cast<const int*>(idxR), static_cast<const int*>(lsel),
      static_cast<const int*>(selR), static_cast<const int*>(selC), static_cast<const float*>(ab),
      static_cast<const T*>(wp), static_cast<T*>(out), n, c2, c4, s3, side);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// f32: wk is (c4, KW, KW * c2), rows (C, w), columns (h, c); c2 % 16 == 0, c4 % 8
// == 0, s3 % 8 == 0. bf16: wk is the packed (ceil(c4 / 32), 4 c2 / 64, 128, 64)
// operand; c2 % 16 == 0, c4 % 16 == 0, s3 % 8 == 0 and typed_c3_expand_smem(c2,
// c4, s3) within a block's shared memory. Returns the launch's cudaError_t. The
// launch of typed_c3_expand_v5 too: its schedule is this kernel's.
extern "C" int typed_c3_expand(const void* z2, const void* idxR, const void* lsel,
                               const void* selR, const void* selC, const void* ab, const void* wk,
                               void* out, int n, int c2, int c4, int s3, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)tc::launch<false>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3,
                                  typed::NZ, s);
  return (int)launch<float>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, typed::NZ,
                           s);
}

// typed_c3_expand_v3: the same arguments and limits, z2 the zero-padded (n,
// 13, 13, c2) grid; the kernels above read its 12 x 12 in place.
extern "C" int typed_c3_expand_v3(const void* z2p, const void* idxR, const void* lsel,
                                  const void* selR, const void* selC, const void* ab,
                                  const void* wk, void* out, int n, int c2, int c4, int s3,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)tc::launch<false>(z2p, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3,
                                  typed::NL, s);
  return (int)launch<float>(z2p, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, typed::NL,
                           s);
}

// typed_c3_expand_v6: the same function and arguments; in bf16 the kernel
// above with the V6 schedule (the row types selR names alone), in f32 the
// FMA reference kernel, which has nothing to skip that counts.
extern "C" int typed_c3_expand_v6(const void* z2, const void* idxR, const void* lsel,
                                  const void* selR, const void* selC, const void* ab,
                                  const void* wk, void* out, int n, int c2, int c4, int s3,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)tc::launch<true>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3,
                                 typed::NZ, s);
  return (int)launch<float>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, typed::NZ,
                           s);
}

// Bytes of dynamic shared memory a block of the bf16 kernel takes.
extern "C" int typed_c3_expand_smem(int c2, int c4, int s3) {
  return tc::layout(c2, c4, s3).total;
}
