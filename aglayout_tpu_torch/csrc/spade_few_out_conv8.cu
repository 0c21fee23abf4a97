// The 128^2 decoder's c7 RGB head: SPADE apply + relu + a KxK conv to
// O <= 4 channels, from compact class tables.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_spade_conv.py::spade_few_out_conv8.
// out = conv(relu(x * A + B)) + bias, where A and B are the SPADE+BN folded
// affine at class resolution, (B, H/f, 5, C, 5 * W/f): the affine of pixel
// (g, j), channel c is tab[b, g / f, class(g % f), c, (j / f) * 5 + class(j % f)].
//
// What bounds it on the H100: at 128^2, B=128, C=128, K=7, O=3 in bf16 it
// reads x (537 MB) and the tables (105 MB): 0.19 ms at 3.35 TB/s. The conv
// is 2,097,152 pixels x 128 channels x 49 taps x 3 outputs = 39.5 G
// multiply-adds (52.6 G with O padded to 4): as FMAs on the CUDA cores, fed
// from shared memory by 2-byte loads, that takes milliseconds (the f32
// kernel below), so the product is what has to move. The bf16 kernel
// (namespace tc) runs it on the tensor cores as an implicit GEMM whose taps
// cost no data movement:
//   - the column taps are the N dimension. For a tile of 8 output rows of
//     one image, acc[(y, x'), (dx, o)] = sum_{dy, c} Y[y + dy - K/2, x', c]
//     * w[o, c, dy, dx]: M = 8 W pixels, N = K O padded to a multiple of 8
//     (24 at K=7, O=3), reduction K C = 896; 90 GFLOP per batch, 0.09 ms at
//     the bf16 peak. The row tap dy is a shift of the A operand's row
//     address: the y tile lies pixel-major in shared memory, 16 channels
//     (one mma.sync m16n8k16 step) innermost, 32 bytes a pixel with the
//     16-byte halves of every second group of 4 pixels swapped so that
//     ldmatrix meets no bank conflict, and one A fragment feeds every
//     column tile. Each warp owns one output row: W/16 x N/8 accumulator
//     tiles in registers across all channel chunks;
//   - out[y, x, o] = bias[o] + sum_dx acc[(y, x + dx - K/2), (dx, o)]: a
//     K-term shifted sum through an f32 tile in shared memory that overlays
//     the operands after the last chunk; columns outside the image are
//     never computed;
//   - the channels go in chunks of 16. A chunk's x rows, the table rows its
//     tile needs (one copy per distinct row block and class, not per image
//     row) and its weight slice come by the copy engine (descriptor-free
//     cp.async.bulk, some 30 copies a chunk, asked for by a ninth warp and
//     counted by an mbarrier) into one of two staging buffers while the
//     previous chunk is applied and multiplied. Copies that the eight
//     working warps start themselves (cp.async) cost them as long as the
//     copies take;
//   - the apply pass reads x in NCHW order from the staging buffer, 8
//     channels x 8 pixels a warp step, applies y = relu(x * A + B) in f32
//     with the table values kept in registers while the table row stays the
//     same, rounds once, transposes the 8 x 8 block inside the warp
//     (movmatrix) and stores it channel-innermost, every access free of bank
//     conflicts. It is the longest stage: the compiler keeps a load behind
//     every earlier store to shared memory, so the loads of the next row are
//     written ahead of this row's stores, and the A fragments of the product
//     two tiles ahead of the mma that reads them.
// The f32 instantiation keeps the FMA kernel below (TF32 would not hold the
// 1e-4 limit): a reference path. It tiles the channels too: a thread owns 4
// pixels x 4 (padded) outputs in registers, and a chunk's weights and y
// rows sit in shared memory.
// Numerics as spade_few_out_conv.cu: y in f32, rounded to the compute
// dtype; zero padding on y; weights rounded to the compute dtype; f32
// accumulation; output rounded once.

#include "common.cuh"

namespace {

constexpr int PX = 4;  // output pixels per thread, along one row
constexpr int THREADS = 256;

// x: (B, C, H, W) T; at, bt: (B, H/f, 5, C, W5) T; w: (C, K, K, 4) f32;
// bias: (4,) f32; out: (B, O, H, W) T. rows * W == THREADS * PX.
// Grid (H / rows, B).
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
head8_kernel(const T* __restrict__ x, const T* __restrict__ at, const T* __restrict__ bt,
             const float* __restrict__ w, const float* __restrict__ bias, T* __restrict__ out,
             int C, int H, int W, int O, int f, int rows, int cc) {
  constexpr int r = K / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);    // [cc][K][K][4]
  T* ys = reinterpret_cast<T*>(ws + cc * K * K * 4);  // [cc][TH][TW]
  const int TW = W + 2 * r, TH = rows + 2 * r, W5 = (W / f) * 5;
  const int b = blockIdx.y, r0 = blockIdx.x * rows, HB = H / f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = THREADS / 32;
  const int oy = tid / (W / PX), ox0 = (tid % (W / PX)) * PX;

  float acc[PX][4];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[p][o] = bias[o];

  for (int c0 = 0; c0 < C; c0 += cc) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < cc * K * K; i += THREADS)
      reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(w)[c0 * K * K + i];
    // y tile, one warp per (channel, tile row); lanes walk the columns
    for (int cr = warp; cr < cc * TH; cr += nwarps) {
      const int c = c0 + cr / TH, ty = cr % TH, g = r0 + ty - r;
      T* yrow = ys + (size_t)cr * TW;
      if (g < 0 || g >= H) {
        for (int tx = lane; tx < TW; tx += 32) yrow[tx] = agl::from_f<T>(0.f);
        continue;
      }
      const T* xrow = x + (((size_t)b * C + c) * H + g) * W;
      const size_t toff = ((((size_t)b * HB + g / f) * 5 + agl::row_class(g % f, f)) * C + c) * W5;
      for (int tx = lane; tx < TW; tx += 32) {
        const int j = tx - r;
        float y = 0.f;
        if (j >= 0 && j < W) {
          const int col = agl::compact_col(j, f);
          y = fmaxf(agl::to_f(xrow[j]) * agl::to_f(at[toff + col]) + agl::to_f(bt[toff + col]), 0.f);
        }
        yrow[tx] = agl::from_f<T>(y);
      }
    }
    __syncthreads();

    for (int c = 0; c < cc; ++c) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        // tile column of output column ox0 + p, tap dx is ox0 + p + dx
        const T* src = ys + ((size_t)c * TH + oy + dy) * TW + ox0;
        float xv[PX + K - 1];
#pragma unroll
        for (int i = 0; i < PX + K - 1; ++i) xv[i] = agl::to_f(src[i]);
        const float* wrow = ws + (c * K + dy) * K * 4;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float wv[4];
          agl::load4(wrow + dx * 4, wv);
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int o = 0; o < 4; ++o) acc[p][o] = fmaf(wv[o], xv[p + dx], acc[p][o]);
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < 4; ++o) {  // static indices keep acc in registers
    if (o >= O) break;
    T* orow = out + (((size_t)b * O + o) * H + r0 + oy) * W + ox0;
#pragma unroll
    for (int p = 0; p < PX; ++p) orow[p] = agl::from_f<T>(acc[p][o]);
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* at, const void* bt, const void* w,
                   const void* bias, void* out, int B, int C, int H, int W, int O, int f,
                   int cc, cudaStream_t stream) {
  const int rows = THREADS * PX / W;
  const size_t smem = (size_t)cc * K * K * 4 * sizeof(float) +
                      (size_t)cc * (rows + K - 1) * (W + K - 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(head8_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / rows, B);
  head8_kernel<T, K><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<T*>(out), C, H,
      W, O, f, rows, cc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(const void* x, const void* at, const void* bt, const void* w,
                       const void* bias, void* out, int B, int C, int H, int W, int K, int O,
                       int f, int cc, cudaStream_t s) {
  switch (K) {
    case 3: return launch<T, 3>(x, at, bt, w, bias, out, B, C, H, W, O, f, cc, s);
    case 5: return launch<T, 5>(x, at, bt, w, bias, out, B, C, H, W, O, f, cc, s);
    case 7: return launch<T, 7>(x, at, bt, w, bias, out, B, C, H, W, O, f, cc, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: the implicit GEMM on the tensor cores --------------------------
namespace tc {

constexpr int R = 8;    // output rows a tile, one a warp
constexpr int CC = 16;  // channels a chunk: one k-step of mma.sync m16n8k16; 32 bytes a pixel
constexpr int THREADS = 32 * (R + 1);  // R consumer warps and one that asks for the copies

// Table slot of tile row ty of the tile at r0: rows of one (row block, row
// class) share a slot; -1 outside the image. Slots count up along the tile.
__host__ __device__ inline int table_slot(int r0, int ty, int r, int H, int f) {
  int s = -1, prev = -1, mine = -1;
  for (int t = 0; t <= ty; ++t) {
    const int g = r0 + t - r;
    mine = -1;
    if (g < 0 || g >= H) continue;
    const int u = g % f;
    const int key = (g / f) * 5 + (u == 0 ? 0 : u == 1 ? 1 : u == f - 2 ? 3 : u == f - 1 ? 4 : 2);
    if (key != prev) { ++s; prev = key; }
    mine = s;
  }
  return mine;
}

// Byte offsets into the dynamic shared memory, and the sizes they follow
// from; computed on the host and handed to the kernel.
struct Layout {
  int th, w5, np;   // tile rows with the halo; table columns; GEMM columns
  int xcs;          // elements between two channels of the staged x rows
  int slots;        // table slots a tile needs at most
  int xbuf, tbuf;   // bytes of one staging buffer of x, and of one table
  int slot, first, bar, ws, xs, tabs, ys, total;
};
inline Layout layout(int H, int W, int K, int O, int f) {
  Layout l;
  l.th = R + K - 1;
  l.w5 = W / f * 5;
  l.np = (K * O + 7) / 8 * 8;
  // channel stride = 4 mod 32 words: the apply pass reads 8 channels x 4 words at once
  const int words = l.th * W / 2;
  l.xcs = 2 * (words + (36 - words % 32) % 32);
  l.slots = 1;
  for (int r0 = 0; r0 < H; r0 += R)
    for (int ty = 0; ty < l.th; ++ty) {
      const int s = table_slot(r0, ty, K / 2, H, f) + 1;
      l.slots = s > l.slots ? s : l.slots;
    }
  l.xbuf = CC * l.xcs * 2;
  l.tbuf = l.slots * CC * l.w5 * 2;
  l.slot = 0;                                // [th] int: table slot of a tile row
  l.first = 64;                              // [th] int: first tile row of a slot; [15]: slots
  l.bar = 128;                               // [2] mbarrier, one a staging buffer
  l.ws = 144;                                // [2][K][np][CC] bf16, k in fragment order
  l.xs = l.ws + 2 * K * l.np * CC * 2;       // [2][CC][xcs] bf16, rows [th][W]
  l.tabs = l.xs + 2 * l.xbuf;                // [2][A, B][slots][CC][w5] bf16
  l.ys = l.tabs + 4 * l.tbuf;                // [th][W][CC] bf16, the 16-byte halves swizzled
  const int operands = l.ys + l.th * W * CC * 2 - l.xs;
  const int sums = R * W * (l.np + 1) * 4;   // [R * W][np + 1] f32 (odd: no conflicts), overlays from xs on
  l.total = l.xs + (operands > sums ? operands : sums);
  return l;
}

// x: (B, C, H, W) bf16; at, bt: (B, H/f, 5, C, W5) bf16; wp: (C / 16, K, NP,
// 16) bf16, the packed weights [chunk][dy][(dx, o)][c], zero rows past K * O,
// the 16 channels of a chunk in the order 0 1 8 9 2 3 10 11 4 5 12 13 6 7 14
// 15 (a lane's mma B fragment is then 8 contiguous bytes); bias: (4,) f32;
// out: (B, O, H, W) bf16. W == 16 MT, NP == 8 NT. Grid (H / R, B).
template <int NT, int MT>
__global__ void __launch_bounds__(THREADS, 1)
head8_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ at,
                 const __nv_bfloat16* __restrict__ bt, const __nv_bfloat16* __restrict__ wp,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int C, int H,
                 int K, int O, int f, const Layout L) {
  constexpr int W = 16 * MT, NP = 8 * NT, SS = NP + 1;  // SS: floats a pixel of the sums
  constexpr int PGS = W / 8 / R;  // 8-pixel groups a warp applies: 2 at W = 128, 1 at 64
  extern __shared__ __align__(16) unsigned char smem[];
  int* slot = reinterpret_cast<int*>(smem + L.slot);
  int* first = reinterpret_cast<int*>(smem + L.first);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L.ys);
  float* sums = reinterpret_cast<float*>(smem + L.xs);
  const int TH = L.th, W5 = L.w5, r = K / 2, HB = H / f;
  const int b = blockIdx.y, r0 = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tylo = r0 < r ? r - r0 : 0, tyhi = r0 + TH - r > H ? H + r - r0 : TH;  // rows inside
  auto bar = [&](int ci) { return agl::smem_u32(smem + L.bar + (ci & 1) * 8); };
  auto xbuf = [&](int ci) { return reinterpret_cast<__nv_bfloat16*>(smem + L.xs + (ci & 1) * L.xbuf); };
  auto tbuf = [&](int ci, int which) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.tabs + ((ci & 1) * 2 + which) * L.tbuf);
  };

  if (tid == 0) {
    agl::mbar_init(bar(0), 1);
    agl::mbar_init(bar(1), 1);
    agl::mbar_fence_init();
  }
  if (tid < TH) slot[tid] = table_slot(r0, tid, r, H, f);
  __syncthreads();
  if (tid < TH && slot[tid] >= 0) {
    if (tid == 0 || slot[tid - 1] != slot[tid]) first[slot[tid]] = tid;
    if (tid == tyhi - 1) first[15] = slot[tid] + 1;
  }
  __syncthreads();

  // The producer warp asks the copy engine for a chunk's x rows (one run of rows a
  // channel), table rows (one run of CC rows a slot and table) and weight
  // slice (one run), into the staging buffers of the chunk's parity; the
  // bytes land on that buffer's mbarrier.
  auto stage = [&](int ci) {
    const int c0 = ci * CC, nslots = first[15];
    const uint32_t xbytes = (tyhi - tylo) * W * 2, tbytes = CC * W5 * 2, wbytes = K * NP * CC * 2;
    if (lane == 0) {
      agl::fence_proxy_async();  // the buffers were read by ordinary loads two chunks ago
      agl::mbar_arrive_expect_tx(bar(ci), CC * xbytes + 2 * nslots * tbytes + wbytes);
    }
    __syncwarp();
    for (int j = lane; j < CC + 1 + 2 * nslots; j += 32) {
      if (j < CC) {
        agl::bulk_copy_g2s(agl::smem_u32(xbuf(ci) + j * L.xcs + tylo * W),
                           x + (((size_t)b * C + c0 + j) * H + r0 + tylo - r) * W, xbytes, bar(ci));
      } else if (j == CC) {
        agl::bulk_copy_g2s(agl::smem_u32(ws + (ci & 1) * K * NP * CC),
                           wp + (size_t)ci * K * NP * CC, wbytes, bar(ci));
      } else {
        const int s = (j - CC - 1) >> 1, which = (j - CC - 1) & 1, g = r0 + first[s] - r;
        const size_t src = ((((size_t)b * HB + g / f) * 5 + agl::row_class(g % f, f)) * C + c0) * W5;
        agl::bulk_copy_g2s(agl::smem_u32(tbuf(ci, which) + s * CC * W5), (which ? bt : at) + src,
                           tbytes, bar(ci));
      }
    }
  };

  // y = relu(x * A + B) of the staged chunk into the y tile, transposed to
  // channel-innermost. A warp step is 8 channels x 8 pixels of one tile row:
  // lane l reads channel l / 4, pixels 2 (l % 4) and + 1, and after the
  // transpose stores pixel l / 4, channels 2 (l % 4) and + 1. The y tile has
  // 32 bytes a pixel; pixels 4..7 of every 8 swap their two 16-byte halves, so
  // that neither these stores nor the product's ldmatrix meet a bank conflict.
  // The PGS * 2 steps of a tile row are independent chains, and the table
  // values stay in registers while the rows share a slot.
  auto apply = [&](int ci) {
    const __nv_bfloat16 *xs = xbuf(ci), *ta = tbuf(ci, 0), *tb = tbuf(ci, 1);
    int col[PGS][2];
#pragma unroll
    for (int p = 0; p < PGS; ++p) {
      const int xa = (warp + p * R) * 8 + 2 * t4;
      col[p][0] = agl::compact_col(xa, f);
      col[p][1] = agl::compact_col(xa + 1, f);
    }
    // lane's word of x for step (p, cg) of tile row ty
    auto xword = [&](int ty, int p, int cg) {
      return *reinterpret_cast<const uint32_t*>(xs + (cg * 8 + g8) * L.xcs + ty * W +
                                                (warp + p * R) * 8 + 2 * t4);
    };
    float av[PGS][2][2], bv[PGS][2][2];
    uint32_t raw[PGS][2], next[PGS][2];
    int cur = -1;
    // the rows' slots in a register, 4 bits a row (15: outside the image), so
    // that no row starts by waiting for a load
    unsigned long long slots = 0;
    for (int ty = 0; ty < TH; ++ty) slots |= (unsigned long long)(slot[ty] & 15) << (4 * ty);
#pragma unroll
    for (int p = 0; p < PGS; ++p)
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) next[p][cg] = xword(tylo, p, cg);
    // The compiler cannot tell the staging buffers from the y tile, so it
    // keeps every load behind the stores written before it: the next row's
    // loads are written ahead of this row's stores.
#pragma unroll 2
    for (int ty = 0; ty < TH; ++ty) {
      const int s4 = (int)(slots >> (4 * ty)) & 15, s = s4 == 15 ? -1 : s4;
#pragma unroll
      for (int p = 0; p < PGS; ++p)
#pragma unroll
        for (int cg = 0; cg < 2; ++cg) {
          raw[p][cg] = s >= 0 ? next[p][cg] : 0u;
          if (ty + 1 >= tylo && ty + 1 < tyhi) next[p][cg] = xword(ty + 1, p, cg);
        }
      if (s >= 0 && s != cur) {
        cur = s;
#pragma unroll
        for (int p = 0; p < PGS; ++p)
#pragma unroll
          for (int cg = 0; cg < 2; ++cg)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ti = (s * CC + cg * 8 + g8) * W5 + col[p][e];
              av[p][cg][e] = __bfloat162float(ta[ti]);
              bv[p][cg][e] = __bfloat162float(tb[ti]);
            }
      }
      uint32_t packed[PGS][2];
#pragma unroll
      for (int p = 0; p < PGS; ++p)
#pragma unroll
        for (int cg = 0; cg < 2; ++cg) {
          packed[p][cg] = 0;  // a row outside the image is zero
          if (s >= 0) {
            const float2 v =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[p][cg]));
            const __nv_bfloat162 y2 =
                __floats2bfloat162_rn(fmaxf(fmaf(v.x, av[p][cg][0], bv[p][cg][0]), 0.f),
                                      fmaxf(fmaf(v.y, av[p][cg][1], bv[p][cg][1]), 0.f));
            packed[p][cg] = *reinterpret_cast<const uint32_t*>(&y2);
          }
          packed[p][cg] = agl::movmatrix_trans(packed[p][cg]);
        }
#pragma unroll
      for (int p = 0; p < PGS; ++p)
#pragma unroll
        for (int cg = 0; cg < 2; ++cg)
          *reinterpret_cast<uint32_t*>(ys + (ty * W + (warp + p * R) * 8 + g8) * CC +
                                       ((cg ^ (g8 >> 2)) * 8) + 2 * t4) = packed[p][cg];
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // The chunk's share of the GEMM: output row `warp`, every row tap a k-step.
  auto product = [&](int ci) {
    const __nv_bfloat16* wsl = ws + (ci & 1) * K * NP * CC + g8 * CC + 4 * t4;
    // ldmatrix x4: lane supplies pixel lane % 16 of the 16-pixel tile, channels
    // 8 (lane / 16) on, which lie in the swizzled half
    const uint32_t abase = agl::smem_u32(
        ys + (warp * W + (lane & 15)) * CC + (((lane >> 4) ^ ((lane >> 2) & 1)) * 8));
    // The asm statements keep their order, so the A fragments are asked for
    // two tiles ahead of the product that uses them, and a row tap's B
    // fragments (x: k = 2t, 2t + 1; y: k = 2t + 8, 2t + 9 of column g) one tap ahead.
    uint2 bf[NT], bnext[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) bnext[nt] = *reinterpret_cast<const uint2*>(wsl + nt * 8 * CC);
    for (int dy = 0; dy < K; ++dy) {
      const uint32_t arow = abase + dy * W * CC * 2;
      uint32_t a[3][4];
      agl::ldmatrix_x4(arow, a[0]);
      agl::ldmatrix_x4(arow + 16 * CC * 2, a[1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bf[nt] = bnext[nt];
        if (dy + 1 < K)
          bnext[nt] = *reinterpret_cast<const uint2*>(wsl + ((dy + 1) * NP + nt * 8) * CC);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt + 2 < MT) agl::ldmatrix_x4(arow + (mt + 2) * 16 * CC * 2, a[(mt + 2) % 3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          agl::mma_bf16(acc[mt][nt], a[mt % 3], bf[nt].x, bf[nt].y);
      }
    }
  };

  const int nchunks = C / CC;
  const bool producer = warp == R;
  if (producer) stage(0);
  for (int ci = 0; ci < nchunks; ++ci) {
    __syncthreads();  // chunk ci - 1 is applied and multiplied: its buffers are free
    if (producer) {
      if (ci + 1 < nchunks) stage(ci + 1);  // in flight under this chunk's work
      __syncthreads();
      continue;
    }
    agl::mbar_wait(bar(ci), (ci >> 1) & 1);  // chunk ci has landed
    apply(ci);
    __syncthreads();  // the y tile is whole
    product(ci);
  }
  __syncthreads();  // every warp is done with the operands, which the sums overlay

  // acc[(y, x'), (dx, o)] to shared memory, then the shifted sum over dx.
  if (!producer)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sums[(warp * W + mt * 16 + g8 + 8 * (e >> 1)) * SS + nt * 8 + 2 * t4 + (e & 1)] =
            acc[mt][nt][e];
  __syncthreads();
  for (int i = tid; i < O * R * W; i += THREADS) {
    const int xo = i % W, y = (i / W) % R, o = i / (W * R);
    float s = bias[o];
    for (int dx = 0; dx < K; ++dx) {
      const int xi = xo + dx - r;
      if (xi >= 0 && xi < W) s += sums[(y * W + xi) * SS + dx * O + o];
    }
    out[(((size_t)b * O + o) * H + r0 + y) * W + xo] = __float2bfloat16_rn(s);
  }
}

template <int NT, int MT>
cudaError_t launch(const void* x, const void* at, const void* bt, const void* wp,
                   const void* bias, void* out, int B, int C, int H, int K, int O, int f,
                   cudaStream_t stream) {
  using T = __nv_bfloat16;
  const Layout L = layout(H, 16 * MT, K, O, f);
  const int smem = L.total;
  cudaError_t err = cudaFuncSetAttribute(head8_mma_kernel<NT, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  head8_mma_kernel<NT, MT><<<dim3(H / R, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<const T*>(wp), static_cast<const float*>(bias), static_cast<T*>(out), C, H, K,
      O, f, L);
  return cudaGetLastError();
}

template <int MT>
cudaError_t dispatch_nt(const void* x, const void* at, const void* bt, const void* wp,
                        const void* bias, void* out, int B, int C, int H, int K, int O, int f,
                        cudaStream_t s) {
  switch ((K * O + 7) / 8) {
    case 1: return launch<1, MT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, s);
    case 2: return launch<2, MT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, s);
    case 3: return launch<3, MT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, s);
    case 4: return launch<4, MT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, s);
    default: return cudaErrorInvalidValue;
  }
}

// W in {64, 128}, H % 8 == 0, C % 16 == 0, W % f == 0, K odd <= 7, O <= 4; x and the
// tables 16-byte aligned.
cudaError_t dispatch(const void* x, const void* at, const void* bt, const void* wp,
                     const void* bias, void* out, int B, int C, int H, int W, int K, int O, int f,
                     cudaStream_t s) {
  if (H % R || C % CC || W % f) return cudaErrorInvalidValue;
  switch (W) {
    case 64: return dispatch_nt<4>(x, at, bt, wp, bias, out, B, C, H, K, O, f, s);
    case 128: return dispatch_nt<8>(x, at, bt, wp, bias, out, B, C, H, K, O, f, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// f32 (the FMA kernel): w is (C, K, K, 4) f32; K in {3, 5, 7}, 1 <= O <= 4,
// C % cc == 0, W % 4 == 0 dividing 1024, H % (1024 / W) == 0, H % f == 0,
// W % f == 0, f >= 5. bf16 (the tensor-core kernel): w is the packed
// (NP, K, C) bf16 matrix, cc is not read; the limits stand at tc::dispatch.
// bias: (4,) f32 in both. Returns the launch's cudaError_t.
extern "C" int spade_few_out_conv8(const void* x, const void* at, const void* bt, const void* w,
                                   const void* bias, void* out, int B, int C, int H, int W, int K,
                                   int O, int f, int cc, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)tc::dispatch(x, at, bt, w, bias, out, B, C, H, W, K, O, f, s);
  return (int)dispatch_k<float>(x, at, bt, w, bias, out, B, C, H, W, K, O, f, cc, s);
}

// Bytes of dynamic shared memory a block of the bf16 kernel takes.
extern "C" int spade_few_out_conv8_smem(int H, int W, int K, int O, int f) {
  return tc::layout(H, W, K, O, f).total;
}
