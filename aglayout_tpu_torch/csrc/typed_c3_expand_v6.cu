// Typed c3, one row type at a time through a small reused buffer.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_typed_expand.py::typed_c3_expand_v6: the function
// of typed_c3_expand.cu (see typed_c3.cuh; the raw 12 x 12 grid, idxR == 12
// and lsel >= 12 are the taps outside the image). The Pallas kernel loops
// the 14 row types and repacks one type's W3z block into a small reused
// scratch for one deeper column-window matmul; what carries over is the
// loop and the small buffer.
//
// What bounds it on the H100: operations (225 GFLOP a batch at B * O =
// 1280, 0.23 ms at the bf16 tensor-core peak), and under them shared-memory
// bandwidth: a row type's product is only (12 x 512) x (512 x N), so each
// type re-reads the chunk's whole w3 slice from shared memory. The design:
//   - one block of 8 warps per object, chunks of CC = 16 output channels
//     (N = 64 columns): grid tile (39 KB) + w3 slice (65 KB) + one type's
//     W3z (4 KB) + one type's V3 row stay near 110 KB, so two blocks share
//     an SM and one's loads and barriers hide behind the other's products;
//   - per row type a: the w3 slice is the m16n8k16 A operand (4 row tiles
//     of 16 columns (C, w)), the type's 12 gathered grid rows the B operand
//     (2 column tiles, ldmatrix from the grid tile, the zero row for taps
//     outside the image); 4 row tiles x 2 halves of K = 8 warps, the upper
//     half's partial sums pass through the type buffer in f32 and the lower
//     half adds its own, rounds to the compute dtype and writes back;
//   - then V3[a, :, chunk] (the sum over w, affine, relu) and straight away
//     the output rows y with selR[y] == a (the rows are sorted by type
//     once an object), 16 bytes a store; a type that no output row has is
//     skipped, product and all, which only this schedule can do; rows with
//     a type outside [0, 14) are written as zeros.
// In f32 the product runs on FMAs (CC = 8), a reference path.

#include "typed_c3.cuh"

namespace {

using namespace typed;

constexpr int ZROW = NZ * NZ;  // index of the zero row of the grid tile
constexpr int LP = 17;         // row stride of the type buffer, [n][l] f32

template <typename T>
struct Cfg6;
template <>
struct Cfg6<__nv_bfloat16> {
  static constexpr int CC = 16;
};
template <>
struct Cfg6<float> {
  static constexpr int CC = 8;
};

template <typename T>
__host__ __device__ inline size_t slice_bytes(int c2) {
  return align16(btile_bytes<T, Cfg6<T>::CC>(c2));
}
template <typename T>
__host__ __device__ inline size_t grid_bytes(int c2) {
  return align16((size_t)(ZROW + 1) * zstride(c2) * sizeof(T));
}
template <typename T>
__host__ __device__ inline size_t smem_bytes(int c2, int s3) {
  constexpr int CC = Cfg6<T>::CC;
  return grid_bytes<T>(c2) + slice_bytes<T>(c2) + (size_t)CC * KW * LP * sizeof(float) +
         align16((size_t)CC * NA * sizeof(T)) +
         (size_t)(2 * NA * KW + 3 * s3 + NA + 2) * sizeof(int);
}

// Row type a's W3z, rounded to the compute dtype, into wa ([N][LP] f32,
// wa[n][l]), synchronised. bf16: warp = (row tile mt of 16 columns n, half
// kh of K); zs rows are the B operand.
__device__ void type_product(const __nv_bfloat16* zs, const __nv_bfloat16* bs, float* wa,
                             const int* zrow0, int a, int c2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp & 3, kh = warp >> 2, g = lane >> 2, t = lane & 3;
  const int K = KW * c2, bstride = K + 8, zs_ = zstride(c2);
  float acc[2][4] = {};
  // A (the w3 slice): lane gives row lane % 16 of the tile, k offset 8 * (lane / 16).
  const uint32_t abase = agl::smem_u32(bs + (size_t)(mt * 16 + (lane & 15)) * bstride + (lane >> 4) * 8);
  // B (grid rows): lane gives row l = (lane / 16) * 8 + lane % 8, k offset 8 * ((lane / 8) % 2);
  // registers 0, 1 are then column tile 0 (l < 8), registers 2, 3 column tile 1.
  const int l = (lane >> 4) * 8 + (lane & 7), bk = ((lane >> 3) & 1) * 8;
  for (int hh = 0; hh < KW / 2; ++hh) {
    const int h = kh * (KW / 2) + hh, r0 = zrow0[a * KW + h];
    const int row = (r0 < 0 || l >= NZ) ? ZROW : r0 + l;
    const uint32_t bbase = agl::smem_u32(zs + row * zs_ + bk);
#pragma unroll 4
    for (int c = 0; c < c2; c += 16) {
      uint32_t af[4], bf[4];
      agl::ldmatrix_x4(abase + (h * c2 + c) * 2, af);
      agl::ldmatrix_x4(bbase + c * 2, bf);
      agl::mma_bf16(acc[0], af, bf[0], bf[1]);
      agl::mma_bf16(acc[1], af, bf[2], bf[3]);
    }
  }
  // element e of acc[nt]: n = mt * 16 + g + 8 * (e / 2), l = nt * 8 + 2 t + e % 2
  if (kh == 1) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wa[(mt * 16 + g + 8 * (e >> 1)) * LP + nt * 8 + 2 * t + (e & 1)] = acc[nt][e];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* p = wa + (mt * 16 + g + 8 * (e >> 1)) * LP + nt * 8 + 2 * t + (e & 1);
        *p = __bfloat162float(__float2bfloat16_rn(acc[nt][e] + *p));
      }
  }
  __syncthreads();
}

// f32 on the FMAs: thread = (l, two columns n).
__device__ void type_product(const float* zs, const float* bs, float* wa, const int* zrow0, int a,
                             int c2) {
  constexpr int N = Cfg6<float>::CC * KW;  // 32: 16 threads x 2 columns
  const int l = threadIdx.x / 16, n0 = (threadIdx.x % 16) * 2, zs_ = zstride(c2);
  float acc[2] = {0.f, 0.f};
  if (l < NZ) {
    for (int h = 0; h < KW; ++h) {
      const int r0 = zrow0[a * KW + h];
      if (r0 < 0) continue;
      const float* zp = zs + (r0 + l) * zs_;
      const float* bp = bs + (size_t)h * c2 * (N + 1) + n0;
      for (int c = 0; c < c2; ++c) {
        acc[0] = fmaf(zp[c], bp[(size_t)c * (N + 1)], acc[0]);
        acc[1] = fmaf(zp[c], bp[(size_t)c * (N + 1) + 1], acc[1]);
      }
    }
    wa[n0 * LP + l] = acc[0];
    wa[(n0 + 1) * LP + l] = acc[1];
  }
  __syncthreads();
}

// z2: (n, 12, 12, c2) T; idxR, lsel: (n, 14, 4) i32; selR, selC: (n, s3)
// i32; ab: (n, 2, c4) f32; wk: (c4, KW, KW * c2) T, rows (C, w), columns
// (h, c); out: (n, c4, s3, s3) T. Grid (n).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
typed_c3_expand_v6_kernel(const T* __restrict__ z2, const int* __restrict__ idxR,
                          const int* __restrict__ lsel, const int* __restrict__ selR,
                          const int* __restrict__ selC, const float* __restrict__ ab,
                          const T* __restrict__ wk, T* __restrict__ out, int c2, int c4, int s3) {
  constexpr int CC = Cfg6<T>::CC, N = CC * KW;
  using V = agl::Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);
  T* bs = reinterpret_cast<T*>(smem_raw + grid_bytes<T>(c2));
  float* wa = reinterpret_cast<float*>(smem_raw + grid_bytes<T>(c2) + slice_bytes<T>(c2));  // [N][LP]
  T* v3a = reinterpret_cast<T*>(wa + N * LP);                                              // [CC][NA]
  int* zrow0 = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(v3a) +
                                      align16((size_t)CC * NA * sizeof(T)));  // [NA][KW]
  int* lsl = zrow0 + NA * KW;                                                  // [NA][KW]
  int* sr = lsl + NA * KW;  // [s3], types outside [0, NA) stored as NA
  int* sc = sr + s3;        // [s3]
  int* order = sc + s3;     // [s3], the output rows sorted by type
  int* start = order + s3;  // [NA + 2], type a's rows are order[start[a] .. start[a + 1])
  const int obj = blockIdx.x, tid = threadIdx.x;

  for (int i = tid; i < NA * KW; i += THREADS) {
    const int idx = idxR[obj * NA * KW + i];
    zrow0[i] = (idx >= 0 && idx < NZ) ? idx * NZ : -1;
    lsl[i] = lsel[obj * NA * KW + i];
  }
  for (int i = tid; i < s3; i += THREADS) {
    const int a = selR[obj * s3 + i];
    sr[i] = (a >= 0 && a < NA) ? a : NA;
    sc[i] = selC[obj * s3 + i];
  }
  load_grid(z2 + (size_t)obj * ZROW * c2, zs, ZROW, c2);
  for (int i = tid; i < c2; i += THREADS) zs[ZROW * zstride(c2) + i] = agl::from_f<T>(0.f);
  __syncthreads();
  // a counting sort of the rows by type, s3 is small: row i's place is the
  // number of rows before it in (type, row) order
  for (int i = tid; i < s3; i += THREADS) {
    int place = 0;
    for (int j = 0; j < s3; ++j) place += sr[j] < sr[i] || (sr[j] == sr[i] && j < i);
    order[place] = i;
  }
  for (int a = tid; a < NA + 2; a += THREADS) {
    int below = 0;
    for (int j = 0; j < s3; ++j) below += sr[j] < a;
    start[a] = below;
  }

  const float* a3 = ab + (size_t)obj * 2 * c4;
  const float* b3 = a3 + c4;
  const int xv = s3 / V::N;
  for (int c0 = 0; c0 < c4; c0 += CC) {
    __syncthreads();  // the tables and zs are in; the previous chunk is written out
    load_w3<CC>(wk, bs, c0, c2);
    __syncthreads();
    T* outc = out + ((size_t)obj * c4 + c0) * s3 * s3;
    for (int a = 0; a <= NA; ++a) {  // a == NA: the rows of no type, zeros
      const int y0 = start[a], ny = start[a + 1] - y0;
      if (ny == 0) continue;  // no output row has this type: its product is not needed
      if (a < NA) type_product(zs, bs, wa, zrow0, a, c2);
      // V3[a, b, c0 + ci]: the sum over w of the column windows, affine, relu
      if (tid < CC * NA) {
        const int ci = tid / NA, bcol = tid % NA;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < KW; ++w) {
          const int l = lsl[bcol * KW + w];
          if (l >= 0 && l < NZ) s += wa[(ci * KW + w) * LP + l];
        }
        v3a[tid] = agl::from_f<T>(a < NA ? fmaxf(s * a3[c0 + ci] + b3[c0 + ci], 0.f) : 0.f);
      }
      __syncthreads();
      // the output rows of this type
      for (int i = tid; i < CC * ny * xv; i += THREADS) {
        const int x8 = i % xv, y = order[y0 + (i / xv) % ny], ci = i / (xv * ny);
        V v;
#pragma unroll
        for (int e = 0; e < V::N; ++e) {
          const int bcol = sc[x8 * V::N + e];
          v.v()[e] = (bcol >= 0 && bcol < NA) ? v3a[ci * NA + bcol] : agl::from_f<T>(0.f);
        }
        *reinterpret_cast<uint4*>(outc + ((size_t)ci * s3 + y) * s3 + x8 * V::N) = v.raw;
      }
      __syncthreads();  // v3a and wa are free for the next type
    }
  }
}

template <typename T>
cudaError_t launch(const void* z2, const void* idxR, const void* lsel, const void* selR,
                   const void* selC, const void* ab, const void* wk, void* out, int n, int c2,
                   int c4, int s3, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(c2, s3);
  cudaError_t err = cudaFuncSetAttribute(typed_c3_expand_v6_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  typed_c3_expand_v6_kernel<T><<<n, THREADS, smem, stream>>>(
      static_cast<const T*>(z2), static_cast<const int*>(idxR), static_cast<const int*>(lsel),
      static_cast<const int*>(selR), static_cast<const int*>(selC), static_cast<const float*>(ab),
      static_cast<const T*>(wk), static_cast<T*>(out), c2, c4, s3);
  return cudaGetLastError();
}

}  // namespace

// c2 % 16 == 0, c4 % 16 == 0, s3 % 8 == 0; returns the launch's cudaError_t.
extern "C" int typed_c3_expand_v6(const void* z2, const void* idxR, const void* lsel,
                                  const void* selR, const void* selC, const void* ab,
                                  const void* wk, void* out, int n, int c2, int c4, int s3,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, s);
  return (int)launch<float>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, s);
}
