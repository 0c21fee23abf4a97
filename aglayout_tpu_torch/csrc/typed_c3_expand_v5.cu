// Typed c3 as one big product through a device scratch, then one pass for
// the column windows and the expansion.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_typed_expand.py::typed_c3_expand_v5: the function
// of typed_c3_expand.cu (see typed_c3.cuh; the raw 12 x 12 grid, idxR == 12
// and lsel >= 12 are the taps outside the image). The Pallas kernel repacks
// W3z of all 14 row types through a VMEM scratch so that the column windows
// and the column expansion are ONE matmul each. Here the scratch is device
// memory and the two stages are two kernels:
//   1. typed_c3_w3z_kernel: W3z of ALL objects as one GEMM, M = n * 168
//      gathered rows (object, a, l), K = 4 c2, N = 4 c4 columns (w, C),
//      written once, rounded to the compute dtype, to the scratch
//      (n, 14, 12, 4, c4): for one (object, a, l, w) the c4 channels are
//      contiguous, which is how stage 2 reads them. bf16: 128 x 128 block
//      tiles, K in steps of 32 through a cp.async double buffer (the gather
//      is the copy's source address, a tap outside the image a zero fill),
//      8 warps of 64 x 32 on mma.sync m16n8k16; a w3 tile is shared by 128
//      rows of any objects, so the weights are read from L2 M / 128 times
//      in all, not once per object and chunk.
//   2. typed_c3_window_expand_kernel: per (object, 64 channels) the sum
//      over w of the column windows, read from the scratch 16 bytes a
//      load, bn3 affine + relu into shared memory, then the expansion.
//
// What bounds it on the H100: stage 1 is 225 GFLOP at B * O = 1280 (0.23 ms
// at the bf16 peak); the scratch is 440 MB in bf16, written once and read
// once: 0.26 ms at 3.35 TB/s on top of the 671 MB output's 0.2 ms. That
// round trip is the price of the one big product; the other variants keep
// W3z in shared memory.
// In f32 stage 1 runs on FMAs (64 x 64 tiles), a reference path.

#include "typed_c3.cuh"

namespace {

using namespace typed;

constexpr int MROWS = NA * NZ;  // rows (a, l) of W3z per object
constexpr int CC5 = 64;         // channels per block of stage 2

// Row m = (object, a, l) of the GEMM at kernel row h: the index of its
// (c2,) source row in z2 viewed as (n * 144, c2), or -1 for zeros.
__device__ __forceinline__ int source_row(const int* __restrict__ idxR, int m, int h, int m_total) {
  if (m >= m_total) return -1;
  const int obj = m / MROWS, a = (m % MROWS) / NZ, l = m % NZ;
  const int idx = idxR[(obj * NA + a) * KW + h];
  return (idx >= 0 && idx < NZ) ? (obj * NZ + idx) * NZ + l : -1;
}

// Stage 1, bf16. z2: (n * 144, c2); wk: (4 c4, 4 c2), rows (w, C), columns
// (h, c); w3z: (m_total, 4 c4). Grid (ceil(m_total / 128), 4 c4 / 128).
constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8;
__global__ void __launch_bounds__(THREADS)
typed_c3_w3z_kernel(const __nv_bfloat16* __restrict__ z2, const int* __restrict__ idxR,
                    const __nv_bfloat16* __restrict__ wk, __nv_bfloat16* __restrict__ w3z,
                    int m_total, int c2, int ntot) {
  __shared__ __align__(16) __nv_bfloat16 as[2][BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 bs[2][BN][LDS];
  __shared__ int src[BM][KW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, K = KW * c2;

  for (int i = tid; i < BM * KW; i += THREADS)
    src[i / KW][i % KW] = source_row(idxR, m0 + i / KW, i % KW, m_total);
  __syncthreads();

  // a stage: BM + BN rows of BK values, four 16-byte copies a row
  auto load = [&](int kt, int buf) {
    const int k0 = kt * BK, h = k0 / c2, c = k0 % c2;
    for (int i = tid; i < (BM + BN) * 4; i += THREADS) {
      const int row = i >> 2, v = (i & 3) * 8;
      if (row < BM) {
        const int s = src[row][h];
        agl::cp_async16(agl::smem_u32(&as[buf][row][v]), z2 + (size_t)max(s, 0) * c2 + c + v,
                        s >= 0);
      } else {
        agl::cp_async16(agl::smem_u32(&bs[buf][row - BM][v]),
                        wk + (size_t)(n0 + row - BM) * K + k0 + v);
      }
    }
  };

  float acc[4][4][4] = {};
  const int nk = K / BK;
  load(0, 0);
  agl::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    agl::cp_async_commit();
    agl::cp_async_wait_1();  // this step's stage has landed (this thread's part)
    __syncthreads();         // ... and everyone's
    const int buf = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bf[2][4];  // bf[j]: column tiles 2j (registers 0, 1) and 2j + 1 (2, 3)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        agl::ldmatrix_x4(agl::smem_u32(&bs[buf][wn * 32 + j * 16 + (lane >> 4) * 8 + (lane & 7)]
                                          [kk + ((lane >> 3) & 1) * 8]), bf[j]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        agl::ldmatrix_x4(
            agl::smem_u32(&as[buf][wm * 64 + mt * 16 + (lane & 15)][kk + (lane >> 4) * 8]), af);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          agl::mma_bf16(acc[mt][nt], af, bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();  // the stage is free for the load of step kt + 2
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + g + 8 * half;
      if (m >= m_total) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(w3z + (size_t)m * ntot + n) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

// Stage 1, f32 on the FMAs: 64 x 64 tiles, K in steps of 16, 4 x 4 outputs
// a thread. Grid (ceil(m_total / 64), 4 c4 / 64).
constexpr int FM = 64, FK = 16;
__global__ void __launch_bounds__(THREADS)
typed_c3_w3z_f32_kernel(const float* __restrict__ z2, const int* __restrict__ idxR,
                        const float* __restrict__ wk, float* __restrict__ w3z, int m_total,
                        int c2, int ntot) {
  __shared__ float as[FK][FM + 1];
  __shared__ float bs[FK][FM + 1];
  __shared__ int src[FM][KW];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FM, K = KW * c2;
  for (int i = tid; i < FM * KW; i += THREADS)
    src[i / KW][i % KW] = source_row(idxR, m0 + i / KW, i % KW, m_total);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    __syncthreads();  // src is in; the previous step's tiles are read
    const int h = k0 / c2, c = k0 % c2;
    for (int i = tid; i < FM * FK; i += THREADS) {
      const int row = i / FK, k = i % FK, s = src[row][h];
      as[k][row] = s >= 0 ? z2[(size_t)s * c2 + c + k] : 0.f;
      bs[k][row] = wk[(size_t)(n0 + row) * K + k0 + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[k][ty + 16 * i];
        bv[i] = bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) w3z[(size_t)m * ntot + n0 + tx + 16 * j] = acc[i][j];
  }
}

// Stage 2. w3z: (n, 14, 12, 4, c4) T; lsel: (n, 14, 4) i32; selR, selC:
// (n, s3) i32; ab: (n, 2, c4) f32; out: (n, c4, s3, s3) T. Grid (n, c4 / 64).
template <typename T>
__global__ void __launch_bounds__(THREADS)
typed_c3_window_expand_kernel(const T* __restrict__ w3z, const int* __restrict__ lsel,
                              const int* __restrict__ selR, const int* __restrict__ selC,
                              const float* __restrict__ ab, T* __restrict__ out, int c4, int s3) {
  using V = agl::Vec16<T>;
  constexpr int CV = CC5 / V::N;  // 16-byte vectors per (a, l, w) of the block's channels
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v3 = reinterpret_cast<T*>(smem_raw);                                   // [CC5][NA][NA]
  int* lsl = reinterpret_cast<int*>(smem_raw + CC5 * NA * NA * sizeof(T));  // [NA][KW]
  int* sr = lsl + NA * KW;                                                  // [s3]
  int* sc = sr + s3;                                                        // [s3]
  const int obj = blockIdx.x, c0 = blockIdx.y * CC5, tid = threadIdx.x;

  for (int i = tid; i < NA * KW; i += THREADS) lsl[i] = lsel[obj * NA * KW + i];
  for (int i = tid; i < s3; i += THREADS) {
    sr[i] = selR[obj * s3 + i];
    sc[i] = selC[obj * s3 + i];
  }
  __syncthreads();

  const float* a3 = ab + (size_t)obj * 2 * c4 + c0;
  const float* b3 = a3 + c4;
  const T* wobj = w3z + (size_t)obj * MROWS * KW * c4 + c0;
  for (int i = tid; i < NA * NA * CV; i += THREADS) {  // lanes along the channels
    const int cv = i % CV, bcol = (i / CV) % NA, a = i / (CV * NA);
    float s[V::N];
#pragma unroll
    for (int e = 0; e < V::N; ++e) s[e] = 0.f;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int l = lsl[bcol * KW + w];
      if (l < 0 || l >= NZ) continue;
      V v;
      v.raw = *reinterpret_cast<const uint4*>(wobj + ((size_t)(a * NZ + l) * KW + w) * c4 + cv * V::N);
#pragma unroll
      for (int e = 0; e < V::N; ++e) s[e] += agl::to_f(v.v()[e]);
    }
#pragma unroll
    for (int e = 0; e < V::N; ++e) {
      const int ci = cv * V::N + e;
      v3[(ci * NA + a) * NA + bcol] = agl::from_f<T>(fmaxf(s[e] * a3[ci] + b3[ci], 0.f));
    }
  }
  __syncthreads();
  expand_store(v3, sr, sc, out + ((size_t)obj * c4 + c0) * s3 * s3, CC5, s3);
}

template <typename T>
cudaError_t launch(const void* z2, const void* idxR, const void* lsel, const void* selR,
                   const void* selC, const void* ab, const void* wk, void* w3z, void* out, int n,
                   int c2, int c4, int s3, cudaStream_t stream) {
  constexpr int TILE = sizeof(T) == 2 ? BM : FM;
  const int m_total = n * MROWS, ntot = KW * c4;
  const dim3 tiles((m_total + TILE - 1) / TILE, ntot / TILE);
  if constexpr (sizeof(T) == 2)
    typed_c3_w3z_kernel<<<tiles, THREADS, 0, stream>>>(
        static_cast<const T*>(z2), static_cast<const int*>(idxR), static_cast<const T*>(wk),
        static_cast<T*>(w3z), m_total, c2, ntot);
  else
    typed_c3_w3z_f32_kernel<<<tiles, THREADS, 0, stream>>>(
        static_cast<const T*>(z2), static_cast<const int*>(idxR), static_cast<const T*>(wk),
        static_cast<T*>(w3z), m_total, c2, ntot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)CC5 * NA * NA * sizeof(T) + (size_t)(NA * KW + 2 * s3) * sizeof(int);
  err = cudaFuncSetAttribute(typed_c3_window_expand_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  typed_c3_window_expand_kernel<T><<<dim3(n, c4 / CC5), THREADS, smem, stream>>>(
      static_cast<const T*>(w3z), static_cast<const int*>(lsel), static_cast<const int*>(selR),
      static_cast<const int*>(selC), static_cast<const float*>(ab), static_cast<T*>(out), c4, s3);
  return cudaGetLastError();
}

}  // namespace

// c2 % 32 == 0, c4 % 64 == 0, s3 % 8 == 0; w3z: scratch of n * 168 * 4 c4
// values of the compute dtype; returns the first failing launch's
// cudaError_t.
extern "C" int typed_c3_expand_v5(const void* z2, const void* idxR, const void* lsel,
                                  const void* selR, const void* selC, const void* ab,
                                  const void* wk, void* w3z, void* out, int n, int c2, int c4,
                                  int s3, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(z2, idxR, lsel, selR, selC, ab, wk, w3z, out, n, c2, c4, s3, s);
  return (int)launch<float>(z2, idxR, lsel, selR, selC, ab, wk, w3z, out, n, c2, c4, s3, s);
}
