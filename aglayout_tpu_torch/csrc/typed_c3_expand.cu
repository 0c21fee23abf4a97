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
// per batch: ~30 ms on the CUDA cores, 0.23 ms at the bf16 tensor-core
// peak. The output is 671 MB in bf16, 0.2 ms at 3.35 TB/s. So in bf16:
//   - one CTA of 8 warps per object; the object's 12 x 12 x c2 grid sits in
//     shared memory (rows padded by 16 bytes against bank conflicts) with
//     one zero row for the out-of-bounds taps;
//   - the c4 outputs go in chunks of CC = 32 channels: the chunk's w3 slice
//     (4 w x CC rows of 4 * c2, 128 KB) is copied from L2 into shared
//     memory, and the product runs on the tensor cores (mma.sync
//     m16n8k16, bf16 in, f32 out): ldmatrix takes the A rows straight from
//     the gathered grid rows, so the gather costs nothing; each warp owns
//     16 columns x all 11 row tiles, 88 f32 accumulators;
//   - the chunk's W3z (rounded to bf16) and V3 then overwrite the w3 slice
//     in shared memory; the expansion writes each output row from V3 with
//     16-byte stores, a copy, not a product.
// In f32 the product runs on FMAs (CC = 8), which is a reference path.
// Numerics, as the Pallas kernel: products of compute-dtype operands summed
// in f32, W3z rounded to the compute dtype; the sum over w in f32, affine
// and relu in f32, V3 rounded to the compute dtype; the expansion copies.

#include "common.cuh"

namespace {

constexpr int NA = 14;             // window types on the c3 output grid
constexpr int NZ = 12;             // c2 types per axis
constexpr int KW = 4;              // c3 kernel size
constexpr int M = NA * NZ;         // rows (a, l) of W3z
constexpr int MT = (M + 15) / 16;  // m16 row tiles
constexpr int ZROW = NZ * NZ;      // index of the zero row of the grid tile
constexpr int THREADS = 256;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int CC = 32;  // output channels per chunk
};
template <>
struct Cfg<float> {
  static constexpr int CC = 8;
};

__host__ __device__ constexpr int zstride(int c2) { return c2 + 8; }
__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// Shared memory, in bytes: the grid tile; then the chunk's w3 slice, which
// W3z and V3 overwrite after the product; then the index tables.
template <typename T>
__host__ __device__ inline size_t btile_bytes(int c2) {
  constexpr int N = Cfg<T>::CC * KW;
  return sizeof(T) == 2 ? (size_t)N * (KW * c2 + 8) * sizeof(T)   // [n][k], k contiguous
                        : (size_t)KW * c2 * (N + 1) * sizeof(T);  // [k][n]
}
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid row of W3z row m = (a, l) at kernel row h: the gathered c2 row, or
// the zero row (idxR == 12, or m past the M real rows).
__device__ __forceinline__ int zrow(const int* zrow0, int m, int h) {
  if (m >= M) return ZROW;
  const int r0 = zrow0[(m / NZ) * KW + h];
  return r0 < 0 ? ZROW : r0 + m % NZ;
}

// W3z of one chunk into ws ([M][N], rounded to T), bf16 on the tensor
// cores. bs: [N][KW * c2 + 8], n = ci * KW + w.
__device__ void chunk_product(const __nv_bfloat16* zs, const __nv_bfloat16* bs, __nv_bfloat16* ws,
                              const int* zrow0, int c2) {
  constexpr int N = Cfg<__nv_bfloat16>::CC * KW;  // 128: 8 warps x 16 columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, n0 = warp * 16;
  const int K = KW * c2, bstride = K + 8, zs_ = zstride(c2);
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int h = 0; h < KW; ++h) {
    // ldmatrix x4: lane supplies row (lane % 16) of the tile, k offset 8 * (lane / 16)
    uint32_t rowaddr[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      rowaddr[mt] = smem_u32(zs + zrow(zrow0, mt * 16 + (lane & 15), h) * zs_ + (lane >> 4) * 8);
    for (int c0 = 0; c0 < c2; c0 += 16) {
      const int k0 = h * c2 + c0;
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* bp = bs + (size_t)(n0 + j * 8 + g) * bstride + k0 + 2 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[j][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(rowaddr[mt] + c0 * 2, a);
        mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
        mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
      }
    }
  }
  __syncthreads();  // every warp is done with bs, which ws overwrites
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + g + 8 * half, n = n0 + j * 8 + 2 * t;
        if (m < M) {
          ws[m * N + n] = __float2bfloat16_rn(acc[mt][j][2 * half]);
          ws[m * N + n + 1] = __float2bfloat16_rn(acc[mt][j][2 * half + 1]);
        }
      }
}

// The same in f32 on the FMAs. bs: [KW * c2][N + 1].
__device__ void chunk_product(const float* zs, const float* bs, float* ws, const int* zrow0,
                              int c2) {
  constexpr int N = Cfg<float>::CC * KW;  // 32: 8 threads x 4 columns
  constexpr int MI = (M + 31) / 32;       // rows per thread, strided by 32
  const int n4 = threadIdx.x % 8, mrow = threadIdx.x / 8, zs_ = zstride(c2);
  float acc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int h = 0; h < KW; ++h) {
    const float* zp[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) zp[i] = zs + zrow(zrow0, mrow + 32 * i, h) * zs_;
    for (int c = 0; c < c2; ++c) {
      const float* bp = bs + (size_t)(h * c2 + c) * (N + 1) + 4 * n4;
      const float bv[4] = {bp[0], bp[1], bp[2], bp[3]};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float av = zp[i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // every thread is done with bs, which ws overwrites
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = mrow + 32 * i;
    if (m < M)
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[m * N + 4 * n4 + j] = acc[i][j];
  }
}

// The chunk's w3 slice: channels [c0, c0 + CC) of wk ((c4, KW, KW * c2),
// rows (C, w)), into the layout chunk_product reads.
__device__ void load_w3(const __nv_bfloat16* wk, __nv_bfloat16* bs, int c0, int c2) {
  constexpr int N = Cfg<__nv_bfloat16>::CC * KW;
  const int K = KW * c2, kv = K / 8;
  const uint4* src = reinterpret_cast<const uint4*>(wk + (size_t)c0 * KW * K);
  for (int i = threadIdx.x; i < N * kv; i += THREADS) {
    const int n = i / kv, k8 = i % kv;
    *reinterpret_cast<uint4*>(bs + (size_t)n * (K + 8) + k8 * 8) = src[i];
  }
}
__device__ void load_w3(const float* wk, float* bs, int c0, int c2) {
  constexpr int N = Cfg<float>::CC * KW;
  const int K = KW * c2;
  const float* src = wk + (size_t)c0 * KW * K;
  for (int i = threadIdx.x; i < N * K; i += THREADS) {
    const int k = i / N, n = i % N;  // neighbouring threads: neighbouring columns
    bs[(size_t)k * (N + 1) + n] = src[(size_t)n * K + k];
  }
}

// z2: (n, 12, 12, c2) T; idxR, lsel: (n, 14, 4) i32; selR, selC: (n, s3)
// i32; ab: (n, 2, c4) f32; wk: (c4, KW, KW * c2) T, rows (C, w), columns
// (h, c); out: (n, c4, s3, s3) T. Grid (n).
template <typename T>
__global__ void __launch_bounds__(THREADS)
typed_c3_expand_kernel(const T* __restrict__ z2, const int* __restrict__ idxR,
                       const int* __restrict__ lsel, const int* __restrict__ selR,
                       const int* __restrict__ selC, const float* __restrict__ ab,
                       const T* __restrict__ wk, T* __restrict__ out, int c2, int c4, int s3) {
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
  using V = agl::Vec16<T>;
  const int cv = c2 / V::N;
  const uint4* zsrc = reinterpret_cast<const uint4*>(z2 + (size_t)obj * ZROW * c2);
  for (int i = tid; i < ZROW * cv; i += THREADS)
    *reinterpret_cast<uint4*>(zs + (i / cv) * zstride(c2) + (i % cv) * V::N) = zsrc[i];
  for (int i = tid; i < c2; i += THREADS) zs[ZROW * zstride(c2) + i] = agl::from_f<T>(0.f);

  const float* a3 = ab + (size_t)obj * 2 * c4;
  const float* b3 = a3 + c4;
  const int xv = s3 / V::N;
  for (int c0 = 0; c0 < c4; c0 += CC) {
    __syncthreads();  // the tables and zs are in; the previous chunk is written out
    load_w3(wk, bs, c0, c2);
    __syncthreads();
    chunk_product(zs, bs, ws, zrow0, c2);
    __syncthreads();

    // V3 of the chunk: the sum over w of the column windows, affine, relu
    for (int i = tid; i < CC * NA * NA; i += THREADS) {
      const int ci = i / (NA * NA), a = (i / NA) % NA, bcol = i % NA;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const int l = lsl[bcol * KW + w];
        if (l >= 0 && l < NZ) s += agl::to_f(ws[(a * NZ + l) * N + ci * KW + w]);
      }
      v3[i] = agl::from_f<T>(fmaxf(s * a3[c0 + ci] + b3[c0 + ci], 0.f));
    }
    __syncthreads();

    // expansion: out[c0 + ci, y, x] = V3[selR[y], selC[x]], 16 bytes a store
    for (int i = tid; i < CC * s3 * xv; i += THREADS) {
      const int x8 = i % xv, y = (i / xv) % s3, ci = i / (xv * s3);
      const int a = sr[y];
      V v;
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        const int bcol = sc[x8 * V::N + e];
        v.v()[e] = (a >= 0 && a < NA && bcol >= 0 && bcol < NA) ? v3[(ci * NA + a) * NA + bcol]
                                                                 : agl::from_f<T>(0.f);
      }
      *reinterpret_cast<uint4*>(out + (((size_t)obj * c4 + c0 + ci) * s3 + y) * s3 + x8 * V::N) =
          v.raw;
    }
  }
}

template <typename T>
cudaError_t launch(const void* z2, const void* idxR, const void* lsel, const void* selR,
                   const void* selC, const void* ab, const void* wk, void* out, int n, int c2,
                   int c4, int s3, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(c2, s3);
  cudaError_t err = cudaFuncSetAttribute(typed_c3_expand_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  typed_c3_expand_kernel<T><<<n, THREADS, smem, stream>>>(
      static_cast<const T*>(z2), static_cast<const int*>(idxR), static_cast<const int*>(lsel),
      static_cast<const int*>(selR), static_cast<const int*>(selC), static_cast<const float*>(ab),
      static_cast<const T*>(wk), static_cast<T*>(out), c2, c4, s3);
  return cudaGetLastError();
}

}  // namespace

// c2 % 16 == 0, c4 % 32 == 0, s3 % 8 == 0; returns the launch's cudaError_t.
extern "C" int typed_c3_expand(const void* z2, const void* idxR, const void* lsel,
                               const void* selR, const void* selC, const void* ab, const void* wk,
                               void* out, int n, int c2, int c4, int s3, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, s);
  return (int)launch<float>(z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, s);
}
