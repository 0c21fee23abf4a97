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

#include "typed_c3.cuh"

namespace {

using namespace typed;

constexpr int M = NA * NZ;     // rows (a, l) of W3z
constexpr int ZROW = NZ * NZ;  // index of the zero row of the grid tile

// Shared memory, in bytes: the grid tile; then the chunk's w3 slice, which
// W3z and V3 overwrite after the product; then the index tables.
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
  load_grid(z2 + (size_t)obj * ZROW * c2, zs, ZROW, c2);
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
