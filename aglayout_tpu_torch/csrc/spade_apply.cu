// SPADE apply + relu from compact class tables: out = relu(x * A + B).
//
// Replaces the TPU kernel aglayout_tpu/ops/pallas_spade_conv.py::spade_apply8
// (SPADE-4 between the decoder's c5 and c6 at 128^2). A and B are the
// SPADE+BN folded affine at class resolution, (B, H/f, 5, C, 5 * W/f): the
// affine of pixel (g, j), channel c is tab[b, g / f, class(g % f), c,
// (j / f) * 5 + class(j % f)], so the full-resolution gamma and beta never
// exist.
//
// What bounds it on the H100: nothing but bytes. At 128^2, B=128, C=128 in
// bf16 it reads x (537 MB), writes out (537 MB) and reads the two tables
// once (105 MB): ~1.18 GB, 0.35 ms at 3.35 TB/s; a few flops per byte.
// Its design keeps the bytes at that floor and the instructions per byte low:
//   - one CTA per (image, f-row block, block of `cb` channels), so the CTA
//     needs exactly the 5 row classes x cb channels x 5 W/f columns of each
//     table, which it stages once in shared memory as f32;
//   - each thread then streams 16-byte vectors of x (8 bf16 or 4 f32):
//     one vector load, the affine and relu from shared memory, one vector
//     store; neighbouring threads take neighbouring vectors of a row.
// Numerics: y = relu(x * A + B) in f32, rounded once to the compute dtype.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// x, out: (B, C, H, W) T; at, bt: (B, H/f, 5, C, W5) T with W5 = 5 W / f.
// Grid (C / cb, H / f, B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
spade_apply_kernel(const T* __restrict__ x, const T* __restrict__ at, const T* __restrict__ bt,
                   T* __restrict__ out, int C, int H, int W, int f, int cb) {
  extern __shared__ __align__(16) float tabs[];  // [2][5][cb][W5]
  const int W5 = (W / f) * 5, HB = H / f;
  const int c0 = blockIdx.x * cb, hb = blockIdx.y, b = blockIdx.z;
  const int tsize = 5 * cb * W5;
  float* ta = tabs;
  float* tb = tabs + tsize;
  for (int i = threadIdx.x; i < tsize; i += THREADS) {
    const int rc = i / (cb * W5), rem = i % (cb * W5);
    const size_t src = (((size_t)b * HB + hb) * 5 + rc) * C * W5 + (size_t)c0 * W5 + rem;
    ta[i] = agl::to_f(at[src]);
    tb[i] = agl::to_f(bt[src]);
  }
  __syncthreads();

  using V = agl::Vec16<T>;
  const int nv = W / V::N, total = cb * f * nv;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int jv = i % nv, row = i / nv, u = row % f, c = row / f;
    const size_t base = (((size_t)b * C + c0 + c) * H + (size_t)hb * f + u) * W + jv * V::N;
    const int tab = (agl::row_class(u, f) * cb + c) * W5;
    V v;
    v.raw = *reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int e = 0; e < V::N; ++e) {
      const int col = tab + agl::compact_col(jv * V::N + e, f);
      v.v()[e] = agl::from_f<T>(fmaxf(agl::to_f(v.v()[e]) * ta[col] + tb[col], 0.f));
    }
    *reinterpret_cast<uint4*>(out + base) = v.raw;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* at, const void* bt, void* out, int B, int C, int H,
                   int W, int f, int cb, cudaStream_t stream) {
  const size_t smem = 2 * 5 * (size_t)cb * (W / f) * 5 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spade_apply_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(C / cb, H / f, B);
  spade_apply_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<T*>(out), C, H, W, f, cb);
  return cudaGetLastError();
}

}  // namespace

// C % cb == 0, H % f == 0, W % f == 0, W % 8 == 0, f >= 5; returns the
// launch's cudaError_t.
extern "C" int spade_apply8(const void* x, const void* at, const void* bt, void* out, int B, int C,
                            int H, int W, int f, int cb, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, at, bt, out, B, C, H, W, f, cb, s);
  return (int)launch<float>(x, at, bt, out, B, C, H, W, f, cb, s);
}
