// The decoder's RGB head: SPADE apply + relu + a KxK conv to O <= 4 channels.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_spade_conv.py::spade_few_out_conv (flat tables).
// out = conv(relu(x * A + B)) + bias, where A and B are the SPADE+BN folded
// affine, read from (B, H/f, 5, C, W) row-class tables: the affine of
// pixel (g, j), channel c is tab[b, g / f, class(g % f), c, j].
//
// What bounds it on the H100: at 64^2 and B=128 in bf16 it reads x (67 MB)
// and two tables (42 MB): ~110 MB, 33 us at 3.35 TB/s. It does 4.9 G
// multiply-adds (O=3, K=7, C=64), which as plain FMAs on the CUDA cores
// take longer than that, so this simple version is bound by FMA issue.
// Its design keeps the bytes at the floor:
//   - one CTA per (image, tile of `rows` output rows);
//   - the CTA reads rows [r0 - K/2, r0 + rows + K/2) of x and of the
//     tables once, applies y = relu(x * A + B) as it loads, and keeps y,
//     zero outside the image, in shared memory ([C][rows + K - 1][W + K - 1]);
//     the halo costs (rows + K - 1) / rows extra reads, mostly from L2;
//   - the C x K x K x 4 f32 weights also sit in shared memory;
//   - each thread then computes 2 adjacent output pixels x 4 (padded)
//     channels, re-using each loaded row of y across the K column taps.
// Numerics match pallas_spade_conv.py:92-137: y in f32, rounded to the
// compute dtype; the zero padding applies to y; f32 accumulation.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int PX = 2;  // output pixels per thread, along one row

using agl::row_class;

// x: (B, C, H, W) T; at, bt: (B, H/f, 5, C, W) T; w: (C, K, K, 4) f32;
// bias: (4,) f32; out: (B, O, H, W) T. Grid (H / rows, B).
template <typename T, int K>
__global__ void spade_few_out_conv_kernel(const T* __restrict__ x, const T* __restrict__ at,
                                          const T* __restrict__ bt, const float* __restrict__ w,
                                          const float* __restrict__ bias, T* __restrict__ out,
                                          int C, int H, int W, int O, int f, int rows) {
  constexpr int r = K / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [C][K][K][4]
  T* ys = reinterpret_cast<T*>(ws + C * K * K * 4);  // [C][TH][TW]
  const int TW = W + 2 * r, TH = rows + 2 * r;
  const int b = blockIdx.y, r0 = blockIdx.x * rows, HB = H / f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  for (int i = tid; i < C * K * K; i += blockDim.x)
    reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(w)[i];

  // y tile, one warp per (channel, tile row); lanes walk the columns
  for (int cr = warp; cr < C * TH; cr += nwarps) {
    const int c = cr / TH, ty = cr % TH, g = r0 + ty - r;
    T* yrow = ys + (size_t)cr * TW;
    if (g < 0 || g >= H) {
      for (int tx = lane; tx < TW; tx += 32) yrow[tx] = agl::from_f<T>(0.f);
      continue;
    }
    const T* xrow = x + (((size_t)b * C + c) * H + g) * W;
    const size_t toff = ((((size_t)b * HB + g / f) * 5 + row_class(g % f, f)) * C + c) * W;
    for (int tx = lane; tx < TW; tx += 32) {
      const int j = tx - r;
      float y = 0.f;
      if (j >= 0 && j < W)
        y = fmaxf(agl::to_f(xrow[j]) * agl::to_f(at[toff + j]) + agl::to_f(bt[toff + j]), 0.f);
      yrow[tx] = agl::from_f<T>(y);
    }
  }
  __syncthreads();

  const int groups_per_row = W / PX;
  for (int gi = tid; gi < rows * groups_per_row; gi += blockDim.x) {
    const int oy = gi / groups_per_row, ox0 = (gi % groups_per_row) * PX;
    float acc[PX][4];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[p][o] = bias[o];
    for (int c = 0; c < C; ++c) {
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
    for (int o = 0; o < O; ++o) {
      T* orow = out + (((size_t)b * O + o) * H + r0 + oy) * W + ox0;
#pragma unroll
      for (int p = 0; p < PX; ++p) orow[p] = agl::from_f<T>(acc[p][o]);
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* at, const void* bt, const void* w,
                   const void* bias, void* out, int B, int C, int H, int W, int O, int f,
                   int rows, cudaStream_t stream) {
  const size_t smem = (size_t)C * K * K * 4 * sizeof(float) +
                      (size_t)C * (rows + K - 1) * (W + K - 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(spade_few_out_conv_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / rows, B);
  spade_few_out_conv_kernel<T, K><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<T*>(out), C, H,
      W, O, f, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(const void* x, const void* at, const void* bt, const void* w,
                       const void* bias, void* out, int B, int C, int H, int W, int K, int O,
                       int f, int rows, cudaStream_t s) {
  switch (K) {
    case 3: return launch<T, 3>(x, at, bt, w, bias, out, B, C, H, W, O, f, rows, s);
    case 5: return launch<T, 5>(x, at, bt, w, bias, out, B, C, H, W, O, f, rows, s);
    case 7: return launch<T, 7>(x, at, bt, w, bias, out, B, C, H, W, O, f, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K in {3, 5, 7}, 1 <= O <= 4, W even, H % rows == 0, H % f == 0;
// returns the launch's cudaError_t.
extern "C" int spade_few_out_conv(const void* x, const void* at, const void* bt, const void* w,
                                  const void* bias, void* out, int B, int C, int H, int W, int K,
                                  int O, int f, int rows, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_k<__nv_bfloat16>(x, at, bt, w, bias, out, B, C, H, W, K, O, f, rows, s);
  return (int)dispatch_k<float>(x, at, bt, w, bias, out, B, C, H, W, K, O, f, rows, s);
}
