// The 128^2 decoder's c7 RGB head: SPADE apply + relu + a KxK conv to
// O <= 4 channels, with compact class tables and channel tiling.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_spade_conv.py::spade_few_out_conv8.
// out = conv(relu(x * A + B)) + bias, where A and B are the SPADE+BN folded
// affine at class resolution, (B, H/f, 5, C, 5 * W/f): the affine of pixel
// (g, j), channel c is tab[b, g / f, class(g % f), c, (j / f) * 5 + class(j % f)].
//
// What bounds it on the H100: at 128^2, B=128, C=128, K=7 in bf16 it reads
// x (537 MB) and the tables (105 MB): 0.19 ms at 3.35 TB/s. It does 13.2 G
// multiply-adds with O padded to 4 (9.9 G useful), which as FMAs on the
// CUDA cores take several ms, so it is bound by FMA issue. K2's kernel
// (spade_few_out_conv.cu) keeps all C channels of a row tile and their
// weights in shared memory, which at C=128, W=128 does not fit even for one
// row; this kernel tiles the channels instead:
//   - one CTA of 256 threads per (image, tile of 1024 / W output rows);
//     each thread owns PX=4 adjacent output pixels x 4 (padded) channels,
//     whose f32 sums stay in registers across all channel chunks;
//   - per chunk of `cc` channels the CTA loads their C x K x K x 4 f32
//     weights and the tile's rows [r0 - K/2, r0 + rows + K/2) of x,
//     applying y = relu(x * A + B) as it loads and keeping y, zero outside
//     the image, in shared memory ([cc][rows + K - 1][W + K - 1]);
//   - each thread then re-uses each loaded row of y across the K column
//     taps, as K2 does.
// Tensor cores (an implicit GEMM with O padded to 8) are the next step.
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

}  // namespace

// K in {3, 5, 7}, 1 <= O <= 4, C % cc == 0, W % 4 == 0 dividing 1024,
// H % (1024 / W) == 0, H % f == 0, W % f == 0, f >= 5; returns the
// launch's cudaError_t.
extern "C" int spade_few_out_conv8(const void* x, const void* at, const void* bt, const void* w,
                                   const void* bias, void* out, int B, int C, int H, int W, int K,
                                   int O, int f, int cc, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_k<__nv_bfloat16>(x, at, bt, w, bias, out, B, C, H, W, K, O, f, cc, s);
  return (int)dispatch_k<float>(x, at, bt, w, bias, out, B, C, H, W, K, O, f, cc, s);
}
