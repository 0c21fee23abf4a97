// The layout encoder's eval residual trunk, fused into one launch.
//
// Replaces the TPU kernel aglayout_tpu/ops/pallas_resblocks.py::residual_trunk.
// R residual blocks [conv3x3 -> BN affine -> relu -> conv3x3 -> BN affine] +
// skip on a (B, C, 8, 8) map, C = 64 on the main path.
//
// What bounds it on the H100: each image needs 2 * R * 64 * C * 9 * C
// multiply-adds (28 M at C=64, R=6) over data that never leaves the chip:
// the maps are 8x8 and the weights (R * 2 * 9 * C * C, 0.9 MB in bf16) sit
// in L2. As separate launches the trunk is ~40 kernels of a few
// microseconds each, so launch latency and the round trips of the small
// maps through device memory dominate. This kernel makes that one launch:
//   - one CTA per image, 4 * C threads; each thread owns 4 channels x 4
//     pixels of the output for all 12 convs, and keeps its share of the f32
//     skip chain in registers;
//   - the conv input and the intermediate sit zero-padded (C x 10 x 10) in
//     shared memory in the compute dtype, so the conv padding is free;
//   - each conv's 9 x C x C weights are streamed from L2 into shared memory
//     (74 KB in bf16 at C=64, hence the dynamic shared memory attribute);
//   - plain f32 FMAs. Tensor cores (mma.sync / wgmma) are later work.
// Numerics match pallas_resblocks.py:66-83: conv operands in the compute
// dtype, f32 accumulation, BN affine and relu in f32, f32 skip, f32 output.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int S = 8;   // map side
constexpr int P = 10;  // padded map side
constexpr int PX = 4;  // pixels per thread, along one row
constexpr int CX = 4;  // output channels per thread

template <typename T>
__device__ void load_weights(T* ws, const T* __restrict__ w, int n) {
  // n elements; n * sizeof(T) is a multiple of 16 (C % 4 == 0)
  __syncthreads();  // every thread is done with the previous weights
  const int4* src = reinterpret_cast<const int4*>(w);
  int4* dst = reinterpret_cast<int4*>(ws);
  const int nvec = n * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// acc[cc][px] = sum over taps and input channels of in * w, for this
// thread's channels c0 + cc and pixels (row, col0 + px).
template <typename T>
__device__ __forceinline__ void conv3x3(const T* in, const T* ws, int C, int row, int col0,
                                        int c0, float acc[CX][PX]) {
#pragma unroll
  for (int cc = 0; cc < CX; ++cc)
#pragma unroll
    for (int px = 0; px < PX; ++px) acc[cc][px] = 0.f;
  for (int cin = 0; cin < C; ++cin) {
    const T* src = in + cin * P * P + row * P + col0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float xv[PX + 2];
#pragma unroll
      for (int i = 0; i < PX + 2; ++i) xv[i] = agl::to_f(src[dy * P + i]);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float wv[CX];
        agl::load4(ws + ((dy * 3 + dx) * C + cin) * C + c0, wv);
#pragma unroll
        for (int cc = 0; cc < CX; ++cc)
#pragma unroll
          for (int px = 0; px < PX; ++px) acc[cc][px] = fmaf(wv[cc], xv[px + dx], acc[cc][px]);
      }
    }
  }
}

// h: (B, C, 8, 8) T; w1, w2: (R, 3, 3, C, C) T, [tap][cin][cout];
// ab1, ab2: (R, 2, C) f32; out: (B, C, 8, 8) f32.
template <typename T>
__global__ void residual_trunk_kernel(const T* __restrict__ h, const T* __restrict__ w1,
                                      const T* __restrict__ w2, const float* __restrict__ ab1,
                                      const float* __restrict__ ab2, float* __restrict__ out,
                                      int C, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xp = reinterpret_cast<T*>(smem_raw);  // [C][P][P] padded conv input
  T* tp = xp + C * P * P;                  // [C][P][P] padded intermediate
  T* ws = tp + C * P * P;                  // [9][C][C] one conv's weights

  const int tid = threadIdx.x;
  const int pg = tid & 15;  // pixel group: row pg / 2, columns (pg % 2) * 4 + [0, 4)
  const int row = pg >> 1;
  const int col0 = (pg & 1) * PX;
  const int c0 = (tid >> 4) * CX;
  const T* himg = h + (size_t)blockIdx.x * C * S * S;
  float* oimg = out + (size_t)blockIdx.x * C * S * S;

  for (int i = tid; i < 2 * C * P * P; i += blockDim.x) xp[i] = agl::from_f<T>(0.f);
  __syncthreads();
  for (int i = tid; i < C * S * S; i += blockDim.x) {
    const int c = i / (S * S), y = (i / S) % S, x = i % S;
    xp[(c * P + y + 1) * P + x + 1] = himg[i];
  }
  float skip[CX][PX];
#pragma unroll
  for (int cc = 0; cc < CX; ++cc)
#pragma unroll
    for (int px = 0; px < PX; ++px)
      skip[cc][px] = agl::to_f(himg[((c0 + cc) * S + row) * S + col0 + px]);

  float acc[CX][PX];
  for (int r = 0; r < R; ++r) {
    load_weights(ws, w1 + (size_t)r * 9 * C * C, 9 * C * C);
    conv3x3(xp, ws, C, row, col0, c0, acc);
#pragma unroll
    for (int cc = 0; cc < CX; ++cc) {
      const float a = ab1[(r * 2) * C + c0 + cc], b = ab1[(r * 2 + 1) * C + c0 + cc];
#pragma unroll
      for (int px = 0; px < PX; ++px)
        tp[((c0 + cc) * P + row + 1) * P + col0 + px + 1] =
            agl::from_f<T>(fmaxf(acc[cc][px] * a + b, 0.f));
    }
    // the syncs in load_weights also order the tp writes before conv2 reads them
    load_weights(ws, w2 + (size_t)r * 9 * C * C, 9 * C * C);
    conv3x3(tp, ws, C, row, col0, c0, acc);
#pragma unroll
    for (int cc = 0; cc < CX; ++cc) {
      const float a = ab2[(r * 2) * C + c0 + cc], b = ab2[(r * 2 + 1) * C + c0 + cc];
#pragma unroll
      for (int px = 0; px < PX; ++px) {
        skip[cc][px] += acc[cc][px] * a + b;
        // xp is read again only after the next load_weights' barriers
        xp[((c0 + cc) * P + row + 1) * P + col0 + px + 1] = agl::from_f<T>(skip[cc][px]);
      }
    }
  }
#pragma unroll
  for (int cc = 0; cc < CX; ++cc)
#pragma unroll
    for (int px = 0; px < PX; ++px) oimg[((c0 + cc) * S + row) * S + col0 + px] = skip[cc][px];
}

template <typename T>
cudaError_t launch(const void* h, const void* w1, const void* w2, const void* ab1,
                   const void* ab2, void* out, int B, int C, int R, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * C * P * P + 9 * C * C) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      residual_trunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  residual_trunk_kernel<T><<<B, 4 * C, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const float*>(ab1), static_cast<const float*>(ab2),
      static_cast<float*>(out), C, R);
  return cudaGetLastError();
}

}  // namespace

// C % 4 == 0, 4 <= C <= 256; returns the launch's cudaError_t.
extern "C" int residual_trunk(const void* h, const void* w1, const void* w2, const void* ab1,
                              const void* ab2, void* out, int B, int C, int R, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(h, w1, w2, ab1, ab2, out, B, C, R, s);
  return (int)launch<float>(h, w1, w2, ab1, ab2, out, B, C, R, s);
}
