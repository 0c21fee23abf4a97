// The decoder's RGB head: SPADE apply + relu + a KxK conv to O <= 4 channels,
// in the three modes of the TPU kernel it replaces,
// aglayout_tpu/ops/pallas_spade_conv.py::spade_few_out_conv:
//   FLAT        x (B, C, H, W); tables (B, H/f, 5, C, W): the affine of pixel
//               (g, j), channel c is tab[b, g / f, class(g % f), c, j];
//   COMPACT     (the Pallas compact=True) the same x; class-resolution tables
//               (B, H/f, 5, C, 5 W/f), the column expanded here as the index
//               (j / f) * 5 + class(j % f), where the Pallas kernel spends a
//               one-hot matmul per program; no flat table is ever built;
//   TRANSPOSED  (the Pallas transposed=True) x laid out (H, W, B, C), flat
//               tables; the loads run along C, 16 bytes a thread.
// out = conv(relu(x * A + B)) + bias, (B, O, H, W), A and B the SPADE+BN
// folded affine.
//
// Two kernels, which the wrapper (ops/spade_conv.py) picks between from the
// shapes, the dtype and the alignment alone:
//   - bf16, in any mode, where it takes the shapes (C % 16 == 0, W in {64,
//     128}, H % 8 == 0, the tables' rows within shared memory): K3's
//     implicit GEMM on the tensor cores, spade_head_tc.cuh, with the table
//     layout and x's as template parameters (TRANSPOSED: x comes by a TMA
//     tensor copy and is applied in place). What bounds K2 on the H100 was FMA
//     throughput, not bytes: at the 64^2 c4 head (B=128, C=64, K=7, bf16) it
//     reads x (67 MB) and two flat tables (84 MB together), 46 us at 3.35
//     TB/s, and does 6.6 G multiply-adds with O padded to 4 (4.9 G at O=3),
//     which the CUDA cores took 0.7 ms over; the tensor cores take them in
//     a fraction of the apply pass's time. COMPACT runs the very kernel K3
//     runs, so the two give the same bits;
//   - f32 (the reference path: TF32 would not hold 1e-4) and the shapes
//     the tensor-core kernel does not take: FMAs on the CUDA cores, below.
//     The design keeps the bytes near the floor and tiles the channels, so
//     that any C fits:
//       * one CTA of 256 threads per (image, tile of `rows` output rows,
//         rows * W <= 512); a thread owns PX=2 adjacent output pixels x 4
//         (padded) channels, whose f32 sums stay in registers across the
//         channel chunks;
//       * per chunk of `cc` channels the CTA loads their cc x K x K x 4 f32
//         weights and rows [r0 - K/2, r0 + rows + K/2) of x, applies y =
//         relu(x * A + B) as it loads and keeps y, zero outside the image,
//         in shared memory ([cc][rows + K - 1][W + K - 1]); the halo's extra
//         reads come mostly from L2; COMPACT looks its table column up in a
//         small map made once a block, not by a division per element;
//       * each thread re-uses each loaded row of y across the K column taps.
// Numerics match pallas_spade_conv.py:92-137: y in f32, rounded to the
// compute dtype; the zero padding applies to y; f32 accumulation.

#include <stdint.h>

#include "common.cuh"
#include "spade_head_tc.cuh"

namespace {

constexpr int PX = 2;  // output pixels per thread, along one row
constexpr int THREADS = 256;
enum Mode { FLAT = 0, COMPACT = 1, TRANSPOSED = 2 };

// x: (B, C, H, W) T, or (H, W, B, C) T when TRANSPOSED; at, bt: (B, H/f, 5,
// C, TWD) T with TWD = W, or 5 W/f when COMPACT; w: (C, K, K, 4) f32; bias:
// (4,) f32; out: (B, O, H, W) T. rows * W <= THREADS * PX. Grid (H / rows, B).
template <typename T, int K, int MODE>
__global__ void __launch_bounds__(THREADS)
spade_few_out_conv_kernel(const T* __restrict__ x, const T* __restrict__ at,
                          const T* __restrict__ bt, const float* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ out, int B, int C, int H,
                          int W, int O, int f, int rows, int cc) {
  constexpr int r = K / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* colmap = reinterpret_cast<int*>(smem_raw);  // [W, padded to 4]; COMPACT: table column of column j
  float* ws = reinterpret_cast<float*>(colmap + (W + 3) / 4 * 4);  // [cc][K][K][4]
  T* ys = reinterpret_cast<T*>(ws + cc * K * K * 4);               // [cc][TH][TW]
  const int TW = W + 2 * r, TH = rows + 2 * r, TWD = MODE == COMPACT ? (W / f) * 5 : W;
  const int b = blockIdx.y, r0 = blockIdx.x * rows, HB = H / f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = THREADS / 32;
  const bool owner = tid < rows * (W / PX);  // this thread has output pixels
  const int oy = owner ? tid / (W / PX) : 0, ox0 = owner ? (tid % (W / PX)) * PX : 0;

  float acc[PX][4];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[p][o] = bias[o];
  if (MODE == COMPACT)  // the first barrier of the chunk loop publishes it
    for (int j = tid; j < W; j += THREADS) colmap[j] = agl::compact_col(j, f);

  for (int c0 = 0; c0 < C; c0 += cc) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < cc * K * K; i += THREADS)
      reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(w)[c0 * K * K + i];
    if (MODE == TRANSPOSED) {
      // one 16-byte vector of channels per (tile row, column): lanes walk
      // the columns, so the shared-memory stores of one channel are adjacent
      using V = agl::Vec16<T>;
      const int nv = cc / V::N;
      for (int i = tid; i < nv * TH * TW; i += THREADS) {
        const int tx = i % TW, ty = (i / TW) % TH, cv = i / (TW * TH);
        const int g = r0 + ty - r, j = tx - r;
        const bool inside = g >= 0 && g < H && j >= 0 && j < W;
        V v;
        size_t toff = 0;
        if (inside) {
          const int c = c0 + cv * V::N;
          v.raw = *reinterpret_cast<const uint4*>(x + (((size_t)g * W + j) * B + b) * C + c);
          toff = ((((size_t)b * HB + g / f) * 5 + agl::row_class(g % f, f)) * C + c) * W + j;
        }
#pragma unroll
        for (int e = 0; e < V::N; ++e) {
          float y = 0.f;
          if (inside)
            y = fmaxf(agl::to_f(v.v()[e]) * agl::to_f(at[toff + (size_t)e * W]) +
                          agl::to_f(bt[toff + (size_t)e * W]), 0.f);
          ys[((size_t)(cv * V::N + e) * TH + ty) * TW + tx] = agl::from_f<T>(y);
        }
      }
    } else {
      // one warp per (channel, tile row); lanes walk the columns
      for (int cr = warp; cr < cc * TH; cr += nwarps) {
        const int c = c0 + cr / TH, ty = cr % TH, g = r0 + ty - r;
        T* yrow = ys + (size_t)cr * TW;
        if (g < 0 || g >= H) {
          for (int tx = lane; tx < TW; tx += 32) yrow[tx] = agl::from_f<T>(0.f);
          continue;
        }
        const T* xrow = x + (((size_t)b * C + c) * H + g) * W;
        const size_t toff = ((((size_t)b * HB + g / f) * 5 + agl::row_class(g % f, f)) * C + c) * TWD;
        for (int tx = lane; tx < TW; tx += 32) {
          const int j = tx - r;
          float y = 0.f;
          if (j >= 0 && j < W) {
            const int col = MODE == COMPACT ? colmap[j] : j;
            y = fmaxf(agl::to_f(xrow[j]) * agl::to_f(at[toff + col]) + agl::to_f(bt[toff + col]), 0.f);
          }
          yrow[tx] = agl::from_f<T>(y);
        }
      }
    }
    __syncthreads();

    if (owner) {
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
  }
  if (!owner) return;
#pragma unroll
  for (int o = 0; o < 4; ++o) {  // static indices keep acc in registers
    if (o >= O) break;
    T* orow = out + (((size_t)b * O + o) * H + r0 + oy) * W + ox0;
#pragma unroll
    for (int p = 0; p < PX; ++p) orow[p] = agl::from_f<T>(acc[p][o]);
  }
}

template <typename T, int K, int MODE>
cudaError_t launch(const void* x, const void* at, const void* bt, const void* w,
                   const void* bias, void* out, int B, int C, int H, int W, int O, int f,
                   int rows, int cc, cudaStream_t stream) {
  const size_t smem = (size_t)((W + 3) / 4 * 4) * sizeof(int) + (size_t)cc * K * K * 4 * sizeof(float) +
                      (size_t)cc * (rows + K - 1) * (W + K - 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(spade_few_out_conv_kernel<T, K, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / rows, B);
  spade_few_out_conv_kernel<T, K, MODE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<T*>(out), B, C,
      H, W, O, f, rows, cc);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dispatch_mode(int mode, const void* x, const void* at, const void* bt, const void* w,
                          const void* bias, void* out, int B, int C, int H, int W, int O, int f,
                          int rows, int cc, cudaStream_t s) {
  switch (mode) {
    case FLAT: return launch<T, K, FLAT>(x, at, bt, w, bias, out, B, C, H, W, O, f, rows, cc, s);
    case COMPACT: return launch<T, K, COMPACT>(x, at, bt, w, bias, out, B, C, H, W, O, f, rows, cc, s);
    case TRANSPOSED: return launch<T, K, TRANSPOSED>(x, at, bt, w, bias, out, B, C, H, W, O, f, rows, cc, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_k(int mode, const void* x, const void* at, const void* bt, const void* w,
                       const void* bias, void* out, int B, int C, int H, int W, int K, int O,
                       int f, int rows, int cc, cudaStream_t s) {
  switch (K) {
    case 3: return dispatch_mode<T, 3>(mode, x, at, bt, w, bias, out, B, C, H, W, O, f, rows, cc, s);
    case 5: return dispatch_mode<T, 5>(mode, x, at, bt, w, bias, out, B, C, H, W, O, f, rows, cc, s);
    case 7: return dispatch_mode<T, 7>(mode, x, at, bt, w, bias, out, B, C, H, W, O, f, rows, cc, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K in {3, 5, 7}, 1 <= O <= 4, W even, H % rows == 0, rows * W <= 512,
// H % f == 0, C % cc == 0; mode 0 flat, 1 compact (W % f == 0), 2
// transposed (cc a multiple of the 16-byte vector, x 16-byte aligned);
// returns the launch's cudaError_t.
extern "C" int spade_few_out_conv(const void* x, const void* at, const void* bt, const void* w,
                                  const void* bias, void* out, int B, int C, int H, int W, int K,
                                  int O, int f, int rows, int cc, int mode, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_k<__nv_bfloat16>(mode, x, at, bt, w, bias, out, B, C, H, W, K, O, f, rows, cc, s);
  return (int)dispatch_k<float>(mode, x, at, bt, w, bias, out, B, C, H, W, K, O, f, rows, cc, s);
}

// The tensor-core kernel, bf16, in mode 0 (flat tables), 1 (compact tables)
// or 2 (transposed: x (H, W, B, C), flat tables, read by one TMA tensor copy a
// chunk): wp is the packed (C / 16, K, NP, 16) operand
// (ops/spade_conv.pack_head8_weights), bias (4,) f32; the limits stand at
// tc::dispatch (mode 2: also B C 2 % 16 == 0, the tensor map's strides).
// Returns the launch's cudaError_t.
extern "C" int spade_few_out_conv_tc(const void* x, const void* at, const void* bt,
                                     const void* wp, const void* bias, void* out, int B, int C,
                                     int H, int W, int K, int O, int f, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case FLAT:
      return (int)tc::dispatch<false, false>(x, at, bt, wp, bias, out, B, C, H, W, K, O, f, s);
    case COMPACT:
      return (int)tc::dispatch<true, false>(x, at, bt, wp, bias, out, B, C, H, W, K, O, f, s);
    case TRANSPOSED:
      return (int)tc::dispatch<false, true>(x, at, bt, wp, bias, out, B, C, H, W, K, O, f, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory a block of the tensor-core kernel takes in
// `mode`.
extern "C" int spade_few_out_conv_tc_smem(int H, int W, int K, int O, int f, int mode) {
  return tc::layout(H, W, K, O, f, mode == COMPACT, mode == TRANSPOSED).total;
}
