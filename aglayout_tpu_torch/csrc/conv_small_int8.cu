// int8 KxK same-pad conv on 8x8 maps: the wide ConvLSTM gate conv of the
// int8 serving configuration.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_conv8_int8.py::conv_small_int8. With x (B, Cin, 8,
// 8) in the compute dtype T, wq (Cout, K, K, Cin) int8 and sw (Cout) f32:
//   m[g]  = max |x| over the g-th chunk of gb images
//   q     = round_half_even(x * (127 / max(m, 1e-8)))          (no clip)
//   z     = conv(zero_pad(q), wq)                              (exact, s32)
//   out   = T(float(z) * ((max(m, 1e-8) / 127) * sw[co]))      (B, Cout, 8, 8)
// The Pallas kernel handles one chunk per grid step in VMEM; here the chunk
// only defines the scale, and three kernels run on the stream:
//   1. absmax_kernel: per-chunk max |x| by atomicMax on the float's bits
//      (non-negative floats order as unsigned integers);
//   2. quantize_kernel: reads x as it lies (NCHW), quantises, and writes the
//      zero-padded channels-last map q (B, P, P, Cp) int8, P = 8 + K - 1, Cp
//      = Cin rounded up to 32 (a transpose through shared memory; no NHWC
//      copy of x is made outside the kernel);
//   3. conv_kernel: the implicit GEMM M = 64 B, N = Cout, K = K*K*Cp on the
//      int8 tensor cores (mma.sync m16n8k32, s32 accumulation).
//
// What bounds it on the H100: operations. At B=128, 640 -> 512, K=5 it is
// 134 G int8 operations against 24 MB of operands, so the tensor cores'
// int8 rate is the floor and memory is far below it. The GEMM kernel gives a
// CTA 4 images (256 pixels) x 64 output channels, 8 warps of 64 pixels x 32
// channels (64 s32 accumulators a thread), and walks Cin in 32-channel
// steps: the 4 padded 12x12x32 maps (rows padded to 48 bytes) and the 64 x
// 25 x 32 weight slice (rows padded by 16 bytes) go to shared memory, and
// every tap is one k32 step whose A rows ldmatrix takes straight from the
// shifted padded map, so im2col is an address. Two CTAs fit an SM and hide
// each other's loads; the weights (8 MB) stay in L2 across launches.
// ldmatrix feeds 6 loads to 16 products, which keeps shared memory, not the
// tensor cores, the limit: wgmma with the weights resident is the next step.

#include "common.cuh"

namespace {

constexpr int S = 8;          // map side
constexpr int PIX = S * S;
constexpr int THREADS = 256;
constexpr int IM = 4;         // images per CTA of the GEMM
constexpr int BN = 64;        // output channels per CTA
constexpr int CK = 32;        // input channels per step: one m16n8k32 per tap
constexpr int ASTR = CK + 16; // bytes per pixel of the A tile (conflict-free ldmatrix)

// amax[g] = max |x| over chunk g, as float bits. Grid (splits, chunks).
template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax, size_t per_chunk) {
  const T* p = x + blockIdx.y * per_chunk;
  float m = 0.f;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < per_chunk;
       i += (size_t)gridDim.x * THREADS)
    m = fmaxf(m, fabsf(agl::to_f(p[i])));
  m = agl::warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(amax + blockIdx.y, __float_as_uint(m));
}

// x (B, Cin, 8, 8) T -> q (B, P, P, Cp) s8, zero ring and zero channels past
// Cin included. Grid (Cp / 32, B): one image and 32 channels a block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, const unsigned* __restrict__ amax,
                int8_t* __restrict__ q, int Cin, int Cp, int k, int gb) {
  __shared__ int qs[CK][PIX + 1];
  const int c0 = blockIdx.x * CK, b = blockIdx.y, r = k / 2, P = S + k - 1;
  const float inv = 127.f / fmaxf(__uint_as_float(amax[b / gb]), 1e-8f);
  for (int i = threadIdx.x; i < CK * PIX; i += THREADS) {
    const int c = i / PIX, p = i % PIX;
    qs[c][p] = c0 + c < Cin
                   ? __float2int_rn(agl::to_f(x[((size_t)b * Cin + c0 + c) * PIX + p]) * inv)
                   : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P * P * (CK / 4); i += THREADS) {
    const int pp = i / (CK / 4), wd = i % (CK / 4);
    const int y = pp / P - r, xx = pp % P - r;
    uint32_t v = 0;
    if (y >= 0 && y < S && xx >= 0 && xx < S) {
      const int p = y * S + xx;
      v = agl::pack_s8x4(qs[4 * wd][p], qs[4 * wd + 1][p], qs[4 * wd + 2][p], qs[4 * wd + 3][p]);
    }
    *reinterpret_cast<uint32_t*>(q + ((size_t)b * P * P + pp) * Cp + c0 + 4 * wd) = v;
  }
}

// q (B, P, P, Cp) s8; wq (Cout, K*K, Cp) s8; out (B, Cout, 8, 8) T.
// Grid (Cout / BN, ceil(B / IM)).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wq,
            const float* __restrict__ sw, const unsigned* __restrict__ amax, T* __restrict__ out,
            int B, int Cp, int Cout, int k, int gb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = S + k - 1, PP = P * P, KK = k * k;
  const int bstr = KK * CK + 16;  // bytes per output channel of the B tile
  unsigned char* as = smem;                    // [IM][PP][ASTR]
  unsigned char* bs = smem + IM * PP * ASTR;   // [BN][bstr]
  const int n0 = blockIdx.x * BN, b0 = blockIdx.y * IM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's image, and its 32-channel half
  const int g = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix addresses at tap (0, 0). A: m-tile i is map rows 2i and 2i + 1;
  // the lane gives pixel (2i + (lane % 16) / 8, lane % 8), bytes 16 (lane / 16).
  // B: matrices (n-tile, k half) = (2jj, 0), (2jj, 1), (2jj + 1, 0), (2jj + 1, 1).
  uint32_t a_base[4], b_base[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = 2 * i + ((lane & 15) >> 3), xx = lane & 7;
    a_base[i] = agl::smem_u32(as + (wm * PP + y * P + xx) * ASTR + (lane >> 4) * 16);
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
    b_base[jj] = agl::smem_u32(bs + (wn * 32 + (2 * jj + (lane >> 4)) * 8 + (lane & 7)) * bstr +
                               ((lane >> 3) & 1) * 16);

  for (int c0 = 0; c0 < Cp; c0 += CK) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < IM * PP * 2; i += THREADS) {
      const int px = i >> 1, half = i & 1, img = b0 + px / PP;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (img < B)
        v = *reinterpret_cast<const uint4*>(q + ((size_t)img * PP + px % PP) * Cp + c0 + half * 16);
      *reinterpret_cast<uint4*>(as + px * ASTR + half * 16) = v;
    }
    for (int i = tid; i < BN * KK * 2; i += THREADS) {
      const int seg = i >> 1, half = i & 1, n = seg / KK, tap = seg % KK;
      *reinterpret_cast<uint4*>(bs + n * bstr + tap * CK + half * 16) =
          *reinterpret_cast<const uint4*>(wq + ((size_t)(n0 + n) * KK + tap) * Cp + c0 + half * 16);
    }
    __syncthreads();
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx) {
        const uint32_t aoff = (dy * P + dx) * ASTR, boff = (dy * k + dx) * CK;
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) agl::ldmatrix_x4(a_base[i] + aoff, a[i]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) agl::ldmatrix_x4(b_base[jj] + boff, b[jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            agl::mma_s8(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
      }
  }

  // dequantise: accumulator (i, j, e) is pixel 16 i + 8 (e / 2) + g, channel
  // n0 + 32 wn + 8 j + 2 t + e % 2
  const int img = b0 + wm;
  if (img >= B) return;
  const float scale = fmaxf(__uint_as_float(amax[img / gb]), 1e-8f) / 127.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + wn * 32 + 8 * j + 2 * t + (e & 1);
      const float s = scale * sw[n];
      T* o = out + ((size_t)img * Cout + n) * PIX + 8 * (e >> 1) + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) o[16 * i] = agl::from_f<T>(__int2float_rn(acc[i][j][e]) * s);
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* wq, const void* sw, void* amax, void* q, void* out,
                   int B, int Cin, int Cp, int Cout, int k, int gb, cudaStream_t stream) {
  const int P = S + k - 1, chunks = B / gb;
  const size_t per_chunk = (size_t)gb * Cin * PIX;
  const size_t smem = (size_t)IM * P * P * ASTR + (size_t)BN * (k * k * CK + 16);
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned* am = static_cast<unsigned*>(amax);
  int8_t* qp = static_cast<int8_t*>(q);
  const int splits = (int)((per_chunk + 16 * THREADS - 1) / (16 * THREADS));
  absmax_kernel<T><<<dim3(splits, chunks), THREADS, 0, stream>>>(static_cast<const T*>(x), am,
                                                                per_chunk);
  quantize_kernel<T><<<dim3(Cp / CK, B), THREADS, 0, stream>>>(static_cast<const T*>(x), am, qp,
                                                              Cin, Cp, k, gb);
  conv_kernel<T><<<dim3(Cout / BN, (B + IM - 1) / IM), THREADS, smem, stream>>>(
      qp, static_cast<const int8_t*>(wq), static_cast<const float*>(sw), am,
      static_cast<T*>(out), B, Cp, Cout, k, gb);
  return cudaGetLastError();
}

}  // namespace

// x (B, Cin, 8, 8); wq (Cout, k, k, Cp) s8 with Cp = Cin rounded up to 32
// and zeros past Cin; sw (Cout) f32; amax (B / gb) zeroed scratch; q (B, 8 +
// k - 1, 8 + k - 1, Cp) s8 scratch; out (B, Cout, 8, 8). B % gb == 0, Cp %
// 32 == 0, Cout % 64 == 0, k odd and <= 7. Returns the launches'
// cudaError_t.
extern "C" int conv_small_int8(const void* x, const void* wq, const void* sw, void* amax, void* q,
                               void* out, int B, int Cin, int Cp, int Cout, int k, int gb,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, wq, sw, amax, q, out, B, Cin, Cp, Cout, k, gb, s);
  return (int)launch<float>(x, wq, sw, amax, q, out, B, Cin, Cp, Cout, k, gb, s);
}
