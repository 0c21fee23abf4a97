// SPADE apply + relu, dynamic per-image int8 quantisation, 5x5 int8 conv
// C -> C, dequantisation: the int8 form of the 128^2 decoder's SPADE-4 + c6.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_spade_c6_int8.py::spade_c6_int8. With x (B, C, H,
// W) in the compute dtype T, A and B the compact SPADE tables (B, H/f, 5, C,
// 5 W/f) (see spade_apply.cu), w6q (C, 5, 5, C) int8 (output channel first,
// input channel last) and sw6 (C) f32:
//   y     = T(relu(x * A + B))            f32 multiply, f32 add, one rounding
//   m[b]  = max y over image b
//   q     = round_half_even(float(y) * (127 / max(m, 1e-8)))
//   z     = conv(zero_pad(q), w6q)                              (exact, s32)
//   out   = T(float(z) * ((max(m, 1e-8) / 127) * sw6[co]))
// The scale needs the whole applied image, which a TPU core holds in VMEM
// and an SM does not, so two kernels run on the stream:
//   1. max_kernel: y and its per-image max (atomicMax on the float's bits;
//      y >= 0), one CTA per (image, f-row block, channel block) as in
//      spade_apply.cu; y is not stored;
//   2. conv_kernel: a CTA per (image, 8 x 32 output pixels, 128 output
//      channels) recomputes y on its 12 x 36 halo tile straight from x
//      (NCHW) and the tables, quantises it into shared memory as
//      channels-last int8 (zero outside the image), and runs the implicit
//      GEMM M = 256, N = 128, K = 25 C on the int8 tensor cores (mma.sync
//      m16n8k32): each tap's A rows are ldmatrix reads of the shifted tile,
//      and each tap's 128 x C weight slice streams from L2 through a
//      cp.async double buffer. The s32 sums are dequantised into shared
//      memory and written out as whole 32-pixel rows.
//
// What bounds it on the H100: operations. At (128, 128, 128, 128) it is
// 1.72 T int8 operations (0.87 ms at the dense int8 peak) against 1.2 GB of
// x, tables and output (0.35 ms). 16 warps of 64 pixels x 32 channels share
// one A tile, so x is read and quantised once per output tile (1.7x halo
// overhead), never per channel block.
// The multiply and add of the apply are kept separate (no fused
// multiply-add) so that y, and with it every quantised value, equals the
// plain PyTorch version bit for bit.

#include "common.cuh"

namespace {

constexpr int KS = 5, R = KS / 2, TAPS = KS * KS;
constexpr int TH = 8, TW = 32;              // output pixels per CTA
constexpr int HTH = TH + 2 * R, HTW = TW + 2 * R;  // the halo tile
constexpr int BN = 128;                     // output channels per CTA
constexpr int THREADS = 512;
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float apply(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.f);
}

// ymax[b] = max relu(x * A + B) rounded to T, as float bits.
// Grid (C / cb, H / f, B); tables staged as in spade_apply.cu.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
max_kernel(const T* __restrict__ x, const T* __restrict__ at, const T* __restrict__ bt,
           unsigned* __restrict__ ymax, int C, int H, int W, int f, int cb) {
  extern __shared__ __align__(16) float tabs[];  // [2][5][cb][W5]
  const int W5 = (W / f) * 5, HB = H / f;
  const int c0 = blockIdx.x * cb, hb = blockIdx.y, b = blockIdx.z;
  const int tsize = 5 * cb * W5;
  float* ta = tabs;
  float* tb = tabs + tsize;
  for (int i = threadIdx.x; i < tsize; i += MAX_THREADS) {
    const int rc = i / (cb * W5), rem = i % (cb * W5);
    const size_t src = (((size_t)b * HB + hb) * 5 + rc) * C * W5 + (size_t)c0 * W5 + rem;
    ta[i] = agl::to_f(at[src]);
    tb[i] = agl::to_f(bt[src]);
  }
  __syncthreads();

  using V = agl::Vec16<T>;
  const int nv = W / V::N, total = cb * f * nv;
  float m = 0.f;
  for (int i = threadIdx.x; i < total; i += MAX_THREADS) {
    const int jv = i % nv, row = i / nv, u = row % f, c = row / f;
    const size_t base = (((size_t)b * C + c0 + c) * H + (size_t)hb * f + u) * W + jv * V::N;
    const int tab = (agl::row_class(u, f) * cb + c) * W5;
    V v;
    v.raw = *reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int e = 0; e < V::N; ++e) {
      const int col = tab + agl::compact_col(jv * V::N + e, f);
      m = fmaxf(m, agl::to_f(agl::from_f<T>(apply(agl::to_f(v.v()[e]), ta[col], tb[col]))));
    }
  }
  m = agl::warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(ymax + b, __float_as_uint(m));
}

__host__ __device__ inline size_t conv_smem_bytes(int C, int elem) {
  const size_t tiles = (size_t)HTH * HTW * (C + 16) + 2 * (size_t)BN * (C + 16);
  const size_t stage = (size_t)BN * (TH * TW + 8) * elem;
  return tiles > stage ? tiles : stage;
}

// Grid ((H / TH) * (W / TW), C / BN, B).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const T* __restrict__ x, const T* __restrict__ at, const T* __restrict__ bt,
            const int8_t* __restrict__ wq, const float* __restrict__ sw,
            const unsigned* __restrict__ ymax, T* __restrict__ out, int C, int H, int W, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int str = C + 16;  // bytes per pixel of the A tile and per channel of a B tile
  unsigned char* as = smem;                         // [HTH * HTW][str]
  unsigned char* bs = smem + HTH * HTW * str;       // [2][BN][str]
  const int tiles_w = W / TW;
  const int gy0 = (blockIdx.x / tiles_w) * TH, gx0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // tile rows 2 wm, 2 wm + 1; channels 32 wn ..
  const int g = lane >> 2, t = lane & 3;
  const int W5 = (W / f) * 5, HB = H / f;
  const float m = fmaxf(__uint_as_float(ymax[b]), 1e-8f);
  const float inv = 127.f / m, scale = m / 127.f;

  // one tap's weight slice (BN x C bytes) into buffer `buf`
  const int wv = C / 16;
  auto load_b = [&](int tap, int buf) {
    for (int i = tid; i < BN * wv; i += THREADS) {
      const int n = i / wv, v = i % wv;
      agl::cp_async16(agl::smem_u32(bs + ((size_t)buf * BN + n) * str + v * 16),
                 wq + ((size_t)(n0 + n) * TAPS + tap) * C + v * 16);
    }
  };
  load_b(0, 0);
  agl::cp_async_commit();

  // the quantised halo tile: lanes along the tile's pixels, 4 channels a store
  for (int i = tid; i < HTH * HTW * (C / 4); i += THREADS) {
    const int px = i % (HTH * HTW), cq = i / (HTH * HTW);
    const int gy = gy0 - R + px / HTW, gx = gx0 - R + px % HTW;
    uint32_t packed = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int rc = agl::row_class(gy % f, f), col = agl::compact_col(gx, f);
      int qv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * cq + e;
        const size_t ti = ((((size_t)b * HB + gy / f) * 5 + rc) * C + c) * W5 + col;
        const float y = apply(agl::to_f(x[(((size_t)b * C + c) * H + gy) * W + gx]),
                              agl::to_f(at[ti]), agl::to_f(bt[ti]));
        qv[e] = __float2int_rn(agl::to_f(agl::from_f<T>(y)) * inv);
      }
      packed = agl::pack_s8x4(qv[0], qv[1], qv[2], qv[3]);
    }
    *reinterpret_cast<uint32_t*>(as + px * str + 4 * cq) = packed;
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix addresses at tap (0, 0), channel 0. A: m-tile i is tile row
  // 2 wm + i / 2, columns 16 (i % 2) .. + 15. B as in conv_small_int8.cu.
  uint32_t a_base[4], b_base[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ty = 2 * wm + (i >> 1), tx = 16 * (i & 1) + (lane & 15);
    a_base[i] = agl::smem_u32(as + (ty * HTW + tx) * str + (lane >> 4) * 16);
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
    b_base[jj] = agl::smem_u32(bs + (wn * 32 + (2 * jj + (lane >> 4)) * 8 + (lane & 7)) * str +
                               ((lane >> 3) & 1) * 16);

  for (int tap = 0; tap < TAPS; ++tap) {
    if (tap + 1 < TAPS) load_b(tap + 1, (tap + 1) & 1);
    agl::cp_async_commit();
    agl::cp_async_wait_1();  // this tap's slice has landed (this thread's part)
    __syncthreads();    // ... and everyone's; at tap 0 the A tile too
    const uint32_t aoff = ((tap / KS) * HTW + tap % KS) * str;
    const uint32_t boff = (tap & 1) * BN * str;
    for (int c0 = 0; c0 < C; c0 += 32) {
      uint32_t a[4][4], bb[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) agl::ldmatrix_x4(a_base[i] + aoff + c0, a[i]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) agl::ldmatrix_x4(b_base[jj] + boff + c0, bb[jj]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          agl::mma_s8(acc[i][j], a[i], bb[j >> 1][(j & 1) * 2], bb[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();  // the buffer is free for tap + 2's slice
  }

  // dequantise into shared memory, [channel][256 pixels + 8], over the tiles
  T* os = reinterpret_cast<T*>(smem);
  constexpr int OSTR = TH * TW + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = wn * 32 + 8 * j + 2 * t + (e & 1);
      const float s = scale * sw[n0 + n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ty = 2 * wm + (i >> 1), tx = 16 * (i & 1) + 8 * (e >> 1) + g;
        os[n * OSTR + ty * TW + tx] = agl::from_f<T>(__int2float_rn(acc[i][j][e]) * s);
      }
    }
  __syncthreads();
  using V = agl::Vec16<T>;
  constexpr int XV = TW / V::N;
  for (int i = tid; i < BN * TH * XV; i += THREADS) {
    const int xv = i % XV, ty = (i / XV) % TH, n = i / (XV * TH);
    *reinterpret_cast<uint4*>(out + (((size_t)b * C + n0 + n) * H + gy0 + ty) * W + gx0 +
                              xv * V::N) =
        *reinterpret_cast<const uint4*>(os + n * OSTR + ty * TW + xv * V::N);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* at, const void* bt, const void* wq, const void* sw,
                   void* ymax, void* out, int B, int C, int H, int W, int f, int cb,
                   cudaStream_t stream) {
  const size_t smem_max = 2 * 5 * (size_t)cb * (W / f) * 5 * sizeof(float);
  const size_t smem_conv = conv_smem_bytes(C, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(max_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_conv);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* ap = static_cast<const T*>(at);
  const T* bp = static_cast<const T*>(bt);
  unsigned* ym = static_cast<unsigned*>(ymax);
  max_kernel<T><<<dim3(C / cb, H / f, B), MAX_THREADS, smem_max, stream>>>(xp, ap, bp, ym, C, H, W,
                                                                          f, cb);
  conv_kernel<T><<<dim3((H / TH) * (W / TW), C / BN, B), THREADS, smem_conv, stream>>>(
      xp, ap, bp, static_cast<const int8_t*>(wq), static_cast<const float*>(sw), ym,
      static_cast<T*>(out), C, H, W, f);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, C, H, W); at, bt compact (B, H/f, 5, C, 5 W/f); wq (C, 5, 5, C)
// s8; sw (C) f32; ymax (B) zeroed scratch. C % 128 == 0, C % cb == 0, H % 8
// == 0, W % 32 == 0, H % f == 0, W % f == 0, f >= 5. Returns the launches'
// cudaError_t.
extern "C" int spade_c6_int8(const void* x, const void* at, const void* bt, const void* wq,
                             const void* sw, void* ymax, void* out, int B, int C, int H, int W,
                             int f, int cb, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, at, bt, wq, sw, ymax, out, B, C, H, W, f, cb, s);
  return (int)launch<float>(x, at, bt, wq, sw, ymax, out, B, C, H, W, f, cb, s);
}
