// The layout encoder's eval residual trunk, fused into one launch.
//
// Replaces the TPU kernel aglayout_tpu/ops/pallas_resblocks.py::residual_trunk.
// R residual blocks [conv3x3 -> BN affine -> relu -> conv3x3 -> BN affine] +
// skip on a (B, C, 8, 8) map, C = 64 on the main path.
//
// What bounds it on the H100: each image needs 2 * R * 64 * C * 9 * C
// multiply-adds (28 M at C=64, R=6; 3.6 G a batch of 128, 7.3 us at the
// bf16 tensor-core peak) over data that never leaves the chip: the maps are
// 8x8 and the weights (R * 2 * 9 * C * C, 0.9 MB in bf16) sit in L2. As
// separate launches the trunk is ~40 kernels of a few microseconds each.
// One CTA per image makes it one launch, by one of two kernels that the
// wrapper (ops/resblocks.py) picks from the shapes and the dtype alone:
//   - bf16, C % 16 == 0, C <= 128 (namespace tc): each conv an implicit GEMM
//     on the tensor cores, the JAX kernel's 9 tap products on shifted
//     windows: M = 64 pixels, N = C, K = 9 C. The conv input and the
//     intermediate lie zero-padded and pixel-major, [10 x 10][C + 8] bf16,
//     so a tap (dy, dx) is a shift of the rows that ldmatrix reads for the A
//     operand, and the pixel stride, an odd multiple of 16 bytes, keeps
//     ldmatrix and the epilogue's stores free of bank conflicts. Eight
//     warps each own 16 pixels x C/2 channels of every conv's output
//     (mma.sync m16n8k16) and keep that share of the f32 skip chain in
//     registers in the accumulator layout across all 2 R convs. The
//     weights (0.9 MB a CTA, 113 MB from L2 a batch of 128) take about half
//     the kernel's time alone: a ninth warp streams them through a ring of
//     one-tap stages (C * C bf16, packed on the host in the B fragments'
//     order) by the copy engine, counted by full and empty mbarriers, so
//     conv i + 1's taps arrive while conv i multiplies. What bounds it is
//     the product with its epilogues: each warp reads its B fragments from
//     shared memory for one 16-pixel tile only;
//   - f32 (the reference path: TF32 would not hold 1e-4) and the other C: 4
//     * C threads, each owning 4 channels x 4 pixels of the output for all
//     12 convs with its share of the f32 skip chain in registers; the maps
//     zero-padded [C][10][10] in shared memory, each conv's 9 x C x C
//     weights streamed from L2 into shared memory between two barriers;
//     plain f32 FMAs.
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

// ---- bf16: the 12 convs on the tensor cores --------------------------------
namespace tc {

constexpr int CONSUMERS = 8;  // warps that multiply: 4 tiles of 16 pixels x 2 halves of C
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one that streams the weights
constexpr int MAX_STAGES = 16;
constexpr int RING = 256;  // bytes ahead of the ring: full[MAX_STAGES], empty[MAX_STAGES]
constexpr int NPIX = P * P;

// Byte offsets into the dynamic shared memory; computed on the host
// (ops/resblocks.trunk_tc_smem repeats it) and handed to the kernel.
struct Layout {
  int ps;           // elements between two pixels of a tile: C + 8
  int stage_bytes;  // one tap of one conv: C * C bf16
  int stages;       // ring stages: as many as fit, at most MAX_STAGES
  int xs, ts, total;
};
inline Layout layout(int C) {
  Layout l;
  l.ps = C + 8;
  l.stage_bytes = C * C * 2;
  const int tile = NPIX * l.ps * 2, fit = (agl::SMEM_LIMIT - RING - 2 * tile) / l.stage_bytes;
  l.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  l.xs = RING + l.stages * l.stage_bytes;  // [100][ps] bf16: the conv input, the rounded skip
  l.ts = l.xs + tile;                       // [100][ps] bf16: the intermediate
  l.total = l.ts + tile;
  return l;
}

// h: (B, C, 8, 8) bf16; wp: (R, 2, 9, C / 16, C / 8, 32, 4) bf16, the packed
// weights [block][conv][tap][k-step][n-tile][lane][b0 lo, hi, b1 lo, hi]
// (ops/resblocks.pack_trunk_weights); ab1, ab2: (R, 2, C) f32; out: (B, C,
// 8, 8) f32. C == 16 NT. Grid (B).
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
trunk_mma_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ wp,
                 const float* __restrict__ ab1, const float* __restrict__ ab2,
                 float* __restrict__ out, int R, const Layout L) {
  using T = __nv_bfloat16;
  constexpr int C = 16 * NT, KS = C / 16, NJ = C / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nstages = 2 * R * 9;
  auto full = [&](int s) { return agl::smem_u32(smem + s * 8); };
  auto empty = [&](int s) { return agl::smem_u32(smem + (MAX_STAGES + s) * 8); };
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      agl::mbar_init(full(s), 1);
      agl::mbar_init(empty(s), CONSUMERS);
    }
    agl::mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // every tap of every conv through the ring, in order
    if (lane == 0)
      for (int i = 0; i < nstages; ++i) {
        const int s = i % L.stages, round = i / L.stages;
        if (round > 0) agl::mbar_wait(empty(s), (round - 1) & 1);  // its last taps are read
        agl::mbar_arrive_expect_tx(full(s), L.stage_bytes);
        agl::bulk_copy_g2s(agl::smem_u32(smem + RING + s * L.stage_bytes), wp + (size_t)i * C * C,
                           L.stage_bytes, full(s));
      }
    return;
  }

  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ts = reinterpret_cast<T*>(smem + L.ts);
  const int ps = L.ps, ctid = tid;  // consumers are threads 0 .. 255
  const T* himg = h + (size_t)blockIdx.x * C * S * S;
  float* oimg = out + (size_t)blockIdx.x * C * S * S;
  // the tiles: x = h, pixel-major, and t = 0, each with its zero ring
  for (int i = ctid; i < NPIX * ps / 8; i += CONSUMERS * 32) {
    const int q = i / (ps / 8), y = q / P, x = q % P;
    if (y == 0 || y == P - 1 || x == 0 || x == P - 1)
      reinterpret_cast<uint4*>(xs)[i] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(ts)[i] = make_uint4(0, 0, 0, 0);
  }
  for (int i = ctid; i < C * S * S; i += CONSUMERS * 32) {
    const int c = i / (S * S), y = (i / S) % S, x = i % S;
    xs[((y + 1) * P + x + 1) * ps + c] = himg[i];
  }

  // this warp's share: output rows 2 mt and 2 mt + 1 (16 pixels), channels
  // nh C/2 .. (nh + 1) C/2 (NT n-tiles of 8). Lane (g, t) holds, of n-tile j,
  // element e: pixel (2 mt + e / 2, g), channel ch(j) + e % 2.
  const int mt = warp & 3, nh = warp >> 2, g = lane >> 2, t = lane & 3;
  auto ch = [&](int j) { return nh * (C / 2) + j * 8 + 2 * t; };
  auto tile_at = [&](int e2) { return ((2 * mt + e2 + 1) * P + g + 1) * ps; };  // pixel (2 mt + e2, g)
  float skip[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      skip[j][e] = __bfloat162float(himg[((ch(j) + (e & 1)) * S + 2 * mt + (e >> 1)) * S + g]);
  agl::named_barrier(1, CONSUMERS * 32);  // the tiles are whole

  // ldmatrix x4: lane supplies pixel lane % 16 of the tile (row 2 mt + (lane
  // % 16) / 8, column lane % 8) at tap (0, 0), channels 8 (lane / 16) on
  const int q0 = (2 * mt + ((lane & 15) >> 3)) * P + (lane & 7);
  float acc[NT][4];
  int stage = 0;  // the ring's running tap
  auto conv = [&](const T* in) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const uint32_t abase = agl::smem_u32(in + q0 * ps + 8 * (lane >> 4));
    for (int tap = 0; tap < 9; ++tap, ++stage) {
      const int s = stage % L.stages;
      agl::mbar_wait(full(s), (stage / L.stages) & 1);  // the tap's weights have landed
      const T* wst = reinterpret_cast<const T*>(smem + RING + s * L.stage_bytes) +
                     ((nh * NT) * 32 + lane) * 4;
      const uint32_t arow = abase + ((tap / 3) * P + tap % 3) * ps * 2;
      uint32_t a[KS][4];
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) agl::ldmatrix_x4(arow + kc * 32, a[kc]);
#pragma unroll
      for (int kc = 0; kc < KS; ++kc)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 bv = *reinterpret_cast<const uint2*>(wst + (kc * NJ + j) * 32 * 4);
          agl::mma_bf16(acc[j], a[kc], bv.x, bv.y);
        }
      __syncwarp();
      if (lane == 0) agl::mbar_arrive(empty(s));  // this warp is done with the stage
    }
  };
  // relu(acc * a + b) of conv 1, rounded, into the t tile
  auto epilogue1 = [&](int r) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(ab1 + (r * 2) * C + ch(j));
      const float2 b = *reinterpret_cast<const float2*>(ab1 + (r * 2 + 1) * C + ch(j));
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        *reinterpret_cast<__nv_bfloat162*>(ts + tile_at(e2) + ch(j)) = __floats2bfloat162_rn(
            fmaxf(acc[j][2 * e2] * a.x + b.x, 0.f), fmaxf(acc[j][2 * e2 + 1] * a.y + b.y, 0.f));
    }
  };
  // skip += acc * a + b of conv 2; the skip, rounded, into the x tile
  auto epilogue2 = [&](int r) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(ab2 + (r * 2) * C + ch(j));
      const float2 b = *reinterpret_cast<const float2*>(ab2 + (r * 2 + 1) * C + ch(j));
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        skip[j][2 * e2] += acc[j][2 * e2] * a.x + b.x;
        skip[j][2 * e2 + 1] += acc[j][2 * e2 + 1] * a.y + b.y;
        *reinterpret_cast<__nv_bfloat162*>(xs + tile_at(e2) + ch(j)) =
            __floats2bfloat162_rn(skip[j][2 * e2], skip[j][2 * e2 + 1]);
      }
    }
  };

  for (int r = 0; r < R; ++r) {
    conv(xs);
    epilogue1(r);
    agl::named_barrier(1, CONSUMERS * 32);  // t is whole; x is read by no one now
    conv(ts);
    epilogue2(r);
    agl::named_barrier(1, CONSUMERS * 32);  // x is whole; t is read by no one now
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      oimg[((ch(j) + (e & 1)) * S + 2 * mt + (e >> 1)) * S + g] = skip[j][e];
}

template <int NT>
cudaError_t launch(const void* h, const void* wp, const void* ab1, const void* ab2, void* out,
                   int B, int R, cudaStream_t stream) {
  const Layout L = layout(16 * NT);
  if (L.stages < 2 || L.total > agl::SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(trunk_mma_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  trunk_mma_kernel<NT><<<B, THREADS, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(ab1), static_cast<const float*>(ab2), static_cast<float*>(out), R,
      L);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The FMA kernel, f32 or bf16: C % 4 == 0, 4 <= C <= 256 as far as shared
// memory holds; returns the launch's cudaError_t.
extern "C" int residual_trunk(const void* h, const void* w1, const void* w2, const void* ab1,
                              const void* ab2, void* out, int B, int C, int R, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(h, w1, w2, ab1, ab2, out, B, C, R, s);
  return (int)launch<float>(h, w1, w2, ab1, ab2, out, B, C, R, s);
}

// bf16 on the tensor cores: C % 16 == 0, 16 <= C <= 128; wp from
// ops/resblocks.pack_trunk_weights. Returns the launch's cudaError_t.
extern "C" int residual_trunk_tc(const void* h, const void* wp, const void* ab1, const void* ab2,
                                 void* out, int B, int C, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return (int)tc::launch<1>(h, wp, ab1, ab2, out, B, R, s);
    case 32: return (int)tc::launch<2>(h, wp, ab1, ab2, out, B, R, s);
    case 48: return (int)tc::launch<3>(h, wp, ab1, ab2, out, B, R, s);
    case 64: return (int)tc::launch<4>(h, wp, ab1, ab2, out, B, R, s);
    case 80: return (int)tc::launch<5>(h, wp, ab1, ab2, out, B, R, s);
    case 96: return (int)tc::launch<6>(h, wp, ab1, ab2, out, B, R, s);
    case 112: return (int)tc::launch<7>(h, wp, ab1, ab2, out, B, R, s);
    case 128: return (int)tc::launch<8>(h, wp, ab1, ab2, out, B, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory a block of the tensor-core kernel takes.
extern "C" int residual_trunk_tc_smem(int C) { return tc::layout(C).total; }
