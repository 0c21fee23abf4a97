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
//      zero-padded map q in the order the product's copies and descriptors
//      take it (below);
//   3. conv_kernel: the implicit GEMM z^T = W (Cout x K*K*Cp) . Q^T (K*K*Cp x
//      64 B) on the int8 tensor cores (wgmma, s32 sums).
//
// What bounds it on the H100: operations. At B=128, 640 -> 512, K=5 it is
// 134 G int8 operations (0.068 ms at 1,979 TOP/s) against 24 MB of operands
// (0.007 ms at 3.35 TB/s). The design, for a card where a warpgroup's wgmma
// reads both operands from shared memory:
//   - the output channels are the product's M and the pixels its N, so one
//     wgmma m64n256k32 covers 64 channels x 4 images (256 pixels, in the
//     order (y, image, x)) and each 64-channel weight slice is read by the
//     tensor cores for 256 pixels at a time;
//   - a CTA is 64 channels x 8 images: two consumer warpgroups of 4 images
//     each, 128 s32 sums a thread, and two producer warps. 8 images a CTA
//     halve the weight stream from L2 against 4 (128 MB a call at the shape
//     above, 16 image groups x 8 MB); (Cout / 64) x (B / 8) = 128 CTAs fill
//     the card in one wave;
//   - one producer warp asks the copy engine (cp.async.bulk + mbarrier) for
//     the weights, packed on the host in k32 steps (input-channel chunk, tap)
//     with the 128-byte swizzle (ops/conv8_int8.pack_conv_small_int8_weights),
//     16 KB a slice through a ring of as many stages as shared memory leaves
//     (9 at K=5: with 4 the stream was latency-bound and took as long as the
//     product); the other for the padded maps, one 32-channel chunk of the
//     CTA's 8 images (37 KB at K=5) a stage, two stages, one chunk ahead;
//   - the tap shift stays an address: q is stored as planes of 16 channels
//     [P][4 images][P][16 bytes] (P = 8 + K - 1), so the 256 pixel rows of
//     tap (dy, dx) are 8-row groups 16 P bytes apart starting at (4 dy P +
//     dx) * 16: a no-swizzle shared-memory descriptor (leading offset one
//     16-channel plane, stride offset one padded row) reads them in place;
//   - the epilogue dequantises in registers with the f32 operations of the
//     plain version, so the output equals it bit for bit, and writes the
//     channels' 8-pixel rows straight to device memory.

#include "int8_wgmma.cuh"

namespace {

constexpr int S = 8;          // map side
constexpr int PIX = S * S;
constexpr int THREADS = 256;  // of the absmax and quantize kernels
constexpr int CK = 32;        // input channels per k32 step
constexpr int IMG = 8;        // images per CTA of the product: two quads
constexpr int BM = 64;        // output channels per CTA
constexpr int SL = 8;         // k32 steps per weight slice
constexpr int SLICE_BYTES = BM * CK * SL;  // 16 KB
constexpr int MAX_WSTAGES = 12;  // weight ring: as many stages as shared memory leaves
constexpr int MSTAGES = 2;    // map ring: the chunk multiplied and the next
constexpr int CONV_THREADS = 32 * (8 + 2);  // two consumer warpgroups, two producer warps

// Bytes of one 32-channel chunk of one quad of images in q: two planes of 16
// channels, [P][4][P][16].
__host__ __device__ constexpr int quad_bytes(int k) { return 2 * (S + k - 1) * 4 * (S + k - 1) * 16; }

struct Layout {
  int wstages, bars, ring, maps, total;
};
__host__ __device__ constexpr Layout layout(int k) {
  Layout l{};
  const int maps = MSTAGES * 2 * quad_bytes(k);
  l.wstages = (agl::SMEM_LIMIT - 1024 - maps) / SLICE_BYTES;
  if (l.wstages > MAX_WSTAGES) l.wstages = MAX_WSTAGES;
  l.bars = 0;     // full[wstages], empty[wstages], mfull[MSTAGES], mempty[MSTAGES]
  l.ring = 1024;  // [wstages][SL / 4][BM][128] s8, the 128-byte swizzle
  l.maps = l.ring + l.wstages * SLICE_BYTES;  // [MSTAGES][2 quads][quad_bytes]
  l.total = l.maps + maps;
  return l;
}
// the weight ring keeps a slice in flight while another is multiplied and a
// third lands, at every k the kernel takes (the maps grow with k)
static_assert(layout(1).wstages >= 3 && layout(3).wstages >= 3 && layout(5).wstages >= 3 &&
                  layout(7).wstages >= 3,
              "the weight ring needs 3 stages");

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

// x (B, Cin, 8, 8) T -> q [Bp / 4][Cp / 32][2][P][4][P][16] s8: image b is
// quad b / 4, slot b % 4; zero ring, zero channels past Cin and zero images
// past B included. Grid (Cp / 32, Bp): one image and 32 channels a block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, const unsigned* __restrict__ amax,
                int8_t* __restrict__ q, int B, int Cin, int nchunks, int k, int gb) {
  __shared__ int qs[CK][PIX + 1];
  const int c0 = blockIdx.x * CK, b = blockIdx.y, r = k / 2, P = S + k - 1;
  const bool real = b < B;
  const float inv = real ? 127.f / fmaxf(__uint_as_float(amax[b / gb]), 1e-8f) : 0.f;
  for (int i = threadIdx.x; i < CK * PIX; i += THREADS) {
    const int c = i / PIX, p = i % PIX;
    qs[c][p] = real && c0 + c < Cin
                   ? __float2int_rn(agl::to_f(x[((size_t)b * Cin + c0 + c) * PIX + p]) * inv)
                   : 0;
  }
  __syncthreads();
  int8_t* dst = q + ((size_t)(b / 4) * nchunks + blockIdx.x) * quad_bytes(k);
  for (int i = threadIdx.x; i < 2 * P * P; i += THREADS) {
    const int cg = i / (P * P), py = (i / P) % P, px = i % P;
    const int y = py - r, xx = px - r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (y >= 0 && y < S && xx >= 0 && xx < S) {
      const int p = y * S + xx, c = 16 * cg;
      v = make_uint4(agl::pack_s8x4(qs[c][p], qs[c + 1][p], qs[c + 2][p], qs[c + 3][p]),
                     agl::pack_s8x4(qs[c + 4][p], qs[c + 5][p], qs[c + 6][p], qs[c + 7][p]),
                     agl::pack_s8x4(qs[c + 8][p], qs[c + 9][p], qs[c + 10][p], qs[c + 11][p]),
                     agl::pack_s8x4(qs[c + 12][p], qs[c + 13][p], qs[c + 14][p], qs[c + 15][p]));
    }
    *reinterpret_cast<uint4*>(dst + (((cg * P + py) * 4 + b % 4) * P + px) * 16) = v;
  }
}

// q as quantize_kernel writes it; wp: [Mp / 64][steps / 4][64][128] s8, the
// packed weights, k32 step s = (chunk s / KK, tap s % KK); sw (Cout) f32;
// out (B, Cout, 8, 8) T. Grid (Mp / 64, Bp / 8). DRAIN: k < 5, whose chunks
// of k^2 steps are too short for a map stage to be handed back at a slice's
// end before a later chunk of the same slice needs it.
template <typename T, bool DRAIN>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wp,
            const float* __restrict__ sw, const unsigned* __restrict__ amax, T* __restrict__ out,
            int B, int nchunks, int Cout, int k, int gb) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout L = layout(k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = S + k - 1, KK = k * k, QB = quad_bytes(k);
  const int steps = nchunks * KK, nslices = (steps + SL - 1) / SL;
  const int WST = L.wstages;
  auto full = [&](int st) { return agl::smem_u32(smem + L.bars + st * 8); };
  auto empty = [&](int st) { return agl::smem_u32(smem + L.bars + (WST + st) * 8); };
  auto mfull = [&](int st) { return agl::smem_u32(smem + L.bars + (2 * WST + st) * 8); };
  auto mempty = [&](int st) { return agl::smem_u32(smem + L.bars + (2 * WST + MSTAGES + st) * 8); };
  const uint32_t ring = agl::smem_u32(smem + L.ring), maps = agl::smem_u32(smem + L.maps);

  if (tid == 0) {
    for (int st = 0; st < WST; ++st) {
      agl::mbar_init(full(st), 1);  // the producer's arrival, with the bytes
      agl::mbar_init(empty(st), 8);  // one arrival a consumer warp
    }
    for (int st = 0; st < MSTAGES; ++st) {
      agl::mbar_init(mfull(st), 1);
      agl::mbar_init(mempty(st), 8);
    }
    agl::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- weight producer: the slices in order, as far ahead as the ring
    // has room (a weight stream latency-bound at 4 stages of 16 KB)
    if (lane != 0) return;
    const int8_t* wsrc = wp + (size_t)blockIdx.x * nslices * SLICE_BYTES;
    for (int sl = 0, st = 0, ph = 0; sl < nslices; ++sl) {
      agl::mbar_wait(empty(st), ph ^ 1);  // passes at once the first time round
      agl::mbar_arrive_expect_tx(full(st), SLICE_BYTES);
      agl::bulk_copy_g2s(ring + st * SLICE_BYTES, wsrc + (size_t)sl * SLICE_BYTES, SLICE_BYTES,
                         full(st));
      if (++st == WST) st = 0, ph ^= 1;
    }
    return;
  }
  if (warp == 9) {
    // ---- map producer: each chunk's maps of the CTA's two quads as soon as
    // the chunk before the one being multiplied is done
    if (lane != 0) return;
    const int8_t* qsrc = q + (size_t)blockIdx.y * 2 * nchunks * QB;
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % MSTAGES;
      agl::mbar_wait(mempty(st), ((c / MSTAGES) & 1) ^ 1);
      agl::mbar_arrive_expect_tx(mfull(st), 2 * QB);
      for (int h = 0; h < 2; ++h)
        agl::bulk_copy_g2s(maps + (st * 2 + h) * QB, qsrc + ((size_t)h * nchunks + c) * QB, QB,
                           mfull(st));
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies the CTA's 64 channels by the
  // pixels of its quad. A weight slice's 8 k32 steps go off as one group of
  // wgmmas between one fence and one commit (a fence, commit and wait a step
  // cost about as much as the step's products); the group before stays in
  // flight while the next is issued, and then its stages are handed back. A
  // step's place (chunk, tap) advances by counters: no division by k.
  const int wg = warp >> 2;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  const uint32_t lead = 4 * P * P * 16, stride = P * 16, quad = maps + wg * QB;
  int c = 0, tap = 0, dx = 0;  // the next step's chunk, tap and the tap's column
  uint32_t toff = 0;           // the tap's shift, (4 P dy + dx) * 16 bytes
  int freed = 0;               // map chunks handed back
  auto free_maps = [&](int done) {  // every step before `done` is complete
    for (; (freed + 1) * KK <= done; ++freed)
      agl::mbar_arrive_if(mempty(freed % MSTAGES), lane == 0);
  };
  for (int sl = 0, wst = 0, wph = 0, s = 0; sl < nslices; ++sl) {
    agl::mbar_wait_in_asm(full(wst), wph);
    const uint32_t slice = ring + wst * SLICE_BYTES;
    agl::wgmma_fence();
#pragma unroll
    for (int j = 0; j < SL; ++j, ++s) {
      if (s >= steps) break;
      if (tap == 0) {
        if constexpr (DRAIN) {
          if (c >= MSTAGES && freed <= c - MSTAGES) {
            // the chunk's map stage is still read by steps in flight: let
            // them finish and hand their stages back (with k >= 5 a chunk
            // is 25 steps or more, and the stage two chunks back is always
            // free by the start of the slice)
            agl::wgmma_commit();
            agl::wgmma_wait<0>();
            free_maps(s);
            agl::wgmma_fence();
          }
        }
        agl::mbar_wait_in_asm(mfull(c % MSTAGES), (c / MSTAGES) & 1);
      }
      const uint64_t da = agl::desc_sw128(slice + (j >> 2) * (BM * 128) + (j & 3) * 32);
      const uint64_t db = agl::desc_plain(quad + (c % MSTAGES) * 2 * QB + toff, lead, stride);
      agl::wgmma_m64n256k32_s8(acc, da, db, s != 0);
      toff += 16;
      if (++dx == k) dx = 0, toff += (4 * P - k) * 16;
      if (++tap == KK) tap = 0, toff = 0, ++c;
    }
    agl::wgmma_commit();
    agl::wgmma_wait<1>();  // the slice before is done: its weight stage, and the maps it finished
    if (sl > 0) {
      agl::mbar_arrive_if(empty(wst == 0 ? WST - 1 : wst - 1), lane == 0);
      free_maps(sl * SL);
    }
    if (++wst == WST) wst = 0, wph ^= 1;
  }
  agl::wgmma_wait<0>();

  // dequantise: sum (j, e) is channel m0 + 16 (warp % 4) + g + 8 (e / 2) and
  // pixel group j = 4 y + i of the quad, column x = 2 t + e % 2
  const int g = lane >> 2, t = lane & 3;
  const int co0 = blockIdx.x * BM + 16 * (warp & 3) + g, b0 = blockIdx.y * IMG + 4 * wg;
  float scale[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    scale[i] = b0 + i < B ? fmaxf(__uint_as_float(amax[(b0 + i) / gb]), 1e-8f) / 127.f : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int co = co0 + 8 * half;
    if (co >= Cout) continue;
    const float w = sw[co];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int y = jj >> 2, i = jj & 3;
      if (b0 + i >= B) continue;
      const float s = scale[i] * w;
      const float v0 = __int2float_rn(acc[4 * jj + 2 * half]) * s;
      const float v1 = __int2float_rn(acc[4 * jj + 2 * half + 1]) * s;
      T* o = out + ((size_t)(b0 + i) * Cout + co) * PIX + y * S + 2 * t;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(__float2bfloat16_rn(v0),
                                                                    __float2bfloat16_rn(v1));
      } else {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wp, const void* sw, void* amax, void* q, void* out,
                   int B, int Cin, int Cout, int k, int gb, cudaStream_t stream) {
  const int chunks = B / gb, nchunks = (Cin + CK - 1) / CK, groups = (B + IMG - 1) / IMG;
  const size_t per_chunk = (size_t)gb * Cin * PIX;
  const int smem = layout(k).total;
  auto conv = k < 5 ? conv_kernel<T, true> : conv_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(conv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  unsigned* am = static_cast<unsigned*>(amax);
  int8_t* qp = static_cast<int8_t*>(q);
  const int splits = (int)((per_chunk + 16 * THREADS - 1) / (16 * THREADS));
  absmax_kernel<T><<<dim3(splits, chunks), THREADS, 0, stream>>>(static_cast<const T*>(x), am,
                                                                per_chunk);
  quantize_kernel<T><<<dim3(nchunks, groups * IMG), THREADS, 0, stream>>>(
      static_cast<const T*>(x), am, qp, B, Cin, nchunks, k, gb);
  conv<<<dim3((Cout + BM - 1) / BM, groups), CONV_THREADS, smem, stream>>>(
      qp, static_cast<const int8_t*>(wp), static_cast<const float*>(sw), am,
      static_cast<T*>(out), B, nchunks, Cout, k, gb);
  return cudaGetLastError();
}

}  // namespace

// x (B, Cin, 8, 8); wp the packed weights of ops/conv8_int8.pack_conv_small_int8_weights,
// (ceil(Cout / 64), ceil(ceil(Cin / 32) k^2 / 8), 2, 64, 128) s8; sw (Cout) f32;
// amax (B / gb) zeroed scratch; q (ceil(B / 8) * 8 * (8 + k - 1)^2 * ceil(Cin / 32) * 32)
// s8 scratch; out (B, Cout, 8, 8). B % gb == 0, Cout % 8 == 0, k odd and <= 7.
// Returns the launches' cudaError_t.
extern "C" int conv_small_int8(const void* x, const void* wp, const void* sw, void* amax, void* q,
                               void* out, int B, int Cin, int Cout, int k, int gb, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, wp, sw, amax, q, out, B, Cin, Cout, k, gb, s);
  return (int)launch<float>(x, wp, sw, amax, q, out, B, Cin, Cout, k, gb, s);
}
