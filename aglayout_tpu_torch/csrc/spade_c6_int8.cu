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
// and an SM does not, so three kernels run on the stream:
//   1. max_kernel: y and its per-image max (atomicMax on the float's bits;
//      y >= 0), one CTA per (image, f-row block, 16 channels); y is not
//      stored;
//   2. quantize_kernel: y again, quantised, written once as q, channels-last
//      in planes of 16 channels with a zero ring of 2 pixels: [B][C / 16][HP]
//      [WP][16 bytes] (HP, WP: H and W rounded up to the product's tile, plus
//      4);
//   3. conv_kernel: the implicit GEMM z^T = W (C x 25 C) . Q^T (25 C x
//      pixels) on the int8 tensor cores (wgmma m64n256k32, s32 sums).
//
// What bounds it on the H100: operations. At (128, 128, 128, 128) it is
// 1.72 T int8 operations (0.87 ms at 1,979 TOP/s) against 1.2 GB of x,
// tables and output (0.35 ms). The product is K6's (conv_small_int8.cu) on
// larger maps:
//   - the output channels are M and the pixels N: a work item is 64 output
//     channels x a tile of 32 rows x 16 columns of one image, two consumer
//     warpgroups of one 8-column strip each (N = 256: 32 rows of 8 pixels).
//     Both read the same weight slice, so the weights stream from L2 once per
//     512 pixels (1.7 GB a call at the shape above; 3.4 GB for 128 channels x
//     256 pixels, the earlier kernel's tile, re-read by each of its 8,192 CTAs);
//   - the CTAs are persistent, one an SM, and walk the items, the two 64-
//     channel halves of a tile one after the other, so that the second finds
//     the tile's maps in L2; the rings run on across items, and the next
//     item's weights and maps land while the consumers write an item out;
//   - one producer warp asks the copy engine for the weights, packed on the
//     host as K6's (ops/conv8_int8.pack_conv_small_int8_weights: k32 steps
//     (input-channel chunk, tap), 8 KB k-blocks of 4 steps, the 128-byte
//     swizzle) through a ring of 11 stages (19 in f32); the other for the maps, one
//     32-channel chunk of the tile's 36 x 20 halo (23 KB, 72 copies of one
//     padded row each, from all its lanes) a stage, three stages;
//   - the tap shift stays an address: a chunk lies in shared memory as two
//     planes of 16 channels [36][20][16 bytes], so the 32 pixel rows of a
//     strip at tap (dy, dx) are 8-pixel groups 320 bytes apart starting at
//     (20 dy + dx + 8 strip) * 16: a no-swizzle descriptor (leading offset one
//     plane, stride offset one padded row) reads them in place;
//   - the epilogue dequantises in registers with the f32 operations of the
//     plain version, so the output equals it bit for bit, and in bf16 writes
//     the tile through shared memory, 16 bytes a thread, whole 32-byte
//     sectors a warp (from registers, 4-byte pieces of 8 channels a warp's
//     store: they cost 0.27 ms of the product's 1.22 at the shape above on
//     an H100 SXM at 700 W, by stage cuts).
// The quantise pass is separate, not done on the halo tile by the product's
// CTAs (the earlier kernel did, 1.69 times the pixels, each CTA's threads
// turning NCHW into channels-last before any product could start): q is 285
// MB at the shape above, written once and read from L2.
// The multiply and add of the apply are kept separate (no fused
// multiply-add) so that y, and with it every quantised value, equals the
// plain PyTorch version bit for bit.

#include "int8_wgmma.cuh"

namespace {

constexpr int KS = 5, R = KS / 2, TAPS = KS * KS;
constexpr int TH = 32, TW = 16;                    // the output pixels of a work item
constexpr int HTH = TH + 2 * R, HTW = TW + 2 * R;  // its halo tile
constexpr int BM = 64;                             // output channels of a work item
constexpr int CK = 32;                             // input channels of a k32 step
constexpr int SL = 4;                              // k32 steps a weight slice: a k-block
constexpr int SLICE_BYTES = BM * CK * SL;          // 8 KB
constexpr int PLANE_BYTES = HTH * HTW * 16;        // 16 channels of the halo tile
constexpr int CHUNK_BYTES = 2 * PLANE_BYTES;       // a map stage: 32 channels
constexpr int MSTAGES = 3;
constexpr int OSTR = TH * TW * 2 + 16;  // bytes a channel of the bf16 output tile in shared memory
// The product's shared memory: the barriers, the weight ring, the map ring
// and, in bf16, the output tile on its way out; the weight ring takes what
// is left (11 stages in bf16, 19 in f32).
template <typename T>
struct ConvLayout {
  static constexpr int OUT = sizeof(T) == 2 ? BM * OSTR : 0;
  static constexpr int WSTAGES = (agl::SMEM_LIMIT - 1024 - MSTAGES * CHUNK_BYTES - OUT) / SLICE_BYTES;
  static constexpr int MAPS = 1024 + WSTAGES * SLICE_BYTES;
  static constexpr int SMEM = MAPS + MSTAGES * CHUNK_BYTES + OUT;
  static_assert(WSTAGES >= 8, "the weight ring keeps two slices of lead beyond a chunk's waits");
};
constexpr int CONV_THREADS = 32 * (8 + 2);  // two consumer warpgroups, two producer warps
constexpr int PASS_THREADS = 256;  // of the max and the quantise pass

__device__ __forceinline__ float apply(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.f);
}

// The two passes over x work on blocks of 16 channels (plane p) x f rows
// (block row hb) of one image, a thread on 8 pixels of one row at a time,
// each channel's 8 values two vector loads. Their shared memory: the block's
// SPADE tables as (A, B) pairs, [5][16][W5] float2, staged 8 values a load
// (a class's 16 W5 values are contiguous in the compact tables).
template <typename T>
__device__ __forceinline__ void stage_tables(const T* at, const T* bt, float2* tab, int b, int hb,
                                             int p, int C, int HB, int W5) {
  const int n8 = 2 * W5;  // 8-value pieces of a class's 16 W5 values
  for (int rc = 0; rc < 5; ++rc) {
    const size_t src = ((((size_t)b * HB + hb) * 5 + rc) * C + p * 16) * W5;
    for (int k = threadIdx.x; k < n8; k += PASS_THREADS) {
      float va[8], vb[8];
      agl::load4(at + src + 8 * k, va);
      agl::load4(at + src + 8 * k + 4, va + 4);
      agl::load4(bt + src + 8 * k, vb);
      agl::load4(bt + src + 8 * k + 4, vb + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) tab[rc * 16 * W5 + 8 * k + e] = make_float2(va[e], vb[e]);
    }
  }
}

// y = T(relu(x * A + B)) of the 8 pixels x0 .. x0 + 7 of row u of the block
// and channel c of its plane, as floats; col: the pixels' table columns
// (class rc of the row) from `table_cols`.
template <typename T>
__device__ __forceinline__ void apply8(const T* x, const float2* tab, const int (&col)[8], int c,
                                       int W5, float (&y)[8]) {
  float v[8];
  agl::load4(x, v);
  agl::load4(x + 4, v + 4);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float2 ab = tab[col[e] + c * W5];
    y[e] = agl::to_f(agl::from_f<T>(apply(v[e], ab.x, ab.y)));
  }
}
__device__ __forceinline__ void table_cols(int rc, int x0, int f, int W5, int (&col)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) col[e] = rc * 16 * W5 + agl::compact_col(x0 + e, f);
}

// ymax[b] = max y over image b, as float bits. Grid (C / 16, H / f, B).
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
max_kernel(const T* __restrict__ x, const T* __restrict__ at, const T* __restrict__ bt,
           unsigned* __restrict__ ymax, int C, int H, int W, int f) {
  extern __shared__ __align__(16) float2 tab[];
  const int W5 = (W / f) * 5, p = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  stage_tables(at, bt, tab, b, hb, p, C, H / f, W5);
  __syncthreads();
  const int xo = W / 8;
  float m = 0.f;
  for (int i = threadIdx.x; i < f * xo; i += PASS_THREADS) {
    const int u = i / xo, x0 = (i % xo) * 8;
    int col[8];
    table_cols(agl::row_class(u, f), x0, f, W5, col);
    const T* xr = x + (((size_t)b * C + p * 16) * H + hb * f + u) * W + x0;
#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      float y[8];
      apply8(xr + (size_t)c * H * W, tab, col, c, W5, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, y[e]);
    }
  }
  m = agl::warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(ymax + b, __float_as_uint(m));
}

// x (B, C, H, W) T -> q [B][C / 16][HP][WP][16] s8: y quantised with its
// image's scale at (y + 2, x + 2), zero elsewhere. Grid (C / 16, H / f, B).
// A warp's 32 threads take 32 consecutive items (8 pixels each), and their
// 256 pixels' 16-byte words leave through shared memory, so that each store
// of the warp writes 512 contiguous bytes where the items lie in one row
// (from registers, 32 pieces 128 bytes apart).
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
quantize_kernel(const T* __restrict__ x, const T* __restrict__ at, const T* __restrict__ bt,
                const unsigned* __restrict__ ymax, int8_t* __restrict__ q, int C, int H, int W,
                int f, int HP, int WP) {
  extern __shared__ __align__(16) float2 tab[];
  const int W5 = (W / f) * 5, HB = H / f, p = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  // [warp][32 threads][8 pixels] words, pixel e of thread l at e ^ (l % 8)
  uint4* out_words = reinterpret_cast<uint4*>(tab + 5 * 16 * W5) + (threadIdx.x - lane) * 8;
  stage_tables(at, bt, tab, b, hb, p, C, HB, W5);
  __syncthreads();
  const float inv = 127.f / fmaxf(__uint_as_float(ymax[b]), 1e-8f);
  int8_t* qp = q + ((size_t)b * (C / 16) + p) * HP * WP * 16;
  const int xo = W / 8, total = f * xo;
  for (int i0 = threadIdx.x - lane; i0 < total; i0 += PASS_THREADS) {
    const int i = i0 + lane, u = i / xo, x0 = (i % xo) * 8;
    int dst = -1;  // byte offset in the plane of this thread's first pixel; -1: no item
    uint32_t w[8][4];
    if (i < total) {
      dst = ((hb * f + u + R) * WP + x0 + R) * 16;
      int col[8];
      table_cols(agl::row_class(u, f), x0, f, W5, col);
      const T* xr = x + (((size_t)b * C + p * 16) * H + hb * f + u) * W + x0;
#pragma unroll
      for (int cg = 0; cg < 4; ++cg) {  // four channels, one byte each of a word
        int qv[4][8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float yv[8];
          apply8(xr + (size_t)(4 * cg + c) * H * W, tab, col, 4 * cg + c, W5, yv);
#pragma unroll
          for (int e = 0; e < 8; ++e) qv[c][e] = __float2int_rn(yv[e] * inv);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e][cg] = __byte_perm(__byte_perm(qv[0][e], qv[1][e], 0x0040),
                                 __byte_perm(qv[2][e], qv[3][e], 0x0040), 0x5410);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out_words[lane * 8 + (e ^ (lane & 7))] = make_uint4(w[e][0], w[e][1], w[e][2], w[e][3]);
    }
    __syncwarp();
    // the warp's pixel 32 k + lane: pixel e of thread o's item
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = 4 * k + (lane >> 3), e = lane & 7;
      const int base = __shfl_sync(0xffffffffu, dst, o);
      if (base >= 0)
        *reinterpret_cast<uint4*>(qp + base + e * 16) = out_words[o * 8 + (e ^ (o & 7))];
    }
    __syncwarp();
  }
  // the zero ring: the block's rows' columns left and right of the image, the
  // first block's rows above it and the last's below
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int side = WP - W;  // R columns left, the rest right
  for (int i = threadIdx.x; i < f * side; i += PASS_THREADS) {
    const int u = i / side, cx = i % side;
    const int px = cx < R ? cx : W + cx;
    reinterpret_cast<uint4*>(qp)[(size_t)(hb * f + u + R) * WP + px] = zero;
  }
  if (hb == 0)
    for (int i = threadIdx.x; i < R * WP; i += PASS_THREADS) reinterpret_cast<uint4*>(qp)[i] = zero;
  if (hb == HB - 1)
    for (int i = threadIdx.x; i < (HP - H - R) * WP; i += PASS_THREADS)
      reinterpret_cast<uint4*>(qp)[(size_t)(H + R) * WP + i] = zero;
}

// q as quantize_kernel writes it; wp: [ceil(C / 64)][ceil(steps / 8)][2][64]
// [128] s8, the packed weights, k32 step s = (chunk s / 25, tap s % 25), a
// k-block [64][128] of 4 steps a slice of the ring; sw (C) f32;
// ymax (B) the max pass's; out (B, C, H, W) T. Grid: one CTA an SM, each
// walking the work items blockIdx.x, blockIdx.x + gridDim.x, ...; item i is
// output-channel tile i % MT of pixel tile i / MT, the pixel tiles in the
// order (image, tile row, tile column).
template <typename T>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wp,
            const float* __restrict__ sw, const unsigned* __restrict__ ymax, T* __restrict__ out,
            int B, int C, int H, int W, int HP, int WP) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int WSTAGES = ConvLayout<T>::WSTAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = C / CK, steps = nch * TAPS, nslices = (steps + SL - 1) / SL;
  const int MT = (C + BM - 1) / BM, NTX = (W + TW - 1) / TW, NTY = (H + TH - 1) / TH;
  const int items = MT * NTX * NTY * B;
  auto full = [&](int st) { return agl::smem_u32(smem + st * 8); };
  auto empty = [&](int st) { return agl::smem_u32(smem + (WSTAGES + st) * 8); };
  auto mfull = [&](int st) { return agl::smem_u32(smem + (2 * WSTAGES + st) * 8); };
  auto mempty = [&](int st) { return agl::smem_u32(smem + (2 * WSTAGES + MSTAGES + st) * 8); };
  const uint32_t ring = agl::smem_u32(smem + 1024);
  const uint32_t maps = agl::smem_u32(smem + ConvLayout<T>::MAPS);
  // item -> (output-channel tile, image, tile row, tile column)
  auto decode = [&](int item, int& mt, int& b, int& ty, int& tx) {
    mt = item % MT;
    const int p = item / MT;
    tx = p % NTX;
    ty = (p / NTX) % NTY;
    b = p / (NTX * NTY);
  };

  if (tid == 0) {
    for (int st = 0; st < WSTAGES; ++st) {
      agl::mbar_init(full(st), 1);   // the producer's arrival, with the bytes
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
    // ---- weight producer: every item's slices in order, as far ahead as
    // the ring has room, across items
    if (lane != 0) return;
    const int kblocks = (steps + 2 * SL - 1) / (2 * SL) * 2;  // of an output-channel tile, packed
    for (int item = blockIdx.x, st = 0, ph = 0; item < items; item += gridDim.x) {
      const int8_t* wsrc = wp + (size_t)(item % MT) * kblocks * SLICE_BYTES;
      for (int sl = 0; sl < nslices; ++sl) {
        agl::mbar_wait(empty(st), ph ^ 1);  // passes at once the first time round
        agl::mbar_arrive_expect_tx(full(st), SLICE_BYTES);
        agl::bulk_copy_g2s(ring + st * SLICE_BYTES, wsrc + (size_t)sl * SLICE_BYTES, SLICE_BYTES,
                           full(st));
        if (++st == WSTAGES) st = 0, ph ^= 1;
      }
    }
    return;
  }
  if (warp == 9) {
    // ---- map producer: each chunk's halo tile, 72 padded rows of 320
    // bytes (two planes x 36 rows), the copies asked for by all the lanes
    for (int item = blockIdx.x, st = 0, ph = 0; item < items; item += gridDim.x) {
      int mt, b, ty, tx;
      decode(item, mt, b, ty, tx);
      const int8_t* src = q + (((size_t)b * (C / 16) * HP + ty * TH) * WP + tx * TW) * 16;
      for (int c = 0; c < nch; ++c) {
        agl::mbar_wait(mempty(st), ph ^ 1);
        if (lane == 0) agl::mbar_arrive_expect_tx(mfull(st), CHUNK_BYTES);
        __syncwarp();
        for (int i = lane; i < 2 * HTH; i += 32) {
          const int h = i / HTH, py = i % HTH;
          agl::bulk_copy_g2s(maps + st * CHUNK_BYTES + h * PLANE_BYTES + py * HTW * 16,
                             src + ((size_t)(2 * c + h) * HP + py) * WP * 16, HTW * 16, mfull(st));
        }
        if (++st == MSTAGES) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies the item's 64 channels by the
  // 256 pixels of strip wg (columns 8 wg .. 8 wg + 7 of the tile). A weight
  // slice's 4 k32 steps go off as one group of wgmmas between one fence and
  // one commit, with no branch among them: the maps the slice reads are
  // waited for before it, a step's place (chunk, tap) advances by counters,
  // and a last slice that runs past the item's steps multiplies zero weights
  // (the packing pads them) by whatever map stage comes next. The group
  // before stays in flight while the next is issued, and then its stages are
  // handed back.
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const uint32_t strip = wg * 8 * 16;
  int acc[128];
  int wst = 0, wph = 0;  // the weight stage of the next slice, and its phase
  int mst = 0;           // the map stage of the chunk multiplied
  int rst = 0, rph = 0;  // the map stage waited for next, and its phase
  int fst = 0;           // the map stage handed back next
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int tap = 0, dx = 0, ready = 0, freed = 0;  // the step's tap and its column; the item's chunks landed, handed back
    uint32_t toff = 0;                          // the tap's shift, (20 dy + dx) * 16 bytes
    uint32_t mbase = maps + mst * CHUNK_BYTES + strip;
    auto free_maps = [&](int done) {  // every step of the item before `done` is complete
      for (; freed < nch && (freed + 1) * TAPS <= done; ++freed) {
        agl::mbar_arrive_if(mempty(fst), lane == 0);
        if (++fst == MSTAGES) fst = 0;
      }
    };
    for (int sl = 0; sl < nslices; ++sl) {
      for (; ready < nch && ready * TAPS < (sl + 1) * SL; ++ready) {  // the slice's chunks have landed
        agl::mbar_wait_in_asm(mfull(rst), rph);
        if (++rst == MSTAGES) rst = 0, rph ^= 1;
      }
      agl::mbar_wait_in_asm(full(wst), wph);
      const uint32_t slice = ring + wst * SLICE_BYTES;
      agl::wgmma_fence();
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        const uint64_t da = agl::desc_sw128(slice + j * 32);
        const uint64_t db = agl::desc_plain(mbase + toff, PLANE_BYTES, HTW * 16);
        agl::wgmma_m64n256k32_s8(acc, da, db, sl | j);
        toff += 16;
        if (++dx == KS) dx = 0, toff += (HTW - KS) * 16;
        if (++tap == TAPS) {
          tap = 0, toff = 0;
          if (++mst == MSTAGES) mst = 0;
          mbase = maps + mst * CHUNK_BYTES + strip;
        }
      }
      agl::wgmma_commit();
      agl::wgmma_wait<1>();  // the slice before is done: its weight stage, and the maps it finished
      if (sl > 0) {
        agl::mbar_arrive_if(empty(wst == 0 ? WSTAGES - 1 : wst - 1), lane == 0);
        free_maps(sl * SL);
      }
      if (++wst == WSTAGES) wst = 0, wph ^= 1;
    }
    agl::wgmma_wait<0>();
    agl::mbar_arrive_if(empty(wst == 0 ? WSTAGES - 1 : wst - 1), lane == 0);  // the last slice's
    free_maps(steps);

    // dequantise: sum (j, e) is channel 64 mt + 16 (warp % 4) + g + 8 (e / 2)
    // at tile row j, strip column 2 t + e % 2. In bf16 the tile goes through
    // shared memory, [64 channels][32 rows][16 columns] (each channel OSTR
    // bytes: the 4-byte stores of a warp meet no conflict), so that each
    // 16-byte store of a thread fills half a 32-byte sector of the output
    // whose other half the neighbouring thread fills, 16 sectors a store of
    // the warp; f32 stores its pairs straight from registers.
    int mt, b, ty, tx;
    decode(item, mt, b, ty, tx);
    const float scale = fmaxf(__uint_as_float(ymax[b]), 1e-8f) / 127.f;
    const int y0 = ty * TH, x0 = tx * TW;
    if constexpr (sizeof(T) == 2) {
      unsigned char* tile = smem + ConvLayout<T>::MAPS + MSTAGES * CHUNK_BYTES;
      agl::named_barrier(1, 256);  // the previous item's tile is out
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cl = 16 * (warp & 3) + g + 8 * half, co = mt * BM + cl;
        const float s = co < C ? scale * sw[co] : 0.f;
#pragma unroll
        for (int jj = 0; jj < TH; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(tile + cl * OSTR + jj * TW * 2 + (8 * wg + 2 * t) * 2) =
              __halves2bfloat162(__float2bfloat16_rn(__int2float_rn(acc[4 * jj + 2 * half]) * s),
                                 __float2bfloat16_rn(__int2float_rn(acc[4 * jj + 2 * half + 1]) * s));
      }
      agl::named_barrier(1, 256);  // the tile is whole
#pragma unroll 4
      for (int k = 0; k < BM * TH * 2 / 256; ++k) {  // 16-byte pieces (channel, row, half)
        const int piece = k * 256 + tid, cl = piece >> 6, row = (piece >> 1) & 31, h = piece & 1;
        const int co = mt * BM + cl;
        if (co < C && y0 + row < H && x0 + 8 * h < W)
          *reinterpret_cast<uint4*>(out + (((size_t)b * C + co) * H + y0 + row) * W + x0 + 8 * h) =
              *reinterpret_cast<const uint4*>(tile + cl * OSTR + row * TW * 2 + h * 16);
      }
    } else {
      const int x = x0 + 8 * wg + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int co = mt * BM + 16 * (warp & 3) + g + 8 * half;
        if (co >= C || x >= W) continue;
        const float s = scale * sw[co];
        T* o = out + (((size_t)b * C + co) * H + y0) * W + x;
#pragma unroll
        for (int jj = 0; jj < TH; ++jj)
          if (y0 + jj < H)
            *reinterpret_cast<float2*>(o + (size_t)jj * W) =
                make_float2(__int2float_rn(acc[4 * jj + 2 * half]) * s,
                            __int2float_rn(acc[4 * jj + 2 * half + 1]) * s);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* at, const void* bt, const void* wp, const void* sw,
                   void* ymax, void* q, void* out, int B, int C, int H, int W, int f,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int W5 = (W / f) * 5;
  const int HP = (H + TH - 1) / TH * TH + 2 * R, WP = (W + TW - 1) / TW * TW + 2 * R;
  const int smem_max = 5 * 16 * W5 * (int)sizeof(float2);  // the tables
  const int smem_q = smem_max + PASS_THREADS * 8 * 16;        // and the words on their way out
  err = cudaFuncSetAttribute(max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(quantize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ConvLayout<T>::SMEM);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* ap = static_cast<const T*>(at);
  const T* bp = static_cast<const T*>(bt);
  unsigned* ym = static_cast<unsigned*>(ymax);
  int8_t* qp = static_cast<int8_t*>(q);
  const dim3 passes(C / 16, H / f, B);
  max_kernel<T><<<passes, PASS_THREADS, smem_max, stream>>>(xp, ap, bp, ym, C, H, W, f);
  quantize_kernel<T><<<passes, PASS_THREADS, smem_q, stream>>>(xp, ap, bp, ym, qp, C, H, W, f, HP, WP);
  const int items = (C + BM - 1) / BM * ((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
  conv_kernel<T><<<items < sms ? items : sms, CONV_THREADS, ConvLayout<T>::SMEM, stream>>>(
      qp, static_cast<const int8_t*>(wp), static_cast<const float*>(sw), ym, static_cast<T*>(out),
      B, C, H, W, HP, WP);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, C, H, W); at, bt compact (B, H/f, 5, C, 5 W/f); wp the packed
// weights of ops/conv8_int8.pack_conv_small_int8_weights(w6q) (w6q (C, 5, 5,
// C) s8); sw (C) f32; ymax (B) zeroed scratch; q (B, C / 16, HP, WP, 16) s8
// scratch, HP = ceil(H / 32) 32 + 4, WP = ceil(W / 16) 16 + 4. C % 32 == 0,
// W % 8 == 0, H % f == 0, W % f == 0, f >= 5. Returns the launches'
// cudaError_t.
extern "C" int spade_c6_int8(const void* x, const void* at, const void* bt, const void* wp,
                             const void* sw, void* ymax, void* q, void* out, int B, int C, int H,
                             int W, int f, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, at, bt, wp, sw, ymax, q, out, B, C, H, W, f, s);
  return (int)launch<float>(x, at, bt, wp, sw, ymax, q, out, B, C, H, W, f, s);
}
