// The RGB heads' bf16 kernel on the tensor cores: SPADE apply + relu + a KxK
// conv to O <= 4 channels, from compact class tables (K3, the 128^2 c7 head,
// spade_few_out_conv8.cu) or from flat ones (K2, the c4 head and the c7 head
// with K3 switched off, spade_few_out_conv.cu), on x laid out (B, C, H, W)
// or, with flat tables, (H, W, B, C) (K2's transposed mode, K2t). Each of
// the two sources instantiates it for the modes it takes, with a launch
// count of its own.
//
// out = conv(relu(x * A + B)) + bias. The affine of pixel (g, j), channel c
// is tab[b, g / f, class(g % f), c, col(j)] with col(j) = (j / f) * 5 +
// class(j % f) on compact tables (B, H/f, 5, C, 5 * W/f) and col(j) = j on
// flat ones (B, H/f, 5, C, W).
//
// The design, for the FMA kernels it replaced (whose multiply-adds, fed from
// shared memory by 2-byte loads, took milliseconds at these shapes): an
// implicit GEMM whose taps cost no data movement.
//   - the column taps are the N dimension. For a tile of 8 output rows of
//     one image, acc[(y, x'), (dx, o)] = sum_{dy, c} Y[y + dy - K/2, x', c]
//     * w[o, c, dy, dx]: M = 8 W pixels, N = K O padded to a multiple of 8
//     (24 at K=7, O=3), reduction K C. The row tap dy is a shift of the A
//     operand's row address: the y tile lies pixel-major in shared memory,
//     16 channels (one mma.sync m16n8k16 step) innermost, 32 bytes a pixel
//     with the 16-byte halves of every second group of 4 pixels swapped so
//     that ldmatrix meets no bank conflict, and one A fragment feeds every
//     column tile. Each warp owns one output row: W/16 x N/8 accumulator
//     tiles in registers across all channel chunks;
//   - out[y, x, o] = bias[o] + sum_dx acc[(y, x + dx - K/2), (dx, o)]: a
//     K-term shifted sum through an f32 tile in shared memory that overlays
//     the operands after the last chunk; columns outside the image are
//     never computed;
//   - the channels go in chunks of 16. A chunk's x rows, the table rows its
//     tile needs (one copy per distinct row block and class, not per image
//     row; a flat table row is W wide, a compact one 5 W/f) and its weight
//     slice come by the copy engine (descriptor-free cp.async.bulk, asked
//     for by a ninth warp and counted by an mbarrier) into one of two
//     staging buffers while the previous chunk is applied and multiplied.
//     Where two x buffers do not fit beside the flat tables of a 128-wide
//     map, one does (XB = 1): the producer then asks for the next chunk's x
//     rows once the apply pass has read them, under the product only.
//     Copies that the eight working warps start themselves (cp.async) cost
//     them as long as the copies take;
//   - the apply pass reads x in NCHW order from the staging buffer, 8
//     channels x 8 pixels a warp step, applies y = relu(x * A + B) in f32
//     with the table values kept in registers while the table row stays the
//     same, rounds once, transposes the 8 x 8 block inside the warp
//     (movmatrix) and stores it channel-innermost, every access free of bank
//     conflicts. It is the longest stage: the compiler keeps a load behind
//     every earlier store to shared memory, so the loads of the next row are
//     written ahead of this row's stores, and the A fragments of the product
//     two tiles ahead of the mma that reads them.
// x laid out (H, W, B, C) (XT, K2t): a chunk's x rows are W runs of 32 bytes
// a row at a stride of B C 2 bytes, 1,792 pieces for a c7 tile, too many and
// too small for bulk copies. One TMA tensor copy takes them instead: a
// tensor map (encoded on the host, `encode_x_map`) describes x as the 4-D
// tensor (C, B, W, H), and a box of (16, 1, W, th) lands pixel-major with
// 16 channels innermost, the 32-byte swizzle of the copy engine swapping the
// 16-byte halves of pixels 4..7 of every 8: the y tile's own layout. So the
// y tile is the staging buffer: the apply pass reads each pixel's 8
// channels as one 16-byte word and writes y back in place (a warp's lanes
// walk 32 pixels, so a table's channel row is read 64 contiguous bytes a
// warp: no bank conflict and no transpose), and without the separate tile
// two x buffers fit beside 128-wide flat tables. Rows outside the image come
// from the copy as zeros, which is y's zero padding: they are not applied.
// The product and everything after are the other modes', so K2t gives the
// bits of K2 on flat tables run on x permuted to (B, C, H, W).
// Numerics as the FMA kernels: y in f32, rounded to bf16; zero padding on y;
// weights rounded to bf16; f32 accumulation; output rounded once.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {
namespace tc {

constexpr int R = 8;    // output rows a tile, one a warp
constexpr int CC = 16;  // channels a chunk: one k-step of mma.sync m16n8k16; 32 bytes a pixel
constexpr int THREADS = 32 * (R + 1);  // R consumer warps and one that asks for the copies

// Table slot of tile row ty of the tile at r0: rows of one (row block, row
// class) share a slot; -1 outside the image. Slots count up along the tile.
__host__ __device__ inline int table_slot(int r0, int ty, int r, int H, int f) {
  int s = -1, prev = -1, mine = -1;
  for (int t = 0; t <= ty; ++t) {
    const int g = r0 + t - r;
    mine = -1;
    if (g < 0 || g >= H) continue;
    const int u = g % f;
    const int key = (g / f) * 5 + (u == 0 ? 0 : u == 1 ? 1 : u == f - 2 ? 3 : u == f - 1 ? 4 : 2);
    if (key != prev) { ++s; prev = key; }
    mine = s;
  }
  return mine;
}

// Byte offsets into the dynamic shared memory, and the sizes they follow
// from; computed on the host and handed to the kernel.
struct Layout {
  int th, w5, np;   // tile rows with the halo; table columns; GEMM columns
  int xcs;          // elements between two channels of the staged x rows
  int slots;        // table slots a tile needs at most
  int xb;           // staging buffers of x: 2, or 1 where two do not fit
  int xbuf, tbuf;   // bytes of one staging buffer of x, and of one table
  int slot, first, bar, ws, xs, tabs, ys, total;
};
// xt: x laid out (H, W, B, C), its staging buffers the y tile's layout
// ([th][W][CC], 1024-byte aligned for the copy engine's swizzle) and no y
// tile beside them; always two (one would hold the next chunk's copy behind
// this chunk's product): where they do not fit, the total is over the limit.
inline Layout layout(int H, int W, int K, int O, int f, bool compact, bool xt) {
  Layout l;
  l.th = R + K - 1;
  l.w5 = compact ? W / f * 5 : W;
  l.np = (K * O + 7) / 8 * 8;
  // channel stride = 4 mod 32 words: the apply pass reads 8 channels x 4 words at once
  const int words = l.th * W / 2;
  l.xcs = 2 * (words + (36 - words % 32) % 32);
  l.slots = 1;
  for (int r0 = 0; r0 < H; r0 += R)
    for (int ty = 0; ty < l.th; ++ty) {
      const int s = table_slot(r0, ty, K / 2, H, f) + 1;
      l.slots = s > l.slots ? s : l.slots;
    }
  l.xbuf = xt ? l.th * W * CC * 2 : CC * l.xcs * 2;
  l.tbuf = l.slots * CC * l.w5 * 2;
  l.slot = 0;                                // [th] int: table slot of a tile row
  l.first = 64;                              // [th] int: first tile row of a slot; [15]: slots
  l.bar = 128;                               // [2] mbarrier, one a staging buffer
  l.ws = 144;                                // [2][K][np][CC] bf16, k in fragment order
  l.xs = l.ws + 2 * K * l.np * CC * 2;       // [xb][CC][xcs] bf16, rows [th][W]
  const int sums = R * W * (l.np + 1) * 4;   // [R * W][np + 1] f32 (odd: no conflicts), overlays from xs on
  if (xt) {
    l.xs = (l.xs + 1023) / 1024 * 1024;      // [2][th][W][CC] bf16, the y tiles
    l.xb = 2;
    l.tabs = l.xs + 2 * l.xbuf;
    l.ys = l.tabs + 4 * l.tbuf;              // no y tile of its own
    l.total = l.xs + (l.ys - l.xs > sums ? l.ys - l.xs : sums);
    return l;
  }
  for (l.xb = 2;; --l.xb) {
    l.tabs = l.xs + l.xb * l.xbuf;           // [2][A, B][slots][CC][w5] bf16
    l.ys = l.tabs + 4 * l.tbuf;              // [th][W][CC] bf16, the 16-byte halves swizzled
    const int operands = l.ys + l.th * W * CC * 2 - l.xs;
    l.total = l.xs + (operands > sums ? operands : sums);
    if (l.total <= agl::SMEM_LIMIT || l.xb == 1) break;
  }
  return l;
}

// The tensor map of x (H, W, B, C) bf16 for XT: the 4-D tensor (C, B, W, H),
// a box of (CC, 1, W, th), the 32-byte swizzle, zeros outside. Encoded by
// cuTensorMapEncodeTiled (libcuda's), whose address the CUDA runtime hands
// out, so that the library links against the runtime alone.
inline cudaError_t encode_x_map(CUtensorMap* map, const void* x, int B, int C, int H, int W,
                                int th) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)B, (cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)B * C * 2,
                                 (cuuint64_t)W * B * C * 2};  // bytes, of dims 1..3
  const cuuint32_t box[4] = {CC, 1, (cuuint32_t)W, (cuuint32_t)th}, ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                              strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// x: (B, C, H, W) bf16, or (H, W, B, C) with XT (read through xmap); at, bt:
// (B, H/f, 5, C, W5) bf16, W5 = 5 W/f with COMPACT, else W; wp: (C / 16, K,
// NP, 16) bf16, the packed weights [chunk][dy][(dx, o)][c], zero rows past K *
// O, the 16 channels of a chunk in the order 0 1 8 9 2 3 10 11 4 5 12 13 6 7
// 14 15 (a lane's mma B fragment is then 8 contiguous bytes); bias: (4,) f32;
// out: (B, O, H, W) bf16. W == 16 MT, NP == 8 NT, XB == L.xb. Grid (H / R, B).
template <int NT, int MT, bool COMPACT, bool XT, int XB>
__global__ void __launch_bounds__(THREADS, 1)
head8_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ at,
                 const __nv_bfloat16* __restrict__ bt, const __nv_bfloat16* __restrict__ wp,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int C, int H,
                 int K, int O, int f, const Layout L, const __grid_constant__ CUtensorMap xmap) {
  static_assert(!(XT && (COMPACT || XB != 2)), "XT: flat tables, two staging buffers");
  constexpr int W = 16 * MT, NP = 8 * NT, SS = NP + 1;  // SS: floats a pixel of the sums
  constexpr int PGS = W / 8 / R;  // 8-pixel groups a warp applies: 2 at W = 128, 1 at 64
  extern __shared__ __align__(1024) unsigned char smem[];  // XT: the swizzled copies want it
  int* slot = reinterpret_cast<int*>(smem + L.slot);
  int* first = reinterpret_cast<int*>(smem + L.first);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L.ys);
  float* sums = reinterpret_cast<float*>(smem + L.xs);
  const int TH = L.th, W5 = L.w5, r = K / 2, HB = H / f;
  const int b = blockIdx.y, r0 = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tylo = r0 < r ? r - r0 : 0, tyhi = r0 + TH - r > H ? H + r - r0 : TH;  // rows inside
  auto bar = [&](int ci) { return agl::smem_u32(smem + L.bar + (ci & 1) * 8); };
  auto xbuf = [&](int ci) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.xs + (XB == 2 ? ci & 1 : 0) * L.xbuf);
  };
  auto tbuf = [&](int ci, int which) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L.tabs + ((ci & 1) * 2 + which) * L.tbuf);
  };

  if (tid == 0) {
    agl::mbar_init(bar(0), 1);
    agl::mbar_init(bar(1), 1);
    agl::mbar_fence_init();
    if constexpr (XT) agl::prefetch_tensormap(&xmap);
  }
  if (tid < TH) slot[tid] = table_slot(r0, tid, r, H, f);
  __syncthreads();
  if (tid < TH && slot[tid] >= 0) {
    if (tid == 0 || slot[tid - 1] != slot[tid]) first[slot[tid]] = tid;
    if (tid == tyhi - 1) first[15] = slot[tid] + 1;
  }
  __syncthreads();

  // The producer warp asks the copy engine for a chunk's x rows (one run of
  // rows a channel, or with XT one tensor copy of the whole tile; with x_now
  // false they follow from stage_x), table rows (one run of CC rows a slot
  // and table) and weight slice (one run), into the staging buffers of the
  // chunk's parity; the bytes land on that buffer's mbarrier.
  constexpr int NX = XT ? 1 : CC;  // x copies a chunk
  const uint32_t xbytes = (tyhi - tylo) * W * 2;
  const uint32_t xtx = XT ? TH * W * CC * 2 : CC * xbytes;  // a tensor copy counts its zeros too
  auto copy_x = [&](int ci, int j) {
    if constexpr (XT)
      agl::tma_load_4d(agl::smem_u32(xbuf(ci)), &xmap, ci * CC, b, 0, r0 - r, bar(ci));
    else
      agl::bulk_copy_g2s(agl::smem_u32(xbuf(ci) + j * L.xcs + tylo * W),
                         x + (((size_t)b * C + ci * CC + j) * H + r0 + tylo - r) * W, xbytes,
                         bar(ci));
  };
  auto stage = [&](int ci, bool x_now) {
    const int c0 = ci * CC, nslots = first[15];
    const uint32_t tbytes = CC * W5 * 2, wbytes = K * NP * CC * 2;
    if (lane == 0) {
      agl::fence_proxy_async();  // the buffers were read (XT: and written) two chunks ago
      agl::mbar_arrive_expect_tx(bar(ci), xtx + 2 * nslots * tbytes + wbytes);
    }
    __syncwarp();
    for (int j = (x_now ? 0 : NX) + lane; j < NX + 1 + 2 * nslots; j += 32) {
      if (j < NX) {
        copy_x(ci, j);
      } else if (j == NX) {
        agl::bulk_copy_g2s(agl::smem_u32(ws + (ci & 1) * K * NP * CC),
                           wp + (size_t)ci * K * NP * CC, wbytes, bar(ci));
      } else {
        const int s = (j - NX - 1) >> 1, which = (j - NX - 1) & 1, g = r0 + first[s] - r;
        const size_t src = ((((size_t)b * HB + g / f) * 5 + agl::row_class(g % f, f)) * C + c0) * W5;
        agl::bulk_copy_g2s(agl::smem_u32(tbuf(ci, which) + s * CC * W5), (which ? bt : at) + src,
                           tbytes, bar(ci));
      }
    }
  };
  // XB == 1: chunk ci's x rows into the one buffer, which the apply pass of
  // chunk ci - 1 has read; their bytes were announced by stage(ci, false).
  auto stage_x = [&](int ci) {
    if (lane == 0) agl::fence_proxy_async();
    __syncwarp();
    for (int j = lane; j < CC; j += 32) copy_x(ci, j);
  };

  // y = relu(x * A + B) of the staged chunk into the y tile, transposed to
  // channel-innermost. A warp step is 8 channels x 8 pixels of one tile row:
  // lane l reads channel l / 4, pixels 2 (l % 4) and + 1, and after the
  // transpose stores pixel l / 4, channels 2 (l % 4) and + 1. The y tile has
  // 32 bytes a pixel; pixels 4..7 of every 8 swap their two 16-byte halves, so
  // that neither these stores nor the product's ldmatrix meet a bank conflict.
  // The PGS * 2 steps of a tile row are independent chains, and the table
  // values stay in registers while the rows share a slot.
  auto apply_nchw = [&](int ci) {
    const __nv_bfloat16 *xs = xbuf(ci), *ta = tbuf(ci, 0), *tb = tbuf(ci, 1);
    int col[PGS][2];
#pragma unroll
    for (int p = 0; p < PGS; ++p) {
      const int xa = (warp + p * R) * 8 + 2 * t4;
      col[p][0] = COMPACT ? agl::compact_col(xa, f) : xa;
      col[p][1] = COMPACT ? agl::compact_col(xa + 1, f) : xa + 1;
    }
    // lane's word of x for step (p, cg) of tile row ty
    auto xword = [&](int ty, int p, int cg) {
      return *reinterpret_cast<const uint32_t*>(xs + (cg * 8 + g8) * L.xcs + ty * W +
                                                (warp + p * R) * 8 + 2 * t4);
    };
    float av[PGS][2][2], bv[PGS][2][2];
    uint32_t raw[PGS][2], next[PGS][2];
    int cur = -1;
    // the rows' slots in a register, 4 bits a row (15: outside the image), so
    // that no row starts by waiting for a load
    unsigned long long slots = 0;
    for (int ty = 0; ty < TH; ++ty) slots |= (unsigned long long)(slot[ty] & 15) << (4 * ty);
#pragma unroll
    for (int p = 0; p < PGS; ++p)
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) next[p][cg] = xword(tylo, p, cg);
    // The compiler cannot tell the staging buffers from the y tile, so it
    // keeps every load behind the stores written before it: the next row's
    // loads are written ahead of this row's stores.
#pragma unroll 2
    for (int ty = 0; ty < TH; ++ty) {
      const int s4 = (int)(slots >> (4 * ty)) & 15, s = s4 == 15 ? -1 : s4;
#pragma unroll
      for (int p = 0; p < PGS; ++p)
#pragma unroll
        for (int cg = 0; cg < 2; ++cg) {
          raw[p][cg] = s >= 0 ? next[p][cg] : 0u;
          if (ty + 1 >= tylo && ty + 1 < tyhi) next[p][cg] = xword(ty + 1, p, cg);
        }
      if (s >= 0 && s != cur) {
        cur = s;
#pragma unroll
        for (int p = 0; p < PGS; ++p)
#pragma unroll
          for (int cg = 0; cg < 2; ++cg) {
            const int row = (s * CC + cg * 8 + g8) * W5;
            if constexpr (COMPACT) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                av[p][cg][e] = __bfloat162float(ta[row + col[p][e]]);
                bv[p][cg][e] = __bfloat162float(tb[row + col[p][e]]);
              }
            } else {
              // a flat row is W wide: the 8 channels of a step lie in the same
              // 4 banks (8-way conflicts), so the lane's two columns, one
              // 32-bit word, come in one load
              const float2 a2 = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(ta + row + col[p][0]));
              const float2 b2 = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(tb + row + col[p][0]));
              av[p][cg][0] = a2.x, av[p][cg][1] = a2.y;
              bv[p][cg][0] = b2.x, bv[p][cg][1] = b2.y;
            }
          }
      }
      uint32_t packed[PGS][2];
#pragma unroll
      for (int p = 0; p < PGS; ++p)
#pragma unroll
        for (int cg = 0; cg < 2; ++cg) {
          packed[p][cg] = 0;  // a row outside the image is zero
          if (s >= 0) {
            const float2 v =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[p][cg]));
            const __nv_bfloat162 y2 =
                __floats2bfloat162_rn(fmaxf(fmaf(v.x, av[p][cg][0], bv[p][cg][0]), 0.f),
                                      fmaxf(fmaf(v.y, av[p][cg][1], bv[p][cg][1]), 0.f));
            packed[p][cg] = *reinterpret_cast<const uint32_t*>(&y2);
          }
          packed[p][cg] = agl::movmatrix_trans(packed[p][cg]);
        }
#pragma unroll
      for (int p = 0; p < PGS; ++p)
#pragma unroll
        for (int cg = 0; cg < 2; ++cg)
          *reinterpret_cast<uint32_t*>(ys + (ty * W + (warp + p * R) * 8 + g8) * CC +
                                       ((cg ^ (g8 >> 2)) * 8) + 2 * t4) = packed[p][cg];
    }
  };
  // XT: y = relu(x * A + B) in place in the staged chunk, which the tensor
  // copy laid out as the y tile. Warp w takes pixels 32 (w % PG) + lane,
  // channels 8 h .. 8 h + 7 with h = (w / PG) % 2, of every RS-th row inside
  // the image from the (w / 2 PG)-th on: one 16-byte word a row, the next
  // row's loaded ahead of this row's store (the compiler keeps a load behind
  // every earlier store). A lane's 16 table values stay in registers while
  // the rows share a slot; the rows outside the image are the copy's zeros.
  auto apply_hwbc = [&](int ci) {
    constexpr int PG = W / 32, RS = R / (2 * PG);
    char* xs = reinterpret_cast<char*>(xbuf(ci));
    const __nv_bfloat16 *ta = tbuf(ci, 0), *tb = tbuf(ci, 1);
    const int px = (warp % PG) * 32 + lane, h = (warp / PG) & 1;
    const int off = px * 32 + ((h ^ ((px >> 2) & 1)) << 4);  // the lane's word in a tile row
    unsigned long long slots = 0;  // 4 bits a row, as apply_nchw keeps them
    for (int ty = 0; ty < TH; ++ty) slots |= (unsigned long long)(slot[ty] & 15) << (4 * ty);
    float av[8], bv[8];
    int cur = -1;
    const int t0 = tylo + warp / (2 * PG);
    uint4 next = make_uint4(0, 0, 0, 0);
    if (t0 < tyhi) next = *reinterpret_cast<const uint4*>(xs + t0 * W * 32 + off);
    for (int ty = t0; ty < tyhi; ty += RS) {
      const uint4 v = next;
      if (ty + RS < tyhi) next = *reinterpret_cast<const uint4*>(xs + (ty + RS) * W * 32 + off);
      const int s = (int)(slots >> (4 * ty)) & 15;
      if (s != cur) {
        cur = s;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = (s * CC + h * 8 + e) * W + px;  // flat tables: W5 == W
          av[e] = __bfloat162float(ta[i]);
          bv[e] = __bfloat162float(tb[i]);
        }
      }
      uint32_t y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t word = reinterpret_cast<const uint32_t*>(&v)[q];
        const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&word));
        const __nv_bfloat162 y2 =
            __floats2bfloat162_rn(fmaxf(fmaf(x2.x, av[2 * q], bv[2 * q]), 0.f),
                                  fmaxf(fmaf(x2.y, av[2 * q + 1], bv[2 * q + 1]), 0.f));
        y[q] = *reinterpret_cast<const uint32_t*>(&y2);
      }
      *reinterpret_cast<uint4*>(xs + ty * W * 32 + off) = make_uint4(y[0], y[1], y[2], y[3]);
    }
    agl::fence_proxy_async();  // these stores come before the copy engine refills the buffer
  };
  auto apply = [&](int ci) {
    if constexpr (XT)
      apply_hwbc(ci);
    else
      apply_nchw(ci);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // The chunk's share of the GEMM: output row `warp`, every row tap a k-step.
  auto product = [&](int ci) {
    const __nv_bfloat16* wsl = ws + (ci & 1) * K * NP * CC + g8 * CC + 4 * t4;
    const __nv_bfloat16* yt = XT ? xbuf(ci) : ys;  // XT: the y tile is the staging buffer
    // ldmatrix x4: lane supplies pixel lane % 16 of the 16-pixel tile, channels
    // 8 (lane / 16) on, which lie in the swizzled half
    const uint32_t abase = agl::smem_u32(
        yt + (warp * W + (lane & 15)) * CC + (((lane >> 4) ^ ((lane >> 2) & 1)) * 8));
    // The asm statements keep their order, so the A fragments are asked for
    // two tiles ahead of the product that uses them, and a row tap's B
    // fragments (x: k = 2t, 2t + 1; y: k = 2t + 8, 2t + 9 of column g) one tap ahead.
    uint2 bf[NT], bnext[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) bnext[nt] = *reinterpret_cast<const uint2*>(wsl + nt * 8 * CC);
    for (int dy = 0; dy < K; ++dy) {
      const uint32_t arow = abase + dy * W * CC * 2;
      uint32_t a[3][4];
      agl::ldmatrix_x4(arow, a[0]);
      agl::ldmatrix_x4(arow + 16 * CC * 2, a[1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bf[nt] = bnext[nt];
        if (dy + 1 < K)
          bnext[nt] = *reinterpret_cast<const uint2*>(wsl + ((dy + 1) * NP + nt * 8) * CC);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt + 2 < MT) agl::ldmatrix_x4(arow + (mt + 2) * 16 * CC * 2, a[(mt + 2) % 3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          agl::mma_bf16(acc[mt][nt], a[mt % 3], bf[nt].x, bf[nt].y);
      }
    }
  };

  const int nchunks = C / CC;
  const bool producer = warp == R;
  if (producer) stage(0, true);
  for (int ci = 0; ci < nchunks; ++ci) {
    __syncthreads();  // chunk ci - 1 is applied and multiplied: its buffers are free
    if (producer) {
      if (ci + 1 < nchunks) stage(ci + 1, XB == 2);  // in flight under this chunk's work
      __syncthreads();
      if (XB == 1 && ci + 1 < nchunks) stage_x(ci + 1);  // chunk ci's x rows are applied
      continue;
    }
    agl::mbar_wait(bar(ci), (ci >> 1) & 1);  // chunk ci has landed
    apply(ci);
    __syncthreads();  // the y tile is whole
    product(ci);
  }
  __syncthreads();  // every warp is done with the operands, which the sums overlay

  // acc[(y, x'), (dx, o)] to shared memory, then the shifted sum over dx.
  if (!producer)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sums[(warp * W + mt * 16 + g8 + 8 * (e >> 1)) * SS + nt * 8 + 2 * t4 + (e & 1)] =
            acc[mt][nt][e];
  __syncthreads();
  for (int i = tid; i < O * R * W; i += THREADS) {
    const int xo = i % W, y = (i / W) % R, o = i / (W * R);
    float s = bias[o];
    for (int dx = 0; dx < K; ++dx) {
      const int xi = xo + dx - r;
      if (xi >= 0 && xi < W) s += sums[(y * W + xi) * SS + dx * O + o];
    }
    out[(((size_t)b * O + o) * H + r0 + y) * W + xo] = __float2bfloat16_rn(s);
  }
}

template <int NT, int MT, bool COMPACT, bool XT, int XB>
cudaError_t launch(const void* x, const void* at, const void* bt, const void* wp,
                   const void* bias, void* out, int B, int C, int H, int K, int O, int f,
                   const Layout& L, const CUtensorMap& xmap, cudaStream_t stream) {
  using T = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(head8_mma_kernel<NT, MT, COMPACT, XT, XB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  head8_mma_kernel<NT, MT, COMPACT, XT, XB><<<dim3(H / R, B), THREADS, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<const T*>(wp), static_cast<const float*>(bias), static_cast<T*>(out), C, H, K,
      O, f, L, xmap);
  return cudaGetLastError();
}

// One x buffer is instantiated only where it can be needed: flat tables and
// x (B, C, H, W) at W = 128.
template <int NT, int MT, bool COMPACT, bool XT>
cudaError_t launch_xb(const void* x, const void* at, const void* bt, const void* wp,
                      const void* bias, void* out, int B, int C, int H, int K, int O, int f,
                      const CUtensorMap& xmap, cudaStream_t s) {
  const Layout L = layout(H, 16 * MT, K, O, f, COMPACT, XT);
  if (L.total > agl::SMEM_LIMIT) return cudaErrorInvalidValue;
  if (L.xb == 2)
    return launch<NT, MT, COMPACT, XT, 2>(x, at, bt, wp, bias, out, B, C, H, K, O, f, L, xmap, s);
  if constexpr (!COMPACT && !XT && MT == 8)
    return launch<NT, MT, COMPACT, XT, 1>(x, at, bt, wp, bias, out, B, C, H, K, O, f, L, xmap, s);
  return cudaErrorInvalidValue;
}

template <int MT, bool COMPACT, bool XT>
cudaError_t dispatch_nt(const void* x, const void* at, const void* bt, const void* wp,
                        const void* bias, void* out, int B, int C, int H, int K, int O, int f,
                        const CUtensorMap& m, cudaStream_t s) {
  switch ((K * O + 7) / 8) {
    case 1: return launch_xb<1, MT, COMPACT, XT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, m, s);
    case 2: return launch_xb<2, MT, COMPACT, XT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, m, s);
    case 3: return launch_xb<3, MT, COMPACT, XT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, m, s);
    case 4: return launch_xb<4, MT, COMPACT, XT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, m, s);
    default: return cudaErrorInvalidValue;
  }
}

// W in {64, 128}, H % 8 == 0, C % 16 == 0, H % f == 0, W % f == 0 with
// COMPACT, K odd <= 7, O <= 4; x and the tables 16-byte aligned; the block's
// shared memory (layout) within the card's. XT (x laid out (H, W, B, C),
// flat tables): the tensor map of x is encoded here, for this call.
template <bool COMPACT, bool XT>
cudaError_t dispatch(const void* x, const void* at, const void* bt, const void* wp,
                     const void* bias, void* out, int B, int C, int H, int W, int K, int O, int f,
                     cudaStream_t s) {
  static_assert(!(COMPACT && XT), "a transposed x takes flat tables");
  if (H % R || C % CC || H % f || (COMPACT && W % f)) return cudaErrorInvalidValue;
  CUtensorMap m{};
  if constexpr (XT) {
    const cudaError_t err = encode_x_map(&m, x, B, C, H, W, R + K - 1);
    if (err != cudaSuccess) return err;
  }
  switch (W) {
    case 64: return dispatch_nt<4, COMPACT, XT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, m, s);
    case 128: return dispatch_nt<8, COMPACT, XT>(x, at, bt, wp, bias, out, B, C, H, K, O, f, m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace
