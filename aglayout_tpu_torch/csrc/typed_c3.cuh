// Device helpers of the typed-c3 kernels (typed_c3_expand.cu, whose kernels
// run v4, v3, v5 and v6): the geometry of the type grids and, for the f32
// reference kernel, the one-object chunk product on FMAs, the column-window
// sum with the bn3 affine, and the expansion's store loop.
//
// Per object, with z2 its grid of c2 values by (row type, col type) and w3
// the (c4, c2, 4, 4) c3 weight:
//   W3z[a, l, w, C] = sum_{h, c} z2[idxR[a, h], l, c] * w3[C, c, h, w]
//   V3[a, b, C]     = relu(a3[C] * sum_w W3z[a, lsel[b, w], w, C] + b3[C])
//   out[C, y, x]    = V3[selR[y], selC[x], C]           (NCHW, s3 x s3)
// Numerics, in every variant: products of compute-dtype operands summed in
// f32, W3z rounded to the compute dtype; the sum over w in f32, affine and
// relu in f32, V3 rounded to the compute dtype; the expansion copies.
#pragma once

#include "common.cuh"

namespace typed {

constexpr int NA = 14;  // window types on the c3 output grid
constexpr int NZ = 12;  // c2 types per axis
constexpr int NL = 13;  // c2 types per axis of the zero-padded grid
constexpr int KW = 4;   // c3 kernel size
constexpr int THREADS = 256;

// Output channels per chunk of the one-object product (chunk_product).
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int CC = 8;
};

// Row stride of a grid tile in shared memory: 16 bytes of padding against
// bank conflicts of ldmatrix (the bf16 kernel's).
__host__ __device__ constexpr int zstride(int c2) { return c2 + 8; }
__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// Bytes of the w3 slice of a chunk of CC channels in shared memory (load_w3).
template <typename T, int CC = Cfg<T>::CC>
__host__ __device__ inline size_t btile_bytes(int c2) {
  return (size_t)KW * c2 * (CC * KW + 1) * sizeof(T);  // [k][n]
}

// Grid-tile row of W3z row m = (a, l), l < LS, at kernel row h: zrow0[a, h]
// is the tile row of (idxR[a, h], 0), negative for a tap outside the image;
// such taps, and the rows past the last real one, read tile row `zero`.
template <int LS>
__device__ __forceinline__ int zrow(const int* zrow0, int m, int h, int zero) {
  if (m >= NA * LS) return zero;
  const int r0 = zrow0[(m / LS) * KW + h];
  return r0 < 0 ? zero : r0 + m % LS;
}

// W3z of one chunk of one object into ws ([NA * LS][N]), f32 on the FMAs:
// zs is the grid tile, rows of zstride(c2); bs: [KW * c2][N + 1]. Ends with
// ws written but not yet synchronised; ws may overlay bs or zs.
template <int LS>
__device__ void chunk_product(const float* zs, const float* bs, float* ws, const int* zrow0,
                              int c2, int zero) {
  constexpr int N = Cfg<float>::CC * KW;  // 32: 8 threads x 4 columns
  constexpr int M = NA * LS, MI = (M + 31) / 32;  // rows per thread, strided by 32
  const int n4 = threadIdx.x % 8, mrow = threadIdx.x / 8, zs_ = zstride(c2);
  float acc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int h = 0; h < KW; ++h) {
    const float* zp[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) zp[i] = zs + zrow<LS>(zrow0, mrow + 32 * i, h, zero) * zs_;
    for (int c = 0; c < c2; ++c) {
      const float* bp = bs + (size_t)(h * c2 + c) * (N + 1) + 4 * n4;
      const float bv[4] = {bp[0], bp[1], bp[2], bp[3]};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float av = zp[i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // every thread is done with bs and zs, either of which ws may overlay
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = mrow + 32 * i;
    if (m < M)
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[m * N + 4 * n4 + j] = acc[i][j];
  }
}

// A chunk's w3 slice: channels [c0, c0 + CC) of wk ((c4, KW, KW * c2), rows
// (C, w), columns (h, c)), into shared memory as [KW * c2][N + 1].
template <int CC>
__device__ inline void load_w3(const float* wk, float* bs, int c0, int c2) {
  constexpr int N = CC * KW;
  const int K = KW * c2;
  const float* src = wk + (size_t)c0 * KW * K;
  for (int i = threadIdx.x; i < N * K; i += THREADS) {
    const int k = i / N, n = i % N;  // neighbouring threads: neighbouring columns
    bs[(size_t)k * (N + 1) + n] = src[(size_t)n * K + k];
  }
}

// One object's 12 x 12 grid tile from its (side, side, c2) grid z, side 12
// or 13 (zero-padded: its row and column 12 are not read), into zs, rows of
// zstride(c2), 16 bytes a copy, by `nthreads` threads from `first` on.
template <typename T>
__device__ __forceinline__ void load_grid(const T* z, T* zs, int c2, int side, int first,
                                          int nthreads) {
  using V = agl::Vec16<T>;
  const int cv = c2 / V::N;
  const uint4* src = reinterpret_cast<const uint4*>(z);
  for (int i = first; i < NZ * NZ * cv; i += nthreads) {
    const int m = i / cv;  // (row type, col type) = (m / 12, m % 12)
    *reinterpret_cast<uint4*>(zs + m * zstride(c2) + (i % cv) * V::N) =
        src[(m + m / NZ * (side - NZ)) * cv + i % cv];
  }
}

// V3 of a chunk of cc channels from its W3z in shared memory, ws
// ([NA * LS][cc * KW]): the sum over w of the column windows (lsl[b, w]
// outside [0, LS) adds zero), affine, relu, into v3 ([cc][NA][NA]). a3, b3
// point at the chunk's first channel.
template <typename T, int LS>
__device__ __forceinline__ void v3_from_w3z(const T* ws, const int* lsl, const float* a3,
                                            const float* b3, T* v3, int cc) {
  const int N = cc * KW;
  for (int i = threadIdx.x; i < cc * NA * NA; i += THREADS) {
    const int ci = i / (NA * NA), a = (i / NA) % NA, bcol = i % NA;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int l = lsl[bcol * KW + w];
      if (l >= 0 && l < LS) s += agl::to_f(ws[(a * LS + l) * N + ci * KW + w]);
    }
    v3[i] = agl::from_f<T>(fmaxf(s * a3[ci] + b3[ci], 0.f));
  }
}

// The expansion of a chunk: out[ci, y, x] = V3[ci, sr[y], sc[x]] (zero for a
// type outside [0, NA)), 16 bytes a store. out points at the chunk's first
// channel of the object's (c4, s3, s3) map.
template <typename T>
__device__ __forceinline__ void expand_store(const T* v3, const int* sr, const int* sc, T* out,
                                             int cc, int s3) {
  using V = agl::Vec16<T>;
  const int xv = s3 / V::N;
  for (int i = threadIdx.x; i < cc * s3 * xv; i += THREADS) {
    const int x8 = i % xv, y = (i / xv) % s3, ci = i / (xv * s3);
    const int a = sr[y];
    V v;
#pragma unroll
    for (int e = 0; e < V::N; ++e) {
      const int bcol = sc[x8 * V::N + e];
      v.v()[e] = (a >= 0 && a < NA && bcol >= 0 && bcol < NA) ? v3[(ci * NA + a) * NA + bcol]
                                                               : agl::from_f<T>(0.f);
    }
    *reinterpret_cast<uint4*>(out + ((size_t)ci * s3 + y) * s3 + x8 * V::N) = v.raw;
  }
}

}  // namespace typed
