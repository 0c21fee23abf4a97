// Typed c3 on the zero-padded type grid, a group of objects per block.
//
// Replaces the TPU kernel
// aglayout_tpu/ops/pallas_typed_expand.py::typed_c3_expand (v3): the
// function of typed_c3_expand.cu (see typed_c3.cuh) on the padded
// (13, 13, c2) grid of an object, whose row 12 and column 12 are zeros:
// idxR in [0, 13) reads its row like any other, lsel in [0, 13) its column,
// and only lsel == 13 stands for a tap outside the image. The Pallas kernel
// batches `group` objects a program with block-diagonal one-hot selectors so
// that its matmuls fill the MXU; what a group buys on this card is the
// weights' reuse.
//
// What bounds it on the H100: operations, as typed_c3_expand.cu: per object
// a (182 x 512) x (512 x 1024) product, 244 GFLOP at B * O = 1280 (the
// padded column is computed, 13 / 12 of the unpadded work), 0.25 ms at the
// bf16 tensor-core peak. typed_c3_expand.cu re-reads each chunk's 128 KB w3
// slice from L2 once per object, 1.3 GB a batch. Here:
//   - a block takes `group` objects for ONE chunk of CC = 32 output
//     channels (grid: groups x chunks): the chunk's w3 slice is loaded once
//     and stays in shared memory for the whole group, so L2 -> shared
//     weight traffic falls by the group size;
//   - per object the 169-row grid tile is loaded, the product runs as in
//     typed_c3_expand.cu (typed::chunk_product, 12 row tiles), and W3z and
//     V3 overlay the grid tile, which the next object reloads;
//   - no zero row and no branch: every tap reads a row of the tile.
// In f32 the product runs on FMAs (CC = 8), a reference path.

#include "typed_c3.cuh"

namespace {

using namespace typed;

constexpr int M = NA * NL;     // rows (a, l) of W3z
constexpr int ZROWS = NL * NL;  // rows of the grid tile

// Shared memory, in bytes: the chunk's w3 slice; then the grid tile, which
// W3z and V3 overlay after the product; then the index tables.
template <typename T>
__host__ __device__ inline size_t tile_bytes(int c2) {
  constexpr int N = Cfg<T>::CC * KW;
  const size_t grid = (size_t)ZROWS * zstride(c2) * sizeof(T);
  const size_t w3z_v3 = ((size_t)M * N + (size_t)Cfg<T>::CC * NA * NA) * sizeof(T);
  return align16(grid > w3z_v3 ? grid : w3z_v3);
}
template <typename T>
__host__ __device__ inline size_t smem_bytes(int c2, int s3) {
  return align16(btile_bytes<T>(c2)) + tile_bytes<T>(c2) +
         (size_t)(2 * NA * KW + 2 * s3) * sizeof(int);
}

// z2p: (n, 13, 13, c2) T; idxR, lsel: (n, 14, 4) i32; selR, selC: (n, s3)
// i32; ab: (n, 2, c4) f32; wk: (c4, KW, KW * c2) T, rows (C, w), columns
// (h, c); out: (n, c4, s3, s3) T. Grid (ceil(n / group), c4 / CC).
template <typename T>
__global__ void __launch_bounds__(THREADS)
typed_c3_expand_v3_kernel(const T* __restrict__ z2p, const int* __restrict__ idxR,
                          const int* __restrict__ lsel, const int* __restrict__ selR,
                          const int* __restrict__ selC, const float* __restrict__ ab,
                          const T* __restrict__ wk, T* __restrict__ out, int n, int c2, int c4,
                          int s3, int group) {
  constexpr int CC = Cfg<T>::CC, N = CC * KW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);
  unsigned char* tile = smem_raw + align16(btile_bytes<T>(c2));
  T* zs = reinterpret_cast<T*>(tile);
  T* ws = reinterpret_cast<T*>(tile);                      // [M][N], after the product
  T* v3 = reinterpret_cast<T*>(tile + M * N * sizeof(T));  // [CC][NA][NA]
  int* zrow0 = reinterpret_cast<int*>(tile + tile_bytes<T>(c2));  // [NA][KW]
  int* lsl = zrow0 + NA * KW;                                     // [NA][KW]
  int* sr = lsl + NA * KW;                                        // [s3]
  int* sc = sr + s3;                                              // [s3]
  const int tid = threadIdx.x, c0 = blockIdx.y * CC;

  load_w3<CC>(wk, bs, c0, c2);
  for (int obj = blockIdx.x * group; obj < min(n, (blockIdx.x + 1) * group); ++obj) {
    __syncthreads();  // the previous object is written out
    for (int i = tid; i < NA * KW; i += THREADS) {
      zrow0[i] = min(max(idxR[obj * NA * KW + i], 0), NL - 1) * NL;
      lsl[i] = lsel[obj * NA * KW + i];
    }
    for (int i = tid; i < s3; i += THREADS) {
      sr[i] = selR[obj * s3 + i];
      sc[i] = selC[obj * s3 + i];
    }
    load_grid(z2p + (size_t)obj * ZROWS * c2, zs, ZROWS, c2);
    __syncthreads();
    // the rows past the last real one are not stored: they read tile row 0
    chunk_product<NL>(zs, bs, ws, zrow0, c2, 0);
    __syncthreads();
    const float* a3 = ab + (size_t)obj * 2 * c4 + c0;
    v3_from_w3z<T, NL>(ws, lsl, a3, a3 + c4, v3, CC);
    __syncthreads();
    expand_store(v3, sr, sc, out + ((size_t)obj * c4 + c0) * s3 * s3, CC, s3);
  }
}

template <typename T>
cudaError_t launch(const void* z2p, const void* idxR, const void* lsel, const void* selR,
                   const void* selC, const void* ab, const void* wk, void* out, int n, int c2,
                   int c4, int s3, int group, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(c2, s3);
  cudaError_t err = cudaFuncSetAttribute(typed_c3_expand_v3_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + group - 1) / group, c4 / Cfg<T>::CC);
  typed_c3_expand_v3_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(z2p), static_cast<const int*>(idxR), static_cast<const int*>(lsel),
      static_cast<const int*>(selR), static_cast<const int*>(selC), static_cast<const float*>(ab),
      static_cast<const T*>(wk), static_cast<T*>(out), n, c2, c4, s3, group);
  return cudaGetLastError();
}

}  // namespace

// c2 % 16 == 0, c4 % 32 == 0, s3 % 8 == 0, group >= 1; returns the launch's
// cudaError_t.
extern "C" int typed_c3_expand_v3(const void* z2p, const void* idxR, const void* lsel,
                                  const void* selR, const void* selC, const void* ab,
                                  const void* wk, void* out, int n, int c2, int c4, int s3,
                                  int group, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(z2p, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3,
                                      group, s);
  return (int)launch<float>(z2p, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, group, s);
}
