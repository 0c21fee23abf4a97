// SPADE apply + relu from class tables: out = relu(x * A + B).
//
// Replaces the TPU kernels aglayout_tpu/ops/pallas_spade_conv.py::spade_apply8
// (SPADE-4 between the decoder's c5 and c6 at 128^2) and ::spade_apply_t
// (the same function from tables whose columns are at full resolution). A
// and B are the SPADE+BN folded affine at class resolution. spade_apply8
// takes them compact (B, H/f, 5, C, 5 * W/f): the affine of pixel (g, j),
// channel c is tab[b, g / f, class(g % f), c, (j / f) * 5 + class(j % f)],
// so the full-resolution gamma and beta never exist. spade_apply_t takes
// the flat form (B, H/f, 5, C, W), column j itself.
//
// What bounds both on the H100: nothing but bytes. At 128^2, B=128, C=128
// in bf16 they read x (537 MB), write out (537 MB) and read the two tables
// once: 105 MB compact (1.18 GB in all, 0.35 ms at 3.35 TB/s), 336 MB flat
// (1.41 GB, 0.42 ms). A few flops per byte.
//
// spade_apply_kernel (compact tables) reuses each table value across the
// f pixels of its column class, so it stages them:
//   - one CTA per (image, f-row block, block of `cb` channels), so the CTA
//     needs exactly the 5 row classes x cb channels x 5 W/f columns of each
//     table, which it stages once in shared memory as f32;
//   - each thread then streams 16-byte vectors of x (8 bf16 or 4 f32):
//     one vector load, the affine and relu from shared memory, one vector
//     store; neighbouring threads take neighbouring vectors of a row.
// spade_apply_flat_kernel (flat tables) has nothing to reuse across columns,
// and of the 5 row classes only class 2 serves more than one row, so it
// stages nothing: no shared memory, no barrier, any W.
//   - one thread per (image, channel, f-row block, 16-byte column vector):
//     it issues its x loads for the block's rows first, 16-byte vectors,
//     then its A and B vectors of the 5 row classes (5 loads of each
//     table: every table byte is read once over the grid), then applies
//     each row in f32 and stores one 16-byte vector a row;
//   - neighbouring threads take neighbouring column vectors of one row, so
//     each warp access covers whole 32-byte sectors;
//   - a thread holds rows 0, 1, f-2, f-1 and up to MID middle rows at once
//     (f <= MID + 4 = 16: every x load of the thread in flight together,
//     256 B); the middle rows past those follow MID at a time, so any
//     f >= 5 runs in bounded registers;
//   - a flat grid of ceil(B C (H/f) (W/vector) / 256) blocks of 256
//     threads (2.1 M threads, 8,192 blocks at SPADE-4's shape: many waves).
// Numerics (both kernels): y = relu(fma(x, A, B)) in f32, rounded once to
// the compute dtype. In bf16 x * A is exact in f32, so y is the plain
// version's bits; in f32 the fused multiply-add is the kernels' own.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MID = 12;  // middle rows (class 2) a flat-kernel thread holds at once

// x, out: (B, C, H, W) T; at, bt: compact (B, H/f, 5, C, W5) T with W5 =
// 5 W / f. Grid (C / cb, H / f, B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
spade_apply_kernel(const T* __restrict__ x, const T* __restrict__ at, const T* __restrict__ bt,
                   T* __restrict__ out, int C, int H, int W, int f, int cb) {
  extern __shared__ __align__(16) float tabs[];  // [2][5][cb][W5]
  const int W5 = (W / f) * 5, HB = H / f;
  const int c0 = blockIdx.x * cb, hb = blockIdx.y, b = blockIdx.z;
  const int tsize = 5 * cb * W5;
  float* ta = tabs;
  float* tb = tabs + tsize;
  for (int i = threadIdx.x; i < tsize; i += THREADS) {
    const int rc = i / (cb * W5), rem = i % (cb * W5);
    const size_t src = (((size_t)b * HB + hb) * 5 + rc) * C * W5 + (size_t)c0 * W5 + rem;
    ta[i] = agl::to_f(at[src]);
    tb[i] = agl::to_f(bt[src]);
  }
  __syncthreads();

  using V = agl::Vec16<T>;
  const int nv = W / V::N, total = cb * f * nv;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int jv = i % nv, row = i / nv, u = row % f, c = row / f;
    const size_t base = (((size_t)b * C + c0 + c) * H + (size_t)hb * f + u) * W + jv * V::N;
    const int tab = (agl::row_class(u, f) * cb + c) * W5;
    V v;
    v.raw = *reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int e = 0; e < V::N; ++e) {
      const int col = tab + agl::compact_col(jv * V::N + e, f);
      v.v()[e] = agl::from_f<T>(fmaxf(agl::to_f(v.v()[e]) * ta[col] + tb[col], 0.f));
    }
    *reinterpret_cast<uint4*>(out + base) = v.raw;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* at, const void* bt, void* out, int B, int C, int H,
                   int W, int f, int cb, cudaStream_t stream) {
  const size_t smem = 2 * 5 * (size_t)cb * (W / f) * 5 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spade_apply_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(C / cb, H / f, B);
  spade_apply_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<T*>(out), C, H, W, f, cb);
  return cudaGetLastError();
}

// The flat kernel's 16-byte accesses of device memory.
__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void st16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// relu(x * a + b) of one vector, in f32, rounded once to T.
template <typename T>
__device__ __forceinline__ uint4 apply16(uint4 xr, uint4 ar, uint4 br) {
  agl::Vec16<T> xv{xr}, av{ar}, bv{br};
#pragma unroll
  for (int e = 0; e < agl::Vec16<T>::N; ++e)
    xv.v()[e] = agl::from_f<T>(
        fmaxf(__fmaf_rn(agl::to_f(xv.v()[e]), agl::to_f(av.v()[e]), agl::to_f(bv.v()[e])), 0.f));
  return xv.raw;
}

// x, out: (B, C, H, W) T; at, bt: flat (B, H/f, 5, C, W) T; `units` = B C
// (H/f) (W / vector) threads, one per column vector of one f-row block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
spade_apply_flat_kernel(const T* __restrict__ x, const T* __restrict__ at,
                        const T* __restrict__ bt, T* __restrict__ out, int C, int H, int W, int f,
                        long long units) {
  constexpr int N = agl::Vec16<T>::N;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= units) return;
  const int nv = W / N, HB = H / f;
  const int jv = (int)(i % nv);
  const long long blk = i / nv;          // (b, c, hb)
  const int hb = (int)(blk % HB);
  const long long bc = blk / HB;         // b * C + c
  const long long b = bc / C;
  const int c = (int)(bc % C);
  const size_t row0 = ((size_t)bc * H + (size_t)hb * f) * W + (size_t)jv * N;
  const T* xp = x + row0;
  T* op = out + row0;
  const size_t ts = (size_t)C * W;  // one row class to the next
  const size_t tab = (((size_t)b * HB + hb) * 5 * C + c) * W + (size_t)jv * N;
  const int mid = f - 4, m0 = mid < MID ? mid : MID;  // class-2 rows 2 .. f-3; first MID of them

  // x first: rows 0, 1, f-2, f-1 and the first m0 middle rows, all in flight
  uint4 e0 = ld16(xp), e1 = ld16(xp + W);
  uint4 e3 = ld16(xp + (size_t)(f - 2) * W), e4 = ld16(xp + (size_t)(f - 1) * W);
  uint4 m[MID];
#pragma unroll
  for (int r = 0; r < MID; ++r)
    if (r < m0) m[r] = ld16(xp + (size_t)(2 + r) * W);
  // then the 5 row classes of both tables
  uint4 a[5], bb[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    a[k] = ld16(at + tab + k * ts);
    bb[k] = ld16(bt + tab + k * ts);
  }
  st16(op, apply16<T>(e0, a[0], bb[0]));
  st16(op + W, apply16<T>(e1, a[1], bb[1]));
#pragma unroll
  for (int r = 0; r < MID; ++r)
    if (r < m0) st16(op + (size_t)(2 + r) * W, apply16<T>(m[r], a[2], bb[2]));
  st16(op + (size_t)(f - 2) * W, apply16<T>(e3, a[3], bb[3]));
  st16(op + (size_t)(f - 1) * W, apply16<T>(e4, a[4], bb[4]));
  // f > MID + 4: the remaining middle rows, MID at a time
  for (int r0 = 2 + MID; r0 < f - 2; r0 += MID) {
    const int n = f - 2 - r0;
#pragma unroll
    for (int r = 0; r < MID; ++r)
      if (r < n) m[r] = ld16(xp + (size_t)(r0 + r) * W);
#pragma unroll
    for (int r = 0; r < MID; ++r)
      if (r < n) st16(op + (size_t)(r0 + r) * W, apply16<T>(m[r], a[2], bb[2]));
  }
}

template <typename T>
cudaError_t launch_flat(const void* x, const void* at, const void* bt, void* out, int B, int C,
                        int H, int W, int f, cudaStream_t stream) {
  const long long units = (long long)B * C * (H / f) * (W / agl::Vec16<T>::N);
  spade_apply_flat_kernel<T><<<(unsigned)((units + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(at), static_cast<const T*>(bt),
      static_cast<T*>(out), C, H, W, f, units);
  return cudaGetLastError();
}

}  // namespace

// C % cb == 0, H % f == 0, W % f == 0, W % 8 == 0, f >= 5; returns the
// launch's cudaError_t.
extern "C" int spade_apply8(const void* x, const void* at, const void* bt, void* out, int B, int C,
                            int H, int W, int f, int cb, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, at, bt, out, B, C, H, W, f, cb, s);
  return (int)launch<float>(x, at, bt, out, B, C, H, W, f, cb, s);
}

// The same from flat tables (B, H/f, 5, C, W): f >= 5, H % f == 0, W a
// multiple of the 16-byte vector (8 bf16, 4 f32), x, at and bt 16-byte
// aligned; any W and any f beyond that.
extern "C" int spade_apply_t(const void* x, const void* at, const void* bt, void* out, int B, int C,
                             int H, int W, int f, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_flat<__nv_bfloat16>(x, at, bt, out, B, C, H, W, f, s);
  return (int)launch_flat<float>(x, at, bt, out, B, C, H, W, f, s);
}
