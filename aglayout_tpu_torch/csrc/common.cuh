// Shared helpers for the kernels of this directory: conversions between the
// compute dtype (float or bf16) and float, vector loads and stores, the
// SPADE table geometry, the tensor-core and copy-engine primitives.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agl {

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one H100 block can use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>  // round to nearest even, as torch's and XLA's casts
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive values (16-byte aligned for float, 8-byte for bf16) as floats.
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

// One 16-byte vector of T (8 bf16 or 4 float), held in registers.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T* v() { return reinterpret_cast<T*>(&raw); }
};

// SPADE block class of offset u < f inside an f-pixel block (f >= 5):
// 0 for u = 0, 1 for u = 1, 3 for u = f-2, 4 for u = f-1, 2 between.
__device__ __forceinline__ int row_class(int u, int f) {
  return u == 0 ? 0 : u == 1 ? 1 : u == f - 2 ? 3 : u == f - 1 ? 4 : 2;
}

// Column of the compact (B, H/f, 5, C, 5 * W/f) tables for image column j.
__device__ __forceinline__ int compact_col(int j, int f) { return (j / f) * 5 + row_class(j % f, f); }

// Shared-memory address of p, as ldmatrix and cp.async take it.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8-row x 16-byte matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8; register m of lane l then holds bytes
// 4 (l % 4) .. 4 (l % 4) + 3 of row l / 4 of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b on the bf16 tensor cores: a is 16 x 16 (rows, k contiguous), b is
// 16 x 8 held k-contiguous per column, d is 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An mbarrier in shared memory (8 bytes, 8-byte aligned; `bar` is its
// smem_u32 address) that tracks the bytes of asynchronous bulk copies.
// mbar_init by one thread, then mbar_fence_init and a block barrier before
// any use. A phase ends when `count` arrivals are in and every expected byte
// has landed; the phases alternate parity 0, 1, 0, ...
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// One arrival, releasing this thread's earlier writes to who waits.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spins until the phase of parity `parity` has ended.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// The same two for the warps that issue wgmma, with no C++ branch between
// their wgmmas: the wait's loop inside the asm, the arrival predicated
// instead of a test of the lane. `stage_times k6` times the product kernel
// with `mbar_wait` and a lane test in their place.
__device__ __forceinline__ void mbar_wait_in_asm(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine (descriptor-free cp.async.bulk); the
// bytes count towards the current phase of `bar`. One thread asks for it.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// The box at coordinates (c0, c1, c2, c3) (innermost first) of the 4-D tensor
// that `map` (a CUtensorMap: a __grid_constant__ kernel parameter or in
// global memory) describes, from global to shared memory by the copy engine
// (a TMA tensor copy), laid out and swizzled as the map says; elements
// outside the tensor land as zeros, and the box's whole size counts towards
// the current phase of `bar`. dst: aligned as the map's swizzle wants (1024
// bytes serves every swizzle). One thread asks for it.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// Fetches a tensor map into the copy engine's cache ahead of its first use.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from shared to
// global memory by the copy engine; the thread goes on at once. The copies a
// thread asks for before bulk_commit form a group; bulk_wait_read waits until
// the engine has read the source of every group of this thread, which may
// then be overwritten (the writes to global memory may still be on their way;
// they are done when the kernel ends).
__device__ __forceinline__ void bulk_copy_s2g(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
template <int PENDING = 0>  // ... of every group of this thread but the newest PENDING
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
}
// Orders this thread's earlier shared-memory accesses before later accesses
// of the copy engine (the async proxy), as before refilling a buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads') among `threads` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The transpose of an 8 x 8 matrix of 16-bit values held by a warp: on entry
// lane l holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (low half
// first), as an ldmatrix register; on return it holds the same of the
// transposed matrix.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// Four quantised values packed low byte first, as they lie in memory.
__device__ __forceinline__ uint32_t pack_s8x4(int q0, int q1, int q2, int q3) {
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
         ((uint32_t)(q3 & 0xff) << 24);
}

// Largest lane value of a warp, in every lane.
__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

}  // namespace agl
