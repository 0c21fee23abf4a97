"""Where the time of the tensor-core kernels goes: the residual trunk (K1),
the RGB heads (K2 at the c4 head, K3 at the c7 head, K2's transposed mode
K2t at the c7 head's shape), the typed c3 expansion (K5 and its v3, v5, v6
schedules), the int8 convs (K6, K7) and SPADE-4's apply (K4 on compact
tables, K4' on flat ones), as one-off variants of a kernel with a stage
cut out, timed on the card.

    python3 -m aglayout_tpu_torch.stage_times k1 k2 k2t k3 k4 k4t k5 k5v3 k5v5 k5v6 k6 k7
    python3 -m aglayout_tpu_torch.stage_times --csrc <an earlier csrc/> k1_fma k2_fma k2t_fma k3_fma k5_serial
    python3 -m aglayout_tpu_torch.stage_times --csrc <a csrc/ before K6's wgmma kernel> k6_mma_sync
    python3 -m aglayout_tpu_torch.stage_times --csrc <a csrc/ before K7's wgmma kernel> k5v5_scratch k7_mma_sync
    python3 -m aglayout_tpu_torch.stage_times --csrc <a csrc/ before v3 ran on K5's kernel> k5v3_group
    python3 -m aglayout_tpu_torch.stage_times --csrc <a csrc/ before K4''s flat kernel> k4t_smem
    python3 -m aglayout_tpu_torch.stage_times --whole [--box] [--csrc <a csrc/>] k2t k4 k4t k5 k5v3 k5v5 k5v6 k6 k7

Needs one CUDA card and `nvcc`. Each variant is the shipped source with a
few lines replaced (a call removed, a loop bound set to 0), copied with the
rest of `csrc/` under `build/stage_times/` (listed in `.gitignore`),
compiled on its own and called at the shape the 128^2 serving path gives
the kernel (B = 128, O = 10, bf16). A variant computes a wrong result; only
its time is read (CUDA events over 20 launches, twice); the whole kernel's
also on the device (`chip_smoke.device_ms`, its hand-written launches
checked in the trace), and the hash of its output, which two csrc/
directories' kernels that give the same bits share. `--whole` builds and
times the whole kernel alone
(an earlier csrc/ may lack the lines the cuts replace); `--box` also times
a typed kernel, whole, on the inputs the 128^2 path makes from the serving
bench's layouts. The shipped kernels have no switch for any
of this. `VARIANTS` names the replaced lines:
`tests/test_torch_port_redesign.py` holds them against the sources, so an
edit that moves a line shows there and not on the card.

`k1` cuts the tensor-core kernel of `csrc/residual_trunk.cu`; `k2` and `k3`
the one of `csrc/spade_head_tc.cuh`, as `csrc/spade_few_out_conv.cu` builds
it for the c4 head's flat tables and `csrc/spade_few_out_conv8.cu` for the
c7 head's compact ones, `k2t` its transposed instantiation (x (H, W, B, C),
one TMA tensor copy a chunk) at the c7 head's shape; `k5` the one of
`csrc/typed_c3_expand.cu`, and `k5v6` the same lines in its v6
instantiation (`typed_c3_expand_v6`, on the same random inputs), and
`k5v5` and `k5v3` the same kernel as `typed_c3_expand_v5` and
`typed_c3_expand_v3` launch it (v3 on the zero-padded grid); `k6` the
three launches of `csrc/conv_small_int8.cu` (the two quantise passes, the
wgmma product and its copies) and `k7` those of `csrc/spade_c6_int8.cu`
(the max pass, the apply and quantise pass, the wgmma product, its weight
and map copies); `k4` the compact-table apply of `csrc/spade_apply.cu`
(no table staging; its stores under a never-true condition, which keeps
the loads) and `k4t` its flat-table kernel (the five row classes' table
vectors from one address, so one load of each table; no stores; both;
streaming cache hints on every load and store). `k1_fma`,
`k2_fma`, `k2t_fma`, `k3_fma` and `k5_serial` cut the bf16 kernels those
replaced (FMAs on the CUDA cores; one block an object, its stages one after
the other), read with `--csrc` from a checkout that has them (K1's and
K2's FMA kernels still ship, for f32 and the shapes the tensor cores do not
take); `k6_mma_sync` and `k7_mma_sync` the `mma.sync` kernels K6 and K7
replaced, `k5v6_serial` the one-block-an-object v6 kernel K5-v6 replaced,
`k5v5_scratch` the two-stage v5 kernel whose W3z went through a device
scratch, `k5v3_group` the v3 kernel whose blocks took a group of objects
for one weight chunk and `k4t_smem` K4''s kernel that staged both flat
tables in shared memory, from a `csrc/` that still has them (`EARLIER`),
whole.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

from aglayout_tpu_torch.kernels import build

ROOT = build.BUILD_DIR.parent / "stage_times"

def _zero(line: str):
    """The replacement that makes a `for (...; i < N; ...)` loop run no time."""
    head, rest = line.split(" < ", 1)
    return line, head + " < 0" + rest[rest.index(";"):]


# ---- the lines of csrc/spade_head_tc.cuh that the k2 and k3 variants replace
K3_STAGE0 = "  if (producer) stage(0, true);\n"
K3_STAGE = ("      if (ci + 1 < nchunks) stage(ci + 1, XB == 2);  // in flight under this chunk's "
            "work\n")
K3_STAGE_X = ("      if (XB == 1 && ci + 1 < nchunks) stage_x(ci + 1);  // chunk ci's x rows are "
              "applied\n")
K3_WAIT = "    agl::mbar_wait(bar(ci), (ci >> 1) & 1);  // chunk ci has landed\n"
K3_APPLY, K3_PRODUCT = "    apply(ci);\n", "    product(ci);\n"
K3_NO_LOADS = [(K3_STAGE0, ""), (K3_STAGE, ""), (K3_STAGE_X, ""), (K3_WAIT, "")]
K3_DX = "for (int dx = 0; dx < K; ++dx) {\n      const int xi"
HEAD_CUTS = [
    ("whole kernel", []),
    ("copies + apply pass (no product)", [(K3_PRODUCT, "")]),
    ("copies only", [(K3_PRODUCT, ""), (K3_APPLY, "")]),
    ("apply pass only", [(K3_PRODUCT, "")] + K3_NO_LOADS),
    ("product only", [(K3_APPLY, "")] + K3_NO_LOADS),
    ("apply pass + product (no copies)", K3_NO_LOADS),
    ("no shifted sum (one column tap)", [(K3_DX, K3_DX.replace("dx = 0; dx < K", "dx = r; dx <= r"))]),
    ("no transpose in the warp", [("packed[p][cg] = agl::movmatrix_trans(packed[p][cg]);", "")]),
    ("the sums' write-out only", [(K3_PRODUCT, ""), (K3_APPLY, "")] + K3_NO_LOADS),
]
# k2t: its x comes by one tensor copy a chunk, whose bytes the mbarrier
# expects; both go for "no x copies" (the table and weight copies stay)
K2T_NO_X = [("  constexpr int NX = XT ? 1 : CC;  // x copies a chunk\n",
             "  constexpr int NX = XT ? 0 : CC;  // x copies a chunk\n"),
            ("  const uint32_t xtx = XT ? TH * W * CC * 2 : CC * xbytes;",
             "  const uint32_t xtx = XT ? 0 : CC * xbytes;")]
K2T_CUTS = [
    ("whole kernel", []),
    ("no apply pass (copies + product)", [(K3_APPLY, "")]),
    ("no x copies (table and weight copies, apply pass, product)", K2T_NO_X),
    ("copies only", [(K3_PRODUCT, ""), (K3_APPLY, "")]),
    ("apply pass only", [(K3_PRODUCT, "")] + K3_NO_LOADS),
    ("product only", [(K3_APPLY, "")] + K3_NO_LOADS),
]
# ---- of csrc/residual_trunk.cu (k1: the tensor-core kernel)
K1_NO_COPIES = [
    _zero("      for (int i = 0; i < nstages; ++i) {"),
    ("      agl::mbar_wait(full(s), (stage / L.stages) & 1);  // the tap's weights have landed\n", ""),
]
K1_NO_MMA = [("          agl::mma_bf16(acc[j], a[kc], bv.x, bv.y);\n", "")]
# An epilogue cut out leaves the products unread, and ptxas then drops the
# mma instructions themselves: the sums go into one register instead.
K1_SUM = "    for (int j = 0; j < NT; ++j) for (int e = 0; e < 4; ++e) skip[0][0] += acc[j][e];\n"
K1_NO_EPILOGUES = [("    epilogue1(r);\n", K1_SUM), ("    epilogue2(r);\n", K1_SUM)]
# ---- of csrc/typed_c3_expand.cu (k5)
K5_V3 = "      for (int i0 = et; i0 < items; i0 += 2 * ET) {"
K5_TYPES = "        for (int j = G ? rfirst : et / xv; j < nrows; j += rstep * U) {"
K5_PIECES = "        for (int c0 = e0; c0 < e0 + gsz; c0 += psz, ++piece) {"
K5_FILL = "          for (int r = G ? rfirst : et / xv; r < nr; r += rstep * U) {"
K5_WGMMA = ("            wgmma_m64n128k16(acc, cur[kk], wgmma_desc_sw128(bbase + kk * 32), "
            "(sl | kk) != 0);\n")
K5_COPY = ("            agl::bulk_copy_s2g(out + ((size_t)obj * c4 + ch * CC + c0) * s3 * s3, "
           "agl::smem_u32(plane),\n                               psz * s3 * s3 * 2);\n")

K5_CUTS = [
    ("whole kernel", []),
    ("no V3 sums", [_zero(K5_V3)]),
    ("no row types, no output (V3 only)", [_zero(K5_TYPES), _zero(K5_PIECES)]),
    ("no output rows (V3 and row types)", [_zero(K5_FILL)]),
    ("no copy to device memory", [(K5_COPY, "")]),
    ("no epilogue work (product only)", [_zero(K5_V3), _zero(K5_TYPES), _zero(K5_PIECES)]),
    ("no product (epilogue only)", [(K5_WGMMA, "")]),
]
# ---- of csrc/conv_small_int8.cu (k6: the three launches of a call)
K6_CONV = ("  conv<<<dim3((Cout + BM - 1) / BM, groups), CONV_THREADS, smem, stream>>>(\n"
           "      qp, static_cast<const int8_t*>(wp), static_cast<const float*>(sw), am,\n"
           "      static_cast<T*>(out), B, nchunks, Cout, k, gb);\n")
K6_QUANTISE = [
    ("  absmax_kernel<T><<<dim3(splits, chunks), THREADS, 0, stream>>>(static_cast<const T*>(x), am,\n"
     "                                                                per_chunk);\n", ""),
    ("  quantize_kernel<T><<<dim3(nchunks, groups * IMG), THREADS, 0, stream>>>(\n"
     "      static_cast<const T*>(x), am, qp, B, Cin, nchunks, k, gb);\n", ""),
]
K6_WAIT_MAP = "        agl::mbar_wait_in_asm(mfull(c % MSTAGES), (c / MSTAGES) & 1);\n"
K6_WAIT_W = "    agl::mbar_wait_in_asm(full(wst), wph);\n"
K6_MAPS = [_zero("    for (int c = 0; c < nchunks; ++c) {"), (K6_WAIT_MAP, "")]
K6_NO_COPIES = K6_MAPS + [_zero("    for (int sl = 0, st = 0, ph = 0; sl < nslices; ++sl) {"),
                          (K6_WAIT_W, "")]
K6_WGMMA = "      agl::wgmma_m64n256k32_s8(acc, da, db, s != 0);\n"
K6_FREE_MAP = "      agl::mbar_arrive_if(mempty(freed % MSTAGES), lane == 0);\n"
K6_FREE_W = "      agl::mbar_arrive_if(empty(wst == 0 ? WST - 1 : wst - 1), lane == 0);\n"
# the consumers' waits and arrivals as the other kernels write them: a C++
# spin loop (`mbar_wait`) and a test of the lane
K6_PLAIN_BARRIERS = [
    (K6_WAIT_MAP, K6_WAIT_MAP.replace("mbar_wait_in_asm", "mbar_wait")),
    (K6_WAIT_W, K6_WAIT_W.replace("mbar_wait_in_asm", "mbar_wait")),
    (K6_FREE_MAP, "      if (lane == 0) agl::mbar_arrive(mempty(freed % MSTAGES));\n"),
    (K6_FREE_W, "      if (lane == 0) agl::mbar_arrive(empty(wst == 0 ? WST - 1 : wst - 1));\n"),
]
# ---- of csrc/spade_c6_int8.cu (k7: the three launches of a call)
K7_MAX = "  max_kernel<T><<<passes, PASS_THREADS, smem_max, stream>>>(xp, ap, bp, ym, C, H, W, f);\n"
K7_QUANTISE = ("  quantize_kernel<T><<<passes, PASS_THREADS, smem_q, stream>>>(xp, ap, bp, ym, qp, C, H, W, "
               "f, HP, WP);\n")
K7_CONV = ("  conv_kernel<T><<<items < sms ? items : sms, CONV_THREADS, ConvLayout<T>::SMEM, stream>>>(\n"
           "      qp, static_cast<const int8_t*>(wp), static_cast<const float*>(sw), ym, "
           "static_cast<T*>(out),\n      B, C, H, W, HP, WP);\n")
K7_PASSES = [(K7_MAX, ""), (K7_QUANTISE, "")]
K7_NO_WEIGHTS = [_zero("      for (int sl = 0; sl < nslices; ++sl) {"),
                 ("      agl::mbar_wait_in_asm(full(wst), wph);\n", "")]
K7_NO_MAPS = [_zero("      for (int c = 0; c < nch; ++c) {"),
              ("        agl::mbar_wait_in_asm(mfull(rst), rph);\n", "")]
K7_WGMMA = "        agl::wgmma_m64n256k32_s8(acc, da, db, sl | j);\n"
# the bf16 epilogue's stores to device memory predicated off by a test that
# reads the sums through the tile, which keeps the products
K7_STORE = "        if (co < C && y0 + row < H && x0 + 8 * h < W)\n"
K7_NO_STORES = [(K7_STORE, "        if (co < C && y0 + row < H && x0 + 8 * h < W && tile[cl] == 0x7f)\n")]
# ---- of csrc/spade_apply.cu (k4: the compact-table kernel; k4t: the flat-table one)
K4_NO_STAGING = [_zero("  for (int i = threadIdx.x; i < tsize; i += THREADS) {")]
# a store kept under a condition that no relu output meets (two negative
# NaNs in bf16, one in f32), so that ptxas keeps the loads and the math
K4_NO_STORES = [("    *reinterpret_cast<uint4*>(out + base) = v.raw;\n",
                 "    if (v.raw.x == 0xffffffffu) *reinterpret_cast<uint4*>(out + base) = v.raw;\n")]
K4T_LD = ("__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const "
          "uint4*>(p); }\n")
K4T_ST = "__device__ __forceinline__ void st16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }\n"
# the five row classes' table vectors at one address: one load of each table
K4T_ONE_TABLE = [("  const size_t ts = (size_t)C * W;  // one row class to the next\n",
                  "  const size_t ts = 0;  // one row class to the next\n")]
K4T_NO_STORES = [(K4T_ST, K4T_ST.replace("*reinterpret_cast", "if (v.x == 0xffffffffu) *reinterpret_cast"))]
K4T_HINTS = [(K4T_LD, K4T_LD.replace("*reinterpret_cast<const uint4*>(p)",
                                     "__ldcs(reinterpret_cast<const uint4*>(p))")),
             (K4T_ST, K4T_ST.replace("*reinterpret_cast<uint4*>(p) = v", "__stcs(reinterpret_cast<uint4*>(p), v)"))]
# ---- of the parent's csrc/conv_small_int8.cu (k6_mma_sync, with --csrc)
K6_OLD_CONV = ("  conv_kernel<T><<<dim3(Cout / BN, (B + IM - 1) / IM), THREADS, smem, stream>>>(\n"
               "      qp, static_cast<const int8_t*>(wq), static_cast<const float*>(sw), am,\n"
               "      static_cast<T*>(out), B, Cp, Cout, k, gb);\n")
K6_OLD_QUANTISE = [
    ("  absmax_kernel<T><<<dim3(splits, chunks), THREADS, 0, stream>>>(static_cast<const T*>(x), am,\n"
     "                                                                per_chunk);\n", ""),
    ("  quantize_kernel<T><<<dim3(Cp / CK, B), THREADS, 0, stream>>>(static_cast<const T*>(x), am, qp,\n"
     "                                                              Cin, Cp, k, gb);\n", ""),
]

# kernel -> (the source cut, the source compiled (which includes the cut one,
# or is it), exported function, [(variant, [(old, new), ...]), ...])
VARIANTS = {
    "k1": ("residual_trunk.cu", "residual_trunk.cu", "residual_trunk_tc", [
        ("whole kernel", []),
        ("no weight copies", K1_NO_COPIES),
        ("no product", K1_NO_MMA),
        ("no epilogues (the products summed into one register)", K1_NO_EPILOGUES),
        ("product only (no copies, no epilogues)", K1_NO_COPIES + K1_NO_EPILOGUES),
        ("weight copies only (no product, no epilogues)", K1_NO_MMA + K1_NO_EPILOGUES),
    ]),
    "k2": ("spade_head_tc.cuh", "spade_few_out_conv.cu", "spade_few_out_conv_tc", HEAD_CUTS),
    "k2t": ("spade_head_tc.cuh", "spade_few_out_conv.cu", "spade_few_out_conv_tc", K2T_CUTS),
    "k3": ("spade_head_tc.cuh", "spade_few_out_conv8.cu", "spade_few_out_conv8", HEAD_CUTS),
    "k5": ("typed_c3_expand.cu", "typed_c3_expand.cu", "typed_c3_expand", K5_CUTS),
    # the v6 schedule of the same kernel: the same lines, its own instantiation
    "k5v6": ("typed_c3_expand.cu", "typed_c3_expand.cu", "typed_c3_expand_v6", K5_CUTS),
    # v3 on the zero-padded grid: K5's kernel, K5's lines
    "k5v3": ("typed_c3_expand.cu", "typed_c3_expand.cu", "typed_c3_expand_v3", K5_CUTS),
    "k6": ("conv_small_int8.cu", "conv_small_int8.cu", "conv_small_int8", [
        ("whole call", []),
        ("the two quantise passes only", [(K6_CONV, "")]),
        ("the product kernel only (no quantise passes)", K6_QUANTISE),
        ("product only (no copies, no quantise passes)", K6_NO_COPIES + K6_QUANTISE),
        ("weight copies only (no product, no map copies, no quantise passes)",
         K6_MAPS + [(K6_WGMMA, "")] + K6_QUANTISE),
        ("no map copies (no quantise passes)", K6_MAPS + K6_QUANTISE),
        ("the product kernel with mbar_wait and a lane test (no quantise passes)",
         K6_PLAIN_BARRIERS + K6_QUANTISE),
    ]),
    # v5 launches K5's kernel as it is (ops/typed_expand.typed_c3_expand_v5):
    # its cuts are K5's, named for the pair with the kernel it replaced
    "k5v5": ("typed_c3_expand.cu", "typed_c3_expand.cu", "typed_c3_expand", K5_CUTS),
    "k7": ("spade_c6_int8.cu", "spade_c6_int8.cu", "spade_c6_int8", [
        ("whole call", []),
        ("max pass only", [(K7_QUANTISE, ""), (K7_CONV, "")]),
        ("apply and quantise pass only", [(K7_MAX, ""), (K7_CONV, "")]),
        ("the product kernel only (no max, no quantise pass)", K7_PASSES),
        ("product only (no weight or map copies, no passes)", K7_NO_WEIGHTS + K7_NO_MAPS + K7_PASSES),
        ("no weight copies (map copies, no passes)", K7_NO_WEIGHTS + K7_PASSES),
        ("weight copies only (no product, no map copies, no passes)",
         K7_NO_MAPS + [(K7_WGMMA, "")] + K7_PASSES),
        ("no output stores (no passes)", K7_NO_STORES + K7_PASSES),
        ("product only, no output stores (no copies, no passes)",
         K7_NO_WEIGHTS + K7_NO_MAPS + K7_NO_STORES + K7_PASSES),
    ]),
    "k4": ("spade_apply.cu", "spade_apply.cu", "spade_apply8", [
        ("whole kernel", []),
        ("no table staging", K4_NO_STAGING),
        ("no stores (a store under a never-true condition)", K4_NO_STORES),
    ]),
    "k4t": ("spade_apply.cu", "spade_apply.cu", "spade_apply_t", [
        ("whole kernel", []),
        ("tables from one load (one row class for all five)", K4T_ONE_TABLE),
        ("no stores (a store under a never-true condition)", K4T_NO_STORES),
        ("x loads only (tables from one load, no stores)", K4T_ONE_TABLE + K4T_NO_STORES),
        ("streaming cache hints (ld.global.cs, st.global.cs)", K4T_HINTS),
    ]),
    # the shared-memory kernel K4' had before its flat kernel (both tables
    # staged as f32, a CTA per image, row block and cb channels): in an
    # earlier csrc/ only (EARLIER)
    "k4t_smem": ("spade_apply.cu", "spade_apply.cu", "spade_apply_t", [("whole kernel", [])]),
    # the bf16 kernels K1, K2, K3 and K5 replaced, from a checkout that has
    # them (--csrc): the FMA kernels of K1 and K2 still ship for f32 and the
    # shapes the tensor cores do not take, but no longer run in bf16 at these
    "k1_fma": ("residual_trunk.cu", "residual_trunk.cu", "residual_trunk", [
        ("whole kernel", []),
        ("no weight copies", [("    load_weights(ws, w1 + (size_t)r * 9 * C * C, 9 * C * C);\n", ""),
                              ("    load_weights(ws, w2 + (size_t)r * 9 * C * C, 9 * C * C);\n", "")]),
        ("no FMAs", [_zero("  for (int cin = 0; cin < C; ++cin) {")]),
    ]),
    "k2_fma": ("spade_few_out_conv.cu", "spade_few_out_conv.cu", "spade_few_out_conv", [
        ("whole kernel", []),
        ("load + apply only (no FMAs)", [_zero("      for (int c = 0; c < cc; ++c) {")]),
        ("FMAs only (no load, no apply)", [
            _zero("    for (int i = tid; i < cc * K * K; i += THREADS)"),
            _zero("      for (int cr = warp; cr < cc * TH; cr += nwarps) {")]),
    ]),
    # K2t's FMA kernel (mode 2), which ran it in bf16 before the tensor cores did
    "k2t_fma": ("spade_few_out_conv.cu", "spade_few_out_conv.cu", "spade_few_out_conv", [
        ("whole kernel", []),
        ("load + apply only (no FMAs)", [_zero("      for (int c = 0; c < cc; ++c) {")]),
        ("FMAs only (no load, no apply)", [
            _zero("    for (int i = tid; i < cc * K * K; i += THREADS)"),
            _zero("      for (int i = tid; i < nv * TH * TW; i += THREADS) {")]),
    ]),
    "k3_fma": ("spade_few_out_conv8.cu", "spade_few_out_conv8.cu", "spade_few_out_conv8", [
        ("whole kernel", []),
        ("load + apply only (no FMAs)", [_zero("    for (int c = 0; c < cc; ++c) {")]),
        ("FMAs only (no load, no apply)", [
            _zero("    for (int i = tid; i < cc * K * K; i += THREADS)"),
            _zero("    for (int cr = warp; cr < cc * TH; cr += nwarps) {")]),
    ]),
    # the mma.sync kernel K6 replaced: in an earlier csrc/ only (EARLIER)
    "k6_mma_sync": ("conv_small_int8.cu", "conv_small_int8.cu", "conv_small_int8", [
        ("whole call", []),
        ("the two quantise passes only", [(K6_OLD_CONV, "")]),
        ("the product kernel only (no quantise passes)", K6_OLD_QUANTISE),
    ]),
    # the two-stage v5 kernel (W3z through a device scratch) K5-v5's move
    # onto K5's kernel replaced, and the mma.sync K7 the wgmma one replaced:
    # in an earlier csrc/ only (EARLIER)
    "k5v5_scratch": ("typed_c3_expand_v5.cu", "typed_c3_expand_v5.cu", "typed_c3_expand_v5",
                     [("whole kernel", [])]),
    "k7_mma_sync": ("spade_c6_int8.cu", "spade_c6_int8.cu", "spade_c6_int8", [("whole call", [])]),
    # the v3 kernel (a group of objects a block, one weight chunk, mma.sync)
    # that v3's move onto K5's kernel replaced: in an earlier csrc/ only (EARLIER)
    "k5v3_group": ("typed_c3_expand_v3.cu", "typed_c3_expand_v3.cu", "typed_c3_expand_v3",
                   [("whole kernel", [])]),
    # the v6 kernel K5-v6 replaced: its source is gone from this csrc/ (EARLIER)
    "k5v6_serial": ("typed_c3_expand_v6.cu", "typed_c3_expand_v6.cu", "typed_c3_expand_v6",
                    [("whole kernel", [])]),
    "k5_serial": ("typed_c3_expand.cu", "typed_c3_expand.cu", "typed_c3_expand", [
        ("whole kernel", []),
        ("no weight copy", [("    load_w3<CC>(wk, bs, c0, c2);\n", "")]),
        ("no product", [("    chunk_product<NZ>(zs, bs, ws, zrow0, c2, ZROW);\n", "")]),
        ("no V3 sums", [("    v3_from_w3z<T, NZ>(ws, lsl, a3 + c0, b3 + c0, v3, CC);\n", "")]),
        ("no output stores", [
            ("    expand_store(v3, sr, sc, out + ((size_t)obj * c4 + c0) * s3 * s3, CC, s3);\n", "")]),
    ]),
}


# the kernels whose lines are only in an earlier csrc/ (run with --csrc), and
# the C signature of that generation of the source
EARLIER = {"k6_mma_sync": [build._P] * 6 + [build._I] * 7 + [build._P],
           "k5v6_serial": build.SIGNATURES["typed_c3_expand_v6"],
           "k5v5_scratch": [build._P] * 9 + [build._I] * 5 + [build._P],
           "k7_mma_sync": [build._P] * 7 + [build._I] * 7 + [build._P],
           "k5v3_group": [build._P] * 8 + [build._I] * 6 + [build._P],
           "k4t_smem": [build._P] * 4 + [build._I] * 7 + [build._P]}
V3_GROUP = 8  # the objects a block of k5v3_group took (its wrapper's default)
# hand-written launches a call of the whole kernel, where more than one
LAUNCHES = {"k6": 3, "k6_mma_sync": 3, "k5v5_scratch": 2, "k7": 3, "k7_mma_sync": 2}


def patched(text: str, repl, what: str) -> str:
    """`text` with every (old, new) of `repl` applied; raises where an old
    line is not there."""
    for old, new in repl:
        if old not in text:
            raise ValueError(f"{what}: the source no longer has the line {old!r}")
        text = text.replace(old, new)
    return text


def start_variant(csrc: Path, cut: str, compiled: str, tag: str, repl):
    """Start compiling `compiled` of a copy of `csrc` whose `cut` has `repl`
    applied; returns the nvcc process and the library it writes."""
    work = ROOT / tag
    if work.exists():
        shutil.rmtree(work)
    shutil.copytree(csrc, work)
    (work / cut).write_text(patched((work / cut).read_text(), repl, tag))
    lib = work / "variant.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(work / compiled)]
    return subprocess.Popen(cmd), lib


def _operands(kernel: str, box: bool = False):
    """The kernel's arguments at the shape the 128^2 serving path gives it
    (the c4 head and the trunk as at 64^2), as the C function of that
    generation of the source takes them (tensors kept alive by the caller);
    with `box` the typed kernels' inputs are those the 128^2 path makes from
    the serving bench's layouts."""
    import torch

    import chip_smoke as cs
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.ops import resblocks, spade_conv, typed_expand

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    model = build_generator(config_for(128, batch_size=cs.B, max_objects=cs.O, bf16=True), "cuda", seed=0)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.no_grad():
        if kernel.startswith("k1"):
            h, w1, w2, ab1, ab2 = cs.trunk_inputs(dt, gen, dev)
            b, c, r = h.shape[0], h.shape[1], w1.shape[0]
            out = torch.empty((b, c, 8, 8), dtype=torch.float32, device=dev)
            if kernel == "k1_fma":
                wm1, wm2 = (w.to(dt).permute(0, 3, 4, 2, 1).contiguous() for w in (w1, w2))
                keep, tail = (h, wm1, wm2, ab1, ab2, out), (b, c, r, 1, stream)
            else:
                keep = (h, resblocks.pack_trunk_weights(w1, w2, dt), ab1, ab2, out)
                tail = (b, c, r, stream)
        elif kernel.startswith(("k2", "k3")):
            transposed = kernel.startswith("k2t")
            f = 8 if kernel.startswith("k2") and not transposed else 16
            if f == 8:  # the c4 head, flat tables
                x, a_tab, b_tab = cs.table_inputs(model.decoder.spade_3, 64, 64, False, dt, gen, dev)
                weight, bias = model.decoder.c4.weight, model.decoder.c4.bias
            else:  # the c7 head's shape: compact tables, or flat under an (H, W, B, C) x
                x, a_tab, b_tab, weight, bias = cs.head_inputs(
                    model.decoder, "transposed" if transposed else "compact", dt, gen, dev)
            h, w, b, c = x.shape if transposed else (*x.shape[2:], *x.shape[:2])
            o, _, k, _ = weight.shape
            out = torch.empty((b, o, h, w), dtype=dt, device=dev)
            if kernel.endswith("_fma"):
                wk, bk = spade_conv._padded_weights(weight, bias, dt)
            else:
                wk, bk = spade_conv.pack_head8_weights(weight, dt), spade_conv._padded_bias(bias, o, dev)
            keep = (x, a_tab, b_tab, wk, bk, out)
            if kernel in ("k2_fma", "k2t_fma"):
                tile = spade_conv._pick_tile(c, h, w, k, 2, 8 if transposed else 1)
                tail = (b, c, h, w, k, o, f, *tile, 2 if transposed else 0, 1, stream)
            elif kernel in ("k2", "k2t"):
                tail = (b, c, h, w, k, o, f, 2 if transposed else 0, stream)
            else:
                tail = (b, c, h, w, k, o, f, spade_conv._channel_chunk(c) if kernel == "k3_fma" else 0,
                        1, stream)
        elif kernel.startswith("k4"):  # SPADE-4's apply, compact (k4) or flat tables
            x, a_tab, b_tab = cs.table_inputs(model.decoder.spade_4, 128, 128, kernel == "k4", dt,
                                              gen, dev)
            b, c, h, w = x.shape
            out = torch.empty_like(x)
            keep = (x, a_tab, b_tab, out)
            cb = [] if kernel == "k4t" else [spade_conv._channel_chunk(c)]  # the CTA's channels
            tail = (b, c, h, w, 16, *cb, 1, stream)
        elif kernel.startswith("k6"):
            import torch.nn.functional as F

            from aglayout_tpu_torch.ops import conv8_int8
            from aglayout_tpu_torch.ops.int8 import quantize_conv_weights

            cell = model.layout_encoder.clstm.cell_list[0]  # 640 -> 512, 5 x 5
            x = torch.randn(cs.B, cell.conv.in_channels, 8, 8, generator=gen).to(dev, dt)
            wq, sw = quantize_conv_weights(cell.conv.weight)
            b, cin, cout, k, gb = x.shape[0], x.shape[1], wq.shape[0], wq.shape[1], 16
            cp, p = -(-cin // 32) * 32, 8 + k - 1
            amax = torch.zeros(b // gb, dtype=torch.int32, device=dev)
            q = torch.empty(-(-b // 8) * 8 * p * p * cp, dtype=torch.int8, device=dev)
            out = torch.empty((b, cout, 8, 8), dtype=dt, device=dev)
            if kernel == "k6_mma_sync":
                keep = (x, F.pad(wq, (0, cp - cin)).contiguous(), sw, amax, q, out)
                tail = (b, cin, cp, cout, k, gb, 1, stream)
            else:
                keep = (x, conv8_int8.pack_conv_small_int8_weights(wq), sw, amax, q, out)
                tail = (b, cin, cout, k, gb, 1, stream)
        elif kernel.startswith("k7"):
            from aglayout_tpu_torch.ops import conv8_int8, spade_c6_int8

            x, a_tab, b_tab, wq, sw = cs.c6_inputs(model.decoder, dt, gen, dev)
            b, c, h, w = x.shape
            ymax = torch.zeros(b, dtype=torch.int32, device=dev)
            out = torch.empty_like(x)
            if kernel == "k7_mma_sync":
                keep = (x, a_tab, b_tab, wq, sw, ymax, out)
            else:
                q = torch.empty((b, c // 16, *spade_c6_int8.padded_hw(h, w), 16), dtype=torch.int8,
                                device=dev)
                keep = (x, a_tab, b_tab, conv8_int8.pack_conv_small_int8_weights(wq), sw, ymax, q, out)
            tail = (b, c, h, w, 16, *([16] if kernel == "k7_mma_sync" else []), 1, stream)
        else:
            inputs = cs.box_typed_inputs(model) if box else cs.typed_inputs(model, dt, gen, dev)
            if kernel.startswith("k5v3"):  # the grid zero-padded to 13 x 13
                inputs = (cs.padded_grid(inputs[0]), *inputs[1:])
            z2, idxR, lsel, selR, selC, ab, weight = inputs
            n, c2, c4, s3 = z2.shape[0], z2.shape[-1], weight.shape[0], selR.shape[-1]
            out = torch.empty((n, c4, s3, s3), dtype=dt, device=dev)
            if kernel == "k5v5_scratch":  # (w, C, h, c) weights and the W3z scratch
                wk = weight.to(dt).permute(3, 0, 2, 1).contiguous()
                w3z = torch.empty(n * 14 * 12 * 4 * c4, dtype=dt, device=dev)
                keep = (z2, idxR, lsel, selR, selC, ab, wk, w3z, out)
            else:
                wk = (weight.to(dt).permute(0, 3, 2, 1).contiguous()
                      if kernel.endswith(("_serial", "_group"))
                      else typed_expand.pack_typed_c3_weights(weight, dt))
                keep = (z2, idxR, lsel, selR, selC, ab, wk, out)
            tail = (n, c2, c4, s3, *([V3_GROUP] if kernel == "k5v3_group" else []), 1, stream)
    return keep, (*(t.data_ptr() for t in keep), *tail)


def run(kernel: str, csrc: Path, whole: bool = False, box: bool = False) -> dict:
    """Time every variant of `kernel` (the whole kernel alone with `whole`);
    returns {variant: (ms, ms)}, for the whole kernel (ms, ms, device ms),
    and with `box`, for a typed kernel, the whole kernel's on the
    box-derived inputs too."""
    import torch

    import chip_smoke as cs

    cut, compiled, fn_name, variants = VARIANTS[kernel]
    variants = variants[:1] if whole else variants
    # every variant's nvcc at once, as the build does
    builds = [start_variant(csrc, cut, compiled, f"{kernel}_{i}", repl)
              for i, (_, repl) in enumerate(variants)]
    for proc, _ in builds:
        if proc.wait() != 0:
            raise RuntimeError(f"stage_times: a {kernel} variant failed to compile")
    labels = [""] + ([", box-derived inputs"] if box and kernel.startswith("k5") else [])
    operands = {label: _operands(kernel, bool(label)) for label in labels}  # label -> (keep, args)
    times = {}
    for i, ((name, _), (_, lib)) in enumerate(zip(variants, builds)):
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        sig = EARLIER[kernel] if kernel in EARLIER else build.SIGNATURES[fn_name]
        fn.argtypes, fn.restype = sig, ctypes.c_int
        for label in labels[:1 if i else None]:  # the cuts on the random inputs only
            keep, args = operands[label]

            def call():
                build.check(fn(*args), f"{kernel} variant {name!r}")

            call()
            torch.cuda.synchronize()
            # the whole kernel's output bits, to hold against another csrc/'s
            digest = hashlib.sha256(keep[-1].view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
            t = (cs.cuda_ms(call), cs.cuda_ms(call))
            line = f"[stage_times] {kernel}: {name}{label}: {t[0]:.4f} {t[1]:.4f} ms"
            if i == 0:  # the whole kernel, uncut
                t += (cs.device_ms(call, LAUNCHES.get(kernel, 1), csrcs=(csrc,)),)
                line += f"; on the device {t[2]:.4f} ms; output sha256 {digest}"
            times[name + label] = t
            print(line, flush=True)
    del operands
    return times


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--csrc", type=Path, default=build.CSRC,
                    help="the csrc/ directory to cut (default: this package's)")
    ap.add_argument("--whole", action="store_true", help="the whole kernel alone, no cuts")
    ap.add_argument("--box", action="store_true",
                    help="also time the typed kernels on the inputs the 128^2 path makes from "
                         "the bench's layouts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: needs a CUDA card")
    earlier = sorted(set(args.kernels) & set(EARLIER))
    if earlier and args.csrc == build.CSRC:
        raise SystemExit(f"stage_times: {earlier} need --csrc of a checkout that has them")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[stage_times] {smi}; B=128, O=10, bf16; CUDA events, 20 launches, twice; "
          f"csrc {args.csrc}", flush=True)
    for kernel in args.kernels:
        run(kernel, args.csrc, args.whole, args.box)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
