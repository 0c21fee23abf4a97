"""Where the time of the tensor-core kernels goes: the residual trunk (K1),
the RGB heads (K2 at the c4 head, K3 at the c7 head) and the typed c3
expansion (K5), as one-off variants of a kernel with a stage cut out, timed
on the card.

    python3 -m aglayout_tpu_torch.stage_times k1 k2 k3 k5
    python3 -m aglayout_tpu_torch.stage_times --csrc <an earlier csrc/> k1_fma k2_fma k3_fma k5_serial

Needs one CUDA card and `nvcc`. Each variant is the shipped source with a
few lines replaced (a call removed, a loop bound set to 0), copied with the
rest of `csrc/` under `build/stage_times/` (listed in `.gitignore`),
compiled on its own and called at the shape the 128^2 serving path gives
the kernel (B = 128, O = 10, bf16). A variant computes a wrong result; only
its time is read (CUDA events over 20 launches, twice). The shipped kernels
have no switch for any of this. `VARIANTS` names the replaced lines:
`tests/test_torch_port_redesign.py` holds them against the sources, so an
edit that moves a line shows there and not on the card.

`k1` cuts the tensor-core kernel of `csrc/residual_trunk.cu`; `k2` and `k3`
the one of `csrc/spade_head_tc.cuh`, as `csrc/spade_few_out_conv.cu` builds
it for the c4 head's flat tables and `csrc/spade_few_out_conv8.cu` for the
c7 head's compact ones; `k5` the one of `csrc/typed_c3_expand.cu`. `k1_fma`,
`k2_fma`, `k3_fma` and `k5_serial` cut the bf16 kernels those replaced (FMAs
on the CUDA cores; one block an object, its stages one after the other),
read with `--csrc` from a checkout that has them.
"""

from __future__ import annotations

import argparse
import ctypes
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
K5_V3 = "      for (int i0 = et; i0 < ITEMS; i0 += 2 * ET) {"
K5_TYPES = "      for (int j = et / xv; j < CC * V3A; j += rstep * U) {"
K5_PIECES = "      for (int c0 = 0; c0 < CC; c0 += sch, ++piece) {"
K5_FILL = "        for (int row = c0 * s3 + et / xv; row < (c0 + sch) * s3; row += rstep * U) {"
K5_WGMMA = ("            wgmma_m64n128k16(acc, cur[kk], wgmma_desc_sw128(bbase + kk * 32), "
            "(sl | kk) != 0);\n")
K5_COPY = ("          agl::bulk_copy_s2g(out + ((size_t)obj * c4 + ch * CC + c0) * s3 * s3, "
           "agl::smem_u32(plane),\n                             sch * s3 * s3 * 2);\n")

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
    "k3": ("spade_head_tc.cuh", "spade_few_out_conv8.cu", "spade_few_out_conv8", HEAD_CUTS),
    "k5": ("typed_c3_expand.cu", "typed_c3_expand.cu", "typed_c3_expand", [
        ("whole kernel", []),
        ("no V3 sums", [_zero(K5_V3)]),
        ("no row types, no output (V3 only)", [_zero(K5_TYPES), _zero(K5_PIECES)]),
        ("no output rows (V3 and row types)", [_zero(K5_FILL)]),
        ("no copy to device memory", [(K5_COPY, "")]),
        ("no epilogue work (product only)", [_zero(K5_V3), _zero(K5_TYPES), _zero(K5_PIECES)]),
        ("no product (epilogue only)", [(K5_WGMMA, "")]),
    ]),
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
    "k3_fma": ("spade_few_out_conv8.cu", "spade_few_out_conv8.cu", "spade_few_out_conv8", [
        ("whole kernel", []),
        ("load + apply only (no FMAs)", [_zero("    for (int c = 0; c < cc; ++c) {")]),
        ("FMAs only (no load, no apply)", [
            _zero("    for (int i = tid; i < cc * K * K; i += THREADS)"),
            _zero("    for (int cr = warp; cr < cc * TH; cr += nwarps) {")]),
    ]),
    "k5_serial": ("typed_c3_expand.cu", "typed_c3_expand.cu", "typed_c3_expand", [
        ("whole kernel", []),
        ("no weight copy", [("    load_w3<CC>(wk, bs, c0, c2);\n", "")]),
        ("no product", [("    chunk_product<NZ>(zs, bs, ws, zrow0, c2, ZROW);\n", "")]),
        ("no V3 sums", [("    v3_from_w3z<T, NZ>(ws, lsl, a3 + c0, b3 + c0, v3, CC);\n", "")]),
        ("no output stores", [
            ("    expand_store(v3, sr, sc, out + ((size_t)obj * c4 + c0) * s3 * s3, CC, s3);\n", "")]),
    ]),
}


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


def _operands(kernel: str):
    """The kernel's arguments at the shape the 128^2 serving path gives it
    (the c4 head and the trunk as at 64^2), as the C function of that
    generation of the source takes them (tensors kept alive by the caller)."""
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
            f = 8 if kernel.startswith("k2") else 16
            if f == 8:  # the c4 head, flat tables
                x, a_tab, b_tab = cs.table_inputs(model.decoder.spade_3, 64, 64, False, dt, gen, dev)
                weight, bias = model.decoder.c4.weight, model.decoder.c4.bias
            else:
                x, a_tab, b_tab, weight, bias = cs.head_inputs(model.decoder, "compact", dt, gen, dev)
            b, c, h, w = x.shape
            o, _, k, _ = weight.shape
            out = torch.empty((b, o, h, w), dtype=dt, device=dev)
            if kernel.endswith("_fma"):
                wk, bk = spade_conv._padded_weights(weight, bias, dt)
            else:
                wk, bk = spade_conv.pack_head8_weights(weight, dt), spade_conv._padded_bias(bias, o, dev)
            keep = (x, a_tab, b_tab, wk, bk, out)
            if kernel == "k2_fma":
                tail = (b, c, h, w, k, o, f, *spade_conv._pick_tile(c, h, w, k, 2), 0, 1, stream)
            elif kernel == "k2":
                tail = (b, c, h, w, k, o, f, 0, stream)
            else:
                tail = (b, c, h, w, k, o, f, spade_conv._channel_chunk(c) if kernel == "k3_fma" else 0,
                        1, stream)
        else:
            z2, idxR, lsel, selR, selC, ab, weight = cs.typed_inputs(model, dt, gen, dev)
            n, c2, c4, s3 = z2.shape[0], z2.shape[-1], weight.shape[0], selR.shape[-1]
            wk = (weight.to(dt).permute(0, 3, 2, 1).contiguous() if kernel == "k5_serial"
                  else typed_expand.pack_typed_c3_weights(weight, dt))
            out = torch.empty((n, c4, s3, s3), dtype=dt, device=dev)
            keep = (z2, idxR, lsel, selR, selC, ab, wk, out)
            tail = (n, c2, c4, s3, 1, stream)
    return keep, (*(t.data_ptr() for t in keep), *tail)


def run(kernel: str, csrc: Path) -> dict:
    """Time every variant of `kernel`; returns {variant: (ms, ms)}."""
    import torch

    import chip_smoke as cs

    cut, compiled, fn_name, variants = VARIANTS[kernel]
    # every variant's nvcc at once, as the build does
    builds = [start_variant(csrc, cut, compiled, f"{kernel}_{i}", repl)
              for i, (_, repl) in enumerate(variants)]
    for proc, _ in builds:
        if proc.wait() != 0:
            raise RuntimeError(f"stage_times: a {kernel} variant failed to compile")
    keep, args = _operands(kernel)
    times = {}
    for (name, _), (_, lib) in zip(variants, builds):
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        fn.argtypes, fn.restype = build.SIGNATURES[fn_name], ctypes.c_int

        def call():
            build.check(fn(*args), f"{kernel} variant {name!r}")

        call()
        torch.cuda.synchronize()
        times[name] = (cs.cuda_ms(call), cs.cuda_ms(call))
        print(f"[stage_times] {kernel}: {name}: {times[name][0]:.4f} {times[name][1]:.4f} ms", flush=True)
    del keep
    return times


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--csrc", type=Path, default=build.CSRC,
                    help="the csrc/ directory to cut (default: this package's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[stage_times] {smi}; B=128, O=10, bf16; CUDA events, 20 launches, twice", flush=True)
    for kernel in args.kernels:
        run(kernel, args.csrc)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
