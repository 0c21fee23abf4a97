"""Smoke run of the PyTorch port on one CUDA GPU: build, check, generate.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (`nvcc`) and this repository; it
imports nothing of JAX. Phases, each printed as it ends; any failure
raises, and the run then exits non-zero without printing a result:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile aglayout_tpu_torch/csrc/*.cu for sm_90a (timed);
  3. generate 64^2: the full-width 64^2 model (conv_dim=64, 3 ConvLSTM
     layers, 6 residual blocks, 179 classes, O=10, B=128, bf16, seeded
     weights) with the kernels on and off; K1 and K2 must launch in the
     kernels-on run and none with them off; outputs finite, agreeing with
     each other and with the f32 model, timed with CUDA events;
  4. generate 128^2: the same at 128^2 (object_size 64), the slice's main
     path: all five kernels K1-K5 must launch with the kernels on, none
     off; the launch counts of this run are the ones reported;
  5. kernels: each hand-written kernel against its plain PyTorch version,
     at the shapes generate gives it with B=128, in bf16 and in f32 (TF32
     off), with the tolerance stated beside each; timed with CUDA events;
  6. reference: small f32 generators (64^2 and 128^2) on the card, kernels
     on, against the same models on the CPU, where they run their plain
     paths.
The last three lines are the kernel summary (JSON), the card's name and
power limit, and the result (JSON).
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

B, O = 128, 10  # serving batch and object slots (bench.py's)
# kernel name -> (source, the TPU kernel it replaces)
SOURCES = {
    "residual_trunk": ("aglayout_tpu_torch/csrc/residual_trunk.cu",
                       "aglayout_tpu/ops/pallas_resblocks.py:87"),
    "spade_few_out_conv": ("aglayout_tpu_torch/csrc/spade_few_out_conv.cu",
                           "aglayout_tpu/ops/pallas_spade_conv.py:143"),
    "spade_few_out_conv8": ("aglayout_tpu_torch/csrc/spade_few_out_conv8.cu",
                            "aglayout_tpu/ops/pallas_spade_conv.py:437"),
    "spade_apply8": ("aglayout_tpu_torch/csrc/spade_apply.cu",
                     "aglayout_tpu/ops/pallas_spade_conv.py:554"),
    "typed_c3_expand": ("aglayout_tpu_torch/csrc/typed_c3_expand.cu",
                        "aglayout_tpu/ops/pallas_typed_expand.py:346"),
}
SWITCHES = ("use_trunk_kernel", "use_head_kernel", "use_typed_kernel", "use_apply_kernel",
            "use_head8_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(got, want):
    """(max abs error, max abs error / max |want|), in f32."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def set_kernels(model, on: bool) -> None:
    """Every kernel switch of `model` on or off."""
    for owner in (model.layout_encoder, model.decoder):
        for name in SWITCHES:
            if hasattr(owner, name):
                setattr(owner, name, on)


def counted():
    """The five kernel wrappers, by name."""
    from aglayout_tpu_torch.ops.resblocks import residual_trunk
    from aglayout_tpu_torch.ops.spade_conv import spade_apply8, spade_few_out_conv, spade_few_out_conv8
    from aglayout_tpu_torch.ops.typed_expand import typed_c3_expand

    return {k.__name__: k for k in (residual_trunk, spade_few_out_conv, spade_few_out_conv8,
                                    spade_apply8, typed_c3_expand)}


def layouts(cfg, b: int, o: int, seed: int, device):
    """Seeded layouts as bench.py:119-126 makes them, plus z."""
    rng = np.random.RandomState(seed)
    objs = rng.randint(0, cfg.num_classes, (b, o))
    xy0 = rng.uniform(0, 0.6, (b, o, 2)).astype(np.float32)
    wh = rng.uniform(0.1, 0.4, (b, o, 2)).astype(np.float32)
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, 1.0)], -1)
    valid = np.ones((b, o), np.float32)
    attr = (rng.rand(b, o, cfg.attribute_dim) < 0.05).astype(np.float32)
    z = rng.randn(b, o, cfg.z_dim).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (objs, boxes, valid, z, attr)]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from aglayout_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.library()
    log(f"[build] {path.name} built and loaded in {time.perf_counter() - t0:.2f} s")


def phase_generate(size: int, expect, smi: str):
    """Full-width generate at `size` with the kernels on and off; the kernels
    in `expect` must launch with them on, none with them off. Returns the
    model and the kernels-on launch counts."""
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch

    cfg = config_for(size, batch_size=B, max_objects=O, bf16=True)
    model = build_generator(cfg, "cuda", seed=0)
    ins = layouts(cfg, B, O, seed=0, device="cuda")
    kernels = counted()
    switch = functools.partial(set_kernels, model)
    switch(True)
    for k in kernels.values():
        k.launches = 0
    img_on = model.generate(*ins)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    switch(False)
    img_off = model.generate(*ins)
    torch.cuda.synchronize()
    if any(k.launches != launches[name] for name, k in kernels.items()):
        raise AssertionError("a kernel launched with its switch off")
    log(f"[generate {size}] launches with the kernels on: {launches}")
    if min(launches[name] for name in expect) < 1:
        raise AssertionError(f"the {size}^2 path did not run every kernel of {expect}")
    for name, img in (("on", img_on), ("off", img_off)):
        if img.shape != (B, size, size, 3) or not torch.isfinite(img.float()).all():
            raise AssertionError(f"kernels-{name} output: shape {tuple(img.shape)} or non-finite")
    # The same weights in f32, kernels off, TF32 off: the reference both
    # bf16 paths are held against.
    set_tf32(False)
    ref = build_generator(config_for(size, batch_size=B, max_objects=O), "cuda", seed=0)
    set_kernels(ref, False)
    img_ref = ref.generate(*ins)
    set_tf32(True)
    del ref
    # bf16 on both sides; the kernels round at other places than the plain
    # path (the trunk keeps its skip chain in f32, SPADE-4 applies in f32
    # and rounds once where the dense SPADE rounds the normalized input and
    # 1 + gamma), and bf16 roundings carry through the decoder. At 128^2 the
    # image of these seeded weights is 2.4x smaller in mean (mean |img|
    # 0.017 against 0.041 at 64^2 on an H100), so the same roundings weigh
    # more: bf16 alone, kernels on or off, is 1.7e-2 in mean from the f32
    # model there, hence 3e-2.
    max_tol, mean_tol = 5e-2, (1e-2 if size == 64 else 3e-2)
    for label, got, want in (("on vs off", img_on, img_off), ("on vs f32", img_on, img_ref),
                             ("off vs f32", img_off, img_ref)):
        err, rel = errors(got, want)
        mean_rel = ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()
        log(f"[generate {size}] kernels {label}: max abs err {err:.3e}, rel {rel:.3e} "
            f"(tol {max_tol:.0e}), mean rel {mean_rel:.3e} (tol {mean_tol:.0e})")
        if rel > max_tol or mean_rel > mean_tol:
            raise AssertionError(f"generate {label} disagree")
    u8 = imagenet_deprocess_batch(img_on)
    log(f"[generate {size}] deprocessed to {tuple(u8.shape)} {u8.dtype}, "
        f"mean {u8.float().mean().item():.2f}")
    del img_on, img_off, img_ref, u8

    times = {}
    for on in (True, False, False, True, True, False):  # alternated: the card drifts
        switch(on)
        times.setdefault(on, []).append(cuda_ms(lambda: model.generate(*ins), iters=10))
    for on in (True, False):
        ms = sum(times[on]) / len(times[on])
        log(f"[generate {size}] {size}^2 B={B} bf16 kernels {'on' if on else 'off'}: "
            f"{ms:.3f} ms/batch, {B / ms * 1e3:.1f} img/s on {smi} (runs {times[on]})")
    switch(True)
    return model, launches


def trunk_inputs(dtype, gen, dev):
    c, r = 64, 6
    h = torch.randn(B, c, 8, 8, generator=gen).to(dev, dtype)
    w1, w2 = (torch.randn(r, c, c, 3, 3, generator=gen).mul(1 / 24).to(dev) for _ in range(2))
    ab1, ab2 = (
        torch.stack([1 + 0.1 * torch.randn(r, c, generator=gen), 0.1 * torch.randn(r, c, generator=gen)], 1).to(dev)
        for _ in range(2)
    )
    return h, w1, w2, ab1, ab2


def table_inputs(spade, c: int, size: int, compact: bool, dtype, gen, dev):
    """x (B, c, size, size) and SPADE tables of `spade` from a random segmap."""
    seg = torch.randn(B, 64, 8, 8, generator=gen).to(dev)
    if compact:
        a_tab, b_tab = spade.folded_affine_tables_compact(seg)
    else:
        a_tab, b_tab = spade.folded_affine_tables(seg, size // 8)
    x = torch.randn(B, c, size, size, generator=gen).to(dev, dtype)
    return x, a_tab.to(dtype).contiguous(), b_tab.to(dtype).contiguous()


def typed_inputs(model, dtype, gen, dev):
    """Random inputs over the typed kernel's whole domain (as
    tests/test_pallas_typed_expand.py makes them) at 128^2, B=128, O=10."""
    n, c2, s3 = B * O, 128, 32
    i32 = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(dev)  # noqa: E731
    z2 = torch.randn(n, 12, 12, c2, generator=gen).to(dev, dtype)
    ab = torch.randn(n, 2, 256, generator=gen).mul(0.5).to(dev)
    return (z2, i32(13, (n, 14, 4)), i32(14, (n, 14, 4)), i32(14, (n, s3)), i32(14, (n, s3)), ab,
            model.layout_encoder.c3.weight)


def phase_kernels(model64, model128):
    """Each kernel against its plain version; returns the bf16 rows."""
    from aglayout_tpu_torch.ops.resblocks import residual_trunk_plain
    from aglayout_tpu_torch.ops.spade_conv import (
        spade_apply8_plain,
        spade_few_out_conv8_plain,
        spade_few_out_conv_plain,
    )
    from aglayout_tpu_torch.ops.typed_expand import typed_c3_expand_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    k = counted()
    dec64, dec128 = model64.decoder, model128.decoder
    # tolerance on max|err| / max|plain|: f32 only differs in summation
    # order; in bf16 the intermediates are rounded to bf16 on both sides, so
    # an order difference can flip a rounding (one bf16 ulp is 2^-8).
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    cases = [  # name, plain version, the upscale factor f the call takes, inputs by dtype
        ("residual_trunk", residual_trunk_plain, None, lambda dt: trunk_inputs(dt, gen, dev)),
        ("spade_few_out_conv", spade_few_out_conv_plain, 8,
         lambda dt: (*table_inputs(dec64.spade_3, 64, 64, False, dt, gen, dev),
                     dec64.c4.weight, dec64.c4.bias)),
        ("spade_few_out_conv8", spade_few_out_conv8_plain, 16,
         lambda dt: (*table_inputs(dec128.spade_5, 128, 128, True, dt, gen, dev),
                     dec128.c7.weight, dec128.c7.bias)),
        ("spade_apply8", spade_apply8_plain, 16,
         lambda dt: table_inputs(dec128.spade_4, 128, 128, True, dt, gen, dev)),
        ("typed_c3_expand", typed_c3_expand_plain, None,
         lambda dt: typed_inputs(model128, dt, gen, dev)),
    ]
    rows = {}
    for name, plain, f, make in cases:
        kw = {} if f is None else {"f": f}
        kernel, plain = functools.partial(k[name], **kw), functools.partial(plain, **kw)
        for dt in (torch.bfloat16, torch.float32):
            set_tf32(dt != torch.float32)
            with torch.no_grad():
                args = make(dt)
                got, want = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                err, rel = errors(got, want)
                ms_plain_a = cuda_ms(lambda: plain(*args))
                ms_a = cuda_ms(lambda: kernel(*args))
                ms_b = cuda_ms(lambda: kernel(*args))
                ms_plain_b = cuda_ms(lambda: plain(*args))
            ms, ms_plain = (ms_a + ms_b) / 2, (ms_plain_a + ms_plain_b) / 2
            log(f"[kernel] {name} {str(dt)[6:]}: shape {tuple(got.shape)}, max abs err {err:.3e}, "
                f"rel {rel:.3e} (tol {tol[dt]:.0e}); kernel {ms:.4f} ms, plain {ms_plain:.4f} ms "
                f"(runs {ms_a:.4f}/{ms_b:.4f} vs {ms_plain_a:.4f}/{ms_plain_b:.4f})")
            if not torch.isfinite(got.float()).all() or rel > tol[dt]:
                raise AssertionError(f"{name} {dt}: kernel disagrees with its plain version")
            if dt == torch.bfloat16:
                source, replaces = SOURCES[name]
                rows[name] = {"name": name, "route": "cuda", "source": source,
                              "replaces": replaces, "max_abs_err": err, "ms": ms,
                              "plain_ms": ms_plain}
            del args, got, want
    set_tf32(True)
    return rows


def phase_reference(size: int, expect):
    """Small f32 generator: kernels on the card against the CPU plain path;
    the kernels in `expect` must launch."""
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator

    set_tf32(False)
    cfg = config_for(size, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23)
    cpu = build_generator(cfg, "cpu", seed=1)
    gpu = build_generator(cfg, "cuda", seed=1)
    ins = layouts(cfg, 2, 4, seed=1, device="cpu")
    kernels = counted()
    before = {name: k.launches for name, k in kernels.items()}
    want = cpu.generate(*ins)
    got = gpu.generate(*(t.cuda() for t in ins)).cpu()
    ran = sorted(name for name, k in kernels.items() if k.launches > before[name])
    err, rel = errors(got, want)
    log(f"[reference {size}] conv_dim=16 f32, card vs CPU: max abs err {err:.3e}, rel {rel:.3e} "
        f"(tol 1e-4); kernels launched: {ran}")
    set_tf32(True)
    if rel > 1e-4:  # f32 on both sides; only summation order differs
        raise AssertionError(f"the card's {size}^2 generate disagrees with the CPU reference")
    if set(expect) - set(ran):
        raise AssertionError(f"the {size}^2 reference run did not launch {set(expect) - set(ran)}")


def main() -> int:
    smi = phase_device()
    phase_build()
    path64 = ("residual_trunk", "spade_few_out_conv")
    model64, _ = phase_generate(64, path64, smi)
    model128, launches = phase_generate(128, tuple(SOURCES), smi)
    rows = phase_kernels(model64, model128)
    phase_reference(64, path64)
    phase_reference(128, tuple(SOURCES))
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
