"""Smoke run of the PyTorch port on one CUDA GPU: build, check, generate.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (`nvcc`) and this repository; it
imports nothing of JAX. Phases, each printed as it ends; any failure
raises, and the run then exits non-zero without printing a result:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile aglayout_tpu_torch/csrc/*.cu for sm_90a (timed);
  3. generate: the full-width 64^2 model (conv_dim=64, 3 ConvLSTM
     layers, 6 residual blocks, 179 classes, O=10, B=128, bf16, seeded
     weights) with the kernels on and off; both kernels must launch in the
     kernels-on run; outputs finite, agreeing, timed with CUDA events;
  4. kernels: each hand-written kernel against its plain PyTorch version,
     at the shapes of 64^2 generate with B=128, in bf16 and in f32 (TF32
     off), with the tolerance stated beside each; timed with CUDA events;
  5. reference: a small f32 generator on the card, kernels on, against
     the same model on the CPU, where it runs its plain path.
The last three lines are the kernel summary (JSON), the card's name and
power limit, and the result (JSON).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B, O = 128, 10  # serving batch and object slots (bench.py's)


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


def trunk_inputs(dtype, gen, dev):
    c, r = 64, 6
    h = torch.randn(B, c, 8, 8, generator=gen).to(dev, dtype)
    w1, w2 = (torch.randn(r, c, c, 3, 3, generator=gen).mul(1 / 24).to(dev) for _ in range(2))
    ab1, ab2 = (
        torch.stack([1 + 0.1 * torch.randn(r, c, generator=gen), 0.1 * torch.randn(r, c, generator=gen)], 1).to(dev)
        for _ in range(2)
    )
    return h, w1, w2, ab1, ab2


def head_inputs(model, dtype, gen, dev):
    spade, conv = model.decoder.spade_3, model.decoder.c4
    seg = torch.randn(B, 64, 8, 8, generator=gen).to(dev)
    a_tab, b_tab = spade.folded_affine_tables(seg, 8)
    x = torch.randn(B, 64, 64, 64, generator=gen).to(dev, dtype)
    return x, a_tab.to(dtype).contiguous(), b_tab.to(dtype).contiguous(), conv.weight, conv.bias


def phase_kernels(model):
    """Each kernel against its plain version; returns the bf16 rows."""
    from aglayout_tpu_torch.ops.resblocks import residual_trunk, residual_trunk_plain
    from aglayout_tpu_torch.ops.spade_conv import spade_few_out_conv, spade_few_out_conv_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    # tolerance on max|err| / max|plain|: f32 only differs in summation
    # order; in bf16 the intermediates are rounded to bf16 on both sides, so
    # an order difference can flip a rounding (one bf16 ulp is 2^-8).
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    kernels = [
        ("residual_trunk", residual_trunk, residual_trunk_plain,
         lambda dt: trunk_inputs(dt, gen, dev),
         "aglayout_tpu_torch/csrc/residual_trunk.cu", "aglayout_tpu/ops/pallas_resblocks.py:87"),
        ("spade_few_out_conv", lambda *a: spade_few_out_conv(*a, f=8),
         lambda *a: spade_few_out_conv_plain(*a, f=8),
         lambda dt: head_inputs(model, dt, gen, dev),
         "aglayout_tpu_torch/csrc/spade_few_out_conv.cu", "aglayout_tpu/ops/pallas_spade_conv.py:143"),
    ]
    rows = {}
    for name, kernel, plain, make, source, replaces in kernels:
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
                rows[name] = {"name": name, "route": "cuda", "source": source,
                              "replaces": replaces, "max_abs_err": err, "ms": ms,
                              "plain_ms": ms_plain}
    set_tf32(True)
    return rows


def phase_reference():
    """Small f32 generator: kernels on the card against the CPU plain path."""
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator

    set_tf32(False)
    cfg = config_for(64, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23)
    cpu = build_generator(cfg, "cpu", seed=1)
    gpu = build_generator(cfg, "cuda", seed=1)
    ins = layouts(cfg, 2, 4, seed=1, device="cpu")
    want = cpu.generate(*ins)
    got = gpu.generate(*(t.cuda() for t in ins)).cpu()
    err, rel = errors(got, want)
    log(f"[reference] conv_dim=16 f32, card vs CPU: max abs err {err:.3e}, rel {rel:.3e} (tol 1e-4)")
    set_tf32(True)
    if rel > 1e-4:  # f32 on both sides; only summation order differs
        raise AssertionError("the card's generate disagrees with the CPU reference")


def phase_generate(smi: str):
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch
    from aglayout_tpu_torch.ops.resblocks import residual_trunk
    from aglayout_tpu_torch.ops.spade_conv import spade_few_out_conv

    cfg = config_for(64, batch_size=B, max_objects=O, bf16=True)
    model = build_generator(cfg, "cuda", seed=0)
    ins = layouts(cfg, B, O, seed=0, device="cuda")
    counted = (residual_trunk, spade_few_out_conv)

    def switch(on: bool):
        model.layout_encoder.use_trunk_kernel = on
        model.decoder.use_head_kernel = on

    switch(True)
    for k in counted:
        k.launches = 0
    img_on = model.generate(*ins)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counted}
    switch(False)
    img_off = model.generate(*ins)
    torch.cuda.synchronize()
    if any(k.launches != launches[k.__name__] for k in counted):
        raise AssertionError("a kernel launched with its switch off")
    log(f"[generate] launches with the kernels on: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError("the main path did not run every kernel")
    for name, img in (("on", img_on), ("off", img_off)):
        if img.shape != (B, 64, 64, 3) or not torch.isfinite(img.float()).all():
            raise AssertionError(f"kernels-{name} output: shape {tuple(img.shape)} or non-finite")
    err, rel = errors(img_on, img_off)
    mean_rel = ((img_on.float() - img_off.float()).abs().mean() / img_off.float().abs().mean()).item()
    # bf16 on both sides; the kernels keep the trunk's skip chain in f32
    # (the dense blocks round it to bf16 after each block), so they differ
    # by bf16 roundings carried through the decoder
    log(f"[generate] kernels on vs off: max abs err {err:.3e}, rel {rel:.3e} (tol 5e-2), "
        f"mean rel {mean_rel:.3e} (tol 1e-2)")
    if rel > 5e-2 or mean_rel > 1e-2:
        raise AssertionError("generate with the kernels disagrees with the plain path")
    u8 = imagenet_deprocess_batch(img_on)
    log(f"[generate] deprocessed to {tuple(u8.shape)} {u8.dtype}, mean {u8.float().mean().item():.2f}")

    times = {}
    for on in (True, False, False, True, True, False):  # alternated: the card drifts
        switch(on)
        times.setdefault(on, []).append(cuda_ms(lambda: model.generate(*ins), iters=10))
    for on in (True, False):
        ms = sum(times[on]) / len(times[on])
        log(f"[generate] 64^2 B={B} bf16 kernels {'on' if on else 'off'}: {ms:.3f} ms/batch, "
            f"{B / ms * 1e3:.1f} img/s on {smi} (runs {times[on]})")
    switch(True)
    return model, launches


def main() -> int:
    smi = phase_device()
    phase_build()
    model, launches = phase_generate(smi)
    rows = phase_kernels(model)
    phase_reference()
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
