"""Where a serving batch spends its time, stage by stage and kernel by
kernel, on one CUDA card:

    python3 -m aglayout_tpu_torch.profile_generate [--image_size 64|128] [--off] [--batches 5]
        [--int8] [--typed_c3 v4|v5|v6]

The full-width generator (128^2 by default; B = 128, O = 10, bf16, seeded
weights, the serving bench's layouts), the hand-written kernels on (or,
with `--off`, their plain versions), in the default configuration or the
serving bench's `--int8` (`Config.int8_serving`: the wide ConvLSTM gate
conv through K6) and `--typed_c3` (the typed c3 kernel) ones. Two passes
over `--batches` batches after warm-up:

  * staged: every stage of `STAGES` that the model runs is wrapped so that
    the device is idle when it starts and is waited for when it ends; CUDA
    events give its device time, the host clock its host time. The stages
    do not overlap, so their sum is more than a batch takes when it runs
    freely;
  * free-running under `torch.profiler`: kernel launches per batch, the
    device's busy time per batch (the sum of its kernels' times), the batch
    time by CUDA events, and the kernels that take most of it, by name.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

# stage -> (owner attribute path from the generator, method)
STAGES = (
    ("AttributeEncoder", "attribute_encoder", "forward"),
    ("LayoutEncoder stage 1 on boxes (64^2)", "layout_encoder", "_fused_stage1"),
    ("LayoutEncoder typed c2/c3 (+K5)", "layout_encoder", "_typed_c2c3_eval"),
    ("LayoutEncoder c4 fold + bn4", "layout_encoder", "_c4_fold"),
    ("ConvLSTM (+K6 under --int8)", "layout_encoder.clstm", "forward"),
    ("residual trunk (K1)", "layout_encoder", "_trunk"),
    ("GlobalEncoder", "global_encoder", "forward"),
    ("c4 head (SPADE-3 tables + K2)", "decoder", "_head"),
    ("c5", "decoder.c5", "forward"),
    ("SPADE-4 tables + K4", "decoder", "_spade_relu"),
    ("c6", "decoder.c6", "forward"),
    ("c7 head (SPADE-5 tables + K3)", "decoder", "_head8"),
    ("Decoder, whole", "decoder", "forward"),
)


def _owner(model, path: str):
    for name in path.split("."):
        model = getattr(model, name)
    return model


def staged(model, ins, batches: int) -> dict:
    """{stage: (device ms, host ms) per batch}, each stage run alone; the
    stages the model runs."""
    totals = {name: [0.0, 0.0, 0] for name, _, _ in STAGES}
    originals = []
    for name, path, method in STAGES:
        try:
            owner = _owner(model, path)
        except AttributeError:  # a layer of the 128^2 tail in a 64^2 model
            continue
        fn = getattr(owner, method)
        originals.append((owner, method))

        def wrapped(*args, _fn=fn, _name=name, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = _fn(*args, **kw)
            end.record()
            host = time.perf_counter() - t0  # the enqueue, before the device is waited for
            torch.cuda.synchronize()
            totals[_name][0] += start.elapsed_time(end)
            totals[_name][1] += host * 1e3
            totals[_name][2] += 1
            return out

        setattr(owner, method, wrapped)  # an instance attribute shadows the method
    try:
        for _ in range(batches):
            model.generate(*ins)
    finally:
        for owner, method in originals:
            delattr(owner, method)
    return {name: (dev / batches, host / batches) for name, (dev, host, calls) in totals.items()
            if calls}


def profiled(model, ins, batches: int):
    """(launches per batch, busy ms per batch, event ms per batch, [(kernel, ms per batch)])."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(batches):
            model.generate(*ins)
        end.record()
        torch.cuda.synchronize()
    kernels = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            us = getattr(ev, "device_time_total", None)  # cuda_time_total in older PyTorch
            us = ev.cuda_time_total if us is None else us
            kernels[ev.name] = kernels.get(ev.name, 0.0) + us / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    return (launches / batches, busy / batches, start.elapsed_time(end) / batches,
            [(name, ms / batches) for name, ms in top])


def main() -> int:
    import chip_smoke as cs
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image_size", type=int, default=128, choices=[64, 128])
    ap.add_argument("--off", action="store_true", help="the kernels' plain versions")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--int8", action="store_true", help="Config.int8_serving (bench --int8)")
    ap.add_argument("--typed_c3", choices=["v4", "v5", "v6"], default="v4",
                    help="the typed c3 kernel (Config.typed_c3)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    size = args.image_size
    cfg = config_for(size, batch_size=cs.B, max_objects=cs.O, bf16=True, int8_serving=args.int8,
                     typed_c3=args.typed_c3)
    model = build_generator(cfg, "cuda", seed=0)
    cs.set_kernels(model, not args.off, cfg)
    ins = layouts(cfg, cs.B, cs.O, seed=0, device="cuda")
    conf = (" int8" if args.int8 else "") + (f" typed {args.typed_c3}" if args.typed_c3 != "v4" else "")
    tag = f"[profile] {size}^2 B={cs.B} bf16{conf}, kernels {'off' if args.off else 'on'}, {smi}"
    for _ in range(3):
        model.generate(*ins)
    print(f"{tag}: staged, {args.batches} batches", flush=True)
    for name, (dev, host) in staged(model, ins, args.batches).items():
        print(f"[profile]   {name}: device {dev:.3f} ms, host {host:.3f} ms", flush=True)
    launches, busy, event_ms, top = profiled(model, ins, args.batches)
    print(f"{tag}: free-running, {args.batches} batches: {launches:.0f} launches a batch, device "
          f"busy {busy:.3f} ms a batch, {event_ms:.3f} ms a batch by CUDA events (under the "
          f"profiler), busy share {busy / event_ms:.2f}", flush=True)
    for name, ms in top:
        print(f"[profile]   {ms:8.3f} ms  {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
