"""Where a serving batch, or a train step, spends its time, stage by stage
and kernel by kernel, on one CUDA card:

    python3 -m aglayout_tpu_torch.profile_generate [--image_size 64|128] [--off] [--batches 5]
        [--int8] [--typed_c3 v4|v5|v6]
    python3 -m aglayout_tpu_torch.profile_generate --train_step [B] [--f32 [--tf32]] [--deterministic]
        [--batches 5] [--graph | --group]

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
  * free-running: the batch time by CUDA events, then under
    `torch.profiler` kernel launches per batch, the device's busy time per
    batch (the sum of its kernels' times), its share of the batch time
    taken without the profiler (and of the one under it, which the
    profiler's host work stretches), and the kernels that take most of it,
    by name.

With `--train_step [B]` (B=8 when not given) the second pass profiles
`--batches` steps of `train/step.py` on the bench's synthetic batch (bf16,
or with `--f32` f32 with TF32 off, with `--tf32` on, as `train_evidence
--tf32` runs; with `--deterministic` under torch's deterministic algorithms,
`utils/device.deterministic`; the models in training mode, no kernel of
the port) after two warm-up steps: launches, device busy time and its
share of each step. Then one step runs under
`torch.cuda.set_sync_debug_mode("warn")`, and the lines of the port that
made the host wait for the card in it are listed by file and line. With
`--graph` the step is then captured as one CUDA graph (`train/graph.py`)
and profiled graphed, eager, graphed, on the same state. With `--group`
the same step runs also sharded in an NCCL group of one rank
(`parallel.make_sharded_train_step`; the process joins it itself), each
profiled in turns with the plain one: what the collectives cost a step
before a second card shares the work.

Each pass also counts the CUDA runtime calls that make the host wait for
the card (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`, and the copies `cudaMemcpy*`, which wait where
they copy from pageable host memory), with their host time, and lists the
host operations that take the most host time of their own.
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


def event_ms(fn, batches: int) -> float:
    """fn() `batches` times: ms per call by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(batches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / batches


def profiled(fn, batches: int):
    """fn() `batches` times under the profiler, after as many calls timed
    without it: (launches per call, busy ms per call, event ms per call
    without the profiler, event ms per call under it, [(kernel, ms per
    call)])."""
    from torch.profiler import ProfilerActivity, profile

    plain_ms = event_ms(fn, batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = event_ms(fn, batches)
    kernels, waits = {}, {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            us = getattr(ev, "device_time_total", None)  # cuda_time_total in older PyTorch
            us = ev.cuda_time_total if us is None else us
            kernels[ev.name] = kernels.get(ev.name, 0.0) + us / 1e3
        elif ev.name.startswith("cuda") and ("Synchronize" in ev.name or "Memcpy" in ev.name):
            n, ms = waits.get(ev.name, (0, 0.0))
            waits[ev.name] = (n + 1, ms + ev.cpu_time_total / 1e3)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:15]
    return (launches / batches, busy / batches, plain_ms, traced_ms,
            [(name, ms / batches) for name, ms in top],
            {name: (n / batches, ms / batches) for name, (n, ms) in waits.items()},
            [(a.key, a.count / batches, a.self_cpu_time_total / 1e3 / batches) for a in host])


def report(tag: str, what: str, batches: int, profile) -> None:
    """The busy share is the kernels' time over the call's time without
    the profiler, whose own host work stretches the calls it traces."""
    launches, busy, plain_ms, traced_ms, top, waits, host = profile
    plural = {"batch": "batches", "step": "steps"}[what]
    print(f"{tag}: free-running, {batches} {plural}: {launches:.0f} launches a {what}, device "
          f"busy {busy:.3f} ms a {what}; {plain_ms:.3f} ms a {what} by CUDA events without the "
          f"profiler, busy share {busy / plain_ms:.2f}; {traced_ms:.3f} ms under it "
          f"(busy share {busy / traced_ms:.2f}); host waits a {what} (calls, host ms): "
          f"{ {k: (round(n, 1), round(ms, 3)) for k, (n, ms) in waits.items()} }", flush=True)
    for name, ms in top:
        print(f"[profile]   {ms:8.3f} ms  {name[:110]}", flush=True)
    print(f"{tag}: host ops by their own host time a {what} (under the profiler):", flush=True)
    for name, n, ms in host:
        print(f"[profile host] {ms:8.3f} ms {n:7.1f} calls  {name[:100]}", flush=True)


def train_step_profile(args, smi: str) -> None:
    """The second pass over `args.batches` train steps; with
    `args.deterministic` under torch's deterministic algorithms, entered
    before the first product (cuBLAS reads its workspace config then)."""
    import contextlib

    from aglayout_tpu_torch.utils.device import deterministic

    with deterministic() if args.deterministic else contextlib.nullcontext():
        _train_step_profile(args, smi)


def _train_step_profile(args, smi: str) -> None:
    from aglayout_tpu_torch.bench import train_inputs
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.parallel import make_sharded_train_step
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    b = args.train_step
    cfg = config_for(args.image_size, batch_size=b, bf16=not args.f32)
    if args.f32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = args.tf32
    batch, matrix, pos_weight = train_inputs(cfg, b)
    batch = batch_to_torch(batch, "cuda")
    runs = {}
    for name in ("plain", "group") if args.group else ("plain",):
        state = create_train_state(cfg, "cuda", seed=0)
        step = make_train_step(cfg, state.models, matrix, pos_weight)
        if name == "group":
            step = make_sharded_train_step(step, nccl_group_of_one())
        for _ in range(2):
            step(state, batch)
        runs[name] = (step, state)
    precision = f"f32 (TF32 {'on' if args.tf32 else 'off'})" if args.f32 else "bf16"
    tag = (f"[profile] train step {args.image_size}^2 B={b} {precision}"
           f"{', deterministic' if args.deterministic else ''}, {smi}")
    for name in ("plain", "group", "group", "plain") if args.group else ("plain",):
        step, state = runs[name]
        report(f"{tag}, {name}" if args.group else tag, "step", args.batches,
               profiled(lambda: step(state, batch), args.batches))
    step, state = runs["plain"]
    sites = sync_sites(lambda: step(state, batch))
    print(f"{tag}: host waits in one step by line ({sum(sites.values())} in all):", flush=True)
    for site, n in sorted(sites.items(), key=lambda kv: -kv[1]):
        print(f"[profile sync] {n:4d}  {site}", flush=True)
    if args.graph:
        from aglayout_tpu_torch.train.graph import GraphedTrainStep

        graphed = GraphedTrainStep(step, state, batch)
        for name in ("graphed", "eager", "graphed"):
            fn = graphed if name == "graphed" else step
            report(f"{tag}, {name}", "step", args.batches,
                   profiled(lambda: fn(state, batch), args.batches))


def sync_sites(fn) -> dict:
    """{file:line: count} of the calls that made the host wait for the card
    in one fn(), by the Python line that made each (torch's sync debug
    mode warns at every synchronising call)."""
    import collections
    import os
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                                    if "called a synchronizing CUDA operation" in str(w.message)))


def nccl_group_of_one():
    """This process as the one rank of an NCCL group on localhost."""
    import os
    import socket

    from aglayout_tpu_torch.parallel import maybe_init_distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    return maybe_init_distributed("cuda")


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
    ap.add_argument("--train_step", type=int, nargs="?", const=8, default=None, metavar="B",
                    help="profile the GAN train step at batch B (default 8) instead")
    ap.add_argument("--f32", action="store_true", help="with --train_step: f32 models, TF32 off")
    ap.add_argument("--tf32", action="store_true", help="with --f32: TF32 on in cuBLAS and cuDNN")
    ap.add_argument("--deterministic", action="store_true",
                    help="with --train_step: torch's deterministic algorithms")
    ap.add_argument("--graph", action="store_true",
                    help="with --train_step: then the step captured as one CUDA graph "
                         "(train/graph.py), in turns with the eager step")
    ap.add_argument("--group", action="store_true",
                    help="with --train_step: also the step sharded in an NCCL group of one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.train_step is not None:
        train_step_profile(args, smi)
        return 0
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
    report(tag, "batch", args.batches, profiled(lambda: model.generate(*ins), args.batches))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
