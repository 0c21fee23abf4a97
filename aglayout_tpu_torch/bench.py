"""Benchmarks of the port on one GPU: generator inference throughput, or
the GAN train step.

    python -m aglayout_tpu_torch.bench [--int8] [--dense] [--no_<kernel> ...]
                                       [--typed_c3 v4|v5|v6] [--no_compact_heads]
    python -m aglayout_tpu_torch.bench --train_step [B] [--remat] [--double_g_forward] [--f32]

The serving branch of the JAX package's root `bench.py`: eval-mode
`Generator.generate` at 128^2, B=128, O=10, bf16 by default, on layouts
seeded as there, with a fresh z for every iteration. It warms up, times
`--iters` batches with CUDA events, raises unless the checksum of the
images is finite, and prints one JSON line: `metric`, `value`
(images/sec), `unit`, `ms_per_batch`, and the card's name and power
limit. It needs a CUDA device and exits with an error without one;
`--device cpu` runs the plain PyTorch paths on the host clock instead,
which says nothing about the card.

`--int8` is the opt-in approximate int8 serving configuration
(`Config.int8_serving`); `--dense` turns every hand-written kernel off, and
`--no_<kernel>` one of them. The serving A/B configurations: `--typed_c3`
picks the typed-c3 kernel (its default is the environment's `AGL_TYPED_C3`
where that names v5 or v6, as the JAX package reads it, else v4);
`--no_head8` sends the c7 head through `spade_few_out_conv` on compact
tables, and with `--no_compact_heads` on flat ones.

`--train_step [B]` is the train branch of the JAX package's `bench.py`:
`--iters` steps of `train/step.py` at batch B (8 when not given, the
reference's; 128^2 unless `--image_size` says otherwise) on one seeded
`synthetic_batch`, after one warm-up step, in bf16, or with `--f32` in f32
with TF32 off. Its JSON line holds steps/sec, images/sec and ms/step from
CUDA events around the steps, the warm-up step's seconds on the host
clock (the card synchronised after it), the mean ms of each part of a step (prep:
crops, the attribute D's real-crop forward, estimation and swap;
g_forward; d_phase: the Ds' forwards, backward and Adam steps; g_phase:
the G losses, backward and Adam step) from events the step marks, the D
phase's share of the step, the peak device memory, and the card's name
and power limit. No kernel of the port runs in a train step (every model
is in training mode).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from aglayout_tpu_torch.config import Config, config_for
from aglayout_tpu_torch.models import build_generator
from aglayout_tpu_torch.utils.device import no_tf32, require

# --no_<name> -> the Config switch it turns off
KERNEL_FLAGS = {
    "trunk": "use_trunk_kernel",
    "head": "use_head_kernel",
    "typed": "use_typed_kernel",
    "apply": "use_apply_kernel",
    "head8": "use_head8_kernel",
    "int8_kernel": "use_int8_kernel",
}


def layouts(cfg: Config, b: int, o: int, seed: int, device):
    """Seeded serving layouts, drawn as the JAX package's `bench.py` draws
    them: objs, boxes, valid (all ones), z, attribute, as tensors on `device`."""
    rng = np.random.RandomState(seed)
    objs = rng.randint(0, cfg.num_classes, (b, o))
    xy0 = rng.uniform(0, 0.6, (b, o, 2)).astype(np.float32)
    wh = rng.uniform(0.1, 0.4, (b, o, 2)).astype(np.float32)
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, 1.0)], -1)
    valid = np.ones((b, o), np.float32)
    attr = (rng.rand(b, o, cfg.attribute_dim) < 0.05).astype(np.float32)
    z = rng.randn(b, o, cfg.z_dim).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (objs, boxes, valid, z, attr)]


# The config fields of a small train step: the CPU tests' widths, at which
# the card's f32 step is held against the CPU's (`train/compare.py`).
TRAIN_SMALL = dict(num_classes=23, attribute_dim=12, conv_dim=8, z_dim=8, embedding_dim=8,
                   clstm_layers=2, resi_num=2, d_conv_dim=8, batch_size=3, max_objects=3)


def train_inputs(cfg: Config, b: int, seed: int = 0):
    """(batch, matrix, pos_weight) as numpy for a train step of `cfg` at
    batch b: a seeded `synthetic_batch`, a co-occurrence matrix from the
    same draws, and the vocabulary's positive-class weights (seeded ones for
    a model narrower than its 106 attributes)."""
    from aglayout_tpu_torch.data.synthetic import synthetic_batch, synthetic_cooccurrence
    from aglayout_tpu_torch.data.vocab import attribute_pos_weight

    rng = np.random.RandomState(seed)
    batch = synthetic_batch(rng, b, cfg.max_objects, cfg.image_size, cfg.num_classes,
                            cfg.attribute_dim)
    matrix = synthetic_cooccurrence(rng, cfg.num_classes, cfg.attribute_dim)
    pos_weight = attribute_pos_weight()
    if cfg.attribute_dim != len(pos_weight):
        pos_weight = rng.uniform(1.0, 30.0, cfg.attribute_dim).astype(np.float32)
    return batch, matrix, pos_weight


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card(device) -> str:
    """What a run's numbers were taken on: the card's name and power limit,
    or the host's clock."""
    if torch.device(device).type == "cuda":
        return card_name_and_power_limit()
    return "cpu (host clock; not a device number)"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--max_objects", type=int, default=10)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--f32", action="store_true", help="disable bf16 compute")
    p.add_argument("--int8", action="store_true",
                   help="opt-in approximate int8 serving path (wide ConvLSTM gate convs)")
    p.add_argument("--dense", action="store_true",
                   help="turn every hand-written kernel off (plain PyTorch paths)")
    for name, switch in KERNEL_FLAGS.items():
        p.add_argument(f"--no_{name}", action="store_true", help=f"turn {switch} off")
    env = os.environ.get("AGL_TYPED_C3", "")
    p.add_argument("--typed_c3", choices=["v4", "v5", "v6"],
                   default=env if env in ("v5", "v6") else "v4",
                   help="the typed-c3 kernel (default: AGL_TYPED_C3 if it is v5 or v6, else v4)")
    p.add_argument("--no_compact_heads", action="store_true",
                   help="with --no_head8: the c7 head reads flat tables, not compact ones")
    p.add_argument("--train_step", type=int, nargs="?", const=8, default=None, metavar="B",
                   help="time the GAN train step at batch B (default 8) instead of generate")
    p.add_argument("--remat", action="store_true",
                   help="with --train_step: recompute the G forward in its backward")
    p.add_argument("--double_g_forward", action="store_true",
                   help="with --train_step: a second G forward in the G phase (the reference's)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: plain paths on the host, for tests; no device number comes of it")
    return p


def config_from_args(args, **overrides) -> Config:
    """The Config of a run; `overrides` narrow the model (tests)."""
    switches = {switch: not (args.dense or getattr(args, f"no_{name}"))
                for name, switch in KERNEL_FLAGS.items()}
    return config_for(args.image_size, batch_size=batch_size(args), max_objects=args.max_objects,
                      bf16=not args.f32, int8_serving=args.int8, typed_c3=args.typed_c3,
                      remat=args.remat, double_g_forward=args.double_g_forward,
                      use_compact_heads=not args.no_compact_heads, **switches, **overrides)


def batch_size(args) -> int:
    return args.train_step or args.batch_size


def run(args, **overrides) -> dict:
    """Time `args.iters` batches of generate, or train steps with
    `--train_step`; returns the JSON line's dict."""
    require(args.device, "bench")  # this benchmark measures the card
    if args.train_step is not None:
        return run_train(args, **overrides)
    cfg = config_from_args(args, **overrides)
    b, o, iters = batch_size(args), args.max_objects, args.iters
    model = build_generator(cfg, args.device, seed=0)
    objs, boxes, valid, _, attr = layouts(cfg, b, o, seed=0, device=args.device)
    zs = torch.from_numpy(
        np.random.RandomState(1).randn(2, iters, b, o, cfg.z_dim).astype(np.float32)
    ).to(args.device)

    def batches(zstack):
        total = torch.zeros((), dtype=torch.float32, device=args.device)
        for z in zstack:
            total += model.generate(objs, boxes, valid, z, attr).float().sum()
        return total

    batches(zs[0])  # warm-up: builds the kernels, fills the allocator
    if args.device == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        checksum = batches(zs[1])
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        checksum = batches(zs[1])
        ms = (time.perf_counter() - t0) * 1e3 / iters
    checksum = float(checksum)
    if not np.isfinite(checksum):
        raise FloatingPointError(f"bench: the images' checksum is {checksum}")
    return {
        "metric": f"{args.image_size}x{args.image_size} generator inference images/sec/chip",
        "value": round(b / ms * 1e3, 1),
        "unit": "images/sec",
        "ms_per_batch": round(ms, 3),
        "card": card(args.device),
        "config": {"batch_size": b, "max_objects": o, "bf16": cfg.bf16,
                   "int8_serving": cfg.int8_serving, "typed_c3": cfg.typed_c3,
                   "compact_heads": cfg.use_compact_heads,
                   "kernels_off": sorted(s for s in KERNEL_FLAGS.values() if not getattr(cfg, s))},
    }


PHASES = ("prep", "g_forward", "d_phase", "g_phase")


def run_train(args, **overrides) -> dict:
    """Time `args.iters` train steps; returns the JSON line's dict. Under
    `--f32` the step runs in f32 with TF32 off in cuBLAS and cuDNN, as the
    JAX package's f32 step computes; the flags come back after."""
    cfg = config_from_args(args, **overrides)
    with contextlib.nullcontext() if cfg.bf16 else no_tf32():
        return _time_train(args, cfg)


def _time_train(args, cfg) -> dict:
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    b, o, iters, dev = batch_size(args), cfg.max_objects, args.iters, args.device
    batch, matrix, pos_weight = train_inputs(cfg, b)
    batch = batch_to_torch(batch, dev)
    state = create_train_state(cfg, dev, seed=0)
    step = make_train_step(cfg, state.models, matrix, pos_weight)
    cuda = dev == "cuda"

    def stamp():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def elapsed_ms(a, b):
        return a.elapsed_time(b) if cuda else (b - a) * 1e3

    t0 = time.perf_counter()
    state, _ = step(state, batch)  # warm-up: cuDNN's algorithm choice, the allocator
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    warm_s = time.perf_counter() - t0
    marks, total = [], torch.zeros((), device=dev)
    for _ in range(iters):
        times = {"start": stamp()}
        state, metrics = step(state, batch, mark=lambda name, t=times: t.__setitem__(name, stamp()))
        total += metrics["G/loss"]
        marks.append(times)
    if cuda:
        torch.cuda.synchronize()
    checksum = float(total)
    if not np.isfinite(checksum):
        raise FloatingPointError(f"bench: the G losses' sum is {checksum}")
    ms = elapsed_ms(marks[0]["start"], marks[-1]["g_phase"]) / iters
    parts = {}
    for name, prev in zip(PHASES, ("start",) + PHASES):
        parts[name] = round(sum(elapsed_ms(t[prev], t[name]) for t in marks) / iters, 3)
    return {
        "metric": f"{cfg.image_size}x{cfg.image_size} GAN train steps/sec/chip (batch {b})",
        "value": round(1e3 / ms, 3),
        "unit": "steps/sec",
        "images_per_sec": round(b * 1e3 / ms, 1),
        "ms_per_step": round(ms, 3),
        "warm_step_s": round(warm_s, 3),
        "phase_ms": parts,
        "d_phase_share": round(parts["d_phase"] / ms, 3),
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3) if cuda else None,
        "card": card(dev),
        "config": {"batch_size": b, "max_objects": o, "bf16": cfg.bf16, "remat": cfg.remat,
                   "double_g_forward": cfg.double_g_forward, "iters": iters,
                   "tf32": cuda and torch.backends.cudnn.allow_tf32},
    }


def main(argv=None) -> int:
    print(json.dumps(run(parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
