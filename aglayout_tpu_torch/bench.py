"""Serving benchmark of the port: generator inference throughput on one GPU.

    python -m aglayout_tpu_torch.bench [--int8] [--dense] [--no_<kernel> ...]
                                       [--typed_c3 v4|v5|v6] [--no_compact_heads]

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
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from aglayout_tpu_torch.config import Config, config_for
from aglayout_tpu_torch.models import build_generator

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


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: plain paths on the host, for tests; no device number comes of it")
    return p


def config_from_args(args, **overrides) -> Config:
    """The Config of a run; `overrides` narrow the model (tests)."""
    switches = {switch: not (args.dense or getattr(args, f"no_{name}"))
                for name, switch in KERNEL_FLAGS.items()}
    return config_for(args.image_size, batch_size=args.batch_size, max_objects=args.max_objects,
                      bf16=not args.f32, int8_serving=args.int8, typed_c3=args.typed_c3,
                      use_compact_heads=not args.no_compact_heads, **switches, **overrides)


def run(args, **overrides) -> dict:
    """Time `args.iters` batches of generate; returns the JSON line's dict."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; this benchmark measures the card "
                           "(--device cpu runs the plain paths for a functional check)")
    cfg = config_from_args(args, **overrides)
    b, o, iters = args.batch_size, args.max_objects, args.iters
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
        card = card_name_and_power_limit()
    else:
        t0 = time.perf_counter()
        checksum = batches(zs[1])
        ms = (time.perf_counter() - t0) * 1e3 / iters
        card = "cpu (host clock; not a device number)"
    checksum = float(checksum)
    if not np.isfinite(checksum):
        raise FloatingPointError(f"bench: the images' checksum is {checksum}")
    return {
        "metric": f"{args.image_size}x{args.image_size} generator inference images/sec/chip",
        "value": round(b / ms * 1e3, 1),
        "unit": "images/sec",
        "ms_per_batch": round(ms, 3),
        "card": card,
        "config": {"batch_size": b, "max_objects": o, "bf16": cfg.bf16,
                   "int8_serving": cfg.int8_serving, "typed_c3": cfg.typed_c3,
                   "compact_heads": cfg.use_compact_heads,
                   "kernels_off": sorted(s for s in KERNEL_FLAGS.values() if not getattr(cfg, s))},
    }


def main(argv=None) -> int:
    print(json.dumps(run(parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
