"""Train-step throughput table: resolution x batch x dtype on the card.

    python -m aglayout_tpu_torch.tools.bench_train_table [--iters 10]
        [--configs 64:8,128:8,128:32] [--out artifacts/torch_train_bench.json]
        [--device cuda|cpu]

Times the GAN train step (`train/step.py` through `bench.run_train`: one
warm-up step, then `--iters` steps by CUDA events on one seeded
`synthetic_batch`) for every image_size:batch pair of `--configs` in f32
(TF32 off, as `bench --train_step --f32`) and in bf16 (bf16 compute, f32
parameters, BN statistics and Adam moments). Each configuration runs in a
subprocess of its own (`--single size:batch:compute[:remat]`, which prints
one `ROW {json}` line), so that an out-of-memory failure or a leak in one
cannot take the others down and the card starts clean each time. A row
that fails is tried again, with `remat` after an out-of-memory failure and
on the last of three attempts. Rows are written to `--out` as they come,
with the JAX package's keys (`steps_per_sec_{size}_b{B}[_bf16][_remat]`)
and each row's card name and power limit; configurations already in the
file are skipped. Prints a markdown table at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OOM_MARKS = ("torch.cuda.OutOfMemoryError", "out of memory")


def measure(image_size: int, batch_size: int, bf16: bool, iters: int, remat: bool = False,
            device: str = "cuda", **overrides) -> dict:
    """One configuration's row; `overrides` narrow the config (tests)."""
    from aglayout_tpu_torch import bench

    argv = ["--train_step", str(batch_size), "--image_size", str(image_size),
            "--iters", str(iters), "--device", device]
    argv += [] if bf16 else ["--f32"]
    argv += ["--remat"] if remat else []
    out = bench.run(bench.parser().parse_args(argv), **overrides)
    return {
        "image_size": image_size,
        "batch_size": batch_size,
        "compute": "bf16" if bf16 else "f32",
        "remat": remat,
        "steps_per_sec": out["value"],
        "imgs_per_sec": out["images_per_sec"],
        "warm_call_s": round(out["warm_step_s"], 1),
        "card": out["card"],
    }


def _write(out_path: str, rows: list):
    """`rows` and a steps/s key for each, as the JAX package's table."""
    out = {"rows": rows}
    for r in rows:
        key = f"steps_per_sec_{r['image_size']}_b{r['batch_size']}"
        if r["compute"] == "bf16":
            key += "_bf16"
        if r.get("remat"):
            key += "_remat"
        out[key] = r["steps_per_sec"]
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)


def run_single(spec: str, iters: int, device: str) -> subprocess.CompletedProcess:
    """One configuration in a subprocess of its own."""
    return subprocess.run(
        [sys.executable, "-m", "aglayout_tpu_torch.tools.bench_train_table", "--single", spec,
         "--iters", str(iters), "--device", device],
        capture_output=True, text=True, timeout=3600, cwd=REPO,
    )


def table(configs: str, out_path: str, iters: int, device: str,
          computes=("f32", "bf16")) -> list:
    """Measure every configuration of `configs` x `computes` not yet in
    `out_path`; returns all rows."""
    rows = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            rows = json.load(f).get("rows", [])

    def have(size, b, compute):
        return any(r["image_size"] == size and r["batch_size"] == b and r["compute"] == compute
                   for r in rows)

    for pair in configs.split(","):
        size, b = (int(x) for x in pair.strip().split(":"))
        for compute in computes:
            if have(size, b, compute):
                print(f"{size}^2 b={b} {compute}: already measured, skip", flush=True)
                continue
            row, remat = None, False
            for attempt in range(3):
                spec = f"{size}:{b}:{compute}" + (":remat" if remat else "")
                r = run_single(spec, iters, device)
                for line in r.stdout.splitlines():
                    if line.startswith("ROW "):
                        row = json.loads(line[4:])
                if row is not None:
                    break
                print(f"{spec} attempt {attempt} failed (rc={r.returncode}): "
                      f"{r.stderr.strip().splitlines()[-1:]}", flush=True)
                err = (r.stderr + r.stdout).lower()
                if any(mark.lower() in err for mark in OOM_MARKS):
                    remat = True  # out of memory: no point trying again without remat
                if attempt == 1 and not remat:
                    remat = True  # the last attempt: remat is the only lever left
            if row is None:
                print(f"{size}^2 b={b} {compute}: UNMEASURABLE, skipping", flush=True)
                continue
            rows.append(row)
            print(json.dumps(row), flush=True)
            _write(out_path, rows)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--configs", default="64:8,128:8,128:32",
                   help="comma list of image_size:batch pairs; each runs f32 AND bf16")
    p.add_argument("--out", default=os.path.join(REPO, "artifacts", "torch_train_bench.json"))
    p.add_argument("--single", default=None,
                   help="internal: run ONE size:batch:compute[:remat] config in this process "
                   "and print its row")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host clock, for tests")
    args = p.parse_args(argv)

    if args.single:
        parts = args.single.split(":")
        size, b, compute = int(parts[0]), int(parts[1]), parts[2]
        remat = len(parts) > 3 and parts[3] == "remat"
        row = measure(size, b, compute == "bf16", args.iters, remat=remat, device=args.device)
        print("ROW " + json.dumps(row), flush=True)
        return [row]

    rows = table(args.configs, args.out, args.iters, args.device)
    print("\n| size | batch | compute | remat | steps/s | img/s | card |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['image_size']}² | {r['batch_size']} | {r['compute']} | "
              f"{'y' if r.get('remat') else ''} | {r['steps_per_sec']} | {r['imgs_per_sec']} | "
              f"{r.get('card', '')} |")
    return rows


if __name__ == "__main__":
    main()
