"""The first window of `train_evidence` across seeds.

    python -m aglayout_tpu_torch.tools.first_window [--seeds 0 1 2 3 4 5 6 7]
        [--image_size 64] [--batch_size 8] [--deterministic] [--tf32]
        [--out FILE] [--device cuda|cpu]

For each seed, a fresh `train_evidence` run of the 30 steps that its
first window reads, logged every 10 (`train_evidence --seed`, its
other arguments as given, the output in a temporary directory): the three
logged reconstruction L1 values, and their mean, `train_evidence`'s first
window. Prints one JSON object
(and writes it to `--out`): per seed the values and the window, the
windows' min, max, mean and standard deviation, the card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

LOG_EVERY = 10
FIRST_LOGS = 3  # train_evidence.windows' first window
STEPS = FIRST_LOGS * LOG_EVERY


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--tf32", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host, for tests")
    return p


def main(argv=None, **overrides) -> dict:
    """The CLI; `overrides` narrow the config (tests)."""
    from aglayout_tpu_torch.bench import card
    from aglayout_tpu_torch.tools import train_evidence

    args = parser().parse_args(argv)
    runs = {}
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as out:
            argv_run = ["--steps", str(STEPS), "--image_size", str(args.image_size),
                        "--batch_size", str(args.batch_size), "--log_every", str(LOG_EVERY),
                        "--seed", str(seed), "--out", out, "--device", args.device]
            argv_run += ["--deterministic"] * args.deterministic + ["--tf32"] * args.tf32
            train_evidence.run(train_evidence.parser().parse_args(argv_run), **overrides)
            with open(os.path.join(out, "metrics.jsonl")) as f:
                values = [json.loads(line)["G/rec_img"] for line in f]
        runs[str(seed)] = {"rec_l1": values, "first_window": train_evidence.windows(values)[0]}
        print(f"seed {seed}: first window {runs[str(seed)]['first_window']:.4f}", flush=True)
    windows = [r["first_window"] for r in runs.values()]
    result = {
        "image_size": args.image_size, "batch_size": args.batch_size, "steps": STEPS,
        "deterministic": args.deterministic, "tf32": args.tf32, "seeds": runs,
        "first_window": {"min": min(windows), "max": max(windows),
                         "mean": float(np.mean(windows)), "std": float(np.std(windows))},
        "card": card(args.device),
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
