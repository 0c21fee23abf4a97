"""The 128^2 training evidence at JAX's 12,000 steps over four fixed seeds,
and the rule that decides whether the port's curve misses JAX's.

    python -m aglayout_tpu_torch.tools.evidence_seeds
        [--dir artifacts/torch_train_evidence_128_12000/seeds] [--out FILE]

Reads `<dir>/seed_S/`, each written by

    python -m aglayout_tpu_torch.tools.train_evidence --image_size 128 \\
        --steps 12000 --deterministic --tf32 --seed S --out <dir>/seed_S

for S in `SEEDS`, in that order (a seed is read only with every seed
before it: the runs come in the rule's order, none skipped). The rule:
`L_S` is `train_evidence.windows`' last window of `G/rec_img` (the mean
of the last 10 % of the logs, 120 of 1,200); `m` is the median of the
four (the mean of the middle two); `m <= BOUND` (JAX's last window,
0.3448, plus the twin test's tolerance, 0.05) is a draw and `m > BOUND`
a fault; before all four are in, `m` is null and the verdict `pending`.

Beside the rule, not part of it: each seed's first window and reduction
(JAX's bar is a reduction above 0.3), and, for every logged metric, the
mean of the `WINDOW` logs (1,000 steps) that end at each step of `AT`,
for each seed and for the runs in `REFERENCES` (null past a run's end).
Writes verdict.json (by default into `--dir`) and prints it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from aglayout_tpu_torch.tools.train_evidence import REPO, windows

SEEDS = (0, 1, 2, 3)
STEPS = 12000
KEY = "G/rec_img"
JAX_LAST = 0.3448  # artifacts/train_evidence_128/summary.json's rec_l1_last_window, rounded
TOLERANCE = 0.05  # test_committed_training_evidence_128's
BOUND = 0.3948  # JAX_LAST + TOLERANCE
AT = (1000, 3000, 6000, 12000)
WINDOW = 100  # logs: 1,000 steps at a log every 10
DIR = os.path.join(REPO, "artifacts", "torch_train_evidence_128_12000", "seeds")
REFERENCES = {  # label: a run directory of the repo
    "jax": os.path.join("artifacts", "train_evidence_128"),
    "eager, 6,000 steps": os.path.join("artifacts", "torch_train_evidence_128"),
    "pre-repair (side-stream warm-up)": os.path.join("artifacts",
                                                     "torch_train_evidence_128_12000"),
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", default=DIR)
    p.add_argument("--out", default=None, help="default: <dir>/verdict.json")
    return p


def read_metrics(d: str) -> list:
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def seeds_present(d: str) -> list:
    """The seeds of `SEEDS` whose run is in `d`, in order; raises if one is
    there without every seed before it."""
    present = [s for s in SEEDS if os.path.isdir(os.path.join(d, f"seed_{s}"))]
    if present != list(SEEDS[:len(present)]):
        raise ValueError(f"{d} holds seeds {present}: the runs come in the order {SEEDS}")
    return present


def median_and_verdict(last_windows: list) -> tuple:
    """(m, verdict) of the rule on the seeds' `L_S`, in `SEEDS`' order."""
    if len(last_windows) < len(SEEDS):
        return None, "pending"
    m = float(np.median(last_windows))
    return m, "draw" if m <= BOUND else "fault"


def metric_windows(rows: list) -> dict:
    """For every logged metric, the mean of the `WINDOW` logs ending at each
    step of `AT` (null where the run has no log at that step)."""
    steps = [r["step"] for r in rows]
    ends = {n: steps.index(n) + 1 for n in AT if n in steps}
    return {k: {str(n): (float(np.mean([r[k] for r in rows[max(0, ends[n] - WINDOW):ends[n]]]))
                         if n in ends else None) for n in AT}
            for k in sorted(k for k in rows[0] if k != "step")}


def study(d: str = DIR) -> dict:
    seeds, last = {}, []
    for s in seeds_present(d):
        run = os.path.join(d, f"seed_{s}")
        rows = read_metrics(run)
        with open(os.path.join(run, "summary.json")) as f:
            summary = json.load(f)
        first, l_s, reduction = windows([r[KEY] for r in rows])
        last.append(l_s)
        seeds[str(s)] = {"L_S": l_s, "first_window": first, "reduction": reduction,
                         "steps": rows[-1]["step"], "card": summary["card"],
                         "steps_per_sec": summary["steps_per_sec"],
                         "windows": metric_windows(rows)}
    m, verdict = median_and_verdict(last)
    refs = {label: metric_windows(read_metrics(os.path.join(REPO, path)))
            for label, path in REFERENCES.items()}
    return {"rule": {"seeds": list(SEEDS), "steps": STEPS, "statistic": KEY,
                     "jax_last_window": JAX_LAST, "tolerance": TOLERANCE, "bound": BOUND},
            "seeds_run": [int(s) for s in seeds], "m": m, "verdict": verdict,
            "cards": sorted({v["card"] for v in seeds.values()}), "seeds": seeds,
            "window_logs": WINDOW, "references": refs}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    out = study(args.dir)
    with open(args.out or os.path.join(args.dir, "verdict.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in out.items() if k not in ("seeds", "references")}))
    return out


if __name__ == "__main__":
    main()
