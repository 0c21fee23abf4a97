"""Training-evidence runs side by side: the reconstruction L1 of each run's
`metrics.jsonl` at chosen steps.

    python -m aglayout_tpu_torch.tools.compare_evidence DIR [DIR ...]
        [--at STEP ...] [--out FILE]

Each DIR is a `train_evidence` output, the port's or the JAX package's
(`artifacts/train_evidence/`). For each run: the mean of the `WINDOW`
logs that end at each step of `--at` (by default `AT` and every run's last
step; null past the run's end); the first
window (the first 3 logs) and the last 10 % of the logs, and their
reduction, as `train_evidence` takes them, for the whole run and as if it
had ended at each step of `--at`; and how many leading lines of its
`metrics.jsonl` equal the first run's (two runs of one seed and config
that repeat themselves share every line they both have). Prints one JSON
object and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from aglayout_tpu_torch.tools.train_evidence import windows

KEY = "G/rec_img"  # the reconstruction L1, as `train_evidence` reads it
WINDOW = 10  # logs a mean: 100 steps at a log every 10
AT = (200, 1000, 3000, 8000)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dirs", nargs="+")
    p.add_argument("--at", type=int, nargs="+", default=None,
                   help=f"steps to compare at (default {list(AT)} and every run's last step)")
    p.add_argument("--out", default=None)
    return p


def compare(dirs, at=None) -> dict:
    runs, lines0, texts = [], None, []
    for d in dirs:
        with open(os.path.join(d, "metrics.jsonl")) as f:
            texts.append(f.read().splitlines())
    if at is None:
        at = sorted(set(AT) | {json.loads(lines[-1])["step"] for lines in texts})
    for d, lines in zip(dirs, texts):
        rows = [json.loads(line) for line in lines]
        steps = [r["step"] for r in rows]
        values = [r[KEY] for r in rows]
        means, upto = {}, {}
        for n in at:
            end = steps.index(n) + 1 if n in steps else None
            means[str(n)] = (float(np.mean(values[max(0, end - WINDOW):end]))
                             if end is not None else None)
            upto[str(n)] = windows(values[:end])[2] if end is not None else None
        first, last, reduction = windows(values)
        lines0 = lines if lines0 is None else lines0
        same = next((i for i, (a, b) in enumerate(zip(lines, lines0)) if a != b),
                    min(len(lines), len(lines0)))
        runs.append({"dir": d, "steps": steps[-1], f"mean_of_{WINDOW}_logs_at": means,
                     "first_window": first, "last_window": last, "reduction": reduction,
                     "reduction_if_ended_at": upto, "lines_equal_to_the_first_run": same})
    return {"key": KEY, "at": list(at), "runs": runs}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    out = compare(args.dirs, args.at)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
