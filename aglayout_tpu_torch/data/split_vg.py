"""Create the train/test/val image-id split for Visual Genome.

The port's own copy of `aglayout_tpu/data/split_vg.py` (numpy only).

Capability parity with the reference's data/Datasets/vg/train_test_split.py:
shuffles all image ids into train/test/val with the reference's proportions
(86463/10807/10807 out of 108077 usable ids — i.e. 80%/10%/10%).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def make_splits(image_ids, seed: int = 0, train_frac: float = 0.8):
    rng = np.random.RandomState(seed)
    ids = np.asarray(image_ids)
    rng.shuffle(ids)
    n = len(ids)
    n_train = int(round(n * train_frac))
    n_test = (n - n_train) // 2
    return {
        "train": ids[:n_train].tolist(),
        "test": ids[n_train : n_train + n_test].tolist(),
        "val": ids[n_train + n_test :].tolist(),
    }


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vg_dir", default="data/vg")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    with open(os.path.join(args.vg_dir, "image_data.json")) as f:
        images = json.load(f)
    splits = make_splits([i["image_id"] for i in images], args.seed)
    out = os.path.join(args.vg_dir, "vg_splits.json")
    with open(out, "w") as f:
        json.dump(splits, f)
    print({k: len(v) for k, v in splits.items()}, "->", out)


if __name__ == "__main__":
    main()
