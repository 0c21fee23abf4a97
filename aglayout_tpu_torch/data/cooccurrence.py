"""Object<->attribute co-occurrence matrix: counts from the train h5.

The port's own copy of `aglayout_tpu/data/cooccurrence.py` (numpy and h5py only).

Capability parity with the reference's get_att_vs_obj_matrix.py (:37-56):
counts, for every (object class, attribute) pair, how often the attribute
annotates an object of that class in train.h5. The matrix drives the
attribute-swap sampling during training (train64.py:181).

Output: matrix_obj_vs_att.npy, float32 (num_classes, attribute_dim).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_matrix(h5_path: str, num_classes: int, attribute_dim: int = 106) -> np.ndarray:
    import h5py

    matrix = np.zeros((num_classes, attribute_dim), np.float32)
    with h5py.File(h5_path, "r") as f:
        names = np.asarray(f["object_names"])  # (N, O_max)
        atts = np.asarray(f["object_attributes"])  # (N, O_max, 30)
        per_img = np.asarray(f["objects_per_image"])  # (N,)
    for i in range(names.shape[0]):
        for j in range(int(per_img[i])):
            cls = int(names[i, j])
            if cls < 0:
                continue
            ids = atts[i, j]
            ids = ids[ids >= 0]
            np.add.at(matrix[cls], ids, 1.0)
    return matrix


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vg_dir", default="data/vg")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    with open(os.path.join(args.vg_dir, "vocab.json")) as f:
        vocab = json.load(f)
    m = build_matrix(
        os.path.join(args.vg_dir, "train.h5"),
        len(vocab["object_idx_to_name"]),
        len(vocab["attribute_idx_to_name"]),
    )
    out = args.out or os.path.join(args.vg_dir, "matrix_obj_vs_att.npy")
    np.save(out, m)
    print(f"saved {m.shape} co-occurrence counts -> {out} (total {int(m.sum())})")


if __name__ == "__main__":
    main()
