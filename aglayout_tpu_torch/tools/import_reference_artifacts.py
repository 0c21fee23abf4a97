"""Import the reference repository's runtime artifacts into a data directory.

    python -m aglayout_tpu_torch.tools.import_reference_artifacts \
        --vocab /path/to/reference/data/vocab.json \
        --matrix /path/to/reference/matrix_obj_vs_att.pt --out data/vg

Users of the reference (ubc-vision/attribute-guided-image-generation-from-
layout) have `data/vocab.json` (179 objects, 106 attributes, 46
predicates) and `matrix_obj_vs_att.pt` (the object-attribute co-occurrence
counts of its evaluation/get_att_vs_obj_matrix.py). This writes
<out>/vocab.json (checked, passed through with the same schema) and
<out>/matrix_obj_vs_att.npy (the form `train/loop.load_cooccurrence`
reads), the same bytes as the JAX package's tool writes. With the
reference's train/test/val h5 files (or the port's ETL output) a run is
comparable with the reference's without running the ETL again. No device
is used.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

VOCAB_KEYS = [
    "object_name_to_idx",
    "object_idx_to_name",
    "attribute_name_to_idx",
    "attribute_idx_to_name",
    "pred_name_to_idx",
    "pred_idx_to_name",
]


def import_vocab(path: str, out_dir: str) -> dict:
    """Check the vocabulary at `path` (every key, each name's index both
    ways; index 0 may be a sentinel alias) and write it to out_dir/vocab.json."""
    with open(path) as f:
        vocab = json.load(f)
    missing = [k for k in VOCAB_KEYS if k not in vocab]
    if missing:
        raise ValueError(f"{path} lacks vocab keys {missing}")
    for kind in ("object", "attribute", "pred"):
        names = vocab[f"{kind}_idx_to_name"]
        fwd = vocab[f"{kind}_name_to_idx"]
        bad = [n for i, n in enumerate(names) if fwd.get(n) != i]
        if bad[1:]:  # index 0 may be an __image__ / __in_image__ sentinel alias
            raise ValueError(f"inconsistent {kind} vocab entries: {bad[:5]}")
    out = os.path.join(out_dir, "vocab.json")
    with open(out, "w") as f:
        json.dump(vocab, f)
    print(
        f"vocab: {len(vocab['object_idx_to_name'])} objects, "
        f"{len(vocab['attribute_idx_to_name'])} attributes, "
        f"{len(vocab['pred_idx_to_name'])} predicates -> {out}"
    )
    return vocab


def import_matrix(path: str, out_dir: str, vocab: dict | None, unsafe: bool = False) -> np.ndarray:
    """The 2-D matrix saved at `path` (a tensor or array) as f32, its shape
    checked against `vocab` when given, written to out_dir/matrix_obj_vs_att.npy."""
    import torch

    # the reference checkout is untrusted: weights_only=True unpickles
    # plain tensors and nothing else; --unsafe opts into full unpickling
    if unsafe:
        print("WARNING: --unsafe unpickles arbitrary objects from", path)
    m = torch.load(path, map_location="cpu", weights_only=not unsafe)
    if hasattr(m, "numpy"):
        m = m.numpy()
    m = np.asarray(m, np.float32)
    if m.ndim != 2:
        raise ValueError(f"expected a 2-D co-occurrence matrix, got {m.shape}")
    if vocab is not None:
        want = (len(vocab["object_idx_to_name"]), len(vocab["attribute_idx_to_name"]))
        if m.shape != want:
            raise ValueError(f"matrix shape {m.shape} != vocab sizes {want}")
    out = os.path.join(out_dir, "matrix_obj_vs_att.npy")
    np.save(out, m)
    print(f"co-occurrence matrix {m.shape} (sum {m.sum():.0f}) -> {out}")
    return m


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vocab", default=None, help="reference data/vocab.json")
    p.add_argument("--matrix", default=None, help="reference matrix_obj_vs_att.pt")
    p.add_argument("--out", required=True, help="target data dir (cfg.vg_dir)")
    p.add_argument("--unsafe", action="store_true",
                   help="allow full (arbitrary-object) unpickling of --matrix; by default only "
                   "plain tensors load (torch.load weights_only=True)")
    args = p.parse_args(argv)
    if not args.vocab and not args.matrix:
        p.error("nothing to import: pass --vocab and/or --matrix")
    os.makedirs(args.out, exist_ok=True)
    vocab = import_vocab(args.vocab, args.out) if args.vocab else None
    if args.matrix:
        import_matrix(args.matrix, args.out, vocab, unsafe=args.unsafe)


if __name__ == "__main__":
    main()
