"""Position-consistency evaluation: the twin of `aglayout_tpu/eval/consistency.py`.

Capability parity with the reference's evaluation/consistency.py (:155-211):
for each sample, L1 distance between img_rand and img_shift over

  * background: pixels outside the union of the original and shifted
    object masks (should be identical — the background must not change when
    an object is moved), and
  * foreground: pixels inside the union,

plus a random-pair baseline (L1 between img_rand of different samples) to
calibrate the scale. Lower background L1 = better consistency. The metrics
are numpy on the host, as JAX's; the generator runs on the device.
"""

from __future__ import annotations

import numpy as np


def consistency_l1(img_rand, img_shift, masks, masks_shift, valid):
    """img_*: (B, H, W, 3); masks: (B, O, H, W, 1); valid: (B, O).

    Returns dict of per-batch mean background/foreground L1.
    """
    img_rand = np.asarray(img_rand, np.float32)
    img_shift = np.asarray(img_shift, np.float32)
    v = np.asarray(valid)[:, :, None, None, None]
    union = ((np.asarray(masks) * v + np.asarray(masks_shift) * v).sum(1) > 0).astype(np.float32)
    diff = np.abs(img_rand - img_shift).mean(-1, keepdims=True)  # (B,H,W,1)
    bg = (diff * (1 - union)).sum((1, 2, 3)) / np.maximum((1 - union).sum((1, 2, 3)), 1)
    fg = (diff * union).sum((1, 2, 3)) / np.maximum(union.sum((1, 2, 3)), 1)
    return {
        "background_l1": float(bg.mean()),
        "foreground_l1": float(fg.mean()),
    }


def random_pair_baseline(imgs, rng: np.random.RandomState | None = None):
    """Mean L1 between randomly paired different images (reference baseline)."""
    rng = rng or np.random.RandomState(0)
    imgs = np.asarray(imgs, np.float32)
    perm = rng.permutation(len(imgs))
    # ensure derangement-ish pairing
    perm = np.where(perm == np.arange(len(imgs)), (perm + 1) % len(imgs), perm)
    return float(np.abs(imgs - imgs[perm]).mean())


def box_masks(boxes, h: int, w: int, *, device) -> np.ndarray:
    """(B, O, 4) numpy boxes -> (B, O, h, w, 1) f32 numpy masks, rasterized
    on `device` (the port's `ops/rasterize.rasterize_boxes`)."""
    import torch

    from aglayout_tpu_torch.ops.rasterize import rasterize_boxes

    bx = torch.from_numpy(np.asarray(boxes, np.float32)).to(device)
    return rasterize_boxes(bx, h, w).cpu().numpy()[..., None]


def evaluate_consistency(cfg, models, loader, max_batches: int = 50, seed: int = 0, *,
                         device, draws=None):
    """Drive the generator (`models.g`, on `device`) over a loader in eval
    mode and accumulate consistency stats; z and eps from a
    `torch.Generator(device)` seeded with `seed`, or given in `draws` (one
    dict a batch with "z" and "eps")."""
    import torch

    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.infer.generate import (
        check_no_grad,
        eval_forward,
        eval_mode,
        forward_draws,
        given_draws,
    )

    gen = torch.Generator(device).manual_seed(seed)
    np_rng = np.random.RandomState(seed)
    agg = {"background_l1": [], "foreground_l1": [], "random_pair_l1": []}
    with torch.inference_mode(), eval_mode(models.g):
        for bi, batch_np in enumerate(loader):
            if bi >= max_batches:
                break
            batch = batch_to_torch(batch_np, device)
            b, o = batch_np["objs"].shape
            if draws is None:
                z, eps = forward_draws(gen, b, o, cfg.z_dim, device)
            else:
                z, eps = given_draws(draws, bi, ("z", "eps"), device)
            out = eval_forward(models.g, batch, z, batch["attribute"], batch["attribute"], eps)
            if bi == 0:
                check_no_grad(out)
            img_rand = out["img_rand"].float().cpu().numpy()
            stats = consistency_l1(
                img_rand, out["img_shift"].float().cpu().numpy(), batch_np["masks"],
                batch_np["masks_shift"], batch_np["valid"],
            )
            agg["background_l1"].append(stats["background_l1"])
            agg["foreground_l1"].append(stats["foreground_l1"])
            agg["random_pair_l1"].append(random_pair_baseline(img_rand, np_rng))
    return {k: float(np.mean(v)) for k, v in agg.items()}


def main(argv=None):
    """Standalone entry over generation pickles (reference
    evaluation/consistency.py ran as its own script): masks are
    re-rasterized from the pickled boxes/boxes_shift."""
    import argparse
    import glob
    import json
    import os
    import pickle

    from aglayout_tpu_torch.utils.device import require

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pickle_dir", help="directory of batch_*.pkl from eval.gen_pickle")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: rasterize the masks on the host")
    args = p.parse_args(argv)
    device = require(args.device, "consistency")

    files = sorted(glob.glob(os.path.join(args.pickle_dir, "batch_*.pkl")))
    if args.max_batches:
        files = files[: args.max_batches]
    if not files:
        raise SystemExit(f"no batch_*.pkl under {args.pickle_dir}")
    rng = np.random.RandomState(0)
    agg = {"background_l1": [], "foreground_l1": [], "random_pair_l1": []}
    for f in files:
        with open(f, "rb") as fh:
            rec = pickle.load(fh)
        h, w = rec["imgs_rand"].shape[1:3]
        stats = consistency_l1(
            rec["imgs_rand"], rec["imgs_shift"], box_masks(rec["boxes"], h, w, device=device),
            box_masks(rec["boxes_shift"], h, w, device=device), rec["valid"]
        )
        agg["background_l1"].append(stats["background_l1"])
        agg["foreground_l1"].append(stats["foreground_l1"])
        agg["random_pair_l1"].append(random_pair_baseline(rec["imgs_rand"], rng))
    out = {k: float(np.mean(v)) for k, v in agg.items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
