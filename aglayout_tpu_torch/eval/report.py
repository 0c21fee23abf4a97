"""One-command evaluation report over a trained run: the twin of
`aglayout_tpu/eval/report.py`.

    python -m aglayout_tpu_torch.eval.report --path checkpoints --image_size 64

drives one generation pass and produces a single `report.json` with every
metric the reference's scattered evaluation/*.py scripts compute in
sequence (fid.py:361-386, compute_inception_score.py:111-148,
consistency.py:155-211, PerceptualSimilarity diversity, plus test.py's
attribute precision/recall + edit success):

  * fid_rand / fid_shift  — real vs generated Fréchet distance
  * inception_score       — over the generated (random-z) images
  * lpips_diversity       — mean perceptual distance between two z-samples
                            of the SAME layout (higher = more diverse)
  * consistency           — background/foreground L1 between rand and
                            shifted generations + random-pair baseline
  * attributes            — per-object attribute P/R + edit success rate

Extractors: real InceptionV3 / LPIPS-AlexNet when weight files are given
(--inception_weights / --alexnet_weights + --lpips_weights), otherwise the
labeled offline stand-ins (pixel-projection FID, random-feature IS,
random-pyramid perceptual distance) — each report entry carries the
extractor name so the two regimes can never be confused. The generator,
the attribute D and the metric networks run on the device (CUDA unless
`--device cpu`); the statistics are host numpy, as JAX's host numpy and scipy.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _deprocess_u8(imgs) -> np.ndarray:
    import torch

    from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch

    return imagenet_deprocess_batch(torch.as_tensor(imgs)).cpu().numpy()


def evaluate_run(
    cfg,
    models,
    data_factory,
    out_dir: str,
    *,
    device,
    max_batches: int = 5,
    seed: int = 0,
    inception_weights: str | None = None,
    alexnet_weights: str | None = None,
    lpips_weights: str | None = None,
    keep_pickles: bool = True,
    draws: dict | None = None,
) -> dict:
    """Run the full metric suite; returns (and writes) the report dict.

    models: the generator `g` and attribute discriminator `d_att` (a train
    state's `Models`) on `device`. `data_factory()` must return a fresh
    batch iterator each call (the attribute pass re-drives the loader from
    the start so its P/R is computed on the same samples as the
    distribution metrics). draws: None (from `torch.Generator(device)`s
    seeded with `seed`, `seed + 1` and `seed`) or the three passes' draws,
    one dict a batch each (for tests: JAX's): "pickles" with "z", "eps";
    "diversity" with "z", "eps", "z2", "eps2"; "attributes" as
    `run_inference` takes them.
    """
    import glob
    import pickle

    import torch

    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.eval.consistency import (
        box_masks,
        consistency_l1,
        random_pair_baseline,
    )
    from aglayout_tpu_torch.eval.fid import compute_statistics, frechet_distance, make_extractor
    from aglayout_tpu_torch.eval.gen_pickle import dump_generation_pickles
    from aglayout_tpu_torch.eval.inception_score import (
        RandomFeatureClassifier,
        inception_score_from_probs,
    )
    from aglayout_tpu_torch.eval.lpips import distance_fn
    from aglayout_tpu_torch.infer.generate import (
        eval_forward,
        eval_mode,
        forward_draws,
        given_draws,
        run_inference,
    )
    from aglayout_tpu_torch.utils.device import no_tf32

    os.makedirs(out_dir, exist_ok=True)
    report: dict = {"config": {"image_size": cfg.image_size, "max_batches": max_batches}}

    # -- 1. one generation pass -> pickles (real/rand/shift + layout) -------
    pkl_dir = os.path.join(out_dir, "pickles")
    dump_generation_pickles(
        cfg, models, data_factory(), pkl_dir, max_batches=max_batches, seed=seed, device=device,
        draws=draws and draws["pickles"],
    )
    real, rand, shift, boxes, boxes_shift, valid = [], [], [], [], [], []
    for f in sorted(glob.glob(os.path.join(pkl_dir, "batch_*.pkl"))):
        with open(f, "rb") as fh:
            rec = pickle.load(fh)
        real.append(rec["imgs"])
        rand.append(rec["imgs_rand"])
        shift.append(rec["imgs_shift"])
        boxes.append(rec["boxes"])
        boxes_shift.append(rec["boxes_shift"])
        valid.append(rec["valid"])
    real_n = np.concatenate(real)
    rand_n = np.concatenate(rand)
    shift_n = np.concatenate(shift)
    real_u8 = _deprocess_u8(real_n)
    rand_u8 = _deprocess_u8(rand_n)
    shift_u8 = _deprocess_u8(shift_n)

    # -- 2. FID (real vs rand, real vs shift) --------------------------------
    extractor = make_extractor(
        "inception" if inception_weights else "pixel", weights=inception_weights, device=device
    )
    mu_r, s_r = compute_statistics(extractor(real_u8))
    mu_g, s_g = compute_statistics(extractor(rand_u8))
    mu_s, s_s = compute_statistics(extractor(shift_u8))
    report["fid"] = {
        "rand": frechet_distance(mu_r, s_r, mu_g, s_g),
        "shift": frechet_distance(mu_r, s_r, mu_s, s_s),
        "extractor": extractor.name,
        "n_images": int(len(real_u8)),
    }

    # -- 3. Inception Score over the generated images ------------------------
    if inception_weights:
        logits = extractor.logits(rand_u8)  # the same network, its classifier
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
        is_name = "inception-v3 logits"
    else:
        probs = RandomFeatureClassifier(num_classes=cfg.num_classes, seed=0)(rand_u8)
        is_name = RandomFeatureClassifier.name
    splits = min(3, max(1, len(probs) // 2))
    is_mean, is_std = inception_score_from_probs(probs, splits=splits)
    report["inception_score"] = {
        "mean": is_mean, "std": is_std, "splits": splits, "classifier": is_name,
    }

    # -- 4. LPIPS-form diversity: two z draws on the same layouts ------------
    dist_fn, div_name = distance_fn(alexnet_weights, lpips_weights, device=device)
    gen = torch.Generator(device).manual_seed(seed + 1)
    dists = []
    with torch.inference_mode(), eval_mode(models.g):
        for bi, batch_np in enumerate(data_factory()):
            if bi >= max_batches:
                break
            batch = batch_to_torch(batch_np, device)
            b, o = batch_np["objs"].shape
            if draws is None:
                (z1, e1), (z2, e2) = (forward_draws(gen, b, o, cfg.z_dim, device)
                                      for _ in range(2))
            else:
                z1, e1, z2, e2 = given_draws(draws["diversity"], bi, ("z", "eps", "z2", "eps2"),
                                             device)
            x1, x2 = (eval_forward(models.g, batch, z, batch["attribute"], batch["attribute"],
                                   e)["img_rand"] for z, e in ((z1, e1), (z2, e2)))
            # perceptual inputs are [-1,1]-range pixels
            u1, u2 = (torch.from_numpy(_deprocess_u8(x).astype(np.float32) / 127.5 - 1.0)
                      .to(device) for x in (x1, x2))
            with no_tf32():
                dists.append(dist_fn(u1, u2).cpu().numpy())
    d = np.concatenate(dists)
    report["lpips_diversity"] = {
        "mean": float(d.mean()), "std": float(d.std()), "pairs": int(len(d)),
        "backbone": div_name,
    }

    # -- 5. consistency (from the pickled generations) ------------------------
    np_rng = np.random.RandomState(0)
    agg = {"background_l1": [], "foreground_l1": [], "random_pair_l1": []}
    h, w = rand_n.shape[1:3]
    for bx, bxs, vld, ir, ish in zip(boxes, boxes_shift, valid, rand, shift):
        stats = consistency_l1(ir, ish, box_masks(bx, h, w, device=device),
                               box_masks(bxs, h, w, device=device), vld)
        agg["background_l1"].append(stats["background_l1"])
        agg["foreground_l1"].append(stats["foreground_l1"])
        agg["random_pair_l1"].append(random_pair_baseline(ir, np_rng))
    report["consistency"] = {k: float(np.mean(v)) for k, v in agg.items()}

    # -- 6. attribute P/R + edit success (test.py protocol) -------------------
    report["attributes"] = run_inference(
        cfg, models, data_factory(), os.path.join(out_dir, "attr"), device=device,
        max_batches=max_batches, save_images=False, seed=seed,
        draws=draws and draws["attributes"],
    )

    if not keep_pickles:
        import shutil

        shutil.rmtree(pkl_dir, ignore_errors=True)

    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, default=64, choices=[64, 128])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--vg_dir", type=str, default="data/vg")
    p.add_argument("--path", type=str, default="checkpoints")
    p.add_argument("--resume", type=str, default="l")
    p.add_argument("--max_batches", type=int, default=50)
    p.add_argument("--out_dir", default=None, help="default: <results>/eval_report")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--inception_weights", default=None)
    p.add_argument("--alexnet_weights", default=None)
    p.add_argument("--lpips_weights", default=None)
    # width/debug knobs (must match the checkpoint being evaluated)
    p.add_argument("--conv_dim", type=int, default=64)
    p.add_argument("--d_conv_dim", type=int, default=64)
    p.add_argument("--clstm_layers", type=int, default=3)
    p.add_argument("--max_objects", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.train.loop import prepare_dirs
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.utils.checkpoint import restore_state
    from aglayout_tpu_torch.utils.device import require

    device = require(args.device, "report")
    cfg = config_for(
        args.image_size,
        batch_size=args.batch_size,
        vg_dir=args.vg_dir,
        path=args.path,
        conv_dim=args.conv_dim,
        d_conv_dim=args.d_conv_dim,
        clstm_layers=args.clstm_layers,
        max_objects=args.max_objects,
    )

    if args.synthetic:
        from aglayout_tpu_torch.test import synthetic_loader

        def data_factory():
            return synthetic_loader(cfg)
    else:
        from aglayout_tpu_torch.data.dataset import get_dataloaders

        _, val_loader, vocab = get_dataloaders(cfg)
        cfg.num_classes = len(vocab["object_idx_to_name"])

        def data_factory():
            return val_loader.epoch(0)

    state = create_train_state(cfg, device)
    dirs = prepare_dirs(cfg)
    state, step = restore_state(dirs["models"], state, args.resume)
    print(f"restored checkpoint at step {step}")

    out_dir = args.out_dir or os.path.join(dirs["results"], "eval_report")
    report = evaluate_run(
        cfg, state.models, data_factory, out_dir,
        device=device,
        max_batches=args.max_batches,
        inception_weights=args.inception_weights,
        alexnet_weights=args.alexnet_weights,
        lpips_weights=args.lpips_weights,
    )
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
