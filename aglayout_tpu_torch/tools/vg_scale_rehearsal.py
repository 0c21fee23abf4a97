"""Visual Genome-scale rehearsal of the data path: corpus -> ETL -> h5 ->
loader -> the training loop.

    python -m aglayout_tpu_torch.tools.vg_scale_rehearsal [--n_images 80000]
        [--steps 1000] [--batch_size 8] [--image_size 64] [--keep DIR]
        [--train_bench artifacts/torch_train_bench.json]
        [--out artifacts/torch_vg_scale_rehearsal.json] [--device cuda|cpu]

Builds the synthetic VG-shaped corpus of `data/bench_loader.build_corpus`
(JPEGs at VG's sizes, VG's JSON schema; the reference's train split holds
86,463 images), runs the port's ETL over it (`data/bench_loader.run_etl`,
the JAX tool's flags), builds the co-occurrence matrix from train.h5
(`data/cooccurrence.build_matrix`, as the reference's
evaluation/get_att_vs_obj_matrix.py), and trains `--steps` steps through
`train/loop.train` on the real loader (threaded decode, batch assembly,
pinned-memory prefetch; TensorBoard and checkpoints off; a log window
every 50 steps). It writes the steps/s reached by log window beside the
compute-only steps/s of the same configuration from `--train_bench`
(`tools/bench_train_table`'s output): the difference is what the loader
costs the loop. `--keep DIR` builds the
corpus in DIR (or reuses the one there) and keeps it; otherwise it is
built under build/ and deleted. Needs h5py and PIL.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_images", type=int, default=80_000)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--keep", default=None, help="reuse/keep corpus dir")
    p.add_argument("--train_bench",
                   default=os.path.join(REPO, "artifacts", "torch_train_bench.json"),
                   help="the compute-only rates (tools/bench_train_table's output)")
    p.add_argument("--out", default=os.path.join(REPO, "artifacts",
                                                 "torch_vg_scale_rehearsal.json"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host, for tests")
    return p


def main(argv=None, **overrides):
    """The rehearsal; `overrides` replace config fields (tests: widths, the
    log window). Returns the results."""
    import numpy as np

    from aglayout_tpu_torch.bench import card
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.bench_loader import build_corpus, run_etl
    from aglayout_tpu_torch.data.cooccurrence import build_matrix
    from aglayout_tpu_torch.train.loop import train
    from aglayout_tpu_torch.utils.device import require

    args = parser().parse_args(argv)
    device = require(args.device, "vg_scale_rehearsal")
    results = {"n_images": args.n_images, "steps": args.steps,
               "batch_size": args.batch_size, "image_size": args.image_size}

    build = os.path.join(REPO, "build")
    root = os.path.abspath(args.keep or os.path.join(build, "vg_rehearsal_corpus"))
    ckpt_dir = os.path.join(build, "vg_rehearsal_ckpt")
    try:
        if not os.path.exists(os.path.join(root, "train.h5")):
            print(f"building {args.n_images}-image corpus in {root} ...", flush=True)
            t0 = time.time()
            build_corpus(root, args.n_images)
            results["corpus_build_s"] = round(time.time() - t0, 1)
            t0 = time.time()
            run_etl(root)
            results["etl_s"] = round(time.time() - t0, 1)
            print(f"corpus {results['corpus_build_s']}s, ETL {results['etl_s']}s", flush=True)
        with open(os.path.join(root, "vocab.json")) as f:
            vocab = json.load(f)
        if not os.path.exists(os.path.join(root, "matrix_obj_vs_att.npy")):
            m = build_matrix(os.path.join(root, "train.h5"), len(vocab["object_idx_to_name"]),
                             len(vocab["attribute_idx_to_name"]))
            np.save(os.path.join(root, "matrix_obj_vs_att.npy"), m)

        shutil.rmtree(ckpt_dir, ignore_errors=True)
        cfg = config_for(args.image_size, **dict(
            dict(batch_size=args.batch_size,
                 vg_dir=root,
                 image_dir=os.path.join(root, "images"),
                 num_classes=len(vocab["object_idx_to_name"]),
                 attribute_dim=len(vocab["attribute_idx_to_name"]),
                 path=ckpt_dir,
                 save_step=10**9,  # no checkpoints in the timing window
                 tensorboard_step=10**9,
                 log_step=50),
            **overrides))
        rates = []
        t0 = time.time()
        _, metrics = train(cfg, niter=args.steps, use_tensorboard=False, window_rates=rates,
                           device=device)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        wall = time.time() - t0
        results["train_wall_s"] = round(wall, 1)
        results["steps_per_sec_incl_compile"] = round(args.steps / wall, 2)
        # steady state: the first two log windows hold the warm-up and the
        # loader's start; the rest are averaged
        steady = rates[2:] if len(rates) > 4 else rates
        if steady:
            results["steps_per_sec_steady"] = round(sum(steady) / len(steady), 2)
            results["steps_per_sec_steady_min"] = round(min(steady), 2)
            results["steps_per_sec_steady_max"] = round(max(steady), 2)
        results["final_G_loss"] = float(metrics["G/loss"])
        results["final_D_loss"] = float(metrics["D/loss"])
        # the compute-only rate of the same configuration (f32), if measured
        if os.path.exists(args.train_bench):
            with open(args.train_bench) as f:
                tb = json.load(f)
            key = f"steps_per_sec_{args.image_size}_b{args.batch_size}"
            if key in tb:
                results["compute_only_steps_per_sec"] = tb[key]
        results["card"] = card(device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
