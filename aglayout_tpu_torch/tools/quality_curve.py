"""Quality curve: train, and run the evaluation report on the live train
state every N steps.

    python -m aglayout_tpu_torch.tools.quality_curve --corpus DIR
        [--image_size 128] [--batch_size 8] [--steps 25000] [--eval_every 5000]
        [--eval_batches 8] [--[no-]eval_at_init] [--work_dir build/quality_curve_work]
        [--out artifacts/torch_quality_curve] [--device cuda|cpu]

Trains the reference's config on a corpus the port's ETL wrote (train.h5,
test.h5, vocab.json, matrix_obj_vs_att.npy, images/), as
`python -m aglayout_tpu_torch.train` does, and every `--eval_every` steps
(and at step 0 unless `--no-eval_at_init`) runs `eval/report.evaluate_run`
on the state in memory with the offline extractors over `--eval_batches`
batches of the val loader (test.h5, as the reference's), writing:

  <out>.json  one row of metrics an evaluation point, in the JAX package's
              envelope and with its keys
  <out>.png   FID proxy, IS proxy, diversity and consistency by step

The extractors are deterministic and the same at every point, so the
curve's movement is the signal; their absolute values are not comparable
with Inception-based FID and IS (each row names its extractor). Runs on
the card; `--device cpu` runs the plain paths on the host. The corpus
needs h5py.

Twin of the JAX package's tools/quality_curve.py, with two of its faults
repaired: `--eval_at_init` can be turned off, and the batch fetched ahead
of an evaluation point is trained on rather than dropped for a new one.
"""

from __future__ import annotations

import argparse
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NOTE = (
    "offline extractors (named per entry): absolute values are NOT comparable to published "
    "Inception-based FID/IS; the curve's relative movement across evaluation points is the "
    "quality signal. Inline eval of the live train state."
)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--corpus", required=True,
                   help="corpus dir with train.h5/test.h5/vocab.json/matrix_obj_vs_att.npy")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=25_000)
    p.add_argument("--eval_every", type=int, default=5_000)
    p.add_argument("--eval_batches", type=int, default=8)
    p.add_argument("--eval_at_init", action=argparse.BooleanOptionalAction, default=True,
                   help="evaluate the initial state as step 0 (--no-eval_at_init: do not)")
    p.add_argument("--work_dir", default=os.path.join(REPO, "build", "quality_curve_work"))
    p.add_argument("--out", default=os.path.join(REPO, "artifacts", "torch_quality_curve"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host, for tests")
    return p


def curve_row(step_no: int, rep: dict, wall_s: float) -> dict:
    """One evaluation point of the curve from an `evaluate_run` report."""
    return {
        "step": step_no,
        "fid_rand": rep["fid"]["rand"],
        "fid_shift": rep["fid"]["shift"],
        "fid_extractor": rep["fid"]["extractor"],
        "inception_score": rep["inception_score"]["mean"],
        "lpips_diversity": rep["lpips_diversity"]["mean"],
        "consistency_background_l1": rep["consistency"]["background_l1"],
        "consistency_foreground_l1": rep["consistency"]["foreground_l1"],
        "consistency_random_pair_l1": rep["consistency"]["random_pair_l1"],
        "attr_precision": rep["attributes"].get("average_precision"),
        "attr_recall": rep["attributes"].get("average_recall"),
        "edit_success_rate": rep["attributes"].get("edit_success_rate"),
        "eval_wall_s": round(wall_s, 1),
    }


def run_curve(cfg, state, step_fn, train_iter, data_factory, *, steps: int, eval_every: int,
              eval_batches: int, work_dir: str, device, eval_at_init: bool = True,
              on_row=None):
    """Train `state` for `steps` steps of `step_fn` on the batches of
    `train_iter` (tensors on `device`, one fetched ahead of each step), and
    run `evaluate_run` over `eval_batches` batches of `data_factory()` on
    the live state at step 0 (if `eval_at_init`) and every `eval_every`
    steps. `train_iter` is drawn once a step and no more. `on_row(row,
    curve)` is called after each evaluation point. Returns (state, curve)."""
    from aglayout_tpu_torch.eval.report import evaluate_run

    curve = []

    def eval_point(step_no, st):
        t0 = time.time()
        rep = evaluate_run(cfg, st.models, data_factory, os.path.join(work_dir, f"eval_{step_no}"),
                           device=device, max_batches=eval_batches, keep_pickles=False)
        row = curve_row(step_no, rep, time.time() - t0)
        curve.append(row)
        print("EVAL " + json.dumps(row), flush=True)
        if on_row is not None:
            on_row(row, curve)

    if eval_at_init:
        eval_point(0, state)
    pending = next(train_iter)
    t0 = time.time()
    for i in range(steps):
        batch = pending
        state, metrics = step_fn(state, batch)
        if i + 1 < steps:
            pending = next(train_iter)  # the one batch ahead, kept across an evaluation point
        if (i + 1) % 500 == 0:
            g, d = float(metrics["G/loss"]), float(metrics["D/loss"])
            print(f"step {i + 1}/{steps} G/loss={g:.3f} D/loss={d:.3f} "
                  f"{500 / (time.time() - t0):.2f} steps/s", flush=True)
            t0 = time.time()
        if (i + 1) % eval_every == 0:
            eval_point(i + 1, state)
            t0 = time.time()
    return state, curve


def write_curve(args, curve: list):
    """The curve in the JAX package's envelope, to <out>.json."""
    out = {
        "corpus": args.corpus,
        "image_size": args.image_size,
        "batch_size": args.batch_size,
        "steps": args.steps,
        "eval_every": args.eval_every,
        "eval_batches": args.eval_batches,
        "note": NOTE,
        "curve": curve,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=2)


def plot_curve(args, curve: list):
    """The FID proxy, IS proxy, diversity and background consistency (with
    the random-pair baseline) by step, to <out>.png."""
    from aglayout_tpu_torch.utils.plot import plot_panels

    xs = [r["step"] for r in curve]

    def series(key, label=None, dashed=False):
        return (label, xs, [r[key] for r in curve], dashed)

    plot_panels([
        ("FID proxy (real vs rand)", "train step", [series("fid_rand")]),
        ("IS proxy (rand)", "train step", [series("inception_score")]),
        ("perceptual diversity proxy", "train step", [series("lpips_diversity")]),
        ("background L1 (rand vs shift)", "train step",
         [series("consistency_background_l1"),
          series("consistency_random_pair_l1", "random-pair baseline", dashed=True)]),
    ], args.out + ".png", cols=2,
        title=f"{args.image_size}x{args.image_size} quality curve, b={args.batch_size}, corpus "
              f"{os.path.basename(os.path.normpath(args.corpus))} (offline extractors)")
    print("wrote", args.out + ".png", flush=True)


def main(argv=None, **overrides):
    """The CLI; `overrides` narrow the config (tests). Returns the curve."""
    import numpy as np

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.dataset import get_dataloaders
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.data.vocab import attribute_pos_weight
    from aglayout_tpu_torch.parallel import Group, make_sharded_train_step
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step
    from aglayout_tpu_torch.utils.device import require

    args = parser().parse_args(argv)
    device = require(args.device, "quality_curve")
    with open(os.path.join(args.corpus, "vocab.json")) as f:
        vocab = json.load(f)
    cfg = config_for(
        args.image_size,
        batch_size=args.batch_size,
        vg_dir=args.corpus,
        image_dir=os.path.join(args.corpus, "images"),
        num_classes=len(vocab["object_idx_to_name"]),
        attribute_dim=len(vocab["attribute_idx_to_name"]),
        path=args.work_dir,
        **overrides,
    )
    train_loader, val_loader, _ = get_dataloaders(cfg)

    def data_factory():
        return val_loader.epoch(0)

    state = create_train_state(cfg, device, seed=cfg.seed)
    matrix = np.load(os.path.join(args.corpus, "matrix_obj_vs_att.npy"))
    pos_weight = (attribute_pos_weight() if cfg.attribute_dim == 106
                  else np.ones(cfg.attribute_dim, np.float32))
    group = Group()  # one process: the identity
    step_fn = make_sharded_train_step(make_train_step(cfg, state.models, matrix, pos_weight),
                                      group)
    drop = ("masks", "masks_shift") if cfg.device_masks else ()
    train_iter = (batch_to_torch(group.rows({k: v for k, v in b.items() if k not in drop}),
                                 device) for b in train_loader)
    _, curve = run_curve(cfg, state, step_fn, train_iter, data_factory, steps=args.steps,
                         eval_every=args.eval_every, eval_batches=args.eval_batches,
                         work_dir=args.work_dir, device=device, eval_at_init=args.eval_at_init,
                         on_row=lambda row, curve: write_curve(args, curve))
    plot_curve(args, curve)
    return curve


if __name__ == "__main__":
    main()
