"""Training evidence: train the GAN on a finite learnable synthetic corpus.

    python -m aglayout_tpu_torch.tools.train_evidence [--steps 3000] [--image_size 64]
        [--batch_size 8] [--corpus_batches 32] [--log_every 10] [--deterministic]
        [--out artifacts/torch_train_evidence] [--device cuda|cpu]

Runs `--steps` train steps of `train/step.py` (the reference's config at
`--image_size`, f32 with TF32 off, Adam 2e-4) over `--corpus_batches`
batches of `synthetic_scene_batch(RandomState(7), ...)`, whose images are
renders of their layouts, so that the losses have something to learn; the
corpus lives on the device and the steps cycle through it. With
`--deterministic` the steps run under torch's deterministic algorithms
(`utils/device.deterministic`), and two runs of one seed repeat themselves
bit for bit on the card (`tools/step_determinism`). The metrics come
to the host every `--log_every` steps. Then it writes, as the JAX package's
tools/train_evidence.py does:

  <out>/metrics.jsonl    the losses at each logged step
  <out>/loss_curves.png  D/G losses, reconstruction L1, latent losses
  <out>/samples.png      real | rec | rand, from the eval-mode forward
                         (the kernels on, on the card)
  <out>/summary.json     first and last windows of the reconstruction L1,
                         its reduction, the last metrics, steps/s, the card,
                         whether the steps were deterministic

and raises unless the last 10 % of the logged reconstruction L1 averages
below 0.7 of its first three logs. Runs on the card; `--device cpu` runs
the plain paths on the host (for tests; its steps/s is the host's).
Needs PIL.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--corpus_batches", type=int, default=32)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--deterministic", action="store_true",
                   help="the steps under torch.use_deterministic_algorithms(True)")
    p.add_argument("--out", default=os.path.join(REPO, "artifacts", "torch_train_evidence"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host, for tests")
    return p


def scene_corpus(cfg, corpus_batches: int, seed: int = 7):
    """(the corpus as numpy batches, the co-occurrence matrix), drawn from
    one RandomState(seed) in the JAX tool's order."""
    from aglayout_tpu_torch.data.synthetic import synthetic_cooccurrence, synthetic_scene_batch

    rng = np.random.RandomState(seed)
    corpus = [synthetic_scene_batch(rng, cfg.batch_size, cfg.max_objects, cfg.image_size,
                                    cfg.num_classes, cfg.attribute_dim)
              for _ in range(corpus_batches)]
    return corpus, synthetic_cooccurrence(rng, cfg.num_classes, cfg.attribute_dim)


def windows(values) -> tuple:
    """(first window, last window, reduction) of a run's logged values: the
    first 3 logs (before the fast initial descent) against the last 10 %."""
    k = max(1, len(values) // 10)
    first, last = float(np.mean(values[:3])), float(np.mean(values[-k:]))
    return first, last, 1.0 - last / first


def plot_losses(hist, path: str):
    """D/G losses, the reconstruction L1 and the latent losses by step."""
    from aglayout_tpu_torch.utils.plot import plot_panels

    steps = [m["step"] for m in hist]
    plot_panels([(title, "step", [(k, steps, [m[k] for m in hist], False) for k in keys])
                 for keys, title in ((["D/loss", "G/loss"], "adversarial losses"),
                                     (["G/rec_img"], "image reconstruction L1"),
                                     (["G/rec_z", "G/kl"], "latent losses"))],
                path, cols=3)


def sample_grid(cfg, g, batch, device, path: str):
    """real | rec | rand of the first 8 images, from the eval-mode forward
    (z and eps from a generator on the device seeded 123)."""
    import torch
    from PIL import Image

    from aglayout_tpu_torch.infer.generate import eval_forward, eval_mode, forward_draws
    from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch

    b, o = batch["objs"].shape
    z, eps = forward_draws(torch.Generator(device).manual_seed(123), b, o, cfg.z_dim, device)
    with torch.inference_mode(), eval_mode(g):
        out = eval_forward(g, batch, z, batch["attribute"], batch["attribute"], eps)
    real, rec, rand = (imagenet_deprocess_batch(x.float()).cpu().numpy()
                       for x in (batch["imgs"], out["img_rec"], out["img_rand"]))
    n, s = min(8, b), cfg.image_size
    grid = np.zeros((3 * s, n * s, 3), np.uint8)
    for j in range(n):
        grid[0:s, j * s:(j + 1) * s] = real[j]
        grid[s:2 * s, j * s:(j + 1) * s] = rec[j]
        grid[2 * s:, j * s:(j + 1) * s] = rand[j]
    Image.fromarray(grid).save(path)


def setup(args, what: str = "train_evidence", **overrides):
    """(device, cfg, the corpus on the device, a fresh state of seed
    `cfg.seed`, its train step) of a run of `args`; `overrides` narrow the
    config (tests)."""
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.data.vocab import attribute_pos_weight
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step
    from aglayout_tpu_torch.utils.device import require

    device = require(args.device, what)
    cfg = config_for(args.image_size, batch_size=args.batch_size, **overrides)
    corpus_np, matrix = scene_corpus(cfg, args.corpus_batches)
    corpus = [batch_to_torch(b, device) for b in corpus_np]
    pos_weight = (attribute_pos_weight() if cfg.attribute_dim == 106
                  else np.ones(cfg.attribute_dim, np.float32))
    state = create_train_state(cfg, device, seed=cfg.seed)
    return device, cfg, corpus, state, make_train_step(cfg, state.models, matrix, pos_weight)


def run(args, **overrides) -> dict:
    """Train, write the four files, return the summary (no check);
    `overrides` narrow the config (tests)."""
    import torch

    from aglayout_tpu_torch.bench import card
    from aglayout_tpu_torch.utils.device import deterministic, no_tf32

    if args.steps % args.log_every:
        raise ValueError(f"--steps {args.steps} is not a multiple of --log_every {args.log_every}")
    # entered before setup(): cuBLAS reads its workspace config at its first product
    with deterministic() if args.deterministic else contextlib.nullcontext():
        device, cfg, corpus, state, step = setup(args, **overrides)

        os.makedirs(args.out, exist_ok=True)
        hist = []
        t0 = time.time()
        with contextlib.nullcontext() if cfg.bf16 else no_tf32(), \
                open(os.path.join(args.out, "metrics.jsonl"), "w") as f:
            for i in range(args.steps):
                state, metrics = step(state, corpus[i % len(corpus)])
                if (i + 1) % args.log_every:
                    continue
                keys = sorted(k for k in metrics if k != "images")
                values = torch.stack([metrics[k].detach().float() for k in keys]).tolist()
                m = dict(zip(keys, values), step=i + 1)
                hist.append(m)
                f.write(json.dumps(m) + "\n")
                f.flush()
                if (i + 1) % 500 == 0:
                    print(f"step {i + 1}/{args.steps}  G={m['G/loss']:.3f} D={m['D/loss']:.3f} "
                          f"rec={m['G/rec_img']:.4f} ({(i + 1) / (time.time() - t0):.1f} steps/s)",
                          flush=True)
        wall = time.time() - t0

    plot_losses(hist, os.path.join(args.out, "loss_curves.png"))
    sample_grid(cfg, state.models.g, corpus[0], device, os.path.join(args.out, "samples.png"))

    first, last, reduction = windows([m["G/rec_img"] for m in hist])
    summary = {
        "steps": args.steps,
        "image_size": cfg.image_size,
        "batch_size": cfg.batch_size,
        "corpus_batches": args.corpus_batches,
        "rec_l1_first_window": first,
        "rec_l1_last_window": last,
        "rec_l1_reduction": reduction,
        "final": hist[-1],
        "steps_per_sec": args.steps / wall,
        "card": card(device),
        "deterministic": args.deterministic,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


def check(summary: dict):
    """Raise unless the last window's reconstruction L1 is below 0.7 of the
    first's."""
    first, last = summary["rec_l1_first_window"], summary["rec_l1_last_window"]
    if not last < 0.7 * first:
        raise AssertionError(f"reconstruction did not improve: {first} -> {last}")


def main(argv=None, **overrides):
    """The CLI; `overrides` narrow the config (tests). Returns the summary."""
    args = parser().parse_args(argv)
    summary = run(args, **overrides)
    check(summary)
    print(f"TRAINING EVIDENCE OK: reconstruction L1 fell {summary['rec_l1_first_window']:.4f} -> "
          f"{summary['rec_l1_last_window']:.4f} over {args.steps} steps")
    return summary


if __name__ == "__main__":
    main()
