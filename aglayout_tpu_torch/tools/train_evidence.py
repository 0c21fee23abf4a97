"""Training evidence: train the GAN on a finite learnable synthetic corpus.

    python -m aglayout_tpu_torch.tools.train_evidence [--steps 3000] [--image_size 64]
        [--batch_size 8] [--corpus_batches 32] [--log_every 10] [--deterministic]
        [--tf32] [--segment_steps S --state_dir DIR]
        [--out artifacts/torch_train_evidence] [--device cuda|cpu]

Runs `--steps` train steps of `train/step.py` (the reference's config at
`--image_size`, f32, Adam 2e-4) over `--corpus_batches` batches of
`synthetic_scene_batch(RandomState(7), ...)`, whose images are renders of
their layouts, so that the losses have something to learn; the corpus
lives on the device and the steps cycle through it (batch = global step
modulo the corpus length). The steps multiply in f32 with TF32 off in
cuBLAS and cuDNN, or with `--tf32` on. With `--deterministic` the steps run
under torch's deterministic algorithms (`utils/device.deterministic`), and
two runs of one seed repeat themselves bit for bit on the card
(`tools/step_determinism`). On the card the step runs as one captured CUDA
graph (`train/graph.py`), which equals the eager step bit for bit in
deterministic mode; on the host it runs eagerly. The metrics come
to the host every `--log_every` steps.

A run can be cut into segments: with `--segment_steps S --state_dir DIR` it
stops after S more steps and saves the whole train state to DIR
(`utils/checkpoint.save_state`: nets, Adams, the draws' generator, the
step); the same command again resumes from the newest state there and
goes on. `metrics.jsonl` keeps its lines up to the saved step (a segment
cut short leaves lines past it, which are dropped), `progress.json` lists
each segment's steps, seconds, card and run arguments (`run_args`; a
resume whose arguments differ is refused, as is one whose segments do not
cover the steps up to the saved state), and a run of S + S steps in two
processes writes the same metrics and state as one of 2S steps. A run
given `--state_dir` saves its state there at its end as well; each
segment's entry is written before its state, so that a segment cut
between the two is dropped and run again whole. When the run
reaches `--steps` it writes, as the JAX package's tools/train_evidence.py
does:

  <out>/metrics.jsonl    the losses at each logged step
  <out>/loss_curves.png  D/G losses, reconstruction L1, latent losses
  <out>/samples.png      real | rec | rand, from the eval-mode forward
                         (the kernels on, on the card; f32, TF32 off)
  <out>/summary.json     first and last windows of the reconstruction L1,
                         its reduction, the last metrics, steps/s over
                         the segments, the card, whether the steps were
                         deterministic and used TF32, the segments, and
                         the kernel check: the samples' forward against
                         the same forward with every kernel route off

and raises unless the last 10 % of the logged reconstruction L1 averages
below 0.7 of its first three logs, and, on the card, unless the kernel
check is within `KERNEL_LIMIT` and launched each kernel of the path (and
the forward with the routes off launched none). Run
again once it has finished, it changes nothing. Runs on the card;
`--device cpu` runs the plain paths on the host (for tests; its steps/s is
the host's). Needs PIL.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNEL_LIMIT = 1e-4  # the port's f32 limit, relative to the plain forward's max
# the kernels of the eval forward, by image size (K2's flat-table mode under its own name)
PATH_KERNELS = {64: ("residual_trunk", "spade_few_out_conv")}
PATH_KERNELS[128] = PATH_KERNELS[64] + ("spade_few_out_conv8", "spade_apply8", "typed_c3_expand")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--corpus_batches", type=int, default=32)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--deterministic", action="store_true",
                   help="the steps under torch.use_deterministic_algorithms(True)")
    p.add_argument("--tf32", action="store_true",
                   help="TF32 in cuBLAS and cuDNN for the steps (default: f32 products)")
    p.add_argument("--segment_steps", type=int, default=0,
                   help="stop after this many more steps and save the state to --state_dir")
    p.add_argument("--state_dir", default=None,
                   help="save the state here at a segment's or the run's end, and resume from "
                        "the newest state here (about 1 GB at 128^2: keep it out of git)")
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


def sample_forward(cfg, g, batch, device):
    """The eval-mode forward of the sample grid on `batch` (z and eps from a
    generator on the device seeded 123), with the kernels wherever `g`'s
    routes take them: its outputs."""
    import torch

    from aglayout_tpu_torch.infer.generate import eval_forward, eval_mode, forward_draws

    b, o = batch["objs"].shape
    z, eps = forward_draws(torch.Generator(device).manual_seed(123), b, o, cfg.z_dim, device)
    with torch.inference_mode(), eval_mode(g):
        return eval_forward(g, batch, z, batch["attribute"], batch["attribute"], eps)


def sample_grid(cfg, batch, out, path: str):
    """real | rec | rand of the first 8 images of `out` (`sample_forward`)."""
    from PIL import Image

    from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch

    real, rec, rand = (imagenet_deprocess_batch(x.float()).cpu().numpy()
                       for x in (batch["imgs"], out["img_rec"], out["img_rand"]))
    n, s = min(8, batch["objs"].shape[0]), cfg.image_size
    grid = np.zeros((3 * s, n * s, 3), np.uint8)
    for j in range(n):
        grid[0:s, j * s:(j + 1) * s] = real[j]
        grid[s:2 * s, j * s:(j + 1) * s] = rec[j]
        grid[2 * s:, j * s:(j + 1) * s] = rand[j]
    Image.fromarray(grid).save(path)


def launch_counts() -> dict:
    """Launches so far by kernel wrapper (`spade_few_out_conv` by mode: its
    own name counts the flat-table launches)."""
    from aglayout_tpu_torch.ops import (
        conv8_int8,
        resblocks,
        spade_c6_int8,
        spade_conv,
        typed_expand,
    )

    fns = (resblocks.residual_trunk, spade_conv.spade_few_out_conv8, spade_conv.spade_apply8,
           spade_conv.spade_apply_t, typed_expand.typed_c3_expand, typed_expand.typed_c3_expand_v3,
           typed_expand.typed_c3_expand_v5, typed_expand.typed_c3_expand_v6,
           conv8_int8.conv_small_int8, spade_c6_int8.spade_c6_int8)
    counts = {f.__name__: f.launches for f in fns}
    for mode, n in spade_conv.spade_few_out_conv.mode_launches.items():
        counts["spade_few_out_conv" + ("" if mode == "flat" else f"[{mode}]")] = n
    return counts


@contextlib.contextmanager
def kernel_routes_off(g):
    """Every kernel switch of `g`'s modules off for the body (the plain
    paths), their values restored afterwards."""
    from aglayout_tpu_torch.bench import KERNEL_FLAGS

    saved = [(m, name, getattr(m, name)) for m in g.modules() for name in KERNEL_FLAGS.values()
             if hasattr(m, name)]
    for m, name, _ in saved:
        setattr(m, name, False)
    try:
        yield
    finally:
        for m, name, value in saved:
            setattr(m, name, value)


def samples_and_kernel_check(cfg, g, batch, device, path: str) -> dict:
    """Write the sample grid from the eval forward with the kernels on, and
    hold that forward against the same one with every kernel route off,
    both in f32 with TF32 off: per floating output, max |on - off| and
    mean |on - off| over max |off|; the launches of the forward with the
    kernels on by kernel; the kernels the path must launch (none on the
    host, where the wrappers take their plain versions). Raises if the
    forward with the routes off launched a kernel: the check would then
    hold a kernel against itself."""
    from aglayout_tpu_torch.utils.device import tf32

    def launched(before):
        return {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}

    with tf32(False):
        before = launch_counts()
        on = sample_forward(cfg, g, batch, device)
        launches, before = launched(before), launch_counts()
        with kernel_routes_off(g):
            off = sample_forward(cfg, g, batch, device)
        off_launches = launched(before)
    if off_launches:
        raise AssertionError(f"kernel check: the forward with every route off launched "
                             f"{off_launches}")
    sample_grid(cfg, batch, on, path)
    errs = {}
    for k, want in off.items():
        if not want.is_floating_point():
            continue
        diff, scale = (on[k].float() - want.float()).abs(), want.float().abs().max().item()
        errs[k] = (diff.max().item() / scale, diff.mean().item() / scale) if scale else (0.0, 0.0)
    worst = max(errs, key=lambda k: errs[k][0])
    return {"max_abs_err_over_max": errs[worst][0], "worst_output": worst,
            "mean_abs_err_over_max": max(e[1] for e in errs.values()), "limit": KERNEL_LIMIT,
            "launches": launches,
            "expected": list(PATH_KERNELS[cfg.image_size]) if device.type == "cuda" else []}


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


def _resumed_metrics(path: str, start: int, log_every: int) -> list:
    """The logged rows up to step `start` of a run being resumed there;
    rewrites `path` to hold just their lines (a segment cut short leaves
    lines past the saved step)."""
    lines = []
    if start and os.path.exists(path):
        with open(path) as f:
            lines = [line for line in f.read().splitlines()
                     if json.loads(line)["step"] <= start]
    rows = [json.loads(line) for line in lines]
    if [r["step"] for r in rows] != list(range(log_every, start + 1, log_every)):
        raise ValueError(f"{path} does not hold the logs up to step {start}, where the saved "
                         "state is: resume with the --out the state was written with")
    with open(path, "w") as f:
        f.writelines(line + "\n" for line in lines)
    return rows


def run_args(args, overrides: dict) -> dict:
    """What fixes a run's trajectory: the arguments a resume must repeat,
    and the config overrides (tests, seeds)."""
    keys = ("steps", "image_size", "batch_size", "corpus_batches", "log_every", "deterministic",
            "tf32", "device")
    return dict({k: getattr(args, k) for k in keys}, **overrides)


def check_tiling(segments: list, upto: int, path: str) -> None:
    """Raise unless `segments` run from step 0 to `upto`, each from where the
    last ended (a segment missing from `path` would leave its seconds out
    of steps/s)."""
    bounds = [(s["from_step"], s["to_step"]) for s in segments]
    edges = [0] + [b for _, b in bounds]
    if [a for a, _ in bounds] != edges[:-1] or edges[-1] != upto:
        raise ValueError(f"the segments {bounds} of {path} do not cover steps 0 to {upto}")


def _resumed_segments(path: str, start: int, argd: dict) -> list:
    """The segments of `progress.json` that end at or before `start`, the
    step of the state being resumed; raises unless they cover the steps up
    to it with the arguments `argd`."""
    segments = []
    if start and os.path.exists(path):
        with open(path) as f:
            segments = [s for s in json.load(f)["segments"] if s["to_step"] <= start]
    check_tiling(segments, start, path)
    for s in segments:
        if s.get("run_args") != argd:
            raise ValueError(f"the segment {s['from_step']}-{s['to_step']} of {path} ran with "
                             f"{s.get('run_args')}, this run has {argd}: resume with its "
                             "arguments")
    return segments


def run(args, **overrides):
    """Train from the newest state in `args.state_dir` (a fresh one if there
    is none) for a segment or to `args.steps`; at `args.steps` write the
    files and return the summary (no check), else return None.
    `overrides` narrow the config (tests)."""
    import torch

    from aglayout_tpu_torch.bench import card
    from aglayout_tpu_torch.train.graph import GraphedTrainStep
    from aglayout_tpu_torch.utils.checkpoint import restore_state, save_state
    from aglayout_tpu_torch.utils.device import deterministic, tf32

    if args.steps % args.log_every or args.segment_steps % args.log_every:
        raise ValueError(f"--steps {args.steps} and --segment_steps {args.segment_steps} must be "
                         f"multiples of --log_every {args.log_every}")
    if args.segment_steps and not args.state_dir:
        raise ValueError("--segment_steps needs a --state_dir to save the state to")
    metrics_path, progress_path, summary_path = (os.path.join(args.out, name) for name in (
        "metrics.jsonl", "progress.json", "summary.json"))
    argd = run_args(args, overrides)
    # entered before setup(): cuBLAS reads its workspace config at its first product
    with deterministic() if args.deterministic else contextlib.nullcontext():
        device, cfg, corpus, state, step = setup(args, **overrides)
        start = restore_state(args.state_dir, state, "l")[1] if args.state_dir else 0
        if start > args.steps:
            raise ValueError(f"the state in {args.state_dir} is at step {start}, past --steps")
        if start == args.steps and os.path.exists(summary_path):
            _resumed_segments(progress_path, start, argd)  # finished: nothing to do
            with open(summary_path) as f:
                return json.load(f)
        end = min(args.steps, start + args.segment_steps) if args.segment_steps else args.steps

        os.makedirs(args.out, exist_ok=True)
        segments = _resumed_segments(progress_path, start, argd)
        hist = _resumed_metrics(metrics_path, start, args.log_every)
        graphed = device.type == "cuda"
        t0 = time.time()
        with contextlib.nullcontext() if cfg.bf16 else tf32(args.tf32), \
                open(metrics_path, "a") as f:
            if graphed and end > start:  # captured under the steps' TF32 and determinism
                step = GraphedTrainStep(step, state, corpus[start % len(corpus)])
            for i in range(start, end):
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
                          f"rec={m['G/rec_img']:.4f} ({(i + 1 - start) / (time.time() - t0):.2f} "
                          "steps/s)", flush=True)
        wall = time.time() - t0

    if end > start:  # the segment's entry first: a state without it would lose its seconds
        segments.append({"from_step": start, "to_step": end, "seconds": wall,
                         "card": card(device), "graphed": graphed, "run_args": argd})
        with open(progress_path, "w") as f:
            json.dump({"steps": args.steps, "segments": segments}, f, indent=2)
        if args.state_dir:
            save_state(args.state_dir, end, state, save_num=1)
    if end < args.steps:
        print(f"segment done: step {end} of {args.steps} in {wall:.1f} s; the state is in "
              f"{args.state_dir}: run the same command again to resume", flush=True)
        return None

    check_tiling(segments, args.steps, progress_path)
    plot_losses(hist, os.path.join(args.out, "loss_curves.png"))
    kernel_check = samples_and_kernel_check(cfg, state.models.g, corpus[0], device,
                                            os.path.join(args.out, "samples.png"))

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
        "steps_per_sec": args.steps / sum(s["seconds"] for s in segments),
        "card": card(device),
        "deterministic": args.deterministic,
        "tf32": args.tf32,
        "segments": segments,
        "kernel_check": kernel_check,
    }
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


def check(summary: dict):
    """Raise unless the last window's reconstruction L1 is below 0.7 of the
    first's, and unless the kernel check launched every kernel it expects
    and stays within its limit."""
    first, last = summary["rec_l1_first_window"], summary["rec_l1_last_window"]
    if not last < 0.7 * first:
        raise AssertionError(f"reconstruction did not improve: {first} -> {last}")
    k = summary["kernel_check"]
    missing = [name for name in k["expected"] if not k["launches"].get(name)]
    if missing or not k["max_abs_err_over_max"] <= k["limit"]:
        raise AssertionError(f"kernel check: not launched {missing}, max |on - off| / max |off| "
                             f"{k['max_abs_err_over_max']:.3e} (limit {k['limit']})")


def main(argv=None, **overrides):
    """The CLI; `overrides` narrow the config (tests). Returns the summary,
    or None after a segment that did not reach `--steps`."""
    args = parser().parse_args(argv)
    summary = run(args, **overrides)
    if summary is None:
        return None
    check(summary)
    print(f"TRAINING EVIDENCE OK: reconstruction L1 fell {summary['rec_l1_first_window']:.4f} -> "
          f"{summary['rec_l1_last_window']:.4f} over {args.steps} steps")
    return summary


if __name__ == "__main__":
    main()
