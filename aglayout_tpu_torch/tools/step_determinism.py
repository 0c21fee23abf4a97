"""Whether two training runs from one seed repeat themselves, bit for bit.

    python -m aglayout_tpu_torch.tools.step_determinism [--mode default|deterministic]
        [--steps 50] [--check_at 10 50] [--image_size 64] [--tf32] [--seed 0]
        [--batch_size 8] [--corpus_batches 32] [--out FILE] [--device cuda|cpu]

Two runs of `--steps` train steps, each from a fresh state of the same seed
(`--seed`, the config's, as `train_evidence --seed`),
at `train_evidence`'s set-up (the reference's config at `--image_size`, f32
with TF32 off, or with `--tf32` on, the scene corpus), in torch's default mode or (`--mode
deterministic`) under `torch.use_deterministic_algorithms(True,
warn_only=True)` with `CUBLAS_WORKSPACE_CONFIG=:4096:8` set before the
first cuBLAS call. After each step of `--check_at` it takes a SHA-256 of
every net's `state_dict`, Adam's moments and counts, the draws' generator
and the step's metrics, and holds
the second run's params against the first's. Each run's ms/step is the mean
of its steps' CUDA-event times after the first `WARMUP`.
In deterministic mode it lists the ops that warned that they have no
deterministic CUDA form (warn_only lets them run, so the runs complete).

Prints one JSON object (and writes it to `--out`): per run its ms/step and
fingerprints, whether the runs are bit-equal at each checked step, the
largest param difference there and the first `NAMES` of the tensors that
differ (`differ`: nets' `state_dict` entries, Adam state, the draws'
generator, metrics), the warning ops, the card and the versions. Run the modes as separate processes, in turns, to time them.

On the card the second run takes the step captured as one CUDA graph
(`train/graph.py`), so the two runs hold the graphed step against the
eager one, and their ms/step stand side by side (the graph's warm-up and
capture come before its first timed step); on the host both are eager.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import time
import warnings

WARMUP = 5  # steps left out of a run's ms/step
NAMES = 20  # the differing tensors named at a checked step


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="default", choices=["default", "deterministic"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--check_at", type=int, nargs="+", default=[10, 50])
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--corpus_batches", type=int, default=32)
    p.add_argument("--tf32", action="store_true", help="TF32 in cuBLAS and cuDNN for the steps")
    p.add_argument("--seed", type=int, default=0,
                   help="the config's seed: the fresh states' weights and the steps' draws")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host, for tests")
    return p


def fingerprint(state, metrics) -> str:
    """SHA-256 of every net's `state_dict`, Adam's moments and counts, the
    draws' generator and the metrics."""
    h = hashlib.sha256()
    for name, module in state.models.items():
        for t in module.state_dict().values():
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        for s in state.opt[name].state.values():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                h.update(s[k].cpu().numpy().tobytes())
    h.update(state.rng.get_state().numpy().tobytes())
    for k in sorted(k for k in metrics if k != "images"):
        h.update(metrics[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def digests(state, metrics) -> dict:
    """{name: SHA-256} of each tensor that `fingerprint` hashes."""
    def sha(t):
        return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()

    out = {}
    for name, module in state.models.items():
        out.update({f"{name}.{k}": sha(t) for k, t in module.state_dict().items()})
        for i, s in enumerate(state.opt[name].state.values()):
            out.update({f"opt.{name}.{i}.{k}": sha(s[k]) for k in ("exp_avg", "exp_avg_sq", "step")})
    out["rng"] = sha(state.rng.get_state())
    out.update({f"metric.{k}": sha(metrics[k]) for k in sorted(k for k in metrics if k != "images")})
    return out


def one_run(args, overrides, graphed: bool = False) -> dict:
    """One run of `args.steps` steps from a fresh state, eager or
    `graphed`: its ms/step, its fingerprints and params (on the host) at
    `args.check_at`, the ops that warned."""
    import torch

    from aglayout_tpu_torch.tools.train_evidence import setup
    from aglayout_tpu_torch.train.graph import GraphedTrainStep
    from aglayout_tpu_torch.utils.device import tf32

    device, cfg, corpus, state, step = setup(args, "step_determinism", **overrides)
    cuda = device.type == "cuda"
    times, prints, params, ops, tensors = [], {}, {}, set(), {}
    with tf32(args.tf32), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if graphed:
            step = GraphedTrainStep(step, state, corpus[0])
        for i in range(args.steps):
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            else:
                t0 = time.perf_counter()
            state, metrics = step(state, corpus[i % len(corpus)])
            if cuda:
                ev[1].record()
                times.append(ev)
            else:
                times.append(1e3 * (time.perf_counter() - t0))
            if i + 1 in args.check_at:
                prints[i + 1] = fingerprint(state, metrics)
                tensors[i + 1] = digests(state, metrics)
                params[i + 1] = [p.detach().cpu().clone() for _, m in state.models.items()
                                 for p in m.parameters()]
    if cuda:
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in times]
    for w in caught:
        m = re.match(r"(\S+) does not have a deterministic implementation", str(w.message))
        if m:
            ops.add(m.group(1))
    timed = times[min(WARMUP, len(times) - 1):]
    return {"ms_per_step": sum(timed) / len(timed), "fingerprints": prints,
            "params": params, "digests": tensors, "nondeterministic_ops": sorted(ops)}


def measure(args, **overrides) -> dict:
    """Two runs in `args.mode`; `overrides` narrow the config (tests)."""
    import torch

    from aglayout_tpu_torch.bench import card
    from aglayout_tpu_torch.utils.device import deterministic

    if "seed" in overrides:
        raise ValueError("the seed is --seed, not a config override")
    overrides = dict(overrides, seed=args.seed)
    with (deterministic(warn_only=True) if args.mode == "deterministic"
          else contextlib.nullcontext()):
        runs = [one_run(args, overrides, graphed) for graphed in (False, args.device == "cuda")]
    a, b = runs
    out = {
        "mode": args.mode,
        "steps": args.steps,
        "image_size": args.image_size,
        "batch_size": args.batch_size,
        "tf32": args.tf32,
        "seed": args.seed,
        "runs": ["eager", "graphed" if args.device == "cuda" else "eager"],
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "ms_per_step": [r["ms_per_step"] for r in runs],
        "fingerprints": {str(k): [r["fingerprints"][k] for r in runs] for k in args.check_at},
        "bit_equal": {str(k): a["fingerprints"][k] == b["fingerprints"][k]
                      for k in args.check_at},
        "max_param_diff": {str(k): max((p - q).abs().max().item()
                                       for p, q in zip(a["params"][k], b["params"][k]))
                           for k in args.check_at},
        "differ": {str(k): [n for n, h in a["digests"][k].items()
                            if b["digests"][k][n] != h][:NAMES] for k in args.check_at},
        "nondeterministic_ops": sorted(set(a["nondeterministic_ops"])
                                       | set(b["nondeterministic_ops"])),
        "card": card(args.device),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


def main(argv=None, **overrides):
    return measure(parser().parse_args(argv), **overrides)


if __name__ == "__main__":
    main()
