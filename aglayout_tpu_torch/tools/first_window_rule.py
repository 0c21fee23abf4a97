"""The 64^2 first window on the step before and after its capture as a
CUDA graph, and the rule that decides whether the change of step moved it.

    python -m aglayout_tpu_torch.tools.first_window_rule [--faithfulness]

Commit 7db85a4 (`BASE`) ran the train step eagerly with torch's plain Adam
and `F.avg_pool2d`; commit a044d8d (`CHANGE`) captured it as one CUDA graph
and, on the way, changed five files of its path: three constants made
without a host-to-device copy (`KEEP_BITS`, meant to keep the bits), Adam
made capturable (`ADAM`: its count and bias corrections on the device in
f32) and the discriminators' 2x2 pool made a reshape and a mean (`POOL`).
The sets of `SETS` (`tools/first_window`, 64^2, B=8, deterministic, TF32
off, on the card) run each on a tree of `BASE` or `CURRENT` with some of
those files taken from `CHANGE`, or on this checkout
(`tools/first_window_sets`), and land in `DIR`, one file a set.

The rule, fixed before any set was run. The current step (`NEW`) is at
fault if

  1. (faithfulness, measured on the card by `--faithfulness`) the
     capturable Adam, eager or replayed from a CUDA graph, ends farther
     than `ADAM_BOUND` lr from `adam_reference` (optax's f32 Adam) after
     `ADAM_STEPS` steps, or farther than `ADAM_RATIO` times the plain Adam
     on the same inputs; or `avg_pool2` is farther than `POOL_ATOL` from
     `F.avg_pool2d`, or its gradient differs, at a shape the 64^2 step
     pools;
  2. (the distribution moved) with the old step's windows A0 and A0+ and
     the current step's A1 and A1+ (seeds 0-31 each), d = mean(new) -
     mean(old), s = sqrt(sd_new^2 / 32 + sd_old^2 / 32) (sample standard
     deviations), |d| > `Z` s;
  3. (against JAX) JAX's five first windows (its host seeds 0-3 and its
     TPU seed 0) and the current step's 32: JAX's mean outside the port's
     range, or the port's mean outside JAX's range;

and otherwise a draw. A fault is located: the change that fails check 1
(`POOL`, whose set also moves the mean most) runs to 32 seeds
(`LOCATED`), with check 2 against the old step; the change is repaired
in the port, and the repaired step (`REPAIRED`, seeds 0-31) is judged by
the same three checks. Beside the rule, not part of it: the
bit-equalities that show what each set ran (A0 against card_64.json, A1
against card_64_graphed.json, B0 against A0, B12 against A1, R1 against
B1, and whether B1 and B2 differ from A0). Writes `DIR`/verdict.json and
prints it. With `--faithfulness` it measures check 1 of this checkout's
step on the card instead and writes `FAITHFULNESS["repaired"]`: this
checkout runs the repaired step. `FAITHFULNESS["current"]` is the record
of the same measurement made on the current step (commit `CURRENT`)
before the repair; no checkout after it runs that step.

Check 1's `POOL_ATOL` is one f32 rounding at the magnitudes the step
pools: it holds the pool to `F.avg_pool2d`'s order of summation, not to
JAX's `avg_pool` (an XLA reduce_window, with an order of its own). So
each judged step also reports `by_distribution`, checks 2 and 3 alone:
what its 32 seeds learn, whatever order its pool sums in.

The repaired step's graph did not keep its step alive, and with it the
step's pos-weights: its sets R1 and R1+, seeds run one after another in a
process, could read them after the allocator had handed their memory to
another tensor; so could A1 and A1+, PR 21's step graphed the same way.
`kept_study` judges the repaired arithmetic on the graph that keeps its
step (`KEPT_SETS`, F1 and F1+ in R1 and R1+'s place, the rule unchanged)
and marks the verdicts made on sets that could read freed memory. Without
`--faithfulness` the tool writes `DIR`/verdict.json (`study`) and
`DIR`/verdict_kept.json (`kept_study`).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from aglayout_tpu_torch.tools.train_evidence import REPO

BASE = "7db85a4"  # eager step, plain Adam, F.avg_pool2d: card_64.json's
CHANGE = "a044d8d"  # the step captured as a CUDA graph, and the five files below
CURRENT = "30e98c0"  # card_64_graphed.json's
KEEP_BITS = ("ops/bilinear.py", "ops/image.py", "train/losses.py")
ADAM = ("train/state.py",)
POOL = ("models/discriminator.py",)
# name: (file in DIR, tree's commit, files of the package taken from CHANGE, seeds)
SETS = {
    "A0": ("A0.json", BASE, (), tuple(range(8))),
    "A1": ("A1.json", CURRENT, (), tuple(range(8))),
    "B0": ("B0.json", BASE, KEEP_BITS, tuple(range(8))),
    "B1": ("B1.json", BASE, ADAM, tuple(range(8))),
    "B2": ("B2.json", BASE, POOL, tuple(range(8))),
    "B12": ("B12.json", BASE, KEEP_BITS + ADAM + POOL, tuple(range(8))),
    "A0+": ("A0_plus.json", BASE, (), tuple(range(8, 32))),
    "A1+": ("A1_plus.json", CURRENT, (), tuple(range(8, 32))),
    # the fault located (check 1 fails for POOL, whose set moves the mean
    # most) and the step repaired: B2 to 32 seeds, and the repaired step,
    # this checkout (commit None), over seeds 0-31
    "B2+": ("B2_plus.json", BASE, POOL, tuple(range(8, 32))),
    "R1": ("R1.json", None, (), tuple(range(8))),
    "R1+": ("R1_plus.json", None, (), tuple(range(8, 32))),
}
OLD, NEW = ("A0", "A0+"), ("A1", "A1+")
LOCATED, REPAIRED = ("B2", "B2+"), ("R1", "R1+")
# The repaired step with a graph that keeps its step, and with it the
# step's pos-weights and co-occurrence matrix, alive (`train/graph.py`):
# R1 and R1+ run again as they ran, on this checkout, and F1's seeds 6 and
# 7 in a fresh process; name: (file in DIR, seeds)
KEPT_SETS = {"F1": ("F1.json", tuple(range(8))), "F1+": ("F1_plus.json", tuple(range(8, 32))),
             "F1 fresh": ("fresh_F1_s67.json", (6, 7))}
KEPT = ("F1", "F1+")
FAITHFULNESS = {"current": "faithfulness.json", "repaired": "faithfulness_repaired.json"}

Z = 2.5
ADAM_STEPS = 100
ADAM_BOUND = 1e-2  # of lr
ADAM_RATIO = 2.0  # the capturable Adam's distance over the plain one's
POOL_ATOL = 2e-7

STUDY = os.path.join(REPO, "artifacts", "torch_train_evidence_128", "seed_study")
DIR = os.path.join(STUDY, "first_window_64")
CARD_OLD = os.path.join(STUDY, "card_64.json")
CARD_NOW = os.path.join(STUDY, "card_64_graphed.json")
CARD_128 = {"repaired": os.path.join(STUDY, "card_128_repaired.json"),
            "kept": os.path.join(STUDY, "card_128_kept.json")}
JAX_HOST = (os.path.join(STUDY, "host_jax_full_64.json"),
            os.path.join(STUDY, "host_jax_full_64_s23.json"))
JAX_TPU = os.path.join(REPO, "artifacts", "train_evidence", "summary.json")


# ---- check 1: faithfulness


def adam_case(seed: int = 0, n: int = 4096, steps: int = ADAM_STEPS):
    """(initial parameters (n,), gradients (steps, n)), f32, from `seed`:
    each parameter's gradients at a scale of its own, spread over seven
    decades (1e-7 to 1)."""
    rng = np.random.RandomState(seed)
    p0 = (rng.randn(n) * 0.1).astype(np.float32)
    scale = 10.0 ** rng.uniform(-7, 0, n)
    return p0, (rng.randn(steps, n) * scale).astype(np.float32)


def adam_reference(p0, grads, lr: float, b1: float, b2: float, eps: float):
    """optax.adam(lr, b1, b2, eps) applied to `grads` from `p0`, in f32 as
    optax computes it (`scale_by_adam`, then `scale(-lr)`, then
    `apply_updates`): the moments (1 - b) g^k + b m, the bias corrections
    1 - b**count in f32, m / c1 / (sqrt(v / c2) + eps)."""
    f = np.float32
    p, mu, nu = p0.astype(f), np.zeros_like(p0, f), np.zeros_like(p0, f)
    for count, g in enumerate(grads, 1):
        mu = f(1 - b1) * g + f(b1) * mu
        nu = f(1 - b2) * (g * g) + f(b2) * nu
        c1, c2 = (f(1) - np.power(f(b), f(count)) for b in (b1, b2))
        p = p + f(-lr) * ((mu / c1) / (np.sqrt(nu / c2) + f(eps)))
    return p


def torch_adam(p0, grads, device, capturable: bool, graphed: bool = False):
    """`grads` applied from `p0` by the port's Adam (`train/state.adam`;
    capturable, as the card's, or plain with its hyper-parameters), eagerly
    or replayed from one CUDA graph of its step (captured after warm-up
    steps that are then undone, as `train/graph.py` undoes them)."""
    import torch

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.train.state import adam

    holder = torch.nn.Module()
    holder.p = torch.nn.Parameter(torch.tensor(p0, device=device))
    opt = adam(config_for(64), holder)
    if opt.defaults["capturable"] != capturable:
        opt = torch.optim.Adam(holder.parameters(), lr=opt.defaults["lr"],
                               betas=opt.defaults["betas"], eps=opt.defaults["eps"],
                               capturable=capturable)
    p = holder.p
    p.grad = torch.zeros_like(p)
    if graphed:
        for _ in range(3):
            opt.step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            opt.step()
        with torch.no_grad():
            p.copy_(torch.tensor(p0, device=device))
            for v in opt.state[p].values():
                v.zero_()
    for g in grads:
        p.grad.copy_(torch.tensor(g, device=device))
        if graphed:
            graph.replay()
        else:
            opt.step()
    return p.detach().cpu().numpy()


def adam_distances(device) -> dict:
    """max |torch - reference| / lr after `ADAM_STEPS` steps of
    `adam_case()`: the plain Adam, and on the card the capturable one eager
    and graphed."""
    from aglayout_tpu_torch.config import config_for

    cfg = config_for(64)
    p0, grads = adam_case()
    want = adam_reference(p0, grads, cfg.learning_rate, cfg.beta1, cfg.beta2, 1e-8)
    kinds = {"plain": (False, False)}
    if str(device).startswith("cuda"):
        kinds.update(capturable=(True, False), capturable_graphed=(True, True))
    return {k: float(np.abs(torch_adam(p0, grads, device, *kw) - want).max() / cfg.learning_rate)
            for k, kw in kinds.items()}


def pool_shapes(device, **overrides) -> list:
    """The shapes `avg_pool2` takes in one train step of the 64^2 evidence
    (`train_evidence`'s set-up, B=8; `overrides` narrow the config, for
    tests), in the order first seen."""
    from aglayout_tpu_torch.models import discriminator
    from aglayout_tpu_torch.tools.train_evidence import parser, setup

    _, _, corpus, state, step = setup(parser().parse_args(
        ["--image_size", "64", "--corpus_batches", "1", "--device", str(device)]), **overrides)
    shapes, pool = [], discriminator.avg_pool2

    def recording(x):
        if tuple(x.shape) not in shapes:
            shapes.append(tuple(x.shape))
        return pool(x)

    discriminator.avg_pool2 = recording
    try:
        step(state, corpus[0])
    finally:
        discriminator.avg_pool2 = pool
    return shapes


def pool_errors(shape, device, seed: int = 0) -> dict:
    """`avg_pool2` against `F.avg_pool2d(x, 2)` on seeded normal f32 x of
    `shape`: the forward's max |difference|, the same in units in the last
    place of the four terms' mean magnitude (a sum in another order moves
    a value by about one) and the count of values that differ, and whether
    the gradients of a seeded weighted sum are equal."""
    import torch

    from aglayout_tpu_torch.models.discriminator import avg_pool2

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).requires_grad_()
    n, c, h, w = shape
    y = torch.randn(n, c, h // 2, w // 2, generator=g, device=device)
    got, want = avg_pool2(x), torch.nn.functional.avg_pool2d(x, 2)
    (gx,) = torch.autograd.grad((got * y).sum(), x)
    (wx,) = torch.autograd.grad((want * y).sum(), x)
    got, want = got.detach(), want.detach()
    scale = torch.nn.functional.avg_pool2d(x.detach().abs(), 2)  # the terms' mean magnitude
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
    diff = (got - want).abs()
    return {"shape": list(shape), "forward_max_abs": float(diff.max()),
            "forward_max_ulps": float((diff / ulp).max()),
            "forward_unequal": int((diff > 0).sum()), "backward_equal": bool(torch.equal(gx, wx))}


def faithfulness(device="cuda") -> dict:
    """Check 1 of the rule, measured on `device`."""
    from aglayout_tpu_torch.bench import card

    adam = adam_distances(device)
    pools = [pool_errors(s, device) for s in pool_shapes(device)]
    cap = [adam[k] for k in ("capturable", "capturable_graphed") if k in adam]
    adam_ok = bool(cap) and all(d <= ADAM_BOUND and d <= ADAM_RATIO * adam["plain"] for d in cap)
    pool_ok = bool(pools) and all(p["forward_max_abs"] <= POOL_ATOL and p["backward_equal"]
                                  for p in pools)
    return {"adam_over_lr": adam, "adam_ok": adam_ok, "pools": pools, "pool_ok": pool_ok,
            "card": card(device)}


# ---- checks 2 and 3, from the committed files


def _check_layout(out: dict, seeds, path: str) -> dict:
    """{seed: first window} of a first-window file, its layout checked as
    `tools/first_window` writes it at 64^2, B=8: each seed's three logs,
    its window their mean, the summary the windows'."""
    if (out["image_size"], out["batch_size"], out["steps"]) != (64, 8, 30):
        raise ValueError(f"{path}: not a 64^2, B=8, 30-step first-window file")
    if sorted(out["seeds"], key=int) != [str(s) for s in seeds]:
        raise ValueError(f"{path}: seeds {sorted(out['seeds'], key=int)}, not {list(seeds)}")
    windows = {}
    for s, run in out["seeds"].items():
        logs = run["rec_l1"]
        if len(logs) != 3 or not np.isfinite(logs).all() or \
                abs(run["first_window"] - np.mean(logs)) > 1e-12:
            raise ValueError(f"{path}: seed {s}'s logs {logs} and window {run['first_window']}")
        windows[s] = run["first_window"]
    summary = out["first_window"]
    if (summary["min"], summary["max"]) != (min(windows.values()), max(windows.values())) or \
            abs(summary["mean"] - np.mean(list(windows.values()))) > 1e-12:
        raise ValueError(f"{path}: the summary {summary} is not its windows'")
    return windows


def load_set(name: str, d: str = DIR) -> dict:
    """The file of set `name` (of `SETS` or `KEPT_SETS`), its layout
    checked, and deterministic with TF32 off on an NVIDIA card."""
    file, seeds = KEPT_SETS[name] if name in KEPT_SETS else (SETS[name][0], SETS[name][3])
    path = os.path.join(d, file)
    with open(path) as f:
        out = json.load(f)
    _check_layout(out, seeds, path)
    if not out["deterministic"] or out["tf32"] or not out["card"].startswith("NVIDIA"):
        raise ValueError(f"{path}: not deterministic with TF32 off on an NVIDIA card")
    return out


def same_logs(a: dict, b: dict) -> bool:
    """Whether two first-window files hold the same logs, bit for bit, for
    every seed of `a` (all of which `b` must hold)."""
    return all(a["seeds"][s]["rec_l1"] == b["seeds"][s]["rec_l1"] for s in a["seeds"])


def parted(a: dict, b: dict) -> list:
    """The seeds of `a` whose logs differ from `b`'s in any bit."""
    return sorted((int(s) for s in a["seeds"] if a["seeds"][s]["rec_l1"] != b["seeds"][s]["rec_l1"]))


def jax_windows() -> dict:
    """JAX's full-width 64^2 first windows: {"cpuS": its host seed S,
    "tpu0": its TPU run}."""
    out = {}
    for path in JAX_HOST:
        with open(path) as f:
            host = json.load(f)
        out.update({f"cpu{s}": run["first_window"] for s, run in host["seeds"].items()})
    with open(JAX_TPU) as f:
        out["tpu0"] = json.load(f)["rec_l1_first_window"]
    return out


def two_sided(a, b) -> tuple:
    """(a's mean within b's range, b's mean within a's range)."""
    return (min(b) <= float(np.mean(a)) <= max(b), min(a) <= float(np.mean(b)) <= max(a))


def _windows(sets: dict, names) -> list:
    return [run["first_window"] for n in names for run in sets[n]["seeds"].values()]


def _summary(windows: list) -> dict:
    return {"n": len(windows), "mean": float(np.mean(windows)),
            "sd": float(np.std(windows, ddof=1)), "min": min(windows), "max": max(windows)}


def shift(new: list, old: list) -> dict:
    """Check 2: d, s and whether |d| > `Z` s."""
    d = float(np.mean(new) - np.mean(old))
    s = float(np.sqrt(np.var(new, ddof=1) / len(new) + np.var(old, ddof=1) / len(old)))
    return {"d": d, "s": s, "moved": abs(d) > Z * s}


def judge(sets: dict, names, faithful: dict, jax: dict) -> dict:
    """The rule's three checks and its verdict for the step whose windows
    are the sets `names`, its faithfulness measured in `faithful`."""
    old, new = _windows(sets, OLD), _windows(sets, names)
    jax_in_port, port_in_jax = two_sided(list(jax.values()), new)
    out = {"sets": list(names), "windows": _summary(new),
           "faithful": {"adam": faithful["adam_ok"], "pool": faithful["pool_ok"]},
           **shift(new, old),
           "two_sided": {"jax_mean_in_port_range": jax_in_port,
                         "port_mean_in_jax_range": port_in_jax}}
    distribution = not out["moved"] and jax_in_port and port_in_jax
    fault = not all(out["faithful"].values()) or not distribution
    return dict(out, by_distribution="draw" if distribution else "fault",
                verdict="fault" if fault else "draw")


def _rule(new=NEW) -> dict:
    return {"z": Z, "adam_steps": ADAM_STEPS, "adam_bound_over_lr": ADAM_BOUND,
            "adam_ratio": ADAM_RATIO, "pool_atol": POOL_ATOL, "old": list(OLD), "new": list(new)}


def study(d: str = DIR) -> dict:
    sets = {name: load_set(name, d) for name in SETS}
    faithful = {}
    for step, file in FAITHFULNESS.items():
        with open(os.path.join(d, file)) as f:
            faithful[step] = json.load(f)
    with open(CARD_OLD) as f:
        card_old = json.load(f)
    with open(CARD_NOW) as f:
        card_now = json.load(f)
    jax = jax_windows()
    current = judge(sets, NEW, faithful["current"], jax)
    return {
        "rule": _rule(),
        "bit_equal": {"A0=card_64": same_logs(sets["A0"], card_old),
                      "A1=card_64_graphed": same_logs(sets["A1"], card_now),
                      "B0=A0": same_logs(sets["B0"], sets["A0"]),
                      "B12=A1": same_logs(sets["B12"], sets["A1"]),
                      "R1=B1": same_logs(sets["R1"], sets["B1"])},
        "alters_bits": {n: not same_logs(sets[n], sets["A0"]) for n in ("B1", "B2")},
        "means": {n: out["first_window"]["mean"] for n, out in sets.items()},
        "old": _summary(_windows(sets, OLD)),
        "jax": {"windows": jax, "mean": float(np.mean(list(jax.values()))),
                "min": min(jax.values()), "max": max(jax.values())},
        "current": current,
        "located": {"B2": dict(shift(_windows(sets, LOCATED), _windows(sets, OLD)),
                               sets=list(LOCATED))},
        "repaired": judge(sets, REPAIRED, faithful["repaired"], jax),
        "cards": sorted({out["card"] for out in sets.values()}
                        | {f["card"] for f in faithful.values()}),
        "verdict": current["verdict"],
    }


def kept_study(d: str = DIR) -> dict:
    """The rule, unchanged, on the step whose graph keeps its step alive:
    F1 and F1+ in the place of R1 and R1+, which ran on the same arithmetic
    with a graph that read the freed pos-weights; check 1 is the repaired
    step's (the graph changes no arithmetic). Beside it: F1 against the
    eager B1 (the same arithmetic) and the fresh process's seeds, and the
    seeds whose logs the repair changed, at 64^2 (R1, R1+) and at 128^2
    (`card_128_repaired.json` against `card_128_kept.json`, TF32 on)."""
    sets = {name: load_set(name, d) for name in list(SETS) + list(KEPT_SETS)}
    with open(os.path.join(d, FAITHFULNESS["repaired"])) as f:
        faithful = json.load(f)
    card_128 = {}
    for step, path in CARD_128.items():
        with open(path) as f:
            card_128[step] = json.load(f)
        if (card_128[step]["image_size"], card_128[step]["seeds"].keys()) != \
                (128, {str(s) for s in range(8)}) or not card_128[step]["tf32"]:
            raise ValueError(f"{path}: not the 128^2 TF32 first windows of seeds 0-7")
    kept = judge(sets, KEPT, faithful, jax_windows())
    return {
        "rule": _rule(KEPT),
        "bit_equal": {"F1=B1": same_logs(sets["F1"], sets["B1"]),
                      "F1 fresh=F1": same_logs(sets["F1 fresh"], sets["F1"])},
        "parted": {"R1": parted(sets["R1"], sets["F1"]), "R1+": parted(sets["R1+"], sets["F1+"]),
                   "card_128_repaired": parted(card_128["repaired"], card_128["kept"])},
        "means": {n: sets[n]["first_window"]["mean"] for n in KEPT_SETS} | {
            f"card_128_{k}": v["first_window"]["mean"] for k, v in card_128.items()},
        "repaired": judge(sets, REPAIRED, faithful, jax_windows()),
        # the graphed sets that ran on a graph that did not keep its step:
        # verdict.json's "current" and this file's "repaired" rest on them
        "read_freed_memory": {"verdict.json current": list(NEW), "repaired": list(REPAIRED)},
        "kept": kept,
        "cards": sorted({sets[n]["card"] for n in KEPT_SETS} | {faithful["card"]}
                        | {v["card"] for v in card_128.values()}),
        "verdict": kept["verdict"],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--faithfulness", action="store_true",
                   help="measure check 1 of this checkout's (the repaired) step on the card "
                        "and write its file")
    args = p.parse_args(argv)
    out = ({FAITHFULNESS["repaired"]: faithfulness()} if args.faithfulness
           else {"verdict.json": study(), "verdict_kept.json": kept_study()})
    os.makedirs(DIR, exist_ok=True)
    for name, record in out.items():
        with open(os.path.join(DIR, name), "w") as f:
            json.dump(record, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
