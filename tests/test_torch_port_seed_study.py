"""The first window of the training evidence across seeds, on the host at
`bench.TRAIN_SMALL` widths (B=3, O=3, 64^2), both packages:

  * the port's `tools/first_window`;
  * the JAX package's tools/train_evidence.py set-up and step, as
    `jax_first_window` runs them with the package unchanged.

artifacts/torch_train_evidence_128/seed_study/host_train_small.json holds
both over seeds 0-7 at 64^2 and 128^2, with torch at 2 threads:

    from tests.test_torch_port_seed_study import jax_first_window
    jax_first_window(train_configs(size)[1], range(8))
    first_window.main(["--image_size", size, "--batch_size", "3", "--device", "cpu"],
                      **TRAIN_SMALL without batch_size, object_size 32 or 64)

At full width (64^2, B=8) the first windows are committed, not run here:
the port's eight card seeds (card_64.json, `tools/first_window`), its
seeds 0-3 on the host's CPU (host_port_full_64.json, `first_window --device
cpu --deterministic`) and JAX's seeds 0 and 1 on the host's CPU
(host_jax_full_64.json, this module's `main`, about 40 minutes a seed);
`test_full_width_first_windows_two_sided` checks the files and applies
PERF.md's two-sided rule to them.

The small-width tests run one seed of each and hold its first log (step
10) to the committed file's within 1e-2, relatively. Only the first: from the second
log on, a run carries the host's f32 rounding amplified by the steps, and
the port's second log moves by several per cent with torch's thread count
alone, so the later logs repeat only on the same host with the same
threads.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_port_common import train_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDY = os.path.join(REPO, "artifacts", "torch_train_evidence_128", "seed_study",
                     "host_train_small.json")
TOL = 1e-2  # the first log's; see the module's docstring


def jax_first_window(jcfg, seeds, steps: int = 30, log_every: int = 10,
                     corpus_batches: int = 32) -> dict:
    """The first logs of the JAX package's training-evidence run at `jcfg`
    for each seed: tools/train_evidence.py's set-up (the scene corpus and
    matrix from RandomState(7), its jitted step, the state from
    `create_train_state(jcfg, Models(jcfg), PRNGKey(seed))`; the positive
    weights the vocabulary's at 106 attributes, else ones, as the port's
    tool takes them), `steps` steps: {seed: G/rec_img at every
    `log_every`-th step}."""
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.data.synthetic import synthetic_cooccurrence, synthetic_scene_batch
    from aglayout_tpu.data.vocab import attribute_pos_weight
    from aglayout_tpu.train.state import Models, create_train_state
    from aglayout_tpu.train.step import make_train_step

    rng = np.random.RandomState(7)
    corpus = [{k: jnp.asarray(v) for k, v in synthetic_scene_batch(
        rng, jcfg.batch_size, jcfg.max_objects, jcfg.image_size, jcfg.num_classes,
        jcfg.attribute_dim).items()} for _ in range(corpus_batches)]
    matrix = synthetic_cooccurrence(rng, jcfg.num_classes, jcfg.attribute_dim)
    pos_weight = (attribute_pos_weight() if jcfg.attribute_dim == 106
                  else np.ones(jcfg.attribute_dim, np.float32))
    models = Models(jcfg)
    step = jax.jit(make_train_step(jcfg, models, matrix, pos_weight))
    out = {}
    for seed in seeds:
        state, logs = create_train_state(jcfg, models, jax.random.PRNGKey(seed)), []
        for i in range(steps):
            state, metrics = step(state, corpus[i % len(corpus)])
            if (i + 1) % log_every == 0:
                logs.append(float(metrics["G/rec_img"]))
        out[seed] = logs
    return out


def _study():
    with open(STUDY) as f:
        return json.load(f)


def test_first_window_across_seeds_on_the_host(tmp_path):
    """`tools/first_window` at small widths for seed 1 (not the config's 0):
    three logs, the window their mean, the JSON written, the first log the
    committed study's for seed 1 and not its seed 0's."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import first_window

    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the study's
    try:
        out = first_window.main(["--seeds", "1", "--batch_size", "3", "--device", "cpu",
                                 "--out", str(tmp_path / "fw.json")], **small)
    finally:
        torch.set_num_threads(threads)
    assert json.loads((tmp_path / "fw.json").read_text()) == out
    run = out["seeds"]["1"]
    assert list(out["seeds"]) == ["1"] and len(run["rec_l1"]) == 3 and out["steps"] == 30
    assert run["first_window"] == float(np.mean(run["rec_l1"])) == out["first_window"]["mean"]
    study = _study()["port_64"]["seeds"]
    assert abs(run["rec_l1"][0] / study["1"]["rec_l1"][0] - 1) <= TOL, (run, study["1"])
    assert abs(run["rec_l1"][0] / study["0"]["rec_l1"][0] - 1) > TOL, (run, study["0"])


def test_jax_first_window_matches_the_committed_study():
    """`jax_first_window` for seed 0, ten steps: its one log the committed
    study's first for JAX's seed 0 within 1e-2."""
    logs = jax_first_window(train_configs(64)[1], [0], steps=10)
    want = _study()["jax_64"]["0"]["rec_l1"][0]
    assert len(logs[0]) == 1 and np.isfinite(logs[0][0])
    assert abs(logs[0][0] / want - 1) <= TOL, (logs, want)


FULL_JAX = os.path.join(os.path.dirname(STUDY), "host_jax_full_64.json")
FULL_PORT_HOST = os.path.join(os.path.dirname(STUDY), "host_port_full_64.json")
# the port's eight card seeds at 64^2 on the eager step with a plain Adam
# and `F.avg_pool2d`, and on the graphed step (capturable Adam, `avg_pool2`)
FULL_PORT_CARD = os.path.join(os.path.dirname(STUDY), "card_64.json")
FULL_PORT_CARD_NOW = os.path.join(os.path.dirname(STUDY), "card_64_graphed.json")
FULL_PORT_CARD_128 = os.path.join(os.path.dirname(STUDY), "card_128_graphed.json")
JAX_TPU_64 = os.path.join(REPO, "artifacts", "train_evidence", "summary.json")  # JAX's 64^2 run
JAX_TPU_128 = os.path.join(REPO, "artifacts", "train_evidence_128", "summary.json")


def _full(path, seeds, size=64):
    """A full-width B=8 first-window file: its layout checked (each seed's
    three logs, its window their mean, the summary the windows'),
    returned."""
    with open(path) as f:
        out = json.load(f)
    assert (out["image_size"], out["batch_size"], out["steps"]) == (size, 8, 30), path
    assert sorted(out["seeds"], key=int) == [str(s) for s in seeds], path
    windows = []
    for run in out["seeds"].values():
        assert len(run["rec_l1"]) == 3 and np.isfinite(run["rec_l1"]).all(), path
        assert abs(run["first_window"] - np.mean(run["rec_l1"])) <= 1e-12, path
        windows.append(run["first_window"])
    assert (out["first_window"]["min"], out["first_window"]["max"]) == (min(windows), max(windows))
    assert abs(out["first_window"]["mean"] - np.mean(windows)) <= 1e-12, path
    return out


def full_width_sets(card=FULL_PORT_CARD):
    """(JAX's full-width set: its host seeds 0 and 1 and its TPU seed 0;
    the port's: its eight card seeds in `card`), each {name: first
    window}, from the committed files, their layouts checked (the port's
    four host seeds' too, which the platform effect of PERF.md reads)."""
    jax_host = _full(FULL_JAX, [0, 1])
    port_card, port_host = _full(card, range(8)), _full(FULL_PORT_HOST, range(4))
    assert jax_host["host"]["cpu"] and jax_host["command"].startswith("JAX_PLATFORMS=cpu")
    assert set(jax_host["seconds"]) == {"0", "1"}
    assert port_card["deterministic"] and not port_card["tf32"]
    assert port_card["card"].startswith("NVIDIA H100")
    assert port_host["deterministic"] and port_host["card"].startswith("cpu")
    jax_set = {f"cpu{k}": v["first_window"] for k, v in jax_host["seeds"].items()}
    with open(JAX_TPU_64) as f:
        jax_set["tpu0"] = json.load(f)["rec_l1_first_window"]
    return jax_set, {k: v["first_window"] for k, v in port_card["seeds"].items()}


def two_sided(a: dict, b: dict) -> tuple:
    """(a's mean within b's range, b's mean within a's range)."""
    def inside(values, of):
        return min(of.values()) <= float(np.mean(list(values.values()))) <= max(of.values())
    return inside(a, b), inside(b, a)


@pytest.mark.parametrize("card", [
    FULL_PORT_CARD,
    pytest.param(FULL_PORT_CARD_NOW, marks=pytest.mark.xfail(strict=True, reason=(
        "ROADMAP queue 3, fault 2 (a), reopened: on the graphed step the port's 64^2 mean "
        "first window (0.5944) lies below JAX's range (0.6059-0.6491)"))),
], ids=lambda path: os.path.basename(path))
def test_full_width_first_windows_two_sided(card):
    """The full-width 64^2 rule of PERF.md §6: the mean of JAX's set
    (its host seeds 0, 1 and its TPU seed 0) within the port's eight card
    seeds' range, and the port's mean within JAX's range; the port's seeds
    on the eager step (card_64.json) and on the graphed one
    (card_64_graphed.json, where the second half fails)."""
    jax_set, port_card = full_width_sets(card)
    assert two_sided(jax_set, port_card) == (True, True), (jax_set, port_card)


def test_full_width_first_windows_128_on_the_card():
    """card_128_graphed.json, the port's eight card seeds at 128^2 on the
    graphed step: `_full`'s layout, deterministic with TF32 on, an NVIDIA
    card; seeds 0-3 the first windows of the 128^2 evidence runs of the
    same seeds (`seeds/seed_S`, the same first 30 steps), bit for bit; and
    the one-sided check of PERF.md §6: JAX's one full-width 128^2 first
    window (its TPU run) within the eight seeds' range."""
    from aglayout_tpu_torch.tools import evidence_seeds

    port = _full(FULL_PORT_CARD_128, range(8), 128)
    assert port["deterministic"] and port["tf32"] and port["card"].startswith("NVIDIA H100")
    with open(JAX_TPU_128) as f:
        jax_first = json.load(f)["rec_l1_first_window"]
    assert port["first_window"]["min"] <= jax_first <= port["first_window"]["max"], jax_first
    for s in evidence_seeds.seeds_present(evidence_seeds.DIR):
        with open(os.path.join(evidence_seeds.DIR, f"seed_{s}", "summary.json")) as f:
            assert port["seeds"][str(s)]["first_window"] == json.load(f)["rec_l1_first_window"], s


def _host() -> dict:
    """The CPU's model name, its logical cores and JAX's version."""
    import platform

    import jax

    model = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    except OSError:
        pass
    return {"cpu": model, "cores": os.cpu_count(), "jax": jax.__version__}


def main(argv=None) -> dict:
    """JAX's full-width first windows on the host, one seed at a time:

        JAX_PLATFORMS=cpu python -m tests.test_torch_port_seed_study --seeds 0 1 [--out FILE]

    JAX's `config_for(64, batch_size=8)` (tools/train_evidence.py's) through
    `jax_first_window`; the file is rewritten after each seed, in
    card_64.json's layout plus the host, each seed's seconds (set-up and
    compile included) and this command."""
    import argparse
    import sys
    import time

    from aglayout_tpu.config import config_for

    p = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--out", default=FULL_JAX)
    args = p.parse_args(argv)
    jcfg = config_for(64, batch_size=8)
    result = {"image_size": jcfg.image_size, "batch_size": jcfg.batch_size, "steps": 30,
              "seeds": {}, "seconds": {}, "host": _host(),
              "command": "JAX_PLATFORMS=cpu python -m tests.test_torch_port_seed_study "
                         + " ".join(sys.argv[1:] if argv is None else argv)}
    for seed in args.seeds:
        t0 = time.perf_counter()
        values = jax_first_window(jcfg, [seed])[seed]
        result["seconds"][str(seed)] = time.perf_counter() - t0
        result["seeds"][str(seed)] = {"rec_l1": values, "first_window": float(np.mean(values))}
        windows = [r["first_window"] for r in result["seeds"].values()]
        result["first_window"] = {"min": min(windows), "max": max(windows),
                                  "mean": float(np.mean(windows)), "std": float(np.std(windows))}
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"seed {seed}: first window {windows[-1]:.4f} "
              f"({result['seconds'][str(seed)]:.1f} s)", flush=True)
    return result


if __name__ == "__main__":
    main()
