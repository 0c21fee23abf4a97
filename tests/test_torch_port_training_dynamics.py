"""The port's GAN must train, not merely give finite losses: twin of
tests/test_training_dynamics.py.

  * a live check: on the learnable synthetic-scene corpus (images are
    renders of their layouts) the image reconstruction L1 of the last 8 of
    60 steps must average below 0.8 of the first 8's, at the JAX test's
    config and seed on the card (`gpu`), under torch's deterministic
    algorithms so that every run gives the same ratio, and at the CPU
    tests' small widths over 40 steps here;
  * the committed card run: artifacts/torch_train_evidence/ (8,000 steps
    at the reference's 64^2 config from a fresh state, `python -m
    aglayout_tpu_torch.tools.train_evidence --steps 8000 --deterministic`),
    its summary held to the JAX test's bar (at least 3,000 steps);
  * the committed 128^2 card run: artifacts/torch_train_evidence_128/
    (object_size 64, the attribute D's extra block, the decoder's c5-c7
    tail; 6,000 steps in two segments of 3,000, `--image_size 128 --steps
    6000 --deterministic --tf32 --segment_steps 3000`), held to JAX's
    128^2 test's bar, to JAX's own curve at the same length, and to the
    kernel check of its samples' forward on the trained state;
  * the committed 128^2 card runs at JAX's 12,000 steps by seed:
    artifacts/torch_train_evidence_128_12000/seeds/ (`train_evidence
    --image_size 128 --steps 12000 --deterministic --tf32 --seed S`), each
    held to its own files and kernel check, and its verdict.json to the
    rule of `tools/evidence_seeds` (the median of four seeds' last windows
    against JAX's plus 0.05).

The file imports no JAX, so it runs where only PyTorch is installed:
`python -m pytest --noconftest tests/test_torch_port_training_dynamics.py`.
"""

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script (`main`): the packages are in the repo
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aglayout_tpu_torch.bench import TRAIN_SMALL  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(REPO, "artifacts", "torch_train_evidence")
EVIDENCE_128 = os.path.join(REPO, "artifacts", "torch_train_evidence_128")
JAX_EVIDENCE_128 = os.path.join(REPO, "artifacts", "train_evidence_128")
# the JAX test's config (tests/test_training_dynamics.py), 60 steps of it
JAX_TEST_CONFIG = dict(batch_size=4, max_objects=3, image_size=64, object_size=32,
                       num_classes=12, clstm_layers=1, resi_num=1)
JAX_TEST_STEPS = 60


def rec_l1_curve(device, steps: int, seed: int = 0, **cfg_kw):
    """The G/rec_img of `steps` train steps of a fresh state of `seed`,
    cycling over 4 batches of `synthetic_scene_batch(RandomState(11))`, as
    the JAX test draws them (f32, TF32 off)."""
    from aglayout_tpu_torch.config import Config
    from aglayout_tpu_torch.data.synthetic import (
        batch_to_torch,
        synthetic_cooccurrence,
        synthetic_scene_batch,
    )
    from aglayout_tpu_torch.data.vocab import attribute_pos_weight
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step
    from aglayout_tpu_torch.utils.device import no_tf32

    cfg = Config(**cfg_kw)
    state = create_train_state(cfg, device, seed=seed)
    rng = np.random.RandomState(11)
    corpus = [batch_to_torch(synthetic_scene_batch(rng, cfg.batch_size, cfg.max_objects,
                                                   cfg.image_size, cfg.num_classes,
                                                   cfg.attribute_dim), device)
              for _ in range(4)]
    pos_weight = (attribute_pos_weight() if cfg.attribute_dim == 106
                  else np.ones(cfg.attribute_dim, np.float32))
    step = make_train_step(cfg, state.models,
                           synthetic_cooccurrence(rng, cfg.num_classes, cfg.attribute_dim),
                           pos_weight)
    rec = []
    with no_tf32() if device == "cuda" else contextlib.nullcontext():
        for i in range(steps):
            state, metrics = step(state, corpus[i % len(corpus)])
            rec.append(metrics["G/rec_img"].detach())
    return torch.stack(rec).float().cpu().numpy()


def windows8(rec) -> tuple:
    """(mean of the first 8, mean of the last 8, their ratio) of a curve."""
    first, last = float(np.mean(rec[:8])), float(np.mean(rec[-8:]))
    return first, last, last / first


def assert_falls(rec, bar: float = 0.8):
    first, last, _ = windows8(rec)
    assert np.isfinite(rec).all()
    assert last < bar * first, f"rec L1 did not fall: {first:.4f} -> {last:.4f}"


def deterministic_curve(device, seed: int = 0):
    """The JAX test's curve from a fresh state of `seed`, under torch's
    deterministic algorithms (`utils/device.deterministic`; TF32 off): two
    runs on one card give the same values, bit for bit."""
    from aglayout_tpu_torch.utils.device import deterministic

    with deterministic():
        return rec_l1_curve(device, JAX_TEST_STEPS, seed=seed, **JAX_TEST_CONFIG)


@pytest.mark.gpu
def test_reconstruction_l1_decreases_over_training():
    """The JAX test's config, steps, seed and bar, on the card, deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert_falls(deterministic_curve("cuda"))


def test_reconstruction_l1_decreases_over_training_small():
    """The CPU tests' small widths (`bench.TRAIN_SMALL`, B=3, O=3), 40 steps."""
    torch.set_num_threads(1)
    rec = rec_l1_curve("cpu", 40, image_size=64, object_size=32, **TRAIN_SMALL)
    assert_falls(rec)


def test_committed_training_evidence():
    path = os.path.join(EVIDENCE, "summary.json")
    assert os.path.exists(path), (
        "training evidence missing: run `python -m aglayout_tpu_torch.tools.train_evidence` "
        "on the card")
    with open(path) as f:
        s = json.load(f)
    assert s["steps"] >= 3000
    assert s["rec_l1_reduction"] > 0.3, s
    for art in ("metrics.jsonl", "loss_curves.png", "samples.png"):
        assert os.path.exists(os.path.join(EVIDENCE, art))


def test_committed_training_evidence_128():
    """JAX's test_committed_training_evidence_128 on the port's card run: the
    128^2 config, at least 3,000 steps, a reduction above 0.3, the three
    files. Besides: the run's last 10 % of logs within 0.05 of JAX's
    committed 128^2 run's as if it had ended at the same step; an NVIDIA
    card named; every log step present; and the samples' eval forward on
    the trained state with the kernels on within 1e-4 of the plain forward's
    max, K1-K5 each launched (3 a forward: rec, rand, shift)."""
    from aglayout_tpu_torch.tools.train_evidence import PATH_KERNELS, windows

    path = os.path.join(EVIDENCE_128, "summary.json")
    assert os.path.exists(path), (
        "128^2 training evidence missing: run `python -m aglayout_tpu_torch.tools.train_evidence "
        "--image_size 128 --deterministic --tf32 ...` on the card")
    with open(path) as f:
        s = json.load(f)
    assert s["image_size"] == 128
    assert s["steps"] >= 3000
    assert s["rec_l1_reduction"] > 0.3, s
    for art in ("metrics.jsonl", "loss_curves.png", "samples.png"):
        assert os.path.exists(os.path.join(EVIDENCE_128, art))
    with open(os.path.join(EVIDENCE_128, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == list(range(10, s["steps"] + 1, 10))
    with open(os.path.join(JAX_EVIDENCE_128, "metrics.jsonl")) as f:
        jax_rows = [json.loads(line) for line in f][:len(rows)]
    assert jax_rows[-1]["step"] == s["steps"]
    jax_last = windows([r["G/rec_img"] for r in jax_rows])[1]
    assert abs(s["rec_l1_last_window"] - jax_last) <= 0.05, (s["rec_l1_last_window"], jax_last)
    assert s["card"].startswith("NVIDIA") and s["deterministic"] and s["tf32"]
    assert s["segments"][-1]["to_step"] == s["steps"]
    k = s["kernel_check"]
    assert k["limit"] == 1e-4 and k["max_abs_err_over_max"] <= k["limit"], k
    path = PATH_KERNELS[128]
    assert {name: k["launches"].get(name) for name in path} == dict.fromkeys(path, 3), k


def test_committed_128_evidence_seeds():
    """artifacts/torch_train_evidence_128_12000/seeds/: the 128^2 evidence at
    JAX's 12,000 steps by seed (`tools/evidence_seeds`). All four of the
    rule's seeds ran, 0 to 3. Each has every log step to 12,000, the
    summary's windows as `train_evidence.windows` recomputes them, the
    arguments of the others but for the seed (deterministic, TF32, every
    segment graphed), an NVIDIA card, and a kernel check within 1e-4 with
    K1-K5 three launches each; verdict.json's `L_S`, `m` and verdict
    (`draw` or `fault`) are the rule's on the recomputed windows."""
    from aglayout_tpu_torch.tools import evidence_seeds
    from aglayout_tpu_torch.tools.train_evidence import PATH_KERNELS, windows

    d = evidence_seeds.DIR
    seeds = evidence_seeds.seeds_present(d)
    assert seeds == [0, 1, 2, 3] == list(evidence_seeds.SEEDS), seeds
    with open(os.path.join(JAX_EVIDENCE_128, "summary.json")) as f:
        assert round(json.load(f)["rec_l1_last_window"], 4) == evidence_seeds.JAX_LAST
    assert evidence_seeds.BOUND == round(evidence_seeds.JAX_LAST + 0.05, 4)
    last, args = [], []
    for s in seeds:
        run = os.path.join(d, f"seed_{s}")
        with open(os.path.join(run, "summary.json")) as f:
            summary = json.load(f)
        rows = evidence_seeds.read_metrics(run)
        assert [r["step"] for r in rows] == list(range(10, 12001, 10))
        first, l_s, reduction = windows([r["G/rec_img"] for r in rows])
        assert (summary["rec_l1_first_window"], summary["rec_l1_last_window"],
                summary["rec_l1_reduction"]) == (first, l_s, reduction)
        last.append(l_s)
        assert summary["steps"] == 12000 and summary["image_size"] == 128
        assert summary["deterministic"] and summary["tf32"]
        assert summary["card"].startswith("NVIDIA")
        segments = summary["segments"]
        assert all(sg["graphed"] for sg in segments) and segments[-1]["to_step"] == 12000
        assert all(sg["run_args"] == segments[0]["run_args"] for sg in segments)
        assert segments[0]["run_args"]["seed"] == s
        args.append(dict(segments[0]["run_args"], seed=None))
        k = summary["kernel_check"]
        assert k["limit"] == 1e-4 and k["max_abs_err_over_max"] <= k["limit"], k
        path = PATH_KERNELS[128]
        assert {name: k["launches"].get(name) for name in path} == dict.fromkeys(path, 3), k
        for art in ("loss_curves.png", "samples.png", "progress.json"):
            assert os.path.getsize(os.path.join(run, art)) > 0
    assert all(a == args[0] for a in args), args
    assert args[0]["deterministic"] and args[0]["tf32"] and args[0]["steps"] == 12000
    with open(os.path.join(d, "verdict.json")) as f:
        verdict = json.load(f)
    assert verdict["seeds_run"] == seeds
    assert [verdict["seeds"][str(s)]["L_S"] for s in seeds] == last
    m = float(np.median(last))
    assert (verdict["m"], verdict["verdict"]) == (m, "draw" if m <= 0.3948 else "fault")
    assert verdict["cards"] and all(c.startswith("NVIDIA") for c in verdict["cards"])


@pytest.mark.parametrize("last, want", [
    ((0.33, 0.41, 0.39, 0.36), (0.375, "draw")),
    ((0.40, 0.41, 0.39, 0.36), (0.395, "fault")),
    ((0.3948, 0.3948, 0.30, 0.50), (0.3948, "draw")),
    ((0.30, 0.50), (None, "pending")),
])
def test_evidence_seeds_rule(tmp_path, last, want):
    """`tools/evidence_seeds` on runs whose every log is `L_S`: the median
    of four (the mean of the middle two) against 0.3948, inclusive, and
    `pending` with fewer; verdict.json written; a seed without the seeds
    before it refused."""
    from aglayout_tpu_torch.tools import evidence_seeds

    for s, value in enumerate(last):
        run = tmp_path / f"seed_{s}"
        run.mkdir()
        rows = [{"G/rec_img": value, "G/loss": 1.0, "step": i} for i in range(10, 12001, 10)]
        (run / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        (run / "summary.json").write_text(json.dumps({"card": "NVIDIA test card, 1 W",
                                                      "steps_per_sec": 1.0}))
    out = evidence_seeds.main(["--dir", str(tmp_path)])
    m, verdict = want
    assert out["verdict"] == verdict and out["seeds_run"] == list(range(len(last)))
    assert out["m"] == (None if m is None else pytest.approx(m, abs=1e-12))
    assert [out["seeds"][str(s)]["L_S"] for s in range(len(last))] == pytest.approx(last)
    assert out["seeds"]["0"]["windows"]["G/loss"] == {"1000": 1.0, "3000": 1.0, "6000": 1.0,
                                                      "12000": 1.0}
    assert json.loads((tmp_path / "verdict.json").read_text()) == out
    os.rename(tmp_path / "seed_0", tmp_path / "gone")
    with pytest.raises(ValueError, match="in the order"):
        evidence_seeds.study(str(tmp_path))


def test_committed_dynamics_seed_study():
    """artifacts/torch_dynamics_seeds/ (`main`): the live test's ratio by
    seed, the port's deterministic on the card (card.json) and on the
    host's CPU (host_port.json), seeds 0-7 each, and JAX's own test on the
    host's CPU for PRNGKey(0) and PRNGKey(1) (host_jax.json). Each file has
    the JAX test's config, steps and bar; each seed's ratio is its curve's
    last 8 over its first 8, and passes where it is under the bar; seed 0
    passes on the card, as the live test asserts there."""
    d = os.path.join(REPO, "artifacts", "torch_dynamics_seeds")
    runs = {}
    for name, seeds in (("card", range(8)), ("host_port", range(8)), ("host_jax", range(2))):
        with open(os.path.join(d, f"{name}.json")) as f:
            runs[name] = r = json.load(f)
        assert r["config"] == JAX_TEST_CONFIG and r["steps"] == JAX_TEST_STEPS and r["bar"] == 0.8
        assert sorted(r["seeds"], key=int) == [str(i) for i in seeds]
        for v in r["seeds"].values():
            assert len(v["rec_l1"]) == JAX_TEST_STEPS and np.isfinite(v["rec_l1"]).all()
            # the port's windows were taken in f32, JAX's in f64
            np.testing.assert_allclose((v["first"], v["last"], v["ratio"]),
                                       windows8(np.asarray(v["rec_l1"])), rtol=1e-6)
            assert v["passes"] == (v["ratio"] < 0.8)
    assert runs["card"]["device"].startswith("NVIDIA") and runs["card"]["deterministic"]
    assert runs["host_port"]["device"].startswith("cpu") and runs["host_jax"]["backend"] == "cpu"
    assert runs["card"]["seeds"]["0"]["passes"]


def jax_curve(seed: int):
    """The JAX test's run (tests/test_training_dynamics.py, its body with
    `PRNGKey(seed)`): G/rec_img at each of its 60 steps, on JAX's backend."""
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.config import Config
    from aglayout_tpu.data.synthetic import synthetic_cooccurrence, synthetic_scene_batch
    from aglayout_tpu.data.vocab import attribute_pos_weight
    from aglayout_tpu.train.state import Models, create_train_state
    from aglayout_tpu.train.step import make_train_step

    cfg = Config(**JAX_TEST_CONFIG)
    models = Models(cfg)
    state = create_train_state(cfg, models, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(11)
    corpus = [{k: jnp.asarray(v) for k, v in synthetic_scene_batch(
        rng, cfg.batch_size, cfg.max_objects, cfg.image_size, cfg.num_classes).items()}
        for _ in range(4)]
    step = jax.jit(make_train_step(cfg, models, synthetic_cooccurrence(rng, cfg.num_classes),
                                   attribute_pos_weight()), donate_argnums=0)
    rec = []
    for i in range(JAX_TEST_STEPS):
        state, metrics = step(state, corpus[i % len(corpus)])
        rec.append(float(metrics["G/rec_img"]))
    return np.asarray(rec)


def main(argv=None) -> dict:
    """The dynamics test's ratio (last 8 over first 8 of 60 steps) by seed:

        python tests/test_torch_port_training_dynamics.py --seeds 0 1 2 3 4 5 6 7
            [--device cuda|cpu] [--jax] [--out FILE]

    The port's run is `deterministic_curve` on `--device`; with `--jax` it
    is the JAX test's own run (`jax_curve`) on JAX's backend
    (`JAX_PLATFORMS=cpu` for the host), more than 20 minutes a seed there.
    The file is rewritten after each seed: each seed's first and last
    windows, ratio, whether it passes the bar of 0.8, and its seconds,
    beside the device, the versions and the command."""
    import argparse
    import platform
    import sys
    import time

    p = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--jax", action="store_true", help="the JAX package's run instead")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.jax:
        import jax

        where = {"package": "jax", "backend": jax.default_backend(), "jax": jax.__version__}
    else:
        from aglayout_tpu_torch.bench import card

        where = {"package": "torch", "device": card(args.device), "torch": torch.__version__,
                 "deterministic": True, "threads": torch.get_num_threads()}
    result = {"config": JAX_TEST_CONFIG, "steps": JAX_TEST_STEPS, "bar": 0.8, **where,
              "host": platform.processor() or platform.machine(), "seeds": {},
              "command": "python tests/test_torch_port_training_dynamics.py "
                         + " ".join(sys.argv[1:] if argv is None else argv)}
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = jax_curve(seed) if args.jax else deterministic_curve(args.device, seed)
        first, last, ratio = windows8(rec)
        result["seeds"][str(seed)] = {"first": first, "last": last, "ratio": ratio,
                                      "passes": ratio < 0.8, "seconds": time.perf_counter() - t0,
                                      "rec_l1": [float(x) for x in rec]}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2)
        print(f"seed {seed}: {first:.4f} -> {last:.4f}, ratio {ratio:.4f}", flush=True)
    return result


if __name__ == "__main__":
    main()
