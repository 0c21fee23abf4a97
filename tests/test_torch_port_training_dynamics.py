"""The port's GAN must train, not merely give finite losses: twin of
tests/test_training_dynamics.py.

  * a live check: on the learnable synthetic-scene corpus (images are
    renders of their layouts) the image reconstruction L1 of the last 8 of
    60 steps must average below 0.8 of the first 8's, at the JAX test's
    config on the card (`gpu`), and at the CPU tests' small widths over 40
    steps here;
  * the committed card run: artifacts/torch_train_evidence/ (8,000 steps
    at the reference's 64^2 config from a fresh state, `python -m
    aglayout_tpu_torch.tools.train_evidence --steps 8000 --deterministic`),
    its summary held to the JAX test's bar (at least 3,000 steps);
  * the committed 128^2 card run: artifacts/torch_train_evidence_128/
    (object_size 64, the attribute D's extra block, the decoder's c5-c7
    tail; 6,000 steps in two segments of 3,000, `--image_size 128 --steps
    6000 --deterministic --tf32 --segment_steps 3000`), held to JAX's
    128^2 test's bar, to JAX's own curve at the same length, and to the
    kernel check of its samples' forward on the trained state.

The file imports no JAX, so it runs where only PyTorch is installed:
`python -m pytest --noconftest tests/test_torch_port_training_dynamics.py`.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from aglayout_tpu_torch.bench import TRAIN_SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(REPO, "artifacts", "torch_train_evidence")
EVIDENCE_128 = os.path.join(REPO, "artifacts", "torch_train_evidence_128")
JAX_EVIDENCE_128 = os.path.join(REPO, "artifacts", "train_evidence_128")


def rec_l1_curve(device, steps: int, **cfg_kw):
    """The G/rec_img of `steps` train steps cycling over 4 batches of
    `synthetic_scene_batch(RandomState(11))`, as the JAX test draws them (f32,
    TF32 off)."""
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
    state = create_train_state(cfg, device, seed=0)
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


def assert_falls(rec, bar: float = 0.8):
    first, last = float(np.mean(rec[:8])), float(np.mean(rec[-8:]))
    assert np.isfinite(rec).all()
    assert last < bar * first, f"rec L1 did not fall: {first:.4f} -> {last:.4f}"


@pytest.mark.gpu
def test_reconstruction_l1_decreases_over_training():
    """The JAX test's config and steps, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec = rec_l1_curve("cuda", 60, batch_size=4, max_objects=3, image_size=64, object_size=32,
                       num_classes=12, clstm_layers=1, resi_num=1)
    assert_falls(rec)


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
