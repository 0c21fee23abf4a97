"""The port's evaluation suite on the host against the JAX package's, and
its command lines, on the CPU:

  * the host metrics on identical arrays equal JAX's: `AttributeMetrics`,
    `frechet_distance`, `compute_statistics`, `inception_score_from_probs`,
    `consistency_l1`, `random_pair_baseline`, and the two offline stand-ins
    (`PixelProjectionExtractor`, `RandomFeatureClassifier`);
  * each CLI, as `tests/test_eval_cli.py` drives JAX's: `fid`,
    `inception_score`, `lpips`, `consistency` (on pickles written by JAX's
    `gen_pickle` and on the port's own, each read by both packages' CLI),
    and `report` on a synthetic checkpoint, with the offline stand-ins and
    with seeded real networks;
  * every new entry point raises without a card unless `--device cpu`.
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from aglayout_tpu.eval import consistency as jax_consistency
from aglayout_tpu.eval import fid as jax_fid
from aglayout_tpu.eval import inception_score as jax_is
from aglayout_tpu.infer.generate import AttributeMetrics as JaxAttributeMetrics
from aglayout_tpu_torch.eval import consistency, fid, inception_score
from aglayout_tpu_torch.infer.generate import AttributeMetrics
from tests.torch_port_common import drawn_train_state, jax_train_state, train_configs

torch.set_num_threads(1)


# ---- host metrics on identical arrays

def test_attribute_metrics_equal_jax():
    rng = np.random.RandomState(0)
    got, want = AttributeMetrics(), JaxAttributeMetrics()
    assert got.summary() == want.summary()  # empty
    for n in (5, 0, 7):
        pred = (rng.rand(n, 12) < 0.3).astype(np.float32)
        gt = (rng.rand(n, 12) < 0.2).astype(np.float32)
        got.update(pred, gt)
        want.update(pred, gt)
    assert got.summary() == want.summary()


def test_frechet_and_statistics_equal_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(40, 6), rng.randn(30, 6) * 1.5 + 0.3
    sa, sb = fid.compute_statistics(a), fid.compute_statistics(b)
    ja, jb = jax_fid.compute_statistics(a), jax_fid.compute_statistics(b)
    for x, y in zip(sa + sb, ja + jb):
        assert np.array_equal(x, y)
    # the port takes the trace of the square root by eigendecompositions,
    # JAX by sqrtm: the same value to f64 rounding where the covariances are
    # full-rank, and to sqrtm's own accuracy on a singular product, of the
    # order of sqrt(f64 eps) (tests/test_torch_port_fid.py holds both at 2048-d)
    got, want = fid.frechet_distance(*sa, *sb), jax_fid.frechet_distance(*ja, *jb)
    assert abs(got - want) <= 1e-12 * want, (got, want)
    c = rng.randn(3, 6)  # a rank-2 covariance
    sc = fid.compute_statistics(c)
    got, want = fid.frechet_distance(*sa, *sc), jax_fid.frechet_distance(*sa, *sc)
    assert abs(got - want) <= 1e-7 * want, (got, want)


def test_inception_score_from_probs_equals_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(31, 10)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (1, 3, 4):
        assert inception_score.inception_score_from_probs(probs, splits) == \
            jax_is.inception_score_from_probs(probs, splits)


def test_consistency_helpers_equal_jax():
    rng = np.random.RandomState(3)
    b, o, h = 3, 4, 16
    img_rand, img_shift = rng.randn(b, h, h, 3), rng.randn(b, h, h, 3)
    masks = (rng.rand(b, o, h, h, 1) < 0.2).astype(np.float32)
    masks_shift = (rng.rand(b, o, h, h, 1) < 0.2).astype(np.float32)
    valid = (rng.rand(b, o) < 0.7).astype(np.float32)
    assert consistency.consistency_l1(img_rand, img_shift, masks, masks_shift, valid) == \
        jax_consistency.consistency_l1(img_rand, img_shift, masks, masks_shift, valid)
    r1, r2 = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(3):  # the same RandomState use, draw after draw
        assert consistency.random_pair_baseline(img_rand, r1) == \
            jax_consistency.random_pair_baseline(img_rand, r2)
    assert consistency.random_pair_baseline(img_rand) == jax_consistency.random_pair_baseline(img_rand)


def test_box_masks_equal_jax_rasterize():
    import jax.numpy as jnp

    from aglayout_tpu.ops.rasterize import rasterize_boxes

    rng = np.random.RandomState(5)
    xy0 = rng.uniform(0, 0.6, (2, 3, 2)).astype(np.float32)
    boxes = np.concatenate([xy0, np.minimum(xy0 + rng.uniform(0.1, 0.4, (2, 3, 2)), 1.0)], -1)
    want = np.asarray(rasterize_boxes(jnp.asarray(boxes.astype(np.float32)), 24, 24))[..., None]
    assert np.array_equal(consistency.box_masks(boxes, 24, 24, device="cpu"), want)


def test_offline_stand_ins_equal_jax():
    rng = np.random.RandomState(6)
    imgs = rng.randint(0, 256, (4, 24, 24, 3)).astype(np.uint8)
    assert np.array_equal(fid.PixelProjectionExtractor()(imgs),
                          jax_fid.PixelProjectionExtractor()(imgs))
    for seed, n in ((0, 179), (2, 7)):
        assert np.array_equal(inception_score.RandomFeatureClassifier(n, seed)(imgs),
                              jax_is.RandomFeatureClassifier(n, seed)(imgs))
    assert fid.PixelProjectionExtractor.name == jax_fid.PixelProjectionExtractor.name
    assert inception_score.RandomFeatureClassifier.name == jax_is.RandomFeatureClassifier.name


# ---- the command lines

def run_jax_cli(monkeypatch, capsys, main_fn, argv):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    main_fn()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def png_dirs(tmp_path_factory):
    """Two directories of small random PNGs, the same names in both."""
    from PIL import Image

    rng = np.random.RandomState(0)
    dirs = []
    for name in ("a", "b"):
        d = tmp_path_factory.mktemp(f"png_{name}")
        for i in range(8):
            Image.fromarray(rng.randint(0, 255, (24, 24, 3), dtype=np.uint8)).save(
                d / f"img_{i}.png")
        dirs.append(str(d))
    return dirs


def test_fid_cli_equals_jax(monkeypatch, capsys, png_dirs):
    # JAX's sqrtm of the 2048^2 product of two rank-7 covariances (13 s on an
    # 8-core CPU) against the port's eigendecompositions: within the report's
    # 5e-4 (measured 2.2e-7), and the port within 1e-7 of the trace taken from
    # the features' 8 x 8 cross product (measured 4.6e-9)
    from tests.test_torch_port_fid import REFEREE_TOL, TOL, referee_frechet_distance

    got = fid.main([*png_dirs, "--image_size", "24", "--device", "cpu"])
    want = run_jax_cli(monkeypatch, capsys, jax_fid.main, [*png_dirs, "--image_size", "24"])
    assert got.keys() == want.keys() and got["extractor"] == want["extractor"]
    assert np.isfinite(got["fid"]) and got["fid"] >= 0
    assert abs(got["fid"] - want["fid"]) <= TOL * want["fid"], (got, want)
    ext = fid.PixelProjectionExtractor()
    referee = referee_frechet_distance(*(ext(fid.load_images(d, 24)) for d in png_dirs))
    assert abs(got["fid"] - referee) <= REFEREE_TOL * referee, (got, referee)


def test_inception_score_cli_equals_jax(monkeypatch, capsys, png_dirs, tmp_path):
    got = inception_score.main([png_dirs[0], "--splits", "2", "--device", "cpu"])
    want = run_jax_cli(monkeypatch, capsys, jax_is.main, [png_dirs[0], "--splits", "2"])
    assert got == want and "random-feature" in got["classifier"]
    probs = np.full((30, 5), 0.2, np.float32)
    np.save(tmp_path / "probs.npy", probs)
    got = inception_score.main([str(tmp_path / "probs.npy"), "--device", "cpu"])
    np.testing.assert_allclose(got["inception_score_mean"], 1.0, atol=1e-5)


def test_lpips_cli_equals_jax(monkeypatch, capsys, png_dirs):
    from aglayout_tpu.eval import lpips as jax_lpips
    from aglayout_tpu_torch.eval import lpips

    got = lpips.main([*png_dirs, "--image_size", "24", "--device", "cpu"])
    want = run_jax_cli(monkeypatch, capsys, jax_lpips.main, [*png_dirs, "--image_size", "24"])
    assert got["pairs"] == want["pairs"] == 8 and got["backbone"] == want["backbone"]
    for k in ("mean_dist", "std_dist"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


@pytest.fixture(scope="module")
def pickle_dirs(tmp_path_factory):
    """Generation pickles of the same batches from the same weights, one
    directory written by JAX's `gen_pickle`, one by the port's."""
    from aglayout_tpu.eval.gen_pickle import dump_generation_pickles as jax_dump
    from aglayout_tpu_torch.data.synthetic import synthetic_batch
    from aglayout_tpu_torch.eval.gen_pickle import dump_generation_pickles

    cfg, jcfg = train_configs(64, batch_size=2, max_objects=3)
    models = drawn_train_state(cfg, "cpu", seed=0).models
    jmodels, jstate = jax_train_state(models, jcfg)
    rng = np.random.RandomState(0)
    batches = [synthetic_batch(rng, 2, 3, 64, cfg.num_classes, cfg.attribute_dim)
               for _ in range(2)]
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_pkl", "port_pkl"))
    jax_dump(jcfg, jmodels, jstate, iter(batches), jdir, max_batches=2)
    dump_generation_pickles(cfg, models, iter(batches), tdir, max_batches=2, device="cpu")
    return jdir, tdir


def test_gen_pickle_layout_equals_jax(pickle_dirs):
    jdir, tdir = pickle_dirs
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in ("batch_00000.pkl", "batch_00001.pkl"):
        with open(os.path.join(jdir, name), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(tdir, name), "rb") as f:
            got = pickle.load(f)
        assert got.keys() == want.keys()
        for k in got:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert type(got[k]) is np.ndarray and g.shape == w.shape and g.dtype == w.dtype, k
            if k not in ("imgs_rand", "imgs_shift"):  # the draws differ
                assert np.array_equal(g, w), k
        assert np.isfinite(got["imgs_rand"]).all()


@pytest.mark.parametrize("writer", [0, 1], ids=["jax_pickles", "port_pickles"])
def test_consistency_cli_reads_both_packages_pickles(monkeypatch, capsys, pickle_dirs, writer):
    d = pickle_dirs[writer]
    got = consistency.main([d, "--device", "cpu"])
    want = run_jax_cli(monkeypatch, capsys, jax_consistency.main, [d])
    assert got == want
    assert all(np.isfinite(v) for v in got.values())


@pytest.fixture(scope="module")
def metric_weights(tmp_path_factory):
    """Seeded InceptionV3, AlexNet features and LPIPS heads as weight files."""
    from aglayout_tpu_torch.eval.lpips import AlexNetFeatures
    from chip_smoke import seeded_inception

    d = tmp_path_factory.mktemp("metric_weights")
    torch.manual_seed(0)
    torch.save(seeded_inception(0).state_dict(), d / "inception.pth")
    torch.save(AlexNetFeatures().state_dict(), d / "alexnet.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                for i, c in enumerate((64, 192, 384, 256, 256))}, d / "lpips.pth")
    return {k: str(d / f"{k}.pth") for k in ("inception", "alexnet", "lpips")}


REPORT_FLAGS = ["--image_size", "64", "--batch_size", "2", "--synthetic", "--max_batches", "2",
                "--conv_dim", "8", "--d_conv_dim", "8", "--clstm_layers", "1",
                "--max_objects", "3", "--device", "cpu"]


@pytest.mark.parametrize("real", [False, True], ids=["stand_ins", "real_networks"])
def test_report_cli_on_synthetic_checkpoint(tmp_path, capsys, monkeypatch, metric_weights, real):
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.eval import report
    from aglayout_tpu_torch.train.loop import prepare_dirs
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.utils.checkpoint import save_state

    cfg = config_for(64, batch_size=2, conv_dim=8, d_conv_dim=8, clstm_layers=1, max_objects=3,
                     path=str(tmp_path))
    save_state(prepare_dirs(cfg)["models"], 7, create_train_state(cfg, "cpu", seed=3))
    argv = REPORT_FLAGS + ["--path", str(tmp_path), "--out_dir", str(tmp_path / "report")]
    # a 64-d pixel projection: the 2048-d one's two sqrtm take 26 s on a CPU
    monkeypatch.setattr(fid.PixelProjectionExtractor, "dim", 64)
    if real:
        argv += ["--inception_weights", metric_weights["inception"], "--alexnet_weights",
                 metric_weights["alexnet"], "--lpips_weights", metric_weights["lpips"]]
    out = report.main(argv)
    assert "restored checkpoint at step 7" in capsys.readouterr().out
    with open(tmp_path / "report" / "report.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert list(out) == ["config", "fid", "inception_score", "lpips_diversity", "consistency",
                         "attributes"]
    assert np.isfinite(out["fid"]["rand"]) and np.isfinite(out["fid"]["shift"])
    assert out["fid"]["n_images"] == 4 and out["lpips_diversity"]["pairs"] == 4
    assert out["inception_score"]["mean"] >= 1.0
    assert np.isfinite(out["lpips_diversity"]["mean"])
    for k in ("background_l1", "foreground_l1", "random_pair_l1"):
        assert np.isfinite(out["consistency"][k])
    assert out["attributes"]["num_objects"] > 0
    names = (out["fid"]["extractor"], out["inception_score"]["classifier"],
             out["lpips_diversity"]["backbone"])
    if real:
        assert names == ("inception-v3 pool3 (pytorch-fid weights)", "inception-v3 logits",
                         "lpips-v0.1-alexnet")
    else:
        assert all("not comparable" in n for n in names)


# ---- the device: the card unless asked for the host

CLIS = {
    "test": ("aglayout_tpu_torch.test", ["--synthetic"]),
    "demo_layout": ("aglayout_tpu_torch.infer.demo_layout", []),
    "fid": ("aglayout_tpu_torch.eval.fid", ["a", "b"]),
    "inception_score": ("aglayout_tpu_torch.eval.inception_score", ["probs.npy"]),
    "lpips": ("aglayout_tpu_torch.eval.lpips", ["a", "b"]),
    "consistency": ("aglayout_tpu_torch.eval.consistency", ["pickles"]),
    "report": ("aglayout_tpu_torch.eval.report", ["--synthetic"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_raises_without_a_card(name, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = CLIS[name]
    main = importlib.import_module(module).main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
