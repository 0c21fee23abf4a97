"""The port's train loop (`train/loop.py`) and logger against JAX's:
`prepare_dirs`, `load_cooccurrence`, the stdout line, the TensorBoard
scalars and six image grids (twin of tests/test_train_loop_logging.py),
the log and save cadence, a run off the main thread, and the device and
data-parallel refusals."""

import dataclasses
import glob
import os
import threading

import numpy as np
import pytest
import torch

from aglayout_tpu.config import Config as JaxConfig
from aglayout_tpu.train import loop as jax_loop
from aglayout_tpu.utils.logging import MetricLogger as JaxMetricLogger
from aglayout_tpu_torch.bench import TRAIN_SMALL
from aglayout_tpu_torch.config import Config, config_for
from aglayout_tpu_torch.data.synthetic import synthetic_batch
from aglayout_tpu_torch.train import loop
from aglayout_tpu_torch.utils.checkpoint import saved_steps
from aglayout_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(1)

EXPECT_TAGS = {
    "Result/img_real",
    "Result/img_real_rec",
    "Result/img_fake_rand",
    "Result/crop_real",
    "Result/crop_real_rec",
    "Result/crop_rand",
}


def _cfg(tmp_path, **kw):
    fields = dict(TRAIN_SMALL, allow_uniform_matrix=True, path=str(tmp_path),
                  vg_dir=str(tmp_path), save_step=1000, tensorboard_step=1000)
    return config_for(64, **dict(fields, **kw))


def _loader(cfg, seed=0):
    rng = np.random.RandomState(seed)
    while True:
        yield synthetic_batch(rng, cfg.batch_size, cfg.max_objects, cfg.image_size,
                              cfg.num_classes, cfg.attribute_dim)


def _iter_lines(out):
    return [line for line in out.splitlines() if line.startswith("iter [")]


def test_prepare_dirs_matches_jax(tmp_path):
    kw = dict(path=str(tmp_path), batch_size=16, z_dim=32, lambda_kl=0.1, dataset="vg")
    got = loop.prepare_dirs(Config(**kw))
    want = jax_loop.prepare_dirs(JaxConfig(**kw))
    assert got == want and all(os.path.isdir(d) for d in got.values())
    assert set(got) == {"logs", "models", "samples", "results"}


def test_load_cooccurrence_matches_jax(tmp_path):
    kw = dict(vg_dir=str(tmp_path), num_classes=7, attribute_dim=5)
    for Cfg, mod in ((Config, loop), (JaxConfig, jax_loop)):
        with pytest.raises(FileNotFoundError, match="allow_uniform_matrix"):
            mod.load_cooccurrence(Cfg(**kw))
    with pytest.warns(UserWarning, match="UNIFORMLY"):
        got = loop.load_cooccurrence(Config(allow_uniform_matrix=True, **kw))
    with pytest.warns(UserWarning, match="UNIFORMLY"):
        want = jax_loop.load_cooccurrence(JaxConfig(allow_uniform_matrix=True, **kw))
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert got.shape == (7, 5) and (got == 1).all()
    m = np.random.RandomState(0).randint(0, 9, (7, 5)).astype(np.float32)
    np.save(tmp_path / "matrix_obj_vs_att.npy", m)
    for allow in (True, False):
        got = loop.load_cooccurrence(Config(allow_uniform_matrix=allow, **kw))
        want = jax_loop.load_cooccurrence(JaxConfig(allow_uniform_matrix=allow, **kw))
        assert np.array_equal(got, m) and np.array_equal(want, m)


def test_stdout_line_matches_jax(capsys):
    metrics = {"D/loss": torch.tensor(1.23456), "G/loss": torch.tensor(-0.5),
               "G/kl": 12345.678912, "steps_per_sec": 2.5}
    MetricLogger(None).log_stdout(10, 900_000, metrics)
    got = capsys.readouterr().out
    JaxMetricLogger(None).log_stdout(10, 900_000, {k: float(v) for k, v in metrics.items()})
    want = capsys.readouterr().out
    assert got == want == ("iter [000010/900000], D/loss: 1.2346, G/loss: -0.5000, "
                           "G/kl: 12345.6789, steps_per_sec: 2.5000\n")


def test_loop_logs_scalars_and_generated_grids(tmp_path, capsys):
    cfg = _cfg(tmp_path, log_step=1, tensorboard_step=2)
    loop.train(cfg, loader=_loader(cfg), niter=2, use_tensorboard=True, device="cpu")
    assert len(_iter_lines(capsys.readouterr().out)) == 2
    log_dir = loop.prepare_dirs(cfg)["logs"]
    assert glob.glob(os.path.join(log_dir, "events.out.tfevents.*")), os.listdir(log_dir)

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    img_tags = set(acc.Tags().get("images", []))
    # SummaryWriter.add_images suffixes sub-image tags; match on prefix
    found = {t for t in EXPECT_TAGS if any(it.startswith(t) for it in img_tags)}
    assert found == EXPECT_TAGS, (sorted(img_tags), sorted(EXPECT_TAGS - found))
    scalars = set(acc.Tags().get("scalars", []))
    assert {"G/loss", "D/loss", "G/object_att_cls_loss"} <= scalars
    assert [e.step for e in acc.Scalars("G/loss")] == [2]


def test_log_and_save_cadence_then_resume(tmp_path, capsys):
    cfg = _cfg(tmp_path, log_step=2, save_step=3, save_num=2)
    window = []
    state, metrics = loop.train(cfg, loader=_loader(cfg), niter=7, use_tensorboard=False,
                                window_rates=window, device="cpu")
    lines = _iter_lines(capsys.readouterr().out)
    assert [line[:20] for line in lines] == [f"iter [{s:06d}/000007]" for s in (2, 4, 6)]
    assert all("steps_per_sec" in line and "G/loss" in line for line in lines)
    assert len(window) == 3 and all(r > 0 for r in window)
    model_dir = loop.prepare_dirs(cfg)["models"]
    assert saved_steps(model_dir) == [3, 6] and state.step == 7
    assert all(torch.isfinite(v) for k, v in metrics.items() if k != "images")
    # `resume l` (the default) continues at the latest checkpoint: steps 6 and 7
    state, _ = loop.train(cfg, loader=_loader(cfg), niter=8, use_tensorboard=False, device="cpu")
    assert state.step == 8 and _iter_lines(capsys.readouterr().out)[0].startswith("iter [000008")
    # scratch ignores them
    cfg = dataclasses.replace(cfg, resume="s")
    state, _ = loop.train(cfg, loader=_loader(cfg), niter=1, use_tensorboard=False, device="cpu")
    assert state.step == 1


def test_train_runs_off_the_main_thread(tmp_path):
    """Signal handlers go on the main thread only, so a loop started from
    another thread runs (JAX's installs them unconditionally and raises)."""
    cfg = _cfg(tmp_path, log_step=1)
    result = {}

    def run():
        try:
            result["state"], _ = loop.train(cfg, loader=_loader(cfg), niter=2,
                                            use_tensorboard=False, device="cpu")
        except Exception as e:  # reported below
            result["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert "error" not in result, result.get("error")
    assert result["state"].step == 2


def test_train_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    """num_devices other than 0 or the process group's size (1 without a
    group) raises and names the launcher; no CUDA device raises."""
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match=r"python -m torch\.distributed\.run"):
        loop.train(dataclasses.replace(cfg, num_devices=2), loader=_loader(cfg), niter=1,
                   device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(cfg, loader=_loader(cfg), niter=1)
    assert not os.path.exists(tmp_path / "all")  # nothing made before the refusals
