"""The port's `tools/quality_curve.py` and `tools/vg_scale_rehearsal.py` on
the CPU at small widths, on a miniature Visual Genome corpus built as
tests/test_torch_port_data.py builds one: the curve's rows and envelope
carry the JAX tool's keys (its committed artifacts/quality_curve.json), the
step-0 row is `evaluate_run` on the initial state, `--no-eval_at_init`
leaves step 0 out, and the train iterator is drawn once a step with no
batch dropped at an evaluation point (the JAX tool's two faults, repaired);
the rehearsal runs end to end with the JAX tool's result keys."""

import json
import os

import numpy as np
import pytest
import torch

from aglayout_tpu_torch.data import preprocess_vg
from aglayout_tpu_torch.data.cooccurrence import build_matrix
from aglayout_tpu_torch.eval import fid
from aglayout_tpu_torch.tools import quality_curve, vg_scale_rehearsal
from tests.torch_port_common import vg_etl, write_vg_corpus

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(conv_dim=8, z_dim=8, embedding_dim=8, clstm_layers=1, resi_num=1, d_conv_dim=8,
              max_objects=3)


@pytest.fixture(autouse=True)
def narrow_fid(monkeypatch):
    # a 64-d pixel projection: the 2048-d one's sqrtm take 13 s each here
    monkeypatch.setattr(fid.PixelProjectionExtractor, "dim", 64)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's ETL output over the miniature corpus, with its
    co-occurrence matrix and the images beside it."""
    root = tmp_path_factory.mktemp("vg")
    write_vg_corpus(root)
    out = vg_etl(preprocess_vg, root, "port")
    with open(os.path.join(out, "vocab.json")) as f:
        vocab = json.load(f)
    np.save(os.path.join(out, "matrix_obj_vs_att.npy"),
            build_matrix(os.path.join(out, "train.h5"), len(vocab["object_idx_to_name"]),
                         len(vocab["attribute_idx_to_name"])))
    os.symlink(root / "images", os.path.join(out, "images"))
    return out


def _jax_curve():
    with open(os.path.join(REPO, "artifacts", "quality_curve.json")) as f:
        return json.load(f)


def _argv(corpus, tmp_path, *extra):
    return ["--corpus", corpus, "--image_size", "64", "--batch_size", "2", "--eval_batches", "1",
            "--work_dir", str(tmp_path / "work"), "--out", str(tmp_path / "curve"),
            "--device", "cpu", *extra]


def test_quality_curve(corpus, tmp_path, monkeypatch):
    """Rows at steps 0, 1, 2 with the JAX tool's keys and envelope; row 0
    equals `evaluate_run` on a fresh state of the same seed; the iterator is
    drawn exactly once a step and every drawn batch is trained on, in order."""
    from aglayout_tpu_torch import parallel
    from aglayout_tpu_torch.data import dataset
    from aglayout_tpu_torch.eval.report import evaluate_run
    from aglayout_tpu_torch.train import state as train_state

    drawn, trained, cfgs = [], [], []
    get_dataloaders, make_step = dataset.get_dataloaders, parallel.make_sharded_train_step
    create_train_state = train_state.create_train_state

    class Counted:
        def __init__(self, loader):
            self.loader = loader

        def __iter__(self):
            for b in self.loader:
                drawn.append(b["imgs"])
                yield b

    def counted_loaders(cfg, *a, **kw):
        train, val, vocab = get_dataloaders(cfg, *a, **kw)
        return Counted(train), val, vocab

    def recording_step(step, group):
        inner = make_step(step, group)

        def step_fn(state, batch, **kw):
            trained.append(batch["imgs"].numpy().copy())
            return inner(state, batch, **kw)

        return step_fn

    def capturing_state(cfg, *a, **kw):
        cfgs.append(cfg)
        return create_train_state(cfg, *a, **kw)

    monkeypatch.setattr(dataset, "get_dataloaders", counted_loaders)
    monkeypatch.setattr(parallel, "make_sharded_train_step", recording_step)
    monkeypatch.setattr(train_state, "create_train_state", capturing_state)
    curve = quality_curve.main(_argv(corpus, tmp_path, "--steps", "2", "--eval_every", "1"),
                               **NARROW)

    assert [r["step"] for r in curve] == [0, 1, 2]
    assert len(drawn) == 2 and len(trained) == 2
    for got, want in zip(trained, drawn):
        np.testing.assert_array_equal(got, want)
    jax_out = _jax_curve()
    with open(str(tmp_path / "curve") + ".json") as f:
        out = json.load(f)
    assert list(out) == list(jax_out)
    assert out["curve"] == curve
    for row in curve:
        assert list(row) == list(jax_out["curve"][0])
        assert all(np.isfinite(v) for k, v in row.items() if k != "fid_extractor"), row
    assert os.path.getsize(str(tmp_path / "curve") + ".png") > 0

    cfg = cfgs[0]
    fresh = create_train_state(cfg, "cpu", seed=cfg.seed)
    _, val, _ = get_dataloaders(cfg)
    rep = evaluate_run(cfg, fresh.models, lambda: val.epoch(0), str(tmp_path / "direct"),
                       device="cpu", max_batches=1, keep_pickles=False)
    want = quality_curve.curve_row(0, rep, 0.0)
    assert {k: v for k, v in curve[0].items() if k != "eval_wall_s"} == \
        {k: v for k, v in want.items() if k != "eval_wall_s"}


def test_quality_curve_no_eval_at_init(corpus, tmp_path):
    assert quality_curve.parser().parse_args(["--corpus", "x"]).eval_at_init is True
    curve = quality_curve.main(_argv(corpus, tmp_path, "--steps", "1", "--eval_every", "1",
                                     "--no-eval_at_init"), **NARROW)
    assert [r["step"] for r in curve] == [1]


def test_vg_scale_rehearsal(tmp_path):
    """48 images (at 40 the ETL keeps no val image), 2 steps of a log window
    each: the JAX tool's keys (its committed artifacts/vg_scale_rehearsal.json;
    the corpus and ETL seconds, which it writes when it builds the corpus,
    and the card field besides)."""
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps({"steps_per_sec_64_b2": 1.5}))
    out = tmp_path / "rehearsal.json"
    res = vg_scale_rehearsal.main(
        ["--n_images", "48", "--steps", "2", "--batch_size", "2", "--keep",
         str(tmp_path / "corpus"), "--train_bench", str(bench), "--out", str(out),
         "--device", "cpu"], log_step=1, **NARROW)
    with open(os.path.join(REPO, "artifacts", "vg_scale_rehearsal.json")) as f:
        jax_keys = set(json.load(f))
    assert set(res) == jax_keys | {"corpus_build_s", "etl_s", "card"}
    assert json.loads(out.read_text()) == res
    assert res["compute_only_steps_per_sec"] == 1.5
    assert np.isfinite(res["final_G_loss"]) and np.isfinite(res["final_D_loss"])
    assert os.path.exists(tmp_path / "corpus" / "train.h5")  # --keep keeps it
