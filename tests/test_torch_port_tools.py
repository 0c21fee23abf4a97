"""The port's last two bilinear ops and its `tools/` twins against the JAX
package's, on the CPU: `uncrop_bbox` and `crop_bbox_flat` on seeded numpy
inputs (f32, 1e-6), `import_reference_artifacts` byte for byte,
`bench_train_table`'s table and its subprocesses, and `train_evidence`
at small widths (its corpus equal to JAX's, JAX's keys, the assertion)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from aglayout_tpu.ops import crop_bbox_dense as jax_crop_bbox_dense
from aglayout_tpu.ops import crop_bbox_flat as jax_crop_bbox_flat
from aglayout_tpu.ops import uncrop_bbox as jax_uncrop_bbox
from aglayout_tpu_torch.ops.bilinear import crop_bbox_dense, crop_bbox_flat, uncrop_bbox
from tests.torch_port_common import nchw, nhwc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import bench_train_table as jax_bench_train_table  # noqa: E402
from tools import import_reference_artifacts as jax_import  # noqa: E402


# ---- ops/bilinear.py: uncrop_bbox, crop_bbox_flat


def _uncrop_boxes():
    """Seeded boxes with a zero-width one, a zero-height one, and boxes
    partly off the canvas."""
    rng = np.random.RandomState(3)
    xy0 = rng.uniform(0.0, 0.6, (6, 2))
    boxes = np.concatenate([xy0, xy0 + rng.uniform(0.1, 0.4, (6, 2))], -1).astype(np.float32)
    boxes[0, 2] = boxes[0, 0]  # zero width
    boxes[1, 3] = boxes[1, 1]  # zero height
    boxes[2] = [-0.3, 0.2, 0.5, 1.4]  # off the left and the bottom
    boxes[3] = [0.7, -0.25, 1.3, 0.45]  # off the right and the top
    return boxes


@pytest.mark.parametrize("fill_value", [0.0, -7.0])
@pytest.mark.parametrize("out_h,out_w,hh,ww", [(16, None, 8, 8), (12, 20, 5, 7)])
def test_uncrop_bbox_matches_jax(fill_value, out_h, out_w, hh, ww):
    rng = np.random.RandomState(4)
    feats = rng.randn(6, hh, ww, 3).astype(np.float32)
    boxes = _uncrop_boxes()
    want = np.asarray(jax_uncrop_bbox(jnp.asarray(feats), jnp.asarray(boxes), out_h, out_w,
                                      fill_value=fill_value))
    got = uncrop_bbox(nchw(feats), torch.from_numpy(boxes), out_h, out_w,
                      fill_value=fill_value)
    assert got.dtype == torch.float32 and got.shape == (6, 3, out_h, out_w or out_h)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-6)
    assert (nhwc(got) == fill_value).any()  # some canvas pixels lie outside their box


def test_uncrop_bbox_roundtrip():
    """Twin of tests/test_ops.py::test_uncrop_bbox_roundtrip: outside the box
    the fill, inside the crop, and the full box's corner the crop's corner."""
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 8, 8, 3).astype(np.float32)
    boxes = np.array([[0.25, 0.25, 0.75, 0.75], [0.0, 0.0, 1.0, 1.0]], np.float32)
    out = nhwc(uncrop_bbox(nchw(feats), torch.from_numpy(boxes), 16,
                           fill_value=-7.0))
    assert out.shape == (2, 16, 16, 3)
    assert np.all(out[0, 0, 0] == -7.0) and np.all(out[0, -1, -1] == -7.0)
    assert np.all(out[0, 8, 8] != -7.0)
    np.testing.assert_allclose(out[1, 0, 0], feats[1, 0, 0], atol=1e-5)


def test_crop_bbox_flat_matches_jax():
    """Boxes partly off the map, a zero-width one, and `box_to_feat` naming
    one map several times and another not at all."""
    rng = np.random.RandomState(6)
    feats = rng.randn(3, 12, 10, 4).astype(np.float32)
    boxes = _uncrop_boxes()
    box_to_feat = np.array([2, 0, 2, 2, 0, 0], np.int32)
    args = (jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(box_to_feat), 8, 6)
    got = nhwc(crop_bbox_flat(nchw(feats), torch.from_numpy(boxes),
                              torch.from_numpy(box_to_feat), 8, 6))
    assert got.shape == (6, 8, 6, 4)
    # JAX's body op by op: the port's arithmetic, 1e-6
    np.testing.assert_allclose(got, np.asarray(jax_crop_bbox_flat.__wrapped__(*args)), rtol=0,
                               atol=1e-6)
    # jitted, XLA fuses the sample coordinates' arithmetic and rounds them
    # apart (2.1e-6 here; the eval forward's crops show the same)
    np.testing.assert_allclose(got, np.asarray(jax_crop_bbox_flat(*args)), rtol=0, atol=1e-5)


def test_crop_bbox_dense_matches_flat():
    """Twin of tests/test_ops.py::test_crop_bbox_dense_matches_flat, and the
    port's dense crops against JAX's."""
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 12, 12, 3).astype(np.float32)
    boxes = rng.uniform(0.1, 0.9, (2, 5, 4)).astype(np.float32)
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 0.05)
    dense = crop_bbox_dense(nchw(feats), torch.from_numpy(boxes), 8)
    flat = crop_bbox_flat(nchw(feats), torch.from_numpy(boxes.reshape(-1, 4)),
                          torch.from_numpy(np.repeat(np.arange(2), 5)), 8)
    np.testing.assert_allclose(dense.reshape(-1, 3, 8, 8).numpy(), flat.numpy(), atol=1e-5)
    want = np.asarray(jax_crop_bbox_dense(jnp.asarray(feats), jnp.asarray(boxes), 8))
    np.testing.assert_allclose(dense.permute(0, 1, 3, 4, 2).numpy(), want, rtol=0, atol=1e-6)


# ---- tools/import_reference_artifacts.py


def _vocab():
    vocab = {}
    for kind, names in (("object", ["__image__", "tree", "car", "sky"]),
                        ("attribute", ["white", "red", "wooden"]),
                        ("pred", ["__in_image__", "on", "has"])):
        vocab[f"{kind}_idx_to_name"] = names
        vocab[f"{kind}_name_to_idx"] = {n: i for i, n in enumerate(names)}
    return vocab


def _reference_files(tmp_path, vocab):
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    torch.save(torch.from_numpy(np.random.RandomState(0).randint(0, 50, (4, 3)).astype(np.float64)),
               tmp_path / "matrix.pt")
    return str(tmp_path / "vocab.json"), str(tmp_path / "matrix.pt")


def test_import_reference_artifacts_equals_jax(tmp_path):
    """The port's vocab.json and matrix_obj_vs_att.npy are the JAX tool's
    bytes; the CLI writes the same."""
    from aglayout_tpu_torch.tools import import_reference_artifacts as port

    vocab_path, matrix_path = _reference_files(tmp_path, _vocab())
    outs = {}
    for tag, mod in (("jax", jax_import), ("port", port)):
        out = tmp_path / tag
        out.mkdir()
        vocab = mod.import_vocab(vocab_path, str(out))
        m = mod.import_matrix(matrix_path, str(out), vocab)
        assert m.dtype == np.float32 and m.shape == (4, 3)
        outs[tag] = out
    for name in ("vocab.json", "matrix_obj_vs_att.npy"):
        assert (outs["port"] / name).read_bytes() == (outs["jax"] / name).read_bytes(), name
    port.main(["--vocab", vocab_path, "--matrix", matrix_path, "--out", str(tmp_path / "cli")])
    for name in ("vocab.json", "matrix_obj_vs_att.npy"):
        assert (tmp_path / "cli" / name).read_bytes() == (outs["jax"] / name).read_bytes(), name


@pytest.mark.parametrize("fault", ["missing_key", "inconsistent", "matrix_shape"])
def test_import_reference_artifacts_refuses_as_jax(tmp_path, fault):
    from aglayout_tpu_torch.tools import import_reference_artifacts as port

    vocab = _vocab()
    if fault == "missing_key":
        del vocab["pred_name_to_idx"]
    elif fault == "inconsistent":
        vocab["object_name_to_idx"].update(car=1, sky=1)  # two wrong: one may be an alias
    vocab_path, matrix_path = _reference_files(tmp_path, vocab)
    if fault == "matrix_shape":
        vocab = dict(vocab, attribute_idx_to_name=["white", "red"])
    errors = []
    for mod in (jax_import, port):
        with pytest.raises(ValueError) as e:
            if fault == "matrix_shape":
                mod.import_matrix(matrix_path, str(tmp_path), vocab)
            else:
                mod.import_vocab(vocab_path, str(tmp_path))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---- tools/bench_train_table.py


def _rows():
    return [dict(image_size=s, batch_size=b, compute=c, remat=r, steps_per_sec=v,
                 imgs_per_sec=round(v * b, 1), warm_call_s=1.5, card="NVIDIA H100, 700.00 W")
            for s, b, c, r, v in ((64, 8, "f32", False, 3.1), (64, 8, "bf16", False, 3.6),
                                  (128, 32, "f32", True, 0.4), (128, 32, "bf16", False, 1.3))]


def test_bench_train_table_write_equals_jax(tmp_path):
    from aglayout_tpu_torch.tools import bench_train_table as port

    port._write(str(tmp_path / "port.json"), _rows())
    jax_bench_train_table._write(str(tmp_path / "jax.json"),
                                 [{k: v for k, v in r.items() if k != "card"} for r in _rows()])
    got = json.loads((tmp_path / "port.json").read_text())
    assert [r.pop("card") for r in got["rows"]] == ["NVIDIA H100, 700.00 W"] * 4
    assert got == json.loads((tmp_path / "jax.json").read_text())
    assert got["steps_per_sec_128_b32_remat"] == 0.4 and got["steps_per_sec_128_b32_bf16"] == 1.3


class _FakeRuns:
    """subprocess.run for the tables' --single children: each call's spec
    is recorded and answered from `replies` in turn ("oom", "fail", "row")."""

    def __init__(self, replies):
        self.replies, self.specs = list(replies), []

    def __call__(self, cmd, **kw):
        spec = cmd[cmd.index("--single") + 1]
        self.specs.append(spec)
        reply = self.replies.pop(0)
        if reply == "row":
            size, b, compute = spec.split(":")[:3]
            row = dict(image_size=int(size), batch_size=int(b), compute=compute,
                       remat=spec.endswith(":remat"), steps_per_sec=2.0, imgs_per_sec=16.0,
                       warm_call_s=1.0)
            return subprocess.CompletedProcess(cmd, 0, "ROW " + json.dumps(row) + "\n", "")
        err = ("torch.cuda.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB"
               if reply == "oom" else "RuntimeError: something else")
        return subprocess.CompletedProcess(cmd, 1, "", err)


@pytest.mark.parametrize("replies", [["oom", "row", "row"], ["fail", "fail", "row", "row"],
                                     ["fail", "fail", "fail", "row"]])
def test_bench_train_table_retries_as_jax(tmp_path, monkeypatch, replies):
    """After an out-of-memory failure the next attempt takes remat, and the
    last of three attempts takes it anyway: the same children, in the same
    order, as the JAX tool's; an unmeasurable row is skipped."""
    from aglayout_tpu_torch.tools import bench_train_table as port

    specs, written = [], []
    for tag, run in (("jax", lambda out: jax_bench_train_table.main()),
                     ("port", lambda out: port.main(["--configs", "64:8", "--out", out,
                                                     "--device", "cpu"]))):
        fake = _FakeRuns(replies)
        monkeypatch.setattr(subprocess, "run", fake)
        out = str(tmp_path / f"{tag}.json")
        monkeypatch.setattr(sys, "argv", ["bench_train_table.py", "--configs", "64:8",
                                          "--out", out])
        run(out)
        specs.append(fake.specs)
        written.append(json.loads(open(out).read()))
    assert specs[0] == specs[1]
    assert written[0] == written[1]
    if replies[0] == "oom":
        assert specs[0] == ["64:8:f32", "64:8:f32:remat", "64:8:bf16"]
    elif replies[2] == "row":
        assert specs[0] == ["64:8:f32", "64:8:f32", "64:8:f32:remat", "64:8:bf16"]
    else:
        assert [r["compute"] for r in written[0]["rows"]] == ["bf16"]


def test_bench_train_table_skips_measured(tmp_path, monkeypatch, capsys):
    from aglayout_tpu_torch.tools import bench_train_table as port

    out = str(tmp_path / "t.json")
    port._write(out, _rows())
    monkeypatch.setattr(subprocess, "run", _FakeRuns(["row", "row"]))
    rows = port.table("64:8,128:32,128:8", out, 10, "cpu")
    assert capsys.readouterr().out.count("already measured, skip") == 4
    assert [(r["image_size"], r["batch_size"], r["compute"]) for r in rows[4:]] == \
        [(128, 8, "f32"), (128, 8, "bf16")]
    assert json.loads(open(out).read())["steps_per_sec_128_b8_bf16"] == 2.0


def test_bench_train_table_row(monkeypatch):
    """A --single row (in process, small widths, the host clock) has the JAX
    tool's keys and the card field, from `bench.run_train`."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import bench_train_table as port

    small = {k: v for k, v in TRAIN_SMALL.items() if k not in ("batch_size", "max_objects")}
    row = port.measure(64, 3, False, 1, device="cpu", **small)
    assert list(row) == ["image_size", "batch_size", "compute", "remat", "steps_per_sec",
                         "imgs_per_sec", "warm_call_s", "card"]
    assert row["compute"] == "f32" and row["steps_per_sec"] > 0
    assert row["card"].startswith("cpu")


# ---- tools/train_evidence.py


def test_train_evidence_corpus_equals_jax():
    from aglayout_tpu.data.synthetic import synthetic_cooccurrence, synthetic_scene_batch
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.tools.train_evidence import scene_corpus

    cfg = config_for(64, batch_size=8)
    corpus, matrix = scene_corpus(cfg, 3)
    rng = np.random.RandomState(7)
    want = [synthetic_scene_batch(rng, cfg.batch_size, cfg.max_objects, cfg.image_size,
                                  cfg.num_classes) for _ in range(3)]
    for got, w in zip(corpus, want):
        assert set(got) == set(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
    np.testing.assert_array_equal(matrix, synthetic_cooccurrence(rng, cfg.num_classes))


def _evidence_argv(out):
    return ["--steps", "6", "--log_every", "2", "--batch_size", "3", "--corpus_batches", "2",
            "--out", str(out), "--device", "cpu"]


def test_train_evidence_files_and_keys(tmp_path):
    """At small widths, a few steps: the four files, the JAX tool's keys in
    metrics.jsonl and summary.json (the card and deterministic fields
    besides)."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import train_evidence

    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    summary = train_evidence.run(train_evidence.parser().parse_args(_evidence_argv(tmp_path)),
                                 **small)
    jax_dir = os.path.join(REPO, "artifacts", "train_evidence")
    with open(os.path.join(jax_dir, "summary.json")) as f:
        jax_summary = json.load(f)
    with open(os.path.join(jax_dir, "metrics.jsonl")) as f:
        jax_row = json.loads(f.readline())
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert all(list(r) == list(jax_row) for r in rows)
    assert list(summary) == list(jax_summary) + ["card", "deterministic", "tf32", "segments",
                                                 "kernel_check"]
    assert summary["deterministic"] is False and summary["tf32"] is False
    assert [(s["from_step"], s["to_step"]) for s in summary["segments"]] == [(0, 6)]
    check = summary["kernel_check"]  # the host takes the plain paths both times
    assert check["max_abs_err_over_max"] == 0.0 and check["launches"] == {}
    assert check["expected"] == [] and check["limit"] == train_evidence.KERNEL_LIMIT
    assert summary["final"] == rows[-1] and summary["steps"] == 6
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert all(np.isfinite(v) for v in rows[-1].values())
    for name in ("loss_curves.png", "samples.png"):
        assert (tmp_path / name).stat().st_size > 0
    from PIL import Image

    assert Image.open(tmp_path / "samples.png").size == (3 * 64, 3 * 64)


def test_train_evidence_deterministic_repeats_itself(tmp_path):
    """`--deterministic`: the steps under torch's deterministic algorithms,
    two runs' metrics equal, the summary says so, and the mode is off
    again after the run."""
    import torch

    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import train_evidence

    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    runs = []
    for name in ("a", "b"):
        argv = _evidence_argv(tmp_path / name) + ["--deterministic"]
        runs.append(train_evidence.run(train_evidence.parser().parse_args(argv), **small))
        assert not torch.are_deterministic_algorithms_enabled()
    assert all(r["deterministic"] is True for r in runs)
    assert (tmp_path / "a" / "metrics.jsonl").read_text() == \
        (tmp_path / "b" / "metrics.jsonl").read_text()


def test_train_evidence_asserts_improvement(tmp_path):
    """With a learning rate of 0 nothing is learnt: the tool raises."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import train_evidence

    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    with pytest.raises(AssertionError, match="reconstruction did not improve"):
        train_evidence.main(_evidence_argv(tmp_path), learning_rate=0.0, **small)
    assert (tmp_path / "summary.json").exists()  # written before the check


def _load_state(state_dir, step: int):
    return torch.load(os.path.join(state_dir, f"step_{step}.pt"), weights_only=True)


def _equal(a, b) -> bool:
    """Nested checkpoint payloads equal, tensors by `torch.equal`."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _segment_run(tmp_path, name: str, size: int, *extra):
    """`train_evidence.run` at small widths, 8 steps logged every 2, with
    its state in `<name>_state`: the summary, or None after a segment."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import train_evidence

    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    argv = ["--steps", "8", "--log_every", "2", "--batch_size", "3", "--corpus_batches", "3",
            "--image_size", str(size), "--out", str(tmp_path / name),
            "--state_dir", str(tmp_path / f"{name}_state"), "--device", "cpu", *extra]
    return train_evidence.run(train_evidence.parser().parse_args(argv),
                              object_size=32 if size == 64 else 64, **small)


FINAL_FILES = ("loss_curves.png", "samples.png", "summary.json")


@pytest.mark.parametrize("size", [64, 128])
def test_train_evidence_segments_equal_one_run(tmp_path, size):
    """S + S steps in two calls equal 2S in one: metrics.jsonl byte-equal,
    the saved states equal tensor for tensor (nets, Adams, the draws'
    generator, the step); the plots, samples and summary appear only when
    the run reaches --steps; the summary lists both segments and its
    steps/s is the steps over their summed seconds."""
    one = _segment_run(tmp_path, "one", size)
    assert _segment_run(tmp_path, "two", size, "--segment_steps", "4") is None
    assert not any((tmp_path / "two" / f).exists() for f in FINAL_FILES)
    progress = json.loads((tmp_path / "two" / "progress.json").read_text())
    assert [(s["from_step"], s["to_step"]) for s in progress["segments"]] == [(0, 4)]
    two = _segment_run(tmp_path, "two", size, "--segment_steps", "4")
    assert all((tmp_path / "two" / f).stat().st_size > 0 for f in FINAL_FILES)
    assert (tmp_path / "one" / "metrics.jsonl").read_bytes() == \
        (tmp_path / "two" / "metrics.jsonl").read_bytes()
    assert len((tmp_path / "two" / "metrics.jsonl").read_text().splitlines()) == 4
    assert _equal(_load_state(tmp_path / "one_state", 8), _load_state(tmp_path / "two_state", 8))
    assert os.listdir(tmp_path / "two_state") == ["step_8.pt"]  # the newest state only
    assert [(s["from_step"], s["to_step"]) for s in two["segments"]] == [(0, 4), (4, 8)]
    assert two["steps_per_sec"] == 8 / sum(s["seconds"] for s in two["segments"])
    for k in ("final", "rec_l1_first_window", "rec_l1_last_window", "kernel_check"):
        assert two[k] == one[k], k


def test_train_evidence_resumes_a_segment_cut_short(tmp_path):
    """A segment cut short after its state was saved at step 4 but with a
    log of step 6 written: the resume drops that line and the run ends as
    the unsplit one does."""
    _segment_run(tmp_path, "one", 64)
    _segment_run(tmp_path, "cut", 64, "--segment_steps", "4")
    lines = (tmp_path / "one" / "metrics.jsonl").read_text().splitlines()
    with open(tmp_path / "cut" / "metrics.jsonl", "a") as f:
        f.write(lines[2].replace('"G/rec_img": ', '"G/rec_img": 9') + "\n")  # step 6, not saved
    assert _segment_run(tmp_path, "cut", 64, "--segment_steps", "4") is not None
    assert (tmp_path / "cut" / "metrics.jsonl").read_text().splitlines() == lines
    assert _equal(_load_state(tmp_path / "one_state", 8), _load_state(tmp_path / "cut_state", 8))


def test_train_evidence_finished_run_changes_nothing(tmp_path):
    """Run again after it reached --steps, the tool returns the summary and
    writes nothing: every file's bytes and modification time as before."""
    first = _segment_run(tmp_path, "run", 64, "--segment_steps", "8")
    files = sorted(p for p in tmp_path.rglob("*") if p.is_file())
    before = {p: (p.read_bytes(), p.stat().st_mtime_ns) for p in files}
    assert _segment_run(tmp_path, "run", 64, "--segment_steps", "8") == first
    assert sorted(p for p in tmp_path.rglob("*") if p.is_file()) == files
    assert {p: (p.read_bytes(), p.stat().st_mtime_ns) for p in files} == before


@pytest.mark.parametrize("fault, match", [
    ("other_args", "resume with its arguments"),
    ("no_progress", "do not cover steps 0 to 4"),
])
def test_train_evidence_refuses_a_resume_it_cannot_account_for(tmp_path, fault, match):
    """A resume with another argument than its saved segments' (here --tf32),
    or one whose progress.json does not cover the steps up to the saved
    state, raises before it trains; each segment records its arguments."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL

    _segment_run(tmp_path, "run", 64, "--segment_steps", "4")
    progress = json.loads((tmp_path / "run" / "progress.json").read_text())
    assert progress["segments"][0]["run_args"] == {
        "steps": 8, "image_size": 64, "batch_size": 3, "corpus_batches": 3, "log_every": 2,
        "deterministic": False, "tf32": False, "device": "cpu", "object_size": 32,
        **{k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}}
    assert progress["segments"][0]["graphed"] is False  # the CPU steps eagerly
    extra = ["--tf32"] if fault == "other_args" else []
    if fault == "no_progress":
        os.remove(tmp_path / "run" / "progress.json")
    with pytest.raises(ValueError, match=match):
        _segment_run(tmp_path, "run", 64, "--segment_steps", "4", *extra)
    assert len((tmp_path / "run" / "metrics.jsonl").read_text().splitlines()) == 2


def test_train_evidence_reruns_a_segment_cut_before_its_state(tmp_path, monkeypatch):
    """A segment stopped after its entry in progress.json was written but
    before its state was saved: the resume drops the entry and runs the
    segment again whole, and the run ends as the unsplit one does, its
    segments covering the steps once."""
    from aglayout_tpu_torch.utils import checkpoint

    _segment_run(tmp_path, "one", 64)
    _segment_run(tmp_path, "cut", 64, "--segment_steps", "4")
    save_state = checkpoint.save_state

    def killed(*args, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint, "save_state", killed)
    with pytest.raises(KeyboardInterrupt):
        _segment_run(tmp_path, "cut", 64, "--segment_steps", "4")
    progress = json.loads((tmp_path / "cut" / "progress.json").read_text())
    assert [(s["from_step"], s["to_step"]) for s in progress["segments"]] == [(0, 4), (4, 8)]
    monkeypatch.setattr(checkpoint, "save_state", save_state)
    summary = _segment_run(tmp_path, "cut", 64, "--segment_steps", "4")
    assert [(s["from_step"], s["to_step"]) for s in summary["segments"]] == [(0, 4), (4, 8)]
    assert (tmp_path / "cut" / "metrics.jsonl").read_bytes() == \
        (tmp_path / "one" / "metrics.jsonl").read_bytes()
    assert _equal(_load_state(tmp_path / "one_state", 8), _load_state(tmp_path / "cut_state", 8))


def test_train_evidence_kernel_check_refuses_a_launch_with_the_routes_off(tmp_path, monkeypatch):
    """If the forward with every kernel route off launched a kernel (a route
    switch that kernel_routes_off missed), the check would hold the kernel
    against itself: it raises instead."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import train_evidence

    calls = []

    def counts():  # a launch between every two readings: the off forward's too
        calls.append(1)
        return {"residual_trunk": len(calls)}

    monkeypatch.setattr(train_evidence, "launch_counts", counts)
    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    with pytest.raises(AssertionError, match="every route off launched"):
        train_evidence.run(train_evidence.parser().parse_args(_evidence_argv(tmp_path)), **small)


@pytest.mark.parametrize("argv, match", [
    (["--segment_steps", "4"], "needs a --state_dir"),
    (["--segment_steps", "3", "--state_dir", "x"], "multiples of --log_every"),
])
def test_train_evidence_refuses_segments_it_cannot_resume(tmp_path, argv, match):
    from aglayout_tpu_torch.tools import train_evidence

    with pytest.raises(ValueError, match=match):
        train_evidence.run(train_evidence.parser().parse_args(
            _evidence_argv(tmp_path) + argv))


@pytest.mark.parametrize("on", [False, True])
def test_train_evidence_tf32_sets_and_restores_both_flags(tmp_path, monkeypatch, on):
    """The steps run with TF32 in cuBLAS and cuDNN as --tf32 says, the
    summary records it, and both flags come back afterwards."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import train_evidence

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", not on)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not on)
    setup, seen = train_evidence.setup, []

    def recording_setup(*args, **kw):
        device, cfg, corpus, state, step = setup(*args, **kw)

        def recorded(*a, **k):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return step(*a, **k)
        return device, cfg, corpus, state, recorded

    monkeypatch.setattr(train_evidence, "setup", recording_setup)
    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    argv = ["--steps", "2", "--log_every", "2", "--batch_size", "3", "--corpus_batches", "2",
            "--out", str(tmp_path), "--device", "cpu"] + (["--tf32"] if on else [])
    summary = train_evidence.run(train_evidence.parser().parse_args(argv), **small)
    assert seen == [(on, on)] * 2 and summary["tf32"] is on
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (not on,
                                                                                      not on)


@pytest.mark.parametrize("mode", ["default", "deterministic"])
def test_step_determinism_on_the_host(tmp_path, mode):
    """At small widths on the CPU, where a step repeats itself: the two runs
    are bit-equal at every checked step in both modes, with the same
    fingerprints and no param difference; the JSON is written; the
    deterministic mode is off again afterwards."""
    import torch

    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import step_determinism

    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    out = step_determinism.main(["--mode", mode, "--steps", "4", "--check_at", "2", "4",
                                 "--batch_size", "3", "--corpus_batches", "2",
                                 "--out", str(tmp_path / "det.json"), "--device", "cpu"], **small)
    assert out["bit_equal"] == {"2": True, "4": True}
    assert out["max_param_diff"] == {"2": 0.0, "4": 0.0}
    assert all(a == b and len(a) == 64 for a, b in out["fingerprints"].values())
    assert out["fingerprints"]["2"] != out["fingerprints"]["4"]
    assert len(out["ms_per_step"]) == 2 and all(t > 0 for t in out["ms_per_step"])
    assert json.loads((tmp_path / "det.json").read_text()) == out
    assert not torch.are_deterministic_algorithms_enabled()
    assert out["runs"] == ["eager", "eager"]  # the graph is the card's



def test_compare_evidence_reads_the_committed_runs(tmp_path):
    """On the committed runs (JAX's and the port's): each run's first and
    last windows and reduction are those its summary.json gives, a 10-log
    mean is the mean of those logs, a step past the run's end is null, and
    a run against itself shares every line, against another none."""
    from aglayout_tpu_torch.tools import compare_evidence

    dirs = [os.path.join(REPO, "artifacts", d) for d in ("train_evidence",
                                                         "torch_train_evidence")]
    out = compare_evidence.main(dirs + [dirs[0], "--at", "200", "20000", "--out",
                                        str(tmp_path / "cmp.json")])
    assert json.loads((tmp_path / "cmp.json").read_text()) == out
    for d, run in zip(dirs, out["runs"]):
        with open(os.path.join(d, "summary.json")) as f:
            summary = json.load(f)
        assert run["steps"] == summary["steps"]
        assert run["first_window"] == summary["rec_l1_first_window"]
        assert run["last_window"] == summary["rec_l1_last_window"]
        assert run["reduction"] == summary["rec_l1_reduction"]
        rows = [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
        end = [r["step"] for r in rows].index(200) + 1
        assert run["mean_of_10_logs_at"]["200"] == float(np.mean(
            [r["G/rec_img"] for r in rows[end - 10:end]]))
        assert run["mean_of_10_logs_at"]["20000"] is None
        assert run["reduction_if_ended_at"]["20000"] is None
    with open(os.path.join(dirs[0], "metrics.jsonl")) as f:
        n_jax = len(f.read().splitlines())
    assert out["runs"][1]["lines_equal_to_the_first_run"] == 0
    assert out["runs"][2]["lines_equal_to_the_first_run"] == n_jax


def test_compare_evidence_defaults_to_every_runs_end():
    """Without --at: the fixed steps and each run's last, here JAX's 64^2
    run's 10,000 and its 128^2 run's 12,000; the 128^2 run's 10-log mean at
    12,000 is the mean of its last ten logs."""
    from aglayout_tpu_torch.tools import compare_evidence

    dirs = [os.path.join(REPO, "artifacts", d) for d in ("train_evidence", "train_evidence_128")]
    out = compare_evidence.main(dirs)
    assert out["at"] == [200, 1000, 3000, 8000, 10000, 12000]
    rows = [json.loads(line) for line in open(os.path.join(dirs[1], "metrics.jsonl"))]
    assert out["runs"][1]["mean_of_10_logs_at"]["12000"] == float(np.mean(
        [r["G/rec_img"] for r in rows[-10:]]))
    assert out["runs"][0]["mean_of_10_logs_at"]["12000"] is None
