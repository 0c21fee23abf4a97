"""The port's Visual Genome pipeline against JAX's, on a tiny corpus built
as tests/test_data_pipeline.py builds it: the ETL's h5 datasets, vocab,
splits and co-occurrence matrix are equal; `VgDataset` samples and `Loader`
batches are equal for one seed over two epochs, on the native and the NumPy
batch paths, with `fast_decode` on and off; and the native bindings over the
shared native/libdatapath.so equal JAX's (twin of tests/test_native.py)."""

import json
import os

import numpy as np
import pytest

from aglayout_tpu.data import dataset as jax_dataset
from aglayout_tpu.data import native as jax_native
from aglayout_tpu.data import preprocess_vg as jax_preprocess
from aglayout_tpu.data.cooccurrence import build_matrix as jax_build_matrix
from aglayout_tpu.data.split_vg import make_splits as jax_make_splits
from aglayout_tpu_torch.data import dataset, native, preprocess_vg
from aglayout_tpu_torch.data.cooccurrence import build_matrix
from aglayout_tpu_torch.data.split_vg import make_splits
from tests.torch_port_common import vg_etl, write_vg_corpus

H5_KEYS = ["image_ids", "object_ids", "object_names", "object_boxes", "objects_per_image",
           "relationship_ids", "relationship_subjects", "relationship_predicates",
           "relationship_objects", "relationships_per_image", "attributes_per_object",
           "object_attributes", "image_paths"]


@pytest.fixture(scope="module")
def vg_dirs(tmp_path_factory):
    """A miniature Visual Genome corpus (JSON and JPEGs) and the two
    packages' ETL outputs over it: (corpus dir, JAX's out dir, the port's)."""
    root = tmp_path_factory.mktemp("vg")
    write_vg_corpus(root)
    return str(root), *(vg_etl(pkg, root, tag) for pkg, tag in ((jax_preprocess, "jax"),
                                                                 (preprocess_vg, "port")))


def _vocab(d):
    with open(os.path.join(d, "vocab.json")) as f:
        return json.load(f)


def test_splits_equal_jax():
    ids = list(range(5, 212, 3))
    for seed, frac in ((0, 0.8), (3, 0.67)):
        assert make_splits(ids, seed, frac) == jax_make_splits(ids, seed, frac)


def test_etl_equals_jax(vg_dirs):
    import h5py

    _, jax_dir, port_dir = vg_dirs
    assert _vocab(port_dir) == _vocab(jax_dir)
    vocab = _vocab(port_dir)
    assert vocab["object_idx_to_name"][0] == "__image__" and len(vocab["attribute_idx_to_name"]) == 5
    for split in ("train", "test", "val"):
        with h5py.File(os.path.join(port_dir, f"{split}.h5")) as a, \
                h5py.File(os.path.join(jax_dir, f"{split}.h5")) as b:
            assert sorted(a.keys()) == sorted(b.keys()) == sorted(H5_KEYS)
            for k in H5_KEYS:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)
    n_cls = len(vocab["object_idx_to_name"])
    got = build_matrix(os.path.join(port_dir, "train.h5"), n_cls, 5)
    want = jax_build_matrix(os.path.join(jax_dir, "train.h5"), n_cls, 5)
    assert got.dtype == want.dtype == np.float32 and got.sum() > 0
    np.testing.assert_array_equal(got, want)


def _datasets(vg_dirs, size=64, split="train"):
    root, _, port_dir = vg_dirs
    kw = dict(image_size=size, max_objects=4, attribute_dim=5)
    args = (os.path.join(port_dir, f"{split}.h5"), os.path.join(root, "images"), _vocab(port_dir))
    return dataset.VgDataset(*args, **kw), jax_dataset.VgDataset(*args, **kw)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("size", [64, 128])
def test_samples_equal_jax(vg_dirs, size):
    ds, jds = _datasets(vg_dirs, size)
    assert len(ds) == len(jds) > 0 and ds.max_objects == 3 and ds.o_max == 4
    for i in range(len(ds)):
        got = ds.sample(i, np.random.RandomState(i))
        _assert_batches_equal(got, jds.sample(i, np.random.RandomState(i)))
        _assert_batches_equal(ds.sample_meta(i, np.random.RandomState(i)),
                              jds.sample_meta(i, np.random.RandomState(i)))
        assert got["valid"].sum() == min(3, ds.data["objects_per_image"][i])


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("fast_decode", [True, False])
def test_loader_batches_equal_jax_over_two_epochs(vg_dirs, monkeypatch, path, fast_decode):
    if path == "native" and native.load_lib() is None:
        pytest.skip(f"the native library does not load here: {native.load_error()}")
    if path == "numpy":
        monkeypatch.setattr(native, "load_lib", lambda: None)
        monkeypatch.setattr(jax_native, "load_lib", lambda: None)
    ds, jds = _datasets(vg_dirs)
    kw = dict(batch_size=2, shuffle=True, seed=3, num_threads=2, fast_decode=fast_decode)
    loader, jloader = dataset.Loader(ds, **kw), jax_dataset.Loader(jds, **kw)
    assert loader.batch_path == path and len(loader) == len(jloader) == len(ds) // 2
    got, want = iter(loader), iter(jloader)
    batches = [next(got) for _ in range(2 * len(loader))]
    for b in batches:
        _assert_batches_equal(b, next(want))
    # the epochs are shuffled apart, and the seed decides them
    n = len(loader)
    assert any(not np.array_equal(a["objs"], b["objs"]) for a, b in zip(batches[:n], batches[n:]))
    again = iter(dataset.Loader(ds, **kw))
    _assert_batches_equal(next(again), batches[0])


def test_native_and_numpy_paths_agree(vg_dirs, monkeypatch):
    """The native batch (full-resolution decode) against the NumPy one:
    the same boxes, masks and attributes, images within PIL's resample
    rounding."""
    if native.load_lib() is None:
        pytest.skip(f"the native library does not load here: {native.load_error()}")
    ds, _ = _datasets(vg_dirs)
    kw = dict(batch_size=2, shuffle=True, seed=1, num_threads=2, fast_decode=False)
    nat = next(iter(dataset.Loader(ds, **kw)))
    monkeypatch.setattr(native, "load_lib", lambda: None)
    ref = next(iter(dataset.Loader(ds, **kw)))
    for k in ref:
        if k == "imgs":
            std = np.asarray([0.229, 0.224, 0.225], np.float32)
            assert (np.abs(nat[k] - ref[k]) * std * 255).max() < 2.5
        else:
            np.testing.assert_allclose(nat[k], ref[k], atol=1e-6, err_msg=k)


def test_get_dataloaders_equals_jax(vg_dirs):
    from aglayout_tpu.config import Config as JaxConfig
    from aglayout_tpu_torch.config import Config

    root, _, port_dir = vg_dirs
    kw = dict(vg_dir=port_dir, image_dir=os.path.join(root, "images"), batch_size=2,
              max_objects=4, attribute_dim=5, seed=2)
    train, val, vocab = dataset.get_dataloaders(Config(**kw))
    jtrain, jval, jvocab = jax_dataset.get_dataloaders(JaxConfig(**kw))
    assert vocab == jvocab
    assert (train.shuffle, val.shuffle, val.num_threads, train.fast_decode) == (
        jtrain.shuffle, jval.shuffle, jval.num_threads, jtrain.fast_decode) == (True, False, 1, True)
    _assert_batches_equal(next(iter(train)), next(iter(jtrain)))
    _assert_batches_equal(next(iter(val)), next(iter(jval)))


def test_loader_raises_what_a_worker_raised(vg_dirs, monkeypatch):
    ds, _ = _datasets(vg_dirs)
    monkeypatch.setattr(native, "load_lib", lambda: None)
    ds.image_dir = "/nonexistent"
    with pytest.raises(FileNotFoundError):
        next(iter(dataset.Loader(ds, batch_size=2, num_threads=2)))


def test_missing_library_reports_why(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libdatapath.so"))
    native._load.cache_clear()
    try:
        assert native.load_lib() is None and "is absent" in native.load_error()
    finally:
        monkeypatch.undo()
        native._load.cache_clear()


# ---- the bindings (twin of tests/test_native.py), against JAX's over the same library


def _native_or_skip():
    if native.load_lib() is None or jax_native.load_lib() is None:
        pytest.skip(f"the native library does not load here: {native.load_error()}")


def _objects(n, rng, att_dim=106, max_atts=30):
    img_w, img_h = rng.uniform(300, 800, n), rng.uniform(300, 800, n)
    boxes_px = np.stack([rng.uniform(0, 200, n), rng.uniform(0, 200, n),
                         rng.uniform(30, 300, n), rng.uniform(30, 300, n)], 1)
    att_ids = np.full((n, max_atts), -1, np.int32)
    for i in range(n):
        k = rng.randint(0, 4)
        att_ids[i, :k] = rng.choice(att_dim, k, replace=False)
    valid = (rng.rand(n) > 0.2).astype(np.float32)
    return boxes_px, img_w, img_h, att_ids, valid


@pytest.mark.parametrize("threads", [1, 8])
def test_assemble_objects_equals_jax(threads):
    _native_or_skip()
    args = _objects(37, np.random.RandomState(threads))
    got = native.assemble_objects(*args, 106, 64, num_threads=threads)
    want = jax_native.assemble_objects(*args, 106, 64, num_threads=threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    boxes, _, masks, _, attribute = got
    valid = args[4] > 0
    assert (boxes[~valid] == [0, 0, 1, 1]).all() and masks[~valid].sum() == 0
    assert (masks[valid].sum((1, 2)) > 0).all()
    assert attribute[~valid].sum() == 0


def test_normalize_images_equals_jax():
    _native_or_skip()
    imgs = np.random.RandomState(1).randint(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got = native.normalize_images(imgs)
    np.testing.assert_array_equal(got, jax_native.normalize_images(imgs))
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    np.testing.assert_allclose(got, (imgs.astype(np.float32) / 255.0 - mean) / std, atol=1e-5)


@pytest.mark.parametrize("fast_scale", [False, True])
def test_decode_batch_equals_jax(tmp_path, fast_scale):
    _native_or_skip()
    from PIL import Image

    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate([(500, 375), (64, 64), (333, 217)]):
        img = np.zeros((h, w, 3), np.uint8)
        img[:] = rng.randint(0, 255, 3)
        for _ in range(5):
            x0, y0 = rng.randint(0, w - 20), rng.randint(0, h - 20)
            img[y0:y0 + 20, x0:x0 + 20] = rng.randint(0, 255, 3)
        paths.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(img).save(paths[-1], quality=92)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    paths.append(str(bad))
    out, dims, n_failed = native.decode_batch(paths, 64, fast_scale=fast_scale)
    jout, jdims, jn_failed = jax_native.decode_batch(paths, 64, fast_scale=fast_scale)
    assert n_failed == jn_failed == 1 and dims[-1, 0] == 0
    np.testing.assert_array_equal(dims, jdims)
    np.testing.assert_array_equal(out, jout)
    assert (dims[:3] == [[500, 375], [64, 64], [333, 217]]).all()


def test_bench_loader_runs():
    """`python -m aglayout_tpu_torch.data.bench_loader` at a tiny size: both
    paths where the library loads, positive rates, the corpus removed."""
    from aglayout_tpu_torch.data import bench_loader

    result = bench_loader.main(["--n_images", "60", "--batches", "2", "--image_size", "64",
                                "--workers", "2"])
    paths = ["native", "numpy"] if native.load_lib() is not None else ["numpy"]
    assert all(result[f"{p}_batches_per_sec"] > 0 for p in paths)
    assert result["train_images"] > 0 and result["synthetic_ms_per_batch"] > 0
    assert not os.path.exists(os.path.join(bench_loader.BUILD, "bench_loader_corpus"))


def test_train_from_the_corpus(vg_dirs, tmp_path, capsys):
    """`train/loop.train` with no loader reads the corpus through
    `get_dataloaders`, sets num_classes from the vocab, reports its batch
    path and takes its steps."""
    import torch

    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.train.loop import train

    root, _, port_dir = vg_dirs
    vocab = _vocab(port_dir)
    n_cls = len(vocab["object_idx_to_name"])
    np.save(os.path.join(port_dir, "matrix_obj_vs_att.npy"),
            build_matrix(os.path.join(port_dir, "train.h5"), n_cls, 5))
    fields = dict(TRAIN_SMALL, num_classes=99, attribute_dim=5, batch_size=2, max_objects=4,
                  vg_dir=port_dir, image_dir=os.path.join(root, "images"), path=str(tmp_path),
                  log_step=1)
    cfg = config_for(64, **fields)
    state, metrics = train(cfg, niter=2, use_tensorboard=False, device="cpu")
    out = capsys.readouterr().out
    assert cfg.num_classes == n_cls and state.step == 2
    path = "native" if native.load_lib() is not None else "numpy"
    assert f"{path} batch path" in out
    assert all(torch.isfinite(v) for k, v in metrics.items() if k != "images")


def test_download_vg_script_equals_jax():
    """`data/download_vg.sh` is JAX's script, line for line (its `set`,
    `mkdir`, URLs, file list and unzip steps) but the last, which names the
    port's ETL modules; bash parses it (`-n`: nothing runs, nothing is
    fetched)."""
    import importlib.util
    import re
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, pkg, "data", "download_vg.sh")
             for pkg in ("aglayout_tpu", "aglayout_tpu_torch")]
    jax_lines, port_lines = ([line.rstrip("\n") for line in open(p)] for p in paths)
    assert port_lines[:-1] == jax_lines[:-1]
    for pattern in (r"^set -euo pipefail$", r'^VG_DIR="\$\{1:-data/vg\}"$', r"^mkdir -p ",
                    r'^BASE="https://', r'^VISUALGENOME="https://', r"^for f in objects\.json",
                    r"^\s+wget -c "):
        assert any(re.match(pattern, line) for line in port_lines), pattern
    modules = re.findall(r"python -m ([\w.]+)", port_lines[-1])
    assert modules == ["aglayout_tpu_torch.data.split_vg", "aglayout_tpu_torch.data.preprocess_vg"]
    assert port_lines[-1] == jax_lines[-1].replace("aglayout_tpu.", "aglayout_tpu_torch.")
    assert all(importlib.util.find_spec(m) is not None for m in modules)
    assert os.access(paths[1], os.X_OK)
    subprocess.run(["bash", "-n", paths[1]], check=True)
