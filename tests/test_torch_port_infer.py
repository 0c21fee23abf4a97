"""The port's test-time path against the JAX package's, on the CPU, at small
widths (`torch_port_common.SMALL`), f32, JAX's Pallas flags off (its CPU
default):

  * the eval-mode `Generator.forward` at 64^2 and 128^2 against JAX's
    `__call__(train=False)`: each of the eleven outputs within 1e-5 of
    JAX's max |.|, with JAX's z and its reparametrisation draw;
  * `infer/generate.run_inference`, two batches at B=2, O=3 of the
    synthetic stream, with JAX's draws passed in: the summary equal to
    JAX's, each forward's attribute logits within 1e-5, one batch's PNGs
    within one level of 255;
  * `utils/draw.py` and `infer/demo_layout.layout_from_spec` on the same
    arrays as JAX's.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu_torch.data.synthetic import batch_to_torch, synthetic_batch
from aglayout_tpu_torch.infer import generate as port_generate
from tests.torch_port_common import (
    SMALL,
    close,
    eval_models_pair,
    generator_pair,
    jax_eval_draws,
    jax_eval_forward,
    train_configs,
    train_inputs,
)

torch.set_num_threads(1)
KEYS = ("crops_input", "crops_input_rec", "crops_rand", "crops_shift", "img_rec", "img_rand",
        "img_shift", "mu", "logvar", "z_rand_rec", "z_rand_shift")
GEN_ARGS = ("imgs", "objs", "boxes", "masks", "valid", "z", "attribute", "masks_shift",
            "boxes_shift", "attribute_est")


@pytest.mark.parametrize("size", [64, 128])
def test_eval_forward_matches_jax(size):
    jmodel, variables, tmodel = generator_pair(seed=size + 1, image_size=size)
    cfg, _ = train_configs(size)
    batch, _, _ = train_inputs(cfg, seed=size)
    rng = np.random.RandomState(size)
    batch["z"] = rng.randn(3, 3, SMALL["z_dim"]).astype(np.float32)
    est = batch["attribute"].copy()
    est[..., 1] = 1.0
    batch["attribute_est"] = est
    out, eps = jax_eval_forward(
        jmodel, variables, tuple(jnp.asarray(batch[k]) for k in GEN_ARGS), jax.random.PRNGKey(size))
    tb = batch_to_torch(batch, "cpu")
    with torch.inference_mode():
        got = tmodel.eval()(*(tb[k] for k in GEN_ARGS), torch.from_numpy(np.array(eps)))
    assert set(got) == set(out) == set(KEYS)
    for k in KEYS:
        close(got[k], out[k], 1e-5, k)
    # eval mode reads the running statistics and moves none of them
    assert int(tmodel.crop_encoder.bn1.bn.num_batches_tracked) == 0


# ---- run_inference in both packages

B, O, BATCHES = 2, 3, 2


def _inference_case(tmp_root):
    """Both packages' run_inference over the same two batches from the same
    weights, the port given JAX's draws; each records its forwards."""
    from aglayout_tpu.infer import generate as jax_generate

    # VG's 106 attributes: the 12 colour ids and the target (95) in range
    cfg, jcfg = train_configs(64, batch_size=B, max_objects=O, attribute_dim=106)
    models, jmodels, jstate = eval_models_pair(cfg, jcfg)
    rng = np.random.RandomState(0)
    batches = [synthetic_batch(rng, B, O, 64, cfg.num_classes, cfg.attribute_dim)
               for _ in range(BATCHES)]

    # JAX's draws, split as infer/generate.py:151 splits them
    draws = jax_eval_draws(jmodels, jstate, batches, jcfg.z_dim, 0, ("z", "eps", "z2", "eps2"))

    def recording(module, log):
        make = module.make_infer_fns

        def make_infer_fns(*a, **kw):
            forward, estimate = make(*a, **kw)

            def fwd(*args):
                res = forward(*args)
                log.append(res[1])
                return res

            return fwd, estimate

        return make_infer_fns

    jlog, tlog = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_generate, "make_infer_fns", recording(jax_generate, jlog))
        mp.setattr(port_generate, "make_infer_fns", recording(port_generate, tlog))
        want = jax_generate.run_inference(jcfg, jmodels, jstate, iter(batches),
                                          os.path.join(tmp_root, "jax"), seed=0)
        got = port_generate.run_inference(cfg, models, iter(batches),
                                          os.path.join(tmp_root, "port"), device="cpu",
                                          draws=draws)
    return want, got, jlog, tlog, tmp_root


@pytest.fixture(scope="module")
def inference_case(tmp_path_factory):
    return _inference_case(str(tmp_path_factory.mktemp("infer")))


def test_run_inference_summary_equals_jax(inference_case):
    want, got, _, _, _ = inference_case
    assert got.keys() == want.keys()
    # counts and fractions of whole objects: exact
    assert got == want, (got, want)
    assert want["num_objects"] > 0 and want["edit_candidates"] > 0


def test_run_inference_logits_match_jax(inference_case):
    _, _, jlog, tlog, _ = inference_case
    assert len(jlog) == len(tlog) == 2 * BATCHES  # the original and the edited forward
    for i, (got, want) in enumerate(zip(tlog, jlog)):
        close(got, np.asarray(want), 1e-5, f"forward {i}")


def test_run_inference_pngs_match_jax(inference_case):
    from PIL import Image

    root = inference_case[-1]
    jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "port")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    first = [n for n in names if n.startswith(("img000000_", "img000001_"))]  # batch 0
    assert {n.split("_", 1)[1] for n in first} >= {"rand.png", "shift.png", "rec.png", "real.png"}
    assert len(names) >= 4 * B * BATCHES
    for name in first:
        a = np.asarray(Image.open(os.path.join(tdir, name)), np.int32)
        b = np.asarray(Image.open(os.path.join(jdir, name)), np.int32)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name



# ---- host helpers on the same arrays as JAX's

def test_draw_boxes_equal_jax():
    from aglayout_tpu.utils import draw as jax_draw
    from aglayout_tpu_torch.utils import draw

    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 255, (2, 48, 48, 3)).astype(np.uint8)
    xy0 = rng.uniform(0, 0.5, (2, 4, 2)).astype(np.float32)
    boxes = np.concatenate([xy0, xy0 + rng.uniform(0.1, 0.5, (2, 4, 2)).astype(np.float32)], -1)
    boxes[0, 1, 2] = boxes[0, 1, 0]  # a degenerate box is skipped
    valid = np.array([[1, 1, 1, 0], [1, 0, 1, 1]], np.float32)
    objs = rng.randint(0, 3, (2, 4))
    vocab = {"object_idx_to_name": ["sky", "tree", "car"]}
    for args in ((boxes,), (boxes, valid), (boxes, valid, objs), (boxes, valid, objs, vocab)):
        got = draw.draw_boxes_batch(imgs, *args)
        assert got.dtype == np.uint8 and np.array_equal(got, jax_draw.draw_boxes_batch(imgs, *args))
    assert not np.array_equal(got, imgs)


def test_plot_grad_flow_equals_jax(tmp_path):
    from aglayout_tpu.utils import draw as jax_draw
    from aglayout_tpu_torch.utils import draw

    rng = np.random.RandomState(4)
    grads = {f"layer{i}": rng.randn(3, i + 2).astype(np.float32) for i in range(5)}
    want = jax_draw.plot_grad_flow(grads, str(tmp_path / "jax.png"))
    got = draw.plot_grad_flow({k: torch.from_numpy(v) for k, v in grads.items()},
                              str(tmp_path / "port.png"), max_bars=4)
    assert list(got.values()) == list(want.values())[:4]
    assert os.path.getsize(tmp_path / "port.png") > 0


def test_layout_from_spec_equals_jax():
    from aglayout_tpu.infer.demo_layout import layout_from_spec as jax_layout_from_spec
    from aglayout_tpu_torch.infer.demo_layout import layout_from_spec

    vocab = {"object_name_to_idx": {"sky": 0, "tree": 1, "car": 2},
             "attribute_name_to_idx": {"blue": 3, "red": 7}}
    spec = [{"name": "sky", "box": [0, 0, 1, 0.4], "attributes": ["blue"]},
            {"name": "car", "box": [0.3, 0.6, 0.7, 0.9], "attributes": ["red", "blue"]},
            {"name": "tree", "box": [0.1, 0.2, 0.3, 0.9]}]
    for o, a in ((5, 12), (2, 8)):  # more slots than objects, and fewer
        got, want = layout_from_spec(spec, vocab, o, a), jax_layout_from_spec(spec, vocab, o, a)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


# ---- the entry points on the host, at small widths

PORT_SMALL = dict(SMALL, num_classes=23, d_conv_dim=8, max_objects=3)


@pytest.fixture
def small_config(monkeypatch):
    """The entry points' `config_for` narrowed to the test widths (the CLIs
    have no width flags, as root test.py has none)."""
    from aglayout_tpu_torch import config

    full = config.config_for
    monkeypatch.setattr(config, "config_for", lambda size, **kw: full(size, **{**PORT_SMALL, **kw}))
    return config.config_for


def test_test_entry_synthetic_cpu(small_config, tmp_path, capsys):
    import json

    from aglayout_tpu_torch import test as entry
    from aglayout_tpu_torch.train.loop import prepare_dirs

    summary = entry.main(["--device", "cpu", "--synthetic", "--image_size", "128",
                          "--batch_size", "2", "--max_batches", "2", "--path", str(tmp_path),
                          "--draw_boxes"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 0" in out
    assert json.loads(out[out.index("{"):]) == summary
    assert summary["num_objects"] > 0 and all(np.isfinite(v) for v in summary.values())
    results = prepare_dirs(small_config(128, batch_size=2, path=str(tmp_path)))["results"]
    pngs = os.listdir(results)
    assert len([p for p in pngs if "modified" not in p]) == 4 * 2 * 2


def test_test_entry_loads_torch_state_dicts(small_config, tmp_path):
    """--torch_netG / --torch_netD_att load reference-keyed state_dicts
    strictly: the summary is run_inference's with those weights."""
    from aglayout_tpu_torch import test as entry
    from aglayout_tpu_torch.train.state import create_train_state

    cfg = small_config(64, batch_size=2, path=str(tmp_path))
    donor = create_train_state(cfg, "cpu", seed=9).models
    torch.save(donor.g.state_dict(), tmp_path / "netG.pkl")
    torch.save(donor.d_att.state_dict(), tmp_path / "netD_att.pkl")
    argv = ["--device", "cpu", "--synthetic", "--batch_size", "2", "--max_batches", "1",
            "--no_images", "--path", str(tmp_path), "--torch_netG", str(tmp_path / "netG.pkl"),
            "--torch_netD_att", str(tmp_path / "netD_att.pkl")]
    got = entry.main(argv)
    want = port_generate.run_inference(cfg, donor, entry.synthetic_loader(cfg),
                                       str(tmp_path / "want"), device="cpu", max_batches=1,
                                       save_images=False)
    assert got == want
    sd = donor.g.state_dict()
    sd.pop("decoder.c0_new.weight")
    torch.save(sd, tmp_path / "netG.pkl")
    with pytest.raises(RuntimeError, match="Missing key"):
        entry.main(argv)


def test_demo_layout_entry_cpu(small_config, tmp_path, capsys):
    import json

    from PIL import Image

    from aglayout_tpu_torch.infer import demo_layout

    names = ["sky", "tree", "car", "road"] + [f"thing{i}" for i in range(19)]
    vocab = {"object_idx_to_name": names,
             "object_name_to_idx": {n: i for i, n in enumerate(names)},
             "attribute_name_to_idx": {"blue": 0, "green": 1, "red": 2}}
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    demo_layout.main(["--device", "cpu", "--vocab", str(tmp_path / "vocab.json"), "--path",
                      str(tmp_path / "ckpt"), "--out", str(tmp_path / "demo"), "--samples", "2",
                      "--draw_boxes"])
    assert "wrote 2 samples" in capsys.readouterr().out
    for k in range(2):
        im = np.asarray(Image.open(tmp_path / "demo" / f"demo_{k}.png"))
        assert im.shape == (64, 64, 3) and im.dtype == np.uint8
