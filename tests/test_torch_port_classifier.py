"""The crop-realism and held-out attribute classifiers of the port
(`aglayout_tpu_torch/eval/{resnet,classifier,train_att_cls}.py`) against
JAX's, on the CPU in f32, from the same weights (carried from JAX's trees
by `utils/jax_import.resnet_state_dict_from_jax` and
`attribute_discriminator_state_dict_from_jax`):

  * ResNet-50 at full depth in eval mode on 2 crops at 32^2 (1e-5 of the
    logits' max; measured 1.8e-6), and one train-mode step at stages
    (1, 2, 1, 1) on 6 crops: logits (5e-5; 1.1e-5), running means and the
    *biased* running variances (1e-5 of their tensor's max; 3.2e-6),
    gradients (2e-4 relative L2 a tensor; 5.5e-5) and params after Adam
    (1e-6 where Adam's first step is sure of its sign, `compare.adam_sure`,
    6.0e-8; 2 lr elsewhere);
  * `train_crop_classifier` for 2 steps from JAX's `init(PRNGKey(0))` at
    those stages (JAX's `ResNet50` monkeypatched in the test; no JAX file
    changes), on a synthetic loader: the logged losses equal to their 4
    printed decimals; BN statistics within 3e-5 of their tensor's max
    (8.6e-6); params off by more than 1e-6 in at most 1e-3 of their
    elements (2.1e-4) and by at most 4 lr (two Adam steps of about lr,
    whose signs may differ where a gradient is rounding noise; 1.7e-4);
  * `test_crop_classifier` on generation pickles: the accuracies equal;
  * `train_attribute_classifier` for 2 steps from JAX's init (its u and v
    iterated in init, and again in every step): the last loss 1e-5
    relative (1.6e-6), the params and u, v as the crop classifier's
    (1.4e-5 of the params off by more than 1e-6, at most 5.5e-5; u and v
    7.9e-6);
  * both CLIs (train, then test; the attribute classifier's train) on the
    tiny Visual Genome corpus of `torch_port_common.write_vg_corpus`.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

from aglayout_tpu_torch.eval import classifier, train_att_cls
from aglayout_tpu_torch.eval.resnet import ResNet50
from aglayout_tpu_torch.train.compare import adam_sure
from aglayout_tpu_torch.utils.jax_import import (
    attribute_discriminator_state_dict_from_jax,
    resnet_state_dict_from_jax,
)
from tests.torch_port_common import vg_etl, write_vg_corpus

torch.set_num_threads(1)
SHALLOW = (1, 2, 1, 1)
LR = 1e-4


def _jax_resnet_trees(num_classes, stage_sizes, size, seed):
    """(params, batch_stats) of JAX's ResNet50: shapes from an abstract
    init, values from numpy (He-normal convs, BN affines near the identity,
    running statistics near (0, 1)): every block's branch counts, where a
    fresh model's zero-scaled last BN would silence it."""
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.eval.resnet import ResNet50 as JaxResNet50

    model = JaxResNet50(num_classes=num_classes, stage_sizes=stage_sizes)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((2, size, size, 3)), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    trees = [jax.tree_util.tree_map_with_path(fill, shapes[c]) for c in ("params", "batch_stats")]
    return model, *trees


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_resnet50_full_depth_eval_matches_jax():
    import jax.numpy as jnp

    model, params, stats = _jax_resnet_trees(7, (3, 4, 6, 3), 32, seed=0)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  train=False))
    net = ResNet50(7)
    net.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert _rel(got, want) <= 1e-5, _rel(got, want)
    assert np.abs(want[0] - want[1]).max() > 1e-2 * np.abs(want).max()  # the input matters


def test_resnet50_train_step_matches_jax():
    """Train-mode logits, the running statistics after it (flax's biased
    running variance), every gradient, and the params after one Adam step."""
    import jax
    import jax.numpy as jnp
    import optax

    model, params, stats = _jax_resnet_trees(5, SHALLOW, 32, seed=2)
    rng = np.random.RandomState(3)
    x = rng.randn(6, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 5, 6)

    def loss_fn(p):
        logits, mut = model.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()
        return ce, (logits, mut["batch_stats"])

    (_, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = optax.adam(LR)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jparams = optax.apply_updates(params, updates)

    net = ResNet50(5, SHALLOW)
    net.load_state_dict(resnet_state_dict_from_jax(params, stats, SHALLOW))
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    logits = net.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    opt.step()

    assert _rel(logits.detach(), jlogits) <= 5e-5
    want_sd = resnet_state_dict_from_jax(jparams, jstats, SHALLOW)
    want_g = resnet_state_dict_from_jax(jgrads, jstats, SHALLOW)
    for key, v in net.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert _rel(v, want_sd[key]) <= 1e-5, key
    for key, g in grads.items():
        w = want_g[key]
        assert ((g - w).norm() / w.norm()).item() <= 2e-4, key
        p, q = net.state_dict()[key], want_sd[key]
        sure = adam_sure(w, g, LR)
        assert not sure.any() or (p - q)[sure].abs().max() <= 1e-6, key
        assert (p - q).abs().max() <= 2 * LR + 1e-6, key


def test_flax_batchnorm_keeps_the_biased_running_variance():
    """One training forward moves running_var by 0.1 of the batch's biased
    variance (flax), where torch's BatchNorm2d takes the unbiased one."""
    from aglayout_tpu_torch.eval.resnet import FlaxBatchNorm2d

    x = torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    bn = FlaxBatchNorm2d(3).train()
    bn(x)
    var = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    ref = torch.nn.BatchNorm2d(3).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var)


# ---- the training and scoring functions against JAX's


def _batches(b, o, size, num_classes, attribute_dim, seed):
    from aglayout_tpu_torch.data.synthetic import synthetic_batch

    rng = np.random.RandomState(seed)
    while True:
        yield synthetic_batch(rng, b, o, size, num_classes, attribute_dim)


def _losses(text, tag):
    return [float(v) for v in re.findall(rf"{tag} iter \d+/\d+ loss ([-0-9.e]+)", text)]


def _check_params_after_two_steps(got: dict, want: dict, lr: float):
    """BN statistics and SN vectors within 3e-5 of their tensor's max |.|
    (at least 1); params off by more than 1e-6 in at most 1e-3 of their
    elements, and by at most 4 lr (two Adam steps of about lr each, whose
    signs may differ where a gradient is rounding noise)."""
    off = total = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        diff = (got[key] - w).abs()
        if key.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
            assert diff.max() <= 3e-5 * max(1.0, w.abs().max().item()), key
            continue
        assert diff.max() <= 4 * lr + 1e-6, key
        off += (diff > 1e-6).sum().item()
        total += diff.numel()
    assert off <= 1e-3 * total, (off, total)


@pytest.fixture()
def shallow_jax_resnet(monkeypatch):
    from aglayout_tpu.eval import classifier as jax_classifier
    from aglayout_tpu.eval.resnet import ResNet50 as JaxResNet50

    monkeypatch.setattr(jax_classifier, "ResNet50", functools.partial(JaxResNet50,
                                                                      stage_sizes=SHALLOW))
    monkeypatch.setattr(classifier, "ResNet50", functools.partial(ResNet50, stage_sizes=SHALLOW))
    return jax_classifier


def test_train_crop_classifier_matches_jax(shallow_jax_resnet, capsys):
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.config import Config as JaxConfig
    from aglayout_tpu_torch.config import config_for

    cs, ncls = 32, 6
    jcfg = JaxConfig(num_classes=ncls)
    _, jparams, jstats = shallow_jax_resnet.train_crop_classifier(
        jcfg, _batches(2, 3, 64, ncls, 106, seed=0), niter=2, crop_size=cs, log_step=1)
    jlosses = _losses(capsys.readouterr().out, "cls")

    init = jax.jit(shallow_jax_resnet.ResNet50(num_classes=ncls).init,
                   static_argnames=("train",))(jax.random.PRNGKey(0), jnp.zeros((2, cs, cs, 3)),
                                               train=True)
    model = classifier.train_crop_classifier(
        config_for(64, num_classes=ncls), _batches(2, 3, 64, ncls, 106, seed=0), niter=2,
        crop_size=cs, log_step=1, device="cpu",
        init=resnet_state_dict_from_jax(init["params"], init["batch_stats"], SHALLOW))
    losses = _losses(capsys.readouterr().out, "cls")
    assert len(losses) == 2 and losses == jlosses, (losses, jlosses)
    _check_params_after_two_steps(model.state_dict(),
                                  resnet_state_dict_from_jax(jparams, jstats, SHALLOW), 1e-4)


@pytest.fixture(scope="module")
def pickle_dir(tmp_path_factory):
    """Generation pickles in `eval/gen_pickle.py`'s format: 2 batches of 2
    images (16^2) of 3 objects of 4 classes, one slot padding."""
    d = tmp_path_factory.mktemp("pickles")
    rng = np.random.RandomState(1)
    b, o, h = 2, 3, 16
    for bi in range(2):
        xy0 = rng.uniform(0, 0.5, (b, o, 2)).astype(np.float32)
        boxes = np.concatenate([xy0, np.minimum(xy0 + rng.uniform(0.2, 0.4, (b, o, 2)), 1.0)],
                               -1).astype(np.float32)
        valid = np.ones((b, o), np.float32)
        valid[1, 2] = 0.0
        rec = {k: rng.randn(b, h, h, 3).astype(np.float32) for k in ("imgs", "imgs_rand",
                                                                     "imgs_shift")}
        rec.update(objs=rng.randint(0, 4, (b, o)).astype(np.int32), boxes=boxes,
                   boxes_shift=np.clip(boxes + 0.05, 0, 1).astype(np.float32), valid=valid,
                   attribute=(rng.rand(b, o, 106) < 0.05).astype(np.float32))
        with open(d / f"batch_{bi:05d}.pkl", "wb") as f:
            pickle.dump(rec, f)
    return str(d)


def test_test_crop_classifier_matches_jax(pickle_dir):
    from aglayout_tpu.eval import classifier as jax_classifier

    model, params, stats = _jax_resnet_trees(4, SHALLOW, 32, seed=4)
    want = jax_classifier.test_crop_classifier(model, params, stats, pickle_dir, crop_size=32)
    net = ResNet50(4, SHALLOW)
    net.load_state_dict(resnet_state_dict_from_jax(params, stats, SHALLOW))
    got = classifier.test_crop_classifier(net, pickle_dir, crop_size=32, device="cpu")
    assert got == want, (got, want)
    assert all(0.0 < v < 1.0 for v in want.values()), want  # each count moves the result


def test_train_attribute_classifier_matches_jax(capsys, tmp_path):
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.config import Config as JaxConfig
    from aglayout_tpu.eval.train_att_cls import train_attribute_classifier as jax_train
    from aglayout_tpu.models.discriminator import AttributeDiscriminator as JaxAttD
    from aglayout_tpu_torch.config import config_for

    jparams, jstats, jloss = jax_train(JaxConfig(num_classes=10), _batches(2, 3, 64, 10, 106, 0),
                                       niter=2, log_step=1)
    jlosses = _losses(capsys.readouterr().out, "att_cls")
    init = jax.jit(JaxAttD(n_attribute=106).init)(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))
    model, loss = train_att_cls.train_attribute_classifier(
        config_for(64, num_classes=10), _batches(2, 3, 64, 10, 106, 0), niter=2, log_step=1,
        out_dir=str(tmp_path), device="cpu",
        init=attribute_discriminator_state_dict_from_jax(init["params"], init["batch_stats"]))
    losses = _losses(capsys.readouterr().out, "att_cls")
    assert len(losses) == 2 and abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert losses == jlosses, (losses, jlosses)
    _check_params_after_two_steps(model.state_dict(),
                                  attribute_discriminator_state_dict_from_jax(jparams, jstats),
                                  2e-4)
    saved = torch.load(tmp_path / "step_2.pt", weights_only=True)
    assert saved["step"] == 2 and saved["nets"]["d_att"].keys() == model.state_dict().keys()


# ---- the command lines


@pytest.fixture(scope="module")
def vg_dir(tmp_path_factory):
    """The port's ETL over the miniature corpus: vocab.json and {train,test}.h5."""
    from aglayout_tpu_torch.data import preprocess_vg

    root = tmp_path_factory.mktemp("vg_cli")
    write_vg_corpus(root)
    out = vg_etl(preprocess_vg, root, "port")
    shutil.copytree(root / "images", os.path.join(out, "images"))  # where the loader looks
    return out


def test_classifier_cli_train_then_test(capsys, tmp_path, vg_dir, pickle_dir):
    weights = tmp_path / "cls.pt"
    classifier.main(["train", "--vg_dir", vg_dir, "--out", str(weights), "--image_size", "64",
                     "--batch_size", "2", "--niter", "2", "--crop_size", "32", "--device", "cpu"])
    assert weights.exists()
    with open(f"{vg_dir}/vocab.json") as f:
        n_cls = len(json.load(f)["object_idx_to_name"])
    capsys.readouterr()
    classifier.main(["test", pickle_dir, "--weights", str(weights), "--crop_size", "32",
                     "--num_classes", str(n_cls), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"real", "rand", "shift"} and all(0.0 <= v <= 1.0 for v in out.values())


def test_train_att_cls_cli(tmp_path, vg_dir):
    model, loss = train_att_cls.main(["--vg_dir", vg_dir, "--batch_size", "2", "--niter", "2",
                                      "--out_dir", str(tmp_path / "att_cls"), "--device", "cpu"])
    assert np.isfinite(loss) and (tmp_path / "att_cls" / "step_2.pt").exists()
