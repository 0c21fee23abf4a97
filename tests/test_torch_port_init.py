"""Fresh states against JAX's: the train state (`train/state.py`) and the
crop classifier's ResNet-50 (`eval/resnet.flax_init`).

A fresh port train state at `bench.TRAIN_SMALL` widths, 64^2, against
JAX's `create_train_state(cfg, Models(cfg), PRNGKey(0))`, mapped to the
port's keys by the weight bridge (`utils/jax_import.py`):

  * every batch norm of the generator equals JAX's: running mean 0,
    running variance 1, weight 1 and bias 0 where affine, and no batch
    tracked;
  * every other tensor of the four nets is drawn from JAX's distribution:
    conv, linear and spectral-norm weights and biases uniform within
    1 / sqrt(fan_in) in both packages; each tensor's mean and std within 5
    standard errors of JAX's tensor (the errors estimated from the two
    tensors' own moments) where it has at least `MIN_SAMPLE` values, else
    only the bound; the class-conditional BN tables' scale half likewise
    and their bias half exactly 0; spectral-norm u and v of unit norm.

`build_generator`, which serving, the bench and the kernel checks build
from, keeps its drawn BN state.

A fresh ResNet-50 at stages (1, 1, 1, 1) against JAX's `ResNet50.init`
(flax's initialisers): each conv and fc weight's std within 5 standard
errors of JAX's and of sqrt(1 / fan_in), every value inside the +-2 sigma
cut of flax's truncated normal in both, the fc bias 0 and each block's
`bn3` scale 0, the other BN scales 1 and biases 0.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn as nn

from aglayout_tpu_torch.eval.resnet import TRUNCATED_STD, Bottleneck, ResNet50, flax_init
from aglayout_tpu_torch.models import build_generator
from aglayout_tpu_torch.models.norms import ConditionalBatchNorm, MaskedBatchNorm
from aglayout_tpu_torch.models.sn import SNConv2d, SNLinear
from aglayout_tpu_torch.train.state import NETS, create_train_state
from aglayout_tpu_torch.utils import jax_import
from tests.torch_port_common import train_configs

torch.set_num_threads(1)
MIN_SAMPLE = 16  # below this many values a tensor is held to its bound only


@pytest.fixture(scope="module")
def states():
    """(the port's Config, its fresh train state on the CPU, JAX's fresh
    state as port `state_dict`s a net)."""
    import jax

    from aglayout_tpu.train.state import Models, create_train_state as jax_create_train_state

    cfg, jcfg = train_configs(64)
    js = jax_create_train_state(jcfg, Models(jcfg), jax.random.PRNGKey(0))
    to_sd = {
        "g": lambda p, s: jax_import.generator_state_dict_from_jax(
            p, s, cfg.image_size, cfg.clstm_layers, cfg.resi_num),
        "d_image": jax_import.image_discriminator_state_dict_from_jax,
        "d_object": jax_import.object_discriminator_state_dict_from_jax,
        "d_att": jax_import.attribute_discriminator_state_dict_from_jax,
    }
    jsd = {name: to_sd[name](getattr(js, name).params, getattr(js, name).stats) for name in NETS}
    return cfg, create_train_state(cfg, "cpu", seed=0), jsd


def _bns(module):
    return [(name, m) for name, m in module.named_modules() if isinstance(m, MaskedBatchNorm)]


def _stats(x):
    """(mean, std, the mean's and the std's standard errors) of a tensor's
    values, in f64: the std's from the sample's fourth moment."""
    x = np.asarray(x, np.float64).ravel()
    n, mean, var = x.size, x.mean(), x.var()
    m4 = ((x - mean) ** 4).mean()
    se_std = math.sqrt(max(m4 - var * var, 0.0) / n) / (2 * math.sqrt(var)) if var > 0 else 0.0
    return mean, math.sqrt(var), math.sqrt(var / n), se_std


def _same_distribution(got, want, what):
    """`got`'s mean and std within 5 standard errors of `want`'s."""
    (m1, s1, se_m1, se_s1), (m2, s2, se_m2, se_s2) = _stats(got), _stats(want)
    assert abs(m1 - m2) <= 5 * math.hypot(se_m1, se_m2), (what, "mean", m1, m2)
    assert abs(s1 - s2) <= 5 * math.hypot(se_s1, se_s2), (what, "std", s1, s2)


def _drawn(module):
    """(state_dict key, kind, bound) of every drawn tensor of `module`:
    "uniform" within `bound`, "normal" (an embedding), "cbn" (a
    class-conditional BN table), "unit" (a spectral-norm u or v)."""
    out = []
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = (m.weight.shape[1] * m.weight[0, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel())
            out += [(pre + k, "uniform", fan_in ** -0.5) for k in ("weight", "bias")
                    if getattr(m, k) is not None]
        elif isinstance(m, (SNConv2d, SNLinear)):
            bound = m.weight_v.numel() ** -0.5
            out += [(pre + k, "uniform", bound) for k in ("weight_orig", "bias")
                    if getattr(m, k) is not None]
            out += [(pre + k, "unit", None) for k in ("weight_u", "weight_v")]
        elif isinstance(m, ConditionalBatchNorm):
            out.append((pre + "embed.weight", "cbn", None))
        elif isinstance(m, nn.Embedding) and not name.endswith(".embed"):
            out.append((pre + "weight", "normal", None))
    return out


def test_fresh_generator_bn_state_equals_jax(states):
    """Every generator BN (the affine ones and the affine-free ones inside
    the class-conditional BNs and SPADE) is JAX's fresh state, exactly."""
    _, state, jsd = states
    bns = _bns(state.models.g)
    assert any(m.affine for _, m in bns) and any(not m.affine for _, m in bns)
    sd = state.models.g.state_dict()
    for name, m in bns:
        keys = ["running_mean", "running_var"] + (["weight", "bias"] if m.affine else [])
        for k in keys:
            assert torch.equal(sd[f"{name}.{k}"], jsd["g"][f"{name}.{k}"]), f"{name}.{k}"
        assert torch.equal(m.running_mean, torch.zeros(m.features))
        assert torch.equal(m.running_var, torch.ones(m.features))
        if m.affine:
            assert torch.equal(m.weight.detach(), torch.ones(m.features))
            assert torch.equal(m.bias.detach(), torch.zeros(m.features))
        assert m.num_batches_tracked.item() == 0


@pytest.mark.parametrize("net", NETS)
def test_fresh_tensors_follow_jax_distributions(states, net):
    """Every key of the net is in JAX's state and every drawn tensor follows
    the distribution of JAX's tensor of the same key."""
    _, state, jsd = states
    module = getattr(state.models, net)
    sd, want = module.state_dict(), jsd[net]
    assert set(sd) == set(want)
    drawn = _drawn(module)
    bn_keys = {f"{n}.{k}" for n, _ in _bns(module) for k in
               ("running_mean", "running_var", "num_batches_tracked", "weight", "bias")}
    assert {k for k, _, _ in drawn} | bn_keys >= set(sd)  # no tensor unchecked
    for key, kind, bound in drawn:
        got, ref = sd[key].double(), want[key].double()
        assert got.shape == ref.shape, key
        if kind == "unit":
            for t in (got, ref):
                assert abs(t.norm().item() - 1.0) <= 1e-6, key
            continue
        if kind == "cbn":
            c = got.shape[1] // 2
            assert not got[:, c:].any() and not ref[:, c:].any(), key  # the bias half
            got, ref = got[:, :c], ref[:, :c]
        if kind == "uniform":  # the bound rounded to f32 may sit one ulp above
            bound *= 1 + 2**-23
            assert got.abs().max() <= bound and ref.abs().max() <= bound, key
        if got.numel() >= MIN_SAMPLE:
            _same_distribution(got, ref, key)


def test_build_generator_keeps_drawn_bn_state():
    """Serving, the bench and the kernel checks build from `build_generator`:
    its BNs keep the drawn running statistics and affines."""
    cfg, _ = train_configs(64)
    g = build_generator(cfg, "cpu", seed=0)
    for name, m in _bns(g):
        assert not torch.equal(m.running_mean, torch.zeros(m.features)), name
        assert not torch.equal(m.running_var, torch.ones(m.features)), name
        assert (m.running_var >= 0.5).all() and (m.running_var < 1.5).all(), name
        if m.affine:
            assert not torch.equal(m.weight.detach(), torch.ones(m.features)), name
            assert not torch.equal(m.bias.detach(), torch.zeros(m.features)), name


STAGES = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def resnets():
    """(the port's fresh ResNet-50 at `STAGES`, JAX's `init(PRNGKey(0))` at
    the same stages as a port `state_dict`)."""
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.eval.resnet import ResNet50 as JaxResNet50

    v = JaxResNet50(num_classes=10, stage_sizes=STAGES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32), train=False)
    jsd = jax_import.resnet_state_dict_from_jax(v["params"], v["batch_stats"], STAGES)
    return flax_init(ResNet50(10, STAGES), torch.Generator().manual_seed(0)), jsd


def test_fresh_resnet_weights_follow_flax(resnets):
    model, jsd = resnets
    sd = model.state_dict()
    assert set(sd) == set(jsd)
    weights = [n for n, m in model.named_modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    assert len(weights) == 1 + 4 * 4 + 1  # the stem, 3 convs and a projection a block, fc
    for name in weights:
        got, ref = sd[f"{name}.weight"].double(), jsd[f"{name}.weight"].double()
        fan_in = got[0].numel()
        cut = 2 * fan_in ** -0.5 / TRUNCATED_STD
        assert got.abs().max() <= cut and ref.abs().max() <= cut, name
        _same_distribution(got, ref, name)
        _, std, _, se_std = _stats(got)
        assert abs(std - fan_in ** -0.5) <= 5 * se_std, (name, std, fan_in ** -0.5)
    assert not sd["fc.bias"].any() and not jsd["fc.bias"].any()


def test_fresh_resnet_batch_norms_follow_flax(resnets):
    model, jsd = resnets
    sd = model.state_dict()
    last = {f"{n}.bn3" for n, m in model.named_modules() if isinstance(m, Bottleneck)}
    assert len(last) == 4
    for name, m in model.named_modules():
        if not isinstance(m, nn.BatchNorm2d):
            continue
        scale = 0.0 if name in last else 1.0
        for key, value in (("weight", scale), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            want = torch.full((m.num_features,), value)
            assert torch.equal(sd[f"{name}.{key}"], want), f"{name}.{key}"
            assert torch.equal(jsd[f"{name}.{key}"], want), f"{name}.{key}"


def test_make_crop_classifier_draws_as_flax():
    """The classifier's fresh ResNet-50, at full depth: each weight's std
    within 10 % of sqrt(1 / fan_in) and inside the cut, the fc bias and the
    `bn3` scales 0; given `init=`, that `state_dict` exactly."""
    from aglayout_tpu_torch.eval.classifier import make_crop_classifier

    model, _, _ = make_crop_classifier(5, device="cpu")
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight.detach()
            target = w[0].numel() ** -0.5
            assert abs(w.std().item() - target) <= 0.1 * target, name
            assert w.abs().max().item() <= 2 * target / TRUNCATED_STD * (1 + 2**-23), name
        if isinstance(m, Bottleneck):
            assert not m.bn3.weight.any(), name
    assert not model.fc.bias.any()
    sd = {k: torch.randn(v.shape) if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    again, _, _ = make_crop_classifier(5, device="cpu", init=sd)
    assert all(torch.equal(v, sd[k]) for k, v in again.state_dict().items())
