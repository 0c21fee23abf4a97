"""The port's spectral norm and discriminators against the JAX package's, on
the CPU, at small widths: each layer and each discriminator with the same
weights (drawn in the port, carried into JAX by its own importer,
`import_*_discriminator`), the same numpy inputs, `update_stats` off and
on; the weight bridge's round trip; and the shortcut's pre-activation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.discriminator import AttributeDiscriminator as JaxAttributeD
from aglayout_tpu.models.discriminator import ImageDiscriminator as JaxImageD
from aglayout_tpu.models.discriminator import ObjectDiscriminator as JaxObjectD
from aglayout_tpu.models.sn import SNConv2d as JaxSNConv2d
from aglayout_tpu.models.sn import SNDense as JaxSNDense
from aglayout_tpu.utils.torch_import import (
    import_attribute_discriminator,
    import_image_discriminator,
    import_object_discriminator,
)
from aglayout_tpu_torch.config import Config
from aglayout_tpu_torch.models import (
    AttributeDiscriminator,
    DResidualBlock,
    ImageDiscriminator,
    ObjectDiscriminator,
    SNConv2d,
    SNLinear,
    build_discriminators,
    init_weights,
)
from aglayout_tpu_torch.models.discriminator import avg_pool2
from aglayout_tpu_torch.utils import jax_import
from tests.torch_port_common import nchw, nhwc

D = 8  # d_conv_dim
N_CLASS, N_ATT = 23, 12


def _close(got, want, tol, what):
    """max |got - want| <= tol * max |want|, in f32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: max abs err {err:.3e}, max {np.abs(want).max():.3e}"


def _sd_numpy(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@torch.no_grad()
def _iterated(module):
    """module with every layer's u and v after one power iteration (in f64),
    the state any call with `update_stats` leaves and a checkpoint holds.
    Freshly drawn, u and v are random unit vectors and sigma = u^T W v is a
    sum of terms that cancel, which two f32 implementations round apart
    (to ~1e-4 of the output); after an iteration u is W v / |W v| and
    sigma = |W v|, a sum of positive terms."""
    for layer in module.modules():
        if isinstance(layer, (SNConv2d, SNLinear)):
            w = layer.weight_orig.double().view(layer.weight_orig.shape[0], -1)
            v = w.t() @ layer.weight_u.double()
            v /= v.norm()
            u = w @ v
            layer.weight_u.copy_(u / u.norm())
            layer.weight_v.copy_(v)
    return module


# ---- spectral norm, layer by layer


def _sn_conv_pair(cin, cout, k, stride, padding, seed, iterated):
    port = init_weights(SNConv2d(cin, cout, k, stride, padding), torch.Generator().manual_seed(seed))
    port = _iterated(port) if iterated else port
    sd = _sd_numpy(port)
    params = {"kernel": np.transpose(sd["weight_orig"], (2, 3, 1, 0)), "bias": sd["bias"]}
    stats = {"sn": {"u": sd["weight_u"], "v": sd["weight_v"]}}
    jax_layer = JaxSNConv2d(cout, k, stride=stride, padding=padding)
    return port, jax_layer, {"params": params, "batch_stats": stats}


def _sn_linear_pair(fin, fout, bias, seed, iterated):
    port = init_weights(SNLinear(fin, fout, bias=bias), torch.Generator().manual_seed(seed))
    port = _iterated(port) if iterated else port
    sd = _sd_numpy(port)
    params = {"kernel": sd["weight_orig"].T} | ({"bias": sd["bias"]} if bias else {})
    stats = {"sn": {"u": sd["weight_u"], "v": sd["weight_v"]}}
    return port, JaxSNDense(fout, use_bias=bias), {"params": params, "batch_stats": stats}


# cin, cout, k, stride, padding: the blocks' 3x3 convs and 1x1 shortcut, and a strided 4x4
@pytest.mark.parametrize("update_stats", [False, True])
@pytest.mark.parametrize("cin,cout,k,stride,padding", [(3, 8, 3, 1, 1), (8, 16, 1, 1, 0),
                                                       (6, 10, 4, 2, 1)])
def test_sn_conv_matches_jax(cin, cout, k, stride, padding, update_stats):
    port, jax_layer, variables = _sn_conv_pair(cin, cout, k, stride, padding, cin + k,
                                                 iterated=not update_stats)
    x = np.random.RandomState(k).randn(2, 12, 12, cin).astype(np.float32)
    want, new = jax_layer.apply(variables, jnp.asarray(x), update_stats, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(nchw(x), update_stats)
    _close(nhwc(got), want, 1e-5, "SNConv2d")
    sn = new["batch_stats"]["sn"] if update_stats else variables["batch_stats"]["sn"]
    _close(port.weight_u, sn["u"], 1e-5, "u")
    _close(port.weight_v, sn["v"], 1e-5, "v")


@pytest.mark.parametrize("update_stats", [False, True])
@pytest.mark.parametrize("fin,fout,bias", [(32, 1, False), (32, N_CLASS, True)])
def test_sn_linear_matches_jax(fin, fout, bias, update_stats):
    port, jax_layer, variables = _sn_linear_pair(fin, fout, bias, fout, iterated=not update_stats)
    x = np.random.RandomState(fout).randn(3, fin).astype(np.float32)
    want, new = jax_layer.apply(variables, jnp.asarray(x), update_stats, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), update_stats)
    _close(got, want, 1e-5, "SNLinear")
    sn = new["batch_stats"]["sn"] if update_stats else variables["batch_stats"]["sn"]
    _close(port.weight_u, sn["u"], 1e-5, "u")
    _close(port.weight_v, sn["v"], 1e-5, "v")


def test_sn_gradient_flows_through_sigma():
    """sigma = u^T W v with u and v constants: W's gradient is that of
    W / sigma, and a later update of the buffers in place does not break
    the earlier call's backward."""
    layer = init_weights(SNLinear(6, 4), torch.Generator().manual_seed(3))
    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(4))
    y = layer(x).square().sum()
    u, v = layer.weight_u.clone(), layer.weight_v.clone()  # this call's power iteration
    layer(x)  # advances u and v in place
    y.backward()
    w = layer.weight_orig.detach().clone().requires_grad_(True)
    ref = torch.nn.functional.linear(x, w / torch.dot(u, w @ v), layer.bias.detach())
    want = torch.autograd.grad(ref.square().sum(), w)[0]
    torch.testing.assert_close(layer.weight_orig.grad, want, rtol=1e-5, atol=1e-6)


# ---- the discriminators

# kind, image or crop side, extra_block
CASES = [("image", 64, False), ("image", 128, False), ("object", 32, False),
         ("attribute", 32, False), ("attribute", 64, True)]


def _pair(kind, extra_block, dtype=None, iterated=True):
    """(the port's discriminator, the JAX one, its variables, the bridge back),
    with the port's seeded weights (u and v `_iterated` once, or as drawn)."""
    tdt = torch.bfloat16 if dtype == "bf16" else None
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    gen = torch.Generator().manual_seed(len(kind) + extra_block)
    if kind == "image":
        port, jax_d = ImageDiscriminator(D, tdt), JaxImageD(conv_dim=D, dtype=jdt)
        load, back = import_image_discriminator, jax_import.image_discriminator_state_dict_from_jax
    elif kind == "object":
        port, jax_d = ObjectDiscriminator(N_CLASS, D, tdt), JaxObjectD(N_CLASS, conv_dim=D, dtype=jdt)
        load, back = import_object_discriminator, jax_import.object_discriminator_state_dict_from_jax
    else:
        port = AttributeDiscriminator(N_ATT, D, extra_block, tdt)
        jax_d = JaxAttributeD(N_ATT, conv_dim=D, extra_block=extra_block, dtype=jdt)
        load = lambda sd: import_attribute_discriminator(sd, extra_block)  # noqa: E731
        back = lambda p, s: jax_import.attribute_discriminator_state_dict_from_jax(  # noqa: E731
            p, s, extra_block)
    init_weights(port, gen)
    port = _iterated(port) if iterated else port
    params, stats = load(_sd_numpy(port))
    return port, jax_d, {"params": params, "batch_stats": stats}, back


def _outputs(out):
    return [np.asarray(o.float() if isinstance(o, torch.Tensor) else o.astype(jnp.float32))
            for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("update_stats", [False, True])
@pytest.mark.parametrize("kind,side,extra_block", CASES)
def test_discriminator_matches_jax_f32(kind, side, extra_block, update_stats):
    port, jax_d, variables, back = _pair(kind, extra_block, iterated=not update_stats)
    x = np.random.RandomState(side).randn(2, side, side, 3).astype(np.float32)
    want, new = jax_d.apply(variables, jnp.asarray(x), update_stats, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(nchw(x), update_stats)
    for g, w in zip(_outputs(got), _outputs(want), strict=True):
        _close(g, w, 1e-5, f"{kind} D logits")
    # u and v of every layer after the call: JAX's returned batch_stats
    stats = new["batch_stats"] if update_stats else variables["batch_stats"]
    want_sd = back(variables["params"], stats)
    got_sd = port.state_dict()
    for key in want_sd:
        if key.endswith(("weight_u", "weight_v")):
            _close(got_sd[key].numpy(), want_sd[key].numpy(), 1e-5, key)


# bf16: both compute each conv and linear in bf16 from f32 weights divided
# by sigma in f32, but round at different places (XLA's CPU convs keep f32
# sums and fuse the bias and the pool; torch rounds each op's output, and
# sums the spatial map in f32 before rounding), and the logits sum a
# 16 d-channel map: 3e-2 of the logits' max
@pytest.mark.parametrize("kind,side,extra_block", CASES)
def test_discriminator_matches_jax_bf16(kind, side, extra_block):
    port, jax_d, variables, _ = _pair(kind, extra_block, "bf16")
    x = np.random.RandomState(side + 1).randn(2, side, side, 3).astype(np.float32)
    want = jax_d.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(nchw(x), False)
    for g, w in zip(_outputs(got), _outputs(want), strict=True):
        _close(g, w, 3e-2, f"{kind} D logits, bf16")


@pytest.mark.parametrize("kind,extra_block", [("image", False), ("object", False),
                                              ("attribute", False), ("attribute", True)])
def test_discriminator_bridge_round_trip(kind, extra_block):
    """port state_dict -> JAX's importer -> the port's bridge: the same
    keys and bits, and a strict load."""
    port, _, variables, back = _pair(kind, extra_block, iterated=False)
    sd = back(variables["params"], variables["batch_stats"])
    want = port.state_dict()
    assert sorted(sd) == sorted(want)
    for key, value in want.items():
        assert torch.equal(sd[key], value), key
    fresh = type(port)(*((N_CLASS,) if kind == "object" else ()), conv_dim=D,
                       **({"extra_block": extra_block, "n_attribute": N_ATT}
                          if kind == "attribute" else {}))
    fresh.load_state_dict(sd, strict=True)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in want.items())


def test_residual_block_shortcut_reads_relu_of_x():
    """The shortcut takes relu(x), the shared pre-activation: on an x with
    negative entries the block differs from one whose shortcut is fed x
    unactivated, and equals it once x is non-negative."""
    block = init_weights(DResidualBlock(4, 8, downsample=True), torch.Generator().manual_seed(5))
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(6))
    assert (x < 0).any()

    def unactivated_shortcut(x):
        h = block.resi["3"](torch.relu(block.resi["1"](torch.relu(x), False)), False)
        return avg_pool2(h) + avg_pool2(block.sc(x, False))  # the block's own pool

    with torch.no_grad():
        got = block(x, False)
        assert not torch.allclose(got, unactivated_shortcut(x))
        torch.testing.assert_close(got, unactivated_shortcut(torch.relu(x)), rtol=0, atol=0)
        assert torch.equal(block(torch.relu(x), False), got)


@pytest.mark.parametrize("image_size,blocks", [(64, 5), (128, 6)])
def test_build_discriminators_follows_the_config(image_size, blocks):
    """Widths from `d_conv_dim`, classes and attributes from the config, the
    attribute D's extra block at 128^2 only, bf16 from `bf16`, and weights
    that are a function of the seed."""
    cfg = Config(image_size=image_size, d_conv_dim=4, num_classes=N_CLASS, attribute_dim=N_ATT,
                 bf16=True)
    image, obj, att = build_discriminators(cfg, "cpu", seed=2)
    assert len(image.main) == len(obj.main) == 5 and len(att.main) == blocks
    assert image.classifier.weight_orig.shape == (1, 64) and image.classifier.bias is None
    assert obj.classifier_cls.weight_orig.shape == (N_CLASS, 64)
    assert att.classifier_att.weight_orig.shape == (N_ATT, 64)
    assert image.main[0].resi["0"].compute_dtype == torch.bfloat16
    again = build_discriminators(cfg, "cpu", seed=2)[2].state_dict()
    other = build_discriminators(cfg, "cpu", seed=3)[2].state_dict()
    key = "main.1.resi.1.weight_orig"
    assert torch.equal(again[key], att.state_dict()[key]) and not torch.equal(other[key], again[key])
    u = att.state_dict()["main.1.resi.1.weight_u"]
    assert abs(u.norm().item() - 1) < 1e-6


def test_pool_shapes_are_a_steps_pools():
    """`first_window_rule.pool_shapes` on the host at small widths (B=8,
    O=3, d 8): the image D's pools on the D phase's 4 B images and the G
    phase's 3 B, from its first block's at 64^2 down to 4^2, and the crops'
    on the attribute D's B O real crops and the object D's 4 B O and 3 B O,
    32^2 down to 4^2 (3 B images and B O crops share their trunk's shapes),
    each once; the Ds' pool is itself again afterwards."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.models import discriminator
    from aglayout_tpu_torch.tools.first_window_rule import pool_shapes

    pool = discriminator.avg_pool2
    shapes = pool_shapes("cpu", **{k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"})
    assert discriminator.avg_pool2 is pool
    trunk = [(16, 32), (32, 16), (64, 8), (128, 4)]
    assert len(set(shapes)) == len(shapes)
    assert set(shapes) == ({(n, c, s, s) for n in (24, 32) for c, s in [(8, 64), (3, 64)] + trunk}
                           | {(n, c, s, s) for n in (24, 72, 96) for c, s in trunk})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avg_pool2_is_avg_pool2d(dtype):
    """The Ds' 2x2 pool (F.avg_pool2d's forward, its gradient an expand)
    against F.avg_pool2d: the same values, bit for bit, and the same
    gradient, a quarter of the output's gradient on each of its four
    pixels."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 5, 16, 8, generator=g).to(dtype).requires_grad_()
    y = torch.randn(3, 5, 8, 4, generator=g).to(dtype)
    got, want = avg_pool2(x), torch.nn.functional.avg_pool2d(x, 2)
    assert torch.equal(got, want)
    (gx,) = torch.autograd.grad((got * y).sum(), x)
    (wx,) = torch.autograd.grad((want * y).sum(), x)
    assert torch.equal(gx, wx)
