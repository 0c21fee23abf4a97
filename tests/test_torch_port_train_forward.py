"""The port's train-mode generator and discriminators against the JAX
package's, on the CPU, at small widths (`torch_port_common.SMALL`), f32:

  * `Generator.forward` at 64^2 and 128^2 on a synthetic batch (B=3, O=3)
    with the reparametrisation draw JAX made: each of its 11 outputs, every
    running statistic after it, and the gradients of a scalar of all the
    outputs with respect to every parameter (end to end:
    `check_grads_end_to_end`);
  (each module's backward is held to 1e-4 in `test_torch_port_train_modules.py`);
  * `generate(train=True)`, a train forward followed by the eval typed
    generate against the masks path (the twin of
    `tests/test_typed_layout.py`'s check), and every kernel route in
    training mode.
"""

from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.generator import CropEncoder as JaxCropEncoder
from aglayout_tpu.models.generator import Generator as JaxGenerator
from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.models.convlstm import LayoutFuser
from aglayout_tpu_torch.models.generator import Decoder, LayoutEncoder
from aglayout_tpu_torch.ops.rasterize import rasterize_boxes
from aglayout_tpu_torch.utils import jax_import
from tests.torch_port_common import (
    SMALL,
    check_grads_end_to_end,
    close,
    generator_pair,
    noise_tensors,
    train_configs,
    train_inputs,
)

torch.set_num_threads(1)
KEYS = ("crops_input", "crops_input_rec", "crops_rand", "crops_shift", "img_rec", "img_rand",
        "img_shift", "mu", "logvar", "z_rand_rec", "z_rand_shift")
GEN_ARGS = ("imgs", "objs", "boxes", "masks", "valid", "z", "attribute", "masks_shift",
            "boxes_shift", "attribute_est")


def _inputs(size):
    cfg, _ = train_configs(size)
    batch, _, _ = train_inputs(cfg)
    rng = np.random.RandomState(size)
    batch["z"] = rng.randn(3, 3, SMALL["z_dim"]).astype(np.float32)
    est = batch["attribute"].copy()
    est[..., 0] = 1.0
    batch["attribute_est"] = est
    return batch


def _scalar(outputs, cast):
    """sum of mean(out^2) over the 11 outputs."""
    return sum((cast(outputs[k]) ** 2).mean() for k in KEYS)


@functools.lru_cache(maxsize=None)
def _case(size):
    """(the JAX model's variables, the port's train-mode model, the batch,
    JAX's outputs, statistics after, eps and gradients)."""
    jmodel, variables, tmodel = generator_pair(seed=size, image_size=size)
    batch = _inputs(size)

    def f(params, args):
        out, st = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, *args, train=True,
            rngs={"reparam": jax.random.PRNGKey(size)}, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, method: isinstance(mdl, JaxCropEncoder))
        z, mu, logvar = st["intermediates"]["crop_encoder"]["__call__"][0]
        eps = (z - mu) / jnp.exp(logvar / 2)
        return _scalar(out, lambda x: x.astype(jnp.float32)), (out, st["batch_stats"], eps)

    (_, (out, stats, eps)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"], tuple(jnp.asarray(batch[k]) for k in GEN_ARGS))
    return variables, tmodel.train(), batch, jax.tree.map(np.asarray, (out, stats, eps, grads))


def _port_forward(size):
    """A fresh copy of the port's model (running statistics as drawn), and
    its train forward with JAX's eps."""
    _, tmodel, batch, (_, _, eps, _) = _case(size)
    tb = batch_to_torch(batch, "cpu")
    tmodel = copy.deepcopy(tmodel)
    return tmodel, tmodel(*(tb[k] for k in GEN_ARGS), torch.from_numpy(np.array(eps)))


@pytest.mark.parametrize("size", [64, 128])
def test_train_forward_outputs_and_stats_match_jax(size):
    variables, _, _, (out, stats, _, _) = _case(size)
    tmodel, tout = _port_forward(size)
    assert set(tout) == set(out) == set(KEYS)
    for k in KEYS:
        close(tout[k], out[k], 1e-4, k)
    want = jax_import.generator_state_dict_from_jax(variables["params"], stats, size,
                                                    SMALL["clstm_layers"], SMALL["resi_num"])
    bufs = dict(tmodel.named_buffers())
    for key, w in want.items():
        if key.endswith(("running_mean", "running_var")):
            err = (bufs[key] - w).abs().max().item()
            assert err <= 1e-5 * max(1.0, w.abs().max().item()), (key, err)
    # each BN ran once per call: 2 attribute-encoder calls, 3 of the others
    assert int(tmodel.attribute_encoder.bn0.num_batches_tracked) == 2
    assert int(tmodel.crop_encoder.bn1.bn.num_batches_tracked) == 3
    assert int(tmodel.decoder.spade_0.param_free_norm.num_batches_tracked) == 3


# The forward's gradients against JAX's, each tensor in relative L2. JAX's
# jitted f32 gradients are 6.8e-3 (64^2) and 5.0e-3 (128^2) from the port's
# f64 ones, the port's f32 ones 1.9e-5 and 1.4e-3 from them
# (`tools/port_train_precision.py`).
FORWARD_GRAD_TOL = 2e-2


@pytest.mark.parametrize("size", [64, 128])
def test_train_forward_grads_match_jax(size):
    variables, _, _, (_, stats, _, grads) = _case(size)
    tmodel, tout = _port_forward(size)
    _scalar(tout, lambda x: x.float()).backward()
    want = jax_import.generator_state_dict_from_jax(grads, stats, size, SMALL["clstm_layers"],
                                                    SMALL["resi_num"])
    got = {f"g.{k}": p.grad for k, p in tmodel.named_parameters()}
    _, n = check_grads_end_to_end(got, {f"g.{k}": want[k] for k, _ in tmodel.named_parameters()},
                                  f"G forward {size}", FORWARD_GRAD_TOL)
    assert n == len(got) - 2  # the two biases before a batch-statistics BN


def _port_grads(size, dtype):
    """The port's gradients of the scalar after a train forward in `dtype`
    (a copy of the model and the inputs cast to it)."""
    _, tmodel, batch, (_, _, eps, _) = _case(size)
    tmodel = copy.deepcopy(tmodel).to(dtype)
    tb = {k: (v.to(dtype) if v.is_floating_point() and k != "valid" else v)
          for k, v in batch_to_torch(batch, "cpu").items()}
    out = tmodel(*(tb[k] for k in GEN_ARGS), torch.from_numpy(np.array(eps)).to(dtype))
    _scalar(out, lambda x: x).backward()
    return {k: p.grad.double() for k, p in tmodel.named_parameters()}


@pytest.mark.parametrize("size", [64, 128])
def test_train_forward_grads_match_the_ports_f64(size):
    """The port's f32 gradients against its own f64 evaluation of the same
    forward: within 5e-3 of each tensor's max |.| (measured 2.6e-5 at 64^2,
    2.8e-3 at 128^2, where E[x^2] - E[x]^2 over the crop encoder's 64^2 maps
    loses digits; `tools/port_train_precision.py`)."""
    g32, g64 = _port_grads(size, torch.float32), _port_grads(size, torch.float64)
    noise = noise_tensors(g64)
    assert len(noise) == 2
    for key in g64.keys() - noise:
        close(g32[key], g64[key], 5e-3, f"f32 against f64 {key}")


# ---- generate in training mode, the typed twin, the routes


@pytest.mark.parametrize("size", [64, 128])
def test_generate_train_matches_jax(size):
    jmodel, variables, tmodel = generator_pair(seed=11, image_size=size)
    b = _inputs(size)
    args = (b["objs"], b["boxes"], b["valid"], b["z"], b["attribute"])
    want, new = jmodel.apply(variables, *map(jnp.asarray, args), None, True,
                             method=JaxGenerator.generate, mutable=["batch_stats"])
    got = tmodel.generate(torch.from_numpy(b["objs"]).long(),
                          *(torch.from_numpy(a) for a in args[1:]), train=True)
    assert not tmodel.training  # the module's own mode comes back
    # the masks path's dense c0 on (B O) full-size planes, then batch
    # statistics: measured 1.3e-4 at 128^2 (the port's masks path equals its
    # closed form to 3e-6)
    close(got, want, 1e-3, "generate(train=True)")
    wsd = jax_import.generator_state_dict_from_jax(variables["params"], new["batch_stats"], size,
                                                   SMALL["clstm_layers"], SMALL["resi_num"])
    for key, v in tmodel.state_dict().items():
        if key.endswith(("running_mean", "running_var")) and not key.startswith("crop_encoder"):
            err = (v - wsd[key]).abs().max().item()
            assert err <= 1e-5 * max(1.0, wsd[key].abs().max().item()), (key, err)


@pytest.mark.parametrize("size", [64, 128])
def test_fused_train_forward_matches_masks_path(size):
    """The train forward's closed-form first stage (analytic bn1 moments on
    the boxes) against `fused_layout=False`, the dense c0 on the rasterized
    masks: the outputs and every running statistic after (the twin of
    `tests/test_fused_layout.py`'s train check)."""
    _, _, tmodel = generator_pair(seed=17, image_size=size)
    b = _inputs(size)
    tb = batch_to_torch(b, "cpu")
    eps = torch.randn(9, SMALL["z_dim"], generator=torch.Generator().manual_seed(1))
    fused, dense = copy.deepcopy(tmodel).train(), copy.deepcopy(tmodel).train()
    dense.fused_layout = False
    with torch.no_grad():
        out_f = fused(*(tb[k] for k in GEN_ARGS), eps)
        out_d = dense(*(tb[k] for k in GEN_ARGS), eps)
    for k in KEYS:
        close(out_f[k], out_d[k], 1e-4, k)
    sd = dense.state_dict()
    for key, v in fused.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert (v - sd[key]).abs().max().item() <= 1e-5 * max(1.0, sd[key].abs().max().item()), key


@pytest.mark.parametrize("size", [64, 128])
def test_typed_generate_after_a_train_forward_matches_masks_path(size):
    """A train forward leaves trained running statistics; the eval box path
    (at 128^2 the typed algebra) then equals the eval masks path, as JAX's
    `tests/test_typed_layout.py` holds its own."""
    _, _, tmodel = generator_pair(seed=13, image_size=size)
    b = _inputs(size)
    tb = batch_to_torch(b, "cpu")
    eps = torch.randn(9, SMALL["z_dim"], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tmodel.train()(*(tb[k] for k in GEN_ARGS), eps)
    tmodel.eval()
    args = (tb["objs"], tb["boxes"], tb["valid"], tb["z"], tb["attribute"])
    masks = rasterize_boxes(tb["boxes"], size, size)[..., None]
    typed = tmodel.generate(*args)
    dense = tmodel.generate(*args, masks=masks)
    assert (typed - dense).abs().max().item() <= 3e-4


def test_every_route_is_plain_in_training_mode():
    """At the published widths each site takes its kernel in eval mode and
    the plain composition in training mode (models on the meta device; the
    routes read shapes only)."""
    dt = torch.bfloat16
    with torch.device("meta"):
        enc = LayoutEncoder(23, image_size=128, conv_dim=64, resi_num=2, clstm_dims=(64,), dtype=dt)
        dec = Decoder(image_size=128, conv_dim=64, dtype=dt)
        fuser = LayoutFuser(512, (128, 64, 64), int8_serving=True, dtype=dt)
    z = lambda *s: torch.zeros(*s, dtype=dt, device="meta")  # noqa: E731
    trunk, c4, seg, c7, z2 = z(2, 64, 8, 8), z(2, 64, 64, 64), z(2, 64, 8, 8), z(2, 128, 128, 128), \
        z(4, 12, 12, 128)
    cell, inp = fuser.cell_list[0], z(4, 640, 8, 8)

    def routes():
        return (enc.trunk_route(trunk), enc.typed_route(z2, 32), dec.head_route(c4, seg),
                dec.head8_route(c7, seg), dec.apply_route(c7, seg), cell.int8_route(inp))

    for m in (enc, dec, fuser):
        m.eval()
    assert routes() == ("k1", "v4", "k2", "k3", "k4", "kernel")
    for m in (enc, dec, fuser):
        m.train()
    assert routes() == ("loop", "plain", "dense", "dense", "dense", "plain")
