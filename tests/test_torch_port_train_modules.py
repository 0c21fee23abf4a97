"""Each train-mode module's backward in the port against the JAX package's,
on the CPU, at small widths (`torch_port_common.SMALL`), f32, on identical
inputs and a random cotangent: the generator's attribute, crop and layout
encoders, its global encoder with the decoder (64^2 and 128^2), and the
three discriminators with and without `update_stats`. Every parameter's and
input's gradient within 1e-4 of its tensor's max |.|, but the gradients
that are rounding noise (the attribute encoder's biases before its BNs,
zero in exact arithmetic). The generator end to end is
`test_torch_port_train_forward.py`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models import discriminator as jdisc
from aglayout_tpu.utils.torch_import import (
    import_attribute_discriminator,
    import_image_discriminator,
    import_object_discriminator,
)
from aglayout_tpu_torch.models import build_discriminators
from aglayout_tpu_torch.utils import jax_import
from tests.test_torch_port_train_forward import _inputs
from tests.torch_port_common import (
    NUM_CLASSES,
    SMALL,
    close,
    generator_pair,
    nchw,
    nhwc,
    noise_tensors,
    sd_numpy,
    train_configs,
)

torch.set_num_threads(1)


def _module_inputs(size, rng):
    """Random inputs of each generator module at `size` (JAX layouts)."""
    b, o, d = 3, 3, SMALL["conv_dim"]
    batch = _inputs(size)
    n = b * o
    s = 32 if size == 64 else 64
    return {
        "attribute_encoder": (batch["objs"].reshape(-1), batch["attribute"].reshape(n, -1),
                              batch["valid"].reshape(-1)),
        "crop_encoder": (rng.randn(n, s, s, 3).astype(np.float32), batch["objs"].reshape(-1),
                         batch["valid"].reshape(-1)),
        "layout_encoder": (rng.randn(b, o, d).astype(np.float32), batch["valid"], batch["z"],
                           batch["objs"], batch["boxes"]),
        "decoder": (rng.randn(b, 8, 8, d).astype(np.float32),),
    }


def _jax_apply(jmodel, variables, name, args, eps_key):
    """The JAX generator's module `name` in train mode on `args` (for the
    decoder: the global encoder, then the decoder)."""
    P, S = variables["params"], variables["batch_stats"]
    rngs = {"reparam": eps_key}

    def f(params, *xs):
        v = {"params": params, "batch_stats": S}
        if name == "decoder":
            def run(mdl, h):
                return mdl.decoder(h, mdl.global_encoder(h, True), True)
        elif name == "layout_encoder":
            def run(mdl, objs_att, valid, z, objs, boxes):
                return mdl.layout_encoder(objs_att, None, valid, z, objs, True, boxes=boxes)
        elif name == "crop_encoder":
            def run(mdl, crops, objs, mask):
                return mdl.crop_encoder(crops, objs, mask, True)
        else:
            def run(mdl, objs, attribute, mask):
                return mdl.attribute_encoder(objs, attribute, mask, True)
        out, _ = jmodel.apply(v, *xs, method=run, rngs=rngs, mutable=["batch_stats"])
        return out

    return f, P


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("name", ["attribute_encoder", "crop_encoder", "layout_encoder", "decoder"])
def test_module_backward_matches_jax(name, size):
    jmodel, variables, tmodel = generator_pair(seed=7, image_size=size)
    tmodel.train()
    rng = np.random.RandomState(3)
    args = _module_inputs(size, rng)[name]
    f, P = _jax_apply(jmodel, variables, name, tuple(map(jnp.asarray, args)), jax.random.PRNGKey(1))
    float_args = [i for i, a in enumerate(args) if a.dtype == np.float32 and a.ndim >= 3]
    out, vjp = jax.vjp(lambda p, *xs: f(p, *xs), P, *map(jnp.asarray, args))
    outs = out if isinstance(out, tuple) else (out,)
    cots = tuple(rng.randn(*o.shape).astype(np.float32) for o in outs)
    grads = vjp(cots if isinstance(out, tuple) else cots[0])

    targs = [torch.from_numpy(np.array(a)) for a in args]
    targs = [t.long() if name != "layout_encoder" and t.dtype == torch.int32 else t for t in targs]
    for i in float_args:
        targs[i] = (nchw(args[i]) if args[i].ndim == 4 else targs[i]).requires_grad_()
    if name == "decoder":
        h = targs[0]
        touts = (tmodel.decoder(h, tmodel.global_encoder(h)),)
        cot_t = (nchw(cots[0]),)
    elif name == "layout_encoder":
        objs_att, valid, z, objs, boxes = targs
        touts = (tmodel.layout_encoder(objs_att, valid, z, objs.long(), boxes),)
        cot_t = (nchw(cots[0]),)
    elif name == "crop_encoder":
        z, mu, logvar = outs
        eps = (np.asarray(z) - np.asarray(mu)) / np.exp(np.asarray(logvar) / 2)
        touts = tmodel.crop_encoder(*targs, torch.from_numpy(eps))
        cot_t = tuple(map(torch.from_numpy, cots))
    else:
        touts = (tmodel.attribute_encoder(*targs),)
        cot_t = (torch.from_numpy(cots[0]),)
    for o, w in zip(touts, outs):
        close(o if o.ndim == 2 else nhwc(o), w, 1e-4, f"{name} output")
    torch.autograd.backward(touts, cot_t)

    full = dict(variables["params"], **{name: grads[0][name]})
    if name == "decoder":
        full["global_encoder"] = grads[0]["global_encoder"]
    want = jax_import.generator_state_dict_from_jax(full, variables["batch_stats"], size,
                                                    SMALL["clstm_layers"], SMALL["resi_num"])
    prefixes = (name, "global_encoder") if name == "decoder" else (name,)
    got = {f"g.{k}": p.grad for k, p in tmodel.named_parameters() if k.startswith(prefixes)}
    want = {k: want[k[2:]] for k in got}
    noise = noise_tensors(want)  # the attribute encoder's biases before its BNs
    assert len(noise) == (2 if name == "attribute_encoder" else 0)
    for key in got.keys() - noise:
        close(got[key], want[key], 1e-4, f"{name} grad {key}")
    for i in float_args:
        g = targs[i].grad
        close(g if g.ndim == 2 or g.ndim == 3 else nhwc(g), grads[1 + i], 1e-4, f"{name} input {i}")


@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("kind,side", [("image", 64), ("object", 32), ("attribute", 64)])
def test_discriminator_backward_matches_jax(kind, side, update_stats):
    cfg, _ = train_configs(128 if side == 64 and kind == "attribute" else 64)
    nets = build_discriminators(cfg, "cpu", seed=5)
    port = dict(zip(("image", "object", "attribute"), nets))[kind]
    extra = kind == "attribute" and cfg.image_size == 128
    if kind == "image":
        jd = jdisc.ImageDiscriminator(conv_dim=8)
        params, stats = import_image_discriminator(sd_numpy(port))
        back = jax_import.image_discriminator_state_dict_from_jax
    elif kind == "object":
        jd = jdisc.ObjectDiscriminator(NUM_CLASSES, conv_dim=8)
        params, stats = import_object_discriminator(sd_numpy(port))
        back = jax_import.object_discriminator_state_dict_from_jax
    else:
        jd = jdisc.AttributeDiscriminator(SMALL["attribute_dim"], conv_dim=8, extra_block=extra)
        params, stats = import_attribute_discriminator(sd_numpy(port), extra)
        back = functools.partial(jax_import.attribute_discriminator_state_dict_from_jax,
                                 extra_block=extra)
    rng = np.random.RandomState(side)
    x = rng.randn(4, side, side, 3).astype(np.float32)

    def f(p, x):
        out, _ = jd.apply({"params": p, "batch_stats": stats}, x, update_stats,
                          mutable=["batch_stats"])
        return out

    out, vjp = jax.vjp(f, params, jnp.asarray(x))
    outs = out if isinstance(out, tuple) else (out,)
    cots = tuple(rng.randn(*o.shape).astype(np.float32) for o in outs)
    gp, gx = vjp(cots if isinstance(out, tuple) else cots[0])
    xt = nchw(x).requires_grad_()
    tout = port(xt, update_stats)
    touts = tout if isinstance(tout, tuple) else (tout,)
    torch.autograd.backward(touts, tuple(map(torch.from_numpy, cots)))
    want = back(gp, stats)
    for key, p in port.named_parameters():
        close(p.grad, want[key], 1e-4, f"{kind} D grad {key}")
    close(nhwc(xt.grad), gx, 1e-4, f"{kind} D input grad")


