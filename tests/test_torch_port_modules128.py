"""The port's 128^2 modules against their JAX counterparts, eval mode, f32,
from the same weights and the same numpy inputs: the typed geometry, the
layout encoder (typed c2/c3 and the c4 fold) and the decoder's 2x tail;
and the 128^2 state_dict through both weight bridges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models import generator as jax_generator
from aglayout_tpu.utils.torch_import import import_generator
from aglayout_tpu_torch.models.generator import Generator as TorchGenerator
from aglayout_tpu_torch.models.generator import init_weights, typed_axis_coverage
from aglayout_tpu_torch.utils.jax_import import generator_state_dict_from_jax
from torch_port_common import NUM_CLASSES, SMALL, generator_pair, layouts, nchw, nhwc

torch.set_num_threads(1)
# f32 on both sides with the same algebra: only summation order differs
ATOL = RTOL = 1e-5


@pytest.mark.parametrize("size", [64, 128])
def test_typed_axis_coverage_matches_jax(size):
    """Every integer box edge pair is covered by the typed candidates, in
    both packages, pair by pair."""
    got = typed_axis_coverage(size)
    want = jax_generator.typed_axis_coverage(size)
    for g, w in zip(got, want):
        assert g.shape == ((size + 1) ** 2,) and bool(g.all())
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def pair():
    return generator_pair(seed=4, image_size=128)


def test_layout_encoder128_matches_jax(pair):
    """The whole eval layout encoder at 128^2: the typed c2/c3 algebra, the
    c4 fold, the ConvLSTM and the trunk."""
    jm, v, tm = pair
    objs, boxes, valid, z, _ = layouts(2, 3, seed=5)
    codes = np.random.RandomState(5).randn(2, 3, 8).astype(np.float32)
    want = jm.apply(v, *map(jnp.asarray, (codes, valid, z, objs)), False,
                    method=lambda m, a, vl, zz, ob, tr: m.layout_encoder(
                        a, None, vl, zz, ob, tr, boxes=jnp.asarray(boxes)))
    with torch.no_grad():
        got = tm.layout_encoder(*map(torch.from_numpy, (codes, valid, z, objs.astype(np.int64), boxes)))
    assert got.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_typed_c2c3_matches_jax(pair):
    """`_typed_c2c3_eval` alone: c0..bn3 + relu by type algebra, before the
    c4 fold, (B*O, 4d, 32, 32)."""
    jm, v, tm = pair
    objs, boxes, _, z, _ = layouts(2, 3, seed=6)
    codes = np.random.RandomState(6).randn(2, 3, 8).astype(np.float32)
    vec = np.concatenate([codes, z], -1)
    want = jm.apply(v, jnp.asarray(vec), jnp.asarray(boxes), jnp.asarray(objs),
                    method=lambda m, *a: m.layout_encoder._typed_c2c3_eval(*a))
    with torch.no_grad():
        got = tm.layout_encoder._typed_c2c3_eval(torch.from_numpy(vec), torch.from_numpy(boxes),
                                                 torch.from_numpy(objs).long())
    assert got.shape == (6, 32, 32, 32)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_decoder128_matches_jax(pair):
    """The decoder at 128^2: the 64^2 trunk and c4 head, the nearest 2x
    upsample, c5, SPADE-4, c6 and the c7 head."""
    jm, v, tm = pair
    rng = np.random.RandomState(7)
    hidden = rng.randn(2, 8, 8, 8).astype(np.float32)
    global_h = rng.randn(2, 16).astype(np.float32)
    want = jm.apply(v, jnp.asarray(hidden), jnp.asarray(global_h), False,
                    method=lambda m, *a: m.decoder(*a))
    with torch.no_grad():
        got = tm.decoder(nchw(hidden), torch.from_numpy(global_h))
    assert got.shape == (2, 3, 128, 128)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_bridge_round_trip_128():
    """The port's 128^2 state_dict -> JAX trees (`import_generator`) -> the
    port's bridge gives the state_dict back bit for bit, and loads strictly
    into a 128^2 port."""
    cfg = dict(SMALL, image_size=128, object_size=64)
    model = init_weights(TorchGenerator(num_classes=NUM_CLASSES, **cfg),
                         torch.Generator().manual_seed(8))
    sd = model.state_dict()
    assert "decoder.c7.bias" in sd and "decoder.spade_5.mlp_beta.weight" in sd
    params, stats = import_generator({k: t.numpy() for k, t in sd.items()}, image_size=128,
                                     clstm_layers=cfg["clstm_layers"], resi_num=cfg["resi_num"])
    assert {"c5", "spade_4", "c6", "spade_5", "c7"} <= set(params["decoder"])
    back = generator_state_dict_from_jax(params, stats, image_size=128,
                                         clstm_layers=cfg["clstm_layers"], resi_num=cfg["resi_num"])
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k  # exact: transposes and flips only
    TorchGenerator(num_classes=NUM_CLASSES, **cfg).load_state_dict(back, strict=True)
