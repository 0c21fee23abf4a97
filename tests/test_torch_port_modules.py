"""The port's modules against their JAX counterparts, eval mode, f32, from
the same weights and the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.convlstm import LayoutFuser as JaxLayoutFuser
from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.utils.torch_import import _TreeBuilder
from aglayout_tpu_torch.models.convlstm import LayoutFuser
from aglayout_tpu_torch.models.generator import init_weights
from aglayout_tpu_torch.models.norms import SPADE
from torch_port_common import generator_pair, layouts, nchw, nhwc

torch.set_num_threads(1)
# f32 on both sides with the same algebra: only summation order differs
ATOL = RTOL = 1e-5


@pytest.mark.parametrize("f", [2, 8])  # classic nearest-resize path; exact class-grid path
def test_spade_matches_jax(f):
    c, seg_c, hs = 8, 8, 8
    spade = init_weights(SPADE(c, seg_features=seg_c, nhidden=16),
                         torch.Generator().manual_seed(f)).eval()
    t = _TreeBuilder({k: v.numpy() for k, v in spade.state_dict().items()})
    t.spade("", ())
    rng = np.random.RandomState(f)
    seg = rng.randn(2, hs, hs, seg_c).astype(np.float32)
    x = rng.randn(2, hs * f, hs * f, c).astype(np.float32)
    want = JaxSPADE(c, seg_features=seg_c, nhidden=16).apply(
        {"params": t.params, "batch_stats": t.stats}, jnp.asarray(x), jnp.asarray(seg), True
    )
    with torch.no_grad():
        got = spade(nchw(x), nchw(seg))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_convlstm_masked_slots_match_jax():
    """Invalid slots (valid == 0) carry h and c through unchanged."""
    b, o, cin, hw, dims = 3, 4, 6, 8, (8, 4)
    fuser = init_weights(LayoutFuser(cin, dims), torch.Generator().manual_seed(0)).eval()
    t = _TreeBuilder({k: v.numpy() for k, v in fuser.state_dict().items()})
    for i in range(len(dims)):
        t.conv(f"cell_list.{i}.conv", ("step", f"cell_{i}", "conv"))
    rng = np.random.RandomState(0)
    x = rng.randn(b, o, hw, hw, cin).astype(np.float32)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 0], [1, 1, 0, 0]], np.float32)
    want = JaxLayoutFuser(dims).apply({"params": t.params}, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got = fuser(torch.from_numpy(x).permute(0, 1, 4, 2, 3), torch.from_numpy(valid))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)
    # a trailing invalid slot changes nothing: image 2's state == after its 2 objects
    with torch.no_grad():
        short = fuser(torch.from_numpy(x[2:, :2]).permute(0, 1, 4, 2, 3), torch.ones(1, 2))
    np.testing.assert_allclose(short.numpy(), got[2:].numpy(), atol=0, rtol=0)


@pytest.fixture(scope="module")
def pair():
    return generator_pair(seed=3)


def test_attribute_encoder_matches_jax(pair):
    jm, v, tm = pair
    objs, _, valid, _, attr = layouts(3, 4, seed=1)
    n = objs.size
    want = jm.apply(v, jnp.asarray(objs.reshape(n)), jnp.asarray(attr.reshape(n, -1)),
                    jnp.asarray(valid.reshape(n)), False,
                    method=lambda m, *a: m.attribute_encoder(*a))
    with torch.no_grad():
        got = tm.attribute_encoder(torch.from_numpy(objs.reshape(n)).long(),
                                   torch.from_numpy(attr.reshape(n, -1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_fused_stage1_matches_jax(pair):
    """Eval `_fused_stage1`: the box-algebra c0 + bn1 + relu + c2."""
    jm, v, tm = pair
    objs, boxes, _, z, _ = layouts(3, 4, seed=2)
    codes = np.random.RandomState(2).randn(3, 4, 8).astype(np.float32)
    vec = np.concatenate([codes, z], -1)
    want = jm.apply(v, jnp.asarray(vec), jnp.asarray(boxes), jnp.asarray(objs),
                    method=lambda m, *a: m.layout_encoder._fused_stage1(*a, None, False))
    with torch.no_grad():
        got = tm.layout_encoder._fused_stage1(torch.from_numpy(vec), torch.from_numpy(boxes),
                                              torch.from_numpy(objs).long())
    assert got.shape == (12, 16, 33, 33)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_global_encoder_matches_jax(pair):
    jm, v, tm = pair
    h = np.random.RandomState(4).randn(2, 8, 8, 8).astype(np.float32)
    want = jm.apply(v, jnp.asarray(h), False, method=lambda m, *a: m.global_encoder(*a))
    with torch.no_grad():
        got = tm.global_encoder(nchw(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_layout_encoder_matches_jax(pair):
    """The whole eval layout encoder: stage 1, c3, c4, ConvLSTM, trunk."""
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
