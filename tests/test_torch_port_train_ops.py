"""The train path's pieces of the port against the JAX package's, on the CPU:
train-mode BN, class-conditional BN and SPADE (masked and not, with the
running statistics after), `train_affine`, the pools, the bilinear crops,
mask rasterization, ImageNet preprocessing, every loss, and attribute
estimation and swapping (also against the NumPy transcriptions of the
reference's loops in `tests/test_attributes.py`). f32 throughout; inputs
are seeded numpy arrays.
"""

from __future__ import annotations

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aglayout_tpu.models.layers import adaptive_avg_pool as jax_adaptive_avg_pool
from aglayout_tpu.models.layers import avg_pool2 as jax_avg_pool2
from aglayout_tpu.models.norms import ConditionalBatchNorm as JaxCBN
from aglayout_tpu.models.norms import MaskedBatchNorm as JaxBN
from aglayout_tpu.ops import bilinear as jbil
from aglayout_tpu.ops import image as jimage
from aglayout_tpu.ops import rasterize as jras
from aglayout_tpu.train import attributes as jatt
from aglayout_tpu.train import losses as jloss
from aglayout_tpu_torch.models.layers import adaptive_avg_pool
from aglayout_tpu_torch.models.norms import ConditionalBatchNorm, MaskedBatchNorm
from aglayout_tpu_torch.ops import bilinear, image, rasterize
from aglayout_tpu_torch.train import attributes, losses
from tests.test_attributes import A, NC, _batch, ref_estimate, ref_swap
from tests.torch_port_common import close, nchw, nhwc, spade_pair

torch.set_num_threads(1)
T = torch.from_numpy


def _stats_vars(mean, var, scale=None, bias=None):
    params = {} if scale is None else {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    return {"params": params, "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}


def _bn_pair(c, affine, seed):
    rng = np.random.RandomState(seed)
    bn = MaskedBatchNorm(c, affine=affine).train()
    mean, var = rng.randn(c).astype(np.float32) * 0.1, rng.uniform(0.5, 1.5, c).astype(np.float32)
    scale, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    with torch.no_grad():
        bn.running_mean.copy_(T(mean))
        bn.running_var.copy_(T(var))
        if affine:
            bn.weight.copy_(T(scale))
            bn.bias.copy_(T(bias))
    variables = _stats_vars(mean, var, *((scale, bias) if affine else ()))
    return bn, JaxBN(c, affine=affine), variables


# shape (NHWC for JAX), masked, affine
BN_CASES = [((7, 6), False, True), ((7, 6), True, True), ((5, 4, 4, 6), False, True),
            ((5, 4, 4, 6), True, False), ((9, 3, 3, 6), True, True)]


@pytest.mark.parametrize("shape,masked,affine", BN_CASES)
def test_masked_batch_norm_train_matches_jax(shape, masked, affine):
    bn, jbn, variables = _bn_pair(shape[-1], affine, len(shape) + masked)
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    mask = (np.arange(shape[0]) < shape[0] - 2).astype(np.float32) if masked else None
    want, new = jbn.apply(variables, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                          False, mutable=["batch_stats"])
    xt = T(x) if x.ndim == 2 else nchw(x)
    with torch.no_grad():
        got = bn(xt, None if mask is None else T(mask))
    close(got if x.ndim == 2 else nhwc(got), want, 1e-5, "BN train")
    close(bn.running_mean, new["batch_stats"]["mean"], 1e-5, "running_mean")
    close(bn.running_var, new["batch_stats"]["var"], 1e-5, "running_var")
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("affine", [False, True])
def test_train_affine_matches_jax(affine):
    bn, jbn, variables = _bn_pair(6, affine, 3)
    rng = np.random.RandomState(4)
    mean, var = rng.randn(6).astype(np.float32), rng.uniform(0.1, 2, 6).astype(np.float32)
    cnt = np.float32(37.0)
    (a, b), new = jbn.apply(variables, jnp.asarray(mean), jnp.asarray(var), jnp.asarray(cnt),
                            method=JaxBN.train_affine, mutable=["batch_stats"])
    with torch.no_grad():
        ga, gb = bn.train_affine(T(mean), T(var), torch.tensor(cnt))
    close(ga, a, 1e-6, "a")
    close(gb, b, 1e-6, "b")
    close(bn.running_mean, new["batch_stats"]["mean"], 1e-6, "running_mean")
    close(bn.running_var, new["batch_stats"]["var"], 1e-6, "running_var")


def _cbn_pair(c, n_cls, seed):
    rng = np.random.RandomState(seed)
    cbn = ConditionalBatchNorm(c, n_cls).train()
    mean, var = rng.randn(c).astype(np.float32) * 0.1, rng.uniform(0.5, 1.5, c).astype(np.float32)
    table = rng.randn(n_cls, 2 * c).astype(np.float32)
    with torch.no_grad():
        cbn.bn.running_mean.copy_(T(mean))
        cbn.bn.running_var.copy_(T(var))
        cbn.embed.weight.copy_(T(table))
    variables = {"params": {"embed": {"embedding": jnp.asarray(table)}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}}
    return cbn, JaxCBN(c, n_cls), variables


@pytest.mark.parametrize("masked", [False, True])
def test_conditional_batch_norm_train_matches_jax(masked):
    cbn, jcbn, variables = _cbn_pair(6, 5, 7)
    rng = np.random.RandomState(8)
    x = (rng.randn(8, 5, 5, 6) * 3).astype(np.float32)
    y = rng.randint(0, 5, 8)
    mask = (rng.rand(8) < 0.6).astype(np.float32) if masked else None
    want, new = jcbn.apply(variables, jnp.asarray(x), jnp.asarray(y),
                           None if mask is None else jnp.asarray(mask), False,
                           mutable=["batch_stats"])
    with torch.no_grad():
        got = cbn(nchw(x), T(y), None if mask is None else T(mask))
    close(nhwc(got), want, 1e-5, "CBN train")
    close(cbn.bn.running_mean, new["batch_stats"]["bn"]["mean"], 1e-5, "running_mean")
    close(cbn.bn.running_var, new["batch_stats"]["bn"]["var"], 1e-5, "running_var")


def test_conditional_batch_norm_train_affine_matches_jax():
    cbn, jcbn, variables = _cbn_pair(6, 5, 9)
    rng = np.random.RandomState(10)
    y = rng.randint(0, 5, 8)
    mean, var = rng.randn(6).astype(np.float32), rng.uniform(0.1, 2, 6).astype(np.float32)
    (a, b), new = jcbn.apply(variables, jnp.asarray(y), jnp.asarray(mean), jnp.asarray(var),
                             jnp.asarray(np.float32(50.0)), method=JaxCBN.train_affine,
                             mutable=["batch_stats"])
    with torch.no_grad():
        ga, gb = cbn.train_affine(T(y), T(mean), T(var), torch.tensor(50.0))
    close(ga, a, 1e-6, "a")
    close(gb, b, 1e-6, "b")
    close(cbn.bn.running_var, new["batch_stats"]["bn"]["var"], 1e-6, "running_var")


@pytest.mark.parametrize("size", [8, 40])  # the classic path, and f = 5 where eval takes the grid
def test_spade_train_matches_jax(size):
    spade, jspade, variables = spade_pair(6, 4, seed=size)
    spade.train()
    rng = np.random.RandomState(size)
    x = (rng.randn(2, size, size, 6) * 2).astype(np.float32)
    seg = rng.randn(2, 8, 8, 4).astype(np.float32)
    want, new = jspade.apply(variables, jnp.asarray(x), jnp.asarray(seg), False,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = spade(nchw(x), nchw(seg))
    close(nhwc(got), want, 1e-5, "SPADE train")
    close(spade.param_free_norm.running_var,
          new["batch_stats"]["param_free_norm"]["var"], 1e-5, "running_var")


def test_pools_match_jax():
    x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    # the discriminators' F.avg_pool2d(x, 2) is JAX's avg_pool2
    close(nhwc(F.avg_pool2d(nchw(x), 2)), jax_avg_pool2(jnp.asarray(x)), 1e-6, "avg_pool2")
    close(nhwc(adaptive_avg_pool(nchw(x), 8)), jax_adaptive_avg_pool(jnp.asarray(x), 8), 1e-6,
          "adaptive 8")
    close(nhwc(adaptive_avg_pool(nchw(x), 4)), jax_adaptive_avg_pool(jnp.asarray(x), 4), 1e-6,
          "adaptive 4")
    assert adaptive_avg_pool(nchw(x), 16).shape == (2, 3, 16, 16)
    with pytest.raises(ValueError):
        adaptive_avg_pool(nchw(x), 5)


# ---- bilinear crops, rasterization, ImageNet preprocessing


def _boxes(rng, *lead):
    xy0 = rng.uniform(-0.1, 0.7, lead + (2,))
    wh = rng.uniform(0.0, 0.5, lead + (2,))
    return np.concatenate([xy0, xy0 + wh], -1).astype(np.float32)


def test_linspace_and_interp_matrix_match_jax():
    rng = np.random.RandomState(1)
    lo, hi = rng.uniform(-0.2, 0.6, 12).astype(np.float32), rng.uniform(0.3, 1.2, 12).astype(np.float32)
    close(bilinear.tensor_linspace(T(lo), T(hi), 17), jbil.tensor_linspace(lo, hi, 17), 1e-7,
          "linspace")
    close(bilinear.interp_matrix(T(lo), T(hi), 17, 20), jbil.interp_matrix(lo, hi, 17, 20), 1e-6,
          "interp matrix")


def test_crops_match_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(3, 20, 24, 5).astype(np.float32)
    dense_boxes = _boxes(rng, 3, 4)
    got = bilinear.crop_bbox_dense(nchw(feats), T(dense_boxes), 8, 6)  # (B, O, C, 8, 6)
    want = jbil.crop_bbox_dense(jnp.asarray(feats), jnp.asarray(dense_boxes), 8, 6)
    close(got.permute(0, 1, 3, 4, 2), want, 1e-6, "crop_bbox_dense")
    boxes = dense_boxes[:, 0]
    close(nhwc(bilinear.crop_bbox(nchw(feats), T(boxes), 7)),
          jbil.crop_bbox(jnp.asarray(feats), jnp.asarray(boxes), 7), 1e-6, "crop_bbox")
    # a box wholly outside the map crops to zeros (zero padding)
    out = bilinear.crop_bbox(nchw(feats[:1]), torch.tensor([[1.5, 1.5, 2.0, 2.0]]), 4)
    assert out.abs().max() == 0


def test_crop_of_a_bf16_map_is_f32():
    feats = torch.randn(2, 3, 16, 16).bfloat16()
    out = bilinear.crop_bbox_dense(feats, torch.tensor([[[0.1, 0.2, 0.6, 0.9]]] * 2), 4)
    assert out.dtype == torch.float32
    close(out, bilinear.crop_bbox_dense(feats.float(), torch.tensor([[[0.1, 0.2, 0.6, 0.9]]] * 2), 4),
          0.0, "bf16 map")


def test_rasterize_and_shift_match_jax():
    rng = np.random.RandomState(4)
    boxes = np.clip(_boxes(rng, 3, 5), 0, 1)
    boxes[0, 0] = [0.125, 0.5 / 64, 0.5, 1.0]  # edges at exact halves: round half to even
    got = rasterize.rasterize_boxes(T(boxes), 64, 48)
    want = np.asarray(jras.rasterize_boxes(jnp.asarray(boxes), 64, 48))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    close(rasterize.shift_boxes(T(boxes)), jras.shift_boxes(jnp.asarray(boxes)), 0.0, "shift")


def test_imagenet_preprocess_matches_jax():
    x = np.random.RandomState(5).rand(2, 4, 4, 3).astype(np.float32)
    close(image.imagenet_preprocess(T(x)), jimage.imagenet_preprocess(jnp.asarray(x)), 1e-7,
          "preprocess")
    back = image.imagenet_deprocess(image.imagenet_preprocess(T(x)), rescale=False)
    close(back, x, 1e-6, "round trip")


# ---- losses


def test_bce_and_cross_entropy_match_jax():
    rng = np.random.RandomState(6)
    logits = (rng.randn(12, 7) * 4).astype(np.float32)
    target = (rng.rand(12, 7) < 0.3).astype(np.float32)
    w = (rng.rand(12) < 0.7).astype(np.float32)
    pw = rng.uniform(1, 30, 7).astype(np.float32)
    labels = rng.randint(0, 7, 12)
    cases = [((T(logits), 1.0), (jnp.asarray(logits), 1.0)),
             ((T(logits[:, 0]), 0.0, T(w)), (jnp.asarray(logits[:, 0]), 0.0, jnp.asarray(w))),
             ((T(logits), T(target), T(w), T(pw)),
              (jnp.asarray(logits), jnp.asarray(target), jnp.asarray(w), jnp.asarray(pw))),
             ((T(logits), T(target), torch.zeros(12)),
              (jnp.asarray(logits), jnp.asarray(target), jnp.zeros(12)))]
    for targs, jargs in cases:
        close(losses.bce_logits(*targs), jloss.bce_logits(*jargs), 1e-6, "bce")
    close(losses.cross_entropy(T(logits), T(labels)),
          jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)), 1e-6, "ce")
    close(losses.cross_entropy(T(logits), T(labels), T(w)),
          jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)), 1e-6,
          "masked ce")


def test_reconstruction_kl_and_branch_losses_match_jax():
    rng = np.random.RandomState(7)
    img, rec = rng.randn(5, 8, 8, 3).astype(np.float32), rng.randn(5, 8, 8, 3).astype(np.float32)
    for k in (0, 1, 2):
        close(losses.masked_l1_image_rec(T(rec), T(img), k),
              jloss.masked_l1_image_rec(jnp.asarray(rec), jnp.asarray(img), k), 1e-6, "l1 rec")
    z, zr, zs = (rng.randn(10, 4).astype(np.float32) for _ in range(3))
    valid = (rng.rand(10) < 0.6).astype(np.float32)
    close(losses.z_rec_loss(T(zr), T(zs), T(z), T(valid)),
          jloss.z_rec_loss(jnp.asarray(zr), jnp.asarray(zs), jnp.asarray(z), jnp.asarray(valid)),
          1e-6, "z rec")
    mu, logvar = rng.randn(10, 4).astype(np.float32), rng.randn(10, 4).astype(np.float32)
    close(losses.kl_loss(T(mu), T(logvar), T(valid)),
          jloss.kl_loss(jnp.asarray(mu), jnp.asarray(logvar), jnp.asarray(valid)), 1e-6, "kl")
    assert float(losses.branch_weighted(torch.tensor(1.0), torch.tensor(2.0), torch.tensor(4.0))) \
        == pytest.approx(float(jloss.branch_weighted(1.0, 2.0, 4.0)))


def test_losses_run_on_bf16_inputs_in_f32():
    x = torch.randn(6, 3).bfloat16()
    assert losses.bce_logits(x, 1.0).dtype == torch.float32
    assert losses.kl_loss(x, x, torch.ones(6)).dtype == torch.float32


# ---- attribute estimation and swapping


def test_estimate_attributes_matches_jax_and_the_reference_loop():
    rng = np.random.RandomState(0)
    objs, valid, attribute = _batch(rng, 6, 5)
    logits = rng.randn(30, A).astype(np.float32)
    flat_att, flat_valid = attribute.reshape(-1, A), valid.reshape(-1)
    got = attributes.estimate_attributes(T(logits), T(flat_att), T(flat_valid)).numpy()
    want = np.asarray(jatt.estimate_attributes(jnp.asarray(logits), jnp.asarray(flat_att),
                                               jnp.asarray(flat_valid)))
    np.testing.assert_array_equal(got, want)
    real = flat_valid > 0
    np.testing.assert_array_equal(got[real], ref_estimate(logits[real], flat_att[real]))
    np.testing.assert_array_equal(got[~real], flat_att[~real])


def _jax_swap_draws(key, matrix, attribute, objs):
    """JAX `swap_attributes`'s three draws under `key`, with its logits."""
    weights = jnp.take(matrix, objs, axis=0) * (1.0 - attribute)
    safe = jnp.where(jnp.sum(weights, axis=-1, keepdims=True) > 0, weights, jnp.ones_like(weights))
    logits = jnp.log(jnp.maximum(safe, 1e-20))
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.categorical(k1, logits, axis=-1), jax.random.categorical(k2, logits, axis=-1),
            jax.random.bernoulli(k3, 0.5, (attribute.shape[0],)))


@pytest.mark.parametrize("b,o,seed", [(7, 6, 1), (9, 4, 2), (3, 3, 3)])
def test_swap_attributes_with_jax_draws_matches_jax(b, o, seed):
    rng = np.random.RandomState(seed)
    objs, valid, attribute = _batch(rng, b, o)
    matrix = rng.randint(0, 50, (NC, A)).astype(np.float32)
    matrix[0] = 0.0  # class 0's weights vanish: the uniform guard
    flat = [attribute.reshape(-1, A), attribute.reshape(-1, A), objs.reshape(-1), valid.reshape(-1)]
    key = jax.random.PRNGKey(seed)
    want_att, want_est, want_n = jatt.swap_attributes(key, jnp.asarray(matrix),
                                                      *map(jnp.asarray, flat), b, o)
    draws = tuple(T(np.array(d)) for d in _jax_swap_draws(key, jnp.asarray(matrix),
                                                            jnp.asarray(flat[0]),
                                                            jnp.asarray(flat[2])))
    got_att, got_est, got_n = attributes.swap_attributes(T(matrix), *map(T, flat), b, o,
                                                         draws=draws)
    assert got_n == want_n == b // 3
    np.testing.assert_array_equal(got_att.numpy(), np.asarray(want_att))
    np.testing.assert_array_equal(got_est.numpy(), np.asarray(want_est))


def test_swap_attributes_matches_the_reference_loop():
    """The changed rows are the reference loop's (NumPy transcription, ragged
    and in order), each row replaced by its one or two drawn attributes in
    both outputs; drawn by the port's generator, within the co-occurrence
    support with the old attributes excluded."""
    rng = np.random.RandomState(2)
    b, o = 9, 4
    objs, valid, attribute = _batch(rng, b, o)
    matrix = rng.randint(1, 50, (NC, A)).astype(np.float32)
    flat_att, flat_objs, flat_valid = attribute.reshape(-1, A), objs.reshape(-1), valid.reshape(-1)
    keep = flat_valid > 0
    _, _, r_changed, _ = ref_swap(random.Random(0), matrix, flat_att[keep], flat_att[keep],
                                  flat_objs[keep], (np.arange(b * o) // o)[keep], b)
    gen = torch.Generator().manual_seed(0)
    got_att, got_est, n = attributes.swap_attributes(T(matrix), T(flat_att), T(flat_att),
                                                     T(flat_objs), T(flat_valid), b, o,
                                                     generator=gen)
    got_att, got_est = got_att.numpy(), got_est.numpy()
    changed = np.nonzero(keep)[0][r_changed]
    assert n == math.floor(b / 3)
    rows = np.nonzero((got_att != flat_att).any(-1))[0]
    np.testing.assert_array_equal(rows, np.sort(changed))
    for r in changed:
        new = np.nonzero(got_att[r])[0]
        w = matrix[flat_objs[r]] * (1 - flat_att[r])
        assert 1 <= len(new) <= 2 and (w[new] > 0).all()
        np.testing.assert_array_equal(got_est[r], got_att[r])


def test_swap_draws_follow_the_weights():
    """The port's categorical draw is proportional to the weights."""
    w = torch.tensor([[1.0, 3.0, 0.0, 4.0]]).expand(20000, 4)
    d1, d2, two = attributes.swap_draws(w, torch.Generator().manual_seed(1))
    freq = torch.bincount(torch.cat([d1, d2]), minlength=4).float() / 40000
    assert (freq - torch.tensor([0.125, 0.375, 0.0, 0.5])).abs().max() < 0.01
    assert abs(two.float().mean().item() - 0.5) < 0.02
