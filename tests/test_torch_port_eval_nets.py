"""The port's evaluation networks against the JAX package's on the same
weights and inputs, on the CPU, f32:

  * InceptionV3 (`eval/inception.py`) with seeded He-normal convs and
    randomised BN statistics (`chip_smoke.seeded_inception`, whose pool3
    and logits depend on the input: the two images' differ by more than
    ten times the bound): the port's `state_dict`, through `torch.save`,
    is JAX's `load_torch_weights` input; pool3 and logits on a 147^2 input
    in both `fid_variant` settings within 2e-3 of JAX's max |.| (the bound
    of `tests/test_inception.py`; measured 6.7e-7 and 6.5e-7 without the
    variant, 2.1e-6 and 7.6e-7 with it); `preprocess` equal to JAX's where
    it enlarges (64^2 and 128^2 -> 299^2);
  * LPIPS: the random pyramid's `perceptual_distance` (the same
    `RandomState` weights) and AlexNet `lpips_alex` (the port's `features`
    `state_dict` through JAX's `load_alexnet_lpips`, the heads under both
    key spellings) within 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.eval import inception as jax_inception
from aglayout_tpu.eval import lpips as jax_lpips
from aglayout_tpu_torch.eval import inception, lpips
from chip_smoke import seeded_inception

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def inception_weights(tmp_path_factory):
    """A seeded InceptionV3's state_dict saved as a .pth, plus an AuxLogits
    key as torchvision files carry."""
    sd = dict(seeded_inception(0).state_dict())
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    path = str(tmp_path_factory.mktemp("inception") / "incv3.pth")
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("fid_variant", [False, True])
def test_inception_matches_jax(inception_weights, fid_variant):
    x = np.random.RandomState(0).rand(2, 147, 147, 3).astype(np.float32) * 2 - 1
    model = inception.load_inception(inception_weights, fid_variant, device="cpu")
    with torch.inference_mode():
        p3, logits = model(torch.from_numpy(x).permute(0, 3, 1, 2), True)
    variables = jax_inception.load_torch_weights(inception_weights)
    jp3, jlogits = jax_inception.InceptionV3(fid_variant=fid_variant).apply(
        variables, jnp.asarray(x), return_logits=True)
    assert p3.shape == (2, 2048) and logits.shape == (2, 1000)
    # the outputs depend on the input: a match says something of the convs
    # and the pools (measured 4.1e-2 and 3.6e-2 without the variant, 8.0e-2
    # and 3.5e-2 with it)
    assert _rel(p3[0], p3[1]) > 2e-2 and _rel(logits[0], logits[1]) > 2e-2
    assert _rel(p3, jp3) <= 2e-3 and _rel(logits, jlogits) <= 2e-3, (_rel(p3, jp3),
                                                                      _rel(logits, jlogits))


@pytest.mark.parametrize("size", [64, 128])
def test_preprocess_matches_jax_when_enlarging(size):
    imgs = np.random.RandomState(size).randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    got = inception.preprocess(imgs, device="cpu").permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax_inception.preprocess(imgs))
    assert got.shape == want.shape == (2, 299, 299, 3)
    assert np.abs(got - want).max() <= 1e-5


def test_extractor_features_and_logits(inception_weights):
    """The extractor's batches: pool3 and logits of the images in chunks
    equal the whole batch's."""
    imgs = np.random.RandomState(2).randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    ext = inception.InceptionExtractor(inception_weights, device="cpu")
    feats, logits = ext(imgs, batch_size=2), ext.logits(imgs, batch_size=2)
    assert feats.shape == (3, 2048) and logits.shape == (3, 1000)
    with torch.inference_mode():
        p3, lg = ext.model(inception.preprocess(imgs, device="cpu"), True)
    assert _rel(feats, p3.numpy()) <= 1e-5 and _rel(logits, lg.numpy()) <= 1e-5


def test_perceptual_distance_matches_jax():
    rng = np.random.RandomState(5)
    x, y = (rng.rand(3, 32, 32, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    for seed in (0, 3):
        got = lpips.perceptual_distance(torch.from_numpy(x), torch.from_numpy(y),
                                        lpips._random_pyramid_params(seed, device="cpu"))
        want = jax_lpips.perceptual_distance(jnp.asarray(x), jnp.asarray(y),
                                             jax_lpips._random_pyramid_params(seed))
        assert got.shape == (3,) and _rel(got, want) <= 1e-5
    assert _rel(lpips.perceptual_distance(torch.from_numpy(x), torch.from_numpy(y)),
                jax_lpips.perceptual_distance(jnp.asarray(x), jnp.asarray(y))) <= 1e-5


@pytest.mark.parametrize("head_key", ["lin{i}.model.1.weight", "lins.{i}.model.1.weight"])
def test_lpips_alex_matches_jax(tmp_path, head_key):
    torch.manual_seed(0)
    net = lpips.AlexNetFeatures()
    # a full torchvision AlexNet file: its classifier keys are not the
    # features' and are left out on loading
    sd = dict(net.state_dict(), **{"classifier.1.weight": torch.zeros(4096, 9216)})
    couts = [64, 192, 384, 256, 256]
    lsd = {head_key.format(i=i): torch.rand(1, c, 1, 1) for i, c in enumerate(couts)}
    apath, lpath = str(tmp_path / "alex.pth"), str(tmp_path / "lpips.pth")
    torch.save(sd, apath)
    torch.save(lsd, lpath)

    rng = np.random.RandomState(0)
    x, y = (rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    tnet, lins = lpips.load_alexnet_lpips(apath, lpath, device="cpu")
    with torch.inference_mode():
        got = lpips.lpips_alex(torch.from_numpy(x), torch.from_numpy(y), tnet, lins)
    convs, jlins = jax_lpips.load_alexnet_lpips(apath, lpath)
    want = jax_lpips.lpips_alex(jnp.asarray(x), jnp.asarray(y), convs, jlins)
    assert got.shape == (2,) and _rel(got, want) <= 1e-5


def test_lpips_needs_both_weight_files(tmp_path):
    with pytest.raises(ValueError, match="BOTH"):
        lpips.distance_fn(alexnet_weights=str(tmp_path / "alex.pth"), device="cpu")
