"""The port's public surface against the JAX package's: `Config` field for
field, eval `Generator.generate` from explicit masks, and the mode in which
`SPADE` takes its class grid."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.config import Config as JaxConfig
from aglayout_tpu.config import config_for as jax_config_for
from aglayout_tpu.models.generator import Generator
from aglayout_tpu_torch.config import Config, config_for
from aglayout_tpu_torch.models.norms import SPADE
from torch_port_common import generator_pair, layouts, spade_pair

torch.set_num_threads(1)

# the JAX package's TPU knobs, which the port drops
TPU_ONLY = {"pallas_heads", "pallas_apply8", "pallas_compact_heads", "pallas_grouped_heads",
            "pallas_trunk", "phase_dc", "clstm_unroll"}
# the port's own: an on/off switch per Hopper kernel, and the choices between
# kernels of one function
PORT_ONLY = {"use_trunk_kernel", "use_head_kernel", "use_typed_kernel", "use_apply_kernel",
             "use_head8_kernel", "use_int8_kernel", "typed_c3", "use_compact_heads"}


def test_config_matches_jax_field_for_field():
    """Every JAX field but the TPU knobs is the port's, with JAX's default;
    a config written for JAX builds the port's and names the same run."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(Config)}
    assert set(jax_fields) - set(port_fields) == TPU_ONLY
    assert set(port_fields) - set(jax_fields) == PORT_ONLY
    assert {n: port_fields[n] for n in jax_fields if n in port_fields} == {
        n: d for n, d in jax_fields.items() if n not in TPU_ONLY}
    written = jax_config_for(128, batch_size=32, conv_dim=16, remat=True, resume="s",
                             lambda_kl=0.1, fast_decode=False, path="runs")
    kept = {n: getattr(written, n) for n in jax_fields if n not in TPU_ONLY}
    port = Config(**kept)
    assert dataclasses.asdict(port) == dict(dataclasses.asdict(config_for(128)), **kept)
    assert port.exp_name == written.exp_name and port.clstm_dims == written.clstm_dims


def _box_masks(boxes, size):
    """(B, O, size, size, 1) f32: 1 on the pixels whose centres lie in each
    normalized (x0, y0, x1, y1) box."""
    c = (np.arange(size) + 0.5) / size
    x0, y0, x1, y1 = (boxes[..., i, None] for i in range(4))
    rows = (c >= y0) & (c < y1)  # (B, O, size)
    cols = (c >= x0) & (c < x1)
    return (rows[..., :, None] & cols[..., None, :]).astype(np.float32)[..., None]


# f32: the same algebra at every step (the dense masks stage, then c4 and bn4
# at 64^2, the c4 fold at 128^2), summation order only
@pytest.mark.parametrize("size", [64, 128])
def test_generate_with_masks_matches_jax(size):
    jm, v, tm = generator_pair(seed=1, image_size=size)
    objs, boxes, valid, z, attr = layouts(2, 3, seed=5)
    masks = _box_masks(boxes, size)
    want = np.asarray(jm.apply(v, *map(jnp.asarray, (objs, boxes, valid, z, attr)),
                               jnp.asarray(masks), False, method=Generator.generate))
    tensors = [torch.from_numpy(objs.astype(np.int64))] + [torch.from_numpy(a) for a in
                                                           (boxes, valid, z, attr)]
    got = tm.generate(*tensors, masks=torch.from_numpy(masks)).numpy()
    assert got.shape == (2, size, size, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    # the masks, not the boxes, drive it: other masks move the image by ten
    # times the limit above
    other = tm.generate(*tensors, masks=torch.from_numpy(masks[:, ::-1].copy())).numpy()
    assert np.abs(other - got).max() > 1e-4 * np.abs(want).max()


def test_spade_takes_its_class_grid_in_eval_mode_only(monkeypatch):
    """In eval mode SPADE's gamma and beta come from the exact class grid; in
    train mode from the full-resolution convs, as in JAX. (The parameter-free
    BN stays in eval mode: its batch statistics come with the train slice.)"""
    spade, _, _ = spade_pair(8, 8, seed=2)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 8, 40, 40).astype(np.float32))
    seg = torch.from_numpy(rng.randn(2, 8, 8, 8).astype(np.float32))
    calls = []
    grid = SPADE._gamma_beta_fused
    monkeypatch.setattr(SPADE, "_gamma_beta_fused",
                        lambda self, *a: calls.append(self.training) or grid(self, *a))
    with torch.no_grad():
        grid_out = spade.eval()(x, seg)
        assert calls == [False]
        spade.train().param_free_norm.eval()
        out = spade(x, seg)
    assert calls == [False] and out.shape == x.shape
    assert torch.allclose(out, grid_out, atol=1e-5, rtol=0)  # the grid is exact: f32 order only
