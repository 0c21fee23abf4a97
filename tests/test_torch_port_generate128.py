"""The 128^2 slice end to end: the port's eval `Generator.generate` at
128^2 against JAX `Generator.generate` with every Pallas flag off (the
typed XLA fallback, the c4 fold and the dense heads), from the same weights
and layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.generator import Generator
from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.models import build_generator
from aglayout_tpu_torch.ops.spade_conv import spade_apply8, spade_few_out_conv8
from aglayout_tpu_torch.ops.typed_expand import typed_c3_expand
from torch_port_common import generator_pair, layouts

torch.set_num_threads(1)


# f32: the same algebra at every step, summation order only (outputs are
# O(0.1)); bf16: both frameworks compute in bf16 but round at different
# places (einsum and conv accumulation, 1 + gamma, the typed V3 affine), and
# those differences carry through some 25 bf16 layers: a few bf16 ulps
# (2^-8 relative) of the output scale, as at 64^2.
@pytest.mark.parametrize("dtype,atol", [(None, 1e-5), ("bf16", 3e-2)])
def test_generate128_matches_jax(dtype, atol):
    jm, v, tm = generator_pair(seed=0, dtype=dtype, image_size=128)
    ins = layouts(2, 4, seed=0)
    want = jm.apply(v, *map(jnp.asarray, ins), None, False, method=Generator.generate)
    objs, *rest = ins
    got = tm.generate(torch.from_numpy(objs.astype(np.int64)), *map(torch.from_numpy, rest))
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == (2, 128, 128, 3) and want.shape == got.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol * np.abs(want).max(), rtol=0)


def test_kernel_switches_leave_cpu_path_alone_128():
    """The 128^2 kernel switches act only on CUDA tensors: on the CPU, on
    and off run the same plain path and never count a launch."""
    cfg = config_for(128, conv_dim=8, z_dim=8, embedding_dim=8, attribute_dim=12,
                     clstm_layers=2, resi_num=2, num_classes=23)
    ins = layouts(2, 3, seed=7)
    tensors = [torch.from_numpy(ins[0].astype(np.int64))] + [torch.from_numpy(a) for a in ins[1:]]
    kernels = (typed_c3_expand, spade_apply8, spade_few_out_conv8)
    before = [k.launches for k in kernels]
    on = build_generator(cfg, "cpu", seed=7).generate(*tensors)
    cfg.use_typed_kernel = cfg.use_apply_kernel = cfg.use_head8_kernel = False
    off = build_generator(cfg, "cpu", seed=7).generate(*tensors)
    assert on.shape == (2, 128, 128, 3)
    assert torch.equal(on, off)
    assert [k.launches for k in kernels] == before


@pytest.mark.slow
def test_generate128_full_width_matches_jax():
    """conv_dim=64, 3 ConvLSTM layers, 6 residual blocks, f32, at 128^2."""
    jm, v, tm = generator_pair(seed=0, image_size=128, conv_dim=64, z_dim=64, embedding_dim=64,
                               attribute_dim=106, clstm_layers=3, resi_num=6)
    ins = layouts(2, 3, jm.z_dim, jm.attribute_dim, seed=0)
    want = np.asarray(jm.apply(v, *map(jnp.asarray, ins), None, False, method=Generator.generate))
    objs, *rest = ins
    got = tm.generate(torch.from_numpy(objs.astype(np.int64)), *map(torch.from_numpy, rest)).numpy()
    assert got.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
