"""The port's kernel modules against the JAX kernels they replace.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the JAX Pallas kernel run in interpret mode, with the
same numpy inputs. The CUDA kernels themselves are held against the plain
versions on the card (`test_torch_port_gpu.py` and `chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.ops.pallas_resblocks import residual_trunk as jax_residual_trunk
from aglayout_tpu.ops.pallas_spade_conv import spade_few_out_conv as jax_spade_few_out_conv
from aglayout_tpu_torch.models.generator import init_weights
from aglayout_tpu_torch.models.layers import ResidualBlock
from aglayout_tpu_torch.ops.resblocks import residual_trunk, residual_trunk_plain
from aglayout_tpu_torch.ops.spade_conv import spade_few_out_conv, spade_few_out_conv_plain
from torch_port_common import nchw, nhwc, spade_pair

torch.set_num_threads(1)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _trunk_inputs(b, c, r, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(b, 8, 8, c).astype(np.float32)
    w1 = (rng.randn(r, 3, 3, c, c) * 0.1).astype(np.float32)  # JAX HWIO per block
    w2 = (rng.randn(r, 3, 3, c, c) * 0.1).astype(np.float32)
    ab1 = (rng.randn(r, 2, c) * 0.5).astype(np.float32)
    ab2 = (rng.randn(r, 2, c) * 0.5).astype(np.float32)
    return h, w1, w2, ab1, ab2


def _torch_trunk_args(h, w1, w2, ab1, ab2, tdt):
    hwio_to_oihw = lambda w: torch.from_numpy(w).permute(0, 4, 3, 1, 2)  # noqa: E731
    return (nchw(h).to(tdt), hwio_to_oihw(w1), hwio_to_oihw(w2),
            torch.from_numpy(ab1), torch.from_numpy(ab2))


# the parameters of tests/test_pallas_resblocks.py
@pytest.mark.parametrize("b,c,r,dt", [(8, 64, 6, "f32"), (16, 64, 3, "bf16")])
def test_trunk_plain_matches_jax_kernel(b, c, r, dt):
    jdt, tdt = DT[dt]
    h, w1, w2, ab1, ab2 = _trunk_inputs(b, c, r)
    want = jax_residual_trunk(jnp.asarray(h, jdt), jnp.asarray(w1), jnp.asarray(w2),
                              jnp.asarray(ab1), jnp.asarray(ab2), interpret=True)
    got = residual_trunk_plain(*_torch_trunk_args(h, w1, w2, ab1, ab2, tdt))
    assert got.dtype == torch.float32
    # same rounding points on both sides (compute-dtype conv operands, f32
    # accumulation, f32 skip): f32 differs by summation order over 6 blocks
    # of O(40) values; bf16 by a flipped rounding of an intermediate
    tol = 1e-3 if dt == "f32" else 5e-2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_trunk_plain_matches_dense_blocks(dt):
    """The plain trunk == the port's dense ResidualBlock loop with each BN
    folded to its eval affine; in bf16 the dense loop rounds the skip
    chain to bf16 after each block, the trunk keeps it in f32."""
    _, tdt = DT[dt]
    c, r = 16, 2
    blocks = [ResidualBlock(c, dtype=tdt) for _ in range(r)]
    for i, blk in enumerate(blocks):
        init_weights(blk, torch.Generator().manual_seed(i)).eval()
    h = nchw(np.random.RandomState(3).randn(2, 8, 8, c)).to(tdt)
    x = h
    with torch.no_grad():
        for blk in blocks:
            x = blk(x)
        w1 = torch.stack([blk.main[0].weight for blk in blocks])
        w2 = torch.stack([blk.main[3].weight for blk in blocks])
        ab1 = torch.stack([torch.stack(blk.main[1].eval_affine()) for blk in blocks])
        ab2 = torch.stack([torch.stack(blk.main[4].eval_affine()) for blk in blocks])
        got = residual_trunk(h, w1, w2, ab1, ab2)  # a CPU tensor: the plain version
    assert x.dtype == tdt and got.dtype == torch.float32
    # f32: rounding only; bf16: the skip chain's per-block bf16 rounding
    tol = 1e-5 if dt == "f32" else 3e-2
    np.testing.assert_allclose(got.numpy(), x.float().numpy(), atol=tol, rtol=tol)


def _head_case(b=2, hs=8, f=8, c=8, seg_c=8, k=7, o=3, seed=0):
    rng = np.random.RandomState(seed)
    spade, jspade, variables = spade_pair(c, seg_c, seed)
    seg = rng.randn(b, hs, hs, seg_c).astype(np.float32)
    x = rng.randn(b, hs * f, hs * f, c).astype(np.float32)
    kern = (0.1 * rng.randn(k, k, c, o)).astype(np.float32)  # JAX HWIO
    bias = rng.randn(o).astype(np.float32)
    return spade, jspade, variables, seg, x, kern, bias


def test_folded_tables_match_jax():
    """SPADE.folded_affine_tables of both packages: the same row-class
    tables, the port's laid out (B, H/f, 5, C, W) for NCHW."""
    spade, jspade, variables, seg, *_ = _head_case()
    ja, jb = jspade.apply(variables, jnp.asarray(seg), 8, method=JaxSPADE.folded_affine_tables)
    with torch.no_grad():
        ta, tb = spade.folded_affine_tables(nchw(seg), 8)
    for want, got in ((ja, ta), (jb, tb)):
        # f32, same einsum/conv algebra; summation order only
        np.testing.assert_allclose(got.permute(0, 1, 2, 4, 3).numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_head_plain_matches_jax_kernel():
    """The port's plain head == spade_few_out_conv(interpret=True) at the
    c4 head's 64^2 shape (f=8), small C, each fed its own package's tables."""
    spade, jspade, variables, seg, x, kern, bias = _head_case()
    ja, jb = jspade.apply(variables, jnp.asarray(seg), 8, method=JaxSPADE.folded_affine_tables)
    want = jax_spade_few_out_conv(jnp.asarray(x), ja, jb, jnp.asarray(kern), jnp.asarray(bias),
                                  f=8, interpret=True)
    with torch.no_grad():
        ta, tb = spade.folded_affine_tables(nchw(seg), 8)
        weight = torch.from_numpy(kern).permute(3, 2, 0, 1)
        got = spade_few_out_conv(nchw(x), ta, tb, weight, torch.from_numpy(bias), 8)
    assert got.shape == (2, 3, 64, 64)
    # f32; kn2row matmul vs direct conv: re-association on O(10) outputs
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=5e-4, rtol=1e-4)


def test_wrappers_reject_other_devices():
    """A wrapper takes its plain version only for CPU tensors."""
    h = torch.zeros(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        residual_trunk(h, h, h, h, h)
    with pytest.raises(ValueError, match="unsupported device"):
        spade_few_out_conv(h, h, h, h, None, 8)
