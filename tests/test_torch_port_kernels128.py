"""The port's 128^2 kernel modules (K4 `spade_apply8`, K5
`typed_c3_expand`, and the compact SPADE tables K3 and K4 read) against
the JAX kernels they replace; K3 is in `test_torch_port_head8.py`.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the JAX Pallas kernel run in interpret mode, at the
shapes of the JAX package's own kernel tests, with the same numpy inputs.
The CUDA kernels themselves are held against the plain versions on the card
(`test_torch_port_gpu.py` and `chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.ops.pallas_spade_conv import spade_apply8 as jax_spade_apply8
from aglayout_tpu.ops.pallas_typed_expand import typed_c3_expand_v4 as jax_typed_c3_expand_v4
from aglayout_tpu_torch.ops.spade_conv import (
    compact_to_flat,
    spade_apply8,
    spade_few_out_conv8,
)
from aglayout_tpu_torch.ops.typed_expand import (
    typed_c3_expand,
    typed_c3_expand_plain,
    typed_c3_inputs_from_windows,
)
from torch_port_common import nchw, nhwc, spade_pair

torch.set_num_threads(1)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_compact_to_port(t):
    """JAX compact table (B/8, h, 5, w*5, 8, C) -> the port's (B, h, 5, C, w*5)."""
    g, h, _, w5, _, c = t.shape
    return np.asarray(t, np.float32).transpose(0, 4, 1, 2, 5, 3).reshape(g * 8, h, 5, c, w5)


def _compact_case(b, hs, c, seed):
    """A seeded SPADE in both packages and a (b, hs, hs, 64) segmap."""
    spade, jspade, variables = spade_pair(c, 64, seed)
    seg = np.random.RandomState(seed).randn(b, hs, hs, 64).astype(np.float32)
    return spade, jspade, variables, seg


def test_compact_tables_match_jax():
    """SPADE.folded_affine_tables_compact of both packages: the same class
    tables after the layout permutation, and the port's flat tables are
    the compact ones with their columns expanded."""
    f = 16
    spade, jspade, variables, seg = _compact_case(8, 4, 16, seed=0)
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f,
                          method=JaxSPADE.folded_affine_tables_compact)
    with torch.no_grad():
        ta, tb = spade.folded_affine_tables_compact(nchw(seg))
        fa, fb = spade.folded_affine_tables(nchw(seg), f)
    assert ta.shape == (8, 4, 5, 16, 20)
    for want, got in ((ja, ta), (jb, tb)):
        # f32, the same einsum/conv algebra; summation order only
        np.testing.assert_allclose(got.numpy(), _jax_compact_to_port(want), atol=1e-6, rtol=1e-6)
    for flat, compact in ((fa, ta), (fb, tb)):
        assert torch.equal(flat, compact_to_flat(compact, f))


# the shapes of tests/test_pallas_typed_expand.py
@pytest.mark.parametrize("n,s3,c2,c4,group", [(8, 32, 128, 256, 8), (6, 16, 128, 256, 4)])
def test_typed_expand_plain_matches_jax_kernel(n, s3, c2, c4, group):
    """typed_c3_expand_plain == typed_c3_expand_v4(interpret=True), f32,
    over the kernel's whole input domain (idxR == 12 and lsel >= 12 are
    the zero taps)."""
    rng = np.random.RandomState(0)
    z2 = rng.randn(n, 12, 12, c2).astype(np.float32)
    idxR = rng.randint(0, 13, (n, 14, 4)).astype(np.int32)
    lsel = rng.randint(0, 14, (n, 14, 4)).astype(np.int32)
    selR = rng.randint(0, 14, (n, s3)).astype(np.int32)
    selC = rng.randint(0, 14, (n, s3)).astype(np.int32)
    ab = (rng.randn(n, 2, c4) * 0.5).astype(np.float32)
    w3 = (rng.randn(4, 4, c2, c4) * 0.05).astype(np.float32)  # JAX HWIO
    w3t = w3.transpose(0, 2, 1, 3).reshape(4 * c2, 4 * c4)
    want = jax_typed_c3_expand_v4(*map(jnp.asarray, (z2, idxR, lsel, selR, selC, ab, w3t)),
                                  interpret=True, group=group)
    args = [torch.from_numpy(a) for a in (z2, idxR, lsel, selR, selC, ab)]
    weight = torch.from_numpy(w3).permute(3, 2, 0, 1)  # (c4, c2, 4, 4)
    got = typed_c3_expand(*args, weight)  # a CPU tensor: the plain version
    assert got.shape == (n, c4, s3, s3)
    # f32; one-hot matmuls vs gathers: re-association of a 512-term sum of O(1)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_typed_inputs_adapter_matches_jax():
    """typed_c3_inputs_from_windows of both packages: the same int32 arrays."""
    from aglayout_tpu.ops.pallas_typed_expand import typed_c3_inputs_from_windows as jax_adapter

    rng = np.random.RandomState(1)
    arrays = (rng.randint(0, 13, (5, 14, 4)), rng.randint(0, 14, (5, 14, 4)),
              rng.randint(0, 14, (5, 16)), rng.randint(0, 14, (5, 16)))
    want = jax_adapter(*map(jnp.asarray, arrays))
    got = typed_c3_inputs_from_windows(*map(torch.from_numpy, arrays))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_typed_expand_plain_bf16_rounds_like_jax():
    """In bf16 the plain version rounds W3z and V3 to bf16 as the Pallas
    kernel does; the two differ by flipped roundings only."""
    jdt, tdt = DT["bf16"]
    rng = np.random.RandomState(2)
    n, s3, c2, c4 = 4, 16, 32, 64
    z2 = rng.randn(n, 12, 12, c2).astype(np.float32)
    ints = (rng.randint(0, 13, (n, 14, 4)), rng.randint(0, 14, (n, 14, 4)),
            rng.randint(0, 14, (n, s3)), rng.randint(0, 14, (n, s3)))
    ints = [a.astype(np.int32) for a in ints]
    ab = (rng.randn(n, 2, c4) * 0.5).astype(np.float32)
    w3 = (rng.randn(4, 4, c2, c4) * 0.1).astype(np.float32)
    w3t = w3.transpose(0, 2, 1, 3).reshape(4 * c2, 4 * c4)
    want = jax_typed_c3_expand_v4(jnp.asarray(z2, jdt), *map(jnp.asarray, ints), jnp.asarray(ab),
                                  jnp.asarray(w3t), interpret=True, group=4)
    got = typed_c3_expand(torch.from_numpy(z2).to(tdt), *map(torch.from_numpy, ints),
                          torch.from_numpy(ab), torch.from_numpy(w3).permute(3, 2, 0, 1))
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    # two bf16 roundings (W3z, V3) that summation order can flip: a few ulps
    # (2^-8 relative) of the output scale
    np.testing.assert_allclose(nhwc(got), want, atol=2e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply8_plain_matches_jax_kernel(dt):
    """The port's plain SPADE-4 apply == spade_apply8(interpret=True) at
    tests/test_pallas_spade_conv.py::test_spade_apply8_matches_dense's
    shape, each fed its own package's compact tables."""
    jdt, tdt = DT[dt]
    b, hs, c, f = 8, 8, 128, 16
    spade, jspade, variables, seg = _compact_case(b, hs, c, seed=4)
    x = np.random.RandomState(5).randn(b, hs * f, hs * f, c).astype(np.float32)
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f,
                          method=JaxSPADE.folded_affine_tables_compact)
    x_t = jnp.transpose(jnp.asarray(x, jdt), (1, 2, 0, 3))
    want = np.asarray(jax_spade_apply8(x_t, ja.astype(jdt), jb.astype(jdt), f=f, interpret=True),
                      np.float32).transpose(2, 0, 1, 3)
    with torch.no_grad():
        ta, tb = (t.to(tdt) for t in spade.folded_affine_tables_compact(nchw(seg)))
        got = spade_apply8(nchw(x).to(tdt), ta, tb, f)
    assert got.dtype == tdt and got.shape == (b, c, hs * f, hs * f)
    if dt == "f32":  # the same products and sums: the tables' summation order only
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5, rtol=1e-5)
    else:
        # the Pallas kernel rounds x * A to bf16 before it adds B; the port
        # applies in f32 and rounds once: at most one bf16 ulp (2^-8
        # relative) of |x * A| apart, and |x * A| < 4 max|out| here
        np.testing.assert_allclose(nhwc(got), want, atol=4 * 2 ** -8 * np.abs(want).max(), rtol=0)


def test_new_wrappers_reject_other_devices():
    """A wrapper takes its plain version only for CPU tensors."""
    h = torch.zeros(1, 16, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        spade_few_out_conv8(h, h, h, h, None, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        spade_apply8(h, h, h, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        typed_c3_expand(h, h, h, h, h, h, h)


def test_typed_expand_plain_ignores_out_of_bounds_taps():
    """idxR == 12 and lsel >= 12 contribute zero: with every tap out of
    bounds, the output is relu(b3) everywhere."""
    n, c2, c4, s3 = 2, 16, 8, 8
    z2 = torch.randn(n, 12, 12, c2)
    ab = torch.randn(n, 2, c4)
    full = lambda v, shape: torch.full(shape, v, dtype=torch.int32)  # noqa: E731
    sel = torch.randint(0, 14, (n, s3), dtype=torch.int32)
    out = typed_c3_expand_plain(z2, full(12, (n, 14, 4)), full(13, (n, 14, 4)), sel, sel, ab,
                                torch.randn(c4, c2, 4, 4))
    want = torch.relu(ab[:, 1])[:, :, None, None].expand(n, c4, s3, s3)
    assert torch.equal(out, want)
