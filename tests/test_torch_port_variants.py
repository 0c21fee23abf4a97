"""The port's serving A/B kernels against the JAX kernels they replace: the
typed-c3 variants (`typed_c3_expand_v3`, `_v5`, `_v6`) and the compact and
transposed modes of `spade_few_out_conv`.

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
from aglayout_tpu.ops import pallas_typed_expand as jax_typed
from aglayout_tpu.ops.pallas_spade_conv import spade_few_out_conv as jax_spade_few_out_conv
from aglayout_tpu_torch.ops import typed_expand
from aglayout_tpu_torch.ops.spade_conv import (
    compact_to_flat,
    spade_few_out_conv,
    spade_few_out_conv_plain,
)
from torch_port_common import compact_tables_to_jax_flat, head_case, nchw, nhwc

torch.set_num_threads(1)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# variant -> (the JAX kernel, the port's wrapper, the port's plain version)
TYPED = {
    "v3": (jax_typed.typed_c3_expand, typed_expand.typed_c3_expand_v3,
           typed_expand.typed_c3_expand_v3_plain),
    "v5": (jax_typed.typed_c3_expand_v5, typed_expand.typed_c3_expand_v5,
           typed_expand.typed_c3_expand_v5_plain),
    "v6": (jax_typed.typed_c3_expand_v6, typed_expand.typed_c3_expand_v6,
           typed_expand.typed_c3_expand_v6_plain),
}


def _typed_inputs(variant, n, s3, c2, c4, seed, wscale=0.05):
    """numpy inputs over the kernel's whole domain: v3 takes the grid
    zero-padded to 13 x 13; idxR == 12 and lsel >= 12 (v3: lsel == 13, and
    the zero row and column 12) are the taps outside the image."""
    rng = np.random.RandomState(seed)
    z2 = rng.randn(n, 12, 12, c2).astype(np.float32)
    if variant == "v3":
        z2 = np.pad(z2, ((0, 0), (0, 1), (0, 1), (0, 0)))
    idxR = rng.randint(0, 13, (n, 14, 4)).astype(np.int32)
    lsel = rng.randint(0, 14, (n, 14, 4)).astype(np.int32)
    selR = rng.randint(0, 14, (n, s3)).astype(np.int32)
    selC = rng.randint(0, 14, (n, s3)).astype(np.int32)
    ab = (rng.randn(n, 2, c4) * 0.5).astype(np.float32)
    w3 = (rng.randn(4, 4, c2, c4) * wscale).astype(np.float32)  # JAX HWIO
    return z2, (idxR, lsel, selR, selC), ab, w3


def _run_both(variant, z2, ints, ab, w3, jdt, tdt, group):
    jax_fn, wrapper, _ = TYPED[variant]
    c2, c4 = w3.shape[2:]
    w3t = w3.transpose(0, 2, 1, 3).reshape(4 * c2, 4 * c4)
    want = jax_fn(jnp.asarray(z2, jdt), *map(jnp.asarray, ints), jnp.asarray(ab),
                  jnp.asarray(w3t), interpret=True, group=group)
    got = wrapper(torch.from_numpy(z2).to(tdt), *map(torch.from_numpy, ints),
                  torch.from_numpy(ab), torch.from_numpy(w3).permute(3, 2, 0, 1))  # CPU: plain
    return got, np.asarray(want, np.float32)


# the shapes of tests/test_pallas_typed_expand.py
@pytest.mark.parametrize("n,s3,c2,c4,group", [(8, 32, 128, 256, 8), (6, 16, 128, 256, 4)])
@pytest.mark.parametrize("variant", sorted(TYPED))
def test_typed_variant_plain_matches_jax_kernel(variant, n, s3, c2, c4, group):
    """Each variant's plain version == its JAX kernel (interpret=True), f32."""
    z2, ints, ab, w3 = _typed_inputs(variant, n, s3, c2, c4, seed=0)
    got, want = _run_both(variant, z2, ints, ab, w3, *DT["f32"], group)
    assert got.shape == (n, c4, s3, s3)
    # f32; one-hot matmuls vs gathers: re-association of a 512-term sum of O(1)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(TYPED))
def test_typed_variant_plain_bf16_rounds_like_jax(variant):
    """In bf16 every variant rounds W3z and V3 to bf16, in both packages;
    the two differ by flipped roundings only."""
    n, s3, c2, c4 = 4, 16, 32, 64
    z2, ints, ab, w3 = _typed_inputs(variant, n, s3, c2, c4, seed=2, wscale=0.1)
    got, want = _run_both(variant, z2, ints, ab, w3, *DT["bf16"], 4)
    assert got.dtype == torch.bfloat16
    # two bf16 roundings (W3z, V3) that summation order can flip: a few ulps
    # (2^-8 relative) of the output scale
    np.testing.assert_allclose(nhwc(got), want, atol=2e-2 * np.abs(want).max(), rtol=0)


def test_typed_v3_reads_the_padded_grid():
    """v3's plain version reads the grid's row and column 12: with them
    zero it equals v4's on the inner grid with the same windows, and a
    non-zero row 12 shows in the output wherever idxR names it."""
    n, s3, c2, c4 = 3, 8, 16, 8
    z2p, ints, ab, w3 = _typed_inputs("v3", n, s3, c2, c4, seed=3)
    args = [torch.from_numpy(a) for a in ints]
    ab, weight = torch.from_numpy(ab), torch.from_numpy(w3).permute(3, 2, 0, 1)
    z2p = torch.from_numpy(z2p)
    v3 = typed_expand.typed_c3_expand_v3_plain(z2p, *args, ab, weight)
    v4 = typed_expand.typed_c3_expand_plain(z2p[:, :12, :12].contiguous(), *args, ab, weight)
    assert torch.equal(v3, v4)
    z2p[:, 12] = 1.0
    assert not torch.equal(typed_expand.typed_c3_expand_v3_plain(z2p, *args, ab, weight), v4)


def test_v5_and_v6_share_v4s_function():
    """v5 and v6 are schedules of v4's function: on the CPU all three
    wrappers give the same tensor, and `VARIANTS` names them."""
    z2, ints, ab, w3 = _typed_inputs("v5", 3, 8, 16, 8, seed=4)
    args = (torch.from_numpy(z2), *map(torch.from_numpy, ints), torch.from_numpy(ab),
            torch.from_numpy(w3).permute(3, 2, 0, 1))
    want = typed_expand.typed_c3_expand(*args)
    assert sorted(typed_expand.VARIANTS) == ["v4", "v5", "v6"]
    for name, fn in typed_expand.VARIANTS.items():
        assert torch.equal(fn(*args), want), name


def test_compact_flat_tables_match_jax():
    """JAX's `folded_affine_tables_compact_flat` is the port's compact table
    under `compact_tables_to_jax_flat`."""
    f = 16
    spade, jspade, variables, seg, *_ = head_case(2, 4, 128, f, 7, seed=5)
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f,
                          method=JaxSPADE.folded_affine_tables_compact_flat)
    with torch.no_grad():
        ta, tb = spade.folded_affine_tables_compact(nchw(seg))
    assert ja.shape == (2, 20, 4, 5, 128) and ta.shape == (2, 4, 5, 128, 20)
    for want, got in ((ja, ta), (jb, tb)):
        # f32, the same einsum/conv algebra; summation order only
        np.testing.assert_allclose(compact_tables_to_jax_flat(got).numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


# the third shape of tests/test_pallas_spade_conv.py::test_fused_head_matches_dense
# (f=16 on a 4x4 seg, K=5), and the c7 head's width at a 4x4 seg
@pytest.mark.parametrize("b,hs,c,f,k", [(1, 4, 128, 16, 5), (2, 4, 128, 16, 7)])
def test_head_compact_plain_matches_jax_kernel(b, hs, c, f, k):
    """The port's plain compact mode == spade_few_out_conv(compact=True,
    interpret=True), each fed its own package's compact tables, f32."""
    spade, jspade, variables, seg, x, kern, bias = head_case(b, hs, c, f, k, seed=6)
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f,
                          method=JaxSPADE.folded_affine_tables_compact_flat)
    want = jax_spade_few_out_conv(jnp.asarray(x), ja, jb, jnp.asarray(kern), jnp.asarray(bias),
                                  f=f, interpret=True, compact=True)
    with torch.no_grad():
        ta, tb = spade.folded_affine_tables_compact(nchw(seg))
        weight = torch.from_numpy(kern).permute(3, 2, 0, 1)
        got = spade_few_out_conv(nchw(x), ta, tb, weight, torch.from_numpy(bias), f, compact=True)
    assert got.shape == (b, 3, hs * f, hs * f)
    # f32; kn2row matmul vs direct conv: re-association of a C*K*K-term sum
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_transposed_plain_matches_jax_kernel(dt):
    """The port's plain transposed mode == spade_few_out_conv(transposed=
    True, interpret=True): x laid out (H, W, B, C) in both, flat tables."""
    jdt, tdt = DT[dt]
    b, hs, c, f, k = 2, 4, 128, 16, 5
    spade, jspade, variables, seg, x, kern, bias = head_case(b, hs, c, f, k, seed=7)
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f, method=JaxSPADE.folded_affine_tables)
    x_t = np.ascontiguousarray(x.transpose(1, 2, 0, 3))
    want = jax_spade_few_out_conv(jnp.asarray(x_t, jdt), ja.astype(jdt), jb.astype(jdt),
                                  jnp.asarray(kern), jnp.asarray(bias), f=f, interpret=True,
                                  transposed=True)
    with torch.no_grad():
        ta, tb = (t.to(tdt) for t in spade.folded_affine_tables(nchw(seg), f))
        weight = torch.from_numpy(kern).permute(3, 2, 0, 1)
        got = spade_few_out_conv(torch.from_numpy(x_t).to(tdt), ta, tb, weight,
                                 torch.from_numpy(bias), f, transposed=True)
    want = np.asarray(want, np.float32)
    assert got.shape == (b, 3, hs * f, hs * f) and got.dtype == tdt
    if dt == "f32":  # kn2row matmul vs direct conv: re-association
        np.testing.assert_allclose(nhwc(got), want, atol=5e-4, rtol=1e-4)
    else:
        # the Pallas kernel rounds its kn2row products z to bf16 before the
        # tap sum (K*K roundings an output), the port sums in f32 and rounds
        # once: a few bf16 ulps (2^-8 relative) of the output scale
        np.testing.assert_allclose(nhwc(got), want, atol=3e-2 * np.abs(want).max(), rtol=0)


def test_head_modes_agree_on_the_cpu():
    """The three modes are one function: compact tables expanded, or x
    transposed, give the flat-mode tensor bit for bit; both flags together
    are refused."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 4, 16, 16).astype(np.float32))
    ca, cb = (torch.from_numpy(rng.randn(2, 2, 5, 4, 10).astype(np.float32)) for _ in range(2))
    weight = torch.from_numpy(rng.randn(3, 4, 3, 3).astype(np.float32))
    fa, fb = compact_to_flat(ca, 8), compact_to_flat(cb, 8)
    flat = spade_few_out_conv(x, fa, fb, weight, None, 8)
    assert torch.equal(spade_few_out_conv(x, ca, cb, weight, None, 8, compact=True), flat)
    x_t = x.permute(2, 3, 0, 1).contiguous()
    assert torch.equal(spade_few_out_conv(x_t, fa, fb, weight, None, 8, transposed=True), flat)
    for fn in (spade_few_out_conv, spade_few_out_conv_plain):
        with pytest.raises(ValueError, match="not supported"):
            fn(x_t, ca, cb, weight, None, 8, compact=True, transposed=True)


@pytest.mark.parametrize("variant", sorted(TYPED))
def test_typed_variant_wrappers_reject_other_devices(variant):
    """A wrapper takes its plain version only for CPU tensors."""
    h = torch.zeros(1, 16, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TYPED[variant][1](h, h, h, h, h, h, h)


@pytest.mark.parametrize("kw", [{"compact": True}, {"transposed": True}])
def test_head_modes_reject_other_devices(kw):
    h = torch.zeros(1, 16, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        spade_few_out_conv(h, h, h, h, None, 16, **kw)
