"""The host side of the two kernels redesigned for the H100's tensor cores
(K3 `spade_few_out_conv8`, K5 `typed_c3_expand`): the operand packing, the
plain PyTorch version of K3's new schedule, and the lines that
`aglayout_tpu_torch.stage_times` cuts out of the sources.

The CUDA kernels run only on a card (`test_torch_port_gpu.py`,
`chip_smoke.py`); what surrounds them is Python and is held here, on the
CPU, against the plain versions and against the JAX kernel in interpret mode,
with the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.ops.pallas_spade_conv import spade_few_out_conv8 as jax_spade_few_out_conv8
from aglayout_tpu_torch import stage_times
from aglayout_tpu_torch.kernels import build
from aglayout_tpu_torch.ops.spade_conv import (
    head8_weight_matrix,
    pack_head8_weights,
    spade_few_out_conv8_plain,
    spade_few_out_conv8_shifted_plain,
    unpack_head8_weights,
)
from aglayout_tpu_torch.ops.typed_expand import pack_typed_c3_weights, unpack_typed_c3_weights
from torch_port_common import head_case, nchw, nhwc

torch.set_num_threads(1)


def _case(b, c, h, w, f, k, o, seed, bias=True):
    """x, compact tables, weight, bias from a numpy seed."""
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    x = t(b, c, h, w)
    a_tab = 1 + 0.3 * t(b, h // f, 5, c, w // f * 5)
    b_tab = 0.3 * t(b, h // f, 5, c, w // f * 5)
    return x, a_tab, b_tab, 0.1 * t(o, c, k, k), t(o) if bias else None


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# W = 24 and 40: not 128, and not a power of two; f = 8 and 5 (the smallest)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("o", [1, 3])
@pytest.mark.parametrize("k,w,f", [(3, 24, 8), (5, 40, 5), (7, 24, 8)])
def test_shifted_plain_matches_plain(k, w, f, o, bias):
    """The per-row-tap GEMM on the packed weights and the masked shifted sum
    compute the head's function: f32, so only the order of the sums differs."""
    h = 2 * f
    x, a_tab, b_tab, weight, bvec = _case(2, 16, h, w, f, k, o, seed=k * 10 + o, bias=bias)
    want = spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bvec, f)
    got = spade_few_out_conv8_shifted_plain(x, a_tab, b_tab, weight, bvec, f)
    assert got.shape == (2, o, h, w) and got.dtype == x.dtype
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("k", [3, 5, 7])
def test_shifted_plain_masks_the_columns_outside_the_image(k):
    """With y = x + 1 > 0 up to the border, a column tap that wrapped into the
    neighbouring row, or read the GEMM's row of a column outside, would show:
    the shifted version equals a zero-padded conv of y exactly at the
    border pixels too."""
    f, h, w, c, o = 8, 16, 16, 16, 3
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.rand(1, c, h, w).astype(np.float32)) + 2.0
    ones = torch.ones(1, h // f, 5, c, w // f * 5)
    weight = torch.from_numpy(rng.rand(o, c, k, k).astype(np.float32))  # all positive: nothing cancels
    got = spade_few_out_conv8_shifted_plain(x, ones, ones, weight, None, f)
    want = F.conv2d(x + 1.0, weight, padding=k // 2)
    border = torch.ones(h, w, dtype=torch.bool)
    border[k // 2:h - k // 2, k // 2:w - k // 2] = False
    assert (want[..., border] > 0).all()
    assert _rel(got[..., border], want[..., border]) <= 1e-5 and _rel(got, want) <= 1e-5


def test_shifted_plain_bf16_rounds_where_the_plain_version_rounds():
    """In bf16 both round y and the weights once and sum in f32: the two
    differ by the order of the f32 sums, which can flip the last rounding."""
    x, a_tab, b_tab, weight, bias = _case(2, 32, 16, 24, 8, 7, 3, seed=5)
    args = [t.to(torch.bfloat16) for t in (x, a_tab, b_tab)]
    want = spade_few_out_conv8_plain(*args, weight, bias, 8)
    got = spade_few_out_conv8_shifted_plain(*args, weight, bias, 8)
    assert got.dtype == torch.bfloat16 and _rel(got, want) <= 2 ** -7


# b = 8 and C = 128 are the JAX kernel's least; hs = 2 blocks of f = 8 rows
@pytest.mark.parametrize("k,o,bias", [(7, 3, True), (5, 3, False), (3, 1, True)])
def test_shifted_plain_matches_jax_kernel(k, o, bias):
    """spade_few_out_conv8_shifted_plain == JAX's spade_few_out_conv8 in
    interpret mode, each fed its own package's compact tables, f32."""
    b, hs, c, f = 8, 2, 128, 8
    spade, jspade, variables, seg, x, kern, bvec = head_case(b, hs, c, f, k, seed=7)
    kern, bvec = kern[..., :o], bvec[:o] if bias else None
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f,
                          method=JaxSPADE.folded_affine_tables_compact)
    want = jax_spade_few_out_conv8(jnp.transpose(jnp.asarray(x), (1, 2, 0, 3)), ja, jb,
                                   jnp.asarray(kern), None if bvec is None else jnp.asarray(bvec),
                                   f=f, interpret=True)
    with torch.no_grad():
        ta, tb = spade.folded_affine_tables_compact(nchw(seg))
        weight = torch.from_numpy(kern).permute(3, 2, 0, 1)
        got = spade_few_out_conv8_shifted_plain(
            nchw(x), ta, tb, weight, None if bvec is None else torch.from_numpy(bvec), f)
    want = np.asarray(want)
    assert got.shape == (b, o, hs * f, hs * f)
    # f32; two re-associations of a C K K-term sum
    assert np.abs(nhwc(got) - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("o,c,k", [(3, 128, 7), (1, 16, 3), (4, 32, 5), (4, 16, 7)])
def test_head8_weight_packing(o, c, k):
    """The packed K3 weights: shape, zero padding, the GEMM's matrix, the
    channel order inside a chunk, and the way back."""
    weight = torch.from_numpy(np.random.RandomState(o + c).randn(o, c, k, k).astype(np.float32))
    packed = pack_head8_weights(weight, torch.float32)
    cols = -(-k * o // 8) * 8
    assert packed.shape == (c // 16, k, cols, 16) and packed.is_contiguous()
    assert (packed[:, :, k * o:] == 0).all()  # the padding columns, exactly
    assert torch.equal(unpack_head8_weights(packed, o), weight)
    m = head8_weight_matrix(packed)
    assert m.shape == (k * c, cols)
    dy, ch, dx, oo = k - 1, c - 3, k // 2, o - 1
    assert m[dy * c + ch, dx * o + oo] == weight[oo, ch, dy, dx]
    order = [0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15]  # a lane's 4 values contiguous
    assert torch.equal(packed[0, 1, 2], m[c:c + 16, 2][order])
    rounded = pack_head8_weights(weight, torch.bfloat16)
    assert rounded.dtype == torch.bfloat16
    assert torch.equal(rounded.float(), pack_head8_weights(weight.bfloat16().float(), torch.float32))


@pytest.mark.parametrize("c4,c2", [(64, 32), (96, 48), (256, 128)])
def test_typed_c3_weight_packing(c4, c2):
    """The packed K5 weights against `weight`: [chunk][slice][32 w + ci][k]
    with k = h c2 + c, the 16-byte pieces of a row swizzled by the row."""
    rng = np.random.RandomState(c4)
    weight = torch.from_numpy(rng.randn(c4, c2, 4, 4).astype(np.float32))
    packed = pack_typed_c3_weights(weight, torch.float32)
    assert packed.shape == (c4 // 32, 4 * c2 // 64, 128, 64) and packed.is_contiguous()
    assert torch.equal(unpack_typed_c3_weights(packed), weight)
    for _ in range(200):
        ch, c, h, w = rng.randint(c4), rng.randint(c2), rng.randint(4), rng.randint(4)
        n, k = 32 * w + ch % 32, h * c2 + c
        piece, e = (k % 64) // 8, k % 8
        assert packed[ch // 32, k // 64, n, (piece ^ (n % 8)) * 8 + e] == weight[ch, c, h, w]
    # a row's pieces are a permutation of themselves: nothing lost, nothing doubled
    plain = weight.permute(0, 3, 2, 1).reshape(c4 // 32, 32, 4, 4 * c2 // 64, 64)
    plain = plain.permute(0, 3, 2, 1, 4).reshape(packed.shape)  # rows (w, ci), unswizzled
    assert torch.equal(packed.sort(-1).values, plain.sort(-1).values)
    assert pack_typed_c3_weights(weight, torch.bfloat16).dtype == torch.bfloat16


def test_packing_refuses_what_the_kernels_do_not_take():
    """The packing functions raise on a width the kernels' tiles do not
    divide, on the CPU as on the card."""
    with pytest.raises(ValueError, match="C % 16"):
        pack_head8_weights(torch.zeros(3, 24, 7, 7), torch.bfloat16)
    with pytest.raises(ValueError, match="c2 % 16"):
        pack_typed_c3_weights(torch.zeros(64, 24, 4, 4), torch.bfloat16)
    with pytest.raises(ValueError, match="c4 % 32"):
        pack_typed_c3_weights(torch.zeros(48, 32, 4, 4), torch.bfloat16)


def _variants():
    return [(kernel, name) for kernel, (_, _, _, cuts) in stage_times.VARIANTS.items()
            for name, _ in cuts]


@pytest.mark.parametrize("kernel,name", _variants())
def test_stage_variants_still_match_the_sources(kernel, name):
    """Every line that `stage_times` replaces to cut a stage out of a kernel
    is still in the shipped source it cuts (the FMA kernels the tensor-core
    ones replaced in bf16 still ship, for f32 and other shapes), the cut
    changes it, and the source compiled for the variant exports the kernel's
    function."""
    cut, compiled, fn, variants = stage_times.VARIANTS[kernel]
    repl = dict(variants)[name]
    if kernel in stage_times.EARLIER and not (build.CSRC / cut).exists():
        # a replaced kernel whose whole source is gone: timed whole, from an
        # earlier csrc/ (--csrc), through the C signature of that source
        assert not repl and cut == compiled and stage_times.EARLIER[kernel]
        return
    text = (build.CSRC / cut).read_text()
    assert f'extern "C" int {fn}(' in (build.CSRC / compiled).read_text() and fn in build.SIGNATURES
    assert cut == compiled or f'#include "{cut}"' in (build.CSRC / compiled).read_text()
    if kernel in stage_times.EARLIER:
        # a replaced kernel, cut in an earlier csrc/ (--csrc): its lines are
        # gone from the shipped source, whole-kernel aside
        if repl:
            with pytest.raises(ValueError, match="no longer has the line"):
                stage_times.patched(text, repl, name)
        return
    cut_text = stage_times.patched(text, repl, name)
    assert (cut_text == text) == (not repl)
    with pytest.raises(ValueError, match="no longer has the line"):
        stage_times.patched(text, [("a line that is not there", "")], name)
