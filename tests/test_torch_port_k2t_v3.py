"""The host side of K2's transposed mode (K2t) on the tensor-core head kernel
and of K5-v3 on K5's kernel.

The CUDA kernels run only on a card (`test_torch_port_gpu.py`,
`chip_smoke.py`). Here, on the CPU: K2t's route and its shared-memory
layout (which the card's build holds against the library's), the schedule
the tensor-core kernel runs for it (`spade_few_out_conv8_shifted_plain` on
the permuted x) and the plain transposed head, each against the JAX kernel
in interpret mode on the same numpy inputs; v3's predicate, now K5's limits
on the zero-padded grid, and its wrapper's contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.ops.pallas_spade_conv import spade_few_out_conv as jax_spade_few_out_conv
from aglayout_tpu_torch import stage_times
from aglayout_tpu_torch.kernels import build
from aglayout_tpu_torch.ops import typed_expand
from aglayout_tpu_torch.ops.spade_conv import (
    head_tc_layout,
    spade_few_out_conv,
    spade_few_out_conv8_shifted_plain,
    spade_few_out_conv_plain,
    spade_few_out_conv_route,
    spade_head_tc_supports,
)

torch.set_num_threads(1)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# max|err| / max|want|: f32 differs by the order of the sums; bf16 rounds
# intermediates on both sides, and an order difference can flip a rounding
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _aligned(n, dtype=torch.bfloat16, offset=0):
    """A flat tensor of n elements whose data starts `offset` elements past
    a 16-byte boundary."""
    base = torch.zeros(n + 16, dtype=dtype)
    skip = (-base.data_ptr() % 16) // base.element_size() + offset
    return base[skip:skip + n]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


# ---- K2t: the route and the layout


@pytest.mark.parametrize("c,h,w,f,dtype,want", [
    (16, 64, 64, 8, torch.bfloat16, "tc"),  # the small model's c4 head
    (64, 64, 64, 8, torch.bfloat16, "tc"),  # the c4 head
    (128, 64, 64, 8, torch.bfloat16, "tc"),
    (16, 128, 128, 16, torch.bfloat16, "tc"),
    (64, 128, 128, 16, torch.bfloat16, "tc"),
    (128, 128, 128, 16, torch.bfloat16, "tc"),  # the c7 head
    (128, 128, 128, 16, torch.float32, "fma"),  # f32: the reference path
    (64, 32, 32, 8, torch.bfloat16, "fma"),  # W not 64 or 128
    (24, 64, 64, 8, torch.bfloat16, "fma"),  # C % 16 (a whole 16-byte vector of C % 8 still)
    (64, 60, 64, 5, torch.bfloat16, "fma"),  # H % 8
    (64, 128, 128, 8, torch.bfloat16, "fma"),  # 11 table slots of 128 columns: over the limit
    (12, 64, 64, 8, torch.bfloat16, None),  # no 16-byte vector of channels for either kernel
])
def test_transposed_head_route(c, h, w, f, dtype, want):
    x = _aligned(h * w * 2 * c, dtype).view(h, w, 2, c)
    tab = _aligned(2 * (h // f) * 5 * c * w, dtype).view(2, h // f, 5, c, w)
    weight = torch.zeros(3, c, 7, 7)
    assert spade_few_out_conv_route(x, weight, f, transposed=True, tables=(tab, tab)) == want


def test_transposed_head_route_by_alignment_and_mode():
    """A misaligned table sends K2t to the FMA kernel (the tensor-core
    kernel's bulk copies want 16 bytes); a misaligned x has no kernel (the
    FMA kernel's vector loads want 16 bytes too, as the tensor map does);
    compact tables with a transposed x are no mode."""
    weight = torch.zeros(3, 64, 7, 7)
    x = _aligned(64 * 64 * 2 * 64).view(64, 64, 2, 64)
    tab = _aligned(2 * 8 * 5 * 64 * 64).view(2, 8, 5, 64, 64)
    shifted_tab = _aligned(2 * 8 * 5 * 64 * 64, offset=1).view(2, 8, 5, 64, 64)
    assert spade_few_out_conv_route(x, weight, 8, transposed=True, tables=(tab, tab)) == "tc"
    assert spade_few_out_conv_route(x, weight, 8, transposed=True,
                                    tables=(tab, shifted_tab)) == "fma"
    shifted = _aligned(64 * 64 * 2 * 64, offset=1).view(64, 64, 2, 64)
    assert spade_few_out_conv_route(shifted, weight, 8, transposed=True) is None
    assert spade_few_out_conv_route(x, weight, 8, compact=True, transposed=True) is None
    assert not spade_head_tc_supports(x, weight, 8, True, transposed=True)
    # the transposed x read as (B, C, H, W) is another shape: the flag decides
    assert spade_head_tc_supports(x, weight, 8, False, transposed=True)


@pytest.mark.parametrize("h,w,k,o,f,want", [
    # the c4 head: weights 10,752 B from 144, the x buffers from 11,264
    # (1024-aligned), 2 x 14 x 64 x 32 B, 4 tables of 11 slots x 16 x 64 x 2 B
    (64, 64, 7, 3, 8, 11264 + 2 * 14 * 64 * 32 + 4 * 11 * 16 * 64 * 2),
    # the c7 head: 6 slots of 128 columns; two x buffers fit (one did with
    # an NCHW x, whose y tile is a third buffer)
    (128, 128, 7, 3, 16, 11264 + 2 * 14 * 128 * 32 + 4 * 6 * 16 * 128 * 2),
    # K = 3, O = 1: 8 GEMM columns (weights 1,536 B, x buffers from 2,048);
    # the sums (8 x 128 x 9 x 4 B) are smaller than the operands
    (128, 128, 3, 1, 16, 2048 + 2 * 10 * 128 * 32 + 4 * 4 * 16 * 128 * 2),
])
def test_transposed_head_layout(h, w, k, o, f, want):
    assert head_tc_layout(h, w, k, o, f, False, transposed=True) == (2, want)
    assert want <= build.SMEM_LIMIT
    # an NCHW x keeps its own y tile beside the staging: at the c7 head only
    # one x buffer fits there
    assert head_tc_layout(h, w, k, o, f, False)[0] == (1 if (w, k) == (128, 7) else 2)


def test_transposed_head_layout_over_the_limit():
    """f = 8 at 128 columns: 11 table slots of 128 columns leave no room for
    two x buffers, and the transposed layout has no one-buffer form."""
    assert head_tc_layout(128, 128, 7, 3, 8, False, transposed=True)[1] > build.SMEM_LIMIT


# ---- K2t: the schedule and the plain version against JAX


def _head_inputs(rng, b, c, h, w, f, k, o):
    """x (H, W, B, C), flat tables in the port's (B, H/f, 5, C, W) layout,
    a JAX HWIO (K, K, C, O) kernel and a bias, as numpy."""
    x = rng.randn(h, w, b, c).astype(np.float32)
    a = (1 + 0.3 * rng.randn(b, h // f, 5, c, w)).astype(np.float32)
    bb = (0.3 * rng.randn(b, h // f, 5, c, w)).astype(np.float32)
    kern = (0.05 * rng.randn(k, k, c, o)).astype(np.float32)
    return x, a, bb, kern, rng.randn(o).astype(np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_transposed_plain_matches_jax_kernel(dt):
    """The port's transposed head (on the CPU its plain version) ==
    spade_few_out_conv(transposed=True, interpret=True) at C = 128 (the
    Pallas fold of (B, C) wants C % 128), H = W = 32, f = 8, K = 7, O = 3."""
    jdt, tdt = DT[dt]
    x, a, bb, kern, bias = _head_inputs(np.random.RandomState(40), 2, 128, 32, 32, 8, 7, 3)
    want = jax_spade_few_out_conv(
        jnp.asarray(x, jdt), jnp.asarray(a.transpose(0, 1, 2, 4, 3), jdt),
        jnp.asarray(bb.transpose(0, 1, 2, 4, 3), jdt), jnp.asarray(kern), jnp.asarray(bias),
        f=8, interpret=True, transposed=True)
    with torch.no_grad():
        got = spade_few_out_conv(torch.from_numpy(x).to(tdt), torch.from_numpy(a).to(tdt),
                                 torch.from_numpy(bb).to(tdt),
                                 torch.from_numpy(kern).permute(3, 2, 0, 1),
                                 torch.from_numpy(bias), 8, transposed=True)
    assert got.shape == (2, 3, 32, 32) and got.dtype == tdt
    assert _rel(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32)) < TOL[dt]


@pytest.mark.parametrize("k,o,f", [(7, 3, 8), (5, 4, 16), (3, 1, 8)])
def test_transposed_schedule_matches_plain(k, o, f):
    """What the tensor-core kernel computes for K2t: the flat-table schedule
    (`spade_few_out_conv8_shifted_plain(compact=False)`: a GEMM per row tap
    on the packed weights, then the shifted sum over the column taps) on x
    permuted to (B, C, H, W), against the plain transposed head, f32."""
    x, a, bb, kern, bias = _head_inputs(np.random.RandomState(41 + k), 3, 32, 32, 64, f, k, o)
    xt, at, bt = (torch.from_numpy(t) for t in (x, a, bb))
    weight, bias = torch.from_numpy(kern).permute(3, 2, 0, 1), torch.from_numpy(bias)
    want = spade_few_out_conv_plain(xt, at, bt, weight, bias, f, transposed=True)
    got = spade_few_out_conv8_shifted_plain(xt.permute(2, 3, 0, 1).contiguous(), at, bt, weight,
                                            bias, f, compact=False)
    assert _rel(got, want) < TOL["f32"]


# ---- K5-v3 on K5's kernel


@pytest.mark.parametrize("c2,c4,s3,dtype,want", [
    (128, 256, 32, torch.bfloat16, True),  # the published width
    (128, 272, 32, torch.bfloat16, True),  # c4 % 32 == 16: K5's last chunk of 16
    (16, 64, 32, torch.bfloat16, True),
    (192, 384, 32, torch.bfloat16, True),  # conv_dim 96: K5's widened kernel
    (128, 256, 24, torch.bfloat16, True),  # any s3 % 8
    (24, 48, 32, torch.bfloat16, False),  # c2 % 16
    (128, 264, 32, torch.bfloat16, False),  # c4 % 16
    (128, 256, 20, torch.bfloat16, False),  # s3 % 8
    (320, 640, 32, torch.bfloat16, False),  # past a block's shared memory
    (16, 8, 32, torch.float32, True),  # f32 chunks of 8 channels
])
def test_v3_predicate_is_k5s_on_the_padded_grid(c2, c4, s3, dtype, want):
    padded = _aligned(3 * 13 * 13 * c2, dtype).view(3, 13, 13, c2)
    weight = torch.zeros(c4, c2, 4, 4)
    assert typed_expand.typed_c3_expand_v3_supports(padded, weight, s3) == want
    inner = _aligned(3 * 12 * 12 * c2, dtype).view(3, 12, 12, c2)
    assert typed_expand.typed_c3_expand_supports(inner, weight, s3) == want
    assert not typed_expand.typed_c3_expand_v3_supports(inner, weight, s3)  # the padded grid is due
    shifted = _aligned(3 * 13 * 13 * c2, dtype, offset=1).view(3, 13, 13, c2)
    assert not typed_expand.typed_c3_expand_v3_supports(shifted, weight, s3)


def test_v3_wrapper_checks_group_and_reads_the_inner_grid():
    """`group` stays JAX's argument, >= 1, and changes nothing; on the CPU v3
    is K5's function on the inner grid where the padding is zero."""
    rng = np.random.RandomState(42)
    n, s3, c2, c4 = 3, 8, 16, 16
    z2 = torch.from_numpy(rng.randn(n, 12, 12, c2).astype(np.float32))
    z2p = torch.nn.functional.pad(z2, (0, 0, 0, 1, 0, 1))
    ints = [torch.from_numpy(rng.randint(0, hi, shape).astype(np.int32))
            for hi, shape in ((13, (n, 14, 4)), (14, (n, 14, 4)), (14, (n, s3)), (14, (n, s3)))]
    ab = torch.from_numpy((0.5 * rng.randn(n, 2, c4)).astype(np.float32))
    weight = torch.from_numpy((0.1 * rng.randn(c4, c2, 4, 4)).astype(np.float32))
    want = typed_expand.typed_c3_expand(z2, *ints, ab, weight)
    for group in (1, 8, 1000):
        assert torch.equal(typed_expand.typed_c3_expand_v3(z2p, *ints, ab, weight, group), want)
    for group in (0, -2):
        with pytest.raises(ValueError, match="group"):
            typed_expand.typed_c3_expand_v3(z2p, *ints, ab, weight, group)


def test_v3_shares_k5s_library_function_shape():
    """v3's library entry takes K5's arguments (its own group-a-block kernel
    and source are gone), and `stage_times` times the kernel it replaced
    from an earlier csrc/ only."""
    assert build.SIGNATURES["typed_c3_expand_v3"] == build.SIGNATURES["typed_c3_expand"]
    assert not (build.CSRC / "typed_c3_expand_v3.cu").exists()
    assert "k5v3_group" in stage_times.EARLIER and "k5v3" not in stage_times.EARLIER
    assert stage_times.VARIANTS["k5v3"][:3] == ("typed_c3_expand.cu", "typed_c3_expand.cu",
                                                 "typed_c3_expand_v3")
