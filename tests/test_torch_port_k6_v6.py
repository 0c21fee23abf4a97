"""The host side of K6 (`conv_small_int8`) and K5-v6 (`typed_c3_expand_v6`)
as redesigned for the H100, and K6's route, which falls through by shape.

The CUDA kernels run only on a card (`test_torch_port_gpu.py`,
`chip_smoke.py`). Here, on the CPU: K6's weight packing, a plain PyTorch
version of its k32-step schedule held against the plain version and against
the JAX kernel in interpret mode on the same numpy inputs, its shape
predicate and `ConvLSTMCell.int8_route` (models on the meta device), and
v6's compaction of an object's row types.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aglayout_tpu.ops.pallas_conv8_int8 as jax_conv8
from aglayout_tpu.ops.pallas_spade_c6_int8 import quantize_conv_weights as jax_quantize
from aglayout_tpu_torch.models.convlstm import ConvLSTMCell, LayoutFuser
from aglayout_tpu_torch.models.generator import clstm_hidden_dims
from aglayout_tpu_torch.ops import typed_expand
from aglayout_tpu_torch.ops.conv8_int8 import (
    conv_small_int8_plain,
    conv_small_int8_supports,
    conv_small_int8_takes_weights,
    conv_small_int8_tapped_plain,
    pack_conv_small_int8_weights,
    unpack_conv_small_int8_weights,
)
from aglayout_tpu_torch.ops.int8 import quantize_conv_weights
from torch_port_common import nchw, nhwc

torch.set_num_threads(1)


def _int8_case(b, cin, cout, k, seed):
    """x (B, 8, 8, Cin) and an HWIO weight as numpy, and the port's int8
    weights of it."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 8, 8, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.05).astype(np.float32)
    wq, sw = quantize_conv_weights(torch.from_numpy(w).permute(3, 2, 0, 1))
    return x, w, wq, sw


# ---- K6: the weight packing


# Cout 24 (not a multiple of 64), Cin 40 (not of 32), every k; the wide cell
@pytest.mark.parametrize("cin,cout,k", [(40, 24, 3), (64, 72, 5), (33, 8, 7), (16, 64, 1),
                                        (640, 512, 5)])
def test_k6_weight_packing(cin, cout, k):
    """The packed K6 weights: shape, the way back bit for bit, and where
    one byte lies: tile, slice, k-block, row, swizzled piece."""
    rng = np.random.RandomState(cin + cout + k)
    wq = torch.from_numpy(rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8))
    packed = pack_conv_small_int8_weights(wq)
    nch = -(-cin // 32)
    nsl = -(-nch * k * k // 8)
    assert packed.shape == (-(-cout // 64), nsl, 2, 64, 128) and packed.dtype == torch.int8
    assert packed.is_contiguous()
    assert torch.equal(unpack_conv_small_int8_weights(packed, cout, k, cin), wq)
    flat = packed.view(packed.shape[0], nsl * 2, 64, 128)
    for _ in range(100):
        co, dy, dx, ci = rng.randint(cout), rng.randint(k), rng.randint(k), rng.randint(cin)
        s = (ci // 32) * k * k + dy * k + dx  # the k32 step: (chunk, tap)
        n, byte = co % 64, (s % 4) * 32 + ci % 32
        piece = byte // 16
        assert flat[co // 64, s // 4, n, (piece ^ (n % 8)) * 16 + byte % 16] == wq[co, dy, dx, ci]
    # the padding (channels past Cout and Cin, steps past the last) is zero
    assert int(packed.abs().sum()) == int(wq.abs().sum())


def test_k6_weight_packing_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="Cout % 8"):
        pack_conv_small_int8_weights(torch.zeros(12, 5, 5, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="k odd"):
        pack_conv_small_int8_weights(torch.zeros(16, 4, 4, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        pack_conv_small_int8_weights(torch.zeros(16, 5, 5, 16))


# ---- K6: the k32-step schedule against the plain version and JAX


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,gb,cin,cout,k", [(6, 16, 40, 24, 3), (8, 4, 64, 72, 5), (3, 3, 33, 16, 7),
                                             (2, 2, 48, 8, 1)])
def test_k6_tapped_plain_matches_plain_and_jax(b, gb, cin, cout, k, dt):
    """conv_small_int8_tapped_plain (the kernel's order: one k32 step of 32
    channels at one tap after another, from the packed weights) ==
    conv_small_int8_plain (int8_conv_exact's im2col) bit for bit: both sums
    are exact integers. Against JAX's kernel in interpret mode: the same
    integers; the dequantising product agrees to the last bit in f32 and
    rounds once to bf16."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    x, w, wq, sw = _int8_case(b, cin, cout, k, seed=b * cin + k)
    xt = nchw(x).to(tdt)
    got = conv_small_int8_tapped_plain(xt, wq, sw, k, gb)
    assert got.dtype == tdt and got.shape == (b, cout, 8, 8)
    assert torch.equal(got, conv_small_int8_plain(xt, wq, sw, k, gb))
    jq, js = jax_quantize(jnp.asarray(w))
    want = np.asarray(jax_conv8.conv_small_int8(jnp.asarray(x, {"f32": jnp.float32,
                                                                 "bf16": jnp.bfloat16}[dt]),
                                                jq, js, k=k, gb=gb, interpret=True), np.float32)
    err = np.abs(nhwc(got.float()) - want).max() / np.abs(want).max()
    assert err <= {"f32": 1e-5, "bf16": 2 ** -7}[dt], err


# ---- K6: the predicate and the route


@pytest.mark.parametrize("x_shape,wq_shape,k,want", [
    ((128, 640, 8, 8), (512, 5, 5, 640), 5, True),  # the published wide cell
    ((4, 600, 8, 8), (480, 5, 5, 600), 5, True),  # conv_dim 60: Cout not a multiple of 64
    ((4, 580, 8, 8), (464, 5, 5, 580), 5, True),  # conv_dim 58
    ((3, 33, 8, 8), (8, 7, 7, 33), 7, True),
    ((3, 33, 8, 8), (12, 7, 7, 33), 7, False),  # Cout % 8
    ((4, 64, 16, 16), (64, 5, 5, 64), 5, False),  # another map size
    ((4, 64, 8, 8), (64, 4, 4, 64), 4, False),  # an even k
    ((4, 64, 8, 8), (64, 9, 9, 64), 9, False),  # k > 7
    ((4, 64, 8, 8), (64, 5, 5, 32), 5, False),  # Cin of x and wq differ
])
def test_k6_supports(x_shape, wq_shape, k, want):
    assert conv_small_int8_supports(x_shape, wq_shape, k) == want


@pytest.mark.parametrize("wq_shape,k,want", [
    ((512, 5, 5, 640), 5, True),
    ((480, 5, 5, 600), 5, True),
    ((8, 1, 1, 3), 1, True),
    ((12, 5, 5, 64), 5, False),  # Cout % 8
    ((64, 4, 4, 64), 4, False),  # an even k
    ((64, 5, 5, 64), 3, False),  # k is not the weights'
    ((64, 5, 5), 5, False),
])
def test_k6_takes_weights(wq_shape, k, want):
    """The weight half of the predicate, which also decides where the
    ConvLSTM packs its weights."""
    assert conv_small_int8_takes_weights(wq_shape, k) == want


def test_quantized_weights_are_packed_only_where_the_kernel_can_run(monkeypatch):
    """`quantized_weights` is the one place the gate conv's weights are
    packed (once a forward, for every slot): never for CPU weights, which
    take the plain version; a cell that does not engage has none."""
    import aglayout_tpu_torch.models.convlstm as convlstm

    monkeypatch.setattr(convlstm, "_INT8_MIN_CINCOUT", 1)
    cell = ConvLSTMCell(8, 8, int8_serving=True)
    wq, sw, wp = cell.quantized_weights()
    assert wq.dtype == torch.int8 and wq.shape == (32, 5, 5, 16) and sw.shape == (32,) and wp is None
    assert ConvLSTMCell(8, 8).quantized_weights() is None


def _layer0(d, **kw):
    """The layer-0 ConvLSTM cell of the layout encoder at conv_dim d, on the
    meta device, and its input cat(x, h)."""
    dims = clstm_hidden_dims(3, d)
    with torch.device("meta"):
        fuser = LayoutFuser(8 * d, dims, int8_serving=True, dtype=torch.bfloat16, **kw)
    cell = fuser.cell_list[0].eval()  # int8 serving: the eval path's route
    return cell, torch.empty(4, 8 * d + dims[0], 8, 8, dtype=torch.bfloat16, device="meta")


# conv_dim 58 and 60: 8 conv_dim output channels, not a multiple of 64; JAX
# engages its kernel at every width from 58 on
@pytest.mark.parametrize("d", [58, 60, 64])
def test_int8_route_takes_the_kernel_at_every_engaged_width(d):
    cell, inp = _layer0(d)
    assert cell.int8_engaged and cell.conv.out_channels == 8 * d
    assert cell.int8_route(inp) == "kernel"
    off, inp = _layer0(d, use_int8_kernel=False)
    assert off.int8_route(inp) == "plain"
    assert cell.int8_route(inp.float()) == "kernel" and cell.int8_route(inp.half()) == "plain"


def test_int8_route_falls_through_by_shape():
    """A map other than 8x8 or an even kernel size takes the plain version;
    below conv_dim 58 the cell does not engage at all."""
    cell, inp = _layer0(64)
    assert cell.int8_route(torch.empty(4, inp.shape[1], 16, 16, device="meta")) == "plain"
    with torch.device("meta"):
        even = ConvLSTMCell(512, 128, kernel_size=4, int8_serving=True).eval()
    assert even.int8_engaged and even.int8_route(inp) == "plain"
    assert not _layer0(57)[0].int8_engaged


# ---- K5-v6: the compaction of the row types


def test_v6_compaction_on_edge_cases():
    """present_row_types: the row types the output rows name, in
    increasing order, their count, and W3z rows padded to the warpgroups'
    64: one type, all 14, types outside [0, 14) (no row type), none."""
    sel = torch.tensor([[5] * 32,
                        list(range(13, -1, -1)) * 2 + [0, 1, 2, 3],
                        [14, -1, 20] + [3] * 14 + [9] * 15,
                        [14] * 16 + [-2] * 16,
                        [0] * 31 + [13]], dtype=torch.int32)
    types, counts, rows = typed_expand.present_row_types(sel)
    assert counts.tolist() == [1, 14, 2, 0, 2]
    assert rows.tolist() == [64, 192, 64, 0, 64]
    assert types[0].tolist() == [5] + [-1] * 13
    assert types[1].tolist() == list(range(14))
    assert types[2].tolist() == [3, 9] + [-1] * 12
    assert types[3].tolist() == [-1] * 14
    assert types[4].tolist() == [0, 13] + [-1] * 12
    for obj in range(sel.shape[0]):  # the set of types, from selR directly
        named = {a for a in sel[obj].tolist() if 0 <= a < 14}
        assert set(types[obj, :counts[obj]].tolist()) == named


@pytest.mark.parametrize("n_types", [1, 5, 14])
def test_v6_absent_row_types_do_not_reach_the_output(n_types):
    """What v6 skips is what the function never reads: the windows (idxR)
    of a row type no output row names can be anything, and the plain version
    gives the same output, bit for bit (f32)."""
    rng = np.random.RandomState(n_types)
    n, c2, c4, s3 = 3, 16, 8, 16
    z2 = torch.from_numpy(rng.randn(n, 12, 12, c2).astype(np.float32))
    i32 = lambda hi, shape: torch.from_numpy(rng.randint(0, hi, shape).astype(np.int32))  # noqa: E731
    idxR, lsel, selC = i32(13, (n, 14, 4)), i32(14, (n, 14, 4)), i32(14, (n, s3))
    chosen = torch.from_numpy(rng.permutation(14)[:n_types].astype(np.int32))
    selR = chosen[torch.from_numpy(rng.randint(0, n_types, (n, s3)))]
    selR[:, :n_types] = chosen  # every chosen type has a row
    ab = torch.from_numpy(rng.randn(n, 2, c4).astype(np.float32))
    weight = torch.from_numpy(rng.randn(c4, c2, 4, 4).astype(np.float32) * 0.1)
    want = typed_expand.typed_c3_expand_plain(z2, idxR, lsel, selR, selC, ab, weight)
    types, counts, _ = typed_expand.present_row_types(selR)
    absent = torch.ones(n, 14, dtype=torch.bool)
    for obj in range(n):
        absent[obj, types[obj, :counts[obj]]] = False
    scrambled = torch.where(absent[..., None], i32(13, (n, 14, 4)), idxR)
    got = typed_expand.typed_c3_expand_v6_plain(z2, scrambled, lsel, selR, selC, ab, weight)
    assert absent.sum(1).tolist() == [14 - n_types] * n
    assert torch.equal(got, want)
