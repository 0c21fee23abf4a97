"""Fused SPADE apply + relu + few-output-channel KxK conv (the RGB head).

Port of `aglayout_tpu/ops/pallas_spade_conv.py::spade_few_out_conv`, flat
tables, NCHW. The decoder's c4 head computes conv(relu(SPADE(x, seg))) with
3 output channels. SPADE's eval output is x * A + B, where A and B (the
SPADE gamma/beta folded with the parameter-free BN) take one value per
(row block, row class, channel, column): `SPADE.folded_affine_tables`
gives them as (B, H/f, 5, C, W) tables, so the full-resolution gamma and
beta never exist. `csrc/spade_few_out_conv.cu` applies the affine and
relu while it loads x into shared memory and convolves from there.

Numerics, the same in the kernel and in `spade_few_out_conv_plain`:
y = relu(x * A + B) in f32, rounded to x's dtype; the conv zero-pads y
(not x); weights rounded to x's dtype; products and bias accumulated in
f32; output rounded to x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aglayout_tpu_torch.kernels import build

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def class_expand(t, dim: int, f: int):
    """t, whose axis `dim` holds the 5 SPADE block-row classes, indexed along
    it by the class of each offset u < f of an f-pixel block (f >= 5):
    0 for u = 0, 1 for u = 1, 3 for u = f-2, 4 for u = f-1, 2 between.
    Written as slices and not as an index tensor, which would be a
    host-to-device copy that waits for the stream."""
    mid = t.narrow(dim, 2, 1)
    shape = list(mid.shape)
    shape[dim] = f - 4
    return torch.cat([t.narrow(dim, 0, 2), mid.expand(shape), t.narrow(dim, 3, 2)], dim)


def expand_tables(tab, f: int):
    """(B, H/f, 5, C, W) row-class table -> full-resolution (B, C, H, W)."""
    b, hb, _, c, w = tab.shape
    return class_expand(tab, 2, f).permute(0, 3, 1, 2, 4).reshape(b, c, hb * f, w)


def spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f: int):
    """Plain PyTorch version of the kernel.

    x: (B, C, H, W); a_tab, b_tab: (B, H/f, 5, C, W) in x's dtype;
    weight: (O, C, K, K) torch conv weight; bias: (O,) or None.
    Returns (B, O, H, W) in x's dtype.
    """
    y = torch.relu(x.float() * expand_tables(a_tab, f).float() + expand_tables(b_tab, f).float())
    w = weight.to(x.dtype).float()
    out = F.conv2d(y.to(x.dtype).float(), w, None if bias is None else bias.float(),
                   padding=weight.shape[-1] // 2)
    return out.to(x.dtype)


def _pick_rows(c: int, h: int, w: int, k: int, itemsize: int):
    """Largest output-row tile whose shared memory fits one block."""
    for rows in (8, 4, 2, 1):
        smem = c * k * k * 4 * 4 + c * (rows + k - 1) * (w + k - 1) * itemsize
        if h % rows == 0 and smem <= build.SMEM_LIMIT:
            return rows, smem
    raise ValueError(f"spade_few_out_conv: C={c}, W={w}, K={k} does not fit shared memory")


def spade_few_out_conv(x, a_tab, b_tab, weight, bias, f: int):
    """relu(x * A + B) convolved with a KxK, O <= 4 output-channel kernel.

    Same contract as `spade_few_out_conv_plain`. A CPU tensor takes the
    plain version. A CUDA tensor launches `csrc/spade_few_out_conv.cu` or
    raises.
    """
    if x.device.type == "cpu":
        return spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_few_out_conv: unsupported device {x.device}")
    b, c, h, w = x.shape
    o, _, k, _ = weight.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"spade_few_out_conv: dtype {x.dtype} not supported")
    if weight.shape != (o, c, k, k) or k not in (3, 5, 7) or not 1 <= o <= 4:
        raise ValueError(f"spade_few_out_conv: weight shape {tuple(weight.shape)} not supported")
    if h % f or w % 2 or f < 5:
        raise ValueError(f"spade_few_out_conv: x shape {tuple(x.shape)} with f={f} not supported")
    tab_shape = (b, h // f, 5, c, w)
    if a_tab.shape != tab_shape or b_tab.shape != tab_shape:
        raise ValueError(f"spade_few_out_conv: tables {tuple(a_tab.shape)}, want {tab_shape}")
    if a_tab.dtype != x.dtype or b_tab.dtype != x.dtype:
        raise ValueError("spade_few_out_conv: tables must have x's dtype")
    if not (x.is_contiguous() and a_tab.is_contiguous() and b_tab.is_contiguous()):
        raise ValueError("spade_few_out_conv: x and the tables must be contiguous")
    for t in (a_tab, b_tab, weight) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError("spade_few_out_conv: all tensors must be on x's device")
    rows, _ = _pick_rows(c, h, w, k, x.element_size())
    # (O, C, K, K) -> (C, K, K, 4) f32 of the x-dtype-rounded weights, O padded to 4
    wk = torch.zeros((c, k, k, 4), dtype=torch.float32, device=x.device)
    wk[..., :o] = weight.to(x.dtype).float().permute(1, 2, 3, 0)
    bk = torch.zeros(4, dtype=torch.float32, device=x.device)
    if bias is not None:
        bk[:o] = bias.float()
    out = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_few_out_conv(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        out.data_ptr(), b, c, h, w, k, o, f, rows, _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_few_out_conv")
    spade_few_out_conv.launches += 1
    return out


spade_few_out_conv.launches = 0
