"""The decoder's SPADE kernels: the fused SPADE apply + relu + few-output
KxK conv (the RGB heads), and the SPADE apply + relu alone.

Port of `aglayout_tpu/ops/pallas_spade_conv.py`, NCHW. SPADE's eval output
is x * A + B, where A and B (the SPADE gamma/beta folded with the
parameter-free BN) take one value per (row block, row class, channel, col
block, col class) for an upscale factor f >= 5, so the full-resolution
gamma and beta never exist. Two table layouts, both from `models/norms.py`:

  * compact, (B, H/f, 5, C, 5 W/f) (`SPADE.folded_affine_tables_compact`):
    the affine of pixel (g, j) is tab[b, g/f, class(g%f), c,
    (j/f)*5 + class(j%f)];
  * flat, (B, H/f, 5, C, W) (`SPADE.folded_affine_tables`): the compact
    table with its columns expanded to full resolution (`compact_to_flat`).

Kernels, each beside its plain PyTorch version:
  * `spade_few_out_conv` (K2, the 64^2 c4 head; flat tables):
    `csrc/spade_few_out_conv.cu`;
  * `spade_few_out_conv8` (K3, the 128^2 c7 head; compact tables, channel
    tiling): `csrc/spade_few_out_conv8.cu`;
  * `spade_apply8` (K4, SPADE-4 between c5 and c6 at 128^2; compact
    tables): `csrc/spade_apply.cu`.
The Pallas kernels' 8-image groups and (H, W, B, C) views are TPU layouts
and are not carried over: all three take NCHW x.

Numerics, the same in the kernels and their plain versions:
y = relu(x * A + B) in f32, rounded once to x's dtype (the Pallas
`spade_apply8` applies in bf16; the f32 apply is the port's contract for
all three). The heads zero-pad y (not x), round the weights to x's dtype,
accumulate products and bias in f32 and round the output to x's dtype.
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


def compact_to_flat(tab, f: int):
    """Compact (B, H/f, 5, C, 5 W/f) table -> flat (B, H/f, 5, C, W)."""
    b, hb, _, c, w5 = tab.shape
    cols = class_expand(tab.reshape(b, hb, 5, c, w5 // 5, 5), 5, f)
    return cols.reshape(b, hb, 5, c, w5 // 5 * f)


def expand_tables(tab, f: int):
    """(B, H/f, 5, C, W) row-class table -> full-resolution (B, C, H, W)."""
    b, hb, _, c, w = tab.shape
    return class_expand(tab, 2, f).permute(0, 3, 1, 2, 4).reshape(b, c, hb * f, w)


def _check_common(name, x, a_tab, b_tab, tab_shape, others=()):
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    if a_tab.shape != tab_shape or b_tab.shape != tab_shape:
        raise ValueError(f"{name}: tables {tuple(a_tab.shape)}, want {tab_shape}")
    if a_tab.dtype != x.dtype or b_tab.dtype != x.dtype:
        raise ValueError(f"{name}: tables must have x's dtype")
    if not (x.is_contiguous() and a_tab.is_contiguous() and b_tab.is_contiguous()):
        raise ValueError(f"{name}: x and the tables must be contiguous")
    for t in (a_tab, b_tab) + tuple(t for t in others if t is not None):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on x's device")


def _padded_weights(weight, bias, dtype):
    """(O, C, K, K) weight, (O,) bias -> (C, K, K, 4) f32 of the
    dtype-rounded weights and (4,) f32 bias, O padded to 4."""
    o, c, k, _ = weight.shape
    wk = torch.zeros((c, k, k, 4), dtype=torch.float32, device=weight.device)
    wk[..., :o] = weight.to(dtype).float().permute(1, 2, 3, 0)
    bk = torch.zeros(4, dtype=torch.float32, device=weight.device)
    if bias is not None:
        bk[:o] = bias.float()
    return wk, bk


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
    if weight.shape != (o, c, k, k) or k not in (3, 5, 7) or not 1 <= o <= 4:
        raise ValueError(f"spade_few_out_conv: weight shape {tuple(weight.shape)} not supported")
    if h % f or w % 2 or f < 5:
        raise ValueError(f"spade_few_out_conv: x shape {tuple(x.shape)} with f={f} not supported")
    _check_common("spade_few_out_conv", x, a_tab, b_tab, (b, h // f, 5, c, w), (weight, bias))
    rows, _ = _pick_rows(c, h, w, k, x.element_size())
    wk, bk = _padded_weights(weight, bias, x.dtype)
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


def spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, f: int):
    """Plain PyTorch version of the c7-head kernel: `spade_few_out_conv_plain`
    on the compact tables (B, H/f, 5, C, 5 W/f), expanded."""
    return spade_few_out_conv_plain(x, compact_to_flat(a_tab, f), compact_to_flat(b_tab, f),
                                    weight, bias, f)


def _channel_chunk(c: int) -> int:
    """Channels per shared-memory chunk of `csrc/spade_few_out_conv8.cu`."""
    return next(cc for cc in (16, 8, 4, 2, 1) if c % cc == 0)


def spade_few_out_conv8(x, a_tab, b_tab, weight, bias, f: int):
    """relu(x * A + B) convolved with a KxK, O <= 4 output-channel kernel,
    from compact tables; the channel-tiled head for wide inputs (the c7
    head at 128^2: C=128, W=128, which K2's kernel cannot hold).

    Same contract as `spade_few_out_conv8_plain`. A CPU tensor takes the
    plain version. A CUDA tensor launches `csrc/spade_few_out_conv8.cu` or
    raises.
    """
    if x.device.type == "cpu":
        return spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_few_out_conv8: unsupported device {x.device}")
    b, c, h, w = x.shape
    o, _, k, _ = weight.shape
    if weight.shape != (o, c, k, k) or k not in (3, 5, 7) or not 1 <= o <= 4:
        raise ValueError(f"spade_few_out_conv8: weight shape {tuple(weight.shape)} not supported")
    if f < 5 or h % f or w % f or w % 4 or 1024 % w or h % (1024 // w):
        raise ValueError(f"spade_few_out_conv8: x shape {tuple(x.shape)} with f={f} not supported")
    _check_common("spade_few_out_conv8", x, a_tab, b_tab, (b, h // f, 5, c, w // f * 5),
                  (weight, bias))
    cc = _channel_chunk(c)
    smem = cc * k * k * 16 + cc * (1024 // w + k - 1) * (w + k - 1) * x.element_size()
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"spade_few_out_conv8: W={w}, K={k} needs {smem} bytes of shared memory")
    wk, bk = _padded_weights(weight, bias, x.dtype)
    out = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_few_out_conv8(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        out.data_ptr(), b, c, h, w, k, o, f, cc, _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_few_out_conv8")
    spade_few_out_conv8.launches += 1
    return out


spade_few_out_conv8.launches = 0


def spade_apply8_plain(x, a_tab, b_tab, f: int):
    """Plain PyTorch version of the SPADE-apply kernel.

    x: (B, C, H, W); a_tab, b_tab: compact (B, H/f, 5, C, 5 W/f) in x's
    dtype. Returns relu(x * A + B), (B, C, H, W) in x's dtype.
    """
    a = expand_tables(compact_to_flat(a_tab, f), f).float()
    b = expand_tables(compact_to_flat(b_tab, f), f).float()
    return torch.relu(x.float() * a + b).to(x.dtype)


def spade_apply8(x, a_tab, b_tab, f: int):
    """relu(x * A + B) from compact SPADE tables; see `spade_apply8_plain`.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/spade_apply.cu` or raises.
    """
    if x.device.type == "cpu":
        return spade_apply8_plain(x, a_tab, b_tab, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_apply8: unsupported device {x.device}")
    b, c, h, w = x.shape
    if f < 5 or h % f or w % f or w % 8:
        raise ValueError(f"spade_apply8: x shape {tuple(x.shape)} with f={f} not supported")
    _check_common("spade_apply8", x, a_tab, b_tab, (b, h // f, 5, c, w // f * 5))
    if x.data_ptr() % 16:
        raise ValueError("spade_apply8: x must be 16-byte aligned (the kernel's vector loads)")
    cb = _channel_chunk(c)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_apply8(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), out.data_ptr(), b, c, h, w, f, cb,
        _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_apply8")
    spade_apply8.launches += 1
    return out


spade_apply8.launches = 0
