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
  * `spade_few_out_conv` (K2, the c4 head on flat tables; with
    `compact=True` the 128^2 c7 head when K3 is switched off; with
    `transposed=True` an x laid out (H, W, B, C), an op no model path
    calls, as in JAX): `csrc/spade_few_out_conv.cu`;
  * `spade_few_out_conv8` (K3, the 128^2 c7 head; compact tables):
    `csrc/spade_few_out_conv8.cu`, in bf16 an implicit GEMM on the tensor
    cores over weights packed by `pack_head8_weights`, whose arithmetic
    `spade_few_out_conv8_shifted_plain` repeats;
  * `spade_apply8` (K4, SPADE-4 between c5 and c6 at 128^2; compact
    tables) and `spade_apply_t` (K4', the same function from flat tables;
    like JAX's, an op the decoder does not call): `csrc/spade_apply.cu`.
The Pallas kernels' 8-image groups, (H, W, B, C) views and (B, C) folds are
TPU layouts and are not carried over: all take NCHW x, but for K2's
`transposed` mode, whose (H, W, B, C) input is the mode's point.

Numerics, the same in the kernels and their plain versions:
y = relu(x * A + B) in f32, rounded once to x's dtype (the Pallas
`spade_apply8` applies in bf16; the f32 apply is the port's contract for
all four). The heads zero-pad y (not x), round the weights to x's dtype,
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


def _padded_bias(bias, o: int, device):
    """(O,) bias or None -> (4,) f32, O padded to 4."""
    bk = torch.zeros(4, dtype=torch.float32, device=device)
    if bias is not None:
        bk[:o] = bias.float()
    return bk


def _padded_weights(weight, bias, dtype):
    """(O, C, K, K) weight, (O,) bias -> (C, K, K, 4) f32 of the
    dtype-rounded weights and (4,) f32 bias, O padded to 4."""
    o, c, k, _ = weight.shape
    wk = torch.zeros((c, k, k, 4), dtype=torch.float32, device=weight.device)
    wk[..., :o] = weight.to(dtype).float().permute(1, 2, 3, 0)
    return wk, _padded_bias(bias, o, weight.device)


def _modes(name, compact: bool, transposed: bool) -> str:
    if compact and transposed:
        raise ValueError(f"{name}: compact tables with a transposed x are not supported")
    return "compact" if compact else "transposed" if transposed else "flat"


def spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f: int, compact: bool = False,
                             transposed: bool = False):
    """Plain PyTorch version of the kernel.

    x: (B, C, H, W), or (H, W, B, C) with `transposed`; a_tab, b_tab in x's
    dtype: flat (B, H/f, 5, C, W), or compact (B, H/f, 5, C, 5 W/f) with
    `compact`; weight: (O, C, K, K) torch conv weight; bias: (O,) or None.
    Returns (B, O, H, W) in x's dtype.
    """
    mode = _modes("spade_few_out_conv_plain", compact, transposed)
    if mode == "transposed":
        x = x.permute(2, 3, 0, 1)
    elif mode == "compact":
        a_tab, b_tab = compact_to_flat(a_tab, f), compact_to_flat(b_tab, f)
    y = torch.relu(x.float() * expand_tables(a_tab, f).float() + expand_tables(b_tab, f).float())
    w = weight.to(x.dtype).float()
    out = F.conv2d(y.to(x.dtype).float(), w, None if bias is None else bias.float(),
                   padding=weight.shape[-1] // 2)
    return out.to(x.dtype)


def _pick_tile(c: int, h: int, w: int, k: int, itemsize: int, vec: int = 1):
    """(rows, cc) of `csrc/spade_few_out_conv.cu`: the tallest output-row
    tile with rows * W <= 512 (two pixels a thread), and the widest channel
    chunk, a multiple of `vec`, whose shared memory fits one block."""
    rows = max((r for r in range(1, h + 1) if h % r == 0 and r * w <= 512), default=0)
    for cc in (16, 8, 4, 2, 1):
        smem = (w + 3) // 4 * 16 + cc * k * k * 16 + cc * (rows + k - 1) * (w + k - 1) * itemsize
        if rows and c % cc == 0 and cc % vec == 0 and smem <= build.SMEM_LIMIT:
            return rows, cc
    raise ValueError(f"spade_few_out_conv: C={c}, W={w}, K={k} not supported")


_MODES = {"flat": 0, "compact": 1, "transposed": 2}  # the kernel's mode argument


def spade_few_out_conv(x, a_tab, b_tab, weight, bias, f: int, compact: bool = False,
                       transposed: bool = False):
    """relu(x * A + B) convolved with a KxK, O <= 4 output-channel kernel,
    from flat tables, from compact ones (`compact`), or on an x laid out
    (H, W, B, C) (`transposed`, flat tables). The channels are tiled, so any
    C fits, the c7 head's 128 at W = 128 included.

    Same contract as `spade_few_out_conv_plain`. A CPU tensor takes the
    plain version. A CUDA tensor launches `csrc/spade_few_out_conv.cu` or
    raises; `launches` counts every launch, `mode_launches` by mode.
    """
    if x.device.type == "cpu":
        return spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f, compact, transposed)
    if x.device.type != "cuda":
        raise ValueError(f"spade_few_out_conv: unsupported device {x.device}")
    mode = _modes("spade_few_out_conv", compact, transposed)
    h, w, b, c = x.shape if transposed else (*x.shape[2:], *x.shape[:2])
    o, _, k, _ = weight.shape
    if weight.shape != (o, c, k, k) or k not in (3, 5, 7) or not 1 <= o <= 4:
        raise ValueError(f"spade_few_out_conv: weight shape {tuple(weight.shape)} not supported")
    if h % f or w % 2 or f < 5 or (compact and w % f):
        raise ValueError(f"spade_few_out_conv: x shape {tuple(x.shape)} with f={f} not supported")
    _check_common("spade_few_out_conv", x, a_tab, b_tab,
                  (b, h // f, 5, c, w // f * 5 if compact else w), (weight, bias))
    # the transposed loads are 16-byte vectors along C: nothing of the Pallas
    # kernel's C % 128 lane fold is needed beyond that
    vec = 16 // x.element_size() if transposed else 1
    if transposed and (c % vec or x.data_ptr() % 16):
        raise ValueError(f"spade_few_out_conv: a transposed x needs C % {vec} == 0 and 16-byte "
                         "alignment (the kernel's vector loads)")
    rows, cc = _pick_tile(c, h, w, k, x.element_size(), vec)
    wk, bk = _padded_weights(weight, bias, x.dtype)
    out = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_few_out_conv(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        out.data_ptr(), b, c, h, w, k, o, f, rows, cc, _MODES[mode], _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_few_out_conv")
    spade_few_out_conv.launches += 1
    spade_few_out_conv.mode_launches[mode] += 1
    return out


spade_few_out_conv.launches = 0
spade_few_out_conv.mode_launches = dict.fromkeys(_MODES, 0)


def spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, f: int):
    """Plain PyTorch version of the c7-head kernel: `spade_few_out_conv_plain`
    on the compact tables (B, H/f, 5, C, 5 W/f)."""
    return spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f, compact=True)


def pack_head8_weights(weight, dtype):
    """The c7 head's weights as the B operand of the implicit GEMM of
    `csrc/spade_few_out_conv8.cu`: (O, C, K, K) -> (C / 16, K, NP, 16) in
    `dtype`, [chunk of 16 channels][dy][column dx * O + o][channel]. NP is
    K O rounded up to a multiple of 8, the columns past K O zero. Within a
    chunk the channels lie in the order 0 1 8 9 2 3 10 11 4 5 12 13 6 7 14 15,
    so that the four values one lane feeds to `mma.sync` are contiguous.
    `head8_weight_matrix` gives the same numbers as the (K C, NP) matrix.
    Two launches: a fill and a copy."""
    o, c, k, _ = weight.shape
    if c % 16:
        raise ValueError(f"pack_head8_weights: C % 16 == 0 (the mma k-step), got C={c}")
    cols = -(-k * o // 8) * 8
    buf = torch.zeros((c // 16, k, cols, 4, 2, 2), dtype=dtype, device=weight.device)
    # channel 16 ci + 8 h + 2 t + e -> [ci, dy, (dx, o), t, h, e]
    src = weight.view(o, c // 16, 2, 4, 2, k, k).permute(1, 5, 6, 0, 3, 2, 4)
    buf[:, :, : k * o].view(c // 16, k, k, o, 4, 2, 2).copy_(src)
    return buf.view(c // 16, k, cols, 16)


def head8_weight_matrix(packed):
    """`pack_head8_weights`'s operand as the GEMM's (K C, NP) matrix: row
    dy * C + c, column dx * O + o."""
    nc, k, cols, _ = packed.shape
    m = packed.view(nc, k, cols, 4, 2, 2).permute(1, 0, 4, 3, 5, 2)  # (dy, ci, h, t, e, n)
    return m.reshape(k * nc * 16, cols)


def unpack_head8_weights(packed, o: int):
    """The inverse of `pack_head8_weights`: -> (O, C, K, K)."""
    nc, k, _, _ = packed.shape
    m = head8_weight_matrix(packed)[:, : k * o]
    return m.reshape(k, nc * 16, k, o).permute(3, 1, 0, 2)


def spade_few_out_conv8_shifted_plain(x, a_tab, b_tab, weight, bias, f: int):
    """Plain PyTorch version of the schedule of the bf16 kernel in
    `csrc/spade_few_out_conv8.cu`; the function of `spade_few_out_conv8_plain`
    with its sums in another order. The column taps are columns of a GEMM,
    acc[b, y, x', (dx, o)] = sum_dy y[b, :, y + dy - K/2, x'] @ packed[dy],
    one product per row tap on the packed weights (`pack_head8_weights`),
    and out[b, o, y, x] = bias[o] + sum_dx acc[b, y, x + dx - K/2, (dx, o)],
    a column outside the image adding nothing. Used by the tests only."""
    o, c, k, _ = weight.shape
    b, _, h, w = x.shape
    r = k // 2
    a = expand_tables(compact_to_flat(a_tab, f), f).float()
    bb = expand_tables(compact_to_flat(b_tab, f), f).float()
    y = torch.relu(x.float() * a + bb).to(x.dtype).float()
    yp = F.pad(y, (0, 0, r, r)).permute(0, 2, 3, 1)  # (B, H + 2r, W, C), zero rows outside
    packed = head8_weight_matrix(pack_head8_weights(weight, x.dtype)).float()
    acc = sum(yp[:, dy:dy + h] @ packed[dy * c:(dy + 1) * c] for dy in range(k))  # (B, H, W, NP)
    acc = F.pad(acc, (0, 0, r, r))  # zero columns outside the image
    out = sum(acc[:, :, dx:dx + w, dx * o:(dx + 1) * o] for dx in range(k))  # (B, H, W, O)
    if bias is not None:
        out = out + bias.float()
    return out.permute(0, 3, 1, 2).to(x.dtype)


def _channel_chunk(c: int) -> int:
    """Channels per shared-memory chunk of the f32 kernel of
    `csrc/spade_few_out_conv8.cu`, and of `csrc/spade_apply.cu`."""
    return next(cc for cc in (16, 8, 4, 2, 1) if c % cc == 0)


def spade_few_out_conv8(x, a_tab, b_tab, weight, bias, f: int):
    """relu(x * A + B) convolved with a KxK, O <= 4 output-channel kernel,
    from compact tables; the default c7 head at 128^2. In bf16 an implicit
    GEMM on the tensor cores (8 output rows a block, 16 channels a chunk);
    in f32 FMAs (four pixels a thread, 1024 / W rows a block).

    Same contract as `spade_few_out_conv8_plain`. A CPU tensor takes the
    plain version. A CUDA tensor launches `csrc/spade_few_out_conv8.cu` or
    raises a ValueError that names the limit.
    """
    if x.device.type == "cpu":
        return spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_few_out_conv8: unsupported device {x.device}")
    b, c, h, w = x.shape
    o, _, k, _ = weight.shape
    if weight.shape != (o, c, k, k) or k not in (3, 5, 7) or not 1 <= o <= 4:
        raise ValueError(f"spade_few_out_conv8: weight shape {tuple(weight.shape)} not supported")
    if f < 5 or h % f or w % f:
        raise ValueError(f"spade_few_out_conv8: x shape {tuple(x.shape)} with f={f} not supported")
    _check_common("spade_few_out_conv8", x, a_tab, b_tab, (b, h // f, 5, c, w // f * 5),
                  (weight, bias))
    if x.dtype == torch.bfloat16:
        if w not in (64, 128) or h % 8:
            raise ValueError(f"spade_few_out_conv8: the bf16 kernel takes W in (64, 128) and "
                             f"H % 8 == 0 (8-row tiles, 16-pixel mma tiles), got H={h}, W={w}")
        if c % 16:
            raise ValueError(f"spade_few_out_conv8: the bf16 kernel takes C % 16 == 0 "
                             f"(the mma k-step), got C={c}")
        if any(t.data_ptr() % 16 for t in (x, a_tab, b_tab)):
            raise ValueError("spade_few_out_conv8: the bf16 kernel's 16-byte copies need x and "
                             "the tables 16-byte aligned")
        smem = build.library().spade_few_out_conv8_smem(h, w, k, o, f)
        cc, wk, bk = 0, pack_head8_weights(weight, x.dtype), _padded_bias(bias, o, x.device)
    else:
        if w % 4 or 1024 % w or h % (1024 // w):
            raise ValueError(f"spade_few_out_conv8: the f32 kernel takes W % 4 == 0 dividing "
                             f"1024 and H % (1024 / W) == 0, got H={h}, W={w}")
        cc = _channel_chunk(c)
        smem = cc * k * k * 16 + cc * (1024 // w + k - 1) * (w + k - 1) * x.element_size()
        wk, bk = _padded_weights(weight, bias, x.dtype)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"spade_few_out_conv8: W={w}, K={k}, f={f} needs {smem} bytes of shared "
                         f"memory, a block has {build.SMEM_LIMIT}")
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


def spade_apply_t_plain(x, a_tab, b_tab, f: int):
    """Plain PyTorch version of the flat-table SPADE apply.

    x: (B, C, H, W); a_tab, b_tab: flat (B, H/f, 5, C, W) in x's dtype
    (`SPADE.folded_affine_tables`). Returns relu(x * A + B), (B, C, H, W)
    in x's dtype.
    """
    a, b = expand_tables(a_tab, f).float(), expand_tables(b_tab, f).float()
    return torch.relu(x.float() * a + b).to(x.dtype)


def spade_apply_t(x, a_tab, b_tab, f: int):
    """relu(x * A + B) from flat SPADE tables; see `spade_apply_t_plain`.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/spade_apply.cu` (its flat-table entry point) or raises.
    """
    if x.device.type == "cpu":
        return spade_apply_t_plain(x, a_tab, b_tab, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_apply_t: unsupported device {x.device}")
    b, c, h, w = x.shape
    if f < 5 or h % f or w % 8:
        raise ValueError(f"spade_apply_t: x shape {tuple(x.shape)} with f={f} not supported")
    _check_common("spade_apply_t", x, a_tab, b_tab, (b, h // f, 5, c, w))
    if x.data_ptr() % 16:
        raise ValueError("spade_apply_t: x must be 16-byte aligned (the kernel's vector loads)")
    # the block's 5 row classes x cb channels x W columns of both tables, as f32
    cb = next((cb for cb in (16, 8, 4, 2, 1) if c % cb == 0 and 40 * cb * w <= build.SMEM_LIMIT), 0)
    if not cb:
        raise ValueError(f"spade_apply_t: W={w} does not fit shared memory")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_apply_t(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), out.data_ptr(), b, c, h, w, f, cb,
        _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_apply_t")
    spade_apply_t.launches += 1
    return out


spade_apply_t.launches = 0
