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
    calls, as in JAX): `csrc/spade_few_out_conv.cu`, two kernels that the
    wrapper picks between from the shapes, the dtype and the alignment
    (`spade_few_out_conv_route`): in bf16, in each mode, K3's implicit
    GEMM on the tensor cores (`csrc/spade_head_tc.cuh`; a transposed x
    comes by a TMA tensor copy) wherever it takes the shapes, else FMAs on
    the CUDA cores;
  * `spade_few_out_conv8` (K3, the 128^2 c7 head; compact tables):
    `csrc/spade_few_out_conv8.cu`, in bf16 that implicit GEMM over weights
    packed by `pack_head8_weights`, whose arithmetic
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


def _tile(c: int, h: int, w: int, k: int, itemsize: int, vec: int = 1):
    """(rows, cc) of the FMA kernel of `csrc/spade_few_out_conv.cu`: the
    tallest output-row tile with rows * W <= 512 (two pixels a thread), and
    the widest channel chunk, a multiple of `vec`, whose shared memory fits
    one block; None where there is none."""
    rows = max((r for r in range(1, h + 1) if h % r == 0 and r * w <= 512), default=0)
    for cc in (16, 8, 4, 2, 1):
        smem = (w + 3) // 4 * 16 + cc * k * k * 16 + cc * (rows + k - 1) * (w + k - 1) * itemsize
        if rows and c % cc == 0 and cc % vec == 0 and smem <= build.SMEM_LIMIT:
            return rows, cc
    return None


def _pick_tile(c: int, h: int, w: int, k: int, itemsize: int, vec: int = 1):
    """`_tile`, raising where there is none."""
    tile = _tile(c, h, w, k, itemsize, vec)
    if tile is None:
        raise ValueError(f"spade_few_out_conv: C={c}, W={w}, K={k} not supported")
    return tile


# ---- the tensor-core kernel of `csrc/spade_head_tc.cuh`, K3's and K2's in bf16
_TC_R, _TC_CC = 8, 16  # output rows and channels a chunk


def _row_class(u: int, f: int) -> int:
    return 0 if u == 0 else 1 if u == 1 else 3 if u == f - 2 else 4 if u == f - 1 else 2


def _table_slots(h: int, k: int, f: int) -> int:
    """Distinct (row block, row class) table rows that a tile of 8 output
    rows and its halo reads, at most over the tiles (`tc::table_slot`)."""
    most = 1
    for r0 in range(0, h, _TC_R):
        keys = [(g // f) * 5 + _row_class(g % f, f) for g in range(r0 - k // 2, r0 + _TC_R + k // 2)
                if 0 <= g < h]
        most = max(most, sum(1 for i, key in enumerate(keys) if i == 0 or key != keys[i - 1]))
    return most


def head_tc_layout(h: int, w: int, k: int, o: int, f: int, compact: bool,
                   transposed: bool = False):
    """(x staging buffers, bytes of shared memory) of a block of the
    tensor-core kernel, as `tc::layout` in `csrc/spade_head_tc.cuh` computes
    them: two staging buffers for x where they fit, else one (the flat
    tables of a 128-wide map take the room of the second). A transposed x
    is staged as the y tile itself ((8 + K - 1) rows x W pixels x 16
    channels a buffer, 1024-byte aligned), always in two buffers; where
    they do not fit the size is over the limit."""
    th, w5, cols = _TC_R + k - 1, (w // f * 5 if compact else w), -(-k * o // 8) * 8
    words = th * w // 2
    xcs = 2 * (words + (36 - words % 32) % 32)
    xbuf, tbuf = _TC_CC * xcs * 2, _table_slots(h, k, f) * _TC_CC * w5 * 2
    xs = 144 + 2 * k * cols * _TC_CC * 2
    sums = _TC_R * w * (cols + 1) * 4
    if transposed:
        xs = -(-xs // 1024) * 1024
        return 2, xs + max(2 * th * w * _TC_CC * 2 + 4 * tbuf, sums)
    for xb in (2, 1):
        operands = xb * xbuf + 4 * tbuf + th * w * _TC_CC * 2
        total = xs + max(operands, sums)
        if total <= build.SMEM_LIMIT:
            break
    return xb, total


def _head_weight_ok(x, weight, c: int) -> bool:
    o, _, k, _ = weight.shape
    return tuple(weight.shape) == (o, c, k, k) and k in (3, 5, 7) and 1 <= o <= 4


def spade_head_tc_supports(x, weight, f: int, compact: bool, tables=(),
                           transposed: bool = False) -> bool:
    """Whether the tensor-core kernel takes x (B, C, H, W), or (H, W, B, C)
    with `transposed` (flat tables only), and the weight on tables of that
    mode: bf16, C % 16 == 0 (the mma k-step), W in (64, 128) and H % 8 == 0
    (8-row tiles of 16-pixel mma tiles), W % f == 0 with compact tables, x
    and the tables 16-byte aligned (the bulk and tensor copies), with
    `transposed` B C 2 % 16 == 0 (the tensor map's strides), and the block's
    shared memory. A pure function of shapes, dtype and alignment: no CUDA
    call."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or (compact and transposed):
        return False
    h, w, b, c = x.shape if transposed else (*x.shape[2:], *x.shape[:2])
    o, _, k, _ = weight.shape
    return (_head_weight_ok(x, weight, c) and c % _TC_CC == 0 and w in (64, 128)
            and h % _TC_R == 0 and f >= 5 and h % f == 0 and (not compact or w % f == 0)
            and (not transposed or b * c * 2 % 16 == 0)
            and all(t.data_ptr() % 16 == 0 for t in (x, *tables))
            and head_tc_layout(h, w, k, o, f, compact, transposed)[1] <= build.SMEM_LIMIT)


_MODES = {"flat": 0, "compact": 1, "transposed": 2}  # the kernel's mode argument


def spade_few_out_conv_route(x, weight, f: int, compact: bool = False, transposed: bool = False,
                             tables=()) -> str | None:
    """The kernel `spade_few_out_conv` launches for these inputs: "tc" (bf16,
    in any mode, where `spade_head_tc_supports`), "fma", or None where
    neither takes them. A pure function of shapes, dtype and alignment: no
    CUDA call."""
    if x.dtype not in _DTYPES or x.dim() != 4 or (compact and transposed) or f < 5:
        return None
    h, w, _, c = x.shape if transposed else (*x.shape[2:], *x.shape[:2])
    if not _head_weight_ok(x, weight, c) or h % f or w % 2 or (compact and w % f):
        return None
    if spade_head_tc_supports(x, weight, f, compact, tables, transposed):
        return "tc"
    vec = 16 // x.element_size() if transposed else 1
    if transposed and (c % vec or x.data_ptr() % 16):
        return None
    return "fma" if _tile(c, h, w, weight.shape[-1], x.element_size(), vec) else None


def spade_few_out_conv_supports(x, weight, f: int, compact: bool = False,
                                transposed: bool = False) -> bool:
    """Whether a kernel of `spade_few_out_conv` takes x and the weight."""
    return spade_few_out_conv_route(x, weight, f, compact, transposed) is not None


def spade_few_out_conv(x, a_tab, b_tab, weight, bias, f: int, compact: bool = False,
                       transposed: bool = False):
    """relu(x * A + B) convolved with a KxK, O <= 4 output-channel kernel,
    from flat tables, from compact ones (`compact`), or on an x laid out
    (H, W, B, C) (`transposed`, flat tables). The FMA kernel tiles the
    channels, so any C fits, the c7 head's 128 at W = 128 included.

    Same contract as `spade_few_out_conv_plain`. A CPU tensor takes the
    plain version. A CUDA tensor launches a kernel of
    `csrc/spade_few_out_conv.cu` (`spade_few_out_conv_route`) or raises;
    `launches` counts every launch, `mode_launches` by mode and
    `route_launches` by kernel.
    """
    if x.device.type == "cpu":
        return spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f, compact, transposed)
    if x.device.type != "cuda":
        raise ValueError(f"spade_few_out_conv: unsupported device {x.device}")
    mode = _modes("spade_few_out_conv", compact, transposed)
    h, w, b, c = x.shape if transposed else (*x.shape[2:], *x.shape[:2])
    o, _, k, _ = weight.shape
    if not _head_weight_ok(x, weight, c):
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
    route = spade_few_out_conv_route(x, weight, f, compact, transposed, (a_tab, b_tab))
    if route is None:
        raise ValueError(f"spade_few_out_conv: C={c}, W={w}, K={k} not supported")
    out = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tc":
        wk, bk = pack_head8_weights(weight, x.dtype), _padded_bias(bias, o, x.device)
        err = build.library().spade_few_out_conv_tc(
            x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), wk.data_ptr(), bk.data_ptr(),
            out.data_ptr(), b, c, h, w, k, o, f, _MODES[mode], stream,
        )
    else:
        rows, cc = _pick_tile(c, h, w, k, x.element_size(), vec)
        wk, bk = _padded_weights(weight, bias, x.dtype)
        err = build.library().spade_few_out_conv(
            x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), wk.data_ptr(), bk.data_ptr(),
            out.data_ptr(), b, c, h, w, k, o, f, rows, cc, _MODES[mode], _DTYPES[x.dtype], stream,
        )
    build.check(err, "spade_few_out_conv")
    spade_few_out_conv.launches += 1
    spade_few_out_conv.mode_launches[mode] += 1
    spade_few_out_conv.route_launches[route] += 1
    return out


spade_few_out_conv.launches = 0
spade_few_out_conv.mode_launches = dict.fromkeys(_MODES, 0)
spade_few_out_conv.route_launches = {"tc": 0, "fma": 0}


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


def spade_few_out_conv8_shifted_plain(x, a_tab, b_tab, weight, bias, f: int, compact: bool = True):
    """Plain PyTorch version of the schedule of the tensor-core kernel
    (`csrc/spade_head_tc.cuh`, K3's and, in bf16, K2's); the function of
    `spade_few_out_conv_plain` on compact tables (`compact`, K3's) or flat
    ones, with its sums in another order. The column taps are columns of a
    GEMM, acc[b, y, x', (dx, o)] = sum_dy y[b, :, y + dy - K/2, x'] @
    packed[dy], one product per row tap on the packed weights
    (`pack_head8_weights`), and out[b, o, y, x] = bias[o] + sum_dx acc[b, y,
    x + dx - K/2, (dx, o)], a column outside the image adding nothing. Used
    by the tests only."""
    o, c, k, _ = weight.shape
    b, _, h, w = x.shape
    r = k // 2
    if compact:
        a_tab, b_tab = compact_to_flat(a_tab, f), compact_to_flat(b_tab, f)
    a, bb = expand_tables(a_tab, f).float(), expand_tables(b_tab, f).float()
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


def _head8_fma_smem(c: int, w: int, k: int, itemsize: int) -> int:
    """Bytes of shared memory of a block of K3's FMA kernel (f32)."""
    cc = _channel_chunk(c)
    return cc * k * k * 16 + cc * (1024 // w + k - 1) * (w + k - 1) * itemsize


def spade_few_out_conv8_supports(x, weight, f: int, tables=()) -> bool:
    """Whether the kernel of `spade_few_out_conv8` takes x (B, C, H, W) and
    the weight on compact tables: in bf16 the tensor-core kernel
    (`spade_head_tc_supports`), in f32 the FMA kernel (W % 4 == 0 dividing
    1024, H % (1024 / W) == 0). A pure function of shapes, dtype and
    alignment: no CUDA call."""
    if x.dtype not in _DTYPES or x.dim() != 4:
        return False
    _, c, h, w = x.shape
    if not _head_weight_ok(x, weight, c) or f < 5 or h % f or w % f:
        return False
    if x.dtype == torch.bfloat16:
        return spade_head_tc_supports(x, weight, f, True, tables)
    return (w % 4 == 0 and 1024 % w == 0 and h % (1024 // w) == 0
            and _head8_fma_smem(c, w, weight.shape[-1], x.element_size()) <= build.SMEM_LIMIT)


def spade_few_out_conv8(x, a_tab, b_tab, weight, bias, f: int):
    """relu(x * A + B) convolved with a KxK, O <= 4 output-channel kernel,
    from compact tables; the default c7 head at 128^2. In bf16 an implicit
    GEMM on the tensor cores (8 output rows a block, 16 channels a chunk);
    in f32 FMAs (four pixels a thread, 1024 / W rows a block).

    Same contract as `spade_few_out_conv8_plain`. A CPU tensor takes the
    plain version. A CUDA tensor launches `csrc/spade_few_out_conv8.cu` or
    raises a ValueError that names the limit (`spade_few_out_conv8_supports`
    says beforehand).
    """
    if x.device.type == "cpu":
        return spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_few_out_conv8: unsupported device {x.device}")
    b, c, h, w = x.shape
    o, _, k, _ = weight.shape
    if not _head_weight_ok(x, weight, c):
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
        smem = head_tc_layout(h, w, k, o, f, True)[1]
        cc, wk, bk = 0, pack_head8_weights(weight, x.dtype), _padded_bias(bias, o, x.device)
    else:
        if w % 4 or 1024 % w or h % (1024 // w):
            raise ValueError(f"spade_few_out_conv8: the f32 kernel takes W % 4 == 0 dividing "
                             f"1024 and H % (1024 / W) == 0, got H={h}, W={w}")
        cc = _channel_chunk(c)
        smem = _head8_fma_smem(c, w, k, x.element_size())
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


def spade_apply8_supports(x, f: int) -> bool:
    """Whether the kernel of `spade_apply8` takes x (B, C, H, W) on compact
    tables: f >= 5 dividing H and W, W % 8 == 0, x 16-byte aligned (its
    vector loads). A pure function of shapes, dtype and alignment."""
    if x.dtype not in _DTYPES or x.dim() != 4:
        return False
    h, w = x.shape[2:]
    return f >= 5 and h % f == 0 and w % f == 0 and w % 8 == 0 and x.data_ptr() % 16 == 0


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


def spade_apply_t_supports(x, a_tab, b_tab, f: int) -> bool:
    """Whether the kernel of `spade_apply_t` takes x (B, C, H, W) on flat
    tables: f >= 5 dividing H, W a multiple of the 16-byte vector (8 bf16,
    4 f32), x and both tables 16-byte aligned (the kernel's vector loads
    of each). It stages nothing, so any W and f beyond that. A pure
    function of shapes, dtype and alignment."""
    if x.dtype not in _DTYPES or x.dim() != 4:
        return False
    h, w = x.shape[2:]
    return (f >= 5 and h % f == 0 and w % (16 // x.element_size()) == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, a_tab, b_tab)))


def spade_apply_t(x, a_tab, b_tab, f: int):
    """relu(x * A + B) from flat SPADE tables; see `spade_apply_t_plain`.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/spade_apply.cu` (its flat-table kernel) or raises a ValueError
    (`spade_apply_t_supports` says beforehand).
    """
    if x.device.type == "cpu":
        return spade_apply_t_plain(x, a_tab, b_tab, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_apply_t: unsupported device {x.device}")
    b, c, h, w = x.shape
    if f < 5 or h % f or w % (16 // x.element_size()):
        raise ValueError(f"spade_apply_t: x shape {tuple(x.shape)} with f={f} not supported "
                         "(f >= 5 dividing H, W a multiple of 16 bytes)")
    _check_common("spade_apply_t", x, a_tab, b_tab, (b, h // f, 5, c, w))
    if not spade_apply_t_supports(x, a_tab, b_tab, f):
        raise ValueError("spade_apply_t: x and the tables must be 16-byte aligned (the kernel's "
                         "vector loads)")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_apply_t(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), out.data_ptr(), b, c, h, w, f,
        _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_apply_t")
    spade_apply_t.launches += 1
    return out


spade_apply_t.launches = 0
