"""Fused SPADE apply + relu + int8 5x5 conv (C -> C): the int8 form of the
128^2 decoder's SPADE-4 + c6.

Port of `aglayout_tpu/ops/pallas_spade_c6_int8.py`, NCHW. As in the JAX
package, the op stands beside the decoder and is not wired into it: c6
stays dense under `int8_serving`. The tables are the port's compact ones,
(B, H/f, 5, C, 5 W/f) from `SPADE.folded_affine_tables_compact`, which
`spade_apply8` reads too (JAX's kernel takes the column-expanded
(B, H/f, 5, W, C) form). Numerics, the same in the kernel
(`csrc/spade_c6_int8.cu`) and the plain version:

    y   = relu(x * A + B) in f32 (multiply, then add), rounded to x's dtype
    m   = max y over the image                           (f32)
    q   = round_half_even(y * (127 / max(m, 1e-8)))
    z   = conv(zero_pad(q), w6q)                         (exact)
    out = float(z) * ((max(m, 1e-8) / 127) * sw6[co]), rounded once to x's dtype

The kernel writes q once, channels-last with a zero ring
(`spade_c6_int8_quantized` is that pass in plain PyTorch), and sums on the
int8 tensor cores in K6's k32 steps (32 input channels at one tap) from
K6's packed weights (`ops/conv8_int8.pack_conv_small_int8_weights`), over
tiles of 64 output channels x 32 rows x 16 columns;
`spade_c6_int8_tapped_plain` takes the sum in that order, reading q
through the kernel's descriptor arithmetic.
"""

from __future__ import annotations

import torch

from aglayout_tpu_torch.kernels import build
from aglayout_tpu_torch.ops.conv8_int8 import pack_conv_small_int8_weights, unpack_conv_small_int8_weights
from aglayout_tpu_torch.ops.int8 import int8_conv_exact, symmetric_scales
from aglayout_tpu_torch.ops.spade_conv import _DTYPES, _check_common, spade_apply8_plain

K6 = 5  # the conv's kernel size
R = K6 // 2
# the product's tile (csrc/spade_c6_int8.cu): 32 rows x 16 columns, two
# strips of 8 columns, one a consumer warpgroup; 64 output channels; its
# halo tile, 36 x 20, lies in shared memory as planes of 16 channels
_TH, _TW, _BM = 32, 16, 64
_HTH, _HTW = _TH + 2 * R, _TW + 2 * R
_PLANE = _HTH * _HTW * 16


def padded_hw(h: int, w: int):
    """(HP, WP) of the kernel's q: H and W rounded up to the product's
    tile, plus the zero ring of 2 on each side."""
    return -(-h // _TH) * _TH + 2 * R, -(-w // _TW) * _TW + 2 * R


def spade_c6_int8_plain(x, a_tab, b_tab, w6q, sw6, f: int):
    """Plain PyTorch version of the kernel.

    x: (B, C, H, W); a_tab, b_tab: compact (B, H/f, 5, C, 5 W/f) in x's
    dtype; w6q: (C, 5, 5, C) int8 (`ops/int8.quantize_conv_weights`); sw6:
    (C,) f32. Returns (B, C, H, W) in x's dtype.
    """
    y = spade_apply8_plain(x, a_tab, b_tab, f).float()
    inv, scale = symmetric_scales(y.amax(dim=(1, 2, 3), keepdim=True))
    z = int8_conv_exact(torch.round(y * inv), w6q)
    return (z.float() * (scale * sw6.float().view(1, -1, 1, 1))).to(x.dtype)


def spade_c6_int8_quantized(x, a_tab, b_tab, f: int):
    """The kernel's quantise pass in plain PyTorch: (q, scale) with q (B,
    C / 16, HP, WP, 16) int8, the quantised y of `spade_c6_int8_plain` at
    (y + 2, x + 2) of planes of 16 channels, channels last, zero elsewhere
    (`padded_hw`); scale (B, 1, 1, 1) f32, each image's dequantising
    scale."""
    b, c, h, w = x.shape
    y = spade_apply8_plain(x, a_tab, b_tab, f).float()
    inv, scale = symmetric_scales(y.amax(dim=(1, 2, 3), keepdim=True))
    qv = torch.round(y * inv).to(torch.int8)
    hp, wp = padded_hw(h, w)
    q = torch.zeros((b, c // 16, hp, wp, 16), dtype=torch.int8, device=x.device)
    q[:, :, R:h + R, R:w + R] = qv.view(b, c // 16, 16, h, w).permute(0, 1, 3, 4, 2)
    return q, scale


def spade_c6_int8_tapped_plain(x, a_tab, b_tab, w6q, sw6, f: int):
    """Plain PyTorch version of the kernel's schedule: q from
    `spade_c6_int8_quantized`; for each tile of 32 x 16 output pixels, each
    32-channel chunk's 36 x 20 halo copied as the map producer copies it
    (two planes of 16 channels, a padded row of 320 bytes at a time), and
    the k32 steps (chunk, tap) in the order of K6's packed weights, each
    strip's B operand gathered from that copy at the addresses its wgmma
    descriptor names (start (20 dy + dx + 8 strip) 16, 8-pixel groups 320
    bytes apart, the second 16 channels a plane further), summed exactly in
    int64; then dequantised as the kernel does."""
    b, c, h, w = x.shape
    q, scale = spade_c6_int8_quantized(x, a_tab, b_tab, f)
    dev = x.device
    wt = unpack_conv_small_int8_weights(pack_conv_small_int8_weights(w6q), c, K6, c).to(torch.int64)
    n = torch.arange(256, device=dev)
    k = torch.arange(32, device=dev)
    group = (n // 8 * _HTW * 16 + n % 8 * 16)[:, None] + (k // 16 * _PLANE + k % 16)[None, :]
    z = torch.zeros((b, c, -(-h // _TH) * _TH, -(-w // _TW) * _TW), dtype=torch.int64, device=dev)
    for ty in range(0, h, _TH):
        for tx in range(0, w, _TW):
            for cc in range(c // 32):
                stage = q[:, 2 * cc:2 * cc + 2, ty:ty + _HTH, tx:tx + _HTW].reshape(b, -1).long()
                for tap in range(K6 * K6):
                    dy, dx = divmod(tap, K6)
                    a = wt[:, dy, dx, 32 * cc:32 * cc + 32]  # (C, 32)
                    for strip in range(2):
                        addr = strip * 8 * 16 + (_HTW * dy + dx) * 16 + group  # (256, 32)
                        bop = stage[:, addr]  # (B, 256 pixels, 32)
                        zz = torch.einsum("ck,bnk->bcn", a, bop).view(b, c, _TH, 8)
                        z[:, :, ty:ty + _TH, tx + 8 * strip:tx + 8 * strip + 8] += zz
    z = z[:, :, :h, :w]
    return (z.float() * (scale * sw6.float().view(1, -1, 1, 1))).to(x.dtype)


def spade_c6_int8_supports(x_shape, f: int) -> bool:
    """Whether the kernel of `spade_c6_int8` takes x of `x_shape` (B, C, H,
    W) with row blocks of f: C % 32 == 0 (the k32 steps' chunks), W % 8 ==
    0 (the quantise pass's 8-pixel vectors), f >= 5 dividing H and W, and
    the quantise pass's block within its shared memory: the (A, B) tables
    of 16 channels and the words of its 256 threads on their way out. A
    pure function of shapes."""
    if len(x_shape) != 4:
        return False
    b, c, h, w = x_shape
    return (b >= 1 and c >= 32 and c % 32 == 0 and w % 8 == 0 and f >= 5 and h % f == 0
            and w % f == 0 and 2 * 5 * 16 * (w // f * 5) * 4 + 256 * 8 * 16 <= build.SMEM_LIMIT)


def spade_c6_int8(x, a_tab, b_tab, w6q, sw6, f: int, packed=None):
    """relu(x * A + B) -> int8 5x5 conv, dequantised to x's dtype; see
    `spade_c6_int8_plain`.

    A CPU tensor takes the plain version. A CUDA tensor launches the three
    kernels of `csrc/spade_c6_int8.cu` (one launch counted) or raises.
    `packed`, which a CUDA call needs: the weights as
    `pack_conv_small_int8_weights(w6q)` gives them, packed once by the
    caller for all its calls with these weights.
    """
    if x.device.type == "cpu":
        return spade_c6_int8_plain(x, a_tab, b_tab, w6q, sw6, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_c6_int8: unsupported device {x.device}")
    b, c, h, w = x.shape
    if not spade_c6_int8_supports(x.shape, f):
        raise ValueError(f"spade_c6_int8: x shape {tuple(x.shape)} with f={f} not supported "
                         "(C % 32 == 0, W % 8 == 0, f >= 5 dividing H and W)")
    _check_common("spade_c6_int8", x, a_tab, b_tab, (b, h // f, 5, c, w // f * 5), (w6q, sw6))
    if w6q.shape != (c, K6, K6, c) or w6q.dtype != torch.int8:
        raise ValueError(f"spade_c6_int8: w6q {tuple(w6q.shape)} {w6q.dtype}, "
                         f"want ({c}, {K6}, {K6}, {c}) int8")
    if sw6.shape != (c,) or sw6.dtype != torch.float32:
        raise ValueError(f"spade_c6_int8: sw6 {tuple(sw6.shape)} {sw6.dtype}, want ({c},) f32")
    if not (w6q.is_contiguous() and sw6.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("spade_c6_int8: w6q and sw6 must be contiguous, x 16-byte aligned")
    if packed is None:
        raise ValueError("spade_c6_int8: a CUDA call takes the weights packed, "
                         "packed=pack_conv_small_int8_weights(w6q)")
    shape = (-(-c // _BM), -(-c // 32 * K6 * K6 // 8), 2, _BM, 128)
    if (tuple(packed.shape) != shape or packed.dtype != torch.int8 or packed.device != x.device
            or not packed.is_contiguous() or packed.data_ptr() % 16):
        raise ValueError(f"spade_c6_int8: packed weights {tuple(packed.shape)} {packed.dtype}, "
                         f"want {shape} int8, contiguous, 16-byte aligned, on x's device")
    hp, wp = padded_hw(h, w)
    ymax = torch.zeros(b, dtype=torch.int32, device=x.device)  # float bits, for atomicMax
    q = torch.empty((b, c // 16, hp, wp, 16), dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_c6_int8(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), packed.data_ptr(), sw6.data_ptr(),
        ymax.data_ptr(), q.data_ptr(), out.data_ptr(), b, c, h, w, f, _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_c6_int8")
    spade_c6_int8.launches += 1
    return out


spade_c6_int8.launches = 0
