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
"""

from __future__ import annotations

import torch

from aglayout_tpu_torch.kernels import build
from aglayout_tpu_torch.ops.int8 import int8_conv_exact, symmetric_scales
from aglayout_tpu_torch.ops.spade_conv import _DTYPES, _channel_chunk, _check_common, spade_apply8_plain

K6 = 5  # the conv's kernel size


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


def spade_c6_int8(x, a_tab, b_tab, w6q, sw6, f: int):
    """relu(x * A + B) -> int8 5x5 conv, dequantised to x's dtype; see
    `spade_c6_int8_plain`.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/spade_c6_int8.cu` or raises.
    """
    if x.device.type == "cpu":
        return spade_c6_int8_plain(x, a_tab, b_tab, w6q, sw6, f)
    if x.device.type != "cuda":
        raise ValueError(f"spade_c6_int8: unsupported device {x.device}")
    b, c, h, w = x.shape
    if f < 5 or h % f or w % f or h % 8 or w % 32 or c % 128:
        raise ValueError(f"spade_c6_int8: x shape {tuple(x.shape)} with f={f} not supported")
    _check_common("spade_c6_int8", x, a_tab, b_tab, (b, h // f, 5, c, w // f * 5), (w6q, sw6))
    if w6q.shape != (c, K6, K6, c) or w6q.dtype != torch.int8:
        raise ValueError(f"spade_c6_int8: w6q {tuple(w6q.shape)} {w6q.dtype}, "
                         f"want ({c}, {K6}, {K6}, {c}) int8")
    if sw6.shape != (c,) or sw6.dtype != torch.float32:
        raise ValueError(f"spade_c6_int8: sw6 {tuple(sw6.shape)} {sw6.dtype}, want ({c},) f32")
    if not (w6q.is_contiguous() and sw6.is_contiguous()) or x.data_ptr() % 16 or w6q.data_ptr() % 16:
        raise ValueError("spade_c6_int8: w6q and sw6 must be contiguous, x and w6q 16-byte aligned")
    smem = max((12 * 36 + 2 * 128) * (c + 16), 128 * (8 * 32 + 8) * x.element_size())
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"spade_c6_int8: C={c} needs {smem} bytes of shared memory")
    ymax = torch.zeros(b, dtype=torch.int32, device=x.device)  # float bits, for atomicMax
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().spade_c6_int8(
        x.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), w6q.data_ptr(), sw6.data_ptr(),
        ymax.data_ptr(), out.data_ptr(), b, c, h, w, f, _channel_chunk(c), _DTYPES[x.dtype], stream,
    )
    build.check(err, "spade_c6_int8")
    spade_c6_int8.launches += 1
    return out


spade_c6_int8.launches = 0
