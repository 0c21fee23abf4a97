"""int8 KxK conv on small (8x8) maps: the wide ConvLSTM gate conv of the
opt-in int8 serving configuration (`Config.int8_serving`).

Port of `aglayout_tpu/ops/pallas_conv8_int8.py`, NCHW. The activations
are quantised with a dynamic symmetric scale per chunk of `gb` images
(`gb` lowered to the largest value that divides B, as in JAX), the weights
per output channel (`ops/int8.quantize_conv_weights`), the products are
summed exactly in integers, and the sum is dequantised to x's dtype:

    m   = max |x| over the chunk                     (f32)
    q   = round_half_even(x * (127 / max(m, 1e-8)))  (no clip: |q| <= 127)
    z   = conv(zero_pad(q), wq)                      (exact)
    out = float(z) * ((max(m, 1e-8) / 127) * sw[co]), rounded once to x's dtype

The kernel (`csrc/conv_small_int8.cu`) and the plain version follow this
to the operation, so they agree to the last bit wherever their f32
products do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aglayout_tpu_torch.kernels import build
from aglayout_tpu_torch.ops.int8 import int8_conv_exact, symmetric_scales

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _chunk(b: int, gb: int) -> int:
    """The largest chunk size <= gb that divides b."""
    while b % gb:
        gb -= 1
    return gb


def conv_small_int8_plain(x, wq, sw, k: int = 5, gb: int = 16):
    """Plain PyTorch version of the kernel.

    x: (B, Cin, S, S); wq: (Cout, k, k, Cin) int8; sw: (Cout,) f32
    per-output-channel weight scales. Returns (B, Cout, S, S) in x's dtype.
    """
    b = x.shape[0]
    gb = _chunk(b, gb)
    xf = x.float()
    m = xf.reshape(b // gb, -1).abs().amax(dim=1)
    m = m[:, None].expand(-1, gb).reshape(b, 1, 1, 1)  # each image's chunk max
    inv, scale = symmetric_scales(m)
    z = int8_conv_exact(torch.round(xf * inv), wq)
    return (z.float() * (scale * sw.float().view(1, -1, 1, 1))).to(x.dtype)


def conv_small_int8(x, wq, sw, k: int = 5, gb: int = 16):
    """int8 KxK same-pad conv of 8x8 maps; see `conv_small_int8_plain`.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/conv_small_int8.cu` or raises.
    """
    if x.device.type == "cpu":
        return conv_small_int8_plain(x, wq, sw, k, gb)
    if x.device.type != "cuda":
        raise ValueError(f"conv_small_int8: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv_small_int8: dtype {x.dtype} not supported")
    b, cin = x.shape[:2]
    cout = wq.shape[0]
    if x.shape != (b, cin, 8, 8):
        raise ValueError(f"conv_small_int8: x shape {tuple(x.shape)}, want (B, Cin, 8, 8)")
    if k not in (1, 3, 5, 7) or wq.shape != (cout, k, k, cin) or wq.dtype != torch.int8:
        raise ValueError(f"conv_small_int8: wq {tuple(wq.shape)} {wq.dtype}, "
                         f"want ({cout}, {k}, {k}, {cin}) int8")
    if cout % 64 or sw.shape != (cout,) or sw.dtype != torch.float32:
        raise ValueError(f"conv_small_int8: Cout={cout} must be a multiple of 64 "
                         f"and sw ({cout},) f32, got {tuple(sw.shape)} {sw.dtype}")
    if not (x.is_contiguous() and wq.is_contiguous() and sw.is_contiguous()):
        raise ValueError("conv_small_int8: x, wq and sw must be contiguous")
    if wq.device != x.device or sw.device != x.device:
        raise ValueError("conv_small_int8: all tensors must be on x's device")
    gb = _chunk(b, gb)
    cp = (cin + 31) // 32 * 32  # the kernel's k step is 32 input channels
    if cp != cin:
        wq = F.pad(wq, (0, cp - cin))
    if wq.data_ptr() % 16:
        raise ValueError("conv_small_int8: wq must be 16-byte aligned (the kernel's vector loads)")
    p = 8 + k - 1
    amax = torch.zeros(b // gb, dtype=torch.int32, device=x.device)  # float bits, for atomicMax
    q = torch.empty((b, p, p, cp), dtype=torch.int8, device=x.device)
    out = torch.empty((b, cout, 8, 8), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().conv_small_int8(
        x.data_ptr(), wq.data_ptr(), sw.data_ptr(), amax.data_ptr(), q.data_ptr(), out.data_ptr(),
        b, cin, cp, cout, k, gb, _DTYPES[x.dtype], stream,
    )
    build.check(err, "conv_small_int8")
    conv_small_int8.launches += 1
    return out


conv_small_int8.launches = 0
