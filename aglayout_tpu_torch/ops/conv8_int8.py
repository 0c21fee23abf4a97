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
products do. The kernel sums on the int8 tensor cores in k32 steps (32
input channels at one tap) from weights packed once by the caller
(`pack_conv_small_int8_weights`; `LayoutFuser` packs them once a forward);
`conv_small_int8_tapped_plain` takes the sum in that order, and
`conv_small_int8_supports` says which shapes the kernel takes.
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


def _quantized(x, gb: int):
    """(q, scale): x quantised with each chunk's scale (q integer-valued f32)
    and each image's dequantising scale, (B, 1, 1, 1)."""
    b = x.shape[0]
    gb = _chunk(b, gb)
    xf = x.float()
    m = xf.reshape(b // gb, -1).abs().amax(dim=1)
    m = m[:, None].expand(-1, gb).reshape(b, 1, 1, 1)  # each image's chunk max
    inv, scale = symmetric_scales(m)
    return torch.round(xf * inv), scale


def conv_small_int8_plain(x, wq, sw, k: int = 5, gb: int = 16):
    """Plain PyTorch version of the kernel.

    x: (B, Cin, S, S); wq: (Cout, k, k, Cin) int8; sw: (Cout,) f32
    per-output-channel weight scales. Returns (B, Cout, S, S) in x's dtype.
    """
    q, scale = _quantized(x, gb)
    z = int8_conv_exact(q, wq)
    return (z.float() * (scale * sw.float().view(1, -1, 1, 1))).to(x.dtype)


# the kernel's tiles (csrc/conv_small_int8.cu): 64 output channels and 8
# images a CTA, 32 input channels a k32 step, 8 steps a 16 KB weight slice
_BM, _IMG, _CK, _SL = 64, 8, 32, 8


def conv_small_int8_takes_weights(wq_shape, k: int) -> bool:
    """Whether the kernel of `conv_small_int8` (and
    `pack_conv_small_int8_weights`) takes int8 weights of `wq_shape`: (Cout,
    k, k, Cin), k odd and at most 7, Cout a multiple of 8 (the output
    channels are padded to the kernel's 64 when the weights are packed, the
    input channels to its k32 step). A pure function of shapes."""
    if len(wq_shape) != 4:
        return False
    cout, cin = wq_shape[0], wq_shape[3]
    return (k in (1, 3, 5, 7) and tuple(wq_shape) == (cout, k, k, cin) and cin >= 1
            and cout >= 8 and cout % 8 == 0)


def conv_small_int8_supports(x_shape, wq_shape, k: int) -> bool:
    """Whether the kernel of `conv_small_int8` takes x of `x_shape` and
    weights of `wq_shape`: x (B, Cin, 8, 8), weights it takes
    (`conv_small_int8_takes_weights`) with Cin input channels. A pure
    function of shapes."""
    if len(x_shape) != 4 or len(wq_shape) != 4:
        return False
    return (tuple(x_shape[2:]) == (8, 8) and x_shape[0] >= 1 and wq_shape[3] == x_shape[1]
            and conv_small_int8_takes_weights(wq_shape, k))


def _swizzle(n_rows: int, device):
    """The (n_rows, 8) index of the 128-byte swizzle: piece p of row n lies
    at p ^ (n % 8); the map is its own inverse."""
    r = torch.arange(n_rows, device=device) % 8
    return r[:, None] ^ torch.arange(8, device=device)[None, :]


def pack_conv_small_int8_weights(wq):
    """The int8 weights as the ring slices of `csrc/conv_small_int8.cu`:
    (Cout, k, k, Cin) -> (Mp / 64, n_slices, 2, 64, 128) int8, [64-channel
    tile][slice of 8 k32 steps][k-block of 4 steps][output channel][128
    bytes]. Step s is input-channel chunk s // k^2 (32 channels) at tap s %
    k^2; output channels are padded with zeros to Mp (a multiple of 64),
    input channels to a multiple of 32, steps to a whole slice. Within a row
    the 16-byte pieces are swizzled, piece p holding the bytes of piece p ^
    (n % 8), the layout the tensor cores read with the 128-byte swizzle. A
    slice is one contiguous 16 KB copy."""
    cout, k, _, cin = wq.shape
    if wq.dtype != torch.int8 or not conv_small_int8_takes_weights(tuple(wq.shape), k):
        raise ValueError(f"pack_conv_small_int8_weights: wq (Cout, k, k, Cin) int8 with Cout % 8 "
                         f"== 0 and k odd <= 7, got {tuple(wq.shape)} {wq.dtype}")
    kk, mp, nch = k * k, -(-cout // _BM) * _BM, -(-cin // _CK)
    steps = nch * kk
    nsl = -(-steps // _SL)
    w = torch.zeros((mp, kk, nch * _CK), dtype=torch.int8, device=wq.device)
    w[:cout, :, :cin] = wq.reshape(cout, kk, cin)
    w = w.view(mp, kk, nch, _CK).transpose(1, 2).reshape(mp, steps * _CK)  # rows (chunk, tap)
    w = F.pad(w, (0, (nsl * _SL - steps) * _CK))
    w = w.view(mp // _BM, _BM, nsl * 2, 8, 16).permute(0, 2, 1, 3, 4)  # [tile][k-block][n][piece]
    idx = _swizzle(_BM, wq.device).view(1, 1, _BM, 8, 1)
    w = torch.take_along_dim(w, idx, dim=3)  # [.., n, p, :] <- [.., n, p ^ (n % 8), :]
    return w.reshape(mp // _BM, nsl, 2, _BM, 128).contiguous()


def unpack_conv_small_int8_weights(packed, cout: int, k: int, cin: int):
    """The inverse of `pack_conv_small_int8_weights`: -> (Cout, k, k, Cin)."""
    mt, nsl = packed.shape[:2]
    kk, nch = k * k, -(-cin // _CK)
    idx = _swizzle(_BM, packed.device).view(1, 1, _BM, 8, 1)
    w = torch.take_along_dim(packed.view(mt, nsl * 2, _BM, 8, 16), idx, dim=3)
    w = w.permute(0, 2, 1, 3, 4).reshape(mt * _BM, nsl * _SL * _CK)[:, :nch * kk * _CK]
    w = w.view(-1, nch, kk, _CK).transpose(1, 2).reshape(-1, kk, nch * _CK)
    return w[:cout, :, :cin].reshape(cout, k, k, cin)


def conv_small_int8_tapped_plain(x, wq, sw, k: int = 5, gb: int = 16):
    """Plain PyTorch version of the kernel's schedule: the same quantisation
    as `conv_small_int8_plain`, then the integer sum taken as the kernel
    takes it, one k32 step (32 input channels at one tap, a shifted window
    of the zero-padded map) at a time, in the order of the packed weights
    (unpacked from `pack_conv_small_int8_weights`), exact in int64."""
    b, cin = x.shape[:2]
    cout = wq.shape[0]
    q, scale = _quantized(x, gb)
    q = q.to(torch.int64)
    w = unpack_conv_small_int8_weights(pack_conv_small_int8_weights(wq), cout, k, cin).to(torch.int64)
    r = k // 2
    qp = F.pad(q, (r, r, r, r))  # (B, Cin, 8 + 2r, 8 + 2r)
    z = torch.zeros(b, cout, 8, 8, dtype=torch.int64)
    for c0 in range(0, cin, _CK):
        for tap in range(k * k):
            dy, dx = divmod(tap, k)
            win = qp[:, c0:c0 + _CK, dy:dy + 8, dx:dx + 8]  # (B, 32, 8, 8)
            z += torch.einsum("bcyx,oc->boyx", win, w[:, dy, dx, c0:c0 + _CK])
    return (z.float() * (scale * sw.float().view(1, -1, 1, 1))).to(x.dtype)


def conv_small_int8(x, wq, sw, k: int = 5, gb: int = 16, packed=None):
    """int8 KxK same-pad conv of 8x8 maps; see `conv_small_int8_plain`.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/conv_small_int8.cu` or raises. `packed`, which a CUDA call
    needs: the weights as `pack_conv_small_int8_weights(wq)` gives them,
    packed once by the caller for all its calls with these weights (the
    ConvLSTM packs them once a forward).
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
    if k not in (1, 3, 5, 7):
        raise ValueError(f"conv_small_int8: k={k} not supported (the kernel takes k odd, <= 7)")
    if wq.shape != (cout, k, k, cin) or wq.dtype != torch.int8:
        raise ValueError(f"conv_small_int8: wq {tuple(wq.shape)} {wq.dtype}, "
                         f"want ({cout}, {k}, {k}, {cin}) int8")
    if cout % 8 or sw.shape != (cout,) or sw.dtype != torch.float32:
        raise ValueError(f"conv_small_int8: Cout={cout} must be a multiple of 8 "
                         f"and sw ({cout},) f32, got {tuple(sw.shape)} {sw.dtype}")
    if not conv_small_int8_supports(x.shape, wq.shape, k):
        raise ValueError(f"conv_small_int8: x {tuple(x.shape)}, wq {tuple(wq.shape)} not supported")
    if not (x.is_contiguous() and sw.is_contiguous()):
        raise ValueError("conv_small_int8: x and sw must be contiguous")
    if wq.device != x.device or sw.device != x.device:
        raise ValueError("conv_small_int8: all tensors must be on x's device")
    nch = -(-cin // _CK)
    shape = (-(-cout // _BM), -(-nch * k * k // _SL), 2, _BM, 128)
    if packed is None:
        raise ValueError("conv_small_int8: a CUDA call takes the weights packed, "
                         "packed=pack_conv_small_int8_weights(wq)")
    if (tuple(packed.shape) != shape or packed.dtype != torch.int8 or packed.device != x.device
            or not packed.is_contiguous()):
        raise ValueError(f"conv_small_int8: packed weights {tuple(packed.shape)} {packed.dtype}, "
                         f"want {shape} int8, contiguous, on x's device")
    if packed.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("conv_small_int8: x and the packed weights must be 16-byte aligned")
    gb = _chunk(b, gb)
    p = 8 + k - 1
    bp = -(-b // _IMG) * _IMG  # the last CTA's images past B are zero maps
    amax = torch.zeros(b // gb, dtype=torch.int32, device=x.device)  # float bits, for atomicMax
    q = torch.empty(bp * p * p * nch * _CK, dtype=torch.int8, device=x.device)
    out = torch.empty((b, cout, 8, 8), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().conv_small_int8(
        x.data_ptr(), packed.data_ptr(), sw.data_ptr(), amax.data_ptr(), q.data_ptr(),
        out.data_ptr(), b, cin, cout, k, gb, _DTYPES[x.dtype], stream,
    )
    build.check(err, "conv_small_int8")
    conv_small_int8.launches += 1
    return out


conv_small_int8.launches = 0
