"""int8 weights for the int8 serving kernels, and the exact integer conv
their plain versions share.

Port of `quantize_conv_weights` in
`aglayout_tpu/ops/pallas_spade_c6_int8.py`: per-output-channel symmetric
int8 quantisation of a conv weight. The port's weights are torch's
(O, I, K, K); the quantised weight comes back as (O, K, K, I), input
channel last, which is the k-contiguous B operand the int8 tensor-core
kernels (`csrc/conv_small_int8.cu`, `csrc/spade_c6_int8.cu`) read. JAX
holds the same values as (K, K, I, O).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quantize_conv_weights(w):
    """(O, I, K, K) float weight -> (wq (O, K, K, I) int8, scales (O,) f32)
    with w ~= wq * scales[o]: scales = max(max|w[o]|, 1e-12) / 127, wq =
    clip(round_half_even(w / scales), -127, 127)."""
    w = w.float()
    absmax = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
    scales = absmax / torch.full_like(absmax, 127.0)  # a true division, see symmetric_scales
    wq = torch.round(w / scales[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), scales


def symmetric_scales(m):
    """(127 / m', m' / 127) with m' = max(m, 1e-8): the quantising factor and
    the dequantising scale of activations whose absolute maximum is m.

    Both are IEEE f32 divisions between tensors, as the kernels and JAX
    compute them. torch turns `scalar / tensor`, and on CUDA `tensor /
    scalar`, into a product with a reciprocal, whose last bit can differ and
    move a value across a rounding step.
    """
    m = m.clamp_min(1e-8)
    c = torch.full_like(m, 127.0)
    return c / m, m / c


def int8_conv_exact(q, wq):
    """Exact same-pad conv of integer-valued q (B, I, H, W) with int8 wq
    (O, K, K, I): (B, O, H, W) float64, every value an exact integer.

    An im2col in float64 times the weight matrix: a sum of K*K*I products
    below 2^14 stays far below 2^53, so the order of summation cannot
    change it (float32 could not hold it: 25 * 640 * 127^2 > 2^24). Images
    go in groups so that one im2col stays near 2 GB at the serving shapes.
    """
    b, i, h, w = q.shape
    o, k = wq.shape[:2]
    r = k // 2
    qp = F.pad(q.permute(0, 2, 3, 1).double(), (0, 0, r, r, r, r))  # (B, H+2r, W+2r, I)
    wf = wq.reshape(o, k * k * i).double().t()  # rows (dy, dx, ci)
    step = max(1, 2 ** 28 // (h * w * k * k * i))
    out = []
    for b0 in range(0, b, step):
        im = torch.cat([qp[b0:b0 + step, dy:dy + h, dx:dx + w]
                        for dy in range(k) for dx in range(k)], dim=-1)
        out.append(im.reshape(-1, k * k * i) @ wf)
    return torch.cat(out).reshape(b, h, w, o).permute(0, 3, 1, 2)
