"""Layout mask rasterization and the shift augmentation, on any device.

Port of `aglayout_tpu/ops/rasterize.py` (the reference's host-side
`data/vg_custom_mask.py:136-158`). Box edges are rounded half to even, as
Python's `round`, `jnp.round` and `torch.round` all do.
"""

from __future__ import annotations

import torch


def rasterize_boxes(boxes, height: int, width: int):
    """Normalized (x0, y0, x1, y1) boxes (..., 4) -> f32 masks (..., height,
    width): mask[y, x] = 1 iff round(y0 H) <= y < round(y1 H) and
    round(x0 W) <= x < round(x1 W), the half-open box of the reference's
    slicing."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    def inside(lo, hi, size):  # (..., size): round(lo size) <= i < round(hi size)
        i = torch.arange(size, dtype=boxes.dtype, device=boxes.device)
        return (i >= torch.round(lo * size)[..., None]) & (i < torch.round(hi * size)[..., None])

    row_in, col_in = inside(y0, y1, height), inside(x0, x1, width)
    return (row_in[..., :, None] & col_in[..., None, :]).float()


def shift_boxes(boxes):
    """The horizontal shift augmentation: a box narrower than 0.5 moves by
    0.8 times its larger border distance, toward the farther border; wide
    and centred boxes stay. boxes (..., 4) -> (..., 4)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    left, right = x0, 1.0 - x1
    zero = torch.zeros_like(x0)
    delta = torch.where(left > right, -left * 0.8, torch.where(right > left, right * 0.8, zero))
    delta = torch.where(x1 - x0 < 0.5, delta, zero)
    return torch.stack([x0 + delta, y0, x1 + delta, y1], dim=-1)
