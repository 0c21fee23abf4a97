"""Differentiable bilinear ROI crops as two small matmuls a crop, NCHW.

Port of `aglayout_tpu/ops/bilinear.py` (the reference's `models/bilinear.py`,
whose executed backend is `F.grid_sample` with `align_corners=True` and
zero padding). A crop of a (C, H, W) map is R_y @ map @ R_x^T, with R_y
(out_h, H) and R_x (out_w, W) interpolation matrices of at most two
non-zeros a row, the bilinear corner weights:

  * box (x0, y0, x1, y1) in [0, 1] image coordinates;
  * sample positions linspace(x0, x1, out_w) * (W - 1), the same for y;
  * a corner outside the map contributes zero.

The products run in f32 for bf16 and f32 maps (JAX promotes a bf16 map
against its f32 matrices; f64 maps stay f64) and with TF32 off on the
card, as JAX pins `precision=HIGHEST` there.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _full_f32():
    """cuBLAS f32 products without TF32 for the body (the crops' matmuls)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _unit_linspace(steps: int, device, dtype=torch.float32) -> torch.Tensor:
    """linspace(0, 1, steps) as jnp.linspace computes it: i * (1 / (steps -
    1)), the last point exactly 1."""
    if steps == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    t = torch.arange(steps, dtype=dtype, device=device)
    # a Python scalar and a fill, not host-to-device copies: the same bits
    t = t * (1.0 / (steps - 1))
    t[-1:].fill_(1.0)
    return t


def tensor_linspace(start, end, steps: int):
    """out[..., i] interpolates start..end inclusive: start * (1 - t) + end * t
    with t = linspace(0, 1, steps) (the reference's `tensor_linspace`)."""
    t = _unit_linspace(steps, start.device, start.dtype)
    return start[..., None] * (1.0 - t) + end[..., None] * t


def interp_matrix(lo, hi, steps: int, size: int):
    """The (..., steps, size) bilinear interpolation matrix of one axis: row
    i holds the weights of position linspace(lo, hi, steps)[i] * (size - 1),
    a corner outside [0, size - 1] weighted zero."""
    coord = tensor_linspace(lo, hi, steps) * (size - 1)
    i0 = torch.floor(coord)
    w1 = coord - i0
    w0 = 1.0 - w1
    i1 = i0 + 1.0
    in0 = (i0 >= 0) & (i0 <= size - 1)
    in1 = (i1 >= 0) & (i1 <= size - 1)
    eye0 = F.one_hot(i0.clamp(0, size - 1).long(), size).to(coord.dtype)
    eye1 = F.one_hot(i1.clamp(0, size - 1).long(), size).to(coord.dtype)
    return (w0 * in0)[..., None] * eye0 + (w1 * in1)[..., None] * eye1


def crop_bbox(feats, boxes, out_h: int, out_w: int | None = None):
    """One box a map: feats (N, C, H, W), boxes (N, 4) -> (N, C, out_h, out_w),
    f32 (f64 for f64 maps)."""
    out_w = out_w or out_h
    h, w = feats.shape[-2:]
    dt = torch.promote_types(feats.dtype, torch.float32)
    x0, y0, x1, y1 = boxes.to(dt).unbind(-1)
    ry = interp_matrix(y0, y1, out_h, h)  # (N, out_h, H)
    rx = interp_matrix(x0, x1, out_w, w)  # (N, out_w, W)
    with _full_f32():
        tmp = torch.einsum("nyh,nchw->ncyw", ry, feats.to(dt))
        return torch.einsum("ncyw,nxw->ncyx", tmp, rx)


def crop_bbox_dense(feats, boxes, out_h: int, out_w: int | None = None):
    """O boxes from each of B maps (the dense layout): feats (B, C, H, W),
    boxes (B, O, 4) -> (B, O, C, out_h, out_w), f32 (f64 for f64 maps).
    Padded slots give crops that their consumers mask out."""
    out_w = out_w or out_h
    h, w = feats.shape[-2:]
    dt = torch.promote_types(feats.dtype, torch.float32)
    x0, y0, x1, y1 = boxes.to(dt).unbind(-1)
    ry = interp_matrix(y0, y1, out_h, h)  # (B, O, out_h, H)
    rx = interp_matrix(x0, x1, out_w, w)  # (B, O, out_w, W)
    with _full_f32():
        tmp = torch.einsum("boyh,bchw->bocyw", ry, feats.to(dt))
        return torch.einsum("bocyw,boxw->bocyx", tmp, rx)


def uncrop_bbox(feats, boxes, out_h: int, out_w: int | None = None, fill_value: float = 0.0):
    """The inverse of `crop_bbox`: paste each crop into its box on a canvas.
    feats (N, C, hh, ww) crops, boxes (N, 4) -> (N, C, out_h, out_w), f32
    (f64 for f64 crops). Canvas pixel (y, x) samples the crop at ((x/W -
    x0)/w, (y/H - y0)/h), crop coordinate t * size with both corners clamped
    into the crop (the reference's `uncrop_bbox`, bilinear.py:139-191); a
    box of zero width or height divides by 1; pixels outside the box take
    `fill_value`."""
    out_w = out_w or out_h
    hh, ww = feats.shape[-2:]
    dt = torch.promote_types(feats.dtype, torch.float32)
    boxes = boxes.to(dt)
    x0, y0 = boxes[:, 0], boxes[:, 1]
    bw, bh = boxes[:, 2] - x0, boxes[:, 3] - y0
    one = torch.ones((), dtype=dt, device=boxes.device)
    xs = _unit_linspace(out_w, boxes.device, dt)
    ys = _unit_linspace(out_h, boxes.device, dt)
    u = (xs[None, :] - x0[:, None]) / torch.where(bw == 0, one, bw)[:, None]  # (N, W)
    v = (ys[None, :] - y0[:, None]) / torch.where(bh == 0, one, bh)[:, None]  # (N, H)

    def axis_matrix(t, size):
        coord = t * size
        f = torch.floor(coord)
        i0 = f.clamp(0, size - 1)
        i1 = (i0 + 1).clamp(0, size - 1)
        w1 = coord - f
        eye0 = F.one_hot(i0.long(), size).to(dt)
        eye1 = F.one_hot(i1.long(), size).to(dt)
        return (1.0 - w1)[..., None] * eye0 + w1[..., None] * eye1

    ry = axis_matrix(v, hh)  # (N, out_h, hh)
    rx = axis_matrix(u, ww)  # (N, out_w, ww)
    with _full_f32():
        out = torch.einsum("nyh,nchw->ncyw", ry, feats.to(dt))
        out = torch.einsum("ncyw,nxw->ncyx", out, rx)
    inside = (((u >= 0) & (u <= 1))[:, None, None, :]
              & ((v >= 0) & (v <= 1))[:, None, :, None])
    return torch.where(inside, out, torch.as_tensor(fill_value, dtype=dt, device=out.device))


def crop_bbox_flat(feats, boxes, box_to_feat, out_h: int, out_w: int | None = None):
    """The reference's flat call (`crop_bbox_batch(feats, bbox, bbox_to_feats,
    HH)`): feats (N, C, H, W), boxes (M, 4), box_to_feat (M,) the map of each
    box -> (M, C, out_h, out_w) in the boxes' order."""
    return crop_bbox(feats[torch.as_tensor(box_to_feat, device=feats.device).long()], boxes,
                     out_h, out_w)
