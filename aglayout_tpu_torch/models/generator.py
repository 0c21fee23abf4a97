"""The layout-to-image generator, eval path at 64^2 and 128^2.

Port of `aglayout_tpu/models/generator.py`. Module and attribute names
follow the reference's `state_dict` keys (`layout_encoder.clstm.cell_list.0.conv`,
`layout_encoder.residual.0.main.0`, `decoder.spade_0.mlp_shared.0`, ...),
so a reference netG checkpoint loads with `load_state_dict`, and
`aglayout_tpu/utils/torch_import.py::import_generator` maps this model's
`state_dict` into the JAX trees.

Ported so far: eval-mode `Generator.generate` at 64^2 and 128^2. At 128^2
the layout encoder takes the typed c2/c3 algebra and the folded c4, and
the decoder the 2x upsample tail, as JAX's eval path does. The
CropEncoder holds its parameters, so the `state_dict` is the reference's
whole netG; its forward and train mode come later.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from aglayout_tpu_torch.config import Config
from aglayout_tpu_torch.models.convlstm import LayoutFuser
from aglayout_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    Embedding,
    Linear,
    ResidualBlock,
)
from aglayout_tpu_torch.models.norms import SPADE, ConditionalBatchNorm, MaskedBatchNorm
from aglayout_tpu_torch.ops.resblocks import residual_trunk
from aglayout_tpu_torch.ops.spade_conv import spade_apply8, spade_few_out_conv, spade_few_out_conv8
from aglayout_tpu_torch.ops.typed_expand import (
    typed_c3_expand,
    typed_c3_expand_plain,
    typed_c3_inputs_from_windows,
)

SIZES = (64, 128)  # the reference's two generators (train64.py, train128.py)


def clstm_hidden_dims(clstm_layers: int, conv_dim: int = 64) -> Tuple[int, ...]:
    """Hidden dims by layer count (reference generator_obj_att.py:459-464)."""
    cd = conv_dim
    return {1: (cd,), 2: (cd, cd), 3: (2 * cd, cd, cd)}[clstm_layers]


# ---------------------------------------------------------------------------
# Typed-eval geometry of the 128^2 layout encoder (JAX generator.py:53-139):
# every row and column of the c2 and c3 output grids of an object matches
# one of a few candidate patterns determined by its box edges;
# `typed_axis_coverage` proves it for every integer box edge. Indices are
# built on the device of the inputs.
# ---------------------------------------------------------------------------


def _tap_geometry(size: int, device=None):
    """(taps, inb, inbcode) for the stride-2 k4 window on the padded grid."""
    in_size = size + 2
    s2 = (in_size - 2) // 2 + 1
    taps = 2 * torch.arange(s2, device=device)[:, None] + torch.arange(4, device=device) - 1
    inb = (taps >= 0) & (taps < in_size)  # (s2, 4)
    pow2 = 2 ** torch.arange(4, device=device)
    return taps, inb, (inb * pow2).sum(-1)


def _rect_win(taps, lo, hi, size: int):
    """(..., s2, 4) bool: which taps land inside [round(lo*s), round(hi*s))."""
    t0 = torch.round(lo * size)[..., None, None]  # round half to even, as jnp.round
    t1 = torch.round(hi * size)[..., None, None]
    tt = taps.float() - 1.0  # original-grid coordinates
    return (tt >= t0) & (tt < t1)


def _first_match(code, cand):
    """For each entry of `code` (..., s), whether it equals one of the
    candidates' codes and the index of the first that does (0 if none)."""
    candcode = torch.take_along_dim(code, cand, dim=-1)
    eq = code[..., :, None] == candcode[..., None, :]
    # argmax takes the first maximum, as jnp.argmax; CUDA has no bool argmax
    return eq.any(-1), eq.to(torch.int32).argmax(-1)


def _axis_typing(rwin, inb, inbcode, lo, hi, size: int):
    """Type one axis of the c2 grid: 12 candidate rows covering every
    realized (inb, rect-window) pattern. Returns (sel, rwinK, inbK,
    covered); `covered` flags rows whose pattern matched a candidate."""
    s2 = rwin.shape[-2]
    pow2 = 2 ** torch.arange(4, device=rwin.device)
    code = (rwin * pow2).sum(-1) + 16 * inbcode  # (..., s2)
    yt = torch.floor((torch.round(lo * size) - 1.0) / 2.0)
    yb = torch.floor((torch.round(hi * size) - 1.0) / 2.0)
    ones = torch.ones_like(yt)
    cand = torch.stack([0 * ones, ones, yt - 1, yt, yt + 1, yt + 2,
                        yb - 1, yb, yb + 1, yb + 2, (s2 - 2) * ones, (s2 - 1) * ones], -1)
    cand = cand.clamp(0, s2 - 1).long()  # (..., 12)
    covered, sel = _first_match(code, cand)
    rwinK = torch.take_along_dim(rwin, cand[..., None], dim=-2)  # (..., 12, 4)
    return sel, rwinK, inb[cand], covered


def _axis_out_typing(sel, lo, hi, size: int, s2: int, s3: int):
    """Type the c3 output windows (4 input rows, stride 2, pad 1): 14
    candidates on the s3 grid. Returns (sel3, winK, covered)."""
    dev = sel.device
    src = 2 * torch.arange(s3, device=dev)[:, None] + torch.arange(4, device=dev) - 1
    selpad = F.pad(sel + 1, (1, 1))  # 0 = out of bounds
    win = selpad[..., (src + 1).clamp(0, s2 + 1)]  # (..., s3, 4) in 0..12
    code = (win * 13 ** torch.arange(4, device=dev)).sum(-1)
    yt = torch.floor((torch.floor((torch.round(lo * size) - 1.0) / 2.0) - 1.0) / 2.0)
    yb = torch.floor((torch.floor((torch.round(hi * size) - 1.0) / 2.0) - 1.0) / 2.0)
    ones = torch.ones_like(yt)
    cand = torch.stack([0 * ones, ones, yt - 1, yt, yt + 1, yt + 2, yt + 3,
                        yb - 1, yb, yb + 1, yb + 2, yb + 3, (s3 - 2) * ones, (s3 - 1) * ones], -1)
    cand = cand.clamp(0, s3 - 1).long()  # (..., 14)
    covered, sel3 = _first_match(code, cand)
    winK = torch.take_along_dim(win, cand[..., None], dim=-2)  # (..., 14, 4)
    return sel3, winK, covered


def typed_axis_coverage(size: int):
    """Exhaustive coverage check of the typed-eval candidates for one axis.

    The typing depends on the box only through its rounded integer edge
    coordinates, and rows and columns are typed independently, so every
    integer (lo, hi) edge pair in [0, size]^2 is a complete proof for one
    image size. Returns (covered_c2, covered_c3), each (n_pairs,) bool: all
    True iff no realizable pattern is uncovered.
    """
    taps, inb, inbcode = _tap_geometry(size)
    s2 = inb.shape[0]
    s3 = (s2 - 2) // 2 + 1
    grid = torch.arange(size + 1, dtype=torch.float32) / size
    lo = grid.repeat_interleave(size + 1)
    hi = grid.repeat(size + 1)
    rwin = _rect_win(taps, lo, hi, size)  # (P, s2, 4)
    sel, _, _, cov2 = _axis_typing(rwin, inb, inbcode, lo, hi, size)
    _, _, cov3 = _axis_out_typing(sel, lo, hi, size, s2, s3)
    return cov2.all(-1), cov3.all(-1)


class CropEncoder(nn.Module):
    """VAE encoder over object crops (reference generator_obj_att.py:367-422).
    Parameters only: its forward belongs to the train path, not ported yet."""

    def __init__(self, num_classes: int, z_dim: int, conv_dim: int = 64,
                 dtype: torch.dtype | None = None):
        super().__init__()
        d = conv_dim
        specs = [(3, d, 7, 1, 3), (d, 2 * d, 4, 2, 1), (2 * d, 4 * d, 4, 2, 1),
                 (4 * d, 8 * d, 4, 2, 1), (8 * d, 16 * d, 4, 2, 1)]
        for i, (cin, cout, k, s, p) in enumerate(specs):
            name = "conv5" if i == 4 else f"c{i + 1}"
            setattr(self, name, Conv2d(cin, cout, k, s, p, bias=False, dtype=dtype))
            setattr(self, f"bn{i + 1}", ConditionalBatchNorm(cout, num_classes, dtype=dtype))
        self.fc_mu = Linear(16 * d, z_dim, dtype=dtype)
        self.fc_logvar = Linear(16 * d, z_dim, dtype=dtype)

    def forward(self, *args):
        raise NotImplementedError("CropEncoder.forward comes with the train path")


class AttributeEncoder(nn.Module):
    """Class embedding + multi-hot attributes -> cd-dim object code
    (reference generator_obj_att.py:575-600)."""

    def __init__(self, num_classes: int, attribute_dim: int = 106, embedding_dim: int = 64,
                 conv_dim: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        cd = conv_dim
        self.embedding = Embedding(num_classes, embedding_dim, dtype=dtype)
        self.c0 = Linear(embedding_dim + attribute_dim, 2 * cd, dtype=dtype)
        self.bn0 = MaskedBatchNorm(2 * cd, dtype=dtype)
        self.c1 = Linear(2 * cd, cd, dtype=dtype)
        self.bn1 = MaskedBatchNorm(cd, dtype=dtype)
        self.c2 = Linear(cd, cd, dtype=dtype)

    def forward(self, objs, attribute):
        emb = self.embedding(objs)
        a = torch.cat([emb, attribute.to(emb.dtype)], dim=-1)
        a = torch.relu(self.bn0(self.c0(a)))
        a = torch.relu(self.bn1(self.c1(a)))
        return self.c2(a)


class LayoutEncoder(nn.Module):
    """Object codes + boxes -> (B, cd, 8, 8) layout feature
    (reference generator_obj_att.py:449-513)."""

    def __init__(self, num_classes: int, image_size: int = 64, conv_dim: int = 64,
                 resi_num: int = 6, clstm_dims: Tuple[int, ...] = (128, 64, 64),
                 z_dim: int = 64, use_trunk_kernel: bool = True, use_typed_kernel: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if image_size not in SIZES:
            raise ValueError(f"image_size {image_size} not in {SIZES}")
        d = conv_dim
        self.image_size = image_size
        self.conv_dim = d
        self.use_trunk_kernel = use_trunk_kernel
        self.use_typed_kernel = use_typed_kernel
        self.compute_dtype = dtype
        # the reference's c0 is a 1x1 conv with padding=1 (grows the map by 2)
        self.c0 = Conv2d(d + z_dim, d, 1, padding=1, bias=False, dtype=dtype)
        self.bn1 = ConditionalBatchNorm(d, num_classes, dtype=dtype)
        self.c2 = Conv2d(d, 2 * d, 4, 2, 1, bias=False, dtype=dtype)
        self.bn2 = ConditionalBatchNorm(2 * d, num_classes, dtype=dtype)
        self.c3 = Conv2d(2 * d, 4 * d, 4, 2, 1, bias=False, dtype=dtype)
        self.bn3 = ConditionalBatchNorm(4 * d, num_classes, dtype=dtype)
        self.c4 = Conv2d(4 * d, 8 * d, 4, 2, 1, bias=False, dtype=dtype)
        self.bn4 = ConditionalBatchNorm(8 * d, num_classes, dtype=dtype)
        self.clstm = LayoutFuser(8 * d, clstm_dims, dtype=dtype)
        self.residual = nn.ModuleList(
            ResidualBlock(clstm_dims[-1], dtype=dtype) for _ in range(resi_num)
        )

    def _fused_stage1(self, vec, boxes, objs):
        """Exact eval-mode broadcast + c0 + bn1 + relu + c2 on box masks
        (JAX `_fused_stage1`, eval branch).

        The c0 input plane of an object is its code inside its box and 0
        outside, so after c0, bn1 and relu it takes two constants, p inside
        and q outside (padding ring included); c2 then reduces to sums of
        its taps weighted by separable binary box windows.
        vec: (B, O, C0); boxes: (B, O, 4) normalized (x0, y0, x1, y1);
        objs: (B, O). Returns the c2 output (B*O, 2d, S2, S2).
        """
        b, o, _ = vec.shape
        size = self.image_size
        in_size = size + 2  # c0's padding=1
        out_size = (in_size + 2 - 4) // 2 + 1
        dt = self.compute_dtype or vec.dtype

        w0 = self.c0.weight[:, :, 0, 0].to(dt)  # (d, C0)
        wv = torch.einsum("bok,dk->bod", vec.to(dt), w0)
        a, bb = self.bn1.eval_affine(objs.reshape(-1))
        a = a.view(b, o, -1).to(dt)
        bb = bb.view(b, o, -1).to(dt)
        p = torch.relu(a * wv + bb)  # inside the box
        q = torch.relu(bb)  # outside the box

        w2 = self.c2.weight.to(dt)  # (2d, d, 4, 4)
        kq = torch.einsum("cdhw,bod->bohwc", w2, q)
        kp = torch.einsum("cdhw,bod->bohwc", w2, p - q)

        # tap coordinate in the padded (in_size) grid: t = 2*y + dy - 1
        dev = vec.device
        taps = 2 * torch.arange(out_size, device=dev)[:, None] + torch.arange(4, device=dev) - 1
        inb = ((taps >= 0) & (taps < in_size)).to(dt)  # (out, 4)

        def rect_win(lo, hi):  # box rows/cols [round(lo*size), round(hi*size)) of the image
            t0 = torch.round(lo * size)[..., None, None]
            t1 = torch.round(hi * size)[..., None, None]
            tt = taps.float() - 1.0
            return ((tt >= t0) & (tt < t1)).to(dt)  # (B, O, out, 4)

        rr = rect_win(boxes[..., 1], boxes[..., 3])
        cc = rect_win(boxes[..., 0], boxes[..., 2])
        tq = torch.einsum("yh,bohwc->boywc", inb, kq)  # (B, O, Y, 4, 2d)
        tp = torch.einsum("boyh,bohwc->boywc", rr, kp)
        out = torch.einsum("xw,boywc->bocyx", inb, tq) + torch.einsum("boxw,boywc->bocyx", cc, tp)
        return out.reshape(b * o, -1, out_size, out_size)

    def _trunk(self, h):
        if self.use_trunk_kernel and h.is_cuda and len(self.residual) and h.shape[-2:] == (8, 8):
            blocks = [blk.main for blk in self.residual]
            w1 = torch.stack([m[0].weight for m in blocks])
            w2 = torch.stack([m[3].weight for m in blocks])
            ab1 = torch.stack([torch.stack(m[1].eval_affine()) for m in blocks])
            ab2 = torch.stack([torch.stack(m[4].eval_affine()) for m in blocks])
            dt = self.compute_dtype or h.dtype
            return residual_trunk(h.to(dt).contiguous(), w1, w2, ab1, ab2)
        for block in self.residual:
            h = block(h)
        return h

    def _typed_c2c3_eval(self, vec, boxes, objs):
        """Exact eval [broadcast -> c0 -> bn1 -> relu -> c2 -> bn2 -> relu ->
        c3 -> bn3 -> relu] by row and column type algebra (JAX
        `_typed_c2c3_eval`); the per-object c2 map never exists.

        The c0 output plane is a two-constant rectangle (see
        `_fused_stage1`), so every row of the c2 output matches one of 12
        patterns and likewise every column: the c2 map is
        z2[row_type, col_type, :] on a 12 x 12 type grid. The 4-row windows
        of c3 are typed again (14 types per axis), and
        `ops/typed_expand.typed_c3_expand` computes c3, bn3 and relu on the
        types and expands them. Returns (B*O, 4d, S3, S3).
        """
        b, o, _ = vec.shape
        d, size = self.conv_dim, self.image_size
        s2 = (size + 2 - 2) // 2 + 1
        s3 = (s2 - 2) // 2 + 1
        n = b * o
        objs_f = objs.reshape(-1)
        dt = self.compute_dtype or vec.dtype

        # stage-1 constants (the algebra of _fused_stage1)
        w0 = self.c0.weight[:, :, 0, 0].to(dt)
        wv = torch.einsum("bok,dk->bod", vec.to(dt), w0)
        a1, b1 = self.bn1.eval_affine(objs_f)
        a1 = a1.view(b, o, -1).to(dt)
        b1 = b1.view(b, o, -1).to(dt)
        p = torch.relu(a1 * wv + b1)  # inside the box
        q = torch.relu(b1)  # outside the box
        w2 = self.c2.weight.to(dt)  # (2d, d, 4, 4)
        kq = torch.einsum("cdhw,bod->bohwc", w2, q)
        kp = torch.einsum("cdhw,bod->bohwc", w2, p - q)

        # rows (y) and columns (x) are typed by the same algebra, stacked on axis 0
        taps, inb, inbcode = _tap_geometry(size, vec.device)
        lo2 = torch.stack([boxes[..., 1], boxes[..., 0]])  # (2, B, O)
        hi2 = torch.stack([boxes[..., 3], boxes[..., 2]])
        rc = _rect_win(taps, lo2, hi2, size)  # (2, B, O, s2, 4)
        sel2ax, rcK, inbK2, _ = _axis_typing(rc, inb, inbcode, lo2, hi2, size)
        rcK, inbK2 = rcK.to(dt), inbK2.to(dt)

        # c2 values on the 12 x 12 type grid, bn2 affine + relu
        V2 = (torch.einsum("bokh,bolw,bohwc->boklc", inbK2[0], inbK2[1], kq)
              + torch.einsum("bokh,bolw,bohwc->boklc", rcK[0], rcK[1], kp))  # (B, O, 12, 12, 2d)
        a2, b2 = self.bn2.eval_affine(objs_f)
        z2 = torch.relu(a2.view(b, o, 1, 1, -1).to(dt) * V2 + b2.view(b, o, 1, 1, -1).to(dt))

        # the c3 output windows (4 input rows, stride 2, pad 1), typed
        sel3ax, winK2, _ = _axis_out_typing(sel2ax, lo2, hi2, size, s2, s3)
        idxR = torch.where(winK2[0] > 0, winK2[0] - 1, 12)  # (B, O, 14, 4); 12 = zero row
        inputs = typed_c3_inputs_from_windows(
            idxR.reshape(n, 14, 4), winK2[1].reshape(n, 14, 4),
            sel3ax[0].reshape(n, s3), sel3ax[1].reshape(n, s3),
        )
        a3, b3 = self.bn3.eval_affine(objs_f)
        ab = torch.stack([a3, b3], 1).float()  # (n, 2, 4d)
        expand = typed_c3_expand if self.use_typed_kernel and vec.is_cuda else typed_c3_expand_plain
        return expand(z2.reshape(n, 12, 12, 2 * d).contiguous(), *inputs, ab, self.c3.weight)

    def _c4_fold(self, h, objs_f):
        """Exact eval fold of [c4 (k4 s2 p1) -> bn4 affine -> 2x2 avgpool]
        into one k6 s4 p1 conv whose kernel is the 2x2-shift average of c4's
        (the pool commutes with the affine), then the bn4 affine (JAX
        generator.py:543-562)."""
        k4 = self.c4.weight
        k6 = sum(F.pad(k4, (2 * v, 2 - 2 * v, 2 * u, 2 - 2 * u)) for u in (0, 1) for v in (0, 1))
        dt = h.dtype
        h = F.conv2d(h, (0.25 * k6).to(dt), stride=4, padding=1)
        a4, b4 = self.bn4.eval_affine(objs_f)
        return h * a4[:, :, None, None].to(dt) + b4[:, :, None, None].to(dt)

    def forward(self, objs_att, valid, z, objs, boxes):
        # objs_att: (B, O, cd); valid, objs: (B, O); z: (B, O, z_dim); boxes: (B, O, 4)
        b, o = objs_att.shape[:2]
        objs_f = objs.reshape(-1)
        vec = torch.cat([objs_att, z.to(objs_att.dtype)], dim=-1)
        if self.image_size == 128:
            # the typed algebra and the c4 fold (JAX's eval path at 128^2; at
            # 64^2 the dense c3 is cheaper there)
            h = self._c4_fold(self._typed_c2c3_eval(vec, boxes, objs), objs_f)
        else:
            h = self._fused_stage1(vec, boxes, objs)
            h = torch.relu(self.bn2(h, objs_f))
            h = torch.relu(self.bn3(self.c3(h), objs_f))
            h = self.bn4(self.c4(h), objs_f)  # no relu (reference :504-509)
        h = self.clstm(h.view(b, o, *h.shape[1:]), valid)
        return self._trunk(h)


class GlobalEncoder(nn.Module):
    """8x8 layout feature -> global context vector (reference :425-446)."""

    def __init__(self, in_dim: int = 64, dim: int = 128, dtype: torch.dtype | None = None):
        super().__init__()
        self.c1 = Conv2d(in_dim, dim, 4, 2, 1, bias=False, dtype=dtype)
        self.bn1 = MaskedBatchNorm(dim, dtype=dtype)
        self.c2 = Conv2d(dim, dim, 4, 2, 1, bias=False, dtype=dtype)

    def forward(self, h):
        h = torch.relu(self.bn1(self.c1(h)))
        return self.c2(h).sum(dim=(2, 3))


class Decoder(nn.Module):
    """Layout feature + global vector -> raw RGB output, (B, 3, S, S), no
    tanh (reference generator_obj_att.py:516-572, and at 128^2 the 2x
    upsample tail of generator_obj_att128.py:542-604). Every SPADE is
    conditioned on the 8x8 layout feature itself."""

    def __init__(self, image_size: int = 64, conv_dim: int = 64,
                 use_head_kernel: bool = True, use_apply_kernel: bool = True,
                 use_head8_kernel: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        if image_size not in SIZES:
            raise ValueError(f"image_size {image_size} not in {SIZES}")
        d = conv_dim
        self.image_size = image_size
        self.use_head_kernel = use_head_kernel
        self.use_apply_kernel = use_apply_kernel
        self.use_head8_kernel = use_head8_kernel
        spade_kw = dict(seg_features=d, nhidden=2 * d, dtype=dtype)
        self.c0_new = Conv2d(3 * d, 4 * d, 3, padding=1, bias=False, dtype=dtype)
        self.spade_0 = SPADE(4 * d, **spade_kw)
        self.dc1 = ConvTranspose2d(4 * d, 4 * d, 4, 2, 1, bias=False, dtype=dtype)
        self.spade_1 = SPADE(4 * d, **spade_kw)
        self.dc2 = ConvTranspose2d(4 * d, 2 * d, 4, 2, 1, bias=False, dtype=dtype)
        self.spade_2 = SPADE(2 * d, **spade_kw)
        self.dc3 = ConvTranspose2d(2 * d, d, 4, 2, 1, bias=False, dtype=dtype)
        self.spade_3 = SPADE(d, **spade_kw)
        self.c4 = Conv2d(d, 3, 7, padding=3, bias=True, dtype=dtype)
        if image_size == 128:
            self.c5 = Conv2d(3, 2 * d, 7, padding=3, bias=False, dtype=dtype)
            self.spade_4 = SPADE(2 * d, **spade_kw)
            self.c6 = Conv2d(2 * d, 2 * d, 5, padding=2, bias=False, dtype=dtype)
            self.spade_5 = SPADE(2 * d, **spade_kw)
            self.c7 = Conv2d(2 * d, 3, 7, padding=3, bias=True, dtype=dtype)

    @staticmethod
    def _factor(h, seg):
        """The upscale factor f of h over seg where the class-table kernels
        take it (f >= 5, h exactly f times seg on both axes), else 0."""
        f = h.shape[-1] // seg.shape[-1]
        return f if f >= 5 and h.shape[-2:] == (f * seg.shape[-2], f * seg.shape[-1]) else 0

    def _head(self, spade, conv, h, seg):
        """The c4 head, conv(relu(SPADE(h, seg))): K2 on flat tables for CUDA
        tensors, the dense composition otherwise."""
        f = self._factor(h, seg)
        if self.use_head_kernel and h.is_cuda and f:
            a_tab, b_tab = spade.folded_affine_tables(seg, f)
            return spade_few_out_conv(
                h.contiguous(), a_tab.to(h.dtype).contiguous(), b_tab.to(h.dtype).contiguous(),
                conv.weight, conv.bias, f,
            )
        return conv(torch.relu(spade(h, seg)))

    def _head8(self, spade, conv, h, seg):
        """The c7 head at 128^2: K3 on compact tables for CUDA tensors, the
        dense composition otherwise. (JAX routes each head by its TPU
        tiling gate, C % 128 == 0, which at the published widths sends c4
        to K2 and c7 to K3; the port routes by head, at any width.)"""
        f = self._factor(h, seg)
        if self.use_head8_kernel and h.is_cuda and f:
            a_tab, b_tab = spade.folded_affine_tables_compact(seg)
            return spade_few_out_conv8(
                h.contiguous(), a_tab.to(h.dtype).contiguous(), b_tab.to(h.dtype).contiguous(),
                conv.weight, conv.bias, f,
            )
        return conv(torch.relu(spade(h, seg)))

    def _spade_relu(self, spade, h, seg):
        """relu(SPADE(h, seg)): K4 on compact tables for CUDA tensors, the
        dense SPADE otherwise."""
        f = self._factor(h, seg)
        if self.use_apply_kernel and h.is_cuda and f:
            a_tab, b_tab = spade.folded_affine_tables_compact(seg)
            return spade_apply8(h.contiguous(), a_tab.to(h.dtype).contiguous(),
                                b_tab.to(h.dtype).contiguous(), f)
        return torch.relu(spade(h, seg))

    def forward(self, hidden, global_h):
        seg = hidden  # (B, cd, 8, 8)
        g = global_h[:, :, None, None].expand(-1, -1, *hidden.shape[-2:])
        h = self.c0_new(torch.cat([hidden, g.to(hidden.dtype)], dim=1))
        h = torch.relu(self.spade_0(h, seg))
        h = torch.relu(self.spade_1(self.dc1(h), seg))
        h = torch.relu(self.spade_2(self.dc2(h), seg))
        h = self._head(self.spade_3, self.c4, self.dc3(h), seg)
        if self.image_size == 64:
            return h
        # 128: nearest 2x upsample of the 64^2 RGB, then refine
        h = self.c5(F.interpolate(h, scale_factor=2, mode="nearest"))
        h = self.c6(self._spade_relu(self.spade_4, h, seg))
        return self._head8(self.spade_5, self.c7, h, seg)


class Generator(nn.Module):
    """The generator (reference models/generator_obj_att.py:603-647)."""

    def __init__(self, num_classes: int, attribute_dim: int = 106, embedding_dim: int = 64,
                 z_dim: int = 64, image_size: int = 64, object_size: int = 32,
                 clstm_layers: int = 3, resi_num: int = 6, conv_dim: int = 64,
                 use_trunk_kernel: bool = True, use_head_kernel: bool = True,
                 use_typed_kernel: bool = True, use_apply_kernel: bool = True,
                 use_head8_kernel: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        cd = conv_dim
        self.object_size = object_size
        self.crop_encoder = CropEncoder(num_classes, z_dim, conv_dim=cd, dtype=dtype)
        self.layout_encoder = LayoutEncoder(
            num_classes, image_size=image_size, conv_dim=cd, resi_num=resi_num,
            clstm_dims=clstm_hidden_dims(clstm_layers, cd), z_dim=z_dim,
            use_trunk_kernel=use_trunk_kernel, use_typed_kernel=use_typed_kernel, dtype=dtype,
        )
        self.decoder = Decoder(
            image_size, cd, use_head_kernel=use_head_kernel, use_apply_kernel=use_apply_kernel,
            use_head8_kernel=use_head8_kernel, dtype=dtype,
        )
        self.global_encoder = GlobalEncoder(cd, 2 * cd, dtype=dtype)
        self.attribute_encoder = AttributeEncoder(
            num_classes, attribute_dim, embedding_dim, conv_dim=cd, dtype=dtype
        )

    @torch.no_grad()
    def generate(self, objs, boxes, valid, z, attribute):
        """Layout -> image, eval mode (JAX `Generator.generate` with masks=None).

        objs: (B, O) int; boxes: (B, O, 4) normalized; valid: (B, O);
        z: (B, O, z_dim); attribute: (B, O, attribute_dim).
        Returns the raw decoder output (B, H, W, 3).
        """
        if self.training:
            raise NotImplementedError("generate runs in eval mode; call .eval() first")
        b, o = objs.shape
        att = self.attribute_encoder(objs.reshape(-1), attribute.reshape(b * o, -1))
        h = self.layout_encoder(att.view(b, o, -1), valid, z, objs, boxes)
        g = self.global_encoder(h)
        return self.decoder(h, g).permute(0, 2, 3, 1)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter with torch's default initialisers from
    `generator`, and give every BN non-trivial running statistics and
    affines, so that a seeded model exercises the eval affines."""

    def uniform_(t, fan_in):
        bound = 1.0 / fan_in ** 0.5
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)

    def normal_(t, mean, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std + mean)

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            k = mod.weight[0, 0].numel()
            fan_in = (mod.weight.shape[1] * k if isinstance(mod, nn.ConvTranspose2d)
                      else mod.weight[0].numel())
            uniform_(mod.weight, fan_in)
            if mod.bias is not None:
                uniform_(mod.bias, fan_in)
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.0, 1.0)
        elif isinstance(mod, MaskedBatchNorm):
            normal_(mod.running_mean, 0.0, 0.1)
            mod.running_var.copy_(0.5 + torch.rand(mod.features, generator=generator))
            if mod.affine:
                normal_(mod.weight, 1.0, 0.1)
                normal_(mod.bias, 0.0, 0.1)
    for mod in model.modules():  # CBN tables: scale half ~ N(1, 0.02), bias half 0
        if isinstance(mod, ConditionalBatchNorm):
            c = mod.features
            normal_(mod.embed.weight[:, :c], 1.0, 0.02)
            mod.embed.weight[:, c:].zero_()
    return model


def build_generator(cfg: Config, device, seed: int | None = None) -> Generator:
    """The eval-mode generator of `cfg` on `device` (the counterpart of the
    JAX `train/state.py::Models`), with weights drawn from `seed`
    (default `cfg.seed`); load a checkpoint over them with `load_state_dict`."""
    model = Generator(
        num_classes=cfg.num_classes,
        attribute_dim=cfg.attribute_dim,
        embedding_dim=cfg.embedding_dim,
        z_dim=cfg.z_dim,
        image_size=cfg.image_size,
        object_size=cfg.object_size,
        clstm_layers=cfg.clstm_layers,
        resi_num=cfg.resi_num,
        conv_dim=cfg.conv_dim,
        use_trunk_kernel=cfg.use_trunk_kernel,
        use_head_kernel=cfg.use_head_kernel,
        use_typed_kernel=cfg.use_typed_kernel,
        use_apply_kernel=cfg.use_apply_kernel,
        use_head8_kernel=cfg.use_head8_kernel,
        dtype=torch.bfloat16 if cfg.bf16 else None,
    )
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return init_weights(model, gen).to(device).eval()
