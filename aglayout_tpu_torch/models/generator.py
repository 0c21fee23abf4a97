"""The layout-to-image generator, eval path at 64^2.

Port of `aglayout_tpu/models/generator.py`. Module and attribute names
follow the reference's `state_dict` keys (`layout_encoder.clstm.cell_list.0.conv`,
`layout_encoder.residual.0.main.0`, `decoder.spade_0.mlp_shared.0`, ...),
so a reference netG checkpoint loads with `load_state_dict`, and
`aglayout_tpu/utils/torch_import.py::import_generator` maps this model's
`state_dict` into the JAX trees.

Ported so far: eval-mode `Generator.generate` at 64^2 (the JAX package's
default `image_size`). The CropEncoder holds its parameters, so the
`state_dict` is the reference's whole netG; its forward, train mode and
the 128^2 tail come later.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

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
from aglayout_tpu_torch.ops.spade_conv import spade_few_out_conv


def clstm_hidden_dims(clstm_layers: int, conv_dim: int = 64) -> Tuple[int, ...]:
    """Hidden dims by layer count (reference generator_obj_att.py:459-464)."""
    cd = conv_dim
    return {1: (cd,), 2: (cd, cd), 3: (2 * cd, cd, cd)}[clstm_layers]


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
                 z_dim: int = 64, use_trunk_kernel: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        d = conv_dim
        self.image_size = image_size
        self.conv_dim = d
        self.use_trunk_kernel = use_trunk_kernel
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

    def forward(self, objs_att, valid, z, objs, boxes):
        # objs_att: (B, O, cd); valid, objs: (B, O); z: (B, O, z_dim); boxes: (B, O, 4)
        b, o = objs_att.shape[:2]
        objs_f = objs.reshape(-1)
        vec = torch.cat([objs_att, z.to(objs_att.dtype)], dim=-1)
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
    """Layout feature + global vector -> raw c4 output, (B, 3, 64, 64), no
    tanh (reference generator_obj_att.py:516-572). Every SPADE is
    conditioned on the 8x8 layout feature itself."""

    def __init__(self, image_size: int = 64, conv_dim: int = 64,
                 use_head_kernel: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        if image_size != 64:
            raise NotImplementedError("the 128^2 decoder tail is not ported yet")
        d = conv_dim
        self.use_head_kernel = use_head_kernel
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

    def _head(self, spade, conv, h, seg):
        """conv(relu(SPADE(h, seg))): the fused kernel for CUDA tensors with
        an upscale factor f >= 5, the dense composition otherwise."""
        f = h.shape[-1] // seg.shape[-1]
        if (self.use_head_kernel and h.is_cuda and f >= 5
                and h.shape[-2:] == (f * seg.shape[-2], f * seg.shape[-1])):
            a_tab, b_tab = spade.folded_affine_tables(seg, f)
            return spade_few_out_conv(
                h.contiguous(), a_tab.to(h.dtype).contiguous(), b_tab.to(h.dtype).contiguous(),
                conv.weight, conv.bias, f,
            )
        return conv(torch.relu(spade(h, seg)))

    def forward(self, hidden, global_h):
        seg = hidden  # (B, cd, 8, 8)
        g = global_h[:, :, None, None].expand(-1, -1, *hidden.shape[-2:])
        h = self.c0_new(torch.cat([hidden, g.to(hidden.dtype)], dim=1))
        h = torch.relu(self.spade_0(h, seg))
        h = torch.relu(self.spade_1(self.dc1(h), seg))
        h = torch.relu(self.spade_2(self.dc2(h), seg))
        return self._head(self.spade_3, self.c4, self.dc3(h), seg)


class Generator(nn.Module):
    """The generator (reference models/generator_obj_att.py:603-647)."""

    def __init__(self, num_classes: int, attribute_dim: int = 106, embedding_dim: int = 64,
                 z_dim: int = 64, image_size: int = 64, object_size: int = 32,
                 clstm_layers: int = 3, resi_num: int = 6, conv_dim: int = 64,
                 use_trunk_kernel: bool = True, use_head_kernel: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if image_size != 64:
            raise NotImplementedError("only the 64^2 generator is ported yet")
        cd = conv_dim
        self.object_size = object_size
        self.crop_encoder = CropEncoder(num_classes, z_dim, conv_dim=cd, dtype=dtype)
        self.layout_encoder = LayoutEncoder(
            num_classes, image_size=image_size, conv_dim=cd, resi_num=resi_num,
            clstm_dims=clstm_hidden_dims(clstm_layers, cd), z_dim=z_dim,
            use_trunk_kernel=use_trunk_kernel, dtype=dtype,
        )
        self.decoder = Decoder(image_size, cd, use_head_kernel=use_head_kernel, dtype=dtype)
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
        dtype=torch.bfloat16 if cfg.bf16 else None,
    )
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return init_weights(model, gen).to(device).eval()
