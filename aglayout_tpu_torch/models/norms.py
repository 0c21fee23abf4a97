"""Eval-mode normalization layers: BN, class-conditional BN and SPADE.

Port of `aglayout_tpu/models/norms.py`, NCHW. The buffers and parameters
carry torch's own `BatchNorm` names (`weight`, `bias`, `running_mean`,
`running_var`, `num_batches_tracked`), so the reference's `state_dict`
loads as it is. Every layer normalises in f32 with the running statistics
and then casts to the compute dtype, as the JAX layers do. Train-mode
masked batch statistics are not ported yet: a layer in training mode
raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aglayout_tpu_torch.ops.spade_conv import class_expand, compact_to_flat


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the channel axis 1 of (N, C) or (N, C, H, W) input."""

    def __init__(self, features: int, affine: bool = True, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.features = features
        self.affine = affine
        self.eps = eps
        self.compute_dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def eval_affine(self):
        """(a, b) such that eval-mode BN(x) == a * x + b (per channel), f32."""
        a = torch.rsqrt(self.running_var + self.eps)
        b = -self.running_mean * a
        if self.affine:
            a = a * self.weight
            b = b * self.weight + self.bias
        return a, b

    def forward(self, x):
        if self.training:
            raise NotImplementedError("train-mode batch statistics are not ported yet")
        shape = (1, self.features) + (1,) * (x.ndim - 2)
        y = (x.float() - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + self.eps
        )
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(self.compute_dtype or x.dtype)


class ConditionalBatchNorm(nn.Module):
    """Affine-free BN + per-class affine from an embedding table
    (reference models/generator_obj_att.py:31-44)."""

    def __init__(self, features: int, num_classes: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.features = features
        self.bn = MaskedBatchNorm(features, affine=False, dtype=dtype)
        self.embed = nn.Embedding(num_classes, 2 * features)
        with torch.no_grad():  # scale half ~ N(1, 0.02), bias half 0
            self.embed.weight[:, :features].normal_(1.0, 0.02)
            self.embed.weight[:, features:].zero_()

    def eval_affine(self, y):
        """Per-row (a, b), each (N, C) f32, with CBN(x, y) == a * x + b."""
        a0, b0 = self.bn.eval_affine()
        gamma, beta = self.embed(y).chunk(2, dim=-1)
        return gamma * a0, gamma * b0 + beta

    def forward(self, x, y):
        out = self.bn(x)
        gamma, beta = self.embed(y).chunk(2, dim=-1)
        shape = gamma.shape + (1,) * (x.ndim - 2)
        return out * gamma.view(shape).to(out.dtype) + beta.view(shape).to(out.dtype)


# First-conv tap pattern per block-row class (top / interior / bottom):
# _R[class][delta + 1][dy] marks which 3x3 taps hit block offset delta.
_R = [
    [[1, 0, 0], [0, 1, 1], [0, 0, 0]],
    [[0, 0, 0], [1, 1, 1], [0, 0, 0]],
    [[0, 0, 0], [1, 1, 0], [0, 0, 1]],
]
# Second conv, per output class s: for dy in 0..2 the (first-conv class,
# block shift) that tap reads.
_TAP = {
    0: [(2, -1), (0, 0), (1, 0)],  # u%f==0: B(i-1), T(i), M(i)
    1: [(0, 0), (1, 0), (1, 0)],  # u%f==1
    2: [(1, 0), (1, 0), (1, 0)],  # interior
    3: [(1, 0), (1, 0), (2, 0)],  # u%f==f-2
    4: [(1, 0), (2, 0), (0, 1)],  # u%f==f-1: M, B, T(i+1)
}


class SPADE(nn.Module):
    """Spatially-adaptive denormalization on the 8x8 layout feature
    (reference models/spade/networks/normalization.py:66-108, batch norm,
    ks=3).

    For an upscale factor f >= 5 the nearest-upsampled segmap is block
    constant, so both mlp convs take one of 5 x 5 (row class, column class)
    values per block: `_block_class_grid` computes them exactly on the 8x8
    grid, and the full-resolution gamma/beta (or the folded tables that
    feed the RGB-head kernel) are gathered from them.
    """

    def __init__(self, norm_features: int, seg_features: int = 64, nhidden: int = 128,
                 dtype: torch.dtype | None = None):
        super().__init__()
        from aglayout_tpu_torch.models.layers import Conv2d

        self.norm_features = norm_features
        self.nhidden = nhidden
        self.compute_dtype = dtype
        self.param_free_norm = MaskedBatchNorm(norm_features, affine=False, dtype=dtype)
        self.mlp_shared = nn.Sequential(
            Conv2d(seg_features, nhidden, 3, padding=1, dtype=dtype), nn.ReLU()
        )
        self.mlp_gamma = Conv2d(nhidden, norm_features, 3, padding=1, dtype=dtype)
        self.mlp_beta = Conv2d(nhidden, norm_features, 3, padding=1, dtype=dtype)
        self.register_buffer("class_taps", torch.tensor(_R, dtype=torch.float32), persistent=False)

    def _block_class_grid(self, segmap):
        """Exact (gamma ++ beta) by (row class, col class) for an
        f-upsampled segmap, f >= 5: (B, h, w, 5, 5, 2C)."""
        b, cin, h, w = segmap.shape
        dt = self.compute_dtype or segmap.dtype
        seg = segmap.to(dt)
        nh = self.nhidden
        conv1 = self.mlp_shared[0]
        R = self.class_taps.to(dt)
        # class-aggregated first-conv kernels, output channels ordered (r, s, o)
        A = torch.einsum("rad,sbe,ocde->rsocab", R, R, conv1.weight.to(dt))
        v = F.conv2d(seg, A.reshape(9 * nh, cin, 3, 3), padding=1).view(b, 3, 3, nh, h, w)
        v = torch.relu(v + conv1.bias.to(dt).view(1, 1, 1, nh, 1, 1))

        # Second conv for all 25 class pairs at once: gather its 9 taps per
        # pair as views of the zero-padded first-conv output (a block shift
        # of -1/0/+1 is a slice), stack them once, and contract in one matmul.
        vp = F.pad(v, (1, 1, 1, 1)).permute(0, 4, 5, 1, 2, 3)  # (B, h+2, w+2, 3, 3, nh)
        taps = [
            vp[:, 1 + sy : 1 + sy + h, 1 + sx : 1 + sx + w, r, c]
            for s in range(5) for t in range(5)
            for r, sy in _TAP[s] for c, sx in _TAP[t]
        ]
        X = torch.stack(taps, dim=3).view(b, h, w, 25, 9 * nh)  # taps (dy, dx, k)
        w2 = torch.cat([self.mlp_gamma.weight, self.mlp_beta.weight]).to(dt)  # (2C, nh, 3, 3)
        w2 = w2.permute(2, 3, 1, 0).reshape(9 * nh, w2.shape[0])
        b2 = torch.cat([self.mlp_gamma.bias, self.mlp_beta.bias]).to(dt)
        return (X @ w2 + b2).view(b, h, w, 5, 5, -1)

    def folded_affine_tables_compact(self, segmap):
        """Per-pixel affine (A, B) with SPADE_eval(x) == x * A + B, folded
        with the parameter-free BN, at class resolution on both axes, for
        an f-upsampled segmap (f >= 5), as the 128^2 kernels read them
        (ops/spade_conv.py).

        Returns (A, B), each (B, h, 5, C, w*5): indexed by (row block, row
        class, channel, col block * 5 + col class). JAX's
        `folded_affine_tables_compact` holds the same values as
        (B/8, h, 5, w*5, 8, C), 8-image groups being a TPU layout.
        """
        G = self._block_class_grid(segmap)  # (B, h, w, 5r, 5c, 2C)
        b, h, w = G.shape[:3]
        T = G.permute(0, 1, 3, 5, 2, 4).reshape(b, h, 5, G.shape[-1], w * 5)
        gamma, beta = T.split(self.norm_features, dim=3)
        a0, b0 = self.param_free_norm.eval_affine()
        a0 = a0.to(gamma.dtype).view(-1, 1)
        b0 = b0.to(gamma.dtype).view(-1, 1)
        return a0 * (1 + gamma), b0 * (1 + gamma) + beta

    def folded_affine_tables(self, segmap, f: int):
        """The compact tables with their columns expanded to full
        resolution, for the 64^2 RGB-head kernel (ops/spade_conv.py).

        Returns (A, B), each (B, h, 5, C, w*f): indexed by (row block, row
        class, channel, full-resolution column).
        """
        return tuple(compact_to_flat(t, f) for t in self.folded_affine_tables_compact(segmap))

    def _gamma_beta_fused(self, segmap, f: int):
        """Exact full-resolution (gamma, beta), each (B, C, h*f, w*f), f >= 5."""
        G = self._block_class_grid(segmap)
        b, h, w = G.shape[:3]
        full = class_expand(class_expand(G, 3, f), 4, f)  # (B, h, w, f, f, 2C)
        full = full.permute(0, 5, 1, 3, 2, 4).reshape(b, G.shape[-1], h * f, w * f)
        return full.split(self.norm_features, dim=1)

    def forward(self, x, segmap):
        normalized = self.param_free_norm(x)
        h, w = segmap.shape[-2:]
        H, W = x.shape[-2:]
        if H % h == 0 and H // h >= 5 and W == H and w == h:
            gamma, beta = self._gamma_beta_fused(segmap, H // h)
            return normalized * (1 + gamma) + beta

        # classic path: nearest resize (torch F.interpolate 'nearest'), then conv
        if H % h == 0 and W % w == 0:
            seg = segmap.repeat_interleave(H // h, 2).repeat_interleave(W // w, 3)
        else:
            idx_h = (torch.arange(H, device=x.device) * h) // H
            idx_w = (torch.arange(W, device=x.device) * w) // W
            seg = segmap[:, :, idx_h][:, :, :, idx_w]
        actv = self.mlp_shared(seg)
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)
