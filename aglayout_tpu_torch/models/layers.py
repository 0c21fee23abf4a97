"""Torch layers that compute in a chosen dtype, the residual block and the
average pools.

Port of `aglayout_tpu/models/layers.py`. Each layer keeps torch's own
weight layout and default initialisation, so the reference's `state_dict`
loads as it is: Conv2d (O, I, kh, kw), ConvTranspose2d (I, O, kh, kw),
Linear (out, in), Embedding (n, d). Parameters stay f32; like the JAX
layers, a layer casts its input and weights to `dtype` (when given) and
computes in it.

The JAX ConvTranspose2d stores a flipped forward-conv HWIO kernel; here it
is torch's transposed-conv weight, and `utils/jax_import.py` converts.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aglayout_tpu_torch.models.norms import MaskedBatchNorm


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                        self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 2, padding: int = 1, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                                  self.stride, self.padding)


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Embedding(nn.Embedding):
    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype | None = None):
        super().__init__(num_embeddings, features)
        self.compute_dtype = dtype

    def forward(self, ids):
        y = F.embedding(ids, self.weight)
        return y.to(self.compute_dtype or y.dtype)


class ResidualBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + identity skip
    (reference models/generator_obj_att.py:47-60; keys main.{0,1,3,4}); in
    training mode its BNs take the batch's statistics over B x 8 x 8."""

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.main = nn.Sequential(
            Conv2d(features, features, 3, padding=1, bias=False, dtype=dtype),
            MaskedBatchNorm(features, dtype=dtype),
            nn.ReLU(),
            Conv2d(features, features, 3, padding=1, bias=False, dtype=dtype),
            MaskedBatchNorm(features, dtype=dtype),
        )

    def forward(self, x):
        return x + self.main(x)


def adaptive_avg_pool(x, out_hw: int):
    """AdaptiveAvgPool2d to out_hw x out_hw for an integer ratio (exact), NCHW."""
    h, w = x.shape[-2:]
    if h == out_hw and w == out_hw:
        return x
    if h % out_hw or w % out_hw:
        raise ValueError(f"adaptive_avg_pool: {(h, w)} is not a multiple of {out_hw}")
    return F.avg_pool2d(x, (h // out_hw, w // out_hw))
