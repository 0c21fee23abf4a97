"""Spectrally normalised conv and linear layers, with torch's semantics.

Port of `aglayout_tpu/models/sn.py`. The reference wraps every conv and
linear of the three discriminators in `nn.utils.spectral_norm`; these
layers keep its legacy names, so the reference's `state_dict` loads as it
is: parameters `weight_orig` ((O, I, kh, kw) or (out, in)) and `bias`,
buffers `weight_u` (O) and `weight_v` (I kh kw).

  * the weight is viewed as the (O, I kh kw) matrix `weight_orig.view(O, -1)`,
    whose (in, kh, kw) order is JAX's fan-in order;
  * `forward(x, update_stats=True)` first takes one power iteration on the
    detached weight and writes it back to the buffers: v = normalize(W^T u),
    u = normalize(W v), each x / max(|x|, 1e-12); with `update_stats=False`
    the buffers are used as they are;
  * sigma = u^T W v with u and v constants, so gradients flow through W,
    sigma included; the weight (not the output) is divided by sigma, cast
    to the compute dtype and applied.

`update_stats` is the JAX package's cadence (once a discriminator phase),
not `nn.utils.spectral_norm`'s, which advances at every training forward.
Parameters stay f32; with `dtype` given, a layer casts its input and its
normalised weight to it, as `models/layers.py` does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-12


def _l2n(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=_EPS)


class _SpectralNorm(nn.Module):
    """The parameters, buffers and power iteration both layers share."""

    def __init__(self, weight_shape, bias: bool, dtype: torch.dtype | None):
        super().__init__()
        out_dim, fan_in = weight_shape[0], int(torch.Size(weight_shape[1:]).numel())
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        self.register_buffer("weight_u", torch.empty(out_dim))
        self.register_buffer("weight_v", torch.empty(fan_in))
        self.compute_dtype = dtype
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """weight_orig and bias uniform within 1 / sqrt(fan_in) (torch's and
        JAX's `torch_uniform_init`), u and v normalised normals, drawn from
        `generator` (torch's global one when None)."""
        bound = 1.0 / self.weight_v.numel() ** 0.5  # weight_v has the fan-in
        for t in (self.weight_orig, self.bias):
            if t is not None:
                t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)
        for t in (self.weight_u, self.weight_v):
            t.copy_(_l2n(torch.randn(t.shape, generator=generator)))

    def normalized_weight(self, update_stats: bool):
        """weight_orig / sigma, after one power iteration with `update_stats`."""
        w = self.weight_orig.view(self.weight_orig.shape[0], -1)
        if update_stats:
            with torch.no_grad():
                v = _l2n(w.t() @ self.weight_u)
                u = _l2n(w @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        # clones: a later update writes the buffers in place, and autograd
        # keeps u and v for this call's backward
        u, v = self.weight_u.clone(), self.weight_v.clone()
        sigma = torch.dot(u, w @ v)
        return self.weight_orig / sigma

    def _cast(self, x):
        dt = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), dt, bias


class SNConv2d(_SpectralNorm):
    """Spectrally normalised Conv2d (torch Conv2d + spectral_norm); NCHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__((out_channels, in_channels, kernel_size, kernel_size), bias, dtype)
        self.stride, self.padding = stride, padding

    def forward(self, x, update_stats: bool = True):
        w = self.normalized_weight(update_stats)
        x, dt, bias = self._cast(x)
        return F.conv2d(x, w.to(dt), bias, self.stride, self.padding)


class SNLinear(_SpectralNorm):
    """Spectrally normalised Linear (torch Linear + spectral_norm)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__((out_features, in_features), bias, dtype)

    def forward(self, x, update_stats: bool = True):
        w = self.normalized_weight(update_stats)
        x, dt, bias = self._cast(x)
        return F.linear(x, w.to(dt), bias)
