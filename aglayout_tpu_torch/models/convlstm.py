"""ConvLSTM layout fusion over the object axis.

Port of `aglayout_tpu/models/convlstm.py`: the `lax.scan` becomes a Python
loop over the O object slots. All layers advance within one timestep, and
an invalid slot carries h and c through unchanged, so the final state is
the reference's state after its last real object. The 5x5 gate conv is
`F.conv2d`, as the JAX package leaves it to XLA, except under the opt-in
`int8_serving`, where a wide cell's conv goes through
`ops/conv8_int8.conv_small_int8`: the CUDA kernel for CUDA tensors where
`ConvLSTMCell.int8_route` says it takes the shapes, its plain version
otherwise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from aglayout_tpu_torch.models.layers import Conv2d
from aglayout_tpu_torch.ops.conv8_int8 import (
    conv_small_int8,
    conv_small_int8_plain,
    conv_small_int8_supports,
    conv_small_int8_takes_weights,
    pack_conv_small_int8_weights,
)
from aglayout_tpu_torch.ops.int8 import quantize_conv_weights

# the int8 gate conv engages only at or above this cin * cout (JAX
# `convlstm._INT8_MIN_CINCOUT`): at the published widths only layer 0,
# 640 -> 512; 192 -> 256 and 128 -> 256 stay dense
_INT8_MIN_CINCOUT = 512 * 512


class ConvLSTMCell(nn.Module):
    """conv(cat(x, h)) -> gates in the reference's order i, f, o, g
    (models/generator_obj_att.py:99-114).

    int8_serving: a cell with cin * cout >= _INT8_MIN_CINCOUT runs its conv
    in int8 (approximate: dynamic activation scales, per-channel weight
    scales, exact integer sums); the bias is added after the dequantised
    conv, in its output dtype. Eval only.
    """

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 5,
                 int8_serving: bool = False, use_int8_kernel: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.int8_serving = int8_serving
        self.use_int8_kernel = use_int8_kernel
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim, kernel_size,
                           padding=kernel_size // 2, dtype=dtype)

    @property
    def int8_engaged(self) -> bool:
        """Whether this cell's gate conv takes the int8 route."""
        conv = self.conv
        return self.int8_serving and conv.in_channels * conv.out_channels >= _INT8_MIN_CINCOUT

    def int8_route(self, inp) -> str:
        """The int8 gate conv of an engaged cell on its input inp = cat(x,
        h) (B, Cin, H, W): "kernel" in eval mode where `conv_small_int8`'s
        kernel takes the shapes and dtype (`use_int8_kernel` on), else
        "plain" (`conv_small_int8_plain`). A pure function of shapes: the
        caller takes the kernel for CUDA tensors only."""
        conv = self.conv
        k = conv.kernel_size[0]
        wq_shape = (conv.out_channels, k, k, conv.in_channels)
        if (not self.training and self.use_int8_kernel and inp.dtype in (torch.bfloat16, torch.float32)
                and conv_small_int8_supports(tuple(inp.shape), wq_shape, k)):
            return "kernel"
        return "plain"

    def quantized_weights(self):
        """(wq, sw, wp) of the gate conv under the int8 route, else None. wp
        is wq packed for the kernel (`pack_conv_small_int8_weights`) where
        the kernel can run: CUDA weights of a shape it takes, with
        `use_int8_kernel` on, in eval mode; else None. They do not change over the object
        slots: `LayoutFuser` takes them once a forward."""
        if not self.int8_engaged:
            return None
        wq, sw = quantize_conv_weights(self.conv.weight)
        packs = (not self.training and self.use_int8_kernel and wq.is_cuda
                 and conv_small_int8_takes_weights(tuple(wq.shape), self.conv.kernel_size[0]))
        return wq, sw, pack_conv_small_int8_weights(wq) if packs else None

    def forward(self, x, h, c, quantized=None):
        inp = torch.cat([x, h], dim=1)
        if self.int8_engaged:
            k = self.conv.kernel_size[0]
            wq, sw, wp = quantized or self.quantized_weights()
            if inp.is_cuda and self.int8_route(inp) == "kernel":
                z = conv_small_int8(inp.contiguous(), wq, sw, k=k, packed=wp)
            else:
                z = conv_small_int8_plain(inp, wq, sw, k=k)
            z = z + self.conv.bias.to(z.dtype).view(1, -1, 1, 1)
        else:
            z = self.conv(inp)
        i, f, o, g = z.split(self.hidden_dim, dim=1)
        c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_next = torch.sigmoid(o) * torch.tanh(c_next)
        return h_next, c_next


class LayoutFuser(nn.Module):
    """Fuse (B, O, C, H, W) object features into (B, hidden[-1], H, W)."""

    def __init__(self, input_dim: int, hidden_dims: Tuple[int, ...] = (128, 64, 64),
                 kernel_size: int = 5, int8_serving: bool = False, use_int8_kernel: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.compute_dtype = dtype
        ins = (input_dim,) + self.hidden_dims[:-1]
        self.cell_list = nn.ModuleList(
            ConvLSTMCell(i, hd, kernel_size, int8_serving=int8_serving,
                         use_int8_kernel=use_int8_kernel, dtype=dtype)
            for i, hd in zip(ins, self.hidden_dims)
        )

    def forward(self, x, valid):
        b, o, _, h, w = x.shape
        dt = self.compute_dtype or x.dtype
        state = [
            (x.new_zeros((b, hd, h, w), dtype=dt), x.new_zeros((b, hd, h, w), dtype=dt))
            for hd in self.hidden_dims
        ]
        # the int8 weights, quantised and packed for the kernel once per
        # forward and not per slot (JAX leaves the hoisting to XLA)
        quantized = [cell.quantized_weights() for cell in self.cell_list]
        for t in range(o):
            m = valid[:, t].to(dt).view(b, 1, 1, 1)
            inp = x[:, t]
            for li, cell in enumerate(self.cell_list):
                hp, cp = state[li]
                h2, c2 = cell(inp, hp, cp, quantized[li])
                h2 = m * h2 + (1 - m) * hp
                c2 = m * c2 + (1 - m) * cp
                state[li] = (h2, c2)
                inp = h2
        return state[-1][0]
