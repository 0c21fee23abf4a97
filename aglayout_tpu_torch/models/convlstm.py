"""ConvLSTM layout fusion over the object axis.

Port of `aglayout_tpu/models/convlstm.py`: the `lax.scan` becomes a Python
loop over the O object slots. All layers advance within one timestep, and
an invalid slot carries h and c through unchanged, so the final state is
the reference's state after its last real object. The 5x5 gate conv stays
`F.conv2d`, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from aglayout_tpu_torch.models.layers import Conv2d


class ConvLSTMCell(nn.Module):
    """conv(cat(x, h)) -> gates in the reference's order i, f, o, g
    (models/generator_obj_att.py:99-114)."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim, kernel_size,
                           padding=kernel_size // 2, dtype=dtype)

    def forward(self, x, h, c):
        z = self.conv(torch.cat([x, h], dim=1))
        i, f, o, g = z.split(self.hidden_dim, dim=1)
        c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_next = torch.sigmoid(o) * torch.tanh(c_next)
        return h_next, c_next


class LayoutFuser(nn.Module):
    """Fuse (B, O, C, H, W) object features into (B, hidden[-1], H, W)."""

    def __init__(self, input_dim: int, hidden_dims: Tuple[int, ...] = (128, 64, 64),
                 kernel_size: int = 5, dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.compute_dtype = dtype
        ins = (input_dim,) + self.hidden_dims[:-1]
        self.cell_list = nn.ModuleList(
            ConvLSTMCell(i, hd, kernel_size, dtype=dtype) for i, hd in zip(ins, self.hidden_dims)
        )

    def forward(self, x, valid):
        b, o, _, h, w = x.shape
        dt = self.compute_dtype or x.dtype
        state = [
            (x.new_zeros((b, hd, h, w), dtype=dt), x.new_zeros((b, hd, h, w), dtype=dt))
            for hd in self.hidden_dims
        ]
        for t in range(o):
            m = valid[:, t].to(dt).view(b, 1, 1, 1)
            inp = x[:, t]
            for li, cell in enumerate(self.cell_list):
                hp, cp = state[li]
                h2, c2 = cell(inp, hp, cp)
                h2 = m * h2 + (1 - m) * hp
                c2 = m * c2 + (1 - m) * cp
                state[li] = (h2, c2)
                inp = h2
        return state[-1][0]
