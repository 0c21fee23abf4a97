"""The layout encoder's eval-mode residual trunk in one kernel launch.

Port of `aglayout_tpu/ops/pallas_resblocks.py::residual_trunk`. After the
ConvLSTM, the (B, C, 8, 8) layout feature runs through R residual blocks
[conv3x3 -> BN affine -> relu -> conv3x3 -> BN affine] + skip. At serving
shapes each conv is tiny, so as separate launches the trunk is some 40
small kernels; `csrc/residual_trunk.cu` runs all of it in one launch, one
CTA per image.

Numerics, the same in the kernel and in `residual_trunk_plain`:
  - conv inputs and weights in the compute dtype (h's dtype), products
    accumulated in f32;
  - BN eval affine and relu in f32;
  - the skip chain in f32 across all blocks, rounded to the compute dtype
    only as the next conv's input;
  - output f32.
The dense `ResidualBlock` loop instead rounds the skip to the compute dtype
after every block; in f32 the two agree to rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aglayout_tpu_torch.kernels import build

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def residual_trunk_plain(h, w1, w2, ab1, ab2):
    """Plain PyTorch version of the kernel: 12 convs with affines.

    h: (B, C, 8, 8) in the compute dtype; w1, w2: (R, C, C, 3, 3) torch
    conv weights per block; ab1, ab2: (R, 2, C) f32 BN eval affines (a, b).
    Returns (B, C, 8, 8) f32.
    """
    cd = h.dtype
    x = h.float()

    def conv(v, w):  # compute-dtype operands, f32 accumulation
        return F.conv2d(v.to(cd).float(), w.to(cd).float(), padding=1)

    for r in range(w1.shape[0]):
        t = torch.relu(conv(x, w1[r]) * ab1[r, 0].view(1, -1, 1, 1) + ab1[r, 1].view(1, -1, 1, 1))
        x = x + (conv(t, w2[r]) * ab2[r, 0].view(1, -1, 1, 1) + ab2[r, 1].view(1, -1, 1, 1))
    return x


def residual_trunk(h, w1, w2, ab1, ab2):
    """Fused eval residual trunk; see `residual_trunk_plain` for the contract.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/residual_trunk.cu` or raises.
    """
    if h.device.type == "cpu":
        return residual_trunk_plain(h, w1, w2, ab1, ab2)
    if h.device.type != "cuda":
        raise ValueError(f"residual_trunk: unsupported device {h.device}")
    b, c, hh, ww = h.shape
    r = w1.shape[0]
    if h.dtype not in _DTYPES:
        raise ValueError(f"residual_trunk: dtype {h.dtype} not supported")
    if (hh, ww) != (8, 8) or c % 4 or not 4 <= c <= 256:
        raise ValueError(f"residual_trunk: input shape {tuple(h.shape)} not supported")
    if not h.is_contiguous():
        raise ValueError("residual_trunk: h must be contiguous")
    if w1.shape != (r, c, c, 3, 3) or w2.shape != w1.shape:
        raise ValueError(f"residual_trunk: weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}")
    if ab1.shape != (r, 2, c) or ab2.shape != ab1.shape:
        raise ValueError(f"residual_trunk: affine shapes {tuple(ab1.shape)}, {tuple(ab2.shape)}")
    for t in (w1, w2, ab1, ab2):
        if t.device != h.device:
            raise ValueError("residual_trunk: all tensors must be on h's device")
    smem = (2 * c * 100 + 9 * c * c) * h.element_size()
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"residual_trunk: C={c} needs {smem} bytes of shared memory")
    # (R, Cout, Cin, 3, 3) -> (R, 3, 3, Cin, Cout): per tap, a Cin x Cout matrix
    wm1 = w1.to(h.dtype).permute(0, 3, 4, 2, 1).contiguous()
    wm2 = w2.to(h.dtype).permute(0, 3, 4, 2, 1).contiguous()
    ab1 = ab1.float().contiguous()
    ab2 = ab2.float().contiguous()
    out = torch.empty((b, c, 8, 8), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = build.library().residual_trunk(
        h.data_ptr(), wm1.data_ptr(), wm2.data_ptr(), ab1.data_ptr(), ab2.data_ptr(),
        out.data_ptr(), b, c, r, _DTYPES[h.dtype], stream,
    )
    build.check(err, "residual_trunk")
    residual_trunk.launches += 1
    return out


residual_trunk.launches = 0
