"""Typed c3 of the 128^2 layout encoder, its bn3 affine + relu and the
expansion to the dense c3 output, in one kernel launch.

Port of `aglayout_tpu/ops/pallas_typed_expand.py::typed_c3_expand_v4` and
its adapter `typed_c3_inputs_from_windows`. `LayoutEncoder._typed_c2c3_eval`
(models/generator.py) types every row and column of an object's c2 output
by its box: the c2 map of an object is z2[row_type, col_type, :] on a
12 x 12 type grid, and the 4-row windows of c3 take one of 14 types per
axis. Per object, with w3 the (c4, c2, 4, 4) c3 weight:

    W3z[a, l, w, C] = sum_{h, c} z2[idxR[a, h], l, c] * w3[C, c, h, w]
    V3[a, b, C]     = relu(a3[C] * sum_w W3z[a, lsel[b, w], w, C] + b3[C])
    out[C, y, x]    = V3[selR[y], selC[x], C]

idxR == 12 and lsel >= 12 stand for taps outside the image (zero).
`csrc/typed_c3_expand.cu` runs all of it per object without writing W3z or
V3 to device memory.

Numerics, the same in the kernel and in `typed_c3_expand_plain` (and the
Pallas kernel's): W3z from compute-dtype operands, products summed in f32,
rounded to the compute dtype; the sum over w in f32, the affine and relu
in f32, V3 rounded to the compute dtype; the expansion copies.
"""

from __future__ import annotations

import torch

from aglayout_tpu_torch.kernels import build

NA = 14  # window types per axis on the c3 output grid
NZ = 12  # c2 types per axis
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
_CHUNK = {torch.bfloat16: 32, torch.float32: 8}  # output channels per chunk in the kernel


def typed_c3_inputs_from_windows(idxR, winKC, sel3R, sel3C):
    """The generator's window arrays -> the kernel's int32 inputs: winKC in
    0..13 with 0 = out of bounds -> lsel in 0..13 with 13 = out of bounds."""
    lsel = torch.where(winKC > 0, winKC - 1, NZ + 1).to(torch.int32)
    return idxR.to(torch.int32), lsel, sel3R.to(torch.int32), sel3C.to(torch.int32)


def typed_c3_expand_plain(z2, idxR, lsel, selR, selC, ab, weight):
    """Plain PyTorch version of the kernel.

    z2: (n, 12, 12, c2) in the compute dtype; idxR, lsel: (n, 14, 4) int;
    selR, selC: (n, s3) int; ab: (n, 2, c4) f32 bn3 eval affine (a, b);
    weight: (c4, c2, 4, 4) torch c3 weight. Returns (n, c4, s3, s3) in z2's
    dtype.
    """
    n, _, _, c2 = z2.shape
    c4 = weight.shape[0]
    dt, dev = z2.dtype, z2.device
    ar = torch.arange(n, device=dev)
    # row gather, with a zero row 12: Z1[n, a, h, l, c] = z2[n, idxR[n, a, h], l, c]
    z2p = torch.cat([z2, z2.new_zeros(n, 1, NZ, c2)], 1)
    Z1 = z2p[ar[:, None, None], idxR.long()]  # (n, a, h, l, c)
    z1t = Z1.permute(0, 1, 3, 2, 4).reshape(n * NA * NZ, 4 * c2)  # rows (n, a, l), cols (h, c)
    w3t = weight.to(dt).permute(2, 1, 3, 0).reshape(4 * c2, 4 * c4)  # rows (h, c), cols (w, C)
    W3z = (z1t.float() @ w3t.float()).to(dt)
    # column windows as a one-hot product over (l, w), zero for lsel >= 12
    hc = lsel.long()[..., None] == torch.arange(NZ, device=dev)  # (n, b, w, l)
    hc = hc.permute(0, 1, 3, 2).reshape(n, NA, NZ * 4).float()
    w3z = W3z.view(n, NA, NZ, 4, c4).permute(0, 2, 3, 1, 4).reshape(n, NZ * 4, NA * c4)
    V = torch.bmm(hc, w3z.float()).view(n, NA, NA, c4)  # (n, b, a, C)
    V3 = torch.relu(V * ab[:, None, None, 0] + ab[:, None, None, 1]).to(dt)
    out = V3[ar[:, None, None], selC.long()[:, None, :], selR.long()[:, :, None]]  # (n, y, x, C)
    return out.permute(0, 3, 1, 2).contiguous()


def typed_c3_expand(z2, idxR, lsel, selR, selC, ab, weight):
    """Typed c3 + bn3 affine + relu + expansion; see `typed_c3_expand_plain`
    for the contract (int inputs int32 here).

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/typed_c3_expand.cu` or raises; the launch itself refuses a c2 whose
    grid and weight tiles exceed a block's shared memory (c2 > 160 in bf16).
    """
    if z2.device.type == "cpu":
        return typed_c3_expand_plain(z2, idxR, lsel, selR, selC, ab, weight)
    if z2.device.type != "cuda":
        raise ValueError(f"typed_c3_expand: unsupported device {z2.device}")
    if z2.dtype not in _DTYPES:
        raise ValueError(f"typed_c3_expand: dtype {z2.dtype} not supported")
    n, c2 = z2.shape[0], z2.shape[-1]
    c4, s3 = weight.shape[0], selR.shape[-1]
    if z2.shape != (n, NZ, NZ, c2) or c2 % 16:
        raise ValueError(f"typed_c3_expand: z2 shape {tuple(z2.shape)} not supported")
    if weight.shape != (c4, c2, 4, 4) or c4 % _CHUNK[z2.dtype]:
        raise ValueError(f"typed_c3_expand: weight shape {tuple(weight.shape)} not supported")
    if idxR.shape != (n, NA, 4) or lsel.shape != (n, NA, 4):
        raise ValueError(f"typed_c3_expand: window shapes {tuple(idxR.shape)}, {tuple(lsel.shape)}")
    if selR.shape != (n, s3) or selC.shape != (n, s3) or s3 % 8:
        raise ValueError(f"typed_c3_expand: selector shapes {tuple(selR.shape)}, {tuple(selC.shape)}")
    if ab.shape != (n, 2, c4) or ab.dtype != torch.float32:
        raise ValueError(f"typed_c3_expand: ab must be (n, 2, c4) f32, got {tuple(ab.shape)} {ab.dtype}")
    for t in (idxR, lsel, selR, selC):
        if t.dtype != torch.int32:
            raise ValueError("typed_c3_expand: window and selector inputs must be int32")
    for t in (z2, idxR, lsel, selR, selC, ab):
        if not t.is_contiguous():
            raise ValueError("typed_c3_expand: inputs must be contiguous")
    for t in (idxR, lsel, selR, selC, ab, weight):
        if t.device != z2.device:
            raise ValueError("typed_c3_expand: all tensors must be on z2's device")
    if z2.data_ptr() % 16:
        raise ValueError("typed_c3_expand: z2 must be 16-byte aligned (the kernel's vector loads)")
    wk = weight.to(z2.dtype).permute(0, 3, 2, 1).contiguous()  # (C, w, h, c)
    out = torch.empty((n, c4, s3, s3), dtype=z2.dtype, device=z2.device)
    stream = torch.cuda.current_stream(z2.device).cuda_stream
    err = build.library().typed_c3_expand(
        z2.data_ptr(), idxR.data_ptr(), lsel.data_ptr(), selR.data_ptr(), selC.data_ptr(),
        ab.data_ptr(), wk.data_ptr(), out.data_ptr(), n, c2, c4, s3, _DTYPES[z2.dtype], stream,
    )
    build.check(err, "typed_c3_expand")
    typed_c3_expand.launches += 1
    return out


typed_c3_expand.launches = 0
