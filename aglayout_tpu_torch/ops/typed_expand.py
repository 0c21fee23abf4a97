"""Typed c3 of the 128^2 layout encoder, its bn3 affine + relu and the
expansion to the dense c3 output, in one kernel launch.

Port of `aglayout_tpu/ops/pallas_typed_expand.py`: `typed_c3_expand` here
is its `typed_c3_expand_v4`, with the adapter
`typed_c3_inputs_from_windows`. `LayoutEncoder._typed_c2c3_eval`
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

The JAX module's other three kernels are three more schedules of the same
function, each a kernel of its own here:
  * `typed_c3_expand_v3` (`csrc/typed_c3_expand_v3.cu`): the zero-padded
    (n, 13, 13, c2) grid, a group of objects per block sharing one chunk of
    the c3 weights; an op no model path calls, as in JAX;
  * `typed_c3_expand_v5` (`csrc/typed_c3_expand_v5.cu`): W3z of all objects
    as one GEMM through a device scratch, then one pass for the rest;
  * `typed_c3_expand_v6` (`csrc/typed_c3_expand.cu`, the same kernel on
    another schedule): W3z only for the row types an object's output rows
    have, their rows compacted, so that a warpgroup without any skips the
    product and the epilogue sums and expands those types alone.
`Config.typed_c3` ("v4", "v5", "v6"; JAX reads `AGL_TYPED_C3`) picks the
one `LayoutEncoder._typed_c2c3_eval` launches (`VARIANTS`).

Numerics, the same in every kernel and plain version (and the Pallas
kernels'): W3z from compute-dtype operands, products summed in f32,
rounded to the compute dtype; the sum over w in f32, the affine and relu
in f32, V3 rounded to the compute dtype; the expansion copies.
"""

from __future__ import annotations

import torch

from aglayout_tpu_torch.kernels import build

NA = 14  # window types per axis on the c3 output grid
NZ = 12  # c2 types per axis
NL = 13  # c2 types per axis of the zero-padded grid `typed_c3_expand_v3` takes
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
_CHUNK = {torch.bfloat16: 32, torch.float32: 8}  # output channels per chunk in the kernel
_CHUNK_V5 = {torch.bfloat16: 64, torch.float32: 64}  # ... in stage 2 of `csrc/typed_c3_expand_v5.cu`


def typed_c3_inputs_from_windows(idxR, winKC, sel3R, sel3C):
    """The generator's window arrays -> the kernel's int32 inputs: winKC in
    0..13 with 0 = out of bounds -> lsel in 0..13 with 13 = out of bounds."""
    lsel = torch.where(winKC > 0, winKC - 1, NZ + 1).to(torch.int32)
    return idxR.to(torch.int32), lsel, sel3R.to(torch.int32), sel3C.to(torch.int32)


def _typed_plain(zrows, idxR, lsel, selR, selC, ab, weight):
    """The shared arithmetic of the plain versions. zrows: (n, R, L, c2), the
    type grid whose row idxR selects (a zero row included where idxR can
    name one); lsel outside [0, L) adds zero."""
    n, _, nl, c2 = zrows.shape
    c4 = weight.shape[0]
    dt, dev = zrows.dtype, zrows.device
    ar = torch.arange(n, device=dev)
    # row gather: Z1[n, a, h, l, c] = zrows[n, idxR[n, a, h], l, c]
    Z1 = zrows[ar[:, None, None], idxR.long()]  # (n, a, h, l, c)
    z1t = Z1.permute(0, 1, 3, 2, 4).reshape(n * NA * nl, 4 * c2)  # rows (n, a, l), cols (h, c)
    w3t = weight.to(dt).permute(2, 1, 3, 0).reshape(4 * c2, 4 * c4)  # rows (h, c), cols (w, C)
    W3z = (z1t.float() @ w3t.float()).to(dt)
    # column windows as a one-hot product over (l, w), zero for lsel outside [0, L)
    hc = lsel.long()[..., None] == torch.arange(nl, device=dev)  # (n, b, w, l)
    hc = hc.permute(0, 1, 3, 2).reshape(n, NA, nl * 4).float()
    w3z = W3z.view(n, NA, nl, 4, c4).permute(0, 2, 3, 1, 4).reshape(n, nl * 4, NA * c4)
    V = torch.bmm(hc, w3z.float()).view(n, NA, NA, c4)  # (n, b, a, C)
    V3 = torch.relu(V * ab[:, None, None, 0] + ab[:, None, None, 1]).to(dt)
    out = V3[ar[:, None, None], selC.long()[:, None, :], selR.long()[:, :, None]]  # (n, y, x, C)
    return out.permute(0, 3, 1, 2).contiguous()


def typed_c3_expand_plain(z2, idxR, lsel, selR, selC, ab, weight):
    """Plain PyTorch version of the kernel.

    z2: (n, 12, 12, c2) in the compute dtype; idxR, lsel: (n, 14, 4) int;
    selR, selC: (n, s3) int; ab: (n, 2, c4) f32 bn3 eval affine (a, b);
    weight: (c4, c2, 4, 4) torch c3 weight. Returns (n, c4, s3, s3) in z2's
    dtype.
    """
    n, _, _, c2 = z2.shape
    # a zero row 12 for the taps outside the image
    z2p = torch.cat([z2, z2.new_zeros(n, 1, NZ, c2)], 1)
    return _typed_plain(z2p, idxR, lsel, selR, selC, ab, weight)


def typed_c3_expand_v3_plain(z2p, idxR, lsel, selR, selC, ab, weight):
    """Plain PyTorch version of `typed_c3_expand_v3`: the function of
    `typed_c3_expand_plain` on the zero-padded grid.

    z2p: (n, 13, 13, c2), whose row 12 and column 12 the caller zeroed;
    idxR in [0, 13) and lsel in [0, 13) read them like any other row and
    column, and lsel == 13 alone stands for a tap outside the image.
    """
    return _typed_plain(z2p, idxR, lsel, selR, selC, ab, weight)


# v5 and v6 compute v4's function from v4's inputs; only the kernels'
# schedules differ.
typed_c3_expand_v5_plain = typed_c3_expand_plain
typed_c3_expand_v6_plain = typed_c3_expand_plain


def _check(name, z2, idxR, lsel, selR, selC, ab, weight, nl=NZ, c2_mult=16, chunk=_CHUNK):
    """Device, dtype, shape, contiguity and alignment checks shared by the
    four wrappers; returns (n, c2, c4, s3). nl: the grid's side; chunk: the
    kernel's output channels per chunk, by dtype."""
    if z2.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {z2.device}")
    if z2.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {z2.dtype} not supported")
    n, c2 = z2.shape[0], z2.shape[-1]
    c4, s3 = weight.shape[0], selR.shape[-1]
    if z2.shape != (n, nl, nl, c2) or c2 % c2_mult or n < 1:
        raise ValueError(f"{name}: z2 shape {tuple(z2.shape)} not supported")
    if weight.shape != (c4, c2, 4, 4) or c4 % chunk[z2.dtype]:
        raise ValueError(f"{name}: weight shape {tuple(weight.shape)} not supported")
    if idxR.shape != (n, NA, 4) or lsel.shape != (n, NA, 4):
        raise ValueError(f"{name}: window shapes {tuple(idxR.shape)}, {tuple(lsel.shape)}")
    if selR.shape != (n, s3) or selC.shape != (n, s3) or s3 % 8:
        raise ValueError(f"{name}: selector shapes {tuple(selR.shape)}, {tuple(selC.shape)}")
    if ab.shape != (n, 2, c4) or ab.dtype != torch.float32:
        raise ValueError(f"{name}: ab must be (n, 2, c4) f32, got {tuple(ab.shape)} {ab.dtype}")
    for t in (idxR, lsel, selR, selC):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: window and selector inputs must be int32")
    for t in (z2, idxR, lsel, selR, selC, ab):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in (idxR, lsel, selR, selC, ab, weight):
        if t.device != z2.device:
            raise ValueError(f"{name}: all tensors must be on z2's device")
    if z2.data_ptr() % 16:
        raise ValueError(f"{name}: z2 must be 16-byte aligned (the kernel's vector loads)")
    return n, c2, c4, s3


def typed_tc_smem(c2: int, c4: int, s3: int) -> int:
    """Bytes of shared memory of a block of the bf16 kernel of
    `csrc/typed_c3_expand.cu`, as its `tc::layout` computes them: the
    3-stage weight ring, the grid tile, W3z, V3, the row types, the output
    staging, the affine and the index tables. No CUDA call."""
    align16 = lambda v: (v + 15) // 16 * 16  # noqa: E731
    zs = 1024 + 3 * 128 * 64 * 2
    w3z = zs + align16((NZ * NZ + 1) * (c2 + 8) * 2)
    erows = w3z + NA * NZ * 136 * 2 + 32 * (NA + 1) * 16 * 2
    ab = erows + 32 * (NA + 1) * s3 * 2 + 2 * 16384
    return ab + 2 * c4 * 4 + (2 * NA * 4 + s3) * 4


def _shapes_ok(z2, weight, s3: int, nl: int, c2_mult: int, chunk) -> bool:
    """The shape, dtype and alignment limits of `_check`, as a predicate."""
    if z2.dtype not in _DTYPES or z2.dim() != 4:
        return False
    n, c2, c4 = z2.shape[0], z2.shape[-1], weight.shape[0]
    return (tuple(z2.shape) == (n, nl, nl, c2) and n >= 1 and c2 % c2_mult == 0
            and tuple(weight.shape) == (c4, c2, 4, 4) and c4 % chunk[z2.dtype] == 0
            and s3 % 8 == 0 and z2.data_ptr() % 16 == 0)


def typed_c3_expand_supports(z2, weight, s3: int) -> bool:
    """Whether the kernel of `typed_c3_expand` takes the (n, 12, 12, c2)
    grid, the (c4, c2, 4, 4) weight and an s3 x s3 output: c2 % 16 == 0, c4
    a multiple of the chunk (32 in bf16, 8 in f32), s3 % 8 == 0, z2 16-byte
    aligned; in bf16 also s3 in (8, 16, 32, 64) and the block's shared
    memory. A pure function of shapes, dtype and alignment."""
    if not _shapes_ok(z2, weight, s3, NZ, 16, _CHUNK):
        return False
    return z2.dtype != torch.bfloat16 or (
        s3 in (8, 16, 32, 64)
        and typed_tc_smem(z2.shape[-1], weight.shape[0], s3) <= build.SMEM_LIMIT)


def typed_c3_expand_v3_supports(z2p, weight, s3: int) -> bool:
    """The same for `typed_c3_expand_v3` on the padded (n, 13, 13, c2) grid."""
    return _shapes_ok(z2p, weight, s3, NL, 16, _CHUNK)


def typed_c3_expand_v5_supports(z2, weight, s3: int) -> bool:
    """The same for `typed_c3_expand_v5`: c2 % 32 == 0, c4 % 64 == 0."""
    return _shapes_ok(z2, weight, s3, NZ, 32, _CHUNK_V5)


def typed_c3_expand_v6_supports(z2, weight, s3: int) -> bool:
    """The same for `typed_c3_expand_v6`, which runs `typed_c3_expand`'s
    kernel: its limits."""
    return typed_c3_expand_supports(z2, weight, s3)


def present_row_types(selR):
    """The v6 schedule's rows, object by object, as the kernel compacts
    them: (types (n, 14) int64, the row types each object's output rows
    name in increasing order, padded with -1; counts (n,); W3z rows (n,),
    12 a type, padded to the next multiple of 64, the warpgroups' rows). A
    type outside [0, 14) names no row type (its rows are zeros)."""
    sel = selR.long()
    n = sel.shape[0]
    present = torch.zeros(n, NA + 1, dtype=torch.bool, device=sel.device)
    present.scatter_(1, torch.where((sel >= 0) & (sel < NA), sel, NA), True)
    present = present[:, :NA]
    counts = present.sum(1)
    ar = torch.arange(NA, device=sel.device).expand(n, NA)
    types = torch.where(present, ar, NA).sort(1).values
    types = torch.where(types < NA, types, -1)
    return types, counts, (counts * NZ + 63) // 64 * 64


def _launch(fn, z2, idxR, lsel, selR, selC, ab, wk, out, *tail):
    """Call the library function `fn` on the tensors' pointers and raise on
    a non-zero cudaError_t. tail: the integers after `out`, then is_bf16 and
    the stream are appended."""
    stream = torch.cuda.current_stream(z2.device).cuda_stream
    err = getattr(build.library(), fn)(
        z2.data_ptr(), idxR.data_ptr(), lsel.data_ptr(), selR.data_ptr(), selC.data_ptr(),
        ab.data_ptr(), wk.data_ptr(), *out, *tail, _DTYPES[z2.dtype], stream,
    )
    build.check(err, fn)


_swizzle: dict = {}  # device -> the (8, 8) index p ^ r of `pack_typed_c3_weights`


def pack_typed_c3_weights(weight, dtype):
    """The c3 weights as the ring stages of the bf16 kernel of
    `csrc/typed_c3_expand.cu`: (c4, c2, 4, 4) -> (c4 / 32, 4 c2 / 64, 128,
    64) in `dtype`, [chunk of 32 channels][slice of 64 k][row n = 32 w +
    ci][k], with k = h * c2 + c. Within a row the eight 16-byte pieces are
    swizzled, piece p holding the values of piece p ^ (n % 8), so that eight
    rows read at one k lie in eight different banks (`ldmatrix`, and the
    128-byte swizzle of `wgmma`). A stage is one contiguous 16 KB copy."""
    c4, c2, _, _ = weight.shape
    if c2 % 16 or c4 % 32:
        raise ValueError(f"pack_typed_c3_weights: c2 % 16 == 0 and c4 % 32 == 0 (64-deep slices, "
                         f"32-channel chunks), got c2={c2}, c4={c4}")
    dev = weight.device
    if dev not in _swizzle:
        r = torch.arange(8, device=dev)
        _swizzle[dev] = (r[:, None] ^ r[None, :]).view(1, 1, 1, 8, 8, 1)
    k = 4 * c2
    # [chunk][w][ci / 8][ci % 8][h][c], row n = 32 w + ci = 8 i + r: one copy that converts
    # and permutes, then one gather that swizzles into the final order
    wk = torch.empty((c4 // 32, 4, 4, 8, 4, c2), dtype=dtype, device=dev)
    wk.copy_(weight.view(c4 // 32, 4, 8, c2, 4, 4).permute(0, 5, 1, 2, 4, 3))
    wk = wk.view(c4 // 32, 16, 8, k // 64, 8, 8).permute(0, 3, 1, 2, 4, 5)  # [chunk][slice][i][r][p]
    wk = torch.take_along_dim(wk, _swizzle[dev], dim=4)  # [.., r, p, :] <- [.., r, p ^ r, :]
    return wk.view(c4 // 32, k // 64, 128, 64)


def unpack_typed_c3_weights(packed):
    """The inverse of `pack_typed_c3_weights`: -> (c4, c2, 4, 4)."""
    nch, nsl, _, _ = packed.shape
    r = torch.arange(8, device=packed.device)
    wk = torch.take_along_dim(packed.view(nch, nsl, 16, 8, 8, 8),  # the swizzle is its own inverse
                              (r[:, None] ^ r[None, :]).view(1, 1, 1, 8, 8, 1), dim=4)
    c2 = nsl * 16
    # (chunk, slice, i, r, p, e) -> (chunk, i, r, slice, p, e) = (chunk, w, ci, h, c)
    wk = wk.permute(0, 2, 3, 1, 4, 5).reshape(nch, 4, 32, 4, c2)
    return wk.permute(0, 2, 4, 3, 1).reshape(nch * 32, c2, 4, 4)


def _typed_tc(name, z2, idxR, lsel, selR, selC, ab, weight):
    """The launch shared by `typed_c3_expand` and `typed_c3_expand_v6`, the
    two schedules of the kernel of `csrc/typed_c3_expand.cu`."""
    n, c2, c4, s3 = _check(name, z2, idxR, lsel, selR, selC, ab, weight)
    if z2.dtype == torch.bfloat16:
        if s3 not in (8, 16, 32, 64):
            raise ValueError(f"{name}: the bf16 kernel takes s3 in (8, 16, 32, 64) (its "
                             f"epilogue's shifts and 16 KB output pieces), got s3={s3}")
        smem = typed_tc_smem(c2, c4, s3)
        if smem > build.SMEM_LIMIT:
            raise ValueError(f"{name}: c2={c2}, c4={c4}, s3={s3} needs {smem} bytes of "
                             f"shared memory, a block has {build.SMEM_LIMIT}")
        wk = pack_typed_c3_weights(weight, z2.dtype)
    else:
        wk = weight.to(z2.dtype).permute(0, 3, 2, 1).contiguous()  # (C, w, h, c)
    out = torch.empty((n, c4, s3, s3), dtype=z2.dtype, device=z2.device)
    _launch(name, z2, idxR, lsel, selR, selC, ab, wk, (out.data_ptr(),), n, c2, c4, s3)
    return out


def typed_c3_expand(z2, idxR, lsel, selR, selC, ab, weight):
    """Typed c3 + bn3 affine + relu + expansion; see `typed_c3_expand_plain`
    for the contract (int inputs int32 here).

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/typed_c3_expand.cu` or raises: in bf16 one persistent block an SM
    whose warps share out the weight copies, the product and the expansion
    (weights from `pack_typed_c3_weights`); in f32 one block an object on
    FMAs. A c2 whose tiles exceed a block's shared memory is refused with a
    ValueError in bf16 (c2 > 176) and by the launch in f32.
    """
    if z2.device.type == "cpu":
        return typed_c3_expand_plain(z2, idxR, lsel, selR, selC, ab, weight)
    out = _typed_tc("typed_c3_expand", z2, idxR, lsel, selR, selC, ab, weight)
    typed_c3_expand.launches += 1
    return out


typed_c3_expand.launches = 0


def typed_c3_expand_v3(z2p, idxR, lsel, selR, selC, ab, weight, group: int = 8):
    """The typed c3 on the zero-padded (n, 13, 13, c2) grid, `group` objects
    a block; see `typed_c3_expand_v3_plain` for the contract. Like the JAX
    op, no model path calls it.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/typed_c3_expand_v3.cu` or raises.
    """
    if z2p.device.type == "cpu":
        return typed_c3_expand_v3_plain(z2p, idxR, lsel, selR, selC, ab, weight)
    n, c2, c4, s3 = _check("typed_c3_expand_v3", z2p, idxR, lsel, selR, selC, ab, weight, nl=NL)
    if group < 1:
        raise ValueError(f"typed_c3_expand_v3: group {group} not supported")
    wk = weight.to(z2p.dtype).permute(0, 3, 2, 1).contiguous()  # (C, w, h, c)
    out = torch.empty((n, c4, s3, s3), dtype=z2p.dtype, device=z2p.device)
    _launch("typed_c3_expand_v3", z2p, idxR, lsel, selR, selC, ab, wk, (out.data_ptr(),),
            n, c2, c4, s3, group)
    typed_c3_expand_v3.launches += 1
    return out


typed_c3_expand_v3.launches = 0

_w3z_scratch: dict = {}  # device -> the uint8 buffer `typed_c3_expand_v5` keeps


def w3z_scratch(nbytes: int, device) -> torch.Tensor:
    """The device scratch of `typed_c3_expand_v5`, at least `nbytes` long:
    allocated once per device and reused by every later call (calls on one
    stream follow each other, so they can share it), regrown when a call
    needs more. Raises if the card cannot hold it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    buf = _w3z_scratch.get(device)
    if buf is None or buf.numel() < nbytes:
        _w3z_scratch.pop(device, None)
        del buf  # a smaller buffer goes back to the allocator first
        free, _ = torch.cuda.mem_get_info(device)
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        if nbytes > free + cached:
            raise RuntimeError(f"typed_c3_expand_v5: the W3z scratch needs {nbytes} bytes, "
                               f"{free + cached} are free on {device}")
        buf = _w3z_scratch[device] = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return buf


def typed_c3_expand_v5(z2, idxR, lsel, selR, selC, ab, weight):
    """`typed_c3_expand`'s function as one GEMM over all n * 168 gathered
    rows into a device scratch (`w3z_scratch`: n * 168 * 4 c4 values of the
    compute dtype, 440 MB at n = 1280, c4 = 256 in bf16), then one pass for
    the column windows, the affine and the expansion.

    A CPU tensor takes the plain version. A CUDA tensor launches the two
    kernels of `csrc/typed_c3_expand_v5.cu` (one launch counted) or raises.
    """
    if z2.device.type == "cpu":
        return typed_c3_expand_v5_plain(z2, idxR, lsel, selR, selC, ab, weight)
    n, c2, c4, s3 = _check("typed_c3_expand_v5", z2, idxR, lsel, selR, selC, ab, weight,
                           c2_mult=32, chunk=_CHUNK_V5)
    wk = weight.to(z2.dtype).permute(3, 0, 2, 1).contiguous()  # (w, C, h, c)
    w3z = w3z_scratch(n * NA * NZ * 4 * c4 * z2.element_size(), z2.device)
    out = torch.empty((n, c4, s3, s3), dtype=z2.dtype, device=z2.device)
    _launch("typed_c3_expand_v5", z2, idxR, lsel, selR, selC, ab, wk,
            (w3z.data_ptr(), out.data_ptr()), n, c2, c4, s3)
    typed_c3_expand_v5.launches += 1
    return out


typed_c3_expand_v5.launches = 0


def typed_c3_expand_v6(z2, idxR, lsel, selR, selC, ab, weight):
    """`typed_c3_expand`'s function on `typed_c3_expand`'s kernel, scheduled
    by the row types: W3z only for the types each object's selR names
    (`present_row_types`), compacted, the sums and the expansion along x of
    those types alone. In bf16 each row is summed as `typed_c3_expand` sums
    it, so the two agree bit for bit; in f32 it runs the FMA reference
    kernel of `typed_c3_expand`.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    of `csrc/typed_c3_expand.cu` or raises.
    """
    if z2.device.type == "cpu":
        return typed_c3_expand_v6_plain(z2, idxR, lsel, selR, selC, ab, weight)
    out = _typed_tc("typed_c3_expand_v6", z2, idxR, lsel, selR, selC, ab, weight)
    typed_c3_expand_v6.launches += 1
    return out


typed_c3_expand_v6.launches = 0

# Config.typed_c3 -> the kernel `LayoutEncoder._typed_c2c3_eval` launches, and
# the predicate that says whether it takes the shapes
VARIANTS = {"v4": typed_c3_expand, "v5": typed_c3_expand_v5, "v6": typed_c3_expand_v6}
SUPPORTS = {"v4": typed_c3_expand_supports, "v5": typed_c3_expand_v5_supports,
            "v6": typed_c3_expand_v6_supports}
