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
function:
  * `typed_c3_expand_v3` (`csrc/typed_c3_expand.cu`): the function on the
    zero-padded (n, 13, 13, c2) grid, whose 12 x 12 K5's kernel reads in
    place, so it equals `typed_c3_expand` on the inner grid bit for bit;
    JAX's group of objects a program fills the TPU's MXU and has no
    counterpart in the persistent schedule; an op no model path calls, as
    in JAX;
  * `typed_c3_expand_v5` (`csrc/typed_c3_expand.cu`): one product over all
    row types of an object, which is what K5's kernel does: it launches that
    kernel as it is, and equals `typed_c3_expand` bit for bit;
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
# the output channels the kernels' chunks divide: K5 in bf16 multiplies
# chunks of 32 and takes a last one of 16, in f32 chunks of 8
_CHUNK = {torch.bfloat16: 16, torch.float32: 8}


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


def _check(name, z2, idxR, lsel, selR, selC, ab, weight, nl=NZ):
    """Device, dtype, shape, contiguity and alignment checks shared by the
    four wrappers; returns (n, c2, c4, s3). nl: the grid's side."""
    if z2.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {z2.device}")
    if z2.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {z2.dtype} not supported")
    n, c2 = z2.shape[0], z2.shape[-1]
    c4, s3 = weight.shape[0], selR.shape[-1]
    if z2.shape != (n, nl, nl, c2) or c2 % 16 or n < 1:
        raise ValueError(f"{name}: z2 shape {tuple(z2.shape)} not supported")
    if weight.shape != (c4, c2, 4, 4) or c4 % _CHUNK[z2.dtype]:
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


def typed_tc_layout(c2: int, c4: int, s3: int):
    """(channels whose row types are held at a time, bytes of a staging
    buffer, bytes of shared memory) of a block of the bf16 kernel of
    `csrc/typed_c3_expand.cu`, as its `tc::layout` chooses them: the 3-stage
    weight ring, the grid tile, W3z, V3, the row types of a channel group,
    two output staging buffers, the affine and the index tables; K5's own
    group of 32 channels and 16 KB buffers wherever they fit, else the
    largest that do. Where nothing fits, the size is one byte past the
    limit. No CUDA call."""
    zs = 1024 + 3 * 128 * 64 * 2
    rows = zs + (NZ * NZ + 1) * (c2 + 8) * 2 + 15 & ~15  # the grid tile, 16-byte aligned
    rows += NA * NZ * 136 * 2 + 32 * (NA + 1) * 16 * 2  # W3z, V3
    fixed = 2 * c4 * 4 + (2 * NA * 4 + s3) * 4  # the affine, the index tables
    for plane in (16384, 8192):
        for ech in (32, 16, 8):
            total = rows + ech * (NA + 1) * s3 * 2 + 2 * plane + fixed
            if total <= build.SMEM_LIMIT and 2 * s3 * s3 <= plane:
                return ech, plane, total
    return 8, 8192, build.SMEM_LIMIT + 1


def typed_tc_smem(c2: int, c4: int, s3: int) -> int:
    """The bytes of `typed_tc_layout`: what `typed_c3_expand_smem` of the
    library returns."""
    return typed_tc_layout(c2, c4, s3)[2]


def _supports(z2, weight, s3: int, nl: int) -> bool:
    """The limits of `_check` and, in bf16, the block's shared memory, as a
    predicate; nl: the grid's side."""
    if z2.dtype not in _DTYPES or z2.dim() != 4:
        return False
    n, c2, c4 = z2.shape[0], z2.shape[-1], weight.shape[0]
    return (tuple(z2.shape) == (n, nl, nl, c2) and n >= 1 and c2 % 16 == 0
            and tuple(weight.shape) == (c4, c2, 4, 4) and c4 % _CHUNK[z2.dtype] == 0
            and s3 % 8 == 0 and z2.data_ptr() % 16 == 0
            and (z2.dtype != torch.bfloat16 or typed_tc_smem(c2, c4, s3) <= build.SMEM_LIMIT))


def typed_c3_expand_supports(z2, weight, s3: int) -> bool:
    """Whether the kernel of `typed_c3_expand` takes the (n, 12, 12, c2)
    grid, the (c4, c2, 4, 4) weight and an s3 x s3 output: c2 % 16 == 0, c4
    % 16 == 0 in bf16 and % 8 in f32, s3 % 8 == 0, z2 16-byte aligned; in
    bf16 also the block's shared memory (`typed_tc_smem`: at s3 = 32 and c4
    = 2 c2, c2 up to 304). A pure function of shapes, dtype and alignment."""
    return _supports(z2, weight, s3, NZ)


def typed_c3_expand_v3_supports(z2p, weight, s3: int) -> bool:
    """The same for `typed_c3_expand_v3` on the padded (n, 13, 13, c2) grid:
    K5's kernel, which reads the 12 x 12 in place, so K5's limits."""
    return _supports(z2p, weight, s3, NL)


# v5 and v6 run `typed_c3_expand`'s kernel: its limits
typed_c3_expand_v5_supports = typed_c3_expand_supports
typed_c3_expand_v6_supports = typed_c3_expand_supports


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


def _typed_tc(name, z2, idxR, lsel, selR, selC, ab, weight, fn=None, nl=NZ):
    """The launch shared by the four wrappers, the schedules of the kernel
    of `csrc/typed_c3_expand.cu`; fn: the library function, if not `name`;
    nl: the grid's side."""
    n, c2, c4, s3 = _check(name, z2, idxR, lsel, selR, selC, ab, weight, nl)
    if z2.dtype == torch.bfloat16:
        smem = typed_tc_smem(c2, c4, s3)
        if smem > build.SMEM_LIMIT:
            raise ValueError(f"{name}: c2={c2}, c4={c4}, s3={s3} needs more than "
                             f"{build.SMEM_LIMIT} bytes of shared memory, a block's")
        if c4 % 32:  # a last chunk of 16 channels: its upper half multiplies zeros
            weight = torch.cat([weight, weight.new_zeros(16, *weight.shape[1:])])
        wk = pack_typed_c3_weights(weight, z2.dtype)
    else:
        wk = weight.to(z2.dtype).permute(0, 3, 2, 1).contiguous()  # (C, w, h, c)
    out = torch.empty((n, c4, s3, s3), dtype=z2.dtype, device=z2.device)
    _launch(fn or name, z2, idxR, lsel, selR, selC, ab, wk, (out.data_ptr(),), n, c2, c4, s3)
    return out


def typed_c3_expand(z2, idxR, lsel, selR, selC, ab, weight):
    """Typed c3 + bn3 affine + relu + expansion; see `typed_c3_expand_plain`
    for the contract (int inputs int32 here).

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/typed_c3_expand.cu` or raises: in bf16 one persistent block an SM
    whose warps share out the weight copies, the product and the expansion
    (weights from `pack_typed_c3_weights`); in f32 one block an object on
    FMAs. Shapes whose tiles exceed a block's shared memory are refused with
    a ValueError in bf16 (`typed_tc_smem`) and by the launch in f32.
    """
    if z2.device.type == "cpu":
        return typed_c3_expand_plain(z2, idxR, lsel, selR, selC, ab, weight)
    out = _typed_tc("typed_c3_expand", z2, idxR, lsel, selR, selC, ab, weight)
    typed_c3_expand.launches += 1
    return out


typed_c3_expand.launches = 0


def typed_c3_expand_v3(z2p, idxR, lsel, selR, selC, ab, weight, group: int = 8):
    """The typed c3 on the zero-padded (n, 13, 13, c2) grid; see
    `typed_c3_expand_v3_plain` for the contract. Like the JAX op, no model
    path calls it. `group` (JAX's objects a program, >= 1) is checked and
    has no effect: the kernel is `typed_c3_expand`'s, one persistent block
    an SM walking over the objects, which reads the grid's 12 x 12 in place
    and gives the bits of `typed_c3_expand` on `z2p[:, :12, :12]`.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    of `csrc/typed_c3_expand.cu` or raises.
    """
    if group < 1:
        raise ValueError(f"typed_c3_expand_v3: group {group} not supported")
    if z2p.device.type == "cpu":
        return typed_c3_expand_v3_plain(z2p, idxR, lsel, selR, selC, ab, weight)
    out = _typed_tc("typed_c3_expand_v3", z2p, idxR, lsel, selR, selC, ab, weight, nl=NL)
    typed_c3_expand_v3.launches += 1
    return out


typed_c3_expand_v3.launches = 0

def typed_c3_expand_v5(z2, idxR, lsel, selR, selC, ab, weight):
    """`typed_c3_expand`'s function as JAX's v5 schedules it, one product
    over all row types of an object: on the card the kernel of
    `typed_c3_expand`, whose three warpgroups take all 168 rows (a, l) of an
    object in one pass, so the two agree bit for bit.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    of `csrc/typed_c3_expand.cu` or raises.
    """
    if z2.device.type == "cpu":
        return typed_c3_expand_v5_plain(z2, idxR, lsel, selR, selC, ab, weight)
    out = _typed_tc("typed_c3_expand_v5", z2, idxR, lsel, selR, selC, ab, weight,
                    fn="typed_c3_expand")
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
