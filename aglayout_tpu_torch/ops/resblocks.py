"""The layout encoder's eval-mode residual trunk in one kernel launch.

Port of `aglayout_tpu/ops/pallas_resblocks.py::residual_trunk`. After the
ConvLSTM, the (B, C, 8, 8) layout feature runs through R residual blocks
[conv3x3 -> BN affine -> relu -> conv3x3 -> BN affine] + skip. At serving
shapes each conv is tiny, so as separate launches the trunk is some 40
small kernels; `csrc/residual_trunk.cu` runs all of it in one launch, one
CTA per image, by one of two kernels that the wrapper picks from the
shapes and the dtype alone (`residual_trunk_route`):
  * "tc", bf16 with C % 16 == 0 up to 128: the 12 convs as implicit GEMMs
    on the tensor cores, each the JAX kernel's 9 tap products on shifted
    windows of a zero-padded pixel-major tile, over weights packed by
    `pack_trunk_weights`; `residual_trunk_tapped_plain` repeats its order
    of sums;
  * "fma", f32 and the other C (4 <= C <= 256, C % 4 == 0, as far as a
    conv's weights fit shared memory): FMAs on the CUDA cores.

Numerics, the same in both kernels and in `residual_trunk_plain`:
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
_TC_MAX_STAGES = 16  # the ring of weight stages in the tensor-core kernel, at most
_TC_RING = 256  # bytes ahead of the ring: its full and empty mbarriers


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


def pack_trunk_weights(w1, w2, dtype):
    """The trunk's conv weights as the tensor-core kernel streams them: (R,
    C, C, 3, 3) twice -> (R, 2, 3, 3, C / 16, C / 8, 8, 4, 2, 2) in `dtype`,
    [block][conv][dy][dx][k-step kc][n-tile J][g][t][reg][e], holding
    w[cout = 8 J + g, cin = 16 kc + 8 reg + 2 t + e, dy, dx]: lane 4 g + t of
    an `mma.sync` m16n8k16 finds its B fragment of n-tile J (two registers)
    as 8 contiguous bytes, and one tap of one conv is one contiguous C * C
    stage. Two launches, each a copy that converts and permutes."""
    r, c = w1.shape[:2]
    if c % 16:
        raise ValueError(f"pack_trunk_weights: C % 16 == 0 (the mma k-step), got C={c}")
    buf = torch.empty((r, 2, 3, 3, c // 16, c // 8, 8, 4, 2, 2), dtype=dtype, device=w1.device)
    for i, w in enumerate((w1, w2)):
        # (R, J, g, kc, reg, t, e, dy, dx) -> (R, dy, dx, kc, J, g, t, reg, e)
        src = w.reshape(r, c // 8, 8, c // 16, 2, 4, 2, 3, 3).permute(0, 7, 8, 3, 1, 2, 5, 4, 6)
        buf[:, i].copy_(src)
    return buf


def trunk_weight_matrices(packed):
    """`pack_trunk_weights`'s operand as per-tap GEMM matrices: (R, 2, 9,
    Cin, Cout), row cin, column cout."""
    r, _, _, _, nkc, nj = packed.shape[:6]
    m = packed.permute(0, 1, 2, 3, 4, 8, 7, 9, 5, 6)  # (R, 2, dy, dx, kc, reg, t, e, J, g)
    return m.reshape(r, 2, 9, nkc * 16, nj * 8)


def unpack_trunk_weights(packed):
    """The inverse of `pack_trunk_weights`: -> (w1, w2), each (R, C, C, 3, 3)."""
    m = trunk_weight_matrices(packed)  # (R, 2, 9, Cin, Cout)
    r, _, _, c, _ = m.shape
    w = m.view(r, 2, 3, 3, c, c).permute(1, 0, 5, 4, 2, 3)  # (2, R, Cout, Cin, dy, dx)
    return w[0], w[1]


def residual_trunk_tapped_plain(h, w1, w2, ab1, ab2):
    """Plain PyTorch version of the schedule of the tensor-core kernel; the
    function of `residual_trunk_plain` with its sums in another order. The
    maps lie pixel-major, channels innermost, zero-padded to 10 x 10; a conv
    is 9 tap products of the (B, 8, 8, Cin) window at offset (dy, dx) with
    the tap's (Cin, Cout) matrix of the packed weights, summed in f32 tap by
    tap. Used by the tests only."""
    cd = h.dtype
    m = trunk_weight_matrices(pack_trunk_weights(w1, w2, cd)).float()
    x = h.float().permute(0, 2, 3, 1)  # (B, 8, 8, C)

    def conv(v, mats):  # v rounded to the compute dtype, as the kernel's tiles hold it
        vp = F.pad(v.to(cd).float(), (0, 0, 1, 1, 1, 1))  # (B, 10, 10, C)
        acc = torch.zeros_like(v)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            acc = acc + vp[:, dy:dy + 8, dx:dx + 8] @ mats[tap]
        return acc

    for r in range(w1.shape[0]):
        t = torch.relu(conv(x, m[r, 0]) * ab1[r, 0] + ab1[r, 1])
        x = x + (conv(t, m[r, 1]) * ab2[r, 0] + ab2[r, 1])
    return x.permute(0, 3, 1, 2).contiguous()


def trunk_tc_smem(c: int):
    """(ring stages, bytes of shared memory) of a block of the tensor-core
    kernel at width C, as `csrc/residual_trunk.cu`'s `tc::layout` computes
    them: as many one-tap weight stages (C * C bf16) as fit beside the two
    padded tiles (100 pixels of C + 8 bf16), at most 16."""
    tiles = 2 * 100 * (c + 8) * 2
    stages = min(_TC_MAX_STAGES, (build.SMEM_LIMIT - _TC_RING - tiles) // (c * c * 2))
    return stages, _TC_RING + stages * c * c * 2 + tiles


def _fma_smem(c: int, itemsize: int) -> int:
    """Bytes of shared memory of a block of the FMA kernel."""
    return (2 * c * 100 + 9 * c * c) * itemsize


def residual_trunk_route(h, w1) -> str | None:
    """The kernel `residual_trunk` launches for these inputs: "tc", "fma",
    or None where neither takes them. A pure function of the shapes and the
    dtype (no CUDA call), so that a CPU test can ask it."""
    if h.dtype not in _DTYPES or h.dim() != 4:
        return None
    b, c, hh, ww = h.shape
    r = w1.shape[0]
    if (hh, ww) != (8, 8) or b < 1 or w1.shape != (r, c, c, 3, 3):
        return None
    if h.dtype == torch.bfloat16 and c % 16 == 0 and c <= 128 and trunk_tc_smem(c)[0] >= 2:
        return "tc"
    if c % 4 == 0 and 4 <= c <= 256 and _fma_smem(c, h.element_size()) <= build.SMEM_LIMIT:
        return "fma"
    return None


def residual_trunk_supports(h, w1) -> bool:
    """Whether a kernel of `residual_trunk` takes h and the weights."""
    return residual_trunk_route(h, w1) is not None


def residual_trunk(h, w1, w2, ab1, ab2):
    """Fused eval residual trunk; see `residual_trunk_plain` for the contract.

    A CPU tensor takes the plain version. A CUDA tensor launches one of the
    two kernels of `csrc/residual_trunk.cu` (`residual_trunk_route`) or
    raises; `launches` counts every launch, `route_launches` by kernel.
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
    route = residual_trunk_route(h, w1)
    if route is None:
        raise ValueError(f"residual_trunk: C={c} needs {_fma_smem(c, h.element_size())} bytes of "
                         f"shared memory, a block has {build.SMEM_LIMIT}")
    ab1 = ab1.float().contiguous()
    ab2 = ab2.float().contiguous()
    out = torch.empty((b, c, 8, 8), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if route == "tc":
        wp = pack_trunk_weights(w1, w2, h.dtype)
        err = build.library().residual_trunk_tc(
            h.data_ptr(), wp.data_ptr(), ab1.data_ptr(), ab2.data_ptr(), out.data_ptr(), b, c, r,
            stream,
        )
    else:
        # (R, Cout, Cin, 3, 3) -> (R, 3, 3, Cin, Cout): per tap, a Cin x Cout matrix
        wm1 = w1.to(h.dtype).permute(0, 3, 4, 2, 1).contiguous()
        wm2 = w2.to(h.dtype).permute(0, 3, 4, 2, 1).contiguous()
        err = build.library().residual_trunk(
            h.data_ptr(), wm1.data_ptr(), wm2.data_ptr(), ab1.data_ptr(), ab2.data_ptr(),
            out.data_ptr(), b, c, r, _DTYPES[h.dtype], stream,
        )
    build.check(err, "residual_trunk")
    residual_trunk.launches += 1
    residual_trunk.route_launches[route] += 1
    return out


residual_trunk.launches = 0
residual_trunk.route_launches = {"tc": 0, "fma": 0}
