"""K4' (`spade_apply_t`, SPADE's apply from flat tables) on the CPU: the
predicate that says which calls its kernel takes, and the wrapper's plain
route for CPU tensors. The kernel itself runs only on a card
(`tests/test_torch_port_gpu.py`); its plain version is held against JAX's
Pallas kernel in `tests/test_torch_port_int8.py`."""

from __future__ import annotations

import pytest
import torch

from aglayout_tpu_torch.ops.spade_conv import (
    spade_apply_t,
    spade_apply_t_plain,
    spade_apply_t_supports,
)


def _case(b, c, h, w, f, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g).to(dtype)
    a_tab = (1 + 0.3 * torch.randn(b, h // f, 5, c, w, generator=g)).to(dtype)
    b_tab = (0.3 * torch.randn(b, h // f, 5, c, w, generator=g)).to(dtype)
    return x, a_tab, b_tab


def _misaligned(t):
    """A contiguous copy of t whose storage starts one element past its allocation's start."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    return out.copy_(t)


def _aligned(t):
    """t itself if 16-byte aligned, else an aligned contiguous copy."""
    if t.data_ptr() % 16 == 0:
        return t
    n = t.numel() + 16
    buf = torch.empty(n, dtype=t.dtype)
    start = (-buf.data_ptr() % 16) // t.element_size()
    return buf[start:start + t.numel()].view(t.shape).copy_(t)


# label, (b, c, h, w, f), dtype, which tensor to misalign (or None), taken
CASES = [
    ("SPADE-4's shape, batch cut", (2, 128, 128, 128, 16), torch.bfloat16, None, True),
    ("f = 32", (1, 8, 64, 64, 32), torch.bfloat16, None, True),
    ("f < 5", (1, 8, 8, 64, 4), torch.bfloat16, None, False),
    ("H % f != 0", (1, 8, 20, 64, 8), torch.bfloat16, None, False),
    ("W = 12 in bf16: no whole 16-byte vectors", (1, 8, 16, 12, 8), torch.bfloat16, None, False),
    ("W = 12 in f32: three vectors", (1, 8, 16, 12, 8), torch.float32, None, True),
    ("x misaligned", (1, 8, 16, 64, 8), torch.bfloat16, 0, False),
    ("a_tab misaligned", (1, 8, 16, 64, 8), torch.bfloat16, 1, False),
    ("b_tab misaligned", (1, 8, 16, 64, 8), torch.bfloat16, 2, False),
    # past the 5,811 columns the shared-memory kernel took (40 cb W <= 232,448 at cb = 1)
    ("W = 5816 at B = C = 1", (1, 1, 16, 5816, 16), torch.bfloat16, None, True),
    ("f16 is no dtype of the kernel", (1, 8, 16, 64, 8), torch.float16, None, False),
]


@pytest.mark.parametrize("label,shape,dtype,misaligned,taken", CASES, ids=[c[0] for c in CASES])
def test_spade_apply_t_supports(label, shape, dtype, misaligned, taken):
    b, c, h, w, f = shape
    args = [_aligned(t) for t in _case(b, c, h, w, f, dtype)]
    if misaligned is not None:
        args[misaligned] = _misaligned(args[misaligned])
        assert args[misaligned].data_ptr() % 16
    assert spade_apply_t_supports(*args, f) is taken


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_spade_apply_t_takes_the_plain_version_on_the_cpu(dtype):
    """A CPU tensor goes to the plain version, launching nothing, whatever
    the kernel would take (here W = 5816 and misaligned tables)."""
    x, a_tab, b_tab = _case(1, 2, 32, 5816, 16, dtype, seed=1)
    a_tab = _misaligned(a_tab)
    before = spade_apply_t.launches
    got = spade_apply_t(x, a_tab, b_tab, 16)
    assert spade_apply_t.launches == before
    assert torch.equal(got, spade_apply_t_plain(x, a_tab, b_tab, 16))
    # the plain version itself: relu(x * A + B) in f32, A and B by row class
    u = torch.arange(16)
    cls = torch.where(u == 0, 0, torch.where(u == 1, 1, torch.where(u == 14, 3,
                                                                    torch.where(u == 15, 4, 2))))
    a = a_tab.float()[:, :, cls].permute(0, 3, 1, 2, 4).reshape(1, 2, 32, 5816)
    bb = b_tab.float()[:, :, cls].permute(0, 3, 1, 2, 4).reshape(1, 2, 32, 5816)
    assert torch.equal(got, torch.relu(x.float() * a + bb).to(dtype))
