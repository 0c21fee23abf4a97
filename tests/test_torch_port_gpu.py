"""The port's CUDA kernels on the card, against their plain versions and
against the CPU path. Every test here needs a CUDA card and skips without
one. The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(`--noconftest`: the suite's conftest sets up JAX).
"""

import pytest
import torch

from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.models import build_generator, init_weights
from aglayout_tpu_torch.models.norms import SPADE
from aglayout_tpu_torch.ops.resblocks import residual_trunk, residual_trunk_plain
from aglayout_tpu_torch.ops.spade_conv import (
    spade_apply8,
    spade_apply8_plain,
    spade_few_out_conv,
    spade_few_out_conv8,
    spade_few_out_conv8_plain,
    spade_few_out_conv_plain,
)
from aglayout_tpu_torch.ops.typed_expand import typed_c3_expand, typed_c3_expand_plain

pytestmark = pytest.mark.gpu
DT = {"f32": torch.float32, "bf16": torch.bfloat16}
# max|err| / max|plain|: f32 differs by summation order only; bf16 rounds
# intermediates on both sides, so an order difference can flip a rounding
TOL = {"f32": 1e-4, "bf16": 2e-2}


@pytest.fixture
def cuda():
    """The CUDA device, with TF32 off; skips the test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_trunk_kernel_matches_plain(cuda, dt):
    g = torch.Generator().manual_seed(0)
    b, c, r = 16, 64, 6
    h = torch.randn(b, c, 8, 8, generator=g).to(cuda, DT[dt])
    w1, w2 = (torch.randn(r, c, c, 3, 3, generator=g).div(24).to(cuda) for _ in range(2))
    ab1, ab2 = (torch.randn(r, 2, c, generator=g).mul(0.5).to(cuda) for _ in range(2))
    before = residual_trunk.launches
    got = residual_trunk(h, w1, w2, ab1, ab2)
    assert residual_trunk.launches == before + 1 and got.dtype == torch.float32
    assert _rel(got, residual_trunk_plain(h, w1, w2, ab1, ab2)) < TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_kernel_matches_plain(cuda, dt):
    g = torch.Generator().manual_seed(1)
    spade = init_weights(SPADE(64, seg_features=64, nhidden=128), g).eval().to(cuda)
    with torch.no_grad():
        seg = torch.randn(4, 64, 8, 8, generator=g).to(cuda)
        a_tab, b_tab = (t.to(DT[dt]).contiguous() for t in spade.folded_affine_tables(seg, 8))
        x = torch.randn(4, 64, 64, 64, generator=g).to(cuda, DT[dt])
        weight = torch.randn(3, 64, 7, 7, generator=g).mul(0.02).to(cuda)
        bias = torch.randn(3, generator=g).to(cuda)
        before = spade_few_out_conv.launches
        got = spade_few_out_conv(x, a_tab, b_tab, weight, bias, 8)
        want = spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, 8)
    assert spade_few_out_conv.launches == before + 1 and got.shape == (4, 3, 64, 64)
    assert _rel(got, want) < TOL[dt]


def _compact_case(cuda, dt, b, c, size, seed):
    """x (b, c, size, size) and compact SPADE tables (f = size / 8) in `dt`."""
    g = torch.Generator().manual_seed(seed)
    spade = init_weights(SPADE(c, seg_features=64, nhidden=128), g).eval().to(cuda)
    with torch.no_grad():
        seg = torch.randn(b, 64, 8, 8, generator=g).to(cuda)
        a_tab, b_tab = (t.to(DT[dt]).contiguous() for t in spade.folded_affine_tables_compact(seg))
    x = torch.randn(b, c, size, size, generator=g).to(cuda, DT[dt])
    return x, a_tab, b_tab, g


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head8_kernel_matches_plain(cuda, dt):
    """K3 at the c7 head's shape (C=128, 128^2, f=16, K=7), batch cut to 4."""
    x, a_tab, b_tab, g = _compact_case(cuda, dt, 4, 128, 128, seed=3)
    weight = torch.randn(3, 128, 7, 7, generator=g).mul(0.02).to(cuda)
    bias = torch.randn(3, generator=g).to(cuda)
    before = spade_few_out_conv8.launches
    got = spade_few_out_conv8(x, a_tab, b_tab, weight, bias, 16)
    want = spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, 16)
    assert spade_few_out_conv8.launches == before + 1 and got.shape == (4, 3, 128, 128)
    assert _rel(got, want) < TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply8_kernel_matches_plain(cuda, dt):
    """K4 at SPADE-4's shape (C=128, 128^2, f=16), batch cut to 4."""
    x, a_tab, b_tab, _ = _compact_case(cuda, dt, 4, 128, 128, seed=4)
    before = spade_apply8.launches
    got = spade_apply8(x, a_tab, b_tab, 16)
    want = spade_apply8_plain(x, a_tab, b_tab, 16)
    assert spade_apply8.launches == before + 1 and got.dtype == DT[dt]
    assert _rel(got, want) < TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_typed_kernel_matches_plain(cuda, dt):
    """K5 at the 128^2 layout encoder's shape (c2=128, c4=256, s3=32) over
    its whole input domain, 16 objects."""
    g = torch.Generator().manual_seed(5)
    n, s3 = 16, 32
    ints = [torch.randint(0, hi, shape, generator=g, dtype=torch.int32).to(cuda)
            for hi, shape in ((13, (n, 14, 4)), (14, (n, 14, 4)), (14, (n, s3)), (14, (n, s3)))]
    z2 = torch.randn(n, 12, 12, 128, generator=g).to(cuda, DT[dt])
    ab = torch.randn(n, 2, 256, generator=g).mul(0.5).to(cuda)
    weight = torch.randn(256, 128, 4, 4, generator=g).mul(0.05).to(cuda)
    before = typed_c3_expand.launches
    got = typed_c3_expand(z2, *ints, ab, weight)
    want = typed_c3_expand_plain(z2, *ints, ab, weight)
    assert typed_c3_expand.launches == before + 1 and got.shape == (n, 256, s3, s3)
    assert _rel(got, want) < TOL[dt]


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_generate_on_card_matches_cpu(cuda, bf16, size):
    """Kernels on, on the card, against the plain path on the CPU."""
    cfg = config_for(size, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23, bf16=bf16)
    g = torch.Generator().manual_seed(2)
    b, o = 4, 4
    objs = torch.randint(0, cfg.num_classes, (b, o), generator=g)
    xy0 = torch.rand(b, o, 2, generator=g) * 0.6
    boxes = torch.cat([xy0, (xy0 + 0.1 + 0.3 * torch.rand(b, o, 2, generator=g)).clamp(max=1)], -1)
    valid = torch.ones(b, o)
    z = torch.randn(b, o, cfg.z_dim, generator=g)
    attr = (torch.rand(b, o, cfg.attribute_dim, generator=g) < 0.1).float()
    ins = (objs, boxes, valid, z, attr)
    kernels = [residual_trunk, spade_few_out_conv]
    if size == 128:
        kernels += [typed_c3_expand, spade_apply8, spade_few_out_conv8]
    before = [k.launches for k in kernels]
    got = build_generator(cfg, cuda, seed=1).generate(*(t.to(cuda) for t in ins)).cpu()
    want = build_generator(cfg, "cpu", seed=1).generate(*ins)
    assert all(k.launches > n for k, n in zip(kernels, before))
    # f32: summation order; bf16: the kernels' f32 skip chain against the
    # dense blocks' bf16 one, carried through the decoder
    assert _rel(got, want) < (1e-4 if not bf16 else 5e-2)
