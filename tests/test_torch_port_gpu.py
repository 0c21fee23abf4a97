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
from aglayout_tpu_torch.ops.spade_conv import spade_few_out_conv, spade_few_out_conv_plain

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


@pytest.mark.parametrize("bf16", [False, True])
def test_generate_on_card_matches_cpu(cuda, bf16):
    """Kernels on, on the card, against the plain path on the CPU."""
    cfg = config_for(64, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23, bf16=bf16)
    g = torch.Generator().manual_seed(2)
    b, o = 4, 4
    objs = torch.randint(0, cfg.num_classes, (b, o), generator=g)
    xy0 = torch.rand(b, o, 2, generator=g) * 0.6
    boxes = torch.cat([xy0, (xy0 + 0.1 + 0.3 * torch.rand(b, o, 2, generator=g)).clamp(max=1)], -1)
    valid = torch.ones(b, o)
    z = torch.randn(b, o, cfg.z_dim, generator=g)
    attr = (torch.rand(b, o, cfg.attribute_dim, generator=g) < 0.1).float()
    ins = (objs, boxes, valid, z, attr)
    before = (residual_trunk.launches, spade_few_out_conv.launches)
    got = build_generator(cfg, cuda, seed=1).generate(*(t.to(cuda) for t in ins)).cpu()
    want = build_generator(cfg, "cpu", seed=1).generate(*ins)
    assert residual_trunk.launches > before[0] and spade_few_out_conv.launches > before[1]
    # f32: summation order; bf16: the kernels' f32 skip chain against the
    # dense blocks' bf16 one, carried through the decoder
    assert _rel(got, want) < (1e-4 if not bf16 else 5e-2)
