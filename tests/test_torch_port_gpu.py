"""The port's CUDA kernels on the card, against their plain versions and
against the CPU path. Every test here needs a CUDA card and skips without
one. The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(`--noconftest`: the suite's conftest sets up JAX).
"""

import numpy as np
import pytest
import torch

from aglayout_tpu_torch.bench import TRAIN_SMALL
from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.models import build_discriminators, build_generator, init_weights
from aglayout_tpu_torch.models.convlstm import ConvLSTMCell
from aglayout_tpu_torch.models.norms import SPADE
from aglayout_tpu_torch.ops.conv8_int8 import (
    conv_small_int8,
    conv_small_int8_plain,
    pack_conv_small_int8_weights,
)
from aglayout_tpu_torch.ops.int8 import quantize_conv_weights
from aglayout_tpu_torch.ops.resblocks import residual_trunk, residual_trunk_plain
from aglayout_tpu_torch.ops.spade_c6_int8 import spade_c6_int8, spade_c6_int8_plain
from aglayout_tpu_torch.ops.spade_conv import (
    compact_to_flat,
    spade_apply8,
    spade_apply8_plain,
    spade_apply_t,
    spade_apply_t_plain,
    spade_few_out_conv,
    spade_few_out_conv8,
    spade_few_out_conv8_plain,
    spade_few_out_conv_plain,
)
from aglayout_tpu_torch.ops import typed_expand
from aglayout_tpu_torch.ops.typed_expand import typed_c3_expand, typed_c3_expand_plain
from aglayout_tpu_torch.train.compare import compare_steps, run_step, step_draws

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


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_t_kernel_matches_plain(cuda, dt):
    """K4' at SPADE-4's shape from flat tables, batch cut to 4."""
    x, a_tab, b_tab, _ = _compact_case(cuda, dt, 4, 128, 128, seed=6)
    a_flat, b_flat = (compact_to_flat(t, 16).contiguous() for t in (a_tab, b_tab))
    before = spade_apply_t.launches
    got = spade_apply_t(x, a_flat, b_flat, 16)
    assert spade_apply_t.launches == before + 1 and got.dtype == DT[dt]
    assert _rel(got, spade_apply_t_plain(x, a_flat, b_flat, 16)) < TOL[dt]
    assert torch.equal(got, spade_apply8(x, a_tab, b_tab, 16))  # K4's function, K4's numerics


# b, c, h, w, f: W 8, 64, 128, 200; f 5, 8, 16, 32 (at f = 32 the middle rows
# past a thread's first twelve come in two more passes); and W = 5816 at
# B = C = 1, past the 5,811 columns the shared-memory kernel it replaced took
K4T_SHAPES = [(1, 8, 10, 8, 5), (8, 24, 64, 64, 8), (2, 128, 128, 128, 16), (3, 40, 64, 200, 32),
              (5, 16, 48, 200, 16), (4, 128, 64, 128, 32), (1, 1, 32, 5816, 16)]


def _apply_t_case(cuda, dt, b, c, h, w, f, seed):
    """x (b, c, h, w) and random flat tables (b, h / f, 5, c, w) in `dt`."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g).to(cuda, DT[dt])
    a_tab = (1 + 0.3 * torch.randn(b, h // f, 5, c, w, generator=g)).to(cuda, DT[dt])
    b_tab = (0.3 * torch.randn(b, h // f, 5, c, w, generator=g)).to(cuda, DT[dt])
    return x, a_tab, b_tab


@pytest.mark.parametrize("b,c,h,w,f", K4T_SHAPES)
def test_apply_t_kernel_bit_for_bit_in_bf16(cuda, b, c, h, w, f):
    """K4' in bf16: x * A is exact in f32, so the kernel's fma gives the
    plain version's product and sum, rounded once: the same bits."""
    x, a_tab, b_tab = _apply_t_case(cuda, "bf16", b, c, h, w, f, seed=30)
    before = spade_apply_t.launches
    got = spade_apply_t(x, a_tab, b_tab, f)
    assert spade_apply_t.launches == before + 1
    assert torch.equal(got, spade_apply_t_plain(x, a_tab, b_tab, f))


@pytest.mark.parametrize("b,c,h,w,f", K4T_SHAPES)
def test_apply_t_kernel_matches_plain_in_f32(cuda, b, c, h, w, f):
    """K4' in f32: one fma against the plain version's product and sum."""
    x, a_tab, b_tab = _apply_t_case(cuda, "f32", b, c, h, w, f, seed=31)
    got = spade_apply_t(x, a_tab, b_tab, f)
    assert _rel(got, spade_apply_t_plain(x, a_tab, b_tab, f)) <= 1e-6


def _misaligned(t):
    """A contiguous copy of t whose storage starts one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def test_apply_t_raises_on_what_its_kernel_does_not_take(cuda):
    """Misaligned x or tables (each is read as 16-byte vectors) and a W of
    no whole vectors raise; nothing launches."""
    x, a_tab, b_tab = _apply_t_case(cuda, "bf16", 2, 8, 16, 64, 8, seed=32)
    before = spade_apply_t.launches
    for args in ((_misaligned(x), a_tab, b_tab), (x, _misaligned(a_tab), b_tab),
                 (x, a_tab, _misaligned(b_tab))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            spade_apply_t(*args, 8)
    with pytest.raises(ValueError, match="not supported"):  # W = 12: no whole bf16 vectors
        spade_apply_t(x[..., :12].contiguous(), a_tab[..., :12].contiguous(),
                      b_tab[..., :12].contiguous(), 8)
    assert spade_apply_t.launches == before


# b, cin, cout, k: the wide gate conv (batch cut; 6 is not a multiple of 8
# images a CTA, and its chunk is 6), a narrow one with Cin % 32 != 0,
# conv_dim 60's 600 -> 480 (Cout not a multiple of 64), and k = 1, 3 and 7
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,cin,cout,k", [(32, 640, 512, 5), (6, 144, 64, 5), (4, 600, 480, 5),
                                          (5, 40, 24, 3), (3, 50, 72, 7), (9, 300, 64, 1)])
def test_conv_small_int8_kernel_matches_plain(cuda, dt, b, cin, cout, k):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, cin, 8, 8, generator=g).to(cuda, DT[dt])
    wq, sw = quantize_conv_weights(torch.randn(cout, cin, k, k, generator=g).mul(0.02).to(cuda))
    packed = pack_conv_small_int8_weights(wq)  # packed once by the caller, as the ConvLSTM does
    before = conv_small_int8.launches
    got = conv_small_int8(x, wq, sw, k=k, packed=packed)
    want = conv_small_int8_plain(x, wq, sw, k=k)
    assert conv_small_int8.launches == before + 1 and got.shape == (b, cout, 8, 8)
    # exact integer sums and the same f32 products on both sides: the same bits
    assert got.dtype == DT[dt] and torch.equal(got, want)


# B 2 to 8, C 128 and 256; a map that is not a whole number of the product's
# 32 x 16 tiles, and C = 96 (half the last 64-channel tile)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,size,f", [(2, 128, 32, 8), (4, 128, 128, 16), (8, 256, 64, 16),
                                        (3, 256, 32, 8), (5, 96, 40, 8)])
def test_spade_c6_int8_kernel_matches_plain(cuda, dt, b, c, size, f):
    """K7 at small maps and at SPADE-4 + c6's shape, batch cut to 4: bit
    for bit its plain version (exact integer sums, the same f32 products)."""
    g = torch.Generator().manual_seed(8)
    w5 = 5 * size // f
    x = torch.randn(b, c, size, size, generator=g).to(cuda, DT[dt])
    a_tab = torch.rand(b, size // f, 5, c, w5, generator=g).add(0.5).to(cuda, DT[dt])
    b_tab = torch.randn(b, size // f, 5, c, w5, generator=g).mul(0.2).to(cuda, DT[dt])
    wq, sw = quantize_conv_weights(torch.randn(c, c, 5, 5, generator=g).mul(0.05).to(cuda))
    before = spade_c6_int8.launches
    got = spade_c6_int8(x, a_tab, b_tab, wq, sw, f, packed=pack_conv_small_int8_weights(wq))
    want = spade_c6_int8_plain(x, a_tab, b_tab, wq, sw, f)
    assert spade_c6_int8.launches == before + 1 and got.shape == x.shape
    assert got.dtype == DT[dt] and torch.equal(got, want)


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """On a CUDA tensor a wrapper launches or raises; it never falls back."""
    x = torch.zeros(4, 64, 8, 8, device=cuda)
    wq, sw = quantize_conv_weights(torch.randn(64, 64, 5, 5).to(cuda))
    launches = (conv_small_int8.launches, spade_c6_int8.launches, spade_apply_t.launches)
    wp = pack_conv_small_int8_weights(wq)
    with pytest.raises(ValueError, match="want \\(B, Cin, 8, 8\\)"):
        conv_small_int8(torch.zeros(4, 64, 16, 16, device=cuda), wq, sw, packed=wp)
    with pytest.raises(ValueError, match="int8"):
        conv_small_int8(x, wq.float(), sw, packed=wp)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_small_int8(x, wq[:12].contiguous(), sw[:12].contiguous(), packed=wp)
    with pytest.raises(ValueError, match="packed weights"):  # packed for other weights
        conv_small_int8(x, wq, sw, packed=pack_conv_small_int8_weights(wq[:, :, :, :32].contiguous()))
    with pytest.raises(ValueError, match="takes the weights packed"):  # not packed at all
        conv_small_int8(x, wq, sw)
    with pytest.raises(ValueError, match="not supported"):  # an even k
        conv_small_int8(x, wq[:, :4, :4].contiguous(), sw, k=4, packed=wp)
    with pytest.raises(ValueError, match="dtype"):
        conv_small_int8(x.half(), wq, sw, packed=wp)
    with pytest.raises(ValueError, match="contiguous"):
        conv_small_int8(x.permute(0, 1, 3, 2), wq, sw, packed=wp)
    y = torch.zeros(1, 128, 32, 32, device=cuda)
    tab = torch.zeros(1, 4, 5, 128, 20, device=cuda)
    w6q, sw6 = quantize_conv_weights(torch.randn(128, 128, 5, 5).to(cuda))
    with pytest.raises(ValueError, match="not supported"):  # C % 32: the k32 steps' chunks
        spade_c6_int8(y[:, :48].contiguous(), tab[:, :, :, :48].contiguous(),
                      tab[:, :, :, :48].contiguous(), w6q[:48, :, :, :48].contiguous(),
                      sw6[:48].contiguous(), 8)
    with pytest.raises(ValueError, match="tables"):
        spade_c6_int8(y, tab[..., :10].contiguous(), tab, w6q, sw6, 8)
    with pytest.raises(ValueError, match="w6q"):
        spade_c6_int8(y, tab, tab, w6q[:, :3].contiguous(), sw6, 8)
    with pytest.raises(ValueError, match="takes the weights packed"):
        spade_c6_int8(y, tab, tab, w6q, sw6, 8)
    with pytest.raises(ValueError, match="packed weights"):  # packed for other weights
        spade_c6_int8(y, tab, tab, w6q, sw6, 8, packed=pack_conv_small_int8_weights(w6q[:64, :, :, :64]))
    with pytest.raises(ValueError, match="tables"):
        spade_apply_t(y, tab, tab, 8)  # compact tables where flat ones are due
    assert launches == (conv_small_int8.launches, spade_c6_int8.launches, spade_apply_t.launches)


def test_int8_cell_on_card_matches_cpu(cuda):
    """The 640 -> 512 cell at the real threshold: K6 on the card against the
    plain version on the CPU; with the switch off the card runs the plain
    version and launches nothing."""
    g = torch.Generator().manual_seed(9)
    cell = init_weights(ConvLSTMCell(512, 128, int8_serving=True), g).eval()
    x = torch.randn(4, 512, 8, 8, generator=g)
    h, c = (torch.randn(4, 128, 8, 8, generator=g).mul(0.5) for _ in range(2))
    with torch.no_grad():
        want = torch.cat(cell(x, h, c), 1)
        cell.to(cuda)
        before = conv_small_int8.launches
        got = torch.cat(cell(x.to(cuda), h.to(cuda), c.to(cuda)), 1).cpu()
        assert conv_small_int8.launches == before + 1
        cell.use_int8_kernel = False
        off = torch.cat(cell(x.to(cuda), h.to(cuda), c.to(cuda)), 1).cpu()
        assert conv_small_int8.launches == before + 1
    assert _rel(got, want) < 1e-5 and _rel(off, want) < 1e-5


def _typed_case(cuda, dt, n, seed, padded=False):
    """Inputs over the typed kernels' whole domain at the 128^2 layout
    encoder's shape (c2=128, c4=256, s3=32); `padded`: v3's 13 x 13 grid."""
    g = torch.Generator().manual_seed(seed)
    s3 = 32
    ints = [torch.randint(0, hi, shape, generator=g, dtype=torch.int32).to(cuda)
            for hi, shape in ((13, (n, 14, 4)), (14, (n, 14, 4)), (14, (n, s3)), (14, (n, s3)))]
    z2 = torch.randn(n, 12, 12, 128, generator=g)
    if padded:
        z2 = torch.nn.functional.pad(z2, (0, 0, 0, 1, 0, 1))
    ab = torch.randn(n, 2, 256, generator=g).mul(0.5).to(cuda)
    weight = torch.randn(256, 128, 4, 4, generator=g).mul(0.05).to(cuda)
    return z2.to(cuda, DT[dt]), *ints, ab, weight


# n = 13: not a multiple of v3's group, and of v5's 128-row tiles
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["v3", "v5", "v6"])
def test_typed_variant_kernel_matches_plain(cuda, dt, variant):
    kernel = getattr(typed_expand, f"typed_c3_expand_{variant}")
    plain = getattr(typed_expand, f"typed_c3_expand_{variant}_plain")
    args = _typed_case(cuda, dt, 13, seed=10, padded=variant == "v3")
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1 and got.shape == (13, 256, 32, 32)
    assert _rel(got, plain(*args)) < TOL[dt]


def test_typed_v6_skips_absent_row_types(cuda):
    """v6 leaves out the product of a row type no output row has: with one
    type, and with a type outside [0, 14) (zeros), it still equals the plain
    version."""
    z2, idxR, lsel, selR, selC, ab, weight = _typed_case(cuda, "f32", 4, seed=11)
    selR[0] = 5
    selR[1, ::2] = 14
    got = typed_expand.typed_c3_expand_v6(z2, idxR, lsel, selR, selC, ab, weight)
    want = typed_c3_expand_plain(z2, idxR, lsel, selR.clamp(max=13), selC, ab, weight)
    want[1, :, ::2] = 0
    assert _rel(got, want) < TOL["f32"]


def _box_typed_inputs(cuda, dt):
    """The typed kernel's inputs as a small 128^2 model (conv_dim 16: c2 =
    32, c4 = 64) makes them from box layouts, recorded in one generate."""
    cfg = config_for(128, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23,
                     bf16=dt == "bf16")
    g = torch.Generator().manual_seed(5)
    b, o = 8, 10
    xy0 = torch.rand(b, o, 2, generator=g) * 0.6
    boxes = torch.cat([xy0, (xy0 + 0.1 + 0.3 * torch.rand(b, o, 2, generator=g)).clamp(max=1)], -1)
    ins = (torch.randint(0, cfg.num_classes, (b, o), generator=g), boxes, torch.ones(b, o),
           torch.randn(b, o, cfg.z_dim, generator=g),
           (torch.rand(b, o, cfg.attribute_dim, generator=g) < 0.1).float())
    seen, kernel = [], typed_expand.VARIANTS["v4"]
    typed_expand.VARIANTS["v4"] = lambda *a: seen.append(a) or kernel(*a)
    try:
        with torch.no_grad():
            build_generator(cfg, cuda, seed=1).generate(*(t.to(cuda) for t in ins))
    finally:
        typed_expand.VARIANTS["v4"] = kernel
    return seen[0]


@pytest.mark.parametrize("inputs", ["random", "box", "edge"])
def test_typed_v6_equals_k5_bit_for_bit(cuda, inputs):
    """v6 runs K5's kernel on the row types selR names, each row summed in
    K5's order: in bf16 the same bits as K5 and within 2e-2 of the plain
    version, on random inputs, on box-derived ones (few types an object),
    and with an object of one type and one whose rows all lie outside [0,
    14) (zeros)."""
    if inputs == "box":
        args = _box_typed_inputs(cuda, "bf16")
    else:
        args = list(_typed_case(cuda, "bf16", 13, seed=15))
        if inputs == "edge":
            sel = args[3].clone()
            sel[0], sel[1], sel[2, ::2] = 14, 5, -3
            args[3] = sel
    before = typed_expand.typed_c3_expand_v6.launches
    got = typed_expand.typed_c3_expand_v6(*args)
    assert typed_expand.typed_c3_expand_v6.launches == before + 1
    assert torch.equal(got, typed_c3_expand(*args))
    sel = args[3]
    outside = (sel < 0) | (sel >= 14)  # rows of no type are zeros; the plain version cannot index them
    want = typed_c3_expand_plain(*args[:3], sel.clamp(0, 13), *args[4:])
    assert _rel(got, want.masked_fill(outside[:, None, :, None], 0)) < TOL["bf16"]
    if inputs == "edge":
        assert not got[0].any()
    if inputs == "box":
        _, counts, _ = typed_expand.present_row_types(args[3])
        assert counts.float().mean() < 14


def test_int8_serving_at_conv_dim_60_takes_k6(cuda):
    """conv_dim 60: the wide gate conv is 600 -> 480 (480 not a multiple of
    64), which JAX's kernel takes; the port's route sends it through K6, once
    a slot, and the image matches the CPU within the int8 limit."""
    cfg = config_for(64, conv_dim=60, int8_serving=True)
    g = torch.Generator().manual_seed(4)
    b, o = 2, 3
    xy0 = torch.rand(b, o, 2, generator=g) * 0.6
    boxes = torch.cat([xy0, (xy0 + 0.2).clamp(max=1)], -1)
    ins = (torch.randint(0, cfg.num_classes, (b, o), generator=g), boxes, torch.ones(b, o),
           torch.randn(b, o, cfg.z_dim, generator=g),
           (torch.rand(b, o, cfg.attribute_dim, generator=g) < 0.1).float())
    before = conv_small_int8.launches
    with torch.no_grad():
        got = build_generator(cfg, cuda, seed=4).generate(*(t.to(cuda) for t in ins)).cpu()
    assert conv_small_int8.launches == before + o
    want = build_generator(cfg, "cpu", seed=4).generate(*ins)
    assert _rel(got, want) < 1e-3


def test_typed_v5_equals_k5_bit_for_bit(cuda):
    """v5 launches K5's kernel: at the published width (c2 128, c4 256, s3
    32), more objects than SMs, the same bits as `typed_c3_expand`."""
    args = _typed_case_at(cuda, "bf16", 300, 128, 256, 32, seed=12)
    before = typed_expand.typed_c3_expand_v5.launches
    got = typed_expand.typed_c3_expand_v5(*args)
    assert typed_expand.typed_c3_expand_v5.launches == before + 1
    assert torch.equal(got, typed_c3_expand(*args))


# the shapes the kernels K5's replaced took and K5 did not: c2 192 and 256
# (conv_dim 96 and 128), s3 24 and 56, c4 % 32 == 16, and 32-channel row-type
# groups with 8 KB staging buffers (c2 272 and 256 at s3 16)
@pytest.mark.parametrize("variant", ["v4", "v5", "v6"])
@pytest.mark.parametrize("n,c2,c4,s3", [(133, 192, 384, 32), (133, 256, 512, 32), (40, 128, 256, 24),
                                        (40, 128, 256, 56), (17, 48, 80, 24), (40, 272, 544, 16),
                                        (40, 256, 1024, 16)])
def test_typed_kernels_at_the_widened_shapes(cuda, variant, n, c2, c4, s3):
    args = _typed_case_at(cuda, "bf16", n, c2, c4, s3, seed=c2 + s3)
    kernel = typed_expand.VARIANTS[variant]
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1 and got.shape == (n, c4, s3, s3)
    assert _rel(got, typed_c3_expand_plain(*args)) < TOL["bf16"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["flat", "compact", "transposed"])
def test_head_kernel_modes_at_the_c7_shape(cuda, dt, mode):
    """K2 at the c7 head's shape (C=128, 128^2, f=16, K=7), which needs its
    channel tiling, batch cut to 4, in each of its modes."""
    x, a_tab, b_tab, g = _compact_case(cuda, dt, 4, 128, 128, seed=13)
    weight = torch.randn(3, 128, 7, 7, generator=g).mul(0.02).to(cuda)
    bias = torch.randn(3, generator=g).to(cuda)
    kw = {"compact": mode == "compact", "transposed": mode == "transposed"}
    if mode != "compact":
        a_tab, b_tab = (compact_to_flat(t, 16).contiguous() for t in (a_tab, b_tab))
    if mode == "transposed":
        x = x.permute(2, 3, 0, 1).contiguous()
    before = dict(spade_few_out_conv.mode_launches)
    got = spade_few_out_conv(x, a_tab, b_tab, weight, bias, 16, **kw)
    want = spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, 16, **kw)
    after = spade_few_out_conv.mode_launches
    assert {m: after[m] - before[m] for m in after} == {m: int(m == mode) for m in after}
    assert got.shape == (4, 3, 128, 128) and _rel(got, want) < TOL[dt]


@pytest.mark.parametrize("kw,kernels", [
    ({"typed_c3": "v5"}, ("typed_c3_expand_v5",)),
    ({"typed_c3": "v6"}, ("typed_c3_expand_v6",)),
    ({"use_head8_kernel": False}, ("compact",)),
    ({"use_head8_kernel": False, "use_compact_heads": False}, ("flat",)),
])
def test_generate_variants_on_card_match_cpu(cuda, kw, kernels):
    """Each A/B configuration on the card, f32, against the plain path on
    the CPU; its kernel launches and the one it replaces does not."""
    cfg = config_for(128, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23, **kw)
    g = torch.Generator().manual_seed(3)
    b, o = 2, 4
    objs = torch.randint(0, cfg.num_classes, (b, o), generator=g)
    xy0 = torch.rand(b, o, 2, generator=g) * 0.6
    boxes = torch.cat([xy0, (xy0 + 0.1 + 0.3 * torch.rand(b, o, 2, generator=g)).clamp(max=1)], -1)
    ins = (objs, boxes, torch.ones(b, o), torch.randn(b, o, cfg.z_dim, generator=g),
           (torch.rand(b, o, cfg.attribute_dim, generator=g) < 0.1).float())

    def counts():
        return {"typed_c3_expand": typed_c3_expand.launches,
                "typed_c3_expand_v5": typed_expand.typed_c3_expand_v5.launches,
                "typed_c3_expand_v6": typed_expand.typed_c3_expand_v6.launches,
                "spade_few_out_conv8": spade_few_out_conv8.launches,
                **spade_few_out_conv.mode_launches}

    before = counts()
    got = build_generator(cfg, cuda, seed=1).generate(*(t.to(cuda) for t in ins)).cpu()
    ran = {name: n - before[name] for name, n in counts().items()}
    want = build_generator(cfg, "cpu", seed=1).generate(*ins)
    typed = "typed_c3_expand" if "typed_c3" not in kw else kernels[0]
    expect = {typed: 1, "flat": 1}  # the c4 head, always on flat tables
    if "use_head8_kernel" in kw:
        expect[kernels[0]] = expect.get(kernels[0], 0) + 1
    else:
        expect["spade_few_out_conv8"] = 1
    assert {name: n for name, n in ran.items() if n} == expect
    assert _rel(got, want) < 1e-4  # f32: summation order only


def test_variant_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """On a CUDA tensor a wrapper launches or raises; it never falls back."""
    z2, idxR, lsel, selR, selC, ab, weight = _typed_case(cuda, "bf16", 2, seed=14)
    v3, v5, v6 = (getattr(typed_expand, f"typed_c3_expand_v{i}") for i in (3, 5, 6))
    launches = [k.launches for k in (v3, v5, v6, spade_few_out_conv)]
    with pytest.raises(ValueError, match="z2 shape"):
        v3(z2, idxR, lsel, selR, selC, ab, weight)  # the raw grid where the padded one is due
    with pytest.raises(ValueError, match="z2 shape"):  # c2 % 16, which K5's kernel needs
        v5(z2[..., :24].contiguous(), idxR, lsel, selR, selC, ab, weight[:, :24].contiguous())
    with pytest.raises(ValueError, match="weight shape"):  # c4 % 16
        v5(z2, idxR, lsel, selR, selC, ab[..., :40].contiguous(), weight[:40].contiguous())
    with pytest.raises(ValueError, match="int32"):
        v6(z2, idxR.long(), lsel, selR, selC, ab, weight)
    with pytest.raises(ValueError, match="dtype"):
        v6(z2.half(), idxR, lsel, selR, selC, ab, weight)
    x = torch.zeros(2, 16, 32, 32, device=cuda)
    flat, compact = torch.zeros(2, 4, 5, 16, 32, device=cuda), torch.zeros(2, 4, 5, 16, 20, device=cuda)
    w = torch.zeros(3, 16, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="tables"):
        spade_few_out_conv(x, flat, flat, w, None, 8, compact=True)
    with pytest.raises(ValueError, match="tables"):
        spade_few_out_conv(x, compact, compact, w, None, 8)
    with pytest.raises(ValueError, match="not supported"):
        spade_few_out_conv(x, compact, compact, w, None, 8, compact=True, transposed=True)
    x6 = torch.zeros(32, 32, 2, 6, device=cuda)  # C = 6: no 16-byte vector of channels
    with pytest.raises(ValueError, match="transposed x needs"):
        spade_few_out_conv(x6, flat[:, :, :, :6].contiguous(), flat[:, :, :, :6].contiguous(),
                           w[:, :6].contiguous(), None, 8, transposed=True)
    assert launches == [k.launches for k in (v3, v5, v6, spade_few_out_conv)]


# ---- K3 and K5 as redesigned for the tensor cores: shapes the tests above do not reach


def _border(h, w, r):
    """The pixels within r of the image's edge."""
    mask = torch.ones(h, w, dtype=torch.bool)
    mask[r:h - r, r:w - r] = False
    return mask


# b = 5 and 3: no multiple of anything the grid could like; C = 32 is the small model's c7 head
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c", [(5, 32), (3, 128)])
def test_head8_kernel_at_odd_batches_and_at_the_border(cuda, dt, b, c):
    x, a_tab, b_tab, g = _compact_case(cuda, dt, b, c, 128, seed=20)
    weight = torch.randn(3, c, 7, 7, generator=g).mul(0.02).to(cuda)
    got = spade_few_out_conv8(x, a_tab, b_tab, weight, None, 16)
    want = spade_few_out_conv8_plain(x, a_tab, b_tab, weight, None, 16)
    edge = _border(128, 128, 3)
    assert got.shape == (b, 3, 128, 128) and _rel(got, want) < TOL[dt]
    assert _rel(got[..., edge], want[..., edge]) < TOL[dt]  # where rows and columns outside add zero


@pytest.mark.parametrize("k,o", [(5, 4), (3, 1), (7, 4)])
def test_head8_kernel_at_64_columns(cuda, k, o):
    """The bf16 kernel's other width, every count of column tiles (K O / 8
    rounded up: 3, 1, 4)."""
    x, a_tab, b_tab, g = _compact_case(cuda, "bf16", 2, 48, 64, seed=21)
    weight = torch.randn(o, 48, k, k, generator=g).mul(0.05).to(cuda)
    bias = torch.randn(o, generator=g).to(cuda)
    got = spade_few_out_conv8(x, a_tab, b_tab, weight, bias, 8)
    assert _rel(got, spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, 8)) < TOL["bf16"]


def test_head8_kernel_twice_on_a_side_stream(cuda):
    """Two launches back to back on a stream that is not the default one:
    the second finds the barriers and buffers as the first did."""
    x, a_tab, b_tab, g = _compact_case(cuda, "bf16", 4, 128, 128, seed=22)
    weight = torch.randn(3, 128, 7, 7, generator=g).mul(0.02).to(cuda)
    bias = torch.randn(3, generator=g).to(cuda)
    want = spade_few_out_conv8_plain(x, a_tab, b_tab, weight, bias, 16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = spade_few_out_conv8(x, a_tab, b_tab, weight, bias, 16)
        second = spade_few_out_conv8(x, a_tab, b_tab, weight, bias, 16)
    side.synchronize()
    assert torch.equal(first, second) and _rel(first, want) < TOL["bf16"]


def _typed_case_at(cuda, dt, n, c2, c4, s3, seed):
    g = torch.Generator().manual_seed(seed)
    ints = [torch.randint(0, hi, shape, generator=g, dtype=torch.int32).to(cuda)
            for hi, shape in ((13, (n, 14, 4)), (14, (n, 14, 4)), (14, (n, s3)), (14, (n, s3)))]
    z2 = torch.randn(n, 12, 12, c2, generator=g).to(cuda, DT[dt])
    ab = torch.randn(n, 2, c4, generator=g).mul(0.5).to(cuda)
    weight = torch.randn(c4, c2, 4, 4, generator=g).mul(0.05).to(cuda)
    return z2, *ints, ab, weight


# n = 1: one block; n = 133: one more object than the card has SMs, so one
# persistent block takes a second object; the small model's widths, and s3 = 16
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,c2,c4,s3", [(1, 128, 256, 32), (133, 128, 256, 32), (133, 32, 64, 32),
                                        (7, 64, 96, 16)])
def test_typed_kernel_at_other_counts_and_widths(cuda, dt, n, c2, c4, s3):
    args = _typed_case_at(cuda, dt, n, c2, c4, s3, seed=23)
    got = typed_c3_expand(*args)
    assert got.shape == (n, c4, s3, s3) and _rel(got, typed_c3_expand_plain(*args)) < TOL[dt]


def test_typed_kernel_keeps_out_of_range_types_zero(cuda):
    """selR and selC outside [0, 14) give zeros, as in the plain version."""
    z2, idxR, lsel, selR, selC, ab, weight = _typed_case_at(cuda, "bf16", 3, 32, 64, 32, seed=24)
    selR[0, ::3] = 14
    selC[1, 5:9] = -1
    got = typed_c3_expand(z2, idxR, lsel, selR, selC, ab, weight)
    want = typed_c3_expand_plain(z2, idxR, lsel, selR.clamp(0, 13), selC.clamp(0, 13), ab, weight)
    want[0, :, ::3] = 0
    want[1, :, :, 5:9] = 0
    assert _rel(got, want) < TOL["bf16"] and (got[0, :, ::3] == 0).all() and (got[1, :, :, 5:9] == 0).all()


def test_typed_kernel_twice_on_a_side_stream(cuda):
    """Two launches back to back on a stream that is not the default one, each
    with more objects than SMs: the weight ring and the barriers' phases start
    anew in the second."""
    args = _typed_case_at(cuda, "bf16", 300, 128, 256, 32, seed=25)
    want = typed_c3_expand_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = typed_c3_expand(*args)
        second = typed_c3_expand(*args)
    side.synchronize()
    assert torch.equal(first, second) and _rel(first, want) < TOL["bf16"]


def test_redesigned_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """On a CUDA tensor a wrapper launches or raises a ValueError that names
    the limit; it never falls back."""
    launches = (spade_few_out_conv8.launches, typed_c3_expand.launches)
    bf = torch.bfloat16

    def head(b, c, size, f, k=7, dt=bf):
        x = torch.zeros(b, c, size, size, device=cuda, dtype=dt)
        tab = torch.zeros(b, size // f, 5, c, size // f * 5, device=cuda, dtype=dt)
        return x, tab, tab.clone(), torch.zeros(3, c, k, k, device=cuda)

    x, a_tab, b_tab, w = head(1, 32, 32, 8)
    with pytest.raises(ValueError, match="W in \\(64, 128\\)"):
        spade_few_out_conv8(x, a_tab, b_tab, w, None, 8)
    x, a_tab, b_tab, w = head(1, 24, 64, 8)
    with pytest.raises(ValueError, match="C % 16 == 0"):
        spade_few_out_conv8(x, a_tab, b_tab, w, None, 8)
    x, a_tab, b_tab, w = head(1, 32, 64, 8)
    shifted = torch.zeros(x.numel() + 1, device=cuda, dtype=bf)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        spade_few_out_conv8(shifted, a_tab, b_tab, w, None, 8)
    x, a_tab, b_tab, w = head(1, 32, 24, 8, dt=torch.float32)
    with pytest.raises(ValueError, match="dividing 1024"):
        spade_few_out_conv8(x, a_tab, b_tab, w, None, 8)
    z2, idxR, lsel, selR, selC, ab, weight = _typed_case_at(cuda, "bf16", 2, 32, 64, 20, seed=26)
    with pytest.raises(ValueError, match="selector shapes"):  # s3 % 8
        typed_c3_expand(z2, idxR, lsel, selR, selC, ab, weight)
    args = _typed_case_at(cuda, "bf16", 2, 320, 640, 32, seed=27)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        typed_c3_expand(*args)
    assert launches == (spade_few_out_conv8.launches, typed_c3_expand.launches)


# ---- K1 and K2 on the tensor cores, and the routes that fall through by shape


def _trunk_case(cuda, b, c, r, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(b, c, 8, 8, generator=g).to(cuda, torch.bfloat16)
    w1, w2 = (torch.randn(r, c, c, 3, 3, generator=g).div(3 * c ** 0.5).to(cuda) for _ in range(2))
    ab1, ab2 = (torch.stack([1 + 0.1 * torch.randn(r, c, generator=g),
                             0.1 * torch.randn(r, c, generator=g)], 1).to(cuda) for _ in range(2))
    return h, w1, w2, ab1, ab2


def _route_delta(kernel, before):
    return {k: n - before[k] for k, n in kernel.route_launches.items() if n != before[k]}


# odd batches; every C of the published models' trunks and the small ones'
@pytest.mark.parametrize("b,c,r", [(5, 16, 2), (3, 32, 2), (7, 64, 6), (3, 128, 2), (1, 48, 1)])
def test_trunk_tc_kernel_matches_plain(cuda, b, c, r):
    args = _trunk_case(cuda, b, c, r, seed=30 + c)
    before = dict(residual_trunk.route_launches)
    got = residual_trunk(*args)
    assert _route_delta(residual_trunk, before) == {"tc": 1}
    assert got.shape == (b, c, 8, 8) and got.dtype == torch.float32
    assert _rel(got, residual_trunk_plain(*args)) < TOL["bf16"]


def test_trunk_tc_kernel_twice_on_a_side_stream(cuda):
    """Two launches back to back on another stream: the weight ring's
    barriers start anew in the second."""
    args = _trunk_case(cuda, 130, 64, 6, seed=31)
    want = residual_trunk_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = residual_trunk(*args)
        second = residual_trunk(*args)
    side.synchronize()
    assert torch.equal(first, second) and _rel(first, want) < TOL["bf16"]


def _flat_case(cuda, b, c, size, seed):
    x, a_tab, b_tab, g = _compact_case(cuda, "bf16", b, c, size, seed)
    f = size // 8
    return x, *(compact_to_flat(t, f).contiguous() for t in (a_tab, b_tab)), g


# the c4 head (64 columns, f = 8) at odd batches, C of the small and the
# published models; the c7 head's shape (128 columns, f = 16) in both modes
@pytest.mark.parametrize("b,c,size,compact", [(5, 16, 64, False), (3, 32, 64, False),
                                              (3, 64, 64, False), (2, 128, 64, False),
                                              (3, 128, 128, False), (3, 128, 128, True),
                                              (5, 32, 128, True), (3, 64, 128, False)])
def test_head_tc_kernel_matches_plain(cuda, b, c, size, compact):
    case = _compact_case if compact else _flat_case
    x, a_tab, b_tab, g = (case(cuda, "bf16", b, c, size, seed=32) if compact
                          else case(cuda, b, c, size, seed=32))
    f = size // 8
    weight = torch.randn(3, c, 7, 7, generator=g).mul(0.02).to(cuda)
    bias = torch.randn(3, generator=g).to(cuda)
    before = dict(spade_few_out_conv.route_launches)
    got = spade_few_out_conv(x, a_tab, b_tab, weight, bias, f, compact=compact)
    want = spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f, compact=compact)
    assert _route_delta(spade_few_out_conv, before) == {"tc": 1}
    edge = _border(size, size, 3)
    assert got.shape == (b, 3, size, size) and _rel(got, want) < TOL["bf16"]
    assert _rel(got[..., edge], want[..., edge]) < TOL["bf16"]


def test_head_tc_kernel_twice_on_a_side_stream(cuda):
    x, a_tab, b_tab, g = _flat_case(cuda, 6, 64, 64, seed=33)
    weight = torch.randn(3, 64, 7, 7, generator=g).mul(0.02).to(cuda)
    want = spade_few_out_conv_plain(x, a_tab, b_tab, weight, None, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = spade_few_out_conv(x, a_tab, b_tab, weight, None, 8)
        second = spade_few_out_conv(x, a_tab, b_tab, weight, None, 8)
    side.synchronize()
    assert torch.equal(first, second) and _rel(first, want) < TOL["bf16"]


@pytest.mark.parametrize("b,c,size", [(3, 128, 128), (2, 48, 64)])
def test_head_compact_equals_head8_bit_for_bit(cuda, b, c, size):
    """K2 on compact tables runs K3's very kernel: the same bits."""
    x, a_tab, b_tab, g = _compact_case(cuda, "bf16", b, c, size, seed=34)
    weight = torch.randn(3, c, 7, 7, generator=g).mul(0.02).to(cuda)
    bias = torch.randn(3, generator=g).to(cuda)
    f = size // 8
    k2 = spade_few_out_conv(x, a_tab, b_tab, weight, bias, f, compact=True)
    assert torch.equal(k2, spade_few_out_conv8(x, a_tab, b_tab, weight, bias, f))


def _generate_inputs(cfg, b, o, seed):
    from aglayout_tpu_torch.bench import layouts

    return layouts(cfg, b, o, seed=seed, device="cpu")


@pytest.mark.parametrize("size", [64, 128])
def test_default_generate_takes_the_tensor_core_routes(cuda, size):
    """The default configuration at the published widths, bf16: K1 and K2
    launch on the tensor cores, once each."""
    cfg = config_for(size, bf16=True)
    ins = _generate_inputs(cfg, 2, 4, seed=4)
    model = build_generator(cfg, cuda, seed=0)
    before = (dict(residual_trunk.route_launches), dict(spade_few_out_conv.route_launches))
    img = model.generate(*(t.to(cuda) for t in ins))
    assert _route_delta(residual_trunk, before[0]) == {"tc": 1}
    assert _route_delta(spade_few_out_conv, before[1]) == {"tc": 1}
    assert img.shape == (2, size, size, 3) and torch.isfinite(img.float()).all()


@pytest.mark.parametrize("size", [64, 128])
def test_generate_at_conv_dim_12_falls_through(cuda, size):
    """conv_dim = 12, bf16: no tensor-core kernel takes C % 16 != 0, nor the
    typed kernels c2 = 24; each site takes the next route (the FMA kernels,
    K2 for the c7 head, the plain typed expansion). The image agrees with
    the kernels-off path on the card, and with the f32 plain path on the
    CPU within bf16's limits at this width (chip_smoke's fall-through
    phase)."""
    small = dict(conv_dim=12, clstm_layers=2, resi_num=2, num_classes=23)
    cfg = config_for(size, bf16=True, **small)
    ins = _generate_inputs(cfg, 3, 4, seed=5)
    model = build_generator(cfg, cuda, seed=1)
    counters = (residual_trunk, spade_few_out_conv, spade_few_out_conv8, typed_c3_expand)
    before = [dict(getattr(k, "route_launches", {"all": k.launches})) for k in counters]
    got = model.generate(*(t.to(cuda) for t in ins)).float().cpu()
    after = [dict(getattr(k, "route_launches", {"all": k.launches})) for k in counters]
    for owner in model.modules():
        for name in ("use_trunk_kernel", "use_head_kernel", "use_typed_kernel", "use_apply_kernel",
                     "use_head8_kernel"):
            if hasattr(owner, name):
                setattr(owner, name, False)
    off = model.generate(*(t.to(cuda) for t in ins)).float().cpu()
    want = build_generator(config_for(size, **small), "cpu", seed=1).generate(*ins)
    ran = [{r: n - b[r] for r, n in a.items() if n != b[r]} for a, b in zip(after, before)]
    assert ran == [{"fma": 1}, {"fma": 1 if size == 64 else 2}, {}, {}]
    mean_rel = lambda a, b: ((a - b).abs().mean() / b.abs().mean()).item()  # noqa: E731
    # bf16 weighs more at this width: the mean limit is the 128^2 one at both sizes
    assert _rel(got, off) < 5e-2 and mean_rel(got, off) < 3e-2
    assert _rel(got, want) < 5e-2 and mean_rel(got, want) < 3e-2


def test_tc_wrappers_raise_on_what_no_kernel_takes(cuda):
    """On a CUDA tensor K1 and K2 launch one of their kernels or raise."""
    launches = (residual_trunk.launches, spade_few_out_conv.launches)
    h = torch.zeros(2, 6, 8, 8, device=cuda)  # C % 4: neither trunk kernel
    w = torch.zeros(1, 6, 6, 3, 3, device=cuda)
    ab = torch.zeros(1, 2, 6, device=cuda)
    with pytest.raises(ValueError, match="input shape"):
        residual_trunk(h, w, w, ab, ab)
    h = torch.zeros(2, 120, 8, 8, device=cuda, dtype=torch.bfloat16)  # tc: C % 16; fma: smem
    w = torch.zeros(1, 120, 120, 3, 3, device=cuda)
    ab = torch.zeros(1, 2, 120, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        residual_trunk(h, w, w, ab, ab)
    x, a_tab, b_tab, _ = _flat_case(cuda, 1, 64, 64, seed=35)
    with pytest.raises(ValueError, match="weight shape"):  # K = 9
        spade_few_out_conv(x, a_tab, b_tab, torch.zeros(3, 64, 9, 9, device=cuda), None, 8)
    with pytest.raises(ValueError, match="with f=4"):
        spade_few_out_conv(x, a_tab, b_tab, torch.zeros(3, 64, 7, 7, device=cuda), None, 4)
    assert launches == (residual_trunk.launches, spade_few_out_conv.launches)


# ---- K2t (the transposed mode on the tensor-core kernel, x by a TMA tensor
# copy) and v3 (K5's kernel reading the zero-padded grid in place)


def _transposed_case(cuda, b, c, h, w, f, seed):
    """x (h, w, b, c) bf16 and flat tables (b, h / f, 5, c, w) around the
    folded affine's scale (A near 1, B near 0)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(h, w, b, c, generator=g).to(cuda, torch.bfloat16)
    a_tab = (1 + 0.3 * torch.randn(b, h // f, 5, c, w, generator=g)).to(cuda, torch.bfloat16)
    b_tab = (0.3 * torch.randn(b, h // f, 5, c, w, generator=g)).to(cuda, torch.bfloat16)
    return x, a_tab, b_tab, g


# B 2-8, C 16-128, W 64 and 128, K 3/5/7, O 1-4, f 8 and 16, H other than
# W; the first and last tiles' halos leave the image, which `edge` checks
@pytest.mark.parametrize("b,c,h,w,k,o,f", [(2, 16, 64, 64, 7, 3, 8), (3, 128, 128, 128, 7, 3, 16),
                                           (5, 32, 64, 128, 5, 4, 16), (8, 64, 80, 64, 3, 1, 8),
                                           (4, 48, 48, 64, 5, 2, 8), (2, 128, 32, 128, 3, 4, 16)])
def test_transposed_head_tc_kernel_matches_plain(cuda, b, c, h, w, k, o, f):
    x, a_tab, b_tab, g = _transposed_case(cuda, b, c, h, w, f, seed=50 + c + k)
    weight = torch.randn(o, c, k, k, generator=g).mul(0.02).to(cuda)
    bias = torch.randn(o, generator=g).to(cuda)
    before = dict(spade_few_out_conv.route_launches)
    got = spade_few_out_conv(x, a_tab, b_tab, weight, bias, f, transposed=True)
    want = spade_few_out_conv_plain(x, a_tab, b_tab, weight, bias, f, transposed=True)
    assert _route_delta(spade_few_out_conv, before) == {"tc": 1}
    edge = _border(h, w, k // 2)
    assert got.shape == (b, o, h, w) and _rel(got, want) < TOL["bf16"]
    assert _rel(got[..., edge], want[..., edge]) < TOL["bf16"]


# the c4 head's shape and the c7 head's
@pytest.mark.parametrize("b,c,size,f", [(3, 64, 64, 8), (3, 128, 128, 16)])
def test_transposed_head_equals_flat_bit_for_bit(cuda, b, c, size, f):
    """K2t's product, sums and roundings are flat K2's: the same bits as K2
    on the same flat tables with x permuted to (B, C, H, W)."""
    x, a_tab, b_tab, g = _transposed_case(cuda, b, c, size, size, f, seed=60 + c)
    weight = torch.randn(3, c, 7, 7, generator=g).mul(0.02).to(cuda)
    bias = torch.randn(3, generator=g).to(cuda)
    before = dict(spade_few_out_conv.mode_launches)
    got = spade_few_out_conv(x, a_tab, b_tab, weight, bias, f, transposed=True)
    flat = spade_few_out_conv(x.permute(2, 3, 0, 1).contiguous(), a_tab, b_tab, weight, bias, f)
    after = spade_few_out_conv.mode_launches
    assert {m: after[m] - before[m] for m in after} == {"flat": 1, "compact": 0, "transposed": 1}
    assert torch.equal(got, flat)


# n = 13: not a multiple of anything the old group schedule liked; the
# published width in both dtypes, and K5's widened shapes in bf16
@pytest.mark.parametrize("dt,n,c2,c4,s3", [("f32", 13, 128, 256, 32), ("bf16", 13, 128, 256, 32),
                                           ("bf16", 13, 192, 384, 32), ("bf16", 13, 16, 64, 32),
                                           ("f32", 13, 16, 64, 32), ("bf16", 140, 192, 384, 32)])
def test_typed_v3_equals_k5_on_the_inner_grid(cuda, dt, n, c2, c4, s3):
    """v3 launches K5's kernel on the padded grid, read in place: K5's bits
    on the inner 12 x 12, whatever the padding holds."""
    z2, *rest = _typed_case_at(cuda, dt, n, c2, c4, s3, seed=70 + c2)
    z2p = torch.nn.functional.pad(z2, (0, 0, 0, 1, 0, 1))
    v3 = typed_expand.typed_c3_expand_v3
    before = v3.launches
    got = v3(z2p, *rest)
    assert v3.launches == before + 1 and got.shape == (n, c4, s3, s3)
    want = typed_c3_expand(z2, *rest)
    assert torch.equal(got, want)
    z2p[:, 12], z2p[:, :, 12] = 7.0, -3.0  # the kernel reads none of it
    assert torch.equal(v3(z2p, *rest, group=1), want)


# ---- the discriminators: no kernel of the port (cuDNN's convs), on the card all the same


@pytest.mark.parametrize("index,side", [(0, 128), (1, 64), (2, 64)])
def test_discriminator_on_card_matches_cpu(cuda, index, side):
    """The image (128^2), object and attribute (64^2 crops, its sixth block)
    discriminators at d_conv_dim 8 in f32 on the card against the same
    modules on the CPU: one call with update_stats, then one without."""
    import copy

    cfg = config_for(128, d_conv_dim=8, num_classes=23, attribute_dim=12)
    ref = build_discriminators(cfg, "cpu", seed=4)[index]
    net = copy.deepcopy(ref).to(cuda)
    x = torch.randn(3, 3, side, side, generator=torch.Generator().manual_seed(index))
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)  # noqa: E731
    for update_stats in (True, False):
        with torch.no_grad():
            want, got = as_tuple(ref(x, update_stats)), as_tuple(net(x.to(cuda), update_stats))
        for g, w in zip(got, want, strict=True):
            assert _rel(g.cpu(), w) <= 1e-4  # summation order, over 14 convs
        for (key, a), b in zip(net.state_dict().items(), ref.state_dict().values()):
            if key.endswith(("weight_u", "weight_v")):
                assert (a.cpu() - b).abs().max().item() <= 1e-5, key


# ---- the train step: the models in training mode, no kernel of the port

def _all_launches():
    from aglayout_tpu_torch.ops.typed_expand import (
        typed_c3_expand_v3,
        typed_c3_expand_v5,
        typed_c3_expand_v6,
    )

    return sum(k.launches for k in (residual_trunk, spade_few_out_conv, spade_few_out_conv8,
                                    spade_apply8, spade_apply_t, typed_c3_expand,
                                    typed_c3_expand_v3, typed_c3_expand_v5, typed_c3_expand_v6,
                                    conv_small_int8, spade_c6_int8))


@pytest.mark.parametrize("size", [64, 128])
def test_train_step_on_card_matches_cpu(cuda, size):
    """A small f32 step (TF32 off) on the card against the CPU, same
    weights, batch and draws (`train/compare.py`): metrics within 1e-4
    relative; params within 1e-6 where Adam's first step is the same for
    both gradients (`adam_sure`), within 2 lr anywhere."""
    cfg = config_for(size, **TRAIN_SMALL)
    err = compare_steps(cfg, ("cpu", cuda), step_draws(cfg, size))
    assert err["metrics"] <= 1e-4, err
    assert err["params_sure"] <= 1e-6 and err["params_any"] <= err["params_any_tol"] + 1e-6, err


@pytest.mark.parametrize("bf16", [True, False])
def test_train_step_at_full_width_launches_no_kernel(cuda, bf16):
    """The 64^2 model at its published widths, B=2: one step launches none of
    the port's kernels, its metrics are finite and all four nets move."""
    cfg = config_for(64, batch_size=2, bf16=bf16)
    before = _all_launches()
    state, metrics = run_step(cfg, cuda)
    torch.cuda.synchronize()
    assert _all_launches() == before
    assert all(torch.isfinite(v).all() for k, v in metrics.items() if k != "images")
    from aglayout_tpu_torch.train.state import build_models

    fresh = build_models(cfg, "cpu", seed=0)
    for name, m in state.models.items():
        assert any(not torch.equal(p.detach().cpu(), q) for p, q in
                   zip(m.parameters(), getattr(fresh, name).parameters())), name


def test_generate_after_a_train_step_takes_its_kernels(cuda):
    """A trained 64^2 bf16 generator, put in eval mode, serves through K1 and
    K2 again."""
    cfg = config_for(64, batch_size=2, bf16=True)
    state, _ = run_step(cfg, cuda)
    g = state.models.g.eval()
    k1, k2 = residual_trunk.launches, spade_few_out_conv.launches
    gen = torch.Generator().manual_seed(1)
    b, o = 8, cfg.max_objects
    boxes = torch.rand(b, o, 2, generator=gen) * 0.6
    boxes = torch.cat([boxes, boxes + 0.3], -1)
    img = g.generate(torch.randint(0, 179, (b, o), generator=gen).to(cuda), boxes.to(cuda),
                     torch.ones(b, o).to(cuda), torch.randn(b, o, 64, generator=gen).to(cuda),
                     torch.zeros(b, o, 106).to(cuda))
    torch.cuda.synchronize()
    assert residual_trunk.launches == k1 + 1 and spade_few_out_conv.launches == k2 + 1
    assert torch.isfinite(img.float()).all()


def test_fresh_train_state_on_card_starts_at_jax_bn_state(cuda):
    """A fresh state made on the card at the 64^2 published widths, B=2:
    every generator BN at JAX's fresh values (running mean 0, variance 1,
    weight 1, bias 0, no batch tracked), and one f32 step from it (TF32
    off) gives finite metrics; `build_generator` on the card keeps its
    drawn BN state."""
    from aglayout_tpu_torch.bench import train_inputs
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.models.norms import MaskedBatchNorm
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    cfg = config_for(64, batch_size=2)
    state = create_train_state(cfg, cuda, seed=0)
    bns = [m for m in state.models.g.modules() if isinstance(m, MaskedBatchNorm)]
    assert bns
    for m in bns:
        assert m.running_mean.is_cuda and not m.running_mean.any()
        assert torch.equal(m.running_var, torch.ones_like(m.running_var))
        assert m.num_batches_tracked.item() == 0
        if m.affine:
            assert torch.equal(m.weight.detach(), torch.ones_like(m.weight))
            assert not m.bias.any()
    batch, matrix, pos_weight = train_inputs(cfg, cfg.batch_size, 0)
    state, metrics = make_train_step(cfg, state.models, matrix, pos_weight)(
        state, batch_to_torch(batch, cuda))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for k, v in metrics.items() if k != "images")
    assert all(m.num_batches_tracked.item() >= 1 for m in bns)
    drawn = [m for m in build_generator(cfg, cuda, seed=0).modules()
             if isinstance(m, MaskedBatchNorm)]
    assert all(m.running_var.is_cuda and not torch.equal(m.running_var,
                                                         torch.ones_like(m.running_var))
               for m in drawn)


# ---- the trainer (train/loop.py, utils/checkpoint.py) on the card


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A CUDA state after one step, saved and restored into a fresh one:
    every tensor, the Adams (moments and, capturable, step counts on the
    card, as a fresh Adam there keeps them), the CUDA generator's state and
    the step."""
    from aglayout_tpu_torch.train.compare import state_mismatches
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.utils.checkpoint import restore_state, save_state

    cfg = config_for(64, **TRAIN_SMALL)
    state, _ = run_step(cfg, cuda)
    save_state(str(tmp_path), state.step, state)
    restored, start = restore_state(str(tmp_path), create_train_state(cfg, cuda, seed=1), "l")
    assert start == 1 and state_mismatches(state, restored) == []
    assert restored.rng.device.type == "cuda"
    for opt in restored.opt.values():
        for s in opt.state.values():
            assert s["step"].is_cuda and s["exp_avg"].is_cuda
    assert torch.equal(torch.randn(7, generator=state.rng, device=cuda),
                       torch.randn(7, generator=restored.rng, device=cuda))


def test_train_loop_on_card(cuda, tmp_path):
    """A few steps of the loop on the synthetic stream: logs, a checkpoint,
    finite metrics, the state on the card; no kernel of the port launches."""
    from aglayout_tpu_torch.train.__main__ import synthetic_stream
    from aglayout_tpu_torch.train.loop import prepare_dirs, train
    from aglayout_tpu_torch.utils.checkpoint import saved_steps

    cfg = config_for(64, **dict(TRAIN_SMALL, log_step=1, save_step=2, allow_uniform_matrix=True,
                                path=str(tmp_path), vg_dir=str(tmp_path)))
    before = _all_launches()
    state, metrics = train(cfg, loader=synthetic_stream(cfg), niter=3, use_tensorboard=False,
                           device="cuda")
    torch.cuda.synchronize()
    assert state.step == 3 and saved_steps(prepare_dirs(cfg)["models"]) == [2]
    assert all(torch.isfinite(v).all() for k, v in metrics.items() if k != "images")
    assert all(p.is_cuda for _, m in state.models.items() for p in m.parameters())
    assert _all_launches() == before


def test_restored_generator_serves_through_the_128_path(cuda, tmp_path):
    """The full-width 128^2 generator after a bf16 step, saved, loaded into
    `build_generator` in eval mode: generate launches the 128^2 path's five
    kernels once each and equals the trained generator in memory."""
    from chip_smoke import PATH128, launch_counts
    from aglayout_tpu_torch.utils.checkpoint import checkpoint_path, save_state

    cfg = config_for(128, batch_size=2, bf16=True)
    state, _ = run_step(cfg, cuda)
    save_state(str(tmp_path), state.step, state)
    g = build_generator(cfg, cuda, seed=3).eval()
    g.load_state_dict(torch.load(checkpoint_path(str(tmp_path), 1), map_location=cuda,
                                 weights_only=True)["nets"]["g"])
    ins = [t.to(cuda) for t in _generate_inputs(cfg, 16, 10, seed=2)]
    launch_counts(reset=True)
    img = g.generate(*ins)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == PATH128
    assert torch.equal(img, state.models.g.eval().generate(*ins))


# ---- inference and the evaluation networks (the infer and eval slice)

def _eval_case(size, device, seed=1):
    """A small f32 model's eval-forward inputs and outputs on `device`."""
    from aglayout_tpu_torch.data.synthetic import batch_to_torch, synthetic_batch
    from aglayout_tpu_torch.infer.generate import eval_forward

    cfg = config_for(size, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23, max_objects=4)
    batch = batch_to_torch(
        synthetic_batch(np.random.RandomState(seed), 2, 4, size, 23, cfg.attribute_dim), device)
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(2, 4, cfg.z_dim, generator=g).to(device)
    eps = torch.randn(8, cfg.z_dim, generator=g).to(device)
    with torch.inference_mode():
        return eval_forward(build_generator(cfg, device, seed=seed), batch, z, batch["attribute"],
                            batch["attribute"], eps)


@pytest.mark.parametrize("size", [64, 128])
def test_eval_forward_on_card_matches_cpu(cuda, size):
    """The eval-mode forward, kernels on, on the card against the CPU: each
    of K1-K5 (K1, K2 at 64^2) three times, once a branch, f32 1e-4."""
    from chip_smoke import PATH64, PATH128, launch_counts

    launch_counts(reset=True)
    got = _eval_case(size, cuda)
    torch.cuda.synchronize()
    path = PATH64 if size == 64 else PATH128
    assert {k: v for k, v in launch_counts().items() if v} == {k: 3 * n for k, n in path.items()}
    want = _eval_case(size, "cpu")
    for k, w in want.items():
        assert _rel(got[k].cpu(), w) < 1e-4, k


def test_inception_on_card_matches_cpu(cuda, tmp_path):
    """InceptionV3 pool3 and logits, f32 with TF32 off, card against CPU."""
    from chip_smoke import seeded_inception
    from aglayout_tpu_torch.eval.inception import InceptionExtractor

    torch.save(seeded_inception(0).state_dict(), tmp_path / "inc.pth")
    imgs = np.random.RandomState(3).randint(0, 256, (4, 128, 128, 3)).astype("uint8")
    for fn in ("__call__", "logits"):
        got = getattr(InceptionExtractor(str(tmp_path / "inc.pth"), device=cuda), fn)(imgs)
        want = getattr(InceptionExtractor(str(tmp_path / "inc.pth"), device="cpu"), fn)(imgs)
        assert _rel(torch.from_numpy(got), torch.from_numpy(want)) < 1e-4, fn


def test_run_inference_on_card_launches_six_each(cuda, tmp_path):
    """run_inference at 128^2 on the card: two eval forwards a batch, so
    each of K1-K5 six times a batch; the summary has JAX's keys."""
    from chip_smoke import PATH128, SUMMARY_KEYS, launch_counts
    from aglayout_tpu_torch.infer.generate import run_inference
    from aglayout_tpu_torch.test import synthetic_loader
    from aglayout_tpu_torch.train.state import Models

    cfg = config_for(128, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23,
                     d_conv_dim=16, batch_size=2, max_objects=4)
    models = Models(build_generator(cfg, cuda, seed=0), *build_discriminators(cfg, cuda, seed=1))
    launch_counts(reset=True)
    summary = run_inference(cfg, models, synthetic_loader(cfg), str(tmp_path), device=cuda,
                            max_batches=2)
    torch.cuda.synchronize()
    assert set(summary) == SUMMARY_KEYS
    assert {k: v for k, v in launch_counts().items() if v} == {k: 12 * n for k, n in PATH128.items()}
    assert len([p for p in tmp_path.iterdir() if "modified" not in p.name]) == 4 * 2 * 2


# ---- the train step as one CUDA graph (train/graph.py)

GRAPH_STEPS = 20


def _graph_setup(size: int):
    """`train_evidence`'s set-up on the card at `size`, B=8, 4 corpus
    batches: (corpus, a fresh state of the config's seed, its eager step)."""
    from aglayout_tpu_torch.tools.train_evidence import parser, setup

    args = parser().parse_args(["--image_size", str(size), "--corpus_batches", "4",
                                "--device", "cuda"])
    _, _, corpus, state, step = setup(args)
    return corpus, state, step


def _undone(fresh, captured) -> list:
    """What differs between a fresh state and one a capture (its warm-up
    undone) started from it: every net, the draws and the step as
    `state_mismatches` sees them, and any Adam state of `captured` that is
    not zero (the warm-up made it; a fresh Adam's first step finds zero
    moments and a count of 0)."""
    from aglayout_tpu_torch.train.compare import state_mismatches

    bad = [m for m in state_mismatches(fresh, captured) if not m.startswith("opt.")]
    return bad + [f"opt.{name}" for name, opt in captured.opt.items()
                  if any(v.any() for s in opt.state.values() for v in s.values())]


def _same_metrics(a, b) -> list:
    """The metrics and grids of two steps that differ in any bit."""
    bad = [k for k in a if k != "images" and not torch.equal(a[k], b[k])]
    return bad + [k for k in a["images"] if not torch.equal(a["images"][k], b["images"][k])]


@pytest.mark.parametrize("size", [64, 128])
def test_graphed_step_equals_eager_bit_for_bit(cuda, size):
    """From two fresh states of one seed, deterministic, f32 with TF32 off
    at 64^2 and on at 128^2 (as the evidence runs): the capture leaves its
    state where it was, and 20 graphed steps equal 20 eager steps of the
    (capturable) step bit for bit: every metric and grid at every step, and
    after them every parameter, buffer (BN statistics, spectral-norm u and
    v), Adam moment and count, the draws' generator and the step."""
    from aglayout_tpu_torch.train.compare import state_mismatches
    from aglayout_tpu_torch.train.graph import GraphedTrainStep
    from aglayout_tpu_torch.utils.device import deterministic, tf32

    with deterministic(), tf32(size == 128):
        corpus, eager_state, eager = _graph_setup(size)
        _, graph_state, step = _graph_setup(size)
        graphed = GraphedTrainStep(step, graph_state, corpus[0])
        assert _undone(eager_state, graph_state) == []
        for i in range(GRAPH_STEPS):
            _, want = eager(eager_state, corpus[i % len(corpus)])
            _, got = graphed(graph_state, corpus[i % len(corpus)])
            assert _same_metrics(want, got) == [], i
        assert eager_state.step == graph_state.step == GRAPH_STEPS
        assert state_mismatches(eager_state, graph_state) == []


_FRESH_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from aglayout_tpu_torch.tools.train_evidence import parser, setup
from aglayout_tpu_torch.train.graph import GraphedTrainStep
from aglayout_tpu_torch.utils.device import deterministic, tf32
size = int(sys.argv[3])
with deterministic(), tf32(size == 128):
    _, _, corpus, state, step = setup(parser().parse_args(["--image_size", str(size),
                                                           "--device", "cuda"]))
    if sys.argv[2] == "graphed":
        step = GraphedTrainStep(step, state, corpus[0])
    rows = []
    for i in range(20):
        _, m = step(state, corpus[i])
        rows.append(torch.stack([m[k].float() for k in sorted(m) if k != "images"]).tolist())
print(json.dumps(rows))
"""


@pytest.mark.parametrize("size", [64, 128])
def test_graphed_step_in_a_fresh_process_equals_eager(cuda, size):
    """`train_evidence`'s set-up (32 corpus batches), deterministic, at 64^2
    with TF32 off and at 128^2 with it on (the modes the evidence runs),
    20 steps eager in one new process and graphed in another: every metric
    at every step equal. Warmed up on a side stream (64^2), or on a clone
    of the batch after a snapshot on the card (128^2), the graph parted
    from the other process's eager run at step 2, though it equalled an
    eager run in its own process."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = {kind: json.loads(subprocess.run(
        [sys.executable, "-c", _FRESH_RUN, repo, kind, str(size)], capture_output=True,
        text=True, check=True, timeout=600).stdout.splitlines()[-1])
        for kind in ("eager", "graphed")}
    assert rows["eager"] == rows["graphed"]


def test_train_evidence_resumes_at_128_tf32_bit_for_bit(cuda, tmp_path):
    """`chip_smoke.py` phase 16 (e)'s resume check at the 128^2 evidence's
    mode (deterministic, TF32 on, graphed; logged every step): 10 + 10
    steps of `train_evidence --segment_steps 10` in two processes against
    20 in one. `metrics.jsonl` byte-equal, the step-20 states' digests
    equal, the segments (0, 10), (10, 20), each run's kernel check within
    1e-4 with K1-K5 three launches each. A resumed segment is a fresh
    process, where a graph can part from an eager run (`graph.py`); the
    states (about 940 MiB each) stay under `tmp_path`."""
    from chip_smoke import evidence_resume, evidence_start, phase_device, reap

    started = evidence_start(tmp_path, 128)
    try:
        evidence_resume(started, tmp_path, phase_device(), 128)
    finally:
        reap(*started[0].values())


def test_graphed_step_resumes_from_a_checkpoint_bit_for_bit(cuda, tmp_path):
    """64^2, deterministic, TF32 off: 10 graphed steps, the state saved
    after the 5th under the graph, against a fresh state restored from that
    save and captured anew for steps 6-10: the same metrics at each and the
    same state after them, bit for bit."""
    from aglayout_tpu_torch.train.compare import state_mismatches
    from aglayout_tpu_torch.train.graph import GraphedTrainStep
    from aglayout_tpu_torch.utils.checkpoint import restore_state, save_state
    from aglayout_tpu_torch.utils.device import deterministic

    with deterministic():
        corpus, state, step = _graph_setup(64)
        graphed = GraphedTrainStep(step, state, corpus[0])
        later = []
        for i in range(10):
            _, m = graphed(state, corpus[i % len(corpus)])
            if i + 1 == 5:
                save_state(str(tmp_path), 5, state)
            if i >= 5:
                later.append({k: v.clone() for k, v in m.items() if k != "images"})
        _, resumed, step2 = _graph_setup(64)
        assert restore_state(str(tmp_path), resumed, "l")[1] == 5
        graphed2 = GraphedTrainStep(step2, resumed, corpus[5 % len(corpus)])
        for i in range(5, 10):
            _, m = graphed2(resumed, corpus[i % len(corpus)])
            assert all(torch.equal(m[k], later[i - 5][k]) for k in later[i - 5]), i
        assert state_mismatches(state, resumed) == []


def test_graphed_step_refuses_what_it_cannot_replay(cuda):
    """Draws, marks, another state, a batch of another layout, a sharded
    step and a plain (non-capturable) Adam each raise; no path runs the
    eager step. The eager step makes the host wait for the card nowhere
    (sync debug mode "error"), which is what lets it be captured."""
    from aglayout_tpu_torch.parallel import Group, make_sharded_train_step
    from aglayout_tpu_torch.train.compare import step_draws
    from aglayout_tpu_torch.train.graph import GraphedTrainStep

    cfg = config_for(64, **TRAIN_SMALL)
    _, state, step = _small_train(cfg, cuda)
    batch = _small_batch(cfg, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graphed = GraphedTrainStep(step, state, batch)
    with pytest.raises(ValueError, match="eager step"):
        graphed(state, batch, draws=step_draws(cfg, 0))
    with pytest.raises(ValueError, match="eager step"):
        graphed(state, batch, mark=lambda name: None)
    with pytest.raises(ValueError, match="another state"):
        graphed(_small_train(cfg, cuda)[1], batch)
    with pytest.raises(ValueError, match="layout"):
        graphed(state, {k: v for k, v in batch.items() if k != "masks"})
    with pytest.raises(RuntimeError, match="sharded"):
        GraphedTrainStep(make_sharded_train_step(step, Group()), state, batch)
    plain = _small_train(cfg, cuda)[1]
    plain.opt["g"] = torch.optim.Adam(plain.models.g.parameters(), lr=cfg.learning_rate)
    with pytest.raises(RuntimeError, match="not capturable"):
        GraphedTrainStep(step, plain, batch)


def test_capturable_adam_is_optax_adam(cuda):
    """The card's Adam (`train/state.adam`: capturable), eager and replayed
    from one CUDA graph, after 100 steps of `first_window_rule.adam_case()`
    (gradients over seven decades): within 1e-2 lr of `adam_reference`
    (optax's f32 Adam, itself held to `optax.adam` on the host by
    `tests/test_torch_port_graph.py`), and no farther than twice the plain
    Adam on the same inputs; the graph equal to the eager steps."""
    from aglayout_tpu_torch.tools.first_window_rule import (
        ADAM_BOUND,
        ADAM_RATIO,
        adam_case,
        adam_distances,
        torch_adam,
    )

    d = adam_distances(cuda)
    assert set(d) == {"plain", "capturable", "capturable_graphed"}
    for kind in ("capturable", "capturable_graphed"):
        assert d[kind] <= ADAM_BOUND and d[kind] <= ADAM_RATIO * d["plain"], d
    p0, grads = adam_case()
    assert np.array_equal(torch_adam(p0, grads, cuda, True, True),
                          torch_adam(p0, grads, cuda, True, False))


def test_avg_pool2_is_avg_pool2d_at_the_ds_shapes(cuda):
    """`test_torch_port_discriminator.py::test_avg_pool2_is_avg_pool2d` on
    the card, at every shape one 64^2 train step pools (B=8, O=10: among
    them the image D's first block on the D phase's 32 images and the
    object D's second on its 320 crops): the forward within 2e-7 of
    `F.avg_pool2d` on standard-normal f32 inputs (the rule's check; equal,
    since the pool is avg_pool2d's forward), the gradients equal."""
    from aglayout_tpu_torch.tools.first_window_rule import POOL_ATOL, pool_errors, pool_shapes

    shapes = pool_shapes(cuda)
    assert {(32, 3, 64, 64), (32, 64, 64, 64), (320, 128, 32, 32)} <= set(shapes), shapes
    for shape in shapes:
        e = pool_errors(shape, cuda)
        assert e["forward_max_abs"] <= POOL_ATOL and e["backward_equal"], e
        assert e["forward_unequal"] == 0, e


def _small_train(cfg, device):
    """(matrix, a fresh state, its eager step) at `cfg` on `device`."""
    from aglayout_tpu_torch.bench import train_inputs
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    _, matrix, pos_weight = train_inputs(cfg, cfg.batch_size, 0)
    state = create_train_state(cfg, device, seed=0)
    return matrix, state, make_train_step(cfg, state.models, matrix, pos_weight)


def _small_batch(cfg, device):
    from aglayout_tpu_torch.bench import train_inputs
    from aglayout_tpu_torch.data.synthetic import batch_to_torch

    return batch_to_torch(train_inputs(cfg, cfg.batch_size, 0)[0], device)


def test_graphed_step_raises_when_the_capture_fails(cuda):
    """A step that makes the host wait (an `.item()`) cannot be captured:
    the graph raises, and leaves the state where it was before its warm-up.
    Last in the file: should a failed capture disturb the CUDA context, no
    other test of the file runs after it."""
    from aglayout_tpu_torch.train.graph import GraphedTrainStep

    cfg = config_for(64, **TRAIN_SMALL)
    _, state, step = _small_train(cfg, cuda)
    batch = _small_batch(cfg, cuda)

    def waits(state, batch):
        next(state.models.g.parameters()).sum().item()
        return step(state, batch)

    with pytest.raises(RuntimeError, match="capture failed"):
        GraphedTrainStep(waits, state, batch)
    assert _undone(_small_train(cfg, cuda)[1], state) == []
