"""The host side of K7 (`spade_c6_int8`) as rebuilt on int8 wgmma, and of
K5 (`typed_c3_expand`) as widened to every shape the kernels it replaced
took, with K5-v5 now launching K5's kernel.

The CUDA kernels run only on a card (`test_torch_port_gpu.py`,
`chip_smoke.py`). Here, on the CPU: K7's quantise pass and its product's
schedule (tiles, k32 steps, the descriptors' addresses) as plain PyTorch,
held bit for bit against the plain version and against the JAX kernel in
interpret mode on the same numpy inputs; K7's shape predicate; K5's
shared-memory layout, its predicate and the typed route at conv_dim 64, 96
and 128 and at s3 from 24 to 64 (models on the meta device); and the plain
typed expansion against JAX's v4 and v5 kernels at shapes only the widened
kernel takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.ops import pallas_typed_expand as jax_typed
from aglayout_tpu.ops.pallas_spade_c6_int8 import quantize_conv_weights as jax_quantize
from aglayout_tpu.ops.pallas_spade_c6_int8 import spade_c6_int8 as jax_spade_c6_int8
from aglayout_tpu_torch.kernels import build
from aglayout_tpu_torch.models.generator import LayoutEncoder
from aglayout_tpu_torch.ops import typed_expand
from aglayout_tpu_torch.ops.int8 import quantize_conv_weights, symmetric_scales
from aglayout_tpu_torch.ops.spade_c6_int8 import (
    padded_hw,
    spade_c6_int8,
    spade_c6_int8_plain,
    spade_c6_int8_quantized,
    spade_c6_int8_supports,
    spade_c6_int8_tapped_plain,
)
from aglayout_tpu_torch.ops.spade_conv import compact_to_flat, spade_apply8_plain
from torch_port_common import nchw, nhwc

torch.set_num_threads(1)
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _c6_case(b, c, h, w, f, seed):
    """x (B, H, W, C), compact tables and an HWIO weight as numpy, and the
    port's int8 weights of it."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    a_tab = rng.uniform(0.5, 1.5, (b, h // f, 5, c, 5 * w // f)).astype(np.float32)
    b_tab = (rng.randn(b, h // f, 5, c, 5 * w // f) * 0.2).astype(np.float32)
    wk = (rng.randn(5, 5, c, c) * 0.05).astype(np.float32)
    wq, sw = quantize_conv_weights(torch.from_numpy(wk).permute(3, 2, 0, 1))
    return x, torch.from_numpy(a_tab), torch.from_numpy(b_tab), wk, wq, sw


# ---- K7: the quantise pass, the product's schedule


# the JAX kernel test's size; C = 64 (one output-channel tile, two chunks);
# and tiles cut by the image's edge (H not a multiple of 32, W of 16)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,f", [(2, 128, 32, 32, 8), (2, 64, 32, 32, 8), (1, 32, 40, 24, 8)])
def test_k7_tapped_plain_matches_plain_and_jax(b, c, h, w, f, dt):
    """spade_c6_int8_tapped_plain (q as the quantise pass writes it; per
    tile of 32 x 16 pixels and k32 step (chunk, tap), each strip's B operand
    read at its descriptor's addresses from a copy of the chunk's halo laid
    out as the map producer lays it) == spade_c6_int8_plain bit for bit: both
    sums are exact integers. Against JAX's kernel in interpret mode: where
    the two frameworks' f32 apply differ in a last bit, a value can round to
    the next quantisation step (1/127 of the image's max), which moves the
    25 C outputs it feeds by one weight (9.4e-4 of the output's max at C = 64
    here, one value of 131,072); else the same integers, the dequantising
    product to the last bit in f32 and one rounding to bf16."""
    x, a_tab, b_tab, wk, wq, sw = _c6_case(b, c, h, w, f, seed=b * c + h)
    xt, at, bt = nchw(x).to(TDT[dt]), a_tab.to(TDT[dt]), b_tab.to(TDT[dt])
    got = spade_c6_int8_tapped_plain(xt, at, bt, wq, sw, f)
    assert got.dtype == TDT[dt] and got.shape == (b, c, h, w)
    assert torch.equal(got, spade_c6_int8_plain(xt, at, bt, wq, sw, f))
    assert torch.equal(spade_c6_int8(xt, at, bt, wq, sw, f), got)  # a CPU tensor: the plain version
    if h % 32 or w % 32:
        return  # the JAX kernel's row chunks want whole 16-row chunks of 32-wide maps
    jq, js = jax_quantize(jnp.asarray(wk))
    ja, jb = (jnp.asarray(compact_to_flat(t, f).permute(0, 1, 2, 4, 3).numpy(), JDT[dt])
              for t in (a_tab, b_tab))
    want = np.asarray(jax_spade_c6_int8(jnp.asarray(x, JDT[dt]), ja, jb, jq, js, f=f, ch=16,
                                        interpret=True), np.float32)
    err = np.abs(nhwc(got.float()) - want).max() / np.abs(want).max()
    assert err <= {"f32": 2e-3, "bf16": 2 ** -7}[dt], err


@pytest.mark.parametrize("h,w", [(32, 32), (40, 24), (128, 128)])
def test_k7_quantised_layout(h, w):
    """The quantise pass's q: (B, C / 16, HP, WP, 16) int8, HP and WP the
    tiles' cover plus the zero ring; pixel (y, x) of channel 16 p + e at
    [p, y + 2, x + 2, e], every other byte zero; the scale is the plain
    version's."""
    b, c, f = 2, 32, 8
    x, a_tab, b_tab, *_ = _c6_case(b, c, h, w, f, seed=h + w)
    xt = nchw(x)
    q, scale = spade_c6_int8_quantized(xt, a_tab, b_tab, f)
    hp, wp = padded_hw(h, w)
    assert (hp, wp) == (-(-h // 32) * 32 + 4, -(-w // 16) * 16 + 4)
    assert q.shape == (b, c // 16, hp, wp, 16) and q.dtype == torch.int8
    y = spade_apply8_plain(xt, a_tab, b_tab, f).float()
    inv, want_scale = symmetric_scales(y.amax(dim=(1, 2, 3), keepdim=True))
    qv = torch.round(y * inv)
    assert torch.equal(scale, want_scale)
    inner = q[:, :, 2:h + 2, 2:w + 2].permute(0, 1, 4, 2, 3).reshape(b, c, h, w)
    assert torch.equal(inner.float(), qv) and int(qv.min()) >= 0 and int(qv.max()) == 127
    ring = q.clone()
    ring[:, :, 2:h + 2, 2:w + 2] = 0
    assert not ring.any()


@pytest.mark.parametrize("shape,f,want", [
    ((128, 128, 128, 128), 16, True),  # SPADE-4 + c6 at 128^2
    ((2, 256, 64, 64), 16, True),
    ((2, 32, 40, 24), 8, True),  # tiles cut by the image's edge
    ((2, 96, 48, 40), 8, True),  # C % 64 != 0: the last output-channel tile half empty
    ((2, 48, 32, 32), 8, False),  # C % 32: the k32 steps' chunks
    ((2, 64, 32, 20), 5, False),  # W % 8: the quantise pass's 8-pixel vectors
    ((2, 64, 32, 32), 4, False),  # f < 5: no row classes
    ((2, 64, 30, 32), 8, False),  # f does not divide H
    ((2, 64, 32, 32 * 64), 8, False),  # a block's tables past its shared memory
    ((2, 64, 32, 56 * 8), 8, True),  # the quantise pass's tables and out-words: 211,968 bytes
    ((2, 64, 32, 64 * 8), 8, False),  # ... 237,568, past the limit though the max pass's fit
])
def test_k7_supports(shape, f, want):
    assert spade_c6_int8_supports(shape, f) == want


def test_k7_wrapper_rejects_other_devices():
    h = torch.zeros(1, 32, 32, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        spade_c6_int8(h, h, h, h, h, 8)


# ---- K5: the layout, the predicate and the route at the widened shapes


@pytest.mark.parametrize("c2,c4,s3,ech,plane", [
    (128, 256, 32, 32, 16384),  # the published width: K5's own buffers, as before
    (32, 64, 32, 32, 16384),
    (176, 64, 16, 32, 16384),
    (128, 256, 24, 32, 16384),  # s3 % 8 that is not a power of two
    (128, 256, 48, 32, 16384),
    (128, 256, 56, 16, 16384),  # the row types of 16 channels at a time
    (128, 256, 64, 16, 16384),
    (192, 384, 32, 16, 16384),  # conv_dim 96
    (256, 512, 32, 16, 8192),  # conv_dim 128: 8 KB staging buffers as well
    (256, 512, 64, 8, 8192),
    (272, 544, 16, 32, 8192),  # 32 channels with 8 KB buffers: the general instantiation
    (256, 1024, 16, 32, 8192),
])
def test_k5_layout_keeps_k5s_buffers_where_they_fit(c2, c4, s3, ech, plane):
    """typed_tc_layout: K5's 32-channel row-type group and 16 KB staging
    buffers wherever they fit in a block's shared memory (the size then is
    the earlier kernel's: 216,784 bytes at the published width), else the
    largest that fit; the grid tile, W3z and V3 never shrink."""
    got = typed_expand.typed_tc_layout(c2, c4, s3)
    assert got[:2] == (ech, plane) and got[2] <= build.SMEM_LIMIT
    assert typed_expand.typed_tc_smem(c2, c4, s3) == got[2]
    if (c2, c4, s3) == (128, 256, 32):
        assert got[2] == 216784
    fixed = 1024 + 3 * 16384 + (145 * (c2 + 8) * 2 + 15) // 16 * 16 + 168 * 136 * 2 + 32 * 15 * 16 * 2
    assert got[2] == fixed + ech * 15 * s3 * 2 + 2 * plane + 2 * c4 * 4 + (112 + s3) * 4


def test_k5_layout_past_shared_memory():
    """Where nothing fits, one byte past the limit, and the predicate says no."""
    assert typed_expand.typed_tc_smem(320, 640, 32) == build.SMEM_LIMIT + 1
    z2 = torch.zeros(2, 12, 12, 320, dtype=torch.bfloat16)
    assert not typed_expand.typed_c3_expand_supports(z2, torch.zeros(640, 320, 4, 4), 32)
    assert typed_expand.typed_c3_expand_supports(z2.float(), torch.zeros(640, 320, 4, 4), 32)


# s3: the 128^2 model's 32, a 256^2 image's 64, and the other multiples of 8
@pytest.mark.parametrize("s3", [24, 32, 40, 48, 56, 64])
@pytest.mark.parametrize("conv_dim", [64, 96, 128])
def test_k5_supports_the_replaced_kernels_shapes(conv_dim, s3):
    """In bf16 the kernel of `typed_c3_expand` (and so v5 and v6) takes c2 =
    2 conv_dim, c4 = 4 conv_dim and any s3 % 8 up to 64; c4 % 16 == 0 (a
    last chunk of 16 channels); not s3 % 8 != 0 nor c2 % 16 != 0."""
    c2, c4 = 2 * conv_dim, 4 * conv_dim
    z2 = torch.zeros(3, 12, 12, c2, dtype=torch.bfloat16)
    w = torch.zeros(c4, c2, 4, 4)
    for variant in ("v4", "v5", "v6"):
        assert typed_expand.SUPPORTS[variant](z2, w, s3)
    assert typed_expand.typed_c3_expand_supports(z2, torch.zeros(c4 - 16, c2, 4, 4), s3)
    assert not typed_expand.typed_c3_expand_supports(z2, torch.zeros(c4 - 8, c2, 4, 4), s3)
    assert not typed_expand.typed_c3_expand_supports(z2, w, s3 + 4)
    z2x = torch.zeros(3, 12, 12, c2 + 8, dtype=torch.bfloat16)
    assert not typed_expand.typed_c3_expand_supports(z2x, torch.zeros(c4, c2 + 8, 4, 4), s3)


@pytest.mark.parametrize("variant", ["v4", "v5", "v6"])
@pytest.mark.parametrize("conv_dim", [64, 96, 128])
def test_k5_typed_route_at_wide_widths(conv_dim, variant):
    """At 128^2 (s3 = 32) and at 256^2's s3 = 64 the layout encoder's typed
    route is the variant `typed_c3` names, never the plain expansion, at
    conv_dim 64, 96 and 128 in bf16 (the layout encoder on the meta device)."""
    with torch.device("meta"):
        enc = LayoutEncoder(23, image_size=128, conv_dim=conv_dim, resi_num=2,
                            clstm_dims=(conv_dim,), dtype=torch.bfloat16, typed_c3=variant)
    enc.eval()  # the typed route is the eval path's
    assert enc.c3.weight.shape == (4 * conv_dim, 2 * conv_dim, 4, 4)
    z2 = torch.zeros(4, 12, 12, 2 * conv_dim, dtype=torch.bfloat16)
    assert enc.typed_route(z2, 32) == variant
    assert enc.typed_route(z2, 64) == variant
    enc.use_typed_kernel = False
    assert enc.typed_route(z2, 32) == "plain"


def test_k5_v5_is_k5s_kernel():
    """v5 takes what K5 takes and has no device scratch or kernel of its
    own: the library exports no v5 function."""
    assert typed_expand.SUPPORTS["v5"] is typed_expand.typed_c3_expand_supports
    assert "typed_c3_expand_v5" not in build.SIGNATURES
    assert not hasattr(typed_expand, "w3z_scratch")
    assert not (build.CSRC / "typed_c3_expand_v5.cu").exists()


# shapes only the widened kernel takes: s3 of 24 and 56, c4 % 32 == 16
@pytest.mark.parametrize("variant", ["v4", "v5"])
@pytest.mark.parametrize("n,s3,c2,c4", [(4, 24, 48, 48), (3, 56, 32, 16)])
def test_k5_plain_matches_jax_at_the_new_shapes(variant, n, s3, c2, c4):
    """The plain version the card holds the widened kernel against ==
    JAX's v4 and v5 kernels (interpret=True), f32, on the same numpy inputs."""
    rng = np.random.RandomState(n + s3)
    z2 = rng.randn(n, 12, 12, c2).astype(np.float32)
    ints = [rng.randint(0, hi, shape).astype(np.int32)
            for hi, shape in ((13, (n, 14, 4)), (14, (n, 14, 4)), (14, (n, s3)), (14, (n, s3)))]
    ab = (rng.randn(n, 2, c4) * 0.5).astype(np.float32)
    w3 = (rng.randn(4, 4, c2, c4) * 0.05).astype(np.float32)  # JAX HWIO
    jax_fn = {"v4": jax_typed.typed_c3_expand_v4, "v5": jax_typed.typed_c3_expand_v5}[variant]
    want = jax_fn(jnp.asarray(z2), *map(jnp.asarray, ints), jnp.asarray(ab),
                  jnp.asarray(w3.transpose(0, 2, 1, 3).reshape(4 * c2, 4 * c4)), interpret=True,
                  group=1)
    got = typed_expand.VARIANTS[variant](torch.from_numpy(z2), *map(torch.from_numpy, ints),
                                         torch.from_numpy(ab), torch.from_numpy(w3).permute(3, 2, 0, 1))
    assert got.shape == (n, c4, s3, s3)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4, rtol=1e-4)
