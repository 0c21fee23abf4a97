"""The host side of K1 (`residual_trunk`) and K2 (`spade_few_out_conv`) as
redesigned for the H100's tensor cores, and the kernel routes that fall
through by shape.

The CUDA kernels run only on a card (`test_torch_port_gpu.py`,
`chip_smoke.py`). Here, on the CPU: the trunk's weight packing, plain
PyTorch versions of the two new schedules held against the plain versions
and against the JAX kernels in interpret mode on the same numpy inputs, and
each wrapper's route predicate and each model site's route function at the
published widths and at a width the tensor cores do not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.ops.pallas_resblocks import residual_trunk as jax_residual_trunk
from aglayout_tpu.ops.pallas_spade_conv import spade_few_out_conv as jax_spade_few_out_conv
from aglayout_tpu_torch.models.generator import Decoder, LayoutEncoder
from aglayout_tpu_torch.ops import typed_expand
from aglayout_tpu_torch.ops.resblocks import (
    pack_trunk_weights,
    residual_trunk_plain,
    residual_trunk_route,
    residual_trunk_supports,
    residual_trunk_tapped_plain,
    trunk_weight_matrices,
    unpack_trunk_weights,
)
from aglayout_tpu_torch.ops.spade_conv import (
    spade_apply8_supports,
    spade_few_out_conv8_shifted_plain,
    spade_few_out_conv8_supports,
    spade_few_out_conv_plain,
    spade_few_out_conv_route,
)
from torch_port_common import nchw, nhwc

torch.set_num_threads(1)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# max|err| / max|want|: f32 differs by the order of the sums; bf16 rounds the
# same intermediates on both sides, and an order difference can flip one
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


# ---- K1: the weight packing and the tapped schedule


@pytest.mark.parametrize("c,r", [(16, 1), (32, 2), (64, 2)])
def test_trunk_weight_packing(c, r):
    """The packed trunk weights: shape, the way back bit for bit, the
    per-tap GEMM matrices, and the B fragment one mma lane reads."""
    rng = np.random.RandomState(c + r)
    w1, w2 = (torch.from_numpy(rng.randn(r, c, c, 3, 3).astype(np.float32)) for _ in range(2))
    packed = pack_trunk_weights(w1, w2, torch.float32)
    assert packed.shape == (r, 2, 3, 3, c // 16, c // 8, 8, 4, 2, 2) and packed.is_contiguous()
    back1, back2 = unpack_trunk_weights(packed)
    assert torch.equal(back1, w1) and torch.equal(back2, w2)
    m = trunk_weight_matrices(packed)
    assert m.shape == (r, 2, 9, c, c)
    for _ in range(100):
        i, conv, dy, dx, cin, cout = (rng.randint(n) for n in (r, 2, 3, 3, c, c))
        w = (w1, w2)[conv][i, cout, cin, dy, dx]
        assert m[i, conv, 3 * dy + dx, cin, cout] == w
        # lane 4 g + t of n-tile J, register reg, element e of k-step kc
        kc, reg, t, e = cin // 16, (cin % 16) // 8, (cin % 8) // 2, cin % 2
        assert packed[i, conv, dy, dx, kc, cout // 8, cout % 8, t, reg, e] == w
    rounded = pack_trunk_weights(w1, w2, torch.bfloat16)
    assert rounded.dtype == torch.bfloat16
    assert all(torch.equal(a, b.bfloat16()) for a, b in zip(unpack_trunk_weights(rounded), (w1, w2)))
    with pytest.raises(ValueError, match="C % 16"):
        pack_trunk_weights(w1[:, :8, :8], w2[:, :8, :8], torch.bfloat16)


def _trunk_case(b, c, r, seed):
    """h (B, 8, 8, C), HWIO weights and BN affines as numpy, as the JAX
    kernel's tests make them."""
    rng = np.random.RandomState(seed)
    h = rng.randn(b, 8, 8, c).astype(np.float32)
    w1, w2 = ((rng.randn(r, 3, 3, c, c) / (3 * c ** 0.5)).astype(np.float32) for _ in range(2))
    ab1, ab2 = ((np.stack([1 + 0.1 * rng.randn(r, c), 0.1 * rng.randn(r, c)], 1)).astype(np.float32)
                for _ in range(2))
    return h, w1, w2, ab1, ab2


@pytest.mark.parametrize("b,c,r,dt", [(2, 16, 2, "f32"), (3, 32, 1, "f32"), (2, 16, 2, "bf16"),
                                      (4, 32, 2, "bf16")])
def test_tapped_trunk_matches_plain_and_jax(b, c, r, dt):
    """residual_trunk_tapped_plain (the tensor-core kernel's order: 9 tap
    products on a padded pixel-major tile, packed weights) ==
    residual_trunk_plain == JAX's residual_trunk in interpret mode."""
    jdt, tdt = DT[dt]
    h, w1, w2, ab1, ab2 = _trunk_case(b, c, r, seed=b * c + r)
    want = np.asarray(jax_residual_trunk(jnp.asarray(h, jdt), jnp.asarray(w1), jnp.asarray(w2),
                                         jnp.asarray(ab1), jnp.asarray(ab2), interpret=True))
    oihw = lambda w: torch.from_numpy(w).permute(0, 4, 3, 1, 2)  # noqa: E731
    args = (nchw(h).to(tdt), oihw(w1), oihw(w2), torch.from_numpy(ab1), torch.from_numpy(ab2))
    tapped, plain = residual_trunk_tapped_plain(*args), residual_trunk_plain(*args)
    assert tapped.shape == (b, c, 8, 8) and tapped.dtype == torch.float32
    assert _rel(tapped, plain) <= TOL[dt]
    assert _rel(nhwc(tapped), want) <= TOL[dt] and _rel(nhwc(plain), want) <= TOL[dt]


# ---- K2: the tensor-core schedule on flat tables


def _flat_case(b, c, h, w, f, k, o, seed):
    """x (B, H, W, C), flat tables (B, H/f, 5, W, C) in JAX's layout, an
    HWIO (K, K, C, O) kernel and a bias, as numpy. The tables are random:
    a flat table holds a value per column, so any W is one."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    a_tab = (1 + 0.3 * rng.randn(b, h // f, 5, w, c)).astype(np.float32)
    b_tab = (0.3 * rng.randn(b, h // f, 5, w, c)).astype(np.float32)
    kern = (0.1 * rng.randn(k, k, c, o)).astype(np.float32)
    return x, a_tab, b_tab, kern, rng.randn(o).astype(np.float32)


# f = 5 (the least) and 8 (the c4 head's); W a power of two, as the JAX kernel
# wants; every K; O = 1 and 3
@pytest.mark.parametrize("f,h,w,k,o", [(5, 10, 16, 5, 3), (8, 16, 32, 7, 3), (8, 16, 16, 3, 1),
                                       (5, 20, 32, 7, 3)])
def test_shifted_plain_on_flat_tables_matches_plain_and_jax(f, h, w, k, o):
    """spade_few_out_conv8_shifted_plain(compact=False), the schedule K2
    runs on the tensor cores, == spade_few_out_conv_plain == JAX's
    spade_few_out_conv in interpret mode, flat tables, f32."""
    x, a_tab, b_tab, kern, bias = _flat_case(2, 16, h, w, f, k, o, seed=f * 100 + k * 10 + o)
    want = np.asarray(jax_spade_few_out_conv(jnp.asarray(x), jnp.asarray(a_tab), jnp.asarray(b_tab),
                                             jnp.asarray(kern), jnp.asarray(bias), f=f,
                                             interpret=True))
    tab = lambda t: torch.from_numpy(t).permute(0, 1, 2, 4, 3).contiguous()  # noqa: E731
    args = (nchw(x), tab(a_tab), tab(b_tab), torch.from_numpy(kern).permute(3, 2, 0, 1),
            torch.from_numpy(bias), f)
    got = spade_few_out_conv8_shifted_plain(*args, compact=False)
    plain = spade_few_out_conv_plain(*args)
    assert got.shape == (2, o, h, w)
    assert _rel(got, plain) <= 1e-5 and _rel(nhwc(got), want) <= 1e-4


def test_shifted_plain_on_flat_tables_in_bf16():
    """In bf16 the schedule rounds y and the weights where the plain version
    does; only the order of the f32 sums differs."""
    x, a_tab, b_tab, kern, bias = _flat_case(2, 32, 16, 64, 8, 7, 3, seed=3)
    tab = lambda t: torch.from_numpy(t).permute(0, 1, 2, 4, 3).contiguous().bfloat16()  # noqa: E731
    args = (nchw(x).bfloat16(), tab(a_tab), tab(b_tab), torch.from_numpy(kern).permute(3, 2, 0, 1),
            torch.from_numpy(bias), 8)
    got = spade_few_out_conv8_shifted_plain(*args, compact=False)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), spade_few_out_conv_plain(*args).float()) <= 2 ** -7


# ---- the predicates and the routes


def _models(size, conv_dim, dtype=torch.bfloat16, **kw):
    """The layout encoder and decoder at `size` and `conv_dim`, weights on
    the meta device: the routes read their shapes only. In eval mode, the
    only mode whose routes take a kernel."""
    with torch.device("meta"):
        enc = LayoutEncoder(23, image_size=size, conv_dim=conv_dim, resi_num=2,
                            clstm_dims=(conv_dim,), dtype=dtype,
                            **{k: v for k, v in kw.items() if k in ("use_trunk_kernel",
                                                                    "use_typed_kernel", "typed_c3")})
        dec = Decoder(image_size=size, conv_dim=conv_dim, dtype=dtype,
                      **{k: v for k, v in kw.items() if k.startswith("use_") and k not in (
                          "use_trunk_kernel", "use_typed_kernel")})
    return enc.eval(), dec.eval()


def _sites(size, d, dtype=torch.bfloat16):
    """The tensors each site hands its route at `size` and width d (B = 2,
    O = 2): the trunk's h, the c4 head's h, the segmap, and at 128^2 the c7
    head's and SPADE-4's h and the typed grid."""
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    sites = {"trunk": z(2, d, 8, 8), "c4": z(2, d, 64, 64), "seg": z(2, d, 8, 8)}
    if size == 128:
        sites.update(c7=z(2, 2 * d, 128, 128), z2=z(4, 12, 12, 2 * d))
    return sites


def _routes(size, d, dtype=torch.bfloat16, **kw):
    enc, dec = _models(size, d, dtype, **kw)
    s = _sites(size, d, dtype)
    routes = {"trunk": enc.trunk_route(s["trunk"]), "c4": dec.head_route(s["c4"], s["seg"])}
    if size == 128:
        routes.update(c7=dec.head8_route(s["c7"], s["seg"]), apply=dec.apply_route(s["c7"], s["seg"]),
                      typed=enc.typed_route(s["z2"], 32))
    return routes


# the default configuration at the published width takes every kernel; at
# conv_dim = 12 the tensor-core kernels (C % 16) and the typed ones (c2 % 16)
# do not take the shapes, and each site falls through
@pytest.mark.parametrize("size,d,dtype,want", [
    (64, 64, torch.bfloat16, {"trunk": "k1", "c4": "k2"}),
    (128, 64, torch.bfloat16, {"trunk": "k1", "c4": "k2", "c7": "k3", "apply": "k4", "typed": "v4"}),
    (128, 64, torch.float32, {"trunk": "k1", "c4": "k2", "c7": "k3", "apply": "k4", "typed": "v4"}),
    (64, 12, torch.bfloat16, {"trunk": "k1", "c4": "k2"}),
    (128, 12, torch.bfloat16, {"trunk": "k1", "c4": "k2", "c7": "k2", "apply": "k4",
                               "typed": "plain"}),
])
def test_routes_at_published_widths_and_at_conv_dim_12(size, d, dtype, want):
    assert _routes(size, d, dtype) == want


@pytest.mark.parametrize("kw,want", [
    ({"use_head8_kernel": False}, "k2"),
    ({"use_head8_kernel": False, "use_compact_heads": False}, "k2"),
    ({"use_head8_kernel": False, "use_head_kernel": False}, "dense"),
    ({"use_head_kernel": False}, "k3"),
])
def test_head8_route_falls_through(kw, want):
    """The c7 head: K3, else K2 (on the tables `use_compact_heads` names),
    else the dense composition; a switch off skips its step."""
    assert _routes(128, 64, **kw)["c7"] == want


@pytest.mark.parametrize("variant", ["v4", "v5", "v6"])
def test_typed_route_falls_through(variant):
    """The typed c2/c3: the variant `typed_c3` names where it takes the grid,
    else `typed_c3_expand_plain`."""
    assert _routes(128, 64, typed_c3=variant)["typed"] == variant
    assert _routes(128, 12, typed_c3=variant)["typed"] == "plain"
    assert _routes(128, 64, typed_c3=variant, use_typed_kernel=False)["typed"] == "plain"


def test_trunk_and_head_routes_fall_through():
    """The trunk: K1 where a kernel of it takes C, else the block loop; the
    c4 head: K2, else dense; SPADE-4: K4, else dense."""
    assert _routes(64, 6)["trunk"] == "loop"  # C % 4: neither K1 kernel
    assert _routes(64, 64, use_trunk_kernel=False)["trunk"] == "loop"
    off = _routes(128, 64, use_head_kernel=False, use_apply_kernel=False)
    assert off["c4"] == "dense" and off["apply"] == "dense"
    enc, dec = _models(64, 64)
    h = torch.zeros(2, 64, 32, 32, dtype=torch.bfloat16)  # 4 x the segmap: no row classes
    assert dec.head_route(h, torch.zeros(2, 64, 8, 8)) == "dense"


@pytest.mark.parametrize("c,dtype,want", [
    (64, torch.bfloat16, "tc"), (16, torch.bfloat16, "tc"), (128, torch.bfloat16, "tc"),
    (48, torch.bfloat16, "tc"), (12, torch.bfloat16, "fma"), (100, torch.bfloat16, "fma"),
    (120, torch.bfloat16, None), (64, torch.float32, "fma"), (80, torch.float32, None),
    (12, torch.float32, "fma"), (6, torch.float32, None), (64, torch.float16, None),
])
def test_trunk_kernel_route(c, dtype, want):
    """The trunk kernel by shape and dtype: the tensor cores in bf16 for C %
    16 == 0 up to 128, the FMA kernel for f32 and the other C (C % 4 == 0, as
    far as a conv's weights fit shared memory: C = 120 in bf16 and 80 in f32
    do not), else none."""
    h = torch.zeros(3, c, 8, 8, dtype=dtype)
    w1 = torch.zeros(2, c, c, 3, 3)
    assert residual_trunk_route(h, w1) == want
    assert residual_trunk_supports(h, w1) == (want is not None)
    assert residual_trunk_route(torch.zeros(3, c, 4, 4, dtype=dtype), w1) is None


def _aligned(n, dtype=torch.bfloat16, offset=0):
    """A flat tensor of n elements whose data starts `offset` elements past
    a 16-byte boundary."""
    base = torch.zeros(n + 16, dtype=dtype)
    skip = (-base.data_ptr() % 16) // base.element_size() + offset
    return base[skip:skip + n]


@pytest.mark.parametrize("c,h,w,f,k,o,dtype,compact,want", [
    (64, 64, 64, 8, 7, 3, torch.bfloat16, False, "tc"),  # the c4 head at 64^2 and 128^2
    (128, 128, 128, 16, 7, 3, torch.bfloat16, True, "tc"),  # the c7 head, compact
    (128, 128, 128, 16, 7, 3, torch.bfloat16, False, "tc"),  # the c7 head, flat
    (12, 64, 64, 8, 7, 3, torch.bfloat16, False, "fma"),  # conv_dim = 12: C % 16
    (24, 128, 128, 16, 7, 3, torch.bfloat16, True, "fma"),
    (64, 32, 32, 8, 7, 3, torch.bfloat16, False, "fma"),  # W not 64 or 128
    (64, 64, 64, 8, 7, 3, torch.float32, False, "fma"),  # f32: the reference path
    (64, 60, 60, 5, 7, 3, torch.bfloat16, False, "fma"),  # H % 8
    (64, 64, 64, 8, 9, 3, torch.bfloat16, False, None),  # K = 9
    (64, 64, 64, 8, 7, 5, torch.bfloat16, False, None),  # O = 5
    (64, 64, 64, 4, 7, 3, torch.bfloat16, False, None),  # f < 5: no row classes
])
def test_head_kernel_route(c, h, w, f, k, o, dtype, compact, want):
    x = _aligned(2 * c * h * w, dtype).view(2, c, h, w)
    weight = torch.zeros(o, c, k, k)
    assert spade_few_out_conv_route(x, weight, f, compact) == want


def test_head_kernel_route_by_alignment_and_mode():
    """A misaligned x or table sends the bf16 head to the FMA kernel (its
    copies want 16 bytes); the transposed mode takes the tensor cores in
    bf16 where C % 16 == 0, the FMA kernel in f32 and at C = 24; K3 takes
    only the tensor-core shapes in bf16."""
    weight = torch.zeros(3, 64, 7, 7)
    x = _aligned(2 * 64 * 64 * 64).view(2, 64, 64, 64)
    shifted = _aligned(2 * 64 * 64 * 64, offset=1).view(2, 64, 64, 64)
    tab = _aligned(2 * 8 * 5 * 64 * 64).view(2, 8, 5, 64, 64)
    assert spade_few_out_conv_route(shifted, weight, 8) == "fma"
    assert spade_few_out_conv_route(x, weight, 8, tables=(tab, tab[:-1].view(-1)[1:])) == "fma"
    assert spade_few_out_conv_route(x, weight, 8, tables=(tab, tab)) == "tc"
    xt = _aligned(2 * 64 * 64 * 64).view(64, 64, 2, 64)
    assert spade_few_out_conv_route(xt, weight, 8, transposed=True) == "tc"
    assert spade_few_out_conv_route(xt.float(), weight, 8, transposed=True) == "fma"
    xt24 = _aligned(2 * 24 * 64 * 64).view(64, 64, 2, 24)
    assert spade_few_out_conv_route(xt24, torch.zeros(3, 24, 7, 7), 8, transposed=True) == "fma"
    assert spade_few_out_conv_route(x, weight, 8, compact=True, transposed=True) is None
    assert spade_few_out_conv8_supports(x, weight, 8) and not spade_few_out_conv8_supports(
        shifted, weight, 8)
    x24 = _aligned(2 * 24 * 64 * 64).view(2, 24, 64, 64)
    assert not spade_few_out_conv8_supports(x24, torch.zeros(3, 24, 7, 7), 8)
    assert spade_few_out_conv8_supports(x24.float(), torch.zeros(3, 24, 7, 7), 8)  # f32: FMAs
    assert spade_apply8_supports(x, 8) and not spade_apply8_supports(shifted, 8)


@pytest.mark.parametrize("c2,c4,s3,dtype,want", [
    (128, 256, 32, torch.bfloat16, {"v4", "v5", "v6"}),  # the published width
    (24, 48, 32, torch.bfloat16, set()),  # conv_dim = 12: c2 % 16
    (32, 64, 32, torch.bfloat16, {"v4", "v5", "v6"}),
    (16, 64, 32, torch.bfloat16, {"v4", "v5", "v6"}),  # v5 runs K5's kernel: c2 % 16
    (128, 256, 24, torch.bfloat16, {"v4", "v5", "v6"}),  # the epilogue takes any s3 % 8
    (256, 64, 32, torch.bfloat16, {"v4", "v5", "v6"}),  # row types and staging sized to fit
    (320, 640, 32, torch.bfloat16, set()),  # past a block's shared memory in any layout
    (24, 48, 32, torch.float32, set()),
    (16, 8, 32, torch.float32, {"v4", "v5", "v6"}),  # f32 chunks of 8 channels
])
def test_typed_kernel_predicates(c2, c4, s3, dtype, want):
    z2 = _aligned(3 * 12 * 12 * c2, dtype).view(3, 12, 12, c2)
    weight = torch.zeros(c4, c2, 4, 4)
    assert {v for v, ok in typed_expand.SUPPORTS.items() if ok(z2, weight, s3)} == want
    padded = _aligned(3 * 13 * 13 * c2, dtype).view(3, 13, 13, c2)
    # v3 runs K5's kernel on the padded grid, read in place: K5's limits
    assert typed_expand.typed_c3_expand_v3_supports(padded, weight, s3) == ("v4" in want)
    assert not typed_expand.typed_c3_expand_supports(padded, weight, s3)  # the raw grid is due
