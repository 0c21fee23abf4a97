"""The port's int8 serving pieces against the JAX package: the weight
quantiser, the plain versions of K6 `conv_small_int8`, K7 `spade_c6_int8`
and K4' `spade_apply_t` against the Pallas kernels in interpret mode, and
the ConvLSTM and `Generator.generate` with `int8_serving=True`.

JAX's cell calls its Pallas kernel without `interpret`, so the model tests
patch `aglayout_tpu.ops.pallas_conv8_int8.conv_small_int8` to its
interpret-mode form, and lower `_INT8_MIN_CINCOUT` on both sides to 1 so
that the narrow test models take the int8 route. Nothing in the JAX
package changes for that.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aglayout_tpu.models.convlstm as jax_convlstm
import aglayout_tpu.ops.pallas_conv8_int8 as jax_conv8
import aglayout_tpu_torch.models.convlstm as port_convlstm
from aglayout_tpu.models.generator import Generator
from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.ops.pallas_spade_c6_int8 import quantize_conv_weights as jax_quantize
from aglayout_tpu.ops.pallas_spade_c6_int8 import spade_c6_int8 as jax_spade_c6_int8
from aglayout_tpu.ops.pallas_spade_conv import spade_apply_t as jax_spade_apply_t
from aglayout_tpu.utils.torch_import import _TreeBuilder
from aglayout_tpu_torch.models.generator import init_weights
from aglayout_tpu_torch.ops.conv8_int8 import conv_small_int8
from aglayout_tpu_torch.ops.int8 import int8_conv_exact, quantize_conv_weights
from aglayout_tpu_torch.ops.spade_c6_int8 import spade_c6_int8
from aglayout_tpu_torch.ops.spade_conv import compact_to_flat, spade_apply_t
from torch_port_common import generator_pair, layouts, nchw, nhwc, spade_pair

torch.set_num_threads(1)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# of the output's max. f32: both sides hold the same exact integers until the
# dequantising products; bf16: one rounding of the output, half an ulp (2^-9)
# where the f32 values differ in their last bits, 2^-7 with margin
TOL = {"f32": 1e-5, "bf16": 2 ** -7}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"{what}: max |err| / max |want| = {err:.3e} (tol {tol:.1e})")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert err <= tol, (what, err, tol)


@pytest.fixture
def int8_on_cpu(monkeypatch):
    """JAX's int8 cell runnable on a CPU (interpret mode), and every cell
    of both packages wide enough for the int8 route."""
    monkeypatch.setattr(jax_conv8, "conv_small_int8",
                        functools.partial(jax_conv8.conv_small_int8, interpret=True))
    monkeypatch.setattr(jax_convlstm, "_INT8_MIN_CINCOUT", 1)
    monkeypatch.setattr(port_convlstm, "_INT8_MIN_CINCOUT", 1)


def test_quantize_conv_weights_matches_jax():
    """The same int8 values and scales; the port returns (O, K, K, I)."""
    w = (np.random.RandomState(1).randn(5, 5, 16, 32) * 0.1).astype(np.float32)  # HWIO
    w[..., 3] = 0.0  # an all-zero output channel takes the 1e-12 floor
    jq, js = jax_quantize(jnp.asarray(w))
    tq, ts = quantize_conv_weights(torch.from_numpy(w).permute(3, 2, 0, 1))
    assert tq.dtype == torch.int8 and tq.shape == (32, 5, 5, 16) and tq.is_contiguous()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).transpose(3, 0, 1, 2))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_int8_conv_exact_is_exact():
    """Past 2^24 and in image groups: equal to an int64 reference."""
    rng = np.random.RandomState(0)
    q = rng.randint(-127, 128, (3, 80, 4, 4))
    q[0] = 127
    wq = rng.randint(-127, 128, (8, 5, 5, 80)).astype(np.int8)
    wq[0] = 127
    got = int8_conv_exact(torch.from_numpy(q).float(), torch.from_numpy(wq))
    qp = np.pad(q, ((0, 0), (0, 0), (2, 2), (2, 2))).astype(np.int64)
    want = np.zeros((3, 8, 4, 4), np.int64)
    for dy in range(5):
        for dx in range(5):
            want += np.einsum("bihw,oi->bohw", qp[:, :, dy:dy + 4, dx:dx + 4],
                              wq[:, dy, dx].astype(np.int64))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))
    assert want.max() > 2 ** 24  # where a float32 sum would have rounded


# the JAX kernel test's size (tests/test_pallas_conv8_int8.py), and a batch
# that 16 does not divide: gb falls to the largest divisor of B
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,gb", [(8, 4), (6, 16)])
def test_conv_small_int8_plain_matches_jax_kernel(b, gb, dt):
    jdt, tdt = DT[dt]
    rng = np.random.RandomState(0)
    s, cin, cout, k = 8, 192, 256, 5
    x = rng.randn(b, s, s, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.05).astype(np.float32)
    jq, js = jax_quantize(jnp.asarray(w))
    want = jax_conv8.conv_small_int8(jnp.asarray(x, jdt), jq, js, k=k, gb=gb, interpret=True)
    tq, ts = quantize_conv_weights(torch.from_numpy(w).permute(3, 2, 0, 1))
    got = conv_small_int8(nchw(x).to(tdt), tq, ts, k=k, gb=gb)  # a CPU tensor: the plain version
    assert got.dtype == tdt and got.shape == (b, cout, s, s)
    _close(nhwc(got), want, TOL[dt], f"conv_small_int8 b={b} gb={gb} {dt}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_spade_c6_int8_plain_matches_jax_kernel(dt):
    """At tests/test_pallas_spade_c6_int8.py's size. The port reads compact
    tables, JAX their column-expanded (B, H/f, 5, W, C) form: the same
    random class tables go to both."""
    jdt, tdt = DT[dt]
    rng = np.random.RandomState(0)
    b, h, w, c, f = 2, 32, 32, 128, 8
    x = rng.randn(b, h, w, c).astype(np.float32)
    a_tab = torch.from_numpy(rng.uniform(0.5, 1.5, (b, h // f, 5, c, 5 * w // f)).astype(np.float32))
    b_tab = torch.from_numpy((rng.randn(b, h // f, 5, c, 5 * w // f) * 0.2).astype(np.float32))
    wk = (rng.randn(5, 5, c, c) * 0.05).astype(np.float32)
    jq, js = jax_quantize(jnp.asarray(wk))
    ja, jb = (jnp.asarray(compact_to_flat(t, f).permute(0, 1, 2, 4, 3).numpy(), jdt)
              for t in (a_tab, b_tab))
    want = jax_spade_c6_int8(jnp.asarray(x, jdt), ja, jb, jq, js, f=f, ch=16, interpret=True)
    tq, ts = quantize_conv_weights(torch.from_numpy(wk).permute(3, 2, 0, 1))
    got = spade_c6_int8(nchw(x).to(tdt), a_tab.to(tdt), b_tab.to(tdt), tq, ts, f)
    assert got.dtype == tdt and got.shape == (b, c, h, w)
    _close(nhwc(got), want, TOL[dt], f"spade_c6_int8 {dt}")


@pytest.mark.parametrize("dt,tol", [("f32", 1e-6), ("bf16", 2 ** -7)])
def test_spade_apply_t_plain_matches_jax_kernel(dt, tol):
    """At tests/test_pallas_spade_conv.py::test_spade_apply_t_matches_dense's
    shape, each side fed its own package's flat tables."""
    jdt, tdt = DT[dt]
    b, hs, c, f = 2, 8, 128, 16
    spade, jspade, variables = spade_pair(c, 64, seed=2)
    rng = np.random.RandomState(2)
    seg = rng.randn(b, hs, hs, 64).astype(np.float32)
    x = rng.randn(b, hs * f, hs * f, c).astype(np.float32)
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f, method=JaxSPADE.folded_affine_tables)
    x_t = jnp.transpose(jnp.asarray(x, jdt), (1, 2, 0, 3))
    want = jnp.transpose(jax_spade_apply_t(x_t, ja.astype(jdt), jb.astype(jdt), f=f, interpret=True),
                         (2, 0, 1, 3))
    with torch.no_grad():
        ta, tb = (t.to(tdt) for t in spade.folded_affine_tables(nchw(seg), f))
        got = spade_apply_t(nchw(x).to(tdt), ta, tb, f)
    assert got.dtype == tdt and ta.shape == (b, hs, 5, c, hs * f)
    # f32: the same product and sum from tables that differ in summation
    # order; bf16: the tables' own bf16 rounding can flip, one ulp of |x * A|
    _close(nhwc(got), want, tol, f"spade_apply_t {dt}")


def test_int8_wrappers_reject_other_devices():
    """A wrapper takes its plain version only for CPU tensors."""
    h = torch.zeros(1, 16, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_small_int8(h, h, h)
    with pytest.raises(ValueError, match="unsupported device"):
        spade_c6_int8(h, h, h, h, h, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        spade_apply_t(h, h, h, 16)


def test_layout_fuser_int8_matches_jax(int8_on_cpu):
    """The masked ConvLSTM with int8 gate convs, a gap in the valid mask."""
    b, o, cin, hw, dims = 2, 3, 6, 8, (16, 8)
    fuser = init_weights(port_convlstm.LayoutFuser(cin, dims, int8_serving=True),
                         torch.Generator().manual_seed(0)).eval()
    dense = port_convlstm.LayoutFuser(cin, dims).eval()
    dense.load_state_dict(fuser.state_dict())
    t = _TreeBuilder({k: v.numpy() for k, v in fuser.state_dict().items()})
    for i in range(len(dims)):
        t.conv(f"cell_list.{i}.conv", ("step", f"cell_{i}", "conv"))
    rng = np.random.RandomState(0)
    x = rng.randn(b, o, hw, hw, cin).astype(np.float32)
    valid = np.array([[1, 1, 1], [1, 0, 1]], np.float32)
    want = jax_convlstm.LayoutFuser(dims, int8_serving=True).apply(
        {"params": t.params}, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3)
        got = fuser(xt, torch.from_numpy(valid))
        exact = dense(xt, torch.from_numpy(valid))
    assert all(cell.int8_engaged for cell in fuser.cell_list)
    # f32 on both sides. A last-bit difference in h can move an activation
    # across a quantisation step (1/127 of the chunk's max) in a later slot;
    # measured 1e-6 here, held at 1e-4 of the output scale
    _close(nhwc(got), want, 1e-4, "LayoutFuser int8, port vs JAX")
    drift = (got - exact).abs().max() / exact.abs().max()
    assert 1e-5 < drift < 0.1, drift  # the int8 route ran, and stays near the dense fuser


@pytest.mark.parametrize("image_size", [64, 128])
def test_generate_int8_matches_jax(int8_on_cpu, image_size):
    """The path as a whole: small `Generator.generate` with
    `int8_serving=True`, f32, port against JAX."""
    jm, v, tm = generator_pair(seed=0, image_size=image_size, int8_serving=True)
    ins = layouts(2, 3, seed=0)
    want = jm.apply(v, *map(jnp.asarray, ins), None, False, method=Generator.generate)
    objs, *rest = ins
    tensors = [torch.from_numpy(objs.astype(np.int64))] + [torch.from_numpy(a) for a in rest]
    got = tm.generate(*tensors)
    assert got.shape == (2, image_size, image_size, 3)
    assert all(cell.int8_engaged for cell in tm.layout_encoder.clstm.cell_list)
    # f32; as for the fuser, a flipped quantisation step upstream is the
    # only source beyond summation order: measured ~1e-5, held at 1e-3
    _close(got.numpy(), want, 1e-3, f"generate {image_size} int8, port vs JAX")
    _, _, dense = generator_pair(seed=0, image_size=image_size)
    assert not torch.equal(dense.generate(*tensors), got)  # int8 changed the result


def test_int8_gate_engages_only_for_the_wide_cell(monkeypatch):
    """At the unpatched threshold and the published widths, layer 0's
    640 -> 512 conv takes the int8 route and 192 -> 256 does not, in both
    packages."""
    assert port_convlstm._INT8_MIN_CINCOUT == jax_convlstm._INT8_MIN_CINCOUT == 512 * 512
    calls = []

    def recorder(inp, wq, sw, *, k):
        calls.append((inp.shape[-1], wq.shape[-1]))
        return jnp.zeros(inp.shape[:-1] + (wq.shape[-1],), inp.dtype)

    monkeypatch.setattr(jax_conv8, "conv_small_int8", recorder)
    for x_dim, hidden, engaged in ((512, 128, True), (128, 64, False)):
        cell = jax_convlstm.ConvLSTMCell(hidden, int8_serving=True)
        h = jnp.zeros((1, 8, 8, hidden))
        n = len(calls)
        jax.eval_shape(lambda: cell.init(jax.random.PRNGKey(0), (h, h), jnp.zeros((1, 8, 8, x_dim))))
        assert (len(calls) > n) == engaged
        tcell = port_convlstm.ConvLSTMCell(x_dim, hidden, int8_serving=True)
        assert tcell.int8_engaged == engaged
        assert not port_convlstm.ConvLSTMCell(x_dim, hidden).int8_engaged
    assert calls and set(calls) == {(640, 512)}
    fuser = port_convlstm.LayoutFuser(512, (128, 64, 64), int8_serving=True)
    assert [cell.int8_engaged for cell in fuser.cell_list] == [True, False, False]
    assert [q is not None for q in (c.quantized_weights() for c in fuser.cell_list)] == [True, False, False]
