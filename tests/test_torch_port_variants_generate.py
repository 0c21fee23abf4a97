"""The serving A/B configurations as a whole: the port's 128^2 decoder and
`Generator.generate` against JAX in the same configuration (the typed-c3
variant chosen by `AGL_TYPED_C3`, the c7 head through `spade_few_out_conv`
with the grouped head off), JAX's Pallas kernels run in interpret mode; and
the port's routing, switches and bench flags for them.

On the CPU the port runs its plain paths whatever the switches say, so each
case holds the one plain path against JAX routed through another kernel.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.generator import Generator
from aglayout_tpu.ops import pallas_spade_conv as psc
from aglayout_tpu.ops import pallas_typed_expand as pte
from aglayout_tpu_torch import bench
from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.models import build_generator
from aglayout_tpu_torch.models import generator as port_generator
from aglayout_tpu_torch.models.generator import Generator as TorchGenerator
from aglayout_tpu_torch.ops import spade_conv
from torch_port_common import NUM_CLASSES, SMALL, generator_pair, layouts, nchw, nhwc

torch.set_num_threads(1)
NARROW = dict(SMALL, resi_num=1, num_classes=NUM_CLASSES)
HEADS = ("spade_few_out_conv", "spade_few_out_conv8", "spade_apply8")
TYPED = ("typed_c3_expand_v4", "typed_c3_expand_v5", "typed_c3_expand_v6")


@pytest.fixture()
def jax_calls(monkeypatch):
    """JAX's Pallas kernels in interpret mode (the model imports them from
    their modules at call time, so patching the modules' attributes reaches
    them); returns the list of (kernel name, keyword arguments) called."""
    calls = []

    def interpreted(module, name):
        kernel = getattr(module, name)

        def run(*args, **kw):
            calls.append((name, kw))
            return kernel(*args, interpret=True, **kw)

        monkeypatch.setattr(module, name, run)

    for name in HEADS:
        interpreted(psc, name)
    for name in TYPED:
        interpreted(pte, name)
    return calls


def _generate_both(jm, v, tm, ins):
    want = jm.apply(v, *map(jnp.asarray, ins), None, False, method=Generator.generate)
    objs, *rest = ins
    got = tm.generate(torch.from_numpy(objs.astype(np.int64)), *map(torch.from_numpy, rest))
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("variant", ["v5", "v6"])
def test_generate128_typed_variant_matches_jax(jax_calls, monkeypatch, variant):
    """`typed_c3` v5 / v6 against JAX under AGL_TYPED_C3 with its typed
    kernel on: JAX must call that variant, and the images agree."""
    monkeypatch.setenv("AGL_TYPED_C3", variant)
    jm, v, tm = generator_pair(seed=1, image_size=128)
    tm.layout_encoder.typed_c3 = variant
    got, want = _generate_both(jm.clone(pallas_heads=True), v, tm, layouts(2, 3, seed=1))
    typed = [name for name, _ in jax_calls if name in TYPED]
    assert typed == [f"typed_c3_expand_{variant}"]
    assert got.shape == (2, 128, 128, 3) and np.isfinite(got).all()
    # f32; the kernels' one-hot and kn2row matmuls re-associate sums that
    # the port's gathers and convs take in another order
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def _compact_route_pair():
    """conv_dim 64 (JAX's compact gate wants the c7 head's C % 128 == 0),
    everything else narrow; JAX with the grouped head off and compact on."""
    jm, v, tm = generator_pair(seed=2, image_size=128, conv_dim=64, resi_num=1)
    jm = jm.clone(pallas_heads=True, pallas_grouped_heads=False, pallas_compact_heads=True)
    tm.decoder.use_head8_kernel = False
    return jm, v, tm


def _head_calls(calls):
    return [(name, bool(kw.get("compact"))) for name, kw in calls if name in HEADS]


def test_decoder128_head8_off_matches_jax(jax_calls):
    """The decoder with the c7 head on K2's compact route: JAX calls
    `spade_few_out_conv` twice (c4 flat, c7 compact) and the grouped kernel
    never; the port's decoder agrees."""
    jm, v, tm = _compact_route_pair()
    rng = np.random.RandomState(3)
    hidden = rng.randn(2, 8, 8, 64).astype(np.float32)
    global_h = rng.randn(2, 128).astype(np.float32)
    want = jm.apply(v, jnp.asarray(hidden), jnp.asarray(global_h), False,
                    method=lambda m, *a: m.decoder(*a))
    with torch.no_grad():
        got = tm.decoder(nchw(hidden), torch.from_numpy(global_h))
    assert _head_calls(jax_calls) == [("spade_few_out_conv", False), ("spade_few_out_conv", True)]
    assert got.shape == (2, 3, 128, 128)
    want = np.asarray(want)
    # f32; kn2row matmuls vs direct convs, carried through c5, c6 and c7
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_generate128_head8_off_matches_jax(jax_calls):
    """The whole of generate in that configuration (JAX `bench.py
    --no_grouped_heads`), typed kernel on."""
    jm, v, tm = _compact_route_pair()
    got, want = _generate_both(jm, v, tm, layouts(2, 3, seed=4))
    assert _head_calls(jax_calls) == [("spade_few_out_conv", False), ("spade_few_out_conv", True)]
    assert [name for name, _ in jax_calls if name in TYPED] == ["typed_c3_expand_v4"]
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, to reach the decoder's
    kernel routes without one."""

    @property
    def is_cuda(self):
        return True


# switches -> the wrapper the c7 head must call, and its compact flag
@pytest.mark.parametrize("head8,head,compact,route", [
    (True, True, True, ("spade_few_out_conv8", None)),
    (False, True, True, ("spade_few_out_conv", True)),
    (False, True, False, ("spade_few_out_conv", False)),
    (False, False, True, None),
])
def test_head8_routes(monkeypatch, head8, head, compact, route):
    """`Decoder._head8` routes as JAX's `_head`: K3, else K2 compact or
    flat, else dense; each route gives the dense head's tensor."""
    cfg = config_for(128, **NARROW, use_head8_kernel=head8, use_head_kernel=head,
                     use_compact_heads=compact)
    dec = build_generator(cfg, "cpu", seed=5).decoder
    calls = []

    def record(name):
        plain = getattr(spade_conv, name + "_plain")

        def run(x, a_tab, b_tab, weight, bias, f, **kw):
            calls.append((name, kw.get("compact")))
            return plain(x, a_tab, b_tab, weight, bias, f, **kw)

        monkeypatch.setattr(port_generator, name, run)

    record("spade_few_out_conv")
    record("spade_few_out_conv8")
    g = torch.Generator().manual_seed(5)
    h, seg = torch.randn(2, 16, 128, 128, generator=g), torch.randn(2, 8, 8, 8, generator=g)
    with torch.no_grad():
        want = dec.c7(torch.relu(dec.spade_5(h, seg)))
        got = dec._head8(dec.spade_5, dec.c7, h.as_subclass(_OnCard), seg)
    assert calls == ([route] if route else [])
    # f32: the folded tables against the dense SPADE, summation order
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_c4_head_keeps_flat_tables(monkeypatch):
    """The default path's routing is unchanged: the c4 head calls K2 on flat
    tables whatever `use_compact_heads` says."""
    dec = build_generator(config_for(128, **NARROW), "cpu", seed=6).decoder
    seen = []
    monkeypatch.setattr(port_generator, "spade_few_out_conv",
                        lambda x, a, b, w, bias, f, compact: seen.append((compact, a.shape)) or
                        spade_conv.spade_few_out_conv_plain(x, a, b, w, bias, f, compact))
    h, seg = torch.randn(1, 8, 64, 64).as_subclass(_OnCard), torch.randn(1, 8, 8, 8)
    with torch.no_grad():
        dec._head(dec.spade_3, dec.c4, h, seg)
    assert seen == [(False, (1, 8, 5, 8, 64))]


def test_unknown_typed_variant_raises():
    with pytest.raises(ValueError, match="typed_c3 'v7'"):
        build_generator(config_for(128, **NARROW, typed_c3="v7"), "cpu")
    with pytest.raises(ValueError, match="typed_c3"):
        TorchGenerator(num_classes=NUM_CLASSES, typed_c3="v3", **SMALL)


@pytest.mark.parametrize("kw", [{"typed_c3": "v5"}, {"typed_c3": "v6"},
                                {"use_head8_kernel": False},
                                {"use_head8_kernel": False, "use_compact_heads": False}])
def test_configurations_share_weights_and_cpu_path(kw):
    """No configuration adds a parameter: the default model's state_dict
    loads strictly into each (so one bridged checkpoint serves them all),
    and on the CPU each gives the default's image bit for bit."""
    base = build_generator(config_for(128, **NARROW), "cpu", seed=7)
    other = build_generator(config_for(128, **NARROW, **kw), "cpu", seed=8)
    other.load_state_dict(base.state_dict(), strict=True)
    ins = layouts(2, 3, seed=7)
    tensors = [torch.from_numpy(ins[0].astype(np.int64))] + [torch.from_numpy(a) for a in ins[1:]]
    assert torch.equal(other.generate(*tensors), base.generate(*tensors))


def _args(*argv):
    return bench.parser().parse_args(list(argv))


@pytest.mark.parametrize("env,default", [(None, "v4"), ("v5", "v5"), ("v6", "v6"), ("v3", "v4"),
                                         ("", "v4")])
def test_bench_typed_default_follows_the_environment(monkeypatch, env, default):
    if env is None:
        monkeypatch.delenv("AGL_TYPED_C3", raising=False)
    else:
        monkeypatch.setenv("AGL_TYPED_C3", env)
    assert bench.config_from_args(_args()).typed_c3 == default
    assert bench.config_from_args(_args("--typed_c3", "v6")).typed_c3 == "v6"  # the flag wins


def test_bench_variant_flags(monkeypatch):
    monkeypatch.delenv("AGL_TYPED_C3", raising=False)
    cfg = bench.config_from_args(_args())
    assert cfg.typed_c3 == "v4" and cfg.use_compact_heads and cfg.use_head8_kernel
    cfg = bench.config_from_args(_args("--no_head8", "--no_compact_heads", "--typed_c3", "v5"))
    assert (cfg.typed_c3, cfg.use_compact_heads, cfg.use_head8_kernel) == ("v5", False, False)
    assert cfg.use_head_kernel  # --no_head8 leaves K2 on, which now takes the c7 head
    with pytest.raises(SystemExit):
        _args("--typed_c3", "v3")


def test_bench_json_names_the_configuration(monkeypatch):
    monkeypatch.delenv("AGL_TYPED_C3", raising=False)
    argv = ["--device", "cpu", "--batch_size", "2", "--max_objects", "3", "--iters", "1"]
    out = bench.run(_args(*argv, "--typed_c3", "v6", "--no_head8", "--no_compact_heads"), **NARROW)
    assert out["config"]["typed_c3"] == "v6" and out["config"]["compact_heads"] is False
    assert out["config"]["kernels_off"] == ["use_head8_kernel"]
    out = bench.run(_args(*argv), **NARROW)
    assert out["config"]["typed_c3"] == "v4" and out["config"]["compact_heads"] is True
    json.dumps(out)


def test_head_tile_holds_the_c7_shape():
    """K2's channel tiling: the c7 head's shape (C = 128, W = 128, K = 7),
    which the untiled kernel could not hold, has a tile in every mode."""
    assert spade_conv._pick_tile(128, 128, 128, 7, 2) == (4, 16)
    assert spade_conv._pick_tile(128, 128, 128, 7, 4, vec=4) == (4, 16)
    assert spade_conv._pick_tile(64, 64, 64, 7, 2) == (8, 16)
    assert spade_conv._pick_tile(6, 16, 16, 3, 4) == (16, 2)
    with pytest.raises(ValueError, match="not supported"):
        spade_conv._pick_tile(64, 8, 1024, 7, 2)  # one row already exceeds 512 pixels
    with pytest.raises(ValueError, match="not supported"):
        spade_conv._pick_tile(6, 16, 16, 3, 2, vec=8)  # no chunk of C = 6 is a multiple of 8
