"""Shared set-up of the `test_torch_port_*` files: a small 64^2 or 128^2
generator in both packages with the same weights, and seeded layouts. Inputs come
from numpy and pass between the two packages as numpy arrays.

The weights are drawn once, in the port (`init_weights`: torch's default
initialisers, non-trivial BN running statistics and affines), and carried
into the JAX trees by the JAX package's own importer, `import_generator`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aglayout_tpu.models.generator import Generator
from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.utils.torch_import import _TreeBuilder, import_generator
from aglayout_tpu_torch.bench import TRAIN_SMALL
from aglayout_tpu_torch.models.generator import Generator as TorchGenerator
from aglayout_tpu_torch.models.generator import init_weights
from aglayout_tpu_torch.models.norms import SPADE

NUM_CLASSES = 23
SMALL = dict(conv_dim=8, z_dim=8, embedding_dim=8, attribute_dim=12, clstm_layers=2, resi_num=2)


def layouts(b: int, o: int, z_dim: int = SMALL["z_dim"],
            attribute_dim: int = SMALL["attribute_dim"], seed: int = 0):
    """objs, boxes, valid, z, attribute as numpy, made as bench.py makes
    them, with some invalid object slots."""
    rng = np.random.RandomState(seed)
    objs = rng.randint(0, NUM_CLASSES, (b, o)).astype(np.int32)
    xy0 = rng.uniform(0, 0.6, (b, o, 2)).astype(np.float32)
    wh = rng.uniform(0.1, 0.4, (b, o, 2)).astype(np.float32)
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, 1.0)], -1)
    valid = (np.arange(o)[None] < rng.randint(1, o + 1, (b,))[:, None]).astype(np.float32)
    valid[0] = 1.0
    z = rng.randn(b, o, z_dim).astype(np.float32)
    attr = (rng.rand(b, o, attribute_dim) < 0.1).astype(np.float32)
    return objs, boxes, valid, z, attr


def generator_pair(seed: int = 0, dtype=None, image_size: int = 64, **kw):
    """(JAX Generator, its variables, the port's eval Generator on the CPU),
    holding the same seeded weights. `dtype` is "bf16" or None; `kw` goes to
    both constructors (widths, or `int8_serving=True`: its int8 weights are
    derived, so the bridge carries no new parameter)."""
    cfg = dict(SMALL, image_size=image_size, object_size=32 if image_size == 64 else 64, **kw)
    tmodel = TorchGenerator(num_classes=NUM_CLASSES,
                            dtype=torch.bfloat16 if dtype == "bf16" else None, **cfg)
    init_weights(tmodel, torch.Generator().manual_seed(seed)).eval()
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    params, stats = import_generator(
        sd, image_size=image_size, clstm_layers=cfg["clstm_layers"], resi_num=cfg["resi_num"]
    )
    if dtype == "bf16":
        import jax.numpy as jnp

        cfg["dtype"] = jnp.bfloat16
    jmodel = Generator(num_classes=NUM_CLASSES, **cfg)
    return jmodel, {"params": params, "batch_stats": stats}, tmodel


def spade_pair(c: int, seg_c: int, seed: int = 0):
    """A seeded port SPADE (nhidden 2 * seg_c, as the decoder's) and the
    JAX SPADE and variables holding its weights."""
    spade = init_weights(SPADE(c, seg_features=seg_c, nhidden=2 * seg_c),
                         torch.Generator().manual_seed(seed)).eval()
    t = _TreeBuilder({k: v.numpy() for k, v in spade.state_dict().items()})
    t.spade("", ())
    jspade = JaxSPADE(c, seg_features=seg_c, nhidden=2 * seg_c)
    return spade, jspade, {"params": t.params, "batch_stats": t.stats}


def head_case(b: int, hs: int, c: int, f: int, k: int, seed: int):
    """An RGB head's inputs in both packages: `spade_pair(c, 64, seed)`, a
    (b, hs, hs, 64) segmap, x (b, hs f, hs f, c), a JAX HWIO (k, k, c, 3)
    kernel and a bias, as numpy."""
    spade, jspade, variables = spade_pair(c, 64, seed)
    rng = np.random.RandomState(seed)
    seg = rng.randn(b, hs, hs, 64).astype(np.float32)
    x = rng.randn(b, hs * f, hs * f, c).astype(np.float32)
    kern = (0.1 * rng.randn(k, k, c, 3)).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    return spade, jspade, variables, seg, x, kern, bias


def nchw(a):
    """NHWC array -> torch NCHW f32 tensor."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    """torch NCHW tensor -> numpy NHWC f32."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def compact_tables_to_jax_flat(t):
    """The port's compact SPADE table (B, H/f, 5, C, 5 W/f) -> the layout of
    JAX's `SPADE.folded_affine_tables_compact_flat`, (B, 5 W/f, H/f, 5, C):
    a TPU lane layout the port does not carry."""
    return t.permute(0, 4, 1, 2, 3)


# ---- the train step in both packages

# the train tests' widths are SMALL's (with d_conv_dim 8, B=3, O=3)
assert {k: TRAIN_SMALL[k] for k in SMALL} == SMALL and TRAIN_SMALL["num_classes"] == NUM_CLASSES


def train_configs(image_size: int = 64, **kw):
    """(the port's Config, the JAX package's) of a small train step: SMALL
    widths, d_conv_dim 8, B=3, O=3; `kw` goes to both."""
    from aglayout_tpu.config import Config as JaxConfig
    from aglayout_tpu_torch.config import config_for

    fields = dict(TRAIN_SMALL, image_size=image_size, object_size=32 if image_size == 64 else 64, **kw)
    return config_for(**fields), JaxConfig(**fields)


def train_inputs(cfg, seed: int = 0):
    """(batch, matrix, pos_weight) as numpy at `cfg.batch_size`: the bench's
    (`aglayout_tpu_torch.bench.train_inputs`; seeded positive-class weights
    at these narrow widths)."""
    from aglayout_tpu_torch.bench import train_inputs as bench_train_inputs

    return bench_train_inputs(cfg, cfg.batch_size, seed)


def sd_numpy(module):
    """module's state_dict as numpy copies: a view of a tensor would reach
    JAX's arrays (which may alias host memory) and change with it."""
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def jax_train_state(models, jcfg, seed: int = 0):
    """The JAX `TrainState` holding the port's `models`' weights (through
    the JAX package's own importers), fresh Adam states and key `seed`."""
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.train.state import NetState, TrainState
    from aglayout_tpu.train.state import Models as JaxModels
    from aglayout_tpu.utils.torch_import import (
        import_attribute_discriminator,
        import_image_discriminator,
        import_object_discriminator,
    )

    jmodels = JaxModels(jcfg)
    trees = {
        "g": import_generator(sd_numpy(models.g), jcfg.image_size, jcfg.clstm_layers,
                              jcfg.resi_num),
        "d_image": import_image_discriminator(sd_numpy(models.d_image)),
        "d_object": import_object_discriminator(sd_numpy(models.d_object)),
        "d_att": import_attribute_discriminator(sd_numpy(models.d_att), jcfg.image_size == 128),
    }

    def net(params, stats):
        params, stats = jax.tree.map(jnp.asarray, (params, stats))
        return NetState(params=params, stats=stats, opt=jmodels.tx.init(params))

    state = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed),
                       **{k: net(*v) for k, v in trees.items()})
    return jmodels, state


def redraw_weights(module, seed: int, gain: float = 1.5):
    """Redraw every conv and linear weight of `module` normal with variance
    gain / fan_in. torch's default initialisers shrink each layer's
    variance about 3x, so that a deep net's output hardly depends on its
    input (the small generator's images move by 1e-4 with z); at gain 1.5
    its images have a std of about 0.7 and z moves them by about 0.4."""
    import torch.nn as nn

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
            elif isinstance(m, nn.ConvTranspose2d):  # stride 2: a quarter of the taps an output
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel() / 4
            else:
                continue
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (gain / fan_in) ** 0.5)
    return module


def eval_models_pair(cfg, jcfg, seed: int = 0):
    """(the port's `Models` on the CPU, JAX's models, JAX's train state) with
    the same seeded weights, for the test-time drivers: the generator's
    redrawn (`redraw_weights`) so that its images depend on z and the
    layout. The attribute D's u and v are those after one power iteration,
    as a trained or checkpointed D holds them (freshly drawn ones make
    sigma = u^T W v a sum that cancels, which two f32 implementations round
    7e-5 apart)."""
    from aglayout_tpu_torch.train.state import create_train_state

    models = create_train_state(cfg, "cpu", seed=seed).models
    redraw_weights(models.g, seed)
    with torch.no_grad():
        models.d_att(torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0)), True)
    return (models, *jax_train_state(models, jcfg))


def jax_eps(jmodels, params, stats, batch, z, rng):
    """The reparametrisation draw of the first CropEncoder call of the JAX
    generator's train forward under `rng`, (B*O, z_dim): from that call's
    (z, mu, logvar), captured, as eps = (z - mu) / exp(logvar / 2). It
    depends on the key and the shapes only."""
    import jax.numpy as jnp

    from aglayout_tpu.models.generator import CropEncoder

    _, state = jmodels.generator.apply(
        {"params": params, "batch_stats": stats}, batch["imgs"], batch["objs"], batch["boxes"],
        batch["masks"], batch["valid"], z, batch["attribute"], batch["masks_shift"],
        batch["boxes_shift"], batch["attribute"], train=True, rngs={"reparam": rng},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, method: isinstance(mdl, CropEncoder),
    )
    zz, mu, logvar = state["intermediates"]["crop_encoder"]["__call__"][0]
    return (zz - mu) / jnp.exp(logvar / 2)


def jax_eval_forward(jgenerator, variables, args, key):
    """JAX's eval forward on the generator's ten positional `args` under the
    reparametrisation key `key`, and the draw of its first CropEncoder call,
    eps = (z - mu) / exp(logvar / 2), captured: (outputs, eps)."""
    import jax.numpy as jnp

    from aglayout_tpu.models.generator import CropEncoder

    out, st = jgenerator.apply(variables, *args, train=False, rngs={"reparam": key},
                               mutable=["intermediates"],
                               capture_intermediates=lambda mdl, method: isinstance(mdl, CropEncoder))
    z, mu, logvar = st["intermediates"]["crop_encoder"]["__call__"][0]
    return out, (z - mu) / jnp.exp(logvar / 2)


@functools.lru_cache(maxsize=None)
def _jitted_eval_forward(jgenerator):
    import jax

    return jax.jit(functools.partial(jax_eval_forward, jgenerator))


def jax_eval_draws(jmodels, jstate, batches, z_dim: int, seed: int, order):
    """The draws of a JAX test-time driver over `batches`, as numpy, one dict
    a batch, for the port's `draws=`: from PRNGKey(seed), each batch splits
    the running key into itself and one key a name of `order`, as the
    driver splits it; a "z..." name is the normal (B, O, z_dim) its key
    draws, an "eps..." name the reparametrisation draw of an eval forward
    under its key (which depends on the key and the shapes only)."""
    import jax
    import jax.numpy as jnp

    g_vars = {"params": jstate.g.params, "batch_stats": jstate.g.stats}
    capture = _jitted_eval_forward(jmodels.generator)
    key, draws = jax.random.PRNGKey(seed), []
    for batch in batches:
        key, *keys = jax.random.split(key, 1 + len(order))
        b, o = batch["objs"].shape
        args = tuple(jnp.asarray(batch[k]) for k in ("imgs", "objs", "boxes", "masks", "valid"))
        args += (jnp.zeros((b, o, z_dim)),) + tuple(
            jnp.asarray(batch[k]) for k in ("attribute", "masks_shift", "boxes_shift", "attribute"))
        draws.append({name: np.array(jax.random.normal(k, (b, o, z_dim)) if name.startswith("z")
                                     else capture(g_vars, args, k)[1])
                      for name, k in zip(order, keys)})
    return draws


def jax_step_draws(jstate, jmodels, jcfg, batch, matrix, eps_fn):
    """The draws of the JAX train step from `jstate.rng`, for the port's
    `train_step(draws=)`, as numpy: z, the swap's categorical draws and
    coin with the logits of `swap_attributes`, and the first G forward's
    eps (and, under `double_g_forward`, the second's) through `eps_fn`
    (a jit of `jax_eps`)."""
    import jax
    import jax.numpy as jnp

    b, o = batch["objs"].shape
    n = b * o
    rng_z, rng_swap, rng_rep_d, rng_rep_g, _ = jax.random.split(jstate.rng, 5)
    z = jax.random.normal(rng_z, (b, o, jcfg.z_dim), jnp.float32)
    attribute = jnp.asarray(batch["attribute"]).reshape(n, -1)
    weights = jnp.take(jnp.asarray(matrix), jnp.asarray(batch["objs"]).reshape(-1), axis=0) * (
        1.0 - attribute)
    safe = jnp.where(jnp.sum(weights, axis=-1, keepdims=True) > 0, weights, jnp.ones_like(weights))
    logits = jnp.log(jnp.maximum(safe, 1e-20))
    k1, k2, k3 = jax.random.split(rng_swap, 3)
    swap = (jax.random.categorical(k1, logits, axis=-1), jax.random.categorical(k2, logits, axis=-1),
            jax.random.bernoulli(k3, 0.5, (n,)))
    draws = {"z": z, "swap": swap,
             "eps": eps_fn(jstate.g.params, jstate.g.stats, batch, z, rng_rep_d)}
    if jcfg.double_g_forward:
        draws["eps_g"] = eps_fn(jstate.g.params, jstate.g.stats, batch, z, rng_rep_g)
    return jax.tree.map(np.asarray, draws)


def torch_draws(draws):
    """`jax_step_draws`' numpy draws -> tensors."""
    return {k: (tuple(torch.from_numpy(np.array(x)) for x in v) if k == "swap"
                else torch.from_numpy(np.array(v))) for k, v in draws.items()}


def close(got, want, tol: float, what: str = ""):
    """max |got - want| <= tol * max |want|, in f32; returns the ratio
    max |got - want| / max |want| (0 where want is all zero and so is got)."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want.detach().cpu() if isinstance(want, torch.Tensor) else want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max(initial=0.0)), float(np.abs(want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max abs err {err:.3e}, max |want| {scale:.3e}, tol {tol}"
    return err / scale if scale else 0.0


class StepCase:
    """One train step in both packages from the same weights, batch and
    draws, at `image_size`: the JAX step jitted once (`jstep`), the JAX
    states before and after (`js0`, `js1`), the port's state after
    (`state1`), both metrics, and `fresh()`, the port's state before (for
    further steps in the port)."""

    def __init__(self, image_size: int):
        import functools

        import jax
        import jax.numpy as jnp

        from aglayout_tpu.train.step import make_train_step as jax_make_train_step
        from aglayout_tpu_torch.data.synthetic import batch_to_torch
        from aglayout_tpu_torch.train.state import create_train_state
        from aglayout_tpu_torch.train.step import make_train_step

        self.cfg, self.jcfg = train_configs(image_size)
        self.batch, self.matrix, self.pos_weight = train_inputs(self.cfg)
        self.fresh = functools.partial(create_train_state, self.cfg, "cpu", 0)
        state = self.fresh()
        self.jmodels, self.js0 = jax_train_state(state.models, self.jcfg)
        self.jstep = jax.jit(jax_make_train_step(self.jcfg, self.jmodels, self.matrix,
                                                 self.pos_weight))
        self.jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.eps_fn = jax.jit(functools.partial(jax_eps, self.jmodels))
        self.tbatch = batch_to_torch(self.batch, "cpu")
        self.draws1 = self.draws(self.js0)
        self.js1, self.jmetrics = self.jstep(self.js0, self.jbatch)
        self.make_step = functools.partial(make_train_step, matrix=self.matrix,
                                           pos_weight=self.pos_weight)
        self.state1, self.metrics = self.port_step(state, self.draws1)

    def draws(self, jstate):
        return torch_draws(jax_step_draws(jstate, self.jmodels, self.jcfg, self.jbatch,
                                          self.matrix, self.eps_fn))

    def port_step(self, state, draws, cfg=None, batch=None):
        step = self.make_step(cfg or self.cfg, state.models)
        return step(state, self.tbatch if batch is None else batch, draws=draws)

    def f64_grads(self):
        """name -> gradient of the port's first step carried out in f64
        from the same weights, batch and draws (the losses stay in f32, as
        both packages compute them): the referee of both f32 steps."""
        state = self.fresh()
        for _, module in state.models.items():
            module.double()

        def cast(t):
            return t.double() if t.is_floating_point() else t

        draws = {k: tuple(map(cast, v)) if k == "swap" else cast(v) for k, v in self.draws1.items()}
        state, _ = self.port_step(state, draws, batch={k: cast(v) for k, v in self.tbatch.items()})
        return {k: 2 * v[1] for k, v in _params_and_moments(state).items()}


LR = 2e-4


def check_step_metrics(case):
    """Every D/* and G/* metric within 1e-4 relative; the grids within one level."""
    for k, v in case.metrics.items():
        if k == "images":
            continue
        want = float(case.jmetrics[k])
        assert abs(float(v) - want) <= 1e-4 * abs(want), (k, float(v), want)
    assert set(case.metrics["images"]) == set(case.jmetrics["images"])
    for k, v in case.metrics["images"].items():
        want = np.asarray(case.jmetrics["images"][k]).astype(np.int32)
        assert v.dtype == torch.uint8 and tuple(v.shape) == want.shape, k
        assert np.abs(v.numpy().astype(np.int32) - want).max() <= 1, k


def _params_and_moments(state):
    """name -> (param, exp_avg, exp_avg_sq) of each net of a port state."""
    out = {}
    for name, module in state.models.items():
        opt = state.opt[name]
        for key, p in module.named_parameters():
            st = opt.state[p]
            out[f"{name}.{key}"] = (p.detach(), st["exp_avg"], st["exp_avg_sq"])
    return out


def noise_tensors(grads):
    """Names of the tensors whose gradient is rounding noise: max |g| below
    1e-6 of the largest in its net (a bias before a batch-statistics BN,
    zero in exact arithmetic)."""
    top = {}
    for k, g in grads.items():
        net = k.split(".")[0]
        top[net] = max(top.get(net, 0.0), g.abs().max().item())
    return {k for k, g in grads.items() if g.abs().max().item() < 1e-6 * top[k.split(".")[0]]}


# The step's gradients against JAX's, each tensor in relative L2, by image
# size. At 64^2 the two packages' f32 gradients are 2.9e-4 apart, and each
# is within 2.9e-4 of the port's f64 step (`StepCase.f64_grads`). At 128^2
# JAX's jitted f32 gradients are 4.0e-2 from that f64 step while the port's
# f32 ones are 1.2e-3 from it: a relu whose input lies near zero takes the
# other side in JAX's f32 and its gradient jumps. Measured by
# `tools/port_train_precision.py --step`.
STEP_GRAD_TOL = {64: 1e-3, 128: 5e-2}
# The port's f32 step gradients against its own f64 step, relative L2.
STEP_F64_TOL = 5e-3
# The share of the elements with |g| above 1e-3 of their tensor's max whose
# gradient changes sign between the packages after one step (measured 0 of
# 671,920 at 64^2, 498 of 980,634 at 128^2).
STEP_FLIP_TOL = {64: 1e-4, 128: 2e-3}


def grad_l2(got, want, noise=frozenset()):
    """name -> |got - want| / |want| (L2) of each gradient but `noise`."""
    return {k: ((got[k] - w).norm() / w.norm()).item() for k, w in want.items() if k not in noise}


def check_grads_end_to_end(got, want, what: str, tol: float):
    """Each tensor's gradient within `tol` of its norm (relative L2), but
    the rounding-noise ones (`noise_tensors`). Returns the worst (ratio,
    name) and the count of tensors checked."""
    rel = grad_l2(got, want, noise_tensors(want))
    for key, r in rel.items():
        assert r <= tol, (what, key, r, tol)
    worst = max(rel, key=rel.get)
    return (rel[worst], worst), len(rel)


def check_step_grads_params_stats(case):
    """After one step: every net's gradients (2 exp_avg: Adam's first
    moment after one step is (1 - 0.5) g in both packages) within
    `STEP_GRAD_TOL` of JAX's; the params within 1e-6 of JAX's wherever
    `adam_sure`, and within 2 lr everywhere (Adam's first step is about
    +-lr, so a sign that flips moves a param by 2 lr); at most
    `STEP_FLIP_TOL` of the elements whose |g| is above 1e-3 of their
    tensor's max change sign;
    every BN running statistic and spectral-norm u, v within 1e-5 of its
    tensor's max |.| (at least 1)."""
    from aglayout_tpu_torch.train.compare import adam_sure
    from aglayout_tpu_torch.utils.jax_import import train_state_from_jax

    size = case.cfg.image_size
    ported = train_state_from_jax(case.js1, case.cfg, "cpu")
    got, want = _params_and_moments(case.state1), _params_and_moments(ported)
    assert got.keys() == want.keys()
    grads = {k: 2 * v[1] for k, v in want.items()}
    got_grads = {k: 2 * v[1] for k, v in got.items()}
    check_grads_end_to_end(got_grads, grads, f"step {size}", STEP_GRAD_TOL[size])
    case.noise = noise_tensors(grads)
    flips = total = 0
    case.sure_worst = 0.0
    for key, (p, _, _) in got.items():
        diff = (p - want[key][0]).abs()
        if key not in case.noise:
            g, got_g = grads[key], got_grads[key]
            sure = adam_sure(g, got_g, LR)
            assert (diff[sure] <= 1e-6).all(), (key, "params", diff[sure].max())
            case.sure_worst = max(case.sure_worst, diff[sure].max().item() if sure.any() else 0.0)
            big = g.abs() > 1e-3 * g.abs().max()
            flips += (big & (torch.sign(g) != torch.sign(got_g))).sum().item()
            total += big.sum().item()
        assert diff.max() <= 2 * LR + 1e-6, (key, "params")
    case.flips = (flips, total)
    assert flips <= STEP_FLIP_TOL[size] * total, (flips, total)
    for name, module in case.state1.models.items():
        wsd = getattr(ported.models, name).state_dict()
        for key, v in module.state_dict().items():
            if key.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
                err = (v - wsd[key]).abs().max().item()
                assert err <= 1e-5 * max(1.0, wsd[key].abs().max().item()), (name, key, err)
    assert case.state1.step == 1 and ported.step == 1


def check_step_grads_against_f64(case):
    """The port's f32 step gradients within `STEP_F64_TOL` of its own f64
    step's (relative L2); returns the worst (ratio, name)."""
    return check_grads_end_to_end({k: v[1].double() * 2 for k, v in
                                   _params_and_moments(case.state1).items()},
                                  case.f64_grads(), "f32 against f64", STEP_F64_TOL)[0]


def check_second_step(case):
    """A second step from JAX's state after step 1, carried into the port
    by `train_state_from_jax` (params, statistics, Adam's moments and
    count). The step-2 gradients (2 (m2 - m1 / 2), from the moments) within
    `STEP_GRAD_TOL` of JAX's. Every param within 1e-5 of JAX's after it
    wherever the two step-2 gradients have the same sign and |.| above 1e-3
    of their tensor's max; at 128^2 only in the tensors whose step-2
    gradients are within `STEP_GRAD_TOL[64]` of JAX's (there
    JAX's own f32 gradients are a few % from exact, and the second step,
    unlike the first, moves a param by an amount that depends on its
    gradient's value). Within 2 lr everywhere (a step-2 gradient whose
    sign flips moves a param by about 2 lr). The rounding-noise tensors of
    step 1 are left out of the 1e-5."""
    from aglayout_tpu_torch.utils.jax_import import train_state_from_jax

    size = case.cfg.image_size
    ported = train_state_from_jax(case.js1, case.cfg, "cpu")
    m1 = {k: v[1].clone() for k, v in _params_and_moments(ported).items()}
    state2, _ = case.port_step(ported, case.draws(case.js1))
    js2, _ = case.jstep(case.js1, case.jbatch)
    got = _params_and_moments(state2)
    want = _params_and_moments(train_state_from_jax(js2, case.cfg, "cpu"))
    g2 = {k: 2 * (v[1] - m1[k] / 2) for k, v in got.items()}
    wg2 = {k: 2 * (v[1] - m1[k] / 2) for k, v in want.items()}
    noise = noise_tensors({k: 2 * v for k, v in m1.items()})
    check_grads_end_to_end(g2, wg2, f"second step {size}", STEP_GRAD_TOL[size])
    rel = grad_l2(g2, wg2, noise)
    worst, checked = (0.0, ""), 0
    for key, (p, _, _) in got.items():
        diff = (p - want[key][0]).abs()
        assert diff.max() <= 2 * LR + 1e-6, (key, diff.max())
        if key in noise or (size != 64 and rel[key] > STEP_GRAD_TOL[64]):
            continue
        g, wg = g2[key], wg2[key]
        same = (torch.sign(g) == torch.sign(wg)) & (wg.abs() > 1e-3 * wg.abs().max())
        assert (diff[same] <= 1e-5).all(), (key, diff[same].max())
        worst = max(worst, (diff[same].max().item() if same.any() else 0.0, key))
        checked += 1
    case.second_step_worst = worst + (checked, len(got))
