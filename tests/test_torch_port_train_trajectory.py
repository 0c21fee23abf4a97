"""Eight train steps of the port against JAX's, at 64^2 here and at 128^2
in test_torch_port_train_trajectory128.py (`bench.TRAIN_SMALL` widths,
B=3, O=3, f32, on the CPU), from the port's fresh state
(`create_train_state(cfg, "cpu", seed=0)`, BNs at JAX's fresh values)
carried into JAX by the JAX package's importers (`jax_train_state`, as
the one- and two-step tests carry it; JAX's own eager init would cost
about 45 s a size with a cold compile cache), over the first batches of
`train_evidence`'s corpus (`synthetic_scene_batch(RandomState(7))`), each
step's draws taken from JAX's `state.rng` (`jax_step_draws`). Both
packages start from the same weights and draw the same noise, so what is
left is how their steps compute.

Each step's G/rec_img, G/loss and D/loss:

  * within `TOL_FIRST` = 1e-3 of JAX's, relatively, over the first
    `FIRST` steps;
  * within `TOL` = 5e-2 over all eight. From the third step on the two
    f32 trajectories part by more than 1e-3: each step's gradients carry
    f32 rounding (1e-3 of JAX's at 64^2, 4e-2 at 128^2 after one step,
    `STEP_GRAD_TOL`), Adam turns a small gradient of either sign into a
    step of about lr, and the GAN's next losses amplify it. Measured on
    this test's inputs: at most 2.0e-2 (64^2) and 1.3e-2 (128^2) by step 8;
  * at 64^2, no farther from JAX's than twice the distance of JAX's own
    f32 trajectory from the port's step carried out in f64 from the same
    start (the referee of both f32 steps; 1.7e-2 at most), the largest
    over the eight steps: the port is as close to JAX as JAX is to the exact trajectory.
    Not over fewer steps: each trajectory's distance from another jumps
    from step to step (here 1.2e-3 and 1.6e-4 at step 4, 1.9e-4 and 1.5e-2
    at step 7).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tests.torch_port_common import (
    jax_eps,
    jax_step_draws,
    jax_train_state,
    torch_draws,
    train_configs,
)

torch.set_num_threads(1)
STEPS, FIRST = 8, 2
TOL_FIRST, TOL = 1e-3, 5e-2
KEYS = ("G/rec_img", "G/loss", "D/loss")


def _double(state):
    """The port state `state` in f64 in place: nets and Adam moments."""
    for name, module in state.models.items():
        module.double()
        for st in state.opt[name].state.values():
            st["exp_avg"], st["exp_avg_sq"] = st["exp_avg"].double(), st["exp_avg_sq"].double()
    return state


def trajectories(size: int, f64: bool):
    """(port f32, JAX, port f64 or None) metrics of `STEPS` steps: each a
    list of {key: value} a step."""
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.train.step import make_train_step as jax_make_train_step
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.tools.train_evidence import scene_corpus
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    cfg, jcfg = train_configs(size)
    corpus, matrix = scene_corpus(cfg, STEPS)
    pos_weight = np.ones(cfg.attribute_dim, np.float32)  # as train_evidence below 106 attributes
    state = create_train_state(cfg, "cpu", seed=0)
    jmodels, js = jax_train_state(state.models, jcfg)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodels, matrix, pos_weight))
    eps_fn = jax.jit(functools.partial(jax_eps, jmodels))
    step = make_train_step(cfg, state.models, matrix, pos_weight)
    if f64:
        state64 = _double(create_train_state(cfg, "cpu", seed=0))
        step64 = make_train_step(cfg, state64.models, matrix, pos_weight)

    def cast(t):
        return t.double() if t.is_floating_point() else t

    port, jax_rows, port64 = [], [], [] if f64 else None
    for b in corpus:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        draws = torch_draws(jax_step_draws(js, jmodels, jcfg, jb, matrix, eps_fn))
        js, jm = jstep(js, jb)
        tb = batch_to_torch(b, "cpu")
        state, m = step(state, tb, draws=draws)
        port.append({k: float(m[k]) for k in KEYS})
        jax_rows.append({k: float(jm[k]) for k in KEYS})
        if f64:
            d64 = {k: tuple(map(cast, v)) if k == "swap" else cast(v) for k, v in draws.items()}
            state64, m64 = step64(state64, {k: cast(v) for k, v in tb.items()}, draws=d64)
            port64.append({k: float(m64[k]) for k in KEYS})
    return port, jax_rows, port64


def _rel(got, want):
    return [{k: abs(g[k] - w[k]) / abs(w[k]) for k in KEYS} for g, w in zip(got, want)]


def check_trajectory(size: int):
    """The bounds of the module's docstring at `size`."""
    port, jax_rows, port64 = trajectories(size, f64=size == 64)
    assert all(np.isfinite(list(r.values())).all() for r in port)
    rel = _rel(port, jax_rows)
    for i, r in enumerate(rel):
        for k, v in r.items():
            tol = TOL_FIRST if i < FIRST else TOL
            assert v <= tol, f"step {i + 1} {k}: {port[i][k]} against JAX's {jax_rows[i][k]}"
    if port64 is not None:
        referee = _rel(jax_rows, port64)
        for k in KEYS:
            worst = max(r[k] for r in rel)
            assert worst <= 2 * max(r[k] for r in referee), (k, worst, referee)


@pytest.mark.parametrize("size", [64])
def test_train_trajectory_matches_jax(size):
    check_trajectory(size)
