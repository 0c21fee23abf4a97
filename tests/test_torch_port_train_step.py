"""One GAN train step of the port against the JAX package's, on the CPU, at
64^2 and small widths (`bench.TRAIN_SMALL`: `torch_port_common.SMALL`,
d_conv_dim 8, B=3, O=3), f32, from the same weights, batch and draws: the
metrics and image grids, every net's gradients, running statistics, spectral-norm
vectors and params after it, the gradients against the port's own f64
step, and a second step from JAX's state after the first carried into the
port by `train_state_from_jax`. Then, in the port alone, `remat` and
`double_g_forward` against the plain step.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from aglayout_tpu_torch.models.norms import MaskedBatchNorm
from tests.torch_port_common import (
    StepCase,
    check_second_step,
    check_step_grads_against_f64,
    check_step_grads_params_stats,
    check_step_metrics,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    return StepCase(64)


def test_step_metrics_match_jax(case):
    check_step_metrics(case)


def test_step_grads_params_and_stats_match_jax(case):
    check_step_grads_params_stats(case)


def test_step_grads_match_the_ports_f64(case):
    check_step_grads_against_f64(case)


def test_second_step_from_jax_state_matches_jax(case):
    check_second_step(case)


def _same_state(a, b):
    for (name, ma), (_, mb) in zip(a.models.items(), b.models.items()):
        for (key, va), vb in zip(ma.state_dict().items(), mb.state_dict().values()):
            assert torch.equal(va, vb), (name, key)


def test_remat_step_equals_plain(case):
    """Recomputed in the backward, the generator forward gives the same
    gradients, and its BNs' running statistics are those of one forward."""
    cfg = dataclasses.replace(case.cfg, remat=True)
    state, metrics = case.port_step(case.fresh(), case.draws1, cfg)
    _same_state(state, case.state1)
    for k, v in metrics.items():
        if k != "images":
            assert torch.equal(v, case.metrics[k]), k


def test_double_g_forward_equals_plain_with_the_same_eps(case):
    """With the second draw equal to the first, the second forward computes
    the same outputs (batch statistics), so the losses and params are the
    plain step's; the running statistics advance twice: k updates a
    forward, each r <- 0.9 r + 0.1 s, make r2 = (1 + 0.9^k) r1 - 0.9^k r0."""
    cfg = dataclasses.replace(case.cfg, double_g_forward=True)
    state, metrics = case.port_step(case.fresh(), dict(case.draws1, eps_g=case.draws1["eps"]), cfg)
    for k, v in metrics.items():
        if k != "images":
            assert torch.allclose(v, case.metrics[k], rtol=1e-6, atol=0), k
    for (p, q) in zip(state.models.g.parameters(), case.state1.models.g.parameters()):
        assert torch.allclose(p, q, rtol=0, atol=1e-7)
    fresh = dict(case.fresh().models.g.named_modules())
    plain = dict(case.state1.models.g.named_modules())
    for name, bn in state.models.g.named_modules():
        if isinstance(bn, MaskedBatchNorm):
            k = int(plain[name].num_batches_tracked)
            assert k >= 1 and int(bn.num_batches_tracked) == 2 * k, name
            for stat in ("running_mean", "running_var"):
                r0, r1 = getattr(fresh[name], stat), getattr(plain[name], stat)
                want = (1 + 0.9 ** k) * r1 - 0.9 ** k * r0
                assert torch.allclose(getattr(bn, stat), want, rtol=1e-5, atol=1e-6), (name, stat)


def test_step_refuses_int8_serving(case):
    with pytest.raises(ValueError, match="int8_serving"):
        case.make_step(dataclasses.replace(case.cfg, int8_serving=True), case.fresh().models)


def test_param_count_matches_jax(case):
    from aglayout_tpu.train.state import param_count as jax_param_count
    from aglayout_tpu_torch.train.state import param_count

    assert param_count(case.fresh()) == jax_param_count(case.js0)
