"""One GAN train step of the port against the JAX package's, on the CPU, at
128^2 (object crops 64^2, the attribute D's extra block) and small widths
(`bench.TRAIN_SMALL`), f32, from the same weights, batch and draws:
the metrics and image grids, every net's gradients, running statistics,
spectral-norm vectors and params after it, the gradients against the
port's own f64 step, and a second step from JAX's state after the first
carried into the port by `train_state_from_jax`.
"""

from __future__ import annotations

import pytest
import torch

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
    return StepCase(128)


def test_step_metrics_match_jax_128(case):
    check_step_metrics(case)


def test_step_grads_params_and_stats_match_jax_128(case):
    check_step_grads_params_stats(case)


def test_step_grads_match_the_ports_f64_128(case):
    check_step_grads_against_f64(case)


def test_second_step_from_jax_state_matches_jax_128(case):
    check_second_step(case)
