"""test_torch_port_train_trajectory.py's eight steps at 128^2 (object_size
64, the attribute D's extra block, the decoder's c5-c7 tail), in a file of
their own so that each file stays near 50 s."""

import pytest

from tests.test_torch_port_train_trajectory import check_trajectory


@pytest.mark.parametrize("size", [128])
def test_train_trajectory_matches_jax(size):
    check_trajectory(size)
