"""The port's c7 RGB head at 128^2 (K3 `spade_few_out_conv8`) against the
JAX kernel it replaces: on the CPU the wrapper takes its plain PyTorch
version, held here against the JAX Pallas kernel in interpret mode at the
shapes of the JAX package's own kernel test. The CUDA kernel is held
against the plain version on the card (`test_torch_port_gpu.py` and
`chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.ops.pallas_spade_conv import spade_few_out_conv8 as jax_spade_few_out_conv8
from aglayout_tpu_torch.ops.spade_conv import spade_few_out_conv8
from torch_port_common import nchw, nhwc, spade_pair

torch.set_num_threads(1)


def _head_inputs(b, hs, c, f, k, seed):
    spade, jspade, variables = spade_pair(c, 64, seed)
    rng = np.random.RandomState(seed)
    seg = rng.randn(b, hs, hs, 64).astype(np.float32)
    x = rng.randn(b, hs * f, hs * f, c).astype(np.float32)
    kern = (0.1 * rng.randn(k, k, c, 3)).astype(np.float32)  # JAX HWIO
    bias = rng.randn(3).astype(np.float32)
    return spade, jspade, variables, seg, x, kern, bias


# the first and third shapes of tests/test_pallas_spade_conv.py::test_head8_matches_dense
@pytest.mark.parametrize("b,H,C,hs,K", [(8, 64, 128, 8, 7), (16, 64, 128, 4, 5)])
def test_head8_plain_matches_jax_kernel(b, H, C, hs, K):
    """The port's plain c7 head == spade_few_out_conv8(interpret=True),
    each fed its own package's compact tables, f32."""
    f = H // hs
    spade, jspade, variables, seg, x, kern, bias = _head_inputs(b, hs, C, f, K, seed=3)
    ja, jb = jspade.apply(variables, jnp.asarray(seg), f,
                          method=JaxSPADE.folded_affine_tables_compact)
    want = jax_spade_few_out_conv8(jnp.transpose(jnp.asarray(x), (1, 2, 0, 3)), ja, jb,
                                   jnp.asarray(kern), jnp.asarray(bias), f=f, interpret=True)
    with torch.no_grad():
        ta, tb = spade.folded_affine_tables_compact(nchw(seg))
        weight = torch.from_numpy(kern).permute(3, 2, 0, 1)
        got = spade_few_out_conv8(nchw(x), ta, tb, weight, torch.from_numpy(bias), f)
    assert got.shape == (b, 3, H, H)
    # f32; kn2row matmul vs direct conv: re-association of a C*K*K-term sum
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=5e-4, rtol=1e-4)
