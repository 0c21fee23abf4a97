"""The PyTorch port imports no JAX, and its weight bridge inverts the JAX
package's importer exactly."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aglayout_tpu.models.generator import CropEncoder, Generator
from aglayout_tpu.utils.torch_import import import_generator
from aglayout_tpu_torch.models.generator import Generator as TorchGenerator
from aglayout_tpu_torch.utils.jax_import import generator_state_dict_from_jax
from torch_port_common import NUM_CLASSES, SMALL, layouts

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import aglayout_tpu_torch\n"
        "for m in pkgutil.walk_packages(aglayout_tpu_torch.__path__, 'aglayout_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'aglayout_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _random_jax_trees(cfg, seed):
    """(params, batch_stats) of a JAX Generator, shapes from an abstract
    init, values from numpy."""
    model = Generator(num_classes=NUM_CLASSES, image_size=64, object_size=32, **cfg)
    ins = [jnp.asarray(a) for a in layouts(2, 3, cfg["z_dim"], cfg["attribute_dim"])]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(key, *ins, None, False, method=Generator.generate))
    crop = jax.eval_shape(lambda: CropEncoder(NUM_CLASSES, cfg["z_dim"], conv_dim=cfg["conv_dim"]).init(
        {"params": key, "reparam": key},
        jnp.zeros((2, 32, 32, 3)), jnp.zeros((2,), jnp.int32), jnp.ones((2,)), True,
    ))
    rng = np.random.RandomState(seed)
    fill = lambda s: rng.randn(*s.shape).astype(np.float32)  # noqa: E731
    trees = []
    for col in ("params", "batch_stats"):
        tree = jax.tree_util.tree_map(fill, dict(shapes[col], crop_encoder=crop[col]))
        trees.append(tree)
    return trees


@pytest.mark.parametrize("clstm_layers,resi_num", [(2, 1), (3, 2)])
def test_bridge_round_trip(clstm_layers, resi_num):
    """JAX trees -> port state_dict -> import_generator gives the trees back
    bit for bit, and the state_dict loads strictly into the port."""
    cfg = dict(SMALL, clstm_layers=clstm_layers, resi_num=resi_num)
    params, stats = _random_jax_trees(cfg, seed=resi_num)
    sd = generator_state_dict_from_jax(params, stats, clstm_layers=clstm_layers, resi_num=resi_num)
    TorchGenerator(num_classes=NUM_CLASSES, **cfg).load_state_dict(sd, strict=True)

    params2, stats2 = import_generator(
        {k: v.numpy() for k, v in sd.items()}, clstm_layers=clstm_layers, resi_num=resi_num
    )
    for want, got in ((params, params2), (stats, stats2)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(a, b)  # exact: transposes and flips only
