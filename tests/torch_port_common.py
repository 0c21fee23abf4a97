"""Shared set-up of the `test_torch_port_*` files: a small 64^2 or 128^2
generator in both packages with the same weights, and seeded layouts. Inputs come
from numpy and pass between the two packages as numpy arrays.

The weights are drawn once, in the port (`init_weights`: torch's default
initialisers, non-trivial BN running statistics and affines), and carried
into the JAX trees by the JAX package's own importer, `import_generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from aglayout_tpu.models.generator import Generator
from aglayout_tpu.models.norms import SPADE as JaxSPADE
from aglayout_tpu.utils.torch_import import _TreeBuilder, import_generator
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
    return t.float().permute(0, 2, 3, 1).numpy()


def compact_tables_to_jax_flat(t):
    """The port's compact SPADE table (B, H/f, 5, C, 5 W/f) -> the layout of
    JAX's `SPADE.folded_affine_tables_compact_flat`, (B, 5 W/f, H/f, 5, C):
    a TPU lane layout the port does not carry."""
    return t.permute(0, 4, 1, 2, 3)
