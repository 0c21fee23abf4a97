"""Weight bridge: JAX generator trees -> this package's `state_dict`.

The inverse of `aglayout_tpu/utils/torch_import.py::import_generator`: it
takes the JAX (params, batch_stats) trees as numpy arrays (or anything
`np.asarray` reads) and returns a `state_dict` keyed by the reference's
netG names, which `Generator.load_state_dict` takes as it is. Layouts:

  * Conv2d   HWIO -> (O, I, kh, kw)
  * ConvT2d  flipped forward-conv HWIO -> (I, O, kh, kw), spatially flipped back
  * Linear   (in, out) -> (out, in)
  * BatchNorm scale/bias -> weight/bias; mean/var -> running_mean/running_var
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


class _StateBuilder:
    def __init__(self, params, stats):
        self.params = params
        self.stats = stats
        self.sd: dict = {}

    @staticmethod
    def _get(tree, path):
        for p in path:
            tree = tree[p]
        return np.asarray(tree, np.float32)

    def conv(self, tkey, mpath, bias=True):
        k = self._get(self.params, mpath + ("kernel",))
        self.sd[tkey + ".weight"] = _tensor(np.transpose(k, (3, 2, 0, 1)))
        if bias:
            self.sd[tkey + ".bias"] = _tensor(self._get(self.params, mpath + ("bias",)))

    def convt(self, tkey, mpath):
        k = self._get(self.params, mpath + ("kernel",))
        self.sd[tkey + ".weight"] = _tensor(np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])

    def linear(self, tkey, mpath):
        self.sd[tkey + ".weight"] = _tensor(self._get(self.params, mpath + ("kernel",)).T)
        self.sd[tkey + ".bias"] = _tensor(self._get(self.params, mpath + ("bias",)))

    def embed(self, tkey, mpath):
        self.sd[tkey + ".weight"] = _tensor(self._get(self.params, mpath + ("embedding",)))

    def bn(self, tkey, mpath, affine=True):
        if affine:
            self.sd[tkey + ".weight"] = _tensor(self._get(self.params, mpath + ("scale",)))
            self.sd[tkey + ".bias"] = _tensor(self._get(self.params, mpath + ("bias",)))
        self.sd[tkey + ".running_mean"] = _tensor(self._get(self.stats, mpath + ("mean",)))
        self.sd[tkey + ".running_var"] = _tensor(self._get(self.stats, mpath + ("var",)))
        self.sd[tkey + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def cbn(self, tkey, mpath):
        self.bn(tkey + ".bn", mpath + ("bn",), affine=False)
        self.embed(tkey + ".embed", mpath + ("embed",))

    def spade(self, tkey, mpath):
        self.bn(tkey + ".param_free_norm", mpath + ("param_free_norm",), affine=False)
        self.conv(tkey + ".mlp_shared.0", mpath + ("mlp_shared",))
        self.conv(tkey + ".mlp_gamma", mpath + ("mlp_gamma",))
        self.conv(tkey + ".mlp_beta", mpath + ("mlp_beta",))


def generator_state_dict_from_jax(params, batch_stats, image_size: int = 64,
                                  clstm_layers: int = 3, resi_num: int = 6) -> dict:
    """JAX Generator (params, batch_stats) -> netG `state_dict` of tensors."""
    t = _StateBuilder(params, batch_stats)

    ce = ("crop_encoder",)
    for i, tname in enumerate(["c1", "c2", "c3", "c4", "conv5"]):
        t.conv(f"crop_encoder.{tname}", ce + (f"c{i + 1}",), bias=False)
        t.cbn(f"crop_encoder.bn{i + 1}", ce + (f"bn{i + 1}",))
    t.linear("crop_encoder.fc_mu", ce + ("fc_mu",))
    t.linear("crop_encoder.fc_logvar", ce + ("fc_logvar",))

    le = ("layout_encoder",)
    for conv, bn in [("c0", "bn1"), ("c2", "bn2"), ("c3", "bn3"), ("c4", "bn4")]:
        t.conv(f"layout_encoder.{conv}", le + (conv,), bias=False)
        t.cbn(f"layout_encoder.{bn}", le + (bn,))
    for i in range(clstm_layers):
        t.conv(f"layout_encoder.clstm.cell_list.{i}.conv",
               le + ("clstm", "step", f"cell_{i}", "conv"))
    for i in range(resi_num):
        base = f"layout_encoder.residual.{i}.main"
        t.conv(f"{base}.0", le + (f"residual_{i}", "c1"), bias=False)
        t.bn(f"{base}.1", le + (f"residual_{i}", "bn1"))
        t.conv(f"{base}.3", le + (f"residual_{i}", "c2"), bias=False)
        t.bn(f"{base}.4", le + (f"residual_{i}", "bn2"))

    t.conv("global_encoder.c1", ("global_encoder", "c1"), bias=False)
    t.bn("global_encoder.bn1", ("global_encoder", "bn1"))
    t.conv("global_encoder.c2", ("global_encoder", "c2"), bias=False)

    de = ("decoder",)
    t.conv("decoder.c0_new", de + ("c0_new",), bias=False)
    for i in range(4):
        t.spade(f"decoder.spade_{i}", de + (f"spade_{i}",))
    for i in range(1, 4):
        t.convt(f"decoder.dc{i}", de + (f"dc{i}",))
    t.conv("decoder.c4", de + ("c4",), bias=True)
    if image_size == 128:
        t.conv("decoder.c5", de + ("c5",), bias=False)
        t.spade("decoder.spade_4", de + ("spade_4",))
        t.conv("decoder.c6", de + ("c6",), bias=False)
        t.spade("decoder.spade_5", de + ("spade_5",))
        t.conv("decoder.c7", de + ("c7",), bias=True)

    ae = ("attribute_encoder",)
    t.embed("attribute_encoder.embedding", ae + ("embedding",))
    t.linear("attribute_encoder.c0", ae + ("c0",))
    t.bn("attribute_encoder.bn0", ae + ("bn0",))
    t.linear("attribute_encoder.c1", ae + ("c1",))
    t.bn("attribute_encoder.bn1", ae + ("bn1",))
    t.linear("attribute_encoder.c2", ae + ("c2",))
    return t.sd
