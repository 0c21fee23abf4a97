"""Weight bridge: JAX generator, discriminator and ResNet-50 trees -> this
package's `state_dict`s, and a JAX train state -> the port's
(`train_state_from_jax`).

The inverse of `aglayout_tpu/utils/torch_import.py::import_generator` and
`import_*_discriminator`: it takes the JAX (params, batch_stats) trees as
numpy arrays (or anything `np.asarray` reads) and returns a `state_dict`
keyed by the reference's netG / netD_* names, which the port's modules'
`load_state_dict` takes as it is. Layouts:

  * Conv2d   HWIO -> (O, I, kh, kw)
  * ConvT2d  flipped forward-conv HWIO -> (I, O, kh, kw), spatially flipped back
  * Linear   (in, out) -> (out, in)
  * BatchNorm scale/bias -> weight/bias; mean/var -> running_mean/running_var
  * spectral norm: kernel -> weight_orig (as a conv's or a linear's);
    batch_stats .../sn/{u,v} -> weight_u/weight_v
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

    def conv(self, tkey, mpath, bias=True, weight="weight"):
        k = self._get(self.params, mpath + ("kernel",))
        self.sd[f"{tkey}.{weight}"] = _tensor(np.transpose(k, (3, 2, 0, 1)))
        if bias:
            self.sd[tkey + ".bias"] = _tensor(self._get(self.params, mpath + ("bias",)))

    def convt(self, tkey, mpath):
        k = self._get(self.params, mpath + ("kernel",))
        self.sd[tkey + ".weight"] = _tensor(np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])

    def linear(self, tkey, mpath, bias=True, weight="weight"):
        self.sd[f"{tkey}.{weight}"] = _tensor(self._get(self.params, mpath + ("kernel",)).T)
        if bias:
            self.sd[tkey + ".bias"] = _tensor(self._get(self.params, mpath + ("bias",)))

    def _sn_state(self, tkey, mpath):
        self.sd[tkey + ".weight_u"] = _tensor(self._get(self.stats, mpath + ("sn", "u")))
        self.sd[tkey + ".weight_v"] = _tensor(self._get(self.stats, mpath + ("sn", "v")))

    def sn_conv(self, tkey, mpath):
        self.conv(tkey, mpath, weight="weight_orig")
        self._sn_state(tkey, mpath)

    def sn_linear(self, tkey, mpath, bias=True):
        self.linear(tkey, mpath, bias, weight="weight_orig")
        self._sn_state(tkey, mpath)

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


def _d_trunk(t: _StateBuilder, num_blocks: int) -> None:
    """main.0 OptimizedBlock and main.1.. DResidualBlocks; `sc` where the tree has it."""
    for i in range(num_blocks):
        convs = ("0", "2") if i == 0 else ("1", "3")
        for name, conv in zip(convs, ("conv1", "conv2")):
            t.sn_conv(f"main.{i}.resi.{name}", (f"block{i}", conv))
        if "sc" in t.params[f"block{i}"]:
            t.sn_conv(f"main.{i}.sc", (f"block{i}", "sc"))


def image_discriminator_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX ImageDiscriminator (params, batch_stats) -> netD_image `state_dict`."""
    t = _StateBuilder(params, batch_stats)
    _d_trunk(t, 5)
    t.sn_linear("classifier", ("classifier",), bias=False)
    return t.sd


def object_discriminator_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX ObjectDiscriminator (params, batch_stats) -> netD_object `state_dict`."""
    t = _StateBuilder(params, batch_stats)
    _d_trunk(t, 5)
    t.sn_linear("classifier_src", ("classifier_src",))
    t.sn_linear("classifier_cls", ("classifier_cls",))
    return t.sd


def attribute_discriminator_state_dict_from_jax(params, batch_stats,
                                                extra_block: bool = False) -> dict:
    """JAX AttributeDiscriminator (params, batch_stats) -> netD_attribute
    `state_dict`; six blocks with `extra_block`."""
    t = _StateBuilder(params, batch_stats)
    _d_trunk(t, 6 if extra_block else 5)
    t.sn_linear("classifier_att", ("classifier_att",))
    return t.sd


def resnet_state_dict_from_jax(params, batch_stats, stage_sizes=(3, 4, 6, 3)) -> dict:
    """JAX `eval/resnet.ResNet50` (params, batch_stats) -> the port's
    `eval/resnet.ResNet50` `state_dict` (torchvision's keys): flax's
    Conv_0/BatchNorm_0 stem, Bottleneck_k (Conv_0-2, BatchNorm_0-2, the
    projection Conv_3/BatchNorm_3) counted across the stages, Dense_0."""
    t = _StateBuilder(params, batch_stats)
    t.conv("conv1", ("Conv_0",), bias=False)
    t.bn("bn1", ("BatchNorm_0",))
    k = 0
    for i, count in enumerate(stage_sizes):
        for j in range(count):
            src, dst = f"Bottleneck_{k}", f"layer{i + 1}.{j}"
            for n in range(3):
                t.conv(f"{dst}.conv{n + 1}", (src, f"Conv_{n}"), bias=False)
                t.bn(f"{dst}.bn{n + 1}", (src, f"BatchNorm_{n}"))
            if "Conv_3" in params[src]:
                t.conv(f"{dst}.downsample.0", (src, "Conv_3"), bias=False)
                t.bn(f"{dst}.downsample.1", (src, "BatchNorm_3"))
            k += 1
    t.linear("fc", ("Dense_0",))
    return t.sd


def _adam_moments(opt):
    """(count, mu, nu) of an optax Adam state (the `ScaleByAdamState` in
    the chain's tuple)."""
    adam = next(s for s in opt if hasattr(s, "mu"))
    return int(np.asarray(adam.count)), adam.mu, adam.nu


def train_state_from_jax(jax_state, cfg, device):
    """A JAX `TrainState` -> the port's (`train/state.py`) for `cfg`, on
    `device`: each net's params and statistics through its
    `*_state_dict_from_jax`, optax Adam's mu, nu and count into its
    `torch.optim.Adam`'s exp_avg, exp_avg_sq and step (the moments through
    the params' own layout conversion, which is linear), and the step
    counter. The draws' generator is the port's own: a JAX key has no
    counterpart."""
    from aglayout_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, device, seed=cfg.seed)
    to_sd = {
        "g": lambda p, s: generator_state_dict_from_jax(p, s, cfg.image_size, cfg.clstm_layers,
                                                        cfg.resi_num),
        "d_image": image_discriminator_state_dict_from_jax,
        "d_object": object_discriminator_state_dict_from_jax,
        "d_att": lambda p, s: attribute_discriminator_state_dict_from_jax(
            p, s, extra_block=cfg.image_size == 128),
    }
    for name, module in state.models.items():
        net = getattr(jax_state, name)
        module.load_state_dict(to_sd[name](net.params, net.stats))
        count, mu, nu = _adam_moments(net.opt)
        mu_sd, nu_sd = to_sd[name](mu, net.stats), to_sd[name](nu, net.stats)
        opt = state.opt[name]
        for key, p in module.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": mu_sd[key].to(device),
                            "exp_avg_sq": nu_sd[key].to(device)}
    state.step = int(np.asarray(jax_state.step))
    return state
