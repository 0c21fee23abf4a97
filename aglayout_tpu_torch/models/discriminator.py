"""SNGAN-style discriminators with spectral normalisation, NCHW.

Port of `aglayout_tpu/models/discriminator.py`. Module and parameter names
follow the reference's `models/discriminator.py`, as
`aglayout_tpu/utils/torch_import.py` reads them, so its `state_dict`s load
as they are:

  * `ImageDiscriminator`: `main.0` an `OptimizedBlock` (downsampling),
    `main.1..4` `DResidualBlock`s to 16 d channels, relu, a spatial sum and
    `classifier` (no bias): one logit an image, (N,);
  * `ObjectDiscriminator`: the same trunk with a `main.0` that keeps the
    size, `classifier_src` (N,) and `classifier_cls` (N, n_class);
  * `AttributeDiscriminator`: that trunk, one more downsampling block
    `main.5` with `extra_block` (the reference's AttributeDiscriminator128,
    64^2 crops), and `classifier_att` (N, n_attribute).

Every conv and linear is an `SNConv2d` / `SNLinear` (`models/sn.py`);
`update_stats` reaches each of them. The convs are `F.conv2d`, as the JAX
package leaves them to XLA: no kernel of this package runs here.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from aglayout_tpu_torch.config import Config
from aglayout_tpu_torch.models.generator import init_weights
from aglayout_tpu_torch.models.sn import SNConv2d, SNLinear


def avg_pool2(x):
    """2x2 average pool, stride 2, of (N, C, H, W) with H and W even, as a
    reshape and a mean: F.avg_pool2d(x, 2) up to the order of the four
    terms' sum, and a backward that is an expand, where avg_pool2d's was the
    train step's heaviest kernel."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean((3, 5))


class OptimizedBlock(nn.Module):
    """conv-relu-conv(-pool) + (pool-)1x1 shortcut; keys `resi.0`,
    `resi.2`, `sc` (reference models/discriminator.py:29-60). The shortcut
    conv exists where the block downsamples or changes the width, and
    follows the pool."""

    def __init__(self, in_channels: int, features: int, downsample: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.downsample = downsample
        self.resi = nn.ModuleDict({
            "0": SNConv2d(in_channels, features, 3, padding=1, dtype=dtype),
            "2": SNConv2d(features, features, 3, padding=1, dtype=dtype),
        })
        self.sc = (SNConv2d(in_channels, features, 1, dtype=dtype)
                   if downsample or in_channels != features else None)

    def forward(self, x, update_stats: bool = True):
        h = self.resi["2"](torch.relu(self.resi["0"](x, update_stats)), update_stats)
        s = x
        if self.downsample:
            h, s = avg_pool2(h), avg_pool2(s)
        if self.sc is not None:
            s = self.sc(s, update_stats)
        return h + s


class DResidualBlock(nn.Module):
    """Pre-activation block: relu-conv-relu-conv(-pool) + sc(relu(x))(-pool);
    keys `resi.1`, `resi.3`, `sc` (reference models/discriminator.py:63-99).
    The shortcut reads relu(x), the shared pre-activation: the reference's
    leading `ReLU(inplace=True)` rewrites x before its shortcut reads it.
    Here relu(x) is computed once, out of place, and feeds both branches.
    The shortcut conv precedes the pool."""

    def __init__(self, in_channels: int, features: int, downsample: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.downsample = downsample
        self.resi = nn.ModuleDict({
            "1": SNConv2d(in_channels, in_channels, 3, padding=1, dtype=dtype),
            "3": SNConv2d(in_channels, features, 3, padding=1, dtype=dtype),
        })
        self.sc = (SNConv2d(in_channels, features, 1, dtype=dtype)
                   if downsample or in_channels != features else None)

    def forward(self, x, update_stats: bool = True):
        y = torch.relu(x)
        h = self.resi["3"](torch.relu(self.resi["1"](y, update_stats)), update_stats)
        s = y if self.sc is None else self.sc(y, update_stats)
        if self.downsample:
            h, s = avg_pool2(h), avg_pool2(s)
        return h + s


def _trunk(d: int, first_downsamples: bool, extra_block: bool, dtype):
    """main.0 (3 -> d) and the downsampling blocks to 16 d channels (and one
    more at 16 d with `extra_block`)."""
    widths = [d, 2 * d, 4 * d, 8 * d, 16 * d] + ([16 * d] if extra_block else [])
    blocks = [OptimizedBlock(3, d, first_downsamples, dtype)]
    blocks += [DResidualBlock(cin, cout, True, dtype) for cin, cout in zip(widths, widths[1:])]
    return nn.ModuleList(blocks)


def _features(main, x, update_stats: bool):
    """The trunk, relu, and the sum over the spatial dims: (N, 16 d)."""
    h = x
    for block in main:
        h = block(h, update_stats)
    return torch.relu(h).sum(dim=(2, 3))


class ImageDiscriminator(nn.Module):
    """Whole-image real/fake discriminator (reference :184-230)."""

    def __init__(self, conv_dim: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        self.main = _trunk(conv_dim, True, False, dtype)
        self.classifier = SNLinear(16 * conv_dim, 1, bias=False, dtype=dtype)

    def forward(self, x, update_stats: bool = True):
        """x (N, 3, H, W) -> logits (N,)."""
        return self.classifier(_features(self.main, x, update_stats), update_stats)[:, 0]


class ObjectDiscriminator(nn.Module):
    """Object-crop discriminator with an auxiliary class head (reference :233-278)."""

    def __init__(self, n_class: int, conv_dim: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        self.main = _trunk(conv_dim, False, False, dtype)
        self.classifier_src = SNLinear(16 * conv_dim, 1, dtype=dtype)
        self.classifier_cls = SNLinear(16 * conv_dim, n_class, dtype=dtype)

    def forward(self, x, update_stats: bool = True):
        """x (N, 3, h, w) crops -> (real/fake logits (N,), class logits (N, n_class))."""
        h = _features(self.main, x, update_stats)
        return self.classifier_src(h, update_stats)[:, 0], self.classifier_cls(h, update_stats)


class AttributeDiscriminator(nn.Module):
    """Attribute classifier on object crops: the reference's
    AttributeDiscriminator (:144-181, 32^2 crops) and, with `extra_block`,
    AttributeDiscriminator128 (:102-141, 64^2 crops, one more block)."""

    def __init__(self, n_attribute: int = 106, conv_dim: int = 64, extra_block: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.main = _trunk(conv_dim, False, extra_block, dtype)
        self.classifier_att = SNLinear(16 * conv_dim, n_attribute, dtype=dtype)

    def forward(self, x, update_stats: bool = True):
        """x (N, 3, h, w) crops -> attribute logits (N, n_attribute)."""
        return self.classifier_att(_features(self.main, x, update_stats), update_stats)


def build_discriminators(cfg: Config, device, seed: int | None = None):
    """The image, object and attribute discriminators of `cfg` on `device`
    (JAX `train/state.py::Models`): width `d_conv_dim`, `num_classes`
    classes, `attribute_dim` attributes, the attribute D's extra block at
    128^2, bf16 compute with `cfg.bf16`; weights drawn from `seed`
    (default `cfg.seed`), the three in that order from one generator."""
    dtype = torch.bfloat16 if cfg.bf16 else None
    nets = (ImageDiscriminator(cfg.d_conv_dim, dtype),
            ObjectDiscriminator(cfg.num_classes, cfg.d_conv_dim, dtype),
            AttributeDiscriminator(cfg.attribute_dim, cfg.d_conv_dim, cfg.image_size == 128, dtype))
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return tuple(init_weights(net, gen).to(device) for net in nets)
