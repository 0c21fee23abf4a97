"""ResNet-50 for the crop realism classification: the twin of
`aglayout_tpu/eval/resnet.py`.

The reference fine-tunes torchvision's ImageNet ResNet-50
(evaluation/train_resinet50_vg.py); pretrained weights are not available
offline, so both packages train it from scratch. The modules carry
torchvision's `state_dict` keys (`conv1`, `bn1`, `layer{1-4}.{j}.{conv,bn}{1-3}`,
`layer{i}.0.downsample.{0,1}`, `fc`), so a torchvision file loads, while
the arithmetic is flax's, as JAX's model computes it:

  * BatchNorm's running variance moves with the batch's *biased*
    variance, E[x^2] - E[x]^2 clipped at 0 (flax), not torch's unbiased
    one; momentum 0.1 in torch's convention (flax's 0.9); eps 1e-5;
  * the stride sits on the 3x3 conv; a projection shortcut (1x1 conv and
    BN) wherever a block changes the shape;
  * a fresh model is drawn as flax draws one (`flax_init`): every conv
    and the fc kernel from a normal cut at +-2 sigma and rescaled to
    variance 1 / fan_in (`lecun_normal`), the fc bias 0, every BN at
    scale 1 and bias 0 but the last of each block, at scale 0;
  * the stem's max pool is 3x3 / 2 with padding 1.

Inputs are NCHW crops.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


# the std of a standard normal cut at +-2 (flax's `variance_scaling` divides by it)
TRUNCATED_STD = 0.87962566103423978


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d`'s parameters and buffers with flax's training
    update: normalise by the biased batch variance and move the running
    variance with it too."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight  # flax's order
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, 1), FlaxBatchNorm2d(features)
        self.conv2, self.bn2 = _conv(features, features, 3, stride), FlaxBatchNorm2d(features)
        self.conv3, self.bn3 = _conv(features, 4 * features, 1), FlaxBatchNorm2d(4 * features)
        nn.init.zeros_(self.bn3.weight)
        self.downsample = None
        if stride != 1 or cin != 4 * features:
            self.downsample = nn.Sequential(_conv(cin, 4 * features, 1, stride),
                                            FlaxBatchNorm2d(4 * features))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    def __init__(self, num_classes: int, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), FlaxBatchNorm2d(64)
        cin = 64
        for i, count in enumerate(stage_sizes):
            blocks = []
            for j in range(count):
                blocks.append(Bottleneck(cin, 64 * 2**i, 2 if i > 0 and j == 0 else 1))
                cin = 4 * 64 * 2**i
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.stages = len(stage_sizes)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        for i in range(self.stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean((2, 3)))


@torch.no_grad()
def flax_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw a fresh `ResNet50` (on the CPU) from `generator` as flax draws
    JAX's: each conv and fc weight from `variance_scaling(1, "fan_in",
    "truncated_normal")`, the fc bias 0, each BN fresh (running mean 0 and
    variance 1, scale 1, bias 0) but each block's `bn3` at scale 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = m.weight[0].numel() ** -0.5 / TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.bn3.weight.zero_()
    return model
