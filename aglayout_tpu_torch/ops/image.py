"""ImageNet (de)normalization, NHWC, as `aglayout_tpu/ops/image.py`
(the reference's `data/utils.py:28-66`)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_preprocess(images):
    """[0, 1] float (..., 3) -> ImageNet-normalized, in the images' dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def imagenet_deprocess(images, rescale: bool = True):
    """Inverse-normalize (B, H, W, 3); optionally min-max rescale per image to [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    x = images.float() * std + mean
    if rescale:
        axes = tuple(range(1, x.ndim))
        lo = x.amin(dim=axes, keepdim=True)
        hi = x.amax(dim=axes, keepdim=True)
        x = (x - lo) / (hi - lo)
    return x


def imagenet_deprocess_batch(images, rescale: bool = True):
    """NHWC normalized batch -> uint8 [0, 255] (reference data/utils.py:47-66)."""
    x = imagenet_deprocess(images, rescale=rescale)
    return (x * 255.0).clamp(0, 255).to(torch.uint8)
