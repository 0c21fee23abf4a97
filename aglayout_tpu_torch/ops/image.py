"""ImageNet (de)normalization, NHWC, as `aglayout_tpu/ops/image.py`
(the reference's `data/utils.py:28-66`)."""

from __future__ import annotations

import functools

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _mean_std(dtype: torch.dtype, device: torch.device):
    """The (mean, std) tensors in `dtype` on `device`, made once: a train
    step builds its grids without a host-to-device copy."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def imagenet_preprocess(images):
    """[0, 1] float (..., 3) -> ImageNet-normalized, in the images' dtype."""
    mean, std = _mean_std(images.dtype, images.device)
    return (images - mean) / std


def imagenet_deprocess(images, rescale: bool = True):
    """Inverse-normalize (B, H, W, 3); optionally min-max rescale per image to [0, 1]."""
    mean, std = _mean_std(torch.float32, images.device)
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
