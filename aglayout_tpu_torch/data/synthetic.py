"""Synthetic in-memory dataset for tests and benchmarks.

The port's own copy of `aglayout_tpu/data/synthetic.py`: the same numpy
draws from the same `RandomState`, so one seed gives both packages the same
batch. It stands in for the Visual Genome h5 pipeline with the dense padded
contract the models consume (JAX's layout: NHWC images, masks (B, O, H, W,
1)), with realistic box, mask and attribute statistics; `batch_to_torch`
moves a batch onto a device.
"""

from __future__ import annotations

import numpy as np

import torch

from aglayout_tpu_torch.ops.image import IMAGENET_MEAN as _MEAN
from aglayout_tpu_torch.ops.image import IMAGENET_STD as _STD

IMAGENET_MEAN = np.array(_MEAN, np.float32)
IMAGENET_STD = np.array(_STD, np.float32)


def synthetic_batch(
    rng: np.random.RandomState,
    batch_size: int = 8,
    max_objects: int = 10,
    image_size: int = 64,
    num_classes: int = 179,
    attribute_dim: int = 106,
    annotated_fraction: float = 0.7,
):
    b, o, s = batch_size, max_objects, image_size
    imgs = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    imgs = (imgs - IMAGENET_MEAN) / IMAGENET_STD

    objs = rng.randint(0, num_classes, (b, o)).astype(np.int32)
    n_valid = rng.randint(1, o + 1, b)
    valid = (np.arange(o)[None] < n_valid[:, None]).astype(np.float32)

    xy0 = rng.uniform(0, 0.6, (b, o, 2)).astype(np.float32)
    wh = rng.uniform(0.1, 0.4, (b, o, 2)).astype(np.float32)
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, 1.0)], axis=-1).astype(np.float32)

    # shift augmentation (same rule as the runtime pipeline)
    x0, x1 = boxes[..., 0], boxes[..., 2]
    width = x1 - x0
    left, right = x0, 1.0 - x1
    delta = np.where(left > right, -left * 0.8, np.where(right > left, right * 0.8, 0.0))
    delta = np.where(width < 0.5, delta, 0.0).astype(np.float32)
    boxes_shift = boxes.copy()
    boxes_shift[..., 0] += delta
    boxes_shift[..., 2] += delta

    def rasterize(bx):
        m = np.zeros((b, o, s, s, 1), np.float32)
        c0 = np.round(bx[..., 0] * s).astype(int)
        c1 = np.round(bx[..., 2] * s).astype(int)
        r0 = np.round(bx[..., 1] * s).astype(int)
        r1 = np.round(bx[..., 3] * s).astype(int)
        for i in range(b):
            for j in range(o):
                m[i, j, r0[i, j] : r1[i, j], c0[i, j] : c1[i, j], 0] = 1
        return m

    attribute = np.zeros((b, o, attribute_dim), np.float32)
    annotated = rng.rand(b, o) < annotated_fraction
    n_attrs = rng.randint(1, 4, (b, o))
    for i in range(b):
        for j in range(o):
            if annotated[i, j]:
                ids = rng.choice(attribute_dim, n_attrs[i, j], replace=False)
                attribute[i, j, ids] = 1

    return {
        "imgs": imgs,
        "objs": objs,
        "boxes": boxes,
        "masks": rasterize(boxes),
        "valid": valid,
        "attribute": attribute,
        "masks_shift": rasterize(boxes_shift),
        "boxes_shift": boxes_shift,
    }


def synthetic_cooccurrence(rng: np.random.RandomState, num_classes=179, attribute_dim=106):
    return rng.randint(0, 100, (num_classes, attribute_dim)).astype(np.float32)


def synthetic_scene_batch(
    rng: np.random.RandomState,
    batch_size: int = 8,
    max_objects: int = 10,
    image_size: int = 64,
    num_classes: int = 179,
    attribute_dim: int = 106,
):
    """A LEARNABLE synthetic corpus: the image is a deterministic render of
    the layout (class-colored rectangles over a class-seeded background),
    and each object carries its class-derived attribute. A GAN trained on
    these scenes must learn the layout -> image mapping, which makes this
    the training-evidence corpus (reconstruction L1 and adversarial losses
    have real signal, unlike noise images)."""
    b, o, s = batch_size, max_objects, image_size
    base = synthetic_batch(
        rng, batch_size, max_objects, image_size, num_classes, attribute_dim
    )
    palette = np.random.RandomState(1234).uniform(0.1, 0.9, (num_classes, 3))

    objs, boxes, valid = base["objs"], base["boxes"], base["valid"]
    imgs = np.empty((b, s, s, 3), np.float32)
    imgs[:] = 0.82  # light background
    # vertical shading so the background is not a constant
    imgs -= (np.linspace(0, 0.12, s, dtype=np.float32))[None, :, None, None]
    c0 = np.round(boxes[..., 0] * s).astype(int)
    c1 = np.round(boxes[..., 2] * s).astype(int)
    r0 = np.round(boxes[..., 1] * s).astype(int)
    r1 = np.round(boxes[..., 3] * s).astype(int)
    for i in range(b):
        for j in range(o):
            if valid[i, j] > 0:
                imgs[i, r0[i, j] : r1[i, j], c0[i, j] : c1[i, j]] = palette[objs[i, j]]
    imgs += rng.uniform(-0.02, 0.02, imgs.shape).astype(np.float32)
    base["imgs"] = ((np.clip(imgs, 0, 1) - IMAGENET_MEAN) / IMAGENET_STD).astype(
        np.float32
    )

    # class-derived attribute (gives the attribute discriminator signal)
    attribute = np.zeros((b, o, attribute_dim), np.float32)
    attribute[np.arange(b)[:, None], np.arange(o)[None], objs % attribute_dim] = 1.0
    base["attribute"] = attribute * valid[..., None]
    return base


def batch_to_torch(batch, device):
    """A numpy batch -> tensors on `device`, class ids as int64. To a CUDA
    device each array goes through pinned host memory, and the copy is
    queued on the current stream without blocking the host."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if cuda:
            t = t.pin_memory()
        out[k] = t.to(device, torch.long if k == "objs" else None, non_blocking=cuda)
    return out
