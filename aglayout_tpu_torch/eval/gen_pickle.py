"""Dump generated batches for downstream classification evaluation: the twin
of `aglayout_tpu/eval/gen_pickle.py`.

Capability parity with the reference's evaluation/gen_pickle_for_classification.py
(:144-176): per batch, pickle (imgs, imgs_rand, imgs_shift, objs, boxes,
boxes_shift, valid, attribute) plus deprocessed PNGs, consumed by the crop
realism classifier and the consistency CLI. The pickles keep JAX's keys and
layout (numpy NHWC images, the generator's raw f32 output), so a pickle
written by either package is read by the other's consumers.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.infer.generate import (
    check_no_grad,
    eval_forward,
    eval_mode,
    forward_draws,
    given_draws,
)
from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch


def dump_generation_pickles(cfg, models, loader, out_dir, max_batches=100, seed=0, *, device,
                            draws=None):
    """One eval forward of `models.g` (on `device`) a batch, z and eps from
    a `torch.Generator(device)` seeded with `seed` or given in `draws` (one
    dict a batch with "z" and "eps"); writes batch_*.pkl and the three
    images' PNGs to `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device).manual_seed(seed)
    with torch.inference_mode(), eval_mode(models.g):
        for bi, batch_np in enumerate(loader):
            if bi >= max_batches:
                break
            batch = batch_to_torch(batch_np, device)
            b, o = batch_np["objs"].shape
            if draws is None:
                z, eps = forward_draws(gen, b, o, cfg.z_dim, device)
            else:
                z, eps = given_draws(draws, bi, ("z", "eps"), device)
            out = eval_forward(models.g, batch, z, batch["attribute"], batch["attribute"], eps)
            if bi == 0:
                check_no_grad(out)
            rec = {
                "imgs": np.asarray(batch_np["imgs"], np.float32),
                "imgs_rand": out["img_rand"].float().cpu().numpy(),
                "imgs_shift": out["img_shift"].float().cpu().numpy(),
                "objs": batch_np["objs"],
                "boxes": batch_np["boxes"],
                "boxes_shift": batch_np["boxes_shift"],
                "valid": batch_np["valid"],
                "attribute": batch_np["attribute"],
            }
            with open(os.path.join(out_dir, f"batch_{bi:05d}.pkl"), "wb") as f:
                pickle.dump(rec, f)
            from PIL import Image

            for name in ("imgs", "imgs_rand", "imgs_shift"):
                u8 = imagenet_deprocess_batch(torch.from_numpy(rec[name])).numpy()
                for j in range(b):
                    Image.fromarray(u8[j]).save(
                        os.path.join(out_dir, f"{name}_{bi * b + j:06d}.png")
                    )
    return out_dir
