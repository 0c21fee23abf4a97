"""Crop realism classification, train and test functions around ResNet-50:
the twin of `aglayout_tpu/eval/classifier.py`.

Reference parity: evaluation/train_resinet50_vg.py (trains on real 224^2
object crops, n_class-way CE) and evaluation/test_classification_vg.py
(accuracy on real vs generated vs shifted crops from the generation
pickles, which `eval/gen_pickle.py` writes). The weights file is a
`torch.save`d `state_dict` (`.pt`), where JAX's is flax msgpack.

    python -m aglayout_tpu_torch.eval.classifier train --vg_dir DIR --out cls.pt
    python -m aglayout_tpu_torch.eval.classifier test PICKLE_DIR --weights cls.pt
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch

from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.eval.resnet import ResNet50, flax_init
from aglayout_tpu_torch.ops.bilinear import crop_bbox_dense
from aglayout_tpu_torch.train.losses import cross_entropy


def crops_of(imgs, boxes, crop_size: int):
    """Every box's crop of its image: imgs (B, H, W, 3) JAX's layout, boxes
    (B, O, 4) -> (B*O, 3, crop_size, crop_size), f32."""
    b, o = boxes.shape[:2]
    return crop_bbox_dense(imgs.permute(0, 3, 1, 2), boxes, crop_size).reshape(
        b * o, 3, crop_size, crop_size)


def make_crop_classifier(num_classes: int, crop_size: int = 224, lr: float = 1e-4, init=None, *,
                         device):
    """(ResNet-50 on `device` in training mode, its Adam(lr), crop_size): the
    weights from the `state_dict` `init`, else drawn as flax draws JAX's
    (`resnet.flax_init`) from a generator seeded 0."""
    with torch.device("meta"):  # no draw: every tensor is set below
        model = ResNet50(num_classes)
    model = model.to_empty(device="cpu")
    if init is None:
        flax_init(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(init)
    model = model.to(device).train()
    return model, torch.optim.Adam(model.parameters(), lr=lr), crop_size


def train_crop_classifier(cfg, loader, niter=5000, crop_size=224, lr=1e-4, log_step=50,
                          init=None, *, device):
    """Train the ResNet-50 crop classifier on `loader`'s real crops: Adam,
    the CE over the valid objects, BN in training mode over all B*O crops
    (padding slots included, as JAX's). Returns the model."""
    model, opt, _ = make_crop_classifier(cfg.num_classes, crop_size, lr, init, device=device)
    it = iter(loader)
    for i in range(niter):
        batch = batch_to_torch(next(it), device)
        logits = model(crops_of(batch["imgs"], batch["boxes"], crop_size))
        loss = cross_entropy(logits, batch["objs"].reshape(-1), batch["valid"].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if (i + 1) % log_step == 0:
            print(f"cls iter {i + 1}/{niter} loss {loss.item():.4f}", flush=True)
    return model


def test_crop_classifier(model, pickle_dir, crop_size=224, max_batches=None, *, device):
    """Accuracy on real / generated / shifted crops (reference
    test_classification_vg.py:44-150), in eval mode."""
    counts = {"real": [0, 0], "rand": [0, 0], "shift": [0, 0]}
    files = sorted(glob.glob(os.path.join(pickle_dir, "batch_*.pkl")))
    if max_batches:
        files = files[:max_batches]
    model.eval()
    with torch.no_grad():
        for f in files:
            with open(f, "rb") as fh:
                rec = pickle.load(fh)
            labels = rec["objs"].reshape(-1)
            valid = rec["valid"].reshape(-1) > 0
            for key, imgs, boxes in [
                ("real", rec["imgs"], rec["boxes"]),
                ("rand", rec["imgs_rand"], rec["boxes"]),
                ("shift", rec["imgs_shift"], rec["boxes_shift"]),
            ]:
                crops = crops_of(torch.as_tensor(np.asarray(imgs, np.float32), device=device),
                                 torch.as_tensor(np.asarray(boxes, np.float32), device=device),
                                 crop_size)
                pred = model(crops).argmax(-1).cpu().numpy()
                counts[key][0] += int(((pred == labels) & valid).sum())
                counts[key][1] += int(valid.sum())
    return {k: (c / max(n, 1)) for k, (c, n) in counts.items()}


def main(argv=None):
    """`train` fits the crop classifier on real crops from the VG loader and
    saves its `state_dict`; `test` scores real/rand/shift crops from
    generation pickles. Both on the card unless `--device cpu`."""
    import argparse
    import json

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.utils.device import require

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train")
    pt.add_argument("--vg_dir", required=True)
    pt.add_argument("--image_dir", default="")
    pt.add_argument("--out", default="crop_classifier.pt")
    pt.add_argument("--image_size", type=int, default=64)
    pt.add_argument("--batch_size", type=int, default=8)
    pt.add_argument("--niter", type=int, default=5000)
    pt.add_argument("--crop_size", type=int, default=224)
    pe = sub.add_parser("test")
    pe.add_argument("pickle_dir")
    pe.add_argument("--weights", required=True)
    pe.add_argument("--crop_size", type=int, default=224)
    pe.add_argument("--max_batches", type=int, default=None)
    pe.add_argument("--num_classes", type=int, default=179,
                    help="must match the trained weights (vocab size at train time)")
    for q in (pt, pe):
        q.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="cpu: run on the host")
    args = p.parse_args(argv)
    device = require(args.device, "classifier")

    if args.cmd == "train":
        from aglayout_tpu_torch.data.dataset import get_dataloaders

        cfg = config_for(args.image_size, vg_dir=args.vg_dir, image_dir=args.image_dir,
                         batch_size=args.batch_size)
        loader, _, vocab = get_dataloaders(cfg)
        cfg.num_classes = len(vocab["object_idx_to_name"])
        model = train_crop_classifier(cfg, loader, niter=args.niter, crop_size=args.crop_size,
                                      device=device)
        torch.save(model.state_dict(), args.out)
        print(f"saved {args.out}")
        return args.out
    sd = torch.load(args.weights, map_location=device, weights_only=True)
    model, _, _ = make_crop_classifier(args.num_classes, args.crop_size, init=sd, device=device)
    acc = test_crop_classifier(model, args.pickle_dir, crop_size=args.crop_size,
                               max_batches=args.max_batches, device=device)
    print(json.dumps(acc))
    return acc


if __name__ == "__main__":
    main()
