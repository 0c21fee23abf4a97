"""Train the held-out attribute classifier used for consistency evaluation:
the twin of `aglayout_tpu/eval/train_att_cls.py`.

Capability parity with the reference's evaluation/train_att_cls.py: its
own copy of the attribute discriminator (`models/discriminator.py`'s
`AttributeDiscriminator`, the sixth block at 128^2) is trained on real object crops with the
pos-weighted BCE (:238-239), and saved apart from the GAN's netD_att so
that evaluation is not self-graded: `{out_dir}/step_<niter>.pt`, the
port's checkpoint layout (`utils/checkpoint.py`) holding this one net as
"d_att".

    python -m aglayout_tpu_torch.eval.train_att_cls --vg_dir DIR --out_dir OUT
"""

from __future__ import annotations

import argparse
import os

import torch

from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.data.vocab import attribute_pos_weight
from aglayout_tpu_torch.eval.classifier import crops_of
from aglayout_tpu_torch.models.discriminator import AttributeDiscriminator
from aglayout_tpu_torch.models.generator import init_weights
from aglayout_tpu_torch.train.losses import bce_logits
from aglayout_tpu_torch.utils.checkpoint import checkpoint_path


def make_classifier_step(model, opt, pos_weight, object_size: int):
    """step(batch) -> loss: the BCE of the attribute logits on the
    annotated valid objects' crops, one Adam step. The spectral norms'
    power iteration runs in every forward (`update_stats`), so sigma is
    taken on iterated u and v, as JAX's step takes it."""
    pos_weight = torch.as_tensor(pos_weight, dtype=torch.float32,
                                 device=next(model.parameters()).device)

    def step(batch):
        b, o = batch["objs"].shape
        att = batch["attribute"].reshape(b * o, -1)
        annotated = (att.sum(-1) > 0) & (batch["valid"].reshape(-1) > 0)
        logits = model(crops_of(batch["imgs"], batch["boxes"], object_size), True)
        loss = bce_logits(logits, att, annotated, pos_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def train_attribute_classifier(cfg, loader, niter=10000, lr=2e-4, log_step=50, out_dir=None,
                               init=None, *, device):
    """Train the attribute classifier (width 64, `cfg.attribute_dim`
    attributes, the extra block at 128^2) with Adam(lr, 0.5, 0.999) on
    `loader`'s crops at `cfg.object_size`; weights from the `state_dict`
    `init`, else drawn from seed 0. Saves at step `niter` under `out_dir`
    when given. Returns (model, the last loss)."""
    model = AttributeDiscriminator(cfg.attribute_dim, extra_block=cfg.image_size == 128)
    if init is not None:
        model.load_state_dict(init)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.5, 0.999))
    step = make_classifier_step(model, opt, attribute_pos_weight(), cfg.object_size)
    it = iter(loader)
    loss = None
    for i in range(niter):
        loss = step(batch_to_torch(next(it), device))
        if (i + 1) % log_step == 0:
            print(f"att_cls iter {i + 1}/{niter} loss {loss.item():.4f}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        torch.save({"step": niter, "nets": {"d_att": model.state_dict()}},
                   checkpoint_path(out_dir, niter))
    return model, (loss.item() if loss is not None else None)


def main(argv=None):
    from aglayout_tpu_torch.utils.device import require

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, default=64, choices=[64, 128])
    p.add_argument("--vg_dir", default="data/vg")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--niter", type=int, default=10000)
    p.add_argument("--out_dir", default="checkpoints/att_cls")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="cpu: run on the host")
    args = p.parse_args(argv)
    device = require(args.device, "train_att_cls")

    from aglayout_tpu_torch.data.dataset import get_dataloaders

    cfg = config_for(args.image_size, vg_dir=args.vg_dir, batch_size=args.batch_size)
    train_loader, _, vocab = get_dataloaders(cfg)
    cfg.num_classes = len(vocab["object_idx_to_name"])
    return train_attribute_classifier(cfg, train_loader, args.niter, out_dir=args.out_dir,
                                      device=device)


if __name__ == "__main__":
    main()
