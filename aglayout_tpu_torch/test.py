"""Inference entry point of the port: the twin of the root `test.py`
(reference test64.py/test128.py, one binary).

  python -m aglayout_tpu_torch.test --image_size 64     # == reference test64.py
  python -m aglayout_tpu_torch.test --image_size 128    # == reference test128.py
  python -m aglayout_tpu_torch.test --synthetic --device cpu --max_batches 1

Generates _rand/_shift/_rec/_real PNGs per sample, runs the attribute
modification demo (+_modified PNGs on success), and prints per-object
attribute precision/recall + edit success rate as JSON. Runs on the CUDA
card unless `--device cpu` is given, and raises where there is no card.
"""

import argparse
import json


def load_torch_state_dict(path: str, device="cpu") -> dict:
    """A reference `state_dict` pickle (netG / netD_attribute) -> its
    tensors on `device`, the non-tensor entries dropped (JAX's
    `utils/torch_import.load_torch_state_dict`)."""
    import torch

    sd = torch.load(path, map_location=device, weights_only=True)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, default=64, choices=[64, 128])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--vg_dir", type=str, default="data/vg")
    p.add_argument("--path", type=str, default="checkpoints")
    p.add_argument("--resume", type=str, default="l")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--edit_target", type=int, default=95, help="95 = black")
    p.add_argument("--no_images", action="store_true")
    p.add_argument("--draw_boxes", action="store_true",
                   help="draw colored layout boxes on saved images (test_with_boxes_drawn)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--torch_netG", type=str, default=None,
                   help="reference netG state_dict to load (strict)")
    p.add_argument("--torch_netD_att", type=str, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host")
    return p


def synthetic_loader(cfg):
    """test.py's `--synthetic` stream: `synthetic_batch` from RandomState(0)."""
    import numpy as np

    from aglayout_tpu_torch.data.synthetic import synthetic_batch

    rng = np.random.RandomState(0)
    while True:
        yield synthetic_batch(rng, cfg.batch_size, cfg.max_objects, cfg.image_size,
                              cfg.num_classes, cfg.attribute_dim)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.infer.generate import run_inference
    from aglayout_tpu_torch.train.loop import prepare_dirs
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.utils.checkpoint import restore_state
    from aglayout_tpu_torch.utils.device import require

    device = require(args.device, "test")
    cfg = config_for(
        args.image_size, batch_size=args.batch_size, vg_dir=args.vg_dir, path=args.path
    )

    if args.synthetic:
        data = synthetic_loader(cfg)
        vocab = None
    else:
        from aglayout_tpu_torch.data.dataset import get_dataloaders

        _, val_loader, vocab = get_dataloaders(cfg)
        cfg.num_classes = len(vocab["object_idx_to_name"])
        data = val_loader.epoch(0)

    state = create_train_state(cfg, device)
    dirs = prepare_dirs(cfg)
    if args.torch_netG:
        state.models.g.load_state_dict(load_torch_state_dict(args.torch_netG, device), strict=True)
        if args.torch_netD_att:
            state.models.d_att.load_state_dict(load_torch_state_dict(args.torch_netD_att, device),
                                               strict=True)
    else:
        state, step = restore_state(dirs["models"], state, args.resume)
        print(f"restored checkpoint at step {step}")

    summary = run_inference(
        cfg,
        state.models,
        data,
        dirs["results"],
        device=device,
        max_batches=args.max_batches,
        edit_target=args.edit_target,
        save_images=not args.no_images,
        draw_boxes=args.draw_boxes,
        vocab=None if args.synthetic else vocab,
    )
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
