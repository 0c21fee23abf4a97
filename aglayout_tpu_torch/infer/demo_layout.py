"""Hand-authored layout demo — evaluation/create_layout.py equivalent; the
twin of `aglayout_tpu/infer/demo_layout.py`.

Builds layout tensors by hand (object names, boxes, attributes looked up in
vocab.json) and generates images from them — the "compose a scene from
scratch" entry point. Runs on the CUDA card unless `--device cpu` is given.

    python -m aglayout_tpu_torch.infer.demo_layout --vg_dir data/vg \
        --spec '[{"name": "sky", "box": [0,0,1,0.4]},
                 {"name": "car", "box": [0.3,0.6,0.7,0.9], "attributes": ["red"]}]'
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def layout_from_spec(spec, vocab, max_objects=10, attribute_dim=106):
    """spec: list of {name, box [x0,y0,x1,y1], attributes: [names]}."""
    name_to_idx = vocab["object_name_to_idx"]
    att_to_idx = vocab["attribute_name_to_idx"]
    o = max_objects
    objs = np.zeros((1, o), np.int32)
    boxes = np.tile(np.array([0, 0, 1, 1], np.float32), (1, o, 1))
    valid = np.zeros((1, o), np.float32)
    attribute = np.zeros((1, o, attribute_dim), np.float32)
    for i, obj in enumerate(spec[:o]):
        objs[0, i] = name_to_idx[obj["name"]]
        boxes[0, i] = obj["box"]
        valid[0, i] = 1
        for att in obj.get("attributes", []):
            attribute[0, i, att_to_idx[att]] = 1
    return objs, boxes, valid, attribute


DEFAULT_SPEC = [
    {"name": "sky", "box": [0.0, 0.0, 1.0, 0.35], "attributes": ["blue"]},
    {"name": "tree", "box": [0.05, 0.2, 0.35, 0.9], "attributes": ["green"]},
    {"name": "car", "box": [0.45, 0.55, 0.9, 0.85], "attributes": ["red"]},
    {"name": "road", "box": [0.0, 0.7, 1.0, 1.0]},
]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, default=64, choices=[64, 128])
    p.add_argument("--vg_dir", default="data/vg")
    p.add_argument("--vocab", default=None)
    p.add_argument("--spec", default=None, help="JSON layout spec (string or @file)")
    p.add_argument("--path", default="checkpoints")
    p.add_argument("--resume", default="l")
    p.add_argument("--out", default="demo")
    p.add_argument("--samples", type=int, default=4, help="z samples per layout")
    p.add_argument("--draw_boxes", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the plain paths on the host")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch
    from aglayout_tpu_torch.train.loop import prepare_dirs
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.utils.checkpoint import restore_state
    from aglayout_tpu_torch.utils.device import require

    device = require(args.device, "demo_layout")
    with open(args.vocab or os.path.join(args.vg_dir, "vocab.json")) as f:
        vocab = json.load(f)

    if args.spec is None:
        spec = [s for s in DEFAULT_SPEC if s["name"] in vocab["object_name_to_idx"]]
    elif args.spec.startswith("@"):
        with open(args.spec[1:]) as f:
            spec = json.load(f)
    else:
        spec = json.loads(args.spec)

    cfg = config_for(args.image_size, path=args.path)
    cfg.num_classes = len(vocab["object_idx_to_name"])
    state = create_train_state(cfg, device)
    state, step = restore_state(prepare_dirs(cfg)["models"], state, args.resume)
    print(f"checkpoint step {step}")
    g = state.models.g

    objs, boxes, valid, attribute = layout_from_spec(
        spec, vocab, cfg.max_objects, cfg.attribute_dim
    )
    layout = [torch.from_numpy(a).to(device) for a in (objs.astype(np.int64), boxes, valid)]
    att = torch.from_numpy(attribute).to(device)
    os.makedirs(args.out, exist_ok=True)
    gen = torch.Generator(device).manual_seed(0)
    with torch.inference_mode():
        for k in range(args.samples):
            z = torch.randn(1, cfg.max_objects, cfg.z_dim, generator=gen, device=device)
            img = g.generate(*layout, z, att)  # eval mode, B=1
            u8 = imagenet_deprocess_batch(img).cpu().numpy()[0]
            if args.draw_boxes:
                from aglayout_tpu_torch.utils.draw import draw_boxes

                u8 = draw_boxes(u8, boxes[0], valid[0] > 0, objs[0], vocab)
            from PIL import Image

            Image.fromarray(u8).save(os.path.join(args.out, f"demo_{k}.png"))
    print(f"wrote {args.samples} samples to {args.out}/")


if __name__ == "__main__":
    main()
