"""Layout visualization: draw colored object boxes on images.

The port's own copy of `aglayout_tpu/utils/draw.py` (the used parts of the
reference's utils/draw_box.py, draw_layout/draw_bbox, and
test_with_boxes_drawn.py): given uint8 images and normalized boxes, draw
per-object colored rectangles (+ optional class names), for qualitative
inspection of generated layouts.
"""

from __future__ import annotations

import colorsys

import numpy as np


def _palette(n: int):
    return [
        tuple(int(255 * c) for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.9, 1.0))
        for i in range(n)
    ]


def draw_boxes(image_u8: np.ndarray, boxes, valid=None, labels=None, vocab=None):
    """image_u8: (H, W, 3) uint8; boxes: (O, 4) normalized [x0,y0,x1,y1].

    Returns a new uint8 image with rectangles (and label text when PIL has
    a default font and `labels`/`vocab` are given).
    """
    from PIL import Image, ImageDraw

    im = Image.fromarray(image_u8)
    drw = ImageDraw.Draw(im)
    h, w = image_u8.shape[:2]
    colors = _palette(len(boxes))
    for i, box in enumerate(np.asarray(boxes)):
        if valid is not None and not valid[i]:
            continue
        x0, y0, x1, y1 = box
        xy = [
            (round(float(x0) * w), round(float(y0) * h)),
            (round(float(x1) * w), round(float(y1) * h)),
        ]
        if xy[1][0] <= xy[0][0] or xy[1][1] <= xy[0][1]:
            continue
        drw.rectangle(xy, outline=colors[i], width=1)
        if labels is not None:
            name = (
                vocab["object_idx_to_name"][int(labels[i])]
                if vocab is not None
                else str(int(labels[i]))
            )
            drw.text((xy[0][0] + 1, xy[0][1] + 1), name, fill=colors[i])
    return np.asarray(im)


def draw_boxes_batch(images_u8, boxes, valid=None, labels=None, vocab=None):
    """(N, H, W, 3) uint8 + (N, O, 4) boxes -> batch with boxes drawn."""
    out = []
    for i in range(len(images_u8)):
        out.append(
            draw_boxes(
                np.asarray(images_u8[i]),
                boxes[i],
                None if valid is None else np.asarray(valid[i]) > 0,
                None if labels is None else labels[i],
                vocab,
            )
        )
    return np.stack(out)


def plot_grad_flow(named_grads, path: str, max_bars: int = 60):
    """Per-layer gradient-norm bar chart (reference utils/draw_box.py
    plot_grad_flow_line/_barchart :397-453): `named_grads` a dict, or pairs,
    of name -> gradient tensor (`{k: p.grad for k, p in
    module.named_parameters()}`), where JAX's takes a gradient pytree.
    Needs matplotlib, as JAX's does (ImportError without it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    items = list(named_grads.items() if hasattr(named_grads, "items") else named_grads)
    names, norms = [], []
    for name, grad in items[:max_bars]:
        names.append(name.replace(".", "/")[-40:])
        g = np.asarray(grad.detach().float().cpu() if hasattr(grad, "detach") else grad, np.float32)
        norms.append(float(np.sqrt(np.mean(np.square(g)))))
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.3), 4))
    ax.bar(range(len(norms)), norms, color="#4878d0")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=90, fontsize=5)
    ax.set_yscale("log")
    ax.set_ylabel("grad RMS")
    ax.set_title("gradient flow")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return dict(zip(names, norms))
