"""Inference and attribute editing: the twin of `aglayout_tpu/infer/generate.py`
(the reference's test64.py/test128.py).

Per batch (reference test64.py:114-239), in JAX's order:
  1. estimate attributes for unannotated objects (argmax of the attribute
     D on the real crops, :127-138);
  2. the eval generator forward -> img_rec / img_rand / img_shift + crops;
  3. attribute scoring: the attribute D on the generated crops, sigmoid >
     0.9 against the annotated rows (:144-164);
  4. attribute editing: zero the 12 colour attributes, set the target
     colour for every object, regenerate with a fresh z (:170-185);
  5. edit success: the target in the top 3 of the edited crop's logits AND
     not in the top 5 of the original's (:193-198);
  6. the _rand/_shift/_rec/_real PNGs (+ _modified ones on success).

The nets run in eval mode under `torch.inference_mode()` on the batch's
device, where the generator's routes take the Hopper kernels (three
launches of each of K1-K5 a forward at 128^2); the host does the metrics
and PNG encoding in numpy, as JAX's does, so equal logits give equal
summaries. The draws (z, z2 and the two reparametrisation eps) come from a
`torch.Generator` on the device seeded with `seed`, or are given.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.data.vocab import COLOR_ATTRIBUTE_IDS, DEFAULT_EDIT_TARGET
from aglayout_tpu_torch.ops.bilinear import crop_bbox_dense
from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch
from aglayout_tpu_torch.train.attributes import estimate_attributes


def save_png(path: str, array_u8: np.ndarray):
    from PIL import Image

    Image.fromarray(array_u8).save(path)


@dataclass
class AttributeMetrics:
    """Per-object multi-label precision/recall accumulator
    (reference test64.py:241-265 via sklearn confusion_matrix)."""

    tp: list = field(default_factory=list)
    fp: list = field(default_factory=list)
    fn: list = field(default_factory=list)

    def update(self, pred: np.ndarray, gt: np.ndarray):
        for p, g in zip(pred, gt):
            p, g = p > 0, g > 0
            self.tp.append(int(np.sum(p & g)))
            self.fp.append(int(np.sum(p & ~g)))
            self.fn.append(int(np.sum(~p & g)))

    def summary(self) -> dict:
        tp = np.array(self.tp, np.float64)
        fp = np.array(self.fp, np.float64)
        fn = np.array(self.fn, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
            rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        n = max(len(tp), 1)
        return {
            "average_precision": float(prec.mean()) if len(tp) else 0.0,
            "average_recall": float(np.nan_to_num(rec).mean()) if len(tp) else 0.0,
            "avg_pred_per_obj": float((tp + fp).sum() / n),
            "avg_gt_per_obj": float((tp + fn).sum() / n),
            "frac_predicting_any": float(((tp + fp) > 0).sum() / n),
            "frac_correct_once": float((tp > 0).sum() / n),
            "num_objects": int(len(tp)),
        }


@contextlib.contextmanager
def eval_mode(*modules):
    """The modules in eval mode for the body (their routes take the kernels
    on the card), their own modes restored afterwards."""
    modes = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


def check_no_grad(out: dict):
    """The kernels have no backward: raise if an output of the eval path
    carries a graph (a caller that left `torch.inference_mode()`)."""
    if any(v.requires_grad for v in out.values()):
        raise RuntimeError("the eval path ran with grad on; its kernels have no backward")


def eval_forward(g, batch, z, attribute, attribute_est, eps):
    """The generator's forward on a batch of tensors (`batch_to_torch`), in
    whatever mode `g` is: JAX's eleven-key dict."""
    return g(batch["imgs"], batch["objs"], batch["boxes"], batch["masks"], batch["valid"], z,
             attribute, batch["masks_shift"], batch["boxes_shift"], attribute_est, eps)


def forward_draws(gen: torch.Generator, b: int, o: int, z_dim: int, device):
    """z (B, O, z_dim) and the reparametrisation eps (B*O, z_dim) of one
    forward, in that order, from `gen`."""
    z = torch.randn(b, o, z_dim, generator=gen, device=device)
    eps = torch.randn(b * o, z_dim, generator=gen, device=device)
    return z, eps


def given_draws(draws, bi: int, keys, device):
    """Batch `bi`'s draws from `draws` (one dict a batch, e.g. JAX's) on
    `device`, in the order of `keys`."""
    return tuple(torch.as_tensor(draws[bi][k]).to(device) for k in keys)


def _crops_nchw(crops):
    """(B, O, s, s, 3) crops (views of NCHW ones) -> (B*O, 3, s, s)."""
    return crops.reshape((-1,) + crops.shape[2:]).permute(0, 3, 1, 2)


def make_infer_fns(cfg, models):
    """The two device programs of a batch: the full forward (+ the
    attribute D on its random-z crops), and attribute estimation."""
    g, d_att = models.g, models.d_att

    def forward(batch, z, attribute, attribute_est, eps):
        out = eval_forward(g, batch, z, attribute, attribute_est, eps)
        return out, d_att(_crops_nchw(out["crops_rand"]), False)

    def estimate(imgs, boxes, attribute, valid):
        b, o = valid.shape
        crops = crop_bbox_dense(imgs.permute(0, 3, 1, 2), boxes, cfg.object_size)
        logits = d_att(crops.reshape((b * o,) + crops.shape[2:]), False)
        est = estimate_attributes(logits, attribute.reshape(b * o, -1), valid.reshape(-1))
        return est.reshape(b, o, -1)

    return forward, estimate


def run_inference(
    cfg,
    models,
    loader,
    result_dir: str,
    *,
    device,
    max_batches: int | None = None,
    edit_target: int = DEFAULT_EDIT_TARGET,
    save_images: bool = True,
    draw_boxes: bool = False,
    vocab: dict | None = None,
    seed: int = 0,
    draws=None,
):
    """Returns the attribute precision/recall summary + edit success rate.

    models: the generator `g` and the attribute discriminator `d_att` (a
    train state's `Models`) on `device`; loader: numpy batches in JAX's
    layout. draws: None (from `torch.Generator(device).manual_seed(seed)`)
    or one dict a batch with "z", "eps", "z2", "eps2" (for tests: JAX's)."""
    from scipy.special import expit

    os.makedirs(result_dir, exist_ok=True)
    forward, estimate = make_infer_fns(cfg, models)
    gen = torch.Generator(device).manual_seed(seed)

    metrics = AttributeMetrics()
    n_edit_candidates = 0
    n_edit_success = 0
    with torch.inference_mode(), eval_mode(models.g, models.d_att):
        for bi, batch_np in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            batch = batch_to_torch(batch_np, device)
            b, o = batch_np["objs"].shape
            valid_f = np.asarray(batch_np["valid"]).reshape(-1) > 0
            if draws is None:
                z, eps = forward_draws(gen, b, o, cfg.z_dim, device)
                z2, eps2 = forward_draws(gen, b, o, cfg.z_dim, device)
            else:
                z, eps, z2, eps2 = given_draws(draws, bi, ("z", "eps", "z2", "eps2"), device)

            attribute_est = estimate(batch["imgs"], batch["boxes"], batch["attribute"],
                                     batch["valid"])
            out, att_logits_rand = forward(batch, z, batch["attribute"], attribute_est, eps)
            if bi == 0:
                check_no_grad(out)

            # attribute modification: remove colors, set target (test64.py:170-185).
            # The color-id list and default target are VG's 106-attribute vocab;
            # on smaller vocabs (synthetic corpora) keep only in-range ids so the
            # edit demo still exercises the pipeline instead of crashing.
            att_dim = int(batch["attribute"].shape[-1])
            color_ids = [i for i in COLOR_ATTRIBUTE_IDS if i < att_dim]
            tgt = edit_target if edit_target < att_dim else att_dim - 1
            att_mod, est_mod = batch["attribute"].clone(), attribute_est.clone()
            for a in (att_mod, est_mod):
                if color_ids:
                    a[..., color_ids] = 0
                a[..., tgt] = 1
            out_mod, att_logits_mod = forward(batch, z2, att_mod, est_mod, eps2)

            # attribute precision/recall on annotated objects (sigmoid > 0.9)
            logits = att_logits_rand.float().cpu().numpy()
            logits_mod = att_logits_mod.float().cpu().numpy()
            att_np = np.asarray(batch_np["attribute"]).reshape(b * o, -1)
            annotated = (att_np.sum(-1) > 0) & valid_f
            probs = expit(logits)
            metrics.update((probs[annotated] > 0.9).astype(np.float32), att_np[annotated])

            # success rule: target enters top-3 (modified) and was outside top-5
            top5 = np.argsort(-logits, axis=1)[:, :5]
            top3 = np.argsort(-logits_mod, axis=1)[:, :3]
            candidates = valid_f & ~(top5 == tgt).any(1)
            success = candidates & (top3 == tgt).any(1)
            n_edit_candidates += int(candidates.sum())
            n_edit_success += int(success.sum())

            if save_images:
                _save_batch(result_dir, bi, b, batch, batch_np, out, out_mod,
                            success.reshape(b, o).any(1), draw_boxes, vocab)

    summary = metrics.summary()
    summary["edit_success_rate"] = n_edit_success / max(n_edit_candidates, 1)
    summary["edit_candidates"] = n_edit_candidates
    return summary


def _save_batch(result_dir, bi, b, batch, batch_np, out, out_mod, success_per_img, draw_boxes,
                vocab):
    """The batch's _rand/_shift/_rec/_real PNGs, and the _modified ones of
    the images whose edit succeeded."""
    for name, arr in [
        ("rand", out["img_rand"]),
        ("shift", out["img_shift"]),
        ("rec", out["img_rec"]),
        ("real", batch["imgs"]),
    ]:
        u8 = imagenet_deprocess_batch(arr).cpu().numpy()
        if draw_boxes:  # test_with_boxes_drawn.py capability
            from aglayout_tpu_torch.utils.draw import draw_boxes_batch

            bx = batch_np["boxes_shift" if name == "shift" else "boxes"]
            u8 = draw_boxes_batch(u8, bx, batch_np["valid"], batch_np["objs"], vocab)
        for j in range(b):
            save_png(os.path.join(result_dir, f"img{bi * b + j:06d}_{name}.png"), u8[j])
    for name, arr in [
        ("rand_modified", out_mod["img_rand"]),
        ("rec_modified", out_mod["img_rec"]),
        ("shift_modified", out_mod["img_shift"]),
    ]:
        u8 = imagenet_deprocess_batch(arr).cpu().numpy()
        for j in range(b):
            if success_per_img[j]:
                save_png(os.path.join(result_dir, f"img{bi * b + j:06d}_{name}.png"), u8[j])
