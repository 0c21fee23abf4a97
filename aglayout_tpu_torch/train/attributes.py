"""Attribute estimation and swapping as masked tensor operations.

Port of `aglayout_tpu/train/attributes.py`: the reference does both with
host-side row loops every iteration (train64.py:155-188); here they run on
the device inside the train step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def estimate_attributes(att_logits, attribute, valid):
    """Objects with no annotated attribute get the attribute D's argmax on
    their real crop (train64.py:155-166). att_logits, attribute (N, A);
    valid (N,). Returns attribute_est (N, A)."""
    need = (attribute.sum(-1) <= 0) & (valid > 0)
    add = F.one_hot(att_logits.argmax(-1), attribute.shape[-1]).to(attribute.dtype)
    return torch.where(need[:, None], torch.maximum(attribute, add), attribute)


def swap_weights(matrix, attribute, objs):
    """The swap's draw weights (N, A): each row's class <-> attribute
    co-occurrence counts with its old attributes zeroed; a row whose
    weights vanish draws uniformly (the reference would raise)."""
    weights = matrix[objs] * (1.0 - attribute)
    safe = torch.where(weights.sum(-1, keepdim=True) > 0, weights, torch.ones_like(weights))
    return torch.clamp(safe, min=1e-20)


def swap_draws(weights, generator=None):
    """The swap's random draws for (N, A) non-negative weights: two
    attribute ids drawn in proportion to each row's weights, and whether
    the row takes both (a fair coin)."""
    draw1 = torch.multinomial(weights, 1, generator=generator)[:, 0]
    draw2 = torch.multinomial(weights, 1, generator=generator)[:, 0]
    two = torch.rand(weights.shape[0], generator=generator, device=weights.device) < 0.5
    return draw1, draw2, two


def swap_attributes(matrix, attribute, attribute_est, objs, valid, batch_size: int, o_max: int,
                    generator=None, draws=None, first: int = 0):
    """Re-sample attributes for half the objects of the first B//3 images
    (train64.py:169-188): for each image i < B//3, its first floor(n_i / 2)
    valid objects get one or two new attributes drawn from the class <->
    attribute co-occurrence `matrix` (num_classes, A) with their old
    attributes' weights zeroed, in both `attribute` and `attribute_est`.

    attribute, attribute_est (N = B*O, A); objs, valid (N,). The draws come
    from `generator`, or are given as `draws` = (draw1, draw2, two), each
    (N,) (for tests, and for a sharded step, which draws for the global
    batch). In a sharded step the rows are the global batch's images
    `first` on and `batch_size` is the global B. Returns (attribute,
    attribute_est, num_img_to_change).
    """
    n, a = attribute.shape
    num_img_to_change = batch_size // 3
    idx = torch.arange(n, device=attribute.device)
    img_idx, slot_idx = idx // o_max, idx % o_max
    half = torch.floor(valid.reshape(-1, o_max).sum(1) / 2.0)
    change = (img_idx < num_img_to_change - first) & (slot_idx < half[img_idx]) & (valid > 0)

    draw1, draw2, two = draws if draws is not None else swap_draws(
        swap_weights(matrix, attribute, objs), generator)
    new_att = F.one_hot(draw1.long(), a).to(attribute.dtype)
    new_att = torch.clamp(
        new_att + two.to(attribute.dtype)[:, None] * F.one_hot(draw2.long(), a).to(attribute.dtype),
        0, 1)
    attribute_out = torch.where(change[:, None], new_att, attribute)
    attribute_est_out = torch.where(change[:, None], new_att, attribute_est)
    return attribute_out, attribute_est_out, num_img_to_change
