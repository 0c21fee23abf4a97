"""GAN losses with the reference's semantics under dense padded objects.

Port of `aglayout_tpu/train/losses.py` (train64.py / train128.py):
non-saturating sigmoid cross-entropy adversarial losses, the 0.4/0.4/0.2
rec/rand/shift branch weighting, pos-weighted attribute BCE restricted to
annotated objects, masked L1 image reconstruction without the
attribute-swapped images, latent reconstruction L1 and the VAE KL term.
The reference's flat object tensors hold only real objects, so its plain
means become means over the valid rows here; the KL term is a *sum* over
real objects (train64.py:294-295). Every loss computes in f32.

Each takes the `group` of a sharded step (`parallel/mesh.py`), None in one
process: there it is this rank's share of the global loss, its numerator
over the global batch's denominator, so that the sum over the ranks is the
loss of the global batch (the KL, a sum, needs nothing).
"""

from __future__ import annotations

import torch


def _total(count, group):
    """`count` summed over the ranks of `group` (None: itself)."""
    return count if group is None else group.global_sum(count)


def bce_logits(logits, target, weight=None, pos_weight=None, group=None):
    """binary_cross_entropy_with_logits, the mean over the rows `weight`
    (N,) keeps (each of them counting all its features), or over all
    elements without it. target: a constant or a tensor; pos_weight (A,)
    multiplies the positive term per feature (torch's semantics)."""
    logits = logits.float()
    # a constant fills on the device: no host-to-device copy inside the step
    target = (target.to(logits.device, torch.float32).expand_as(logits)
              if isinstance(target, torch.Tensor) else torch.full_like(logits, target))
    soft = torch.log1p(torch.exp(-logits.abs()))
    log_sig = soft + torch.clamp(-logits, min=0.0)  # -log sigmoid(x)
    log_one_minus = soft + torch.clamp(logits, min=0.0)  # -log(1 - sigmoid(x))
    pw = 1.0 if pos_weight is None else pos_weight.float()
    loss = pw * target * log_sig + (1.0 - target) * log_one_minus
    if weight is None:
        # every rank holds as many rows (`Group.rows`)
        return loss.mean() if group is None else loss.sum() / (loss.numel() * group.size)
    w = weight.float()
    w = w.view(w.shape + (1,) * (loss.ndim - w.ndim))
    denom = _total(w.sum(), group) * (loss.numel() / w.numel())
    return (loss * w).sum() / torch.clamp(denom, min=1.0)


def cross_entropy(logits, labels, weight=None, group=None):
    """F.cross_entropy, the mean over the rows `weight` (N,) keeps."""
    logits = logits.float()
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if weight is None:
        return nll.mean() if group is None else nll.sum() / (nll.numel() * group.size)
    w = weight.float()
    return (nll * w).sum() / torch.clamp(_total(w.sum(), group), min=1.0)


def masked_l1_image_rec(img_rec, imgs, num_img_to_change: int, first: int = 0,
                        total: int | None = None):
    """L1 reconstruction over the images from num_img_to_change on (the
    first ones had their attributes swapped), normalised by their count
    (train64.py:284-287). In a sharded step `imgs` are the global batch's
    images first .. first + B - 1 of `total`."""
    b = imgs.shape[0]
    total = b if total is None else total
    per_image = (img_rec.float() - imgs.float()).abs().reshape(b, -1).mean(1)
    keep = (torch.arange(first, first + b, device=imgs.device) >= num_img_to_change).float()
    return (per_image * keep).sum() / (total - num_img_to_change)


def z_rec_loss(z_rand_rec, z_rand_shift, z, valid_flat, group=None):
    """0.5 L1(z_rand_rec, z) + 0.5 L1(z_rand_shift, z), means over the valid
    rows (train64.py:289-291)."""
    w = valid_flat.float()[:, None]
    denom = torch.clamp(_total(w.sum(), group) * z.shape[-1], min=1.0)
    rand = ((z_rand_rec - z).abs() * w).sum() / denom
    shift = ((z_rand_shift - z).abs() * w).sum() / denom
    return 0.5 * rand + 0.5 * shift


def kl_loss(mu, logvar, valid_flat):
    """-0.5 sum(1 + logvar - mu^2 - exp(logvar)) over the valid rows (a
    sum, train64.py:294-295)."""
    mu, logvar = mu.float(), logvar.float()
    elt = 1.0 + logvar - mu * mu - torch.exp(logvar)
    return -0.5 * (elt * valid_flat.float()[:, None]).sum()


def branch_weighted(rec, rand, shift):
    """The 0.4/0.4/0.2 rec/rand/shift weighting of every adversarial and
    auxiliary loss across branches (train64.py:208,229,313,351-354)."""
    return 0.4 * rec + 0.4 * rand + 0.2 * shift
