"""The GAN train step: the discriminators' update, then the generator's.

Port of `aglayout_tpu/train/step.py`, in its order (one iteration of the
reference's train64.py:130-414):

  1. draw z ~ N(0, 1) an object; rasterize the masks if the batch has none;
  2. one attribute-D forward on the real crops (spectral-norm iteration on)
     serves both the estimation of unannotated objects' attributes (its
     logits, detached) and the D phase's attribute loss;
  3. swap the attributes of half the objects of the first B//3 images;
  4. one generator forward, with grad (rematerialised in the backward with
     `Config.remat`);
  5. D phase on the detached outputs: each D runs once on the branches
     concatenated along the batch (no BN in the Ds, so this equals the
     reference's separate forwards), one backward, an Adam step each;
  6. G phase: the G losses against the *updated* Ds (no iteration), pulled
     back through the same forward, and G's Adam step. With
     `Config.double_g_forward` the G phase runs a second forward with a
     fresh reparametrisation draw instead, as the reference does (its BN
     statistics then advance twice a step).

The G phase's D forwards leave no gradient on the Ds: the generator's
gradients come from `torch.autograd.grad`. No kernel of the port runs
here: every model is in training mode, where each route is the plain
composition, as JAX's step runs dense XLA.

Run by `parallel.make_sharded_train_step`, the step takes this rank's rows
of the global batch and computes JAX's sharded step: the draws are made
for the global batch from the one seeded generator every rank holds and
sliced; the swap counts the global first B//3 images; each loss is this
rank's share; the BN moments are global (`models/norms.py`); the gradients
are summed over the ranks before each Adam step; the metrics are the
global losses and the grids the global batch's first images.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from aglayout_tpu_torch.config import Config
from aglayout_tpu_torch.ops.bilinear import crop_bbox_dense
from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch
from aglayout_tpu_torch.ops.rasterize import rasterize_boxes
from aglayout_tpu_torch.parallel import mesh
from aglayout_tpu_torch.train.attributes import (
    estimate_attributes,
    swap_attributes,
    swap_draws,
    swap_weights,
)
from aglayout_tpu_torch.train.losses import (
    bce_logits,
    branch_weighted,
    cross_entropy,
    kl_loss,
    masked_l1_image_rec,
    z_rec_loss,
)
from aglayout_tpu_torch.train.state import Models, TrainState


def _nchw(x):
    """An NHWC image (B, H, W, 3) or crop (B, O, s, s, 3) tensor -> NCHW,
    (B*O, 3, s, s) for crops (the generator's outputs are views of these)."""
    if x.ndim == 5:
        x = x.reshape((-1,) + x.shape[2:])
    return x.permute(0, 3, 1, 2)


def make_train_step(cfg: Config, models: Models, matrix, pos_weight):
    """Returns train_step(state, batch, draws=None, mark=None) -> (state,
    metrics); the state is updated in place.

    matrix: (num_classes, attribute_dim) co-occurrence counts; pos_weight:
    (attribute_dim,) the attributes' positive-class weights. batch: tensors
    on the models' device in JAX's layout (`data/synthetic.batch_to_torch`).
    draws: a dict that replaces the state's generator for some draws (for
    tests): "z" (B, O, z_dim), "eps" (B*O, z_dim) the first G forward's
    reparametrisation draw, "eps_g" the second's (`double_g_forward`),
    "swap" (draw1, draw2, two) (`swap_attributes`), each the global
    batch's in a sharded step. mark: called with
    "prep", "g_forward", "d_phase" and "g_phase" as each part ends (the
    bench's timers). metrics: JAX's `D/*` and `G/*` losses as 0-d tensors
    and "images", six uint8 grids of the first 8 images or their crops.
    """
    if cfg.int8_serving:
        raise ValueError("int8_serving is an approximate serving path; training must be exact")
    g, di, do, da = models.g, models.d_image, models.d_object, models.d_att
    dev = next(g.parameters()).device
    matrix = torch.as_tensor(matrix, dtype=torch.float32).to(dev)
    pos_weight = torch.as_tensor(pos_weight, dtype=torch.float32).to(dev)
    g_params = list(g.parameters())
    s_obj = cfg.object_size

    def g_forward(batch, z, att, att_est, eps):
        args = (batch["imgs"], batch["objs"], batch["boxes"], batch["masks"], batch["valid"], z,
                att, batch["masks_shift"], batch["boxes_shift"], att_est, eps)
        if cfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(g, *args, use_reentrant=False,
                                                     preserve_rng_state=False)
        return g(*args)

    def g_losses(out, batch, z, valid_f, objs_f, att_sw, annotated_sw, num_img_to_change, grp,
                 first, total):
        """All G losses of the outputs `out`, against the updated Ds
        (train64.py:283-364); this rank's shares in a sharded step (`grp`,
        its rows the global batch's images `first` on of `total`)."""
        n = valid_f.shape[0]
        g_img_rec = masked_l1_image_rec(out["img_rec"], batch["imgs"], num_img_to_change, first,
                                        total)
        g_z_rec = z_rec_loss(out["z_rand_rec"], out["z_rand_shift"], z.reshape(n, -1), valid_f,
                             grp)
        g_kl = kl_loss(out["mu"], out["logvar"], valid_f)
        imgs = torch.cat([_nchw(out[k]).to(batch["imgs"].dtype)
                          for k in ("img_rec", "img_rand", "img_shift")])
        g_img_adv = branch_weighted(*(bce_logits(x, 1.0, group=grp)
                                      for x in di(imgs, False).chunk(3)))
        crops = torch.cat([_nchw(out[k]) for k in ("crops_input_rec", "crops_rand", "crops_shift")])
        src_all, cls_all = do(crops, False)
        att_all = da(crops, False)
        g_obj_adv = branch_weighted(*(bce_logits(x, 1.0, valid_f, group=grp)
                                      for x in src_all.chunk(3)))
        g_obj_cls = branch_weighted(*(cross_entropy(x, objs_f, valid_f, grp)
                                      for x in cls_all.chunk(3)))
        g_att_cls = branch_weighted(*(bce_logits(x, att_sw, annotated_sw, pos_weight, grp)
                                      for x in att_all.chunk(3)))
        g_loss = (cfg.lambda_img_rec * g_img_rec + cfg.lambda_z_rec * g_z_rec
                  + cfg.lambda_img_adv * g_img_adv + cfg.lambda_obj_adv * g_obj_adv
                  + cfg.lambda_obj_cls * g_obj_cls + cfg.lambda_att_cls * g_att_cls
                  + cfg.lambda_kl * g_kl)
        return g_loss, {
            "G/loss": g_loss,
            "G/image_adv_loss": g_img_adv,
            "G/object_adv_loss": g_obj_adv,
            "G/object_cls_loss": g_obj_cls,
            "G/rec_img": g_img_rec,
            "G/rec_z": g_z_rec,
            "G/kl": g_kl,
            "G/object_att_cls_loss": g_att_cls,
        }

    def train_step(state: TrainState, batch, draws=None, mark=None):
        draws = draws or {}
        mark = mark or (lambda name: None)
        grp = mesh.active()
        rng = state.rng
        b, o = batch["objs"].shape  # this rank's rows in a sharded step
        n = b * o
        # the global batch and this rank's first image in it
        total, first = (b, 0) if grp is None else (b * grp.size, b * grp.rank)
        if "masks" not in batch:
            s = cfg.image_size
            batch = dict(batch, masks=rasterize_boxes(batch["boxes"], s, s)[..., None],
                         masks_shift=rasterize_boxes(batch["boxes_shift"], s, s)[..., None])
        valid_f = batch["valid"].reshape(-1)
        objs_f = batch["objs"].reshape(-1)
        attribute_f = batch["attribute"].reshape(n, -1)

        def draw(name, per_image, shape):
            """The global batch's draw `name` (per_image rows an image), or
            this rank's rows of it in a sharded step."""
            t = draws.get(name)
            t = t if t is not None else torch.randn((total * per_image,) + shape, generator=rng,
                                                    device=dev)
            return t if grp is None else t[first * per_image:(first + b) * per_image]

        z = draw("z", 1, (o, cfg.z_dim))

        # ---- attribute estimation (train64.py:155-166) on one attribute-D
        # forward on the real crops, which the D phase's loss shares
        imgs_nchw = batch["imgs"].permute(0, 3, 1, 2)
        crops_real = crop_bbox_dense(imgs_nchw, batch["boxes"], s_obj).reshape(n, 3, s_obj, s_obj)
        a_real = da(crops_real, True)
        attribute_est = estimate_attributes(a_real.detach(), attribute_f, valid_f)

        # ---- attribute swap (train64.py:169-188)
        swap = draws.get("swap")
        if grp is not None:
            if swap is None:  # drawn for the global batch, from its classes and attributes
                rows = grp.gather(torch.cat([objs_f[:, None].to(attribute_f.dtype), attribute_f], 1))
                swap = swap_draws(swap_weights(matrix, rows[:, 1:], rows[:, 0].long()), rng)
            swap = tuple(t[first * o:(first + b) * o] for t in swap)
        att_sw, att_est_sw, num_img_to_change = swap_attributes(
            matrix, attribute_f, attribute_est, objs_f, valid_f, total, o, generator=rng,
            draws=swap, first=first)
        annotated_gt = (attribute_f.sum(-1) > 0) & (valid_f > 0)
        annotated_sw = (att_sw.sum(-1) > 0) & (valid_f > 0)
        g_in = (z, att_sw.view(b, o, -1), att_est_sw.view(b, o, -1))
        mark("prep")

        eps_d = draw("eps", o, (cfg.z_dim,))
        if cfg.double_g_forward:
            with torch.no_grad():
                out = g_forward(batch, *g_in, eps_d)
        else:
            out = g_forward(batch, *g_in, eps_d)
        mark("g_forward")

        # =========================== D phase ===========================
        sg = {k: v.detach() for k, v in out.items()}
        d_att_cls = bce_logits(a_real, attribute_f, annotated_gt, pos_weight, grp)
        imgs = torch.cat([_nchw(sg[k]).to(imgs_nchw.dtype) for k in ("img_rec", "img_rand", "img_shift")]
                         + [imgs_nchw])
        l_rec, l_rand, l_shift, l_real = di(imgs, True).chunk(4)
        d_img_fake = branch_weighted(*(bce_logits(x, 0.0, group=grp)
                                       for x in (l_rec, l_rand, l_shift)))
        d_img_real = bce_logits(l_real, 1.0, group=grp)
        crops = torch.cat([_nchw(sg[k]) for k in ("crops_input_rec", "crops_rand", "crops_shift",
                                                  "crops_input")])
        src_all, cls_all = do(crops, True)
        s_rec, s_rand, s_shift, s_real = src_all.chunk(4)
        d_obj_fake = branch_weighted(*(bce_logits(s, 0.0, valid_f, group=grp)
                                       for s in (s_rec, s_rand, s_shift)))
        d_obj_real = bce_logits(s_real, 1.0, valid_f, group=grp)
        d_obj_cls = cross_entropy(cls_all[3 * n:], objs_f, valid_f, grp)
        d_loss = (cfg.lambda_img_adv * (d_img_fake + d_img_real)
                  + cfg.lambda_obj_adv * (d_obj_fake + d_obj_real)
                  + cfg.lambda_obj_cls * d_obj_cls + cfg.lambda_att_cls * d_att_cls)
        d_opts = [state.opt[name] for name in ("d_image", "d_object", "d_att")]
        for opt in d_opts:
            opt.zero_grad(set_to_none=True)
        d_loss.backward()  # the attribute D's through its real-crop forward too
        if grp is not None:
            grp.sum_grads([p for m in (di, do, da) for p in m.parameters()])
        for opt in d_opts:
            opt.step()
        mark("d_phase")

        # =========================== G phase ===========================
        if cfg.double_g_forward:
            out = g_forward(batch, *g_in, draw("eps_g", o, (cfg.z_dim,)))
        # the G forward's running statistics: a remat backward's
        # recomputation runs the BNs again, and they go back to these after it
        saved = [t.clone() for t in g.buffers()] if cfg.remat else None
        g_loss, g_metrics = g_losses(out, batch, z, valid_f, objs_f, att_sw, annotated_sw,
                                     num_img_to_change, grp, first, total)
        grads = torch.autograd.grad(g_loss, g_params, allow_unused=True)
        if saved is not None:
            with torch.no_grad():
                for t, v in zip(g.buffers(), saved):
                    t.copy_(v)
        for p, gr in zip(g_params, grads):
            p.grad = gr if gr is not None else torch.zeros_like(p)
        if grp is not None:
            grp.sum_grads(g_params)
        state.opt["g"].step()
        mark("g_phase")
        state.step += 1

        gi = min(8, total)
        shown = {
            "img_real": batch["imgs"],
            "crop_real": out["crops_input"],
            "crop_real_rec": out["crops_input_rec"],
            "crop_rand": out["crops_rand"],
            "img_real_rec": out["img_rec"],
            "img_fake_rand": out["img_rand"],
        }
        if grp is not None:  # the global batch's first gi images, in one collective
            flat = grp.gather(torch.cat([v.detach().float().reshape(b, -1) for v in shown.values()],
                                        1), gi)
            parts = flat.split([v[0].numel() for v in shown.values()], 1)
            shown = {k: p.reshape((gi,) + v.shape[1:]) for (k, v), p in zip(shown.items(), parts)}

        def grid(x):
            x = x.detach()[:gi]
            return imagenet_deprocess_batch(x.reshape((-1,) + x.shape[-3:]))

        images = {k: grid(v) for k, v in shown.items()}
        metrics = {
            "D/loss": d_loss,
            "D/image_adv_loss_real": d_img_real,
            "D/image_adv_loss_fake": d_img_fake,
            "D/object_adv_loss_real": d_obj_real,
            "D/object_adv_loss_fake": d_obj_fake,
            "D/object_cls_loss_real": d_obj_cls,
            "D/object_att_cls_loss": d_att_cls,
            **g_metrics,
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        if grp is not None:  # the global losses: the sums of the ranks' shares
            summed = grp.global_sum(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, summed.unbind()))
        return state, {**metrics, "images": images}

    return train_step
