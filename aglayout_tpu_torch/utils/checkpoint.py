"""Checkpoints of the whole train state: one `torch.save` file a step.

Port of `aglayout_tpu/utils/checkpoint.py` without orbax. A checkpoint
holds every net's `state_dict` (params, spectral-norm u and v, BN running
statistics and `num_batches_tracked`), every Adam's `state_dict`, the
draws' generator state and the step, so a resumed run continues the
interrupted one exactly. The reference's resume contract
(utils/model_saver_iter.py:6-65): 'l' latest, 's' scratch, or a step.
"""

from __future__ import annotations

import os
import re

import torch

from aglayout_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"step_{step}.pt")


def saved_steps(model_dir: str) -> list:
    """The steps with a checkpoint in `model_dir`, ascending ([] when the
    directory is missing)."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(model_dir)) if m)


def save_state(model_dir: str, step: int, state: TrainState, save_num: int = 2) -> str:
    """Write `state` as the checkpoint of `step` and keep the newest
    `save_num` checkpoints (orbax's `max_to_keep`). The file is written
    under a temporary name and renamed, so a save cut short leaves no file
    that a resume would pick. Returns the checkpoint's path."""
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "step": step,
        "nets": {name: m.state_dict() for name, m in state.models.items()},
        "opt": {name: opt.state_dict() for name, opt in state.opt.items()},
        "rng": state.rng.get_state(),
    }
    path = checkpoint_path(model_dir, step)
    tmp = os.path.join(model_dir, f".step_{step}.pt.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in saved_steps(model_dir)[:-save_num]:
        os.remove(checkpoint_path(model_dir, old))
    return path


def restore_state(model_dir: str, state: TrainState, resume: str = "l"):
    """Load a checkpoint into `state` in place: resume 'l' the latest
    (scratch when there is none or `model_dir` is missing), 's' scratch, or
    a step, which must exist. Returns (state, start_step)."""
    if resume == "s":
        return state, 0
    if resume == "l":
        steps = saved_steps(model_dir)
        if not steps:
            return state, 0
        step = steps[-1]
    else:
        step = int(resume)
        if step not in saved_steps(model_dir):
            raise FileNotFoundError(f"no checkpoint of step {step} in {model_dir}")
    device = state.rng.device
    payload = torch.load(checkpoint_path(model_dir, step), map_location=device, weights_only=True)
    for name, m in state.models.items():
        m.load_state_dict(payload["nets"][name])
    for name, opt in state.opt.items():
        sd = payload["opt"][name]
        # the optimizer keeps its own kind whichever kind saved: a capturable
        # Adam (the card's) takes its f32 step counts onto the device, another
        # keeps them on the CPU, where map_location may have moved them from
        capturable = opt.param_groups[0]["capturable"]
        for group in sd["param_groups"]:
            group["capturable"] = capturable
        for s in sd["state"].values():
            s["step"] = s["step"].to(device if capturable else "cpu", torch.float32)
        opt.load_state_dict(sd)
    state.rng.set_state(payload["rng"].cpu())
    state.step = payload["step"]
    return state, step
