"""Train state: the four networks, their optimizers, the draws and the step.

Port of `aglayout_tpu/train/state.py`. The modules hold their own
parameters and statistics (JAX's `NetState.params` and `.stats`), each
`torch.optim.Adam` its moments and count (`NetState.opt`), and a
`torch.Generator` on the device the random draws (`TrainState.rng`), so a
checkpoint of all of them resumes exactly.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from aglayout_tpu_torch.config import Config
from aglayout_tpu_torch.models import build_discriminators, build_generator
from aglayout_tpu_torch.models.norms import MaskedBatchNorm

NETS = ("g", "d_image", "d_object", "d_att")  # JAX TrainState's names


@dataclasses.dataclass
class Models:
    """The generator and the image, object and attribute discriminators."""

    g: nn.Module
    d_image: nn.Module
    d_object: nn.Module
    d_att: nn.Module

    def items(self):
        return [(name, getattr(self, name)) for name in NETS]


@dataclasses.dataclass
class TrainState:
    models: Models
    opt: dict  # NETS name -> torch.optim.Adam
    rng: torch.Generator
    step: int = 0


def build_models(cfg: Config, device, seed: int = 0) -> Models:
    """The four nets of `cfg` on `device`, in training mode: the generator's
    weights drawn from `seed`, the discriminators' from seed + 1. Every
    batch norm of the generator starts where JAX's does (mean 0, variance
    1, weight 1, bias 0), not at `build_generator`'s drawn serving state."""
    g = build_generator(cfg, device, seed=seed).train()
    for m in g.modules():
        if isinstance(m, MaskedBatchNorm):
            m.reset_parameters()
    return Models(g, *(d.train() for d in build_discriminators(cfg, device, seed=seed + 1)))


def adam(cfg: Config, module: nn.Module) -> torch.optim.Adam:
    """Adam(lr, betas=(0.5, 0.999), eps=1e-8) for every net (train64.py:111-114)."""
    return torch.optim.Adam(module.parameters(), lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=1e-8)


def create_train_state(cfg: Config, device, seed: int = 0) -> TrainState:
    """A fresh state: `build_models(cfg, device, seed)`, an Adam each, and
    the draws' generator on `device` seeded with seed + 2."""
    models = build_models(cfg, device, seed)
    rng = torch.Generator(device=device).manual_seed(seed + 2)
    return TrainState(models, {name: adam(cfg, m) for name, m in models.items()}, rng)


def param_count(state: TrainState) -> dict:
    return {name: sum(p.numel() for p in m.parameters()) for name, m in state.models.items()}
