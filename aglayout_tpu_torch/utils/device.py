"""The device of an entry point, f32 with or without TF32 on the card, and torch's
deterministic algorithms.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU; `require` raises where the card asked for is missing, so that
no run falls back to the host on its own.
"""

from __future__ import annotations

import contextlib
import os

import torch

CUBLAS_WORKSPACE_CONFIG = ":4096:8"  # cuBLAS's fixed workspaces, which make it repeat itself


def require(device, what: str) -> torch.device:
    """`device` as a `torch.device`; raises where it is CUDA and no card is
    present (`what` names the caller in the message)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (pass --device cpu to run on the host)")
    return device


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS and cuDNN f32 products with TF32 on or off for the body, both
    flags restored afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def no_tf32():
    """cuBLAS and cuDNN f32 products without TF32 for the body (a metric's
    network: FID must not move with the card's rounding mode)."""
    return tf32(False)


@contextlib.contextmanager
def deterministic(warn_only: bool = False):
    """`torch.use_deterministic_algorithms(True, warn_only=warn_only)` for
    the body, with `CUBLAS_WORKSPACE_CONFIG` set: cuBLAS reads it when it
    makes a handle's workspace, so enter before the process's first
    product on the card. Where an op has no deterministic CUDA form it
    raises, or with `warn_only` warns."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
