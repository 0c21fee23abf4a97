"""The device of an entry point, and f32 without TF32 on the card.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU; `require` raises where the card asked for is missing, so that
no run falls back to the host on its own.
"""

from __future__ import annotations

import contextlib

import torch


def require(device, what: str) -> torch.device:
    """`device` as a `torch.device`; raises where it is CUDA and no card is
    present (`what` names the caller in the message)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (pass --device cpu to run on the host)")
    return device


@contextlib.contextmanager
def no_tf32():
    """cuBLAS and cuDNN f32 products without TF32 for the body (a metric's
    network: FID must not move with the card's rounding mode)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
