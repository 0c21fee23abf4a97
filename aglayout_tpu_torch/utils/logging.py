"""Metrics logging: stdout lines, TensorBoard scalars and image grids.

Port of `aglayout_tpu/utils/logging.py` (the reference's train64.py:384-402):
the same metric names printed every log_step as `iter [000010/900000],
tag: 1.2345, ...`, TensorBoard scalars and deprocessed uint8 image grids
every tensorboard_step. TensorBoard writes only where the `tensorboard`
package imports.
"""

from __future__ import annotations

import numpy as np
import torch


class MetricLogger:
    def __init__(self, log_dir: str | None, use_tensorboard: bool = True):
        self.writer = None
        if use_tensorboard and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(log_dir)

    def log_stdout(self, step: int, niter: int, metrics: dict):
        line = f"iter [{step:06d}/{niter:06d}]"
        for tag, value in metrics.items():
            line += f", {tag}: {float(value):.4f}"
        print(line, flush=True)

    def log_scalars(self, step: int, metrics: dict):
        if self.writer is None:
            return
        for tag, value in metrics.items():
            self.writer.add_scalar(tag, float(value), step)

    def log_images(self, step: int, images: dict):
        """images: name -> uint8 NHWC array or tensor (already deprocessed)."""
        if self.writer is None:
            return
        for tag, arr in images.items():
            if isinstance(arr, torch.Tensor):
                arr = arr.cpu().numpy()
            self.writer.add_images(tag, np.asarray(arr), step, dataformats="NHWC")

    def close(self):
        if self.writer is not None:
            self.writer.close()
