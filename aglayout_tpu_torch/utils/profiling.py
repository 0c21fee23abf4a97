"""Profiling helpers: a trace context, a timing harness, anomaly checks.

Port of `aglayout_tpu/utils/profiling.py`:

  * `trace(logdir)`: `torch.profiler` around a block (the train loop under
    `python -m aglayout_tpu_torch.train --profile DIR`), written to
    DIR/trace.json as a Chrome trace (chrome://tracing, Perfetto);
  * `timed`: seconds a call, synchronising the card around the timed calls;
  * `enable_nan_debugging`: autograd's anomaly mode (JAX's `jax_debug_nans`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed(fn, *args, iters: int = 20, warmup: int = 3):
    """Returns (seconds_per_call, last_output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters, out


def enable_nan_debugging():
    torch.autograd.set_detect_anomaly(True)
