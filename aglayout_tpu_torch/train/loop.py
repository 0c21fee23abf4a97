"""The training loop: data -> train step -> logging -> checkpoints.

Port of `aglayout_tpu/train/loop.py` (the reference's train64.py and
train128.py, one binary, the resolution set by the config). Artifact
directories follow the reference's exp_name convention (train64.py:69-79):
{path}/all/{logs,models,samples,results}/{exp_name}. Under `python -m
torch.distributed.run` (a process group joined by
`parallel.maybe_init_distributed`) the loop trains data-parallel: every
rank restores the same checkpoint and reads the same global batch, moves
its rows to its device and runs the sharded step; rank 0 alone writes the
log, TensorBoard and checkpoints, and the ranks agree each step whether a
preemption signal came, so that all save and stop at the same step.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import warnings

import numpy as np
import torch

from aglayout_tpu_torch.config import Config
from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.data.vocab import attribute_pos_weight
from aglayout_tpu_torch.parallel import Group, make_sharded_train_step
from aglayout_tpu_torch.train.state import create_train_state
from aglayout_tpu_torch.train.step import make_train_step
from aglayout_tpu_torch.utils.checkpoint import restore_state, save_state
from aglayout_tpu_torch.utils.device import require
from aglayout_tpu_torch.utils.logging import MetricLogger


def prepare_dirs(cfg: Config) -> dict:
    dirs = {}
    for kind in ("logs", "models", "samples", "results"):
        d = os.path.join(cfg.path, "all", kind, cfg.exp_name)
        os.makedirs(d, exist_ok=True)
        dirs[kind] = d
    return dirs


def load_cooccurrence(cfg: Config) -> np.ndarray:
    """Object<->attribute co-occurrence counts (the reference's
    matrix_obj_vs_att.pt; built by `python -m aglayout_tpu_torch.data.cooccurrence`)."""
    path = os.path.join(cfg.vg_dir, "matrix_obj_vs_att.npy")
    if os.path.exists(path):
        return np.load(path)
    # A missing matrix changes training (attribute swaps sample uniformly
    # instead of from the co-occurrence statistics): refuse unless allowed.
    if not cfg.allow_uniform_matrix:
        raise FileNotFoundError(
            f"co-occurrence matrix not found at {path}. Build it with "
            "`python -m aglayout_tpu_torch.data.cooccurrence` over the train h5, "
            "or pass --allow_uniform_matrix true to accept uniform "
            "attribute-swap sampling (changes training semantics)."
        )
    warnings.warn(
        f"co-occurrence matrix missing at {path}: attribute swaps will "
        "sample UNIFORMLY (allow_uniform_matrix=true). Not equivalent to "
        "the reference's matrix_obj_vs_att.pt sampling.",
        stacklevel=2,
    )
    return np.ones((cfg.num_classes, cfg.attribute_dim), np.float32)


def make_step(cfg: Config, state):
    """The loop's train step for `state`: the co-occurrence matrix of
    `load_cooccurrence`, and VG's 106-attribute pos-weight table
    (train64.py:24-28), or uniform weights for another vocabulary
    (synthetic smoke configs)."""
    pos_weight = (
        attribute_pos_weight()
        if cfg.attribute_dim == 106
        else np.ones(cfg.attribute_dim, np.float32)
    )
    return make_train_step(cfg, state.models, load_cooccurrence(cfg), pos_weight)


class Preemption:
    """SIGTERM/SIGINT set a flag that the loop reads after each step; a
    second signal puts the previous handlers back and raises the signal
    again, so a run that does not stop in time can still be interrupted.
    Python takes signal handlers on the main thread only: elsewhere nothing
    is installed and the flag stays down."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.signum = None
        self._prev = {}
        if threading.current_thread() is threading.main_thread():
            self._prev = {s: signal.signal(s, self._on_signal) for s in self.SIGNALS}

    def _on_signal(self, signum, frame):
        if self.signum is not None:
            self.restore()
            signal.raise_signal(signum)
            return
        self.signum = signum

    def restore(self):
        for s, handler in self._prev.items():
            signal.signal(s, signal.SIG_DFL if handler is None else handler)
        self._prev = {}


def train(cfg: Config, loader=None, niter: int | None = None, use_tensorboard: bool = True,
          window_rates: list | None = None, device="cuda"):
    """Run training on `device` ("cuda" unless the caller asks for the
    CPU); returns (state, the last step's metrics). `loader` defaults to
    the Visual Genome pipeline (`data/dataset.get_dataloaders`, which also
    sets `cfg.num_classes` from the vocab); any iterator of numpy batches in
    JAX's layout will do (the synthetic stream). If `window_rates` is a
    list, each log window's steps/s is appended to it. In a process group
    (`parallel.maybe_init_distributed`) it trains data-parallel over all
    its ranks, `cfg.batch_size` being the global batch."""
    group = Group()
    if cfg.num_devices not in (0, group.size):
        raise ValueError(
            f"train: num_devices={cfg.num_devices}, but this process group has {group.size} "
            "rank(s) (0 takes them all); launch one process a device with `python -m "
            "torch.distributed.run --nproc_per_node N -m aglayout_tpu_torch.train ...`")
    device = require(device, "train")
    if group.on and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    lead = group.rank == 0  # writes the log, TensorBoard and checkpoints
    dirs = prepare_dirs(cfg)

    if loader is None:
        from aglayout_tpu_torch.data import native
        from aglayout_tpu_torch.data.dataset import get_dataloaders

        loader, _, vocab = get_dataloaders(cfg)
        cfg.num_classes = len(vocab["object_idx_to_name"])
        why = "" if loader.batch_path == "native" else f": {native.load_error()}"
        print(f"[data] {cfg.vg_dir}: {len(loader.ds)} train images, "
              f"{loader.batch_path} batch path{why}", flush=True)

    state = create_train_state(cfg, device, seed=cfg.seed)
    state, start = restore_state(dirs["models"], state, cfg.resume)
    step_fn = make_step(cfg, state)
    if group.on:
        step_fn = make_sharded_train_step(step_fn, group)

    logger = MetricLogger(dirs["logs"] if lead else None, use_tensorboard)
    niter = niter or cfg.niter
    it = iter(loader)
    metrics = {}
    # Config.device_masks: the step rasterizes the layout masks from the
    # boxes on the device, so they never cross from the host
    drop = ("masks", "masks_shift") if cfg.device_masks else ()

    def prep(b):
        return batch_to_torch(group.rows({k: v for k, v in b.items() if k not in drop}), device)

    # Preemption save (the reference's elasticity is SLURM's 24 h limit and
    # a resubmit, losing up to save_step steps): the loop finishes the
    # in-flight step, saves, and returns, so `--resume l` continues there.
    preempt = Preemption()
    try:
        # one-batch prefetch: the next batch's copy from pinned memory is
        # queued before the step, without blocking the host
        pending = prep(next(it))
        t0 = time.time()
        for i in range(start, niter):
            batch = pending
            state, metrics = step_fn(state, batch)
            # every rank stops at the step where the first of them was signalled
            if group.any(preempt.signum is not None, device):
                if lead:
                    save_state(dirs["models"], i + 1, state, cfg.save_num)
                    sig = preempt.signum or "on another rank"
                    print(f"[preempt] signal {sig}: saved checkpoint at step {i + 1}, exiting",
                          flush=True)
                break
            if i + 1 < niter:
                pending = prep(next(it))

            if (i + 1) % cfg.log_step == 0:
                m = {k: float(v) for k, v in metrics.items() if k != "images"}
                m["steps_per_sec"] = cfg.log_step / (time.time() - t0)
                if window_rates is not None:
                    window_rates.append(m["steps_per_sec"])
                t0 = time.time()
                if lead:
                    logger.log_stdout(i + 1, niter, m)
            if (i + 1) % cfg.tensorboard_step == 0:
                logger.log_scalars(
                    i + 1, {k: float(v) for k, v in metrics.items() if k != "images"})
                # the real and generated grids, the reference's tags
                # (train64.py:394-402), from the step's own G forward
                logger.log_images(
                    i + 1, {f"Result/{k}": v for k, v in metrics["images"].items()})
            if (i + 1) % cfg.save_step == 0 and lead:
                save_state(dirs["models"], i + 1, state, cfg.save_num)
    finally:
        preempt.restore()
        logger.close()
    return state, metrics
