"""The train step as one captured CUDA graph, replayed a step.

JAX runs its train step, the D update and the G update, as one compiled
program (`aglayout_tpu/train/step.py`); the port's counterpart is a CUDA
graph of `make_train_step`'s function, captured once and replayed. A
replay launches the whole step at once, so the host's gaps between some
19,000 kernels of an eager step go; the device's own time stays.

`GraphedTrainStep(step, state, batch)` captures `step` on `state` and an
example `batch`, and leaves `state` where it was before; called, it has
the eager step's contract, `(state, batch) -> (state, metrics)`, bound to
`state`'s tensors:

  * each batch is copied into static input buffers, which must match the
    example batch's keys, shapes and dtypes;
  * the state's `torch.Generator` is registered with the graph, so that
    replay N draws what eager step N draws;
  * capture needs eager warm-up steps, on `batch` itself as an eager run
    steps on its batches, which move the state (parameters, Adam's
    moments and counts, BN running statistics, spectral-norm u and v, the
    draws, the step); the whole state is snapshotted to the host before
    them and copied back into the same tensors after the capture. A fresh
    state's Adams have no moments before their first step: they get zero
    moments and a count of 0, which is what torch's first eager step finds;
  * the metrics are static buffers that the next replay overwrites: read
    or clone them before it.

In deterministic mode (`utils/device.deterministic`) a replay equals the
eager step bit for bit. It raises, and never runs the eager step in its
place, on the CPU, on a sharded step (`parallel.make_sharded_train_step`'s,
or inside one: `mesh.active()`), when given
`draws` or `mark`, on another state or a batch of another layout, and
when the capture fails. The Adams must be capturable, as
`train/state.adam` makes them on the card.
"""

from __future__ import annotations

import torch

from aglayout_tpu_torch.parallel import mesh
from aglayout_tpu_torch.train.state import TrainState

WARMUP = 3  # eager steps before the capture (cuDNN's and cuBLAS's set-up, Adam's state)


def _layout(batch) -> dict:
    return {k: (tuple(v.shape), v.dtype, v.device) for k, v in batch.items()}


def _state_tensors(state: TrainState) -> list:
    """Every tensor of `state` that a step writes: the nets' parameters and
    buffers, and the Adams' per-parameter state."""
    out = []
    for name, module in state.models.items():
        out += [p.data for p in module.parameters()] + list(module.buffers())
        for s in state.opt[name].state.values():
            out += [v for v in s.values() if isinstance(v, torch.Tensor)]
    return out


@torch.no_grad()
def _restore(state: TrainState, before: list, had_state: dict):
    """Copy the snapshot `before` back into `state`'s tensors; Adam state
    made since, where `had_state` had none, is zeroed (a fresh Adam's)."""
    fresh = []
    for name, opt in state.opt.items():
        for p, s in opt.state.items():
            if id(p) not in had_state[name]:
                fresh += [v for v in s.values() if isinstance(v, torch.Tensor)]
    for t in fresh:
        t.zero_()
    fresh_ids = set(map(id, fresh))
    kept = [t for t in _state_tensors(state) if id(t) not in fresh_ids]
    if len(kept) != len(before):
        raise RuntimeError("graphed train step: the state's tensors changed in the warm-up")
    for t, v in zip(kept, before):
        t.copy_(v)


class GraphedTrainStep:
    """A captured train step; see the module's docstring."""

    def __init__(self, step, state: TrainState, batch: dict):
        if mesh.active() is not None or getattr(step, "group", None) is not None:
            raise RuntimeError("graphed train step: a sharded step is not captured (its "
                               "collectives); run the eager step")
        if state.rng.device.type != "cuda":
            raise RuntimeError("graphed train step: a CUDA graph needs the state on the card")
        for name, opt in state.opt.items():
            if not all(g["capturable"] for g in opt.param_groups):
                raise RuntimeError(f"graphed train step: the {name} Adam is not capturable")
        self.state = state
        self.layout = _layout(batch)
        try:
            self._capture(step, batch)
        except Exception as e:
            raise RuntimeError(f"graphed train step: the capture failed: {e}") from e

    def _capture(self, step, batch):
        state = self.state
        # the snapshot: the tensors a step writes (on the host), the draws,
        # the step, and which parameters have Adam state yet
        before = [t.to("cpu", copy=True) for t in _state_tensors(state)]
        had_state = {name: set(map(id, opt.state)) for name, opt in state.opt.items()}
        rng, step_no = state.rng.get_state(), state.step
        try:
            # as an eager run's first steps: on the current stream, on the
            # caller's batch itself (the static inputs are cloned after), the
            # snapshot on the host. Warmed up on a side stream (64^2), or on a
            # clone of the batch after a snapshot on the card (128^2, TF32),
            # the graph parted at step 2 from an eager run in another
            # process, though it equalled one in its own; an eager run with
            # those clones on the card, or stepping on a clone, did not part
            # (which library choice differs is not known)
            for _ in range(WARMUP):
                step(state, batch)
            self.static = {k: v.clone() for k, v in batch.items()}
            for _, module in state.models.items():
                module.zero_grad(set_to_none=True)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(state.rng)
            with torch.cuda.graph(self.graph):
                _, self.metrics = step(state, self.static)
        finally:
            _restore(state, before, had_state)
            state.rng.set_state(rng)
            state.step = step_no
            torch.cuda.synchronize()

    def __call__(self, state: TrainState, batch: dict, draws=None, mark=None):
        if draws is not None or mark is not None:
            raise ValueError("graphed train step: draws and marks need the eager step")
        if state is not self.state:
            raise ValueError("graphed train step: captured on another state")
        if mesh.active() is not None:
            raise RuntimeError("graphed train step: called inside a sharded step")
        if _layout(batch) != self.layout:
            raise ValueError(f"graphed train step: the batch's layout {_layout(batch)} is not "
                             f"the captured {self.layout}")
        for k, v in batch.items():
            self.static[k].copy_(v)
        self.graph.replay()
        state.step += 1
        return state, self.metrics

