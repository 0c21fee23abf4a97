"""Data parallelism over a `torch.distributed` process group.

Port of `aglayout_tpu/parallel/mesh.py`. JAX's GSPMD semantics are kept,
written out with explicit collectives instead of DDP's averaging: the
state is replicated (every rank builds or restores the same one), the
batch is split on axis 0 (each rank holds its contiguous rows,
`Group.rows`), and every batch reduction of the train step is a reduction
over the global batch:

  * BatchNorm's moments: each rank's sums, sums of squares and counts are
    all-reduced with autograd (`Group.moments`), so gradients flow back
    through them to every rank, as in SyncBN (`models/norms.py`, and the
    closed-form bn1 moments of `models/generator.py`);
  * each loss is this rank's share of the global loss: its numerator over
    the global denominator (`train/losses.py`), so the sum over the ranks
    is the global loss and the summed gradients are its gradients;
  * the gradients are summed over the ranks in flat buckets
    (`Group.sum_grads`), not averaged.

The train step and the models find the group through `active()`, which
`make_sharded_train_step` sets for the length of a step; with none active
they run the one-process code, with no collective. JAX's `make_mesh`,
`replicated`, `batch_sharding` and `shard_batch` have no counterpart here:
replicated state is what every rank builds, and a rank's share of a batch
is `Group.rows`. `maybe_init_distributed` joins the group that `python -m
torch.distributed.run` describes in the environment (JAX's env hook).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

# the Group of the running sharded step: a global, not a thread-local, as a
# remat backward recomputes the forward on autograd's own thread
_ACTIVE = None
_BUCKET = 1 << 24  # elements a flat gradient bucket holds at most


def maybe_init_distributed(device="cuda", backend: str | None = None):
    """Join the process group that torch's launcher (`python -m
    torch.distributed.run`) describes in RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR/MASTER_PORT; returns its `Group`, or None when the process
    was not launched so. The backend is NCCL for a CUDA device and gloo on
    the CPU unless `backend` names one (gloo lets two ranks share one
    card, which NCCL refuses). On CUDA the rank's device is cuda:LOCAL_RANK.
    A failure to join raises: a launched rank never trains alone."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return Group()


class Group:
    """This rank's place in a process group (`pg`, the default group when
    None), and the collectives the sharded step needs. Without an
    initialised process group it is the one-process identity: rank 0 of 1,
    every operation a no-op."""

    def __init__(self, pg=None):
        self.pg = pg
        self.on = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank(pg) if self.on else 0
        self.size = dist.get_world_size(pg) if self.on else 1

    def rows(self, batch):
        """This rank's contiguous rows (axis 0) of a global batch: a tensor
        or array, or a dict or list of them. Refuses a batch the ranks do
        not divide, as JAX's batch sharding does."""
        if isinstance(batch, dict):
            return {k: self.rows(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self.rows(v) for v in batch)
        n = batch.shape[0]
        if n % self.size:
            raise ValueError(f"a global batch of {n} does not split evenly over {self.size} ranks")
        b = n // self.size
        return batch[self.rank * b:(self.rank + 1) * b]

    def global_sum(self, t):
        """The sum of `t` over the ranks, differentiable: the gradient of
        each rank's input is the sum of the ranks' output gradients."""
        return _SumOverRanks.apply(t, self.pg) if self.on else t

    def moments(self, s1, s2, cnt):
        """(mean, biased var, count) over the global batch from this rank's
        per-channel sums `s1`, sums of squares `s2` and count (a 0-d tensor
        or a number)."""
        # a number goes in by a fill: a copy from pageable host memory would
        # wait for the device's queue to drain
        c = cnt.reshape(1).to(s1.dtype) if torch.is_tensor(cnt) else s1.new_full((1,), cnt)
        tot = self.global_sum(torch.cat([s1, s2, c]))
        c = tot[-1].detach()
        mean, mean2 = tot[: s1.numel()] / c, tot[s1.numel(): -1] / c
        return mean, mean2 - mean * mean, c

    def sum_grads(self, params):
        """Sum each parameter's gradient over the ranks, in place, a flat
        bucket of at most 2^24 elements of one dtype and device at a time."""
        if not self.on:
            return
        buckets, size = {}, {}
        for g in (p.grad for p in params if p.grad is not None):
            key = (g.dtype, g.device)
            if size.get(key, 0) + g.numel() > _BUCKET and buckets.get(key):
                self._sum_flat(buckets.pop(key))
                size[key] = 0
            buckets.setdefault(key, []).append(g)
            size[key] = size.get(key, 0) + g.numel()
        for bucket in buckets.values():
            self._sum_flat(bucket)

    def _sum_flat(self, grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.pg)
        off = 0
        for g in grads:
            g.copy_(flat[off: off + g.numel()].view_as(g))
            off += g.numel()

    def any(self, flag: bool, device) -> bool:
        """Whether `flag` is set on any rank (an all-reduce MAX on `device`)."""
        if not self.on:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        return bool(t.item())

    def gather(self, t, limit: int | None = None):
        """The global batch of `t` (this rank's rows on axis 0, every rank
        holding as many) in rank order, on every rank; only its first
        `limit` rows where given. One all-reduce of a zeroed global buffer
        that each rank fills with its rows: gloo reduces CUDA tensors but
        does not gather them. bf16 and f16 travel as f32 (exactly)."""
        if not self.on:
            return t if limit is None else t[:limit]
        b = t.shape[0]
        n = b * self.size if limit is None else min(limit, b * self.size)
        wire = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
        out = torch.zeros((n,) + tuple(t.shape[1:]), dtype=wire, device=t.device)
        lo = self.rank * b
        if lo < n:
            out[lo: min(lo + b, n)] = t[: min(b, n - lo)]
        dist.all_reduce(out, group=self.pg)
        return out.to(t.dtype)


class _SumOverRanks(torch.autograd.Function):
    """`torch.distributed.nn.functional.all_reduce` with SUM, written out
    (torch 2.13 deprecates that function): the backward all-reduces the
    output's gradient, as SyncBN's does."""

    @staticmethod
    def forward(ctx, t, pg):
        ctx.pg = pg
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=pg)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.pg)
        return grad, None


def active():
    """The `Group` of the sharded step running now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def sharded(group: Group):
    """Make `group` the active one for the body."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, group
    try:
        yield group
    finally:
        _ACTIVE = prev


def make_sharded_generate(generator, group: Group):
    """Data-parallel serving (JAX `make_sharded_generate`): returns
    generate(objs, boxes, valid, z, attribute) of a global batch, each
    rank running the eval `Generator.generate` (its kernels on) on its rows
    and every rank receiving the images of the whole batch in rank order.
    Eval generate treats each sample alone, so the result is the
    one-process one."""

    def generate(objs, boxes, valid, z, attribute):
        with torch.no_grad():
            return group.gather(generator.generate(*group.rows([objs, boxes, valid, z, attribute])))

    return generate


def make_sharded_train_step(train_step, group: Group):
    """Data-parallel training (JAX `make_sharded_train_step`): returns
    step(state, batch, draws=None, mark=None) running `train_step`
    (`train/step.make_train_step`'s) with `group` active. `batch` is this
    rank's rows of the global batch (`group.rows`) on the models' device;
    `draws`, when given, are the global batch's. Every rank's state after
    the step, and the metrics and grids it returns, are those of one
    process stepping on the global batch."""

    def step(state, batch, draws=None, mark=None):
        with sharded(group):
            return train_step(state, batch, draws=draws, mark=mark)

    step.group = group  # `train/graph.py` refuses a sharded step
    return step
