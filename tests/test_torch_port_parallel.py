"""Data parallelism of the port (`aglayout_tpu_torch/parallel/mesh.py`) on
the CPU: two processes over gloo against one process and against JAX.

One train step at 64^2, small widths (`bench.TRAIN_SMALL` with a global
B=6, O=3), f32: the two shards hold 5 and 8 valid objects (a mean of the
ranks' means would differ from the global mean), and rank 1's first image
(the global batch's fourth) has objects to swap (a swap that counted B//3
from the rank's own rows would change it). The two-process step is held
against the port's one-process step on the whole batch, from the same
seed with no draws given and from the same given draws, and against JAX's
step on the same weights, batch and draws (`torch_port_common.StepCase` at
B=6; JAX's sharded step computes the same function,
`tests/test_sharded_full_width.py`) at the single-process step tests'
tolerances (`torch_port_common`). Then the sharded generate against
one-process generate, and the train entry point
under `python -m torch.distributed.run --nproc_per_node 2` (logs and
checkpoints from rank 0 alone; SIGTERM to the launcher saves once, and the
run resumes one step later).

Tolerances against the one-process port step (the two differ only in the
order of the sums over the batch; measured on a CPU, own draws /
given draws): metrics 1e-5 relative (2.2e-7 / 2.2e-7), gradients 1e-3
relative L2 a tensor (3.5e-5 / 2.3e-4: this step's f32 gradients are
1.9e-2 from its f64 ones, so a reordered sum moves them), params 1e-6
where Adam's first step is sure of its sign (`compare.adam_sure`) (1.5e-8)
and 2 lr elsewhere, BN running statistics and SN vectors 1e-6 of their
tensor's max (2.1e-7 / 1.1e-7), grids one level (1).
"""

from __future__ import annotations

import os
import re
import signal
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from aglayout_tpu_torch.parallel import Group, maybe_init_distributed
from aglayout_tpu_torch.train.compare import state_mismatches, step_errors
from tests.torch_port_common import (
    SMALL,
    STEP_FLIP_TOL,
    STEP_GRAD_TOL,
    StepCase,
    _params_and_moments,
    check_grads_end_to_end,
    check_step_grads_params_stats,
    check_step_metrics,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 6
# against the one-process port step (module docstring)
TOL = {"metrics": 1e-5, "grads": 1e-3, "params_sure": 1e-6, "stats": 1e-6, "grids": 1}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _restored(cfg, path):
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.utils.checkpoint import restore_state

    state, step = restore_state(path, create_train_state(cfg, "cpu", seed=7), "l")
    assert step == 1
    return state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX step and the one-process port steps at B=6, then the same
    step on two gloo ranks: a namespace of all their results."""
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.models import build_generator

    case = StepCase(64, batch_size=B)
    valid = case.batch["valid"]
    assert valid[:3].sum() != valid[3:].sum()  # the shards' valid counts differ
    assert valid[3].sum() >= 2  # rank 1's first image has an object to swap

    cfg = case.cfg
    own = case.port_step(case.fresh(), None)  # the state's own draws
    lay = layouts(cfg, B, cfg.max_objects, seed=1, device="cpu")
    with torch.no_grad():
        images = build_generator(cfg, "cpu", seed=0).eval().generate(*lay)

    root = tmp_path_factory.mktemp("parallel")
    fields = {f: getattr(cfg, f) for f in ("image_size", "object_size", "batch_size",
                                           "max_objects", "num_classes", "d_conv_dim", *SMALL)}
    torch.save({"cfg": fields, "batch": case.batch, "matrix": case.matrix,
                "pos_weight": case.pos_weight, "draws": case.draws1, "layouts": lay},
               root / "inputs.pt")
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    child = os.path.join(REPO, "tests", "torch_port_parallel_child.py")
    procs = [subprocess.Popen([sys.executable, child, str(root)], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs

    ranks = []
    for r in range(2):
        out = torch.load(root / f"rank{r}" / "out.pt", weights_only=False)
        ranks.append(types.SimpleNamespace(
            given=(_restored(cfg, root / f"rank{r}" / "given"), out["metrics"]["given"]),
            own=(_restored(cfg, root / f"rank{r}" / "own"), out["metrics"]["own"]),
            images=out["images"]))
    return types.SimpleNamespace(case=case, own=own, images=images, ranks=ranks)


def _check_against_one_process(ref, got, lr):
    err = step_errors(ref, got, lr)
    for key, tol in TOL.items():
        assert err[key] <= tol, (key, err[key], tol)
    assert err["params_any"] <= err["params_any_tol"] + 1e-6, err
    return err


def test_sharded_step_matches_one_process_with_its_own_draws(run):
    """No draws given: each rank draws z, eps and the swap for the global
    batch from the seeded generator and keeps its rows, so the two-rank
    step is the one-process step of the same seed."""
    _check_against_one_process(run.own, run.ranks[0].own, run.case.cfg.learning_rate)
    # the draws' generator advanced as in one process
    assert torch.equal(run.ranks[0].own[0].rng.get_state(), run.own[0].rng.get_state())


def test_sharded_step_matches_one_process_with_given_draws(run):
    _check_against_one_process((run.case.state1, run.case.metrics), run.ranks[0].given,
                               run.case.cfg.learning_rate)


def test_sharded_step_metrics_match_jax(run):
    """Every metric within 1e-4 of JAX's (relative), the grids within one level."""
    check_step_metrics(types.SimpleNamespace(**dict(vars(run.case), metrics=run.ranks[0].given[1])))


def test_sharded_step_grads_params_and_stats_match_jax(run):
    """The step tests' tolerances: params 1e-6 where Adam is sure of its
    sign and 2 lr elsewhere, BN statistics and SN vectors 1e-5; the
    gradients at the tolerance `torch_port_common` gives where f32 itself
    is that far from exact (`STEP_GRAD_TOL[128]`, `STEP_FLIP_TOL[128]`):
    at B=6 JAX's f32 step
    gradients are 2.3e-2 (relative L2) from the port's f64 step and the
    port's one-process f32 ones 1.9e-2 (at B=3, 2.9e-4). Measured against
    JAX: metrics 6.3e-7, sign flips 154 of 680,488 (2.3e-4; tolerance
    2e-3), params where sure 3.0e-8."""
    ns = types.SimpleNamespace(**dict(vars(run.case), state1=run.ranks[0].given[0]))
    check_step_grads_params_stats(ns, STEP_GRAD_TOL[128], STEP_FLIP_TOL[128])
    # and, the referee of both, the port's f64 step (measured 1.9e-2)
    grads = {k: 2 * v[1].double() for k, v in _params_and_moments(ns.state1).items()}
    check_grads_end_to_end(grads, run.case.f64_grads(), "sharded f32 against f64",
                           STEP_GRAD_TOL[128])


@pytest.mark.parametrize("which", ["given", "own"])
def test_sharded_step_leaves_the_ranks_equal(run, which):
    """Both ranks hold the same state and metrics after the step: params,
    statistics, SN vectors, Adam's moments, the draws' generator."""
    (s0, m0), (s1, m1) = getattr(run.ranks[0], which), getattr(run.ranks[1], which)
    assert state_mismatches(s0, s1) == []
    for k, v in m0.items():
        if k == "images":
            assert all(torch.equal(v[g], m1["images"][g]) for g in v)
        else:
            assert torch.equal(v, m1[k]), k


def test_sharded_generate_equals_one_process(run):
    """Both ranks get the whole batch's images, those of one process (each
    sample is decoded alone in eval mode; 1e-6 of the output's max)."""
    for rank in run.ranks:
        assert rank.images.shape == run.images.shape
        err = (rank.images - run.images).abs().max().item()
        assert err <= 1e-6 * run.images.abs().max().item(), err


def test_group_is_the_identity_without_a_process_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_init_distributed("cpu") is None
    g = Group()
    assert (g.on, g.rank, g.size) == (False, 0, 1)
    t = torch.arange(6.0).reshape(3, 2)
    assert g.rows({"x": t})["x"] is not None and torch.equal(g.rows(t), t)
    assert g.global_sum(t) is t and g.gather(t) is t and torch.equal(g.gather(t, 2), t[:2])
    assert g.any(True, "cpu") and not g.any(False, "cpu")
    g.sum_grads([torch.nn.Parameter(t)])  # nothing to sum


def test_rows_refuse_a_batch_the_ranks_do_not_divide():
    g = Group()
    g.rank, g.size = 1, 4
    assert torch.equal(g.rows(torch.arange(8)), torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="does not split evenly over 4 ranks"):
        g.rows(np.zeros((6, 2)))


# ---- the train entry point under torch's launcher

ARGS = ["--synthetic", "--device", "cpu", "--allow_uniform_matrix", "true", "--num_classes", "23",
        "--attribute_dim", "12", "--conv_dim", "8", "--z_dim", "8", "--embedding_dim", "8",
        "--clstm_layers", "2", "--resi_num", "2", "--d_conv_dim", "8", "--batch_size", "4",
        "--max_objects", "3", "--use_tensorboard", "false", "--log_step", "1"]


def _launch(path, *args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "aglayout_tpu_torch.train", *ARGS, "--path", str(path), "--vg_dir", str(path),
           *args]
    return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                                                     OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _steps(path):
    """The steps checkpointed under the run directory `path`."""
    from aglayout_tpu_torch.utils.checkpoint import saved_steps

    (exp,) = os.listdir(os.path.join(path, "all", "models"))
    return saved_steps(os.path.join(path, "all", "models", exp))


def test_entry_point_trains_on_two_ranks_and_rank0_alone_writes(tmp_path):
    proc = _launch(tmp_path, "--niter", "4", "--save_step", "2", "--save_num", "5")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    lines = [line for line in out.splitlines() if line.startswith("iter [")]
    assert [line[:20] for line in lines] == [f"iter [{i:06d}/000004]" for i in (1, 2, 3, 4)], out
    assert out.count("Config(") == 1
    assert _steps(tmp_path) == [2, 4]


def test_entry_point_saves_once_on_sigterm_and_resumes(tmp_path):
    proc = _launch(tmp_path, "--niter", "100000", "--save_step", "100000")
    seen, out = 0, []
    try:
        for line in proc.stdout:
            out.append(line)
            seen += line.startswith("iter [")
            if seen >= 2:
                break
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(out) + rest
    saved = re.findall(r"\[preempt\] signal 15: saved checkpoint at step (\d+), exiting", text)
    assert len(saved) == 1, (text[-2000:], err[-2000:])
    k = int(saved[0])
    assert _steps(tmp_path) == [k]

    proc = _launch(tmp_path, "--niter", str(k + 1), "--resume", "l")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    lines = [line[:20] for line in out.splitlines() if line.startswith("iter [")]
    assert lines == [f"iter [{k + 1:06d}/{k + 1:06d}]"], out
