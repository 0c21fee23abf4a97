"""The port's checkpoints (`utils/checkpoint.py`): a save and a restore
give back all four nets (params, u and v, BN statistics), their Adams, the
draws' generator and the step exactly; the newest `save_num` stay; resume
'l', 's', a step and a missing directory follow JAX's contract; and a step
from a restored state equals, bit for bit on the CPU, the step from the
state that was saved."""

import os

import pytest
import torch

from aglayout_tpu_torch.bench import TRAIN_SMALL, train_inputs
from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.train.compare import state_mismatches
from aglayout_tpu_torch.train.state import create_train_state
from aglayout_tpu_torch.train.step import make_train_step
from aglayout_tpu_torch.utils.checkpoint import (
    checkpoint_path,
    restore_state,
    save_state,
    saved_steps,
)

torch.set_num_threads(1)
CFG = config_for(64, **TRAIN_SMALL)


def _step(state, seed=0):
    """One train step of `state` on the seeded synthetic batch `seed`."""
    batch, matrix, pos_weight = train_inputs(CFG, CFG.batch_size, seed)
    return make_train_step(CFG, state.models, matrix, pos_weight)(
        state, batch_to_torch(batch, "cpu"))


@pytest.fixture(scope="module")
def trained():
    """A state after one step: Adam's moments and the SN and BN buffers moved."""
    state, _ = _step(create_train_state(CFG, "cpu", seed=0))
    return state


def test_round_trip_is_exact(trained, tmp_path):
    path = save_state(str(tmp_path), trained.step, trained)
    assert path == checkpoint_path(str(tmp_path), 1) and os.listdir(tmp_path) == ["step_1.pt"]
    fresh = create_train_state(CFG, "cpu", seed=1)
    assert state_mismatches(trained, fresh)  # the check sees a difference
    restored, start = restore_state(str(tmp_path), fresh, "l")
    assert restored is fresh and start == 1
    assert state_mismatches(trained, restored) == []
    # Adam kept its step counts where a fresh Adam keeps them, and f32 moments
    for opt in restored.opt.values():
        for s in opt.state.values():
            assert s["step"].device.type == "cpu"
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_round_trip_keeps_f32_masters_under_bf16(tmp_path):
    cfg = config_for(64, **dict(TRAIN_SMALL, bf16=True))
    state = create_train_state(cfg, "cpu", seed=0)
    batch, matrix, pos_weight = train_inputs(cfg, cfg.batch_size, 0)
    state, _ = make_train_step(cfg, state.models, matrix, pos_weight)(
        state, batch_to_torch(batch, "cpu"))
    save_state(str(tmp_path), 1, state)
    restored, _ = restore_state(str(tmp_path), create_train_state(cfg, "cpu", seed=3), "1")
    assert state_mismatches(state, restored) == []
    for name, m in restored.models.items():
        assert all(p.dtype == torch.float32 for p in m.parameters()), name
        for s in restored.opt[name].state.values():
            assert s["exp_avg"].dtype == torch.float32


def test_keeps_the_newest_save_num(trained, tmp_path):
    for step in (3, 6, 9, 12):
        save_state(str(tmp_path), step, trained, save_num=2)
    assert saved_steps(str(tmp_path)) == [9, 12]
    assert sorted(os.listdir(tmp_path)) == ["step_12.pt", "step_9.pt"]  # no temporary left
    save_state(str(tmp_path), 15, trained, save_num=3)
    assert saved_steps(str(tmp_path)) == [9, 12, 15]


def test_resume_modes(trained, tmp_path):
    for step in (4, 8):
        trained.step = step
        save_state(str(tmp_path), step, trained)
    trained.step = 1
    fresh = lambda: create_train_state(CFG, "cpu", seed=1)  # noqa: E731
    state, start = restore_state(str(tmp_path), fresh(), "s")
    assert start == 0 and state.step == 0 and state_mismatches(state, fresh()) == []
    state, start = restore_state(str(tmp_path), fresh(), "l")
    assert start == 8 and state.step == 8
    state, start = restore_state(str(tmp_path), fresh(), "4")
    assert start == 4 and state.step == 4
    with pytest.raises(FileNotFoundError):
        restore_state(str(tmp_path), fresh(), "5")
    state, start = restore_state(str(tmp_path / "nope"), fresh(), "l")
    assert start == 0 and state.step == 0
    assert restore_state(str(tmp_path / "empty"), fresh(), "s")[1] == 0
    with pytest.raises(FileNotFoundError):
        restore_state(str(tmp_path / "nope"), fresh(), "4")
    # a save cut short leaves only its temporary, which no resume reads
    (tmp_path / ".step_20.pt.tmp").write_bytes(b"partial")
    assert saved_steps(str(tmp_path)) == [4, 8]
    assert restore_state(str(tmp_path), fresh(), "l")[1] == 8


def test_step_after_restore_equals_step_from_the_saved_state(tmp_path):
    """Bit for bit: the draws come from the restored generator, and Adam
    continues from the restored moments and counts."""
    original, _ = _step(create_train_state(CFG, "cpu", seed=0))
    save_state(str(tmp_path), original.step, original)
    restored, _ = restore_state(str(tmp_path), create_train_state(CFG, "cpu", seed=5), "l")
    a, ma = _step(original, seed=1)
    b, mb = _step(restored, seed=1)
    for k in ma:
        if k == "images":
            assert all(torch.equal(ma[k][n], mb[k][n]) for n in ma[k])
        else:
            assert torch.equal(ma[k], mb[k]), k
    assert state_mismatches(a, b) == [] and a.step == 2
