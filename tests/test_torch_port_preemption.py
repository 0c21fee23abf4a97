"""Preemption save of the port's loop (twin of tests/test_preemption.py):
SIGTERM to a training subprocess saves a checkpoint at the interrupted
step, the process returns cleanly, and `resume l` continues from exactly
that step; a second signal while the first is pending restores the old
handlers and raises it again."""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from aglayout_tpu_torch.bench import TRAIN_SMALL
from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.data.synthetic import synthetic_batch
from aglayout_tpu_torch.train.loop import prepare_dirs, train
from aglayout_tpu_torch.utils.checkpoint import saved_steps

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.data.synthetic import synthetic_batch
from aglayout_tpu_torch.train.loop import train

cfg = config_for(64, **{cfg_kw})
rng = np.random.RandomState(0)

def loader():
    i = 0
    while True:
        if i == {double_signal_at}:  # two SIGINTs before the step can end
            signal.raise_signal(signal.SIGINT)
            signal.raise_signal(signal.SIGINT)
        i += 1
        yield synthetic_batch(rng, cfg.batch_size, cfg.max_objects, cfg.image_size,
                              cfg.num_classes, cfg.attribute_dim)

try:
    train(cfg, loader=loader(), niter=100000, use_tensorboard=False, device="cpu")
except KeyboardInterrupt:
    print("KEYBOARD_INTERRUPT", signal.getsignal(signal.SIGINT) is signal.default_int_handler,
          signal.getsignal(signal.SIGTERM) == signal.SIG_DFL, flush=True)
    sys.exit(3)
print("CHILD_EXITED_CLEANLY", flush=True)
"""


def _cfg_kw(tmp_path):
    return dict(TRAIN_SMALL, allow_uniform_matrix=True, vg_dir=str(tmp_path), log_step=1,
                save_step=10_000, path=str(tmp_path))  # periodic saves never fire


def _child(tmp_path, double_signal_at=-1):
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(cfg_kw=repr(_cfg_kw(tmp_path)),
                                   double_signal_at=double_signal_at))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path))


def test_sigterm_saves_checkpoint_and_resume_continues(tmp_path):
    proc = _child(tmp_path)
    lines = []
    try:
        deadline = time.time() + 120
        steps_seen = 0
        for line in proc.stdout:  # a few steps: the loop and its handler are live
            lines.append(line)
            if line.startswith("iter ["):
                steps_seen += 1
                if steps_seen >= 3:
                    break
            assert time.time() < deadline, "".join(lines[-30:])
        assert steps_seen >= 3, "".join(lines[-30:])
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = "".join(lines)

    m = re.search(r"\[preempt\] signal 15: saved checkpoint at step (\d+), exiting", out)
    assert m, out[-3000:]
    saved_step = int(m.group(1))
    assert saved_step >= 3
    assert "CHILD_EXITED_CLEANLY" in out  # a clean return, not a crash
    assert proc.returncode == 0, proc.returncode

    cfg = config_for(64, **_cfg_kw(tmp_path))
    model_dir = prepare_dirs(cfg)["models"]
    assert saved_steps(model_dir) == [saved_step]  # not a periodic save
    rng = np.random.RandomState(1)

    def loader():
        while True:
            yield synthetic_batch(rng, cfg.batch_size, cfg.max_objects, cfg.image_size,
                                  cfg.num_classes, cfg.attribute_dim)

    state, _ = train(cfg, loader=loader(), niter=saved_step + 1, use_tensorboard=False,
                     device="cpu")
    assert state.step == saved_step + 1


def test_second_sigint_restores_the_handlers_and_reraises(tmp_path):
    proc = _child(tmp_path, double_signal_at=2)
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "KEYBOARD_INTERRUPT True True" in out, out[-3000:]
    assert proc.returncode == 3, (proc.returncode, out[-3000:])
    assert "[preempt]" not in out and "CHILD_EXITED_CLEANLY" not in out
    cfg = config_for(64, **_cfg_kw(tmp_path))
    assert saved_steps(prepare_dirs(cfg)["models"]) == []
