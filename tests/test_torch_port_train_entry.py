"""The port's train entry point, `python -m aglayout_tpu_torch.train`
(`train/__main__.py`), against the root `train.py`: the same flags (one a
Config field, JAX's TPU knobs replaced by the port's kernel switches) plus
`--device`, the same parsing and object_size rule; a synthetic CPU run
saves and logs; without a card the default device raises."""

import dataclasses
import os

import pytest
import torch

import train as jax_train
from aglayout_tpu.config import Config as JaxConfig
from aglayout_tpu.config import config_for as jax_config_for
from aglayout_tpu_torch.config import Config
from aglayout_tpu_torch.train import __main__ as entry
from aglayout_tpu_torch.train.loop import prepare_dirs
from aglayout_tpu_torch.utils.checkpoint import saved_steps

torch.set_num_threads(1)
SMALL_FLAGS = ["--num_classes", "23", "--attribute_dim", "12", "--conv_dim", "8", "--z_dim", "8",
               "--embedding_dim", "8", "--clstm_layers", "2", "--resi_num", "2",
               "--d_conv_dim", "8", "--batch_size", "3", "--max_objects", "3"]


def _flags(parser):
    return {opt for a in parser._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def test_flags_are_train_py_s_plus_device():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(Config)}
    tpu_only = {f"--{n}" for n in jax_fields - port_fields}
    port_only = {f"--{n}" for n in port_fields - jax_fields}
    assert _flags(entry.build_parser()) == (_flags(jax_train.build_parser()) - tpu_only) | port_only | {"--device"}


@pytest.mark.parametrize("argv", [
    [],
    ["--image_size", "128"],
    ["--image_size", "128", "--object_size", "48", "--bf16", "True", "--remat", "false"],
    ["--resume", "s", "--lambda_kl", "0.1", "--niter", "7", "--fast_decode", "false",
     "--device_masks", "false", "--allow_uniform_matrix", "TRUE", "--path", "runs"],
])
def test_parsing_matches_train_py(argv):
    args = entry.build_parser().parse_args(argv)
    jargs = jax_train.build_parser().parse_args(argv)
    cfg = entry.config_from_args(args)
    common = [f.name for f in dataclasses.fields(Config) if hasattr(jargs, f.name)]
    assert {n: getattr(args, n) for n in common} == {n: getattr(jargs, n) for n in common}
    # train.py's object_size rule: the resolution's unless given otherwise
    size = args.image_size
    want = jax_config_for(size).object_size if args.object_size == JaxConfig.object_size \
        else args.object_size
    assert cfg.object_size == want and cfg.image_size == size
    assert (args.device, args.use_tensorboard, args.synthetic, args.profile) == ("cuda", True, False, None)


def test_synthetic_cpu_run_saves_and_logs(tmp_path, capsys):
    argv = ["--synthetic", "--device", "cpu", "--niter", "2", "--log_step", "1", "--save_step", "2",
            "--allow_uniform_matrix", "true", "--vg_dir", str(tmp_path),
            "--path", str(tmp_path), "--use_tensorboard", "false"] + SMALL_FLAGS
    state, metrics = entry.main(argv)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("iter [")]
    assert [line[:20] for line in lines] == ["iter [000001/000002]", "iter [000002/000002]"]
    cfg = entry.config_from_args(entry.build_parser().parse_args(argv))
    assert saved_steps(prepare_dirs(cfg)["models"]) == [2] and state.step == 2
    assert all(torch.isfinite(v) for k, v in metrics.items() if k != "images")


def test_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    entry.main(["--synthetic", "--device", "cpu", "--niter", "1", "--log_step", "1",
                "--allow_uniform_matrix", "true", "--vg_dir", str(tmp_path), "--path",
                str(tmp_path), "--use_tensorboard", "false", "--profile", str(prof)] + SMALL_FLAGS)
    assert os.path.getsize(prof / "trace.json") > 0


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["--synthetic", "--niter", "1", "--path", str(tmp_path)] + SMALL_FLAGS)


def test_profiling_helpers():
    """`utils/profiling`: `timed` returns seconds a call and the last output;
    `enable_nan_debugging` turns autograd's anomaly mode on."""
    from aglayout_tpu_torch.utils.profiling import enable_nan_debugging, timed

    calls = []
    secs, out = timed(lambda x: calls.append(x) or x + 1, 3, iters=4, warmup=2)
    assert out == 4 and len(calls) == 6 and secs >= 0
    was = torch.is_anomaly_enabled()
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
