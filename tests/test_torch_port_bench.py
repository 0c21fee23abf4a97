"""The port's serving bench (`aglayout_tpu_torch.bench`) on the CPU: its
flags, its JSON line at a tiny size, and that it refuses to measure without
a card."""

import json
import math

import pytest
import torch

import aglayout_tpu_torch.models.convlstm as port_convlstm
from aglayout_tpu_torch import bench
from aglayout_tpu_torch.config import Config

torch.set_num_threads(1)
NARROW = dict(conv_dim=8, z_dim=8, embedding_dim=8, attribute_dim=12, clstm_layers=2, resi_num=1,
              num_classes=23)
SWITCHES = sorted(bench.KERNEL_FLAGS.values())


def _args(*argv):
    return bench.parser().parse_args(list(argv))


def test_defaults_are_the_serving_shape():
    args = _args()
    assert (args.image_size, args.batch_size, args.max_objects, args.iters) == (128, 128, 10, 20)
    assert args.device == "cuda" and not (args.f32 or args.int8 or args.dense)
    cfg = bench.config_from_args(args)
    assert cfg.bf16 and not cfg.int8_serving and cfg.object_size == 64
    assert all(getattr(cfg, s) for s in SWITCHES)
    # every kernel switch of the Config has its flag, and nothing else does
    assert SWITCHES == sorted(f.name for f in Config.__dataclass_fields__.values()
                              if f.name.startswith("use_") and f.name.endswith("_kernel"))


@pytest.mark.parametrize("name,switch", sorted(bench.KERNEL_FLAGS.items()))
def test_no_kernel_flag_turns_its_switch_off(name, switch):
    cfg = bench.config_from_args(_args(f"--no_{name}"))
    assert [s for s in SWITCHES if not getattr(cfg, s)] == [switch]


def test_dense_int8_and_f32_flags():
    cfg = bench.config_from_args(_args("--dense", "--int8", "--f32", "--image_size", "64"))
    assert not any(getattr(cfg, s) for s in SWITCHES)
    assert cfg.int8_serving and not cfg.bf16 and (cfg.image_size, cfg.object_size) == (64, 32)


@pytest.mark.parametrize("int8", [False, True])
def test_run_on_cpu_gives_the_json_line(monkeypatch, int8):
    """A narrow model at B=2, one iteration, through `run`: a finite value
    and the line's keys. With --int8 the narrow cells take the int8 route."""
    monkeypatch.setattr(port_convlstm, "_INT8_MIN_CINCOUT", 1)
    argv = ["--device", "cpu", "--batch_size", "2", "--max_objects", "3", "--iters", "1"]
    out = bench.run(_args(*argv, *(["--int8"] if int8 else [])), **NARROW)
    assert {"metric", "value", "unit", "ms_per_batch", "card"} <= set(out)
    assert out["metric"] == "128x128 generator inference images/sec/chip"
    assert out["unit"] == "images/sec" and "vs_baseline" not in out
    assert math.isfinite(out["value"]) and out["value"] > 0 and out["ms_per_batch"] > 0
    assert out["config"]["int8_serving"] is int8 and out["config"]["kernels_off"] == []
    assert out["card"].startswith("cpu")  # never passed off as a device number
    json.dumps(out)


def test_run_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(_args("--batch_size", "2", "--iters", "1"), **NARROW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch_size", "2", "--iters", "1"])


def test_layouts_are_seeded_and_valid():
    cfg = bench.config_from_args(_args(), **NARROW)
    a, b = (bench.layouts(cfg, 3, 4, seed=5, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    objs, boxes, valid, z, attr = a
    assert objs.shape == (3, 4) and int(objs.max()) < cfg.num_classes
    assert boxes.shape == (3, 4, 4) and (boxes[..., 2:] >= boxes[..., :2]).all() and boxes.max() <= 1
    assert valid.eq(1).all() and z.shape == (3, 4, cfg.z_dim) and attr.shape == (3, 4, 12)


def test_train_step_flags():
    args = _args("--train_step", "--remat", "--double_g_forward", "--f32")
    cfg = bench.config_from_args(args)
    assert bench.batch_size(args) == 8 and cfg.batch_size == 8
    assert cfg.remat and cfg.double_g_forward and not cfg.bf16 and cfg.image_size == 128
    assert bench.batch_size(_args("--train_step", "32")) == 32
    assert bench.batch_size(_args()) == 128 and _args().train_step is None


@pytest.mark.parametrize("extra", [[], ["--remat", "--double_g_forward"]])
def test_train_step_on_cpu_gives_the_json_line(extra, capsys, monkeypatch):
    """`main` with --train_step on a narrow 64^2 model at B=3, two steps:
    one JSON line with steps/sec, the parts of a step and the D phase's share."""
    import dataclasses

    real = bench.config_from_args
    narrow = lambda args, **kw: dataclasses.replace(real(args, **kw), **NARROW, d_conv_dim=8)  # noqa: E731
    monkeypatch.setattr(bench, "config_from_args", narrow)
    bench.main(["--train_step", "3", "--device", "cpu", "--image_size", "64", "--max_objects", "3",
                "--iters", "2", *extra])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1
    out = json.loads(line[0])
    assert out["metric"] == "64x64 GAN train steps/sec/chip (batch 3)" and out["unit"] == "steps/sec"
    assert math.isfinite(out["value"]) and out["value"] > 0 and out["ms_per_step"] > 0
    assert set(out["phase_ms"]) == set(bench.PHASES) and 0 < out["d_phase_share"] < 1
    assert out["peak_memory_gib"] is None and out["card"].startswith("cpu")
    assert out["config"]["remat"] is bool(extra) and out["config"]["batch_size"] == 3


@pytest.mark.parametrize("f32", [False, True])
def test_train_step_f32_turns_tf32_off(f32, monkeypatch):
    """Under --f32 the timed steps run with TF32 off in cuBLAS and cuDNN;
    the flags come back after."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    monkeypatch.setattr(bench, "_time_train", lambda args, cfg: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    bench.run_train(_args("--train_step", *(["--f32"] if f32 else [])))
    assert seen == [(not f32, not f32)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
