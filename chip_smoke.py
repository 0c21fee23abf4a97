"""Smoke run of the PyTorch port on one CUDA GPU: build, check, generate.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (`nvcc`) and this repository; it
imports nothing of JAX. Phases, each printed as it ends; any failure
raises, and the run then exits non-zero without printing a result:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile aglayout_tpu_torch/csrc/*.cu for sm_90a (timed);
  3. generate 64^2: the full-width 64^2 model (conv_dim=64, 3 ConvLSTM
     layers, 6 residual blocks, 179 classes, O=10, B=128, bf16, seeded
     weights) with the kernels on and off; K1 and K2 must launch in the
     kernels-on run and none with them off; outputs finite, agreeing with
     each other and with the f32 model, timed with CUDA events;
  4. generate 128^2: the same at 128^2 (object_size 64), the main path:
     the five kernels K1-K5 must launch with the kernels on, none off; the
     launch counts of this run are the ones reported for them;
  5. generate 128^2 int8: the same model with `int8_serving` (the serving
     bench's --int8): K1-K5 must launch and K6 exactly O times (one wide
     ConvLSTM layer); kernels on against off, and int8 against the
     non-int8 image of phase 4, with the limit stated; timed against the
     non-int8 model in turns; then one run of the serving bench itself
     (`aglayout_tpu_torch.bench.run`) in each configuration;
  6. generate 128^2, the serving A/B configurations: `typed_c3` v5 and v6
     (the chosen typed kernel must launch exactly once and v4 not at all),
     `use_head8_kernel` off (K2 must launch twice, on flat tables for c4
     and on compact ones for c7, and K3 not at all), and that with
     `use_compact_heads` off (K2 twice on flat tables); each image against
     the default configuration's, each timed in turns with it;
  7. kernels: each of the thirteen hand-written kernels against its plain
     PyTorch version, at the shapes generate gives it with B=128 (K7 and
     K4', which the decoder does not call, at SPADE-4's shape; K2's
     transposed mode and the typed v3, which no model path calls, at the
     c7 head's and K5's), in bf16 and in f32 (TF32 off), with the tolerance
     stated beside each (K6 with its weights packed once, as the ConvLSTM
     calls it; K4 and K4' bit for bit in bf16 and to 1e-6 in f32, K4' also
     equal to K4 on K4's tables made flat in both dtypes), and for K1 and
     K2 the kernel the wrapper took
     (tensor cores or FMAs); K2 on compact tables must equal K3 bit for
     bit; K2's transposed mode (K2t) must take the tensor cores in bf16
     (x by one TMA tensor copy a chunk) and equal K2 on flat tables run on
     the permuted x bit for bit; v3 must equal K5 on the grid's inner 12 x
     12 bit for bit in both dtypes (K5's kernel reads the padded grid in
     place), its bound counting K5's work; the tensor-core kernels (K1,
     K2, K2t, K3, K5 and its v3, v6 schedules) also in bf16 at the small
     model's widths, which the f32 reference phase does not send through
     them; K6 and K7 must equal their plain versions to 1e-6
     in f32, their integer sums being exact, and K7 bit for bit in both
     dtypes (with c6's weights packed once); timed with CUDA events (the
     span of 20 calls, 10 of a plain version, the host's gaps included)
     and, in bf16, by the
     device time of their launches under torch.profiler, which the kernels
     line reports, beside the bound computed from the shapes and, for v6,
     from the data; v6 equal to K5 bit for bit on random inputs, on the
     inputs the 128^2 path makes from the bench's layouts (timed there
     beside K5) and on objects of one row type and of none; K6 equal to its
     plain version at Cout 480, Cin 144 and 40, k = 1, 3 and 7;
  8. reference: small f32 generators (64^2, 128^2, 128^2 with
     `int8_serving` at a lowered threshold, and 128^2 in each A/B
     configuration) on the card, kernels on, against the same models on the
     CPU, where they run their plain paths; and the 640 -> 512 ConvLSTM
     cell alone at the real int8 threshold;
  9. fall-through: 64^2 and 128^2 generate at conv_dim=12 in bf16, a width
     the tensor-core and typed kernels do not take: each site takes the
     next route (the FMA kernels of K1 and K2, K2 for the c7 head, the
     plain typed expansion), against the f32 plain path on the CPU; and
     64^2 with `int8_serving` at conv_dim=60 (f32, B=4), whose 600 -> 480
     gate conv K6 must take, against the CPU;
 10. wide typed: 128^2 generate at conv_dim=96 (bf16, B=4), a typed grid
     K5's kernel takes since it was widened, with `typed_c3` v4, v5 and v6:
     each route is its kernel, launched once, and the image is held against
     kernels off and f32 on the CPU with the conv_dim=12 limits; then the
     three kernels alone at that shape, on the path's inputs and on random
     ones at B=128, against the plain expansion (2e-2) and v5, v6 against
     v4 bit for bit;
 11. discriminators: the image, object and attribute Ds at the 128^2
     model's widths (d_conv_dim 64, 179 classes, 106 attributes, six
     blocks in the attribute D), the image D on B=32 128^2 images, the
     others on 320 64^2 crops, in bf16 and f32 (TF32 off): u and v after
     one `update_stats` call against the CPU's, the f32 logits against the
     CPU's on a slice, bf16 against f32, outputs finite, each forward timed
     (no kernel of the port: cuDNN's convs);
 12. train step (`train/step.py`, the models in training mode, where every
     route is the plain composition): at small widths (64^2, B=3, O=3) in
     f32 with TF32 off, one step on the card against the same step on the
     CPU from the same weights, batch and draws (every metric within 1e-4
     relative; every net's params within 1e-6 where the two gradients agree
     within 1% and |g| > 1e-3 of its tensor's max, within 2 lr elsewhere:
     Adam's first step moves a param by about +-lr); then the 128^2 model
     at its full width (conv_dim 64, d_conv_dim 64, 179 classes, 106
     attributes, O=10) at B=8 in bf16 and in f32 (TF32 off): one warm-up
     step and 5 timed ones (CUDA events; the parts of a step from the events
     it marks), peak memory; every metric finite, all four nets' params
     moved, and no kernel of the port launched over the steps; then one eval
     `generate` of the trained bf16 generator, which must launch the 128^2
     path's kernels as phase 4's model does. Each fresh state made on the
     card has every generator batch norm at JAX's fresh values (running
     mean 0, variance 1, weight 1, bias 0, no batch tracked; constants, no
     JAX), and `build_generator` on the card keeps its drawn BN state (no
     BN at those values), which the generate and kernel phases exercise.
 13. trainer, the 128^2 model at its full width, B=8, bf16, through the
     port's train entry points (no kernel of the port in a train step):
     (a) `train/loop.train` on the synthetic stream for 12 steps (log_step
     4, save_step 6, save_num 2, TensorBoard at step 12; one process on the
     card, so the step runs as one CUDA graph, `train/graph.py`): 3 log
     lines, checkpoints at steps 6 and 12 only, metrics finite, the last log
     window's ms/step beside `bench.run_train`'s eager and graphed ones
     (CUDA events) in the same call; (b) the step-12 checkpoint restored twice into fresh states:
     every param, buffer, Adam state tensor, the CUDA generator's state and
     the step `torch.equal`; its size, save and restore seconds; then one
     more step from the original and from both restored states on one
     batch: the original against a restored one within 4x the spread of
     the two restored ones + 1e-6 (a step need not be bit-deterministic on
     the card; both were 0 on an H100); (d) the checkpoint's generator loaded into `build_generator` in
     eval mode: `generate` at B=128 launches exactly the 128^2 path's
     kernels (counts set to 0 just before, read just after) and equals the
     trained generator in memory bit for bit; (c) `python -m
     aglayout_tpu_torch.train --synthetic --image_size 128` as a
     subprocess (started ahead, `ahead_module`, when the phase starts),
     SIGTERM after 3 log lines: the `[preempt]` line, rc 0,
     and `--resume l` through the entry point ends one step later. The
     checkpoints (about 1 GB each) are deleted when the phase ends. The
     Visual Genome leg is not run: the card's host has no h5py.
 14. infer and eval, the 128^2 model at its full width (conv_dim 64,
     d_conv_dim 64, 179 classes, 106 attributes, O=10, the attribute D's
     sixth block), seeded weights and the seeded synthetic stream: (a) the
     eval `Generator.forward` at B=32 in bf16 and in f32 with TF32 off,
     kernels on and off: K1-K5 exactly three launches each with them on
     (the rec, rand and shift branches), none off; the three images, the
     four crops tensors, mu and logvar on against off within phase 4's
     128^2 limits in bf16 and 1e-4 of the output's max in f32; ms a forward
     by CUDA events, both dtypes; (b) small f32 eval forwards (conv_dim 16,
     64^2 and 128^2) on the card against the CPU, 1e-4; (c)
     `infer/generate.run_inference` at B=8, 3 batches, f32 and bf16: JAX's
     summary keys, finite values, 4 PNGs an image (+ the _modified ones),
     K1-K5 six launches each a batch, ms a batch on the host clock with and
     without the PNGs; (d) `python -m aglayout_tpu_torch.test --synthetic
     --image_size 128 --max_batches 2` as a subprocess (started ahead when
     (c) starts) from a checkpoint the phase saves: rc 0 and a JSON
     summary; (e) `eval/report.evaluate_run` at B=8, 2 batches, with a
     seeded InceptionV3 (He-normal convs) and a seeded AlexNet with LPIPS
     heads saved as .pth files: every section
     finite and naming the real networks; InceptionV3's pool3 and logits on
     the card (f32, TF32 off) against the CPU on 4 images, 1e-4; images/s of
     InceptionV3 at 299^2 and pairs/s of LPIPS-AlexNet at 128^2. Its files
     (under build/chip_smoke_infer/) are deleted when the phase ends.
 15. data parallelism and the crop classifiers (`parallel/mesh.py`,
     `eval/{resnet,classifier,train_att_cls}.py`), every rank a child
     process of the phase (`python3 chip_smoke.py --parallel-child PART`,
     after the build phase has built the kernels, so that no two ranks
     build at once; (a)'s rank started when phase 14 starts, (b)'s when
     this phase does, each waiting, CUDA context made, for its group's
     port), so that a failing rank fails the run: (a) an NCCL
     group of one rank: the sharded train step at 128^2 full width, B=8,
     bf16, against the same step with no group (metrics 2e-2 relative,
     params 1e-6 where Adam's first step is sure of its sign and 2 lr
     elsewhere, statistics and SN vectors 2e-2), and ms a step of each by
     CUDA events, in turns; (b) two ranks sharing the card over gloo (NCCL
     puts no two ranks on one device): one 128^2 full-width step in f32
     with TF32 off, global B=8, against the one-process step on the card
     (metrics 1e-4, params as in (a), statistics 1e-5, grids one level);
     (c) on those two ranks `make_sharded_generate` at 128^2, B=128, bf16:
     K1-K5 exactly once on each rank, the gathered image within phase 4's
     128^2 limits of the one-process image; (d) `python -m
     torch.distributed.run --nproc_per_node 1 -m aglayout_tpu_torch.train
     --synthetic --image_size 128` for 3 steps: rc 0, 3 log lines, its one
     checkpoint (a process of its own, started when phase 16 starts and
     run beside it, checked when phase 16 ends: "parallel (d)" in the
     phase_seconds line is the wait for it then); (e) on the seeded synthetic stream at the 128^2 model's
     width (179 classes, 106 attributes, B=8, O=10), f32 with TF32 off:
     `train_crop_classifier` at full depth for 3 steps on 224^2 crops
     (finite losses), a fresh ResNet-50 drawn as flax draws JAX's (each
     conv's and fc's weight std within 10 % of sqrt(1 / fan_in), the fc
     bias 0), ResNet-50's forward on the card against the CPU on 4
     crops with seeded weights (1e-4), `test_crop_classifier` on two
     `gen_pickle` batches, `train_attribute_classifier` (the sixth block)
     for 3 steps and its checkpoint, and the ResNet-50 train step's crops/s
     with its FLOP count and share of the f32 peak. Its files (under
     build/chip_smoke_parallel/) are deleted when the phase ends.
 16. tools (`aglayout_tpu_torch/tools/`), the 64^2 model at its full width
     (conv_dim 64, 3 ConvLSTM layers, 6 residual blocks, 179 classes),
     B=8: (a) `train_evidence` for 200 steps (f32 with TF32 off, 32 corpus
     batches, a log every 10 steps): its four files and `progress.json`,
     finite metrics, the
     D's loss and its attribute loss in the last quarter of logs below 0.95
     and 0.8 of the first (0.83 and 0.71 in JAX's committed run, 0.84 and
     0.71 in the port's; the reconstruction L1 0.88 and 1.05: it falls
     later, and tests/test_torch_port_training_dynamics.py holds JAX's
     small live check's 0.8 ratio on it on the card; the two D ratios are
     printed beside those of the run from the drawn BN state), and K1 and K2
     exactly 3 launches each over the run (the sample grid's eval forward:
     rec, rand, shift; none in the steps); (b)
     `quality_curve.run_curve` on the synthetic stream, 20 steps, an
     evaluation point at 0, 10 and 20 (`evaluate_run`, 1 batch): JAX's row
     keys, finite values, the train iterator drawn 20 times (none
     dropped), and at every point K1 and K2 three launches an eval forward
     and none in the steps; (c) `bench_train_table` for 64:8 bf16 through
     its subprocess (started with the phase, beside (a) and (b)): one row,
     finite steps/s, the card's name; (d)
     `import_reference_artifacts` on a vocab and a `torch.save`d matrix
     that the phase writes: the .npy equals the matrix; (e) `train_evidence`
     resumed (f32 with TF32 off, `--deterministic`, a log every 10 steps):
     20 steps in one process against 10 + 10 through `--segment_steps 10`
     in two, each a child process that saves its state to a file and the
     second restoring it (the three start with the phase and run beside
     (a)-(d), the second segment, its imports, CUDA context and kernel
     library done, waiting until the first has exited):
     `metrics.jsonl` byte-equal, the SHA-256 of every
     net's `state_dict`, every Adam state and the draws' generator in the
     saved step-20 states equal, and each run's kernel check (its samples'
     forward, kernels on against off) K1 and K2 three launches each and
     within 1e-4. Its files (under build/chip_smoke_tools/) are deleted
     when the phase ends. Every `train_evidence` run here takes the
     graphed step (`train/graph.py`), the resumed one captured anew after
     its restore.
 17. graph: the train step captured as one CUDA graph (`train/graph.py`)
     against the eager step, at `train_evidence`'s set-up (the published
     widths, B=8, 4 corpus batches), deterministic, at 64^2 in f32 with
     TF32 off and at 128^2 with TF32 on (as the evidence runs): two fresh
     states of one seed, the capture leaving its state where it was, then
     20 steps of each in turns, every metric and grid bit-equal at every
     step, and one more of each under torch's sync debug mode, whose
     host waits it counts; after them every parameter, buffer, Adam moment
     and count, the draws' generator and the step `torch.equal`; no kernel
     of the port launched; steps/s of each by CUDA events over steps 3-20;
     then at 64^2 a third fresh state's graph of a step that nothing but
     the graph references (`PoolChurn`): the step's own tensors (its
     co-occurrence matrix and the attribute pos-weights) alive and held by
     the allocator, and 20 replays, with the caching allocator's free
     blocks of up to 1 MB filled with NaN and a quarter of them turned over
     after each replay, bit-equal to the eager run above at every step.
In every full-width bf16 run of phases 3-6, K1 and K2 must take their
tensor-core kernels (`route_launches`); the build phase holds the
shared-memory sizes the route predicates compute in Python against the
library's (the heads' in each of their three modes).
The last four lines are each phase's seconds (JSON), the kernel summary
(JSON), the card's name and power limit, and the result (JSON).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from aglayout_tpu_torch.tools.train_evidence import PATH_KERNELS

B, O = 128, 10  # serving batch and object slots (the serving bench's)
HBM, BF16, INT8, F32 = 3.35e12, 989e12, 1979e12, 67e12  # H100 SXM peaks: bytes/s, operations/s
# kernel name -> (source, the TPU kernel it replaces)
SOURCES = {
    "residual_trunk": ("aglayout_tpu_torch/csrc/residual_trunk.cu",
                       "aglayout_tpu/ops/pallas_resblocks.py:87"),
    "spade_few_out_conv": ("aglayout_tpu_torch/csrc/spade_few_out_conv.cu",
                           "aglayout_tpu/ops/pallas_spade_conv.py:143"),
    "spade_few_out_conv8": ("aglayout_tpu_torch/csrc/spade_few_out_conv8.cu",
                            "aglayout_tpu/ops/pallas_spade_conv.py:437"),
    "spade_apply8": ("aglayout_tpu_torch/csrc/spade_apply.cu",
                     "aglayout_tpu/ops/pallas_spade_conv.py:554"),
    "typed_c3_expand": ("aglayout_tpu_torch/csrc/typed_c3_expand.cu",
                        "aglayout_tpu/ops/pallas_typed_expand.py:346"),
    "conv_small_int8": ("aglayout_tpu_torch/csrc/conv_small_int8.cu",
                        "aglayout_tpu/ops/pallas_conv8_int8.py:74"),
    "spade_c6_int8": ("aglayout_tpu_torch/csrc/spade_c6_int8.cu",
                      "aglayout_tpu/ops/pallas_spade_c6_int8.py:113"),
    "spade_apply_t": ("aglayout_tpu_torch/csrc/spade_apply.cu",
                      "aglayout_tpu/ops/pallas_spade_conv.py:613"),
    "typed_c3_expand_v3": ("aglayout_tpu_torch/csrc/typed_c3_expand.cu",
                           "aglayout_tpu/ops/pallas_typed_expand.py:148"),
    "typed_c3_expand_v5": ("aglayout_tpu_torch/csrc/typed_c3_expand.cu",
                           "aglayout_tpu/ops/pallas_typed_expand.py:520"),
    "typed_c3_expand_v6": ("aglayout_tpu_torch/csrc/typed_c3_expand.cu",
                           "aglayout_tpu/ops/pallas_typed_expand.py:680"),
    # the compact=True and transposed=True modes of spade_few_out_conv
    "spade_few_out_conv[compact]": ("aglayout_tpu_torch/csrc/spade_few_out_conv.cu",
                                    "aglayout_tpu/ops/pallas_spade_conv.py:143"),
    "spade_few_out_conv[transposed]": ("aglayout_tpu_torch/csrc/spade_few_out_conv.cu",
                                       "aglayout_tpu/ops/pallas_spade_conv.py:143"),
}
K2, K2C, K2T = "spade_few_out_conv", "spade_few_out_conv[compact]", "spade_few_out_conv[transposed]"
# launches per batch of each path; every kernel not named must not launch
PATH64, PATH128 = (dict.fromkeys(PATH_KERNELS[size], 1) for size in (64, 128))
PATH128_INT8 = dict(PATH128, conv_small_int8=O)  # one wide ConvLSTM layer (640 -> 512) x O slots
# the serving A/B configurations: label, Config fields, launches per batch, and
# the kernel whose reported launch count comes from this configuration
VARIANTS = (
    ("typed v5", {"typed_c3": "v5"}, dict(PATH128, typed_c3_expand=0, typed_c3_expand_v5=1),
     "typed_c3_expand_v5"),
    ("typed v6", {"typed_c3": "v6"}, dict(PATH128, typed_c3_expand=0, typed_c3_expand_v6=1),
     "typed_c3_expand_v6"),
    ("head8 off", {"use_head8_kernel": False}, {**PATH128, "spade_few_out_conv8": 0, K2C: 1}, K2C),
    ("head8 off, flat", {"use_head8_kernel": False, "use_compact_heads": False},
     {**PATH128, "spade_few_out_conv8": 0, K2: 2}, None),
)
# the hand-written kernels a wrapper launches each time it counts one launch
# (the quantise passes and the product; the max pass, the quantise pass and
# the product), where more than one
OURS = {"conv_small_int8": 3, "spade_c6_int8": 3}
# the wrappers that pick between a tensor-core and an FMA kernel by shape
ROUTED = ("residual_trunk", K2)
# the summary of `infer/generate.run_inference` (JAX's keys)
SUMMARY_KEYS = {"average_precision", "average_recall", "avg_pred_per_obj", "avg_gt_per_obj",
                "frac_predicting_any", "frac_correct_once", "num_objects", "edit_success_rate",
                "edit_candidates"}
SWITCHES = ("use_trunk_kernel", "use_head_kernel", "use_typed_kernel", "use_apply_kernel",
            "use_head8_kernel", "use_int8_kernel")

def log(msg: str) -> None:
    print(msg, flush=True)


PLAIN_ITERS = 10  # the plain versions' calls a CUDA-event span (2-82 ms a call)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hand_written(*csrcs):
    """A pattern that finds, in a trace's kernel names, the `__global__`
    functions of these csrc/ directories (default: this checkout's)."""
    import re
    from pathlib import Path

    names = set()
    for d in csrcs or (Path(__file__).resolve().parent / "aglayout_tpu_torch" / "csrc",):
        for f in sorted(Path(d).glob("*.cu*")):
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                    f.read_text()))
    return re.compile(r"(?:^|[\s:])(?:" + "|".join(sorted(names)) + r")[<(]")


def device_ms(fn, ours: int, iters: int = 20, warmup: int = 3, csrcs=()) -> float:
    """Device time of fn() in ms: the summed durations of the kernels it
    launches, from `torch.profiler` over `iters` calls. Unlike `cuda_ms` it
    leaves out the device's idle time between launches, which for a call
    shorter than its host overhead (K1's: a wrapper, two weight launches and
    the kernel) is most of what the events measure.

    Each trace follows a warm-up step of `iters` calls under the profiler,
    whose trace is dropped: without it the first launch of a window could go
    missing (on the card: one of 20 in most windows of K6's and K7's calls).
    A trace can still come back short, so it counts only when it is whole:
    `ours` launches a call of the hand-written kernels (`hand_written`; the
    caller takes the count from the wrapper's own launch counter), every
    kernel a whole number of launches a call, and every kernel that another
    trace of fn showed. fn is traced twice, and up to four times until a
    trace is whole; the mean of the whole traces is returned, and a run with
    none raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    ours_re = hand_written(*csrcs)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    traces = []  # kernel name -> [us, launches], a trace each
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the traced one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        per = {}
        for ev in prof.events():
            # the schedule marks its step on the device too: not a launch
            if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.name.startswith("ProfilerStep"):
                t = getattr(ev, "device_time_total", None)  # cuda_time_total in older PyTorch
                acc = per.setdefault(ev.name, [0.0, 0])
                acc[0] += ev.cuda_time_total if t is None else t
                acc[1] += 1
        traces.append(per)
        names = set().union(*traces)
        whole = [p for p in traces
                 if set(p) == names and all(n % iters == 0 for _, n in p.values())
                 and sum(n for name, (_, n) in p.items() if ours_re.search(name)) == ours * iters]
        if len(traces) >= 2 and whole:
            return sum(us for p in whole for us, _ in p.values()) / len(whole) / iters / 1e3
    raise AssertionError(f"torch.profiler: no whole trace of {iters} calls ({ours} hand-written "
                         f"launches a call) in {len(traces)}: "
                         f"{[{k: n for k, (_, n) in p.items()} for p in traces]}")


def wrapper_ms(name: str, fn) -> float:
    """`device_ms` of fn, calls of the wrapper of kernel `name`: its
    hand-written launches a call are the wrapper's own launch count over one
    call times the kernels it launches each time (`OURS`)."""
    total = lambda: sum(w.launches for w in counted().values())  # noqa: E731
    before = total()
    fn()
    torch.cuda.synchronize()
    return device_ms(fn, (total() - before) * OURS.get(name, 1))


def errors(got, want):
    """(max abs error, max abs error / max |want|), in f32."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def set_kernels(model, on: bool, cfg=None) -> None:
    """Every kernel switch of `model` off, or back on where `cfg` has it on
    (the layout encoder's and the decoder's; the int8 switch sits on the
    ConvLSTM cells)."""
    for owner in model.modules():
        for name in SWITCHES:
            if hasattr(owner, name):
                setattr(owner, name, on and getattr(cfg, name, True))


def counted():
    """The kernel wrappers, by name."""
    from aglayout_tpu_torch.ops.conv8_int8 import conv_small_int8
    from aglayout_tpu_torch.ops.resblocks import residual_trunk
    from aglayout_tpu_torch.ops.spade_c6_int8 import spade_c6_int8
    from aglayout_tpu_torch.ops.spade_conv import (
        spade_apply8,
        spade_apply_t,
        spade_few_out_conv,
        spade_few_out_conv8,
    )
    from aglayout_tpu_torch.ops.typed_expand import (
        typed_c3_expand,
        typed_c3_expand_v3,
        typed_c3_expand_v5,
        typed_c3_expand_v6,
    )

    return {k.__name__: k for k in (residual_trunk, spade_few_out_conv, spade_few_out_conv8,
                                    spade_apply8, typed_c3_expand, conv_small_int8,
                                    spade_c6_int8, spade_apply_t, typed_c3_expand_v3,
                                    typed_c3_expand_v5, typed_c3_expand_v6)}


def launch_counts(reset: bool = False):
    """Launches by kernel name since the last reset; spade_few_out_conv's by
    mode (its own name counts the flat-table launches)."""
    kernels = counted()
    modes = kernels[K2].mode_launches
    counts = {name: k.launches for name, k in kernels.items()}
    counts.update({K2: modes["flat"], K2C: modes["compact"], K2T: modes["transposed"]})
    if reset:
        for k in kernels.values():
            k.launches = 0
        for d in [modes] + [kernels[name].route_launches for name in ROUTED]:
            d.update(dict.fromkeys(d, 0))
    return counts


def route_counts():
    """Launches of K1 and K2 by kernel ("tc": tensor cores, "fma") since the
    last `launch_counts(reset=True)`."""
    kernels = counted()
    return {name: dict(kernels[name].route_launches) for name in ROUTED}


def routes_taken(before) -> str:
    """The kernels of K1 and K2 launched since `before` (a `route_counts()`)."""
    now = route_counts()
    return ", ".join(r for name in ROUTED for r, n in now[name].items() if n != before[name][r])


def mean_rel(got, want) -> float:
    """mean |got - want| / mean |want|, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().mean() / want.abs().mean()).item()


@contextlib.contextmanager
def fid_seconds():
    """Each `eval/fid.frechet_distance` call (`evaluate_run` imports it
    when it runs) timed apart: yields the list that their seconds go into."""
    from aglayout_tpu_torch.eval import fid

    inner, spent = fid.frechet_distance, []

    def timed(*args, **kw):
        t = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            spent.append(round(time.perf_counter() - t, 2))

    fid.frechet_distance = timed
    try:
        yield spent
    finally:
        fid.frechet_distance = inner


# the start of each child process started ahead of its check: the port's
# imports, the CUDA context and the kernel library, then a wait for a line
# on its standard input (`go`; at its end the child exits) before its body
AHEAD = ("import sys, time; t0 = time.time(); import torch; torch.cuda.init(); "
         "import aglayout_tpu_torch.infer.generate, aglayout_tpu_torch.train.step, "
         "aglayout_tpu_torch.train.state, aglayout_tpu_torch.utils.checkpoint; "
         "from aglayout_tpu_torch.kernels import build; build.library(); "
         "print(f'[child] ready {time.time() - t0:.1f} s', flush=True); "
         "sys.stdin.readline() or sys.exit(1); t1 = time.time(); ")


def ahead(body: str, *argv: str, stderr=subprocess.STDOUT) -> subprocess.Popen:
    """`python -c AHEAD + body argv` from the repo's root, started now; it
    runs `body` once `go` lets it."""
    return subprocess.Popen([sys.executable, "-c", AHEAD + body, *argv],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr,
                            text=True)


def ahead_module(module: str, *argv: str, **kw) -> subprocess.Popen:
    """`python -m module argv`, started ahead (`ahead`): runpy runs the
    module as `__main__`, as `-m` does."""
    return ahead(f"import runpy; runpy.run_module({module!r}, run_name='__main__', "
                 "alter_sys=True)", *argv, **kw)


def go(p: subprocess.Popen) -> None:
    """Let a child started by `ahead` run its body."""
    p.stdin.write("\n")
    p.stdin.flush()


def reap(*procs) -> None:
    """Kill each child that is still running, and wait for it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def kill_children(marker: str) -> None:
    """Kill each child process of this one whose command line holds
    `marker` (a child that a library started and holds the handle of)."""
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            if ppid == os.getpid() and marker.encode() in cmd:
                os.kill(int(pid), signal.SIGKILL)
        except (OSError, IndexError, ValueError):
            continue  # ended meanwhile


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from aglayout_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build(verbose=True)
    lib = build.library()
    log(f"[build] {path.name} built and loaded in {time.perf_counter() - t0:.2f} s")
    # the route predicates compute the tensor-core kernels' shared memory in
    # Python, so that they need no CUDA call: it must be the library's
    from aglayout_tpu_torch.ops import resblocks, spade_conv, typed_expand

    sizes = [(resblocks.trunk_tc_smem(c)[1], lib.residual_trunk_tc_smem(c))
             for c in (16, 32, 48, 64, 128)]
    # mode: 0 flat, 1 compact, 2 transposed x (flat tables)
    for h, w, k, o, f, mode in ((64, 64, 7, 3, 8, 0), (128, 128, 7, 3, 16, 1),
                                (128, 128, 7, 3, 16, 0), (80, 64, 5, 4, 5, 0), (64, 64, 7, 3, 8, 1),
                                (128, 128, 3, 1, 16, 1), (64, 64, 7, 3, 8, 2), (128, 128, 7, 3, 16, 2),
                                (128, 128, 7, 3, 8, 2), (80, 64, 5, 4, 5, 2), (32, 64, 3, 1, 8, 2)):
        py = spade_conv.head_tc_layout(h, w, k, o, f, mode == 1, mode == 2)[1]
        sizes.append((py, lib.spade_few_out_conv_tc_smem(h, w, k, o, f, mode)))
        if mode == 1:
            sizes.append((py, lib.spade_few_out_conv8_smem(h, w, k, o, f)))
    sizes += [(typed_expand.typed_tc_smem(c2, c4, s3), lib.typed_c3_expand_smem(c2, c4, s3))
              for c2, c4, s3 in ((128, 256, 32), (32, 64, 32), (176, 64, 16), (192, 384, 32),
                                 (256, 512, 32), (128, 256, 64), (128, 256, 24), (48, 80, 24),
                                 (256, 512, 64), (272, 544, 16), (256, 1024, 16), (320, 640, 32))]
    if any(py != c for py, c in sizes):
        raise AssertionError(f"shared memory, Python against the library: {sizes}")
    log(f"[build] the tensor-core kernels' shared memory: Python's sizes equal the library's "
        f"({len(sizes)} shapes)")


def phase_generate(size: int, expect, smi: str, iters: int = 10, label: str = "", against=None,
                   **cfg_kw):
    """Full-width generate at `size` with the kernels on and off; with them
    on every kernel must launch exactly `expect` times (0 where it is not
    named), with them off none. `cfg_kw` are Config fields of a
    configuration other than the default (`int8_serving`, `typed_c3`, a
    switch off); with `against` (the default model and its kernels-on image)
    the image and the time are held against the default's. Returns the model,
    the kernels-on launch counts and the kernels-on image."""
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.ops.image import imagenet_deprocess_batch

    tag = f"generate {size}{' ' + label if label else ''}"
    cfg = config_for(size, batch_size=B, max_objects=O, bf16=True, **cfg_kw)
    model = build_generator(cfg, "cuda", seed=0)
    ins = layouts(cfg, B, O, seed=0, device="cuda")
    switch = functools.partial(set_kernels, model, cfg=cfg)
    switch(True)
    launch_counts(reset=True)
    img_on = model.generate(*ins)
    torch.cuda.synchronize()
    launches, routes = launch_counts(), route_counts()
    switch(False)
    img_off = model.generate(*ins)
    torch.cuda.synchronize()
    if launch_counts() != launches:
        raise AssertionError("a kernel launched with its switch off")
    log(f"[{tag}] launches with the kernels on: {launches}; K1 and K2 by kernel: {routes}")
    wrong = {name: n for name, n in launches.items() if n != expect.get(name, 0)}
    if wrong:
        raise AssertionError(f"{tag}: launches {wrong}, expected {expect}")
    # at the published widths in bf16 every K1 and K2 launch takes the tensor cores
    tc = {"residual_trunk": {"tc": launches["residual_trunk"], "fma": 0},
          K2: {"tc": launches[K2] + launches[K2C], "fma": 0}}
    if routes != tc:
        raise AssertionError(f"{tag}: K1 and K2 took {routes}, expected {tc}")
    for name, img in (("on", img_on), ("off", img_off)):
        if img.shape != (B, size, size, 3) or not torch.isfinite(img.float()).all():
            raise AssertionError(f"kernels-{name} output: shape {tuple(img.shape)} or non-finite")
    # bf16 on both sides; the kernels round at other places than the plain
    # path (the trunk keeps its skip chain in f32, SPADE-4 applies in f32
    # and rounds once where the dense SPADE rounds the normalized input and
    # 1 + gamma), and bf16 roundings carry through the decoder. At 128^2 the
    # image of these seeded weights is 2.4x smaller in mean (mean |img|
    # 0.017 against 0.041 at 64^2 on an H100), so the same roundings weigh
    # more: bf16 alone, kernels on or off, is 1.7e-2 in mean from the f32
    # model there, hence 3e-2.
    max_tol, mean_tol = 5e-2, (1e-2 if size == 64 else 3e-2)
    if against is not None:
        # A configuration against the default one, both with the kernels on.
        # int8: K6 equals its plain version bit for bit, so the on/off limits
        # hold; against the non-int8 bf16 image the gate convs' quantisation
        # error (under 1 % of the pre-activations, damped by the gates) comes
        # on top of the bf16 roundings it reshuffles: the limits are those of
        # bf16 against f32. The typed variants round where v4 rounds and the
        # K2 routes where K3 rounds, so they come far closer than the limits.
        checks = (("on vs off", img_on, img_off), ("vs the default", img_on, against[1]))
    else:
        # The same weights in f32, kernels off, TF32 off: the reference both
        # bf16 paths are held against.
        set_tf32(False)
        ref = build_generator(config_for(size, batch_size=B, max_objects=O), "cuda", seed=0)
        set_kernels(ref, False)
        img_ref = ref.generate(*ins)
        set_tf32(True)
        del ref
        checks = (("on vs off", img_on, img_off), ("on vs f32", img_on, img_ref),
                  ("off vs f32", img_off, img_ref))
    for name, got, want in checks:
        err, rel = errors(got, want)
        mrel = mean_rel(got, want)
        log(f"[{tag}] kernels {name}: max abs err {err:.3e}, rel {rel:.3e} "
            f"(tol {max_tol:.0e}), mean rel {mrel:.3e} (tol {mean_tol:.0e})")
        if rel > max_tol or mrel > mean_tol:
            raise AssertionError(f"{tag} {name} disagree")
    u8 = imagenet_deprocess_batch(img_on)
    log(f"[{tag}] deprocessed to {tuple(u8.shape)} {u8.dtype}, "
        f"mean {u8.float().mean().item():.2f}")
    del img_off, u8, checks

    def timed(what, runs):  # alternated: the card drifts
        times = {}
        for key, fn in runs:
            times.setdefault(key, []).append(cuda_ms(fn, iters=iters))
        for key, ms_runs in times.items():
            ms = sum(ms_runs) / len(ms_runs)
            log(f"[{tag}] {size}^2 B={B} bf16 {what} {key}: {ms:.3f} ms/batch, "
                f"{B / ms * 1e3:.1f} img/s on {smi} (runs {ms_runs})")

    def run(on):
        switch(on)
        model.generate(*ins)

    if against is None or cfg.int8_serving:
        timed("kernels", [("on" if on else "off", functools.partial(run, on))
                          for on in (True, False, False, True, True, False)])
    switch(True)
    if against is not None:
        default = against[0]
        timed("kernels on,", [(key, lambda m=m: m.generate(*ins)) for key, m in
                              ((label, model), ("default", default), ("default", default),
                               (label, model), (label, model), ("default", default))])
    return model, launches, img_on


def phase_bench():
    """The serving entry point, `python -m aglayout_tpu_torch.bench`, in
    process: the default, the --int8 and the A/B configurations, one JSON
    line each."""
    from aglayout_tpu_torch import bench

    for argv in ([], ["--int8"], ["--typed_c3", "v5"], ["--typed_c3", "v6"], ["--no_head8"],
                 ["--no_head8", "--no_compact_heads"], []):
        out = bench.run(bench.parser().parse_args(argv + ["--iters", "5"]))
        log(f"[bench] {' '.join(argv) or '(default)'}: {json.dumps(out)}")
        if not (out["value"] > 0 and np.isfinite(out["ms_per_batch"])):
            raise AssertionError(f"bench {argv}: {out}")


def trunk_inputs(dtype, gen, dev):
    c, r = 64, 6
    h = torch.randn(B, c, 8, 8, generator=gen).to(dev, dtype)
    w1, w2 = (torch.randn(r, c, c, 3, 3, generator=gen).mul(1 / 24).to(dev) for _ in range(2))
    ab1, ab2 = (
        torch.stack([1 + 0.1 * torch.randn(r, c, generator=gen), 0.1 * torch.randn(r, c, generator=gen)], 1).to(dev)
        for _ in range(2)
    )
    return h, w1, w2, ab1, ab2


def table_inputs(spade, c: int, size: int, compact: bool, dtype, gen, dev):
    """x (B, c, size, size) and SPADE tables of `spade` from a random segmap."""
    seg = torch.randn(B, 64, 8, 8, generator=gen).to(dev)
    if compact:
        a_tab, b_tab = spade.folded_affine_tables_compact(seg)
    else:
        a_tab, b_tab = spade.folded_affine_tables(seg, size // 8)
    x = torch.randn(B, c, size, size, generator=gen).to(dev, dtype)
    return x, a_tab.to(dtype).contiguous(), b_tab.to(dtype).contiguous()


def typed_inputs(model, dtype, gen, dev):
    """Random inputs over the typed kernel's whole domain (as
    tests/test_pallas_typed_expand.py makes them) at 128^2, B=128, O=10."""
    n, c2, s3 = B * O, 128, 32
    i32 = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(dev)  # noqa: E731
    z2 = torch.randn(n, 12, 12, c2, generator=gen).to(dev, dtype)
    ab = torch.randn(n, 2, 256, generator=gen).mul(0.5).to(dev)
    return (z2, i32(13, (n, 14, 4)), i32(14, (n, 14, 4)), i32(14, (n, s3)), i32(14, (n, s3)), ab,
            model.layout_encoder.c3.weight)


def padded_grid(z2):
    """The (n, 12, 12, c2) type grid zero-padded to v3's (n, 13, 13, c2)."""
    return torch.nn.functional.pad(z2, (0, 0, 0, 1, 0, 1))


def typed_v3_inputs(model, dtype, gen, dev):
    """The same for the typed v3 kernel: the grid zero-padded to 13 x 13."""
    z2, *rest = typed_inputs(model, dtype, gen, dev)
    return (padded_grid(z2), *rest)


def head_inputs(dec, mode: str, dtype, gen, dev):
    """K2 at the c7 head's shape in one of its modes: x (B, 128, 128, 128),
    laid out (H, W, B, C) for "transposed", SPADE-5's tables, c7's weights."""
    x, a_tab, b_tab = table_inputs(dec.spade_5, 128, 128, mode == "compact", dtype, gen, dev)
    if mode == "transposed":
        x = x.permute(2, 3, 0, 1).contiguous()
    return x, a_tab, b_tab, dec.c7.weight, dec.c7.bias


def gate_inputs(cell, dtype, gen, dev):
    """K6 at the wide ConvLSTM layer's shape: cat(x, h) (B, 640, 8, 8) and
    the cell's quantised 640 -> 512 gate conv (wq, sw)."""
    x = torch.randn(B, cell.conv.in_channels, 8, 8, generator=gen).to(dev, dtype)
    return (x, *cell.quantized_weights()[:2])


def box_typed_inputs(model):
    """The typed kernel's inputs as the 128^2 path makes them from the
    serving bench's layouts (B=128, O=10): what `LayoutEncoder` hands the
    typed kernel in one generate, recorded."""
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.ops import typed_expand as te

    cfg = config_for(128, batch_size=B, max_objects=O, bf16=True)  # the model's
    seen, kernel = [], te.VARIANTS["v4"]
    te.VARIANTS["v4"] = lambda *a: seen.append(a) or kernel(*a)
    try:
        with torch.no_grad():
            model.generate(*layouts(cfg, B, O, seed=0, device="cuda"))
    finally:
        te.VARIANTS["v4"] = kernel
    return seen[0]


def c6_inputs(dec, dtype, gen, dev):
    """K7 at SPADE-4 + c6's shape, with c6's quantised weights."""
    from aglayout_tpu_torch.ops.int8 import quantize_conv_weights

    return (*table_inputs(dec.spade_4, 128, 128, True, dtype, gen, dev),
            *quantize_conv_weights(dec.c6.weight))


def bound(args, out, ops: float, peak: float):
    """(bound_ms, bound_by): the larger of the bytes of every tensor argument
    and of the output, each moved once at the card's memory rate, and of
    `ops` operations at `peak` operations a second."""
    moved = sum(t.numel() * t.element_size() for t in (*args, out) if isinstance(t, torch.Tensor))
    t_bytes, t_ops = moved / HBM * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(model64, model128, model_int8):
    """Each kernel against its plain version; returns the bf16 rows."""
    import torch.nn.functional as F

    from aglayout_tpu_torch.ops import typed_expand as te
    from aglayout_tpu_torch.ops.conv8_int8 import conv_small_int8_plain, pack_conv_small_int8_weights
    from aglayout_tpu_torch.ops.int8 import quantize_conv_weights
    from aglayout_tpu_torch.ops.resblocks import residual_trunk_plain
    from aglayout_tpu_torch.ops.spade_c6_int8 import spade_c6_int8_plain
    from aglayout_tpu_torch.ops.spade_conv import (
        compact_to_flat,
        spade_apply8_plain,
        spade_apply_t_plain,
        spade_few_out_conv8_plain,
        spade_few_out_conv_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    k = counted()
    dec64, dec128 = model64.decoder, model128.decoder
    cell0 = model_int8.layout_encoder.clstm.cell_list[0]
    # the gate conv's weights packed once, as `LayoutFuser` packs them a forward
    k6 = functools.partial(k["conv_small_int8"], packed=cell0.quantized_weights()[2])
    # c6's weights packed once, as a caller of K7 would pack them for all its calls
    k7 = functools.partial(k["spade_c6_int8"], f=16,
                           packed=pack_conv_small_int8_weights(quantize_conv_weights(dec128.c6.weight)[0]))
    # tolerance on max|err| / max|plain|: f32 only differs in summation
    # order; in bf16 the intermediates are rounded to bf16 on both sides, so
    # an order difference can flip a rounding (one bf16 ulp is 2^-8).
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    # the two int8 kernels sum exact integers, and the plain versions make
    # the same f32 products around them: 1e-6 in f32. The two SPADE applies
    # compute relu(x * A + B) once in f32: in bf16 x * A is exact, so they
    # give the plain version's bits; in f32 their fused multiply-add
    # differs from its product and sum by a rounding: 1e-6
    exact = {"conv_small_int8", "spade_c6_int8", "spade_apply8", "spade_apply_t"}
    conv_ops = lambda x, w, o: 2.0 * x.shape[0] * x.shape[2] * x.shape[3] * w[0].numel() * o  # noqa: E731
    head_ops = lambda a: (conv_ops(a[0], a[3], 3), BF16)  # noqa: E731
    # W3z: 14 row types x 12 (13 on the padded grid) rows an object
    # W3z: 14 row types x 12 rows an object (v3 too: its padded row and
    # column are zeros by contract, so its function's work is K5's)
    typed_ops = lambda a: (2.0 * a[0].shape[0] * 14 * 12 * a[6].numel(), BF16)  # noqa: E731

    def typed_v6_ops(a):
        # v6 skips the product of a row type that no output row has: count
        # the types that selR names, object by object
        types = te.present_row_types(a[3])[1].sum().item()
        return 2.0 * types * 12 * a[6].numel(), BF16

    def mode(name, **kw):  # K2 or its plain version in one of its modes
        fn = k[K2] if name == "kernel" else spade_few_out_conv_plain
        return functools.partial(fn, f=16, **kw)

    cases = [  # name, kernel, plain version, inputs by dtype, (operations, peak) of the bf16 call
        ("residual_trunk", k["residual_trunk"], residual_trunk_plain,
         lambda dt: trunk_inputs(dt, gen, dev),
         lambda a: (2 * conv_ops(a[0], a[1][0], 64) * a[1].shape[0], BF16)),
        (K2, functools.partial(k[K2], f=8), functools.partial(spade_few_out_conv_plain, f=8),
         lambda dt: (*table_inputs(dec64.spade_3, 64, 64, False, dt, gen, dev),
                     dec64.c4.weight, dec64.c4.bias), head_ops),
        ("spade_few_out_conv8", functools.partial(k["spade_few_out_conv8"], f=16),
         functools.partial(spade_few_out_conv8_plain, f=16),
         lambda dt: head_inputs(dec128, "compact", dt, gen, dev), head_ops),
        ("spade_apply8", functools.partial(k["spade_apply8"], f=16),
         functools.partial(spade_apply8_plain, f=16),
         lambda dt: table_inputs(dec128.spade_4, 128, 128, True, dt, gen, dev),
         lambda a: (3.0 * a[0].numel(), F32)),
        ("typed_c3_expand", k["typed_c3_expand"], te.typed_c3_expand_plain,
         lambda dt: typed_inputs(model128, dt, gen, dev), typed_ops),
        ("conv_small_int8", k6, conv_small_int8_plain,
         lambda dt: gate_inputs(cell0, dt, gen, dev),
         lambda a: (conv_ops(a[0], a[1], a[1].shape[0]), INT8)),
        ("spade_c6_int8", k7,
         functools.partial(spade_c6_int8_plain, f=16), lambda dt: c6_inputs(dec128, dt, gen, dev),
         lambda a: (conv_ops(a[0], a[3], a[3].shape[0]), INT8)),
        ("spade_apply_t", functools.partial(k["spade_apply_t"], f=16),
         functools.partial(spade_apply_t_plain, f=16),
         lambda dt: table_inputs(dec128.spade_4, 128, 128, False, dt, gen, dev),
         lambda a: (3.0 * a[0].numel(), F32)),
        ("typed_c3_expand_v3", k["typed_c3_expand_v3"], te.typed_c3_expand_v3_plain,
         lambda dt: typed_v3_inputs(model128, dt, gen, dev), typed_ops),
        ("typed_c3_expand_v5", k["typed_c3_expand_v5"], te.typed_c3_expand_v5_plain,
         lambda dt: typed_inputs(model128, dt, gen, dev), typed_ops),
        ("typed_c3_expand_v6", k["typed_c3_expand_v6"], te.typed_c3_expand_v6_plain,
         lambda dt: typed_inputs(model128, dt, gen, dev), typed_v6_ops),
        (K2C, mode("kernel", compact=True), mode("plain", compact=True),
         lambda dt: head_inputs(dec128, "compact", dt, gen, dev), head_ops),
        (K2T, mode("kernel", transposed=True), mode("plain", transposed=True),
         lambda dt: head_inputs(dec128, "transposed", dt, gen, dev), head_ops),
        # K2 on flat tables at the c7 head's shape: what `use_compact_heads`
        # off launches; no row of its own, the time goes into K2's row
        (K2 + " at c7", mode("kernel"), mode("plain"),
         lambda dt: head_inputs(dec128, "flat", dt, gen, dev), head_ops),
    ]
    rows = {}
    for name, kernel, plain, make, work in cases:
        for dt in (torch.bfloat16, torch.float32):
            set_tf32(dt != torch.float32)
            with torch.no_grad():
                args = make(dt)
                before = route_counts()
                got, want = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                taken = routes_taken(before)
                err, rel = errors(got, want)
                if name == K2C and dt == torch.bfloat16:
                    # the same kernel as K3 (csrc/spade_head_tc.cuh): the same bits
                    if not torch.equal(got, k["spade_few_out_conv8"](*args, 16)):
                        raise AssertionError("K2 on compact tables differs from K3")
                    log(f"[kernel] {K2C} bf16 equals spade_few_out_conv8 bit for bit")
                if name == K2T and dt == torch.bfloat16:
                    # the tensor-core kernel with x by a tensor copy, applied in
                    # place; the rest is flat K2's: its bits on x permuted
                    flat = k[K2](args[0].permute(2, 3, 0, 1).contiguous(), *args[1:], 16)
                    if taken != "tc" or not torch.equal(got, flat):
                        raise AssertionError(f"K2t took {taken!r}, or differs from flat K2 on "
                                             "the permuted x")
                    log(f"[kernel] {K2T} bf16 took the tensor cores and equals flat K2 on the "
                        "permuted x bit for bit")
                if name == "typed_c3_expand_v3":
                    # K5's kernel reading the padded grid's 12 x 12 in place: K5's bits
                    if not torch.equal(got, k["typed_c3_expand"](args[0][:, :12, :12].contiguous(),
                                                                 *args[1:])):
                        raise AssertionError(f"typed v3 {dt}: not K5's bits on the inner grid")
                    log(f"[kernel] typed_c3_expand_v3 {str(dt)[6:]} equals typed_c3_expand on "
                        "the inner 12 x 12 grid bit for bit")
                ms_plain_a = cuda_ms(lambda: plain(*args), iters=PLAIN_ITERS)
                ms_a = cuda_ms(lambda: kernel(*args))
                ms_b = cuda_ms(lambda: kernel(*args))
                ms_plain_b = cuda_ms(lambda: plain(*args), iters=PLAIN_ITERS)
                on_device = wrapper_ms(name, lambda: kernel(*args)) if dt == torch.bfloat16 else None
            ms, ms_plain = (ms_a + ms_b) / 2, (ms_plain_a + ms_plain_b) / 2
            limit = 1e-6 if name in exact and dt == torch.float32 else tol[dt]
            log(f"[kernel] {name} {str(dt)[6:]}: shape {tuple(got.shape)}, max abs err {err:.3e}, "
                f"rel {rel:.3e} (tol {limit:.0e}); kernel{' (' + taken + ')' if taken else ''} "
                f"{ms:.4f} ms, plain {ms_plain:.4f} ms "
                f"(runs {ms_a:.4f}/{ms_b:.4f} vs {ms_plain_a:.4f}/{ms_plain_b:.4f})"
                f"{'' if on_device is None else f'; kernel on the device {on_device:.4f} ms'}")
            if not torch.isfinite(got.float()).all() or rel > limit:
                raise AssertionError(f"{name} {dt}: kernel disagrees with its plain version")
            if ((name == "spade_c6_int8" or (name in exact and dt == torch.bfloat16))
                    and not torch.equal(got, want)):
                raise AssertionError(f"{name} {dt}: not its plain version's bits")
            if name == "spade_apply_t":
                # the same function as K4 on K4's compact tables made flat: K4's bits
                with torch.no_grad():
                    x, a_tab, b_tab = table_inputs(dec128.spade_4, 128, 128, True, dt, gen, dev)
                    flat = (compact_to_flat(t, 16).contiguous() for t in (a_tab, b_tab))
                    same = torch.equal(k[name](x, *flat, 16), k["spade_apply8"](x, a_tab, b_tab, 16))
                del x, a_tab, b_tab
                if not same:
                    raise AssertionError(f"{name} {dt}: not K4's bits on K4's tables made flat")
                log(f"[kernel] {name} {str(dt)[6:]} equals spade_apply8 on its tables made flat "
                    "bit for bit")
            if dt == torch.bfloat16:
                bound_ms, bound_by = bound(args, got, *work(args))
                log(f"[kernel] {name} bf16: bound {bound_ms:.4f} ms by {bound_by}, "
                    f"kernel on the device / bound {on_device / bound_ms:.1f}")
                if name not in SOURCES:  # K2 at the c7 shape
                    rows[K2].update(c7_ms=on_device, c7_plain_ms=ms_plain, c7_bound_ms=bound_ms)
                    continue
                source, replaces = SOURCES[name]
                # library_ms: no single PyTorch call computes any of these
                # functions (each fuses an affine, a relu, a quantisation or
                # a gather with its conv), so there is nothing to time
                # ms: the call's time on the device (the kernel and its weight
                # launches), not the events' span, which holds the host's gaps
                rows[name] = {"name": name, "route": "cuda", "source": source,
                              "replaces": replaces, "max_abs_err": err, "ms": on_device,
                              "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": None}
                # the dense routes the int8 kernels compete with (other
                # functions: exact bf16 convs), for the record
                if name == "conv_small_int8":
                    w = cell0.conv.weight.to(dt)
                    dense = cuda_ms(lambda: F.conv2d(args[0], w, padding=2))
                    log(f"[kernel] {name}: cuDNN bf16 F.conv2d of the same shape {dense:.4f} ms")
                if name == "spade_c6_int8":
                    w = dec128.c6.weight.to(dt)
                    dense = cuda_ms(lambda: F.conv2d(k["spade_apply8"](*args[:3], 16), w, padding=2))
                    log(f"[kernel] {name}: spade_apply8 + cuDNN bf16 F.conv2d {dense:.4f} ms")
            del args, got, want
    set_tf32(True)
    phase_kernels_small(k, gen, dev, tol[torch.bfloat16])
    phase_typed_v6(model128, gen, dev, rows["typed_c3_expand_v6"])
    phase_k6_shapes(k, gen, dev)
    return rows


def phase_typed_v6(model128, gen, dev, row):
    """v6 runs K5's kernel on the row types an object's selR names: held
    against K5 bit for bit (each row is summed in K5's order) on the random
    inputs, on the inputs the 128^2 path makes from the serving bench's
    layouts, and with objects of one row type and of none (every row outside
    [0, 14)); and timed on the box-derived inputs beside K5, in turns."""
    from aglayout_tpu_torch.ops import typed_expand as te

    v4, v6 = te.typed_c3_expand, te.typed_c3_expand_v6
    edge = list(typed_inputs(model128, torch.bfloat16, gen, dev))
    sel = edge[3].clone()
    sel[0], sel[1], sel[2, ::2] = 14, 5, -3
    edge[3] = sel
    cases = (("random", typed_inputs(model128, torch.bfloat16, gen, dev)),
             ("box-derived", box_typed_inputs(model128)), ("edge", tuple(edge)))
    for label, args in cases:
        _, counts, rows = te.present_row_types(args[3])
        sel = args[3]
        outside = (sel < 0) | (sel >= 14)  # rows of no type: zeros, which the plain version
        plain_args = (*args[:3], sel.clamp(0, 13), *args[4:])  # cannot index, so they are masked
        with torch.no_grad():
            got, want = v6(*args), v4(*args)
            plain = te.typed_c3_expand_plain(*plain_args).masked_fill(outside[:, None, :, None], 0)
            err, rel = errors(got, plain)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or rel > 2e-2 or (label == "edge" and got[0].any()):
            raise AssertionError(f"typed v6 on {label} inputs: not K5's bits, or {rel:.3e} from "
                                 "its plain version, or an object of no row type not zero")
        log(f"[kernel] typed_c3_expand_v6 bf16 on {label} inputs: equals typed_c3_expand bit for "
            f"bit, rel err {rel:.3e} against the plain version (tol 2e-2); row types an object "
            f"{counts.float().mean().item():.2f} of 14, W3z rows {rows.float().mean().item():.1f} "
            "of 192")
        if label == "box-derived":
            runs = {"v6": [], "v4": []}
            for name in ("v6", "v4", "v4", "v6"):
                fn = v6 if name == "v6" else v4
                runs[name].append(wrapper_ms(name, lambda: fn(*args)))
            ms = {name: sum(r) / 2 for name, r in runs.items()}
            log(f"[kernel] typed_c3_expand_v6 bf16 on box-derived inputs: on the device "
                f"{ms['v6']:.4f} ms (runs {runs['v6']}), typed_c3_expand {ms['v4']:.4f} ms "
                f"(runs {runs['v4']}); on random inputs {row['ms']:.4f} ms")


def phase_k6_shapes(k, gen, dev):
    """K6 bit for bit against its plain version at the shapes past the
    published one: Cout not a multiple of 64 (conv_dim 60's 600 -> 480),
    Cin not a multiple of 32, a batch of one partial CTA, k = 1, 3 (the
    kernel's draining instantiation) and 7."""
    from aglayout_tpu_torch.ops.conv8_int8 import conv_small_int8_plain, pack_conv_small_int8_weights
    from aglayout_tpu_torch.ops.int8 import quantize_conv_weights

    for b, cin, cout, ks in ((4, 600, 480, 5), (6, 144, 64, 5), (5, 40, 24, 3), (3, 50, 72, 7),
                             (9, 300, 64, 1)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(b, cin, 8, 8, generator=gen).to(dev, dt)
            wq, sw = quantize_conv_weights(torch.randn(cout, cin, ks, ks, generator=gen).mul(0.02).to(dev))
            got = k["conv_small_int8"](x, wq, sw, k=ks, packed=pack_conv_small_int8_weights(wq))
            want = conv_small_int8_plain(x, wq, sw, k=ks)
            if not torch.equal(got, want):
                raise AssertionError(f"conv_small_int8 ({b}, {cin}) -> {cout}, k={ks}, {dt}: "
                                     "not its plain version's bits")
    log("[kernel] conv_small_int8 equals its plain version bit for bit at (4, 600 -> 480), "
        "(6, 144 -> 64), (5, 40 -> 24, k=3), (3, 50 -> 72, k=7), (9, 300 -> 64, k=1), bf16 and f32")


def phase_kernels_small(k, gen, dev, limit: float):
    """The tensor-core kernels in bf16 at the widths of the small reference
    model (conv_dim=16: C = 16 in the trunk and the c4 head, 32 at the c7
    head, c2 = 32, c4 = 64), which generate reaches in f32 only, where they
    run their FMA kernels: K1, K2, K2t, K3, K5 and its v3 and v6 schedules;
    K2t also equal to K2 on the permuted x, and v3 to K5 on the inner grid,
    bit for bit."""
    from aglayout_tpu_torch.ops.resblocks import residual_trunk_plain
    from aglayout_tpu_torch.ops.spade_conv import spade_few_out_conv8_plain, spade_few_out_conv_plain
    from aglayout_tpu_torch.ops.typed_expand import typed_c3_expand_plain, typed_c3_expand_v3_plain

    dt = torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)  # noqa: E731
    i32 = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(dev)  # noqa: E731
    trunk = (rnd(3, 16, 8, 8).to(dt), *(0.08 * rnd(2, 16, 16, 3, 3) for _ in range(2)),
             *(torch.stack([1 + 0.1 * rnd(2, 16), 0.1 * rnd(2, 16)], 1) for _ in range(2)))
    flat = [(s + 0.3 * rnd(3, 8, 5, 16, 64)).to(dt) for s in (1.0, 0.0)]
    head4 = (rnd(3, 16, 64, 64).to(dt), *flat, 0.05 * rnd(3, 16, 7, 7), rnd(3), 8)
    head4t = (head4[0].permute(2, 3, 0, 1).contiguous(), *head4[1:])
    tabs = [(s + 0.3 * rnd(3, 8, 5, 32, 40)).to(dt) for s in (1.0, 0.0)]
    head = (rnd(3, 32, 128, 128).to(dt), *tabs, 0.05 * rnd(3, 32, 7, 7), rnd(3), 16)
    n = 9
    typed = (rnd(n, 12, 12, 32).to(dt), i32(13, (n, 14, 4)), i32(14, (n, 14, 4)), i32(14, (n, 32)),
             i32(14, (n, 32)), 0.5 * rnd(n, 2, 64), 0.05 * rnd(64, 32, 4, 4))
    typed_v3 = (padded_grid(typed[0]), *typed[1:])
    k2t = functools.partial(k[K2], transposed=True)
    outs = {}
    for name, kernel, plain, args in (
            ("residual_trunk", k["residual_trunk"], residual_trunk_plain, trunk),
            (K2, k[K2], spade_few_out_conv_plain, head4),
            (K2T, k2t, functools.partial(spade_few_out_conv_plain, transposed=True), head4t),
            ("spade_few_out_conv8", k["spade_few_out_conv8"], spade_few_out_conv8_plain, head),
            ("typed_c3_expand", k["typed_c3_expand"], typed_c3_expand_plain, typed),
            ("typed_c3_expand_v3", k["typed_c3_expand_v3"], typed_c3_expand_v3_plain, typed_v3),
            ("typed_c3_expand_v6", k["typed_c3_expand_v6"], typed_c3_expand_plain, typed)):
        before = route_counts()
        with torch.no_grad():
            outs[name] = kernel(*args)
            err, rel = errors(outs[name], plain(*args))
        taken = routes_taken(before)
        log(f"[kernel] {name} bf16 at the small model's widths{' (' + taken + ')' if taken else ''}: "
            f"max abs err {err:.3e}, rel {rel:.3e} (tol {limit:.0e})")
        if rel > limit or taken not in ("", "tc") or (name == K2T and taken != "tc"):
            raise AssertionError(f"{name}: the small-width kernel disagrees with its plain version "
                                 "or took its FMA kernel")
    if not (torch.equal(outs[K2T], outs[K2])
            and torch.equal(outs["typed_c3_expand_v3"], outs["typed_c3_expand"])):
        raise AssertionError("small widths: K2t is not K2's bits on the permuted x, or v3 not K5's")
    log(f"[kernel] small widths: {K2T} equals {K2} on the permuted x, typed_c3_expand_v3 equals "
        "typed_c3_expand on the inner grid, bit for bit")


def phase_reference(size: int, expect, int8: bool = False, **cfg_kw):
    """Small f32 generator: kernels on the card against the CPU plain path;
    the kernels in `expect`, and no others, must launch. With `int8`, the
    model is built with `int8_serving` and the threshold lowered so its
    narrow cells take the int8 route; `cfg_kw` are the Config fields of an
    A/B configuration."""
    import aglayout_tpu_torch.models.convlstm as convlstm
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator

    set_tf32(False)
    cfg = config_for(size, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23,
                     int8_serving=int8, **cfg_kw)
    threshold = convlstm._INT8_MIN_CINCOUT
    if int8:
        convlstm._INT8_MIN_CINCOUT = 1
    try:
        cpu = build_generator(cfg, "cpu", seed=1)
        gpu = build_generator(cfg, "cuda", seed=1)
        ins = layouts(cfg, 2, 4, seed=1, device="cpu")
        launch_counts(reset=True)
        want = cpu.generate(*ins)
        got = gpu.generate(*(t.cuda() for t in ins)).cpu()
    finally:
        convlstm._INT8_MIN_CINCOUT = threshold
    ran = sorted(name for name, n in launch_counts().items() if n)
    err, rel = errors(got, want)
    # f32 on both sides; only summation order differs. With int8, a last-bit
    # difference upstream can move an activation across a quantisation step
    # (1/127 of its chunk's max), which the gates damp: 1e-3
    tol = 1e-3 if int8 else 1e-4
    log(f"[reference {size}{' int8' if int8 else ''}{' ' + str(cfg_kw) if cfg_kw else ''}] "
        f"conv_dim=16 f32, card vs CPU: "
        f"max abs err {err:.3e}, rel {rel:.3e} (tol {tol:.0e}); kernels launched: {ran}")
    set_tf32(True)
    if rel > tol:
        raise AssertionError(f"the card's {size}^2 generate disagrees with the CPU reference")
    if set(ran) != {name for name, n in expect.items() if n}:
        raise AssertionError(f"the {size}^2 reference run launched {ran}, expected {expect}")


def phase_reference_cell():
    """The 640 -> 512 ConvLSTM cell alone, f32, at the real int8 threshold:
    K6 on the card against the plain version on the CPU."""
    from aglayout_tpu_torch.models.convlstm import ConvLSTMCell
    from aglayout_tpu_torch.models.generator import init_weights
    from aglayout_tpu_torch.ops.conv8_int8 import conv_small_int8

    gen = torch.Generator().manual_seed(2)
    cell = init_weights(ConvLSTMCell(512, 128, int8_serving=True), gen).eval()
    narrow = ConvLSTMCell(128, 64, int8_serving=True)
    if not cell.int8_engaged or narrow.int8_engaged:
        raise AssertionError("the int8 gate: 640 -> 512 must engage, 192 -> 256 must not")
    x = torch.randn(6, 512, 8, 8, generator=gen)
    h, c = (torch.randn(6, 128, 8, 8, generator=gen) * 0.5 for _ in range(2))
    before = conv_small_int8.launches
    with torch.no_grad():
        want = torch.cat(cell(x, h, c), 1)
        got = torch.cat(cell.cuda()(x.cuda(), h.cuda(), c.cuda()), 1).cpu()
    err, rel = errors(got, want)
    log(f"[reference cell] ConvLSTMCell 640 -> 512 int8, B=6 f32, card vs CPU: max abs err "
        f"{err:.3e}, rel {rel:.3e} (tol 1e-5)")
    if conv_small_int8.launches != before + 1:
        raise AssertionError("the wide cell did not launch conv_small_int8")
    if rel > 1e-5:  # the same integers on both sides; sigmoid and tanh differ in their last bits
        raise AssertionError("the card's int8 cell disagrees with the CPU")


def phase_fallthrough(size: int):
    """Generate at conv_dim=12 on the card (the other widths the published
    ones, B=4). In bf16 the tensor-core kernels want C % 16 == 0 and the
    typed ones c2 % 16 == 0, so each site takes the next route its
    predicates give, and no wrapper raises; the image is held against the
    same model with the kernels off and against the f32 plain path on the
    CPU. At this width bf16's roundings weigh more than at the published
    one (at 64^2, 1.2e-2 in mean from either, against 7.4e-3 and 5.6e-3 at
    conv_dim=64), so the mean limit is the 128^2 one, 3e-2, at both sizes.
    In f32 (TF32 off) the same model on the card, through the FMA kernels,
    against the CPU: 1e-4."""
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator

    expect = {"residual_trunk": 1, K2: 1}
    expect32 = dict(expect)
    if size == 128:
        expect.update({K2C: 1, "spade_apply8": 1})  # K3 and the typed kernels do not take C = 24
        expect32.update({"spade_few_out_conv8": 1, "spade_apply8": 1})  # K3's f32 kernel does
    fma = {"residual_trunk": {"tc": 0, "fma": 1}, K2: {"tc": 0, "fma": 1 + (size == 128)}}
    cfg = config_for(size, conv_dim=12, bf16=True)
    ins = layouts(cfg, 4, O, seed=3, device="cpu")
    tag = f"[fall-through {size}] conv_dim=12"
    ran = lambda: {n: c for n, c in launch_counts().items() if c}  # noqa: E731
    with torch.no_grad():
        model = build_generator(cfg, "cuda", seed=3)
        launch_counts(reset=True)
        img_on = model.generate(*(t.cuda() for t in ins))
        torch.cuda.synchronize()
        launches, routes = ran(), route_counts()
        set_kernels(model, False)
        img_off = model.generate(*(t.cuda() for t in ins))
        want = build_generator(config_for(size, conv_dim=12), "cpu", seed=3).generate(*ins)
        set_tf32(False)
        launch_counts(reset=True)
        img32 = build_generator(config_for(size, conv_dim=12), "cuda", seed=3).generate(
            *(t.cuda() for t in ins)).cpu()
        launches32 = ran()
        set_tf32(True)
    log(f"{tag} bf16: launches {launches}, K1 and K2 by kernel {routes}; f32: launches {launches32}")
    if launches != expect or routes != fma or launches32 != expect32:
        raise AssertionError(f"fall-through {size}: expected launches {expect}, routes {fma}, "
                             f"and in f32 {expect32}")
    img_on, img_off = img_on.float().cpu(), img_off.float().cpu()
    if img_on.shape != (4, size, size, 3) or not torch.isfinite(img_on).all():
        raise AssertionError(f"fall-through {size}: output shape {tuple(img_on.shape)} or non-finite")
    for name, got, ref, max_tol, mean_tol in (
            ("bf16 on vs off", img_on, img_off, 5e-2, 3e-2),
            ("bf16 on vs f32 on the CPU", img_on, want, 5e-2, 3e-2),
            ("bf16 off vs f32 on the CPU", img_off, want, 5e-2, 3e-2),
            ("f32 on the card vs the CPU", img32, want, 1e-4, 1e-4)):
        err, rel = errors(got, ref)
        mrel = mean_rel(got, ref)
        log(f"{tag} {name}: max abs err {err:.3e}, rel {rel:.3e} (tol {max_tol:.0e}), mean rel "
            f"{mrel:.3e} (tol {mean_tol:.0e})")
        if rel > max_tol or mrel > mean_tol:
            raise AssertionError(f"fall-through {size}: {name} disagree")


def phase_wide_typed():
    """128^2 generate at conv_dim=96 (bf16, B=4) with `typed_c3` v4, v5 and
    v6: the typed grid is c2 = 192 wide and c3 has c4 = 384 channels, past
    what K5's kernel took before this slice (its grid tile, row types and
    staging now sized to fit). Each variant's route must be its kernel, which
    must launch once (and the other typed kernels not at all); the image is
    held against the same model with the kernels off and against f32 on the
    CPU, with the conv_dim=12 limits (max 5e-2, mean 3e-2). Then the three
    kernels alone at that shape (`wide_typed_kernels`)."""
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.ops import typed_expand as te

    typed = {"v4": "typed_c3_expand", "v5": "typed_c3_expand_v5", "v6": "typed_c3_expand_v6"}
    ins = layouts(config_for(128, conv_dim=96), 4, O, seed=5, device="cpu")
    seen, kernel = [], te.VARIANTS["v4"]
    with torch.no_grad():
        want = build_generator(config_for(128, conv_dim=96), "cpu", seed=5).generate(*ins)
        for variant, name in typed.items():
            model = build_generator(config_for(128, conv_dim=96, bf16=True, typed_c3=variant), "cuda",
                                    seed=5)
            grid = torch.zeros(4, 12, 12, 192, dtype=torch.bfloat16, device="cuda")
            route = model.layout_encoder.typed_route(grid, 32)
            launch_counts(reset=True)
            if variant == "v4":  # the path's own inputs of the typed kernel, recorded
                te.VARIANTS["v4"] = lambda *a: seen.append(a) or kernel(*a)
            try:
                img_on = model.generate(*(t.cuda() for t in ins)).float().cpu()
            finally:
                te.VARIANTS["v4"] = kernel
            ran = {n: c for n, c in launch_counts().items() if c and n in typed.values()}
            set_kernels(model, False)
            img_off = model.generate(*(t.cuda() for t in ins)).float().cpu()
            if route != variant or ran != {name: 1}:
                raise AssertionError(f"conv_dim=96 typed {variant}: route {route!r}, typed launches "
                                     f"{ran}, expected {name} once")
            if img_on.shape != (4, 128, 128, 3) or not torch.isfinite(img_on).all():
                raise AssertionError(f"conv_dim=96 typed {variant}: shape {tuple(img_on.shape)} "
                                     "or non-finite")
            for what, got, ref in (("on vs off", img_on, img_off), ("on vs f32 on the CPU", img_on, want)):
                err, rel = errors(got, ref)
                mrel = mean_rel(got, ref)
                log(f"[wide typed] conv_dim=96 128^2 B=4 bf16 typed {variant} ({name} launched once, "
                    f"route {route}): {what}: max abs err {err:.3e}, rel {rel:.3e} (tol 5e-02), mean "
                    f"rel {mrel:.3e} (tol 3e-02)")
                if rel > 5e-2 or mrel > 3e-2:
                    raise AssertionError(f"conv_dim=96 typed {variant}: {what} disagree")
            weight = model.layout_encoder.c3.weight
            del model
    wide_typed_kernels(seen[0], weight)


def wide_typed_kernels(path_args, weight):
    """K5, v5 and v6 alone at conv_dim=96's shape (c2 192, c4 384, s3 32:
    16-channel row-type groups, the general epilogue), on the inputs the
    path gave K5 (B=4) and on random ones over the whole domain at B=128,
    O=10: each within the kernel tolerance (2e-2 of max |plain|) of
    `typed_c3_expand_plain`, and v5 and v6 the same bits as v4 (each sums a
    row in K5's order)."""
    from aglayout_tpu_torch.ops import typed_expand as te

    gen = torch.Generator().manual_seed(96)
    n, c2, c4, s3 = B * O, 192, 384, 32
    i32 = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).cuda()  # noqa: E731
    rnd = (torch.randn(n, 12, 12, c2, generator=gen).cuda().to(torch.bfloat16), i32(13, (n, 14, 4)),
           i32(14, (n, 14, 4)), i32(14, (n, s3)), i32(14, (n, s3)),
           torch.randn(n, 2, c4, generator=gen).mul(0.5).cuda(), weight)
    for label, args in (("the path's", path_args), ("random", rnd)):
        if args[0].shape[-1] != c2 or args[5].shape[-1] != c4 or args[3].shape[-1] != s3:
            raise AssertionError(f"conv_dim=96: typed inputs of shape {tuple(args[0].shape)}")
        with torch.no_grad():
            plain = te.typed_c3_expand_plain(*args)
            outs = {v: te.VARIANTS[v](*args) for v in ("v4", "v5", "v6")}
        for v, got in outs.items():
            err, rel = errors(got, plain)
            same = torch.equal(got, outs["v4"])
            log(f"[wide typed] {te.VARIANTS[v].__name__} bf16 at c2 {c2}, c4 {c4}, s3 {s3} on "
                f"{label} inputs (n {args[0].shape[0]}): max abs err {err:.3e}, rel {rel:.3e} "
                f"(tol 2e-2){', bits equal to v4' if same else ''}")
            if rel > 2e-2 or not torch.isfinite(got).all() or not same:
                raise AssertionError(f"conv_dim=96 typed {v} on {label} inputs: {rel:.3e} from the "
                                     "plain version, or not v4's bits")


def phase_fallthrough_int8():
    """`int8_serving` at conv_dim=60 (64^2, B=4, f32): the wide ConvLSTM
    layer's gate conv is 600 -> 480, whose 480 output channels are not a
    multiple of 64; JAX engages its kernel there, and so must the port:
    K6 launches once a slot, and the image is held against the same model on
    the CPU, plain path, with the int8 limit of the reference phase (a
    last-bit difference upstream can move an activation across a
    quantisation step): 1e-3."""
    from aglayout_tpu_torch.bench import layouts
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_generator

    set_tf32(False)
    cfg = config_for(64, conv_dim=60, int8_serving=True)
    ins = layouts(cfg, 4, O, seed=4, device="cpu")
    with torch.no_grad():
        gpu = build_generator(cfg, "cuda", seed=4)
        cell = gpu.layout_encoder.clstm.cell_list[0]
        launch_counts(reset=True)
        got = gpu.generate(*(t.cuda() for t in ins)).cpu()
        torch.cuda.synchronize()
        n = launch_counts()["conv_small_int8"]
        want = build_generator(cfg, "cpu", seed=4).generate(*ins)
    set_tf32(True)
    err, rel = errors(got, want)
    log(f"[fall-through int8] conv_dim=60 64^2 B=4 f32, {cell.conv.in_channels} -> "
        f"{cell.conv.out_channels} gate conv: conv_small_int8 launched {n} times (expected {O}); "
        f"card vs CPU: max abs err {err:.3e}, rel {rel:.3e} (tol 1e-3)")
    if n != O or not torch.isfinite(got).all() or rel > 1e-3:
        raise AssertionError("int8_serving at conv_dim=60: K6 did not take the gate conv, or the "
                             "image disagrees with the CPU")


def phase_discriminators(smi: str):
    """The image, object and attribute discriminators at the 128^2 model's
    published widths (d_conv_dim 64, 179 classes, 106 attributes, the
    attribute D with its sixth block), seeded weights: the image D on B=32
    128^2 images, the object and attribute Ds on the 320 64^2 crops of B=32
    images of O=10 objects. They hold no kernel of the port: their convs
    are cuDNN's (`F.conv2d`), as JAX leaves them to XLA. TF32 off. First one
    call with `update_stats` on a slice (2 images, 4 crops) on the card in
    f32 and bf16 and on the CPU: u and v of every layer against the CPU's
    (1e-5), the f32 logits too (1e-4 of their max); then the whole batch
    with `update_stats` off: finite, bf16 against f32 (5e-2 of the f32
    logits' max: bf16 rounds each of 14 convs' inputs, weights and outputs
    to 8 bits, then sums a 1024-channel map), the slice's f32 rows against
    the CPU (1e-4: summation order, over 14 convs); each forward timed by
    CUDA events in both dtypes."""
    import copy
    import dataclasses

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.models import build_discriminators

    dev = torch.device("cuda")
    cfg = config_for(128)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(32, 3, 128, 128, generator=gen)
    crops = torch.randn(32 * O, 3, cfg.object_size, cfg.object_size, generator=gen)
    cpu = build_discriminators(cfg, "cpu", seed=0)
    f32 = tuple(copy.deepcopy(net).to(dev) for net in cpu)
    bf16 = build_discriminators(dataclasses.replace(cfg, bf16=True), dev, seed=0)
    outputs = lambda out: out if isinstance(out, tuple) else (out,)  # noqa: E731
    set_tf32(False)
    for name, x, nets, sl in zip(("image", "object", "attribute"), (images, crops, crops),
                                 zip(cpu, f32, bf16), (2, 4, 4)):
        ref, net32, net16 = nets
        with torch.no_grad():
            x_dev = x.to(dev)
            want = outputs(ref(x[:sl], True))
            got = outputs(net32(x_dev[:sl], True))
            net16(x_dev[:sl], True)
            rel_upd = max(errors(g.cpu(), w)[1] for g, w in zip(got, want))
            uv = max((a.cpu() - b).abs().max().item()
                     for (ka, a), (kb, b) in zip(net32.state_dict().items(), ref.state_dict().items())
                     if ka.endswith(("weight_u", "weight_v")))
            out32, out16 = outputs(net32(x_dev, False)), outputs(net16(x_dev, False))
            torch.cuda.synchronize()
            want = outputs(ref(x[:sl], False))
            rel_ref = max(errors(g[:sl].cpu(), w)[1] for g, w in zip(out32, want))
            rel_16 = max(errors(g, w)[1] for g, w in zip(out16, out32))
            finite = all(torch.isfinite(o.float()).all().item() for o in out32 + out16)
            ms = {"f32": [], "bf16": []}
            for dt in ("f32", "bf16", "bf16", "f32"):  # alternated: the card drifts
                net = net32 if dt == "f32" else net16
                ms[dt].append(cuda_ms(lambda: net(x_dev, False), iters=10))
        shapes = [tuple(o.shape) for o in out32]
        log(f"[discriminators] {name} D on {tuple(x.shape)}: outputs {shapes}, finite {finite}; "
            f"update_stats on {sl}: u, v against the CPU max abs err {uv:.3e} (tol 1e-5), logits "
            f"rel {rel_upd:.3e} (tol 1e-4); update_stats off: f32 against the CPU rel "
            f"{rel_ref:.3e} (tol 1e-4), bf16 against f32 rel {rel_16:.3e} (tol 5e-2)")
        log(f"[discriminators] {name} D forward, CUDA events, 10 calls, in turns: bf16 "
            f"{ms['bf16'][0]:.4f} {ms['bf16'][1]:.4f} ms, f32 (TF32 off) {ms['f32'][0]:.4f} "
            f"{ms['f32'][1]:.4f} ms | {smi}")
        if not finite or uv > 1e-5 or rel_upd > 1e-4 or rel_ref > 1e-4 or rel_16 > 5e-2:
            raise AssertionError(f"{name} discriminator: not finite, or off its limits")
        del x_dev, out32, out16
    set_tf32(True)


# JAX's fresh batch-norm state (aglayout_tpu/models/norms.py's initialisers)
JAX_FRESH_BN = {"running_mean": 0.0, "running_var": 1.0, "num_batches_tracked": 0,
                "weight": 1.0, "bias": 0.0}


def bn_at_jax_fresh(g) -> list:
    """For each batch norm of generator `g`: whether every one of its
    tensors holds JAX's fresh value (`JAX_FRESH_BN`), and, where not,
    whether none of its running statistics and affines does (drawn)."""
    from aglayout_tpu_torch.models.norms import MaskedBatchNorm

    out = []
    for m in g.modules():
        if isinstance(m, MaskedBatchNorm):
            sd = m.state_dict()
            out.append(("fresh" if all(bool((v == JAX_FRESH_BN[k]).all()) for k, v in sd.items())
                        else "drawn" if all(not bool((v == JAX_FRESH_BN[k]).any())
                                            for k, v in sd.items() if k != "num_batches_tracked")
                        else "mixed"))
    return out


def train_params_raw(state):
    """Each net's params, copied."""
    return {name: [p.detach().clone() for p in m.parameters()] for name, m in state.models.items()}


def phase_train(smi: str):
    from aglayout_tpu_torch.bench import TRAIN_SMALL, layouts, train_inputs
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.train.compare import compare_steps, step_draws
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    # ---- small widths, f32, TF32 off: the card against the CPU
    set_tf32(False)
    cfg = config_for(64, **TRAIN_SMALL)
    err = compare_steps(cfg, ("cpu", "cuda"), step_draws(cfg, 0))
    log(f"[train] small f32 step (TF32 off), card against CPU: metrics max rel "
        f"{err['metrics']:.3e} (tol 1e-4); params max abs err {err['params_sure']:.3e} where "
        f"Adam's first step is the same for both gradients (tol 1e-6), {err['params_any']:.3e} "
        f"anywhere (tol 2 lr = {err['params_any_tol']:.0e})")
    if (err["metrics"] > 1e-4 or err["params_sure"] > 1e-6
            or err["params_any"] > err["params_any_tol"] + 1e-6):
        raise AssertionError("train step: the card and the CPU disagree")

    # ---- the 128^2 model at its full width, B=8, bf16 and f32 (TF32 off)
    trained = None
    for bf16 in (True, False):
        label = "bf16" if bf16 else "f32 (TF32 off)"
        cfg = config_for(128, batch_size=8, max_objects=O, bf16=bf16)
        batch, matrix, pw = train_inputs(cfg, 8)
        batch = batch_to_torch(batch, "cuda")
        state = create_train_state(cfg, "cuda", seed=0)
        bns = bn_at_jax_fresh(state.models.g)
        drawn = bn_at_jax_fresh(build_generator(cfg, "cuda", seed=0))
        log(f"[train] 128^2 full width {label}: a fresh train state's {len(bns)} generator "
            f"batch norms, {bns.count('fresh')} at JAX's fresh values {JAX_FRESH_BN}; "
            f"build_generator's {len(drawn)}, {drawn.count('drawn')} drawn")
        if not bns or bns.count("fresh") != len(bns) or drawn.count("drawn") != len(bns):
            raise AssertionError(f"train state {label}: generator BN state {bns}, "
                                 f"build_generator's {drawn}")
        before = train_params_raw(state)
        step = make_train_step(cfg, state.models, matrix, pw)
        launch_counts(reset=True)
        state, _ = step(state, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks, finite = [], True
        for _ in range(5):
            ev = {"start": torch.cuda.Event(enable_timing=True)}
            ev["start"].record()

            def mark(name, ev=ev):
                ev[name] = torch.cuda.Event(enable_timing=True)
                ev[name].record()

            state, metrics = step(state, batch, mark=mark)
            marks.append(ev)
        torch.cuda.synchronize()
        finite = all(torch.isfinite(v).all().item() for k, v in metrics.items() if k != "images")
        launches = {k: v for k, v in launch_counts().items() if v}
        moved = {name: any(not torch.equal(p.detach(), q) for p, q in zip(m.parameters(), before[name]))
                 for name, m in state.models.items()}
        ms = marks[0]["start"].elapsed_time(marks[-1]["g_phase"]) / 5
        parts = {name: sum(e[prev].elapsed_time(e[name]) for e in marks) / 5
                 for name, prev in zip(("prep", "g_forward", "d_phase", "g_phase"),
                                       ("start", "prep", "g_forward", "d_phase"))}
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[train] 128^2 full width B=8 {label}: {1e3 / ms:.3f} steps/s, {8e3 / ms:.1f} img/s, "
            f"{ms:.2f} ms/step (CUDA events, 5 steps after 1 warm-up); parts "
            f"{ {k: round(v, 2) for k, v in parts.items()} } ms, D phase "
            f"{parts['d_phase'] / ms:.1%} of the step; peak memory {peak:.2f} GiB; metrics finite "
            f"{finite}; params moved {moved}; kernel launches {launches or 'none'} | {smi}")
        if not finite or not all(moved.values()) or launches:
            raise AssertionError(f"train step {label}: non-finite metrics, a net that did not "
                                 f"move, or a kernel launch ({launches})")
        if bf16:
            trained = state.models.g
        del state, step, batch, before
    set_tf32(True)

    # ---- the trained generator still serves through its kernels
    trained.eval()
    cfg = config_for(128, batch_size=B, max_objects=O, bf16=True)
    launch_counts(reset=True)
    img = trained.generate(*layouts(cfg, B, O, seed=0, device="cuda"))
    torch.cuda.synchronize()
    launches = launch_counts()
    wrong = {k: v for k, v in launches.items() if v != PATH128.get(k, 0)}
    log(f"[train] eval generate of the trained bf16 generator: launches "
        f"{ {k: v for k, v in launches.items() if v} }, finite {torch.isfinite(img.float()).all().item()}")
    if wrong or not torch.isfinite(img.float()).all():
        raise AssertionError(f"generate after training: launches {wrong}, expected {PATH128}")
    log(f"[train] phase done in {time.perf_counter() - t0:.1f} s")


class _Tee:
    """stdout that also keeps what was written (the loop's log lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def lines(self, prefix: str):
        return [line for line in "".join(self.parts).splitlines() if line.startswith(prefix)]


def phase_trainer(smi: str):
    """The trainer through its entry points, at the 128^2 model's full
    width, B=8, bf16: (a) the loop, (b) the checkpoint round trip, (c)
    preemption and resume, (d) serving from the checkpoint."""
    import contextlib
    import os
    import re
    import shutil
    import signal
    import warnings
    from pathlib import Path

    from aglayout_tpu_torch.bench import layouts, parser, run_train
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.train import __main__ as entry
    from aglayout_tpu_torch.train.compare import state_mismatches
    from aglayout_tpu_torch.train.loop import make_step, prepare_dirs, train
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        restore_state,
        save_state,
        saved_steps,
    )

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_trainer"
    shutil.rmtree(root, ignore_errors=True)
    # (c)'s entry point, started ahead: it gets ready while (a) and (b) run
    argv = ["--synthetic", "--image_size", "128", "--batch_size", "8", "--bf16", "true",
            "--log_step", "1", "--save_step", "10000", "--allow_uniform_matrix", "true",
            "--use_tensorboard", "false", "--path", str(root / "c"), "--vg_dir",
            str(root / "c"), "--niter", "100000"]
    proc = ahead_module("aglayout_tpu_torch.train", *argv)
    try:
        # ---- (a) the loop: 12 steps of the synthetic stream
        cfg = config_for(128, batch_size=8, max_objects=O, bf16=True, log_step=4, save_step=6,
                         save_num=2, tensorboard_step=12, allow_uniform_matrix=True,
                         path=str(root / "a"), vg_dir=str(root / "a"))
        tee, windows = _Tee(sys.stdout), []
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            state, metrics = train(cfg, loader=entry.synthetic_stream(cfg), niter=12,
                                   window_rates=windows)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t1
        model_dir = prepare_dirs(cfg)["models"]
        lines = tee.lines("iter [")
        finite = all(torch.isfinite(v).all().item() for k, v in metrics.items() if k != "images")
        bench = run_train(parser().parse_args(["--train_step", "8", "--iters", "5"]))
        log(f"[trainer] (a) loop: 12 steps in {loop_s:.2f} s, {len(lines)} log lines, "
            f"checkpoints at steps {saved_steps(model_dir)}, metrics finite {finite}; steps/s by "
            f"log window {[round(r, 3) for r in windows]} (the first holds the warm-up, the second "
            f"the save at step 6): {1e3 / windows[-1]:.1f} ms/step in the last, against "
            f"bench --train_step 8's {bench['ms_per_step']:.1f} ms/step eager and "
            f"{bench['graphed']['ms_per_step']:.1f} graphed (CUDA events) | {smi}")
        if len(lines) != 3 or saved_steps(model_dir) != [6, 12] or not finite or state.step != 12:
            raise AssertionError("trainer (a): log lines, checkpoints or metrics off")

        # ---- (b) checkpoint round trip, then one more step from each
        path = checkpoint_path(model_dir, 12)
        mb = os.path.getsize(path) / 1e6
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        save_state(str(root / "b"), 12, state)
        save_s = time.perf_counter() - t1
        restored = []
        for seed in (1, 2):
            t1 = time.perf_counter()
            r, start = restore_state(model_dir, create_train_state(cfg, "cuda", seed=seed), "l")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
            bad = state_mismatches(state, r)
            if start != 12 or bad:
                raise AssertionError(f"trainer (b): restored state differs: {bad[:10]}")
            restored.append(r)
        log(f"[trainer] (b) checkpoint {mb:.1f} MB: save {save_s:.2f} s, restore {restore_s:.2f} s "
            f"(into a fresh state); every param, buffer, Adam state tensor, the CUDA generator's "
            f"state and the step torch.equal")
        # ---- (d) serving from the checkpoint
        scfg = config_for(128, batch_size=B, max_objects=O, bf16=True)
        g = build_generator(scfg, "cuda", seed=5).eval()
        sd = torch.load(path, map_location="cuda", weights_only=True)["nets"]["g"]
        g.load_state_dict(sd)
        ins = layouts(scfg, B, O, seed=0, device="cuda")
        launch_counts(reset=True)
        img = g.generate(*ins)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        want = state.models.g.eval().generate(*ins)
        state.models.g.train()
        err = errors(img, want)[0]
        log(f"[trainer] (d) the checkpoint's generator in eval mode, B={B}: launches {launches}, "
            f"against the trained generator in memory max abs err {err:.3e} (bit for bit: "
            f"{torch.equal(img, want)})")
        if launches != PATH128 or not torch.equal(img, want):
            raise AssertionError(f"trainer (d): launches {launches} (expected {PATH128}) or the "
                                 "image differs")
        del g, sd, img, want

        # ---- (b) one more step from the original and from the restored state
        batch = batch_to_torch(next(entry.synthetic_stream(cfg)), "cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the uniform matrix, as in (a)
            after = [make_step(cfg, s)(s, dict(batch)) for s in (state, *restored)]
        torch.cuda.synchronize()

        def step_diff(x, y):
            (sx, mx), (sy, my) = x, y
            m = max(abs(mx[k].item() - my[k].item()) / max(abs(my[k].item()), 1e-30)
                    for k in mx if k != "images")
            p = max((a - b).abs().max().item() for name, net in sx.models.items()
                    for a, b in zip(net.parameters(), getattr(sy.models, name).parameters()))
            return m, p

        noise, got = step_diff(after[1], after[2]), step_diff(after[0], after[1])
        log(f"[trainer] (b) one more step: the original against the restored, metrics max rel "
            f"{got[0]:.3e}, params max abs {got[1]:.3e}; two restored copies against each other "
            f"(the card's own spread from one state) {noise[0]:.3e}, {noise[1]:.3e}; limit 4x the "
            f"spread + 1e-6")
        if got[0] > 4 * noise[0] + 1e-6 or got[1] > 4 * noise[1] + 1e-6:
            raise AssertionError("trainer (b): a step from the restored state is off")
        del after, restored, batch, state, metrics
        torch.cuda.empty_cache()

        # ---- (c) preemption: SIGTERM to the entry point, then `--resume l`
        go(proc)
        out = []
        try:
            deadline, seen = time.time() + 300, 0
            for line in proc.stdout:
                out.append(line)
                seen += line.startswith("iter [")
                if seen >= 3 or time.time() > deadline:
                    break
            proc.send_signal(signal.SIGTERM)
            rest, _ = proc.communicate(timeout=300)
            out.append(rest)
        finally:
            reap(proc)
        text = "".join(out)
        m = re.search(r"\[preempt\] signal 15: saved checkpoint at step (\d+), exiting", text)
        if not m or proc.returncode != 0:
            raise AssertionError(f"trainer (c): rc {proc.returncode}, no [preempt] line: {text[-2000:]}")
        k = int(m.group(1))
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            resumed, _ = entry.main(argv[:-1] + [str(k + 1), "--resume", "l"])
        lines = tee.lines("iter [")
        log(f"[trainer] (c) SIGTERM after 3 log lines: '{m.group(0)}', rc {proc.returncode}; "
            f"`--resume l --niter {k + 1}` logged {[line[:20] for line in lines]} and ended at "
            f"step {resumed.step}")
        if resumed.step != k + 1 or len(lines) != 1:
            raise AssertionError("trainer (c): the resume did not continue at the saved step")
        del resumed
    finally:
        reap(proc)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[trainer] phase done in {time.perf_counter() - t0:.1f} s")


def eval_batch(cfg, b: int, seed: int, device):
    """A seeded synthetic batch of `cfg` at batch b on `device`, and z, eps
    of one eval forward from a generator on the device."""
    from aglayout_tpu_torch.data.synthetic import batch_to_torch, synthetic_batch
    from aglayout_tpu_torch.infer.generate import forward_draws

    batch = synthetic_batch(np.random.RandomState(seed), b, cfg.max_objects, cfg.image_size,
                            cfg.num_classes, cfg.attribute_dim)
    gen = torch.Generator(device).manual_seed(seed)
    return (batch_to_torch(batch, device),
            *forward_draws(gen, b, cfg.max_objects, cfg.z_dim, device))


def seeded_inception(seed: int = 0):
    """An InceptionV3 with seeded weights whose activations neither vanish
    nor blow up through its 94 convs (`seeded_weights`; torch's default
    init shrinks each layer's variance about 6x, and pool3 of the default
    net is a constant to 1e-6, its logits the classifier's bias)."""
    from aglayout_tpu_torch.eval.inception import InceptionV3

    return seeded_weights(InceptionV3(), seed)


def seeded_weights(net, seed: int):
    """`net` with seeded weights: He-normal convs, BN statistics and
    affines drawn near the identity, linear layers of unit gain."""
    import torch.nn as nn

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
            elif isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / m.in_features ** 0.5)
    return net


def layer_flops(net, x) -> int:
    """The operations of `net` on one image of `x`: two a multiply-add of
    each conv and linear layer (pools, BN and relu left out)."""
    import torch.nn as nn

    count = [0]

    def hook(m, inputs, out):
        count[0] += 2 * m.weight[0].numel() * out[0].numel()

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    with torch.inference_mode():
        net(x[:1])
    for h in hooks:
        h.remove()
    return count[0]


# the eval forward's outputs held kernels on against off: the three images,
# the four crops tensors, mu and logvar
FORWARD_KEYS = ("img_rec", "img_rand", "img_shift", "crops_input", "crops_input_rec",
                "crops_rand", "crops_shift", "mu", "logvar")


def phase_infer(smi: str):
    """Inference, attribute editing and the evaluation report on the card,
    the 128^2 model at its full width: (a) the eval forward, kernels on and
    off, bf16 and f32; (b) small f32 eval forwards against the CPU; (c)
    `run_inference`; (d) `python -m aglayout_tpu_torch.test`; (e) the
    report with seeded InceptionV3 and LPIPS-AlexNet weights."""
    import shutil
    from pathlib import Path

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.eval.inception import load_inception, preprocess
    from aglayout_tpu_torch.eval.lpips import AlexNetFeatures, distance_fn
    from aglayout_tpu_torch.eval.report import evaluate_run
    from aglayout_tpu_torch.infer.generate import eval_forward, run_inference
    from aglayout_tpu_torch.models import build_discriminators, build_generator
    from aglayout_tpu_torch.test import synthetic_loader
    from aglayout_tpu_torch.train.loop import prepare_dirs
    from aglayout_tpu_torch.train.state import Models, create_train_state
    from aglayout_tpu_torch.utils.checkpoint import save_state
    from aglayout_tpu_torch.utils.device import no_tf32

    t0 = time.perf_counter()
    per_forward = {k: 3 * n for k, n in PATH128.items()}  # the rec, rand and shift branches

    # ---- (a) the eval forward at B=32, kernels on and off, bf16 and f32 (TF32 off)
    fb = 32
    for bf16 in (True, False):
        label = "bf16" if bf16 else "f32 (TF32 off)"
        set_tf32(bf16)
        cfg = config_for(128, batch_size=fb, max_objects=O, bf16=bf16)
        g = build_generator(cfg, "cuda", seed=0)
        batch, z, eps = eval_batch(cfg, fb, 0, "cuda")

        def fwd():
            return eval_forward(g, batch, z, batch["attribute"], batch["attribute"], eps)

        with torch.inference_mode():
            set_kernels(g, True, cfg)
            launch_counts(reset=True)
            on = fwd()
            torch.cuda.synchronize()
            launches = {k: v for k, v in launch_counts().items() if v}
            set_kernels(g, False)
            off = fwd()
            torch.cuda.synchronize()
            if {k: v for k, v in launch_counts().items() if v} != launches:
                raise AssertionError("infer (a): a kernel launched with its switch off")
            worst = {}
            for k in FORWARD_KEYS:
                if not torch.isfinite(on[k].float()).all() or on[k].shape != off[k].shape:
                    raise AssertionError(f"infer (a): {k} non-finite or misshapen")
                worst[k] = (errors(on[k], off[k])[1], mean_rel(on[k], off[k]))
            times = {}
            for key in ("on", "off", "off", "on", "on", "off"):
                set_kernels(g, key == "on", cfg)
                times.setdefault(key, []).append(cuda_ms(fwd, iters=5, warmup=2))
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        max_tol, mean_tol = (5e-2, 3e-2) if bf16 else (1e-4, None)
        bad = {k: v for k, v in worst.items()
               if v[0] > max_tol or (mean_tol is not None and v[1] > mean_tol)}
        log(f"[infer] (a) eval forward 128^2 full width B={fb} {label}: launches {launches} "
            f"(expected {per_forward}); kernels on vs off, max rel / mean rel: "
            f"{ {k: (float(f'{a:.3e}'), float(f'{b:.3e}')) for k, (a, b) in worst.items()} } "
            f"(tol {max_tol:.0e}{f', mean {mean_tol:.0e}' if mean_tol else ''}); "
            f"{ms['on']:.3f} ms/forward kernels on, {ms['off']:.3f} off (CUDA events, 5 after "
            f"2 warm-up, runs {times}) | {smi}")
        if launches != per_forward or bad:
            raise AssertionError(f"infer (a) {label}: launches {launches} or outputs {bad}")
        del g, batch, on, off
    set_tf32(True)

    # ---- (b) small f32 eval forwards on the card, kernels on, against the CPU
    set_tf32(False)
    for size, path in ((64, PATH64), (128, PATH128)):
        cfg = config_for(size, conv_dim=16, clstm_layers=2, resi_num=2, num_classes=23,
                         max_objects=4)
        batch, z, eps = eval_batch(cfg, 2, 1, "cpu")
        with torch.inference_mode():
            want = eval_forward(build_generator(cfg, "cpu", seed=1), batch, z, batch["attribute"],
                                batch["attribute"], eps)
            launch_counts(reset=True)
            dev = {k: v.cuda() for k, v in batch.items()}
            got = eval_forward(build_generator(cfg, "cuda", seed=1), dev, z.cuda(),
                               dev["attribute"], dev["attribute"], eps.cuda())
            torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        rel = max(errors(got[k].cpu(), want[k])[1] for k in want)
        log(f"[infer] (b) eval forward {size}^2 conv_dim=16 f32, card vs CPU: max rel {rel:.3e} "
            f"over the 11 outputs (tol 1e-4); launches {launches}")
        if rel > 1e-4 or launches != {k: 3 * n for k, n in path.items()}:
            raise AssertionError(f"infer (b) {size}: the card disagrees with the CPU or launches")
    set_tf32(True)

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_infer"
    shutil.rmtree(root, ignore_errors=True)
    # (d)'s entry point, started ahead: it gets ready while (c) runs
    entry = ahead_module("aglayout_tpu_torch.test", "--synthetic", "--image_size", "128",
                         "--max_batches", "2", "--path", str(root / "d"), stderr=subprocess.PIPE)
    try:
        # ---- (c) run_inference, 128^2, B=8, 3 batches, f32 (the entry's default) and bf16
        ib, nb = 8, 3
        models = {}
        for bf16 in (False, True):
            label = "bf16" if bf16 else "f32"
            cfg = config_for(128, batch_size=ib, max_objects=O, bf16=bf16)
            m = Models(build_generator(cfg, "cuda", seed=0),
                       *build_discriminators(cfg, "cuda", seed=1))
            out = root / f"infer_{label}"
            run_inference(cfg, m, synthetic_loader(cfg), str(out / "warm"), device="cuda",
                          max_batches=1)  # warm-up
            torch.cuda.synchronize()
            launch_counts(reset=True)
            t1 = time.perf_counter()
            summary = run_inference(cfg, m, synthetic_loader(cfg), str(out / "run"),
                                    device="cuda", max_batches=nb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) / nb * 1e3
            launches = {k: v for k, v in launch_counts().items() if v}
            t1 = time.perf_counter()
            run_inference(cfg, m, synthetic_loader(cfg), str(out / "bare"), device="cuda",
                          max_batches=nb, save_images=False)
            torch.cuda.synchronize()
            bare_ms = (time.perf_counter() - t1) / nb * 1e3
            batch, z, eps = eval_batch(cfg, ib, 0, "cuda")
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: eval_forward(m.g.eval(), batch, z, batch["attribute"],
                                                      batch["attribute"], eps), iters=5, warmup=2)
            pngs = sorted(p.name for p in (out / "run").iterdir())
            plain = [p for p in pngs if "modified" not in p]
            modified = len(pngs) - len(plain)
            finite = all(np.isfinite(v) for v in summary.values())
            log(f"[infer] (c) run_inference 128^2 full width B={ib} {label}, {nb} batches: "
                f"{ms:.1f} ms/batch (host clock after the card synchronises, PNGs written), "
                f"{bare_ms:.1f} without PNGs, of which two eval forwards {2 * fwd_ms:.1f} "
                f"(CUDA events, {fwd_ms:.3f} ms each); "
                f"summary {summary}; {len(plain)} PNGs + {modified} _modified; launches "
                f"{launches} | {smi}")
            if (set(summary) != SUMMARY_KEYS or not finite or len(plain) != 4 * ib * nb
                    or modified % 3 or launches != {k: 6 * nb * n for k, n in PATH128.items()}):
                raise AssertionError(f"infer (c) {label}: summary, PNGs or launches off")
            models[label] = (cfg, m)

        # ---- (d) the entry point, from a checkpoint this phase saves
        cfg = config_for(128, batch_size=ib, path=str(root / "d"))
        state = create_train_state(cfg, "cuda", seed=0)
        ckpt = save_state(prepare_dirs(cfg)["models"], 5, state)
        del state
        t1 = time.perf_counter()
        go(entry)
        text, err = entry.communicate(timeout=600)
        text = "".join(line + "\n" for line in text.splitlines()
                       if not line.startswith("[child] "))
        summary = json.loads(text[text.index("{"):]) if "{" in text else None
        log(f"[infer] (d) python -m aglayout_tpu_torch.test --synthetic --image_size 128 "
            f"--max_batches 2 (started ahead): rc {entry.returncode} in "
            f"{time.perf_counter() - t1:.1f} s after its go, from a "
            f"{os.path.getsize(ckpt) / 1e6:.1f} MB checkpoint; "
            f"'{text.splitlines()[0] if text else ''}'; summary {summary}")
        if entry.returncode != 0 or summary is None or set(summary) != SUMMARY_KEYS:
            raise AssertionError(f"infer (d): the entry point failed: {err[-2000:]}")

        # ---- (e) the report with seeded InceptionV3 and LPIPS-AlexNet weights
        torch.manual_seed(0)
        weights = {k: str(root / f"{k}.pth") for k in ("inception", "alexnet", "lpips")}
        torch.save(seeded_inception(0).state_dict(), weights["inception"])
        torch.save(AlexNetFeatures().state_dict(), weights["alexnet"])
        torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                    for i, c in enumerate((64, 192, 384, 256, 256))}, weights["lpips"])
        cfg, m = models["f32"]
        t1 = time.perf_counter()
        with fid_seconds() as fid_s:
            report = evaluate_run(cfg, m, lambda: synthetic_loader(cfg), str(root / "report"),
                                  device="cuda", max_batches=2,
                                  inception_weights=weights["inception"],
                                  alexnet_weights=weights["alexnet"],
                                  lpips_weights=weights["lpips"])
        report_s = time.perf_counter() - t1
        flat = [v for sec in report.values() for v in sec.values()
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
        names = (report["fid"]["extractor"], report["inception_score"]["classifier"],
                 report["lpips_diversity"]["backbone"])
        log(f"[infer] (e) evaluate_run 128^2 B={ib}, 2 batches, seeded InceptionV3 and "
            f"LPIPS-AlexNet: {report_s:.1f} s, of which its two FIDs {fid_s} s; "
            f"{json.dumps(report)}")
        if (not all(np.isfinite(flat)) or any("not comparable" in n for n in names)
                or names != ("inception-v3 pool3 (pytorch-fid weights)", "inception-v3 logits",
                             "lpips-v0.1-alexnet")):
            raise AssertionError(f"infer (e): non-finite report or a stand-in network: {names}")
        # InceptionV3 on the card (f32, TF32 off) against the CPU on 4 images
        imgs = np.random.RandomState(3).randint(0, 256, (4, 128, 128, 3)).astype(np.uint8)
        cpu_net = load_inception(weights["inception"], device="cpu")
        gpu_net = load_inception(weights["inception"], device="cuda")
        with torch.inference_mode(), no_tf32():
            want = cpu_net(preprocess(imgs, device="cpu"), True)
            got = gpu_net(preprocess(imgs, device="cuda"), True)
            rels = [errors(a.cpu(), b)[1] for a, b in zip(got, want)]
            x = preprocess(np.random.RandomState(4).randint(0, 256, (64, 128, 128, 3)),
                           device="cuda")
            inc_ms = cuda_ms(lambda: gpu_net(x), iters=5, warmup=2)
            dist, _ = distance_fn(weights["alexnet"], weights["lpips"], device="cuda")
            u = torch.rand(2, 64, 128, 128, 3, device="cuda") * 2 - 1
            lp_ms = cuda_ms(lambda: dist(u[0], u[1]), iters=10, warmup=2)
        flops = layer_flops(cpu_net, preprocess(imgs[:1], device="cpu"))
        rate = flops * 64e3 / inc_ms
        log(f"[infer] (e) InceptionV3 f32 (TF32 off), card vs CPU on 4 images: pool3 max rel "
            f"{rels[0]:.3e}, logits {rels[1]:.3e} (tol 1e-4); {64e3 / inc_ms:.1f} images/s at "
            f"299^2 ({inc_ms:.3f} ms a batch of 64; {flops / 1e9:.3f} GFLOP an image, two a "
            f"multiply-add: {rate / 1e12:.2f} TFLOP/s, {100 * rate / F32:.1f} % of the f32 "
            f"peak); LPIPS-AlexNet {64e3 / lp_ms:.1f} pairs/s at "
            f"128^2 ({lp_ms:.3f} ms a batch of 64 pairs) (CUDA events) | {smi}")
        if max(rels) > 1e-4:
            raise AssertionError("infer (e): InceptionV3 on the card disagrees with the CPU")
    finally:
        reap(entry)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[infer] phase done in {time.perf_counter() - t0:.1f} s")


RESULT = "[parallel-result]"  # the line a phase-15 child reports on


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(part: str, world: int) -> list:
    """Start `python3 chip_smoke.py --parallel-child part` as ranks
    0..world-1 of one process group on the card (LOCAL_RANK 0: they share
    it); each imports the port and makes its CUDA context, then waits for
    the group's port on its standard input (`_children` sends it)."""
    from pathlib import Path

    env = dict(os.environ, MASTER_ADDR="localhost", WORLD_SIZE=str(world), LOCAL_RANK="0")
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--parallel-child",
                              part], cwd=Path(__file__).resolve().parent,
                             env=dict(env, RANK=str(r)), stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _children(part: str, procs: list, timeout: float = 600):
    """Run the ranks of `part` that `_spawn` started on a free port and
    return each rank's JSON result; any rank that fails, or does not end
    in `timeout` seconds, fails the phase (every child is killed)."""
    try:
        port = str(_free_port())
        for p in procs:
            p.stdin.write(port + "\n")
            p.stdin.flush()
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        reap(*procs)
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [line for line in out.splitlines() if line.startswith(RESULT)]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"parallel {part}: rank {r} rc {p.returncode}: {out[-3000:]}")
        results.append(json.loads(lines[0][len(RESULT):]))
    return results


def parallel_child(part: str) -> int:
    """One rank of phase 15: "nccl1", (a) the sharded step in an NCCL group
    of one against the step with no group; "gloo2", (b) and (c) on two
    ranks sharing the card over gloo. Prints one `RESULT` JSON line."""
    from aglayout_tpu_torch.bench import layouts, train_inputs
    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.parallel import (
        make_sharded_generate,
        make_sharded_train_step,
        maybe_init_distributed,
    )
    from aglayout_tpu_torch.train.compare import step_errors
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    torch.cuda.init()
    port = sys.stdin.readline().strip()  # the parent's go, once the port is chosen
    if not port:
        return 1
    os.environ["MASTER_PORT"] = port
    out = {}
    group = maybe_init_distributed("cuda", backend="gloo" if part == "gloo2" else None)
    out["backend"] = torch.distributed.get_backend()
    bt = 8
    if part == "nccl1":  # (a)
        cfg = config_for(128, batch_size=bt, max_objects=O, bf16=True)
        batch, matrix, pw = train_inputs(cfg, bt)
        batch = batch_to_torch(batch, "cuda")
        runs, steps = {}, {}
        for name in ("plain", "group"):
            state = create_train_state(cfg, "cuda", seed=0)
            step = make_train_step(cfg, state.models, matrix, pw)
            steps[name] = (step if name == "plain" else make_sharded_train_step(step, group), state)
            runs[name] = steps[name][0](state, group.rows(batch))
        out["errors"] = step_errors(runs["plain"], runs["group"], cfg.learning_rate)
        out["ms"] = {}
        for name in ("plain", "group", "group", "plain"):  # alternated: the card drifts
            step, state = steps[name]
            out["ms"].setdefault(name, []).append(
                cuda_ms(lambda: step(state, batch), iters=5, warmup=1))
    else:  # (b), (c)
        set_tf32(False)
        cfg = config_for(128, batch_size=bt, max_objects=O)
        batch, matrix, pw = train_inputs(cfg, bt)
        state = create_train_state(cfg, "cuda", seed=0)
        step = make_sharded_train_step(make_train_step(cfg, state.models, matrix, pw), group)
        got = step(state, batch_to_torch(group.rows(batch), "cuda"))
        torch.cuda.synchronize()
        if group.rank == 0:
            ref_state = create_train_state(cfg, "cuda", seed=0)
            ref = make_train_step(cfg, ref_state.models, matrix, pw)(
                ref_state, batch_to_torch(batch, "cuda"))
            out["errors"] = step_errors(ref, got, cfg.learning_rate)
            del ref, ref_state
        del got, state, step
        torch.cuda.empty_cache()
        set_tf32(True)
        # (c) the sharded generate, kernels on, at the serving batch
        gcfg = config_for(128, batch_size=B, max_objects=O, bf16=True)
        model = build_generator(gcfg, "cuda", seed=0).eval()
        ins = layouts(gcfg, B, O, seed=0, device="cuda")
        generate = make_sharded_generate(model, group)
        launch_counts(reset=True)
        img = generate(*ins)
        torch.cuda.synchronize()
        out["launches"] = {k: v for k, v in launch_counts().items() if v}
        out["shape"] = list(img.shape)
        out["finite"] = bool(torch.isfinite(img.float()).all())
        out["generate_ms"] = cuda_ms(lambda: generate(*ins), iters=3, warmup=1)
        if group.rank == 0:
            with torch.no_grad():
                want = model.generate(*ins)
            out["image_rel"], out["image_mean_rel"] = errors(img, want)[1], mean_rel(img, want)
            out["one_process_ms"] = cuda_ms(lambda: model.generate(*ins), iters=3, warmup=1)
    out["rank"] = group.rank
    print(RESULT + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def phase_parallel(smi: str, nccl: list):
    """Data parallelism (`parallel/mesh.py`) and the crop classifiers on the
    card: (a)-(c) in child processes (`parallel_child`; (a)'s rank `nccl`,
    from `_spawn`), (e) the classifiers in this process; (d), the train
    entry point under torch's launcher, runs beside phase 16
    (`launcher_start`, `launcher_check`)."""
    import shutil
    from pathlib import Path

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gloo = _spawn("gloo2", 2)  # (b) and (c)'s ranks get ready while (a) runs
    try:
        # ---- (a) an NCCL group of one: the sharded step against the plain one
        (a,) = _children("nccl1", nccl)
        e, ms = a["errors"], {k: sum(v) / len(v) for k, v in a["ms"].items()}
        log(f"[parallel] (a) {a['backend']} group of 1, 128^2 full width B=8 bf16: the sharded "
            f"step against the step with no group: metrics max rel {e['metrics']:.3e} (tol "
            f"2e-2), gradients max rel L2 {e['grads']:.3e}, params {e['params_sure']:.3e} where "
            f"Adam is sure of its sign (tol 1e-6), {e['params_any']:.3e} anywhere (tol 2 lr), BN "
            f"statistics and SN vectors {e['stats']:.3e} (tol 2e-2), grids {e['grids']} levels; "
            f"{ms['group']:.2f} ms a step with the group, {ms['plain']:.2f} without (CUDA events, "
            f"5 steps after a warm-up, twice each in turns: {a['ms']}) | {smi}")
        if (a["backend"] != "nccl" or e["metrics"] > 2e-2 or e["stats"] > 2e-2
                or e["params_sure"] > 1e-6 or e["params_any"] > e["params_any_tol"] + 1e-6):
            raise AssertionError(f"parallel (a): the NCCL step of one rank differs: {e}")

        # ---- (b), (c) two ranks sharing the card over gloo
        ranks = _children("gloo2", gloo)
    finally:
        reap(*gloo)
    e = ranks[0]["errors"]
    log(f"[parallel] (b) {ranks[0]['backend']}, 2 ranks on one card, 128^2 full width, global "
        f"B=8, f32 (TF32 off): against the one-process step on the card: metrics max rel "
        f"{e['metrics']:.3e} (tol 1e-4), gradients max rel L2 {e['grads']:.3e}, params "
        f"{e['params_sure']:.3e} where Adam is sure (tol 1e-6), {e['params_any']:.3e} anywhere "
        f"(tol 2 lr), statistics and SN vectors {e['stats']:.3e} (tol 1e-5), grids "
        f"{e['grids']} levels (tol 1)")
    if (e["metrics"] > 1e-4 or e["stats"] > 1e-5 or e["params_sure"] > 1e-6 or e["grids"] > 1
            or e["params_any"] > e["params_any_tol"] + 1e-6):
        raise AssertionError(f"parallel (b): the two-rank step differs: {e}")
    r0 = ranks[0]
    log(f"[parallel] (c) make_sharded_generate 128^2 B={B} bf16 on 2 ranks: launches by rank "
        f"{[r['launches'] for r in ranks]}; gathered image {r0['shape']}, finite "
        f"{[r['finite'] for r in ranks]}; against the one-process image max rel "
        f"{r0['image_rel']:.3e} (tol 5e-2), mean rel {r0['image_mean_rel']:.3e} (tol 3e-2); "
        f"{r0['generate_ms']:.2f} ms a sharded batch, {r0['one_process_ms']:.2f} in one process "
        f"(CUDA events) | {smi}")
    if (any(r["launches"] != PATH128 or r["shape"] != [B, 128, 128, 3] or not r["finite"]
            for r in ranks) or r0["image_rel"] > 5e-2 or r0["image_mean_rel"] > 3e-2):
        raise AssertionError("parallel (c): launches, shape or image off")

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"
    shutil.rmtree(root, ignore_errors=True)
    try:
        # ---- (e) the classifiers on the seeded synthetic stream ((d): `launcher_start`)
        phase_classifiers(smi, root / "e")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[parallel] phase done in {time.perf_counter() - t0:.1f} s")


LAUNCHER_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_launcher")


def launcher_start() -> tuple:
    """Phase 15 (d), started now in a process of its own: the train entry
    point under torch's launcher, 3 steps at 128^2 (its checkpoints under
    `LAUNCHER_ROOT`). Returns (the process, its start)."""
    import shutil

    shutil.rmtree(LAUNCHER_ROOT, ignore_errors=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "aglayout_tpu_torch.train", "--synthetic", "--image_size", "128",
         "--batch_size", "8", "--bf16", "true", "--niter", "3", "--log_step", "1",
         "--save_step", "3", "--allow_uniform_matrix", "true", "--use_tensorboard", "false",
         "--path", LAUNCHER_ROOT, "--vg_dir", LAUNCHER_ROOT],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def launcher_check(started: tuple) -> None:
    """Phase 15 (d)'s checks, once `launcher_start`'s process has ended:
    rc 0, 3 log lines, its one checkpoint."""
    from pathlib import Path

    proc, t1 = started
    out, err = proc.communicate(timeout=600)
    lines = [line for line in out.splitlines() if line.startswith("iter [")]
    saved = sorted(p.name for p in Path(LAUNCHER_ROOT).rglob("step_*.pt"))
    log(f"[parallel] (d) python -m torch.distributed.run --nproc_per_node 1 -m "
        f"aglayout_tpu_torch.train --synthetic --image_size 128 --niter 3 (beside phase 16): "
        f"rc {proc.returncode} in {time.perf_counter() - t1:.1f} s, {len(lines)} log lines, "
        f"checkpoints {saved}")
    if proc.returncode != 0 or len(lines) != 3 or saved != ["step_3.pt"]:
        raise AssertionError(f"parallel (d): {out[-2000:]} {err[-2000:]}")


def phase_classifiers(smi: str, root):
    """Phase 15 (e): the crop classifier (ResNet-50 at full depth, 224^2
    crops) and the attribute classifier (128^2 full width) train on the
    card; ResNet-50's forward against the CPU; the crop classifier scores
    `gen_pickle` pickles; the ResNet-50 train step's crops/s."""
    import contextlib
    import re
    import types

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.eval import classifier, train_att_cls
    from aglayout_tpu_torch.eval.gen_pickle import dump_generation_pickles
    from aglayout_tpu_torch.eval.resnet import ResNet50
    from aglayout_tpu_torch.models import build_generator
    from aglayout_tpu_torch.test import synthetic_loader
    from aglayout_tpu_torch.train import __main__ as entry
    from aglayout_tpu_torch.train.losses import cross_entropy

    cs, cfg = 224, config_for(128, batch_size=8, max_objects=O)
    set_tf32(False)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        model = classifier.train_crop_classifier(cfg, entry.synthetic_stream(cfg), niter=3,
                                                 crop_size=cs, log_step=1, device="cuda")
        torch.cuda.synchronize()
    losses = [float(x) for x in re.findall(r"loss ([-0-9.e]+)", "".join(tee.lines("cls iter")))]
    # the train step's rate at the loader's batch: B * O crops
    net, opt, _ = classifier.make_crop_classifier(cfg.num_classes, cs, device="cuda")
    # fresh, it is drawn as flax draws JAX's: weight std sqrt(1 / fan_in), fc bias 0
    stds = [m.weight.std().item() * m.weight[0].numel() ** 0.5 for m in net.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    fc_bias = net.fc.bias.abs().max().item()
    log(f"[parallel] (e) a fresh ResNet-50 on the card: {len(stds)} conv and fc weights, std "
        f"over sqrt(1 / fan_in) {min(stds):.4f} to {max(stds):.4f} (tol 10 %), fc bias max "
        f"|.| {fc_bias}")
    if len(stds) != 54 or max(abs(r - 1) for r in stds) > 0.1 or fc_bias != 0.0:
        raise AssertionError("parallel (e): a fresh ResNet-50 is not drawn as flax draws it")
    batch = batch_to_torch(next(entry.synthetic_stream(cfg)), "cuda")
    crops = classifier.crops_of(batch["imgs"], batch["boxes"], cs)

    def step():
        loss = cross_entropy(net(crops), batch["objs"].reshape(-1), batch["valid"].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    step_ms = cuda_ms(step, iters=5, warmup=2)
    net.eval()
    flops = 3 * layer_flops(net, crops)  # forward, and the backward's two products
    rate = flops * crops.shape[0] / step_ms * 1e3
    # ResNet-50 on the card against the CPU, seeded weights (every branch counts)
    ref = seeded_weights(ResNet50(cfg.num_classes), 0).eval()
    x = torch.randn(4, 3, cs, cs, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ref(x)
        got = ref.cuda()(x.cuda())
    rel = errors(got.cpu(), want)[1]
    log(f"[parallel] (e) train_crop_classifier, ResNet-50 full depth, {crops.shape[0]} crops "
        f"of {cs}^2 a step, f32 (TF32 off), 3 steps: losses {losses}; the step "
        f"{step_ms:.2f} ms, {crops.shape[0] / step_ms * 1e3:.1f} crops/s, {flops / 1e9:.3f} GFLOP "
        f"a crop (3x the forward's convs and fc, two a multiply-add): {rate / 1e12:.2f} "
        f"TFLOP/s, {100 * rate / F32:.1f} % of the f32 peak (CUDA events); the forward on the "
        f"card against the CPU, 4 crops, seeded weights: max rel {rel:.3e} (tol 1e-4) | {smi}")
    if len(losses) != 3 or not np.all(np.isfinite(losses)) or rel > 1e-4:
        raise AssertionError("parallel (e): the crop classifier's losses or forward off")
    # test_crop_classifier on the pickles of `gen_pickle`
    g = build_generator(cfg, "cuda", seed=0)
    dump_generation_pickles(cfg, types.SimpleNamespace(g=g), synthetic_loader(cfg),
                            str(root / "pickles"), max_batches=2, device="cuda")
    acc = classifier.test_crop_classifier(model, str(root / "pickles"), crop_size=cs,
                                          device="cuda")
    log(f"[parallel] (e) test_crop_classifier on 2 gen_pickle batches (128^2, B=8): {acc}")
    if set(acc) != {"real", "rand", "shift"} or not all(0.0 <= v <= 1.0 for v in acc.values()):
        raise AssertionError(f"parallel (e): accuracies {acc}")
    # the attribute classifier at the 128^2 model's width (the sixth block, 64^2 crops)
    tee = _Tee(sys.stdout)
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        att, loss = train_att_cls.train_attribute_classifier(
            cfg, entry.synthetic_stream(cfg), niter=3, log_step=1, out_dir=str(root / "att"),
            device="cuda")
        torch.cuda.synchronize()
    saved = (root / "att" / "step_3.pt").exists()
    log(f"[parallel] (e) train_attribute_classifier 128^2 full width, B=8, 3 steps in "
        f"{time.perf_counter() - t1:.2f} s: losses {tee.lines('att_cls iter')}, "
        f"{len(att.main)} blocks, checkpoint step_3.pt saved {saved}")
    if not np.isfinite(loss) or not saved or len(att.main) != 6:
        raise AssertionError("parallel (e): the attribute classifier did not train")
    set_tf32(True)


# a quality curve's row (the JAX package's tools/quality_curve.py)
CURVE_KEYS = ("step", "fid_rand", "fid_shift", "fid_extractor", "inception_score",
              "lpips_diversity", "consistency_background_l1", "consistency_foreground_l1",
              "consistency_random_pair_l1", "attr_precision", "attr_recall", "edit_success_rate",
              "eval_wall_s")
# the JAX package's committed 64^2 evidence (artifacts/train_evidence/
# metrics.jsonl) over the 200 steps phase 16 (a) runs: the means of the
# first and last quarters of its 20 logs. The port's 3,000-step run gave
# the same ratios for the D's losses (0.84 and 0.71), and its
# reconstruction L1 rose over its first 300 steps: that falls later
JAX_FIRST_200 = {"D/loss": (10.613910102844239, 8.853595161437989),
                 "D/object_att_cls_loss": (1.294143795967102, 0.9150449395179748),
                 "G/rec_img": (0.6148820638656616, 0.5410331726074219)}
# the most the last quarter of each D loss may be of its first in phase 16 (a)
D_FALLS = {"D/loss": 0.95, "D/object_att_cls_loss": 0.8}
# those ratios in phase 16 (a) from the generator's drawn BN state, before
# a fresh train state started at JAX's (the last chip_smoke.py run on an
# NVIDIA H100 80GB HBM3 at 700 W before the change)
DRAWN_BN_D_RATIOS = {"D/loss": 0.832, "D/object_att_cls_loss": 0.717}


def phase_tools(smi: str):
    """The tools' twins (`aglayout_tpu_torch/tools/`) on the card at the
    64^2 model's full width, B=8: (a) `train_evidence`, (b) `quality_curve`'s
    core on the synthetic stream, (c) `bench_train_table` through its
    subprocess, (d) `import_reference_artifacts`, (e) `train_evidence`
    resumed (`evidence_resume`)."""
    import shutil
    from pathlib import Path

    from aglayout_tpu_torch.config import config_for
    from aglayout_tpu_torch.data.synthetic import batch_to_torch, synthetic_cooccurrence
    from aglayout_tpu_torch.data.vocab import attribute_pos_weight
    from aglayout_tpu_torch.parallel import Group, make_sharded_train_step
    from aglayout_tpu_torch.test import synthetic_loader
    from aglayout_tpu_torch.tools import (
        bench_train_table,
        import_reference_artifacts,
        quality_curve,
        train_evidence,
    )
    from aglayout_tpu_torch.train import __main__ as entry
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_tools"
    shutil.rmtree(root, ignore_errors=True)
    started = evidence_start(root)  # (e), beside (a)-(d)
    bench = {}  # (c): its subprocess runs beside (a) and (b)

    def bench_table():
        try:
            t = time.perf_counter()
            bench["table"] = bench_train_table.table("64:8", str(root / "bench.json"), 5, "cuda",
                                                     computes=("bf16",))
            bench["seconds"] = time.perf_counter() - t
        except Exception as e:
            bench["error"] = e

    bench_thread = threading.Thread(target=bench_table, daemon=True)
    bench_thread.start()
    try:
        # ---- (a) train_evidence: 200 steps, f32 with TF32 off
        out = root / "evidence"
        launch_counts(reset=True)
        t1 = time.perf_counter()
        summary = train_evidence.run(train_evidence.parser().parse_args(
            ["--steps", "200", "--corpus_batches", "32", "--log_every", "10", "--out", str(out),
             "--device", "cuda"]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = {k: v for k, v in launch_counts().items() if v}
        with open(out / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        finite = all(np.isfinite(v) for r in rows for v in r.values())
        files = sorted(p.name for p in out.iterdir())
        quarter = len(rows) // 4
        quarters = {k: (np.mean([r[k] for r in rows[:quarter]]),
                        np.mean([r[k] for r in rows[-quarter:]])) for k in JAX_FIRST_200}
        compare = ", ".join(
            f"{k} {quarters[k][0]:.4f} -> {quarters[k][1]:.4f} against "
            f"{JAX_FIRST_200[k][0]:.4f} -> {JAX_FIRST_200[k][1]:.4f}" for k in JAX_FIRST_200)
        log(f"[tools] (a) train_evidence 64^2 B=8 f32 (TF32 off), 200 steps (beside (e)'s "
            f"children and (c)'s subprocess) in {run_s:.1f} s "
            f"({summary['steps_per_sec']:.3f} steps/s, {1e3 / summary['steps_per_sec']:.1f} "
            f"ms/step with the logging and the sample grid's forward): rec L1 first window "
            f"{summary['rec_l1_first_window']:.4f}, last {summary['rec_l1_last_window']:.4f} "
            f"(reduction {summary['rec_l1_reduction']:.3f}); the first and last quarters of "
            f"the logs, the port's against the JAX package's committed run: {compare}; files "
            f"{files}; launches over the run (the steps and the sample grid's eval forward) "
            f"{launches} | {smi}")
        ratios = {k: round(float(quarters[k][1] / quarters[k][0]), 4) for k in D_FALLS}
        log(f"[tools] (a) the D losses' last quarter over their first: {ratios}; from the "
            f"drawn BN state {DRAWN_BN_D_RATIOS}")
        if files != ["loss_curves.png", "metrics.jsonl", "progress.json", "samples.png",
                     "summary.json"] \
                or len(rows) != 20 or not finite or summary["card"] != smi:
            raise AssertionError("tools (a): files, logged rows or card off")
        for k, bar in D_FALLS.items():
            if not quarters[k][1] < bar * quarters[k][0]:
                raise AssertionError(f"tools (a): {k} did not fall below {bar} of its start: "
                                     f"{quarters[k]}")
        if launches != {k: 3 * n for k, n in PATH64.items()}:
            raise AssertionError(f"tools (a): launches {launches}, expected three forwards' "
                                 f"{PATH64} (none in the steps)")

        # ---- (b) quality_curve's core: 20 steps, an evaluation point every 10
        cfg = config_for(64, batch_size=8, max_objects=O)
        state = create_train_state(cfg, "cuda", seed=cfg.seed)
        matrix = synthetic_cooccurrence(np.random.RandomState(0), cfg.num_classes,
                                        cfg.attribute_dim)
        group = Group()
        step_fn = make_sharded_train_step(
            make_train_step(cfg, state.models, matrix, attribute_pos_weight()), group)
        drawn, forwards, points = [0], [0], []
        drop = ("masks", "masks_shift") if cfg.device_masks else ()  # as the loop's

        def train_iter():
            for b in entry.synthetic_stream(cfg):
                drawn[0] += 1
                yield batch_to_torch(group.rows({k: v for k, v in b.items() if k not in drop}),
                                     "cuda")

        def on_row(row, curve):
            torch.cuda.synchronize()
            points.append((row["step"], forwards[0],
                           {k: v for k, v in launch_counts(reset=True).items() if v}))
            forwards[0] = 0

        hook = state.models.g.register_forward_hook(
            lambda m, i, o: forwards.__setitem__(0, forwards[0] + (not m.training)))
        launch_counts(reset=True)
        t1 = time.perf_counter()
        try:
            with fid_seconds() as fid_s:
                _, curve = quality_curve.run_curve(
                    cfg, state, step_fn, train_iter(), lambda: synthetic_loader(cfg), steps=20,
                    eval_every=10, eval_batches=1, work_dir=str(root / "curve"), device="cuda",
                    on_row=on_row)
        finally:
            hook.remove()
        run_s = time.perf_counter() - t1
        finite = all(np.isfinite(v) for r in curve for k, v in r.items()
                     if k != "fid_extractor" and v is not None)
        log(f"[tools] (b) quality_curve 64^2 B=8, 20 steps, evaluation points "
            f"{[r['step'] for r in curve]} in {run_s:.1f} s (eval s "
            f"{[r['eval_wall_s'] for r in curve]}, of which FIDs {fid_s} s); the train iterator "
            f"drawn {drawn[0]} times; per point (step, eval forwards, launches since the last): "
            f"{points}; fid_rand {[round(r['fid_rand'], 3) for r in curve]}, lpips_diversity "
            f"{[round(r['lpips_diversity'], 6) for r in curve]}")
        if [r["step"] for r in curve] != [0, 10, 20] or not finite \
                or any(tuple(r) != CURVE_KEYS for r in curve):
            raise AssertionError("tools (b): rows, keys or values off")
        if drawn[0] != 20:
            raise AssertionError(f"tools (b): the train iterator drawn {drawn[0]} times for 20 "
                                 "steps")
        for step_no, n, counts in points:
            if n < 1 or counts != {k: 3 * n * c for k, c in PATH64.items()}:
                raise AssertionError(f"tools (b): at step {step_no}, {n} eval forwards launched "
                                     f"{counts} (expected three a forward of {PATH64}, none in "
                                     "the steps)")
        del state, step_fn
        torch.cuda.empty_cache()

        # ---- (c) bench_train_table: one configuration through its subprocess
        t1 = time.perf_counter()
        bench_thread.join(timeout=900)
        if bench_thread.is_alive() or "error" in bench:
            raise AssertionError(f"tools (c): bench_train_table did not finish: "
                                 f"{bench.get('error')}")
        table = bench["table"]
        with open(root / "bench.json") as f:
            written = json.load(f)
        log(f"[tools] (c) bench_train_table 64:8 bf16 in a subprocess started with the phase, "
            f"beside (a) and (b): {bench['seconds']:.1f} s, {time.perf_counter() - t1:.1f} s "
            f"after (b): {table}; keys {sorted(written)}")
        if len(table) != 1 or not np.isfinite(table[0]["steps_per_sec"]) \
                or table[0]["steps_per_sec"] <= 0 or table[0]["card"] != smi \
                or written.get("steps_per_sec_64_b8_bf16") != table[0]["steps_per_sec"]:
            raise AssertionError("tools (c): the row is off")

        # ---- (d) import_reference_artifacts on files this phase writes
        ref = root / "reference"
        ref.mkdir()
        vocab = {}
        for kind, n in (("object", 179), ("attribute", 106), ("pred", 46)):
            names = [f"{kind}{i}" for i in range(n)]
            vocab[f"{kind}_idx_to_name"] = names
            vocab[f"{kind}_name_to_idx"] = {name: i for i, name in enumerate(names)}
        with open(ref / "vocab.json", "w") as f:
            json.dump(vocab, f)
        matrix = torch.randint(0, 100, (179, 106), generator=torch.Generator().manual_seed(0))
        torch.save(matrix.float(), ref / "matrix_obj_vs_att.pt")
        import_reference_artifacts.main(["--vocab", str(ref / "vocab.json"), "--matrix",
                                         str(ref / "matrix_obj_vs_att.pt"), "--out",
                                         str(root / "vg")])
        got = np.load(root / "vg" / "matrix_obj_vs_att.npy")
        with open(root / "vg" / "vocab.json") as f:
            same_vocab = json.load(f) == vocab
        log(f"[tools] (d) import_reference_artifacts: matrix {got.shape} {got.dtype} equal "
            f"{np.array_equal(got, matrix.float().numpy())}, vocab equal {same_vocab}")
        if not np.array_equal(got, matrix.float().numpy()) or got.dtype != np.float32 \
                or not same_vocab:
            raise AssertionError("tools (d): the imported files differ")

        # ---- (e) train_evidence resumed: 10 + 10 steps in two processes against 20 in one
        t1 = time.perf_counter()
        evidence_resume(started, root, smi)
        log(f"[tools] (e) done in {time.perf_counter() - t1:.1f} s")
    except BaseException:
        while bench_thread.is_alive():  # (c)'s subprocess, and each retry, ended at once
            kill_children("aglayout_tpu_torch.tools.bench_train_table")
            bench_thread.join(timeout=1)
        raise
    finally:
        reap(*started[0].values())
        bench_thread.join(timeout=900)  # (c)'s subprocess ends before its files go
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[tools] phase done in {time.perf_counter() - t0:.1f} s")


def state_digest(path) -> str:
    """SHA-256 of a saved train state: every net's `state_dict`, every
    Adam's state and the draws' generator, in a fixed order."""
    import hashlib

    payload = torch.load(path, map_location="cpu", weights_only=True)
    h = hashlib.sha256(str(payload["step"]).encode())

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        elif isinstance(x, torch.Tensor):
            h.update(x.numpy().tobytes())
        else:
            h.update(repr(x).encode())

    feed([payload["nets"], payload["opt"], payload["rng"]])
    return h.hexdigest()


# the resume check's `train_evidence` arguments by size: 64^2 with TF32 off
# (phase 16 (e)); 128^2 with TF32 on, logged every step, as the 128^2
# evidence runs (tests/test_torch_port_gpu.py)
RESUME_ARGS = {64: ("--log_every", "10"),
               128: ("--log_every", "1", "--image_size", "128", "--tf32")}


def evidence_children(root, size: int = 64) -> dict:
    """Phase 16 (e)'s three `train_evidence` child processes, started
    ahead (`ahead`): 20 steps in one ("one"), 10 + 10 through
    `--segment_steps 10` in two ("first", "second", both writing to
    "two"), each saving its state to `--state_dir`; deterministic, graphed,
    with `RESUME_ARGS[size]`."""
    body = ("from aglayout_tpu_torch.tools import train_evidence as t; "
            "t.run(t.parser().parse_args(sys.argv[1:])); "
            "print(f'[child] ran {time.time() - t1:.1f} s', flush=True)")

    def child(name, *extra):
        return ahead(body, "--steps", "20", *RESUME_ARGS[size], "--deterministic", "--out",
                     str(root / name), "--state_dir", str(root / f"{name}_state"), "--device",
                     "cuda", *extra)

    return {"one": child("one"), "first": child("two", "--segment_steps", "10"),
            "second": child("two", "--segment_steps", "10")}


def evidence_start(root, size: int = 64) -> tuple:
    """Phase 16 (e), started with the phase: `evidence_children`' unsplit
    run and first segment at once, the second segment once the first has
    exited, through a thread of this process that waits for them. Returns
    (the children, the thread, its record: each child's end and marks, and
    the error that stopped it)."""
    kids, record = evidence_children(root, size), {"walls": {}, "error": None}
    t_start = time.perf_counter()

    def wait(name):
        out, _ = kids[name].communicate(timeout=900)
        if kids[name].returncode:
            raise AssertionError(f"tools (e): {name} exited {kids[name].returncode}: "
                                 f"{out[-3000:]}")
        record["walls"][name] = (round(time.perf_counter() - t_start, 1),
                                 [line[8:] for line in out.splitlines()
                                  if line.startswith("[child] ")])

    def run():
        try:
            go(kids["one"])
            go(kids["first"])
            wait("first")
            if (root / "two" / "summary.json").exists():
                raise AssertionError("tools (e): the first segment wrote the summary")
            go(kids["second"])
            wait("second")
            wait("one")
        except Exception as e:  # raised by evidence_resume
            record["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return kids, thread, record


def evidence_resume(started: tuple, root, smi: str, size: int = 64) -> None:
    """Phase 16 (e)'s checks, once `evidence_start`'s children have ended:
    `metrics.jsonl` byte-equal (else the first logged step at which the
    runs part is raised), the step-20 states' `state_digest` equal, the
    segments (0, 20) and (0, 10), (10, 20), and each run's kernel check
    within 1e-4 with every kernel of the size's path three launches."""
    _, thread, record = started
    thread.join(timeout=900)
    if thread.is_alive():
        raise AssertionError("tools (e): the children did not end in 900 s")
    if record["error"] is not None:
        raise record["error"]
    steps_s = [[round(s["seconds"], 1) for s in json.loads(
        (root / name / "progress.json").read_text())["segments"]] for name in ("one", "two")]
    log(f"[tools] (e) each child's end (s after phase 16 started them) and its own marks "
        f"(ready: imports, CUDA and the kernel library, before its go; ran: after it): "
        f"{record['walls']}; the steps' seconds (progress.json): unsplit {steps_s[0]}, "
        f"segments {steps_s[1]}")
    metrics = [(root / name / "metrics.jsonl").read_bytes() for name in ("one", "two")]
    digests = [state_digest(root / f"{name}_state" / "step_20.pt") for name in ("one", "two")]
    summaries = [json.loads((root / name / "summary.json").read_text()) for name in ("one", "two")]
    segments = [[(s["from_step"], s["to_step"]) for s in x["segments"]] for x in summaries]
    checks = [x["kernel_check"] for x in summaries]
    lines = metrics[0].count(b"\n")
    log(f"[tools] (e) train_evidence {size}^2 B=8 f32 (TF32 {'on' if size == 128 else 'off'}) "
        f"deterministic, 20 steps in one "
        f"process against 10 + 10 in two (segments {segments}): metrics.jsonl equal "
        f"{metrics[0] == metrics[1]} ({lines} lines), step-20 state "
        f"SHA-256 {digests[0][:16]}... against {digests[1][:16]}...; the kernel check (the "
        f"samples' forward, kernels on against off, f32): max |on - off| / max |off| "
        f"{[c['max_abs_err_over_max'] for c in checks]}, launches {checks[0]['launches']} | {smi}")
    if metrics[0] != metrics[1] or digests[0] != digests[1] or segments != [[(0, 20)],
                                                                             [(0, 10), (10, 20)]]:
        rows = [m.splitlines() for m in metrics]
        parted = next((json.loads(a)["step"] for a, b in zip(*rows) if a != b), None)
        raise AssertionError(f"tools (e): the resumed run differs from the unsplit one "
                             f"(first logged step that differs: {parted}; states equal "
                             f"{digests[0] == digests[1]}; segments {segments})")
    path = PATH64 if size == 64 else PATH128
    for c in checks:
        if c["launches"] != {k: 3 * n for k, n in path.items()} \
                or not c["max_abs_err_over_max"] <= c["limit"] or c["limit"] != 1e-4:
            raise AssertionError(f"tools (e): kernel check {c}")


GRAPH_STEPS = 20  # phase 17's steps of each kind


def closure_tensors(fn) -> dict:
    """The CUDA tensors that the function `fn` holds in its closure, and
    the closures of the functions there, by a path of their names (each
    tensor once)."""
    seen, out = set(), {}

    def walk(v, path):
        if isinstance(v, torch.Tensor):
            if v.is_cuda and id(v) not in seen:
                seen.add(id(v))
                out[path] = v
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(x, f"{path}[{i}]")
        elif hasattr(v, "__code__") and hasattr(v, "__closure__"):
            if id(v) not in seen:
                seen.add(id(v))
                for name, cell in zip(v.__code__.co_freevars, v.__closure__ or ()):
                    walk(cell.cell_contents, f"{path}.{name}")

    walk(fn, "step")
    return out


def own_tensors(step, state) -> dict:
    """`closure_tensors(step)` less those of `state` (its nets'
    parameters): what the step alone owns."""
    theirs = {id(p) for _, m in state.models.items() for p in m.parameters()}
    return {k: v for k, v in closure_tensors(step).items() if id(v) not in theirs}


def unheld(ranges: dict) -> list:
    """The names of `ranges` ({name: (address, bytes)}) that no block the
    caching allocator has handed out (`active_allocated`) covers."""
    held = []
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            addr = b.get("address", addr)
            if b["state"] == "active_allocated":
                held.append((addr, addr + b["size"]))
            addr += b["size"]
    return [k for k, (p, n) in ranges.items() if not any(a <= p and p + n <= e for a, e in held)]


class PoolChurn:
    """What a caller's own allocations do to memory that a CUDA graph reads
    but did not allocate: every free block of the caching allocator's small
    pool (requests up to 1 MB) is handed out to a tensor of NaN, and
    `turn()` frees a quarter of them and allocates as many of sizes drawn
    from 512 B to 1 MB."""

    SIZES = [512 << i for i in range(12)]  # 512 B ... 1 MB

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.held = []
        # largest first; best fit takes each request from the smallest free
        # block that holds it, and reserves a new segment only when none
        # does: after the 512-B round no free block is left
        for size in reversed(self.SIZES):
            while True:
                before = torch.cuda.memory_reserved()
                self.held += [self.nan(size) for _ in range(32)]
                if torch.cuda.memory_reserved() > before:
                    break

    @staticmethod
    def nan(nbytes: int):
        return torch.full((nbytes // 4,), float("nan"), device="cuda")

    def turn(self):
        drop = set(self.rng.choice(len(self.held), len(self.held) // 4, replace=False).tolist())
        self.held = [t for i, t in enumerate(self.held) if i not in drop]
        self.held += [self.nan(int(self.rng.choice(self.SIZES))) for _ in drop]


def differing(want: dict, got: dict) -> list:
    """The metrics and grids of two steps' outputs that differ in any bit."""
    bad = [k for k in want if k != "images" and not torch.equal(want[k], got[k])]
    return bad + [k for k in want["images"] if not torch.equal(want["images"][k],
                                                              got["images"][k])]


def graph_of_a_dropped_step(args, corpus, want: list, label: str, smi: str):
    """Phase 17 (b): a graph captured from a step that nothing else
    references, replayed in a churned pool, against `want`, the eager run's
    outputs from a fresh state of the same seed on the same batches."""
    import gc
    import weakref

    from aglayout_tpu_torch.tools.train_evidence import setup
    from aglayout_tpu_torch.train.graph import GraphedTrainStep

    _, _, _, state, step = setup(args)
    own = own_tensors(step, state)
    refs = {k: weakref.ref(v) for k, v in own.items()}
    ranges = {k: (v.data_ptr(), v.untyped_storage().nbytes()) for k, v in own.items()}
    graphed = GraphedTrainStep(step, state, corpus[0])
    del step, own
    gc.collect()
    dead = [k for k, r in refs.items() if r() is None]
    loose = unheld({k: v for k, v in ranges.items() if k not in dead})
    churn = PoolChurn()
    n_churn = len(churn.held)
    diverged = []
    for i in range(len(want)):
        got = graphed(state, corpus[i % len(corpus)])[1]
        bad = differing(want[i], got)
        if bad:
            diverged.append((i + 1, bad))
        churn.turn()
    torch.cuda.synchronize()
    log(f"[graph] {label}, the step dropped: its own tensors "
        f"{ {k: ranges[k][1] for k in ranges} } (bytes) alive after gc: {not dead} {dead}, "
        f"held by the allocator: {not loose} {loose}; {len(want)} replays with the free blocks "
        f"filled with NaN ({n_churn} tensors, a quarter turned over after each replay), every "
        f"metric and grid bit-equal to the eager run at every step: {not diverged} "
        f"{diverged[:3]} | {smi}")
    if not refs or dead or loose or diverged:
        raise AssertionError(f"graph {label}: a graph of a dropped step lost its tensors "
                             f"({dead}, not held {loose}) or parted from eager ({diverged[:3]})")


def phase_graph(smi: str):
    """Phase 17: the graphed train step against the eager one, bit for bit."""
    from aglayout_tpu_torch.profile_generate import sync_sites
    from aglayout_tpu_torch.tools.train_evidence import parser, setup
    from aglayout_tpu_torch.train.compare import state_mismatches
    from aglayout_tpu_torch.train.graph import GraphedTrainStep
    from aglayout_tpu_torch.utils.device import deterministic, tf32

    t0 = time.perf_counter()
    for size in (64, 128):
        label = f"{size}^2 B=8 f32 (TF32 {'on' if size == 128 else 'off'}) deterministic"
        with deterministic(), tf32(size == 128):
            args = parser().parse_args(["--image_size", str(size), "--corpus_batches", "4",
                                        "--device", "cuda"])
            _, _, corpus, eager_state, eager = setup(args)
            _, _, _, graph_state, step = setup(args)
            t1 = time.perf_counter()
            graphed = GraphedTrainStep(step, graph_state, corpus[0])
            capture_s = time.perf_counter() - t1
            # what the warm-up moved must be back; the Adam state it made, zero
            undone = [m for m in state_mismatches(eager_state, graph_state)
                      if not m.startswith("opt.")]
            undone += [f"opt.{n}" for n, opt in graph_state.opt.items()
                       if any(v.any() for s in opt.state.values() for v in s.values())]
            runs = (("eager", eager, eager_state), ("graphed", graphed, graph_state))
            times, diverged, eager_out = {name: [] for name, _, _ in runs}, [], []
            launch_counts(reset=True)
            for i in range(GRAPH_STEPS):
                out = {}
                for name, fn, state in runs:
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                    out[name] = fn(state, corpus[i % len(corpus)])[1]
                    ev[1].record()
                    times[name].append(ev)
                eager_out.append(out["eager"])
                bad = differing(out["eager"], out["graphed"])
                if bad:
                    diverged.append((i + 1, bad))
            waits = {name: sum(sync_sites(lambda fn=fn, st=state: fn(st, corpus[0])).values())
                     for name, fn, state in runs}
            torch.cuda.synchronize()
            launches = {k: v for k, v in launch_counts().items() if v}
            rates = {name: (GRAPH_STEPS - 2) * 1e3 / sum(x.elapsed_time(y) for x, y in evs[2:])
                     for name, evs in times.items()}
            bad_state = state_mismatches(eager_state, graph_state)
        log(f"[graph] {label}: capture {capture_s:.2f} s (3 warm-up steps, undone: "
            f"{undone or 'all equal'}); {GRAPH_STEPS} steps each, every metric and grid "
            f"bit-equal at every step: {not diverged} {diverged[:3]}; after one more each, the "
            f"states {'torch.equal' if not bad_state else bad_state[:8]}; steps/s (CUDA events, "
            f"steps 3-{GRAPH_STEPS}) eager {rates['eager']:.3f}, graphed {rates['graphed']:.3f} "
            f"({rates['graphed'] / rates['eager']:.2f}x); host waits a step (sync debug mode) "
            f"eager {waits['eager']}, graphed {waits['graphed']}; kernel launches "
            f"{launches or 'none'} | {smi}")
        if undone or diverged or bad_state or launches or waits["graphed"] or waits["eager"]:
            raise AssertionError(f"graph {label}: the graphed step is not the eager step, a "
                                 f"kernel launched ({launches}) or the host waited ({waits})")
        del eager_state, graph_state, eager, graphed, step
        if size == 64:
            with deterministic(), tf32(False):
                graph_of_a_dropped_step(args, corpus, eager_out, label, smi)
        del corpus, eager_out
        torch.cuda.empty_cache()
    log(f"[graph] phase done in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import shutil

    seconds = {}

    def timed(name, fn, *args, **kw):  # each phase's seconds, for the phase_seconds line
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    t_main = time.perf_counter()
    smi = timed("device", phase_device)
    timed("build", phase_build)
    model64, _, _ = timed("generate 64", phase_generate, 64, PATH64, smi, iters=5)
    model128, launches, img128 = timed("generate 128", phase_generate, 128, PATH128, smi)
    default = (model128, img128)
    model_int8, launches_int8, _ = timed("generate 128 int8", phase_generate, 128, PATH128_INT8,
                                         smi, iters=6, label="int8", against=default,
                                         int8_serving=True)
    launches["conv_small_int8"] = launches_int8["conv_small_int8"]
    for label, cfg_kw, expect, name in VARIANTS:
        _, counts, _ = timed(f"generate 128 {label}", phase_generate, 128, expect, smi, iters=6,
                             label=label, against=default, **cfg_kw)
        if name:
            launches[name] = counts[name]
    del img128, default
    timed("bench", phase_bench)
    rows = timed("kernels", phase_kernels, model64, model128, model_int8)
    timed("reference 64", phase_reference, 64, PATH64)
    timed("reference 128", phase_reference, 128, PATH128)
    timed("reference 128 int8", phase_reference, 128, PATH128_INT8, int8=True)
    for label, cfg_kw, expect, name in VARIANTS:
        if name:  # once with v5, once with v6, once with head8 off
            timed(f"reference 128 {label}", phase_reference, 128, expect, **cfg_kw)
    timed("reference cell", phase_reference_cell)
    timed("fallthrough 64", phase_fallthrough, 64)
    timed("fallthrough 128", phase_fallthrough, 128)
    timed("fallthrough int8", phase_fallthrough_int8)
    timed("wide typed", phase_wide_typed)
    timed("discriminators", phase_discriminators, smi)
    timed("train", phase_train, smi)
    timed("trainer", phase_trainer, smi)
    nccl = _spawn("nccl1", 1)  # phase 15 (a)'s rank gets ready while phase 14 runs
    try:
        timed("infer", phase_infer, smi)
        timed("parallel", phase_parallel, smi, nccl)
    finally:
        reap(*nccl)
    launcher = launcher_start()  # phase 15 (d), beside phase 16
    try:
        timed("tools", phase_tools, smi)
        timed("parallel (d)", launcher_check, launcher)
    finally:
        reap(launcher[0])
        shutil.rmtree(LAUNCHER_ROOT, ignore_errors=True)
    timed("graph", phase_graph, smi)
    for name, row in rows.items():
        row["launches"] = launches[name]
    seconds["total"] = round(time.perf_counter() - t_main, 1)
    print(json.dumps({"phase_seconds": seconds}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(sys.argv[2]))
    sys.exit(main())
