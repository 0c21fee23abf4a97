"""What the train step's capture as one CUDA graph (`train/graph.py`) needs
and refuses, on the host:

  * the step's constants no longer cross from the host on every call, and
    give the same bits as the copies they replace: the BCE target (a fill),
    the crops' linspace step (a Python float), the ImageNet mean and std
    (made once per dtype and device);
  * Adam is capturable on the card only (torch takes no capturable Adam on
    the CPU), and a checkpoint restores exactly into either kind, whichever
    kind saved it, each keeping its counts where it keeps them;
  * `tools/first_window_rule.adam_reference`, the f32 Adam that the card's
    capturable Adam is held to (`tests/test_torch_port_gpu.py`), is
    optax's, and the plain Adam is within the rule's bound of it;
  * the graphed step raises on the CPU, on a sharded step and inside one,
    and when given draws or marks: no path runs the eager step in its
    place.

The capture itself, and the graphed step against the eager one bit for
bit, run on the card (`tests/test_torch_port_gpu.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aglayout_tpu_torch.bench import TRAIN_SMALL, train_inputs
from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.ops import bilinear
from aglayout_tpu_torch.ops.image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    imagenet_deprocess_batch,
    imagenet_preprocess,
)
from aglayout_tpu_torch.parallel import Group, make_sharded_train_step, mesh
from aglayout_tpu_torch.tools.first_window_rule import (
    ADAM_BOUND,
    adam_case,
    adam_distances,
    adam_reference,
)
from aglayout_tpu_torch.train.compare import state_mismatches, step_draws
from aglayout_tpu_torch.train.graph import GraphedTrainStep
from aglayout_tpu_torch.train.losses import bce_logits
from aglayout_tpu_torch.train.state import create_train_state
from aglayout_tpu_torch.train.step import make_train_step
from aglayout_tpu_torch.utils.checkpoint import restore_state, save_state

torch.set_num_threads(1)
CFG = config_for(64, **TRAIN_SMALL)


def _setup(seed=0):
    """A fresh CPU state, its eager step and the seeded batch."""
    batch, matrix, pos_weight = train_inputs(CFG, CFG.batch_size, seed)
    state = create_train_state(CFG, "cpu", seed=seed)
    return state, make_train_step(CFG, state.models, matrix, pos_weight), batch_to_torch(batch,
                                                                                         "cpu")


# ---- the constants: the same bits as the host-to-device copies they replace


def _bce_copied(logits, target, weight=None, pos_weight=None):
    """`bce_logits` as it was, with its target copied from the host."""
    logits = logits.float()
    target = torch.as_tensor(target, dtype=torch.float32, device=logits.device).expand_as(logits)
    soft = torch.log1p(torch.exp(-logits.abs()))
    log_sig = soft + torch.clamp(-logits, min=0.0)
    log_one_minus = soft + torch.clamp(logits, min=0.0)
    pw = 1.0 if pos_weight is None else pos_weight.float()
    loss = pw * target * log_sig + (1.0 - target) * log_one_minus
    if weight is None:
        return loss.mean()
    w = weight.float()
    w = w.view(w.shape + (1,) * (loss.ndim - w.ndim))
    return (loss * w).sum() / torch.clamp(w.sum() * (loss.numel() / w.numel()), min=1.0)


@pytest.mark.parametrize("target", [0.0, 1.0, 0.3, "tensor"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bce_target_fill_keeps_the_bits(target, weighted, dtype):
    g = torch.Generator().manual_seed(3)
    logits = (torch.randn(24, 12, generator=g) * 4).to(dtype)
    if target == "tensor":
        target = (torch.rand(24, 12, generator=g) < 0.3).float()
    weight = (torch.rand(24, generator=g) < 0.7).float() if weighted else None
    pos_weight = torch.rand(12, generator=g) * 20 + 1 if weighted else None
    got = bce_logits(logits, target, weight, pos_weight)
    assert torch.equal(got, _bce_copied(logits, target, weight, pos_weight))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unit_linspace_scalar_keeps_the_bits(dtype):
    for steps in (2, 3, 5, 7, 16, 32, 33, 64, 100, 128, 129, 256):
        copied = torch.arange(steps, dtype=dtype) * torch.tensor(1.0 / (steps - 1), dtype=dtype)
        copied[-1] = 1.0
        assert torch.equal(bilinear._unit_linspace(steps, "cpu", dtype), copied), steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_imagenet_constants_keep_the_bits(dtype):
    g = torch.Generator().manual_seed(5)
    x = torch.rand(4, 8, 8, 3, generator=g).to(dtype)
    mean, std = (torch.tensor(v, dtype=dtype) for v in (IMAGENET_MEAN, IMAGENET_STD))
    assert torch.equal(imagenet_preprocess(x), (x - mean) / std)
    y = torch.randn(4, 8, 8, 3, generator=g).to(dtype)
    mean32, std32 = (torch.tensor(v) for v in (IMAGENET_MEAN, IMAGENET_STD))
    z = y.float() * std32 + mean32
    lo, hi = z.amin(dim=(1, 2, 3), keepdim=True), z.amax(dim=(1, 2, 3), keepdim=True)
    want = (((z - lo) / (hi - lo)) * 255.0).clamp(0, 255).to(torch.uint8)
    assert torch.equal(imagenet_deprocess_batch(y), want)


def test_imagenet_constants_are_made_once():
    from aglayout_tpu_torch.ops import image

    a = image._mean_std(torch.float32, torch.device("cpu"))
    assert image._mean_std(torch.float32, torch.device("cpu")) is a
    assert image._mean_std(torch.bfloat16, torch.device("cpu"))[0].dtype == torch.bfloat16


# ---- Adam's kind, and checkpoints across the kinds


def test_adam_is_not_capturable_on_the_cpu():
    state = create_train_state(CFG, "cpu", seed=0)
    assert all(not g["capturable"] for opt in state.opt.values() for g in opt.param_groups)


def _capturable(state):
    """`state` with capturable Adams (the card's kind) holding the same
    moments and counts: a CPU stand-in, which restores but does not step."""
    for name, opt in state.opt.items():
        sd = opt.state_dict()
        for group in sd["param_groups"]:
            group["capturable"] = True
        new = torch.optim.Adam(getattr(state.models, name).parameters(), lr=CFG.learning_rate,
                               betas=(CFG.beta1, CFG.beta2), eps=1e-8, capturable=True)
        new.load_state_dict(sd)
        state.opt[name] = new
    return state


@pytest.fixture(scope="module")
def stepped():
    """A CPU state after two steps, its Adams the plain kind."""
    state, step, batch = _setup()
    for _ in range(2):
        state, _ = step(state, batch)
    return state


def test_old_checkpoint_restores_exactly_into_a_capturable_adam(stepped, tmp_path):
    """A checkpoint of the plain kind (counts on the CPU), restored into
    capturable Adams: the moments and counts equal, the counts f32 tensors
    on the parameters' device, and the Adams stay capturable."""
    save_state(str(tmp_path), stepped.step, stepped)
    restored, start = restore_state(str(tmp_path), _capturable(create_train_state(CFG, "cpu",
                                                                                  seed=1)), "l")
    assert start == 2
    for name, opt in restored.opt.items():
        assert all(g["capturable"] for g in opt.param_groups), name
        ref = stepped.opt[name]
        for p, q in zip(getattr(restored.models, name).parameters(),
                        getattr(stepped.models, name).parameters()):
            s, r = opt.state[p], ref.state[q]
            assert s["step"].dtype == torch.float32 and s["step"].device == p.device
            assert torch.equal(s["step"], r["step"]) and s["step"].item() == 2.0
            assert torch.equal(s["exp_avg"], r["exp_avg"])
            assert torch.equal(s["exp_avg_sq"], r["exp_avg_sq"])
    # the rest of the state as with a plain restore; the Adams differ in kind only
    assert [m for m in state_mismatches(stepped, restored) if not m.startswith("opt.")] == []


def test_capturable_checkpoint_restores_exactly_into_a_plain_adam(stepped, tmp_path):
    """A checkpoint of capturable Adams restored into the plain kind: the
    counts back on the CPU, the Adams not capturable, and the whole state
    equal to the one the capturable Adams held."""
    cap = _capturable(create_train_state(CFG, "cpu", seed=1))
    save_state(str(tmp_path / "a"), stepped.step, stepped)
    restore_state(str(tmp_path / "a"), cap, "l")
    save_state(str(tmp_path / "b"), cap.step, cap)
    restored, _ = restore_state(str(tmp_path / "b"), create_train_state(CFG, "cpu", seed=2), "l")
    assert state_mismatches(stepped, restored) == []
    for opt in restored.opt.values():
        assert not any(g["capturable"] for g in opt.param_groups)
        assert all(s["step"].device.type == "cpu" for s in opt.state.values())


# ---- the Adam the card's is held to


def test_adam_reference_is_optax_adam():
    """`adam_reference` against optax's Adam as the JAX package builds it
    (aglayout_tpu/train/state.py: `optax.adam(lr, b1, b2, eps=1e-8)`),
    its 100 steps of `adam_case()` (gradients over seven decades) in one
    jitted scan: every parameter within 1e-3 lr (measured 1.5e-4 lr, one
    f32 rounding of the parameters; the bias corrections' powers round
    apart in a few steps), a tenth of the bound the card's Adam is held to."""
    p0, grads = adam_case()
    tx = optax.adam(CFG.learning_rate, b1=CFG.beta1, b2=CFG.beta2, eps=1e-8)

    def body(carry, g):
        p, s = carry
        u, s = tx.update(g, s, p)
        return (optax.apply_updates(p, u), s), None

    p = jnp.asarray(p0)
    (want, _), _ = jax.jit(lambda p, gs: jax.lax.scan(body, (p, tx.init(p)), gs))(
        p, jnp.asarray(grads))
    got = adam_reference(p0, grads, CFG.learning_rate, CFG.beta1, CFG.beta2, 1e-8)
    assert got.dtype == np.float32
    assert np.abs(got - np.asarray(want)).max() <= 1e-3 * CFG.learning_rate
    assert np.abs(got - p0).max() > 10 * CFG.learning_rate  # it moved


def test_plain_adam_is_within_the_bound_of_optax():
    """torch's plain Adam (the host's kind of `train/state.adam`) after the
    same 100 steps: within the rule's 1e-2 lr of `adam_reference`
    (measured 6.0e-4 lr)."""
    d = adam_distances("cpu")
    assert set(d) == {"plain"} and d["plain"] <= ADAM_BOUND, d


# ---- the graphed step's refusals


def test_graphed_step_raises_on_the_cpu():
    state, step, batch = _setup()
    with pytest.raises(RuntimeError, match="on the card"):
        GraphedTrainStep(step, state, batch)


def test_graphed_step_raises_on_a_sharded_step():
    state, step, batch = _setup()
    with pytest.raises(RuntimeError, match="sharded"):
        GraphedTrainStep(make_sharded_train_step(step, Group()), state, batch)
    with mesh.sharded(Group()), pytest.raises(RuntimeError, match="sharded"):
        GraphedTrainStep(step, state, batch)


@pytest.mark.parametrize("what", ["draws", "mark"])
def test_graphed_step_raises_when_given_draws_or_marks(what):
    """Before it replays anything (here on an instance with no graph)."""
    state, _, batch = _setup()
    kw = {"draws": step_draws(CFG, 0)} if what == "draws" else {"mark": lambda name: None}
    with pytest.raises(ValueError, match="eager step"):
        GraphedTrainStep.__call__(object.__new__(GraphedTrainStep), state, batch, **kw)
