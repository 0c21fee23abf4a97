"""One train step on two devices from the same weights, batch and draws,
held against each other (the card's f32 step against the CPU's).

After one step Adam's first moment is (1 - beta1) g = g / 2, so each
param's gradient is read back from its optimizer, and its first step is
lr g / (|g| + eps): about +-lr, so a gradient whose sign differs between
the two runs moves the param by about 2 lr, and one whose sign agrees by
the same amount to within lr eps / |g|.

`step_errors` holds two steps' results against each other (the card
against the CPU, a sharded step against one process), `state_mismatches`
two whole train states (a checkpoint's round trip, two ranks' replicas).
"""

from __future__ import annotations

import torch

from aglayout_tpu_torch.config import Config


def step_draws(cfg: Config, seed: int) -> dict:
    """The draws of one train step (`train_step(draws=)`) on the CPU,
    seeded: z, the first G forward's eps, and the swap's draws."""
    gen = torch.Generator().manual_seed(seed)
    b, o, a = cfg.batch_size, cfg.max_objects, cfg.attribute_dim
    n = b * o
    return {"z": torch.randn(b, o, cfg.z_dim, generator=gen),
            "eps": torch.randn(n, cfg.z_dim, generator=gen),
            "swap": (torch.randint(0, a, (n,), generator=gen),
                     torch.randint(0, a, (n,), generator=gen),
                     torch.rand(n, generator=gen) < 0.5)}


def params_and_grads(state) -> dict:
    """name -> (param, gradient) of every net after one step, on the CPU."""
    return {f"{name}.{key}": (p.detach().cpu(), 2 * state.opt[name].state[p]["exp_avg"].cpu())
            for name, module in state.models.items() for key, p in module.named_parameters()}


def adam_sure(g, other, lr: float, eps: float = 1e-8, tol: float = 1e-6):
    """Where Adam's first step moves a param by the same amount to within
    `tol` for either gradient g or other: the same sign, and both |.| above
    lr eps / tol and above 1e-3 of g's tensor's max."""
    floor = max(1e-3 * g.abs().max().item(), lr * eps / tol)
    return (torch.sign(g) == torch.sign(other)) & (g.abs() > floor) & (other.abs() > floor)


def run_step(cfg: Config, device, draws: dict | None = None, seed: int = 0):
    """One train step of a fresh state (weights from `seed`) on the seeded
    synthetic batch of `bench.train_inputs`, on `device`, with `draws` (on
    the CPU) or the state's own: (state, metrics)."""
    from aglayout_tpu_torch.bench import train_inputs
    from aglayout_tpu_torch.data.synthetic import batch_to_torch
    from aglayout_tpu_torch.train.state import create_train_state
    from aglayout_tpu_torch.train.step import make_train_step

    batch, matrix, pos_weight = train_inputs(cfg, cfg.batch_size, seed)
    state = create_train_state(cfg, device, seed=seed)
    step = make_train_step(cfg, state.models, matrix, pos_weight)
    if draws is not None:
        draws = {k: tuple(t.to(device) for t in v) if k == "swap" else v.to(device)
                 for k, v in draws.items()}
    return step(state, batch_to_torch(batch, device), draws=draws)


def step_errors(ref, got, lr: float) -> dict:
    """ref, got: (state, metrics) after one step each from the same state,
    batch and draws, ref the reference: the metrics' largest relative
    difference ("metrics"), the gradients' largest relative L2 difference
    over the tensors but the rounding-noise ones ("grads"), the params' largest difference where
    `adam_sure` ("params_sure") and anywhere ("params_any"), that bound, 2
    lr ("params_any_tol"), the BN running statistics' and spectral-norm
    vectors' largest difference over their tensor's max |.|, at least 1
    ("stats"), and the grids' largest difference in levels ("grids")."""
    (s_ref, m_ref), (s_got, m_got) = ref, got
    metrics = max(abs(m_got[k].item() - m_ref[k].item()) / abs(m_ref[k].item())
                  for k in m_ref if k != "images")
    grids = max((m_got["images"][k].cpu().int() - v.cpu().int()).abs().max().item()
                for k, v in m_ref["images"].items())
    ref_pg, got_pg = params_and_grads(s_ref), params_and_grads(s_got)
    top = {}
    for key, (_, g) in ref_pg.items():
        net = key.split(".")[0]
        top[net] = max(top.get(net, 0.0), g.abs().max().item())
    sure = anywhere = grads = 0.0
    for key, (p, g) in ref_pg.items():
        q, gq = got_pg[key]
        diff = (q - p).abs()
        mask = adam_sure(g, gq, lr)
        sure = max(sure, diff[mask].max().item() if mask.any() else 0.0)
        anywhere = max(anywhere, diff.max().item())
        # a gradient below 1e-6 of its net's largest is rounding noise (a
        # bias before a batch-statistics BN, zero in exact arithmetic)
        if g.abs().max().item() >= 1e-6 * top[key.split(".")[0]]:
            grads = max(grads, ((gq - g).norm() / g.norm()).item())
    stats = 0.0
    for name, m in s_ref.models.items():
        other = getattr(s_got.models, name).state_dict()
        for key, v in m.state_dict().items():
            if key.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
                err = (other[key].cpu() - v.cpu()).abs().max().item()
                stats = max(stats, err / max(1.0, v.abs().max().item()))
    return {"metrics": metrics, "grads": grads, "params_sure": sure, "params_any": anywhere,
            "params_any_tol": 2 * lr, "stats": stats, "grids": grids}


def compare_steps(cfg: Config, devices, draws: dict) -> dict:
    """`run_step` on each of two devices, the first the reference:
    `step_errors` of the second against the first."""
    return step_errors(*(run_step(cfg, d, draws) for d in devices), cfg.learning_rate)


def state_mismatches(a, b) -> list:
    """What differs between two train states: every net's `state_dict`
    entry, every Adam state tensor (value and device) and hyperparameter,
    the draws' generator state and the step; [] when all are equal."""
    bad = []
    for name, m in a.models.items():
        sa, sb = m.state_dict(), getattr(b.models, name).state_dict()
        bad += [f"{name}.{k}" for k in sa.keys() | sb.keys()
                if k not in sa or k not in sb or not torch.equal(sa[k], sb[k])]
        oa, ob = a.opt[name].state_dict(), b.opt[name].state_dict()
        if oa["param_groups"] != ob["param_groups"] or oa["state"].keys() != ob["state"].keys():
            bad.append(f"opt.{name}")
            continue
        for i, sa_i in oa["state"].items():
            sb_i = ob["state"][i]
            bad += [f"opt.{name}.{i}.{k}" for k in sa_i
                    if sa_i[k].device != sb_i[k].device or not torch.equal(sa_i[k], sb_i[k])]
    if a.rng.device != b.rng.device or not torch.equal(a.rng.get_state(), b.rng.get_state()):
        bad.append("rng")
    if a.step != b.step:
        bad.append("step")
    return bad
