"""How far apart the JAX package's and the PyTorch port's f32 train path
are, and which side is nearer the exact value.

    JAX_PLATFORMS=cpu python tools/port_train_precision.py [--sizes 64 128] [--step]

For the generator's train forward at the tests' small widths
(`tests/test_torch_port_train_forward.py`: B=3, O=3, the scalar sum of
mean(out^2) over its 11 outputs) it prints, per image size, the largest
max |difference| / max |output| of the 11 outputs against JAX's, and for
the gradients, over the parameters, the worst relative L2 difference (the
tests' measure) and the worst max |difference| / max |reference|, for: the
port in f32 against the port in f64 (the same formulas, carried out exactly
enough to be the referee), JAX's jitted f32 against the port's f64, and the
port's f32 against JAX's jitted f32. The biases before a batch-statistics
BN, whose gradient is zero in exact arithmetic, are left out. With
`--step`, one train step in both packages
(`tests/torch_port_common.StepCase`, checked as the step tests check it):
the metrics' largest relative difference, the grids' largest difference in
levels, the same three gradient comparisons against the port's f64 step
(`StepCase.f64_grads`), the params' largest difference where Adam's first
step is the same for both gradients, the gradient signs that differ, the
running statistics' and u, v's largest difference, and the second step's
largest param difference. CPU only; both packages.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aglayout_tpu_torch.utils import jax_import  # noqa: E402
from tests.test_torch_port_train_forward import KEYS, _case, _port_forward, _port_grads  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    SMALL,
    StepCase,
    _params_and_moments,
    check_second_step,
    check_step_grads_params_stats,
    grad_l2,
    noise_tensors,
)


def _stats(got, want):
    noise = noise_tensors(want)
    l2 = grad_l2(got, want, noise)
    ratio = {k: ((got[k] - w).abs().max() / w.abs().max()).item()
             for k, w in want.items() if k not in noise}
    a, b = max(l2, key=l2.get), max(ratio, key=ratio.get)
    return (f"relative L2 max {l2[a]:.2e} ({a}), max-ratio max {ratio[b]:.2e} ({b}), "
            f"{len(l2)} tensors")


def _three(tag, p32, j32, p64):
    print(f"{tag} port f32 against port f64: {_stats(p32, p64)}")
    print(f"{tag} JAX jit f32 against port f64: {_stats(j32, p64)}")
    print(f"{tag} port f32 against JAX jit f32: {_stats(p32, j32)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[64, 128])
    p.add_argument("--step", action="store_true", help="also one train step in both packages")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    for size in args.sizes:
        _, _, _, (out, stats, _, grads) = _case(size)
        _, tout = _port_forward(size)
        rel = {k: ((tout[k].detach().double() - torch.from_numpy(np.array(out[k])).double()).abs().max()
                   / float(np.abs(out[k]).max())).item() for k in KEYS}
        worst = max(rel, key=rel.get)
        print(f"{size}^2 train forward outputs, port against JAX jit: max {rel[worst]:.2e} ({worst})")
        jit32 = {k: v.double() for k, v in jax_import.generator_state_dict_from_jax(
            grads, stats, size, SMALL["clstm_layers"], SMALL["resi_num"]).items()}
        p32, p64 = _port_grads(size, torch.float32), _port_grads(size, torch.float64)
        _three(f"{size}^2 forward gradients,", p32, {k: jit32[k] for k in p64}, p64)
        if args.step:
            step_report(size)
    return 0


def step_report(size: int) -> None:
    """One step and a second one in both packages, as the step tests check them."""
    from aglayout_tpu_torch.utils.jax_import import train_state_from_jax

    case = StepCase(size)
    m = {k: abs(float(v) - float(case.jmetrics[k])) / abs(float(case.jmetrics[k]))
         for k, v in case.metrics.items() if k != "images"}
    grids = max(int(np.abs(v.numpy().astype(np.int32)
                           - np.asarray(case.jmetrics["images"][k]).astype(np.int32)).max())
                for k, v in case.metrics["images"].items())
    worst = max(m, key=m.get)
    print(f"{size}^2 step: metrics max rel {m[worst]:.2e} ({worst}); grids max {grids} level(s)")
    check_step_grads_params_stats(case)
    ported = train_state_from_jax(case.js1, case.cfg, "cpu")
    p32 = {k: 2 * v[1].double() for k, v in _params_and_moments(case.state1).items()}
    j32 = {k: 2 * v[1].double() for k, v in _params_and_moments(ported).items()}
    _three(f"{size}^2 step gradients,", p32, j32, case.f64_grads())
    stats = max(((v - getattr(ported.models, name).state_dict()[key]).abs().max().item(), key)
                for name, module in case.state1.models.items()
                for key, v in module.state_dict().items()
                if key.endswith(("running_mean", "running_var", "weight_u", "weight_v")))
    check_second_step(case)
    w2, key2, checked, total = case.second_step_worst
    print(f"{size}^2 step: params max abs difference where Adam's first step is the same "
          f"{case.sure_worst:.2e}; gradient signs that differ {case.flips[0]} of {case.flips[1]}; "
          f"running stats and u, v max abs {stats[0]:.2e} ({stats[1]}); second step max param "
          f"difference where checked {w2:.2e} ({key2}), {checked} of {total} tensors checked")


if __name__ == "__main__":
    sys.exit(main())
