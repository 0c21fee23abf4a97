"""The port's `eval/fid.frechet_distance` (the trace of the square root
by symmetric eigendecompositions) against the JAX package's
(`scipy.linalg.sqrtm` of the product), on the CPU, f64:

  * 2048-d statistics from 8 and from 16 seeded rows (a quality-curve
    point's and the smoke's report's shapes), and the statistics that
    `chip_smoke.py`'s reports produced on the card (phase 14 (e), seeded
    InceptionV3 pool3 of 16 images a set; phase 16 (b)'s first point, the
    pixel stand-in of 8; real against rand), within the report's 5e-4 of
    JAX's values, and within 1e-7 of `referee_frechet_distance`, which
    takes the trace from the features' n1 x n2 cross product. JAX's 2048-d
    `sqrtm` costs 12-14 s a call, so its values were computed once by JAX's
    function and are committed in `torch_port_fid_jax.json`:

        JAX_PLATFORMS=cpu python tests/test_torch_port_fid.py --jax

    A live comparison at 256-d;
  * the reference's eps * I branch: where JAX's `sqrtm` is not finite (so
    that JAX takes it), and where both packages are made to take it;
  * two covariances of rank 7, diagonal in one random orthogonal basis,
    where the trace is sum(sqrt(l1 * l2)): the port within 1e-6 of it.

The card's features (`torch_port_fid_features.npz`, the "infer_e" and
"tools_b0" real and rand arrays of the capture) came from

    python tests/test_torch_port_fid.py --capture build/fid_capture

which runs `chip_smoke.main()` on the card with each report's
`compute_statistics` inputs kept and its FIDs taken by `sqrtm`, as before
the eigendecompositions (`sqrtm_frechet_distance`), then times both ways
on every kept pair (`fid_times.json` in that directory).

BLAS runs on two threads here: the gate's six workers share eight cores,
and a 2048-d eigendecomposition on eight threads each slows ten-fold.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_VALUES = os.path.join(HERE, "torch_port_fid_jax.json")
FEATURES = os.path.join(HERE, "torch_port_fid_features.npz")
TOL = 5e-4  # the report's (tests/test_torch_port_report.py U8_TOL)
EXACT_TOL = 1e-6
REFEREE_TOL = 1e-7
SEEDED = {"rows8": (8, 0), "rows16": (16, 1)}  # rows, seed
# a pair of integer rank-deficient covariances whose product's sqrtm is not
# finite (its Schur form couples two zero eigenvalues); its FID is 12
SQRTM_FAILS = (np.array([[4., -4, 0, 2], [-4, 4, 0, -2], [0, 0, 0, 0], [2, -2, 0, 1]]),
               np.array([[4., 0, -4, -2], [0, 0, 0, 0], [-4, 0, 4, 2], [-2, 0, 2, 1]]))


def seeded_features(rows: int, seed: int, dim: int = 2048):
    """Two seeded feature sets of `rows` rows: unit normals, and normals
    scaled by 1.1 and shifted by 0.05."""
    rng = np.random.RandomState(seed)
    a = rng.randn(rows, dim).astype(np.float32)
    return a, (1.1 * rng.randn(rows, dim) + 0.05).astype(np.float32)


def seeded_statistics(rows: int, seed: int, dim: int = 2048):
    """(mu1, sigma1, mu2, sigma2) of `seeded_features`."""
    from aglayout_tpu_torch.eval.fid import compute_statistics

    a, b = seeded_features(rows, seed, dim)
    return (*compute_statistics(a), *compute_statistics(b))


def referee_frechet_distance(features1, features2) -> float:
    """The FID of two feature sets with Tr sqrt(sigma1 sigma2) taken from the
    features, in f64: with X_i the centred rows, sigma_i = X_i^T X_i /
    (n_i - 1), so the trace is the sum of the singular values of X_1 X_2^T
    over sqrt((n_1 - 1)(n_2 - 1)), an n_1 x n_2 matrix."""
    x1, x2 = np.asarray(features1, np.float64), np.asarray(features2, np.float64)
    (n1, _), (n2, _) = x1.shape, x2.shape
    diff = x1.mean(0) - x2.mean(0)
    x1, x2 = x1 - x1.mean(0), x2 - x2.mean(0)
    tr = np.linalg.svd(x1 @ x2.T, compute_uv=False).sum() / np.sqrt((n1 - 1) * (n2 - 1))
    return float(diff @ diff + (x1 * x1).sum() / (n1 - 1) + (x2 * x2).sum() / (n2 - 1) - 2 * tr)


def closed_form_case(dim: int = 2048, rank: int = 7, seed: int = 2):
    """(mu, sigma1, mu, sigma2, the exact FID): sigma_i = Q diag(l_i) Q^T
    for one random orthogonal Q and l_i nonzero on the same `rank` entries,
    so that Tr sqrt(sigma1 sigma2) = sum(sqrt(l1 * l2))."""
    rng = np.random.RandomState(seed)
    q = np.linalg.qr(rng.randn(dim, dim))[0]
    l1, l2 = np.zeros(dim), np.zeros(dim)
    l1[:rank], l2[:rank] = rng.uniform(0.5, 4.0, rank), rng.uniform(0.5, 4.0, rank)
    s1, s2 = (q * l1) @ q.T, (q * l2) @ q.T
    mu = np.zeros(dim)
    return mu, s1, mu, s2, float(l1.sum() + l2.sum() - 2 * np.sqrt(l1 * l2).sum())


def card_features() -> dict:
    """{name: (real, rand)} features of the reports' FIDs on the card."""
    feats = np.load(FEATURES)
    return {f"{r}_rand": (feats[f"{r}_real"], feats[f"{r}_rand"]) for r in ("infer_e", "tools_b0")}


def sqrtm_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The reference's calculate_frechet_distance (:112-163) by
    `scipy.linalg.sqrtm`: `eval/fid.frechet_distance` as it was before the
    eigendecompositions, for the card's timings."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.fixture(autouse=True)
def two_blas_threads():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=2, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def jax_values():
    with open(JAX_VALUES) as f:
        return json.load(f)


def _features(name):
    return seeded_features(*SEEDED[name]) if name in SEEDED else card_features()[name]


@pytest.mark.parametrize("name", sorted(SEEDED) + ["infer_e_rand", "tools_b0_rand"])
def test_fid_2048_equals_jax(jax_values, name):
    from aglayout_tpu_torch.eval.fid import compute_statistics, frechet_distance

    a, b = _features(name)
    got = frechet_distance(*compute_statistics(a), *compute_statistics(b))
    assert _rel(got, jax_values[name]) <= TOL, (got, jax_values[name])
    referee = referee_frechet_distance(a, b)
    assert _rel(got, referee) <= REFEREE_TOL, (got, referee)


@pytest.mark.parametrize("rows", [8, 16])
def test_fid_256_equals_jax_live(rows):
    from aglayout_tpu.eval.fid import frechet_distance as jax_frechet_distance
    from aglayout_tpu_torch.eval.fid import frechet_distance

    stats = seeded_statistics(rows, 3, dim=256)
    got, want = frechet_distance(*stats), jax_frechet_distance(*stats)
    assert _rel(got, want) <= TOL, (got, want)


def test_fid_where_jax_sqrtm_is_not_finite():
    """JAX's `sqrtm` of the product is not finite, so JAX takes the eps
    branch; the port needs no offset and gives the exact 12."""
    from scipy import linalg

    from aglayout_tpu.eval.fid import frechet_distance as jax_frechet_distance
    from aglayout_tpu_torch.eval.fid import frechet_distance

    s1, s2 = SQRTM_FAILS
    mu = np.zeros(4)
    assert not np.isfinite(linalg.sqrtm(s1 @ s2)).all()
    got, want = frechet_distance(mu, s1, mu, s2), jax_frechet_distance(mu, s1, mu, s2)
    assert _rel(got, want) <= TOL and _rel(got, 12.0) <= EXACT_TOL, (got, want)


def test_fid_eps_branch_equals_jax(monkeypatch):
    """Both packages' first square root made not finite: each adds eps * I
    to both covariances, and the two values agree."""
    import scipy.linalg

    from aglayout_tpu.eval.fid import frechet_distance as jax_frechet_distance
    from aglayout_tpu_torch.eval import fid

    mu1, s1, mu2, s2 = seeded_statistics(8, 4, dim=256)
    calls = {"port": [], "jax": []}

    def first_nan(name, inner, nan):
        def wrapped(*args):
            calls[name].append(args)
            return nan(args) if len(calls[name]) == 1 else inner(*args)
        return wrapped

    monkeypatch.setattr(fid, "trace_sqrt_product", first_nan(
        "port", fid.trace_sqrt_product, lambda args: float("nan")))
    monkeypatch.setattr(scipy.linalg, "sqrtm", first_nan(
        "jax", scipy.linalg.sqrtm, lambda args: np.full_like(args[0], np.nan)))
    got, want = fid.frechet_distance(mu1, s1, mu2, s2), jax_frechet_distance(mu1, s1, mu2, s2)
    assert len(calls["port"]) == len(calls["jax"]) == 2
    eps = np.eye(256) * 1e-6
    np.testing.assert_array_equal(calls["port"][1][0], s1 + eps)
    np.testing.assert_array_equal(calls["port"][1][1], s2 + eps)
    assert _rel(got, want) <= TOL, (got, want)


def test_fid_closed_form(jax_values):
    """The port within 1e-6 of the exact value, and no further from it than
    JAX's committed value."""
    from aglayout_tpu_torch.eval.fid import frechet_distance

    *stats, exact = closed_form_case()
    got = frechet_distance(*stats)
    assert _rel(got, exact) <= EXACT_TOL, (got, exact)
    assert jax_values["closed_form_exact"] == exact
    assert abs(got - exact) <= abs(jax_values["closed_form"] - exact), (got, jax_values)


def _jax_values() -> dict:
    """JAX's `frechet_distance` on every committed 2048-d case; the file."""
    from aglayout_tpu.eval.fid import compute_statistics
    from aglayout_tpu.eval.fid import frechet_distance as jax_frechet_distance

    cases = {name: _features(name) for name in [*SEEDED, *card_features()]}
    out = {name: jax_frechet_distance(*compute_statistics(a), *compute_statistics(b))
           for name, (a, b) in cases.items()}
    *stats, out["closed_form_exact"] = closed_form_case()
    out["closed_form"] = jax_frechet_distance(*stats)
    out["command"] = "JAX_PLATFORMS=cpu python tests/test_torch_port_fid.py --jax"
    with open(JAX_VALUES, "w") as f:
        json.dump(out, f, indent=2)
    return out


def _capture(out_dir: str) -> dict:
    """`chip_smoke.main()` on the card with each `evaluate_run`'s features
    kept and its FIDs by `sqrtm_frechet_distance`; then both ways timed on
    each kept pair. Writes features.npz and fid_times.json to `out_dir`."""
    import time

    import chip_smoke
    from aglayout_tpu_torch.eval import fid

    kept = []
    stats_inner, frechet_eig = fid.compute_statistics, fid.frechet_distance

    def keep(features):
        kept.append(np.asarray(features, np.float32).copy())
        return stats_inner(features)

    fid.compute_statistics, fid.frechet_distance = keep, sqrtm_frechet_distance
    try:
        rc = chip_smoke.main()
    finally:
        fid.compute_statistics, fid.frechet_distance = stats_inner, frechet_eig
    if rc:
        raise SystemExit(rc)
    # the report takes real, rand, shift in turn: phase 14 (e) first, then 16 (b)'s points
    names = ["infer_e"] + [f"tools_b{i}" for i in range(len(kept) // 3 - 1)]
    arrays = {f"{n}_{k}": kept[3 * i + j] for i, n in enumerate(names)
              for j, k in enumerate(("real", "rand", "shift"))}
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "features.npz"), **arrays)
    times = {}
    for n in names:
        real = stats_inner(arrays[f"{n}_real"])
        for k in ("rand", "shift"):
            stats = (*real, *stats_inner(arrays[f"{n}_{k}"]))
            row = {}
            for way, fn in (("sqrtm", sqrtm_frechet_distance), ("eigh", frechet_eig)):
                t = time.perf_counter()
                row[way] = fn(*stats)
                row[f"{way}_s"] = time.perf_counter() - t
            row["rel"] = _rel(row["eigh"], row["sqrtm"])
            times[f"{n}_{k}"] = row
    with open(os.path.join(out_dir, "fid_times.json"), "w") as f:
        json.dump(times, f, indent=2)
    print(json.dumps({"fid_times": times}))
    return times


if __name__ == "__main__":
    import argparse
    import sys

    sys.path.insert(0, os.path.dirname(HERE))  # the repo: chip_smoke, the packages

    p = argparse.ArgumentParser(description="JAX's committed FID values, or the card's "
                                            "features and FID timings")
    p.add_argument("--jax", action="store_true", help="rewrite torch_port_fid_jax.json")
    p.add_argument("--capture", metavar="DIR", help="run chip_smoke.main() on the card")
    args = p.parse_args()
    if args.capture:
        _capture(args.capture)
    if args.jax:
        print(json.dumps(_jax_values(), indent=2))
