"""The port's evaluation drivers against the JAX package's on the same
weights and batches, on the CPU, f32, with JAX's draws passed in:

  * `eval/report.evaluate_run`, 2 batches at B=3, O=3, 64^2, with the
    offline stand-ins and with seeded real networks (InceptionV3,
    LPIPS-AlexNet): every section equal to JAX's `evaluate_run`, its names
    and counts exactly, its statistics within the stated tolerances;
  * `eval/consistency.evaluate_consistency` against JAX's, within 1e-5.

The generator's weights are redrawn (`torch_port_common.redraw_weights`)
so that its images depend on z: the diversity and consistency figures are
then not the rounding of a constant image.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aglayout_tpu_torch.data.synthetic import synthetic_batch
from tests.torch_port_common import eval_models_pair, jax_eval_draws, train_configs

torch.set_num_threads(2)
# B=3: at B=2 the random-pair baseline's permutation is the same whatever
# its RandomState draws
B, O, BATCHES = 3, 3, 2
# the statistics of images deprocessed to uint8: the two packages' f32
# images agree within 1e-5, so a few pixels round one level apart
# (measured: FID 1.5e-7, LPIPS mean 2.5e-5 and std 4.2e-5, IS 0)
U8_TOL = 5e-4
# the consistency figures read the raw f32 images (measured 2.8e-7)
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    """The models in both packages, the batches, and JAX's draws of the
    report's three passes, split as JAX's drivers split them: the pickles
    (gen_pickle.py, PRNGKey(seed)), the diversity pass (report.py,
    PRNGKey(seed + 1)) and the attributes (infer/generate.py, PRNGKey(seed))."""
    cfg, jcfg = train_configs(64, batch_size=B, max_objects=O, attribute_dim=106)
    models, jmodels, jstate = eval_models_pair(cfg, jcfg)
    rng = np.random.RandomState(0)
    batches = [synthetic_batch(rng, B, O, 64, cfg.num_classes, cfg.attribute_dim)
               for _ in range(BATCHES)]

    def draws(seed, order):
        return jax_eval_draws(jmodels, jstate, batches, cfg.z_dim, seed, order)

    passes = {"pickles": draws(0, ("z", "eps")), "diversity": draws(1, ("z", "z2", "eps", "eps2")),
              "attributes": draws(0, ("z", "eps", "z2", "eps2"))}
    return cfg, jcfg, models, jmodels, jstate, batches, passes


@pytest.fixture(scope="module")
def metric_weights(tmp_path_factory):
    from aglayout_tpu_torch.eval.lpips import AlexNetFeatures
    from chip_smoke import seeded_inception

    d = tmp_path_factory.mktemp("report_weights")
    torch.save(seeded_inception(0).state_dict(), d / "inception.pth")
    torch.manual_seed(0)
    torch.save(AlexNetFeatures().state_dict(), d / "alexnet.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                for i, c in enumerate((64, 192, 384, 256, 256))}, d / "lpips.pth")
    return {f"{k}_weights": str(d / f"{k}.pth") for k in ("inception", "alexnet", "lpips")}


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("real", [False, True], ids=["stand_ins", "real_networks"])
def test_evaluate_run_equals_jax(case, metric_weights, tmp_path, monkeypatch, real):
    from aglayout_tpu.eval import fid as jax_fid
    from aglayout_tpu.eval import report as jax_report
    from aglayout_tpu_torch.eval import fid, report

    cfg, jcfg, models, jmodels, jstate, batches, passes = case
    # a 64-d pixel projection in both: the 2048-d one's sqrtm take 13 s each
    monkeypatch.setattr(fid.PixelProjectionExtractor, "dim", 64)
    monkeypatch.setattr(jax_fid.PixelProjectionExtractor, "dim", 64)
    weights = metric_weights if real else {}
    want = jax_report.evaluate_run(jcfg, jmodels, jstate, lambda: iter(batches),
                                   str(tmp_path / "jax"), max_batches=BATCHES, **weights)
    got = report.evaluate_run(cfg, models, lambda: iter(batches), str(tmp_path / "port"),
                              device="cpu", max_batches=BATCHES, draws=passes, **weights)
    assert list(got) == list(want)
    for section, tol in (("fid", U8_TOL), ("inception_score", U8_TOL),
                         ("lpips_diversity", U8_TOL), ("consistency", F32_TOL)):
        assert got[section].keys() == want[section].keys(), section
        for k, w in want[section].items():
            if isinstance(w, float):
                assert _rel(got[section][k], w) <= tol, (section, k, got[section][k], w)
            else:  # names and counts
                assert got[section][k] == w, (section, k)
    assert got["config"] == want["config"] and got["attributes"] == want["attributes"]
    # z moves the images: the diversity is not the rounding of a constant
    assert want["lpips_diversity"]["mean"] > 1e-2
    assert all(want["consistency"][k] > 1e-2 for k in want["consistency"])


def test_evaluate_consistency_equals_jax(case):
    from aglayout_tpu.eval.consistency import evaluate_consistency as jax_evaluate_consistency
    from aglayout_tpu_torch.eval.consistency import evaluate_consistency

    cfg, jcfg, models, jmodels, jstate, batches, passes = case
    want = jax_evaluate_consistency(jcfg, jmodels, jstate, iter(batches), max_batches=BATCHES)
    # evaluate_consistency splits PRNGKey(seed) as gen_pickle does
    got = evaluate_consistency(cfg, models, iter(batches), max_batches=BATCHES, device="cpu",
                               draws=passes["pickles"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert w > 1e-2 and _rel(got[k], w) <= F32_TOL, (k, got[k], w)
