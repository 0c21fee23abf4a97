"""The first window of the training evidence across seeds, on the host at
`bench.TRAIN_SMALL` widths (B=3, O=3, 64^2), both packages:

  * the port's `tools/first_window`;
  * the JAX package's tools/train_evidence.py set-up and step, as
    `jax_first_window` runs them with the package unchanged.

artifacts/torch_train_evidence_128/seed_study/host_train_small.json holds
both over seeds 0-7 at 64^2 and 128^2, with torch at 2 threads:

    from tests.test_torch_port_seed_study import jax_first_window
    jax_first_window(train_configs(size)[1], range(8))
    first_window.main(["--image_size", size, "--batch_size", "3", "--device", "cpu"],
                      **TRAIN_SMALL without batch_size, object_size 32 or 64)

The tests run one seed of each and hold its first log (step 10) to the
committed file's within 1e-2, relatively. Only the first: from the second
log on, a run carries the host's f32 rounding amplified by the steps, and
the port's second log moves by several per cent with torch's thread count
alone, so the later logs repeat only on the same host with the same
threads.
"""

import json
import os

import numpy as np
import torch

from tests.torch_port_common import train_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDY = os.path.join(REPO, "artifacts", "torch_train_evidence_128", "seed_study",
                     "host_train_small.json")
TOL = 1e-2  # the first log's; see the module's docstring


def jax_first_window(jcfg, seeds, steps: int = 30, log_every: int = 10,
                     corpus_batches: int = 32) -> dict:
    """The first logs of the JAX package's training-evidence run at `jcfg`
    for each seed: tools/train_evidence.py's set-up (the scene corpus and
    matrix from RandomState(7), its jitted step, the state from
    `create_train_state(jcfg, Models(jcfg), PRNGKey(seed))`; the positive
    weights the vocabulary's at 106 attributes, else ones, as the port's
    tool takes them), `steps` steps: {seed: G/rec_img at every
    `log_every`-th step}."""
    import jax
    import jax.numpy as jnp

    from aglayout_tpu.data.synthetic import synthetic_cooccurrence, synthetic_scene_batch
    from aglayout_tpu.data.vocab import attribute_pos_weight
    from aglayout_tpu.train.state import Models, create_train_state
    from aglayout_tpu.train.step import make_train_step

    rng = np.random.RandomState(7)
    corpus = [{k: jnp.asarray(v) for k, v in synthetic_scene_batch(
        rng, jcfg.batch_size, jcfg.max_objects, jcfg.image_size, jcfg.num_classes,
        jcfg.attribute_dim).items()} for _ in range(corpus_batches)]
    matrix = synthetic_cooccurrence(rng, jcfg.num_classes, jcfg.attribute_dim)
    pos_weight = (attribute_pos_weight() if jcfg.attribute_dim == 106
                  else np.ones(jcfg.attribute_dim, np.float32))
    models = Models(jcfg)
    step = jax.jit(make_train_step(jcfg, models, matrix, pos_weight))
    out = {}
    for seed in seeds:
        state, logs = create_train_state(jcfg, models, jax.random.PRNGKey(seed)), []
        for i in range(steps):
            state, metrics = step(state, corpus[i % len(corpus)])
            if (i + 1) % log_every == 0:
                logs.append(float(metrics["G/rec_img"]))
        out[seed] = logs
    return out


def _study():
    with open(STUDY) as f:
        return json.load(f)


def test_first_window_across_seeds_on_the_host(tmp_path):
    """`tools/first_window` at small widths for seed 1 (not the config's 0):
    three logs, the window their mean, the JSON written, the first log the
    committed study's for seed 1 and not its seed 0's."""
    from aglayout_tpu_torch.bench import TRAIN_SMALL
    from aglayout_tpu_torch.tools import first_window

    small = {k: v for k, v in TRAIN_SMALL.items() if k != "batch_size"}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the study's
    try:
        out = first_window.main(["--seeds", "1", "--batch_size", "3", "--device", "cpu",
                                 "--out", str(tmp_path / "fw.json")], **small)
    finally:
        torch.set_num_threads(threads)
    assert json.loads((tmp_path / "fw.json").read_text()) == out
    run = out["seeds"]["1"]
    assert list(out["seeds"]) == ["1"] and len(run["rec_l1"]) == 3 and out["steps"] == 30
    assert run["first_window"] == float(np.mean(run["rec_l1"])) == out["first_window"]["mean"]
    study = _study()["port_64"]["seeds"]
    assert abs(run["rec_l1"][0] / study["1"]["rec_l1"][0] - 1) <= TOL, (run, study["1"])
    assert abs(run["rec_l1"][0] / study["0"]["rec_l1"][0] - 1) > TOL, (run, study["0"])


def test_jax_first_window_matches_the_committed_study():
    """`jax_first_window` for seed 0, ten steps: its one log the committed
    study's first for JAX's seed 0 within 1e-2."""
    logs = jax_first_window(train_configs(64)[1], [0], steps=10)
    want = _study()["jax_64"]["0"]["rec_l1"][0]
    assert len(logs[0]) == 1 and np.isfinite(logs[0][0])
    assert abs(logs[0][0] / want - 1) <= TOL, (logs, want)
