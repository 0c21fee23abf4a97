"""One rank of the two-process gloo run of `test_torch_port_parallel.py`.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_port_parallel_child.py DIR

Reads DIR/inputs.pt (the config's fields, the global batch, the
co-occurrence matrix, the positive weights, the given draws and the
layouts of a generate call), joins the group through
`parallel.maybe_init_distributed`, and writes, under DIR/rank<r>/:
`given/` and `own/`, the checkpoints (`utils/checkpoint.save_state`) of a
fresh state (its generator redrawn as `torch_port_common.drawn_train_state`
redraws it: the test's one-process step starts there) after one sharded
step with the given draws and with the state's own; `out.pt`, both steps'
metrics and the sharded generate's images.
"""

import os
import sys

import torch

from aglayout_tpu_torch.config import config_for
from aglayout_tpu_torch.data.synthetic import batch_to_torch
from aglayout_tpu_torch.models import build_generator, init_weights
from aglayout_tpu_torch.parallel import (
    make_sharded_generate,
    make_sharded_train_step,
    maybe_init_distributed,
)
from aglayout_tpu_torch.train.state import create_train_state
from aglayout_tpu_torch.train.step import make_train_step
from aglayout_tpu_torch.utils.checkpoint import save_state


def main(root: str) -> None:
    torch.set_num_threads(1)
    ins = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    group = maybe_init_distributed("cpu")
    assert group is not None and group.size == 2, group
    out_dir = os.path.join(root, f"rank{group.rank}")
    cfg = config_for(**ins["cfg"])
    metrics = {}
    for name, draws in (("given", ins["draws"]), ("own", None)):
        state = create_train_state(cfg, "cpu", seed=0)
        init_weights(state.models.g, torch.Generator().manual_seed(0))
        step = make_sharded_train_step(
            make_train_step(cfg, state.models, ins["matrix"], ins["pos_weight"]), group)
        state, metrics[name] = step(state, batch_to_torch(group.rows(ins["batch"]), "cpu"),
                                    draws=draws)
        save_state(os.path.join(out_dir, name), 1, state)
    g = build_generator(cfg, "cpu", seed=0).eval()
    images = make_sharded_generate(g, group)(*ins["layouts"])
    torch.save({"metrics": metrics, "images": images}, os.path.join(out_dir, "out.pt"))


if __name__ == "__main__":
    main(sys.argv[1])
