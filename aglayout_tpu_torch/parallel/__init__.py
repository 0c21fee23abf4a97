from aglayout_tpu_torch.parallel.mesh import (
    Group,
    active,
    make_sharded_generate,
    make_sharded_train_step,
    maybe_init_distributed,
    sharded,
)
