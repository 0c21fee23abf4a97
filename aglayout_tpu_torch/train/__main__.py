"""Training entry point of the port: the twin of the root `train.py`.

  python -m aglayout_tpu_torch.train --image_size 64    # reference train64.py
  python -m aglayout_tpu_torch.train --image_size 128   # reference train128.py
  python -m aglayout_tpu_torch.train --synthetic --device cpu --niter 2   # a host smoke run
  python -m torch.distributed.run --nproc_per_node 4 -m aglayout_tpu_torch.train ...  # 4 GPUs

One flag per `Config` field, as `train.py` has them, plus `--device`: the
run is on the CUDA card unless `--device cpu` is given, and raises where
there is no card. `--synthetic` trains on the seeded `synthetic_batch`
stream instead of the Visual Genome corpus under `--vg_dir`; `--profile DIR`
traces at most 20 steps with `torch.profiler` into DIR/trace.json. Under
`python -m torch.distributed.run` each process joins the launcher's group
(NCCL on the card, gloo with `--device cpu`) and the run is data-parallel,
`--batch_size` being the global batch; rank 0 prints and writes.
"""

import argparse
import dataclasses

from aglayout_tpu_torch.config import Config, config_for


def _bool(v: str) -> bool:
    return v.lower() == "true"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, default=64, choices=[64, 128])
    for f in dataclasses.fields(Config):
        if f.name == "image_size":
            continue
        typ = type(f.default)
        if typ is bool or f.default is None:
            p.add_argument(f"--{f.name}", type=_bool, default=f.default)
        else:
            p.add_argument(f"--{f.name}", type=typ, default=f.default)
    p.add_argument("--use_tensorboard", type=_bool, default=True)
    p.add_argument("--synthetic", action="store_true", help="train on synthetic data (smoke)")
    p.add_argument("--profile", type=str, default=None,
                   help="trace at most 20 steps with torch.profiler into this directory")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: train on the host (tests, smoke runs)")
    return p


def config_from_args(args) -> Config:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(Config)
          if f.name != "image_size"}
    # object_size follows the resolution unless it is given
    if kw["object_size"] == Config.object_size and args.image_size == 128:
        kw["object_size"] = 64
    return config_for(args.image_size, **kw)


def synthetic_stream(cfg: Config):
    """The seeded synthetic batches of `--synthetic`, as train.py draws them."""
    import numpy as np

    from aglayout_tpu_torch.data.synthetic import synthetic_batch

    rng = np.random.RandomState(cfg.seed)
    while True:
        yield synthetic_batch(rng, cfg.batch_size, cfg.max_objects, cfg.image_size,
                              cfg.num_classes, cfg.attribute_dim)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    from aglayout_tpu_torch.parallel import maybe_init_distributed
    from aglayout_tpu_torch.train.loop import train

    group = maybe_init_distributed(args.device)
    if group is None or group.rank == 0:
        print(cfg, flush=True)
    loader = synthetic_stream(cfg) if args.synthetic else None
    try:
        if args.profile:
            from aglayout_tpu_torch.utils.profiling import trace

            with trace(args.profile):
                return train(cfg, loader=loader, niter=min(cfg.niter, 20),
                             use_tensorboard=args.use_tensorboard, device=args.device)
        return train(cfg, loader=loader, use_tensorboard=args.use_tensorboard, device=args.device)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
