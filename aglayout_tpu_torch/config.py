"""One dataclass config, field for field the JAX package's `Config`.

The model and runtime fields keep the names and defaults of
`aglayout_tpu/config.py`, so a config reads the same in both packages. The
TPU knobs are gone; each Hopper kernel has one on/off switch instead, which
takes effect only for CUDA tensors (on the CPU the model always runs its
plain PyTorch path).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class Config:
    # data
    dataset: str = "vg"
    vg_dir: str = "data/vg"
    image_dir: str = ""  # defaults to <vg_dir>/images
    batch_size: int = 8
    max_objects: int = 10  # O_max: dense object slots per image (incl. mask)
    attribute_dim: int = 106
    num_classes: int = 179  # overridden from vocab at load time

    # model
    image_size: int = 64
    object_size: int = 32
    embedding_dim: int = 64
    z_dim: int = 64
    clstm_layers: int = 3
    resi_num: int = 6
    conv_dim: int = 64  # generator base width
    d_conv_dim: int = 64  # discriminator base width

    # optimization (reference train64.py:427-446 defaults)
    niter: int = 900_000
    learning_rate: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    lambda_img_adv: float = 1.0
    lambda_obj_adv: float = 1.0
    lambda_obj_cls: float = 1.0
    lambda_z_rec: float = 8.0
    lambda_img_rec: float = 1.0
    lambda_kl: float = 0.01
    lambda_att_cls: float = 2.0

    # runtime
    seed: int = 0
    data_axis: str = "data"
    num_devices: int = 0  # 0 = all visible
    bf16: bool = False  # bf16 compute (f32 params/BN accumulators)
    # Hopper kernels on the eval path (CUDA tensors only)
    use_trunk_kernel: bool = True  # ops/resblocks.residual_trunk
    use_head_kernel: bool = True  # ops/spade_conv.spade_few_out_conv (c4 head)
    # 128^2 only (JAX: pallas_heads' typed c3, pallas_apply8, pallas_grouped_heads)
    use_typed_kernel: bool = True  # ops/typed_expand.typed_c3_expand
    use_apply_kernel: bool = True  # ops/spade_conv.spade_apply8 (SPADE-4)
    use_head8_kernel: bool = True  # ops/spade_conv.spade_few_out_conv8 (c7 head)

    @property
    def clstm_dims(self) -> Tuple[int, ...]:
        cd = self.conv_dim
        return {0: (), 1: (cd,), 2: (cd, cd), 3: (2 * cd, cd, cd)}[self.clstm_layers]


def config_for(image_size: int = 64, **kw) -> Config:
    """train64/train128-equivalent presets: 128 uses 64^2 object crops."""
    base = dict(image_size=image_size, object_size=32 if image_size == 64 else 64)
    base.update(kw)
    return Config(**base)
