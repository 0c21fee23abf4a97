"""One dataclass config, field for field the JAX package's `Config`.

Every field keeps the name and default of `aglayout_tpu/config.py`, so a
config written for the JAX package builds this one. The TPU knobs
(`pallas_*`, `phase_dc`, `clstm_unroll`) are gone; each Hopper kernel on
the model's path has one on/off switch instead (`use_trunk_kernel`,
`use_head_kernel`, `use_typed_kernel`, `use_apply_kernel`,
`use_head8_kernel`, `use_int8_kernel`), which takes effect only for CUDA
tensors (on the CPU the model always runs its plain
PyTorch path). `typed_c3` and `use_compact_heads` choose between kernels of
one function (the serving A/B configurations of JAX's `AGL_TYPED_C3` and
`pallas_compact_heads`). `int8_serving` is the JAX package's opt-in approximate
serving configuration, not a kernel switch: it changes what is computed.
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
    # opt-in approximate int8 serving: the wide ConvLSTM gate convs quantise
    # their input and weights to int8 (models/convlstm.py). Eval only.
    int8_serving: bool = False
    # Hopper kernels on the eval path (CUDA tensors only)
    use_trunk_kernel: bool = True  # ops/resblocks.residual_trunk
    use_head_kernel: bool = True  # ops/spade_conv.spade_few_out_conv (c4 head)
    # 128^2 only (JAX: pallas_heads' typed c3, pallas_apply8, pallas_grouped_heads)
    use_typed_kernel: bool = True  # ops/typed_expand.typed_c3_expand, or the variant below
    # which typed-c3 kernel serves: "v4" (typed_c3_expand), "v5" or "v6"
    # (ops/typed_expand.VARIANTS; JAX selects them by AGL_TYPED_C3)
    typed_c3: str = "v4"
    use_apply_kernel: bool = True  # ops/spade_conv.spade_apply8 (SPADE-4)
    use_head8_kernel: bool = True  # ops/spade_conv.spade_few_out_conv8 (c7 head)
    # with use_head8_kernel off the c7 head goes through spade_few_out_conv:
    # on compact tables, or on flat ones (JAX: pallas_compact_heads)
    use_compact_heads: bool = True
    # under int8_serving only
    use_int8_kernel: bool = True  # ops/conv8_int8.conv_small_int8 (ConvLSTM gate conv)
    # training and input pipeline, as in the JAX package: a missing
    # co-occurrence matrix is refused unless allowed (train/loop.py);
    # libjpeg's DCT-domain scaled decode on the native batch path
    # (data/dataset.py); the step rasterizes the masks from the boxes, so the
    # loop does not copy them to the device; the G forward recomputed in its
    # backward; a second G forward in the G phase, as the reference's
    allow_uniform_matrix: bool = False
    fast_decode: bool = True
    device_masks: bool = True
    remat: bool = False
    double_g_forward: bool = False

    # logging / checkpointing (train64.py:449-454)
    resume: str = "l"  # 'l' latest / 's' scratch / explicit step
    log_step: int = 10
    tensorboard_step: int = 100
    save_step: int = 500
    save_num: int = 2
    path: str = "checkpoints"

    @property
    def exp_name(self) -> str:
        # mirrors the reference exp_name hyperparameter string (train64.py:457-467)
        return (
            f"est_change_att_{self.dataset}_bs{self.batch_size}e{self.embedding_dim}"
            f"z{self.z_dim}clstm{self.clstm_layers}li{self.lambda_img_adv}"
            f"lo{self.lambda_obj_adv}lc{self.lambda_obj_cls}lz{self.lambda_z_rec}"
            f"lc{self.lambda_img_rec}lk{self.lambda_kl}"
        )

    @property
    def clstm_dims(self) -> Tuple[int, ...]:
        cd = self.conv_dim
        return {0: (), 1: (cd,), 2: (cd, cd), 3: (2 * cd, cd, cd)}[self.clstm_layers]


def config_for(image_size: int = 64, **kw) -> Config:
    """train64/train128-equivalent presets: 128 uses 64^2 object crops."""
    base = dict(image_size=image_size, object_size=32 if image_size == 64 else 64)
    base.update(kw)
    return Config(**base)
