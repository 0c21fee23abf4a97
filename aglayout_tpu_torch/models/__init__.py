from aglayout_tpu_torch.models.discriminator import (
    AttributeDiscriminator,
    DResidualBlock,
    ImageDiscriminator,
    ObjectDiscriminator,
    OptimizedBlock,
    build_discriminators,
)
from aglayout_tpu_torch.models.generator import (
    AttributeEncoder,
    CropEncoder,
    Decoder,
    Generator,
    GlobalEncoder,
    LayoutEncoder,
    build_generator,
    init_weights,
)
from aglayout_tpu_torch.models.sn import SNConv2d, SNLinear
