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
