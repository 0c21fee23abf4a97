"""aglayout_tpu_torch — the generator of `aglayout_tpu`, in PyTorch for an H100.

A second package beside the JAX one, with the same layout (`config.py`,
`models/`, `ops/`, `utils/`). Plain tensor code is PyTorch; every function
that the JAX package wrote as a Pallas TPU kernel is a CUDA C++ kernel
under `csrc/`, built by `kernels/build.py` at first use. Internals are
NCHW; public inputs and outputs keep the JAX layout (boxes (B, O, 4),
images (B, H, W, 3)). This package never imports JAX.
"""

__version__ = "0.1.0"
