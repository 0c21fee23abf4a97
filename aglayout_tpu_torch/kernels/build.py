"""Build the CUDA kernels of `csrc/` and load them with ctypes.

At first use, `library()` compiles every `csrc/*.cu` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into one shared library under `build/kernels/` at the repo root (listed in
`.gitignore`), named by a hash of the sources so an edited source is
rebuilt, and loads it with ctypes. The sources include no PyTorch header:
each exported function takes raw pointers, sizes and a stream, launches
on that stream and returns `cudaGetLastError()`, so a build takes seconds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C functions: name -> argument types (all return int, a cudaError_t)
SIGNATURES = {
    # h, w1, w2, ab1, ab2, out, B, C, R, is_bf16, stream
    "residual_trunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, a_tab, b_tab, w, bias, out, B, C, H, W, K, O, f, rows, is_bf16, stream
    "spade_few_out_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into a shared library (cached by source hash)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libaglayout_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
