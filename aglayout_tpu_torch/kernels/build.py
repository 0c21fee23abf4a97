"""Build the CUDA kernels of `csrc/` and load them with ctypes.

At first use, `library()` compiles every `csrc/*.cu`, one `nvcc` process
per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c

and links the objects into one shared library under `build/kernels/` at
the repo root (listed in `.gitignore`), named by a hash of the sources so
an edited source is rebuilt, and loads it with ctypes. The sources include
no PyTorch header: each exported function takes raw pointers, sizes and a
stream, launches on that stream and returns `cudaGetLastError()`, so a
build takes seconds. Nothing here runs at import time.
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
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C functions: name -> argument types (all return int, a cudaError_t)
SIGNATURES = {
    # h, w1, w2, ab1, ab2, out, B, C, R, is_bf16, stream
    "residual_trunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, a_tab, b_tab, w, bias, out, B, C, H, W, K, O, f, rows, is_bf16, stream
    "spade_few_out_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, a_tab, b_tab, w, bias, out, B, C, H, W, K, O, f, cc, is_bf16, stream
    "spade_few_out_conv8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, a_tab, b_tab, out, B, C, H, W, f, cb, is_bf16, stream
    "spade_apply8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # z2, idxR, lsel, selR, selC, ab, wk, out, n, c2, c4, s3, is_bf16, stream
    "typed_c3_expand": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
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
    nvcc, tag = _nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]  # waits for every compile
        failed = [f"{src.name} ({proc.returncode}):\n{log}"
                  for src, proc, log in zip(sources, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        if verbose:
            print("".join(logs), end="")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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
