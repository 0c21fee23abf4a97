"""ctypes bindings for the native data-plane kernels (native/datapath.cpp).

The port's copy of `aglayout_tpu/data/native.py`, over the same shared
library at the repository's root, `native/libdatapath.so` (`make -C
native`; it links libjpeg). `load_lib` returns None where the library is
absent or does not load on this host (`load_error` says why), and the
loader then assembles its batches with NumPy: the two paths give the same
batches (tests/test_torch_port_data.py).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

LIB_PATH = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libdatapath.so"))


@functools.lru_cache(maxsize=None)
def _load():
    """(the library, None) or (None, why it did not load)."""
    if not os.path.exists(LIB_PATH):
        return None, f"{LIB_PATH} is absent (build it with `make -C native`)"
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:  # e.g. no libjpeg on this host
        return None, f"{LIB_PATH} does not load: {e}"
    lib.assemble_objects.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # boxes_px
        ctypes.POINTER(ctypes.c_double),  # img_w
        ctypes.POINTER(ctypes.c_double),  # img_h
        ctypes.POINTER(ctypes.c_int32),  # att_ids
        ctypes.POINTER(ctypes.c_float),  # valid
        ctypes.c_int,  # n
        ctypes.c_int,  # max_atts
        ctypes.c_int,  # att_dim
        ctypes.c_int,  # size
        ctypes.c_int,  # num_threads
        ctypes.POINTER(ctypes.c_float),  # boxes
        ctypes.POINTER(ctypes.c_float),  # boxes_s
        ctypes.POINTER(ctypes.c_float),  # masks
        ctypes.POINTER(ctypes.c_float),  # masks_s
        ctypes.POINTER(ctypes.c_float),  # attribute
    ]
    lib.assemble_objects.restype = None
    lib.normalize_images.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.normalize_images.restype = None
    lib.decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,  # n
        ctypes.c_int,  # size
        ctypes.c_int,  # num_threads
        ctypes.POINTER(ctypes.c_float),  # out (n, size, size, 3)
        ctypes.POINTER(ctypes.c_int32),  # dims (n, 2): original W, H
        ctypes.c_int,  # fast_scale (DCT-domain scaled decode)
    ]
    lib.decode_batch.restype = ctypes.c_int
    return lib, None


def load_lib():
    """The native library, or None where it is absent or does not load."""
    return _load()[0]


def load_error():
    """Why `load_lib` gives None (None when it loaded)."""
    return _load()[1]


def _ptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def assemble_objects(boxes_px, img_w, img_h, att_ids, valid, att_dim, size, num_threads=4):
    """Batch-assemble normalized boxes, masks, shifted variants, multi-hot
    attributes. All per-object rows flat: boxes_px (N, 4) float64 [x,y,w,h];
    img_w/img_h (N,); att_ids (N, max_atts) int32 -1-padded; valid (N,).
    Returns (boxes, boxes_shift, masks, masks_shift, attribute) float32.
    """
    lib = load_lib()
    n, max_atts = att_ids.shape
    boxes_px = np.ascontiguousarray(boxes_px, np.float64)
    img_w = np.ascontiguousarray(img_w, np.float64)
    img_h = np.ascontiguousarray(img_h, np.float64)
    att_ids = np.ascontiguousarray(att_ids, np.int32)
    valid = np.ascontiguousarray(valid, np.float32)
    if not (boxes_px.shape == (n, 4) and img_w.shape == img_h.shape == valid.shape == (n,)):
        raise ValueError("assemble_objects: boxes_px (N, 4), img_w, img_h and valid (N,)")
    boxes = np.zeros((n, 4), np.float32)
    boxes_s = np.zeros((n, 4), np.float32)
    masks = np.zeros((n, size, size), np.float32)
    masks_s = np.zeros((n, size, size), np.float32)
    attribute = np.zeros((n, att_dim), np.float32)
    lib.assemble_objects(
        _ptr(boxes_px, ctypes.c_double),
        _ptr(img_w, ctypes.c_double),
        _ptr(img_h, ctypes.c_double),
        _ptr(att_ids, ctypes.c_int32),
        _ptr(valid, ctypes.c_float),
        n,
        max_atts,
        att_dim,
        size,
        num_threads,
        _ptr(boxes, ctypes.c_float),
        _ptr(boxes_s, ctypes.c_float),
        _ptr(masks, ctypes.c_float),
        _ptr(masks_s, ctypes.c_float),
        _ptr(attribute, ctypes.c_float),
    )
    return boxes, boxes_s, masks, masks_s, attribute


def normalize_images(images_u8):
    """(N, H, W, 3) uint8 -> imagenet-normalized float32, native loop."""
    lib = load_lib()
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"normalize_images: (N, H, W, 3) uint8, got {images_u8.shape}")
    n = images_u8.shape[0]
    hw = int(np.prod(images_u8.shape[1:3]))
    out = np.empty(images_u8.shape, np.float32)
    lib.normalize_images(_ptr(images_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float), n, hw)
    return out


def decode_batch(paths, size: int, num_threads: int = 1, fast_scale: bool = False):
    """JPEG decode + PIL-compatible bilinear resize + imagenet normalize for
    a batch of files (native/datapath.cpp decode_batch). Returns
    (images (n, size, size, 3) f32, dims (n, 2) i32 [original W, H],
    n_failed); failed slots have dims == 0 — fall back to PIL per file.

    fast_scale=True enables libjpeg's DCT-domain scaled decode (1/2..1/8,
    the largest reduction keeping the decoded image >= size per axis),
    within about 1-2/255 of the full-resolution resample; the loader uses
    it unless `Config.fast_decode` is off.
    """
    lib = load_lib()
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.float32)
    dims = np.zeros((n, 2), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    n_failed = lib.decode_batch(
        arr, n, size, num_threads, _ptr(out, ctypes.c_float), _ptr(dims, ctypes.c_int32),
        1 if fast_scale else 0,
    )
    return out, dims, n_failed
