"""Attribute vocabulary metadata and the attributes' positive-class weights.

The port's own copy of `aglayout_tpu/data/vocab.py`. `attributes_vg.json`
(a copy of the JAX package's) holds the 106 Visual Genome attribute names
-> index map and their annotation counts (the reference's
attribute_names.py / attribute_counts.py). The pos_weight formula is
train64.py:24-28: (100000 - count) / count per attribute, applied to the
attribute BCE.
"""

from __future__ import annotations

import json
import os

import numpy as np

_HERE = os.path.dirname(__file__)


def load_attribute_meta(path: str | None = None):
    with open(path or os.path.join(_HERE, "attributes_vg.json")) as f:
        return json.load(f)


def attribute_pos_weight(path: str | None = None) -> np.ndarray:
    meta = load_attribute_meta(path)
    names, counts = meta["attribute_names"], meta["attribute_counts"]
    weight = np.zeros(len(names), np.float32)
    for name, idx in names.items():
        c = counts[name]
        weight[idx] = (100000.0 - c) / c
    return weight


# the 12 color-attribute indices zeroed during test-time attribute editing
# (test64.py:175) and the default edit target (95 = black, test64.py:173)
COLOR_ATTRIBUTE_IDS = [2, 8, 0, 94, 90, 95, 96, 34, 25, 70, 58, 104]
DEFAULT_EDIT_TARGET = 95
