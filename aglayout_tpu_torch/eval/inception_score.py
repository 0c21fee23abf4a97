"""Inception Score with splits: the twin of `aglayout_tpu/eval/inception_score.py`
(host numpy, as JAX's; the Inception network runs on the device).

Capability parity with the reference's evaluation/compute_inception_score.py
(get_inception_score :111-148): IS = exp(E_x KL(p(y|x) || p(y))) computed
over `splits` equal chunks (default 3, reference :35), reported mean/std.

The classifier producing p(y|x) is pluggable (the reference uses the TF1
Inception graph, unavailable offline). The offline stand-in is
`RandomFeatureClassifier` — a FIXED seeded random-feature softmax head over
32^2 pixels, model-independent by construction (it never touches trained
parameters, so offline IS tracking cannot be circular). Documented
deviation; not comparable to published Inception-Score numbers. The
published-comparable path (`--weights` -> the port's InceptionV3 logits) is
`inception_score_from_dir`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def inception_score_from_probs(probs: np.ndarray, splits: int = 3):
    """probs: (N, num_classes) softmax outputs."""
    scores = []
    n = probs.shape[0]
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(np.maximum(part, 1e-12)) - np.log(np.maximum(py, 1e-12)))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


class RandomFeatureClassifier:
    """Fixed seeded random-feature softmax classifier over 32x32 pixels.

    Offline-safe p(y|x) stand-in for IS: two frozen random projections
    (3072 -> 512 -> num_classes with a tanh nonlinearity), seeded, never
    trained — so offline IS computed with it is independent of the model
    under evaluation (unlike a generator-coupled discriminator head, which
    would self-grade). Same role as eval/fid.py's PixelProjectionExtractor.
    Not comparable to published Inception-Score numbers.
    """

    name = "random-feature-512->C softmax (not comparable to Inception IS)"

    def __init__(self, num_classes: int = 179, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.w1 = rng.randn(32 * 32 * 3, 512).astype(np.float32) / 32.0
        self.w2 = rng.randn(512, num_classes).astype(np.float32) / np.sqrt(512.0)
        self.num_classes = num_classes

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        """images_u8: (N, H, W, 3) uint8/float pixels -> (N, C) probs."""
        from PIL import Image

        probs = np.zeros((len(images_u8), self.num_classes), np.float32)
        for i in range(len(images_u8)):
            img = Image.fromarray(images_u8[i].astype(np.uint8)).resize(
                (32, 32), Image.BILINEAR
            )
            x = np.asarray(img, np.float32).reshape(-1) / 255.0
            h = np.tanh(x @ self.w1)
            logits = h @ self.w2
            e = np.exp(logits - logits.max())
            probs[i] = e / e.sum()
        return probs


def inception_score_offline(image_dir: str, splits: int = 3, seed: int = 0,
                            num_classes: int = 179, image_size: int = 64):
    """Offline IS over a directory of images with the fixed
    RandomFeatureClassifier (model-independent stand-in)."""
    from aglayout_tpu_torch.eval.fid import load_images

    imgs = load_images(image_dir, image_size)
    probs = RandomFeatureClassifier(num_classes=num_classes, seed=seed)(imgs)
    return inception_score_from_probs(probs, splits)


def inception_score_from_dir(
    image_dir: str, weights: str, image_size: int = 299, splits: int = 3, *, device
):
    """Published-comparable IS: softmax of the InceptionV3 logits
    (eval/inception.py, on `device`) over a directory of images; needs a
    torch .pth weights file (reference protocol:
    compute_inception_score.py:111-148).

    Images are loaded at 299^2 directly: `preprocess` performs the single
    protocol (bilinear-to-299) resize, so any other `image_size` would add
    a second resample the pytorch-fid/IS protocol does not have."""
    from aglayout_tpu_torch.eval.fid import load_images
    from aglayout_tpu_torch.eval.inception import InceptionExtractor

    if image_size != 299:
        raise ValueError(
            f"image_size={image_size}: the IS protocol resizes to 299 exactly "
            "once; loading at another size would double-resample"
        )
    ext = InceptionExtractor(weights, device=device)
    imgs = load_images(image_dir, image_size)
    logits = ext.logits(imgs)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    return inception_score_from_probs(probs, splits)


def main(argv=None):
    from aglayout_tpu_torch.utils.device import require

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "source",
        help=".npy of (N, C) class probabilities, OR an image directory "
        "(published-comparable with --weights, offline random-feature "
        "stand-in without)",
    )
    p.add_argument("--splits", type=int, default=3)
    p.add_argument("--weights", default=None, help="InceptionV3 torch .pth -> published-comparable IS over an image dir")
    p.add_argument("--image_size", type=int, default=299)
    p.add_argument("--seed", type=int, default=0, help="offline stand-in classifier seed")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: InceptionV3 on the host")
    args = p.parse_args(argv)
    device = require(args.device, "inception_score")
    if args.weights:
        mean, std = inception_score_from_dir(
            args.source, args.weights, args.image_size, args.splits, device=device
        )
        kind = "inception"
    elif os.path.isdir(args.source):
        mean, std = inception_score_offline(args.source, args.splits, seed=args.seed)
        kind = RandomFeatureClassifier.name
    else:
        mean, std = inception_score_from_probs(np.load(args.source), args.splits)
        kind = "precomputed-probs"
    out = {"inception_score_mean": mean, "inception_score_std": std, "classifier": kind}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
