"""FID: Fréchet Inception Distance, dir-vs-dir: the twin of
`aglayout_tpu/eval/fid.py` (host numpy, as JAX's host numpy and scipy; the
Inception network runs on the device, `eval/inception.py`).

Capability parity with the reference's evaluation/fid.py: activation
statistics (mean + covariance) per directory of PNGs, Fréchet distance via
the trace of the matrix sqrt (calculate_frechet_distance, reference
:112-163), <=10k image cap and resize-to-model-size protocol (:308-311,
384-385).

The reference downloads a TF1 Inception graph at runtime; this environment
is zero-egress, so the feature extractor is pluggable:

  * 'inception': torchvision/TF Inception pool3 features when a weights
    file is available (pass --weights). Use this for numbers comparable to
    published FID.
  * 'pixel': deterministic random-projection of resized pixels — always
    available, suitable for tracking relative progress between two of our
    own runs, NOT comparable to published FID. Clearly labeled in output.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def compute_statistics(features: np.ndarray):
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def _significant(lam: np.ndarray, n: int) -> np.ndarray:
    """The eigenvalues of a symmetric positive semi-definite matrix of an
    n-d problem, those within the eigensolver's rounding of 0 (n * eps *
    the largest) set to 0: their square roots would add noise of order
    sqrt(eps) a dimension."""
    return np.where(lam > n * np.finfo(lam.dtype).eps * lam.max(initial=0), lam, 0)


def trace_sqrt_product(sigma1, sigma2) -> float:
    """Tr(sqrtm(sigma1 sigma2)) of two symmetric positive semi-definite
    matrices, in f64, by symmetric eigendecompositions. With A = V S V^T
    the square root of sigma1 (`eigh`; S^2 the eigenvalues `_significant`
    keeps, V their vectors), sigma1 sigma2 = A (A sigma2) has the
    eigenvalues of A sigma2 A = V (S V^T sigma2 V S) V^T, so the trace is
    the sum of the square roots of the eigenvalues of the r x r S V^T
    sigma2 V S (r the rank kept; its eigenvalues clipped alike). NaN where
    an input or that matrix is not finite."""
    sigma1, sigma2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    if not (np.isfinite(sigma1).all() and np.isfinite(sigma2).all()):
        return float("nan")
    n = sigma1.shape[0]
    lam, v = np.linalg.eigh(sigma1)
    keep = _significant(lam, n) > 0
    b = v[:, keep] * np.sqrt(lam[keep])
    m = b.T @ sigma2 @ b
    if not np.isfinite(m).all():
        return float("nan")
    return float(np.sqrt(_significant(np.linalg.eigvalsh((m + m.T) / 2), n)).sum())


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), the reference's
    calculate_frechet_distance (:112-163) with the trace of the square
    root taken by `trace_sqrt_product` instead of `scipy.linalg.sqrtm`
    (the same value; 2048-d in about a tenth of the time). As the
    reference, eps * I is added to both covariances when the first value
    is not finite (here only where an input is not finite or the product
    overflows: a singular product needs no offset). The reference's
    imaginary-part check has nothing left to check: the eigenvalues of a
    symmetric matrix are real."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    tr_covmean = trace_sqrt_product(sigma1, sigma2)
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_covmean = trace_sqrt_product(sigma1 + offset, sigma2 + offset)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def load_images(path_or_dir: str, image_size: int, max_images: int = 10000) -> np.ndarray:
    """Directory of PNG/JPG -> float32 NHWC in [0, 255], resized.

    Mirrors the reference protocol: cap at 10k images, resize to the
    model's output resolution (:308-311, 384).
    """
    from PIL import Image

    files = sorted(
        glob.glob(os.path.join(path_or_dir, "*.png"))
        + glob.glob(os.path.join(path_or_dir, "*.jpg"))
    )[:max_images]
    out = np.zeros((len(files), image_size, image_size, 3), np.float32)
    for i, f in enumerate(files):
        with Image.open(f) as img:
            img = img.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
        out[i] = np.asarray(img, np.float32)
    return out


class PixelProjectionExtractor:
    """Deterministic 2048-d random projection of 32x32 grayscale pixels.

    Offline-safe stand-in with the same API as an Inception extractor; FID
    computed on it tracks distribution drift between two of OUR runs but is
    NOT comparable to published Inception-FID numbers.
    """

    name = "pixel-projection-2048 (not comparable to Inception FID)"
    dim = 2048

    def __init__(self, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.proj = rng.randn(32 * 32 * 3, self.dim).astype(np.float32) / 32.0

    def __call__(self, images_u8: np.ndarray, batch_size: int = 256) -> np.ndarray:
        from PIL import Image

        feats = np.zeros((len(images_u8), self.dim), np.float32)
        for i in range(len(images_u8)):
            img = Image.fromarray(images_u8[i].astype(np.uint8)).resize((32, 32), Image.BILINEAR)
            x = np.asarray(img, np.float32).reshape(-1) / 255.0
            feats[i] = x @ self.proj
        return feats


def make_extractor(kind: str = "pixel", weights: str | None = None, *, device):
    """The pixel stand-in (host), or InceptionV3 pool3 on `device`."""
    if kind == "pixel":
        return PixelProjectionExtractor()
    if kind == "inception":
        from aglayout_tpu_torch.eval.inception import InceptionExtractor

        if not weights:
            raise ValueError(
                "kind='inception' needs --weights pointing at a torchvision "
                "inception_v3 or pytorch-fid pt_inception .pth state_dict "
                "(the network is implemented in eval/inception.py; this "
                "zero-egress image cannot ship the pretrained file itself)."
            )
        return InceptionExtractor(weights, device=device)
    raise ValueError(kind)


def calculate_fid_given_paths(path1: str, path2: str, image_size: int = 64, extractor=None):
    extractor = extractor or PixelProjectionExtractor()
    stats = []
    for p in (path1, path2):
        imgs = load_images(p, image_size)
        feats = extractor(imgs)
        stats.append(compute_statistics(feats))
    return frechet_distance(stats[0][0], stats[0][1], stats[1][0], stats[1][1])


def main(argv=None):
    from aglayout_tpu_torch.utils.device import require

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path1")
    p.add_argument("path2")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--extractor", default="pixel", choices=["pixel", "inception"])
    p.add_argument("--weights", default=None, help="torch .pth for --extractor inception")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: InceptionV3 on the host")
    args = p.parse_args(argv)
    device = require(args.device, "fid")
    ext = make_extractor(args.extractor, args.weights, device=device)
    fid = calculate_fid_given_paths(args.path1, args.path2, args.image_size, ext)
    out = {"fid": fid, "extractor": ext.name}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
