"""LPIPS-style perceptual distance (diversity metric): the twin of
`aglayout_tpu/eval/lpips.py`, on the device.

Capability parity with the reference's vendored PerceptualSimilarity/ (LPIPS
v0.1; its compute_dists_dirs.py compares two result directories and
reports mean/std over pairs — the recorded baseline is mean 0.3360/std
0.1016 on VG 64^2, see BASELINE.md).

True LPIPS needs pretrained AlexNet/VGG features + trained linear weights,
which do not ship with the repository. The distance here is the same
*functional form* (unit-normalized multi-scale feature differences,
spatially averaged, summed over layers) over a pluggable backbone:

  * 'random': an untrained conv pyramid with fixed seed (the same
    `RandomState` draws as JAX's). Random-feature perceptual distances
    correlate with perceptual similarity (though not calibrated to LPIPS)
    and are deterministic across runs — usable for relative diversity
    tracking. NOT comparable to published LPIPS.
  * real LPIPS v0.1: torchvision AlexNet's `features` (its keys) + the
    trained per-channel linear heads, given as weight files.

Images are NHWC in [-1, 1], as JAX's; the features are NCHW.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _random_pyramid_params(seed: int = 0, channels=(3, 32, 64, 128), *, device):
    """The pyramid's conv weights, OIHW: JAX's HWIO draws (scaled in f64,
    then f32, as `jnp.asarray` stores them) transposed."""
    rng = np.random.RandomState(seed)
    params = []
    for cin, cout in zip(channels[:-1], channels[1:]):
        w = rng.randn(3, 3, cin, cout).astype(np.float32) / np.sqrt(9 * cin)
        w = w.astype(np.float32).transpose(3, 2, 0, 1)
        params.append(torch.from_numpy(np.ascontiguousarray(w)).to(device))
    return params


def _pyramid_features(x, params):
    feats = []
    h = x
    for w in params:
        h = F.relu(F.conv2d(h, w, stride=2, padding=1))
        feats.append(h)
    return feats


def _unit(a):
    """Channel-wise L2 normalisation with a floor of 1e-10 (NCHW)."""
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)


def _distance(fx, fy, weights=None):
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (_unit(a) - _unit(b)) ** 2
        if weights is not None:
            d = d * weights[i][None, :, None, None]
        total = total + d.sum(1).mean(dim=(1, 2))
    return total


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def perceptual_distance(x, y, params=None):
    """LPIPS functional form: sum_l mean_hw || x_hat_l - y_hat_l ||^2 with
    channel-unit-normalized features. x, y: (N, H, W, 3) in [-1, 1]."""
    x, y = _nchw(x), _nchw(y)
    params = params or _random_pyramid_params(device=x.device)
    return _distance(_pyramid_features(x, params), _pyramid_features(y, params))  # (N,)


# ---------------------------------------------------------------------------
# Real LPIPS v0.1 (AlexNet backbone + trained linear heads)
# ---------------------------------------------------------------------------

# LPIPS input normalization (richzhang ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_TAPS = (1, 4, 7, 9, 11)  # the relus after features.0, .3, .6, .8, .10


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet's `features` stack (keys `features.{0,3,6,8,10}`);
    forward returns the 5 relu maps LPIPS taps (maxpools after the first
    two)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(), nn.MaxPool2d(3, 2),
        )

    def forward(self, x):
        """x: (N, 3, H, W) in [-1, 1], LPIPS-normalized inside."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)[None, :, None, None]
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)[None, :, None, None]
        h = (x - shift) / scale
        feats = []
        for i, layer in enumerate(self.features[: _TAPS[-1] + 1]):
            h = layer(h)
            if i in _TAPS:
                feats.append(h)
        return feats


def load_alexnet_lpips(alexnet_pth: str, lpips_pth: str, *, device):
    """(torchvision alexnet state_dict, richzhang lpips alex.pth) ->
    (an eval `AlexNetFeatures` on `device` holding the file's `features.*`
    keys, [per-channel linear weight (C,)] x5)."""
    asd = torch.load(alexnet_pth, map_location="cpu", weights_only=True)
    net = AlexNetFeatures()
    net.load_state_dict({k: v for k, v in asd.items() if k.startswith("features.")}, strict=True)

    lsd = torch.load(lpips_pth, map_location="cpu", weights_only=True)
    lins = []
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lsd:
                lins.append(lsd[key].reshape(-1).float().to(device))
                break
        else:
            raise ValueError(f"lin{i} weight not found in {lpips_pth}")
    return net.to(device).eval(), lins


def lpips_alex(x, y, net, lins):
    """True LPIPS v0.1: unit-normalize, squared diff, trained per-channel
    linear weight, spatial average, sum over the 5 layers. x, y: (N, H, W,
    3) in [-1, 1]. (N,) distances."""
    return _distance(net(_nchw(x)), net(_nchw(y)), lins)


LPIPS_NAME = "lpips-v0.1-alexnet"
PYRAMID_NAME = "random-pyramid (not comparable to published LPIPS)"


def distance_fn(alexnet_weights=None, lpips_weights=None, seed: int = 0, *, device):
    """(dist(x, y), backbone name): true LPIPS with both weight files, the
    random pyramid with neither; one file alone raises."""
    if bool(alexnet_weights) != bool(lpips_weights):
        raise ValueError(
            "real LPIPS needs BOTH --alexnet_weights and --lpips_weights; "
            "got only one — refusing to silently fall back to the "
            "random-pyramid stand-in"
        )
    if alexnet_weights:
        net, lins = load_alexnet_lpips(alexnet_weights, lpips_weights, device=device)
        return (lambda a, b: lpips_alex(a, b, net, lins)), LPIPS_NAME
    params = _random_pyramid_params(seed, device=device)
    return (lambda a, b: perceptual_distance(a, b, params)), PYRAMID_NAME


def compute_dists_dirs(
    dir1: str,
    dir2: str,
    image_size: int = 64,
    seed: int = 0,
    alexnet_weights: str | None = None,
    lpips_weights: str | None = None,
    *,
    device,
):
    """Pairwise distance between same-named images in two directories
    (reference compute_dists_dirs.py protocol), on `device` in f32 with
    TF32 off. With both
    weights files the distance is true LPIPS v0.1; otherwise the
    random-pyramid stand-in."""
    from PIL import Image

    from aglayout_tpu_torch.utils.device import no_tf32

    files1 = sorted(glob.glob(os.path.join(dir1, "*.png")))
    dist_fn, _ = distance_fn(alexnet_weights, lpips_weights, seed, device=device)
    dists = []
    with torch.inference_mode(), no_tf32():
        for f1 in files1:
            f2 = os.path.join(dir2, os.path.basename(f1))
            if not os.path.exists(f2):
                continue
            ims = []
            for f in (f1, f2):
                with Image.open(f) as im:
                    im = im.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
                ims.append(torch.from_numpy(np.asarray(im, np.float32) / 127.5 - 1.0)[None])
            d = dist_fn(ims[0].to(device), ims[1].to(device))
            dists.append(float(d[0]))
    return float(np.mean(dists)), float(np.std(dists)), len(dists)


def main(argv=None):
    from aglayout_tpu_torch.utils.device import require

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dir1")
    p.add_argument("dir2")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--alexnet_weights", default=None, help="torchvision alexnet .pth")
    p.add_argument("--lpips_weights", default=None, help="richzhang lpips alex.pth (linear heads)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the distances on the host")
    args = p.parse_args(argv)
    device = require(args.device, "lpips")
    mean, std, n = compute_dists_dirs(
        args.dir1, args.dir2, args.image_size,
        alexnet_weights=args.alexnet_weights, lpips_weights=args.lpips_weights, device=device,
    )
    backbone = LPIPS_NAME if args.alexnet_weights and args.lpips_weights else PYRAMID_NAME
    out = {"mean_dist": mean, "std_dist": std, "pairs": n, "backbone": backbone}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
