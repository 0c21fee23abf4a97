"""InceptionV3 (pool3) for published-comparable FID / IS: the twin of
`aglayout_tpu/eval/inception.py`, as plain `nn.Module`s, NCHW.

The reference computes FID from a TF1 Inception pool_3 graph
(evaluation/fid.py:282-328) and the Inception Score from the same graph's
logits (evaluation/compute_inception_score.py:111-148). No pretrained
weights ship with the repository, but the NETWORK is here: the module names
are torchvision's `state_dict` keys (`Conv2d_1a_3x3.conv.weight`,
`Mixed_5b.branch1x1.bn.running_mean`, `fc.weight`, ...), so a torchvision
`inception_v3_google-*.pth` or pytorch-fid `pt_inception-2015-12-05.pth`
loads with `load_state_dict` (`load_torch_weights`; the `AuxLogits` keys
are skipped).

`fid_variant=True` reproduces pytorch-fid's TF-faithful patches: average
pools with count_include_pad=False in InceptionA/C/E_1 and a max pool in
the E_2 pool branch.

Input protocol (pytorch-fid): RGB in [0, 255] -> bilinear resize to 299 ->
scale to [-1, 1]. `InceptionV3` returns pool3 (N, 2048), and with
`return_logits` also the classifier's output for IS. `InceptionExtractor`
runs it on its device in f32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _avg_pool(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


class BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3, running statistics in eval) + relu."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid: bool = True):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, fid: bool = True):
        super().__init__()
        self.fid = fid
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_max: bool = False, fid: bool = True):
        super().__init__()
        self.pool_max, self.fid = pool_max, fid  # FID variant: E_2 (Mixed_7c) max-pools
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_max and self.fid:
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg_pool(x, count_include_pad=not self.fid)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """torchvision-architecture InceptionV3; module names == torch keys."""

    def __init__(self, fid_variant: bool = True, num_classes: int = 1000):
        super().__init__()
        fid = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, fid=fid)
        self.Mixed_7c = InceptionE(2048, pool_max=True, fid=fid)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x, return_logits: bool = False):
        """x: (N, 3, 299, 299) in [-1, 1] -> pool3 (N, 2048) [, logits]."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = x.mean(dim=(2, 3))
        if not return_logits:
            return pool3
        return pool3, self.fc(pool3)


def preprocess(images_u8, *, device) -> torch.Tensor:
    """RGB [0, 255] NHWC (any size) -> (N, 3, 299, 299) in [-1, 1] on
    `device` (pytorch-fid protocol: bilinear resize, x/255*2-1).

    JAX's `jax.image.resize(..., "bilinear")` equals
    `F.interpolate(mode="bilinear", align_corners=False)` when it enlarges,
    as it does here (64^2 and 128^2 images in). It does not when it
    shrinks: JAX antialiases there and `F.interpolate` does not."""
    x = torch.as_tensor(np.asarray(images_u8, np.float32), device=device) / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                      align_corners=False)
    return x * 2.0 - 1.0


def load_torch_weights(path: str) -> dict:
    """torchvision/pytorch-fid `.pth` -> the `state_dict` an `InceptionV3`
    loads strictly: the `AuxLogits` keys dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")}


def load_inception(path: str, fid_variant: bool = True, *, device) -> InceptionV3:
    """An eval-mode InceptionV3 on `device` holding the weights of `path`
    (its classifier as wide as the file's: 1000 for torchvision, 1008 for
    pytorch-fid)."""
    sd = load_torch_weights(path)
    model = InceptionV3(fid_variant, num_classes=sd["fc.weight"].shape[0])
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


class InceptionExtractor:
    """pool3 feature extractor with the FID-standard protocol, on `device`
    in f32 with TF32 off."""

    name = "inception-v3 pool3 (pytorch-fid weights)"
    dim = 2048

    def __init__(self, weights: str, fid_variant: bool = True, *, device):
        self.device = torch.device(device)
        self.model = load_inception(weights, fid_variant, device=self.device)

    def _run(self, images_u8, batch_size: int, logits: bool) -> np.ndarray:
        from aglayout_tpu_torch.utils.device import no_tf32

        outs = []
        with torch.inference_mode(), no_tf32():
            for i in range(0, len(images_u8), batch_size):
                x = preprocess(images_u8[i: i + batch_size], device=self.device)
                out = self.model(x, logits)
                outs.append((out[1] if logits else out).cpu().numpy())
        return np.concatenate(outs, 0) if outs else np.zeros((0, self.dim), np.float32)

    def __call__(self, images_u8: np.ndarray, batch_size: int = 64) -> np.ndarray:
        return self._run(images_u8, batch_size, logits=False)

    def logits(self, images_u8: np.ndarray, batch_size: int = 64) -> np.ndarray:
        return self._run(images_u8, batch_size, logits=True)
