"""The paper's AlexNet (counterpart of ``repro/models/vision.py``): the
original grouped topology, 60,965,224 parameters at 227 px and 1000
classes (the paper's Table 2).

Layouts follow PyTorch inside and the JAX package at the edges. Images
come in NHWC (B, H, W, 3), as the data sources make them, and run NCHW
through ``F.conv2d``; conv weights are OIHW (``bridge`` maps the JAX
package's HWIO); the FC weights are the JAX package's (in, out) operands,
and the pool-5 features are flattened in (h, w, c) order as the JAX model
flattens its NHWC map, so ``f6`` means the same rows on both sides.
Grouped convs (``groups=2``) split their output channels contiguously, as
``feature_group_count=2`` does. Pooling is VALID 3/2. The convolutions and
FC matmuls are cuDNN/cuBLAS calls, as the JAX package leaves them to XLA
outside any Pallas kernel.

VGG-16 and GoogLeNet are not ported yet (ROADMAP queue 1, "VGG-16 and
GoogLeNet"): ``init_conv`` raises for them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import softmax_xent

_NOT_PORTED = ("{arch} is not ported yet (ROADMAP queue 1: VGG-16 and "
               "GoogLeNet); the port's vision model is AlexNet")


def _conv_init(gen, kh, kw, cin, cout, groups=1, device=None):
    fan_in = kh * kw * cin // groups
    w = torch.empty((cout, cin // groups, kh, kw), dtype=torch.float32,
                    device=device)
    if w.device.type != "meta":
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    return {"w": w, "b": torch.zeros((cout,), dtype=torch.float32,
                                     device=device)}


def _fc_init(gen, cin, cout, device=None):
    w = torch.empty((cin, cout), dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(0.0, math.sqrt(2.0 / cin), generator=gen)
    return {"w": w, "b": torch.zeros((cout,), dtype=torch.float32,
                                     device=device)}


def _conv(p, x, stride=1, padding=0, groups=1):
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding,
                    groups=groups)


def _maxpool(x):
    return F.max_pool2d(x, kernel_size=3, stride=2)


def lrn(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 2.0):
    """AlexNet's local response normalization over the channels of an
    NCHW map: x / (k + alpha * sum of x^2 over n channels)^beta, with
    zeros past the edge channels. Unlike ``F.local_response_norm``, alpha
    is not divided by n, and k = 2."""
    sq = x * x
    pad = F.pad(sq, (0, 0, 0, 0, n // 2, n // 2))
    C = x.shape[1]
    acc = torch.zeros_like(x)
    for i in range(n):
        acc = acc + pad[:, i:i + C]
    return x / torch.pow(k + alpha * acc, beta)


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------

def _pooled(n: int) -> int:
    return (n - 3) // 2 + 1


def feature_side(image_size: int) -> int:
    """Side of the pool-5 map: 11x11/4 VALID conv, then three 3/2 pools
    around SAME convs."""
    return _pooled(_pooled(_pooled((image_size - 11) // 4 + 1)))


def init_alexnet(gen, cfg: ArchConfig, device=None):
    side = feature_side(cfg.image_size)
    if side < 1:
        raise ValueError(f"image_size {cfg.image_size} leaves no pool-5 map")
    return {
        "c1": _conv_init(gen, 11, 11, 3, 96, device=device),
        "c2": _conv_init(gen, 5, 5, 96, 256, groups=2, device=device),
        "c3": _conv_init(gen, 3, 3, 256, 384, device=device),
        "c4": _conv_init(gen, 3, 3, 384, 384, groups=2, device=device),
        "c5": _conv_init(gen, 3, 3, 384, 256, groups=2, device=device),
        "f6": _fc_init(gen, side * side * 256, 4096, device=device),
        "f7": _fc_init(gen, 4096, 4096, device=device),
        "f8": _fc_init(gen, 4096, cfg.num_classes, device=device),
    }


def _alexnet_features(p, x):
    x = F.relu(_conv(p["c1"], x, stride=4))
    x = _maxpool(lrn(x))
    x = F.relu(_conv(p["c2"], x, padding=2, groups=2))
    x = _maxpool(lrn(x))
    x = F.relu(_conv(p["c3"], x, padding=1))
    x = F.relu(_conv(p["c4"], x, padding=1, groups=2))
    x = F.relu(_conv(p["c5"], x, padding=1, groups=2))
    return _maxpool(x)


def _dropout(x, gen):
    keep = torch.empty_like(x).bernoulli_(0.5, generator=gen)
    return x * keep * 2.0


def alexnet_forward(p, images, train: bool = False, gen=None):
    """images (B, H, W, 3) NHWC -> logits (B, classes). Dropout 0.5 after
    f6 and f7 when ``train`` and a generator is given."""
    x = images.permute(0, 3, 1, 2).contiguous()
    x = _alexnet_features(p, x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) order
    x = F.relu(x @ p["f6"]["w"] + p["f6"]["b"])
    if train and gen is not None:
        x = _dropout(x, gen)
    x = F.relu(x @ p["f7"]["w"] + p["f7"]["b"])
    if train and gen is not None:
        x = _dropout(x, gen)
    return x @ p["f8"]["w"] + p["f8"]["b"]


# ---------------------------------------------------------------------------
# unified interface
# ---------------------------------------------------------------------------

def init_conv(gen, cfg: ArchConfig, device=None):
    if cfg.conv_arch != "alexnet":
        raise NotImplementedError(_NOT_PORTED.format(arch=cfg.conv_arch))
    return init_alexnet(gen, cfg, device)


def conv_loss(params, batch, cfg: ArchConfig, gen=None):
    """batch {images (B, H, W, 3), labels (B,)} -> (loss, {loss, aux}).
    ``gen`` (a torch.Generator) turns dropout on; None runs without it."""
    if cfg.conv_arch != "alexnet":
        raise NotImplementedError(_NOT_PORTED.format(arch=cfg.conv_arch))
    logits = alexnet_forward(params, batch["images"], train=True, gen=gen)
    loss = softmax_xent(logits, batch["labels"])
    return loss, {"loss": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                   device=loss.device)}


def conv_predict(params, images, cfg: ArchConfig):
    if cfg.conv_arch != "alexnet":
        raise NotImplementedError(_NOT_PORTED.format(arch=cfg.conv_arch))
    return alexnet_forward(params, images)
