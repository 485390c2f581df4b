"""The paper's benchmark convnets (counterpart of
``repro/models/vision.py``): AlexNet in the original grouped topology
(60,965,224 parameters at 227 px and 1000 classes, the paper's Table 2),
VGG-16 (138,357,544 at 224 px) and GoogLeNet with both auxiliary
classifiers.

Layouts follow PyTorch inside and the JAX package at the edges. Images
come in NHWC (B, H, W, 3), as the data sources make them, and run NCHW
through ``F.conv2d``; conv weights are OIHW (``bridge`` maps the JAX
package's HWIO); the FC weights are the JAX package's (in, out) operands,
and every map that feeds an FC layer (AlexNet's pool 5, VGG's pool 5,
GoogLeNet's aux maps) is flattened in (h, w, c) order as the JAX model
flattens its NHWC map, so the FC rows mean the same on both sides.
Grouped convs (``groups=2``) split their output channels contiguously, as
``feature_group_count=2`` does. Convolutions pad as XLA's ``"SAME"``
does: (k - 1) // 2 before and the rest after, which for GoogLeNet's 7x7
stride-2 stem on an even input is (2, 3), not a symmetric 3. Pooling is
VALID unless stated; the Inception pool branch is a SAME 3/1 max pool
(implicit -inf padding, as the reference's ``reduce_window``). No model
applies dropout but AlexNet, as in the reference. The convolutions and FC
matmuls are cuDNN/cuBLAS calls, as the JAX package leaves them to XLA
outside any Pallas kernel.

GoogLeNet's aux heads deviate from the reference at 224 px. The
reference sizes each aux ``fc1`` from ``(image_size // 16 - 5) // 3 + 1``
= 4, which assumes a 14x14 map after 4a/4d; its own VALID 3/2 pools leave
13x13 there, the 5/3 average pool gives 3x3, and its ``conv_loss`` fails
at 224 px (``dot_general`` of 1152 against 2048). The port keeps the
reference's forward and sizes ``fc1`` from the map that forward makes,
as ``init_alexnet`` sizes ``f6``: the same trees at every size where the
reference trains (96, 160 and 192 px among them), and at 224 px
11,543,272 parameters instead of Table 2's 13,378,280 (2 x 128 x 7 x 1024
fewer).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import softmax_xent

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


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial side: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(p, x, stride=1):
    """A square conv with XLA's "SAME" padding, padded explicitly (where
    the total pad is odd the extra row/column goes after)."""
    k = p["w"].shape[-1]
    (t, b), (l, r) = (_same_pads(x.shape[2], k, stride),
                      _same_pads(x.shape[3], k, stride))
    return _conv(p, F.pad(x, (l, r, t, b)), stride)


def _maxpool(x, k=3, s=2):
    return F.max_pool2d(x, kernel_size=k, stride=s)


def _avgpool(x, k, s):
    """VALID average pool, divided by k^2."""
    return F.avg_pool2d(x, kernel_size=k, stride=s)


def _gap(x):
    return x.mean(dim=(2, 3))


def _flat_hwc(x):
    """An NCHW map flattened in (h, w, c) order, as the JAX model flattens
    its NHWC map."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


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
    x = F.relu(_flat_hwc(x) @ p["f6"]["w"] + p["f6"]["b"])
    if train and gen is not None:
        x = _dropout(x, gen)
    x = F.relu(x @ p["f7"]["w"] + p["f7"]["b"])
    if train and gen is not None:
        x = _dropout(x, gen)
    return x @ p["f8"]["w"] + p["f8"]["b"]


# ---------------------------------------------------------------------------
# VGG-16 (138,357,544 parameters at 224 px and 1000 classes)
# ---------------------------------------------------------------------------

_VGG16 = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def init_vgg16(gen, cfg: ArchConfig, device=None):
    side = cfg.image_size // 32
    if side < 1:
        raise ValueError(f"image_size {cfg.image_size} leaves no pool-5 map")
    p, cin, i = {}, 3, 0
    for cout, reps in _VGG16:
        for _ in range(reps):
            p[f"c{i}"] = _conv_init(gen, 3, 3, cin, cout, device=device)
            cin, i = cout, i + 1
    p["f0"] = _fc_init(gen, cin * side * side, 4096, device=device)
    p["f1"] = _fc_init(gen, 4096, 4096, device=device)
    p["f2"] = _fc_init(gen, 4096, cfg.num_classes, device=device)
    return p


def vgg16_forward(p, images):
    """images (B, H, W, 3) NHWC -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    i = 0
    for _, reps in _VGG16:
        for _ in range(reps):
            x = F.relu(_conv(p[f"c{i}"], x, padding=1))
            i += 1
        x = _maxpool(x, k=2, s=2)
    x = F.relu(_flat_hwc(x) @ p["f0"]["w"] + p["f0"]["b"])
    x = F.relu(x @ p["f1"]["w"] + p["f1"]["b"])
    return x @ p["f2"]["w"] + p["f2"]["b"]


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1, with both aux classifiers)
# ---------------------------------------------------------------------------

# (1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool projection)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}
_AUX_AFTER = {"4a": 0, "4d": 1}         # aux head j after this module
_POOL_AFTER = ("3b", "4e")


def _init_inception(gen, cin, spec, device=None):
    c1, r3, c3, r5, c5, pp = spec
    return {"b1": _conv_init(gen, 1, 1, cin, c1, device=device),
            "b3r": _conv_init(gen, 1, 1, cin, r3, device=device),
            "b3": _conv_init(gen, 3, 3, r3, c3, device=device),
            "b5r": _conv_init(gen, 1, 1, cin, r5, device=device),
            "b5": _conv_init(gen, 5, 5, r5, c5, device=device),
            "bp": _conv_init(gen, 1, 1, cin, pp, device=device)}


def _inception(p, x):
    b1 = F.relu(_conv(p["b1"], x))
    b3 = F.relu(_conv(p["b3"], F.relu(_conv(p["b3r"], x)), padding=1))
    b5 = F.relu(_conv(p["b5"], F.relu(_conv(p["b5r"], x)), padding=2))
    bp = F.relu(_conv(p["bp"], F.max_pool2d(x, 3, 1, padding=1)))
    return torch.cat([b1, b3, b5, bp], dim=1)


def _out_ch(spec) -> int:
    return spec[0] + spec[2] + spec[4] + spec[5]


def googlenet_sides(image_size: int) -> dict:
    """Map sides of the forward below: after the stem (``stem``), at the
    aux heads' input (``aux_in``, after 4a and 4d), after their 5/3 pool
    (``aux``), and before the global average pool (``gap``)."""
    stem = _pooled(_pooled(-(-image_size // 2)))
    aux_in = _pooled(stem)
    return {"stem": stem, "aux_in": aux_in, "aux": (aux_in - 5) // 3 + 1,
            "gap": _pooled(aux_in)}


def init_googlenet(gen, cfg: ArchConfig, device=None):
    sides = googlenet_sides(cfg.image_size)
    if sides["aux"] < 1 or sides["gap"] < 1:
        raise ValueError(f"image_size {cfg.image_size} is too small for "
                         f"GoogLeNet's aux heads: map sides {sides}")
    p = {"c1": _conv_init(gen, 7, 7, 3, 64, device=device),
         "c2r": _conv_init(gen, 1, 1, 64, 64, device=device),
         "c2": _conv_init(gen, 3, 3, 64, 192, device=device)}
    cin = 192
    for name, spec in _INCEPTION.items():
        p[f"i{name}"] = _init_inception(gen, cin, spec, device)
        cin = _out_ch(spec)
    p["fc"] = _fc_init(gen, cin, cfg.num_classes, device=device)
    side = sides["aux"]
    for j, cin_aux in ((0, 512), (1, 528)):
        p[f"aux{j}_conv"] = _conv_init(gen, 1, 1, cin_aux, 128, device=device)
        p[f"aux{j}_fc1"] = _fc_init(gen, 128 * side * side, 1024,
                                    device=device)
        p[f"aux{j}_fc2"] = _fc_init(gen, 1024, cfg.num_classes,
                                    device=device)
    return p


def _aux_head(p, j, x):
    x = F.relu(_conv(p[f"aux{j}_conv"], _avgpool(x, 5, 3)))
    x = F.relu(_flat_hwc(x) @ p[f"aux{j}_fc1"]["w"] + p[f"aux{j}_fc1"]["b"])
    return x @ p[f"aux{j}_fc2"]["w"] + p[f"aux{j}_fc2"]["b"]


def googlenet_forward(p, images, train: bool = False):
    """images (B, H, W, 3) NHWC -> (logits, [aux0, aux1]); the aux heads
    run only when ``train``."""
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.relu(_conv_same(p["c1"], x, stride=2))
    x = lrn(_maxpool(x))
    x = F.relu(_conv(p["c2r"], x))
    x = F.relu(_conv(p["c2"], x, padding=1))
    x = _maxpool(lrn(x))
    aux = []
    for name in _INCEPTION:
        x = _inception(p[f"i{name}"], x)
        if name in _POOL_AFTER:
            x = _maxpool(x)
        if train and name in _AUX_AFTER:
            aux.append(_aux_head(p, _AUX_AFTER[name], x))
    return _gap(x) @ p["fc"]["w"] + p["fc"]["b"], aux


# ---------------------------------------------------------------------------
# unified interface
# ---------------------------------------------------------------------------

_INITS = {"alexnet": init_alexnet, "vgg16": init_vgg16,
          "googlenet": init_googlenet}


def init_conv(gen, cfg: ArchConfig, device=None):
    if cfg.conv_arch not in _INITS:
        raise ValueError(f"unknown conv_arch {cfg.conv_arch!r}")
    return _INITS[cfg.conv_arch](gen, cfg, device)


def conv_loss(params, batch, cfg: ArchConfig, gen=None):
    """batch {images (B, H, W, 3), labels (B,)} -> (loss, {loss, aux}).
    ``gen`` (a torch.Generator) turns AlexNet's dropout on; None runs
    without it. GoogLeNet's loss adds 0.3 of each aux head's; the ``aux``
    metric is 0 for every arch, as in the reference."""
    images, labels = batch["images"], batch["labels"]
    if cfg.conv_arch == "googlenet":
        logits, aux = googlenet_forward(params, images, train=True)
        loss = softmax_xent(logits, labels)
        for a in aux:
            loss = loss + 0.3 * softmax_xent(a, labels)
    elif cfg.conv_arch == "alexnet":
        loss = softmax_xent(alexnet_forward(params, images, train=True,
                                            gen=gen), labels)
    else:
        loss = softmax_xent(vgg16_forward(params, images), labels)
    return loss, {"loss": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                   device=loss.device)}


def conv_predict(params, images, cfg: ArchConfig):
    if cfg.conv_arch == "googlenet":
        return googlenet_forward(params, images)[0]
    if cfg.conv_arch == "alexnet":
        return alexnet_forward(params, images)
    return vgg16_forward(params, images)
