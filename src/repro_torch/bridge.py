"""Parameter bridge: the JAX package's parameter trees, given as numpy
arrays, to the port's parameters.

Convnets (``conv_params_from_jax``): every 4-D leaf is a conv weight and
goes from the JAX package's HWIO to PyTorch's OIHW (a transpose, 1x1
convs included; grouped convs split their output channels contiguously
on both sides, so no regrouping); FC weights and all biases keep their
layout. The trees keep their nesting, so GoogLeNet's Inception modules
(``i3a.b3r.w``, ...) and aux heads (``aux0_fc1.w``, ...) cross as they
are.

Decoders (``decoder_params_from_jax``): the JAX tree stacks consecutive
same-kind layers into ``blocks[seg]`` with a leading layer axis; the port
keeps one dict per layer (``params["layers"]``). Hymba's ``meta`` tokens
cross as a top-level leaf. Leaves keep their layout — dense weights are the
same ``(in, *out)`` einsum operands on both sides — so both packages
compute the same thing from the same numbers.

Encoder-decoders (``encdec_params_from_jax``): the JAX tree stacks the
encoder and decoder layers along a leading axis in ``enc`` and ``dec``;
the port keeps one dict per layer in each list. Nothing here imports JAX:
convert the tree with ``np.asarray`` on each leaf first.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _unstack(stacked, device) -> list:
    """A tree of leaves with a leading layer axis -> one tree a layer."""
    count = np.asarray(next(_leaves(stacked))).shape[0]
    return [_map(stacked, lambda a, j=j: to_tensor(np.asarray(a)[j], device))
            for j in range(count)]


def decoder_params_from_jax(tree, device=None) -> dict:
    """{embed, ln_f, [head], [meta], blocks: [stacked segment trees]}
    (numpy leaves) -> {embed, ln_f, [head], [meta], layers: [per-layer
    trees]}. SSM leaves ({"ssm": {wz, ..., A_log, D, norm}}) and the
    hybrid layer's ``fuse_na``/``fuse_ns`` cross like any other leaf."""
    out = {k: to_tensor(v, device) for k, v in tree.items() if k != "blocks"}
    out["layers"] = [lp for seg in tree["blocks"]
                     for lp in _unstack(seg, device)]
    return out


def encdec_params_from_jax(tree, device=None) -> dict:
    """{embed, head, ln_enc, ln_dec, enc, dec} with ``enc``/``dec``
    stacked along their layer axis (numpy leaves) -> the same dict with
    ``enc``/``dec`` lists of per-layer trees."""
    out = {k: to_tensor(v, device) for k, v in tree.items()
           if k not in ("enc", "dec")}
    out["enc"] = _unstack(tree["enc"], device)
    out["dec"] = _unstack(tree["dec"], device)
    return out


def conv_params_from_jax(tree, device=None) -> dict:
    """A convnet tree with HWIO conv weights (numpy leaves, nested dicts of
    {w, b}) -> the same tree with OIHW conv weights as tensors."""
    def leaf(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return to_tensor(a, device)
    return _map(tree, leaf)
