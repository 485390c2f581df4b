"""Fused momentum-SGD update on flat fp32 tensors.

    m' = momentum * m + g
    p' = p - lr * m'                     (classic)
    p' = p - lr * (g + momentum * m')    (nesterov)

For CUDA tensors it launches ``csrc/sgd.cu:fused_sgd`` (replacing
``repro/kernels/fused_sgd.py:_fused_sgd_kernel``), one pass that reads
(p, g, m) and writes (p', m'); for CPU tensors it runs
``ref.fused_sgd_ref``. ``lr`` may be a Python number or a one-element
fp32 tensor on the device; the kernel reads it from device memory, as the
Pallas kernel reads ``lr_ref[0]``. This is the ``fused_kernel`` plug-in of
``optim.sgd_momentum``.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref


def lr_tensor(lr, device) -> torch.Tensor:
    """``lr`` as the one-element fp32 device tensor the kernels read."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"lr must hold one value, got {tuple(lr.shape)}")
        return lr.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(lr), dtype=torch.float32, device=device)


def lr_operand(lr) -> tuple:
    """``lr`` among the tensors whose devices must agree (a Python number
    has no device)."""
    return (lr,) if isinstance(lr, torch.Tensor) else ()


def _flat_fp32(name, t, n):
    if t.dtype != torch.float32 or t.numel() != n:
        raise ValueError(f"{name} must be fp32 with {n} elements, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def fused_sgd_cost(n: int) -> tuple:
    """(flops, bytes) of one launch over n values: p, g, m read and p', m'
    written in fp32; 5 flops a value."""
    return 5.0 * n, 20.0 * n


def fused_sgd(p, g, m, lr, momentum: float = 0.9, nesterov: bool = False):
    """p, g, m fp32 of one shape -> (p', m') fp32 of that shape."""
    if K.plain_path(p, g, m, *lr_operand(lr)):
        return ref.fused_sgd_ref(p, g, m, lr, momentum, nesterov)
    n = p.numel()
    p, g, m = (_flat_fp32(a, t, n) for a, t in (("p", p), ("g", g), ("m", m)))
    lr_t = lr_tensor(lr, p.device)
    po, mo = torch.empty_like(p), torch.empty_like(m)
    if n == 0:
        return po, mo
    if K.launches(p):
        err = K.load("sgd").fused_sgd(K.ptr(p), K.ptr(g), K.ptr(m),
                                      K.ptr(lr_t), K.ptr(po), K.ptr(mo), n,
                                      float(momentum), int(bool(nesterov)),
                                      K.stream_ptr(p))
        K.check(err, "fused_sgd")
        K.count("fused_sgd")
    K.cost("fused_sgd", lambda: fused_sgd_cost(n))
    return po, mo
