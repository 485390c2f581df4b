"""The fp16 wire casts of the ``asa16`` exchange (and of the fp16
parameter all-gather of ``asa16``/``asa8``).

For CUDA tensors they launch ``csrc/exchange.cu:quant_fp16`` /
``dequant_fp16`` (replacing ``repro/kernels/quantize.py:_cast_kernel``);
for CPU tensors they run ``ref.quant_fp16_ref`` / ``dequant_fp16_ref``.
Both round exactly as ``x.half()`` / ``h.float()`` do. The blockwise int8
kernels of the same JAX module (``quant_int8`` / ``dequant_int8``) have
no caller on any path yet and are not ported.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref


def _cast(x, src: torch.dtype, dst: torch.dtype, entry: str, plain):
    if x.dtype != src:
        raise TypeError(f"{entry} takes {src}, got {x.dtype}")
    if K.on_cpu(x):
        return plain(x)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=dst, device=x.device)
    if x.numel() == 0:
        return out
    err = getattr(K.load("exchange"), entry)(K.ptr(x), K.ptr(out), x.numel(),
                                             K.stream_ptr(x))
    K.check(err, entry)
    K.count(entry)
    return out


def quant_fp16(x):
    """fp32 -> fp16, any shape (round to nearest even; overflow to inf)."""
    return _cast(x, torch.float32, torch.float16, "quant_fp16",
                 ref.quant_fp16_ref)


def dequant_fp16(x):
    """fp16 -> fp32, any shape (exact)."""
    return _cast(x, torch.float16, torch.float32, "dequant_fp16",
                 ref.dequant_fp16_ref)
