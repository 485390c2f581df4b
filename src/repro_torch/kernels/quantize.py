"""The wire formats of the exchange.

- ``quant_fp16`` / ``dequant_fp16``: the fp16 casts of the ``asa16`` and
  ``ring16`` exchanges (and of the fp16 parameter all-gather of
  ``asa16``/``asa8``). For CUDA tensors they launch
  ``csrc/exchange.cu:quant_fp16`` / ``dequant_fp16`` (replacing
  ``repro/kernels/quantize.py:_cast_kernel``); for CPU tensors they run
  ``ref.quant_fp16_ref`` / ``dequant_fp16_ref``. Both round exactly as
  ``x.half()`` / ``h.float()`` do.
- ``quant_int8`` / ``dequant_int8``: blockwise-absmax int8, one fp32
  scale per block of ``BLOCK_N`` (2048) values. For CUDA tensors they launch
  ``csrc/exchange.cu:quant_int8`` / ``dequant_int8`` (replacing
  ``_quant_int8_kernel`` / ``_dequant_int8_kernel`` of the same JAX
  module); for CPU tensors they run ``ref.quant_int8_ref`` /
  ``dequant_int8_ref``, which they equal bit for bit on finite inputs.
  As in the JAX package, no exchange calls them: ``asa8`` quantizes per
  rank chunk.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref


def cast_cost(n: int, src_es: int, dst_es: int) -> tuple:
    """(flops, bytes) of one cast of n values: read and written once, one
    flop a value."""
    return float(n), float(n * (src_es + dst_es))


def int8_cost(entry: str, n: int) -> tuple:
    """(flops, bytes) of ``quant_int8`` (n fp32 read, n int8 and a scale a
    block written; absmax, scale, round, clip, cast: 5 flops a value) or
    ``dequant_int8`` (the int8 values and scales read, n fp32 written)."""
    nb = -(-n // BLOCK_N)
    b = float(4 * n + n + 4 * nb)
    return (5.0 * n, b) if entry == "quant_int8" else (float(n), b)


def _cast(x, src: torch.dtype, dst: torch.dtype, entry: str, plain):
    if x.dtype != src:
        raise TypeError(f"{entry} takes {src}, got {x.dtype}")
    if K.plain_path(x):
        return plain(x)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=dst, device=x.device)
    if x.numel() == 0:
        return out
    if K.launches(x):
        err = getattr(K.load("exchange"), entry)(K.ptr(x), K.ptr(out),
                                                 x.numel(), K.stream_ptr(x))
        K.check(err, entry)
        K.count(entry)
    K.cost(entry, lambda: cast_cost(x.numel(), x.element_size(),
                                    out.element_size()))
    return out


def quant_fp16(x):
    """fp32 -> fp16, any shape (round to nearest even; overflow to inf)."""
    return _cast(x, torch.float32, torch.float16, "quant_fp16",
                 ref.quant_fp16_ref)


def dequant_fp16(x):
    """fp16 -> fp32, any shape (exact)."""
    return _cast(x, torch.float16, torch.float32, "dequant_fp16",
                 ref.dequant_fp16_ref)


BLOCK_N = 2048           # values per scale, as the JAX kernels' default


def quant_int8(x):
    """(n,) fp32 -> (q (n,) int8, scales (ceil(n / BLOCK_N),) fp32)."""
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"quant_int8 takes a 1-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if K.on_cpu(x):
        return ref.quant_int8_ref(x, BLOCK_N)
    x = x.contiguous()
    n = x.shape[0]
    q = torch.empty((n,), dtype=torch.int8, device=x.device)
    scales = torch.empty((-(-n // BLOCK_N),), dtype=torch.float32,
                         device=x.device)
    if n == 0:
        return q, scales
    err = K.load("exchange").quant_int8(K.ptr(x), K.ptr(q), K.ptr(scales), n,
                                        BLOCK_N, K.stream_ptr(x))
    K.check(err, "quant_int8")
    K.count("quant_int8")
    K.cost("quant_int8", lambda: int8_cost("quant_int8", n))
    return q, scales


def dequant_int8(q, scales):
    """(n,) int8 and (ceil(n / BLOCK_N),) fp32 scales -> (n,) fp32."""
    if q.dtype != torch.int8 or q.dim() != 1:
        raise TypeError(f"dequant_int8 takes a 1-D int8 tensor, got "
                        f"{q.dtype} {tuple(q.shape)}")
    n = q.shape[0]
    if scales.dtype != torch.float32 or tuple(scales.shape) != (
            -(-n // BLOCK_N),):
        raise ValueError(f"dequant_int8 takes ({-(-n // BLOCK_N)},) "
                         f"float32 scales, got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if K.on_cpu(q, scales):
        return ref.dequant_int8_ref(q, scales, BLOCK_N)
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    err = K.load("exchange").dequant_int8(K.ptr(q), K.ptr(scales), K.ptr(out),
                                          n, BLOCK_N, K.stream_ptr(q))
    K.check(err, "dequant_int8")
    K.count("dequant_int8")
    K.cost("dequant_int8", lambda: int8_cost("dequant_int8", n))
    return out
