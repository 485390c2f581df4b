"""The ASA exchange's full-precision sum (paper §3.2: "transfer at half
precision while summing at full").

After the all-to-all leg of a reduce-scatter each rank holds ``k``
received chunks of its shard, in the wire dtype. ``chunk_sum`` adds them
in fp32, rows in order 0..k-1. For CUDA tensors it launches
``csrc/exchange.cu:chunk_sum`` (replacing
``repro/kernels/chunk_sum.py:_chunk_sum_kernel``); for CPU tensors it
runs ``ref.chunk_sum_ref``. The ``asa`` exchangers sum with it.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref


def chunk_sum_cost(k: int, n: int, es: int) -> tuple:
    """(flops, bytes) of one launch: the (k, n) receive read at ``es``
    bytes a value, the (n,) fp32 sum written; k - 1 adds a value."""
    return float((k - 1) * n), float(k * n * es + 4 * n)


def chunk_sum(chunks):
    """(k, ...) float32/bfloat16/float16 chunks -> (...) fp32 sum over the
    leading axis."""
    if chunks.dim() < 2:
        raise ValueError(f"chunks must be (k, ...), got {tuple(chunks.shape)}")
    if K.plain_path(chunks):
        return ref.chunk_sum_ref(chunks.reshape(chunks.shape[0], -1)).reshape(
            chunks.shape[1:])
    code = K.dtype_code(chunks)
    k = chunks.shape[0]
    flat = chunks.contiguous().reshape(k, -1)
    n = flat.shape[1]
    out = torch.empty(chunks.shape[1:], dtype=torch.float32,
                      device=chunks.device)
    if n == 0:
        return out
    if K.launches(flat):
        err = K.load("exchange").chunk_sum(K.ptr(flat), K.ptr(out), k, n,
                                           code, K.stream_ptr(flat))
        K.check(err, "chunk_sum")
        K.count("chunk_sum")
    K.cost("chunk_sum", lambda: chunk_sum_cost(k, n, flat.element_size()))
    return out
