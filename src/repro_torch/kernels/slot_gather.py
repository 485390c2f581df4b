"""Fused per-slot logit gather + greedy/temperature sampling.

The serving engine's prefill and decode steps end with, per slot s:

    row_s   = logits[s, idx_s, :]               (the slot's token row)
    greedy  = argmax(row_s)
    sampled = argmax(row_s / T_s + gumbel_s)    (Gumbel-max == categorical)

For CUDA tensors this launches ``csrc/slot_gather.cu`` (replacing
``repro/kernels/slot_gather.py:_kernel``), which reads each slot's row
once, cut into ``CHUNK``-entry pieces that reduce to (value, index) pairs
in parallel and then per slot; for CPU tensors it runs
``ref.slot_gather_sample_ref``. The Gumbel noise is an
input, so a test can feed both versions the same noise and require the
same indices. Top-k/top-p need a vocab sort and stay on the plain path
(``repro_torch.serve.sampling``).
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref

CHUNK = 4096        # vocab entries per block of the kernel's first pass


def slot_gather_sample(logits, onehot, temperature, noise):
    """logits (S, C, V) float; onehot (S, C) selecting each slot's row;
    temperature (S,); noise (S, V) Gumbel. Returns (greedy (S,), sampled
    (S,)) int32: the argmax of each slot's gathered row and of its
    temperature-scaled noise-perturbed row, first index on ties."""
    S, C, V = logits.shape
    if onehot.shape != (S, C) or temperature.shape != (S,) \
            or noise.shape != (S, V):
        raise ValueError(f"shapes: logits {tuple(logits.shape)}, onehot "
                         f"{tuple(onehot.shape)}, temperature "
                         f"{tuple(temperature.shape)}, noise "
                         f"{tuple(noise.shape)}")
    if K.on_cpu(logits, onehot, temperature, noise):
        return ref.slot_gather_sample_ref(logits, onehot, temperature, noise)
    code = K.dtype_code(logits)
    logits = logits.contiguous()
    onehot = onehot.to(torch.float32).contiguous()
    temperature = temperature.to(torch.float32).contiguous()
    noise = noise.to(torch.float32).contiguous()
    dev = logits.device
    greedy = torch.empty((S,), dtype=torch.int32, device=dev)
    sampled = torch.empty((S,), dtype=torch.int32, device=dev)
    nchunk = -(-V // CHUNK)
    part_v = torch.empty((S, nchunk, 2), dtype=torch.float32, device=dev)
    part_i = torch.empty((S, nchunk, 2), dtype=torch.int32, device=dev)
    err = K.load("slot_gather").slot_gather_sample(
        K.ptr(logits), K.ptr(onehot), K.ptr(temperature), K.ptr(noise),
        K.ptr(greedy), K.ptr(sampled), K.ptr(part_v), K.ptr(part_i), S, C, V,
        CHUNK, code, K.stream_ptr(logits))
    K.check(err, "slot_gather_sample")
    K.count("slot_gather_sample")
    return greedy, sampled
