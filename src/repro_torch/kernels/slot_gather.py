"""Fused per-slot logit gather + greedy/temperature sampling.

The serving engine's prefill and decode steps end with, per slot s:

    row_s   = logits[s, idx_s, :]               (the slot's token row)
    greedy  = argmax(row_s)
    sampled = argmax(row_s / T_s + gumbel_s)    (Gumbel-max == categorical)

For CUDA tensors this launches ``csrc/slot_gather.cu`` (replacing
``repro/kernels/slot_gather.py:_kernel``) once: a thread-block cluster of
blocks a slot, each reducing one slice of the vocab, with the slices'
(value, index) pairs merged through distributed shared memory, so there is
no second pass and no scratch (:func:`sampler_plan` cuts the vocab). For
CPU tensors it runs ``ref.slot_gather_sample_ref``. The Gumbel noise is an
input, so a test can feed both versions the same noise and require the
same indices. Top-k/top-p need a vocab sort and stay on the plain path
(``repro_torch.serve.sampling``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref

# the kernel's shape (csrc/slot_gather.cu keeps the same constants)
SAMPLER_THREADS = 512       # threads a block
SAMPLER_VEC = 8             # entries a 16-byte load of bf16/fp16 logits
SAMPLER_MAX_CLUSTER = 16    # blocks a slot: an H100's largest cluster


def sampler_plan(S: int, C: int, V: int, sm_count: int):
    """(CL, slice): each of the S slots' vocab of V entries is cut into CL
    slices of ``slice`` entries (the tail in the last, none empty), one
    block of the slot's cluster each. ``slice`` is a multiple of
    SAMPLER_VEC, so a slice of bf16 logits starts on a 16-byte boundary.

    CL is the largest power of two up to SAMPLER_MAX_CLUSTER whose S
    clusters fit on 7/8 of the card's ``sm_count`` SMs at once (a block
    takes an SM: a cluster's blocks share a GPC, and an H100 holds 7
    clusters of 9-16 such blocks and 15 of 8, not 8 and 16), and no more
    than gives every block one entry a thread. C (rows a slot) does not
    enter: a slot reads only its selected rows. A function of its
    arguments alone: no device value is read."""
    room = sm_count * 7 // 8
    cl = SAMPLER_MAX_CLUSTER
    while cl > 1 and S * cl > room:
        cl //= 2
    cl = min(cl, -(-V // SAMPLER_THREADS))
    slice_ = -(-V // cl)
    slice_ += -slice_ % SAMPLER_VEC
    return -(-V // slice_), slice_


def sampler_cost(S: int, C: int, V: int, es: int) -> tuple:
    """(flops, bytes) of one launch: each slot's selected row of V logits
    at ``es`` bytes and its V fp32 noise read, the one-hot and the
    temperatures read, two int32 indices a slot written; 3 flops an
    entry (scale, add, compare)."""
    return 3.0 * S * V, float(S * V * (es + 4) + S * C * 4 + S * 12)


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
    cl, slice_ = sampler_plan(S, C, V, K.sm_count(logits.device.index or 0))
    out = torch.empty((2, S), dtype=torch.int32, device=logits.device)
    greedy, sampled = out
    err = K.load("slot_gather").slot_gather_sample(
        K.ptr(logits), K.ptr(onehot), K.ptr(temperature), K.ptr(noise),
        K.ptr(greedy), K.ptr(sampled), S, C, V, cl, slice_, code,
        K.stream_ptr(logits))
    K.check(err, "slot_gather_sample")
    K.count("slot_gather_sample", (S, C, V))
    K.cost("slot_gather_sample", lambda: sampler_cost(
        S, C, V, logits.element_size()))
    return greedy, sampled


def clusters_at_once(cl: int) -> int:
    """The clusters of ``cl`` blocks that the current card holds at once,
    as CUDA's occupancy calculator reports it for the kernel (at one
    block an SM an H100 holds 7 of 16 and 15 of 8: ``sampler_plan``'s
    rule)."""
    n = ctypes.c_int(0)
    err = K.load("slot_gather").slot_gather_max_clusters(cl, ctypes.byref(n))
    K.check(err, "slot_gather_max_clusters")
    return n.value
