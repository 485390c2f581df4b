"""The fused tail of the sharded update: dequant + fp32 chunk sum + weight
decay + momentum-SGD on this rank's flat shard, in one pass.

    g  = scale * sum_r dequant(recv[r])
    g += weight_decay * wd_mask * p
    m' = momentum * m + g
    p' = p - lr * m'                     (classic)
    p' = p - lr * (g + momentum * m')    (nesterov)

``recv`` is the (k, s) un-summed all-to-all receive of the reduce-scatter
half: fp32/bf16/fp16, or int8 with one fp32 scale per received chunk (the
``asa8`` wire). ``scale`` folds the data-parallel mean (1/k) and any
microbatch mean (1/(k m)). For CUDA tensors it launches
``csrc/sgd.cu:fused_rs_update`` (replacing
``repro/kernels/fused_rs_update.py:_kernel`` and ``_kernel_q``); for CPU
tensors it runs ``ref.fused_rs_update_ref``. The kernel shares its update
tail with ``fused_sgd``, so it equals ``chunk_sum`` followed by
``fused_sgd`` bit for bit. This is ``Optimizer.rs_fused_update``'s kernel.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref
from repro_torch.kernels.fused_sgd import _flat_fp32, lr_operand, lr_tensor

WIRE = (torch.float32, torch.bfloat16, torch.float16, torch.int8)


def fused_rs_update_cost(k: int, s: int, es: int, mask: bool,
                         int8: bool) -> tuple:
    """(flops, bytes) of one launch: the (k, s) receive at ``es`` bytes a
    value (+ its k fp32 scales on the int8 wire), p and m read and p', m'
    written in fp32, the weight-decay mask when one is read; k + 7 flops
    a value (2 k + 7 with the int8 scaling)."""
    flops = (2 * k + 7 if int8 else k + 7) * s
    nbytes = k * s * es + (4 * k if int8 else 0) + 16 * s + (4 * s if mask
                                                             else 0)
    return float(flops), float(nbytes)


def fused_rs_update(recv, p, m, lr, *, wd_mask=None, scale: float = 1.0,
                    momentum: float = 0.9, nesterov: bool = False,
                    weight_decay: float = 0.0, scales=None):
    """recv (k, s); p, m (s,) fp32; wd_mask (s,) 0/1 or None (no decay);
    scales (k,) fp32 for an int8 ``recv``, else None -> (p', m') fp32."""
    if recv.dim() != 2:
        raise ValueError(f"recv must be (k, s), got {tuple(recv.shape)}")
    k, s = recv.shape
    if (recv.dtype == torch.int8) != (scales is not None):
        raise ValueError("an int8 receive needs its (k,) scales, and only "
                         "an int8 receive takes them")
    if K.plain_path(recv, p, m, wd_mask, scales, *lr_operand(lr)):
        return ref.fused_rs_update_ref(
            recv, p, m, wd_mask, lr, momentum, nesterov, scale, weight_decay,
            None if scales is None else scales.reshape(-1))
    code = K.dtype_code(recv, WIRE)
    recv = recv.contiguous()
    p, m = _flat_fp32("p", p, s), _flat_fp32("m", m, s)
    mask = None
    if weight_decay and wd_mask is not None:
        mask = _flat_fp32("wd_mask", wd_mask.float(), s)
    if scales is not None:
        scales = _flat_fp32("scales", scales.reshape(-1).float(), k)
    lr_t = lr_tensor(lr, p.device)
    po, mo = torch.empty_like(p), torch.empty_like(m)
    if s == 0:
        return po, mo
    if K.launches(p):
        err = K.load("sgd").fused_rs_update(
            K.ptr(recv), K.ptr(scales), K.ptr(p), K.ptr(m), K.ptr(mask),
            K.ptr(lr_t), K.ptr(po), K.ptr(mo), k, s, code, float(scale),
            float(weight_decay), float(momentum), int(bool(nesterov)),
            K.stream_ptr(p))
        K.check(err, "fused_rs_update")
        K.count("fused_rs_update")
    K.cost("fused_rs_update", lambda: fused_rs_update_cost(
        k, s, recv.element_size(), mask is not None, scales is not None))
    return po, mo
