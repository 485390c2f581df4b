"""Meta-device stand-ins for every model input at every (arch x input
shape), and abstract state and cache (counterpart of
``repro/launch/specs.py``): tensors on the ``meta`` device carry shape
and dtype and hold no memory, the port's ``jax.ShapeDtypeStruct``.

Modality frontends are stubs, as in the reference: VLM image tokens
arrive as precomputed patch embeddings, audio as precomputed frame
embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.gspmd import abstract_params
from repro_torch.models.registry import Model, build_model

__all__ = ["abstract_cache", "abstract_params", "abstract_state",
           "decode_batch_specs", "meta", "train_batch_specs"]


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def train_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The global batch of a training (or prefill) step: images and labels
    for a convnet; frames, tokens and labels for an encoder-decoder;
    tokens and labels, after image embeddings for a VLM (the image
    prefix takes ``min(num_image_tokens, S // 2)`` of the S positions)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "conv":
        return {"images": meta((B, cfg.image_size, cfg.image_size, 3),
                               torch.float32),
                "labels": meta((B,), torch.int32)}
    if cfg.family == "encdec":
        return {"frames": meta((B, cfg.encoder_seq_len, cfg.d_model),
                               torch.float32),
                "tokens": meta((B, S), torch.int32),
                "labels": meta((B, S), torch.int32)}
    batch = {}
    n_text = S
    if cfg.modality == "vlm":
        n_img = min(cfg.num_image_tokens, S // 2)
        n_text = S - n_img
        batch["image_embeds"] = meta((B, n_img, cfg.d_model), torch.float32)
    batch["tokens"] = meta((B, n_text), torch.int32)
    batch["labels"] = meta((B, n_text), torch.int32)
    return batch


def decode_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    return {"tokens": meta((shape.global_batch, 1), torch.int32)}


def abstract_state(model: Model, optimizer):
    """The train state of ``init_train_state`` on the meta device."""
    params = abstract_params(model)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def abstract_cache(model: Model, cfg: ArchConfig, shape: InputShape):
    """The contiguous decode cache of the global batch at the shape's
    sequence length, on the meta device."""
    return build_model(cfg, "meta").init_cache(shape.global_batch,
                                               shape.seq_len)
