"""Unified model API (counterpart of ``repro/models/registry.py``).

``build_model(cfg, device=None)`` returns a :class:`Model` with:

- ``init(seed_or_generator=0) -> params``   master params (``param_dtype``)
- ``forward(params, batch) -> logits``      full-sequence forward
- ``init_cache(batch, max_len)`` / ``init_paged_cache(max_slots,
  page_size, num_pages)``
- ``decode_step(params, cache, batch, pos, seq_len, block_tables=None,
  page_size=0) -> (logits, cache)``
- ``chunk_prefill(params, cache, tokens, pos0, valid, *, seq_len,
  block_tables=None, page_size=0) -> (logits, cache)``
- ``loss_fn(params, batch, gen=None, gather=None) -> (loss, metrics)``
  next-token cross-entropy on ``batch`` {tokens, labels} plus the MoE
  layers' load-balance loss (metrics {"loss", "aux"}); differentiable,
  so gradients flow through the cast to the fp32 masters; ``gather``
  (sharded training, ``core/gspmd.py``) takes ``params`` as shards and
  gathers them a layer at a time

Decoders of dense, MoE, SSM and hybrid layers, with GQA or MLA attention
(DeepSeek-V2: MLA with the MoE of ``models/moe.py`` after
``first_k_dense`` dense layers; Mamba-2: SSD blocks alone; Hymba:
attention and SSD side by side, after 128 meta tokens; VLMs take
``batch["image_embeds"]`` before the tokens); ``init`` draws every leaf
from one ``torch.Generator`` on ``device`` (the MoE router in fp32
whatever ``param_dtype`` says). Every decoder exposes the same fields,
``init_paged_cache`` included: a pure-SSM model's paged pool holds its
slot lanes alone, and the serving engine, not the model, decides to run
it slot-granular.

The ``encdec`` family (SeamlessM4T's backbone; ``models/encdec.py``)
has ``init``, ``forward(params, batch)`` and ``loss_fn`` on batch
{frames, tokens, labels}, ``init_cache(batch, max_len)``,
``prefill(params, frames, cache) -> cache`` (the encoder once, then each
layer's cross K/V) and ``decode_step(params, cache, batch, pos,
seq_len)``; no chunked prefill and no paged cache, as in the reference.
Its ``loss_fn`` takes ``gather=None`` alone: sharded (gspmd) training
gathers its tree whole before the loss (``core/gspmd.py``), as for every
family but the decoders.

Every call casts fp32 matrices to the compute dtype (``cast_params``);
a caller that keeps params already cast (the serving engine) pays
nothing for that. ``device`` defaults to ``cuda`` and raises when no GPU
is visible; pass ``device="cpu"`` for the plain CPU path.

The ``conv`` family (AlexNet, VGG-16, GoogLeNet; ``models/vision.py``)
trains in fp32 and has

- ``init(generator) -> params``             fp32, from an explicit
  ``torch.Generator`` (none on the ``meta`` device)
- ``loss_fn(params, batch, gen=None) -> (loss, metrics)``  AlexNet's
  dropout draws from ``gen`` (None runs without it); GoogLeNet's loss
  takes its two aux heads at 0.3 each
- ``forward(params, batch) -> logits``
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import default_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer, vision
from repro_torch.models.common import dtype_of


def cast_params(params, dtype):
    """Cast matmul weights (fp32 tensors with ndim >= 2) to the compute
    dtype; norm scales and biases keep their dtype. Returns a new tree."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_params(v, dtype) for v in params)
    if params.ndim >= 2 and params.dtype == torch.float32:
        return params.to(dtype)
    return params


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    forward: Callable
    init_cache: Callable | None = None
    decode_step: Callable | None = None
    chunk_prefill: Callable | None = None
    init_paged_cache: Callable | None = None
    loss_fn: Callable | None = None
    prefill: Callable | None = None      # encdec: encoder -> cross K/V


def _build_conv(cfg: ArchConfig, dev: torch.device) -> Model:
    def init(generator):
        if dev.type != "meta" and not isinstance(generator, torch.Generator):
            raise TypeError("conv init takes an explicit torch.Generator "
                            f"(got {type(generator).__name__})")
        with torch.no_grad():
            return vision.init_conv(generator, cfg, dev)

    def loss_fn(params, batch, gen=None):
        return vision.conv_loss(params, batch, cfg, gen)

    @torch.no_grad()
    def forward(params, batch):
        return vision.conv_predict(params, batch["images"], cfg)

    return Model(cfg, dev, init, forward, loss_fn=loss_fn)


def _initializer(init_fn, cfg: ArchConfig, dev: torch.device):
    """``init(seed_or_generator=0)``: ``init_fn(gen, cfg, dev)`` with a
    generator on ``dev`` seeded from an int, or the one given."""
    def init(seed_or_generator=0):
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        with torch.no_grad():
            return init_fn(gen, cfg, dev)
    return init


def _build_encdec(cfg: ArchConfig, dev: torch.device) -> Model:
    cdt = dtype_of(cfg.dtype)

    def loss_fn(params, batch, gen=None, gather=None):
        del gen                 # the encoder-decoder draws no randomness
        if gather is not None:
            raise NotImplementedError(
                f"{cfg.name}: the encdec loss takes no layer-wise gather; "
                f"gspmd gathers its tree whole")
        return encdec.encdec_loss(cast_params(params, cdt), batch, cfg)

    @torch.no_grad()
    def forward(params, batch):
        p = cast_params(params, cdt)
        return encdec.decode_train(p, batch["tokens"],
                                   encdec.encode(p, batch["frames"], cfg),
                                   cfg)

    def init_cache(batch, max_len):
        return encdec.init_encdec_cache(cfg, batch, max_len, dev)

    @torch.no_grad()
    def decode_step(params, cache, batch, pos, seq_len):
        return encdec.encdec_decode_step(cast_params(params, cdt), cache,
                                         batch["tokens"], pos, cfg,
                                         seq_len=seq_len)

    @torch.no_grad()
    def prefill(params, frames, cache):
        return encdec.prefill_encoder(cast_params(params, cdt), frames, cfg,
                                      cache)

    return Model(cfg, dev, _initializer(encdec.init_encdec, cfg, dev),
                 forward, init_cache, decode_step, loss_fn=loss_fn,
                 prefill=prefill)


def build_model(cfg: ArchConfig, device=None) -> Model:
    dev = default_device(device)
    if cfg.family == "conv":
        return _build_conv(cfg, dev)
    if cfg.family == "encdec":
        return _build_encdec(cfg, dev)
    if cfg.family != "decoder":
        raise ValueError(f"unknown family {cfg.family!r}")
    cdt = dtype_of(cfg.dtype)
    init = _initializer(transformer.init_decoder, cfg, dev)

    def loss_fn(params, batch, gen=None, gather=None):
        del gen                 # decoders draw no randomness
        if gather is None:
            return transformer.decoder_loss(cast_params(params, cdt), batch,
                                            cfg)
        # sharded training: each gathered subtree is cast as it arrives
        return transformer.decoder_loss(
            params, batch, cfg, lambda t: cast_params(gather(t), cdt))

    @torch.no_grad()
    def forward(params, batch):
        return transformer.decoder_forward(cast_params(params, cdt), batch,
                                           cfg)[0]

    def init_cache(batch, max_len):
        return transformer.init_decoder_cache(cfg, batch, max_len, dev)

    def init_paged_cache(max_slots, page_size, num_pages):
        return transformer.init_paged_decoder_cache(cfg, max_slots, page_size,
                                                    num_pages, dev)

    @torch.no_grad()
    def decode_step(params, cache, batch, pos, seq_len, block_tables=None,
                    page_size=0):
        return transformer.decoder_decode_step(
            cast_params(params, cdt), cache, batch["tokens"], pos, cfg,
            seq_len=seq_len, block_tables=block_tables, page_size=page_size)

    @torch.no_grad()
    def chunk_prefill(params, cache, tokens, pos0, valid, *, seq_len,
                      block_tables=None, page_size=0):
        return transformer.decoder_prefill(
            cast_params(params, cdt), cache, tokens, pos0, valid, cfg,
            seq_len=seq_len, block_tables=block_tables, page_size=page_size)

    return Model(cfg, dev, init, forward, init_cache, decode_step,
                 chunk_prefill, init_paged_cache, loss_fn)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()
