"""Config system: architecture configs, input shapes, CLI overrides.

Every assigned architecture gets one ``<arch>.py`` exporting ``CONFIG``; the
registry resolves ``--arch <id>`` and can derive a reduced smoke variant.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any


# ---------------------------------------------------------------------------
# Input shapes (assigned): name -> (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Layer / block descriptors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    # MLA (DeepSeek-V2): latent KV compression. 0 disables.
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0   # rope sub-dim for MLA (k_rope shared across heads)
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # sliding window; 0 = full/causal attention
    sliding_window: int = 0
    rope_theta: float = 10_000.0
    # blockwise (flash-style) attention KV block size; 0 = naive attention
    # (the paper-baseline). Enabled per-experiment in §Perf hillclimbs.
    block_kv: int = 0
    # unroll the KV-block scan (dry-run costing: scan bodies are counted
    # once by XLA, so unrolling keeps the roofline honest)
    block_unroll: bool = False
    # attention implementation: "" / "auto" (= "flash") | "flash" (the
    # hand-written CUDA kernels; their plain versions on CPU tensors) |
    # "ref" (einsum oracles). The REPRO_ATTN_IMPL env var overrides; see
    # models/attention.py.
    attn_impl: str = ""


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_dim: int               # d_ff per expert
    num_shared_experts: int = 0
    shared_expert_dim: int = 0    # d_ff of the fused shared expert(s)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # layers that stay dense (e.g. deepseek first layer); dense layers use
    # ``ArchConfig.d_ff`` as their hidden size.
    first_k_dense: int = 0
    moe_every: int = 1            # apply MoE every Nth layer (1 = all)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int                # N (ssm_state)
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 128              # SSD chunk length
    conv_width: int = 4
    ngroups: int = 1


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. ``family`` picks the executor:

    - "decoder":  decoder-only transformer (dense / moe / ssm / hybrid blocks)
    - "encdec":   encoder-decoder transformer
    - "conv":     image classification convnet (paper's own models)
    """
    name: str
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # block layout: "attn" (dense), "ssm" (mamba), "hybrid" (attn ∥ ssm)
    block: str = "attn"
    # modality stub: "text" | "vlm" | "audio"  (vlm/audio consume precomputed
    # frontend embeddings through input_specs())
    modality: str = "text"
    num_meta_tokens: int = 0      # hymba learnable prefix tokens
    # hybrid: every Nth layer uses full attention, rest sliding window
    global_attn_every: int = 0
    # encdec
    num_encoder_layers: int = 0
    encoder_seq_len: int = 2048   # stub-frontend frame count for enc-dec
    # vlm: fraction of the sequence that is image-patch embeddings
    num_image_tokens: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"
    # conv family
    conv_arch: str = ""           # "alexnet" | "vgg16" | "googlenet"
    image_size: int = 224
    num_classes: int = 1000
    # long-context variant: window applied to full-attention layers when the
    # input shape is long_500k (sub-quadratic requirement). 0 = arch is
    # natively sub-quadratic (ssm) or must skip.
    long_context_window: int = 8192
    # provenance
    source: str = ""
    remat: bool = True
    scan_layers: bool = True

    # -- derived -----------------------------------------------------------
    def head_dim(self) -> int:
        a = self.attention
        if a is None:
            return 0
        return a.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        total += d  # final norm
        per_layer = 0
        a = self.attention
        if self.family in ("decoder", "encdec") and self.block in ("attn", "hybrid") and a:
            if a.kv_lora_rank:  # MLA
                qd = a.num_heads * (a.qk_nope_dim + a.qk_rope_dim)
                per_layer += d * qd
                per_layer += d * (a.kv_lora_rank + a.qk_rope_dim)
                per_layer += a.kv_lora_rank * a.num_heads * (a.qk_nope_dim + a.v_head_dim)
                per_layer += a.num_heads * a.v_head_dim * d
            else:
                per_layer += d * a.num_heads * a.head_dim  # q
                per_layer += 2 * d * a.num_kv_heads * a.head_dim  # k,v
                per_layer += a.num_heads * a.head_dim * d  # o
                if a.qkv_bias:
                    per_layer += (a.num_heads + 2 * a.num_kv_heads) * a.head_dim
        if self.block in ("ssm", "hybrid") and self.ssm:
            s = self.ssm
            d_inner = s.expand * d
            nheads = d_inner // s.head_dim
            per_layer += d * (2 * d_inner + 2 * s.ngroups * s.state_dim + nheads)
            per_layer += d_inner * d  # out proj
            per_layer += s.conv_width * (d_inner + 2 * s.ngroups * s.state_dim)
            per_layer += 2 * nheads  # A, D
        if self.moe:
            m = self.moe
            n_moe = max(0, (L - m.first_k_dense + m.moe_every - 1) // m.moe_every)
            n_dense = L - n_moe
            per_layer = per_layer  # attention handled above
            moe_ffn = m.num_experts * 3 * d * m.expert_dim + d * m.num_experts
            if m.num_shared_experts:
                moe_ffn += 3 * d * m.shared_expert_dim
            total += n_moe * moe_ffn + n_dense * 3 * d * self.d_ff
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff  # SwiGLU
        per_layer += 2 * d  # norms
        total += L * per_layer
        if self.family == "encdec":
            # encoder layers: self-attn + ffn; decoder already counted has
            # cross-attn extra
            enc_layer = 0
            if a:
                enc_layer += 2 * (d * a.num_heads * a.head_dim + 2 * d * a.num_kv_heads * a.head_dim + a.num_heads * a.head_dim * d) // 2
            enc_layer += 3 * d * self.d_ff + 2 * d
            total += self.num_encoder_layers * enc_layer
            # cross attention in decoder
            if a:
                total += L * (d * a.num_heads * a.head_dim + 2 * d * a.num_kv_heads * a.head_dim + a.num_heads * a.head_dim * d + d)
        return total

    def active_param_count(self) -> int:
        """Parameters activated per token (MoE top-k)."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.num_layers
        n_moe = max(0, (L - m.first_k_dense + m.moe_every - 1) // m.moe_every)
        inactive = n_moe * (m.num_experts - m.top_k) * 3 * d * m.expert_dim
        return self.param_count() - inactive

    def with_overrides(self, **kw: Any) -> "ArchConfig":
        return replace(self, **kw)


def with_attn_impl(cfg: ArchConfig, impl: str | None) -> ArchConfig:
    """Pin the attention implementation on a config (the ``--attn-impl``
    CLI knob and ``Engine(attn_impl=...)`` both route through here).
    No-op when ``impl`` is falsy or the arch has no attention block
    (pure-SSM families), so a global flag can sweep every arch."""
    if not impl or cfg.attention is None:
        return cfg
    return replace(cfg, attention=replace(cfg.attention, attn_impl=impl))


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: 2 layers, d_model<=512, <=4 experts, small vocab."""
    d = min(cfg.d_model, 256)
    kw: dict[str, Any] = dict(
        num_layers=2,
        d_model=d,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 64),
        num_image_tokens=min(cfg.num_image_tokens, 16),
        num_meta_tokens=min(cfg.num_meta_tokens, 8),
        scan_layers=False,
        remat=False,
    )
    if cfg.attention is not None:
        a = cfg.attention
        heads = min(a.num_heads, 4)
        kvh = max(1, min(a.num_kv_heads, heads))
        hd = 32
        kw["attention"] = replace(
            a, num_heads=heads, num_kv_heads=kvh, head_dim=hd,
            kv_lora_rank=64 if a.kv_lora_rank else 0,
            qk_rope_dim=16 if a.kv_lora_rank else 0,
            qk_nope_dim=16 if a.kv_lora_rank else 0,
            v_head_dim=hd if a.kv_lora_rank else 0,
            sliding_window=min(a.sliding_window, 32) if a.sliding_window else 0,
        )
    if cfg.moe is not None:
        m = cfg.moe
        kw["moe"] = replace(
            m, num_experts=4, top_k=min(m.top_k, 2),
            expert_dim=128,
            num_shared_experts=min(m.num_shared_experts, 1),
            shared_expert_dim=128 if m.num_shared_experts else 0,
            first_k_dense=min(m.first_k_dense, 1),
        )
    if cfg.ssm is not None:
        s = cfg.ssm
        kw["ssm"] = replace(s, state_dim=min(s.state_dim, 16), head_dim=32,
                            chunk=16)
    if cfg.family == "conv":
        kw = dict(num_layers=cfg.num_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
                  vocab_size=cfg.vocab_size, image_size=96, num_classes=16,
                  scan_layers=False, remat=False)
    return replace(cfg, **kw)
