"""Llama-4-Scout-17B-16E MoE with early fusion.  [hf:meta-llama/Llama-4-Scout-17B-16E]

16 routed experts top-1 + 1 shared expert; vision frontend STUB (early-fusion
patch embeddings via input_specs()).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="decoder",
    num_layers=48,
    d_model=5120,
    d_ff=16384,                  # dense interleaved-layer FFN
    vocab_size=202048,
    attention=AttentionConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    moe=MoEConfig(num_experts=16, top_k=1, expert_dim=8192,
                  num_shared_experts=1, shared_expert_dim=8192,
                  moe_every=1),  # Scout: every layer MoE (interleave step 1)
    block="attn",
    modality="vlm",
    num_image_tokens=1024,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
