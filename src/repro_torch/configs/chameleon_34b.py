"""Chameleon-34B early-fusion VLM (VQ image tokens).  [arXiv:2405.09818]

The VQ-VAE image tokenizer is a frontend STUB: ``input_specs()`` provides
precomputed image-token embeddings; this config is the fused decoder backbone.
Chameleon uses qk-norm for training stability.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="decoder",
    num_layers=48,
    d_model=8192,
    d_ff=22016,
    vocab_size=65536,
    attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                              qk_norm=True),
    block="attn",
    modality="vlm",
    num_image_tokens=1024,      # VQ tokens per image (32x32 grid)
    source="arXiv:2405.09818 (Chameleon)",
)
