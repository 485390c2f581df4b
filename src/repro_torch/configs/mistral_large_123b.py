"""Mistral-Large-123B dense decoder.  [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="decoder",
    num_layers=88,
    d_model=12288,
    d_ff=28672,
    vocab_size=32768,
    attention=AttentionConfig(num_heads=96, num_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0),
    block="attn",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
