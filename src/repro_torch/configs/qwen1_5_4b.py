"""Qwen1.5-4B-class dense decoder with QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="decoder",
    num_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=20, num_kv_heads=20, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0),
    block="attn",
    source="hf:Qwen/Qwen1.5-0.5B (scaled family config per assignment)",
)
