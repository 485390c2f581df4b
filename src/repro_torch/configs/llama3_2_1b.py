"""Llama-3.2-1B small llama3 dense decoder.  [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="decoder",
    num_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=128256,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=8, head_dim=64, rope_theta=500_000.0),
    block="attn",
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
