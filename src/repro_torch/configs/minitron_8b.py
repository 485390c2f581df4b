"""Minitron-8B pruned Nemotron dense decoder.  [arXiv:2407.14679]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="decoder",
    num_layers=32,
    d_model=4096,
    d_ff=16384,
    vocab_size=256000,
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128),
    block="attn",
    source="arXiv:2407.14679 (Minitron pruned Nemotron-4)",
)
