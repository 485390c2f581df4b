"""Hymba-1.5B hybrid-head (parallel attention ∥ mamba) decoder.  [arXiv:2411.13676]

Each block runs attention heads and SSM heads IN PARALLEL on the same input
and fuses normalized outputs. 128 learnable meta tokens are prepended; most
layers use sliding-window attention, every 16th (plus first/last) is global.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="decoder",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    attention=AttentionConfig(num_heads=25, num_kv_heads=5, head_dim=64,
                              sliding_window=1024),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, chunk=128),
    block="hybrid",
    num_meta_tokens=128,
    global_attn_every=16,
    long_context_window=0,       # natively sub-quadratic (sw + O(1) ssm)
    source="arXiv:2411.13676 (Hymba)",
)
