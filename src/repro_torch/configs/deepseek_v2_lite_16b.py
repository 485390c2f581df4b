"""DeepSeek-V2-Lite-16B: MLA attention + fine-grained MoE.  [arXiv:2405.04434]

MLA: kv_lora_rank=512, qk_rope=64, qk_nope=128, v_head=128, 16 heads.
MoE: 64 routed experts top-6 + 2 shared, expert_dim=1408, first layer dense.
(The assignment note "160 routed" belongs to DeepSeek-V2-236B; the V2-Lite
column of arXiv:2405.04434 Table 1 is 64 routed / 2 shared, which we follow —
consistent with the primary "MoE 64e top-6" assignment spec.)
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="decoder",
    num_layers=27,
    d_model=2048,
    d_ff=10944,                  # dense-layer FFN (first_k_dense)
    vocab_size=102400,
    attention=AttentionConfig(
        num_heads=16, num_kv_heads=16, head_dim=192,  # = nope+rope
        kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, expert_dim=1408,
                  num_shared_experts=2, shared_expert_dim=2816,
                  first_k_dense=1),
    block="attn",
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
)
