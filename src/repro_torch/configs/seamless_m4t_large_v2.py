"""SeamlessM4T-Large-v2 encoder-decoder multimodal backbone.  [arXiv:2308.11596]

The speech frontend (mel-spectrogram + conformer feature extractor) is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, T_src, d_model).
This config is the text/unit transformer backbone (24L enc + 24L dec).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,               # decoder layers
    num_encoder_layers=24,
    encoder_seq_len=4096,        # stub frame count for full-size lowering
    d_model=1024,
    d_ff=8192,
    vocab_size=256206,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64),
    block="attn",
    modality="audio",
    source="arXiv:2308.11596 (SeamlessM4T v2)",
)
