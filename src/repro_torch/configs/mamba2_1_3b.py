"""Mamba2-1.3B attention-free SSM (SSD / state-space duality).  [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="decoder",
    num_layers=48,
    d_model=2048,
    d_ff=0,                     # attention/MLP-free: SSD blocks only
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=128),
    block="ssm",
    long_context_window=0,       # natively sub-quadratic (O(1) decode state)
    source="arXiv:2405.21060 (Mamba-2 SSD)",
)
