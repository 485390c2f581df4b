"""AlexNet — the paper's primary benchmark model (Table 2: 60,965,224 params).

[Krizhevsky et al. 2012; theano_alexnet reference implementation]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="alexnet",
    family="conv",
    conv_arch="alexnet",
    num_layers=8, d_model=0, d_ff=0, vocab_size=0,
    image_size=227, num_classes=1000,
    scan_layers=False,
    source="Theano-MPI paper Table 2 / NIPS2012",
)
