"""GoogLeNet (Inception v1) with both auxiliary classifiers
(paper Table 2: 13,378,280 params including aux classifiers).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="googlenet",
    family="conv",
    conv_arch="googlenet",
    num_layers=22, d_model=0, d_ff=0, vocab_size=0,
    image_size=224, num_classes=1000,
    scan_layers=False,
    source="Theano-MPI paper Table 2 / arXiv:1409.4842",
)
