"""VGGNet-19-ish (paper Table 2 reports VGG 'Depth 19', 138,357,544 params —
that parameter count is VGG-16's; we implement VGG-16 to match the count).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="vggnet",
    family="conv",
    conv_arch="vgg16",
    num_layers=16, d_model=0, d_ff=0, vocab_size=0,
    image_size=224, num_classes=1000,
    scan_layers=False,
    source="Theano-MPI paper Table 2 / arXiv:1409.1556",
)
