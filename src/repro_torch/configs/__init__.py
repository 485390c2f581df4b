from repro_torch.configs.base import (ArchConfig, AttentionConfig, MoEConfig,
                                SSMConfig, InputShape, INPUT_SHAPES, reduced)
from repro_torch.configs.registry import (get_config, get_smoke_config, get_shape,
                                    list_archs, ASSIGNED_ARCHS, PAPER_ARCHS)
