"""The distribution layer's placement rules (counterpart of
``repro/dist``): ``sharding`` holds the parameter rule table, the spec
sanitizer and the FSDP rule that ``core/gspmd.py`` shards by."""
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (MODEL_AXIS, Mesh, data_mesh,
                                       dp_axes_of, dp_size_of, fsdp_dim,
                                       fsdp_param_spec, param_spec,
                                       sanitize_spec)

__all__ = ["MODEL_AXIS", "Mesh", "data_mesh", "dp_axes_of", "dp_size_of",
           "fsdp_dim", "fsdp_param_spec", "param_spec", "sanitize_spec",
           "sharding"]
