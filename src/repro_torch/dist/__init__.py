"""The distribution layer (counterpart of ``repro/dist``): the placement
rules (``sharding``: the parameter rule table, the spec sanitizer, the
FSDP rule and the tree builders) and the sequence-parallel activation
constraints (``act``)."""
from repro_torch.dist import act, sharding
from repro_torch.dist.sharding import (MODEL_AXIS, Mesh, batch_shardings,
                                       cache_shardings, data_mesh,
                                       dp_axes_of, dp_size_of, fsdp_dim,
                                       fsdp_param_spec, fsdp_state_shardings,
                                       local_shape, param_shardings,
                                       param_spec, placements, sanitize_spec,
                                       set_replicate_attn, state_shardings)

__all__ = ["MODEL_AXIS", "Mesh", "act", "batch_shardings",
           "cache_shardings", "data_mesh", "dp_axes_of", "dp_size_of",
           "fsdp_dim", "fsdp_param_spec", "fsdp_state_shardings",
           "local_shape", "param_shardings", "param_spec", "placements",
           "sanitize_spec", "set_replicate_attn", "sharding",
           "state_shardings"]
