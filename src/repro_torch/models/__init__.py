from repro_torch.models.registry import (Model, build_model, cast_params,
                                         count_params)
