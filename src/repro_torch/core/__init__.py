"""The paper's training core on torch.distributed: exchangers and BSP."""
from repro_torch.core.bsp import (PhaseTimer, init_sharded_train_state,
                                  init_train_state, make_bsp_step)
from repro_torch.core.exchanger import (EXCHANGERS, BucketSpec, Exchanger,
                                        RSPlan, Transport, get_exchanger,
                                        make_rs_plan, param_wire_dtype,
                                        wire_summary)

__all__ = ["PhaseTimer", "init_sharded_train_state", "init_train_state",
           "make_bsp_step", "EXCHANGERS", "BucketSpec", "Exchanger", "RSPlan",
           "Transport", "get_exchanger", "make_rs_plan", "param_wire_dtype",
           "wire_summary"]
