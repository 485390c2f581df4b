"""`repro_torch.roofline` — the card's peaks and a cost model of the port's
programs (counterpart of ``repro.roofline``)."""
from repro_torch.roofline.analysis import (CostMode, Roofline, analyze,
                                           attention_flops_bytes,
                                           count_cost, model_flops_6nd,
                                           peaks)

__all__ = ["CostMode", "Roofline", "analyze", "attention_flops_bytes",
           "count_cost", "model_flops_6nd", "peaks"]
