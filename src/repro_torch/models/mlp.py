"""SwiGLU MLP (dense FFN)."""
from __future__ import annotations

import torch

from repro_torch.models import tp
from repro_torch.models.common import dense_init


def init_mlp(gen, d_model: int, d_ff: int, dtype, device=None):
    return {
        "wi": dense_init(gen, d_model, (d_ff,), dtype, device),   # gate
        "wu": dense_init(gen, d_model, (d_ff,), dtype, device),   # up
        "wd": dense_init(gen, d_ff, (d_model,), dtype, device),   # down
    }


def mlp_forward(p, x):
    x = tp.column_input(x, p["wi"])
    g = torch.einsum("bsd,df->bsf", x, p["wi"])
    u = torch.einsum("bsd,df->bsf", x, p["wu"])
    return torch.einsum("bsf,fd->bsd", torch.nn.functional.silu(g) * u,
                        p["wd"])
