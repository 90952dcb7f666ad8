"""Gated-linear-unit FFN (GeGLU / SwiGLU), the port of `repro.models.ffn`:
the hidden activations carry the ``ffn_hidden`` sharding hint."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.dist.sharding import hint
from .common import activate, dense


class FFN(nn.Module):
    """`dtype` is the compute dtype; the weights are stored in
    `param_dtype` (`dtype` when None)."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device,
                 param_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=param_dtype or dtype, device=device)
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, **kw))


def ffn_forward(p: FFN, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = activate(hint("ffn_hidden", dense(x, p.w_gate, dtype=p.dtype)), act)
    u = hint("ffn_hidden", dense(x, p.w_up, dtype=p.dtype))
    return dense(g * u, p.w_down, dtype=p.dtype)
