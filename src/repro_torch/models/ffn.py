"""Gated-linear-unit FFN (GeGLU / SwiGLU), the port of `repro.models.ffn`:
the hidden activations carry the ``ffn_hidden`` sharding hint."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.sharding import hint
from .common import activate, dense


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, **kw))


def ffn_forward(p: FFN, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = activate(hint("ffn_hidden", dense(x, p.w_gate)), act)
    u = hint("ffn_hidden", dense(x, p.w_up))
    return dense(g * u, p.w_down)
