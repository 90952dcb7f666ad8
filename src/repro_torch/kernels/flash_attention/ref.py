"""Plain PyTorch version: naive attention with GQA / causal / SWA / softcap
(follows `repro.kernels.flash_attention.ref.attention_ref`)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → (B, Hq, Sq, D).

    `q_offset` — absolute position of q[0] (decode: Sk - Sq).
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)

    rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)
