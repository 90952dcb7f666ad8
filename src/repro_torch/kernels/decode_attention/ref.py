"""Plain PyTorch version of decode attention (follows
`repro.kernels.decode_attention.ref.decode_attention_ref`, including the
rounding of the probabilities to v's dtype before the PV product)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[Union[int, torch.Tensor]] = None,
                         window: int = 0, softcap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); k/v (B, Hkv, S, D) → (B, Hq, D).  `kv_len` may be a
    0-d tensor; it is never read on the host."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    kv_len = S if kv_len is None else kv_len
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    # fp32 products of the storage-dtype operands, fp32 accumulation
    qf = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(S, device=q.device)
    mask = cols < kv_len
    if window > 0:
        mask = mask & (cols >= kv_len - window)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Hq, D).to(q.dtype)
