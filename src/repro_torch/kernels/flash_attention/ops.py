"""Public flash attention op: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as fa
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → (B, Hq, Sq, D)."""
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if q.device.type == "cuda":
        return fa.flash_attention_cuda(q, k, v, causal=causal,
                                       window=window, softcap=softcap,
                                       scale=scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")
