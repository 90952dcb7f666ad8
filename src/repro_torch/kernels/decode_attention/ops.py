"""Public decode attention op: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import decode_attention as da
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[Union[int, torch.Tensor]] = None,
                     window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); k/v (B, Hkv, S, D) → (B, Hq, D)."""
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if q.device.type == "cuda":
        return da.decode_attention_cuda(q, k, v, kv_len=kv_len,
                                        window=window, softcap=softcap,
                                        scale=scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len=kv_len, window=window,
                                    softcap=softcap, scale=scale)
    raise ValueError(f"no decode attention for device {q.device}")
