"""Public SSD op: the CUDA kernel for tensors on the card, the chunked
plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from . import ssd as ssd_kernel
from .ref import ssd_chunked_ref


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, chunk: int = 128,
        return_state: bool = False):
    """x (B, H, S, P), dt (B, H, S), A/D (H,), B/C (B, G, S, N) → y
    (B, H, S, P) [, final state (B, H, N, P) fp32].  S must be a multiple
    of `chunk` (the caller pads with zero dt)."""
    S, H, G = x.shape[2], x.shape[1], B.shape[1]
    if S % chunk:
        raise ValueError(f"seq {S} not a multiple of chunk {chunk}")
    if H % G:
        raise ValueError(f"heads {H} not a multiple of groups {G}")
    if x.device.type == "cuda":
        y, state = ssd_kernel.ssd_cuda(x, dt, A, D, B, C, chunk=chunk)
        return (y, state) if return_state else y
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, D, B, C, chunk=chunk,
                               return_state=return_state)
    raise ValueError(f"no SSD scan for device {x.device}")
