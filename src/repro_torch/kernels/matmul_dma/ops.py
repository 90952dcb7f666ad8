"""Public matmul op: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import matmul_dma, ref


def matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
           epilogue: Optional[Callable] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) → (M, N) in `out_dtype or x.dtype`, summed in
    fp32, with `epilogue` applied to the fp32 sum before the one rounding
    to the output type.

    On the card x and w are float32 or bfloat16 views with any strides,
    and `epilogue` is one the kernel fuses (`matmul_dma.FUSABLE`); on the
    CPU they take any dtype and any callable.  The reference's `block`,
    `backend` and `interpret` are gone: the tile geometry is the kernel's
    own."""
    if x.device.type == "cuda":
        return matmul_dma.matmul_cuda(x, w, out_dtype, epilogue)
    if x.device.type == "cpu":
        matmul_dma.check_shapes(x, w)
        return ref.matmul_ref(x, w, out_dtype, epilogue)
    raise ValueError(f"no matmul for device {x.device}")
