"""Plain PyTorch version of the blocked matmul (the port of
`repro/kernels/matmul_dma/ref.py`).  The CUDA kernel of
`csrc/matmul_dma.cu` is held against it."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
               epilogue: Optional[Callable] = None) -> torch.Tensor:
    """`epilogue(x @ w)` with the sum in fp32, cast to `out_dtype or
    x.dtype`.  The operands are upcast first: products of bf16 values are
    exact in fp32, so this is the reference's `jnp.dot(...,
    preferred_element_type=float32)`.  `epilogue` is any callable."""
    acc = x.float() @ w.float()
    if epilogue is not None:
        acc = epilogue(acc)
    return acc.to(out_dtype or x.dtype)
