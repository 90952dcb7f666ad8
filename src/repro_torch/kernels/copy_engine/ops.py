"""Public copy ops: the CUDA kernels for tensors on the card, the plain
versions for tensors on the CPU."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import copy_engine, ref


def copy_2d(x: torch.Tensor, transform: Optional[Callable] = None,
            out_dtype=None) -> torch.Tensor:
    """Copy (and optionally transform) a 2-D tensor into a new row-major
    one.  On the card `transform` is one of the in-stream transforms the
    kernel fuses (`copy_engine.FUSABLE`) and must give `out_dtype or
    x.dtype`; on the CPU it is any shape-preserving callable and its
    output is cast."""
    if x.device.type == "cuda":
        return copy_engine.copy_2d_cuda(x, transform, out_dtype)
    if x.device.type == "cpu":
        return ref.copy_2d_ref(x, transform, out_dtype)
    raise ValueError(f"no copy_2d for device {x.device}")


def strided_copy_nd(x: torch.Tensor) -> torch.Tensor:
    """Materialise a (possibly non-contiguous) view as a new contiguous
    tensor; a 0-D or 1-D input comes back 2-D."""
    if x.device.type == "cuda":
        return copy_engine.strided_copy_nd_cuda(x)
    if x.device.type == "cpu":
        return ref.strided_copy_nd_ref(x)
    raise ValueError(f"no strided_copy_nd for device {x.device}")
