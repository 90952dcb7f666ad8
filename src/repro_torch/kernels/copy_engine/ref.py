"""Plain PyTorch versions of the copy engine (the port of
`repro/kernels/copy_engine/ref.py`).  The CUDA kernels of
`csrc/copy_engine.cu` are held bit for bit against them."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def copy_2d_ref(x: torch.Tensor, transform: Optional[Callable] = None,
                out_dtype=None) -> torch.Tensor:
    """`transform(x)` cast to `out_dtype or x.dtype`, as a new row-major
    tensor.  Unlike the Pallas kernel, which refuses a store whose dtype
    differs from the output's, this casts (as the reference's ref.py
    does)."""
    out = x if transform is None else transform(x)
    return out.to(out_dtype or x.dtype, copy=True,
                  memory_format=torch.contiguous_format)


#: signed integer types by itemsize: the gather moves raw elements, as
#: the kernel does, and torch indexes no unsigned or bool type on the card
RAW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def strided_copy_nd_ref(x: torch.Tensor) -> torch.Tensor:
    """Materialise any view of a tensor, contiguous or not, by gathering
    its elements from the flat storage at storage_offset + Σ index·stride.
    A 0-D or 1-D input comes back 2-D, (1, 1) or (1, n), as from the
    Pallas kernel."""
    if x.ndim < 2:
        x = x.reshape((1,) * (2 - x.ndim) + tuple(x.shape))
    n_storage = x.untyped_storage().nbytes() // x.element_size()
    flat = x.as_strided((n_storage,), (1,), 0).view(RAW[x.element_size()])
    index = torch.full((), x.storage_offset(), dtype=torch.int64,
                       device=x.device)
    for d, (size, stride) in enumerate(zip(x.shape, x.stride())):
        view = [1] * x.ndim
        view[d] = size
        index = index + torch.arange(size, device=x.device).view(view) \
            * stride
    return flat[index].view(x.dtype)
