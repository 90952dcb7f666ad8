"""In-stream accelerators (paper §2: 'an in-stream acceleration port enables
configurable in-flight operation on the data being transferred').

The RTL exposes a standardized byte-stream port inside the dataflow element
(Fig. 5 '⚡').  Here each accelerator is a pure function over the stream,
usable in two places:

1. the functional back-end (`core.backend.execute(instream=...)`), on
   NumPy byte arrays,
2. the copy kernel (`kernels/copy_engine`), on torch tensors: the CUDA
   kernel fuses `identity`, `zero`, `cast` and `scale` into its store;
   the plain version on the CPU takes any callable.

The element transforms take torch tensors or NumPy arrays; the int8
compression accelerators take torch tensors.  Same registry and names as
`repro.core.instream`.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no in-stream accelerator {name!r}; have {sorted(_REGISTRY)}"
        ) from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# Element transforms
# --------------------------------------------------------------------------

@register("identity")
def identity(x):
    return x


@register("cast")
def cast(x, dtype=torch.bfloat16):
    return x.to(dtype) if isinstance(x, torch.Tensor) else x.astype(dtype)


@register("scale")
def scale(x, factor=1.0):
    return x * factor


@register("zero")
def zero(x):
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) \
        else np.zeros_like(x)


@register("byteswap")
def byteswap(x):
    """Endianness swap — a classic DMA in-flight transform."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint8:
        return x.reshape(-1, 2)[:, ::-1].reshape(-1)
    raise TypeError("byteswap operates on uint8 byte streams")


@register("block_transpose")
def block_transpose(x, block: Tuple[int, int] = (8, 8)):
    """MT-DMA-style in-flight block transposition (paper Table 5,
    'Stream Modification Capability: Block Transp.'): each (r, r) block is
    transposed in place (square blocks ⇒ involution)."""
    r, c = block
    if r != c:
        raise ValueError("in-stream block transpose needs square blocks")
    if x.ndim != 2:
        raise ValueError("block_transpose expects a 2-D tile stream")
    R, C = x.shape
    if R % r or C % c:
        raise ValueError(f"tile {tuple(x.shape)} not divisible by block "
                         f"{block}")
    t = x.reshape(R // r, r, C // c, c)
    if isinstance(x, torch.Tensor):
        return t.permute(0, 3, 2, 1).reshape(R, C)
    return np.transpose(t, (0, 3, 2, 1)).reshape(R, C)


# --------------------------------------------------------------------------
# Quantization / compression — the gradient-compression accelerators
# --------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor, axis: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with per-tensor (or per-`axis`) scale."""
    absmax = x.abs().amax() if axis is None else \
        x.abs().amax(dim=axis, keepdim=True)
    scale_ = absmax.clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale_), -127, 127).to(torch.int8)
    return q, scale_.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale_: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale_


@register("compress_int8")
def compress_int8(x):
    return quantize_int8(x)


@register("decompress_int8")
def decompress_int8(pair):
    q, s = pair
    return dequantize_int8(q, s)


class ErrorFeedbackCompressor:
    """int8 gradient compression with error feedback (EF-SGD style).

    State: the residual of the previous quantization, added back before the
    next one — keeps compressed all-reduce unbiased over time.  Gradients
    are any pytree of tensors (`torch.utils._pytree`).
    """

    def init(self, grads):
        return pytree.tree_map(torch.zeros_like, grads)

    def compress(self, grads, residual):
        leaves_g, treedef = pytree.tree_flatten(grads)
        leaves_r = pytree.tree_leaves(residual)
        if len(leaves_r) != len(leaves_g):
            raise ValueError(f"residual has {len(leaves_r)} leaves, grads "
                             f"{len(leaves_g)}")
        qs, res = [], []
        for g, r in zip(leaves_g, leaves_r):
            g = g + r
            q, s = quantize_int8(g)
            qs.append((q, s))
            res.append(g - dequantize_int8(q, s))
        return (pytree.tree_unflatten(qs, treedef),
                pytree.tree_unflatten(res, treedef))

    @staticmethod
    def decompress(qs):
        return pytree.tree_map(
            lambda p: dequantize_int8(*p), qs,
            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2)


def chunk_pipeline(*names_and_kwargs) -> Callable:
    """Compose registered accelerators:
    chunk_pipeline(('cast', {...}), ...)."""
    fns = []
    for item in names_and_kwargs:
        if isinstance(item, str):
            fns.append(get(item))
        else:
            name, kw = item
            fns.append(functools.partial(get(name), **kw))

    def run(x):
        for f in fns:
            x = f(x)
        return x

    return run
