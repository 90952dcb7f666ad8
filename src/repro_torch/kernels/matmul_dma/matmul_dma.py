"""Wrapper of the hand-written CUDA matmul (`repro_torch/csrc/matmul_dma.cu`),
the port of the Pallas TPU kernel
`repro/kernels/matmul_dma/matmul_dma.py:matmul_pallas`.

x (M, K) @ w (K, N) with the sum in fp32 and an epilogue applied to the
fp32 sum before the one rounding to the output type, as the Pallas
kernel's `_retire` does.  x and w are float32 or bfloat16 (mixed types
too), each read through its two strides, so a transposed or sliced view
goes in without a copy; the output is a new row-major (M, N) tensor of
float32 or bfloat16.  M, N and K are arbitrary: every edge is masked,
K's included (the Pallas kernel sums the padded tail of a ragged last k
block in, see ROADMAP queue 3).

The card fuses a fixed set of epilogues (`FUSABLE`), recognised as
`copy_engine` recognises its in-stream transforms.  `check_matmul` holds
the kernel route's refusals and runs on any device, so the CPU tests
reach it; `tile_geometry` is the layout the kernel's tile loads take.
`launches` counts the kernel launches this wrapper has made.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import instream
from repro_torch.kernels import runtime

SOURCE = "matmul_dma"
launches = 0

#: the epilogues the kernel fuses, by name → its code in csrc/matmul_dma.cu
FUSABLE = {"none": 0, "relu": 1, "silu": 2, "gelu_tanh": 3, "scale": 4}


def check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    """The refusals both routes share: 2-D operands whose inner
    dimensions agree (the Pallas kernel's `ValueError`)."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"matmul expects 2-D operands, got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")


def fused_epilogue(epilogue: Optional[Callable]) -> Tuple[int, float]:
    """(code, factor) of an epilogue the kernel fuses: None, `torch.relu`
    or `F.relu`, `F.silu`, `F.gelu` with approximate="tanh" (as a
    `functools.partial`), or `instream.scale`, bare or as a
    `functools.partial` with `factor`.  Any other callable raises
    `ValueError`."""
    fn, kw = epilogue, {}
    if isinstance(epilogue, functools.partial) and not epilogue.args:
        fn, kw = epilogue.func, dict(epilogue.keywords)
    if epilogue is None:
        return FUSABLE["none"], 1.0
    if fn in (torch.relu, F.relu) and not kw:
        return FUSABLE["relu"], 1.0
    if fn is F.silu and not kw:
        return FUSABLE["silu"], 1.0
    if fn is F.gelu and kw == {"approximate": "tanh"}:
        return FUSABLE["gelu_tanh"], 1.0
    factor = kw.get("factor", 1.0)
    if fn is instream.scale and set(kw) <= {"factor"} and \
            isinstance(factor, (int, float)) and not isinstance(factor, bool):
        return FUSABLE["scale"], float(factor)
    raise ValueError(
        f"matmul on the card fuses only the epilogues none, relu "
        f"(torch.relu, F.relu), silu (F.silu), tanh-gelu "
        f"(functools.partial(F.gelu, approximate='tanh')) and scale "
        f"(instream.scale, bare or as a functools.partial with factor); "
        f"got {epilogue!r}")


def check_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                 epilogue: Optional[Callable] = None
                 ) -> Tuple[torch.dtype, int, float]:
    """The kernel route's refusals, before any launch → (output dtype,
    epilogue code, factor).  Shapes as `check_shapes`; an operand or
    output type other than float32 or bfloat16 raises `TypeError`;
    operands on two devices and an epilogue the kernel does not fuse
    raise `ValueError`."""
    check_shapes(x, w)
    out = out_dtype or x.dtype
    for what, dtype in (("x", x.dtype), ("w", w.dtype), ("output", out)):
        if dtype not in runtime.DTYPE_CODES:
            raise TypeError(f"matmul on the card takes float32 or bfloat16, "
                            f"got {what} {dtype}")
    if x.device != w.device:
        raise ValueError(f"matmul operands on two devices: {x.device} and "
                         f"{w.device}")
    code, factor = fused_epilogue(epilogue)
    return out, code, factor


def _operand(t: torch.Tensor, k_axis: int) -> Tuple[bool, bool]:
    """(k-major, 16-byte loads) of one operand's tile loads.  The tile
    is kept in shared memory along the operand's contiguous axis: along
    k when k's stride is 1 or the other axis's is not, else along the
    other axis.  Loads of eight elements at once need a bfloat16
    operand whose contiguous stride is 1, whose other stride is a
    multiple of 8 and whose base is 16-byte aligned."""
    other = 1 - k_axis
    k_major = t.stride(k_axis) == 1 or t.stride(other) != 1
    inner, outer = (k_axis, other) if k_major else (other, k_axis)
    vec = (t.dtype == torch.bfloat16 and t.stride(inner) == 1 and
           t.stride(outer) % 8 == 0 and t.data_ptr() % 16 == 0)
    return k_major, vec


def tile_geometry(x: torch.Tensor, w: torch.Tensor
                  ) -> Tuple[bool, bool, bool, bool]:
    """(x k-major, x vector loads, w k-major, w vector loads)."""
    return (*_operand(x, 1), *_operand(w, 0))


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    fn = lib.matmul_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [P, P, P, L, L, L, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, P]
        fn.restype = I
    return lib


def matmul_cuda(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                epilogue: Optional[Callable] = None) -> torch.Tensor:
    """`epilogue(x @ w)` into a new row-major (M, N) tensor of `out_dtype
    or x.dtype`; x and w are views on one CUDA device."""
    global launches
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"matmul_cuda takes tensors on a CUDA device, got "
                         f"{x.device} and {w.device}")
    out, code, factor = check_matmul(x, w, out_dtype, epilogue)
    (M, K), N = x.shape, w.shape[1]
    y = torch.empty((M, N), dtype=out, device=x.device)
    if y.numel() == 0:
        return y
    strides = (ctypes.c_int64 * 4)(*x.stride(), *w.stride())
    a_kmajor, a_vec, b_kmajor, b_vec = tile_geometry(x, w)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.matmul_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, strides,
            runtime.DTYPE_CODES[x.dtype], runtime.DTYPE_CODES[w.dtype],
            runtime.DTYPE_CODES[out], int(a_kmajor), int(a_vec),
            int(b_kmajor), int(b_vec), code, factor,
            torch.cuda.current_stream(x.device).cuda_stream)
    runtime.check(lib, err, "matmul")
    launches += 1
    return y
