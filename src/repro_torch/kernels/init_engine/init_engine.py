"""Wrapper of the hand-written CUDA Init generators
(`repro_torch/csrc/init_engine.cu`), the port of the Pallas TPU kernels
`repro/kernels/init_engine/init_engine.py`: `memset_pallas`,
`iota_fill_pallas` and `prng_fill_pallas`.

'The Init pseudo-protocol only provides a read manager emitting a
configurable stream of either the same repeated value, incrementing
values, or a pseudorandom sequence' (paper Table 3).  Each generator
writes a fresh contiguous (rows, cols) tensor on the card and reads
nothing.  The pseudorandom stream is the functional back-end's splitmix32
(`repro_torch.core.backend.splitmix32`), so the engine's Init bytes and
the kernel's agree.

`check_fill` holds the Pallas kernels' host-side refusals; it runs on any
device, so the CPU tests reach it.  `memset_launches`,
`iota_fill_launches` and `prng_fill_launches` count this module's kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.engine import plan_nd_copy
from repro_torch.kernels import runtime

from .ref import MASK32, fill_value

SOURCE = "init_engine"
memset_launches = 0
iota_fill_launches = 0
prng_fill_launches = 0

# csrc/init_engine.cu's output kinds
IOTA_KINDS = {torch.int8: 0, torch.uint8: 0, torch.int16: 1,
              torch.uint16: 1, torch.int32: 2, torch.uint32: 2,
              torch.bool: 3, torch.float32: 4, torch.bfloat16: 5,
              torch.float16: 6}
PRNG_KINDS = {torch.uint32: 0, torch.float32: 1, torch.bfloat16: 2,
              torch.int8: 3}


def check_fill(shape, dtype: torch.dtype, generator: str = "memset"
               ) -> Tuple[int, int]:
    """The refusals of the Pallas generators, in their order: the shape
    unpacks into (rows, cols) and `plan_nd_copy` takes the dtype's
    itemsize (`ValueError`, e.g. "unsupported itemsize 8"); then the prng
    kernel takes uint32, float32, bfloat16 and int8 only
    (`NotImplementedError`).  The iota kernel converts to the dtypes of
    `IOTA_KINDS`; the Pallas one takes any 1-, 2- or 4-byte dtype, so
    another (a float8) raises `NotImplementedError` here."""
    rows, cols = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan_nd_copy((rows, cols), itemsize)
    if generator == "prng" and dtype not in PRNG_KINDS:
        raise NotImplementedError(f"prng fill for {dtype}")
    if generator == "iota" and dtype not in IOTA_KINDS:
        raise NotImplementedError(f"iota fill for {dtype}")
    return rows, cols


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    if lib.init_memset.argtypes is None:
        P, I, L, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint32)
        lib.init_memset.argtypes = [P, L, I, U, P]
        lib.init_iota.argtypes = [P, L, I, U, I, P]
        lib.init_prng.argtypes = [P, L, I, U, I, P]
        for fn in (lib.init_memset, lib.init_iota, lib.init_prng):
            fn.restype = I
    return lib


def _out(shape, dtype, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the Init kernels write to a CUDA device, got "
                         f"{device}")
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _launch(name: str, out: torch.Tensor, word: int, *kind) -> bool:
    """Run `init_<name>` on `out`; False when there is nothing to fill."""
    if out.numel() == 0:
        return False
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, f"init_{name}")(
            out.data_ptr(), out.numel(), out.element_size(), word & MASK32,
            *kind, stream)
    runtime.check(lib, err, f"init_{name}")
    return True


def memset_cuda(shape: Tuple[int, int], value, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """(rows, cols) of `value` cast into `dtype` as `jnp.full` does; the
    card writes its bytes and never converts."""
    global memset_launches
    check_fill(shape, dtype)
    out = _out(shape, dtype, device)
    raw = torch.tensor([fill_value(value, dtype)], dtype=dtype) \
        .view(torch.uint8).tolist()
    word = int.from_bytes(bytes(raw * (4 // len(raw))), "little")
    if _launch("memset", out, word):
        memset_launches += 1
    return out


def iota_fill_cuda(shape: Tuple[int, int], start: int = 0,
                   dtype=torch.int32, device="cuda") -> torch.Tensor:
    """start + row·cols + col, in wrapping int32, converted to `dtype`."""
    global iota_fill_launches
    check_fill(shape, dtype, "iota")
    out = _out(shape, dtype, device)
    if _launch("iota", out, start, IOTA_KINDS[dtype]):
        iota_fill_launches += 1
    return out


def prng_fill_cuda(shape: Tuple[int, int], seed: int = 0,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
    """splitmix32(flat index + seed): uint32 bits, a uniform [0, 1) float
    from the top 24 bits, or the low byte as int8."""
    global prng_fill_launches
    check_fill(shape, dtype, "prng")
    out = _out(shape, dtype, device)
    if _launch("prng", out, seed, PRNG_KINDS[dtype]):
        prng_fill_launches += 1
    return out
