"""Plain PyTorch versions of the Init pseudo-protocol generators (the
port of `repro/kernels/init_engine/ref.py`).  The CUDA kernels of
`csrc/init_engine.cu` are held bit for bit against them.

`torch.uint32` has no add or shift on the CPU, so splitmix32 runs on
int64 words masked to 32 bits, and only the result becomes uint32.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Device = Union[str, torch.device]
MASK32 = 0xFFFFFFFF


def fill_value(value, dtype: torch.dtype):
    """`value` as `jnp.full` casts it into `dtype`, where `torch.full`
    would raise: floats truncate toward zero into an integer dtype (2.5
    gives 2), integers wrap to its width (300 gives 44 in int8), and a
    float too large for a narrow float type becomes inf.  (A float out of
    an integer type's range has no defined cast and is not matched.)"""
    if dtype == torch.bool:
        return bool(value)
    if dtype.is_floating_point:
        return torch.tensor(value, dtype=torch.float64).to(dtype).item()
    info = torch.iinfo(dtype)
    span = 1 << info.bits
    v = int(value) % span
    return v - span if info.min < 0 and v > info.max else v


def memset_ref(shape: Tuple[int, int], value, dtype=torch.float32,
               device: Device = "cpu") -> torch.Tensor:
    return torch.full(shape, fill_value(value, dtype), dtype=dtype,
                      device=device)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    return (((v & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def iota_fill_ref(shape: Tuple[int, int], start: int = 0,
                  dtype=torch.int32, device: Device = "cpu") -> torch.Tensor:
    n = shape[0] * shape[1]
    flat = torch.arange(n, dtype=torch.int64, device=device) + start
    return _wrap_int32(flat).to(dtype).reshape(shape)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2^32 for 0 ≤ a, c < 2^32, in int64 without overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 (`repro_torch.core.backend.splitmix32`) on int64 words
    in [0, 2^32)."""
    x = (x + 0x9E3779B9) & MASK32
    z = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def _bits64(shape: Tuple[int, int], seed: int, device: Device
            ) -> torch.Tensor:
    n = shape[0] * shape[1]
    ctr = (torch.arange(n, dtype=torch.int64, device=device)
           + (seed & MASK32)) & MASK32
    return splitmix32(ctr).reshape(shape)


def prng_bits_ref(shape: Tuple[int, int], seed: int = 0,
                  device: Device = "cpu") -> torch.Tensor:
    return _bits64(shape, seed, device).to(torch.uint32)


def prng_fill_ref(shape: Tuple[int, int], seed: int = 0,
                  dtype=torch.float32, device: Device = "cpu"
                  ) -> torch.Tensor:
    bits = _bits64(shape, seed, device)
    if dtype == torch.uint32:
        return bits.to(torch.uint32)
    if dtype == torch.int8:
        return (bits & 0xFF).to(torch.uint8).view(torch.int8)
    u = (bits >> 8).to(torch.float32) / float(1 << 24)
    return u.to(dtype)
