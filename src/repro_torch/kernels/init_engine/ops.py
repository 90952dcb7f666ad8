"""Public Init generators: the CUDA kernels on the card, the plain
versions on the CPU.  They have no input tensor, so `device` chooses:
`None` is the card (`runtime.resolve_device`), which raises where there
is none; the tests pass `device="cpu"`."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.runtime import resolve_device

from . import init_engine, ref


def memset(shape: Tuple[int, int], value=0.0, dtype=torch.float32,
           device=None) -> torch.Tensor:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return init_engine.memset_cuda(shape, value, dtype, dev)
    if dev.type == "cpu":
        return ref.memset_ref(shape, value, dtype, dev)
    raise ValueError(f"no memset for device {dev}")


def iota_fill(shape: Tuple[int, int], start: int = 0, dtype=torch.int32,
              device=None) -> torch.Tensor:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return init_engine.iota_fill_cuda(shape, start, dtype, dev)
    if dev.type == "cpu":
        return ref.iota_fill_ref(shape, start, dtype, dev)
    raise ValueError(f"no iota fill for device {dev}")


def prng_fill(shape: Tuple[int, int], seed: int = 0, dtype=torch.float32,
              device=None) -> torch.Tensor:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return init_engine.prng_fill_cuda(shape, seed, dtype, dev)
    if dev.type == "cpu":
        return ref.prng_fill_ref(shape, seed, dtype, dev)
    raise ValueError(f"no prng fill for device {dev}")
