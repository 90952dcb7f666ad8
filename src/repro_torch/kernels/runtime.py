"""Device choice and the build-and-load helper for the CUDA kernels.

Each kernel is one source under `repro_torch/csrc/` with a plain C
interface.  At first use it is compiled with `nvcc` for `sm_90a` into a
shared library under `build/repro_torch/` at the root of the checkout,
named by a hash of its source and of every header beside it
(`csrc/*.cuh`), so an edited source or header is rebuilt, and loaded
with `ctypes`.  A failed build, load or launch raises; nothing falls back
to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Union

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """`None` means the card.  Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (`nvcc`, `cuobjdump`)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found on PATH or under CUDA_HOME")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current library.  One
    `nvcc` per source, all started together, so the build of N kernels
    takes about as long as the slowest one."""
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for name, tmp, out, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)   # atomic: a concurrent loader sees all
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a launch."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte-aligned base for vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}") \
            from None
