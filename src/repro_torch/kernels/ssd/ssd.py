"""Wrapper of the hand-written CUDA SSD kernel (`repro_torch/csrc/ssd.cu`),
the port of the Pallas TPU kernel `repro/kernels/ssd/ssd.py:ssd_pallas`.

Mamba-2's chunked scan: one block per (batch, head) walks the chunks in
order with the (N, P) state in shared memory; y in x's dtype and the
final state in fp32.  x, B and C are float32 or bfloat16 (one dtype);
dt, A and D are taken as float32.  The kernel reads x, dt, B and C
through their strides, so views of the model's (B, S, ...) tensors go in
without copies, and y comes back as a (B, H, S, P) view of a
(B, S, H, P) tensor.  `launches` counts the kernel launches this wrapper
has made.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import runtime

SOURCE = "ssd"
launches = 0


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    fn = lib.ssd_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 9 + [I] * 8 + [P]
        fn.restype = I
    return lib


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             D: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, S, P), dt (B, H, S), A/D (H,), B/C (B, G, S, N) on the
    card, the last axis of x, B and C contiguous → (y (B, H, S, P), final
    state (B, H, N, P) fp32).  The sequence and group refusals are
    `ops.ssd`'s and the kernel's."""
    global launches
    Bb, H, S, P = x.shape
    _, G, _, N = B.shape
    tensors = (x, dt, A, D, B, C)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_cuda takes tensors on one CUDA device")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x/B/C dtypes differ: {x.dtype} {B.dtype} "
                        f"{C.dtype}")
    if dt.shape != (Bb, H, S) or A.shape != (H,) or D.shape != (H,) or \
            B.shape[0] != Bb or B.shape[2] != S or C.shape != B.shape:
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} D {tuple(D.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} do not match")
    if chunk % 32:
        raise ValueError(f"chunk {chunk} is not a multiple of 32")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("the last axis of x, B and C must be contiguous")
    code = runtime.dtype_code(x)
    dt = dt.float()
    A, D = A.float().contiguous(), D.float().contiguous()
    y = torch.empty((Bb, S, H, P), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 15)(*(
        n for t in (x, dt, B, C, y) for n in t.stride()[:3]))
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssd_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          D.data_ptr(), B.data_ptr(), C.data_ptr(),
                          y.data_ptr(), state.data_ptr(), strides, Bb, H, G,
                          S, chunk, N, P, code, stream)
    runtime.check(lib, err, "ssd")
    launches += 1
    return y, state
