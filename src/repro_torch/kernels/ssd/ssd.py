"""Wrapper of the hand-written CUDA SSD kernel (`repro_torch/csrc/ssd.cu`),
the port of the Pallas TPU kernel `repro/kernels/ssd/ssd.py:ssd_pallas`.

Mamba-2's chunked scan, y in x's dtype and the final state in fp32, on one
of two routes that `route` chooses from the operands (`ROUTES`):
"tensor_cores", the chunks in parallel with every product on `mma.sync`
(3xTF32 for fp32 inputs), through fp32 scratch this wrapper allocates
(C·Bᵀ of each group and chunk, and the chunk states, (B, H, S/chunk, N,
P): 302 MB at mamba2-1.3b's prefill shape); "cuda_cores", one block per
(batch, head) walking the chunks in order, for the shapes and views the
first does not take.  x, B and C are float32 or bfloat16 (one dtype); dt,
A and D are taken as float32.  The kernels read x, dt, B and C through
their strides, so views of the model's (B, S, ...) tensors go in without
copies, and y comes back as a (B, H, S, P) view of a (B, S, H, P) tensor.
`launches` counts the calls that launched the kernel, one a call whatever
the route (the tensor-core route is four launches on the stream),
`launches_by_route` the same by route.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import runtime

SOURCE = "ssd"
#: the kernel's routes, the preferred one first
ROUTES = ("tensor_cores", "cuda_cores")
#: the tensor-core route's limits (csrc/ssd.cu, namespace tc): chunk ≤
#: MAX_L, N a multiple of 16 up to MAX_N, P one of TC_P
MAX_L, MAX_N, TC_P = 128, 128, (16, 32, 64)
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


def route(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
          chunk: int = 128) -> str:
    """The route `ssd_cuda` takes for these operands (on any device, so
    the choice can be checked on the CPU): "tensor_cores" for float32 or
    bfloat16 x, B and C of one dtype, a chunk of at most MAX_L, N a
    multiple of 16 up to MAX_N, P one of TC_P, and x, B and C whose base
    addresses and (batch, head or group, step) strides are multiples of
    16 bytes with their last axis contiguous (the 16-byte copies of their
    rows); else "cuda_cores".  dt is read element by element on both
    routes, so it plays no part."""
    P, N = x.shape[-1], B.shape[-1]
    if not (x.dtype in (torch.float32, torch.bfloat16)
            and B.dtype == C.dtype == x.dtype):
        return "cuda_cores"
    if chunk % 32 or chunk > MAX_L or N % 16 or N > MAX_N or P not in TC_P:
        return "cuda_cores"
    elt = x.element_size()
    for t in (x, B, C):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                any(s * elt % 16 for s in t.stride()[:3]):
            return "cuda_cores"
    return "tensor_cores"


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    if lib.ssd_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_fwd.argtypes = [P] * 9 + [I] * 8 + [P]
        lib.ssd_fwd.restype = I
        lib.ssd_tc_fwd.argtypes = [P] * 9 + [I] * 8 + [P] * 4
        lib.ssd_tc_fwd.restype = I
    return lib


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             D: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             chunk: int = 128, kernel_route: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, S, P), dt (B, H, S), A/D (H,), B/C (B, G, S, N) on the
    card, the last axis of x, B and C contiguous → (y (B, H, S, P), final
    state (B, H, N, P) fp32).  The sequence and group refusals are
    `ops.ssd`'s and the kernel's.  `kernel_route` names a route in place
    of `route(...)`, to time the routes against each other: "cuda_cores"
    takes every operand, "tensor_cores" raises `ValueError` where `route`
    would not choose it."""
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
    chosen = route(x, B, C, chunk)
    if kernel_route is not None:
        if kernel_route not in (chosen, "cuda_cores"):
            raise ValueError(f"route {kernel_route!r} does not take these "
                             f"operands (route: {chosen!r})")
        chosen = kernel_route
    dt = dt.float()
    A, D = A.float().contiguous(), D.float().contiguous()
    y = torch.empty((Bb, S, H, P), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 15)(*(
        n for t in (x, dt, B, C, y) for n in t.stride()[:3]))
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
            strides, Bb, H, G, S, chunk, N, P, code)
    with torch.cuda.device(x.device):
        if chosen == "tensor_cores":
            nc = S // chunk
            f32 = dict(dtype=torch.float32, device=x.device)
            cb = torch.empty((Bb, G, nc, chunk, chunk), **f32)
            states = torch.empty((Bb, H, nc, N, P), **f32)
            totals = torch.empty((Bb, H, nc), **f32)
            err = lib.ssd_tc_fwd(*args, cb.data_ptr(), states.data_ptr(),
                                 totals.data_ptr(), stream)
        else:
            err = lib.ssd_fwd(*args, stream)
    runtime.check(lib, err, f"ssd ({chosen})")
    launches += 1
    launches_by_route[chosen] += 1
    return y, state
