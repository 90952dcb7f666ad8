"""Wrapper of the hand-written CUDA flash attention kernel
(`repro_torch/csrc/flash_attention.cu`), the port of the Pallas TPU kernel
`repro/kernels/flash_attention/flash_attention.py:flash_attention_pallas`.

Features: grouped-query attention (Hq = G·Hkv), causal masking, sliding
window (keys with col > row − window), tanh logit softcap, fp32 online
softmax at float32 or bfloat16 inputs; the output has the input's dtype.
`launches` counts the kernel launches this wrapper has made.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import runtime

SOURCE = "flash_attention"
HEAD_DIMS = (64, 128, 256)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, I,
                       ctypes.c_float, ctypes.c_float, P]
        fn.restype = I
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) on the card → (B, Hq, Sq, D)."""
    global launches
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda takes tensors on one CUDA "
                         "device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} "
                        f"{v.dtype}")
    if k.shape[0] != B or v.shape != k.shape or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    code = runtime.dtype_code(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    # the bf16 kernel reads through TMA, which needs 16-byte-aligned bases
    q, k, v = runtime.aligned16(q), runtime.aligned16(k), runtime.aligned16(v)
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, code, int(causal), int(window),
            float(scale), float(softcap), stream)
    runtime.check(lib, err, "flash_attention")
    launches += 1
    return out
