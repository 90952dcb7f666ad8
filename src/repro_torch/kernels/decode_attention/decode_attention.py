"""Wrapper of the hand-written CUDA decode attention kernel
(`repro_torch/csrc/decode_attention.cu`), the port of the Pallas TPU kernel
`repro/kernels/decode_attention/decode_attention.py:decode_attention_pallas`.

One query token per sequence attends to its KV cache up to `kv_len`, the
G q heads of each kv head packed into one block; optional sliding window
(keys with col ≥ kv_len − window) and tanh softcap; fp32 online softmax.
`kv_len` is an int or a one-element int32 tensor on the card, which the
kernel reads there (no host sync).  `launches` counts the kernel launches
this wrapper has made.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels import runtime

SOURCE = "decode_attention"
HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, ctypes.c_float, P]
        fn.restype = I
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Optional[Union[int, torch.Tensor]] = None,
                          window: int = 0, softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); k/v (B, Hkv, S, D) on the card → (B, Hq, D)."""
    global launches
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention_cuda takes tensors on one CUDA "
                         "device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} "
                        f"{v.dtype}")
    if k.shape[0] != B or v.shape != k.shape or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if D not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"head_dim {D} / group {Hq // Hkv} not in "
                         f"{HEAD_DIMS} / {GROUPS}")
    code = runtime.dtype_code(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_ptr, kv_host = None, S
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device != q.device or kv_len.dtype != torch.int32 \
                or kv_len.numel() != 1:
            raise ValueError("a tensor kv_len must be one int32 on q's "
                             "device")
        kv_len = kv_len.contiguous()
        kv_ptr = kv_len.data_ptr()
    elif kv_len is not None:
        kv_host = int(kv_len)
    q, k, v = (runtime.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_ptr, kv_host, B, Hq, Hkv, S, D, code, int(window),
            float(scale), float(softcap), stream)
    runtime.check(lib, err, "decode_attention")
    launches += 1
    return out
