"""Wrapper of the hand-written CUDA decode attention kernel
(`repro_torch/csrc/decode_attention.cu`), the port of the Pallas TPU kernel
`repro/kernels/decode_attention/decode_attention.py:decode_attention_pallas`.

One query token per sequence attends to its KV cache up to `kv_len`, the
q heads of each kv head packed into one block (at most 8; G 16 takes two
blocks); optional sliding window (keys with col ≥ kv_len − window) and
tanh softcap; fp32 online softmax.  The live keys are split across
`num_splits` blocks a (b, kv head), fixed here from the cache's capacity
and the SM count, and merged in the same launch by the last block to
finish, through a workspace kept here, one per (device, stream): the
partial softmaxes' scratch and counters that the kernel leaves at 0, so
a call allocates nothing.  `kv_len` is an int or a one-element int32
tensor on the card, which the kernel reads there (no host sync).
`launches` counts the kernel launches this wrapper has made.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import runtime

SOURCE = "decode_attention"
HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 5, 6, 8, 16)
#: q heads one block holds in registers; a larger group is split in blocks
MAX_HEADS_PER_BLOCK = 8
#: blocks a call aims for on each SM, fewest keys a split of a full cache,
#: most splits
BLOCKS_PER_SM, MIN_KEYS_PER_SPLIT, MAX_SPLITS = 2, 32, 64
launches = 0

_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def heads_per_block(group: int) -> int:
    return group if group <= MAX_HEADS_PER_BLOCK else MAX_HEADS_PER_BLOCK


def num_splits(blocks: int, capacity: int, sms: int) -> int:
    """Key splits a (b, kv head) for a call of `blocks` head blocks over a
    cache of `capacity` rows on a card of `sms` SMs: about BLOCKS_PER_SM
    blocks an SM in all, at least MIN_KEYS_PER_SPLIT keys a split when the
    cache is full, at most MAX_SPLITS, at least 1.  It depends on the
    capacity, never on `kv_len`, which stays on the card."""
    want = (BLOCKS_PER_SM * sms) // max(blocks, 1)
    return max(1, min(want, MAX_SPLITS, capacity // MIN_KEYS_PER_SPLIT))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(device: torch.device, stream: int, n_counters: int,
               n_part: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counters, scratch) for launches on `stream`: at least `n_counters`
    int32 at 0 and `n_part` floats.  Launches on one stream run in turn,
    so they share them; the kernel leaves the counters at 0, so they are
    zeroed once."""
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None or work[0].numel() < n_counters or \
            work[1].numel() < n_part:
        work = _WORK[key] = (
            torch.zeros(max(n_counters, 1024), dtype=torch.int32,
                        device=device),
            torch.empty(max(n_part, 1 << 20), dtype=torch.float32,
                        device=device))
    return work


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I,
                       ctypes.c_float, ctypes.c_float, I, I, P, P, P]
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
    G = Hq // Hkv
    if D not in HEAD_DIMS or Hq % Hkv or G not in GROUPS:
        raise ValueError(f"decode attention on the card takes head_dim in "
                         f"{HEAD_DIMS} and a GQA group in {GROUPS}; got "
                         f"head_dim {D}, Hq {Hq}, Hkv {Hkv}")
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
    per_block = heads_per_block(G)
    blocks = B * Hkv * (G // per_block)
    splits = num_splits(blocks, S, _sm_count(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = counters = None
    if splits > 1:
        counters, part = _workspace(q.device, stream, blocks,
                                    B * Hq * splits * (D + 2))
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_ptr, kv_host, B, Hq, Hkv, S, D, code, int(window),
            float(scale), float(softcap), per_block, splits,
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), stream)
    runtime.check(lib, err, "decode_attention")
    launches += 1
    return out
