"""Hand-written Hopper kernels of the port.

Each kernel package has three files, as in `repro.kernels`:
  <name>.py — the ctypes wrapper of `csrc/<name>.cu` (launch counter),
  ops.py    — the public op: the kernel for CUDA tensors, the plain
              version for CPU tensors,
  ref.py    — the plain PyTorch version.

Kernels:
  flash_attention  — GQA/SWA/softcap prefill attention
  decode_attention — single-token decode over the KV cache
  ssd              — Mamba-2 chunked SSD scan (prefill of SSM layers)
"""

from . import runtime
