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
  init_engine      — the Init pseudo-protocol: memset, iota_fill and
                     prng_fill, write-only generators (one source, three
                     kernels); they take `device=`, the card by default
  copy_engine      — copy_2d with a fused in-stream transform and
                     strided_copy_nd for any view (one source); beside
                     them the reference's descriptor plan of a copy
                     (`plan_descriptor_batch`, `estimate_plan_cycles`,
                     `copy_2d_reference`) on `repro_torch.core`
  matmul_dma       — x @ w with fp32 sums and a fused epilogue (relu,
                     silu, tanh-gelu, scale), bf16 on the tensor cores
"""

from . import runtime
