"""PyTorch/CUDA port of `repro` for one NVIDIA H100.

Mirrors `repro`'s module names.  It imports torch, numpy and the standard
library, never jax or anything under `repro`.  Entry points run on the
card unless the caller passes `device="cpu"`; the hand-written CUDA
kernels under `csrc/` run for tensors on the card and their plain PyTorch
versions for tensors on the CPU.
"""
