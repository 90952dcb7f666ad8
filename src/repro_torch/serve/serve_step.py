"""Serving steps: prefill and decode closures over a model, and sampling
(the port of `repro.serve.serve_step`).

For an encoder-decoder (`EncDec`, the audio family) the prefill step
takes (frames, tokens) and returns the decoder layers' cross-attention
K/V, as the reference's does (the tokens are not read); its decode step
takes (caches, cross, tokens, pos).

On a mesh (a model whose parameters are DTensors) each step runs under
`implicit_replication`, as the train step does: the tensors a step makes
(positions, masks) count as replicated.

`rcfg` is the reference's setting, chosen by the caller: under
`kernels="xla"` the steps take the plain attention and SSD (the path the
dry-run costs), and with None, or "pallas", the kernel ops, which run
their kernels on the card and raise on a device that has none.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.train.train_step import _on_mesh
from repro_torch.models import (LM, EncDec, encdec_decode_step,
                                encdec_prepare_cross, lm_decode_step,
                                lm_prefill)


def make_prefill_step(model: Union[LM, EncDec],
                      max_len: Optional[int] = None,
                      rcfg: Optional[RunConfig] = None) -> Callable:
    if isinstance(model, EncDec):
        def prefill_cross(frames: torch.Tensor,
                          tokens: Optional[torch.Tensor] = None):
            with _on_mesh(model):
                return encdec_prepare_cross(model, frames, rcfg)
        return prefill_cross

    def prefill(tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None):
        with _on_mesh(model):
            return lm_prefill(model, tokens, max_len=max_len,
                              patch_embeds=patch_embeds, rcfg=rcfg)
    return prefill


def make_decode_step(model: Union[LM, EncDec],
                     rcfg: Optional[RunConfig] = None) -> Callable:
    if isinstance(model, EncDec):
        def step_cross(caches, cross, tokens: torch.Tensor, pos: int):
            with _on_mesh(model):
                return encdec_decode_step(model, caches, cross, tokens, pos,
                                          rcfg)
        return step_cross

    def step(caches, tokens: torch.Tensor, pos: int):
        with _on_mesh(model):
            return lm_decode_step(model, caches, tokens, pos, rcfg)
    return step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(generator: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """One draw per row from softmax(logits / temperature)."""
    if temperature <= 0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)
