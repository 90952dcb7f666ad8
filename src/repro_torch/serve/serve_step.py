"""Serving steps: prefill and decode closures over a model, and sampling
(the port of `repro.serve.serve_step` for decoder-only LMs)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import LM, lm_decode_step, lm_prefill


def make_prefill_step(model: LM, max_len: Optional[int] = None) -> Callable:
    def prefill(tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None):
        return lm_prefill(model, tokens, max_len=max_len,
                          patch_embeds=patch_embeds)
    return prefill


def make_decode_step(model: LM) -> Callable:
    def step(caches, tokens: torch.Tensor, pos: int):
        return lm_decode_step(model, caches, tokens, pos)
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
