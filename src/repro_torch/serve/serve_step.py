"""Serving steps: prefill and decode closures over a model, and sampling
(the port of `repro.serve.serve_step`).

For an encoder-decoder (`EncDec`, the audio family) the prefill step
takes (frames, tokens) and returns the decoder layers' cross-attention
K/V, as the reference's does (the tokens are not read); its decode step
takes (caches, cross, tokens, pos).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.models import (LM, EncDec, encdec_decode_step,
                                encdec_prepare_cross, lm_decode_step,
                                lm_prefill)


def make_prefill_step(model: Union[LM, EncDec],
                      max_len: Optional[int] = None) -> Callable:
    if isinstance(model, EncDec):
        def prefill_cross(frames: torch.Tensor,
                          tokens: Optional[torch.Tensor] = None):
            return encdec_prepare_cross(model, frames)
        return prefill_cross

    def prefill(tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None):
        return lm_prefill(model, tokens, max_len=max_len,
                          patch_embeds=patch_embeds)
    return prefill


def make_decode_step(model: Union[LM, EncDec]) -> Callable:
    if isinstance(model, EncDec):
        def step_cross(caches, cross, tokens: torch.Tensor, pos: int):
            return encdec_decode_step(model, caches, cross, tokens, pos)
        return step_cross

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
