"""Batched serving engine: prefill + decode loop with greedy/temperature
sampling over a fixed batch of requests (the port of
`repro.serve.engine`).

Prompts are left-padded with token 0 and, as in the reference, the pad
tokens are attended (there is no pad mask).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from repro_torch.models import LM
from .serve_step import (greedy_sample, make_decode_step, make_prefill_step,
                         temperature_sample)


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    output: List[int] = field(default_factory=list)

    @property
    def finished(self) -> bool:
        return len(self.output) >= self.max_new_tokens or \
            bool(self.output and self.output[-1] in self.stop_tokens)


class ServeEngine:
    def __init__(self, model: LM, max_len: int = 512, seed: int = 0) -> None:
        self.model = model
        self.max_len = max_len
        self.seed = seed
        self._prefill = make_prefill_step(model, max_len=max_len)
        self._decode = make_decode_step(model)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Run a padded batch of requests to completion."""
        B = len(requests)
        dev = self.model.device
        prompt_len = max(len(r.prompt) for r in requests)
        tokens = torch.zeros((B, prompt_len), dtype=torch.long)
        for i, r in enumerate(requests):
            tokens[i, prompt_len - len(r.prompt):] = torch.tensor(
                r.prompt, dtype=torch.long)               # left pad
        tokens = tokens.to(dev)
        # row i of every generate call draws from the same seeded stream
        gens = [torch.Generator(dev).manual_seed(self.seed * 65_537 + i)
                for i in range(B)]

        logits, caches = self._prefill(tokens)
        max_new = max(r.max_new_tokens for r in requests)
        pos = prompt_len
        cur = self._sample(logits, requests, gens)
        for r, t in zip(requests, cur.tolist()):
            r.output.append(t)

        for _ in range(max_new - 1):
            if all(r.finished for r in requests):
                break  # every request hit max_new or a stop token
            logits, caches = self._decode(caches, cur[:, None].long(), pos)
            cur = self._sample(logits, requests, gens)
            pos += 1
            for r, t in zip(requests, cur.tolist()):
                if not r.finished:
                    r.output.append(t)
        return requests

    def _sample(self, logits: torch.Tensor, requests: List[Request],
                gens: List[torch.Generator]) -> torch.Tensor:
        """Greedy rows are exact argmax, never touched by a neighbour's
        temperature; each hot row draws at its own temperature from its
        own generator."""
        cur = greedy_sample(logits)
        for i, r in enumerate(requests):
            if r.temperature > 0:
                cur[i] = temperature_sample(gens[i], logits[i:i + 1],
                                            max(r.temperature, 1e-4))[0]
        return cur
