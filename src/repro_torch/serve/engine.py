"""Batched serving engine: prefill + decode loop with greedy/temperature
sampling over a fixed batch of requests (the port of
`repro.serve.engine`).

Prompts are left-padded with token 0 and, as in the reference, the pad
tokens are attended (there is no pad mask).  Each batch row samples from
its own generator, seeded from the engine's seed and the row and kept on
the engine, so its draws go on from one `generate` call to the next, as
the reference's engine key does; a fresh engine with the same seed
repeats them.
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


def left_pad(prompts: List[List[int]]) -> torch.Tensor:
    """(B, longest prompt) int64 tokens, each prompt left-padded with 0."""
    width = max(map(len, prompts))
    tokens = torch.zeros((len(prompts), width), dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, width - len(p):] = torch.tensor(p, dtype=torch.long)
    return tokens


class ServeEngine:
    def __init__(self, model: LM, max_len: int = 512, seed: int = 0) -> None:
        if model.cfg.encoder is not None:
            # the reference's engine would fail on the prefill's missing
            # frames argument
            raise ValueError(
                f"{model.cfg.name}: ServeEngine serves decoder-only LMs; "
                f"serve an encoder-decoder through make_prefill_step "
                f"(frames → cross K/V) and make_decode_step")
        self.model = model
        self.max_len = max_len
        self.seed = seed
        self._gens: List[torch.Generator] = []   # row i's sampling stream
        self._prefill = make_prefill_step(model, max_len=max_len)
        self._decode = make_decode_step(model)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Run a padded batch of requests to completion."""
        B = len(requests)
        dev = self.model.device
        tokens = left_pad([r.prompt for r in requests]).to(dev)
        prompt_len = tokens.shape[1]
        for i in range(len(self._gens), B):
            self._gens.append(torch.Generator(dev).manual_seed(
                self.seed * 65_537 + i))
        gens = self._gens[:B]

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
