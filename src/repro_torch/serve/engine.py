"""Batched serving engine: prefill + decode loop with greedy/temperature
sampling over a fixed batch of requests (the port of
`repro.serve.engine`).

Prompts are left-padded with token 0 and, as in the reference, the pad
tokens are attended (there is no pad mask).  Each batch row samples from
its own generator, seeded from the engine's seed and the row and kept on
the engine, so its draws go on from one `generate` call to the next, as
the reference's engine key does; a fresh engine with the same seed
repeats them.

The decode steps run through `GraphDecodeStep`: on the card, for a model
of attention layers with dense FFNs, the layers replay from CUDA graphs
captured at the first step of a batch size and kept while the batch size
stays; elsewhere the eager step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from repro_torch import spans
from repro_torch.models import LM
from .serve_step import (GraphDecodeStep, greedy_sample, make_prefill_step,
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
        self._decode = GraphDecodeStep(model)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Run a padded batch of requests to completion.  Its records
        (`repro_torch.spans`) carry the call's number; its counters:
        `serve.prefill_tokens` (own: the prompts' tokens, padded: B x the
        padded width) once the prefill returns, and `serve.kv_rows`
        (reserved: B x max_len cache rows, own: the rows of requests still
        served) after each decode step's tokens are appended."""
        B = len(requests)
        dev = self.model.device
        tokens = left_pad([r.prompt for r in requests]).to(dev)
        prompt_len = tokens.shape[1]
        for i in range(len(self._gens), B):
            self._gens.append(torch.Generator(dev).manual_seed(
                self.seed * 65_537 + i))
        gens = self._gens[:B]

        with spans.call("repro_torch.serve.generate", B=B,
                        width=prompt_len):
            logits, caches = self._prefill(tokens)
            if spans.active():
                spans.count("repro_torch.serve.prefill_tokens",
                            own=sum(len(r.prompt) for r in requests),
                            padded=B * prompt_len)
            max_new = max(r.max_new_tokens for r in requests)
            pos = prompt_len
            cur = self._sample(logits, requests, gens)
            with spans.span("repro_torch.serve.emit", B=B):
                for r, t in zip(requests, cur.tolist()):
                    r.output.append(t)

            for k in range(1, max_new):
                if all(r.finished for r in requests):
                    break  # every request hit max_new or a stop token
                logits, caches = self._decode(caches, cur[:, None].long(),
                                              pos)
                cur = self._sample(logits, requests, gens)
                pos += 1
                with spans.span("repro_torch.serve.emit", B=B):
                    for r, t in zip(requests, cur.tolist()):
                        if not r.finished:
                            r.output.append(t)
                if spans.active():
                    # a request served in step k holds k + 1 tokens
                    spans.count("repro_torch.serve.kv_rows",
                                reserved=B * self.max_len,
                                own=sum(len(r.prompt) + k for r in requests
                                        if len(r.output) == k + 1))
        return requests

    def _sample(self, logits: torch.Tensor, requests: List[Request],
                gens: List[torch.Generator]) -> torch.Tensor:
        """Greedy rows are exact argmax, never touched by a neighbour's
        temperature; each hot row draws at its own temperature from its
        own generator."""
        with spans.span("repro_torch.serve.sample", B=len(requests)):
            cur = greedy_sample(logits)
            for i, r in enumerate(requests):
                if r.temperature > 0:
                    cur[i] = temperature_sample(gens[i], logits[i:i + 1],
                                                max(r.temperature, 1e-4))[0]
            return cur
