"""`StepLM` — the port's prefill/decode steps bound to the
continuous-batching front door (the port of `repro.serve.sched.steplm`).

Admission runs the real prefill for one request (B = 1); its
last-position logits are the request's first sample.

Decode runs one call per request, on the request's own caches.  The
reference groups the requests at one position into one call and relies
on XLA's lowering being bitwise row-independent, so that any batch
composition gives a request the same tokens.  PyTorch's is not: on the
CPU a row of ``x @ W`` at M = 1 differs from the same row inside M = 4,
and on the card cuBLAS picks its kernel by M and decode attention splits
its keys by the batch (`num_splits`).  At one row a call each request
goes through the same kernels in the same order whatever else is in
flight, so its tokens do not depend on which other requests share its
step.

Per-request sampling: greedy rows are exact ``argmax``; a temperature
row draws from a `torch.Generator` seeded from ``(StepLM seed, rid,
len(tokens))`` — counter-based, so the draw at step ``t`` of request
``r`` never depends on which other requests are in flight.  These
draws are not the reference's: `jax.random.fold_in` streams have no
PyTorch counterpart, so hot rows match only themselves across batch
compositions, while greedy rows match the reference's.

KV bytes on the DMA plane: the model's caches are the *logits* source of
truth, while the pool/staging/swap bytes the scheduler moves are a
deterministic hash mirror of the same (request, position, token)
history (`HashLM.kv_rows`), as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models import LM
from repro_torch.models.blocks import Cache
from ..serve_step import (make_decode_step, make_prefill_step,
                          temperature_sample)
from .model import HashLM

_U64 = (1 << 64) - 1


class StepLM:
    """Model adapter over `make_prefill_step` / `make_decode_step`.

    ``model`` is the port's `LM` (its device is where the caches live);
    ``max_len`` the cache length of every request; ``row_bytes`` one KV
    row of the front door's `KVLayout` (the hash mirror's row)."""

    def __init__(self, model: LM, max_len: int, row_bytes: int,
                 eos_token: int = -1, seed: int = 0) -> None:
        self.model = model
        self.vocab = model.cfg.vocab_size
        self.eos_token = eos_token
        self.seed = seed
        self.max_len = max_len
        self._prefill = make_prefill_step(model, max_len=max_len)
        self._decode = make_decode_step(model)
        self._mirror = HashLM(row_bytes, vocab=self.vocab,
                              eos_token=eos_token, seed=seed)
        self._caches: Dict[int, List[Cache]] = {}     # rid → B=1 caches
        self._logits: Dict[int, torch.Tensor] = {}    # rid → pending (V,)
        #: decode calls made, one request each
        self.decode_calls = 0

    # -- DMA-plane byte contract (the hash mirror) ---------------------------

    def kv_rows(self, seed: int, tokens, start: int, end: int,
                which: str) -> np.ndarray:
        return self._mirror.kv_rows(seed, tokens, start, end, which)

    # -- lifecycle -----------------------------------------------------------

    def on_admit(self, req) -> None:
        """Run the real prefill for this request (B=1); its last-position
        logits become the first decode sample."""
        tokens = torch.tensor([req.prompt], dtype=torch.long,
                              device=self.model.device)
        logits, caches = self._prefill(tokens)
        self._caches[req.rid] = caches
        self._logits[req.rid] = logits[0]

    def release(self, req) -> None:
        self._caches.pop(req.rid, None)
        self._logits.pop(req.rid, None)

    # -- decode --------------------------------------------------------------

    def _draw_seed(self, req) -> int:
        """The hot row's generator seed: a pure function of (StepLM seed,
        rid, len(tokens))."""
        entropy = [self.seed & _U64, req.rid & _U64, len(req.tokens)]
        return int(np.random.SeedSequence(entropy).generate_state(
            1, np.uint64)[0])

    def _sample_row(self, req, logits_row: torch.Tensor) -> int:
        if req.temperature <= 0:
            return int(torch.argmax(logits_row))
        gen = torch.Generator(logits_row.device).manual_seed(
            self._draw_seed(req))
        return int(temperature_sample(gen, logits_row[None],
                                      max(req.temperature, 1e-4))[0])

    def decode_call(self, req) -> torch.Tensor:
        """One decode call for ``req`` at its position, ``len(tokens) - 1``,
        on its own caches (the call writes the token's K/V row into its
        attention caches in place and replaces its SSM caches).  Returns
        its logits (V,)."""
        tokens = torch.tensor([[req.tokens[-1]]], dtype=torch.long,
                              device=self.model.device)
        logits, self._caches[req.rid] = self._decode(
            self._caches[req.rid], tokens, len(req.tokens) - 1)
        self.decode_calls += 1
        return logits[0]

    def next_tokens(self, reqs, gathered: List[Tuple[np.ndarray,
                                                     np.ndarray]]
                    ) -> List[int]:
        """One token per request; ``gathered`` (the DMA-plane bytes) is
        validated by the tests' digests, not consumed for logits."""
        out: List[int] = []
        for req in reqs:
            # first decode step: the prefill already produced these
            # logits (position len(prompt) - 1)
            logits = self._logits.pop(req.rid, None)
            if logits is None:
                logits = self.decode_call(req)
            out.append(self._sample_row(req, logits))
        return out
