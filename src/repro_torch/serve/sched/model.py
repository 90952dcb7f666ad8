"""Models the serving front door can drive, and the sequential oracle.

The front door's model contract is byte-coupled to the DMA plane: the
model *defines* the KV bytes the scheduler moves (`kv_rows`) and then
*consumes* the gathered bytes back at decode time (`next_tokens`).  Any
corruption along the descriptor path — a swap that restores the wrong
page, a gather that reads a recycled block, a staging overlap — changes
the gathered image and therefore the emitted tokens, which is exactly
what the byte-identity gates check.

`HashLM` is the deterministic numpy reference model: the KV row of
position ``t`` is a splitmix64 expansion of ``(request seed, t,
token[t])`` and the next token is a keyed digest of the gathered valid
rows.  It has no float path at all, so "byte-identical to the
sequential oracle" is a hard equality, not a tolerance.

`oracle_generate` replays one request with **no** engine, pool or
scheduler — pure model evaluation over reconstructed rows — and is the
one-request-at-a-time oracle the verify family and the benchmark gate
compare against.

The PyTorch binding (`StepLM`, `serve.sched.steplm`) plugs the port's
prefill/decode step functions into the same contract.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_P1 = np.uint64(0x9E3779B97F4A7C15)
_P2 = np.uint64(0xBF58476D1CE4E5B9)
_P3 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 arrays (wrapping
    multiply is the point — overflow warnings are noise here)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint64)
        x = (x + _P1) & _MASK
        x ^= x >> np.uint64(30)
        x = (x * _P2) & _MASK
        x ^= x >> np.uint64(27)
        x = (x * _P3) & _MASK
        return x ^ (x >> np.uint64(31))


class HashLM:
    """Deterministic KV-coupled token model (no floats, no torch).

    * ``kv_rows(seed, tokens, start, end, which)`` — the pool content
      for positions ``[start, end)``: each row is a pure function of
      ``(model seed, request seed, which, position, token at position)``.
    * ``next_tokens(reqs, gathered)`` — the next token per request from
      an order-sensitive digest of its gathered valid rows; greedy for
      ``temperature <= 0``, else a seeded per-request categorical over
      digest-derived logits (counter-based RNG: the draw at step ``t``
      of request ``r`` never depends on batch composition).
    """

    def __init__(self, row_bytes: int, vocab: int = 64,
                 eos_token: int = 1, seed: int = 0) -> None:
        if row_bytes % 8:
            raise ValueError(f"row_bytes {row_bytes} must be a multiple "
                             f"of 8 (rows hash as uint64 words)")
        if not 2 <= vocab <= 1 << 20:
            raise ValueError(f"vocab {vocab} out of range")
        self.row_bytes = row_bytes
        self.row_words = row_bytes // 8
        self.vocab = vocab
        self.eos_token = eos_token
        self.seed = seed
        self._word_idx = np.arange(self.row_words, dtype=np.uint64)

    # -- pool content -------------------------------------------------------

    def kv_rows(self, seed: int, tokens: Sequence[int], start: int,
                end: int, which: str) -> np.ndarray:
        """``(end - start, row_bytes)`` uint8 rows for positions
        ``[start, end)`` of a request whose token history is `tokens`."""
        if not start <= end <= len(tokens):
            raise ValueError(f"row span [{start}, {end}) outside "
                             f"history of {len(tokens)}")
        with np.errstate(over="ignore"):
            pos = np.arange(start, end, dtype=np.uint64)
            toks = np.asarray(tokens[start:end], dtype=np.uint64)
            base = _mix(np.uint64((self.seed * 0x10001 + seed)
                                  & 0xFFFFFFFF)
                        + np.uint64(2 if which == "k" else 3) * _P2)
            h = _mix(base + pos * _P1 + _mix(toks))                # (n,)
            ctr = h[:, None] + self._word_idx[None, :] * _P3       # (n, w)
        rows = _mix(ctr).astype("<u8").view(np.uint8)
        return rows.reshape(end - start, self.row_bytes)

    # -- decode -------------------------------------------------------------

    def _digest(self, seed: int, n_tokens: int, last_token: int,
                k_bytes: np.ndarray, v_bytes: np.ndarray) -> np.uint64:
        """Order-sensitive digest of the gathered valid rows — one
        flipped byte anywhere in either image changes it."""
        with np.errstate(over="ignore"):
            w = np.concatenate([
                np.ascontiguousarray(k_bytes).view("<u8"),
                np.ascontiguousarray(v_bytes).view("<u8")])
            weights = _mix(np.arange(w.shape[0], dtype=np.uint64))
            folded = np.bitwise_xor.reduce(_mix(w + weights)) \
                if w.size else np.uint64(0)
            return _mix(folded + _mix(np.uint64(seed & 0xFFFFFFFF)
                                      + np.uint64(n_tokens) * _P1
                                      + np.uint64(last_token) * _P2))

    def next_tokens(self, reqs, gathered: List[Tuple[np.ndarray,
                                                     np.ndarray]]
                    ) -> List[int]:
        """One next token per request; ``gathered[i]`` is request ``i``'s
        contiguous valid K and V images (``len(tokens) * row_bytes`` bytes
        each — page-tail bytes past the last token are *excluded*: they
        belong to whatever previously tenanted the block)."""
        out = []
        for req, (kb, vb) in zip(reqs, gathered):
            d = self._digest(req.seed, len(req.tokens), req.tokens[-1],
                             kb, vb)
            if req.temperature <= 0:
                out.append(int(d % np.uint64(self.vocab)))
                continue
            # digest-derived logits + a counter-based per-request draw
            logits = _mix(d + np.arange(self.vocab, dtype=np.uint64)
                          ).astype(np.float64) / float(1 << 64)
            z = logits / max(req.temperature, 1e-4)
            p = np.exp(z - z.max())
            p /= p.sum()
            rng = np.random.default_rng(
                [req.seed & 0xFFFFFFFF, len(req.tokens), 0x5E12])
            out.append(int(rng.choice(self.vocab, p=p)))
        return out

    # -- front-door lifecycle hooks (stateless model: no-ops) ---------------

    def on_admit(self, req) -> None:
        pass

    def release(self, req) -> None:
        pass


class _OracleReq:
    """The minimal request view `next_tokens` reads."""

    __slots__ = ("seed", "tokens", "temperature")

    def __init__(self, seed: int, tokens: List[int],
                 temperature: float) -> None:
        self.seed = seed
        self.tokens = tokens
        self.temperature = temperature


def oracle_generate(model: HashLM, seed: int, prompt: Sequence[int],
                    max_new_tokens: int, temperature: float = 0.0,
                    stop_tokens: Sequence[int] = ()) -> List[int]:
    """Sequential one-request-at-a-time oracle: replay one request with
    no engine, no pool and no scheduler — the rows a correct DMA plane
    would gather are reconstructed directly from the model.

    Token-for-token this must equal what `ServeFrontDoor` emits for the
    same request, regardless of batch composition, preemption, or
    swap-out/swap-in along the way."""
    view = _OracleReq(seed, list(prompt), temperature)
    stop = set(stop_tokens) | {model.eos_token}
    k_rows = [model.kv_rows(seed, view.tokens, 0, len(view.tokens), "k")]
    v_rows = [model.kv_rows(seed, view.tokens, 0, len(view.tokens), "v")]
    out: List[int] = []
    for _ in range(max_new_tokens):
        kb = np.concatenate(k_rows).reshape(-1)
        vb = np.concatenate(v_rows).reshape(-1)
        tok = model.next_tokens([view], [(kb, vb)])[0]
        out.append(tok)
        view.tokens.append(tok)
        if tok in stop:
            break
        t = len(view.tokens) - 1
        k_rows.append(model.kv_rows(seed, view.tokens, t, t + 1, "k"))
        v_rows.append(model.kv_rows(seed, view.tokens, t, t + 1, "v"))
    return out
