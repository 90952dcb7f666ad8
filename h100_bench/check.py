"""Whether what the timed path served is right.

A sample of the first batch's greedy requests, drawn from the seed with
the one served the most tokens among them, is followed through the
window: at each of its steps the program's logits of those rows are
copied to the host (`Capture`, inside the step's timing: an asynchronous
copy a row and step).  Once the window has closed, each sampled
request that the window finished (all of them, unless the window cut the
first batch) goes through the family's plain float32 reference, its
left-padded prompt (as its batch padded it) and its served tokens in one
forward, and these numbers are compared:

  logit_err        the widest distance between the program's logits and
                   the reference's, at any sampled position and token
  token_mismatches served tokens that are not the argmax of the
                   program's own logits at their position (exact: 0)
  logit_gap        the widest gap by which a served token's reference
                   logit lies below the reference's best
  row_errors       the window's rows whose outputs do not hold one token
                   a step their batch ran, or hold a token outside the
                   vocabulary (exact: 0)

The control (`control=True`) reads the first and the third for the
reference with every weight product in float8 e4m3 (`reference.common.
Fp8`) in the program's place: its logits at each position of the same
prompts and tokens, and the gap of the token it puts first.
`as_control` puts those readings where the program's were, so that the
cell's own comparison (`bench.compare`) judges the control.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench.reference import common
from h100_bench.window import Result


class Capture:
    """The program's logits of `n` rows of the first batch at every step:
    the row whose request is served the most tokens and n − 1 more drawn
    by `rng`, greedy rows all.  The host buffer is made at set-up."""

    def __init__(self, n: int, max_new: int, padded_vocab: int,
                 rng: np.random.Generator, device: torch.device) -> None:
        self.n, self.rng = n, rng
        self.rows: Optional[List[int]] = None
        self.host = torch.empty((max_new, n, padded_vocab),
                                dtype=torch.float32,
                                pin_memory=device.type == "cuda")

    def __call__(self, batch: int, k: int, requests, logits) -> None:
        if batch != 0:
            return
        if self.rows is None:
            greedy = [i for i, r in enumerate(requests) if r.temperature == 0]
            first = max(greedy, key=lambda i: requests[i].max_new_tokens)
            rest = [i for i in greedy if i != first]
            more = self.rng.choice(len(rest), min(self.n - 1, len(rest)),
                                   replace=False)
            self.rows = [first] + [rest[i] for i in sorted(more)]
        # a copy a row: no index tensor to send, nothing that waits for
        # the device
        for j, row in enumerate(self.rows):
            self.host[k, j].copy_(logits[row], non_blocking=True)


def row_errors(result: Result, vocab_size: int) -> int:
    bad = 0
    for b in result.batches:
        steps = len(b.token_times)
        for r in b.requests:
            want = min(r.max_new_tokens, steps)
            if len(r.output) != want or any(
                    not 0 <= t < vocab_size for t in r.output):
                bad += 1
    return bad


def _sequences(picks, device: torch.device):
    """(tokens, positions) of each (prompt, served, padded width): the
    left-padded prompt and the served tokens fed back, and the positions
    whose logits gave the served tokens."""
    seqs = []
    for prompt, served, width in picks:
        toks = [0] * (width - len(prompt)) + prompt + served[:-1]
        pos = torch.arange(width - 1, width - 1 + len(served), device=device)
        seqs.append((torch.tensor(toks, device=device), pos))
    return seqs


def _gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """Widest gap of the chosen tokens' reference logits below the best."""
    return float((ref.max(-1).values -
                  ref.gather(1, chosen[:, None])[:, 0]).max())


@torch.no_grad()
def judge(cfg: Dict, ref, weights: common.Weights, result: Result,
          cap: Capture, device: torch.device, control: bool = False
          ) -> Dict[str, float]:
    """The numbers above, with "requests" and "tokens" compared (and, with
    `control`, "control_err" and "control_gap")."""
    V = cfg["vocab_size"]
    out = {"row_errors": row_errors(result, V), "requests": 0, "tokens": 0}
    b0 = result.batches[0] if result.batches else None
    done = [] if b0 is None or cap.rows is None else \
        [i for i, row in enumerate(cap.rows)
         if len(b0.requests[row].output) == b0.requests[row].max_new_tokens]
    if not done:
        return out
    picks = [(b0.requests[cap.rows[i]].prompt,
              list(b0.requests[cap.rows[i]].output), b0.width) for i in done]
    old = common.no_tf32()
    try:
        seqs = _sequences(picks, device)
        best = ref.logits(cfg, weights, seqs)
        low = ref.logits(cfg, weights, seqs, common.Fp8()) if control \
            else [None] * len(picks)
        err = gap = c_err = c_gap = 0.0
        mism = 0
        for i, (_, served, _), r, c in zip(done, picks, best, low):
            n = len(served)
            got = cap.host[:n, i, :V].to(device)
            idx = torch.tensor(served, device=device)
            err = max(err, float((got - r).abs().max()))
            mism += int((got.argmax(-1) != idx).sum())
            gap = max(gap, _gap(r, idx))
            if c is not None:
                c_err = max(c_err, float((c - r).abs().max()))
                c_gap = max(c_gap, _gap(r, c.argmax(-1)))
            out["tokens"] += n
        out.update(requests=len(picks), logit_err=err, token_mismatches=mism,
                   logit_gap=gap)
        if control:
            out.update(control_err=c_err, control_gap=c_gap)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def as_control(judged: Dict[str, float]) -> Dict[str, float]:
    """The judged numbers with the control in the program's place: its
    logits' distance and its first tokens' gap, and no token off its own
    argmax."""
    return dict(judged, logit_err=judged["control_err"],
                logit_gap=judged["control_gap"], token_mismatches=0)
