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

A family may follow a choice (its module's `FOLLOW`, a `families.Choice`):
a function of the port that makes a discrete choice inside a step, such
as an MoE router's top-k.  Served in bf16 it can flip near-tied choices
against the float32 reference, and `logit_err` would then measure the
flips, not the arithmetic.  Over the first batch the function is
wrapped, and each call's choices of the checked rows are copied to the
host as the logits are; the reference takes the program's choice where
its own margin is within the cell's limit `<name>_margin`, and counts
it (`reference.common.Follow`):

  <name>_flips     the program's choices the reference took
  <name>_margin    the widest margin of the reference's own by which a
                   choice of the program's differed from it

The control is judged as a program is: the float32 reference follows
the choices the float8 reference made (`control_<name>_...`).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from h100_bench.families import Choice
from h100_bench.reference import common
from h100_bench.window import Result


class Capture:
    """The program's logits of `n` rows of the first batch at every step:
    the row whose request is served the most tokens and n − 1 more drawn
    by `rng`, greedy rows all, chosen (`choose`) before the batch runs.
    The host buffers are made at set-up."""

    def __init__(self, n: int, max_new: int, padded_vocab: int,
                 rng: np.random.Generator, device: torch.device) -> None:
        self.n, self.rng = n, rng
        self.pinned = device.type == "cuda"
        self.rows: Optional[List[int]] = None
        self.host = torch.empty((max_new, n, padded_vocab),
                                dtype=torch.float32, pin_memory=self.pinned)
        self.choice: Optional[Choice] = None
        self._unwrap: Optional[Callable[[], None]] = None

    def choose(self, requests) -> None:
        """The checked rows, from the first batch's requests."""
        if self.rows is not None:
            return
        greedy = [i for i, r in enumerate(requests) if r.temperature == 0]
        first = max(greedy, key=lambda i: requests[i].max_new_tokens)
        rest = [i for i in greedy if i != first]
        more = self.rng.choice(len(rest), min(self.n - 1, len(rest)),
                               replace=False)
        self.rows = [first] + [rest[i] for i in sorted(more)]
        self.batch = len(requests)

    def follow(self, choice: Choice, shape: Tuple[int, ...],
               max_len: int) -> None:
        """Keep `choice`'s choices of the checked rows at every position
        of the first batch, until it ends or `close`."""
        sites, *row = shape
        self.choice, self.sites = choice, sites
        self.choices = torch.empty((sites, self.n, max_len, *row),
                                   dtype=torch.int64, pin_memory=self.pinned)
        self.step = self.site = self.width = 0
        mod = importlib.import_module(choice.module)
        fn = getattr(mod, choice.fn)
        self._unwrap = lambda: setattr(mod, choice.fn, fn)
        setattr(mod, choice.fn, self._kept(fn))

    def _kept(self, fn):
        def kept(*args, **kw):
            out = fn(*args, **kw)
            t = self.choice.keep(out)
            S = t.shape[0] // self.batch        # the prefill's width, or 1
            if self.step == 0:
                self.width = S
            at = 0 if self.step == 0 else self.width - 1 + self.step
            rows = t.view(self.batch, S, *t.shape[1:])
            for j, row in enumerate(self.rows):
                self.choices[self.site, j, at:at + S].copy_(
                    rows[row], non_blocking=True)
            self.site += 1
            return out
        return kept

    def close(self) -> None:
        """Stop following (the port's function as it was)."""
        if self._unwrap is not None:
            self._unwrap()
            self._unwrap = None

    def __call__(self, batch: int, k: int, requests, logits) -> None:
        if batch != 0:
            self.close()
            return
        # a copy a row: no index tensor to send, nothing that waits for
        # the device
        for j, row in enumerate(self.rows):
            self.host[k, j].copy_(logits[row], non_blocking=True)
        if self._unwrap is not None:
            if self.site != self.sites:
                raise ValueError(f"{self.choice.fn} was called {self.site} "
                                 f"times in step {k}, where the family "
                                 f"counts {self.sites}")
            self.step, self.site = k + 1, 0
            if k + 1 == max(r.max_new_tokens for r in requests):
                self.close()


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


def _logits(ref, cfg: Dict, weights: common.Weights, seqs,
            mm: common.Float32, follow: Optional[common.Follow]):
    if follow is None:
        return ref.logits(cfg, weights, seqs, mm)
    return ref.logits(cfg, weights, seqs, mm, follow=follow)


@torch.no_grad()
def judge(cfg: Dict, family, weights: common.Weights, result: Result,
          cap: Capture, device: torch.device,
          limits: Optional[Dict] = None, control: bool = False
          ) -> Dict[str, float]:
    """The numbers above, with "requests" and "tokens" compared (and, with
    `control`, "control_err", "control_gap" and the control's followed
    numbers).  `family` is the configuration's family module; `limits`,
    the cell's, give the margin within which a followed choice is
    taken."""
    V = cfg["vocab_size"]
    ref, choice = family.reference, family.FOLLOW
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
        follow = own = trail = None
        if choice is not None:
            limit = limits[f"{choice.name}_margin"]
            # each site's kept choices of each sequence's positions
            follow = common.Follow(
                {s: [cap.choices[s, i, :len(t)] for i, (t, _) in
                     zip(done, seqs)] for s in range(cap.sites)}, limit)
            own = common.Follow() if control else None
        best = _logits(ref, cfg, weights, seqs, common.Float32(), follow)
        low = _logits(ref, cfg, weights, seqs, common.Fp8(), own) \
            if control else [None] * len(picks)
        if own is not None:
            # the float32 reference as it judges the control: following
            # the control's own choices
            trail = common.Follow(own.own, limit)
            best_c = _logits(ref, cfg, weights, seqs, common.Float32(), trail)
        else:
            best_c = best
        err = gap = c_err = c_gap = 0.0
        mism = 0
        for i, (_, served, _), r, c, rc in zip(done, picks, best, low,
                                               best_c):
            n = len(served)
            got = cap.host[:n, i, :V].to(device)
            idx = torch.tensor(served, device=device)
            err = max(err, float((got - r).abs().max()))
            mism += int((got.argmax(-1) != idx).sum())
            gap = max(gap, _gap(r, idx))
            if c is not None:
                c_err = max(c_err, float((c - rc).abs().max()))
                c_gap = max(c_gap, _gap(rc, c.argmax(-1)))
            out["tokens"] += n
        out.update(requests=len(picks), logit_err=err, token_mismatches=mism,
                   logit_gap=gap)
        if follow is not None:
            out.update(follow.numbers(choice.name))
        if control:
            out.update(control_err=c_err, control_gap=c_gap)
            if trail is not None:
                out.update({f"control_{n}": v for n, v in
                            trail.numbers(choice.name).items()})
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


# the control's reading of each compared number, where it has one
CONTROL = {"logit_err": "control_err", "logit_gap": "control_gap"}


def control_of(number: str) -> str:
    return CONTROL.get(number, f"control_{number}")


def as_control(judged: Dict[str, float]) -> Dict[str, float]:
    """The judged numbers with the control in the program's place: each
    number the control reads, and no token off its own argmax."""
    out = dict(judged, token_mismatches=0)
    for n in judged:
        if control_of(n) in judged:
            out[n] = judged[control_of(n)]
    return out
