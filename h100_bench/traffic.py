"""The one traffic generator: a mix file's parameters and the run's seed
give the batches an offline client sends, one after the other, to
`ServeEngine.generate`.

Every batch holds the same lengths: the `batch` quantile midpoints of the
mix's prompt and output laws, each list shuffled by the seed, so that a
seed changes which row gets which length, the token ids and which rows
sample hot, never the work.  Token ids are uniform over the real
vocabulary rows.  A mix file holds:

  source             the published trace or dataset the laws come from
  assumed            what the mix sets that the source does not give
  batch              requests a batch
  prompt_tokens      {"law": "loguniform" | "uniform", "low", "high"}
  output_tokens      the same, for the tokens served a request
  hot_share          (optional) share of each batch's rows that sample,
  hot_temperature    at this temperature; the others are greedy
  max_len            the engine's cache rows a sequence
  check_requests     finished greedy requests the check compares
  trace_decode_steps decode steps the traced run profiles
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from repro_torch.serve import Request

WARMUP_DECODE_STEPS = 3          # decode steps of the warm-up batch


def quantiles(law: Dict, n: int) -> List[int]:
    """The n quantile midpoints of a law over [low, high], as whole
    token counts."""
    lo, hi = law["low"], law["high"]
    u = (np.arange(n) + 0.5) / n
    if law["law"] == "loguniform":
        vals = np.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
    elif law["law"] == "uniform":
        vals = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown law {law['law']!r}")
    return [int(round(v)) for v in vals]


class Traffic:
    """Batches of `Request`s drawn from a mix and a seed."""

    def __init__(self, mix: Dict, seed: int, vocab_size: int) -> None:
        self.mix = mix
        self.vocab_size = vocab_size
        self.rng = np.random.default_rng(seed)
        B = mix["batch"]
        self.prompts = quantiles(mix["prompt_tokens"], B)
        self.outputs = quantiles(mix["output_tokens"], B)
        self.n_hot = int(round(B * mix.get("hot_share", 0.0)))
        self.hot_temperature = mix["hot_temperature"] if self.n_hot else 0.0
        if max(self.prompts) + max(self.outputs) > mix["max_len"]:
            raise ValueError("the longest prompt and output exceed max_len")

    def batch(self) -> List[Request]:
        B = self.mix["batch"]
        prompts = self.rng.permutation(self.prompts)
        outputs = self.rng.permutation(self.outputs)
        hot = set(self.rng.choice(B, self.n_hot, replace=False).tolist())
        return [Request(prompt=self.rng.integers(
                            0, self.vocab_size, int(n)).tolist(),
                        max_new_tokens=int(m),
                        temperature=self.hot_temperature
                        if i in hot else 0.0)
                for i, (n, m) in enumerate(zip(prompts, outputs))]

    def warmup(self) -> List[Request]:
        """A batch at the widest padded shape, with a few decode steps;
        its hot rows as a batch of the window has them."""
        reqs = self.batch()
        width = max(self.prompts)
        for r in reqs:
            r.prompt = self.rng.integers(0, self.vocab_size, width).tolist()
            r.max_new_tokens = WARMUP_DECODE_STEPS + 1
        return reqs
