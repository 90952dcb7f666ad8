"""Serving entry point: batched generation with seeded random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --batch 4 --prompt-len 32 --new-tokens 16 [--device cpu] [--full]

`--arch` is gemma2-2b, mamba2-1.3b, hymba-1.5b, internlm2-20b,
chatglm3-6b, qwen2.5-32b, internvl2-26b (whose backbone serves text
prompts here: `ServeEngine` passes no patch embeddings, as the
reference's engine does not), qwen2-moe-a2.7b or mixtral-8x7b (mixture
of experts; mixtral's 46.7 B bf16 params, about 87 GiB, do not fit one
80 GB card with `--full`).

Without `--full` the config is `reduced()` and computes in float32, as
the reference `repro.launch.serve` does; `--full` serves the published
widths in bfloat16.
The device is the card unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import LM
from repro_torch.serve import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    help="a name of repro_torch.configs.REGISTRY, e.g. "
                         "qwen2-moe-a2.7b or mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--full", action="store_true",
                    help="serve the unreduced config in bfloat16")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get(args.arch) if args.full else reduced(get(args.arch))
    rcfg = RunConfig(dtype="bfloat16" if args.full else "float32")
    model = LM(cfg, rcfg, seed=args.seed, device=dev)
    engine = ServeEngine(model, max_len=args.prompt_len + args.new_tokens + 8,
                         seed=args.seed)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, args.prompt_len)],
        max_new_tokens=args.new_tokens,
        temperature=args.temperature) for _ in range(args.batch)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    engine.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in reqs)
    print(json.dumps({
        "arch": cfg.name, "device": str(dev), "batch": args.batch,
        "new_tokens": total_new,
        "wall_s": round(dt, 2),
        "tok_per_s": round(total_new / dt, 1),
        "sample_output": reqs[0].output[:8],
    }, indent=1))


if __name__ == "__main__":
    main()
