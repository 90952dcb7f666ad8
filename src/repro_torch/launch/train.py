"""Training launcher (the port of `repro.launch.train`).

Trains a config on the synthetic pipeline through `Trainer` and prints a
JSON summary, on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 50 --seq-len 128 --batch 8 --ckpt build/ckpt --device cpu

As in the reference, ``--reduced`` is a flag whose default is already on,
so the launcher always trains the reduced config; a full-width run goes
through `Trainer` directly (`chip_smoke.py` does).
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import get
from repro_torch.configs.base import RunConfig, reduced as reduce_cfg
from repro_torch.dist.fault import FaultConfig
from repro_torch.train import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-policy", default="replay",
                    choices=["replay", "continue", "abort"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    rcfg = RunConfig(kernels="xla", dtype="float32", remat=False,
                     learning_rate=args.lr)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt,
        seed=args.seed,
        fault=FaultConfig(policy=args.fault_policy),
    )
    trainer = Trainer(cfg, rcfg, tcfg, seq_len=args.seq_len,
                      global_batch=args.batch, device=args.device)
    t0 = time.time()
    state = trainer.run()
    dt = time.time() - t0
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    print(json.dumps({
        "arch": cfg.name,
        "steps": int(state["step"]),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": round(dt, 2),
        "replays": trainer.stats.replays,
        "skipped": trainer.stats.skipped,
    }, indent=1))


if __name__ == "__main__":
    main()
