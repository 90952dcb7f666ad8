"""Debug tool: list a cell's heaviest collectives per rank, at full depth,
with the site that issued each, so perf iterations know what to attack
(the port's twin of `repro.launch.debug_collectives`).  With `--bytes`,
the heaviest ops by HBM bytes instead.

A row is one site: the op, its local type, and in place of the
reference's `op_name` (the name stack of its traced functions) the chain
of the port's functions on the Python stack when the op ran, or in the
backward the autograd node that ran it.  The port's models call their
layers as functions, not as modules, so `ModuleTracker` would name no
module below the step.  Identical sites are grouped, with their
multiplicity `x M` at full depth by the dry-run's depth rule
(`launch.dryrun.depth_plan`), as the reference weights a site by its
trip count.

Usage (from the repository root, `PYTHONPATH=src`):
  python -m repro_torch.launch.debug_collectives --arch gemma2-2b \\
      --shape train_4k [--multi-pod] [--no-sp] [--top 25] [--bytes]
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Dict, List, Tuple

from repro_torch.configs import get
from repro_torch.configs.base import RunConfig
from repro_torch.launch.dryrun import depth_plan, production_mesh, trace_cell


def site_rows(arch: str, shape: str, multi_pod: bool = False,
              sp: bool = True, by_bytes: bool = False
              ) -> List[Tuple[float, str, str, str, float]]:
    """(bytes at full depth, op, local type, site, multiplicity) of every
    site of a cell, heaviest first: its collectives, or with `by_bytes`
    every op's HBM bytes."""
    cfg = get(arch)
    mesh = production_mesh(multi_pod)
    rcfg = RunConfig(kernels="xla", sequence_parallel=sp)
    plan, _ = depth_plan(cfg)
    sums: Dict[Tuple[str, str, str], List[float]] = defaultdict(
        lambda: [0.0, 0.0])
    for variant, weight in plan:
        _, mode, _, _ = trace_cell(variant, shape, mesh, rcfg,
                                   collect_top=int(by_bytes),
                                   collect_sites=not by_bytes)
        for nbytes, op, type_str, site in (mode.byte_rows if by_bytes
                                           else mode.coll_rows):
            row = sums[(op, type_str, site)]
            row[0] += weight * nbytes
            row[1] += weight
    rows = [(b, op, t, site, m) for (op, t, site), (b, m) in sums.items()
            if m > 0.5]
    rows.sort(key=lambda r: -r[0])
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--bytes", action="store_true",
                    help="rank by HBM bytes instead of collective bytes")
    args = ap.parse_args(argv)

    rows = site_rows(args.arch, args.shape, args.multi_pod, not args.no_sp,
                     args.bytes)
    total = sum(r[0] for r in rows)
    kind = "HBM" if args.bytes else "collective"
    print(f"total weighted {kind} bytes/device: {total/1e9:.2f} GB "
          f"({len(rows)} sites)")
    for b, op, t, site, m in rows[:args.top]:
        print(f"  {b/1e9:8.3f} GB  x{m:<5.0f} {op:20s} {t[:60]:60s} "
              f"{site[:110]}")


if __name__ == "__main__":
    main()
