"""Readings that the check's limits are set from, at a cell's own sizes.

  python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,... \
      [--control-seeds 7,8,9] [--out FILE]

In one process (the model is built once, its weights drawn again for
every seed), each seed serves one whole batch of the cell's traffic
through the timed path and is checked as a run checks it (`check.judge`:
the sound readings).  On the control seeds the control is read as well:
the same prompts and tokens through the reference with float8 e4m3
products, and judged by the cell's own comparison and limits
(`bench.compare`), which has to find it not correct.  One JSON line a
seed, then each number's lower reading (the largest of the sound runs,
control seeds' included) and upper reading (the smallest of the
control's), for every number the cell's limits compare.  It exits 1 if
a sound seed is not correct or a control seed is.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(c, device, seeds: List[int], controls: List[int]) -> Dict:
    """Each seed's judged numbers (`rows`), and each number the cell's
    limits compare: its lower reading (the sound runs') and its upper
    (the control's, where the control reads it)."""
    from h100_bench import bench, check

    s = None
    rows = []
    for seed in seeds + controls:
        t = time.perf_counter()
        if s is None:
            s = bench.Session(c.cfg, c.mix, device, seed)
            s.warm_up()
        else:
            s.reseed(seed)
        cap = s.capture()
        result = s.window(float("inf"), cap, max_batches=1)
        judged = s.judge(result, cap, control=seed in controls,
                         limits=c.limits)
        row = dict(seed=seed, **judged,
                   correct=bench.compare(judged, c.limits)[1])
        if seed in controls:
            row["control_correct"] = bench.compare(
                check.as_control(judged), c.limits)[1]
        row.update(seconds=time.perf_counter() - t,
                   batch_seconds=result.seconds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": c.name, "rows": rows}
    for num in c.limits:
        if num == "readings":
            continue
        ctl = check.control_of(num)
        summary[num] = {"lower": max(r[num] for r in rows),
                        "upper": min((r[ctl] for r in rows if ctl in r),
                                     default=None)}
    summary["sound_not_correct"] = [r["seed"] for r in rows
                                    if not r["correct"]]
    summary["control_correct"] = [r["seed"] for r in rows
                                  if r.get("control_correct")]
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from h100_bench import bench, families
    from repro_torch.kernels import runtime

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    c = bench.cell(spec, args.workload)
    dev = torch.device("cuda", 0)
    runtime.build(families.of(c.cfg).kernels(c.cfg))
    summary = readings(c, dev, [int(x) for x in args.seeds.split(",") if x],
                       [int(x) for x in args.control_seeds.split(",") if x])
    summary["device"] = torch.cuda.get_device_name(dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 1 if summary["sound_not_correct"] or \
        summary["control_correct"] else 0


if __name__ == "__main__":
    sys.exit(main())
