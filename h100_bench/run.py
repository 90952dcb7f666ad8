"""The benchmark of the PyTorch and CUDA port: one run of one cell.

  python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout.  It loads the cell's model with weights
drawn from the seed, warms up, serves the cell's traffic for `--seconds`
through `ServeEngine.generate`, checks a sample of what it served
against the plain reference, and prints one JSON line: the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics (from a
profiled slice of the window) with `--trace 1`.  The numbers the check
compared, each with its limit, end the line and standard error.  It
exits non-zero, and prints no result, without a CUDA device, outside a
checkout of the repository, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch beside {HERE.name}: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    # the profiler of a traced run tears CUPTI down when it stops: left up,
    # it slows every later launch by about a third
    os.environ["TEARDOWN_CUPTI"] = "1"
    # every cache of the program inside the checkout, at a fixed path
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from h100_bench import bench

    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    chips = next((w["chips"] for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    line = bench.run(spec, args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0), T0)
    loaded = bench.jax_loaded()
    if loaded:
        print(f"the process holds the modules {loaded} after the window: "
              f"the port must run without JAX", file=sys.stderr)
        return 3
    for what, c in line["compared"].items():
        print(f"{what} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
