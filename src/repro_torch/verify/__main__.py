"""CLI: ``python -m repro_torch.verify --seeds N``.

Runs N seeded constrained-random programs through the differential
harness (engine batch path + plan cache + interrupt front-end vs the
scalar oracle).  Any divergence is shrunk to a minimal reproducer and
printed; the exit code is non-zero iff a divergence survived.
"""

from __future__ import annotations

import argparse
import sys

from .adversary import check_differential, check_racy_program
from .collective import (check_collective_program,
                         generate_collective_program,
                         shrink_collective_program)
from .generator import FAMILIES, generate_program, generate_racy_program
from .harness import check_program
from .serve import (check_serve_program, generate_serve_program,
                    shrink_serve_program)
from .shrink import shrink_program
from .vm import (check_vm_program, generate_vm_program, shrink_vm_program)

#: the full family rotation: every engine family from the generator plus
#: the multi-engine collective-fabric family, the deliberately-racy
#: sanitizer-validation family, the virtual-memory translation family
#: and the continuous-batching serve family (seed % len picks one —
#: vm lands on seed % 9 == 7, serve on seed % 9 == 8)
ALL_FAMILIES = FAMILIES + ("collective", "racy", "vm", "serve")


def _run_one(seed, family, differential=False, storm=False):
    """Generate + check one seed; returns (program, divergence, shrinker).
    ``seed % len(ALL_FAMILIES)`` rotates through the scalar-oracle engine
    families AND the multi-engine collective family AND the racy family
    (whose check is the sanitizer contract, not the scalar oracle).

    ``differential`` swaps the oracle check for the sanitizer's
    schedule-invariance contract (`adversary.check_differential`) on the
    engine families; the rotation then skips collectives (no drain
    schedule to permute) and racy programs keep their own contract.
    """
    rotation = (FAMILIES + ("racy",)) if differential else ALL_FAMILIES
    fam = family or rotation[seed % len(rotation)]
    if fam == "serve":
        program = generate_serve_program(seed)
        return program, check_serve_program(program), shrink_serve_program
    if fam == "vm":
        program = generate_vm_program(seed, storm=storm)
        return program, check_vm_program(program), shrink_vm_program
    if fam == "collective":
        program = generate_collective_program(seed)
        return program, check_collective_program(program), \
            shrink_collective_program
    if fam == "racy":
        program, expected = generate_racy_program(seed)

        def check_racy(p, expected=expected):
            return check_racy_program(p, expected)

        def shrink_racy(p, d, budget=200):
            return shrink_program(p, d, budget=budget, check=check_racy)

        return program, check_racy(program), shrink_racy
    program = generate_program(seed, family=fam)
    if differential:

        def shrink_diff(p, d, budget=200):
            return shrink_program(p, d, budget=budget,
                                  check=check_differential)

        return program, check_differential(program), shrink_diff
    return program, check_program(program), shrink_program


def run_seeds(seeds, family=None, do_shrink=True, fail_fast=False,
              log=print, differential=False, storm=False):
    """Exercise every seed; returns (stats dict, list of divergences)."""
    totals = {"programs": 0, "submissions": 0, "rows": 0, "faults": 0,
              "collectives": 0, "requests": 0}
    divergences = []
    for seed in seeds:
        program, d, shrinker = _run_one(seed, family,
                                        differential=differential,
                                        storm=storm)
        totals["programs"] += 1
        totals["rows"] += program.num_rows
        if getattr(program, "family", None) == "serve":
            totals["requests"] += len(program.requests)
        elif hasattr(program, "submissions"):
            totals["submissions"] += len(program.submissions)
            totals["faults"] += len(program.fault_sites)
        else:
            totals["collectives"] += 1
            totals["faults"] += sum(len(s) for s in
                                    program.fault_sites.values())
        if d is None:
            continue
        log(f"seed {seed}: {d}")
        if do_shrink:
            small, small_d = shrinker(program, d)
            log("shrunk to minimal reproducer:")
            log(str(small_d))
        divergences.append(d)
        if fail_fast:
            break
    return totals, divergences


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="constrained-random differential exerciser")
    parser.add_argument("--seeds", type=int, default=50,
                        help="number of seeded programs to run")
    parser.add_argument("--start", type=int, default=0,
                        help="first seed (seeds run [start, start+N))")
    parser.add_argument("--family", choices=list(ALL_FAMILIES), default=None,
                        help="pin every program to one engine family")
    parser.add_argument("--replay", type=int, default=None, metavar="SEED",
                        help="re-run a single seed verbosely and exit")
    parser.add_argument("--fail-fast", action="store_true",
                        help="stop at the first divergence")
    parser.add_argument("--no-shrink", action="store_true",
                        help="report divergences without shrinking")
    parser.add_argument("--storm", action="store_true",
                        help="fault-storm mode: crank the vm family's"
                             " unmapped-page rate (only affects vm-family"
                             " programs)")
    parser.add_argument("--differential", action="store_true",
                        help="check the sanitizer contract (clean programs"
                             " are drain-schedule-invariant; racy-family"
                             " programs are flagged and diverge) instead"
                             " of the scalar-oracle equivalences")
    args = parser.parse_args(argv)

    if args.replay is not None:
        program, d, shrinker = _run_one(args.replay, args.family,
                                        differential=args.differential,
                                        storm=args.storm)
        print(program.describe())
        if d is None:
            print(f"seed {args.replay}: PASS")
            return 0
        print(str(d))
        if not args.no_shrink:
            _, small_d = shrinker(program, d)
            print("shrunk to minimal reproducer:")
            print(str(small_d))
        return 1

    seeds = range(args.start, args.start + args.seeds)
    totals, divergences = run_seeds(
        seeds, family=args.family, do_shrink=not args.no_shrink,
        fail_fast=args.fail_fast, differential=args.differential,
        storm=args.storm)
    print(f"{totals['programs']} programs "
          f"({totals['submissions']} submissions, {totals['rows']} rows, "
          f"{totals['faults']} fault sites, "
          f"{totals['requests']} serve requests): "
          f"{len(divergences)} divergence(s)")
    return 1 if divergences else 0


if __name__ == "__main__":
    sys.exit(main())
