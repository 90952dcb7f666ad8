"""Automatic shrinking of diverging programs to minimal reproducers.

Delta-debugging over the program's structure: whole submissions first,
then rows within each submission, then fault sites, then per-row
simplifications (shorter lengths, dropped burst caps).  A reduction step
is kept only when the reduced program still produces a divergence of the
*same kind* — shrinking an address-bounds divergence must not wander off
into an unrelated cycle mismatch.

The number of harness executions is bounded (`budget`): shrinking is a
debugging aid, not a proof search.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from .generator import Program, Row
from .harness import Divergence, check_program


def _still_fails(program: Program, kind: str,
                 spent: List[int], budget: int,
                 check: Callable[[Program], Optional[Divergence]]
                 = check_program) -> Optional[Divergence]:
    if spent[0] >= budget:
        return None
    spent[0] += 1
    try:
        d = check(program)
    except Exception:        # a reduced program must still *run*
        return None
    if d is not None and d.kind == kind:
        return d
    return None


def _ddmin(items: list, rebuild: Callable[[list], Program], kind: str,
           spent: List[int], budget: int,
           check: Callable[[Program], Optional[Divergence]]
           = check_program) -> list:
    """Classic ddmin: drop chunks (halving granularity) while the rebuilt
    program still diverges with the same kind."""
    chunk = max(1, len(items) // 2)
    while chunk >= 1 and len(items) > 1:
        i = 0
        reduced = False
        while i < len(items):
            trial = items[:i] + items[i + chunk:]
            if trial and _still_fails(rebuild(trial), kind, spent, budget,
                                      check):
                items = trial
                reduced = True
            else:
                i += chunk
        if not reduced:
            chunk //= 2
    return items


def shrink_program(program: Program, failure: Divergence,
                   budget: int = 200,
                   check: Callable[[Program], Optional[Divergence]]
                   = check_program) -> Tuple[Program, Divergence]:
    """Reduce `program` to a minimal reproducer of ``failure.kind``.

    Returns the smallest program found and its (re-verified) divergence.
    ``check`` is the oracle that decides whether a reduced program still
    fails — the default is the full differential `check_program`; the
    sanitizer's racy-program path passes a closure over
    `repro_torch.verify.adversary.check_racy_program` instead.
    """
    kind = failure.kind
    spent = [0]
    best = program
    best_d = failure

    def with_subs(subs: list) -> Program:
        return dataclasses.replace(best, submissions=list(subs))

    # 1. whole submissions
    subs = _ddmin(list(best.submissions), with_subs, kind, spent,
                  budget, check)
    d = _still_fails(with_subs(subs), kind, spent, budget, check)
    if d is not None:
        best = with_subs(subs)
        best_d = d

    # 2. rows within each surviving submission
    for si, sub in enumerate(best.submissions):
        if sub.kind != "batch" or len(sub.rows) <= 1:
            continue

        def with_rows(rows: list, si=si, sub=sub) -> Program:
            subs = list(best.submissions)
            subs[si] = dataclasses.replace(sub, rows=tuple(rows))
            return dataclasses.replace(best, submissions=subs)

        rows = _ddmin(list(sub.rows), with_rows, kind, spent,
                      budget, check)
        d = _still_fails(with_rows(rows), kind, spent, budget, check)
        if d is not None:
            best = with_rows(rows)
            best_d = d

    # 3. fault sites
    if best.fault_sites:

        def with_sites(sites: list) -> Program:
            return dataclasses.replace(best, fault_sites=list(sites))

        sites = list(best.fault_sites)
        i = 0
        while i < len(sites):
            trial = sites[:i] + sites[i + 1:]
            d = _still_fails(with_sites(trial), kind, spent, budget,
                             check)
            if d is not None:
                sites = trial
                best = with_sites(sites)
                best_d = d
            else:
                i += 1

    # 4. per-row simplification: shorter lengths, no burst caps
    for si, sub in enumerate(best.submissions):
        if sub.kind == "nd":
            continue
        for ri, row in enumerate(sub.rows):
            for simpler in _simpler_rows(row,
                                         best.spec.backend.bus_width):
                subs = list(best.submissions)
                rows = list(sub.rows)
                rows[ri] = simpler
                subs[si] = dataclasses.replace(
                    dataclasses.replace(sub), rows=tuple(rows))
                trial = dataclasses.replace(best, submissions=subs)
                d = _still_fails(trial, kind, spent, budget, check)
                if d is not None:
                    best = trial
                    best_d = d
                    sub = subs[si]
                    break

    return best, best_d


def _simpler_rows(row: Row, bus: int) -> List[Row]:
    out = []
    if row.max_burst:
        out.append(dataclasses.replace(row, max_burst=0))
    for length in (bus, 1):
        if row.length > length:
            out.append(dataclasses.replace(row, length=length))
    return out
