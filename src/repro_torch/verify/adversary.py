"""Differential validation of the sanitizer's hazard verdicts.

`repro_torch.sanitize` claims a program is *clean* (no unordered overlapping
accesses) or *racy* (some hazard code).  This module checks both claims
against actual execution:

* **clean ⇒ schedule-invariant** — a clean program's memory image must
  be byte-identical under every adversarial drain schedule
  (`IDMAEngine.wait_all(schedule=...)` permutes cross-channel service
  order; per-channel FIFOs are preserved, which is exactly the ordering
  the sanitizer's model grants).  A clean program that diverges is a
  sanitizer false-negative — `check_differential` reports it as a
  ``sanitize-false-clean`` divergence;
* **racy ⇒ flagged and consequential** — every `generate_racy_program`
  must be flagged with its kind's expected code, and the hazard must be
  *real*: cross-channel kinds diverge across schedules, the intra-RAW
  kind diverges between the engine's binned vectorized execution and the
  scalar oracle — unless the overlapping writes carry identical bytes,
  which `benign_same_value` classifies explicitly instead of letting it
  rot as an unexplained pass.

Fault sites are stripped before scheduling experiments: fault ordinals
are drain-global, so permuting the drain legitimately moves which burst
faults — a byte difference that says nothing about memory hazards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import build_engine
from repro_torch.sanitize import Report, check_engine

from .generator import Program, fill_mem, generate_racy_program
from .harness import Divergence, EngineRun, _enqueue, run_engine

__all__ = ["SCHEDULES", "sanitize_verdict", "run_bytes",
           "check_differential", "benign_same_value",
           "check_racy_program", "check_racy_seed"]

#: the drain schedules every program is exercised under: the production
#: first-tid merge, its exact reversal (covers both orders of every
#: cross-channel pair), and two seeded random interleavings
SCHEDULES: Tuple = (None, "reverse", 0xD1CE, 0xFADE)


def _strip_faults(program: Program) -> Program:
    return dataclasses.replace(program, fault_sites=[])


def sanitize_verdict(program: Program) -> Report:
    """The sanitizer's static verdict on a program: build the engine,
    enqueue every submission, sweep the queues — nothing executes."""
    engine = build_engine(program.spec)
    fill_mem(engine.mem, program.mem_seed)
    _enqueue(engine, program)
    return check_engine(engine)


def run_bytes(program: Program, schedule=None) -> EngineRun:
    """One fault-free engine execution under a drain schedule."""
    return run_engine(_strip_faults(program), schedule=schedule)


def check_differential(program: Program) -> Optional[Divergence]:
    """The clean direction of the contract: a sanitizer-clean program
    must produce byte-identical memory under every schedule in
    `SCHEDULES`.  Returns ``None`` for clean-and-invariant *and* for
    flagged programs (a flagged program is allowed to diverge — that is
    what the flag means)."""
    report = sanitize_verdict(program)
    if not report.clean:
        return None
    base = run_bytes(program, schedule=None)
    for schedule in SCHEDULES[1:]:
        other = run_bytes(program, schedule=schedule)
        for proto, img in base.spaces.items():
            if other.spaces[proto] != img:
                return Divergence(
                    "sanitize-false-clean",
                    f"sanitizer passed the program clean but {proto} "
                    f"bytes diverge under schedule={schedule!r}",
                    program)
    return None


def benign_same_value(program: Program, report: Report) -> bool:
    """True iff *every* flagged write-write overlap moves identical
    bytes: for each H002/H003/H006 diagnostic, read both sides' source
    bytes over the overlap window out of the seeded initial memory image
    and compare.  Generator-sourced writes (no memory source to compare)
    and read-write hazards are never benign.  Conservative on
    multi-space programs (an `Access` does not carry its source space,
    so the comparison is only sound when there is exactly one)."""
    from repro_torch.core import MemoryMap, Protocol
    if len(program.spec.mem_spaces) != 1:
        return False
    mem = MemoryMap.create(dict(program.spec.mem_spaces))
    fill_mem(mem, program.mem_seed)

    checked = False
    for diag in report.diagnostics:
        if diag.severity != "error":
            continue
        if diag.a is None or diag.b is None or diag.window is None:
            return False
        if diag.a.op != "write" or diag.b.op != "write":
            return False       # read-write: order changes observed bytes
        lo, hi = diag.window
        space = next((p for p in Protocol if p.value == diag.space), None)
        if space is None:
            return False
        sides = []
        for acc in (diag.a, diag.b):
            if acc.gen_src:
                return False
            off = lo - acc.dst
            sides.append(np.asarray(
                mem.read(space, acc.src + off, hi - lo)))
        if not np.array_equal(sides[0], sides[1]):
            return False
        checked = True
    return checked


def check_racy_program(program: Program, expected_code: str
                       ) -> Optional[Divergence]:
    """The racy direction of the contract: the program must be flagged
    with ``expected_code``, and the hazard must actually matter."""
    report = sanitize_verdict(program)
    if report.clean:
        return Divergence(
            "sanitize-miss",
            f"racy program not flagged (expected {expected_code})",
            program)
    if not report.has(expected_code):
        return Divergence(
            "sanitize-wrong-code",
            f"racy program flagged {report.codes}, "
            f"expected {expected_code}",
            program)

    if expected_code == "H001":
        # intra-submission RAW: engine (binned gather-then-scatter) vs
        # the scalar oracle (row-sequential) disagree on the read bytes
        from .harness import run_oracle
        stripped = _strip_faults(program)
        eng = run_engine(stripped)
        orc = run_oracle(stripped)
        if all(eng.spaces[p] == orc.spaces[p] for p in eng.spaces):
            if benign_same_value(program, report):
                return None
            return Divergence(
                "sanitize-overclaim",
                "flagged intra-RAW program: engine and oracle bytes "
                "identical and overlap is not a benign same-value write",
                program)
        return None

    # cross-channel kinds: bytes must differ across drain schedules
    images = [run_bytes(program, schedule=s).spaces for s in SCHEDULES]
    base = images[0]
    if any(img[p] != base[p] for img in images[1:] for p in base):
        return None
    if benign_same_value(program, report):
        return None
    return Divergence(
        "sanitize-overclaim",
        f"flagged {expected_code} program: bytes identical under all "
        f"{len(SCHEDULES)} schedules and overlap is not a benign "
        f"same-value write",
        program)


def check_racy_seed(seed: int) -> Optional[Divergence]:
    """`generate_racy_program` + `check_racy_program` for one seed."""
    program, expected = generate_racy_program(seed)
    return check_racy_program(program, expected)
