"""Diagnostic model of the descriptor-program sanitizer.

Every finding is a `Diagnostic` with a stable code.  ``H``-codes are
memory hazards (errors: executing the program has an unspecified
outcome), ``P``-codes are plan-cache replay unsoundness (errors: the
frozen plan no longer matches a from-scratch lowering), ``S``-codes are
spec misconfigurations (warnings: the composition runs, but not the way
its parameters suggest).

Code table
----------

====== ====================================================================
H001   read-after-write: an unordered row reads bytes an earlier row writes
H002   write-after-write: two unordered rows write overlapping bytes
H003   cross-channel race: overlapping bytes touched from two channels
       of one drain (no cross-channel byte-ordering guarantee)
H004   write-after-read: an unordered row overwrites bytes an earlier
       row reads
H005   intra-descriptor overlap: one row's source and destination
       windows overlap in the same address space
H006   cross-engine race: overlapping bytes touched from two engines
       sharing one memory map in the same fabric phase
H007   virtual-address aliasing: translation maps two virtual pages onto
       one physical page, so a program disjoint on the virtual plane
       races on the physical plane
S001   plan cache configured on an unplannable composition — every
       submission bypasses it
S002   plan cache configured with a multi-port back-end split — every
       submission bypasses it
S003   back-end declares a protocol port with no backing address space
S004   interrupt controller has more vectors than submission channels
S005   replay error policy with max_replays=0 — the replay verb can
       never retry, behaves as abort
P001   plan replay structural mismatch: the rebound frozen stream is not
       the stream a from-scratch lowering emits for the new addresses
P002   rebound plan stream fails the legalizer's legality gate
P003   stale TLB translation: a cached translation entry disagrees with
       the current page table (missed shootdown)
====== ====================================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["CODES", "Access", "Diagnostic", "Report", "SanitizeError",
           "severity"]

#: one-line summary per diagnostic code (the module docstring's table)
CODES: Dict[str, str] = {
    "H001": "read-after-write between unordered rows",
    "H002": "write-after-write between unordered rows",
    "H003": "cross-channel race within one drain",
    "H004": "write-after-read between unordered rows",
    "H005": "intra-descriptor src/dst overlap",
    "H006": "cross-engine race within one fabric phase",
    "H007": "virtual-address aliasing onto one physical page",
    "S001": "plan cache on unplannable composition (always bypassed)",
    "S002": "plan cache with multi-port back-end split (always bypassed)",
    "S003": "declared protocol port without a backing address space",
    "S004": "more interrupt vectors than channels",
    "S005": "replay policy with max_replays=0 (behaves as abort)",
    "P001": "plan replay structural mismatch",
    "P002": "rebound plan stream fails legality",
    "P003": "stale TLB translation vs current page table",
}


def severity(code: str) -> str:
    """``"error"`` for hazard/plan codes, ``"warning"`` for spec codes."""
    return "warning" if code.startswith("S") else "error"


@dataclass(frozen=True)
class Access:
    """One side of a hazard: a single row's read or write interval."""

    unit: int          # index into the checked unit list
    row: int           # row index within that unit's batch
    op: str            # "read" | "write"
    start: int         # interval start (byte address, half-open)
    end: int           # interval end
    src: int           # the row's source address
    dst: int           # the row's destination address
    length: int        # the row's transfer length
    gen_src: bool      # source is a generator pseudo-protocol (no read)
    engine: int = 0
    channel: int = -1

    def describe(self) -> str:
        where = f"unit[{self.unit}]"
        if self.engine:
            where += f" eng{self.engine}"
        if self.channel >= 0:
            where += f" ch{self.channel}"
        return (f"{where} row {self.row} {self.op}s "
                f"[{self.start:#x}, {self.end:#x})")


@dataclass(frozen=True)
class Diagnostic:
    """One sanitizer finding."""

    code: str
    message: str
    space: Optional[str] = None          # protocol name of the overlap
    window: Optional[Tuple[int, int]] = None   # overlapping byte window
    a: Optional[Access] = None
    b: Optional[Access] = None

    @property
    def severity(self) -> str:
        return severity(self.code)

    def __str__(self) -> str:
        loc = f" [{self.space}]" if self.space else ""
        return f"{self.code}{loc}: {self.message}"


@dataclass
class Report:
    """The outcome of one sanitizer pass.

    ``clean`` is True when no *error*-severity diagnostic survived —
    warnings (S-codes) never fail a program, and codes listed in
    ``suppressed`` were dropped (with counts kept for transparency).
    """

    diagnostics: List[Diagnostic] = field(default_factory=list)
    checked_rows: int = 0
    suppressed: Dict[str, int] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not any(d.severity == "error" for d in self.diagnostics)

    @property
    def codes(self) -> Tuple[str, ...]:
        return tuple(sorted({d.code for d in self.diagnostics}))

    def has(self, code: str) -> bool:
        return any(d.code == code for d in self.diagnostics)

    def select(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def merge(self, other: "Report") -> "Report":
        self.diagnostics.extend(other.diagnostics)
        self.checked_rows += other.checked_rows
        for code, n in other.suppressed.items():
            self.suppressed[code] = self.suppressed.get(code, 0) + n
        self.notes.extend(other.notes)
        return self

    def format(self, limit: int = 20) -> str:
        head = ("clean" if self.clean else "HAZARDOUS")
        lines = [f"sanitize: {head} — {self.checked_rows} rows, "
                 f"{len(self.diagnostics)} diagnostic(s)"]
        for d in self.diagnostics[:limit]:
            lines.append(f"  {d}")
        if len(self.diagnostics) > limit:
            lines.append(f"  ... {len(self.diagnostics) - limit} more")
        for code, n in sorted(self.suppressed.items()):
            lines.append(f"  suppressed {code} x{n} ({CODES[code]})")
        for note in self.notes:
            lines.append(f"  note: {note}")
        return "\n".join(lines)


class SanitizeError(RuntimeError):
    """Raised by ``sanitize="raise"`` wiring when a program is flagged."""

    def __init__(self, report: Report) -> None:
        super().__init__(report.format())
        self.report = report


def normalize_suppress(suppress: Sequence[str]) -> Tuple[str, ...]:
    """Validate a suppression list against the known code table."""
    out = tuple(suppress)
    for code in out:
        if code not in CODES:
            raise ValueError(f"unknown diagnostic code {code!r} "
                             f"(known: {sorted(CODES)})")
    return out
