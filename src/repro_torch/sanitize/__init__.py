"""repro_torch.sanitize — static descriptor-program analyzer (the port of
`repro.sanitize`: host NumPy over `repro_torch.core`, as the reference
is over `repro.core`; its reports equal the reference's).

A race detector and misconfiguration linter that runs *without
executing*: descriptor programs (`DescriptorBatch` submissions, engine
drains, `CollectiveFabric` phases) are swept for memory hazards with a
vectorized interval sweep-line (`hazards`), engine specs are audited
for silently-inert configuration (`speccheck`), and plan-cache replays
are re-derived and compared against from-scratch lowering
(`planaudit`).  Diagnostics carry stable codes (``H0xx`` hazards,
``S0xx`` spec warnings, ``P0xx`` plan-replay unsoundness — see
`diagnostics.CODES`).

Verdicts are differentially validated by `repro_torch.verify`: the engine's
adversarial drain-schedule mode permutes cross-channel service order
under a seed, and property tests assert sanitizer-clean programs are
byte-identical under every tried permutation while flagged racy
programs actually diverge (or are classified as benign same-value
writes).

Run the CLI:

    python -m repro_torch.sanitize --demo       # racy two-channel example
    python -m repro_torch.sanitize --corpus     # audit the in-repo programs
"""

from .diagnostics import (CODES, Access, Diagnostic, Report,
                          SanitizeError, severity)
from .hazards import (Unit, as_batch, channel_units, check_batch,
                      check_engine, check_phase, check_units)
from .planaudit import audit_nd_plan, audit_plan, audit_replay
from .speccheck import check_spec

__all__ = [
    "CODES", "Access", "Diagnostic", "Report", "SanitizeError", "severity",
    "Unit", "as_batch", "channel_units", "check_batch", "check_engine",
    "check_phase", "check_units",
    "audit_nd_plan", "audit_plan", "audit_replay",
    "check_spec",
]
