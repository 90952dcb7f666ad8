"""repro_torch.verify — constrained-random differential exerciser (the
port of `repro.verify`: the same programs for the same seeds, over
`repro_torch.core`, `repro_torch.dist` and `repro_torch.serve.sched`).

The verification layer of this repo's iDMA reproduction: a seeded
constrained-random descriptor-program generator (`generator`), a
differential harness that runs every generated program through the
engine's vectorized batch path — ``execute_batch`` / ``simulate_channels``,
plan cache on *and* off, interrupt front-end reconfigured — against an
independent scalar oracle built on ``execute`` and ``simulate_reference``
(`harness`), and an automatic shrinker that reduces any diverging program
to a minimal reproducer (`shrink`).

Programs exercise the paper's §2.3 error-handler verbs end to end via
deterministic seeded fault injection (`core.backend.FaultSite`): transient
read errors recovered by replay, persistent faults driving
replay-exhaustion / abort / continue, and mid-transfer channel stalls
surfaced as backoff cycles.

The `adversary` module differentially validates `repro_torch.sanitize`'s
static hazard verdicts: sanitizer-clean programs must be byte-identical
under every adversarial drain schedule, and the deliberately-racy
program family (`generator.generate_racy_program`) must be flagged with
the expected code *and* observably diverge.

Run it:

    python -m repro_torch.verify --seeds 200
    python -m repro_torch.verify --seeds 200 --differential
"""

from .adversary import (SCHEDULES, benign_same_value, check_differential,
                        check_racy_program, check_racy_seed, run_bytes,
                        sanitize_verdict)
from .generator import (FAMILIES, RACY_KINDS, Program, Row, Submission,
                        generate_program, generate_racy_program, fill_mem)
from .harness import (Divergence, EngineRun, check_program, run_engine,
                      run_oracle)
from .shrink import shrink_program

__all__ = [
    "FAMILIES", "RACY_KINDS", "Program", "Row", "Submission",
    "generate_program", "generate_racy_program", "fill_mem",
    "Divergence", "EngineRun", "check_program", "run_engine", "run_oracle",
    "shrink_program",
    "SCHEDULES", "benign_same_value", "check_differential",
    "check_racy_program", "check_racy_seed", "run_bytes",
    "sanitize_verdict",
]
