"""S0xx: static `EngineSpec` misconfiguration checks.

These are warnings, not errors: every flagged composition constructs and
runs, but a parameter is silently inert or behaves differently than its
name suggests.  The checks only use the spec dataclasses — nothing is
built or executed.
"""

from __future__ import annotations

from repro_torch.core.descriptor import GENERATOR_PROTOCOLS
from repro_torch.core.spec import EngineSpec

from .diagnostics import Diagnostic, Report

__all__ = ["check_spec"]


def check_spec(spec: EngineSpec) -> Report:
    """Audit one `EngineSpec` for silently-inert configuration."""
    report = Report()
    diags = report.diagnostics

    if spec.plan_cache:
        unsigned = [st.name for st in spec.midend
                    if st.signature() is None]
        if unsigned:
            diags.append(Diagnostic(
                code="S001",
                message=(f"plan_cache={spec.plan_cache!r} but pipeline "
                         f"stage(s) {unsigned} carry no structural "
                         f"signature — every submission bypasses the "
                         f"cache (EngineStats.plan_bypasses)")))
        if spec.backend.num_ports > 1:
            diags.append(Diagnostic(
                code="S002",
                message=(f"plan_cache={spec.plan_cache!r} with a "
                         f"{spec.backend.num_ports}-port back-end split — "
                         f"multi-port lowering is not plan-cacheable, "
                         f"every submission bypasses the cache")))

    if spec.mem_spaces:
        have = {p for p, _ in spec.mem_spaces}
        missing = [p for p in spec.backend.protocols
                   if p not in have and p not in GENERATOR_PROTOCOLS]
        if missing:
            diags.append(Diagnostic(
                code="S003",
                message=(f"back-end declares protocol port(s) "
                         f"{[p.value for p in missing]} but mem_spaces "
                         f"provides no backing space — any transfer "
                         f"touching them faults at run time")))

    if spec.irq.vectors and spec.irq.vectors > spec.channels.count:
        diags.append(Diagnostic(
            code="S004",
            message=(f"irq.vectors={spec.irq.vectors} exceeds "
                     f"channels.count={spec.channels.count} — the extra "
                     f"vectors can never be targeted")))

    pol = spec.backend.error_policy
    if pol.action == "replay" and pol.max_replays == 0:
        diags.append(Diagnostic(
            code="S005",
            message=("error policy 'replay' with max_replays=0 — the "
                     "first replay attempt already exhausts the budget, "
                     "so the verb degenerates to abort")))

    return report
