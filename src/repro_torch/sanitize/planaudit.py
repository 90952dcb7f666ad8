"""P0xx: plan-cache replay soundness audit.

A `TransferPlan` freezes the legalized burst structure of one capture
and replays it onto new base addresses with a vectorized rebind.  The
residue-modulus signature (`core.plan.plan_signature`) is what makes
that sound — this module is the *independent check* of that argument:
given a cache hit's new addresses, re-derive the legalization from
scratch (spec pipeline + `legalize_batch`) and compare it column by
column against the rebound frozen stream.

* ``P001`` — structural mismatch: the rebound stream differs from the
  from-scratch lowering (wrong cut points, lengths, protocols, or
  ordering) — replaying this plan executes different bursts than the
  uncached path would;
* ``P002`` — the rebound stream fails `check_legal_batch`'s legality
  gate (a frozen cut that is illegal at the new addresses);
* ``P003`` — a value stage's translation cache (TLB) holds an entry
  that disagrees with the current page table: a replay through that
  stage would rebind onto a stale physical address.

Value stages (``stage.translates``) are audited on the **virtual
plane**: plans are captured through ``apply_structure`` (the engine
rebinds values after replay), so the from-scratch comparison lowers the
same way — translation values never enter the P001/P002 comparison,
only the P003 TLB audit sees them.

The audit costs one full lowering per call — it deliberately un-does the
cache's saving, which is why it only runs under the opt-in
``sanitize=`` engine mode (and in tests/CI over the plan corpus).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import DescriptorBatch
from repro_torch.core.descriptor import NdTransfer, Transfer1D
from repro_torch.core.legalizer import check_legal_batch, legalize_batch
from repro_torch.core.midend import tensor_nd_batch
from repro_torch.core.plan import (PlanCache, TransferPlan, nd_plan_signature,
                                   plan_signature)

from .diagnostics import Diagnostic, Report

__all__ = ["audit_plan", "audit_nd_plan", "audit_replay"]

#: legalized-stream columns compared burst-by-burst (everything that
#: shapes execution except the options column, which rebind freezes
#: verbatim from capture)
_COLUMNS = ("src_addr", "dst_addr", "length", "src_proto", "dst_proto",
            "owner", "max_burst", "reduce_len")


def _rebind_quiet(plan: TransferPlan, src, dst, tid) -> DescriptorBatch:
    """`TransferPlan.rebind` without skewing the replay counter — the
    audit observes the plan, it is not a served submission."""
    out = plan.rebind(src, dst, transfer_id=tid)
    plan.replays -= 1
    return out


def _audit_tlb(pipeline: Sequence, report: Report) -> None:
    """P003: ask every value stage that exposes ``audit_translations``
    to compare its TLB entries against a fresh page-table walk — stale
    entries mean a replay through this stage rebinds onto physical
    addresses the table no longer maps there (a missed shootdown)."""
    for stage in pipeline:
        audit = getattr(stage, "audit_translations", None)
        if audit is None:
            continue
        for space, vpn, cached, walked in audit():
            now = ("is unmapped in the current table" if walked is None
                   else f"now walks to ppn {walked:#x}")
            report.diagnostics.append(Diagnostic(
                code="P003",
                message=(f"stale TLB entry: {space} vpn {vpn:#x} cached "
                         f"as ppn {cached:#x} but {now} — replays "
                         f"through this stage use a dead translation")))


def _compare(rebound: DescriptorBatch, fresh: DescriptorBatch,
             report: Report) -> None:
    if len(rebound) != len(fresh):
        report.diagnostics.append(Diagnostic(
            code="P001",
            message=(f"rebound stream has {len(rebound)} bursts, "
                     f"from-scratch lowering emits {len(fresh)}")))
        return
    for col in _COLUMNS:
        a = getattr(rebound, col)
        b = getattr(fresh, col)
        bad = np.flatnonzero(a != b)
        if bad.size:
            i = int(bad[0])
            report.diagnostics.append(Diagnostic(
                code="P001",
                message=(f"column {col!r} diverges at burst {i}: "
                         f"rebound {a[i]!r} != fresh {b[i]!r} "
                         f"({bad.size} burst(s) differ)")))
            return


def audit_plan(plan: TransferPlan, batch: DescriptorBatch,
               bus_width: int = 8, pipeline: Sequence = ()) -> Report:
    """Audit one plan against one (hit) submission batch: the rebound
    frozen stream must equal the from-scratch lowering of ``batch`` and
    must pass the legality gate."""
    report = Report(checked_rows=len(batch))
    rebound = _rebind_quiet(plan, batch.src_addr, batch.dst_addr,
                            batch.transfer_id)
    fresh = batch
    for stage in pipeline:
        fresh = getattr(stage, "apply_structure", stage.apply)(fresh)
    fresh = legalize_batch(fresh, bus_width=bus_width)
    _compare(rebound, fresh, report)
    try:
        check_legal_batch(rebound, bus_width=bus_width)
    except Exception as err:
        report.diagnostics.append(Diagnostic(
            code="P002",
            message=f"rebound stream fails legality: {err}"))
    _audit_tlb(pipeline, report)
    return report


def audit_nd_plan(plan: TransferPlan, nd: NdTransfer, bus_width: int = 8,
                  pipeline: Sequence = ()) -> Report:
    """`audit_plan` for an N-D affine transfer template."""
    report = Report(checked_rows=1)
    rebound = _rebind_quiet(
        plan,
        np.asarray([nd.src_addr], dtype=np.int64),
        np.asarray([nd.dst_addr], dtype=np.int64),
        np.asarray([nd.transfer_id], dtype=np.int64))
    fresh = tensor_nd_batch(nd)
    for stage in pipeline:
        fresh = getattr(stage, "apply_structure", stage.apply)(fresh)
    fresh = legalize_batch(fresh, bus_width=bus_width)
    _compare(rebound, fresh, report)
    try:
        check_legal_batch(rebound, bus_width=bus_width)
    except Exception as err:
        report.diagnostics.append(Diagnostic(
            code="P002",
            message=f"rebound stream fails legality: {err}"))
    _audit_tlb(pipeline, report)
    return report


def audit_replay(cache: PlanCache, payload, bus_width: int = 8,
                 pipeline: Sequence = ()) -> Optional[Report]:
    """Audit a submission *if* it would hit the cache; ``None`` on a
    miss (a capture is trivially sound for its own addresses).  Peeks
    at the cache without touching hit/miss statistics or LRU order."""
    if isinstance(payload, NdTransfer):
        key = nd_plan_signature(payload, bus_width, pipeline=pipeline)
        plan = cache._plans.get(key)
        if plan is None:
            return None
        return audit_nd_plan(plan, payload, bus_width=bus_width,
                             pipeline=pipeline)
    if isinstance(payload, Transfer1D):
        payload = DescriptorBatch.from_transfers([payload])
    key = plan_signature(payload, bus_width, pipeline=pipeline)
    plan = cache._plans.get(key)
    if plan is None:
        return None
    return audit_plan(plan, payload, bus_width=bus_width,
                      pipeline=pipeline)
