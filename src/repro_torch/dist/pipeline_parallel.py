"""GPipe-style pipeline parallelism over a ``'stage'`` mesh dim (the port
of `repro.dist.pipeline_parallel` on `torch.distributed`).

Each rank holds one stage's parameters; microbatches stream through the
pipeline by ring shifts over ``M + S - 1`` ticks.  The schedule is the
classic fill/steady/drain trapezoid, so `pipeline_bubble` gives its idle
fraction: ``(S - 1) / (M + S - 1)``.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["pipeline_bubble", "stack_stage_params", "gpipe"]


def pipeline_bubble(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: ``(S-1) / (M + S - 1)``."""
    s, m = int(num_stages), int(num_microbatches)
    if s < 1 or m < 1:
        raise ValueError("pipeline_bubble needs stages >= 1 and "
                         "microbatches >= 1")
    return (s - 1) / (m + s - 1)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _map(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, item) for item in tree)
    return fn(tree)


def stack_stage_params(stage_params_list):
    """Stack a list of per-stage parameter trees (dicts, lists and tuples
    of tensors) leaf-wise into one tree with a leading stage axis — the
    layout `gpipe` takes one stage a rank from."""
    import torch

    def stack(*leaves):
        return torch.stack(leaves)

    first = stage_params_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in stage_params_list])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params(list(xs))
                           for xs in zip(*stage_params_list))
    return stack(*stage_params_list)


def _stage_slice(a, i: int):
    """This rank's stage of a stacked leaf: the local shard's one row of a
    DTensor sharded on the stage dim, else row `i`."""
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        local = a.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stacked DTensor leaf must hold one stage "
                             f"a rank, not {local.shape[0]}")
        return local[0]
    return a[i]


def gpipe(stage_fn: Callable, mesh, axis: str = "stage") -> Callable:
    """Build ``fn(stacked_params, x) -> y`` running ``stage_fn(w, mb)``
    as a GPipe pipeline over the ``axis`` mesh dim.

    ``stacked_params`` carries a leading stage axis (`stack_stage_params`),
    either whole on every rank or as DTensors sharded one stage a rank;
    ``x`` is ``(M, ...)`` microbatched and the same on every rank, and
    ``stage_fn`` keeps a microbatch's shape.  Each tick stage 0 takes
    microbatch t, every stage runs, and the activations ring-shift
    stage → stage + 1 with `batch_isend_irecv` (a blocking send around
    the ring would deadlock); the last stage writes microbatch
    t − (S − 1), and a final all-reduce over the stage group replicates
    the ``(M, ...)`` result (the other stages add zeros, which is
    exact).  With one stage no point-to-point call is made.
    """
    import torch
    import torch.distributed as dist

    def fn(stacked_params, x):
        group = mesh.get_group(axis)
        ranks = dist.get_process_group_ranks(group)
        num_stages = len(ranks)
        i = ranks.index(dist.get_rank())
        w = _map(lambda a: _stage_slice(a, i), stacked_params)
        num_micro = x.shape[0]
        outs = torch.zeros_like(x)
        cur = torch.zeros_like(x[0])
        nxt_rank = ranks[(i + 1) % num_stages]
        prv_rank = ranks[(i - 1) % num_stages]
        for t in range(num_micro + num_stages - 1):
            inp = x[min(t, num_micro - 1)] if i == 0 else cur
            y = stage_fn(w, inp)
            if num_stages > 1:
                cur = torch.empty_like(y)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt_rank, group),
                    dist.P2POp(dist.irecv, cur, prv_rank, group)])
                for r in reqs:
                    r.wait()
            m = t - (num_stages - 1)
            if i == num_stages - 1 and 0 <= m < num_micro:
                outs[m] = y
        if num_stages > 1:
            dist.all_reduce(outs, group=group)
        return outs

    return fn
