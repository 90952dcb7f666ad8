"""Dry run of every (architecture × shape) cell on the production meshes:
build the cell on torch's fake process group, put its arguments on the
mesh as meta DTensors, count one call of its step, and write the
roofline JSON (the port's twin of `repro.launch.dryrun`).

Nothing is allocated and no kernel runs: the arguments live on the meta
device, and the cells take the plain attention and SSD
(`RunConfig(kernels="xla")`), as the reference's dry-run lowers them.
The mesh is (16, 16) data×model, or (2, 16, 16) pod×data×model with
`--multi-pod`, on the fake process group (`launch.specs.fake_mesh`);
this process's default group must be that one, so a caller that runs
NCCL starts the dry run in a child process.

The depth rule.  The reference weights each scanned layer's HLO by its
trip count; the port's step runs its layers in a Python loop, and
DTensor's dispatch of one full-width layer takes seconds (10.9 s for
qwen2-moe-a2.7b's train layer), so a full-depth count would take
minutes a cell.  `count_cell` counts the cell with every pattern entry
(and the encoder) at two repeats, or its own count where that is fewer,
then again with each longer entry at three, and takes every count as
affine in the repeats past two: base + Σ (reps − 2) × slope.  Two, not
one: the first and the last layer of a stack differ from the layers
between (the residual stream comes from the embedding into the first
and goes to the head from the last, in other layouts on a mesh), so one
layer, first and last at once, is no base to add middle layers to.
`while_trips` records the repeats.

Usage (from the repository root, `PYTHONPATH=src`):
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --cells gemma2-2b:train_4k,...
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import REGISTRY, get
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch.analysis import cell_result, model_flops, tree_bytes
from repro_torch.launch.hlo_cost import CostTotals, count_call
from repro_torch.launch.specs import build_cell, fake_mesh

DEFAULT_OUT = os.path.join("build", "dryrun_torch")
_MESHES: Dict[bool, object] = {}


def production_mesh(multi_pod: bool):
    """The (16, 16) or (2, 16, 16) mesh on the fake process group, made
    once a process (`launch.specs.fake_mesh`).  The group is made of 512
    ranks when this process has none; the (16, 16) mesh takes its first
    256."""
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = fake_mesh(
            (2, 16, 16) if multi_pod else (16, 16),
            ("pod", "data", "model") if multi_pod else ("data", "model"),
            world=512)
    return _MESHES[multi_pod]


# --------------------------------------------------------------------------
# Arguments onto the mesh
# --------------------------------------------------------------------------

def _distribute(tree, shards, mesh):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, torch.nn.Module):
        return shd.distribute_params(tree, mesh)
    if isinstance(tree, dict):
        return {k: _distribute(tree[k], shards[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_distribute(t, s, mesh)
                          for t, s in zip(tree, shards))
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, shards)
    return tree


def distribute_args(cell, mesh) -> tuple:
    """The cell's arguments on `mesh` by its `in_shardings`: a train
    state by `distribute_train_state` (its count and step stay plain), a
    batch by `distribute_batch`, a model's parameters by their rules,
    every other tensor by `distribute_tensor`; ints unchanged."""
    from repro_torch.train import distribute_train_state

    args = list(cell.args)
    if isinstance(args[0], dict) and "opt" in args[0]:
        return (distribute_train_state(args[0], mesh),
                shd.distribute_batch(args[1], mesh))
    return tuple(_distribute(a, s, mesh)
                 for a, s in zip(args, cell.in_shardings))


# --------------------------------------------------------------------------
# The count, and the depth rule
# --------------------------------------------------------------------------

def with_reps(cfg: ArchConfig, reps: List[int],
              enc_layers: Optional[int] = None) -> ArchConfig:
    """`cfg` with pattern entry i repeated reps[i] times (and the encoder
    at `enc_layers`)."""
    pattern = tuple((kinds, r) for (kinds, _), r in zip(cfg.pattern, reps))
    n = sum(len(kinds) * r for kinds, r in pattern)
    changes = dict(n_layers=n)
    if cfg.layer_pattern is not None:
        changes["layer_pattern"] = pattern
    if cfg.encoder is not None and enc_layers is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder,
                                                 n_layers=enc_layers)
    return dataclasses.replace(cfg, **changes)


def depth_plan(cfg: ArchConfig) -> Tuple[List[Tuple[ArchConfig, float]],
                                         List[Tuple[str, int]]]:
    """The depth rule as weights: ([(config traced, its weight)], the
    (entry, repeats) pairs), so that a full-depth count is Σ weight ×
    the count of its config.  The base holds every entry at min(reps, 2)
    (the encoder likewise) with weight 1 − Σ (reps − 2) over the entries
    past two; each of those is traced again at three, with weight
    reps − 2."""
    reps = [r for _, r in cfg.pattern]
    enc = cfg.encoder.n_layers if cfg.encoder is not None else None
    low = [min(r, 2) for r in reps]
    enc_low = min(enc, 2) if enc is not None else None
    plan, trips, w0 = [], [], 1.0
    for i, r in enumerate(reps):
        trips.append((f"pattern[{i}]", r))
        if r > 2:
            plan.append((with_reps(cfg, [3 if j == i else n
                                         for j, n in enumerate(low)],
                                   enc_low), float(r - 2)))
            w0 -= r - 2
    if enc is not None:
        trips.append(("encoder", enc))
        if enc > 2:
            plan.append((with_reps(cfg, low, 3), float(enc - 2)))
            w0 -= enc - 2
    return [(with_reps(cfg, low, enc_low), w0)] + plan, trips


def trace_cell(cfg: ArchConfig, shape_name: str, mesh, rcfg: RunConfig,
               **count_kw):
    """One call of the cell's step counted: (the counts, with the
    arguments' and result's bytes on a rank; the `CostMode`;
    build-and-distribute s; counted s)."""
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape_name, mesh, rcfg)
    args = distribute_args(cell, mesh)
    arg_bytes = tree_bytes(args)
    t1 = time.perf_counter()
    try:
        out, totals, mode = count_call(cell.fn, *args, **count_kw)
    finally:
        shd.set_hint_fn(None)
        shd.set_moe_mesh(None)
    nums = dict(totals.numbers(), argument_bytes=arg_bytes,
                output_bytes=tree_bytes(out))
    return nums, mode, t1 - t0, time.perf_counter() - t1


def count_cell(cfg: ArchConfig, shape_name: str, mesh, rcfg: RunConfig
               ) -> Tuple[CostTotals, Dict[str, float], float, float]:
    """The full-depth counts of a cell by the depth rule (`depth_plan`):
    (totals with `while_trips`, {argument_bytes, output_bytes}, build s,
    counted s)."""
    plan, trips = depth_plan(cfg)
    full: Dict[str, float] = {}
    lower = comp = 0.0
    for variant, weight in plan:
        nums, _, lo, co = trace_cell(variant, shape_name, mesh, rcfg)
        lower, comp = lower + lo, comp + co
        for k, v in nums.items():
            full[k] = full.get(k, 0.0) + weight * v
    totals = CostTotals.from_numbers(full)
    totals.while_trips = trips
    mem = {k: full[k] for k in ("argument_bytes", "output_bytes")}
    return totals, mem, lower, comp


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rcfg: RunConfig, out_dir: Optional[str],
             verbose: bool = True) -> dict:
    cfg = get(arch)
    mesh = production_mesh(multi_pod)
    mesh_desc = "x".join(str(s) for s in mesh.shape)
    n_dev = mesh.size()
    totals, mem, t_lower, t_compile = count_cell(cfg, shape_name, mesh,
                                                 rcfg)
    name = f"{cfg.name}:{shape_name}"
    result = cell_result(name, mesh_desc, n_dev, totals,
                         mem["argument_bytes"], mem["output_bytes"])
    shape = cfg.shape(shape_name)
    result["lower_s"] = t_lower
    result["compile_s"] = t_compile
    result["model_flops_global"] = model_flops(cfg, shape)
    result["shape"] = {"name": shape_name, "seq_len": shape.seq_len,
                       "global_batch": shape.global_batch,
                       "kind": shape.kind}
    result["run_config"] = {
        "sequence_parallel": rcfg.sequence_parallel,
        "remat": rcfg.remat, "microbatch": rcfg.microbatch,
        "attn_chunk_q": rcfg.attn_chunk_q, "attn_chunk_k": rcfg.attn_chunk_k,
    }

    if verbose:
        rl = result["roofline"]
        print(f"== {name} on {mesh_desc} ==")
        print(f"   build {t_lower:.1f}s count {t_compile:.1f}s "
              f"(repeats {totals.while_trips})")
        print(f"   memory: {result['memory']}")
        print(f"   cost: {result['cost']}")
        print(f"   collectives: {result['collectives']['bytes']}")
        print(f"   roofline: compute {rl['compute_s']:.4g}s  memory "
              f"{rl['memory_s']:.4g}s  collective {rl['collective_s']:.4g}s"
              f"  → {rl['bottleneck']}-bound")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = "pod2" if multi_pod else "pod1"
        suffix = ""
        if os.environ.get("REPRO_VARIANT"):
            suffix = "_" + os.environ["REPRO_VARIANT"]
        fname = f"{arch}_{shape_name}_{tag}{suffix}.json".replace("/", "-")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def summary_row(r: dict) -> str:
    """One cell's line of the summary table `main` prints: its three
    terms, bottleneck, model over counted flops, peak live GiB a rank
    and seconds (build and count)."""
    rl = r["roofline"]
    ratio = r["model_flops_global"] / r["n_devices"] / \
        rl["flops_per_device"]
    return (f"| {r['name']} | {rl['mesh']} | {rl['compute_s']:.4g} | "
            f"{rl['memory_s']:.4g} | {rl['collective_s']:.4g} | "
            f"{rl['bottleneck']} | {ratio:.3f} | "
            f"{r['memory']['temp_bytes'] / 2**30:.2f} | "
            f"{r['lower_s'] + r['compile_s']:.1f} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape cells")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel residual sharding")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--attn-chunk-q", type=int, default=1024)
    ap.add_argument("--attn-chunk-k", type=int, default=2048)
    ap.add_argument("--moe-reduce", default="combine_first",
                    choices=["psum", "scatter", "combine_first"])
    ap.add_argument("--moe-comm-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--ssm-tp", action="store_true")
    ap.add_argument("--ssd-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--decode-ring", type=int, default=128)
    ap.add_argument("--decode-kv-shard", default="auto",
                    choices=["auto", "heads", "seq"])
    ap.add_argument("--variant", default=None,
                    help="artifact suffix for perf-iteration runs")
    args = ap.parse_args(argv)

    if args.variant:
        os.environ["REPRO_VARIANT"] = args.variant
    rcfg = RunConfig(kernels="xla",
                     sequence_parallel=not args.no_sp,
                     microbatch=args.microbatch,
                     attn_chunk_q=args.attn_chunk_q,
                     attn_chunk_k=args.attn_chunk_k,
                     moe_reduce=args.moe_reduce,
                     moe_comm_dtype=args.moe_comm_dtype,
                     ssd_chunk=args.ssd_chunk,
                     ssd_compute_dtype=args.ssd_dtype,
                     ssm_head_tp=args.ssm_tp,
                     decode_kv_shard=args.decode_kv_shard,
                     decode_ring=args.decode_ring)

    cells = []
    if args.all:
        for name, cfg in sorted(REGISTRY.items()):
            for s in cfg.shapes:
                cells.append((name, s.name))
    elif args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --cells, --all)")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures, rows = [], []
    for arch, shape in cells:
        for mp in meshes:
            try:
                rows.append(summary_row(run_cell(arch, shape, mp, rcfg,
                                                 args.out)))
            except Exception as e:
                failures.append((arch, shape, mp, repr(e)))
                print(f"!! FAILED {arch}:{shape} multi_pod={mp}: {e}")
                traceback.print_exc()
    print("\n| cell | mesh | compute s | memory s | collective s | bound "
          "| model / counted flops | temp GiB a rank | s |")
    print("|---|---|---|---|---|---|---|---|---|")
    print("\n".join(rows))
    if failures:
        print(f"\n{len(failures)} cell(s) failed:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nAll {len(cells) * len(meshes)} dry-run cells passed.")


if __name__ == "__main__":
    main()
