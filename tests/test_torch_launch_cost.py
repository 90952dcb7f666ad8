"""The port's cost tools (`repro_torch.launch.hlo_cost`, `analysis`,
`dryrun`) against the reference's (`repro.launch.hlo_cost`, `analysis`).

  * the four programs of `tests/test_hlo_cost.py`, run in both packages:
    the reference compiled as that file builds them, the port counted on
    torch's fake process group of 8 ranks; the port exactly on the
    analytical counts, the reference's numbers beside them;
  * `model_flops` and `active_params` equal to the reference's for every
    arch × shape;
  * the dry-run's depth rule against a full trace, on a (2, 2) mesh of
    the fake group: reduced gemma2-2b train, mamba2-1.3b prefill and
    qwen2-moe-a2.7b decode at 3-4 repeats, every count equal (the peak
    of live bytes, a maximum, within 2%);
  * per-rank flops of reduced gemma2-2b's train and prefill cells on a
    (2, 2) mesh within 5% of the reference's `analyze_compiled` on 4 fake
    host devices;
  * one dry-run cell written by `run_cell` read by
    `benchmarks/roofline.py`'s `run`, with the reference's keys.

The port's side runs in one subprocess (one fake default group a
process), the reference's in another with 8 fake host devices; both
start together.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from repro.configs import REGISTRY as J_REGISTRY, get as j_get
from repro.launch import analysis as j_analysis
from repro_torch.configs import get
from repro_torch.launch import analysis
from test_torch_dist_mesh import REPO, spawn_reference, wait_all

N = 128
SCAN_FLOPS = 13 * 2 * N ** 3 + 2 * N ** 3
SCAN_TRANS = 13 * N * N
SHARDED_FLOPS = 2 * 256 * 256 * 512 / 8
COLL_FLOPS = 2 * 64 * 512 * 64 / 8
ALL_REDUCE_BYTES = 64 * 64 * 4
#: the reduced cells held against the reference's counts, (arch, kind)
CELLS = (("gemma2-2b", "train"), ("gemma2-2b", "prefill"))
#: the depth rule's cases: (arch, kind, repeats)
DEPTH = (("gemma2-2b", "train", 3), ("mamba2-1.3b", "prefill", 4),
         ("qwen2-moe-a2.7b", "decode", 3))
#: the keys of the reference's dry-run JSON (`repro/launch/dryrun.py`)
RESULT_KEYS = {"name", "mesh", "n_devices", "cost", "cost_raw", "memory",
               "collectives", "while_trips", "roofline", "lower_s",
               "compile_s", "model_flops_global", "shape", "run_config"}

COMMON = """
import dataclasses, json
SHAPES = {{"train": ("t", 128, 4), "prefill": ("p", 128, 4),
           "decode": ("d", 128, 4)}}
CELLS = {cells!r}
DEPTH = {depth!r}
out = {{}}


def small(cfg, kind, ShapeSpec):
    name, seq, batch = SHAPES[kind]
    return dataclasses.replace(
        cfg, shapes=(ShapeSpec(name, seq, batch, kind),)), name
"""

REFERENCE = COMMON + """
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get
from repro.configs.base import RunConfig, ShapeSpec, reduced
from repro.launch.analysis import analyze_compiled
from repro.launch.hlo_cost import analyze_hlo, shape_bytes
from repro.launch.specs import build_cell


def f(x, w):
    def body(c, wi):
        return jnp.tanh(c @ wi), None
    y, _ = jax.lax.scan(body, x, w)
    return y @ y.T


t = analyze_hlo(jax.jit(f).lower(
    jax.ShapeDtypeStruct((128, 128), jnp.float32),
    jax.ShapeDtypeStruct((13, 128, 128), jnp.float32)).compile().as_text())
out["scan"] = [t.flops, t.transcendentals, t.while_trips[0][1]]
mesh = jax.make_mesh((8,), ("model",))
with mesh:
    c = jax.jit(lambda a, b: a @ b,
                in_shardings=(NamedSharding(mesh, P(None, None)),
                              NamedSharding(mesh, P(None, "model")))).lower(
        jax.ShapeDtypeStruct((256, 256), jnp.float32),
        jax.ShapeDtypeStruct((256, 512), jnp.float32)).compile()
out["sharded"] = analyze_hlo(c.as_text()).flops
mesh = jax.make_mesh((8,), ("d",))
with mesh:
    c = jax.jit(lambda a, b: a @ b,
                in_shardings=(NamedSharding(mesh, P(None, "d")),
                              NamedSharding(mesh, P("d", None))),
                out_shardings=NamedSharding(mesh, P())).lower(
        jax.ShapeDtypeStruct((64, 512), jnp.float32),
        jax.ShapeDtypeStruct((512, 64), jnp.float32)).compile()
t = analyze_hlo(c.as_text())
out["collective"] = [t.flops, t.total_collective_bytes,
                     t.collective_bytes["all-reduce"]]
out["shape_bytes"] = [shape_bytes(s) for s in (
    "f32[128,1024]{{1,0}}", "bf16[16]", "(f32[8,4]{{1,0}}, pred[8])",
    "s32[]")]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     (jax.sharding.AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
for arch, kind in CELLS:
    cfg, shape = small(reduced(get(arch)), kind, ShapeSpec)
    cell = build_cell(cfg, shape, mesh, RunConfig(kernels="xla"))
    with mesh:
        comp = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings,
                       donate_argnums=cell.donate_argnums).lower(
            *cell.args).compile()
    out[f"{{arch}} {{kind}}"] = analyze_compiled(cell.name, "2x2", 4,
                                                 comp)["cost"]["flops"]
print("REFERENCE_JSON", json.dumps(out))
"""

PORT = COMMON + """
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get
from repro_torch.configs.base import (ATTN_FULL, ATTN_SWA, RunConfig,
                                      ShapeSpec, reduced)
from repro_torch.launch import analysis, dryrun, specs
from repro_torch.launch.hlo_cost import count_call, local_nbytes

dryrun.production_mesh(False)           # the fake group, 512 ranks
meta = torch.device("meta")


def f(x, w):
    c = x
    for i in range(w.shape[0]):
        c = torch.tanh(c @ w[i])
    return c @ c.T


_, t, _ = count_call(f, torch.empty(128, 128, device=meta),
                     torch.empty(13, 128, 128, device=meta))
out["scan"] = [t.flops, t.transcendentals]
m8 = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("model",))
a = distribute_tensor(torch.empty(256, 256, device=meta), m8, [Replicate()])
b = distribute_tensor(torch.empty(256, 512, device=meta), m8, [Shard(1)])
_, t, _ = count_call(lambda a, b: a @ b, a, b)
out["sharded"] = [t.flops, t.total_collective_bytes]
a = distribute_tensor(torch.empty(64, 512, device=meta), m8, [Shard(1)])
b = distribute_tensor(torch.empty(512, 64, device=meta), m8, [Shard(0)])
_, t, _ = count_call(
    lambda a, b: (a @ b).redistribute(m8, [Replicate()]), a, b)
out["collective"] = [t.flops, t.total_collective_bytes,
                     t.collective_bytes["all-reduce"],
                     t.collective_counts["all-reduce"]]
out["shape_bytes"] = [
    local_nbytes(torch.empty(128, 1024, device=meta)),
    local_nbytes(torch.empty(16, dtype=torch.bfloat16, device=meta)),
    local_nbytes(torch.empty(8, 4, device=meta))
    + local_nbytes(torch.empty(8, dtype=torch.bool, device=meta)),
    local_nbytes(torch.empty((), dtype=torch.int32, device=meta))]

m4 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                mesh_dim_names=("data", "model"))
rcfg = RunConfig(kernels="xla")
for arch, kind in CELLS:
    cfg, shape = small(reduced(get(arch)), kind, ShapeSpec)
    cell = specs.build_cell(cfg, shape, m4, rcfg)
    res = analysis.analyze_cell(cell.name, "2x2", 4, cell,
                                dryrun.distribute_args(cell, m4))
    out[f"{{arch}} {{kind}}"] = res["cost"]["flops"]
    out[f"keys {{arch}} {{kind}}"] = sorted(res)
for arch, kind, reps in DEPTH:
    cfg = reduced(get(arch), n_layers=reps * (2 if arch == "gemma2-2b"
                                              else 1))
    if arch == "gemma2-2b":             # the local/global pair, repeated
        cfg = dataclasses.replace(
            cfg, layer_pattern=(((ATTN_SWA, ATTN_FULL), reps),))
    cfg, shape = small(cfg, kind, ShapeSpec)
    totals, mem, _, _ = dryrun.count_cell(cfg, shape, m4, rcfg)
    full = dryrun.trace_cell(cfg, shape, m4, rcfg)[0]
    out[f"depth {{arch}}"] = [dict(totals.numbers(), **mem), full,
                             totals.while_trips]
dryrun.run_cell("gemma2-2b", "decode_32k", False, rcfg, {tmp!r},
                verbose=False)
print("PORT_JSON", json.dumps(out))
"""


def _json(output: str, tag: str) -> dict:
    line = next(ln for ln in output.splitlines() if ln.startswith(tag))
    return json.loads(line[len(tag):])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch_cost")
    kw = dict(cells=CELLS, depth=DEPTH)
    ref = spawn_reference(REFERENCE.format(**kw), n_devices=8)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    port = subprocess.Popen(
        [sys.executable, "-c", PORT.format(tmp=str(tmp), **kw)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    outs = wait_all([ref, port])
    return dict(ref=_json(outs[0], "REFERENCE_JSON"),
                port=_json(outs[1], "PORT_JSON"), tmp=tmp)


def test_scan_of_matmuls(runs):
    """13 (128 × 128) products and tanh in a loop, then y·yᵀ: the flops
    and the tanh elements exactly; the reference counts the same by its
    `while` trip count (13)."""
    flops, trans = runs["port"]["scan"]
    assert flops == SCAN_FLOPS and trans == SCAN_TRANS
    rflops, rtrans, trips = runs["ref"]["scan"]
    assert abs(rflops / SCAN_FLOPS - 1) < 1e-6 and trips == 13
    assert rtrans >= SCAN_TRANS


def test_sharded_matmul_counts_one_ranks_share(runs):
    """A @ B with B split on its columns over 8 ranks: 1/8 of the global
    product a rank, and no collective, as the reference's per-device
    module."""
    flops, coll = runs["port"]["sharded"]
    assert flops == SHARDED_FLOPS and coll == 0
    assert abs(runs["ref"]["sharded"] - SHARDED_FLOPS) < 1e-6


def test_contracting_split_counts_one_all_reduce(runs):
    """A contraction split over 8 ranks, the result replicated: 1/8 of
    the product a rank and one all-reduce of the (64, 64) fp32 result,
    16,384 bytes; the reference's all-reduce is at least that."""
    flops, total, ar, count = runs["port"]["collective"]
    assert flops == COLL_FLOPS
    assert total == ar == ALL_REDUCE_BYTES and count == 1
    rflops, rtotal, rar = runs["ref"]["collective"]
    assert rtotal >= ALL_REDUCE_BYTES and rar >= ALL_REDUCE_BYTES
    assert abs(rflops - COLL_FLOPS) < 1e-6


def test_shape_bytes(runs):
    """A tensor's bytes as the reference's `shape_bytes` of its HLO
    type: f32[128,1024], bf16[16], (f32[8,4], pred[8]) and s32[]."""
    want = [128 * 1024 * 4, 32, 8 * 4 * 4 + 8, 4]
    assert runs["port"]["shape_bytes"] == want == runs["ref"]["shape_bytes"]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_reduced_cells_within_five_percent_of_the_reference(runs, arch,
                                                            kind):
    """Per-rank flops of the reduced cell on a (2, 2) mesh by
    `analyze_cell` (with `analyze_compiled`'s keys) against the
    reference's `analyze_compiled` on 4 fake devices."""
    assert set(runs["port"][f"keys {arch} {kind}"]) == RESULT_KEYS - {
        "lower_s", "compile_s", "model_flops_global", "shape", "run_config"}
    got, want = runs["port"][f"{arch} {kind}"], runs["ref"][f"{arch} {kind}"]
    ratio = got / want
    assert abs(ratio - 1) < 0.05, f"port / reference flops = {ratio:.6f}"


@pytest.mark.parametrize("arch", [a for a, _, _ in DEPTH])
def test_depth_rule_equals_the_full_trace(runs, arch):
    """The depth rule's counts at 3-4 repeats equal a trace of every
    layer: flops, bytes, transcendentals, each kind's collective bytes
    and counts, the arguments' and the result's bytes.  The peak of
    live bytes is a maximum, not a sum: where the first layer's own peak
    is the larger at two repeats, the slope misses it, so it is held
    within 2% (mamba2-1.3b's prefill: 1.25% over)."""
    rule, full, trips = runs["port"][f"depth {arch}"]
    assert set(rule) == set(full)
    for key, v in full.items():
        if key == "temp_bytes":
            assert abs(rule[key] / v - 1) < 0.02, (key, rule[key], v)
        else:
            assert rule[key] == v, (key, rule[key], v)
    assert trips[0][1] == dict((a, r) for a, _, r in DEPTH)[arch]


def test_model_flops_and_active_params_are_the_references():
    for name in J_REGISTRY:
        cfg, jcfg = get(name), j_get(name)
        assert analysis.active_params(cfg) == \
            j_analysis.active_params(jcfg), name
        for s, js in zip(cfg.shapes, jcfg.shapes):
            assert analysis.model_flops(cfg, s) == \
                j_analysis.model_flops(jcfg, js), (name, s.name)


def test_roofline_reads_the_ports_dry_run(runs, monkeypatch):
    """`run_cell`'s JSON has the reference's keys and H100 terms, and
    `benchmarks/roofline.py` reads it (`REPRO_DRYRUN_DIR`)."""
    tmp = runs["tmp"]
    path = tmp / "gemma2-2b_decode_32k_pod1.json"
    with open(path) as f:
        art = json.load(f)
    assert set(art) == RESULT_KEYS
    rl = art["roofline"]
    assert rl["mesh"] == "16x16" and rl["n_devices"] == 256
    assert rl["compute_s"] == rl["flops_per_device"] / 989e12
    assert rl["memory_s"] == rl["bytes_per_device"] / 3.35e12
    assert art["memory"]["temp_bytes"] > 0
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp))
    spec = importlib.util.spec_from_file_location(
        "roofline_bench", os.path.join(REPO, "benchmarks", "roofline.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rows = []
    bench.run(rows)
    tag = "roofline_gemma2-2b_decode_32k_pod1"
    got = {r[0]: r[1] for r in rows}
    assert got[f"{tag}_compute_s"] == rl["compute_s"]
    assert got[f"{tag}_bottleneck"] in (0, 1, 2)
