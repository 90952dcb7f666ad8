"""The port's `launch.specs` against the reference's `repro.launch.specs`
on the production (16, 16) data×model mesh: for every (arch × shape)
cell of the ten archs, and again under `decode_kv_shard` "heads" and
"seq", `decode_ring` 0, `sequence_parallel` off and `ssm_head_tp` on,
every argument leaf's shape, dtype and placements, the donated
arguments, the RunConfig the cell's step is built with (the few-head
`attn_chunk_q` cap), the activation hints and residual-stream
constraint it installs, and whether it installs the MoE mesh.

The reference runs once, in a subprocess with 256 fake host devices;
the port in another, on torch's fake process group of 256 ranks
(`specs.fake_mesh`).  Both write every cell as JSON.  The port keeps a
layer a module (and a decode cache a dict a layer) where the reference
stacks each segment's layers, so a stacked reference leaf stands for one
port leaf a layer, each its shape and spec less the stacked axis: the
converter's leaf tables name the pairs, as in
`tests/test_torch_sharding.py`."""

import json
import os
import re
import subprocess
import sys

import pytest

from repro_torch.configs import get
from repro_torch.models.convert import _LAYER_LEAVES, _encdec_leaf
from test_torch_dist_mesh import REPO, spawn_reference, wait_all
from test_torch_sharding import expected_placements

#: RunConfig variants, and the cells each covers ("all", a shape kind,
#: or the archs with an SSM)
VARIANTS = {
    "base": ({}, "all"),
    "heads": (dict(decode_kv_shard="heads"), "decode"),
    "seq": (dict(decode_kv_shard="seq"), "decode"),
    "ring0": (dict(decode_ring=0), "decode"),
    "nosp": (dict(sequence_parallel=False), "train"),
    "ssmtp": (dict(ssm_head_tp=True), "ssm"),
}
#: the RunConfig fields a cell's step is built with that either side
#: records
RCFG_FIELDS = ("kernels", "dtype", "attn_chunk_q", "attn_chunk_k",
               "decode_kv_shard", "decode_ring", "sequence_parallel",
               "ssm_head_tp", "ssd_chunk", "ssd_compute_dtype", "remat",
               "moe_shard_map", "moe_reduce")

COMMON = """
import dataclasses, json
VARIANTS = {variants!r}
FIELDS = {fields!r}
record = {{}}


def cells(REGISTRY, get):
    for name, (knobs, which) in VARIANTS.items():
        for arch in sorted(REGISTRY):
            cfg = get(arch)
            for s in cfg.shapes:
                if which == "all" or s.kind == which or (
                        which == "ssm" and cfg.ssm is not None):
                    yield name, knobs, cfg, s.name


def spec_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def wrap(mod, fname, key, rcfg_at):
    inner = getattr(mod, fname)

    def hooked(*a, **k):
        if rcfg_at is not None:
            rc = a[rcfg_at]
            record["rcfg"] = {{f: getattr(rc, f) for f in FIELDS}}
        if key == "hint":
            record["hint"] = [a[1], a[2], k.get("ssm_heads", 0)]
        if key == "residual":
            record["residual"] = a[1]
        return inner(*a, **k)
    setattr(mod, fname, hooked)
"""

REFERENCE = COMMON + """
import jax
from repro.configs import REGISTRY, get
from repro.configs.base import RunConfig
from repro.dist import sharding as shd
from repro.launch import specs
from repro.launch.mesh import make_production_mesh

mesh = make_production_mesh()
wrap(specs, "make_train_step", "rcfg", 1)
wrap(specs, "make_prefill_step", "rcfg", 1)
wrap(specs, "make_decode_step", "rcfg", 1)
wrap(shd, "make_hint_fn", "hint", None)
wrap(shd, "residual_spec", "residual", None)
out = {{}}
for name, knobs, cfg, shape in cells(REGISTRY, get):
    record.clear()
    cell = specs.build_cell(cfg, shape, mesh,
                            RunConfig(kernels="xla", **knobs))
    leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    shards = jax.tree_util.tree_leaves(cell.in_shardings)
    assert len(leaves) == len(shards)
    args = {{jax.tree_util.keystr(p): [list(a.shape), str(a.dtype),
                                      spec_list(s.spec)]
            for (p, a), s in zip(leaves, shards)}}
    out.setdefault(name, {{}})[cell.name] = dict(
        args=args, donate=list(cell.donate_argnums), **record,
        residual_spec=spec_list(shd.residual_spec(
            mesh, record["residual"]).spec),
        moe_mesh=shd.moe_mesh() is not None)
with open({path!r}, "w") as f:
    json.dump(out, f)
print("REFERENCE_OK")
"""

PORT = COMMON + """
from repro_torch.configs import REGISTRY, get
from repro_torch.configs.base import RunConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs

mesh = specs.fake_mesh()
wrap(specs, "make_train_step", "rcfg", 1)
wrap(specs, "_serving_params", "rcfg", 1)
wrap(shd, "make_hint_fn", "hint", None)
wrap(shd, "residual_spec", "residual", None)
out = {{}}
for name, knobs, cfg, shape in cells(REGISTRY, get):
    record.clear()
    cell = specs.build_cell(cfg, shape, mesh,
                            RunConfig(kernels="xla", **knobs))
    d = specs.describe(cell)
    out.setdefault(name, {{}})[cell.name] = dict(
        d, **record, residual_spec=[str(p) for p in shd.residual_spec(
            mesh, record["residual"])],
        moe_mesh=shd.moe_mesh() is not None)
with open({path!r}, "w") as f:
    json.dump(out, f)
print("PORT_OK")
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("specs")
    kw = dict(variants=VARIANTS, fields=RCFG_FIELDS)
    ref = spawn_reference(REFERENCE.format(
        path=str(tmp / "reference.json"), **kw), n_devices=256)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    port = subprocess.Popen(
        [sys.executable, "-c", PORT.format(path=str(tmp / "port.json"),
                                           **kw)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    outs = wait_all([ref, port])
    assert "REFERENCE_OK" in outs[0] and "PORT_OK" in outs[1]
    with open(tmp / "reference.json") as f:
        want = json.load(f)
    with open(tmp / "port.json") as f:
        got = json.load(f)
    return got, want


def _keys(keystr: str):
    """A jax `keystr` as its keys: "[0]['a'][2]" → (0, 'a', 2)."""
    return tuple(int(i) if i else k for k, i in
                 re.findall(r"\['([^']*)'\]|\[(\d+)\]", keystr))


def _layer(cfg, si: int, ki: int, r: int) -> int:
    """The port's layer index of segment si, kind ki, repeat r."""
    before = sum(len(k) * rep for k, rep in cfg.pattern[:si])
    return before + r * len(cfg.pattern[si][0]) + ki


TOP = {("embed", "table"): "embed", ("final_norm", "scale"): "final_norm",
       ("lm_head", "kernel"): "lm_head",
       ("vision_proj", "kernel"): "vision_proj",
       ("enc_norm", "scale"): "enc_norm"}


def port_leaves(cfg, path):
    """The port's names for the reference's parameter leaf `path` (its
    keys), and whether that leaf is stacked over the layers."""
    if path in TOP:
        return [TOP[path]], False
    if path[0] == "segments":
        si, ki, rest = path[1], path[2], path[3:]
        rep = cfg.pattern[si][1]
        return [f"layers.{_layer(cfg, si, ki, r)}.{_LAYER_LEAVES[rest]}"
                for r in range(rep)], True
    if path[0] in ("enc_layers", "dec_layers"):
        n = cfg.encoder.n_layers if path[0] == "enc_layers" else \
            cfg.n_layers
        return [f"{path[0]}.{i}.{_encdec_leaf(path[1:])}"
                for i in range(n)], True
    raise AssertionError(path)


def port_paths(cfg, kind, keystr):
    """The port's argument paths for a reference argument leaf: (paths,
    whether the reference stacks them on a leading axis)."""
    keys = _keys(keystr)
    arg, rest = keys[0], keys[1:]
    if kind == "train" and arg == 0:
        if rest[0] == "params":
            names, stacked = port_leaves(cfg, rest[1:])
            return [f"0.params.{n}" for n in names], stacked
        if rest[0] == "opt" and rest[1] in ("mu", "nu"):
            names, stacked = port_leaves(cfg, rest[2:])
            return [f"0.opt.{rest[1]}.{n}" for n in names], stacked
        return ["0." + ".".join(map(str, rest))], False
    if kind != "train" and arg == 0:
        names, stacked = port_leaves(cfg, rest)
        return [f"0.{n}" for n in names], stacked
    if kind == "decode" and arg == 1 and cfg.family != "audio":
        si, ki, key = rest[0], rest[1], rest[-1]
        rep = cfg.pattern[si][1]
        return [f"1.{_layer(cfg, si, ki, r)}.{key}" for r in range(rep)], \
            True
    return [".".join(map(str, keys))], False


def kind_of(cell_name):
    return get(cell_name.split(":")[0]), \
        get(cell_name.split(":")[0]).shape(cell_name.split(":")[1]).kind


def test_every_cell_is_built_on_both_sides(cells):
    got, want = cells
    assert set(got) == set(want) == set(VARIANTS)
    for name in VARIANTS:
        assert set(got[name]) == set(want[name]), name
    assert len(want["base"]) == 33


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_arguments_match_the_references(cells, variant):
    """Every argument leaf of every cell: shape, dtype and placements as
    the reference's (a stacked leaf as each of its layers), the decode
    position (an int in the port, a 0-d int32 there) replicated; every
    port leaf accounted for; the same arguments donated."""
    got, want = cells
    for cell, w in want[variant].items():
        g = got[variant][cell]
        cfg, kind = kind_of(cell)
        assert g["donate"] == w["donate"], cell
        seen = set()
        for keystr, (shape, dtype, spec) in w["args"].items():
            paths, stacked = port_paths(cfg, kind, keystr)
            if stacked:
                shape, spec = shape[1:], spec[1:]
            for path in paths:
                gshape, gdtype, gpl = g["args"][path]
                assert gpl == expected_placements(spec), (cell, path, spec)
                if gdtype == "int":     # the decode position
                    assert (shape, dtype) == ([], "int32"), (cell, path)
                else:
                    assert (gshape, gdtype) == (shape, dtype), (cell, path)
            seen.update(paths)
        assert seen == set(g["args"]), (cell, set(g["args"]) - seen)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_steps_hints_and_constraints_match_the_references(cells, variant):
    """The RunConfig each cell's step is built with (the few-head
    `attn_chunk_q` cap among its fields), the hint function's arguments
    (kv heads, sequence parallelism, SSM heads under `ssm_head_tp`), the
    residual-stream placements and the MoE mesh's install."""
    got, want = cells
    for cell, w in want[variant].items():
        g = got[variant][cell]
        assert g["rcfg"] == w["rcfg"], cell
        assert g["hint"] == w["hint"], cell
        assert g["residual"] == w["residual"], cell
        assert g["residual_spec"] == expected_placements(
            w["residual_spec"]), cell
        assert g["moe_mesh"] == w["moe_mesh"], cell


def test_the_variants_change_what_they_should(cells):
    """The knobs are read: "heads" and "seq" move a decode cache's split,
    a ring of 0 drops the rings, `ssm_head_tp` hands the SSM heads to the
    hints, and a few-head arch's q chunk is capped."""
    got = cells[0]
    k = "gemma2-2b:decode_32k"
    base, heads, seq, ring0 = (got[v][k]["args"] for v in
                               ("base", "heads", "seq", "ring0"))
    # gemma2's 4 kv heads do not divide 'model' (16): "auto" splits the
    # sequence, as "seq" does, and "heads" forces the heads
    assert base["1.1.k"] == seq["1.1.k"]
    assert heads["1.1.k"][2] != seq["1.1.k"][2]
    assert any(".rk" in p for p in base) and \
        not any(".rk" in p for p in ring0)
    assert got["ssmtp"]["mamba2-1.3b:train_4k"]["hint"][2] > 0
    assert got["base"]["mamba2-1.3b:train_4k"]["hint"][2] == 0
    caps = {c: v["rcfg"]["attn_chunk_q"] for c, v in got["base"].items()
            if not c.endswith("decode_32k") and "long" not in c}
    assert min(caps.values()) < max(caps.values())
