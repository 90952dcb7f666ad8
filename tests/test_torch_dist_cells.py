"""The production cells' train steps on a mesh whose 'model' dim the
heads do not divide, and mamba2's, on four gloo ranks against the
reference's on four fake devices (a (1, 4) data×model mesh, fp32).

Three faults stopped these cells on DTensor, each shown here with its
repair turned off, then the repaired step held to the reference's own
multi-device tolerances (loss 1e-5, parameters 5e-4 / 1e-5):
  * few-head attention: a q/k/v projection split on its features over
    'model' cannot be unflattened into 6 (or 2) heads on 4 ranks
    (`_split_heads`); the `attn_proj` / `attn_kv4` hints move it to the
    context-parallel layout first (`dist.sharding.make_hint_fn`);
  * a tied embedding on a vocab split: the unembedding hands the
    residual stream a pending-sum gradient, which DTensor cannot turn
    into the lookup's masked partial (`models.common.settle_partial`);
  * mamba2's backward: with the in_proj product laid out by DTensor's
    own matmul, the gradient of the heads' view of x comes back as a
    strided local shard under a contiguous DTensor, and the reshape's
    backward `view` fails; the products run on each rank's shards
    (`models.common.matmul`), and so does the scan
    (`models.ssm._ssd_on_shards`; torch 2.11 also has no rule for the
    flip in its cumsum's backward).

The port runs the cell as `launch.specs.build_cell` builds it (the q
chunk capped to S / model, the hints and the residual constraint
installed) on weights drawn here; the reference runs
`repro.launch.specs.build_cell`'s cell under `jax.jit` with the cell's
shardings, on the same weights.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get as j_get
from repro.configs.base import reduced as j_reduced
from test_torch_dist_mesh import (LOSS_RTOL, PARAM_ATOL, PARAM_RTOL,
                                  as_port_names, port_cfg, spawn_ranks,
                                  spawn_reference, wait_all)
from test_torch_serve import seeded_params
from repro_torch.models import lm_from_numpy

#: (arch, reduced dims, seq, batch): gemma2-2b at 6 q / 2 kv heads of 16
#: (the heads divide no 'model' of 4; tied, softcaps, a 64-row window;
#: 512 tokens, so that the q chunk, capped to S / model, is 128 rows),
#: mamba2-1.3b at its reduced 16 SSM heads and one whole chunk of 32
#: tokens, the smallest input that shows its fault (a sequence padded to
#: the chunk is a fresh tensor, whose views' gradients are dense)
CASES = {
    "gemma2-2b": (dict(d_model=96, n_heads=6, n_kv_heads=2), 512, 2),
    "mamba2-1.3b": ({}, 32, 2),
}
#: each repair, turned off in the ranks' process, and the error it stops
FAULTS = {
    "few-head": ("gemma2-2b", "Cannot unflatten unevenly sharded tensor"),
    "tied-embedding": ("gemma2-2b", "Redistribution from one partial type"),
    "mamba2-view": ("mamba2-1.3b", "view size is not compatible"),
}

COMMON = """
import dataclasses, json
import numpy as np
CASES = {cases!r}
FAULTS = {faults!r}
tmp = {tmp!r}


def shape_cfg(cfg, seq, batch, ShapeSpec):
    return dataclasses.replace(cfg, shapes=(ShapeSpec("t", seq, batch,
                                                      "train"),))
"""

REFERENCE = COMMON + """
import jax, jax.numpy as jnp
from repro.configs import get
from repro.configs.base import RunConfig, ShapeSpec, reduced
from repro.dist import sharding as shd
from repro.launch.specs import build_cell
from repro.train.train_step import init_train_state

mesh = jax.make_mesh((1, 4), ("data", "model"),
                     (jax.sharding.AxisType.Auto,) * 2)
out = {{}}
for arch, (dims, seq, batch) in CASES.items():
    cfg = shape_cfg(reduced(get(arch), **dims), seq, batch, ShapeSpec)
    npz = np.load(f"{{tmp}}/{{arch}}_ref.npz")
    state = init_train_state(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state["params"]),
        [jnp.asarray(npz[f"l{{i:04d}}"]) for i in range(len(npz.files) - 1)])
    state = dict(state, params=params)
    rcfg = RunConfig(kernels="xla", dtype="float32")
    cell = build_cell(cfg, "t", mesh, rcfg)
    with mesh:
        new, m = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                         out_shardings=cell.out_shardings)(
            state, {{"tokens": jnp.asarray(npz["tokens"])}})
    shd.set_hint_fn(None)
    shd.set_moe_mesh(None)
    out[arch] = [float(m["loss"]), float(m["grad_norm"])]
    np.savez(f"{{tmp}}/{{arch}}_ref_out.npz", *[
        np.asarray(a) for a in jax.tree_util.tree_leaves(new["params"])])
with open(f"{{tmp}}/reference.json", "w") as f:
    json.dump(out, f)
print("REFERENCE_OK")
"""

RANKS = COMMON + """
from torch.distributed.tensor import DTensor
from repro_torch.configs import get
from repro_torch.configs.base import RunConfig, ShapeSpec, reduced
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM, common, ssm
from repro_torch.train import distribute_train_state
from repro_torch.train.train_step import train_state

mesh = make_host_mesh(1, 4, "cpu")
out, arrays = {{}}, {{}}


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def run(arch):
    dims, seq, batch = CASES[arch]
    cfg = shape_cfg(reduced(get(arch), **dims), seq, batch, ShapeSpec)
    npz = np.load(f"{{tmp}}/{{arch}}_port.npz")
    rcfg = RunConfig(kernels="xla", dtype="float32")
    cell = specs.build_cell(cfg, "t", mesh, rcfg)
    model = LM(cfg, rcfg, device="cpu", init=False)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(npz[n]))
    state = distribute_train_state(train_state(model), mesh)
    tokens = shd.distribute_batch(
        {{"tokens": torch.from_numpy(npz["tokens"])}}, mesh)
    try:
        return cell.fn(state, tokens)
    finally:
        shd.set_hint_fn(None)
        shd.set_moe_mesh(None)


def without(fault):
    # the repairs of `fault` turned off: [(module, name, stand-in)]
    if fault == "few-head":
        inner = shd.make_hint_fn

        def make(*a, **k):
            fn = inner(*a, **k)
            return lambda name, x: x if name in ("attn_proj", "attn_kv4") \\
                else fn(name, x)
        return [(shd, "make_hint_fn", make)]
    if fault == "tied-embedding":
        return [(common, "settle_partial", common._replicate_partial)]
    return [(common, "matmul", lambda x, w: x @ w),
            (ssm, "_ssd_on_shards", lambda args, chunk, state:
             ssm.ssd_chunked_ref(*args, chunk=chunk, return_state=state))]


for fault, (arch, _) in FAULTS.items():
    swaps = [(mod, attr, getattr(mod, attr), off)
             for mod, attr, off in without(fault)]
    for mod, attr, _, off in swaps:
        setattr(mod, attr, off)
    try:
        run(arch)
        out[fault] = "no error"
    except Exception as e:
        out[fault] = f"{{type(e).__name__}}: {{e}}"
    finally:
        for mod, attr, on, _ in swaps:
            setattr(mod, attr, on)

for arch in CASES:
    state, m = run(arch)
    out[arch] = [float(whole(m["loss"])), float(whole(m["grad_norm"]))]
    for n, p in state["params"].named_parameters():
        arrays[f"{{arch}} {{n}}"] = whole(p.detach()).numpy()

if rank == 0:
    np.savez(f"{{tmp}}/port.npz", **arrays)
    with open(f"{{tmp}}/port.json", "w") as f:
        json.dump(out, f)
"""


def _cfg(arch):
    dims, seq, batch = CASES[arch]
    return j_reduced(j_get(arch), **dims), seq, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cells")
    trees = {}
    for i, arch in enumerate(CASES):
        jcfg, seq, batch = _cfg(arch)
        params = seeded_params(jcfg, 30 + i)
        tokens = np.random.default_rng(40 + i).integers(
            0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
        np.savez(tmp / f"{arch}_ref.npz", tokens=tokens, **{
            f"l{j:04d}": np.asarray(a)
            for j, a in enumerate(jax.tree_util.tree_leaves(params))})
        model = lm_from_numpy(port_cfg(jcfg), jax.tree_util.tree_map(
            np.asarray, params), device="cpu")
        np.savez(tmp / f"{arch}_port.npz", tokens=tokens, **{
            n: p.detach().numpy() for n, p in model.named_parameters()})
        trees[arch] = params
    kw = dict(cases=CASES, faults=FAULTS, tmp=str(tmp))
    procs = spawn_ranks(RANKS.format(**kw), tmp)
    procs.append(spawn_reference(REFERENCE.format(**kw)))
    outs = wait_all(procs)
    assert "REFERENCE_OK" in outs[-1]
    with open(tmp / "port.json") as f:
        port = json.load(f)
    with open(tmp / "reference.json") as f:
        ref = json.load(f)
    ref_params = {}
    for arch, params in trees.items():
        npz = np.load(tmp / f"{arch}_ref_out.npz")
        new = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [npz[f"arr_{j}"] for j in range(len(npz.files))])
        ref_params[arch] = as_port_names(_cfg(arch)[0], new)
    return dict(port=port, ref=ref, arrays=dict(np.load(tmp / "port.npz")),
                ref_params=ref_params)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_fault_shows_without_its_repair(runs, fault):
    """With its repair turned off, the step stops with DTensor's error."""
    got = runs["port"][fault]
    assert FAULTS[fault][1] in got, got


@pytest.mark.parametrize("arch", list(CASES))
def test_repaired_step_matches_the_reference_on_four_devices(runs, arch):
    """The repaired step's loss at rtol 1e-5, its gradient norm at rtol
    1e-4 (AdamW's first update is about lr·sign(g), so the weights alone
    would not show a gradient off in size) and every parameter after its
    AdamW update at rtol 5e-4 / atol 1e-5 of the reference's."""
    (loss, gnorm), (rloss, rgnorm) = runs["port"][arch], runs["ref"][arch]
    np.testing.assert_allclose(loss, rloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(gnorm, rgnorm, rtol=1e-4)
    want = runs["ref_params"][arch]
    got = {k.split(" ", 1)[1]: v for k, v in runs["arrays"].items()
           if k.startswith(arch + " ")}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def test_the_few_head_case_is_few_head():
    """The gemma2 case's heads divide no 'model' of 4, and its table is
    tied, so both of its faults are reached."""
    jcfg = _cfg("gemma2-2b")[0]
    assert jcfg.n_heads % 4 and jcfg.n_kv_heads % 4
    assert jcfg.tie_embeddings
    assert dataclasses.asdict(port_cfg(jcfg))["n_heads"] == 6
