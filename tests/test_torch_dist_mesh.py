"""The port's distributed layer on four ranks against the reference's on
four devices, on the CPU: the sharded train step, the MoE mesh dispatch
in its three reductions (forward and gradients), the bf16 train step
over fp32 leaves, `gpipe`, `compressed_psum` and the elastic restore.

The port runs in four processes joined by `torch.distributed`'s gloo
backend on a (2, 2) data×model mesh (a (4,) one for the pipeline and the
compressed sum); the reference's multi-device runs go to one subprocess
with four fake host devices, as `tests/test_sharding_dist.py` runs them.
Both start together and each is cut at its own timeout.  Weights and
inputs are drawn here with numpy and cross as `.npz` files: neither
subprocess draws a weight (the reference's `init_lm` salts its keys
with Python's `hash()`, which differs between processes).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.dist import checkpoint as j_ckpt
from repro.models import lm_loss as j_lm_loss
from repro.train.train_step import (init_train_state as j_init_state,
                                    make_train_step as j_make_train_step)
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import lm_from_numpy
from repro_torch.train import make_train_step
from repro_torch.train.train_step import train_state
from test_torch_serve import seeded_params
from torch.distributed.tensor import Replicate, Shard

R = str(Replicate())


def S(d: int) -> str:
    return str(Shard(d))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 120     # seconds, each subprocess

#: the reference's multi-device tolerances (`tests/test_sharding_dist.py`)
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 5e-4, 1e-5
MOE_RTOL = 2e-4
GPIPE_RTOL, GPIPE_ATOL = 1e-5, 1e-6
F32_RTOL = 2e-5

TRAIN_DIMS = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=128, vocab=256)
MOE_MODES = ("psum", "scatter", "combine_first")
#: capacity factors of the MoE cases: the reduced config's (no pair
#: drops) and one at which pairs drop, per data shard
MOE_FACTORS = (8.0, 1.0)
M_MICRO, MB, D_PIPE = 8, 4, 16


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def spawn_ranks(body: str, tmp_path, world: int = 4, env=None,
                prelude: str = "") -> list:
    """Start `world` processes running `body` with `rank`, `world`,
    `tmp` (a str) and an initialized gloo default group in scope
    (rendezvous through a file under `tmp_path`); returns the Popen
    objects, for `wait_all`."""
    script = tmp_path / "rank_worker.py"
    script.write_text(prelude + textwrap.dedent("""
        import sys
        import torch
        import torch.distributed as dist
        rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=rank, world_size=world)
    """) + textwrap.dedent(body) + textwrap.dedent("""
        dist.barrier()
        dist.destroy_process_group()
    """))
    env = dict(os.environ if env is None else env,
               PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(world)]


def spawn_reference(code: str, n_devices: int = 4) -> subprocess.Popen:
    """The reference's multi-device code in a subprocess with
    `n_devices` fake host devices (as `tests/conftest.py` runs it)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               TF_CPP_MIN_LOG_LEVEL="2")
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{n_devices} " + env.get("XLA_FLAGS", ""))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=REPO)


def wait_all(procs) -> list:
    """Each process's output; every one must exit 0 within
    SPAWN_TIMEOUT, else all are killed and the outputs raised."""
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out = f"TIMED OUT after {SPAWN_TIMEOUT} s\n{out}"
            failed = True
        failed = failed or p.returncode != 0
        outs.append(out)
    if failed:
        raise AssertionError("\n=====\n".join(o[-6000:] for o in outs))
    return outs


REFERENCE = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import get
from repro.configs.base import RunConfig, reduced
from repro.dist import sharding as shd
from repro.dist.collectives import compressed_psum
from repro.dist.pipeline_parallel import gpipe, stack_stage_params
from repro.models import init_lm, lm_loss

tmp = {tmp!r}
out = {{}}
# Auto axes: on Explicit ones (the default) the backward's contraction
# over the data-split tokens has no output sharding to take
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     (jax.sharding.AxisType.Auto,) * 2)
for cf in {factors!r}:
    base = reduced(get("mixtral-8x7b"), **{dims!r})
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    shapes = jax.eval_shape(lambda: init_lm(jax.random.PRNGKey(0), cfg))
    npz = np.load(f"{{tmp}}/moe_{{cf}}.npz")
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(npz[f"l{{i:04d}}"]) for i in range(len(npz.files) - 1)])
    batch = {{"tokens": jnp.asarray(npz["tokens"])}}
    for mode in {modes!r}:
        rcfg = RunConfig(kernels="xla", dtype="float32", remat=False,
                         moe_reduce=mode)
        shd.set_moe_mesh(mesh)
        with mesh:
            (loss, m), grads = jax.jit(jax.value_and_grad(
                lambda p, b: lm_loss(p, b, cfg, rcfg), has_aux=True))(
                params, batch)
        shd.set_moe_mesh(None)
        out[f"moe {{cf}} {{mode}}"] = [float(loss), float(m["loss"]),
                                      float(m["aux_loss"])]
        np.savez(f"{{tmp}}/ref_grads_{{cf}}_{{mode}}.npz", *[
            np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])

pipe = np.load(f"{{tmp}}/pipe.npz")
smesh = jax.make_mesh((4,), ("stage",))
with smesh:
    piped = jax.jit(gpipe(lambda w, x: jnp.tanh(x @ w), smesh, "stage"))(
        stack_stage_params([jnp.asarray(w) for w in pipe["ws"]]),
        jnp.asarray(pipe["x"]))
dmesh = jax.make_mesh((4,), ("data",))
with dmesh:
    approx = shard_map(lambda xl: compressed_psum(xl[0], "data"),
                       mesh=dmesh, in_specs=(P("data", None),),
                       out_specs=P(), check_rep=False)(
        jnp.asarray(pipe["cx"]))
np.savez(f"{{tmp}}/reference.npz", piped=np.asarray(piped),
         cpsum=np.asarray(approx))
with open(f"{{tmp}}/reference.json", "w") as f:
    json.dump(out, f)
print("REFERENCE_OK")
"""

RANKS = """
import dataclasses, json
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.dist import checkpoint as ckpt, sharding as shd
from repro_torch.dist.collectives import compressed_psum
from repro_torch.dist.pipeline_parallel import gpipe, stack_stage_params
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM, lm_loss
from repro_torch.train import distribute_train_state, make_train_step
from repro_torch.train.train_step import train_state

out, arrays = {}, {}
mesh = make_host_mesh(2, 2, "cpu")


def load(model, npz):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(npz[n]))
    return model


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


# the sharded train step
tin = np.load(f"{tmp}/train_in.npz")
cfg = reduced(get("internlm2-20b"), **DIMS)
rcfg = RunConfig(kernels="xla", dtype="float32", remat=False,
                 learning_rate=1e-3)
state = train_state(load(LM(cfg, rcfg, device="cpu", init=False), tin))
shd.set_hint_fn(shd.make_hint_fn(mesh, cfg.n_kv_heads, True))
distribute_train_state(state, mesh)
batch = shd.distribute_batch({"tokens": torch.from_numpy(tin["tokens"])},
                             mesh)
state, m = make_train_step(cfg, rcfg)(state, batch)
shd.set_hint_fn(None)
out["train"] = [float(whole(m["loss"])), float(whole(m["grad_norm"]))]
out["train placements"] = {
    n: [str(pl) for pl in p.placements]
    for n, p in state["params"].named_parameters()}
out["moment placements"] = {
    n: [str(pl) for pl in t.placements]
    for n, t in state["opt"]["mu"].items()}
for n, p in state["params"].named_parameters():
    arrays["train " + n] = whole(p.detach()).numpy()
# the same step in bf16 over fp32 leaves
rcfg16 = dataclasses.replace(rcfg, dtype="bfloat16")
state = train_state(load(LM(cfg, rcfg16, device="cpu", init=False,
                            param_dtype=torch.float32), tin))
shd.set_hint_fn(shd.make_hint_fn(mesh, cfg.n_kv_heads, True))
distribute_train_state(state, mesh)
state, m = make_train_step(cfg, rcfg16)(state, batch)
shd.set_hint_fn(None)
out["train bf16"] = [float(whole(m["loss"])), float(whole(m["grad_norm"]))]
out["train bf16 placements"] = {
    n: [str(pl) for pl in p.placements] + [str(p.dtype)]
    for n, p in state["params"].named_parameters()}
for n, p in state["params"].named_parameters():
    arrays["step16 " + n] = whole(p.detach()).numpy()

# the MoE mesh dispatch against the local path
for cf in FACTORS:
    base = reduced(get("mixtral-8x7b"), **DIMS)
    mcfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    npz = np.load(f"{tmp}/moe_{cf}_port.npz")
    model = load(LM(mcfg, RunConfig(dtype="float32"), device="cpu",
                    init=False), npz)
    tokens = {"tokens": torch.from_numpy(npz["tokens"])}
    with torch.no_grad():
        for mode in MODES:
            r = RunConfig(kernels="xla", dtype="float32", remat=False,
                          moe_reduce=mode)
            loss, ml = lm_loss(model, tokens, r)
            shd.set_moe_mesh(mesh)
            dloss, dm = lm_loss(model, tokens, r)
            shd.set_moe_mesh(None)
            out[f"moe {cf} {mode}"] = [float(dloss), float(dm["loss"]),
                                      float(dm["aux_loss"]), float(loss),
                                      float(ml["loss"]),
                                      float(ml["aux_loss"])]

# gradients through the MoE mesh dispatch: plain weights (the same on
# every rank, each gradient whole on every rank), and for combine_first
# DTensor weights on the mesh with a data-split batch, in fp32 and with
# bf16 compute over the fp32 leaves
for cf in FACTORS:
    base = reduced(get("mixtral-8x7b"), **DIMS)
    mcfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    npz = np.load(f"{tmp}/moe_{cf}_port.npz")
    tokens = {"tokens": torch.from_numpy(npz["tokens"])}
    for mode in MODES:
        r = RunConfig(kernels="xla", dtype="float32", remat=False,
                      moe_reduce=mode)
        model = load(LM(mcfg, r, device="cpu", init=False), npz)
        for on_mesh in (True, False):
            shd.set_moe_mesh(mesh if on_mesh else None)
            loss, _ = lm_loss(model, tokens, r)
            loss.backward()
            shd.set_moe_mesh(None)
            tag = "mesh" if on_mesh else "local"
            for n, p in model.named_parameters():
                arrays[f"grad {tag} {cf} {mode} {n}"] = p.grad.numpy().copy()
                p.grad = None
    for dtype in ("float32", "bfloat16"):
        r = RunConfig(kernels="xla", dtype=dtype, remat=False,
                      moe_reduce="combine_first")
        model = load(LM(mcfg, r, device="cpu", init=False,
                        param_dtype=torch.float32), npz)
        if dtype == "bfloat16":       # plain weights, for the DTensor run
            shd.set_moe_mesh(mesh)
            loss, _ = lm_loss(model, tokens, r)
            loss.backward()
            shd.set_moe_mesh(None)
            for n, p in model.named_parameters():
                arrays[f"grad mesh16 {cf} {n}"] = p.grad.numpy().copy()
                p.grad = None
        shd.distribute_params(model, mesh)
        shd.set_moe_mesh(mesh)
        with implicit_replication():
            loss, _ = lm_loss(model, shd.distribute_batch(tokens, mesh), r)
            loss.backward()
        shd.set_moe_mesh(None)
        for n, p in model.named_parameters():
            arrays[f"grad dtensor {dtype} {cf} {n}"] = whole(p.grad).numpy()
            out[f"grad placements {dtype} {cf} {n}"] = [
                [str(pl) for pl in p.placements],
                [str(pl) for pl in p.grad.placements]]

# gpipe over four stages and the compressed sum
pipe = np.load(f"{tmp}/pipe.npz")
smesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
ws = [torch.from_numpy(w) for w in pipe["ws"]]
piped = gpipe(lambda w, x: torch.tanh(x @ w), smesh, "stage")(
    stack_stage_params(ws), torch.from_numpy(pipe["x"]))
dmesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
cx = torch.from_numpy(pipe["cx"])
approx = compressed_psum(cx[rank], "data", dmesh)
arrays["piped"], arrays["cpsum"] = piped.numpy(), approx.numpy()
out["cpsum input intact"] = bool(torch.equal(cx[rank], torch.from_numpy(
    pipe["cx"][rank])))

# the elastic restore: the reference's checkpoint onto the (2, 2) mesh
like = {"w": torch.zeros(8, 8)}
sh = {"w": shd.placements(mesh, shd.P("data", "model"))}
got = ckpt.restore(f"{tmp}/ckpt/step_00000001", like, shardings=sh,
                   mesh=mesh)["w"]
out["elastic"] = {
    "placements": [str(pl) for pl in got.placements],
    "want": [str(pl) for pl in sh["w"]],
    "local": got.to_local().tolist(),
    "coordinate": mesh.get_coordinate(),
    "whole": whole(got).tolist()}
# and a DTensor state saved on the mesh, read back whole
ckpt.save({"w": got}, f"{tmp}/mesh_ckpt", step=2)
dist.barrier()
back = ckpt.restore(f"{tmp}/mesh_ckpt/step_00000002", {"w": None})
out["mesh save"] = back["w"].tolist()

if rank == 0:
    np.savez(f"{tmp}/port.npz", **arrays)
    with open(f"{tmp}/port.json", "w") as f:
        json.dump(out, f)
else:
    with open(f"{tmp}/elastic_{rank}.json", "w") as f:
        json.dump(out["elastic"], f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Draw every input, start the four ranks and the reference's
    multi-device subprocess together, run the reference's single-device
    train step here meanwhile, and collect all results."""
    tmp = tmp_path_factory.mktemp("dist_mesh")
    # the train step's weights and batch: reduced internlm2-20b, as
    # `test_sharding_dist.py` trains it
    jcfg = j_reduced(j_get("internlm2-20b"), **TRAIN_DIMS)
    params = seeded_params(jcfg, 3)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    model = lm_from_numpy(port_cfg(jcfg), jax.tree_util.tree_map(
        np.asarray, params), device="cpu")
    np.savez(tmp / "train_in.npz", tokens=tokens, **{
        n: p.detach().numpy() for n, p in model.named_parameters()})
    # the MoE cases: reduced mixtral-8x7b at two capacity factors
    moe_batches = {}
    for i, cf in enumerate(MOE_FACTORS):
        base = j_reduced(j_get("mixtral-8x7b"), **TRAIN_DIMS)
        mj = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        mp = seeded_params(mj, 5 + i)
        mtok = np.random.default_rng(6 + i).integers(
            0, mj.vocab_size, (8, 16)).astype(np.int32)
        leaves = jax.tree_util.tree_leaves(mp)
        np.savez(tmp / f"moe_{cf}.npz", tokens=mtok, **{
            f"l{j:04d}": np.asarray(a) for j, a in enumerate(leaves)})
        mm = lm_from_numpy(port_cfg(mj), jax.tree_util.tree_map(
            np.asarray, mp), device="cpu")
        np.savez(tmp / f"moe_{cf}_port.npz", tokens=mtok, **{
            n: p.detach().numpy() for n, p in mm.named_parameters()})
        moe_batches[cf] = (mj, mp, mtok)
    # gpipe's stages and microbatches, the compressed sum's input
    rng = np.random.default_rng(7)
    ws = (rng.standard_normal((4, D_PIPE, D_PIPE)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M_MICRO, MB, D_PIPE)).astype(np.float32)
    cx = rng.standard_normal((4, 256)).astype(np.float32)
    np.savez(tmp / "pipe.npz", ws=ws, x=x, cx=cx)
    # a checkpoint written by the reference, unsharded
    j_ckpt.save({"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)},
                str(tmp / "ckpt"), step=1)

    prelude = (f"DIMS = {TRAIN_DIMS!r}\nFACTORS = {MOE_FACTORS!r}\n"
               f"MODES = {MOE_MODES!r}\n")
    procs = spawn_ranks(RANKS, tmp, prelude=prelude)
    procs.append(spawn_reference(REFERENCE.format(
        tmp=str(tmp), factors=MOE_FACTORS, dims=TRAIN_DIMS,
        modes=MOE_MODES)))

    # meanwhile: the single-device steps, the reference's and the port's
    jb = {"tokens": jnp.asarray(tokens)}
    jrcfg = JRunConfig(kernels="xla", dtype="float32", remat=False,
                       learning_rate=1e-3)
    jstate = j_init_state(jax.random.PRNGKey(0), jcfg)
    jstate["params"] = params
    jstate, jm = jax.jit(j_make_train_step(jcfg, jrcfg))(jstate, jb)
    import torch
    rcfg = RunConfig(kernels="xla", dtype="float32", remat=False,
                     learning_rate=1e-3)
    single = train_state(model)
    single, m = make_train_step(port_cfg(jcfg), rcfg)(
        single, {"tokens": torch.from_numpy(tokens)})
    rcfg16 = dataclasses.replace(rcfg, dtype="bfloat16")
    single16 = train_state(lm_from_numpy(
        port_cfg(jcfg), jax.tree_util.tree_map(np.asarray, params), rcfg16,
        device="cpu", param_dtype=torch.float32))
    single16, m16 = make_train_step(port_cfg(jcfg), rcfg16)(
        single16, {"tokens": torch.from_numpy(tokens)})
    # the local MoE loss of the reference (no mesh) for each case
    j_local = {}
    for cf, (mj, mp, mtok) in moe_batches.items():
        j_local[cf] = float(j_lm_loss(mp, {"tokens": jnp.asarray(mtok)}, mj,
                                      jrcfg)[0])

    outs = wait_all(procs)
    assert "REFERENCE_OK" in outs[-1]
    with open(tmp / "port.json") as f:
        port = json.load(f)
    with open(tmp / "reference.json") as f:
        ref = json.load(f)
    elastic = [port["elastic"]] + [
        json.load(open(tmp / f"elastic_{r}.json")) for r in (1, 2, 3)]
    return dict(
        port=port, ref=ref, arrays=dict(np.load(tmp / "port.npz")),
        ref_arrays=dict(np.load(tmp / "reference.npz")),
        jm=jm, jparams=jstate["params"], jcfg=jcfg, single=single,
        single_m=m, j_local=j_local, pipe=dict(np.load(tmp / "pipe.npz")),
        elastic=elastic, moe_batches=moe_batches, tmp=tmp,
        single16=single16, single16_m=m16)


def as_port_names(jcfg, tree):
    model = lm_from_numpy(port_cfg(jcfg), jax.tree_util.tree_map(
        np.asarray, tree), device="cpu")
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def test_sharded_train_step_matches_single_device(runs):
    """The (2, 2) step against the port's single-process step and the
    reference's single-device step, from the same weights and batch: the
    loss at rtol 1e-5, every parameter at rtol 5e-4 / atol 1e-5 (the
    reference's own tolerances for its sharded step)."""
    loss, gnorm = runs["port"]["train"]
    np.testing.assert_allclose(loss, float(runs["jm"]["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, float(runs["single_m"]["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(gnorm, float(runs["jm"]["grad_norm"]),
                               rtol=1e-4)
    want = as_port_names(runs["jcfg"], runs["jparams"])
    single = {n: p.detach().numpy()
              for n, p in runs["single"]["params"].named_parameters()}
    assert set(want) == set(single) == {
        k[len("train "):] for k in runs["arrays"] if k.startswith("train ")}
    for name, w in want.items():
        got = runs["arrays"]["train " + name]
        np.testing.assert_allclose(got, w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(got, single[name], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def test_sharded_train_state_is_laid_out_by_the_rules(runs):
    """The step's parameters stay on their rule-table placements, and
    the moments share them: wq column-split, wo row-split, the
    embedding's vocab split, norms and the untied head replicated."""
    pl = runs["port"]["train placements"]
    assert runs["port"]["moment placements"] == pl
    assert pl["layers.0.attn.wq"] == [R, S(1)]
    assert pl["layers.1.attn.wo"] == [R, S(0)]
    assert pl["layers.0.ffn.w_down"] == [R, S(0)]
    assert pl["embed"] == [R, S(0)]
    for name in ("final_norm", "layers.0.ln1", "lm_head"):
        assert pl[name] == [R, R], name


@pytest.mark.parametrize("cf", MOE_FACTORS)
@pytest.mark.parametrize("mode", MOE_MODES)
def test_moe_mesh_dispatch_matches_the_reference(runs, mode, cf):
    """lm_loss with the (2, 2) mesh installed (`set_moe_mesh`): the total
    loss at the reference's rtol 2e-4 against the reference's sharded
    run, the aux loss (averaged over the data shards, each sized from
    its own tokens) and the token loss at f32 rtol 2e-5.  At capacity
    factor 1 pairs drop per data shard, so only the sharded run is the
    yardstick."""
    got = runs["port"][f"moe {cf} {mode}"]
    want = runs["ref"][f"moe {cf} {mode}"]
    np.testing.assert_allclose(got[0], want[0], rtol=MOE_RTOL)
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=F32_RTOL)


@pytest.mark.parametrize("mode", MOE_MODES)
def test_moe_mesh_dispatch_matches_local_where_nothing_drops(runs, mode):
    """At the reduced config's capacity factor 8 no pair drops, so the
    mesh dispatch's token loss equals the local path's (f32 rtol 2e-5);
    the total differs only by the aux loss, averaged per shard, and
    stays within the reference's rtol 2e-4 of the local one's."""
    got = runs["port"][f"moe 8.0 {mode}"]
    np.testing.assert_allclose(got[1], got[4], rtol=F32_RTOL)
    np.testing.assert_allclose(got[0], got[3], rtol=MOE_RTOL)
    np.testing.assert_allclose(got[3], runs["j_local"][8.0], rtol=F32_RTOL)


def test_sharded_bf16_train_step_keeps_the_rules_and_fp32_leaves(runs):
    """The (2, 2) step in bf16 over fp32 leaves: every parameter on the
    placements of the fp32 step (the rule table does not read the dtype)
    and fp32; the loss and grad norm within the bf16 tolerance of the
    single-process bf16 step, and the weights within 2·lr of its (Adam
    moves a weight by at most about lr a step)."""
    port = runs["port"]
    pl = port["train bf16 placements"]
    assert {n: v[:-1] for n, v in pl.items()} == port["train placements"]
    assert {v[-1] for v in pl.values()} == {str(torch.float32)}
    loss, gnorm = port["train bf16"]
    np.testing.assert_allclose(loss, float(runs["single16_m"]["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(gnorm, float(runs["single16_m"]["grad_norm"]),
                               rtol=2e-2)
    lr = float(runs["single16_m"]["lr"])
    for n, p in runs["single16"]["params"].named_parameters():
        got = runs["arrays"]["step16 " + n]
        assert np.max(np.abs(got - p.detach().numpy())) <= 2 * lr + 1e-7, n


def reference_grads(runs, cf, mode):
    """The reference's sharded-run gradients of a MoE case, by port
    name."""
    mj, mp, _ = runs["moe_batches"][cf]
    npz = np.load(runs["tmp"] / f"ref_grads_{cf}_{mode}.npz")
    leaves = [npz[f"arr_{i}"] for i in range(len(npz.files))]
    return as_port_names(mj, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(mp), leaves))


def grad_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


@pytest.mark.parametrize("cf", MOE_FACTORS)
@pytest.mark.parametrize("mode", MOE_MODES)
def test_moe_mesh_dispatch_gradients_match_the_reference(runs, mode, cf):
    """The backward through the mesh dispatch on four gloo ranks against
    `jax.grad` of the reference's `shard_map` run on four fake devices:
    every parameter's gradient within the MoE tolerance, 2e-4 of its
    leaf's largest."""
    want = reference_grads(runs, cf, mode)
    for name, w in want.items():
        got = runs["arrays"][f"grad mesh {cf} {mode} {name}"]
        assert grad_err(got, w) < MOE_RTOL, (name, grad_err(got, w))


@pytest.mark.parametrize("mode", MOE_MODES)
def test_moe_mesh_gradients_sum_over_the_data_ranks_once(runs, mode):
    """Where no pair drops (capacity factor 8), the last layer's expert
    weights' gradients on the (2, 2) mesh equal the local path's within
    f32 rounding (no aux loss lies past them, and the aux loss, averaged
    per data shard on the mesh, is all that parts the two runs): each
    rank's part is summed over the data ranks once, not left alone or
    doubled."""
    a = runs["arrays"]
    last = TRAIN_DIMS["n_layers"] - 1
    experts = [k.split(" ", 4)[-1] for k in a
               if k.startswith(f"grad mesh 8.0 {mode} layers.{last}.moe.w_")]
    assert len(experts) == 3
    for n in experts:
        got, loc = a[f"grad mesh 8.0 {mode} {n}"], \
            a[f"grad local 8.0 {mode} {n}"]
        assert grad_err(got, loc) < F32_RTOL, (n, grad_err(got, loc))


@pytest.mark.parametrize("cf", MOE_FACTORS)
def test_moe_gradients_of_dtensor_weights_on_the_mesh(runs, cf):
    """DTensor weights on the mesh with a data-split batch: each rank's
    part of a gradient is summed once (fp32: the plain weights' gradients
    within 2e-5 of the leaf's max), and in bf16 over the fp32 leaves the
    weights and their gradients take the placements of the fp32 run and
    the gradients are fp32, where nothing drops (capacity factor 8)
    within 2e-2 in norm of the plain weights' bf16 gradients.  (Where
    pairs drop, a bf16 rounding that moves a token across an expert's
    capacity moves its gradients by far more than rounding.)"""
    a, port = runs["arrays"], runs["port"]
    names = [k.split(" ", 4)[-1] for k in a
             if k.startswith(f"grad dtensor float32 {cf} ")]
    assert names
    got16, want32 = [], []
    for n in names:
        f32 = a[f"grad dtensor float32 {cf} {n}"]
        plain = a[f"grad mesh {cf} combine_first {n}"]
        assert grad_err(f32, plain) < F32_RTOL, (n, grad_err(f32, plain))
        assert port[f"grad placements bfloat16 {cf} {n}"] == \
            port[f"grad placements float32 {cf} {n}"], n
        g16 = a[f"grad dtensor bfloat16 {cf} {n}"]
        assert g16.dtype == np.float32
        got16.append(g16.ravel())
        want32.append(a[f"grad mesh16 {cf} {n}"].ravel())
    got16, want32 = np.concatenate(got16), np.concatenate(want32)
    assert np.all(np.isfinite(got16))
    if cf == 8.0:
        assert np.linalg.norm(got16 - want32) < \
            2e-2 * np.linalg.norm(want32)


def test_gpipe_matches_sequential_and_the_reference(runs):
    pipe = runs["pipe"]
    ref = pipe["x"]
    for w in pipe["ws"]:
        ref = np.tanh(ref @ w)
    got = runs["arrays"]["piped"]
    np.testing.assert_allclose(got, ref, rtol=GPIPE_RTOL, atol=GPIPE_ATOL)
    np.testing.assert_allclose(got, runs["ref_arrays"]["piped"],
                               rtol=GPIPE_RTOL, atol=GPIPE_ATOL)


def test_compressed_psum_close_to_exact_and_the_reference(runs):
    got = runs["arrays"]["cpsum"]
    exact = runs["pipe"]["cx"].sum(axis=0)
    rel = float(np.max(np.abs(got - exact)) / np.max(np.abs(exact)))
    assert 0 < rel < 0.1, rel
    np.testing.assert_allclose(got, runs["ref_arrays"]["cpsum"], rtol=1e-6,
                               atol=1e-6 * float(np.max(np.abs(exact))))
    assert runs["port"]["cpsum input intact"]


def test_elastic_restore_to_mesh(runs):
    """The reference's unsharded checkpoint restored onto the (2, 2)
    mesh: every rank holds its (4, 4) block of the 8 x 8 tensor, with the
    placements asked for; a DTensor saved on the mesh reads back whole."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for e in runs["elastic"]:
        assert e["placements"] == e["want"] == [S(0), S(1)]
        i, j = e["coordinate"]
        assert np.array_equal(np.asarray(e["local"]),
                              w[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        assert np.array_equal(np.asarray(e["whole"]), w)
    assert sorted(tuple(e["coordinate"]) for e in runs["elastic"]) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert np.array_equal(np.asarray(runs["port"]["mesh save"]), w)
