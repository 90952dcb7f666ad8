"""The port's sharding rules (`repro_torch.dist.sharding`) against the
reference's (`repro.dist.sharding`): the rule table's cases, and for six
reduced configs every port parameter's DTensor placements on a (2, 2)
data×model mesh of four gloo ranks against the reference's
`param_specs` of its counterpart leaf on four fake devices, matched
through the converter's leaf table.  Also the hint function's layouts,
`residual_spec` and the mesh helpers on that mesh."""

import json

import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.dist.sharding import spec_for_path as j_spec_for_path
from repro_torch.dist import sharding as shd
from repro_torch.models.convert import _LAYER_LEAVES
from test_torch_dist_mesh import spawn_ranks, spawn_reference, wait_all

ARCHS = ("gemma2-2b", "mamba2-1.3b", "hymba-1.5b", "qwen2-moe-a2.7b",
         "mixtral-8x7b", "internvl2-26b")

RULES = [
    ("segments/0/0/attn/wq/kernel", 3, (None, None, "model")),
    ("segments/0/0/attn/wo/kernel", 3, (None, "model", None)),
    ("segments/0/0/ffn/w_gate/kernel", 3, (None, None, "model")),
    ("segments/0/0/ffn/w_down/kernel", 3, (None, "model", None)),
    ("segments/0/0/moe/w_gate", 4, (None, None, None, "model")),
    ("segments/0/0/moe/w_down", 4, (None, None, "model", None)),
    ("embed/table", 2, ("model", None)),
    ("segments/0/0/ssm/in_proj/kernel", 3, (None, None, "model")),
    ("segments/0/0/ln1/scale", 2, (None, None)),
]


@pytest.mark.parametrize("path,ndim,want", RULES)
def test_rules(path, ndim, want):
    """The nine cases of `tests/test_sharding_dist.py`, and the
    reference's answer for each."""
    spec = shd.spec_for_path(path, ndim)
    got = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    assert got == tuple(want), f"{path}: {got}"
    ref = tuple(j_spec_for_path(path, ndim))
    assert got == ref + (None,) * (ndim - len(ref))


@pytest.mark.parametrize("name,ndim,want", [
    ("layers.3.attn.wq", 2, (None, "model")),
    ("layers.3.attn.wo", 2, ("model", None)),
    ("layers.0.attn.bq", 1, ("model",)),
    ("layers.0.moe.w_gate", 3, (None, None, "model")),
    ("layers.0.moe.w_down", 3, (None, "model", None)),
    ("layers.0.moe.router", 2, (None, None)),
    ("layers.1.ln1", 1, (None,)),
    ("embed", 2, ("model", None)),
    ("lm_head", 2, (None, None)),
])
def test_port_names_classify_as_their_reference_leaves(name, ndim, want):
    """A `named_parameters` name splits on '.', and a layer's leaf takes
    the spec of the reference's stacked leaf less its leading dim."""
    assert tuple(shd._port_spec(name, ndim)) == want
    assert shd._tokens("layers.3.attn.wq") == ("layers", "3", "attn", "wq")


def test_hint_is_the_identity_without_a_mesh():
    import torch
    x = torch.randn(2, 3)
    assert shd.hint("attn_out", x) is x
    assert shd.moe_mesh() is None


def test_partition_spec_reads_as_a_tuple():
    spec = shd.P(("pod", "data"), None, "model")
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert repr(spec) == "P(('pod', 'data'), None, 'model')"


REFERENCE = """
import json
import jax
from repro.configs import get
from repro.configs.base import reduced
from repro.dist.sharding import param_specs
from repro.models import init_lm

mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {{}}
for arch in {archs!r}:
    cfg = reduced(get(arch))
    shapes = jax.eval_shape(lambda: init_lm(jax.random.PRNGKey(0), cfg))
    specs = param_specs(shapes, mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out[arch] = {{jax.tree_util.keystr(p): [list(shape.shape), [
        list(e) if isinstance(e, tuple) else e for e in tuple(s)]]
        for (p, s), (_, shape) in zip(flat[0], leaves)}}
with open({path!r}, "w") as f:
    json.dump(out, f)
print("REFERENCE_OK")
"""

RANKS = """
import json
from repro_torch.configs import get
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from torch.distributed.tensor import DTensor, distribute_tensor, Replicate

mesh = make_host_mesh(2, 2, "cpu")
out = {"params": {}, "hints": {}}
for arch in ARCHS:
    model = LM(reduced(get(arch)), RunConfig(dtype="float32"), seed=0,
               device="cpu")
    shd.distribute_params(model, mesh)
    out["params"][arch] = {
        n: [list(p.shape), [str(pl) for pl in p.placements],
            isinstance(p, torch.nn.Parameter), isinstance(p, DTensor)]
        for n, p in model.named_parameters()}

# the hint function's layouts on DTensor activations, heads divisible by
# 'model' (2 kv heads) or not (1), and a plain tensor passing unchanged
whole = [Replicate(), Replicate()]
for kv in (2, 1):
    fn = shd.make_hint_fn(mesh, kv, True, ssm_heads=4)
    for name, shape in (("attn_q6", (4, kv, 2, 2, 8, 16)),
                        ("attn_kv5", (4, kv, 2, 8, 16)),
                        ("attn_out", (4, 2 * kv, 16, 16)),
                        ("ffn_hidden", (4, 16, 64)),
                        ("ssm_x4", (4, 4, 16, 8)),
                        ("ssm_dt3", (4, 4, 16)),
                        ("other", (4, 4))):
        x = distribute_tensor(torch.randn(shape), mesh, whole)
        y = fn(name, x)
        out["hints"][f"{name} {kv}"] = [str(pl) for pl in y.placements]
        assert torch.equal(y.full_tensor(), x.full_tensor())
    t = torch.randn(4, 2, 2, 2, 8, 16)
    assert fn("attn_q6", t) is t
out["residual"] = [[str(pl) for pl in shd.residual_spec(mesh, sp)]
                   for sp in (True, False)]
out["axes"] = [list(shd.zip_axis(mesh)), list(shd.data_axes(mesh))]
batch = shd.distribute_batch({"tokens": torch.arange(32).reshape(8, 4)},
                             mesh)["tokens"]
out["batch"] = [str(pl) for pl in batch.placements]
out["batch local"] = batch.to_local().tolist()
if rank == 0:
    with open(f"{tmp}/port.json", "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    procs = spawn_ranks(RANKS, tmp, prelude=f"ARCHS = {ARCHS!r}\n")
    procs.append(spawn_reference(REFERENCE.format(
        archs=ARCHS, path=str(tmp / "reference.json"))))
    outs = wait_all(procs)
    assert "REFERENCE_OK" in outs[-1]
    with open(tmp / "port.json") as f:
        port = json.load(f)
    with open(tmp / "reference.json") as f:
        ref = json.load(f)
    return port, ref


def expected_placements(spec, mesh_dims=("data", "model")):
    """A reference spec as DTensor placements: Shard(d) on the mesh dims
    that tensor dim d names, Replicate on the rest."""
    out = []
    for name in mesh_dims:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, list) and name in e)]
        out.append(str(Shard(dims[0])) if dims else str(Replicate()))
    return out


def reference_name(name: str, cfg) -> str:
    """The reference's `keystr` of a port parameter's counterpart leaf."""
    top = {"embed": "['embed']['table']",
           "final_norm": "['final_norm']['scale']",
           "lm_head": "['lm_head']['kernel']",
           "vision_proj": "['vision_proj']['kernel']"}
    if name in top:
        return top[name]
    _, layer, rest = name.split(".", 2)
    inverse = {v: k for k, v in _LAYER_LEAVES.items()}
    i = int(layer)
    for si, (kinds, rep) in enumerate(cfg.pattern):
        if i < len(kinds) * rep:
            ki = i % len(kinds)
            return f"['segments'][{si}][{ki}]" + "".join(
                f"[{k!r}]" for k in inverse[rest])
        i -= len(kinds) * rep
    raise AssertionError(name)


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_match_the_reference_param_specs(layouts, arch):
    """Every port parameter, put on the mesh by `distribute_params`, is a
    DTensor parameter with the placements of the reference's
    `param_specs` for its leaf (its stacked layer dim dropped), and
    every reference leaf has its port parameter."""
    from repro.configs import get as j_get
    from repro.configs.base import reduced as j_reduced

    port, ref = layouts
    cfg = j_reduced(j_get(arch))
    got, want = port["params"][arch], ref[arch]
    seen = set()
    sharded = 0
    for name, (shape, pls, is_param, is_dtensor) in got.items():
        assert is_param and is_dtensor, name
        key = reference_name(name, cfg)
        wshape, spec = want[key]
        stacked = key.startswith("['segments']")
        if stacked:
            assert wshape[1:] == shape, name
            spec = spec[1:] + [None] * (len(shape) + 1 - len(spec))
        assert pls == expected_placements(spec), (name, pls, spec)
        sharded += pls != [str(Replicate())] * 2
        seen.add(key)
    assert seen == set(want)
    assert sharded > 0


def test_hint_layouts(layouts):
    """`make_hint_fn`'s layouts as the reference's: batch over 'data';
    attention on heads over 'model' when the kv heads divide it, else
    (context parallel) the q blocks, the kv replicated; FFN hidden on
    d_ff; SSM heads when they divide; unnamed sites unchanged."""
    h = layouts[0]["hints"]
    r, s0 = str(Replicate()), str(Shard(0))
    assert h["attn_q6 2"] == [s0, str(Shard(1))]
    assert h["attn_q6 1"] == [s0, str(Shard(3))]
    assert h["attn_kv5 2"] == [s0, str(Shard(1))]
    assert h["attn_kv5 1"] == [s0, r]
    assert h["attn_out 2"] == [s0, str(Shard(1))]
    assert h["attn_out 1"] == [s0, str(Shard(2))]
    assert h["ffn_hidden 2"] == h["ffn_hidden 1"] == [s0, str(Shard(2))]
    assert h["ssm_x4 2"] == h["ssm_dt3 2"] == [s0, str(Shard(1))]
    assert h["other 2"] == [r, r]


def test_residual_spec_batch_and_mesh_helpers(layouts):
    port = layouts[0]
    s0, r = str(Shard(0)), str(Replicate())
    assert port["residual"] == [[s0, str(Shard(1))], [s0, r]]
    assert port["axes"] == [[["data", 2], ["model", 2]], ["data"]]
    assert port["batch"] == [s0, r]
    assert len(port["batch local"]) == 4          # 8 rows over 2 shards
    assert np.asarray(port["batch local"]).shape == (4, 4)
