"""The port's checkpoint engine: every case of `tests/test_checkpoint.py`
but the restore onto a mesh (in `tests/test_torch_dist_mesh.py`, on four
ranks), run against `repro_torch.dist.checkpoint`, and the format across
the two packages:
either one restores the other's checkpoints bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import checkpoint as j_ckpt
from repro_torch.core.engine import ErrorPolicy
from repro_torch.dist import checkpoint as ckpt


def tree():
    return {
        "a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
        "b": [torch.ones((5,), dtype=torch.bfloat16),
              torch.zeros((2, 2), dtype=torch.int32)],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def like():
    """The structure of `tree()`, unset: `restore` fills it in place."""
    return _map(torch.empty_like, tree())


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v) for v in node]
    return fn(node)


def leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in leaves(v)]
    return [t]


def test_roundtrip(tmp_path):
    t = tree()
    path = ckpt.save(t, str(tmp_path), step=7)
    target = like()
    out = ckpt.restore(path, target)
    for a, b, c in zip(leaves(t), leaves(out), leaves(target)):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert b is c                          # filled in place


def test_latest_and_prune(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4):
        ckpt.save(t, str(tmp_path), step=s)
    assert ckpt.latest(str(tmp_path)).step == 4
    ckpt.prune(str(tmp_path), keep=2)
    assert len(ckpt.list_checkpoints(str(tmp_path))) == 2


def test_checksum_verification(tmp_path):
    t = tree()
    path = ckpt.save(t, str(tmp_path), step=1)
    # corrupt the payload
    payload = os.path.join(path, ckpt.PAYLOAD)
    arrs = dict(np.load(payload))
    key = sorted(arrs)[0]
    arrs[key] = arrs[key] + 1
    np.savez(payload.replace(".npz", ""), **arrs)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(path, like())


class TestErrorVerbs:
    def _flaky(self, fail_names, max_fails=1):
        fails = {}

        def hook(name):
            if any(f in name for f in fail_names):
                n = fails.get(name, 0)
                if n < max_fails:
                    fails[name] = n + 1
                    raise IOError(f"injected write fault for {name}")
        return hook

    def test_replay_retries_and_succeeds(self, tmp_path):
        t = tree()
        path = ckpt.save(t, str(tmp_path), step=1,
                         error_policy=ErrorPolicy(action="replay"),
                         _fault_hook=self._flaky(["'w'"]))
        out = ckpt.restore(path, like())
        assert torch.equal(out["a"]["w"], t["a"]["w"])

    def test_abort_raises(self, tmp_path):
        with pytest.raises(IOError):
            ckpt.save(tree(), str(tmp_path), step=1,
                      error_policy=ErrorPolicy(action="abort"),
                      _fault_hook=self._flaky(["'w'"], max_fails=99))

    def test_continue_marks_partial(self, tmp_path):
        path = ckpt.save(tree(), str(tmp_path), step=1,
                         error_policy=ErrorPolicy(action="continue"),
                         _fault_hook=self._flaky(["'w'"], max_fails=99))
        infos = ckpt.list_checkpoints(str(tmp_path))
        assert len(infos) == 1 and not infos[0].complete
        # incomplete checkpoints are not eligible for restore-latest
        assert ckpt.latest(str(tmp_path)) is None
        assert os.path.basename(path) == "step_00000001"


# --------------------------------------------------------------------------
# Across the two packages
# --------------------------------------------------------------------------

def seeded_pair(seed=0):
    """The same dict-and-list tree of f32, bf16 and i32 leaves (a 0-d one
    among them, bf16 with NaN and -0.0 bits), as torch and as jax."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bits = rng.integers(0, 1 << 16, 40, dtype=np.uint16)
    bits[:2] = (0x7FC1, 0x8000)
    i32 = rng.integers(-2**31, 2**31 - 1, (4, 2), dtype=np.int64) \
        .astype(np.int32)
    t = {"params": {"w": torch.from_numpy(f32.copy()),
                    "e": torch.from_numpy(bits.view(np.int16).copy())
                    .view(torch.bfloat16)},
         "opt": [torch.from_numpy(i32.copy()),
                 torch.tensor(3, dtype=torch.int32)]}
    j = {"params": {"w": jnp.asarray(f32),
                    "e": jnp.asarray(bits).view(jnp.bfloat16)},
         "opt": [jnp.asarray(i32), jnp.asarray(3, jnp.int32)]}
    return t, j


def bits(x):
    a = np.asarray(x.view(torch.int16) if isinstance(x, torch.Tensor) and
                   x.dtype == torch.bfloat16 else x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a.tobytes(), a.dtype.itemsize, a.shape


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    t, j = seeded_pair(1)
    path = j_ckpt.save(j, str(tmp_path), step=3)
    out = ckpt.restore(path, _map(torch.empty_like, t))
    for a, b in zip(jax.tree_util.tree_leaves(j), leaves(out)):
        assert bits(a) == bits(b)
    assert out["params"]["e"].dtype == torch.bfloat16


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    t, j = seeded_pair(2)
    path = ckpt.save(t, str(tmp_path), step=4)
    out = j_ckpt.restore(path, jax.eval_shape(lambda: j))
    for a, b in zip(jax.tree_util.tree_leaves(j),
                    jax.tree_util.tree_leaves(out)):
        assert bits(a) == bits(b) and np.asarray(b).dtype == \
            np.asarray(a).dtype


def test_leaf_names_are_the_references(tmp_path):
    """The same tree written by either package has the same meta.json
    leaves: names, keys, dtypes, shapes and checksums."""
    import json
    t, j = seeded_pair(3)
    a = ckpt.save(t, str(tmp_path / "port"), step=1)
    b = j_ckpt.save(j, str(tmp_path / "ref"), step=1)
    ma, mb = (json.load(open(os.path.join(p, ckpt.META))) for p in (a, b))
    assert ma == mb


def test_module_state_roundtrip(tmp_path):
    """A train state (a module, its moments, the step) restores into an
    unset state on the same device, in place and bit for bit, under the
    names `['params']['layers.0.attn.wq']`."""
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.train import init_train_state
    cfg = reduced(get("gemma2-2b"))
    rcfg = RunConfig(dtype="float32")
    state = init_train_state(3, cfg, rcfg, device="cpu")
    state["opt"]["mu"]["embed"].normal_()
    path = ckpt.save(state, str(tmp_path), step=5)
    target = init_train_state(0, cfg, rcfg, device="cpu", init=False)
    wq = target["params"].layers[0].attn.wq
    out = ckpt.restore(path, target)
    assert out["params"] is target["params"] and \
        out["params"].layers[0].attn.wq is wq
    for (n, p), (_, q) in zip(state["params"].named_parameters(),
                              out["params"].named_parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(out["opt"]["mu"]["embed"], state["opt"]["mu"]["embed"])
    import json
    names = [m["name"] for m in json.load(open(
        os.path.join(path, ckpt.META)))["leaves"]]
    assert "['params']['layers.0.attn.wq']" in names and "['step']" in names


def test_restore_refuses_a_mismatched_tree(tmp_path):
    path = ckpt.save(tree(), str(tmp_path), step=1)
    bad = like()
    bad["a"]["w"] = torch.empty(4, 3)
    with pytest.raises(IOError, match="leaf"):
        ckpt.restore(path, bad)
    bad = like()
    del bad["a"]
    bad["c"] = torch.empty(1)
    with pytest.raises(IOError, match="no leaf"):
        ckpt.restore(path, bad)


def test_restore_onto_a_device_makes_new_tensors(tmp_path):
    """With `device`, tensor leaves come back as new tensors there (the
    `like` tree is left as it was); a leaf of `like` that is not a tensor
    becomes one."""
    path = ckpt.save(tree(), str(tmp_path), step=1)
    target = like()
    target["a"]["w"] = np.zeros((3, 4), np.float32)
    out = ckpt.restore(path, target, device="cpu")
    for a, b in zip(leaves(tree()), leaves(out)):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    assert out["b"][0] is not target["b"][0]
    assert not np.any(target["a"]["w"])
