"""The port's AdamW and cosine schedule against the reference's, on the
same seeded NumPy trees, in one process on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (adamw_init as j_init, adamw_update as j_update,
                         cosine_schedule as j_cosine,
                         global_norm as j_global_norm)
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               global_norm)

RTOL = 1e-6     # fp32, the same operations in the same order per element


def numpy_tree(seed, scale=1.0):
    """A dict/list tree of fp32 leaves: a matrix, a norm scale, a 0-d
    leaf and a leaf larger than adamw's slice, so the slicing is met."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": r(13, 7), "norm": {"scale": r(7)},
            "layers": [r(3), np.asarray(rng.standard_normal() * scale,
                                             np.float32)], "big": r(70_000)}


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.array(a)), tree)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_the_reference(grad_clip, weight_decay,
                                            monkeypatch):
    """Four steps from zero moments, grads of norm ~300 (so clipping at 1
    bites), at lr 1e-2: parameters, both moments and the grad norm
    within RTOL of the reference's; the count equal."""
    import repro_torch.optim.adamw as A
    monkeypatch.setattr(A, "CHUNK", 4096)      # "big" takes 18 slices
    p0 = numpy_tree(0)
    jp, jst = jax.tree_util.tree_map(jnp.asarray, p0), None
    tp = to_torch(p0)
    jst, tst = j_init(jp), adamw_init(tp)
    for i in range(4):
        g = numpy_tree(10 + i, scale=1.1)
        jp, jst, jm = j_update(jax.tree_util.tree_map(jnp.asarray, g), jst,
                               jp, 1e-2, weight_decay=weight_decay,
                               grad_clip=grad_clip)
        tp2, tst2, tm = adamw_update(to_torch(g), tst, tp, 1e-2,
                                     weight_decay=weight_decay,
                                     grad_clip=grad_clip)
        assert tp2 is tp and tst2 is tst         # updated in place
        assert rel(tm["grad_norm"], jm["grad_norm"]) < RTOL
    for name, got, want in (("params", tp, jp), ("mu", tst["mu"], jst["mu"]),
                            ("nu", tst["nu"], jst["nu"])):
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert rel(a, b) < RTOL, name
    assert int(tst["count"]) == int(jst["count"]) == 4


def test_global_norm_matches_the_reference():
    t = numpy_tree(3, scale=2.0)
    want = float(j_global_norm(jax.tree_util.tree_map(jnp.asarray, t)))
    assert rel(global_norm(to_torch(t)), want) < RTOL


def test_adamw_init_is_fp32_zeros_on_the_leaves_device():
    st = adamw_init({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert st["mu"]["a"].dtype == torch.float32
    assert not st["nu"]["a"].any() and int(st["count"]) == 0


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5_000, 9_999,
                                  10_000, 12_000])
def test_cosine_schedule_matches_the_reference(step):
    """Steps 0 and the warmup exactly; the cosine within one fp32 ulp."""
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = np.float32(j_cosine(step, **kw))
    got = cosine_schedule(step, **kw)
    assert got.dtype == torch.float32
    if step <= 100:
        assert np.float32(got) == want
    else:
        assert abs(float(got) - float(want)) <= \
            float(np.spacing(np.float32(want)))
