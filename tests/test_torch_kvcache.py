"""The port's paged KV cache (`repro_torch.serve.kvcache`) on the CPU,
against the JAX package's (`repro.serve.kvcache`).

The pool functions (`init_paged_kv`, `append_token`, `gather_kv`) take the
same NumPy inputs, made from a seed, in f32 and bf16 and must give the same
bits.  The descriptor half is a NumPy copy of the reference: `PagePool` and
`make_page_tables` hand out the same pages, every column of each builder's
`DescriptorBatch` is equal, and `PagedKVDMA`'s append and gather move the
same bytes with the same engine stats as the reference's in all four modes
(the timing model on and off, the plan cache on and off).  The cases of
tests/test_kv_dma.py (paged-via-DMA == contiguous) and the paged ==
contiguous case of tests/test_serve.py are held here on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.kvcache as J
import repro_torch.serve.kvcache as T

N_PAGES, PAGE_SIZE, HKV, DH = 16, 4, 2, 8
B, STEPS = 3, 8
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layout(C=T):
    return C.KVLayout(N_PAGES, PAGE_SIZE, HKV, DH, itemsize=4)


def jbits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def tbits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def same_bits(jax_out, torch_out) -> None:
    assert tuple(np.asarray(jax_out).shape) == tuple(torch_out.shape)
    assert np.array_equal(jbits(jax_out), tbits(torch_out))


def tokens(rng, dtype: str):
    """One token's (k, v) for B rows, as float32 NumPy rounded to `dtype`
    the same way on both sides."""
    kv = [rng.standard_normal((B, HKV, DH)).astype(np.float32)
          for _ in range(2)]
    return [np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
            for a in kv]


# -- the pool functions ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_append_gather_equal_jax(dtype):
    rng = np.random.default_rng(0)
    tables = J.make_page_tables(J.PagePool(N_PAGES, PAGE_SIZE), B, STEPS)
    jpool = J.init_paged_kv(N_PAGES, PAGE_SIZE, HKV, DH, dtype=JDT[dtype])
    tpool = T.init_paged_kv(N_PAGES, PAGE_SIZE, HKV, DH, dtype=TDT[dtype],
                            device="cpu")
    same_bits(jpool["k"], tpool["k"])
    for pos in range(STEPS):
        k, v = tokens(rng, dtype)
        jpool = J.append_token(jpool, jnp.asarray(tables), jnp.int32(pos),
                               jnp.asarray(k), jnp.asarray(v), PAGE_SIZE)
        back = T.append_token(tpool, torch.from_numpy(tables), pos,
                              torch.from_numpy(k), torch.from_numpy(v),
                              PAGE_SIZE)
        assert back is tpool                   # written in place
        same_bits(jpool["k"], tpool["k"])
        same_bits(jpool["v"], tpool["v"])
    for max_len in (STEPS, PAGE_SIZE + 2):     # whole pages, then a part
        jk, jv = J.gather_kv(jpool, jnp.asarray(tables), max_len, PAGE_SIZE)
        tk, tv = T.gather_kv(tpool, torch.from_numpy(tables), max_len,
                             PAGE_SIZE)
        same_bits(jk, tk)
        same_bits(jv, tv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_to_a_repeated_page_keeps_the_last_row_like_jax(dtype):
    """Rows 0, 2 and 3 name one physical page: `.at[].set` keeps the last
    row's values; so must the port, whatever the device does with
    repeated indices."""
    rng = np.random.default_rng(1)
    tables = np.asarray([[5, 1], [2, 1], [5, 3], [5, 0]], np.int32)
    n = tables.shape[0]
    k = rng.standard_normal((n, HKV, DH)).astype(np.float32)
    v = rng.standard_normal((n, HKV, DH)).astype(np.float32)
    jpool = J.init_paged_kv(N_PAGES, PAGE_SIZE, HKV, DH, dtype=JDT[dtype])
    tpool = T.init_paged_kv(N_PAGES, PAGE_SIZE, HKV, DH, dtype=TDT[dtype],
                            device="cpu")
    jpool = J.append_token(jpool, jnp.asarray(tables), jnp.int32(1),
                           jnp.asarray(k), jnp.asarray(v), PAGE_SIZE)
    T.append_token(tpool, torch.from_numpy(tables), 1, torch.from_numpy(k),
                   torch.from_numpy(v), PAGE_SIZE)
    same_bits(jpool["k"], tpool["k"])
    same_bits(jpool["v"], tpool["v"])
    assert torch.equal(tpool["k"][5, 1],
                       torch.from_numpy(k[3]).to(TDT[dtype]))
    # the rows stored: the last of each page, so no index repeats
    assert T._last_occurrence(torch.tensor([5, 2, 5, 5])).tolist() == [1, 3]


def test_paged_equals_contiguous():
    Bp, Hkv, dh, page, S = 2, 2, 16, 8, 64
    alloc = T.PagePool(n_pages=Bp * S // page + 4, page_size=page)
    tables = torch.from_numpy(T.make_page_tables(alloc, Bp, S))
    pool = T.init_paged_kv(alloc.n_pages, page, Hkv, dh, torch.float32,
                           device="cpu")
    want_k = torch.zeros((Bp, Hkv, S, dh))
    want_v = torch.zeros((Bp, Hkv, S, dh))
    gen = torch.Generator().manual_seed(0)
    for pos in range(S):
        k = torch.randn((Bp, Hkv, dh), generator=gen)
        v = torch.randn((Bp, Hkv, dh), generator=gen)
        pool = T.append_token(pool, tables, pos, k, v, page)
        want_k[:, :, pos], want_v[:, :, pos] = k, v
    gk, gv = T.gather_kv(pool, tables, S, page)
    assert torch.equal(gk, want_k) and torch.equal(gv, want_v)


def test_init_paged_kv_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_paged_kv(N_PAGES, PAGE_SIZE, HKV, DH)


def test_page_pools_hand_out_the_same_pages():
    pools = [C.PagePool(N_PAGES, PAGE_SIZE) for C in (J, T)]
    tables = [C.make_page_tables(p, B, STEPS + 1) for C, p in
              zip((J, T), pools)]
    assert tables[0].dtype == tables[1].dtype
    assert np.array_equal(tables[0], tables[1])
    for p, t in zip(pools, tables):
        p.release(t[1])
        p.release([-1])                        # unallocated slots skip
    assert pools[0].free == pools[1].free
    again = [p.alloc() for p in pools]         # a released page comes back
    assert again[0] == again[1] == int(tables[0][1][-1])
    for p in pools:
        while p.free:
            p.alloc()
        with pytest.raises(MemoryError):
            p.alloc()


# -- the descriptor builders -------------------------------------------------

def columns(batch) -> dict:
    cols = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if f.name != "options"}
    cols["options"] = batch.options is None
    return cols


def assert_same_columns(jb, tb) -> None:
    jc, tc = columns(jb), columns(tb)
    assert jc.keys() == tc.keys()
    for name in jc:
        assert np.array_equal(jc[name], tc[name]), name
        assert np.asarray(jc[name]).dtype == np.asarray(tc[name]).dtype, name


BUILDERS = {
    "gather": lambda C, lay, t: C.gather_descriptors(
        lay, t, STEPS, pool_base=64, dst_base=4096),
    "gather_part": lambda C, lay, t: C.gather_descriptors(
        lay, t, PAGE_SIZE + 2),
    "append": lambda C, lay, t: C.append_descriptors(
        lay, t, 5, src_base=128, pool_base=lay.pool_bytes),
    "span_append": lambda C, lay, t: C.span_append_descriptors(
        lay, t[0], 3, 7, stage_k=100, stage_v=200),
    "span_append_row": lambda C, lay, t: C.span_append_descriptors(
        lay, t[1], 6, 7, stage_k=0, stage_v=32, pool_base=8),
    "swap_out": lambda C, lay, t: C.swap_descriptors(
        lay, t[0], [1, 0], "out"),
    "swap_in": lambda C, lay, t: C.swap_descriptors(
        lay, t[2], [3, 2], "in", pool_base=16, host_base=256),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_columns_equal_jax(name):
    tables = T.make_page_tables(T.PagePool(N_PAGES, PAGE_SIZE), B, STEPS)
    jb = BUILDERS[name](J, layout(J), tables)
    tb = BUILDERS[name](T, layout(T), tables)
    assert len(jb) == len(tb) > 0
    assert_same_columns(jb, tb)


def test_swap_refusals_match_jax():
    for C in (J, T):
        with pytest.raises(ValueError, match="one slot per block"):
            C.swap_descriptors(layout(C), [1, 2], [0], "out")
        with pytest.raises(ValueError, match="direction"):
            C.swap_descriptors(layout(C), [1], [0], "sideways")


def test_descriptor_builders_shapes():
    lay = layout()
    tables = T.make_page_tables(T.PagePool(N_PAGES, PAGE_SIZE), B, STEPS)
    g = T.gather_descriptors(lay, tables, STEPS)
    assert len(g) == B * (STEPS // PAGE_SIZE)
    assert int(g.length.sum()) == B * STEPS * lay.row_bytes
    assert (g.length == lay.page_bytes).all()
    a = T.append_descriptors(lay, tables, pos=5)
    assert len(a) == B
    assert (a.length == lay.row_bytes).all()
    phys = tables[:, 5 // PAGE_SIZE].astype(np.int64)
    want = phys * lay.page_bytes + (5 % PAGE_SIZE) * lay.row_bytes
    assert np.array_equal(a.dst_addr, want)


def test_gather_matches_manual_page_walk():
    lay = layout()
    tables = T.make_page_tables(T.PagePool(N_PAGES, PAGE_SIZE), B, STEPS)
    g = T.gather_descriptors(lay, tables, STEPS)
    n = STEPS // PAGE_SIZE
    want_src = tables[:, :n].astype(np.int64).reshape(-1) * lay.page_bytes
    assert np.array_equal(g.src_addr, want_src)
    assert int(g.src_proto[0]) != int(g.dst_proto[0])   # HBM -> VMEM


# -- PagedKVDMA --------------------------------------------------------------

def run_dma(C, seed=0, num_channels=1, timing=True, plan_cache=True,
            steps=STEPS):
    """`steps` appends of seeded rows and a gather through package C's
    `PagedKVDMA`; returns (k, v, dma)."""
    rng = np.random.default_rng(seed)
    tables = C.make_page_tables(C.PagePool(N_PAGES, PAGE_SIZE), B, STEPS)
    dma = C.PagedKVDMA(layout(C), max_batch=B, max_len=STEPS,
                       num_channels=num_channels, timing=timing,
                       plan_cache=plan_cache)
    for pos in range(steps):
        k = rng.standard_normal((B, HKV, DH)).astype(np.float32)
        v = rng.standard_normal((B, HKV, DH)).astype(np.float32)
        dma.append(tables, pos, k, v)
    k, v = dma.gather(tables, STEPS)
    return k, v, dma, tables


def stats(dma) -> dict:
    s = dma.engine.stats
    out = {name: getattr(s, name) for name in
           ("bytes_moved", "bursts", "submitted", "completed", "errors")}
    if dma.plan_cache is not None:
        out["plan_hits"] = dma.plan_cache.stats.hits
        out["plan_misses"] = dma.plan_cache.stats.misses
    return out


@pytest.mark.parametrize("timing", [True, False])
@pytest.mark.parametrize("plan_cache", [True, False])
def test_paged_kv_dma_equals_jax(timing, plan_cache):
    jk, jv, jdma, _ = run_dma(J, seed=5, timing=timing,
                              plan_cache=plan_cache)
    tk, tv, tdma, tables = run_dma(T, seed=5, timing=timing,
                                   plan_cache=plan_cache)
    assert np.array_equal(jk, tk) and np.array_equal(jv, tv)
    assert stats(jdma) == stats(tdma)
    assert (jdma.engine.last_channel_result is None) == (not timing)
    if not timing and plan_cache:
        assert tdma.plan_cache.stats.hits > 0  # template replay ran
    # ... and equal to the port's pool functions over the same rows
    rng = np.random.default_rng(5)
    pool = T.init_paged_kv(N_PAGES, PAGE_SIZE, HKV, DH, torch.float32,
                           device="cpu")
    for pos in range(STEPS):
        k = torch.from_numpy(rng.standard_normal((B, HKV, DH))
                             .astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((B, HKV, DH))
                             .astype(np.float32))
        T.append_token(pool, torch.from_numpy(tables), pos, k, v, PAGE_SIZE)
    gk, gv = T.gather_kv(pool, torch.from_numpy(tables), STEPS, PAGE_SIZE)
    assert np.array_equal(gk.numpy(), tk) and np.array_equal(gv.numpy(), tv)


def test_multi_channel_engine_same_bytes():
    jk, jv, jdma, _ = run_dma(J, seed=1, num_channels=4)
    tk, tv, tdma, _ = run_dma(T, seed=1, num_channels=4)
    assert np.array_equal(jk, tk) and np.array_equal(jv, tv)
    assert len(tdma.engine.last_channel_result.per_channel) == 4
    assert tdma.engine.last_channel_result.total_cycles == \
        jdma.engine.last_channel_result.total_cycles


def test_traffic_is_engine_transfers():
    _, _, dma, _ = run_dma(T, seed=2)
    lay = layout()
    append_bytes = STEPS * B * lay.row_bytes * 2
    gather_bytes = B * (STEPS // PAGE_SIZE) * lay.page_bytes * 2
    assert dma.engine.stats.bytes_moved == append_bytes + gather_bytes
    assert dma.engine.stats.errors == 0


def test_gather_partial_page_truncates_like_reference():
    out = []
    for C in (J, T):
        _, _, dma, tables = run_dma(C, seed=3)
        out.append(dma.gather(tables, PAGE_SIZE + 2)[0])
    assert out[0].shape == out[1].shape == (B, HKV, PAGE_SIZE, DH)
    assert np.array_equal(out[0], out[1])


def test_gather_results_do_not_alias_vmem():
    k1, _, dma, tables = run_dma(T, seed=4)
    snapshot = k1.copy()
    dma._pool("k")[:] = 0                      # wipe the physical pool
    zeros, _ = dma.gather(tables, STEPS)       # reuses the VMEM region
    assert np.array_equal(k1, snapshot)        # old result untouched
    assert not np.array_equal(zeros, k1)
    assert not zeros.any()
