"""The port's continuous-batching front door (`repro_torch.serve.sched`) on
the CPU, against the JAX package's (`repro.serve.sched`).

`alloc`, `sched`, `model` and `front` are NumPy copies of the reference:
the same requests, made from a seed, must give the same outputs, the same
simulated cycles step by step and the same allocator stats, under irq and
poll completion and in a pool starved enough to preempt and swap.  The
cases of tests/test_serve_sched.py are held here on the port, the
sanitized one included (`repro_torch.sanitize` certifies every drain).

`StepLM` is rewritten in PyTorch.  On reduced gemma2-2b, mamba2-1.3b and
hymba-1.5b (2 layers, fp32, the same weights in both packages) its greedy
streams equal the JAX `StepLM`'s; every stream, hot rows included, is the
same at `max_running` 4 and 1; and a request's decode logits are
`torch.equal` whatever other requests are in flight.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serve.sched as JS
from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.serve.kvcache import KVLayout as JKVLayout
from repro_torch.configs.base import ArchConfig
from repro_torch.core import Protocol
from repro_torch.models import lm_from_numpy
import repro_torch.serve.sched as TS
from repro_torch.serve import StepLM
from repro_torch.serve.kvcache import (KVLayout, span_append_descriptors,
                                       swap_descriptors)
from test_torch_serve import seeded_params

LAYOUT = dict(n_pages=24, page_size=4, n_kv_heads=2, head_dim=4,
              itemsize=4)   # row 32 B, page 128 B
SMALL = dict(LAYOUT, n_pages=10)


def _requests(S, n, seed=0, vocab=64, max_prompt=12, max_new=10):
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(2, max_prompt + 1))
        reqs.append(S.ServeRequest(
            rid=rid,
            prompt=list(map(int, rng.integers(0, vocab, plen))),
            max_new_tokens=int(rng.integers(2, max_new + 1)),
            temperature=float(rng.choice([0.0, 0.8])),
            seed=int(rng.integers(0, 1 << 31))))
    return reqs


def _run_front(reqs, S=TS, layout=LAYOUT, gap=0, **kw):
    lay = (KVLayout if S is TS else JKVLayout)(**layout)
    model = S.HashLM(lay.row_bytes)
    kw.setdefault("max_seq_len", 24)
    fd = S.ServeFrontDoor(model, lay, **kw)
    for i, r in enumerate(reqs):
        fd.submit(r, at_cycle=i * gap)
    fd.run()
    return fd, model


def _record(fd, reqs):
    """What must match the reference: outputs, each step's metrics and
    the allocator's lifetime stats."""
    return ([r.output for r in reqs],
            [dataclasses.astuple(m) for m in fd.metrics.per_step],
            dataclasses.astuple(fd.alloc.stats), fd.metrics.cycles)


# -- the allocator -----------------------------------------------------------

class TestBlockAllocator:
    def test_alloc_free_refcount(self):
        a = TS.BlockAllocator(8)
        blocks = a.alloc(3)
        assert len(set(blocks)) == 3 and a.used_blocks == 3
        a.incref([blocks[0]])
        a.decref([blocks[0]])
        assert a.used_blocks == 3           # still referenced once
        a.decref(blocks)
        assert a.used_blocks == 0 and a.free_blocks == 8
        a.check()

    def test_exhaustion_and_watermark(self):
        a = TS.BlockAllocator(8, low_watermark=2)
        assert a.can_alloc(8) and not a.can_alloc(9)
        assert a.above_watermark(6) and not a.above_watermark(7)
        with pytest.raises(MemoryError):
            a.alloc(9)
        assert a.stats.failures == 1

    def test_swap_slots_and_leak_detection(self):
        a = TS.BlockAllocator(4, n_swap_slots=2)
        blocks = a.alloc(2)
        slots = a.alloc_swap(2)
        assert not a.can_alloc_swap(1)
        assert sorted(a.leaked()) == sorted(blocks)
        a.free_swap(slots)
        a.decref(blocks)
        assert a.leaked() == []
        a.check()

    def test_double_free_raises(self):
        a = TS.BlockAllocator(4)
        (b,) = a.alloc(1)
        a.decref([b])
        with pytest.raises(ValueError):
            a.decref([b])

    def test_random_ops_equal_jax(self):
        """One seeded sequence of allocs, increfs, decrefs and swap-slot
        moves through both allocators: the same blocks handed out, the
        same stats and free lists."""
        rng = np.random.default_rng(7)
        allocs = [S.BlockAllocator(16, n_swap_slots=6, low_watermark=2)
                  for S in (JS, TS)]
        held, slots = [], []
        for _ in range(400):
            op = int(rng.integers(0, 5))
            n = int(rng.integers(1, 4))
            got = []
            for a in allocs:
                if op == 0 and a.can_alloc(n):
                    got.append(a.alloc(n))
                elif op == 1 and held:
                    a.incref(held[-1])
                elif op == 2 and held:
                    a.decref(held[0])
                elif op == 3 and a.can_alloc_swap(n):
                    got.append(a.alloc_swap(n))
                elif op == 4 and slots:
                    a.free_swap(slots[0])
            if got:
                assert got[0] == got[1]
                (held if op == 0 else slots).append(got[0])
            elif op == 2 and held:
                held.pop(0)
            elif op == 4 and slots:
                slots.pop(0)
        j, t = allocs
        assert dataclasses.astuple(j.stats) == dataclasses.astuple(t.stats)
        assert j.leaked() == t.leaked()
        assert (j.free_blocks, j.free_swap_slots) == \
            (t.free_blocks, t.free_swap_slots)
        t.check()


# -- the front door's descriptor builders ------------------------------------

class TestDescriptorBuilders:
    def test_span_append_addresses(self):
        lay = KVLayout(**LAYOUT)
        batch = span_append_descriptors(lay, [5, 2], 3, 6,
                                        stage_k=100, stage_v=200)
        # positions 3..5 → (page 0, slot 3), (page 1, slots 0..1)
        k_dst = [5 * lay.page_bytes + 3 * lay.row_bytes,
                 2 * lay.page_bytes, 2 * lay.page_bytes + lay.row_bytes]
        v_dst = [lay.pool_bytes + d for d in k_dst]
        assert batch.dst_addr.tolist() == k_dst + v_dst
        assert batch.src_addr.tolist()[:3] == \
            [100, 100 + lay.row_bytes, 100 + 2 * lay.row_bytes]
        assert set(batch.length.tolist()) == {lay.row_bytes}
        assert batch.row(0).src_protocol == Protocol.VMEM
        assert batch.row(0).dst_protocol == Protocol.HBM

    def test_swap_round_trip_addresses(self):
        lay = KVLayout(**LAYOUT)
        out = swap_descriptors(lay, [3, 7], [1, 0], "out")
        back = swap_descriptors(lay, [3, 7], [1, 0], "in")
        assert out.src_addr.tolist() == back.dst_addr.tolist()
        assert out.dst_addr.tolist() == back.src_addr.tolist()
        pb = lay.page_bytes
        assert out.dst_addr.tolist() == [2 * pb, 0, 3 * pb, pb]
        with pytest.raises(ValueError):
            swap_descriptors(lay, [1, 2], [0], "out")
        with pytest.raises(ValueError):
            swap_descriptors(lay, [1], [0], "sideways")


# -- ServeFrontDoor over HashLM ----------------------------------------------

class TestFrontDoor:
    def test_oracle_identity_no_pressure(self):
        reqs = _requests(TS, 8, seed=1)
        fd, model = _run_front(reqs, max_running=8)
        assert fd.alloc.stats.preemptions == 0
        for r in reqs:
            assert r.output == TS.oracle_generate(
                model, r.seed, r.prompt, r.max_new_tokens,
                r.temperature, r.stop_tokens), f"rid {r.rid}"
        jreqs = _requests(JS, 8, seed=1)
        jfd, _ = _run_front(jreqs, S=JS, max_running=8)
        assert _record(fd, reqs) == _record(jfd, jreqs)

    @pytest.mark.parametrize("completion", ["irq", "poll"])
    def test_preemption_swap_equals_jax(self, completion):
        """Exhaustion → preemption → swap-out/in: the starved pool's run
        equals the oracle and the reference's run, step by step."""
        runs = []
        for S in (JS, TS):
            reqs = _requests(S, 14, seed=2)
            fd, model = _run_front(reqs, S=S, layout=SMALL, max_running=6,
                                   low_watermark=1, completion=completion)
            runs.append(_record(fd, reqs))
        assert fd.alloc.stats.preemptions > 0
        assert fd.alloc.stats.swapped_out == fd.alloc.stats.swapped_in > 0
        for r in reqs:
            assert r.output == TS.oracle_generate(
                model, r.seed, r.prompt, r.max_new_tokens,
                r.temperature, r.stop_tokens), f"rid {r.rid}"
        assert runs[0] == runs[1]

    def test_irq_equals_poll(self):
        runs = {}
        for mode in ("irq", "poll"):
            reqs = _requests(TS, 14, seed=3)
            fd, _ = _run_front(reqs, layout=SMALL, max_running=6,
                               low_watermark=1, completion=mode)
            runs[mode] = ([r.output for r in reqs], fd.metrics.steps,
                          fd.metrics.cycles, fd.alloc.stats.preemptions,
                          fd.alloc.stats.swapped_out)
        assert runs["irq"] == runs["poll"]
        assert runs["irq"][3] > 0           # pressure actually happened

    def test_churn_leaks_nothing(self):
        """1k requests through a starved pool: every block and swap slot
        back on the free lists, refcounts clean."""
        reqs = _requests(TS, 1000, seed=4, max_prompt=10, max_new=6)
        fd, _ = _run_front(reqs, layout=SMALL, max_running=6,
                           low_watermark=1, gap=300)
        assert fd.alloc.stats.preemptions > 0
        assert fd.alloc.leaked() == []
        assert fd.alloc.free_blocks == fd.alloc.n_blocks
        assert fd.alloc.free_swap_slots == fd.alloc.n_swap_slots
        fd.alloc.check()

    def test_eos_and_stop_tokens_release_blocks(self):
        lay = KVLayout(**LAYOUT)
        model = TS.HashLM(lay.row_bytes)
        fd = TS.ServeFrontDoor(model, lay, max_seq_len=24)
        stops = tuple(range(32))
        reqs = [TS.ServeRequest(rid=i, prompt=[i + 2, 5], max_new_tokens=20,
                                stop_tokens=stops, seed=i) for i in range(4)]
        for r in reqs:
            fd.submit(r)
        fd.run()
        assert any(len(r.output) < r.max_new_tokens for r in reqs)
        for r in reqs:
            assert r.output == TS.oracle_generate(model, r.seed, r.prompt,
                                                  r.max_new_tokens, 0.0,
                                                  stops)
            assert r.state is TS.ReqState.FINISHED and r.blocks == []

    def test_submit_rejects_oversize(self):
        lay = KVLayout(**LAYOUT)
        fd = TS.ServeFrontDoor(TS.HashLM(lay.row_bytes), lay, max_seq_len=16)
        with pytest.raises(ValueError):
            fd.submit(TS.ServeRequest(rid=0, prompt=[1] * 10,
                                      max_new_tokens=10))

    def test_plan_cache_reuse(self):
        reqs = _requests(TS, 12, seed=5)
        fd, _ = _run_front(reqs, max_running=8)
        assert fd.plan_cache.stats.hit_rate > 0.5
        jreqs = _requests(JS, 12, seed=5)
        jfd, _ = _run_front(jreqs, S=JS, max_running=8)
        assert fd.plan_cache.stats.hits == jfd.plan_cache.stats.hits

    def test_sanitize_raises_until_ported(self):
        """The reference's sanitized case (tests/test_serve_sched.py:131):
        with ``sanitize=True`` the starved pool's run, preemptions and
        swaps included, gives the reference's outputs, cycles and stats,
        every drain and plan-cache hit is certified clean, and the report
        count equals the reference's."""
        runs, counts = [], []
        for S in (JS, TS):
            reqs = _requests(S, 14, seed=2)
            fd, model = _run_front(reqs, S=S, layout=SMALL, max_running=6,
                                   low_watermark=1, sanitize=True)
            runs.append(_record(fd, reqs))
            reports = fd.engine.sanitize_reports
            assert reports and all(r.clean for r in reports)
            counts.append((len(reports), sum(r.checked_rows
                                             for r in reports)))
        assert fd.engine.sanitize == "raise"
        assert fd.alloc.stats.preemptions > 0
        assert fd.alloc.stats.swapped_out == fd.alloc.stats.swapped_in > 0
        for r in reqs:
            assert r.output == TS.oracle_generate(
                model, r.seed, r.prompt, r.max_new_tokens,
                r.temperature, r.stop_tokens), f"rid {r.rid}"
        assert runs[0] == runs[1]
        assert counts[0] == counts[1]


class TestHashLM:
    def test_rows_deterministic_and_positional(self):
        m = TS.HashLM(32)
        a = m.kv_rows(7, [1, 2, 3], 0, 3, "k")
        assert np.array_equal(a, m.kv_rows(7, [1, 2, 3], 0, 3, "k"))
        assert not np.array_equal(a[0], a[1])          # position-keyed
        assert not np.array_equal(a, m.kv_rows(7, [1, 2, 3], 0, 3, "v"))
        assert not np.array_equal(a, m.kv_rows(8, [1, 2, 3], 0, 3, "k"))
        assert np.array_equal(m.kv_rows(7, [1, 2, 3], 2, 3, "k"), a[2:])
        j = JS.HashLM(32)
        assert np.array_equal(a, j.kv_rows(7, [1, 2, 3], 0, 3, "k"))

    def test_digest_sensitive_to_any_byte(self):
        m, j = TS.HashLM(32), JS.HashLM(32)
        kb = m.kv_rows(1, [4, 5], 0, 2, "k").reshape(-1)
        vb = m.kv_rows(1, [4, 5], 0, 2, "v").reshape(-1)
        for temperature in (0.0, 0.8):
            req = type("R", (), {"seed": 1, "tokens": [4, 5],
                                 "temperature": temperature})()
            assert m.next_tokens([req], [(kb, vb)]) == \
                j.next_tokens([req], [(kb, vb)])
        req.temperature = 0.0
        base = m.next_tokens([req], [(kb, vb)])[0]
        flip = kb.copy()
        flip[17] ^= 1
        assert m.next_tokens([req], [(flip, vb)])[0] != base


# -- StepLM on reduced models ------------------------------------------------

MAX_LEN = 48
# three requests share their prompt length, so their decode rows share a
# position and group into one call
PROMPT_LENS = (20, 20, 20, 33, 20, 9)
NEW_TOKENS = 6
STEP_LAYOUT = dict(n_pages=64, page_size=4, n_kv_heads=2, head_dim=4,
                   itemsize=4)


def _step_requests(S, vocab):
    rng = np.random.default_rng(9)
    return [S.ServeRequest(
        rid=i, prompt=list(map(int, rng.integers(1, vocab, n))),
        max_new_tokens=NEW_TOKENS, temperature=0.8 * (i % 2), seed=i)
        for i, n in enumerate(PROMPT_LENS)]


def _serve(S, lm, lay, vocab, max_running):
    fd = S.ServeFrontDoor(lm, lay, max_seq_len=40, max_running=max_running,
                          prefill_chunk=16)
    reqs = _step_requests(S, vocab)
    for r in reqs:
        fd.submit(r)
    fd.run()
    return [r.output for r in reqs]


class RecordingStepLM(StepLM):
    """Keeps the logits row behind every token, by (rid, position)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.rows = {}

    def _sample_row(self, req, logits_row):
        self.rows[req.rid, len(req.tokens)] = logits_row.clone()
        return super()._sample_row(req, logits_row)


def _step_setup(arch, seed):
    jcfg = j_reduced(j_get(arch))
    params = seeded_params(jcfg, seed)
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg)})
    model = lm_from_numpy(cfg, tree, device="cpu")
    j_lm = JS.StepLM(jcfg, JRunConfig(kernels="xla", dtype="float32",
                                      remat=False),
                     params, max_len=MAX_LEN, row_bytes=32)
    j_out = _serve(JS, j_lm, JKVLayout(**STEP_LAYOUT), jcfg.vocab_size, 4)
    return model, j_out


# Weight seeds: with these requests the smallest top-2 margin of a greedy
# token is 108x (gemma2, seed 0), 136x (mamba2, seed 0) and 153x (hymba,
# seed 3) the disagreement bound below.
@pytest.fixture(scope="module")
def gemma2():
    return _step_setup("gemma2-2b", 0)


@pytest.fixture(scope="module")
def mamba2():
    return _step_setup("mamba2-1.3b", 0)


@pytest.fixture(scope="module")
def hymba():
    return _step_setup("hymba-1.5b", 3)


@pytest.mark.parametrize("which", ["gemma2", "mamba2", "hymba"])
def test_steplm_greedy_streams_equal_jax(request, which):
    """Greedy rows through the port's `ServeFrontDoor(StepLM)` equal the
    JAX front door's; each greedy token's top-2 margin is many times the
    two frameworks' logit disagreement (1e-4 of max|logit|), so a near-tie
    cannot flip it."""
    model, j_out = request.getfixturevalue(which)
    lm = RecordingStepLM(model, max_len=MAX_LEN, row_bytes=32)
    out = _serve(TS, lm, KVLayout(**STEP_LAYOUT), model.cfg.vocab_size, 4)
    for i, n in enumerate(PROMPT_LENS):
        assert len(out[i]) == NEW_TOKENS
        if i % 2 == 0:
            assert out[i] == j_out[i], f"rid {i}"
    greedy = [row for (rid, _), row in lm.rows.items() if rid % 2 == 0]
    assert len(greedy) == 3 * NEW_TOKENS
    for row in greedy:
        top2 = torch.topk(row, 2).values
        assert float(top2[0] - top2[1]) > \
            10 * 1e-4 * float(row.abs().max())
    # one decode call a request and token after the prefill's sample
    assert lm.decode_calls == len(PROMPT_LENS) * (NEW_TOKENS - 1)


@pytest.mark.parametrize("which", ["gemma2", "mamba2", "hymba"])
def test_continuous_equals_sequential(request, which):
    """Every stream, hot rows included, is the same at max_running 4 (the
    requests share steps) and 1 (each request alone), down to the bits of
    every logits row it sampled from."""
    model, _ = request.getfixturevalue(which)
    runs, rows = [], []
    for max_running in (4, 1):
        lm = RecordingStepLM(model, max_len=MAX_LEN, row_bytes=32)
        runs.append(_serve(TS, lm, KVLayout(**STEP_LAYOUT),
                           model.cfg.vocab_size, max_running))
        assert lm.decode_calls == len(PROMPT_LENS) * (NEW_TOKENS - 1)
        rows.append(lm.rows)
    assert runs[0] == runs[1]
    assert rows[0].keys() == rows[1].keys()
    for key, row in rows[0].items():
        assert torch.equal(row, rows[1][key]), key


@pytest.mark.parametrize("which", ["gemma2", "mamba2", "hymba"])
def test_decode_logits_independent_of_other_requests(request, which):
    """A request's decode logits are `torch.equal` whether it steps alone
    or among other requests at the same position, before or after them in
    the step, and stay so on the next step."""
    model, _ = request.getfixturevalue(which)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, model.cfg.vocab_size, 20)))
               for _ in range(4)]

    def admitted(rids):
        lm = RecordingStepLM(model, max_len=MAX_LEN, row_bytes=32)
        reqs = [TS.ServeRequest(rid=i, prompt=prompts[i]) for i in rids]
        for r in reqs:
            r.tokens = list(r.prompt)
            lm.on_admit(r)
        for r, tok in zip(reqs, lm.next_tokens(reqs, [None] * len(reqs))):
            r.tokens.append(tok)               # the prefill's sample
        return lm, reqs

    solo, alone = admitted([0])
    full, others = admitted([3, 1, 0, 2])
    for _ in range(2):
        for lm, reqs in ((solo, alone), (full, others)):
            for r, tok in zip(reqs, lm.next_tokens(reqs, [None] * len(reqs))):
                r.tokens.append(tok)
    assert alone[0].tokens == others[2].tokens
    for pos in (21, 22):
        assert torch.equal(solo.rows[0, pos], full.rows[0, pos]), pos
    assert not torch.equal(full.rows[0, 21], full.rows[1, 21])
    assert (solo.decode_calls, full.decode_calls) == (2, 8)


def test_steplm_release_and_hot_draws(gemma2):
    model, _ = gemma2
    lm = StepLM(model, max_len=MAX_LEN, row_bytes=32)
    reqs = [TS.ServeRequest(rid=i, prompt=[3, 4, 5]) for i in range(3)]
    for r in reqs:
        r.tokens = r.prompt + [6]
        lm.on_admit(r)
    lm.release(reqs[0])
    assert reqs[0].rid not in lm._caches and reqs[0].rid not in lm._logits
    # a hot row's draw depends on (seed, rid, len(tokens)) only
    hot = TS.ServeRequest(rid=5, prompt=[3], temperature=0.8)
    hot.tokens = [3, 4]
    row = torch.linspace(-1.0, 1.0, model.cfg.vocab_size)
    assert len({lm._sample_row(hot, row) for _ in range(3)}) == 1
