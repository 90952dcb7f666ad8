"""`GraphDecodeStep` on the card: the decode step replayed from CUDA
graphs against the eager step.  Marked `cuda`: run them where there is a
GPU with

    PYTHONPATH=src python3 -m pytest -m cuda tests/test_torch_decode_graph_cuda.py

Elsewhere every test skips from inside the `cuda` fixture.  This file
imports only torch and repro_torch (the machine with the card has no JAX).

Models: internlm2-20b at its published widths cut to 2 layers, and a
gemma2-style model (sliding-window and full layers in turn, attention and
final softcaps, post norms, a tied head) at small widths, both bf16.
The graphs replay the eager step's kernels at its shapes, so the greedy
tokens and every step's logits must be equal bit for bit.
"""

import gc
import weakref

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.models import LM, lm_prefill
from repro_torch.serve import (GraphDecodeStep, Request, ServeEngine,
                               make_decode_step)

pytestmark = pytest.mark.cuda

STEPS = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _config(which):
    if which == "internlm2":
        return reduced(get("internlm2-20b"), n_layers=2, d_model=6144,
                       n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544)
    return reduced(get("gemma2-2b"), n_layers=4, d_model=512, n_heads=4,
                   n_kv_heads=2, d_ff=1024, vocab=4096)


_MODELS = {}


def _model(which, dev):
    if which not in _MODELS:
        _MODELS[which] = LM(_config(which), RunConfig(dtype="bfloat16"),
                            seed=5, device=dev)
    return _MODELS[which]


def _requests(B, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(20, 90, (B,), generator=g).tolist()
    return [Request(prompt=torch.randint(1, vocab, (n,), generator=g)
                    .tolist(), max_new_tokens=STEPS + 1) for n in lens]


class Recording(ServeEngine):
    """Keeps every step's logits."""

    def _sample(self, logits, requests, gens):
        self.seen.append(logits.clone())
        return super()._sample(logits, requests, gens)


def _serve(model, B, graphed):
    engine = Recording(model, max_len=160)
    if not graphed:
        engine._decode = make_decode_step(model)
    engine.seen = []
    out = engine.generate(_requests(B, model.cfg.vocab_size, B))
    torch.cuda.synchronize()
    return [r.output for r in out], engine.seen, engine


@pytest.mark.parametrize("B", [4, 32])
@pytest.mark.parametrize("which", ["internlm2", "gemma2"])
def test_graphed_engine_equals_eager(cuda, which, B):
    model = _model(which, cuda)
    want_tokens, want_logits, _ = _serve(model, B, graphed=False)
    tokens, logits, engine = _serve(model, B, graphed=True)
    step = engine._decode
    assert step.fits and step.captures == 1 and step.fallbacks == 0
    assert len(step.graphs.graphs) == model.cfg.n_layers + 1
    print(f"{which} B {B}: graph pool {step.graphs.pool_bytes} bytes")
    assert 0 < step.graphs.pool_bytes < 2 ** 30
    assert tokens == want_tokens
    assert len(logits) == len(want_logits) == STEPS + 1
    for k, (got, want) in enumerate(zip(logits, want_logits)):
        err = (got - want).abs().max().item() / want.abs().max().item()
        assert torch.equal(got, want), (which, B, k, err)


def test_capture_once_a_batch_size(cuda):
    """Two generates at one B capture once; a new B captures anew and
    frees the old set; the engine's going frees the last."""
    model = _model("gemma2", cuda)
    engine = ServeEngine(model, max_len=160)
    step = engine._decode
    for _ in range(2):
        engine.generate(_requests(4, model.cfg.vocab_size, 1))
    assert step.captures == 1
    old = weakref.ref(step.graphs)
    graph = weakref.ref(step.graphs.graphs[0])
    engine.generate(_requests(8, model.cfg.vocab_size, 2))
    gc.collect()
    assert step.captures == 2 and step.graphs.B == 8
    assert old() is None and graph() is None
    last = weakref.ref(step.graphs)
    torch.cuda.synchronize()
    del engine, step
    gc.collect()
    assert last() is None


def test_returned_logits_survive_the_next_step(cuda):
    model = _model("gemma2", cuda)
    tokens = torch.randint(1, 4096, (4, 30), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(3))
    _, caches = lm_prefill(model, tokens, max_len=64)
    step = GraphDecodeStep(model)
    first, caches = step(caches, tokens[:, -1:], 30)
    kept = first.clone()
    second, caches = step(caches, first.argmax(-1)[:, None], 31)
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


def test_replay_counts_and_calls_decode_attention_by_name(cuda, monkeypatch):
    """Under `spans.recording()` a replayed step counts
    `serve.decode_graph` (graphs L + 1, eager 0), opens one
    `lm.decode_step` and one `lm.attend` a layer, calls the decode op
    through `repro_torch.models.attention.decode_attention` once a layer
    (the name the benchmark's tracer wraps), and makes no synchronize."""
    import repro_torch.models.attention as attention

    model = _model("gemma2", cuda)
    L = model.cfg.n_layers
    tokens = torch.randint(1, 4096, (4, 30), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(4))
    _, caches = lm_prefill(model, tokens, max_len=64)
    step = GraphDecodeStep(model)
    _, caches = step(caches, tokens[:, -1:], 30)          # captures
    calls = []
    op = attention.decode_attention

    def counted(*args, **kw):
        calls.append(kw["kv_len"])
        return op(*args, **kw)
    monkeypatch.setattr(attention, "decode_attention", counted)
    torch.cuda.synchronize()
    spans.clear()
    try:
        with spans.recording():
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(caches, tokens[:, -1:], 31)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        names = [r.name for r in spans.records()]
        counts = [r.attrs for r in spans.records()
                  if r.name == "repro_torch.serve.decode_graph"]
    finally:
        spans.clear()
    assert calls == [32] * L
    assert counts == [dict(graphs=L + 1, captured=0, eager=0)]
    assert names.count("repro_torch.lm.decode_step") == 1
    assert names.count("repro_torch.lm.attend") == L
