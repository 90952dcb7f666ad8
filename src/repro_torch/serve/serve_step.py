"""Serving steps: prefill and decode closures over a model, and sampling
(the port of `repro.serve.serve_step`).

For an encoder-decoder (`EncDec`, the audio family) the prefill step
takes (frames, tokens) and returns the decoder layers' cross-attention
K/V, as the reference's does (the tokens are not read); its decode step
takes (caches, cross, tokens, pos).

On a mesh (a model whose parameters are DTensors) each step runs under
`implicit_replication`, as the train step does: the tensors a step makes
(positions, masks) count as replicated.

`rcfg` is the reference's setting, chosen by the caller: under
`kernels="xla"` the steps take the plain attention and SSD (the path the
dry-run costs), and with None, or "pallas", the kernel ops, which run
their kernels on the card and raise on a device that has none.

`GraphDecodeStep` is the decode step `ServeEngine` runs: the same step,
whose layers replay from CUDA graphs where the model allows it
(`decode_graphs_fit`).
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Tuple, Union

import torch

from repro_torch import spans
from repro_torch.configs.base import ATTN_FULL, ATTN_SWA, RunConfig
from repro_torch.train.train_step import _on_mesh
from repro_torch.models import (LM, EncDec, encdec_decode_step,
                                encdec_prepare_cross, lm_decode_step,
                                lm_prefill)
from repro_torch.models.blocks import (Cache, block_decode_attend,
                                       block_decode_post, block_decode_pre)
from repro_torch.models.lm import (_embed_in, decode_logits,
                                   decode_step_span, embed_scale)

DECODE_GRAPH = "repro_torch.serve.decode_graph"


def make_prefill_step(model: Union[LM, EncDec],
                      max_len: Optional[int] = None,
                      rcfg: Optional[RunConfig] = None) -> Callable:
    if isinstance(model, EncDec):
        def prefill_cross(frames: torch.Tensor,
                          tokens: Optional[torch.Tensor] = None):
            with _on_mesh(model):
                return encdec_prepare_cross(model, frames, rcfg)
        return prefill_cross

    def prefill(tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None):
        with _on_mesh(model):
            return lm_prefill(model, tokens, max_len=max_len,
                              patch_embeds=patch_embeds, rcfg=rcfg)
    return prefill


def make_decode_step(model: Union[LM, EncDec],
                     rcfg: Optional[RunConfig] = None) -> Callable:
    if isinstance(model, EncDec):
        def step_cross(caches, cross, tokens: torch.Tensor, pos: int):
            with _on_mesh(model):
                return encdec_decode_step(model, caches, cross, tokens, pos,
                                          rcfg)
        return step_cross

    def step(caches, tokens: torch.Tensor, pos: int):
        with _on_mesh(model):
            return lm_decode_step(model, caches, tokens, pos, rcfg)
    return step


def decode_graphs_fit(model: Union[LM, EncDec]) -> bool:
    """Whether `model`'s decode step may replay from CUDA graphs, read
    from its structure: an `LM` on a CUDA device, no DTensor parameter,
    every layer full or sliding-window attention with a dense FFN.  An
    SSM or hybrid layer replaces its cache every step, which a graph
    would fix; the MoE layers, whose dispatch no capture has been held
    against, stay eager."""
    if not isinstance(model, LM) or model.device.type != "cuda":
        return False
    from torch.distributed.tensor import DTensor

    cfg = model.cfg
    return cfg.moe is None and \
        all(kind in (ATTN_FULL, ATTN_SWA) for kind in cfg.layer_kinds) and \
        not any(isinstance(p, DTensor) for p in model.parameters())


def _capture(graph: "torch.cuda.CUDAGraph", pool, fn: Callable):
    """fn()'s launches captured into `graph` on the current stream."""
    graph.capture_begin(pool=pool)
    try:
        out = fn()
    except BaseException:
        try:
            graph.capture_end()
        except RuntimeError:
            pass                     # the capture was already invalid
        raise
    graph.capture_end()
    return out


class _Graphs:
    """The decode step of one batch size B as L + 1 CUDA graphs cut at the
    L decode-attention calls.  Graph 0 runs from the tokens to layer 0's
    roped q/k/v; graph i (0 < i < L) from layer i − 1's attention output
    (the out projection, residual, norms and FFN) to layer i's q/k/v;
    graph L from the last layer's attention output to the fp32 logits.

    Their inputs are static tensors: `tokens` (B, 1), `pos`, the step's
    position as one int32 (RoPE reads it), `o`, the attention output
    each graph after the first reads, and `scale`, a tied head's
    embedding scale.  The graphs hold the weights and these activations,
    never a cache, so one capture serves every batch of B whatever its
    caches.  They share one memory pool.  Capture runs the pieces once on
    the capture stream first (the lazy set-up of cuBLAS and the rest),
    with no attention call, so no cache is written."""

    def __init__(self, model: LM, B: int, stream: "torch.cuda.Stream"
                 ) -> None:
        cfg, dev = model.cfg, model.device
        self.B = B
        self.tokens = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.o = torch.zeros((B, cfg.n_heads, cfg.resolved_head_dim),
                             dtype=model.dtype, device=dev)
        # the embedding's scale; every tensor a graph reads is held here,
        # or its memory would go back to the allocator
        self.scale = torch.tensor(embed_scale(cfg) or 1.0, dtype=model.dtype,
                                  device=dev)
        layers = list(zip(model.layers, cfg.layer_kinds))

        def piece(i: int, x: Optional[torch.Tensor]) -> Tuple:
            if i == 0:
                x = _embed_in(model, self.tokens, scale=self.scale)
            else:
                p, kind = layers[i - 1]
                x, _ = block_decode_post(p, x, None, self.o, {}, cfg, kind)
            if i == len(layers):
                return (decode_logits(model, x),)
            p, kind = layers[i]
            return (x,) + block_decode_pre(p, x, cfg, kind, self.pos)[1]

        pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.outs: List[Tuple] = []   # each graph's static outputs
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            x = None
            for i in range(len(layers) + 1):
                x = piece(i, x)[0]
            x = None
            before = torch.cuda.memory_reserved(dev)
            for i in range(len(layers) + 1):
                g = torch.cuda.CUDAGraph()
                self.outs.append(_capture(g, pool, lambda: piece(i, x)))
                self.graphs.append(g)
                x = self.outs[-1][0]
        torch.cuda.current_stream(dev).wait_stream(stream)
        #: bytes the pool reserved on the card (a private pool takes
        #: segments of its own)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before

    def step(self, caches: List[Cache], tokens: torch.Tensor, pos: int,
             model: LM) -> torch.Tensor:
        """Replay the step: the inputs copied in, each graph replayed, and
        between two graphs, eager, the layer's cache write and attention
        (`block_decode_attend`) and one copy of its output into `o`.
        Returns a fresh copy of the logits."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        for i, (kind, cache) in enumerate(zip(model.cfg.layer_kinds,
                                              caches)):
            self.graphs[i].replay()
            o, _ = block_decode_attend(self.outs[i][1:], cache, pos,
                                       model.cfg, kind)
            self.o.copy_(o)
        self.graphs[-1].replay()
        return self.outs[-1][0].clone()

    def release(self) -> None:
        for g in self.graphs:
            g.reset()
        self.graphs, self.outs = [], []


class GraphDecodeStep:
    """The decode step of `make_decode_step`, (caches, tokens, pos) →
    (logits, caches), whose layers replay from CUDA graphs (`_Graphs`)
    where `decode_graphs_fit` allows it; elsewhere, and for caches with
    rings, it is the eager step itself.  The decode attention stays an
    eager call between the graphs, through the name bound in
    `repro_torch.models.attention`, with the cache write before it.

    Graphs are captured at the first call of a batch size and kept for
    that size alone: a call of another size releases them and captures
    anew.  A capture that raises leaves the step eager from then on
    (`fallbacks` counts it).  Each call, while spans record, counts
    `serve.decode_graph` (graphs: graphs replayed, captured: graphs
    captured in the call, eager: 1 if the step ran eager).  The graphs
    read the weights where they lay at capture: a model whose parameters
    are replaced, not written in place, needs a new step."""

    def __init__(self, model: LM) -> None:
        self.model = model
        self.eager = make_decode_step(model)
        self.fits = decode_graphs_fit(model)
        self.captures = 0
        self.fallbacks = 0
        self.graphs: Optional[_Graphs] = None
        self._stream: Optional[torch.cuda.Stream] = None

    def __call__(self, caches: List[Cache], tokens: torch.Tensor, pos: int
                 ) -> Tuple[torch.Tensor, List[Cache]]:
        use = self.fits and not any("rk" in c for c in caches)
        captured = self._ready(tokens.shape[0]) if use else 0
        if not (use and self.fits):
            out = self.eager(caches, tokens, pos)
            if spans.active():
                spans.count(DECODE_GRAPH, graphs=0, captured=0, eager=1)
            return out
        with decode_step_span(tokens, pos), torch.no_grad():
            logits = self.graphs.step(caches, tokens, pos, self.model)
            if spans.active():
                spans.count(DECODE_GRAPH, graphs=len(self.graphs.graphs),
                            captured=captured, eager=0)
        return logits, caches

    def _ready(self, B: int) -> int:
        """Graphs for batch size B, captured if need be; the number
        captured.  On a failed capture `graphs` is None and the step
        eager from then on."""
        if self.graphs is not None and self.graphs.B == B:
            return 0
        self.release()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.model.device)
        try:
            with torch.no_grad():
                self.graphs = _Graphs(self.model, B, self._stream)
        except Exception as e:         # noqa: BLE001 — any capture fault
            self.fits = False
            self.fallbacks += 1
            warnings.warn(f"decode step capture failed, running eager: "
                          f"{type(e).__name__}: {e}")
            return 0
        self.captures += 1
        return len(self.graphs.graphs)

    def release(self) -> None:
        """Drop the graphs and their memory pool."""
        if self.graphs is not None:
            self.graphs.release()
            self.graphs = None


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(generator: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """One draw per row from softmax(logits / temperature)."""
    if temperature <= 0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)
