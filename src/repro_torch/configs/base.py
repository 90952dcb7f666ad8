"""Architecture & run configuration records (the port's own copy).

Mirrors `repro.configs.base` field for field, so a test can build the
reference config and this one from the same numbers.  Serving runs
each kernel's CUDA version or plain version by the device of the tensor
it is given, not by a knob; training chooses its attention and SSD by
`RunConfig.kernels`, as the reference's does.

Layer heterogeneity (gemma2's local/global alternation, hymba's three
full-attention layers) is a `layer_pattern`: a tuple of ((kinds...),
repeat) segments.  The real layer order is segment by segment, and
within a segment repeat by repeat, each repeat running `kinds` in order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Layer kinds
ATTN_FULL = "attn_full"
ATTN_SWA = "attn_swa"
SSM = "ssm"
HYBRID = "hybrid"          # parallel attention + SSM heads (hymba)
HYBRID_FULL = "hybrid_full"   # the same with full attention


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int             # N
    head_dim: int = 64       # P
    n_heads: int = 0         # 0 → derived: d_inner // head_dim
    n_groups: int = 1        # G (B/C groups)
    expand: int = 2          # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    subsample: int = 4


@dataclass(frozen=True)
class VisionStub:
    n_patches: int = 256
    patch_embed_dim: int = 3200


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    window: int = 0                   # SWA width (0 = full attention)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    query_scale: Optional[float] = None
    post_block_norm: bool = False
    tie_embeddings: bool = False
    act: str = "silu"                 # silu | gelu
    layer_pattern: Optional[Tuple[Tuple[Tuple[str, ...], int], ...]] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStub] = None
    shapes: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128; logits past
        `vocab_size` are masked to -1e30."""
        return -(-self.vocab_size // 128) * 128

    @property
    def pattern(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        if self.layer_pattern is not None:
            return self.layer_pattern
        kind = SSM if self.family == "ssm" else ATTN_FULL
        if self.window and self.family != "ssm":
            kind = ATTN_SWA
        return (((kind,), self.n_layers),)

    @property
    def total_layers(self) -> int:
        return sum(len(kinds) * rep for kinds, rep in self.pattern)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Every layer's kind in the order the model runs them."""
        return tuple(kind for kinds, rep in self.pattern
                     for _ in range(rep) for kind in kinds)

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(
            f"{self.name} does not run shape {name!r} "
            f"(available: {[s.name for s in self.shapes]})")

    def validate(self) -> None:
        if self.total_layers != self.n_layers:
            raise ValueError(f"{self.name}: pattern covers "
                             f"{self.total_layers} != {self.n_layers}")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")


@dataclass(frozen=True)
class RunConfig:
    """Runtime/parallelism knobs: every field of the reference's, with its
    defaults.

    A model reads its numerics when it is built (`LM(cfg, rcfg)`,
    `EncDec(cfg, rcfg)`): `dtype` is the compute dtype of every matmul,
    `ssd_chunk` and `ssd_compute_dtype` the SSD's chunk and the dtype of
    its x, B and C.  The forwards also read `kernels`: "xla" takes the
    plain PyTorch `chunked_flash`, `decode_attention_ref` and
    `ssd_chunked_ref`, as the reference's "xla" path does; "pallas"
    takes the kernel ops, which run the CUDA kernel for tensors on the
    card, and raises where autograd would need their backward (no kernel
    has one, in either package).  Serving (`lm_prefill`,
    `lm_decode_step`, the encoder-decoder's `encdec_prepare_cross` and
    `encdec_decode_step`, `serve_step`'s steps) takes an optional
    `rcfg`: with none it runs the kernel ops, as the served path on the
    card does.  The `moe_*` fields
    are the MoE mesh dispatch's (`models.moe`, with a mesh installed by
    `dist.sharding.set_moe_mesh`); `sequence_parallel`, `decode_kv_shard`,
    `decode_ring` and `ssm_head_tp` are read by `launch.specs` as the
    reference's are.  The rest are the train step's.

    `param_dtype` is read nowhere, as in the reference: a train state
    keeps fp32 leaves whatever the compute dtype (`init_train_state`),
    and a model built for serving stores its matmul weights in the
    compute dtype.  Three more are accepted and read nowhere, as in the
    reference: `scan_layers` (the port runs its layers in a Python loop;
    there is no `lax.scan` to turn on or off), `zero1` (no reader in the
    reference) and `grad_compression` (named only in the reference train
    step's docstring; `dist.collectives.compressed_psum` is the
    primitive)."""

    kernels: str = "xla"              # "pallas" | "xla"
    dtype: str = "bfloat16"           # compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    sequence_parallel: bool = True    # SP residual stream sharding
    zero1: bool = True                # shard optimizer state over data
    # int8 error-feedback gradient compression primitives live in
    # dist.collectives.compressed_psum + instream.ErrorFeedbackCompressor
    # (tested); wiring them into the train step requires per-shard
    # (pre-reduction) gradients, i.e. a data-parallel outer loop.
    grad_compression: bool = False
    microbatch: int = 0               # 0 = no gradient accumulation
    attn_chunk_q: int = 1024          # chunked_flash's tiles
    attn_chunk_k: int = 2048
    decode_kv_shard: str = "auto"     # "heads" | "seq" | "auto"
    decode_ring: int = 128            # ring-append buffer (0 = off)
    moe_shard_map: bool = True        # MoE mesh dispatch if a mesh is set
    moe_reduce: str = "combine_first"  # "psum"|"scatter"|"combine_first"
    moe_comm_dtype: str = "float32"   # expert-output reduction dtype
    ssd_chunk: int = 0                # 0 = arch default; else override
    ssm_head_tp: bool = False         # shard SSD heads over model (flagged)
    ssd_compute_dtype: str = "float32"  # SSD intra-chunk einsum dtype
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def reduced(cfg: ArchConfig, n_layers: int = 2, d_model: int = 128,
            n_heads: int = 4, n_kv_heads: int = 2, d_ff: int = 256,
            vocab: int = 512) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes: Dict = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=min(n_kv_heads, cfg.n_kv_heads) or n_kv_heads,
        d_ff=d_ff, vocab_size=vocab, head_dim=d_model // n_heads,
        window=min(cfg.window, 64) if cfg.window else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            d_ff_shared=128 if cfg.moe.n_shared_experts else 0,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            capacity_factor=8.0)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=32, head_dim=16, n_heads=0, chunk=32)
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2)
    if cfg.vision is not None:
        changes["vision"] = dataclasses.replace(
            cfg.vision, n_patches=16, patch_embed_dim=64)
    if cfg.layer_pattern is not None:
        # shrink the pattern to n_layers while keeping heterogeneity
        kinds = []
        for ks, rep in cfg.layer_pattern:
            kinds.extend(list(ks) * rep)
        step = max(len(kinds) // n_layers, 1)
        picked = tuple(kinds[::step][:n_layers])
        while len(picked) < n_layers:
            picked = picked + (picked[-1],)
        changes["layer_pattern"] = tuple(((k,), 1) for k in picked)
    return dataclasses.replace(cfg, **changes)
