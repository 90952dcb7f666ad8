"""internvl2-26b — InternVL2 [arXiv:2404.16821].

Backbone: InternLM2-20B-class decoder (48L, d_model 6144, 48H, GQA kv=8,
d_ff 16384) with vocab 92553, padded to 92672 rows (the 119 pad rows'
logits are masked to -1e30).  The InternViT-6B frontend is a STUB: the
caller passes precomputed patch embeddings (`n_patches` of width 3200)
that the linear `vision_proj` maps into d_model and which replace the
first token positions.  Full attention ⇒ `long_500k` SKIPPED.
"""

from .base import ArchConfig, VisionStub, TRAIN_4K, PREFILL_32K, DECODE_32K

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    vision=VisionStub(n_patches=256, patch_embed_dim=3200),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[arXiv:2404.16821; hf]",
)
