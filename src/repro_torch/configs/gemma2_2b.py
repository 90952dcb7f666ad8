"""gemma2-2b — Gemma 2 [arXiv:2408.00118].

26 layers, d_model 2304, 8 heads (GQA kv=4), d_ff 9216, vocab 256000.
Alternating local (4096-window) and global layers, attention logit
softcap 50, final logit softcap 30, query scale 1/sqrt(256), GeGLU,
pre+post block norms, tied embeddings scaled by sqrt(d_model).
"""

from .base import (ArchConfig, ATTN_FULL, ATTN_SWA, TRAIN_4K, PREFILL_32K,
                   DECODE_32K)

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=1.0 / (256 ** 0.5),
    post_block_norm=True,
    tie_embeddings=True,
    act="gelu",
    layer_pattern=(((ATTN_SWA, ATTN_FULL), 13),),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[arXiv:2408.00118; hf]",
)
