"""seamless-m4t-large-v2 — SeamlessM4T v2 [arXiv:2308.11596].

Enc-dec backbone: 24 encoder + 24 decoder layers, d_model 1024, 16 heads
(kv=16), d_ff 8192, vocab 256206.  The speech frontend (w2v-BERT conv
feature extractor) is a stub: the encoder takes precomputed frame
embeddings, seq_len // subsample of them.  The decoder is full attention;
decoding caches the encoder's cross-attention K/V.
"""

from .base import (ArchConfig, EncoderConfig, TRAIN_4K, PREFILL_32K,
                   DECODE_32K)

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    encoder=EncoderConfig(n_layers=24, subsample=4),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[arXiv:2308.11596; hf]",
)
