"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060].

48 layers, d_model 2048, attention-free, vocab 50280, ssm_state 128.
Mamba-2 defaults: expand 2 (d_inner 4096), headdim 64 (→ 64 SSD heads),
n_groups 1, conv kernel 4, chunk 128.  Every layer is norm → Mamba-2
mixer → residual, with no MLP block.
"""

from .base import (ArchConfig, SSMConfig, TRAIN_4K, PREFILL_32K, DECODE_32K,
                   LONG_500K)

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                      # attention-free, no MLP block (Mamba-2)
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, expand=2,
                  conv_kernel=4, chunk=128),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K),
    source="[arXiv:2405.21060; unverified]",
)
