"""granite-4.0-h-small — Granite 4.0-H Small, 32B-A9B
[hf:ibm-granite/granite-4.0-h-small config.json, model_type
granitemoehybrid].

40 layers, d_model 4096, vocab 100352, tied head.  36 layers are Mamba-2
mixers (128 heads of 64, d_state 128, 1 group, conv 4 with bias, no
projection bias) and 4, at 5, 15, 25 and 35, GQA attention (32 q / 8 kv
heads of 128) with no positional encoding and the softmax scale
`attention_multiplier` 1/128.  Every mixer, SSM or attention, is
followed by an MoE of 72 SwiGLU experts of 768, top-10, dropless, and an
ungated SwiGLU shared MLP of 1536.  µP: the embedding times 12, each
branch times 0.22 before its residual add, the logits divided by 16;
RMSNorm eps 1e-5, the mixer's gated norm's too.

The SSD scans in chunks of 128 where the config gives 256: at N 128 and
P 64 no route of the SSD kernel holds a chunk of 256.  The chunk blocks
the scan and leaves its mathematics as it is.
"""

from .base import (ATTN_FULL, PortArchConfig, PortMoEConfig, SSMConfig,
                   SSM_FFN, TRAIN_4K, PREFILL_32K, DECODE_32K)

CONFIG = PortArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,                     # one routed expert's width
    vocab_size=100352,
    head_dim=128,
    rope_fraction=0.0,            # position_embedding_type "nope"
    query_scale=1.0 / 128,        # attention_multiplier
    tie_embeddings=True,
    layer_pattern=(((SSM_FFN,) * 5 + (ATTN_FULL,) + (SSM_FFN,) * 4, 4),),
    moe=PortMoEConfig(n_experts=72, top_k=10, d_ff_expert=768,
                      n_shared_experts=1, d_ff_shared=1536,
                      dropless=True, shared_gate=False),
    ssm=SSMConfig(d_state=128, head_dim=64, n_heads=128, n_groups=1,
                  expand=2, conv_kernel=4, chunk=128),
    norm_eps=1e-5,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_divisor=16.0,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[hf:ibm-granite/granite-4.0-h-small; hf]",
)
