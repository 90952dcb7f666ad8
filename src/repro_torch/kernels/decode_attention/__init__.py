from .ops import decode_attention
from .ref import decode_attention_ref
