"""Models of the port: the dense attention LM (gemma2) in PyTorch."""

from .lm import LM, lm_decode_step, lm_prefill
from .convert import lm_from_numpy
