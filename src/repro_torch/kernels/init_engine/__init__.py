from .ops import iota_fill, memset, prng_fill
from .ref import iota_fill_ref, memset_ref, prng_bits_ref, prng_fill_ref
