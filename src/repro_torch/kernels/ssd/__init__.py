from .ops import ssd
from .ref import ssd_chunked_ref, ssd_ref
