"""Weights drawn from the run's seed, on the device, in the dtype they are
served in, in a few large calls.

The reference family's `layout` names every weight, its shape and its
law.  The products' weights, the embedding and the head are drawn
together as one standard normal in the served dtype and scaled leaf by
leaf; the small float32 leaves as one normal and one uniform draw.  The
laws:

  matmul   N(0, 1/fan_in), fan_in the rows of each matrix: the first
           dim of a (d_in, d_out) weight, the second of stacked experts'
           (E, d_in, d_out)
  embed    N(0, 0.02²)            head  N(0, 0.02²)
  norm     N(0, 0.1²)  (the norms scale by 1 + this)
  small    N(0, 0.1²)             conv_w  N(0, 1/taps)
  A_log    log U(1, 16)           D  1 + N(0, 0.1²)
  dt_bias  softplus⁻¹ of a log-uniform dt in [0.001, 0.1]
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

SERVED = ("matmul", "embed", "head")
CHUNK = 1 << 28                      # elements a draw


def _scale(law: str, shape: Tuple[int, ...]) -> float:
    return 1.0 / math.sqrt(shape[-2]) if law == "matmul" else 0.02


def draw(layout: List[Tuple[str, Tuple[int, ...], str]],
         dtype: torch.dtype, device: torch.device, seed: int,
         into: Optional[Dict[str, torch.Tensor]] = None
         ) -> Dict[str, torch.Tensor]:
    """{name: tensor}: the served leaves views of one `dtype` buffer, the
    rest views of one float32 buffer.  `into`, weights an earlier call
    returned for the same layout, are drawn again in place."""
    gen = torch.Generator(device).manual_seed(seed)
    sizes = {name: math.prod(shape) for name, shape, _ in layout}
    big = sum(sizes[n] for n, _, law in layout if law in SERVED)
    small = sum(sizes[n] for n, _, law in layout if law not in SERVED)
    if into is None:
        flat = torch.empty(big, dtype=dtype, device=device)
        normal = torch.empty(small, dtype=torch.float32, device=device)
    else:
        flat, normal = (_base(into, law in SERVED, layout)
                        for law in ("matmul", "norm"))
    uniform = torch.empty(small, dtype=torch.float32, device=device)
    for a in range(0, big, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    normal.normal_(generator=gen)
    uniform.uniform_(generator=gen)

    out: Dict[str, torch.Tensor] = {}
    at_big = at_small = 0
    with torch.no_grad():
        for name, shape, law in layout:
            n = sizes[name]
            if law in SERVED:
                w = flat[at_big:at_big + n].view(shape)
                at_big += n
                w.mul_(_scale(law, shape))
                out[name] = w
                continue
            w = normal[at_small:at_small + n].view(shape)
            u = uniform[at_small:at_small + n].view(shape)
            at_small += n
            if law in ("norm", "small"):
                w.mul_(0.1)
            elif law == "conv_w":
                w.mul_(1.0 / math.sqrt(shape[0]))
            elif law == "D":
                w.mul_(0.1).add_(1.0)
            elif law == "A_log":
                w.copy_(torch.log(1.0 + 15.0 * u))
            elif law == "dt_bias":
                lo, hi = math.log(1e-3), math.log(1e-1)
                dt = torch.exp(lo + (hi - lo) * u)
                w.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                raise ValueError(f"{name}: unknown law {law!r}")
            out[name] = w
    return out


def _base(weights: Dict[str, torch.Tensor], served: bool,
          layout: List[Tuple[str, Tuple[int, ...], str]]) -> torch.Tensor:
    """The flat buffer under the served (or the small) leaves of `draw`'s
    weights."""
    first = next(n for n, _, law in layout if (law in SERVED) == served)
    w = weights[first]
    n = sum(math.prod(s) for _, s, law in layout if (law in SERVED) == served)
    return w.as_strided((n,), (1,), w.storage_offset())
