"""Plain PyTorch versions of the Mamba-2 SSD scan (follow
`repro.kernels.ssd.ref`).

`ssd_ref`          — the sequential recurrence over time steps (ground
                     truth).
`ssd_chunked_ref`  — the chunked form the kernel computes: an (L, L)
                     masked score matrix inside each chunk and an (N, P)
                     state carried across chunks.

Layouts (P = head_dim, N = state dim, G = B/C groups):
  x (B, H, S, P) · dt (B, H, S) · A (H,) · D (H,) · B/C (B, G, S, N)
"""

from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            D: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            return_state: bool = False):
    """→ y (B, H, S, P) in x's dtype [, final state (B, H, N, P) fp32]."""
    Bb, H, S, P = x.shape
    G, N = B.shape[1], B.shape[3]
    hpg = H // G
    xf, dtf = x.float(), dt.float()
    Bf = B.float().repeat_interleave(hpg, dim=1)     # (Bb, H, S, N)
    Cf = C.float().repeat_interleave(hpg, dim=1)
    decay = torch.exp(A.float()[None, :, None] * dtf)  # (Bb, H, S)

    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * decay[:, :, t, None, None] + \
            dtf[:, :, t, None, None] * Bf[:, :, t, :, None] * \
            xf[:, :, t, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, :, t], h))
    y = torch.stack(ys, dim=2) + D.float()[None, :, None, None] * xf
    return (y.to(x.dtype), h) if return_state else y.to(x.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    D: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    chunk: int = 128, return_state: bool = False):
    """The kernel's math, vectorized over chunks.  S must be a multiple of
    `chunk` (`ops.ssd` refuses other lengths).  x, B and C stay in their
    dtype where the reference keeps them (bf16 scores and chunk states
    are rounded to it before their products); every product accumulates
    in fp32.  `return_state` also returns the final (B, H, N, P) fp32
    state, the prefill→decode handoff."""
    Bb, H, S, P = x.shape
    G, N = B.shape[1], B.shape[3]
    hpg = H // G
    L = chunk
    nc = S // L

    xf = x.reshape(Bb, H, nc, L, P)
    dtf = dt.float().reshape(Bb, H, nc, L)
    Bf = B.repeat_interleave(hpg, dim=1).reshape(Bb, H, nc, L, N)
    Cf = C.repeat_interleave(hpg, dim=1).reshape(Bb, H, nc, L, N)

    cum = torch.cumsum(A.float()[None, :, None, None] * dtf, dim=-1)
    total = cum[..., -1]                               # (Bb, H, nc)

    # intra-chunk: above the diagonal seg is a positive sum that may
    # overflow exp, so mask before it (exp(-inf) = 0, and the gradient
    # there is 0, not 0 * inf)
    seg = cum[..., :, None] - cum[..., None, :]        # (Bb, H, nc, L, L)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask, seg, float("-inf")))
    scores = torch.einsum("bhctn,bhcsn->bhcts", Cf.float(), Bf.float()) * \
        decay * dtf[..., None, :]
    y_intra = torch.einsum("bhcts,bhcsp->bhctp",
                           scores.to(x.dtype).float(), xf.float())

    # chunk states, then the recurrence over the chunk index
    w = torch.exp(total[..., None] - cum) * dtf        # (Bb, H, nc, L)
    chunk_states = torch.einsum("bhcln,bhclp->bhcnp",
                                (Bf * w[..., None].to(Bf.dtype)).float(),
                                xf.float())
    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = torch.exp(total[:, :, c])[..., None, None] * h + \
            chunk_states[:, :, c]
    h_prev = torch.stack(h_prevs, dim=2)               # (Bb, H, nc, N, P)

    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bhctn,bhcnp->bhctp", Cf.float(), h_prev.to(Cf.dtype).float())
    y = (y_intra + y_inter).reshape(Bb, H, S, P) + \
        D.float()[None, :, None, None] * x.float()
    return (y.to(x.dtype), h) if return_state else y.to(x.dtype)
