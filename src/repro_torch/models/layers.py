"""Core layers, mirroring `repro/models/layers.py`. Only the Mamba2 SSD
scan is ported so far; the rest of the module follows with the models."""
from __future__ import annotations

from typing import Optional

import torch


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_in: torch.Tensor, C_in: torch.Tensor, D_res: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD (state-space duality), chunked.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus, >0); A: [H] (negative);
    B_in/C_in: [B,S,N] (single group); D_res: [H].
    Returns y [B,S,H,P] and final state [B,H,P,N].
    """
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    l = min(chunk, s)
    assert s % l == 0
    nc = s // l
    xc = x.reshape(b, nc, l, h, p)
    dtc = dt.reshape(b, nc, l, h).float()
    bc = B_in.reshape(b, nc, l, n).float()
    cc = C_in.reshape(b, nc, l, n).float()
    dA = dtc * A.float()[None, None, None, :]                    # [B,nc,L,H] (<0)
    cum = torch.cumsum(dA, dim=2)                                # within-chunk
    total = cum[:, :, -1:, :]                                    # [B,nc,1,H]
    dtx = dtc[..., None] * xc.float()                            # [B,nc,L,H,P]

    # ---- intra-chunk (quadratic within chunk, causal-masked decay)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                 # [B,nc,L,L]
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    w_ij = torch.where(mask[None, None, :, :, None], cb[..., None] * decay,
                       0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, dtx)

    # ---- inter-chunk: end-of-chunk states, then a sequential scan over chunks
    decay_to_end = torch.exp(total - cum)                        # [B,nc,L,H]
    states = torch.einsum("bclh,bcln,bclhp->bchpn", decay_to_end, bc, dtx)
    chunk_decay = torch.exp(total[:, :, 0, :])                   # [B,nc,H]

    hstate = (init_state.float() if init_state is not None
              else torch.zeros((b, h, p, n), device=x.device))
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, 1)                              # [B,nc,H,P,N]
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", cc, torch.exp(cum),
                           hprevs)

    y = y_intra + y_inter + (D_res.float()[None, None, None, :, None]
                             * xc.float())
    return y.reshape(b, s, h, p).to(x.dtype), hstate
