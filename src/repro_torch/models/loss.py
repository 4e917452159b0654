"""Chunked LM cross-entropy, mirroring `repro/models/loss.py`: never
materializes [B, S, V] logits.

Loops over sequence blocks; per block computes fp32 logits against the
head, a numerically-stable logsumexp, the label logit, and a z-loss.
Padded vocab columns are masked to -inf.
"""
from __future__ import annotations

import torch


def lm_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, *,
            logical_vocab: int, block: int = 512, z_loss: float = 1e-4):
    """h: [B,S,D]; head: [D,V_pad]; labels: [B,S] (-1 = pad).

    Returns (mean_loss fp32 scalar, metrics dict).
    """
    b, s, d = h.shape
    block = min(block, s)
    assert s % block == 0
    vmask = torch.arange(head.shape[-1], device=h.device) < logical_vocab
    tot = zl_tot = cnt = torch.zeros((), device=h.device)
    for i in range(0, s, block):
        hb, lb = h[:, i:i + block], labels[:, i:i + block]
        logits = torch.einsum("bsd,dv->bsv", hb, head.to(hb.dtype)).float()
        logits = torch.where(vmask[None, None, :], logits, -torch.inf)
        m = logits.amax(-1).detach()        # the reference's stop_gradient
        lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), -1))
        ll = torch.gather(logits, -1,
                          torch.clamp_min(lb, 0).long()[..., None])[..., 0]
        mask = (lb >= 0).float()
        tot = tot + torch.sum((lse - ll) * mask)
        zl_tot = zl_tot + torch.sum(torch.square(lse) * mask)
        cnt = cnt + torch.sum(mask)
    cnt = torch.clamp_min(cnt, 1.0)
    xent = tot / cnt
    loss = xent + z_loss * zl_tot / cnt
    return loss, {"xent": xent, "tokens": cnt}


def logits_for(h_last: torch.Tensor, head: torch.Tensor,
               logical_vocab: int) -> torch.Tensor:
    """Final-position logits. h_last: [B,D] -> [B,V_pad] (padded cols -inf)."""
    logits = torch.einsum("bd,dv->bv", h_last, head.to(h_last.dtype)).float()
    vmask = torch.arange(head.shape[-1], device=h_last.device) < logical_vocab
    return torch.where(vmask[None, :], logits, -torch.inf)
