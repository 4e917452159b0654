"""Chunked LM cross-entropy, mirroring `repro/models/loss.py`: never
materializes [B, S, V] logits.

Loops over sequence blocks; per block computes fp32 logits against the
head, a numerically-stable logsumexp, the label logit, and a z-loss.
Padded vocab columns are masked to -inf. On DTensors (a sharding
context) each rank sums its batch shard's blocks against the whole head
(`parallel.local_ops.run_local`), and the three sums are added over the
batch's ranks before the divisions.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import eins
from repro_torch.parallel import local_ops
from repro_torch.parallel.sharding import is_dtensor, replicated


def _loss_sums(h, head, labels, logical_vocab: int, block: int):
    """(sum of the masked cross-entropy, of the squared logsumexp, count
    of the labels >= 0) over `h`'s rows."""
    b, s, d = h.shape
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
    return tot, zl_tot, cnt


def _loss_sums_on_mesh(h, head, labels, logical_vocab: int, block: int):
    """`_loss_sums` of DTensors: each rank's batch shard against the
    whole head (gathered); the sums, and the head's gradient, are
    `Partial` over the batch's mesh dimensions."""
    ph = local_ops.without(h.placements, (1, 2))  # labels laid out alike
    whole = local_ops.without(ph, (0,))
    over_batch = [p.is_shard() for p in ph]
    summed = local_ops.summed_where(whole, over_batch)
    sums = local_ops.run_local(
        lambda a, w, lab: _loss_sums(a, w, lab, logical_vocab, block),
        (h, head, labels), (ph, whole, ph), (summed,) * 3,
        (ph, summed, ph))
    return [replicated(x) for x in sums]


def lm_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, *,
            logical_vocab: int, block: int = 512, z_loss: float = 1e-4):
    """h: [B,S,D]; head: [D,V_pad]; labels: [B,S] (-1 = pad).

    Returns (mean_loss fp32 scalar, metrics dict).
    """
    block = min(block, h.shape[1])
    assert h.shape[1] % block == 0
    sums = _loss_sums_on_mesh if is_dtensor(h) else _loss_sums
    tot, zl_tot, cnt = sums(h, head, labels, logical_vocab, block)
    cnt = torch.clamp_min(cnt, 1.0)
    xent = tot / cnt
    loss = xent + z_loss * zl_tot / cnt
    return loss, {"xent": xent, "tokens": cnt}


def logits_for(h_last: torch.Tensor, head: torch.Tensor,
               logical_vocab: int) -> torch.Tensor:
    """Final-position logits. h_last: [B,D] -> [B,V_pad] (padded cols -inf)."""
    logits = eins("bd,dv->bv", h_last, head).float()
    vmask = torch.arange(head.shape[-1], device=h_last.device) < logical_vocab
    return torch.where(vmask[None, :], logits, -torch.inf)
