"""Paged, int8-quantized KV cache with page "refresh" (the serving-side
DRAM), mirroring `repro/kvcache/paged.py`.

Memory layout (per k and v), on the cache's device:
  pages   : [L, n_pages, page_size, H_kv, D] int8   — long-term store
  scales  : [L, n_pages, H_kv] f32                  — per (page, head) scale
  staging : [L, n_staging, page_size, H_kv, D] bf16 — recent, uncompressed

The refresh analogy (DESIGN §2):
  * a page-group (page_id % n_groups) is a *bank*;
  * compressing a full staging page into int8 is the *refresh* operation —
    mandatory periodic maintenance (staging capacity is finite, like charge
    leaking away);
  * DARP schedules which bank-group gets compressed each decode round,
    avoiding groups the current batch is attending to; budget-forced
    compression when staging runs out is the data-integrity guarantee.

The compression is kernel D: a staging slice `[L, T, H_kv, D]` is its
`[P, T, H, D]`, the layer axis in the place of D's page axis, with one
scale per (layer, head) over (T, D). On CUDA tensors `quantize_page`
launches it (or raises); on CPU tensors it runs D's plain version, which
divides by a tensor as the reference's true division does.

Bookkeeping (allocation, page tables, staging map) is host-side numpy, as
in the reference. The device tensors are updated in place (the
reference's `.at[].set` makes new arrays).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import kv_quant as _kq


@dataclass(frozen=True)
class PagedKVConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 64
    n_pages: int = 256
    n_staging: int = 32
    n_groups: int = 8            # DARP bank-groups
    max_seqs: int = 16
    max_pages_per_seq: int = 64
    dtype: torch.dtype = torch.bfloat16


# ---------------------------------------------------------- tensor ops

def quantize_page(page: torch.Tensor):
    """page: [..., page_size, H, D] float -> (int8 page, scale [..., H]).

    Kernel D on a CUDA tensor, its plain version on a CPU tensor; the
    leading axes are flattened into D's page axis."""
    t, h, d = page.shape[-3:]
    lead = page.shape[:-3]
    q, scale = _kq.kv_quant(page.reshape(-1, t, h, d).contiguous())
    return q.reshape(page.shape), scale.reshape(*lead, h)


def dequantize_page(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_page."""
    return (q.float() * scale[..., None, :, None]).to(dtype)


def page_quant_error(page: torch.Tensor) -> torch.Tensor:
    q, s = quantize_page(page)
    return torch.max(torch.abs(dequantize_page(q, s, torch.float32)
                               - page.float()))


# ----------------------------------------------------------------- manager

class PagedKVCache:
    """Host-orchestrated paged cache for one model (all layers), its
    tensors on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: PagedKVConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        L, P, T, H, D = (cfg.n_layers, cfg.n_pages, cfg.page_size,
                         cfg.n_kv_heads, cfg.head_dim)
        S = cfg.n_staging
        dev = self.device
        self.k_pages = torch.zeros((L, P, T, H, D), dtype=torch.int8,
                                   device=dev)
        self.v_pages = torch.zeros((L, P, T, H, D), dtype=torch.int8,
                                   device=dev)
        self.k_scale = torch.ones((L, P, H), dtype=torch.float32, device=dev)
        self.v_scale = torch.ones((L, P, H), dtype=torch.float32, device=dev)
        self.k_staging = torch.zeros((L, S, T, H, D), dtype=cfg.dtype,
                                     device=dev)
        self.v_staging = torch.zeros((L, S, T, H, D), dtype=cfg.dtype,
                                     device=dev)
        # host bookkeeping
        self.free_pages = list(range(P - 1, -1, -1))
        self.free_staging = list(range(S - 1, -1, -1))
        self.page_table = np.full((cfg.max_seqs, cfg.max_pages_per_seq), -1,
                                  dtype=np.int32)
        self.seq_len = np.zeros(cfg.max_seqs, dtype=np.int32)
        self.active = np.zeros(cfg.max_seqs, dtype=bool)
        # page state: -1 free, 0 compressed, 1 staged (uncompressed)
        self.page_state = np.full(P, -1, dtype=np.int8)
        self.staging_slot = np.full(P, -1, dtype=np.int32)  # page -> slot
        self.stats = {"compressions": 0, "forced": 0, "appends": 0,
                      "alloc_fail": 0}

    # ------------------------------------------------------------ alloc
    def group_of(self, page: int) -> int:
        return page % self.cfg.n_groups

    def new_seq(self) -> int:
        sid = int(np.argmin(self.active))
        if self.active[sid]:
            raise RuntimeError("no free sequence slots")
        self.active[sid] = True
        self.seq_len[sid] = 0
        self.page_table[sid] = -1
        return sid

    def release_seq(self, sid: int) -> None:
        for p in self.page_table[sid]:
            if p >= 0:
                self._free_page(int(p))
        self.page_table[sid] = -1
        self.active[sid] = False
        self.seq_len[sid] = 0

    def _free_page(self, p: int) -> None:
        if self.page_state[p] == 1:
            self.free_staging.append(int(self.staging_slot[p]))
            self.staging_slot[p] = -1
        self.page_state[p] = -1
        self.free_pages.append(p)

    def _alloc_page(self) -> Optional[int]:
        if not self.free_pages or not self.free_staging:
            self.stats["alloc_fail"] += 1
            return None
        p = self.free_pages.pop()
        slot = self.free_staging.pop()
        self.page_state[p] = 1
        self.staging_slot[p] = slot
        return p

    # ----------------------------------------------------------- appends
    def append(self, sid: int, k_tok, v_tok) -> bool:
        """Append one token's K/V ([L, H, D], a tensor or a numpy array)
        for sequence sid. Returns False if a page could not be allocated
        (caller must force compressions and retry)."""
        pos = int(self.seq_len[sid])
        pidx, off = divmod(pos, self.cfg.page_size)
        if off == 0:
            p = self._alloc_page()
            if p is None:
                return False
            self.page_table[sid, pidx] = p
        p = int(self.page_table[sid, pidx])
        slot = int(self.staging_slot[p])
        assert slot >= 0, "append target must be staged"
        self.k_staging[:, slot, off] = torch.as_tensor(
            k_tok, device=self.device).to(self.cfg.dtype)
        self.v_staging[:, slot, off] = torch.as_tensor(
            v_tok, device=self.device).to(self.cfg.dtype)
        self.seq_len[sid] = pos + 1
        self.stats["appends"] += 1
        return True

    # ----------------------------------------------------------- refresh
    def compressible_pages(self) -> list[int]:
        """Staged pages that are FULL (safe to compress; no more appends)."""
        out = []
        for sid in np.where(self.active)[0]:
            full_pages = int(self.seq_len[sid]) // self.cfg.page_size
            for i in range(full_pages):
                p = int(self.page_table[sid, i])
                if p >= 0 and self.page_state[p] == 1:
                    out.append(p)
        return out

    def demand_by_group(self, attending_pages: list[int]) -> list[int]:
        """Demand vector for the maintenance view: pages the current decode
        batch is reading, bucketed by bank-group."""
        d = [0] * self.cfg.n_groups
        for p in attending_pages:
            d[self.group_of(p)] += 1
        return d

    def compressible_by_group(self) -> list[int]:
        """Per-group count of full staged pages (the maintenance work
        actually available on each "bank" right now)."""
        counts = [0] * self.cfg.n_groups
        for p in self.compressible_pages():
            counts[self.group_of(p)] += 1
        return counts

    def group_ready(self) -> list[bool]:
        """`ready` mask for the maintenance view: a group is ready when a
        compression can *start* there, i.e. it holds at least one full
        staged page."""
        return [c > 0 for c in self.compressible_by_group()]

    def compress_page(self, p: int, forced: bool = False) -> None:
        """The refresh operation: staging -> int8 + scale (kernel D on the
        card), frees the slot."""
        assert self.page_state[p] == 1
        slot = int(self.staging_slot[p])
        kq, ks = quantize_page(self.k_staging[:, slot].contiguous())
        vq, vs = quantize_page(self.v_staging[:, slot].contiguous())
        self.k_pages[:, p] = kq
        self.v_pages[:, p] = vq
        self.k_scale[:, p] = ks
        self.v_scale[:, p] = vs
        self.page_state[p] = 0
        self.staging_slot[p] = -1
        self.free_staging.append(slot)
        self.stats["compressions"] += 1
        if forced:
            self.stats["forced"] += 1

    def compress_group(self, group: int, forced: bool = False) -> int:
        n = 0
        for p in self.compressible_pages():
            if self.group_of(p) == group:
                self.compress_page(p, forced=forced)
                n += 1
        return n

    def staging_pressure(self) -> float:
        """Staging occupancy in [0, 1] — the serving analogue of the DRAM
        write-buffer fill level (`MaintenanceView.pressure`)."""
        return 1.0 - len(self.free_staging) / self.cfg.n_staging

    def page_pressure(self) -> float:
        """Long-term page-pool occupancy in [0, 1]; 1.0 means the next
        page allocation must evict a sequence."""
        return 1.0 - len(self.free_pages) / self.cfg.n_pages

    # ------------------------------------------------------------- reads
    def gather_seq(self, sid: int, layer: int, dtype=torch.bfloat16):
        """Materialize sequence sid's full K/V for one layer (the
        reference read path). Returns (k [S,H,D], v [S,H,D])."""
        n = int(self.seq_len[sid])
        if n == 0:
            h, d = self.cfg.n_kv_heads, self.cfg.head_dim
            z = torch.zeros((0, h, d), dtype=dtype, device=self.device)
            return z, z.clone()
        parts_k, parts_v = [], []
        npages = (n + self.cfg.page_size - 1) // self.cfg.page_size
        for i in range(npages):
            p = int(self.page_table[sid, i])
            take = min(self.cfg.page_size, n - i * self.cfg.page_size)
            if self.page_state[p] == 1:
                slot = int(self.staging_slot[p])
                parts_k.append(self.k_staging[layer, slot, :take].to(dtype))
                parts_v.append(self.v_staging[layer, slot, :take].to(dtype))
            else:
                parts_k.append(dequantize_page(
                    self.k_pages[layer, p], self.k_scale[layer, p], dtype)[:take])
                parts_v.append(dequantize_page(
                    self.v_pages[layer, p], self.v_scale[layer, p], dtype)[:take])
        return torch.cat(parts_k), torch.cat(parts_v)

    def pages_of(self, sid: int) -> list[int]:
        n = int(self.seq_len[sid])
        npages = (n + self.cfg.page_size - 1) // self.cfg.page_size
        return [int(self.page_table[sid, i]) for i in range(npages)]
