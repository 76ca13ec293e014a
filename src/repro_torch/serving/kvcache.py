"""Paged KV cache: fixed-size token pages, free-list allocator, block tables
(port of ``repro/serving/kvcache.py`` for the slice).

  * ``PageAllocator``: pure-Python bookkeeping (free list, per-request block
    tables, committed token counts), copied from the reference without the
    prefix-sharing (adopt / copy-on-write) and serialization parts.
  * ``PagedKVCache``: torch page pools, one (k, v) pair per attention
    position of ``cfg.block_pattern``, each ``(P, N+1, page_size, Hkv, hd)``
    with the period dim leading.  Page N is a reserved scratch page: decode
    scatters from inactive slots and bucket-pad tails land there.

The reference also keeps a ``pos`` pool for position-driven gathers; the
port's paged kernels mask by resident length alone (a request's pages cover
positions [0, length) contiguously, all written before they are read), so
it has no such pool.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.heads import head_layout

# block kinds that own a KV cache
KV_KINDS = ("attn_mlp",)


class OutOfPages(RuntimeError):
    """Raised by PageAllocator when the pool cannot satisfy a request; the
    engine turns this into preemption-by-eviction."""


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


class PageAllocator:
    """Free-list page allocator with per-request block tables.

    Invariants: free + allocated == num_pages; a page belongs to at most one
    table; a request's capacity ``len(table) * page_size`` covers its
    committed token count."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def capacity(self, rid: int) -> int:
        return len(self.tables.get(rid, ())) * self.page_size

    def ensure(self, rid: int, n_tokens: int) -> None:
        """Grow ``rid``'s block table to hold ``n_tokens`` tokens.  Raises
        OutOfPages (allocating nothing) if the pool can't cover it."""
        table = self.tables.setdefault(rid, [])
        need = pages_for(n_tokens, self.page_size) - len(table)
        if need <= 0:
            return
        if need > len(self._free):
            if not table:
                del self.tables[rid]
            raise OutOfPages(f"need {need} pages, {len(self._free)} free")
        for _ in range(need):
            table.append(self._free.pop())

    def commit(self, rid: int, n_tokens: int) -> None:
        """Record ``n_tokens`` more live tokens for ``rid``."""
        new = self.lengths.get(rid, 0) + n_tokens
        assert new <= self.capacity(rid), (rid, new, self.capacity(rid))
        self.lengths[rid] = new

    def free(self, rid: int) -> List[int]:
        """Release all of ``rid``'s pages; returns them."""
        table = self.tables.pop(rid, [])
        self.lengths.pop(rid, None)
        assert not set(table) & set(self._free), f"double free in {table}"
        self._free.extend(table)
        return table

    def check(self) -> None:
        """Structural invariants: no page both free and allocated, no page
        in two tables, every page accounted for, tokens within capacity."""
        allocated = [pg for t in self.tables.values() for pg in t]
        assert len(allocated) == len(set(allocated)), "page in two tables"
        assert not set(allocated) & set(self._free)
        assert len(self._free) + len(allocated) == self.num_pages
        for rid, n in self.lengths.items():
            assert n <= self.capacity(rid), (rid, n)

    def block_table(self, rid: int, max_blocks: int) -> np.ndarray:
        """Padded (-1) block table row of static width ``max_blocks``."""
        table = self.tables.get(rid, [])
        assert len(table) <= max_blocks, (rid, len(table), max_blocks)
        row = np.full(max_blocks, -1, np.int32)
        row[:len(table)] = table
        return row


# ---------------------------------------------------------------------------
# page coordinates
# ---------------------------------------------------------------------------

def token_page_coords(positions: torch.Tensor, block_table: torch.Tensor,
                      page_size: int, scratch: int):
    """Map absolute token positions -> (page_id, offset) through one block
    table.  positions: (T,) integer; block_table: (MB,) (-1 pad).  Positions
    whose table slot is unallocated map to the scratch page."""
    positions = positions.long()
    blk = positions // page_size
    MB = block_table.shape[0]
    page = block_table.long()[blk.clamp(0, MB - 1)]
    page = torch.where((blk < MB) & (page >= 0), page,
                       torch.full_like(page, scratch))
    return page, positions % page_size


def window_page_coords(lengths: torch.Tensor, block_tables: torch.Tensor,
                       k_tokens: int, page_size: int, scratch: int,
                       decode_mask=None):
    """Map a K-token decode window's positions -> (page, off, ok, positions)
    through per-request block tables.  Window token qi sits at
    ``lengths[b] + qi``; ``ok`` (B, K) marks positions landing in a live page
    of an active slot, everything else has ``page`` routed to ``scratch``."""
    positions = (lengths.long()[:, None]
                 + torch.arange(k_tokens, device=lengths.device)[None])
    blk = positions // page_size
    MB = block_tables.shape[1]
    page = torch.gather(block_tables.long(), 1, blk.clamp(0, MB - 1))
    ok = (page >= 0) & (blk < MB)
    if decode_mask is not None:
        ok &= decode_mask[:, None]
    page = torch.where(ok, page, torch.full_like(page, scratch))
    return page, positions % page_size, ok, positions


class PagedKVCache:
    """Owns the page pools: ``k[i]``/``v[i]`` for the i-th attention
    position, each (P, N+1, page_size, Hkv_loc, hd), zero-initialised.
    ``Hkv_loc = hkv_eff // tp`` is this rank's share of the kv head slots
    (the reference shards the pool's head axis over the model axis)."""

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int,
                 tp: int = 1, dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.num_pages = num_pages            # usable pages (scratch excluded)
        self.page_size = page_size
        periods = cfg.num_layers // len(cfg.block_pattern)
        layout = head_layout(cfg.num_heads, max(cfg.num_kv_heads, 1), tp)
        shape = (periods, num_pages + 1, page_size, layout.hkv_eff // tp,
                 cfg.resolved_head_dim)
        self.kv_positions = tuple(i for i, kind in enumerate(cfg.block_pattern)
                                  if kind in KV_KINDS)
        self.k = tuple(torch.zeros(shape, dtype=dtype, device=device)
                       for _ in self.kv_positions)
        self.v = tuple(torch.zeros(shape, dtype=dtype, device=device)
                       for _ in self.kv_positions)

    @property
    def scratch_page(self) -> int:
        return self.num_pages
