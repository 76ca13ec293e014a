"""Paged KV cache: fixed-size token pages, free-list allocator, block tables
(port of ``repro/serving/kvcache.py``).

  * ``PageAllocator``: pure-Python bookkeeping (free list, per-request block
    tables, committed token counts, page refcounts for prefix sharing:
    ``adopt`` maps a donor's prefix pages into a fresh request, ``cow``
    gives a writer its own copy of a shared page), copied from the
    reference with its trace narration (alloc, free, rc_drop, cow, adopt),
    its JSON-able ``snapshot``/``restore`` and ``import_tables``, which
    adopts a migrated request group's block tables at fresh page ids
    (``serving/kvstate.KVPool.import_pages``).
  * ``PrefixCache``: the hash index over registered prompt prefixes that
    finds a live donor for a new request, with ``snapshot``/``restore``.
  * ``PagedKVCache``: torch page pools, one (k, v) pair per attention
    position of ``cfg.block_pattern``, each ``(P, N+1, page_size, Hkv, hd)``
    with the period dim leading.  Page N is a reserved scratch page: decode
    scatters from inactive slots, bucket-pad tails and pad rows of a
    prefill pack land there.

The reference also keeps a ``pos`` pool for position-driven gathers, and
invalidates its entries when pages are freed and when a speculative
verify's positions are rejected.  The port has no such pool: every paged
read is masked by a resident length (decode by ``lengths``, prefill by
``prefix_lens``), and a request's first ``length`` positions are all written
before they are read.  What a page holds past that length is never read: a
dead request's tail on a reused page, the KV of rejected verify positions
(the window's own keys come from the in-call merge, not from the page), and
a donor's tokens past a sharee's shared length on an adopted page (the
sharee copies the page before it writes there).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import AFMOE_KINDS, ModelConfig
from repro_torch.layers.heads import head_layout

# block kinds that own a KV cache (an afmoe sliding layer's pool keeps every
# position too: its window is applied when the pool is read)
KV_KINDS = ("attn_mlp", "attn_moe", "hybrid") + AFMOE_KINDS


class OutOfPages(RuntimeError):
    """Raised by PageAllocator when the pool cannot satisfy a request; the
    engine turns this into preemption-by-eviction."""


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


class PageAllocator:
    """Free-list page allocator with per-request block tables and refcounted
    prefix/page sharing.

    Invariants (``check``): free + unique-allocated == num_pages; a page's
    refcount equals the number of block tables referencing it; a page handed
    out (``ensure`` growth or a ``cow`` copy target) comes from the free
    list, never from a page another request still holds; a request's
    capacity ``len(table) * page_size`` covers its committed token count."""

    def __init__(self, num_pages: int, page_size: int, trace=None):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._free_set = set(self._free)
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.refcount: Dict[int, int] = {}        # page -> #tables holding it
        # optional obs.TraceRing: every pool mutation narrates itself, each
        # event carrying free= and used=, so a trace replay can prove
        # conservation (pages_allocated - pages_freed == used_pages)
        self.trace = trace

    def _emit(self, kind: str, rid: int, **payload) -> None:
        if self.trace is not None:
            self.trace.emit(kind, rid=rid, free=len(self._free),
                            used=self.used_pages, **payload)

    # ---- queries ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def capacity(self, rid: int) -> int:
        return len(self.tables.get(rid, ())) * self.page_size

    def tokens(self, rid: int) -> int:
        return self.lengths.get(rid, 0)

    def shared_pages(self) -> int:
        """Pages referenced by more than one block table."""
        return sum(1 for rc in self.refcount.values() if rc > 1)

    def page_shared(self, pg: int) -> bool:
        return self.refcount.get(pg, 0) > 1

    def logical_tokens(self) -> int:
        """Tokens committed across requests (shared pages count per
        sharer)."""
        return sum(self.lengths.values())

    def utilization(self) -> float:
        """Committed tokens per allocated page slot; above 1.0 when sharing
        maps several requests' tokens onto one page."""
        used = self.used_pages * self.page_size
        if not used:
            return 1.0
        return sum(self.lengths.values()) / used

    def fragmentation(self) -> int:
        """Allocated but empty token slots (tail waste of partial pages),
        floored at 0 under sharing."""
        return max(0, self.used_pages * self.page_size
                   - sum(self.lengths.values()))

    # ---- mutation ---------------------------------------------------------
    def _take_free(self) -> int:
        pg = self._free.pop()
        self._free_set.discard(pg)
        assert self.refcount.get(pg, 0) == 0, \
            f"free list handed out live page {pg}"
        self.refcount[pg] = 1
        return pg

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
            table.append(self._take_free())
        self._emit("alloc", rid, n=need)

    def commit(self, rid: int, n_tokens: int) -> None:
        """Record ``n_tokens`` more live tokens for ``rid``."""
        new = self.lengths.get(rid, 0) + n_tokens
        assert new <= self.capacity(rid), (rid, new, self.capacity(rid))
        self.lengths[rid] = new

    def adopt(self, rid: int, pages: List[int], n_tokens: int) -> None:
        """Map another request's prefix ``pages`` into fresh request
        ``rid``'s table (prefix sharing): refcounts go up and ``n_tokens``
        are committed as resident.  Nothing is copied."""
        assert rid not in self.tables, f"adopt into non-fresh request {rid}"
        assert n_tokens <= len(pages) * self.page_size
        for pg in pages:
            assert self.refcount.get(pg, 0) > 0, f"adopting dead page {pg}"
            assert pg not in self._free_set
            self.refcount[pg] += 1
        self.tables[rid] = list(pages)
        self.lengths[rid] = n_tokens
        self._emit("adopt", rid, n_pages=len(pages), tokens=n_tokens)

    def cow(self, rid: int, block_idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: give ``rid`` a private copy of a shared page before
        it writes into it.  Returns (old_page, new_page) for the device-side
        copy, or None if the page was already exclusive.  Raises OutOfPages
        (mutating nothing) when no page is free."""
        table = self.tables[rid]
        old = table[block_idx]
        if self.refcount.get(old, 0) <= 1:
            return None
        if not self._free:
            raise OutOfPages(f"cow of page {old}: no free pages")
        new = self._take_free()
        self.refcount[old] -= 1
        table[block_idx] = new
        # the copy target counts as an allocation for conservation (the old
        # page stays live with the other sharers)
        self._emit("alloc", rid, n=1)
        self._emit("cow", rid, old=old, new=new)
        return old, new

    def free(self, rid: int) -> List[int]:
        """Drop all of ``rid``'s page references; returns the pages whose
        refcount reached zero (pages another request shares stay live)."""
        table = self.tables.pop(rid, [])
        self.lengths.pop(rid, None)
        released = []
        rc_drops = 0
        for pg in table:
            assert pg not in self._free_set, f"double free of page {pg}"
            rc = self.refcount.get(pg, 0)
            assert rc > 0, f"freeing page {pg} with refcount 0"
            if rc == 1:
                del self.refcount[pg]
                self._free.append(pg)
                self._free_set.add(pg)
                released.append(pg)
            else:
                self.refcount[pg] = rc - 1
                rc_drops += 1
        if released:
            self._emit("free", rid, n=len(released))
        if rc_drops:
            # a sharer dropping its refcount releases nothing: its own
            # (replay-neutral) event
            self._emit("rc_drop", rid, n=rc_drops)
        return released

    def import_tables(self, tables: Dict[int, List[int]],
                      lengths: Dict[int, int]) -> Dict[int, int]:
        """Adopt exported block tables into THIS pool: ``tables`` reference
        export-local page ids, and every distinct id gets one fresh page
        from the free list, so sharing among the imported requests is kept
        (refcounts equal to the number of importing tables).  Returns the
        local-id -> new-page mapping for the payload scatter.  Raises
        OutOfPages, mutating nothing, when the free list cannot cover the
        distinct pages (the disagg router's defer-and-retry path)."""
        local_ids = sorted({pg for t in tables.values() for pg in t})
        for rid in tables:
            assert rid not in self.tables, f"import into live request {rid}"
            assert rid in lengths, rid
        if len(local_ids) > len(self._free):
            raise OutOfPages(f"import needs {len(local_ids)} pages, "
                             f"{len(self._free)} free")
        mapping: Dict[int, int] = {}
        for lid in local_ids:
            pg = self._free.pop()
            self._free_set.discard(pg)
            assert self.refcount.get(pg, 0) == 0, \
                f"free list handed out live page {pg}"
            mapping[lid] = pg
        for rid, t in tables.items():
            new_t = [mapping[lid] for lid in t]
            for pg in new_t:
                self.refcount[pg] = self.refcount.get(pg, 0) + 1
            self.tables[rid] = new_t
            self.lengths[rid] = lengths[rid]
            assert self.lengths[rid] <= len(new_t) * self.page_size
        self._emit("alloc", next(iter(tables), -1), n=len(local_ids))
        return mapping

    # ---- serialization ----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The whole allocator state as a JSON-able dict (keys become
        strings; ``restore`` converts back).  The free list's ORDER is kept,
        so a restored allocator hands out pages in the same sequence."""
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "free": list(self._free),
                "tables": {str(r): list(t) for r, t in self.tables.items()},
                "lengths": {str(r): n for r, n in self.lengths.items()},
                "refcount": {str(p): rc for p, rc in self.refcount.items()}}

    def restore(self, snap: Dict[str, Any]) -> None:
        """Overwrite this allocator's state from a ``snapshot()`` dict (the
        geometry must match) and re-check the invariants."""
        assert snap["num_pages"] == self.num_pages, \
            (snap["num_pages"], self.num_pages)
        assert snap["page_size"] == self.page_size, \
            (snap["page_size"], self.page_size)
        self._free = [int(p) for p in snap["free"]]
        self._free_set = set(self._free)
        self.tables = {int(r): [int(p) for p in t]
                       for r, t in snap["tables"].items()}
        self.lengths = {int(r): int(n) for r, n in snap["lengths"].items()}
        self.refcount = {int(p): int(rc)
                         for p, rc in snap["refcount"].items()}
        self.check()

    def check(self) -> None:
        """Structural invariants: free + unique-allocated == num_pages, a
        page's refcount equals the number of tables referencing it, no page
        both free and referenced, tokens within capacity."""
        allocated = {pg for t in self.tables.values() for pg in t}
        assert not (allocated & self._free_set), \
            f"pages both free and allocated: {allocated & self._free_set}"
        assert len(self._free) == len(self._free_set), "free-list duplicates"
        assert len(self._free) + len(allocated) == self.num_pages, \
            (len(self._free), len(allocated), self.num_pages)
        refs: Dict[int, int] = {}
        for t in self.tables.values():
            for pg in t:
                refs[pg] = refs.get(pg, 0) + 1
        assert refs == self.refcount, (refs, self.refcount)
        for rid, n in self.lengths.items():
            assert n <= len(self.tables.get(rid, ())) * self.page_size, \
                (rid, n)

    def block_table(self, rid: int, max_blocks: int) -> np.ndarray:
        """Padded (-1) block table row of static width ``max_blocks``."""
        table = self.tables.get(rid, [])
        assert len(table) <= max_blocks, (rid, len(table), max_blocks)
        row = np.full(max_blocks, -1, np.int32)
        row[:len(table)] = table
        return row

    def stats(self) -> Dict[str, Any]:
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "free_pages": self.free_pages, "used_pages": self.used_pages,
                "shared_pages": self.shared_pages(),
                "logical_tokens": self.logical_tokens(),
                "utilization": self.utilization(),
                "fragmentation_tokens": self.fragmentation()}


class PrefixCache:
    """Hash index over registered prompt prefixes for page sharing.

    Every admitted request registers its prompt: one hash per page-aligned
    prefix.  A new request looks up the longest page-aligned prefix of its
    prompt that a live donor holds (hash first, then token-by-token
    verification: a collision can suggest, never corrupt), then extends
    token by token into the donor's next page, so a partly matching page is
    shared too (the engine copies it on write before the sharer's first
    divergent write).  The index holds request ids, not pages: validity is
    checked against the allocator at lookup, so a dead donor simply stops
    matching."""

    def __init__(self, page_size: int):
        self.ps = page_size
        self._prompts: Dict[int, np.ndarray] = {}       # rid -> prompt
        self._by_hash: Dict[int, List[int]] = {}        # prefix hash -> rids

    @staticmethod
    def _h(tokens: np.ndarray) -> int:
        return hash(np.asarray(tokens, np.int32).tobytes())

    def register(self, rid: int, prompt: np.ndarray) -> None:
        if rid in self._prompts:
            return                            # re-admission after preemption
        prompt = np.asarray(prompt, np.int32)
        self._prompts[rid] = prompt
        for k in range(1, len(prompt) // self.ps + 1):
            self._by_hash.setdefault(self._h(prompt[:k * self.ps]),
                                     []).append(rid)

    def forget(self, rid: int) -> None:
        prompt = self._prompts.pop(rid, None)
        if prompt is None:
            return
        for k in range(1, len(prompt) // self.ps + 1):
            h = self._h(prompt[:k * self.ps])
            rids = self._by_hash.get(h, [])
            if rid in rids:
                rids.remove(rid)
            if not rids:
                self._by_hash.pop(h, None)

    def snapshot(self) -> Dict[str, Any]:
        """The registered prompts as a JSON-able dict.  The hash index is
        not kept: ``hash(bytes)`` is salted per process, so ``restore``
        rebuilds it from the prompts."""
        return {"page_size": self.ps,
                "prompts": {str(r): [int(t) for t in p]
                            for r, p in self._prompts.items()}}

    def restore(self, snap: Dict[str, Any]) -> None:
        assert snap["page_size"] == self.ps, (snap["page_size"], self.ps)
        self._prompts = {}
        self._by_hash = {}
        for r, toks in snap["prompts"].items():
            self.register(int(r), np.asarray(toks, np.int32))

    def lookup(self, prompt: np.ndarray, alloc: PageAllocator,
               exclude: int = -1):
        """Best live donor for ``prompt``: (donor_rid, shared_tokens,
        shared_pages) or None.  ``shared_tokens`` is capped at
        ``len(prompt) - 1``, so the sharer prefills at least one token (its
        last-position logits give the first sample)."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.ps
        for k in range(len(prompt) // ps, 0, -1):
            for rid in self._by_hash.get(self._h(prompt[:k * ps]), ()):
                if rid == exclude or rid not in alloc.tables:
                    continue
                donor = self._prompts.get(rid)
                if donor is None or len(donor) < k * ps or \
                        not np.array_equal(donor[:k * ps], prompt[:k * ps]):
                    continue
                if alloc.tokens(rid) < k * ps or \
                        len(alloc.tables[rid]) < k:
                    continue                  # donor hasn't prefilled this far
                # extend token-wise into the donor's page k (partial share)
                limit = min(len(prompt) - 1, len(donor), alloc.tokens(rid),
                            len(alloc.tables[rid]) * ps)
                t = k * ps
                while t < limit and donor[t] == prompt[t]:
                    t += 1
                t = min(t, len(prompt) - 1)
                if t <= 0:
                    continue
                return rid, t, list(alloc.tables[rid][:pages_for(t, ps)])
        return None


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
    (the reference shards the pool's head axis over the model axis).  A
    stack with no attention position (xLSTM) has empty ``k``/``v`` tuples;
    its allocator still keeps the block tables, and ``dtype``/``device``
    still name the pool's."""

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int,
                 tp: int = 1, dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.num_pages = num_pages            # usable pages (scratch excluded)
        self.page_size = page_size
        self.dtype = dtype
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
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

    def page_bytes(self) -> int:
        """KV bytes of one page across all layers (k and v)."""
        return sum(2 * k[:, 0].numel() * k.element_size() for k in self.k)

    def kv_bytes(self, allocator: PageAllocator) -> int:
        """Live KV footprint: bytes of the pages allocated to requests."""
        return allocator.used_pages * self.page_bytes()

    def total_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.k + self.v)
