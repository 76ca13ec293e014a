"""Engine-external KV state: the page pools + allocator as one portable object
(port of ``repro/serving/kvstate.py``).

``KVPool`` bundles the ``PageAllocator`` and the ``PagedKVCache`` behind an
export/import surface, so a request's KV can move between engines
(disaggregated serving, ``serving/disagg.py``):

  * ``export_pages(rids)`` gathers the requests' pages, block tables and
    committed lengths into a host blob.  Page ids are remapped to a dense
    export-local namespace, and a page shared by several exported requests
    (copy-on-write prefix sharing) is exported once and referenced by each
    table, so sharing survives the move.
  * ``import_pages(blob)`` adopts an export into another pool: every
    distinct exported page gets a fresh page from the target's free list
    (``PageAllocator.import_tables``, atomic on ``OutOfPages``) and the
    payloads are copied into the pools at the remapped ids.

The pools are written IN PLACE (``index_copy_``), never rebound: a captured
CUDA graph holds the addresses of ``PagedKVCache.k[i]``/``.v[i]``, and a
rebound pool would leave its replays reading the old one without an error.
The port keeps no ``pos`` pool (serving/kvcache.py): every paged read is
masked by a resident length, which the blob's ``lengths`` carry, so the
blob has no ``pos`` key.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.serving.kvcache import PageAllocator, PagedKVCache

# blob dtype name -> (pool dtype, the numpy dtype carrying its bits)
_BLOB_DTYPES = {"bfloat16": (torch.bfloat16, torch.int16),
                "float32": (torch.float32, torch.float32)}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A pool gather as a numpy array: bfloat16 as its raw bits (int16;
    numpy has no bfloat16), float32 as itself."""
    carrier = _BLOB_DTYPES[str(t.dtype).removeprefix("torch.")][1]
    return t.view(carrier).cpu().numpy()


class KVPool:
    """Composition of the ``PageAllocator`` (``pool.alloc``) and the
    ``PagedKVCache`` (``pool.kv``); the engine uses both directly and the
    pool adds the migration and serialization surface."""

    def __init__(self, alloc: PageAllocator, kv: PagedKVCache):
        assert alloc.page_size == kv.page_size, (alloc.page_size, kv.page_size)
        assert alloc.num_pages == kv.num_pages, (alloc.num_pages, kv.num_pages)
        self.alloc = alloc
        self.kv = kv

    @classmethod
    def create(cls, cfg: ModelConfig, num_pages: int, page_size: int, *,
               tp: int = 1, dtype=torch.bfloat16, device=None,
               trace=None) -> "KVPool":
        """``trace``: the ``obs.TraceRing`` the allocator narrates into."""
        return cls(PageAllocator(num_pages, page_size, trace=trace),
                   PagedKVCache(cfg, num_pages, page_size, tp=tp, dtype=dtype,
                                device=device))

    @property
    def page_size(self) -> int:
        return self.alloc.page_size

    @property
    def dtype(self) -> torch.dtype:
        return self.kv.dtype

    # ------------------------------------------------------------------
    # export / import
    # ------------------------------------------------------------------
    def export_pages(self, rids: Sequence[int]) -> Dict[str, Any]:
        """Host blob of ``rids``' KV state.

        Returns ``{"page_size", "dtype", "tables", "lengths", "n_pages",
        "pages"}``: ``tables`` maps rid -> export-local page ids
        (0..n_pages-1, first-reference order), ``lengths`` the committed
        token counts, and ``pages`` holds ``k`` and ``v``, each a list over
        attention positions of numpy arrays (P, n_pages, ps, Hkv, hd).  A
        bf16 payload is carried as its raw 16-bit pattern in an
        int16 array and ``dtype`` names the pool's type; fp32 as float32.
        The round trip is bit-exact.  The source pool is not mutated: the
        caller decides whether the export is a move or a copy."""
        local_of: Dict[int, int] = {}
        tables: Dict[int, List[int]] = {}
        for rid in rids:
            assert rid in self.alloc.tables, f"export of pageless request {rid}"
            row = []
            for pg in self.alloc.tables[rid]:
                if pg not in local_of:
                    local_of[pg] = len(local_of)
                row.append(local_of[pg])
            tables[rid] = row
        src = torch.tensor(list(local_of), dtype=torch.long,
                           device=self.kv.device)
        pages = {"k": [_to_host(k.index_select(1, src)) for k in self.kv.k],
                 "v": [_to_host(v.index_select(1, src)) for v in self.kv.v]}
        return {"page_size": self.page_size,
                "dtype": str(self.dtype).removeprefix("torch."),
                "tables": tables,
                "lengths": {rid: self.alloc.tokens(rid) for rid in rids},
                "n_pages": len(local_of), "pages": pages}

    def import_pages(self, blob: Dict[str, Any]) -> Dict[int, int]:
        """Adopt an ``export_pages`` blob into THIS pool.

        Allocates one fresh page per distinct exported page (raising
        ``OutOfPages`` atomically, nothing mutated, when the free list
        cannot cover them), installs the remapped block tables with
        refcounts equal to the number of importing tables, and copies the
        payloads into the pools in place at the new ids.  Returns the
        export-local-id -> new-page mapping."""
        assert blob["page_size"] == self.page_size, \
            (blob["page_size"], self.page_size)
        dtype, _ = _BLOB_DTYPES[blob["dtype"]]
        assert dtype == self.dtype, (blob["dtype"], self.dtype)
        mapping = self.alloc.import_tables(blob["tables"], blob["lengths"])
        n = blob["n_pages"]
        if n == 0:
            return mapping
        dev = self.kv.device
        new_ids = torch.tensor([mapping[lid] for lid in range(n)],
                               dtype=torch.long, device=dev)
        for pools, payloads in ((self.kv.k, blob["pages"]["k"]),
                                (self.kv.v, blob["pages"]["v"])):
            for pool, payload in zip(pools, payloads):
                src = torch.from_numpy(np.ascontiguousarray(payload))
                pool.index_copy_(1, new_ids, src.view(dtype).to(dev))
        return mapping

    # ------------------------------------------------------------------
    def scrub(self, pages: Sequence[int]) -> None:
        """Zero released pages' k and v in place.  (The reference invalidates
        their ``pos`` entries, since its attention validity derives from
        ``pos``.)  In the port no read depends on it: every paged read is
        masked by the resident length, and a request writes its first
        ``length`` positions before it reads them, so a reused page's old
        tail is never read.  Zeroing keeps a dead request's KV from lying
        in a free page."""
        if not len(pages):
            return
        ids = torch.tensor(list(pages), dtype=torch.long,
                           device=self.kv.device)
        for pool in self.kv.k + self.kv.v:
            pool.index_fill_(1, ids, 0)

    def stats(self) -> Dict[str, Any]:
        s = self.alloc.stats()
        s["kv_bytes_live"] = self.kv.kv_bytes(self.alloc)
        s["kv_bytes_reserved"] = self.kv.total_bytes()
        return s
