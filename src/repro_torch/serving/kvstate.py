"""Engine-external KV state: the page pools + allocator as one object (port
of ``KVPool.create`` from ``repro/serving/kvstate.py``; export/import for
page migration is ROADMAP queue A item 9)."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.serving.kvcache import PageAllocator, PagedKVCache


class KVPool:
    """Composition of the ``PageAllocator`` (``pool.alloc``) and the
    ``PagedKVCache`` (``pool.kv``)."""

    def __init__(self, alloc: PageAllocator, kv: PagedKVCache):
        assert alloc.page_size == kv.page_size, (alloc.page_size, kv.page_size)
        assert alloc.num_pages == kv.num_pages, (alloc.num_pages, kv.num_pages)
        self.alloc = alloc
        self.kv = kv

    @classmethod
    def create(cls, cfg: ModelConfig, num_pages: int, page_size: int, *,
               tp: int = 1, dtype=torch.bfloat16, device=None) -> "KVPool":
        return cls(PageAllocator(num_pages, page_size),
                   PagedKVCache(cfg, num_pages, page_size, tp=tp, dtype=dtype,
                                device=device))
