"""Request objects + lifecycle for the serving engine (copy of
``repro/serving/requests.py``)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_ids = itertools.count()


@dataclass
class SamplingParams:
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => full
    max_new_tokens: int = 32
    eos_id: int = 1
    seed: int = 0


@dataclass
class Request:
    prompt: np.ndarray                # (S,) int32
    sampling: SamplingParams = field(default_factory=SamplingParams)
    rid: int = field(default_factory=lambda: next(_ids))
    priority: int = 0                 # paged engine "priority" policy: higher first
    # family extras (stub frontends)
    frames: Optional[np.ndarray] = None
    patches: Optional[np.ndarray] = None


@dataclass
class RequestState:
    request: Request
    slot: int
    generated: List[int] = field(default_factory=list)
    prompt_len: int = 0
    done: bool = False
    # --- paged engine (chunked prefill) bookkeeping ---
    prefilled: int = 0                # prompt tokens already resident in pages
    chunk_plan: Tuple[int, ...] = ()  # ISO chunk boundaries = scheduling quanta
    t_submit: float = 0.0
    t_first: float = -1.0             # wall time of the first sampled token

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.generated)

    def finish_check(self) -> None:
        sp = self.request.sampling
        if (self.generated and self.generated[-1] == sp.eos_id) or \
                len(self.generated) >= sp.max_new_tokens:
            self.done = True
