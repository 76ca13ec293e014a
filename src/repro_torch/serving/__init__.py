from repro_torch.serving.engine import Engine  # noqa: F401
from repro_torch.serving.kvcache import PageAllocator, PagedKVCache  # noqa: F401
from repro_torch.serving.kvstate import KVPool  # noqa: F401
from repro_torch.serving.paged_engine import PagedEngine  # noqa: F401
from repro_torch.serving.requests import Request, RequestState  # noqa: F401
from repro_torch.serving.scheduler import TokenBudgetScheduler  # noqa: F401
