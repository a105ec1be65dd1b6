"""Serving of the port (``repro.serving``): the continuous-batching
engine and the legacy lockstep engine."""

from repro_torch.serving.engine import (ContinuousEngine, LockstepEngine,
                                        RequestResult)
from repro_torch.serving.kv_cache import (SCRATCH_PAGE, PageAllocator,
                                          PagedKVCache)
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import ScheduleConfig, Scheduler, StepPlan

__all__ = ["ContinuousEngine", "LockstepEngine", "RequestResult",
           "SCRATCH_PAGE", "PageAllocator", "PagedKVCache", "Request",
           "RequestQueue", "RequestState", "ScheduleConfig", "Scheduler",
           "StepPlan"]
