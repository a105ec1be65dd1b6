"""Continuous-batching serving of the port (``repro.serving``)."""

from repro_torch.serving.engine import ContinuousEngine, RequestResult
from repro_torch.serving.kv_cache import (SCRATCH_PAGE, PageAllocator,
                                          PagedKVCache)
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import ScheduleConfig, Scheduler, StepPlan

__all__ = ["ContinuousEngine", "RequestResult", "SCRATCH_PAGE",
           "PageAllocator", "PagedKVCache", "Request", "RequestQueue",
           "RequestState", "ScheduleConfig", "Scheduler", "StepPlan"]
