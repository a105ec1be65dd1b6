"""Profiler annotations for emulation sites (``repro.telemetry.trace``).

:func:`gemm_scope` names one emulated GEMM
``emugemm/<scheme>-<p|m><count>/<backend>/<impl>`` in a profiler trace, as
the reference's ``jax.named_scope`` names the ops lowered inside it. The
reference's scopes are trace metadata and cost nothing at run time; the
port's would be a ``torch.profiler.record_function`` on every call of an
eager, host-bound loop, so a scope is opened only while a profiler is
running (``torch._C._autograd._profiler_enabled()``) and is a null
context otherwise.
"""

from __future__ import annotations

import contextlib
from typing import ContextManager

from repro_torch.telemetry.record import gemm_tag


def _profiling() -> bool:
    import torch
    return torch._C._autograd._profiler_enabled()


def gemm_scope(scheme: str, count: int, backend: str, impl: str) -> ContextManager[None]:
    """``torch.profiler.record_function`` for one emulated GEMM while a
    profiler runs, else a null context."""
    if not _profiling():
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(gemm_tag(scheme, count, backend,
                                                   impl))
