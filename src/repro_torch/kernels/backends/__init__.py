"""Kernel-backend registry of the port (``repro.kernels.backends``).

Two backends ship built in:

  ``cuda``  — the hand-written Hopper kernels (csrc/); on a CPU tensor a
              kernel wrapper runs its plain version instead;
  ``torch`` — the plain versions as torch ops, on any device (the role
              the reference's ``xla`` backend plays).

Selection precedence (:func:`resolve_backend_name`):

  explicit argument > ``REPRO_TORCH_BACKEND`` env var > ``EmulationConfig
  .backend`` > default: ``cuda`` for CUDA tensors, ``torch`` for CPU
  tensors.

Unlike the reference, an unknown name raises: nothing falls back
silently.
"""

from __future__ import annotations

import os

from repro_torch.kernels.backends.base import (  # noqa: F401
    BackendCapabilities, KernelBackend)
from repro_torch.kernels.backends.cuda import CudaBackend
from repro_torch.kernels.backends.reference import TorchBackend

ENV_VAR = "REPRO_TORCH_BACKEND"

_REGISTRY: dict[str, KernelBackend] = {
    b.name: b for b in (CudaBackend(), TorchBackend())}


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> KernelBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel backend {name!r}; registered: "
                       f"{available_backends()}") from None


def default_backend_name(device=None) -> str:
    return "cuda" if getattr(device, "type", device) == "cuda" else "torch"


def resolve_backend_name(name: str | None = None, cfg=None,
                         device=None) -> str:
    """Apply the selection precedence; returns a registered name."""
    requested = (name or os.environ.get(ENV_VAR)
                 or getattr(cfg, "backend", None)
                 or default_backend_name(device))
    get_backend(requested)
    return requested


def resolve_backend(name: str | None = None, cfg=None,
                    device=None) -> KernelBackend:
    return get_backend(resolve_backend_name(name, cfg, device))
