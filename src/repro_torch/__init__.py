"""repro_torch: EmuGEMM (Ozaki Scheme I/II precision emulation) in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper; the port of the JAX
package ``repro``.

The public surface:

  repro_torch.precision("ozaki1-p4")          spec string -> EmulationConfig
  with repro_torch.emulation("ozaki2-m6"):    ambient emulation scope
  repro_torch.einsum("bik,bkj->bij", a, b)    emulated general contractions
  repro_torch.dot_general(a, b, dnums)        ... in dimension-number form
  repro_torch.emulated_matmul(a, b, cfg=...)  the 2-D kernel front door
  repro_torch.emulated_dot(a, b, cfg)         (..., K) @ (K, N), differentiable
  repro_torch.plan_precision(bits, k)         Fig.-7 scheme/slice planner
  repro_torch.GemmPolicy / prepare_rhs        model policies / prepared weights
  repro_torch.guard / "+guard" spec suffix    numerical guardrails
  repro_torch.verify_gemm(a, b, c, cfg)       a posteriori residual check
  repro_torch.telemetry                       metrics registry and sinks

It imports torch and never jax, nor anything of ``repro``. Module paths
mirror the reference's.
"""

from repro_torch.api import (
    EMULATION_ENV_VAR,
    current_emulation,
    dot_general,
    einsum,
    emulation,
    precision,
    resolve_config,
)
from repro_torch.core.precision import (
    EmulationConfig,
    NATIVE,
    plan_precision,
)

__all__ = [
    # precision specs + planning
    "EmulationConfig",
    "NATIVE",
    "precision",
    "plan_precision",
    # ambient scopes + the resolver
    "EMULATION_ENV_VAR",
    "emulation",
    "current_emulation",
    "resolve_config",
    # contractions
    "dot_general",
    "einsum",
    "emulated_dot",
    "emulated_matmul",
    "emulated_matmul_batched",
    # model policies + prepared weights
    "GemmPolicy",
    "prepare_rhs",
    "PreparedOperand",
    # numerical guardrails
    "guard",
    "EmulationAccuracyError",
    "verify_gemm",
    # observability
    "telemetry",
]

# The kernel stack resolves lazily, so `import repro_torch` stays cheap and
# builds nothing.
_LAZY = {
    "emulated_dot": ("repro_torch.core.emulated", "emulated_dot"),
    "emulated_matmul": ("repro_torch.kernels.dispatch", "emulated_matmul"),
    "emulated_matmul_batched": ("repro_torch.kernels.dispatch",
                                "emulated_matmul_batched"),
    "GemmPolicy": ("repro_torch.models.common", "GemmPolicy"),
    "prepare_rhs": ("repro_torch.kernels.prepared", "prepare_rhs"),
    "PreparedOperand": ("repro_torch.kernels.prepared", "PreparedOperand"),
    "guard": ("repro_torch.guard", None),  # the subpackage itself
    "EmulationAccuracyError": ("repro_torch.core.precision",
                               "EmulationAccuracyError"),
    "verify_gemm": ("repro_torch.guard.verify", "verify_gemm"),
    "telemetry": ("repro_torch.telemetry", None),  # the subpackage itself
}


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch' has no attribute "
                             f"{name!r}") from None
    import importlib
    mod = importlib.import_module(module)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value     # cache for later lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
