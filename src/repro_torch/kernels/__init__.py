"""The port's kernels for EmuGEMM precision emulation (``repro.kernels``).

Layering:

  csrc/          the hand-written Hopper kernels (CUDA C++, plain C
                 interfaces), built by ``build.py`` with nvcc at first use
  backends/      the kernel-backend registry: 'cuda' (the kernels) and
                 'torch' (their plain versions)
  dispatch.py    routing: one plan per GEMM (cached blocks), batching,
                 launch-policy resolution
  ozaki1/2/3m, decompose, matmul_int8, flash_attn
                 one module per kernel source: wrapper, plain version,
                 launch counts
  prepared.py    prepared weights (``PreparedOperand``,
                 ``PreparedResidues``) and the once-per-step hoist
  ops.py         scheme-pinned end-to-end wrappers

The re-exports below are the reference's, where the port has a
counterpart (it has no ``register_backend`` and no ``build_pallas_call``).
They resolve lazily: every ``import repro_torch.kernels.x`` runs this
file, and importing ``dispatch`` or ``prepared`` here would risk an
import cycle.
"""

_LAZY = {
    "KernelBackend": "repro_torch.kernels.backends",
    "available_backends": "repro_torch.kernels.backends",
    "get_backend": "repro_torch.kernels.backends",
    "resolve_backend": "repro_torch.kernels.backends",
    "auto_fused_matmul": "repro_torch.kernels.dispatch",
    "emulated_matmul": "repro_torch.kernels.dispatch",
    "emulated_matmul_batched": "repro_torch.kernels.dispatch",
    "plan_emulated": "repro_torch.kernels.dispatch",
    "resolve_policy": "repro_torch.kernels.dispatch",
    "select_blocks": "repro_torch.kernels.dispatch",
    "PreparedOperand": "repro_torch.kernels.prepared",
    "prepare_params": "repro_torch.kernels.prepared",
    "prepare_rhs": "repro_torch.kernels.prepared",
}


def __getattr__(name):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.kernels' has no attribute "
                             f"{name!r}") from None
    import importlib
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value     # cache for later lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
