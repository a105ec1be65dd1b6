"""repro_torch.guard — numerical guardrails and graceful degradation (the
port of the reference's guard package).

Emulated GEMMs that are *fast* but silently wrong are worse than slow
correct ones.  This subsystem gives every emulated call-site three safety
layers, armed by the ``+guard`` / ``+guard:strict`` precision-spec
suffixes:

* **special-value semantics** (``sentinel``) — NaN/Inf operand entries
  NaN the affected output rows/columns exactly as native ``torch.matmul``
  would, instead of truncating into finite garbage;
* **a posteriori verification** (``verify_gemm``) — a stochastic residual
  check of the finished result against the analytic error bound the
  configuration promised;
* **escalation ladder** (``ladder``) — tripped checks retry with more
  precision bits, then the reference expansion, then the native dot (or
  raise ``EmulationAccuracyError`` under ``:strict``), with every event
  counted in ``guard.stats()``.

``guard.inject`` corrupts slice/residue stacks under test so a check can
prove the verifier catches what it claims to.
"""

from repro_torch.core.precision import EmulationAccuracyError  # noqa: F401

from repro_torch.guard import inject as _inject_mod  # noqa: F401
from repro_torch.guard import ladder, policy, sentinel  # noqa: F401
from repro_torch.guard import verify as _verify_mod  # noqa: F401
from repro_torch.guard.inject import inject  # noqa: F401
from repro_torch.guard.ladder import guarded_call, guarded_dot_2d  # noqa: F401
from repro_torch.guard.ladder import guarded_matmul  # noqa: F401
from repro_torch.guard.policy import GuardPolicy, GuardStats  # noqa: F401
from repro_torch.guard.policy import stats, stats_clear  # noqa: F401
from repro_torch.guard.sentinel import probe_operands  # noqa: F401
from repro_torch.guard.verify import VerifyResult, verify_gemm  # noqa: F401

__all__ = [
    "EmulationAccuracyError",
    "GuardPolicy",
    "GuardStats",
    "VerifyResult",
    "guarded_call",
    "guarded_dot_2d",
    "guarded_matmul",
    "inject",
    "probe_operands",
    "stats",
    "stats_clear",
    "verify_gemm",
]
