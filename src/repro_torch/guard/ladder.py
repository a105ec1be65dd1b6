"""The guard escalation ladder: sanitize -> run -> verify -> escalate
(``repro.guard.ladder``).

``guarded_call`` wraps one unguarded 2-D GEMM runner with the full guard
pipeline:

  0. probe operands (NaN/Inf lanes, exponent spread) and sanitize the
     non-finite entries so the integer pipelines see finite data;
  1. run the requested config and verify the result a posteriori
     (``guard.verify``);
  2. on a tripped check, climb the ladder: re-plan with more precision
     bits (plan_precision, same scheme preferred), then pin the reference
     expansion (impl 'xla': the 'torch' backend's plain version),
     re-verifying each rung;
  3. an exhausted ladder falls back to the native dot ('on' mode, with a
     one-shot RuntimeWarning through the dispatcher's fallback machinery)
     or raises EmulationAccuracyError ('strict');
  4. finally restore native special-value semantics by NaN-masking the
     output lanes a non-finite operand entry contaminated.

The reference climbs the ladder when it runs eagerly and, under tracing
(jit, grad, vmap), only sanitizes, verifies, masks and counts. The port
has no tracing, so it chooses per call: a 2-D call takes the eager ladder
(``guarded_call``), and a guarded batched call — which the reference runs
as a vmap of the 2-D dispatch, i.e. traced — takes the traced semantics
(``guarded_batched_call``): it sanitizes, runs the guard-stripped
batched dispatch once (the batched kernel, which computes the same
function as the 2-D one element by element), then verifies, masks and
counts ``calls`` / ``verified`` / ``trips`` / ``masked`` per element,
with no ladder and no raise. As under the reference's vmap, the
element's probes, verifications and masks run batched, one set of ops
for the whole stack, and the exponent spread, which only the eager ladder
reads (XLA drops it from the traced program), is not computed there. The
runtime layers (the Trainer, the serve engines) poll ``guard.stats()``
between steps and own the retry there.

Every host read of a device value (a verdict, the masked flag, the
exponent spread) synchronizes with the card; :data:`SYNCS` counts them:
three per eager call, one per batched call (the reference's one debug
callback).

On a mesh every rank guards its own tile of each product, and the
runtime layers act on each process's own counters and exceptions. So
the ranks agree on every eager verdict (:func:`consensus`, which the
step functions of a live mesh enter): a check passes only where it
passes on every rank, and every rank climbs the same rungs, counts the
same trips and escalations and raises at the same call, where the
reference's one program has one verdict.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.precision import (EmulationAccuracyError,
                                        EmulationConfig, plan_precision)
from repro_torch.guard import policy as policy_mod
from repro_torch.guard import sentinel
from repro_torch.guard import verify as verify_mod

GuardPolicy = policy_mod.GuardPolicy


@dataclasses.dataclass
class SyncCount:
    """Host reads of device values made by guarded calls."""
    n: int = 0

    def reset(self) -> None:
        self.n = 0


SYNCS = SyncCount()


def _host(x: torch.Tensor):
    """One device value on the host: a sync, counted."""
    SYNCS.n += 1
    return x.item()


# The meshes whose ranks agree on each verdict (:func:`consensus`); the
# outermost decides.
_CONSENSUS: list = []


@contextlib.contextmanager
def consensus(mesh):
    """Within it, every eager verdict of :func:`guarded_call` is that of
    all of ``mesh``'s ranks: a failed check on one fails it on all (a sum
    of the failures over the mesh), so that the ranks, which run the same
    sequence of guarded calls, take the same path through the ladder. A
    no-op without a live mesh of several ranks, and inside another
    consensus (the outer, wider one holds). Every rank enters it at the
    same point of its program."""
    from repro_torch.launch import mesh as mesh_mod
    if isinstance(mesh, mesh_mod.RowsLocal):
        mesh = mesh.mesh
    if (_CONSENSUS or not mesh_mod.is_live(mesh)
            or mesh_mod.axis_sizes(mesh) == {}
            or max(mesh_mod.axis_sizes(mesh).values()) == 1):
        yield
        return
    _CONSENSUS.append(mesh)
    try:
        yield
    finally:
        _CONSENSUS.pop()


def mesh_max(counts: list[int], mesh) -> list[int]:
    """``counts`` at their largest over the ranks of a live ``mesh``
    (every rank calls it), reduced on the host under gloo and on the
    rank's card under NCCL; as they are without a live mesh."""
    from repro_torch.launch import mesh as mesh_mod
    if not mesh_mod.is_live(mesh):
        return list(counts)
    import torch.distributed as dist
    group = mesh_mod.axis_group(mesh, tuple(mesh_mod.axis_sizes(mesh)))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor(counts, dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def _agree(ok: torch.Tensor) -> bool:
    """A verdict on the host: this rank's, or under :func:`consensus`
    that of every rank of the mesh."""
    ok = bool(_host(ok))
    if _CONSENSUS:
        ok = not mesh_max([int(not ok)], _CONSENSUS[0])[0]
    return ok


def strip_guard(cfg: EmulationConfig) -> EmulationConfig:
    """The same config with the guard disarmed — what the ladder hands
    to the unguarded runners (prevents recursive guarding)."""
    if cfg.guard is None:
        return cfg
    return dataclasses.replace(cfg, guard=None)


def escalated_config(base: EmulationConfig, k_dim: int,
                     extra_bits: int) -> EmulationConfig | None:
    """First ladder rung: re-plan for ``extra_bits`` more precision bits
    at this contraction length, keeping the scheme when it can deliver.
    None when even the cross-scheme planner cannot reach the target."""
    target = base.bits(k_dim) + extra_bits
    prefer = base.scheme if base.scheme in ("ozaki1", "ozaki2") else None
    try:
        planned = plan_precision(target, k_dim, prefer=prefer)
    except ValueError:
        try:
            planned = plan_precision(target, k_dim)
        except ValueError:
            return None
    return dataclasses.replace(
        planned, impl=base.impl, backend=base.backend,
        out_dtype=base.out_dtype, fused=base.fused, decomp=base.decomp)


def _warn_guard(reason: tuple, shapes: tuple, message: str) -> None:
    from repro_torch.kernels import dispatch
    dispatch._warn_fallback_once(("guard",) + reason, shapes, message,
                                 stacklevel=4)


def guarded_call(a: torch.Tensor, b, cfg: EmulationConfig, run,
                 probe: "sentinel.SentinelProbe | None" = None
                 ) -> torch.Tensor:
    """Run one (M, K) @ (K, N) emulated GEMM under the guard pipeline,
    with the full ladder.

    ``run(a, b, cfg)`` is the unguarded runner (it receives sanitized
    operands and guard-stripped configs, including the escalation rungs'
    re-planned configs).  ``b`` may be a prepared operand — the re-plan
    rung is then skipped (its slice/modulus count is pinned at prepare
    time) and the ladder goes straight to the reference expansion.
    ``probe`` is an already-computed sentinel probe (e.g. off a
    ``dispatch.plan_emulated(..., probe=True)`` plan); None computes it
    here.
    """
    guard_policy = GuardPolicy.from_config(cfg)
    assert guard_policy is not None, "guarded_call needs cfg.guard set"
    base = strip_guard(cfg)
    prepared = hasattr(b, "reconstruct")
    b_dense = b.reconstruct() if prepared else b
    if probe is None:
        probe = sentinel.probe_operands(a, b_dense)
    a_s = sentinel.sanitize(a)
    b_s = b if prepared else sentinel.sanitize(b_dense)
    k_dim = a.shape[-1]

    def check(c, rung_cfg):
        return verify_mod.verify_gemm(
            a_s, b_s if not prepared else b_dense, c, rung_cfg,
            probes=guard_policy.probes, tol_factor=guard_policy.tol_factor,
            row_mask=probe.row_mask, col_mask=probe.col_mask)

    c0 = run(a_s, b_s, base)
    policy_mod.record("calls")
    if _host(probe.any_nonfinite()):
        policy_mod.record("masked")
    bits = base.bits(k_dim)
    spread = _host(torch.maximum(probe.spread_a, probe.spread_b))
    if spread > bits:
        _warn_guard(
            ("spread", base.scheme, base.p),
            (tuple(a.shape), tuple(b_dense.shape)),
            f"guard: operand exponent spread ~{spread:.0f} bits exceeds "
            f"the {bits}-bit budget of {base.scheme}-p{base.p}; small "
            "entries fall below the power-of-two row scale (expect a "
            "verification trip or request more bits via a 'bits=' spec)")
    ver = check(c0, base)
    policy_mod.record("verified")
    if _agree(ver.ok):
        return sentinel.apply_special_values(c0, probe)

    policy_mod.record("trips")
    rungs: list[EmulationConfig] = []
    if not prepared:
        esc = escalated_config(base, k_dim, guard_policy.escalate_bits)
        if esc is not None:
            rungs.append(esc)
        rungs.append(dataclasses.replace(esc or base, impl="xla"))
    else:
        # Slice/modulus counts are pinned in the prepared stack; the only
        # re-runnable rung is the reference expansion.
        rungs.append(dataclasses.replace(base, impl="xla"))
    for rung_cfg in rungs:
        policy_mod.record("escalations")
        c = run(a_s, b_s, rung_cfg)
        ver = check(c, rung_cfg)
        policy_mod.record("verified")
        if _agree(ver.ok):
            policy_mod.record("recoveries")
            return sentinel.apply_special_values(c, probe)

    if guard_policy.strict:
        tried = [f"{r.scheme}-p{r.p}+{r.impl}" for r in rungs]
        raise EmulationAccuracyError(
            f"guarded emulated GEMM {tuple(a.shape)} @ "
            f"{tuple(b_dense.shape)} missed its error bound (residual "
            f"{float(ver.err):.3g} > tol {ver.tol:.3g}) and the escalation "
            f"ladder is exhausted (tried {tried}); strict mode refuses the "
            "native fallback — inspect the operands (guard.stats(), "
            "repro_torch.guard.sentinel) or raise the precision budget")
    policy_mod.record("native_fallbacks")
    _warn_guard(
        ("native_fallback", base.scheme, base.p),
        (tuple(a.shape), tuple(b_dense.shape)),
        f"guard: emulated GEMM missed its error bound (residual "
        f"{float(ver.err):.3g} > tol {ver.tol:.3g}) after "
        f"{len(rungs)} escalation(s); falling back to the native dot "
        "for this call ('+guard:strict' raises instead)")
    c_native = (a_s.to(torch.float32) @ b_dense.to(torch.float32)).to(c0.dtype)
    return sentinel.apply_special_values(c_native, probe)


def guarded_batched_call(a: torch.Tensor, b: torch.Tensor,
                         cfg: EmulationConfig, run) -> torch.Tensor:
    """A guarded (Bt, M, K) @ (Bt, K, N) under the reference's traced
    guard semantics: sanitize, ``run(a, b, cfg)`` once (the unguarded
    batched runner, with the guard stripped), verify each element,
    NaN-mask and count Bt ``calls`` and ``verified``, a ``trips`` per
    element that missed its bound and a ``masked`` per element with a
    non-finite lane, with one host read; no ladder and no raise,
    whatever the mode."""
    guard_policy = GuardPolicy.from_config(cfg)
    assert guard_policy is not None, "guarded_batched_call needs cfg.guard"
    base = strip_guard(cfg)
    row_mask = ~torch.all(torch.isfinite(a), dim=-1)       # (Bt, M)
    col_mask = ~torch.all(torch.isfinite(b), dim=-2)       # (Bt, N)
    a_s, b_s = sentinel.sanitize(a), sentinel.sanitize(b)
    c = run(a_s, b_s, base)
    ver = verify_mod.verify_batched(
        a_s, b_s, c, base, probes=guard_policy.probes,
        tol_factor=guard_policy.tol_factor, row_mask=row_mask,
        col_mask=col_mask)
    masked_any = torch.any(row_mask, dim=-1) | torch.any(col_mask, dim=-1)
    SYNCS.n += 1
    trips, masked = torch.stack([(~ver.ok).sum(), masked_any.sum()]).tolist()
    if _CONSENSUS:                      # every rank counts the same
        trips, masked = mesh_max([trips, masked], _CONSENSUS[0])
    n = a.shape[0]
    policy_mod.record("calls", n)
    policy_mod.record("verified", n)
    if trips:
        policy_mod.record("trips", trips)
    if masked:
        policy_mod.record("masked", masked)
    mask = row_mask[:, :, None] | col_mask[:, None, :]
    return torch.where(mask, torch.full((), torch.nan, dtype=c.dtype,
                                        device=c.device), c)


def _dispatch_runner(out_dtype, backend, mesh_shape=None):
    from repro_torch.kernels import dispatch

    def run(aa, bb, rung_cfg):
        # A rung pinned to the reference expansion runs the 'torch'
        # backend's plain version, as core.emulated._dot_2d routes it.
        be = "torch" if rung_cfg.impl == "xla" else backend
        return dispatch.emulated_matmul(aa, bb, cfg=rung_cfg,
                                        out_dtype=out_dtype, backend=be,
                                        mesh_shape=mesh_shape)
    return run


def guarded_matmul(a: torch.Tensor, b, cfg: EmulationConfig, *,
                   out_dtype=None, backend: str | None = None,
                   mesh_shape: tuple | None = None) -> torch.Tensor:
    """The dispatch-level guard seam: ``dispatch.emulated_matmul`` routes
    here when ``cfg.guard`` is set, and every rung routes back through
    ``emulated_matmul`` with the guard stripped. ``mesh_shape`` marks
    (a, b) as a rank's tiles of a partitioned GEMM: every rung carries it
    (the block cache and the labels key on it), and each rank verifies
    its own tile."""
    from repro_torch.kernels import dispatch
    probe = None
    if not hasattr(b, "reconstruct"):
        probe = dispatch.plan_emulated(a, b, strip_guard(cfg), out_dtype,
                                       backend, mesh_shape=mesh_shape,
                                       probe=True).probe
    return guarded_call(a, b, cfg,
                        _dispatch_runner(out_dtype, backend, mesh_shape),
                        probe=probe)


def guarded_matmul_batched(a: torch.Tensor, b: torch.Tensor,
                           cfg: EmulationConfig, *, out_dtype=None,
                           backend: str | None = None) -> torch.Tensor:
    """A guarded (B, M, K) @ (B, K, N) under the traced semantics: one
    unguarded ``emulated_matmul_batched``, each element verified, masked
    and counted, as the reference's vmap of the 2-D dispatch runs it."""
    from repro_torch.kernels import dispatch

    def run(aa, bb, base):
        return dispatch.emulated_matmul_batched(aa, bb, cfg=base,
                                                out_dtype=out_dtype,
                                                backend=backend)
    return guarded_batched_call(a, b, cfg, run)


def guarded_dot_2d(a: torch.Tensor, b: torch.Tensor,
                   cfg: EmulationConfig) -> torch.Tensor:
    """The core-level guard seam: ``repro_torch.core.emulated._dot_2d``
    (the 2-D engine under dot_general/einsum/dense and both backward
    GEMMs) routes here when ``cfg.guard`` is set."""
    from repro_torch.core import emulated

    def run(aa, bb, rung_cfg):
        return emulated._dot_2d(aa, bb, rung_cfg)

    return guarded_call(a, b, cfg, run)
