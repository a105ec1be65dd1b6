"""Numerical fault injection for the guard subsystem
(``repro.guard.inject``).

A verifier that never trips is indistinguishable from one that cannot
trip.  ``inject(...)`` arms a thread-local fault that corrupts the next
Scheme-I slice stack or Scheme-II residue stack *as it is produced*
(hooks live in ``scheme1.carve_stack`` — the decomposition of
``scheme1.split`` and of the EmuGEMM-I plain versions — and in
``scheme2.balanced_residues``), so the corruption rides the real
decomposition path into the GEMM exactly like a hardware bit flip in the
encoded operand would.

Faults are one-shot by default (``count=1``): the first decomposition is
corrupted, every retry re-decomposes clean — which is what lets the smoke
check assert "detected and recovered within one retry".

The hooks fire only where the decomposition runs in tensor ops: the
'torch' backend (``+xla`` configs) and the plain versions.  The CUDA
kernels carve slices and residues inside a launch, so injection tests
pin ``+xla``.

Kinds:
  * ``"bitflip_slice"``  — XOR bit ``bit`` into one entry of the int8
    slice/residue stack (a classic SDC single-bit flip).
  * ``"zero_modulus"``   — zero an entire plane of the stack: for Scheme
    II this drops one modulus from the CRT; for Scheme I it drops one
    mantissa slice.
"""

from __future__ import annotations

import contextlib
import threading

import torch

KINDS = ("bitflip_slice", "zero_modulus")

_tls = threading.local()


def _active():
    return getattr(_tls, "fault", None)


class _Fault:
    def __init__(self, kind: str, count: int, bit: int, plane: int,
                 operand: str):
        self.kind = kind
        self.remaining = count
        self.bit = bit
        self.plane = plane
        self.operand = operand  # 'a' | 'b' | 'any'
        self.fired = 0
        self._call_parity = 0

    def _claims(self) -> bool:
        """Whether this hook invocation should corrupt.

        ``operand`` targeting relies on call order inside one GEMM: the
        decompositions run a first, then b — parity 0 is 'a', parity 1
        is 'b'.  'any' corrupts the first invocation.
        """
        if self.remaining <= 0:
            return False
        parity = self._call_parity
        self._call_parity ^= 1
        if self.operand == "any":
            return True
        return parity == (0 if self.operand == "a" else 1)


@contextlib.contextmanager
def inject(kind: str, *, count: int = 1, bit: int = 6, plane: int = 0,
           operand: str = "any"):
    """Arm a one-shot (by default) numerical fault for this thread.

    Args:
      kind: one of ``KINDS``.
      count: how many stacks to corrupt before the fault disarms
        (default 1 — the retry after a guard trip runs clean).
      bit: which bit to flip for ``bitflip_slice`` (6 flips a
        high-magnitude bit so the corruption is far outside rounding).
      plane: which slice/modulus plane to target.
      operand: 'a', 'b', or 'any' — which operand's stack to corrupt.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} (expected one "
                         f"of {KINDS})")
    if operand not in ("a", "b", "any"):
        raise ValueError(f"operand must be 'a', 'b' or 'any', "
                         f"got {operand!r}")
    if not 0 <= bit <= 6:
        raise ValueError(f"bit must be in [0, 6] for signed int8 stacks, "
                         f"got {bit}")
    prev = _active()
    fault = _Fault(kind, count, bit, plane, operand)
    _tls.fault = fault
    try:
        yield fault
    finally:
        _tls.fault = prev


def _corrupt(stack: torch.Tensor, fault: _Fault) -> torch.Tensor:
    plane = min(fault.plane, stack.shape[0] - 1)
    out = stack.clone()
    if fault.kind == "zero_modulus":
        out[plane] = 0
        return out
    # bitflip_slice: XOR one bit into the first entry of the plane.
    flat = out.reshape(stack.shape[0], -1)
    flat[plane, 0] ^= 1 << fault.bit
    return out


def maybe_corrupt_slices(slices: torch.Tensor) -> torch.Tensor:
    """Hook called on every freshly carved Scheme-I slice stack."""
    fault = _active()
    if fault is None or not fault._claims():
        return slices
    fault.remaining -= 1
    fault.fired += 1
    return _corrupt(slices, fault)


def maybe_corrupt_residues(residues: torch.Tensor) -> torch.Tensor:
    """Hook called by ``scheme2.balanced_residues``."""
    fault = _active()
    if fault is None or not fault._claims():
        return residues
    fault.remaining -= 1
    fault.fired += 1
    return _corrupt(residues, fault)
