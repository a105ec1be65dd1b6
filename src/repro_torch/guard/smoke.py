"""Fault-injection smoke check: ``python -m repro_torch.guard.smoke``
(``repro.guard.smoke``).

Proves the guard closes its loop end to end, outside pytest: corrupt a
decomposition with ``guard.inject``, assert the a posteriori verifier
trips, the escalation ladder recovers within one retry (the injected
fault is one-shot, so the first rung re-decomposes clean), the recovered
result is bit-identical to the uncorrupted reference, and
``guard.stats()`` reports the whole story.

It runs on the card unless ``--device cpu`` is given. The configs pin
``+xla``: the 'torch' backend's plain version, where the injection hooks
live (the CUDA kernels carve inside a launch). Integer-valued operands
make every Ozaki configuration exact, so "recovered" is checkable as
bit-identity rather than allclose.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def run(m: int = 64, n: int = 48, k: int = 96, seed: int = 0,
        device="cuda") -> int:
    from repro_torch import guard
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # Small integers: exactly representable, exactly emulated at any p —
    # the recovered result must match the uncorrupted one bit for bit.
    a = torch.as_tensor(rng.integers(-8, 9, (m, k)), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.integers(-8, 9, (k, n)), dtype=torch.float32,
                        device=dev)

    failures: list[str] = []

    def expect(cond: bool, what: str) -> None:
        print(("ok  " if cond else "FAIL") + " " + what)
        if not cond:
            failures.append(what)

    # Scheme II flips a bit in plane 1: plane 0's modulus is 256, and
    # integer operands scaled by a power of two have an identically-zero
    # residue plane there, so corrupting it is a mathematical no-op.
    for scheme, spec, plane in (("ozaki1", "ozaki1-p4+xla+guard", 0),
                                ("ozaki2", "ozaki2-m6+xla+guard", 1)):
        guard.stats_clear()
        reference = dispatch.emulated_matmul(
            a, b, cfg=spec.replace("+guard", ""))
        clean = dispatch.emulated_matmul(a, b, cfg=spec)
        s = guard.stats()
        expect(bool(torch.equal(clean, reference)),
               f"{scheme}: clean guarded result bit-identical")
        expect(s.verified == 1 and s.trips == 0,
               f"{scheme}: clean run verified without a trip ({s})")

        guard.stats_clear()
        with guard.inject("bitflip_slice", count=1, plane=plane) as fault:
            recovered = dispatch.emulated_matmul(a, b, cfg=spec)
        s = guard.stats()
        expect(fault.fired == 1, f"{scheme}: fault fired exactly once")
        expect(s.trips == 1, f"{scheme}: injected corruption tripped the "
                             f"verifier ({s})")
        expect(s.recoveries == 1 and s.escalations == 1,
               f"{scheme}: recovered within one retry ({s})")
        expect(s.native_fallbacks == 0,
               f"{scheme}: no native fallback needed ({s})")
        expect(bool(torch.equal(recovered, reference)),
               f"{scheme}: recovered result bit-identical to the "
               "uncorrupted reference")

    if failures:
        print(f"\nsmoke FAILED: {len(failures)} check(s)")
        return 1
    print(f"\nsmoke OK on {dev.type}: injected corruption detected and "
          "recovered within one retry on both schemes")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.guard.smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    sys.exit(main())
