"""Precision planning for Ozaki-scheme emulated GEMM.

This module owns the *numerical* side of the emulation configuration:

* ``safe_beta(K)``       — largest per-slice bit-width such that a K-long
  int8xint8 dot accumulates exactly in int32 (Scheme I).
* ``default_moduli(p)``  — pairwise-coprime moduli <= 256 (Scheme II).
* ``scheme2_budget``     — per-operand integer bit budget under the CRT
  exactness bound 2 * K * max|A'| * max|B'| < P.
* ``plan_precision``     — the Fig.-7 crossover automated: pick scheme + p
  for a target precision (the cuBLAS-ADP analogue the paper lacks).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Literal, Sequence

# Pairwise coprime moduli <= 256, descending. 256 = 2^8; 255 = 3*5*17;
# 253 = 11*23; 247 = 13*19; the rest are primes. Pairwise coprimality is
# asserted by tests/test_scheme2.py::test_moduli_coprime.
DEFAULT_MODULI: tuple[int, ...] = (
    256, 255, 253, 251, 247, 241, 239, 233, 229, 227, 223, 211, 199, 197, 193,
    191,
)

Scheme = Literal["native", "ozaki1", "ozaki2"]


class EmulationAccuracyError(ValueError):
    """An emulated GEMM cannot (or did not) meet its accuracy contract.

    Raised ahead of time when a configuration provably breaks exactness
    (e.g. ``scheme2.check_exact_k``'s int32 accumulator bound) and at
    runtime by the guard subsystem (``repro.guard``) when a verified
    result misses its error bound and the escalation ladder is exhausted
    (``+guard:strict``).  Subclasses ValueError so existing call-sites
    that caught the old bare ValueError keep working.
    """

# K the spec mini-language assumes when a ``bits=N`` spec names no ``:kK``
# suffix — plan_precision needs a contraction length to budget slices
# against, and 4096 is the model zoo's typical projection K.
DEFAULT_PLAN_K = 4096

# Largest slice/modulus count the planner searches (the moduli table
# bounds Scheme II exactly; Scheme I shares the cap so the planner never
# returns a slice count whose GEMM count is off the paper's Table II).
MAX_PLAN_P = 16


def safe_beta(k_dim: int, max_beta: int = 7) -> int:
    """Largest slice bit-width with exact int32 accumulation over ``k_dim``.

    Each product of two beta-bit signed slices is bounded by (2^beta - 1)^2;
    summing ``k_dim`` of them must stay below 2^31.
    """
    if k_dim <= 0:
        raise ValueError(f"k_dim must be positive, got {k_dim}")
    beta = int((31 - math.ceil(math.log2(k_dim))) // 2)
    return max(1, min(max_beta, beta))


def default_moduli(p: int) -> tuple[int, ...]:
    if not 1 <= p <= len(DEFAULT_MODULI):
        raise ValueError(f"p={p} out of range [1, {len(DEFAULT_MODULI)}]")
    return DEFAULT_MODULI[:p]


def scheme2_budget(moduli: Sequence[int], k_dim: int,
                   complex_guard: bool = False) -> int:
    """Per-operand magnitude bit budget for exact CRT reconstruction.

    Bound: 2 * K * 2^bits_a * 2^bits_b < P  (one extra bit for the signed
    range mapping; one more for 3M complex where C_im sums two products).
    """
    log2_p_prod = sum(math.log2(m) for m in moduli)
    guard = 2 + (1 if complex_guard else 0)
    total = int(log2_p_prod - guard - math.ceil(math.log2(max(2, k_dim))))
    per_operand = total // 2
    # float64 can only represent integers exactly up to 2^53; trunc happens
    # in float, so cap the budget there.
    return max(1, min(per_operand, 52))


def scheme1_bits(p: int, beta: int) -> int:
    """Approximate relative precision (bits) delivered by Scheme I."""
    return p * beta


def scheme2_bits(moduli: Sequence[int], k_dim: int) -> int:
    """Approximate relative precision (bits) delivered by Scheme II."""
    return scheme2_budget(moduli, k_dim)


@dataclasses.dataclass(frozen=True)
class EmulationConfig:
    """Configuration of one emulated GEMM call-site.

    Attributes:
      scheme:  'native' (plain dot), 'ozaki1' (mantissa slicing),
               'ozaki2' (CRT modular).
      p:       slice count (Scheme I) / modulus count (Scheme II).
      beta:    Scheme-I per-slice bit-width; None = derive via safe_beta(K).
      moduli:  Scheme-II moduli; None = default_moduli(p).
      impl:    'xla' (jnp reference path), 'pallas' (fused TPU kernel),
               'auto' (pallas where available, else xla).
      fused:   if False, force the naive (unfused, materializing) path —
               used by benchmarks to reproduce the paper's baselines.
      out_dtype: output dtype; None = result dtype of the inputs.
      decomp:  where Scheme-I decomposition runs on the fused path:
               'kernel' slices the fp32 tile in VMEM (the in-kernel
               prologue — no (M, p*K) HBM intermediate), 'xla' keeps the
               historical split -> interleave -> kernel pipeline, 'auto'
               prefers the prologue.
      cache_weights: training flag — the custom VJP prepares the rhs
               operand once per step (forward layout + K-transposed
               twin for dA) instead of re-encoding it in forward, remat
               re-forward, and backward: Scheme I caches int8 mantissa
               slices, Scheme II balanced int8 residues (see
               repro.kernels.prepared).
      backend: kernel-backend name from the registry in
               repro.kernels.backends ('tpu' | 'gpu' | 'xla' | an
               out-of-tree registration); None = platform default.  The
               ``REPRO_BACKEND`` environment variable overrides this at
               dispatch time.
      guard:   numerical guardrails (repro.guard): None = off, 'on' =
               special-value masking + a posteriori verification with
               the escalation ladder (retry with more bits, then
               fused->xla->native), 'strict' = same but an exhausted
               ladder raises EmulationAccuracyError instead of falling
               back to native.  Spec suffixes '+guard' / '+guard:strict'.
    """
    scheme: Scheme = "native"
    p: int = 4
    beta: int | None = None
    moduli: tuple[int, ...] | None = None
    impl: Literal["auto", "xla", "pallas"] = "auto"
    fused: bool = True
    out_dtype: str | None = None
    # Mixed-precision emulated training (beyond-paper): gradients tolerate
    # fewer slices than the forward pass; 0 = same as forward.
    bwd_p: int = 0
    decomp: Literal["auto", "xla", "kernel"] = "auto"
    cache_weights: bool = False
    backend: str | None = None
    guard: Literal["on", "strict"] | None = None

    def resolved_beta(self, k_dim: int) -> int:
        return self.beta if self.beta is not None else safe_beta(k_dim)

    def resolved_moduli(self) -> tuple[int, ...]:
        return self.moduli if self.moduli is not None else default_moduli(self.p)

    def bits(self, k_dim: int) -> int:
        if self.scheme == "ozaki1":
            return scheme1_bits(self.p, self.resolved_beta(k_dim))
        if self.scheme == "ozaki2":
            return scheme2_bits(self.resolved_moduli(), k_dim)
        return 24  # native fp32 mantissa

    def gemm_count(self) -> int:
        """Paper Table II: number of int8 GEMMs issued."""
        if self.scheme == "ozaki1":
            return self.p * (self.p + 1) // 2
        if self.scheme == "ozaki2":
            return self.p
        return 1

    # -- the precision-spec mini-language (see docs/api.md) -----------------
    #
    #   spec   := base suffix*
    #   base   := "native" | "ozaki1-p" INT | "ozaki2-m" INT
    #           | "bits=" INT [":k" INT]        (routes via plan_precision)
    #   suffix := "@" BACKEND                   (kernel-backend name)
    #           | "+cached"                     (per-step weight cache:
    #                                            slices / residues)
    #           | "+xla" | "+pallas"            (pin impl; default 'auto')
    #           | "+guard" | "+guard:strict"    (numerical guardrails,
    #                                            see docs/robustness.md)
    #
    # ``ozaki2-m6`` pins ``moduli=default_moduli(6)`` so parse/to_spec
    # round-trips survive plan_precision's explicit moduli. ``ozaki2-p6``
    # is accepted as a legacy alias and canonicalized to ``-m``.

    _SPEC_RE = re.compile(r"(?P<base>[^@+\s]+)(?P<suffixes>(?:[@+][^@+\s]+)*)")

    @classmethod
    def parse(cls, spec: "str | EmulationConfig") -> "EmulationConfig":
        """Parse a precision-spec string into an EmulationConfig.

        An EmulationConfig passes through unchanged, so call-sites can
        accept either form. Raises ValueError with the offending token
        for anything outside the grammar.
        """
        if isinstance(spec, cls):
            return spec
        if not isinstance(spec, str):
            raise TypeError(f"precision spec must be a str or "
                            f"EmulationConfig, got {type(spec).__name__}")
        m = cls._SPEC_RE.fullmatch(spec.strip())
        if m is None:
            raise ValueError(f"bad precision spec {spec!r}")
        base = m.group("base")
        backend: str | None = None
        cached = False
        impl = "auto"
        guard: str | None = None
        for tok in re.findall(r"[@+][^@+]+", m.group("suffixes")):
            if tok[0] == "@":
                if backend is not None:
                    raise ValueError(f"duplicate '@backend' in {spec!r}")
                backend = tok[1:]
            elif tok[1:] == "cached":
                cached = True
            elif tok[1:] in ("xla", "pallas"):
                impl = tok[1:]
            elif tok[1:] == "guard":
                guard = "on"
            elif tok[1:] == "guard:strict":
                guard = "strict"
            else:
                raise ValueError(
                    f"unknown suffix {tok!r} in {spec!r} (expected "
                    "'@<backend>', '+cached', '+xla', '+pallas', "
                    "'+guard' or '+guard:strict')")

        if base == "native":
            cfg = cls(scheme="native", impl=impl, backend=backend)
        elif base.startswith("bits="):
            bm = re.fullmatch(r"bits=(\d+)(?::k(\d+))?", base)
            if bm is None:
                raise ValueError(f"bad 'bits=' base in {spec!r} (expected "
                                 "'bits=<N>' or 'bits=<N>:k<K>')")
            planned = plan_precision(int(bm.group(1)),
                                     int(bm.group(2) or DEFAULT_PLAN_K))
            cfg = dataclasses.replace(planned, impl=impl, backend=backend)
        else:
            sm = re.fullmatch(r"(ozaki[12])-([pm])(\d+)", base)
            if sm is None:
                raise ValueError(
                    f"bad precision spec {spec!r}: base must be 'native', "
                    "'ozaki1-p<N>', 'ozaki2-m<N>' or 'bits=<N>[:k<K>]'")
            scheme, kind, num = sm.group(1), sm.group(2), int(sm.group(3))
            if scheme == "ozaki1" and kind != "p":
                raise ValueError(f"{spec!r}: ozaki1 counts slices with "
                                 "'-p<N>'")
            if num < 1:
                raise ValueError(f"{spec!r}: count must be >= 1")
            if scheme == "ozaki2":
                # -m pins the moduli so the config round-trips to_spec.
                cfg = cls(scheme="ozaki2", p=num, moduli=default_moduli(num),
                          impl=impl, backend=backend)
            else:
                cfg = cls(scheme="ozaki1", p=num, impl=impl, backend=backend)
        if cached:
            if cfg.scheme == "native":
                raise ValueError(f"{spec!r}: '+cached' needs an emulation "
                                 "scheme (ozaki1 caches int8 slices, "
                                 "ozaki2 balanced residues)")
            cfg = dataclasses.replace(cfg, cache_weights=True)
        if guard is not None:
            if cfg.scheme == "native":
                raise ValueError(f"{spec!r}: '+guard' needs an emulation "
                                 "scheme (native dots have nothing to "
                                 "verify against)")
            cfg = dataclasses.replace(cfg, guard=guard)
        return cfg

    def to_spec(self) -> str:
        """Print this config as a canonical spec string.

        Inverse of :meth:`parse` on its image: ``parse(cfg.to_spec()) ==
        cfg`` for every config parse can produce. Configs carrying fields
        the grammar cannot express (explicit beta, custom moduli,
        out_dtype, bwd_p, decomp, fused=False) raise ValueError naming
        the field.
        """
        blockers = []
        if self.beta is not None:
            blockers.append("beta")
        if self.out_dtype is not None:
            blockers.append("out_dtype")
        if self.bwd_p:
            blockers.append("bwd_p")
        if not self.fused:
            blockers.append("fused")
        if self.decomp != "auto":
            blockers.append("decomp")
        if self.moduli is not None and (
                self.scheme != "ozaki2"
                or tuple(self.moduli) != default_moduli(self.p)):
            blockers.append("moduli")
        if self.cache_weights and self.scheme == "native":
            blockers.append("cache_weights")
        if self.guard is not None and self.scheme == "native":
            blockers.append("guard")
        if blockers:
            raise ValueError(
                f"config not expressible as a spec (non-default "
                f"{', '.join(blockers)}): {self!r}")
        if self.scheme == "native":
            base = "native"
        elif self.scheme == "ozaki1":
            base = f"ozaki1-p{self.p}"
        else:
            base = f"ozaki2-m{self.p}"
        out = base
        if self.backend:
            out += f"@{self.backend}"
        if self.impl != "auto":
            out += f"+{self.impl}"
        if self.cache_weights:
            out += "+cached"
        if self.guard == "on":
            out += "+guard"
        elif self.guard == "strict":
            out += "+guard:strict"
        return out


NATIVE = EmulationConfig(scheme="native")


def plan_precision(target_bits: int, k_dim: int,
                   prefer: Scheme | None = None) -> EmulationConfig:
    """Pick the cheaper scheme for ``target_bits`` of relative precision.

    Implements the paper's Fig.-7 crossover: Scheme I wins below ~FP32
    precision (its GEMM count grows quadratically), Scheme II above.

    ``prefer`` pins the scheme instead of cost-comparing; a preferred
    scheme that cannot reach ``target_bits`` raises (naming the maximum
    it can deliver at this K) rather than silently handing the choice
    back to the cost comparison. Returned ozaki2 configs pin ``moduli``
    explicitly so they survive a ``to_spec``/``parse`` round-trip.
    """
    if prefer not in (None, "ozaki1", "ozaki2"):
        raise ValueError(f"prefer must be 'ozaki1' or 'ozaki2', "
                         f"got {prefer!r}")
    beta = safe_beta(k_dim)
    p1 = max(1, math.ceil(target_bits / beta))
    max1 = MAX_PLAN_P * beta
    # Smallest Scheme-II modulus count that meets the target.
    p2 = None
    for p in range(2, len(DEFAULT_MODULI) + 1):
        if scheme2_bits(default_moduli(p), k_dim) >= target_bits:
            p2 = p
            break
    max2 = scheme2_bits(DEFAULT_MODULI, k_dim)
    cost1 = p1 * (p1 + 1) / 2 if p1 <= MAX_PLAN_P else math.inf
    # Scheme II pays residue generation + CRT reconstruction on top of its p
    # GEMMs; empirically ~25% per-GEMM overhead (paper Fig. 7 crossover).
    cost2 = 1.25 * p2 if p2 is not None else math.inf

    def scheme1_cfg():
        return EmulationConfig(scheme="ozaki1", p=p1)

    def scheme2_cfg():
        return EmulationConfig(scheme="ozaki2", p=p2,
                               moduli=default_moduli(p2))

    if prefer == "ozaki1":
        if cost1 == math.inf:
            raise ValueError(
                f"prefer='ozaki1' cannot reach target_bits={target_bits} "
                f"at K={k_dim}: p<={MAX_PLAN_P} slices of beta={beta} bits "
                f"deliver at most {max1} bits")
        return scheme1_cfg()
    if prefer == "ozaki2":
        if cost2 == math.inf:
            raise ValueError(
                f"prefer='ozaki2' cannot reach target_bits={target_bits} "
                f"at K={k_dim}: the full {len(DEFAULT_MODULI)}-modulus "
                f"table delivers at most {max2} bits")
        return scheme2_cfg()
    if cost1 == math.inf and cost2 == math.inf:
        raise ValueError(
            f"target_bits={target_bits} unreachable at K={k_dim} "
            f"(scheme1 max {max1}, scheme2 max {max2})")
    if cost1 <= cost2:
        return scheme1_cfg()
    return scheme2_cfg()
