"""Pre-decomposed rhs operands of the port (``repro.kernels.prepared``).

Training re-encodes the same weight in the forward, the remat re-forward
and the backward dA = dC B^T. A prepared operand holds the finished
encode instead, with ``twin``, the same weight prepared as the rhs of
B^T for dA:

* :class:`PreparedOperand` (Scheme I): the p int8 slices (p <= 16), the
  (1, N) power-of-two column scale (float32; float64 for a float64
  weight, whose slices are carved in float64), ``p``/``beta``, ``k``/``n`` (the
  logical dims), ``layout`` and ``backend``, the kernel backend that
  prepared it and consumes it. ``layout`` 'planes' (the 'cuda' backend)
  holds them as the (p, N, Kp) K-contiguous planes of B^T (K padded to
  ``ozaki1.PLANE_K`` with zero slices), written by one launch of the plane
  route's encode kernel (two with the twin, whose planes are those of B,
  (p_bwd, K, Np)) and consumed by EmuGEMM-I's plane route (one lhs encode
  and one plane GEMM, ``ozaki1.fused_matmul_mixed``). 'interleaved' (an
  ``impl='xla'`` config, or the 'torch' backend) holds them interleaved on
  K ((p * Kp, N), paper Eq. 11) at granularity ``blocks.bk``
  (``decompose.TILE``), written by the plain versions of the pair and rhs
  decompositions (K2, K2r) and consumed by the mixed form's plain version.
  ``stacked()`` reads either as the (p, Kp, N) slice stack.
* :class:`PreparedResidues` (Scheme II): the balanced int8 residues of
  the integerized weight, its (1, Np) power-of-two scale in the weight's
  type (N padded to 16) and the budget pinned at encode time. ``layout``
  'planes' (the 'cuda' backend) holds them as the (p, N, Kp) K-contiguous
  planes of B^T (K padded to ``ozaki2.PLANE_K`` with zero residues),
  written by one launch of the plane route's encode kernel and consumed
  by the plane route of EmuGEMM-II's prepared form (K5g with ``b_res``:
  one lhs encode and one plane GEMM). 'stacked' (an ``impl='xla'``
  config, or a backend other than 'cuda') holds the reference's
  (p, Kp, Np) stack, padded to 16 on K and N with zero residues, encoded
  in torch ops as the reference's is in XLA ops and consumed by the
  prepared form's plain version. ``stacked()`` reads either in the
  reference's layout.

:func:`prepare_rhs` builds either from a float (K, N) weight and
:func:`matmul_prepared` consumes either. Under gradient accumulation
:func:`build_step_preps` prepares every cacheable dense weight once per
optimizer step and :func:`attach_step_preps` pairs each with its float
weight (:class:`StepPrepared`), which ``models.common.dense`` sends
through ``core.emulated.emulated_dot_prepared``.

The 'planes' layouts are the port's (ROADMAP.md § 3): int8 wgmma reads
both of its shared-memory operands K-major only, so the weight is stored
as B^T. Unlike the reference, nothing is padded to 128 in Scheme I: the
prepared layouts round K (and N in the twin) up to their tile only,
with zero slices, and beta comes from the logical dims, which the
reference's padded dims agree with wherever ``safe_beta`` is 7 (every
dim up to 2^17; :func:`_beta` checks it). The reference's Scheme-I 'stacked'
layout of its XLA expansion has no counterpart: ``impl='xla'`` prepares
on the ``torch`` backend, the plain versions, in the same layout.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.core import scheme1, scheme2
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import backends, decompose, ozaki1, ozaki2
from repro_torch.kernels.backends.cuda import KERNEL_BLOCKS
from repro_torch.kernels.common import Blocks
from repro_torch.kernels.decompose import TILE, round_up
from repro_torch.telemetry import record as _tele


def _record_consume(scheme: str, count: int, backend: str, route: str,
                    reason: str, m: int, k: int, prep, in_bytes: int) -> None:
    """One prepared-consume route (the fused kernel, or the plain version
    on the 'torch' backend) and its GEMM, when telemetry is enabled;
    ``in_bytes`` is the lhs's element size."""
    if not telemetry.enabled():
        return
    telemetry.record_event(_tele.PREPARED_CONSUME, {
        "scheme": scheme, "route": route, "reason": reason})
    telemetry.record_gemm(
        scheme=scheme, count=count, backend=backend,
        impl="prepared-kernel" if route == "fused" else "prepared-torch",
        m=m, k=k, n=prep.n, in_bytes=in_bytes)

# The plane route's tiles, whose K tile is the planes' padding.
PLANE_BLOCKS = Blocks(bm=128, bn=ozaki1.PLANE_N, bk=ozaki1.PLANE_K)

_REF_ALIGN = 128     # the reference's Scheme-I prepared padding
ALIGN = 16           # the residue stack's padding (the reference's gpu.ALIGN)


@dataclasses.dataclass
class PreparedOperand:
    """A pre-split, pre-interleaved Scheme-I rhs operand (module doc)."""
    slices: torch.Tensor
    scale: torch.Tensor
    p: int
    beta: int
    blocks: Blocks
    layout: str
    k: int
    n: int
    twin: "PreparedOperand | None" = None
    backend: str = "cuda"

    # The tensor fields, which autograd saves (core.emulated).
    TENSORS = ("slices", "scale")

    def stacked(self) -> torch.Tensor:
        """The (p, Kp, N) slice stack, Kp = K rounded up to
        ``decompose.TILE``: the interleaved slices deinterleaved, or the
        planes transposed (a view)."""
        if self.layout == "planes":
            return self.slices.transpose(1, 2)[:, :round_up(self.k)]
        return scheme1.deinterleave_k(self.slices, self.p, "b",
                                      self.blocks.bk)

    def reconstruct(self) -> torch.Tensor:
        """The dense (k, n) float32 weight the slices represent, exact up
        to the decomposition residual (scale * 2^(-beta p) elementwise)."""
        st = self.stacked().float()
        w = torch.zeros(st.shape[1:], dtype=torch.float32,
                        device=st.device)
        for i in range(self.p):
            w = w + 2.0 ** (-self.beta * (i + 1)) * st[i]
        return (w * self.scale.float())[:self.k, :self.n]


@dataclasses.dataclass
class PreparedResidues:
    """A pre-encoded Scheme-II rhs operand (module doc): ``residues``
    (the (p, N, Kp) planes of B^T for layout 'planes', the (p, K16, N16)
    stack for 'stacked'), ``scale`` (1, N16) in the weight's type, the
    ``moduli``, the pinned ``budget_bits``, the logical ``k``/``n``,
    ``layout`` and ``twin``. Unlike a Scheme-I operand it has no block
    granularity."""
    residues: torch.Tensor
    scale: torch.Tensor
    moduli: tuple
    budget_bits: int
    k: int
    n: int
    layout: str = "planes"
    twin: "PreparedResidues | None" = None

    TENSORS = ("residues", "scale")

    @property
    def p(self) -> int:
        return len(self.moduli)

    @property
    def padded_k(self) -> int:
        return -(-self.k // ALIGN) * ALIGN

    @property
    def padded_n(self) -> int:
        return -(-self.n // ALIGN) * ALIGN

    def stacked(self) -> torch.Tensor:
        """The residues in the reference's (p, K16, N16) layout: the stack
        itself, or the planes transposed and padded (a copy)."""
        if self.layout == "stacked":
            return self.residues
        return F.pad(self.residues.transpose(1, 2)[:, :self.padded_k],
                     (0, self.padded_n - self.n))

    def reconstruct(self) -> torch.Tensor:
        """The dense (k, n) float32 weight the residues represent, exact up
        to the integerization truncation (1 / scale elementwise)."""
        res = scheme2.modular_reduce(self.stacked().to(torch.int32),
                                     self.moduli)
        w_int = scheme2.crt_reconstruct(res, self.moduli, torch.float32)
        return (w_int / self.scale.float())[:self.k, :self.n]


def split_tensors(prep):
    """(``prep`` with its tensor fields set to None, those tensors): the
    tensors go through autograd's ``save_for_backward``, so that
    activation checkpointing can drop them; the metadata stays."""
    return (dataclasses.replace(prep, **dict.fromkeys(prep.TENSORS)),
            tuple(getattr(prep, f) for f in prep.TENSORS))


def join_tensors(meta, tensors):
    """The inverse of :func:`split_tensors`."""
    return dataclasses.replace(meta, **dict(zip(meta.TENSORS, tensors)))


def _beta(cfg: EmulationConfig, dim: int) -> int:
    """beta for a prepared contraction of length ``dim``; the reference
    takes it from the dim padded to 128, which must give the same."""
    beta = cfg.resolved_beta(dim)
    padded = -(-dim // _REF_ALIGN) * _REF_ALIGN
    if cfg.resolved_beta(padded) != beta:
        raise NotImplementedError(
            f"beta differs between K={dim} ({beta}) and its 128-padded "
            f"{padded}; such a contraction is beyond safe_beta's 7-bit range")
    return beta


def _backend_name(cfg: EmulationConfig, device) -> str:
    if cfg.impl == "xla" or cfg.decomp == "xla":
        return "torch"
    return backends.resolve_backend_name(None, cfg, device)


def prepare_rhs(b: torch.Tensor, cfg: EmulationConfig, *,
                with_twin: bool = False):
    """Decompose a (K, N) float rhs once, for reuse across GEMMs: a
    :class:`PreparedOperand` under Scheme I, a :class:`PreparedResidues`
    under Scheme II (:func:`prepare_rhs_scheme2`).

    With ``with_twin`` the K-transposed layout for the backward dA GEMM
    comes too. Under Scheme I it comes from the same read of b (the pair
    kernel) when forward and backward share p, else from a second rhs
    decomposition of b.T at ``cfg.bwd_p`` (b.T is a strided view, never
    copied).
    """
    if cfg.scheme == "ozaki2":
        return prepare_rhs_scheme2(b, cfg, with_twin=with_twin)
    if isinstance(b, PreparedResidues):
        raise ValueError("got a PreparedResidues (Scheme-II) operand "
                         f"under scheme={cfg.scheme!r}; pass the float "
                         "weight instead")
    if isinstance(b, PreparedOperand):
        return b
    if cfg.scheme != "ozaki1":
        raise ValueError(f"prepare_rhs needs an emulated scheme, got "
                         f"{cfg.scheme!r}")
    if b.dim() != 2:
        raise ValueError(f"prepare_rhs is 2-D; got {tuple(b.shape)}")
    if b.is_complex():
        raise ValueError("prepare_rhs is real-valued; decompose the real "
                         "and imaginary parts separately (4M formulation)")
    if not b.is_floating_point():
        b = b.float()
    name = _backend_name(cfg, b.device)
    backends.get_backend(name).check(cfg, b, b)
    telemetry.record_event(_tele.PREPARED_BUILD, {
        "scheme": "ozaki1",
        "layout": "planes" if name == "cuda" else "interleaved"})
    k, n = b.shape
    p, beta = cfg.p, _beta(cfg, k)
    nu = scheme1.pow2_scale(b, -2)                              # (1, N)
    p_bwd, beta_bwd = cfg.bwd_p or p, _beta(cfg, n)
    tau = scheme1.pow2_scale(b, -1).T if with_twin else None    # (1, K)
    if name == "cuda":
        # The planes of B^T and, for the twin, of B: one encode each.
        layout, blocks = "planes", PLANE_BLOCKS
        hat = ozaki1.encode_planes(b.T, nu.T, p, beta)
        t_hat = (ozaki1.encode_planes(b, tau.T, p_bwd, beta_bwd)
                 if with_twin else None)
    else:
        # The plain versions of the pair and rhs decompositions (K2, K2r).
        layout, blocks = "interleaved", KERNEL_BLOCKS
        if with_twin and p_bwd == p:
            hat, t_hat = decompose.decompose_pair_plain(b, nu, tau, p, beta,
                                                        beta_bwd)
        else:
            hat = decompose.decompose_rhs_plain(b, nu, p, beta)
            t_hat = (decompose.decompose_rhs_plain(b.T, tau, p_bwd, beta_bwd)
                     if with_twin else None)
    twin = (PreparedOperand(t_hat, tau, p_bwd, beta_bwd, blocks, layout, n,
                            k, backend=name) if with_twin else None)
    return PreparedOperand(hat, nu, p, beta, blocks, layout, k, n, twin, name)


def _pad2(x: torch.Tensor, align: int) -> torch.Tensor:
    k, n = x.shape
    kp, np_ = -(-k // align) * align, -(-n // align) * align
    if (kp, np_) == (k, n):
        return x
    return F.pad(x, (0, np_ - n, 0, kp - k))


def _encode_residues(b: torch.Tensor, moduli, k_dim: int):
    """One Scheme-II rhs encode into the 'stacked' layout: the 16-aligned
    balanced residue stack, the power-of-two scale and the pinned budget.
    It mirrors ``scheme2.matmul``'s (integerize at the shared budget,
    capped by the weight type's mantissa, then ``balanced_residues``), so
    consumption is bit-identical to the unprepared product; padded rows
    and columns encode to zero residues, which add nothing mod any
    modulus."""
    b_pad = _pad2(b, ALIGN)
    budget = scheme2.budget_bits(moduli, k_dim, b.dtype)
    nu = scheme2._pow2_int_scale(b_pad, -2, budget)
    res = scheme2.balanced_residues(torch.trunc(b_pad * nu), moduli)
    return res, nu, budget


def _encode_planes(b: torch.Tensor, moduli, k_dim: int):
    """The same encode into the 'planes' layout: the scale and budget as
    :func:`_encode_residues`, the residues as the (p, N, Kp) planes of
    B^T, written by one launch of the plane route's encode kernel
    (``ozaki2.encode_planes``, which reads b.T through its strides; its
    plain version on a CPU tensor)."""
    budget = scheme2.budget_bits(moduli, k_dim, b.dtype)
    nu = scheme2._pow2_int_scale(_pad2(b, ALIGN), -2, budget)
    n = b.shape[1]
    planes = ozaki2.encode_planes(b.T, nu[:, :n].T, moduli)
    return planes, nu, budget


def prepare_rhs_scheme2(b: torch.Tensor, cfg: EmulationConfig, *,
                        with_twin: bool = False) -> PreparedResidues:
    """Encode a (K, N) float rhs's balanced Scheme-II residues once.

    ``with_twin`` also encodes B^T for the backward dA GEMM, a separate
    encode: its scale reduces over the other axis and its budget is set
    by its own contraction length N; a reduced ``cfg.bwd_p`` keeps the
    leading ``bwd_p`` moduli. The layout is pinned now: 'planes' when the
    config runs fused and the backend resolves to 'cuda', else 'stacked'.
    """
    if isinstance(b, PreparedResidues):
        return b
    if isinstance(b, PreparedOperand):
        raise ValueError("got a PreparedOperand (Scheme-I) operand under "
                         "scheme='ozaki2'; pass the float weight instead")
    if b.dim() != 2:
        raise ValueError(f"prepare_rhs is 2-D; got {tuple(b.shape)}")
    if b.is_complex():
        raise ValueError("prepare_rhs is real-valued; decompose the real "
                         "and imaginary parts separately (the complex 3M "
                         "path re-encodes per call)")
    b = scheme2.operand(b)
    k, n = b.shape
    moduli = tuple(int(m) for m in cfg.resolved_moduli())
    layout = "planes" if _backend_name(cfg, b.device) == "cuda" else "stacked"
    telemetry.record_event(_tele.PREPARED_BUILD,
                           {"scheme": "ozaki2", "layout": layout})
    encode = _encode_planes if layout == "planes" else _encode_residues
    res, nu, budget = encode(b, moduli, k)
    twin = None
    if with_twin:
        t_moduli = moduli[:cfg.bwd_p] if cfg.bwd_p else moduli
        t_res, tau, t_budget = encode(b.T, t_moduli, n)
        twin = PreparedResidues(t_res, tau, t_moduli, t_budget, n, k, layout)
    return PreparedResidues(res, nu, moduli, budget, k, n, layout, twin)


def matmul_prepared_scheme2(a: torch.Tensor, prep: PreparedResidues,
                            out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) float @ prepared Scheme-II residues (K, N) -> (M, N).

    The lhs integerizes in its own type at the prep's pinned budget,
    capped by its own mantissa, and is encoded once while the stored
    planes stream as they are ('planes'; the 'cuda' backend's plane
    route, which launches the kernels or raises); a 'stacked' prep runs
    the plain version on the 'torch' backend. Bit-identical to
    ``scheme2.matmul`` on the same operands whenever the lhs mantissa
    does not cap the budget below the encode-time one (any same-type
    pair).
    """
    m, k = a.shape
    if k != prep.k:
        raise ValueError(f"lhs K={k} vs prepared K={prep.k}")
    if a.is_complex():
        raise ValueError("matmul_prepared is real-valued; got complex lhs "
                         f"{a.dtype}")
    scheme2.check_exact_k(k, prep.moduli)
    a = scheme2.operand(a)
    budget = min(prep.budget_bits, scheme2.MANTISSA[a.dtype])
    mu = scheme2._pow2_int_scale(a, -1, budget)                # (M, 1)
    name = "cuda" if prep.layout == "planes" else "torch"
    route = "fused" if name == "cuda" else "torch"
    count = len(prep.moduli)
    _record_consume("ozaki2", count, name, route,
                    "-" if name == "cuda" else "stacked_layout", m, k, prep,
                    a.element_size())
    with telemetry.gemm_scope("ozaki2", count, name, "prepared-" + (
            "kernel" if name == "cuda" else "torch")):
        return backends.get_backend(name).matmul_prepared_residues(
            a, prep.residues, mu, prep.scale, prep.moduli, out_dtype,
            prep.n)


def matmul_prepared(a: torch.Tensor, prep,
                    out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) float @ prepared (K, N) -> (M, N) ``out_dtype``.

    A :class:`PreparedResidues` goes to :func:`matmul_prepared_scheme2`.
    A :class:`PreparedOperand` runs on the backend that prepared it: the
    lhs is encoded once and the prepared planes stream as they are
    ('planes'; the 'cuda' backend's plane route, which launches the
    kernels or raises), or the mixed form's plain version runs on the
    'interleaved' slices (the 'torch' backend)."""
    if isinstance(prep, PreparedResidues):
        return matmul_prepared_scheme2(a, prep, out_dtype)
    if not isinstance(prep, PreparedOperand):
        raise TypeError(f"matmul_prepared takes a PreparedOperand or "
                        f"PreparedResidues, got {type(prep).__name__}")
    m, k = a.shape
    if k != prep.k:
        raise ValueError(f"lhs K={k} vs prepared K={prep.k}")
    if a.is_complex():
        raise ValueError("matmul_prepared is real-valued; got complex lhs "
                         f"{a.dtype}")
    granularity = {"interleaved": TILE, "planes": ozaki1.PLANE_K}
    if prep.blocks.bk != granularity.get(prep.layout):
        raise ValueError(f"prepared operand {prep.layout} at granularity "
                         f"{prep.blocks.bk}; the consumer reads granularity "
                         f"{granularity.get(prep.layout)}")
    if not a.is_floating_point():
        a = a.float()
    mu = scheme1.pow2_scale(a, -1)                              # (M, 1)
    fused = prep.backend == "cuda"
    _record_consume("ozaki1", prep.p, prep.backend,
                    "fused" if fused else "torch",
                    "-" if fused else "interleaved_layout", m, k, prep,
                    a.element_size())
    with telemetry.gemm_scope("ozaki1", prep.p, prep.backend, "prepared-" + (
            "kernel" if fused else "torch")):
        return backends.get_backend(prep.backend).matmul_mixed(
            a, prep.slices, mu, prep.scale, prep.p, prep.beta, out_dtype)


# ---------------------------------------------------------------------------
# Once-per-step preparation under gradient accumulation.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepPrepared:
    """A float weight paired with its once-per-step prepared operand.

    Built before the microbatch loop by :func:`build_step_preps` and
    attached to the params tree by :func:`attach_step_preps`, so every
    microbatch streams the finished encode instead of preparing again.
    ``w`` stays the differentiable leaf: ``emulated_dot_prepared``
    (``repro_torch.core.emulated``) computes the forward from ``prep``
    and sends dB to ``w``; ``prep`` takes no gradient. For a layer stack
    ``w`` is (L, K, N) and ``prep`` the list of its L per-layer preps."""
    w: torch.Tensor
    prep: "PreparedOperand | PreparedResidues | list"

    def unbind(self) -> list:
        """Per-layer pairs of a layer stack."""
        return [StepPrepared(w, p)
                for w, p in zip(torch.unbind(self.w), self.prep)]


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (the model's
    ``tail``), ``path`` the tuple of keys and list indices down to the
    leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _site_of(path, site_default: str = "ffn") -> str:
    if "mixer" in path:
        return "attn"
    if "head" in path or "emb" in path:
        return "logits"
    return site_default


def _step_cacheable(cfg) -> bool:
    # Scheme I caches int8 slices, Scheme II balanced residues.
    return cfg.scheme in ("ozaki1", "ozaki2") and cfg.cache_weights


def policy_caches_weights(policy) -> bool:
    """Does any call-site family of this GemmPolicy cache weights? An
    unset default defers to the ambient resolver, as ``for_site`` does."""
    sites = [policy.default] + [cfg for _, cfg in policy.overrides]
    if policy.default is None:
        from repro_torch import api
        sites[0] = api.resolve_config()
    return any(_step_cacheable(cfg) for cfg in sites)


def _path_key(path) -> str:
    return "/".join(str(k) for k in path)


# Projection-weight leaf names consumed through models.common.dense, the
# only places a prepared rhs is legal. Excludes lookalikes used through
# raw einsums (w_r/w_i of RG-LRU, wkv_b of MLA, MoE experts,
# frontend_proj) and the tied-embedding table.
DENSE_WEIGHT_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a",
    "wi", "wi_gate", "wi_up", "w_y", "w_gate", "w_out", "w_in",
    "head",
})


def build_step_preps(params, policy, *, site_default: str = "ffn",
                     names=None) -> dict:
    """Prepare every cacheable dense weight once, keyed by tree path.

    Returns {path: prepared operand (with twin)} for the float leaves in
    ``names`` (``DENSE_WEIGHT_NAMES`` by default) whose site config caches
    weights; a leaf that is neither under a mixer nor the head takes the
    site ``site_default``. A 3-D stack
    under 'layers' is prepared per layer into a list, which the model's
    layer loop pairs with its weight's per-layer views (the reference
    stacks them for its layer scan; an eager loop needs no stack). MoE
    leaves are skipped (their experts are consumed through raw einsums).
    Nothing here is differentiated.
    """
    if names is None:
        names = DENSE_WEIGHT_NAMES
    preps: dict = {}

    def visit(path, leaf):
        ndim = getattr(leaf, "ndim", 0)
        stacked = ndim == 3 and "layers" in path
        if (not path or path[-1] not in names or "moe" in path
                or not (ndim == 2 or stacked) or not leaf.is_floating_point()):
            return leaf
        cfg = policy.for_site(_site_of(path, site_default))
        if not _step_cacheable(cfg):
            return leaf
        w = leaf.detach()
        if stacked:
            preps[_path_key(path)] = [prepare_rhs(w[g], cfg, with_twin=True)
                                      for g in range(w.shape[0])]
        else:
            preps[_path_key(path)] = prepare_rhs(w, cfg, with_twin=True)
        return leaf

    with torch.no_grad():
        _map_with_path(visit, params)
    return preps


def attach_step_preps(params, preps: dict):
    """Swap each prepared weight leaf for a StepPrepared(w, prep) pair."""
    if not preps:
        return params

    def wrap(path, leaf):
        prep = preps.get(_path_key(path))
        return StepPrepared(leaf, prep) if prep is not None else leaf

    return _map_with_path(wrap, params)


# ---------------------------------------------------------------------------
# Whole-model preparation (once-per-session serving reuse).
# ---------------------------------------------------------------------------

def prepare_params(params, policy, *, site_default: str = "ffn",
                   names=DENSE_WEIGHT_NAMES):
    """Wrap a model's 2-D dense projection weights (the leaves in
    ``names``; ``site_default`` is the site of those neither under a mixer
    nor the head) as prepared operands (either scheme), once per serve
    session. Scan-stacked (3-D) layer leaves pass through untouched, so on
    olmo-1b, whose projections are layer stacks and whose head is the
    tied embedding, no leaf is prepared (ROADMAP.md § 3 R4); the 2-D
    leaves of a model's unstacked ``tail`` blocks (recurrentgemma-2b's
    last two) are prepared, as in the reference."""
    def wrap(path, leaf):
        if (not path or path[-1] not in names
                or getattr(leaf, "ndim", 0) != 2
                or not leaf.is_floating_point()):
            return leaf
        cfg = policy.for_site(_site_of(path, site_default))
        if cfg.scheme not in ("ozaki1", "ozaki2"):
            return leaf
        with torch.no_grad():
            return prepare_rhs(leaf.detach(), cfg)

    return _map_with_path(wrap, params)
