"""Quickstart on the PyTorch port: emulated high-precision GEMM through
the unified API, on the card.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Everything below runs through the three pillars of the public surface
(docs/api.md), as ``examples/quickstart.py`` does on the JAX package:
precision specs (``repro_torch.precision``), ambient emulation scopes
(``with repro_torch.emulation(...)``), and the emulated
``repro_torch.einsum`` front door. On a CUDA tensor every emulated GEMM
runs the hand-written kernels (the 'cuda' backend); ``--device cpu``
runs their plain versions. The ``@cuda`` spec suffix names that backend
(the JAX package's ``@gpu``).
"""

import argparse

import numpy as np
import torch

import repro_torch


def bits(c, ref):
    c = c.double().cpu().numpy() if isinstance(c, torch.Tensor) else c
    return float(-np.log2(np.abs(c - ref).max() / np.abs(ref).max()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    n = args.n
    rng = np.random.default_rng(0)
    # ill-conditioned inputs (paper Eq. 19, phi=4)
    a = ((rng.random((n, n)) - 0.5) * np.exp(4 * rng.standard_normal((n, n)))
         ).astype(np.float32)
    b = ((rng.random((n, n)) - 0.5) * np.exp(4 * rng.standard_normal((n, n)))
         ).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    out = {}

    # Precision specs are loggable one-liners: scheme + slice/modulus
    # count, parsed by repro_torch.precision (grammar in docs/api.md).
    out["native"] = bits(at @ bt, ref)
    print(f"native fp32 matmul:              {out['native']:5.1f} bits")
    for spec in ("ozaki1-p2", "ozaki1-p3", "ozaki1-p4",   # mantissa slicing
                 "ozaki2-m8", "ozaki2-m12"):              # CRT modular
        cfg = repro_torch.precision(spec)
        out[spec] = bits(repro_torch.einsum("ij,jk->ik", at, bt,
                                            precision=spec), ref)
        name = "Ozaki-I " if spec.startswith("ozaki1") else "Ozaki-II"
        print(f"{name} {spec} ({cfg.gemm_count():2d} int8 GEMMs): "
              f"{out[spec]:5.1f} bits")

    # 'bits=N' specs route through the planner (paper Fig. 7 crossover,
    # automated): name the precision you need, get the cheaper scheme.
    for target in (16, 22, 40):
        cfg = repro_torch.precision(f"bits={target}:k{n}")
        out[f"bits={target}"] = cfg.to_spec()
        print(f"planner: bits={target}:k{n} -> {cfg.to_spec()}")

    # Ambient scopes: emulate a whole block without threading configs —
    # every emulation-aware call site inside resolves to the scoped spec
    # (explicit arg > innermost scope > REPRO_TORCH_EMULATION env >
    # native).
    with repro_torch.emulation("ozaki2-m8"):
        out["scope ozaki2-m8"] = bits(repro_torch.einsum("ij,jk->ik", at, bt),
                                      ref)
    print(f"ambient scope ozaki2-m8:          {out['scope ozaki2-m8']:5.1f} "
          "bits")

    # General contractions: batch dims, multi-axis contractions and
    # attention-style patterns lower onto the same kernels (a batched
    # product is one launch of the batched kernel on the card).
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(
        np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(
        np.float32)).to(dev)
    scores = repro_torch.einsum("bqhd,bkhd->bhqk", q, k,
                                precision="ozaki1-p4")
    ref_scores = np.einsum("bqhd,bkhd->bhqk", q.double().cpu().numpy(),
                           k.double().cpu().numpy())
    out["scores"] = bits(scores, ref_scores)
    print(f"attention scores (bqhd,bkhd->bhqk): {out['scores']:5.1f} bits, "
          f"shape {tuple(scores.shape)}")

    # Kernel backends (docs/backends.md): the same GEMM named onto the
    # 'cuda' backend by the spec's suffix.
    out["ozaki1-p4@cuda"] = bits(repro_torch.einsum(
        "ij,jk->ik", at, bt, precision="ozaki1-p4@cuda"), ref)
    print(f"Ozaki-I  ozaki1-p4@cuda:          {out['ozaki1-p4@cuda']:5.1f} "
          "bits")
    return out


if __name__ == "__main__":
    main()
