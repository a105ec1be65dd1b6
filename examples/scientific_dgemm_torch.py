"""Scientific-computing scenario on the PyTorch port: FP64-grade GEMM on
int8 tensor cores.

An H100 SXM does 1979 Top/s of dense int8 on its tensor cores and 67
TFLOP/s of FP64 (NVIDIA's data sheet, dense rates at 700 W): about 30
int8 operations for every FP64 one. This example emulates double-
precision GEMM from int8 products (Scheme II with m moduli, the float64
plane route of the port's kernels on the card) and compares its accuracy
with the card's own float64 matmul on ill-conditioned inputs, both
against a long-double product on the host.

  PYTHONPATH=src python examples/scientific_dgemm_torch.py
  PYTHONPATH=src python examples/scientific_dgemm_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core.precision import EmulationConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.default_rng(7)
    n = args.n
    a = (rng.random((n, n)) - 0.5) * np.exp(4.0 * rng.standard_normal((n, n)))
    b = (rng.random((n, n)) - 0.5) * np.exp(4.0 * rng.standard_normal((n, n)))
    ref = a.astype(np.longdouble) @ b.astype(np.longdouble)
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

    def effective_bits(c):
        c = c.cpu().numpy().astype(np.longdouble)
        return float(-np.log2(np.abs(c - ref).max() / np.abs(ref).max()))

    out = {"native f64": effective_bits(at @ bt)}
    for p in (9, 12, 15):
        cfg = EmulationConfig(scheme="ozaki2", p=p)
        emu = repro_torch.einsum("ij,jk->ik", at, bt, precision=cfg)
        out[f"Ozaki-II p={p}"] = effective_bits(emu)
        for name in ("native f64", f"Ozaki-II p={p}"):
            count = cfg.gemm_count() if "Ozaki" in name else 1
            print(f"{name:16s}: {out[name]:5.1f} effective bits "
                  f"({count} GEMMs)")
        print()
    ratio = 15 * 67e12 / 1979e12
    print(f"On an H100 SXM the int8 tensor cores peak at 1979 Top/s against "
          f"67 TFLOP/s\nof FP64: at the peaks the 15 int8 GEMMs of p=15 "
          f"({out['Ozaki-II p=15']:.1f} effective bits here)\ntake "
          f"{ratio:.2f} of the time of one FP64 GEMM.")
    return out


if __name__ == "__main__":
    main()
