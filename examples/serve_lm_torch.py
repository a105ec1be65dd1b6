"""Batched serving on the PyTorch port: prefill + decode against a shared
KV cache, optionally with the int8-quantized cache and an emulated-GEMM
spec, on the card.

  PYTHONPATH=src python examples/serve_lm_torch.py --requests 8 --gen 32
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The JAX package's ``examples/serve_lm.py`` on the port's surface: the
lockstep engine (``repro_torch.launch.serve.ServeEngine``) on the arch's
smoke config, one card and no mesh.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch
from repro_torch import configs
from repro_torch.launch.serve import ServeEngine
from repro_torch.models.common import GemmPolicy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--gemm", default=None,
                    help="precision spec (repro_torch.precision grammar); "
                         "omitted, REPRO_TORCH_EMULATION / the ambient "
                         "scope decides")
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = configs.get_smoke_config(args.arch)
    if args.int8_cache:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, kv_cache_dtype="int8"))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, arch.model.vocab,
                           (args.requests, args.prompt_len)).astype(np.int32)
    gemm = repro_torch.precision(args.gemm) if args.gemm else None
    eng = ServeEngine(arch, None, args.prompt_len + args.gen,
                      GemmPolicy(default=gemm), device=args.device)
    t0 = time.time()
    toks = eng.generate(prompts, args.gen)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    print(f"[serve] {args.requests} req x {args.gen} tok in {dt:.2f}s "
          f"({args.requests * args.gen / dt:.1f} tok/s, "
          f"cache={'int8' if args.int8_cache else arch.model.dtype})")
    print("[serve] first request:", toks[0].tolist())
    return toks


if __name__ == "__main__":
    main()
