"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM with
every dense projection running on the paper's emulated int8 GEMM path,
on the card.

  PYTHONPATH=src python examples/train_emulated_lm_torch.py --steps 300
  PYTHONPATH=src python examples/train_emulated_lm_torch.py --small \\
      --steps 20 --device cpu

(--small for a quick demo.) The JAX package's
``examples/train_emulated_lm.py`` on the port's surface: one card, no
mesh; data, the step, the emulated matmuls, checkpoints and resume are
exercised by one command. Checkpoints go to a temporary directory
unless ``--ckpt-dir`` names one (a rerun with the same directory
resumes).
"""

import argparse
import dataclasses
import tempfile

import repro_torch
from repro_torch.configs.base import (ArchConfig, ModelConfig, ShapeSpec,
                                      TrainPolicy)
from repro_torch.data import make_batch_iterator
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.models.common import GemmPolicy
from repro_torch.optim import make_optimizer
from repro_torch.runtime import Trainer

LM_100M = ArchConfig(
    model=ModelConfig(
        name="lm-100m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=32768, norm="rms", act="swiglu",
        tie_embeddings=True, q_chunk=256, kv_chunk=256),
    train=TrainPolicy(microbatches=1, learning_rate=3e-4),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--gemm", default="ozaki1-p3",
                    help="every dense projection runs through this")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = LM_100M
    if args.small:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
            d_ff=1024, vocab=4096))
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    policy = GemmPolicy(default=repro_torch.precision(args.gemm))
    opt_init, _ = make_optimizer(arch.train.optimizer)

    def init_state():
        params = M.init_params(arch.model, 0, args.device)
        print(f"[100m] {M.param_count(params) / 1e6:.1f}M parameters, "
              f"gemm backend = {args.gemm}")
        return {"params": params, "opt": opt_init(params)}

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(
            step_fn=S.make_train_step(arch, None, shape, policy,
                                      donate=False),
            init_state_fn=init_state,
            batch_iterator=make_batch_iterator(arch, shape),
            ckpt_dir=args.ckpt_dir or tmp, device=args.device,
            ckpt_every=50)
        log = trainer.run(args.steps)
        trainer.close()
    print(f"[100m] loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}")
    return log


if __name__ == "__main__":
    main()
