"""Training CLI of the port (``repro.launch.train``): the deterministic
synthetic stream, the training step of ``launch.steps`` and the
fault-tolerant Trainer with auto-resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 3 --batch 8 --seq 128 --gemm ozaki1-p4+cached

The flags are the reference's plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). ``--smoke`` takes the reduced
config. ``--fail-at N`` injects a failure at step N; running the same
command again resumes from the newest checkpoint in ``--ckpt-dir``.
Flags whose subsystem is not ported yet raise: ``--metrics-jsonl`` /
``--metrics-prom`` (telemetry, ROADMAP.md § 1 item 6) and
``--model-parallel`` above 1 (multi-device, item 8).
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import api, configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import make_batch_iterator
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.models.common import GemmPolicy
from repro_torch.runtime import FailureInjector, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20,
                    help="TOTAL step count; a resumed run only executes "
                         "the remainder")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gemm", default=None,
                    help="precision spec (e.g. ozaki1-p3, ozaki1-p4+cached); "
                         "omitted, the ambient REPRO_TORCH_EMULATION env "
                         "decides")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--metrics-jsonl", default=None)
    ap.add_argument("--metrics-prom", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    if args.metrics_jsonl or args.metrics_prom:
        raise NotImplementedError("telemetry is not ported yet (ROADMAP.md "
                                  "§ 1 item 6)")
    if args.model_parallel != 1:
        raise NotImplementedError("model parallelism is not ported yet "
                                  "(ROADMAP.md § 1 item 8)")
    device = M.resolve_device(args.device)
    arch = (configs.get_smoke_config(args.arch) if args.smoke
            else configs.get_config(args.arch))
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    policy = (GemmPolicy(default=api.precision(args.gemm))
              if args.gemm else None)
    step_fn = S.make_train_step(arch, policy=policy)
    trainer = Trainer(
        step_fn=step_fn,
        init_state_fn=lambda: S.init_state(arch, args.seed, device),
        batch_iterator=make_batch_iterator(arch, shape, args.seed),
        ckpt_dir=args.ckpt_dir, device=device, ckpt_every=args.ckpt_every,
        failure=FailureInjector(args.fail_at))
    try:
        log = trainer.run(max(0, args.steps - trainer.start_step))
    finally:
        trainer.close()
    if log:
        print(f"[train] loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f} "
              f"over {len(log)} steps")
    return log


if __name__ == "__main__":
    main()
