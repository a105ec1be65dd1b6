"""Training CLI of the port (``repro.launch.train``): the deterministic
synthetic stream, the training step of ``launch.steps`` and the
fault-tolerant Trainer with auto-resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 3 --batch 8 --seq 128 --gemm ozaki1-p4+cached

The flags are the reference's plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). ``--smoke`` takes the reduced
config. ``--fail-at N`` injects a failure at step N; running the same
command again resumes from the newest checkpoint in ``--ckpt-dir``. A
guarded spec (``--gemm ozaki1-p4+guard:strict``) retries a step whose
ladder ran out; ``--metrics-jsonl FILE`` writes one telemetry record a
step, and with telemetry enabled the final Prometheus text goes to
``--metrics-prom FILE`` (stdout without it).

On N ranks (``torchrun --nproc-per-node N -m repro_torch.launch.train
...``, or any launcher that sets ``RANK`` / ``WORLD_SIZE``) the mesh is
(N / mp, mp) over ("data", "model"), mp = ``--model-parallel``: each
data rank reads its own rows of every batch, each model rank holds its
tiles of the dense weights, and rank 0 writes whole checkpoints, which
a resume on another mesh re-shards.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import api, configs, telemetry
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import make_batch_iterator
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (axis_index, axis_sizes, is_live,
                                     make_host_mesh)
from repro_torch.models import model as M
from repro_torch.parallel import sharding as shd
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
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write one telemetry record per step to this "
                         "JSONL file (implies telemetry; aggregate with "
                         "python -m repro_torch.telemetry.report)")
    ap.add_argument("--metrics-prom", default=None,
                    help="dump the final Prometheus text-format metrics "
                         "to this file at exit (stdout when telemetry is "
                         "enabled and no path is given)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    mesh = make_host_mesh(args.model_parallel)
    device = M.resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        from repro_torch.launch.mesh import rank_device
        device = rank_device("cuda")
    arch = (configs.get_smoke_config(args.arch) if args.smoke
            else configs.get_config(args.arch))
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    policy = (GemmPolicy(default=api.precision(args.gemm))
              if args.gemm else None)
    live = is_live(mesh)          # a process group of several ranks
    step_fn = S.make_train_step(arch, mesh if live else None, shape, policy,
                                donate=False)
    sizes = axis_sizes(mesh)
    host = axis_index(mesh, shd.data_axes(mesh)) if live else 0
    state_sh = (S.named(S.tile_state_specs(arch, mesh), mesh) if live
                else None)
    trainer = Trainer(
        step_fn=step_fn,
        init_state_fn=lambda: S.init_state(arch, args.seed, device,
                                           mesh if live else None),
        batch_iterator=make_batch_iterator(arch, shape, args.seed, host,
                                           sizes.get("data", 1)),
        ckpt_dir=args.ckpt_dir, state_shardings=state_sh, device=device,
        ckpt_every=args.ckpt_every,
        failure=FailureInjector(args.fail_at),
        metrics_jsonl=args.metrics_jsonl,
        tokens_per_step=args.batch * args.seq)
    try:
        log = trainer.run(max(0, args.steps - trainer.start_step))
    finally:
        trainer.close()
    if log:
        print(f"[train] loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f} "
              f"over {len(log)} steps"
              + (f" on mesh {sizes}" if live else ""))
    if telemetry.enabled():
        text = telemetry.render_prometheus()
        if args.metrics_prom:
            with open(args.metrics_prom, "w", encoding="utf-8") as fh:
                fh.write(text)
            print(f"[train] metrics dumped to {args.metrics_prom}")
        else:
            print("[train] final metrics (Prometheus text format):")
            print(text, end="")
    return log


if __name__ == "__main__":
    main()
