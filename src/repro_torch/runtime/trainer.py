"""Fault-tolerant training runtime (``repro.runtime.trainer``).

* auto-resume: on construction the Trainer restores the newest valid
  checkpoint onto its device and continues from the next step;
* failure injection: ``FailureInjector`` raises at a chosen step, so a
  test can assert bit-exact continuation after a restart;
* straggler detection: per-step wall time against the mean and spread of
  the earlier steps; slow steps are logged and counted;
* guard consumption: when emulated GEMMs run with a ``+guard`` spec,
  ``GuardMonitor`` folds the per-step delta of ``repro_torch.guard.
  stats()`` into the metrics log, and a strict-mode accuracy trip
  (``EmulationAccuracyError``) becomes a step-level retry with backoff
  instead of a run abort (the step function is pure: state in, state
  out);
* telemetry: with ``metrics_jsonl`` (which enables telemetry) or with
  telemetry already enabled, one step record a step
  (``telemetry.StepTracker``; ``tokens_per_step`` gives its tokens/s);
* preemption: with ``handle_sigterm`` a SIGTERM lets the current step
  finish, writes a checkpoint of it synchronously and returns from
  ``run``; ``close`` puts the previous handler back;
* meshes: with ``state_shardings`` (a tree of ``parallel.sharding.
  NamedSharding`` of the state as the ranks hold it) every rank joins in
  gathering each sharded leaf whole before a save, rank 0 alone writes
  the whole state, and a resume gives each rank its slice of it, on
  whatever mesh the shardings name (the elastic path).
"""

from __future__ import annotations

import signal
import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.precision import EmulationAccuracyError


class FailureInjector:
    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def check(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step \
                and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


class StragglerMonitor:
    """Steps slower than mean + z * std of the last 50 are stragglers."""

    def __init__(self, z: float = 3.0, warmup: int = 5):
        self.z = z
        self.warmup = warmup
        self.times: list[float] = []
        self.stragglers: list[tuple[int, float]] = []

    def observe(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        if len(self.times) <= self.warmup:
            return False
        hist = np.asarray(self.times[:-1][-50:])
        mu, sd = hist.mean(), hist.std() + 1e-9
        if seconds > mu + self.z * sd:
            self.stragglers.append((step, seconds))
            return True
        return False


class GuardMonitor:
    """Per-step deltas of the process-wide ``repro_torch.guard`` counters.

    ``observe(step)`` is called after the step's metrics reached the host,
    so every guard event of the step has been recorded. Steps whose delta
    shows a trip are collected in ``trip_steps``.
    """

    def __init__(self):
        from repro_torch import guard
        self._stats = guard.stats
        self._last = self._stats()
        self.trip_steps: list[tuple[int, int]] = []

    def observe(self, step: int) -> dict[str, int]:
        now = self._stats()
        delta = {f: getattr(now, f) - getattr(self._last, f)
                 for f in ("calls", "trips", "escalations", "recoveries",
                           "native_fallbacks", "masked")}
        self._last = now
        if delta["trips"]:
            self.trip_steps.append((step, delta["trips"]))
        return delta


class Trainer:
    """The reference's Trainer on one card: ``keep`` checkpoints are kept
    (``CheckpointManager``), and a progress line is printed every
    ``log_every`` steps; ``device`` is where a resumed state is put."""

    def __init__(self, *, step_fn, init_state_fn, batch_iterator,
                 ckpt_dir: str, state_shardings=None, device="cuda",
                 ckpt_every: int = 50,
                 keep: int = 3, failure: FailureInjector | None = None,
                 log_every: int = 10, handle_sigterm: bool = False,
                 guard_retries: int = 2, guard_backoff: float = 0.25,
                 metrics_jsonl: str | None = None,
                 tokens_per_step: int | None = None):
        from repro_torch import telemetry
        self.step_fn = step_fn
        self.state_shardings = state_shardings
        self.batch_iterator = batch_iterator
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.failure = failure or FailureInjector()
        self.monitor = StragglerMonitor()
        self.guard_monitor = GuardMonitor()
        self.guard_retries = guard_retries
        self.guard_backoff = guard_backoff
        self.metrics_log: list[dict] = []
        self._preempted = False
        self._prev_sigterm = None
        self._tokens_per_step = tokens_per_step
        self._sink = None
        if metrics_jsonl:
            telemetry.enable()
            self._sink = telemetry.jsonl_sink(metrics_jsonl)
        self._tracker = telemetry.StepTracker() if telemetry.enabled() \
            else None

        latest = self.ckpt.latest_step()
        if latest is not None:
            self.state = self.ckpt.restore(latest, device=device,
                                           shardings=state_shardings)
            self.start_step = latest + 1
            print(f"[trainer] resumed from step {latest}")
        else:
            self.state = init_state_fn()
            self.start_step = 0

        if handle_sigterm:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)

    def _on_sigterm(self, *_):
        self._preempted = True

    def run(self, n_steps: int) -> list[dict]:
        step = self.start_step
        end = self.start_step + n_steps
        it = iter(self.batch_iterator)
        # Fast-forward the deterministic stream to the resume point.
        for _ in range(self.start_step):
            next(it)
        while step < end:
            _, batch = next(it)
            t0 = time.time()
            self.failure.check(step)
            # A strict guard raises EmulationAccuracyError when its ladder
            # runs out; the step is retried with backoff before giving up,
            # and self.state only advances once metrics have synced.
            attempt = 0
            while True:
                try:
                    new_state, metrics = self.step_fn(self.state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    break
                except EmulationAccuracyError as e:
                    if attempt >= self.guard_retries:
                        raise
                    attempt += 1
                    pause = self.guard_backoff * attempt
                    print(f"[trainer] guard trip at step {step} "
                          f"(retry {attempt}/{self.guard_retries} "
                          f"after {pause:.2f}s): {e}")
                    time.sleep(pause)
            self.state = new_state
            dt = time.time() - t0
            slow = self.monitor.observe(step, dt)
            metrics.update(step=step, seconds=dt, guard_retries=attempt,
                           **{f"guard_{k}": v for k, v in
                              self.guard_monitor.observe(step).items()
                              if k in ("trips", "native_fallbacks")})
            self.metrics_log.append(metrics)
            if self._tracker is not None:
                self._tracker.step_metrics(
                    step, dt, kind="train", tokens=self._tokens_per_step,
                    loss=metrics.get("loss"),
                    extra={"guard_retries": attempt,
                           "straggler": bool(slow)})
            if slow:
                print(f"[trainer] straggler step {step}: {dt:.3f}s")
            if step % self.log_every == 0:
                print(f"[trainer] step {step} "
                      f"loss {metrics.get('loss', float('nan')):.4f} "
                      f"({dt:.2f}s)")
            if ((step + 1) % self.ckpt_every == 0 or step + 1 == end
                    or self._preempted):
                self._save(step)
            step += 1
            if self._preempted:
                print(f"[trainer] preempted; checkpointed at step {step - 1}")
                break
        self.ckpt.wait()
        self._barrier()
        self.start_step = step
        return self.metrics_log

    def _save(self, step: int) -> None:
        """A checkpoint of the whole state: on a mesh gathered by every
        rank, written by rank 0."""
        if self.state_shardings is None:
            self.ckpt.save(step, self.state)
            return
        import torch.distributed as dist
        from repro_torch.parallel import sharding as shd
        whole = shd._map(lambda ns, x: shd.unshard_leaf(x, ns.spec, ns.mesh),
                         self.state_shardings, self.state)
        if not dist.is_initialized() or dist.get_rank() == 0:
            self.ckpt.save(step, whole)

    def _barrier(self) -> None:
        """On a mesh, no rank reads a checkpoint before rank 0 wrote it."""
        import torch.distributed as dist
        if self.state_shardings is not None and dist.is_initialized():
            dist.barrier()

    def close(self):
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
        self.ckpt.close()
