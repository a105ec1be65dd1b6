"""Fault-tolerant training runtime (``repro.runtime.trainer``).

* auto-resume: on construction the Trainer restores the newest valid
  checkpoint onto its device and continues from the next step;
* failure injection: ``FailureInjector`` raises at a chosen step, so a
  test can assert bit-exact continuation after a restart;
* straggler detection: per-step wall time against the mean and spread of
  the earlier steps; slow steps are logged and counted.

The reference's SIGTERM preemption checkpoint is not ported yet
(ROADMAP.md § 1 item 2), nor its guard retry (``+guard`` specs) and
telemetry records (items 5 and 6); a guarded spec is refused earlier, by
``kernels.dispatch.resolve_policy``.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager


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


class Trainer:
    LOG_EVERY = 10

    def __init__(self, *, step_fn, init_state_fn, batch_iterator,
                 ckpt_dir: str, device="cuda", ckpt_every: int = 50,
                 failure: FailureInjector | None = None):
        self.step_fn = step_fn
        self.batch_iterator = batch_iterator
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.failure = failure or FailureInjector()
        self.monitor = StragglerMonitor()
        self.metrics_log: list[dict] = []

        latest = self.ckpt.latest_step()
        if latest is not None:
            self.state = self.ckpt.restore(latest, device)
            self.start_step = latest + 1
            print(f"[trainer] resumed from step {latest}")
        else:
            self.state = init_state_fn()
            self.start_step = 0

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
            new_state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            self.state = new_state
            dt = time.time() - t0
            slow = self.monitor.observe(step, dt)
            metrics.update(step=step, seconds=dt)
            self.metrics_log.append(metrics)
            if slow:
                print(f"[trainer] straggler step {step}: {dt:.3f}s")
            if step % self.LOG_EVERY == 0:
                print(f"[trainer] step {step} "
                      f"loss {metrics.get('loss', float('nan')):.4f} "
                      f"({dt:.2f}s)")
            if (step + 1) % self.ckpt_every == 0 or step + 1 == end:
                self.ckpt.save(step, self.state)
            step += 1
        self.ckpt.wait()
        self.start_step = step
        return self.metrics_log

    def close(self):
        self.ckpt.close()
