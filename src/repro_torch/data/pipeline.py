"""Deterministic synthetic LM data (``repro.data.pipeline``).

Batches are numpy arrays keyed by (seed, step), the same numbers the
reference draws for host 0, so a resumed run fast-forwards to the same
stream and the parity tests feed both packages one batch: int32 token
ids and labels; for the audio stub, float32 Gaussian frames (B, S, F)
in place of the ids; for the vision stub, the ids plus float32 Gaussian
``image_embeds`` (B, n_image_tokens, F). With ``n_hosts`` > 1 host
``host`` draws its own batch_size / n_hosts rows, keyed by (seed, step,
host) as the reference's; a data-parallel step gives host r to rank r of
the data axes (``launch.steps``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    # Structured stream: x_{t+1} = (a * x_t + noise) mod vocab, which a
    # model can partially predict, so the loss falls in training.
    mult: int = 31

    def batch(self, step: int, batch_size: int, host: int = 0,
              n_hosts: int = 1) -> dict:
        per_host = batch_size // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host]))
        x0 = rng.integers(0, self.vocab, (per_host, 1))
        noise = rng.integers(0, 7, (per_host, self.seq_len + 1))
        toks = [x0]
        for t in range(self.seq_len):
            toks.append((toks[-1] * self.mult + noise[:, t:t + 1])
                        % self.vocab)
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def make_batch_iterator(arch: ArchConfig, shape: ShapeSpec, seed: int = 0,
                        host: int = 0, n_hosts: int = 1,
                        batch_override: int | None = None):
    """Yields (step, batch dict) of numpy arrays, ``batch_override`` rows
    a batch instead of the shape's global batch when set; host ``host``
    of ``n_hosts`` gets its own 1 / n_hosts of the rows."""
    m = arch.model
    bsz = batch_override or shape.global_batch
    ds = SyntheticLMDataset(m.vocab, shape.seq_len, seed)
    step = 0
    # The stub front ends' features: one stream for the run, as the
    # reference's (keyed by seed + 1 and the host).
    rng = np.random.default_rng(np.random.SeedSequence([seed + 1, host]))
    per_host = bsz // n_hosts
    while True:
        batch = ds.batch(step, bsz, host, n_hosts)
        if m.frontend == "audio_stub":
            batch = {"tokens": rng.standard_normal(
                (per_host, shape.seq_len, m.frontend_dim), dtype=np.float32),
                "labels": batch["labels"]}
        elif m.frontend == "vision_stub":
            batch["image_embeds"] = rng.standard_normal(
                (per_host, m.n_image_tokens, m.frontend_dim),
                dtype=np.float32)
        yield step, batch
        step += 1
