"""Deterministic synthetic LM data (``repro.data.pipeline``, token front
end only).

Batches are numpy int32 arrays keyed by (seed, step), the same numbers
the reference draws for host 0, so a resumed run fast-forwards to the
same stream and the parity tests feed both packages one batch. One card
is one host: sharding the stream across hosts waits for multi-device
training (ROADMAP.md § 1 item 8).
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

    def batch(self, step: int, batch_size: int) -> dict:
        # The reference keys its stream by (seed, step, host); this is host 0.
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 0]))
        x0 = rng.integers(0, self.vocab, (batch_size, 1))
        noise = rng.integers(0, 7, (batch_size, self.seq_len + 1))
        toks = [x0]
        for t in range(self.seq_len):
            toks.append((toks[-1] * self.mult + noise[:, t:t + 1])
                        % self.vocab)
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def make_batch_iterator(arch: ArchConfig, shape: ShapeSpec, seed: int = 0):
    """Yields (step, batch dict) of numpy arrays."""
    m = arch.model
    if m.frontend != "none":
        raise NotImplementedError(
            f"the {m.frontend} front end is not ported yet (ROADMAP.md § 1 "
            "item 4)")
    ds = SyntheticLMDataset(m.vocab, shape.seq_len, seed)
    step = 0
    while True:
        yield step, ds.batch(step, shape.global_batch)
        step += 1
