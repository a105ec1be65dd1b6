"""Atomic, keep-N checkpoints of trees of tensors
(``repro.checkpoint.manager``).

Layout: ``<dir>/step_<N>/state.pt`` + ``manifest.json``, written into a
temporary directory and renamed into place when complete, so a reader
never sees half a checkpoint. ``torch.save`` stores each tensor with its
dtype and values exactly; ``restore`` loads onto the device asked for.
Saves run on a background thread: the state is copied to host memory
first, the previous save is joined before a new one starts, and
``wait`` / ``close`` join the last. The reference's re-sharding onto
another mesh has no counterpart on one card.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import torch

from repro_torch.utils.tree import tree_flatten, tree_map


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state) -> None:
        self.wait()
        # Snapshot to host memory now, so the step can go on while the
        # file is written.
        host = tree_map(lambda x: x.detach().to("cpu", copy=True)
                        if isinstance(x, torch.Tensor) else x, state)

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            torch.save(host, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "keys": sorted(tree_flatten(host))},
                          f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic publish
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, device="cpu"):
        """The state saved at ``step``, its tensors on ``device``."""
        path = os.path.join(self.dir, f"step_{step:08d}", "state.pt")
        return torch.load(path, map_location=torch.device(device),
                          weights_only=True)

    def close(self) -> None:
        self.wait()
