"""Atomic, keep-N checkpoints of trees of tensors
(``repro.checkpoint.manager``).

Layout: ``<dir>/step_<N>/state.pt`` + ``manifest.json``, written into a
temporary directory and renamed into place when complete, so a reader
never sees half a checkpoint. ``torch.save`` stores each tensor with its
dtype and values exactly; ``restore`` loads onto the device asked for.
With ``async_save`` (the default) saves run on a background thread: the
state is copied to host memory first, the previous save is joined before
a new one starts, and ``wait`` / ``close`` join the last; without it
``save`` returns once the checkpoint is published. ``restore(step,
like)`` checks the saved tree against ``like``'s structure and puts each
tensor where ``like``'s leaf is. ``restore(..., shardings=)`` re-shards
every leaf of the saved (whole) state onto a possibly different mesh,
the elastic path: each rank keeps its slice under the leaf's
``NamedSharding`` (``parallel.sharding``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import torch

from repro_torch.utils.tree import tree_flatten, tree_map


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
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

        if not self.async_save:
            write()
            return
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

    def restore(self, step: int, like=None, shardings=None, *,
                device="cpu"):
        """The state saved at ``step``: its tensors on ``device``, or, with
        ``like`` (a tree of the same structure), each on the device of
        ``like``'s leaf. ``shardings`` (a tree of ``NamedSharding`` of
        the same structure, ``parallel.sharding.shardings``) keeps only
        this rank's slice of each whole leaf under its spec, which may be
        of another mesh than the one that saved it; the file is then
        mapped, not read, and only the slices are copied to ``device``, so
        no rank holds the whole state."""
        path = os.path.join(self.dir, f"step_{step:08d}", "state.pt")
        if shardings is None:
            state = torch.load(path, map_location=torch.device(device),
                               weights_only=True)
        else:
            from repro_torch.parallel import sharding as shd
            state = torch.load(path, map_location="cpu", mmap=True,
                               weights_only=True)
            state = shd._map(
                lambda ns, x: shd.shard_leaf(x, ns.spec, ns.mesh).to(
                    device, copy=True) if isinstance(x, torch.Tensor) else x,
                shardings, state)
        if like is None:
            return state
        want, got = tree_flatten(like), tree_flatten(state)
        if sorted(want) != sorted(got):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{sorted(set(got) ^ set(want))[:8]} unlike "
                             "the tree it is restored into")
        return tree_map(lambda x, ref: x.to(ref.device)
                        if isinstance(ref, torch.Tensor) else x, state, like)

    def close(self) -> None:
        self.wait()
