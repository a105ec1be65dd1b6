"""Carry the JAX package's parameters over to the port.

``params_from_jax(tree, mcfg, device)`` takes the reference's parameter
pytree with numpy arrays as leaves (``jax.tree.map(np.asarray, params)``
on the JAX side — this module never imports jax) and returns the port's
parameters: the same nested dicts of tensors, in the same layout. The
stacked ``layers`` axis is kept by default, as the port's model indexes
it; ``split_layers=True`` returns one dict per layer under ``"blocks"``
instead, for callers that want per-layer tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import model as M


def _to_torch(tree, dtype: torch.dtype, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, dtype, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: widen exactly first
        arr = arr.astype(np.float32)
    # A copy: jax hands out read-only buffers.
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device,
                                                         dtype=dtype)


def params_from_jax(tree, mcfg: ModelConfig, device="cuda",
                    split_layers: bool = False):
    """The reference's parameter pytree (numpy leaves) -> the port's."""
    B.check_supported(mcfg)
    device = M.resolve_device(device)
    extra = set(tree) - {"emb", "ln_f", "head", "layers"}
    if extra:
        raise NotImplementedError(
            f"parameter groups {sorted(extra)} have no counterpart in the "
            "port yet (ROADMAP.md § 1 item 4)")
    params = _to_torch(tree, getattr(torch, mcfg.dtype), device)
    if split_layers:
        params["blocks"] = M.unstack_layers(params, mcfg.n_layers)
        del params["layers"]
    return params
