"""Carry the JAX package's parameters over to the port.

``params_from_jax(tree, mcfg, device)`` takes the reference's parameter
pytree with numpy arrays as leaves (``jax.tree.map(np.asarray, params)``
on the JAX side — this module never imports jax) and returns the port's
parameters: the same nested dicts of tensors, in the same layout. The
stacked ``layers`` axis is kept by default, as the port's model indexes
it; ``split_layers=True`` returns one dict per layer under ``"blocks"``
instead (every group's blocks in execution order, then the tail), for
callers that want per-layer tensors.

The tree's groups ``layers/b0 .. b{k-1}``, its ``tail`` list of
unstacked blocks, a stub front end's ``frontend_proj`` and the
multi-token prediction group ``mtp`` carry over as they are. Each leaf
keeps its own dtype, as in the reference's tree: a bf16 model's MoE
router and sigmoid ``router_bias``, and its RG-LRU ``lam`` and SSD
``a_log``, ``dt_bias`` and ``d_skip``, are float32 there and stay
float32 here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    arr = np.asarray(tree)
    dtype = None
    if arr.dtype.name == "bfloat16":      # ml_dtypes: widen exactly first
        arr, dtype = arr.astype(np.float32), torch.bfloat16
    # A copy: jax hands out read-only buffers.
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device,
                                                         dtype=dtype)


def params_from_jax(tree, mcfg: ModelConfig, device="cuda",
                    split_layers: bool = False):
    """The reference's parameter pytree (numpy leaves) -> the port's."""
    device = M.resolve_device(device)
    extra = set(tree) - {"emb", "ln_f", "head", "layers", "tail",
                         "frontend_proj", "mtp"}
    if extra:
        raise ValueError(f"parameter groups {sorted(extra)} are not the "
                         "reference model's")
    params = _to_torch(tree, device)
    if split_layers:
        params["blocks"] = M.unstack_layers(params, mcfg)
        params.pop("layers", None)
        params.pop("tail", None)
    return params
