"""Helpers shared by the port's tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_*.py`")
    return torch.device("cuda")


def t(x: np.ndarray, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (a copy; jax hands out read-only arrays)."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


def bits(x) -> np.ndarray:
    """The float32 bit patterns of an array or tensor, for bitwise checks."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32).view(np.int32)
