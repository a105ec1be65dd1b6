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


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module, then as it was. The
    suite runs its files in parallel workers on a few cores, where every
    worker's full-size pool oversubscribes them: a file of many small
    torch ops (an engine's steps on smoke widths) then ran 10-300x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x: np.ndarray, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (a copy; jax hands out read-only arrays)."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


def bits(x) -> np.ndarray:
    """The float32 bit patterns of an array or tensor, for bitwise checks."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32).view(np.int32)
