"""Multi-device execution of the port (``repro.parallel``): the sharding
rules, the tensor-parallel emulated GEMM and the compressed reduction."""

from repro_torch.parallel.sharding import (  # noqa: F401
    batch_pspec,
    cache_pspecs,
    opt_pspecs,
    param_pspecs,
)
