"""The port's model zoo (``repro.models``): attention decoders (GQA or
MLA; dense FFN or MoE), the RG-LRU hybrid, Mamba-2 SSD blocks and a
bidirectional encoder over grouped, stacked layers, with token,
audio-stub and vision-stub front ends, in training, ragged serving,
prefill and decode."""

from repro_torch.models.model import (  # noqa: F401
    forward_decode,
    forward_prefill,
    forward_train,
    init_cache,
    init_params,
    param_count,
)
from repro_torch.models.common import (  # noqa: F401
    GemmPolicy,
    NATIVE_POLICY,
    cross_entropy_loss,
    parse_gemm_spec,
)
