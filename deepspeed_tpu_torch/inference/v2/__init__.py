"""Inference v2, FastGen (counterpart of ``deepspeed_tpu/inference/v2/``).

Continuous batching over a block-paged KV cache: physical KV blocks are
allocated to sequences on demand (`inference/kv_cache.PagedKVCache`), and
the paged decode and prefill kernels (`ops/cuda/paged_attention.py`)
resolve the block tables on the device.
"""

from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2  # noqa: F401
from deepspeed_tpu_torch.inference.v2.ragged import (  # noqa: F401
    BlockedAllocator,
    DSSequenceDescriptor,
    DSStateManager,
)
