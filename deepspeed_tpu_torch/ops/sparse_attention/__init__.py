from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (  # noqa: F401
    SparseSelfAttention,
    sparse_attention,
)
