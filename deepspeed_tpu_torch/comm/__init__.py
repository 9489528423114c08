"""`deepspeed_tpu_torch.comm` (counterpart of ``deepspeed_tpu/comm``)."""
from deepspeed_tpu_torch.comm.comm import (  # noqa: F401
    all_gather,
    all_reduce,
    barrier,
    broadcast,
    destroy_process_group,
    get_backend,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
)
