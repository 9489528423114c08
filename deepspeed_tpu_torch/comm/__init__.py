"""`deepspeed_tpu_torch.comm` (counterpart of ``deepspeed_tpu/comm``)."""
from deepspeed_tpu_torch.comm.comm import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_into,
    all_reduce,
    barrier,
    broadcast,
    comm_stats,
    destroy_process_group,
    get_backend,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    reduce_scatter,
    reset_comm_stats,
)
