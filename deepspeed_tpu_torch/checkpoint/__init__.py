"""Checkpoint interop (counterpart of ``deepspeed_tpu/checkpoint``): readers of
torch-DeepSpeed checkpoint directories (`ds_import.py`) and the universal
atom layout (`ds_export.py`). The port's own checkpoints are
`runtime/checkpointing.py`."""

from deepspeed_tpu_torch.checkpoint.ds_export import (  # noqa: F401
    ds_to_universal,
    load_universal,
    restore_tree_from_universal,
)
from deepspeed_tpu_torch.checkpoint.ds_import import (  # noqa: F401
    get_fp32_state_dict_from_zero_checkpoint,
    import_reference_checkpoint,
    load_model_states,
    load_reference_checkpoint,
)
