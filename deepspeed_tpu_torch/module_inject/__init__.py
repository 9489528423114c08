from deepspeed_tpu_torch.module_inject.load_checkpoint import (  # noqa: F401
    from_hf_config, load_hf_checkpoint, load_state_dict)
