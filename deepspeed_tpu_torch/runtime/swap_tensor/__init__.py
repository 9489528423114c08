from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import (  # noqa: F401
    AsyncTensorSwapper,
    SwapIOError,
)
