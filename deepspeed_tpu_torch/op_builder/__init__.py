from deepspeed_tpu_torch.op_builder.builder import (  # noqa: F401
    KernelLibrary,
    build_all,
)
