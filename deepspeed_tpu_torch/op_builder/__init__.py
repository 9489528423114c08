from deepspeed_tpu_torch.op_builder.builder import (  # noqa: F401
    AIO_LIBRARY,
    HostLibrary,
    KernelLibrary,
    build_all,
    on_current_stream,
    refuse_grad,
    split_workspace,
)
