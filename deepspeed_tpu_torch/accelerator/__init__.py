from deepspeed_tpu_torch.accelerator.cuda_accelerator import get_accelerator  # noqa: F401
