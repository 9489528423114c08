"""The CUDA device the port runs on (counterpart of ``deepspeed_tpu/accelerator/``).

`resolve_device` is the one place the port decides where it runs: no device
means CUDA, and a machine without CUDA raises unless the caller asks for the
CPU. There is no silent CPU path.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """`None` → `cuda`; a CUDA request on a machine without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class CudaAccelerator:
    """Device name, synchronisation, memory statistics and the power limit
    of one device (`cuda:N`, or the CPU when it was asked for)."""

    def __init__(self, device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def device_name(self) -> str:
        if not self.is_cuda:
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    def synchronize(self) -> None:
        if self.is_cuda:
            torch.cuda.synchronize(self.device)

    def max_memory_allocated(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.is_cuda else 0

    def reset_peak_memory_stats(self) -> None:
        if self.is_cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def name_and_power_limit(self) -> Optional[str]:
        """`nvidia-smi --query-gpu=name,power.limit` for this device, as it
        prints it, for reports; None where `nvidia-smi` is missing."""
        if not self.is_cuda or shutil.which("nvidia-smi") is None:
            return None
        index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip()


def get_accelerator(device: Union[None, str, torch.device] = None) -> CudaAccelerator:
    return CudaAccelerator(device)
