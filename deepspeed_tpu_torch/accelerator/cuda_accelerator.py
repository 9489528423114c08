"""The CUDA device the port runs on (counterpart of ``deepspeed_tpu/accelerator/``).

`resolve_device` is the one place the port decides where it runs: no device
means the rank's card, `cuda:{local_rank % device_count}`
(`local_device_index`), and a machine without CUDA raises unless the caller
asks for the CPU. There is no silent CPU path. Two ranks on one card arise
only under the `gloo` backend: `comm.init_distributed` refuses them under
`nccl`.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch

# Published dense bf16 tensor-core peak in TFLOP/s at the full power limit
# (NVIDIA H100 SXM data sheet, no sparsity): a datasheet figure for MFU, not
# a measurement. A card set below its power limit runs slower.
_PEAK_TFLOPS = {"H100": {"bfloat16": 989.0}}


def local_device_index() -> int:
    """The rank's card: its local rank modulo the cards on this host."""
    from deepspeed_tpu_torch.comm import get_local_rank
    return get_local_rank() % max(1, torch.cuda.device_count())


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """`None` → the rank's card (`local_device_index`); a CUDA request on a
    machine without CUDA raises."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", local_device_index())
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

    def total_memory(self) -> int:
        """The card's memory in bytes; 0 on the CPU (size unknown)."""
        if not self.is_cuda:
            return 0
        return int(torch.cuda.get_device_properties(self.device).total_memory)

    def reset_peak_memory_stats(self) -> None:
        if self.is_cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_tflops(self, dtype: str = "bfloat16") -> float:
        """The card's published dense peak for `dtype`, in TFLOP/s. Raises
        for a card or dtype the table does not hold."""
        name = self.device_name()
        for card, peaks in _PEAK_TFLOPS.items():
            if card in name and dtype in peaks:
                return peaks[dtype]
        raise ValueError(f"no published {dtype} peak for {name!r}")

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
