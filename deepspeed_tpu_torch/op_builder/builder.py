"""Builds the port's CUDA kernels (counterpart of ``deepspeed_tpu/op_builder/builder.py``).

Each `deepspeed_tpu_torch/csrc/<name>.cu` is compiled at first use by `nvcc`
for `sm_90a` into a shared library with a plain C interface, and loaded with
`ctypes`. Nothing includes PyTorch's headers, so a build takes seconds. The
library's file name carries the hash of its source and of the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Libraries
go to `build/torch_kernels/` beside the package.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `KernelLibrary.check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                           "needs the CUDA toolkit")
    return found


class KernelLibrary:
    """One `.cu` source, the library built from it, and the C functions it
    exports. `functions` maps each exported name to its `ctypes` argtypes;
    every function returns a `cudaError_t` as an int."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC_DIR / source
        self.functions = dict(functions)
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""

    @property
    def name(self) -> str:
        return self.source.stem

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        """Start `nvcc` unless the library for this source exists."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.ds_tmp, proc.ds_out = tmp, out  # type: ignore[attr-defined]
        return proc

    def _finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(proc.ds_tmp, proc.ds_out)  # type: ignore[attr-defined]

    def build(self) -> Path:
        self._finish_build(self._start_build())
        return self.library_path()

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fname, argtypes in self.functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            err = lib.ds_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if code != 0:
            msg = self.lib().ds_cuda_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def build_all(libraries: Iterable[KernelLibrary]) -> List[KernelLibrary]:
    """Build every library at once: one `nvcc` per source, all started
    together, then wait for each. Returns the libraries, loaded."""
    libraries = list(libraries)
    procs = [lib._start_build() for lib in libraries]
    errors = []
    for lib, proc in zip(libraries, procs):
        try:  # wait for every nvcc before raising, so none outlives the call
            lib._finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.lib()
    return libraries
