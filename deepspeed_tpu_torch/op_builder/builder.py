"""Builds the port's CUDA kernels (counterpart of ``deepspeed_tpu/op_builder/builder.py``).

Each `deepspeed_tpu_torch/csrc/<name>.cu` is compiled at first use by `nvcc`
for `sm_90a` into a shared library with a plain C interface, and loaded with
`ctypes`. Nothing includes PyTorch's headers, so a build takes seconds. The
library's file name carries the hash of its source, of the local headers the
source includes (`#include "..."`, next to it, and the ones those include)
and of the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.
Libraries go to `build/torch_kernels/` beside the package.

`HostLibrary` builds a host C++ source the same way with `g++`: the
asynchronous file I/O engine of the NVMe tier (`csrc/aio/ds_aio.cpp`, a copy
of the JAX package's root `csrc/aio/ds_aio.cpp`; `AIO_LIBRARY`).

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `KernelLibrary.check` raises on a non-zero code.
A kernel written through `ctypes` into a fresh tensor leaves that tensor
with no `grad_fn`: a wrapper whose kernel has no backward calls
`refuse_grad` first, so that grad mode raises instead of detaching.
Wrappers launch through `on_current_stream` (the current stream's raw
handle, a device guard only when needed), and a kernel whose blocks split a
sum takes its partials and arrival counts from `split_workspace`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LOCAL_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)


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

    FLAGS = NVCC_FLAGS

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC_DIR / source
        self.functions = dict(functions)
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""
        self.build_seconds = 0.0

    @property
    def name(self) -> str:
        return self.source.stem

    def library_path(self) -> Path:
        source = self.source.read_bytes()
        digest = hashlib.sha256(source)
        seen, todo = set(), list(_LOCAL_INCLUDE.findall(source))
        while todo:     # the local headers, and the ones they include
            name = todo.pop(0)
            if name in seen:
                continue
            seen.add(name)
            header = (self.source.parent / name.decode()).read_bytes()
            digest.update(header)
            todo += _LOCAL_INCLUDE.findall(header)
        digest.update(" ".join(self.FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        """Start `nvcc` unless the library for this source exists."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*self._compiler(), *self.FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.ds_tmp, proc.ds_out = tmp, out  # type: ignore[attr-defined]
        return proc

    def _compiler(self) -> List[str]:
        return [_nvcc()]

    def _finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.build_log = getattr(proc, "ds_log", None)
        if self.build_log is None:
            self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{self._compiler()[0]} failed on {self.source.name} "
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


class HostLibrary(KernelLibrary):
    """One host C++ source built by `g++` into a shared library, loaded
    with `ctypes`. `functions` maps each exported name to `(restype,
    argtypes)`."""

    FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

    def _compiler(self) -> List[str]:
        found = shutil.which("g++")
        if found is None:
            raise RuntimeError(f"g++ not found: building {self.source.name} needs a C++ "
                               "compiler")
        return [found]

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fname, (restype, argtypes) in self.functions.items():
                fn = getattr(lib, fname)
                fn.restype, fn.argtypes = restype, list(argtypes)
            self._lib = lib
        return self._lib


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# the asynchronous file I/O engine (the JAX package's `AsyncIOBuilder`
# signatures): io_uring where the kernel allows it, else a thread pool;
# large requests striped into sub-operations
AIO_LIBRARY = HostLibrary("aio/ds_aio.cpp", {
    "ds_aio_create": (_P, (_I, _I)),
    "ds_aio_create_ex": (_P, (_I, _I, _LL)),
    "ds_aio_destroy": (None, (_P,)),
    "ds_aio_using_uring": (_I, (_P,)),
    "ds_aio_open": (_I, (ctypes.c_char_p, _I)),
    "ds_aio_close": (None, (_I,)),
    "ds_aio_pread": (_LL, (_P, _I, _P, _LL, _LL)),
    "ds_aio_pwrite": (_LL, (_P, _I, _P, _LL, _LL)),
    "ds_aio_wait": (_LL, (_P,)),
})


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and an input requires grad: the kernel's
    output would carry no gradient back to it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that do not require grad")


def on_current_stream(index: int, launch: Callable[[int], int]) -> int:
    """`launch(stream)` on device `index`'s current stream, given as the raw
    handle (a Stream object costs ~3 us), under a device guard only when
    `index` is not the current device (a guard costs ~3 us a call)."""
    if index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return launch(torch._C._cuda_getCurrentRawStream(index))


_WORKSPACE: Dict[Tuple[str, int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def split_workspace(kind: str, index: int, stream: int, floats: int,
                    counts: int) -> Tuple[int, int]:
    """Pointers to the f32 partials and int32 arrival counts of `kind`, a
    kernel whose blocks split a sum and whose last block to arrive adds
    the partials, for calls on `stream` of device `index`: kept per stream,
    since the calls on a stream run in order, and grown as needed; the
    counts are zeroed once and every launch leaves them at 0."""
    part, count = _WORKSPACE.get((kind, index, stream), (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=torch.device("cuda", index))
    if count is None or count.numel() < counts:
        count = torch.zeros(max(counts, 256), dtype=torch.int32,
                            device=torch.device("cuda", index))
    _WORKSPACE[(kind, index, stream)] = (part, count)
    return part.data_ptr(), count.data_ptr()


def build_all(libraries: Iterable[KernelLibrary]) -> List[KernelLibrary]:
    """Build every library at once: one `nvcc` per source, all started
    together, then wait for each; each library's `build_seconds` is its own
    compiler's wall time (0 when it was built already). Returns the
    libraries, loaded."""
    libraries = list(libraries)
    t0 = time.perf_counter()
    procs = [lib._start_build() for lib in libraries]

    def drain(lib, proc):  # read the compiler's output as it comes, then time it
        proc.ds_log = proc.communicate()[0]
        lib.build_seconds = time.perf_counter() - t0

    threads = []
    for lib, proc in zip(libraries, procs):
        lib.build_seconds = 0.0
        if proc is not None:
            threads.append(threading.Thread(target=drain, args=(lib, proc)))
            threads[-1].start()
    for thread in threads:
        thread.join()
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
