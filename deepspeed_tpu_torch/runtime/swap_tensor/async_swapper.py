"""Asynchronous tensor swapping to NVMe (counterpart of ``deepspeed_tpu/runtime/swap_tensor/async_swapper.py``).

Tensors stream to and from swap files through the native aio engine
(`csrc/aio/ds_aio.cpp`, built by `op_builder.AIO_LIBRARY`), so disk traffic
overlaps the work around it. Reads land directly in the host tensor the
caller gives, page-locked where a host-to-device copy follows, so that copy
can run asynchronously. A missing or short swap file, and any failed
request, raise `SwapIOError`: no partial read passes as data.

`NVMeStateStore` (the ZeRO-Infinity optimizer-state cycle of training) is
not ported (ROADMAP.md, Queue 1, 'Training: the rest').
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


class SwapIOError(IOError):
    """A swap-file I/O failure with its file and offset: `op` is "read",
    "write", "open" or "io", `offset` is where the valid bytes end (0 for a
    missing file), `expected`/`available` the bytes asked for and backed."""

    def __init__(self, op: str, path: str, offset: int = 0, expected: int = 0,
                 available: int = 0, detail: str = ""):
        self.op, self.path = op, path
        self.offset, self.expected, self.available = int(offset), int(expected), int(available)
        msg = (f"async swap {op} failed: {path} at offset {self.offset} (expected "
               f"{self.expected} bytes, {self.available} available)")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class AsyncTensorSwapper:
    """Swap files under `swap_dir`, one a name. `swap_out` and `swap_in`
    queue requests; `synchronize` waits for all of them and raises on a
    failure. A tensor given to either must stay untouched until then (the
    swapper keeps a reference)."""

    def __init__(self, swap_dir: str, num_threads: int = 4, queue_depth: int = 32,
                 stripe_bytes: int = 8 << 20):
        from deepspeed_tpu_torch.nvme import tuned_defaults
        from deepspeed_tpu_torch.op_builder import AIO_LIBRARY
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.lib = AIO_LIBRARY.lib()
        # `python -m deepspeed_tpu_torch.nvme --tune --path <dir>` keeps the
        # best sizing measured for this directory; it overrides the arguments
        tuned = tuned_defaults(swap_dir)
        if tuned is not None:
            num_threads, queue_depth, stripe_bytes = tuned
        self.handle = self.lib.ds_aio_create_ex(num_threads, queue_depth, stripe_bytes)
        self.using_uring = bool(self.lib.ds_aio_using_uring(self.handle))
        self.counters: Dict[str, Any] = {
            "backend": "io_uring" if self.using_uring else "threads",
            "threads": int(num_threads), "queue_depth": int(queue_depth),
            "stripe_bytes": int(stripe_bytes), "reads": 0, "writes": 0,
            "read_bytes": 0, "write_bytes": 0, "syncs": 0, "errors": 0}
        # op:name → (tensor, fd, path): the tensor stays alive until the wait
        self._pending: Dict[str, Tuple[torch.Tensor, int, str]] = {}
        self._meta: Dict[str, Tuple[tuple, torch.dtype]] = {}

    def _path(self, name: str) -> str:
        return os.path.join(self.swap_dir, f"{name.replace('/', '_')}.swp")

    def swap_out(self, name: str, tensor: torch.Tensor) -> None:
        """Queue a write of `tensor` (copied to the host first if it lies on
        the card) to `name`'s swap file."""
        host = tensor.detach().to("cpu").contiguous()
        path = self._path(name)
        fd = self.lib.ds_aio_open(path.encode(), 1)
        if fd < 0:
            raise SwapIOError("open", path, expected=_nbytes(host),
                              detail="ds_aio_open failed for write")
        self.lib.ds_aio_pwrite(self.handle, fd, host.data_ptr(), _nbytes(host), 0)
        self._pending[f"w:{name}"] = (host, fd, path)
        self._meta[name] = (tuple(host.shape), host.dtype)
        self.counters["writes"] += 1
        self.counters["write_bytes"] += _nbytes(host)

    def swap_in(self, name: str, shape=None, dtype: Optional[torch.dtype] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Queue a read of `name` into `out` (a contiguous host tensor), or
        into a new one of `shape` and `dtype` (by default those written),
        page-locked when CUDA is up. Returns the tensor, which holds the data
        after `synchronize()`. A missing or short swap file raises here."""
        if out is None:
            if shape is None:
                shape, dtype = self._meta[name]
            out = torch.empty(shape, dtype=dtype, pin_memory=torch.cuda.is_available())
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("swap_in reads into a contiguous host tensor")
        path = self._path(name)
        want = _nbytes(out)
        try:
            size = os.path.getsize(path)
        except OSError:
            raise SwapIOError("read", path, expected=want, detail="swap file missing")
        if size < want:
            raise SwapIOError("read", path, offset=size, expected=want, available=size,
                              detail="short swap file (truncated write?)")
        fd = self.lib.ds_aio_open(path.encode(), 0)
        if fd < 0:
            raise SwapIOError("open", path, expected=want, available=size,
                              detail="ds_aio_open failed for read")
        self.lib.ds_aio_pread(self.handle, fd, out.data_ptr(), want, 0)
        self._pending[f"r:{name}"] = (out, fd, path)
        self.counters["reads"] += 1
        self.counters["read_bytes"] += want
        return out

    def synchronize(self) -> None:
        """Wait for every queued request. The engine returns only a count of
        failures; on one, the pending files are examined to name the
        request that broke (a read past a file's end first)."""
        errors = self.lib.ds_aio_wait(self.handle)
        pending = list(self._pending.items())
        for _, (_, fd, _) in pending:
            self.lib.ds_aio_close(fd)
        self._pending.clear()
        self.counters["syncs"] += 1
        if not errors:
            return
        self.counters["errors"] += int(errors)
        for key, (t, _, path) in pending:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if key.startswith("r:") and size < _nbytes(t):
                raise SwapIOError("read", path, offset=size, expected=_nbytes(t),
                                  available=size, detail=f"{errors} request(s) failed")
        raise SwapIOError("io", pending[0][1][2] if pending else self.swap_dir,
                          detail=f"{errors} request(s) failed among "
                                 f"{[f'{k} -> {p}' for k, (_, _, p) in pending]}")

    def swap_out_tree(self, prefix: str, tree) -> None:
        """Every tensor of nested dicts, out under `{prefix}_{i}`."""
        for i, leaf in enumerate(_leaves(tree)):
            self.swap_out(f"{prefix}_{i}", leaf)

    def swap_in_tree(self, prefix: str, tree_like):
        """The tree `swap_out_tree` wrote, read back into new host tensors
        shaped like `tree_like`'s leaves; waits for the reads."""
        counter = iter(range(1 << 62))

        def read(leaf):
            return self.swap_in(f"{prefix}_{next(counter)}", tuple(leaf.shape), leaf.dtype)

        tree = _map(read, tree_like)
        self.synchronize()
        return tree

    def __del__(self):
        try:
            self.lib.ds_aio_destroy(self.handle)
        except Exception:
            pass


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
