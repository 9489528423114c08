"""Pluggable checkpoint engines (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine.py``).

A checkpoint engine writes and reads one file: a tree (dicts, lists,
numbers, strings) of tensors. `TorchCheckpointEngine` is `torch.save`,
synced to disk, and `torch.load(weights_only=True, mmap=True)`, so a load
maps the file and reads a tensor's bytes only when it is used.
`AsyncCheckpointEngine` (alias `NebulaCheckpointEngine`, as in the JAX
package) writes on a background thread; `commit` or `wait` joins the
writes. The training engine updates
its state in place (`runtime/engine.py`), so the async `save` copies every
tensor to host memory before it returns: the file holds the values of the
call, whatever the steps after it do.
"""

from __future__ import annotations

import abc
import os
import threading
from typing import Any, List, Optional

import torch


class CheckpointEngine(abc.ABC):
    def __init__(self, config_params=None):
        pass

    def create(self, tag: str):
        """Notify the start of a new checkpoint."""

    @abc.abstractmethod
    def save(self, state_dict: Any, path: str): ...

    @abc.abstractmethod
    def load(self, path: str, map_location=None): ...

    def commit(self, tag: str) -> bool:
        """Every `save` of the checkpoint `tag` is on disk."""
        return True


class TorchCheckpointEngine(CheckpointEngine):
    """`torch.save`, and `torch.load(weights_only=True, mmap=True)`. A save
    returns once the file is on disk (`fsync`), not only in the page
    cache. It writes no CRC-32 of the records: `torch.load` never reads
    it, and computing it is a single-threaded pass over every byte."""

    def save(self, state_dict: Any, path: str):
        from torch.utils.serialization import config
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with config.patch({"save.compute_crc32": False}):
            torch.save(state_dict, path)
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def load(self, path: str, map_location=None):
        return torch.load(path, map_location=map_location or "cpu", weights_only=True,
                          mmap=True)


def host_copy(tree: Any) -> Any:
    """`tree` with every tensor copied to host memory (a clone, also of a
    host tensor; a view copies only its own elements)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class AsyncCheckpointEngine(TorchCheckpointEngine):
    """`save` copies the tree to host memory and writes it on a thread of
    its own; `commit`/`wait` join the writes and raise a write's error."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    def save(self, state_dict: Any, path: str):
        snapshot = host_copy(state_dict)

        def write():
            try:
                TorchCheckpointEngine.save(self, snapshot, path)
            except BaseException as e:  # reported by wait()
                self._errors.append(e)

        thread = threading.Thread(target=write, name=f"checkpoint:{os.path.basename(path)}")
        thread.start()
        self._threads.append(thread)

    def wait(self) -> None:
        threads, self._threads = self._threads, []
        for t in threads:
            t.join()
        if self._errors:
            error, self._errors = self._errors[0], []
            raise error

    def commit(self, tag: Optional[str] = None) -> bool:
        self.wait()
        return True


NebulaCheckpointEngine = AsyncCheckpointEngine
