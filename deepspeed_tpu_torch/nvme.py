"""Read and write bandwidth of the aio engine on a path (counterpart of ``deepspeed_tpu/nvme.py``).

Sizes the NVMe tier of capacity serving (`capacity: {"nvme_dir",
"nvme_layers"}`): one file of `mb` MiB written and read back in `block_mb`
requests, each striped into `stripe_mb` sub-operations, through page-locked
host memory when CUDA is up. The engine opens files without `O_DIRECT`, so a
read of a file written a moment before comes from the page cache (warm).

    python -m deepspeed_tpu_torch.nvme --path /mnt/nvme --mb 256 --threads 4
    python -m deepspeed_tpu_torch.nvme --path /mnt/nvme --tune

`--tune` sweeps threads × stripe and keeps the best read sizing in
`<path>/ds_aio_tune.json`, which `AsyncTensorSwapper` then uses for that
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

TUNE_FILE = "ds_aio_tune.json"


def sweep(path: str, mb: int = 64, threads: int = 4, queue_depth: int = 32,
          block_mb: int = 8, stripe_mb: int = 8) -> dict:
    """Write then read one `mb` MiB file under `path`; check the bytes read
    back; remove the file. Returns GB/s both ways and the engine's
    backend ("io_uring" or "threads")."""
    from deepspeed_tpu_torch.op_builder import AIO_LIBRARY
    from deepspeed_tpu_torch.runtime.swap_tensor import SwapIOError
    lib = AIO_LIBRARY.lib()
    h = lib.ds_aio_create_ex(threads, queue_depth, stripe_mb << 20)
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, "ds_aio_perf.bin")
    nbytes, block = mb << 20, block_mb << 20
    pin = torch.cuda.is_available()
    buf = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    if pin:
        buf = buf.pin_memory()
    out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    try:
        rates = {}
        for op, tensor, flag in (("write", buf, 1), ("read", out, 0)):
            fd = lib.ds_aio_open(fname.encode(), flag)
            if fd < 0:
                raise SwapIOError("open", fname, expected=nbytes, detail=f"for {op}")
            submit = lib.ds_aio_pwrite if flag else lib.ds_aio_pread
            t0 = time.perf_counter()
            for off in range(0, nbytes, block):
                submit(h, fd, tensor.data_ptr() + off, min(block, nbytes - off), off)
            errors = lib.ds_aio_wait(h)
            seconds = time.perf_counter() - t0
            lib.ds_aio_close(fd)
            if errors:
                raise SwapIOError(op, fname, expected=nbytes,
                                  available=os.path.getsize(fname),
                                  detail=f"{errors} request(s) failed")
            rates[f"{op}_GBps"] = nbytes / seconds / 1e9
        backend = "io_uring" if lib.ds_aio_using_uring(h) else "threads"
    finally:
        lib.ds_aio_destroy(h)
        if os.path.exists(fname):
            os.unlink(fname)
    if not torch.equal(out, buf):
        bad = int((out != buf).nonzero()[0, 0])
        raise SwapIOError("read", fname, offset=bad, expected=nbytes, available=bad,
                          detail="read-back mismatch")
    return {**rates, "size_mb": mb, "threads": threads, "stripe_mb": stripe_mb,
            "queue_depth": queue_depth, "backend": backend}


def tune(path: str, mb: int = 256) -> dict:
    """Sweep (threads × stripe) and keep the best read sizing in
    `<path>/ds_aio_tune.json`. Under io_uring the thread count is unused,
    so one is tried a stripe."""
    best = None
    thread_opts = (2, 4, 8)
    for stripe_mb in (4, 8, 16):
        for threads in thread_opts:
            r = sweep(path, mb=mb, threads=threads, stripe_mb=stripe_mb)
            if best is None or r["read_GBps"] > best["read_GBps"]:
                best = r
            if r["backend"] == "io_uring":
                thread_opts = (threads,)
                break
    with open(os.path.join(path, TUNE_FILE), "w") as f:
        json.dump(best, f)
    return best


def tuned_defaults(path: str):
    """(threads, queue_depth, stripe_bytes) kept by `tune` for `path`, or
    None. A file that does not parse is ignored with a warning."""
    p = os.path.join(path, TUNE_FILE)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            t = json.load(f)
        return int(t["threads"]), int(t.get("queue_depth", 32)), int(t["stripe_mb"]) << 20
    except (OSError, ValueError, KeyError, TypeError) as e:
        from deepspeed_tpu_torch.utils.logging import logger
        logger.warning(f"nvme: ignoring the unreadable tune file {p} ({type(e).__name__}: "
                       f"{e}); run `python -m deepspeed_tpu_torch.nvme --tune` again")
        return None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--path", default="ds_nvme_perf")
    p.add_argument("--mb", type=int, default=64)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--block_mb", type=int, default=8)
    p.add_argument("--stripe_mb", type=int, default=8)
    p.add_argument("--tune", action="store_true",
                   help="sweep threads x stripe and keep the best sizing for the path")
    args = p.parse_args()
    if args.tune:
        print(tune(args.path, args.mb))
    else:
        print(sweep(args.path, args.mb, args.threads, block_mb=args.block_mb,
                    stripe_mb=args.stripe_mb))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
