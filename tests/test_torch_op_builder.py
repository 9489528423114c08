"""The port's kernel builder (`deepspeed_tpu_torch/op_builder/builder.py`).

A library's file name carries the hash of its source and of the local
headers the source includes, so an edited header is rebuilt rather than
loaded stale. Nothing here calls `nvcc`.
"""

from deepspeed_tpu_torch.op_builder import KernelLibrary


def test_library_name_follows_included_headers(tmp_path):
    header = tmp_path / "common.cuh"
    header.write_text("// one\n")
    source = tmp_path / "kernel.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "common.cuh"\nint x;\n')
    lib = KernelLibrary("kernel.cu", {})
    lib.source = source
    first = lib.library_path()
    header.write_text("// two\n")
    assert lib.library_path() != first
    header.write_text("// one\n")
    assert lib.library_path() == first
    source.write_text('#include <cuda_runtime.h>\n#include "common.cuh"\nint y;\n')
    assert lib.library_path() != first



def test_library_name_follows_headers_included_by_headers(tmp_path):
    """A header included only by another local header (the flash sources'
    `flash_attention_common.cuh` includes `hopper_common.cuh`) is hashed
    too, and a header included twice is read once."""
    (tmp_path / "base.cuh").write_text("// one\n")
    (tmp_path / "mid.cuh").write_text('#pragma once\n#include "base.cuh"\n')
    source = tmp_path / "kernel.cu"
    source.write_text('#include "mid.cuh"\n#include "base.cuh"\nint x;\n')
    lib = KernelLibrary("kernel.cu", {})
    lib.source = source
    first = lib.library_path()
    (tmp_path / "base.cuh").write_text("// two\n")
    assert lib.library_path() != first
    (tmp_path / "base.cuh").write_text("// one\n")
    assert lib.library_path() == first
