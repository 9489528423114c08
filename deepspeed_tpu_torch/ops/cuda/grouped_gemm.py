"""Grouped (ragged) expert GEMM and its backward (counterpart of ``deepspeed_tpu/ops/pallas/grouped_gemm.py``).

`grouped_gemm(lhs, rhs, group_sizes)` computes `out[rows of group g] =
lhs[rows of group g] @ rhs[g]` over rows sorted by group: for CUDA tensors
it launches the hand-written kernel `csrc/grouped_gemm.cu` (K6), for CPU
tensors it takes the plain version, `grouped_gemm_plain`. rhs is the (G, K,
N) expert stack as the parameter tree holds it, read with no transpose.
When grad mode is on and an operand requires grad, the call goes through
`GroupedGemm`, whose backward runs the two kernels of megablox `gmm`'s
VJP, from the same source: `grouped_gemm_dlhs` (dlhs = grad @ rhs[g]^T,
megablox `gmm(..., transpose_rhs=True)`) and `grouped_gemm_drhs` (drhs[g]
= lhs[rows of g]^T @ grad[rows of g], megablox `tgmm`; an empty group's
slab is zeros), each with its plain version for CPU tensors.

The JAX wrapper pads M up to its row tile and hands the pad rows to the
last group; the kernels mask the ragged edge of each tile instead, and the
outputs and the gradients of real rows are the same. `tiling` is the JAX
package's megablox tile choice: it is taken and ignored, since the kernels
pick their own tiles from M and G. The kernels read `group_sizes` on the
device, so a call makes no host sync.

`sharded_grouped_gemm(lhs, rhs_local, group_sizes, mesh)` is the
expert-parallel flavour (K8-e, the JAX `sharded_grouped_gemm`, :88): under
a topology whose `expert` axis has ep ranks, rhs_local holds this rank's
E/ep experts [rank·E/ep, (rank+1)·E/ep) and lhs and the E sizes are the
same on every rank. The kernel (the same source, given the rank's group
offset) computes that span's rows, bit for bit K6's rows for those experts,
and writes zeros in every other row; an all-reduce over `expert` then sums
the ranks, whose spans are disjoint, so the sum is K6's output exactly.
`reduce=False` leaves the rank's partial, for a caller that reduces once
after a chain of products (`moe/layer.Experts`). Its plain version,
`sharded_grouped_gemm_plain`, takes no collective. No backward is ported
under expert parallelism: the wrapper refuses grad mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.op_builder import KernelLibrary, refuse_grad
from deepspeed_tpu_torch.runtime.config_utils import unported

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("grouped_gemm.cu", {
    "ds_grouped_gemm": [_P] * 4 + [_I] * 6 + [_P],  # + group offset, local groups
    "ds_grouped_gemm_dlhs": [_P] * 4 + [_I] * 4 + [_P],
    "ds_grouped_gemm_drhs": [_P] * 5 + [_I] * 4 + [_P],  # + the split's f32 scratch
    "ds_grouped_gemm_drhs_scratch": [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)],
})


def _spans(group_sizes: torch.Tensor, m: int):
    """(group, first row, end row) of every group with rows, as the kernels
    place them: negative sizes count as 0, rows past M are cut."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        if end > start:
            yield g, start, end
        start = max(start, end)


def grouped_gemm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """The f32 loop over groups, cast to lhs's dtype. Reads the sizes on the
    host. Rows past the sum of the sizes are zero, as the kernel writes them."""
    out = torch.zeros((lhs.shape[0], rhs.shape[2]), dtype=torch.float32, device=lhs.device)
    for g, start, end in _spans(group_sizes, lhs.shape[0]):
        out[start:end] = lhs[start:end].float() @ rhs[g].float()
    return out.to(lhs.dtype)


def grouped_gemm_dlhs_plain(grad: torch.Tensor, rhs: torch.Tensor,
                            group_sizes: torch.Tensor) -> torch.Tensor:
    """dlhs (M, K) = per-group grad (M, N) @ rhs[g]^T in f32, cast to
    grad's dtype; rows past the sum of the sizes are zero."""
    out = torch.zeros((grad.shape[0], rhs.shape[1]), dtype=torch.float32, device=grad.device)
    for g, start, end in _spans(group_sizes, grad.shape[0]):
        out[start:end] = grad[start:end].float() @ rhs[g].float().T
    return out.to(grad.dtype)


def grouped_gemm_drhs_plain(lhs: torch.Tensor, grad: torch.Tensor,
                            group_sizes: torch.Tensor) -> torch.Tensor:
    """drhs (G, K, N) = per-group lhs[rows of g]^T @ grad[rows of g] in f32,
    cast to lhs's dtype; an empty group's slab is zero."""
    g_count = group_sizes.shape[0]
    out = torch.zeros((g_count, lhs.shape[1], grad.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    for g, start, end in _spans(group_sizes, lhs.shape[0]):
        out[g] = lhs[start:end].float().T @ grad[start:end].float()
    return out.to(lhs.dtype)


def _check(what, a, b, group_sizes):
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: operands must be bfloat16 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if group_sizes.dtype != torch.int32 or not group_sizes.is_contiguous():
        raise ValueError(f"{what}: group_sizes must be a contiguous int32 tensor")
    for t in (b, group_sizes):
        if t.device != a.device:
            raise ValueError(f"{what}: operands on {t.device} and {a.device}")


def _launch(fn_name, what, a, b, group_sizes, out, m, k, n, span=(), scratch=()):
    """`span` is the forward's (group offset, local groups), `scratch`
    drhs's f32 scratch pointer (None: no scratch)."""
    _check(what, a, b, group_sizes)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = getattr(LIBRARY.lib(), fn_name)(
            a.data_ptr(), b.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), *scratch,
            m, k, n, group_sizes.shape[0], *span, stream)
    LIBRARY.check(code, what)
    return out


def _device(what, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cuda"


def grouped_gemm_dlhs(grad: torch.Tensor, rhs: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """K6-bwd dlhs. grad (M, N) bf16, rhs (G, K, N) bf16, group_sizes (G,)
    int32 -> (M, K) in grad's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not _device("grouped_gemm_dlhs", grad):
        return grouped_gemm_dlhs_plain(grad, rhs, group_sizes)
    refuse_grad("grouped_gemm_dlhs", grad, rhs)
    m, n = grad.shape
    out = torch.empty((m, rhs.shape[1]), dtype=grad.dtype, device=grad.device)
    _launch("ds_grouped_gemm_dlhs", "grouped_gemm_dlhs", grad, rhs, group_sizes, out,
            m, rhs.shape[1], n)
    grouped_gemm_dlhs.launches += 1
    return out


grouped_gemm_dlhs.launches = 0


@functools.lru_cache(maxsize=64)
def _drhs_scratch_floats(m: int, k: int, n: int, g: int) -> int:
    """The f32 scratch drhs needs (the kernel's rule): the partials of the
    row ranges a group with many more rows than the mean is split into, at
    most about the size of the output; 0 when no group can be split."""
    floats = ctypes.c_longlong(0)
    LIBRARY.check(LIBRARY.lib().ds_grouped_gemm_drhs_scratch(m, k, n, g, ctypes.byref(floats)),
                  "grouped_gemm_drhs")
    return floats.value


def grouped_gemm_drhs(lhs: torch.Tensor, grad: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """K6-bwd drhs. lhs (M, K) bf16, grad (M, N) bf16, group_sizes (G,)
    int32 -> (G, K, N) in lhs's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not _device("grouped_gemm_drhs", lhs):
        return grouped_gemm_drhs_plain(lhs, grad, group_sizes)
    refuse_grad("grouped_gemm_drhs", lhs, grad)
    (m, k), n = lhs.shape, grad.shape[1]
    g = group_sizes.shape[0]
    out = torch.empty((g, k, n), dtype=lhs.dtype, device=lhs.device)
    floats = _drhs_scratch_floats(m, k, n, g)
    scratch = torch.empty(floats, dtype=torch.float32, device=lhs.device) if floats else None
    _launch("ds_grouped_gemm_drhs", "grouped_gemm_drhs", lhs, grad, group_sizes, out, m, k, n,
            scratch=(None if scratch is None else scratch.data_ptr(),))
    grouped_gemm_drhs.launches += 1
    return out


grouped_gemm_drhs.launches = 0


class GroupedGemm(torch.autograd.Function):
    """`grouped_gemm` with its gradient: dlhs and drhs, each only where an
    operand needs it."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return _grouped_gemm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = grouped_gemm_dlhs(grad, rhs, group_sizes).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = grouped_gemm_drhs(lhs, grad.to(lhs.dtype), group_sizes).to(rhs.dtype)
        return dlhs, drhs, None


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                 tiling: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """K6. lhs (M, K) bf16, rows sorted by group; rhs (G, K, N) bf16;
    group_sizes (G,) int32 on lhs's device, summing to M. Returns (M, N) in
    lhs's dtype, f32 accumulation. `tiling` is accepted for the JAX
    signature and ignored. Differentiable (`GroupedGemm`) when grad mode is
    on and lhs or rhs requires grad.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    del tiling
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"grouped_gemm: lhs {tuple(lhs.shape)} must be (M, K) and "
                         f"rhs {tuple(rhs.shape)} (G, K, N)")
    k, (g, k2, _) = lhs.shape[1], rhs.shape
    if k != k2:
        raise ValueError(f"grouped_gemm: lhs K={k} vs rhs K={k2}")
    if tuple(group_sizes.shape) != (g,):
        raise ValueError(f"grouped_gemm: group_sizes {tuple(group_sizes.shape)} != ({g},)")
    _device("grouped_gemm", lhs)
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return GroupedGemm.apply(lhs, rhs, group_sizes)
    return _grouped_gemm(lhs, rhs, group_sizes)


def _grouped_gemm(lhs, rhs, group_sizes, group_offset: int = 0):
    """K6; on CUDA, over rhs's groups [group_offset, group_offset +
    rhs.shape[0]) of the sizes' G (all of them for K6) with zeros in every
    other row (K8-e's launch)."""
    if lhs.device.type == "cpu":
        return grouped_gemm_plain(lhs, rhs, group_sizes)
    (m, k), n = lhs.shape, rhs.shape[2]
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    _launch("ds_grouped_gemm", "grouped_gemm", lhs, rhs, group_sizes, out, m, k, n,
            span=(group_offset, rhs.shape[0]))
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0


def sharded_grouped_gemm_plain(lhs: torch.Tensor, rhs_local: torch.Tensor,
                               group_sizes: torch.Tensor, group_offset: int) -> torch.Tensor:
    """One expert rank's partial of K8-e: the f32 loop over its local groups
    [group_offset, group_offset + rhs_local.shape[0]) of the sizes, cast to
    lhs's dtype; every other row is zero. No collective."""
    out = torch.zeros((lhs.shape[0], rhs_local.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    local = range(group_offset, group_offset + rhs_local.shape[0])
    for g, start, end in _spans(group_sizes, lhs.shape[0]):
        if g in local:
            out[start:end] = lhs[start:end].float() @ rhs_local[g - group_offset].float()
    return out.to(lhs.dtype)


def expert_offset(what: str, num_groups: int, local_groups: int, mesh) -> int:
    """This rank's first expert under `mesh`'s `expert` axis, after checking
    that the E groups divide over it and that the rank holds E/ep of them."""
    ep, rank = mesh.axis_size("expert"), mesh.coord("expert")
    if num_groups % ep:
        raise ValueError(f"{what}: {num_groups} experts not divisible by expert={ep}")
    if local_groups != num_groups // ep:
        raise ValueError(f"{what}: the rank holds {local_groups} experts, not its share "
                         f"{num_groups // ep} of {num_groups} over expert={ep}")
    return rank * local_groups


def sharded_grouped_gemm(lhs: torch.Tensor, rhs_local: torch.Tensor,
                         group_sizes: torch.Tensor, mesh, reduce: bool = True) -> torch.Tensor:
    """K8-e. lhs (M, K) bf16, rows sorted by expert, the same on every
    rank; rhs_local (E/ep, K, N) bf16, this rank's experts; group_sizes
    (E,) int32 over all E; `mesh` the topology (its `expert` axis and
    device). Returns (M, N) in lhs's dtype: K6's output, all-reduced over
    `expert` (the rank's partial with `reduce=False`).

    A CPU tensor takes the plain version, except under a topology whose
    device is CUDA, where it raises; a CUDA tensor launches the kernel or
    raises. Refuses grad mode (no backward under expert parallelism)."""
    from deepspeed_tpu_torch import comm
    what = "sharded_grouped_gemm"
    if lhs.dim() != 2 or rhs_local.dim() != 3 or lhs.shape[1] != rhs_local.shape[1]:
        raise ValueError(f"{what}: lhs {tuple(lhs.shape)} must be (M, K) and rhs_local "
                         f"{tuple(rhs_local.shape)} (E/ep, K, N)")
    if group_sizes.dim() != 1:
        raise ValueError(f"{what}: group_sizes {tuple(group_sizes.shape)} must be (E,)")
    offset = expert_offset(what, group_sizes.shape[0], rhs_local.shape[0], mesh)
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs_local.requires_grad):
        raise unported(f"the gradient of {what} (training under expert parallelism)",
                       "Multi-GPU")
    cuda = _device(what, lhs)
    if not cuda and mesh.device is not None and mesh.device.type == "cuda":
        raise ValueError(f"{what}: the topology serves {mesh.device} and lhs is on "
                         f"{lhs.device}; a per-shard call runs on the rank's card")
    if cuda:
        out = _grouped_gemm(lhs, rhs_local, group_sizes, offset)
        sharded_grouped_gemm.launches += 1
    else:
        out = sharded_grouped_gemm_plain(lhs, rhs_local, group_sizes, offset)
    return comm.all_reduce(out, group="expert") if reduce else out


sharded_grouped_gemm.launches = 0
