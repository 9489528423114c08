"""K6's backward held against the JAX package's grouped GEMM gradient on the CPU.

The plain versions of the two backward kernels, `grouped_gemm_dlhs_plain`
(grad @ rhs[g]^T, megablox `gmm(..., transpose_rhs=True)`) and
`grouped_gemm_drhs_plain` (lhs[rows of g]^T @ grad[rows of g], megablox
`tgmm`), and `grouped_gemm` in grad mode (the `GroupedGemm` autograd
Function, whose CPU backward takes those plain versions), against
`jax.vjp` of `deepspeed_tpu.ops.pallas.grouped_gemm.grouped_gemm`, whose
megablox kernels run in Pallas interpret mode, on the same numpy inputs in
f32: 1e-5. Layouts: empty groups first, in the middle and last (their drhs
slab is zero), one group holding every row, M = 5, and M not a multiple of
16, where the JAX wrapper pads M to its tile and hands the pad rows to the
last group while the port masks: the gradients of the real rows must not
change. Also a skewed routing (one group of 60 holds a quarter of the rows:
the card's drhs splits such a group over row ranges) and a group of more
than 256 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.grouped_gemm import grouped_gemm as jax_grouped_gemm
from deepspeed_tpu_torch.ops.cuda.grouped_gemm import (
    GroupedGemm,
    grouped_gemm,
    grouped_gemm_dlhs,
    grouped_gemm_dlhs_plain,
    grouped_gemm_drhs,
    grouped_gemm_drhs_plain,
)

TOL = 1e-5
# 2,048 rows over 60 groups, the eighth holding 512 of them
SKEWED = np.insert(np.bincount(np.random.default_rng(0).integers(0, 59, 1536), minlength=59),
                   7, 512).tolist()

CASES = {   # group sizes, K, N, JAX tiling
    "empty_first_middle_last": ([0, 13, 0, 40, 7, 0], 24, 40, (16, 16, 16)),
    "one_group_all_rows": ([0, 0, 37, 0], 16, 24, (16, 16, 16)),
    "m5": ([2, 0, 3], 8, 12, None),
    "m_not_multiple_of_16": ([5, 9, 1, 22], 32, 8, None),
    "skewed_60_groups": (SKEWED, 16, 24, None),
    "group_over_256_rows": ([300, 600, 37], 24, 16, (128, 128, 128)),
}


def _inputs(sizes, k, n, seed):
    rng = np.random.default_rng(seed)
    m = int(np.sum(sizes))
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    grad = rng.standard_normal((m, n)).astype(np.float32)
    return lhs, rhs, grad, np.asarray(sizes, np.int32)


def _jax_vjp(lhs, rhs, grad, gs, tiling):
    _, vjp = jax.vjp(lambda a, b: jax_grouped_gemm(a, b, jnp.asarray(gs), tiling=tiling),
                     jnp.asarray(lhs), jnp.asarray(rhs))
    dlhs, drhs = vjp(jnp.asarray(grad))
    return np.asarray(dlhs), np.asarray(drhs)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_versions_and_function_match_jax_vjp(case):
    sizes, k, n, tiling = CASES[case]
    lhs, rhs, grad, gs = _inputs(sizes, k, n, len(case))
    ref_dlhs, ref_drhs = _jax_vjp(lhs, rhs, grad, gs, tiling)
    tl, tr, tg, tgs = (torch.from_numpy(x) for x in (lhs, rhs, grad, gs))

    np.testing.assert_allclose(grouped_gemm_dlhs_plain(tg, tr, tgs).numpy(), ref_dlhs,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grouped_gemm_drhs_plain(tl, tg, tgs).numpy(), ref_drhs,
                               rtol=TOL, atol=TOL)

    launches = (grouped_gemm.launches, grouped_gemm_dlhs.launches, grouped_gemm_drhs.launches)
    a, b = tl.clone().requires_grad_(), tr.clone().requires_grad_()
    out = grouped_gemm(a, b, tgs, tiling=tiling)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "GroupedGemmBackward"
    out.backward(tg)
    assert (grouped_gemm.launches, grouped_gemm_dlhs.launches,
            grouped_gemm_drhs.launches) == launches   # the plain versions are no launch
    np.testing.assert_allclose(a.grad.numpy(), ref_dlhs, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b.grad.numpy(), ref_drhs, rtol=TOL, atol=TOL)
    for g in np.flatnonzero(gs == 0):
        assert (b.grad[g] == 0).all()


def test_function_computes_only_the_gradients_asked_for():
    """With only rhs requiring grad, lhs gets none (dlhs is not computed),
    and the wrappers dispatch a CPU tensor to the plain version."""
    lhs, rhs, grad, gs = _inputs([3, 0, 4], 6, 5, 1)
    tl, tr, tg, tgs = (torch.from_numpy(x) for x in (lhs, rhs, grad, gs))
    b = tr.clone().requires_grad_()
    GroupedGemm.apply(tl, b, tgs).backward(tg)
    assert tl.grad is None and b.grad is not None
    torch.testing.assert_close(grouped_gemm_dlhs(tg, tr, tgs), grouped_gemm_dlhs_plain(tg, tr, tgs))
    torch.testing.assert_close(grouped_gemm_drhs(tl, tg, tgs), grouped_gemm_drhs_plain(tl, tg, tgs))
    with torch.no_grad():
        assert grouped_gemm(tl, b, tgs).grad_fn is None


def test_plain_versions_are_the_per_group_products():
    """Without JAX: rows past the sum of the sizes get zero dlhs and add
    nothing to drhs; dtypes follow grad (dlhs) and lhs (drhs)."""
    rng = np.random.default_rng(4)
    lhs = torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32)).bfloat16()
    rhs = torch.from_numpy(rng.standard_normal((3, 6, 5)).astype(np.float32)).bfloat16()
    grad = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32)).bfloat16()
    gs = torch.tensor([4, 0, 5])
    dlhs = grouped_gemm_dlhs_plain(grad, rhs, gs)
    drhs = grouped_gemm_drhs_plain(lhs, grad, gs)
    assert dlhs.dtype == drhs.dtype == torch.bfloat16
    assert (dlhs[9:] == 0).all() and (drhs[1] == 0).all()
    torch.testing.assert_close(dlhs[:4], (grad[:4].float() @ rhs[0].float().T).bfloat16())
    torch.testing.assert_close(drhs[2], (lhs[4:9].float().T @ grad[4:9].float()).bfloat16())
