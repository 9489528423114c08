"""K6's plain version held against the JAX package's grouped GEMM on the CPU.

`grouped_gemm_plain` (what the port's wrapper runs on a CPU tensor) against
`deepspeed_tpu.ops.pallas.grouped_gemm.grouped_gemm`, whose megablox `gmm`
runs in Pallas interpret mode on the CPU, on the same numpy inputs in f32:
1e-5. Layouts: empty groups first, in the middle and last, one group
holding every row, M not a multiple of 16, with the 16-row tiling of the
JAX tests and the default one, a skewed routing (one group of 60 holds a
quarter of the rows: the card's drhs splits such a group) and a group of
more than 256 rows (the card's forward row tile). The megablox calls are
few and small: each takes seconds in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.grouped_gemm import grouped_gemm as jax_grouped_gemm
from deepspeed_tpu_torch.ops.cuda.grouped_gemm import grouped_gemm, grouped_gemm_plain

TOL = 1e-5
# 2,048 rows over 60 groups, the eighth holding 512 of them
SKEWED = np.insert(np.bincount(np.random.default_rng(0).integers(0, 59, 1536), minlength=59),
                   7, 512).tolist()


@pytest.mark.parametrize("sizes,k,n,tiling", [
    ([0, 13, 0, 40, 7, 0], 24, 40, (16, 16, 16)),   # empty first, middle, last; M = 60
    ([0, 13, 0, 40, 7, 0], 24, 40, None),
    ([0, 0, 37, 0], 16, 24, (16, 16, 16)),           # one group holds every row; M = 37
    ([5, 9, 1, 22], 32, 8, None),                   # M = 37, N narrower than a tile
    (SKEWED, 16, 24, None),                         # skewed; M = 2048 over 60
    ([300, 600, 37], 24, 16, (128, 128, 128)),      # a group of more than 256 rows
])
def test_grouped_gemm_plain_matches_jax(sizes, k, n, tiling):
    rng = np.random.default_rng(sum(sizes) + k + n)
    m = int(np.sum(sizes))
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    ref = np.asarray(jax_grouped_gemm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs),
                                      tiling=tiling))
    launches = grouped_gemm.launches
    got = grouped_gemm(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(gs),
                       tiling=tiling)
    assert grouped_gemm.launches == launches   # the plain version is no launch
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_grouped_gemm_plain_is_the_per_group_product():
    """Without JAX: each group's rows times its expert; rows past the sum of
    the sizes are zero; the result keeps lhs's dtype."""
    rng = np.random.default_rng(3)
    lhs = torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((3, 6, 5)).astype(np.float32))
    out = grouped_gemm_plain(lhs.bfloat16(), rhs.bfloat16(), torch.tensor([4, 0, 5]))
    assert out.dtype == torch.bfloat16
    ref = torch.cat([lhs[:4].bfloat16().float() @ rhs[0].bfloat16().float(),
                     lhs[4:9].bfloat16().float() @ rhs[2].bfloat16().float()]).bfloat16()
    torch.testing.assert_close(out[:9], ref)
    assert (out[9:] == 0).all()


def test_grouped_gemm_refuses_other_devices_and_shapes():
    lhs, rhs = torch.zeros(4, 8), torch.zeros(2, 8, 3)
    gs = torch.tensor([1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_gemm(lhs.to("meta"), rhs.to("meta"), gs.to("meta"))
    with pytest.raises(ValueError, match="K="):
        grouped_gemm(lhs, torch.zeros(2, 7, 3), gs)
    with pytest.raises(ValueError, match="group_sizes"):
        grouped_gemm(lhs, rhs, torch.tensor([4], dtype=torch.int32))
