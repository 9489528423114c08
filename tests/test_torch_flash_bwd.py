"""The port's flash-attention backward held against the JAX package's.

`flash_attention_bwd_plain` (the plain version of the K1-bwd kernels) gets
the same numpy q, k, v and dO as `jax.vjp` of the JAX `flash_attention`,
whose backward Pallas kernels run in interpret mode with 16-row tiles, so
the triangular grid (Sq == Sk) and the rectangular one (Sq < Sk, and no
mask) both run over several tiles, at every head dim the kernels are
built for (64, 80, 128, 256). In fp32 the gradients agree to
1e-5 x max(1, max |ref|). The `FlashAttention` Function's gradients on the
CPU are held to autograd through `reference_attention` at 1e-4, and the
masked attention paths stay differentiable, as in the JAX package.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.ops import attention as jax_attention  # noqa: E402
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from deepspeed_tpu_torch.ops import attention as port_attention  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.flash_attention import (  # noqa: E402
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)

TOL = 1e-5
BLOCK = 16

# (causal, sq, sk): the tri grid (sq == sk), the rect grid with an offset
# (sq < sk), and no mask
CASES = [(True, 64, 64), (True, 32, 64), (False, 32, 48)]


def _inputs(seed, sq, sk, h, hkv, d, b=1):
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("causal,sq,sk", CASES)
def test_flash_bwd_plain_matches_jax_vjp(causal, sq, sk, n_rep, d):
    q, k, v, do = _inputs(sq + sk + n_rep + d, sq, sk, 4, 4 // n_rep, d)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, causal=causal,
                                                  block_q=BLOCK, block_k=BLOCK),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_fwd_plain(tq, tk, tv, causal)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(r).max())), err_msg=name)


@pytest.mark.parametrize("causal,sq,sk", CASES)
def test_flash_function_grads_match_reference_autograd(causal, sq, sk):
    """Autograd through `FlashAttention` on the CPU (the plain forward and
    backward) against autograd through the masked reference attention."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, sq, sk, 8, 2, 32, b=2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(port_attention.reference_attention(*ref_leaves, causal=causal),
                              ref_leaves, do)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl,window", [("reference", None), ("reference", 5),
                                         ("blockwise", 5), ("pallas", None)])
def test_attention_grads_match_jax(impl, window):
    """`attention` stays differentiable on every path: the masked ones
    through plain autograd, the flash one through `FlashAttention`; the
    gradients match `jax.grad` of the JAX package's `attention`."""
    q, k, v, do = _inputs(6, 24, 24, 4, 2, 16, b=2)
    kw = dict(causal=True, impl=impl, window=window)

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_attention.attention(q_, k_, v_, **kw) * jnp.asarray(do))
    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(port_attention.attention(*leaves, **kw), leaves,
                              torch.from_numpy(do))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_cpu_backward_launches_nothing():
    """On the CPU the backward takes the plain version and counts no launch;
    without grad mode `flash_attention` does not build a graph."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(0, 16, 16, 2, 1, 64))
    counters = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [fn.launches for fn in counters]
    out, lse = flash_attention_fwd(q, k, v)
    flash_attention_bwd(q, k, v, out, lse, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttention.apply(*leaves, True, None).sum().backward()
    with torch.no_grad():
        assert flash_attention(*leaves).grad_fn is None
    assert [fn.launches for fn in counters] == before
