"""The port's MoE gating and dispatches held against the JAX package's on the CPU.

Logits, tokens and expert weights are made with numpy from a seed and
handed to both packages, in f32. Gating must choose the same experts,
positions and kept flags exactly, with weights and the aux loss to 1e-6;
the combine tensors and the three dispatches (einsum, ragged buffer,
expert-sorted rows through the grouped GEMM, whose JAX side runs megablox
in interpret mode) agree to 1e-5, with drops on and off. The `auto` rule
picks the same dispatch for (train, b·s·k) on both sides of 1024.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.moe import sharded_moe as jax_moe
from deepspeed_tpu.ops.pallas.grouped_gemm import grouped_gemm as jax_grouped_gemm
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.groups import MeshTopology
from deepspeed_tpu_torch.moe import sharded_moe as moe
from deepspeed_tpu_torch.moe.layer import MoE, choose_dispatch
from deepspeed_tpu_torch.ops.cuda.grouped_gemm import grouped_gemm

TOL = 1e-5
T, D, F_, E = 48, 16, 24, 6


@pytest.mark.parametrize("args", [(64, 8, 1.0, 4, 1), (64, 8, 1.25, 4, 2), (7, 60, 1.0, 4, 4),
                                  (512, 60, 1.25, 4, 4), (3, 4, 2.0, 8, 2)])
def test_capacity_matches_jax(args):
    assert moe._capacity(*args) == jax_moe._capacity(*args)


def _logits(seed, t=T, e=E):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_gating_core_matches_jax(k, drop, norm):
    logits = _logits(10 + k)
    ref = jax_moe._gating_core(jnp.asarray(logits), k, 1.0, 4, drop, None, None, norm)
    got = moe._gating_core(torch.from_numpy(logits), k, 1.0, 4, drop, None, None, norm)
    l_aux, gate_k, idx, pos, kept, masks, cap = got
    assert cap == ref[6]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref[5]))
    np.testing.assert_allclose(gate_k.numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(l_aux), float(ref[0]), rtol=1e-6)
    if drop and k > 1:
        assert (kept.numpy() == 0).any()   # the capacity limit drops some slots


@pytest.mark.parametrize("drop", [False, True])
def test_topkgating_matches_jax(drop):
    logits = _logits(20)
    l_aux, combine, dispatch, cap = jax_moe.topkgating(jnp.asarray(logits), 2, 1.0, 4, drop)
    got = moe.topkgating(torch.from_numpy(logits), 2, 1.0, 4, drop)
    assert got[3] == cap
    np.testing.assert_allclose(got[1].numpy(), np.asarray(combine), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(dispatch))
    np.testing.assert_allclose(float(got[0]), float(l_aux), rtol=1e-6)


def _experts(seed):
    rng = np.random.default_rng(seed)
    w = {name: (0.2 * rng.standard_normal(shape)).astype(np.float32) for name, shape in
         (("gate", (E, D, F_)), ("up", (E, D, F_)), ("down", (E, F_, D)))}
    jw = {n: jnp.asarray(v) for n, v in w.items()}
    tw = {n: torch.from_numpy(v) for n, v in w.items()}

    def jax_batched(x):
        h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", x, jw["gate"])) * \
            jnp.einsum("ecd,edf->ecf", x, jw["up"])
        return jnp.einsum("ecf,efd->ecd", h, jw["down"])

    def jax_grouped(x, gs):
        h = jax.nn.silu(jax_grouped_gemm(x, jw["gate"], gs)) * jax_grouped_gemm(x, jw["up"], gs)
        return jax_grouped_gemm(h, jw["down"], gs)

    def torch_batched(x):
        h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", x, tw["gate"])) * \
            torch.einsum("ecd,edf->ecf", x, tw["up"])
        return torch.einsum("ecf,efd->ecd", h, tw["down"])

    def torch_grouped(x, gs):
        h = torch.nn.functional.silu(grouped_gemm(x, tw["gate"], gs)) * \
            grouped_gemm(x, tw["up"], gs)
        return grouped_gemm(h, tw["down"], gs)

    return jax_batched, jax_grouped, torch_batched, torch_grouped


@pytest.mark.parametrize("impl", ["einsum", "ragged", "gmm"])
@pytest.mark.parametrize("drop", [False, True])
def test_dispatches_match_jax(impl, drop):
    """Each dispatch on the same gating decisions: 1e-5 against JAX. With
    drops, the gmm path computes the dropped slots and weights them 0."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((T, D)).astype(np.float32)
    logits = _logits(31)
    jax_batched, jax_grouped, torch_batched, torch_grouped = _experts(32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if impl == "einsum":
        _, combine, dispatch, _ = jax_moe.topkgating(jnp.asarray(logits), 2, 1.0, 4, drop)
        ref = jax_moe.dispatch_combine(jx, combine, dispatch, jax_batched)
        _, combine, dispatch, _ = moe.topkgating(torch.from_numpy(logits), 2, 1.0, 4, drop)
        got = moe.dispatch_combine(tx, combine, dispatch, torch_batched)
    else:
        _, gk, idx, pos, kept, cap = jax_moe.topkgating_ragged(jnp.asarray(logits), 2, 1.0, 4,
                                                               drop)
        _, tgk, tidx, tpos, tkept, tcap = moe.topkgating_ragged(torch.from_numpy(logits), 2,
                                                                1.0, 4, drop)
        if impl == "ragged":
            ref = jax_moe.dispatch_combine_ragged(jx, gk, idx, pos, kept, cap, E, jax_batched)
            got = moe.dispatch_combine_ragged(tx, tgk, tidx, tpos, tkept, tcap, E,
                                              torch_batched)
        else:
            ref = jax_moe.dispatch_combine_gmm(jx, gk, idx, E, jax_grouped)
            got = moe.dispatch_combine_gmm(tx, tgk, tidx, E, torch_grouped)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("train,s", [(False, 512), (False, 511), (True, 512), (True, 1024)])
def test_auto_dispatch_matches_jax_rule(monkeypatch, train, s):
    """On a one-device JAX mesh `auto` takes the grouped GEMM for inference
    at b·s·k ≥ 1024 rows (k = 2 here) and the ragged buffer otherwise; the
    port's choice is the same, and its `MoE` runs the dispatch it names."""
    groups.initialize(MeshTopology(devices=jax.devices()[:1]))
    seen = []

    def recorder(name):
        def fn(x, *args):
            seen.append(name)
            return jnp.zeros_like(x)
        return fn

    monkeypatch.setattr(jax_layer, "dispatch_combine_gmm", recorder("gmm"))
    monkeypatch.setattr(jax_layer, "dispatch_combine_ragged", recorder("ragged"))
    jmoe = jax_layer.MoE(hidden_size=8, num_experts=4, k=2, intermediate_size=8,
                         dtype=jnp.float32)
    x = jnp.zeros((1, s, 8), jnp.float32)
    params = jmoe.init({"params": jax.random.PRNGKey(0)}, x[:, :4])["params"]
    seen.clear()
    jmoe.apply({"params": params}, x, train=train, mutable=["aux_loss", "metrics"])
    assert seen == [choose_dispatch("auto", train, s * 2)]

    from deepspeed_tpu_torch.moe import layer as port_layer
    ran = []
    for name in ("gmm", "ragged"):
        monkeypatch.setattr(port_layer, f"dispatch_combine_{name}",
                            lambda x, *a, _n=name: ran.append(_n) or torch.zeros_like(x))
    MoE(hidden_size=8, num_experts=4, k=2, intermediate_size=8,
        dtype=torch.float32)(torch.zeros(1, s, 8), train=train)
    assert ran == seen
