"""The port's expert-parallel pieces held against the JAX package's on the CPU.

K8-e: each expert rank's partial of `sharded_grouped_gemm` (its experts'
rows, zeros elsewhere; the plain version, since the tensors lie on the
CPU), summed over the ranks, against the JAX `sharded_grouped_gemm` on the
virtual CPU mesh (megablox in interpret mode) at ep = 2 and ep = 4, on the
JAX test's own case (8 experts, sizes [7, 0, 13, 5, 9, 11, 3, 16] with an
empty expert), to 1e-5; the sum is also the port's unsharded K6 plain
version bit for bit. On this JAX a `pallas_call` in interpret mode inside
`shard_map` fails the region's varying-axes check, so the JAX wrapper runs
with `jax.shard_map(..., check_vma=False)` (the `jax_shard_map` fixture;
the package is unchanged). Exactly: the `expert` axis of `MeshTopology`
against the JAX topology's, the `gmm_mesh` predicate against `_gmm_mesh`,
the cut of the Qwen2-MoE and Mixtral trees over `expert` (the ranks' stacks
concatenate to the whole, the other leaves are the same on every rank, a
shard's module gives its cut back), `init_params` on a shard, placement of
a whole module as one rank's shard, and the refusals: E that does not
divide ep, tp × ep, a shard outside its `expert` group, a model without
experts on an expert topology, grad mode.
"""

import functools
import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.models.mixtral import init_mixtral  # noqa: E402
from deepspeed_tpu.models.mixtral import mixtral_config as jax_mixtral_config  # noqa: E402
from deepspeed_tpu.models.qwen2_moe import init_qwen2_moe  # noqa: E402
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as jax_qwen_config  # noqa: E402
from deepspeed_tpu.moe.layer import _gmm_mesh as jax_gmm_mesh  # noqa: E402
from deepspeed_tpu.ops.pallas.grouped_gemm import (  # noqa: E402
    sharded_grouped_gemm as jax_sharded_grouped_gemm,
)
from deepspeed_tpu.utils import groups as jax_groups  # noqa: E402
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models.llama import init_params, to_jax_params  # noqa: E402
from deepspeed_tpu_torch.moe.layer import MoE, choose_dispatch, gmm_mesh  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.grouped_gemm import (  # noqa: E402
    grouped_gemm_plain,
    sharded_grouped_gemm,
    sharded_grouped_gemm_plain,
)
from deepspeed_tpu_torch.utils import groups  # noqa: E402
from deepspeed_tpu_torch.utils.groups import MESH_AXES, MeshTopology  # noqa: E402
from deepspeed_tpu_torch.utils.partitioning import shard_tree  # noqa: E402
from tests import torch_ep_ranks as ranks  # noqa: E402
from tests.test_torch_qwen2_moe import numpy_tree  # noqa: E402

TOL = 1e-5
SIZES = [7, 0, 13, 5, 9, 11, 3, 16]   # the JAX test's case, an empty expert
FAMILIES = {"qwen2_moe": (init_qwen2_moe, jax_qwen_config),
            "mixtral": (init_mixtral, jax_mixtral_config)}


@pytest.fixture
def jax_shard_map(monkeypatch):
    monkeypatch.setattr(jax, "shard_map", functools.partial(jax.shard_map, check_vma=False))


@pytest.fixture(autouse=True)
def _no_topology():
    yield
    groups.reset_topology()
    jax_groups.reset_topology()


def _jax_ep_mesh(ep):
    jax_groups.reset_topology()
    return jax_groups.initialize(JaxTopology(ep=ep, devices=jax.devices()[:ep])).mesh


def _cpu_ranks(ep):
    return [MeshTopology(ep=ep, world_size=ep, rank=r, device="cpu") for r in range(ep)]


def _case(seed=2, k=128, n=128):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((sum(SIZES), k)).astype(np.float32)
    rhs = rng.standard_normal((len(SIZES), k, n)).astype(np.float32)
    return lhs, rhs, np.asarray(SIZES, np.int32)


@pytest.mark.parametrize("ep", [2, 4])
def test_sharded_grouped_gemm_matches_jax(jax_shard_map, ep):
    lhs, rhs, sizes = _case()
    ref = np.asarray(jax_sharded_grouped_gemm(jnp.asarray(lhs), jnp.asarray(rhs),
                                              jnp.asarray(sizes), _jax_ep_mesh(ep)))
    e_loc, starts = len(SIZES) // ep, np.concatenate([[0], np.cumsum(SIZES)])
    t_lhs, t_sizes = torch.from_numpy(lhs), torch.from_numpy(sizes)
    partials = []
    for rank, topo in enumerate(_cpu_ranks(ep)):
        local = torch.from_numpy(rhs[rank * e_loc:(rank + 1) * e_loc])
        part = sharded_grouped_gemm(t_lhs, local, t_sizes, topo, reduce=False)
        assert torch.equal(part, sharded_grouped_gemm_plain(t_lhs, local, t_sizes,
                                                            rank * e_loc))
        lo, hi = starts[rank * e_loc], starts[(rank + 1) * e_loc]
        outside = torch.ones(part.shape[0], dtype=torch.bool)
        outside[lo:hi] = False
        assert hi > lo and not part[outside].any() and part[lo:hi].abs().min() > 0
        # with no process group the all-reduce is the identity: the partial
        assert torch.equal(sharded_grouped_gemm(t_lhs, local, t_sizes, topo), part)
        partials.append(part)
    total = torch.stack(partials).sum(0)
    np.testing.assert_allclose(total.numpy(), ref, rtol=TOL, atol=TOL)
    # the spans are disjoint: the sum is the unsharded grouped GEMM, bit for bit
    assert torch.equal(total, grouped_gemm_plain(t_lhs, torch.from_numpy(rhs), t_sizes))


def test_sharded_grouped_gemm_refusals(jax_shard_map):
    lhs, rhs, _ = _case(3)
    six = np.full(6, 4, np.int32)   # 6 experts over ep = 4, as the JAX test
    with pytest.raises(ValueError):
        jax_sharded_grouped_gemm(jnp.asarray(lhs[:24]), jnp.asarray(rhs[:6]), jnp.asarray(six),
                                 _jax_ep_mesh(4))
    topo2, topo4 = _cpu_ranks(2)[1], _cpu_ranks(4)[0]
    t_lhs, t_rhs = torch.from_numpy(lhs), torch.from_numpy(rhs)
    sizes = torch.tensor(SIZES, dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible by expert=4"):
        sharded_grouped_gemm(t_lhs[:24], t_rhs[:1], torch.from_numpy(six), topo4)
    with pytest.raises(ValueError, match="not its share 4 of 8"):
        sharded_grouped_gemm(t_lhs, t_rhs[:3], sizes, topo2)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        sharded_grouped_gemm(t_lhs, t_rhs[4:].requires_grad_(), sizes, topo2)
    with torch.no_grad():   # grad mode off: no backward is asked for
        sharded_grouped_gemm(t_lhs, t_rhs[4:].requires_grad_(), sizes, topo2)
    on_card = MeshTopology(ep=2, world_size=2, rank=1, device="cuda")
    with pytest.raises(ValueError, match="rank's card"):
        sharded_grouped_gemm(t_lhs, t_rhs[4:], sizes, on_card)


@pytest.mark.parametrize("kw", [dict(ep=2), dict(expert=2), dict(ep=4)])
def test_expert_axis_matches_jax(kw):
    n = next(iter(kw.values()))
    jax_topo = JaxTopology(devices=jax.devices()[:n], ep=n)
    devices = list(jax.devices()[:n])
    for rank in range(n):
        topo = MeshTopology(world_size=n, rank=rank, **kw)
        assert topo.sizes == {a: int(jax_topo.sizes[a]) for a in MESH_AXES}
        assert (topo.world_size, topo.ep_size, topo.tp_size) == \
            (jax_topo.world_size, jax_topo.ep_size, jax_topo.tp_size)
        where = np.argwhere(np.asarray(jax_topo.mesh.devices) == devices[rank])[0]
        assert tuple(topo.coords[a] for a in MESH_AXES) == tuple(int(c) for c in where)
        assert (topo.axis_size("ep"), topo.coord("expert"), topo.coord("model")) == (n, rank, 0)
    groups.initialize(MeshTopology(world_size=n, rank=n - 1, **kw))
    assert groups.get_expert_parallel_world_size() == n
    assert groups.get_tensor_model_parallel_world_size() == 1


@pytest.mark.parametrize("kw,error", [
    (dict(tp=2, ep=2, world_size=4), NotImplementedError),   # tp x ep
    (dict(ep=2, world_size=4), NotImplementedError),         # a data axis beside it
    (dict(ep=3, world_size=4), ValueError),                  # does not divide the world
    (dict(ep=2, expert=2, world_size=2), TypeError)])
def test_expert_topology_refusals(kw, error):
    with pytest.raises(error):
        MeshTopology(rank=0, **kw)


def test_gmm_mesh_matches_jax():
    """(topology, ep) on a pure expert axis that E divides, (None, 0) on
    any other partitioned one, (None, 1) unpartitioned, as the JAX
    `_gmm_mesh`; `auto` leaves the grouped GEMM where it cannot run."""
    cases = [(dict(ep=2), 4, 2), (dict(ep=2), 3, 0), (dict(ep=4), 8, 4), (dict(tp=2), 4, 0),
             (dict(), 4, 1)]
    for kw, experts, want in cases:
        n = max(kw.values()) if kw else 1
        jax_groups.reset_topology()
        jax_groups.initialize(JaxTopology(devices=jax.devices()[:n], **kw))
        groups.initialize(MeshTopology(world_size=n, rank=0, **kw))
        (jax_mesh, jax_ep), (mesh, ep) = jax_gmm_mesh(experts), gmm_mesh(experts)
        assert ep == jax_ep == want, (kw, experts)
        assert (mesh is None) == (jax_mesh is None) == (want != n or n == 1)
    groups.reset_topology()
    assert gmm_mesh(4) == (None, 1)
    assert choose_dispatch("auto", False, 1024, gmm_ok=False) == "ragged"
    assert choose_dispatch("auto", False, 1024) == "gmm"
    assert choose_dispatch("gmm", False, 16, gmm_ok=False) == "gmm"


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_tree(request):
    init, config = FAMILIES[request.param]
    return request.param, numpy_tree(init, config(ranks.family(request.param)[2],
                                                  dtype=jnp.float32), 21)


def _stacks(tree):
    layers = tree["layers"]
    return (layers.get("mlp") or layers["block_sparse_moe"])["experts"]


def test_expert_cut_of_the_tree(family_tree):
    name, tree = family_tree
    cls = ranks.family(name)[0]
    cuts = [shard_tree(tree, ranks.EP, r, "expert") for r in range(ranks.EP)]
    for key, whole in _stacks(tree).items():
        parts = [_stacks(c)[key] for c in cuts]
        assert all(p.shape[1] == whole.shape[1] // ranks.EP for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts, axis=1), whole)
    flat = [dict(jax.tree_util.tree_leaves_with_path(c)) for c in cuts]
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        if "experts" not in jax.tree_util.keystr(path):
            assert all(f[path] is leaf for f in flat), path   # replicated
    # a rank's shard module takes its cut and gives it back, bit for bit
    cfg = ranks._config(name)
    for r, cut in enumerate(cuts):
        back = to_jax_params(cls(cfg, ep_size=ranks.EP, ep_rank=r).load_jax_params(cut))
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        want = jax.tree_util.tree_leaves_with_path(cut)
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    with pytest.raises(ValueError, match="does not divide ep=3"):
        shard_tree(tree, 3, 0, "expert")


def test_init_params_shards_are_cuts_of_the_whole(family_tree):
    name, _ = family_tree
    cls, cfg = ranks.family(name)[0], ranks._config(name)
    whole = init_params(cls(cfg), torch.Generator().manual_seed(4))
    full = whole.state_dict()
    for r in range(ranks.EP):
        shard = init_params(cls(cfg, ep_size=ranks.EP, ep_rank=r),
                            torch.Generator().manual_seed(4))
        for key, value in shard.state_dict().items():
            want = full[key]
            if ".experts." in key:
                n = want.shape[0] // ranks.EP
                want = want[r * n:(r + 1) * n]
            assert torch.equal(value, want), key


def test_whole_module_placed_as_a_rank_shard(family_tree):
    """One process under an installed ep = 2 topology (no process group):
    `init_inference` rebuilds the whole module as rank 1's shard and feeds
    it the cut tree; a call then raises, since its sums would stay partial."""
    name, tree = family_tree
    cls = ranks.family(name)[0]
    groups.initialize(MeshTopology(ep=ranks.EP, world_size=ranks.EP, rank=1, device="cpu"))
    eng = deepspeed_tpu_torch.init_inference(cls(ranks._config(name)), params=tree,
                                             dtype="fp32", device="cpu")
    assert (eng.module.ep_size, eng.module.ep_rank) == (ranks.EP, 1)
    assert eng.topology.ep_size == ranks.EP and eng.serve_mode == "dequant"
    want = _stacks(shard_tree(tree, ranks.EP, 1, "expert"))
    for i, layer in enumerate(eng.module.layers):
        experts = layer.moe.experts
        assert experts.first_expert == 2 and experts.num_experts == 4
        for key in ("gate", "up", "down"):
            np.testing.assert_array_equal(getattr(experts, key).detach().numpy(),
                                          want[key][i])
    ids = np.zeros((1, 4), np.int64)
    with pytest.raises(RuntimeError, match="`expert` group of 1 rank"):
        eng.forward(ids)


def test_expert_parallel_refusals():
    cfg = ranks._config("qwen2_moe")
    cls = ranks.family("qwen2_moe")[0]
    with pytest.raises(ValueError, match="not divisible by expert=3"):
        MoE(hidden_size=8, num_experts=4, k=2, ep_size=3, ep_rank=0)
    with pytest.raises(ValueError, match="installed topology has expert=1"):
        MoE(hidden_size=8, num_experts=4, k=2, ep_size=2)
    with pytest.raises(ValueError, match="outside ep_size"):
        cls(cfg, ep_size=2, ep_rank=2)
    # a shard alone: no `expert` group holds its ranks
    shard = cls(cfg, ep_size=2, ep_rank=0)
    with pytest.raises(RuntimeError, match="`expert` group of 1 rank"):
        with torch.no_grad():
            shard(torch.zeros((1, 4), dtype=torch.long))
    # the rank is taken from the installed topology
    groups.initialize(MeshTopology(ep=2, world_size=2, rank=1))
    assert MoE(hidden_size=8, num_experts=4, k=2, ep_size=2).experts.first_expert == 2
    # a model without experts on an expert topology, and MoE under tp
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        deepspeed_tpu_torch.init_inference(LlamaForCausalLM(llama_config("llama-tiny")),
                                           dtype="fp32", device="cpu")
    groups.initialize(MeshTopology(tp=2, world_size=2, rank=0))
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        deepspeed_tpu_torch.init_inference(cls(cfg), dtype="fp32", device="cpu")
    # a shard of the tensor axis served on an expert topology
    groups.initialize(MeshTopology(ep=2, world_size=2, rank=0))
    with pytest.raises(ValueError, match="shard of ep=2"):
        deepspeed_tpu_torch.init_inference(cls(cfg, ep_size=2, ep_rank=1), dtype="fp32",
                                           device="cpu")
