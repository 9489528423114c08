"""The port's ragged batching state and KV block manager held against the JAX package's.

`BlockedAllocator`, `DSStateManager` and `KVBlockManager` are pure Python in
both packages. One seeded sequence of operations (allocate, free, share,
copy-on-write, commit, match, drain; sequences created, grown and flushed)
runs on a port object and a JAX object side by side: every return value,
every raised error type and the whole state must be equal after each one.
"""

import numpy as np
import pytest

from deepspeed_tpu.inference.kv_block_manager import KVBlockManager as JaxKVBlockManager
from deepspeed_tpu.inference.v2 import ragged as jax_ragged
from deepspeed_tpu_torch.inference.kv_block_manager import KVBlockManager
from deepspeed_tpu_torch.inference.v2 import ragged

BS = 4


def _same(op, port, ref):
    """Run `op` on both objects; same value or same error type."""
    outcomes = []
    for obj in (port, ref):
        try:
            outcomes.append(("ok", op(obj)))
        except (RuntimeError, ValueError) as e:
            outcomes.append(("raise", type(e)))
    assert outcomes[0] == outcomes[1]
    return outcomes[0][1] if outcomes[0][0] == "ok" else None


def _manager_state(m):
    return (m.num_blocks, m.free_blocks, list(m._free), list(m._refs), dict(m._prefix),
            dict(m._block_hash), list(m._pending_copies), m.cow_copies, m.prefix_hits,
            m.prefix_tokens_reused, m.shared_blocks, m.has_pending_copies)


def test_blocked_allocator_matches_jax():
    rng = np.random.default_rng(0)
    port, ref = ragged.BlockedAllocator(6), jax_ragged.BlockedAllocator(6)
    held = []
    for _ in range(60):
        if rng.random() < 0.5 or not held:
            got = _same(lambda a, n=int(rng.integers(1, 4)): a.allocate(n), port, ref)
            held.extend(got or [])
        else:
            blk = held.pop(int(rng.integers(len(held))))
            _same(lambda a: a.free(blk), port, ref)
            if rng.random() < 0.2:  # a double free raises in both
                _same(lambda a: a.free(blk), port, ref)
        assert (port.free_blocks, port._free) == (ref.free_blocks, ref._free)


@pytest.mark.parametrize("shared", [False, True])
def test_state_manager_matches_jax(shared):
    """Sequences join, grow block by block and leave; with `shared` the
    block allocator is the KV block manager, as the v2 engine wires it."""
    rng = np.random.default_rng(1 + shared)
    port = ragged.DSStateManager(3, num_blocks=10, block_size=BS)
    ref = jax_ragged.DSStateManager(3, num_blocks=10, block_size=BS)
    if shared:
        port.block_allocator = KVBlockManager(10, BS)
        ref.block_allocator = JaxKVBlockManager(10, BS)
    uids = []
    for step in range(80):
        op = rng.integers(0, 3)
        if op == 0:
            uid = int(rng.integers(0, 6))
            seq = _same(lambda s: s.get_or_create_sequence(uid).slot, port, ref)
            if seq is not None and uid not in uids:
                uids.append(uid)
        elif op == 1 and uids:
            uid = uids[int(rng.integers(len(uids)))]
            n = int(rng.integers(1, 20))
            _same(lambda s: s.ensure_blocks(s.get_sequence(uid), n), port, ref)
        elif uids:
            uid = uids.pop(int(rng.integers(len(uids))))
            _same(lambda s: s.flush_sequence(uid), port, ref)
        for s in (port, ref):
            assert s.blocks_for(9) == 3
        assert port.n_tracked_sequences == ref.n_tracked_sequences
        for uid in uids:
            a, b = port.get_sequence(uid), ref.get_sequence(uid)
            assert (a.slot, a.blocks, a.cur_allocated_blocks) == \
                (b.slot, b.blocks, b.cur_allocated_blocks)
        assert (port.allocator._free, port.block_allocator.free_blocks) == \
            (ref.allocator._free, ref.block_allocator.free_blocks)


def test_kv_block_manager_matches_jax():
    """Allocate, free, share (fork), copy-on-write, commit and match over a
    small pool, as `tests/unit/inference/test_kv_block_manager.py` drives
    the JAX class; prompts reuse a few block contents so matches hit."""
    rng = np.random.default_rng(5)
    port, ref = KVBlockManager(12, BS), JaxKVBlockManager(12, BS)
    contents = [list(rng.integers(1, 50, BS)) for _ in range(4)]
    seqs = []          # (tokens, blocks) that both sides own
    for step in range(300):
        op = int(rng.integers(0, 7))
        if op == 0:                                    # a new sequence
            n = int(rng.integers(1, 4))
            blocks = _same(lambda m: m.allocate(n), port, ref)
            if blocks is not None:
                toks = sum((contents[int(i)] for i in rng.integers(0, 4, n)), [])
                seqs.append((toks, blocks))
        elif op == 1 and seqs:                         # flush
            _, blocks = seqs.pop(int(rng.integers(len(seqs))))
            _same(lambda m: m.free(blocks), port, ref)
        elif op == 2 and seqs:                         # fork
            toks, blocks = seqs[int(rng.integers(len(seqs)))]
            _same(lambda m: m.share(blocks), port, ref)
            seqs.append((list(toks), list(blocks)))
        elif op == 3 and seqs:                         # write into a block
            toks, blocks = seqs[int(rng.integers(len(seqs)))]
            i = int(rng.integers(len(blocks)))
            if port.refcount(blocks[i]) > 1:
                new = _same(lambda m: m.cow(blocks[i]), port, ref)
                if new is not None:
                    blocks[i] = new
            else:                                      # cow refuses a private block
                _same(lambda m: m.cow(blocks[i]), port, ref)
        elif op == 4 and seqs:                         # commit a prefill
            toks, blocks = seqs[int(rng.integers(len(seqs)))]
            _same(lambda m: m.commit_prefix(toks, blocks), port, ref)
        elif op == 5:                                  # admit through a match
            toks = sum((contents[int(i)] for i in rng.integers(0, 4, 3)), [])
            cap = int(rng.integers(1, 3 * BS + 1))
            got = _same(lambda m: m.match_prefix(toks, max_tokens=cap), port, ref)
            if got and got[0]:
                seqs.append((toks[:got[0]], list(got[1])))
        elif op == 6:
            _same(lambda m: m.drain_copies(), port, ref)
        assert _manager_state(port) == _manager_state(ref), step
        for toks, blocks in seqs:
            assert [port.refcount(b) for b in blocks] == [ref.refcount(b) for b in blocks]
    assert port.prefix_hits > 0 and port.cow_copies > 0
