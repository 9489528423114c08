"""InferenceEngineV2: continuous batching over the block-paged KV cache or
dense slot rows (counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py``).

The FastGen serving loop: prompts join as cache rows and blocks free up,
every live row decodes each step, long prompts prefill in chunks of
`split_fuse_chunk` tokens that ride the same step as the decode rows
(dynamic split-fuse), prompts that share committed full blocks share them
physically (prefix sharing) and `fork` clones a live sequence with
copy-on-write.

Where the JAX package compiles static-shape programs, this engine runs
eagerly and keeps the results the same:
- a lone prompt is not padded to a bucket, and a chunk batch holds only the
  rows that have a chunk (no parked padding rows);
- the LM head runs only at each row's last valid position;
- a decode wave keeps its K steps' tokens on the device and fetches them
  once at its end;
- every cache write lands in place with no host sync (`kv_cache.py`).
Sampled rows draw from their own generator, seeded from (seed, uid), so a
row's draws depend on (seed, uid, draw index) and not on its slot.

`kv_cache_dtype="int8"` keeps the pools int8 at rest with f32 scales
(quantized by the scatters and `apply_stage`, folded in by K3/K4), and a
copy-on-write block copy moves the scales with the values. Placement is v1's
(`serve_modes.place_params`): `quant` in the `dequant` mode serves the int8
tree dequantized at every model call, as the JAX engine's programs do.

`kv_layout="slot"` keeps one dense `KVCache` row per sequence: prompt
pieces run row by row through a view of their row (`kv_cache.row_view`),
decode steps over every row at once (a Llama's through K2), and there are
no blocks, so no prefix sharing and no `fork`. `kv_layout=None` picks as
the JAX engine does: `slot` for an alibi model whose head dim or block size
is under 128 (BLOOM-560m, bloom-tiny), else `paged` (BLOOM-7b1 runs K3-alibi
and K4-alibi there). int8 KV needs the paged layout.

Tensor parallelism (`config.tensor_parallel`, Llama only) is v1's: each
rank runs this same host scheduler on the same requests, so every rank's
block tables and cursors are equal, and the pools hold the rank's Hkv/tp
heads (K3 and K4 per shard).

The layer-streamed serve modes serve slot rows, as in the JAX engine:
`serve_mode="layer_scan"` (with `quant`) runs every model call through the
layer scan over the per-layer int8 stacks (K5 on every projection), and
`"capacity"` through the capacity runner, which streams every layer from
host memory or NVMe each call (`capacity_scan.CapacityRunner`); decode steps
attend through K2 in both. An explicit `kv_layout="paged"` with either
raises, a paged default warns once and takes slot rows, and an int8 KV
cache raises.

The serve-mode ladder, speculative rounds, `warmup` and the tracer, program
ledger, recompile detector and memory plane are not ported (ROADMAP.md,
Queue 1, 'v2 FastGen: the rest').
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig, _unported
from deepspeed_tpu_torch.inference.engine import _cache_dims
from deepspeed_tpu_torch.inference.kv_block_manager import KVBlockManager
from deepspeed_tpu_torch.inference.kv_cache import KVCache, PagedKVCache, merge_row, row_view
from deepspeed_tpu_torch.inference.serve_modes import (
    dense_state,
    place_params,
    serving_topology,
    use_fused_int8,
)
from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager
from deepspeed_tpu_torch.ops.sampling import row_generator, sample_logits
from deepspeed_tpu_torch.utils.logging import logger

_REST = "v2 FastGen: the rest"
_WARNED: set = set()


def _uid_fold(uid) -> int:
    """Stable 31-bit value of a caller-chosen uid, folded into its row's
    generator seed."""
    return int(uid) & 0x7FFFFFFF


class InferenceEngineV2:
    def __init__(self, model: Any, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Any = None, max_batch: int = 8,
                 max_seq_len: int = 2048, split_fuse_chunk: int = 256,
                 kv_layout: Optional[str] = None, cache_block_size: int = 256,
                 num_cache_blocks: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = None,
                 prefix_sharing: bool = True,
                 serve_mode: Optional[str] = None,
                 quant: Optional[dict] = None,
                 speculative: Optional[dict] = None,
                 device=None):
        """The JAX engine's keyword arguments, plus `device` (None → CUDA;
        without CUDA it raises unless `device="cpu"`). The cache is a pool
        of `num_cache_blocks` blocks of `cache_block_size` tokens (default:
        max_batch × ceil(max_seq_len / block) blocks), so memory scales with
        tokens in flight. `kv_layout="slot"` keeps a dense max_batch ×
        max_seq_len cache instead; None picks as the JAX engine does (the
        module docstring). `kv_cache_dtype="int8"` stores the pools int8 at
        rest. `prefix_sharing` admits prompts through a match against
        committed blocks and enables `fork` (paged only). `model` is an `nn.Module` or a
        `(module, params)` tuple, `params` a JAX parameter tree of numpy
        arrays. `serve_mode` and `quant` write through to the config."""
        if config is None:
            config = DeepSpeedInferenceConfig()
        elif isinstance(config, dict):
            config = DeepSpeedInferenceConfig(**config)
        if serve_mode is not None:
            config.serve_mode = serve_mode
        if quant is not None:
            config.quant = quant
        if speculative is not None:
            config.speculative = speculative
        config._check_ported()
        if isinstance(model, tuple):
            model, params = model
        explicit_layout = kv_layout is not None
        if kv_layout is None:
            # the JAX engine's rule: its alibi kernels were validated at
            # head dim and block >= 128, so smaller alibi models keep slot rows
            _, _, head_dim = _cache_dims(model.cfg)
            small_alibi = getattr(model.cfg, "uses_alibi", False) and (
                head_dim < 128 or cache_block_size < 128)
            kv_layout = "slot" if small_alibi else "paged"
        if kv_layout not in ("paged", "slot"):
            raise ValueError(f"kv_layout must be 'paged' or 'slot', got {kv_layout!r}")
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got {kv_cache_dtype!r}")
        if not config.max_batch_size:
            config.max_batch_size = max_batch
        self._config = config
        self.accelerator = get_accelerator(device)
        self.device = self.accelerator.device
        self.module = model
        self.model_cfg = model.cfg
        self.topology = serving_topology(self)
        self.params = place_params(self, params)
        if kv_cache_dtype == "int8" and self.serve_mode != "dequant":
            raise ValueError(
                "kv_cache_dtype='int8' rides the paged dequant path; the "
                f"layer-streamed serve mode {self.serve_mode!r} keeps dense "
                "slot rows with no per-row view of a quantized cache — use "
                "serve_mode='dequant' or drop the int8 cache")
        kv_layout = self._streamed_layout(kv_layout, explicit_layout)
        if kv_cache_dtype == "int8" and kv_layout != "paged":
            raise ValueError(
                "kv_cache_dtype='int8' needs the paged layout (the dense "
                "slot rows have no per-row view of a quantized cache); "
                "drop kv_layout='slot' or the int8 cache")
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.split_fuse_chunk = split_fuse_chunk
        self.kv_layout = kv_layout
        self.kv_cache_dtype = kv_cache_dtype
        self._cache_block_size = cache_block_size
        self._num_cache_blocks = num_cache_blocks
        self._prefix_sharing = prefix_sharing
        self._apply = self._make_apply()
        self._setup_cache()
        self._sample_cfg = None   # (temperature, top_k, top_p) or None
        self._seed = 0
        self._row_gens: Dict[int, torch.Generator] = {}
        self.last_timing: Dict[int, Dict[str, float]] = {}  # per-uid stamps
        self.serving_counters: Dict[str, int] = {
            "flushed_sequences": 0, "generated_tokens": 0,
            "decode_waves": 0, "mixed_rounds": 0}
        self._kv_util_peak = 0.0
        logger.info(f"InferenceEngineV2: {self._cache_desc} on "
                    f"{self.accelerator.device_name()}, dtype={config.dtype}")

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config

    def _streamed_layout(self, kv_layout: str, explicit: bool) -> str:
        """The layer-streamed modes run the block body over dense slot rows
        (the paged table indirection lives in the model's cache path, which
        they bypass): an explicit paged request raises, a paged default
        warns once and takes slot rows."""
        if self.serve_mode == "dequant" or kv_layout == "slot":
            return kv_layout
        if explicit:
            raise ValueError(
                f"kv_layout='paged' is incompatible with serve_mode={self.serve_mode!r}: "
                "the layer-streamed block body runs over dense slot rows; drop kv_layout "
                "or serve dequant")
        key = ("v2_kv_layout", self.serve_mode)
        if key not in _WARNED:
            _WARNED.add(key)
            logger.warning(f"v2: serve_mode={self.serve_mode!r} forces the dense 'slot' KV "
                           "layout (prefix sharing and fork are paged-only and go inactive)")
        return "slot"

    def _make_apply(self):
        """`apply(ids, cache, logits_at=None) → (logits, cache)` with the
        cursors advanced, as the module's call gives them, for the streamed
        modes: the layer scan over the placed int8 stacks, or the capacity
        runner's streamed pass. None in the dequant mode (`_model` calls the
        module)."""
        if self.serve_mode == "capacity":
            return self._capacity.apply
        if self.serve_mode != "layer_scan":
            return None
        from deepspeed_tpu_torch.inference.quantized_layer_scan import (
            layer_slices, make_scan_apply)
        scan = make_scan_apply(self.model_cfg, fused=use_fused_int8(self),
                               mesh=self.topology if self.topology.tp_size > 1 else None)
        per_layer = layer_slices(self.params["layers"])

        def apply(ids, cache, logits_at=None):
            logits, cache = scan(self.params, ids, cache, per_layer, logits_at=logits_at)
            return logits, cache.replace(index=cache.index + ids.shape[1])

        return apply

    def _model(self, ids, cache, logits_at=None):
        """One model call: the streamed modes' `apply`, else the module on
        its own weights, or with `quant` on the int8 tree dequantized for
        this call."""
        if self._apply is not None:
            return self._apply(ids, cache, logits_at=logits_at)
        kwargs = {"cache": cache, "logits_at": logits_at}
        state = dense_state(self)
        if state is None:
            return self.module(ids, **kwargs)
        return torch.func.functional_call(self.module, state, (ids,), kwargs)

    def _setup_cache(self) -> None:
        """The cache and the scheduler state; every row parked (cursor at
        max_len, so writes drop)."""
        self.block_manager: Optional[KVBlockManager] = None
        layers, kv_heads, head_dim = _cache_dims(self.model_cfg, self.topology.tp_size)
        if self.kv_layout == "slot":
            self.cache = KVCache.create(layers, self.max_batch, self.max_seq_len, kv_heads,
                                        head_dim, dtype=self._config.dtype, device=self.device)
            self.state_manager = DSStateManager(self.max_batch)
            self.cache.index.fill_(self.cache.max_len)
            self._cache_desc = f"{self.max_batch} slots × {self.max_seq_len} tokens"
            return
        bs = self._cache_block_size
        t = -(-self.max_seq_len // bs)
        num_blocks = self._num_cache_blocks
        if num_blocks is None:
            num_blocks = self.max_batch * t  # slot-parity capacity
        self.cache = PagedKVCache.create(
            layers, self.max_batch, self.max_seq_len, kv_heads, head_dim,
            num_blocks=num_blocks, block_size=bs, dtype=self._config.dtype,
            device=self.device, staged=True, quantized=self.kv_cache_dtype == "int8")
        self.state_manager = DSStateManager(self.max_batch, num_blocks=num_blocks,
                                            block_size=bs)
        if self._prefix_sharing:
            self.block_manager = KVBlockManager(num_blocks, bs)
            self.state_manager.block_allocator = self.block_manager
        self._tables_np = np.full((self.max_batch, t), -1, np.int32)
        self._tables_dirty = False  # the cache was created with -1 tables
        # park every row: cursor at max_len, so writes drop
        self.cache.index.fill_(self.cache.max_len)
        self._cache_desc = (f"{num_blocks} blocks × {bs} tokens (paged"
                            f"{', int8' if self.cache.quantized else ''}), "
                            f"{self.max_batch} seq rows")

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------- paged plumbing
    def _reserve(self, seq, total_tokens: int) -> None:
        """Grow a sequence's blocks to `total_tokens` and stage its table row
        for the next sync. A write about to land in a shared partial block
        (after `fork`) copies it first (copy-on-write). Slot rows own no
        blocks: a no-op."""
        if self.kv_layout != "paged":
            return
        total_tokens = min(total_tokens, self.cache.max_len)
        if self.block_manager is not None and seq.blocks:
            cur = seq.seen_tokens          # next write position
            bs = self.state_manager.block_size
            bi = cur // bs
            if cur < total_tokens and cur % bs and bi < len(seq.blocks) \
                    and self.block_manager.refcount(seq.blocks[bi]) > 1:
                fresh_blk = self.block_manager.cow(seq.blocks[bi])
                seq.blocks[bi] = fresh_blk
                self._tables_np[seq.slot, bi] = fresh_blk
                self._tables_dirty = True
        fresh = self.state_manager.ensure_blocks(seq, total_tokens)
        if fresh:
            start = len(seq.blocks) - len(fresh)
            self._tables_np[seq.slot, start:start + len(fresh)] = fresh
            self._tables_dirty = True
            self._kv_util_peak = max(self._kv_util_peak, self.kv_utilization())

    def _copy_blocks(self, copies) -> None:
        """Copy-on-write block copies, one gather and one scatter per pool
        (and per scale pool) over every layer and head."""
        c = self.cache
        lh, nb = c.num_layers * c.kv_heads, c.num_blocks
        heads = torch.arange(lh, device=self.device)[:, None] * nb
        src = (heads + self._tensor([s for s, _ in copies], torch.long)[None]).reshape(-1)
        dst = (heads + self._tensor([d for _, d in copies], torch.long)[None]).reshape(-1)
        for blocks in (c.k_blocks, c.v_blocks, c.k_scale_blocks, c.v_scale_blocks):
            if blocks is not None:
                blocks.index_copy_(0, dst, blocks[src])

    def _maybe_sync_tables(self) -> None:
        """Push host-side table edits to the device before a step; queued
        copy-on-write copies go first (they read pre-step content)."""
        if self.kv_layout != "paged":
            return
        copies = (self.block_manager.drain_copies()
                  if self.block_manager is not None else [])
        if copies:
            self._copy_blocks(copies)
        if self._tables_dirty:
            self.cache.with_tables(self._tables_np)
            self._tables_dirty = False

    def _match_prefix(self, seq, tokens) -> int:
        """Share the longest committed block chain of `tokens` (capped at
        len − 1, so the last prompt token runs and yields logits), install
        it in the table and advance the cursor. Returns matched tokens."""
        if self.block_manager is None or len(tokens) < 2:
            return 0
        n, blocks = self.block_manager.match_prefix(
            list(map(int, tokens)), max_tokens=len(tokens) - 1)
        if not n:
            return 0
        seq.blocks = list(blocks)
        self._tables_np[seq.slot, :len(blocks)] = blocks
        self._tables_dirty = True
        seq.seen_tokens = n
        return n

    def _commit_prefix(self, seq) -> None:
        """Register a prefilled sequence's full blocks (idempotent)."""
        if self.block_manager is not None and seq.blocks:
            self.block_manager.commit_prefix(seq.tokens[:seq.seen_tokens], seq.blocks)

    @torch.inference_mode()
    def fork(self, parent_uid: int, child_uid: int) -> None:
        """Clone a live sequence under a new uid: the child shares every
        parent block, the partial tail included; whichever writes the tail
        first copies it (`_reserve`)."""
        if self.block_manager is None:
            raise ValueError("fork() needs the paged layout with "
                             "prefix_sharing enabled")
        if self.state_manager.known_sequence(child_uid):
            raise ValueError(f"fork target uid {child_uid} already tracked")
        parent = self.state_manager.get_sequence(parent_uid)
        if parent.pending:
            raise ValueError(f"cannot fork uid {parent_uid} mid-prefill")
        child = self.state_manager.get_or_create_sequence(child_uid)
        self.block_manager.share(parent.blocks)
        child.blocks = list(parent.blocks)
        child.tokens = list(parent.tokens)
        child.seen_tokens = parent.seen_tokens
        self._tables_np[child.slot, :len(child.blocks)] = child.blocks
        self._tables_dirty = True
        self.cache.index[child.slot] = child.seen_tokens  # un-park the row

    def kv_utilization(self) -> float:
        """Fraction of the KV pool in use: physical blocks (paged) or
        sequence rows (slot)."""
        alloc = (self.state_manager.block_allocator if self.kv_layout == "paged"
                 else self.state_manager.allocator)
        total = max(alloc.num_blocks, 1)
        return (total - alloc.free_blocks) / total

    def warmup(self, *args, **kwargs):
        """The JAX engine compiles its program family here; this engine
        compiles nothing, and the warm-up pass is not ported."""
        raise _unported("InferenceEngineV2.warmup", _REST)

    # ---------------------------------------------------------------- steps
    def _rows(self, slots, starts, width: int) -> PagedKVCache:
        """The rows `slots` of the cache as a batch: their table rows and
        cursors `starts`, over the shared pools, with no stage (chunks write
        the pool)."""
        bs = self.cache.block_size
        aligned = width == bs and all(int(s) % bs == 0 for s in starts)
        return self.cache.replace(tables=self.cache.tables[self._tensor(slots, torch.long)],
                                  index=self._tensor(starts), k_stage=None,
                                  v_stage=None, aligned=aligned)

    def _chunk_batch(self, pieces, slots, starts) -> torch.Tensor:
        """R rows' prompt pieces in one model call, each written through its
        own table row at its own cursor; advances their cursors. Returns the
        next-token logits (R, V) at each row's last piece token. Slot rows
        run one model call each, on a view of their row."""
        if self.kv_layout == "slot":
            last = []
            for piece, slot, start in zip(pieces, slots, starts):
                logits, _ = self._model(self._tensor([piece], torch.long),
                                        cache=row_view(self.cache, slot, start),
                                        logits_at=self._tensor([len(piece) - 1]))
                merge_row(self.cache, slot, start + len(piece))
                last.append(logits)
            return torch.cat(last)
        width = max(len(p) for p in pieces)
        ids = np.zeros((len(pieces), width), np.int64)
        for i, p in enumerate(pieces):
            ids[i, :len(p)] = p
        valids = self._tensor([len(p) for p in pieces])
        last, _ = self._model(self._tensor(ids, torch.long),
                              cache=self._rows(slots, starts, width),
                              logits_at=valids - 1)
        self.cache.index[self._tensor(slots, torch.long)] = self._tensor(starts) + valids
        return last

    def _decode_step(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One token for every row (B, 1): staged attention, then one scatter
        per pool lands the staged tokens (slot rows are written in place);
        inactive rows keep their cursors. Returns logits (B, V)."""
        logits, stepped = self._model(tokens, cache=self.cache)
        if self.kv_layout == "paged":
            stepped.apply_stage()
        self.cache = self.cache.replace(
            index=torch.where(active, stepped.index, self.cache.index))
        return logits[:, -1]

    def _gens(self, uids) -> List[torch.Generator]:
        for uid in uids:
            if uid not in self._row_gens:
                self._row_gens[uid] = row_generator(self._seed, _uid_fold(uid), self.device)
        return [self._row_gens[u] for u in uids]

    def _pick(self, logits: torch.Tensor, uids) -> torch.Tensor:
        """Next tokens (R,) on the device for logits (R, V) of `uids`:
        argmax, or each row's own draw when sampling."""
        if self._sample_cfg is None:
            return logits.float().argmax(dim=-1)
        return sample_logits(logits, None, *self._sample_cfg,
                             row_generators=self._gens(uids))

    def _reduce(self, logits: torch.Tensor, uids, argmax_only: bool) -> np.ndarray:
        """One host fetch of a round's results: token ids or f32 logits."""
        if argmax_only:
            return self._pick(logits, uids).cpu().numpy()
        return logits.float().cpu().numpy()

    def _decode_wave(self, k: int, tokens, active, live_slots, live_uids) -> np.ndarray:
        """K decode steps with the tokens kept on the device, fetched once:
        (K, B) token ids."""
        tok = self._tensor(tokens, torch.long)
        act = self._tensor(active, torch.bool)
        slots = self._tensor(live_slots, torch.long)
        out = []
        for _ in range(k):
            logits = self._decode_step(tok, act)
            nxt = torch.zeros((self.max_batch,), dtype=torch.long, device=self.device)
            nxt[slots] = self._pick(logits[slots], live_uids)
            out.append(nxt)
            tok = nxt[:, None]
        return torch.stack(out).cpu().numpy()

    # ------------------------------------------------------------ scheduling
    def can_schedule(self, uids: Sequence[int], lengths: Sequence[int]) -> bool:
        """Slot and (paged) physical-block availability."""
        new_uids = [u for u in uids if not self.state_manager.known_sequence(u)]
        if len(new_uids) > self.state_manager.allocator.free_blocks or \
                any(l > self.max_seq_len for l in lengths):
            return False
        if self.kv_layout != "paged":
            return True
        need = sum(self.state_manager.blocks_for(l) for u, l in zip(uids, lengths)
                   if not self.state_manager.known_sequence(u))
        return need <= self.state_manager.block_allocator.free_blocks

    @torch.inference_mode()
    def put(self, batch_uids: Sequence[int], batch_tokens: Sequence[np.ndarray],
            argmax_only: bool = False) -> Dict[int, np.ndarray]:
        """Schedule tokens for each uid: a prompt for an unknown uid, one
        token for a known one (batched decode), several for a known one
        (prefill continuation). One round per call: every mid-prefill
        sequence advances by one chunk of `split_fuse_chunk` tokens, riding
        the same step as this call's decode rows. Returns next-token logits
        (V,) f32, or token ids with `argmax_only`, for the uids that
        produced one this round."""
        out: Dict[int, np.ndarray] = {}
        decode_uids: List[int] = []
        # validate the whole batch before any mutation
        cap = min(self.max_seq_len, self.cache.max_len)
        for uid, toks in zip(batch_uids, batch_tokens):
            n = np.asarray(toks, np.int32).reshape(-1).shape[0]
            if self.state_manager.known_sequence(uid):
                seq = self.state_manager.get_sequence(uid)
                seen = seq.seen_tokens + len(seq.pending)
            else:
                seen = 0
            if seen + n > cap:
                raise ValueError(
                    f"sequence {uid} would reach {seen + n} tokens "
                    f"but max_seq_len={cap} — raise max_seq_len or shorten "
                    "the prompt/generation budget")
        new_short: List[Any] = []
        for uid, toks in zip(batch_uids, batch_tokens):
            toks = np.asarray(toks, np.int32).reshape(-1)
            if not self.state_manager.known_sequence(uid):
                seq = self.state_manager.get_or_create_sequence(uid)
                seq.tokens = list(map(int, toks))
                matched = self._match_prefix(seq, toks)
                if matched:
                    # only the remainder runs, through the chunk path
                    seq.pending = list(map(int, toks[matched:]))
                elif len(toks) <= self.split_fuse_chunk:
                    new_short.append((uid, seq, toks))
                else:
                    seq.pending = list(map(int, toks))
            else:
                seq = self.state_manager.get_sequence(uid)
                if len(toks) == 0:
                    raise ValueError(
                        f"put got an empty token list for known uid {uid} — "
                        "a decode feed is exactly one token, a prefill "
                        "continuation at least one")
                seq.tokens.extend(map(int, toks))
                if len(toks) == 1 and not seq.pending:
                    decode_uids.append(uid)
                else:
                    seq.pending.extend(map(int, toks))

        # a lone short prompt prefills on its own; several ride the chunk batch
        lone_short = len(new_short) == 1 and not any(
            s.pending for s in self.state_manager.tracked_sequences.values())
        if lone_short:
            uid, seq, toks = new_short[0]
            self._reserve(seq, len(toks))
            self._maybe_sync_tables()
            last = self._chunk_batch([list(map(int, toks))], [seq.slot], [0])
            seq.seen_tokens = len(toks)
            self._commit_prefix(seq)
            out[uid] = self._reduce(last, [uid], argmax_only)[0]
        else:
            for uid, seq, toks in new_short:
                seq.pending = list(map(int, toks))
        chunk_uids = [uid for uid, seq in self.state_manager.tracked_sequences.items()
                      if seq.pending]

        tokens = np.zeros((self.max_batch, 1), np.int64)
        active = np.zeros((self.max_batch,), bool)
        for uid in decode_uids:
            seq = self.state_manager.get_sequence(uid)
            tokens[seq.slot, 0] = seq.tokens[-1]
            active[seq.slot] = True
            self._reserve(seq, seq.seen_tokens + 1)
        decode_slots = [self.state_manager.get_sequence(u).slot for u in decode_uids]

        def decode_results(logits):
            vals = self._reduce(logits[self._tensor(decode_slots, torch.long)],
                                decode_uids, argmax_only)
            for i, duid in enumerate(decode_uids):
                self.state_manager.get_sequence(duid).seen_tokens += 1
                out[duid] = vals[i]

        csz = self.split_fuse_chunk
        if chunk_uids:
            # every pending chunk rides one step, with the decode rows if any
            pieces, slots, starts = [], [], []
            for uid in chunk_uids:
                seq = self.state_manager.get_sequence(uid)
                piece = seq.pending[:csz]
                pieces.append(piece)
                slots.append(seq.slot)
                starts.append(seq.seen_tokens)
                self._reserve(seq, seq.seen_tokens + len(piece))
            self._maybe_sync_tables()
            if decode_uids:
                logits = self._decode_step(self._tensor(tokens, torch.long),
                                           self._tensor(active, torch.bool))
                last = self._chunk_batch(pieces, slots, starts)
                decode_results(logits)
            else:
                last = self._chunk_batch(pieces, slots, starts)
            done = [i for i, uid in enumerate(chunk_uids)
                    if len(self.state_manager.get_sequence(uid).pending) == len(pieces[i])]
            vals = (self._reduce(last[self._tensor(done, torch.long)],
                                 [chunk_uids[i] for i in done], argmax_only)
                    if done else [])
            for i, uid in enumerate(chunk_uids):
                seq = self.state_manager.get_sequence(uid)
                seq.pending = seq.pending[len(pieces[i]):]
                seq.seen_tokens += len(pieces[i])
            for j, i in enumerate(done):  # final chunk → next-token logits
                seq = self.state_manager.get_sequence(chunk_uids[i])
                self._commit_prefix(seq)
                out[chunk_uids[i]] = vals[j]
        elif decode_uids:
            self._maybe_sync_tables()
            decode_results(self._decode_step(self._tensor(tokens, torch.long),
                                             self._tensor(active, torch.bool)))
        return out

    @torch.inference_mode()
    def flush(self, uid: int) -> None:
        """Release a sequence's row and blocks and park its cursor."""
        self._flush_batch([uid])

    def _flush_batch(self, uids: Sequence[int]) -> None:
        """Park several finished rows with one device write."""
        if not uids:
            return
        # rows being retired still count: stamp the peak before release
        self._kv_util_peak = max(self._kv_util_peak, self.kv_utilization())
        self.serving_counters["flushed_sequences"] += len(uids)
        slots = []
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            slots.append(seq.slot)
            if self.kv_layout == "paged":
                self._tables_np[seq.slot] = -1
                self._tables_dirty = True
            self.state_manager.flush_sequence(uid)
            self._row_gens.pop(uid, None)
        self.cache.index[self._tensor(slots, torch.long)] = self.cache.max_len

    # ------------------------------------------------------------ serving loop
    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0) -> List[List[int]]:
        """Continuous-batching loop: admits prompts as rows and blocks free
        up and decodes every live sequence each step. Greedy by default;
        `temperature` > 0 samples every token with temperature / top-k /
        top-p, each sequence from its own generator seeded by (`seed`,
        uid). Returns each prompt followed by its new tokens."""
        self._sample_cfg = ((float(temperature), int(top_k), float(top_p))
                            if temperature and temperature > 0.0 else None)
        self._seed = seed
        self._row_gens = {}
        try:
            return self._generate(prompts, max_new_tokens, eos_token_id)
        finally:
            self._sample_cfg = None

    def _generate(self, prompts, max_new_tokens, eos_token_id):
        cap = min(self.max_seq_len, self.cache.max_len)
        for p in prompts:
            if len(p) + 1 > cap:
                raise ValueError(
                    f"prompt of {len(p)} tokens leaves no room to generate "
                    f"within max_seq_len={cap} — KV writes past the row "
                    "capacity would silently drop recent context")
        if any(len(p) + max_new_tokens > cap for p in prompts):
            logger.warning("max_new_tokens=%d clamped to max_seq_len=%d for %d "
                           "prompt(s)", max_new_tokens, cap,
                           sum(len(p) + max_new_tokens > cap for p in prompts))
        pending = list(enumerate(prompts))
        results: Dict[int, List[int]] = {}
        budget: Dict[int, int] = {}
        live: List[int] = []
        prefilling: set = set()
        # per-query stamps, taken when tokens reach the host
        t_start = time.perf_counter()
        timing: Dict[int, Dict[str, float]] = {}
        plen: Dict[int, int] = {}

        def _stamp(retired_uids=()):
            now = time.perf_counter() - t_start
            for u, rec in timing.items():
                if "first" not in rec and len(results[u]) > plen[u]:
                    rec["first"] = now
            for u in retired_uids:
                timing[u]["done"] = now
                timing[u]["new_tokens"] = len(results[u]) - plen[u]
        self.last_timing = timing

        while pending or live:
            step_uids = [u for u in live if u not in prefilling]
            step_tokens: List[List[int]] = [[results[u][-1]] for u in step_uids]
            # admit into this step; each admitted sequence prepays its
            # worst-case blocks (prompt + generation budget)
            while pending and self.state_manager.allocator.free_blocks > 0:
                if self.kv_layout == "paged":
                    worst = self.state_manager.blocks_for(min(
                        len(pending[0][1]) + max_new_tokens, self.cache.max_len))
                    pool = self.state_manager.block_allocator
                    if worst > pool.num_blocks:
                        raise ValueError(
                            f"prompt needs {worst} KV blocks worst-case but the "
                            f"pool only has {pool.num_blocks} — raise "
                            "num_cache_blocks or shorten the prompt/generation budget")
                    if worst > pool.free_blocks:
                        break  # not enough physical blocks; retry later
                uid, prompt = pending.pop(0)
                seq_new = self.state_manager.get_or_create_sequence(uid)
                matched = self._match_prefix(seq_new, list(map(int, prompt)))
                self._reserve(seq_new, len(prompt) + max_new_tokens)
                if matched:
                    seq_new.tokens = list(map(int, prompt))
                    seq_new.pending = seq_new.tokens[matched:]
                else:
                    step_uids.append(uid)
                    step_tokens.append(list(map(int, prompt)))
                results[uid] = list(map(int, prompt))
                timing[uid] = {"admit": time.perf_counter() - t_start}
                plen[uid] = len(prompt)
                budget[uid] = min(max_new_tokens, self.max_seq_len - len(prompt),
                                  self.cache.max_len - len(prompt))
                live.append(uid)
                prefilling.add(uid)
            # pure decode: K steps, one fetch
            if live and not prefilling:
                k = min(64, min(budget[u] for u in live))
                if k < 64 and any(budget[u] != k for u in live):
                    k = 1 << (k.bit_length() - 1)  # ragged budgets: pow2 floor
            else:
                k = 1
            if k > 1:
                tokens = np.zeros((self.max_batch, 1), np.int64)
                active = np.zeros((self.max_batch,), bool)
                slots = []
                for uid in live:
                    seq = self.state_manager.get_sequence(uid)
                    tokens[seq.slot, 0] = results[uid][-1]
                    active[seq.slot] = True
                    slots.append(seq.slot)
                    self._reserve(seq, seq.seen_tokens + k)
                self._maybe_sync_tables()
                toks_np = self._decode_wave(k, tokens, active, slots, list(live))
                self.serving_counters["decode_waves"] += 1
                retired = []
                for uid in list(live):
                    seq = self.state_manager.get_sequence(uid)
                    new = [int(t) for t in toks_np[:, seq.slot]]
                    if eos_token_id is not None and eos_token_id in new:
                        new = new[:new.index(eos_token_id) + 1]
                    seq.seen_tokens += k
                    seq.tokens.extend(new)
                    results[uid].extend(new)
                    self.serving_counters["generated_tokens"] += len(new)
                    budget[uid] -= len(new)
                    if budget[uid] <= 0 or (eos_token_id is not None and new
                                            and new[-1] == eos_token_id):
                        retired.append(uid)
                        live.remove(uid)
                self._flush_batch(retired)
                _stamp(retired)
                continue
            # mixed round: split-fuse prefill + decode, token ids reduced on
            # the device
            outs = self.put(step_uids, step_tokens, argmax_only=True)
            self.serving_counters["mixed_rounds"] += 1
            retired = []
            for uid in list(live):
                if uid not in outs:
                    continue  # still mid-prefill
                prefilling.discard(uid)
                nxt = int(outs[uid])
                results[uid].append(nxt)
                self.serving_counters["generated_tokens"] += 1
                budget[uid] -= 1
                if budget[uid] <= 0 or (eos_token_id is not None and nxt == eos_token_id):
                    retired.append(uid)
                    live.remove(uid)
            self._flush_batch(retired)
            _stamp(retired)
        return [results[i] for i in range(len(prompts))]
