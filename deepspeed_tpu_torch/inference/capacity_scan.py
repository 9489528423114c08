"""The `capacity` serve mode: ZeRO-Inference, Llama layers streamed from host memory and NVMe (counterpart of ``deepspeed_tpu/inference/capacity_scan.py``).

For a model larger than the card: only the embedding, the final norm and the
LM head stay in device memory; every layer's leaves sit in one page-locked
host buffer per layer (int8 with `quant`, quantized per layer as the
`layer_scan` mode does, so the bytes at rest equal `quantize_layer_stacks`'s),
and the last `nvme_layers` layers sit in swap files under `nvme_dir`, read
through the aio engine (`runtime/swap_tensor`). Each forward pass streams the
layers through preallocated device slabs and runs the layer scan's block body
(`quantized_layer_scan.make_block_fn`) on views into the slab, so K2 decodes
every streamed layer and K5 runs every int8 projection:

    HBM peak ≈ resident (embed/norm/head) + 2·slice + KV cache + workspace

(`CapacityPlan.peak_hbm_bytes`; one slice in the synchronous mode).

Staging on CUDA. Two slabs the size of the largest slice; the host-to-device
copies run on a stream of their own. Layer l+1's copy is issued before
layer l's block, so it overlaps l's compute; block l waits, on the compute
stream, for the event that records l's copy; the copy of l+2 into l's slab
waits, on the copy stream, for the event that records the end of block l.
The host never waits for the device inside a pass: the events order the
two streams (the JAX runner throttles its host with "await l−1's output"
instead). At the end of a pass the next pass's layer 0 is already queued.
`double_buffer: False` is the synchronous A/B mode: one slab, so each copy
waits for the previous block and nothing overlaps. `_transfer`,
`_await_transfer` and `_await_result` are the three primitives, at module
level so a test can record the order they are issued in. The device time
the compute stream spends waiting for copies is measured with timing events
and read after the pass (`last_prefetch_stall_ms`).

The NVMe tier: the disk read of layer l+1 is queued right after layer l's
copy is issued, into one of two page-locked ring buffers. Only this tier
makes the host wait inside a pass: for its disk reads, and, before a read
reuses a ring buffer, for the event of the copy that last read it (which
keeps the host at most about two layers ahead of the device). A failed or
short read raises `SwapIOError`.

On the CPU the slabs are host tensors and each copy is a plain copy.

The host tier is built straight from its source, one layer at a time, never
placing all the layers on the card: a JAX parameter tree (`params=`), or a
module's own weights (on the CPU, or on the card, where each layer is copied
off the card and the runner keeps no device copy of it).

Not ported (ROADMAP.md, Queue 1, 'The rest'): the resilience knobs
(`prefetch_watchdog_s`, `dispatch_deadline_s`, `stage_retries`), the fault
points, the memory-plane rows and the program ledger.

Below the runner: the KV-cache and decode-workspace formulas that
`config.choose_serve_mode` and `kv_block_manager.model_kv_budget` read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

CACHE_LEN_MULTIPLE = 128
ALIGN = 256          # bytes between the starts of two leaves in a slice buffer
RESILIENCE_KEYS = ("prefetch_watchdog_s", "dispatch_deadline_s", "stage_retries")
OPTION_KEYS = ("double_buffer", "nvme_dir", "nvme_layers")


def round_up_len(n: int) -> int:
    """Cache-length rounding shared with the generate loops."""
    return -(-int(n) // CACHE_LEN_MULTIPLE) * CACHE_LEN_MULTIPLE


def _model_dims(model_cfg) -> Dict[str, int]:
    from deepspeed_tpu_torch.inference.engine import _cache_dims
    layers, hkv, hd = _cache_dims(model_cfg)
    hidden = getattr(model_cfg, "hidden_size", None) or getattr(model_cfg, "n_embd")
    inter = getattr(model_cfg, "intermediate_size", None) or 4 * hidden
    return {"layers": layers, "kv_heads": hkv, "head_dim": hd,
            "hidden": int(hidden), "inter": int(inter),
            "vocab": int(getattr(model_cfg, "vocab_size"))}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kv_cache_bytes(model_cfg, batch: int, max_len: int, dtype,
                   kv_dtype: Optional[str] = None) -> int:
    """K + V cache bytes for a (batch, max_len) generate. `kv_dtype="int8"`
    is the quantized cache: one byte per element plus one f32 scale per
    (kv head, token slot); otherwise `dtype`'s width."""
    d = _model_dims(model_cfg)
    slots = 2 * d["layers"] * batch * max_len * d["kv_heads"]
    if kv_dtype in ("int8", torch.int8):
        return slots * (d["head_dim"] + 4)
    return slots * d["head_dim"] * _itemsize(dtype)


def decode_workspace_bytes(model_cfg, batch: int, max_len: int, dtype) -> int:
    """Activation bytes a generate keeps beside weights and KV: 2·hidden +
    2·inter per token position up to max_len, plus one f32 logits row per
    sequence."""
    d = _model_dims(model_cfg)
    return (batch * max_len * (2 * d["hidden"] + 2 * d["inter"]) * _itemsize(dtype)
            + batch * d["vocab"] * 4)


@dataclasses.dataclass
class CapacityPlan:
    """The placement's byte accounting, which the documented HBM formula
    and the card test's measured peak are held to."""
    num_layers: int
    slice_bytes: int        # largest per-layer slice (what one copy streams)
    resident_bytes: int     # embed/norm/head in device memory
    kv_bytes: int           # at the plan's (batch, max_len)
    workspace_bytes: int
    host_bytes: int         # the RAM tier at rest
    nvme_bytes: int         # the disk tier at rest
    nvme_layers: int
    double_buffer: bool

    @property
    def peak_hbm_bytes(self) -> int:
        """resident + 2 layer slices (one computing, one arriving) + KV
        cache + activation workspace."""
        return (self.resident_bytes + 2 * self.slice_bytes
                + self.kv_bytes + self.workspace_bytes)


# ------------------------------------------------------------ the primitives
def _transfer(host: torch.Tensor, slab: torch.Tensor, stream, after=None):
    """Copy one layer's host buffer into a device slab. On CUDA the copy
    runs on `stream` (asynchronous, from page-locked memory) after the event
    `after` (the end of the last block that read the slab), and the event
    recording its end is returned; on the CPU it is a plain copy (None)."""
    if stream is None:
        slab.copy_(host)
        return None
    if after is not None:
        stream.wait_event(after)
    with torch.cuda.stream(stream):
        slab.copy_(host, non_blocking=True)
    # the allocator must not hand the slab out again (the runner gone)
    # before this copy ends
    slab.record_stream(stream)
    done = torch.cuda.Event()
    done.record(stream)
    return done


def _await_transfer(copied, compute) -> None:
    """The compute stream waits for a layer's copy (the host does not)."""
    if copied is not None:
        compute.wait_event(copied)


def _await_result(compute):
    """The event recording the end of the block just issued on the compute
    stream, which the next copy into its slab waits for; None on the CPU."""
    if compute is None:
        return None
    done = torch.cuda.Event()
    done.record(compute)
    return done


# ------------------------------------------------------------------ layouts
def _flatten(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of nested dicts in key order (a module's layer and
    a tree's give the same order); a quantized leaf gives two."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _unflatten(pairs) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


@dataclasses.dataclass(frozen=True)
class _Leaf:
    path: tuple
    offset: int
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * _itemsize(self.dtype)


def _layout(pairs) -> Tuple[List[_Leaf], int]:
    """Each leaf's place in one flat buffer, starts `ALIGN`-byte aligned
    (K5 reads its operands through TMA): (leaves, buffer bytes)."""
    leaves, off = [], 0
    for path, t in pairs:
        leaves.append(_Leaf(path, off, tuple(t.shape), t.dtype))
        off += -(-leaves[-1].nbytes // ALIGN) * ALIGN
    return leaves, off


def _views(buf: torch.Tensor, layout: List[_Leaf]) -> dict:
    """The layer tree as views into a flat uint8 buffer."""
    return _unflatten((leaf.path, buf[leaf.offset:leaf.offset + leaf.nbytes]
                       .view(leaf.dtype).view(leaf.shape)) for leaf in layout)


class _NVMeLeaf:
    """A disk-tier leaf in `params_view`: its shape and dtype; the bytes are
    in the layer's swap file."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, tuple(shape), dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * _itemsize(self.dtype)

    def __repr__(self):
        return f"_NVMeLeaf({self.name}, {self.shape}, {self.dtype})"


@dataclasses.dataclass
class _Staged:
    layer: int
    slab: int
    tree: dict
    copied: Any          # the copy's event (None on the CPU)


# ------------------------------------------------------------------ sources
def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _take(x, l: int) -> torch.Tensor:
    """Layer l of a stacked numpy or torch leaf, as a torch tensor (the
    other layers are not copied)."""
    return x.detach()[l] if isinstance(x, torch.Tensor) else _tensor(np.asarray(x)[l])


def _layer_of(leaf, l: int, num_layers: int):
    """Layer l of a stacked leaf; a stacked int8 leaf keeps its bytes, its
    flat scales cut per layer as `quantize_layer_stacks` cuts them."""
    from deepspeed_tpu_torch.inference.quantization import is_quantized_leaf
    from deepspeed_tpu_torch.ops.quantization import dequantize_int8_blockwise
    if not is_quantized_leaf(leaf):
        return _take(leaf, l)
    s = _tensor(leaf["scales"])
    if np.ndim(leaf["__q8__"]) < 3:
        return dequantize_int8_blockwise(_tensor(leaf["__q8__"]), s.reshape(-1))[l]
    if s.dim() == 1 and s.shape[0] % num_layers == 0:
        s = s.reshape(num_layers, -1)
    return {"__q8__": _take(leaf["__q8__"], l), "scales": s[l]}


def check_options(block: str, options: Optional[dict]) -> dict:
    """The `capacity` block (or `resilience`, for its capacity keys): the
    resilience knobs raise, as not ported; other unknown keys are ignored
    with a warning."""
    from deepspeed_tpu_torch.runtime.config_utils import unported
    from deepspeed_tpu_torch.utils.logging import logger
    options = dict(options or {})
    for key in options:
        if key in RESILIENCE_KEYS:
            raise unported(f"{block} option {key!r}", "The rest")
        if block == "capacity" and key not in OPTION_KEYS:
            logger.warning(f"capacity: ignoring unknown option {key!r} (known: {OPTION_KEYS})")
    return options


# ------------------------------------------------------------------- runner
class CapacityRunner:
    """The capacity mode's tiers and its streamed forward pass.

    `source` is a JAX parameter tree of a Llama (numpy or torch leaves,
    layers stacked on a leading L axis, int8 leaves kept as given) or a
    `LlamaForCausalLM` whose own weights are read (CPU or CUDA). Floating
    weights are cast to `infer_cfg.dtype`; with `quantized` each layer's
    kernels are quantized per layer (`group_size`) as `quantize_layer_stacks`
    does, on the device the weights are read from. `options` is the
    `capacity` config block."""

    def __init__(self, model_cfg, infer_cfg, source, device, quantized: bool = False,
                 group_size: int = 256, options: Optional[dict] = None, fused: bool = True):
        from deepspeed_tpu_torch.inference.quantized_layer_scan import make_block_fn
        options = check_options("capacity", options)
        self.model_cfg, self.infer_cfg = model_cfg, infer_cfg
        self.device = torch.device(device)
        self.quantized, self.group_size = bool(quantized), int(group_size)
        self.double_buffer = bool(options.get("double_buffer", True))
        self._dtype = infer_cfg.dtype
        self.num_layers = _model_dims(model_cfg)["layers"]
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._block = make_block_fn(model_cfg, fused=fused)

        module = source if isinstance(source, nn.Module) else None
        self.resident = self._resident(module, source)
        self._layout, self._buf_bytes = _layout(_flatten(self._layer_source(module, source, 0)))
        L = self.num_layers
        nvme_layers = int(options.get("nvme_layers", 0) or 0)
        if nvme_layers and not options.get("nvme_dir"):
            raise ValueError("capacity: nvme_layers > 0 needs nvme_dir")
        nvme_layers = min(max(nvme_layers, 0), L)
        self._nvme_first = L - nvme_layers
        # host tier: one page-locked buffer a layer, filled from the source
        self._ram: Dict[int, torch.Tensor] = {}
        for l in range(self._nvme_first):
            self._ram[l] = self._host_buffer()
            self._fill(self._ram[l], self._layer_source(module, source, l))
        # NVMe tier: written through one host buffer, layer by layer; two
        # ring buffers take the reads back
        self._nvme = None
        self._ring: List[torch.Tensor] = []
        self._ring_read: List[Any] = []        # the copy that last read each
        self._ring_next = 0
        self._queued: Dict[int, int] = {}      # layer → ring buffer it is read into
        if nvme_layers:
            from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper
            self._nvme = AsyncTensorSwapper(str(options["nvme_dir"]))
            self._ring = [self._host_buffer() for _ in range(2)]
            self._ring_read = [None, None]
            for l in range(self._nvme_first, L):
                self._fill(self._ring[0], self._layer_source(module, source, l))
                self._nvme.swap_out(self._swap_name(l), self._ring[0])
                self._nvme.synchronize()
        # staging: two device slabs (one when synchronous)
        self._slabs = [torch.empty(self._buf_bytes, dtype=torch.uint8, device=self.device)
                       for _ in range(2 if self.double_buffer else 1)]
        self._slab_free: List[Any] = [None] * len(self._slabs)
        self._slab_next = 0
        self._staged0: Optional[_Staged] = None
        self._stall_events: List[Tuple[Any, Any]] = []
        self._stall_ms = 0.0
        self.plan = self._build_plan()

    # ------------------------------------------------------------ building
    def _resident(self, module, source) -> dict:
        """embed, final norm and LM head in the serving dtype on the device
        (a pre-quantized one dequantized, as `quantize_layer_stacks` does).
        A module's tensors already there in that dtype are used as they
        are."""
        from deepspeed_tpu_torch.inference.quantization import (
            dequantize_param_tree, tree_map)

        def place(x):
            x = _tensor(x)
            if x.is_floating_point():
                x = x.to(self._dtype)
            return x.to(self.device)

        if module is not None:
            tree = {"embed_tokens": module.embed_tokens,
                    "norm": {"weight": module.norm.weight}}
            if module.lm_head is not None:
                tree["lm_head"] = module.lm_head.weight.detach().t().contiguous()
        else:
            tree = dequantize_param_tree(
                tree_map(_tensor, {k: v for k, v in source.items() if k != "layers"}))
        return tree_map(place, tree)

    def _layer_source(self, module, source, l: int) -> dict:
        """Layer l in its at-rest form (cast, then quantized per layer with
        `quant`), on the device it was read from."""
        from deepspeed_tpu_torch.inference.quantization import is_quantized_leaf, tree_map
        from deepspeed_tpu_torch.models.llama import layer_tree
        from deepspeed_tpu_torch.ops.quantization import quantize_int8_blockwise
        if module is not None:
            tree = layer_tree(module.layers[l])
        else:
            tree = tree_map(lambda x: _layer_of(x, l, self.num_layers), source["layers"])

        def at_rest(x):
            if is_quantized_leaf(x):
                return x
            if x.is_floating_point():
                x = x.to(self._dtype)
            if self.quantized and x.dim() >= 2 and x.numel() >= 4096 and x.is_floating_point():
                q, s = quantize_int8_blockwise(x, self.group_size, reciprocal=True)
                return {"__q8__": q, "scales": s}
            return x

        return tree_map(at_rest, tree)

    def _host_buffer(self) -> torch.Tensor:
        return torch.empty(self._buf_bytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def _fill(self, buf: torch.Tensor, tree: dict) -> None:
        pairs = _flatten(tree)
        if [(p, tuple(t.shape), t.dtype) for p, t in pairs] != \
                [(leaf.path, leaf.shape, leaf.dtype) for leaf in self._layout]:
            raise ValueError("capacity: every layer must have layer 0's leaves")
        for leaf, (_, t) in zip(self._layout, pairs):
            dst = buf[leaf.offset:leaf.offset + leaf.nbytes].view(leaf.dtype).view(leaf.shape)
            dst.copy_(t)

    @staticmethod
    def _swap_name(l: int) -> str:
        return f"cap_l{l}"

    # ------------------------------------------------------------ streaming
    def _host_slice(self, l: int) -> Tuple[torch.Tensor, int]:
        """Layer l's host buffer and its ring index (-1 for the RAM tier);
        a disk layer's queued read is waited for here."""
        if l in self._ram:
            return self._ram[l], -1
        if l not in self._queued:
            self._queue_disk(l)
        self._nvme.synchronize()
        r = self._queued.pop(l)
        return self._ring[r], r

    def _queue_disk(self, l: int) -> None:
        """Queue the read of disk layer l into the next ring buffer, once
        the copy that last read that buffer is done."""
        if self._nvme is None or l in self._ram or l in self._queued:
            return
        r = self._ring_next
        self._ring_next ^= 1
        if self._ring_read[r] is not None:
            self._ring_read[r].synchronize()
        self._nvme.swap_in(self._swap_name(l), out=self._ring[r])
        self._queued[l] = r

    def _transfer_layer(self, l: int) -> _Staged:
        """Issue layer l's copy into the next slab, then queue the disk read
        of layer l+1 (when it is on disk) so it overlaps."""
        host, ring = self._host_slice(l)
        s = self._slab_next
        self._slab_next = (s + 1) % len(self._slabs)
        copied = _transfer(host, self._slabs[s], self._copy_stream, self._slab_free[s])
        if ring >= 0:
            self._ring_read[ring] = copied
        self._queue_disk((l + 1) % self.num_layers)
        return _Staged(l, s, _views(self._slabs[s], self._layout), copied)

    def _run_block(self, staged: _Staged, h, aux, kv, compute):
        if compute is not None:
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record(compute)
        _await_transfer(staged.copied, compute)
        if compute is not None:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record(compute)
            self._stall_events.append((t0, t1))
        h, _ = self._block(h, staged.tree, aux, kv)
        self._slab_free[staged.slab] = _await_result(compute)
        return h

    def _pass(self, h, aux, kv_layers):
        """One sweep over the layers; `kv_layers[l]` is layer l's (K, V)
        cache pair, written in place."""
        compute = torch.cuda.current_stream(self.device) if self.device.type == "cuda" \
            else None
        self._drain_stall_events()
        L = self.num_layers
        if not self.double_buffer:
            for l in range(L):
                h = self._run_block(self._transfer_layer(l), h, aux, kv_layers[l], compute)
            return h
        staged = self._staged0 if self._staged0 is not None else self._transfer_layer(0)
        self._staged0 = None
        for l in range(L):
            nxt = self._transfer_layer(l + 1) if l + 1 < L else None
            h = self._run_block(staged, h, aux, kv_layers[l], compute)
            staged = nxt
        # the next pass's layer 0, copied while the head and sampling run
        self._staged0 = self._transfer_layer(0)
        return h

    def _drain_stall_events(self) -> None:
        """Fold the stall pairs the device has finished into the total,
        without waiting for the rest."""
        done = 0
        for t0, t1 in self._stall_events:
            if not t1.query():
                break
            self._stall_ms += t0.elapsed_time(t1)
            done += 1
        del self._stall_events[:done]

    def reset_stats(self) -> None:
        """Start a new `last_prefetch_stall_ms` window."""
        self._stall_events.clear()
        self._stall_ms = 0.0

    @property
    def last_prefetch_stall_ms(self) -> float:
        """Device ms the compute stream waited for copies since
        `reset_stats` (waits for the last recorded pass to finish)."""
        if self._stall_events:
            self._stall_events[-1][1].synchronize()
            self._drain_stall_events()
        return self._stall_ms

    # ------------------------------------------------------------- calling
    def apply(self, ids, cache, logits_at=None, last_only: bool = False):
        """`(logits, cache)` for `ids` (B, S) over a dense `KVCache`, written
        in place, with its cursors advanced by S; `logits_at`/`last_only`
        as in `quantized_layer_scan.scan_logits`."""
        from deepspeed_tpu_torch.inference.quantized_layer_scan import scan_inputs, scan_logits
        h, aux = scan_inputs(self.model_cfg, self.resident, ids, cache.index, cache.max_len)
        h = self._pass(h, aux, [(cache.k[l], cache.v[l]) for l in range(self.num_layers)])
        logits = scan_logits(self.model_cfg, self.resident, h, logits_at=logits_at,
                             last_only=last_only)
        return logits, cache.replace(index=cache.index + ids.shape[1])

    def forward(self, ids) -> torch.Tensor:
        """Logits (B, S, V) of `ids` with no cache of the caller's: the
        streamed layers over a scratch cache of the rounded length."""
        from deepspeed_tpu_torch.inference.engine import _cache_dims
        from deepspeed_tpu_torch.inference.kv_cache import KVCache
        b, s = ids.shape
        layers, kv_heads, head_dim = _cache_dims(self.model_cfg)
        cache = KVCache.create(layers, b, round_up_len(s), kv_heads, head_dim,
                               dtype=self._dtype, device=self.device)
        return self.apply(ids, cache)[0]

    # ---------------------------------------------------------- accounting
    def params_view(self) -> dict:
        """The engine's tree: the resident leaves, and `layers` as one tree
        a layer: views into the host buffers, or `_NVMeLeaf`s for the disk
        tier."""
        def layer(l):
            if l in self._ram:
                return _views(self._ram[l], self._layout)
            return _unflatten((leaf.path, _NVMeLeaf(f"{self._swap_name(l)}:{leaf.offset}",
                                                    leaf.shape, leaf.dtype))
                              for leaf in self._layout)
        return dict(self.resident, layers=[layer(l) for l in range(self.num_layers)])

    def host_resident(self) -> bool:
        """True when every RAM-tier buffer is a host tensor, page-locked on
        CUDA: no layer leaf lives on the card between passes."""
        pinned = self.device.type == "cuda"
        return all(b.device.type == "cpu" and (b.is_pinned() or not pinned)
                   for b in self._ram.values())

    def slice_bytes(self) -> int:
        """A layer's leaf bytes (every layer has layer 0's leaves)."""
        return sum(leaf.nbytes for leaf in self._layout)

    def h2d_bytes_pass(self) -> int:
        """Host-to-device bytes one sweep streams (one decode step)."""
        return self.num_layers * self.slice_bytes()

    def weight_bytes_step_pair(self) -> Tuple[int, int]:
        """(at rest, dense equivalent) weight bytes a decode step reads: the
        streamed slices plus the resident final norm and LM head (the
        embedding is a B-row gather, left out)."""
        item = _itemsize(self._dtype)
        resident = sum(_nbytes(t) for _, t in _flatten(self.resident.get("norm", {})))
        if self.resident.get("lm_head") is not None:
            resident += _nbytes(self.resident["lm_head"])
        dense = 0
        for leaf in self._layout:
            if leaf.path[-1] == "scales":
                continue
            dense += int(np.prod(leaf.shape, dtype=np.int64)) * item
        return self.h2d_bytes_pass() + resident, self.num_layers * dense + resident

    def _build_plan(self) -> CapacityPlan:
        cfg = self.infer_cfg
        b = int(getattr(cfg, "max_batch_size", None) or 1)
        max_len = round_up_len(getattr(cfg, "max_out_tokens", 1024))
        kv_dtype = getattr(cfg, "kv_cache_dtype", None)
        return CapacityPlan(
            num_layers=self.num_layers, slice_bytes=self.slice_bytes(),
            resident_bytes=sum(_nbytes(t) for _, t in _flatten(self.resident)),
            kv_bytes=kv_cache_bytes(self.model_cfg, b, max_len, cfg.dtype, kv_dtype=kv_dtype),
            workspace_bytes=decode_workspace_bytes(self.model_cfg, b, max_len, cfg.dtype),
            host_bytes=len(self._ram) * self.slice_bytes(),
            nvme_bytes=(self.num_layers - len(self._ram)) * self.slice_bytes(),
            nvme_layers=self.num_layers - len(self._ram), double_buffer=self.double_buffer)

    def plan_for(self, batch: int, seq: int, new_tokens: int) -> CapacityPlan:
        """The plan at one generate's shapes."""
        cfg = self.infer_cfg
        max_len = round_up_len(seq + new_tokens)
        return dataclasses.replace(
            self.plan,
            kv_bytes=kv_cache_bytes(self.model_cfg, batch, max_len, cfg.dtype,
                                    kv_dtype=getattr(cfg, "kv_cache_dtype", None)),
            workspace_bytes=decode_workspace_bytes(self.model_cfg, batch, max_len, cfg.dtype))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0
