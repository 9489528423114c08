"""One family of kernels of two or more trees, in turns, on one card.

    python3 chip_ab.py {gmm,decode,sparse,build} [ROOT ...]

`gmm`: the grouped expert GEMM (K6, K6-bwd dlhs and drhs, K8-e) through
each tree's `check_gmm`, `check_gmm_bwd` and `check_sharded_gmm`, beside
`torch._grouped_mm`: the Qwen1.5-MoE prefill, training and decode calls,
Mixtral-8x7B's w1 and w2, a skewed Qwen routing (one expert holds 2,048 of
the 8,192 rows) and the odd layouts of `chip_smoke.py`.
`decode`: the decode-attention kernels (K2, K2-int8, K3, K3-int8, K3-alibi,
K8-a, K8-b) through each tree's `check_decode`, `check_paged_decode`,
`check_sharded_decode` and `check_sharded_paged_decode`, beside SDPA: the
rows of `chip_smoke.py`'s kernel phase and `PERF.md`'s table, then K3 as a
v2 decode step calls it (idle rows parked or empty) and over twice the
table width.
`sparse`: the block-sparse attention kernel (K7) through each tree's
`check_sparse` over this checkout's `SPARSE_SHAPES` and `sparse_layout`
(so every tree sees the same layouts), beside its SDPA yardstick.
`build`: every kernel library of each tree built from nothing (its build
directory emptied first), all at once as `chip_smoke.py` builds them: the
wall seconds, and each source's compiler seconds where the tree records
them (`KernelLibrary.build_seconds`).

Each ROOT is a checkout of this repository (default: this one). In the
order given, each runs in a process of its own that imports that tree's
`chip_smoke` and package, builds its kernels, and runs the same cases, each
kernel held against its plain version and timed with CUDA events. Every
timed call is also read by `device_ms` (torch.profiler's CUDA time of every
kernel a call launches), since at a few microseconds a call the events read
the host's launch path as soon as it is the slower: the tree's own where
its `chip_smoke` has one, else this checkout's (`sparse`'s checks free
their inputs, so its calls are read as they are timed). Every case draws
its inputs from its own seed, so every tree sees the same data. Give roots as
`A B B A` to compare two trees on one card; the rows go to
`chiprun_out/<family>_ab.json` and a table of kernel and library times by
case and tree to the standard output, after the card's name and power
limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SKEW_ROWS, SKEW_EXPERTS, SKEW_HOT = 8192, 60, 2048
BLOOM = dict(h=32, hkv=32, d=128, alibi=True)      # bloom-7b1's attention
BLOOM_560M = dict(h=16, hkv=16, d=64, alibi=True)


def gmm_cases(cs, torch):
    """(name, run(gen, rng) -> (shape, {kind: row})) for every grouped-GEMM
    case, `cs` the tree's chip_smoke."""
    def sizes(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    def routed(tokens, experts, k):
        return lambda gen: cs.routing_sizes(gen, tokens, experts, k)

    def skewed(gen):  # one expert holds SKEW_HOT rows, the rest share the others
        rest = cs.routing_sizes(gen, (SKEW_ROWS - SKEW_HOT) // 4, SKEW_EXPERTS - 1, 4)
        return torch.cat([rest[:7], sizes([SKEW_HOT]), rest[7:]])

    def fixed(values):
        return lambda gen: sizes(values)

    def run(kind, check, name, k, n, draw):
        def go(gen, rng):
            row = check(gen, name, k, n, draw(gen))
            if kind == "grouped_gemm_bwd":
                return row["shape"], {f"{kind}_{key}": row[f"grouped_gemm_bwd_{key}"]
                                      for key in ("dlhs", "drhs")}
            return row["shape"], {kind: row}
        return name, go

    qwen, decode = routed(cs.B * cs.PROMPT, 60, 4), routed(cs.B, 60, 4)
    train, mixtral = routed(cs.MOE_MBS * cs.MOE_SEQ, 60, 4), routed(2048, 8, 2)
    odd = [("empty first and last groups", 1408, 2048, fixed([0, 300, 0, 77, 211, 0])),
           ("one group holds every row", 2048, 1408, fixed([0, 0, 517, 0])),
           ("M = 5", 40, 24, fixed([2, 0, 3]))]
    fwd = [("qwen prefill gate/up", 2048, 1408, qwen), ("qwen prefill down", 1408, 2048, qwen),
           ("qwen decode gate/up", 2048, 1408, decode), ("qwen decode down", 1408, 2048, decode),
           ("mixtral prefill w1", 4096, 14336, mixtral),
           ("mixtral prefill w2", 14336, 4096, mixtral),
           ("qwen skewed gate/up", 2048, 1408, skewed)] + odd
    bwd = [("qwen train gate/up", 2048, 1408, train), ("qwen train down", 1408, 2048, train),
           ("mixtral w1", 4096, 14336, mixtral), ("qwen skewed gate/up", 2048, 1408, skewed),
           ("qwen decode gate/up", 2048, 1408, decode)] + odd
    ep = [("qwen prefill gate/up", 2048, 1408, qwen), ("qwen prefill down", 1408, 2048, qwen),
          ("qwen decode gate/up", 2048, 1408, decode)]
    return ([run("grouped_gemm", cs.check_gmm, *c) for c in fwd]
            + [run("grouped_gemm_bwd", cs.check_gmm_bwd, *c) for c in bwd]
            + [run("sharded_grouped_gemm", cs.check_sharded_gmm, *c) for c in ep])


def v2_step(cs, gen, rng, h=32, hkv=8, d=128, alibi=False, idle="parked", t=None):
    """K3 as a v2 decode step calls it: 48 live rows a few tokens past their
    256-token prompts and 16 idle rows, parked at the capacity as the
    engine parks them (`idle="parked"`) or empty (`"empty"`), staged; with
    `t`, the kernel-phase rows over tables padded with -1 to T = t (more
    chunks past every row's end). Held against the plain version, timed,
    with its bound; no library call."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    b, cap = 64, cs.T * cs.BS
    if t is None:
        lengths_np = np.concatenate([rng.integers(258, 272, 48),
                                     [cap + 1 if idle == "parked" else 0] * 16])
    else:
        lengths_np = np.concatenate([rng.integers(1, cs.BS + 1, 32),
                                     rng.integers(cs.BS + 1, 2 * cs.BS + 1, 31), [cap + 1]])
    lengths_np = lengths_np.astype(np.int32)
    k_pool, v_pool, _, tables, tables_t = cs.paged_inputs(
        rng, gen, [-(-int(n) // cs.BS) if n <= cap else 0 for n in lengths_np], False, hkv, d)
    if t is not None:
        tables = np.concatenate([tables, np.full((b, t - cs.T), -1, np.int32)], axis=1)
        tables_t = torch.from_numpy(tables).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    q = cs.randn((b, 1, h, d), gen)
    kw = dict(k_new=cs.randn((b, hkv, d), gen), v_new=cs.randn((b, hkv, d), gen),
              alibi=alibi_slopes(h, "cuda") if alibi else None)
    out = pa.paged_decode_attention(q, k_pool, v_pool, tables_t, lengths, **kw)
    ref = pa.paged_decode_attention_plain(q, k_pool, v_pool, tables_t, lengths, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= cs.KERNEL_TOL, err
    hi = np.minimum(lengths_np - 1, tables.shape[1] * cs.BS)
    keys = int(np.maximum(hi, 0).sum()) + b
    nbytes = (cs.kv_bytes(tables, zip(np.zeros(b, np.int64), hi), False, hkv, d)
              + q.numel() * 4 + tables.size * 4 + b * 4 + 2 * b * hkv * d * 2)
    bound_ms, _ = cs.bound(nbytes, 4.0 * d * h * keys)
    return dict(shape=f"B={b} H={h} Hkv={hkv} D={d} T={tables.shape[1]} idle={idle}",
                max_abs_err=err, bound_ms=bound_ms, library_ms=None, plain_ms=None,
                ms=cs.cuda_ms(lambda: pa.paged_decode_attention(q, k_pool, v_pool, tables_t,
                                                                lengths, **kw)))


def decode_cases(cs, torch):
    """(name, run(gen, rng) -> (shape, {kind: row})) for every decode case,
    `cs` the tree's chip_smoke."""
    paged = cs.check_paged_decode
    calls = [
        ("K2", lambda gen, rng: cs.check_decode(gen)),
        ("K2-int8", lambda gen, rng: cs.check_decode(gen, int8=True)),
        ("K2 group 1", lambda gen, rng: cs.check_decode(gen, h=16, hkv=16)),
        ("K3", lambda gen, rng: paged(gen, rng, staged=True)),
        ("K3 unstaged", lambda gen, rng: paged(gen, rng, staged=False)),
        ("K3 window 300", lambda gen, rng: paged(gen, rng, staged=True, window=300)),
        ("K3-int8", lambda gen, rng: paged(gen, rng, staged=True, int8=True)),
        ("K3-int8 unstaged", lambda gen, rng: paged(gen, rng, staged=False, int8=True)),
        ("K3-int8 window 300", lambda gen, rng: paged(gen, rng, staged=True, window=300,
                                                      int8=True)),
        ("K3-alibi", lambda gen, rng: paged(gen, rng, staged=True, **BLOOM)),
        ("K3-alibi unstaged", lambda gen, rng: paged(gen, rng, staged=False, **BLOOM)),
        ("K3-alibi int8", lambda gen, rng: paged(gen, rng, staged=True, int8=True, **BLOOM)),
        ("K3-alibi D=64", lambda gen, rng: paged(gen, rng, staged=True, **BLOOM_560M)),
        ("K8-a", lambda gen, rng: cs.check_sharded_decode(gen)),
        ("K8-b", lambda gen, rng: cs.check_sharded_paged_decode(gen, rng)),
        # a v2 decode step's call, with the idle rows parked or empty, and
        # the kernel-phase rows over twice the table width
        ("K3 v2 step", lambda gen, rng: v2_step(cs, gen, rng)),
        ("K3 v2 step, idle empty", lambda gen, rng: v2_step(cs, gen, rng, idle="empty")),
        ("K3-alibi v2 step", lambda gen, rng: v2_step(cs, gen, rng, **BLOOM)),
        ("K3-alibi v2 step, idle empty", lambda gen, rng: v2_step(cs, gen, rng, idle="empty",
                                                                   **BLOOM)),
        ("K3, T = 8", lambda gen, rng: v2_step(cs, gen, rng, t=2 * cs.T)),
    ]

    def run(call):
        def go(gen, rng):
            row = call(gen, rng)
            return row["shape"], {"decode": row}
        return go
    return [(name, run(call)) for name, call in calls]


def own_smoke():
    """This checkout's `chip_smoke`, loaded beside the tree's."""
    spec = importlib.util.spec_from_file_location("chip_ab_own", HERE / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return own


def sparse_cases(cs, torch):
    """(name, run(gen, rng) -> (shape, {kind: row})) for every K7 case, `cs`
    the tree's chip_smoke, whose layouts become this checkout's."""
    own = own_smoke()
    cs.sparse_layout = own.sparse_layout

    def run(shape):
        def go(gen, rng):
            row = cs.check_sparse(gen, *shape)
            return row["shape"], {"block_sparse_attention": row}
        return go
    return [(shape[0], run(shape)) for shape in own.SPARSE_SHAPES]


def build_one(root: str) -> None:
    """`build` on the tree at `root`: one JSON line."""
    import shutil
    import time
    from deepspeed_tpu_torch.op_builder import build_all, builder
    from deepspeed_tpu_torch.ops.cuda import (block_sparse_attention, decode_attention,
                                              flash_attention, grouped_gemm, paged_attention,
                                              quantized_matmul)
    libs = {}
    for module in (flash_attention, decode_attention, paged_attention, quantized_matmul,
                   grouped_gemm, block_sparse_attention):
        for value in vars(module).values():
            if isinstance(value, builder.KernelLibrary):
                libs[value.source] = value
    shutil.rmtree(builder.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    build_all(libs.values())
    wall = time.perf_counter() - t0
    print(json.dumps({"tree": root, "case": "build", "build": {
        "wall_s": wall, "by_source": {lib.source.name: getattr(lib, "build_seconds", None)
                                      for lib in libs.values()}}}), flush=True)


FAMILIES = {"gmm": gmm_cases, "decode": decode_cases, "sparse": sparse_cases, "build": None}
# families whose checks free their inputs before they return: each call
# timed with the default count (the kernel's and the library's, not the
# slow plain versions') is read by `device_ms` as it is timed
EAGER = ("sparse",)


def one(family: str, root: str) -> None:
    """Run every case of `family` on the tree at `root`; one JSON line a case."""
    sys.path.insert(0, root)
    os.chdir(root)
    if family == "build":
        return build_one(root)
    import numpy as np
    import torch
    import chip_smoke as cs
    timer = getattr(cs, "device_ms", None)
    if timer is None:  # a tree from before `device_ms`: this checkout's
        timer = own_smoke().device_ms
    timed = {}  # event ms -> the call it timed, or that call's device ms
    event_ms = cs.cuda_ms
    eager = family in EAGER

    def cuda_ms(fn, iters=20, warmup=3):  # the tree's timer, keeping the call
        ms = event_ms(fn, iters, warmup)
        timed[ms] = timer(fn) if eager and iters >= 20 else fn
        return ms
    cs.cuda_ms = cuda_ms
    for seed, (name, run) in enumerate(FAMILIES[family](cs, torch)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        timed.clear()
        shape, parts = run(gen, np.random.default_rng(seed))
        for r in parts.values():  # device times the tree's check did not take
            for key in ("", "library_"):
                if f"{key}device_ms" not in r and r.get(f"{key}ms") in timed:
                    got = timed[r[f"{key}ms"]]
                    r[f"{key}device_ms"] = got if isinstance(got, float) else timer(got)
        print(json.dumps({"tree": root, "case": name, "shape": shape, **parts}), flush=True)


def main() -> int:
    if len(sys.argv) > 3 and sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) < 2 or sys.argv[1] not in FAMILIES:
        print(f"usage: chip_ab.py {{{','.join(FAMILIES)}}} [ROOT ...]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    family = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    roots = [str(pathlib.Path(r).resolve()) for r in (sys.argv[2:] or ["."])]
    rows, failed = [], 0
    for turn, root in enumerate(roots):
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--one",
                               family, root], capture_output=True, text=True)
        rows += [dict(json.loads(line), turn=turn) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
        if proc.returncode != 0:  # the other trees still run; the exit code says so
            print(f"turn {turn} ({root}) failed:", proc.stderr[-8000:], sep="\n",
                  file=sys.stderr)
            failed = proc.returncode
    out = HERE / "chiprun_out" / f"{family}_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": smi.strip(), "rows": rows}, indent=1))
    for row in rows:
        if "build" in row:
            print(f"{row['turn']} {pathlib.Path(row['tree']).name:>12} build "
                  f"{row['build']['wall_s']:.1f} s {json.dumps(row['build']['by_source'])}")
        for kind, r in row.items():
            if not (isinstance(r, dict) and "ms" in r):
                continue
            library = (f"library {r['library_ms']:.4f} device {r.get('library_device_ms')} "
                       if r.get("library_ms") is not None else "")
            err = r.get("max_abs_err", r.get("rel_max_err"))
            print(f"{row['turn']} {pathlib.Path(row['tree']).name:>12} {kind:>26} "
                  f"{row['case']:>28}: ms {r['ms']:.4f} device {r['device_ms']:.4f} "
                  f"bound {r['bound_ms']:.4f} {library}err {err:.2e}")
    return failed


if __name__ == "__main__":
    sys.exit(main())
