"""The grouped expert GEMM (K6, K6-bwd dlhs and drhs, K8-e) of two trees, in turns, on one card.

    python3 chip_gmm_ab.py [ROOT ...]

Each ROOT is a checkout of this repository (default: this one). In the
order given, each runs in a process of its own that imports that tree's
`chip_smoke` and package, builds its `grouped_gemm.cu`, and runs the same
cases through that tree's `check_gmm`, `check_gmm_bwd` and
`check_sharded_gmm` (each kernel against its plain version, timed with CUDA
events beside `torch._grouped_mm`; each kernel's device time per call is
also read from `torch.profiler`, since a call of a few microseconds is
bound by the host's launch path, not the card): the Qwen1.5-MoE prefill, training and
decode calls, Mixtral-8x7B's w1 and w2, a skewed Qwen routing (one expert
holds 2,048 of the 8,192 rows), and the odd layouts of `chip_smoke.py`.
Every case draws its inputs from its own seed, so both trees see the same
data. Give roots as `A B B A` to compare two trees on one card; the rows
go to `chiprun_out/gmm_ab.json` and a table of kernel ms by case and tree
to the standard output, after the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

OUT = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "gmm_ab.json"
SKEW_ROWS, SKEW_EXPERTS, SKEW_HOT = 8192, 60, 2048


def cases(cs, torch):
    """(name, kind, check, k, n, sizes drawn from a generator) for every
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
    return ([(name, "grouped_gemm", cs.check_gmm, k, n, draw) for name, k, n, draw in fwd]
            + [(name, "grouped_gemm_bwd", cs.check_gmm_bwd, k, n, draw)
               for name, k, n, draw in bwd]
            + [(name, "sharded_grouped_gemm", cs.check_sharded_gmm, k, n, draw)
               for name, k, n, draw in ep])


def one(root: str) -> None:
    """Run every case on the tree at `root`; one JSON line a case."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    timings = []
    event_ms = cs.cuda_ms

    def cuda_ms(fn, iters=20, warmup=3):  # the tree's timer, and device ms a call
        ms = event_ms(fn, iters, warmup)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        timings.append((ms, sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3))
        return ms
    cs.cuda_ms = cuda_ms
    for seed, (name, kind, check, k, n, draw) in enumerate(cases(cs, torch)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        timings.clear()
        row = check(gen, name, k, n, draw(gen))
        parts = ({f"{kind}_{key}": row[f"grouped_gemm_bwd_{key}"] for key in ("dlhs", "drhs")}
                 if kind == "grouped_gemm_bwd" else {kind: row})
        for r in parts.values():
            r["device_ms"] = next(dev for ms, dev in timings if ms == r["ms"])
        print(json.dumps({"tree": root, "case": name, "shape": row["shape"], **parts}),
              flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_gmm_ab: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    roots = [str(pathlib.Path(r).resolve()) for r in (sys.argv[1:] or ["."])]
    rows, failed = [], 0
    for turn, root in enumerate(roots):
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--one",
                               root], capture_output=True, text=True)
        rows += [dict(json.loads(line), turn=turn) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
        if proc.returncode != 0:  # the other trees still run; the exit code says so
            print(f"turn {turn} ({root}) failed:", proc.stderr[-8000:], sep="\n",
                  file=sys.stderr)
            failed = proc.returncode
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"card": smi.strip(), "rows": rows}, indent=1))
    for row in rows:
        for kind, r in row.items():
            if isinstance(r, dict) and "ms" in r:
                print(f"{row['turn']} {pathlib.Path(row['tree']).name:>12} {kind:>26} "
                      f"{row['case']:>28}: ms {r['ms']:.4f} device {r['device_ms']:.4f} "
                      f"bound {r['bound_ms']:.4f} "
                      f"library {r['library_ms']} rel_err {r['rel_max_err']:.2e}")
    return failed


if __name__ == "__main__":
    sys.exit(main())
