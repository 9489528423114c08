"""Smoke run of deepspeed_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. prints the card (`nvidia-smi` name and power limit) and the torch/CUDA
   versions;
2. builds every kernel of the serving path from `deepspeed_tpu_torch/csrc/`
   with `nvcc`, all at once;
3. holds each kernel against its plain PyTorch version in bf16 at the
   serving shapes, and times the kernel, the plain version and one PyTorch
   library call for the same function with CUDA events;
4. serves Llama-3-8B at full width and depth with random bf16 weights:
   `forward` on 4 x 512 tokens, greedy `generate` of 64 tokens (the main
   path, whose kernel launches are counted), a sampled `generate`, the
   last decode step's logits against `forward` on the generated sequence,
   and a 2-layer model of the same width against the plain versions in f32
   on the CPU;
5. prints one JSON line of kernels, then the result line.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing a result. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import torch

SEED = 0
B, PROMPT, NEW = 4, 512, 64
H, HKV, D = 32, 8, 128
DECODE_LENGTHS = (513, 544, 575, 640)  # ragged rows of a 640-slot cache
KERNEL_TOL = 2e-2       # bf16: p and the output round at 2^-8; outputs are O(1)
# Logits are compared by relative RMS error, ||a - b|| / ||b||. bf16 rounds
# at 2^-8 per op and with random weights the difference between two valid
# bf16 paths grows with depth: at 32 layers the flash kernel and the masked
# reference path differ by ~7% on an H100 (`noise_floor_rel_rms_err`), and
# at 2 layers the card's bf16 lies ~1.5% from f32 on the CPU (`reference`),
# both measured by this script. The bounds sit above those.
CONSISTENCY_RTOL = 0.10  # decode vs forward on the card, 32 layers
REFERENCE_RTOL = 0.04    # bf16 on the card vs f32 on the CPU, 2 layers
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12   # dense bf16 tensor cores
OUT_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def check_flash(gen, causal, sq, sk):
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v = randn((B, sq, H, D), gen), randn((B, sk, HKV, D), gen), randn((B, sk, HKV, D), gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    assert torch.isfinite(out).all() and err <= KERNEL_TOL and lse_err <= 1e-3, \
        (causal, sq, sk, err, lse_err)
    pairs = sum(min(i + sk - sq + 1, sk) for i in range(sq)) if causal else sq * sk
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * D * pairs * B * H)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = None
    if not causal or sq == sk:  # SDPA's is_causal is top-left aligned
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
    return dict(shape=f"B={B} Sq={sq} Sk={sk} H={H} Hkv={HKV} D={D} causal={causal}",
                max_abs_err=err, lse_max_abs_err=lse_err,
                ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=causal)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library)


def check_decode(gen):
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    m = max(DECODE_LENGTHS)
    q, k, v = randn((B, 1, H, D), gen), randn((B, m, HKV, D), gen), randn((B, m, HKV, D), gen)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    out = da.decode_attention(q, k, v, lengths)
    ref = da.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= KERNEL_TOL, err
    n_kv = sum(DECODE_LENGTHS)
    nbytes = (q.numel() + out.numel()) * 2 + n_kv * HKV * D * 2 * 2 + lengths.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * D * n_kv * H)
    mask = (torch.arange(m, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return dict(shape=f"B={B} M={m} H={H} Hkv={HKV} D={D} lengths={list(DECODE_LENGTHS)}",
                max_abs_err=err,
                ms=cuda_ms(lambda: da.decode_attention(q, k, v, lengths)),
                plain_ms=cuda_ms(lambda: da.decode_attention_plain(q, k, v, lengths)),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)))


def llama(cfg, seed):
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, init_params
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    return init_params(model, torch.Generator(device="cuda").manual_seed(seed))


def rel_err(got, ref) -> float:
    """Relative RMS error of `got` against `ref`."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).norm() / ref.norm()).item()


def rel_max_err(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def serve(report):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    cfg = llama_config("llama3-8b")
    engine = deepspeed_tpu_torch.init_inference(llama(cfg, SEED), dtype="bf16")
    acc = engine.accelerator
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.forward(ids)                                  # warm-up
    engine.generate(ids[:1, :16], max_new_tokens=2)
    last_logits = []
    hook = engine.module.lm_head.register_forward_hook(
        lambda mod, inp, out: last_logits.append(out[:, -1].detach()))

    # the main path: counted launches
    acc.synchronize()
    acc.reset_peak_memory_stats()
    flash_attention_fwd.launches = decode_attention.launches = 0
    t0 = time.perf_counter()
    logits = engine.forward(ids)
    acc.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=NEW)
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "decode_attention": decode_attention.launches}
    greedy_tok_s = engine.last_decode_tok_s
    peak = acc.max_memory_allocated()
    hook.remove()
    L = cfg.num_hidden_layers
    assert launches == {"flash_attention_fwd": L, "decode_attention": L * (NEW - 1)}, launches
    assert logits.shape == (B, PROMPT, cfg.vocab_size) and torch.isfinite(logits).all()
    assert out.shape == (B, PROMPT + NEW) and torch.equal(out[:, :PROMPT], ids)

    # the last decode step against forward on the generated sequence
    step_logits = last_logits[-1]
    full = engine.forward(out[:, :-1])[:, -1]
    consistency = rel_err(step_logits, full)
    consistency_max = rel_max_err(step_logits, full)
    # the same forward through the masked reference attention: how far two
    # valid bf16 paths lie apart
    with_reference = dataclasses.replace(cfg, attn_impl="reference")
    for layer in engine.module.layers:
        layer.self_attn.cfg = with_reference
    noise_floor = rel_err(engine.forward(out[:, :-1])[:, -1], full)
    for layer in engine.module.layers:
        layer.self_attn.cfg = cfg
    assert torch.isfinite(step_logits).all() and consistency <= CONSISTENCY_RTOL, consistency
    assert torch.equal(step_logits.float().argmax(-1), out[:, -1])

    # prefill alone, to split the generate time
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    decode_tok_s = B * (NEW - 1) / ((generate_ms - prefill_ms) / 1e3)

    decode_attention.launches = 0
    sampled = engine.generate(ids, max_new_tokens=NEW, temperature=0.8, top_p=0.9,
                              seed=SEED + 2)
    assert decode_attention.launches == L * (NEW - 1)
    assert sampled.shape == out.shape and int(sampled.min()) >= 0 \
        and int(sampled.max()) < cfg.vocab_size
    report["decode_profile"] = profile_decode(engine, ids)
    del engine, logits, full
    torch.cuda.empty_cache()
    report["serve"] = dict(
        card=report["card"], model="llama3-8b (random bf16 weights, seed 0)",
        batch=B, prompt=PROMPT, new_tokens=NEW, forward_ms=forward_ms, generate_ms=generate_ms,
        generate_prefill_ms=prefill_ms, decode_tok_s=decode_tok_s,
        engine_last_decode_tok_s=greedy_tok_s, peak_memory_bytes=peak,
        consistency_rel_rms_err=consistency, consistency_rel_max_err=consistency_max,
        noise_floor_rel_rms_err=noise_floor,
        launches=launches)
    return launches


def profile_decode(engine, ids, steps: int = 8):
    """Device time by kernel over `steps` decode steps of the model's cached
    call (what `generate` runs per token), from torch.profiler; the
    profiler's own host cost is in `step_ms`."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference.kv_cache import KVCache
    cfg = engine.model_cfg
    with torch.inference_mode():
        cache = KVCache.create(cfg.num_hidden_layers, B, 640, cfg.num_key_value_heads,
                               cfg.head_dim, dtype=torch.bfloat16, device="cuda")
        logits, cache = engine.module(ids, cache=cache)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = engine.module(tok[:, None], cache=cache)
                tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:10]
    return dict(steps=steps, step_ms=wall_us / steps / 1e3,
                device_ms_per_step=busy_us / steps / 1e3,
                device_busy_share=(busy_us / wall_us) if busy_us else None,
                kernel_launches_per_step=sum(e.count for e in kernels) / steps,
                top=[dict(name=e.key[:90], ms_per_step=device_us(e) / steps / 1e3,
                          launches_per_step=e.count / steps) for e in top])


def reference(report):
    """Two layers at full width: the card in bf16 against the plain
    versions on the CPU in f32, on the same weights."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    cfg = llama_config("llama3-8b", num_hidden_layers=2)
    gpu = deepspeed_tpu_torch.init_inference(llama(cfg, SEED + 3), dtype="bf16")
    cpu_model = LlamaForCausalLM(llama_config("llama3-8b", num_hidden_layers=2,
                                              dtype=torch.float32), device="meta")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                               gpu.module.state_dict().items()}, assign=True)
    cpu = deepspeed_tpu_torch.init_inference(cpu_model, dtype="fp32", device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(SEED + 4))
    err_fwd = rel_err(gpu.forward(ids), cpu.forward(ids))
    steps = []
    hook = gpu.module.lm_head.register_forward_hook(
        lambda mod, inp, out: steps.append(out[:, -1]))
    out = gpu.generate(ids, max_new_tokens=8)
    hook.remove()
    # the card's prefill and last decode step against the CPU's forward on
    # the tokens the card generated
    ref = cpu.forward(out[:, :-1].cpu())
    err_prefill = rel_err(steps[0], ref[:, ids.shape[1] - 1])
    err_step = rel_err(steps[-1], ref[:, -1])
    assert max(err_fwd, err_prefill, err_step) <= REFERENCE_RTOL, \
        (err_fwd, err_prefill, err_step)
    del gpu
    torch.cuda.empty_cache()
    report["reference"] = dict(forward_rel_rms_err=err_fwd,
                               prefill_rel_rms_err=err_prefill,
                               last_decode_step_rel_rms_err=err_step)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card")
        return 2
    from deepspeed_tpu_torch.accelerator import get_accelerator
    smi = get_accelerator().name_and_power_limit()
    if smi is None:
        raise RuntimeError("nvidia-smi is missing: the card's power limit is unknown")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    from deepspeed_tpu_torch.op_builder import build_all
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    t0 = time.perf_counter()
    build_all([fa.LIBRARY, da.LIBRARY])
    report["build_s"] = time.perf_counter() - t0
    print(f"built kernels in {report['build_s']:.1f} s", flush=True)
    for lib in (fa.LIBRARY, da.LIBRARY):
        log(lib.build_log)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = [check_flash(gen, True, PROMPT, PROMPT), check_flash(gen, True, 128, 640),
             check_flash(gen, False, PROMPT, PROMPT)]
    decode = check_decode(gen)
    report["flash_attention_fwd"], report["decode_attention"] = flash, decode
    for row in flash + [decode]:
        print(json.dumps(row), flush=True)

    launches = serve(report)
    reference(report)
    print(json.dumps(report["serve"]), flush=True)
    print(json.dumps(report["reference"]), flush=True)
    print(json.dumps(report["decode_profile"]), flush=True)

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="deepspeed_tpu/ops/pallas/flash_attention.py:593",
             launches=launches["flash_attention_fwd"],
             **{k: flash[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}),
        dict(name="decode_attention", route="cuda",
             source="deepspeed_tpu_torch/csrc/decode_attention.cu",
             replaces="deepspeed_tpu/ops/pallas/decode_attention.py:103",
             launches=launches["decode_attention"],
             **{k: decode[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}),
    ]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
