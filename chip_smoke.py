"""Smoke run of deepspeed_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. prints the card (`nvidia-smi` name and power limit) and the torch/CUDA
   versions;
2. builds every kernel of the serving and training paths from
   `deepspeed_tpu_torch/csrc/` with `nvcc`, all at once;
3. holds each kernel against its plain PyTorch version in bf16 at the
   serving shapes (K1-fwd also at the llama-1b training call; the flash
   backward at the training shapes, run twice and bitwise equal; the fused
   dequant-GEMM K5 at the four Llama-3-8B projections at M = 4 and 2048
   and two odd layouts, two calls bitwise equal (the decode path's split K);
   the paged prefill K4, bf16 and int8, and K1-fwd, two calls bitwise equal; the decode
   kernels K2 and K3 in every form, two calls bitwise equal, each with its
   device time from torch.profiler beside SDPA's; the int8
   attention kernels on int8 caches, and with unit scales bitwise against
   their bf16 kernels; the grouped expert GEMM
   K6 at the Qwen1.5-MoE prefill and decode calls, Mixtral-8x7B's w1/w2, a
   skewed Qwen routing and odd layouts; K1-fwd and K2 at Qwen1.5-MoE's GQA
   group 1; K6's backward kernels, dlhs and drhs, at the Qwen1.5-MoE
   training calls, Mixtral-8x7B's w1, the skewed routing (drhs's split) and
   odd layouts, run twice and bitwise equal; the block-sparse attention K7
   at the JAX kernel's own shape, at Llama-3-8B's attention width over 16k
   tokens, on a non-causal Fixed layout, with a fully masked causal row,
   and on BSLongformer at block 128), and times
   the kernel, the plain version and one PyTorch library call for the same
   function with CUDA events; K3-alibi and K4-alibi at bloom-7b1's
   attention (H = Hkv = 32, D = 128; staged and unstaged, over int8 pools)
   and bloom-560m's (H = 16, D = 64), each beside a control, the kernel
   run without the slopes, that must miss (SDPA's yardstick carries the
   bias in a bf16 float mask); K1-fwd, K2, K2-int8, K3 and K3-int8 (staged
   and not), K4 and K4-int8 (with and without a window) at the zoo's head
   widths, phi-2's (H = Hkv = 32, D = 80) and pythia-1b's (H = Hkv = 8,
   D = 256); K1-fwd and K1-bwd at those models' training calls (S = 2048,
   causal, `train_zoo`'s micro-batch: 2 for phi-2, 4 for pythia-1b; the
   backward run twice and bitwise equal); then runs the sparse path,
   `SparseSelfAttention` forward (K7, counted) and backward (the gather
   path's gradient) against autograd of the gather path;
4. serves Llama-3-8B at full width and depth with random bf16 weights
   through v1 (`init_inference`): `forward` on 4 x 512 tokens, greedy
   `generate` of 64 tokens (the v1 main path, whose kernel launches are
   counted), a sampled `generate`, the last decode step's logits against
   `forward` on the generated sequence;
5. serves the same model through v2 (`InferenceEngineV2`, the paged cache):
   traffic A, 96 prompts of 256 tokens and 64 greedy new tokens each over a
   96-block pool (the v2 main path, whose launches are counted), four rows'
   last decode step against v1 `forward`, and a profile of the decode step;
   traffic B, 16 prompts sharing a 512-token system prompt, a 900-token
   prompt put in split-fuse chunks while rows decode, a fork with
   copy-on-write, and a prefix-shared prompt against sharing off;
6. serves it with the KV cache int8 at rest (`kv_cache_dtype="int8"`): v1
   greedy `generate` (K2-int8 counted; the last step against the bf16-KV
   engine's `generate` forced through the same tokens, and a control with
   doubled scales that must fail that gate), v2 traffic A over int8 pools (K3-int8 and K4-int8
   counted) and a fork with copy-on-write;
7. serves it with int8 weights through `serve_mode="layer_scan"` (K5 on
   every projection, counted): the same greedy `generate`, the last step
   against the same int8 tree served by `dequant`, and profiles of the
   prefill and the decode step with K5's share;
7a. serves it with its layers streamed from page-locked host memory every
   pass (`serve_mode="capacity"`, ZeRO-Inference), the module's weights
   left on the card for 7: the pinned host-to-device rate of one layer's
   436 MB slice alone (the bound: 32 slices a decode step); batch 1's peak
   device memory against the plan (≤ 1.10x) and what stays on the card
   between calls; greedy `generate` of CAP_NEW tokens double-buffered (K2
   counted), the last step of 4's tokens teacher forced against 4's own
   under CONSISTENCY_RTOL beside a control (every layer run on its
   predecessor's weights) that must miss; the synchronous mode (one slab),
   bit for bit the same; two layers on NVMe through the aio engine (the same
   tokens) and the engine's read rate (`nvme.sweep`, warm); int8 weights
   quantized from the module, logits and tokens bit for bit those of the
   int8 layer scan (K5 and K2 counted); v2 on slot rows in `layer_scan` and
   `capacity` over the same int8 tree, the same tokens (K5, K2 counted);
8. holds a 2-layer model of the same width on the card in bf16 against the
   plain versions on the CPU in f32, through v1 and through v2, and with
   int8 weights through the layer scan;
8a. serves bloom-7b1 at full width and depth with random bf16 weights:
   v1 `forward` on 4 x 512 and greedy `generate` of 64 (the masked alibi
   path: no kernel may launch), the last step against `forward`; v2 with
   the automatic layout (paged) on traffic A (the Bloom v2 main path:
   K3-alibi and K4-alibi counted), four rows' last step against v1
   `forward`, and a decode-step profile; serves bloom-560m (24 layers, head
   dim 64) through v2, whose automatic layout is slot rows (no kernel),
   and forced onto the paged layout (K3/K4-alibi at D = 64), rows against
   v1 `forward` and the two layouts' teacher-forced logits against each
   other; holds a 2-layer bloom-7b1-width model on the card in bf16
   against the CPU in f32 through v1 and v2 paged;
8c. serves the zoo's first two families (`serve_zoo`) at full width and
   depth with random bf16 weights: phi-2 (32 layers, 32 heads of 80) and
   pythia-1b (16 layers, 8 heads of 256), each through v1 (`forward` on 4 x
   512 and greedy `generate` of 64: K1-fwd and K2 counted, the last decode
   step against `forward` beside a control, another row's `forward`, that
   must miss), v2 traffic A on the paged pool (K4 and K3 counted, four
   rows' last step against v1 `forward` beside the same control), an int8
   KV cache (v1 greedy `generate` of ZOO_INT8_NEW: K2-int8 counted, the
   last step against the bf16-KV engine forced through the same tokens
   beside the doubled-scales control; v2 over int8 pools: K4-int8 and
   K3-int8 counted), and a 2-layer model of the same width on the card in
   bf16 against the CPU in f32 through v1 and v2;
8b. serves Qwen1.5-MoE-A2.7B at full width and depth with random bf16
   weights through v1: `forward` on 4 x 512 (the ragged path, which drops
   tokens over capacity), greedy `generate` of 64 tokens (the MoE main
   path: K6 three times a layer in the prefill, counted), the last decode
   step against a cached prefill of the whole sequence (not `forward`, whose
   drops differ by design) beside the routing-flip share and a control,
   a sampled `generate`, prefill and decode profiles, and decode with the
   grouped GEMM forced; then 2-layer Qwen1.5-MoE and Mixtral-8x7B-width
   models on the card in bf16 against the CPU in f32;
9. trains llama-1b (TinyLlama-1.1B shapes) at full width and depth with
   random bf16 weights through `initialize` → `train_batch` (micro-batch
   4, GAS 2, sequence 2048, FusedAdam, clipping 1.0, ZeRO stage 3 on one
   rank, remat on): one warm-up and 5 timed steps on one batch (the
   training main path, whose launches are counted), with the step time,
   tokens/s, MFU, peak memory and a profile of one step with K1's share
   of its device time; the loss must fall. A 2-layer model of the same
   width is held on the card in bf16 against the CPU in f32 over one GAS
   window of `forward`/`backward`
   (loss, grad norm, four gradients), and remat on against remat off;
9b. trains Qwen1.5-MoE-A2.7B at full width and 4 of its 24 layers (random
   bf16 weights, `dispatch_impl="gmm"`) through `initialize` →
   `train_batch` (micro-batch 1, GAS 4, sequence 2048, FusedAdam, clipping
   1.0, ZeRO stage 3 on one rank, remat on): one warm-up and 5 timed steps
   (the MoE training main path: K6, its dlhs and drhs, and K1, counted),
   step time, tokens/s, active-parameter MFU, peak memory and a profile of
   one step; the loss must fall; then 2 timed steps of the same engine with
   `dispatch_impl="auto"` (the ragged buffer in training). A 2-layer model
   of the same width holds the gradients of one GAS window through the
   grouped GEMM against the ragged buffer beside the routing-flip share,
   with a control (drhs fed the sizes rolled by one) that must fail;
9c. serves Llama-3-8B at full width and TP_LAYERS (8) of its 32 layers
   tensor-parallel over tp = 2 (`tensor_parallel={"tp_size": 2}`): two
   ranks, spawned processes on the one card joined by gloo (NCCL rejects
   two ranks on one device, so the collectives stage through the host: its
   times are not a tensor-parallel speed), each building its shard from
   the seed of the tp = 1 phases, against tp = 1 references that this
   process builds at the same depth (`tp_references`): v1 `forward` on 4 x
   512 and greedy `generate` of 64 (K1 and K2 per shard counted), the last
   step teacher-forced on the tp = 1 tokens against the tp = 1 engine's,
   with a control (rank 1 serving rank 0's o_proj shard) that must miss; a
   sampled `generate`; v2 traffic A (K3 and K4 per shard counted), four
   rows against v1 `forward`; int8 weights through the layer scan (K5 'n'
   and 'k' per shard counted, no kernel fallback), the last step against
   the tp = 1 int8 engine's; both
   ranks' tokens equal; then a 2-layer model at tp = 2 on the card in bf16
   against the CPU in f32 at tp = 1. The kernel phase holds each rank's
   shard of K2, K3, K4 and K5 ('n') bit for bit to the same heads or
   columns of the unsharded kernel, and K5 'k''s two partial products
   summed to the unsharded product;
9d. serves Qwen1.5-MoE-A2.7B at full width and EP_LAYERS (8) of its 24
   layers expert-parallel over
   ep = 2 (`groups.initialize(MeshTopology(ep=2))`, then `init_inference`):
   two ranks on the one card over gloo, as 9c, each building its shard (the
   dense model whole, 30 of the 60 experts of every layer) from the seed of
   8b: v1 `forward` on 4 x 512 (the ragged path: the rank's slice of the
   expert buffer, all-gathered) and greedy `generate` of 64 (K8-e three
   times a layer in the prefill, one all-reduce a layer; the ragged buffer
   and K2 at decode), counted; the last step teacher-forced on the tokens
   of ep = 1 references that this process builds at the same depth
   (`ep_references`) against theirs, beside the routing-flip share, with a control (rank 1
   running its experts at rank 0's group offset) that must miss; a sampled
   `generate`; the gloo all-reduce and all-gather at the prefill and decode
   operand sizes and K8-e alone and with its all-reduce; decode with the
   grouped GEMM forced (K8-e counted); both ranks' tokens equal; then the
   2-layer models of 8b at ep = 2 against 8b's CPU f32 logits. The kernel
   phase holds each rank's share of K8-e bit for bit to K6's rows of its
   experts (zeros elsewhere) and the ranks' sum to K6's output;
9e. trains llama-1b at full width and depth data-parallel over dp = 2
   (`train_zero`): two ranks on the one card over gloo, as 9c (so the
   collectives stage through the host and the times are not a
   data-parallel speed), each building the weights of 9 (seed 30) and
   taking its half of 9's batch (micro-batch 2 a rank, GAS 2: the same
   global batch), through `initialize` → `train_batch` under ZeRO stages
   0, 1, 2 and 3 in turn (bf16, clipping 1.0, FusedAdam, remat on), two
   steps each: after every step both ranks' parameters (stage 3:
   gathered) have the same digest (`param_digest`, summed on the card); the
   first step's loss and pre-clip grad norm match 9's first `train_batch`
   within TRAIN_REF_LOSS_RTOL and
   TRAIN_REF_NORM_RTOL, and a control (one rank on rank 0's rows alone)
   must miss the norm bound; the loss falls; each rank's K1 launches
   equal 9's per step and no other kernel launches; the peak memory per
   rank orders stage 3 < stage 1 <= stage 0 and stage 3 <= 0.6 x stage 0.
   Step seconds, tokens/s, and gloo's seconds and bytes a step by
   collective kind are reported. After stage 3's first step each rank
   saves its part of a checkpoint (`save_checkpoint`; the bytes each rank
   wrote and the seconds reported); a fresh engine on each rank, from
   other weights, loads it and takes the second step again, bitwise the
   uninterrupted one (loss, grad norm, digest); this process loads the
   save at dp = 1 and takes that step on the whole batch, within
   TRAIN_REF_LOSS_RTOL and TRAIN_REF_NORM_RTOL of the ranks';
9f. checkpoints llama-1b on one rank (`train_checkpoint`, right after 9,
   on 9's engine after its steps): `save_checkpoint` (~15.4 GB), CKPT_STEPS
   more steps; `zero_to_fp32` of the save equals the master at the save
   (digest); a fresh engine from other weights loads it and takes the same
   steps, losses, grad norms and parameter digest bitwise equal, with K1's
   launches of 9's steps; the control, a step of the fresh engine before
   the load, must differ. Save and load seconds and GB/s are reported (the
   load reads files written a moment before: warm). The free disk space is
   checked first against the engine's state bytes, and the files are
   deleted afterwards;
9g. trains Qwen1.5-MoE-A2.7B at full width and MOE_DP_LAYERS layer
   data-parallel over dp = 2 (`train_moe_zero`, after 9b; its runs take
   place in 9e's two ranks, after 9l), each on its half of a global batch of
   4 x 2048 tokens (micro-batch 2, GAS 1), one step under each of ZeRO
   0-3 with `dispatch_impl="gmm"` (K6, dlhs, drhs and K1 counted on each
   rank) and one at stage 2 with `auto` (the ragged buffer); the gate routes
   the global batch (its capacity, places and aux loss from both ranks'
   counts). Both ranks' parameter digests equal; the loss and the aux loss
   within TRAIN_REF_LOSS_RTOL and the grad norm within TRAIN_REF_NORM_RTOL
   of the one-rank step on the same global batch, beside the routing-flip
   share; the global count of dropped assignments equal to the one-rank
   step's (or within 2k per flipped token); the control, one rank on rank
   0's rows alone, must miss the norm bound. Peak memory, step seconds,
   launches and gloo's seconds and bytes a step by kind, per rank;
9h. trains llama-1b with ZeRO++ (`train_zeropp`) in 9e's two ranks after
   its stages, at full depth: stage 2 with qgZ (int8 gradient reduce-scatter) and stage 3
   with qwZ and qgZ (int8 parameter gathers too), two steps each, every
   step's parameters bitwise equal on both ranks; the first step's loss
   and pre-clip norm held to the same stage's plain step (ZEROPP_LOSS_RTOL,
   ZEROPP_NORM_RTOL: qgZ leaves the forward alone, so its loss is bitwise
   the plain one), a control (every block dequantized with its neighbour's
   scale) that must miss the norm bound; a falling loss; K1's launches as
   the plain stage's; the wire bytes by kind (the int8 values and f32
   scales handed to gloo) over the plain run's against the ratio the
   pieces predict (`zeropp_prediction`, within
   ZEROPP_BYTES_RTOL: int8 plus an f32 scale a block of 256 against f32
   or bf16), and qwZ's bytes a micro beside the JAX package's record of
   them (the recompute gathers a block again); gloo's seconds a step;
9i. trains llama-1b at full width and MICS_LAYERS layers under MiCS
   (`train_mics`): four ranks on the one card over gloo, `repl` 2 x `data`
   2 from the config's `mics_shard_size`, stage 3, micro-batch 1 a rank
   and GAS 2 (9's global batch), two steps: every rank's gathered
   parameters bitwise equal, `repl` peers' pieces bitwise equal and the
   `data` peers' not, the gathers on the `data` pairs only and the
   gradient mean across `repl`, the first step against a one-rank engine
   at the same depth (TRAIN_REF_* bounds), a falling loss, K1's launches,
   the peak memory a rank and gloo's calls, bytes and seconds by group;
9j. trains llama-1b at full width and ONEBIT_LAYERS layers through 1-bit
   Adam's compressed wire (`train_onebit`, in 9e's ranks after 9h's
   runs): dp = 2, stage 0, freeze step
   ONEBIT_FREEZE, no clipping, beside FusedAdam on the same weights and
   rows: the warm-up's change of the f32 master within ONEBIT_WARMUP_RTOL
   of Adam's (relative L2; the first step tighter than the second, whose
   bf16 parameters already differ a little), the first compressed step's
   not (the control);
   both ranks bitwise equal after each step; a falling loss over
   ONEBIT_STEPS; K1's launches; the bytes a step by kind before the freeze
   (the momentum's exact mean and the norm's, f32) and after it (int8
   signs and one f32 scale a JAX leaf, and the norm's mean);
9k. trains the zoo (`train_zoo`, after 9's reference): phi-2 (32 layers of
   32 heads of 80), pythia-1b (16 layers of 8 heads of 256) and bloom-560m
   (24 layers of 16 heads of 64) at full width and depth with random bf16
   weights through `initialize` → `train_batch` (`train`'s config at
   micro-batch 2, 4 and 4: ZOO_TRAIN): one warm-up and ZOO_TRAIN_STEPS
   timed steps on one batch (K1-fwd 2·L·GAS and K1-bwd dq and dk/dv L·GAS
   launches a `train_batch` at D = 80 and 256, counted; none for BLOOM,
   whose alibi takes the masked path), a falling loss, step time, tokens/s,
   MFU and peak memory; a 2-layer model of each width on the card in bf16
   against the CPU in f32 over one GAS window (9's gates) and remat on
   against off;
9l. trains the same three at full width and ZOO_DP_LAYERS layers over dp =
   2 in 9e's ranks after 9j (`train_zoo_zero`): one step at each of
   ZOO_DP_STAGES (stage 3 gathers the blocks inside their checkpoints and
   the root around the forward), both ranks' parameters bitwise equal, the
   step against one rank on the same global batch (TRAIN_REF_* bounds)
   beside a control (one rank on rank 0's rows alone) that must miss, K1's
   launches a rank;
10. prints one JSON line of kernels (with each training path's launches a
   `train_batch` beside K1's and K6's rows), then the result line.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing a result. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import shutil
import sys
import time
import types

import numpy as np
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
# int8-KV decode vs bf16-KV decode on the same path and tokens, 32 layers:
# int8's own rounding, grown by depth, reads ~0.098 on an H100, and a write
# whose scales are doubled reads ~1.35 (this script's control).
INT8_KV_RTOL = 0.15
REFERENCE_RTOL = 0.04    # bf16 on the card vs f32 on the CPU, 2 layers
# MoE serving, Qwen1.5-MoE-A2.7B (the published Qwen/Qwen1.5-MoE-A2.7B shapes).
# Expert choice is discrete: two valid bf16 paths can route a near-tie token
# to another expert, so the MoE gates sit beside a routing-flip share and a
# control (K6 fed sizes rolled by one) that must fail them.
QWEN_MOE = "qwen1.5-moe-a2.7b"
# Bounds from this script's run on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md): the last decode step against a cached prefill of the whole
# sequence read 0.0177 at 24
# layers (6 of 96 routing decisions flipped), its control 0.181. At 2
# layers against CPU f32, Qwen read 0.0145 at most (4.4% flipped), control
# 0.172; Mixtral 0.0919 over every position of the cached prefill (1.0%
# flipped: a flip swaps half of a token's top-2 FFN), control 0.726.
MOE_CONSISTENCY_RTOL = 0.06
MOE_REFERENCE_RTOL = {QWEN_MOE: 0.05, "mixtral-8x7b": 0.2}
# BLOOM serving: bloom-7b1 (the published bigscience/bloom-7b1 shapes, 30
# layers of 32 heads of 128, vocab 250,880) through v1 and v2 paged, and
# bloom-560m (24 layers, 16 heads of 64) through v2 slot rows and paged.
# Bound from this script's run on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md): at 30 layers the last decode step read 0.0158 against
# `forward` (v1) and 0.0158-0.0162 (v2 rows against v1 `forward`); at 24
# layers bloom-560m's slot and paged rows 0.0127-0.0144, and the two
# layouts' teacher-forced logits 0.0157 apart. The bound sits ~3x above.
# The kernel phase's controls (the kernels without the slopes) miss by >= 2.9.
BLOOM, BLOOM_SLOT = "bloom-7b1", "bloom-560m"
BLOOM_CONSISTENCY_RTOL = 0.05
SLOT_V2 = dict(max_batch=8, max_seq_len=1024, split_fuse_chunk=256)
SLOT_PROMPTS = (100, 300, 600, 200) * 4  # the 600s run three chunks
SLOT_NEW = 32
WATCH_SLOT = (0, 1, 2, 15)               # one prompt of each length
# Tensor-parallel serving of Llama-3-8B over tp = 2: two ranks, one process
# each, on the one card, joined by gloo (NCCL rejects two ranks on one
# device), so the collectives stage through the host while the kernels,
# weights and caches stay on the card. Its times are those of two ranks
# sharing one H100, not a tensor-parallel speed.
TP = 2
# serve_tp runs Llama-3-8B at full width and TP_LAYERS of its 32 layers
# (gloo's collectives scale with depth), against tp = 1 references built
# at the same depth (`tp_references`)
TP_LAYERS = 8
SERVE_REFS = {}              # `serve`'s greedy tokens and last-step logits (full depth)
TP_TIMEOUT_S = 600           # a rank waiting longer on a collective fails the run
# Expert-parallel serving of Qwen1.5-MoE-A2.7B over ep = 2 (`serve_ep`): two
# ranks on the one card over gloo, as `serve_tp`, each holding the whole
# dense model and 30 of the 60 experts of every layer.
EP = 2
EP_REFS = {}                 # ep = 1 results: `ep_references`' and `reference_moe`'s
# EP_LAYERS of Qwen1.5-MoE's 24 layers in `serve_ep` (the script's time),
# against ep = 1 references built at the same depth (`ep_references`)
EP_LAYERS = 8
# The zoo's first two families (`serve_zoo`), at the published
# microsoft/phi-2 and EleutherAI/pythia-1b shapes: (module, preset, seed),
# and each one's attention for the kernel phase's rows at its head width
ZOO = (("phi", "phi-2", SEED + 80, 80), ("gptneox", "pythia-1b", SEED + 90, 256))
ZOO_WIDTHS = {80: dict(h=32, hkv=32, d=80), 256: dict(h=8, hkv=8, d=256)}
# Training the zoo (`train_zoo`): phi-2, pythia-1b and bloom-560m (the
# published bigscience/bloom-560m shapes: 24 layers of 16 heads of 64, vocab
# 250,880) at full width and depth, random bf16 weights, `train`'s config at
# each model's micro-batch: (module, preset, seed, micro-batch). The engine
# keeps ~20 bytes a parameter (bf16 parameter and gradient, f32 master, two
# Adam moments, f32 accumulation at GAS 2): phi-2's 2.78e9 parameters take
# ~56 GB, so it trains at micro-batch 2; pythia-1b (1.01e9) and bloom-560m
# (5.6e8) at `train`'s 4.
ZOO_TRAIN = (("phi", "phi-2", SEED + 100, 2), ("gptneox", "pythia-1b", SEED + 110, 4),
             ("bloom", "bloom-560m", SEED + 120, 4))
ZOO_TRAIN_STEPS = 3
# the gradients each family's 2-layer reference holds against the CPU (as
# GRAD_KEYS: the embedding, layer 0's q projection and MLP output, and the
# head or, for BLOOM's tied head, a layer-1 projection)
ZOO_GRAD_KEYS = {
    "phi": ("embed_tokens", "layers.0.self_attn.q_proj.weight", "layers.0.mlp.fc2.weight",
            "lm_head.weight"),
    "gptneox": ("embed_in", "layers.0.attention.q_proj.weight",
                "layers.0.mlp.dense_4h_to_h.weight", "embed_out.weight"),
    "bloom": ("word_embeddings", "h.0.self_attention.q_proj.weight",
              "h.0.mlp.dense_4h_to_h.weight", "h.1.self_attention.dense.weight")}
# the zoo across data ranks (in `train_zero`'s ranks, after its runs): each
# family at full width and ZOO_DP_LAYERS layers, one step at each of
# ZOO_DP_STAGES over dp = 2, `train_zero`'s rows a rank, held to one rank
# on the same global batch (TRAIN_REF_* bounds) beside a control (one rank
# on rank 0's rows alone) that must miss. Its norm bound is tighter than
# TRAIN_REF_NORM_RTOL: at two layers the step read within 2.2e-6 of one
# rank's and the loss within 8.4e-8, while BLOOM's control read only 0.0407
# (its norm is mostly the tied head's softmax term, which half the batch
# barely moves; phi-2's and pythia-1b's ~0.41), this script on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md)
ZOO_DP_LAYERS, ZOO_DP_STAGES = 2, (1, 3)
ZOO_DP_NORM_RTOL = 1e-3
ZOO_INT8_NEW = 8             # greedy tokens of the int8-KV runs
ZOO_INT8_PROMPTS = 8         # v2 prompts of 256 tokens over int8 pools
# K2's and K3's report names and CUDA names in a profile ("::" keeps K5's
# qmm_decode_kernel and K3's paged_decode_kernel out of K2's)
K2_NAME = ("decode_attention", "::decode_kernel<")
K3_NAME = ("paged_decode_attention", "::paged_decode_kernel<")
# ZeRO-Inference (`serve_capacity`): Llama-3-8B's layers streamed from
# page-locked host memory (and NVMe) every pass, so a decode step costs one
# sweep of 14 GB (bf16) or 7 GB (int8) over PCIe; the runs are kept short.
CAP_NEW = 8                  # greedy tokens of the bf16 runs (B x PROMPT prompts)
CAP_PEAK = (128, 130)        # batch 1: prompt, prompt + new tokens of the peak run
CAP_PEAK_RATIO = 1.10        # measured peak over the plan's (the JAX check_plan bound)
CAP_NVME_LAYERS, CAP_NVME_NEW = 2, 4
CAP_NVME_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_nvme"
CAP_INT8_NEW = 4
CAP_V2 = dict(max_batch=2, max_seq_len=256, split_fuse_chunk=256)
CAP_V2_PROMPTS, CAP_V2_NEW = (100, 60), 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12   # dense bf16 tensor cores
OUT_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"
# checkpoints of the training phases, written here (gitignored) and
# deleted after each phase; a phase checks the free space first
CKPT_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_checkpoints"
# v2 serving: the JAX package's on-chip fastgen row (bench.py), paged cache
# of 96 blocks x 256 tokens (3.2 GB at Llama-3-8B), 64 sequence rows
BS, T, NB = 256, 4, 96
V2 = dict(max_batch=64, max_seq_len=T * BS, cache_block_size=BS, num_cache_blocks=NB,
          split_fuse_chunk=256, prefix_sharing=True)
TRAFFIC_A = (96, 256, 64)        # prompts, prompt tokens, new tokens
WATCH = (0, 1, 48, 95)           # traffic A rows whose last step is held against v1
# K1-bwd shapes (B, Sq, Sk, H, Hkv, D, causal): (a) the llama-1b training
# shape, (b) the JAX bench's 470M training shape, (c) the causal offset
# path, (d) no mask
BWD_SHAPES = [(4, 2048, 2048, 32, 4, 64, True), (2, 2048, 2048, 8, 8, 128, True),
              (4, 128, 640, 32, 8, 128, True), (4, 512, 512, 32, 8, 128, False)]
# K5: the Llama-3-8B projections (K, N): q/o, k/v, gate/up, down; and the
# JAX package's odd layouts (M, K, N, block): blocks spanning rows, and M, N
# and K remainders
QMM_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
QMM_ODD = [(4, 64, 128, 256), (5, 128, 384, 64)]
# training: llama-1b (TinyLlama-1.1B shapes), 16,384 tokens a step
MBS, GAS, SEQ, TRAIN_STEPS = 4, 2, 2048, 5
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": MBS, "gradient_accumulation_steps": GAS,
                "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}},
                "zero_optimization": {"stage": 3}}
# 2-layer full-width training reference, card bf16 against CPU f32. With
# random weights the loss sits near ln V whatever attention computes, so
# the loss gate cannot see a wrong kernel: the gradient gates are what check
# the K1 kernels (layer 0's q_proj through its dq; its down_proj and the
# embedding through layer 1's dq, dk and dv).
TRAIN_REF_LOSS_RTOL, TRAIN_REF_NORM_RTOL, TRAIN_REF_GRAD_RTOL = 1e-3, 5e-2, 0.05
# data-parallel training (`train_zero`): dp = 2 ranks on the one card over
# gloo, each with ZERO_MBS rows a micro, so that GAS x ZERO_MBS x dp is the
# `train` phase's batch; its first step is held to `train`'s (TRAIN_REFS)
DP = 2
ZERO_MBS = 2
ZERO_STAGES = (0, 1, 2, 3)
ZERO_STEPS = 2
ZERO_PEAK_RATIO = 0.6        # stage 3's peak over stage 0's, at most
TRAIN_REFS = {}              # `train`'s first train_batch: loss and pre-clip grad norm
# ZeRO++ over dp = 2 (`train_zeropp`, in `train_zero`'s ranks, after its
# stages): llama-1b at full depth, stage 2 with qgZ and stage 3 with qwZ and
# qgZ, each held to the same stage's run without ZeRO++ (its first step:
# the same weights and rows). qgZ leaves the forward alone, so the first
# loss is bitwise the plain stage's; the int8 gradient moves the pre-clip
# norm by a few 1e-4 at most, and qwZ's int8 weights the loss and norm by
# ~1e-3 (PERF.md's prediction, written before the first card run).
# The control (stage 2 qgZ) dequantizes every block with its neighbour's
# scale.
ZEROPP_RUNS = (("qgz_stage2", 2, True, False), ("qwz_qgz_stage3", 3, True, True))
ZEROPP_NORM_RTOL = {"qgz_stage2": 2e-3, "qwz_qgz_stage3": 1e-2}
ZEROPP_LOSS_RTOL = {"qgz_stage2": 0.0, "qwz_qgz_stage3": 2e-3}
ZEROPP_BYTES_RTOL = 0.01     # counted wire bytes over plain ones against the prediction
# MiCS (`train_mics`): four ranks on the one card, repl 2 x data 2, stage 3,
# llama-1b at full width and MICS_LAYERS of its 22 layers (four ranks' gloo
# time), micro-batch 1 a rank and GAS 2 (`train`'s global batch), held to a
# one-rank engine at the same depth (TRAIN_REF_* bounds)
MICS_RANKS, MICS_SHARD, MICS_LAYERS, MICS_STEPS = 4, 2, 2, 2
# the 1-bit wire (`train_onebit`): dp = 2, stage 0, llama-1b at full width and
# ONEBIT_LAYERS layers, 1-bit Adam with freeze_step ONEBIT_FREEZE and no
# clipping, beside FusedAdam on the same rows: the warm-up's cumulative
# update against Adam's (relative L2 of the master's change) within
# ONEBIT_WARMUP_RTOL: the first step, from the same parameters, to 1e-5
# (5.9e-7 read), the second to 1e-3 (3.6e-4 read: the two runs' parameters
# already differ a little after one step). The first compressed step's
# must miss the second bound (the control; 6.43 read). This script's
# readings at 1 layer on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
ONEBIT_LAYERS, ONEBIT_FREEZE, ONEBIT_STEPS = 1, 2, 4
ONEBIT_WARMUP_RTOL = (1e-5, 1e-3)
ZERO_RANKS = []              # `train_zero`'s ranks' results
REMAT_RTOL = 1e-3
GRAD_KEYS = ("embed_tokens", "layers.0.self_attn.q_proj.weight",
             "layers.0.mlp.down_proj.weight", "lm_head.weight")
# K7 (block-sparse attention): (name, B, S, H, D, block, layout, causal). (a) the
# JAX kernel's docstring shape, causal BigBird; (b) Llama-3-8B's attention
# width at 16k context, causal BigBird (its Kmax stays small, so the plain
# gather fits); (c) non-causal Fixed; (d) a causal row whose only live block
# lies above it (zeros), at block 32 and D 64; (e) BSLongformer at block 128,
# not causal: block 0 is global, so one query block a head walks all 64
# blocks and the rest about 4 (where the longest-first order shows)
SPARSE_SHAPES = [("a: bigbird causal", 1, 4096, 8, 128, 64, "bigbird", True),
                 ("b: llama3-8b width, 16k, bigbird causal", 1, 16384, 32, 128, 64, "bigbird",
                  True),
                 ("c: fixed, not causal", 1, 4096, 8, 128, 64, "fixed", False),
                 ("d: fully masked causal row", 2, 1024, 4, 64, 32, "masked_row", True),
                 ("e: bslongformer, block 128", 1, 8192, 16, 128, 128, "bslongformer", False)]
# MoE training, Qwen1.5-MoE-A2.7B at full width and 4 of its 24 layers: the
# engine keeps ~20 bytes a parameter (bf16 param and grad, f32 master, two
# Adam moments, f32 accumulation), 2.905e9 parameters at 4 layers, ~58 GB
QWEN_TRAIN_LAYERS = 4
MOE_MBS, MOE_GAS, MOE_SEQ, MOE_STEPS, MOE_AUTO_STEPS = 1, 4, 2048, 5, 2
MOE_TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": MOE_MBS,
                    "gradient_accumulation_steps": MOE_GAS, "bf16": {"enabled": True},
                    "gradient_clipping": 1.0,
                    "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}},
                    "zero_optimization": {"stage": 3}}
# checkpoints (`train_checkpoint`): `train`'s engine saves (bf16 params 2.2
# GB, f32 master 4.4 GB, moments 8.8 GB) and trains CKPT_STEPS more; a fresh
# engine from other weights loads the save and takes the same steps bit for
# bit. `train_zero` saves after ZERO_SAVE_STAGE's first step and resumes it
# at dp = 2 (bitwise) and at dp = 1 in this process (TRAIN_REF_* bounds)
CKPT_STEPS = 2
ZERO_SAVE_STAGE = 3
# MoE training across data ranks (`train_moe_zero`): Qwen1.5-MoE at full
# width and 1 of its 24 layers (1.19e9 parameters: 311M embedding, 311M
# head, ~570M in the layer; ~21.5 GB of engine state a rank at stage 0, so
# that two ranks' whole states fit on the card; two layers, ~32 GB a rank,
# would not with their activations), dp = 2 ranks on the one card over gloo,
# micro-batch 2 a rank, GAS 1, sequence 2048: one step each of ZeRO 0-3 under
# gmm and of stage 2 under auto, held against the one-rank step on the same
# global batch (TRAIN_REF_LOSS_RTOL for the loss and the aux loss,
# TRAIN_REF_NORM_RTOL for the norm), beside the routing-flip share; a control
# (one rank on rank 0's rows alone) must miss
MOE_DP_LAYERS = 1
MOE_DP_MBS = 2
MOE_DP_RUNS = ((0, "gmm"), (1, "gmm"), (2, "gmm"), (3, "gmm"), (2, "auto"))
MOE_DP_CONFIG = dict(MOE_TRAIN_CONFIG, train_micro_batch_size_per_gpu=MOE_DP_MBS,
                     gradient_accumulation_steps=1)
# 2-layer full-width Qwen1.5-MoE in bf16 on the card, gradients of one GAS
# window through the grouped GEMM (K6 and its backward) against the ragged
# buffer (cuBLAS batched products) on the same weights and tokens: both
# dispatches compute the same function, and the router runs in f32. On an
# NVIDIA H100 80GB HBM3 at 700 W this script read at most 0.0069 relative
# RMS (embed_tokens; 0.0038 on the expert stacks, no routing decision
# flipped), and its control, drhs fed the sizes rolled by one, 1.31 on the
# expert stacks (PERF.md). The bound sits ~3x above the reading.
TRAIN_MOE_GRAD_RTOL = 0.02
MOE_GRAD_KEYS = ("layers.0.mlp.experts.gate", "layers.0.mlp.experts.up",
                 "layers.0.mlp.experts.down", "layers.1.mlp.experts.gate",
                 "layers.1.mlp.experts.up", "layers.1.mlp.experts.down",
                 "layers.0.mlp.gate.wg", "layers.1.mlp.gate.wg", "embed_tokens")


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


def window_us(kernels: dict, iters: int):
    """Device us per call in one profiler window of `iters` calls, from
    `device_kernels`'s {kernel: (us, events)}: each kernel's mean time over
    the events the window kept, times its launches per call, its events over
    `iters` rounded up (right while it loses fewer than `iters` events).
    None when the window holds no kernel, or a kernel kept fewer than half
    its launches."""
    if not kernels:
        return None
    total = 0.0
    for us, n in kernels.values():
        per_call = -(-n // iters)
        if 2 * n < per_call * iters:
            return None
        total += us / n * per_call
    return total


def device_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 3, tries: int = 12) -> float:
    """Device time per call of `fn`: the median over `windows` torch.profiler
    windows of `iters` calls of `window_us`. A window can lose kernel events
    (on an H100, 1 to 10 of 20 in a window), so each kernel is counted at
    its mean time over the events kept, never at their sum; a window that
    kept fewer than half is taken again, and after `tries` windows with
    fewer than `windows` kept it raises. At a few
    microseconds a kernel, `cuda_ms` (events around back-to-back calls)
    reads the host path when it is the slower; this reads the device."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kept, seen = [], []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        seen.append(sorted(n for _, n in kernels.values()))
        us = window_us(kernels, iters)
        if us is not None:
            kept.append(us)
        if len(kept) == windows:
            return sorted(kept)[windows // 2] / 1e3
    raise RuntimeError(f"device_ms: {len(kept)} of {tries} profiler windows of {iters} calls "
                       f"kept their kernel events (events by kernel: {seen})")


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def check_flash(gen, causal, sq, sk, h=H, hkv=HKV, b=B, d=D):
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    q, k = randn((b, sq, h, d), gen), randn((b, sk, hkv, d), gen)
    v = randn((b, sk, hkv, d), gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    again = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    assert torch.isfinite(out).all() and err <= KERNEL_TOL and lse_err <= 1e-3, \
        (causal, sq, sk, err, lse_err)
    bitwise = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert bitwise, ("K1-fwd is not bitwise repeatable", b, sq, sk, h, hkv, d, causal)
    pairs = sum(min(i + sk - sq + 1, sk) for i in range(sq)) if causal else sq * sk
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * d * pairs * b * h)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = None
    if not causal or sq == sk:  # SDPA's is_causal is top-left aligned
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
    return dict(shape=f"B={b} Sq={sq} Sk={sk} H={h} Hkv={hkv} D={d} causal={causal}",
                max_abs_err=err, lse_max_abs_err=lse_err, calls_bitwise_equal=bitwise,
                ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=causal)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library)


def check_flash_bwd(gen, b, sq, sk, h, hkv, d, causal):
    """K1-bwd: dq and dk/dv against the plain backward, each relative to
    max |ref|; each kernel against the plain version of its own half, and
    the two together against the whole plain backward and SDPA's backward
    (forward outside the timing). No library call computes dq or dk/dv
    alone, so the per-kernel rows carry no library time."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v = randn((b, sq, h, d), gen), randn((b, sk, hkv, d), gen), randn((b, sk, hkv, d), gen)
    do = randn((b, sq, h, d), gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa._delta(out, do).contiguous()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    # deterministic: no atomics, every sum in a fixed order
    bitwise = all(torch.equal(g, a) for g, a in zip(got, again))
    assert bitwise, ("K1-bwd is not bitwise repeatable", b, sq, sk, h, hkv, d, causal)
    del again
    names = ("dq", "dk", "dv")
    rel = {n: rel_max_err(g, r) for n, g, r in zip(names, got, ref)}
    err = {n: (g.float() - r.float()).abs().max().item() for n, g, r in zip(names, got, ref)}
    assert all(torch.isfinite(g).all() for g in got) and max(rel.values()) <= KERNEL_TOL, \
        (b, sq, sk, h, hkv, d, causal, rel)
    del ref
    torch.cuda.empty_cache()
    pairs = sum(min(i + sk - sq + 1, sk) for i in range(sq)) if causal else sq * sk
    product = 2.0 * d * pairs * b * h           # one (q, k)-pair product over D, all heads
    q_bytes, kv_bytes_ = q.numel() * 2, k.numel() * 2
    rows_bytes = 2 * lse.numel() * 4            # lse and delta
    # dq: S, dP and dS.K (3 products); dk/dv: S, dP, P^T.dO and dS^T.qs (4);
    # the backward as a whole: 5 products, q, k, v, o, dO in and dq, dk, dv out
    dq_bound = bound(3 * q_bytes + 2 * kv_bytes_ + rows_bytes, 3 * product)
    dkv_bound = bound(2 * q_bytes + 4 * kv_bytes_ + rows_bytes, 4 * product)
    all_bound = bound(4 * q_bytes + 4 * kv_bytes_ + rows_bytes, 5 * product)
    args = (q, k, v, do, lse, delta, causal)

    def plain_ms(fn):
        ms = cuda_ms(fn, iters=3, warmup=1)
        torch.cuda.empty_cache()
        return ms
    plain = dict(dq=plain_ms(lambda: fa.flash_attention_bwd_dq_plain(*args)),
                 dkv=plain_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args)),
                 both=plain_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                                     causal=causal)))
    library = None
    if not causal or sq == sk:  # SDPA's is_causal is top-left aligned
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        g = do.transpose(1, 2)
        library = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g, retain_graph=True))
        del o
    dq = dict(max_abs_err=err["dq"], rel_max_err=rel["dq"],
              ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(*args)), plain_ms=plain["dq"],
              bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=None)
    dkv = dict(max_abs_err=max(err["dk"], err["dv"]), rel_max_err=max(rel["dk"], rel["dv"]),
               ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args)), plain_ms=plain["dkv"],
               bound_ms=dkv_bound[0], bound_by=dkv_bound[1], library_ms=None)
    return dict(shape=f"B={b} Sq={sq} Sk={sk} H={h} Hkv={hkv} D={d} causal={causal}",
                rel_max_err=rel, bitwise_repeatable=bitwise,
                both_ms=cuda_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, causal=causal)),
                both_plain_ms=plain["both"], both_library_ms=library,
                both_bound_ms=all_bound[0], both_bound_by=all_bound[1],
                flash_attention_bwd_dq=dq, flash_attention_bwd_dkv=dkv)


def int8_pair(x):
    """x quantized per (token, head) as the int8 cache stores it: (int8, f32
    scales)."""
    from deepspeed_tpu_torch.ops.quantization import quantize_kv_tokens
    return quantize_kv_tokens(x)


def unit_scale_pair(x):
    """x's integer part in int8 with unit scales, and the same values in
    bf16: inputs on which an int8 kernel must equal its bf16 kernel."""
    ints = (x.float() * 20).round().clamp(-127, 127).to(torch.int8)
    return ints, torch.ones(ints.shape[:-1], device=ints.device), ints.to(torch.bfloat16)


def check_decode(gen, int8=False, h=H, hkv=HKV, d=D):
    """K2 at the v1 decode shape; with `int8`, K2-int8 on the same cache
    quantized, and unit scales held bitwise to the bf16 kernel."""
    D = d  # noqa: N806 (the shape of this call)
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.quantization import dequantize_kv
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    m = max(DECODE_LENGTHS)
    q, k, v = randn((B, 1, h, D), gen), randn((B, m, hkv, D), gen), randn((B, m, hkv, D), gen)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    kw, elem, extra = {}, 2 * D, {}
    if int8:
        (k, ks), (v, vs) = int8_pair(k), int8_pair(v)
        kw, elem = dict(k_scales=ks, v_scales=vs), D + 4
        ki, ones, kb = unit_scale_pair(randn((B, m, hkv, D), gen))
        extra["unit_scales_bitwise_equal"] = torch.equal(
            da.decode_attention(q, ki, ki, lengths, k_scales=ones, v_scales=ones),
            da.decode_attention(q, kb, kb, lengths))
        assert extra["unit_scales_bitwise_equal"]
    out = da.decode_attention(q, k, v, lengths, **kw)
    extra["calls_bitwise_equal"] = torch.equal(out, da.decode_attention(q, k, v, lengths, **kw))
    ref = da.decode_attention_plain(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= KERNEL_TOL, err
    assert extra["calls_bitwise_equal"], ("K2 is not bitwise repeatable", int8, h, hkv)
    n_kv = sum(DECODE_LENGTHS)
    nbytes = (q.numel() + out.numel()) * 2 + n_kv * hkv * elem * 2 + lengths.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * D * n_kv * h)
    mask = (torch.arange(m, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    # the yardstick reads the dequantized cache, as the bf16 row reads its cache
    kd, vd = (dequantize_kv(k, ks, torch.bfloat16), dequantize_kv(v, vs, torch.bfloat16)) \
        if int8 else (k, v)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kd, vd))

    def kernel():
        return da.decode_attention(q, k, v, lengths, **kw)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    return dict(shape=f"B={B} M={m} H={h} Hkv={hkv} D={D} lengths={list(DECODE_LENGTHS)}"
                      f"{' int8' if int8 else ''}",
                max_abs_err=err, ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                plain_ms=cuda_ms(lambda: da.decode_attention_plain(q, k, v, lengths, **kw)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=cuda_ms(library),
                library_device_ms=device_ms(library), **extra)


def paged_pools(gen, int8, hkv=HKV, d=D):
    """(k_pool, v_pool, scales kwargs) at the serving shape: bf16, or the
    same random values quantized as the int8 pools store them."""
    k, v = randn((hkv, NB, BS, d), gen), randn((hkv, NB, BS, d), gen)
    if not int8:
        return k, v, {}
    (k, ks), (v, vs) = int8_pair(k), int8_pair(v)
    return k, v, dict(k_scales=ks, v_scales=vs)


def paged_inputs(rng, gen, blocks_per_row, int8=False, hkv=HKV, d=D):
    """Pools (Hkv, NB, BS, D), their scales kwargs, and (B, T) tables: a
    seeded permutation of the pool handed out row by row, -1 tails."""
    perm, used = rng.permutation(NB), 0
    tables = np.full((len(blocks_per_row), T), -1, np.int32)
    for row, n in enumerate(blocks_per_row):
        tables[row, :n] = perm[used:used + n]
        used += n
    assert used <= NB
    return (*paged_pools(gen, int8, hkv, d), tables, torch.from_numpy(tables).cuda())


def kv_bytes(tables, spans, int8=False, hkv=HKV, d=D) -> int:
    """Bytes of K and V (and their scales) that attention over `spans`
    ((lo, hi) logical positions per row) reads, each pool row once: table
    entries clamp into the pool, as the kernels clamp them."""
    rows = [np.clip(tables[b, np.arange(lo, hi) // BS], 0, NB - 1) * BS
            + np.arange(lo, hi) % BS for b, (lo, hi) in enumerate(spans) if hi > lo]
    n = np.unique(np.concatenate(rows)).size if rows else 0
    return n * hkv * (d + 4 if int8 else d * 2) * 2


def dense_view(pool, tables_t, scales=None):
    """(B, Hkv, T·BS, D) logical view through the clamped tables, for SDPA
    (an int8 pool dequantized to bf16)."""
    from deepspeed_tpu_torch.ops.quantization import dequantize_kv
    from deepspeed_tpu_torch.ops.cuda.paged_attention import _gather
    if scales is not None:
        pool = dequantize_kv(pool, scales, torch.bfloat16)
    return _gather(pool, tables_t).transpose(0, 1).contiguous()


def alibi_mask(slopes, keep, cols):
    """SDPA's float mask for alibi: slopes[h]·position where `keep`, −inf
    elsewhere, in bf16 (SDPA takes the query's dtype). keep (B, [S,] M),
    cols (B, [S,] M) key positions → (B, H, S, M)."""
    bias = slopes.view(1, -1, *([1] * (cols.dim() - 1))) * cols[:, None].float()
    out = torch.where(keep[:, None], bias, torch.full_like(bias, float("-inf")))
    return (out if keep.dim() == 3 else out[:, :, None]).to(torch.bfloat16)


def control_err(fn, ref, **kw):
    """The kernel run without the slopes against the plain version with
    them: the alibi gate must see the bias, so this must fail it."""
    err = (fn(**kw).float() - ref.float()).abs().max().item()
    assert err > KERNEL_TOL, err
    return err


def check_paged_decode(gen, rng, staged, window=None, int8=False, h=H, hkv=HKV, d=D,
                       alibi=False):
    """K3 at the serving shape: 64 rows, 32 of one block and 31 of two with
    ragged lengths, one parked row (cursor at the capacity, table all -1).
    With `int8`, K3-int8 on int8 pools, and unit scales held bitwise to the
    bf16 kernel. With `alibi`, K3-alibi with the model's slopes for `h`
    heads, beside the control (`control_err`)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    H, HKV, D = h, hkv, d  # noqa: N806 (the shape of this call)
    b = 64
    lengths_np = np.concatenate([rng.integers(1, BS + 1, 32), rng.integers(BS + 1, 2 * BS + 1, 31),
                                 [T * BS + 1]]).astype(np.int32)
    k_pool, v_pool, scales, tables, tables_t = paged_inputs(
        rng, gen, [-(-int(n) // BS) for n in lengths_np[:-1]] + [0], int8, HKV, D)
    lengths = torch.from_numpy(lengths_np).cuda()
    q = randn((b, 1, H, D), gen)
    k_new, v_new = (randn((b, HKV, D), gen), randn((b, HKV, D), gen)) if staged else (None, None)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    kw = dict(k_new=k_new, v_new=v_new, window=window, alibi=slopes, **scales)
    extra = {}
    if int8 and not alibi:
        ki, ones, kb = unit_scale_pair(randn((HKV, NB, BS, D), gen))
        unit = dict(k_new=k_new, v_new=v_new, window=window)
        extra["unit_scales_bitwise_equal"] = torch.equal(
            pa.paged_decode_attention(q, ki, ki, tables_t, lengths, k_scales=ones,
                                      v_scales=ones, **unit),
            pa.paged_decode_attention(q, kb, kb, tables_t, lengths, **unit))
        assert extra["unit_scales_bitwise_equal"], (staged, window)
    out = pa.paged_decode_attention(q, k_pool, v_pool, tables_t, lengths, **kw)
    extra["calls_bitwise_equal"] = torch.equal(
        out, pa.paged_decode_attention(q, k_pool, v_pool, tables_t, lengths, **kw))
    ref = pa.paged_decode_attention_plain(q, k_pool, v_pool, tables_t, lengths, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= KERNEL_TOL, (staged, window, alibi, err)
    assert extra["calls_bitwise_equal"], ("K3 is not bitwise repeatable", staged, window, int8,
                                          alibi)
    if alibi:
        extra["control_no_alibi_max_abs_err"] = control_err(
            pa.paged_decode_attention, ref, q=q, k_pool=k_pool, v_pool=v_pool,
            tables=tables_t, lengths=lengths, **{**kw, "alibi": None})
    qpos = lengths_np.astype(np.int64) - 1
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(b, np.int64)
    hi = np.minimum(lengths_np - int(staged), T * BS)
    keys = int(np.maximum(hi - lo, 0).sum()) + (b if staged else 0)
    nbytes = (kv_bytes(tables, zip(lo, hi), int8, HKV, D) + (q.numel() + out.numel()) * 2
              + tables.size * 4 + b * 4 + (2 * b * HKV * D * 2 if staged else 0)
              + (H * 4 if alibi else 0))
    bound_ms, bound_by = bound(nbytes, 4.0 * D * H * keys)
    # SDPA over the gathered dense view (staged column appended), as a yardstick
    dk = dense_view(k_pool, tables_t, scales.get("k_scales"))
    dv = dense_view(v_pool, tables_t, scales.get("v_scales"))
    cols = torch.arange(T * BS, device="cuda")[None, :]
    mask = (cols >= torch.from_numpy(lo).cuda()[:, None]) & (cols < torch.from_numpy(hi).cuda()[:, None])
    pos = cols.expand(b, -1)
    if staged:
        dk = torch.cat([dk, k_new[:, :, None]], dim=2)
        dv = torch.cat([dv, v_new[:, :, None]], dim=2)
        mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
        pos = torch.cat([pos, (lengths.long() - 1)[:, None]], dim=1)
    attn_mask = alibi_mask(slopes, mask, pos) if alibi else mask[:, None, None, :]
    qt = q.transpose(1, 2)

    def kernel():
        return pa.paged_decode_attention(q, k_pool, v_pool, tables_t, lengths, **kw)

    def library():
        return F.scaled_dot_product_attention(qt, dk, dv, attn_mask=attn_mask, enable_gqa=True)

    return dict(shape=f"B={b} H={H} Hkv={HKV} D={D} BS={BS} T={T} NB={NB} staged={staged} "
                      f"window={window} keys={keys}{' int8' if int8 else ''}"
                      f"{' alibi' if alibi else ''}",
                max_abs_err=err, ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                plain_ms=cuda_ms(lambda: pa.paged_decode_attention_plain(
                    q, k_pool, v_pool, tables_t, lengths, **kw)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=cuda_ms(library),
                library_device_ms=device_ms(library), **extra)


def check_paged_prefill(gen, rng, window=None, int8=False, h=H, hkv=HKV, d=D, alibi=False):
    """K4 at the serving shape: 16 rows of S = 256 new tokens at starts 0,
    256, 300 (unaligned), 512 and 768, and one parked row; two calls must
    give the same bits. With `int8`,
    K4-int8 on int8 pools, and unit scales held bitwise to the bf16 kernel.
    With `alibi`, K4-alibi with the model's slopes for `h` heads, beside the
    control (`control_err`)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    H, HKV, D = h, hkv, d  # noqa: N806 (the shape of this call)
    b, s = 16, 256
    starts_np = np.asarray([(0, 256, 300, 512, 768)[i % 5] for i in range(b - 1)]
                           + [T * BS], np.int32)
    k_pool, v_pool, scales, tables, tables_t = paged_inputs(
        rng, gen, [-(-(int(st) + s) // BS) for st in starts_np[:-1]] + [0], int8, HKV, D)
    starts = torch.from_numpy(starts_np).cuda()
    q = randn((b, s, H, D), gen)
    slopes = alibi_slopes(H, "cuda") if alibi else None
    kw = dict(window=window, alibi=slopes, **scales)
    extra = {}
    if int8 and not alibi:
        ki, ones, kb = unit_scale_pair(randn((HKV, NB, BS, D), gen))
        extra["unit_scales_bitwise_equal"] = torch.equal(
            pa.paged_prefill_attention(q, ki, ki, tables_t, starts, window=window,
                                       k_scales=ones, v_scales=ones),
            pa.paged_prefill_attention(q, kb, kb, tables_t, starts, window=window))
        assert extra["unit_scales_bitwise_equal"], window
    out = pa.paged_prefill_attention(q, k_pool, v_pool, tables_t, starts, **kw)
    extra["calls_bitwise_equal"] = torch.equal(
        out, pa.paged_prefill_attention(q, k_pool, v_pool, tables_t, starts, **kw))
    ref = pa.paged_prefill_attention_plain(q, k_pool, v_pool, tables_t, starts, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= KERNEL_TOL, (window, alibi, err)
    assert extra["calls_bitwise_equal"], ("K4 is not bitwise repeatable", window, int8, alibi)
    if alibi:
        extra["control_no_alibi_max_abs_err"] = control_err(
            pa.paged_prefill_attention, ref, q=q, k_pool=k_pool, v_pool=v_pool,
            tables=tables_t, starts=starts, **{**kw, "alibi": None})
    qpos = starts_np.astype(np.int64)[:, None] + np.arange(s)[None, :]          # (B, S)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros_like(qpos)
    hi = np.minimum(qpos + 1, T * BS)
    keys = int(np.maximum(hi - lo, 0).sum())
    nbytes = (kv_bytes(tables, zip(lo[:, 0], hi[:, -1]), int8, HKV, D)
              + (q.numel() + out.numel()) * 2 + tables.size * 4 + b * 4
              + (H * 4 if alibi else 0))
    bound_ms, bound_by = bound(nbytes, 4.0 * D * H * keys)
    dk = dense_view(k_pool, tables_t, scales.get("k_scales"))
    dv = dense_view(v_pool, tables_t, scales.get("v_scales"))
    cols = torch.arange(T * BS, device="cuda")[None, None, :]
    mask = (cols >= torch.from_numpy(lo).cuda()[..., None]) & \
        (cols < torch.from_numpy(hi).cuda()[..., None])
    attn_mask = alibi_mask(slopes, mask, cols.expand(b, s, -1)) if alibi else mask[:, None]
    qt = q.transpose(1, 2)
    return dict(shape=f"B={b} S={s} H={H} Hkv={HKV} D={D} BS={BS} T={T} NB={NB} "
                      f"starts={sorted(set(starts_np.tolist()))} window={window} keys={keys}"
                      f"{' int8' if int8 else ''}{' alibi' if alibi else ''}",
                max_abs_err=err,
                ms=cuda_ms(lambda: pa.paged_prefill_attention(q, k_pool, v_pool, tables_t,
                                                              starts, **kw)),
                plain_ms=cuda_ms(lambda: pa.paged_prefill_attention_plain(
                    q, k_pool, v_pool, tables_t, starts, **kw), iters=5),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, dk, dv, attn_mask=attn_mask, enable_gqa=True)), **extra)


def check_qmm(gen, m, k, n, block):
    """K5 at (M, K) x (K, N) with weights quantized in blocks of `block`,
    against its plain version relative to max |ref|, and two calls bitwise
    equal (the decode path sums its K slices in a fixed order); the
    yardstick is cuBLAS `F.linear` with a bf16 weight of the same shape."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantization import quantize_int8_blockwise
    x = randn((m, k), gen)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    q, scales = quantize_int8_blockwise(w, block)
    del w
    out = qm.quantized_matmul(x, q, scales)
    repeat = torch.equal(out, qm.quantized_matmul(x, q, scales))
    ref = qm.quantized_matmul_plain(x, q, scales)
    torch.cuda.synchronize()
    err = rel_max_err(out, ref)
    assert out.shape == (m, n) and torch.isfinite(out).all() and err <= KERNEL_TOL, \
        (m, k, n, block, err)
    assert repeat, ("K5 is not bitwise repeatable", m, k, n, block)
    g = qm.scale_group_width(k, n, scales.numel())
    nbytes = m * k * 2 + k * n + scales.numel() * 4 + m * n * 2
    bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
    w_t = torch.randn((n, k), generator=gen, device="cuda").to(torch.bfloat16)
    return dict(shape=f"M={m} K={k} N={n} block={block} g={g}",
                max_abs_err=(out.float() - ref.float()).abs().max().item(), rel_max_err=err,
                calls_bitwise_equal=repeat,
                ms=cuda_ms(lambda: qm.quantized_matmul(x, q, scales)),
                plain_ms=cuda_ms(lambda: qm.quantized_matmul_plain(x, q, scales),
                                 iters=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms(lambda: F.linear(x, w_t)))


def shard_topology(rank):
    """Rank `rank` of a tp = 2 topology on the card (no process group: the
    kernel phase calls each rank's shard in this one process)."""
    from deepspeed_tpu_torch.utils.groups import MeshTopology
    return MeshTopology(tp=TP, world_size=TP, rank=rank, device="cuda")


def head_shard(x, axis, rank):
    """Rank `rank`'s contiguous slice of axis `axis` (heads or columns)."""
    n = x.shape[axis] // TP
    return x.narrow(axis, rank * n, n).contiguous()


def shard_row(name, call, plain, whole, out_axis, nbytes, flops, library, relative=False):
    """K8: `call(rank)` runs the per-shard wrapper on that rank's slice.
    Each rank's output must equal the same heads (or columns) of `whole`,
    the unsharded kernel's output, bit for bit; rank 0's is held against
    its plain version (relative to its largest magnitude for K5, as
    `check_qmm` holds K5) and timed beside it, its bound (the shard's own
    bytes and operations) and `library`."""
    outs = [call(r) for r in range(TP)]
    torch.cuda.synchronize()
    bitwise = all(torch.equal(o, head_shard(whole, out_axis, r)) for r, o in enumerate(outs))
    assert bitwise, name
    ref = plain()
    err = (outs[0].float() - ref.float()).abs().max().item()
    gated = rel_max_err(outs[0], ref) if relative else err
    assert torch.isfinite(outs[0]).all() and gated <= KERNEL_TOL, (name, gated)
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(bitwise_equal_to_unsharded=bitwise, max_abs_err=err,
                **({"rel_max_err": gated} if relative else {}),
                ms=cuda_ms(lambda: call(0)), device_ms=device_ms(lambda: call(0)),
                plain_ms=cuda_ms(plain, iters=5, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=cuda_ms(library),
                library_device_ms=device_ms(library))


def check_sharded_decode(gen):
    """K8-a: K2 per shard at the v1 decode shape, Llama-3-8B's heads cut
    over tp = 2 (rank r: query heads 16r..16r+15, KV heads 4r..4r+3)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda.sharded import sharded_decode_attention
    m = max(DECODE_LENGTHS)
    q, k, v = randn((B, 1, H, D), gen), randn((B, m, HKV, D), gen), randn((B, m, HKV, D), gen)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    whole = da.decode_attention(q, k, v, lengths)
    shards = [[head_shard(x, 2, r) for x in (q, k, v)] for r in range(TP)]
    topos = [shard_topology(r) for r in range(TP)]
    q0, k0, v0 = shards[0]
    n_kv, h, hkv = sum(DECODE_LENGTHS), H // TP, HKV // TP
    mask = (torch.arange(m, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q0, k0, v0))
    row = shard_row(
        "sharded_decode_attention",
        lambda r: sharded_decode_attention(*shards[r], lengths, topos[r]),
        lambda: da.decode_attention_plain(q0, k0, v0, lengths), whole, 2,
        q0.numel() * 2 * 2 + n_kv * hkv * D * 2 * 2 + lengths.numel() * 4,
        4.0 * D * n_kv * h,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    return dict(shape=f"B={B} M={m} H={h} Hkv={hkv} D={D} per rank of H={H} Hkv={HKV}, "
                      f"tp={TP}, lengths={list(DECODE_LENGTHS)}", **row)


def check_sharded_paged_decode(gen, rng):
    """K8-b: K3 per shard at the v2 decode shape (staged, bf16 pools; the
    rows of `check_paged_decode`), the pools' KV heads cut over tp = 2."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.ops.cuda.sharded import sharded_paged_decode_attention
    b, h, hkv = 64, H // TP, HKV // TP
    lengths_np = np.concatenate([rng.integers(1, BS + 1, 32), rng.integers(BS + 1, 2 * BS + 1, 31),
                                 [T * BS + 1]]).astype(np.int32)
    k_pool, v_pool, _, tables, tables_t = paged_inputs(
        rng, gen, [-(-int(n) // BS) for n in lengths_np[:-1]] + [0])
    lengths = torch.from_numpy(lengths_np).cuda()
    q, k_new, v_new = randn((b, 1, H, D), gen), randn((b, HKV, D), gen), randn((b, HKV, D), gen)
    whole = pa.paged_decode_attention(q, k_pool, v_pool, tables_t, lengths, k_new=k_new,
                                      v_new=v_new)
    shards = [dict(q=head_shard(q, 2, r), k_pool=head_shard(k_pool, 0, r),
                   v_pool=head_shard(v_pool, 0, r), k_new=head_shard(k_new, 1, r),
                   v_new=head_shard(v_new, 1, r)) for r in range(TP)]
    topos = [shard_topology(r) for r in range(TP)]
    s0 = shards[0]
    hi = np.minimum(lengths_np - 1, T * BS)
    keys = int(np.maximum(hi, 0).sum()) + b
    nbytes = (kv_bytes(tables, zip(np.zeros(b, np.int64), hi), False, hkv, D)
              + s0["q"].numel() * 2 * 2 + tables.size * 4 + b * 4 + 2 * b * hkv * D * 2)
    dk = torch.cat([dense_view(s0["k_pool"], tables_t), s0["k_new"][:, :, None]], dim=2)
    dv = torch.cat([dense_view(s0["v_pool"], tables_t), s0["v_new"][:, :, None]], dim=2)
    cols = torch.arange(T * BS, device="cuda")[None, :]
    mask = cols < torch.from_numpy(hi).cuda()[:, None]
    mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)[:, None, None, :]
    qt = s0["q"].transpose(1, 2)

    def call(r):
        x = shards[r]
        return sharded_paged_decode_attention(x["q"], x["k_pool"], x["v_pool"], tables_t,
                                              lengths, topos[r], k_new=x["k_new"],
                                              v_new=x["v_new"])

    row = shard_row(
        "sharded_paged_decode_attention", call,
        lambda: pa.paged_decode_attention_plain(s0["q"], s0["k_pool"], s0["v_pool"], tables_t,
                                                lengths, k_new=s0["k_new"], v_new=s0["v_new"]),
        whole, 2, nbytes, 4.0 * D * h * keys,
        lambda: F.scaled_dot_product_attention(qt, dk, dv, attn_mask=mask, enable_gqa=True))
    return dict(shape=f"B={b} H={h} Hkv={hkv} D={D} BS={BS} T={T} NB={NB} staged per rank "
                      f"of H={H} Hkv={HKV}, tp={TP}, keys={keys}", **row)


def check_sharded_paged_prefill(gen, rng):
    """K8-c: K4 per shard at the v2 prefill shape (16 rows of 256 new
    tokens, the rows of `check_paged_prefill`), KV heads cut over tp = 2."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.ops.cuda.sharded import sharded_paged_prefill_attention
    b, s, h, hkv = 16, 256, H // TP, HKV // TP
    starts_np = np.asarray([(0, 256, 300, 512, 768)[i % 5] for i in range(b - 1)]
                           + [T * BS], np.int32)
    k_pool, v_pool, _, tables, tables_t = paged_inputs(
        rng, gen, [-(-(int(st) + s) // BS) for st in starts_np[:-1]] + [0])
    starts = torch.from_numpy(starts_np).cuda()
    q = randn((b, s, H, D), gen)
    whole = pa.paged_prefill_attention(q, k_pool, v_pool, tables_t, starts)
    shards = [(head_shard(q, 2, r), head_shard(k_pool, 0, r), head_shard(v_pool, 0, r))
              for r in range(TP)]
    topos = [shard_topology(r) for r in range(TP)]
    q0, kp0, vp0 = shards[0]
    qpos = starts_np.astype(np.int64)[:, None] + np.arange(s)[None, :]
    hi = np.minimum(qpos + 1, T * BS)
    keys = int(np.maximum(hi, 0).sum())
    nbytes = (kv_bytes(tables, zip(np.zeros(b, np.int64), hi[:, -1]), False, hkv, D)
              + q0.numel() * 2 * 2 + tables.size * 4 + b * 4)
    cols = torch.arange(T * BS, device="cuda")[None, None, :]
    mask = (cols < torch.from_numpy(hi).cuda()[..., None])[:, None]
    dk, dv = dense_view(kp0, tables_t), dense_view(vp0, tables_t)
    qt = q0.transpose(1, 2)
    row = shard_row(
        "sharded_paged_prefill_attention",
        lambda r: sharded_paged_prefill_attention(*shards[r], tables_t, starts, topos[r]),
        lambda: pa.paged_prefill_attention_plain(q0, kp0, vp0, tables_t, starts),
        whole, 2, nbytes, 4.0 * D * h * keys,
        lambda: F.scaled_dot_product_attention(qt, dk, dv, attn_mask=mask, enable_gqa=True))
    return dict(shape=f"B={b} S={s} H={h} Hkv={hkv} D={D} BS={BS} T={T} NB={NB} per rank of "
                      f"H={H} Hkv={HKV}, tp={TP}, keys={keys}", **row)


def check_sharded_qmm(gen):
    """K8-d: K5 per shard at the decode calls (M = 4, blocks of 256):
    'n' on gate/up's column shard (4096 x 7168 of 14336), each rank bitwise
    the unsharded columns; 'k' on down's row shard (7168 of 14336 x 4096),
    the two ranks' partial products summed (the all-reduce, here in one
    process) within the kernel gate of the unsharded product, and rank 0's
    partial held against the plain version at its own shape."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantization import quantize_int8_blockwise
    from deepspeed_tpu_torch.utils.partitioning import shard_leaf

    def weight(k, n):
        q, scales = quantize_int8_blockwise(
            torch.randn((k, n), generator=gen, device="cuda") * 0.02, 256)
        return {"__q8__": q, "scales": scales}

    m, k, n = B, 4096, 14336
    x, w = randn((m, k), gen), weight(k, n)
    whole = qm.quantized_matmul(x, w["__q8__"], w["scales"])
    cut = [shard_leaf(w, 1, TP, r) for r in range(TP)]
    q0, s0 = cut[0]["__q8__"], cut[0]["scales"]
    w_t = torch.randn((n // TP, k), generator=gen, device="cuda").to(torch.bfloat16)
    row = shard_row(
        "sharded_quantized_matmul 'n'",
        lambda r: qm.sharded_quantized_matmul(x, cut[r]["__q8__"], cut[r]["scales"], "n"),
        lambda: qm.sharded_quantized_matmul_plain(x, q0, s0, "n"), whole, 1,
        m * k * 2 + q0.numel() + s0.numel() * 4 + m * (n // TP) * 2,
        2.0 * m * k * n / TP, lambda: F.linear(x, w_t), relative=True)
    # 'k': down's rows
    xk, wk = randn((m, n), gen), weight(n, k)
    whole_k = qm.quantized_matmul(xk, wk["__q8__"], wk["scales"])
    rows = [shard_leaf(wk, 0, TP, r) for r in range(TP)]
    parts = [qm.sharded_quantized_matmul(head_shard(xk, 1, r), rows[r]["__q8__"],
                                         rows[r]["scales"], "k") for r in range(TP)]
    k_err = rel_max_err(parts[0] + parts[1], whole_k)
    assert k_err <= KERNEL_TOL, k_err
    x0, qk0, sk0 = head_shard(xk, 1, 0), rows[0]["__q8__"], rows[0]["scales"]
    k_ref = qm.sharded_quantized_matmul_plain(x0, qk0, sk0, "k")
    k_plain_err = rel_max_err(parts[0], k_ref)
    assert torch.isfinite(parts[0]).all() and k_plain_err <= KERNEL_TOL, k_plain_err
    k_bound, k_by = bound(m * (n // TP) * 2 + qk0.numel() + sk0.numel() * 4 + m * k * 2,
                          2.0 * m * k * n / TP)
    wk_t = torch.randn((k, n // TP), generator=gen, device="cuda").to(torch.bfloat16)
    k_row = dict(shape=f"M={m} K={n // TP} N={k} block=256 (down's rows, tp={TP})",
                 partial_sum_rel_max_err=k_err,
                 max_abs_err=(parts[0].float() - k_ref.float()).abs().max().item(),
                 rel_max_err=k_plain_err,
                 ms=cuda_ms(lambda: qm.sharded_quantized_matmul(x0, qk0, sk0, "k")),
                 plain_ms=cuda_ms(lambda: qm.sharded_quantized_matmul_plain(x0, qk0, sk0, "k"),
                                  iters=5, warmup=1),
                 bound_ms=k_bound, bound_by=k_by, library_ms=cuda_ms(lambda: F.linear(x0, wk_t)))
    return dict(shape=f"M={m} K={k} N={n // TP} block=256 (gate/up's columns, tp={TP})",
                **row, k=k_row)


def routing_sizes(gen, tokens, experts, k):
    """Group sizes of a top-k routing draw: `tokens` random router logits
    through the port's gating, counted per expert (int32, on the card)."""
    from deepspeed_tpu_torch.moe.sharded_moe import _top_k
    idx = _top_k(torch.randn((tokens, experts), generator=gen, device="cuda"), k)
    sizes = torch.zeros(experts, dtype=torch.int32, device="cuda")
    return sizes.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1),
                                                                  dtype=torch.int32))


def grouped_mm_library(operands, sizes, ref):
    """`torch._grouped_mm` on `operands` grouped by `sizes`, where the card's
    torch has it and takes their layout (a yardstick only: the port never
    calls it): (ms, its max error against the plain version relative to
    max |ref|, None), or (None, None, the reason)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, None, "torch has no _grouped_mm"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    try:
        out = fn(*operands, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, ValueError, TypeError) as e:
        return None, None, str(e).splitlines()[0][:200]
    return cuda_ms(lambda: fn(*operands, offs=offs)), rel_max_err(out, ref), None


def check_gmm(gen, name, k, n, sizes):
    """K6 on lhs (M, K), rhs (G, K, N) and `sizes` (G,) int32 against its
    plain version, relative to max |ref|. The bound reads lhs, the weights
    of the groups that have rows (the work this routing needs), the sizes,
    and writes out; operations 2·M·K·N."""
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    m, g = int(sizes.sum()), sizes.numel()
    lhs = randn((m, k), gen)
    rhs = (torch.randn((g, k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    out = gg.grouped_gemm(lhs, rhs, sizes)
    ref = gg.grouped_gemm_plain(lhs, rhs, sizes)
    torch.cuda.synchronize()
    err = rel_max_err(out, ref)
    assert out.shape == (m, n) and torch.isfinite(out).all() and err <= KERNEL_TOL, \
        (name, err)
    used = int((sizes > 0).sum())
    nbytes = m * k * 2 + used * k * n * 2 + g * 4 + m * n * 2
    bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
    library, library_err, library_note = grouped_mm_library((lhs, rhs), sizes, ref)
    row = dict(shape=f"{name}: M={m} K={k} N={n} G={g} groups_with_rows={used} "
                     f"sizes_min={int(sizes.min())} sizes_max={int(sizes.max())}",
               max_abs_err=(out.float() - ref.float()).abs().max().item(), rel_max_err=err,
               ms=cuda_ms(lambda: gg.grouped_gemm(lhs, rhs, sizes)),
               plain_ms=cuda_ms(lambda: gg.grouped_gemm_plain(lhs, rhs, sizes),
                                iters=3, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library,
               library_rel_max_err=library_err, library_note=library_note)
    del lhs, rhs, out, ref
    torch.cuda.empty_cache()
    return row


def skewed_sizes(gen, rows=8192, experts=60, hot=2048):
    """Qwen1.5-MoE's `rows` over its `experts` with one expert (the eighth)
    holding `hot` of them, the rest a top-4 draw: drhs splits that expert's
    rows over several blocks."""
    rest = routing_sizes(gen, (rows - hot) // 4, experts - 1, 4)
    return torch.cat([rest[:7], torch.tensor([hot], dtype=torch.int32, device="cuda"),
                      rest[7:]])


def gmm_cases(gen):
    """K6 at the shapes the MoE paths give it: Qwen1.5-MoE prefill (B = 4 x
    512 tokens, top-4 of 60: M = 8192) gate/up and down, its decode-sized
    call (4 tokens: M = 16 over 60), Mixtral-8x7B w1 and w2 (2048 tokens,
    top-2 of 8: M = 4096), a skewed Qwen routing (one expert holds 2,048 of
    the 8,192 rows), and odd layouts."""
    qwen = routing_sizes(gen, B * PROMPT, 60, 4)
    decode = routing_sizes(gen, B, 60, 4)
    mixtral = routing_sizes(gen, 2048, 8, 2)

    def sizes(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")
    return [check_gmm(gen, "qwen prefill gate/up", 2048, 1408, qwen),
            check_gmm(gen, "qwen prefill down", 1408, 2048, qwen),
            check_gmm(gen, "qwen decode gate/up", 2048, 1408, decode),
            check_gmm(gen, "qwen decode down", 1408, 2048, decode),
            check_gmm(gen, "mixtral prefill w1", 4096, 14336, mixtral),
            check_gmm(gen, "mixtral prefill w2", 14336, 4096, mixtral),
            check_gmm(gen, "qwen skewed gate/up", 2048, 1408, skewed_sizes(gen)),
            check_gmm(gen, "empty first and last groups", 1408, 2048,
                      sizes([0, 300, 0, 77, 211, 0])),
            check_gmm(gen, "one group holds every row", 2048, 1408, sizes([0, 0, 517, 0])),
            check_gmm(gen, "M = 5", 40, 24, sizes([2, 0, 3]))]


def expert_topology(rank):
    """Rank `rank` of an ep = 2 topology on the card (no process group: the
    kernel phase calls each rank's share in this one process)."""
    from deepspeed_tpu_torch.utils.groups import MeshTopology
    return MeshTopology(ep=EP, world_size=EP, rank=rank, device="cuda")


def check_sharded_gmm(gen, name, k, n, sizes):
    """K8-e on lhs (M, K), the expert stack (E, K, N) cut over ep = 2 and
    `sizes` (E,): each rank's output before the all-reduce must be K6's rows
    of its experts' span bit for bit and zeros elsewhere, and the two summed
    (the all-reduce, here in one process) K6's output bit for bit. Rank 0's
    output is held against the plain version relative to max |ref| and timed
    beside it, its bound (its span's lhs rows, its experts that have rows,
    the sizes, all of out) and `torch._grouped_mm` over its span."""
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    m, e = int(sizes.sum()), sizes.numel()
    el = e // EP
    lhs = randn((m, k), gen)
    rhs = (torch.randn((e, k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    whole = gg.grouped_gemm(lhs, rhs, sizes)
    locals_ = [rhs[r * el:(r + 1) * el].contiguous() for r in range(EP)]
    topos = [expert_topology(r) for r in range(EP)]
    starts = [0] + torch.cumsum(sizes, 0).tolist()
    parts = [gg.sharded_grouped_gemm(lhs, locals_[r], sizes, topos[r], reduce=False)
             for r in range(EP)]
    torch.cuda.synchronize()
    for r, part in enumerate(parts):
        lo, hi = starts[r * el], starts[(r + 1) * el]
        assert torch.equal(part[lo:hi], whole[lo:hi]), (name, r)
        assert not part[:lo].any() and not part[hi:].any(), (name, r)
    summed = torch.stack(parts).sum(0)
    assert torch.equal(summed, whole), name
    ref = gg.sharded_grouped_gemm_plain(lhs, locals_[0], sizes, 0)
    err = rel_max_err(parts[0], ref)
    assert torch.isfinite(parts[0]).all() and err <= KERNEL_TOL, (name, err)
    span = starts[el]
    local_sizes = sizes[:el].contiguous()
    used = int((local_sizes > 0).sum())
    nbytes = span * k * 2 + used * k * n * 2 + e * 4 + m * n * 2
    bound_ms, bound_by = bound(nbytes, 2.0 * span * k * n)
    library, library_err, library_note = grouped_mm_library(
        (lhs[:span], locals_[0]), local_sizes, ref[:span])
    row = dict(shape=f"{name}: M={m} K={k} N={n} E={e}, rank 0 of ep={EP}: experts 0..{el - 1}, "
                     f"rows 0..{span - 1}, sizes_min={int(sizes.min())} "
                     f"sizes_max={int(sizes.max())}",
               ranks_bitwise_equal_to_unsharded_rows=True, sum_bitwise_equal_to_unsharded=True,
               max_abs_err=(parts[0].float() - ref.float()).abs().max().item(),
               rel_max_err=err,
               ms=cuda_ms(lambda: gg.sharded_grouped_gemm(lhs, locals_[0], sizes, topos[0],
                                                          reduce=False)),
               plain_ms=cuda_ms(lambda: gg.sharded_grouped_gemm_plain(lhs, locals_[0], sizes, 0),
                                iters=3, warmup=1),
               unsharded_ms=cuda_ms(lambda: gg.grouped_gemm(lhs, rhs, sizes)),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library,
               library_rel_max_err=library_err, library_note=library_note)
    del lhs, rhs, whole, locals_, parts, summed, ref
    torch.cuda.empty_cache()
    return row


def sharded_gmm_cases(gen):
    """K8-e at the shapes the expert-parallel path gives it: the Qwen1.5-MoE
    prefill (M = 8192 over 60 experts, gate/up then down) and decode calls
    (M = 16), Mixtral-8x7B's w1 (M = 4096 over 8), and odd layouts: empty
    experts at both edges of the spans, and M = 5."""
    def sizes(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")
    qwen = routing_sizes(gen, B * PROMPT, 60, 4)
    return [check_sharded_gmm(gen, "qwen prefill gate/up", 2048, 1408, qwen),
            check_sharded_gmm(gen, "qwen prefill down", 1408, 2048, qwen),
            check_sharded_gmm(gen, "qwen decode gate/up", 2048, 1408,
                              routing_sizes(gen, B, 60, 4)),
            check_sharded_gmm(gen, "mixtral prefill w1", 4096, 14336,
                              routing_sizes(gen, 2048, 8, 2)),
            check_sharded_gmm(gen, "empty experts at the span edges", 1408, 2048,
                              sizes([0, 300, 0, 0, 211, 0])),
            check_sharded_gmm(gen, "M = 5", 40, 24, sizes([2, 0, 0, 3]))]


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


def serve(report, model):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    cfg = model.cfg
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16")
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
    SERVE_REFS["v1"] = (out.cpu(), step_logits.float().cpu())

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
    kernels = device_kernels(prof)
    return add_share(profile_summary(prof, steps, wall_us, kernels), kernels, steps, K2_NAME)


def device_kernels(prof) -> dict:
    """{kernel name: (device us, launches)} of a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
            out[e.key] = (us, e.count)
    return out


def profile_summary(prof, steps, wall_us, kernels=None):
    """Step time, device time and launches per step, and the top kernels
    (`kernels`, from `device_kernels`, else the profile's own)."""
    kernels = device_kernels(prof) if kernels is None else kernels
    busy_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return dict(steps=steps, step_ms=wall_us / steps / 1e3,
                device_ms_per_step=busy_us / steps / 1e3,
                device_busy_share=(busy_us / wall_us) if busy_us else None,
                kernel_launches_per_step=sum(n for _, n in kernels.values()) / steps,
                top=[dict(name=name[:90], ms_per_step=us / steps / 1e3,
                          launches_per_step=n / steps) for name, (us, n) in top])


def v2_engine(model, **overrides):
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    return InferenceEngineV2(model, **{**V2, **overrides})


def instrument(engine, watch=()):
    """Count the engine's decode steps and chunk (prefill) calls, and keep
    the latest decode-step logits of the `watch` uids while they are live."""
    calls, last = {"decode_steps": 0, "chunk_calls": 0}, {}
    decode_step, chunk_batch = engine._decode_step, engine._chunk_batch
    sm = engine.state_manager

    def counted_decode(tokens, active):
        logits = decode_step(tokens, active)
        calls["decode_steps"] += 1
        for uid in watch:
            if sm.known_sequence(uid):
                last[uid] = logits[sm.get_sequence(uid).slot].clone()
        return logits

    def counted_chunk(*args):
        calls["chunk_calls"] += 1
        return chunk_batch(*args)

    engine._decode_step, engine._chunk_batch = counted_decode, counted_chunk
    return calls, last


def kernel_counters():
    """Each kernel's name in the `kernels` line → (wrapper, its count)."""
    from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from deepspeed_tpu_torch.ops.cuda.paged_attention import (
        paged_decode_attention, paged_prefill_attention)
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import block_sparse_attention
    from deepspeed_tpu_torch.ops.cuda.grouped_gemm import (
        grouped_gemm, grouped_gemm_dlhs, grouped_gemm_drhs)
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul
    counters = {fn.__name__: (fn, "launches") for fn in (
        flash_attention_fwd, decode_attention, paged_decode_attention,
        paged_prefill_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv,
        quantized_matmul, grouped_gemm, grouped_gemm_dlhs, grouped_gemm_drhs,
        block_sparse_attention)}
    for fn in (decode_attention, paged_decode_attention, paged_prefill_attention):
        counters[fn.__name__ + "_int8"] = (fn, "launches_int8")
    for fn in (paged_decode_attention, paged_prefill_attention):
        counters[fn.__name__ + "_alibi"] = (fn, "launches_alibi")
    from deepspeed_tpu_torch.ops.cuda.grouped_gemm import sharded_grouped_gemm
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import sharded_quantized_matmul
    from deepspeed_tpu_torch.ops.cuda.sharded import (
        sharded_decode_attention, sharded_paged_decode_attention,
        sharded_paged_prefill_attention)
    for fn in (sharded_decode_attention, sharded_paged_decode_attention,
               sharded_paged_prefill_attention, sharded_grouped_gemm):
        counters[fn.__name__] = (fn, "launches")
    for flavor in ("n", "k"):
        counters[f"sharded_quantized_matmul_{flavor}"] = (sharded_quantized_matmul,
                                                          f"launches_{flavor}")
    return counters


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}


def zero_launches():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def only(**counts):
    """The launch counts of every kernel: these, and 0 for the rest."""
    return {**dict.fromkeys(kernel_counters(), 0), **counts}


def traffic_a(engine, rng):
    """Traffic A through `engine` after one warm-up call: 96 prompts of 256
    random tokens, 64 greedy new tokens each. The pool holds 48 sequences
    of 320 tokens, so admission waits on blocks. Returns the outputs, the
    run's numbers, its launches, its decode steps and chunk calls, and the
    WATCH rows' last decode-step logits."""
    vocab = engine.model_cfg.vocab_size
    n, plen, new = TRAFFIC_A
    calls, last = instrument(engine, WATCH)
    engine.generate(rng.integers(0, vocab, (1, plen)).tolist(), max_new_tokens=4)
    prompts = rng.integers(0, vocab, (n, plen)).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    calls.update(decode_steps=0, chunk_calls=0)
    last.clear()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    assert all(len(o) == plen + new and o[:plen] == p for o, p in zip(out, prompts))
    timing = engine.last_timing
    ttft = sorted(rec["first"] for rec in timing.values())
    generated = sum(rec["new_tokens"] for rec in timing.values())
    assert generated == n * new
    cache = engine.cache
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        cache.k_blocks, cache.v_blocks, cache.k_scale_blocks, cache.v_scale_blocks)
        if t is not None)
    stats = dict(prompts=n, prompt_tokens=plen, new_tokens=new, wall_s=wall_s,
                 tok_s=generated / wall_s,
                 decode_tok_s=generated / max(rec["done"] for rec in timing.values()),
                 ttft_min_s=ttft[0], ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
                 kv_util_peak=engine._kv_util_peak,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 pool_bytes=pool_bytes, decode_steps=calls["decode_steps"],
                 chunk_calls=calls["chunk_calls"],
                 serving_counters=dict(engine.serving_counters), launches=launches)
    return out, stats, launches, dict(calls), last


def serve_v2(report, model):
    """Traffic A (the v2 main path), its four WATCH rows' last decode step
    against v1 `forward`, and a profile of the decode step."""
    import deepspeed_tpu_torch
    L = model.cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 10)
    engine = v2_engine(model)
    out, stats, launches, calls, last = traffic_a(engine, rng)
    assert launches == only(paged_decode_attention=L * calls["decode_steps"],
                            paged_prefill_attention=L * calls["chunk_calls"]), \
        (launches, calls)

    # four rows' last decode step against v1 forward on the generated sequence
    v1 = deepspeed_tpu_torch.init_inference(model, dtype="bf16")
    full = v1.forward([out[u][:-1] for u in WATCH])[:, -1]
    errs = [rel_err(last[u], full[i]) for i, u in enumerate(WATCH)]
    assert all(int(last[u].float().argmax()) == out[u][-1] for u in WATCH)
    assert max(errs) <= CONSISTENCY_RTOL, errs
    del v1, full
    report["v2_decode_profile"] = profile_v2_decode(engine, rng)
    del engine
    torch.cuda.empty_cache()
    report["serve_v2"] = dict(
        card=report["card"], model="llama3-8b (random bf16 weights, seed 0)",
        engine=dict(V2), **stats, last_step_vs_v1_forward_rel_rms_err=errs)
    return launches, calls


def profile_v2_decode(engine, rng, rows: int = 48, steps: int = 8):
    """Device time by kernel over `steps` v2 decode steps with `rows` live
    rows of 256-token prompts (traffic A's steady state), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    vocab = engine.model_cfg.vocab_size
    uids = list(range(1000, 1000 + rows))
    first = engine.put(uids, [rng.integers(0, vocab, 256) for _ in uids], argmax_only=True)
    tokens = np.zeros((engine.max_batch, 1), np.int64)
    active = np.zeros((engine.max_batch,), bool)
    slots = []
    for uid in uids:
        seq = engine.state_manager.get_sequence(uid)
        tokens[seq.slot, 0], active[seq.slot] = first[uid], True
        slots.append(seq.slot)
        engine._reserve(seq, seq.seen_tokens + 2 * steps)
    engine._maybe_sync_tables()
    with torch.inference_mode():
        engine._decode_wave(2, tokens, active, slots, uids)       # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine._decode_wave(steps, tokens, active, slots, uids)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    for uid in uids:
        engine.flush(uid)
    kernels = device_kernels(prof)
    return dict(live_rows=rows, max_batch=engine.max_batch,
                **add_share(profile_summary(prof, steps, wall_us, kernels), kernels, steps,
                            K3_NAME))


def serve_v2_shared(report, model):
    """Traffic B: prefix sharing, split-fuse while rows decode, fork with
    copy-on-write, and a prefix-shared prompt against sharing off."""
    cfg = model.cfg
    L, vocab = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.default_rng(SEED + 20)
    engine = v2_engine(model)
    bm = engine.block_manager
    system = rng.integers(0, vocab, 512).tolist()
    # one request commits the system prompt's two full blocks
    engine.generate([system + rng.integers(0, vocab, 64).tolist()], max_new_tokens=4)
    hits0 = bm.prefix_hits
    users = [system + rng.integers(0, vocab, 64).tolist() for _ in range(16)]
    t0 = time.perf_counter()
    out = engine.generate(users, max_new_tokens=16)
    torch.cuda.synchronize()
    users_s = time.perf_counter() - t0
    assert all(len(o) == len(u) + 16 and o[:len(u)] == u for o, u in zip(out, users))
    assert bm.prefix_hits - hits0 == len(users), bm.prefix_hits

    # a 900-token prompt put while four rows decode: split-fuse chunks
    live = [200, 201, 202, 203]
    first = engine.put(live, [rng.integers(0, vocab, 100) for _ in live], argmax_only=True)
    toks = {u: int(first[u]) for u in live}
    long_prompt = rng.integers(0, vocab, 900)
    zero_launches()
    rounds = 0
    while True:
        feeds = [np.asarray([toks[u]]) for u in live]
        outs = engine.put(live + ([300] if rounds == 0 else []),
                          feeds + ([long_prompt] if rounds == 0 else []), argmax_only=True)
        rounds += 1
        toks.update({u: int(outs[u]) for u in live})
        if 300 in outs:
            break
    fused = read_launches()
    assert rounds == 4 and fused["paged_decode_attention"] == L * rounds \
        and fused["paged_prefill_attention"] == L * rounds, (rounds, fused)

    # fork a live sequence mid-block; parent and child fed the same token
    cow0 = bm.cow_copies
    engine.fork(200, 400)
    both = engine.put([200, 400], [np.asarray([toks[200]])] * 2)
    assert bm.cow_copies == cow0 + 1
    assert np.array_equal(both[200], both[400]), "fork logits differ"
    fork_tables = (engine.state_manager.get_sequence(200).blocks,
                   engine.state_manager.get_sequence(400).blocks)

    # a prefix-shared prompt against the same prompt with sharing off
    query = system + rng.integers(0, vocab, 64).tolist()
    shared = engine.put([500], [np.asarray(query)])[500]
    assert bm.prefix_hits - hits0 == len(users) + 1
    counters = dict(prefix_hits=bm.prefix_hits, prefix_tokens_reused=bm.prefix_tokens_reused,
                    cow_copies=bm.cow_copies, shared_blocks=bm.shared_blocks)
    del engine
    torch.cuda.empty_cache()
    plain = v2_engine(model, max_batch=4, num_cache_blocks=8, prefix_sharing=False)
    got = plain.put([500], [np.asarray(query)])
    while 500 not in got:
        got = plain.put([], [])
    shared_err = rel_err(torch.from_numpy(shared), torch.from_numpy(got[500]))
    assert shared_err <= CONSISTENCY_RTOL, shared_err
    del plain
    torch.cuda.empty_cache()
    report["serve_v2_shared"] = dict(
        users=len(users), system_tokens=len(system), users_wall_s=users_s,
        split_fuse_rounds=rounds, fused_round_launches=fused, fork_tables=fork_tables,
        fork_logits_bitwise_equal=True, shared_vs_unshared_rel_rms_err=shared_err,
        **counters)


def generate_logits(engine, ids, new_tokens, force=None):
    """`engine.generate(ids, max_new_tokens=new_tokens)` with the v1
    sampler wrapped to keep every step's logits: (tokens, logits list).
    `force` (B, S + new_tokens), when given, stands in for each sampled
    token (teacher forcing: the engine's own prefill and decode path, on
    those tokens)."""
    from deepspeed_tpu_torch.inference import engine as v1
    sampler, seen = v1.sample_logits, []

    def keep(logits, *args, **kwargs):
        seen.append(logits.detach())
        if force is None:
            return sampler(logits, *args, **kwargs)
        return force[:, ids.shape[1] + len(seen) - 1]

    v1.sample_logits = keep
    try:
        out = engine.generate(ids, max_new_tokens=new_tokens)
    finally:
        v1.sample_logits = sampler
    return out, seen


def serve_kv_int8(report, model):
    """int8 KV at rest on Llama-3-8B's bf16 weights: v1 `dequant` greedy
    `generate` (K2-int8 at every decode step; its last step against the
    bf16-KV engine's `generate` forced through the same tokens, K2 on the
    same decode path, and a control whose int8 writes carry scales twice
    too large), v2 traffic A over int8 pools (K3-int8, K4-int8), and a fork
    with copy-on-write over int8 pools."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import kv_cache
    from deepspeed_tpu_torch.inference.capacity_scan import kv_cache_bytes, round_up_len
    cfg = model.cfg
    L = cfg.num_hidden_layers
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16", kv_cache_dtype="int8")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.generate(ids[:1, :16], max_new_tokens=2)      # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out, seen = generate_logits(engine, ids, NEW)
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    last = seen[-1]
    # the prefill reads the int8 cache's dequantized view (the masked path)
    assert launches == only(decode_attention_int8=L * (NEW - 1)), launches
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    bf16_kv = generate_logits(deepspeed_tpu_torch.init_inference(model, dtype="bf16"),
                              ids, NEW, force=out)[1][-1]
    err = rel_err(last, bf16_kv)
    assert torch.isfinite(last).all() and err <= INT8_KV_RTOL, err
    # the control: a fault in the int8 write (every scale doubled) must
    # fail the same gate
    quantize = kv_cache.quantize_kv_tokens
    kv_cache.quantize_kv_tokens = lambda x: (lambda q, s: (q, 2.0 * s))(*quantize(x))
    try:
        control = rel_err(generate_logits(engine, ids, NEW, force=out)[1][-1], bf16_kv)
    finally:
        kv_cache.quantize_kv_tokens = quantize
    assert control > INT8_KV_RTOL, control
    max_len = round_up_len(PROMPT + NEW)
    v1 = dict(batch=B, prompt=PROMPT, new_tokens=NEW, generate_ms=generate_ms,
              generate_prefill_ms=prefill_ms,
              decode_tok_s=B * (NEW - 1) / ((generate_ms - prefill_ms) / 1e3),
              kv_cache_bytes=kv_cache_bytes(cfg, B, max_len, torch.bfloat16, "int8"),
              kv_cache_bytes_bf16=kv_cache_bytes(cfg, B, max_len, torch.bfloat16),
              last_step_vs_bf16_kv_generate_rel_rms_err=err,
              doubled_scales_control_rel_rms_err=control, launches=launches)
    del engine, bf16_kv, last, seen
    gc.collect()
    torch.cuda.empty_cache()

    # v2 traffic A over int8 pools
    rng = np.random.default_rng(SEED + 10)
    engine = v2_engine(model, kv_cache_dtype="int8")
    out, stats, v2_launches, calls, _ = traffic_a(engine, rng)
    assert v2_launches == only(paged_decode_attention_int8=L * calls["decode_steps"],
                               paged_prefill_attention_int8=L * calls["chunk_calls"]), \
        (v2_launches, calls)
    # a fork mid-block: the parent's write copies the shared block (values
    # and scales); parent and child fed the same token give equal logits
    vocab = cfg.vocab_size
    first = engine.put([200], [rng.integers(0, vocab, 100)], argmax_only=True)
    tok = int(first[200])
    for _ in range(3):
        tok = int(engine.put([200], [np.asarray([tok])], argmax_only=True)[200])
    cow0 = engine.block_manager.cow_copies
    engine.fork(200, 400)
    both = engine.put([200, 400], [np.asarray([tok])] * 2)
    assert engine.block_manager.cow_copies == cow0 + 1
    assert np.array_equal(both[200], both[400]), "int8 fork logits differ"
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    report["serve_kv_int8"] = dict(
        card=report["card"], model="llama3-8b (random bf16 weights, seed 0)",
        v1=v1, v2_traffic_a=dict(engine=dict(V2, kv_cache_dtype="int8"), **stats),
        fork_logits_bitwise_equal=True)
    return launches, v2_launches


def serve_int8(report, model):
    """Llama-3-8B with int8 weights through `serve_mode="layer_scan"` (the
    fused dequant-GEMM, K5, on every projection): B=4 x 512 prompts, greedy
    `generate` of 64 tokens, the last decode step against the same int8
    tree served by `dequant` (the engine's `forward` on the generated
    tokens, which dequantizes the whole tree), and a profile of 8 decode
    steps. `model`'s own weights are released into the
    int8 tree."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.inference import quantized_layer_scan as qls
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.serve_modes import resolve_serve_mode
    from deepspeed_tpu_torch.models.llama import param_tree
    cfg = model.cfg
    L = cfg.num_hidden_layers
    quant = {"enabled": True, "group_size": 256}
    auto = resolve_serve_mode(types.SimpleNamespace(
        _config=DeepSpeedInferenceConfig(dtype="bf16", quant=quant, max_batch_size=B),
        model_cfg=cfg, _quantized=True, accelerator=get_accelerator()),
        param_tree(model, device="meta"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16", quant=quant,
                                                serve_mode="layer_scan")
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    place_peak = torch.cuda.max_memory_allocated()
    assert engine.serve_mode == "layer_scan" and engine._use_fused_int8()
    at_rest = qls.at_rest_bytes(engine.params)
    allocated = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.generate(ids[:1, :16], max_new_tokens=2)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out, seen = generate_logits(engine, ids, NEW)
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    greedy_tok_s = engine.last_decode_tok_s
    per_call = 7 * L
    assert launches == only(quantized_matmul=per_call * NEW,
                            decode_attention=L * (NEW - 1)), launches
    assert out.shape == (B, PROMPT + NEW) and torch.equal(out[:, :PROMPT], ids)
    step_logits = seen[-1]
    assert torch.equal(step_logits.float().argmax(-1), out[:, -1])
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    profile = profile_generate(engine, ids, kernels=(("quantized_matmul", "qmm_"), K2_NAME))
    prefill_profile = profile_prefill(engine, ids, kernel=("quantized_matmul", "qmm_"))

    # the same int8 tree served by dequant: `forward` dequantizes the whole
    # tree in every serve mode, then runs the module (cuBLAS, flash forward)
    full = engine.forward(out[:, :-1])[:, -1]
    err = rel_err(step_logits, full)
    assert torch.isfinite(step_logits).all() and err <= CONSISTENCY_RTOL, err
    del engine, full
    gc.collect()
    torch.cuda.empty_cache()
    report["serve_int8"] = dict(
        card=report["card"], model="llama3-8b (random bf16 weights, seed 0), int8 group 256",
        auto_resolves_to=auto, serve_mode="layer_scan", batch=B, prompt=PROMPT,
        new_tokens=NEW, placement_s=place_s, placement_peak_memory_bytes=place_peak,
        weights_at_rest=at_rest, allocated_after_placement_bytes=allocated,
        generate_ms=generate_ms, generate_prefill_ms=prefill_ms,
        decode_tok_s=B * (NEW - 1) / ((generate_ms - prefill_ms) / 1e3),
        engine_last_decode_tok_s=greedy_tok_s, generate_peak_memory_bytes=peak,
        quantized_matmul_per_model_call=per_call, launches=launches,
        last_step_vs_dequant_forward_rel_rms_err=err,
        decode_profile=profile, prefill_profile=prefill_profile)
    return launches


def pinned_h2d_bytes_per_s(nbytes: int, iters: int = 5) -> float:
    """Host-to-device bytes/s of one copy of `nbytes` from page-locked
    memory, alone on the card (CUDA events around `iters` copies)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), iters=iters, warmup=1)
    del host, dev
    return nbytes / (ms / 1e3)


def aliased_bytes(engine, model) -> int:
    """Bytes of the capacity runner's resident tier that are the module's
    own tensors (counted in the plan, not new on the card)."""
    ptrs = {p.data_ptr() for p in model.parameters()}
    return sum(t.numel() * t.element_size() for t in (
        engine._capacity.resident["embed_tokens"], engine._capacity.resident["norm"]["weight"])
        if t.data_ptr() in ptrs)


def timed_generate(engine, ids, new_tokens):
    """(tokens, step logits, generate ms) of a greedy `generate`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, seen = generate_logits(engine, ids, new_tokens)
    return out, seen, (time.perf_counter() - t0) * 1e3


def forced_last_step(engine, out):
    """The last decode step of `out`, teacher forced: a prefill of all but
    its last two tokens, then one decode step on the second-to-last."""
    return generate_logits(engine, out[:, :-2], 2, force=out)[1][-1]


def free_capacity(host: bool = False):
    """After the caller dropped a capacity engine: its device slabs back to
    the card; with `host`, the page-locked blocks PyTorch's host allocator
    keeps cached for reuse (the next bf16 engine reuses them unpinned)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    empty = (getattr(torch._C, "_host_emptyCache", None)
             or getattr(torch._C, "_accelerator_emptyHostCache", None))
    if host and empty is not None:
        empty()


def pinned_host_bytes():
    """The byte counts PyTorch's host allocator reports for its page-locked
    blocks now ({} where this torch reports none)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return {k: v for k, v in (stats() if stats is not None else {}).items()
            if "bytes" in k and k.endswith(".current")}


def serve_capacity(report, model):
    """ZeRO-Inference on Llama-3-8B at full width and depth (module
    docstring, 7a): the layers streamed from page-locked host memory (bf16,
    double-buffered, then synchronous), from NVMe for CAP_NVME_LAYERS of
    them, and in int8 (K5), through v1 and v2; every layer's decode through
    K2. The module's weights stay on the card for `serve_int8`."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import nvme
    from deepspeed_tpu_torch.inference import capacity_scan
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    cfg = model.cfg
    L = cfg.num_hidden_layers
    out_ref, step_ref = (t.cuda() for t in SERVE_REFS["v1"])   # `serve`'s greedy run
    ids = out_ref[:, :PROMPT]
    n = CAP_NEW
    free_capacity(host=True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16", serve_mode="capacity")
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    pinned = pinned_host_bytes()
    runner = engine._capacity
    slice_bytes = runner.slice_bytes()
    assert engine.serve_mode == "capacity" and runner.host_resident()
    h2d = pinned_h2d_bytes_per_s(slice_bytes)
    bound_step_ms = L * slice_bytes / h2d * 1e3

    # peak device memory of a generate against the plan (the first call:
    # no earlier transient in the peak)
    alias = aliased_bytes(engine, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.generate(ids[:1, :CAP_PEAK[0]], max_new_tokens=CAP_PEAK[1] - CAP_PEAK[0])
    peak = torch.cuda.max_memory_allocated() - base + alias
    plan = runner.plan_for(1, CAP_PEAK[0], CAP_PEAK[1] - CAP_PEAK[0])
    assert peak <= CAP_PEAK_RATIO * plan.peak_hbm_bytes, (peak, plan)
    held = torch.cuda.memory_allocated() - base + alias     # between calls
    assert held <= plan.resident_bytes + 2 * runner._buf_bytes + (64 << 20), held

    # the main path: greedy generate of n tokens, launches counted
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    out, seen, gen_ms = timed_generate(engine, ids, n)
    launches = read_launches()
    assert launches == only(decode_attention=L * (n - 1)), launches
    stall_ms = engine.serving_stats()["prefetch_stall_ms"]
    peak_b4 = torch.cuda.max_memory_allocated() - base + alias
    assert out.shape == (B, PROMPT + n) and torch.equal(out[:, :PROMPT], ids)
    assert torch.equal(seen[-1].float().argmax(-1), out[:, -1])
    agree = (out[:, PROMPT:] == out_ref[:, PROMPT:PROMPT + n]).float().mean().item()
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_ms = (gen_ms - prefill_ms) / (n - 1)

    # the last decode step of `serve`'s tokens, teacher forced, against its
    # own; the control runs every layer on its predecessor's weights (an
    # off-by-one in the staging schedule) and must miss
    forced = forced_last_step(engine, out_ref)
    err = rel_err(forced, step_ref)
    host_slice = capacity_scan.CapacityRunner._host_slice
    capacity_scan.CapacityRunner._host_slice = lambda self, l: host_slice(self, max(l - 1, 0))
    try:
        control = rel_err(forced_last_step(engine, out_ref), step_ref)
    finally:
        capacity_scan.CapacityRunner._host_slice = host_slice
    assert torch.isfinite(forced).all() and err <= CONSISTENCY_RTOL < control, (err, control)
    del runner, engine
    free_capacity()

    # the synchronous mode: one slab, no overlap; the same bits
    sync = deepspeed_tpu_torch.init_inference(model, dtype="bf16", serve_mode="capacity",
                                              capacity={"double_buffer": False})
    assert len(sync._capacity._slabs) == 1
    assert torch.equal(forced_last_step(sync, out_ref), forced)
    sync_out, _, sync_ms = timed_generate(sync, ids, n)
    assert torch.equal(sync_out, out)
    sync_stall = sync.serving_stats()["prefetch_stall_ms"]
    del sync
    free_capacity()

    # the NVMe tier: the last CAP_NVME_LAYERS layers read back through the
    # aio engine each pass; the same tokens
    nvme_dir = CAP_NVME_DIR
    shutil.rmtree(nvme_dir, ignore_errors=True)
    sweep = nvme.sweep(str(nvme_dir / "sweep"), mb=256)
    t0 = time.perf_counter()
    disk = deepspeed_tpu_torch.init_inference(
        model, dtype="bf16", serve_mode="capacity",
        capacity={"nvme_dir": str(nvme_dir), "nvme_layers": CAP_NVME_LAYERS})
    nvme_place_s = time.perf_counter() - t0
    assert disk._capacity.plan.nvme_layers == CAP_NVME_LAYERS
    disk_out, _, disk_ms = timed_generate(disk, ids, CAP_NVME_NEW)
    assert torch.equal(disk_out, out[:, :PROMPT + CAP_NVME_NEW])
    backend = disk._capacity._nvme.counters["backend"]
    del disk
    free_capacity(host=True)
    shutil.rmtree(nvme_dir, ignore_errors=True)

    # int8: the layer scan's tree (built from a copy of the weights, the
    # module untouched) against capacity int8 quantized from the module
    quant = {"enabled": True, "group_size": 256}
    scan = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(cfg, device="meta"), params=model.param_tree(dtype=torch.bfloat16),
        dtype="bf16", quant=quant, serve_mode="layer_scan")
    scan_forced = forced_last_step(scan, out_ref)
    scan_out = scan.generate(ids, max_new_tokens=CAP_INT8_NEW)
    int8 = deepspeed_tpu_torch.init_inference(model, dtype="bf16", quant=quant,
                                              serve_mode="capacity")
    assert int8._capacity.quantized and int8._use_fused_int8()
    zero_launches()
    int8_out, _, int8_ms = timed_generate(int8, ids, CAP_INT8_NEW)
    int8_launches = read_launches()
    assert int8_launches == only(quantized_matmul=7 * L * CAP_INT8_NEW,
                                 decode_attention=L * (CAP_INT8_NEW - 1)), int8_launches
    assert torch.equal(int8_out, scan_out)
    assert torch.equal(forced_last_step(int8, out_ref), scan_forced)
    t0 = time.perf_counter()
    int8.generate(ids, max_new_tokens=1)
    torch.cuda.synchronize()
    int8_prefill_ms = (time.perf_counter() - t0) * 1e3
    int8_slice = int8._capacity.slice_bytes()
    h2d_int8 = pinned_h2d_bytes_per_s(int8_slice)
    del int8
    free_capacity()

    # v2 on slot rows: the layer scan over the int8 tree, then capacity
    # streaming the same tree; the same tokens
    rng = np.random.default_rng(SEED + 40)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, p))) for p in CAP_V2_PROMPTS]
    v2 = {}
    for mode in ("layer_scan", "capacity"):
        eng = v2_engine(LlamaForCausalLM(cfg, device="meta"), params=scan.params,
                        serve_mode=mode, quant=quant, **CAP_V2)
        assert eng.kv_layout == "slot"
        calls, _ = instrument(eng)
        zero_launches()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=CAP_V2_NEW)
        wall = time.perf_counter() - t0
        got = read_launches()
        # a chunk call runs each slot row's piece as its own model call
        pieces = sum(-(-p // CAP_V2["split_fuse_chunk"]) for p in CAP_V2_PROMPTS)
        model_calls = calls["decode_steps"] + pieces
        assert got == only(quantized_matmul=7 * L * model_calls,
                           decode_attention=L * calls["decode_steps"]), (mode, got, calls)
        v2[mode] = dict(tokens=toks, wall_s=wall, launches=got, calls=dict(calls),
                        tok_s=len(prompts) * CAP_V2_NEW / wall)
        del eng
        free_capacity()
    assert v2["capacity"]["tokens"] == v2["layer_scan"]["tokens"]
    del scan
    free_capacity(host=True)

    report["serve_capacity"] = dict(
        card=report["card"], model="llama3-8b (random bf16 weights, seed 0)",
        slice_bytes=slice_bytes, int8_slice_bytes=int8_slice, layers=L,
        pinned_host_bf16_tier=pinned,
        pinned_h2d_GBps_one_slice=h2d / 1e9, bound_step_ms=bound_step_ms,
        pinned_h2d_GBps_one_int8_slice=h2d_int8 / 1e9,
        int8_bound_step_ms=L * int8_slice / h2d_int8 * 1e3, placement_s=place_s,
        plan_batch1=dict(dataclasses.asdict(plan), peak_hbm_bytes=plan.peak_hbm_bytes),
        peak_memory_batch1_bytes=peak, held_between_calls_bytes=held,
        peak_memory_batch4_bytes=peak_b4, resident_aliased_bytes=alias,
        bf16=dict(batch=B, prompt=PROMPT, new_tokens=n, generate_ms=gen_ms,
                  prefill_ms=prefill_ms, step_ms=step_ms,
                  decode_tok_s=B * (n - 1) / ((gen_ms - prefill_ms) / 1e3),
                  prefetch_stall_ms=stall_ms, tokens_agree_with_serve=agree,
                  last_step_vs_serve_rel_rms_err=err, off_by_one_layer_control=control),
        synchronous=dict(generate_ms=sync_ms, step_ms=(sync_ms - prefill_ms) / (n - 1),
                         decode_tok_s=B * (n - 1) / ((sync_ms - prefill_ms) / 1e3),
                         prefetch_stall_ms=sync_stall, bitwise_double_buffered=True),
        nvme=dict(layers_on_disk=CAP_NVME_LAYERS, new_tokens=CAP_NVME_NEW, placement_s=nvme_place_s,
                  generate_ms=disk_ms, engine=backend, sweep=sweep,
                  decode_tok_s=B * (CAP_NVME_NEW - 1) / ((disk_ms - prefill_ms) / 1e3),
                  tokens_equal=True),
        int8=dict(new_tokens=CAP_INT8_NEW, generate_ms=int8_ms, prefill_ms=int8_prefill_ms,
                  decode_tok_s=B * (CAP_INT8_NEW - 1) / ((int8_ms - int8_prefill_ms) / 1e3),
                  launches=int8_launches, forced_logits_bitwise_layer_scan=True,
                  tokens_equal_layer_scan=True),
        v2={mode: {k: v for k, v in r.items() if k != "tokens"} for mode, r in v2.items()},
        launches=launches)
    log(f"serve_capacity ({report['card']}): pinned H2D {h2d / 1e9:.2f} GB/s "
        f"(one {slice_bytes / 1e6:.1f} MB slice), bound {bound_step_ms:.0f} ms a step; "
        f"bf16 step {step_ms:.0f} ms, decode {B * (n - 1) / ((gen_ms - prefill_ms) / 1e3):.2f} "
        f"tok/s, prefill {prefill_ms:.0f} ms; synchronous {(sync_ms - prefill_ms) / (n - 1):.0f} "
        f"ms a step; int8 {(int8_ms - int8_prefill_ms) / (CAP_INT8_NEW - 1):.0f} ms a step "
        f"(bound {L * int8_slice / h2d_int8 * 1e3:.0f} at {h2d_int8 / 1e9:.2f} GB/s); "
        f"NVMe ({backend}, read {sweep['read_GBps']:.2f} GB/s) {disk_ms:.0f} ms for "
        f"{CAP_NVME_NEW} tokens; peak {peak / 1e9:.2f} GB against a plan of "
        f"{plan.peak_hbm_bytes / 1e9:.2f}; last step {err:.4f} (control {control:.3f})")
    return launches, int8_launches, v2["capacity"]["launches"]


def profile_generate(engine, ids, steps: int = 8, kernels=(("quantized_matmul", "qmm_"),)):
    """Device time by kernel over `steps` decode steps of the engine's own
    `generate`, from torch.profiler: a `generate` of steps + 1 tokens less
    a prefill-only one (one token). Adds the share of the device time of
    each of `kernels` (its name in the report, a substring of its CUDA
    name)."""
    from torch.profiler import ProfilerActivity, profile
    runs = []
    for new in (steps + 1, 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.generate(ids, max_new_tokens=new)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        runs.append((wall_us, device_kernels(prof)))
    (wall, full), (prefill_wall, prefill) = runs
    decode = {name: (us - prefill.get(name, (0.0, 0))[0], n - prefill.get(name, (0.0, 0))[1])
              for name, (us, n) in full.items()}
    summary = profile_summary(None, steps, wall - prefill_wall, decode)
    for kernel in kernels:
        add_share(summary, decode, steps, kernel)
    return summary


def add_share(summary, kernels, steps, kernel):
    """`summary` with the device ms per step and device-time share of
    `kernel` (its name in the report, a substring of its CUDA name)."""
    busy = sum(us for us, _ in kernels.values())
    mine = sum(us for name, (us, _) in kernels.items() if kernel[1] in name)
    summary[f"{kernel[0]}_ms_per_step"] = mine / steps / 1e3
    summary[f"{kernel[0]}_device_share"] = mine / busy if busy else None
    return summary


def profile_prefill(engine, ids, kernel=("grouped_gemm", "gmm_kernel")):
    """Device time by kernel over one prefill (`generate` of one token),
    from torch.profiler, with `kernel`'s share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(ids, max_new_tokens=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    return add_share(profile_summary(None, 1, wall_us, kernels), kernels, 1, kernel)


def moe_model(cls, cfg, seed):
    """An MoE model built on the card in bf16 (f32 construction would need
    four bytes a parameter), with random weights from `seed`."""
    from deepspeed_tpu_torch.models.llama import init_params
    model = cls(cfg, device="cuda", dtype=torch.bfloat16)
    return init_params(model, torch.Generator(device="cuda").manual_seed(seed))


class RoutingRecorder:
    """Each router's top-k experts of its latest call, in layer order."""

    def __init__(self, model):
        from deepspeed_tpu_torch.moe.layer import TopKGate
        self.gates = [m for m in model.modules() if isinstance(m, TopKGate)]
        self.last = {}
        self.handles = [g.register_forward_hook(self._keep) for g in self.gates]

    def _keep(self, gate, args, out):
        self.last[gate] = out[2]   # the index form: (l_aux, gate_k, topk_idx, ...)

    def take(self):
        return [self.last[g] for g in self.gates]

    def remove(self):
        for h in self.handles:
            h.remove()


def flip_share(got, ref) -> float:
    """Share of (token, layer) routing decisions whose expert sets differ
    between two runs over the same tokens."""
    flips = total = 0
    for a, b in zip(got, ref):
        a, b = a.sort(-1).values.cpu(), b.sort(-1).values.cpu()
        flips += int((a != b).any(-1).sum())
        total += a.shape[0]
    return flips / total


def cached_prefill(module, ids, last_only=False):
    """The module's cached path over `ids` in one call (no drops; the
    grouped GEMM from b·s·k ≥ 1024 rows): logits (B, S, V), or (B, V) at the
    last position."""
    from deepspeed_tpu_torch.inference.capacity_scan import round_up_len
    from deepspeed_tpu_torch.inference.kv_cache import KVCache
    cfg = module.cfg
    b, s = ids.shape
    dtype = next(module.parameters()).dtype
    cache = KVCache.create(cfg.num_hidden_layers, b, round_up_len(s), cfg.num_key_value_heads,
                           cfg.head_dim, dtype=dtype, device=ids.device)
    at = torch.full((b,), s - 1, device=ids.device) if last_only else None
    with torch.inference_mode():
        return module(ids, cache=cache, logits_at=at)[0]


def gate(what, err, bound_, control, flips):
    """An MoE logits gate: `err` within `bound_`, and the control (the same
    comparison with a fault in K6's schedule) outside it."""
    assert err <= bound_ < control, (what, err, bound_, control, flips)


def rolled_sizes_control(fn):
    """`fn()` with a fault in K6's schedule: every group's rows sent to the
    next group's expert (the sizes rolled by one)."""
    from deepspeed_tpu_torch.moe import layer as moe_layer
    real = moe_layer.grouped_gemm
    moe_layer.grouped_gemm = lambda lhs, rhs, sizes: real(lhs, rhs, torch.roll(sizes, 1))
    try:
        return fn()
    finally:
        moe_layer.grouped_gemm = real


def serve_moe(report):
    """Qwen1.5-MoE-A2.7B at full width and depth (24 layers, random bf16
    weights) through v1 `init_inference`: `forward` on B x 512 (the ragged
    drop path), greedy `generate` of 64 tokens (the MoE main path: its
    prefill runs K6 three times a layer, its decode steps the ragged
    buffer and K2), the last decode step against a cached prefill of the
    whole sequence (K6, no drops; never against `forward`, whose drops
    differ by design) with the routing-flip share and a control, a sampled
    `generate`, prefill and decode profiles, and decode with the grouped
    GEMM forced (`dispatch_impl="gmm"`) beside `auto`."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM, qwen2_moe_config
    cfg = qwen2_moe_config(QWEN_MOE)
    L = cfg.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(moe_model(Qwen2MoeForCausalLM, cfg, SEED + 40),
                                                dtype="bf16")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    module = engine.module
    weights = sum(p.numel() * p.element_size() for p in module.parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.forward(ids[:1, :16])                       # warm-up
    engine.generate(ids, max_new_tokens=2)
    recorder = RoutingRecorder(module)

    # the main path: counted launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    logits = engine.forward(ids)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out, seen = generate_logits(engine, ids, NEW)
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    greedy_tok_s = engine.last_decode_tok_s
    decode_routing = recorder.take()
    assert launches == only(flash_attention_fwd=L, decode_attention=L * (NEW - 1),
                            grouped_gemm=3 * L), launches
    assert logits.shape == (B, PROMPT, cfg.vocab_size) and torch.isfinite(logits).all()
    assert out.shape == (B, PROMPT + NEW) and torch.equal(out[:, :PROMPT], ids)
    step_logits = seen[-1]
    assert torch.equal(step_logits.float().argmax(-1), out[:, -1])
    del logits

    # the last decode step against a cached prefill of the whole sequence
    seq = out[:, :-1]
    full = cached_prefill(module, seq, last_only=True)
    prefill_routing = [r.reshape(B, seq.shape[1], -1)[:, -1] for r in recorder.take()]
    recorder.remove()
    consistency = rel_err(step_logits, full)
    flips = flip_share(decode_routing, prefill_routing)
    control = rel_err(step_logits, rolled_sizes_control(
        lambda: cached_prefill(module, seq, last_only=True)))
    assert torch.isfinite(step_logits).all()
    gate("serve_moe last step vs cached prefill", consistency, MOE_CONSISTENCY_RTOL, control,
         flips)

    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    prefill_ms = (time.perf_counter() - t0) * 1e3

    zero_launches()
    sampled = engine.generate(ids, max_new_tokens=NEW, temperature=0.8, top_p=0.9,
                              seed=SEED + 2)
    sampled_launches = read_launches()
    assert sampled_launches == launches | {"flash_attention_fwd": 0}, sampled_launches
    assert sampled.shape == out.shape and int(sampled.min()) >= 0 \
        and int(sampled.max()) < cfg.vocab_size

    prefill_profile = profile_prefill(engine, ids)
    decode_profile = profile_generate(engine, ids, kernels=(K2_NAME,))   # no K6 at decode
    # the ragged decode's expert products: one layer's batched FFN over the
    # (E, C = B, D) buffer, by CUDA events, and its share of the profiled
    # decode step's device time
    experts = module.layers[0].mlp.experts
    buf = randn((cfg.num_experts, B, cfg.hidden_size), gen)
    with torch.inference_mode():
        ragged_experts_ms = cuda_ms(lambda: experts(buf))
    device_ms = decode_profile["device_ms_per_step"]
    decode_profile["ragged_experts_ms_per_step"] = ragged_experts_ms * L
    decode_profile["ragged_experts_device_share"] = \
        ragged_experts_ms * L / device_ms if device_ms else None

    # decode with the grouped GEMM forced (K6 at M = B·k = 16 rows)
    for layer in module.layers:
        layer.mlp.dispatch_impl = "gmm"
    engine.generate(ids, max_new_tokens=2)                # warm-up
    zero_launches()
    t0 = time.perf_counter()
    gmm_out = engine.generate(ids, max_new_tokens=NEW)
    gmm_generate_ms = (time.perf_counter() - t0) * 1e3
    gmm_launches = read_launches()
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    gmm_prefill_ms = (time.perf_counter() - t0) * 1e3
    gmm_profile = profile_generate(engine, ids, kernels=(("grouped_gemm", "gmm_kernel"),))
    for layer in module.layers:
        layer.mlp.dispatch_impl = cfg.dispatch_impl
    assert gmm_launches["grouped_gemm"] == 3 * L * NEW, gmm_launches
    del engine, module, recorder, full, seen
    gc.collect()
    torch.cuda.empty_cache()
    report["serve_moe"] = dict(
        card=report["card"], model=f"{QWEN_MOE} (random bf16 weights, seed {SEED + 40})",
        layers=L, batch=B, prompt=PROMPT, new_tokens=NEW, build_and_place_s=build_s,
        weights_at_rest_bytes=weights, generate_peak_memory_bytes=peak,
        forward_ms=forward_ms, generate_ms=generate_ms, generate_prefill_ms=prefill_ms,
        decode_tok_s=B * (NEW - 1) / ((generate_ms - prefill_ms) / 1e3),
        engine_last_decode_tok_s=greedy_tok_s, launches=launches,
        last_step_vs_cached_prefill_rel_rms_err=consistency,
        last_step_routing_flip_share=flips, rolled_sizes_control_rel_rms_err=control,
        gmm_decode=dict(generate_ms=gmm_generate_ms, generate_prefill_ms=gmm_prefill_ms,
                        decode_tok_s=B * (NEW - 1) / ((gmm_generate_ms - gmm_prefill_ms)
                                                      / 1e3),
                        greedy_tokens_equal_share=float((gmm_out == out).float().mean()),
                        launches=gmm_launches, decode_profile=gmm_profile),
        ragged_experts_ms_per_layer=ragged_experts_ms,
        prefill_profile=prefill_profile, decode_profile=decode_profile)
    return launches


def reference_moe(report):
    """Two layers at the Qwen1.5-MoE-A2.7B and Mixtral-8x7B widths: the card
    in bf16 against the plain versions on the CPU in f32, on the same
    weights. The card's v1 greedy `generate` of 8 tokens (its prefill at
    b·s·k = 1024 rows runs K6) and a cached prefill of the generated
    sequence against the CPU's cached prefill of it, with the routing-flip
    share and the rolled-sizes control."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_config
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM, qwen2_moe_config
    rows = {}
    for seed, (name, cls, config, prompt) in enumerate((
            (QWEN_MOE, Qwen2MoeForCausalLM, qwen2_moe_config, 128),
            ("mixtral-8x7b", MixtralForCausalLM, mixtral_config, 256))):
        cfg = config(name, num_hidden_layers=2)
        gpu = deepspeed_tpu_torch.init_inference(moe_model(cls, cfg, SEED + 50 + seed),
                                                 dtype="bf16")
        cpu_model = cls(config(name, num_hidden_layers=2, dtype=torch.float32), device="meta")
        cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                                   gpu.module.state_dict().items()}, assign=True)
        cpu = deepspeed_tpu_torch.init_inference(cpu_model, dtype="fp32", device="cpu")
        ids = torch.randint(0, cfg.vocab_size, (2, prompt),
                            generator=torch.Generator().manual_seed(SEED + 60 + seed))
        zero_launches()
        out, seen = generate_logits(gpu, ids, 8)
        launches = read_launches()
        assert launches["grouped_gemm"] == 3 * cfg.num_hidden_layers, launches
        seq = out[:, :-1]
        card_rec, cpu_rec = RoutingRecorder(gpu.module), RoutingRecorder(cpu.module)
        card = cached_prefill(gpu.module, seq)
        ref = cached_prefill(cpu.module, seq.cpu())
        flips = flip_share(card_rec.take(), cpu_rec.take())
        card_rec.remove()
        cpu_rec.remove()
        errs = dict(prefill_rel_rms_err=rel_err(seen[0], ref[:, prompt - 1]),
                    last_decode_step_rel_rms_err=rel_err(seen[-1], ref[:, -1]),
                    cached_prefill_rel_rms_err=rel_err(card, ref))
        control = rel_err(rolled_sizes_control(lambda: cached_prefill(gpu.module, seq)), ref)
        gate(f"reference_moe {name}", max(errs.values()), MOE_REFERENCE_RTOL[name], control,
             flips)
        rows[name] = dict(layers=2, prompt=prompt, **errs, routing_flip_share=flips,
                          rolled_sizes_control_rel_rms_err=control, launches=launches)
        # `serve_ep` holds its ep = 2 ranks to the same CPU logits
        EP_REFS[f"reference {name}"] = dict(seed=SEED + 50 + seed, ids=ids,
                                            tokens=out.cpu(), cpu_logits=ref)
        del gpu, cpu, cpu_model, card, ref
        gc.collect()
        torch.cuda.empty_cache()
    report["reference_moe"] = rows


def ep_references(cfg):
    """The ep = 1 references of `serve_ep` at `cfg`'s depth, from
    `serve_moe`'s seed and prompts: greedy `generate`'s tokens, its last
    decode step's logits and routing (as `serve_moe` takes them), and the
    tokens of decode with the grouped GEMM forced."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
    engine = deepspeed_tpu_torch.init_inference(moe_model(Qwen2MoeForCausalLM, cfg, SEED + 40),
                                                dtype="bf16")
    module = engine.module
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.generate(ids, max_new_tokens=2)                # warm-up
    recorder = RoutingRecorder(module)
    out, seen = generate_logits(engine, ids, NEW)
    refs = dict(tokens=out.cpu(), last=seen[-1].float().cpu(),
                routing=[r.cpu() for r in recorder.take()])
    recorder.remove()
    for layer in module.layers:
        layer.mlp.dispatch_impl = "gmm"
    refs["gmm_tokens"] = engine.generate(ids, max_new_tokens=NEW).cpu()
    del engine, module, seen
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def serve_ep(report):
    """Qwen1.5-MoE-A2.7B at full width and EP_LAYERS of its 24 layers served
    expert-parallel over
    ep = 2: two ranks (spawned processes) on the one card, joined by gloo,
    each holding the whole dense model and 30 of the 60 experts of every
    layer (`MeshTopology(ep=2)`, a module built with `ep_rank`). The phase's
    gates: equal greedy, sampled and gmm-decode tokens on both ranks; rank
    0's last decode step, teacher-forced on the ep = 1 references' tokens
    (`ep_references`, at the same depth), within
    MOE_CONSISTENCY_RTOL of theirs, beside the routing-flip share,
    and a control (rank 1 running its experts at rank 0's group offset)
    that must miss that bound; the launch counts of the main path (`forward`
    on B x 512 and greedy `generate` of 64: K8-e three times a layer in the
    prefill, the ragged buffer and K2 at decode) and of decode with the
    grouped GEMM forced; no kernel_fallback; then 2-layer Qwen1.5-MoE and
    Mixtral-8x7B-width models at ep = 2 on the card in bf16, teacher-forced
    on `reference_moe`'s tokens, against its CPU f32 logits at ep = 1."""
    import tempfile

    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config
    cpu_logits = {k: v.pop("cpu_logits") for k, v in EP_REFS.items() if "cpu_logits" in v}
    t0 = time.perf_counter()
    EP_REFS[QWEN_MOE] = ep_references(qwen2_moe_config(QWEN_MOE, num_hidden_layers=EP_LAYERS))
    references_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(EP_REFS, f"{tmp}/refs.pt")
        t0 = time.perf_counter()
        mp.start_processes(ep_rank, args=(free_port(), tmp), nprocs=EP, start_method="spawn")
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(EP)]
    r0, r1 = ranks
    L = EP_LAYERS
    for key in ("greedy", "sampled", "gmm_greedy", "reference_tokens"):
        assert r0[key] == r1[key], key
    gate("serve_ep last step vs ep = 1", r0["last_rel_rms_err"], MOE_CONSISTENCY_RTOL,
         r0["control_rel_rms_err"], r0["last_step_routing_flip_share"])
    for r in ranks:
        assert r["launches"] == only(flash_attention_fwd=L, decode_attention=L * (NEW - 1),
                                     grouped_gemm=3 * L, sharded_grouped_gemm=3 * L), \
            r["launches"]
        assert r["gmm_launches"] == only(
            grouped_gemm=3 * L * NEW, sharded_grouped_gemm=3 * L * NEW,
            decode_attention=L * (NEW - 1)), r["gmm_launches"]
        assert r["kernel_fallbacks"] == [], r["kernel_fallbacks"]
    rows = {}
    for name, got in r0.pop("reference").items():
        ref, prompt = cpu_logits[f"reference {name}"], got["prompt"]
        errs = dict(prefill_rel_rms_err=rel_err(got["prefill"], ref[:, prompt - 1]),
                    last_decode_step_rel_rms_err=rel_err(got["last"], ref[:, -1]),
                    cached_prefill_rel_rms_err=rel_err(got["cached"], ref))
        assert max(errs.values()) <= MOE_REFERENCE_RTOL[name], (name, errs)
        rows[name] = dict(layers=2, ep=EP, prompt=prompt, **errs, launches=got["launches"])
    report["reference_ep"] = rows
    drop = ("greedy", "sampled", "gmm_greedy", "reference_tokens", "reference")
    report["serve_ep"] = dict(
        card=report["card"],
        model=f"{QWEN_MOE} (random bf16 weights, seed {SEED + 40}) over ep={EP}",
        setup=f"{EP} ranks, one process each, sharing one card over gloo: the "
              "collectives stage through the host, so these times are not an "
              "expert-parallel speed", layers=EP_LAYERS, wall_s=wall_s,
        ep1_references_s=references_s,
        ranks=[{k: v for k, v in r.items() if k not in drop} for r in ranks])
    log(f"serve_ep: {EP} ranks sharing one card over gloo: " + "; ".join(
        f"rank {r['rank']}: decode {r['decode_tok_s']:.1f} tok/s, prefill "
        f"{r['generate_prefill_ms']:.0f} ms, last step {r['last_rel_rms_err']:.4f} from ep=1, "
        f"peak {r['peak_memory_bytes'] / 2**30:.2f} GiB" for r in ranks))
    return r0


def ep_rank(rank, port, tmp):
    """One rank of `serve_ep`: joins the gloo group, installs the ep = 2
    topology, builds its shard of Qwen1.5-MoE-A2.7B at EP_LAYERS layers from
    `serve_moe`'s seed (each expert stack drawn whole, as there, and cut)
    and serves it, then
    the 2-layer reference models' shards."""
    import datetime
    import logging

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils import groups
    from deepspeed_tpu_torch.utils.logging import logger
    comm.init_distributed(dist_backend="gloo", init_method=f"tcp://localhost:{port}",
                          rank=rank, world_size=EP,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    fallbacks = []
    handler = logging.Handler()
    handler.emit = lambda rec: fallbacks.append(rec.getMessage()) \
        if "kernel_fallback" in rec.getMessage() else None
    logger.addHandler(handler)
    try:
        from deepspeed_tpu_torch.accelerator import get_accelerator
        acc = get_accelerator()
        topo = groups.initialize(groups.MeshTopology(ep=EP, device=acc.device))
        refs = torch.load(f"{tmp}/refs.pt", weights_only=False)
        out = dict(rank=rank, device=str(acc.device), backend=comm.get_backend(),
                   topology=repr(topo))
        torch.cuda.reset_peak_memory_stats()
        out.update(ep_v1(rank, refs))
        gc.collect()
        torch.cuda.empty_cache()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["reference"], out["reference_tokens"] = ep_reference(rank, refs)
        out["kernel_fallbacks"] = fallbacks
        torch.save(out, f"{tmp}/rank{rank}.pt")
        comm.barrier()
    finally:
        logger.removeHandler(handler)
        comm.destroy_process_group()


def moe_shard(cls, cfg, seed, rank):
    """Rank `rank`'s expert shard of `moe_model(cls, cfg, seed)`: the same
    draws, each expert stack cut to the rank's experts."""
    from deepspeed_tpu_torch.models.llama import init_params
    model = cls(cfg, device="cuda", dtype=torch.bfloat16, ep_size=EP, ep_rank=rank)
    return init_params(model, torch.Generator(device="cuda").manual_seed(seed))


def ep_v1(rank, refs):
    """v1 at ep = 2: the main path (`forward` on B x 512, greedy `generate`
    of 64; counted), the last step teacher-forced on the ep = 1 references'
    tokens with its routing-flip share, the wrong-offset control, a sampled run,
    the collectives' and K8-e's times, and decode with the grouped GEMM
    forced (counted)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM, qwen2_moe_config
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    cfg = qwen2_moe_config(QWEN_MOE, num_hidden_layers=EP_LAYERS)
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(
        moe_shard(Qwen2MoeForCausalLM, cfg, SEED + 40, rank), dtype="bf16")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    module = engine.module
    assert engine.topology.ep_size == EP and module.ep_rank == rank
    weights = sum(p.numel() * p.element_size() for p in module.parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)     # serve_moe's prompts
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.forward(ids[:1, :16])                                     # warm-up
    engine.generate(ids, max_new_tokens=2)
    recorder = RoutingRecorder(module)

    # the main path: counted launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    logits = engine.forward(ids)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=NEW)
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    greedy_tok_s = engine.last_decode_tok_s
    assert logits.shape == (B, PROMPT, cfg.vocab_size) and torch.isfinite(logits).all()
    assert out.shape == (B, PROMPT + NEW) and torch.equal(out[:, :PROMPT], ids)
    del logits

    # the last step teacher-forced on the ep = 1 tokens, and the control:
    # rank 1 runs its experts at rank 0's offset (grouped and buffer routes)
    ref = refs[QWEN_MOE]
    force = ref["tokens"].cuda()
    _, seen = generate_logits(engine, ids, NEW, force=force)
    err = rel_err(seen[-1], ref["last"])
    flips = flip_share(recorder.take(), ref["routing"])
    recorder.remove()
    experts = [layer.mlp.experts for layer in module.layers]
    real_offset = gg.expert_offset
    if rank == 1:
        gg.expert_offset = lambda *args: 0
        for x in experts:
            x.first_expert = 0
    try:
        _, seen_c = generate_logits(engine, ids, NEW, force=force)
    finally:
        gg.expert_offset = real_offset
        for x in experts:
            x.first_expert = rank * x.up.shape[0]
    control = rel_err(seen_c[-1], ref["last"])
    del seen, seen_c

    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    sampled = engine.generate(ids, max_new_tokens=NEW, temperature=0.8, top_p=0.9,
                              seed=SEED + 2)
    times = ep_collective_ms(cfg, engine)

    # decode with the grouped GEMM forced (K8-e at M = B·k = 16 rows)
    for layer in module.layers:
        layer.mlp.dispatch_impl = "gmm"
    engine.generate(ids, max_new_tokens=2)                # warm-up
    zero_launches()
    t0 = time.perf_counter()
    gmm_out = engine.generate(ids, max_new_tokens=NEW)
    gmm_generate_ms = (time.perf_counter() - t0) * 1e3
    gmm_launches = read_launches()
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    gmm_prefill_ms = (time.perf_counter() - t0) * 1e3
    for layer in module.layers:
        layer.mlp.dispatch_impl = cfg.dispatch_impl
    del engine, module, experts
    return dict(
        layers=cfg.num_hidden_layers, local_experts=cfg.num_experts // EP,
        build_and_place_s=build_s, weights_at_rest_bytes=weights,
        generate_peak_memory_bytes=peak, forward_ms=forward_ms, generate_ms=generate_ms,
        generate_prefill_ms=prefill_ms,
        decode_tok_s=B * (NEW - 1) / ((generate_ms - prefill_ms) / 1e3),
        engine_last_decode_tok_s=greedy_tok_s, launches=launches,
        last_rel_rms_err=err, last_step_routing_flip_share=flips,
        control_rel_rms_err=control,
        greedy_equal_to_ep1_share=float((out.cpu() == ref["tokens"]).float().mean()),
        greedy=out.cpu().tolist(), sampled=sampled.cpu().tolist(), **times,
        gmm_decode=dict(generate_ms=gmm_generate_ms, generate_prefill_ms=gmm_prefill_ms,
                        decode_tok_s=B * (NEW - 1) / ((gmm_generate_ms - gmm_prefill_ms)
                                                      / 1e3),
                        greedy_equal_to_ep1_gmm_share=float(
                            (gmm_out.cpu() == ref["gmm_tokens"]).float().mean())),
        gmm_launches=gmm_launches, gmm_greedy=gmm_out.cpu().tolist())


def ep_collective_ms(cfg, engine, iters: int = 10):
    """Host ms, synchronised, of the gloo collectives of the expert-parallel
    path at its operand sizes: the all-reduce of the prefill's `down` output
    (B·PROMPT·k rows x hidden, bf16, once a layer), the all-reduce the JAX
    order would add after gate and up (x moe_intermediate), the all-gather
    of a decode step's expert slice (E/ep, B, hidden); and K8-e at the
    prefill's `down` call alone (CUDA events) and with its all-reduce (the
    whole call, host clock)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    m, d, f = B * PROMPT * cfg.num_experts_per_tok, cfg.hidden_size, cfg.moe_intermediate_size
    out = {}

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    for name, shape, op in (
            ("all_reduce_prefill_down", (m, d), comm.all_reduce),
            ("all_reduce_prefill_gate_up", (m, f), comm.all_reduce),
            ("all_gather_decode_experts", (cfg.num_experts // EP, B, d), comm.all_gather)):
        x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
        out[f"gloo_{name}_ms"] = host_ms(lambda: op(x, group="expert"))
        out[f"gloo_{name}_bytes"] = x.numel() * 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)   # the same on both ranks
    sizes = routing_sizes(gen, B * PROMPT, cfg.num_experts, cfg.num_experts_per_tok)
    lhs = randn((m, f), gen)
    down = engine.module.layers[0].mlp.experts.down.detach()
    topo = engine.topology
    with torch.inference_mode():
        out["k8e_prefill_down_kernel_ms"] = cuda_ms(
            lambda: gg.sharded_grouped_gemm(lhs, down, sizes, topo, reduce=False))
        out["k8e_prefill_down_call_ms"] = host_ms(
            lambda: gg.sharded_grouped_gemm(lhs, down, sizes, topo))
    return out


def ep_reference(rank, refs):
    """The 2-layer models of `reference_moe` at ep = 2 on the card, built
    from its seeds, teacher-forced on its tokens: the prefill's and last
    decode step's logits and a cached prefill of the sequence (rank 0
    keeps them), and the tokens."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_config
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM, qwen2_moe_config
    rows, tokens = {}, []
    for name, cls, config in ((QWEN_MOE, Qwen2MoeForCausalLM, qwen2_moe_config),
                              ("mixtral-8x7b", MixtralForCausalLM, mixtral_config)):
        ref = refs[f"reference {name}"]
        cfg = config(name, num_hidden_layers=2)
        engine = deepspeed_tpu_torch.init_inference(moe_shard(cls, cfg, ref["seed"], rank),
                                                    dtype="bf16")
        ids, force = ref["ids"].cuda(), ref["tokens"].cuda()
        zero_launches()
        out, seen = generate_logits(engine, ids, 8, force=force)
        launches = read_launches()
        assert launches["sharded_grouped_gemm"] == 3 * cfg.num_hidden_layers, launches
        card = cached_prefill(engine.module, force[:, :-1])
        tokens.append(out.cpu().tolist())
        if rank == 0:
            rows[name] = dict(prompt=ids.shape[1], prefill=seen[0].cpu(), last=seen[-1].cpu(),
                              cached=card.cpu(), launches=launches)
        del engine, seen, card
        gc.collect()
        torch.cuda.empty_cache()
    return rows, tokens


def reference_int8(report):
    """Two layers at full width with int8 weights through the layer scan:
    the card in bf16 (K5, K2) against the plain versions on the CPU in f32,
    on the same int8 bytes: the prefill logits and one decode step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.kv_cache import KVCache
    from deepspeed_tpu_torch.inference.quantized_layer_scan import make_scan_apply
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config, to_jax_params
    quant = dict(quant={"enabled": True, "group_size": 256}, serve_mode="layer_scan")
    cfg = llama_config("llama3-8b", num_hidden_layers=2)
    gpu = deepspeed_tpu_torch.init_inference(llama(cfg, SEED + 5), dtype="bf16", **quant)
    cpu_cfg = llama_config("llama3-8b", num_hidden_layers=2, dtype=torch.float32)
    cpu = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(cpu_cfg, device="meta"), params=to_jax_params(gpu.params),
        dtype="fp32", device="cpu", fused_int8=True, **quant)
    ids = torch.randint(0, cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(SEED + 6))
    errs = []
    with torch.inference_mode():
        steps = []
        for engine in (gpu, cpu):
            mcfg, device = engine.model_cfg, engine.device
            apply = make_scan_apply(mcfg, fused=True)
            cache = KVCache.create(2, 2, 128, mcfg.num_key_value_heads, mcfg.head_dim,
                                   dtype=mcfg.dtype, device=device)
            prefill, cache = apply(engine.params, ids.to(device), cache)
            cache = cache.replace(index=cache.index + ids.shape[1])
            tok = steps[0][0][:, -1].argmax(-1).to(device) if steps else \
                prefill[:, -1].argmax(-1)
            step, _ = apply(engine.params, tok[:, None], cache)
            steps.append((prefill, step))
        errs = [rel_err(steps[0][i], steps[1][i]) for i in range(2)]
    assert max(errs) <= REFERENCE_RTOL, errs
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    report["reference_int8"] = dict(prefill_rel_rms_err=errs[0],
                                    decode_step_rel_rms_err=errs[1])


def reference(report):
    """Two layers at full width: the card in bf16 against the plain
    versions on the CPU in f32, on the same weights, through v1 and v2."""
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
    report["reference"] = dict(forward_rel_rms_err=err_fwd,
                               prefill_rel_rms_err=err_prefill,
                               last_decode_step_rel_rms_err=err_step)
    report["reference_v2"] = reference_v2(gpu.module, cpu.module, ids.numpy())
    del gpu
    torch.cuda.empty_cache()


def reference_v2(gpu_model, cpu_model, ids, steps: int = 8):
    """v2 on the card in bf16 against v2 on the CPU in f32: the prefill
    logits of two prompts, then `steps` decode steps fed the card's greedy
    tokens, on the same 2-layer weights."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    kw = dict(max_batch=4, max_seq_len=512, cache_block_size=BS, num_cache_blocks=8,
              split_fuse_chunk=256)
    gpu = InferenceEngineV2(gpu_model, **kw)
    cpu = InferenceEngineV2(cpu_model, config={"dtype": "fp32"}, device="cpu", **kw)
    uids = list(range(len(ids)))
    g = gpu.put(uids, list(ids))
    c = cpu.put(uids, list(ids))
    err_prefill = max(rel_err(torch.from_numpy(g[u]), torch.from_numpy(c[u])) for u in uids)
    for _ in range(steps):
        feeds = [np.asarray([int(np.argmax(g[u]))]) for u in uids]
        g, c = gpu.put(uids, feeds), cpu.put(uids, feeds)
    err_step = max(rel_err(torch.from_numpy(g[u]), torch.from_numpy(c[u])) for u in uids)
    assert max(err_prefill, err_step) <= REFERENCE_RTOL, (err_prefill, err_step)
    layout = gpu.kv_layout
    del gpu, cpu
    return dict(prefill_rel_rms_err=err_prefill, last_decode_step_rel_rms_err=err_step,
                decode_steps=steps, kv_layout=layout)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def tp_references(cfg):
    """The tp = 1 references of `serve_tp` at `cfg`'s depth, from the seed
    of the tp = 1 phases: the v1 engine's greedy tokens and last-step logits
    (as `serve` takes them) and the int8 layer scan's (as `serve_int8`)."""
    import deepspeed_tpu_torch
    model = llama(cfg, SEED)
    ids = tp_prompts(cfg)
    refs = {}
    for key, kw in (("v1", {}), ("int8", dict(quant={"enabled": True, "group_size": 256},
                                              serve_mode="layer_scan"))):
        engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16", **kw)
        out, seen = generate_logits(engine, ids, NEW)
        refs[key] = (out.cpu(), seen[-1].float().cpu())
        del engine, seen                    # the layer scan released the weights
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def serve_tp(report):
    """Llama-3-8B at full width and TP_LAYERS of its layers served
    tensor-parallel over tp = 2: two ranks (spawned processes) on the one
    card, joined by gloo, each holding its shard (`tp_rank`). The phase's
    gates: equal tokens on both ranks; rank 0's last v1 decode step
    (teacher-forced on the tp = 1 engine's tokens) against the tp = 1
    engine's at the same depth (`tp_references`), and the same for the
    int8 layer scan, within CONSISTENCY_RTOL; a control (rank 1 serving
    rank 0's o_proj shard) that must miss that bound; v2 rows against v1
    `forward` at tp = 2; launch counts of every per-shard route; no
    kernel_fallback. Then `reference_tp`'s two layers against the CPU."""
    import tempfile

    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    cpu_ref = LlamaForCausalLM(llama_config("llama3-8b", num_hidden_layers=2,
                                            dtype=torch.float32), device="meta")
    cpu_ref.load_state_dict({k: v.float().cpu() for k, v in llama(
        llama_config("llama3-8b", num_hidden_layers=2), SEED + 7).state_dict().items()},
        assign=True)
    gc.collect()
    torch.cuda.empty_cache()
    refs = tp_references(llama_config("llama3-8b", num_hidden_layers=TP_LAYERS))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(refs, f"{tmp}/refs.pt")
        t0 = time.perf_counter()
        mp.start_processes(tp_rank, args=(free_port(), tmp), nprocs=TP, start_method="spawn")
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(TP)]
    r0, r1 = ranks
    L = TP_LAYERS
    for key in ("v1_greedy", "v1_sampled", "v2_outputs", "int8_greedy", "ref_tokens"):
        assert r0[key] == r1[key], key
    assert r0["v1_last_rel_rms_err"] <= CONSISTENCY_RTOL, r0["v1_last_rel_rms_err"]
    assert r0["v1_control_rel_rms_err"] > CONSISTENCY_RTOL, r0["v1_control_rel_rms_err"]
    assert r0["int8_last_rel_rms_err"] <= CONSISTENCY_RTOL, r0["int8_last_rel_rms_err"]
    assert max(r0["v2_last_step_vs_v1_forward_rel_rms_err"]) <= CONSISTENCY_RTOL
    for r in ranks:
        calls = r["v2_calls"]
        assert r["v1_launches"] == only(flash_attention_fwd=L, decode_attention=L * (NEW - 1),
                                        sharded_decode_attention=L * (NEW - 1)), r["v1_launches"]
        assert r["v2_launches"] == only(
            paged_decode_attention=L * calls["decode_steps"],
            sharded_paged_decode_attention=L * calls["decode_steps"],
            paged_prefill_attention=L * calls["chunk_calls"],
            sharded_paged_prefill_attention=L * calls["chunk_calls"]), r["v2_launches"]
        assert r["int8_launches"] == only(
            quantized_matmul=7 * L * NEW, sharded_quantized_matmul_n=5 * L * NEW,
            sharded_quantized_matmul_k=2 * L * NEW, decode_attention=L * (NEW - 1),
            sharded_decode_attention=L * (NEW - 1)), r["int8_launches"]
        assert r["kernel_fallbacks"] == [], r["kernel_fallbacks"]
    report["reference_tp"] = reference_tp(cpu_ref, r0)
    del cpu_ref
    gc.collect()
    drop = ("v1_greedy", "v1_sampled", "v2_outputs", "int8_greedy", "ref_tokens",
            "ref_logits")
    report["serve_tp"] = dict(
        card=report["card"],
        model=f"llama3-8b (random bf16 weights, seed 0), {TP_LAYERS} of 32 layers, over tp=2",
        setup=f"{TP} ranks, one process each, sharing one card over gloo: the "
              "collectives stage through the host, so these times are not a "
              "tensor-parallel speed", wall_s=wall_s,
        ranks=[{k: v for k, v in r.items() if k not in drop} for r in ranks])
    log(f"serve_tp: {TP} ranks sharing one card over gloo: " + "; ".join(
        f"rank {r['rank']} on {r['device']} ({r['backend']}): v1 {r['v1_decode_tok_s']:.1f} "
        f"tok/s, v2 {r['v2']['tok_s']:.1f} tok/s, int8 {r['int8_decode_tok_s']:.1f} tok/s, "
        f"peak {r['peak_memory_bytes'] / 2**30:.2f} GiB" for r in ranks))
    return r0


def tp_rank(rank, port, tmp):
    """One rank of `serve_tp`: joins the gloo group, builds its shard of
    Llama-3-8B at TP_LAYERS layers from the seed of the tp = 1 phases (each
    weight drawn whole, as `tp_references`' model draws it, and cut), and
    serves it through v1, v2 and the int8 layer scan, then the 2-layer
    reference model."""
    import datetime
    import logging

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils.logging import logger
    comm.init_distributed(dist_backend="gloo", init_method=f"tcp://localhost:{port}",
                          rank=rank, world_size=TP,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    fallbacks = []
    handler = logging.Handler()
    handler.emit = lambda rec: fallbacks.append(rec.getMessage()) \
        if "kernel_fallback" in rec.getMessage() else None
    logger.addHandler(handler)
    try:
        from deepspeed_tpu_torch.accelerator import get_accelerator
        from deepspeed_tpu_torch.models.llama import llama_config
        refs = torch.load(f"{tmp}/refs.pt", weights_only=False)
        acc = get_accelerator()
        out = dict(rank=rank, device=str(acc.device), backend=comm.get_backend())
        torch.cuda.reset_peak_memory_stats()
        model = llama_shard(llama_config("llama3-8b", num_hidden_layers=TP_LAYERS), SEED, rank)
        out.update(tp_v1(model, refs, rank))
        out.update(tp_v2(model))
        out.update(tp_int8(model, refs))       # releases the model's weights
        del model
        gc.collect()
        torch.cuda.empty_cache()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out.update(tp_reference(rank))
        out["kernel_fallbacks"] = fallbacks
        torch.save(out, f"{tmp}/rank{rank}.pt")
        comm.barrier()
    finally:
        logger.removeHandler(handler)
        comm.destroy_process_group()


def llama_shard(cfg, seed, rank):
    """Rank `rank`'s shard of `llama(cfg, seed)`: the same draws, cut."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, init_params
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, tp_size=TP,
                             tp_rank=rank)
    return init_params(model, torch.Generator(device="cuda").manual_seed(seed))


def tp_prompts(cfg):
    """`serve`'s prompts, from the same seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")


def tp_v1(model, refs, rank):
    """v1 at tp = 2: `forward` on 4 x 512 and greedy `generate` of 64 (K1-fwd
    and K8-a counted), the last step teacher-forced on the tp = 1 tokens,
    a control with rank 0's o_proj shard on rank 1, and a sampled run."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16",
                                                tensor_parallel={"tp_size": TP})
    cfg = model.cfg
    ids = tp_prompts(cfg)
    engine.forward(ids)                                  # warm-up
    engine.generate(ids[:1, :16], max_new_tokens=2)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    logits = engine.forward(ids)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=NEW)
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    assert logits.shape == (B, PROMPT, cfg.vocab_size) and torch.isfinite(logits).all()
    del logits
    ref_tokens, ref_last = refs["v1"]
    _, seen = generate_logits(engine, ids, NEW, force=ref_tokens.cuda())
    err = rel_err(seen[-1], ref_last)
    # control: rank 1 serves rank 0's o_proj shard
    own = [layer.self_attn.o_proj.weight.detach().clone() for layer in model.layers]
    for layer in model.layers:
        comm.broadcast(layer.self_attn.o_proj.weight.data, src=0)
    _, seen_c = generate_logits(engine, ids, NEW, force=ref_tokens.cuda())
    control = rel_err(seen_c[-1], ref_last)
    for layer, w in zip(model.layers, own):
        layer.self_attn.o_proj.weight.data.copy_(w)
    del own, seen, seen_c
    sampled = engine.generate(ids, max_new_tokens=NEW, temperature=0.8, top_p=0.9,
                              seed=SEED + 2)
    return dict(v1_forward_ms=forward_ms, v1_generate_ms=generate_ms,
                **collective_ms(cfg),
                v1_decode_tok_s=engine.last_decode_tok_s, v1_launches=launches,
                v1_greedy=out.cpu().tolist(), v1_sampled=sampled.cpu().tolist(),
                v1_greedy_equals_tp1=bool(torch.equal(out.cpu(), ref_tokens)),
                v1_last_rel_rms_err=err, v1_control_rel_rms_err=control)


def collective_ms(cfg, iters: int = 20):
    """Host ms of one gloo collective of a decode step, synchronised: the
    all-reduce of a row-parallel output (B, 1, hidden) and the gather of
    the head's logits (B, V/tp), both bf16 on the card."""
    from deepspeed_tpu_torch import comm
    out = {}
    for name, shape, op in (("all_reduce", (B, 1, cfg.hidden_size), comm.all_reduce),
                            ("all_gather_logits", (B, cfg.vocab_size // TP),
                             lambda t: comm.all_gather(t, axis=-1))):
        x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
        op(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            op(x)
        torch.cuda.synchronize()
        out[f"gloo_{name}_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def tp_v2(model):
    """v2 at tp = 2: traffic A on the head-sharded paged pool (K8-b and
    K8-c counted), four rows' last decode step against v1 `forward`."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    rng = np.random.default_rng(SEED + 10)
    engine = v2_engine(model, config=DeepSpeedInferenceConfig(
        dtype="bf16", tensor_parallel={"tp_size": TP}))
    out, stats, launches, calls, last = traffic_a(engine, rng)
    del engine
    torch.cuda.empty_cache()
    v1 = deepspeed_tpu_torch.init_inference(model, dtype="bf16",
                                            tensor_parallel={"tp_size": TP})
    full = v1.forward([out[u][:-1] for u in WATCH])[:, -1]
    errs = [rel_err(last[u], full[i]) for i, u in enumerate(WATCH)]
    assert all(int(last[u].float().argmax()) == out[u][-1] for u in WATCH)
    return dict(v2=stats, v2_launches=launches, v2_calls=calls, v2_outputs=out,
                v2_last_step_vs_v1_forward_rel_rms_err=errs)


def tp_int8(model, refs):
    """int8 weights through the layer scan at tp = 2 (K8-d 'n' and 'k'
    counted): greedy `generate`, the last step teacher-forced on the tp = 1
    int8 engine's tokens. Each rank quantizes its own shard; blocks of 256
    lie inside every shard's rows, so its bytes are the cut of the whole
    tree's (`serve_modes.place_params` checks that)."""
    import deepspeed_tpu_torch
    quant = {"enabled": True, "group_size": 256}
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16", quant=quant,
                                                serve_mode="layer_scan",
                                                tensor_parallel={"tp_size": TP})
    assert engine.serve_mode == "layer_scan" and engine._use_fused_int8()
    ids = tp_prompts(model.cfg)
    engine.generate(ids[:1, :16], max_new_tokens=2)      # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=NEW)
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    ref_tokens, ref_last = refs["int8"]
    _, seen = generate_logits(engine, ids, NEW, force=ref_tokens.cuda())
    err = rel_err(seen[-1], ref_last)
    tok_s = engine.last_decode_tok_s
    del engine
    return dict(int8_generate_ms=generate_ms, int8_decode_tok_s=tok_s,
                int8_launches=launches, int8_greedy=out.cpu().tolist(),
                int8_greedy_equals_tp1=bool(torch.equal(out.cpu(), ref_tokens)),
                int8_last_rel_rms_err=err)


def tp_reference(rank):
    """The 2-layer model of `reference_tp` at tp = 2 on the card: `forward`
    logits and a greedy `generate` of 8 with its prefill and last decode
    step's logits (rank 0 keeps them)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_config
    model = llama_shard(llama_config("llama3-8b", num_hidden_layers=2), SEED + 7, rank)
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16",
                                                tensor_parallel={"tp_size": TP})
    ids = torch.randint(0, model.cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(SEED + 8))
    logits = engine.forward(ids)
    out, seen = generate_logits(engine, ids.cuda(), 8)
    keep = dict(ref_tokens=out.cpu().tolist())
    if rank == 0:
        keep["ref_logits"] = (logits.cpu(), seen[0].cpu(), seen[-1].cpu())
    return keep


def reference_tp(cpu_model, r0):
    """The card at tp = 2 in bf16 against the plain versions on the CPU in
    f32 at tp = 1, on the same 2-layer weights: `forward`, and the prefill
    and last decode step of a greedy `generate` against the CPU's `forward`
    on the tokens the card generated."""
    import deepspeed_tpu_torch
    cpu = deepspeed_tpu_torch.init_inference(cpu_model, dtype="fp32", device="cpu")
    ids = torch.randint(0, cpu_model.cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(SEED + 8))
    logits, first, last = r0["ref_logits"]
    err_fwd = rel_err(logits, cpu.forward(ids))
    ref = cpu.forward(torch.tensor(r0["ref_tokens"])[:, :-1])
    err_prefill = rel_err(first, ref[:, ids.shape[1] - 1])
    err_step = rel_err(last, ref[:, -1])
    assert max(err_fwd, err_prefill, err_step) <= REFERENCE_RTOL, \
        (err_fwd, err_prefill, err_step)
    return dict(tp=TP, forward_rel_rms_err=err_fwd, prefill_rel_rms_err=err_prefill,
                last_decode_step_rel_rms_err=err_step)


def bloom(name, seed, **overrides):
    """A BLOOM preset on the card with random bf16 weights from `seed`."""
    from deepspeed_tpu_torch.models.bloom import bloom_config, init_bloom
    return init_bloom(bloom_config(name, **overrides),
                      torch.Generator(device="cuda").manual_seed(seed), device="cuda",
                      dtype=torch.bfloat16)


def serve_bloom(report):
    """bloom-7b1 at full width and depth, random bf16 weights. v1: `forward`
    on 4 x 512 and greedy `generate` of 64 on the masked alibi path (no
    kernel launches), the last decode step against `forward`. v2 with the
    automatic layout (paged): traffic A, whose K3-alibi and K4-alibi
    launches are counted (the Bloom v2 main path), four rows' last decode
    step against v1 `forward`, and a decode-step profile."""
    import deepspeed_tpu_torch
    model = bloom(BLOOM, SEED + 30)
    cfg = model.cfg
    L = cfg.num_hidden_layers
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.forward(ids[:, :64])                          # warm-up
    engine.generate(ids[:1, :16], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    logits = engine.forward(ids)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out, steps = generate_logits(engine, ids, NEW)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    v1_launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    assert v1_launches == only(), v1_launches          # BLOOM's v1 path runs no kernel
    assert logits.shape == (B, PROMPT, cfg.vocab_size) and torch.isfinite(logits).all()
    assert out.shape == (B, PROMPT + NEW) and torch.equal(out[:, :PROMPT], ids)
    full = engine.forward(out[:, :-1])[:, -1]
    consistency = rel_err(steps[-1], full)
    assert torch.isfinite(steps[-1]).all() and consistency <= BLOOM_CONSISTENCY_RTOL, consistency
    assert torch.equal(steps[-1].float().argmax(-1), out[:, -1])
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del logits, full, steps
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 32)
    v2 = v2_engine(model)
    assert v2.kv_layout == "paged", v2.kv_layout
    out2, stats, launches, calls, last = traffic_a(v2, rng)
    assert launches == only(paged_decode_attention_alibi=L * calls["decode_steps"],
                            paged_prefill_attention_alibi=L * calls["chunk_calls"]), \
        (launches, calls)
    full = engine.forward([out2[u][:-1] for u in WATCH])[:, -1]
    errs = [rel_err(last[u], full[i]) for i, u in enumerate(WATCH)]
    assert all(int(last[u].float().argmax()) == out2[u][-1] for u in WATCH)
    assert max(errs) <= BLOOM_CONSISTENCY_RTOL, errs
    del full
    report["bloom_v2_decode_profile"] = profile_v2_decode(v2, rng)
    del v2, engine, model
    gc.collect()
    torch.cuda.empty_cache()
    report["serve_bloom"] = dict(
        card=report["card"], model=f"{BLOOM} (random bf16 weights, seed {SEED + 30})",
        v1=dict(batch=B, prompt=PROMPT, new_tokens=NEW, forward_ms=forward_ms,
                generate_ms=generate_ms, generate_prefill_ms=prefill_ms,
                decode_tok_s=B * (NEW - 1) / ((generate_ms - prefill_ms) / 1e3),
                peak_memory_bytes=peak, launches=v1_launches,
                last_step_vs_forward_rel_rms_err=consistency),
        v2=dict(engine=dict(V2), kv_layout="paged", **stats,
                last_step_vs_v1_forward_rel_rms_err=errs))
    return launches


def forced_logits(engine, prompts, feeds):
    """`put` every prompt (its chunks drained), then one decode feed per
    step from `feeds` (uid → tokens): the f32 logits of the prefill and of
    each step, per uid. Rows are flushed after."""
    uids = list(range(len(prompts)))
    got = engine.put(uids, [np.asarray(p) for p in prompts])
    while len(got) < len(uids):
        got.update(engine.put([], []))
    out = [got]
    for i in range(len(feeds[0])):
        out.append(engine.put(uids, [np.asarray([feeds[u][i]]) for u in uids]))
    for u in uids:
        engine.flush(u)
    return out


def serve_bloom_slot(report):
    """bloom-560m at full depth (24 layers, 1024 wide, 16 heads of 64)
    through v2. The automatic layout is slot (head dim 64): a short
    traffic with prompts of up to three chunks, no kernel launched, four
    rows' last decode step against v1 `forward`. The same traffic forced
    onto the paged layout launches K3-alibi and K4-alibi at D = 64 (counted);
    then teacher-forced prefill and decode logits of the WATCH_SLOT prompts on
    the two layouts are held against each other."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    model = bloom(BLOOM_SLOT, SEED + 33)
    cfg = model.cfg
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 34)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SLOT_PROMPTS]
    runs, engines = {}, {}
    for layout in (None, "paged"):
        eng = InferenceEngineV2(model, kv_layout=layout, **SLOT_V2)
        calls, last = instrument(eng, WATCH_SLOT)
        eng.generate(prompts[:1], max_new_tokens=2)     # warm-up
        torch.cuda.synchronize()
        zero_launches()
        calls.update(decode_steps=0, chunk_calls=0)
        last.clear()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=SLOT_NEW)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        assert all(len(o) == len(p) + SLOT_NEW and o[:len(p)] == p for o, p in zip(out, prompts))
        runs[eng.kv_layout] = dict(out=out, launches=read_launches(), calls=dict(calls),
                                   last=dict(last), wall_s=wall_s,
                                   tok_s=len(prompts) * SLOT_NEW / wall_s)
        engines[eng.kv_layout] = eng
    slot, paged = runs["slot"], runs["paged"]
    assert slot["launches"] == only(), slot["launches"]
    assert paged["launches"] == only(
        paged_decode_attention_alibi=L * paged["calls"]["decode_steps"],
        paged_prefill_attention_alibi=L * paged["calls"]["chunk_calls"]), paged
    v1 = deepspeed_tpu_torch.init_inference(model, dtype="bf16")
    errs = {}
    for name, run in runs.items():
        errs[name] = [rel_err(run["last"][u], v1.forward([run["out"][u][:-1]])[0, -1])
                      for u in WATCH_SLOT]
        assert max(errs[name]) <= BLOOM_CONSISTENCY_RTOL, (name, errs[name])
    del v1
    # teacher forcing: the WATCH_SLOT prompts and the slot run's tokens on both layouts
    watch = [prompts[u] for u in WATCH_SLOT]
    feeds = [slot["out"][u][len(prompts[u]):len(prompts[u]) + 8] for u in WATCH_SLOT]
    forced = {name: forced_logits(eng, watch, feeds) for name, eng in engines.items()}
    layout_err = max(rel_err(torch.from_numpy(a[u]), torch.from_numpy(b[u]))
                     for a, b in zip(forced["slot"], forced["paged"]) for u in a)
    assert layout_err <= BLOOM_CONSISTENCY_RTOL, layout_err
    same = sum(a == b for a, b in zip(slot["out"], paged["out"]))
    del engines, model
    gc.collect()
    torch.cuda.empty_cache()
    report["serve_bloom_slot"] = dict(
        model=f"{BLOOM_SLOT} (random bf16 weights, seed {SEED + 33})", engine=dict(SLOT_V2),
        prompt_tokens=list(SLOT_PROMPTS), new_tokens=SLOT_NEW,
        **{name: {k: run[k] for k in ("launches", "calls", "wall_s", "tok_s")}
           for name, run in runs.items()},
        last_step_vs_v1_forward_rel_rms_err=errs,
        forced_slot_vs_paged_rel_rms_err=layout_err, forced_steps=8,
        sequences_equal_across_layouts=f"{same}/{len(prompts)}")


def reference_bloom(report):
    """Two layers at bloom-7b1 width: the card in bf16 against the plain
    versions on the CPU in f32, on the same weights, through v1 (the masked
    alibi path) and through v2 paged (K3-alibi and K4-alibi against their
    plain versions inside the model)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bloom import BloomForCausalLM, bloom_config
    gpu = deepspeed_tpu_torch.init_inference(bloom(BLOOM, SEED + 35, num_hidden_layers=2),
                                             dtype="bf16")
    cpu_model = BloomForCausalLM(bloom_config(BLOOM, num_hidden_layers=2, dtype=torch.float32),
                                 device="meta")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                               gpu.module.state_dict().items()}, assign=True)
    cpu = deepspeed_tpu_torch.init_inference(cpu_model, dtype="fp32", device="cpu")
    ids = torch.randint(0, gpu.model_cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(SEED + 36))
    err_fwd = rel_err(gpu.forward(ids), cpu.forward(ids))
    out, steps = generate_logits(gpu, ids.cuda(), 8)
    ref = cpu.forward(out[:, :-1].cpu())
    err_prefill = rel_err(steps[0], ref[:, ids.shape[1] - 1])
    err_step = rel_err(steps[-1], ref[:, -1])
    assert max(err_fwd, err_prefill, err_step) <= REFERENCE_RTOL, \
        (err_fwd, err_prefill, err_step)
    zero_launches()
    v2 = reference_v2(gpu.module, cpu.module, ids.numpy())
    launches = read_launches()
    assert v2["kv_layout"] == "paged" and launches["paged_decode_attention_alibi"] > 0 \
        and launches["paged_prefill_attention_alibi"] > 0, (v2, launches)
    report["reference_bloom"] = dict(
        forward_rel_rms_err=err_fwd, prefill_rel_rms_err=err_prefill,
        last_decode_step_rel_rms_err=err_step, v2=v2)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def zoo_model(family, name, seed, dtype=torch.bfloat16, device="cuda", **overrides):
    """A zoo preset (`models/phi.py`, `models/gptneox.py`, `models/bloom.py`)
    with random weights from `seed`, built on `device` in `dtype`."""
    import importlib
    mod = importlib.import_module(f"deepspeed_tpu_torch.models.{family}")
    cfg = getattr(mod, f"{family}_config")(name, **overrides)
    return getattr(mod, f"init_{family}")(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device, dtype=dtype)


def serve_zoo(report):
    """phi-2 and pythia-1b at full width and depth (`ZOO`), random bf16
    weights, through v1, v2 on the paged pool and an int8 KV cache
    (`zoo_serve`), then a 2-layer model of each width against the CPU in
    f32 (`zoo_reference`). Returns each model's launches by run."""
    rows, launches = {}, {}
    for family, name, seed, _ in ZOO:
        rows[name], launches[name] = zoo_serve(report, family, name, seed)
        rows[name]["reference"] = zoo_reference(family, name, seed + 5)
    report["serve_zoo"] = rows
    return launches


def zoo_serve(report, family, name, seed):
    """One zoo model. v1: `forward` on B x PROMPT and greedy `generate` of
    NEW (K1-fwd at `forward`, K2 at every decode step; counted), the last
    decode step against `forward` on the generated sequence within
    CONSISTENCY_RTOL, beside a control (another row's `forward`) that must
    miss. v2 with the automatic layout (paged): traffic A (K4 and K3
    counted), four rows' last step against v1 `forward`, beside the same
    control. An int8 KV cache (`zoo_int8`)."""
    import deepspeed_tpu_torch
    model = zoo_model(family, name, seed)
    cfg = model.cfg
    L = cfg.num_hidden_layers
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")
    engine.forward(ids[:, :64])                          # warm-up
    engine.generate(ids[:1, :16], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    logits = engine.forward(ids)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out, seen = generate_logits(engine, ids, NEW)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    v1_launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # `forward` runs K1-fwd; the cached prefill takes the masked path, and
    # every decode step K2
    assert v1_launches == only(flash_attention_fwd=L, decode_attention=L * (NEW - 1)), \
        v1_launches
    assert logits.shape == (B, PROMPT, cfg.vocab_size) and torch.isfinite(logits).all()
    assert out.shape == (B, PROMPT + NEW) and torch.equal(out[:, :PROMPT], ids)
    del logits
    step = seen[-1]
    full = engine.forward(out[:, :-1])[:, -1]
    consistency = rel_err(step, full)
    control = rel_err(step, full.roll(1, 0))
    assert torch.isfinite(step).all() and consistency <= CONSISTENCY_RTOL < control, \
        (name, consistency, control)
    assert torch.equal(step.float().argmax(-1), out[:, -1])
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del full, seen, step
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 2)
    v2 = v2_engine(model)
    assert v2.kv_layout == "paged", v2.kv_layout
    out2, stats, v2_launches, calls, last = traffic_a(v2, rng)
    assert v2_launches == only(paged_decode_attention=L * calls["decode_steps"],
                               paged_prefill_attention=L * calls["chunk_calls"]), \
        (v2_launches, calls)
    full = engine.forward([out2[u][:-1] for u in WATCH])[:, -1]
    errs = [rel_err(last[u], full[i]) for i, u in enumerate(WATCH)]
    controls = [rel_err(last[u], full[(i + 1) % len(WATCH)]) for i, u in enumerate(WATCH)]
    assert all(int(last[u].float().argmax()) == out2[u][-1] for u in WATCH)
    assert max(errs) <= CONSISTENCY_RTOL < min(controls), (name, errs, controls)
    del v2, full
    gc.collect()
    torch.cuda.empty_cache()
    int8, int8_launches = zoo_int8(engine, model, ids, rng)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    row = dict(
        card=report["card"], model=f"{name} (random bf16 weights, seed {seed})",
        layers=L, heads=cfg.num_attention_heads, head_dim=cfg.head_dim,
        rotary_dim=cfg.rotary_dim, weights_bytes=weights,
        v1=dict(batch=B, prompt=PROMPT, new_tokens=NEW, forward_ms=forward_ms,
                generate_ms=generate_ms, generate_prefill_ms=prefill_ms,
                decode_tok_s=B * (NEW - 1) / ((generate_ms - prefill_ms) / 1e3),
                peak_memory_bytes=peak, launches=v1_launches,
                last_step_vs_forward_rel_rms_err=consistency,
                other_row_control_rel_rms_err=control),
        v2=dict(engine=dict(V2), kv_layout="paged", **stats,
                last_step_vs_v1_forward_rel_rms_err=errs,
                other_row_control_rel_rms_err=controls),
        kv_int8=int8)
    return row, dict(v1=v1_launches, v2=v2_launches, **int8_launches)


def zoo_int8(bf16_engine, model, ids, rng):
    """The zoo model with its KV cache int8 at rest. v1: greedy `generate`
    of ZOO_INT8_NEW (K2-int8 counted), the last step against the bf16-KV
    engine's `generate` forced through the same tokens within INT8_KV_RTOL,
    beside a control whose int8 writes carry doubled scales; v2 over int8
    pools: ZOO_INT8_PROMPTS prompts of traffic A's length and ZOO_INT8_NEW greedy
    tokens (K4-int8 and K3-int8 counted)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import kv_cache
    cfg = model.cfg
    L, new = cfg.num_hidden_layers, ZOO_INT8_NEW
    engine = deepspeed_tpu_torch.init_inference(model, dtype="bf16", kv_cache_dtype="int8")
    engine.generate(ids[:1, :16], max_new_tokens=2)      # warm-up
    torch.cuda.synchronize()
    zero_launches()
    out, seen = generate_logits(engine, ids, new)
    v1_launches = read_launches()
    assert v1_launches == only(decode_attention_int8=L * (new - 1)), v1_launches
    bf16_kv = generate_logits(bf16_engine, ids, new, force=out)[1][-1]
    err = rel_err(seen[-1], bf16_kv)
    assert torch.isfinite(seen[-1]).all() and err <= INT8_KV_RTOL, err
    quantize = kv_cache.quantize_kv_tokens
    kv_cache.quantize_kv_tokens = lambda x: (lambda q, s: (q, 2.0 * s))(*quantize(x))
    try:
        control = rel_err(generate_logits(engine, ids, new, force=out)[1][-1], bf16_kv)
    finally:
        kv_cache.quantize_kv_tokens = quantize
    assert control > INT8_KV_RTOL, control
    del engine, seen, bf16_kv
    v2 = v2_engine(model, kv_cache_dtype="int8")
    calls, _ = instrument(v2)
    plen = TRAFFIC_A[1]
    prompts = rng.integers(0, cfg.vocab_size, (ZOO_INT8_PROMPTS, plen)).tolist()
    v2.generate(prompts[:1], max_new_tokens=2)           # warm-up
    torch.cuda.synchronize()
    zero_launches()
    calls.update(decode_steps=0, chunk_calls=0)
    out2 = v2.generate(prompts, max_new_tokens=new)
    v2_launches = read_launches()
    assert all(len(o) == plen + new and o[:plen] == p for o, p in zip(out2, prompts))
    assert v2_launches == only(paged_decode_attention_int8=L * calls["decode_steps"],
                               paged_prefill_attention_int8=L * calls["chunk_calls"]), \
        (v2_launches, calls)
    del v2
    return (dict(new_tokens=new, v1_last_step_vs_bf16_kv_rel_rms_err=err,
                 doubled_scales_control_rel_rms_err=control, v1_launches=v1_launches,
                 v2_prompts=ZOO_INT8_PROMPTS, v2_calls=dict(calls), v2_launches=v2_launches),
            dict(v1_int8=v1_launches, v2_int8=v2_launches))


def zoo_reference(family, name, seed):
    """Two layers at the model's width: the card in bf16 (K1-fwd, K2, and
    K4 and K3 through v2) against the plain versions on the CPU in f32, on
    the same weights: `forward`, the prefill and last decode step of a
    greedy `generate`, and v2 paged (`reference_v2`)."""
    import deepspeed_tpu_torch
    gpu = deepspeed_tpu_torch.init_inference(zoo_model(family, name, seed, num_hidden_layers=2),
                                             dtype="bf16")
    cpu_model = type(gpu.module)(dataclasses.replace(gpu.model_cfg, dtype=torch.float32),
                                 device="meta")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in
                               gpu.module.state_dict().items()}, assign=True)
    cpu = deepspeed_tpu_torch.init_inference(cpu_model, dtype="fp32", device="cpu")
    ids = torch.randint(0, gpu.model_cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(seed + 1))
    err_fwd = rel_err(gpu.forward(ids), cpu.forward(ids))
    out, steps = generate_logits(gpu, ids.cuda(), 8)
    ref = cpu.forward(out[:, :-1].cpu())
    err_prefill = rel_err(steps[0], ref[:, ids.shape[1] - 1])
    err_step = rel_err(steps[-1], ref[:, -1])
    assert max(err_fwd, err_prefill, err_step) <= REFERENCE_RTOL, \
        (name, err_fwd, err_prefill, err_step)
    zero_launches()
    v2 = reference_v2(gpu.module, cpu.module, ids.numpy())
    launches = read_launches()
    assert v2["kv_layout"] == "paged" and launches["paged_decode_attention"] > 0 \
        and launches["paged_prefill_attention"] > 0, (v2, launches)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=2, forward_rel_rms_err=err_fwd, prefill_rel_rms_err=err_prefill,
                last_decode_step_rel_rms_err=err_step, v2=v2)


def train(report):
    """The training main path: llama-1b at full width and depth, random
    bf16 weights, one warm-up and TRAIN_STEPS timed `train_batch` calls on
    one fixed batch; launches counted over the timed calls. Returns them
    and the engine, which `train_checkpoint` saves."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_config, llama_loss_fn
    cfg = llama_config("llama-1b", remat=True, remat_policy="nothing")
    gc.collect()   # the serving phases' instrumented engines hold reference cycles
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    model = llama(cfg, SEED + 30)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG,
                                                loss_fn=llama_loss_fn(model))
    acc = engine.accelerator
    batch = {"input_ids": train_rows(cfg)}
    t0 = time.perf_counter()
    loss = engine.train_batch(batch=batch)               # warm-up
    TRAIN_REFS.update(loss=float(loss), grad_norm=engine.get_global_grad_norm())
    acc.synchronize()
    warmup_s = time.perf_counter() - t0

    # the main path: counted launches
    acc.reset_peak_memory_stats()
    zero_launches()
    steps = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ts = time.perf_counter()
        loss = float(engine.train_batch(batch=batch))
        steps.append(dict(loss=loss, grad_norm=engine.get_global_grad_norm(),
                          step_s=time.perf_counter() - ts))
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak = acc.max_memory_allocated()
    L = cfg.num_hidden_layers
    per_step = {"flash_attention_fwd": 2 * L * GAS,     # remat runs each forward again
                "flash_attention_bwd_dq": L * GAS, "flash_attention_bwd_dkv": L * GAS}
    assert launches == only(**{k: n * TRAIN_STEPS for k, n in per_step.items()}), launches
    losses = [s["loss"] for s in steps]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    tokens = GAS * MBS * SEQ
    step_s = wall_s / TRAIN_STEPS
    n_params = engine.total_params
    flops_per_token = 6.0 * n_params + 6.0 * L * cfg.hidden_size * SEQ
    peak_tflops = acc.peak_tflops("bfloat16")
    mfu = tokens / step_s * flops_per_token / (peak_tflops * 1e12)
    report["train_profile"] = profile_train(engine, batch)
    del model
    report["train"] = dict(
        card=report["card"], model="llama-1b (TinyLlama-1.1B shapes, random bf16 weights, "
                                   f"seed {SEED + 30})",
        params=n_params, config=TRAIN_CONFIG, seq=SEQ,
        tokens_per_step=tokens, warmup_s=warmup_s, steps=steps, step_s=step_s,
        tokens_per_s=tokens / step_s, flops_per_token=flops_per_token,
        peak_tflops_datasheet=peak_tflops, mfu=mfu, peak_memory_bytes=peak,
        allocated_before_bytes=allocated_before,
        launches=launches, launches_per_train_batch=per_step)
    return launches, engine


def train_rows(cfg):
    """The training phases' fixed batch: GAS x MBS rows of SEQ tokens."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    return torch.randint(0, cfg.vocab_size, (GAS * MBS, SEQ), generator=gen, device="cuda")


def rank_rows(rows, rank):
    """Data rank `rank`'s rows of a global batch of GAS micros: of each
    micro, rows [rank * ZERO_MBS, (rank + 1) * ZERO_MBS), as the JAX
    engine's `data`-sharded batch gives them."""
    micros = rows.reshape(GAS, DP, ZERO_MBS, -1)
    return micros[:, rank].reshape(GAS * ZERO_MBS, -1)


def train_zero(report):
    """llama-1b at full width and depth trained over dp = 2 under ZeRO
    stages 0-3: two ranks (spawned processes) on the one card, joined by
    gloo (module docstring, 9e). Then, in this process, the stage-3 save
    resumed at dp = 1 (`zero_checkpoint`) and the control: one rank on rank
    0's rows alone, whose first-step grad norm must miss
    TRAIN_REF_NORM_RTOL."""
    import tempfile

    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    cfg = zero_model_config()
    checkpoint_dir(f"train_zero_s{ZERO_SAVE_STAGE}", model_state_bytes(cfg))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(zero_rank, args=(free_port(), tmp), nprocs=DP, start_method="spawn")
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(DP)]
    ZERO_RANKS[:] = ranks            # `train_zeropp` reads the ZeRO++ runs
    L = cfg.num_hidden_layers
    per_step = {"flash_attention_fwd": 2 * L * GAS,     # remat runs each forward again
                "flash_attention_bwd_dq": L * GAS, "flash_attention_bwd_dkv": L * GAS}
    ref_loss, ref_norm = TRAIN_REFS["loss"], TRAIN_REFS["grad_norm"]
    stages = {}
    for stage in ZERO_STAGES:
        r0, r1 = (r["stages"][stage] for r in ranks)
        assert r0["digests"] == r1["digests"], (stage, r0["digests"], r1["digests"])
        first = r0["steps"][0]
        loss_err = abs(first["loss"] - ref_loss) / abs(ref_loss)
        norm_err = abs(first["grad_norm"] - ref_norm) / abs(ref_norm)
        assert loss_err <= TRAIN_REF_LOSS_RTOL and norm_err <= TRAIN_REF_NORM_RTOL, \
            (stage, loss_err, norm_err)
        for r in (r0, r1):
            losses = [st["loss"] for st in r["steps"]]
            assert all(np.isfinite(losses)) and losses[-1] < losses[0], (stage, losses)
            assert r["launches"] == only(**{k: n * ZERO_STEPS for k, n in per_step.items()}), \
                (stage, r["launches"])
        stages[stage] = dict(first_step_loss_rel_err=loss_err,
                             first_step_grad_norm_rel_err=norm_err)
    for r in ranks:
        assert r["kernel_fallbacks"] == [], r["kernel_fallbacks"]
    checkpoint = zero_checkpoint(ranks)
    peak = {s: max(r["stages"][s]["peak_memory_bytes"] for r in ranks) for s in ZERO_STAGES}
    assert peak[3] <= ZERO_PEAK_RATIO * peak[0] and peak[3] < peak[1] <= peak[0], peak
    control = zero_control()
    control_err = abs(control["grad_norm"] - ref_norm) / abs(ref_norm)
    assert control_err > TRAIN_REF_NORM_RTOL, control
    tokens = GAS * ZERO_MBS * SEQ                      # a rank's tokens a step
    for stage in ZERO_STAGES:
        r0 = ranks[0]["stages"][stage]
        step_s = max(r["stages"][stage]["steps"][-1]["step_s"] for r in ranks)
        stages[stage].update(
            peak_memory_bytes_per_rank=[r["stages"][stage]["peak_memory_bytes"] for r in ranks],
            steps=r0["steps"], last_step_s=step_s, tokens_per_s_per_rank=tokens / step_s,
            tokens_per_s_total=DP * tokens / step_s,
            gloo_per_step={k: {f: v[f] / ZERO_STEPS for f in ("calls", "bytes", "seconds")}
                           for k, v in r0["comm"].items()},
            state_elements_per_rank=r0["state_elements"])
    report["train_zero"] = dict(
        card=report["card"], model=f"llama-1b (random bf16 weights, seed {SEED + 30}) over "
                                   f"dp={DP}, full depth at every stage",
        setup=f"{DP} ranks, one process each, sharing one card over gloo: the collectives "
              "stage through the host and the ranks share the card's compute, so these "
              "times are not a data-parallel speed",
        config=dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=ZERO_MBS), seq=SEQ,
        steps_per_stage=ZERO_STEPS, train_first_step=dict(TRAIN_REFS), wall_s=wall_s,
        stages=stages, peak_memory_bytes=peak,
        peak_stage3_over_stage0=peak[3] / peak[0],
        control=dict(control, grad_norm_rel_err=control_err,
                     what="one rank trained on rank 0's rows alone"),
        launches_per_rank_per_train_batch=per_step,
        checkpoint=dict(checkpoint, stage=ZERO_SAVE_STAGE),
        ranks=[dict(rank=r["rank"], device=r["device"], backend=r["backend"]) for r in ranks])
    log(f"train_zero: {DP} ranks sharing one card over gloo ({report['card']}): " + "; ".join(
        f"stage {s}: peak {peak[s] / 2**30:.2f} GiB a rank, step "
        f"{stages[s]['last_step_s']:.1f} s, gloo "
        f"{sum(v['seconds'] for v in stages[s]['gloo_per_step'].values()):.1f} s a step"
        for s in ZERO_STAGES) + f"; control norm err {control_err:.3f}; stage "
        f"{ZERO_SAVE_STAGE} save {checkpoint['save_s']:.1f} s, "
        f"{[b / 1e9 for b in checkpoint['bytes_written']]} GB a rank, resumed at dp = 2 "
        f"bitwise, loaded at dp = 1 in {checkpoint['resumed_at_dp1']['load_s']:.1f} s")


def zero_checkpoint(ranks):
    """ZERO_SAVE_STAGE's save: resumed at dp = 2 on each rank, bitwise the
    uninterrupted step; resumed at dp = 1 here, on the whole batch, against
    the ranks' step (TRAIN_REF_* bounds). Removes the save."""
    import shutil

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    cfg = zero_model_config()
    per_rank = [r["stages"][ZERO_SAVE_STAGE] for r in ranks]
    for r in per_rank:
        c = r["checkpoint"]
        want = {k: r["steps"][1][k] for k in ("loss", "grad_norm")}
        assert c["resumed_step"] == want and c["resumed_digest"] == r["digests"][1], (c, want)
    model = llama(cfg, SEED + 33)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG,
                                                loss_fn=llama_loss_fn(model))
    del model
    root = CKPT_DIR / f"train_zero_s{ZERO_SAVE_STAGE}"
    t0 = time.perf_counter()
    engine.load_checkpoint(root)
    load_s = time.perf_counter() - t0
    loss = float(engine.train_batch(batch={"input_ids": train_rows(cfg)}))
    norm = engine.get_global_grad_norm()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    ref = per_rank[0]["steps"][1]
    loss_err = abs(loss - ref["loss"]) / abs(ref["loss"])
    norm_err = abs(norm - ref["grad_norm"]) / abs(ref["grad_norm"])
    assert loss_err <= TRAIN_REF_LOSS_RTOL and norm_err <= TRAIN_REF_NORM_RTOL, \
        (loss_err, norm_err)
    return dict(save_s=max(r["checkpoint"]["save_s"] for r in per_rank),
                bytes_written=[r["checkpoint"]["bytes_written"] for r in per_rank],
                resumed_at_dp2=dict(bitwise=True,
                                    load_s=max(r["checkpoint"]["load_s"] for r in per_rank)),
                resumed_at_dp1=dict(loss=loss, grad_norm=norm, loss_rel_err=loss_err,
                                    grad_norm_rel_err=norm_err, load_s=load_s))


def train_zeropp(report):
    """ZeRO++ over dp = 2, run in `train_zero`'s ranks after its stages
    (`zero_rank`): stage 2 with qgZ and stage 3 with qwZ and qgZ, each
    held to the same stage's plain run on the same weights and rows (its
    first step's loss and pre-clip norm within ZEROPP_LOSS_RTOL and
    ZEROPP_NORM_RTOL), both ranks' parameters bitwise equal after every
    step, a falling loss, K1's launches as the plain stage's, and the
    wire bytes by kind over the plain run's against the prediction
    (`zeropp_prediction`, within ZEROPP_BYTES_RTOL); the control (blocks
    dequantized with a neighbour's scale) must miss the norm bound."""
    ranks = ZERO_RANKS
    out = {}
    for name, stage, qg, qw in ZEROPP_RUNS:
        runs = [r["zeropp"][name] for r in ranks]
        plain = [r["stages"][stage] for r in ranks]
        r0, p0 = runs[0], plain[0]
        assert r0["digests"] == runs[1]["digests"], (name, r0["digests"], runs[1]["digests"])
        first, ref = r0["steps"][0], p0["steps"][0]
        loss_err = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
        norm_err = abs(first["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
        assert loss_err <= ZEROPP_LOSS_RTOL[name] and norm_err <= ZEROPP_NORM_RTOL[name], \
            (name, loss_err, norm_err)
        for r, p in zip(runs, plain):
            losses = [st["loss"] for st in r["steps"]]
            assert all(np.isfinite(losses)) and losses[-1] < losses[0], (name, losses)
            assert r["launches"] == p["launches"], (name, r["launches"], p["launches"])
        wire = {}
        for kind, plain_kind, fraction in (("quantized_reduce_scatter", "reduce_scatter",
                                            "reduce_scatter"),
                                           ("quantized_all_gather", "all_gather", "all_gather")):
            if r0["predicted"][fraction] is None:
                assert kind not in r0["comm"], (name, kind)
                continue
            got = r0["comm"][kind]["bytes"] / p0["comm"][plain_kind]["bytes"]
            want = r0["predicted"][fraction]
            assert abs(got / want - 1) <= ZEROPP_BYTES_RTOL, (name, kind, got, want)
            # the gradients cross in int8 only (stage 1-2's update still gathers
            # bf16 parameters, stage 3's the few left whole)
            assert kind != "quantized_reduce_scatter" or plain_kind not in r0["comm"], \
                (name, r0["comm"])
            wire[kind] = dict(ratio=got, predicted=want,
                              bytes_per_step=r0["comm"][kind]["bytes"] / ZERO_STEPS,
                              plain_bytes_per_step=p0["comm"][plain_kind]["bytes"] / ZERO_STEPS)
        if qw:
            per_micro = r0["predicted"]["all_gather_bytes_per_micro"]
            jax = r0["predicted"]["all_gather_bytes_per_micro_jax_record"]
            wire["quantized_all_gather"].update(
                predicted_bytes_per_micro=per_micro, jax_record_bytes_per_micro=jax,
                over_jax_record=per_micro / jax)
        step_s = max(r["steps"][-1]["step_s"] for r in runs)
        out[name] = dict(
            stage=stage, qgz=qg, qwz=qw, first_step_loss_rel_err=loss_err,
            first_step_grad_norm_rel_err=norm_err, steps=r0["steps"], last_step_s=step_s,
            plain_last_step_s=max(p["steps"][-1]["step_s"] for p in plain),
            peak_memory_bytes_per_rank=[r["peak_memory_bytes"] for r in runs],
            gloo_per_step={k: {f: v[f] / ZERO_STEPS for f in ("calls", "bytes", "seconds")}
                           for k, v in r0["comm"].items()},
            plain_gloo_per_step={k: {f: v[f] / ZERO_STEPS for f in ("calls", "bytes",
                                                                    "seconds")}
                                 for k, v in p0["comm"].items()},
            wire=wire, launches_per_rank=r0["launches"])
    control = ranks[0]["zeropp_control"]
    ref = ranks[0]["stages"][ZEROPP_RUNS[0][1]]["steps"][0]
    control_err = abs(control["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    assert control_err > ZEROPP_NORM_RTOL[ZEROPP_RUNS[0][0]], (control_err, control)
    seconds = max(r["zeropp_s"] for r in ranks)
    report.setdefault("phase_s", {})["train_zeropp_ranks"] = seconds
    print(f"phase train_zeropp (in train_zero's ranks): {seconds:.1f} s", flush=True)
    report["train_zeropp"] = dict(
        card=report["card"], model="llama-1b (random bf16 weights, seed 30) over dp=2, "
                                   "full depth, beside train_zero's plain stages",
        runs=out, control=dict(control, grad_norm_rel_err=control_err,
                               what="stage 2 qgZ, every block dequantized with its "
                                    "neighbour's scale"),
        norm_rtol=ZEROPP_NORM_RTOL, loss_rtol=ZEROPP_LOSS_RTOL, ranks_s=seconds)
    log("train_zeropp: " + "; ".join(
        f"{n}: loss err {o['first_step_loss_rel_err']:.2e}, norm err "
        f"{o['first_step_grad_norm_rel_err']:.2e}, step {o['last_step_s']:.1f} s (plain "
        f"{o['plain_last_step_s']:.1f}), wire "
        + ", ".join(f"{k} {v['ratio']:.4f} (pred {v['predicted']:.4f})"
                    for k, v in o['wire'].items()) for n, o in out.items())
        + f"; control norm err {control_err:.3f}")


def spawn_ranks(fn, world):
    """`fn(rank, port, tmp)` in `world` spawned processes on the one card;
    each saves its result to `tmp/rank{r}.pt`. Returns the results and
    the wall seconds."""
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(fn, args=(free_port(), tmp), nprocs=world, start_method="spawn")
        wall_s = time.perf_counter() - t0
        return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                for r in range(world)], wall_s


def join_ranks(rank, world, port):
    import datetime

    from deepspeed_tpu_torch import comm
    comm.init_distributed(dist_backend="gloo", init_method=f"tcp://localhost:{port}",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))


def cut_llama_config(layers):
    from deepspeed_tpu_torch.models.llama import llama_config
    return llama_config("llama-1b", num_hidden_layers=layers, remat=True,
                        remat_policy="nothing")


def train_steps(engine, batch, steps, by_group=False):
    """`steps` `train_batch` calls on `batch`: per step the loss, pre-clip
    norm, seconds and gloo's calls, bytes and seconds by kind (and group),
    the gathered parameters' digest after it, and the peak memory."""
    from deepspeed_tpu_torch import comm
    out, peak = [], 0
    for _ in range(steps):
        comm.reset_comm_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch=batch))
        torch.cuda.synchronize()
        out.append(dict(loss=loss, grad_norm=engine.get_global_grad_norm(),
                        step_s=time.perf_counter() - t0, comm=comm.comm_stats(by_group)))
        peak = max(peak, torch.cuda.max_memory_allocated())
        out[-1]["digest"] = param_digest(engine.gathered_params())
    return out, peak


MICS_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=MBS // MICS_RANKS,
                   zero_optimization={"stage": 3, "mics_shard_size": MICS_SHARD})


def mics_rank(rank, port, tmp):
    """One rank of `train_mics`: the engine builds `repl` x `data` from
    the config's `mics_shard_size`; MICS_STEPS steps on this rank's rows."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    from deepspeed_tpu_torch.utils.groups import BATCH_AXES
    join_ranks(rank, MICS_RANKS, port)
    try:
        cfg = cut_llama_config(MICS_LAYERS)
        model = llama(cfg, SEED + 30)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=MICS_CONFIG,
                                                    loss_fn=llama_loss_fn(model))
        del model
        topo = engine.topology
        where = topo.coord(BATCH_AXES)
        rows = train_rows(cfg).reshape(GAS, MICS_RANKS, -1, SEQ)[:, where].reshape(-1, SEQ)
        zero_launches()
        steps, peak = train_steps(engine, {"input_ids": rows}, MICS_STEPS, by_group=True)
        out = dict(rank=rank, coords=topo.coords, steps=steps, peak_memory_bytes=peak,
                   launches=read_launches(),
                   pieces_digest=param_digest(engine.state.params))
        torch.save(out, f"{tmp}/rank{rank}.pt")
        comm.barrier()
    finally:
        comm.destroy_process_group()


def train_mics(report):
    """MiCS over four ranks on the one card (`repl` 2 x `data` 2, stage 3,
    llama-1b at MICS_LAYERS layers, `train`'s global batch): every rank's
    gathered parameters bitwise equal after each step, `repl` peers'
    pieces bitwise equal and `data` peers' not, the gathers on the `data`
    pairs only and the gradient mean across `repl`, the first step
    against a one-rank engine at the same depth (TRAIN_REF_* bounds), a
    falling loss, K1's launches, the peak memory a rank."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    ranks, wall_s = spawn_ranks(mics_rank, MICS_RANKS)
    cfg = cut_llama_config(MICS_LAYERS)
    L = cfg.num_hidden_layers
    per_step = {"flash_attention_fwd": 2 * L * GAS, "flash_attention_bwd_dq": L * GAS,
                "flash_attention_bwd_dkv": L * GAS}
    for i in range(MICS_STEPS):
        assert len({r["steps"][i]["digest"] for r in ranks}) == 1, i
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coords"]["data"], set()).add(r["pieces_digest"])
        assert r["coords"]["repl"] * MICS_SHARD + r["coords"]["data"] == r["rank"], r["coords"]
        losses = [s["loss"] for s in r["steps"]]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert r["launches"] == only(**{k: n * MICS_STEPS for k, n in per_step.items()}), \
            r["launches"]
        for s in r["steps"]:
            assert set(s["comm"]["all_gather"]) == {"data"}, s["comm"]["all_gather"]
            assert "repl" in s["comm"]["all_reduce"], s["comm"]["all_reduce"]
    assert all(len(d) == 1 for d in by_data.values()) and len(by_data) == MICS_SHARD and \
        len(set.union(*by_data.values())) == MICS_SHARD, by_data
    model = llama(cfg, SEED + 30)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG,
                                                loss_fn=llama_loss_fn(model))
    del model
    loss = float(engine.train_batch(batch={"input_ids": train_rows(cfg)}))
    ref = dict(loss=loss, grad_norm=engine.get_global_grad_norm())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    first = ranks[0]["steps"][0]
    loss_err = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
    norm_err = abs(first["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    assert loss_err <= TRAIN_REF_LOSS_RTOL and norm_err <= TRAIN_REF_NORM_RTOL, \
        (loss_err, norm_err, ref)
    steps = ranks[0]["steps"]
    report["train_mics"] = dict(
        card=report["card"], model=f"llama-1b at {L} of 22 layers (random bf16 weights, "
                                   f"seed {SEED + 30}), repl {MICS_RANKS // MICS_SHARD} x "
                                   f"data {MICS_SHARD}, ZeRO stage 3",
        setup=f"{MICS_RANKS} ranks, one process each, sharing one card over gloo",
        config=MICS_CONFIG, seq=SEQ, wall_s=wall_s, one_rank_first_step=ref,
        first_step_loss_rel_err=loss_err, first_step_grad_norm_rel_err=norm_err,
        steps=[{k: v for k, v in s.items() if k != "comm"} for s in steps],
        gloo_per_step_by_group=steps[-1]["comm"],
        peak_memory_bytes_per_rank=[r["peak_memory_bytes"] for r in ranks],
        launches_per_rank_per_train_batch=per_step,
        coords=[r["coords"] for r in ranks])
    log(f"train_mics: {MICS_RANKS} ranks, peak "
        f"{max(r['peak_memory_bytes'] for r in ranks) / 2**30:.2f} GiB a rank, step "
        f"{steps[-1]['step_s']:.1f} s, loss err {loss_err:.2e}, norm err {norm_err:.2e}")


ONEBIT_BASE = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=ZERO_MBS, gradient_clipping=0.0,
                   zero_optimization={"stage": 0})
ONEBIT_CONFIG = dict(ONEBIT_BASE, optimizer={
    "type": "OneBitAdam", "params": {"lr": 1e-4, "freeze_step": ONEBIT_FREEZE,
                                     "comm_backend_name": "gloo"}})


def flat_master(engine):
    """The f32 master, flat, in the module's parameter order."""
    return torch.cat([engine.state.master[n].reshape(-1) for n in engine.param_shapes])


def onebit_run(rank):
    """This rank's part of `train_onebit`, in `train_zero`'s ranks after
    the ZeRO++ runs: FusedAdam for ONEBIT_FREEZE + 1 steps, then 1-bit Adam
    for ONEBIT_STEPS, on the same weights and rows; the 1-bit run's master
    against Adam's after each of its first ONEBIT_FREEZE + 1 steps (the
    relative L2 distance of the changes from the start)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    from deepspeed_tpu_torch.ops.optimizers import jax_leaves
    cfg = cut_llama_config(ONEBIT_LAYERS)
    batch = {"input_ids": rank_rows(train_rows(cfg), rank)}

    def engine(config):
        model = llama(cfg, SEED + 30)
        eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                 loss_fn=llama_loss_fn(model))
        return eng
    adam = engine(ONEBIT_BASE)
    start = flat_master(adam)
    adam_moves = []
    for _ in range(ONEBIT_FREEZE + 1):
        adam.train_batch(batch=batch)
        adam_moves.append(flat_master(adam) - start)
    del adam
    gc.collect()
    wire = engine(ONEBIT_CONFIG)
    zero_launches()
    steps, gaps, peak = [], [], 0
    for i in range(ONEBIT_STEPS):
        got, step_peak = train_steps(wire, batch, 1)
        steps += got
        peak = max(peak, step_peak)
        if i <= ONEBIT_FREEZE:
            move = flat_master(wire) - start
            gaps.append(float((move - adam_moves[i]).norm() / adam_moves[i].norm()))
    out = dict(rank=rank, steps=steps, gaps=gaps, peak_memory_bytes=peak,
               launches=read_launches(), n_params=int(start.numel()),
               n_leaves=len(jax_leaves(wire.state.params)))
    del wire
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_onebit(report):
    """1-bit Adam's wire over dp = 2 (stage 0, llama-1b at ONEBIT_LAYERS
    layers, freeze_step ONEBIT_FREEZE, no clipping), run in `train_zero`'s
    ranks after the ZeRO++ runs (`onebit_run`): both ranks' parameters
    bitwise equal after each step; the warm-up's steps within
    ONEBIT_WARMUP_RTOL of FusedAdam's on the same rows, the first
    compressed step not (the control); a falling loss; K1's launches; the
    wire's bytes a step before the freeze (the exact momentum mean and the
    norm's mean, f32) and after it (int8 signs and one f32 scale a JAX
    leaf, and the norm's mean)."""
    ranks = [r["onebit"] for r in ZERO_RANKS]
    wall_s = max(r["onebit_s"] for r in ZERO_RANKS)
    report.setdefault("phase_s", {})["train_onebit_ranks"] = wall_s
    print(f"phase train_onebit (in train_zero's ranks): {wall_s:.1f} s", flush=True)
    cfg = cut_llama_config(ONEBIT_LAYERS)
    L = cfg.num_hidden_layers
    per_step = {"flash_attention_fwd": 2 * L * GAS, "flash_attention_bwd_dq": L * GAS,
                "flash_attention_bwd_dkv": L * GAS}
    r0 = ranks[0]
    assert [s["digest"] for s in r0["steps"]] == [s["digest"] for s in ranks[1]["steps"]]
    for r in ranks:
        gaps = r["gaps"]
        first, later = ONEBIT_WARMUP_RTOL
        assert gaps[0] <= first and max(gaps[1:ONEBIT_FREEZE]) <= later < gaps[ONEBIT_FREEZE], \
            gaps
        losses = [s["loss"] for s in r["steps"]]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert r["launches"] == only(**{k: n * ONEBIT_STEPS for k, n in per_step.items()}), \
            r["launches"]
    n, leaves = r0["n_params"], r0["n_leaves"]
    for i, s in enumerate(r0["steps"]):
        kinds = s["comm"]
        if i < ONEBIT_FREEZE:
            assert "compressed_allreduce" not in kinds, kinds
            assert kinds["all_reduce"]["bytes"] >= 8 * n, kinds
        else:
            assert kinds["compressed_allreduce"]["bytes"] == n + 4 * leaves, kinds
            assert 4 * n <= kinds["all_reduce"]["bytes"] < 5 * n, kinds
    report["train_onebit"] = dict(
        card=report["card"], model=f"llama-1b at {L} of 22 layers (random bf16 weights, "
                                   f"seed {SEED + 30}) over dp={DP}, ZeRO stage 0",
        setup=f"{DP} ranks sharing one card over gloo (train_zero's)", config=ONEBIT_CONFIG,
        seq=SEQ,
        wall_s=wall_s, params=n, jax_leaves=leaves, warmup_rel_gaps=r0["gaps"],
        steps=[{k: v for k, v in s.items() if k != "comm"} for s in r0["steps"]],
        gloo_per_step=[s["comm"] for s in r0["steps"]],
        peak_memory_bytes_per_rank=[r["peak_memory_bytes"] for r in ranks],
        launches_per_rank_per_train_batch=per_step)
    log(f"train_onebit: gaps to Adam {['%.2e' % g for g in r0['gaps']]}, bytes a step "
        + ", ".join(f"step {i + 1}: " + ", ".join(f"{k} {v['bytes'] / 1e9:.3f} GB"
                                                  for k, v in s["comm"].items())
                    for i, s in enumerate(r0["steps"])))


def zero_rank(rank, port, tmp):
    """One rank of `train_zero`: joins the gloo group and trains under each
    ZeRO stage in turn (`zero_stage`)."""
    import datetime
    import logging

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils.logging import logger
    comm.init_distributed(dist_backend="gloo", init_method=f"tcp://localhost:{port}",
                          rank=rank, world_size=DP,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    fallbacks = []
    handler = logging.Handler()
    handler.emit = lambda rec: fallbacks.append(rec.getMessage()) \
        if "kernel_fallback" in rec.getMessage() else None
    logger.addHandler(handler)
    try:
        from deepspeed_tpu_torch.accelerator import get_accelerator
        out = dict(rank=rank, device=str(get_accelerator().device),
                   backend=comm.get_backend(), stages={})
        for stage in ZERO_STAGES:
            out["stages"][stage] = zero_stage(rank, stage)
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["zeropp"] = {}
        for name, stage, qg, qw in ZEROPP_RUNS:
            out["zeropp"][name] = zero_stage(rank, stage, (qg, qw))
            gc.collect()
            torch.cuda.empty_cache()
        out["zeropp_control"] = zeropp_control(rank)
        out["zeropp_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["onebit"] = onebit_run(rank)
        out["onebit_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["zoo"] = {name: {stage: zoo_dp_run(rank, family, name, seed, stage)
                             for stage in ZOO_DP_STAGES}
                      for family, name, seed, _ in ZOO_TRAIN}
        out["zoo_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["moe_zero"] = [moe_dp_step(dict(MOE_DP_CONFIG, zero_optimization={"stage": stage}),
                                       dispatch, moe_dp_rows(rank))
                           for stage, dispatch in MOE_DP_RUNS]
        out["moe_zero_s"] = time.perf_counter() - t0
        out["kernel_fallbacks"] = fallbacks
        torch.save(out, f"{tmp}/rank{rank}.pt")
        comm.barrier()
    finally:
        logger.removeHandler(handler)
        comm.destroy_process_group()


def param_digest(params) -> str:
    """A digest of the parameters' names and bits, in order: SHA-256 of the
    names and each tensor's `word_sum`, which the card computes (hashing
    the bytes on the host took ~1.5 s a GB on the H100's machine)."""
    import hashlib
    h = hashlib.sha256()
    for name, p in params.items():
        h.update(name.encode())
        h.update(str(word_sum(p)).encode())
    return h.hexdigest()


def word_sum(t, chunk: int = 1 << 26) -> int:
    """The sum, mod 2^64, of a tensor's 16- or 32-bit words times odd
    multipliers that depend on each word's position, on the card. Integer
    sums are exact in any order, and a change of one word always changes
    the sum (its difference, under 2^33, times an odd number is not 0 mod
    2^64)."""
    words = t.detach().to("cuda").contiguous().view(-1)
    words = words.view(torch.int16 if words.element_size() == 2 else torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    for start in range(0, words.numel(), chunk):
        w = words[start:start + chunk].to(torch.int64)
        pos = torch.arange(start, start + w.numel(), dtype=torch.int64, device=w.device)
        total += (w * ((pos * -7046029254386353131 + 1442695040888963407) | 1)).sum()
    return int(total)


def zero_stage(rank, stage, zeropp=None):
    """ZERO_STEPS `train_batch` calls of llama-1b under one ZeRO stage on
    this rank's rows: losses, grad norms, step seconds, the parameters'
    digest after each step, the peak memory inside the steps, launches,
    gloo's calls, bytes and seconds, and the elements of the rank's state;
    at ZERO_SAVE_STAGE the save after the first step and its resumption.
    With `zeropp` (qgZ, qwZ) the stage runs ZeRO++ instead, and reports
    the predicted ratios of its wire bytes (`zeropp_prediction`)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    cfg = zero_model_config()
    zero = {"stage": stage}
    if zeropp is not None:
        zero.update(zero_quantized_gradients=zeropp[0], zero_quantized_weights=zeropp[1])
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=ZERO_MBS,
                  zero_optimization=zero)
    model = llama(cfg, SEED + 30)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                loss_fn=llama_loss_fn(model))
    del model
    batch = {"input_ids": rank_rows(train_rows(cfg), rank)}
    st = engine.state
    state_elements = {k: sum(t.numel() for t in tree.values()) for k, tree in (
        ("params", st.params), ("master", st.master), ("exp_avg", st.opt_state.exp_avg),
        ("grad_acc", st.grad_acc))}
    steps, digests, peak, gloo, saved = [], [], 0, {}, None
    predicted = None if zeropp is None else zeropp_prediction(engine)
    zero_launches()
    for i in range(ZERO_STEPS):
        if i == 1 and stage == ZERO_SAVE_STAGE and zeropp is None:
            saved = zero_save(engine, rank, stage)
        comm.reset_comm_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch=batch))
        torch.cuda.synchronize()
        steps.append(dict(loss=loss, grad_norm=engine.get_global_grad_norm(),
                          step_s=time.perf_counter() - t0))
        peak = max(peak, torch.cuda.max_memory_allocated())
        for kind, v in comm.comm_stats().items():
            acc = gloo.setdefault(kind, dict.fromkeys(v, 0))
            for f in v:
                acc[f] += v[f]
        digests.append(param_digest(engine.gathered_params()))
    launches = read_launches()
    del engine
    out = dict(steps=steps, digests=digests, peak_memory_bytes=peak, launches=launches,
               comm=gloo, state_elements=state_elements, checkpoint=saved,
               predicted=predicted)
    if stage == ZERO_SAVE_STAGE and zeropp is None:
        out["checkpoint"].update(zero_resume(rank, stage, config, batch))
    return out


def zeropp_prediction(engine):
    """The wire bytes ZeRO++ sends over the plain collectives' bytes, from
    the engine's pieces and the JAX package's block rule: the gradient
    reduce-scatter (int8 plus an f32 scale a block against f32; a stacked
    leaf's chunk is its layers' pieces together) and stage 3's gathers
    (against bf16), each gather counted as often as a micro runs it (twice
    for a decoder block under remat: the recompute gathers again, where the
    JAX step gathers once), beside the plain step's, which also gathers
    the leaves left whole in bf16 after its update. Also the gathers'
    bytes a micro as the JAX package records them (each leaf once)."""
    from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import wire_bytes
    from deepspeed_tpu_torch.runtime.zero.partition import jax_leaf_key
    dp, gas = engine.dp, engine.gradient_accumulation_steps()
    z = engine.config.zero_config
    rs_q = rs_plain = ag_q = ag_plain = ag_jax = 0
    stacked = {}
    for u in engine.units:
        g, s = u.gathered, u.sharded
        times = 1 if u.module is engine.module else 2     # remat gathers a block again
        if g is not None:
            for p in g.pieces:
                rs_q += wire_bytes(dp * p, 256, dp)
                rs_plain += 4 * dp * p
                if z.zero_quantized_weights:
                    ag_q += gas * times * wire_bytes(p)
                    ag_plain += gas * times * 2 * p
                    ag_jax += wire_bytes(p)
        if s is not None and z.zero_quantized_weights:
            ag_plain += 2 * s.size      # the plain step's bf16 gather after its update
        if s is not None:
            for n, p in zip(s.names, s.pieces):
                stacked[jax_leaf_key(n)] = stacked.get(jax_leaf_key(n), 0) + p
    for p in stacked.values():
        rs_q += wire_bytes(dp * p, 256, dp)
        rs_plain += 4 * dp * p
    return dict(reduce_scatter=rs_q / rs_plain,
                all_gather=ag_q / ag_plain if ag_plain else None,
                all_gather_bytes_per_micro=ag_q / gas,
                all_gather_bytes_per_micro_jax_record=ag_jax)


def zeropp_control(rank):
    """The control of `train_zeropp`: the stage-2 qgZ run's first step
    with every block dequantized with its neighbour's scale (the scales
    rolled by one block), on the same weights and rows: its loss and
    pre-clip norm, which must miss the run's norm bound."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc
    cfg = zero_model_config()
    _, stage, qg, qw = ZEROPP_RUNS[0]
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=ZERO_MBS,
                  zero_optimization={"stage": stage, "zero_quantized_gradients": qg,
                                     "zero_quantized_weights": qw})
    model = llama(cfg, SEED + 30)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                loss_fn=llama_loss_fn(model))
    del model
    dequantize = cc.dequantize_rows
    cc.dequantize_rows = lambda q, scales: dequantize(q, scales.roll(1, dims=1))
    try:
        loss = float(engine.train_batch(batch={"input_ids": rank_rows(train_rows(cfg), rank)}))
    finally:
        cc.dequantize_rows = dequantize
    out = dict(loss=loss, grad_norm=engine.get_global_grad_norm())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zero_save(engine, rank, stage):
    """This rank's part of a save after the stage's first step: seconds
    and the bytes of the files this rank wrote."""
    from deepspeed_tpu_torch.runtime.checkpointing import WHOLE_FILE, rank_file
    root = CKPT_DIR / f"train_zero_s{stage}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = engine.save_checkpoint(root)
    save_s = time.perf_counter() - t0
    mine = {rank_file(rank)} | ({WHOLE_FILE} if rank == 0 else set())
    return dict(path=path, save_s=save_s, bytes_written=dir_bytes(path, mine))


def zero_resume(rank, stage, config, batch):
    """A fresh engine from other weights loads the stage's save and takes
    its second step again: loss, grad norm, digest, load seconds."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    model = llama(zero_model_config(), SEED + 33)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                loss_fn=llama_loss_fn(model))
    del model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.load_checkpoint(CKPT_DIR / f"train_zero_s{stage}")
    load_s = time.perf_counter() - t0
    loss = float(engine.train_batch(batch=batch))
    out = dict(load_s=load_s, resumed_step=dict(loss=loss, grad_norm=engine.get_global_grad_norm()),
               resumed_digest=param_digest(engine.gathered_params()))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    comm.barrier()
    return out


def zero_model_config():
    from deepspeed_tpu_torch.models.llama import llama_config
    return llama_config("llama-1b", remat=True, remat_policy="nothing")


def zero_control():
    """The control of `train_zero`: one rank (this process, dp = 1) trained
    on rank 0's rows alone, with the same config and weights; its first
    step's loss and pre-clip grad norm."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    cfg = zero_model_config()
    model = llama(cfg, SEED + 30)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, loss_fn=llama_loss_fn(model),
        config=dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=ZERO_MBS))
    loss = float(engine.train_batch(batch={"input_ids": rank_rows(train_rows(cfg), 0)}))
    out = dict(loss=loss, grad_norm=engine.get_global_grad_norm())
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train(engine, batch):
    """Device time by kernel over one `train_batch`, from torch.profiler,
    and K1's share of it (forward, dq and dk/dv together)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    summary = profile_summary(None, 1, wall_us, kernels)
    summary["port_kernels"] = kernel_shares(kernels, 1)
    k1 = [v for k, v in summary["port_kernels"].items() if k.startswith("flash_attention")]
    summary["k1_ms_per_step"] = sum(v["ms_per_step"] for v in k1)
    summary["k1_device_share"] = sum(v["device_share"] or 0.0 for v in k1)
    print(f"K1 (flash fwd, dq, dk/dv) in the llama-1b training step: "
          f"{summary['k1_ms_per_step']:.2f} ms of {summary['device_ms_per_step']:.2f} device "
          f"ms, share {summary['k1_device_share']:.3f}", flush=True)
    return summary


def train_reference(report):
    """Two layers at the llama-1b width (`two_layer_reference`): one GAS
    window of micro-batch 2 at sequence 512."""
    from deepspeed_tpu_torch.models.llama import llama_config, llama_loss_fn
    ids = torch.randint(0, 32000, (4, 512), generator=torch.Generator().manual_seed(SEED + 32))
    report["train_reference"] = two_layer_reference(
        llama(llama_config("llama-1b", num_hidden_layers=2), SEED + 30), llama_loss_fn,
        GRAD_KEYS, ids, k1_per_step(2))


def two_layer_reference(gpu_model, loss_fn, keys, ids, per_window):
    """A 2-layer model at a full width (`gpu_model`, on the card in bf16):
    one GAS window of forward/backward over `ids` in two micros against the
    plain versions on the CPU in f32 on the same weights (loss within
    TRAIN_REF_LOSS_RTOL, grad norm within TRAIN_REF_NORM_RTOL, the
    gradients of `keys` within TRAIN_REF_GRAD_RTOL, relative RMS); and on
    the card remat on against remat off (REMAT_RTOL), each window launching
    `per_window` with remat and K1-fwd half as often without."""
    import deepspeed_tpu_torch
    config = {"train_micro_batch_size_per_gpu": ids.shape[0] // 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-4}}}
    cls, cfg = type(gpu_model), gpu_model.cfg
    card = next(gpu_model.parameters()).device
    weights = {k: v.float().cpu() for k, v in gpu_model.state_dict().items()}

    def port_model(device, dtype, remat=True):
        model = cls(dataclasses.replace(cfg, dtype=dtype, remat=remat), device="meta")
        model.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in weights.items()},
                              assign=True)
        return model

    def window(model, config, device=None):
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                    loss_fn=loss_fn(model), device=device)
        losses = []
        for micro in ids.chunk(2):
            loss = engine({"input_ids": micro})
            engine.backward(loss)
            losses.append(float(loss.detach()))
        grads = {k: engine.state.grad_acc[k].float().cpu() for k in keys}
        return float(np.mean(losses)), engine.get_global_grad_norm(), grads

    bf16 = dict(config, bf16={"enabled": True})
    zero_launches()
    gpu = window(gpu_model, bf16)
    remat_launches = read_launches()
    del gpu_model
    zero_launches()
    gpu_off = window(port_model(card, torch.bfloat16, remat=False), bf16)
    off_launches = read_launches()
    cpu = window(port_model("cpu", torch.float32), config, device="cpu")
    gc.collect()
    torch.cuda.empty_cache()
    loss_err = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    norm_err = abs(gpu[1] - cpu[1]) / abs(cpu[1])
    grad_errs = {k: rel_err(gpu[2][k], cpu[2][k]) for k in keys}
    remat_loss_err = abs(gpu[0] - gpu_off[0]) / abs(gpu_off[0])
    remat_norm_err = abs(gpu[1] - gpu_off[1]) / abs(gpu_off[1])
    assert loss_err <= TRAIN_REF_LOSS_RTOL and norm_err <= TRAIN_REF_NORM_RTOL \
        and max(grad_errs.values()) <= TRAIN_REF_GRAD_RTOL, (loss_err, norm_err, grad_errs)
    assert remat_loss_err <= REMAT_RTOL and remat_norm_err <= REMAT_RTOL, \
        (remat_loss_err, remat_norm_err)
    off = {k: n // 2 if k == "flash_attention_fwd" else n for k, n in per_window.items()}
    assert remat_launches == only(**per_window) and off_launches == only(**off), \
        (remat_launches, off_launches)
    return dict(
        loss_card=gpu[0], loss_cpu=cpu[0], loss_rel_err=loss_err, grad_norm_card=gpu[1],
        grad_norm_cpu=cpu[1], grad_norm_rel_err=norm_err, grad_acc_rel_rms_err=grad_errs,
        remat_off_loss=gpu_off[0], remat_off_grad_norm=gpu_off[1],
        remat_loss_rel_err=remat_loss_err, remat_grad_norm_rel_err=remat_norm_err,
        launches_remat_on=remat_launches, launches_remat_off=off_launches)


def zoo_loss_fn(family):
    import importlib
    return getattr(importlib.import_module(f"deepspeed_tpu_torch.models.{family}"),
                   f"{family}_loss_fn")


def k1_per_step(layers, alibi=False):
    """K1's launches a `train_batch` of GAS micros under remat (which runs
    each forward again); none with alibi, which takes the masked path."""
    if alibi:
        return {}
    return {"flash_attention_fwd": 2 * layers * GAS, "flash_attention_bwd_dq": layers * GAS,
            "flash_attention_bwd_dkv": layers * GAS}


def train_zoo(report):
    """The zoo's training main paths (`ZOO_TRAIN`): each model at full width
    and depth with random bf16 weights through `initialize` →
    `train_batch`, one warm-up and ZOO_TRAIN_STEPS timed steps on one fixed
    batch, launches counted over the timed steps (`k1_per_step` a
    `train_batch`, nothing else); the loss must fall; step seconds,
    tokens/s, MFU and peak memory. Then a 2-layer model of each width
    against the CPU in f32 over micro-batch 2 at sequence 256, and remat on
    against off (`two_layer_reference`). Returns each model's launches."""
    import deepspeed_tpu_torch
    rows, launches = {}, {}
    for family, name, seed, mbs in ZOO_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        model = zoo_model(family, name, seed, remat=True, remat_policy="nothing")
        cfg = model.cfg
        config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=mbs)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                    loss_fn=zoo_loss_fn(family)(model))
        del model
        acc = engine.accelerator
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        batch = {"input_ids": torch.randint(0, cfg.vocab_size, (GAS * mbs, SEQ), generator=gen,
                                            device="cuda")}
        t0 = time.perf_counter()
        engine.train_batch(batch=batch)                 # warm-up
        acc.synchronize()
        warmup_s = time.perf_counter() - t0
        acc.reset_peak_memory_stats()
        zero_launches()
        steps = []
        t0 = time.perf_counter()
        for _ in range(ZOO_TRAIN_STEPS):
            ts = time.perf_counter()
            loss = float(engine.train_batch(batch=batch))
            steps.append(dict(loss=loss, grad_norm=engine.get_global_grad_norm(),
                              step_s=time.perf_counter() - ts))
        wall_s = time.perf_counter() - t0
        got = read_launches()
        peak = acc.max_memory_allocated()
        L = cfg.num_hidden_layers
        per_step = k1_per_step(L, family == "bloom")
        assert got == only(**{k: n * ZOO_TRAIN_STEPS for k, n in per_step.items()}), (name, got)
        losses = [st["loss"] for st in steps]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], (name, losses)
        tokens = GAS * mbs * SEQ
        step_s = wall_s / ZOO_TRAIN_STEPS
        n_params = engine.total_params
        flops_per_token = 6.0 * n_params + 6.0 * L * cfg.hidden_size * SEQ
        peak_tflops = acc.peak_tflops("bfloat16")
        mfu = tokens / step_s * flops_per_token / (peak_tflops * 1e12)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        rows[name] = dict(
            card=report["card"], model=f"{name} (published shapes, random bf16 weights, "
                                       f"seed {seed}), full depth",
            params=n_params, config=config, seq=SEQ, tokens_per_step=tokens,
            warmup_s=warmup_s, steps=steps, step_s=step_s, tokens_per_s=tokens / step_s,
            flops_per_token=flops_per_token, peak_tflops_datasheet=peak_tflops, mfu=mfu,
            peak_memory_bytes=peak, launches=got, launches_per_train_batch=per_step,
            reference=two_layer_reference(
                zoo_model(family, name, seed + 5, num_hidden_layers=2, remat=True),
                zoo_loss_fn(family), ZOO_GRAD_KEYS[family],
                torch.randint(0, cfg.vocab_size, (4, 256),
                              generator=torch.Generator().manual_seed(seed + 6)),
                k1_per_step(2, family == "bloom")))
        launches[name] = got
        log(f"train_zoo {name}: {n_params / 1e9:.3f}e9 params, step {step_s:.3f} s, "
            f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.3f}, peak {peak / 2**30:.1f} GiB, "
            f"losses {losses}")
    report["train_zoo"] = rows
    return launches


def zoo_dp_engine(family, name, seed, mbs, stage):
    """A zoo model at full width and ZOO_DP_LAYERS layers (random bf16
    weights from `seed`, the same on every rank) under `train`'s config at
    micro-batch `mbs` and ZeRO `stage`: (engine, model config)."""
    import deepspeed_tpu_torch
    model = zoo_model(family, name, seed + 7, num_hidden_layers=ZOO_DP_LAYERS, remat=True)
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=mbs,
                  zero_optimization={"stage": stage})
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                loss_fn=zoo_loss_fn(family)(model))
    return engine, model.cfg


def zoo_dp_rows(cfg, seed, rank=None):
    """The zoo's global batch across data ranks (GAS x ZERO_MBS x DP rows
    of SEQ tokens, `train_zero`'s shape), or rank `rank`'s rows of it."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    rows = torch.randint(0, cfg.vocab_size, (GAS * ZERO_MBS * DP, SEQ), generator=gen,
                         device="cuda")
    return rows if rank is None else rank_rows(rows, rank)


def zoo_dp_run(rank, family, name, seed, stage):
    """One `train_batch` of a zoo model (`zoo_dp_engine`) on this rank's
    rows at ZeRO `stage`: `train_steps`' record, the peak memory and the
    launches."""
    engine, cfg = zoo_dp_engine(family, name, seed, ZERO_MBS, stage)
    zero_launches()
    steps, peak = train_steps(engine, {"input_ids": zoo_dp_rows(cfg, seed, rank)}, 1)
    launches = read_launches()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, peak_memory_bytes=peak, launches=launches)


def train_zoo_zero(report):
    """The zoo across data ranks, run in `train_zero`'s ranks after its
    other runs (`zero_rank`): each family at ZOO_DP_LAYERS layers of full
    width, one step at each of ZOO_DP_STAGES over dp = 2 (stage 3 gathers
    its units: `zero3_gathers`). Both ranks' parameters bitwise equal after
    the step; the step's loss and pre-clip norm within TRAIN_REF_LOSS_RTOL
    and ZOO_DP_NORM_RTOL of one rank's on the same global batch (here);
    each rank's launches `k1_per_step` at that depth; the control, one
    rank on rank 0's rows alone, must miss the norm bound."""
    ranks = ZERO_RANKS
    out = {}
    for family, name, seed, _ in ZOO_TRAIN:
        refs = {}
        for what, mbs, rank in (("reference", ZERO_MBS * DP, None), ("control", ZERO_MBS, 0)):
            engine, cfg = zoo_dp_engine(family, name, seed, mbs, 0)
            loss = float(engine.train_batch(batch={"input_ids": zoo_dp_rows(cfg, seed, rank)}))
            refs[what] = dict(loss=loss, grad_norm=engine.get_global_grad_norm())
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        ref, control = refs["reference"], refs["control"]
        stages = {}
        for stage in ZOO_DP_STAGES:
            r0, r1 = (r["zoo"][name][stage] for r in ranks)
            first = r0["steps"][0]
            stages[stage] = dict(
                loss=first["loss"], grad_norm=first["grad_norm"],
                loss_rel_err=abs(first["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_norm_rel_err=abs(first["grad_norm"] - ref["grad_norm"])
                / abs(ref["grad_norm"]),
                ranks_bitwise_equal=first["digest"] == r1["steps"][0]["digest"],
                launches_per_rank=[r["launches"] for r in (r0, r1)],
                step_s=max(r["steps"][0]["step_s"] for r in (r0, r1)),
                peak_memory_bytes_per_rank=[r["peak_memory_bytes"] for r in (r0, r1)],
                gloo={k: {f: v[f] for f in ("calls", "bytes", "seconds")}
                      for k, v in first["comm"].items()})
        out[name] = dict(stages=stages, one_rank=ref, control=dict(
            control, grad_norm_rel_err=abs(control["grad_norm"] - ref["grad_norm"])
            / abs(ref["grad_norm"]), what="one rank trained on rank 0's rows alone"),
            launches_per_rank_per_train_batch=k1_per_step(ZOO_DP_LAYERS, family == "bloom"))
    seconds = max(r["zoo_s"] for r in ranks)
    report.setdefault("phase_s", {})["train_zoo_zero_ranks"] = seconds
    print(f"phase train_zoo_zero (in train_zero's ranks): {seconds:.1f} s", flush=True)
    report["train_zoo_zero"] = dict(
        card=report["card"], setup=f"{DP} ranks sharing one card over gloo, as train_zero",
        layers=ZOO_DP_LAYERS, stages=list(ZOO_DP_STAGES), seq=SEQ,
        config=dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=ZERO_MBS), models=out,
        loss_rtol=TRAIN_REF_LOSS_RTOL, norm_rtol=ZOO_DP_NORM_RTOL, ranks_s=seconds)
    log("train_zoo_zero: " + "; ".join(
        f"{n}: " + ", ".join(f"stage {s} loss err {v['loss_rel_err']:.2e} norm err "
                             f"{v['grad_norm_rel_err']:.2e} step {v['step_s']:.1f} s"
                             for s, v in o["stages"].items())
        + f", control {o['control']['grad_norm_rel_err']:.3e}" for n, o in out.items()))
    for name, o in out.items():
        per_step = only(**o["launches_per_rank_per_train_batch"])
        for stage, v in o["stages"].items():
            assert v["ranks_bitwise_equal"], (name, stage)
            assert v["loss_rel_err"] <= TRAIN_REF_LOSS_RTOL \
                and v["grad_norm_rel_err"] <= ZOO_DP_NORM_RTOL, (name, stage, v)
            assert all(got == per_step for got in v["launches_per_rank"]), (name, stage, v)
        assert o["control"]["grad_norm_rel_err"] > ZOO_DP_NORM_RTOL, (name, o["control"])


def checkpoint_dir(name, need_bytes):
    """A fresh directory under CKPT_DIR for one phase's checkpoints; fails
    with the free and the needed bytes when the disk holds too little."""
    import shutil
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    free = shutil.disk_usage(CKPT_DIR).free
    if free < 1.2 * need_bytes:
        raise RuntimeError(f"{name}: {free / 1e9:.1f} GB free under {CKPT_DIR}, the phase "
                           f"writes {need_bytes / 1e9:.1f} GB")
    return path


def dir_bytes(path, names=None) -> int:
    """Bytes of the files under `path` (only those named `names`)."""
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file() and (names is None or f.name in names))


def tree_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees if tree is not None
               for t in tree.values())


def model_state_bytes(cfg) -> int:
    """The bytes of a bf16 llama engine's saved state at `cfg`: per
    parameter its bf16 value, f32 master and two f32 Adam moments, with
    the parameters counted on the meta device."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    return (2 + 4 + 4 + 4) * sum(p.numel() for p in
                                 LlamaForCausalLM(cfg, device="meta").parameters())


def train_checkpoint(report, first):
    """llama-1b at full width and depth on one rank: `train`'s engine
    (`first`, after its steps) saves, then takes CKPT_STEPS more steps on
    `train`'s batch; a fresh engine from other weights loads the save and
    takes the same steps, whose losses, grad norms and parameter digest
    must equal the first engine's, with K1's launches of `train`'s steps;
    the control, a step of the fresh engine before the load, must differ
    (and the load must undo it). `zero_to_fp32` of the save must equal the
    master at the save, bit for bit. Releases `first`."""
    import shutil

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_config, llama_loss_fn
    from deepspeed_tpu_torch.runtime.checkpointing import zero_to_fp32
    cfg = llama_config("llama-1b", remat=True, remat_policy="nothing")
    st = first.state
    need = tree_bytes(st.params, st.master, st.opt_state.exp_avg, st.opt_state.exp_avg_sq)
    root = checkpoint_dir("train_checkpoint", need + tree_bytes(st.master))   # + fp32.pt
    batch = {"input_ids": train_rows(cfg)}

    def steps(e, n):
        return [(float(e.train_batch(batch=batch)), e.get_global_grad_norm()) for _ in range(n)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    steps_before = first.global_steps
    master = param_digest(first.state.master)
    path, save_s = timed(lambda: first.save_checkpoint(root))
    saved = dir_bytes(path)
    want = steps(first, CKPT_STEPS)
    want_digest = param_digest(first.state.params)
    del first, st
    gc.collect()
    torch.cuda.empty_cache()
    _, fp32_s = timed(lambda: zero_to_fp32(root, root / "fp32.pt"))
    fp32_digest = param_digest(torch.load(root / "fp32.pt", mmap=True, weights_only=True))
    assert fp32_digest == master, "zero_to_fp32 is not the master at the save"
    model = llama(cfg, SEED + 33)
    resumed, *_ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG,
                                                 loss_fn=llama_loss_fn(model))
    del model
    missed = steps(resumed, 1)          # the control: the fresh engine before the load
    _, load_s = timed(lambda: resumed.load_checkpoint(root))
    zero_launches()
    got = steps(resumed, CKPT_STEPS)
    launches = read_launches()
    got_digest = param_digest(resumed.state.params)
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    L = cfg.num_hidden_layers
    per_step = {"flash_attention_fwd": 2 * L * GAS, "flash_attention_bwd_dq": L * GAS,
                "flash_attention_bwd_dkv": L * GAS}
    assert got == want and got_digest == want_digest, (got, want)
    assert launches == only(**{k: n * CKPT_STEPS for k, n in per_step.items()}), launches
    assert missed[0] != want[0], (missed, want)
    report["train_checkpoint"] = dict(
        card=report["card"], model=f"llama-1b (`train`'s engine, random bf16 weights, seed "
                                   f"{SEED + 30}; the resuming engine built from seed "
                                   f"{SEED + 33})",
        config=TRAIN_CONFIG, seq=SEQ, steps_before=steps_before, steps_after=want,
        resumed_steps=got, bitwise=True, control_first_step=missed[0],
        saved_bytes=saved, save_s=save_s, save_gb_per_s=saved / save_s / 1e9,
        load_s=load_s, load_gb_per_s=saved / load_s / 1e9,
        load_read="warm: the files were written by this process a moment before",
        zero_to_fp32_s=fp32_s, zero_to_fp32_equals_master=True,
        launches=launches, launches_per_train_batch=per_step)
    log(f"train_checkpoint ({report['card']}): saved {saved / 1e9:.2f} GB in {save_s:.1f} s "
        f"({saved / save_s / 1e9:.2f} GB/s), loaded in {load_s:.1f} s "
        f"({saved / load_s / 1e9:.2f} GB/s, warm), zero_to_fp32 {fp32_s:.1f} s; resumed "
        f"steps bitwise equal")
    return launches


def sparse_layout(kind, h, s, block):
    """The layouts of SPARSE_SHAPES, from the port's sparsity configs (a
    seeded numpy draw for the masked-row case)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig, FixedSparsityConfig)
    if kind == "bslongformer":
        return BSLongformerSparsityConfig(num_heads=h, block=block).make_layout(s)
    if kind == "bigbird":
        return BigBirdSparsityConfig(num_heads=h, block=block,
                                     attention="unidirectional").make_layout(s)
    if kind == "fixed":
        return FixedSparsityConfig(num_heads=h, block=block).make_layout(s)
    n = s // block
    layout = np.random.default_rng(SEED + 80).random((h, n, n)) < 0.4
    layout[:, :, 0] = True
    layout[0, 0, :] = False      # head 0's first query block sees only the last key block
    layout[0, 0, n - 1] = True
    return layout


def live_work(layout, causal):
    """(live (query block, key block) pairs, distinct live key blocks) of a
    layout over its heads: the blocks K7 reads, for the bound."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import padded_layout_indices
    idx, nlive = padded_layout_indices(layout)
    live = np.arange(idx.shape[-1])[None, None] < nlive[..., None]
    if causal:
        live &= idx <= np.arange(idx.shape[1])[None, :, None]
    distinct = sum(len(np.unique(idx[h][live[h]])) for h in range(idx.shape[0]))
    return int(live.sum()), distinct


def check_sparse(gen, name, b, s, h, d, block, kind, causal):
    """K7 against its plain version (bf16, KERNEL_TOL); its bound reads q,
    the live K and V blocks once and writes out, against 4·blk²·D
    operations per live block pair; the library yardstick is SDPA with the
    dense boolean mask (one (S, S) plane when the heads share the layout:
    67 MB at 8k), or at 16k (where that mask would take 8.6 GB) SDPA causal
    without a mask, the dense work the sparsity avoids. K7 takes the
    layout's cached longest-first order, as `sparse_attention` does."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bs
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import layout_tensors
    layout = sparse_layout(kind, h, s, block)
    idx, nlive, _, order = layout_tensors(layout, "cuda", block)
    q, k, v = (randn((b, s, h, d), gen) for _ in range(3))
    out = bs.block_sparse_attention(q, k, v, idx, nlive, block, causal, order=order)
    ref = bs.block_sparse_attention_plain(q, k, v, idx, nlive, block, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert out.shape == q.shape and torch.isfinite(out).all() and err <= KERNEL_TOL, (name, err)
    if kind == "masked_row":
        assert (out[:, :block, 0] == 0).all(), name
    pairs, distinct = live_work(layout, causal)
    nbytes = (q.numel() + out.numel()) * 2 + b * distinct * block * d * 2 * 2
    bound_ms, bound_by = bound(nbytes, 4.0 * block * block * d * pairs * b)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if s <= 8192:  # one plane when every head shares the layout, else one a head
        planes = layout[:1] if (layout == layout[:1]).all() else layout
        mask = torch.from_numpy(np.kron(planes, np.ones((block, block), bool))).cuda()
        if causal:
            mask &= torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
        library = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[None]))
        library_note = "SDPA with the dense boolean block mask"
        del mask
    else:
        library = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
        library_note = "SDPA causal, no mask: the dense work the sparsity avoids"
    row = dict(shape=f"{name}: B={b} S={s} H={h} D={d} block={block} Kmax={idx.shape[-1]} "
                     f"live_pairs={pairs * b} density={layout.mean():.4f}",
               max_abs_err=err, ms=cuda_ms(lambda: bs.block_sparse_attention(
                   q, k, v, idx, nlive, block, causal, order=order)),
               plain_ms=cuda_ms(lambda: bs.block_sparse_attention_plain(
                   q, k, v, idx, nlive, block, causal), iters=3, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library,
               library_note=library_note)
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    return row


def sparse_path(report):
    """The sparse path: `SparseSelfAttention` forward and backward at shape
    (a), K7 in the forward (counted), the gather path's gradient in the
    backward; output and q/k/v gradients against autograd of the gather path
    (`impl="reference"`) on the card, relative to max |ref|."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, SparseSelfAttention, sparse_attention)
    name, b, s, h, d, block, _, causal = SPARSE_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    q, k, v = (randn((b, s, h, d), gen).requires_grad_() for _ in range(3))
    g = randn((b, s, h, d), gen)
    attn = SparseSelfAttention(BigBirdSparsityConfig(num_heads=h, block=block,
                                                     attention="unidirectional"))
    zero_launches()
    out = attn(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == only(block_sparse_attention=1), launches
    layout = attn.config.make_layout(s)

    def gather_path(q, k, v, causal):
        return sparse_attention(q, k, v, layout, block=block, causal=causal, impl="reference")
    ref = gather_path(q, k, v, causal=causal)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    errs = {n: rel_max_err(a, r) for n, a, r in zip(("out", "dq", "dk", "dv"),
                                                    (out, *grads), (ref, *ref_grads))}
    assert all(torch.isfinite(t).all() for t in (out, *grads)) \
        and max(errs.values()) <= KERNEL_TOL, errs

    def fwd_bwd(fn):
        o = fn(q, k, v, causal=causal)
        torch.autograd.grad(o, (q, k, v), g)
    report["sparse_path"] = dict(
        shape=f"{name}: B={b} S={s} H={h} D={d} block={block}", rel_max_err=errs,
        launches=launches, fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(attn), iters=5, warmup=1),
        reference_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(gather_path), iters=5, warmup=1))
    del q, k, v, g, out, ref, grads, ref_grads
    torch.cuda.empty_cache()
    return launches


def check_gmm_bwd(gen, name, k, n, sizes):
    """K6-bwd: dlhs (M, K) = grad @ rhs[g]^T and drhs (G, K, N) = lhs^T @
    grad per group against their plain versions, relative to max |ref|; an
    empty group's drhs slab must be exact zeros, and a second call on the
    same inputs must give the same bits (no atomics; drhs's split ranges
    are summed in a fixed order). Bounds: dlhs reads grad,
    the weights of the groups with rows and writes (M, K); drhs reads lhs
    and grad and writes the whole (G, K, N); each 2·M·K·N operations. The
    library: `torch._grouped_mm` on grad and rhs transposed (dlhs), and
    its K-grouped form on lhs^T and grad (drhs)."""
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    m, g = int(sizes.sum()), sizes.numel()
    lhs, grad = randn((m, k), gen), randn((m, n), gen)
    rhs = (torch.randn((g, k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    used = int((sizes > 0).sum())
    rows = {}
    for kind, fn, plain, args, operands, nbytes in (
            ("dlhs", gg.grouped_gemm_dlhs, gg.grouped_gemm_dlhs_plain, (grad, rhs, sizes),
             (grad, rhs.transpose(-2, -1)), m * n * 2 + used * k * n * 2 + g * 4 + m * k * 2),
            ("drhs", gg.grouped_gemm_drhs, gg.grouped_gemm_drhs_plain, (lhs, grad, sizes),
             (lhs.t(), grad), m * k * 2 + m * n * 2 + g * 4 + g * k * n * 2)):
        out, again, ref = fn(*args), fn(*args), plain(*args)
        torch.cuda.synchronize()
        err = rel_max_err(out, ref)
        assert torch.isfinite(out).all() and err <= KERNEL_TOL, (name, kind, err)
        assert torch.equal(out, again), (name, kind, "two calls differ")
        if kind == "drhs":
            assert all((out[e] == 0).all() for e in (sizes == 0).nonzero().flatten().tolist())
        bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
        library, library_err, library_note = grouped_mm_library(operands, sizes, ref)
        rows[kind] = dict(
            max_abs_err=(out.float() - ref.float()).abs().max().item(), rel_max_err=err,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: plain(*args), iters=3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library,
            library_rel_max_err=library_err, library_note=library_note)
        del out, again, ref
    del lhs, grad, rhs
    torch.cuda.empty_cache()
    return dict(shape=f"{name}: M={m} K={k} N={n} G={g} groups_with_rows={used} "
                      f"sizes_min={int(sizes.min())} sizes_max={int(sizes.max())}",
                calls_bitwise_equal=True,
                grouped_gemm_bwd_dlhs=rows["dlhs"], grouped_gemm_bwd_drhs=rows["drhs"])


def gmm_bwd_cases(gen):
    """K6-bwd at the training shapes: Qwen1.5-MoE (one micro-batch of 2048
    tokens, top-4 of 60: M = 8192) gate/up and down, Mixtral-8x7B w1 (2048
    tokens, top-2 of 8: M = 4096), a skewed Qwen routing (one expert holds
    2,048 of the 8,192 rows: drhs splits its rows), and odd layouts."""
    qwen = routing_sizes(gen, MOE_MBS * MOE_SEQ, 60, 4)
    mixtral = routing_sizes(gen, 2048, 8, 2)

    def sizes(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")
    return [check_gmm_bwd(gen, "qwen train gate/up", 2048, 1408, qwen),
            check_gmm_bwd(gen, "qwen train down", 1408, 2048, qwen),
            check_gmm_bwd(gen, "mixtral w1", 4096, 14336, mixtral),
            check_gmm_bwd(gen, "qwen skewed gate/up", 2048, 1408, skewed_sizes(gen)),
            check_gmm_bwd(gen, "empty first and last groups", 1408, 2048,
                          sizes([0, 300, 0, 77, 211, 0])),
            check_gmm_bwd(gen, "one group holds every row", 2048, 1408, sizes([0, 0, 517, 0])),
            check_gmm_bwd(gen, "M = 5", 40, 24, sizes([2, 0, 3]))]


def kernel_shares(kernels, steps):
    """Device ms per step and share of the port's kernels in a profile
    (`device_kernels`), by the kernels' names."""
    def which(name):
        if "tgmm_kernel" in name or "drhs_reduce_kernel" in name:
            return "grouped_gemm_drhs"
        if "gmm_kernel" in name:
            return "grouped_gemm_dlhs" if ("true>" in name or "Lb1E" in name) \
                else "grouped_gemm"
        for key, label in (("flash_fwd_kernel", "flash_attention_fwd"),
                           ("flash_bwd_dq_kernel", "flash_attention_bwd_dq"),
                           ("flash_bwd_dkv_kernel", "flash_attention_bwd_dkv")):
            if key in name:
                return label
        return None
    busy = sum(us for us, _ in kernels.values())
    out = {}
    for name, (us, _) in kernels.items():
        label = which(name)
        if label is not None:
            out[label] = out.get(label, 0.0) + us
    return {label: dict(ms_per_step=us / steps / 1e3, device_share=us / busy if busy else None)
            for label, us in out.items()}


def train_moe(report):
    """The MoE training main path: Qwen1.5-MoE-A2.7B at full width and
    QWEN_TRAIN_LAYERS layers, random bf16 weights, `dispatch_impl="gmm"`,
    through `initialize` → `train_batch`: one warm-up and MOE_STEPS timed
    steps on one batch (launches counted), a profile of one step, then
    MOE_AUTO_STEPS timed steps of the same engine with `dispatch_impl="auto"`
    (the ragged buffer in training) after one warm-up."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.qwen2_moe import (
        Qwen2MoeForCausalLM, qwen2_moe_config, qwen2_moe_loss_fn)
    cfg = qwen2_moe_config(QWEN_MOE, num_hidden_layers=QWEN_TRAIN_LAYERS, dispatch_impl="gmm",
                           remat=True, remat_policy="nothing")
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    model = moe_model(Qwen2MoeForCausalLM, cfg, SEED + 70)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=MOE_TRAIN_CONFIG,
                                                loss_fn=qwen2_moe_loss_fn(model))
    acc = engine.accelerator
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (MOE_GAS * MOE_MBS, MOE_SEQ),
                                        generator=gen, device="cuda")}
    t0 = time.perf_counter()
    engine.train_batch(batch=batch)                      # warm-up
    acc.synchronize()
    warmup_s = time.perf_counter() - t0

    def timed(n):
        steps = []
        t0 = time.perf_counter()
        for _ in range(n):
            ts = time.perf_counter()
            loss = float(engine.train_batch(batch=batch))
            steps.append(dict(loss=loss, grad_norm=engine.get_global_grad_norm(),
                              step_s=time.perf_counter() - ts))
        return steps, (time.perf_counter() - t0) / n

    acc.reset_peak_memory_stats()
    zero_launches()
    steps, step_s = timed(MOE_STEPS)
    launches = read_launches()
    peak = acc.max_memory_allocated()
    L, micros = cfg.num_hidden_layers, MOE_GAS
    # remat runs each block's forward again in backward: K6 and K1-fwd twice
    per_step = {"grouped_gemm": 2 * 3 * L * micros, "grouped_gemm_dlhs": 3 * L * micros,
                "grouped_gemm_drhs": 3 * L * micros, "flash_attention_fwd": 2 * L * micros,
                "flash_attention_bwd_dq": L * micros, "flash_attention_bwd_dkv": L * micros}
    assert launches == only(**{k: n * MOE_STEPS for k, n in per_step.items()}), launches
    losses = [st["loss"] for st in steps]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    tokens = MOE_GAS * MOE_MBS * MOE_SEQ
    n_total = engine.total_params
    expert_p = 3 * cfg.hidden_size * cfg.moe_intermediate_size * cfg.num_experts * L
    active = n_total - expert_p + expert_p * cfg.num_experts_per_tok / cfg.num_experts
    flops_per_token = 6.0 * active + 6.0 * L * cfg.hidden_size * MOE_SEQ
    peak_tflops = acc.peak_tflops("bfloat16")
    mfu = tokens / step_s * flops_per_token / (peak_tflops * 1e12)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    profile_ = profile_summary(None, 1, wall_us, kernels)
    profile_["port_kernels"] = kernel_shares(kernels, 1)

    for layer in engine.module.layers:
        layer.mlp.dispatch_impl = "auto"
    engine.train_batch(batch=batch)                      # warm-up of the ragged buffer
    zero_launches()
    auto_steps, auto_step_s = timed(MOE_AUTO_STEPS)
    auto_launches = read_launches()
    assert auto_launches["grouped_gemm"] == auto_launches["grouped_gemm_drhs"] == 0, auto_launches
    del engine, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    report["train_moe"] = dict(
        card=report["card"], model=f"{QWEN_MOE} at {L} of 24 layers (random bf16 weights, "
                                   f"seed {SEED + 70}), dispatch_impl='gmm'",
        params=n_total, active_params=active, config=MOE_TRAIN_CONFIG, seq=MOE_SEQ,
        tokens_per_step=tokens, warmup_s=warmup_s, steps=steps, step_s=step_s,
        tokens_per_s=tokens / step_s, flops_per_token=flops_per_token,
        peak_tflops_datasheet=peak_tflops, mfu_active=mfu, peak_memory_bytes=peak,
        allocated_before_bytes=allocated_before, launches=launches,
        launches_per_train_batch=per_step, profile=profile_,
        auto=dict(dispatch="ragged (auto in training)", steps=auto_steps, step_s=auto_step_s,
                  tokens_per_s=tokens / auto_step_s,
                  mfu_active=tokens / auto_step_s * flops_per_token / (peak_tflops * 1e12),
                  launches=auto_launches),
        gmm_over_auto_step_time=step_s / auto_step_s)
    return launches


def train_moe_reference(report):
    """Two layers of Qwen1.5-MoE-A2.7B at full width in bf16 on the card:
    the gradients of one GAS window (2 micro-batches of 2048 tokens) of
    `qwen2_moe_loss_fn` through the grouped GEMM (K6, dlhs, drhs) against
    the same window through the ragged buffer, on the same weights and
    tokens, with the routing-flip share between the two; and a control
    whose drhs is fed the group sizes rolled by one."""
    from deepspeed_tpu_torch.models.qwen2_moe import (
        Qwen2MoeForCausalLM, qwen2_moe_config, qwen2_moe_loss_fn)
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    cfg = qwen2_moe_config(QWEN_MOE, num_hidden_layers=2, remat=False)
    model = moe_model(Qwen2MoeForCausalLM, cfg, SEED + 72)
    loss_fn = qwen2_moe_loss_fn(model)
    params = dict(model.named_parameters())
    ids = torch.randint(0, cfg.vocab_size, (2, 1, MOE_SEQ), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 73))

    def window(impl):
        for layer in model.layers:
            layer.mlp.dispatch_impl = impl
        model.zero_grad(set_to_none=True)
        routing = []
        for micro in ids:
            recorder = RoutingRecorder(model)
            loss, _ = loss_fn(model, {"input_ids": micro})
            (loss / len(ids)).backward()
            routing += recorder.take()
            recorder.remove()
        torch.cuda.synchronize()
        return {key: params[key].grad.float() for key in MOE_GRAD_KEYS}, routing

    def errs(got, ref):
        return {key: ((got[key] - ref[key]).norm() / ref[key].norm()).item()
                for key in MOE_GRAD_KEYS}

    zero_launches()
    gmm, gmm_routing = window("gmm")
    launches = read_launches()
    L = cfg.num_hidden_layers
    assert launches == only(grouped_gemm=3 * L * 2, grouped_gemm_dlhs=3 * L * 2,
                            grouped_gemm_drhs=3 * L * 2, flash_attention_fwd=L * 2,
                            flash_attention_bwd_dq=L * 2, flash_attention_bwd_dkv=L * 2), launches
    ragged, ragged_routing = window("ragged")
    rel = errs(gmm, ragged)
    flips = flip_share(gmm_routing, ragged_routing)
    real = gg.grouped_gemm_drhs

    def rolled(lhs, grad, sizes):
        return real(lhs, grad, torch.roll(sizes, 1))
    rolled.launches = 0    # the wrapper counts its launch on the name it is called by
    gg.grouped_gemm_drhs = rolled
    try:
        control, _ = window("gmm")
    finally:
        gg.grouped_gemm_drhs = real
    control_rel = errs(control, ragged)
    log(json.dumps(dict(train_moe_reference=dict(rel=rel, flips=flips, control=control_rel))))
    gate("train_moe_reference gmm vs ragged gradients", max(rel.values()), TRAIN_MOE_GRAD_RTOL,
         max(control_rel.values()), flips)
    del model, params, gmm, ragged, control
    gc.collect()
    torch.cuda.empty_cache()
    report["train_moe_reference"] = dict(
        layers=L, micro_batches=2, seq=MOE_SEQ, grad_rel_rms_err=rel,
        routing_flip_share=flips, rolled_drhs_sizes_control_rel_rms_err=control_rel,
        launches=launches)


def moe_dp_model_config(dispatch):
    from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config
    return qwen2_moe_config(QWEN_MOE, num_hidden_layers=MOE_DP_LAYERS, dispatch_impl=dispatch,
                            remat=True, remat_policy="nothing")


def moe_dp_rows(rank=None):
    """`train_moe_zero`'s global batch, DP x MOE_DP_MBS rows of MOE_SEQ
    tokens, or rank `rank`'s rows of it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    rows = torch.randint(0, moe_dp_model_config("gmm").vocab_size, (DP * MOE_DP_MBS, MOE_SEQ),
                         generator=gen, device="cuda")
    return rows if rank is None else rows[rank * MOE_DP_MBS:(rank + 1) * MOE_DP_MBS]


def moe_dp_step(config, dispatch, rows):
    """One `train_batch` of the MOE_DP_LAYERS-layer Qwen1.5-MoE (random bf16
    weights, seed SEED + 80) on `rows`: loss, aux loss, the global count of
    dropped (token, slot) assignments, grad norm, step seconds, the peak
    memory, launches, gloo's calls, bytes and seconds, the parameters'
    digest and each router's top-k experts of this process's tokens."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM, qwen2_moe_loss_fn
    cfg = moe_dp_model_config(dispatch)
    model = moe_model(Qwen2MoeForCausalLM, cfg, SEED + 80)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                loss_fn=qwen2_moe_loss_fn(model))
    del model
    recorder = RoutingRecorder(engine.module)
    seen, loss_fn = [], engine.loss_fn
    tokens = engine.dp * rows.numel() * cfg.num_experts_per_tok   # the global assignments

    def recording(module, batch, rng=None):
        loss, aux = loss_fn(module, batch, rng)
        seen.append((float(aux["moe_aux_loss"].detach()), float(aux["router_drop"].sum()) * tokens,
                     [t.cpu() for t in recorder.take()]))
        return loss, aux

    engine.loss_fn = recording
    comm.reset_comm_stats()
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(engine.train_batch(batch={"input_ids": rows}))
    torch.cuda.synchronize()
    out = dict(loss=loss, aux_loss=float(np.mean([a for a, _, _ in seen])),
               dropped=round(sum(d for _, d, _ in seen)), grad_norm=engine.get_global_grad_norm(),
               step_s=time.perf_counter() - t0, peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches=read_launches(), comm=comm.comm_stats(),
               digest=param_digest(engine.gathered_params()),
               routing=[r for _, _, r in seen])
    recorder.remove()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_moe_zero(report):
    """Qwen1.5-MoE at full width and MOE_DP_LAYERS layer trained over dp = 2,
    one step of each of MOE_DP_RUNS in `train_zero`'s ranks after their
    other runs (`zero_rank`), against the one-rank step on the same global
    batch (module docstring, 9g), and the control: one rank on rank 0's
    rows alone."""
    gc.collect()
    torch.cuda.empty_cache()
    one = dict(MOE_DP_CONFIG, train_micro_batch_size_per_gpu=DP * MOE_DP_MBS,
               zero_optimization={"stage": 0})
    ref = moe_dp_step(one, "gmm", moe_dp_rows())
    control = moe_dp_step(dict(one, train_micro_batch_size_per_gpu=MOE_DP_MBS), "gmm",
                          moe_dp_rows(0))
    ranks = ZERO_RANKS
    ranks_s = max(r["moe_zero_s"] for r in ranks)
    report.setdefault("phase_s", {})["train_moe_zero_ranks"] = ranks_s
    print(f"phase train_moe_zero (in train_zero's ranks): {ranks_s:.1f} s", flush=True)
    L, k = MOE_DP_LAYERS, moe_dp_model_config("gmm").num_experts_per_tok
    # remat runs each block's forward again in backward: K6 and K1-fwd twice
    gmm = {"grouped_gemm": 2 * 3 * L, "grouped_gemm_dlhs": 3 * L, "grouped_gemm_drhs": 3 * L,
           "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
           "flash_attention_bwd_dkv": L}
    ragged = {n: c for n, c in gmm.items() if n.startswith("flash")}
    assert ref["launches"] == only(**gmm), ref["launches"]
    runs = {}
    for (stage, dispatch), r0, r1 in zip(MOE_DP_RUNS, *(r["moe_zero"] for r in ranks)):
        assert r0["digest"] == r1["digest"], (stage, dispatch)
        assert r0["loss"] == r1["loss"] and r0["dropped"] == r1["dropped"], (stage, dispatch)
        routing = [torch.cat([a, b]) for a, b in zip(r0["routing"][0], r1["routing"][0])]
        flips = flip_share(routing, ref["routing"][0])
        flipped = round(flips * ref["routing"][0][0].shape[0] * L)
        errs = dict(loss=abs(r0["loss"] - ref["loss"]) / abs(ref["loss"]),
                    aux_loss=abs(r0["aux_loss"] - ref["aux_loss"]) / abs(ref["aux_loss"]),
                    grad_norm=abs(r0["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"]))
        assert errs["loss"] <= TRAIN_REF_LOSS_RTOL and errs["aux_loss"] <= TRAIN_REF_LOSS_RTOL \
            and errs["grad_norm"] <= TRAIN_REF_NORM_RTOL, (stage, dispatch, errs, flips)
        # a flipped token moves at most its k assignments between experts
        assert abs(r0["dropped"] - ref["dropped"]) <= 2 * k * flipped, \
            (stage, dispatch, r0["dropped"], ref["dropped"], flips)
        want = gmm if dispatch == "gmm" else ragged
        for r in (r0, r1):
            assert r["launches"] == only(**want), (stage, dispatch, r["launches"])
        runs[f"stage{stage}_{dispatch}"] = dict(
            rel_err=errs, routing_flip_share=flips, dropped=r0["dropped"],
            dropped_one_rank=ref["dropped"], loss=r0["loss"], aux_loss=r0["aux_loss"],
            grad_norm=r0["grad_norm"], step_s=max(r0["step_s"], r1["step_s"]),
            peak_memory_bytes_per_rank=[r0["peak_memory_bytes"], r1["peak_memory_bytes"]],
            launches_per_rank=[r0["launches"], r1["launches"]],
            gloo_per_step={kind: {f: v[f] for f in ("calls", "bytes", "seconds")}
                           for kind, v in r0["comm"].items()})
    control_err = abs(control["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    assert control_err > TRAIN_REF_NORM_RTOL, (control_err, control["grad_norm"])
    drop = lambda r: {x: r[x] for x in ("loss", "aux_loss", "dropped", "grad_norm", "step_s",
                                        "peak_memory_bytes", "launches")}
    report["train_moe_zero"] = dict(
        card=report["card"], model=f"{QWEN_MOE} at {L} of 24 layers (random bf16 weights, "
                                   f"seed {SEED + 80}) over dp={DP}",
        setup=f"{DP} ranks, one process each, sharing one card over gloo: the collectives "
              "stage through the host and the ranks share the card's compute, so these "
              "times are not a data-parallel speed",
        config=MOE_DP_CONFIG, seq=MOE_SEQ, global_rows=DP * MOE_DP_MBS, ranks_s=ranks_s,
        one_rank=drop(ref), runs=runs,
        control=dict(drop(control), grad_norm_rel_err=control_err,
                     what="one rank trained on rank 0's rows alone"),
        launches_per_rank_per_train_batch=dict(gmm=gmm, auto=ragged))
    log(f"train_moe_zero: {DP} ranks sharing one card over gloo ({report['card']}): " +
        "; ".join(f"{name}: step {v['step_s']:.1f} s, peak "
                  f"{max(v['peak_memory_bytes_per_rank']) / 2**30:.2f} GiB a rank, loss err "
                  f"{v['rel_err']['loss']:.1e}, norm err {v['rel_err']['grad_norm']:.1e}, flips "
                  f"{v['routing_flip_share']:.4f}, dropped {v['dropped']} "
                  f"({v['dropped_one_rank']} on one rank)" for name, v in runs.items()) +
        f"; control norm err {control_err:.3f}")
    return runs


def kernel_row(name, source, replaces, launches, check):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                **{k: check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                **{k: check[k] for k in ("device_ms", "library_device_ms") if k in check})


def phase(report, fn, *args):
    """`fn(report, *args)`, its seconds kept in report["phase_s"] and
    printed."""
    t0 = time.perf_counter()
    out = fn(report, *args)
    seconds = time.perf_counter() - t0
    report.setdefault("phase_s", {})[fn.__name__] = seconds
    print(f"phase {fn.__name__}: {seconds:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card")
        return 2
    from deepspeed_tpu_torch.accelerator import get_accelerator
    smi = get_accelerator().name_and_power_limit()
    if smi is None:
        raise RuntimeError("nvidia-smi is missing: the card's power limit is unknown")
    peak_tflops = get_accelerator().peak_tflops("bfloat16")
    print(smi)
    print(f"{smi}: published dense bf16 peak {peak_tflops} TFLOP/s (data sheet, "
          "the MFU denominator)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "peak_bf16_tflops_datasheet": peak_tflops}
    t_start = time.perf_counter()

    from deepspeed_tpu_torch.op_builder import build_all
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bs
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.ops.cuda import quantized_matmul as qm
    libraries = [fa.LIBRARY, fa.BWD_LIBRARY, da.LIBRARY, pa.DECODE_LIBRARY,
                 pa.ALIBI_DECODE_LIBRARY, pa.PREFILL_LIBRARY, qm.LIBRARY, gg.LIBRARY, bs.LIBRARY]
    t0 = time.perf_counter()
    build_all(libraries)
    report["build_s"] = time.perf_counter() - t0
    report["build_s_by_source"] = {lib.source.name: lib.build_seconds for lib in libraries}
    print(f"built kernels in {report['build_s']:.1f} s "
          f"({json.dumps(report['build_s_by_source'])})", flush=True)
    for lib in libraries:
        log(lib.build_log)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    # K1-fwd: the v1 prefill first (the v1 path's), the causal offset, no
    # mask, then the llama-1b training call (BWD_SHAPES' shape (a))
    tb, ts, _, th, thkv, td, _ = BWD_SHAPES[0]
    flash = [check_flash(gen, True, PROMPT, PROMPT), check_flash(gen, True, 128, 640),
             check_flash(gen, False, PROMPT, PROMPT),
             check_flash(gen, True, ts, ts, h=th, hkv=thkv, b=tb, d=td)]
    decode = check_decode(gen)
    # K3: the main path's staged call first, then unstaged and windowed
    paged_decode = [check_paged_decode(gen, rng, staged=True),
                    check_paged_decode(gen, rng, staged=False),
                    check_paged_decode(gen, rng, staged=True, window=300)]
    paged_prefill = [check_paged_prefill(gen, rng), check_paged_prefill(gen, rng, window=300)]
    flash_bwd = [check_flash_bwd(gen, *shape) for shape in BWD_SHAPES]
    # K5: the decode case of each projection first (the main path's), then
    # prefill, then the odd layouts
    qmm = [check_qmm(gen, m, k, n, 256) for m in (B, B * PROMPT) for k, n in QMM_SHAPES]
    qmm += [check_qmm(gen, *case) for case in QMM_ODD]
    decode_int8 = check_decode(gen, int8=True)
    paged_decode_int8 = [check_paged_decode(gen, rng, staged=True, int8=True),
                         check_paged_decode(gen, rng, staged=False, int8=True),
                         check_paged_decode(gen, rng, staged=True, window=300, int8=True)]
    paged_prefill_int8 = [check_paged_prefill(gen, rng, int8=True),
                          check_paged_prefill(gen, rng, window=300, int8=True)]
    # K6 (the Qwen prefill gate/up call first, the main path's), and K1-fwd
    # and K2 at Qwen1.5-MoE's attention (H = Hkv = 16, GQA group 1)
    gmm = gmm_cases(gen)
    group_one = [check_flash(gen, True, PROMPT, PROMPT, h=16, hkv=16),
                 check_decode(gen, h=16, hkv=16)]
    # K6-bwd at the MoE training shapes (the Qwen gate/up call first, the
    # main path's), and K7 at the sparse shapes ((a) first, the sparse path's)
    gmm_bwd = gmm_bwd_cases(gen)
    sparse = [check_sparse(gen, *shape) for shape in SPARSE_SHAPES]
    # K3-alibi and K4-alibi at bloom-7b1's attention (H = Hkv = 32, D = 128;
    # the Bloom v2 path's staged decode first), over int8 pools, and at
    # bloom-560m's (H = 16, D = 64), each beside its control
    bloom_w, small_w = dict(h=32, hkv=32, d=128, alibi=True), dict(h=16, hkv=16, d=64, alibi=True)
    paged_decode_alibi = [check_paged_decode(gen, rng, staged=True, **bloom_w),
                          check_paged_decode(gen, rng, staged=False, **bloom_w),
                          check_paged_decode(gen, rng, staged=True, int8=True, **bloom_w),
                          check_paged_decode(gen, rng, staged=True, **small_w)]
    paged_prefill_alibi = [check_paged_prefill(gen, rng, **bloom_w),
                           check_paged_prefill(gen, rng, int8=True, **bloom_w),
                           check_paged_prefill(gen, rng, **small_w)]
    # K1-fwd, K2, K3 and K4 at the zoo's widths, phi-2's attention (D = 80)
    # and pythia-1b's (D = 256), each at a GQA group of one: the main paths'
    # calls first (the v1 prefill, K3 staged, K4 without a window)
    zoo_kernels = {d: dict(
        flash=check_flash(gen, True, PROMPT, PROMPT, **w),
        decode=check_decode(gen, **w), decode_int8=check_decode(gen, int8=True, **w),
        paged_decode=[check_paged_decode(gen, rng, staged=True, **w),
                      check_paged_decode(gen, rng, staged=False, **w)],
        paged_decode_int8=[check_paged_decode(gen, rng, staged=True, int8=True, **w),
                           check_paged_decode(gen, rng, staged=False, int8=True, **w)],
        paged_prefill=[check_paged_prefill(gen, rng, **w),
                       check_paged_prefill(gen, rng, window=300, **w)],
        paged_prefill_int8=[check_paged_prefill(gen, rng, int8=True, **w),
                            check_paged_prefill(gen, rng, window=300, int8=True, **w)])
        for d, w in ZOO_WIDTHS.items()}
    # K1-fwd and K1-bwd at the zoo's training calls: phi-2's and pythia-1b's
    # attention at their `train_zoo` micro-batch, S = SEQ, causal
    zoo_train_kernels = {}
    for _, name, _, d in ZOO:
        mbs, w = dict((n, m) for _, n, _, m in ZOO_TRAIN)[name], ZOO_WIDTHS[d]
        zoo_train_kernels[d] = dict(
            flash=check_flash(gen, True, SEQ, SEQ, b=mbs, **w),
            bwd=check_flash_bwd(gen, mbs, SEQ, SEQ, w["h"], w["hkv"], d, True))
    # K8-a..d: each rank's shard of K2, K3, K4 and K5 at Llama-3-8B's serving
    # shapes over tp = 2, against the unsharded kernels' outputs
    sharded = dict(sharded_decode_attention=check_sharded_decode(gen),
                   sharded_paged_decode_attention=check_sharded_paged_decode(gen, rng),
                   sharded_paged_prefill_attention=check_sharded_paged_prefill(gen, rng),
                   sharded_quantized_matmul=check_sharded_qmm(gen))
    # K8-e: each rank's share of K6 over ep = 2 at the MoE shapes (the Qwen
    # prefill gate/up call first, the expert-parallel path's), against K6
    sharded_gmm = sharded_gmm_cases(gen)
    report.update(flash_attention_fwd=flash, decode_attention=decode,
                  paged_decode_attention=paged_decode, paged_prefill_attention=paged_prefill,
                  flash_attention_bwd=flash_bwd, quantized_matmul=qmm,
                  decode_attention_int8=decode_int8,
                  paged_decode_attention_int8=paged_decode_int8,
                  paged_prefill_attention_int8=paged_prefill_int8, grouped_gemm=gmm,
                  attention_group_one=group_one, grouped_gemm_bwd=gmm_bwd,
                  block_sparse_attention=sparse, paged_decode_attention_alibi=paged_decode_alibi,
                  paged_prefill_attention_alibi=paged_prefill_alibi, **sharded,
                  sharded_grouped_gemm=sharded_gmm,
                  zoo_widths={f"d{d}": rows for d, rows in zoo_kernels.items()},
                  zoo_training_shapes={f"d{d}": rows for d, rows in zoo_train_kernels.items()})
    for row in (flash + [decode] + paged_decode + paged_prefill + flash_bwd + qmm
                + [decode_int8] + paged_decode_int8 + paged_prefill_int8 + gmm + group_one
                + gmm_bwd + sparse + paged_decode_alibi + paged_prefill_alibi
                + list(sharded.values()) + sharded_gmm
                + [r for rows in zoo_kernels.values() for v in rows.values()
                   for r in (v if isinstance(v, list) else [v])]
                + [r for rows in zoo_train_kernels.values() for r in rows.values()]):
        print(json.dumps(row), flush=True)
    report["kernel_checks_s"] = time.perf_counter() - t0
    print(f"kernel checks: {report['kernel_checks_s']:.1f} s", flush=True)
    sparse_launches = phase(report, sparse_path)

    from deepspeed_tpu_torch.models.llama import llama_config
    model = llama(llama_config("llama3-8b"), SEED)
    v1_launches = phase(report, serve, model)
    v2_launches, _ = phase(report, serve_v2, model)
    phase(report, serve_v2_shared, model)
    kv_int8_launches, v2_int8_launches = phase(report, serve_kv_int8, model)
    cap_launches, cap_int8_launches, cap_v2_launches = phase(report, serve_capacity, model)
    int8_launches = phase(report, serve_int8, model)     # releases the model's weights
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tp = phase(report, serve_tp)
    phase(report, reference)
    phase(report, reference_int8)
    bloom_launches = phase(report, serve_bloom)
    phase(report, serve_bloom_slot)
    phase(report, reference_bloom)
    zoo_launches = phase(report, serve_zoo)
    moe_launches = phase(report, serve_moe)
    phase(report, reference_moe)
    ep = phase(report, serve_ep)
    train_launches, engine = phase(report, train)
    checkpoint_launches = phase(report, train_checkpoint, engine)
    del engine
    phase(report, train_reference)
    zoo_train_launches = phase(report, train_zoo)
    phase(report, train_zero)
    phase(report, train_zeropp)
    phase(report, train_zoo_zero)
    phase(report, train_mics)
    phase(report, train_onebit)
    moe_train_launches = phase(report, train_moe)
    phase(report, train_moe_reference)
    moe_zero = phase(report, train_moe_zero)
    report["wall_s"] = time.perf_counter() - t_start
    for key in ("serve", "decode_profile", "serve_v2", "v2_decode_profile", "serve_v2_shared",
                "serve_kv_int8", "serve_capacity", "serve_int8", "reference", "reference_v2", "reference_int8",
                "serve_bloom", "bloom_v2_decode_profile", "serve_bloom_slot", "reference_bloom",
                "serve_zoo",
                "serve_moe", "reference_moe", "train", "train_profile", "train_reference",
                "sparse_path", "train_moe", "train_moe_reference", "serve_tp", "reference_tp",
                "serve_ep", "reference_ep", "train_zero", "train_checkpoint", "train_moe_zero",
                "train_zeropp", "train_mics", "train_onebit", "train_zoo", "train_zoo_zero"):
        print(json.dumps({key: report[key]}), flush=True)

    kernels = [
        kernel_row("flash_attention_fwd", "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
                   "deepspeed_tpu/ops/pallas/flash_attention.py:593",
                   v1_launches["flash_attention_fwd"], flash[0]),
        # K1-fwd again at the llama-1b training call, launches from the
        # training main path
        kernel_row("flash_attention_fwd_training_shape",
                   "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
                   "deepspeed_tpu/ops/pallas/flash_attention.py:593",
                   train_launches["flash_attention_fwd"], flash[3]),
        kernel_row("decode_attention", "deepspeed_tpu_torch/csrc/decode_attention.cu",
                   "deepspeed_tpu/ops/pallas/decode_attention.py:103",
                   v1_launches["decode_attention"], decode),
        kernel_row("paged_decode_attention", "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
                   "deepspeed_tpu/ops/pallas/paged_attention.py:159",
                   v2_launches["paged_decode_attention"], paged_decode[0]),
        kernel_row("paged_prefill_attention",
                   "deepspeed_tpu_torch/csrc/paged_prefill_attention.cu",
                   "deepspeed_tpu/ops/pallas/paged_attention.py:366",
                   v2_launches["paged_prefill_attention"], paged_prefill[0]),
        kernel_row("flash_attention_bwd_dq", "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
                   "deepspeed_tpu/ops/pallas/flash_attention.py:425",
                   train_launches["flash_attention_bwd_dq"],
                   flash_bwd[0]["flash_attention_bwd_dq"]),
        kernel_row("flash_attention_bwd_dkv", "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
                   "deepspeed_tpu/ops/pallas/flash_attention.py:425",
                   train_launches["flash_attention_bwd_dkv"],
                   flash_bwd[0]["flash_attention_bwd_dkv"]),
        # K5's row: the decode gate/up projection (M = 4, 4096 x 14336)
        kernel_row("quantized_matmul", "deepspeed_tpu_torch/csrc/quantized_matmul.cu",
                   "deepspeed_tpu/ops/pallas/quantized_matmul.py:146",
                   int8_launches["quantized_matmul"], qmm[2]),
        kernel_row("decode_attention_int8", "deepspeed_tpu_torch/csrc/decode_attention.cu",
                   "deepspeed_tpu/ops/pallas/decode_attention.py:97",
                   kv_int8_launches["decode_attention_int8"], decode_int8),
        kernel_row("paged_decode_attention_int8",
                   "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
                   "deepspeed_tpu/ops/pallas/paged_attention.py:159",
                   v2_int8_launches["paged_decode_attention_int8"], paged_decode_int8[0]),
        kernel_row("paged_prefill_attention_int8",
                   "deepspeed_tpu_torch/csrc/paged_prefill_attention.cu",
                   "deepspeed_tpu/ops/pallas/paged_attention.py:366",
                   v2_int8_launches["paged_prefill_attention_int8"], paged_prefill_int8[0]),
        # K6's row: the Qwen1.5-MoE prefill gate/up call (M = 8192 over 60)
        kernel_row("grouped_gemm", "deepspeed_tpu_torch/csrc/grouped_gemm.cu",
                   "deepspeed_tpu/ops/pallas/grouped_gemm.py:52",
                   moe_launches["grouped_gemm"], gmm[0]),
        # K6-bwd's rows: the Qwen1.5-MoE training gate/up call (M = 8192 over 60)
        kernel_row("grouped_gemm_bwd_dlhs", "deepspeed_tpu_torch/csrc/grouped_gemm.cu",
                   "deepspeed_tpu/ops/pallas/grouped_gemm.py:83",
                   moe_train_launches["grouped_gemm_dlhs"], gmm_bwd[0]["grouped_gemm_bwd_dlhs"]),
        kernel_row("grouped_gemm_bwd_drhs", "deepspeed_tpu_torch/csrc/grouped_gemm.cu",
                   "deepspeed_tpu/ops/pallas/grouped_gemm.py:83",
                   moe_train_launches["grouped_gemm_drhs"], gmm_bwd[0]["grouped_gemm_bwd_drhs"]),
        # K7's row: shape (a), the sparse path's
        kernel_row("block_sparse_attention", "deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
                   "deepspeed_tpu/ops/pallas/block_sparse_attention.py:110",
                   sparse_launches["block_sparse_attention"], sparse[0]),
        # K3-alibi and K4-alibi's rows: bloom-7b1's staged decode and prefill
        # chunk; launches from the Bloom v2 path (traffic A)
        kernel_row("paged_decode_attention_alibi",
                   "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
                   "deepspeed_tpu/ops/pallas/paged_attention.py:141",
                   bloom_launches["paged_decode_attention_alibi"], paged_decode_alibi[0]),
        kernel_row("paged_prefill_attention_alibi",
                   "deepspeed_tpu_torch/csrc/paged_prefill_attention.cu",
                   "deepspeed_tpu/ops/pallas/paged_attention.py:348",
                   bloom_launches["paged_prefill_attention_alibi"], paged_prefill_alibi[0]),
        # K8-a..d's rows: the per-shard calls at tp = 2, launches from the
        # tensor-parallel path (rank 0: v1 decode, v2 traffic A, int8 layer scan)
        kernel_row("sharded_decode_attention", "deepspeed_tpu_torch/csrc/decode_attention.cu",
                   "deepspeed_tpu/ops/pallas/sharded.py:155",
                   tp["v1_launches"]["sharded_decode_attention"],
                   sharded["sharded_decode_attention"]),
        kernel_row("sharded_paged_decode_attention",
                   "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
                   "deepspeed_tpu/ops/pallas/sharded.py:183",
                   tp["v2_launches"]["sharded_paged_decode_attention"],
                   sharded["sharded_paged_decode_attention"]),
        kernel_row("sharded_paged_prefill_attention",
                   "deepspeed_tpu_torch/csrc/paged_prefill_attention.cu",
                   "deepspeed_tpu/ops/pallas/sharded.py:233",
                   tp["v2_launches"]["sharded_paged_prefill_attention"],
                   sharded["sharded_paged_prefill_attention"]),
        kernel_row("sharded_quantized_matmul", "deepspeed_tpu_torch/csrc/quantized_matmul.cu",
                   "deepspeed_tpu/ops/pallas/quantized_matmul.py:226",
                   tp["int8_launches"]["sharded_quantized_matmul_n"]
                   + tp["int8_launches"]["sharded_quantized_matmul_k"],
                   sharded["sharded_quantized_matmul"]),
        # K8-e's row: rank 0 of ep = 2 at the Qwen1.5-MoE prefill gate/up call;
        # launches from the expert-parallel main path (rank 0)
        kernel_row("sharded_grouped_gemm", "deepspeed_tpu_torch/csrc/grouped_gemm.cu",
                   "deepspeed_tpu/ops/pallas/grouped_gemm.py:88",
                   ep["launches"]["sharded_grouped_gemm"], sharded_gmm[0]),
    ]
    # the zoo's widths: each kernel's main-path call at phi-2's (D = 80) and
    # pythia-1b's (D = 256) attention, launches from that model's `serve_zoo`
    # runs (v1, v2 traffic A, and the int8-KV v1 and v2 runs)
    for _, name, _, d in ZOO:
        zk, zl = zoo_kernels[d], zoo_launches[name]
        for kernel, source, replaces, run, check in (
                ("flash_attention_fwd", "flash_attention_fwd.cu", "flash_attention.py:593",
                 "v1", zk["flash"]),
                ("decode_attention", "decode_attention.cu", "decode_attention.py:103", "v1",
                 zk["decode"]),
                ("decode_attention_int8", "decode_attention.cu", "decode_attention.py:97",
                 "v1_int8", zk["decode_int8"]),
                ("paged_decode_attention", "paged_decode_attention.cu", "paged_attention.py:159",
                 "v2", zk["paged_decode"][0]),
                ("paged_decode_attention_int8", "paged_decode_attention.cu",
                 "paged_attention.py:159", "v2_int8", zk["paged_decode_int8"][0]),
                ("paged_prefill_attention", "paged_prefill_attention.cu",
                 "paged_attention.py:366", "v2", zk["paged_prefill"][0]),
                ("paged_prefill_attention_int8", "paged_prefill_attention.cu",
                 "paged_attention.py:366", "v2_int8", zk["paged_prefill_int8"][0])):
            kernels.append(kernel_row(f"{kernel}_d{d}", f"deepspeed_tpu_torch/csrc/{source}",
                                      f"deepspeed_tpu/ops/pallas/{replaces}",
                                      zl[run][kernel], check))
    # the zoo's training calls: K1-fwd and K1-bwd at phi-2's (D = 80) and
    # pythia-1b's (D = 256) attention, launches from that model's `train_zoo`
    # steps; a `train_batch`'s there and on each rank of `train_zoo_zero`
    for _, name, _, d in ZOO:
        zk, zl = zoo_train_kernels[d], zoo_train_launches[name]
        dp_step = report["train_zoo_zero"]["models"][name]["launches_per_rank_per_train_batch"]
        for kernel, check in (("flash_attention_fwd", zk["flash"]),
                              ("flash_attention_bwd_dq", zk["bwd"]["flash_attention_bwd_dq"]),
                              ("flash_attention_bwd_dkv", zk["bwd"]["flash_attention_bwd_dkv"])):
            source = "fwd" if kernel == "flash_attention_fwd" else "bwd"
            row = kernel_row(
                f"{kernel}{'_training_shape' if source == 'fwd' else ''}_d{d}",
                f"deepspeed_tpu_torch/csrc/flash_attention_{source}.cu",
                "deepspeed_tpu/ops/pallas/flash_attention.py:"
                + ("593" if source == "fwd" else "425"), zl[kernel], check)
            row["launches_per_train_batch_by_path"] = dict(
                train_zoo=zl[kernel] // ZOO_TRAIN_STEPS, train_zoo_zero_rank=dp_step[kernel])
            kernels.append(row)
    # the training paths beyond the main one: per train_batch of
    # `train_checkpoint`'s resumed engine, and of each rank of
    # `train_zero` and `train_moe_zero` (rank 0, the stage 0 gmm run)
    zero_per_step = report["train_zero"]["launches_per_rank_per_train_batch"]
    moe_zero_runs = moe_zero["stage0_gmm"]["launches_per_rank"][0]
    for row in kernels:
        name = row["name"].replace("_training_shape", "")
        paths = {}
        if row["name"] in ("flash_attention_fwd_training_shape", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"):
            zeropp = report["train_zeropp"]["runs"]
            paths = dict(train=train_launches[name] // TRAIN_STEPS,
                         train_checkpoint=checkpoint_launches[name] // CKPT_STEPS,
                         train_zero_rank=zero_per_step[name],
                         train_moe_zero_rank=moe_zero_runs[name],
                         **{f"train_zeropp_{run}_rank": zeropp[run]["launches_per_rank"][name]
                            // ZERO_STEPS for run in zeropp},
                         train_mics_rank=report["train_mics"][
                             "launches_per_rank_per_train_batch"][name],
                         train_onebit_rank=report["train_onebit"][
                             "launches_per_rank_per_train_batch"][name])
        elif row["name"] in ("grouped_gemm", "grouped_gemm_bwd_dlhs", "grouped_gemm_bwd_drhs"):
            key = {"grouped_gemm_bwd_dlhs": "grouped_gemm_dlhs",
                   "grouped_gemm_bwd_drhs": "grouped_gemm_drhs"}.get(name, name)
            paths = dict(train_moe=moe_train_launches[key] // MOE_STEPS,
                         train_moe_zero_rank=moe_zero_runs[key])
        if paths:
            row["launches_per_train_batch_by_path"] = paths
    # K2 and K5 on the layer-streamed paths (`serve_capacity`): v1 capacity
    # (bf16, then int8) and v2 capacity on slot rows (int8)
    for row in kernels:
        if row["name"] in ("decode_attention", "quantized_matmul"):
            row["launches_by_path"] = {
                "serve_capacity_bf16": cap_launches[row["name"]],
                "serve_capacity_int8": cap_int8_launches[row["name"]],
                "serve_capacity_v2": cap_v2_launches[row["name"]]}
    assert all(k["launches"] > 0 for k in kernels), kernels
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
