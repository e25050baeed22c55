#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device  — a CUDA card is required (no CPU fallback); prints its name and
               ``nvidia-smi``'s name and power limit.  TF32 is switched off
               for matmuls and cuDNN, so float32 plain versions are exact
               float32 references.
  2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
               (one nvcc per source, all at once); prints build seconds and
               ptxas registers / shared memory.
  3. kernels — each kernel against its plain PyTorch version on the card:
               flash attention at the serving path's shape, at
               deepseek-moe-16b's (MHA 16 / 16, head_dim 128), at
               zamba2-2.7b's (MHA 32 / 32, head_dim 80, bf16 and float32,
               with ragged S, GQA and windowed head_dim 80 cases) and at MHA
               / MQA / GQA-8 / ragged / non-causal / windowed / other
               head-dim cases,
               at the wgmma kernel's tile edges (S 1, 127, 129, 300 with
               windows 48 and 200) and on views of a fused qkv projection,
               non-causal with Sq != Skv at whisper-base's encoder (B 16,
               1500 x 1500, 8 / 8 heads of 64) and cross (224 x 1500)
               shapes and at (Sq, Skv) (224, 1500), (1500, 224), (1,
               1500), (129, 63), (300, 1) for bf16 head_dim 64 / 128 / 80
               and float32, with GQA cases, at phi-3-vision-4.2b's shape
               (B 4, S 2048, MHA 32 / 32, head_dim 96) and nemotron-4-340b's
               heads (B 1, S 2048, 96 / 8 of 192), and at head_dim 96 and
               192 with S 1, 127, 129, 300 (GQA 4), a window of 48, Sq x
               Skv 224 x 1500 and 1 x 1500 non-causal and fused-projection
               views, in bf16 and float32, each on the mma kernel (the
               built library's dispatch is held to name it too),
               on both kernels of the source (bf16 within one bf16 ulp of the
               output, float32 1e-4); the segment
               max at the lane engine's dispatch shapes, empty segments and
               values, ties and negatives, int64 extremes and one
               1,000,000-value segment, on CUDA tensors and through the
               engines' numpy route, bit-exact against its plain version
               and numpy; the fused RWKV6 recurrence from raw q / k / v /
               log decay (a bonus on the exclusive cases) at the serving
               path's shape (B·H 160, T 2048, K = V = 64, chunk 16, with and
               without an initial state) and at every K / V in {8, ..., 128},
               chunks 1 to 64 (12 and 7 among them) and mask kind, float32
               output and final state within 1e-4; then the path's case in
               bf16 from the model's split_heads views, output within one
               bf16 ulp; each case logs the VB and loads it took; then the
               recurrence as zamba2's Mamba2 blocks call it (float32,
               inclusive, B·H 160, T 2048, K 64, V 128, chunk 16, q
               broadcast over the heads), output and S within 1e-4.
  4. serve   — full-width tinyllama-1.1b (22 layers, seeded random weights,
               bf16) through ``repro_torch.launch.serve.generate``: prefill of
               4 x 2048 tokens and 32 greedy decode steps.  The kernel must be
               launched once per layer by prefill, never in decode, and the
               other kernels never; prefill must take the wgmma variant.  Then a teacher-forced
               forward over prompt + generated tokens must reproduce the last
               decode logits.  torch.profiler then traces one prefill and 8
               decode steps: wall time, kernel time, device idle share and
               the kernels that take the most device time.
  4c. train — (a) the autograd Functions around the kernels on the card:
               attention (bf16 and float32, head_dim 64 and 32, GQA 32 / 4,
               S 256 and 2048, causal, one windowed case) and the
               recurrence (B·H 8, T 256, K = V = 64, both masks, with and
               without S0): their grads against autograd through the plain
               formulation alone (``blocked_attention``, the chunk scan),
               float32 1e-4, bf16 one bf16 ulp (8e-3 where |g| < 2).
               (b) full-width tinyllama-1.1b training: float32 masters, bf16
               compute, seeded random weights, ``SyntheticSource`` batches
               of 4 x 2048, AdamW float32 state, remat none: every master
               leaf gets a finite grad on the first step's params and
               batch; one step under torch.profiler split by kind
               (attention kernel, the attention backward: the
               ``blocked_attention`` recompute and its grads, GEMMs,
               optimizer, other) with the device idle share; then
               ``repro_torch.launch.train.main`` on a 64-GPU vclos grant on
               CLUSTER512, 2 warm-up and 3 timed steps: ms per step,
               tokens/s, peak memory, loss and grad norm per step, the
               step's bound; the attention kernel must launch 22 times a
               step and every loss must be finite.  (c) checkpoint and
               resume on the card: reduced tinyllama-1.1b and rwkv6-3b in
               float32, ckpt_every 2: 4 steps at once against 2 steps and
               a resumed run to 4; losses of steps 3-4 compared (and
               whether bit-exact); rwkv6 launches the recurrence once per
               layer per step.
  4b. serve-ssm — the same for full-width, full-depth rwkv6-3b (32 layers,
               d_model 2560, seeded random weights, bf16): 4 x 2048 prompt,
               32 greedy decode steps.  The recurrence kernel must be
               launched 32 times per prefill and 32 times by the
               teacher-forced forward, 0 times in decode; flash attention
               and the segment max 0 times.
  4d. serve-moe — the same for full-width, full-depth deepseek-moe-16b (28
               layers, the first dense, d_model 2048, 16 heads of 128, 64
               routed experts top-6 + 2 shared of d_ff 1408; 16.4 B
               parameters held in bf16 from seed 0, the router float32):
               4 x 2048 prompt, 32 greedy decode steps.  Flash attention must
               be launched 28 times per prefill, 0 times in decode, and the
               other kernels never.  Logs the share of (token, choice) pairs
               dropped at capacity 960 and the bounds by part; the
               teacher-forced check runs on the same weights at capacity
               factor 16, where nothing is dropped; the profile adds a "moe
               dispatch" kind.  The model is freed before phase 4e.
  4e. serve-hybrid — the same for full-width, full-depth zamba2-2.7b (54
               Mamba2 blocks of d_inner 5120, 40 SSM heads of 128, state 64;
               one shared attention + gelu MLP block, 32 / 32 heads of 80,
               d_ff 10240, applied after every 6 on concat(h, x0); 2.40 B
               parameters, float32 masters, bf16 compute, seed 0): 4 x 2048
               prompt, 32 greedy decode steps.  A prefill and the
               teacher-forced forward must launch flash attention 9 times
               (mma_sync) and the recurrence 54 times, decode neither, the
               segment max never; teacher forcing within 0.15 / 0.05.  Logs
               the bounds by part (``hybrid_prefill_parts``,
               ``hybrid_decode_bytes``).  The model is freed before phase 4f.
  4f. serve-audio — the same for full-width, full-depth whisper-base (6
               encoder + 6 decoder layers, d_model 512, 8 / 8 heads of 64,
               gelu d_ff 2048, vocab 51865; 97 M parameters, float32
               masters, bf16 compute, seed 0) at 16 requests of 1500 frame
               embeddings (seeded normals, handed over in bf16) and a
               224-token prompt, 32 greedy decode steps, caches of 1536
               rows.  A prefill and the teacher-forced forward must launch
               flash attention 18 times (6 encoder, 6 self, 6 cross, every
               launch wgmma_tma), decode never, the other kernels never;
               teacher forcing within 0.15 / 0.05 in bf16, float32 compute
               recorded beside it.  Logs the bounds by part
               (``audio_prefill_parts``, ``audio_decode_bytes``).  The model
               is freed before phase 4g.
  4g. serve-vlm — the same for full-width, full-depth phi-3-vision-4.2b
               (32 layers, d_model 3072, 32 / 32 heads of 96, gated silu
               d_ff 8192, vocab 32064; 3.83 B parameters with patch_proj,
               float32 masters, bf16 compute, seed 0): 4 x 2048 prompt, 32
               greedy decode steps, served on tokens alone as the reference
               serves it.  A prefill alone, the main run and the
               teacher-forced forward must launch flash attention 32 times,
               every launch mma_sync, decode never, the other kernels
               never; teacher forcing within 0.15 / 0.05 in bf16.  Then the
               patch path (``patch_path``): a forward with 256 bf16 patch
               embeddings (seeded normals) must launch 32 times (mma_sync),
               give finite logits and move every position's logits past
               the patches against the patch-free forward; timed.  Logs the
               bounds by part (``dense_prefill_parts``).  The model is
               freed before phase 5.
  4h. distributed — ranks spawned on the one card and joined with a
               deadline (``repro_torch.testing.run_ranks``); any rank's
               failure, a hang or a missed gate exits non-zero.  (1) The
               collective probe: 4 ranks under gloo on CUDA tensors of
               64 MB: all_reduce, all_gather_into_tensor,
               reduce_scatter_tensor, all_to_all_single and broadcast, each
               checked against its plain expectation and timed ("gloo,
               host-staged, one card": these times measure host staging,
               not NVLink or NCCL).  (2) World size 1 under NCCL: full-width
               tinyllama-1.1b's first-step loss and grads through
               make_context on a (1, 1) mesh, sharded_param_specs and
               make_train_step(ctx=) equal the no-mesh step within 1e-6
               (bit-exactness recorded), 22 attention launches.  (3) FSDP +
               TP on (data 2, model 2), 4 gloo ranks in the rank order of a
               4-GPU vclos grant on CLUSTER512: full-width tinyllama,
               float32 masters drawn into their shards, bf16 compute, AdamW
               float32, remat none, 4 x 2048: the first step's loss within
               1e-2 and grad norm within 1% of (2)'s single rank; 22
               attention launches a rank a step at 16 / 2 local heads;
               finite losses; 2 warm-up and 2 timed steps (ms, tokens/s),
               each rank's peak memory, one step profiled on rank 0 with
               gloo's host staging as its own kind.  (4) Expert parallelism
               on (1, 2), 2 gloo ranks: full-width deepseek-moe-16b cut to
               its dense layer and 3 MoE layers (EP_LAYERS), bf16-held
               weights drawn into their shards one rank at a time, one
               prefill of 4 x 2048 at capacity factor 16 through the
               sequence-sharded dispatch: last-position logits within 1e-2
               of the single-rank forward in float32 compute (bf16
               recorded), one attention launch a layer a rank, 2
               all_to_all_single calls a MoE layer; ms, peaks, a profile.
  5. simulate — the flow-level simulator through ``repro_torch.core`` on
               ``cuda``, its rate resolution in the segment-max kernel
               through the engines' route (``phase_max_host``: one host copy
               into page-locked staging that the kernel reads in place, one
               wait): the golden trace (200 jobs, CLUSTER512, v2 engine) for
               ecmp / sr / best must reproduce the pinned average JCTs and
               the ``cpu`` run's JCTs, with one launch per solve (39 / 36 /
               0); then a 72-lane CLUSTER2048 grid (best / sr / ecmp x seeds
               0-7 x mean interarrival 15 / 30 / 60 s, 400 jobs a lane,
               max_gpus 64) through ``run_lanes``, every report identical to
               the ``cpu`` run, launches equal to solves (795).  Prints wall
               seconds and the host time spent in the solves, in turns, on
               cuda, cpu and two yardsticks (PR 16's route, host numpy),
               the values per call, the split of the cuda run (the calls on
               the device's clock by CUDA events, kernel and copies and
               device idle share under torch.profiler, the rest on the
               host).
  5c. campaign — simulation campaigns through the port's user entry point,
               ``repro_torch.launch.sweep.campaign_main(argv)``, in this
               process (so the launch counters can be read), every report
               written with ``--out`` and compared with the wall-clock keys
               (sim_seconds, wall_time, journal_seconds) dropped: (1) the
               golden grid (CLUSTER512, ecmp / sr / best, 200 jobs,
               max_gpus 256, seed 0) serial on cuda must give the pinned
               average JCTs with 75 launches = 75 solves, and the cpu
               report; (2) the fabric-heavy grid (CLUSTER2048, helios, 400
               jobs, max_gpus 64, best / sr / ecmp x loads 15 / 30 / 60 x
               seeds 0-1: 18 cells) four ways, serial v2 on cuda, serial
               batched on cuda (``run_lanes``), 4 spawned workers on cuda
               and serial v2 on cpu, all four reports identical, launches =
               solves on the serial cuda runs; walls, solves, host time in
               the solves and the serial cuda run's device idle share
               (torch.profiler) logged; (3) fault tolerance on 2 spawned
               card workers on the golden grid: ``REPRO_CHAOS=crash@1:1``
               recovers through isolation to step 1's report, and
               ``crash@1`` with ``--quarantine --journal`` leaves one
               quarantined cell that ``--resume`` (no chaos) merges into
               step 1's report (``resumed_cells`` aside, which counts the
               journal's cells); (4) the alibaba fixture
               (``src/repro_torch/data/alibaba_sample.csv``, 25 jobs) under
               ``--trace-format alibaba`` on cuda and cpu and under
               ``auto`` on cuda, identical, then windowed (``--window 10
               --stride 5``) on cuda and cpu, identical.
  5d. figures — the paper's figures through the port's report, in this
               process (so the launch counters can be read): (1) the six
               smoke figures through ``repro_torch.launch.report.generate``
               into a temporary directory, once on cuda and once on cpu:
               every CSV byte-equal to the committed
               ``docs/assets/<figure>.smoke.csv``, ``check_results`` empty
               on the tables generate built, the cuda tables equal to the
               cpu ones, launches = solves on cuda (the reference makes
               372); without matplotlib the report skips the SVGs; (2)
               jct-vs-load, contention-cdf, ocs-comparison, frag-timeline
               and hetero-interleave at the paper's own sizes on cuda: each
               CSV's sha256 equal to the reference's (``PAPER_FIGURES``),
               ``qualitative_checks`` empty, launches = solves; wall
               seconds and us a solve per figure, and the device idle share
               over contention-cdf (CLUSTER2048) under torch.profiler.
               Paper real-trace is left out.
  5e. schedd — the scheduler service: (1) ``schedd replay --verify`` on
               cuda over the golden trace (ecmp, sr: JCT 13417.8 / 3731.4,
               ``verify: OK``, 78 / 72 launches = solves, as the reference
               counts them) and over the paper's CLUSTER2048 contention
               workload (1500 jobs, max_gpus 1024, λ 40) with an event log
               that, reopened on cpu, lands on the cuda run's version,
               clock and placements; (2) a daemon session
               (``ServerThread`` over ``LiveCluster.open`` on CLUSTER512,
               sr, quota teamA=64) through every op: stats, admit grant and
               quota deny, placed and quota-denied submits, a what-if twice
               (the second a memo hit), a churn event, an advance, a drain,
               an unknown op, shutdown; the log reopened on cpu reaches the
               same version; launches = solves; (3) request latency on
               CLUSTER2048 under sr: the 1500-job trace's first 500 jobs
               submitted in arrival order through one client, a what-if
               (moe, 32 GPUs, sr and ecmp) every 25 submits at a fresh
               version, p50 / p99 ms on cuda and on a cpu service, whose
               final versions and placements must agree.
  6. timing  — each kernel, its plain version and a PyTorch library call
               computing the same function, at the path's shape (CUDA
               events), flash attention at deepseek-moe-16b's,
               zamba2-2.7b's and phi-3-vision-4.2b's shapes and
               nemotron-4-340b's heads too, and at whisper-base's encoder
               and cross shapes (non-causal, SDPA with is_causal=False); the
               attention variant the path took and the ptxas
               report (registers, spills, wgmma serialisation) of each
               attention variant; the segment max at the grid's p50 / p90 /
               max calls: its device time (profiler), the wrapper's issue
               rate back to back, and the round trip numpy -> numpy of the
               engines' route (transfer design (B), zero-copy) against
               design (A), staged through a device scratch, and PR 16's
               route (pageable uploads, synchronising download), both kept
               here as yardsticks only, in turns, with host numpy beside;
               the recurrence at its serving shape in bf16 from split_heads
               views, at the plan the library makes (no single PyTorch call
               computes it, so it has no library time), then at VB 16, 32
               and 64 (each a compile-time instance there) at batch 4 and 1
               (B·H 160 and 40); then the recurrence at the Mamba2 path's
               shape and call (float32 operands, q broadcast over the
               heads, bound with q read once).
The last three lines are ``nvidia-smi``'s name and power limit,
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH, PROMPT, DECODE_STEPS = 4, 2048, 32
# the golden trace (tests/test_campaign.py) and its pinned average JCTs;
# v2 rate-resolution solves per strategy, as the reference counts them
GOLDEN = {"ecmp": 13417.8, "sr": 3731.4, "best": 2949.3}
GOLDEN_SOLVES = {"ecmp": 39, "sr": 36, "best": 0}
# the fabric-heavy lane grid on the paper's large cluster
GRID_STRATEGIES, GRID_SEEDS, GRID_LOADS = ("best", "sr", "ecmp"), range(8), \
    (15.0, 30.0, 60.0)
GRID_JOBS, GRID_MAX_GPUS, GRID_SOLVES = 400, 64, 795
# phase 5c: the campaigns, as argv of ``sweep campaign``
CAMPAIGN_GOLDEN = ["--cluster", "512", "--strategies", "ecmp,sr,best",
                   "--loads", "120", "--seeds", "0", "--jobs", "200",
                   "--max-gpus", "256"]
CAMPAIGN_GRID = ["--cluster", "2048", "--size-mix", "helios", "--max-gpus",
                 "64", "--jobs", "400", "--strategies", "best,sr,ecmp",
                 "--loads", "15,30,60", "--seeds", "0,1"]
CAMPAIGN_GRID_CELLS, CAMPAIGN_WORKERS, CHAOS_WORKERS = 18, 4, 2
ALIBABA_TRACE = ROOT / "src" / "repro_torch" / "data" / "alibaba_sample.csv"
ALIBABA_JOBS = 25
WALL_KEYS = ("sim_seconds", "wall_time", "journal_seconds")
# phase 5d: the paper's figures.  The reference's v2 solves over the six
# smoke figures, and, for the paper-scale figures run here, the sha256 of the
# reference's CSV and its solves, computed on the reference with
#   PYTHONPATH=src python -c 'import hashlib; from repro.core.figures import
#   build_figure; from repro.launch.report import csv_text; print({n:
#   hashlib.sha256(csv_text(build_figure(n, scale="paper")).encode())
#   .hexdigest() for n in ("jct-vs-load", "contention-cdf", "ocs-comparison",
#   "frag-timeline", "hetero-interleave")})'
# (paper real-trace, five windows of a generated 5000-job trace, is left out)
FIGURE_SMOKE_SOLVES = 372
PAPER_FIGURES = {
    "jct-vs-load": (
        "efdcdea674d88ef8d35a4eaa23307c2599b78cb9014e8efc0f9cc1d1edf41815",
        528),
    "contention-cdf": (
        "5d4dce59e55639dc2e07807be6d05f161fa42b13fa814ef544572b27618cc921",
        756),
    "ocs-comparison": (
        "831af4bf80916d6145eb469ccc131497c6e24faf354385a56666c38042564491",
        184),
    "frag-timeline": (
        "93e3e005ce9131b371b34172a5ff57ec173be2917d968ba2c025616ac09af291",
        349),
    "hetero-interleave": (
        "4ed8c8f9b1c09fed3f791f295fd687aea0f13f0c9eef5cf6820a7865e22d50d9",
        90),
}
# phase 5e: the scheduler service.  Replay goldens (JCT, and the v2 solves of
# the live loop plus the offline oracle, as the reference counts them), the
# paper's CLUSTER2048 contention workload (contention-cdf's, as WorkloadSpec
# fields), the jobs the latency run submits and its what-if cadence
SCHEDD_GOLDEN = {"ecmp": (13417.8, 78), "sr": (3731.4, 72)}
SCHEDD_BIG = dict(num_jobs=1500, mean_interarrival=40.0, seed=0,
                  max_gpus=1024)
SCHEDD_LATENCY_JOBS, SCHEDD_WHATIF_EVERY = 500, 25
# (nvals, nseg) at the lane engine's dispatch
# (benchmarks/bench_fairshare.py BATCHED_DISPATCH_SHAPES)
DISPATCH_SHAPES = (("p50", 3345, 62), ("p90", 22652, 398),
                   ("max", 43593, 753))
# the recurrence kernel's shape on the rwkv6-3b serving path: (B, H, T, K, V)
# and the chunk hidden_states picks for a 2048-token prompt (_fit_chunk)
RWKV_PATH, RWKV_CHUNK = (BATCH, 40, PROMPT, 64, 64), 16
# its call from zamba2-2.7b's Mamba2 blocks: 40 heads of 128, ssm_state 64,
# float32 operands, inclusive mask, q broadcast over the heads
MAMBA_PATH = (BATCH, 40, PROMPT, 64, 128)
# zamba2-2.7b's shared attention: 32 / 32 heads of 80
ZAMBA_ATTN = (BATCH, PROMPT, 32, 32, 80)
# whisper-base served (phase 4f): 16 requests of 1500 frame embeddings
# (n_audio_ctx) and a 224-token prompt (n_text_ctx // 2), caches of 1536
# rows so that no frame is trimmed; its attention shapes, (B, Sq, Hq, Hkv,
# hd, Skv): the encoder's (non-causal) and the cross attention's
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT = 16, 1500, 224
WHISPER_MAX_LEN = 1536
WHISPER_ENC = (WHISPER_BATCH, WHISPER_FRAMES, 8, 8, 64, WHISPER_FRAMES)
WHISPER_CROSS = (WHISPER_BATCH, WHISPER_PROMPT, 8, 8, 64, WHISPER_FRAMES)
# phi-3-vision-4.2b served (phase 4g): MHA 32 / 32 heads of 96, and its
# stub frontend's 256 patch embeddings; nemotron-4-340b's attention heads,
# 96 / 8 of 192 (GQA 12), at one sequence
PHI3_ATTN = (BATCH, PROMPT, 32, 32, 96)
PHI3_PATCHES = 256
NEMOTRON_ATTN = (1, PROMPT, 96, 8, 192)
# Published dense peaks of one H100 SXM at its 700 W limit.
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_TF32_FLOPS = 495e12
# the H100 SXM's PCIe Gen5 x16 host link, one way (NVIDIA's data sheet)
PEAK_LINK_BYTES = 64e9
# the recurrence's column blocks timed against each other (each a
# compile-time instance on the path) and the batches they are timed at
RWKV_SWEEP_VBS, RWKV_SWEEP_BATCHES = (16, 32, 64), (BATCH, 1)
# Kernel vs plain: bf16 — both keep P in float32 (the kernel as bf16 hi + lo
# halves), so they differ by the output's own bf16 rounding: one ulp, 8e-3
# where |o| < 2; float32 — the same float32 arithmetic summed in another
# order, with exp from the device library.
BF16_TOL, F32_TOL = 8e-3, 1e-4
# Decode vs teacher-forced forward, bf16 (tests/test_serve.py:60-62); the
# moe family is held at a capacity factor that drops nothing, as the
# reference's test does (tests/test_serve.py:19-23): a forward over B x S
# tokens drops pairs that B-token decode steps keep.
SERVE_ATOL, SERVE_RTOL = 0.15, 0.05
TF_CAPACITY_FACTOR = 16.0
# The moe family's gate runs in float32 compute on the served bf16 weights:
# float32 sums in other orders over 28 layers, far below the ~0.6 a
# differently routed token moves its logits.  In bf16 near-uniform random
# routers leave the k-th and (k + 1)-th choice 1e-5 to 1e-3 apart in
# probability, which the two computations' bf16 rounding crosses (recorded,
# with the routes).
MOE_TF_F32_TOL = 1e-2
# The hybrid family's gate runs in float32 compute from the held float32
# masters, as the moe family's does.  In bf16 each Mamba2 block rounds its
# output by about 1%, and with random weights each block's output moves
# about three times as far as its input does (q = C, k = B·dt and v are
# all projections of it), so the rounding of any two bf16 computations
# grows with depth to logits about 1 apart after 54 blocks: decode against
# the forward, and the bf16 forward against the float32 one alike
# (recorded, with the growth block by block and point by point).
HYBRID_TF_F32_TOL = 1e-2
# Training (phase 4c): full-width tinyllama-1.1b at B x S, warm-up and timed
# steps through repro_torch.launch.train.main on a 64-GPU vclos grant on
# CLUSTER512; then checkpoint / resume of reduced configs, ckpt_every 2.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_TIMED = 4, 2048, 2, 3
TRAIN_GPUS, RESUME_STEPS, RESUME_SPLIT = 64, 4, 2
# profiled device time by kind of kernel (name fragments); the rest is
# PyTorch's elementwise, copy and reduction kernels
KERNEL_KINDS = {"recurrence": ("rwkv6_chunked",), "attention": ("attn_fwd",),
                "segment max": ("segment_max",),
                "gemm": ("nvjet", "gemm", "gemv", "cutlass", "sm90_xmma"),
                "copies": ("Memcpy", "Memset")}
# the moe family's profile adds the dispatch: top-k and its sort, the slot
# cumsum, one_hot (a scatter), the index_add scatter and the gathers (the
# embedding's row gather and the KV cache writes, both small, fall here too)
MOE_KINDS = {**KERNEL_KINDS, "moe dispatch": (
    "TopK", "topk", "Sort", "sort", "scan", "scatter", "gather", "index",
    "compute_cuda_kernel")}
# Phase 4h: ranks sharing the card.  The collective probe's ranks and
# bytes; FSDP + TP tinyllama steps (the 4c batch); deepseek's EP prefill at
# a capacity factor that drops nothing, cut to its dense layer and 3 MoE
# layers: each MoE layer's two all-to-alls carry the E x capacity slot
# blocks (3.2 GB a rank in float32 at factor 16) through gloo's host
# staging
DIST_WORLD, PROBE_BYTES, DIST_WARMUP, DIST_TIMED = 4, 64 << 20, 2, 2
EP_LAYERS, EP_FACTOR = 4, 16.0
# the distributed profiles split gloo's host staging (device <-> host
# copies) from the other copies
DIST_KINDS = {"attention": ("attn_fwd",),
              "gemm": KERNEL_KINDS["gemm"],
              "host staging (gloo)": ("DtoH", "HtoD"),
              "copies": ("Memcpy", "Memset")}


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(q, k) pairs the masks leave: the work the kernel must do."""
    total = 0
    for q in range(sq):
        hi = min(skv, q + 1) if causal else skv
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def bound(q, k, v, causal, window):
    """Least time on the card: max(products / peak rate, bytes / memory rate)."""
    import torch
    b, sq, hq, hd = q.shape
    flops = 4.0 * hd * b * hq * live_pairs(sq, k.shape[1], causal, window)
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def rwkv6_bound(bh: int, t: int, dk: int, dv: int, chunk: int,
                exclusive: bool, with_state: bool, esize: int = 2,
                heads: int = 0, shared_q: bool = False):
    """Least time of one fused recurrence call: max(live float32 operations
    at their rate, bytes / memory rate).  Per chunk: the live score pairs
    times K and V, the cross-chunk read and the state update (C·K·V FMAs
    each): products the kernel runs in 3xTF32, three TF32 products each on
    the tensor cores, so at PEAK_TF32_FLOPS / 3; the decay scaling of S and,
    per row with a bonus, Σ_k q·u·k (3·K) and its product with v added
    (2·V), at PEAK_F32_FLOPS.  Bytes: q, k, log decay and v read once and
    the output written once in their dtype (``esize`` bytes), S written and
    s0 read in float32, the bonus (heads, K) read in float32.  ``shared_q``
    (Mamba2's call): q is one (B, T, K) tensor broadcast over the
    ``heads``, read once."""
    nc = t // chunk
    pairs = chunk * (chunk - 1) // 2 if exclusive else chunk * (chunk + 1) // 2
    products = bh * nc * (2 * pairs * (dk + dv) + 4 * chunk * dk * dv)
    other = bh * nc * dk * dv + (bh * t * (3 * dk + 2 * dv) if exclusive
                                 else 0)
    q_bytes = esize * t * dk * (bh // heads if shared_q else bh)
    nbytes = (q_bytes + bh * (esize * (2 * t * dk + 2 * t * dv)
                              + 4 * dk * dv * (2 if with_state else 1))
              + (4 * heads * dk if exclusive else 0))
    t_ops = (3 * products / PEAK_TF32_FLOPS + other / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def serve_bounds(cfg, batch: int, prompt: int, steps: int, frames: int = 0):
    """Least time of the served path on the card, from its shapes.

    Prefill: the bf16 products of every layer matrix over all prompt tokens,
    the live attention pairs, and the lm_head at the last position, over the
    bf16 peak; for the ssm family, plus one recurrence bound per layer (its
    float32 work cannot use the bf16 peak).  A decode step: the bytes it
    must read, i.e. every matrix once (bf16) plus the valid part of the KV
    cache (its mean over the steps) or the float32 recurrent state (read and
    written), over the memory rate.  The moe family: ``moe_prefill_parts``
    and ``moe_decode_bytes``; the hybrid family: ``hybrid_prefill_parts``
    and ``hybrid_decode_bytes``; the audio family (``frames`` frame
    embeddings a request): ``audio_prefill_parts`` and
    ``audio_decode_bytes``; the dense and vlm families:
    ``dense_prefill_parts``.  Returns (prefill_ms, decode_ms_per_step, the
    recurrence's share of prefill_ms).
    """
    d, L = cfg.d_model, cfg.num_layers
    if cfg.family == "ssm":
        from repro_torch.models.transformer import _fit_chunk
        hd = cfg.rwkv_head_dim
        heads = d // hd
        # r, k, v, g and the low-rank decay are products; w_o only scales
        # channels by its row sums (ssm.py:281), so it is read, not multiplied
        prod = 4 * d * d + 2 * d * 64 + 2 * d * cfg.d_ff
        head = d * cfg.vocab_size
        esize = 2 if cfg.dtype == "bfloat16" else 4
        rec_ms = L * rwkv6_bound(batch * heads, prompt, hd, hd,
                                 _fit_chunk(prompt, 16), True, False,
                                 esize, heads)[0]
        prefill = 2 * L * prod * batch * prompt + 2 * head * batch
        state = L * batch * (heads * hd * hd * 4 * 2 + 2 * d * 2 * 2)
        decode = 2 * (L * (prod + d * d) + head) + state
        return (prefill / PEAK_BF16_FLOPS * 1e3 + rec_ms,
                decode / PEAK_BYTES * 1e3, rec_ms)
    if cfg.family == "moe":
        return (sum(moe_prefill_parts(cfg, batch, prompt).values()),
                moe_decode_bytes(cfg, batch, prompt, steps) / PEAK_BYTES
                * 1e3, 0.0)
    if cfg.family == "hybrid":
        parts = hybrid_prefill_parts(cfg, batch, prompt)
        return (sum(parts.values()),
                hybrid_decode_bytes(cfg, batch, prompt, steps) / PEAK_BYTES
                * 1e3, parts["recurrence"])
    if cfg.family == "audio":
        return (sum(audio_prefill_parts(cfg, batch, prompt, frames).values()),
                audio_decode_bytes(cfg, batch, prompt, frames, steps)
                / PEAK_BYTES * 1e3, 0.0)
    hd = cfg.head_dim_
    kv = cfg.num_layers * 2 * batch * (prompt + steps / 2) \
        * cfg.num_kv_heads * hd
    decode = 2 * (dense_matrices(cfg) + d * cfg.vocab_size + kv)
    return (sum(dense_prefill_parts(cfg, batch, prompt).values()),
            decode / PEAK_BYTES * 1e3, 0.0)


def dense_matrices(cfg) -> int:
    """Weights of the layers' products: q / k / v / o and the gated MLP."""
    d, hd = cfg.d_model, cfg.head_dim_
    return cfg.num_layers * (2 * d * cfg.num_heads * hd
                             + 2 * d * cfg.num_kv_heads * hd
                             + 3 * d * cfg.d_ff)


def dense_prefill_parts(cfg, batch: int, prompt: int) -> dict:
    """Least time of each part of a dense (or vlm) prefill on the card, ms,
    all bf16 products at 989 TFLOP/s: the layers' matrices over every
    prompt token, attention's live causal pairs, the lm_head at the last
    position."""
    flops = {
        "layer products": 2 * dense_matrices(cfg) * batch * prompt,
        "attention": cfg.num_layers * 4 * cfg.head_dim_ * cfg.num_heads
        * batch * live_pairs(prompt, prompt, True, None),
        "lm_head": 2 * cfg.d_model * cfg.vocab_size * batch,
    }
    return {k: v / PEAK_BF16_FLOPS * 1e3 for k, v in flops.items()}


def moe_prefill_parts(cfg, batch: int, prompt: int) -> dict:
    """Least time of each part of a moe prefill on the card, ms: the bf16
    products of the attention projections and the live causal pairs (every
    layer), the leading dense layers' MLP, the E x cap expert slots the
    dense dispatch fills (capacity as ``moe_apply_dense`` sets it, padding
    included), the shared experts over every token and the lm_head at the
    last position, at 989 TFLOP/s; the router's float32 product (no TF32)
    at 67 TFLOP/s."""
    from repro_torch.models.moe import _capacity
    d, hd, t = cfg.d_model, cfg.head_dim_, batch * prompt
    n_moe = cfg.num_layers - cfg.moe_first_dense
    fe, e = cfg.moe_d_ff or cfg.d_ff, cfg.moe_num_experts
    cap = _capacity(t, cfg.moe_top_k, e, cfg.moe_capacity_factor)
    proj = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
    flops = {
        "attention projections": 2 * proj * t * cfg.num_layers,
        "attention": cfg.num_layers * 4 * hd * cfg.num_heads * batch
        * live_pairs(prompt, prompt, True, cfg.sliding_window),
        "dense-layer MLP": 2 * 3 * d * cfg.d_ff * t * cfg.moe_first_dense,
        f"experts ({e} x {cap} slots)": 2 * 3 * d * fe * e * cap * n_moe,
        "shared experts": 2 * 3 * d * fe * cfg.moe_shared_experts * t
        * n_moe,
        "lm_head": 2 * d * cfg.vocab_size * batch,
    }
    ms = {k: v / PEAK_BF16_FLOPS * 1e3 for k, v in flops.items()}
    ms["router (float32)"] = 2 * d * e * t * n_moe / PEAK_F32_FLOPS * 1e3
    return ms


def hybrid_matrices(cfg):
    """(weights of one Mamba2 block's products: w_in, w_bc, w_dt, w_out;
    of the shared block's: shared_proj, q / k / v / o, the gelu MLP)."""
    from repro_torch.models.transformer import ssm_heads
    d, hd = cfg.d_model, cfg.head_dim_
    din, heads = d * cfg.ssm_expand, ssm_heads(cfg)
    mamba = d * 2 * din + d * 2 * cfg.ssm_state + d * heads + din * d
    shared = (2 * d * d + 2 * d * cfg.num_heads * hd
              + 2 * d * cfg.num_kv_heads * hd + 2 * d * cfg.d_ff)
    return mamba, shared


def hybrid_prefill_parts(cfg, batch: int, prompt: int) -> dict:
    """Least time of each part of a hybrid prefill on the card, ms: the bf16
    products of the Mamba2 blocks' and the shared block's matrices over
    every prompt token, the shared attention's live causal pairs at each
    application point and the lm_head at the last position, at 989
    TFLOP/s; one recurrence call per Mamba2 block at its bound (float32
    operands, q shared by the heads)."""
    from repro_torch.models.transformer import ssm_heads
    mamba, shared = hybrid_matrices(cfg)
    t, hd = batch * prompt, cfg.head_dim_
    points = cfg.num_layers // cfg.attn_every
    heads = ssm_heads(cfg)
    din = cfg.d_model * cfg.ssm_expand
    flops = {
        "Mamba2 products": 2 * mamba * t * cfg.num_layers,
        "shared-block products": 2 * shared * t * points,
        "attention": points * 4 * hd * cfg.num_heads * batch
        * live_pairs(prompt, prompt, True, cfg.sliding_window),
        "lm_head": 2 * cfg.d_model * cfg.vocab_size * batch,
    }
    ms = {k: v / PEAK_BF16_FLOPS * 1e3 for k, v in flops.items()}
    ms["recurrence"] = cfg.num_layers * rwkv6_bound(
        batch * heads, prompt, cfg.ssm_state, din // heads, 16, False, False,
        4, heads, shared_q=True)[0]
    return ms


def hybrid_decode_bytes(cfg, batch: int, prompt: int, steps: int) -> float:
    """Bytes a hybrid decode step must read: every matrix once in bf16 (the
    shared block's too, though nine points apply it), the lm_head, the
    float32 SSM state and the conv context read and written, and the
    valid KV cache of each application point (its mean over the steps)."""
    mamba, shared = hybrid_matrices(cfg)
    din = cfg.d_model * cfg.ssm_expand
    points = cfg.num_layers // cfg.attn_every
    mats = cfg.num_layers * mamba + shared + cfg.d_model * cfg.vocab_size
    ssm = cfg.num_layers * batch * cfg.ssm_state * din * 4 * 2
    conv = cfg.num_layers * batch * 3 * din * 2 * 2
    kv = (points * 2 * batch * (prompt + steps / 2) * cfg.num_kv_heads
          * cfg.head_dim_)
    return 2 * (mats + kv) + ssm + conv


def audio_matrices(cfg):
    """(weights of one encoder layer's products: q / k / v / o and the gelu
    MLP; of one decoder layer's: its self-attention's q / k / v / o, the
    MLP, and its cross attention's q / o; of one cross attention's k / v,
    which project the encoder's output)."""
    d, hd = cfg.d_model, cfg.head_dim_
    attn = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
    mlp = 2 * d * cfg.d_ff
    return (attn + mlp, attn + mlp + 2 * d * cfg.num_heads * hd,
            2 * d * cfg.num_kv_heads * hd)


def audio_prefill_parts(cfg, batch: int, prompt: int, frames: int) -> dict:
    """Least time of each part of an audio prefill on the card, ms, all bf16
    products at 989 TFLOP/s: the encoder's matrices over every frame, the
    cross K/V projections of the encoder's output (every decoder layer),
    the decoder's matrices over every prompt token, the lm_head at the last
    position, and attention's live pairs: the encoder's frames x frames,
    the decoder's causal prompt pairs and the cross prompt x frames."""
    enc, dec, cross = audio_matrices(cfg)
    hd, hq, L = cfg.head_dim_, cfg.num_heads, cfg.num_layers
    pairs = (cfg.encoder_layers * live_pairs(frames, frames, False, None)
             + L * live_pairs(prompt, prompt, True, None)
             + L * prompt * frames)
    flops = {
        "encoder products": 2 * enc * batch * frames * cfg.encoder_layers,
        "cross K/V projections": 2 * cross * batch * frames * L,
        "decoder products": 2 * dec * batch * prompt * L,
        "attention": 4 * hd * hq * batch * pairs,
        "lm_head": 2 * cfg.d_model * cfg.vocab_size * batch,
    }
    return {k: v / PEAK_BF16_FLOPS * 1e3 for k, v in flops.items()}


def audio_decode_bytes(cfg, batch: int, prompt: int, frames: int,
                       steps: int) -> float:
    """Bytes an audio decode step must read, bf16: the decoder's matrices
    (the cross K/V projections are not run in decode), the lm_head, the
    valid self K/V (its mean over the steps) and the valid cross K/V."""
    _, dec, _ = audio_matrices(cfg)
    L, kvw = cfg.num_layers, cfg.num_kv_heads * cfg.head_dim_
    mats = L * dec + cfg.d_model * cfg.vocab_size
    kv = L * 2 * batch * (prompt + steps / 2 + frames) * kvw
    return 2 * (mats + kv)


def moe_decode_bytes(cfg, batch: int, prompt: int, steps: int) -> float:
    """Bytes a moe decode step must read: every matrix in bf16, every
    expert's too (the dense dispatch runs them all at capacity 8), the
    float32 router, the lm_head, and the valid KV cache (its mean over the
    steps)."""
    d, hd = cfg.d_model, cfg.head_dim_
    n_moe = cfg.num_layers - cfg.moe_first_dense
    fe, e = cfg.moe_d_ff or cfg.d_ff, cfg.moe_num_experts
    proj = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
    mats = (cfg.num_layers * proj + cfg.moe_first_dense * 3 * d * cfg.d_ff
            + n_moe * 3 * d * fe * (e + cfg.moe_shared_experts)
            + d * cfg.vocab_size)
    kv = (cfg.num_layers * 2 * batch * (prompt + steps / 2)
          * cfg.num_kv_heads * hd)
    return 2 * (mats + kv) + 4 * n_moe * d * e


def bf16_bound(ref):
    """One bf16 ulp of |ref|, at least BF16_TOL (the ulp below 2)."""
    import torch
    mag = ref.abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp_min(BF16_TOL)


def log_ptxas(name: str, text: str) -> None:
    """Log a kernel source's -Xptxas -v report: each entry function (one
    per variant) with its registers, stack and spills, and any wgmma
    serialisation warning (C7512, which names its function)."""
    for line in text.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            log(f"ptxas {name}: {entry.group(1)}")
        elif "registers" in line or "spill" in line or "C7512" in line:
            log(f"ptxas {name}:   {line.strip()}")


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(label: str, fn, top: int = 6, kinds=KERNEL_KINDS):
    """Wall time, summed kernel time and the device's idle share of ``fn``
    under torch.profiler (which adds host time: the idle share it shows is
    an upper estimate), and the kernels that take most device time.
    Returns (wall_ms, rows of (device ms, count, name))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    idle = 1 - busy_ms / wall_ms if busy_ms else float("nan")
    log(f"profile {label}: wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms, "
        f"device idle share {idle:.3f}")
    for ms, count, key in rows[:top]:
        log(f"profile {label}:   {ms:9.3f} ms {count:6d}x {key[:90]}")
    split = dict.fromkeys([*kinds, "other"], 0.0)
    for ms, _, key in rows:
        split[next((kind for kind, marks in kinds.items()
                    if any(m in key for m in marks)), "other")] += ms
    log(f"profile {label}: device ms by kind: " + ", ".join(
        f"{kind} {ms:.3f}" for kind, ms in split.items() if ms))
    return wall_ms, rows


def allclose_margin(out, ref, atol: float, rtol: float) -> float:
    """max |out - ref| / (atol + rtol |ref|): allclose holds iff <= 1."""
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def profile_serve(lm, prompts, tokens, kinds=KERNEL_KINDS, frames=None,
                  max_len=None) -> None:
    """Profile one prefill and 8 decode steps of the served model (the
    audio family: on ``frames``, with caches of ``max_len`` rows)."""
    import torch
    from repro_torch.serve.decode import decode_step, prefill
    cfg, params = lm.cfg, lm.compute_params()
    max_len = max_len or prompts.shape[1] + 9
    enc_params = lm.params if frames is not None else None
    with torch.inference_mode():
        box = {}
        device_profile("prefill", lambda: box.update(
            st=prefill(params, cfg, prompts, max_len, frame_embeds=frames,
                       encoder_params=enc_params)[1]), kinds=kinds)

        def decode8():
            st = box["st"]
            for i in range(8):
                st = decode_step(params, cfg, tokens[:, i:i + 1], st)[1]
        device_profile("decode x8", decode8, kinds=kinds)


def csr_case(seed: int, nvals: int, nseg: int, lo: int = 1, hi: int = 40):
    """nseg CSR segments over nvals random values, empty segments included."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, nvals + 1, max(nseg - 1, 0)))
    ptr = np.concatenate([[0], cuts, [nvals]]).astype(np.int64)
    return rng.integers(lo, hi, nvals, dtype=np.int64), ptr


def phase_max_cases():
    import numpy as np
    i64 = np.iinfo(np.int64)
    cases = {name: csr_case(i, nv, ns)
             for i, (name, nv, ns) in enumerate(DISPATCH_SHAPES)}
    cases.update({
        "mixed-empty": ([3, 1, 4, 7, 7, -2, 9], [0, 2, 2, 3, 5, 5, 7]),
        "all-empty": ([], [0] * 9),
        "no-values-no-segments": ([], [0]),
        "ties-negatives": ([8, 8, -8, -5, -9, -1, -1], [0, 2, 3, 6, 7]),
        "int64-extremes": ([i64.min, i64.max, i64.min, -(2 ** 40), 2 ** 31],
                           [0, 2, 3, 5]),
        "one-1M-segment": csr_case(7, 1_000_000, 1, lo=i64.min, hi=i64.max),
    })
    return {k: (np.asarray(v, np.int64), np.asarray(p, np.int64))
            for k, (v, p) in cases.items()}


def check_phase_max(dev) -> float:
    """The segment-max kernel on both routes (CUDA tensors, and the
    engines' numpy route through page-locked staging) against its plain
    version and numpy; any difference fails.  Returns the largest absolute
    difference (0)."""
    import numpy as np
    import torch
    from repro_torch.core.fairshare import phase_worst_numpy
    from repro_torch.kernels import phase_max as pm
    for name, (vals, ptr) in phase_max_cases().items():
        tv, tp = torch.from_numpy(vals).to(dev), torch.from_numpy(ptr).to(dev)
        out = pm.phase_max(tv, tp).cpu().numpy()
        host = pm.phase_max_host(vals, ptr, dev)
        plain = pm.phase_max_plain(tv, tp).cpu().numpy()
        want = phase_worst_numpy(vals, ptr)
        bad = int((out != want).sum() + (host != want).sum()
                  + (plain != want).sum())
        log(f"phase_max {name:22s} nvals {len(vals):8d} nseg {len(ptr) - 1:4d}"
            f" mismatches of both routes vs plain and numpy: {bad}")
        if bad or out.dtype != np.int64 or host.dtype != np.int64:
            fail(f"phase_max {name}: kernel {out[:8]} route {host[:8]} plain "
                 f"{plain[:8]} numpy {want[:8]}")
    return 0.0


def rwkv6_case_inputs(dev, shape, exclusive, decay, seed,
                      dtype_name="float32", views=False):
    """Raw q, k, v, log decay (B, H, T, K/V) and, on exclusive cases, a
    bonus (H, K): normal q, k, v and a log decay that is either the model's
    kind ("model": -exp(N(-0.5, 1)), the clamp at -4 active) or
    tests/test_kernels.py's ("mild": log U(0.3, 1)).  ``views``: the model's
    ``split_heads`` views of contiguous (B, T, H·D) tensors."""
    import torch
    b, h, t, dk, dv = shape
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*size):
        return torch.randn(size, generator=gen, device=dev)
    q, k, v = normal(b, h, t, dk), normal(b, h, t, dk), normal(b, h, t, dv)
    if decay == "model":
        ld = -torch.exp(normal(b, h, t, dk) - 0.5)
    else:
        ld = torch.log(0.3 + 0.7 * torch.rand((b, h, t, dk), generator=gen,
                                              device=dev))
    ins = []
    for x in (q, k, v, ld):
        x = x.to(dtype)
        if views:
            d = x.shape[-1]
            x = (x.transpose(1, 2).contiguous().view(b, t, h * d)
                 .view(b, t, h, d).transpose(1, 2))
        ins.append(x)
    u = normal(h, dk) * 0.1 if exclusive else None
    return (*ins, u)


RWKV_CASES = [  # name, (B, H, T, K, V), chunk, exclusive, initial state, decay
    ("path", RWKV_PATH, RWKV_CHUNK, True, False, "model"),
    ("path-s0", RWKV_PATH, RWKV_CHUNK, True, True, "model"),
    ("reduced", (2, 4, 64, 16, 16), 16, True, False, "model"),
    ("k8-inclusive", (2, 4, 64, 8, 8), 16, False, False, "mild"),
    ("k32-c8", (2, 4, 64, 32, 32), 8, True, True, "model"),
    ("k128-c64", (2, 4, 256, 128, 128), 64, False, True, "mild"),
    ("mamba2-k64-v128", (2, 4, 256, 64, 128), 16, False, False, "model"),
    ("k128-v8-c2", (1, 4, 64, 128, 8), 2, True, False, "model"),
    ("k8-v128-c32", (1, 4, 64, 8, 128), 32, False, False, "mild"),
    ("k64-c64-excl", (2, 4, 128, 64, 64), 64, True, False, "mild"),
    # the chunks _fit_chunk gives 12-, 7- and 17-token prompts
    ("t12-c12", (2, 4, 12, 64, 64), 12, True, True, "model"),
    ("t7-c7", (2, 4, 7, 16, 16), 7, True, True, "model"),
    ("t17-c1", (2, 4, 17, 16, 16), 1, True, True, "model"),
]


def check_rwkv6(dev) -> float:
    """The fused recurrence kernel against its plain version on raw q / k /
    v / log decay, a bonus on the exclusive cases: float32 output and final
    state within F32_TOL; then the path's case in bf16 from ``split_heads``
    views, output within one bf16 ulp, state within F32_TOL.  Logs the VB
    and the loads each case took.  Returns the output's max abs error on
    the path's bf16 views."""
    import torch
    from repro_torch.kernels import rwkv6 as kr
    cases = [(*c, "float32", False) for c in RWKV_CASES]
    cases.append(("path-bf16-views", RWKV_PATH, RWKV_CHUNK, True, False,
                  "model", "bfloat16", True))
    path_err = None
    for i, (name, shape, chunk, excl, with_s0, decay, dt, views) in \
            enumerate(cases):
        b, h, _, dk, dv = shape
        q, k, v, ld, u = rwkv6_case_inputs(dev, shape, excl, decay,
                                           100 + i, dt, views)
        s0 = torch.randn((b * h, dk, dv), device=dev) if with_s0 else None
        out, S = kr.rwkv6_fused(q, k, v, ld, bonus=u, chunk=chunk,
                                initial_state=s0)
        torch.cuda.synchronize()
        plan = kr.last_plan
        ref, ref_S = kr.rwkv6_fused_plain(q, k, v, ld, bonus=u, chunk=chunk,
                                          initial_state=s0)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        s_err = (S - ref_S).abs().max().item()
        if dt == "bfloat16":
            tol = "one bf16 ulp, 8e-3 where |o| < 2"
            within = bool((diff <= bf16_bound(ref.float())).all())
        else:
            tol = f"{F32_TOL:g}"
            within = torch.allclose(out, ref, atol=F32_TOL, rtol=F32_TOL)
        ok = (bool(torch.isfinite(out.float()).all()
                   and torch.isfinite(S).all()) and within
              and out.dtype == q.dtype
              and torch.allclose(S, ref_S, atol=F32_TOL, rtol=F32_TOL))
        log(f"rwkv6 {name:16s} {dt:8s} B·H {b * h:4d} T {shape[2]:5d} K "
            f"{dk:3d} V {dv:3d} C {chunk:2d} "
            f"{'bonus    ' if excl else 'inclusive'} s0 "
            f"{'yes' if with_s0 else 'no '} VB {plan['vb']:2d} "
            f"{plan['loads']:6s} max_abs_err out {err:.3e} (tol {tol}) S "
            f"{s_err:.3e} (tol {F32_TOL:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"rwkv6 {name}: kernel disagrees with its plain version "
                 f"(out {err:.3e}, S {s_err:.3e})")
        if name == "path-bf16-views":
            path_err = err
        del q, k, v, ld, out, S, ref, ref_S, diff
    torch.cuda.empty_cache()
    return path_err


def mamba2_operands(dev, shape, seed):
    """The recurrence's operands as ``models.ssm.mamba2_apply`` builds them
    on the card: float32 q = C (B, T, K) broadcast over the heads (head
    stride 0), k = B·dt (B, H, T, K), v the (B, H, T, hd) view of a (B, T,
    H·hd) tensor, and the scalar log decay dt·A broadcast over K and made
    contiguous; dt = softplus(N(0, 1)), A = -exp(N(0, 0.5))."""
    import torch
    b, h, t, dk, dv = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*size):
        return torch.randn(size, generator=gen, device=dev)
    c, bb = normal(b, t, dk), normal(b, t, dk)
    dt = torch.nn.functional.softplus(normal(b, t, h))
    a = -torch.exp(normal(h) * 0.5)
    q = c[:, None].expand(b, h, t, dk)
    k = bb[:, None] * dt.transpose(1, 2)[..., None]
    v = normal(b, t, h * dv).view(b, t, h, dv).transpose(1, 2)
    ld = (dt * a).transpose(1, 2)[..., None].expand(b, h, t, dk).contiguous()
    return q, k, v, ld


def check_mamba2_call(dev) -> float:
    """The recurrence called as ``mamba2_apply`` calls it at the served
    path's shape (float32, inclusive, B·H 160, T 2048, K 64, V 128, chunk
    16, from the head-broadcast views), and at a small case with an initial
    state: output and final S within F32_TOL of the plain version.
    Returns the path case's output max abs error."""
    import torch
    from repro_torch.kernels import rwkv6 as kr
    err_path = None
    for name, shape, with_s0 in (("mamba2-path", MAMBA_PATH, False),
                                 ("mamba2-s0", (2, 8, 256, 64, 128), True)):
        q, k, v, ld = mamba2_operands(dev, shape, 40)
        b, h, _, dk, dv = shape
        s0 = torch.randn((b, h, dk, dv), device=dev) if with_s0 else None
        out, S = kr.rwkv6_fused(q, k, v, ld, chunk=RWKV_CHUNK,
                                initial_state=s0)
        torch.cuda.synchronize()
        plan = kr.last_plan
        ref, ref_S = kr.rwkv6_fused_plain(q, k, v, ld, chunk=RWKV_CHUNK,
                                          initial_state=s0)
        err = (out - ref).abs().max().item()
        s_err = (S - ref_S).abs().max().item()
        ok = (bool(torch.isfinite(out).all() and torch.isfinite(S).all())
              and torch.allclose(out, ref, atol=F32_TOL, rtol=F32_TOL)
              and torch.allclose(S, ref_S, atol=F32_TOL, rtol=F32_TOL))
        log(f"rwkv6 {name:16s} float32  B·H {b * h:4d} T {shape[2]:5d} K "
            f"{dk:3d} V {dv:3d} C {RWKV_CHUNK} inclusive, q head stride "
            f"{q.stride(1)} s0 {'yes' if with_s0 else 'no '} VB "
            f"{plan['vb']:2d} {plan['loads']:6s} max_abs_err out {err:.3e} "
            f"S {s_err:.3e} (tol {F32_TOL:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"rwkv6 {name}: kernel disagrees with its plain version")
        if name == "mamba2-path":
            err_path = err
        del q, k, v, ld, out, S, ref, ref_S
    torch.cuda.empty_cache()
    return err_path


def kernel_counters():
    """Each kernel's wrapper module under its name in the kernels line; its
    ``launches`` counts the kernel's launches since the last reset."""
    from repro_torch.kernels import flash_attention, phase_max, rwkv6
    return {"flash_attention": flash_attention, "phase_max": phase_max,
            "rwkv6_chunked": rwkv6}


def moe_drop_share(lm, prompts):
    """One prefill with ``moe._route`` wrapped here (for this call only):
    the share of (token, choice) pairs dropped at the capacity, per layer
    and in all, and the fullest expert's load against the capacity.
    Returns (the share in all, the experts chosen in the layer that
    dropped most, its capacity)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serve.decode import prefill
    cfg, route, seen, worst = lm.cfg, moe._route, [], {}

    def recording_route(router_w, x_flat, top_k, num_experts, capacity):
        out = route(router_w, x_flat, top_k, num_experts, capacity)
        load = torch.bincount(out[0].reshape(-1), minlength=num_experts)
        dropped = (~out[3]).sum().item()
        seen.append((dropped, out[3].numel(), load.max().item(), capacity))
        if dropped >= max(x[0] for x in seen):
            worst["idx"] = out[0]
        return out
    moe._route = recording_route
    with torch.inference_mode():
        prefill(lm.compute_params(), cfg, prompts, prompts.shape[1] + 1)
    moe._route = route
    shares = [dropped / pairs for dropped, pairs, _, _ in seen]
    total = sum(x[0] for x in seen) / sum(x[1] for x in seen)
    t = prompts.numel()
    log(f"{cfg.name} prefill {tuple(prompts.shape)}: capacity {seen[0][3]} "
        f"slots per expert ({t * cfg.moe_top_k / cfg.moe_num_experts:g} if "
        f"the router were balanced); (token, choice) pairs dropped "
        f"{total:.4f} over {len(seen)} MoE layers (per layer min "
        f"{min(shares):.4f}, max {max(shares):.4f}); fullest expert "
        f"{min(x[2] for x in seen)}-{max(x[2] for x in seen)} pairs")
    return total, worst["idx"], seen[0][3]


def time_moe_dispatch(expert_idx, capacity: int, cfg, dev) -> None:
    """The port's dispatch against the reference's literal operations,
    kept here as yardsticks only, on one prefill layer's routing (the
    layer that dropped most), in turns: slots by ``moe._slots`` (a stable
    sort) or by the one-hot cumsum down the T·k rows (``moe.py:66-72``);
    the scatter into E·cap + 1 rows by ``index_put`` or by ``index_add``
    (bf16 atomics, every dropped pair on the scratch row).  The slots must
    be equal and the kept rows identical."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    flat_e = expert_idx.reshape(-1)

    def cumsum_slots():
        pos = torch.cumsum(F.one_hot(flat_e, e), dim=0) - 1
        return pos.gather(1, flat_e[:, None])[:, 0]
    slot = moe._slots(flat_e, e)
    if not torch.equal(slot, cumsum_slots()):
        fail("moe._slots disagrees with the one-hot cumsum")
    dst = torch.where(slot < capacity, flat_e * capacity + slot, e * capacity)
    x = torch.randn((flat_e.numel() // k, cfg.d_model), device=dev,
                    dtype=torch.bfloat16)
    rep = x.repeat_interleave(k, dim=0)
    rows = e * capacity

    def put():
        return x.new_zeros((rows + 1, cfg.d_model)).index_put((dst,), rep)

    def add():
        return x.new_zeros((rows + 1, cfg.d_model)).index_add(0, dst, rep)
    if not torch.equal(put()[:rows], add()[:rows]):
        fail("the index_put scatter disagrees with index_add on kept rows")
    fns = {"sort": lambda: moe._slots(flat_e, e), "cumsum": cumsum_slots,
           "index_put": put, "index_add": add}
    turns = {name: [] for name in fns}
    for name in ("sort", "cumsum", "index_put", "index_add", "index_add",
                 "index_put", "cumsum", "sort"):
        turns[name].append(time_ms(fns[name], iters=10))
    log(f"moe dispatch at one deepseek prefill layer (T·k {flat_e.numel()} "
        f"pairs, {(slot >= capacity).sum().item()} dropped, capacity "
        f"{capacity}), CUDA events, in turns: " + "; ".join(
            f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
            for n, ts in turns.items())
        + " (the port: sort and index_put)")


def counted(expect: dict, fn):
    """Run ``fn`` with every kernel's count from 0; returns (its result,
    each kernel's launches, whether they are ``expect``'s, every other
    kernel 0)."""
    import torch
    mods = kernel_counters()
    for mod in mods.values():
        mod.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {name: mod.launches for name, mod in mods.items()}
    return out, got, got == {name: expect.get(name, 0) for name in mods}


def greedy_decode(params, cfg, prompts, max_len: int, frames=None):
    """Prefill and DECODE_STEPS greedy decode steps of ``cfg`` on
    ``params`` (the audio family: on ``frames``): (the last decode logits
    (B, V), prompt + the tokens the steps were fed, over which a
    teacher-forced forward must give those logits at its last position)."""
    import torch
    from repro_torch.serve.decode import decode_step, prefill
    with torch.inference_mode():
        logits, state = prefill(params, cfg, prompts, max_len,
                                frame_embeds=frames)
        toks = [logits.argmax(dim=-1)]
        for _ in range(DECODE_STEPS):
            logits, state = decode_step(params, cfg, toks[-1], state)
            toks.append(logits.argmax(dim=-1))
    return logits[:, 0], torch.cat([prompts, *toks[:-1]], dim=1)


def forward_last_logits(params, cfg, tokens, expect: dict, frames=None,
                        sink=None):
    """A teacher-forced forward over ``tokens`` (the audio family: on
    ``frames``), its launches counted by ``counted``: (the last position's
    logits (B, V), each kernel's launches, whether they are ``expect``'s)."""
    import torch
    from repro_torch.models.transformer import (hidden_states,
                                                logits_from_hidden)
    with torch.inference_mode():
        x, launched, ok = counted(expect, lambda: hidden_states(
            params, cfg, tokens, sink=sink, frame_embeds=frames)[0])
        return logits_from_hidden(params, cfg, x[:, -1:])[:, 0], launched, ok


def teacher_forcing(lm, prompts, res, expect: dict,
                    gate: bool = True, frames=None, variant=None) -> None:
    """The last decode logits of ``res`` against a forward over prompt +
    generated tokens (the audio family: on the same ``frames``), bf16, at
    atol SERVE_ATOL / rtol SERVE_RTOL; the forward must launch each kernel
    as often as a prefill does (``expect``), the others never, and every
    attention launch take ``variant`` where one is named."""
    import torch
    cfg = lm.cfg
    with torch.inference_mode():
        (full, variants), tf_launches, as_expected = counted(
            expect, lambda: attention_variants(lambda: lm(
                torch.cat([prompts, res.tokens[:, :-1]], dim=1),
                frames)[:, -1]))
    dec = res.last_logits[:, 0].float()
    err = (full.float() - dec).abs().max().item()
    agree = (full.argmax(-1) == dec.argmax(-1)).float().mean().item()
    margin = allclose_margin(full.float(), dec, SERVE_ATOL, SERVE_RTOL)
    at = (f" at capacity factor {cfg.moe_capacity_factor} (recorded, not a "
          f"gate)" if cfg.family == "moe" else "")
    log(f"{cfg.name} teacher-forced forward vs last decode logits, bf16{at}:"
        f" max_abs_err {err:.4f} (atol {SERVE_ATOL}, rtol {SERVE_RTOL}; "
        f"worst error / tolerance {margin:.3f}); argmax agreement "
        f"{agree:.2f}; kernel launches {tf_launches}, attention variants "
        f"{sorted(set(variants))}")
    if not as_expected:
        fail(f"teacher-forced forward launched {tf_launches}, expected "
             f"{expect}")
    if variant and set(variants) != {variant}:
        fail(f"{cfg.name}'s teacher-forced forward took {variants}, not "
             f"only {variant}")
    if gate and not torch.allclose(full.float(), dec, atol=SERVE_ATOL,
                                   rtol=SERVE_RTOL):
        fail(f"{cfg.name} decode logits disagree with the teacher-forced "
             f"forward")


def moe_teacher_forcing(lm, prompts, expect: dict) -> None:
    """The moe family against teacher forcing at TF_CAPACITY_FACTOR, where
    neither side drops a pair, on the served weights.  (a) bf16 through
    ``generate``, recorded with the routes: for each row, the first MoE
    layer whose top-k experts for the last token differ between its decode
    step and the forward, and the k-th minus (k + 1)-th probability there.
    (b) the gate: float32 compute from the same bf16-held weights (cast at
    each product: ``generate``'s float32 compute copy, 65.5 GB, would not
    fit beside them), prefill and greedy decode steps against the forward
    over prompt + generated tokens, within MOE_TF_F32_TOL; the forward
    must launch the attention kernel once per layer."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    cfg = lm.cfg
    lm.cfg = dataclasses.replace(cfg, moe_capacity_factor=TF_CAPACITY_FACTOR)
    calls, restore = route_recorder(prompts.shape[0])
    res = generate(lm, prompts, DECODE_STEPS + 1)
    n_moe = cfg.num_layers - cfg.moe_first_dense
    decode_calls = calls[-n_moe:]
    del calls[:]
    teacher_forcing(lm, prompts, res, expect, gate=False)
    restore()
    rows = route_agreement(decode_calls, calls, cfg.moe_top_k)
    log(f"{cfg.name} bf16 routes of the last token, decode step vs forward, "
        f"per row (first MoE layer whose top-{cfg.moe_top_k} differ, the "
        f"k-th minus (k+1)-th probability there in the forward / in "
        f"decode): " + "; ".join(
            "same experts in every layer" if r is None else
            f"layer {r[0]}, {r[1]:.2e} / {r[2]:.2e}" for r in rows))
    lm.cfg = cfg

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                moe_capacity_factor=TF_CAPACITY_FACTOR)
    params = lm.params
    t0 = time.perf_counter()
    dec, tokens = greedy_decode(params, cfg32, prompts,
                                prompts.shape[1] + DECODE_STEPS + 1)
    full, tf_launches, as_expected = forward_last_logits(params, cfg32,
                                                         tokens, expect)
    err = (full - dec).abs().max().item()
    log(f"{cfg.name} teacher-forced forward vs last decode logits, float32 "
        f"compute from the bf16 weights, capacity factor "
        f"{TF_CAPACITY_FACTOR}: max_abs_err {err:.3e} (tol "
        f"{MOE_TF_F32_TOL:g}); argmax agreement "
        f"{(full.argmax(-1) == dec.argmax(-1)).float().mean().item():.2f}; "
        f"kernel launches {tf_launches} ({fa.last_variant}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not as_expected:
        fail(f"the float32 forward launched {tf_launches}, expected "
             f"{expect}")
    if not torch.allclose(full, dec, atol=MOE_TF_F32_TOL,
                          rtol=MOE_TF_F32_TOL):
        fail(f"{cfg.name} decode logits disagree with the teacher-forced "
             f"forward in float32")
    del full, dec
    torch.cuda.empty_cache()


def hybrid_teacher_forcing(lm, prompts, res, expect: dict) -> None:
    """The hybrid family against teacher forcing.  (a) bf16 through
    ``generate`` (``teacher_forcing``), at SERVE_ATOL / SERVE_RTOL.  (b)
    float32 compute from the same float32 masters: prefill, greedy decode
    steps and the forward over prompt + generated tokens, within
    HYBRID_TF_F32_TOL.  (c) the bf16 forward against that float32 forward
    on the same tokens: the last logits, and at each application point of
    the shared block the relative distance of its post-RoPE k at the last
    position (from the sinks), which shows how bf16 rounding grows with
    depth; and for the first ``attn_every`` Mamba2 blocks of the bf16
    forward over the prompt, each block's own rounding (its bf16 output
    against its float32 output on the same bf16 input) beside the distance
    carried from the blocks before it.  Both forwards must launch as
    ``expect`` says.  The gate is (b)."""
    import dataclasses
    import torch
    cfg = lm.cfg
    teacher_forcing(lm, prompts, res, expect, gate=False)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = lm.params
    t0 = time.perf_counter()
    dec, tokens = greedy_decode(params, cfg32, prompts,
                                prompts.shape[1] + DECODE_STEPS + 1)
    sinks = {}

    def last_logits(p, c, name):
        sinks[name] = []
        out, launched, ok = forward_last_logits(p, c, tokens, expect,
                                                sink=sinks[name])
        sinks[name] = [k[:, -1].float() for k, v in sinks[name]
                       if v.dim() == 4]       # (k, v), not (S, conv)
        if not ok:
            fail(f"the {name} forward launched {launched}, expected "
                 f"{expect}")
        return out.float()
    full = last_logits(params, cfg32, "float32")
    full16 = last_logits(lm.compute_params(), cfg, "bf16")
    err = (full - dec).abs().max().item()
    log(f"{cfg.name} teacher-forced forward vs last decode logits, float32 "
        f"compute from the float32 masters: max_abs_err {err:.3e} (tol "
        f"{HYBRID_TF_F32_TOL:g}); argmax agreement "
        f"{(full.argmax(-1) == dec.argmax(-1)).float().mean().item():.2f}; "
        f"{time.perf_counter() - t0:.1f} s")
    rel = [((a - b).norm() / b.norm()).item()
           for a, b in zip(sinks["bf16"], sinks["float32"])]
    log(f"{cfg.name} bf16 forward vs float32 forward on the same "
        f"{tokens.shape[1]} tokens: last logits max_abs_err "
        f"{(full16 - full).abs().max().item():.4f} (worst error / "
        f"tolerance at {SERVE_ATOL} / {SERVE_RTOL}: "
        f"{allclose_margin(full16, full, SERVE_ATOL, SERVE_RTOL):.3f}), "
        f"argmax agreement "
        f"{(full16.argmax(-1) == full.argmax(-1)).float().mean().item():.2f};"
        f" relative distance of the shared attention's k at the last "
        f"position, by application point: "
        + ", ".join(f"{r:.2e}" for r in rel))
    del full16, sinks
    log(f"{cfg.name} bf16 rounding through the first {cfg.attn_every} "
        f"Mamba2 blocks over the prompt, relative distance of each block's "
        f"output from float32's (its own rounding / carried from the blocks"
        f" before): " + ", ".join(
            f"{own:.2e} / {carried:.2e}"
            for own, carried in mamba2_rounding(lm, prompts)))
    if not torch.allclose(full, dec, atol=HYBRID_TF_F32_TOL,
                          rtol=HYBRID_TF_F32_TOL):
        fail(f"{cfg.name} decode logits disagree with the teacher-forced "
             f"forward in float32")
    del full, dec
    torch.cuda.empty_cache()


def audio_f32_teacher_forcing(lm, prompts, frames, expect: dict,
                              max_len: int) -> None:
    """Recorded beside the bf16 gate: float32 compute from the float32
    masters on the same frames in float32, prefill and greedy decode steps
    against the forward over prompt + generated tokens (the forward must
    launch as ``expect`` says)."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as fa
    cfg = lm.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params, frames32 = lm.params, frames.float()
    t0 = time.perf_counter()
    dec, tokens = greedy_decode(params, cfg32, prompts, max_len, frames32)
    full, launched, ok = forward_last_logits(params, cfg32, tokens, expect,
                                             frames32)
    log(f"{cfg.name} teacher-forced forward vs last decode logits, float32 "
        f"compute from the float32 masters (recorded): max_abs_err "
        f"{(full - dec).abs().max().item():.3e}; argmax agreement "
        f"{(full.argmax(-1) == dec.argmax(-1)).float().mean().item():.2f}; "
        f"kernel launches {launched} ({fa.last_variant}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not ok:
        fail(f"the float32 forward launched {launched}, expected {expect}")
    del full, dec
    torch.cuda.empty_cache()


def attention_variants(fn):
    """Run ``fn`` with ``ops.flash_attention`` wrapped here (for this call
    only) to record the variant of every attention launch; returns (its
    result, the variants in launch order)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    launch, seen = ops.flash_attention, []

    def recording(*args, **kwargs):
        out = launch(*args, **kwargs)
        seen.append(fa.last_variant)
        return out
    ops.flash_attention = recording
    out = fn()
    ops.flash_attention = launch
    return out, seen


def mamba2_rounding(lm, prompts) -> list:
    """For each of the first ``attn_every`` Mamba2 blocks, run on the
    prompt both in bf16 (from the bf16 forward's running h) and in float32
    (from the float32 forward's): (the relative distance of the bf16
    output from the float32 output on the same bf16 input, its distance
    from the float32 forward's output)."""
    import torch
    from repro_torch.models.common import norm_apply
    from repro_torch.models.ssm import mamba2_apply
    from repro_torch.models.transformer import ssm_heads, unstack
    cfg = lm.cfg
    p32, p16 = lm.params, lm.compute_params()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def block(lp, x):
        return mamba2_apply(lp["mamba"], norm_apply(cfg.norm, lp["ln"], x),
                            ssm_heads(cfg), cfg.ssm_state,
                            cfg.ssm_expand)[0]
    n = cfg.attn_every
    out = []
    with torch.inference_mode():
        x32 = p32["embed"][prompts].float()
        x16 = p16["embed"][prompts].to(torch.bfloat16)
        for l32, l16 in zip(unstack(p32["layers"], n),
                            unstack(p16["layers"], n)):
            y16, y32 = block(l16, x16), block(l32, x32)
            own = block(l32, x16.float())
            out.append((rel(y16, own), rel(y16, y32)))
            x16, x32 = x16 + y16, x32 + y32
    return out


def route_recorder(batch: int):
    """Wrap ``moe._route`` (until ``restore()``): each call records, for
    the last position of each of the ``batch`` rows, the top-(k + 1)
    router probabilities and experts.  Returns (calls, restore)."""
    import torch
    from repro_torch.models import moe
    route, calls = moe._route, []

    def recording_route(router_w, x_flat, top_k, num_experts, capacity):
        last = x_flat.reshape(batch, -1, x_flat.shape[-1])[:, -1]
        probs = torch.softmax(last.float() @ router_w.float(), dim=-1)
        calls.append(probs.topk(top_k + 1, dim=-1, sorted=True))
        return route(router_w, x_flat, top_k, num_experts, capacity)

    def restore():
        moe._route = route
    moe._route = recording_route
    return calls, restore


def route_agreement(decode_calls, forward_calls, top_k: int) -> list:
    """Per row: (first MoE layer whose top-k experts differ between the
    last decode step and the forward's last position, or None; the
    forward's k-th minus (k+1)-th probability there; the decode's)."""
    rows = []
    for b in range(decode_calls[0].indices.shape[0]):
        first = None
        for i, (dc, fc) in enumerate(zip(decode_calls, forward_calls)):
            if set(dc.indices[b, :top_k].tolist()) != set(
                    fc.indices[b, :top_k].tolist()):
                gap = (lambda c: (c.values[b, top_k - 1]
                                  - c.values[b, top_k]).item())
                first = (i, gap(fc), gap(dc))
                break
        rows.append(first)
    return rows


def describe(cfg, param_dtype: str) -> str:
    """One line of the served config's shapes."""
    from repro_torch.models.transformer import ssm_heads
    if cfg.family == "ssm":
        mix = (f"{cfg.d_model // cfg.rwkv_head_dim} heads of "
               f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}")
    elif cfg.family == "hybrid":
        heads = ssm_heads(cfg)
        din = cfg.d_model * cfg.ssm_expand
        mix = (f"Mamba2 d_inner {din}, {heads} SSM heads of {din // heads}, "
               f"ssm_state {cfg.ssm_state}; one shared block every "
               f"{cfg.attn_every} ({cfg.num_layers // cfg.attn_every} "
               f"points): {cfg.num_heads} heads, {cfg.num_kv_heads} kv heads "
               f"of {cfg.head_dim_}, {cfg.act} d_ff {cfg.d_ff}")
    elif cfg.family == "audio":
        mix = (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
               f"layers (each decoder layer with a cross attention), "
               f"{cfg.num_heads} heads, {cfg.num_kv_heads} kv heads of "
               f"{cfg.head_dim_}, {cfg.act} d_ff {cfg.d_ff}")
    elif cfg.family == "moe":
        mix = (f"{cfg.num_heads} heads, {cfg.num_kv_heads} kv heads of "
               f"{cfg.head_dim_}, {cfg.moe_first_dense} dense layer(s) of "
               f"d_ff {cfg.d_ff}, {cfg.moe_num_experts} routed experts (top-"
               f"{cfg.moe_top_k}) + {cfg.moe_shared_experts} shared of d_ff "
               f"{cfg.moe_d_ff}, capacity factor {cfg.moe_capacity_factor}")
    else:
        mix = (f"{cfg.num_heads} heads, {cfg.num_kv_heads} kv heads of "
               f"{cfg.head_dim_}, d_ff {cfg.d_ff}")
    return (f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{mix}, vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B "
            f"params held in {param_dtype}, {cfg.dtype} compute")


def patch_path(lm, prompts, expect: dict, variant, prefill_ms: float
               ) -> None:
    """Phase 4g's patch path: ``LM.forward`` over the prompts with
    PHI3_PATCHES patch embeddings (seeded normals from numpy, handed over
    in bf16 as a bf16 frontend would) must launch as a prefill does
    (``expect``, every attention launch ``variant``), give finite logits,
    and move the logits of every position past the patches against the
    patch-free forward's (the patches reach them through attention).
    Logs its time (CUDA events) beside the prefill's."""
    import numpy as np
    import torch
    cfg = lm.cfg
    b, n = prompts.shape[0], PHI3_PATCHES
    pe = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (b, n, cfg.d_model), dtype=np.float32)).to(prompts.device,
                                                   torch.bfloat16)
    with torch.inference_mode():
        (logits, variants), launched, ok = counted(
            expect, lambda: attention_variants(
                lambda: lm(prompts, patch_embeds=pe)))
        moved = (logits[:, n:].float() - lm(prompts)[:, n:].float()
                 ).abs().amax(dim=-1)
        ms = time_ms(lambda: lm(prompts, patch_embeds=pe), iters=3)
    finite = bool(torch.isfinite(logits.float()).all())
    log(f"{cfg.name} patch path, {b} x {prompts.shape[1]} tokens with {n} "
        f"bf16 patch embeddings: forward {ms:.2f} ms (CUDA events; a "
        f"prefill {prefill_ms:.2f} ms); kernel launches {launched}, "
        f"attention variants {sorted(set(variants))}; finite {finite}; "
        f"least change of a position's logits past the patches "
        f"{moved.min().item():.4f}, mean {moved.mean().item():.4f}; "
        f"{nvidia_smi()}")
    if not ok or (variant and set(variants) != {variant}):
        fail(f"the patch path launched {launched} ({variants}), expected "
             f"{expect}, every one {variant}")
    if not finite:
        fail(f"{cfg.name}'s logits with patches are not finite")
    if not bool((moved > 0).all()):
        fail(f"{cfg.name}: patches left {(moved == 0).sum().item()} "
             f"positions' logits unchanged")
    del logits, moved, pe
    torch.cuda.empty_cache()


def serve_phase(dev, arch: str, expect: dict, param_dtype: str = "float32",
                batch: int = BATCH, prompt: int = PROMPT, frames: int = 0,
                max_len=None, variant=None) -> dict:
    """Phases 4, 4b, 4d, 4e, 4f and 4g: full-width ``arch`` (seeded random
    weights, held in ``param_dtype``) through ``generate``, ``batch``
    prompts of ``prompt`` tokens (the audio family: with ``frames`` frame
    embeddings each, seeded normals from numpy handed over in bf16 as a
    bf16 frontend would, and caches of ``max_len`` rows).  ``expect`` gives
    each kernel's launches in a prefill: a prefill alone, the main run
    (prefill and decode) and the teacher-forced forward must launch each
    exactly that often, every other kernel never, and where ``variant`` is
    named every attention launch of the three must take it.  The moe family
    also logs the share of pairs dropped at capacity, and is held against
    teacher forcing at TF_CAPACITY_FACTOR on the same weights; the vlm
    family then runs ``patch_path``.  Returns each kernel's launches in the
    main run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.transformer import LM

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM.init(cfg, seed=0, device=dev, dtype=getattr(torch, param_dtype))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = make_prompts(cfg, batch, prompt, seed=0, device=dev)
    fe = None
    if frames:
        fe = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (batch, frames, cfg.d_model), dtype=np.float32)).to(
            dev, torch.bfloat16)
    log(f"{describe(cfg, param_dtype)}; init {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held, init peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def serve(n):
        return generate(lm, prompts, n, fe, max_len)
    serve(2)                          # warm-up: allocator, cuBLAS, kernel
    (_, prefill_variants), per_prefill, prefill_ok = counted(
        expect, lambda: attention_variants(lambda: serve(1)))
    torch.cuda.reset_peak_memory_stats()
    (res, variants), launches, run_ok = counted(
        expect, lambda: attention_variants(lambda: serve(DECODE_STEPS + 1)))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    shape = f"{batch}x{prompt}" + (f" on {frames} frames" if frames else "")
    log(f"{cfg.name} prefill {shape}: {res.prefill_s * 1e3:.2f} ms; "
        f"decode {res.decode_s / DECODE_STEPS * 1e3:.3f} ms/step, "
        f"{DECODE_STEPS * batch / res.decode_s:.1f} tok/s; "
        f"peak memory {peak_gb:.2f} GiB; {nvidia_smi()}")
    pre_bound, dec_bound, rec_ms = serve_bounds(cfg, batch, prompt,
                                                DECODE_STEPS, frames)
    if cfg.family == "moe":
        pre_how = "; ".join(f"{k} {v:.3f}" for k, v in moe_prefill_parts(
            cfg, BATCH, PROMPT).items()) + " ms"
        _, worst_idx, capacity = moe_drop_share(lm, prompts)
        time_moe_dispatch(worst_idx, capacity, cfg, dev)
        del worst_idx
    elif cfg.family == "hybrid":
        pre_how = "; ".join(f"{k} {v:.3f}" for k, v in hybrid_prefill_parts(
            cfg, BATCH, PROMPT).items()) + (
            f" ms: bf16 products at 989 TFLOP/s, {cfg.num_layers} recurrence "
            f"calls at their bound")
    elif cfg.family == "audio":
        pre_how = "; ".join(f"{k} {v:.4f}" for k, v in audio_prefill_parts(
            cfg, batch, prompt, frames).items()) + (
            " ms: bf16 products at 989 TFLOP/s")
    elif rec_ms:
        pre_how = (f"{pre_bound - rec_ms:.3f} ms of bf16 products at 989 "
                   f"TFLOP/s + {rec_ms:.3f} ms for {cfg.num_layers} "
                   f"recurrence calls at their bound")
    else:
        pre_how = "; ".join(f"{k} {v:.3f}" for k, v in dense_prefill_parts(
            cfg, batch, prompt).items()) + " ms: bf16 products at 989 TFLOP/s"
    log(f"{cfg.name} serve bounds on the card: prefill {pre_bound:.3f} ms "
        f"({pre_how}), decode {dec_bound:.4f} ms/step (bytes); measured / "
        f"bound: prefill {res.prefill_s * 1e3 / pre_bound:.2f}x, decode "
        f"{res.decode_s / DECODE_STEPS * 1e3 / dec_bound:.1f}x")
    log(f"kernel launches on the {cfg.name} path: {per_prefill} per prefill"
        f" alone, {launches} in prefill + {DECODE_STEPS} decode steps; "
        f"expected {expect} in both, the others 0; attention variants of "
        f"the main run: {dict((v, variants.count(v)) for v in set(variants))}")
    if not (prefill_ok and run_ok):
        fail(f"{cfg.name} launches: {per_prefill} per prefill and "
             f"{launches} with decode, expected {expect} in both (none in "
             f"decode)")
    if variant and set(variants) | set(prefill_variants) != {variant}:
        fail(f"{cfg.name}'s attention launches took {variants} (prefill "
             f"alone {prefill_variants}), not only {variant}")
    if tuple(res.tokens.shape) != (batch, DECODE_STEPS + 1):
        fail(f"{cfg.name} generated tokens of shape "
             f"{tuple(res.tokens.shape)}")
    if not bool(torch.isfinite(res.last_logits.float()).all()):
        fail(f"{cfg.name} decode logits are not finite")

    if cfg.family == "moe":
        moe_teacher_forcing(lm, prompts, expect)
    elif cfg.family == "hybrid":
        hybrid_teacher_forcing(lm, prompts, res, expect)
    else:
        teacher_forcing(lm, prompts, res, expect, frames=fe, variant=variant)
    if cfg.family == "audio":
        audio_f32_teacher_forcing(lm, prompts, fe, expect, max_len)
    if cfg.frontend == "patch":
        patch_path(lm, prompts, expect, variant, res.prefill_s * 1e3)
    profile_serve(lm, prompts, res.tokens,
                  MOE_KINDS if cfg.family == "moe" else KERNEL_KINDS, fe,
                  max_len)
    del lm, res, prompts, fe
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 4c. training
# ---------------------------------------------------------------------------

def grads_of(fn, ins, weights):
    """(outputs, grads of sum(output x weight) w.r.t. each input) of ``fn``
    on fresh leaf copies of ``ins`` (None stays None)."""
    leaves = [None if x is None else x.detach().clone().requires_grad_()
              for x in ins]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
    return [o.detach() for o in outs], [None if x is None else x.grad
                                        for x in leaves]


def grad_error(got, want, bf16: bool):
    """(max abs error, within tolerance) of one grad against its
    reference: bf16 one ulp of the reference (BF16_TOL where |g| < 2),
    float32 F32_TOL."""
    import torch
    diff = (got.float() - want.float()).abs()
    within = (bool((diff <= bf16_bound(want.float())).all()) if bf16 else
              torch.allclose(got, want, atol=F32_TOL, rtol=F32_TOL))
    return diff.max().item(), within and bool(torch.isfinite(got).all())


def check_function_grads(dev) -> dict:
    """Phase 4c (a): each autograd Function's grads on the card against
    autograd through its plain formulation alone.  Returns the max abs
    grad error of each."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6 as kr
    from repro_torch.models.attention import blocked_attention
    from repro_torch.models.ssm import chunked_linear_attention_scan
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {"flash_attention": 0.0, "rwkv6_chunked": 0.0}
    cases = [(dt, hd, s, None) for dt in (torch.bfloat16, torch.float32)
             for hd in (64, 32) for s in (256, 2048)]
    cases.append((torch.bfloat16, 64, 2048, 256))
    for dtype, hd, s, window in cases:
        q, k, v = (torch.randn((1, s, h, hd), generator=gen, device=dev)
                   .to(dtype) for h in (32, 4, 4))
        w = torch.randn(q.shape, generator=gen, device=dev)
        before = fa.launches
        _, got = grads_of(lambda *x: ops.attention(*x, window=window),
                          (q, k, v), (w,))
        launched = fa.launches - before
        _, want = grads_of(lambda *x: blocked_attention(*x, window=window),
                           (q, k, v), (w,))
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        errs = [grad_error(g, r, bf16) for g, r in zip(got, want)]
        err = max(e for e, _ in errs)
        ok = all(o for _, o in errs) and launched == 1
        worst["flash_attention"] = max(worst["flash_attention"], err)
        log(f"grad flash_attention {str(dtype):14s} hd {hd:3d} GQA 32/4 S "
            f"{s:5d} {'window ' + str(window) if window else 'causal    '}"
            f" {fa.last_variant or '-':9s} dq/dk/dv max_abs_err "
            + "/".join(f"{e:.3e}" for e, _ in errs)
            + f" (tol {'one bf16 ulp, 8e-3 where |g| < 2' if bf16 else F32_TOL}"
            f"); kernel launches {launched} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash attention's Function grads disagree with autograd "
                 f"through blocked_attention (dtype {dtype}, hd {hd}, S {s})")
    for excl in (True, False):
        for with_s0 in (False, True):
            q, k, v, ld, u = rwkv6_case_inputs(dev, (2, 4, 256, 64, 64),
                                               excl, "model", 11)
            s0 = (torch.randn((2, 4, 64, 64), generator=gen, device=dev)
                  if with_s0 else None)
            ws = (torch.randn((2, 4, 256, 64), generator=gen, device=dev),
                  torch.randn((2, 4, 64, 64), generator=gen, device=dev))
            before = kr.launches
            _, got = grads_of(lambda *x: ops.rwkv6_mix_state(
                *x[:4], bonus=x[4], chunk=16, initial_state=x[5]),
                (q, k, v, ld, u, s0), ws)
            launched = kr.launches - before
            _, want = grads_of(lambda *x: chunked_linear_attention_scan(
                *x[:4], bonus=x[4], chunk=16, initial_state=x[5]),
                (q, k, v, ld, u, s0), ws)
            torch.cuda.synchronize()
            errs = [grad_error(g, r, False) for g, r in zip(got, want)
                    if r is not None]
            err = max(e for e, _ in errs)
            ok = all(o for _, o in errs) and launched == 1
            worst["rwkv6_chunked"] = max(worst["rwkv6_chunked"], err)
            log(f"grad rwkv6 B·H 8 T 256 K 64 V 64 "
                f"{'bonus    ' if excl else 'inclusive'} s0 "
                f"{'yes' if with_s0 else 'no '} max_abs_err over "
                f"{len(errs)} grads {err:.3e} (tol {F32_TOL:g}); kernel "
                f"launches {launched} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail("the recurrence's Function grads disagree with "
                     "autograd through the chunk scan")
    torch.cuda.empty_cache()
    return worst


def train_bound(cfg, batch: int, seq: int):
    """Least time of one training step on the card: the bf16 products (6 x
    the layer matrices and the head x tokens; the attention's live causal
    pairs 4 times its forward: the kernel's forward, the recompute, and the
    backward's four products, twice a forward) over 989 TFLOP/s, plus the
    optimizer's float32 bytes (p, g, m, v read, p, m, v written once) over
    3.35 TB/s.  Returns (ms, products ms, optimizer ms, FLOP, bytes)."""
    d, hd = cfg.d_model, cfg.head_dim_
    mats = cfg.num_layers * (2 * d * cfg.num_heads * hd
                             + 2 * d * cfg.num_kv_heads * hd
                             + 3 * d * cfg.d_ff)
    head = d * cfg.vocab_size
    attn_fwd = (cfg.num_layers * 4 * hd * cfg.num_heads * batch
                * live_pairs(seq, seq, True, None))
    flops = 6 * (mats + head) * batch * seq + 4 * attn_fwd
    nbytes = 7 * 4 * cfg.param_count()
    ops_ms, opt_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return ops_ms + opt_ms, ops_ms, opt_ms, flops, nbytes


def kernels_under(evt):
    """(name, device us) of every kernel launched under a profiler event
    and its CPU children."""
    for kern in evt.kernels:
        yield kern.name, kern.duration
    for child in evt.cpu_children:
        yield from kernels_under(child)


def profile_train_step(step_fn, state, batch, top: int = 8) -> dict:
    """One training step under torch.profiler, its device time split by
    kind: the attention kernel; the attention backward, i.e. the
    ``blocked_attention`` recompute and its grads; the optimizer (each
    found under a ``record_function`` range that wraps it here, for this
    run only); the other GEMMs; the rest.  Logs the device idle share and
    the kernels that take most device time.  Returns the split in ms, with
    the wall and idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as ts_mod
    ranges = {"attention backward (recompute)": "attention backward",
              "optimizer": "adamw_update"}
    backward, update = ops._FlashAttention.backward, ts_mod.adamw_update

    def wrap(fn, name):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner
    ops._FlashAttention.backward = staticmethod(
        wrap(backward, ranges["attention backward (recompute)"]))
    ts_mod.adamw_update = wrap(update, ranges["optimizer"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = step_fn(*state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops._FlashAttention.backward = staticmethod(backward)
    ts_mod.adamw_update = update

    def kind_of(name):
        return next((k for k, marks in KERNEL_KINDS.items()
                     if any(m in name for m in marks)), "other")
    total, rows = {}, []
    for e in prof.key_averages():
        # the ranges' own device-side annotations span kernels; not kernels
        if e.device_type == DeviceType.CUDA and e.key not in ranges.values():
            ms = e.self_device_time_total / 1e3
            rows.append((ms, e.count, e.key))
            total[kind_of(e.key)] = total.get(kind_of(e.key), 0.0) + ms
    busy = sum(total.values())
    split = {"attention kernel": total.get("attention", 0.0)}
    inside = {}
    for key, name in ranges.items():
        ms = 0.0
        for e in prof.events():
            if e.name == name:
                for kname, us in kernels_under(e):
                    ms += us / 1e3
                    inside[kind_of(kname)] = inside.get(kind_of(kname),
                                                        0.0) + us / 1e3
        split[key] = ms
    split["gemm (outside the ranges)"] = total.get("gemm", 0.0) - \
        inside.get("gemm", 0.0)
    split["other"] = busy - sum(split.values())
    idle = 1 - busy / wall_ms
    log(f"profile train step: wall {wall_ms:.3f} ms, kernels {busy:.3f} ms,"
        f" device idle share {idle:.3f}")
    log("profile train step: device ms by kind: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items())
        + f" (GEMMs inside the ranges {inside.get('gemm', 0.0):.3f})")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"profile train step:   {ms:9.3f} ms {count:6d}x {key[:90]}")
    if not all(split[k] for k in ranges):
        log("profile train step: a range found no kernels (the profiler did "
            "not link them); its time stays in gemm / other")
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle": idle, **split}


def train_phase(dev, smi: str) -> dict:
    """Phase 4c (b): full-width tinyllama-1.1b training."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.train.tree import flatten

    mods = kernel_counters()
    cfg = get_config("tinyllama-1.1b")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = TRAIN_WARMUP + TRAIN_TIMED
    log(f"train {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model},"
        f" {cfg.num_heads} / {cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B params; "
        f"float32 masters, {cfg.dtype} compute, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, AdamW float32 state, remat none")

    # the first step's params and batch: every master leaf gets a grad
    params = init_lm(cfg, 0, device=dev)
    batch = SyntheticSource(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                       TRAIN_BATCH)).batch(0)
    toks, labels = (torch.as_tensor(batch[n]).to(dev, torch.long)
                    for n in ("tokens", "labels"))
    loss, grads = loss_and_grads(cfg, params, toks, labels)
    leaf_norms = {path: torch.linalg.vector_norm(g.float()).item()
                  for path, g in flatten(grads)}
    bad = [p for p, n in leaf_norms.items() if not np.isfinite(n)]
    log(f"train first step: loss {loss.item():.4f}; {len(leaf_norms)} of "
        f"{len(flatten(params))} master leaves have a grad, non-finite: "
        f"{bad or 'none'}; grad norms: " + ", ".join(
            f"{p} {n:.3e}" for p, n in leaf_norms.items()))
    if (len(leaf_norms) != len(flatten(params)) or bad
            or not np.isfinite(loss.item())):
        fail(f"train first step: grads missing or not finite ({bad})")
    del grads, loss

    # one step under the profiler, after one warm-up step
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=steps, total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg)
    state = step_fn(params, adamw_init(params, opt_cfg), None, batch)[:3]
    prof = profile_train_step(step_fn, state, batch)
    del params, state, step_fn
    torch.cuda.empty_cache()

    # the launcher: grant, rank order, init, train_step, run_training
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    report = launch_train.main([
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
        str(steps), "--gpus", str(TRAIN_GPUS), "--strategy", "vclos"])
    counts = {name: mod.launches for name, mod in mods.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    timed = report.step_times[TRAIN_WARMUP:]
    step_ms = 1e3 * sum(timed) / len(timed)
    bound_ms, ops_ms, opt_ms, flops, nbytes = train_bound(cfg, TRAIN_BATCH,
                                                          TRAIN_SEQ)
    log(f"train {cfg.name} via launch.train.main ({TRAIN_GPUS}-GPU vclos "
        f"grant on CLUSTER512): step ms " + ", ".join(
            f"{t * 1e3:.2f}" for t in report.step_times)
        + f" ({TRAIN_WARMUP} warm-up); timed mean {step_ms:.2f} ms/step, "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory {peak_gb:.2f} "
        f"GiB; {smi}")
    log(f"train losses {['%.4f' % x for x in report.losses]}; grad norms "
        f"{['%.4f' % x for x in report.grad_norms]}")
    log(f"train step bound {bound_ms:.3f} ms: products {ops_ms:.3f} ms "
        f"({flops:.4g} FLOP at 989 TFLOP/s: 6 x matrices x {tokens} tokens "
        f"+ 4 x the causal attention forward) + optimizer {opt_ms:.3f} ms "
        f"({nbytes:.4g} B of float32 p, g, m, v read and p, m, v written at "
        f"3.35 TB/s); measured / bound {step_ms / bound_ms:.2f}x")
    per_step = counts["flash_attention"] / steps
    log(f"train kernel launches over {steps} steps: {counts} "
        f"({per_step:g} attention launches a step)")
    if counts["flash_attention"] != cfg.num_layers * steps:
        fail(f"training launched flash attention {counts['flash_attention']}"
             f" times in {steps} steps, expected {cfg.num_layers} a step")
    if counts["rwkv6_chunked"] or counts["phase_max"]:
        fail(f"training launched other kernels: {counts}")
    if report.steps_run != steps or not all(map(np.isfinite,
                                                report.losses)):
        fail(f"training losses not finite or steps missing: {report}")
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "bound_ms": bound_ms, "peak_gb": peak_gb,
            "launches_per_step": per_step, "profile": prof}


def resume_phase(dev) -> None:
    """Phase 4c (c): checkpoint and resume on the card."""
    import tempfile
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import rwkv6 as kr
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_train_step
    for arch in ("tinyllama-1.1b", "rwkv6-3b"):
        cfg = reduced(get_config(arch), dtype="float32")
        opt = OptimizerConfig(lr=1e-3, warmup_steps=1,
                              total_steps=RESUME_STEPS)
        data = DataConfig(cfg.vocab_size, 64, 4)
        step = make_train_step(cfg, opt)

        def run(total, cdir):
            return run_training(
                cfg, step, init_lm(cfg, 0, device=dev), opt, data,
                LoopConfig(total_steps=total, ckpt_every=RESUME_SPLIT,
                           ckpt_dir=cdir, log_every=0), log=lambda m: None)
        with tempfile.TemporaryDirectory() as a, \
                tempfile.TemporaryDirectory() as b:
            kr.launches = 0
            full = run(RESUME_STEPS, a)
            rec = kr.launches
            first = run(RESUME_SPLIT, b)
            resumed = run(RESUME_STEPS, b)
        tail, want = resumed.losses, full.losses[RESUME_SPLIT:]
        diff = max(abs(x - y) for x, y in zip(tail, want))
        log(f"resume {cfg.name} reduced float32 on the card: uninterrupted "
            f"losses {['%.7f' % x for x in full.losses]}; {RESUME_SPLIT} "
            f"steps, then resumed from step {resumed.resumed_from}: "
            f"{['%.7f' % x for x in first.losses + tail]}; steps 3-4 max "
            f"abs diff {diff:.3e} ({'bit-exact' if tail == want else 'not bit-exact'})"
            + (f"; recurrence launches {rec} in {RESUME_STEPS} steps"
               if cfg.family == "ssm" else ""))
        if resumed.resumed_from != RESUME_SPLIT or len(tail) != len(want) \
                or diff > 1e-4:
            fail(f"resume of {cfg.name} disagrees with the uninterrupted run")
        if cfg.family == "ssm" and rec != cfg.num_layers * RESUME_STEPS:
            fail(f"rwkv6 training launched the recurrence {rec} times in "
                 f"{RESUME_STEPS} steps, expected one per layer per step")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4h. distributed: ranks that share the card
# ---------------------------------------------------------------------------

def dist_workdir() -> Path:
    """Rendezvous files and each rank's stderr (gitignored ``build/``)."""
    return ROOT / "build" / "dist"


def quiet_dtensor() -> None:
    """DTensor logs a warning per multi-step redistribution; the phase's log
    keeps the measurements."""
    import logging
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)


def dist_rank_device():
    """cuda:0 for a rank; under gloo, DTensor's gathers through the c10d
    collectives the probe holds (``testing.gloo_cuda``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.testing import gloo_cuda
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    quiet_dtensor()
    if dist.get_backend() == "gloo":
        gloo_cuda.use_c10d_collectives()
    return dev


def probe_rank(rank: int, world: int, nbytes: int) -> dict:
    """Step 1: each collective the slice needs, on CUDA tensors of
    ``nbytes`` under the group's backend, checked against its plain
    expectation and timed (host clock, after a warm-up call)."""
    import torch
    import torch.distributed as dist
    dev = dist_rank_device()
    n = nbytes // 4
    x = torch.full((n,), float(rank + 1), device=dev)
    times = {}

    def timed(name, fn):
        for _ in range(2):                      # warm-up, then timed
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    total = world * (world + 1) / 2
    y = x.clone()
    timed("all_reduce", lambda: dist.all_reduce(y.copy_(x)))
    assert bool((y == total).all()), "all_reduce"
    g = torch.empty(n * world, device=dev)
    timed("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(g, x))
    want = torch.arange(1, world + 1, device=dev,
                        dtype=torch.float32).repeat_interleave(n)
    assert torch.equal(g, want), "all_gather_into_tensor"
    rs = torch.empty(n // world, device=dev)
    timed("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(rs, x))
    assert bool((rs == total).all()), "reduce_scatter_tensor"
    src = torch.arange(n, device=dev, dtype=torch.float32) + rank * n
    a2a = torch.empty_like(src)
    timed("all_to_all_single", lambda: dist.all_to_all_single(a2a, src))
    c = n // world
    want = torch.cat([torch.arange(rank * c, (rank + 1) * c, device=dev,
                                   dtype=torch.float32) + j * n
                      for j in range(world)])
    assert torch.equal(a2a, want), "all_to_all_single"
    b = x.clone()
    timed("broadcast", lambda: dist.broadcast(b.copy_(x), 0))
    assert bool((b == 1).all()), "broadcast"
    return times


def first_batch(cfg, batch: int, seq: int) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    return SyntheticSource(DataConfig(cfg.vocab_size, seq, batch)).batch(0)


def single_rank_rank(rank: int, world: int, batch: int, seq: int) -> dict:
    """Step 2: world size 1 under NCCL.  Full-width tinyllama's first-step
    loss and grads with no mesh, then through make_context on a (1, 1)
    mesh, sharded_param_specs and make_train_step(ctx=)."""
    import torch
    from repro_torch.bridge import place_params
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.dryrun import sharded_param_specs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.parallel.sharding import distribute_local, make_context
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                             global_norm)
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.train.tree import flatten
    dev = dist_rank_device()
    cfg = get_config("tinyllama-1.1b")
    data = first_batch(cfg, batch, seq)
    params = init_lm(cfg, 0, device=dev)
    toks, labels = (torch.as_tensor(data[n]).to(dev, torch.long)
                    for n in ("tokens", "labels"))
    loss0, g0 = loss_and_grads(cfg, params, toks, labels)
    gnorm0 = global_norm(g0).item()
    g0 = dict(flatten(g0))
    mesh = make_smoke_mesh((1, 1), device="cuda")
    ctx = make_context(mesh, cfg, RunConfig(remat="none",
                                            sequence_parallel=False))
    shard = sharded_param_specs(params, cfg, ctx.mesh)
    dparams = place_params(params, cfg, ctx.mesh)
    del params
    rows = ctx.placements("dp", None)
    fa.launches = 0
    loss1, g1 = loss_and_grads(cfg, dparams, distribute_local(
        toks, ctx.dmesh, rows), distribute_local(labels, ctx.dmesh, rows),
        ctx=ctx)
    launches = fa.launches
    loss_err = abs(loss1.full_tensor().item() - loss0.item())
    grad_err, exact = 0.0, loss1.full_tensor().item() == loss0.item()
    for path, g in flatten(g1):
        local = g.full_tensor()
        grad_err = max(grad_err, (local.float() - g0[path].float()).abs()
                       .max().item())
        exact = exact and torch.equal(local, g0[path])
    del g1, g0
    torch.cuda.empty_cache()
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, opt_cfg, ctx=ctx, grad_shardings=shard)
    fa.launches = 0
    _, _, _, m = step(dparams, adamw_init(dparams, opt_cfg), None, data)
    return {"loss": loss0.item(), "grad_norm": gnorm0,
            "step_loss": m["loss"].item(), "step_grad_norm":
            m["grad_norm"].item(), "loss_err": loss_err,
            "grad_err": grad_err, "bit_exact": bool(exact),
            "launches": launches, "step_launches": fa.launches,
            "last_shape": fa.last_shape,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def fsdp_tp_rank(rank: int, world: int, order, batch: int, seq: int,
                 warmup: int, timed: int) -> dict:
    """Step 3: FSDP + TP on (data 2, model 2), the rank order of a vclos
    grant.  Full-width tinyllama, float32 masters drawn into their shards,
    bf16 compute, AdamW float32, remat none; warm-up and timed steps, then
    one step under torch.profiler on rank 0."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import init_sharded
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.dryrun import sharded_param_specs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import abstract_params, make_context
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    dist_rank_device()
    cfg = get_config("tinyllama-1.1b")
    mesh = make_smoke_mesh((2, 2), ranks=order, device="cuda")
    ctx = make_context(mesh, cfg, RunConfig(remat="none",
                                            sequence_parallel=False))
    t0 = time.perf_counter()
    params = init_sharded(cfg, ctx.mesh, seed=0)
    init_s = time.perf_counter() - t0
    shard = sharded_param_specs(abstract_params(cfg), cfg, ctx.mesh)
    steps = warmup + timed
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=steps + 1,
                              total_steps=steps + 1)
    step = make_train_step(cfg, opt_cfg, ctx=ctx, grad_shardings=shard)
    state = (params, adamw_init(params, opt_cfg), None)
    source = SyntheticSource(DataConfig(cfg.vocab_size, seq, batch))
    losses, norms, times, launches = [], [], [], []
    for i in range(steps):
        data = source.batch(i)
        fa.launches = 0
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, m = step(*state, data)
        torch.cuda.synchronize()
        dist.barrier()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        launches.append(fa.launches)
    shape = fa.last_shape
    data = source.batch(steps)
    if rank == 0:
        wall, rows = device_profile("4h fsdp+tp step (rank 0)",
                                    lambda: step(*state, data),
                                    kinds=DIST_KINDS)
    else:
        wall, rows = None, None
        step(*state, data)
    torch.cuda.synchronize()
    dist.barrier()
    return {"losses": losses, "grad_norms": norms, "step_s": times,
            "launches": launches, "last_shape": shape, "init_s": init_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "finite": bool(np.all(np.isfinite(losses))),
            "profile": None if rows is None else profile_split(wall, rows)}


def ep_rank(rank: int, world: int, layers: int, batch: int, seq: int,
            factor: float) -> dict:
    """Step 4: deepseek-moe-16b at full width on (1, 2): EP 2 over "a",
    bf16-held weights drawn into their shards by one rank at a time; one
    prefill forward's last-position logits in float32 compute and in bf16,
    the sequence-sharded dispatch through moe_apply_a2a."""
    import dataclasses

    import torch
    from repro_torch.bridge import init_sharded
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import distribute_local, make_context
    dev = dist_rank_device()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=layers, moe_capacity_factor=factor)
    mesh = make_smoke_mesh((1, 2), device="cuda")
    ctx = make_context(mesh, cfg, RunConfig(remat="none",
                                            sequence_parallel=False))
    t0 = time.perf_counter()
    params = init_sharded(cfg, ctx.mesh, seed=0, dtype=torch.bfloat16)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    toks = distribute_local(ep_prompts(cfg, batch, seq, dev), ctx.dmesh,
                            ctx.placements("dp", None))
    out = {"init_s": init_s, "init_peak_gb": init_peak,
           "ep_axis": ctx.ep_axis, "view": tuple(ctx.mesh.mesh.shape)}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        fa.launches = moe.a2a_calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = ep_last_logits(params, c, toks, ctx)
        torch.cuda.synchronize()
        out[dtype] = {"ms": (time.perf_counter() - t0) * 1e3,
                      "last": last.float().cpu().numpy(),
                      "launches": fa.launches, "a2a": moe.a2a_calls,
                      "last_shape": fa.last_shape,
                      "variant": fa.last_variant}
    c = dataclasses.replace(cfg, dtype="bfloat16")
    if rank == 0:
        wall, rows = device_profile(
            "4h ep prefill bf16 (rank 0)",
            lambda: ep_last_logits(params, c, toks, ctx), kinds=DIST_KINDS)
        out["profile"] = profile_split(wall, rows)
    else:
        ep_last_logits(params, c, toks, ctx)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def ep_prompts(cfg, batch: int, seq: int, dev):
    import torch
    gen = torch.Generator(device="cpu").manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (batch, seq),
                         generator=gen).to(dev)


def ep_last_logits(params, cfg, tokens, ctx):
    """Last-position logits (B, V) of a prefill, as ``prefill`` takes them:
    the final hidden states' last row through the LM head."""
    import torch
    from repro_torch.models.context import NULL_CTX
    from repro_torch.models.transformer import (hidden_states,
                                                logits_from_hidden)
    with torch.no_grad(), ctx.scope():
        x, _ = hidden_states(params, cfg, tokens, ctx=ctx)
        logits = logits_from_hidden(params, cfg, x[:, -1:], ctx)
    if ctx is NULL_CTX:
        return logits[:, 0]
    return logits.full_tensor()[:, 0]


def profile_split(wall_ms: float, rows) -> dict:
    busy = sum(r[0] for r in rows)
    split = dict.fromkeys([*DIST_KINDS, "other"], 0.0)
    for ms, _, key in rows:
        split[next((kind for kind, marks in DIST_KINDS.items()
                    if any(m in key for m in marks)), "other")] += ms
    return {"wall_ms": wall_ms, "kernel_ms": busy,
            "idle": 1 - busy / wall_ms if busy else float("nan"),
            "by_kind": split}


def distributed_phase(smi: str) -> dict:
    """Phase 4h: (1) the collective probe, (2) world size 1 under NCCL,
    (3) FSDP + TP on (2, 2), (4) expert parallelism on (1, 2).  Ranks are
    spawned on cuda:0 and joined with a deadline; a rank's failure, a hang
    or a missed gate exits non-zero."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import vclos_device_order
    from repro_torch.models.transformer import init_lm
    from repro_torch.testing import run_ranks
    torch.cuda.empty_cache()
    work = dist_workdir()
    out = {}
    label = "gloo, host-staged, one card"

    # (1) the collective probe: 4 ranks, gloo, CUDA tensors, 64 MB
    t0 = time.perf_counter()
    probe = run_ranks(probe_rank, DIST_WORLD, (PROBE_BYTES,), workdir=work,
                      timeout=300)
    ms = {k: max(r[k] for r in probe) for k in probe[0]}
    log(f"4h probe: {DIST_WORLD} ranks, gloo on CUDA tensors of "
        f"{PROBE_BYTES >> 20} MB, each checked against its plain "
        f"expectation: " + ", ".join(f"{k} ok {v:.1f} ms" for k, v in
                                    ms.items())
        + f" (slowest rank; {label}); {time.perf_counter() - t0:.1f} s")
    out["probe_ms"] = ms

    # (2) world size 1 under NCCL: the mesh path against no mesh
    t0 = time.perf_counter()
    one = run_ranks(single_rank_rank, 1, (TRAIN_BATCH, TRAIN_SEQ),
                    workdir=work, timeout=600, backend="nccl")[0]
    cfg = get_config("tinyllama-1.1b")
    log(f"4h world 1 (nccl, (1, 1) mesh), full-width {cfg.name} at "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, first step's params and batch: loss "
        f"{one['loss']:.6f}, |loss - no mesh| {one['loss_err']:.3e}, max "
        f"|grad - no mesh| {one['grad_err']:.3e}, bit-exact "
        f"{one['bit_exact']}; attention launches {one['launches']} (last "
        f"shape {one['last_shape']}); make_train_step(ctx=) loss "
        f"{one['step_loss']:.6f} grad norm {one['step_grad_norm']:.6f} (no "
        f"mesh {one['grad_norm']:.6f}), {one['step_launches']} launches; "
        f"peak {one['peak_gb']:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    if one["loss_err"] > 1e-6 or one["grad_err"] > 1e-6:
        fail(f"4h world 1: the (1, 1) mesh's loss / grads differ from no "
             f"mesh by {one['loss_err']:.3e} / {one['grad_err']:.3e} "
             f"(tol 1e-6)")
    if one["launches"] != cfg.num_layers or \
            one["step_launches"] != cfg.num_layers:
        fail(f"4h world 1: {one['launches']} / {one['step_launches']} "
             f"attention launches, expected {cfg.num_layers}")
    if abs(one["step_loss"] - one["loss"]) > 1e-6:
        fail(f"4h world 1: train step loss {one['step_loss']} vs "
             f"{one['loss']}")
    out["world1"] = {k: one[k] for k in ("loss", "loss_err", "grad_err",
                                         "bit_exact", "launches")}

    # (3) FSDP + TP on (data 2, model 2), ranks in a vclos grant's order
    grant = core.IsolatedScheduler(core.CLUSTER512).submit(0, DIST_WORLD)
    order = vclos_device_order(grant, core.CLUSTER512,
                               devices=list(range(DIST_WORLD)))
    t0 = time.perf_counter()
    ranks = run_ranks(fsdp_tp_rank, DIST_WORLD,
                      (order, TRAIN_BATCH, TRAIN_SEQ, DIST_WARMUP,
                       DIST_TIMED), workdir=work, timeout=900)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    steps = DIST_WARMUP + DIST_TIMED
    step_s = [max(r["step_s"][i] for r in ranks) for i in range(steps)]
    step_ms = 1e3 * sum(step_s[DIST_WARMUP:]) / DIST_TIMED
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peaks = [r["peak_gb"] for r in ranks]
    log(f"4h fsdp+tp (data 2, model 2), rank order {order} from a "
        f"{DIST_WORLD}-GPU vclos grant on CLUSTER512 (placement "
        f"{grant.placement.gpus}), full-width {cfg.name}, float32 masters "
        f"drawn into their shards ({r0['init_s']:.1f} s), bf16 compute, "
        f"AdamW float32, remat none, {TRAIN_BATCH} x {TRAIN_SEQ}: step ms "
        + ", ".join(f"{s * 1e3:.1f}" for s in step_s)
        + f" ({DIST_WARMUP} warm-up); timed {step_ms:.1f} ms/step, "
        f"{tokens / step_ms * 1e3:.0f} tokens/s ({label}); losses "
        f"{['%.5f' % x for x in r0['losses']]}, grad norms "
        f"{['%.5f' % x for x in r0['grad_norms']]}; attention launches a "
        f"step by rank {[r['launches'] for r in ranks]}, last shape "
        f"{r0['last_shape']}; peak GiB by rank "
        f"{['%.2f' % p for p in peaks]}, sum {sum(peaks):.2f}; {smi}; "
        f"{wall:.1f} s")
    loss_gap = abs(r0["losses"][0] - one["loss"])
    norm_gap = abs(r0["grad_norms"][0] - one["grad_norm"]) / one["grad_norm"]
    log(f"4h fsdp+tp first step vs the single rank: loss "
        f"{r0['losses'][0]:.6f} vs {one['loss']:.6f} (|gap| "
        f"{loss_gap:.3e}, tol 1e-2), grad norm {r0['grad_norms'][0]:.6f} vs "
        f"{one['grad_norm']:.6f} (relative {norm_gap:.3e}, tol 1e-2)")
    if loss_gap > 1e-2 or norm_gap > 1e-2:
        fail("4h fsdp+tp: the first step misses the single rank's loss or "
             "grad norm")
    if not all(r["finite"] for r in ranks):
        fail("4h fsdp+tp: a loss is not finite")
    if any(n != cfg.num_layers for r in ranks for n in r["launches"]):
        fail(f"4h fsdp+tp: attention launches a step "
             f"{[r['launches'] for r in ranks]}, expected {cfg.num_layers}")
    local = (TRAIN_BATCH // 2, TRAIN_SEQ, cfg.num_heads // 2,
             cfg.num_kv_heads // 2, cfg.head_dim_)
    if any(tuple(r["last_shape"]) != local for r in ranks):
        fail(f"4h fsdp+tp: kernels ran at {[r['last_shape'] for r in ranks]}"
             f", not the local {local}")
    prof = r0["profile"]
    log(f"4h fsdp+tp profiled step (rank 0): wall {prof['wall_ms']:.1f} ms, "
        f"kernels {prof['kernel_ms']:.1f} ms, idle {prof['idle']:.3f}; "
        f"device ms by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in prof["by_kind"].items() if v))
    out["fsdp_tp"] = {"order": order, "step_ms": step_ms,
                      "tokens_per_s": tokens / step_ms * 1e3,
                      "losses": r0["losses"], "grad_norms": r0["grad_norms"],
                      "launches_per_step": r0["launches"][0],
                      "local_shape": list(local), "peak_gb": peaks,
                      "profile": prof}
    del ranks

    # (4) expert parallelism on (1, 2): the single-rank forward first
    mcfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                               num_layers=EP_LAYERS,
                               moe_capacity_factor=EP_FACTOR)
    dev = torch.device("cuda")
    params = init_lm(mcfg, 0, device=dev, dtype=torch.bfloat16)
    prompts = ep_prompts(mcfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    from repro_torch.models.context import NULL_CTX
    single = {dt: ep_last_logits(params, dataclasses.replace(mcfg, dtype=dt),
                                 prompts, NULL_CTX).float().cpu().numpy()
              for dt in ("float32", "bfloat16")}
    del params, prompts
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(ep_rank, 2, (EP_LAYERS, TRAIN_BATCH, TRAIN_SEQ,
                                   EP_FACTOR), workdir=work, timeout=900)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    errs = {dt: float(np.abs(r0[dt]["last"] - single[dt]).max())
            for dt in ("float32", "bfloat16")}
    moe_layers = mcfg.num_layers - mcfg.moe_first_dense
    log(f"4h ep (data 1, model 2 = EP 2 over \"a\"), {mcfg.name} at full "
        f"width, {mcfg.num_layers} of 28 layers (1 dense + {moe_layers} "
        f"MoE), bf16-held weights drawn into their shards one rank at a "
        f"time ({r0['init_s']:.1f} s, rank 0 peak "
        f"{r0['init_peak_gb']:.2f} GiB), prefill {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} at capacity factor {EP_FACTOR:g}: float32 compute "
        f"{r0['float32']['ms']:.1f} ms, last-position logits vs the single "
        f"rank max |diff| {errs['float32']:.3e} (tol 1e-2); bf16 "
        f"{r0['bfloat16']['ms']:.1f} ms, max |diff| {errs['bfloat16']:.3e} "
        f"(recorded); attention launches by rank "
        f"{[r['float32']['launches'] for r in ranks]} (last shape "
        f"{r0['bfloat16']['last_shape']}, {r0['bfloat16']['variant']}), "
        f"all_to_all_single calls by rank "
        f"{[r['float32']['a2a'] for r in ranks]}; peak GiB by rank "
        f"{['%.2f' % r['peak_gb'] for r in ranks]} ({label}); {smi}; "
        f"{wall:.1f} s")
    if errs["float32"] > 1e-2:
        fail(f"4h ep: float32 logits {errs['float32']:.3e} from the single "
             f"rank's (tol 1e-2)")
    for r in ranks:
        for dt in ("float32", "bfloat16"):
            if r[dt]["launches"] != mcfg.num_layers:
                fail(f"4h ep: {r[dt]['launches']} attention launches in a "
                     f"{dt} prefill, expected {mcfg.num_layers}")
            if r[dt]["a2a"] != 2 * moe_layers:
                fail(f"4h ep: {r[dt]['a2a']} all_to_all_single calls, "
                     f"expected 2 per MoE layer ({2 * moe_layers})")
    prof = r0["profile"]
    log(f"4h ep profiled bf16 prefill (rank 0): wall {prof['wall_ms']:.1f} "
        f"ms, kernels {prof['kernel_ms']:.1f} ms, idle {prof['idle']:.3f}; "
        f"device ms by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in prof["by_kind"].items() if v))
    out["ep"] = {"layers": mcfg.num_layers, "factor": EP_FACTOR,
                 "ms": {dt: r0[dt]["ms"] for dt in ("float32", "bfloat16")},
                 "max_abs_err": errs, "launches": r0["float32"]["launches"],
                 "a2a_calls": r0["float32"]["a2a"],
                 "local_shape": list(r0["bfloat16"]["last_shape"]),
                 "peak_gb": [r["peak_gb"] for r in ranks], "profile": prof}
    return out


def grid_lanes():
    """The 72 lanes of the fabric-heavy grid, with fresh jobs (run_lanes
    mutates them)."""
    from repro_torch.core import WorkloadSpec, generate_trace, get_strategy
    return [(generate_trace(WorkloadSpec(
        num_jobs=GRID_JOBS, mean_interarrival=load, seed=seed,
        max_gpus=GRID_MAX_GPUS)), get_strategy(s), seed)
        for s in GRID_STRATEGIES for seed in GRID_SEEDS for load in GRID_LOADS]


def same_reports(a, b) -> bool:
    return all(x.n_finished == y.n_finished and x.jcts == y.jcts
               and x.jwts == y.jwts and x.slowdowns == y.slowdowns
               and x.frag_gpu == y.frag_gpu
               and x.frag_network == y.frag_network
               for x, y in zip(a, b)) and len(a) == len(b)


def simulate_golden() -> int:
    """The golden trace on cuda through the v2 engine; returns launches."""
    from repro_torch.core import (CLUSTER512, WorkloadSpec, generate_trace,
                                  simulate)
    from repro_torch.core import simulator as cs
    from repro_torch.kernels import phase_max as pm
    jobs = generate_trace(WorkloadSpec(num_jobs=200, mean_interarrival=120.0,
                                       seed=0, max_gpus=256))
    total = 0
    for strat, golden in GOLDEN.items():
        cs.solves, before = 0, pm.launches
        t0 = time.perf_counter()
        rep = simulate(CLUSTER512, jobs, strat)
        wall = time.perf_counter() - t0
        launched, solves = pm.launches - before, cs.solves
        ref = simulate(CLUSTER512, jobs, strat, device="cpu")
        log(f"golden {strat:5s} on cuda: avg JCT {rep.avg_jct:.1f} (pinned "
            f"{golden}), {wall:.3f} s; phase_max launches {launched}, v2 "
            f"solves {solves} (reference {GOLDEN_SOLVES[strat]}); jcts equal "
            f"to the cpu run: {rep.jcts == ref.jcts}")
        if round(rep.avg_jct, 1) != golden:
            fail(f"golden {strat}: avg JCT {rep.avg_jct} != {golden}")
        if not same_reports([rep], [ref]):
            fail(f"golden {strat}: cuda schedule differs from the cpu run")
        if not launched == solves == GOLDEN_SOLVES[strat]:
            fail(f"golden {strat}: {launched} launches, {solves} solves, "
                 f"expected {GOLDEN_SOLVES[strat]}")
        total += launched
    return total


def simulate_grid():
    """The 72-lane CLUSTER2048 grid on cuda against cpu.  Returns the main
    run's launches and, for the timing phase, the numpy CSR inputs of the
    calls at the p50 / p90 / max number of values."""
    import numpy as np
    import torch
    from repro_torch.core import CLUSTER2048, fairshare, run_lanes
    from repro_torch.core import batched as cb
    from repro_torch.kernels import phase_max as pm

    lanes = grid_lanes()
    cb.solves, before = 0, pm.launches
    t0 = time.perf_counter()
    reps = run_lanes(CLUSTER2048, lanes)
    torch.cuda.synchronize()
    wall_cuda = time.perf_counter() - t0
    launched, solves = pm.launches - before, cb.solves
    lanes = grid_lanes()
    ref = run_lanes(CLUSTER2048, lanes, device="cpu")
    same = same_reports(reps, ref)
    log(f"grid {len(reps)} lanes, CLUSTER2048, {GRID_JOBS} jobs a lane: "
        f"first run on cuda {wall_cuda:.3f} s (builds the per-trace "
        f"precompute); launches {launched}, solves {solves} (reference "
        f"{GRID_SOLVES}); reports identical to the cpu run: {same}")
    if not same:
        fail("grid: a lane's report on cuda differs from the cpu run")
    if not launched == solves == GRID_SOLVES:
        fail(f"grid: {launched} launches, {solves} solves, expected "
             f"{GRID_SOLVES}")

    # wall seconds in turns, warm: cuda, pr16, numpy, cpu, cpu, numpy, pr16,
    # cuda, with the host time of every solve as the engine calls it.
    # "pr16" (PR 16's route: pageable uploads, a synchronising download)
    # and "numpy" (each solve by host numpy, np.maximum.reduceat, no torch)
    # are yardsticks the port does not offer
    walls = {"cuda": [], "pr16": [], "numpy": [], "cpu": []}
    solve_s = {turn: [] for turn in walls}
    engine_solve = cb.phase_worst_loads
    yardsticks = {"pr16": pr16_route(torch.device("cuda")),
                  "numpy": lambda v, p, device=None:
                  fairshare.phase_worst_numpy(v, p)}
    for turn in ("cuda", "pr16", "numpy", "cpu", "cpu", "numpy", "pr16",
                 "cuda"):
        solve, spent = yardsticks.get(turn, engine_solve), [0.0]

        def timed_solve(v, p, device=None, solve=solve, spent=spent):
            t0 = time.perf_counter()
            out = solve(v, p, device=device)
            spent[0] += time.perf_counter() - t0
            return out
        cb.phase_worst_loads = timed_solve
        lanes = grid_lanes()
        t0 = time.perf_counter()
        run_lanes(CLUSTER2048, lanes,
                  device="cpu" if turn in ("numpy", "cpu") else "cuda")
        torch.cuda.synchronize()
        walls[turn].append(time.perf_counter() - t0)
        solve_s[turn].append(spent[0])
        cb.phase_worst_loads = engine_solve
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    wall_cuda = mean["cuda"]
    log("grid wall, warm, in turns: " + "; ".join(
        f"{k} {v[0]:.3f} / {v[1]:.3f} s (mean {mean[k]:.3f})"
        for k, v in walls.items())
        + f"; {solves / wall_cuda:.1f} solves/s on cuda")
    log(f"grid time in the {solves} solves (host clock around each, as the "
        f"lane engine calls it), same turns: " + "; ".join(
            f"{k} {v[0] * 1e3:.1f} / {v[1] * 1e3:.1f} ms "
            f"({sum(v) / len(v) / solves * 1e6:.1f} us a solve)"
            for k, v in solve_s.items()))

    # instrumented run: CUDA events around every call of the engines' route
    # (kernel.phase_max_host, as fairshare calls it), and its inputs
    calls, events = [], []
    route = fairshare.phase_max_host

    def timed_route(vals, ptr, device):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = route(vals, ptr, device)
        e1.record()
        events.append((e0, e1))
        calls.append((vals.copy(), ptr.copy()))
        return out
    fairshare.phase_max_host = timed_route
    lanes = grid_lanes()
    t0 = time.perf_counter()
    run_lanes(CLUSTER2048, lanes)
    torch.cuda.synchronize()
    wall_timed = time.perf_counter() - t0
    fairshare.phase_max_host = route
    event_ms = sum(a.elapsed_time(b) for a, b in events)
    nvals = np.asarray([len(vals) for vals, _ in calls])
    nseg = np.asarray([len(ptr) - 1 for _, ptr in calls])
    p50, p90, pmax = np.percentile(nvals, [50, 90, 100])
    log(f"grid values per call: p50 {p50:.0f}, p90 {p90:.0f}, max {pmax:.0f};"
        f" segments per call: p50 {np.percentile(nseg, 50):.0f}, max "
        f"{nseg.max()}; {len(calls)} calls")

    # profiled run: copies, kernel device time, idle share
    lanes = grid_lanes()
    wall_prof, rows = device_profile(
        "grid", lambda: run_lanes(CLUSTER2048, lanes))
    copy_ms = sum(ms for ms, _, key in rows if "memcpy" in key.lower())
    kern_ms = sum(ms for ms, _, key in rows if "segment_max" in key)
    log(f"grid split on cuda: wall {wall_cuda * 1e3:.1f} ms; calls "
        f"{event_ms:.3f} ms on the device's clock (CUDA events around each "
        f"call of the route, staging to wait; run of "
        f"{wall_timed * 1e3:.1f} ms), {kern_ms:.3f} ms of kernel and "
        f"{copy_ms:.3f} ms of copies on the device under torch.profiler "
        f"(run of {wall_prof:.1f} ms); host outside the calls "
        f"{wall_cuda * 1e3 - event_ms:.1f} ms")
    order = np.argsort(nvals, kind="stable")
    picks = {label: calls[order[int(round(q * (len(order) - 1)))]]
             for label, q in (("p50", 0.5), ("p90", 0.9), ("max", 1.0))}
    return launched, picks


def drop_wall(obj):
    """A campaign report without its wall-clock keys."""
    if isinstance(obj, dict):
        return {k: drop_wall(v) for k, v in obj.items()
                if k not in WALL_KEYS}
    if isinstance(obj, list):
        return [drop_wall(v) for v in obj]
    return obj


def counted_run(fn):
    """``fn()`` with the segment-max launches and the engines' solves
    counted from 0 around it, and the host seconds spent inside the solves
    (on whatever thread they run) summed.  Returns ``(fn's result, {"wall",
    "launches", "solves", "solve_s"})``."""
    import torch
    from repro_torch.core import batched as cb
    from repro_torch.core import simulator as cs
    from repro_torch.kernels import phase_max as pm

    spent = [0.0]
    engines = {mod: mod.phase_worst_loads for mod in (cs, cb)}

    def timed(solve):
        def call(vals, ptr, device=None):
            t0 = time.perf_counter()
            res = solve(vals, ptr, device=device)
            spent[0] += time.perf_counter() - t0
            return res
        return call

    for mod, solve in engines.items():
        mod.phase_worst_loads = timed(solve)
    pm.launches = cs.solves = cb.solves = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = {"wall": time.perf_counter() - t0, "launches": pm.launches,
              "solves": cs.solves + cb.solves, "solve_s": spent[0]}
    for mod, solve in engines.items():
        mod.phase_worst_loads = solve
    return out, counts


def us_a_solve(counts) -> float:
    return counts["solve_s"] / counts["solves"] * 1e6 if counts["solves"] \
        else float("nan")


def sweep_campaign(argv, out: Path, env=None) -> dict:
    """One ``sweep campaign`` run in this process, through the port's CLI.
    Returns the report without its wall-clock keys, the wall seconds, the
    segment-max launches and the engines' solves counted from 0 around the
    call, the host seconds spent inside the solves, and the printed lines.
    ``env`` arms the chaos harness for this run only."""
    import contextlib
    import io
    import os

    from repro_torch.launch.sweep import campaign_main

    os.environ.update(env or {})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, counts = counted_run(
            lambda: campaign_main([*argv, "--out", str(out)]))
    for key in env or {}:
        os.environ.pop(key)
    return {"report": drop_wall(json.loads(out.read_text())), **counts,
            "printed": buf.getvalue().splitlines()}


def campaign_phase() -> dict:
    """Phase 5c: the paper's simulation campaigns through ``sweep
    campaign`` on the card (see the module docstring).  Returns the
    launches of the gated serial cuda runs and the numbers logged."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_campaign_"))
    runs = {}

    def run(label, argv, env=None):
        t0 = time.perf_counter()
        runs[label] = res = sweep_campaign(argv, tmp / f"{label}.json", env)
        log(f"campaign {label}: {res['wall']:.3f} s wall "
            f"({time.perf_counter() - t0:.3f} s with the report), "
            f"{res['solves']} solves, {res['launches']} "
            f"launches in this process, {res['solve_s'] * 1e3:.1f} ms in "
            f"the solves"
            + (f" ({res['solve_s'] / res['solves'] * 1e6:.1f} us a solve)"
               if res["solves"] else ""))
        return res

    def same(label, a, b, ignore=()):
        x = {k: v for k, v in runs[a]["report"].items() if k not in ignore}
        y = {k: v for k, v in runs[b]["report"].items() if k not in ignore}
        log(f"campaign {label}: report of {a} identical to {b}: {x == y}")
        if x != y:
            fail(f"campaign {label}: the report of {a} differs from {b}")

    # (1) the golden grid, serial on cuda, against cpu
    golden = run("golden-cuda", CAMPAIGN_GOLDEN + ["--device", "cuda"])
    jct = {row["strategy"]: round(row["jct_mean"], 1)
           for row in golden["report"]["table"]}
    log(f"campaign golden: avg JCT {jct} (pinned {GOLDEN})")
    if jct != GOLDEN:
        fail(f"campaign golden: avg JCT {jct} != {GOLDEN}")
    want = sum(GOLDEN_SOLVES.values())
    if not golden["launches"] == golden["solves"] == want:
        fail(f"campaign golden: {golden['launches']} launches, "
             f"{golden['solves']} solves, expected {want}")
    run("golden-cpu", CAMPAIGN_GOLDEN + ["--device", "cpu"])
    same("golden", "golden-cuda", "golden-cpu")

    # (2) the fabric-heavy grid four ways
    grid_runs = {"grid-v2-cuda": ["--device", "cuda"],
                 "grid-batched-cuda": ["--engine", "batched", "--device",
                                       "cuda"],
                 "grid-workers-cuda": ["--workers", str(CAMPAIGN_WORKERS),
                                       "--device", "cuda"],
                 "grid-v2-cpu": ["--device", "cpu"]}
    for label, extra in grid_runs.items():
        run(label, CAMPAIGN_GRID + extra)
    cells = sum(row["seeds"] for row in runs["grid-v2-cpu"]["report"]["table"])
    if cells != CAMPAIGN_GRID_CELLS:
        fail(f"campaign grid: {cells} cells, expected {CAMPAIGN_GRID_CELLS}")
    for label in ("grid-batched-cuda", "grid-workers-cuda", "grid-v2-cpu"):
        same("grid", "grid-v2-cuda", label)
    for label in ("grid-v2-cuda", "grid-batched-cuda"):
        res = runs[label]
        if not res["launches"] == res["solves"] > 0:
            fail(f"campaign {label}: {res['launches']} launches, "
                 f"{res['solves']} solves")
    if runs["grid-workers-cuda"]["launches"]:
        fail("campaign grid-workers-cuda: the parent process launched the "
             "kernel; the cells belong to the workers")
    wall_prof, rows = device_profile(
        "campaign grid v2 cuda, serial",
        lambda: sweep_campaign(CAMPAIGN_GRID + ["--device", "cuda"],
                               tmp / "profiled.json"))
    busy_ms = sum(ms for ms, _, _ in rows)
    idle = 1 - busy_ms / wall_prof if busy_ms else float("nan")

    # (3) fault tolerance on spawned card workers, on the golden grid
    chaos = CAMPAIGN_GOLDEN + ["--workers", str(CHAOS_WORKERS), "--device",
                               "cuda"]
    run("chaos-crash-once", chaos, {"REPRO_CHAOS": "crash@1:1"})
    same("chaos crash@1:1", "chaos-crash-once", "golden-cuda")
    journal = tmp / "chaos.jsonl"
    quarantined = run("chaos-quarantine",
                      chaos + ["--quarantine", "--journal", str(journal)],
                      {"REPRO_CHAOS": "crash@1"})
    failed = quarantined["report"]["failed_cells"]
    log(f"campaign chaos crash@1: quarantined {failed}")
    if len(failed) != 1 or failed[0]["kind"] != "crash":
        fail(f"campaign chaos crash@1: expected one crashed cell in "
             f"quarantine, got {failed}")
    resumed = run("chaos-resumed", chaos + ["--resume", str(journal)])
    if resumed["report"]["resumed_cells"] != 2:
        fail(f"campaign resume: {resumed['report']['resumed_cells']} cells "
             f"from the journal, expected 2")
    same("resume", "chaos-resumed", "golden-cuda", ignore=("resumed_cells",))

    # (4) trace replay: the alibaba fixture, eager and windowed
    trace = ["--trace", str(ALIBABA_TRACE), "--strategies", "best,sr,ecmp"]
    for label, extra in (("trace-cuda", ["--trace-format", "alibaba",
                                         "--device", "cuda"]),
                         ("trace-cpu", ["--trace-format", "alibaba",
                                        "--device", "cpu"]),
                         ("trace-auto-cuda", ["--device", "cuda"]),
                         ("window-cuda", ["--trace-format", "alibaba",
                                          "--window", "10", "--stride", "5",
                                          "--device", "cuda"]),
                         ("window-cpu", ["--trace-format", "alibaba",
                                         "--window", "10", "--stride", "5",
                                         "--device", "cpu"])):
        run(label, trace + extra)
    jobs = [stats["n"] for stats in runs["trace-cuda"]["report"]["trace"]
            .values()]
    log(f"campaign trace: {jobs} jobs from the alibaba fixture")
    if jobs != [ALIBABA_JOBS]:
        fail(f"campaign trace: {jobs} jobs, expected [{ALIBABA_JOBS}]")
    same("trace", "trace-cuda", "trace-cpu")
    same("trace auto", "trace-auto-cuda", "trace-cuda")
    same("windowed", "window-cuda", "window-cpu")
    for label in ("trace-cuda", "trace-auto-cuda", "window-cuda"):
        if runs[label]["launches"] != runs[label]["solves"]:
            fail(f"campaign {label}: {runs[label]['launches']} launches, "
                 f"{runs[label]['solves']} solves")

    gated = ("golden-cuda", "grid-v2-cuda", "grid-batched-cuda",
             "trace-cuda", "trace-auto-cuda", "window-cuda")
    launches = sum(runs[label]["launches"] for label in gated)
    v2, cpu = runs["grid-v2-cuda"], runs["grid-v2-cpu"]
    log(f"campaign grid: walls v2 cuda {v2['wall']:.3f} s, batched cuda "
        f"{runs['grid-batched-cuda']['wall']:.3f}, {CAMPAIGN_WORKERS} "
        f"workers cuda {runs['grid-workers-cuda']['wall']:.3f}, v2 cpu "
        f"{cpu['wall']:.3f}; {v2['solves']} solves, "
        f"{v2['solve_s'] / v2['solves'] * 1e6:.1f} us a solve on cuda "
        f"against {cpu['solve_s'] / cpu['solves'] * 1e6:.1f} on cpu; device "
        f"idle {idle:.4f} (profiled wall {wall_prof:.1f} ms)")
    by_run = ", ".join(f"{k} {runs[k]['launches']}" for k in gated)
    log(f"campaign launches in the gated serial cuda runs: {launches} "
        f"({by_run})")
    return {"launches": launches,
            "golden_launches": golden["launches"],
            "grid_launches": v2["launches"],
            "grid_walls_s": {k: runs[k]["wall"] for k in grid_runs},
            "grid_us_per_solve": {
                k: runs[k]["solve_s"] / runs[k]["solves"] * 1e6
                for k in ("grid-v2-cuda", "grid-batched-cuda",
                          "grid-v2-cpu")},
            "grid_device_idle": idle,
            "walls_s": {k: v["wall"] for k, v in runs.items()}}


def need(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def figures_phase() -> dict:
    """Phase 5d: the paper's figures through the port's report on the card
    (see the module docstring).  Returns the launches of the gated cuda
    runs and the numbers logged."""
    import hashlib
    import tempfile

    from repro_torch.core.figures import (build_figure, figure_names,
                                          qualitative_checks)
    from repro_torch.launch import report

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_figures_"))
    # (1) the six smoke figures through report.generate, on cuda and cpu;
    # the tables generate builds are kept for check_results and for cuda
    # against cpu
    build, built, smoke, notes = report._build, {}, {}, []

    def keep(*args, **kwargs):
        built["tables"] = build(*args, **kwargs)
        return built["tables"]

    report._build = keep
    for dev in ("cuda", "cpu"):
        out_dir = tmp / f"smoke-{dev}"
        _, counts = counted_run(lambda: report.generate(
            "smoke", out_dir=out_dir, progress=notes.append, device=dev))
        smoke[dev] = {"tables": built.pop("tables"), **counts}
        for name in figure_names():
            got = (out_dir / "assets" / f"{name}.smoke.csv").read_bytes()
            want = (ROOT / "docs" / "assets" / f"{name}.smoke.csv") \
                .read_bytes()
            need(got == want, f"figures smoke {dev}: {name}.smoke.csv "
                 f"differs from docs/assets")
        problems = report.check_results(smoke[dev]["tables"])
        need(not problems, f"figures smoke {dev}: check_results: {problems}")
        log(f"figures smoke on {dev}: {counts['wall']:.3f} s, "
            f"{counts['solves']} solves (reference {FIGURE_SMOKE_SOLVES}), "
            f"{counts['launches']} launches, {us_a_solve(counts):.1f} us a "
            f"solve; six CSVs byte-equal to docs/assets, check_results "
            f"empty")
    report._build = build
    log("figures smoke: the report said " + "; ".join(
        sorted({n for n in notes if n.startswith("[report]")})))
    need(smoke["cuda"]["tables"] == smoke["cpu"]["tables"],
         "figures smoke: the cuda tables differ from the cpu tables")
    c = smoke["cuda"]
    need(c["launches"] == c["solves"] > 0,
         f"figures smoke cuda: {c['launches']} launches, {c['solves']} "
         f"solves")

    # (2) paper scale on cuda, contention-cdf under torch.profiler
    paper, tables = {}, []
    for name, (sha, ref_solves) in PAPER_FIGURES.items():
        def run(name=name):
            return counted_run(lambda: build_figure(name, scale="paper"))
        if name == "contention-cdf":
            held = []
            wall_prof, rows = device_profile(
                "figure contention-cdf, paper scale, cuda",
                lambda: held.append(run()))
            (table, counts), = held
            busy_ms = sum(ms for ms, _, _ in rows)
            idle = 1 - busy_ms / wall_prof if busy_ms else float("nan")
        else:
            table, counts = run()
        digest = hashlib.sha256(report.csv_text(table).encode()).hexdigest()
        paper[name] = counts
        tables.append(table)
        log(f"figure {name} paper on cuda: {counts['wall']:.3f} s"
            + (" (under torch.profiler)" if name == "contention-cdf" else "")
            + f", {counts['solves']} solves (reference {ref_solves}), "
            f"{counts['launches']} launches, {us_a_solve(counts):.1f} us a "
            f"solve, {counts['solve_s']:.3f} s in the solves; csv sha256 "
            f"equal to the reference's: {digest == sha}")
        need(digest == sha, f"figure {name} paper: csv sha256 {digest} != "
             f"the reference's {sha}")
        need(counts["launches"] == counts["solves"] > 0,
             f"figure {name} paper: {counts['launches']} launches, "
             f"{counts['solves']} solves")
    problems = qualitative_checks(tables)
    need(not problems, f"figures paper: qualitative_checks: {problems}")
    log(f"figures paper: qualitative_checks empty; contention-cdf device "
        f"idle {idle:.4f} (profiled wall {wall_prof:.1f} ms)")
    launches = c["launches"] + sum(v["launches"] for v in paper.values())
    return {"launches": launches, "smoke_launches": c["launches"],
            "smoke_walls_s": {d: v["wall"] for d, v in smoke.items()},
            "smoke_us_per_solve": {d: us_a_solve(v)
                                   for d, v in smoke.items()},
            "paper_walls_s": {k: v["wall"] for k, v in paper.items()},
            "paper_solves": {k: v["solves"] for k, v in paper.items()},
            "paper_us_per_solve": {k: us_a_solve(v)
                                   for k, v in paper.items()},
            "contention_cdf_device_idle": idle}


def p50_p99_ms(seconds) -> list:
    import numpy as np
    return [float(x) for x in np.percentile(np.asarray(seconds) * 1e3,
                                            [50, 99])]


def percentiles_ms(seconds) -> str:
    p50, p99 = p50_p99_ms(seconds)
    return f"p50 {p50:.3f} ms, p99 {p99:.3f} ms ({len(seconds)} calls)"


def service_phase() -> dict:
    """Phase 5e: the scheduler service on the card (see the module
    docstring).  Returns the launches of the gated cuda runs and the
    numbers logged."""
    import contextlib
    import io
    import tempfile

    import repro_torch.service as service
    from repro_torch.core import (CLUSTER512, CLUSTER2048, SimConfig,
                                  WorkloadSpec, generate_trace,
                                  save_trace_csv)
    from repro_torch.launch import schedd
    from repro_torch.service import (LiveCluster, SchedClient,
                                     SchedulerService, ServerThread)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_schedd_"))
    launches = {}

    def cfg(strategy):
        return SimConfig(strategy=strategy, scheduler="fifo", seed=0,
                         engine="v2")

    # (1) the differential replay through `schedd replay --verify`; the
    # live cluster each replay drives is kept to compare the reopened log
    golden_csv, big_csv = tmp / "golden.csv", tmp / "cluster2048.csv"
    save_trace_csv(generate_trace(WorkloadSpec(
        num_jobs=200, mean_interarrival=120.0, seed=0, max_gpus=256)),
        str(golden_csv))
    big_jobs = generate_trace(WorkloadSpec(**SCHEDD_BIG))
    save_trace_csv(big_jobs, str(big_csv))
    replay, replayed = service.replay_trace, []

    def keep(live, jobs, **kwargs):
        replayed.append(live)
        return replay(live, jobs, **kwargs)

    def cli(label, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, counts = counted_run(lambda: schedd.main(argv))
        text = buf.getvalue()
        log(f"schedd {label}: {counts['wall']:.3f} s, {counts['solves']} "
            f"solves, {counts['launches']} launches, {us_a_solve(counts):.1f}"
            f" us a solve; " + " | ".join(text.strip().splitlines()))
        need("verify: OK" in text, f"schedd {label}: no verify: OK")
        need(counts["launches"] == counts["solves"] > 0,
             f"schedd {label}: {counts['launches']} launches, "
             f"{counts['solves']} solves")
        launches[label] = counts["launches"]
        return text, counts

    service.replay_trace = keep
    for strategy, (jct, ref_solves) in SCHEDD_GOLDEN.items():
        text, counts = cli(f"replay golden {strategy}", [
            "replay", "--trace", str(golden_csv), "--strategy", strategy,
            "--verify", "--device", "cuda"])
        need(f"JCT {jct:.1f}s" in text, f"schedd golden {strategy}: JCT "
             f"{jct} not in {text!r}")
        need(counts["solves"] == ref_solves, f"schedd golden {strategy}: "
             f"{counts['solves']} solves, the reference makes {ref_solves}")
    for strategy in ("ecmp", "sr"):
        log_path = tmp / f"cluster2048-{strategy}.log"
        cli(f"replay CLUSTER2048 {strategy}", [
            "replay", "--trace", str(big_csv), "--cluster", "2048",
            "--strategy", strategy, "--verify", "--event-log",
            str(log_path), "--device", "cuda"])
        live = replayed[-1]
        cpu = LiveCluster.open(str(log_path), CLUSTER2048, cfg(strategy),
                               device="cpu")
        same = (cpu.version, cpu.now, cpu.sim.placements) == \
            (live.version, live.now, live.sim.placements)
        log(f"schedd CLUSTER2048 {strategy}: the event log reopened on cpu "
            f"replays {cpu.ingested} records to version {cpu.version}, t="
            f"{cpu.now:g}, {len(cpu.sim.placements)} placements; same as "
            f"the cuda run: {same}")
        need(same, f"schedd CLUSTER2048 {strategy}: the log reopened on "
             f"cpu differs from the cuda run")
        cpu.close()
    service.replay_trace = replay

    # (2) one daemon session through every op, on a durable log
    session_log = tmp / "session.log"

    def session():
        live = LiveCluster.open(str(session_log), CLUSTER512, cfg("sr"),
                                quotas={"teamA": 64}, fsync=False)
        server = ServerThread(SchedulerService(live))
        host, port = server.start()
        with SchedClient(host, port) as c:
            s = c.stats()
            need(s["running"] == 0 and s["version"] == 0, f"stats {s}")
            need(c.admit("default", 128)["admit"], "admit grant")
            denied = c.admit("teamA", 128)
            need(not denied["admit"] and "quota" in denied["reason"],
                 f"admit deny {denied}")
            r = c.submit("resnet50", 16, 4000, tenant="teamA")
            need(r["admitted"] and r["placed"], f"submit {r}")
            d = c.submit("bert", 64, 1000, tenant="teamA")
            need(not d["admitted"] and "quota" in d["reason"], f"quota {d}")
            q = c.submit("vgg16", 96, 3000, t=30.0)
            need(q["admitted"], f"submit {q}")
            w = c.whatif("moe", 32, 2000, strategies=["sr", "ecmp"])
            need(not w["cached"] and all(
                w["strategies"][n]["supported"] for n in ("sr", "ecmp")),
                f"what-if {w}")
            need(c.whatif("moe", 32, 2000, strategies=["sr", "ecmp"])
                 ["cached"], "the second what-if is no memo hit")
            ev = c.event({"time": 100.0, "kind": "preempt",
                          "job_id": r["job_id"], "restart_iters": 50.0})
            need(ev["kind"] == "preempt", f"event {ev}")
            need(c.advance(200.0)["t"] == 200.0, "advance")
            need(c.drain()["completed"], "drain finished nothing")
            # an unknown op answers ok: false and keeps the session (read
            # off the wire: the client raises ServiceError on it)
            c._fh.write(b'{"id": 99, "op": "frobnicate"}\n')
            c._fh.flush()
            err = json.loads(c._fh.readline())
            need(not err["ok"] and "unknown op" in err["error"],
                 f"unknown op {err}")
            final = c.stats()
            c.shutdown()
        server.join()
        return final

    final, counts = counted_run(session)
    launches["session"] = counts["launches"]
    reopened = LiveCluster.open(str(session_log), CLUSTER512, cfg("sr"),
                                quotas={"teamA": 64}, device="cpu")
    log(f"schedd session (CLUSTER512, sr, quota teamA=64): "
        f"{counts['wall']:.3f} s, {final['requests']} requests, "
        f"{final['errors']} errors, version {final['version']}, t="
        f"{final['now']:g}; {counts['solves']} solves, {counts['launches']} "
        f"launches; the log reopened on cpu: version {reopened.version}, t="
        f"{reopened.now:g}")
    need((reopened.version, reopened.now) == (final["version"],
                                              final["now"]),
         "schedd session: the reopened log reaches another state")
    need(counts["launches"] == counts["solves"] > 0,
         f"schedd session: {counts['launches']} launches, "
         f"{counts['solves']} solves")
    reopened.close()

    # (3) request latency on the paper's large cluster, cuda then cpu
    first = sorted(big_jobs, key=lambda j: j.arrival)[:SCHEDD_LATENCY_JOBS]

    def latency(dev):
        live = LiveCluster(CLUSTER2048, cfg("sr"), device=dev)
        server = ServerThread(SchedulerService(live))
        host, port = server.start()
        sub, wif = [], []
        with SchedClient(host, port) as c:
            for i, job in enumerate(first):
                t0 = time.perf_counter()
                c.submit(job.model, job.num_gpus, job.num_iters,
                         batch_size=job.batch_size, t=job.arrival,
                         allreduce_algo=job.allreduce_algo,
                         deadline=job.deadline)
                sub.append(time.perf_counter() - t0)
                if i % SCHEDD_WHATIF_EVERY == SCHEDD_WHATIF_EVERY - 1:
                    t0 = time.perf_counter()
                    w = c.whatif("moe", 32, 2000, strategies=["sr", "ecmp"])
                    wif.append(time.perf_counter() - t0)
                    need(not w["cached"], "a what-if at a fresh version hit "
                         "the memo")
            stats = c.stats()
            c.shutdown()
        server.join()
        return stats, live.sim.placements, sub, wif

    lat = {}
    for dev in ("cuda", "cpu"):
        (stats, placements, sub, wif), counts = counted_run(
            lambda: latency(dev))
        lat[dev] = {"version": stats["version"], "placements": placements,
                    "submit_s": sub, "whatif_s": wif, **counts}
        log(f"schedd latency on {dev} (CLUSTER2048, sr, "
            f"{len(sub)} submits, {len(wif)} what-ifs of moe x 32 under sr "
            f"and ecmp): submit {percentiles_ms(sub)}; what-if "
            f"{percentiles_ms(wif)}; {counts['wall']:.3f} s, "
            f"{counts['solves']} solves, {counts['launches']} launches, "
            f"{us_a_solve(counts):.1f} us a solve")
    need(lat["cuda"]["launches"] == lat["cuda"]["solves"] > 0,
         "schedd latency cuda: launches != solves")
    need((lat["cuda"]["version"], lat["cuda"]["placements"])
         == (lat["cpu"]["version"], lat["cpu"]["placements"]),
         "schedd latency: the cuda and cpu services end in other states")
    launches["latency"] = lat["cuda"]["launches"]
    log(f"schedd launches in the gated cuda runs: {launches}")
    return {"launches": sum(launches.values()), "by_run": launches,
            "latency_p50_p99_ms": {
                dev: {"submit": p50_p99_ms(v["submit_s"]),
                      "whatif": p50_p99_ms(v["whatif_s"])}
                for dev, v in lat.items()}}


def kernel_device_ms(fn, name: str, n: int = 50) -> float:
    """Mean device time of the kernel ``name`` over ``n`` calls of ``fn``,
    from torch.profiler (launch overhead excluded).  A trace that holds no
    kernel of that name (seen once for the route's launches from the
    plain-C library) is taken again, up to three times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in rows)
        if count:
            return sum(e.self_device_time_total for e in rows) / count / 1e3
        log(f"profile of {name}: trace {attempt + 1} holds no such kernel")
    fail(f"torch.profiler recorded no {name} kernel in three traces")


class StagedRoute:
    """Transfer design (A), kept as a yardstick the port does not offer:
    ``[ptr | vals]`` packed into a page-locked buffer, one asynchronous
    copy into a device scratch tensor, the launch there, an asynchronous
    copy of the result into a page-locked output, one event wait.  Sized
    once for the largest call it is given."""

    def __init__(self, dev, nmax: int, segmax: int):
        import torch
        i64 = torch.int64
        self.dev = dev
        self.host = torch.empty(nmax, dtype=i64, pin_memory=True)
        self.out = torch.empty(segmax, dtype=i64, pin_memory=True)
        self.scratch = torch.empty(nmax, dtype=i64, device=dev)
        self.dout = torch.empty(segmax, dtype=i64, device=dev)
        self.host_np, self.out_np = self.host.numpy(), self.out.numpy()
        self.event = torch.cuda.Event()

    def __call__(self, vals, ptr):
        import numpy as np
        import torch
        from repro_torch.kernels import phase_max as pm
        pm.check_csr(ptr, len(vals))
        nptr, n, nseg = len(ptr), len(ptr) + len(vals), len(ptr) - 1
        np.concatenate((ptr, vals), out=self.host_np[:n])
        self.scratch[:n].copy_(self.host[:n], non_blocking=True)
        stream = torch.cuda.current_stream(self.dev)
        base = self.scratch.data_ptr()
        err = pm._c("phase_max_launch")(
            base + 8 * nptr, base, self.dout.data_ptr(), nseg, len(vals),
            stream.cuda_stream, self.dev.index)
        if err:
            fail(f"phase_max staged design: launch failed ({err})")
        self.out[:nseg].copy_(self.dout[:nseg], non_blocking=True)
        self.event.record(stream)
        self.event.synchronize()
        return self.out_np[:nseg].copy()


def pr16_route(dev):
    """PR 16's ``phase_worst_loads`` on ``cuda``, a yardstick only: the
    same host checks, two pageable uploads, the launch, a synchronising
    pageable download."""
    import numpy as np
    import torch
    from repro_torch.kernels import phase_max as pm

    def route(vals, ptr, device=None):
        vals, ptr = np.asarray(vals), np.asarray(ptr)
        for a in (vals, ptr):
            if a.ndim != 1 or not np.issubdtype(a.dtype, np.integer):
                raise TypeError("pr16_route: 1-D integer arrays only")
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        ptr = np.ascontiguousarray(ptr, dtype=np.int64)
        pm.check_csr(ptr, len(vals))
        return pm.phase_max(torch.from_numpy(vals).to(dev),
                            torch.from_numpy(ptr).to(dev)).cpu().numpy()
    return route


def device_ops(fn, n: int = 50):
    """Device time of each operation (kernels and copies) that ``fn``
    issues, from torch.profiler over ``n`` calls: {name: (occurrences per
    call, us per occurrence)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / n, e.self_device_time_total / e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def time_phase_max(picks, smi: str):
    """At the grid's p50 / p90 / max calls: the kernel's device time on the
    engines' route and on device-resident inputs, the wrapper's issue rate,
    the engines' round trip numpy -> numpy against PR 16's route and
    against transfer design (A), in turns, each design's device operations,
    the route's host parts (p50), the plain version, a library call and
    host numpy.  Returns the p50 row."""
    import numpy as np
    import torch
    from repro_torch.core.fairshare import phase_worst_loads, phase_worst_numpy
    from repro_torch.kernels import phase_max as pm

    def host_ms(fn, iters=400):
        for _ in range(20):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3

    def ops_text(ops):
        return ", ".join(f"{key[:40]} {us:.2f} us" + (
            f" x{count:g}" if count != 1 else "")
            for key, (count, us) in sorted(ops.items()))

    dev = torch.device("cuda", torch.cuda.current_device())
    one_v = torch.ones(1, dtype=torch.int64, device=dev)
    one_p = torch.tensor([0, 1], dtype=torch.int64, device=dev)
    floor_ms = time_ms(lambda: pm.phase_max(one_v, one_p), iters=200)
    floor_dev = kernel_device_ms(lambda: pm.phase_max(one_v, one_p),
                                 "segment_max")
    v1, p1 = np.ones(1, np.int64), np.asarray([0, 1], np.int64)
    floor_route = host_ms(lambda: phase_worst_loads(v1, p1))
    floor_route_dev = kernel_device_ms(lambda: phase_worst_loads(v1, p1),
                                       "segment_max")
    log(f"phase_max floor (1 value, 1 segment): on device tensors issue "
        f"{floor_ms:.4f} ms back to back (CUDA events), kernel "
        f"{floor_dev:.4f} ms on the device; engines' "
        f"route {floor_route:.4f} ms numpy -> numpy, kernel "
        f"{floor_route_dev:.4f} ms on the device (profiler)")
    staged = StagedRoute(dev, max(len(v) + len(p) for v, p in picks.values()),
                         max(len(p) for _, p in picks.values()))
    routes = {"pr16": pr16_route(dev), "staged": staged,
              "zero-copy": lambda v, p: phase_worst_loads(v, p)}
    rows = {}
    for label, (vals, ptr) in picks.items():
        nvals, nseg = len(vals), len(ptr) - 1
        want = phase_worst_numpy(vals, ptr)
        for name, fn in routes.items():
            if not np.array_equal(fn(vals, ptr), want):
                fail(f"phase_max {label}: the {name} route disagrees with "
                     f"numpy")
        tv, tp = torch.from_numpy(vals).to(dev), torch.from_numpy(ptr).to(dev)
        seg = torch.repeat_interleave(torch.arange(nseg, device=dev),
                                      tp[1:] - tp[:-1])
        zeros = torch.zeros(nseg, dtype=torch.int64, device=dev)
        lib = zeros.scatter_reduce(0, seg, tv, "amax", include_self=False)
        if not torch.equal(lib, pm.phase_max(tv, tp)):
            fail(f"phase_max {label}: the library call computes another "
                 f"function")
        # the routes numpy -> numpy, in turns on this card
        turns = {name: [] for name in routes}
        for name in ("pr16", "staged", "zero-copy", "zero-copy", "staged",
                     "pr16"):
            turns[name].append(host_ms(lambda: routes[name](vals, ptr)))
        rt = {name: sum(t) / len(t) for name, t in turns.items()}
        ops = {name: device_ops(lambda: routes[name](vals, ptr))
               for name in ("staged", "zero-copy")}
        nbytes = 8 * nvals + 16 * nseg
        row = {
            "kernel_ms": kernel_device_ms(lambda: phase_worst_loads(vals, ptr),
                                          "segment_max"),
            "resident_kernel_ms": kernel_device_ms(
                lambda: pm.phase_max(tv, tp), "segment_max"),
            "issue_ms": time_ms(lambda: pm.phase_max(tv, tp), iters=200),
            "roundtrip_ms": rt["zero-copy"], "staged_ms": rt["staged"],
            "pr16_roundtrip_ms": rt["pr16"],
            "plain_ms": time_ms(lambda: pm.phase_max_plain(tv, tp), iters=50),
            "library_ms": time_ms(lambda: zeros.scatter_reduce(
                0, seg, tv, "amax", include_self=False), iters=200),
            "numpy_ms": host_ms(lambda: phase_worst_numpy(vals, ptr)),
            "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "link_bound_ms": nbytes / PEAK_LINK_BYTES * 1e3,
        }
        rows[label] = row
        log(f"phase_max {label} call (nvals {nvals}, nseg {nseg}): round "
            f"trip numpy -> numpy, in turns (pr16, staged, zero-copy, "
            f"zero-copy, staged, pr16): " + "; ".join(
                f"{name} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                for name, ts in turns.items()))
        log(f"phase_max {label} call: device operations per call: staged "
            f"(A): {ops_text(ops['staged'])}; zero-copy (B, the engines' "
            f"route): {ops_text(ops['zero-copy'])}")
        log(f"phase_max {label} call: engines' route (zero-copy) "
            f"{row['roundtrip_ms']:.4f} ms, design (A) staged "
            f"{row['staged_ms']:.4f} ms, PR 16's route "
            f"{row['pr16_roundtrip_ms']:.4f} ms; kernel on the device "
            f"{row['kernel_ms']:.4f} ms on the route (reading page-locked "
            f"host memory), {row['resident_kernel_ms']:.4f} ms on device "
            f"tensors (profiler); issue on device tensors "
            f"{row['issue_ms']:.4f} ms (CUDA events, back to back); plain "
            f"{row['plain_ms']:.4f} ms, library scatter_reduce "
            f"{row['library_ms']:.4f} ms, host numpy reduceat "
            f"{row['numpy_ms'] * 1e3:.1f} us; bound "
            f"{row['bound_ms'] * 1e3:.4f} us (bytes at 3.35 TB/s), "
            f"{row['link_bound_ms'] * 1e3:.4f} us over the host link "
            f"(64 GB/s); {smi}")
        if label == "p50":   # where the route's host time goes
            st = pm._staging[dev.index]
            solve = pm._c("phase_max_solve")

            def launch_wait():
                stream = torch.cuda.current_stream(dev.index).cuda_stream
                solve(st.packed_at + 8 * len(ptr), st.packed_at, st.out_at,
                      nseg, nvals, stream, dev.index, st.event.cuda_event)
            parts = {
                "phase_worst_loads": lambda: phase_worst_loads(vals, ptr),
                "phase_max_host": lambda: pm.phase_max_host(vals, ptr, dev),
                "pack": lambda: st.pack(vals, ptr),
                "current_stream": lambda: torch.cuda.current_stream(
                    dev.index).cuda_stream,
                "launch_and_wait": launch_wait,
                "result": lambda: st.result(nseg),
            }
            log("phase_max p50 call, the route's parts (host clock): " +
                "; ".join(f"{k} {host_ms(f) * 1e3:.2f} us"
                          for k, f in parts.items()))
    slower = [label for label, row in rows.items()
              if row["roundtrip_ms"] >= row["pr16_roundtrip_ms"]]
    log("phase_max: launch latency and the host link, not the bound, set "
        f"a call's device time here (bound at the max call "
        f"{rows['max']['bound_ms'] * 1e3:.4f} us, kernel floor "
        f"{floor_dev * 1e3:.1f} us on the device); the engines' route is "
        f"below PR 16's at every pick: {not slower}")
    return rows["p50"]


def main() -> None:
    import torch

    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; the port's smoke run needs the card")
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import phase_max as pm
    from repro_torch.kernels import rwkv6 as kr

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: float32 plain versions are float32")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, text in report.items():
        log_ptxas(name, text)
    for dtype in (torch.bfloat16, torch.float32):
        sizes = {hd: fa.smem_bytes(dtype, hd) for hd in fa.HEAD_DIMS}
        log(f"flash_attention {dtype} dynamic shared memory per CTA "
            f"(bytes, by head_dim): {sizes}")
    # head_dim 96 (phi-3-vision) and 192 (nemotron-4-340b) on the mma
    # kernel, as the wrapper's check_layout names it
    for dtype, want in ((torch.bfloat16, "mma_sync"),
                        (torch.float32, "mma_fma")):
        for hd in (96, 192):
            if fa.built_variant(dtype, hd) != want:
                fail(f"the built library launches "
                     f"{fa.built_variant(dtype, hd)} for {dtype} head_dim "
                     f"{hd}, not {want}")

    # 3. kernels against their plain versions -------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, hq, hkv, hd, dtype, fused=False, skv=None):
        """q (b, s, hq, hd), k / v (b, skv or s, hkv, hd)."""
        if fused:   # views of one (B, S, (Hq + 2 Hkv) * hd) projection
            x = torch.randn((b, s, (hq + 2 * hkv) * hd), generator=gen,
                            device=dev).to(dtype).view(b, s, hq + 2 * hkv, hd)
            return x[:, :, :hq], x[:, :, hq:hq + hkv], x[:, :, hq + hkv:]
        return [torch.randn((b, n, h, hd), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for n, h in ((s, hq), (skv or s, hkv), (skv or s, hkv))]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, (B, Sq, Hq, Hkv, hd[, Skv]), dtype, causal, window[,
        # fused]
        ("path-bf16", (BATCH, PROMPT, 32, 4, 64), bf16, True, None),
        ("path-f32", (BATCH, PROMPT, 32, 4, 64), f32, True, None),
        ("deepseek-bf16", (BATCH, PROMPT, 16, 16, 128), bf16, True, None),
        ("mha", (2, 512, 8, 8, 64), bf16, True, None),
        ("mqa", (2, 512, 8, 1, 64), bf16, True, None),
        ("gqa-8", (2, 512, 16, 2, 64), bf16, True, None),
        ("ragged-1000", (2, 1000, 8, 4, 64), bf16, True, None),
        ("ragged-1000-f32", (2, 1000, 8, 4, 64), f32, True, None),
        ("non-causal", (2, 1000, 8, 4, 64), bf16, False, None),
        ("window-48", (2, 1000, 8, 4, 64), bf16, True, 48),
        ("window-48-f32", (2, 1000, 8, 4, 64), f32, True, 48),
        ("s1", (2, 1, 8, 2, 64), bf16, True, None),
        ("s127", (2, 127, 8, 2, 64), bf16, True, None),
        ("s129", (2, 129, 8, 2, 64), bf16, True, None),
        ("s129-f32", (2, 129, 8, 2, 64), f32, True, None),
        ("s300-window-48", (2, 300, 8, 2, 64), bf16, True, 48),
        ("s300-window-200", (2, 300, 8, 2, 64), bf16, True, 200),
        ("s300-hd128-w200", (2, 300, 8, 2, 128), bf16, True, 200),
        ("s300-nc-w200-f32", (2, 300, 8, 2, 64), f32, False, 200),
        ("fused-hd64", (2, 257, 8, 2, 64), bf16, True, None, True),
        ("fused-hd128-w100", (2, 257, 8, 2, 128), bf16, True, 100, True),
        ("fused-hd32", (2, 257, 8, 2, 32), bf16, True, None, True),
        ("fused-hd64-f32", (2, 257, 8, 2, 64), f32, True, None, True),
        ("hd16", (1, 300, 4, 2, 16), bf16, True, None),
        ("hd32", (1, 300, 4, 2, 32), bf16, True, None),
        ("hd128", (1, 300, 4, 2, 128), bf16, True, None),
        ("hd128-f32", (1, 300, 4, 2, 128), f32, True, None),
        # zamba2-2.7b's shared attention (head_dim 80, MHA 32 / 32) on the
        # mma kernel, its tile edges, GQA and windows
        ("zamba2-bf16", ZAMBA_ATTN, bf16, True, None),
        ("zamba2-f32", ZAMBA_ATTN, f32, True, None),
        ("hd80-s1", (2, 1, 8, 8, 80), bf16, True, None),
        ("hd80-s127", (2, 127, 8, 8, 80), bf16, True, None),
        ("hd80-s129", (2, 129, 8, 8, 80), bf16, True, None),
        ("hd80-s300", (2, 300, 8, 8, 80), bf16, True, None),
        ("hd80-s300-f32", (2, 300, 8, 8, 80), f32, True, None),
        ("hd80-gqa-4", (2, 300, 8, 2, 80), bf16, True, None),
        ("hd80-window-48", (2, 300, 8, 8, 80), bf16, True, 48),
        ("hd80-w48-f32", (2, 300, 8, 2, 80), f32, True, 48),
        ("fused-hd80", (2, 257, 8, 2, 80), bf16, True, None, True),
        # whisper-base: non-causal with Sq != Skv (its encoder over 1500
        # frames, its cross attention from a 224-token prompt to them):
        # ragged tiles on both sides, one q row, one key, fewer keys than a
        # tile, q rows of a whole consumer warpgroup past Sq; both kernels
        ("whisper-enc", WHISPER_ENC, bf16, False, None),
        ("whisper-cross", WHISPER_CROSS, bf16, False, None),
        ("whisper-enc-f32", WHISPER_ENC, f32, False, None),
        ("whisper-cross-f32", WHISPER_CROSS, f32, False, None),
        *((f"nc-{sq}x{skv}-{tag}", (2, sq, 4, 4, hd, skv), dt, False, None)
          for sq, skv in ((224, 1500), (1500, 224), (1, 1500), (129, 63),
                          (300, 1))
          for tag, hd, dt in (("hd64", 64, bf16), ("hd128", 128, bf16),
                              ("hd80", 80, bf16), ("f32", 64, f32))),
        ("nc-gqa-224x1500", (2, 224, 8, 2, 64, 1500), bf16, False, None),
        ("nc-gqa-129x63-hd80", (2, 129, 8, 2, 80, 63), bf16, False, None),
        ("nc-gqa-129x63-f32", (2, 129, 8, 2, 64, 63), f32, False, None),
        # phi-3-vision-4.2b's attention (MHA 32 / 32, head_dim 96) and
        # nemotron-4-340b's heads (96 / 8 of 192), both on the mma kernel:
        # at their shapes, ragged S, a window, GQA, non-causal Sq != Skv
        ("phi3-bf16", PHI3_ATTN, bf16, True, None),
        ("phi3-f32", PHI3_ATTN, f32, True, None),
        ("nemotron-bf16", NEMOTRON_ATTN, bf16, True, None),
        ("nemotron-f32", NEMOTRON_ATTN, f32, True, None),
        *((f"hd{hd}-s{sq}{tag}", (2, sq, 8, 2, hd), dt, True, None)
          for hd in (96, 192) for sq in (1, 127, 129, 300)
          for tag, dt in (("", bf16), ("-f32", f32))),
        *((f"hd{hd}-window-48{tag}", (2, 300, 8, 8, hd), dt, True, 48)
          for hd in (96, 192) for tag, dt in (("", bf16), ("-f32", f32))),
        *((f"nc-{sq}x1500-hd{hd}{tag}", (2, sq, 4, 4, hd, 1500), dt, False,
           None)
          for hd in (96, 192) for sq in (224, 1)
          for tag, dt in (("", bf16), ("-f32", f32))),
        ("fused-hd96", (2, 257, 8, 2, 96), bf16, True, None, True),
        ("fused-hd192-w100", (2, 257, 8, 2, 192), bf16, True, 100, True),
    ]
    path_err = moe_err = zamba_err = phi3_err = nemotron_err = None
    whisper_err = {}
    for name, shape, dtype, causal, window, *fused in cases:
        q, k, v = qkv(*shape[:5], dtype, fused=bool(fused),
                      skv=shape[5] if len(shape) > 5 else None)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if dtype == torch.bfloat16:
            tol = "one bf16 ulp, 8e-3 where |o| < 2"
            within = bool((diff <= bf16_bound(ref.float())).all())
        else:
            tol = f"{F32_TOL:g}"
            within = torch.allclose(out.float(), ref.float(), atol=F32_TOL,
                                    rtol=F32_TOL)
        ok = bool(torch.isfinite(out.float()).all()) and within
        log(f"flash_attention {name:16s} {str(dtype):15s} "
            f"{fa.last_variant:9s} max_abs_err {err:.3e} (tol {tol}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attention {name}: kernel disagrees with its plain "
                 f"version (max_abs_err {err:.3e}, tol {tol})")
        if name == "path-bf16":
            path_err = err
        if name == "deepseek-bf16":
            moe_err = err
            if fa.last_variant != "wgmma_tma":
                fail(f"deepseek's attention shape ran {fa.last_variant}")
        if name == "zamba2-bf16":
            zamba_err = err
            if fa.last_variant != "mma_sync":
                fail(f"zamba2's attention shape ran {fa.last_variant}")
        if name in ("whisper-enc", "whisper-cross"):
            whisper_err[name] = err
            if fa.last_variant != "wgmma_tma":
                fail(f"whisper's {name} shape ran {fa.last_variant}")
        if shape[4] in (96, 192) and fa.last_variant != (
                "mma_sync" if dtype == bf16 else "mma_fma"):
            fail(f"{name} (head_dim {shape[4]}) ran {fa.last_variant}")
        if name == "phi3-bf16":
            phi3_err = err
        if name == "nemotron-bf16":
            nemotron_err = err
        del q, k, v, out, ref, diff
    torch.cuda.empty_cache()
    pm_err = check_phase_max(dev)
    rwkv_err = check_rwkv6(dev)
    mamba_err = check_mamba2_call(dev)

    # 4. the main path: full-width tinyllama-1.1b serving -------------------
    launches = serve_phase(dev, "tinyllama-1.1b", {"flash_attention": 22})
    path_variant = fa.last_variant
    if path_variant != "wgmma_tma":
        fail(f"tinyllama prefill ran the {path_variant} attention variant, "
             f"not wgmma_tma")

    # 4c. training: the Functions' grads, full-width tinyllama, resume -------
    grad_errs = check_function_grads(dev)
    train = train_phase(dev, smi)
    resume_phase(dev)

    # 4b. the recurrence's path: full-width rwkv6-3b serving ----------------
    rwkv_launches = serve_phase(dev, "rwkv6-3b", {"rwkv6_chunked": 32})

    # 4d. the moe family: full-width deepseek-moe-16b, bf16-held weights ----
    moe_launches = serve_phase(dev, "deepseek-moe-16b",
                               {"flash_attention": 28},
                               param_dtype="bfloat16")
    moe_variant = fa.last_variant
    if moe_variant != "wgmma_tma":
        fail(f"deepseek prefill ran the {moe_variant} attention variant, "
             f"not wgmma_tma")

    # 4e. the hybrid family: full-width zamba2-2.7b, both model kernels -----
    hybrid_launches = serve_phase(dev, "zamba2-2.7b", {"flash_attention": 9,
                                                       "rwkv6_chunked": 54})
    hybrid_variant = fa.last_variant
    if hybrid_variant != "mma_sync":
        fail(f"zamba2 prefill ran the {hybrid_variant} attention variant, "
             f"not mma_sync")

    # 4f. the audio family: full-width whisper-base on 1500 frames ----------
    audio_launches = serve_phase(
        dev, "whisper-base", {"flash_attention": 18}, batch=WHISPER_BATCH,
        prompt=WHISPER_PROMPT, frames=WHISPER_FRAMES,
        max_len=WHISPER_MAX_LEN, variant="wgmma_tma")

    # 4g. the vlm family: full-width phi-3-vision-4.2b, head_dim 96 --------
    vlm_launches = serve_phase(dev, "phi-3-vision-4.2b",
                               {"flash_attention": 32}, variant="mma_sync")

    # 4h. distributed: ranks sharing the card -----------------------------
    t0 = time.perf_counter()
    dist = distributed_phase(smi)
    log(f"phase 4h took {time.perf_counter() - t0:.1f} s")

    # 5. the simulator's path: golden trace, then the 72-lane grid ---------
    fa.launches = pm.launches = kr.launches = 0
    golden_launches = simulate_golden()
    grid_launches, picks = simulate_grid()
    pm_launches = golden_launches + grid_launches
    log(f"phase_max launches on the simulate path: {pm_launches} (golden "
        f"trace {golden_launches}, grid {grid_launches})")
    if fa.launches or kr.launches:
        fail(f"the simulator launched flash attention {fa.launches} and the "
             f"recurrence {kr.launches} times")

    # 5c. the campaigns: sweep campaign on the card -------------------------
    t0 = time.perf_counter()
    campaign = campaign_phase()
    log(f"phase 5c took {time.perf_counter() - t0:.1f} s")
    if fa.launches or kr.launches:
        fail(f"the campaigns launched flash attention {fa.launches} and the "
             f"recurrence {kr.launches} times")

    # 5d. the paper's figures: report.generate and the paper-scale builders -
    t0 = time.perf_counter()
    figures = figures_phase()
    log(f"phase 5d took {time.perf_counter() - t0:.1f} s")

    # 5e. the scheduler service: replay oracle, a daemon session, latency ---
    t0 = time.perf_counter()
    schedd = service_phase()
    log(f"phase 5e took {time.perf_counter() - t0:.1f} s")
    if fa.launches or kr.launches:
        fail(f"the figures and the service launched flash attention "
             f"{fa.launches} and the recurrence {kr.launches} times")

    # 6. timing at the paths' shapes ----------------------------------------
    q, k, v = qkv(BATCH, PROMPT, 32, 4, 64, torch.bfloat16)
    kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), iters=5)
    # yardstick only, never called by the port: PyTorch's fused attention on
    # (B, H, S, hd) inputs with the kv heads expanded beforehand
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    bound_ms, bound_by = bound(q, k, v, True, None)
    log(f"flash_attention at the path's shape: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {1.5 * bound_ms:.4f} ms with the "
        f"split PV product's 1.5x tensor-core work); {smi}")
    log(f"flash_attention variant on the tinyllama path: {path_variant} "
        f"({fa.last_variant} at the timed shape)")
    log_ptxas("flash_attention", report["flash_attention"])
    def attention_row(label, shape, causal, err):
        """Kernel, plain and SDPA (kv heads expanded) ms at ``shape`` (B,
        Sq, Hq, Hkv, hd[, Skv]), bf16, with its bound; logged."""
        aq, ak, av = qkv(*shape[:5], torch.bfloat16,
                         skv=shape[5] if len(shape) > 5 else None)
        row = {"ms": time_ms(lambda: fa.flash_attention(aq, ak, av,
                                                        causal=causal)),
               "variant": fa.last_variant,
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                   aq, ak, av, causal), iters=5)}
        rep = aq.shape[2] // ak.shape[2]
        aqh = aq.transpose(1, 2).contiguous()
        akh, avh = (t.repeat_interleave(rep, dim=2).transpose(1, 2)
                    .contiguous() for t in (ak, av))
        row["library_ms"] = time_ms(lambda: sdpa(aqh, akh, avh,
                                                 is_causal=causal))
        row["bound_ms"], row["bound_by"] = bound(aq, ak, av, causal, None)
        row["max_abs_err"] = err
        row["shape"] = (f"B {shape[0]}, Sq {shape[1]}"
                        + (f", Skv {shape[5]}" if len(shape) > 5 else "")
                        + f", {shape[2]} / {shape[3]} heads of {shape[4]}, "
                        f"bf16, {'causal' if causal else 'non-causal'}")
        log(f"flash_attention at {label}'s shape ({row['shape']}, "
            f"{row['variant']}): kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); {smi}")
        return row

    moe_row = attention_row("deepseek-moe-16b", (BATCH, PROMPT, 16, 16, 128),
                            True, moe_err)
    zamba_row = attention_row("zamba2-2.7b", ZAMBA_ATTN, True, zamba_err)
    audio_rows = {
        "encoder": attention_row("whisper-base's encoder", WHISPER_ENC,
                                 False, whisper_err["whisper-enc"]),
        "cross": attention_row("whisper-base's cross", WHISPER_CROSS, False,
                               whisper_err["whisper-cross"])}
    phi3_row = attention_row("phi-3-vision-4.2b", PHI3_ATTN, True, phi3_err)
    nemotron_row = attention_row("nemotron-4-340b's heads", NEMOTRON_ATTN,
                                 True, nemotron_err)
    qf, kf, vf = (t.float() for t in (q, k, v))
    f32_ms = time_ms(lambda: fa.flash_attention(qf, kf, vf), iters=5)
    f32_bound, f32_by = bound(qf, kf, vf, True, None)
    log(f"flash_attention float32 at the path's shape: kernel {f32_ms:.4f} ms,"
        f" bound {f32_bound:.4f} ms ({f32_by}, 67 TFLOP/s without TF32)")

    pm_row = time_phase_max(picks, smi)

    # the recurrence at the rwkv6-3b path's shape: bf16 split_heads views
    q, k, v, ld, u = rwkv6_case_inputs(dev, RWKV_PATH, True, "model", 0,
                                       "bfloat16", True)
    rwkv_ms = time_ms(lambda: kr.rwkv6_fused(q, k, v, ld, bonus=u,
                                             chunk=RWKV_CHUNK))
    rwkv_plan = kr.last_plan
    rwkv_plain_ms = time_ms(lambda: kr.rwkv6_fused_plain(
        q, k, v, ld, bonus=u, chunk=RWKV_CHUNK), iters=3)
    b, h, t, dk, dv = RWKV_PATH
    rwkv_bound_ms, rwkv_by = rwkv6_bound(b * h, t, dk, dv, RWKV_CHUNK, True,
                                         False, 2, h)
    log(f"rwkv6 at the path's shape (B·H {b * h}, T {t}, K {dk}, V {dv}, "
        f"chunk {RWKV_CHUNK}, bonus, bf16 split_heads views): kernel "
        f"{rwkv_ms:.4f} ms (plan {rwkv_plan}), plain {rwkv_plain_ms:.4f} ms, "
        f"bound {rwkv_bound_ms:.4f} ms ({rwkv_by}); no single PyTorch call "
        f"computes it (library none); {smi}")
    del q, k, v, ld, u
    vb_ms = {}
    for batch in RWKV_SWEEP_BATCHES:
        q, k, v, ld, u = rwkv6_case_inputs(dev, (batch, *RWKV_PATH[1:]), True,
                                           "model", 0, "bfloat16", True)
        for vb in RWKV_SWEEP_VBS:
            ms = time_ms(lambda: kr.rwkv6_fused(q, k, v, ld, bonus=u,
                                                chunk=RWKV_CHUNK, vb=vb))
            vb_ms[f"B·H {batch * h} VB {vb}"] = ms
            log(f"rwkv6 VB sweep, bf16 views, B·H {batch * h}: VB {vb} "
                f"{ms:.4f} ms (CUDA events; plan {kr.last_plan})")
        del q, k, v, ld, u
    # the recurrence as zamba2-2.7b's Mamba2 blocks call it
    mq, mk, mv, mld = mamba2_operands(dev, MAMBA_PATH, 0)
    mamba_ms = time_ms(lambda: kr.rwkv6_fused(mq, mk, mv, mld,
                                              chunk=RWKV_CHUNK))
    mamba_plan = kr.last_plan
    mamba_plain_ms = time_ms(lambda: kr.rwkv6_fused_plain(
        mq, mk, mv, mld, chunk=RWKV_CHUNK), iters=3)
    b, h, t, dk, dv = MAMBA_PATH
    mamba_bound_ms, mamba_by = rwkv6_bound(b * h, t, dk, dv, RWKV_CHUNK,
                                           False, False, 4, h, shared_q=True)
    per_head_ms = rwkv6_bound(b * h, t, dk, dv, RWKV_CHUNK, False, False, 4,
                              h)[0]
    log(f"rwkv6 at the Mamba2 path's shape (B·H {b * h}, T {t}, K {dk}, V "
        f"{dv}, chunk {RWKV_CHUNK}, inclusive, float32, q broadcast over the "
        f"heads): kernel {mamba_ms:.4f} ms (plan {mamba_plan}), plain "
        f"{mamba_plain_ms:.4f} ms, bound {mamba_bound_ms:.4f} ms "
        f"({mamba_by}; q read once; {per_head_ms:.4f} ms with q read per "
        f"head, as the kernel reads it); no single PyTorch call computes it "
        f"(library none); {smi}")
    del mq, mk, mv, mld
    log_ptxas("rwkv6", report["rwkv6"])

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "variant": path_variant,
        "launches": launches["flash_attention"], "max_abs_err": path_err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "train_launches_per_step": train["launches_per_step"],
        "train_grad_max_abs_err": grad_errs["flash_attention"],
        "moe_path": {
            "arch": "deepseek-moe-16b",
            "launches": moe_launches["flash_attention"], **moe_row,
            "variant": moe_variant},
        "hybrid_path": {
            "arch": "zamba2-2.7b",
            "launches": hybrid_launches["flash_attention"], **zamba_row,
            "variant": hybrid_variant},
        "audio_path": {
            "arch": "whisper-base",
            "launches": audio_launches["flash_attention"],
            **audio_rows["encoder"], "cross": audio_rows["cross"]},
        "vlm_path": {
            "arch": "phi-3-vision-4.2b",
            "launches": vlm_launches["flash_attention"], **phi3_row},
        "nemotron_head_shape": {"arch": "nemotron-4-340b", **nemotron_row},
        "distributed_path": {
            "note": "per rank, ranks sharing one card (gloo, host-staged)",
            "fsdp_tp_tinyllama": {
                "mesh": "(data 2, model 2)",
                "launches_per_rank_per_step":
                    dist["fsdp_tp"]["launches_per_step"],
                "local_shape": dist["fsdp_tp"]["local_shape"]},
            "ep_deepseek": {
                "mesh": "(data 1, model 2), EP 2",
                "layers": dist["ep"]["layers"],
                "launches_per_rank": dist["ep"]["launches"],
                "local_shape": dist["ep"]["local_shape"]},
            "world1_nccl_launches": dist["world1"]["launches"]},
    }, {
        "name": "phase_max", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/phase_max.cu",
        "replaces": "src/repro/kernels/phase_max.py:47",
        "launches": pm_launches + campaign["launches"] + figures["launches"]
        + schedd["launches"],
        "launches_by_path": {"simulate": pm_launches,
                             "sweep campaign": campaign["launches"],
                             "report figures": figures["launches"],
                             "schedd": schedd["launches"]},
        "campaign": campaign, "figures": figures, "schedd": schedd,
        "max_abs_err": pm_err,
        "ms": pm_row["kernel_ms"], "kernel_ms": pm_row["kernel_ms"],
        "issue_ms": pm_row["issue_ms"], "design": "zero-copy",
        "resident_kernel_ms": pm_row["resident_kernel_ms"],
        "roundtrip_ms": pm_row["roundtrip_ms"],
        "staged_roundtrip_ms": pm_row["staged_ms"],
        "pr16_roundtrip_ms": pm_row["pr16_roundtrip_ms"],
        "numpy_ms": pm_row["numpy_ms"],
        "plain_ms": pm_row["plain_ms"], "bound_ms": pm_row["bound_ms"],
        "bound_by": "bytes", "library_ms": pm_row["library_ms"],
        "shape": "the grid's p50 call",
    }, {
        "name": "rwkv6_chunked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:31",
        "launches": rwkv_launches["rwkv6_chunked"], "max_abs_err": rwkv_err,
        "ms": rwkv_ms, "kernel_ms": rwkv_ms, "plain_ms": rwkv_plain_ms,
        "bound_ms": rwkv_bound_ms, "bound_by": rwkv_by, "library_ms": None,
        "vb": rwkv_plan["vb"], "vb_ms": vb_ms,
        "train_grad_max_abs_err": grad_errs["rwkv6_chunked"],
        "shape": f"B·H {RWKV_PATH[0] * RWKV_PATH[1]}, T {RWKV_PATH[2]}, K "
                 f"{RWKV_PATH[3]}, V {RWKV_PATH[4]}, chunk {RWKV_CHUNK}, "
                 f"bonus, bf16 split_heads views",
        "hybrid_path": {
            "arch": "zamba2-2.7b",
            "shape": f"B·H {b * h}, T {t}, K {dk}, V {dv}, chunk "
                     f"{RWKV_CHUNK}, inclusive, float32, q broadcast over "
                     f"the heads",
            "launches": hybrid_launches["rwkv6_chunked"],
            "max_abs_err": mamba_err, "ms": mamba_ms,
            "plain_ms": mamba_plain_ms, "bound_ms": mamba_bound_ms,
            "bound_by": mamba_by, "library_ms": None,
            "vb": mamba_plan["vb"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
