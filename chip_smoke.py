"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --conv-sweep    # shift-conv's tiles and splits
    python3 chip_smoke.py --ddmm-sweep    # DDMM's column tiles and splits
    python3 chip_smoke.py --lattice       # Step 4b on the card alone
    python3 chip_smoke.py --serve         # the serving phase and the
                                          # request times alone
    python3 chip_smoke.py --sharded       # batch-sharded serving alone
    python3 chip_smoke.py --frontend      # the tracing frontend alone
    python3 chip_smoke.py --gnn           # the GNN phase alone
    python3 chip_smoke.py --train         # the training phase alone
    python3 chip_smoke.py --rec           # the recurrent LM family alone
    python3 chip_smoke.py --moe           # deepseek-v3 and grok-1 alone
    python3 chip_smoke.py --train-families [ARCH ...]
                                          # zamba2, xlstm, deepseek, grok
                                          # trained alone
    python3 chip_smoke.py --dense         # chameleon-34b, codeqwen1.5-7b,
                                          # qwen2-72b, musicgen-medium
    python3 chip_smoke.py --distributed   # four cards: the LM over a mesh
                                          # at full size
    python3 chip_smoke.py --dryrun        # the dry run against the card
    python3 chip_smoke.py --grok-schedule # grok-1's int8 schedules, 1 layer
    python3 chip_smoke.py --all-times     # the full run, every checked
                                          # call of phase 2 timed

Builds the port's hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc``, holds each one against its plain-PyTorch version at every shape the
full-width paths give it (b4 ST-GCN, b6-dyn dynamic point cloud, b6 point
cloud, b5 SAR, b1 few-shot, b2 ML-GCN, b3 DualGCN on ResNet-50 and -101,
and the masked VIP at b3's spatial width) and the LM path (qwen3-0.6b's
served prefills, a 2048-token prefill, and flash attention's edge cases in
fp32 and bf16), serves 8 requests of each GNN-CV path through its compiled
plan with the CUDA kernels bound (eager runners), checks the launch
counts and the outputs against the same plan bound to the plain versions
(on the card and, for one request, on the CPU), serves 16 requests of
qwen3-0.6b at full width
through ``repro_torch.launch.serve`` and checks its tokens against the
plain attention path, and times kernels, requests and tokens.  DDMM is
held to its batch rule (a product stacked along M equals its per-sample
products bit for bit; a second call with split-K the first), and relu
must keep a NaN row NaN.  SpDMM runs through the entry the path calls
(``spdmm_rows`` on b4's ``(C·T, V)`` view), timed beside the route it
replaced (the column kernel between two transposing copies).  KNN is also
held to the orders and ties that stress its warp list
(``knn_adversarial``), SDDMM to split-K at K = 4096 and to exact zeros in
dead tiles over NaN and inf inputs; both print their share of the bound.
Then each GNN-CV path runs again through the public entry point,
``repro_torch.gcv.compile(graph, kernels="cuda")``: ``warmup()`` captures
the batch-1 and batch-4 requests as CUDA graphs (the launches recorded at
capture are counted, and the kernels of a replay by the profiler), the
graph outputs must equal the eager runner's bit for bit, a batch of 4
(eager and graph) each sample's batch-1 output bit for bit, and the
runner cache may miss no more after the warmup; request times (eager
against graph, in turns), samples/s at batch 4 and the device's idle share
under replay are printed.  Then the tracing frontend
(``frontend_phase``): every task of ``gnncv/torch_tasks.py`` traced from
its torch function by ``gcv.compile(fn, example_inputs)`` at its published
defaults; b1-b6, b3-r101 and b6-dyn must give the builder's plan up to
names and its outputs bit for bit on the same requests; b7 (ViG-Ti's
width: 224x224, 16x16 patches, 192 features, 12 blocks, 1000 classes) and
b7-dyn (its KNN graph built per request, k = 9), which exist only traced,
run as the paths above do (launch counts, the plain plan within 1e-4,
graph == eager and batch 4 == batch 1 bit for bit, times), b7-dyn's KNN
indices must equal ``knn_ref`` on the same embeddings and its outputs its
precomputed-graph twin's bit for bit, and b7, b7-dyn and a traced b6-dyn
over graph buckets are served by one ``gcv.serve`` engine, each request
held to its batch-1 run bit for bit.  Then Step 4b on the card
(``lattice_phase``):
each path compiled with ``kernels="auto"`` (the H100 cost model), which
ops bind a plain twin, the ``auto`` plan's outputs against the ``cuda``
plan's, the predicted-vs-measured report (an op whose measured rivals
differ by more than 20% must be ranked right, closer rivals are a tie;
``agreement.rate`` printed), and ``kernels="measured"`` compiled twice
into an autotune cache under ``build/`` (the warm compile measures
nothing); then the same ranking rule at held-out shapes no path has
(``heldout_phase``), where the model was not fitted.  Then the nine paths
through ``gcv.serve`` engines (``serving_phase``): the first engine's
warmup one (task, bucket) at a time, each capture held to that bucket's
eager batched launches; FIFO closed batches at pipeline depth 1 and 2
(req/s over 360 batches), buckets 1, 2, 4 and 8 each held to the batch-1
run bit for bit and, under the profiler, to the kernels their graphs
recorded; open-loop Poisson streams under the SLO scheduler below and
past the knee (req/s, goodput, deadline misses, sojourn p50/p99 over the
served and over every arrival, the adaptive depth, the device's idle
share); and b6-dyn over graph buckets, held as the paths are.  A served
batch must launch nothing from the host.  Then batch-sharded serving
(``sharded_phase``, alone under ``--sharded``): b4, b6-dyn and b3-r50 at
full width through ``gcv.serve(..., devices=[...])`` over every card, or
``[cuda:0, cuda:0]`` (two replicas) on a one-card host: the warmup's
captures (one per replica per bucket, each recording its replica's eager
batched launches), 16 mixed requests equal to the batch-1 graph outputs
bit for bit with no host launch, the runner cache frozen, pads per
device summing to the pads, the resident bytes one replica's times the
replicas; the replicas' served req/s beside a one-device engine's; and
``devices=`` one above the cards present warning and degrading.  Then
the GNN phase
(``gnn_phase``, alone under ``--gnn``): g1 GCN, g2 GraphSAGE and g3 GAT of
``gnncv/gnn_zoo.py`` on cora, citeseer, pubmed and flickr at their
published sizes (the reference's ``GraphSpec``s, seed 0), each compiled
with ``kernels="cuda"`` and ``"torch"`` and served 8 feature requests
(launch counts, the plain plan within 1e-4, graph == eager bit for bit,
batch 4 == batch 1 on cora, input staging, request p50s, replay alone,
device busy and idle share, every DDMM call against its plain version
and ``torch.mm``); KNN's sort route (k above 64) against ``knn_ref``
exactly; dense max-aggregation equal to the plain plan and the CPU run
exactly, NaN and an empty row included; and Step 4 under
``target="fpga"`` and ``"h100"`` on b1-b7 and g1-g3 on cora (the ops
that flip, outputs within 1e-4, each plan's device time).  Before the
GNN phase, the training phase (``train_phase``, alone under ``--train``):
the flash backward kernel (``csrc/flash_attention_bwd.cu``) against
``attention_bwd_ref`` at llama3.2-1b's training shape (bf16 and fp32),
qwen3-0.6b's 2048-token shape and the edge cases (dq, dk, dv each within
tolerance, a second call bit for bit; its device time, TFLOP/s and share
of the bound beside SDPA's backward by events and by device time), the
forward's LSE against
``attention_lse_ref`` and its output bits against the serving forward's;
one fp32 full-width step of llama3.2-1b, kernel path against plain path
(loss and every grad leaf); ``launch.train.train("llama3.2-1b",
smoke=False)`` for 30 steps at the launcher's defaults (launch counts, the
loss falls, step p50/p25/p75, tokens/s, peak memory); a profile of 3 steps
(device busy, idle share, top kernels, flash forward and backward device
time a step); a checkpoint at step 2 of 4 restored bit for bit into fresh
state and run on (resumed == straight reported bit for bit, with the
leaves whose backward does not repeat); and one step with int8 moments.
Then the dry run against the card (``dryrun_phase``, alone under
``--dryrun``): llama3.2-1b's train step at the training batch counted by
``launch/dryrun.py`` on a fake group of 1 and run for real (argument
bytes, FLOPs and flash calls equal, the counted peak within
DRYRUN_PEAK_RTOL of the allocator's, the roofline's terms beside the step).
After the GNN phase, the recurrent family (``rec_phase``, alone
under ``--rec``): zamba2-2.7b (54 Mamba2 blocks and two shared GQA + MLP
blocks applied after every sixth, 32 heads of 80) and xlstm-350m (21
mLSTM and 3 sLSTM blocks) at their published configs in bf16, each
served through ``launch.serve.serve`` at the launcher's defaults (every
prompt prefilled at its exact length; zamba2's 9 shared-attention calls a
prefill through the flash kernel, at D = 80 under its DP = 128
instantiation, checked against ``attention_ref`` at every served length
and at 2048 tokens in bf16 and fp32), then stepped through a
``ServeEngine`` (tok/s, time to first token, step p50); zamba2's bf16
path against the plain path (``bf16_parity``: every
shared-attention call on the plain path's own inputs and the
margin-aware token each prefill emits, asserted, the end-to-end logits
beside a one-ulp input change printed; ``bf16_streams``: every token of
the kernel engine's streams at STREAM_SEEDS, asserted beside the library
attention's engine and the plain engine); fp32 (kernel
path == plain path tokens, or two runs equal; prefill logits) and
float64 (prefill then decode == one ``lm_forward``); a 2048-token
prefill each (p50, device breakdown) and the device time of the SSD,
mLSTM and sLSTM plain paths in a decode step and that prefill.
Last, the mixtures of experts (``moe_phase``, alone under ``--moe``):
deepseek-v3-671b (MLA: q·k over 192, v of 128, 128 heads; 256 experts
top-8 behind 3 dense layers) and grok-1-314b (48/8 GQA heads of 128; 8
experts top-2) at their published width in bf16, the depth cut (printed:
``MOE_LAYERS``) to fit one card; the flash kernel held against its plain
version at each model's shapes (its (192, 128) instantiation for
deepseek: the served buckets, 2048 tokens, a continuation and rows with
no live key, bf16 and fp32), each model served 16 requests through a
``ServeEngine`` at the launcher's defaults (launch counts, tok/s, time to
first token, step p50), the margin-aware token check and every flash call
of the served prefills within 2^-7 of the plain core on its own inputs
and the margin-aware check on the tokens the prefills emit
(``bf16_parity``; the streams' margins beside two controls' under
``--moe`` only: ``bf16_streams``), a 2048-token
prefill, profiles with flash's share of the device, and the
weights in fp32 (deepseek cut to 4 layers: ``MOE_FP32_LAYERS``): prefill
logits of the kernel path within 1e-4 of the plain path's and the
engine's greedy tokens equal.
Then the other families' training (``train_families_phase``, alone under
``--train-families``): zamba2-2.7b and xlstm-350m whole through
``launch.train.train``, deepseek-v3 cut to its 3 dense MLA layers and
grok-1 to 1 layer (int8 moments) through what ``train()`` builds, each at
its published width in bf16 (``FAMILY_TRAIN``): the flash forward with
its LSE and the backward at the arch's training shape (deepseek's
(192, 128) backward also at 2048 tokens) against their plain versions,
bf16 and fp32, a second call bit for bit, and timed; one fp32 step,
kernel path against plain path (loss 1e-6, grads TRAIN_GRAD_RTOL);
FAMILY_STEPS bf16 steps (counts set to 0 just before, read just after;
the loss falls by TRAIN_DROP; step p50/p25/p75, tokens/s, peak memory);
a profiled step (busy, idle share, flash's share); and on FAMILY_RESUME
(on the last arch where the run leaves it out) a checkpoint resume, bit
for bit.
Last, the last four dense archs (``dense_phase``, alone under
``--dense``) at their published width in bf16 (``DENSE_LAYERS``):
chameleon-34b whole (also served through ``launch.serve.serve``),
codeqwen1.5-7b whole, qwen2-72b cut to 4 layers, musicgen-medium whole,
the free memory printed before each (the run fails unless the weights
leave DENSE_HEADROOM): the
flash kernel at their shapes (group 1 under (128, 128) and (64, 64), 64/8
heads) against its plain version, the launcher's requests through a
``ServeEngine`` (launch counts, tok/s, time to first token, step p50),
``bf16_parity``, then in fp32 (``DENSE_FP32_LAYERS``) the prefill logits
and the engine's tokens kernel path against plain path, chameleon's and
musicgen's prefill and greedy decode from embeddings fed from outside
(``embeds_parity``), and the plain ``tri`` and ``chunked_scan`` cores
against the kernel; then musicgen-medium whole (from ``{"embeds",
"labels"}``) and codeqwen1.5-7b at 4 layers trained as the families are
(``DENSE_TRAIN``).
Then the LM over a device mesh (``distributed_phase``, alone under
``--mesh``): one NCCL rank a visible card (a (1, 1) mesh on one card),
the sharded smoke steps of llama3.2-1b and deepseek-v3 (through
``moe_a2a``) held to the one-card step with flash's forward and backward
launched in them, deepseek-v3's decode over the mesh and its MoE's
gathered paths, a checkpoint restored onto the mesh, ``ServeEngine(mesh=)``
(its greedy tokens against the engine without a mesh, flash launched in
its prefills), zamba2's smoke step and decode against no mesh, and an int8
step on placed parameters bit for bit (``dist_rest_smoke``); ``--mesh``
then times flash at the per-rank shapes of the four-card sections' served
prefills beside its plain core (``dist_flash_shapes``);
``--distributed[=sections]`` runs on four cards instead: (a) llama3.2-1b
at its published size over (2, 2) held to one card and trained 10 bf16
steps, (b) deepseek-v3's 3 dense and 1 MoE layer at its published width
over (1, 4) trained 10 steps, (c) ``pipeline_apply`` over 4 stages, (d)
qwen3-0.6b served over (2, 2) and (1, 4) against one card, with one row
of an 8192-token prompt decoded over both (the caches' sequence over all
four ranks), (e) zamba2-2.7b
and xlstm-350m trained and served over both, (f) grok-1 with int8 moments
over (1, 4), (g) its checkpoint restored onto (2, 2), (x) the dry run of
llama3.2-1b's train step over (2, 2) against the four ranks' (collective
bytes per kind and argument bytes equal; sections "abc", "d", "e", "f",
"g", "x"; all by default), and (w), not by default: the witnesses that
tell a fault of the mesh from rounding (xlstm-350m's fp32 and fp64 steps,
grok-1's 1-layer step and loss curves).  grok-1 steps on GROK_SCHEDULE
(``--grok-schedule`` prints the candidates' curves).  Every training
curve is held to the whole-curve loss bar (``loss_bar``).
Timing that holds no kernel against its plain version runs under its
phase's flag only, not in the full run: the GNN-CV paths' eager request
times of both plans and their request profiles (``request_times``)
under ``--serve``, the 2048-token prefills' host
times and profiles of ``--rec`` (``rec_scan_times``; xlstm's 2048-token
prefill whole), ``--moe`` and ``--dense`` (``lm_profiles``), the
families' and the dense archs' profiled steps under ``--train-families``
and ``--dense``, llama3.2-1b's under ``--train``, the GNN paths' input
staging and Step 4's device busy time under ``--gnn``, and in those
phases the times of the calls off the path (fp32, edge cases, other
lengths: checked in the full run as well); so do the MoE and dense
archs' bf16 streams (``bf16_streams``), printed beside their controls
and asserted for none of them.  To fit the time limit, these checks run
under their phase's flag only as well: zamba2's bf16 streams and the
recurrent family's fp32 and float64 checks (``rec_fp32_parity``) under
``--rec`` (zamba2's fp32 prefill logits, kernel path against plain
path, stay in the full run), the MoE and dense archs' fp32 checks
(``arch_fp32``, codeqwen's plain cores) under ``--moe`` and ``--dense``,
the fp32 step of each family and dense arch, kernel path against plain
path (``train_fp32_parity``; llama3.2-1b's stays in the full run), and
FAMILY_RESUME's checkpoint resume under ``--train-families`` (llama3.2-
1b's resume stays), and the GNN paths on citeseer, pubmed and flickr
under ``--gnn`` (the full run takes cora, GNN_DEFAULT_DATASETS).  The
full run times only the calls each path makes, and qwen3-0.6b's
profiles not at all (``--all-times``: both), and a dense kernel's call
that several paths make once (``case_times``).  llama3.2-1b's checkpoint
resume runs at TRAIN_RESUME_LAYERS.  Every stamp
prints the seconds since the one before.
Every number printed is measured in this run.
The last line is the JSON result; any failure exits nonzero before it.
Imports the port only (``repro_torch``), never JAX.

``--conv-sweep`` instead times the shift-conv kernel at every pixel tile
and split-K factor it takes, at every distinct conv shape of b4, b5, b1,
b2 and b3, checks each against the plain version, and prints the plan's
choice (``shift_conv.launch_plan``) beside the best: the data behind the
plan's rule.  ``--ddmm-sweep`` does the same for DDMM's tensor-core route
(column tile and split-K at every tensor-core call of the paths, beside
``ddmm.launch_plan``'s choice).  ``--bwd`` runs only the flash backward's
and the LSE's checks and times of the training phase (no training path,
no JSON row).
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import types
import warnings
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
STARTED = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM rate and
# the fp32 rate outside the tensor cores, which is what the fp32 SIMT
# kernels (and their plain versions, with TF32 off) run on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# the bf16 tensor-core peak: the least time for bf16 attention's products
BF16_FLOPS = 989e12
# Shift-conv runs fp32-accurate products on the TF32 tensor cores as three
# TF32 products each (3xTF32): its least time is 3·ops / 495 TFLOP/s.
TF32_FLOPS = 495e12
CONV_FLOPS = TF32_FLOPS / 3

# Tolerances.  The kernels accumulate in fp32 in another order than the
# plain versions (cuBLAS / torch reductions): the rounding error of a
# K-term fp32 dot grows like sqrt(K)·2^-24 ≈ 3e-6 at b4's largest
# K = 9·256, so a kernel agrees within 1e-5 of the output's magnitude.
# Through 29 ops of a request those differences compound, hence 1e-4 end
# to end.  (b5's COO sums add each row's edges in edge order: the same
# bits every run.)  KNN indices must be equal exactly: the
# kernel repeats the plain version's fp32 arithmetic.
KERNEL_RTOL = 1e-5
E2E_RTOL = 1e-4
# Flash attention in bf16: kernel and plain version both compute from the
# same bf16 inputs with fp32 sums (the kernel's p in three bf16 parts,
# fp32-level) and round the result once to bf16, so an element may differ
# by one bf16 ulp (2^-8 of itself) where the two sums straddle a rounding
# boundary: within 2^-7 of max|plain|.  Shift-conv's 3xTF32 products are
# fp32-level (~2^-21 of each product): KERNEL_RTOL holds for it.
FLASH_BF16_RTOL = 2.0 ** -7
REQUESTS = 8
# The lattice phase: an op whose measured rivals differ by more than this
# share must be ranked right by the H100 model (closer rivals may swap
# between runs: a launch-bound call's time is the host's).  The verdict
# takes each candidate's median over AGREE_MEASUREMENTS independent
# measurements (``measure_op``, each the best of its rounds): one
# measurement of a launch-bound pair has moved by up to 70% between runs.
AGREE_GAP = 0.2
AGREE_MEASUREMENTS = 5
# At the held-out shapes (``heldout_graphs``) at least this share of the
# ops whose rivals are more than AGREE_GAP apart must be ranked right.  The
# model's host floors are constants, while the host's speed for the
# multi-kernel plain twins moved 1.5-2.7x between two machines (the gather
# SpDMM at 300 x 5 slots @ (300, 1024): 83.6 and 226.1 us, PERF.md §5), so
# a pair near its crossover ranks one way on one host and the other way on
# the next.
HELDOUT_RATE = 0.8
# The serving phase: engines over the nine paths (buckets 1, 2, 4, 8).
# (a) takes its req/s over SERVE_ROUNDS rounds of one bucket-8 batch of
# every path (360 batches: one short window moved by 15% between runs).
# (b) draws Poisson arrivals of uniformly drawn tasks (a smoke mix with no
# published source) for STREAM_S seconds at two rates: STREAM_BELOW req/s,
# below the knee PERF.md §5 measured, and STREAM_LOAD of (a)'s depth-2
# req/s, which lies past it; each request is due SLO_FACTOR x b3-r101's
# batch-1 graph p50 after it arrives.  (c) serves b6-dyn at DYN_BUCKETS
# points, DYN_REQUESTS clouds of DYN_POINTS points each.
SERVE_MAX_BATCH = 8
SERVE_ROUNDS = 40
STREAM_BELOW = 1000.0
STREAM_LOAD = 0.7
STREAM_S = 2.0
SLO_FACTOR = 10
DYN_BUCKETS = (512, 1024)
DYN_POINTS = (400, 1024)
DYN_REQUESTS = 16
GNNCV_KERNELS = ("shift_conv2d", "spdmm", "ddmm", "knn", "sddmm")
# Batch-sharded serving: these paths over every card, or two replicas on
# cuda:0 where there is one; SHARDED_REQUESTS mixed requests held bit for
# bit, then SHARDED_ROUNDS rounds of them timed on each engine.
SHARDED_TASKS = ("b4", "b6-dyn", "b3-r50")
SHARDED_REQUESTS = 16
SHARDED_ROUNDS = 8
# The GNN phase: g1-g3 of ``gnncv/gnn_zoo.py`` on the Table IX graphs at
# their published sizes (cora 2708 nodes / 10556 edges / 1433 features /
# 7 classes, citeseer 3327 / 9104 / 3703 / 6, pubmed 19717 / 88648 / 500 /
# 3, flickr 89250 / 899756 / 500 / 7), each model's DDMM launches per
# request (every linear; the COO aggregations, the GAT scores and the
# segment softmax are plain PyTorch), GNN_TURNS turns of request times.
GNN_MODELS = ("g1_gcn", "g2_sage", "g3_gat")
GNN_DATASETS = ("cora", "citeseer", "pubmed", "flickr")
# the default run's: the smallest (``--gnn``: all four)
GNN_DEFAULT_DATASETS = ("cora",)
GNN_DDMM = {"g1_gcn": 2, "g2_sage": 4, "g3_gat": 2}
GNN_TURNS = 2
# The KNN sort route (k above the warp route's 64) at N = 1024, and at
# b6-dyn's own points; dense max-aggregation over b6-dyn's points' 20-NN
# adjacency; Step 4 compares plans on STEP4_REQUESTS requests.
KNN_SORT_K = (65, 128, 512, 1024)
KNN_SORT_ORDERS = ("padded", "masked", "rising", "falling", "equal")
DYN_SORT_K = 100
MAXAGG_K = 20
STEP4_REQUESTS = 2
# The graph phase: batch-1 request times over GRAPH_TURNS turns of the
# REQUESTS requests for each runner (eager, graph), and BATCH_TURNS turns
# of the two batches of GRAPH_BATCH for each batched runner.
GRAPH_BATCH = 4
GRAPH_TURNS = 5
BATCH_TURNS = 10
# b6-dyn requests: a 960-point cloud padded to a 1024-point bucket, as
# graph-bucketed serving sends it.
PAD_POINTS = 64
# The masked VIP path: b3-r50's spatial branch (14x14 patches of 512
# channels), each patch sampling its 5x5 window (nnz 4096, density 0.107).
VIP_SIDE, VIP_FEAT, VIP_WIN = 14, 512, 5
# b3's random-weight ResNet has zero biases and identity BN statistics, so
# its features grow through depth (to ~1e4 at a standard-normal 224x224
# image for ResNet-50) and its VIP affinities reach 1e10 and more: the
# softmax over them is a hard argmax, and any two fp32 orders of summation
# flip its near-ties.  The backbone is positively homogeneous (conv, ReLU,
# max pool, residual add), so scaling the image by s scales the affinities
# by s²: b3's requests are scaled by the power of two that brings their
# largest affinity to at most AFFINITY_PEAK, where the softmax is smooth
# and the comparison with the plain versions means something.
# The work, and so every time, does not depend on the data.  The masked
# VIP's standard-normal 512-feature nodes have self-affinities near 512
# against neighbours' ±23, so its softmax would collapse to the diagonal
# and the path would return its input: its requests are scaled the same
# way.
SCALED_TASKS = ("b3-r50", "b3-r101", "vip-masked")
AFFINITY_PEAK = 4.0
# Launches per request of each task's main path (the plan's bindings).  An
# unmasked VIP runs the DDMM kernel on x @ xᵀ, as the reference does.
PER_REQUEST = {
    "b4": {"shift_conv2d": 18, "spdmm": 9, "ddmm": 1, "knn": 0, "sddmm": 0},
    "b6-dyn": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 6, "knn": 1,
               "sddmm": 0},
    "b6": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 6, "knn": 0, "sddmm": 0},
    "b5": {"shift_conv2d": 2, "spdmm": 0, "ddmm": 3, "knn": 0, "sddmm": 0},
    # 4 convs on the (26, c, H, W) stack; 5 linears, 3 runtime-adjacency
    # MPs and 3 unmasked VIPs
    "b1": {"shift_conv2d": 4, "spdmm": 0, "ddmm": 11, "knn": 0, "sddmm": 0},
    "b2": {"shift_conv2d": 53, "spdmm": 0, "ddmm": 5, "knn": 0, "sddmm": 0},
    "b3-r50": {"shift_conv2d": 55, "spdmm": 0, "ddmm": 6, "knn": 0,
               "sddmm": 0},
    "b3-r101": {"shift_conv2d": 106, "spdmm": 0, "ddmm": 6, "knn": 0,
                "sddmm": 0},
    "vip-masked": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 1, "knn": 0,
                   "sddmm": 1},
}
# The traced-only paths (``repro_torch.gnncv.torch_tasks``), at ViG-Ti's
# width: a 224x224 image in 16x16 patches (196 nodes of 192 features), 12
# blocks, ImageNet's 1000 classes; b7-dyn builds its graph per request with
# ViG's k = 9.  One patch-embedding conv, 12 blocks x 4 linears and the
# classifier; b7's patch graph is a COO (coo_scatter, no kernel).
TRACED_PER_REQUEST = {
    "b7": {"shift_conv2d": 1, "spdmm": 0, "ddmm": 49, "knn": 0, "sddmm": 0},
    "b7-dyn": {"shift_conv2d": 1, "spdmm": 0, "ddmm": 49, "knn": 1,
               "sddmm": 0},
}
# b7-dyn against its precomputed-graph twin on this many requests (each
# twin is traced and compiled with its request's indices baked in)
TWIN_REQUESTS = 2
# The LM path: qwen3-0.6b at full width (28 layers, 16 query and 8 kv heads
# of 128), random weights from seed 0, the launcher's defaults: 16 requests
# with prompt lengths in [8, 48) from seed 0 (buckets of 16, 32 and 48),
# 32 new tokens each, 8 slots, 256 positions, greedy.  One prefill per
# request launches the flash kernel once per layer.  Then one prefill of a
# 2048-token prompt.
LM_ARCH = "qwen3-0.6b"
LM_REQUESTS, LM_MAX_NEW, LM_SLOTS, LM_MAX_LEN = 16, 32, 8, 256
LM_PROMPT_LEN = (8, 48)
LONG_PROMPT = 2048
# bf16 end to end: the kernel path and the plain path (``impl="naive"``)
# differ by one bf16 rounding of some attention outputs per layer, carried
# through 28 layers of bf16 arithmetic.  Prefill logits of the two paths
# must agree within PREFILL_RTOL of max|logits|.  Greedy tokens may then
# part where two logits lie closer than that, so each token the engine
# emits must hold a plain-path logit (teacher-forced over the prompt and
# the engine's own tokens) within MARGIN_RTOL of max|logits| of that
# position's maximum: twice the prefill bound, one for each path's error.
PREFILL_RTOL = 2e-2
MARGIN_RTOL = 4e-2
# zamba2's bf16 streams (``bf16_streams``): the same margin-aware check over
# every token of every stream, pooled over the launcher's prompts at these
# seeds (0 is the served set; three for the run's time, four measured by
# ``tools/stream_margins.py``), for the kernel engine and two engines
# without the kernel (SDPA in its place; the plain core).  The kernel
# engine's largest gap must stay within MARGIN_RTOL or within the largest
# gap of those two over the same prompts: on an H100 the plain engine
# alone reached 4.434e-2 and 4.583e-2 at seeds 2 and 3, and 6.719e-2 at
# seed 0 with bf16-rounded products, so the random model's bf16 streams
# cross MARGIN_RTOL with no kernel at all (PERF.md §6).
STREAM_SEEDS = range(3)
# The same weights cast to fp32: the two paths then differ only by the
# order of fp32 sums, so their prefill logits must agree within E2E_RTOL.
# The recurrent family (``rec_phase``): zamba2-2.7b and xlstm-350m at their
# published configs, random weights from seed 0, served with the launcher's
# defaults above, every prompt prefilled at its exact length.
REC_ARCHS = ("zamba2-2.7b", "xlstm-350m")
# The mixtures of experts (``moe_phase``) at their published width, the
# depth cut to fit one 80 GB card in bf16 (random weights from seed 0):
# deepseek-v3-671b to its 3 dense layers and 2 MoE layers of 61 (about 53
# GB: each MoE layer holds 256 experts of 3 x 7168 x 2048), grok-1-314b to
# 2 of 64 (about 23 GB); for the fp32 check deepseek to 3 dense + 1 MoE
# (about 60 GB), grok stays at 2 (about 45 GB).
MOE_LAYERS = {"deepseek-v3-671b": 5, "grok-1-314b": 2}
MOE_FP32_LAYERS = {"deepseek-v3-671b": 4, "grok-1-314b": 2}
# The last four dense archs (``dense_phase``, alone under ``--dense``) at
# their published width in bf16, random weights from seed 0, each serving
# the launcher's requests above: chameleon-34b (48 layers, d 8192, 64/8
# heads of 128, qk-norm; 34.29 B params, 68.6 GB) whole, through
# ``launch.serve.serve`` too (DENSE_SERVE); codeqwen1.5-7b (32 layers, d
# 4096, 32/32 heads of 128, qkv biases; 8.19 B, 16.4 GB) whole; qwen2-72b
# (80 layers, d 8192, 64/8 heads of 128, qkv biases; 72.7 B, 145 GB, past
# one card) cut to 4 layers (6.00 B, 12.0 GB); musicgen-medium (48 layers,
# d 1536, 24/24 heads of 64, sinusoidal positions, gelu; 1.37 B, 2.7 GB)
# whole.  Before each model the script prints the free memory and fails
# unless the weights leave DENSE_HEADROOM free: the cuts are these fixed
# ones, never made at run time.
# chameleon and musicgen take embeddings from outside: their engines serve
# token ids through the table (the engine takes token prompts, as the
# reference's), and their fp32 prefill and decode from embeddings are held
# kernel path against plain path (``embeds_parity``).  The fp32 checks run
# at DENSE_FP32_LAYERS (chameleon 4 layers: 15.4 GB); the ``tri`` and
# ``chunked_scan`` cores are held to the flash kernel at DENSE_CORES'
# shapes.  Then DENSE_TRAIN as FAMILY_TRAIN: musicgen-medium whole from
# ``{"embeds", "labels"}`` batches (through what ``train()`` builds: the
# launcher feeds tokens only), codeqwen1.5-7b cut to 4 layers (1.69 B),
# fp32 moments.
DENSE_LAYERS = {"chameleon-34b": None, "codeqwen1.5-7b": None,
                "qwen2-72b": 4, "musicgen-medium": None}
DENSE_FP32_LAYERS = {"chameleon-34b": 4, "codeqwen1.5-7b": None,
                     "qwen2-72b": 4, "musicgen-medium": None}
DENSE_SERVE = "chameleon-34b"
DENSE_CORES = "codeqwen1.5-7b"
DENSE_HEADROOM = 6 * 2**30
DENSE_TRAIN = {"musicgen-medium": (None, False),
               "codeqwen1.5-7b": (4, False)}
EMBED_DECODE_STEPS = 32
# The training path: llama3.2-1b at its published width (16 layers, d 2048,
# 32/8 heads of 64, d_ff 8192, vocab 128256, tied, bf16), random weights
# from seed 0, through ``launch.train.train`` at the launcher's defaults
# (batch 8 x 128 tokens, AdamW, cosine lr from 3e-4) for TRAIN_STEPS steps;
# step times after TRAIN_WARM steps.  The loss must fall by TRAIN_DROP
# nats from the first step to the last.  Each step launches the forward
# kernel (with its LSE) and the backward kernel once a layer.
TRAIN_ARCH = "llama3.2-1b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARM = 30, 8, 128, 3
TRAIN_DROP = 0.1
# The loss bar holds the whole curve (``loss_bar``): besides falling by
# TRAIN_DROP from the first step to the last, no step's loss may stand more
# than TRAIN_RISE nats above the first step's.  Both recorded grok-1 curves
# with int8 moments on the cosine from 3e-4 fail it (12.2871 -> 25.0472
# and -> 18.2786 at step 7: 12.76 and 5.99 nats above the first, though
# each ends below its start).  The cosine reaching its peak at step 2 of
# a 10-step run lifts the curves that train too, on an H100: zamba2-2.7b's
# (launch.train.train) 4.67 nats above its first loss at step 3, then
# 1.65 below it by step 10; llama3.2-1b's over (2, 2) 1.25 up at step 3.
# The margin sits between the largest rise of a curve that trains and the
# smaller of grok's.
TRAIN_RISE = 5.5
# grok-1's schedule with int8 moments (peak lr, warmup steps of the
# cosine): the one-card family run and the four-card runs of
# ``--distributed`` (f, g, w) step on it.  Chosen on one card at 1 layer
# from GROK_CANDIDATES (``--grok-schedule``, each whole curve printed): the
# cosine from 3e-4 with 2 warmup steps, which every other arch trains on,
# spikes there.  On an H100 all three candidates held the bar; the last
# fell furthest (12.2871 -> 10.4725) and never rose above its first loss,
# where the others rose 0.50 and 0.53 nats at step 3.
GROK_CANDIDATES = ((1e-4, 2), (3e-4, 6), (1e-4, 6))
GROK_SCHEDULE = GROK_CANDIDATES[2]
# The family runs that step on another schedule than the cosine from 3e-4
# with 2 warmup steps (``train_setup``): grok-1's, and deepseek-v3's at 3
# layers, whose curve rose 16.44 nats at step 4 on it (12.2647 -> 28.7062,
# then 11.5865 at step 10) and 8.07 at step 7 on grok's schedule, and
# fell 1.5356 with no rise on the cosine from 3e-5 with 2 warmup steps, on
# an H100.
FAMILY_SCHEDULE = {"grok-1-314b": GROK_SCHEDULE,
                   "deepseek-v3-671b": (3e-5, 2)}
# The checkpoint resume of the training path runs at TRAIN_RESUME_LAYERS
# of llama3.2-1b's 16 layers, width unchanged: its save and restore of
# 11.5 GiB whole took 40.7 s of disk time on the H100 machine.
TRAIN_RESUME_LAYERS = 4
# The flash backward against ``attention_bwd_ref`` on the same q, k, v, out,
# LSE and dout (B, Hq, Hkv, Sq, Sk, D, causal): llama3.2-1b's training
# shape (bf16 and fp32), qwen3-0.6b's 2048-token shape (bf16), a
# non-causal case, a continuation (Sq < Sk), rows with no live key
# (Sq > Sk) and a D = 128 continuation whose lengths are off the bf16
# kernel's 64-row tiles; dq, dk and dv each within KERNEL_RTOL (fp32) or
# FLASH_BF16_RTOL (bf16: both sum in fp32 and round once; the kernel feeds
# p and ds to the tensor cores in two bf16 parts) of max|plain|, and a
# second call bit for bit (no atomics).  The forward's LSE must match
# ``attention_lse_ref`` within KERNEL_RTOL of max|lse|.
TRAIN_SHAPE = (TRAIN_BATCH, 32, 8, TRAIN_SEQ, TRAIN_SEQ, 64, True)
QWEN_BWD_SHAPE = (1, 16, 8, LONG_PROMPT, LONG_PROMPT, 128, True)
FLASH_BWD_EDGES = [(2, 4, 2, 77, 100, 64, False), (1, 4, 1, 64, 256, 64, True),
                   (2, 4, 1, 40, 24, 64, True), (2, 8, 2, 100, 163, 128, True)]
# bf16 parts of p and ds the backward kernel feeds its second-stage
# products (``PARTS`` in csrc/flash_attention_bwd.cu): its MMAs issue
# 4 + 3 · BWD_PARTS products of 2·D operations per live pair
BWD_PARTS = 2
# The other families' training paths (``train_families_phase``, alone under
# ``--train-families``), each at its published width in bf16 with random
# weights from seed 0, batch TRAIN_BATCH x TRAIN_SEQ from the launcher's
# pipeline, AdamW on the cosine schedule from 3e-4, FAMILY_STEPS steps:
# zamba2-2.7b and xlstm-350m whole, through ``launch.train.train`` itself
# (fp32 moments); deepseek-v3-671b cut to its 3 dense MLA layers of 61
# (3.604 B params; one MoE layer adds 11.27 B, past the card with its
# grads and moments) with fp32 moments, and grok-1-314b cut to 1 layer of
# 64 (6.531 B; fp32 moments would need 78 GB) with int8 moments, both
# through what ``train()`` builds (``train_setup``) on the cut config.
# (depth cut or None, int8 moments) per arch; the fp32 kernel-vs-plain step
# runs at the same depths, its first grads in host memory.  The resume
# check (bit for bit) runs on FAMILY_RESUME when the run trains it, else
# on the run's last arch: xlstm-350m's recurrent tree (4.8 GiB, about
# 30 s) in the full run; ``--train-families grok-1-314b`` resumes
# grok-1's int8 MoE tree (24.5 GiB, about 140 s on an H100 machine: the
# full run with it took 1224 s, past its time limit).
FAMILY_TRAIN = {"zamba2-2.7b": (None, False), "xlstm-350m": (None, False),
                "deepseek-v3-671b": (3, False), "grok-1-314b": (1, True)}
FAMILY_STEPS = 10
FAMILY_RESUME = "xlstm-350m"
# One fp32 step at full width, kernel path against plain path: the loss
# within 1e-6 relative (the same fp32 math summed in another order), every
# grad leaf within TRAIN_GRAD_RTOL of its max|plain| (the attention's
# rounding differences carried back through 16 layers).
TRAIN_GRAD_RTOL = 1e-4
# The name prefix of each kernel's device kernels in a profile (shift-conv's
# split-K reduction is ``shift_conv_splitk_reduce``; flash has a bf16 and
# an fp32 kernel, its backward three kernels a call).
DEVICE_PREFIX = {"shift_conv2d": "shift_conv", "spdmm": "ell_spdmm",
                 "ddmm": "ddmm", "knn": "knn", "sddmm": "sddmm",
                 "flash_attention": ("flash_f32", "flash_bf16"),
                 "flash_attention_bwd": "flash_bwd"}
# The device kernels that are each wrapper's launch (shift-conv's split-K
# reduction is a second kernel of the same launch), counted per graph
# replay under the profiler.
MAIN_KERNELS = {"shift_conv2d": ("shift_conv_tf32x3_kernel",),
                "spdmm": ("ell_spdmm_rows_kernel",),
                "ddmm": ("ddmm_tf32x3_kernel", "ddmm_narrow_kernel"),
                "knn": ("knn_kernel", "knn_sort_kernel"),
                "sddmm": ("sddmm_tf32x3_kernel",)}
# the kernels whose rows print their achieved share of the bound (the
# three redesigned last, from under 2% of it)
BOUND_SHARE = ("knn", "sddmm", "flash_attention_bwd")
SOURCES = {
    "shift_conv2d": ("src/repro_torch/kernels/csrc/shift_conv.cu",
                     "src/repro/kernels/shift_conv.py:78"),
    "spdmm": ("src/repro_torch/kernels/csrc/spdmm.cu",
              "src/repro/kernels/spdmm.py:76"),
    "ddmm": ("src/repro_torch/kernels/csrc/ddmm.cu",
             "src/repro/kernels/ddmm.py:103"),
    "knn": ("src/repro_torch/kernels/csrc/knn.cu",
            "src/repro/kernels/knn.py:128"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm.py:81"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:108"),
    # no Pallas call: the XLA backward of flash_attention_xla's custom_vjp
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:279"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """-> (max |got - want|, that over max |want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
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


def bound_ms(nbytes: float, flops: float,
             rate: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Case:
    """One kernel call at one shape: the kernel, its plain version, an
    optional one-call library yardstick, the bytes and operations the call
    needs and the peak rate of those operations, how many times one
    request of the path makes it (on average), whether the result must
    equal the plain version's exactly (integer indices), and the
    tolerance otherwise."""
    kernel: str
    label: str
    run: Callable
    plain: Callable
    library: Callable | None
    nbytes: float
    flops: float
    per_request: float
    exact: bool = False
    rtol: float = KERNEL_RTOL
    rate: float = FP32_FLOPS
    plan: object = None          # shift-conv's or DDMM's launch plan
    # the route the runtime took before this kernel's redesign, timed
    # beside it (SpDMM: the column kernel between two transposing copies)
    before: Callable | None = None
    # DDMM: ``torch.mm`` of the product alone, the yardstick where no one
    # PyTorch call computes the product with its epilogue
    mm: Callable | None = None
    # DDMM: the call's (x, y, bias, residual, act), for ``--ddmm-sweep``
    args: tuple = ()
    # the operations the kernel issues, where it runs more than the
    # function needs (the flash backward recomputes two products)
    run_flops: float | None = None
    # device time of the call by kernel and of the library call, each in a
    # window bracketed on the card (``device_breakdown``), in place of
    # ``device_ms`` (a library backward's events time is the host's rate)
    bracketed: bool = False


def mm_operands(op, xin, shapes, rng):
    """The ``(x, y)`` a ``cuda_ddmm`` mm op hands the DDMM kernel, by its
    side: compile-time operands from the plan, runtime ones random."""
    side = op.attrs["weight_side"]

    def rand(*shape):
        return rng.standard_normal(shape)

    def rows(shape):                               # (..., F) -> (M, F)
        return int(np.prod(shape[:-1] or (1,))), shape[-1]

    if side == "right":
        return rand(*rows(xin)), op.weights["w"]
    if side == "left":
        return op.weights["adj"], rand(*xin)
    if side == "left_runtime":
        return rand(*shapes[op.inputs[1]]), rand(*xin)
    if side == "both_runtime":
        y = shapes[op.inputs[1]]
        return rand(*rows(xin)), rand(y[0], int(np.prod(y[1:])))
    raise AssertionError(f"{op.name}: no DDMM case for side {side!r}")


def task_cases(task, plan, rng, dev) -> list[Case]:
    """Every distinct kernel call ``plan`` makes, with the plan's own
    weights and random activations, plus how often one request makes it;
    then, per task, shapes beyond the main path."""
    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def ddmm_at(x, y, gram=False, epi=None):
        epi = epi or {}
        key = ("ddmm", tuple(x.shape), tuple(y.shape), gram,
               tuple(sorted((k, v is not None if k != "act" else v)
                            for k, v in epi.items())))
        if key not in cases:
            cases[key] = ddmm_case(x, y, gram=gram, per_request=0, **epi)
        cases[key].per_request += 1

    shapes = dict(plan.meta["input_shapes"])
    cases: dict[tuple, Case] = {}
    for op in plan.ops:
        xin = tuple(shapes[op.inputs[0]])
        shapes[op.name] = op.out_shape
        if op.kernel == "cuda_ddmm" and op.kind == "conv":
            w = op.weights["w"]
            kw = dict(stride=op.attrs["stride"], padding=op.attrs["padding"])
            key = ("conv", xin, w.shape, kw["stride"], kw["padding"])
            if key not in cases:
                cases[key] = conv_case(t(rng.standard_normal(xin)), t(w),
                                       kw, per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_ell_spdmm":
            c, tt, v = xin                     # right_t: the (C·T, V) view
            key = ("spdmm", (c * tt, v), op.ell[0].shape)
            if key not in cases:
                idx, val = t(op.ell[0], torch.int32), t(op.ell[1])
                x2 = t(rng.standard_normal((c * tt, v)))
                cases[key] = spdmm_case(idx, val, x2, per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_ddmm" and op.kind == "mm":
            # the runtime hands the kernel the op's epilogue where it can
            x, y = map(t, mm_operands(op, xin, shapes, rng))
            ddmm_at(x, y, epi=handed_epilogue(op, x.shape[0], y.shape[1],
                                              rng, dev))
        elif op.kernel == "cuda_sddmm" and "mask" not in op.weights:
            x = t(rng.standard_normal(xin))            # VIP: x @ xᵀ, a view
            ddmm_at(x, x.T, gram=True)
        elif op.kernel == "cuda_sddmm":
            x = t(rng.standard_normal(xin))
            key = ("sddmm", xin, op.attrs["nnz"])
            if key not in cases:
                cases[key] = sddmm_case(x, x.T, t(op.weights["mask"]),
                                        per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_knn":
            n = xin[0]
            key = ("knn", xin, op.attrs["k"])
            if key not in cases:
                cases[key] = knn_case(
                    t(rng.standard_normal(xin)), op.attrs["k"],
                    mask=t(pad_mask(n)) if op.attrs.get("masked") else None,
                    self_loops=bool(op.attrs.get("self_loops")),
                    per_request=0)
            cases[key].per_request += 1
        elif op.kernel not in ("torch_ew", "coo_scatter"):
            raise AssertionError(f"unexpected kernel {op.kernel} on {task}")
    extra = []
    if task == "b4":
        # beyond the path: ragged tiles with the whole epilogue, and the
        # conv options; SpDMM's column entry (the JAX signature) at b4's
        # widest shape
        x = t(rng.standard_normal((1000, 700)))
        idx, val = (t(a, dt) for a, dt in zip(
            next(op.ell for op in plan.ops if op.ell is not None),
            (torch.int32, torch.float32)))
        extra = [ddmm_case(x, t(rng.standard_normal((700, 300))),
                           bias=t(rng.standard_normal(300)),
                           residual=t(rng.standard_normal((1000, 300))),
                           act="gelu", per_request=0),
                 spdmm_columns_case(idx, val, t(rng.standard_normal(
                     (25, 19200)))),
                 conv_case(t(rng.standard_normal((32, 40, 25))),
                           t(rng.standard_normal((3, 3, 8, 32))),
                           dict(stride=(2, 1), padding="SAME", groups=4,
                                dilation=(2, 1)), per_request=0),
                 conv_case(t(rng.standard_normal((16, 21, 25))),
                           t(rng.standard_normal((3, 2, 8, 16))),
                           dict(stride=(1, 2), padding="VALID", groups=2,
                                dilation=(1, 3)), per_request=0)]
    elif task == "b6-dyn":
        # beyond the path: integer coordinates (exact distance ties), self
        # loops, a ragged N, b7-dyn's shape (196 patches of 192 features)
        ints = rng.integers(-4, 5, (1024, 3))
        extra = [knn_case(t(ints), 20, mask=None, self_loops=False,
                          per_request=0),
                 knn_case(t(rng.standard_normal((1024, 3))), 20, mask=None,
                          self_loops=True, per_request=0),
                 knn_case(t(rng.standard_normal((1000, 3))), 20,
                          mask=t(pad_mask(1000)), self_loops=False,
                          per_request=0),
                 knn_case(t(rng.standard_normal((196, 192))), 9, mask=None,
                          self_loops=False, per_request=0)]
        # the warp list's worst orders and ties, and k at both ends (their
        # own generator: the other paths' inputs stay as they were)
        from repro_torch.kernels.knn import WARP_MAX_K
        own = np.random.default_rng(17)
        for name, k in (("rising", 20), ("falling", 20), ("equal", 20),
                        ("masked", 20), ("normal", 1), ("rising", WARP_MAX_K)):
            x, mask = knn_adversarial(name, 1024, 3, own)
            extra.append(knn_case(t(x), k, mask=None if mask is None
                                  else t(mask), self_loops=False,
                                  per_request=0, note=name))
    elif task == "b1":
        # beyond the path: every other act, ragged M, N and K on both y
        # layouts, and each route at K not a multiple of 4
        for act, (m, k, n) in zip(("gelu", "silu", "tanh", None),
                                  ((26, 800, 400), (33, 257, 129),
                                   (5, 403, 7), (100, 70, 130))):
            x = t(rng.standard_normal((m, k)))
            for y in (t(rng.standard_normal((k, n))),
                      t(rng.standard_normal((n, k))).T):
                extra.append(ddmm_case(
                    x, y, bias=t(rng.standard_normal(n)),
                    residual=t(rng.standard_normal((m, n))), act=act))
    elif task == "vip-masked":
        # beyond the path: the reference's three shapes, ragged M, N and K,
        # a mask of density 1 and one of density 0, y stored k-major
        for m, k, n, density in ((128, 64, 128, 0.2), (256, 128, 256, 0.05),
                                 (100, 50, 70, 0.4), (33, 17, 65, 0.3),
                                 (37, 1, 31, 1.0), (64, 40, 96, 0.0)):
            y = t(rng.standard_normal((k, n)))
            extra.append(sddmm_case(
                t(rng.standard_normal((m, k))), y,
                t(rng.random((m, n)) < density), per_request=0))
        x = t(rng.standard_normal((100, 50)))
        extra.append(sddmm_case(x, x.T, t(rng.random((100, 100)) < 0.4),
                                per_request=0))
        # split-K at its deepest: K = 4096 in 8 chunks, ragged M and N, y
        # row-major and a transposed view (their own generator)
        own = np.random.default_rng(17)
        for m, n, density, view in ((100, 70, 0.3, False),
                                    (33, 65, 0.05, True)):
            y = t(own.standard_normal((n, 4096) if view else (4096, n)))
            extra.append(sddmm_case(
                t(own.standard_normal((m, 4096))), y.T if view else y,
                t(own.random((m, n)) < density), per_request=0))
    return list(cases.values()) + extra


def handed_epilogue(op, m, n, rng, dev) -> dict:
    """The epilogue the runtime hands the DDMM kernel with ``op``'s
    ``(m, k) @ (k, n)`` product (``matmul.kernel_epilogue``: bias, relu,
    a pre-activation residual, random where it is a runtime value), on
    ``dev``; empty where ``apply_epilogue`` runs it after the kernel."""
    from repro_torch.core.runtime.matmul import kernel_epilogue
    shape = tuple(op.out_shape) if op.out_shape else (m * n,)
    env = {}
    if op.attrs.get("fused_residual"):
        env[op.attrs["fused_residual"]] = torch.tensor(
            rng.standard_normal(shape), dtype=torch.float32)
    epi = kernel_epilogue(op, env, None, m, n, shape)
    if epi is None:
        return {}
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in epi.items()}


def ddmm_exact_checks(task, rng, dev) -> None:
    """DDMM's batch-stable plan and in-order split-K, bit for bit: a
    stacked-M product equals its per-sample products (b1's linear on the
    tensor cores and its classifier on the narrow route, stacked 4x; b6's
    classifier at M = 1 against M = 4), two calls with split-K active give
    the same bits (b2), and relu keeps a NaN row NaN (b6)."""
    from repro_torch.kernels import ddmm, ref
    from repro_torch.kernels.ddmm import launch_plan

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)

    stacked = {"b1": ((26, 800, 400, "relu"), (26, 400, 5, None)),
               "b6": ((1, 1024, 40, None),)}
    for m, k, n, act in stacked.get(task, ()):
        x, y, b = t(4 * m, k), t(k, n), t(n)
        got = ddmm(x, y, bias=b, act=act)
        each = torch.cat([ddmm(x[i * m:(i + 1) * m], y, bias=b, act=act)
                          for i in range(4)])
        torch.cuda.synchronize()
        differ = int((got != each).sum().item())
        one, four = launch_plan(m, k, n), launch_plan(4 * m, k, n)
        log(f"check ddmm stacked ({4 * m},{k})@({k},{n}) act={act} (route "
            f"{one.route}, tiles {four.bm}x{four.bn} vs {one.bm}x{one.bn}, "
            f"split {four.split} of {four.k_tiles} K stages): vs 4 "
            f"per-sample products, {differ} elements differ"
            + ("" if not differ else "  FAIL"))
        assert not differ, "ddmm: stacked M differs from per-sample calls"
    if task == "b2":
        x, y, b = t(80, 1024), t(1024, 2048), t(2048)
        plan = launch_plan(80, 1024, 2048)
        got, again = ddmm(x, y, bias=b), ddmm(x, y, bias=b)
        torch.cuda.synchronize()
        differ = int((got != again).sum().item())
        log(f"check ddmm (80,1024)@(1024,2048) split {plan.split} of "
            f"{plan.k_tiles} K stages: a second call, {differ} elements "
            f"differ" + ("" if not differ else "  FAIL"))
        assert plan.split > 1 and not differ, "ddmm: two calls differ"
    if task == "b6":
        x, y, b = t(64, 256), t(256, 1024), t(1024)
        x[3] = float("nan")
        got = ddmm(x, y, bias=b, act="relu")
        torch.cuda.synchronize()
        want = ref.ddmm_ref(x, y, bias=b, act="relu")
        nan_row = bool(torch.isnan(got[3]).all().item())
        rest = torch.cat([got[:3], got[4:]])
        _, rel = rel_err(rest, torch.cat([want[:3], want[4:]]))
        ok = nan_row and bool(torch.isfinite(rest).all().item()) \
            and rel <= KERNEL_RTOL
        log(f"check ddmm relu with a NaN row of x: the row NaN "
            f"{nan_row}, the other rows finite, rel={rel:.3e}"
            + ("" if ok else "  FAIL"))
        assert ok, "ddmm: relu does not keep NaN"


def exact_checks(task, rng, dev) -> None:
    """Kernel results beyond the main path that must hold exactly: a
    batched conv equals its per-image calls (same arithmetic order; b1's
    and b2's shapes, split-K active) and a second call of itself (no
    atomics); SDDMM's dead tiles come out as exact zeros over NaN and inf
    inputs, and its split-K result is the same on a second call and with y
    as a transposed view (vip-masked);
    DDMM's (``ddmm_exact_checks``)."""
    from repro_torch.kernels import sddmm, shift_conv2d
    from repro_torch.kernels.sddmm import live_tiles
    from repro_torch.kernels.shift_conv import launch_plan
    ddmm_exact_checks(task, rng, dev)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    conv_shapes = {
        "b1": (((26, 1, 28, 28), (3, 3, 1, 64), dict(stride=1)),
               ((26, 64, 14, 14), (3, 3, 64, 64), dict(stride=1)),
               ((5, 8, 15, 25), (3, 2, 2, 8),
                dict(stride=(2, 1), padding="VALID", groups=4,
                     dilation=(1, 2)))),
        # b2's 7x7 and 14x14 layers, batched
        "b2": (((4, 512, 7, 7), (3, 3, 512, 512), dict(stride=1)),
               ((4, 1024, 14, 14), (1, 1, 1024, 256), dict(stride=1)),
               ((3, 256, 28, 28), (3, 3, 256, 256), dict(stride=2)))}
    for xs, ws, kw in conv_shapes.get(task, ()):
        x, w = t(rng.standard_normal(xs)), t(rng.standard_normal(ws))
        got = shift_conv2d(x, w, **kw)
        again = shift_conv2d(x, w, **kw)
        each = torch.stack([shift_conv2d(xi, w, **kw) for xi in x])
        torch.cuda.synchronize()
        differ = int((got != each).sum().item())
        rerun = int((got != again).sum().item())
        plan = launch_plan(xs, ws, **kw)
        log(f"check batched shift_conv2d x{xs} w{ws} {kw} (split "
            f"{plan.split} of {plan.k_tiles} K tiles): one launch vs "
            f"{xs[0]} per-image launches, {differ} elements differ; a "
            f"second call, {rerun} differ"
            + ("" if not (differ or rerun) else "  FAIL"))
        assert not differ, "batched conv differs from per-image calls"
        assert not rerun, "two calls of the conv differ"
    if task == "vip-masked":
        # NaN in x's rows and inf in y's columns that only dead tiles read
        x, y = t(rng.standard_normal((256, 64))), t(rng.standard_normal(
            (64, 256)))
        x[160:200] = float("nan")
        y[:, 130:250] = float("inf")
        mask = torch.zeros((256, 256), device=dev)
        mask[:128, :128] = 1.0
        got = sddmm(x, y, mask)
        torch.cuda.synchronize()
        dead = torch.cat([got[128:].flatten(), got[:128, 128:].flatten()])
        nonzero = int((dead != 0).sum().item())
        log(f"check sddmm dead tiles: mask live on [:128, :128] of 256x256, "
            f"{int(live_tiles(mask).sum())}/{live_tiles(mask).numel()} tiles "
            f"live, NaN and inf only in dead bands, {nonzero} nonzero "
            f"outputs outside" + ("" if not nonzero else "  FAIL"))
        assert not nonzero, "sddmm: a dead tile is not exactly zero"
        # split-K in order: a second call and a transposed y, bit for bit
        from repro_torch.kernels.sddmm import launch_plan as sddmm_plan
        own = np.random.default_rng(18)
        x = t(own.standard_normal((100, 4096)))
        y = t(own.standard_normal((4096, 70)))
        mask = t(own.random((100, 70)) < 0.3)
        got, again = sddmm(x, y, mask), sddmm(x, y, mask)
        view = sddmm(x, y.T.contiguous().T, mask)
        torch.cuda.synchronize()
        rerun = int((got != again).sum().item())
        differ = int((got != view).sum().item())
        plan = sddmm_plan(100, 4096, 70)
        log(f"check sddmm (100,4096)@(4096,70) split {plan.split} of "
            f"{plan.k_tiles} K stages: a second call, {rerun} elements "
            f"differ; y as a transposed view, {differ} differ"
            + ("" if not (rerun or differ) else "  FAIL"))
        assert plan.split > 1 and not (rerun or differ), \
            "sddmm: two calls or two layouts of y differ"


def knn_adversarial(name: str, n: int, f: int,
                    rng) -> tuple[np.ndarray, np.ndarray | None]:
    """``(x, mask)`` for the KNN cases that stress the kernel's warp list:
    ``rising`` / ``falling`` collinear points (every candidate of the last
    or first rows beats all before it: the threshold filter's worst case,
    with a tie toward each side), ``equal`` points (every distance ties:
    pure index order), ``masked`` (all but 5 candidates masked: trailing
    +inf in index order); standard-normal points otherwise."""
    mask = None
    if name in ("rising", "falling"):
        line = np.arange(n, dtype=np.float32) * 0.5
        x = np.stack([line if name == "rising" else line[::-1]]
                     + [np.zeros(n, np.float32)] * (f - 1), 1)
    elif name == "equal":
        x = np.full((n, f), 0.25, np.float32)
    else:
        x = rng.standard_normal((n, f)).astype(np.float32)
    if name == "masked":
        mask = np.zeros(n, np.float32)
        mask[rng.choice(n, 5, replace=False)] = 1.0
    return x, mask


def pad_mask(n: int) -> np.ndarray:
    """Ones with the last ``PAD_POINTS`` set to zero (padded points)."""
    mask = np.ones(n, np.float32)
    mask[-PAD_POINTS:] = 0.0
    return mask


def conv_case(x, w, kw, per_request) -> Case:
    from repro_torch.kernels import ref, shift_conv2d
    from repro_torch.kernels.shift_conv import launch_plan
    k1, k2, cin_g, cout = w.shape
    ho, wo, pt, pb, pl, pr = ref.conv_geometry(
        x.shape[-2], x.shape[-1], k1, k2, stride=kw["stride"],
        padding=kw["padding"], dilation=kw.get("dilation", (1, 1)))
    batch = x.shape[0] if x.ndim == 4 else 1
    # the library yardstick gets the pre-padded input (set-up, untimed):
    # F.conv2d's own padding is symmetric, the reference's SAME split is not
    xp = F.pad(x, (pl, pr, pt, pb))
    xp = xp.reshape(batch, *xp.shape[-3:])
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    groups = kw.get("groups", 1)
    label = (f"shift_conv2d x{tuple(x.shape)} w{tuple(w.shape)} "
             f"stride={kw['stride']} {kw['padding']}"
             + (f" groups={groups} dilation={kw['dilation']}"
                if "dilation" in kw else ""))
    return Case(
        "shift_conv2d", label,
        lambda: shift_conv2d(x, w, **kw),
        lambda: ref.conv2d_ref(x, w, **kw),
        lambda: F.conv2d(xp, w_oihw, stride=ref.pair(kw["stride"]),
                         dilation=ref.pair(kw.get("dilation", 1)),
                         groups=groups).reshape(*x.shape[:-3], cout, ho, wo),
        4.0 * (x.numel() + w.numel() + batch * cout * ho * wo),
        2.0 * batch * k1 * k2 * cin_g * cout * ho * wo, per_request,
        rate=CONV_FLOPS, plan=launch_plan(tuple(x.shape), tuple(w.shape),
                                          **kw))


def ell_csr(idx, val, s2):
    """The ELL matrix as CSR (set-up, untimed), and its nonzeros."""
    s1, ell_l = idx.shape
    dense = torch.zeros((s1, s2), device=val.device)
    rows = torch.arange(s1, device=val.device)[:, None].expand(-1, ell_l)
    dense.index_put_((rows, idx.long()), val, accumulate=True)
    with warnings.catch_warnings():                # "CSR support is beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = dense.to_sparse_csr()
    return csr, int((val != 0).sum().item())


def spdmm_case(idx, val, x2, per_request) -> Case:
    """SpDMM as b4's ``right_t`` side calls it: ``spdmm_rows`` on the
    ``(C·T, V)`` view.  Library: ``torch.sparse.mm`` of the CSR matrix
    and ``x2ᵀ`` (it returns ``outᵀ``; the ``.T`` is a view).  Before: the
    route the runtime took before ``spdmm_rows``, the column kernel
    between two transposing copies."""
    from repro_torch.kernels import ref, spdmm, spdmm_rows
    r, s2 = x2.shape
    csr, nnz = ell_csr(idx, val, s2)
    return Case(
        "spdmm", f"spdmm_rows ell{tuple(idx.shape)} nnz={nnz} "
                 f"x2{tuple(x2.shape)}",
        lambda: spdmm_rows(idx, val, x2),
        lambda: ref.spdmm_rows_ref(idx, val, x2),
        lambda: torch.sparse.mm(csr, x2.T).T,
        4.0 * (2 * idx.numel() + x2.numel() + r * idx.shape[0]),
        2.0 * nnz * r, per_request,
        before=lambda: spdmm(idx, val, x2.T.contiguous()).T.contiguous())


def spdmm_columns_case(idx, val, y) -> Case:
    """SpDMM's column entry, the JAX signature ``(S1, L) @ (S2, N)``."""
    from repro_torch.kernels import ref, spdmm
    csr, nnz = ell_csr(idx, val, y.shape[0])
    return Case(
        "spdmm", f"spdmm ell{tuple(idx.shape)} nnz={nnz} y{tuple(y.shape)}",
        lambda: spdmm(idx, val, y), lambda: ref.spdmm_ref(idx, val, y),
        lambda: torch.sparse.mm(csr, y),
        4.0 * (2 * idx.numel() + y.numel() + idx.shape[0] * y.shape[1]),
        2.0 * nnz * y.shape[1], 0)


def sddmm_case(x, y, mask, per_request) -> Case:
    """Bound: bytes, or the sampled products at the 3xTF32 rate.  Library:
    ``torch.sparse.sampled_addmm`` of the CSR mask."""
    from repro_torch.kernels import ref, sddmm
    from repro_torch.kernels.sddmm import launch_plan, live_tiles
    m, k = x.shape
    n = y.shape[1]
    # the VIP passes y = xᵀ, a view of x's memory: x is read once
    y_is_x = y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    mask = mask.float().contiguous()
    nnz = int((mask != 0).sum().item())
    live = live_tiles(mask)
    with warnings.catch_warnings():                # "CSR support is beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = mask.to_sparse_csr()                 # set-up, untimed
    label = (f"sddmm ({m},{k})@({k},{n}) y_strides={tuple(y.stride())} "
             f"nnz={nnz} density={nnz / (m * n):.4f} live tiles "
             f"{int(live.sum())}/{live.numel()} = "
             f"{live.float().mean().item():.4f}"
             + (" y=xᵀ" if y_is_x else ""))
    # bytes: x, y (unless it is x's view), the mask and the output once
    # each; operations: the sampled products only, 2·nnz·K
    return Case(
        "sddmm", label, lambda: sddmm(x, y, mask),
        lambda: ref.sddmm_ref(x, y, mask),
        lambda: torch.sparse.sampled_addmm(csr, x, y, beta=0.0),
        4.0 * (m * k + (0 if y_is_x else k * n) + 2 * m * n),
        2.0 * nnz * k, per_request, rate=CONV_FLOPS,
        plan=launch_plan(m, k, n))


def ddmm_case(x, y, *, bias=None, residual=None, act=None, gram=False,
              per_request=0) -> Case:
    """``gram``: y is xᵀ (a VIP's x @ xᵀ), so the function reads x once.
    Library: ``torch.mm`` or ``torch.addmm`` where one call computes the
    function (no activation, no residual); ``mm``: ``torch.mm`` of the
    product alone, always.  Bound: operations at the 3xTF32 rate on the
    tensor-core route, at the fp32 SIMT rate on the narrow one."""
    from repro_torch.kernels import ddmm, ref
    from repro_torch.kernels.ddmm import launch_plan
    m, k = x.shape
    n = y.shape[1]
    library = None
    if act is None and residual is None:
        library = ((lambda: torch.mm(x, y)) if bias is None  # noqa: E731
                   else (lambda: torch.addmm(bias, x, y)))
    nbytes = 4.0 * (x.numel() + (0 if gram else y.numel()) + m * n
                    + (n if bias is not None else 0)
                    + (m * n if residual is not None else 0))
    plan = launch_plan(m, k, n)
    label = (f"ddmm ({m},{k})@({k},{n}) y_strides={tuple(y.stride())} "
             f"bias={bias is not None} act={act} "
             f"residual={residual is not None}"
             + (" y=xᵀ" if gram else ""))
    return Case(
        "ddmm", label,
        lambda: ddmm(x, y, bias=bias, residual=residual, act=act),
        lambda: ref.ddmm_ref(x, y, bias=bias, residual=residual, act=act),
        library, nbytes, 2.0 * m * k * n, per_request,
        rate=CONV_FLOPS if plan.route == "mma" else FP32_FLOPS, plan=plan,
        mm=lambda: torch.mm(x, y), args=(x, y, bias, residual, act))


def knn_case(x, k, *, mask, self_loops, per_request, note="") -> Case:
    """``note``: the name of the input's kind (``knn_adversarial``)."""
    from repro_torch.kernels import knn, ref
    n, f = x.shape
    kw = dict(mask=mask, self_loops=self_loops)
    label = (f"knn x{tuple(x.shape)} k={k} masked={mask is not None} "
             f"self_loops={self_loops}" + (f" ({note})" if note else ""))
    # bytes: points, mask, indices; operations: the 2·N²·F of the dot
    # products plus 3·N² to form each distance and compare it
    return Case(
        "knn", label, lambda: knn(x, k, **kw),
        lambda: ref.knn_ref(x, k, **kw), None,
        4.0 * (n * f + (n if mask is not None else 0) + n * k),
        2.0 * n * n * f + 3.0 * n * n, per_request, exact=True)


def check_case(case: Case) -> float:
    """Run the kernel and its plain version once; raise on disagreement.
    Returns max |kernel - plain|."""
    got, want = case.run(), case.plain()
    torch.cuda.synchronize()
    assert got.shape == want.shape, (case.label, got.shape, want.shape)
    if case.exact:
        bad = (got != want).any(1).nonzero().flatten().tolist()
        log(f"check {case.label}: {len(bad)} rows differ"
            + ("" if not bad else "  FAIL"))
        for row in bad[:8]:
            log(f"  row {row}: kernel {got[row].tolist()}")
            log(f"  row {row}: plain  {want[row].tolist()}")
        assert not bad, f"{case.label}: kernel indices differ"
        return 0.0
    assert torch.isfinite(got).all(), case.label
    got, want = got.float(), want.float()
    err, rel = rel_err(got, want)
    ok = rel <= case.rtol
    msg = f"check {case.label}: max|d|={err:.3e} rel={rel:.3e}"
    if case.library is not None:
        lib = case.library()
        _, lrel = rel_err((lib if lib.layout == torch.strided
                           else lib.to_dense()).float(), want)
        msg += f" (library rel={lrel:.3e})"
    log(msg + ("" if ok else "  FAIL"))
    assert ok, f"{case.label}: kernel disagrees with its plain version"
    return err


MARKER = "spin_kernel"      # torch.cuda._sleep's kernel: a window's bounds
WINDOW_GAP_S = 0.02         # host pause inside each end of a scheduled window


def device_events(fn, n: int, warm=None) -> list:
    """The device kernels of ``n`` calls of ``fn`` under ``torch.profiler``.
    ``warm``: called first, in the profiler's warm-up step, whose events
    are dropped (a window that opens on a graph replay has lost its first
    few device events).

    The profiler places device events in its window by the host's clock,
    which does not agree with the card's to the kernel: a window can keep
    the last kernels of the warm-up step and drop its own first or last
    ones.  So a scheduled window is bracketed on the card by two
    ``MARKER`` kernels, each ``WINDOW_GAP_S`` on the host's clock inside
    the window, and only the events between them on the card's own
    timeline count (none if either marker was lost).  An event the
    profiler reports twice counts once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    steps = None if warm is None else schedule(wait=0, warmup=1, active=1,
                                               repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=steps) as prof:
        if warm is not None:
            warm()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(WINDOW_GAP_S)
            torch.cuda._sleep(1000)
        for _ in range(n):
            fn()
        if warm is not None:
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if warm is not None:
            time.sleep(WINDOW_GAP_S)
            prof.step()
    # a scheduled profile also puts each step's span on the device's
    # timeline ("ProfilerStep#n"), which no kernel is
    events, seen = [], set()
    for e in prof.events():
        key = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA and key not in seen \
                and not e.name.startswith("ProfilerStep"):
            seen.add(key)
            events.append(e)
    if warm is None:
        return events
    marks = sorted(e.time_range.start for e in events
                   if kernel_base(e.name) == MARKER)
    if len(marks) != 2:
        return []
    return [e for e in events if kernel_base(e.name) != MARKER
            and marks[0] < e.time_range.start < marks[1]]


def kernel_base(name: str) -> str:
    """A profiled kernel's bare function name: ``void (anonymous
    namespace)::shift_conv_tf32x3_kernel<64, false>(...)`` ->
    ``shift_conv_tf32x3_kernel``."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return head.split("<", 1)[0].split()[-1].split("::")[-1]


def device_ms(fn, prefix: str | tuple[str, ...], n: int = 20,
              tries: int = 3) -> float | None:
    """Mean device time of the kernels whose bare name starts with
    ``prefix`` (or one of them), per call of ``fn``, over ``n`` profiled
    calls.  A profile
    now and then records no device kernel at all; it is taken again, up to
    ``tries`` times (None if none recorded one)."""
    fn()
    for _ in range(tries):
        events = [e for e in device_events(fn, n)
                  if kernel_base(e.name).startswith(prefix)]
        if events:
            return sum(e.time_range.end - e.time_range.start
                       for e in events) / n / 1e3
    return None


def device_breakdown(fn, n: int = 10, tries: int = 3) -> dict[str, float]:
    """Mean device time of one call of ``fn`` by kernel (bare name), in
    ms, over ``n`` calls profiled in a window bracketed on the card
    (``device_events`` with ``warm=fn``), taken again up to ``tries``
    times where a marker was lost; empty if none kept both."""
    fn()
    for _ in range(tries):
        events = device_events(fn, n, warm=fn)
        if events:
            break
    out: dict[str, float] = {}
    for e in events:
        name = kernel_base(e.name)
        out[name] = out.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / n / 1e3
    return out


def profile_requests(run, requests, card, task) -> None:
    """Device time by kernel name over the requests (``torch.profiler``),
    and the share of the profiled window in which no kernel ran."""
    it = iter(requests)
    profile_window(lambda: run(**next(it)), len(requests),
                   f"{task} requests", "request", card)


def profile_window(fn, n: int, what: str, per: str, card: str,
                   warm=None) -> list:
    """Profile ``n`` calls of ``fn`` (after ``warm``, as in
    ``device_events``): device kernels and busy time per call, the idle
    share of the device window, the largest kernels.  Returns the device
    events (empty where none was recorded)."""
    kernels = device_events(fn, n, warm)
    if not kernels:
        log(f"profile of {what}: no device events recorded (device "
            "breakdown not measured)")
        return []
    busy, window = device_busy(kernels)
    compute = [e for e in kernels if not is_copy(e)]
    log(f"profile over {n} {what} (under the profiler): "
        f"{len(kernels) / n:.1f} device kernels/{per}, device busy "
        f"{busy / n / 1e3:.4f} ms/{per}"
        + (f" ({device_busy(compute)[0] / n / 1e3:.4f} ms without its "
           f"copies)" if compute and len(compute) < len(kernels) else "")
        + f", idle share of the device window {1 - busy / window:.3f}  "
        f"[{card}]")
    by_name: dict[str, list] = {}
    for e in kernels:
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.end - e.time_range.start
        tot[1] += 1
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"  {us / n / 1e3:.4f} ms/{per}  {count // n:3d}x  "
            f"{name[:90]}")
    return kernels


def is_copy(event) -> bool:
    """A profiled copy or fill (``Memcpy HtoD ...``, ``Memset ...``): the
    card's copy engines, not a kernel."""
    return event.name.startswith(("Memcpy", "Memset"))


def device_busy(kernels) -> tuple[float, float]:
    """-> (the time some kernel of ``kernels`` ran, the window from the
    first kernel's start to the last one's end), in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def window_mask(side: int, win: int) -> np.ndarray:
    """0/1 ``(side², side²)`` mask joining each cell of a ``side x side``
    grid to the cells of its ``win x win`` window (clipped at the edges)."""
    r, c = np.divmod(np.arange(side * side), side)
    h = win // 2
    near = ((np.abs(r[:, None] - r[None, :]) <= h)
            & (np.abs(c[:, None] - c[None, :]) <= h))
    return near.astype(np.float32)


def vip_masked_graph(builder, side=VIP_SIDE, feat=VIP_FEAT, win=VIP_WIN):
    """The masked VIP path: ``vip(mask=M)`` -> ``softmax(mask=M)`` -> MP
    over that runtime affinity, on ``side²`` nodes of ``feat`` features,
    M = ``window_mask(side, win)`` (defaults: b3-r50's spatial branch).
    ``builder`` is a ``GraphBuilder`` class: the port's here, either
    package's in the tests, which share this one definition."""
    mask = window_mask(side, win)
    b = builder("vip_masked")
    x = b.input((side * side, feat), name="nodes")
    aff = b.vip(x, mask=mask, name="aff")
    aff = b.softmax(aff, axis=-1, mask=mask, name="aff_sm")
    return b.output(b.mp(x, adj_input=aff, name="agg"))


def task_graph(task):
    """The task's layer graph at full width (random weights from seed 0)."""
    from repro_torch.core.ir import GraphBuilder
    from repro_torch.gnncv.tasks import build_dynamic_task, build_task
    if task == "vip-masked":
        return vip_masked_graph(GraphBuilder)
    return (build_dynamic_task if task == "b6-dyn" else build_task)(task)


def task_plans(task):
    """-> (plan with the CUDA kernels bound, the same plan bound to the
    plain versions)."""
    from repro_torch.core import CompileOptions, compile_graph
    return tuple(compile_graph(task_graph(task), CompileOptions(kernels=mode))
                 for mode in ("cuda", "torch"))


def task_requests(task, plan, plan_torch) -> list[dict]:
    """``REQUESTS`` requests from seeds 0..REQUESTS-1.  b6-dyn: standard
    normal points and the padding mask; b3 and vip-masked: the plan's
    random inputs, scaled (``request_scale``); the others: the plan's
    random inputs."""
    from repro_torch.core.executor import random_inputs
    if task != "b6-dyn":
        reqs = [random_inputs(plan, seed=s) for s in range(REQUESTS)]
        if task in SCALED_TASKS:
            scale = np.float32(request_scale(task, plan, plan_torch,
                                             reqs))
            reqs = [{k: v * scale for k, v in r.items()} for r in reqs]
        return reqs
    n, f = plan.meta["input_shapes"]["points"]
    return [dict(points=np.random.default_rng(s).standard_normal(
        (n, f)).astype(np.float32), mask=pad_mask(n))
        for s in range(REQUESTS)]


def request_scale(task, plan, plan_torch, reqs) -> float:
    """The power of two s that brings the largest VIP affinity over
    ``reqs`` to at most ``AFFINITY_PEAK``.  Also prints what unscaled
    requests show: the cuda plan against the torch plan, and, for the
    request where they differ most, the torch plan on the card against
    the same plan on the CPU."""
    from repro_torch.core import build_runner
    vips = [op.name for op in plan_torch.ops if op.kind == "sddmm"]
    probe = build_runner(dataclasses.replace(plan_torch, outputs=vips),
                         free_dead=False, jit=False)
    peak = max(a.abs().max().item() for r in reqs for a in probe(**r))
    scale = 2.0 ** math.floor(0.5 * math.log2(AFFINITY_PEAK / peak))
    run_cuda = build_runner(plan, jit=False)
    run_torch = build_runner(plan_torch, jit=False)
    rels = [rel_err(run_cuda(**r)[0], run_torch(**r)[0])[1] for r in reqs]
    worst = int(np.argmax(rels))
    cpu = build_runner(plan_torch, device="cpu")(**reqs[worst])[0]
    _, rel_cpu = rel_err(run_torch(**reqs[worst])[0].cpu(), cpu)
    log(f"{task}: standard-normal requests give max|affinity| {peak:.3e} "
        f"({', '.join(vips)}); unscaled, cuda vs torch plan rel up to "
        f"{rels[worst]:.3e} (request {worst}), where the torch plan on the "
        f"card vs on the CPU gives rel={rel_cpu:.3e}; requests scaled by "
        f"2^{math.log2(scale):.0f}")
    return scale


def serve(task, plan, plan_torch, requests, kernels,
          per_request=None) -> dict[str, int]:
    """Drive one task's main path: every launch count set to 0 just
    before, read just after.  Checks counts (``per_request``, default
    ``PER_REQUEST[task]``) and outputs; returns the counts."""
    from repro_torch.core import build_runner
    per_req = dict.fromkeys(kernels, 0)
    expected = {**per_req, **(per_request or PER_REQUEST[task])}
    for op in plan.ops:
        if op.kernel == "cuda_ddmm":
            per_req["shift_conv2d" if op.kind == "conv" else "ddmm"] += 1
        elif op.kernel == "cuda_ell_spdmm":
            per_req["spdmm"] += 1
        elif op.kernel == "cuda_knn":
            per_req["knn"] += 1
        elif op.kernel == "cuda_sddmm":     # unmasked: DDMM on x @ xᵀ
            per_req["sddmm" if "mask" in op.weights else "ddmm"] += 1
    assert per_req == expected, (task, per_req)
    run_cuda = build_runner(plan, jit=False)
    run_torch = build_runner(plan_torch, jit=False)
    for fn in kernels.values():
        fn.launches = 0
    outs = []
    for s, req in enumerate(requests):
        before = {name: fn.launches for name, fn in kernels.items()}
        outs.append(run_cuda(**req)[0])
        step = {name: fn.launches - before[name]
                for name, fn in kernels.items()}
        assert step == per_req, (task, s, step)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"{task}: launches over {len(requests)} requests: {launches}")
    for name, n in launches.items():
        assert n == per_req[name] * len(requests), (task, name, n)
    n_out = plan.ops[-1].out_shape
    for s, (req, out) in enumerate(zip(requests, outs)):
        assert tuple(out.shape) == tuple(n_out), (task, out.shape)
        assert torch.isfinite(out).all(), f"{task} request {s}: non-finite"
        err, rel = rel_err(out, run_torch(**req)[0])
        log(f"{task} request {s}: cuda vs torch plan max|d|={err:.3e} "
            f"rel={rel:.3e}")
        assert rel <= E2E_RTOL, f"{task} request {s}: disagrees with the " \
            "torch plan"
    cpu_out = build_runner(plan_torch, device="cpu")(**requests[0])[0]
    err, rel = rel_err(outs[0].cpu(), cpu_out)
    log(f"{task} request 0: cuda vs CPU plain versions max|d|={err:.3e} "
        f"rel={rel:.3e}")
    assert rel <= E2E_RTOL, f"{task} request 0 disagrees with the CPU run"
    return launches


def request_times(task, plan, plan_torch, requests, card) -> None:
    """Request latency of both plans, eager, in turns, on the host
    clock."""
    from repro_torch.core import build_runner
    run_cuda = build_runner(plan, jit=False)
    run_torch = build_runner(plan_torch, jit=False)

    def request_ms(run):
        t_req = []
        for req in requests:
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            run(**req)
            torch.cuda.synchronize()
            t_req.append((time.perf_counter() - t_a) * 1e3)
        return t_req

    request_ms(run_cuda)
    request_ms(run_torch)                              # warm both
    t_cuda, t_torch = [], []
    for turn in range(5):                              # cuda/torch in turns
        order = (run_cuda, run_torch) if turn % 2 == 0 else \
            (run_torch, run_cuda)
        for run in order:
            (t_cuda if run is run_cuda else t_torch).extend(request_ms(run))
    for name, samples in (("cuda", t_cuda), ("torch", t_torch)):
        q1, med, q3 = statistics.quantiles(samples, n=4)
        log(f"{task} request, {name} plan (host clock, synchronized, "
            f"{len(samples)} requests): p50 {med:.4f} ms, p25 {q1:.4f} ms, "
            f"p75 {q3:.4f} ms  [{card}]")
    profile_requests(run_cuda, requests, card, task)


def graph_phase(task, requests, kernels, card, model=None,
                per_request=None, batch: int | None = GRAPH_BATCH,
                turns: int = GRAPH_TURNS) -> None:
    """The task through the public entry point, ``gcv.compile(graph,
    kernels="cuda")`` (or ``model``, compiled by the caller and not warmed
    up yet, with ``per_request`` its launches per request): ``warmup()``
    captures batch 1 and ``batch`` (the launches the wrappers record at
    capture must be ``PER_REQUEST``, and at ``batch`` those of one eager
    batched request), the graph runner must equal the eager runner bit for
    bit on every request, both batched runners each sample's batch-1
    output, and the runner cache may not miss after the runners are
    built.  ``batch=None``: batch 1 alone.  ``turns``: the turns of the
    request times (``graph_times``).  Every launch count set to 0 just
    before, read just after."""
    from repro_torch import gcv
    from repro_torch.core.executor import stack_inputs
    from repro_torch.core.runtime.cache import cache_stats
    if model is None:
        model = gcv.compile(task_graph(task), kernels="cuda")
    per_request = per_request or PER_REQUEST[task]
    want = {**dict.fromkeys(kernels, 0), **per_request}

    def captured(batch) -> dict[str, int]:
        """The launches each wrapper records into the graph that
        ``warmup`` captures for ``batch`` (None: the ``run()`` runner)."""
        for fn in kernels.values():
            fn.captured = 0
        assert model.warmup(None if batch is None else [batch]) == {batch}
        return {name: fn.captured for name, fn in kernels.items()}

    one = captured(None)
    many = captured(batch) if batch else None
    log(f"{task} graphs: launches recorded at capture, batch 1: {one}"
        + (f"; batch {batch}: {many}" if batch else ""))
    assert one == want, (task, one)
    graph1, eager1 = model.runner(), model.runner(jit=False)
    pair_b, batches = None, []
    if batch:
        pair_b = (model.batched(batch), model.batched(batch, jit=True))
        assert pair_b[1].jit and not pair_b[0].jit
    assert graph1.jit and not eager1.jit
    misses = cache_stats()["runner_misses"]
    if batch:
        batches = [stack_inputs(requests[i:i + batch])
                   for i in range(0, len(requests), batch)]
        for fn in kernels.values():
            fn.launches = 0
        pair_b[0](**batches[0])
        walked = {name: fn.launches for name, fn in kernels.items()}
        assert many == walked, (task, many, walked)
    singles = [eager1(**req) for req in requests]
    for s, req in enumerate(requests):
        for g, e in zip(graph1(**req), singles[s]):
            assert torch.equal(g, e), f"{task} request {s}: graph != eager"
    for name, run in zip(("eager", "graph"), pair_b or ()):
        for b, stacked in enumerate(batches):
            for j, out in enumerate(run(**stacked)):
                for i in range(batch):
                    assert torch.equal(
                        out[i], singles[b * batch + i][j]), \
                        f"{task} {name} batch {b} sample {i} != batch 1"
    torch.cuda.synchronize()
    log(f"{task}: graph == eager bit for bit on {len(requests)} requests"
        + (f"; batch {batch} (eager and graph) == batch 1 bit for bit on "
           f"{len(batches) * batch} samples" if batch else ""))
    graph_times(task, (eager1, graph1), pair_b, requests, batches, card,
                per_request, turns)
    assert cache_stats()["runner_misses"] == misses, \
        f"{task}: the runner cache missed after warmup"
    assert graph1.trace_count() == 1 and (
        not batch or pair_b[1].trace_count() == 1), \
        f"{task}: a graph was captured again under traffic"


def graph_times(task, ones, batched, requests, batches, card,
                per_request, turns: int = GRAPH_TURNS) -> None:
    """Request latency of the eager and the graph runner in ``turns`` turns
    (host clock), samples/s of the two batched runners in turns (where
    ``batched`` is given), and the graph replays under the profiler (the
    main kernels per replay must be ``per_request``)."""
    def request_ms(run):
        t_req = []
        for req in requests:
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            run(**req)
            torch.cuda.synchronize()
            t_req.append((time.perf_counter() - t_a) * 1e3)
        return t_req

    def samples_per_s(run):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        for stacked in batches:
            run(**stacked)
        torch.cuda.synchronize()
        return [len(batches) * GRAPH_BATCH / (time.perf_counter() - t_a)]

    def in_turns(measure, pair, turns):
        out = ([], [])
        for turn in range(turns):
            for k in ((0, 1) if turn % 2 == 0 else (1, 0)):
                out[k].extend(measure(pair[k]))
        return out

    for name, samples in zip(("eager", "graph"),
                             in_turns(request_ms, ones, turns)):
        q1, med, q3 = statistics.quantiles(samples, n=4)
        log(f"{task} request, {name} runner, batch 1 (host clock, "
            f"synchronized, {len(samples)} requests): p50 {med:.4f} ms, "
            f"p25 {q1:.4f} ms, p75 {q3:.4f} ms  [{card}]")
    replay = ones[1].aot_compile()          # the request's graph itself
    t_rep = []
    for _ in range(turns * len(requests)):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        replay.replay()
        torch.cuda.synchronize()
        t_rep.append((time.perf_counter() - t_a) * 1e3)
    q1, med, q3 = statistics.quantiles(t_rep, n=4)
    log(f"{task} graph replay alone, batch 1 (no input or output copy; "
        f"host clock, synchronized, {len(t_rep)} replays): p50 {med:.4f} "
        f"ms, p25 {q1:.4f} ms, p75 {q3:.4f} ms  [{card}]")
    for name, samples in zip(("eager", "graph"),
                             in_turns(samples_per_s, batched, BATCH_TURNS)
                             if batched else ()):
        q1, med, q3 = statistics.quantiles(samples, n=4)
        log(f"{task} batch {GRAPH_BATCH}, {name} runner: {med:.1f} "
            f"samples/s (median of {len(samples)} runs of {len(batches)} "
            f"batches; p25 {q1:.1f}, p75 {q3:.1f})  [{card}]")
    it = itertools.cycle(requests)
    events = profile_window(lambda: ones[1](**next(it)), len(requests),
                            f"{task} graph replays", "request", card,
                            warm=lambda: ones[1](**next(it)))
    if batched:
        it_b = itertools.cycle(batches)
        profile_window(lambda: batched[1](**next(it_b)), len(batches),
                       f"{task} batch-{GRAPH_BATCH} graph replays", "batch",
                       card, warm=lambda: batched[1](**next(it_b)))
    # The windows above are opened by a warm-up replay and bracketed by two
    # marker kernels on the card (``device_events``): one that opens on a
    # replay loses its first kernels.  A profile still now and then records
    # only some of a graph's device events, or none: a count that falls
    # short of the want (and never over it) is profiled again, up to two
    # more times, and every count is printed.
    want = {name: per_request[name] for name in MAIN_KERNELS}
    for attempt in range(3):
        if attempt:
            events = device_events(lambda: ones[1](**next(it)),
                                   len(requests),
                                   warm=lambda: ones[1](**next(it)))
        per_replay = {name: sum(kernel_base(e.name) in bases
                                for e in events) / len(requests)
                      for name, bases in MAIN_KERNELS.items()}
        log(f"{task}: main kernels per graph replay (profiler, profile "
            f"{attempt + 1}): {per_replay}")
        if per_replay == want:
            return
        assert all(per_replay[k] <= want[k] for k in want), \
            (task, per_replay, want)
    raise AssertionError((task, per_replay, want))


def frontend_phase(kernels, plans, requests, card) -> dict:
    """The tracing frontend on the card: every traced task
    (``torch_tasks.TRACED_TASKS`` at its published defaults) through
    ``gcv.compile(fn, example_inputs)`` with its defaults (the card,
    ``kernels="cuda"``).  b1-b6, b3-r101 and b6-dyn: the traced plan must
    equal the builder plan up to names (``differences_up_to_names``), and
    after ``warmup()`` its graph replays the builder plan's eager outputs
    bit for bit on the main path's requests (b3's scaled).  b7 and b7-dyn,
    which exist only traced: ``traced_path``.  Then ``traced_serving``.
    Returns ``{task: (launches, cases, max_err)}`` of b7 and b7-dyn."""
    from repro_torch import gcv
    from repro_torch.core import build_runner
    from repro_torch.core.plan import differences_up_to_names
    from repro_torch.gnncv.torch_tasks import TRACED_TASKS
    pairs = {}
    for task, make in TRACED_TASKS.items():
        fn, example = make()
        pairs[task] = (fn, example)
        t_a = time.perf_counter()
        model = gcv.compile(fn, example, name=f"{task}_traced")
        took = time.perf_counter() - t_a
        assert model.device.type == "cuda" and \
            model.plan.meta["frontend"] == "tracer" and \
            model.plan.meta["kernels_mode"] == "cuda", task
        log(f"{task} traced: trace + compile {took:.2f} s on the host, "
            f"{len(model.plan.ops)} ops, {model.plan.kernel_counts()}")
        if task in TRACED_PER_REQUEST:
            pairs[task] += (model,)
            continue
        builder = plans[task][0]
        diffs = differences_up_to_names(model.plan, builder, portions=False)
        assert not diffs, (task, diffs[:5])
        model.warmup()
        eager = build_runner(builder, jit=False)
        for s, req in enumerate(requests[task]):
            for got, want in zip(model.run(**req), eager(**req)):
                assert torch.equal(got, want), \
                    f"{task} request {s}: traced != builder"
        torch.cuda.synchronize()
        log(f"{task}: traced plan == builder plan up to names; its graph "
            f"== the builder plan's eager run bit for bit on "
            f"{len(requests[task])} requests")
    out = {task: traced_path(task, pairs[task][2], kernels, card)
           for task in TRACED_PER_REQUEST}
    traced_serving(pairs, kernels, card)
    return out


def traced_path(task, model, kernels, card):
    """One traced-only path at full width: the KNN checks (b7-dyn), the
    eager requests through the kernels with every launch count set to 0
    just before and read just after, held to the plain plan on the card
    within ``E2E_RTOL`` (``serve``), ``graph_phase`` (graph == eager, batch
    ``GRAPH_BATCH`` == batch 1, bit for bit, request p50s, device time per
    request), eager request times and every kernel call against its plain
    version.  -> (launches, cases, max_err)."""
    from repro_torch.core import CompileOptions, compile_graph
    from repro_torch.core.executor import random_inputs
    plan = model.plan
    plan_torch = compile_graph(model.graph, CompileOptions(kernels="torch"))
    reqs = [random_inputs(plan, seed=s) for s in range(REQUESTS)]
    if task == "b7-dyn":
        knn_paths(plan, plan_torch, reqs)
    per_request = TRACED_PER_REQUEST[task]
    launches = serve(task, plan, plan_torch, reqs, kernels, per_request)
    graph_phase(task, reqs, kernels, card, model=model,
                per_request=per_request)
    request_times(task, plan, plan_torch, reqs, card)
    cases = task_cases(task, plan, np.random.default_rng(7),
                       torch.device("cuda"))
    max_err = dict.fromkeys(kernels, 0.0)
    for case in cases:
        max_err[case.kernel] = max(max_err[case.kernel], check_case(case))
    return launches, cases, max_err


def knn_paths(plan, plan_torch, reqs) -> None:
    """b7-dyn's graph: the KNN kernel's indices must equal ``knn_ref`` on
    the same patch embeddings exactly; where the kernel plan and the plain
    plan (whose embeddings differ by the convs' rounding) pick different
    neighbours, the rows and the distance gap at the k-th place are
    printed; the traced model must equal its ``precomputed_graph`` twin,
    fed the kernel's own indices, bit for bit (``TWIN_REQUESTS``)."""
    from repro_torch import gcv
    from repro_torch.core import build_runner
    from repro_torch.gnncv.torch_tasks import TRACED_TASKS
    from repro_torch.kernels.ref import knn_ref
    op = next(o for o in plan.ops if o.kind == "knn_graph")
    k = op.attrs["k"]

    def probe(p):
        return build_runner(dataclasses.replace(
            p, outputs=[op.inputs[0], op.name]), free_dead=False, jit=False)
    run_k, run_p = probe(plan), probe(plan_torch)
    parted = 0
    for s, req in enumerate(reqs):
        h, idx = run_k(**req)
        want = knn_ref(h, k)
        bad = (idx != want).any(1).nonzero().flatten().tolist()
        assert not bad, f"b7-dyn request {s}: KNN rows {bad[:8]} != knn_ref"
        hp, idxp = run_p(**req)
        rows = (idx != idxp).any(1).nonzero().flatten().tolist()
        parted += len(rows)
        for r in rows[:4]:
            d = ((hp[r] - hp) ** 2).sum(1)
            kth = d[idxp[r].long()].max().item()
            gap = min(abs(d[int(j)].item() - kth) for j in
                      set(idx[r].tolist()) ^ set(idxp[r].tolist()))
            log(f"b7-dyn request {s} row {r}: kernel plan {idx[r].tolist()}"
                f", plain plan {idxp[r].tolist()}, distance gap at the "
                f"k-th place {gap:.3e} of {kth:.3e}")
    log(f"b7-dyn: KNN kernel indices == knn_ref on the same embeddings in "
        f"every row of {len(reqs)} requests; kernel and plain plans pick "
        f"different neighbours in {parted} rows")
    eager = build_runner(plan, jit=False)
    for s, req in enumerate(reqs[:TWIN_REQUESTS]):
        _, idx = run_k(**req)
        fn, example = TRACED_TASKS["b7-dyn"](
            precomputed_graph=idx.cpu().numpy())
        twin = gcv.compile(fn, example, name="b7-dyn_precomputed")
        assert "knn_graph" not in [o.kind for o in twin.plan.ops]
        assert torch.equal(eager(**req)[0], build_runner(
            twin.plan, jit=False)(**req)[0]), \
            f"b7-dyn request {s} != its precomputed twin"
    log(f"b7-dyn == its precomputed-graph twin (the kernel's indices "
        f"baked in as a COO) bit for bit on {TWIN_REQUESTS} requests")


def traced_serving(pairs, kernels, card) -> None:
    """b7 and b7-dyn as ``(fn, example)`` pairs and b6-dyn's graph
    buckets from a traced factory, through one ``gcv.serve`` engine
    (``max_batch=SERVE_MAX_BATCH``): each (task, bucket) capture must
    record its bucket's eager batched launches (``warm_each``), a batch
    must launch nothing from the host, and every served request must equal
    its batch-1 run bit for bit."""
    from repro_torch import gcv
    from repro_torch.core.executor import random_inputs
    from repro_torch.gnncv.torch_tasks import TRACED_TASKS
    eng = gcv.serve(
        {"b7": pairs["b7"][:2], "b7-dyn": pairs["b7-dyn"][:2],
         "b6-dyn": lambda n: TRACED_TASKS["b6-dyn"](n_points=n)},
        graph_buckets={"b6-dyn": list(DYN_BUCKETS)},
        max_batch=SERVE_MAX_BATCH)
    rng = np.random.default_rng(2)

    def cloud(n: int) -> dict:
        return dict(points=rng.standard_normal((n, 3)).astype(np.float32),
                    mask=np.ones(n, np.float32))
    reqs = {t: [random_inputs(eng.models[t].plan, seed=100 + s)
                for s in range(REQUESTS)] for t in ("b7", "b7-dyn")}
    want = {(t, b): eager_bucket_launches(kernels, eng.models[t],
                                          reqs[t][:b])
            for t in eng.models if not t.startswith("b6-dyn")
            for b in eng.buckets()}
    want.update({(f"b6-dyn@g{g}", b): eager_bucket_launches(
        kernels, eng.models[f"b6-dyn@g{g}"], [cloud(g)] * b)
        for g in DYN_BUCKETS for b in eng.buckets()})
    warm_each(eng, want, kernels, "traced serving")
    for name in GNNCV_KERNELS:
        kernels[name].launches = 0
    sizes = rng.integers(DYN_POINTS[0], DYN_POINTS[1] + 1, DYN_REQUESTS)
    served = [eng.submit(t, **r) for t in ("b7", "b7-dyn") for r in reqs[t]]
    served += [eng.submit("b6-dyn", **cloud(int(n))) for n in sizes]
    assert eng.run() == len(served)
    torch.cuda.synchronize()
    host = {name: kernels[name].launches for name in GNNCV_KERNELS}
    assert not any(host.values()), f"traced serving launched {host}"
    for r in served:
        assert r.done and r.result is not None, r.task
        for got, w in zip(r.result, eng.models[r.task].run(**r.inputs)):
            assert np.isfinite(got).all() and np.array_equal(
                got, w.cpu().numpy()), f"served {r.task} != its batch-1 run"
    log(f"traced serving: {len(served)} requests (b7 and b7-dyn x "
        f"{REQUESTS}, b6-dyn x {DYN_REQUESTS} over graph buckets "
        f"{list(DYN_BUCKETS)}) served in buckets {eng.buckets()}, each == "
        f"its batch-1 run bit for bit; no launch from the host; "
        f"{eng.stats()['graph_buckets']}  [{card}]")


def lattice_phase(task, graph, requests, cache_path, card) -> dict:
    """Step 4b on the card: ``gcv.compile(graph, kernels="auto")`` (the
    H100 model), which ops bind a twin, the ``auto`` plan's outputs on the
    requests against the ``cuda`` plan's (``E2E_RTOL``), the
    predicted-vs-measured report (``profile_report``, its agreement rate
    printed; every op whose rivals differ by more than ``AGREE_GAP``, by
    the median within-measurement ratio over ``AGREE_MEASUREMENTS``
    measurements (``rank_ops``), must be ranked right by the model), then ``kernels="measured"`` compiled twice into
    ``cache_path``: the second compile, from the warm cache, measures
    nothing.  Returns the report's agreement block."""
    from repro_torch import gcv
    from repro_torch.core import CompileOptions, compile_graph
    auto = gcv.compile(graph, kernels="auto")
    cuda = gcv.compile(graph, kernels="cuda")
    choices = auto.plan.meta["kernel_choices"]
    assert auto.plan.meta["kernels_backend"] == "cuda"
    twins = [f"{name}:{c['kernel']}" for name, c in choices.items()
             if len(c["candidates"]) > 1 and c["kernel"].startswith("torch_")]
    multi = sum(len(c["candidates"]) > 1 for c in choices.values())
    log(f"{task} lattice: kernels='auto' binds a twin on {len(twins)} of "
        f"{multi} multi-candidate ops: {', '.join(twins) or '-'}; counts "
        f"{auto.plan.kernel_counts()}")
    run_auto, run_cuda = auto.runner(jit=False), cuda.runner(jit=False)
    worst = 0.0
    for s, req in enumerate(requests):
        for a, c in zip(run_auto(**req), run_cuda(**req)):
            assert torch.isfinite(a).all(), f"{task} auto request {s}"
            worst = max(worst, rel_err(a, c)[1])
    log(f"{task} lattice: auto vs cuda plan over {len(requests)} requests: "
        f"rel up to {worst:.3e}")
    assert worst <= E2E_RTOL, f"{task}: the auto plan disagrees"
    report = auto.profile_report(inputs=requests[0])
    verdicts = rank_ops(task, auto.plan, report)
    ag = report["agreement"]
    assert ag["considered"], f"{task}: no op with two measured candidates"
    log(f"{task} lattice: agreement.rate {ag['rate']:.3f} "
        f"({ag['agree']}/{ag['considered']}); over rivals more than "
        f"{AGREE_GAP:.0%} apart (median ratio within a measurement, of "
        f"{AGREE_MEASUREMENTS}): "
        f"{verdicts['agree']} ranked right, {verdicts['tie']} ties  [{card}]")
    cuda_prof = cuda.profile(inputs=requests[0])
    for name, rows in (("auto", report["rows"]),
                       ("cuda", [dict(predicted_s=r["predicted_s"],
                                      measured_s=r["s"])
                                 for r in cuda_prof.values()])):
        log(f"{task} lattice: {name} plan over its {len(rows)} ops: "
            f"predicted {sum(r['predicted_s'] for r in rows) * 1e3:.4f} "
            f"ms (the sum of its bound kernels' predictions), measured "
            f"{sum(r['measured_s'] for r in rows) * 1e3:.4f} ms (op by "
            f"op, a synchronize between ops, best of 3)  [{card}]")
    opts = CompileOptions(kernels="measured", autotune_cache=str(cache_path))
    t_a = time.perf_counter()
    cold = compile_graph(graph, opts, backend="cuda")
    t_b = time.perf_counter()
    warm = compile_graph(graph, opts, backend="cuda")
    t_c = time.perf_counter()
    at_cold, at_warm = cold.meta["autotune"], warm.meta["autotune"]
    differ = [name for name, c in cold.meta["kernel_choices"].items()
              if c["kernel"] != choices[name]["kernel"]]
    log(f"{task} lattice: kernels='measured' first compile {t_b - t_a:.2f} "
        f"s ({at_cold['measured_signatures']} signatures measured, "
        f"{at_cold['cache_hits']} found in the cache the paths share), warm "
        f"{t_c - t_b:.2f} s ({at_warm['measured_signatures']} measured, "
        f"{at_warm['cache_hits']} hits); binds other than auto on "
        f"{len(differ)} ops: {', '.join(differ) or '-'}")
    assert at_warm["measured_signatures"] == 0, \
        f"{task}: the warm autotune cache measured again"
    assert {n: c["kernel"] for n, c in warm.meta["kernel_choices"].items()} \
        == {n: c["kernel"] for n, c in cold.meta["kernel_choices"].items()}
    return ag


def rank_ops(what: str, plan, report, *,
             strict: bool = True) -> dict[str, int]:
    """The H100 model's ranking of every op of ``report`` (a
    ``profile_report``) with two measured candidates, over
    ``AGREE_MEASUREMENTS`` measurements (the report's and fresh ones), each
    timing the rivals in turns: each candidate's median ratio, within a
    measurement, to the model's pick.  Rivals within ``AGREE_GAP`` of each
    other are a tie (the measurement cannot rank them), an op whose rivals
    are further apart must be ranked right (``strict``; otherwise it is
    counted as ``WRONG``).  Returns the count of each verdict."""
    from repro_torch.core.autotune import AutotuneCache, measure_op
    ops = {op.name: op for op in plan.ops}
    again = [AutotuneCache(path=ROOT / "build" / "never_written.json")
             for _ in range(AGREE_MEASUREMENTS - 1)]
    verdicts = {"agree": 0, "tie": 0, "WRONG": 0}
    for row in report["rows"]:
        meas, pred = row["candidates_s"], row["candidates_predicted_s"]
        if not meas or len(meas) < 2:
            continue
        op = ops[row["op"]]
        runs = [meas] + [measure_op(op, list(meas), cache, backend="cuda")
                         for cache in again]
        med = {k: statistics.median(r[k] for r in runs) for k in meas}
        # Each run times the rivals in turns, so within a run they share
        # the host's state; the host's launch rate moves between runs
        # (one call's time can sit near either of two levels), which a
        # ratio of per-rival medians mixes in.  Compare within runs: each
        # rival's median ratio to the model's pick.
        pick = min(meas, key=pred.get)
        ratio = {k: statistics.median(r[k] / r[pick] for r in runs)
                 for k in meas}
        gap = max(ratio.values()) / min(ratio.values()) - 1
        agree = min(ratio, key=ratio.get) == pick
        verdict = "tie" if gap <= AGREE_GAP else \
            "agree" if agree else "WRONG"
        spread = ", ".join(
            f"{k} {min(r[k] for r in runs) * 1e6:.2f}-"
            f"{max(r[k] for r in runs) * 1e6:.2f}" for k in meas)
        dims = ("x".join(str(op.attrs[k]) for k in ("s1", "s2", "s3"))
                if op.kind != "conv" else "x".join(
                    str(d) for d in (*op.weights["w"].shape[:2],
                                     *op.out_shape)))
        log(f"  {row['op']:<24} {dims:<15} {row['kernel']:<16} predicted "
            + ", ".join(f"{k} {pred[k] * 1e6:.2f}" for k in meas)
            + " us; measured (median of " + str(len(runs)) + ") "
            + ", ".join(f"{k} {v * 1e6:.2f}" for k, v in med.items())
            + f" us (range {spread} us); over {pick} within a run "
            + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items())
            + f"; gap {gap:.2f}; {verdict} (first measurement ranked "
            + f"{'right' if row['agree'] else 'wrong'})")
        assert verdict != "WRONG" or not strict, \
            f"{what} {row['op']}: the H100 model ranks a {gap:.0%} gap wrong"
        verdicts[verdict] += 1
    return verdicts


def heldout_graphs() -> dict:
    """Ops at shapes none of the nine paths has (PERF.md §5 says which
    of them a constant of the H100 model was later fitted to): Gram
    products ``x @ xᵀ``, dense products, convs (the 3x3 over 384 channels
    is ranked by the plain conv's per-tap host cost), a masked VIP, KNN,
    and ELL products with the ELL matrix on the left (the columns
    kernel)."""
    from repro_torch.core.ir import GraphBuilder
    rng = np.random.default_rng(7)

    def rand(*shape):
        return (rng.standard_normal(shape) / math.sqrt(shape[-2] if len(
            shape) > 1 else 1)).astype(np.float32)

    graphs = {}
    for n, f in ((64, 2048), (128, 1024), (1024, 64), (1024, 2048)):
        b = GraphBuilder(f"gram_{n}x{f}")
        b.output(b.vip(b.input((n, f), name="x"), name=f"gram_{n}x{f}"))
        graphs[f"gram-{n}x{f}"] = b.g
    for m, k, n in ((4096, 1024, 1024), (256, 4096, 256)):
        b = GraphBuilder(f"dense_{m}x{k}x{n}")
        b.output(b.linear(b.input((m, k), name="x"), rand(k, n),
                          name=f"dense_{m}x{k}x{n}"))
        graphs[f"dense-{m}x{k}x{n}"] = b.g
    for kk, c_in, c_out, side in ((5, 256, 256, 16), (3, 32, 32, 64),
                                  (3, 384, 384, 20)):
        b = GraphBuilder(f"conv{kk}x{kk}")
        b.output(b.conv(b.input((c_in, side, side), name="x"),
                        rand(kk, kk, c_in, c_out),
                        name=f"conv{kk}x{kk}_{c_in}_{side}"))
        graphs[f"conv{kk}x{kk}-{c_in}-{side}"] = b.g
    graphs["vip-masked-10x10x1024"] = vip_masked_graph(
        GraphBuilder, side=10, feat=1024, win=3)
    b = GraphBuilder("knn_768x6")
    x = b.input((768, 6), name="x")
    b.output(b.mp(x, knn_input=b.knn_graph(x, k=16, name="knn_768x6"),
                  name="knn_mp"))
    graphs["knn-768x6-k16"] = b.g
    for n, f, slots in ((300, 1024, 5), (120, 4096, 3), (1000, 256, 8)):
        adj = np.zeros((n, n), np.float32)
        for i in range(n):
            adj[i, rng.choice(n, slots, replace=False)] = 1.0
        b = GraphBuilder(f"ell_{n}")
        b.output(b.mp(b.input((n, f), name="x"), adj=adj,
                      name=f"ell_{n}x{f}"))
        graphs[f"ell-{n}x{f}-{slots}"] = b.g
    return graphs


def heldout_phase(card) -> None:
    """The H100 model's ranking at ``heldout_graphs``' shapes
    (``rank_ops``): of the ops whose rivals are more than ``AGREE_GAP``
    apart, at least ``HELDOUT_RATE`` must be ranked right."""
    from repro_torch import gcv
    total = {"agree": 0, "tie": 0, "WRONG": 0}
    for name, graph in heldout_graphs().items():
        model = gcv.compile(graph, kernels="auto")
        report = model.profile_report(inputs=model.random_inputs(seed=0))
        for k, v in rank_ops(f"held-out {name}", model.plan, report,
                             strict=False).items():
            total[k] += v
    decided = total["agree"] + total["WRONG"]
    rate = total["agree"] / decided if decided else 1.0
    log(f"held-out lattice: over rivals more than {AGREE_GAP:.0%} apart: "
        f"{total['agree']} ranked right, {total['WRONG']} wrong "
        f"({rate:.3f}), {total['tie']} ties  [{card}]")
    assert decided and rate >= HELDOUT_RATE, \
        f"held out, the H100 model ranks {rate:.0%} of {decided} ops right"


def request_key(inputs: dict) -> tuple:
    """A request's identity by its arrays (``submit`` copies the dict,
    not the arrays)."""
    return tuple(id(v) for v in inputs.values())


def served_equal(reqs, singles, what: str) -> None:
    """Every served request's outputs equal its batch-1 run's bit for
    bit (``reqs``: (task, request index, TaskRequest))."""
    for task, i, req in reqs:
        assert req.done and req.result is not None, (what, task, i)
        for got, want in zip(req.result, singles[task][i]):
            assert np.array_equal(got, want), \
                f"{what}: {task} request {i} != its batch-1 run"


def closed_batches(eng, tasks, requests, singles, take,
                   rounds: int = 1) -> float:
    """Submit ``rounds`` rounds of ``take`` requests of every task (task by
    task in each round), drain the engine, hold every output to its
    batch-1 run; returns req/s on the host clock."""
    reqs = [(t, i % len(requests[t]), eng.submit(
        t, **requests[t][i % len(requests[t])]))
        for r in range(rounds) for t in tasks
        for i in range(r * take, (r + 1) * take)]
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    served = eng.run()
    rate = served / (time.perf_counter() - t_a)
    assert served == len(reqs), (served, len(reqs))
    served_equal(reqs, singles, f"closed batches of {take}")
    return rate


def eager_bucket_launches(kernels, model, samples) -> dict[str, int]:
    """Each GNN-CV wrapper's launches in one eager batched run of
    ``samples`` (the launches a graph of that bucket must record)."""
    from repro_torch.core.executor import stack_inputs
    run = model.batched(len(samples), jit=False)
    for name in GNNCV_KERNELS:
        kernels[name].launches = 0
    run(**stack_inputs(samples))
    torch.cuda.synchronize()
    return {name: kernels[name].launches for name in GNNCV_KERNELS}


def warm_each(eng, want, kernels, what: str) -> None:
    """The engine's ``warmup`` one (task, bucket) at a time: each capture
    must record ``want[(task, bucket)]``, the launches of that bucket's
    eager batched run (every count set to 0 just before, read just
    after)."""
    for task, bucket in want:
        for name in GNNCV_KERNELS:
            kernels[name].captured = 0
        assert eng.warmup([task], [bucket]) >= {(task, bucket)}
        got = {name: kernels[name].captured for name in GNNCV_KERNELS}
        assert got == want[(task, bucket)], (what, task, bucket, got,
                                             want[(task, bucket)])
    assert eng.stats()["warmed"] == len(want)
    log(f"{what}: the engine's warmup captured {len(want)} (task, bucket) "
        f"graphs, each recording its bucket's eager batched launches")


def served_kernels(eng, drive, want, what: str, card: str, *,
                   exact: bool = True) -> None:
    """``drive()`` under the profiler, after a first ``drive()`` in its
    warm-up step: each GNN-CV kernel's device count must equal the
    launches the dispatched (task, bucket) graphs recorded at capture
    (``want``), summed over the batches the engine dispatched in the
    recorded step (its per-bucket service histograms).  A profile now and
    then records only some of a window's device events, or none: a count
    that falls short (never over) is profiled again, up to two more times.
    ``exact=False``: every kernel seen and none over."""
    def batches():
        return {p: eng.metrics.histogram(f"service_ms.{p[0]}.b{p[1]}").count
                for p in want}

    before = {}

    def warm() -> None:
        drive()
        torch.cuda.synchronize()
        before.update(batches())

    for attempt in range(3):
        events = profile_window(drive, 1, what, "window", card, warm=warm)
        ran_b = {p: n - before[p] for p, n in batches().items()}
        expect = {name: sum(n * want[p][name] for p, n in ran_b.items())
                  for name in MAIN_KERNELS}
        ran = {name: sum(kernel_base(e.name) in bases for e in events)
               for name, bases in MAIN_KERNELS.items()}
        log(f"{what}: {sum(ran_b.values())} batches dispatched; main "
            f"kernels under the profiler {ran}, recorded by their graphs "
            f"{expect} (profile {attempt + 1})")
        assert all(ran[k] <= expect[k] for k in expect), (what, ran, expect)
        if ran == expect or (not exact and all(
                ran[k] for k in expect if expect[k])):
            return
    raise AssertionError((what, ran, expect))


def stream_arrivals(tasks, requests, rate: float, seconds: float,
                    seed: int) -> list:
    """Poisson arrivals at ``rate`` req/s for ``seconds``, tasks and
    requests drawn uniformly (a smoke mix, not a sourced one)."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    at = np.cumsum(rng.exponential(1.0 / rate, n))
    picks = zip(rng.integers(len(tasks), size=n),
                rng.integers(REQUESTS, size=n))
    return [(float(a), tasks[t], requests[tasks[t]][i])
            for a, (t, i) in zip(at, picks)]


def serving_phase(kernels, requests, card) -> None:
    """The nine paths served by ``gcv.serve`` engines (``kernels="cuda"``,
    ``max_batch=8``), the launch and capture counts set to 0 just before
    each engine's warmup and before its traffic, and read just after:

    (a) FIFO closed batches, ``SERVE_ROUNDS`` rounds of 8 requests of
        every path (bucket-8 batches) at ``pipeline_depth`` 1, then 2,
        req/s printed; the first engine's warmup is taken one (task,
        bucket) at a time, each capture held to its bucket's eager batched
        launches; then, under the profiler, 8, 1, 2 and 3 requests of every
        path (buckets 8, 1, 2 and 4, the last padded), the kernels the card
        ran held to the launches the dispatched graphs recorded;
    (b) open-loop streams under the SLO scheduler (``STREAM_*``,
        ``SLO_FACTOR``) at a fixed rate below the knee and at
        ``STREAM_LOAD`` of (a)'s depth-2 req/s: req/s, goodput, deadline
        misses, sojourn p50 and p99 (over the served requests and over
        every arrival, a shed one counted as never served), the adaptive
        depth's trace; each again under the profiler for the device's
        idle share and the kernels it ran;
    (c) b6-dyn over graph buckets (``DYN_*``): routing, padding counted,
        its warmup and its served batches held as in (a).

    Every served output must equal that request's batch-1
    ``CompiledModel.run`` bit for bit; a served batch launches no kernel
    from the host (every one is a graph replay); the runner cache may not
    miss after an engine's warmup, and a later engine over the same models
    captures nothing; under depth 2 some dispatch must return before the
    card finished its batch."""
    from repro_torch import gcv
    from repro_torch.core.runtime.cache import cache_stats
    from repro_torch.gnncv.tasks import build_dynamic_task
    tasks = list(requests)
    models = {t: gcv.compile(task_graph(t), kernels="cuda") for t in tasks}
    singles = {t: [tuple(o.cpu().numpy() for o in models[t].run(**r))
                   for r in requests[t]] for t in tasks}
    first = gcv.serve(models, max_batch=SERVE_MAX_BATCH, pipeline_depth=1,
                      scheduler="fifo")
    want = {(t, b): eager_bucket_launches(kernels, models[t],
                                          requests[t][:b])
            for t in tasks for b in first.buckets()}

    def zero() -> None:
        for name in GNNCV_KERNELS:
            kernels[name].launches = kernels[name].captured = 0

    def no_host_launches(what: str) -> None:
        launched = {n: kernels[n].launches for n in GNNCV_KERNELS}
        assert not any(launched.values()), (what, launched)

    def engine(**kw):
        """A later engine over the same models: its warmup finds every
        graph in the runner cache and captures nothing."""
        zero()
        eng = gcv.serve(models, max_batch=SERVE_MAX_BATCH, warmup=True,
                        **kw)
        assert eng.stats()["warmed"] == len(want)
        captured = {n: kernels[n].captured for n in GNNCV_KERNELS}
        assert not any(captured.values()), captured
        zero()
        return eng, cache_stats()["runner_misses"]

    rates = {}
    for depth in (1, 2):
        if depth == 1:
            eng = first
            warm_each(eng, want, kernels, "serve (a)")
            zero()
            misses = cache_stats()["runner_misses"]
        else:
            eng, misses = engine(pipeline_depth=2, scheduler="fifo")
        rates[depth] = closed_batches(eng, tasks, requests, singles,
                                      SERVE_MAX_BATCH, SERVE_ROUNDS)
        log(f"serve (a): closed batches, {SERVE_ROUNDS} rounds of "
            f"{SERVE_MAX_BATCH} requests x {len(tasks)} paths, FIFO, "
            f"pipeline_depth {depth}: {rates[depth]:.1f} req/s (host clock; "
            f"{eng.stats()['steps']} dispatches; "
            f"{eng.metrics.counter('dispatch_returned_ahead').value} "
            f"returned before the card finished their batch)  [{card}]")
        no_host_launches(f"serve (a) depth {depth}")
        if depth == 2:
            assert eng.metrics.counter("dispatch_returned_ahead").value, \
                "no dispatch returned before its batch finished"
            served_kernels(eng, lambda: [
                closed_batches(eng, tasks, requests, singles, take)
                for take in (SERVE_MAX_BATCH, 1, 2, 3)],
                want, "serve (a) buckets 8, 1, 2, 4", card)
            no_host_launches("serve (a) buckets")
            seen = {t: sorted(b for b in eng.buckets() if eng.metrics
                              .histogram(f"service_ms.{t}.b{b}").count)
                    for t in tasks}
            assert all(v == eng.buckets() for v in seen.values()), seen
            log(f"serve (a): buckets {eng.buckets()} served on every path; "
                f"every output == its batch-1 run bit for bit")
        assert cache_stats()["runner_misses"] == misses, \
            "the runner cache missed after the engine's warmup"

    b3 = models["b3-r101"]
    t_b3 = []
    for _ in range(20):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        b3.run(**requests["b3-r101"][0])
        torch.cuda.synchronize()
        t_b3.append((time.perf_counter() - t_a) * 1e3)
    slo_ms = SLO_FACTOR * statistics.median(t_b3)
    index = {request_key(r): i for t in tasks
             for i, r in enumerate(requests[t])}
    streams = (("below the knee", STREAM_BELOW),
               (f"{STREAM_LOAD} x depth 2", STREAM_LOAD * rates[2]))
    for seed, (label, rate) in enumerate(streams):
        arrivals = stream_arrivals(tasks, requests, rate, STREAM_S, seed)
        log(f"serve (b): open loop, {len(arrivals)} Poisson arrivals at "
            f"{rate:.1f} req/s ({label}) over {arrivals[-1][0]:.2f} s, "
            f"tasks uniform, slo_ms {slo_ms:.3f} ({SLO_FACTOR} x b3-r101's "
            f"batch-1 graph p50 {statistics.median(t_b3):.4f} ms), "
            f"scheduler slo")
        for profiled in (False, True):
            eng, misses = engine(slo_ms=slo_ms, scheduler="slo")
            if profiled:
                served_kernels(eng, lambda: eng.stream(arrivals), want,
                               f"served stream (b), {label}", card,
                               exact=False)
                no_host_launches("serve (b), profiled")
                break
            trace, t0 = [], time.perf_counter()
            adapt = eng._adapt_depth

            def traced_adapt():
                d = adapt()
                if not trace or trace[-1][1] != d:
                    trace.append((round((time.perf_counter() - t0) * 1e3,
                                        1), d))
                return d
            eng._adapt_depth = traced_adapt
            reqs = eng.stream(arrivals)
            st = eng.stats()
            done = [r for r in reqs if r.result is not None]
            served = sorted((r.t_done - r.t_submit) * 1e3 for r in done)
            every = served + [math.inf] * (len(reqs) - len(done))

            def pct(xs, q):
                return xs[min(len(xs) - 1, round(q * (len(xs) - 1)))]
            log(f"serve (b), {label}: {st['completed']} served, "
                f"{st['shed']} shed, {st['expired_at_submit']} expired at "
                f"submit; {st['req_per_s']:.1f} req/s, goodput "
                f"{st['goodput_req_per_s']:.1f} req/s, deadline-miss rate "
                f"{st['deadline_miss_rate']:.4f} (shed counted as missed); "
                f"sojourn over the served p50 {pct(served, 0.5):.3f} ms "
                f"p99 {pct(served, 0.99):.3f} ms, over every arrival (a "
                f"shed request never served) p50 {pct(every, 0.5):.3f} ms "
                f"p99 {pct(every, 0.99):.3f} ms; depth trace (ms, depth): "
                f"{trace[:12]}{' ...' if len(trace) > 12 else ''} "
                f"({len(trace)} changes)  [{card}]")
            served_equal([(r.task, index[request_key(r.inputs)], r)
                          for r in done], singles, "the stream")
            no_host_launches("serve (b)")
            assert cache_stats()["runner_misses"] == misses

    zero()
    dyn = gcv.serve(
        {"b6-dyn": lambda n: build_dynamic_task("b6-dyn", n_points=n)},
        graph_buckets={"b6-dyn": list(DYN_BUCKETS)},
        max_batch=SERVE_MAX_BATCH)
    rng = np.random.default_rng(1)

    def cloud(n: int) -> dict:
        return dict(points=rng.standard_normal((n, 3)).astype(np.float32),
                    mask=np.ones(n, np.float32))
    want_dyn = {(f"b6-dyn@g{g}", b): eager_bucket_launches(
        kernels, dyn.models[f"b6-dyn@g{g}"], [cloud(g)] * b)
        for g in DYN_BUCKETS for b in dyn.buckets()}
    warm_each(dyn, want_dyn, kernels, "serve (c)")
    zero()
    misses = cache_stats()["runner_misses"]
    sizes = rng.integers(DYN_POINTS[0], DYN_POINTS[1] + 1, DYN_REQUESTS)
    clouds = [cloud(int(n)) for n in sizes]
    reqs, runs = [], []

    def drive() -> None:
        reqs[:] = [dyn.submit("b6-dyn", **c) for c in clouds]
        assert dyn.run() == len(reqs)
        runs.append(len(reqs))
    served_kernels(dyn, drive, want_dyn, "serve (c) b6-dyn graph buckets",
                   card)
    no_host_launches("serve (c)")
    assert cache_stats()["runner_misses"] == misses
    for n, req in zip(sizes, reqs):
        g = next(b for b in DYN_BUCKETS if b >= n)
        assert req.task == f"b6-dyn@g{g}", (n, req.task)
        want_out = dyn.models[req.task].run(**req.inputs)
        for got, w in zip(req.result, want_out):
            assert np.isfinite(got).all() and np.array_equal(
                got, w.cpu().numpy()), f"b6-dyn {n} points"
    st = dyn.stats()["graph_buckets"]["b6-dyn"]
    assert sum(v["pad_nodes"] for v in st.values()) == len(runs) * sum(
        next(b for b in DYN_BUCKETS if b >= n) - n for n in sizes)
    log(f"serve (c): b6-dyn over graph buckets {list(DYN_BUCKETS)}: "
        f"{len(reqs)} clouds of {sizes.min()}-{sizes.max()} points, per "
        f"bucket over {len(runs)} run(s) {st}; each output == its "
        f"padded request's batch-1 run")


def sharded_phase(kernels, requests, card) -> None:
    """Batch-sharded serving (``gcv.serve(models, devices=[...])``,
    ``kernels="cuda"``, ``max_batch=SERVE_MAX_BATCH``) of
    ``SHARDED_TASKS`` at full width over every card, or ``[cuda:0,
    cuda:0]`` on a one-card host: two replicas, each with its weights,
    graphs and stream.  Checks that the warmup captures one graph per
    replica per bucket, each recording the launches of its replica's
    eager batched run (the captured counts set to 0 just before the warmup
    and read just after); that ``SHARDED_REQUESTS`` mixed requests come
    back equal to the batch-1 graph outputs bit for bit, with no kernel
    launched from the host, the runner cache frozen, ``pad_per_device``
    summing to ``padded``; that each model's ``resident_bytes`` is its
    replicas times ``resident_bytes_per_device``; and that ``devices=``
    one above the cards present warns and degrades.  Prints the replicas'
    served req/s beside a one-device engine's over the same requests."""
    import gc

    from repro_torch import gcv
    from repro_torch.core.runtime.cache import cache_stats
    from repro_torch.launch.mesh import make_data_mesh
    n_cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(n_cards)]
               if n_cards > 1 else [torch.device("cuda", 0)] * 2)
    mesh = make_data_mesh(devices)
    ndev = mesh.size
    tasks = SHARDED_TASKS
    graphs = {t: task_graph(t) for t in tasks}
    one = {t: gcv.compile(graphs[t], kernels="cuda") for t in tasks}
    picks = [(tasks[k % len(tasks)], (k // len(tasks)) % REQUESTS)
             for k in range(SHARDED_REQUESTS)]
    singles = {}
    for t, i in picks:
        singles.setdefault(t, {})[i] = tuple(
            o.cpu().numpy() for o in one[t].run(**requests[t][i]))

    def zero() -> None:
        for name in GNNCV_KERNELS:
            kernels[name].launches = kernels[name].captured = 0

    eng = gcv.serve(graphs, devices=devices, max_batch=SERVE_MAX_BATCH,
                    kernels="cuda")
    assert eng.stats()["devices"] == ndev and eng.buckets()[0] == ndev
    want = {}
    for t in tasks:
        for b in eng.buckets():
            rows = eager_bucket_launches(kernels, one[t],
                                         requests[t][:b // ndev])
            for name, n in rows.items():
                want[name] = want.get(name, 0) + ndev * n
    zero()
    t_a = time.perf_counter()
    eng.warmup()
    t_warm = time.perf_counter() - t_a
    got = {name: kernels[name].captured for name in GNNCV_KERNELS}
    assert got == want, ("sharded warmup captures", got, want)
    for t in tasks:
        for b in eng.buckets():
            run = eng.models[t].batched(b, jit=True)
            assert run.mesh == mesh and [
                r.trace_count() for r in run.replicas] == [1] * ndev, \
                (t, b, [r.trace_count() for r in run.replicas])
    resident = {}
    for t in tasks:
        st = eng.models[t].stats()
        assert st["devices"] == ndev and st["resident_bytes"] == \
            ndev * st["resident_bytes_per_device"], (t, st)
        resident[t] = st["resident_bytes"]
    log(f"sharded: {ndev} replicas on {[str(d) for d in mesh.devices]}, "
        f"buckets {eng.buckets()}; warmup {t_warm:.2f} s captured one "
        f"graph per replica per bucket ({len(tasks) * len(eng.buckets())} "
        f"x {ndev}), recording {got} launches (each replica's eager "
        f"batched launches); resident bytes per model {resident} = {ndev} "
        f"x one replica's")

    misses = cache_stats()["runner_misses"]

    def drive(engine) -> list:
        reqs = [(t, i, engine.submit(t, **requests[t][i]))
                for t, i in picks]
        assert engine.run() == len(reqs)
        return reqs

    zero()
    reqs = drive(eng)
    launched = {n: kernels[n].launches for n in GNNCV_KERNELS}
    assert not any(launched.values()), ("sharded host launches", launched)
    for t, i, req in reqs:
        for a, b in zip(req.result, singles[t][i]):
            assert np.isfinite(a).all() and np.array_equal(a, b), \
                f"sharded: {t} request {i} != its batch-1 graph run"
    st = eng.stats()
    assert st["runner_misses"] == misses, "the sharded engine built a runner"
    assert sum(st["pad_per_device"]) == st["padded"], st["pad_per_device"]
    assert st["inflight_per_device"] == [0] * ndev
    log(f"sharded: {len(reqs)} mixed requests of {list(tasks)} over "
        f"{ndev} replicas == their batch-1 graph runs bit for bit; "
        f"{st['steps']} dispatches, padded {st['padded']}, per device "
        f"{st['pad_per_device']}; no host launch, runner cache frozen")

    flat = gcv.serve(one, max_batch=SERVE_MAX_BATCH, warmup=True)
    rates = {}
    for label, engine in (("one device", flat), (f"{ndev} replicas", eng),
                          ("one device", flat), (f"{ndev} replicas", eng)):
        drive(engine)
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        for _ in range(SHARDED_ROUNDS):
            drive(engine)
        rates.setdefault(label, []).append(
            SHARDED_ROUNDS * len(picks) / (time.perf_counter() - t_a))
    log(f"sharded: served req/s (host clock, {SHARDED_ROUNDS} rounds of "
        f"{len(picks)} mixed requests, FIFO, depth 2, in turns): "
        + ", ".join(f"{k} {' / '.join(f'{r:.1f}' for r in v)}"
                    for k, v in rates.items()) + f"  [{card}]")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        small = gcv.serve({"b4": graphs["b4"]}, devices=n_cards + 1,
                          max_batch=SERVE_MAX_BATCH)
    assert any("only" in str(w.message) for w in caught), caught
    assert small.stats()["devices"] == n_cards
    log(f"sharded: devices={n_cards + 1} on {n_cards} card(s) warned "
        f"({caught[0].message}) and serves over {n_cards}")
    del eng, flat, small, one, graphs
    gc.collect()
    torch.cuda.empty_cache()


def gnn_phase(kernels, requests, card, timed: bool) -> list[dict]:
    """The standalone GNNs and what this slice repaired, on the card:
    ``gnn_path`` for g1-g3 on each Table IX graph (``GNN_DATASETS``), the
    KNN sort route (``knn_sort_checks``), dense max-aggregation
    (``maxagg_checks``) and Step 4 on the H100 (``step4_phase``, b1-b7's
    ``requests`` given); with ``timed`` (``--gnn``) also the input staging
    and Step 4's device busy time.  -> the kernels line's rows of the GNN
    paths' DDMM calls and of the KNN sort route."""
    rows = []
    for model_name in GNN_MODELS:
        for dataset in GNN_DATASETS if timed else GNN_DEFAULT_DATASETS:
            rows += gnn_path(model_name, dataset, kernels, card, timed)
        stamp(f"{model_name} paths")
    rows += knn_sort_checks(kernels, card)
    maxagg_checks(card)
    stamp("KNN sort route and maxagg")
    step4_phase(requests, card, timed)
    return rows


def gnn_requests(plan, seeds=range(REQUESTS)) -> list[dict]:
    """Standard-normal node features, one request per seed."""
    n, f = plan.meta["input_shapes"]["features"]
    return [{"features": np.random.default_rng(s).standard_normal(
        (n, f), dtype=np.float32)} for s in seeds]


def gnn_path(model_name, dataset, kernels, card,
             timed: bool) -> list[dict]:
    """One GNN of ``GNN_ZOO`` on one dataset at its published size (the
    reference's ``GraphSpec`` and builder defaults, seed 0):
    ``gcv.compile(graph, kernels="cuda")`` and the plain plan, ``REQUESTS``
    feature requests eager through the kernels (``serve``: counts,
    ``E2E_RTOL`` against the plain plan on the card, request 0 against the
    CPU), with ``timed`` the input staging, ``graph_phase`` (graph ==
    eager bit for bit; batch ``GRAPH_BATCH`` == batch 1 on cora alone;
    request p50s, replay alone, device busy and idle share, kernels per
    replay) and every DDMM call against its plain version.  -> its
    kernels-line rows."""
    from repro_torch import gcv
    from repro_torch.core import CompileOptions, compile_graph
    from repro_torch.gnncv import GNN_ZOO
    task = f"{model_name}-{dataset}"
    graph = GNN_ZOO[model_name](dataset)
    t_a = time.perf_counter()
    model = gcv.compile(graph, kernels="cuda")
    plan_torch = compile_graph(graph, CompileOptions(kernels="torch"))
    log(f"{task}: compile {time.perf_counter() - t_a:.2f} s on the host, "
        f"{len(model.plan.ops)} ops, {model.plan.kernel_counts()}, inputs "
        f"{model.plan.meta['input_shapes']}")
    per_request = {**dict.fromkeys(GNNCV_KERNELS, 0),
                   "ddmm": GNN_DDMM[model_name]}
    reqs = gnn_requests(model.plan)
    if timed:
        staging_times(task, reqs, card)
    launches = serve(task, model.plan, plan_torch, reqs, kernels,
                     per_request)
    graph_phase(task, reqs, kernels, card, model=model,
                per_request=per_request,
                batch=GRAPH_BATCH if dataset == "cora" else None,
                turns=GNN_TURNS)
    cases = task_cases(task, model.plan, np.random.default_rng(7),
                       torch.device("cuda"))
    max_err = dict.fromkeys(kernels, 0.0)
    for case in cases:
        max_err[case.kernel] = max(max_err[case.kernel], check_case(case))
    return kernel_rows(task, cases, launches, per_request, max_err, card)


def staging_times(task, reqs, card) -> None:
    """Host-to-card copy of each request's inputs from pageable numpy
    memory, as a request stages them (host clock, synchronized)."""
    t_req = []
    for req in reqs:
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        for v in req.values():
            torch.from_numpy(v).to("cuda")
        torch.cuda.synchronize()
        t_req.append((time.perf_counter() - t_a) * 1e3)
    mb = sum(v.nbytes for v in reqs[0].values()) / 1e6
    log(f"{task} staging: {mb:.1f} MB a request, host to card p50 "
        f"{statistics.median(t_req):.4f} ms over {len(t_req)} requests "
        f"(pageable copy, host clock)  [{card}]")


def knn_sort_checks(kernels, card) -> list[dict]:
    """KNN above the warp route (``k > WARP_MAX_K``, the sort route) at
    ``N = 1024``: every k of ``KNN_SORT_K`` over a padding mask and
    ``knn_adversarial``'s orders, self loops off and on, then b6-dyn's own
    points (request 0: standard normal, the padding mask) at
    ``DYN_SORT_K``; indices equal to ``knn_ref`` exactly.  The launch count
    is set to 0 just before and read just after.  -> the route's
    kernels-line row (b6-dyn's points)."""
    from repro_torch.kernels import knn, ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    knn.launches = 0
    checked = 0
    for k in KNN_SORT_K:
        for name in KNN_SORT_ORDERS:
            x, mask = (knn_adversarial(name, 1024, 3, rng)
                       if name != "padded" else
                       (rng.standard_normal((1024, 3)).astype(np.float32),
                        pad_mask(1024)))
            x = torch.from_numpy(x).to(dev)
            mask = None if mask is None else torch.from_numpy(mask).to(dev)
            for self_loops in (False, True):
                got = knn(x, k, mask=mask, self_loops=self_loops)
                want = ref.knn_ref(x, k, mask=mask, self_loops=self_loops)
                bad = (got != want).any(1).nonzero().flatten().tolist()
                assert not bad, (f"knn sort route k={k} {name} self_loops="
                                 f"{self_loops}: rows {bad[:8]} differ")
                checked += 1
    points = np.random.default_rng(0).standard_normal(
        (1024, 3)).astype(np.float32)
    x, mask = (torch.from_numpy(a).to(dev) for a in (points, pad_mask(1024)))
    got = knn(x, DYN_SORT_K, mask=mask)
    assert torch.equal(got, ref.knn_ref(x, DYN_SORT_K, mask=mask)), \
        "knn sort route at b6-dyn's points differs from knn_ref"
    torch.cuda.synchronize()
    launches = knn.launches
    assert launches == checked + 1, (launches, checked)
    log(f"knn sort route: indices == knn_ref exactly in {checked} cases at "
        f"N = 1024 (k in {KNN_SORT_K}, {KNN_SORT_ORDERS}, self loops off "
        f"and on) and at b6-dyn's points, k = {DYN_SORT_K}; {launches} "
        f"launches")
    case = knn_case(x, DYN_SORT_K, mask=mask, self_loops=False,
                    per_request=1, note="b6-dyn's points, sort route")
    check_case(case)
    return kernel_rows(
        "knn-sort", [case], {"knn": launches}, {"knn": 1}, {"knn": 0.0},
        card, unit=f"ms per call of the KNN sort route at b6-dyn's points "
                   f"(1024, 3), k = {DYN_SORT_K}")


def maxagg_checks(card) -> None:
    """Dense max-aggregation (``maxagg``, plain PyTorch: no kernel) on the
    card: b6-dyn's 1024 points (request 0) with their 20-NN adjacency made
    dense 0/1 and row 0 emptied, ``mp(adj=, reduce="max")`` over 64
    features, through ``gcv.compile(kernels="cuda")``: equal to the plain
    plan on the card and to the CPU run exactly, graph replay included,
    NaN included where one is planted."""
    from repro_torch import gcv
    from repro_torch.core.ir import GraphBuilder
    from repro_torch.gnncv.graphs import knn_indices
    points = np.random.default_rng(0).standard_normal(
        (1024, 3)).astype(np.float32)
    adj = np.zeros((1024, 1024), np.float32)
    adj[np.repeat(np.arange(1024), MAXAGG_K),
        knn_indices(points, MAXAGG_K).reshape(-1)] = 1.0
    adj[0] = 0.0
    b = GraphBuilder("maxagg_b6dyn")
    x = b.input((1024, 64), name="nodes")
    graph = b.output(b.mp(x, adj=adj, reduce="max", name="agg"))
    model = gcv.compile(graph, kernels="cuda")
    plain = gcv.compile(graph, kernels="torch")
    cpu = gcv.compile(graph, kernels="cuda", device="cpu")
    assert [(o.kind, o.kernel) for o in model.plan.ops] == \
        [("maxagg", "torch_ell_spdmm")]
    model.warmup()
    reqs = []
    for s in range(3):
        feats = np.random.default_rng(s).standard_normal(
            (1024, 64)).astype(np.float32)
        if s == 2:
            feats[int(np.nonzero(adj[5])[0][0]), 3] = np.nan
            feats[0, 7] = np.nan                  # the empty row's own
        reqs.append({"nodes": feats})
    for s, req in enumerate(reqs):
        got = model.run(**req)[0].cpu().numpy()
        eager = model.runner(jit=False)(**req)[0].cpu().numpy()
        for what, want in (("eager", eager),
                           ("plain plan", plain.run(**req)[0].cpu().numpy()),
                           ("CPU", cpu.run(**req)[0].numpy())):
            np.testing.assert_array_equal(
                got, want, err_msg=f"maxagg request {s}: graph != {what}")
        np.testing.assert_array_equal(got[0], req["nodes"][0])
    assert np.isnan(got[5, 3]) and np.isnan(got[0, 7])
    log(f"maxagg (1024 nodes, {MAXAGG_K}-NN adjacency made dense, row 0 "
        f"empty): graph == eager == plain plan == CPU exactly on "
        f"{len(reqs)} requests, NaN and the empty row included  [{card}]")


def step4_phase(requests, card, timed: bool) -> None:
    """Step 4 on the H100: b1-b6, b3-r101, b6-dyn (``requests``), the
    traced b7 and b7-dyn and g1-g3 on cora, each compiled with
    ``target="fpga"`` and ``target="h100"`` under ``kernels="cuda"``: the
    ops whose primitive or kernel flips, the h100 plan's outputs within
    ``E2E_RTOL`` of the fpga plan's, and with ``timed`` each plan's
    kernels' device busy time per graph request (profiler,
    marker-bracketed window; the input and output copies left out)."""
    from repro_torch import gcv
    from repro_torch.core.executor import random_inputs
    from repro_torch.gnncv import GNN_ZOO
    from repro_torch.gnncv.torch_tasks import TRACED_TASKS
    paths = [(t, task_graph(t), None, requests[t][:STEP4_REQUESTS])
             for t in PER_REQUEST if t != "vip-masked"]
    paths += [(t, *TRACED_TASKS[t](), None) for t in TRACED_PER_REQUEST]
    paths += [(f"{m}-cora", GNN_ZOO[m]("cora"), None, None)
              for m in GNN_MODELS]
    flipped = 0
    for task, graph, example, reqs in paths:
        models = {t: gcv.compile(graph, example, kernels="cuda", target=t,
                                 name=f"{task}_{t}")
                  for t in ("fpga", "h100")}
        fpga, h100 = (models[t].plan for t in ("fpga", "h100"))
        assert h100.meta["select_target"] == "h100"
        flips = [(a.name, f"{a.primitive}/{a.kernel}",
                  f"{b.primitive}/{b.kernel}")
                 for a, b in zip(fpga.ops, h100.ops)
                 if (a.primitive, a.kernel) != (b.primitive, b.kernel)]
        flipped += len(flips)
        if reqs is None:
            reqs = ([random_inputs(fpga, seed=s)
                     for s in range(STEP4_REQUESTS)]
                    if "features" not in fpga.meta["input_shapes"] else
                    gnn_requests(fpga, range(STEP4_REQUESTS)))
        for s, req in enumerate(reqs):
            want = models["fpga"].run(**req)
            for got, ref_out in zip(models["h100"].run(**req), want):
                err, rel = rel_err(got.float(), ref_out.float())
                assert rel <= E2E_RTOL, \
                    f"{task} request {s}: h100 plan differs by {rel:.3e}"
        busy = dict.fromkeys(models, "not measured (under --gnn)")
        for t, model in (models.items() if timed else ()):
            model.warmup()
            it = itertools.cycle(reqs)
            events = [e for e in device_events(
                lambda: model.run(**next(it)), REQUESTS,
                warm=lambda: model.run(**next(it))) if not is_copy(e)]
            busy[t] = (f"{device_busy(events)[0] / REQUESTS / 1e3:.4f} ms"
                       if events else "not measured")
        log(f"step 4 {task}: {len(flips)} ops flip under target='h100' "
            f"{flips}; kernels' device busy per graph request (copies "
            f"left out): fpga plan {busy['fpga']}, h100 plan "
            f"{busy['h100']}; outputs within {E2E_RTOL:g}  [{card}]")
    log(f"step 4: {flipped} ops flip over {len(paths)} paths")


# A dense kernel's call takes the same time on any data: one call that
# several paths make (b3-r50's and b3-r101's convolutions, b7's and
# b7-dyn's products) is timed once a run, at the first path that makes it,
# and its times are printed under each path that makes it.
SAME_TIME = ("shift_conv2d", "ddmm")
_TIMED: dict[tuple, tuple] = {}


def case_times(case, task: str) -> tuple:
    """The times of ``case``'s call: (kernel ms, plain ms, library ms or
    None, device ms or None, the kernel's device parts where bracketed,
    the extra times, the library's device parts, the path at which the
    call was timed)."""
    plan = case.plan
    key = (case.kernel, case.label, case.bracketed,
           case.library is None, case.before is None, case.mm is None,
           None if plan is None else (getattr(plan, "route", "tile"),
                                      plan.bm, plan.bn, plan.split,
                                      plan.k_tiles, plan.blocks))
    if case.kernel in SAME_TIME and key in _TIMED:
        return _TIMED[key]
    ms = time_ms(case.run)
    plain = time_ms(case.plain)
    lib = time_ms(case.library) if case.library is not None else None
    parts = {}
    if case.bracketed:
        parts = device_breakdown(case.run)
        dev = sum(parts.values()) if parts else None
    else:
        dev = device_ms(case.run, DEVICE_PREFIX[case.kernel])
    extra = {}
    if case.before is not None:
        extra["before_ms"] = time_ms(case.before)
        # every device kernel of the old route, its copies included
        extra["before_device_ms"] = device_ms(case.before, "")
    if case.mm is not None:
        extra["mm_ms"] = time_ms(case.mm)
    lib_parts = {}
    if case.bracketed and lib is not None:
        # every device kernel of the library call (their names say which
        # backend ran)
        lib_parts = device_breakdown(case.library)
        extra["library_device_ms"] = sum(lib_parts.values()) or None
    out = (ms, plain, lib, dev, parts, extra, lib_parts, task)
    if case.kernel in SAME_TIME:
        _TIMED[key] = out
    return out


def kernel_rows(task, cases, launches, per_request, max_err, card,
                unit=None, timed: bool = True) -> list[dict]:
    """Time every case (``timed=False``: only the calls the path makes, the
    others are checked only; their times come under the phase's flag);
    one JSON row per kernel the path runs (``per_request``: its launches
    per request; the rows sum the path's calls alone either way)."""
    totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         library_ms=0.0, device_ms=0.0, nbytes=0.0,
                         flops=0.0, library=True, device=True,
                         before_ms=None, before_device_ms=None, mm_ms=None,
                         library_device_ms=None)
              for name in SOURCES}
    for case in cases:
        if not (timed or case.per_request):
            continue
        ms, plain, lib, dev, parts, extra, lib_parts, first = \
            case_times(case, task)
        bnd, by = bound_ms(case.nbytes, case.flops, case.rate)
        # the rate of the products the function needs, by device time
        rate = case.flops / ((dev or ms) * 1e-3) / 1e12
        plan = case.plan
        log(f"time {task} {case.label}: kernel {ms:.5f} ms"
            + ("" if dev is None else f" (device {dev:.5f} ms)")
            + f", plain {plain:.5f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.5f} ms'}, bound "
            f"{bnd:.5f} ms ({by}), {rate:.2f} TFLOP/s"
            + ("" if case.run_flops is None else
               f" ({case.run_flops / ((dev or ms) * 1e9):.2f} TFLOP/s "
               f"issued)")
            + "".join(f", {k} {v:.5f}" for k, v in extra.items()
                      if v is not None)
            + ("" if plan is None else
               f", {getattr(plan, 'route', 'tile')} {plan.bm}x{plan.bn} "
               f"split {plan.split} of {plan.k_tiles} K tiles, "
               f"{plan.blocks} blocks")
            + (f", {bnd / (dev or ms):.4f} of the bound"
               if case.kernel in BOUND_SHARE else "")
            + f", x{case.per_request:g}/request"
            + ("" if first == task else f" (the same call as {first}'s, "
               f"timed there)")
            + f"  [{card}]")
        if case.bracketed:
            log("  by kernel (device ms a call, bracketed window): " + (
                ", ".join(f"{name} {t:.5f}" for name, t in parts.items())
                or "not measured (a marker was lost)"))
        if lib_parts:
            log("  library by kernel: " + ", ".join(
                f"{name[:60]} {t:.5f}" for name, t in lib_parts.items()))
        if case.per_request:
            tot = totals[case.kernel]
            for key, value in extra.items():
                if value is not None:
                    tot[key] = (tot[key] or 0.0) + case.per_request * value
            tot["ms"] += case.per_request * ms
            tot["plain_ms"] += case.per_request * plain
            tot["bound_ms"] += case.per_request * bnd
            # operations in fp32-rate units, so that mixed cases compare
            tot["nbytes"] += case.per_request * case.nbytes
            tot["flops"] += case.per_request * case.flops * (
                FP32_FLOPS / case.rate)
            if lib is None:
                tot["library"] = False
            else:
                tot["library_ms"] += case.per_request * lib
            if dev is None:
                tot["device"] = False
            else:
                tot["device_ms"] += case.per_request * dev
    rows = []
    for name, tot in totals.items():
        if not per_request.get(name):
            continue
        _, by = bound_ms(tot["nbytes"], tot["flops"])
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "launches_per_request": per_request[name],
            "max_abs_err": max_err[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"] if tot["library"] else None,
            "unit": unit or f"ms per {task} request: sum over its launches",
        }
        if tot["device"]:
            row["device_ms"] = tot["device_ms"]
        if name in BOUND_SHARE:
            # the bound over the time taken: device time where profiled
            took = tot["device_ms"] if tot["device"] else tot["ms"]
            row["bound_share"] = tot["bound_ms"] / took
            log(f"{task} {name}: {took:.5f} ms/request "
                f"({'device' if tot['device'] else 'events'}) against a "
                f"bound of {tot['bound_ms']:.5f} ms: "
                f"{row['bound_share']:.4f} of the bound  [{card}]")
        for key in ("before_ms", "before_device_ms", "mm_ms",
                    "library_device_ms"):
            if tot[key] is not None:
                row[key] = tot[key]
        rows.append(row)
    return rows


def live_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: under the diagonal when
    causal (query i sees keys j <= i + sk - sq)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def flash_case(shape, dtype, rng, dev, per_request=0.0,
               lse=False, dv=None) -> Case:
    """Flash attention at ``(B, Hq, Hkv, Sq, Sk, D, causal)``, v's head dim
    ``dv`` (default D).  Bound: q, k, v and o moved once (and the fp32 LSE
    written, with ``lse``: the training forward); 2·(D + DV) operations
    per live pair at the peak of the input's type.  Library: one
    ``F.scaled_dot_product_attention`` call (its causal mask is aligned
    at the top left, so only at Sq = Sk or without a mask is it the same
    function)."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    b, hq, hkv, sq, sk, d, causal = shape
    dv = dv or d
    q, k, v = (torch.tensor(rng.standard_normal(sh), dtype=torch.float32,
                            device=dev).to(dtype)
               for sh in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv)))
    library = None
    if sq == sk or not causal:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    bf16 = dtype == torch.bfloat16
    label = (f"flash_attention {str(dtype).split('.')[-1]} q{tuple(q.shape)} "
             + (f"kv{tuple(k.shape)}" if dv == d else
                f"k{tuple(k.shape)} v{tuple(v.shape)}")
             + f" causal={causal}" + (" +lse" if lse else ""))

    def run():
        if lse:
            return flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)[0]
        return flash_attention(q, k, v, causal=causal)

    return Case(
        "flash_attention", label, run,
        lambda: ref.attention_ref(q, k, v, causal=causal), library,
        q.element_size() * (q.numel() + k.numel() + v.numel()
                            + b * hq * sq * dv)
        + (4.0 * b * hq * sq if lse else 0.0),
        2.0 * (d + dv) * b * hq * live_pairs(sq, sk, causal), per_request,
        rtol=FLASH_BF16_RTOL if bf16 else KERNEL_RTOL,
        rate=BF16_FLOPS if bf16 else FP32_FLOPS)


def lm_buckets(cfg) -> dict[int, int]:
    """Requests per prefill bucket among the launcher's prompts."""
    from repro_torch.launch.serve import prompts
    from repro_torch.serve import ServeEngine
    counts: dict[int, int] = {}
    for p in prompts(cfg.vocab, LM_REQUESTS, LM_PROMPT_LEN, 0):
        bucket = ServeEngine._bucket(len(p))
        counts[bucket] = counts.get(bucket, 0) + 1
    return counts


def lm_cases(cfg, rng, dev) -> dict[str, list[Case]]:
    """The flash kernel's calls on the LM paths in bf16 (the served
    prefills, weighted by their share of requests; the 2048-token
    prefill), the same shapes in fp32, and edge cases in both types: a
    D = 64 GQA (llama3.2's heads), a continuation (Sq < Sk), rows with no
    live key (Sq > Sk) and no mask at ragged sizes."""
    hq, hkv, d, n_l = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                       cfg.n_layers)
    bf16, f32 = torch.bfloat16, torch.float32
    serve_cases = [flash_case((1, hq, hkv, s, s, d, True), bf16, rng, dev,
                              per_request=n * n_l / LM_REQUESTS)
                   for s, n in sorted(lm_buckets(cfg).items())]
    long = (1, hq, hkv, LONG_PROMPT, LONG_PROMPT, d, True)
    long_cases = [flash_case(long, bf16, rng, dev, per_request=n_l),
                  flash_case(long, f32, rng, dev)]
    extra = [flash_case((1, hq, hkv, s, s, d, True), f32, rng, dev)
             for s in sorted(lm_buckets(cfg))]
    for shape in ((2, 32, 8, 128, 128, 64, True),
                  (1, hq, hkv, 64, 256, d, True),
                  (1, hq, hkv, 80, 48, d, True),
                  (2, 2, 1, 77, 154, 48, False)):
        extra += [flash_case(shape, dt, rng, dev) for dt in (f32, bf16)]
    return {"lm-serve": serve_cases + extra, "lm-prefill-2048": long_cases}


def flash_exact_checks(cfg, rng, dev) -> None:
    """Rows with no live key come out as exact zeros; (B, S, H, D)
    activations read as permuted views give the bits of contiguous
    copies."""
    from repro_torch.kernels import flash_attention
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(torch.bfloat16)

    out = flash_attention(t(1, hq, 80, d), t(1, hkv, 48, d), t(1, hkv, 48, d))
    views = [t(2, 48, h, d).transpose(1, 2) for h in (hq, hkv, hkv)]
    got = flash_attention(*views)
    copies = flash_attention(*(a.contiguous() for a in views))
    torch.cuda.synchronize()
    nonzero = int((out[:, :, :32] != 0).sum().item())
    differ = int((got != copies).sum().item())
    log(f"check flash_attention Sq=80 > Sk=48: {nonzero} nonzero outputs on "
        f"the 32 rows with no live key; permuted (B, S, H, D) views vs "
        f"contiguous copies: {differ} elements differ"
        + ("" if not (nonzero or differ) else "  FAIL"))
    assert not nonzero, "flash_attention: a row with no live key is not 0"
    assert not differ, "flash_attention: strided views change the result"


def lm_counts(kernels, want: dict[str, int], what: str) -> dict[str, int]:
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"{what}: launches {launches}")
    assert launches == {**dict.fromkeys(kernels, 0), **want}, (what,
                                                               launches)
    return launches


def lm_serve(cfg, kernels) -> dict[str, int]:
    """The LM path through its entry point, ``launch.serve.serve`` at the
    launcher's defaults and the published config: counts set to 0 just
    before, read just after."""
    from repro_torch.launch.serve import serve as serve_lm
    for fn in kernels.values():
        fn.launches = 0
    res = serve_lm(LM_ARCH, smoke=False, device="cuda")
    torch.cuda.synchronize()
    launches = lm_counts(kernels, {"flash_attention": LM_REQUESTS
                                   * cfg.n_layers}, f"{LM_ARCH} serve")
    log(f"{LM_ARCH} serve (launch.serve.serve, full config): "
        f"{json.dumps(res)}")
    assert res["requests"] == LM_REQUESTS
    assert res["tokens_generated"] == LM_REQUESTS * LM_MAX_NEW, res
    return launches


def lm_engine_run(cfg, params, kernels, card, want=None):
    """The same requests through a ``ServeEngine`` stepped here, timed on
    the host clock per step, per request and per token; ``want``: the
    launches the run must count (default: qwen3's, one flash launch a
    layer per prefill).  Returns the engine and its requests."""
    from repro_torch.launch.serve import prompts
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    batch = prompts(cfg.vocab, LM_REQUESTS, LM_PROMPT_LEN, 0)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=LM_MAX_NEW) for p in batch]
    first, done, steps = {}, {}, []
    while not all(r.done for r in reqs):
        t_a = time.perf_counter()
        eng.step()                        # ends in .tolist(): synchronized
        t_b = time.perf_counter()
        steps.append((t_b - t_a) * 1e3)
        for r in reqs:
            if r.out:
                first.setdefault(r.rid, t_b)
            if r.done:
                done.setdefault(r.rid, t_b)
        assert len(steps) <= LM_REQUESTS * LM_MAX_NEW, "did not converge"
    wall = time.perf_counter() - t0
    lm_counts(kernels, {"flash_attention": LM_REQUESTS * cfg.n_layers}
              if want is None else want, f"{cfg.name} engine run")
    lat = [(done[r.rid] - t0) * 1e3 for r in reqs]
    ttft = [(first[r.rid] - t0) * 1e3 for r in reqs]
    per_tok = [(done[r.rid] - first[r.rid]) * 1e3 / (len(r.out) - 1)
               for r in reqs]

    def q(xs):
        qs = statistics.quantiles(xs, n=10)
        return (f"p50 {statistics.median(xs):.4f} ms, p10 {qs[0]:.4f}, "
                f"p90 {qs[-1]:.4f}, max {max(xs):.4f}")

    n_tok = sum(len(r.out) for r in reqs)
    log(f"{cfg.name} engine run (host clock): {len(reqs)} requests, "
        f"{len(steps)} steps, {n_tok} tokens in {wall:.4f} s "
        f"({n_tok / wall:.2f} tok/s)  [{card}]")
    log(f"  request latency (all submitted at t0): {q(lat)}")
    log(f"  time to first token: {q(ttft)}")
    log(f"  per token after the first, per request: {q(per_tok)}")
    log(f"  engine step (admissions + one decode step): {q(steps)}")
    return eng, reqs


def token_margins(cfg, params, reqs) -> tuple[float, int, int]:
    """Each engine token's logit on the plain path (``impl="naive"``,
    teacher-forced over the prompt and the engine's own tokens) against
    that position's maximum: ``(the largest gap over max|logits|, tokens
    equal to the plain argmax, tokens)``."""
    from repro_torch.models.transformer import lm_forward
    dev = params["embed"].device
    rows = []
    for r in reqs:
        seq = np.concatenate([r.prompt, r.out[:-1]])
        logits, _ = lm_forward(params, cfg, impl="naive",
                               tokens=torch.as_tensor(seq, device=dev)[None])
        rows.append(logits[0, len(r.prompt) - 1:])      # (len(out), V)
    return gap_stats(rows, [r.out for r in reqs])


def gap_stats(rows, outs) -> tuple[float, int, int]:
    """Per request, logits ``(len(out), V)`` and the tokens ``out``: the
    largest gap between a position's maximum and its token's logit over
    max|logits| there, the tokens equal to the argmax, the tokens."""
    worst_gap, agree, total = 0.0, 0, 0
    for row, out in zip(rows, outs):
        out = torch.as_tensor(out, device=row.device)
        gap = ((row.amax(-1) - row.gather(1, out[:, None])[:, 0])
               / row.abs().amax(-1))
        worst_gap = max(worst_gap, gap.max().item())
        agree += int((row.argmax(-1) == out).sum().item())
        total += len(out)
    return worst_gap, agree, total


def lm_parity(cfg, params, reqs) -> None:
    """Margin-aware parity of the served tokens against the plain path
    (same weights): each request's prefill logits, and each engine
    token's plain logit against that position's maximum."""
    worst_prefill = max(rel_err(*(served_prefill(cfg, params, r.prompt, impl)
                                  for impl in ("chunked", "naive")))[1]
                        for r in reqs)
    worst_gap, agree, total = token_margins(cfg, params, reqs)
    ok = worst_prefill <= PREFILL_RTOL and worst_gap <= MARGIN_RTOL
    log(f"{cfg.name} parity vs the plain path: prefill logits rel up to "
        f"{worst_prefill:.3e} (limit {PREFILL_RTOL:g}); engine tokens "
        f"{agree}/{total} equal the plain argmax, the largest gap below "
        f"the plain maximum {worst_gap:.3e} of max|logits| (limit "
        f"{MARGIN_RTOL:g})" + ("" if ok else "  FAIL"))
    assert worst_prefill <= PREFILL_RTOL, "prefill logits disagree"
    assert worst_gap <= MARGIN_RTOL, "an engine token is off the plain max"


class AttentionProbe:
    """Two attention cores registered in ``models.attention.ATTN_IMPLS``
    for the duration of a ``with`` block (never on a served path):
    ``probe`` runs the plain core and the kernel on the same q, k, v,
    keeps the kernel's error at each call (``errs``) and returns the
    plain output, so a prefill under it is the plain path;  ``library``
    is ``F.scaled_dot_product_attention``, a third implementation to
    measure how far any correct attention moves the model's bf16
    logits."""

    def __init__(self):
        self.errs: list[float] = []

    def probe(self, q, k, v, *, causal, offset=0, scale=None):
        from repro_torch.models import attention
        want = attention.naive_attention(q, k, v, causal=causal,
                                         offset=offset, scale=scale)
        got = attention.flash_chunked_attention(q, k, v, causal=causal,
                                                offset=offset, scale=scale)
        self.errs.append(rel_err(got.float(), want.float())[1])
        return want

    @staticmethod
    def library(q, k, v, *, causal, offset=0, scale=None):
        assert offset == k.shape[1] - q.shape[1] == 0
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, scale=scale,
            enable_gqa=k.shape[2] != q.shape[2]).transpose(1, 2)

    def __enter__(self):
        from repro_torch.models import attention
        attention.ATTN_IMPLS.update(probe=self.probe, library=self.library)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        for name in ("probe", "library"):
            del attention.ATTN_IMPLS[name]


def probe_parity(cfg, params, reqs):
    """Every served prompt prefilled under ``AttentionProbe`` (the plain
    path, the kernel held to the plain core at each attention call), by
    the kernel path and by the library attention, and once with one
    embedding element a bf16 ulp off: ``(the kernel's largest error at a
    call over max|plain|, the calls, {"kernel", "library"}: each path's
    largest prefill-logit error over max|logits|, the nudge's, the plain
    path's prefill logits of each prompt)``."""
    probe = AttentionProbe()
    worst = {"kernel": 0.0, "library": 0.0}
    plains = []
    with probe:
        for r in reqs:
            plain = served_prefill(cfg, params, r.prompt, "probe")
            plains.append(plain)
            for name, impl in (("kernel", "chunked"), ("library", "library")):
                worst[name] = max(worst[name], rel_err(served_prefill(
                    cfg, params, r.prompt, impl), plain)[1])
        embed, tok = params["embed"], int(reqs[0].prompt[0])
        old = embed[tok, 0].clone()
        embed[tok, 0] = (old.float() * (1 + 2.0 ** -7)).to(embed.dtype)
        nudged = served_prefill(cfg, params, reqs[0].prompt, "naive")
        embed[tok, 0] = old
        nudge = rel_err(nudged, served_prefill(cfg, params, reqs[0].prompt,
                                               "naive"))[1]
    return max(probe.errs), len(probe.errs), worst, nudge, plains


def log_prefill_controls(cfg, worst, nudge) -> None:
    log(f"{cfg.name} bf16 prefill logits vs the plain path, rel up to: "
        f"kernel {worst['kernel']:.3e}, library attention "
        f"{worst['library']:.3e}, the plain path with one embedding "
        f"element one ulp off {nudge:.3e} (PREFILL_RTOL {PREFILL_RTOL:g}"
        + (" is met)" if worst["kernel"] <= PREFILL_RTOL
           else " is met by none: not asserted for this model)"))


def bf16_parity(cfg, params, reqs) -> None:
    """zamba2, a MoE model or a dense arch in bf16, kernel path against
    plain path; the kernel acts only in the prefills (a decode step runs
    the same plain code on both paths).  Asserted: at every attention call
    of every served prefill, the kernel's output on the plain path's own
    q, k, v within FLASH_BF16_RTOL of max|plain| (``probe_parity``); and
    the margin-aware check (MARGIN_RTOL) on the token each prefill emits,
    against the plain prefill's logits."""
    local, calls, worst, nudge, plain = probe_parity(cfg, params, reqs)
    first, first_agree, n_first = gap_stats(
        plain, [r.out[:1] for r in reqs])
    ok = local <= FLASH_BF16_RTOL and first <= MARGIN_RTOL
    log(f"{cfg.name} bf16 parity vs the plain path: at all {calls} "
        f"attention calls of the served prefills the kernel on the plain "
        f"path's q, k, v is within {local:.3e} of max|plain| (limit "
        f"{FLASH_BF16_RTOL:.3e}); the prefills' tokens {first_agree}/"
        f"{n_first} equal the plain argmax, the largest gap below the plain "
        f"maximum {first:.3e} of max|logits| (limit {MARGIN_RTOL:g})"
        + ("" if ok else "  FAIL"))
    log_prefill_controls(cfg, worst, nudge)
    assert local <= FLASH_BF16_RTOL, "the kernel disagrees inside the model"
    assert first <= MARGIN_RTOL, "a prefill's token is off the plain max"


def bf16_streams(cfg, params, reqs, seeds, asserted: bool) -> None:
    """The margin-aware check over every token of the bf16 streams against
    one full ``lm_forward`` (``token_margins``) for the kernel engine
    (``reqs`` at seed 0) and two controls, an engine with the library
    attention (SDPA) in the kernel's place and the plain engine itself
    (``impl="naive"``, no kernel at all), over the launcher's prompts at
    ``seeds``.  ``asserted`` (zamba2): the kernel engine's largest gap
    must stay within MARGIN_RTOL or within the controls' largest.  Else
    printed only: the MoE models' plain engine fails MARGIN_RTOL on the
    served prompts (a rounding difference in a prefill's caches flips
    their routers' top-k, and MLA's decode is absorbed in the latent space
    in fp32 where its forward rounds the decompressed k and v to bf16:
    PERF.md §6), and a random dense model's bar lies in its noise."""
    engines = (("kernel", "chunked"), ("library attention", "library"),
               ("plain (impl=naive)", "naive"))
    streams = {}                      # (engine, seed) -> token_margins
    for seed in seeds:
        for name, impl in engines:
            if (name, seed) == ("kernel", 0):
                runs = reqs                      # the timed engine run
            else:
                with AttentionProbe():
                    outs = engine_tokens(cfg, params, impl, seed)
                runs = [types.SimpleNamespace(prompt=p, out=o)
                        for p, o in zip(rec_prompts(cfg, seed), outs)]
            streams[name, seed] = token_margins(cfg, params, runs)
    gap = max(g for (name, _), (g, _, _) in streams.items()
              if name == "kernel")
    controls = max(g for (name, _), (g, _, _) in streams.items()
                   if name != "kernel")
    ok = gap <= max(MARGIN_RTOL, controls)
    for seed in seeds:
        log(f"{cfg.name} bf16 streams against one lm_forward, the "
            f"launcher's prompts at seed {seed}: " + "; ".join(
                f"the {name} engine's tokens {agree}/{total} on the plain "
                f"argmax, largest gap {g:.3e}"
                for (name, sd), (g, agree, total) in streams.items()
                if sd == seed))
    log(f"{cfg.name} bf16 streams: the kernel engine's largest gap "
        f"{gap:.3e}, the engines without the kernel {controls:.3e} "
        + (f"(asserted: within MARGIN_RTOL {MARGIN_RTOL:g} or the "
           f"controls' largest)" + ("" if ok else "  FAIL")
           if asserted else "(not asserted)"))
    assert ok or not asserted, \
        "an engine token is off the plain max past the engines without " \
        "the kernel"


def served_prefill(cfg, params, prompt, impl: str) -> torch.Tensor:
    """The last-token logits of a prompt prefilled as the engine does: an
    attention-only model right-padded to its 16-token bucket, a model with
    a recurrent block at its exact length."""
    from repro_torch.models.transformer import lm_prefill
    from repro_torch.serve import ServeEngine
    n = len(prompt)
    if all(k == "attn" for k in cfg.pattern):
        padded = np.zeros(ServeEngine._bucket(n), np.int64)
        padded[:n] = prompt
        last = n - 1
    else:
        padded, last = np.asarray(prompt, np.int64), None
    tok = torch.as_tensor(padded, device=params["embed"].device)[None]
    return lm_prefill(params, cfg, tokens=tok, max_len=LM_MAX_LEN, impl=impl,
                      last_index=last)[0]


def tree_to(tree, to):
    """Every leaf of a nested dict ``.to(to)`` (a dtype or a device)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, to) for k, v in tree.items()}
    return tree.to(to)


def long_prompt(cfg, dev) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, LONG_PROMPT)), device=dev)


def lm_fp32_parity(cfg, params, prompts) -> None:
    """Kernel path against plain path at full width with the weights in
    fp32, over every served prompt (prefilled as the engine does) and the
    2048-token prompt: the bf16 comparison is dominated by roundings the
    random model amplifies through its layers, the fp32 one holds the
    kernel's own error."""
    from repro_torch.models.transformer import lm_prefill
    p32 = tree_to(params, torch.float32)
    rels = [rel_err(*(served_prefill(cfg, p32, p, impl)
                      for impl in ("chunked", "naive")))[1] for p in prompts]
    tok = long_prompt(cfg, p32["embed"].device)
    rels.append(rel_err(*(lm_prefill(p32, cfg, tokens=tok,
                                     max_len=LONG_PROMPT, impl=impl)[0]
                          for impl in ("chunked", "naive")))[1])
    ok = max(rels) <= E2E_RTOL
    log(f"{cfg.name} in fp32, kernel vs plain path prefill logits: rel up to "
        f"{max(rels[:-1]):.3e} over the {len(prompts)} served prompts, "
        f"{rels[-1]:.3e} at {LONG_PROMPT} tokens (limit {E2E_RTOL:g})"
        + ("" if ok else "  FAIL"))
    assert ok, "fp32 prefill logits disagree"


def lm_long_prefill(cfg, params, kernels, card) -> dict[str, int]:
    """One ``lm_prefill`` of a 2048-token prompt: counts set to 0 just
    before, read just after; logits against the plain path; host times
    of both paths in turns."""
    from repro_torch.models.transformer import lm_prefill
    tok = long_prompt(cfg, params["embed"].device)

    def run(impl):
        return lm_prefill(params, cfg, tokens=tok, max_len=LONG_PROMPT,
                          impl=impl)

    for fn in kernels.values():
        fn.launches = 0
    logits, caches, length = run("chunked")
    torch.cuda.synchronize()
    launches = lm_counts(kernels, {"flash_attention": cfg.n_layers},
                         f"{LM_ARCH} prefill of {LONG_PROMPT} tokens")
    assert tuple(logits.shape) == (1, cfg.vocab) and length == LONG_PROMPT
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    err, rel = rel_err(logits, run("naive")[0])
    log(f"{LM_ARCH} prefill of {LONG_PROMPT} tokens: kernel vs plain path "
        f"logits max|d|={err:.3e} rel={rel:.3e} (limit {PREFILL_RTOL:g})"
        + ("" if rel <= PREFILL_RTOL else "  FAIL"))
    assert rel <= PREFILL_RTOL, "2048-token prefill disagrees"
    times = {"chunked": [], "naive": []}
    for turn in range(3):
        for impl in (("chunked", "naive") if turn % 2 == 0
                     else ("naive", "chunked")):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            run(impl)
            torch.cuda.synchronize()
            times[impl].append((time.perf_counter() - t_a) * 1e3)
    log(f"{LM_ARCH} prefill of {LONG_PROMPT} tokens (host clock, "
        f"synchronized, 3 each): kernel path p50 "
        f"{statistics.median(times['chunked']):.4f} ms, plain path p50 "
        f"{statistics.median(times['naive']):.4f} ms  [{card}]")
    return launches


def flash_share(events, what: str, card: str) -> None:
    """Flash's share of the device busy time of a profiled window."""
    if not events:
        return
    flash = [e for e in events if kernel_base(e.name).startswith(
        DEVICE_PREFIX["flash_attention"])]
    busy = device_busy(events)[0]
    took = device_busy(flash)[0] if flash else 0.0
    log(f"  {what}: flash {len(flash)} kernels, {took / 1e3:.4f} ms of "
        f"{busy / 1e3:.4f} ms device busy ({took / busy:.4f})  [{card}]")


def lm_profiles(cfg, params, eng, card) -> None:
    """Device busy time and idle share of a served prefill (bucket 48),
    a decode step over all slots, and the 2048-token prefill, and flash's
    share of each."""
    from repro_torch.models.transformer import lm_decode_step, lm_prefill
    dev = params["embed"].device
    rng = np.random.default_rng(1)
    tok48 = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 48)), device=dev)
    tok_long = torch.as_tensor(rng.integers(0, cfg.vocab, (1, LONG_PROMPT)),
                               device=dev)
    step_tok = torch.as_tensor(rng.integers(0, cfg.vocab, LM_SLOTS),
                               device=dev)
    lengths = torch.arange(LM_SLOTS, device=dev) * 8 + 40
    for fn, n, what, per in (
            (lambda: lm_prefill(params, cfg, tokens=tok48,
                                max_len=LM_MAX_LEN, last_index=40),
             5, "prefills of a 48-token bucket", "prefill"),
            (lambda: lm_decode_step(params, cfg, step_tok, eng.caches,
                                    lengths),
             10, f"decode steps over {LM_SLOTS} slots", "step"),
            (lambda: lm_prefill(params, cfg, tokens=tok_long,
                                max_len=LONG_PROMPT),
             1, f"prefill of {LONG_PROMPT} tokens", "prefill")):
        flash_share(profile_window(fn, n, f"{cfg.name} {what}", per, card),
                    f"{cfg.name} {what}", card)


# ---- the recurrent family ------------------------------------------------
def rec_apps(cfg) -> int:
    """Shared-block applications a forward makes: zamba2's flash launches
    a prefill (none without shared blocks: xlstm has no attention)."""
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every \
        else 0


def attn_calls(cfg) -> int:
    """Flash launches a forward or a prefill makes: one per attention
    layer and per shared-block application."""
    return cfg.pattern.count("attn") + rec_apps(cfg)


def rec_prompts(cfg, seed: int = 0) -> list[np.ndarray]:
    from repro_torch.launch.serve import prompts
    return prompts(cfg.vocab, LM_REQUESTS, LM_PROMPT_LEN, seed)


def rec_flash_cases(cfg, rng, dev) -> dict[str, list[Case]]:
    """zamba2's flash calls: ``(1, 32, 32, S, S, 80)`` at every served
    (exact) prompt length, weighted by its share of the requests, and at
    2048 tokens, in bf16 (the path's type) and fp32 (checks only).  D = 80
    runs the bf16 kernel's DP = 128 instantiation, columns 80-127
    masked."""
    h, d, n_apps = cfg.n_heads, cfg.resolved_head_dim, rec_apps(cfg)
    counts: dict[int, int] = {}
    for p in rec_prompts(cfg):
        counts[len(p)] = counts.get(len(p), 0) + 1
    serve_cases = []
    for s, n in sorted(counts.items()):
        shape = (1, h, cfg.n_kv_heads, s, s, d, True)
        serve_cases += [flash_case(shape, torch.bfloat16, rng, dev,
                                   per_request=n * n_apps / LM_REQUESTS),
                        flash_case(shape, torch.float32, rng, dev)]
    long = (1, h, cfg.n_kv_heads, LONG_PROMPT, LONG_PROMPT, d, True)
    return {"serve": serve_cases,
            "prefill-2048": [flash_case(long, torch.bfloat16, rng, dev,
                                        per_request=n_apps),
                             flash_case(long, torch.float32, rng, dev)]}


def engine_tokens(cfg, params, impl: str,
                  seed: int = 0) -> list[list[int]]:
    """The launcher's requests (its prompts at ``seed``) through a
    ``ServeEngine`` with attention ``impl``: each request's tokens."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      impl=impl)
    reqs = [eng.submit(p, max_new=LM_MAX_NEW)
            for p in rec_prompts(cfg, seed)]
    eng.run()
    assert all(r.done and len(r.out) == LM_MAX_NEW for r in reqs)
    return [r.out for r in reqs]


def rec_fp32_parity(cfg, p32) -> None:
    """The weights in fp32.  With attention (zamba2): the engine's kernel
    path gives the plain path's greedy tokens on all requests; without
    (xlstm): two engine runs give the same tokens.  Then prefill-then-
    decode (each prompt prefilled alone at its exact length, the rows
    decoded together on the engine's tokens) against one full
    ``lm_forward`` on the same tokens, every position's logits within
    E2E_RTOL of that request's max|logits|: in float64 (``layers.wide``:
    no fp32 rounding anywhere, plain attention), asserted; in fp32 on the
    engine's path, asserted wherever the forward's own two realizations
    of the recurrences (``rec_impl`` chunked and seq) agree within
    E2E_RTOL on the same tokens, else printed beside that gap (the random
    model carries fp32 roundings that far)."""
    impls = ("chunked", "naive") if rec_apps(cfg) else ("chunked",) * 2
    first, second = (engine_tokens(cfg, p32, impl) for impl in impls)
    same = sum(a == b for a, b in zip(first, second))
    what = ("kernel path vs plain path" if rec_apps(cfg)
            else "two runs of the engine")
    log(f"{cfg.name} in fp32, {what}: {same}/{LM_REQUESTS} requests give "
        f"the same {LM_MAX_NEW} greedy tokens"
        + ("" if same == LM_REQUESTS else "  FAIL"))
    assert same == LM_REQUESTS, f"{cfg.name}: fp32 engine tokens differ"
    from repro_torch.models.transformer import lm_forward
    f32 = decode_vs_forward(cfg, p32, first, "chunked")
    forms = max(rel_err(lm_forward(
        p32, cfg, continuation(p, out, p32)[None], rec_impl="seq")[0][
            0, len(p) - 1:], want)[1]
        for p, out, want in zip(rec_prompts(cfg), first, f32["forward"]))
    held = forms <= E2E_RTOL
    p64 = tree_to(p32, torch.float64)
    f64 = decode_vs_forward(cfg, p64, first, "naive")
    del p64
    free_cuda()
    ok = f64["rel"] <= E2E_RTOL and (f32["rel"] <= E2E_RTOL or not held)
    log(f"{cfg.name}, prefill then {LM_MAX_NEW - 1} decode steps vs one "
        f"lm_forward (limit {E2E_RTOL:g}): logits rel up to "
        f"{f64['rel']:.3e} in float64; {f32['rel']:.3e} in fp32 on the "
        f"engine's path, " + ("asserted" if held else "not asserted")
        + f" (the fp32 forward's chunked and seq recurrences differ by "
        f"{forms:.3e} on the same tokens); {f32['agree']}/{f32['total']} "
        f"fp32 argmaxes are the engine's tokens" + ("" if ok else "  FAIL"))
    assert f64["rel"] <= E2E_RTOL, f"{cfg.name}: decode disagrees"
    assert f32["rel"] <= E2E_RTOL or not held, \
        f"{cfg.name}: the engine's path disagrees with the full forward"


def continuation(prompt, out, params) -> torch.Tensor:
    """A prompt and its tokens but the last, as one sequence."""
    return torch.as_tensor(np.concatenate([prompt, out[:-1]]),
                           device=params["embed"].device)


def decode_vs_forward(cfg, params, outs, impl: str,
                      rec_impl: str = "chunked") -> dict:
    """Each launcher prompt prefilled alone, the rows' caches joined and
    decoded together on ``outs`` for LM_MAX_NEW - 1 steps, against
    ``lm_forward`` over prompt + outs (attention ``impl``, ``rec_impl``
    in the prefill and the forward; a decode step always steps token by
    token): the largest rel error over max|logits| of a request, the
    argmaxes equal to ``outs``, and the forward's logits."""
    from repro_torch.models.transformer import (lm_decode_step, lm_forward,
                                                lm_prefill)
    dev = params["embed"].device
    prompts = rec_prompts(cfg)
    heads, caches = [], []
    for p in prompts:
        logits, c, _ = lm_prefill(params, cfg, torch.as_tensor(
            p, device=dev)[None], max_len=LM_MAX_LEN, impl=impl,
            rec_impl=rec_impl)
        heads.append(logits)
        caches.append(c)
    cache = {key: {name: torch.cat([c[key][name] for c in caches], 1)
                   for name in stage} for key, stage in caches[0].items()}
    del caches
    lengths = torch.as_tensor([len(p) for p in prompts], device=dev)
    steps = [torch.cat(heads)]
    for t in range(LM_MAX_NEW - 1):
        toks = torch.as_tensor([o[t] for o in outs], device=dev)
        logits, cache = lm_decode_step(params, cfg, toks, cache,
                                       lengths + t)
        steps.append(logits)
    got = torch.stack(steps, 1)                       # (requests, new, V)
    forward, rels = [], []
    for i, p in enumerate(prompts):
        want = lm_forward(params, cfg, continuation(p, outs[i], params)[None],
                          impl=impl, rec_impl=rec_impl)[0][0, len(p) - 1:]
        forward.append(want)
        rels.append(rel_err(got[i], want)[1])
    agree = int((got.argmax(-1).cpu() == torch.as_tensor(outs)).sum())
    return {"rel": max(rels), "agree": agree, "total": got.shape[0]
            * got.shape[1], "forward": forward}


def profile_busy(fn, n: int, what: str, per: str, card: str,
                 bracket: bool = True, tries: int = 3) -> float | None:
    """``profile_window`` bracketed on the card, taken again up to
    ``tries`` times where a marker was lost; unless ``bracket`` is False
    (a call of tens of thousands of kernels loses at most a few at an
    unbracketed window's ends, and a warm-up call under the profiler
    would double its cost).  Returns the device busy time per call in ms
    (None where no event was recorded)."""
    for _ in range(tries if bracket else 1):
        events = profile_window(fn, n, what, per, card,
                                warm=fn if bracket else None)
        if events:
            return device_busy(events)[0] / n / 1e3
    return None


def rec_long_prefill(cfg, params, kernels, card,
                     timed: bool = True) -> dict[str, int]:
    """One 2048-token ``lm_prefill``: counts set to 0 just before, read
    just after (the attention calls through the kernel, each held to the
    plain core on the same inputs, as in ``bf16_parity``); with ``timed``
    (the phase's own flag run) the host p50 of 3."""
    from repro_torch.models.transformer import lm_prefill
    tok = long_prompt(cfg, params["embed"].device)

    def run(impl="chunked"):
        return lm_prefill(params, cfg, tokens=tok, max_len=LONG_PROMPT,
                          impl=impl)

    for fn in kernels.values():
        fn.launches = 0
    logits, _, length = run()
    torch.cuda.synchronize()
    want = {"flash_attention": attn_calls(cfg)} if attn_calls(cfg) else {}
    launches = lm_counts(kernels, want,
                         f"{cfg.name} prefill of {LONG_PROMPT} tokens")
    assert tuple(logits.shape) == (1, cfg.vocab) and length == LONG_PROMPT
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    if attn_calls(cfg):
        with AttentionProbe() as probe:
            err, rel = rel_err(logits, run("probe")[0])
        local = max(probe.errs)
        log(f"{cfg.name} prefill of {LONG_PROMPT} tokens: the kernel at its "
            f"{len(probe.errs)} calls on the plain path's q, k, v within "
            f"{local:.3e} of max|plain| (limit {FLASH_BF16_RTOL:.3e}); "
            f"logits vs the plain path max|d|={err:.3e} rel={rel:.3e} "
            f"(PREFILL_RTOL {PREFILL_RTOL:g}, not asserted for this model: "
            f"its bf16 parity checks)" + ("" if local <= FLASH_BF16_RTOL
                                   else "  FAIL"))
        assert local <= FLASH_BF16_RTOL, "2048-token prefill: kernel differs"
    if not timed:
        return launches
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_a) * 1e3)
    log(f"{cfg.name} prefill of {LONG_PROMPT} tokens (host clock, "
        f"synchronized): p50 {statistics.median(times):.4f} ms of "
        f"{', '.join(f'{t:.4f}' for t in times)}  [{card}]")
    return launches


def rec_scan_times(cfg, params, eng, card) -> None:
    """Device busy time, kernels and idle share of a decode step over the
    slots and of one prefill (a 47-token prompt, the longest served, and
    2048 tokens); then the recurrences' plain paths in a step and in the
    2048-token prefill, each called alone at the same shapes (the SSD
    scan: ``ssd_seq`` in a step, ``ssd_chunked`` in a prefill, for
    Mamba2; ``mlstm_seq`` / ``mlstm_chunked`` and the whole sLSTM block,
    its token loop, for xLSTM), times the layers of each kind, against
    the whole."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import unbind_params
    from repro_torch.models.transformer import (build_stages,
                                                lm_decode_step, lm_prefill)
    dev = params["embed"].device
    rng = np.random.default_rng(1)
    g = torch.Generator(device=dev).manual_seed(1)
    dt = params["embed"].dtype

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    step_tok = torch.as_tensor(rng.integers(0, cfg.vocab, LM_SLOTS),
                               device=dev)
    lengths = torch.arange(LM_SLOTS, device=dev) * 8 + 40
    whole = {}
    whole["step"] = profile_busy(
        lambda: lm_decode_step(params, cfg, step_tok, eng.caches, lengths),
        5, f"{cfg.name} decode steps over {LM_SLOTS} slots", "step", card)
    for s in (max(LM_PROMPT_LEN) - 1, LONG_PROMPT):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (1, s)), device=dev)
        whole[s] = profile_busy(
            lambda tok=tok: lm_prefill(params, cfg, tokens=tok,
                                       max_len=max(s, LM_MAX_LEN)),
            1, f"{cfg.name} prefills of {s} tokens", "prefill", card,
            bracket=s != LONG_PROMPT)
    kinds = {kind: cfg.pattern.count(kind) for kind in dict.fromkeys(
        cfg.pattern)}
    parts = {}                       # (kind, what) -> ms a call, layers
    for kind, n_layers in kinds.items():
        si = [k for k, _, _ in build_stages(cfg)].index(kind)
        p = unbind_params(params[f"stage_{si}"])[0]["body"]
        for what, b, S in (("step", LM_SLOTS, 1),
                           (LONG_PROMPT, 1, LONG_PROMPT)):
            if kind == "mamba2":
                sc = cfg.ssm
                H = sc.expand * cfg.d_model // sc.head_dim
                x = randn(b, S, H, sc.head_dim)
                dtv = ssm.softplus(randn(b, S, H, dtype=torch.float32))
                B, C = (randn(b, S, sc.n_groups, sc.d_state)
                        for _ in range(2))
                A = -torch.exp(p["A_log"])
                st = randn(b, H, sc.d_state, sc.head_dim,
                           dtype=torch.float32)
                fn = (lambda: ssm.ssd_seq(x, dtv, A, B, C, p["D"], state=st)
                      ) if what == "step" else (
                    lambda: ssm.ssd_chunked(x, dtv, A, B, C, p["D"],
                                            chunk=sc.chunk))
                name = "ssd_seq" if what == "step" else "ssd_chunked"
            elif kind == "mlstm":
                H = cfg.n_heads
                P = int(cfg.xlstm.proj_factor * cfg.d_model) // H
                q, k, v = (randn(b, S, H, P) for _ in range(3))
                li = randn(b, S, H, dtype=torch.float32)
                lf = torch.nn.functional.logsigmoid(
                    randn(b, S, H, dtype=torch.float32) + 4.0)
                st = ssm.mlstm_init_state(cfg, b, dt, device=dev)
                st = (st["C"], st["n"], st["m"])
                fn = (lambda: ssm.mlstm_seq(q, k, v, li, lf, state=st)
                      ) if what == "step" else (
                    lambda: ssm.mlstm_chunked(q, k, v, li, lf,
                                              chunk=cfg.xlstm.chunk))
                name = "mlstm_seq" if what == "step" else "mlstm_chunked"
            else:
                x = randn(b, S, cfg.d_model)
                fn = lambda: ssm.slstm_block(p, x, cfg)  # noqa: E731
                name = "slstm_block"
            parts[(kind, what)] = (name, profile_busy(
                fn, 1 if S == LONG_PROMPT else 5,
                f"{cfg.name} {name} calls at b={b}, S={S}", "call", card,
                bracket=not (S == LONG_PROMPT and kind == "slstm")),
                n_layers)
    for what in ("step", LONG_PROMPT):
        label = ("a decode step" if what == "step"
                 else f"a {what}-token prefill")
        for kind in kinds:
            name, ms, n_layers = parts[(kind, what)]
            if ms is None or whole[what] is None:
                log(f"{cfg.name} {name} in {label}: not measured (no "
                    f"device events)")
                continue
            log(f"{cfg.name} {name} in {label}: {ms:.5f} ms device busy a "
                f"call x {n_layers} layers = {ms * n_layers:.4f} ms of the "
                f"whole's {whole[what]:.4f} ms "
                f"({ms * n_layers / whole[what]:.3f})  [{card}]")


_LAST_STAMP = [STARTED]


def stamp(what: str) -> None:
    """The wall time since the script started, after a phase, and the
    seconds since the previous stamp."""
    now = time.perf_counter()
    log(f"[{now - STARTED:.1f} s] {what} done (+{now - _LAST_STAMP[0]:.1f} "
        f"s)")
    _LAST_STAMP[0] = now


def rec_arch(arch, kernels, card, rng, dev, timed: bool) -> list[dict]:
    """One arch of the recurrent family at its published config: served
    through its entry point (counts set to 0 just before, read just
    after), stepped and timed through a ``ServeEngine``, zamba2's flash
    calls checked at their shapes, zamba2's bf16 parity and fp32 prefill
    logits, the 2048-token prefill (zamba2's flash calls in it held to
    the plain core); with ``timed`` (``--rec``) also zamba2's bf16
    streams, the fp32 and float64 checks (``rec_fp32_parity``), that
    prefill's host times and the device profiles (``rec_scan_times``),
    and xlstm's 2048-token prefill, which holds no kernel; returns
    zamba2's kernel rows."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve as serve_lm
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.optim import tree_leaves
    cfg = configs.get(arch)
    n_apps = rec_apps(cfg)
    want = {"flash_attention": LM_REQUESTS * n_apps} if n_apps else {}
    cases = rec_flash_cases(cfg, rng, dev) if n_apps else {}
    max_err = {path: {"flash_attention": max(check_case(c) for c in cs)}
               for path, cs in cases.items()}
    for fn in kernels.values():
        fn.launches = 0
    res = serve_lm(arch, smoke=False, device="cuda")
    torch.cuda.synchronize()
    launches = {"serve": lm_counts(kernels, want, f"{arch} serve")}
    log(f"{arch} serve (launch.serve.serve, full config): "
        f"{json.dumps(res)}")
    assert res["requests"] == LM_REQUESTS
    assert res["tokens_generated"] == LM_REQUESTS * LM_MAX_NEW, res
    free_cuda()
    params = init_lm(0, cfg, device="cuda")
    log(f"{arch}: {sum(t.numel() for t in tree_leaves(params)) / 1e9:.4f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated  [{card}]")
    eng, reqs = lm_engine_run(cfg, params, kernels, card, want)
    stamp(f"{arch} serve and engine run")
    if n_apps:
        bf16_parity(cfg, params, reqs)
        if timed:
            bf16_streams(cfg, params, reqs, STREAM_SEEDS, asserted=True)
        stamp(f"{arch} bf16 parity")
    if n_apps or timed:
        launches["prefill-2048"] = rec_long_prefill(cfg, params, kernels,
                                                    card, timed)
    if timed:
        rec_scan_times(cfg, params, eng, card)
    stamp(f"{arch} 2048-token prefill and profiles")
    del eng, reqs
    free_cuda()
    p32 = tree_to(params, torch.float32) if n_apps or timed else None
    del params
    free_cuda()
    if n_apps:
        lm_fp32_parity(cfg, p32, rec_prompts(cfg))
    if timed:
        rec_fp32_parity(cfg, p32)
    stamp(f"{arch} fp32 and float64 parity")
    del p32
    free_cuda()
    return arch_rows(arch, cases, launches, n_apps, max_err, card, timed,
                     "at its exact prompt length")


def arch_rows(arch, cases, launches, n, max_err, card, timed: bool,
              where: str) -> list[dict]:
    """The kernel rows of an LM arch's paths that this run drove (those in
    ``launches``): ``serve``, a request's prefill of ``n`` launches
    ``where``, and ``prefill-2048``; ``timed`` as ``kernel_rows``."""
    rows = []
    for path, path_cases in cases.items():
        if path not in launches:
            continue             # checked above; not run on this run's path
        rows += kernel_rows(
            f"{arch}-{path}", path_cases, launches[path],
            {"flash_attention": n}, max_err[path], card,
            unit=(f"ms per {arch} served request: its prefill's {n} "
                  f"launches {where}, mean over the {LM_REQUESTS} requests"
                  if path == "serve" else
                  f"ms per {LONG_PROMPT}-token {arch} prefill: sum over "
                  f"its {n} launches"), timed=timed)
    stamp(f"{arch} kernel rows")
    return rows


def rec_phase(kernels, card, timed: bool) -> list[dict]:
    """The recurrent family (``--rec``: ``timed``): zamba2-2.7b and
    xlstm-350m."""
    rng = np.random.default_rng(0)
    rows = []
    for arch in REC_ARCHS:
        rows += rec_arch(arch, kernels, card, rng, torch.device("cuda"),
                         timed)
        free_cuda()
    return rows


# ---- the mixtures of experts ----------------------------------------------
def depth_config(arch: str, n_layers: int | None = None):
    """The published config, only its depth cut to ``n_layers`` where
    given (deepseek keeps its 3 dense layers first); the width and the cut
    printed."""
    from repro_torch import configs
    from repro_torch.models.transformer import build_stages
    full = configs.get(arch)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    width = [f"d {cfg.d_model}", f"{cfg.n_heads}/{cfg.n_kv_heads} heads",
             f"vocab {cfg.vocab}"]
    if cfg.attn_type == "mla":
        m = cfg.mla
        width.append(f"MLA q_lora {m.q_lora_rank} kv_lora "
                     f"{m.kv_lora_rank} nope {m.nope_head_dim} rope "
                     f"{m.rope_head_dim} v {m.v_head_dim}")
    else:
        width.append(f"head dim {cfg.resolved_head_dim}")
    if cfg.moe is not None:
        width.append(f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
                     f"{cfg.moe.d_ff_expert}, {cfg.moe.router} router, "
                     f"{cfg.moe.n_shared} shared")
    else:
        width.append(f"d_ff {cfg.d_ff} ({cfg.mlp_act})")
    width += [what for flag, what in (
        (cfg.qkv_bias, "qkv biases"), (cfg.qk_norm, "qk-norm"),
        (cfg.pos_emb == "sinusoidal", "sinusoidal positions"),
        (not cfg.embed_inputs, "embeddings from outside")) if flag]
    if cfg.n_layers == full.n_layers:
        cut = f"not cut ({cfg.n_layers} layers)"
    else:
        n_moe = sum(len(idxs) for _, variant, idxs in build_stages(cfg)
                    if variant == "moe")
        cut = (f"depth cut n_layers {full.n_layers} -> {cfg.n_layers} "
               f"({cfg.n_layers - n_moe} dense + {n_moe} MoE)")
    log(f"{arch}: published width ({', '.join(width)}; {cfg.dtype}); "
        f"{cut}, {cfg.params_count() / 1e9:.3f} B params")
    return cfg


def head_dims(cfg) -> tuple[int, int]:
    """(q·k head dim, v head dim) of the model's attention."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return m.nope_head_dim + m.rope_head_dim, m.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def arch_flash_cases(cfg, rng, dev) -> dict[str, list[Case]]:
    """The flash kernel's calls on an attention-only model's path: the served
    prefills (buckets of 16, weighted by their share of the requests, one
    launch a layer) and a 2048-token prefill, in bf16 (the path's type)
    and fp32 (checks only), and at the model's head dims a continuation
    (Sq < Sk) and rows with no live key (Sq > Sk), in both types."""
    hq, hkv, n = cfg.n_heads, cfg.n_kv_heads, attn_calls(cfg)
    d, dv = head_dims(cfg)
    bf16, f32 = torch.bfloat16, torch.float32
    serve = []
    for s, count in sorted(lm_buckets(cfg).items()):
        shape = (1, hq, hkv, s, s, d, True)
        serve += [flash_case(shape, bf16, rng, dev, dv=dv,
                             per_request=count * n / LM_REQUESTS),
                  flash_case(shape, f32, rng, dev, dv=dv)]
    for shape in ((1, hq, hkv, 64, 256, d, True),
                  (1, hq, hkv, 80, 48, d, True)):
        serve += [flash_case(shape, dt, rng, dev, dv=dv)
                  for dt in (f32, bf16)]
    long = (1, hq, hkv, LONG_PROMPT, LONG_PROMPT, d, True)
    return {"serve": serve,
            "prefill-2048": [flash_case(long, bf16, rng, dev, dv=dv,
                                        per_request=n),
                             flash_case(long, f32, rng, dev, dv=dv)]}


def arch_fp32(cfg, kernels, card) -> None:
    """The weights of ``cfg`` in fp32 (drawn fresh): the kernel path's
    prefill logits over the served prompts and 2048 tokens within
    E2E_RTOL of the plain path's (``lm_fp32_parity``), the
    engine's greedy tokens equal on both paths, and for an arch fed
    embeddings from outside, its prefill and decode from them
    (``embeds_parity``)."""
    from repro_torch.models.transformer import init_lm
    arch = cfg.name
    p32 = init_lm(0, cfg, dtype=torch.float32, device="cuda")
    log(f"{arch} fp32: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated  [{card}]")
    lm_fp32_parity(cfg, p32, rec_prompts(cfg))
    for fn in kernels.values():
        fn.launches = 0
    first = engine_tokens(cfg, p32, "chunked")
    launched = kernels["flash_attention"].launches
    second = engine_tokens(cfg, p32, "naive")
    same = sum(a == b for a, b in zip(first, second))
    log(f"{arch} in fp32, the engine's kernel path ({launched} flash "
        f"launches) vs its plain path: {same}/{LM_REQUESTS} requests give "
        f"the same {LM_MAX_NEW} greedy tokens"
        + ("" if same == LM_REQUESTS else "  FAIL"))
    assert launched == LM_REQUESTS * attn_calls(cfg), launched
    assert same == LM_REQUESTS, f"{arch}: fp32 engine tokens differ"
    if not cfg.embed_inputs:
        embeds_parity(cfg, p32, kernels)


def moe_arch(arch, kernels, card, rng, dev, timed: bool) -> list[dict]:
    """One MoE model at its published width, its depth cut: the flash
    kernel at its shapes against its plain version, the launcher's
    requests through a ``ServeEngine`` (counts set to 0 just before, read
    just after), the bf16 parity checks, the 2048-token prefill (its flash
    calls held to the plain core), with ``timed`` (``--moe``) that
    prefill's host times, the profiles and the fp32 check; returns its
    kernel rows."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.optim import tree_leaves
    cfg = depth_config(arch, MOE_LAYERS[arch])
    n = attn_calls(cfg)
    cases = arch_flash_cases(cfg, rng, dev)
    max_err = {path: {"flash_attention": max(check_case(c) for c in cs)}
               for path, cs in cases.items()}
    stamp(f"{arch} kernel checks")
    params = init_lm(0, cfg, device="cuda")
    log(f"{arch}: {sum(t.numel() for t in tree_leaves(params)) / 1e9:.4f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated  [{card}]")
    eng, reqs = lm_engine_run(cfg, params, kernels, card,
                              {"flash_attention": LM_REQUESTS * n})
    launches = {"serve": {name: fn.launches for name, fn in kernels.items()}}
    assert all(r.done and len(r.out) == LM_MAX_NEW for r in reqs)
    stamp(f"{arch} engine run")
    bf16_parity(cfg, params, reqs)
    if timed:
        bf16_streams(cfg, params, reqs, (0,), asserted=False)
    stamp(f"{arch} bf16 parity")
    launches["prefill-2048"] = rec_long_prefill(cfg, params, kernels, card,
                                                timed)
    if timed:
        lm_profiles(cfg, params, eng, card)
    stamp(f"{arch} 2048-token prefill and profiles")
    del eng, reqs, params
    free_cuda()
    if timed:
        arch_fp32(depth_config(arch, MOE_FP32_LAYERS[arch]), kernels, card)
        free_cuda()
        stamp(f"{arch} fp32 parity")
    return arch_rows(arch, cases, launches, n, max_err, card, timed,
                     "at its 16-token bucket")


def moe_phase(kernels, card, timed: bool) -> list[dict]:
    """The mixtures of experts (``--moe``: ``timed``): deepseek-v3-671b and
    grok-1-314b."""
    rng = np.random.default_rng(0)
    rows = []
    for arch in MOE_LAYERS:
        rows += moe_arch(arch, kernels, card, rng, torch.device("cuda"),
                         timed)
        free_cuda()
    return rows


# ---- the last four dense archs --------------------------------------------
def fitting_config(arch: str, n_layers: int | None, elem_bytes: int):
    """``depth_config``, with the weights (``elem_bytes`` an element)
    reckoned against the card's free memory and printed: fails unless they
    leave DENSE_HEADROOM free (a leak or a grown reserve of an earlier
    phase shows here; the depth is never cut at run time)."""
    free_cuda()
    cfg = depth_config(arch, n_layers)
    free, total = torch.cuda.mem_get_info()
    need = cfg.params_count() * elem_bytes
    ok = need + DENSE_HEADROOM <= free
    log(f"{arch}: weights {need / 2**30:.3f} GiB ({elem_bytes} bytes an "
        f"element) and {DENSE_HEADROOM / 2**30:.0f} GiB of headroom; the "
        f"card has {free / 2**30:.3f} GiB free of {total / 2**30:.3f} "
        f"(allocated {torch.cuda.memory_allocated() / 2**30:.3f}, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.3f})"
        + ("" if ok else "  FAIL"))
    assert ok, f"{arch}: the weights and the headroom outgrow the free memory"
    return cfg


def core_checks(cfg, rng, dev) -> None:
    """The plain ``tri`` and ``chunked_scan`` attention cores on the card in
    fp32, at the model's served buckets and at 2048 tokens (``(1, S, H,
    hd)``, causal), against the flash kernel's output on the same q, k and
    v: within KERNEL_RTOL of max|kernel|."""
    from repro_torch.models import attention
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    worst = {"tri": 0.0, "chunked_scan": 0.0}
    sizes = sorted(lm_buckets(cfg)) + [LONG_PROMPT]
    for s in sizes:
        q, k, v = (torch.tensor(rng.standard_normal((1, s, h, d)),
                                dtype=torch.float32, device=dev)
                   for h in (hq, hkv, hkv))
        want = attention.flash_chunked_attention(q, k, v, causal=True)
        for impl in worst:
            got = attention.ATTN_IMPLS[impl](q, k, v, causal=True)
            worst[impl] = max(worst[impl], rel_err(got, want)[1])
    ok = max(worst.values()) <= KERNEL_RTOL
    log(f"{cfg.name} attention cores in fp32 against the flash kernel at "
        f"(1, S, {hq}/{hkv}, {d}), S in {sizes}: " + ", ".join(
            f"{impl} rel up to {err:.3e}" for impl, err in worst.items())
        + f" (limit {KERNEL_RTOL:g})" + ("" if ok else "  FAIL"))
    assert ok, "the tri or chunked_scan core disagrees with the kernel"


def embeds_parity(cfg, p32, kernels) -> None:
    """An arch fed embeddings from outside, in fp32: ``lm_prefill(embeds=)``
    of ``synthetic_embeds`` at the served buckets' lengths (a row each) and
    at 2048 tokens, on the kernel path (its flash launches counted) and
    the plain path (``impl="naive"``): last-token logits within E2E_RTOL
    of max|logits|; then, the bucket rows' caches joined, EMBED_DECODE_STEPS
    greedy ``lm_decode_step``s on each path, every row at its own length
    (musicgen's sinusoidal table at each row's position): the tokens equal
    on both paths."""
    from repro_torch.data import synthetic_embeds
    from repro_torch.models.transformer import lm_decode_step, lm_prefill
    dev = p32["embed"].device
    lengths = sorted(lm_buckets(cfg))
    rows = [synthetic_embeds(i, 1, s, cfg.d_model, device=dev)
            for i, s in enumerate(lengths)]
    long = synthetic_embeds(len(lengths), 1, LONG_PROMPT, cfg.d_model,
                            device=dev)
    heads, toks = {}, {}
    for impl in ("chunked", "naive"):
        for fn in kernels.values():
            fn.launches = 0
        outs = [lm_prefill(p32, cfg, embeds=x, max_len=LM_MAX_LEN,
                           impl=impl) for x in rows]
        heads[impl] = [o[0] for o in outs] + [lm_prefill(
            p32, cfg, embeds=long, max_len=LONG_PROMPT, impl=impl)[0]]
        if impl == "chunked":
            torch.cuda.synchronize()
            launched = kernels["flash_attention"].launches
        cache = {key: {name: torch.cat([o[1][key][name] for o in outs], 1)
                       for name in stage}
                 for key, stage in outs[0][1].items()}
        del outs
        length = torch.as_tensor(lengths, device=dev)
        logits, out = torch.cat(heads[impl][:-1]), []
        for t in range(EMBED_DECODE_STEPS):
            out.append(logits.argmax(-1))
            logits, cache = lm_decode_step(p32, cfg, out[-1], cache,
                                           length + t)
        out.append(logits.argmax(-1))
        toks[impl] = torch.stack(out, 1).tolist()
        del cache
    rels = [rel_err(a, b)[1] for a, b in zip(heads["chunked"],
                                             heads["naive"])]
    same = sum(a == b for a, b in zip(toks["chunked"], toks["naive"]))
    want = attn_calls(cfg) * (len(lengths) + 1)
    ok = max(rels) <= E2E_RTOL and same == len(lengths) and launched == want
    log(f"{cfg.name} in fp32 from embeddings fed from outside, kernel path "
        f"({launched} flash launches) vs plain path: prefill logits rel up "
        f"to {max(rels[:-1]):.3e} at lengths {lengths}, {rels[-1]:.3e} at "
        f"{LONG_PROMPT} (limit {E2E_RTOL:g}); {same}/{len(lengths)} rows "
        f"give the same {EMBED_DECODE_STEPS + 1} greedy tokens over "
        f"{EMBED_DECODE_STEPS} decode steps" + ("" if ok else "  FAIL"))
    assert launched == want, (launched, want)
    assert max(rels) <= E2E_RTOL, "embeddings prefill logits disagree"
    assert same == len(lengths), "embeddings decode tokens differ"


def dense_arch(arch, kernels, card, rng, dev, timed: bool) -> list[dict]:
    """One of the last four dense archs at its published width, its depth
    cut where DENSE_LAYERS says: the flash kernel at its shapes against its
    plain version, DENSE_SERVE (whole) through ``launch.serve.serve``, the
    launcher's requests through a ``ServeEngine`` (counts set to 0 just
    before, read just after), the bf16 parity checks, with ``timed``
    (``--dense``) the 2048-token prefill and the profiles, the fp32
    checks (``arch_fp32``) and on DENSE_CORES the plain attention cores;
    returns its kernel rows."""
    from repro_torch.launch.serve import serve as serve_lm
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.optim import tree_leaves
    cfg = fitting_config(arch, DENSE_LAYERS[arch], 2)
    n = attn_calls(cfg)
    cases = arch_flash_cases(cfg, rng, dev)
    max_err = {path: {"flash_attention": max(check_case(c) for c in cs)}
               for path, cs in cases.items()}
    stamp(f"{arch} kernel checks")
    want = {"flash_attention": LM_REQUESTS * n}
    if arch == DENSE_SERVE:
        for fn in kernels.values():
            fn.launches = 0
        res = serve_lm(arch, smoke=False, device="cuda")
        torch.cuda.synchronize()
        lm_counts(kernels, want, f"{arch} serve")
        log(f"{arch} serve (launch.serve.serve, full config): "
            f"{json.dumps(res)}")
        assert res["requests"] == LM_REQUESTS
        assert res["tokens_generated"] == LM_REQUESTS * LM_MAX_NEW, res
        free_cuda()
        stamp(f"{arch} launch.serve.serve")
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(0, cfg, device="cuda")
    log(f"{arch}: {sum(t.numel() for t in tree_leaves(params)) / 1e9:.4f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated  [{card}]")
    eng, reqs = lm_engine_run(cfg, params, kernels, card, want)
    launches = {"serve": {name: fn.launches for name, fn in kernels.items()}}
    assert all(r.done and len(r.out) == LM_MAX_NEW for r in reqs)
    log(f"{arch}: peak device memory of the engine run "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(max_memory_allocated)  [{card}]")
    stamp(f"{arch} engine run")
    bf16_parity(cfg, params, reqs)
    if timed:
        bf16_streams(cfg, params, reqs, (0,), asserted=False)
    stamp(f"{arch} bf16 parity")
    if timed:
        launches["prefill-2048"] = rec_long_prefill(cfg, params, kernels,
                                                    card)
        lm_profiles(cfg, params, eng, card)
        stamp(f"{arch} 2048-token prefill and profiles")
    del eng, reqs, params
    free_cuda()
    if timed:
        arch_fp32(fitting_config(arch, DENSE_FP32_LAYERS[arch], 4), kernels,
                  card)
    if arch == DENSE_CORES and timed:
        core_checks(cfg, rng, dev)
    free_cuda()
    if timed:
        stamp(f"{arch} fp32 parity")
    return arch_rows(arch, cases, launches, n, max_err, card, timed,
                     "at its 16-token bucket")


def dense_phase(kernels, card, timed: bool) -> list[dict]:
    """The last four dense archs (``--dense``: ``timed``): chameleon-34b,
    codeqwen1.5-7b, qwen2-72b (4 layers) and musicgen-medium served, then
    musicgen-medium and codeqwen1.5-7b (4 layers) trained
    (DENSE_TRAIN)."""
    rng = np.random.default_rng(0)
    rows = []
    for arch in DENSE_LAYERS:
        rows += dense_arch(arch, kernels, card, rng, torch.device("cuda"),
                           timed)
        free_cuda()
    for arch, spec in DENSE_TRAIN.items():
        rows += family_arch(arch, spec, kernels, card, rng,
                            torch.device("cuda"), timed=timed)
        free_cuda()
    return rows


# ---- the training path ----------------------------------------------------
def flash_bwd_case(shape, dtype, rng, dev, per_request=0.0,
                   dv=None) -> Case:
    """The flash backward at ``(B, Hq, Hkv, Sq, Sk, D, causal)``, v's head
    dim ``dv`` (default D), on random q, k, v and dout, with the forward
    kernel's out and LSE.  Bound: q, k, v, o, dO, dq, dk and dv moved once
    and the fp32 LSE read; five products per live pair at the peak of the
    input's type: q·kᵀ, dq and dk of 2·D operations, dO·vᵀ and dv of 2·DV.
    The kernel issues q·kᵀ and dO·vᵀ twice (the dq pass recomputes them),
    in bf16 the three second-stage products BWD_PARTS times, and at (192,
    128) a third q·kᵀ (the dk/dv warps split by output).  Library: the
    backward alone of one ``F.scaled_dot_product_attention``
    (``enable_gqa``; same top-left caveat as ``flash_case``), by
    ``torch.autograd.grad`` on its graph, timed by events and by device
    time; both device times in bracketed windows
    (``device_breakdown``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    b, hq, hkv, sq, sk, d, causal = shape
    dv = dv or d
    q, k, v, dout = (torch.tensor(rng.standard_normal(sh),
                                  dtype=torch.float32, device=dev).to(dtype)
                     for sh in ((b, hq, sq, d), (b, hkv, sk, d),
                                (b, hkv, sk, dv), (b, hq, sq, dv)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    library = None
    if sq == sk or not causal:
        leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=True)
        library = lambda: torch.autograd.grad(  # noqa: E731
            sdpa, leaves, dout, retain_graph=True)
    bf16 = dtype == torch.bfloat16
    label = (f"flash_attention_bwd {str(dtype).split('.')[-1]} "
             f"q{tuple(q.shape)} "
             + (f"kv{tuple(k.shape)}" if dv == d else
                f"k{tuple(k.shape)} v{tuple(v.shape)}")
             + f" causal={causal}")
    pairs = 2.0 * b * hq * live_pairs(sq, sk, causal)
    parts = BWD_PARTS if bf16 else 1
    split = bf16 and d > 128          # the (192, 128) dk/dv kernel
    issued = (2 + split) * d + 2 * dv + parts * (2 * d + dv)
    return Case(
        "flash_attention_bwd", label,
        lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal=causal),
        lambda: ref.attention_bwd_ref(q, k, v, out, lse, dout,
                                      causal=causal), library,
        q.element_size() * 2.0 * (q.numel() + out.numel() + k.numel()
                                  + v.numel()) + 4.0 * b * hq * sq,
        (3 * d + 2 * dv) * pairs, per_request,
        rtol=FLASH_BF16_RTOL if bf16 else KERNEL_RTOL,
        rate=BF16_FLOPS if bf16 else FP32_FLOPS,
        run_flops=issued * pairs,
        bracketed=True)


def check_bwd_case(case: Case) -> float:
    """dq, dk and dv of the kernel against the plain version, each within
    ``case.rtol`` of its max|plain|, finite, and a second call's bits equal
    the first's.  Returns the largest max|kernel - plain|."""
    got, again, want = case.run(), case.run(), case.plain()
    torch.cuda.synchronize()
    errs, msgs, ok = [], [], True
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (case.label, name)
        assert torch.isfinite(g).all(), f"{case.label}: non-finite {name}"
        assert torch.equal(g, a), f"{case.label}: {name} differs between " \
            "two calls"
        err, rel = rel_err(g.float(), w.float())
        errs.append(err)
        ok &= rel <= case.rtol
        msgs.append(f"{name} max|d|={err:.3e} rel={rel:.3e}")
    msg = f"check {case.label}: " + ", ".join(msgs) + ", bit-equal twice"
    if case.library is not None:
        lib = case.library()
        msg += " (library rel " + ", ".join(
            f"{rel_err(x.float(), w.float())[1]:.3e}"
            for x, w in zip(lib, want)) + ")"
    log(msg + ("" if ok else "  FAIL"))
    assert ok, f"{case.label}: the backward kernel disagrees with its plain " \
        "version"
    return max(errs)


def train_cases(rng, dev, n_layers: int) -> list[Case]:
    """The training path's calls, weighted by their launches per step (the
    forward with its LSE and the backward at llama3.2-1b's training shape,
    bf16), and the same calls in fp32, qwen3-0.6b's 2048-token shape and
    the edge cases, checked and timed but off the path."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [flash_case(TRAIN_SHAPE, bf16, rng, dev, per_request=n_layers,
                        lse=True),
             flash_bwd_case(TRAIN_SHAPE, bf16, rng, dev,
                            per_request=n_layers),
             flash_case(TRAIN_SHAPE, f32, rng, dev, lse=True),
             flash_bwd_case(TRAIN_SHAPE, f32, rng, dev),
             flash_bwd_case(QWEN_BWD_SHAPE, bf16, rng, dev)]
    for shape in FLASH_BWD_EDGES:
        cases += [flash_bwd_case(shape, dt, rng, dev) for dt in (f32, bf16)]
    return cases


def flash_lse_checks(rng, dev) -> None:
    """The training forward (LSE written) gives the serving forward's (no
    LSE pointer) output bits; its LSE matches ``attention_lse_ref`` within
    KERNEL_RTOL of max|lse| (fp32 in both types), -inf exactly on the rows
    with no live key."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    worst = 0.0
    for shape in (TRAIN_SHAPE, QWEN_BWD_SHAPE, *FLASH_BWD_EDGES):
        b, hq, hkv, sq, sk, d, causal = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.tensor(rng.standard_normal(sh),
                                    dtype=torch.float32, device=dev)
                       .to(dtype) for sh in ((b, hq, sq, d), (b, hkv, sk, d),
                                             (b, hkv, sk, d)))
            served = flash_attention(q, k, v, causal=causal)
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           return_lse=True)
            _, want = ref.attention_lse_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert torch.equal(served, out), \
                f"{shape} {dtype}: the LSE pointer changed the output"
            dead = torch.isneginf(want)
            assert torch.equal(torch.isneginf(lse), dead), (shape, dtype)
            _, rel = rel_err(lse[~dead], want[~dead])
            worst = max(worst, rel)
    ok = worst <= KERNEL_RTOL
    log(f"check flash forward with LSE: output bits equal the serving "
        f"forward's at {2 + len(FLASH_BWD_EDGES)} shapes x 2 types; LSE rel "
        f"up to {worst:.3e} (limit {KERNEL_RTOL:g}), -inf exactly on the "
        f"rows with no live key" + ("" if ok else "  FAIL"))
    assert ok, "the forward's LSE disagrees with attention_lse_ref"


def free_cuda() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def loss_bar(what: str, hist) -> tuple[str, bool]:
    """The training loss bar on a whole curve: every loss finite, the last
    TRAIN_DROP below the first, none more than TRAIN_RISE above the first.
    -> (the line, the whole curve in it; whether the bar holds)."""
    drop = hist[0] - hist[-1]
    rise = max(hist) - hist[0]
    ok = (all(map(math.isfinite, hist)) and drop >= TRAIN_DROP
          and rise <= TRAIN_RISE)
    return (f"{what}: loss {hist[0]:.4f} -> {hist[-1]:.4f} (fell "
            f"{drop:.4f}, limit {TRAIN_DROP:g}; the highest {rise:.4f} above "
            f"the first, limit {TRAIN_RISE:g}); curve "
            f"{[round(x, 4) for x in hist]}" + ("" if ok else "  FAIL"), ok)


def train_batch(cfg, pipe, step: int) -> dict:
    """The pipeline's batch ``step``; for an arch fed embeddings from
    outside (``embed_inputs=False``) the frontend stub's frames or patches
    in place of the tokens: each token's row of a fixed codebook
    (``synthetic_embeds`` of seed 0, one row a token id), so the labels
    stay learnable from the inputs."""
    batch = pipe.batch(step)
    if cfg.embed_inputs:
        return batch
    from repro_torch.data import synthetic_embeds
    tokens = batch["tokens"]
    book = synthetic_embeds(0, 1, cfg.vocab, cfg.d_model,
                            device=tokens.device)[0]
    return {"embeds": book[tokens], "labels": batch["labels"]}


def train_fp32_parity(cfg, label: str = TRAIN_ARCH,
                      host: bool = False) -> None:
    """One full-width ``lm_loss`` and its grads with the weights cast to
    fp32 on one batch of the launcher's pipeline: the kernel path
    (``impl="chunked"``: flash forward and backward kernels) against the
    plain path (``"naive"``: autograd through plain attention).  ``host``:
    the kernel path's grads wait in host memory while the plain path runs
    (a model whose fp32 weights and two sets of grads outgrow the card),
    and come back one leaf at a time."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.step import leaf_grads, unread_leaf
    params = tree_to(init_lm(0, cfg, device="cuda"), torch.float32)
    free_cuda()
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = train_batch(cfg, TokenPipeline(cfg.vocab, TRAIN_SEQ,
                                           TRAIN_BATCH, seed=0,
                                           device="cuda"), 0)
    res = {}
    for impl in ("chunked", "naive"):
        loss, parts = lm_loss(params, cfg, batch, impl=impl)
        # the table under embeddings from outside gets zeros, as in the
        # train step
        grads = leaf_grads(loss, leaves, unread_leaf(params, cfg, batch))
        if host and impl == "chunked":
            grads = [g.to("cpu", copy=True) for g in grads]
        res[impl] = (loss.item(), grads)
        del loss, parts, grads      # the graph's nodes, before the next pass
        free_cuda()
    (l_k, g_k), (l_p, g_p) = res["chunked"], res["naive"]
    loss_rel = abs(l_k - l_p) / abs(l_p)
    worst = max(rel_err(a.cuda(), b)[1] for a, b in zip(g_k, g_p))
    ok = loss_rel <= 1e-6 and worst <= TRAIN_GRAD_RTOL
    log(f"{label} in fp32, one train step's loss and grads, kernel vs "
        f"plain path: loss {l_k:.6f} vs {l_p:.6f} (rel {loss_rel:.3e}, limit "
        f"1e-06), grads rel up to {worst:.3e} of each leaf's max over "
        f"{len(leaves)} leaves (limit {TRAIN_GRAD_RTOL:g})"
        + ("" if ok else "  FAIL"))
    assert ok, "fp32 train step: kernel path disagrees with the plain path"
    del params, leaves, res, g_k, g_p
    free_cuda()


def train_launcher(cfg, kernels, card) -> dict[str, int]:
    """The training path through its entry point,
    ``launch.train.train(TRAIN_ARCH, smoke=False)`` at the launcher's
    defaults: counts set to 0 just before, read just after; the loss must
    fall; step times by the launcher's clock (its ``.item()`` waits for the
    step), tokens/s, peak device memory."""
    from repro_torch.launch.train import train
    free_cuda()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = train(TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS,
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    per_step = cfg.n_layers * TRAIN_STEPS
    launches = lm_counts(kernels, {"flash_attention": per_step,
                                   "flash_attention_bwd": per_step},
                         f"{TRAIN_ARCH} train, {TRAIN_STEPS} steps")
    hist = res["history"]
    assert len(hist) == TRAIN_STEPS, hist
    line, ok = loss_bar(f"{TRAIN_ARCH} train (launch.train.train, full "
                        f"config, batch {TRAIN_BATCH} x {TRAIN_SEQ})", hist)
    log(f"{line}; stragglers {res['stragglers']}")
    assert ok, "the loss bar failed"
    steps = res["step_ms"][TRAIN_WARM:]
    q1, _, q3 = statistics.quantiles(steps, n=4)
    p50 = statistics.median(steps)
    log(f"{TRAIN_ARCH} train step (host clock, synchronized, "
        f"{len(steps)} steps after {TRAIN_WARM}): p50 {p50:.4f} ms, p25 "
        f"{q1:.4f}, p75 {q3:.4f}; {TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.1f} "
        f"tokens/s; peak device memory {peak / 2**30:.3f} GiB "
        f"(max_memory_allocated)  [{card}]")
    free_cuda()
    return launches


def train_setup(cfg, *, quantized=False, steps=TRAIN_STEPS, schedule=None):
    """What ``launch.train.train`` builds: weights, AdamW with its cosine
    schedule (from 3e-4, or ``schedule``'s (peak, warmup)), the step, the
    pipeline."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import adamw, build_train_step
    from repro_torch.train.optim import cosine_schedule
    peak, warmup = schedule or (3e-4, min(20, steps // 10 + 1))
    opt = adamw(cosine_schedule(peak, warmup=warmup, total=steps),
                quantized=quantized)
    params = init_lm(0, cfg, device="cuda")
    return (params, opt.init(params), opt, build_train_step(cfg, opt),
            TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                          device="cuda"))


def train_profile(cfg, card, label: str = TRAIN_ARCH,
                  quantized: bool = False, steps: int = 3) -> None:
    """Device busy and idle share of ``steps`` profiled steps and their top
    kernels, and the flash forward's and backward's device time a step
    (and their share of the step's busy time)."""
    params, state, _, step_fn, pipe = train_setup(cfg, quantized=quantized)
    it = itertools.count()

    def one():
        nonlocal params, state
        params, state, m = step_fn(params, state,
                                   train_batch(cfg, pipe, next(it)))
        m["loss"].item()

    for _ in range(TRAIN_WARM):
        one()
    events = profile_window(one, steps, f"{label} train steps", "step",
                            card, warm=one)
    if events:
        def ms(prefix):
            return sum(e.time_range.end - e.time_range.start for e in events
                       if kernel_base(e.name).startswith(prefix)
                       ) / steps / 1e3
        fwd = ms(DEVICE_PREFIX['flash_attention'])
        bwd = ms(DEVICE_PREFIX['flash_attention_bwd'])
        busy = device_busy(events)[0] / steps / 1e3
        log(f"{label} train step, flash device time (profile): forward "
            f"with LSE {fwd:.4f} ms/step, backward {bwd:.4f} ms/step: "
            f"{(fwd + bwd) / busy:.4f} of the step's busy {busy:.4f} ms  "
            f"[{card}]")
    del params, state, step_fn
    free_cuda()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree's leaves, an int8 ``QTensor`` moment as its
    codes and scales."""
    from repro_torch.train.optim import tree_leaves
    return [t for leaf in tree_leaves(tree)
            for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


def train_resume(cfg, card, label: str = TRAIN_ARCH,
                 quantized: bool = False, exact: bool = False) -> None:
    """Save at step 2 of 4 with ``CheckpointManager`` (the reference's
    format, under ``build/``), restore into freshly built weights and
    state: every tensor (int8 moments' codes and scales included) must
    equal what was saved bit for bit; then steps 3-4 against the straight
    run's (bit for bit is reported, and asserted with ``exact``; where it
    does not hold, two gradients from the same state name the leaves whose
    backward is not reproducible: ``unstable_leaves``).  The saved copies
    wait in host memory."""
    import shutil
    from repro_torch.train import CheckpointManager
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"{label} checkpoint: "
        f"{shutil.disk_usage(ROOT).free / 2**30:.1f} GiB free on the disk")
    mgr = CheckpointManager(str(ckpt), keep=1)
    params, state, opt, step_fn, pipe = train_setup(cfg, quantized=quantized,
                                                    steps=4)
    straight, saved = [], None
    for step in range(4):
        params, state, m = step_fn(params, state, pipe.batch(step))
        straight.append(m["loss"].item())
        if step == 1:
            t0 = time.perf_counter()
            mgr.save(2, {"params": params, "opt": state},
                     extra={"loss": straight[-1], "data_cursor": 2})
            save_s = time.perf_counter() - t0
            saved = [x.to("cpu", copy=True) for x in _tensors(
                {"params": params, "opt": state})]
    del params, state
    free_cuda()
    params, state, _, step_fn, _ = train_setup(cfg, quantized=quantized,
                                               steps=4)
    t0 = time.perf_counter()
    back = mgr.restore(2, {"params": params, "opt": state})
    restore_s = time.perf_counter() - t0
    del params, state
    restored = _tensors(back)
    differ = sum(not torch.equal(a.cpu(), b) for a, b in zip(restored, saved))
    nbytes = sum(x.numel() * x.element_size() for x in saved)
    del saved
    params, state = back["params"], back["opt"]
    log(f"{label} checkpoint at step 2: {nbytes / 2**30:.3f} GiB, save "
        f"{save_s:.2f} s, restore {restore_s:.2f} s (host clock); restored "
        f"leaves differing from the saved: {differ} of {len(restored)}"
        + ("" if not differ else "  FAIL"))
    assert not differ, "a restored leaf differs from the saved one"
    del restored
    resumed = []
    for step in (2, 3):
        params, state, m = step_fn(params, state, pipe.batch(step))
        resumed.append(m["loss"].item())
    del params, state, back, step_fn
    free_cuda()
    same = resumed == straight[2:]
    gap = max(abs(a - b) for a, b in zip(resumed, straight[2:]))
    log(f"{label} resumed steps 3-4 {resumed} vs straight "
        f"{straight[2:]}: " + ("bit for bit" if same else
                               f"NOT bit for bit, largest loss gap {gap:.3e}"
                               + "; two backwards from the restored state "
                               "differ in " + unstable_leaves(
                                   cfg, mgr, quantized, pipe.batch(2))))
    shutil.rmtree(ckpt, ignore_errors=True)
    assert gap <= 1e-3 * abs(straight[-1]), "the resumed run diverged"
    assert same or not exact, f"{label}: the resumed run is not bit for bit"


def unstable_leaves(cfg, mgr, quantized, batch) -> str:
    """The leaves whose grad differs between two backwards from the saved
    step-2 state on the same batch (restored afresh from ``mgr``)."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.optim import tree_leaves
    params, state, *_ = train_setup(cfg, quantized=quantized, steps=4)
    params = mgr.restore(2, {"params": params, "opt": state})["params"]
    del state
    grads, leaves = [], [p.requires_grad_(True) for p in tree_leaves(params)]
    for _ in range(2):              # the same state, the same batch, twice
        loss, _ = lm_loss(params, cfg, batch)
        grads.append(torch.autograd.grad(loss, leaves))
        if len(grads) == 1:
            grads[0] = [g.to("cpu", copy=True) for g in grads[0]]
        del loss
    names = list(_leaf_names({"params": params}))
    unstable = [(n, rel_err(a.cuda().float(), b.float())[1])
                for n, a, b in zip(names, *grads)
                if not torch.equal(a, b.cpu())]
    del grads, leaves, params
    free_cuda()
    return (", ".join(f"{n} (rel {r:.3e})" for n, r in unstable)
            if unstable else "no leaf")


def _leaf_names(tree, prefix=""):
    """Leaf paths in ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_names(tree[key], f"{prefix}/{key}")
    else:
        yield prefix


def train_int8(cfg, card) -> None:
    """One full-width step with int8 moments (``adamw(quantized=True)``):
    the state's bytes and a finite loss."""
    params, state, _, step_fn, pipe = train_setup(cfg, quantized=True)
    from repro_torch.train.optim import tree_leaves
    nbytes = sum(x.numel() * x.element_size()
                 for q in tree_leaves({"m": state["m"], "v": state["v"]})
                 for x in q)
    pbytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    params, state, m = step_fn(params, state, pipe.batch(0))
    loss = m["loss"].item()
    log(f"{TRAIN_ARCH} one step with int8 moments: loss {loss:.4f}; moments "
        f"{nbytes / 2**30:.3f} GiB (fp32 would be "
        f"{2 * pbytes * 2 / 2**30:.3f} GiB), params {pbytes / 2**30:.3f} "
        f"GiB" + ("" if math.isfinite(loss) else "  FAIL"))
    assert math.isfinite(loss), "int8 moments: non-finite loss"
    del params, state, step_fn
    free_cuda()


def train_phase(kernels, card, path: bool = True,
                timed: bool = True) -> list[dict]:
    """The training path (``--train`` alone, or after the LM phases): the
    backward kernel and the forward's LSE against their plain versions,
    one fp32 full-width step kernel vs plain, the launcher at full width
    (its counts and times), with ``timed`` (``--train``) a profile of 3
    steps and the times of the calls off the step, checkpoint resume and
    int8 moments; returns the kernels' JSON rows.  ``path=False``
    (``--bwd``): the kernels' checks and times alone, no path and no
    rows."""
    from repro_torch import configs
    cfg = configs.get(TRAIN_ARCH)
    assert TRAIN_SHAPE == (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                           TRAIN_SEQ, TRAIN_SEQ, cfg.resolved_head_dim, True)
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    cases = train_cases(rng, dev, cfg.n_layers)
    max_err = dict.fromkeys(kernels, 0.0)
    for case in cases:
        check = check_bwd_case if case.kernel == "flash_attention_bwd" \
            else check_case
        max_err[case.kernel] = max(max_err[case.kernel], check(case))
    flash_lse_checks(rng, dev)
    per_step = {"flash_attention": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    if not path:
        kernel_rows("lm-train", cases, dict.fromkeys(kernels, 0), per_step,
                    max_err, card)
        return []
    train_fp32_parity(cfg)
    launches = train_launcher(cfg, kernels, card)
    if timed:
        train_profile(cfg, card)
    train_resume(depth_config(TRAIN_ARCH, TRAIN_RESUME_LAYERS), card)
    train_int8(cfg, card)
    rows = kernel_rows("lm-train", cases, launches, per_step, max_err, card,
                       unit=f"ms per {TRAIN_ARCH} train step (batch "
                            f"{TRAIN_BATCH} x {TRAIN_SEQ}): its "
                            f"{cfg.n_layers} launches", timed=timed)
    del cases
    free_cuda()
    return rows


def family_cases(cfg, rng, dev, per_step: int) -> list[Case]:
    """The flash calls of a family's training step (none for xlstm): the
    forward with its LSE and the backward at the training shape in bf16,
    weighted by their launches a step, and the same calls in fp32; for MLA
    the backward also at a 2048-token prompt (both types), off the path."""
    if not attn_calls(cfg):
        return []
    d, dv = head_dims(cfg)
    bf16, f32 = torch.bfloat16, torch.float32
    shape = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
             d, True)
    cases = [flash_case(shape, bf16, rng, dev, per_request=per_step,
                        lse=True, dv=dv),
             flash_bwd_case(shape, bf16, rng, dev, per_request=per_step,
                            dv=dv),
             flash_case(shape, f32, rng, dev, lse=True, dv=dv),
             flash_bwd_case(shape, f32, rng, dev, dv=dv)]
    if dv != d:
        long = (1, cfg.n_heads, cfg.n_kv_heads, LONG_PROMPT, LONG_PROMPT, d,
                True)
        cases += [flash_bwd_case(long, dt, rng, dev, dv=dv)
                  for dt in (bf16, f32)]
    return cases


def family_train(arch, cfg, whole: bool, quantized: bool, kernels,
                 card) -> dict[str, int]:
    """FAMILY_STEPS bf16 steps through the entry point (``train()`` for a
    whole model, else ``train_setup``'s weights, AdamW and step on the cut
    config, stepped on ``train()``'s clock): counts set to 0 just before,
    read just after; the loss must fall by TRAIN_DROP; step p50/p25/p75
    after TRAIN_WARM, tokens/s and peak device memory."""
    from repro_torch.launch.train import train
    free_cuda()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    if whole:
        res = train(arch, smoke=False, steps=FAMILY_STEPS,
                    batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
        hist, step_ms = res["history"], res["step_ms"]
    else:
        params, state, _, step_fn, pipe = train_setup(
            cfg, quantized=quantized, steps=FAMILY_STEPS,
            schedule=FAMILY_SCHEDULE.get(arch))
        log(f"{arch}: weights and optimizer state "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        hist, step_ms = [], []
        for step in range(FAMILY_STEPS):
            t0 = time.time()
            params, state, m = step_fn(params, state,
                                       train_batch(cfg, pipe, step))
            hist.append(m["loss"].item())
            step_ms.append((time.time() - t0) * 1e3)
        del params, state, step_fn
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n = attn_calls(cfg) * FAMILY_STEPS
    launches = lm_counts(kernels, {"flash_attention": n,
                                   "flash_attention_bwd": n} if n else {},
                         f"{arch} train, {FAMILY_STEPS} steps")
    assert len(hist) == FAMILY_STEPS, hist
    how = ("launch.train.train, full config" if whole else
           f"train_setup, {cfg.n_layers} layers")
    line, ok = loss_bar(f"{arch} train ({how}, "
                        f"{'int8' if quantized else 'fp32'} moments, batch "
                        f"{TRAIN_BATCH} x {TRAIN_SEQ})", hist)
    log(line)
    assert ok, f"{arch}: the loss bar failed"
    steps = step_ms[TRAIN_WARM:]
    q1, _, q3 = statistics.quantiles(steps, n=4)
    p50 = statistics.median(steps)
    log(f"{arch} train step (host clock, synchronized, {len(steps)} steps "
        f"after {TRAIN_WARM}): p50 {p50:.4f} ms, p25 {q1:.4f}, p75 "
        f"{q3:.4f}; {TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.1f} tokens/s; "
        f"peak device memory {peak / 2**30:.3f} GiB "
        f"(max_memory_allocated)  [{card}]")
    free_cuda()
    return launches


def family_arch(arch, spec, kernels, card, rng, dev, *,
                resume: str | None = None,
                timed: bool = True) -> list[dict]:
    """One arch's training path (``spec``: its depth cut or None, int8
    moments): its flash calls against their plain versions and timed
    (their rows built then, and the cases freed: the library's retained
    graphs at 2048 tokens hold tens of GB), with ``timed`` the fp32 step
    kernel vs plain, the bf16 steps through the entry point (whose launch
    counts fill the rows; the launcher feeds tokens, so an arch fed
    embeddings from outside steps what it builds, ``train_setup``), with
    ``timed`` on
    ``resume`` the checkpoint resume, a profile of 1 step and the times of
    the calls off the step (fp32, MLA's 2048 tokens); returns its kernel
    rows."""
    n_layers, quantized = spec
    cfg = depth_config(arch, n_layers)
    per_step = attn_calls(cfg)
    cases = family_cases(cfg, rng, dev, per_step)
    max_err = dict.fromkeys(kernels, 0.0)
    for case in cases:
        check = check_bwd_case if case.kernel == "flash_attention_bwd" \
            else check_case
        max_err[case.kernel] = max(max_err[case.kernel], check(case))
    per = {"flash_attention": per_step, "flash_attention_bwd": per_step}
    rows = kernel_rows(f"{arch}-train", cases, dict.fromkeys(kernels, 0),
                       per, max_err, card,
                       unit=f"ms per {arch} train step (batch {TRAIN_BATCH}"
                            f" x {TRAIN_SEQ}): its {per_step} launches",
                       timed=timed)
    del cases
    free_cuda()
    stamp(f"{arch} training kernel checks and times")
    if timed:
        train_fp32_parity(cfg, arch, host=True)
        stamp(f"{arch} fp32 step, kernel vs plain")
    launches = family_train(arch, cfg, n_layers is None and cfg.embed_inputs,
                            quantized, kernels, card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    stamp(f"{arch} {FAMILY_STEPS} training steps")
    if timed:
        train_profile(cfg, card, arch, quantized, steps=1)
        stamp(f"{arch} training profile")
    if arch == resume and timed:
        train_resume(cfg, card, arch, quantized, exact=True)
        stamp(f"{arch} checkpoint resume")
    free_cuda()
    return rows


def train_families_phase(kernels, card, timed: bool,
                         archs=tuple(FAMILY_TRAIN)) -> list[dict]:
    """The training paths of the recurrent family and the mixtures of
    experts (``--train-families``: ``timed``, optionally followed by the
    archs to run): zamba2-2.7b, xlstm-350m, deepseek-v3 (3 layers) and
    grok-1 (1 layer); each step's profile and the calls off the step
    timed under ``timed`` only."""
    rng = np.random.default_rng(11)
    resume = FAMILY_RESUME if FAMILY_RESUME in archs else list(archs)[-1]
    rows = []
    for arch in archs:
        rows += family_arch(arch, FAMILY_TRAIN[arch], kernels, card, rng,
                            torch.device("cuda"), resume=resume,
                            timed=timed)
        free_cuda()
    return rows


def grok_schedule_phase(card: str) -> None:
    """``--grok-schedule``: grok-1 at its published width cut to 1 layer,
    int8 moments, FAMILY_STEPS bf16 steps on one card from the same
    weights and batches on each of GROK_CANDIDATES: each whole curve and
    the loss bar's verdict, printed, not asserted (GROK_SCHEDULE is the
    candidate chosen)."""
    cfg = depth_config("grok-1-314b", 1)
    for peak, warmup in GROK_CANDIDATES:
        free_cuda()
        params, state, _, step_fn, pipe = train_setup(
            cfg, quantized=True, steps=FAMILY_STEPS, schedule=(peak, warmup))
        hist = []
        for step in range(FAMILY_STEPS):
            params, state, m = step_fn(params, state,
                                       train_batch(cfg, pipe, step))
            hist.append(m["loss"].item())
        del params, state, step_fn
        line, _ = loss_bar(f"grok-1 1 layer, int8 moments, cosine from "
                           f"{peak:g}, {warmup} warmup steps of "
                           f"{FAMILY_STEPS}", hist)
        log(f"{line}  [{card}]")
    free_cuda()


# The dry run against the card (``dryrun_phase``, alone under ``--dryrun``):
# one llama3.2-1b train step at its published size, batch TRAIN_BATCH x
# TRAIN_SEQ (int32 tokens, as the dry run's cells take them), bf16 with
# fp32 AdamW moments under ``remat``, as ``launch/dryrun.py`` steps a
# train cell, counted twice by ``launch.step_analysis.StepCounter``: by
# ``dryrun.lower_cell`` as rank 0 of a fake group of 1 (meta tensors, no
# card), and for real as rank 0 of an NCCL group of 1 over the same (1, 1)
# mesh, after one warm step.  Argument bytes, FLOPs and the flash calls
# (against the kernels' launch counters) must be equal; the step's counted
# peak within DRYRUN_PEAK_RTOL of what the allocator held above the step's
# base (``max_memory_allocated``: its 512-byte rounding, the kernels'
# scratch).  The roofline's terms at the H100's data-sheet peaks are
# printed beside the measured step p50 of DRYRUN_STEPS steps: a share of
# peak, no bar.
DRYRUN_PEAK_RTOL = 0.05
DRYRUN_STEPS = 8
DRYRUN_DIMS = {"seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH}


def dryrun_cell(grid) -> dict:
    """The dry run's record of that step over ``grid`` (data, model)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rec = dryrun.lower_cell(TRAIN_ARCH, "train_4k", dims=DRYRUN_DIMS,
                            mesh_shape=(grid, ("data", "model")))
    rec["host_s"] = time.perf_counter() - t0
    return rec


def dryrun_real(mesh, kernels):
    """The dry run's step for real on ``mesh``: llama3.2-1b placed, AdamW,
    the step; one warm step, then one under ``StepCounter`` with the
    allocator's peak above its base and the kernels' launches; -> (the
    counter, the arguments as the dry run holds them, peak bytes, the
    launches, the step function and its state)."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.dryrun import batch_blocks
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.launch.step_analysis import StepCounter
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import adamw, build_train_step
    cfg = configs.get(TRAIN_ARCH)
    dp, model, _ = mesh_axes(mesh)
    params, _ = dist_place(init_lm(0, cfg, device=mesh.device), mesh)
    free_cuda()
    opt = adamw()
    state = opt.init(params)
    step = build_train_step(cfg, opt, mesh=mesh, dp_axes=dp,
                            model_axis=model, remat=True)
    pipe = TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                         device=mesh.device)

    def batch(s):
        return {k: v.to(torch.int32) for k, v in pipe.batch(s).items()}

    step(params, state, batch(0))
    b = batch(1)
    held = {"params": params, "opt_state": state,
            "batch": batch_blocks(b, "train", mesh, dp=dp, model=model)}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with StepCounter() as sc:
        step(params, state, b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {n: fn.launches for n, fn in kernels.items()}
    return sc, held, peak, launches, lambda s: step(params, state, batch(s))


def dryrun_phase(card: str) -> None:
    """The dry run against one card (above)."""
    sys.path.insert(0, str(ROOT / "tools"))
    from ranks import free_port
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import (destroy_process_group,
                                         init_process_group,
                                         make_process_mesh)
    from repro_torch.launch.step_analysis import held_bytes
    kernels = dist_kernels()
    dry = dryrun_cell((1, 1))
    log(f"dry run of {TRAIN_ARCH}'s train step (batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, remat) on a fake group of 1: {dry['host_s']:.2f} s "
        f"on the host; flops {dry['flops_per_device']}, bytes "
        f"{dry['bytes_per_device']}, memory {dry['memory']}, flash calls "
        f"{dry['flash_calls']}")
    init_process_group(0, 1, f"tcp://localhost:{free_port()}")
    try:
        mesh = make_process_mesh((1, 1), ("data", "model"))
        sc, held, peak, launches, one = dryrun_real(mesh, kernels)
        ms = []
        for s in range(2, 2 + DRYRUN_STEPS):
            t0 = time.perf_counter()
            one(s)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        destroy_process_group()
    args = held_bytes(held)
    counted = dry["memory"]["peak_bytes"] - dry["memory"]["argument_bytes"]
    peak_rel = abs(counted - peak) / peak
    calls = dry["flash_calls"]
    checks = {
        "argument bytes": (dry["memory"]["argument_bytes"], args),
        "FLOPs": (dry["flops_per_device"], sc.flops),
        "flash forward calls": (calls["flash_fwd"],
                                launches["flash_attention"]),
        "flash backward calls": (calls["flash_bwd"],
                                 launches["flash_attention_bwd"])}
    for what, (want, got) in checks.items():
        log(f"dry run against the card, {what}: {want} counted, {got} on "
            f"the card" + ("" if want == got else "  FAIL") + f"  [{card}]")
    log(f"dry run against the card, the step's peak above its base: "
        f"{counted} counted, {peak} by max_memory_allocated (rel "
        f"{peak_rel:.3e}, limit {DRYRUN_PEAK_RTOL:g}); HBM bytes counted "
        f"{dry['bytes_per_device']} dry, {sc.bytes} on the card  [{card}]")
    terms = roofline.analyze(dry)
    p50 = statistics.median(ms)
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    log(f"roofline at the data sheet's peaks ({roofline.CARD}): compute "
        f"{terms['compute_s'] * 1e3:.4f} ms, memory "
        f"{terms['memory_s'] * 1e3:.4f} ms, collective "
        f"{terms['collective_s'] * 1e3:.4f} ms ({terms['dominant']}); the "
        f"step's p50 {p50:.4f} ms over {len(ms)} steps (host clock, "
        f"synchronized): the bound is {bound * 1e3 / p50:.4f} of it  "
        f"[{card}]")
    assert all(want == got for want, got in checks.values()), checks
    assert peak_rel <= DRYRUN_PEAK_RTOL, (counted, peak)
    free_cuda()


def dist_dryrun_check(rank, dev, emit, dry) -> None:
    """(x): the dry run's llama3.2-1b train step over (2, 2) (``dry``, its
    record on a fake group of 4, made before the ranks started) against
    the real four-rank step: each rank's collective bytes per kind (and
    calls) equal to the dry run's rank 0, exactly (the ranks of (2, 2)
    are alike), and its argument bytes equal to the dry run's and to
    ``sharding.explain()``'s over the parameters, the fp32 moments and
    the batch."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import _opt_specs, input_specs
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.step_analysis import held_bytes
    from repro_torch.models.weights import param_dtypes, param_shapes
    mesh = make_process_mesh((2, 2), ("data", "model"))
    cfg = configs.get(TRAIN_ARCH)
    sc, held, _, launches, _ = dryrun_real(mesh, dist_kernels())
    got = sc.collective_bytes()
    shapes = param_shapes(cfg)
    specs = sharding.param_specs(shapes, mesh)
    stated = sum(row[3] for row in sharding.explain(
        shapes, specs, mesh, param_dtypes(cfg)))
    ospecs = _opt_specs(held["params"], sharding.shardings(specs, mesh),
                        quantized=False)
    fp32 = param_dtypes(cfg, torch.float32)
    stated += sum(row[3] for mom in ("m", "v") for row in sharding.explain(
        shapes, ospecs[mom], mesh, fp32))
    ins = input_specs(TRAIN_ARCH, "train_4k", cfg, DRYRUN_DIMS)
    bspecs = sharding.batch_specs("train", mesh)
    stated += sum(row[3] for row in sharding.explain(
        ins, {k: bspecs[k] for k in ins}, mesh)) + 4    # AdamW's step
    args = held_bytes(held)
    want = dry["collective_bytes_per_device"]
    line = (f"(x) dry run of {TRAIN_ARCH}'s train step over (2, 2) against "
            f"rank {rank}'s: collective bytes {got} on the card, {want} "
            f"counted; argument bytes {args} held, "
            f"{dry['memory']['argument_bytes']} counted, {int(stated)} by "
            f"explain(); flash launches {launches}, calls counted "
            f"{dry['flash_calls']}")
    emit(line)
    assert got == want and args == dry["memory"]["argument_bytes"] \
        == stated, line
    free_cuda()


def device_only_ms(fn, n: int = 40) -> float:
    """Mean device time of ``fn`` by CUDA events, with the host's launches
    queued behind a sleeping kernel, so that the host's launch rate does
    not show."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)               # ~15 ms: queue n launches
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def conv_sweep(card) -> None:
    """Every pixel tile and split-K factor of the shift-conv kernel at every
    distinct conv shape of b4, b5, b1, b2 and b3 (device time, checked
    against the plain version), beside the plan's choice; per task, the
    plan's sum over a request's convs against the best per layer."""
    from repro_torch.kernels import _build, ref
    lib = _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    timed: dict[tuple, tuple[float, float]] = {}   # shape -> (plan, best)
    for task in ("b4", "b5", "b1", "b2", "b3-r50", "b3-r101"):
        plan_ms = best_ms = 0.0
        plan = task_plans(task)[0]
        shapes = dict(plan.meta["input_shapes"])
        for op in plan.ops:
            xin = tuple(shapes[op.inputs[0]])
            shapes[op.name] = op.out_shape
            if op.kind != "conv":
                continue
            w_shape, stride = op.weights["w"].shape, ref.pair(
                op.attrs["stride"])
            key = (xin, w_shape, stride, op.attrs["padding"])
            if key not in timed:
                timed[key] = sweep_shape(lib, dev, rng, *key, card)
            plan_ms += timed[key][0]
            best_ms += timed[key][1]
        log(f"conv sweep {task}: the plan's choice {plan_ms:.4f} ms of "
            f"device time per request, the best per layer {best_ms:.4f} ms "
            f"({plan_ms / best_ms - 1:+.1%})  [{card}]")


def sweep_shape(lib, dev, rng, x_shape, w_shape, stride, padding,
                card) -> tuple[float, float]:
    """Device time of one conv shape at every block tile and split,
    each result checked against the plain version -> (the plan's choice,
    the best), in ms."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.shift_conv import BK, launch_plan
    k1, k2, cin, cout = w_shape
    batch = x_shape[0] if len(x_shape) == 4 else 1
    H, W = x_shape[-2:]
    ho, wo, pad_t, _, pad_l, _ = ref.conv_geometry(
        H, W, k1, k2, stride=stride, padding=padding, dilation=(1, 1))
    x = torch.tensor(rng.standard_normal(x_shape), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.standard_normal(w_shape), dtype=torch.float32,
                     device=dev)
    want = ref.conv2d_ref(x, w, stride=stride, padding=padding)
    k_tiles = -(-k1 * k2 * cin // BK)
    chosen = launch_plan(x_shape, w_shape, stride=stride, padding=padding)
    times = {}
    for bm, bn, split in itertools.product((32, 64), (32, 64),
                                           range(1, k_tiles + 1)):
        tiles = -(-cout // bm) * -(-ho * wo // bn)
        if k_tiles % split or (tiles * split > 4096 and (bm, bn, split) != (
                chosen.bm, chosen.bn, chosen.split)):
            continue
        buf = torch.empty((split, *want.shape), device=dev)
        params = (ctypes.c_int * 20)(
            batch, cin, H, W, k1, k2, cout, 1, ho, wo, *stride, 1, 1,
            pad_t, pad_l, bm, bn, split, int((k1, k2, *stride) == (1,) * 4))

        def run():
            return lib.repro_shift_conv2d(
                x.data_ptr(), w.data_ptr(), buf.data_ptr(), params,
                torch.cuda.current_stream(dev).cuda_stream)
        assert run() == 0
        torch.cuda.synchronize()
        _, rel = rel_err(buf[0], want)
        assert rel <= KERNEL_RTOL, (x_shape, w_shape, bm, bn, split, rel)
        times[bm, bn, split] = device_only_ms(run)
    mine = times[chosen.bm, chosen.bn, chosen.split]
    (bbm, bbn, bsplit), best = min(times.items(), key=lambda kv: kv[1])
    log(f"conv sweep x{x_shape} w{w_shape} stride={stride}: plan tile "
        f"{chosen.bm}x{chosen.bn} split {chosen.split} of {k_tiles} K tiles "
        f"{mine:.5f} ms; best {bbm}x{bbn} split {bsplit} {best:.5f} ms; all "
        + " ".join(f"{bm}x{bn}/{sp}:{t:.4f}" for (bm, bn, sp), t in
                   sorted(times.items())) + f"  [{card}]")
    return mine, best


def ddmm_sweep(card) -> None:
    """Every column tile and K split of DDMM's tensor-core route at every
    distinct tensor-core call of the paths (device time, each checked
    against the plain version), beside the plan's choice; per task, the
    plan's sum over a request's calls against the best per call."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.ddmm import ACT_CODES, BK, MAX_SPLIT, y_layout
    lib = _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    timed: dict[tuple, tuple[float, float]] = {}
    for task in PER_REQUEST:
        plan_ms = best_ms = 0.0
        for case in task_cases(task, task_plans(task)[0], rng, dev):
            if case.kernel != "ddmm" or not case.per_request \
                    or case.plan.route != "mma":
                continue
            x, y, bias, res, act = case.args
            key = (tuple(x.shape), tuple(y.shape), tuple(y.stride()),
                   bias is not None, act)
            if key not in timed:
                timed[key] = sweep_ddmm(lib, x, y, bias, res, act, case.plan,
                                        card, ref, BK, MAX_SPLIT,
                                        y_layout(y), ACT_CODES[act])
            plan_ms += case.per_request * timed[key][0]
            best_ms += case.per_request * timed[key][1]
        if plan_ms:
            log(f"ddmm sweep {task}: the plan's choice {plan_ms:.4f} ms of "
                f"device time per request, the best per call {best_ms:.4f} "
                f"ms ({plan_ms / best_ms - 1:+.1%})  [{card}]")


def sweep_ddmm(lib, x, y, bias, res, act, chosen, card, ref, bk, max_split,
               layout, act_code) -> tuple[float, float]:
    """Device time of one DDMM call at every column tile and split ->
    (the plan's choice, the best), in ms."""
    m, k = x.shape
    n = y.shape[1]
    want = ref.ddmm_ref(x, y, bias=bias, residual=res, act=act)
    k_tiles = max(1, -(-k // bk))
    out = torch.empty_like(want)
    times = {}
    for bn in (32, 64):
        for split in range(1, min(max_split, k_tiles) + 1):
            kt_per = -(-k_tiles // split)
            if -(-k_tiles // kt_per) != split:
                continue
            params = (ctypes.c_int * 11)(m, k, n, layout[1], int(layout[0]),
                                         act_code, 0, chosen.bm, bn, kt_per,
                                         split)

            def run():
                return lib.repro_ddmm(
                    x.data_ptr(), y.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    None if res is None else res.data_ptr(), out.data_ptr(),
                    params, torch.cuda.current_stream().cuda_stream)
            assert run() == 0
            torch.cuda.synchronize()
            _, rel = rel_err(out, want)
            assert rel <= KERNEL_RTOL, (m, k, n, bn, split, rel)
            times[bn, split] = device_only_ms(run)
    mine = times[chosen.bn, chosen.split]
    (bbn, bsplit), best = min(times.items(), key=lambda kv: kv[1])
    log(f"ddmm sweep ({m},{k})@({k},{n}) y_strides={tuple(y.stride())}: "
        f"plan {chosen.bm}x{chosen.bn} split {chosen.split} of {k_tiles} K "
        f"stages {mine:.5f} ms; best {chosen.bm}x{bbn} split {bsplit} "
        f"{best:.5f} ms; all " + " ".join(
            f"{bn}/{sp}:{t:.4f}" for (bn, sp), t in sorted(times.items()))
        + f"  [{card}]")
    return mine, best


# ============================================ the LM over a device mesh ====
# The distributed phase (item 6b): ranks spawned one per visible card
# (``tools/ranks.py``: ``torch.multiprocessing`` spawn, NCCL, one rank a
# card), each joining one group and binding meshes
# (``launch.mesh.make_process_mesh``).  The kernels are built by this
# process before any rank starts; the ranks load the built library.  In
# the default run (one card: a (1, 1) mesh; NCCL takes no two ranks on one
# card) the phase runs at smoke size (``dist_rank_smoke``): the sharded
# train step of llama3.2-1b and of deepseek-v3 (MLA, its MoE through
# ``moe_a2a``; 8 experts, top-2, capacity factor DIST_CAPACITY, which drops
# nothing), each held to the port's own one-card step on the same card
# (loss DIST_LOSS_RTOL relative, every parameter DIST_PARAM_ATOL, grad norm
# DIST_GNORM_RTOL relative) with the flash forward and backward launched in
# the sharded step (counts set to 0 just before it, read just after); a
# deepseek-v3 ``lm_decode_step(mesh=)`` held to the one-card decode
# (DIST_DECODE_RTOL of max|logits|), the decode's tokens also through
# ``moe_apply(path="gathered")`` (``moe_gathered2d``, and ``moe_gathered``
# under ``REPRO_MOE_1D``) against ``moe_dense``; and a checkpoint saved
# from the mesh and restored onto it by ``restore(shardings=)``, bit for
# bit.  ``--distributed`` (a four-card call) runs instead, at full size
# (``dist_rank_full``): (a) llama3.2-1b at its published size over (2, 2),
# one fp32 step held to the one-card step (rank 0's card), then
# DIST_STEPS bf16 steps (the loss must fall by TRAIN_DROP; step p50 beside
# rank 0's one-card bf16 step p50); (b) deepseek-v3 at its published width,
# depth cut to DIST_DEEPSEEK_LAYERS (its 3 dense MLA layers and 1 MoE layer
# of 256 experts), over (1, 4) (64 experts a card), bf16 weights and fp32
# moments, batch TRAIN_BATCH x TRAIN_SEQ, DIST_STEPS steps (the loss must
# fall), peak memory, explain()'s bytes a rank beside the ranks' own, and
# the a2a's dropped (token, k) entries; (c) ``pipeline_apply`` over 4
# stages on 4 cards at PIPE_SHAPES, fp32 with TF32 off, ys within
# PIPE_FWD_ATOL of the sequential product and the grads within
# PIPE_GRAD_ATOL.
DIST_CAPACITY = 4.0
DIST_LOSS_RTOL = 1e-4
DIST_PARAM_ATOL = 1e-3
DIST_GNORM_RTOL = 1e-5
DIST_DECODE_RTOL = 1e-5
DIST_STEPS = 10
DIST_PROFILED = 2
DIST_DEEPSEEK_LAYERS = 4
DIST_TIMEOUT_S = 900
PIPE_STAGES = 4
PIPE_SHAPES = ((6, 2, 16), (6, 2, 2048))        # (n_micro, mb, d)
PIPE_FWD_ATOL, PIPE_GRAD_ATOL = 1e-5, 1e-4


def dist_mesh_shape(world: int) -> tuple[int, int]:
    """(data, model) for a group of ``world`` ranks: (1, 1) on one card,
    (world / 2, 2) on an even count."""
    return (world // 2, 2) if world > 1 and world % 2 == 0 else (world, 1)


def dist_kernels() -> dict:
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd}


def dist_device() -> torch.device:
    """This rank's card (made current when the rank joined its group)."""
    return torch.device("cuda", torch.cuda.current_device())


def dist_setup() -> None:
    """A rank's numerics: IEEE fp32 products for the parity checks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dist_whole(tree) -> dict:
    """A tree's leaves, ``DTensor``s gathered whole (every rank taking
    part), by path, on the rank's card."""
    from repro_torch.distributed import collectives as col
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
            return
        if col.is_dtensor(t):
            from torch.distributed.tensor import Replicate
            t = t.redistribute(
                placements=[Replicate()] * t.device_mesh.ndim).to_local()
        out[path] = t.detach()

    walk(tree, "")
    return out


def dist_place(params, mesh):
    """``params`` placed on ``mesh`` by the rule table; the shardings."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import mesh_axes
    dp, model, _ = mesh_axes(mesh)
    shard = sharding.shardings(sharding.param_specs(
        params, mesh, fsdp=dp, model=model), mesh)
    return sharding.device_put(params, shard), shard


def dist_step_check(what, got, want) -> str:
    """A sharded step's (metrics, params) against the one-card step's:
    the loss, grad norm and every parameter within the bars."""
    (gm, gp), (wm, wp) = got, want
    loss = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
    gnorm = abs(gm["grad_norm"] - wm["grad_norm"]) / abs(wm["grad_norm"])
    err = max(float((gp[k].float() - wp[k].float()).abs().max())
              for k in wp)
    line = (f"{what}: loss {gm['loss']:.6f} vs one card {wm['loss']:.6f} "
            f"(rel {loss:.3e}, limit {DIST_LOSS_RTOL:g}); grad norm rel "
            f"{gnorm:.3e} (limit {DIST_GNORM_RTOL:g}); params max|diff| "
            f"{err:.3e} (limit {DIST_PARAM_ATOL:g})")
    assert loss <= DIST_LOSS_RTOL and gnorm <= DIST_GNORM_RTOL \
        and err < DIST_PARAM_ATOL, line
    return line


def dist_one_step(cfg, params, batch, mesh=None):
    """One AdamW step (lr DIST_LR) of ``params`` (placed on ``mesh`` when
    given): (metrics as floats, the parameters after it, whole)."""
    metrics, params, _ = dist_step_lean(cfg, params, batch, mesh)
    return metrics, dist_whole(params)


def dist_smoke_cfg(arch: str):
    """The smoke configs of the default run (deepseek-v3's with 8
    experts, top-2 at DIST_CAPACITY)."""
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, capacity_factor=DIST_CAPACITY))
    return cfg


def dist_rank_smoke(rank: int, world: int, ckpt_dir: str) -> dict:
    """The default run's distributed phase, on one rank (see above)."""
    import os
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_process_mesh, mesh_axes
    from repro_torch.models import moe
    from repro_torch.models.transformer import (init_caches, init_lm,
                                                lm_decode_step)
    from repro_torch.train import CheckpointManager, adamw
    dist_setup()
    kernels = dist_kernels()
    shape = dist_mesh_shape(world)
    mesh = make_process_mesh(shape, ("data", "model"))
    dp, model, _ = mesh_axes(mesh)
    lines = [f"distributed: {world} rank(s), NCCL, mesh {shape} "
             f"('data', 'model') over {torch.cuda.device_count()} card(s)"]
    launches = {}
    for arch in ("llama3.2-1b", "deepseek-v3-671b"):
        cfg = dist_smoke_cfg(arch)
        batch = TokenPipeline(cfg.vocab, 32, 8, seed=1,
                              device=mesh.device).batch(0)
        want = dist_one_step(cfg, init_lm(0, cfg, device=mesh.device),
                             batch)
        placed, shard = dist_place(init_lm(0, cfg, device=mesh.device), mesh)
        for fn in kernels.values():
            fn.launches = 0
        got = dist_one_step(cfg, placed, batch, mesh)
        torch.cuda.synchronize()
        launches[arch] = {n: fn.launches for n, fn in kernels.items()}
        lines.append(dist_step_check(
            f"{arch} smoke sharded step over {shape}", got, want)
            + f"; launches {launches[arch]}")
        assert all(launches[arch].values()), launches
    # deepseek-v3's decode over the mesh, and the decode paths of its MoE
    cfg = dist_smoke_cfg("deepseek-v3-671b")
    params = init_lm(0, cfg, device=mesh.device)
    placed, shard = dist_place(init_lm(0, cfg, device=mesh.device), mesh)
    b = 4 * mesh.shape["data"]
    caches = init_caches(cfg, b, 4, device=mesh.device, mesh=mesh,
                         dp_axes=dp, model_axis=model)
    one = init_caches(cfg, b, 4, device=mesh.device)
    toks = torch.arange(b, device=mesh.device) * 7 % cfg.vocab
    worst = 0.0
    with torch.no_grad():
        for i in range(3):
            lg, caches = lm_decode_step(placed, cfg, toks, caches, i,
                                        mesh=mesh, dp_axes=dp,
                                        model_axis=model, max_len=4)
            want, one = lm_decode_step(params, cfg, toks, one, i)
            lg = col.gather(lg, mesh, 0, dp)
            worst = max(worst, float((lg - want).abs().max()
                                     / want.abs().max()))
            toks = want.argmax(-1)
        # one MoE layer's weights, whole on every rank
        layer = {k: ({kk: vv[0] for kk, vv in v.items()}
                     if isinstance(v, dict) else v[0])
                 for k, v in params["stage_1"]["moe"].items()}
        x = torch.randn((b, 1, cfg.d_model), generator=torch.Generator(
            mesh.device).manual_seed(3), device=mesh.device)
        ref, _ = moe.moe_dense(layer, x, cfg)
        gathered = {}
        for name, one_d in (("gathered2d", False), ("gathered", True)):
            if one_d:
                os.environ["REPRO_MOE_1D"] = "1"
            try:
                y, _ = moe.moe_apply(layer, col.take_block(x, mesh, 0, dp),
                                     cfg, mesh=mesh, dp_axes=dp,
                                     model_axis=model, path="gathered")
            finally:
                os.environ.pop("REPRO_MOE_1D", None)
            y = col.gather(y, mesh, 0, dp)
            gathered[name] = float((y - ref).abs().max() / ref.abs().max())
    lines.append(f"deepseek-v3 smoke lm_decode_step over {shape}: 3 steps, "
                 f"logits within {worst:.3e} of max|one card| (limit "
                 f"{DIST_DECODE_RTOL:g}); moe_apply(path='gathered') on the "
                 f"decode's tokens vs moe_dense: {gathered}")
    assert worst <= DIST_DECODE_RTOL and all(
        e <= DIST_DECODE_RTOL for e in gathered.values()), lines[-1]
    # a checkpoint saved from the mesh, restored onto it
    opt = adamw(1e-3)
    state = {"params": placed, "opt": opt.init(placed)}
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, state)
    like = {"params": dist_place(init_lm(1, cfg, device=mesh.device),
                                 mesh)[0]}
    like["opt"] = opt.init(like["params"])
    got = mgr.restore(1, like, shardings={"params": shard, "opt": {
        "m": shard, "v": shard}})
    a, b_ = dist_whole(state), dist_whole(got)
    same = all(torch.equal(a[k], b_[k]) for k in a) and set(a) == set(b_)
    lines.append(f"checkpoint saved from {shape} and restored by "
                 f"restore(shardings=): {len(a)} leaves bit for bit: {same}")
    assert same
    lines += dist_rest_smoke(mesh, kernels)
    return {"lines": lines, "launches": launches}


def dist_rest_smoke(mesh, kernels) -> list[str]:
    """The rest of the LM over the mesh at smoke size: the engine, zamba2's
    step and decode, an int8 step on placed parameters."""
    return ([dist_serve_smoke(mesh, kernels)] + dist_rec_smoke(mesh)
            + [dist_int8_smoke(mesh)])


def dist_rank_rest(rank: int, world: int) -> list[str]:
    """``dist_rest_smoke`` alone on this rank (the card tests)."""
    from repro_torch.launch.mesh import make_process_mesh
    dist_setup()
    mesh = make_process_mesh(dist_mesh_shape(world), ("data", "model"))
    return dist_rest_smoke(mesh, dist_kernels())


def dist_serve_smoke(mesh, kernels) -> str:
    """``ServeEngine(mesh=)`` on the mesh at smoke size: its greedy
    tokens against the same engine without a mesh, flash launched in its
    prefills (counts set to 0 just before the mesh engine, read just
    after)."""
    from repro_torch.launch.serve import prompts
    from repro_torch.models.transformer import init_lm
    cfg = dist_smoke_cfg(LM_ARCH)
    batch = prompts(cfg.vocab, 6, LM_PROMPT_LEN, 0)
    want = dist_engine(cfg, init_lm(0, cfg, device=mesh.device), batch,
                       8, slots=4, max_len=64)
    placed, _ = dist_place(init_lm(0, cfg, device=mesh.device), mesh)
    for fn in kernels.values():
        fn.launches = 0
    got = dist_engine(cfg, placed, batch, 8, mesh=mesh, slots=4,
                      max_len=64)
    torch.cuda.synchronize()
    counts = {n: fn.launches for n, fn in kernels.items()}
    same = [r.out for r in got[0]] == [r.out for r in want[0]]
    line = (f"{cfg.name} ServeEngine(mesh=) over {tuple(mesh.shape.values())}"
            f", {len(batch)} requests: greedy tokens equal to the engine "
            f"without a mesh: {same}; launches {counts}")
    assert same and counts["flash_attention"] == len(batch) * cfg.n_layers, \
        line
    return line


def dist_rec_smoke(mesh) -> list[str]:
    """zamba2's smoke train step (Mamba2 heads over the model axis, the
    shared GQA blocks through flash) and decode on the mesh, against no
    mesh."""
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.transformer import (init_caches, init_lm,
                                                lm_decode_step)
    dp, model, _ = mesh_axes(mesh)
    shape = tuple(mesh.shape.values())
    cfg = dist_smoke_cfg("zamba2-2.7b")
    batch = TokenPipeline(cfg.vocab, 32, 8, seed=1,
                          device=mesh.device).batch(0)
    want = dist_one_step(cfg, init_lm(0, cfg, device=mesh.device), batch)
    got = dist_one_step(cfg, dist_place(init_lm(0, cfg, device=mesh.device),
                                        mesh)[0], batch, mesh)
    lines = [dist_step_check(f"{cfg.name} sharded step over {shape}", got,
                             want)]
    params = init_lm(0, cfg, device=mesh.device)
    placed, _ = dist_place(init_lm(0, cfg, device=mesh.device), mesh)
    b = 2 * mesh.shape["data"]
    caches = init_caches(cfg, b, 4, device=mesh.device, mesh=mesh,
                         dp_axes=dp, model_axis=model)
    one = init_caches(cfg, b, 4, device=mesh.device)
    toks = torch.arange(b, device=mesh.device) * 7 % cfg.vocab
    worst = 0.0
    with torch.no_grad():
        for i in range(3):
            lg, caches = lm_decode_step(placed, cfg, toks, caches, i,
                                        mesh=mesh, dp_axes=dp,
                                        model_axis=model, max_len=4)
            ref, one = lm_decode_step(params, cfg, toks, one, i)
            lg = col.gather(lg, mesh, 0, dp)
            worst = max(worst, float((lg - ref).abs().max()
                                     / ref.abs().max()))
            toks = ref.argmax(-1)
    lines.append(f"{cfg.name} lm_decode_step over {shape}: 3 steps, logits "
                 f"within {worst:.3e} of max|no mesh| (limit "
                 f"{DIST_DECODE_RTOL:g})")
    assert worst <= DIST_DECODE_RTOL, lines[-1]
    return lines


def dist_int8_smoke(mesh) -> str:
    """An int8 train step of llama3.2-1b's smoke weights placed on the
    mesh against the unplaced step: parameters, codes and scales bit for
    bit (codes gathered and padded as the reference lays them out).  On
    a mesh of more than one rank, whose grads sum in another order, the
    step's update from the unplaced step's grads, each rank taking its
    blocks (AdamW without the clip, whose global grad norm would sum in
    another order too)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import adamw, build_train_step
    from repro_torch.train.optim import Optimizer, tree_leaves, tree_map
    dp, model, _ = mesh_axes(mesh)
    cfg = dist_smoke_cfg("llama3.2-1b")
    batch = TokenPipeline(cfg.vocab, 32, 8, seed=1,
                          device=mesh.device).batch(0)
    opt = adamw(1e-3, quantized=True, grad_clip=1.0 if mesh.size == 1
                else 0.0)
    params = init_lm(0, cfg, device=mesh.device)
    state = opt.init(params)
    grads = {}

    def keep(g, s, p):
        grads["g"] = tree_map(torch.clone, g)
        return opt.update(g, s, p)

    build_train_step(cfg, Optimizer(opt.init, keep))(params, state, batch)
    placed, shard = dist_place(init_lm(0, cfg, device=mesh.device), mesh)
    pstate = opt.init(placed)
    if mesh.size == 1:
        build_train_step(cfg, opt, mesh=mesh, dp_axes=dp, model_axis=model)(
            placed, pstate, batch)
    else:
        with torch.no_grad():
            opt.update(tree_map(lambda g, sh: sh.block(g).clone(),
                                grads["g"], shard), pstate, placed)
    got, want = dist_whole(placed), dist_whole(params)
    same = set(got) == set(want) and all(torch.equal(got[k], want[k])
                                         for k in want)
    n_q = 0
    for mom in ("m", "v"):
        for q, w in zip(tree_leaves(pstate[mom]), tree_leaves(state[mom])):
            codes, scale = q.whole()
            same &= torch.equal(codes, w.codes) and torch.equal(scale,
                                                                 w.scale)
            n_q += 1
    line = (f"{cfg.name} int8 step on parameters placed over "
            f"{tuple(mesh.shape.values())} vs unplaced"
            f"{'' if mesh.size == 1 else ' (from its grads)'}: {len(want)} "
            f"parameters and {n_q} moments' codes and scales bit for bit: "
            f"{same}")
    assert same, line
    return line




def dist_engine(cfg, params, batch, max_new, *, mesh=None, slots=None,
                max_len=None):
    """``batch``'s prompts through a ``ServeEngine`` (on ``mesh`` when
    given; greedy), stepped here: (requests, each prefill's last logits
    in fp32, host ms of each engine step, wall seconds)."""
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.serve import ServeEngine
    kw = {}
    if mesh is not None:
        dp, model, _ = mesh_axes(mesh)
        kw = dict(mesh=mesh, dp_axes=dp, model_axis=model)
    eng = ServeEngine(cfg, params, slots=slots or LM_SLOTS,
                      max_len=max_len or LM_MAX_LEN, **kw)
    firsts, sample = [], eng._sample

    def record(logits):
        if logits.shape[0] == 1:            # a prefill's (decode: slots)
            firsts.append(logits.float().clone())
        return sample(logits)

    eng._sample = record
    reqs = [eng.submit(p, max_new=max_new) for p in batch]
    steps = []
    t0 = time.perf_counter()
    with torch.no_grad():
        while not all(r.done for r in reqs):
            t_a = time.perf_counter()
            eng.step()                    # ends in .tolist(): synchronized
            steps.append((time.perf_counter() - t_a) * 1e3)
            assert len(steps) <= len(reqs) * max_new, "did not converge"
    return reqs, firsts, steps, time.perf_counter() - t0


def distributed_phase(card: str) -> None:
    """The default run's distributed phase: one rank a visible card."""
    import tempfile
    sys.path.insert(0, str(ROOT / "tools"))
    from ranks import run_ranks
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as ckpt:
        res = run_ranks(dist_rank_smoke, world, ckpt, device_type="cuda",
                        timeout_s=DIST_TIMEOUT_S)
    for line in res[0]["lines"]:
        log(f"{line}  [{card}]")


def dist_flash_shapes(card: str) -> None:
    """``--mesh``'s timing: flash at the per-rank shapes of
    ``--distributed``'s served prefills, (d)'s qwen3-0.6b at its buckets
    and (e)'s zamba2-2.7b at its prompts' lengths, a model rank's q and kv
    heads over a model axis of 2 and of 4, in bf16 and fp32: each call
    checked against its plain core, the two timed beside the bound
    (``bound_ms``: the bytes moved once, 2·(D + DV) operations a live pair
    at the dtype's peak) and one ``F.scaled_dot_product_attention`` call
    (the library), summed over the lengths."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for arch, n_req in ((LM_ARCH, LM_REQUESTS),
                        ("zamba2-2.7b", DIST_REC_REQUESTS)):
        cfg = configs.get(arch)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        lengths = sorted(lm_buckets(cfg)) if arch == LM_ARCH else sorted(
            {len(p) for p in prompts(cfg.vocab, n_req, LM_PROMPT_LEN, 0)})
        for m in (2, 4):
            for dt in (torch.bfloat16, torch.float32):
                ms = plain = bound = lib = 0.0
                for s in lengths:
                    case = flash_case((1, hq // m, max(1, hkv // m), s, s, d,
                                       True), dt, rng, dev)
                    check_case(case)
                    ms += time_ms(case.run)
                    plain += time_ms(case.plain)
                    lib += time_ms(case.library)
                    bound += bound_ms(case.nbytes, case.flops, case.rate)[0]
                log(f"flash at {arch}'s per-rank shape over a model axis of "
                    f"{m} ({hq // m} q / {max(1, hkv // m)} kv heads, D {d}),"
                    f" {str(dt).split('.')[-1]}, one call at each of the "
                    f"{len(lengths)} served lengths {lengths[0]}-"
                    f"{lengths[-1]}: kernel {ms:.4f} ms, plain core "
                    f"{plain:.4f} ms, bound {bound:.5f} ms, SDPA {lib:.4f} "
                    f"ms in all  [{card}]")


def dist_train_steps(cfg, params, mesh, n: int, profiled: int = 0):
    """``n`` bf16 steps of what ``launch.train.train`` builds (AdamW, the
    cosine schedule from 3e-4, the launcher's pipeline) on ``params``
    (placed on ``mesh``, or on one card): (losses, aux losses, step ms,
    and with ``profiled`` the device events of that many more steps)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.train import adamw, build_train_step
    from repro_torch.train.optim import cosine_schedule
    opt = adamw(cosine_schedule(3e-4, warmup=min(20, n // 10 + 1), total=n))
    kw = {}
    if mesh is not None:
        dp, model, _ = mesh_axes(mesh)
        kw = dict(mesh=mesh, dp_axes=dp, model_axis=model)
    step = build_train_step(cfg, opt, **kw)
    state = [params, opt.init(params)]
    dev = mesh.device if mesh is not None else dist_device()
    pipe = TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                         device=dev)
    hist, aux, ms = [], [], []

    def one(s):
        state[0], state[1], m = step(state[0], state[1], pipe.batch(s))
        return m

    for s in range(n):
        t0 = time.perf_counter()
        m = one(s)
        hist.append(m["loss"].item())
        aux.append(m["aux"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    events = None
    if profiled:
        it = iter(range(n, n + profiled))
        events = device_events(lambda: one(next(it)), profiled)
    del state
    return hist, aux, ms, events


def dist_profile_line(events, n: int) -> str:
    """Device busy, idle share, the NCCL kernels' time and the top
    kernels of ``n`` profiled steps on this rank's card."""
    busy, window = device_busy(events)
    by = {}
    for e in events:
        name = kernel_base(e.name)
        # the profiler also puts each collective's span ("nccl:...") on
        # the device's timeline, beside its kernel: count the kernel
        if not name.startswith("nccl:"):
            by[name] = by.get(name, 0.0) + e.time_range.end \
                - e.time_range.start
    nccl = sum(t for k, t in by.items() if k.startswith("ncclDevKernel"))
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    return (f"profile of {n} steps, rank 0's card: busy {busy / n / 1e3:.4f}"
            f" ms a step of {window / n / 1e3:.4f}, idle "
            f"{1 - busy / window:.3f}; NCCL kernels {nccl / n / 1e3:.4f} ms "
            f"a step; top: " + ", ".join(
                f"{k[:48]} {t / n / 1e3:.4f}" for k, t in top))


def dist_loss_line(what, hist, ms) -> str:
    steps = ms[TRAIN_WARM:]
    p50 = statistics.median(steps)
    line, ok = loss_bar(what, hist)
    line += (f"; step p50 {p50:.4f} ms over {len(steps)} steps after "
             f"{TRAIN_WARM} (host clock, synchronized), "
             f"{TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.1f} tokens/s")
    assert ok, line
    return line


def dist_bandwidth(mesh, mb: int = 64, n: int = 5) -> str:
    """The collectives' measured rates on ``mesh``: an fp32 all-reduce
    and an all-gather of ``mb`` MiB over each axis, by CUDA events over
    ``n`` calls after one warm-up (bus bandwidth, NCCL's convention:
    2(k-1)/k of the bytes for an all-reduce, (k-1)/k for a gather)."""
    import torch.distributed as dist
    out = []
    for axis in mesh.axis_names:
        k = mesh.shape[axis]
        if k == 1:
            continue
        group = mesh.group(axis)
        x = torch.ones(mb * 2**18, device=mesh.device)
        y = torch.empty(k * x.numel(), device=mesh.device)
        for what, call, factor in (
                ("all-reduce", lambda: dist.all_reduce(x, group=group),
                 2 * (k - 1) / k),
                ("all-gather", lambda: dist.all_gather_into_tensor(
                    y, x, group=group), (k - 1))):
            call()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(n):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / n
            gbs = factor * mb * 2**20 / (ms * 1e-3) / 1e9
            out.append(f"{what} of {mb} MiB over {axis!r} ({k} ranks) "
                       f"{ms:.3f} ms, bus {gbs:.1f} GB/s")
    return "collectives: " + "; ".join(out)


def dist_rank_full(rank: int, world: int, emit) -> None:
    """``--distributed``: (a), (b) and (c) above on this rank, rank 0's
    lines printed as they come (``emit``)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.weights import param_dtypes, param_shapes
    dist_setup()
    kernels = dist_kernels()
    emit(f"--distributed: {world} ranks, NCCL, one a card")
    dev = dist_device()
    # (a) llama3.2-1b at its published size over (2, 2)
    mesh = make_process_mesh((2, 2), ("data", "model"))
    line = dist_bandwidth(mesh)
    if rank == 0:
        emit(line)
    full = configs.get("llama3.2-1b")
    cfg32 = dataclasses.replace(full, dtype="float32")
    from repro_torch.data import TokenPipeline
    batch = TokenPipeline(full.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                          device=dev).batch(0)
    want = None
    if rank == 0:
        want = dist_one_step(cfg32, init_lm(0, cfg32, device=dev), batch)
        free_cuda()
    dist.barrier()
    placed, _ = dist_place(init_lm(0, cfg32, device=dev), mesh)
    free_cuda()
    got = dist_one_step(cfg32, placed, batch, mesh)
    if rank == 0:
        emit(dist_step_check(
            "llama3.2-1b published size, fp32 step over (2, 2), batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}", got, want))
    del placed, got, want
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    placed, _ = dist_place(init_lm(0, full, device=dev), mesh)
    for fn in kernels.values():
        fn.launches = 0
    hist, _, ms, _ = dist_train_steps(full, placed, mesh, DIST_STEPS)
    counts = {n: fn.launches for n, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    free_cuda()
    placed, _ = dist_place(init_lm(0, full, device=dev), mesh)
    events = dist_train_steps(full, placed, mesh, 1, DIST_PROFILED)[3]
    del placed
    free_cuda()
    if rank == 0:
        emit(dist_loss_line(
            f"llama3.2-1b bf16 over (2, 2), {DIST_STEPS} steps", hist, ms)
            + f"; launches on rank 0 {counts}; peak {peak:.3f} GiB a rank; "
            + dist_profile_line(events, DIST_PROFILED))
        h1, _, ms1, ev1 = dist_train_steps(
            full, init_lm(0, full, device=dev), None, DIST_STEPS,
            DIST_PROFILED)
        emit(dist_loss_line(
            f"llama3.2-1b bf16 on one card, {DIST_STEPS} steps", h1, ms1)
            + "; " + dist_profile_line(ev1, DIST_PROFILED))
        free_cuda()
    want_n = full.n_layers * DIST_STEPS
    assert counts == {n: want_n for n in kernels}, counts
    dist.barrier()
    # (b) deepseek-v3 at its published width, depth cut, over (1, 4)
    mesh = make_process_mesh((1, 4), ("data", "model"))
    cfg = dataclasses.replace(configs.get("deepseek-v3-671b"),
                              n_layers=DIST_DEEPSEEK_LAYERS)
    placed, shard = dist_place(init_lm(0, cfg, device=dev), mesh)
    free_cuda()
    specs = sharding.param_specs(param_shapes(cfg), mesh)
    stated = sum(row[3] for row in sharding.explain(
        param_shapes(cfg), specs, mesh, param_dtypes(cfg)))
    from repro_torch.train.optim import tree_leaves
    held = sum(col.local(t).numel() * col.local(t).element_size()
               for t in tree_leaves(placed))
    drops, loads = [0, 0], []
    a2a = moe.moe_a2a

    def counted_a2a(*args, **kw):
        stats = {}
        out = a2a(*args, **{**kw, "stats": stats})
        d = stats["dropped"]
        n = torch.tensor([int(d.sum()), d.numel()], device=d.device)
        dist.all_reduce(n)
        load = stats["load"].clone()
        dist.all_reduce(load)
        drops[0] += int(n[0])
        drops[1] += int(n[1])
        loads.append(float(load.max()) / float(load.float().mean()))
        return out

    moe.moe_a2a = counted_a2a
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    try:
        hist, aux, ms, events = dist_train_steps(cfg, placed, mesh,
                                                 DIST_STEPS, DIST_PROFILED)
    finally:
        moe.moe_a2a = a2a
    counts = {n: fn.launches for n, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    free_cuda()
    if rank == 0:
        n_exp = cfg.moe.n_experts // mesh.shape["model"]
        emit(dist_loss_line(
            f"deepseek-v3 published width, depth {DIST_DEEPSEEK_LAYERS} "
            f"(3 dense MLA + 1 MoE of {cfg.moe.n_experts} experts, "
            f"{n_exp} a card), bf16, fp32 moments, over (1, 4), batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}", hist, ms)
            + f"; launches on rank 0 {counts}; peak {peak:.3f} GiB a rank "
              f"(max_memory_allocated); parameters a rank: explain() "
              f"{stated / 2**30:.3f} GiB, held {held / 2**30:.3f} GiB; "
              f"a2a dropped {drops[0]} of {drops[1]} (token, k) entries "
              f"over {DIST_STEPS + DIST_PROFILED} forwards (capacity factor "
              f"{cfg.moe.capacity_factor}); the busiest expert's load over "
              f"the mean: first forward {loads[0]:.2f}, last {loads[-1]:.2f}"
              f"; aux {aux[0]:.4f} -> {aux[-1]:.4f}; "
            + dist_profile_line(events, DIST_PROFILED))
    assert stated == held, (stated, held)
    assert counts == {n: cfg.n_layers * (DIST_STEPS + DIST_PROFILED)
                      for n in kernels}, counts
    dist.barrier()
    # (c) pipeline_apply over 4 stages, one a card
    mesh = make_process_mesh((PIPE_STAGES,), ("stage",))
    for n_micro, mb, d in PIPE_SHAPES:
        g = torch.Generator(dev).manual_seed(d)
        W = torch.randn((PIPE_STAGES, d, d), generator=g, device=dev) \
            * (1.2 / math.sqrt(d))
        xs = torch.randn((n_micro, mb, d), generator=g, device=dev)
        w = sharding.device_put(W, sharding.NamedSharding(
            mesh, ("stage", None, None)))
        col.local(w).requires_grad_(True)
        ys = pipeline_apply(lambda p, x: torch.tanh(x @ p), w, xs,
                            mesh=mesh, axis="stage")
        ys.sum().backward()
        grad = col.gather(col.local(w).grad, mesh, 0, "stage")
        Wr = W.clone().requires_grad_(True)
        r = xs
        for i in range(PIPE_STAGES):
            r = torch.tanh(r @ Wr[i])
        r.sum().backward()
        fwd = float((ys - r).detach().abs().max())
        bwd = float((grad - Wr.grad).abs().max())
        line = (f"pipeline_apply over {PIPE_STAGES} stages on {world} "
                f"cards, n_micro {n_micro}, mb {mb}, d {d}, fp32: ys "
                f"max|diff| {fwd:.3e} (limit {PIPE_FWD_ATOL:g}), grads "
                f"{bwd:.3e} (limit {PIPE_GRAD_ATOL:g})")
        assert fwd < PIPE_FWD_ATOL and bwd < PIPE_GRAD_ATOL, line
        emit(line)


def dist_rank_all(rank: int, world: int, card: str, sections: str,
                  ckpt_dir: str, dry: dict | None = None) -> None:
    """``--distributed``'s sections on this rank: (a)-(c)
    (``dist_rank_full``) under "abc", (d)-(g), (w) and (x) under "d", "e",
    "f", "g", "w", "x" (``dry``: the dry run's record for (x)); rank 0
    prints the lines as they come (a failure keeps what came before)."""
    emit = DistReport(rank, card)
    if "abc" in sections:
        dist_rank_full(rank, world, emit)
    free_cuda()
    dev = dist_device()
    dist_setup()
    if "d" in sections:
        dist_serve_full(rank, dev, emit, LM_ARCH, LM_REQUESTS, LM_MAX_NEW,
                        timing=True)
        dist_long_decode(rank, dev, emit)
        stamp_rank(rank, "(d) qwen3-0.6b served over (2, 2) and (1, 4)")
    if "e" in sections:
        for arch in DIST_REC:
            dist_rec_full(rank, dev, emit, arch)
            dist_serve_full(rank, dev, emit, arch, DIST_REC_REQUESTS,
                            DIST_REC_MAX_NEW, timing=False)
            stamp_rank(rank, f"(e) {arch} over (2, 2) and (1, 4)")
    if "f" in sections or "g" in sections:
        dist_grok_full(rank, dev, emit, ckpt_dir, train="f" in sections,
                       checkpoint="g" in sections)
        stamp_rank(rank, "(f, g) grok-1 with int8 moments")
    if "w" in sections:
        dist_witness(rank, dev, emit)
        stamp_rank(rank, "(w) the witnesses of rounding")
    if "x" in sections:
        dist_dryrun_check(rank, dev, emit, dry)
        stamp_rank(rank, "(x) the dry run against four cards")
    assert not emit.failed, emit.failed


class DistReport:
    """Rank 0's lines of every section, printed as they come.  A check
    that only rank 0 can make (against its one-card run) is recorded here
    and fails the run after the last section, so the other ranks never
    wait for it at a barrier; checks every rank makes alike assert where
    they stand."""

    def __init__(self, rank: int, card: str):
        self.rank, self.card, self.failed = rank, card, []

    def __call__(self, line: str, ok: bool = True) -> None:
        if self.rank == 0:
            log(f"{line}{'' if ok else '  FAIL'}  [{self.card}]")
            if not ok:
                self.failed.append(line)


def stamp_rank(rank: int, what: str) -> None:
    if rank == 0:
        stamp(what)


def distributed_full_phase(card: str, sections: str) -> None:
    """``--distributed[=sections]``: one rank a card, four cards."""
    import tempfile
    sys.path.insert(0, str(ROOT / "tools"))
    from ranks import run_ranks
    world = torch.cuda.device_count()
    assert world >= 4, f"--distributed needs 4 cards, found {world}"
    dry = None
    if "x" in sections:
        dry = dryrun_cell((2, 2))
        log(f"(x) dry run of {TRAIN_ARCH}'s train step over (2, 2) on a "
            f"fake group of 4: {dry['host_s']:.2f} s on the host")
    with tempfile.TemporaryDirectory() as ckpt:
        run_ranks(dist_rank_all, 4, card, sections, ckpt, dry,
                  device_type="cuda", timeout_s=DIST_FULL_TIMEOUT_S)


# ``--distributed``'s sections (d)-(f), the rest of the LM over a mesh, at
# published width on four cards, each over (2, 2) and (1, 4) where named
# (rank 0 draws the one-card run while the others wait):
# (d) qwen3-0.6b, not cut, served through ``ServeEngine(mesh=)`` with the
#     launcher's defaults (LM_REQUESTS prompts of LM_PROMPT_LEN from seed
#     0, LM_SLOTS slots, LM_MAX_LEN positions, LM_MAX_NEW new tokens,
#     greedy): in fp32 each prefill's last logits within DIST_LOGIT_RTOL
#     of max|logits| of one card's engine and the tokens equal, or apart
#     only where one card's logits tie within 2 DIST_LOGIT_RTOL
#     (``dist_margins``); in bf16 tok/s, engine step p50 and flash's
#     launches beside one card's; then one row of a DIST_LONG_PROMPT-token
#     prompt in fp32, prefilled and decoded DIST_LONG_NEW steps with the
#     caches' sequence over all four ranks (``dist_long_decode``);
# (e) zamba2-2.7b and xlstm-350m, not cut: one fp32 step (batch
#     DIST_FP32_BATCH x TRAIN_SEQ, the moments drawn after the backward:
#     ``dist_step_lean``) against one card's, loss within DIST_LOSS_RTOL,
#     grad norm DIST_GNORM_RTOL, parameters in AdamW's unit
#     (``dist_unit_check``), each leaf's first moment's distance printed;
#     xlstm's fp32 step is printed beside one card's fp32 step's distance
#     from its fp64 step, and its fp64 step is held to those bars and
#     each first moment within DIST_FP64_RTOL (``dist_rec_steps``);
#     DIST_STEPS bf16 steps with the loss falling, step p50, peak a rank
#     and a profile's NCCL share; the fp32 engine (DIST_REC_REQUESTS
#     requests, DIST_REC_MAX_NEW tokens): tokens as in (d), the prefill
#     logits' distance printed (54 Mamba2 blocks sum in another order over
#     the mesh: 1.543e-5 of max|one card| measured, zamba2 over (2, 2));
# (f) grok-1 at its published width with int8 moments: 1 layer over (1,
#     4) (its experts through ``moe_a2a`` at capacity DIST_CAPACITY) against
#     one card's int8 step, both in bf16, which every rank runs on its own
#     card and holds its blocks to (no rank waits on another's check at a
#     barrier; the counts summed over the ranks): loss and grad norm within
#     DIST_BF16_RTOL; the shares of parameter entries past DIST_LR_BAND lr
#     and of moment entries past one code step, of one card's step against
#     the mesh's bf16 step and against its fp32 step (the same weights),
#     one card's against the fp32 step within DIST_WITNESS times the mesh's
#     own bf16 step's (``dist_grok_one_layer``); 2 layers over (1, 4),
#     DIST_STEPS steps with the loss falling, peak a rank, explain()'s
#     bytes against the held blocks, a profile;
# (g) that state (about 43 GiB) saved, its size and times, restored onto
#     (2, 2) bit for bit, and step DIST_STEPS + 1 on both meshes.
# (w) the witnesses that tell a fault of the mesh from rounding: xlstm's
#     steps of (e) (fp32 and fp64, ``dist_rec_steps``) and grok-1's 1-layer
#     step of (f) with DIST_STEPS int8 steps of one card and of (1, 4) side
#     by side (``dist_grok_one_layer(curves=True)``).
DIST_FULL_TIMEOUT_S = 3300
DIST_LONG_PROMPT, DIST_LONG_NEW = 8192, 16
DIST_SHAPES = ((2, 2), (1, 4))
DIST_REC = ("zamba2-2.7b", "xlstm-350m")
DIST_REC_REQUESTS, DIST_REC_MAX_NEW = 8, 16
DIST_LOGIT_RTOL = 1e-5
DIST_FP32_BATCH = TRAIN_BATCH // 2
# xLSTM's backward amplifies fp32's rounding past 6b's grad-norm bar (one
# card's fp32 step is as far from its fp64 step as the mesh's): its step is
# held to one card's in float64, where the two compute the same function
# to within the moments' fp32 storage
DIST_FP64 = ("xlstm-350m",)
DIST_FP64_RTOL = 1e-6
DIST_LR = 1e-3
DIST_LR_BAND, DIST_FLIP_SHARE = 0.1, 1e-4
DIST_RESUME_RTOL = 1e-2
# grok-1's 1-layer step runs in bf16 (its fp32 weights, grads and moments
# outgrow one card): its loss and grad norm against one card's within
# this, the bars of (f) being the moments' and the parameters'
DIST_BF16_RTOL = 1e-2
DIST_WITNESS = 2.0
CODE_STEP = 2.0 ** (24.0 / 126.0) - 1.0


def dist_peak() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def dist_step_lean(cfg, params, batch, mesh=None, quantized=False):
    """One AdamW step (lr DIST_LR) of ``params`` (placed on ``mesh`` when
    given), the moments drawn after the backward: (metrics as floats, the
    parameters, the optimizer state)."""
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.train import adamw, build_train_step
    kw = {}
    if mesh is not None:
        dp, model, _ = mesh_axes(mesh)
        kw = dict(mesh=mesh, dp_axes=dp, model_axis=model)
    opt = adamw(DIST_LR, quantized=quantized)
    box = {}

    def update(g, s, p):
        box["state"] = opt.init(p)
        return opt.update(g, box["state"], p)

    from repro_torch.train.optim import Optimizer
    step = build_train_step(cfg, Optimizer(init=opt.init, update=update),
                            **kw)
    params, _, m = step(params, None, batch)
    return {k: float(v) for k, v in m.items()}, params, box["state"]


def dist_unit_check(what, gm, gp, wm, wp, gnorm_rtol,
                    loss_rtol=DIST_LOSS_RTOL) -> tuple[str, bool]:
    """A sharded step against one card's: loss, grad norm, and each
    parameter entry within 1e-5 of its leaf's max|one card| plus
    DIST_LR_BAND of the lr (plus one bf16 ulp of the entry for bf16
    leaves) on all but DIST_FLIP_SHARE of the entries: AdamW's unit, in
    which a grad near zero that the two sum to other signs moves its
    entry by up to twice the lr.  -> (the line, whether it passed)."""
    loss = dist_rel(gm, wm, "loss")
    gnorm = dist_rel(gm, wm, "grad_norm")
    outside = total = 0
    worst = 0.0
    for k, w in wp.items():
        o, t, wst = dist_param_apart(gp[k].detach(),
                                     w.detach().to(gp[k].device))
        outside, total, worst = outside + o, total + t, max(worst, wst)
    line = (f"{what}: loss {gm['loss']:.6f} vs one card {wm['loss']:.6f} "
            f"(rel {loss:.3e}, limit {loss_rtol:g}); grad norm rel "
            f"{gnorm:.3e} (limit {gnorm_rtol:g}); parameters: {outside} of "
            f"{total} entries past {DIST_LR_BAND:g} lr (limit "
            f"{DIST_FLIP_SHARE:g} of them), the worst {worst:.3f} lr")
    return line, (loss <= loss_rtol and gnorm <= gnorm_rtol
                  and outside <= DIST_FLIP_SHARE * total)


def dist_margins(cfg, params, batch, got, want):
    """Tokens of two engines on the same prompts: (requests equal, those
    apart only where one card's logits (``params``, teacher-forced over
    the prompt and its own tokens) tie within 2 DIST_LOGIT_RTOL of their
    max at the first token apart, the largest such gap)."""
    from repro_torch.models.transformer import lm_forward
    equal = ties = 0
    worst = 0.0
    dev = params["embed"].device
    for p, g, w in zip(batch, got, want):
        if g.out == w.out:
            equal += 1
            continue
        i = next(k for k, (a, b) in enumerate(zip(g.out, w.out)) if a != b)
        seq = torch.as_tensor(np.concatenate([p, w.out[:i]]), device=dev)
        with torch.no_grad():
            row = lm_forward(params, cfg, tokens=seq[None])[0][0, -1]
        gap = float((row[w.out[i]] - row[g.out[i]]) / row.abs().max())
        worst = max(worst, gap)
        ties += gap <= 2 * DIST_LOGIT_RTOL
    return equal, ties, worst


def dist_serve_full(rank, dev, emit, arch, n_req, max_new, *,
                    timing: bool) -> None:
    """(d), or (e)'s engine: ``arch`` not cut, served over each of
    DIST_SHAPES against one card's engine in fp32 (the tokens
    margin-aware; the prefill logits within DIST_LOGIT_RTOL under
    ``timing``, (d)'s bar, else printed); with ``timing`` the same in
    bf16, timed."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import prompts
    from repro_torch.models.transformer import init_lm
    kernels = dist_kernels()
    full = configs.get(arch)
    cfg32 = dataclasses.replace(full, dtype="float32")
    batch = prompts(full.vocab, n_req, LM_PROMPT_LEN, 0)
    want = p1 = None
    if rank == 0:
        p1 = init_lm(0, cfg32, device=dev)
        want = dist_engine(cfg32, p1, batch, max_new)
    for shape in DIST_SHAPES:
        dist.barrier()
        mesh = make_process_mesh(shape, ("data", "model"))
        placed, _ = dist_place(init_lm(0, cfg32, device=dev), mesh)
        free_cuda()
        got = dist_engine(cfg32, placed, batch, max_new, mesh=mesh)
        del placed
        free_cuda()
        if rank == 0:
            rel = max(rel_err(g, w)[1] for g, w in zip(got[1], want[1]))
            equal, ties, gap = dist_margins(cfg32, p1, batch, got[0],
                                            want[0])
            bar = (f"limit {DIST_LOGIT_RTOL:g}" if timing
                   else "not a bar: the tokens are")
            line = (f"{arch} fp32 ServeEngine(mesh=) over {shape}, "
                    f"{len(batch)} requests x {max_new} tokens: prefill "
                    f"logits within {rel:.3e} of max|one card| ({bar}); "
                    f"tokens equal on {equal} "
                    f"requests, apart at a tie on {ties} (largest gap "
                    f"{gap:.3e}); wall {got[3]:.4f} s against one card's "
                    f"{want[3]:.4f} s")
            emit(line, (rel <= DIST_LOGIT_RTOL or not timing)
                 and equal + ties == len(batch))
    del p1, want
    free_cuda()
    if not timing:
        return
    dist.barrier()
    one = None
    if rank == 0:
        for fn in kernels.values():
            fn.launches = 0
        one = dist_engine(full, init_lm(0, full, device=dev), batch,
                          max_new)
        emit(dist_serve_line(f"{arch} bf16 ServeEngine on one card", one,
                             kernels))
        free_cuda()
    for shape in DIST_SHAPES:
        dist.barrier()
        mesh = make_process_mesh(shape, ("data", "model"))
        placed, _ = dist_place(init_lm(0, full, device=dev), mesh)
        free_cuda()
        for fn in kernels.values():
            fn.launches = 0
        got = dist_engine(full, placed, batch, max_new, mesh=mesh)
        del placed
        free_cuda()
        counts = {n: fn.launches for n, fn in kernels.items()}
        emit(dist_serve_line(f"{arch} bf16 ServeEngine(mesh=) over {shape}",
                             got, kernels) + (
            f"; tokens equal to one card's on "
            f"{sum(g.out == w.out for g, w in zip(got[0], one[0]))} of "
            f"{len(batch)} requests" if rank == 0 else ""))
        assert counts["flash_attention"] == len(batch) * full.n_layers, \
            counts


def dist_long_run(cfg, params, prompt, max_len, toks=None, mesh=None):
    """One row's prefill of ``prompt`` into caches of ``max_len``
    positions, then a decode step a token: ``toks`` (teacher-forced), or
    each step's greedy token.  -> (the prefill's and each step's logits,
    fp32 ``(1, V)``, the tokens fed, the caches, the last step's
    collective bytes a device (``Tally``; on ``mesh``))."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.transformer import lm_decode_step, lm_prefill
    kw = {}
    if mesh is not None:
        dp, model, _ = mesh_axes(mesh)
        kw = dict(mesh=mesh, dp_axes=dp, model_axis=model)
    n = DIST_LONG_NEW if toks is None else len(toks)
    fed = []
    with torch.no_grad():
        lg, caches, _ = lm_prefill(params, cfg, prompt, max_len=max_len,
                                   **kw)
        out = [lg.float()]
        for i in range(n):
            tok = out[-1].argmax(-1) if toks is None else toks[i:i + 1]
            fed.append(tok)
            with col.tallied() as tally:
                lg, caches = lm_decode_step(
                    params, cfg, tok, caches, prompt.shape[1] + i,
                    **(dict(kw, max_len=max_len) if kw else {}))
            out.append(lg.float())
    return out, torch.cat(fed), caches, tally.per_device()


def dist_old_cache_bytes(cfg, mesh, b: int, max_len: int) -> int:
    """A rank's attention caches of an all-attention model in the port's
    layout before ``cache_specs``' one: its rows of ``b``, the sequence
    whole, the kv heads its q heads read."""
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.attention import local_heads
    from repro_torch.models.layers import dtype_of, shard_axes
    from repro_torch.models.transformer import _batch_axes
    dp, model, _ = mesh_axes(mesh)
    with shard_axes(_batch_axes(b, dp, mesh), model, mesh) as ax:
        rows = b // ax.dp_size
        n_kv = len(local_heads(cfg.n_heads, cfg.n_kv_heads)[2])
    item = torch.empty((), dtype=dtype_of(cfg.dtype)).element_size()
    return (2 * cfg.n_layers * rows * max_len * n_kv
            * cfg.resolved_head_dim * item)


def dist_long_decode(rank, dev, emit) -> None:
    """(d)'s long context: qwen3-0.6b in fp32, one row of a
    DIST_LONG_PROMPT-token prompt (numpy seed 0) prefilled and decoded
    DIST_LONG_NEW steps over each of DIST_SHAPES (B = 1: the caches'
    sequence over all four ranks, over dp + model on (2, 2) and over
    model on (1, 4)), teacher-forced by one card's greedy tokens: every
    step's logits within DIST_LOGIT_RTOL of max|one card|, the mesh's
    greedy tokens one card's or apart at a tie within 2 DIST_LOGIT_RTOL
    of one card's logits; each rank's cache bytes beside the layout
    before ``cache_specs``' (``dist_old_cache_bytes``), and a decode
    step's collective bytes at this context equal to one at 64
    positions."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.step_analysis import held_bytes
    from repro_torch.models.transformer import init_lm
    cfg = dataclasses.replace(configs.get(LM_ARCH), dtype="float32")
    max_len = DIST_LONG_PROMPT + DIST_LONG_NEW
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, DIST_LONG_PROMPT)), device=dev)
    toks = torch.zeros(DIST_LONG_NEW, dtype=torch.long, device=dev)
    want = None
    if rank == 0:
        want, fed, _, _ = dist_long_run(cfg, init_lm(0, cfg, device=dev),
                                        prompt, max_len)
        toks.copy_(fed)
        free_cuda()
    dist.broadcast(toks, 0)
    for shape in DIST_SHAPES:
        dist.barrier()
        mesh = make_process_mesh(shape, ("data", "model"))
        placed, _ = dist_place(init_lm(0, cfg, device=dev), mesh)
        t0 = time.perf_counter()
        got, _, caches, tally = dist_long_run(cfg, placed, prompt, max_len,
                                              toks, mesh)
        wall = time.perf_counter() - t0
        held = [None] * mesh.size
        dist.all_gather_object(held, (held_bytes(caches),
                                      dist_old_cache_bytes(cfg, mesh, 1,
                                                           max_len)))
        del caches
        _, _, _, short = dist_long_run(cfg, placed, prompt[:, :48], 64,
                                       toks[:1], mesh)
        del placed
        free_cuda()
        if rank != 0:
            continue
        rel = max(rel_err(g, w)[1] for g, w in zip(got, want))
        mine = [int(g.argmax()) for g in got[:-1]]
        apart = [i for i, (a, b) in enumerate(zip(mine, toks.tolist()))
                 if a != b]
        gaps = [float((want[i][0, toks[i]] - want[i][0, mine[i]])
                      / want[i].abs().max()) for i in apart]
        ties = sum(g <= 2 * DIST_LOGIT_RTOL for g in gaps)
        same_coll = tally["total"] == short["total"]
        emit(f"{LM_ARCH} fp32, one row of a {DIST_LONG_PROMPT}-token "
             f"prompt over {shape} (the caches' sequence over 4 ranks), "
             f"{DIST_LONG_NEW} decode steps teacher-forced by one card's "
             f"greedy tokens: logits within {rel:.3e} of max|one card| "
             f"(limit {DIST_LOGIT_RTOL:g}); greedy tokens equal on "
             f"{DIST_LONG_NEW - len(apart)} of {DIST_LONG_NEW}, apart at a "
             f"tie on {ties}; cache bytes a rank {[h[0] for h in held]} "
             f"(the layout before: {[h[1] for h in held]}); a decode "
             f"step's collective bytes {tally['total']} at {max_len} "
             f"positions, {short['total']} at 64; wall {wall:.4f} s "
             f"(host clock)",
             rel <= DIST_LOGIT_RTOL and len(apart) == ties and same_coll)


def dist_serve_line(what, run, kernels) -> str:
    reqs, _, steps, wall = run
    n_tok = sum(len(r.out) for r in reqs)
    return (f"{what} (host clock): {len(reqs)} requests, {len(steps)} "
            f"steps, {n_tok} tokens in {wall:.4f} s ({n_tok / wall:.2f} "
            f"tok/s), engine step p50 {statistics.median(steps):.4f} ms; "
            f"launches on rank 0 "
            f"{ {n: fn.launches for n, fn in kernels.items()} }")


def dist_witness(rank, dev, emit) -> None:
    """(w): xlstm-350m's fp32 and fp64 steps, grok-1's 1-layer step and
    its loss curves on one card and over (1, 4)."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_process_mesh
    dist_rec_steps(rank, dev, emit, "xlstm-350m")
    full = configs.get("grok-1-314b")
    pipe = TokenPipeline(full.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                         device=dev)
    dist_grok_one_layer(rank, dev, emit, full, pipe,
                        make_process_mesh((1, 4), ("data", "model")),
                        curves=True)


def dist_cast(tree, dtype):
    """A parameter tree with its floating leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: dist_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def dist_moments_apart(got, want) -> tuple[float, str]:
    """The largest distance of a leaf's first moment (0.1 of its clipped
    grad) from ``want``'s, over that leaf's max|want|: (it, the leaf)."""
    worst, at = 0.0, ""
    for k, w in want.items():
        w = w.to(got[k].device)
        d = float((got[k].double() - w.double()).abs().max()) \
            / max(float(w.abs().max()), 1e-30)
        if d >= worst:
            worst, at = d, k
    return worst, at


def dist_rec_steps(rank, dev, emit, arch) -> None:
    """(e)'s fp32 step over each of DIST_SHAPES against one card's (and,
    for DIST_FP64's archs, the float64 step, which holds the mesh to 6b's
    bars where fp32's rounding is amplified past them: DIST_FP64)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.transformer import init_lm
    cfg32 = dataclasses.replace(configs.get(arch), dtype="float32")
    batch = TokenPipeline(cfg32.vocab, TRAIN_SEQ, DIST_FP32_BATCH, seed=0,
                          device=dev).batch(0)
    dtypes = (torch.float32, torch.float64) if arch in DIST_FP64 \
        else (torch.float32,)
    name = {torch.float32: "fp32", torch.float64: "fp64"}
    want = {}
    if rank == 0:
        for dt in dtypes:
            torch.cuda.reset_peak_memory_stats()
            wm, wp, ws = dist_step_lean(
                cfg32, dist_cast(init_lm(0, cfg32, device=dev), dt), batch)
            want[dt] = (wm, {k: v.cpu() for k, v in dist_whole(wp).items()},
                        {k: v.cpu() for k, v in dist_whole(ws["m"]).items()})
            del wp, ws
            free_cuda()
            emit(f"{arch} {name[dt]} step on one card (batch "
                 f"{DIST_FP32_BATCH} x {TRAIN_SEQ}): peak {dist_peak():.3f} "
                 f"GiB")
        if len(dtypes) == 2:
            (m32, _, g32), (m64, _, g64) = want[dtypes[0]], want[dtypes[1]]
            apart, leaf = dist_moments_apart(g32, g64)
            emit(f"{arch} one card's fp32 step against its fp64 step: grad "
                 f"norm rel {dist_rel(m32, m64, 'grad_norm'):.3e}, first "
                 f"moments {apart:.3e} of the leaf's max ({leaf}): fp32's "
                 f"own distance")
    for shape in DIST_SHAPES:
        mesh = make_process_mesh(shape, ("data", "model"))
        for dt in dtypes:
            dist.barrier()
            placed, _ = dist_place(
                dist_cast(init_lm(0, cfg32, device=dev), dt), mesh)
            free_cuda()
            gm, gp, gs = dist_step_lean(cfg32, placed, batch, mesh)
            got, mom = dist_whole(gp), dist_whole(gs["m"])
            del placed, gp, gs
            free_cuda()
            if rank == 0:
                wm, wp, wmom = want[dt]
                line, ok = dist_unit_check(
                    f"{arch} {name[dt]} step over {shape}", gm, got, wm, wp,
                    DIST_GNORM_RTOL)
                apart, leaf = dist_moments_apart(mom, wmom)
                line += (f"; first moments {apart:.3e} of the leaf's max "
                         f"({leaf})")
                if dt == torch.float64:
                    line += f" (limit {DIST_FP64_RTOL:g})"
                    ok = ok and apart <= DIST_FP64_RTOL
                elif len(dtypes) == 2:
                    m64, _, g64 = want[torch.float64]
                    apart64, leaf64 = dist_moments_apart(mom, g64)
                    line += (f"; against one card's fp64 step: grad norm "
                             f"rel {dist_rel(gm, m64, 'grad_norm'):.3e}, "
                             f"first moments {apart64:.3e} ({leaf64}); not "
                             f"a bar: the fp64 step below holds the mesh")
                    ok = True
                emit(line, ok)
            del got, mom
            free_cuda()
    del want
    free_cuda()


def dist_rel(got, want, key) -> float:
    return abs(got[key] - want[key]) / abs(want[key])


def dist_rec_full(rank, dev, emit, arch) -> None:
    """(e)'s training: ``dist_rec_steps``, then DIST_STEPS bf16 steps over
    each of DIST_SHAPES and a profile."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.transformer import init_lm
    full = configs.get(arch)
    dist_rec_steps(rank, dev, emit, arch)
    kernels = dist_kernels()
    for shape in DIST_SHAPES:
        mesh = make_process_mesh(shape, ("data", "model"))
        placed, _ = dist_place(init_lm(0, full, device=dev), mesh)
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        hist, _, ms, events = dist_train_steps(full, placed, mesh,
                                               DIST_STEPS, DIST_PROFILED)
        counts = {n: fn.launches for n, fn in kernels.items()}
        peak = dist_peak()
        del placed
        free_cuda()
        emit(dist_loss_line(f"{arch} bf16 over {shape}, {DIST_STEPS} "
                            f"steps", hist, ms)
             + f"; launches on rank 0 {counts}; peak {peak:.3f} GiB a rank; "
             + dist_profile_line(events, DIST_PROFILED))


def dist_grok_full(rank, dev, emit, ckpt_dir, *, train: bool,
                   checkpoint: bool) -> None:
    """(f) under ``train``, (g) under ``checkpoint`` (above)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.weights import param_dtypes, param_shapes
    from repro_torch.train import CheckpointManager
    from repro_torch.train.optim import moment_shardings, tree_leaves
    full = configs.get("grok-1-314b")
    pipe = TokenPipeline(full.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                         device=dev)
    mesh = make_process_mesh((1, 4), ("data", "model"))
    if train:
        dist_grok_one_layer(rank, dev, emit, full, pipe, mesh)
    # 2 layers over (1, 4): steps, memory, the checkpoint
    cfg2 = dataclasses.replace(full, n_layers=2)
    dist.barrier()
    placed, _ = dist_place(init_lm(0, cfg2, device=dev), mesh)
    free_cuda()
    specs = sharding.param_specs(param_shapes(cfg2), mesh)
    stated = sum(row[3] for row in sharding.explain(
        param_shapes(cfg2), specs, mesh, param_dtypes(cfg2)))
    held = sum(col.local(t).numel() * col.local(t).element_size()
               for t in tree_leaves(placed))
    torch.cuda.reset_peak_memory_stats()
    kernels = dist_kernels()
    for fn in kernels.values():
        fn.launches = 0
    state = dist_int8_steps(cfg2, placed, mesh, pipe, DIST_STEPS)
    hist, ms = state["hist"], state["ms"]
    counts = {n: fn.launches for n, fn in kernels.items()}
    peak = dist_peak()
    events = device_events(lambda: state["step"](DIST_STEPS),
                           DIST_PROFILED)
    n_params = sum(math.prod(t.shape) for t in tree_leaves(placed))
    emit(dist_loss_line(f"grok-1 2 layers ({n_params / 1e9:.2f} B params), "
                        f"int8 moments, bf16, over (1, 4), {DIST_STEPS} "
                        f"steps", hist, ms)
         + f"; launches on rank 0 {counts}; peak {peak:.3f} GiB a rank; "
           f"parameters a rank: explain() {stated / 2**30:.3f} GiB, held "
           f"{held / 2**30:.3f} GiB; " + dist_profile_line(events,
                                                            DIST_PROFILED))
    assert stated == held, (stated, held)
    if not checkpoint:
        del placed, state
        free_cuda()
        return
    # the state after DIST_STEPS + DIST_PROFILED steps, saved, restored
    # onto (2, 2)
    opt_state = state["opt"]
    mgr = CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    path = mgr.save(1, {"params": placed, "opt": opt_state})
    t_save = time.perf_counter() - t0
    size = 0
    if rank == 0:
        size = sum(f.stat().st_size for f in pathlib.Path(path).iterdir())
    m22 = make_process_mesh((2, 2), ("data", "model"))
    like_p, shard22 = dist_place(init_lm(1, cfg2, device=dev), m22)
    free_cuda()
    from repro_torch.train import adamw
    ms22 = moment_shardings(like_p, shard22, quantized=True)
    like = {"params": like_p, "opt": adamw(quantized=True).init(like_p)}
    t0 = time.perf_counter()
    back = mgr.restore(1, like, shardings={"params": shard22,
                                           "opt": {"m": ms22, "v": ms22}})
    t_restore = time.perf_counter() - t0
    del like, like_p
    free_cuda()
    same, n = True, 0
    for a, b in zip(tree_leaves(placed), tree_leaves(back["params"])):
        wa, wb = dist_whole({"x": a})["x"], dist_whole({"x": b})["x"]
        same &= torch.equal(wa, wb)
        n += 1
        del wa, wb
        free_cuda()
    for mom in ("m", "v"):
        for qa, qb in zip(tree_leaves(opt_state[mom]),
                          tree_leaves(back["opt"][mom])):
            wa, wb = qa.whole(), qb.whole()
            same &= torch.equal(wa[0], wb[0]) and torch.equal(wa[1], wb[1])
            n += 2
            del wa, wb
            free_cuda()
    same &= int(back["opt"]["step"]) == int(opt_state["step"])
    step = DIST_STEPS + DIST_PROFILED
    loss_14 = state["step"](step)["loss"].item()
    del placed, opt_state, state
    free_cuda()
    resumed = dist_int8_steps(cfg2, back["params"], m22, pipe, 0,
                              opt_state=back["opt"])
    loss_22 = resumed["step"](step)["loss"].item()
    rel = abs(loss_22 - loss_14) / abs(loss_14)
    line = (f"grok-1 2 layers int8 checkpoint from (1, 4): "
            f"{size / 2**30:.3f} GiB, saved in {t_save:.2f} s, restored "
            f"onto (2, 2) in {t_restore:.2f} s; {n} leaves (parameters, "
            f"codes and scales) bit for bit: {same}; step {step + 1}'s loss "
            f"{loss_22:.6f} on (2, 2) against {loss_14:.6f} on (1, 4) (rel "
            f"{rel:.3e}, limit {DIST_RESUME_RTOL:g})")
    emit(line)
    assert same and rel <= DIST_RESUME_RTOL, line
    del back, resumed
    free_cuda()


def dist_grok_one_layer(rank, dev, emit, full, pipe, mesh, *,
                        curves: bool = False) -> None:
    """(f)'s first half: grok-1 at 1 layer, one int8 step over ``mesh``
    against one card's, which every rank takes on its own card and holds
    its own blocks to (replicated blocks counted once).  Both run in bf16,
    whose grads round apart: the mesh's step also runs with fp32 weights
    (the same bf16 values), and one card's bf16 step must be no further
    from it than DIST_WITNESS times the mesh's own bf16 step is (a fault
    of the mesh would move both of the mesh's steps from one card's).
    With ``curves`` (section w): then DIST_STEPS int8 steps of one card
    and of the mesh, their losses side by side."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as col
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.optim import QTensor, tree_leaves
    cfg1 = dataclasses.replace(full, n_layers=1, moe=dataclasses.replace(
        full.moe, capacity_factor=DIST_CAPACITY))
    batch = pipe.batch(0)
    torch.cuda.reset_peak_memory_stats()
    wm, wp, ws = dist_step_lean(cfg1, init_lm(0, cfg1, device=dev), batch,
                                quantized=True)
    one_p = [t.detach().cpu() for t in tree_leaves(wp)]
    one_q = [QTensor(q.codes.cpu(), q.scale.cpu()) for mom in ("m", "v")
             for q in tree_leaves(ws[mom])]
    del wp, ws
    free_cuda()
    emit(f"grok-1 1 layer int8 step on one card (each rank its own): peak "
         f"{dist_peak():.3f} GiB")
    runs = {}
    for tag in ("bf16", "fp32"):
        dist.barrier()
        cfg, params = cfg1, init_lm(0, cfg1, device=dev)
        if tag == "fp32":
            cfg = dataclasses.replace(cfg1, dtype="float32")
            params = dist_cast(params, torch.float32)
        placed, shard = dist_place(params, mesh)
        del params
        free_cuda()
        runs[tag] = dist_step_lean(cfg, placed, batch, mesh, quantized=True)
        del placed
        free_cuda()
    # per pair (one card's bf16, the mesh's bf16), (one card's bf16, the
    # mesh's fp32), (the mesh's bf16, its fp32): parameter entries past
    # DIST_LR_BAND lr and a bf16 ulp, moment entries past one code step
    apart = torch.zeros(3, 4, dtype=torch.float64, device=dev)
    leaves = {t: tree_leaves(runs[t][1]) for t in runs}
    moms = {t: [q for mom in ("m", "v") for q in tree_leaves(runs[t][2][mom])]
            for t in runs}
    shards = tree_leaves(shard)
    n = len(shards)
    for i, sh in enumerate(shards):
        p16, p32 = leaves["bf16"][i], leaves["fp32"][i]
        if not col.counted_here(p16):
            continue
        one = sh.block(one_p[i]).to(dev)
        for row, (got, want) in enumerate(((p16, one), (p32, one),
                                           (p16, p32))):
            apart[row, :2] += torch.tensor(dist_param_apart(
                col.local(got).detach(), col.local(want).detach())[:2],
                dtype=torch.float64, device=dev)
        del one
        for j in (i, n + i):
            one = dist_moment_block(one_q[j], one_p[i].shape, sh, dev)
            m16 = moms["bf16"][j].local(p16)
            m32 = moms["fp32"][j].local(p32)
            for row, (got, want) in enumerate(((m16, one), (m32, one),
                                               (m16, m32))):
                apart[row, 2:] += torch.tensor(
                    dist_code_steps(got, want), dtype=torch.float64,
                    device=dev)
            del one, m16, m32
    dist.all_reduce(apart)
    share = (apart[:, 0] / apart[:, 1]).tolist(), \
        (apart[:, 2] / apart[:, 3]).tolist()
    gm = runs["bf16"][0]
    loss = dist_rel(gm, wm, "loss")
    gnorm = dist_rel(gm, wm, "grad_norm")
    emit(f"grok-1 1 layer int8 step over (1, 4), bf16: loss {gm['loss']:.6f}"
         f" vs one card {wm['loss']:.6f} (rel {loss:.3e}, limit "
         f"{DIST_BF16_RTOL:g}); grad norm rel {gnorm:.3e} (limit "
         f"{DIST_BF16_RTOL:g}); the mesh's fp32 step: loss "
         f"{runs['fp32'][0]['loss']:.6f}, grad norm rel "
         f"{dist_rel(runs['fp32'][0], wm, 'grad_norm'):.3e}",
         loss <= DIST_BF16_RTOL and gnorm <= DIST_BF16_RTOL)
    for what, (a, b, c), total in (
            (f"parameter entries past {DIST_LR_BAND:g} lr and a bf16 ulp",
             share[0], int(apart[0, 1])),
            ("moment entries (each rank's blocks dequantized) past one code "
             f"step ({CODE_STEP:.4f} of the larger)", share[1],
             int(apart[0, 3]))):
        emit(f"grok-1 1 layer int8 step over (1, 4), {what}, of {total}: "
             f"one card's bf16 against the mesh's bf16 {a:.3e}, against the "
             f"mesh's fp32 {b:.3e}; the mesh's bf16 against its fp32 {c:.3e}"
             f" (limit: one card's no more than {DIST_WITNESS:g}x the "
             f"mesh's)", b <= DIST_WITNESS * c)
    del runs, leaves, moms, one_p, one_q
    free_cuda()
    if not curves:
        return
    hists = {}
    for where in ("one card", "(1, 4)"):
        dist.barrier()
        on = mesh if where == "(1, 4)" else None
        params = init_lm(0, cfg1, device=dev)
        if on is not None:
            params, _ = dist_place(params, on)
        free_cuda()
        state = dist_int8_steps(cfg1, params, on, pipe, DIST_STEPS)
        hists[where] = (state["hist"], state["ms"])
        del params, state
        free_cuda()
    emit("grok-1 1 layer, int8 moments, bf16, " + ", ".join(
        f"{where}: {[round(x, 4) for x in h]} (step p50 "
        f"{statistics.median(ms[3:]):.1f} ms)"
        for where, (h, ms) in hists.items()) + "; not a bar: bf16 steps "
        "round apart, a fault would part the curves from the first step")


def dist_param_apart(got, want) -> tuple[int, int, float]:
    """Entries of a parameter block past DIST_LR_BAND lr of ``want``'s,
    over 1e-5 of its max (and a bf16 ulp of the entry where either is
    bf16): (how many, of how many, the worst in lr)."""
    err = (got.float() - want.float()).abs()
    over = err - 1e-5 * want.float().abs().max()
    if torch.bfloat16 in (got.dtype, want.dtype):
        over = over - want.float().abs() * 2.0 ** -7
    return (int((over > DIST_LR_BAND * DIST_LR).sum()), err.numel(),
            float(over.max()) / DIST_LR)


def dist_moment_block(q, shape, sh, dev, rows=1 << 12):
    """One card's int8 moment ``q`` (on the host) of a parameter of
    ``shape``, dequantized on the card a chunk of rows at a time, and
    ``sh``'s block of it: this rank's entries."""
    from repro_torch.train.optim import dequantize_i8
    codes = q.codes.reshape(-1, q.codes.shape[-1])
    scale = q.scale.reshape(-1, q.scale.shape[-1])
    out = torch.empty((codes.shape[0], shape[-1]), dtype=torch.float32,
                      device=dev)
    for i in range(0, codes.shape[0], rows):
        out[i:i + rows] = dequantize_i8(codes[i:i + rows].to(dev),
                                        scale[i:i + rows].to(dev),
                                        (shape[-1],))
    block = sh.block(out.reshape(shape)).clone()
    del out
    return block


def dist_int8_steps(cfg, params, mesh, pipe, n, opt_state=None) -> dict:
    """``n`` bf16 steps with int8 moments (AdamW, the cosine schedule of
    GROK_SCHEDULE) of ``params`` placed on ``mesh`` (one card's without):
    {"hist", "ms", "opt", "step": one more step of batch ``s``, its
    metrics}."""
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.train import adamw, build_train_step
    from repro_torch.train.optim import cosine_schedule
    kw = {}
    if mesh is not None:
        dp, model, _ = mesh_axes(mesh)
        kw = dict(mesh=mesh, dp_axes=dp, model_axis=model)
    peak, warmup = GROK_SCHEDULE
    opt = adamw(cosine_schedule(peak, warmup=warmup, total=DIST_STEPS + 4),
                quantized=True)
    step = build_train_step(cfg, opt, **kw)
    out = {"hist": [], "ms": [],
           "opt": opt_state if opt_state is not None else opt.init(params)}

    def one(s):
        _, out["opt"], m = step(params, out["opt"], pipe.batch(s))
        return m

    out["step"] = one
    for s in range(n):
        t0 = time.perf_counter()
        out["hist"].append(one(s)["loss"].item())
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def dist_code_steps(got, want, rows=1 << 13):
    """Entries of two dequantized int8 moments further apart than one
    code step of the larger, a chunk of rows at a time; entries under
    2^-24 of their row's absmax (about where the codes hold 0) held to
    that -> (how many, of how many)."""
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    outside = 0
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows], b[i:i + rows]
        big = torch.maximum(x.abs(), y.abs())
        floor = big.amax(-1, keepdim=True) * 2.0 ** -24
        outside += int(((x - y).abs() > CODE_STEP * big + floor).sum())
    return outside, a.numel()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import (_build, ddmm, flash_attention,
                                     flash_attention_bwd, knn, sddmm,
                                     shift_conv2d, spdmm_rows)
    from repro_torch.kernels.flash_attention import MAX_D_BWD, takes
    from repro_torch.kernels.knn import WARP_MAX_K
    from repro_torch.kernels.sddmm import BLOCK
    from repro_torch.models.transformer import init_lm
    # "spdmm" counts the entry the path calls, spdmm_rows
    kernels = {"shift_conv2d": shift_conv2d, "spdmm": spdmm_rows,
               "ddmm": ddmm, "knn": knn, "sddmm": sddmm,
               "flash_attention": flash_attention,
               "flash_attention_bwd": flash_attention_bwd}

    # ---- phase 1: card, numerics, build ---------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib_path = _build.build()
    lib = _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{lib_path.relative_to(ROOT)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    assert lib.repro_knn_warp_k() == WARP_MAX_K, \
        "csrc/knn.cu and knn.py disagree"
    assert lib.repro_sddmm_block() == BLOCK, \
        "csrc/sddmm.cu and sddmm.py disagree"
    assert all(bool(lib.repro_flash_takes(d, dv)) == takes(d, dv)
               for d in range(0, 264, 8) for dv in range(0, 264, 8)), \
        "csrc/flash_attention.cu and flash_attention.py disagree"
    assert all(bool(lib.repro_flash_bwd_takes(d, dv))
               == takes(d, dv, MAX_D_BWD)
               for d in range(0, 264, 8) for dv in range(0, 264, 8)), \
        "csrc/flash_attention_bwd.cu and flash_attention.py disagree"
    if "--conv-sweep" in sys.argv[1:]:
        conv_sweep(card)
        return finish()
    if "--ddmm-sweep" in sys.argv[1:]:
        ddmm_sweep(card)
        return finish()
    if "--bwd" in sys.argv[1:]:
        train_phase(kernels, card, path=False)
        return finish()
    if "--rec" in sys.argv[1:]:
        rows = rec_phase(kernels, card, timed=True)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
        return finish()
    if "--moe" in sys.argv[1:]:
        rows = moe_phase(kernels, card, timed=True)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
        return finish()
    if "--dense" in sys.argv[1:]:
        rows = dense_phase(kernels, card, timed=True)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
        return finish()
    if "--train" in sys.argv[1:]:
        rows = train_phase(kernels, card)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
        return finish()
    if "--grok-schedule" in sys.argv[1:]:
        grok_schedule_phase(card)
        stamp("grok-1 schedules")
        return finish()
    if "--dryrun" in sys.argv[1:]:
        dryrun_phase(card)
        stamp("dry run phase")
        return finish()
    if "--mesh" in sys.argv[1:]:
        distributed_phase(card)
        stamp("distributed phase")
        dist_flash_shapes(card)
        stamp("flash at the mesh's per-rank shapes")
        return finish()
    dist_arg = [a for a in sys.argv[1:] if a.startswith("--distributed")]
    if dist_arg:
        sections = dist_arg[0].partition("=")[2] or "abc,d,e,f,g,x"
        distributed_full_phase(card, sections)
        stamp("distributed phase (four cards)")
        log(f"card: {card}")
        return finish()
    if "--train-families" in sys.argv[1:]:
        rows = train_families_phase(kernels, card, True, [
            a for a in sys.argv[1:] if a in FAMILY_TRAIN] or FAMILY_TRAIN)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
        return finish()

    tasks = list(PER_REQUEST)
    if "--sharded" in sys.argv[1:]:
        reqs = {task: task_requests(task, *task_plans(task))
                for task in SHARDED_TASKS}
        sharded_phase(kernels, reqs, card)
        stamp("sharded phase")
        return finish()
    plans = {task: task_plans(task) for task in tasks}
    autotune_cache = ROOT / "build" / "autotune_smoke.json"
    autotune_cache.unlink(missing_ok=True)
    if "--lattice" in sys.argv[1:] or "--serve" in sys.argv[1:]:
        reqs = {task: task_requests(task, *plans[task]) for task in tasks}
        if "--lattice" in sys.argv[1:]:
            for task in tasks:
                lattice_phase(task, task_graph(task), reqs[task],
                              autotune_cache, card)
            heldout_phase(card)
        if "--serve" in sys.argv[1:]:
            serving_phase(kernels, reqs, card)
            for task in tasks:
                request_times(task, *plans[task], reqs[task], card)
        return finish()
    if "--gnn" in sys.argv[1:]:
        reqs = {task: task_requests(task, *plans[task]) for task in tasks}
        rows = gnn_phase(kernels, reqs, card, timed=True)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
        return finish()
    if "--frontend" in sys.argv[1:]:
        reqs = {task: task_requests(task, *plans[task]) for task in tasks}
        rows = []
        for task, (t_launches, t_cases, t_err) in frontend_phase(
                kernels, plans, reqs, card).items():
            rows += kernel_rows(task, t_cases, t_launches,
                                TRACED_PER_REQUEST[task], t_err, card)
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
        return finish()

    # ---- phase 2: every kernel against its plain version ----------------
    rng = np.random.default_rng(0)
    cases = {task: task_cases(task, plans[task][0], rng, dev)
             for task in tasks}
    max_err = {task: {name: 0.0 for name in kernels} for task in tasks}
    for task in tasks:
        for case in cases[task]:
            max_err[task][case.kernel] = max(max_err[task][case.kernel],
                                             check_case(case))
        exact_checks(task, rng, dev)
    lm_cfg = configs.get(LM_ARCH)
    lm_paths = lm_cases(lm_cfg, rng, dev)
    for path, path_cases in lm_paths.items():
        max_err[path] = {"flash_attention": max(
            check_case(case) for case in path_cases)}
    flash_exact_checks(lm_cfg, rng, dev)
    stamp("kernel checks")

    # ---- phase 3: serve each task's requests through the CUDA kernels ---
    requests = {task: task_requests(task, *plans[task]) for task in tasks}
    launches = {task: serve(task, *plans[task], requests[task], kernels)
                for task in tasks}
    stamp("eager serving")
    for task in tasks:
        graph_phase(task, requests[task], kernels, card)
    stamp("graph phase")
    traced = frontend_phase(kernels, plans, requests, card)
    stamp("frontend phase")
    for task in tasks:
        lattice_phase(task, task_graph(task), requests[task], autotune_cache,
                      card)
    heldout_phase(card)
    stamp("lattice phase")
    serving_phase(kernels, requests, card)
    stamp("serving phase")
    sharded_phase(kernels, requests, card)
    stamp("sharded phase")
    launches["lm-serve"] = lm_serve(lm_cfg, kernels)
    lm_params = init_lm(0, lm_cfg, device="cuda")
    eng, lm_reqs = lm_engine_run(lm_cfg, lm_params, kernels, card)
    lm_parity(lm_cfg, lm_params, lm_reqs)
    lm_fp32_parity(lm_cfg, lm_params, [r.prompt for r in lm_reqs])
    launches["lm-prefill-2048"] = lm_long_prefill(lm_cfg, lm_params,
                                                  kernels, card)
    stamp("qwen3 phase")
    train_rows = train_phase(kernels, card, timed=False)
    stamp("training phase")
    dryrun_phase(card)
    stamp("dry run phase")
    gnn_rows = gnn_phase(kernels, requests, card, timed=False)
    stamp("GNN phase")
    rec_rows = rec_phase(kernels, card, timed=False)
    stamp("recurrent phase")
    moe_rows = moe_phase(kernels, card, timed=False)
    stamp("MoE phase")
    family_rows = train_families_phase(kernels, card, timed=False)
    stamp("training families phase")
    dense_rows = dense_phase(kernels, card, timed=False)
    stamp("dense phase")
    distributed_phase(card)
    stamp("distributed phase")

    # ---- phase 4: timing -----------------------------------------------
    # the calls off each path are checked above, and they and qwen3's
    # profiles are timed under --all-times only
    every = "--all-times" in sys.argv[1:]
    rows = []
    if every:
        lm_profiles(lm_cfg, lm_params, eng, card)
        stamp("qwen3 profiles")
    for task in tasks:
        rows += kernel_rows(task, cases[task], launches[task],
                            PER_REQUEST[task], max_err[task], card,
                            timed=every)
    stamp("GNN-CV kernel rows")
    for task, (t_launches, t_cases, t_err) in traced.items():
        rows += kernel_rows(task, t_cases, t_launches,
                            TRACED_PER_REQUEST[task], t_err, card,
                            timed=every)
    stamp("traced kernel rows")
    per_prefill = {"flash_attention": lm_cfg.n_layers}
    rows += kernel_rows(
        "lm-serve", lm_paths["lm-serve"], launches["lm-serve"], per_prefill,
        max_err["lm-serve"], card,
        unit=f"ms per {LM_ARCH} served request: its prefill's "
             f"{lm_cfg.n_layers} launches at its bucket, mean over the "
             f"{LM_REQUESTS} requests", timed=every)
    rows += kernel_rows(
        "lm-prefill-2048", lm_paths["lm-prefill-2048"],
        launches["lm-prefill-2048"], per_prefill, max_err["lm-prefill-2048"],
        card, unit=f"ms per {LONG_PROMPT}-token {LM_ARCH} prefill: sum "
                   f"over its {lm_cfg.n_layers} launches", timed=every)
    stamp("timing phase")
    rows += (rec_rows + moe_rows + dense_rows + train_rows + family_rows
             + gnn_rows)
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    return finish()


def finish() -> int:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
