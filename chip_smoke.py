"""Chip smoke test: the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version at every shape the main paths
give it (fp32 within ``1e-4 * max(1, max|ref|)``, K5 bit for bit, K6 in
bf16 element by element within ``2**-7 * |ref| + 1e-6``, one bf16 step;
K1/K2 must take the tensor-core route, 3xTF32, at every call with M >= 64
and K, N multiples of 4, and K5 its int8 tensor-core route, ``tc_s8``, at
every call with M >= 64 and K, N multiples of 16; K3/K4 through their
NHWC fronts at the geometry the executor gives them, on the float4 route
wherever the channels come in fours, and off the paths through the tiles
fronts, at m = 2 and at a ragged geometry, and as the decomposed 5x5 and
7x7 convolutions call them: K3 per 3x3 piece at its signed offset, K2 per
piece, one K4; and times kernel, plain version and the nearest single
PyTorch call), runs those decomposed convolutions end to end
(``kernels.winograd.winograd_conv2d``) against ``F.conv2d`` within
``1e-4 * max(1, max|ref|)``, and times a kernel wrapper's host cost on its
direct launch route against its ``torch.ops.repro_torch`` op (the route
an exported program takes),
then serves six CNN paths through ``repro_torch.api.Accelerator`` with
``backend="hopper"``, batch 8, ``pm.V5E`` plans:

* VGG16, 224x224, 1000 classes, fp32 (K1-K4);
* the same VGG16 in int8, default calibration (K5);
* ResNet-18 at full width, ``resnet18_specs(128, 1, n_classes=1000)``, fp32
  (K1-K4) and int8 (K5);
* the reference's depthwise chain (conv -> depthwise -> depthwise,
  stride 2 -> pool -> FC, ``tests/test_residual_ops.py``) at 56x56x128,
  fp32 (K1, K2) and int8 (K5): a check input for DEPTHWISE_CONV, also held
  to the same program on the CPU (fp32 within ``1e-3 * max|logit|``, int8
  bit for bit), since both backends share the depthwise op;

then serves the four model paths (VGG16 and ResNet-18, fp32 and int8)
through a ``ServingSession`` over the same accelerators (phase 3b), from
a settled heap (``api.settled_heap``, as a serving process runs):
``acc.serve(max_batch=8, warmup=True)``, a bulk ``run_many`` of 16
requests of 8 images (each bit for bit ``acc(x)`` on the same batch), then
two windows of 4096 single images arriving open-loop, at 80 % of the direct
path's images/s and at 80 % of what the session sustained (the lower of
its bulk rate and the first window's served rate; each held to its row of
``acc(x)``: int8 bit for bit, fp32 within
``1e-3 * max|logit|``; the served rate beside the offered one, and no
latency percentile where the session fell behind; each window read by
``serving.trace.summary`` from the session's spans: device busy share,
device ms per bucket, the window's split, garbage-collection pauses, the
slowest requests' parts), every session ending
with ``errors == 0``, no retry, ``submitted == requests + errors + shed``,
its launch counts the per-request launches times its batches; on
ResNet-18 fp32 a one-shot ``execute`` error in the middle of a ``run_many``
stream (bisected on hopper, every result bit for bit ``acc(x)``), one
cursed request (``isolated == 1``, innocents bit for bit) and three
concurrent ``run_many`` callers (bit for bit ``acc(x)``);
``save_program`` / ``from_program`` of VGG16 int8 and ResNet-18 fp32 (bit
for bit) and VGG16's ``summary()``; and VGG16 fp32 ``segmented=True`` (5
segment Programs, host maxpool, FC tail on K2; launches per request and
logits equal to the single Program's);

then, on each of the six, the strict per-instruction interpreter
(``HybridRuntime(strict=True, backend="hopper")`` on the served program,
params and sidecar: one kernel call per COMP block and per FC), held bit
for bit to an ``opt_level=0`` hopper executor on the same DRAM image, and
to the served path (int8 bit for bit, fp32 within ``1e-3 * max|logit|``),
with one request of each under ``torch.profiler``; and a last path through
``repro_torch.launch.serve.serve`` with ``backend="hopper"``:

* full-width minitron-8b in bf16 (32 layers, d_model 4096, vocab 256000,
  random weights from seed 0), batch 2, a 4096-token prompt, 16 greedy
  tokens: K6 once per layer of the prefill, never in a decode step;
* mamba2-130m in bf16, batch 2, a 4096-token prompt, 16 greedy tokens: no
  kernel (the SSD is einsum and scans, as the reference's);
* zamba2-7b in bf16, all 81 layers (~14 GB), batch 2, a 4096-token
  prompt, 16 greedy tokens: K6 once per application of the shared
  attention block (13 a prefill, head_dim 112), never in a decode step;
* whisper-base in bf16, batch 8, 1500 frames (30 s of audio) encoded
  outside the timed prefill, a 32-token prompt, 16 greedy tokens: no
  kernel (every attention is under 2048 queries);
* llama-3.2-vision-11b in bf16, all 40 layers (~21 GB), batch 2, a
  4096-token prompt, the config's 1600 image tokens, 16 greedy tokens,
  the cross layers' ``xattn_gate`` set to 0.5 (its zero init would keep
  them from the logits): K6 once per layer and once per cross layer
  (non-causal, Skv 1600) of the prefill, 48, never in a decode step;
* llama4-scout-17b-16e in bf16 at full width (16 experts and a shared
  expert on every layer) cut to 8 of its 48 layers (39.4 GB), and
  llama4-maverick-400b-a17b cut to its first group (a dense layer and an
  MoE layer of all 128 experts, about 37 GB), each batch 2, a 4096-token
  prompt, 16 greedy tokens, through ``train.steps``' serve steps
  (``serve_cut``: ``launch.serve.serve`` builds its config from the arch
  name): K6 once per layer of the prefill (40 heads over 8 KV heads), 8
  and 2, never in a decode step; each MoE layer's tokens per expert and
  dropped tokens of the prefill, and the tokens routed to another expert
  under ``backend="torch"``; where hopper vs torch misses ``LM_TOL`` and
  tokens flipped, both are held in fp32 on the first 2 layers;

and then the five families besides the dense one reduced and in fp32,
each served on the card and on the CPU from one tree (prefill logits
within ``1e-4 * max(1, max|logit|)``).

On the card every executor entry runs as CUDA graphs: a path's first
request is the entry's warm-up run and the capture of its graph, and each
path's direct entry is held ``torch.equal`` to its uncaptured lowering
(``entry.fn``), both timed, with the capture's host time and
``torch.cuda.memory_reserved()`` after it; the session buckets run on
graphs captured at their warmup; the persistence check shows a reloaded
program sharing the direct entry and other weights capturing a graph of
their own. An AOT phase saves VGG16 int8 and ResNet-18 fp32 with
``save_program(aot=True)``, reloads each into a fresh ``ProgramCache``
(the plain program's build and first request against the bundle's load
and first request, bit-equal; a session over it with ``compile_ms == 0``)
and reloads once under a stale fingerprint (a warning, a fresh build,
bit-equal).

Then (phase 3c) F3's rotation: five ResNet-18 fp32 accelerators of one
program with distinct weights called in turn for three rounds on one
stream capture once each (5 graphs), every answer ``torch.equal`` to
``entry.fn``, timed against one tenant alone, with ``memory_reserved``
per further graph; the mesh on the one card: ``make_fleet_mesh()`` and
``make_host_mesh()`` alias the unsharded entry and ``mesh="host"`` serves
bit for bit as ``mesh=None``; each of the four model paths through a
session over a two-replica mesh ``(cuda:0, cuda:0)``, ``buckets=(4, 8)``,
``run_many`` of 16 x 8 + 3 images against the unsharded session (int8 bit
for bit, fp32 within ``1e-3 * max|logit|``; both positions counted, twice
a shard's launches per batch, bulk ms/batch of both), a straggler bucket
on position 0, a ``Fleet`` of VGG16 int8 and ResNet-18 fp32 over the mesh
bit for bit their standalone sessions, and ``python -m
repro_torch.launch.serve --arch resnet18 --no-reduced --session --mesh
host`` to its end. Phase 3d saves VGG16 fp32's params from the card
(``checkpoint.save``, blocking and async, ms and bytes), restores them
onto ``cuda:0`` and ``cpu`` bit for bit (a rebuilt accelerator's captured
logits ``torch.equal`` to the original's), runs ``run_with_recovery`` over
10 steps summing ResNet-18 hopper logits with one failure at step 7 (one
restart, the final state ``torch.equal`` to a run without failure) and
``elastic_restore``s onto placements over the mesh's devices.

Phase 6 trains through ``repro_torch.launch.train`` (no hand-written
kernel lies on the training path, so the launch counts must not move):
(a) reduced minitron-8b in fp32 at the reference CLI's defaults (20 steps,
batch 8, seq 64, a checkpoint every 10), losses finite and falling, then
10 steps and a second run resumed from the step-10 checkpoint, held to the
uninterrupted run's losses within ``1e-4`` relative (the largest gap
printed), and three steps on the card held to the same steps on the CPU
from the same parameters within ``1e-4``; (b) the reduced config in bf16,
two steps, its params and AdamW state saved blocking and async and
restored onto ``cuda:0``, every leaf ``torch.equal`` (ms and bytes); (c)
minitron-8b at full width cut to 4 of its 32 layers (d_model 4096, 32
heads over 8 KV heads, d_ff 16384, vocab 256000, bf16, remat), batch 2 x
4096 from ``batch_for_step``, six steps through the eager ``.fn`` of
``launch.train.build``'s step: ms/step (median of steps 2-6), tokens/s,
peak allocated and reserved memory, loss (near ln(256000) at step 0) and
grad norm, both finite, and one more step under ``torch.profiler``:
device busy share, the ten longest kernels, the GEMM kernels' time, and
the scan attention, the loss and the AdamW update timed by CUDA events;
then the same seed and batches through the step itself, captured
(``train.steps.TrainStep``: the first call warms up and captures, every
later one replays): ms/step (median of the replays), the capture's host
ms, peak allocated and reserved, one profiled replay (busy share, device
ms, longest kernels), one capture, AdamW's ``step`` equal to the calls,
and every step's loss and grad norm within ``1e-3`` relative of the eager
run's (the gap printed); (d) reduced llama4-scout, mamba2-130m,
zamba2-7b, whisper-base and llama-3.2-vision-11b in fp32, each built on
the card by ``launch.train.build``, three captured steps on the card held
to the same steps on the CPU from the same parameters within ``1e-4``,
and to three steps of the eager ``.fn`` from copies of the same
parameters and state: ``torch.equal`` where two eager runs are
bit-identical, else ``adamw.step_gaps`` within 7d's limits (one capture,
AdamW's ``step`` 3); (e) llama4-scout at full width cut to 1 of its 48
layers and all 24 layers of mamba2-130m, bf16, batch 2 x 4096, four steps
each, measured and held as (c). Every other training step on the card
runs captured, in phase 7 too, but 7a's counted step, which runs ``.fn``
(a replay dispatches no op) before the timed steps replay.

Each CNN path answers one first request and several steady ones, with the
launch counts set to 0 just before it and checked per request just after,
and its logits held against the ``backend="torch"`` (aten) path on the same
card: fp32 within ``1e-3 * max|logit|``, int8 bit for bit with the same
params and sidecar. The LM path's launches are counted the same way around
its one served request (and per phase in a second prefill and one decode
step), and its last-token prefill logits are held against
``backend="torch"`` (the scan-flash attention, which rounds P to bf16)
within ``5e-2 * max|logit|``; so are the other LM paths', where mamba2's
and whisper's (no kernel on the path) must be equal, and zamba2's, whose
bf16 logits drift from fp32 on either backend by more than that, are held
in fp32 on the same tree (and the bf16 hopper logits no farther from the
fp32 ones than the bf16 torch logits), as are the MoE paths' where they
miss it and tokens routed to other experts. Any failure raises and exits
non-zero;
without a CUDA card, or without the repository beside it, the script exits
non-zero before printing any result.

Phase 7 (``repro_torch.launch.roofline``, ``dryrun`` and the mesh step of
``launch.train``): (a) the roofline of measured runs, each counted in a run
apart from the timed ones: full-width minitron-8b bf16 prefills on
``hopper``, 2 x 4096 over a cache of 4112 (K6 32 a prefill, its declared
work equal to phase 2's formula at that shape), and the full-width
training step cut to 4 of 32 layers, 2 x 4096 (as phase 6c): measured ms,
the compute and memory terms, the bound, the counted FLOPs and the
model-FLOPs share (``mfu``, which must lie in (0, 1]); (b) the dry-run
cell whisper-base x decode_32k x single through ``dryrun.run_cell``, in a
process of its own with no card visible, started at the phase's start:
status ``OK``, traced split over the 16 ``model`` positions of one data
row (its ``trace_s``), the fullest position's figures per chip, memory
per device and roofline; (c) reduced minitron-8b in
fp32 over a 2-position data mesh of the repeated card against the
one-position step (loss and ``grad_norm`` within ``1e-5 * max(1, |ref|)``,
parameters within ``1e-4 * max(1, max|ref|)``, as AdamW's first steps
scale a rounding difference in a near-zero gradient element up to a share
of ``lr``), and the full-width 4-layer step with its batch split two ways:
ms/step and peak GB beside the unsplit step's. A mesh that repeats one
card shows the split, the reduction and the bookkeeping, not scaling.
(d) Tensor parallelism along ``model`` (``train.steps.place``):
reduced minitron-8b in fp32 over (1, 2) and (2, 2) meshes of the repeated
card, a prefill and 4 greedy decode steps within ``1e-5 * max(1,
max|ref|)`` of the unsplit card run and one training step within 7c's
limits; full-width minitron-8b bf16 on ``hopper``, 2 x 4096, 32 layers, 16
greedy tokens, split over (1, 2) (K6 on each position's 16 heads over 4
KV heads: 64 a prefill), its prefill ms, decode ms/token and peak GB
beside the unsplit run, logits within ``5e-2 * max|logit|`` of the
unsplit prefill, then once through ``launch.serve.serve`` over that mesh;
and phase 6c's 4-layer step split over (1, 2): ms/step and peak GB. The
MoE and VLM families split the same way: reduced scout, maverick
and the VLM in fp32 over (1, 2) and (2, 2) as minitron above, their
prefill routing equal token for token to the unsplit run's; and phase
5's scout (cut to 4 of 48 layers: its tree and the placed copy fit the
card together) and VLM (all 40 layers, 1600 image tokens) paths, bf16 on
``hopper``, 2 x 4096, 16 greedy tokens, split over (1, 2) against the same
tree unsplit (K6 8 and 80 + 16 a prefill; prefill ms, decode ms/token,
peak GB, logits within ``5e-2 * max|logit|``; for scout the tokens per
expert and drops per MoE layer split beside unsplit, the tokens routed
apart, and the first MoE layer on the unsplit run's own input: each
position's assembled router equal bit for bit, the summed output within
``5e-2 * max|out|``). The SSM, hybrid and audio families split too:
reduced mamba2, zamba2 (5 layers: two groups and a tail) and whisper in
fp32 over (1, 2) and (2, 2) as minitron above (every arch's step held
by ``adamw.step_gaps``: each gradient leaf within ``1e-4`` of its own
max|g|, the parameters within ``1e-4`` where the gradient is well above
AdamW's eps, nothing unmoved); and phase 5's zamba2 (81
layers; K6 26 a prefill against 13, on each position's 16 of 32 heads),
mamba2-130m and whisper-base (8 x 1500 frames, encoded over each tree)
paths, bf16 on ``hopper``, split over (1, 2) against the same tree
unsplit (prefill ms, decode ms/token, peak GB; whisper's logits within
``5e-2 * max|logit|``; zamba2's and mamba2's bf16 gap reported, and the
split held in fp32 within ``1e-4 * max|logit|`` on zamba2's first 15
layers and all of mamba2's, its bf16 logits no farther from those fp32
ones than the unsplit bf16 logits plus ``5e-2 * max|logit|``), each
then once through ``launch.serve.serve`` over that mesh. Shares that are
uneven or empty split over the production mesh's 16 ``model``
positions of the repeated card: phase 5's whisper-base path (every even
position holds no head: no attention runs there) and scout cut to 2 of
48 layers (2 or 3 of its 40 heads a position, over one KV head; K6 32 a
prefill against 2), each as above against the same tree unsplit
(prefill ms, decode ms/token, peak GB, logits within ``5e-2 *
max|logit|``; whisper also through ``launch.serve.serve``; scout's
routing and first MoE layer as above), and reduced scout and whisper in
fp32 over (1, 16) as the reduced archs above. Query heads that straddle
KV groups: internlm2-20b cut to 2 of 48 layers, 48 heads over 8 KV heads
split over (1, 6) of the repeated card (8 heads a position over two KV
groups, its K and V indexed to one KV head per query head; K6 12 a
prefill against 2), as scout above against the same tree unsplit, and
reduced internlm2-20b with 48 over 8 heads in fp32 over (1, 6) as the
reduced archs above. Every split training step above (7d) computes its
loss over the positions' vocabulary shares of the logits, where they
lie: no position gathers the (B, S, V) logits.

Every LM decode above runs as the port serves it: one CUDA graph a
request (``train.steps.DecodeStep``), captured on the first decode step
and replayed for every token after it. Phase 5 holds each of its seven
paths' captured decode to its eager step (``decode.fn`` with the position
as a 0-d tensor on the card, from a copy of the same prefilled cache):
the 16 greedy tokens equal, the logits ``torch.equal`` at every step, one
capture; it prints the capture's host ms, the replay ms/token beside the
eager ms/token, and one profiled replay and one profiled eager step
(device busy share, kernels), and the route. Phase 7d does the same for
every full-width decode it runs, split (over (1, 2), (1, 6) and (1, 16)
of the repeated card, captured whole on the card's stream) and unsplit.

Phase 2 also runs F6's shape through K1: ``resnet18_specs(16, 8)``'s
``s4b1_proj`` (a 1x1 stride-2 conv from 2x2 to 1x1, batch 2), whose
patches ``im2col`` must hand over contiguous; and K6 at the per-position
shape of 7d's split prefill, and at scout's position shape (20
over 4 heads), the VLM's cross-attention at a position (16 over 4
heads to the 1600 image tokens), zamba2's shared block at a position
(16 over 16 heads, D 112), scout's positions of 16 (2 and 3 heads
over 1 KV head), and internlm2-20b's positions of 6 (8 heads over 8
indexed KV heads, 4096 x 4112, D 128).

Phase 2 also holds every kernel at the shapes of the interpreter's calls
(``*_strict`` paths: per COMP block, the block's rows and k-group); the
summary's times sum the four CNN model paths and the LM paths only, its
launches every counted request of the run.

Output: the card's name and power limit, one JSON line per (kernel, layer)
(for K1-K5 with its ``route``; for K1/K2 its bound at three TF32
products per product, and ``fma_bound_ms``, the bound on the fp32 FMA
pipes),
the timings of each path (for the interpreter, its requests beside the
served and ``opt_level=0`` executors', and the kernels whose device time
differs most between the two under the profiler; for each LM path also a
``torch.profiler`` breakdown of one prefill and one decode step: device
busy time, its split into K6, GEMMs and the rest, and the longest
kernels), phase 6's training lines, phase 7's roofline, dry-run and
mesh lines, a ``{"kernels": [...]}`` summary line, and as the last line ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the H100 SXM peaks (fp32 outside the tensor cores, dense TF32, bf16 and
# int8 on the tensor cores, HBM3 bandwidth) are repro_torch.launch.roofline's
BATCH, N_CLASSES = 8, 1000
STEADY_REQUESTS = 10
KERNEL_REPS = 10
# per-request launches on each main path, from its program (pm.V5E plans,
# batch 8, opt_level 1: one dispatch per layer)
PATHS = {
    # 9 Spatial CONVs (K1: conv0's 3 channels over im2col's patches, the
    # other 8 over the map itself); 4 Winograd GEMMs + 3 FC (K2); 4
    # Winograd CONVs
    "vgg16_fp32": {"conv_gemm_f32": 1, "conv_implicit_f32": 8, "bmm_f32": 7,
                   "wino_input_transform_f32": 4,
                   "wino_output_transform_f32": 4},
    # 13 CONVs + 3 FC, all Spatial under the int8 DSE
    "vgg16_int8": {"qmm_i8": 16},
    # 16 Spatial CONVs (K1: the stem over patches, 15 over the map); 4
    # Winograd GEMMs + 1 FC (K2); 4 Winograd CONVs
    "resnet18_fp32": {"conv_gemm_f32": 1, "conv_implicit_f32": 15,
                      "bmm_f32": 5,
                      "wino_input_transform_f32": 4,
                      "wino_output_transform_f32": 4},
    # 20 CONVs + 1 FC
    "resnet18_int8": {"qmm_i8": 21},
    # the reference's depthwise chain (tests/test_residual_ops.py) at
    # 56x56x128, a check input for DEPTHWISE_CONV: one Spatial CONV and the
    # FC on the PE (K1 over the map), the two depthwise layers in aten
    "dwchain_fp32": {"conv_implicit_f32": 1, "bmm_f32": 1},
    "dwchain_int8": {"qmm_i8": 2},
    # one K6 per layer of the prefill (prompt >= 2048 tokens); a decode
    # step attends one token through the einsum branch
    "minitron8b_bf16": {"flash_attention": 32},
    # the SSD is einsum and scans, not a kernel (nor is it one in the
    # reference)
    "mamba2_130m_bf16": {},
    # one K6 per application of the shared attention block (81 layers in
    # groups of 6: 13 groups and a tail of 3 without it), D 112
    "zamba2_7b_bf16": {"flash_attention": 13},
    # 1500 frames and 32-token prompts stay under the 2048-token branch
    "whisper_base_bf16": {},
    # 40 causal self-attentions and 8 cross-attentions to 1600 image tokens
    "llama32_vision_bf16": {"flash_attention": 48},
    # one K6 per layer of the prefill (40 heads over 8 KV heads, D 128):
    # scout cut to 8 of its 48 layers, maverick to its first group (a
    # dense layer and an MoE layer of 128 experts)
    "llama4_scout_bf16": {"flash_attention": 8},
    "llama4_maverick_bf16": {"flash_attention": 2},
}
LM_PATH = "minitron8b_bf16"
# phase 5: the LM paths at full width through launch.serve.serve (random
# weights from seed 0): arch, batch, prompt tokens, greedy tokens
LM_PATHS = {
    LM_PATH: ("minitron-8b", 2, 4096, 16),
    "mamba2_130m_bf16": ("mamba2-130m", 2, 4096, 16),
    "zamba2_7b_bf16": ("zamba2-7b", 2, 4096, 16),
    # 30 s of audio (the config's 1500 frames)
    "whisper_base_bf16": ("whisper-base", 8, 32, 16),
    "llama32_vision_bf16": ("llama-3.2-vision-11b", 2, 4096, 16),
    "llama4_scout_bf16": ("llama4-scout-17b-16e", 2, 4096, 16),
    "llama4_maverick_bf16": ("llama4-maverick-400b-a17b", 2, 4096, 16),
}
# LM paths cut in depth, every width whole: the layers kept (scout's 48
# layers are 215 GB of bf16 weights; one maverick group is 37 GB). They
# are served through train.steps' serve steps (``serve_cut``), since
# launch.serve.serve builds its config from the arch name
LM_CUT = {"llama4_scout_bf16": 8, "llama4_maverick_bf16": 2}
# the MoE paths: a token whose near-tied router logits differ by one bf16
# step between the backends routes to another expert ("flips") and its
# FFN output changes whole. Where hopper vs torch misses LM_TOL and tokens
# flipped, the two are held in fp32 on the first FLIP_LAYERS layers of the
# same tree (as LM_DRIFT's, with the bf16 logits of that cut)
FLIP_LAYERS = 2
# paths where hopper and torch run the same ops (no kernel on the path):
# their logits must be equal, not close
LM_EXACT = ("mamba2_130m_bf16", "whisper_base_bf16")
# paths whose bf16 logits drift from their fp32 ones, on either backend,
# by more than LM_TOL (zamba2-7b at random weights: a difference of one
# bf16 step in a shared block's output grows through the next group's
# mamba layers; PERF.md §6 and ``python -m
# repro_torch.launch.drift``): hopper vs torch is held in fp32 on the same
# tree, and the bf16 hopper logits no farther from the fp32 ones than the
# bf16 torch logits, plus LM_TOL
LM_DRIFT = ("zamba2_7b_bf16",)
# the VLM's xattn_gate leaves after init: their zero init makes
# tanh(gate) = 0, and the cross-attention would not reach the logits
VISION_GATE = 0.5
# kept out of the summary's times, which sum the model paths
DW_PATHS = ("dwchain_fp32", "dwchain_int8")
# phase 4: the strict interpreter on each CNN path, with its own launch
# counts and kernel shapes (phase 2): one PE call per COMP block and per
# FC, the opt_level=0 executor's calls
STRICT_PATHS = {f"{p}_strict": p for p in PATHS if p not in LM_PATHS}
# phase 3b: the four model paths through a ServingSession (max_batch 8):
# a bulk run of 16 requests of 8 images, then two windows of 4096 single
# images (the session's whole latency window; 3-7 s at these rates)
# arriving at 80 % of the direct path's images/s and at 80 % of what the
# session sustained (the lower of the bulk rate and the first window's
# served rate). A session that keeps up loses only its last request's
# latency from the served rate (under 1 % of a 3 s window); a window
# served below OVERLOAD of its offered rate ended with over 2 % of it
# queued, is overloaded and reports no latency percentile
SESSION_PATHS = ("vgg16_fp32", "vgg16_int8", "resnet18_fp32",
                 "resnet18_int8")
SESSION_BULK, SESSION_ARRIVALS, SESSION_LOAD, OVERLOAD = 16, 4096, 0.8, 0.98
# hopper vs torch last-token prefill logits, relative to max|logit|: K6
# keeps P in fp32 where the scan rounds it to bf16, over 32 layers
LM_TOL = 5e-2
# K6 in bf16 against its plain version, element by element: both compute
# in fp32 and round once to bf16, so they differ by at most one bf16 step
# (2**-7 of |ref|); the absolute term covers outputs near 0
BF16_STEP, BF16_ABS = 2.0 ** -7, 1e-6
SOURCES = {
    "conv_gemm_f32": ("src/repro_torch/csrc/gemm_f32.cu",
                      "src/repro/kernels/spatial_conv/kernel.py:51"),
    "conv_implicit_f32": ("src/repro_torch/csrc/gemm_f32.cu",
                          "src/repro/kernels/spatial_conv/kernel.py:51"),
    "bmm_f32": ("src/repro_torch/csrc/gemm_f32.cu",
                "src/repro/kernels/gemm/kernel.py:68"),
    "wino_input_transform_f32": ("src/repro_torch/csrc/winograd_f32.cu",
                                 "src/repro/kernels/winograd/kernel.py:52"),
    "wino_output_transform_f32": ("src/repro_torch/csrc/winograd_f32.cu",
                                  "src/repro/kernels/winograd/kernel.py:82"),
    "qmm_i8": ("src/repro_torch/csrc/gemm_i8.cu",
               "src/repro/kernels/gemm/int8.py:60"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:63"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its template
    arguments, registers per thread and spilled bytes."""
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        if m := re.search(r"entry function '(\w+)'", line):
            mangled = m.group(1)
            base = re.search(r"(gemm_f32_kernel|gemm_tc_kernel|"
                             r"qmm_splitk_reduce_kernel|splitk_reduce_kernel|"
                             r"wino_input_vec_kernel|wino_input_scalar_kernel|"
                             r"wino_output_vec_kernel|"
                             r"wino_output_scalar_kernel|"
                             r"qmm_i8_kernel|qmm_tc_kernel|"
                             r"transpose_i8_kernel|"
                             r"flash_attention_f32_kernel|"
                             r"flash_attention_bf16_kernel)", mangled)
            args = [a or b for a, b in re.findall(r"Li(\d+)E|Lb(\d)E",
                                                   mangled)]
            if "bfloat16" in mangled:
                args.insert(0, "bf16")
            name = (base.group(1) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spilled")
            name, spill = None, "?"
    return out


def ptxas_warnings(log: str) -> list[str]:
    """``nvcc``'s warnings about the build, such as ptxas serializing the
    wgmma of a kernel (which costs the tensor cores their overlap)."""
    return [line.strip() for line in log.splitlines()
            if "warning" in line.lower() or "performance loss" in line.lower()]


def time_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float, peak_ops: float) -> tuple[float, str]:
    from repro_torch.launch.roofline import HBM_BW
    t_ops, t_bytes = ops / peak_ops, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def pe_calls(program, per_block: bool):
    """The PE dispatches of one request: ``(layer, label, rows, k)`` per
    CONV layer (the fused lowering, ``opt_level=1``) or, with
    ``per_block``, per COMP block (the strict interpreter and the
    ``opt_level=0`` executor: the block's output rows and k-group width);
    ``rows`` and ``k`` are None for an FC layer."""
    from repro_torch.core.isa import Opcode
    calls = []
    if not per_block:
        for cl in program.layers:
            if cl.kind == "conv":
                calls.append((cl, cl.spec.name, cl.spec.out_hw[0],
                              cl.spec.k))
            elif cl.kind == "fc":
                calls.append((cl, cl.spec.name, None, None))
        return calls
    for ins in program.instructions:
        cl = program.layers[ins.layer_id]
        if ins.opcode == Opcode.COMP:
            ih, kg = ins.size & 0xFFF, (ins.size >> 12) & 0xFFF
            (r0, r1), (lo, hi) = cl.row_groups[ih], cl.k_groups[kg]
            calls.append((cl, f"{cl.spec.name}[{ih},{kg}]", r1 - r0,
                          hi - lo))
        elif ins.opcode == Opcode.FC:
            calls.append((cl, cl.spec.name, None, None))
    return calls


def kernel_cases(program, batch: int, dtype: str, per_block: bool = False):
    """Every kernel call a path makes per request, with its shapes:
    ``(kernel, label, shape dict, launches)``, one entry per PE dispatch
    (:func:`pe_calls`)."""
    from repro_torch.core.executor import width_pad
    from repro_torch.core.hybrid_conv import explicit_pads
    from repro_torch.core.winograd import pt_for
    from repro_torch.kernels.common import cdiv
    cases = []
    for cl, label, rows, k in pe_calls(program, per_block):
        s = cl.spec
        if dtype == "int8" and cl.kind == "fc":
            cases.append(("qmm_i8", label, dict(m=batch, k=s.d_in,
                                                n=s.d_out), 1))
        elif dtype == "int8":
            wo = s.out_hw[1]
            cases.append(("qmm_i8", label, dict(
                m=batch * rows * wo, k=s.r * s.s * s.c, n=k), 1))
        elif cl.kind == "fc":
            cases.append(("bmm_f32", label, dict(
                g=1, m=batch, k=s.d_in, n=s.d_out, df="is"), 1))
        elif cl.plan.mode == "spat":
            wo = s.out_hw[1]
            t = batch * rows * wo
            # K1 reads the map itself where takes_implicit holds (these
            # operands are 16-byte aligned): the whole map with its pads
            # (a fused layer) or the block's row slab with its width pads
            if s.c % 4 == 0 and k % 4 == 0 and t >= 64:
                h, pads = ((s.h, explicit_pads(s.padding, s.h, s.w, s.r,
                                               s.s, s.stride))
                           if not per_block else
                           ((rows - 1) * s.stride + s.r,
                            ((0, 0), width_pad(cl))))
                cases.append(("conv_implicit_f32", label, dict(
                    n=batch, h=h, w=s.w, c=s.c, k=k, r=s.r,
                    stride=s.stride, pads=pads, df=cl.plan.dataflow), 1))
            else:
                cases.append(("conv_gemm_f32", label, dict(
                    t=t, crs=s.r * s.s * s.c, k=k, df=cl.plan.dataflow), 1))
        else:
            # K3 reads the executor's slab (the vertical pad materialized,
            # rows + 2) with the width pad as geometry; K4 writes the
            # (N, rows, Wo, k) block
            m = cl.plan.m
            wo = s.out_hw[1]
            t = batch * cdiv(rows, m) * cdiv(wo, m)
            pt2 = pt_for(m) ** 2
            cases.append(("wino_input_transform_f32", label, dict(
                n=batch, h=rows + 2, w=s.w, c=s.c, m=m,
                pad=((0, 0), width_pad(cl))), 1))
            cases.append(("bmm_f32", label, dict(
                g=pt2, m=t, k=s.c, n=k, df=cl.plan.dataflow), 1))
            cases.append(("wino_output_transform_f32", label, dict(
                n=batch, ho=rows, wo=wo, k=k, m=m), 1))
    return cases


def case_launches(cases) -> dict:
    """Launches per request of each kernel in ``cases``."""
    counted = {}
    for name, _, _, n in cases:
        counted[name] = counted.get(name, 0) + n
    return counted


def wino_offpath_cases():
    """K3/K4 off the main paths (launches 0): the reference's tiles-layout
    fronts at ResNet-18's s1 shape (batch 8 at 64x64: 2048 tiles of 64
    channels), the NHWC fronts at m = 2 on the same layer, and a ragged
    geometry (Ho, Wo not multiples of m, C = K = 5, odd pads: the scalar
    route)."""
    s1 = dict(n=BATCH, h=66, w=64, c=64, m=4, pad=((0, 0), (1, 1)))
    ragged = dict(n=2, h=13, w=11, c=5, m=4, pad=((1, 2), (0, 1)))
    return [
        ("wino_input_transform_f32", "s1_tiles",
         dict(layout="tiles", t=2048, c=64, m=4), 0),
        ("wino_output_transform_f32", "s1_tiles",
         dict(layout="tiles", t=2048, k=64, m=4), 0),
        ("wino_input_transform_f32", "s1_m2", dict(s1, m=2), 0),
        ("wino_output_transform_f32", "s1_m2",
         dict(n=BATCH, ho=64, wo=64, k=64, m=2), 0),
        ("wino_input_transform_f32", "ragged", ragged, 0),
        ("wino_output_transform_f32", "ragged",
         dict(n=2, ho=14, wo=10, k=5, m=4), 0),
    ]


def f6_cases():
    """K1 at F6's shape (launches 0): ``resnet18_specs(16, 8)``'s
    ``s4b1_proj``, a 1x1 stride-2 conv from 2x2x32 to 1x1x64 at batch 2,
    its patches from ``im2col`` (one output column: a strided view before
    the repair)."""
    return [("conv_gemm_f32", "s4b1_proj_16_8",
             dict(t=2, crs=32, k=64, df="is", im2col=(2, 2, 2, 32, 2)), 0)]


# the decomposed convolutions of phase 2 (off the served paths: compiled
# layers stay 3x3): ResNet-18's s1 geometry, batch 8 at 32x32 with 64
# channels in and out, F(4, 3), SAME, with 5x5 and 7x7 kernels
DECOMP = dict(n=BATCH, h=32, w=32, c=64, k=64, m=4)


def wino_decomposed_cases():
    """K3/K2/K4 as ``kernels.winograd.winograd_conv2d`` calls them for a 5x5
    and a 7x7 kernel (launches 0): K3 once per 3x3 piece at its signed
    offset (pad minus the piece's offset) over the full conv's tile grid,
    K2 once per piece, K4 once per conv."""
    d = DECOMP
    m, ho = d["m"], d["h"]
    grid = (-(-ho // m), -(-d["w"] // m))
    t = d["n"] * grid[0] * grid[1]
    cases = []
    for r in (5, 7):
        pad = (r - 1) // 2
        for oh in range(0, r, 3):
            for ow in range(0, r, 3):
                cases.append(("wino_input_transform_f32",
                              f"decomp{r}x{r}[{oh},{ow}]", dict(
                                  n=d["n"], h=d["h"], w=d["w"], c=d["c"],
                                  m=m, pad=((pad - oh, 0), (pad - ow, 0)),
                                  grid=grid), 0))
                cases.append(("bmm_f32", f"decomp{r}x{r}[{oh},{ow}]", dict(
                    g=(m + 2) ** 2, m=t, k=d["c"], n=d["k"], df="is"), 0))
        cases.append(("wino_output_transform_f32", f"decomp{r}x{r}", dict(
            n=d["n"], ho=ho, wo=d["w"], k=d["k"], m=m), 0))
    return cases


def decomposed_conv_check(card: str) -> dict:
    """Phase 2: the decomposed 5x5 and 7x7 convolutions end to end
    (``winograd_conv2d`` on the card: K3 and K2 per piece, one K4) against
    the direct convolution (``F.conv2d``, TF32 off) within
    ``1e-4 * max(1, max|ref|)``, with their launches and times."""
    from repro_torch.kernels import common
    from repro_torch.kernels.winograd import winograd_conv2d
    from repro_torch.kernels.winograd.ref import conv2d_ref
    d = DECOMP
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for r in (5, 7):
        x = torch.randn(d["n"], d["h"], d["w"], d["c"], device="cuda",
                        generator=gen)
        w = torch.randn(r, r, d["c"], d["k"], device="cuda",
                        generator=gen) / r
        b = torch.randn(d["k"], device="cuda", generator=gen)
        common.reset_launches()
        y = winograd_conv2d(x, w, b, m=d["m"], relu=True)
        torch.cuda.synchronize()
        counts = {k: v for k, v in common.LAUNCHES.items() if v}
        pieces = (-(-r // 3)) ** 2
        want = {"wino_input_transform_f32": pieces, "bmm_f32": pieces,
                "wino_output_transform_f32": 1}
        if counts != want:
            raise AssertionError(f"decomposed {r}x{r}: launches {counts} "
                                 f"!= {want}")
        y_ref = conv2d_ref(x, w, "SAME", b, relu=True)
        err = float((y - y_ref).abs().max())
        tol = 1e-4 * max(1.0, float(y_ref.abs().max()))
        if not err <= tol:
            raise AssertionError(f"decomposed {r}x{r}: vs F.conv2d max|diff| "
                                 f"{err:.3e} > {tol:.3e}")
        ms = time_ms(lambda: winograd_conv2d(x, w, b, m=d["m"], relu=True))
        conv_ms = time_ms(lambda: conv2d_ref(x, w, "SAME", b, relu=True))
        common.reset_launches()
        out[f"{r}x{r}"] = dict(pieces=pieces, launches=counts,
                               max_abs_diff_vs_conv2d=err, tol=tol, ms=ms,
                               conv2d_ms=conv_ms)
        print(f"decomposed Winograd {r}x{r} ({card}): {pieces} pieces, "
              f"launches {counts}; vs F.conv2d max|diff| {err:.3e} "
              f"(tolerance {tol:.3e}); {ms:.3f}ms against F.conv2d's "
              f"{conv_ms:.3f}ms", flush=True)
    print(json.dumps({"phase": "decomposed_winograd", "card": card,
                      "shape": DECOMP, **out}), flush=True)
    return out


def dispatcher_cost(card: str) -> dict:
    """Host us per call of a kernel wrapper on the direct launch route
    against the same call through its ``torch.ops.repro_torch`` op (the
    route a traced or loaded AOT program takes), K2 and K5 at small
    shapes: 200 calls each, no synchronisation inside, in turns, median of
    five."""
    from repro_torch.kernels.gemm.int8 import qmm_i8
    from repro_torch.kernels.gemm.kernel import bmm_f32
    gen = torch.Generator(device="cuda").manual_seed(4)
    a = torch.randn(1, 64, 64, device="cuda", generator=gen)
    b = torch.randn(1, 64, 64, device="cuda", generator=gen)
    qa = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device="cuda",
                       generator=gen)
    qbias = torch.zeros(64, dtype=torch.int32, device="cuda")
    qmult = torch.full((64,), 1e-3, device="cuda")
    routes = {
        "bmm_f32 wrapper": lambda: bmm_f32(a, b),
        "bmm_f32 op": lambda: torch.ops.repro_torch.bmm_f32(a, b, None,
                                                            False, False),
        "qmm_i8 wrapper": lambda: qmm_i8(qa, qa, qbias, qmult, False),
        "qmm_i8 op": lambda: torch.ops.repro_torch.qmm_i8(qa, qa, qbias,
                                                          qmult, False),
    }
    times = {k: [] for k in routes}
    for _ in range(5):
        for name, fn in routes.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            times[name].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    us = {k: statistics.median(v) for k, v in times.items()}
    extra = {k: us[f"{k} op"] - us[f"{k} wrapper"]
             for k in ("bmm_f32", "qmm_i8")}
    print(f"dispatcher ({card}): host us per call, wrapper -> launch vs "
          f"torch.ops.repro_torch op: "
          + "; ".join(f"{k} {us[k + ' wrapper']:.1f} vs {us[k + ' op']:.1f}"
                      f" (+{extra[k]:.1f})" for k in extra), flush=True)
    print(json.dumps({"phase": "dispatcher", "card": card, "host_us": us,
                      "op_extra_us": extra}), flush=True)
    return us


def lm_config(path: str):
    """The config an LM path serves: its arch's, cut to ``LM_CUT``'s
    layers where the path is cut."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(LM_PATHS[path][0])
    if path in LM_CUT:
        cfg = dataclasses.replace(cfg, n_layers=LM_CUT[path])
    return cfg


def lm_kernel_cases(path: str):
    """K6's calls per request on one LM path. minitron-8b: the prefill's
    shape, once per layer, and four shapes off the path (launches 0): the
    prefill's shape in fp32, a chunk of half the prompt at row offset 2048
    over the same cache (chunked prefill), ragged non-causal fp32, and
    ragged causal bf16 with Sq < Skv. zamba2-7b: the shared block's
    prefill (D 112, zero-padded to 128 in the kernel), once per group. The
    VLM: the causal prefill once per layer and the non-causal
    cross-attention to the image tokens once per cross layer. mamba2 and
    whisper run no kernel. The MoE paths: the prefill's shape (40 heads
    over 8 KV heads), once per layer. Off the paths (launches 0), phase
    7d's split prefills: one model position's heads of TP_POSITIONS, for
    scout (20 over 4), for the VLM's cross-attention (16 over 4 to the
    image tokens; its causal prefill has minitron's position shape) and
    for zamba2's shared block (16 over 16, D 112); scout's positions of
    TP_WIDE (2 and 3 heads over 1 KV head); and internlm2-20b's positions
    of TP_STRADDLE (8 heads over 8 indexed KV heads, at minitron's batch,
    prompt and head dim)."""
    _, batch, prompt, gen = LM_PATHS[path]
    cfg = lm_config(path)
    prefill = dict(b=batch, h=cfg.n_heads, hkv=cfg.n_kv_heads,
                   sq=prompt, skv=prompt + gen, d=cfg.head_dim,
                   dtype="bf16", causal=True)
    position = dict(prefill, h=cfg.n_heads // TP_POSITIONS,
                    hkv=cfg.n_kv_heads // TP_POSITIONS)
    if cfg.family == "moe":
        # over TP_WIDE positions scout's 40 heads give 2 or 3 a position,
        # each over one KV head
        wide = [("flash_attention", f"moe_prefill_{h}_heads_of_{TP_WIDE}",
                 dict(prefill, h=h, hkv=1), 0) for h in (2, 3)]
        return [("flash_attention", "moe_prefill", prefill, cfg.n_layers),
                *([("flash_attention", "moe_prefill_position_of_2",
                    position, 0)] if path in TP_FAMILY_PATHS else []),
                *(wide if path in TP_WIDE_FAMILY_PATHS else [])]
    if path == "zamba2_7b_bf16":
        return [("flash_attention", "shared_prefill", prefill,
                 cfg.n_layers // cfg.shared_attn_every),
                ("flash_attention", "shared_prefill_position_of_2",
                 position, 0)]
    if path == "llama32_vision_bf16":
        return [("flash_attention", "prefill", prefill, cfg.n_layers),
                ("flash_attention", "cross_prefill", dict(
                    prefill, skv=cfg.n_image_tokens, causal=False),
                 cfg.n_layers // cfg.cross_attn_every),
                ("flash_attention", "cross_prefill_position_of_2", dict(
                    position, skv=cfg.n_image_tokens, causal=False), 0)]
    if path != LM_PATH:
        return []
    return [
        ("flash_attention", "prefill", prefill, cfg.n_layers),
        # phase 7d's split prefill: one model position's heads of two
        ("flash_attention", "prefill_position_of_2", position, 0),
        # phase 7d's straddling prefill: a position of internlm2-20b's 48
        # over 8 heads on TP_STRADDLE, its K and V indexed to its 8 heads
        ("flash_attention", f"prefill_straddle_position_of_{TP_STRADDLE}",
         dict(prefill, h=48 // TP_STRADDLE, hkv=48 // TP_STRADDLE), 0),
        ("flash_attention", "prefill_fp32", dict(prefill, dtype="fp32"), 0),
        ("flash_attention", "prefill_chunk", dict(
            prefill, sq=prompt // 2, row_offset=prompt // 2), 0),
        ("flash_attention", "ragged_fp32", dict(
            b=1, h=4, hkv=2, sq=333, skv=517, d=64, dtype="fp32",
            causal=False), 0),
        ("flash_attention", "ragged_bf16", dict(
            b=2, h=8, hkv=2, sq=100, skv=230, d=128, dtype="bf16",
            causal=True), 0),
    ]


def int_mm_padded(a: torch.Tensor, b: torch.Tensor):
    """``torch._int_mm`` on zero-padded copies (cuBLASLt wants M > 16 and
    K, N multiples of 8; zero padding is exact under zero point 0): a
    yardstick for the product alone, without the epilogue."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
    bp = torch.zeros((kp, np_), dtype=torch.int8, device=b.device)
    ap[:m, :k] = a
    bp[:k, :n] = b
    return lambda: torch._int_mm(ap, bp)


def run_case(name: str, shape: dict, gen: torch.Generator) -> dict:
    """Kernel vs plain version on the card at one shape; times all three."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel,
        flash_attention_work,
    )
    from repro_torch.launch.roofline import (
        PEAK_BF16_FLOPS,
        PEAK_FP32_FLOPS,
        PEAK_INT8_OPS,
        PEAK_TF32_FLOPS,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.gemm.int8 import qmm_i8, qmm_ref, qmm_work
    from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref, bmm_work
    from repro_torch.kernels.spatial_conv.kernel import (
        conv_gemm_f32,
        conv_gemm_ref,
        conv_gemm_work,
        conv_implicit_f32,
        conv_implicit_ref,
        conv_implicit_work,
        im2col,
        out_hw,
    )
    from repro_torch.core.winograd import tile_input, transform_matrices
    from repro_torch.kernels.winograd.kernel import (
        signed_offset_tiles,
        wino_input_transform_f32,
        wino_input_transform_nhwc_f32,
        wino_input_transform_nhwc_ref,
        wino_input_transform_ref,
        wino_output_transform_f32,
        wino_output_transform_nhwc_f32,
        wino_output_transform_nhwc_ref,
        wino_output_transform_ref,
        wino_output_work,
        wino_input_work,
    )

    def rnd(*size):
        return torch.randn(*size, generator=gen, device="cuda")

    lib, peak, exact, rel = None, PEAK_FP32_FLOPS, False, 1e-4
    elementwise = False
    extra = {}
    gemm = None      # (M, K, N) of a K1/K2/K5 call
    if name == "flash_attention":
        b, h, hkv, sq, skv, d = (shape[x] for x in
                                 ("b", "h", "hkv", "sq", "skv", "d"))
        causal, off = shape["causal"], shape.get("row_offset", 0)
        dt = torch.bfloat16 if shape["dtype"] == "bf16" else torch.float32
        q = rnd(b, h, sq, d).to(dt)
        k, v = rnd(b, hkv, skv, d).to(dt), rnd(b, hkv, skv, d).to(dt)
        qf, kf, vf = (t.view(-1, t.shape[2], d) for t in (q, k, v))
        kern = lambda: flash_attention_kernel(qf, kf, vf, causal=causal,
                                              row_offset=off)
        plain = lambda: flash_attention_ref(qf, kf, vf, causal=causal,
                                            row_offset=off)
        # the yardstick only: SDPA's is_causal is aligned at the top left
        # too; a row offset takes an explicit mask
        mask = None
        if causal and off:
            mask = (torch.arange(skv, device="cuda")[None, :]
                    <= off + torch.arange(sq, device="cuda")[:, None])
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=h != hkv)
        # the work the wrapper declares to the roofline counter
        ops, nbytes = flash_attention_work(
            b * h, b * hkv, sq, skv, d, causal=causal, kv_len=skv,
            row_offset=off, itemsize=q.element_size())
        if dt == torch.bfloat16:
            peak, elementwise = PEAK_BF16_FLOPS, True
        extra["library_max_abs_diff"] = float(
            (kern().view(b, h, sq, d).float() - lib().float()).abs().max())
    elif name == "qmm_i8":
        m, k, n = shape["m"], shape["k"], shape["n"]
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=gen)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                          generator=gen)
        bias = torch.randint(-20000, 20000, (n,), dtype=torch.int32,
                             device="cuda", generator=gen)
        # multipliers that spread the int32 sums over the int8 range
        mult = (torch.rand(n, generator=gen, device="cuda") + 0.5) / (
            127.0 * k ** 0.5)
        kern = lambda: qmm_i8(a, b, bias, mult, True)
        plain = lambda: qmm_ref(a, b, bias, mult, True)
        lib = int_mm_padded(a, b)            # the product alone
        ops, nbytes = qmm_work(m, k, n)
        peak, exact = PEAK_INT8_OPS, True
        gemm = (m, k, n)
    elif name == "conv_gemm_f32":
        t, crs, k, df = shape["t"], shape["crs"], shape["k"], shape["df"]
        p, w, b = rnd(t, crs), rnd(crs, k), rnd(k)
        if "im2col" in shape:
            # the patches as spatial_conv2d hands them to the kernel
            n, h, w_, c, stride = shape["im2col"]
            p, _ = im2col(rnd(n, h, w_, c), 1, 1, stride, ((0, 0), (0, 0)))
            if p.shape != (t, crs) or not p.is_contiguous():
                raise AssertionError(f"F6: im2col gave {tuple(p.shape)}, "
                                     f"contiguous {p.is_contiguous()}")
        kern = lambda: conv_gemm_f32(p, w, b, True, df)
        plain = lambda: conv_gemm_ref(p, w, b, True, df)
        lib = lambda: torch.addmm(b, p, w)   # bias + GEMM (ReLU not fused)
        ops, nbytes = conv_gemm_work(t, crs, k)
        gemm = (t, crs, k)
    elif name == "conv_implicit_f32":
        n, h, w_, c, k, r, st, pads, df = (
            shape[x] for x in ("n", "h", "w", "c", "k", "r", "stride",
                               "pads", "df"))
        x, g, b = rnd(n, h, w_, c), rnd(r, r, c, k), rnd(k)
        ho, wo = out_hw(h, w_, r, r, st, pads)
        kern = lambda: conv_implicit_f32(x, g, b, stride=st, pads=pads,
                                         relu=True, dataflow=df)
        plain = lambda: conv_implicit_ref(x, g, b, stride=st, pads=pads,
                                          relu=True)
        (pt, pb), (pl, pr) = pads
        xn, gn = x.permute(0, 3, 1, 2), g.permute(3, 2, 0, 1)
        def lib():
            # the yardstick: cuDNN's fp32 conv (no TF32) on the padded map,
            # bias added, no ReLU
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.nn.functional.conv2d(
                    torch.nn.functional.pad(xn, (pl, pr, pt, pb)), gn, b, st)
        # what K1 ran before it read the map: im2col, then the patch GEMM
        patch = lambda: conv_gemm_f32(im2col(x, r, r, st, pads)[0],
                                      g.view(-1, k), b, True, df)
        if not torch.equal(kern(), patch().view(n, ho, wo, k)):
            raise AssertionError(f"conv_implicit_f32 {shape}: not equal to "
                                 f"conv_gemm_f32 over im2col's patches")
        extra["patch_max_abs_diff"] = 0.0
        extra["patch_route_ms"] = time_ms(patch)
        # the patch GEMM alone, over patches built beforehand
        patches = im2col(x, r, r, st, pads)[0]
        extra["patch_gemm_ms"] = time_ms(
            lambda: conv_gemm_f32(patches, g.view(-1, k), b, True, df))
        del patches
        ops, nbytes = conv_implicit_work(n, h, w_, c, k, r, r, ho, wo)
        gemm = (n * ho * wo, r * r * c, k)
    elif name == "bmm_f32":
        g, m, k, n, df = (shape[x] for x in ("g", "m", "k", "n", "df"))
        a, bm = rnd(g, m, k), rnd(g, k, n)
        kern = lambda: bmm_f32(a, bm, None, False, df)
        plain = lambda: bmm_ref(a, bm, None, False, df)
        lib = lambda: torch.bmm(a, bm)
        ops, nbytes = bmm_work(g, m, k, n)
        gemm = (m, k, n)
    elif name == "wino_input_transform_f32":
        c, m = shape["c"], shape["m"]
        pt = m + 2
        bt = torch.from_numpy(transform_matrices(m)[0]).cuda()
        if shape.get("layout") == "tiles":
            t = shape["t"]
            tiles = rnd(t, pt, pt, c)
            kern = lambda: wino_input_transform_f32(tiles, m)
            plain = lambda: wino_input_transform_ref(tiles, m)
            in_floats = t * pt * pt * c
        else:
            # x read once, V written once
            n, h, w, pad = shape["n"], shape["h"], shape["w"], shape["pad"]
            grid = shape.get("grid")
            x = rnd(n, h, w, c)
            kern = lambda: wino_input_transform_nhwc_f32(x, m, pad, grid)
            plain = lambda: wino_input_transform_nhwc_ref(x, m, pad, grid)
            (top, bottom), (left, right) = pad
            if grid is None:
                tiles, (nh, nw) = tile_input(torch.nn.functional.pad(
                    x, (0, 0, left, right, top, bottom)), m)
            else:
                # a decomposition piece's shifted windows (signed offset)
                nh, nw = grid
                tiles = signed_offset_tiles(x, m, top, left, grid)
            t, in_floats = n * nh * nw, n * h * w * c
        # the yardstick, one fp32 call: V (PT^2, T, C) from tiles already
        # gathered (the gather not counted)
        kron = torch.kron(bt, bt)
        tiles_flat = tiles.reshape(t, pt * pt, c)
        lib = lambda: torch.einsum("ij,tjc->itc", kron, tiles_flat)
        ops, nbytes = wino_input_work(t, c, m, in_floats)
        channels = c
    else:
        k, m = shape["k"], shape["m"]
        pt = m + 2
        at = torch.from_numpy(transform_matrices(m)[2]).cuda()
        if shape.get("layout") == "tiles":
            t = shape["t"]
            mm, b = rnd(pt * pt, t, k), rnd(k)
            kern = lambda: wino_output_transform_f32(mm, b, m, True)
            plain = lambda: wino_output_transform_ref(mm, b, m, True)
            out_floats = t * m * m * k
        else:
            # M and bias read once, the cropped Y written once
            out = (shape["n"], shape["ho"], shape["wo"])
            t = out[0] * common.cdiv(out[1], m) * common.cdiv(out[2], m)
            mm, b = rnd(pt * pt, t, k), rnd(k)
            kern = lambda: wino_output_transform_nhwc_f32(mm, b, m, out, True)
            plain = lambda: wino_output_transform_nhwc_ref(mm, b, m, out,
                                                           True)
            out_floats = out[0] * out[1] * out[2] * k
        # the yardstick, one fp32 call: (T, m^2, K), no bias, no ReLU
        kron = torch.kron(at, at)
        lib = lambda: torch.einsum("ij,jtk->tik", kron, mm)
        ops, nbytes = wino_output_work(t, k, m, out_floats)
        channels = k
    y, y_ref = kern(), plain()
    torch.cuda.synchronize()
    if name.startswith("wino_"):
        # float4 accesses wherever the channels come in fours (these
        # operands are 16-byte aligned), the scalar body else
        route = common.last_route(name)
        if route != ("vec4" if channels % 4 == 0 else "scalar"):
            raise AssertionError(f"{name} {shape}: route {route}")
        extra["route"] = route
    if gemm is not None:
        # the tensor cores take every call with M >= 64 and K, N multiples
        # of 4 (K1/K2) or of 16 (K5) (these operands are 16-byte aligned);
        # the FMA or dp4a body the rest
        m_, k_, n_ = gemm
        mult_of, tc_route = (16, "tc_s8") if exact else (4, "tc3xtf32")
        expected_tc = m_ >= 64 and k_ % mult_of == 0 and n_ % mult_of == 0
        route = common.last_route(name)
        if (route == tc_route) != expected_tc:
            raise AssertionError(f"{name} {shape}: route {route}")
        extra["route"] = route
    if exact:
        err = float((y.int() - y_ref.int()).abs().max())
        tol = 0.0
    elif elementwise:
        diff = (y.float() - y_ref.float()).abs()
        lim = BF16_STEP * y_ref.float().abs() + BF16_ABS
        # the worst element's share of its own limit; must not exceed 1
        ratio = float((diff / lim).max())
        err, tol = float(diff.max()), None
        extra["worst_elem_ratio"] = ratio
        if not ratio <= 1.0:
            raise AssertionError(
                f"{name} {shape}: an element differs by {ratio:.3f} x "
                f"(2**-7 |ref| + {BF16_ABS:g}); max|diff| {err:.3e}")
        del diff, lim
    else:
        err = float((y.float() - y_ref.float()).abs().max())
        tol = rel * max(1.0, float(y_ref.float().abs().max()))
    if tol is not None and not err <= tol:
        raise AssertionError(f"{name} {shape}: max|diff| {err:.3e} > {tol:.3e}")
    del y, y_ref
    if gemm is not None and not exact:
        # an fp32-accurate product on the tensor cores takes three TF32
        # products (3xTF32); the bound on the fp32 FMA pipes beside it
        bound_ms, bound_by = bound(3.0 * ops, nbytes, PEAK_TF32_FLOPS)
        extra["fma_bound_ms"] = bound(ops, nbytes, PEAK_FP32_FLOPS)[0]
    else:
        bound_ms, bound_by = bound(ops, nbytes, peak)
    ms = time_ms(kern)
    # useful work per second, and the share of the bound the kernel reaches
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=time_ms(plain),
                library_ms=None if lib is None else time_ms(lib),
                bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes,
                useful_tflops=ops / ms * 1e-9, bound_share=bound_ms / ms,
                **extra)


def dw_chain_specs() -> list:
    """The reference's depthwise chain (conv -> depthwise -> depthwise,
    stride 2 -> FC, ``tests/test_residual_ops.py``) at a card's width, with
    a pool so the FC input fits the ISA's 16-bit FC dims."""
    from repro_torch.core.hybrid_conv import (
        ConvSpec,
        DepthwiseSpec,
        FCSpec,
        PoolSpec,
    )
    return [ConvSpec("c1", 56, 56, 64, 128, relu=True),
            DepthwiseSpec("d1", 56, 56, 128, relu=True),
            DepthwiseSpec("d2", 56, 56, 128, stride=2),
            PoolSpec("p1", 28, 28, 128),
            FCSpec("f1", 14 * 14 * 128, N_CLASSES)]


def path_specs(path: str):
    """A CNN path's layer specs and its input's (H, W, C)."""
    from repro_torch.models import resnet, vgg
    if path in DW_PATHS:
        return dw_chain_specs(), (56, 56, 64)
    if path.startswith("vgg16"):
        return vgg.network_specs(224, 1, n_classes=N_CLASSES), (224, 224, 3)
    return resnet.resnet18_specs(128, 1, n_classes=N_CLASSES), (128, 128, 3)


def serve_path(path: str, x: torch.Tensor, params=None) -> dict:
    """Build ``path``'s accelerator on the hopper PE, answer one first and
    ``STEADY_REQUESTS`` steady requests with the launch counts reset just
    before, check them per request, and hold the logits against the torch
    backend. Returns the accelerator, its outputs and timings."""
    from repro_torch import api
    from repro_torch.core import perf_model as pm
    from repro_torch.core.runtime import HybridRuntime
    from repro_torch.kernels import common

    specs, _ = path_specs(path)
    dtype = "int8" if path.endswith("int8") else "float32"
    t0 = time.perf_counter()
    acc = api.Accelerator.build(specs, pm.V5E, batch=BATCH, backend="hopper",
                                dtype=dtype, params=params, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_requests = 1 + STEADY_REQUESTS

    reserved_before_mb = torch.cuda.memory_reserved() / 2 ** 20
    common.reset_launches()
    t0 = time.perf_counter()
    y = acc(x)            # the warm-up run, then the capture of its graph
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    first_counts = {k: v for k, v in common.LAUNCHES.items() if v}
    reserved_mb = torch.cuda.memory_reserved() / 2 ** 20
    t0 = time.perf_counter()
    for _ in range(STEADY_REQUESTS):
        y = acc(x)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t0) / STEADY_REQUESTS
    launches = dict(common.LAUNCHES)

    expected = PATHS[path]
    if first_counts != expected:
        raise AssertionError(f"{path}: launches per request {first_counts} "
                             f"!= {expected}")
    for name in common.KERNELS:
        if launches[name] != expected.get(name, 0) * n_requests:
            raise AssertionError(f"{path}: {name} launched {launches[name]} "
                                 f"times over {n_requests} requests")
    y_np = y.cpu().numpy()
    if y_np.shape != (BATCH, N_CLASSES) or not np.isfinite(y_np).all():
        raise AssertionError(f"{path}: logits shape {y_np.shape} or "
                             f"non-finite values")

    # the torch backend on the same card, same params (and sidecar)
    if dtype == "int8":
        rt = HybridRuntime(acc.program, backend="torch", device="cuda",
                           quant=acc.quant)
        rt.load_params(acc.params)
        q = acc.quant.quantize_input(x)
        y_i8 = acc.runtime.run(q)
        y_ref_i8 = rt.run(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEADY_REQUESTS):
            y_ref_i8 = rt.run(q)
        torch.cuda.synchronize()
        t_ref = (time.perf_counter() - t0) / STEADY_REQUESTS
        if not torch.equal(y_i8, y_ref_i8):
            n_bad = int((y_i8 != y_ref_i8).sum())
            raise AssertionError(f"{path}: int8 logits differ from "
                                 f"backend='torch' in {n_bad} places")
        err, tol = 0.0, 0.0
    else:
        ref = api.Accelerator.build(specs, pm.V5E, batch=BATCH,
                                    backend="torch", params=acc.params,
                                    device="cuda")
        y_ref = ref(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEADY_REQUESTS):
            y_ref = ref(x)
        torch.cuda.synchronize()
        t_ref = (time.perf_counter() - t0) / STEADY_REQUESTS
        ref_np = y_ref.cpu().numpy()
        err = float(np.abs(y_np - ref_np).max())
        tol = 1e-3 * float(np.abs(ref_np).max())
        if not err <= tol:
            raise AssertionError(f"{path}: hopper vs torch logits max|diff| "
                                 f"{err:.3e} > {tol:.3e}")
        del ref
    if any(cl.kind == "dw" for cl in acc.program.layers):
        # both backends run the same depthwise op, so the card's is held to
        # the CPU's, which the CPU tests pin to the reference
        cpu = HybridRuntime(acc.program, backend="torch", device="cpu",
                            quant=acc.quant)
        cpu.load_params([(w.cpu(), b.cpu()) for w, b in acc.params])
        inp = acc.quant.quantize_input(x) if dtype == "int8" else x
        y_card, y_cpu = acc.runtime.run(inp).cpu(), cpu.run(inp.cpu())
        err_cpu = float((y_card.float() - y_cpu.float()).abs().max())
        tol_cpu = 0.0 if dtype == "int8" else 1e-3 * float(
            y_cpu.abs().max())
        if not err_cpu <= tol_cpu:
            raise AssertionError(f"{path}: card vs CPU logits max|diff| "
                                 f"{err_cpu:.3e} > {tol_cpu:.3e}")
        print(f"path {path}: vs the same program on the CPU max|diff| "
              f"{err_cpu:.3e} (tolerance {tol_cpu:.3e})", flush=True)
    graph = capture_check(path, acc, x)
    modes = sorted({cl.plan.mode for cl in acc.program.layers
                    if cl.kind == "conv"})
    calib = (f" (calibration {acc.calib_ms:.0f}ms)"
             if acc.calib_ms is not None else "")
    print(f"path {path}: batch {BATCH}, {acc.n_instructions} instructions, "
          f"CONV modes {modes}; build {t_build * 1e3:.0f}ms{calib}; first "
          f"request {t_first * 1e3:.1f}ms; steady {t_steady * 1e3:.2f}"
          f"ms/batch ({BATCH / t_steady:.1f} images/s) over "
          f"{STEADY_REQUESTS} requests; launches per request {first_counts};"
          f" vs backend='torch' ({t_ref * 1e3:.2f}ms/batch): max|diff| "
          f"{err:.3e} (tolerance {tol:.3e}); captured entry "
          f"{graph['captured_ms']:.3f}ms/batch against the uncaptured "
          f"entry.fn's {graph['uncaptured_ms']:.3f} (torch.equal), capture "
          f"{graph['capture_ms']:.1f}ms, memory reserved after it "
          f"{reserved_mb:.0f} MiB ({reserved_before_mb:.0f} before the "
          f"first request)", flush=True)
    print(json.dumps({"path": path, "build_ms": t_build * 1e3,
                      "calib_ms": acc.calib_ms, "first_ms": t_first * 1e3,
                      "steady_ms": t_steady * 1e3,
                      "torch_backend_ms": t_ref * 1e3,
                      "launches_per_request": first_counts,
                      "max_abs_diff_vs_torch": err, "tol": tol,
                      "memory_reserved_mib_after_capture": reserved_mb,
                      "memory_reserved_mib_before": reserved_before_mb,
                      **graph}), flush=True)
    return dict(acc=acc, y=y, launches=launches, steady_ms=t_steady * 1e3)


def capture_check(path: str, acc, x: torch.Tensor) -> dict:
    """The direct entry of ``path``'s accelerator, captured by its first
    request: its replays against its uncaptured lowering (``entry.fn``) on
    the same DRAM image and input, ``torch.equal``, each timed over
    ``STEADY_REQUESTS`` batches (host clock, ending in a synchronise),
    and its capture's host time (its ``executor.capture`` span)."""
    from repro_torch import spans
    entry, params = acc.runtime.executor_entry(BATCH, acc.input_dtype)
    inp = acc.quant.quantize_input(x) if acc.quant is not None else x
    if entry.trace_count != 1:
        raise AssertionError(f"{path}: direct entry captured "
                             f"{entry.trace_count} times, expected 1")
    with torch.no_grad():
        y_graph, y_fn = entry(params, inp), entry.fn(params, inp)
        if not torch.equal(y_graph, y_fn):
            raise AssertionError(
                f"{path}: captured entry differs from entry.fn in "
                f"{int((y_graph != y_fn).sum())} places")
        times = {}
        for name, fn in (("captured_ms", entry), ("uncaptured_ms", entry.fn),
                         ("captured_ms_again", entry)):
            fn(params, inp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEADY_REQUESTS):
                fn(params, inp)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) / STEADY_REQUESTS * 1e3
    cap = [s for s in spans.LOG.between()
           if s.name == spans.CAPTURE and s.id == id(entry)]
    return dict(times, capture_ms=(cap[-1].t1 - cap[-1].t0) * 1e3,
                trace_count=entry.trace_count)


def session_launches_per_batch(acc, x: torch.Tensor, buckets) -> dict:
    """Each bucket's launches per batch, from ``acc(x[:b])`` (the same
    cached executor entry the session runs for bucket ``b``): the expected
    growth of the counts for one session batch in that bucket."""
    from repro_torch.kernels import common
    out = {}
    for b in buckets:
        common.reset_launches()
        acc(x[:b])
        torch.cuda.synchronize()
        out[b] = {k: v for k, v in common.LAUNCHES.items() if v}
    return out


def check_session_launches(label: str, counts: dict, batches: int,
                           per_bucket: dict, per_request: dict) -> None:
    """The counts a session run left must be phase 3's per-request launches
    times the session's batches: every bucket launches the batch-8
    request's kernels (one dispatch per layer)."""
    odd = {b: c for b, c in per_bucket.items() if c != per_request}
    if odd:
        raise AssertionError(f"{label}: buckets launching unlike the batch-8 "
                             f"request {per_request}: {odd}")
    expected = {k: v * batches for k, v in per_request.items()}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts} over {batches} "
                             f"session batches, expected {expected}")


def serve_session_path(path: str, served: dict, x: torch.Tensor,
                       card: str) -> dict:
    """Phase 3b on one CNN model path, over phase 3's accelerator, each
    traffic pattern in a session of its own of ``acc.serve(max_batch=8,
    warmup=True)``: (1) bulk: ``run_many`` of 16 requests of 8 images,
    each result bit for bit ``acc(x)`` on the same batch (same bucket,
    offset 0, the same entry); (2) two arrival windows (``arrival_window``)
    at 80 % of the direct path's images/s and at 80 % of what the session
    sustained (the lower of the bulk rate and the first window's served
    rate). Every run
    has the launch counts set to 0 just before and read just after, and
    each session must end clean (``check_session_ledger``). Also times the
    host staging of one batch (``_stage``: the request checks and, for
    int8, the quantization), the host work the session adds per batch."""
    from repro_torch.kernels import common

    acc, per_request = served["acc"], PATHS[path]
    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)) for _ in range(SESSION_BULK)]
    direct = [acc(b.cuda()).cpu().numpy() for b in batches]
    host = [b.numpy() for b in batches]
    torch.cuda.synchronize()
    direct_ips = BATCH / (served["steady_ms"] / 1e3)

    # (1) bulk
    t0 = time.perf_counter()
    session = acc.serve(max_batch=BATCH, warmup=True)
    warm_s = time.perf_counter() - t0
    try:
        # every bucket entry captured once, at the warmup, and replayed
        traces = {b: e.trace_count for b, e in session._entries.items()}
        if set(traces.values()) != {1} or not all(
                e.donate_input for e in session._entries.values()):
            raise AssertionError(f"{path} session: bucket captures {traces}")
        per_bucket = session_launches_per_batch(acc, x, session.buckets)
        stage_ms = []
        for b in host[:5]:
            t0 = time.perf_counter()
            session._stage(b)
            stage_ms.append((time.perf_counter() - t0) * 1e3)
        common.reset_launches()
        t0 = time.perf_counter()
        outs = session.run_many(host)
        bulk_s = time.perf_counter() - t0
        bulk_launches = {k: v for k, v in common.LAUNCHES.items() if v}
    finally:
        session.close()
    bulk_st = session.stats
    traces_after = {b: e.trace_count for b, e in session._entries.items()}
    if traces_after != traces:
        raise AssertionError(f"{path} session: recaptured {traces_after}")
    check_session_ledger(f"{path} session bulk", bulk_st)
    check_session_launches(f"{path} session bulk", bulk_launches,
                           bulk_st.batches, {BATCH: per_bucket[BATCH]},
                           per_request)
    for i, (got, ref) in enumerate(zip(outs, direct)):
        if not np.array_equal(got, ref):
            raise AssertionError(
                f"{path} session bulk: request {i} differs from acc(x) in "
                f"{int((got != ref).sum())} places, max|diff| "
                f"{float(np.abs(got - ref).max()):.3e}")
    n_images = SESSION_BULK * BATCH
    bulk_ips = n_images / bulk_s
    bulk_ms = bulk_s * 1e3 / bulk_st.batches
    print(f"path {path} session ({card}): warmup of buckets "
          f"{session.buckets} {warm_s * 1e3:.0f}ms (compile_ms "
          f"{bulk_st.compile_ms:.0f}); bulk run_many of {SESSION_BULK} x "
          f"{BATCH} images on captured buckets (one graph each) "
          f"{bulk_s * 1e3:.1f}ms = {bulk_ms:.2f}ms/batch "
          f"({bulk_ips:.1f} images/s) against the direct path's "
          f"{served['steady_ms']:.2f}ms/batch ({direct_ips:.1f} images/s), "
          f"{bulk_st.batches} batches, bit-equal to acc(x); host staging "
          f"{fmt_ms(stage_ms)}ms a batch; launches {bulk_launches}",
          flush=True)

    # (2) open-loop arrivals of single images, drawn from the bulk images
    images, refs = np.concatenate(host), np.concatenate(direct)
    windows = []
    launches = dict.fromkeys(common.KERNELS, 0)
    for k, v in bulk_launches.items():
        launches[k] += v
    for basis in ("direct", "sustained"):
        ips = (direct_ips if basis == "direct" else
               min(bulk_ips, windows[0]["served_images_per_s"]))
        w = arrival_window(f"{path} session arrivals", acc, images, refs,
                           SESSION_LOAD * ips, rng, per_bucket, per_request)
        w["basis"] = f"{SESSION_LOAD:.0%} of {basis}"
        windows.append(w)
        for k, v in w.pop("launches").items():
            launches[k] += v
        lat = ("overloaded: the queue grew, no percentile" if w["overloaded"]
               else f"latency p50 {w['latency_p50_ms']:.2f}ms p95 "
                    f"{w['latency_p95_ms']:.2f}ms, queue wait p50 "
                    f"{w['wait_p50_ms']:.2f}ms p95 {w['wait_p95_ms']:.2f}ms")
        print(f"path {path} session arrivals ({card}): {SESSION_ARRIVALS} "
              f"single images offered at {w['offered_images_per_s']:.1f} "
              f"images/s ({w['basis']}, target {w['rate']:.1f}), served "
              f"{w['served_images_per_s']:.1f} images/s over "
              f"{w['window_s'] * 1e3:.0f}ms: {lat}; {w['batches']} batches, "
              f"{w['padded_rows']} padded rows, occupancy "
              f"{w['occupancy']:.3f}; vs acc(x) rows max|diff| "
              f"{w['max_abs_diff']:.3e} (tolerance {w['tol']:.3e}); ledger "
              f"clean", flush=True)
        print(f"path {path} session trace ({card}): {trace_line(w['trace'])}",
              flush=True)
    print(json.dumps({"path": path, "phase": "session", "card": card,
                      "bulk_ms_per_batch": bulk_ms,
                      "bulk_images_per_s": bulk_ips,
                      "direct_ms_per_batch": served["steady_ms"],
                      "host_staging_ms_per_batch": stage_ms,
                      "compile_ms": bulk_st.compile_ms,
                      "arrivals": windows,
                      "per_bucket_launches": {str(b): c for b, c
                                              in per_bucket.items()}}),
          flush=True)
    return dict(launches=launches)


def arrival_window(label: str, acc, images: np.ndarray, refs: np.ndarray,
                   rate: float, rng, per_bucket: dict,
                   per_request: dict) -> dict:
    """``SESSION_ARRIVALS`` single images, drawn from ``images`` (seeded),
    submitted by this thread at open-loop Poisson ``rate`` into a session
    of its own; each result held to its row of ``refs`` (int8 bit for bit,
    fp32 within ``1e-3 * max|logit|``: another bucket may take another
    route). The served rate is the images over the time from the first
    submit to the last result; below ``OVERLOAD`` of the offered rate the
    window is overloaded, and its percentiles would only measure the
    window's length, so none is reported. The window runs inside
    ``spans.recording()`` and its percentiles and trace are read from the
    session's spans."""
    from repro_torch import spans
    from repro_torch.kernels import common
    from repro_torch.serving import trace
    pick = rng.integers(len(images), size=SESSION_ARRIVALS)
    at = np.cumsum(rng.exponential(1.0 / rate, SESSION_ARRIVALS))
    session = acc.serve(max_batch=BATCH, warmup=True)
    try:
        with spans.recording(), trace.GcPauses() as pauses:
            common.reset_launches()
            futs = []
            t0 = spans.clock()
            for i, t_at in zip(pick, at):
                delay = t0 + t_at - spans.clock()
                if delay > 0:
                    time.sleep(delay)
                futs.append(session.submit(images[i]))
            submit_s = spans.clock() - t0
            got = [f.result(timeout=300) for f in futs]
            # the window ends with its last result, before any host work
            # on the results (stacking 4096 rows took about 1 % of a 0.8 s
            # window)
            t1 = spans.clock()
            window_s = t1 - t0
        rows = np.stack(got)
        counts = {k: v for k, v in common.LAUNCHES.items() if v}
    finally:
        session.close()
    st = session.stats
    check_session_ledger(label, st)
    check_session_launches(label, counts, st.batches, per_bucket,
                           per_request)
    want = refs[pick]
    if acc.quant is not None:
        if not np.array_equal(rows, want):
            raise AssertionError(f"{label}: int8 logits differ from acc(x)'s "
                                 f"rows in {int((rows != want).sum())} places")
        err, tol = 0.0, 0.0
    else:
        err = float(np.abs(rows - want).max())
        tol = 1e-3 * float(np.abs(want).max())
        if not err <= tol:
            raise AssertionError(f"{label}: max|diff| {err:.3e} > {tol:.3e}")
    offered = SESSION_ARRIVALS / submit_s
    served = SESSION_ARRIVALS / window_s
    overloaded = served < OVERLOAD * offered
    return {"rate": rate, "offered_images_per_s": offered,
            "served_images_per_s": served, "window_s": window_s,
            "overloaded": overloaded,
            "latency_p50_ms": None if overloaded else st.p50_ms(t0, t1),
            "latency_p95_ms": None if overloaded else st.p95_ms(t0, t1),
            "wait_p50_ms": None if overloaded else st.wait_p50_ms(t0, t1),
            "wait_p95_ms": None if overloaded else st.wait_p95_ms(t0, t1),
            "batches": st.batches, "padded_rows": st.padded_rows,
            "occupancy": st.occupancy(), "max_abs_diff": err, "tol": tol,
            "launches": counts,
            "trace": trace.summary(st.session, t0, t1, pauses.pauses)}


def trace_line(t: dict) -> str:
    """One window's ``serving.trace.summary`` in a line."""
    busy = t["device_busy_share"]
    parts = ", ".join(f"{k[:-3]} {v:.2f}" for k, v in
                      t["tail_parts_ms"].items())
    return (f"p99 {t['latency_p99_ms']:.2f}ms max "
            f"{t['latency_max_ms']:.2f}ms; device busy "
            f"{'not measured' if busy is None else f'{busy:.3f}'} of the "
            f"window; device ms by bucket {t['device_ms_by_bucket']}; "
            f"split of the window {t['split']}; "
            f"{t['gc_pauses']} gc pauses, {t['gc_ms']:.1f}ms in all, longest "
            f"{t['gc_max_ms']:.1f}ms (of 5ms or more, as (at s, ms, "
            f"generation, collected): {t['gc_long_pauses']}); "
            f"{t['tail_share_in_pause']} of the "
            f"{t['tail_requests']} slowest requests inside a pause of 5ms or "
            f"more; their mean ms: {parts}; tail bursts {t['tail_bursts']}; "
            f"longest gaps between batches {t['top_gaps']}")


def check_session_ledger(label: str, st) -> None:
    """A clean session: every request answered, none degraded, isolated
    or retried, no restart, and ``submitted == requests + errors +
    shed``."""
    if (st.submitted != st.requests + st.errors + st.shed or st.errors
            or st.degraded or st.isolated or st.retries
            or st.watchdog_restarts):
        raise AssertionError(f"{label}: unclean ledger {st}")


def session_faults(served: dict, x: torch.Tensor, card: str) -> None:
    """Phase 3b faults on ResNet-18 fp32, one ``FaultPlan`` each, every
    result held bit for bit: (1) a one-shot ``execute`` error on the fourth
    of eight hopper batches of a ``run_many`` stream of 64 single images is
    bisected on hopper (2 retries, none isolated, nothing degraded), and
    every row equals ``acc(x)``'s; (2) one request-bound ("cursed") fault
    is isolated (``isolated == 1``; the innocent co-batched results equal
    a fault-free run); (3) three threads call ``run_many`` at once, eight
    requests of 8 images each, and every result equals ``acc(x)`` on its
    batch (the staging entries are bound to the pipeline slots)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serving import FaultPlan, FaultSpec, InjectedFault

    acc = served["acc"]
    rng = np.random.default_rng(13)
    batches = [rng.standard_normal(tuple(x.shape)).astype(np.float32)
               for _ in range(8)]
    direct = [acc(torch.from_numpy(b).cuda()).cpu().numpy() for b in batches]
    kw = dict(max_batch=BATCH, buckets=(BATCH,), max_wait_ms=50.0,
              warmup=True)

    plan = FaultPlan([FaultSpec(site="execute", kind="error", at=(3,),
                                match=(("backend", "hopper"),))])
    with acc.serve(fault_plan=plan, **kw) as s:
        rows = np.stack(s.run_many(list(np.concatenate(batches))))
        st = s.stats
    ref = np.concatenate(direct)
    if not (len(plan.fired()) == 1 and st.retries == 2 and st.isolated == 0
            and st.degraded == 0 and st.errors == 0 and st.requests == 64
            and np.array_equal(rows, ref)):
        raise AssertionError(f"session mid-stream failure: {st}; rows differ "
                             f"from acc(x) in {int((rows != ref).sum())} "
                             f"places")
    print(f"session faults ({card}): one execute error on hopper batch 4 of "
          f"8 in a run_many stream -> bisected on hopper ({st.retries} "
          f"retries, isolated {st.isolated}, degraded {st.degraded}); all 64 "
          f"rows bit-equal to acc(x)", flush=True)

    imgs = list(x.cpu().numpy())
    with acc.serve(**kw) as s:
        clean = [f.result(timeout=120) for f in s.submit_many(imgs)]
    cursed = 3
    plan = FaultPlan([FaultSpec(site="execute", kind="error",
                                requests=(cursed,), message="cursed")])
    with acc.serve(fault_plan=plan, **kw) as s:
        futs = s.submit_many(imgs)
        for i, f in enumerate(futs):
            if i == cursed:
                try:
                    f.result(timeout=120)
                except InjectedFault:
                    continue
                raise AssertionError("the cursed request was not isolated")
            if not np.array_equal(f.result(timeout=120), clean[i]):
                raise AssertionError(f"session isolation: innocent request "
                                     f"{i} differs from the fault-free run")
        st = s.stats
    if not (st.isolated == 1 and st.degraded == 0 and st.errors == 1
            and st.submitted == st.requests + st.errors + st.shed):
        raise AssertionError(f"session isolation: {st}")
    print(f"session faults ({card}): one cursed request -> isolated "
          f"{st.isolated} after {st.retries} bisection retries, degraded "
          f"{st.degraded}; {BATCH - 1} innocent co-batched results bit-equal "
          f"to the fault-free run", flush=True)

    orders = [rng.permutation(len(batches)) for _ in range(3)]
    with acc.serve(**kw) as s:
        with ThreadPoolExecutor(len(orders)) as pool:
            futs = [pool.submit(s.run_many, [batches[i] for i in order])
                    for order in orders]
            outs = [f.result(timeout=300) for f in futs]
        st = s.stats
    for order, out in zip(orders, outs):
        for i, got in zip(order, out):
            if not np.array_equal(got, direct[i]):
                raise AssertionError(
                    f"concurrent run_many: a result differs from acc(x) on "
                    f"its batch in {int((got != direct[i]).sum())} places")
    check_session_ledger("concurrent run_many", st)
    print(f"session concurrency ({card}): {len(orders)} threads calling "
          f"run_many at once, {st.batches} batches of {BATCH}, every result "
          f"bit-equal to acc(x) on its batch", flush=True)


def session_persistence(results: dict, xs: dict, card: str) -> None:
    """Phase 3b persistence: ``save_program`` / ``from_program(backend=
    "hopper")`` of VGG16 int8 and ResNet-18 fp32 built on the card; the
    reloaded accelerator's logits equal the original's bit for bit. Then
    ``summary()`` of VGG16."""
    from repro_torch import api
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in ("vgg16_int8", "resnet18_fp32"):
        acc = results[path]["acc"]
        x = xs[path_specs(path)[1]]
        saved = acc.save_program(str(out_dir / f"{path}.json"))
        again = api.Accelerator.from_program(saved, params=acc.params,
                                             backend="hopper",
                                             device="cuda")
        entry = acc.runtime.executor_entry(BATCH, acc.input_dtype)[0]
        traces = entry.trace_count
        y, y2 = acc(x), again(x)
        if not torch.equal(y, y2):
            raise AssertionError(f"{path}: reloaded program differs in "
                                 f"{int((y != y2).sum())} places")
        # the reload shares the direct entry (one schedule, one cache);
        # another set of weights must make it capture a graph of its own,
        # never replay the original's
        if again.runtime.executor_entry(BATCH, acc.input_dtype)[0] \
                is not entry:
            raise AssertionError(f"{path}: the reload took another entry")
        reload_traces = entry.trace_count
        other = api.Accelerator.from_program(
            saved, params=api.random_params(acc.specs, seed=5,
                                            device="cuda"),
            backend="hopper", device="cuda")
        y3 = other(x)
        inp = acc.quant.quantize_input(x) if acc.quant is not None else x
        with torch.no_grad():
            y3_fn = entry.fn(other.runtime.dram_params(), inp)
        if other.quant is not None:
            y3_fn = other.quant.dequantize_output(y3_fn)
        if (entry.trace_count != reload_traces + 1 or not torch.equal(y3, y3_fn)
                or torch.equal(y3, y) or not torch.equal(acc(x), y)):
            raise AssertionError(
                f"{path}: new weights: trace_count {entry.trace_count} "
                f"(was {reload_traces}), equal to entry.fn "
                f"{torch.equal(y3, y3_fn)}, equal to the original's "
                f"{torch.equal(y3, y)}")
        print(f"path {path} persistence ({card}): save_program -> "
              f"from_program(backend='hopper'): {again.n_instructions} "
              f"instructions, logits bit-equal to the original "
              f"({Path(saved).stat().st_size} bytes); the shared direct "
              f"entry's captures: {traces} before the reload, "
              f"{reload_traces} after it (a new graph wherever the reload "
              f"made new weight tensors), {entry.trace_count} after other "
              f"weights (their logits equal entry.fn on them and differ "
              f"from the original's, which still replays bit-equal)",
              flush=True)
    print(results["vgg16_fp32"]["acc"].summary(), flush=True)


class _Records(logging.Handler):
    """Keeps the messages logged to it."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def session_aot(results: dict, xs: dict, card: str) -> None:
    """The AOT phase: VGG16 int8 and ResNet-18 fp32 saved with
    ``save_program(aot=True)`` (buckets 1, 2, 4, 8 and the direct entry)
    and reloaded into a fresh ``ProgramCache``: the build of the plain
    program plus its first request against the bundle's load plus its
    first request, both bit-equal to the served accelerator; a session
    over the loaded accelerator reports ``compile_ms == 0``. Then one
    reload under a stale fingerprint (another torch version) warns,
    builds fresh and answers bit for bit."""
    from repro_torch import api
    from repro_torch.core import aot
    from repro_torch.core.program_cache import ProgramCache
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    records = _Records()
    logging.getLogger("repro_torch.aot").addHandler(records)
    try:
        for path in ("vgg16_int8", "resnet18_fp32"):
            acc = results[path]["acc"]
            x = xs[path_specs(path)[1]]
            y = acc(x)
            plain = acc.save_program(str(out_dir / f"{path}.json"))
            bundle = out_dir / f"{path}.bundle"
            shutil.rmtree(bundle, ignore_errors=True)
            t0 = time.perf_counter()
            acc.save_program(str(bundle), aot=True)
            save_ms = (time.perf_counter() - t0) * 1e3
            size = sum(f.stat().st_size for f in bundle.rglob("*"))
            timed = {}
            for name, src in (("build", plain), ("warm_load", str(bundle))):
                cache = ProgramCache()
                t0 = time.perf_counter()
                again = api.Accelerator.from_program(
                    src, params=acc.params, backend="hopper", device="cuda",
                    cache=cache)
                y2 = again(x)
                torch.cuda.synchronize()
                timed[name] = (time.perf_counter() - t0) * 1e3
                if not torch.equal(y, y2):
                    raise AssertionError(f"{path} aot: {name} differs from "
                                         f"the served logits")
                if cache.stats.aot_loads != (name == "warm_load"):
                    raise AssertionError(f"{path} aot: {name} loaded "
                                         f"{cache.stats.aot_loads}")
            with again.serve(max_batch=BATCH, warmup=True) as s:
                outs = s.run_many([x.cpu().numpy()])
                st = s.stats
            if (st.compile_ms != 0.0 or not st.warm_load_ms > 0
                    or cache.stats.aot_loads != 5
                    or not np.array_equal(outs[0], y.cpu().numpy())):
                raise AssertionError(f"{path} aot session: {st}, "
                                     f"{cache.stats}")
            entry = again.runtime.executor_entry(BATCH, acc.input_dtype)[0]
            print(f"path {path} aot ({card}): save_program(aot=True) "
                  f"{save_ms:.0f}ms, {size} bytes (5 artifacts); plain "
                  f"program build + first request {timed['build']:.0f}ms "
                  f"against the bundle's load + first request "
                  f"{timed['warm_load']:.0f}ms, both bit-equal; a session "
                  f"over it: compile_ms {st.compile_ms}, warm_load_ms "
                  f"{st.warm_load_ms:.0f}, bit-equal; the loaded direct "
                  f"entry captured {entry.trace_count} graph", flush=True)
            print(json.dumps({"path": path, "phase": "aot", "card": card,
                              "save_ms": save_ms, "bundle_bytes": size,
                              "build_first_request_ms": timed["build"],
                              "warm_load_first_request_ms":
                                  timed["warm_load"],
                              "session_warm_load_ms": st.warm_load_ms,
                              "session_compile_ms": st.compile_ms}),
                  flush=True)

        # a stale fingerprint: another torch version
        path = "resnet18_fp32"
        acc, x = results[path]["acc"], xs[path_specs(path)[1]]
        fingerprint = aot.environment_fingerprint
        aot.environment_fingerprint = lambda device="cpu": dict(
            fingerprint(device), torch_version="0.0.0")
        try:
            records.messages.clear()
            cache = ProgramCache()
            stale = api.Accelerator.from_program(
                str(out_dir / f"{path}.bundle"), params=acc.params,
                backend="hopper", device="cuda", cache=cache)
            y_stale = stale(x)
        finally:
            aot.environment_fingerprint = fingerprint
        warned = [m for m in records.messages if "torch_version" in m]
        if (not warned or cache.stats.aot_loads != 0
                or not torch.equal(y_stale, acc(x))):
            raise AssertionError(f"stale aot reload: warnings "
                                 f"{records.messages}, {cache.stats}")
        print(f"path {path} aot stale ({card}): a reload under another "
              f"torch version logged '{warned[0][:160]}...' and built fresh,"
              f" bit-equal", flush=True)
    finally:
        logging.getLogger("repro_torch.aot").removeHandler(records)


def session_segmented(served: dict, x: torch.Tensor, card: str) -> dict:
    """Phase 3b segmented: VGG16 fp32 with ``segmented=True`` on hopper,
    the served params: 5 segment Programs, a host maxpool between them,
    the FC tail on K2: the same kernel calls on the same shapes, so its
    logits must equal the single Program's bit for bit and its launches
    per request the single Program's. Prints its ms/batch."""
    from repro_torch import api
    from repro_torch.kernels import common
    acc = served["acc"]
    seg = api.Accelerator.build(acc.specs, plans=acc.plans,
                                params=acc.params, batch=BATCH,
                                backend="hopper", segmented=True,
                                device="cuda")
    seg(x)
    torch.cuda.synchronize()
    y, times, per_request = timed_requests(seg, x)
    if per_request != PATHS["vgg16_fp32"]:
        raise AssertionError(f"segmented VGG16: launches per request "
                             f"{per_request} != {PATHS['vgg16_fp32']}")
    y_single = acc(x)
    err = float((y - y_single).abs().max())
    if not torch.equal(y, y_single):
        raise AssertionError(f"segmented VGG16 differs from the single "
                             f"Program: max|diff| {err:.3e}")
    print(f"path vgg16_fp32 segmented ({card}): "
          f"{len(seg.segment_runtimes)} segment Programs "
          f"({seg.n_instructions} instructions) + host maxpool + FC tail on "
          f"K2: {fmt_ms(times)}ms/batch over {STEADY_REQUESTS} requests "
          f"against the single Program's {served['steady_ms']:.2f}; vs the "
          f"single-Program logits max|diff| {err:.3e}; launches per request "
          f"{per_request}", flush=True)
    print(json.dumps({"path": "vgg16_fp32_segmented", "card": card,
                      "ms": times, "single_program_ms": served["steady_ms"],
                      "max_abs_diff_vs_single_program": err,
                      "launches_per_request": per_request}), flush=True)
    return dict(launches={k: v * STEADY_REQUESTS
                          for k, v in per_request.items()})


def f3_rotation(served: dict, x: torch.Tensor, card: str) -> dict:
    """Phase 3c, F3: five ResNet-18 fp32 accelerators of one program with
    distinct weights (seeds 0-4), in a program cache of their own, called
    in rotation on one stream for three rounds. The shared entry captures
    once per weight set (5 graphs, not one a call), every answer is
    ``torch.equal`` to ``entry.fn`` on the same weights, and the calls of
    rounds 2-3 (each synchronised) are timed against one tenant's captured
    calls alone; ``memory_reserved`` after the first tenant's capture and
    after all five says what each further live graph costs."""
    from repro_torch import api
    from repro_torch.core import perf_model as pm
    from repro_torch.core.program_cache import ProgramCache
    from repro_torch.kernels import common

    acc0 = served["acc"]
    cache = ProgramCache()
    accs = [api.Accelerator.build(acc0.specs, pm.V5E, batch=BATCH,
                                  backend="hopper", seed=seed,
                                  plans=acc0.plans, device="cuda",
                                  cache=cache) for seed in range(5)]
    entry = accs[0].runtime.executor_entry(BATCH)[0]

    def call(acc) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = acc(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        # the comparison's launches go to a throwaway count, not the path's
        with torch.no_grad(), common.recording_launches():
            y_fn = entry.fn(acc.runtime.dram_params(), x)
        if not torch.equal(y, y_fn):
            raise AssertionError(f"F3: tenant's answer differs from "
                                 f"entry.fn in {int((y != y_fn).sum())} "
                                 f"places")
        return dt

    def memory() -> tuple:
        torch.cuda.synchronize()
        return (torch.cuda.memory_reserved() / 2 ** 20,
                torch.cuda.memory_allocated() / 2 ** 20)

    (reserved0, alloc0) = memory()
    common.reset_launches()
    call(accs[0])
    (reserved1, alloc1) = memory()
    single = [call(accs[0]) for _ in range(10)]
    rounds = [[call(acc) for acc in accs] for _ in range(3)]
    (reserved5, alloc5) = memory()
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    n_calls = 1 + len(single) + 3 * len(accs)
    expected = {k: v * n_calls for k, v in PATHS["resnet18_fp32"].items()}
    if launches != expected:
        raise AssertionError(f"F3: launches {launches} over {n_calls} calls, "
                             f"expected {expected}")
    if entry.trace_count != 5 or len(entry._graphs) != 5:
        raise AssertionError(f"F3: {entry.trace_count} captures, "
                             f"{len(entry._graphs)} graphs kept for five "
                             f"tenants in rotation (expected 5 and 5)")
    rot = [dt for r in rounds[1:] for dt in r]
    print(f"F3 rotation ({card}): five ResNet-18 fp32 tenants of one "
          f"program, three rounds on one stream: {entry.trace_count} "
          f"captures, every answer torch.equal to entry.fn; rounds 2-3 "
          f"{statistics.mean(rot):.3f}ms a call (median "
          f"{statistics.median(rot):.3f}, max {max(rot):.3f}; round 1 "
          f"with four captures {fmt_ms(rounds[0])}) against one tenant "
          f"alone {statistics.mean(single):.3f}ms (median "
          f"{statistics.median(single):.3f}); memory reserved "
          f"{reserved0:.0f} MiB before, {reserved1:.0f} after the first "
          f"capture, {reserved5:.0f} after five "
          f"({(reserved5 - reserved1) / 4:.1f} MiB a further live graph; "
          f"allocated {alloc0:.1f}, {alloc1:.1f}, {alloc5:.1f} MiB: "
          f"{(alloc5 - alloc1) / 4:.2f} a further graph)", flush=True)
    print(json.dumps({"phase": "f3_rotation", "card": card,
                      "captures": entry.trace_count,
                      "rotation_ms": rot, "round1_ms": rounds[0],
                      "single_tenant_ms": single,
                      "reserved_mib": [reserved0, reserved1, reserved5],
                      "allocated_mib": [alloc0, alloc1, alloc5]}),
          flush=True)
    return dict(launches=launches)


MESH_BUCKETS = (4, 8)


def mesh_requests(x: torch.Tensor) -> list:
    """Phase 3c's bulk traffic: 16 requests of 8 images and one of 3,
    seeded; each request fills a batch of its own."""
    rng = np.random.default_rng(17)
    shape = tuple(x.shape[1:])
    return ([rng.standard_normal((BATCH, *shape)).astype(np.float32)
             for _ in range(SESSION_BULK)]
            + [rng.standard_normal((3, *shape)).astype(np.float32)])


def timed_run_many(session, reqs) -> tuple:
    from repro_torch.kernels import common
    common.reset_launches()
    t0 = time.perf_counter()
    out = session.run_many(reqs)
    dt = time.perf_counter() - t0
    return (np.concatenate(out), dt,
            {k: v for k, v in common.LAUNCHES.items() if v})


def sharded_sessions(results: dict, xs: dict, card: str) -> dict:
    """Phase 3c, the mesh on the one card. (1) Keying: ``make_fleet_mesh()``
    and ``make_host_mesh()`` span one position here and alias the
    unsharded entry (``is``), and a session with ``mesh="host"`` is bit for
    bit the one with ``mesh=None``. (2) Each model path through a session
    over a two-replica mesh ``(cuda:0, cuda:0)``, ``buckets=(4, 8)``,
    against the unsharded session on the same requests (16 of 8 images and
    one of 3): int8 bit for bit, fp32 within ``1e-3 * max|logit|``;
    ``device_batches`` counts every batch on both positions; the launches
    are twice a shard's (one dispatch a layer) per batch; bulk ms/batch of
    both. A session with ``buckets=(3, 8)`` sends the 3-image request to
    the single-device entry: counted on position 0 only. (3) A ``Fleet``
    of VGG16 int8 and ResNet-18 fp32 over the mesh, bit for bit their
    standalone sharded sessions. (4) The serve CLI with ``--mesh host``."""
    from repro_torch.compat import make_mesh
    from repro_torch.launch.mesh import make_fleet_mesh, make_host_mesh
    from repro_torch import api

    launches: dict = {}
    acc = results["resnet18_fp32"]["acc"]
    rt = acc.runtime
    e0 = rt.executor_entry(BATCH)[0]
    for name, m in (("make_fleet_mesh()", make_fleet_mesh()),
                    ("make_host_mesh()", make_host_mesh())):
        if m.size != 1 or rt.executor_entry(BATCH, mesh=m)[0] is not e0:
            raise AssertionError(f"{name} on one card must alias the "
                                 f"unsharded entry")
    reqs = mesh_requests(xs[path_specs("resnet18_fp32")[1]])[:4]
    outs = {}
    for mesh in (None, "host"):
        with acc.serve(max_batch=BATCH, buckets=MESH_BUCKETS, warmup=True,
                       mesh=mesh) as s:
            outs[mesh] = np.concatenate(s.run_many(reqs))
            if s._sharded_entries:
                raise AssertionError("mesh='host' on one card sharded")
    if not np.array_equal(outs[None], outs["host"]):
        raise AssertionError("mesh='host' differs from mesh=None")
    print(f"mesh keying ({card}): make_fleet_mesh() and make_host_mesh() "
          f"span 1 position and alias the unsharded entry; a session with "
          f"mesh='host' bit-equal to mesh=None", flush=True)

    mesh = make_mesh((2,), ("batch",), devices=["cuda:0", "cuda:0"])
    standalone, rows = {}, []
    for path in SESSION_PATHS:
        acc = results[path]["acc"]
        reqs = mesh_requests(xs[path_specs(path)[1]])
        with acc.serve(max_batch=BATCH, buckets=MESH_BUCKETS,
                       warmup=True) as s:
            ref, t_ref, _ = timed_run_many(s, reqs)
        with acc.serve(max_batch=BATCH, buckets=MESH_BUCKETS, warmup=True,
                       mesh=mesh) as s:
            captures = {b: e.trace_count
                        for b, e in s._sharded_entries.items()}
            got, t_got, counts = timed_run_many(s, reqs)
            st = s.stats
        n_batches = len(reqs)
        check_session_ledger(f"{path} sharded session", st)
        if st.device_batches != {0: n_batches, 1: n_batches} or \
                captures != {b: 1 for b in MESH_BUCKETS}:
            raise AssertionError(f"{path} sharded: device_batches "
                                 f"{st.device_batches}, captures {captures}")
        expected = {k: 2 * n_batches * v for k, v in PATHS[path].items()}
        if counts != expected:
            raise AssertionError(f"{path} sharded: launches {counts}, "
                                 f"expected {expected}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        err = float(np.abs(got - ref).max())
        tol = 0.0 if path.endswith("int8") else 1e-3 * float(
            np.abs(ref).max())
        if not err <= tol:
            raise AssertionError(f"{path} sharded vs unsharded session: "
                                 f"max|diff| {err:.3e} > {tol:.3e}")
        standalone[path] = got
        ms_got, ms_ref = t_got * 1e3 / n_batches, t_ref * 1e3 / n_batches
        rows.append(dict(path=path, sharded_ms_per_batch=ms_got,
                         unsharded_ms_per_batch=ms_ref, max_abs_diff=err,
                         tol=tol, device_batches=st.device_batches))
        print(f"path {path} sharded session ({card}): two replicas on one "
              f"card, buckets {MESH_BUCKETS} both sharded (one graph a "
              f"bucket); run_many of {SESSION_BULK} x {BATCH} + 3 images "
              f"{ms_got:.2f}ms/batch against unsharded {ms_ref:.2f}; "
              f"max|diff| {err:.3e} (tolerance {tol:.3e}); device_batches "
              f"{st.device_batches}; launches {counts} = 2 shards x "
              f"{n_batches} batches x {PATHS[path]}", flush=True)
    acc = results["resnet18_int8"]["acc"]
    reqs = mesh_requests(xs[path_specs("resnet18_int8")[1]])
    with acc.serve(max_batch=BATCH, buckets=(3, BATCH), mesh=mesh) as s:
        got = np.concatenate(s.run_many(reqs))
        st = s.stats
    n = len(reqs)
    if st.device_batches != {0: n, 1: n - 1} or \
            not np.array_equal(got, standalone["resnet18_int8"]):
        raise AssertionError(f"straggler bucket: device_batches "
                             f"{st.device_batches}")
    print(f"mesh straggler ({card}): resnet18_int8 with buckets (3, 8): the "
          f"3-image request on the single-device entry, device_batches "
          f"{st.device_batches}, bit-equal", flush=True)

    fleet_paths = {"vgg16_int8": "v", "resnet18_fp32": "r"}
    accs = {tag: results[p]["acc"] for p, tag in fleet_paths.items()}
    pairs = [(tag, r) for p, tag in fleet_paths.items()
             for r in mesh_requests(xs[path_specs(p)[1]])]
    with api.Fleet(accs, mesh=mesh, max_batch=BATCH, buckets=MESH_BUCKETS,
                   warmup=True) as fleet:
        res = fleet.run_many(pairs)
    n = len(res) // 2
    for (p, tag), part in zip(fleet_paths.items(), (res[:n], res[n:])):
        if not np.array_equal(np.concatenate(part), standalone[p]):
            raise AssertionError(f"Fleet over the mesh: {p} differs from "
                                 f"its standalone sharded session")
    print(f"Fleet over the mesh ({card}): VGG16 int8 and ResNet-18 fp32, "
          f"bit-equal to their standalone sharded sessions", flush=True)

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "resnet18", "--no-reduced", "--session", "--mesh", "host"]
    src = str(Path(__file__).resolve().parent / "src")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": src})
    if r.returncode != 0 or "per-device batches (mesh=host)" not in r.stdout:
        raise AssertionError(f"serve --mesh host: rc {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    tail = [ln for ln in r.stdout.splitlines()
            if "ServingSession" in ln or "per-device" in ln]
    print(f"serve CLI ({card}): {' '.join(cmd[2:])} ran to its end in "
          f"{time.perf_counter() - t0:.1f}s: {' | '.join(tail)}", flush=True)
    print(json.dumps({"phase": "sharded_sessions", "card": card,
                      "paths": rows}, default=str), flush=True)
    return dict(launches=launches)


def checkpoint_recovery(results: dict, xs: dict, card: str) -> dict:
    """Phase 3d: ``checkpoint.save`` of full-width VGG16 fp32 ``acc.params``
    from the card, blocking and async (ms and bytes each); ``restore`` onto
    ``cuda:0`` and onto ``cpu`` (bit for bit), and an accelerator rebuilt
    from the restored params serving captured logits ``torch.equal`` to the
    original's; ``run_with_recovery`` over 10 steps whose state sums
    ResNet-18 hopper logits on the card, one failure injected at step 7
    (``restarts == 1``, the final state ``torch.equal`` to a run without
    failure); ``elastic_restore`` onto placements over a two-replica
    mesh's devices."""
    from repro_torch import api
    from repro_torch.checkpoint import elastic_restore, run_with_recovery
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.compat import make_mesh
    from repro_torch.core import perf_model as pm
    from repro_torch.kernels import common

    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    acc = results["vgg16_fp32"]["acc"]
    x = xs[path_specs("vgg16_fp32")[1]]
    params = acc.params
    timings = {}
    for mode in ("blocking", "async"):
        d = root / mode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = ckpt.save(str(d), 1, params, blocking=mode == "blocking")
        t_call = (time.perf_counter() - t0) * 1e3
        if t is not None:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("async checkpoint writer did not end")
        t_done = (time.perf_counter() - t0) * 1e3
        nbytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        timings[mode] = dict(call_ms=t_call, done_ms=t_done, bytes=nbytes)
    n_param_bytes = sum(w.numel() * w.element_size() + b.numel()
                        * b.element_size() for w, b in params)
    restored = {}
    for dev in ("cuda:0", "cpu"):
        t0 = time.perf_counter()
        tree, step = ckpt.restore(str(root / "async"), params, device=dev)
        if dev == "cuda:0":
            torch.cuda.synchronize()
        timings[f"restore_{dev}_ms"] = (time.perf_counter() - t0) * 1e3
        for (w, b), (w2, b2) in zip(params, tree):
            if not (torch.equal(w.to(dev), w2) and torch.equal(b.to(dev), b2)
                    and w2.device == torch.device(dev)):
                raise AssertionError(f"restore onto {dev} differs")
        restored[dev] = tree
    again = api.Accelerator.build(acc.specs, pm.V5E, batch=BATCH,
                                  backend="hopper", plans=acc.plans,
                                  params=restored["cuda:0"], device="cuda")
    y, y2 = acc(x), again(x)
    entry = acc.runtime.executor_entry(BATCH)[0]
    if again.runtime.executor_entry(BATCH)[0] is not entry or \
            not torch.equal(y, y2):
        raise AssertionError("the accelerator rebuilt from restored params "
                             "differs from the original")
    blk, asy = timings["blocking"], timings["async"]
    print(f"checkpoint ({card}): VGG16 fp32 params ({n_param_bytes} bytes "
          f"on the card) saved blocking in {blk['done_ms']:.0f}ms "
          f"({blk['bytes']} bytes on disk); async: the call returned in "
          f"{asy['call_ms']:.0f}ms (copy to the host), written after "
          f"{asy['done_ms']:.0f}ms ({asy['bytes']} bytes); restored onto "
          f"cuda:0 in "
          f"{timings['restore_cuda:0_ms']:.0f}ms and onto cpu in "
          f"{timings['restore_cpu_ms']:.0f}ms, bit for bit; a rebuilt "
          f"accelerator's captured logits torch.equal to the original's "
          f"({entry.trace_count} graphs on the shared entry)", flush=True)
    del restored, again

    r18 = results["resnet18_fp32"]["acc"]
    shape = path_specs("resnet18_fp32")[1]
    inputs = [torch.from_numpy(np.random.default_rng(100 + s).standard_normal(
        (BATCH, *shape)).astype(np.float32)).cuda() for s in range(10)]

    def make_step(fail_at):
        calls = {"n": 0}

        def step_fn(state, step):
            calls["n"] += 1
            if step == fail_at and calls["n"] == fail_at + 1:
                raise RuntimeError("injected node failure")
            return {"logits": state["logits"] + r18(inputs[step]),
                    "steps": state["steps"] + 1}
        return step_fn

    init = {"logits": torch.zeros((BATCH, N_CLASSES), device="cuda"),
            "steps": torch.zeros((), dtype=torch.int32, device="cuda")}
    common.reset_launches()
    t0 = time.perf_counter()
    state, log = run_with_recovery(make_step(7), init, 10,
                                   str(root / "recover"), ckpt_every=5)
    t_rec = (time.perf_counter() - t0) * 1e3
    clean, clean_log = run_with_recovery(make_step(-1), init, 10,
                                         str(root / "clean"), ckpt_every=5)
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    # 10 steps and the 2 replayed after the restore at step 5, then 10
    expected = {k: 22 * v for k, v in PATHS["resnet18_fp32"].items()}
    if (log["restarts"] != 1 or clean_log["restarts"] != 0
            or log["completed"] != [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]
            or not all(torch.equal(state[k], clean[k]) for k in state)
            or int(state["steps"]) != 10 or launches != expected):
        raise AssertionError(f"run_with_recovery: log {log}, launches "
                             f"{launches} (expected {expected})")
    print(f"recovery ({card}): run_with_recovery over 10 steps summing "
          f"ResNet-18 hopper logits on the card, a failure at step 7: "
          f"restarts {log['restarts']}, replayed from step 5, final state "
          f"torch.equal to the run without failure ({t_rec:.0f}ms, "
          f"checkpoints every 5 steps)", flush=True)

    mesh = make_mesh((2,), ("batch",), devices=["cuda:0", "cuda:0"])

    def placements(template, m):
        devs = list(m.devices.flat)
        return [(devs[i % len(devs)], devs[(i + 1) % len(devs)])
                for i in range(len(template))]

    tree, step = elastic_restore(str(root / "blocking"), params, mesh,
                                 placements)
    if step != 1 or not all(torch.equal(w, w2) and torch.equal(b, b2)
                            for (w, b), (w2, b2) in zip(params, tree)):
        raise AssertionError("elastic_restore differs")
    print(f"elastic restore ({card}): VGG16 fp32 checkpoint onto placements "
          f"over the mesh's devices {[str(d) for d in mesh.devices.flat]}, "
          f"bit for bit", flush=True)
    print(json.dumps({"phase": "checkpoint", "card": card,
                      "param_bytes": n_param_bytes, **timings,
                      "recovery_ms": t_rec}), flush=True)
    del tree
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches)


def path_program(path: str):
    """The program a phase-2 path runs, its dtype and whether it makes one
    PE call per COMP block (the interpreter's paths)."""
    from repro_torch.core import perf_model as pm
    from repro_torch.core.compiler import compile_network
    base = STRICT_PATHS.get(path, path)
    specs = path_specs(base)[0]
    dtype = "int8" if base.endswith("int8") else "float32"
    program = compile_network(
        specs, pm.V5E.run_dse(specs, batch=BATCH, dtype=dtype).plans)
    return program, dtype, path in STRICT_PATHS


def timed_requests(run, inp: torch.Tensor) -> tuple:
    """``STEADY_REQUESTS`` requests of ``run``, each timed on the host
    clock to a synchronise, with the launch counts set to 0 just before
    the first and read just after the last: (last output, ms per request,
    launches per request, or None where a count is not a multiple)."""
    from repro_torch.kernels import common
    common.reset_launches()
    times = []
    for _ in range(STEADY_REQUESTS):
        t0 = time.perf_counter()
        y = run(inp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_request = {k: (v // STEADY_REQUESTS if v % STEADY_REQUESTS == 0
                       else None)
                   for k, v in common.LAUNCHES.items() if v}
    return y, times, per_request


def fmt_ms(times: list) -> str:
    """Median [min-max] of per-request times."""
    return (f"{statistics.median(times):.2f} [{min(times):.2f}-"
            f"{max(times):.2f}]")


def kernel_delta(a: dict, b: dict, n: int = 5) -> list:
    """The ``n`` kernel names whose device time differs most between two
    profiles (:func:`device_profile` ``by_kernel``): ``[name, ms of a minus
    ms of b, calls of a minus calls of b]``."""
    rows = []
    for k in {*a, *b}:
        (ms_a, n_a), (ms_b, n_b) = a.get(k, (0.0, 0)), b.get(k, (0.0, 0))
        rows.append([k, ms_a - ms_b, n_a - n_b])
    return sorted(rows, key=lambda r: -abs(r[1]))[:n]


def hold_strict(label: str, acc, inp: torch.Tensor) -> dict:
    """``acc``'s program, params and sidecar on the strict interpreter with
    ``backend="hopper"``: one warm request, then ``STEADY_REQUESTS`` timed
    ones with the launch counts set to 0 just before and read just after
    (per request they must equal one PE call per COMP block and per FC),
    held bit for bit to an ``opt_level=0`` hopper executor on the same DRAM
    image (the same calls, timed the same way), and to the served
    ``opt_level=1`` executor: int8 bit for bit, fp32 within
    ``1e-3 * max|logit|``. One request of each under ``torch.profiler``
    says where the interpreter's extra time goes."""
    from repro_torch.core.runtime import HybridRuntime

    int8 = acc.quant is not None
    st = HybridRuntime(acc.program, strict=True, backend="hopper",
                       device="cuda", quant=acc.quant)
    st.load_params(acc.params)
    ex0 = HybridRuntime(acc.program, backend="hopper", opt_level=0,
                        device="cuda", quant=acc.quant)
    ex0.load_params(acc.params)
    st.run(inp)
    ex0.run(inp)
    torch.cuda.synchronize()
    y, interp_ms, launches = timed_requests(st.run, inp)
    expected = case_launches(kernel_cases(
        acc.program, BATCH, "int8" if int8 else "float32", per_block=True))
    if launches != expected:
        raise AssertionError(f"{label}: interpreter launches per request "
                             f"{launches} != one per COMP block and FC "
                             f"{expected}")
    y0, opt0_ms, launches0 = timed_requests(ex0.run, inp)
    if launches0 != launches:
        raise AssertionError(f"{label}: opt_level=0 executor launches "
                             f"{launches0} != interpreter's {launches}")
    if not torch.equal(y, y0):
        raise AssertionError(
            f"{label}: interpreter differs from the opt_level=0 executor in "
            f"{int((y != y0).sum())} places, max|diff| "
            f"{float((y.float() - y0.float()).abs().max()):.3e}")
    y1 = acc.runtime.run(inp)
    torch.cuda.synchronize()
    if int8:
        if not torch.equal(y, y1):
            raise AssertionError(f"{label}: int8 interpreter differs from the "
                                 f"served executor in "
                                 f"{int((y != y1).sum())} places")
        err, tol = 0.0, 0.0
    else:
        err = float((y - y1).abs().max())
        tol = 1e-3 * float(y1.abs().max())
        if not err <= tol:
            raise AssertionError(f"{label}: interpreter vs served executor "
                                 f"max|diff| {err:.3e} > {tol:.3e}")
    if not torch.isfinite(y.float()).all():
        raise AssertionError(f"{label}: non-finite interpreter output")
    prof = {"interp": device_profile(lambda: st.run(inp), by_kernel=True),
            "opt0": device_profile(lambda: ex0.run(inp), by_kernel=True)}
    delta = kernel_delta(prof["interp"].pop("by_kernel"),
                         prof["opt0"].pop("by_kernel"))
    return dict(y=y, launches=launches, interp_ms=interp_ms,
                opt0_ms=opt0_ms, max_abs_diff_vs_served=err, tol=tol,
                equal_to_served=err == 0, profile=prof,
                device_delta=delta)


def interpret_path(path: str, served: dict, x: torch.Tensor,
                   card: str) -> dict:
    """Phase 4 (a): the strict interpreter on ``path``'s served program,
    params and sidecar (:func:`hold_strict`). Every kernel the served
    executor launches must launch on the interpreted request too."""
    acc = served["acc"]
    inp = acc.quant.quantize_input(x) if acc.quant is not None else x
    r = hold_strict(f"{path}_strict", acc, inp)
    missing = [k for k in PATHS[path] if not r["launches"].get(k)]
    if missing:
        raise AssertionError(f"{path}_strict: {missing} never launched")
    pi, p0 = r["profile"]["interp"], r["profile"]["opt0"]
    print(f"path {path}_strict ({card}): batch {BATCH}, interpreted "
          f"requests {fmt_ms(r['interp_ms'])}ms against the served "
          f"executor's steady {served['steady_ms']:.2f}ms/batch and the "
          f"opt_level=0 executor's {fmt_ms(r['opt0_ms'])}ms over "
          f"{STEADY_REQUESTS} requests; launches per interpreted request "
          f"{r['launches']} (served executor {PATHS[path]}); bit-equal to "
          f"opt_level=0; vs the served executor max|diff| "
          f"{r['max_abs_diff_vs_served']:.3e} (equal: "
          f"{r['equal_to_served']}, tolerance {r['tol']:.3e})", flush=True)
    print(f"path {path}_strict profile, one request: interpreter wall "
          f"{pi['wall_ms']:.2f}ms, device busy {pi['device_busy_ms']:.3f}ms "
          f"over {pi['n_kernels']} kernels; opt_level=0 wall "
          f"{p0['wall_ms']:.2f}ms, device busy {p0['device_busy_ms']:.3f}ms "
          f"over {p0['n_kernels']} kernels; largest device differences: "
          + "; ".join(f"{k[:60]} {ms:+.3f}ms {n:+d} calls"
                      for k, ms, n in r["device_delta"]), flush=True)
    print(json.dumps({"path": f"{path}_strict", "card": card,
                      "interp_ms": r["interp_ms"], "opt0_ms": r["opt0_ms"],
                      "served_steady_ms": served["steady_ms"],
                      "launches_per_request": r["launches"],
                      "served_launches_per_request": PATHS[path],
                      "max_abs_diff_vs_served": r["max_abs_diff_vs_served"],
                      "equal_to_served": r["equal_to_served"],
                      "tol": r["tol"], "profile": r["profile"],
                      "device_delta_vs_opt0": r["device_delta"]}),
          flush=True)
    return r


def device_profile(fn, by_kernel: bool = False) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its wall ms (ending in a
    synchronise, profiler overhead included), the summed device time of
    the kernels it ran, and its five longest kernels by name (with
    ``by_kernel``, every kernel name's device ms and calls too). A busy
    time of 0 means the profiler saw no device activity: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               n_kernels=sum(e.count for e in kernels),
               top=[[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in top])
    if by_kernel:
        out["by_kernel"] = {e.key: (e.self_device_time_total / 1e3, e.count)
                            for e in kernels}
    return out


def open_gates(params) -> None:
    """Set a VLM tree's ``xattn_gate`` leaves to ``VISION_GATE``."""
    for slot in params["layers"]:
        if "xattn_gate" in slot:
            slot["xattn_gate"].fill_(VISION_GATE)


def profile_split(pr: dict) -> dict:
    """A profile's device ms by kind: K6, the GEMMs (cuBLAS and CUTLASS
    bodies) and everything else (the SSD's elementwise, scan and reduction
    kernels, norms, softmax, copies)."""
    split = dict(k6_ms=0.0, gemm_ms=0.0, other_ms=0.0)
    for name, (ms, _) in pr.pop("by_kernel").items():
        kind = ("k6_ms" if "flash_attention_" in name
                else "gemm_ms" if GEMM_NAMES.search(name) else "other_ms")
        split[kind] += ms
    return split


def serve_cut(cfg, params, backend: str, batch: int, prompt: int,
              gen: int):
    """``launch.serve.serve`` on a config cut in depth: the same draws
    from seed 0, then the prefill and ``gen`` greedy decode steps through
    ``train.steps``' serve steps (the decode captured), timed as
    ``serve`` times them."""
    from repro_torch.launch.serve import LMServeResult, lm_inputs
    from repro_torch.train import steps

    dev = torch.device("cuda", torch.cuda.current_device())
    prefill, decode = steps.make_serve_steps(cfg, backend=backend)
    cache = steps.init_cache(cfg, batch, prompt + gen, dev)
    extras, prompts, _ = lm_inputs(cfg, params, np.random.default_rng(0),
                                   batch, prompt, backend, dev)
    tokens = torch.from_numpy(prompts).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, cache, extras)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first, outs = logits, []
    tok = logits.argmax(-1)[:, None]
    t0 = t1 = time.perf_counter()
    for i in range(gen):
        outs.append(tok[:, 0])
        logits, cache = decode(params, tok, cache, prompt + i, extras)
        tok = logits.argmax(-1)[:, None]
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    per_token = (t2 - t0) * 1e3 / gen
    replay = (t2 - t1) * 1e3 / (gen - 1)
    print(f"{cfg.name} (cut to {cfg.n_layers} layers, {cfg.dtype}), backend "
          f"{backend}: prefill {prompt} toks x{batch}: {prefill_ms:.1f}ms; "
          f"decode {gen} steps: {per_token:.2f}ms/tok ({decode.route}, "
          f"capture {decode.last_capture_ms:.1f}ms, replay "
          f"{replay:.2f}ms/tok after the first)", flush=True)
    return LMServeResult(tokens=torch.stack(outs, 1).cpu().numpy(),
                         prefill_logits=first, build_ms=None,
                         prefill_ms=prefill_ms,
                         decode_ms_per_token=per_token,
                         replay_ms_per_token=replay,
                         capture_ms=decode.last_capture_ms,
                         decode_route=decode.route,
                         decode_captures=decode.trace_count)


def captured_vs_eager(label: str, decode, params, first: torch.Tensor,
                      cache, prompt: int, gen: int, extras=None) -> dict:
    """The captured decode against its eager step. ``gen`` greedy tokens
    through ``decode`` (a ``train.steps.DecodeStep``: its first step runs
    ``decode.fn`` and captures one CUDA graph, the others replay it) from
    the prefilled ``cache`` whose last-token logits are ``first``; then
    the same steps through ``decode.fn`` with the position as a 0-d
    tensor on the card, from a copy of the cache made before them. Every
    step's logits must be ``torch.equal`` (so the tokens too) and the run
    must capture once. Returns the tokens fed to the steps (as ``serve``
    returns them: the prefill's greedy token first), the capture's host
    ms, the
    first captured step's ms (warm-up and capture), the replays' ms/token
    (the steps after the first), the eager ms/token (every step), the
    route, and one profiled replay and one profiled eager step
    (``device_profile``, by kernel) at the last position."""
    from torch.utils import _pytree as pytree

    from repro_torch.models.layers import SplitCache

    def clone(c):
        if isinstance(c, SplitCache):
            out = SplitCache.__new__(SplitCache)
            out.rows = pytree.tree_map(torch.clone, c.rows)
            return out
        return pytree.tree_map(torch.clone, c)

    dev = first.device
    at = lambda pos: torch.full((), pos, dtype=torch.int64,  # noqa: E731
                                device=dev)
    steps_of = {
        "captured": lambda tok, c, pos: decode(params, tok, c, pos, extras),
        "eager": lambda tok, c, pos: decode.fn(params, tok, c, at(pos),
                                               extras)}
    caches = {"eager": clone(cache), "captured": cache}
    n0 = decode.trace_count
    runs = {}
    for how in ("captured", "eager"):
        step, c = steps_of[how], caches[how]
        tok, logits_all = first.argmax(-1)[:, None], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(gen):
            logits, c = step(tok, c, prompt + i)
            if i == 0:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            logits_all.append(logits)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs[how] = dict(logits=logits_all, first_ms=(t1 - t0) * 1e3,
                         rest_ms=(t2 - t1) * 1e3 / max(gen - 1, 1),
                         all_ms=(t2 - t0) * 1e3 / gen, cache=c)
    captures = decode.trace_count - n0
    cap, eag = runs["captured"], runs["eager"]
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(cap["logits"], eag["logits"])]
    equal = all(torch.equal(a, b)
                for a, b in zip(cap["logits"], eag["logits"]))
    # the tokens fed to the steps, as ``serve`` returns them
    tokens = [torch.stack([first.argmax(-1)] + [x.argmax(-1) for x in
                                                r["logits"][:-1]], 1)
              for r in (cap, eag)]
    if decode.route != "captured" or captures != 1 or not equal:
        raise AssertionError(
            f"{label}: the captured decode ({decode.route}, {captures} "
            f"captures) against its eager step: logits equal at every step "
            f"{equal} (max|diff| per step {diffs}), tokens equal "
            f"{torch.equal(*tokens)}")
    tok, pos = cap["logits"][-1].argmax(-1)[:, None], prompt + gen - 1
    prof_replay = device_profile(
        lambda: decode(params, tok, cap["cache"], pos, extras),
        by_kernel=True)
    prof_eager = device_profile(
        lambda: decode.fn(params, tok, eag["cache"], at(pos), extras),
        by_kernel=True)
    if decode.trace_count - n0 != 1:
        raise AssertionError(f"{label}: the profiled replay captured again")
    return dict(route=decode.route, captures=captures,
                capture_ms=decode.last_capture_ms,
                first_step_ms=cap["first_ms"], replay_ms=cap["rest_ms"],
                eager_ms=eag["all_ms"], tokens=tokens[0].cpu().numpy(),
                profile_replay=prof_replay, profile_eager=prof_eager)


def graph_line(g: dict) -> str:
    """One line of :func:`captured_vs_eager`'s numbers."""
    r, e = g["profile_replay"], g["profile_eager"]
    return (f"decode {g['route']}: capture {g['capture_ms']:.1f}ms (host; "
            f"the first step {g['first_step_ms']:.1f}ms with its warm-up), "
            f"replay {g['replay_ms']:.2f}ms/token against eager "
            f"{g['eager_ms']:.2f}ms/token, tokens equal, logits torch.equal "
            f"at every step; one replay: device busy "
            f"{r['device_busy_ms']:.2f}ms of {r['wall_ms']:.2f}ms "
            f"({r['device_busy_ms'] / r['wall_ms']:.1%}) over "
            f"{r['n_kernels']} kernels; one eager step: "
            f"{e['device_busy_ms']:.2f}ms of {e['wall_ms']:.2f}ms "
            f"({e['device_busy_ms'] / e['wall_ms']:.1%}) over "
            f"{e['n_kernels']} kernels")


class Routing:
    """Records, while entered, the routing of every MoE prefill call
    (more than one token) of ``transformer.moe``: the expert each token
    takes (the first maximum of the float32 router logits, as ``moe``
    takes it) and the bucket capacity. A layer split along ``model`` runs
    one call per position, each routing the same tokens from the whole
    router: the last position's (its range ends at the last expert) is
    recorded. ``first`` keeps the first recorded call's layer tree and
    input."""

    def __init__(self):
        self.calls = []
        self.first = None

    def __enter__(self):
        from repro_torch.models import transformer
        self._moe = moe = transformer.moe

        def recording(p, x, cfg, experts=None):
            if x.shape[1] > 1 and (experts is None
                                   or experts[1] == cfg.n_experts):
                idx = (x.float() @ p["router"]).argmax(-1)
                cap = max(1, int(cfg.capacity_factor * x.shape[1]
                                 / cfg.n_experts) + 1)
                self.calls.append((idx, cap, cfg.n_experts))
                if self.first is None:
                    self.first = (p, x)
            return moe(p, x, cfg, experts=experts)
        transformer.moe = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer.moe = self._moe

    def layers(self) -> list:
        """Per MoE layer of the first prefill: the tokens each expert got
        (summed over the batch rows), the capacity a row, and the tokens
        dropped past it."""
        out = []
        for idx, cap, e in self.calls:
            rows = torch.nn.functional.one_hot(idx, e).sum(1)    # (B, E)
            out.append(dict(experts=rows.sum(0).tolist(), cap=cap,
                            dropped=int((rows - cap).clamp(min=0).sum())))
        return out

    def flips(self, other: "Routing", rows: int = 1) -> int:
        """Tokens routed to another expert than in ``other``'s calls; with
        ``rows``, this run's calls are each data row's layers in turn (a
        split run over as many rows), joined along the batch."""
        m = len(self.calls) // rows
        mine = [torch.cat([self.calls[r * m + i][0] for r in range(rows)])
                for i in range(m)]
        if m != len(other.calls):
            raise AssertionError(f"{m} MoE calls a row against "
                                 f"{len(other.calls)}")
        return sum(int((a != b).sum()) for a, (b, _, _)
                   in zip(mine, other.calls))


def serve_lm(path: str, k6_ms: float) -> dict:
    """Serve one LM path at full width (bf16, random weights from seed 0)
    through ``launch.serve.serve`` (a path cut in depth through
    ``serve_cut``) on the hopper backend, with the launch counts set to 0
    just before and checked just after; check them per phase on a second
    prefill and on the captured decode, held to its eager step from that
    prefill (:func:`captured_vs_eager`; the served decode captured once);
    hold the last-token prefill logits
    against ``backend="torch"`` on the same params (within
    ``LM_TOL * max|logit|``, or equal where no kernel is on the path). An
    MoE path prints each MoE layer's routing of the prefill and the tokens
    routed to another expert under ``torch``. ``k6_ms`` is phase 2's K6
    time per request of the path (all calls)."""
    from repro_torch.kernels import common
    from repro_torch.launch.serve import lm_inputs, serve
    from repro_torch.train import steps

    arch, batch, prompt, gen = LM_PATHS[path]
    cfg = lm_config(path)
    moe = cfg.family == "moe"
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    if cfg.family == "vlm":
        open_gates(params)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(reduced=False, batch=batch, prompt_len=prompt, gen=gen,
              seed=0, device="cuda", params=params)

    def run(backend):
        if path in LM_CUT:
            return serve_cut(cfg, params, backend, batch, prompt, gen)
        return serve(arch, backend=backend, **kw)

    routed = Routing()
    common.reset_launches()
    with routed:
        out = run("hopper")
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    expected = PATHS[path]
    for name in common.KERNELS:
        if launches[name] != expected.get(name, 0):
            raise AssertionError(f"{path}: {name} launched "
                                 f"{launches[name]} times in one request, "
                                 f"expected {expected.get(name, 0)}")
    y = out.prefill_logits.float()
    if y.shape != (batch, cfg.vocab_size) or not torch.isfinite(y).all():
        raise AssertionError(f"{path}: prefill logits {tuple(y.shape)} "
                             f"or non-finite values")

    # per phase, on the same inputs (serve draws them from seed 0)
    prefill, decode = steps.make_serve_steps(cfg, backend="hopper")
    cache = steps.init_cache(cfg, batch, prompt + gen, "cuda")
    extras, prompts, _ = lm_inputs(cfg, params, np.random.default_rng(0),
                                   batch, prompt, "hopper", dev)
    prompts = torch.from_numpy(prompts).cuda()
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, cache, extras)
    torch.cuda.synchronize()
    warm_prefill_ms = (time.perf_counter() - t0) * 1e3
    n_prefill = common.LAUNCHES["flash_attention"]
    common.reset_launches()
    # the captured decode against its eager step, from this prefill
    graph = captured_vs_eager(path, decode, params, logits, cache, prompt,
                              gen, extras)
    n_decode = common.LAUNCHES["flash_attention"]
    want = expected.get("flash_attention", 0)
    if (n_prefill, n_decode) != (want, 0):
        raise AssertionError(f"{path}: K6 launched {n_prefill} times in "
                             f"a prefill and {n_decode} in {2 * gen + 2} "
                             f"decode steps, expected {want} and 0")
    if (out.decode_route, out.decode_captures) != ("captured", 1):
        raise AssertionError(f"{path}: the served decode ran "
                             f"{out.decode_route!r} with "
                             f"{out.decode_captures} captures")
    served_tokens_equal = bool(np.array_equal(out.tokens, graph["tokens"]))
    repeat_diff = float((logits.float() - y).abs().max())
    # where the device time goes, and how much of the wall time it fills
    # (a prefill restarts the SSM states; the attention's cache rows are
    # rewritten with the same values)
    prof_prefill = device_profile(
        lambda: prefill(params, prompts, cache, extras), by_kernel=True)
    prof_decode = graph.pop("profile_replay")
    prof_eager = graph.pop("profile_eager")
    split = {"prefill": profile_split(prof_prefill),
             "decode_step": profile_split(prof_decode),
             "eager_decode_step": profile_split(prof_eager)}
    del cache, logits, extras

    routed_ref = Routing()
    with routed_ref:
        ref = run("torch")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    y_ref = ref.prefill_logits.float()
    err = float((y - y_ref).abs().max())
    drift, flips, routing = None, None, None
    if moe:
        routing = routed.layers()
        flips = routed.flips(routed_ref)
        routed_tokens = batch * prompt * len(routing)
        for i, r in enumerate(routing):
            print(f"path {path} routing, prefill (hopper), MoE layer {i}: "
                  f"tokens per expert {r['experts']} (capacity {r['cap']} "
                  f"a row), dropped {r['dropped']}", flush=True)
        print(f"path {path}: {flips} of {routed_tokens} routed tokens "
              f"(prefill, all MoE layers) take another expert under "
              f"backend='torch'", flush=True)
    if path in LM_EXACT:
        tol = 0.0
        if not torch.equal(out.prefill_logits, ref.prefill_logits):
            raise AssertionError(f"{path}: hopper and torch run the same "
                                 f"ops, but their prefill logits differ "
                                 f"by up to {err:.3e}")
    elif path in LM_DRIFT:
        tol = LM_TOL * float(y_ref.abs().max())
        drift = fp32_held(path, cfg, params, prompts, y, y_ref)
    else:
        tol = LM_TOL * float(y_ref.abs().max())
        if moe and not err <= tol and flips:
            print(f"path {path}: bf16 hopper vs torch max|diff| {err:.3e} > "
                  f"{tol:.3e} with {flips} tokens routed apart; held in "
                  f"fp32 on the first {FLIP_LAYERS} layers", flush=True)
            drift = fp32_held(path, cfg, params, prompts, None, None,
                              n_layers=FLIP_LAYERS)
        elif not err <= tol:
            raise AssertionError(f"{path}: hopper vs torch prefill logits "
                                 f"max|diff| {err:.3e} > {tol:.3e}")
    agree = float((out.tokens == ref.tokens).mean())
    n_tok = batch * prompt
    enc = ("" if out.encode_ms is None else
           f"encode {cfg.n_audio_frames} frames x{batch} "
           f"{out.encode_ms:.1f}ms (outside the prefill); ")
    print(f"path {path}: batch {batch}, prompt {prompt}, "
          f"{gen} greedy tokens; build (random weights) {build_ms:.0f}ms; "
          f"{enc}prefill {out.prefill_ms:.1f}ms first, "
          f"{warm_prefill_ms:.1f}ms again "
          f"({n_tok / warm_prefill_ms * 1e3:.0f} tokens/s); K6 "
          f"{k6_ms:.1f}ms of it ({k6_ms / warm_prefill_ms:.1%}); decode "
          f"{out.decode_ms_per_token:.2f}ms/token "
          f"({batch / out.decode_ms_per_token * 1e3:.1f} tokens/s); "
          f"launches {launches} (prefill {n_prefill}, decode step "
          f"{n_decode}); peak memory {peak_gb:.2f} GB; vs backend='torch' "
          f"{'(bf16; held in fp32 below) ' if drift else ''}"
          f"(prefill {ref.prefill_ms:.1f}ms, decode "
          f"{ref.decode_ms_per_token:.2f}ms/token): max|diff| {err:.3e} "
          f"({'equal required' if path in LM_EXACT else 'tolerance'} "
          f"{tol:.3e}, max|logit| {float(y_ref.abs().max()):.3e})"
          f", greedy tokens agree {agree:.3f}", flush=True)
    line = graph_line({**graph, "profile_replay": prof_decode,
                       "profile_eager": prof_eager})
    print(f"path {path} decode graph: {line}; "
          f"served: {out.decode_ms_per_token:.2f}ms/token all steps, "
          f"capture {out.capture_ms:.1f}ms, replay "
          f"{out.replay_ms_per_token:.2f}ms/token; its tokens equal "
          f"these {served_tokens_equal}", flush=True)
    for phase, pr, sp in (("prefill", prof_prefill, split["prefill"]),
                          ("decode step (replay)", prof_decode,
                           split["decode_step"]),
                          ("decode step (eager)", prof_eager,
                           split["eager_decode_step"])):
        print(f"path {path} profile, one {phase}: wall "
              f"{pr['wall_ms']:.1f}ms under the profiler, device busy "
              f"{pr['device_busy_ms']:.2f}ms "
              f"({pr['device_busy_ms'] / pr['wall_ms']:.1%}) over "
              f"{pr['n_kernels']} kernels (K6 {sp['k6_ms']:.2f}ms, GEMMs "
              f"{sp['gemm_ms']:.2f}ms, other {sp['other_ms']:.2f}ms); "
              f"longest: " + "; ".join(f"{k} {ms:.2f}ms x{n}"
                                       for k, ms, n in pr["top"]),
              flush=True)
    print(json.dumps({
        "path": path, "arch": arch, "batch": batch, "prompt": prompt,
        "gen": gen, "build_ms": build_ms, "encode_ms": out.encode_ms,
        "prefill_ms": out.prefill_ms, "warm_prefill_ms": warm_prefill_ms,
        "decode_ms_per_token": out.decode_ms_per_token,
        "k6_ms_per_prefill": k6_ms,
        "torch_backend_prefill_ms": ref.prefill_ms,
        "torch_backend_decode_ms_per_token": ref.decode_ms_per_token,
        "launches_per_request": launches, "launches_prefill": n_prefill,
        "launches_decode_step": n_decode, "peak_memory_gb": peak_gb,
        "max_abs_diff_vs_torch": err, "tol": tol,
        "repeat_prefill_max_abs_diff": repeat_diff,
        "greedy_token_agreement": agree, "fp32_held": drift,
        "routing_prefill": routing, "routing_flips_vs_torch": flips,
        "decode_route": out.decode_route,
        "decode_capture_ms": out.capture_ms,
        "decode_replay_ms_per_token": out.replay_ms_per_token,
        "graph_check": {k: v for k, v in graph.items() if k != "tokens"},
        "served_tokens_equal_graph_check": served_tokens_equal,
        "profile_split": split,
        "profile_prefill": prof_prefill, "profile_decode_step": prof_decode,
        "profile_eager_decode_step": prof_eager}),
        flush=True)
    return dict(launches=launches)


def fp32_held(path: str, cfg, params, prompts: torch.Tensor,
              y: torch.Tensor | None, y_ref: torch.Tensor | None,
              n_layers: int | None = None) -> dict:
    """The hopper-vs-torch check of an LM path whose bf16 logits drift
    from its fp32 ones by more than ``LM_TOL``: the same tree cast to
    fp32, prefilled once per backend (hopper: K6's fp32 body at the
    path's shapes, the same launches) within ``LM_TOL * max|logit|`` of
    each other; and the bf16 hopper logits ``y`` no farther from the fp32
    ones than the bf16 torch logits ``y_ref`` are, plus that tolerance.
    With ``n_layers`` all of it runs on the tree's first ``n_layers``
    layers (whole groups, views of the stacked leaves), whose bf16 logits
    are prefilled here too (``y`` and ``y_ref`` are then None)."""
    import dataclasses

    from repro_torch.kernels import common
    from repro_torch.models.layers import _tree_map
    from repro_torch.train import steps

    _, batch, prompt, gen = LM_PATHS[path]
    want = PATHS[path].get("flash_attention", 0)
    if n_layers is not None:
        groups = n_layers // len(params["layers"])
        params = {**params, "layers": [_tree_map(lambda t: t[:groups], slot)
                                       for slot in params["layers"]]}
        want = want * n_layers // cfg.n_layers
        cfg = dataclasses.replace(cfg, n_layers=n_layers)

    def prefilled(cfg, params, backend):
        prefill, _ = steps.make_serve_steps(cfg, backend=backend)
        cache = steps.init_cache(cfg, batch, prompt + gen, "cuda")
        common.reset_launches()
        logits, _ = prefill(params, prompts, cache)
        torch.cuda.synchronize()
        if common.LAUNCHES["flash_attention"] != (
                want if backend == "hopper" else 0):
            raise AssertionError(f"{path} ({cfg.dtype}, {backend}): K6 "
                                 f"launched "
                                 f"{common.LAUNCHES['flash_attention']} "
                                 f"times in a prefill, expected {want}")
        return logits.float()

    if n_layers is not None:
        y, y_ref = (prefilled(cfg, params, b) for b in ("hopper", "torch"))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(lambda t: t.float(), params)
    out = {b: prefilled(cfg32, p32, b) for b in ("hopper", "torch")}
    del p32
    torch.cuda.empty_cache()
    h32, t32 = out["hopper"], out["torch"]
    tol = LM_TOL * float(t32.abs().max())
    r = dict(n_layers=cfg.n_layers,
             fp32_max_abs_diff=float((h32 - t32).abs().max()), tol=tol,
             fp32_max_logit=float(t32.abs().max()),
             bf16_hopper_drift=float((y - t32).abs().max()),
             bf16_torch_drift=float((y_ref - t32).abs().max()),
             bf16_max_abs_diff=float((y - y_ref).abs().max()))
    print(f"path {path} ({cfg.n_layers} layers): bf16 hopper vs torch "
          f"max|diff| {r['bf16_max_abs_diff']:.3e}; in fp32 (the same tree) "
          f"hopper vs torch {r['fp32_max_abs_diff']:.3e} (tolerance "
          f"{tol:.3e}); "
          f"bf16 drift from the fp32 torch logits: hopper "
          f"{r['bf16_hopper_drift']:.3e}, torch {r['bf16_torch_drift']:.3e}",
          flush=True)
    if not r["fp32_max_abs_diff"] <= tol:
        raise AssertionError(f"{path}: fp32 hopper vs torch prefill logits "
                             f"max|diff| {r['fp32_max_abs_diff']:.3e} > "
                             f"{tol:.3e}")
    if not r["bf16_hopper_drift"] <= r["bf16_torch_drift"] + tol:
        raise AssertionError(f"{path}: bf16 hopper drifts "
                             f"{r['bf16_hopper_drift']:.3e} from the fp32 "
                             f"logits, torch {r['bf16_torch_drift']:.3e}")
    return r


def families_vs_cpu(card: str) -> None:
    """The five families besides the dense one, reduced and in fp32,
    served on the card (hopper: K6 at the 2048-token prompts of zamba2,
    the VLM and scout) and on the CPU (K6's plain version) from the same
    tree: prefill logits within ``1e-4 * max(1, max|logit|)``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.layers import _tree_map
    from repro_torch.train import steps

    for arch, prompt in (("mamba2-130m", 100), ("zamba2-7b", 2048),
                         ("whisper-base", 32),
                         ("llama-3.2-vision-11b", 2048),
                         ("llama4-scout-17b-16e", 2048),
                         ("llama4-maverick-400b-a17b", 32)):
        cfg = get_config(arch).reduced()
        params = steps.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        if cfg.family == "vlm":
            open_gates(params)
        kw = dict(reduced=True, batch=2, prompt_len=prompt, gen=4, seed=0,
                  backend="hopper")
        on_card = serve(arch, device="cuda", params=_tree_map(
            lambda t: t.cuda(), params), **kw)
        on_cpu = serve(arch, device="cpu", params=params, **kw)
        y, y_ref = on_card.prefill_logits.cpu(), on_cpu.prefill_logits
        err = float((y - y_ref).abs().max())
        tol = 1e-4 * max(1.0, float(y_ref.abs().max()))
        if not err <= tol:
            raise AssertionError(f"{arch} (reduced, fp32): card vs CPU "
                                 f"prefill logits max|diff| {err:.3e} > "
                                 f"{tol:.3e}")
        agree = float((on_card.tokens == on_cpu.tokens).mean())
        print(f"{arch} (reduced, fp32, prompt {prompt}) on {card} vs the "
              f"CPU: max|diff| {err:.3e} (tolerance {tol:.3e}); greedy "
              f"tokens agree {agree:.3f}", flush=True)


# phase 6: training through repro_torch.launch.train. (a) reduced
# minitron-8b at the reference CLI's defaults (20 steps, batch 8, seq 64, a
# checkpoint every 10), resumed from step 10, and three steps held to the
# CPU; (b) the reduced config in bf16, its state checkpointed and restored;
# (c) full-width minitron-8b cut to 4 of its 32 layers, batch 2 x 4096
# (train_4k's sequence; its global batch of 256 cut to 2); (d) the other
# five families reduced in fp32, three steps on the card held to the CPU;
# (e) llama4-scout at full width cut to 1 of its 48 layers (8.5 GB of bf16
# params, 34 GB of AdamW state) and all 24 layers of mamba2-130m, batch 2 x
# 4096, four steps each. The step is captured (``steps.TrainStep``): (c)
# and (e) run its eager ``.fn`` and then the captured step from the same
# seed and batches, held within CAPTURED_TOL relative at every step; (d)
# holds three captured steps to three ``.fn`` steps from copies of the
# same parameters and state
TRAIN_ARCH = "minitron-8b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_EVERY = 20, 8, 64, 10
TRAIN_TOL = 1e-4
# a full-width bf16 step's loss and grad norm, captured against eager
CAPTURED_TOL = 1e-3
FULL_LAYERS, FULL_BATCH, FULL_SEQ, FULL_STEPS = 4, 2, 4096, 6
TRAIN_FAMILIES = ("llama4-scout-17b-16e", "mamba2-130m", "zamba2-7b",
                  "whisper-base", "llama-3.2-vision-11b")
# (arch, layers kept) at full width, FAMILY_STEPS steps each
FULL_FAMILIES = (("llama4-scout-17b-16e", 1), ("mamba2-130m", 24))
FAMILY_STEPS = 4
# kernel names of the GEMMs (cuBLAS and CUTLASS bodies) in a profile
GEMM_NAMES = re.compile(r"gemm|xmma|cutlass|nvjet|wgmma", re.I)


def _rel_gap(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def train_reduced(root: Path, card: str) -> dict:
    """Phase 6a: ``launch.train.train(device="cuda")`` at the reference
    CLI's defaults, then 10 steps and a resumed run to 20 (the same
    schedule horizon), held to the uninterrupted losses; three steps from
    parameters carried to the CPU, held to the card's."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              ckpt_every=TRAIN_EVERY, device="cuda", log_every=TRAIN_STEPS)
    t0 = time.perf_counter()
    full = train_mod.train(TRAIN_ARCH, ckpt_dir=str(root / "a"), **kw)
    t_full = (time.perf_counter() - t0) * 1e3
    half = train_mod.train(TRAIN_ARCH, ckpt_dir=str(root / "b"),
                           **{**kw, "steps": TRAIN_EVERY},
                           total_steps=TRAIN_STEPS)
    rest = train_mod.train(TRAIN_ARCH, ckpt_dir=str(root / "b"), **kw)
    if not (np.isfinite(full).all() and len(full) == TRAIN_STEPS
            and full[-1] < full[0]):
        raise AssertionError(f"reduced training: losses {full}")
    resume_gap = _rel_gap(rest, full[TRAIN_EVERY:])
    first_gap = _rel_gap(half, full[:TRAIN_EVERY])
    if len(rest) != TRAIN_STEPS - TRAIN_EVERY or not max(
            resume_gap, first_gap) <= TRAIN_TOL:
        raise AssertionError(f"resumed training: gap {resume_gap:.3e} "
                             f"(first half {first_gap:.3e}) > {TRAIN_TOL}")

    cfg = get_config(TRAIN_ARCH).reduced()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    params, state, step_fn, _ = train_mod.build(cfg, opt,
                                                make_host_mesh("cuda"))
    cpu = pytree.tree_map(lambda t: t.cpu(), params)
    cpu_state, cpu_step = adamw.init(cpu), steps.make_train_step(cfg, opt)
    data = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    card_losses, cpu_losses = [], []
    for i in range(3):
        b = batch_for_step(data, i)
        params, state, m = step_fn(params, state, b)
        card_losses.append(float(m["loss"]))
        cpu, cpu_state, m = cpu_step(cpu, cpu_state, b)
        cpu_losses.append(float(m["loss"]))
    cpu_gap = _rel_gap(card_losses, cpu_losses)
    if not cpu_gap <= TRAIN_TOL:
        raise AssertionError(f"card vs CPU losses {card_losses} vs "
                             f"{cpu_losses}: gap {cpu_gap:.3e}")
    print(f"train (a) ({card}): reduced {TRAIN_ARCH} fp32, {TRAIN_STEPS} "
          f"steps of {TRAIN_BATCH} x {TRAIN_SEQ} in {t_full:.0f}ms "
          f"(checkpoints every {TRAIN_EVERY}): loss {full[0]:.4f} -> "
          f"{full[-1]:.4f}; resumed from step {TRAIN_EVERY}: largest "
          f"relative gap to the uninterrupted losses {resume_gap:.3e} "
          f"(steps 0-9 {first_gap:.3e}); three steps on the card (step "
          f"{step_fn.route}, {step_fn.trace_count} capture) vs the CPU from "
          f"the same parameters: gap {cpu_gap:.3e}", flush=True)
    if (step_fn.route, step_fn.trace_count) != ("captured", 1):
        raise AssertionError(f"reduced training: route {step_fn.route!r}, "
                             f"{step_fn.trace_count} captures")
    return dict(reduced_ms=t_full, losses=full, resume_gap=resume_gap,
                first_half_gap=first_gap, cpu_gap=cpu_gap)


def train_bf16_checkpoint(root: Path, card: str) -> dict:
    """Phase 6b: the reduced config in bf16, two train steps on the card,
    its (params, AdamW state) saved blocking and async and restored onto
    ``cuda:0``: every leaf ``torch.equal``."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                              dtype="bfloat16")
    params = steps.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    state = adamw.init(params)
    step = steps.make_train_step(cfg, adamw.AdamWConfig())
    for i in range(2):
        params, state, m = step(params, state, batch_for_step(
            DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), i))
    tree = (params, state)
    out = {}
    for mode in ("blocking", "async"):
        d = root / f"bf16_{mode}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = ckpt.save(str(d), 2, tree, blocking=mode == "blocking")
        call_ms = (time.perf_counter() - t0) * 1e3
        if t is not None:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("async checkpoint writer did not end")
        done_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got, _ = ckpt.restore(str(d), tree, device="cuda:0")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        for (path, x), y in zip(pytree.tree_flatten_with_path(got)[0],
                                pytree.tree_leaves(tree)):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                raise AssertionError(f"bf16 checkpoint ({mode}): leaf "
                                     f"{path} differs")
        out[mode] = dict(call_ms=call_ms, done_ms=done_ms,
                         restore_ms=restore_ms, bytes=sum(
                             f.stat().st_size for f in d.rglob("*")
                             if f.is_file()))
    blk, asy = out["blocking"], out["async"]
    print(f"train (b) ({card}): reduced {TRAIN_ARCH} in bf16, 2 steps; "
          f"params, m and v ({blk['bytes']} bytes on disk) saved blocking "
          f"in {blk['done_ms']:.1f}ms, async call {asy['call_ms']:.1f}ms "
          f"(written after {asy['done_ms']:.1f}ms); restored onto cuda:0 "
          f"in {blk['restore_ms']:.1f} / {asy['restore_ms']:.1f}ms, every "
          f"leaf torch.equal", flush=True)
    return out


class _Marks:
    """CUDA events around one function's calls, forward and backward, on
    the current stream: ``wrap(fn)`` records events around each call and,
    through identity autograd nodes on its tensor inputs and output, when
    its backward starts (its output's gradient arrives) and ends (the last
    input's gradient is ready). Its device time is the events' sum."""

    def __init__(self):
        self.pairs = []

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wrap(self, fn):
        marks = self

        class Mark(torch.autograd.Function):
            @staticmethod
            def forward(ctx, slot, end, x):
                ctx.slot, ctx.end = slot, end
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                ctx.slot[1 if ctx.end else 0] = marks._event()
                return None, None, g

        def wrapped(*args, **kwargs):
            slot = [None, None]
            marks.pairs.append(slot)
            args = [Mark.apply(slot, True, a)
                    if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args]
            start = self._event()
            out = fn(*args, **kwargs)
            self.pairs.append([start, self._event()])
            if isinstance(out, torch.Tensor) and out.requires_grad:
                out = Mark.apply(slot, False, out)
            return out
        return wrapped

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs
                   if a is not None and b is not None)


class _GradSpy:
    """Stands in for ``adamw.update`` and keeps a clone of the gradients
    each call receives. Called inside a capture, the clone is one more
    kernel of the graph, so its tensors hold each replay's gradients once
    that replay has run: ``last()`` gives the eager call's clone when the
    step ran eagerly since ``reset()``, else the graph's."""

    def __init__(self):
        from repro_torch.optim import adamw
        self.update = adamw.update
        self.eager = self.captured = None

    def reset(self) -> None:
        self.eager = None

    def __call__(self, cfg, grads, state, params):
        from torch.utils import _pytree as pytree
        got = [t.clone() for t in pytree.tree_leaves(grads)]
        if torch.cuda.is_current_stream_capturing():
            self.captured = got
        else:
            self.eager = got
        return self.update(cfg, grads, state, params)

    def last(self) -> list:
        got = self.eager if self.eager is not None else self.captured
        return [t.clone() for t in got]


def captured_vs_fn(step_fn, opt, params, state, batches: list) -> dict:
    """Phase 6d's hold of a captured train step: ``len(batches)`` steps
    through ``step_fn`` (the first warms up and captures, the rest
    replay) from ``params`` and ``state``, and twice through its eager
    ``.fn`` from copies of them. Where the two eager runs are bit
    identical, the captured run must equal them (``torch.equal``: every
    parameter, state leaf and metric at every step); else each step is
    held by ``adamw.step_gaps`` to the eager one, with phase 7d's limits
    (gradients TP_STEP_GRAD_TOL of a leaf's max|g|, parameters
    MESH_PARAM_TOL, nothing unmoved; loss and grad norm MESH_TOL)."""
    from unittest import mock

    from torch.utils import _pytree as pytree

    from repro_torch.optim import adamw

    clone = lambda t: pytree.tree_map(lambda x: x.clone(), t)  # noqa: E731
    runs = {}
    spy = _GradSpy()
    starts = {"eager": clone((params, state)), "again": clone((params,
                                                               state))}
    with mock.patch.object(adamw, "update", spy):
        for name, run in (("eager", step_fn.fn), ("again", step_fn.fn),
                          ("captured", step_fn)):
            p, s = starts[name] if name in starts else (params, state)
            out = []
            for b in batches:
                before = clone(p)
                spy.reset()
                p, s, m = run(p, s, b)
                out.append(dict(before=before, grads=spy.last(),
                                after=clone((p, s)),
                                metrics={k: v.clone() for k, v in m.items()}))
            runs[name] = out
    leaves = lambda r: pytree.tree_leaves(  # noqa: E731
        (r["after"], r["metrics"]))
    same = lambda a, b: all(  # noqa: E731
        torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    bitwise = all(map(same, runs["eager"], runs["again"]))
    gaps = []
    for i, (c, e) in enumerate(zip(runs["captured"], runs["eager"])):
        if bitwise:
            if not same(c, e):
                raise AssertionError(f"captured step {i} differs from the "
                                     f"bit-identical eager steps")
            continue
        for k in ("loss", "grad_norm"):
            a, r = float(c["metrics"][k]), float(e["metrics"][k])
            if not abs(a - r) <= MESH_TOL * max(1.0, abs(r)):
                raise AssertionError(f"captured step {i}: {k} {a} vs {r}")
        gap = adamw.step_gaps(opt, e["before"], c["grads"],
                              c["after"][0], e["grads"], e["after"][0])
        if not (gap["grad"] <= TP_STEP_GRAD_TOL
                and gap["param"] <= MESH_PARAM_TOL and gap["unmoved"] == 0):
            raise AssertionError(f"captured step {i}: {gap} (limits "
                                 f"{TP_STEP_GRAD_TOL}, {MESH_PARAM_TOL}, 0)")
        gaps.append(gap)
    return dict(bitwise=bitwise, gaps=gaps,
                losses=[float(r["metrics"]["loss"])
                        for r in runs["captured"]],
                eager_losses=[float(r["metrics"]["loss"])
                              for r in runs["eager"]])


def train_families(card: str) -> dict:
    """Phase 6d: each family besides the dense one, reduced and in fp32,
    built on the card by ``launch.train.build`` (a VLM's cross gates set
    to ``VISION_GATE``), its params copied to the CPU, and three steps of
    the same batches (``batch_for_step`` and the stub frontends' inputs
    from ``launch.train.extras_for``) on both: losses within TRAIN_TOL.
    The card's three steps are captured (one capture; AdamW's ``step``
    reads 3 after them) and held to ``.fn``'s (:func:`captured_vs_fn`)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch).reduced()
        opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                total_steps=TRAIN_STEPS)
        params, state, step_fn, _ = train_mod.build(cfg, opt,
                                                    make_host_mesh("cuda"))
        if cfg.family == "vlm":
            open_gates(params)
        cpu = pytree.tree_map(lambda t: t.cpu(), params)
        cpu_state, cpu_step = adamw.init(cpu), steps.make_train_step(cfg, opt)
        data = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
        batches = []
        for i in range(3):
            b = batch_for_step(data, i)
            b.update(train_mod.extras_for(cfg, TRAIN_BATCH,
                                          np.random.default_rng(i)))
            batches.append(b)
        held = captured_vs_fn(step_fn, opt, params, state, batches)
        card_losses, cpu_losses = held["losses"], []
        for b in batches:
            cpu, cpu_state, m = cpu_step(cpu, cpu_state, b)
            cpu_losses.append(float(m["loss"]))
        gap = _rel_gap(card_losses, cpu_losses)
        if not (np.isfinite(card_losses).all() and gap <= TRAIN_TOL):
            raise AssertionError(f"{arch} (reduced, fp32): card losses "
                                 f"{card_losses} vs CPU {cpu_losses}: gap "
                                 f"{gap:.3e}")
        if (step_fn.route, step_fn.trace_count, int(state["step"])) != (
                "captured", 1, 3):
            raise AssertionError(f"{arch}: route {step_fn.route!r}, "
                                 f"{step_fn.trace_count} captures, AdamW "
                                 f"step {int(state['step'])} after 3 calls")
        how = ("two eager runs bit-identical, captured torch.equal to them"
               if held["bitwise"] else
               "two eager runs not bit-identical; captured held by "
               "step_gaps: gradients "
               f"{max(g['grad'] for g in held['gaps']):.2e}, parameters "
               f"{max(g['param'] for g in held['gaps']):.2e}, unmoved "
               f"{sum(g['unmoved'] for g in held['gaps'])}")
        print(f"train (d) ({card}): reduced {arch} fp32, three steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {card_losses} on the "
              f"card, largest relative gap to the CPU's {gap:.3e}; step "
              f"{step_fn.route}, trace_count {step_fn.trace_count}, AdamW "
              f"step {int(state['step'])}, against .fn: {how}",
              flush=True)
        out[arch] = dict(losses=card_losses, cpu_losses=cpu_losses, gap=gap,
                         eager_losses=held["eager_losses"],
                         bitwise=held["bitwise"], step_gaps=held["gaps"],
                         trace_count=step_fn.trace_count,
                         capture_ms=step_fn.last_capture_ms)
    return out


def _profile_split(prof) -> dict:
    """Device ms of a profiled window: every kernel's, the GEMMs', and the
    ten longest kernels [name, ms, count]."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return dict(busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                gemm_ms=sum(e.self_device_time_total for e in kernels
                            if GEMM_NAMES.search(e.key)) / 1e3,
                top=[[e.key[:80], e.self_device_time_total / 1e3, e.count]
                     for e in top])


def train_full_width(card: str, arch: str = TRAIN_ARCH,
                     n_layers: int = FULL_LAYERS, n_steps: int = FULL_STEPS,
                     label: str = "c") -> dict:
    """Phase 6c (and 6e): ``arch`` at full width cut to ``n_layers``
    layers (every width whole, bf16, remat) through ``launch.train.build``,
    twice from the same seed and batches (``batch_for_step``, FULL_BATCH x
    FULL_SEQ): ``n_steps`` steps of the step's eager ``.fn`` and one more
    under ``torch.profiler`` with the scan attention, the loss and the
    AdamW update timed by CUDA events; then ``n_steps`` steps of the
    captured step (the first warms up and captures, the rest replay) and
    one more replay under the profiler. The captured losses and grad norms
    lie within CAPTURED_TOL relative of the eager ones at every step; one
    capture, AdamW's ``step`` equal to the calls."""
    import dataclasses
    import math

    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=n_steps)
    data = DataConfig(cfg.vocab_size, FULL_SEQ, FULL_BATCH)
    tokens = FULL_BATCH * FULL_SEQ
    ln_v = math.log(cfg.vocab_size)
    runs = {}
    for how in ("eager", "captured"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, step_fn, _ = train_mod.build(cfg, opt,
                                                    make_host_mesh("cuda"))
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        n_params = sum(p.numel() for p in pytree.tree_leaves(params))
        run = step_fn if how == "captured" else step_fn.fn
        ms, losses, norms = [], [], []
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = run(params, state, batch_for_step(data, i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()
                and abs(losses[0] - ln_v) < 1.0):
            raise AssertionError(f"full-width training ({how}): losses "
                                 f"{losses}, grad norms {norms} (ln V = "
                                 f"{ln_v:.3f})")

        # one more step under the profiler; the eager one's parts timed by
        # CUDA events (a replay runs no Python to mark)
        marks = {k: _Marks() for k in ("scan", "loss", "adamw")}
        scan, ce, upd = layers._flash_attention_scan, steps.cross_entropy, \
            adamw.update
        if how == "eager":
            layers._flash_attention_scan = marks["scan"].wrap(scan)
            steps.cross_entropy = marks["loss"].wrap(ce)
            adamw.update = marks["adamw"].wrap(upd)
        try:
            b = batch_for_step(data, n_steps)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, state, m = run(params, state, b)
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            layers._flash_attention_scan, steps.cross_entropy = scan, ce
            adamw.update = upd
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        split = _profile_split(prof)
        runs[how] = dict(
            build_ms=build_ms, step_ms=ms, median_step_ms=statistics.median(
                ms[1:]), peak_allocated_gb=peak_gb,
            peak_reserved_gb=reserved_gb, losses=losses, grad_norms=norms,
            profiled_wall_ms=prof_wall_ms, device_busy_ms=split["busy_ms"],
            gemm_ms=split["gemm_ms"], top=split["top"],
            trace_count=step_fn.trace_count,
            capture_ms=step_fn.last_capture_ms, route=step_fn.route,
            adamw_step=int(state["step"]))
        if how == "eager":
            runs[how].update({f"{k}_ms": v.ms() for k, v in marks.items()})
        del params, state, step_fn, run, m

    eager, cap = runs["eager"], runs["captured"]
    loss_gap, norm_gap = (_rel_gap(cap[k], eager[k])
                          for k in ("losses", "grad_norms"))
    if not max(loss_gap, norm_gap) <= CAPTURED_TOL:
        raise AssertionError(f"{arch}: captured losses {cap['losses']} and "
                             f"grad norms {cap['grad_norms']} against eager "
                             f"{eager['losses']}, {eager['grad_norms']}: "
                             f"gaps {loss_gap:.3e}, {norm_gap:.3e} > "
                             f"{CAPTURED_TOL}")
    if (cap["route"], cap["trace_count"], cap["adamw_step"]) != (
            "captured", 1, n_steps + 1):
        raise AssertionError(f"{arch}: route {cap['route']!r}, "
                             f"{cap['trace_count']} captures, AdamW step "
                             f"{cap['adamw_step']} after {n_steps + 1} calls")
    step_ms = eager["median_step_ms"]
    out = dict(arch=arch, n_layers=n_layers, batch=FULL_BATCH,
               seq=FULL_SEQ, n_params=n_params, build_ms=eager["build_ms"],
               step_ms=eager["step_ms"], median_step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3,
               peak_allocated_gb=eager["peak_allocated_gb"],
               losses=eager["losses"], grad_norms=eager["grad_norms"],
               profiled_wall_ms=eager["profiled_wall_ms"],
               device_busy_ms=eager["device_busy_ms"],
               gemm_ms=eager["gemm_ms"],
               scan_attention_ms=eager["scan_ms"], loss_ms=eager["loss_ms"],
               adamw_ms=eager["adamw_ms"], top=eager["top"],
               captured=cap, loss_gap=loss_gap, grad_norm_gap=norm_gap)
    rnd = lambda xs: [round(t, 1) for t in xs]  # noqa: E731
    print(f"train ({label}) ({card}): {arch} at full width, {n_layers} "
          f"of {full.n_layers} layers ({n_params / 1e9:.3f} G parameters, "
          f"bf16, remat), batch {FULL_BATCH} x {FULL_SEQ}, eager .fn: "
          f"{step_ms:.1f}ms/step (median of steps 2-{n_steps}; all "
          f"{rnd(eager['step_ms'])}), {out['tokens_per_s']:.0f} tokens/s, "
          f"peak allocated {eager['peak_allocated_gb']:.2f} GB, reserved "
          f"{eager['peak_reserved_gb']:.2f} GB; loss {eager['losses'][0]:.4f}"
          f" (ln V {ln_v:.4f}) -> {eager['losses'][-1]:.4f}, grad norm "
          f"{eager['grad_norms'][0]:.3f} -> {eager['grad_norms'][-1]:.3f}; "
          f"build {eager['build_ms']:.0f}ms", flush=True)
    print(f"train ({label}) profile ({card}), {arch}, one eager step: wall "
          f"{eager['profiled_wall_ms']:.1f}ms under the profiler, device "
          f"busy {eager['device_busy_ms']:.1f}ms "
          f"({eager['device_busy_ms'] / eager['profiled_wall_ms']:.1%}); "
          f"GEMM kernels {eager['gemm_ms']:.1f}ms (the scan's products "
          f"included); by CUDA events: scan attention (forward, remat "
          f"recompute, backward) {eager['scan_ms']:.1f}ms, loss (forward, "
          f"backward) {eager['loss_ms']:.1f}ms, AdamW update "
          f"{eager['adamw_ms']:.1f}ms; longest kernels: "
          + "; ".join(f"{k} {t:.2f}ms x{n}" for k, t, n in eager["top"]),
          flush=True)
    print(f"train ({label}) captured ({card}): {arch}, {n_layers} layers, "
          f"the same seed and batches through the captured step (route "
          f"{cap['route']}, {cap['trace_count']} capture, AdamW step "
          f"{cap['adamw_step']} after {n_steps + 1} calls): "
          f"{cap['median_step_ms']:.1f}ms/step (median of the replays, "
          f"steps 2-{n_steps}; all {rnd(cap['step_ms'])}; the first: the "
          f"warm-up step and the capture), "
          f"{tokens / cap['median_step_ms'] * 1e3:.0f} tokens/s, capture "
          f"{cap['capture_ms']:.1f}ms of host time; peak allocated "
          f"{cap['peak_allocated_gb']:.2f} GB, reserved "
          f"{cap['peak_reserved_gb']:.2f} GB (eager "
          f"{eager['peak_allocated_gb']:.2f}, "
          f"{eager['peak_reserved_gb']:.2f}); losses captured "
          f"{cap['losses']} / eager {eager['losses']}, grad norms captured "
          f"{cap['grad_norms']} / eager {eager['grad_norms']}: largest "
          f"relative gaps {loss_gap:.3e} and {norm_gap:.3e} (limit "
          f"{CAPTURED_TOL})", flush=True)
    print(f"train ({label}) replay profile ({card}), {arch}, one replay: "
          f"wall {cap['profiled_wall_ms']:.1f}ms under the profiler, device "
          f"busy {cap['device_busy_ms']:.1f}ms "
          f"({cap['device_busy_ms'] / cap['profiled_wall_ms']:.1%}), of "
          f"the timed replay {cap['device_busy_ms'] / cap['median_step_ms']:.1%}"
          f"; GEMM kernels {cap['gemm_ms']:.1f}ms; longest kernels: "
          + "; ".join(f"{k} {t:.2f}ms x{n}" for k, t, n in cap["top"]),
          flush=True)
    return out


def train_phase(card: str) -> dict:
    """Phase 6: training (a)-(e); no hand-written kernel lies on the
    training path, so the launch counts must not move."""
    from repro_torch.kernels import common

    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "train"
    shutil.rmtree(root, ignore_errors=True)
    before = dict(common.LAUNCHES)
    t0 = time.perf_counter()
    out = {"reduced": train_reduced(root, card),
           "bf16_checkpoint": train_bf16_checkpoint(root, card)}
    shutil.rmtree(root, ignore_errors=True)
    out["full_width"] = train_full_width(card)
    torch.cuda.empty_cache()
    out["families"] = train_families(card)
    out["full_width_families"] = {}
    for arch, n_layers in FULL_FAMILIES:
        torch.cuda.empty_cache()
        out["full_width_families"][arch] = train_full_width(
            card, arch, n_layers, FAMILY_STEPS, label="e")
    if common.LAUNCHES != before:
        raise AssertionError(f"training launched hand-written kernels: "
                             f"{common.LAUNCHES} (before {before})")
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": "train", "card": card, **out}), flush=True)
    return out


# phase 7: the launch tools and training over a mesh. (a) minitron-8b bf16
# prefills at full width on hopper over a cache of ROOF_PROMPT + ROOF_GEN
# positions (phase 2's K6 case), ROOF_TIMED timed after a warm-up, then one
# counted; the full-width training step of phase 6c (FULL_LAYERS layers),
# ROOF_STEPS timed steps then one counted; (b) one dry-run cell in a
# process of its own; (c) MESH_POSITIONS data positions of the repeated card
ROOF_ARCH, ROOF_BATCH, ROOF_PROMPT, ROOF_GEN = "minitron-8b", 2, 4096, 16
ROOF_TIMED, ROOF_STEPS = 3, 4
# traced split along model: minitron-8b x train_4k takes minutes to trace on
# a CPU (16 positions' ops), whisper-base x decode_32k seconds
DRYRUN_CELL = ("whisper-base", "decode_32k", False)
MESH_POSITIONS, MESH_TOL, MESH_PARAM_TOL = 2, 1e-5, 1e-4
# (d) a split step's gradient leaves against the one-position step's,
# each relative to its own max|g| (adamw.step_gaps): a leaf that sums
# many terms that cancel reads up to 4.5e-5 here (mamba2's conv_b), the
# dense families 1.5e-6
TP_STEP_GRAD_TOL = 1e-4
# (d) tensor parallelism: model positions of the full-width runs, the
# reduced meshes, and the reduced serve's batch, prompt and decode steps
TP_POSITIONS = 2
TP_MESHES = ((1, 2), (2, 2))
TP_BATCH, TP_PROMPT, TP_DECODE = 4, 64, 4
# the reduced archs split over TP_MESHES, one of each family, with the
# layers kept (None: the reduced config's; zamba2 at 5: two groups of two
# mamba layers and the shared block, and a tail of one)
TP_REDUCED = {ROOF_ARCH: None, "llama4-scout-17b-16e": None,
              "llama4-maverick-400b-a17b": None, "llama-3.2-vision-11b": None,
              "mamba2-130m": None, "zamba2-7b": 5, "whisper-base": None}
# phase 5's MoE and VLM paths split over (1, TP_POSITIONS) at full width,
# with the layers kept (None: all): scout's tree and its placed copy must
# fit one card together (a layer is about 4.4 GB, the embedding and head
# 4.1: 4 layers are 21.8 GB, twice that 44 GB; 8 would be 79 GB)
TP_FAMILY_PATHS = {"llama4_scout_bf16": 4, "llama32_vision_bf16": None}
# phase 5's SSM, hybrid and audio paths split over (1, TP_POSITIONS) at
# full width, none cut (zamba2: 13.6 GB of bf16 parameters, twice that
# with the placed copy)
TP_SSM_PATHS = ("zamba2_7b_bf16", "mamba2_130m_bf16", "whisper_base_bf16")
# the paths whose bf16 split logits drift from the unsplit ones past
# LM_TOL (zamba2 by 1.14 of a max|logit| of 4.5, mamba2-130m by 0.33 of
# 4.2: the split's partial out_proj products, each rounded to bf16, and
# the narrower GEMMs' own accumulation orders move the block outputs a
# bf16 step, which the mamba layers at random weights grow, PERF.md §6),
# with the layers their hold runs on (zamba2: two groups of six and the
# tail of three; None: all): there the split is held to the unsplit run
# in fp32 within TP_FP32_TOL * max|logit|, and in bf16 the split logits
# no farther from the unsplit fp32 ones than the unsplit bf16 logits are,
# plus TP_DRIFT_SLACK * max|logit|; the full-depth bf16 gap is reported.
# The slack is set from the readings on an H100 80GB HBM3 at 700 W
# (PERF.md §6): the split drifted 0.0386 farther than the unsplit on
# zamba2's 15 layers (0.88 % of 4.382) and 0.0124 less on mamba2 (of
# 4.231)
TP_DRIFT = {"zamba2_7b_bf16": 15, "mamba2_130m_bf16": None}
TP_FP32_TOL, TP_DRIFT_SLACK = 1e-4, 2e-2
# the production mesh's TP_WIDE model positions on the repeated card, where
# the heads split unevenly or not at all: phase 5's whisper path (8 heads:
# every even position holds none) and scout cut to 2 of 48 layers (40
# heads over 8 KV heads: 2 or 3 a position over one KV head), bf16 on
# hopper against the same tree unsplit; and the reduced configs of both in
# fp32, as the TP_REDUCED archs over TP_MESHES
TP_WIDE = 16
TP_WIDE_FAMILY_PATHS = {"llama4_scout_bf16": 2}
TP_WIDE_SSM_PATHS = ("whisper_base_bf16",)
TP_WIDE_REDUCED = ("llama4-scout-17b-16e", "whisper-base")
# query heads that straddle KV groups: internlm2-20b's 48 over 8 heads on
# TP_STRADDLE model positions (8 a position, over two KV groups of 6, K and
# V indexed to one KV head per query head), at full width cut to 2 of 48
# layers (as the scout path split over TP_WIDE), bf16 on hopper, 2 x 4096, 16
# greedy tokens, against the same tree unsplit; and reduced in fp32 with
# the same head counts, as the TP_REDUCED archs
TP_STRADDLE = 6
TP_STRADDLE_PATHS = {"internlm2_20b_bf16": 2}
TP_STRADDLE_REDUCED = {"internlm2-20b": dict(n_heads=48, n_kv_heads=8)}
# phase 5's paths and the straddling one, which phase 7d alone serves
SPLIT_PATHS = {**LM_PATHS,
               "internlm2_20b_bf16": ("internlm2-20b", 2, 4096, 16)}


def start_dryrun_cell(root: Path) -> subprocess.Popen:
    """Phase 7b's cell through ``dryrun.run_cell`` in a process of its own
    (fake tensors on the CPU device type, no card visible), started first
    so it traces while the card runs 7a and 7c."""
    code = ("import json, sys\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            f"rec = run_cell(*{DRYRUN_CELL!r}, out_dir=sys.argv[1])\n"
            "print('RECORD ' + json.dumps(rec, default=float))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    return subprocess.Popen([sys.executable, "-c", code, str(root)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def roofline_line(label: str, card: str, ms: float, st, cfg, kind: str,
                  tokens: int) -> dict:
    """Phase 7a's line for one measured run and its counted twin: the
    roofline terms, the counted FLOPs and the model-FLOPs share of the
    card's peak at the run's dtype, which must lie in (0, 1]."""
    from repro_torch.launch import roofline as rl
    roof = rl.roofline_from_stats(st, 1, cfg.torch_dtype)
    model = rl.model_flops(cfg, kind, tokens)
    mfu = model / (ms * 1e-3 * rl.peak_flops(cfg.torch_dtype))
    out = dict(measured_ms=ms, compute_s=roof.compute_s,
               memory_s=roof.memory_s, collective_s=roof.collective_s,
               bound=roof.bound, step_time_s=roof.step_time_s,
               flops=st.flops, bytes=st.bytes_accessed, model_flops=model,
               mfu=mfu, counted_flops_share=st.flops / (
                   ms * 1e-3 * rl.peak_flops(cfg.torch_dtype)),
               kernels=st.kernels)
    print(f"roofline (7a) ({card}): {label}: measured {ms:.1f}ms; counted "
          f"{st.flops:.4g} FLOPs, {st.bytes_accessed:.4g} bytes (eager, "
          f"unfused) -> compute {roof.compute_s * 1e3:.1f}ms, memory "
          f"{roof.memory_s * 1e3:.1f}ms, bound {roof.bound}; model FLOPs "
          f"{model:.4g}, mfu {mfu:.3f} (counted FLOPs "
          f"{out['counted_flops_share']:.3f} of the peak)", flush=True)
    if not 0.0 < mfu <= 1.0:
        raise AssertionError(f"{label}: model-FLOPs share {mfu} outside "
                             f"(0, 1]: the count or the time is wrong")
    return out


def roofline_prefill(card: str, k6_case: dict) -> dict:
    """Phase 7a on the prefill (module doc); ``k6_case`` is phase 2's
    result for the prefill's K6 shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch import roofline as rl
    from repro_torch.train import steps

    cfg = get_config(ROOF_ARCH)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = steps.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prefill, _ = steps.make_serve_steps(cfg, backend="hopper")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ROOF_BATCH, ROOF_PROMPT)).astype(np.int32)
    ).to(dev)
    cache = steps.init_cache(cfg, ROOF_BATCH, ROOF_PROMPT + ROOF_GEN, dev)
    common.reset_launches()
    prefill(params, tokens, cache)
    times = []
    for _ in range(ROOF_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, tokens, cache)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    (logits, _), st = rl.count(prefill, params, tokens, cache)
    launches = dict(common.LAUNCHES)
    runs = ROOF_TIMED + 2
    want = dict.fromkeys(common.KERNELS, 0)
    want["flash_attention"] = runs * cfg.n_layers
    if launches != want:
        raise AssertionError(f"7a prefill launches {launches}, expected "
                             f"{want}")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("7a prefill: logits not finite")
    k6 = st.kernels.get("flash_attention")
    n = cfg.n_layers
    if k6 != {"launches": n, "flops": n * k6_case["ops"],
              "bytes": n * k6_case["bytes"]}:
        raise AssertionError(f"7a: K6's declared work {k6} differs from "
                             f"{n} x phase 2's ({k6_case['ops']}, "
                             f"{k6_case['bytes']})")
    out = roofline_line(
        f"{ROOF_ARCH} bf16 prefill on hopper, {ROOF_BATCH} x {ROOF_PROMPT} "
        f"(times {[round(t, 1) for t in times]}; K6 {n} a prefill at "
        f"{k6_case['ops']:.4g} FLOPs, {k6_case['bytes']:.4g} bytes each, "
        f"as phase 2)", card, statistics.median(times), st, cfg, "prefill",
        ROOF_BATCH * ROOF_PROMPT)
    out["launches"] = launches
    return out


def _timed_steps(step, params, state, data, n: int):
    from repro_torch.data.pipeline import batch_for_step
    ms, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch_for_step(data, i))
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    return (params, state, statistics.median(ms[1:]), ms,
            torch.cuda.max_memory_allocated() / 1e9)


def _loss_peak_gb(params, cfg, batch) -> float:
    """The peak device memory of one ``loss_and_grads`` (the forward, the
    loss over the logits and the backward, no optimizer), above what was
    allocated before it."""
    from repro_torch.train import steps

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = steps.loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    del loss, grads
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def roofline_train(card: str) -> dict:
    """Phase 7a on the full-width training step (phase 6c's cut), then
    7c's split: the same parameters over MESH_POSITIONS data positions of
    the repeated card, the same batches."""
    import dataclasses

    from repro_torch.compat import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config(ROOF_ARCH), n_layers=FULL_LAYERS)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dev = torch.device("cuda", torch.cuda.current_device())
    data = DataConfig(cfg.vocab_size, FULL_SEQ, FULL_BATCH)
    torch.cuda.empty_cache()
    params, state, step, _ = train_mod.build(
        cfg, opt, make_mesh((1, 1), ("data", "model"), devices=[dev]))
    # the eager runs first: once captured, the step's graph keeps its
    # temporaries' pool, beside which an eager step does not fit
    fb_gb = _loss_peak_gb(params, cfg, batch_for_step(data, 0))
    (params, state, _), st = rl.count(step, params, state,
                                      batch_for_step(data, ROOF_STEPS))
    params, state, ms, all_ms, peak = _timed_steps(step, params, state, data,
                                                   ROOF_STEPS)
    out = {"train": roofline_line(
        f"{ROOF_ARCH} training step, {FULL_LAYERS} of 32 layers, bf16, "
        f"{FULL_BATCH} x {FULL_SEQ} (median of steps 2-{ROOF_STEPS}: "
        f"{[round(t, 1) for t in all_ms]})", card, ms, st, cfg, "train",
        FULL_BATCH * FULL_SEQ)}
    out["train"].update(peak_gb=peak, route=step.route,
                        trace_count=step.trace_count)
    print(f"roofline (7a) ({card}): the counted step ran the step's "
          f"eager .fn (before the timed steps); the timed steps ran "
          f"{step.route} ({step.trace_count} capture; the first step warms "
          f"up and captures, the median reads the replays)", flush=True)
    del state, step
    torch.cuda.empty_cache()
    mesh = make_mesh((MESH_POSITIONS, 1), ("data", "model"),
                     devices=[dev] * MESH_POSITIONS)
    _, state, step, _ = train_mod.build(cfg, opt, mesh, params=params)
    _, _, split_ms, split_all, split_peak = _timed_steps(
        step, params, state, data, ROOF_STEPS)
    out["split"] = dict(ms=split_ms, all_ms=split_all, peak_gb=split_peak,
                        unsplit_ms=ms, unsplit_peak_gb=peak,
                        route=step.route, trace_count=step.trace_count)
    print(f"mesh (7c) ({card}): the {FULL_LAYERS}-layer step with its "
          f"batch split over {MESH_POSITIONS} data positions of the repeated "
          f"card, {step.route} ({step.trace_count} capture): "
          f"{split_ms:.1f}ms/step (median of steps 2-{ROOF_STEPS}: "
          f"{[round(t, 1) for t in split_all]}), peak {split_peak:.2f} GB; "
          f"unsplit {ms:.1f}ms/step, peak {peak:.2f} GB (one card: the "
          f"split, the reduction and the bookkeeping, not scaling)",
          flush=True)
    del state, step
    torch.cuda.empty_cache()
    # 7d: the same parameters split along model over TP_POSITIONS
    # positions of the repeated card (build places a copy)
    mesh = make_mesh((1, TP_POSITIONS), ("data", "model"),
                     devices=[dev] * TP_POSITIONS)
    placed, state, step, _ = train_mod.build(cfg, opt, mesh, params=params)
    del params
    torch.cuda.empty_cache()
    tp_fb_gb = _loss_peak_gb(placed, cfg, batch_for_step(data, 0))
    placed, _, tp_ms, tp_all, tp_peak = _timed_steps(step, placed, state,
                                                     data, ROOF_STEPS)
    out["tp_split"] = dict(ms=tp_ms, all_ms=tp_all, peak_gb=tp_peak,
                           loss_and_grads_gb=tp_fb_gb, unsplit_ms=ms,
                           unsplit_peak_gb=peak,
                           unsplit_loss_and_grads_gb=fb_gb,
                           route=step.route, trace_count=step.trace_count)
    print(f"tensor parallel (7d) ({card}): the {FULL_LAYERS}-layer step "
          f"split along model over {TP_POSITIONS} positions of the "
          f"repeated card, {step.route} ({step.trace_count} capture): "
          f"{tp_ms:.1f}ms/step (median of steps "
          f"2-{ROOF_STEPS}: {[round(t, 1) for t in tp_all]}), peak "
          f"{tp_peak:.2f} GB; unsplit {ms:.1f}ms/step, peak {peak:.2f} GB "
          f"(one card: the split and its collectives, not scaling or "
          f"memory relief); forward and backward alone (loss_and_grads, "
          f"no AdamW) peak {tp_fb_gb:.2f} GB above what was resident, "
          f"unsplit {fb_gb:.2f} GB", flush=True)
    return out


def mesh_reduced(card: str) -> dict:
    """Phase 7c on reduced minitron-8b in fp32: two steps over
    MESH_POSITIONS data positions of the repeated card against the
    one-position step from the same parameters."""
    from torch.utils import _pytree as pytree

    from repro_torch.compat import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw

    cfg = get_config(ROOF_ARCH).reduced()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    dev = torch.device("cuda", torch.cuda.current_device())
    p1, s1, f1, _ = train_mod.build(
        cfg, opt, make_mesh((1, 1), ("data", "model"), devices=[dev]))
    p2, s2, f2, _ = train_mod.build(
        cfg, opt, make_mesh((MESH_POSITIONS, 1), ("data", "model"),
                            devices=[dev] * MESH_POSITIONS),
        params=pytree.tree_map(lambda t: t.clone(), p1))
    data = DataConfig(cfg.vocab_size, 64, 8)
    gaps = []
    for i in range(2):
        b = batch_for_step(data, i)
        p1, s1, m1 = f1(p1, s1, b)
        p2, s2, m2 = f2(p2, s2, b)
        for k in ("loss", "grad_norm"):
            a, r = float(m2[k]), float(m1[k])
            if not abs(a - r) <= MESH_TOL * max(1.0, abs(r)):
                raise AssertionError(f"7c step {i}: {k} {a} vs {r}")
        gap = max(float((a - r).abs().max()) / max(1.0, float(
            r.abs().max())) for a, r in zip(pytree.tree_leaves(p2),
                                            pytree.tree_leaves(p1)))
        if not gap <= MESH_PARAM_TOL:
            raise AssertionError(f"7c step {i}: parameters {gap:.3e} apart")
        gaps.append(gap)
    if (f1.route, f2.route, f1.trace_count, f2.trace_count) != (
            "captured", "captured", 1, 1):
        raise AssertionError(f"7c: routes {f1.route!r}, {f2.route!r}, "
                             f"captures {f1.trace_count}, {f2.trace_count}")
    print(f"mesh (7c) ({card}): reduced {ROOF_ARCH} fp32 over "
          f"{MESH_POSITIONS} data positions of the repeated card vs one "
          f"position, both steps {f2.route} (one capture each; the second "
          f"step replays), two steps of 8 x 64: losses "
          f"{float(m2['loss']):.6f} / {float(m1['loss']):.6f}, parameter "
          f"gaps {gaps}", flush=True)
    return dict(gaps=gaps, loss=float(m2["loss"]), ref_loss=float(m1["loss"]))


def _gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max|a - ref| over max(1, max|ref|)."""
    return float((a.float() - ref.float()).abs().max()) / max(
        1.0, float(ref.float().abs().max()))


def tp_reduced(card: str) -> dict:
    """Phase 7d on the reduced TP_REDUCED archs in fp32 (random weights, a
    VLM's cross-attention gates opened, its image embeddings and whisper's
    frames drawn from seed 1, whisper's encoded over each tree): split
    along model over each of TP_MESHES (the repeated card), a prefill and
    TP_DECODE decode steps (teacher-forced with the unsplit run's greedy
    tokens) against the unsplit card run, an MoE model's prefill routing
    token for token equal to the unsplit run's, and one training step
    against the one-position step from the same parameters: loss and
    ``grad_norm`` within MESH_TOL, and by ``adamw.step_gaps`` each
    gradient leaf AdamW receives within TP_STEP_GRAD_TOL of its own
    max|g|, the
    parameters within MESH_PARAM_TOL wherever the gradient is well above
    AdamW's eps, and every element the one-position step moved moved."""
    import dataclasses
    from unittest import mock

    from torch.utils import _pytree as pytree

    from repro_torch.compat import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.models import whisper
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train import steps

    dev = torch.device("cuda", torch.cuda.current_device())
    one = make_mesh((1, 1), ("data", "model"), devices=[dev])
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    seen, update = [], adamw.update

    def spy(cfg, grads, state, params):
        # the step's first call runs it eagerly, then captures it: the
        # capture's gradients are never computed
        if not torch.cuda.is_current_stream_capturing():
            seen.append(pytree.tree_leaves(sharding.gather(pytree.tree_map(
                lambda t: t.clone(), grads))))
        return update(cfg, grads, state, params)

    cases = [(arch, {} if n is None else dict(n_layers=n), TP_MESHES + (
        ((1, TP_WIDE),) if arch in TP_WIDE_REDUCED else ()))
        for arch, n in TP_REDUCED.items()]
    cases += [(arch, changes, ((1, TP_STRADDLE),))
              for arch, changes in TP_STRADDLE_REDUCED.items()]
    out = {}
    for arch, changes, meshes in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        params = steps.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        if cfg.family == "vlm":
            open_gates(params)
        inputs = {k: v.to(dev) for k, v in train_mod.extras_for(
            cfg, TP_BATCH, np.random.default_rng(1)).items()}
        prefill, decode = steps.make_serve_steps(cfg)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (TP_BATCH, TP_PROMPT), dtype=np.int32)).to(dev)

        def serve_run(p, rules, toks=None):
            with sharding.use_rules(rules):
                cache = steps.init_cache(cfg, TP_BATCH,
                                         TP_PROMPT + TP_DECODE, dev)
            extras = dict(inputs)
            if "frames" in extras:
                with torch.no_grad():
                    extras = {"enc_out": whisper.encode(
                        p, extras["frames"], cfg)}
            routed = Routing()
            with routed:
                logits, cache = prefill(p, prompts, cache, extras)
            got, toks = [logits], toks or []
            for i in range(TP_DECODE):
                if len(toks) <= i:
                    toks.append(logits.argmax(-1)[:, None])
                logits, cache = decode(p, toks[i], cache, TP_PROMPT + i,
                                       extras)
                got.append(logits)
            return got, toks, routed

        ref, toks, ref_routed = serve_run(params, sharding.make_rules(one))
        batch = batch_for_step(DataConfig(cfg.vocab_size, 64, 8), 0)
        batch.update(train_mod.extras_for(cfg, 8, np.random.default_rng(2)))
        with mock.patch.object(adamw, "update", spy):
            p1, s1, f1, _ = train_mod.build(
                cfg, opt, one, params=pytree.tree_map(lambda t: t.clone(),
                                                      params))
            p1, s1, m1 = f1(p1, s1, batch)
        g1 = seen.pop()
        name = arch if "n_heads" not in changes else (
            f"{arch} ({cfg.n_heads} over {cfg.n_kv_heads} heads)")
        out[name] = {}
        for shape in meshes:
            mesh = make_mesh(shape, ("data", "model"),
                             devices=[dev] * int(np.prod(shape)))
            rules = sharding.make_rules(mesh)
            placed = steps.place(cfg, params, rules)
            got, _, routed = serve_run(placed, rules, toks)
            gaps = [_gap(a, r) for a, r in zip(got, ref)]
            if not max(gaps) <= MESH_TOL:
                raise AssertionError(f"7d {arch} {shape}: split serving "
                                     f"{gaps} > {MESH_TOL} of the unsplit "
                                     f"run")
            flips = routed.flips(ref_routed, rows=shape[0])
            if flips:
                raise AssertionError(f"7d {arch} {shape}: {flips} tokens "
                                     f"routed apart from the unsplit run")
            with mock.patch.object(adamw, "update", spy):
                p2, s2, f2, _ = train_mod.build(cfg, opt, mesh,
                                                params=params)
                p2, s2, m2 = f2(p2, s2, batch)
            for k in ("loss", "grad_norm"):
                a, r = float(m2[k]), float(m1[k])
                if not abs(a - r) <= MESH_TOL * max(1.0, abs(r)):
                    raise AssertionError(f"7d {arch} {shape} step: {k} {a} "
                                         f"vs {r}")
            step = adamw.step_gaps(opt, params, seen.pop(),
                                   sharding.gather(p2), g1, p1)
            ggap, pgap = step["grad"], step["param"]
            if not (ggap <= TP_STEP_GRAD_TOL and pgap <= MESH_PARAM_TOL
                    and step["unmoved"] == 0):
                raise AssertionError(f"7d {arch} {shape} step: {step} "
                                     f"(limits {TP_STEP_GRAD_TOL}, "
                                     f"{MESH_PARAM_TOL}, 0)")
            out[name][str(shape)] = dict(
                serve_gaps=gaps, grad_gap=ggap, param_gap=pgap,
                unmoved=step["unmoved"], loss=float(m2["loss"]),
                ref_loss=float(m1["loss"]),
                grad_norm=float(m2["grad_norm"]),
                ref_grad_norm=float(m1["grad_norm"]),
                routed_calls=len(ref_routed.calls))
            moe = (f"prefill routing of {len(ref_routed.calls)} MoE layers "
                   f"equal token for token; " if routed.calls else "")
            print(f"tensor parallel (7d) ({card}): reduced {arch} fp32 "
                  f"({cfg.n_layers} layers, {cfg.n_heads} query heads over "
                  f"{cfg.n_kv_heads} KV heads) split over {shape} of the "
                  f"repeated card: prefill and "
                  f"{TP_DECODE} decode steps within {max(gaps):.2e} of the "
                  f"unsplit run (relative to max(1, max|logit|)); {moe}one "
                  f"step: loss {float(m2['loss']):.6f} / "
                  f"{float(m1['loss']):.6f}, grad_norm "
                  f"{float(m2['grad_norm']):.6f} / "
                  f"{float(m1['grad_norm']):.6f}, gradients {ggap:.2e} "
                  f"apart (of each leaf's max|g|), parameters {pgap:.2e} "
                  f"apart where |g| > {adamw.NEAR_EPS:.0e} eps, every "
                  f"moved element moved; the split step {f2.route} (its "
                  f"first call, eager, then captured)",
                  flush=True)
            del placed, p2, s2
        del params, p1, s1
        torch.cuda.empty_cache()
    return out


def tp_full_width(card: str) -> dict:
    """Phase 7d at full width: minitron-8b bf16 on hopper, ROOF_BATCH x
    ROOF_PROMPT, all 32 layers, ROOF_GEN greedy tokens, unsplit and then
    split over TP_POSITIONS positions of the repeated card (placed from
    the unsplit tree, which is then freed); each a warm-up prefill,
    ROOF_TIMED timed prefills and ROOF_GEN timed decode steps. Then once
    through ``launch.serve.serve`` over the same mesh. Returns its
    numbers and the split runs' kernel launches."""
    from unittest import mock

    from repro_torch.compat import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    from repro_torch.parallel import sharding
    from repro_torch.train import steps

    cfg = get_config(ROOF_ARCH)
    dev = torch.device("cuda", torch.cuda.current_device())
    prefill, decode = steps.make_serve_steps(cfg, backend="hopper")
    # the prompts launch.serve.serve draws from seed 0
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ROOF_BATCH, ROOF_PROMPT), dtype=np.int32)
    ).to(dev)

    def run(p, rules) -> dict:
        torch.cuda.reset_peak_memory_stats()
        with sharding.use_rules(rules):
            cache = steps.init_cache(cfg, ROOF_BATCH, ROOF_PROMPT + ROOF_GEN,
                                     dev)
        common.reset_launches()
        prefill(p, tokens, cache)
        times = []
        for _ in range(ROOF_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(p, tokens, cache)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        k6 = common.LAUNCHES["flash_attention"] / (ROOF_TIMED + 1)
        first = logits
        graph = captured_vs_eager(f"7d {ROOF_ARCH} over {rules.mesh!r}",
                                  decode, p, first, cache, ROOF_PROMPT,
                                  ROOF_GEN)
        launches = dict(common.LAUNCHES)
        if launches["flash_attention"] != k6 * (ROOF_TIMED + 1):
            raise AssertionError(f"7d: decode launched K6 ({launches})")
        if not bool(torch.isfinite(first.float()).all()):
            raise AssertionError("7d: prefill logits not finite")
        for name in ("profile_replay", "profile_eager"):
            graph[name].pop("by_kernel")
        graph.pop("tokens")
        return dict(prefill_ms=statistics.median(times), times=times,
                    decode_ms=graph["replay_ms"], k6_per_prefill=k6,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    logits=first, launches=launches, graph=graph)

    one = sharding.make_rules(make_mesh((1, 1), ("data", "model"),
                                        devices=[dev]))
    mesh = make_mesh((1, TP_POSITIONS), ("data", "model"),
                     devices=[dev] * TP_POSITIONS)
    rules = sharding.make_rules(mesh)
    params = steps.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    whole = run(params, one)
    placed = steps.place(cfg, params, rules)
    del params
    torch.cuda.empty_cache()
    split = run(placed, rules)
    del placed
    torch.cuda.empty_cache()
    want_k6 = TP_POSITIONS * cfg.n_layers
    if (whole["k6_per_prefill"], split["k6_per_prefill"]) != (
            cfg.n_layers, want_k6):
        raise AssertionError(f"7d: K6 {whole['k6_per_prefill']} / "
                             f"{split['k6_per_prefill']} a prefill, "
                             f"expected {cfg.n_layers} / {want_k6}")
    ref = whole.pop("logits")
    lim = LM_TOL * float(ref.float().abs().max())
    err = float((split.pop("logits").float() - ref.float()).abs().max())
    if not err <= lim:
        raise AssertionError(f"7d: split prefill logits {err} > {lim}")
    common.reset_launches()
    # one card's host mesh is (1, 1): the repeated card's (1, 2) stands in
    # for a host of two cards
    with mock.patch.object(serve_mod, "make_host_mesh",
                           lambda device_type: mesh):
        served = serve_mod.serve(ROOF_ARCH, reduced=False, batch=ROOF_BATCH,
                                 prompt_len=ROOF_PROMPT, gen=ROOF_GEN,
                                 backend="hopper")
    serve_launches = dict(common.LAUNCHES)
    serve_err = float((served.prefill_logits.float() - ref.float()).abs()
                      .max())
    if serve_launches["flash_attention"] != want_k6 or not serve_err <= lim:
        raise AssertionError(f"7d serve: K6 {serve_launches}, logits "
                             f"{serve_err} (limit {lim})")
    del served
    torch.cuda.empty_cache()
    print(f"tensor parallel (7d) ({card}): {ROOF_ARCH} bf16 on hopper, "
          f"{ROOF_BATCH} x {ROOF_PROMPT}, {cfg.n_layers} layers, split over "
          f"{TP_POSITIONS} positions of the repeated card: prefill "
          f"{split['prefill_ms']:.1f}ms (times "
          f"{[round(t, 1) for t in split['times']]}; K6 "
          f"{split['k6_per_prefill']:.0f} a prefill), decode (replays) "
          f"{split['decode_ms']:.2f}ms/token, peak {split['peak_gb']:.2f} "
          f"GB; unsplit prefill {whole['prefill_ms']:.1f}ms (K6 "
          f"{whole['k6_per_prefill']:.0f}), decode "
          f"{whole['decode_ms']:.2f}ms/token, peak {whole['peak_gb']:.2f} "
          f"GB; split vs unsplit prefill logits max|diff| {err:.4f} "
          f"(limit {lim:.4f}); through launch.serve.serve over that mesh "
          f"(first prefill, cold): {serve_err:.4f}", flush=True)
    graph_lines(f"{ROOF_ARCH} over (1, {TP_POSITIONS})", split, whole)
    launches = split.pop("launches")
    for name, n in serve_launches.items():
        launches[name] += n
    whole.pop("launches")
    return dict(split=split, unsplit=whole, logits_err=err, limit=lim,
                serve_err=serve_err, launches=launches)


def graph_lines(label: str, split: dict, whole: dict) -> None:
    """7d's captured-vs-eager lines of a split run and its unsplit run."""
    for name, r in (("split", split), ("unsplit", whole)):
        print(f"tensor parallel (7d) {label}, {name}: "
              f"{graph_line(r['graph'])}", flush=True)


def full_width_run(path: str, cfg, p, rules) -> dict:
    """One side of phase 7d's full-width split-against-unsplit runs of
    ``path`` (bf16 on hopper, LM_PATHS' batch, prompt and greedy tokens):
    ``p`` over ``rules``' mesh, its inputs drawn from seed 0 as
    ``launch.serve.serve`` draws them (whisper's frames encoded over
    ``p``, outside the timings); a prefill whose MoE routing is recorded,
    ROOF_TIMED timed prefills and the decode steps, captured and held to
    their eager step (:func:`captured_vs_eager`). Returns the median
    prefill ms and its times, the replays' ms/token, K6 per prefill,
    encode ms, peak GB, the first prefill's logits, the launches, the
    routing and the captured-vs-eager numbers."""
    from repro_torch.kernels import common
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.parallel import sharding
    from repro_torch.train import steps

    _, batch, prompt, gen = SPLIT_PATHS[path]
    dev = rules.mesh.devices.flat[0]
    prefill, decode = steps.make_serve_steps(cfg, backend="hopper")
    torch.cuda.reset_peak_memory_stats()
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, batch, prompt + gen, dev)
    extras, prompts, encode_ms = lm_inputs(
        cfg, p, np.random.default_rng(0), batch, prompt, "hopper", dev)
    tokens = torch.from_numpy(prompts).to(dev)
    common.reset_launches()
    routed = Routing()
    with routed:
        first, cache = prefill(p, tokens, cache, extras)
    times = []
    for _ in range(ROOF_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(p, tokens, cache, extras)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    k6 = common.LAUNCHES["flash_attention"] / (ROOF_TIMED + 1)
    graph = captured_vs_eager(f"7d {path} over {rules.mesh!r}", decode, p,
                              first, cache, prompt, gen, extras)
    ran = dict(common.LAUNCHES)
    if ran["flash_attention"] != k6 * (ROOF_TIMED + 1):
        raise AssertionError(f"7d {path}: decode launched K6 ({ran})")
    if not bool(torch.isfinite(first.float()).all()):
        raise AssertionError(f"7d {path}: prefill logits not finite")
    for name in ("profile_replay", "profile_eager"):
        graph[name].pop("by_kernel")
    graph.pop("tokens")
    return dict(prefill_ms=statistics.median(times), times=times,
                decode_ms=graph["replay_ms"], k6_per_prefill=k6,
                encode_ms=encode_ms,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                logits=first, launches=ran, routed=routed, graph=graph)


def tp_families_full_width(card: str, paths: dict = TP_FAMILY_PATHS,
                           positions: int = TP_POSITIONS) -> dict:
    """Phase 7d on phase 5's MoE and VLM paths at full width (``paths``,
    default TP_FAMILY_PATHS: scout cut to 4 of 48 layers, all 40 of the
    VLM's with 1600 image tokens and its gates opened): bf16 on hopper, 2
    x 4096, 16 greedy tokens, unsplit and then split over ``positions``
    positions of the repeated card from the same tree (both held: the
    split run's peak holds the unsplit tree too); each a prefill whose
    routing is recorded, ROOF_TIMED timed prefills and the decode steps.
    K6 per prefill: each position's heads, ``positions`` times the
    unsplit count (every position holds heads). The split prefill's
    logits within ``LM_TOL * max|logit|`` of the unsplit ones. For
    scout, each MoE layer's tokens per expert and drops, split beside
    unsplit, and the tokens routed apart (an attention output one
    bf16 step apart can tip a near tie of the router); then the
    first MoE layer held on the unsplit run's own input: every position's
    router, assembled from the shards, equal to the unsplit one bit for
    bit (so it routes every token as unsplit), and the positions' partial
    outputs, summed, within ``LM_TOL * max|out|`` of the unsplit layer's.
    Returns the numbers and the runs' kernel launches."""
    import dataclasses

    from repro_torch.compat import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import layers, transformer
    from repro_torch.parallel import sharding
    from repro_torch.train import steps

    dev = torch.device("cuda", torch.cuda.current_device())
    one = sharding.make_rules(make_mesh((1, 1), ("data", "model"),
                                        devices=[dev]))
    rules = sharding.make_rules(make_mesh(
        (1, positions), ("data", "model"),
        devices=[dev] * positions))
    out, launches = {}, dict.fromkeys(common.KERNELS, 0)
    for path, n_layers in paths.items():
        arch, batch, prompt, gen = SPLIT_PATHS[path]
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = steps.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        if cfg.family == "vlm":
            open_gates(params)
        whole = full_width_run(path, cfg, params, one)
        placed = steps.place(cfg, params, rules)
        split = full_width_run(path, cfg, placed, rules)
        want_k6 = cfg.n_layers + (cfg.n_layers // cfg.cross_attn_every
                                  if cfg.cross_attn_every else 0)
        if (whole["k6_per_prefill"], split["k6_per_prefill"]) != (
                want_k6, positions * want_k6):
            raise AssertionError(f"7d {path}: K6 {whole['k6_per_prefill']}"
                                 f" / {split['k6_per_prefill']} a prefill, "
                                 f"expected {want_k6} / "
                                 f"{positions * want_k6}")
        ref = whole.pop("logits").float()
        lim = LM_TOL * float(ref.abs().max())
        err = float((split.pop("logits").float() - ref).abs().max())
        if not err <= lim:
            raise AssertionError(f"7d {path}: split prefill logits {err} > "
                                 f"{lim}")
        w_routed, s_routed = whole.pop("routed"), split.pop("routed")
        r = dict(split=split, unsplit=whole, logits_err=err, limit=lim,
                 n_layers=cfg.n_layers)
        if cfg.family == "moe":
            r["routing_unsplit"] = w_routed.layers()
            r["routing_split"] = s_routed.layers()
            r["flips"] = s_routed.flips(w_routed)
            for i, (a, b) in enumerate(zip(r["routing_split"],
                                           r["routing_unsplit"])):
                print(f"tensor parallel (7d) {path} routing, prefill, MoE "
                      f"layer {i}: tokens per expert split {a['experts']}, "
                      f"unsplit {b['experts']} (capacity {a['cap']} a "
                      f"row); dropped {a['dropped']} / {b['dropped']}",
                      flush=True)
            # the first MoE layer on the unsplit run's own input
            p0, x0 = w_routed.first
            want = layers.moe(p0, x0, cfg)
            parts = []
            for i in range(positions):
                slot = next(j for j, lp in enumerate(placed["layers"])
                            if "moe" in lp)
                pi = layers.layer_at(transformer._position_tree(
                    placed, cfg, i)["layers"][slot]["moe"], 0)
                if not torch.equal(pi["router"], p0["router"]):
                    raise AssertionError(f"7d {path}: position {i}'s "
                                         f"router differs from the "
                                         f"unsplit one")
                parts.append(layers.moe(pi, x0, cfg, experts=transformer
                                        ._tp_ranges(cfg, positions, i)
                                        ["experts"]))
            got = sharding.all_reduce_sum(parts)[0]
            r["layer_err"] = float((got.float() - want.float()).abs().max())
            r["layer_limit"] = LM_TOL * float(want.float().abs().max())
            del parts, got, want, p0, x0
            if not r["layer_err"] <= r["layer_limit"]:
                raise AssertionError(f"7d {path}: the split MoE layer on "
                                     f"the unsplit input {r['layer_err']}"
                                     f" > {r['layer_limit']}")
        del placed, params, w_routed, s_routed
        torch.cuda.empty_cache()
        for name, n in split.pop("launches").items():
            launches[name] += n
        whole.pop("launches")
        moe_line = ("" if cfg.family != "moe" else
                    f"; {r['flips']} of {batch * prompt * cfg.n_layers} "
                    f"routed tokens (prefill, all MoE layers) take another "
                    f"expert than unsplit; the first MoE layer on the "
                    f"unsplit input: routers equal bit for bit, output "
                    f"max|diff| {r['layer_err']:.4f} (limit "
                    f"{r['layer_limit']:.4f})")
        print(f"tensor parallel (7d) ({card}): {arch} {cfg.dtype} on hopper, "
              f"{batch} x {prompt}, {cfg.n_layers} layers, split over "
              f"{positions} positions of the repeated card: prefill "
              f"{split['prefill_ms']:.1f}ms (times "
              f"{[round(t, 1) for t in split['times']]}; K6 "
              f"{split['k6_per_prefill']:.0f} a prefill), decode (replays) "
              f"{split['decode_ms']:.2f}ms/token, peak "
              f"{split['peak_gb']:.2f} GB (both trees); unsplit prefill "
              f"{whole['prefill_ms']:.1f}ms (K6 "
              f"{whole['k6_per_prefill']:.0f}), decode "
              f"{whole['decode_ms']:.2f}ms/token, peak "
              f"{whole['peak_gb']:.2f} GB; split vs unsplit prefill logits "
              f"max|diff| {err:.4f} (limit {lim:.4f}){moe_line}",
              flush=True)
        graph_lines(f"{arch} over (1, {positions})", split, whole)
        out[path] = r
    return dict(paths=out, launches=launches)


def drift_hold(path: str, cfg, params, rules, one, launches: dict) -> dict:
    """TP_DRIFT's hold of a split path (see there) on its first
    ``TP_DRIFT[path]`` layers of ``params`` (views; zamba2: whole groups
    and the tail): prefills in bf16 and fp32 (the tree cast), each
    unsplit over ``one`` and split over ``rules``, on hopper (K6 per
    group and position). Adds the kernel launches to ``launches``."""
    import dataclasses

    from repro_torch.kernels import common
    from repro_torch.models.layers import _tree_map
    from repro_torch.parallel import sharding
    from repro_torch.train import steps

    _, batch, prompt, _ = LM_PATHS[path]
    dev = rules.mesh.devices.flat[0]
    n_layers = TP_DRIFT[path] or cfg.n_layers
    cut = params
    groups = 0
    if cfg.shared_attn_every:
        groups = (n_layers - cfg.n_layers % cfg.shared_attn_every) \
            // cfg.shared_attn_every
        cut = dict(params, groups=_tree_map(lambda t: t[:groups],
                                            params["groups"]))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt), dtype=np.int32)).to(dev)
    got, k6 = {}, {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, n_layers=n_layers, dtype=dtype)
        tree = cut if dtype == "bfloat16" else _tree_map(lambda t: t.float(),
                                                         cut)
        prefill, _ = steps.make_serve_steps(c, backend="hopper")
        for name, r in (("unsplit", one), ("split", rules)):
            p = tree if r is one else steps.place(c, tree, rules)
            with sharding.use_rules(r):
                cache = steps.init_cache(c, batch, prompt, dev)
            common.reset_launches()
            logits, _ = prefill(p, tokens, cache)
            got[dtype, name] = logits.float()
            k6[dtype, name] = common.LAUNCHES["flash_attention"]
            for kname, n in common.LAUNCHES.items():
                launches[kname] += n
            del p, cache, logits
        del tree
        torch.cuda.empty_cache()
    want = {"unsplit": groups, "split": TP_POSITIONS * groups}
    if any(n != want[name] for (_, name), n in k6.items()):
        raise AssertionError(f"7d {path} hold: K6 {k6}, expected {want}")
    ref = got["float32", "unsplit"]
    top = float(ref.abs().max())
    r = dict(n_layers=n_layers, k6=f"{groups} / {TP_POSITIONS * groups}",
             fp32_max_logit=top, fp32_limit=TP_FP32_TOL * top,
             fp32_err=float((got["float32", "split"] - ref).abs().max()),
             split_drift=float((got["bfloat16", "split"] - ref).abs().max()),
             unsplit_drift=float((got["bfloat16", "unsplit"] - ref).abs()
                                 .max()),
             bf16_err=float((got["bfloat16", "split"]
                             - got["bfloat16", "unsplit"]).abs().max()),
             drift_slack=TP_DRIFT_SLACK * top)
    if not r["fp32_err"] <= r["fp32_limit"]:
        raise AssertionError(f"7d {path}: fp32 split prefill on {n_layers} "
                             f"layers {r['fp32_err']:.3e} > "
                             f"{r['fp32_limit']:.3e}")
    if not r["split_drift"] <= r["unsplit_drift"] + r["drift_slack"]:
        raise AssertionError(f"7d {path}: bf16 split drifts "
                             f"{r['split_drift']:.3e} from the fp32 logits, "
                             f"unsplit {r['unsplit_drift']:.3e}")
    return r


def tp_ssm_full_width(card: str, paths: tuple = TP_SSM_PATHS,
                      positions: int = TP_POSITIONS) -> dict:
    """Phase 7d on ``paths`` (default TP_SSM_PATHS) at full width: bf16
    on hopper, phase 5's batch, prompt and greedy tokens (whisper: 8 x
    1500 frames, 32-token prompts, encoded over each tree outside the
    timed prefill), unsplit and then split over ``positions`` positions
    of the repeated card from the same tree (both held); each a prefill,
    ROOF_TIMED timed prefills and the decode steps. K6 per prefill:
    zamba2's shared block on each position's heads, ``positions`` times
    the unsplit 13; mamba2 and whisper none.
    whisper's split prefill logits within ``LM_TOL * max|logit|`` of the
    unsplit ones; TP_DRIFT's paths' gap reported and held by
    :func:`drift_hold`. Then each path once through ``launch.serve.serve``
    over the same mesh (the same seed-0 tree and prompts: its logits are
    the split run's). Returns the numbers and the runs' kernel
    launches."""
    from unittest import mock

    from repro_torch.compat import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    from repro_torch.parallel import sharding
    from repro_torch.train import steps

    dev = torch.device("cuda", torch.cuda.current_device())
    one = sharding.make_rules(make_mesh((1, 1), ("data", "model"),
                                        devices=[dev]))
    mesh = make_mesh((1, positions), ("data", "model"),
                     devices=[dev] * positions)
    rules = sharding.make_rules(mesh)
    out, launches = {}, dict.fromkeys(common.KERNELS, 0)
    for path in paths:
        arch, batch, prompt, gen = LM_PATHS[path]
        cfg = get_config(arch)
        params = steps.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        whole = full_width_run(path, cfg, params, one)
        placed = steps.place(cfg, params, rules)
        split = full_width_run(path, cfg, placed, rules)
        del placed
        torch.cuda.empty_cache()
        want_k6 = (cfg.n_layers // cfg.shared_attn_every
                   if cfg.shared_attn_every else 0)
        if (whole["k6_per_prefill"], split["k6_per_prefill"]) != (
                want_k6, positions * want_k6):
            raise AssertionError(f"7d {path}: K6 {whole['k6_per_prefill']}"
                                 f" / {split['k6_per_prefill']} a prefill, "
                                 f"expected {want_k6} / "
                                 f"{positions * want_k6}")
        ref = whole.pop("logits").float()
        lim = LM_TOL * float(ref.abs().max())
        err = float((split.pop("logits").float() - ref).abs().max())
        held = path not in TP_DRIFT
        if held and not err <= lim:
            raise AssertionError(f"7d {path}: split prefill logits {err} > "
                                 f"{lim}")
        r = dict(split=split, unsplit=whole, logits_err=err, limit=lim,
                 n_layers=cfg.n_layers, held=held)
        for name, n in split.pop("launches").items():
            launches[name] += n
        whole.pop("launches")
        whole.pop("routed"), split.pop("routed")
        drift_line = ""
        if not held:
            r["drift"] = drift_hold(path, cfg, params, rules, one, launches)
            d = r["drift"]
            drift_line = (
                f"; held on {d['n_layers']} layers (K6 {d['k6']}): in fp32 "
                f"split vs unsplit max|diff| {d['fp32_err']:.3e} (limit "
                f"{d['fp32_limit']:.3e}, max|logit| {d['fp32_max_logit']:.3f}"
                f"), bf16 drift from the unsplit fp32 logits: split "
                f"{d['split_drift']:.3e}, unsplit {d['unsplit_drift']:.3e} "
                f"(limit the unsplit's + {d['drift_slack']:.3e}), bf16 "
                f"split vs unsplit {d['bf16_err']:.3e}")
        del params
        torch.cuda.empty_cache()
        common.reset_launches()
        # one card's host mesh is (1, 1): the repeated card's (1, 2)
        # stands in for a host of two cards
        with mock.patch.object(serve_mod, "make_host_mesh",
                               lambda device_type: mesh):
            served = serve_mod.serve(arch, reduced=False, batch=batch,
                                     prompt_len=prompt, gen=gen,
                                     backend="hopper")
        for name, n in common.LAUNCHES.items():
            launches[name] += n
        r["serve_err"] = float((served.prefill_logits.float() - ref).abs()
                               .max())
        if common.LAUNCHES["flash_attention"] != positions * want_k6 or (
                held and not r["serve_err"] <= lim) or not bool(
                    torch.isfinite(served.prefill_logits.float()).all()):
            raise AssertionError(f"7d {path} serve: K6 "
                                 f"{dict(common.LAUNCHES)}, logits "
                                 f"{r['serve_err']} (limit {lim})")
        del served
        torch.cuda.empty_cache()
        gate = (f"limit {lim:.4f}" if held else
                f"not gated at full depth; LM_TOL would be {lim:.4f}")
        enc = ("" if whole["encode_ms"] is None else
               f"encode {split['encode_ms']:.1f} / "
               f"{whole['encode_ms']:.1f}ms (split / unsplit); ")
        print(f"tensor parallel (7d) ({card}): {arch} {cfg.dtype} on hopper, "
              f"{batch} x {prompt}, {cfg.n_layers} layers, split over "
              f"{positions} positions of the repeated card: {enc}prefill "
              f"{split['prefill_ms']:.1f}ms (times "
              f"{[round(t, 1) for t in split['times']]}; K6 "
              f"{split['k6_per_prefill']:.0f} a prefill), decode (replays) "
              f"{split['decode_ms']:.2f}ms/token, peak "
              f"{split['peak_gb']:.2f} GB (both trees); unsplit prefill "
              f"{whole['prefill_ms']:.1f}ms (K6 "
              f"{whole['k6_per_prefill']:.0f}), decode "
              f"{whole['decode_ms']:.2f}ms/token, peak "
              f"{whole['peak_gb']:.2f} GB; split vs unsplit prefill logits "
              f"max|diff| {err:.4f} ({gate}){drift_line}; through "
              f"launch.serve.serve over that mesh: {r['serve_err']:.4f}",
              flush=True)
        graph_lines(f"{arch} over (1, {positions})", split, whole)
        out[path] = r
    return dict(paths=out, launches=launches)


def finish_dryrun_cell(proc: subprocess.Popen, card: str) -> dict:
    """Phase 7b: wait for the cell's process and check its record."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"7b dry-run exited {proc.returncode}:\n"
                             f"{out}\n{err}")
    rec = json.loads(next(line for line in out.splitlines()
                          if line.startswith("RECORD "))[7:])
    if rec["status"] != "OK":
        raise AssertionError(f"7b dry-run cell: {rec}")
    if rec["model_positions"] != 16 or not rec["collective_counts"]:
        raise AssertionError(f"7b dry-run cell not split along model: "
                             f"{rec['model_positions']} positions, "
                             f"{rec['collective_counts']}")
    roof, mem = rec["roofline"], rec["memory"]
    print(f"dry-run (7b) ({card}): {rec['arch']} x {rec['shape']} x "
          f"{rec['mesh']}: "
          f"{rec['status']} in trace_s {rec['trace_s']}s, {rec['n_chips']} "
          f"chips, {rec['dp_positions']} data positions x "
          f"{rec['model_positions']} model positions traced apart; per "
          f"chip (the fullest position, {rec['fullest_position']}): "
          f"{rec['flops_per_chip']:.4g} FLOPs, {rec['bytes_per_chip']:.4g} "
          f"bytes, {rec['collective_bytes_per_chip']:.4g} collective bytes "
          f"{rec['collective_counts']}; per device "
          f"{rec['bytes_per_device_gb']} GB (arguments "
          f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB, temporaries "
          f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB); compute "
          f"{roof['compute_s']:.3f}s, memory {roof['memory_s']:.3f}s, "
          f"collective {roof['collective_s']:.4f}s, bound {roof['bound']}; "
          f"useful FLOPs ratio {rec['useful_flops_ratio']:.3f}", flush=True)
    return rec


def launch_tools_phase(card: str, k6_case: dict) -> dict:
    """Phase 7 (module doc); returns its results and the kernel launches
    of its main-path runs."""
    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dryrun"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    proc = start_dryrun_cell(root)
    try:
        out = {"prefill": roofline_prefill(card, k6_case)}
        torch.cuda.empty_cache()
        out.update(roofline_train(card))
        torch.cuda.empty_cache()
        out["mesh_reduced"] = mesh_reduced(card)
        out["tp_reduced"] = tp_reduced(card)
        torch.cuda.empty_cache()
        out["tp_full_width"] = tp_full_width(card)
        torch.cuda.empty_cache()
        out["tp_families"] = tp_families_full_width(card)
        torch.cuda.empty_cache()
        out["tp_ssm"] = tp_ssm_full_width(card)
        torch.cuda.empty_cache()
        out["tp_wide_families"] = tp_families_full_width(
            card, TP_WIDE_FAMILY_PATHS, TP_WIDE)
        torch.cuda.empty_cache()
        out["tp_wide_ssm"] = tp_ssm_full_width(card, TP_WIDE_SSM_PATHS,
                                               TP_WIDE)
        torch.cuda.empty_cache()
        out["tp_straddle"] = tp_families_full_width(
            card, TP_STRADDLE_PATHS, TP_STRADDLE)
        torch.cuda.empty_cache()
        out["dryrun"] = finish_dryrun_cell(proc, card)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out["launches"] = out["prefill"].pop("launches")
    for part in ("tp_full_width", "tp_families", "tp_ssm",
                 "tp_wide_families", "tp_wide_ssm", "tp_straddle"):
        for name, n in out[part].pop("launches").items():
            out["launches"][name] += n
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": "launch_tools", "card": card, **out},
                     default=float), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.compat import use_strict_fp32
    from repro_torch.kernels import common

    # -- phase 1: card, numerics, build ---------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    use_strict_fp32()
    t0 = time.perf_counter()
    lib_path = common.build_library()
    common.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s -> "
          f"{Path(lib_path).name}", flush=True)
    for line in ptxas_summary(common.BUILD_LOG):
        print(f"ptxas: {line}", flush=True)
    for line in ptxas_warnings(common.BUILD_LOG):
        print(f"nvcc: {line}", flush=True)

    # -- phase 2: every kernel at every main-path shape vs its plain version --
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                             bound_ms=0.0, library_ms=None, bound_by={})
                  for name in common.KERNELS}
    seen: dict[tuple, dict] = {}
    lm_k6_ms = {}     # K6 ms per request of each LM path
    lm_k6_case = None  # phase 2's K6 result at the LM prefill's shape
    fields = ("ms", "plain_ms", "bound_ms", "library_ms")
    for path in [*PATHS, *STRICT_PATHS]:
        if path in LM_PATHS:
            cases = lm_kernel_cases(path)
        else:
            program, dtype, per_block = path_program(path)
            cases = kernel_cases(program, BATCH, dtype, per_block)
            if path == "resnet18_fp32":
                cases += (wino_offpath_cases() + wino_decomposed_cases()
                          + f6_cases())
        counted, per_path = case_launches(cases), {}
        if path in PATHS and counted != PATHS[path]:
            raise AssertionError(f"{path}: program gives launches {counted}, "
                                 f"expected {PATHS[path]}")
        for name, layer, shape, n in cases:
            key = (name, tuple(sorted(shape.items())))
            if key not in seen:
                seen[key] = run_case(name, shape, gen)
                torch.cuda.empty_cache()
            r = seen[key]
            if path == LM_PATH and layer == "prefill":
                lm_k6_case = r
            print(json.dumps({"kernel": name, "path": path, "layer": layer,
                              **shape, **r}), flush=True)
            if name == "flash_attention":
                err = (f"worst element {r['worst_elem_ratio']:.3f} of one "
                       f"bf16 step" if "worst_elem_ratio" in r else
                       f"max|diff| {r['max_abs_err']:.2e}")
                print(f"K6 {path} {layer}: {r['ms']:.3f}ms, "
                      f"{r['useful_tflops']:.1f} TFLOP/s useful, "
                      f"{r['bound_share']:.1%} of its bound "
                      f"({r['bound_ms']:.3f}ms); SDPA {r['library_ms']:.3f}"
                      f"ms, plain {r['plain_ms']:.3f}ms; {err}", flush=True)
            pk = per_path.setdefault(name, dict.fromkeys(fields, 0.0))
            for f in fields:
                pk[f] += n * (r[f] or 0.0)
            agg = per_kernel[name]
            agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
            if path not in PATHS or path in DW_PATHS:
                continue     # the summary's times: the served model paths
            for f in ("ms", "plain_ms", "bound_ms"):
                agg[f] += n * r[f]
            if r["library_ms"] is not None:
                agg["library_ms"] = ((agg["library_ms"] or 0.0)
                                     + n * r["library_ms"])
            agg["bound_by"][r["bound_by"]] = (
                agg["bound_by"].get(r["bound_by"], 0) + n * r["bound_ms"])
        # per-request sums of this path's kernel calls (library_ms 0: none)
        print(json.dumps({"path_kernels": path, **per_path}), flush=True)
        if path in LM_PATHS:
            lm_k6_ms[path] = per_path.get("flash_attention", {}).get("ms", 0.0)
    decomposed_conv_check(card)
    dispatcher_cost(card)
    print(f"phase 2 (kernel checks): {time.perf_counter() - t_start:.1f}s "
          f"since start", flush=True)

    # -- phase 3: the main paths through the user's entry points -------------
    xs = {}           # one batch of images per input shape
    total = dict.fromkeys(common.KERNELS, 0)
    results = {}
    for path in PATHS:
        if path in LM_PATHS:
            continue
        shape = path_specs(path)[1]
        if shape not in xs:
            xs[shape] = torch.from_numpy(np.random.default_rng(1)
                                         .standard_normal((BATCH, *shape))
                                         .astype(np.float32)).cuda()
        # the int8 builds quantize the fp32 build's weights
        fp32 = results.get(path.replace("int8", "fp32"))
        results[path] = serve_path(path, xs[shape],
                                   params=fp32["acc"].params if fp32 else None)
        for name, n in results[path]["launches"].items():
            total[name] += n
        if fp32 is not None:
            y8 = results[path]["y"].argmax(-1)
            agree = float((y8 == fp32["y"].argmax(-1)).float().mean())
            print(f"path {path}: top-1 agreement of the dequantized int8 "
                  f"logits with the fp32 hopper path: {agree:.3f} over "
                  f"{BATCH} images (random weights)", flush=True)
        torch.cuda.empty_cache()
    kernel_ms = sum(a["ms"] for name, a in per_kernel.items()
                    if name != "flash_attention")
    print(f"kernel time per request of each CNN model path, summed over the "
          f"paths "
          f"(phase 2): {kernel_ms:.2f}ms; steady ms/batch: "
          + ", ".join(f"{p} {r['steady_ms']:.2f}" for p, r in results.items()),
          flush=True)

    # -- phase 3b: the four model paths through a ServingSession ------------
    from repro_torch.api import settled_heap
    t_3b = time.perf_counter()
    # the sessions' traffic from a settled heap, as a serving process runs
    # it (one full collection first, then everything alive frozen out of
    # the collector): over an unsettled heap a full collection stops every
    # thread for 83-237 ms inside a window (PERF.md §6)
    with settled_heap():
        for path in SESSION_PATHS:
            r = serve_session_path(path, results[path],
                                   xs[path_specs(path)[1]], card)
            for name, n in r["launches"].items():
                total[name] += n
    session_faults(results["resnet18_fp32"],
                   xs[path_specs("resnet18_fp32")[1]], card)
    session_persistence(results, xs, card)
    session_aot(results, xs, card)
    r = session_segmented(results["vgg16_fp32"],
                          xs[path_specs("vgg16_fp32")[1]], card)
    for name, n in r["launches"].items():
        total[name] += n
    torch.cuda.empty_cache()
    print(f"phase 3b (sessions): {time.perf_counter() - t_3b:.1f}s; "
          f"{time.perf_counter() - t_start:.1f}s since start", flush=True)

    # -- phase 3c: F3's rotation and sharded serving over a mesh ------------
    # -- phase 3d: checkpoint, restore and recovery --------------------------
    t_3c = time.perf_counter()
    for r in (f3_rotation(results["resnet18_fp32"],
                          xs[path_specs("resnet18_fp32")[1]], card),
              sharded_sessions(results, xs, card),
              checkpoint_recovery(results, xs, card)):
        for name, n in r["launches"].items():
            total[name] += n
    torch.cuda.empty_cache()
    print(f"phases 3c-3d (F3, mesh, checkpoint): "
          f"{time.perf_counter() - t_3c:.1f}s; "
          f"{time.perf_counter() - t_start:.1f}s since start", flush=True)

    # -- phase 4: the strict interpreter on every CNN path --------------------
    for path, served in results.items():
        r = interpret_path(path, served, xs[path_specs(path)[1]], card)
        for name, n in r["launches"].items():
            total[name] += n * STEADY_REQUESTS
        served.pop("acc")
        del r
        torch.cuda.empty_cache()
    print(f"phase 4 (interpreter): {time.perf_counter() - t_start:.1f}s "
          f"since start", flush=True)
    del results, xs
    # the cached entries hold their CUDA graphs, whose pools and weights
    # the LM needs the room of
    from repro_torch.core.program_cache import default_cache
    default_cache().clear()
    torch.cuda.empty_cache()

    # -- phase 5: the LM paths through repro_torch.launch.serve --------------
    t_5 = time.perf_counter()
    for path in LM_PATHS:
        lm = serve_lm(path, k6_ms=lm_k6_ms[path])
        for name, n in lm["launches"].items():
            total[name] += n
        del lm
        torch.cuda.empty_cache()
    families_vs_cpu(card)
    torch.cuda.empty_cache()
    print(f"phase 5 (LM): {time.perf_counter() - t_5:.1f}s; "
          f"{time.perf_counter() - t_start:.1f}s since start", flush=True)

    # -- phase 6: training through repro_torch.launch.train -----------------
    train = train_phase(card)
    print(f"phase 6 (train): {train['phase_s']:.1f}s", flush=True)
    del train
    torch.cuda.empty_cache()

    # -- phase 7: roofline, dry-run and training over a mesh -----------------
    tools = launch_tools_phase(card, lm_k6_case)
    for name, n in tools["launches"].items():
        total[name] += n
    print(f"phase 7 (launch tools, mesh training, tensor parallelism): "
          f"{tools['phase_s']:.1f}s",
          flush=True)
    print(f"whole run: {time.perf_counter() - t_start:.1f}s", flush=True)

    summary = []
    for name in common.KERNELS:
        a = per_kernel[name]
        source, replaces = SOURCES[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total[name],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": max(a["bound_by"], key=a["bound_by"].get,
                            default="bytes"),
            "library_ms": a["library_ms"]})
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
