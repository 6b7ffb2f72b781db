#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of JAG (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--n N] [--degree R] [--ls-build L] [--batch-size B]
                          [--cand-pool C] [--f-n N] [--f-sift-n N] [--seed S]
                          [--out report.json] [--profile trace.json]

Phases, in order; any failure ends the script with a non-zero exit and no
result line:

1. Device: CUDA with capability (9, 0); prints nvidia-smi's name and power
   limit.
2. Kernel build: nvcc compiles every kernel of ``src/repro_torch/csrc``
   (one process per source, all at once). ``cuobjdump -sass`` counts the
   tensor-core instructions of the three libraries built on them, which
   must each hold some: ``HGMMA`` (wgmma) in ``flash_attention``, ``l2dist``
   and ``flash_attention_f32``, and ``HMMA`` (mma.sync, its head_dim-256
   kernel) in ``flash_attention_f32``.
3. Kernels against their plain versions, at the shapes the main path gives
   them (slice A's data and its per-query plan, slice C's prefill): max
   errors, kernel time, plain-version time and a one-call PyTorch
   yardstick where there is one. d2 tolerance: |kernel - plain| <= 1e-5 *
   (|x|^2 + |q|^2), the magnitude of the terms the norm form sums (FP32 sum
   order differs); attr words, ids and popcounts are bit-exact. Attention
   in bf16 (the tensor-core kernel): |kernel - plain| <= 2^-7 |plain| +
   1e-5, one bf16 rounding step (both round float32 values that differ in
   the sum order and, for the kernel, by p's split into two bf16 halves,
   about 2^-17 of p); in float32 (split-TF32 tensor cores) 1e-4 |plain|
   + 1e-4. l2dist and flash_attention_f32 compute float32 products as three
   TF32 passes (hi and lo halves of each operand), so their operations
   bound is 3x their flops at the TF32 rate; the FP32 rate's figure is
   logged beside it and kept in the report (``fp32_bound_ms``), not in the
   kernels line, and l2dist's largest error is printed as a share of its
   d2 limit, beside its and the plain version's error against float64
   (max, mean, share toward zero, and the share that moves q.x toward
   zero).
   gather_dist and l2dist have no caller on a path; they are held at slice
   A's graph shapes and at the prefilter scan's and kernels_bench's widths;
   the float32 attention kernel at slice C's shape in float32. Edge shapes:
   bitset_dist with N % 4 != 0 at W = 1 and 33, fused_expand at an odd row
   width (103 words) with ids out of range and NaN-like attr words,
   gather_dist with single-value loads (d = 13, a table one element off 16
   bytes, bf16 rows of 200 bytes), ids out of range and C = 600,000 (above
   the 524,280 that its old grid allowed). fused_expand and gather_dist are
   timed with cold rows (the same COLD_SETS id batches in turn, more rows
   than the L2 holds), as the beam finds them; their warm times are
   printed beside them. bitset_dist's operations bound counts popcounts at
   the card's popcount rate (SMs x 16 a clock x nvidia-smi's
   clocks.max.sm), not at the FP32 rate.
4. Slice A, the main path at MSTuring's published width: msturing_subset
   (d = 100, 30 Bernoulli(1/2) subset attributes, N = 500,000, cut
   from 1,000,000 to keep the script's time),
   ``JAGIndex.build`` on the card (degree 128, ls_build 96, cand_pool
   192, batch 8192: at degree 96 or less the graph route's recall at
   ls = 64 stays under the bar at this N, PERF.md); every row's degree
   must be at least R / 8. Then 1024 queries through
   ``search_auto(k=10, ls=64, layout="fused")``; the req_ks mix (0..12
   required bits) spans the prefilter, graph and postfilter routes. The
   launch count of each of the three kernels of this path in that run must
   be above 0, and the graph-routed queries' recall@10 against the exact
   scan at least 0.80.
5. Slice D, int8 serving and the streaming index over slice A's built
   index (no rebuild). int8: ``search_auto(..., dtype="int8")`` in the
   fused and the default layout; the graph-routed recall@10 against slice
   A's exact scan at least 0.80 in each (printed beside the f32 recall),
   the prefilter ids equal to it, and ``fused_expand`` launched in the
   fused run; ``fused_expand`` on the int8 lanes (codes widened to f32, the
   query folded by the scale) against its plain version at the graph
   group's shapes, timed cold (the ``int8`` record of its kernel report);
   ``quantize_int8`` on 65,536 rows equal on the card and the CPU, bit for
   bit. Streaming: ``StreamingJAGIndex`` over the index (compact_frac 0.25,
   so nothing compacts by itself) takes 10,000 rows (2% of N) in 4 batches
   of 2,500, drawn with their own generator (seed 1): slice A rows at
   random ids plus Gaussian noise of 0.1x the per-dim std, and 30
   Bernoulli(1/2) subset bits. ``search_auto(layout="fused")`` over base +
   delta: prefilter ids equal ``exact_filtered_knn`` over the 510,000
   concatenated rows, graph recall at least 0.80 against it, every
   realized route ends in ``+delta``, the delta scan alone launches
   ``gather_dist_tile`` and ``bitset_dist``, and ``gather_dist_tile`` on
   the delta's padded last block (tile 4096) is bit-exact with its plain
   version. ``compact()`` (timed): 510,000 graph rows, every inserted row
   at least R / 8 edges, the extended f32 layout equal to ``build_layout``
   over the concatenated rows bit for bit; then the same search with the
   delta empty (prefilter exact, graph recall at least 0.80, inserted rows
   among the graph route's ids) and ``search_int8``, whose int8 layout is
   rebuilt over 510,000 rows. QPS per route of each served batch is
   printed beside slice A's; no gate.
6. Slice E, the cost model and serving telemetry over slice A's index (no
   rebuild). Calibration on the card over ``cost.FULL_GRID`` (ns 8000 and
   20000, ds 32 and 64, five selectivities, lss 32, 64, 128, b 64,
   delta_ns 256 and 1024, 3 repeats): every
   observation finite and positive, the model covering all six routes
   under ``us``, its backend ``cuda``, and ``CostRegistry`` round tripping
   it. Every distinct call signature of ``fused_expand``,
   ``gather_dist_tile`` and ``bitset_dist`` the calibration made (its
   grid builds, scans and compactions at d 32 and 64) is kept and held
   against the plain version on the same inputs: fused_expand's d2 within
   the d2 tolerance and its attr words bit for bit, the scan tiles bit for
   bit. Slice A's batch routed by the model (route counts beside the static
   plan's, predicted costs, ``explain``): prefilter-routed ids equal the
   exact scan's, graph-routed and whole-batch recall@10 at least 0.80;
   QPS beside the static plan's in the same process. The static plan's
   batch twice with ``Telemetry(introspect=True, spans=True,
   shadow=0.05)``, each time followed by a run without it (telemetry on,
   off, on, off): one trace per query per call, each matching its plan,
   traced n_expanded equal to the hops of ``TraversalStats``, ids and keys
   equal to the same plan's without telemetry bit for bit, the shadow
   oracle's flush launching ``gather_dist_tile`` with prefilter recall
   1.0, the trace JSONL loading back equal, the health report rendering;
   printed: dead ends per selectivity band, shadow recall, span totals,
   the grid model's held-out error on the traces before and after
   ``maybe_recalibrate``, and QPS with and without telemetry. Then a
   ``StreamingJAGIndex`` over the index with the model takes 20,000
   rows, drawn as slice D draws its own, in 4 inserts with auto-compaction: each insert's
   ``compaction_break_even`` must be finite; the streamed batch's
   prefilter ids equal the exact scan over base + delta and its graph
   recall is at least 0.80; the delta scan + merge ms is printed. The
   streamed batch then runs twice with ``Telemetry(shadow=0.05)`` on the
   streaming index: the flush launches ``gather_dist_tile`` and the
   prefilter's shadow recall is 1.0; the card's memory peak above the
   served state is printed, while serving and through the flush.
7. Slice F, the paper's baselines and sharded serving, on data of their
   own (budget 120 s; ``--f-n``/``--f-sift-n`` set it): msturing_subset
   (N = 100,000, d = 100, 30 bits, 1024 queries with 0 to 12 required
   bits, seed 5) and sift_like (N = 60,000, d = 128, 12 labels, 1024
   queries, seed 6), built at degree 64, ls_build 96, cand_pool 192, batch
   4096 (about six batches a shard): the JAG union index,
   ``build_unfiltered`` (RWalks' diffusion over it: m 5, depth 3, h 0.1),
   ``ShardedJAGIndex`` of 4 shards of 25,000 rows on ``[cuda:0] * 4`` and
   ``StitchedLabelIndex`` over sift_like;
   each build's seconds printed. F1: the batch at k = 10, ls = 64 through
   JAG ``search`` and ``search_auto``, ``post_filter_search``,
   ``binary_search``, ``acorn_search`` and ``rwalks_search`` over the
   unfiltered index (``benchmarks/common.py``'s wiring), the same
   post-filtering over JAG's graph (search_auto's postfilter route), and
   the stitched index on sift_like; per algorithm and required-bits band,
   recall@10 against the card's exact scan, QPS of a second run (the band
   alone, host clock around synchronized work) and mean n_dist. Gates:
   every id returned with primary 0 passes its filter (``matches`` on the
   card); at selectivity 1 post_filter returns the unfiltered traversal's
   ids on the same graph, and post-filtering over JAG's graph reaches
   recall above 0.9 there; at selectivity under 0.02 JAG's graph recall
   exceeds post_filter's by more than 0.15; search_auto's batch recall at
   least 0.80; the stitched index's above 0.9. F2: S = 1
   (``from_shards([jag])``, no copy) equals ``jag.search_auto`` bit for
   bit under the default and force-prefilter planners (vlog width 0 on the
   traversal routes); S = 4 under the force-prefilter planner, per_query
   and batch, equals the union index on every field bit for bit, with the
   sharded path's ``gather_dist_tile`` and ``bitset_dist`` launches
   counted ("sharded") and each distinct call signature held against the
   plain version (``check_recorded``); under the default planner the
   routed bands' recall at least the union's less 0.02; every route call
   makes S packed gathers of B * (3k + 2) * 4 bytes; with
   ``Telemetry(shadow=0.05)`` the prefilter band's shadow recall is 1.0;
   slice E's model routes at the per-shard n = 25,000 (route counts
   printed); ``make_serve_step`` in f32 and int8_reg at query_chunk 128
   and 64, the two chunkings equal bit for bit, the f32 recall equal to
   the sharded graph route's.
8. Slice B, the Boolean call site of the deficit kernel: msturing_bool
   (N = 100,000, 15 variables) through the prefilter scan on the card with
   the kernels, whose ids must equal the same scan's through the plain
   versions.
9. Slice C, dense-LM serving: qwen3-1.7b at its published width and depth
   (28 layers, d_model 2048, 16 heads, 8 kv heads, head_dim 128, vocab
   151,936), random weights from ``--seed`` on the card, matrices kept in
   bf16 for serving. 4 requests of 4,096 prompt tokens (LM_SHAPES
   prefill_32k, batch 32 x 32,768, cut to 4 x 4,096 to fit the time
   limit): one ``prefill`` through the tensor-core flash-attention kernel
   (exactly 28 launches of ``flash_attention``, none of
   ``flash_attention_f32``), then 32 greedy ``decode_step``s. Checks: in
   float32 (the masters, before the cast), the prefill's logits with the
   split-TF32 kernel (exactly 28 launches of ``flash_attention_f32``)
   against the plain attention within 1e-4 of the largest logit (float32
   sum order). In bf16 the two differ by more: an attention output that moves
   by one bf16 step moves every later layer's roundings. The yardstick is
   bf16's own error, e = max |plain bf16 logits - plain float32 logits|:
   each bf16 prefill lies about e from the float32 one, so two of them lie
   up to 2e apart. The kernel's bf16 prefill must stay within 2e of the
   plain bf16 prefill, and the first decode step's logits within 2e of a
   prefill over T + 1 tokens. Printed: the prefill's and a decode step's
   flops and bytes against the card's roofline (``launch.roofline``) and
   the measured time's share of that bound.
10. Slice G, static analysis and launch tooling (budget 60 s):
   ``repro_torch.analysis``'s lint over ``src/repro_torch`` (zero
   unjustified findings, counts per rule printed); its route audit on the
   card at the audit size (256 rows, d 8, 13 single-device routes and the
   4 sharded ones over ``[cuda:0] * 8``), zero violations; and slice A's
   index at full width (no rebuild), each route on slice A's batch group
   (prefilter 568 queries, the graph route's 315 in the fused and the
   default layout, postfilter 141) through ``launch.trace_stats``'s op
   recorder and profiler. The index leaves the card after slice E as it
   did before slice G, kept on the host as its ``_save_arrays()``, and
   comes back for this part with ``JAGIndex.from_arrays``, so slices F,
   B and C run as they did without slice G. Gates: the fused route
   launches ``fused_expand`` once per expansion plus once for the seeds
   and makes no aten N-row data gather, the default layout and
   postfilter 3 N-row gathers per expansion, the prefilter's
   ``gather_dist_tile`` and ``bitset_dist`` launches equal its
   ceil(N / 4096) blocks (147), every route's host syncs within the audit's budget, no f64
   op. Printed per route: host syncs a call, launches and device kernels
   per expansion (or block), device busy share, longest idle gaps; then
   each kernel record's share of its bound.
11. Slice H, the LM training step (budget 60 s): qwen3-1.7b at its
   published width and depth (slice C's config, 1.72B parameters) with
   float32 masters and AdamW state from ``--seed`` on the card (about
   27.5 GB with the gradients), remat "full", ``LM_SHAPES["train_4k"]``
   (batch 256 x 4,096) cut to 4 x 4,096 tokens as accum=2 microbatches of
   2, ``lm_batch(step, 4, 4096, vocab, seed)``, ``OptConfig(warmup_steps=1,
   total_steps=10)``. Attention goes through ``kernels.autograd``'s
   Function: the kernel forward, the plain version's backward. First,
   from the same weights, the first step's loss and grad norm without
   the update in float32 (the split-TF32 kernel forward: exactly 112
   launches of ``flash_attention_f32``) and with the plain bf16 attention
   (no launch). Step 1 (warm-up) must launch ``flash_attention`` exactly
   28 layers x (forward + remat recompute) x 2 microbatches = 112 times
   and nothing else (the backward launches none), and its loss and grad
   norm must agree with the plain attention's within the bf16 rule:
   LM_BF16_NOISE x |plain bf16 - float32|. After step 2 the parameters
   and the AdamW state are saved with ``repro_torch.checkpoint`` under the
   temporary directory, restored onto the card and held against the live
   state bit for bit. Steps 2 and 3 are timed one by one (host clock
   around synchronised steps); every loss, grad norm and parameter must
   be finite. Printed: seconds a step (the median), tokens/s, peak memory
   over the timed steps (not the checkpoint), and the step's share of its
   roofline bound, ``launch.roofline.lm_model_flops(kind="train")`` at
   the bf16 rate (remat recompute not counted).
12. Slice I, llama4 serving (budget 60 s): llama4-scout-17b-a16e at its
   published width (d_model 5120, 40 heads over 8 kv heads, head_dim 128,
   d_ff 8192, vocab 202,048, 16 experts top-1 with the shared expert on
   every layer, attn_chunk 8192, every 4th layer global without RoPE),
   cut to 4 of its 48 layers (one iRoPE period: 9.84B parameters, random
   from ``--seed``, float32 masters for the checks, then bf16), after
   slice H's state is freed. ``LM_SHAPES["prefill_32k"]`` cut to 2 x
   12,288 prompt tokens: one whole chunk and a tail of 4,096, so a
   chunked layer launches the kernel twice and the global one once.
   ``flash_attention`` at the global layer's shape (q [2, 40, 12288,
   128], a GQA group of 5) against the plain version in both dtypes;
   the float32 prefill launches ``flash_attention_f32`` exactly 7 times
   and its logits match the plain attention within 1e-4 of the largest;
   a float32 decode step at position 12,288 matches a prefill of 12,289
   tokens within 1e-4 of the largest logit, with the MoE's capacity
   lifted (capacity_factor 8, cap = N / 2, one lane) and no token
   dropped in either (checked): at the served
   capacity a prefill of T + 1 tokens may drop a token that the decode
   step keeps, so that figure is printed per lane with the layers that
   dropped the last token, without a gate. In bf16 (``cast_matrices``;
   the router stays float32) the prefill launches ``flash_attention``
   exactly 7 times and nothing else, and its logits stay within 2x bf16's
   own distance to float32 of the plain attention's. Then the timed
   serving: a second prefill (host clock around synchronised work) and
   16 greedy decode steps (one window). Printed: tokens/s, decode ms a
   step, peak memory of the serving calls, tokens dropped by capacity and
   experts used a layer, and each call's share of its roofline bound
   (``lm_model_flops`` counts the top-1 expert, the shared expert and the
   router, and each chunk's own keys; the bytes count the experts the
   call's tokens use).

13. Slice J, llama4 training (budget 60 s): llama4-scout-17b-a16e at
   its published width (slice I's), cut to 1 of 48 layers (chunked with
   RoPE, MoE with 16 experts and the shared expert: 3.237B parameters;
   float32 masters, gradients and AdamW m and v take 51.8 GB; four
   layers would take 157 GB), remat "full", ``LM_SHAPES["train_4k"]``
   cut to 2 x 4,096 tokens as accum=2 microbatches of 1 from
   ``lm_batch``. At 4,096 <= attn_chunk 8,192 the chunk mask is the
   causal mask: one kernel launch a forward. The first step's loss and
   grad norm against the plain attention (the bf16 rule, beside the
   float32 kernel's: exactly 4 launches of ``flash_attention_f32``);
   step 1 launches ``flash_attention`` exactly 4 times (forward and remat
   recompute, 2 microbatches) and nothing else; the remat recompute
   routes every token as the forward did (eidx and keep), and one
   microbatch's forward run twice routes alike. Then 4 timed steps.
   Printed: seconds a step (median), tokens/s, share of the
   ``lm_model_flops(kind="train")`` bound, peak memory, each
   microbatch's ce and router_aux in step 1 and its tokens dropped by
   capacity.
14. Slice K, recsys (budget 30 s): fm, deepfm, wide-deep and din at their
   published tables (2^25 rows x 10, x 10, x 32; din 2^24 x 18 with a
   history of 100), random from ``--seed``. Each trains on
   ``RECSYS_SHAPES["train_batch"]`` (65,536 rows of ``recsys_batch``, a
   fresh batch a step; 1 warm-up and 4 timed AdamW steps), serves
   ``forward`` at serve_p99 (512 rows, 200 calls: p50 and p99) and
   serve_bulk (262,144 rows), and retrieves the top 100 of
   retrieval_cand's 1,000,000 candidates (its table's first rows) for
   one user's vector (din's attention output, else the mean of the
   request's field embeddings). Gates: finite losses and parameters; the
   first batch's logloss lower after training than before; the 512-row
   forward within 1e-5 of the largest of the bulk forward's first 512
   rows; the retrieval's ids equal a full argsort's where the scores are
   distinct, its scores equal. Printed: step seconds, examples/s, peak
   memory, p99 ms, bulk rows/s, retrieval ms.
15. Slice L, the GCN (budget 90 s): gcn-cora's model at
   ``GNN_SHAPES``' widths from ``--seed``. Full batch at ogb_products
   (``random_graph`` of 2,449,029 nodes and 61,859,140 edges, d_feat 100,
   47 classes; the first conv gathers 64.3M messages x 100 float32, 25.7
   GB); molecule (128 graphs of 30 nodes, a label a graph) through
   ``graph_loss_fn``; minibatch_lg (232,965 nodes, d_feat 602, 41
   classes, its edges cut to a third: ``L_SAMPLED_EDGES``) through
   ``NeighborSampler`` (1,024 seeds, fanout (15, 10), on the host) and
   ``sampled_loss_fn``. 1 warm-up and 4 timed AdamW steps each; losses
   and parameters finite. Printed: the host's generation, CSR and
   sampling seconds, step seconds, peak memory and loss a step.
16. Slice M, the cell registry and the launch layer
   (``repro_torch.configs.registry``, ``repro_torch.launch``). (a)
   ``launch.dryrun`` over every (arch x shape) cell on the (16, 16) and
   (2, 16, 16) meshes, started after the build in a process of its own
   that does not see the card (the meta device) and read here: exit 0,
   no failed cell, each cell run on meta or analytic only with its
   reason; printed: ok / analytic-only / failed counts and the cells
   whose per-card state does not fit (the data sheet's 80 GB and this
   card's memory). (b) ``perf --cell qwen3_train``: qwen3-1.7b at its
   published width and depth with ``attn_scores_bf16`` (v2) and with
   remat "dots" too (v3), ``train_4k`` cut to 4 x 4,096 tokens as accum
   2, a warm-up and 2 timed steps each: the main path of the kernel's
   bf16-score variant, which must launch exactly 28 x 2 x 2 = 112 times
   a step and nothing else launch; the first step's loss within 2^-12
   (relative) of the plain attention's on the same weights, and the
   output of the step's first attention call (layer 0) against the plain
   version on its inputs, within the variant's gate (below). (c) ``perf --cell
   jag_serve``: the five serve variants over one shard of serve_1b at
   its published width (2^22 rows, d 128, row width 80; seeded random
   data, uniform adjacency; 256 queries in place of 4096); each result
   holds together (ids in range, finite keys, every id at primary 0
   inside its range filter). (d) ``perf --cell din_train``: float32 and
   bf16 tables timed at 65,536 rows, the rules' per-card state of all
   four variants. (e) ``launch.train --scale tiny`` crashed at step 6
   (exit 42), resumed from step 4 and run beside a control: the last
   loss within 2e-2 of the control's (the reference's test). (f) the
   variant (both knobs) against its plain version and SDPA at slice C's
   prefill shape, its ms and bound. The variant's gate is element by
   element: every output within one bf16 step (2^-7 of the plain value)
   plus 2^-6, and at most 2^-9 of the outputs past one step plus 1e-5
   (``bf16_variant_gate``); the split kernel (flash_attention, knobs
   ignored) must fail it on the same inputs, which shows that the gate
   tells the rounding points apart.

The last lines are nvidia-smi's card line, one JSON object with a record
per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

COLD_SETS = 8                  # id batches a cold fused_expand timing cycles
DTOL = 1e-5                    # d2 tolerance, relative to |x|^2 + |q|^2
RECALL_MIN = 0.80
MIN_DEGREE_SHARE = 1 / 8       # a built row below R / 8 edges is a fault
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 4096, 32   # prefill_32k cut to fit
E_INSERTS, E_INSERT_ROWS = 4, 5000   # slice E's streamed rows (drawn as D's)
F_N, F_SIFT_N = 100_000, 60_000      # slice F's msturing_subset, sift_like
F_QUERIES, F_SHARDS = 1024, 4
# one batch for every build of slice F, the union's and each shard's: 4096
# keeps about six batches in each 25,000-row shard (ROADMAP F12: at a batch
# near a third of the rows the graph route's recall collapses)
F_BUILD = dict(degree=64, ls_build=96, cand_pool=192, batch_size=4096)
F_MARGIN = 0.02                # sharded recall per routed band >= union's - it
LM_F32_TOL = 1e-4              # float32 prefill, of the largest logit
LM_BF16_NOISE = 2              # bf16 checks: widths of bf16's own error
H_BATCH, H_ACCUM, H_STEPS = 4, 2, 2  # slice H: train_4k cut, timed steps
I_ARCH = "llama4-scout-17b-a16e"
I_LAYERS, I_BATCH, I_PROMPT, I_STEPS = 4, 2, 12288, 16   # slice I's cuts
J_LAYERS, J_BATCH, J_ACCUM, J_STEPS = 1, 2, 2, 4   # slice J's cuts
K_ARCHS = ("fm", "deepfm", "wide-deep", "din")
K_STEPS, K_TOPK, K_P99_CALLS = 4, 100, 200
K_SERVE_TOL = 1e-5             # 512 rows vs the bulk batch, of the largest
L_STEPS = 4
# minibatch_lg's edges, cut from the published 114,615,892 to a third:
# generating them and the sampler's CSR took 60 s on the card's host, over
# the 30 s this slice allows them; at 1/3 each of the 232,965 nodes keeps
# about 164 in-edges, more than the fanout of 15 takes
L_SAMPLED_EDGES = 38_205_297


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(report: str) -> list:
    """(kernel, registers, bytes of spill stores) for each kernel function
    in a ptxas ``-v`` report (``_build.PTXAS_LOG``), in its order; names
    demangled, without return type or parameters, where ``c++filt`` is
    found."""
    rows, fn, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            rows.append((fn, int(m.group(1)), spill))
            fn = None
    tool = shutil.which("c++filt")
    if tool and rows:
        names = subprocess.run([tool], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout
        rows = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                 .removeprefix("void "), regs, sp)
                for n, (_, regs, sp) in zip(names.splitlines(), rows)]
    return rows


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    A kernel shorter than its host-side launch (a few tens of microseconds
    through Python and ctypes) would otherwise be timed at the host's
    launch rate: the stream is held by a sleep kernel while the host
    enqueues the calls, so that they run back to back on the device.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * enqueue_s, 1.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(torch, fns, iters: int) -> float:
    """``cuda_ms`` over calls that take ``fns`` in turn. Their inputs
    together exceed the L2, so each call finds its own evicted, as a caller
    that reads new rows at every step does."""
    turn = itertools.cycle(fns)
    return cuda_ms(torch, lambda: next(turn)(), iters)


def popc_ops_per_s(torch) -> tuple:
    """The card's popcount rate (``launch.roofline.popc_ops_per_s`` at its
    SM count and the SM's maximum clock as nvidia-smi prints it,
    ``clocks.max.sm``); also that line."""
    from repro_torch.launch.roofline import HW, popc_ops_per_s as rate
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return rate(sms, float(clock.split()[0])), \
        f"{sms} SMs x {HW['popc_per_clock']} a clock x clocks.max.sm {clock}"


def check_d2(torch, name, got, want, scale):
    err = (got - want).abs()
    bad = err > DTOL * scale
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: d2 off by {float(err.max())} (> {DTOL} x scale) at "
            f"{int(bad.sum())} entries")
    return float(err.max())


def check_exact(torch, name, got, want):
    """Max |got - want| over integer tensors, which must be 0."""
    err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    if err != 0.0:
        n = int((got != want).sum())
        raise AssertionError(f"{name}: {n} entries differ from the plain "
                             f"version (max {err})")
    return err


def check_fused_expand(torch, ops, ref, packed, ids, q, qn, d) -> float:
    """fused_expand against its plain version: d2 within DTOL of |x|^2 +
    |q|^2, the attr words bit for bit; the max d2 error."""
    kd2, kw = ops.fused_expand(packed, ids, q, qn, d=d)
    pd2, pw = ref.fused_expand(packed, ids, q, qn, d=d)
    rows = ids.long().clamp(0, packed.shape[0] - 1)
    err = check_d2(torch, "fused_expand", kd2, pd2,
                   packed[rows, d] + qn[:, None])
    check_exact(torch, "fused_expand words", kw.view(torch.int32),
                pw.contiguous().view(torch.int32))
    return err


def check_bitset(torch, ops, ref, a, b) -> float:
    """bitset_dist against its plain version, both ops, exact."""
    return max(check_exact(
        torch, f"bitset_dist[{op}] a{tuple(a.shape)} b{tuple(b.shape)}",
        ops.bitset_dist(a, b, op=op), ref.bitset_dist(a, b, op=op))
        for op in ("deficit", "xor"))


def error_stats(torch, got, exact) -> dict:
    """Largest and mean |got - exact|, and the share of the error that
    points toward zero, sum(-sign(exact) * error) / sum(|error|): near 0
    where every rounding is to nearest, near 1 where they truncate."""
    e = got.double() - exact
    return dict(max=float(e.abs().max()), mean=float(e.abs().mean()),
                toward_zero=float((-torch.sign(exact) * e).sum()
                                  / e.abs().sum()))


def l2dist_vs_f64(torch, q, x, outs: dict) -> dict:
    """Each l2dist output of ``outs`` (label -> [B, N]) against the same
    distances in float64, as ``error_stats`` gives them, and beside them
    ``dot_toward_zero``, the share of the error that moves q.x toward zero
    (sign(q.x) * error, since d2 = |q|^2 + |x|^2 - 2 q.x): a truncating
    accumulation of q.x shows there and not in the share of d2."""
    qd, xd = q.double(), x.double()
    dot = qd @ xd.T
    exact = (torch.sum(qd * qd, -1)[:, None] + torch.sum(xd * xd, -1)[None]
             - 2.0 * dot).clamp_min(0.0)
    res = {}
    for k, out in outs.items():
        e = out.double() - exact
        res[k] = dict(error_stats(torch, out, exact), dot_toward_zero=float(
            (torch.sign(dot) * e).sum() / e.abs().sum()))
    return res


def check_l2dist(torch, ops, ref, q, x) -> tuple:
    """l2dist against its plain version within DTOL: (max error, its
    largest share of the limit, the kernel's and the plain version's
    errors against float64), the share and the float64 figures printed."""
    got, want = ops.l2dist(q, x), ref.l2dist(q, x)
    scale = torch.sum(q * q, -1)[:, None] + torch.sum(x * x, -1)[None]
    label = f"l2dist {tuple(q.shape)}x{tuple(x.shape)}"
    err = check_d2(torch, label, got, want, scale)
    share = float(((got - want).abs() / (DTOL * scale)).max())
    f64 = l2dist_vs_f64(torch, q, x, {"kernel": got, "plain": want})
    log(f"[kernels] {label}: largest error {share:.4f} of the d2 limit; "
        "against float64 (max, mean, share toward zero, of q.x) " + ", ".join(
            f"{k} {s['max']:.4g} {s['mean']:.4g} {s['toward_zero']:.3f} "
            f"{s['dot_toward_zero']:.3f}" for k, s in f64.items()))
    return err, share, f64


def check_flash(torch, ops, ref, q, k, v) -> float:
    """Max |kernel - plain| of flash_attention, within its dtype's gate.

    bf16: a bf16 step, 2^-7 of the plain output plus 1e-5; float32: 1e-4
    relative plus 1e-4 (sum order only).
    """
    got = ops.flash_attention(q, k, v).float()
    want = ref.flash_attention(q, k, v).float()
    err = (got - want).abs()
    if q.dtype == torch.bfloat16:
        bad = err > 2.0 ** -7 * want.abs() + 1e-5
    else:
        bad = err > 1e-4 * want.abs() + 1e-4
    if bool(bad.any()):
        raise AssertionError(f"flash_attention ({q.dtype}): {int(bad.sum())}"
                             f" outputs off its gate (max {float(err.max())})")
    return float(err.max())


def check_scan_tile(torch, ops, ref, xb, base, q, tile) -> tuple:
    """gather_dist_tile against its plain version: (max error, bit-exact).

    Fails if the error passes DTOL of |x|^2 + |q|^2; whether the kernel is
    also bit-exact is the caller's gate.
    """
    got = ops.gather_dist_tile(xb, base, q, tile=tile)
    want = ref.gather_dist_tile(xb, base, q, tile=tile)
    xn = torch.sum(xb * xb, -1).view(-1, tile)
    scale = xn[base.long()] + torch.sum(q * q, -1)[:, None]
    err = check_d2(torch, "gather_dist_tile", got, want, scale)
    return err, torch.equal(got, want)


class KernelCalls:
    """While installed, keeps a copy of the first call of each named
    ``ops`` wrapper at each distinct input signature (shapes, dtypes and
    scalar arguments), so that a path's calls can be held against the
    plain versions afterwards at the shapes the path gave them. Inputs of
    up to 2^20 elements are copied; larger ones (the row tables, which no
    path writes in place) are kept by reference. The calls themselves go
    through unchanged."""

    def __init__(self, torch, ops, names):
        self.torch, self.ops, self.names = torch, ops, names
        self.calls = {n: {} for n in names}
        self._orig = {}

    def _sig(self, args, kw):
        t = self.torch
        return tuple((tuple(a.shape), str(a.dtype)) if isinstance(a, t.Tensor)
                     else a for a in args) + tuple(sorted(kw.items()))

    def __enter__(self):
        t = self.torch
        for name in self.names:
            fn = self._orig[name] = getattr(self.ops, name)

            def rec(*args, _fn=fn, _seen=self.calls[name], **kw):
                sig = self._sig(args, kw)
                if sig not in _seen:
                    _seen[sig] = ([a.clone() if isinstance(a, t.Tensor)
                                   and a.numel() <= 1 << 20 else a
                                   for a in args], dict(kw))
                return _fn(*args, **kw)
            setattr(self.ops, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.ops, name, fn)
        return False


def check_recorded(torch, ops, ref, calls) -> dict:
    """Hold every call a ``KernelCalls`` kept against the plain versions:
    fused_expand's d2 within DTOL and its attr words bit for bit,
    gather_dist_tile and bitset_dist bit for bit. Returns, per kernel,
    the signatures held and the largest d2 error."""
    out = {}
    for name, seen in calls.items():
        err = 0.0
        for args, kw in seen.values():
            if name == "fused_expand":
                err = max(err, check_fused_expand(torch, ops, ref, *args,
                                                  **kw))
            elif name == "gather_dist_tile":
                e, exact = check_scan_tile(torch, ops, ref, *args, **kw)
                if not exact:
                    raise AssertionError(
                        f"gather_dist_tile is not bit-exact at xb"
                        f"{tuple(args[0].shape)} q{tuple(args[2].shape)} "
                        f"{kw}")
                err = max(err, e)
            elif name == "bitset_dist":
                err = max(err, check_bitset(torch, ops, ref, *args))
        out[name] = dict(signatures=len(seen), max_abs_err=err)
    return out


def profile_main_path(run, trace_path: str) -> dict:
    """Device busy share, idle gaps and the top kernels of one traced run
    (``launch.trace_stats.profile``; the Chrome trace goes to
    ``trace_path``)."""
    from repro_torch.launch.trace_stats import profile
    out = profile(run, trace_path)
    log(f"[profile] wall {out['wall_us'] / 1e3:.1f} ms, device busy "
        f"{out['device_busy_us'] / 1e3:.1f} ms "
        f"({100 * out['device_busy_share']:.1f}%), longest idle gaps us "
        f"{[round(g, 1) for g in out['idle_gaps_us']]}")
    for name, k in list(out["kernels"].items())[:12]:
        log(f"[profile]   {k['device_ms']:9.3f} ms {k['calls']:6d}x "
            f"{name[:90]}")
    return out


def run_slice_d(torch, np, idx, ds, q_all, gt, f32_recall, f32_qps, kernels,
                K, LS, MI) -> dict:
    """Slice D over slice A's built index: int8 serving, then streaming
    (inserts, merged search, compaction, search after it). Every gate
    raises; returns the phase's report."""
    from repro_torch.core.filters import subset_table
    from repro_torch.core.ground_truth import exact_filtered_knn
    from repro_torch.core.quantized import quantize_int8
    from repro_torch.core.recall import recall_at_k
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.roofline import kernel_bound_ms
    from repro_torch.serve.layout import build_layout
    from repro_torch.stream import StreamingJAGIndex

    dev = idx.device
    N, D = idx.xb.shape
    R = idx.cfg.degree
    out = {}
    t_phase = time.perf_counter()

    def groups_of(plan):
        return {g.route: g.ids for g in plan.groups}

    def route_recall(res, gt_ids, groups):
        rec = recall_at_k(res.ids.cpu().numpy(),
                          res.primary.cpu().numpy() == 0.0, gt_ids)
        return {r: float(rec[ids].mean()) for r, ids in groups.items()}

    def served(label, fn):
        """Run ``fn(on_group)`` twice, the first with the counts at 0;
        (result, plan, launches, QPS per route of the second run, wall s
        of the second run)."""
        timings = {}

        def on_group(g, res, stats, secs):
            timings[g.route] = (len(g.ids), secs)

        ops.reset_launches()
        res, p = fn(on_group)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        timings.clear()
        t0 = time.perf_counter()
        res2, _ = fn(on_group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not torch.equal(res.ids, res2.ids):
            raise AssertionError(f"{label}: two runs disagree")
        qps = {r: n / s for r, (n, s) in timings.items()}
        log(f"[slice D] {label}: launches {launches}; QPS " + ", ".join(
            f"{r} {v:.1f} (slice A {f32_qps.get(r, float('nan')):.1f})"
            for r, v in qps.items()) + f"; batch {len(q_all) / wall:.1f} "
            f"queries/s end to end")
        return res, p, launches, qps, wall

    # -- int8 over the frozen index ----------------------------------------
    t0 = time.perf_counter()
    idx.quantized()
    lay8 = idx.fused_layout("int8")
    torch.cuda.synchronize()
    out["int8_state_s"] = time.perf_counter() - t0
    gt_ids = gt.ids.cpu().numpy()
    for layout in ("fused", "default"):
        res, p, launches, qps, wall = served(
            f"int8 {layout}", lambda og: idx.search_auto(
                q_all, ds.filt, k=K, ls=LS, max_iters=MI, layout=layout,
                dtype="int8", return_plan=True, on_group=og))
        groups = groups_of(p)
        rec = route_recall(res, gt_ids, groups)
        log(f"[slice D] int8 {layout}: recall@{K} per route {rec} (f32 "
            f"fused, slice A: {f32_recall})")
        if rec["graph"] < RECALL_MIN:
            raise AssertionError(f"int8 {layout} graph recall "
                                 f"{rec['graph']:.4f} < {RECALL_MIN}")
        if not np.array_equal(res.ids.cpu().numpy()[groups["prefilter"]],
                              gt_ids[groups["prefilter"]]):
            raise AssertionError(f"int8 {layout}: prefilter ids differ from "
                                 "the exact scan")
        if layout == "fused" and launches["fused_expand"] <= 0:
            raise AssertionError("int8 fused search launched no fused_expand")
        out[f"int8_{layout}"] = dict(recall=rec, qps=qps, launches=launches,
                                     batch_s=wall)
    # fused_expand on the int8 lanes at the graph group's shapes
    gi = torch.as_tensor(groups["graph"], device=dev)
    Bg, C = len(gi), R + idx.cfg.ex_slots
    q_eff, qgn = lay8.fold_query(q_all[gi])
    q_eff = q_eff.contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    id_sets = [torch.randint(0, N, (Bg, C), generator=gen, device=dev,
                             dtype=torch.int32) for _ in range(COLD_SETS)]
    err = check_fused_expand(torch, ops, ref, lay8.packed, id_sets[0], q_eff,
                             qgn, D)
    A = lay8.n_attr_words
    b, o = kernel_bound_ms("fused_expand", B=Bg, C=C, d=D, A=A)
    rec8 = dict(
        shape=f"packed[{N},{D + 1 + A}] int8 lanes ids[{Bg},{C}]",
        max_abs_err=err,
        ms=cold_ms(torch, [lambda s=s: ops.fused_expand(
            lay8.packed, s, q_eff, qgn, d=D) for s in id_sets], 50),
        warm_ms=cuda_ms(torch, lambda: ops.fused_expand(
            lay8.packed, id_sets[0], q_eff, qgn, d=D), 50),
        plain_ms=cuda_ms(torch, lambda: ref.fused_expand(
            lay8.packed, id_sets[0], q_eff, qgn, d=D), 10),
        bound_ms=b, bound_by=o,
        launches=out["int8_fused"]["launches"]["fused_expand"])
    kernels["fused_expand"]["int8"] = rec8
    log(f"[kernels] fused_expand {rec8['shape']}: max_abs_err {err:.3g}, "
        f"{rec8['ms']:.6f} ms cold, {rec8['warm_ms']:.6f} ms warm (plain "
        f"{rec8['plain_ms']:.4f} ms, bound {b:.4f} ms by {o}), "
        f"{rec8['launches']} launches in the int8 fused run")
    del id_sets
    # the card's quantization against the CPU's, bit for bit
    rows = torch.randperm(N, generator=gen, device=dev)[:65_536]
    xs = idx.xb[rows.sort().values]
    cc, cs = quantize_int8(xs)
    hc, hs = quantize_int8(xs.cpu())
    if not (torch.equal(cc.cpu(), hc) and torch.equal(
            cs.cpu().view(torch.int32), hs.view(torch.int32))):
        raise AssertionError("quantize_int8 on the card differs from the CPU")
    log(f"[slice D] quantize_int8 on {len(rows)} rows: the card's codes and "
        "scale equal the CPU's bit for bit")
    del cc, cs, hc, hs, xs

    # -- streaming: inserts, merged search, compaction ---------------------
    n_batches = 4
    M = N // 50 // n_batches * n_batches    # 2% of N: 10,000 at 500k rows
    rng = np.random.default_rng(1)
    std = idx.xb.std(0).cpu().numpy()
    src = rng.integers(0, N, M)
    xv = (idx.xb[torch.as_tensor(src, device=dev)].cpu().numpy()
          + rng.normal(size=(M, D)) * 0.1 * std).astype(np.float32)
    bits = rng.random((M, ds.attr.n_bits)) < 0.5
    sidx = StreamingJAGIndex(idx)
    step = M // n_batches
    t0 = time.perf_counter()
    for i in range(n_batches):
        rep = sidx.insert(xv[i * step:(i + 1) * step],
                          subset_table(bits[i * step:(i + 1) * step],
                                       ds.attr.n_bits, device=dev))
        if rep["compacted"]:
            raise AssertionError("an insert compacted at the default "
                                 "compact_frac")
    out["insert_s"] = time.perf_counter() - t0
    log(f"[slice D] inserted {M} rows in {n_batches} batches in "
        f"{out['insert_s']:.3f} s: epoch {sidx.epoch}, delta {sidx.delta.n}")
    xcat = torch.cat([idx.xb, torch.as_tensor(xv, device=dev)])
    live = sidx.attr
    gt_cat = exact_filtered_knn(xcat, live, q_all, ds.filt, k=K,
                                use_kernel=True).ids.cpu().numpy()
    res, p, launches, qps, wall = served(
        "streamed f32 fused", lambda og: sidx.search_auto(
            q_all, ds.filt, k=K, ls=LS, max_iters=MI, layout="fused",
            return_plan=True, on_group=og))
    groups = groups_of(p)
    if not all(r.endswith("+delta") for r in p.realized):
        raise AssertionError(f"a streamed route lacks +delta: {p.realized}")
    ops.reset_launches()
    extra = sidx.executor.delta(q_all, ds.filt, k=K)
    torch.cuda.synchronize()
    delta_launches = dict(ops.LAUNCHES)
    for name in ("gather_dist_tile", "bitset_dist"):
        if delta_launches[name] <= 0:
            raise AssertionError(f"the delta scan launched no {name}")
    t0 = time.perf_counter()
    sidx.executor.merge(res, sidx.executor.delta(q_all, ds.filt, k=K), k=K)
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t0
    log(f"[slice D] delta scan of {M} rows and merge for {len(q_all)} "
        f"queries: {delta_s * 1e3:.1f} ms; launches {delta_launches}; "
        f"realized {sorted(set(p.realized))}")
    rec = route_recall(res, gt_cat, groups)
    ids_np = res.ids.cpu().numpy()
    if not np.array_equal(ids_np[groups["prefilter"]],
                          gt_cat[groups["prefilter"]]):
        raise AssertionError("streamed prefilter ids differ from the exact "
                             f"scan over {N + M} rows")
    if rec["graph"] < RECALL_MIN:
        raise AssertionError(f"streamed graph recall {rec['graph']:.4f} < "
                             f"{RECALL_MIN}")
    n_delta_hits = int((res.ids >= N).sum())
    log(f"[slice D] streamed recall@{K} per route {rec}; {n_delta_hits} "
        f"inserted rows in the merged top-{K} lists")
    # the delta scan's last, padded block through the kernel
    blk = min(4096, M)
    dp = D + (-D) % 8
    xv_pad = torch.nn.functional.pad(torch.as_tensor(xv, device=dev),
                                     (0, dp - D, 0, (-M) % blk)).contiguous()
    q_pad = torch.nn.functional.pad(q_all, (0, dp - D)).contiguous()
    last = torch.full((len(q_all),), xv_pad.shape[0] // blk - 1,
                      dtype=torch.int32, device=dev)
    terr, exact = check_scan_tile(torch, ops, ref, xv_pad, last, q_pad, blk)
    if not exact:
        raise AssertionError("gather_dist_tile on the delta's padded last "
                             "block is not bit-exact")
    log(f"[slice D] gather_dist_tile xb[{xv_pad.shape[0]},{dp}] "
        f"q[{len(q_all)},{dp}] tile={blk}, last block padded: bit-exact")
    out["streamed"] = dict(recall=rec, qps=qps, launches=launches,
                           batch_s=wall, delta_merge_s=delta_s,
                           delta_launches=delta_launches,
                           inserted_in_top_k=n_delta_hits,
                           realized=sorted(set(p.realized)),
                           delta_tile_max_abs_err=terr)
    del extra, xv_pad, q_pad

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sidx.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    nb = sidx.base
    if nb.graph.shape[0] != N + M or sidx.delta.n:
        raise AssertionError(f"compaction left {nb.graph.shape[0]} graph rows "
                             f"and {sidx.delta.n} delta rows")
    new_deg = int((nb.graph[N:] >= 0).sum(1).min())
    if new_deg < R * MIN_DEGREE_SHARE:
        raise AssertionError(f"compaction left an inserted row of degree "
                             f"{new_deg} (< {R} x {MIN_DEGREE_SHARE})")
    if not torch.equal(nb.fused_layout("f32").packed.view(torch.int32),
                       build_layout(nb.xb, nb.attr).packed.view(torch.int32)):
        raise AssertionError("the extended f32 layout differs from one "
                             "packed anew")
    log(f"[slice D] compact {M} rows into {N}: {out['compact_s']:.2f} s; "
        f"least degree of an inserted row {new_deg}; degree "
        f"{nb.degree_stats()}; the extended f32 layout equals build_layout "
        "bit for bit")
    res, p, launches, qps, wall = served(
        "compacted f32 fused", lambda og: sidx.search_auto(
            q_all, ds.filt, k=K, ls=LS, max_iters=MI, layout="fused",
            return_plan=True, on_group=og))
    groups = groups_of(p)
    rec = route_recall(res, gt_cat, groups)
    ids_np = res.ids.cpu().numpy()
    if not np.array_equal(ids_np[groups["prefilter"]],
                          gt_cat[groups["prefilter"]]):
        raise AssertionError("prefilter ids after compaction differ from "
                             "the exact scan")
    if rec["graph"] < RECALL_MIN:
        raise AssertionError(f"graph recall after compaction "
                             f"{rec['graph']:.4f} < {RECALL_MIN}")
    new_hits = int((ids_np[groups["graph"]] >= N).sum())
    if new_hits == 0:
        raise AssertionError("no inserted row is served by the graph route")
    log(f"[slice D] after compaction: recall@{K} per route {rec}; "
        f"{new_hits} inserted rows in the graph route's results")
    g_ids = groups["graph"]
    t0 = time.perf_counter()
    r8 = sidx.search_int8(q_all[torch.as_tensor(g_ids, device=dev)],
                          ds.filt.take(g_ids), k=K, ls=LS, layout="fused")
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    n8 = nb.fused_layout("int8").n
    if n8 != N + M:
        raise AssertionError(f"the int8 layout after compaction has {n8} rows")
    rec8c = float(recall_at_k(r8.ids.cpu().numpy(),
                              r8.primary.cpu().numpy() == 0.0,
                              gt_cat[g_ids]).mean())
    log(f"[slice D] search_int8 after compaction rebuilt its layout over "
        f"{n8} rows ({int8_s:.2f} s with the rebuild); graph-group recall "
        f"{rec8c:.4f}")
    out["compacted"] = dict(recall=rec, qps=qps, launches=launches,
                            batch_s=wall, new_rows_served=new_hits,
                            least_new_degree=new_deg, int8_rows=n8,
                            int8_recall=rec8c, int8_first_s=int8_s)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice D] {out['phase_s']:.1f} s")
    return out


def run_slice_e(torch, np, idx, ds, q_all, gt, f32_qps, K, LS,
                MI) -> dict:
    """Slice E over slice A's built index: calibrate the cost model on the
    card, route slice A's batch by it, serve the batch with telemetry
    (introspection, spans, shadow audits), and let the model decide a
    streaming index's compaction. Every gate raises; returns the phase's
    report."""
    import tempfile
    from dataclasses import asdict
    from repro_torch.core.filters import subset_table
    from repro_torch.core.ground_truth import exact_filtered_knn
    from repro_torch.core.recall import recall_at_k
    from repro_torch.cost import CostRegistry, fit, run_calibration, to_json
    from repro_torch.cost.calibrate import FULL_GRID
    from repro_torch.cost.model import ALL_ROUTES
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import (Telemetry, heldout_error,
                                 introspection_summary, load_jsonl,
                                 render_health, sel_band)
    from repro_torch.serve.planner import PlannerConfig, explain
    from repro_torch.stream import StreamingJAGIndex

    dev = idx.device
    N, D = idx.xb.shape
    out = {}
    t_phase = time.perf_counter()
    gt_ids = gt.ids.cpu().numpy()

    def recall_of(res, want, rows=None):
        rec = recall_at_k(res.ids.cpu().numpy(),
                          res.primary.cpu().numpy() == 0.0, want)
        return float(rec.mean() if rows is None else rec[rows].mean())

    def timed_batch(**kw):
        """Two runs of slice A's batch; (result, plan, QPS per route and
        batch QPS of the second run, launches of the first)."""
        timings = {}

        def og(g, res, stats, secs):
            timings[g.route] = (len(g.ids), secs)

        ops.reset_launches()
        res, p = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                                 layout="fused", return_plan=True,
                                 on_group=og, **kw)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        timings.clear()
        t0 = time.perf_counter()
        res2 = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                               layout="fused", on_group=og, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not torch.equal(res.ids, res2.ids):
            raise AssertionError("two runs of slice E's batch disagree")
        return (res, p, {r: n / s for r, (n, s) in timings.items()},
                len(q_all) / wall, launches)

    # -- 1. calibration on the card (calibrate() is these two calls; the
    # observations are kept to be checked) ----------------------------------
    grid = FULL_GRID
    ops.reset_launches()
    t0 = time.perf_counter()
    with KernelCalls(torch, ops, ("fused_expand", "gather_dist_tile",
                                  "bitset_dist")) as cal_calls:
        cal = run_calibration(device=dev, **grid)
    model = fit(cal.observations, cal.meta)
    torch.cuda.synchronize()
    out["calibrate_s"] = time.perf_counter() - t0
    out["calibrate_launches"] = dict(ops.LAUNCHES)
    # the grid's kernels run at widths slice A's checks do not reach (d 32
    # and 64: fused_expand rows of 34 and 66 words): each call signature
    # the calibration made, held against the plain version on its inputs
    out["calibrate_checks"] = check_recorded(torch, ops, ref,
                                             cal_calls.calls)
    del cal_calls
    log(f"[slice E] the calibration's kernel calls against their plain "
        f"versions (distinct signatures, max d2 error): "
        f"{out['calibrate_checks']}")
    for name in ("fused_expand", "gather_dist_tile"):
        if not out["calibrate_checks"][name]["signatures"]:
            raise AssertionError(f"the calibration made no {name} call")
    bad = [o for o in cal.observations
           if not (np.isfinite(o.us) and o.us > 0 and np.isfinite(o.n_dist))]
    if bad:
        raise AssertionError(f"{len(bad)} calibration observations are not "
                             f"finite and positive: {bad[:3]}")
    if not model.covers(ALL_ROUTES, "us"):
        raise AssertionError(f"the model covers {model.routes()}, not "
                             f"{ALL_ROUTES}")
    if model.meta["backend"] != "cuda":
        raise AssertionError(f"model backend {model.meta['backend']!r}")
    with tempfile.TemporaryDirectory() as tmp:
        reg = CostRegistry(tmp)
        reg.save(model)
        back = reg.load("cuda")
        if back is None or to_json(back) != to_json(model):
            raise AssertionError("CostRegistry did not round trip the model")
    log(f"[slice E] calibration on the card ({len(cal.observations)} "
        f"observations; grid ns {grid['ns']} ds {grid['ds']} lss "
        f"{grid['lss']} b {grid['b']} delta_ns {grid['delta_ns']} repeats "
        f"{grid['repeats']}): {out['calibrate_s']:.1f} s, builds "
        f"{cal.meta['builds']}; launches {out['calibrate_launches']}")
    for route in ALL_ROUTES:
        log(f"[slice E]   fit {route}: {model.fit_stats.get(route)}; us "
            f"coef {[round(c, 4) for c in model.coef[route]['us']]}")
    out["fit_stats"] = model.fit_stats
    out["model"] = json.loads(to_json(model))

    # -- 2. slice A's batch routed by the model ------------------------------
    _, static_p, static_qps, static_bqps, _ = timed_batch()
    idx.attach_cost_model(model)
    res, p, qps, bqps, launches = timed_batch()
    counts = {g.route: len(g.ids) for g in p.groups}
    static_counts = {g.route: len(g.ids) for g in static_p.groups}
    router = idx.executor.cost_router(k=K, ls=LS, filt=ds.filt)
    log(f"[slice E] routed by the model: {counts} (static plan "
        f"{static_counts}); launches {launches}")
    for g in p.groups:
        pred = {r: round(c, 2) for r, c in router.costs(
            g.selectivity).items()}
        log(f"[slice E]   {g.route}: {len(g.ids)} queries at median sel "
            f"{g.selectivity:.5f}, predicted us/query {pred}")
    log(f"[slice E] explain: {explain(p)}")
    groups = {g.route: g.ids for g in p.groups}
    if "prefilter" in groups and not np.array_equal(
            res.ids.cpu().numpy()[groups["prefilter"]],
            gt_ids[groups["prefilter"]]):
        raise AssertionError("model-routed prefilter ids differ from the "
                             "exact scan")
    rec = {r: recall_of(res, gt_ids, ids) for r, ids in groups.items()}
    batch_rec = recall_of(res, gt_ids)
    if "graph" in rec and rec["graph"] < RECALL_MIN:
        raise AssertionError(f"model-routed graph recall {rec['graph']:.4f}"
                             f" < {RECALL_MIN}")
    if batch_rec < RECALL_MIN:
        raise AssertionError(f"model-routed batch recall {batch_rec:.4f} < "
                             f"{RECALL_MIN}")
    log(f"[slice E] model-routed recall@{K} per route {rec}, batch "
        f"{batch_rec:.4f}; QPS {qps}, batch {bqps:.1f} queries/s (static "
        f"plan in this process: {static_qps}, batch {static_bqps:.1f}; "
        f"slice A {f32_qps})")
    out["routed"] = dict(counts=counts, static_counts=static_counts,
                         costs=p.costs, recall=rec, batch_recall=batch_rec,
                         qps=qps, batch_qps=bqps, static_qps=static_qps,
                         static_batch_qps=static_bqps, launches=launches,
                         explain=explain(p))

    # -- 3. telemetry at full width (the static plan, so that every route
    # and the graph route's introspection run) -------------------------------
    static = PlannerConfig()
    tel = Telemetry(introspect=True, spans=True, shadow=0.05)
    stats = {}

    def keep_stats(g, r, st, s):
        if st is not None:
            stats[g.route] = (g.ids, st, r)

    # in turns, telemetry on then off, twice: the same plan each time
    walls, off_walls, results, plans = [], [], [], []
    for _ in range(2):
        idx.attach_telemetry(tel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_, p_ = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                                 layout="fused", planner=static,
                                 return_plan=True, on_group=keep_stats)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        results.append(r_)
        plans.append(p_)
        idx.attach_telemetry(None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                                layout="fused", planner=static)
        torch.cuda.synchronize()
        off_walls.append(time.perf_counter() - t0)
    traces = list(tel.traces)
    nq = len(q_all)
    if len(traces) != 2 * nq or len({t.qid for t in traces}) != 2 * nq:
        raise AssertionError(f"{len(traces)} traces for 2 calls of {nq}")
    for c in range(2):
        # traces follow the groups, each group's queries in batch order
        order = np.concatenate([g.ids for g in plans[c].groups])
        for t, qi in zip(traces[c * nq:(c + 1) * nq], order):
            if (t.band, t.route) != (plans[c].routes[qi],
                                     plans[c].realized[qi]):
                raise AssertionError(f"trace {t.qid} ({t.band}, {t.route}) "
                                     f"differs from query {qi}'s plan")
    g_ids, g_stats, g_res = stats["graph"]
    if not torch.equal(g_stats.hops, g_res.n_expanded):
        raise AssertionError("hops differ from n_expanded")
    graph_traces = [t for t in traces[nq:] if t.band == "graph"]
    if [t.n_expanded for t in graph_traces] != g_stats.hops.tolist():
        raise AssertionError("traced n_expanded differs from hops")
    # the same plan without telemetry: ids and keys bit for bit
    for f in ("ids", "primary", "secondary", "n_expanded", "n_dist"):
        if not torch.equal(getattr(results[1], f), getattr(plain, f)):
            raise AssertionError(f"{f} with telemetry (introspect) differs "
                                 "from the same plan without it")
    ops.reset_launches()
    n_audit = tel.shadow.flush()
    torch.cuda.synchronize()
    shadow_launches = dict(ops.LAUNCHES)
    if shadow_launches["gather_dist_tile"] <= 0:
        raise AssertionError("the shadow oracle launched no gather_dist_tile")
    table = tel.shadow.recall_table()
    pre = [r for r in table if r["route"] == "prefilter"]
    if not pre or any(r["recall"] != 1.0 for r in pre):
        raise AssertionError(f"prefilter shadow recall not 1.0: {pre}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "traces.jsonl")
        tel.traces.dump_jsonl(path)
        if [asdict(t) for t in load_jsonl(path)] != [asdict(t)
                                                    for t in traces]:
            raise AssertionError("the trace JSONL does not load back equal")
    health = render_health(tel.health_report())
    bands = {}
    for t in traces:
        if t.dead_ends is not None:
            b = bands.setdefault(sel_band(t.sel), [0, 0, 0, 0])
            b[0] += 1
            b[1] += t.dead_ends
            b[2] += t.n_expanded
            b[3] += t.sat_step
    band_rows = {b: dict(queries=v[0], dead_end_rate=v[1] / max(v[2], 1),
                         mean_hops=v[2] / v[0], mean_sat_step=v[3] / v[0])
                 for b, v in sorted(bands.items())}
    log(f"[slice E] telemetry: {len(traces)} traces over 2 calls; "
        f"introspection {introspection_summary(traces)}")
    log(f"[slice E] dead ends per selectivity band (graph route, {N} rows): "
        f"{band_rows}")
    log(f"[slice E] shadow audits {n_audit} (launches of the oracle's scan "
        f"{shadow_launches}): {table}")
    log(f"[slice E] span totals us (2 calls): "
        f"{ {k: round(v, 1) for k, v in tel.spans.totals_us().items()} }")
    for line in health.splitlines():
        log(f"[slice E] health | {line}")
    err_grid = heldout_error(model, traces)
    recal = tel.maybe_recalibrate(idx, require_drift=False)
    err_after = heldout_error(idx.cost_model, traces)
    log(f"[slice E] held-out median relative error of the grid model on "
        f"these traces {err_grid:.4f}; maybe_recalibrate: swapped "
        f"{recal.swapped} ({recal.reason}); after it {err_after:.4f}")
    on_qps, off_qps = nq / walls[1], nq / off_walls[1]
    log(f"[slice E] batch QPS with telemetry {on_qps:.1f}, without "
        f"{off_qps:.1f} (first turn {nq / walls[0]:.1f}, "
        f"{nq / off_walls[0]:.1f})")
    recounts = None
    if recal.swapped:
        _, rp = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                                layout="fused", return_plan=True)
        recounts = {g.route: len(g.ids) for g in rp.groups}
        log(f"[slice E] routes under the refit model: {recounts}")
    out["telemetry"] = dict(
        dead_ends_by_band=band_rows,
        introspection=introspection_summary(traces), shadow=table,
        shadow_audits=n_audit, shadow_launches=shadow_launches,
        spans_us=tel.spans.totals_us(), heldout_grid=err_grid,
        recal_swapped=recal.swapped, recal_reason=recal.reason,
        heldout_after=err_after, routes_after_recal=recounts,
        qps_on=on_qps, qps_off=off_qps, first_qps_on=nq / walls[0],
        first_qps_off=nq / off_walls[0])
    idx.attach_cost_model(None)
    del results, plain, res

    # -- 4. cost-driven compaction ------------------------------------------
    n_batches, step = E_INSERTS, E_INSERT_ROWS
    M = n_batches * step
    rng = np.random.default_rng(1)
    std = idx.xb.std(0).cpu().numpy()
    src = rng.integers(0, N, M)
    xv = (idx.xb[torch.as_tensor(src, device=dev)].cpu().numpy()
          + rng.normal(size=(M, D)) * 0.1 * std).astype(np.float32)
    bits = rng.random((M, ds.attr.n_bits)) < 0.5
    sidx = StreamingJAGIndex(idx, compact_frac=0.25)
    sidx.attach_cost_model(model)
    evens = []
    compacted_at = None
    for i in range(n_batches):
        rows = slice(i * step, (i + 1) * step)
        seen = sidx.delta.n + step           # the delta the insert judges
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sidx.insert(xv[rows], subset_table(bits[rows], ds.attr.n_bits,
                                                 device=dev))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if rep["compacted"]:
            # the decision the insert took, on the rows it saw: a wrapper
            # holding the same delta
            compacted_at = i
            probe = StreamingJAGIndex(idx, compact_frac=0.25)
            probe.attach_cost_model(model)
            tail = slice((i + 1) * step - seen, (i + 1) * step)
            probe.delta.append(xv[tail], subset_table(
                bits[tail], ds.attr.n_bits, device=dev))
            tax, cost, fire = probe.compaction_break_even()
            del probe
        else:
            tax, cost, fire = sidx.compaction_break_even()
        if not (np.isfinite(tax) and np.isfinite(cost)):
            raise AssertionError(f"break-even not finite: {tax}, {cost}")
        evens.append(dict(delta_rows=seen, tax_us=tax,
                          compact_us=cost, fires=fire,
                          compacted=rep["compacted"], insert_s=secs))
        log(f"[slice E] insert {i + 1}: delta {seen} rows; "
            f"predicted tax {tax:.3f} us/query x horizon "
            f"{sidx.query_horizon} = {tax * sidx.query_horizon / 1e6:.3f} s"
            f" vs compaction {cost / 1e6:.3f} s: fires {fire}; compacted "
            f"{rep['compacted']} ({secs:.2f} s)")
    out["break_even"] = evens
    xcat = torch.cat([idx.xb, torch.as_tensor(xv, device=dev)])
    gt_cat = exact_filtered_knn(xcat, sidx.attr, q_all, ds.filt, k=K,
                                use_kernel=True).ids.cpu().numpy()
    res, p = sidx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                              layout="fused", return_plan=True)
    groups = {g.route: g.ids for g in p.groups}
    if "prefilter" in groups and not np.array_equal(
            res.ids.cpu().numpy()[groups["prefilter"]],
            gt_cat[groups["prefilter"]]):
        raise AssertionError("streamed prefilter ids differ from the exact "
                             f"scan over {N + M} rows")
    if "graph" in groups and recall_of(res, gt_cat, groups["graph"]) \
            < RECALL_MIN:
        raise AssertionError(f"streamed graph recall < {RECALL_MIN}")
    if sidx.delta.n:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sidx.executor.merge(res, sidx.executor.delta(q_all, ds.filt, k=K),
                            k=K)
        torch.cuda.synchronize()
        out["delta_merge_s"] = time.perf_counter() - t0
        log(f"[slice E] delta scan of {sidx.delta.n} rows and merge for "
            f"{len(q_all)} queries: {out['delta_merge_s'] * 1e3:.2f} ms "
            f"(the model's tax at this delta: "
            f"{evens[-1]['tax_us'] * len(q_all) / 1e3:.2f} ms a batch)")
    # the streamed batch with shadow audits: each pending audit holds the
    # base and delta tensors, and the flush concatenates one at a time
    stel = sidx.attach_telemetry(Telemetry(shadow=0.05))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for _ in range(2):
        sidx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                         layout="fused")
    queued = torch.cuda.max_memory_allocated() - before
    ops.reset_launches()
    n_audit = stel.shadow.flush()
    torch.cuda.synchronize()
    flushed = torch.cuda.max_memory_allocated() - before
    stable = stel.shadow.recall_table()
    pre = [r for r in stable if r["route"].startswith("prefilter")]
    if not pre or any(r["recall"] != 1.0 for r in pre):
        raise AssertionError(f"streamed prefilter shadow recall not 1.0: "
                             f"{pre}")
    if ops.LAUNCHES["gather_dist_tile"] <= 0:
        raise AssertionError("the streamed shadow oracle launched no "
                             "gather_dist_tile")
    sidx.attach_telemetry(None)
    log(f"[slice E] streamed batch with shadow audits over {N} + "
        f"{sidx.delta.n} rows: {n_audit} audits, {stable}; memory peak "
        f"above the served state {queued / 2 ** 20:.1f} MiB while serving "
        f"two calls, {flushed / 2 ** 20:.1f} MiB through the flush (one "
        f"concatenated copy {(N + sidx.delta.n) * D * 4 / 2 ** 20:.1f} MiB)")
    out["streamed_shadow"] = dict(audits=n_audit, table=stable,
                                  peak_serving_mib=queued / 2 ** 20,
                                  peak_flush_mib=flushed / 2 ** 20)
    del xcat, res
    out["compacted_at_insert"] = compacted_at
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice E] {out['phase_s']:.1f} s")
    return out


def build_slice_f(torch, np, dev, n=F_N, n_sift=F_SIFT_N):
    """Slice F's data and builds on the card: msturing_subset (N rows, d
    100, seed 5) under the JAG union index, ``build_unfiltered`` (with
    RWalks' diffusion over it) and ``ShardedJAGIndex`` over F_SHARDS copies
    of the card; sift_like (d 128, 12 labels, seed 6) under the stitched
    index. Returns the phase's context (a namespace)."""
    from types import SimpleNamespace
    from repro_torch.core import baselines as BL
    from repro_torch.core.filters import popcount
    from repro_torch.core.ground_truth import exact_filtered_knn
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.data import synthetic
    from repro_torch.serve.sharded import ShardedJAGIndex

    t_phase = time.perf_counter()
    D, nq = 100, F_QUERIES
    if n != F_N or n_sift != F_SIFT_N:
        log(f"[slice F] cut: msturing_subset N {F_N} -> {n}, sift_like N "
            f"{F_SIFT_N} -> {n_sift}")
    ds = synthetic.msturing_subset(n=n, d=D, b=nq, seed=5, device=dev)
    sift = synthetic.sift_like(n=n_sift, d=128, b=nq, n_labels=12, seed=6,
                               device=dev)
    c = SimpleNamespace(dev=dev, t_phase=t_phase, ds=ds, sift=sift,
                        mesh=[dev] * F_SHARDS, builds={})
    c.xb = torch.as_tensor(ds.xb, device=dev)
    c.q = torch.as_tensor(ds.queries, device=dev)
    c.req = popcount(ds.filt.data["bits"]).cpu().numpy()
    c.qs = torch.as_tensor(sift.queries, device=dev)
    cfg = JAGConfig(**F_BUILD, ov_max=2 * F_BUILD["batch_size"])
    log(f"[slice F] msturing_subset N={n} d={D} ({nq} queries, required "
        f"bits {sorted(set(c.req.tolist()))}, seed 5); sift_like "
        f"N={n_sift} d=128, 12 labels ({nq} queries, seed 6); builds at "
        f"degree {cfg.degree}, ls_build {cfg.ls_build}, cand_pool "
        f"{cfg.cand_pool}, batch {cfg.batch_size}")

    def timed_build(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        c.builds[name] = time.perf_counter() - t0
        log(f"[slice F] build {name}: {c.builds[name]:.1f} s")
        return r

    c.jag = timed_build("jag", lambda: JAGIndex.build(c.xb, ds.attr, cfg,
                                                      device=dev))
    c.unf = timed_build("unfiltered", lambda: BL.build_unfiltered(
        c.xb, ds.attr, cfg, device=dev))
    c.sh = timed_build(f"sharded (S={F_SHARDS})",
                       lambda: ShardedJAGIndex.build(c.xb, ds.attr, cfg,
                                                     mesh=c.mesh))
    c.st = timed_build("stitched (12 labels)", lambda: BL.StitchedLabelIndex(
        sift.xb, sift.attr, cfg, device=dev))
    c.rw = timed_build("rwalks (m 5, depth 3, over unfiltered)",
                       lambda: BL.build_rwalks(c.xb, ds.attr, cfg, m=5,
                                               depth=3, h=0.1, index=c.unf))
    log(f"[slice F] degree: jag {c.jag.degree_stats()}, unfiltered "
        f"{c.unf.degree_stats()}")
    c.gt_ids = exact_filtered_knn(c.xb, c.jag.attr, c.q, ds.filt, k=10,
                                  use_kernel=True).ids.cpu().numpy()
    c.gts = exact_filtered_knn(torch.as_tensor(sift.xb, device=dev),
                               sift.attr, c.qs, sift.filt, k=10,
                               use_kernel=True).ids.cpu().numpy()
    return c


def _f_recall(res, want):
    from repro_torch.core.recall import recall_at_k
    return recall_at_k(res.ids.cpu().numpy(),
                       res.primary.cpu().numpy() == 0.0, want)


def run_slice_f1(torch, np, c, K, LS) -> dict:
    """F1, the paper's comparison: one batch through each algorithm at
    k = K, ls = LS; per algorithm and required-bits band, recall@K against
    the card's exact scan, QPS of a second run (the band alone) and mean
    n_dist. Every gate raises; returns the report."""
    from repro_torch.core import baselines as BL
    from repro_torch.core.filters import matches

    ds, q, dev = c.ds, c.q, c.dev
    jag, unf, rw, st = c.jag, c.unf, c.rw, c.st
    algos = {
        "jag search": (lambda qq, ff: jag.search(qq, ff, k=K, ls=LS), jag),
        "jag search_auto": (lambda qq, ff: jag.search_auto(
            qq, ff, k=K, ls=LS), jag),
        "post_filter": (lambda qq, ff: BL.post_filter_search(
            unf, qq, ff, k=K, ls=LS), unf),
        "binary": (lambda qq, ff: BL.binary_search(unf, qq, ff, k=K, ls=LS),
                   unf),
        "acorn": (lambda qq, ff: BL.acorn_search(unf, qq, ff, k=K, ls=LS),
                  unf),
        "rwalks": (lambda qq, ff: BL.rwalks_search(rw, qq, ff, k=K, ls=LS),
                   unf),
        # the same post-filtering over JAG's graph: search_auto's
        # postfilter route
        "post_filter@jag": (lambda qq, ff: BL.post_filter_search(
            jag, qq, ff, k=K, ls=LS), jag),
    }
    bands = {int(b): np.flatnonzero(c.req == b) for b in np.unique(c.req)}
    out = {"algos": {}}

    def serve(name, fn, attr, qq, ff, want, groups):
        res = fn(qq, ff)
        torch.cuda.synchronize()
        hit = (res.primary == 0.0) & (res.ids >= 0)
        ok = matches(ff, attr.gather(res.ids.clamp_min(0)))
        if bool((hit & ~ok).any()):
            raise AssertionError(f"{name} returned {int((hit & ~ok).sum())}"
                                 f" ids that fail their filter")
        rec = _f_recall(res, want)
        row = out["algos"][name] = {"recall": float(rec.mean()),
                                    "bands": {}}
        for b, ids in groups.items():
            idt = torch.as_tensor(ids, device=dev)
            qb, fb = qq[idt], ff.take(ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rb = fn(qb, fb)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rr = _f_recall(rb, want[ids])
            nd = float(rb.n_dist.double().mean())
            row["bands"][b] = dict(queries=int(ids.size), recall=float(
                rr.mean()), qps=ids.size / secs, n_dist=nd)
            log(f"[slice F] {name:15s} {b:>11s}: {ids.size:4d} queries, "
                f"recall@{K} {rr.mean():.4f}, {ids.size / secs:9.1f} QPS, "
                f"mean n_dist {nd:.1f}")
        log(f"[slice F] {name:15s} all: recall@{K} {rec.mean():.4f}")
        return res, rec

    res, rec = {}, {}
    for name, (fn, idx) in algos.items():
        res[name], rec[name] = serve(
            name, fn, idx.attr, q, ds.filt, c.gt_ids,
            {f"{b} bits": ids for b, ids in bands.items()})
    _, rec["stitched"] = serve(
        "stitched", lambda qq, ff: st.search(qq, ff, k=K, ls=LS),
        c.sift.attr, c.qs, c.sift.filt, c.gts,
        {"all labels": np.arange(len(c.qs))})

    zero = bands[0]
    low = np.asarray(ds.selectivity) < 0.02
    row = out["gates"] = dict(
        low_queries=int(low.sum()),
        jag_low=float(rec["jag search"][low].mean()),
        post_low=float(rec["post_filter"][low].mean()),
        post_sel1=float(rec["post_filter"][zero].mean()),
        post_jag_sel1=float(rec["post_filter@jag"][zero].mean()),
        auto=float(rec["jag search_auto"].mean()),
        stitched=float(rec["stitched"].mean()))
    # at selectivity 1 every id passes, so post-filtering returns the
    # unfiltered traversal's top K on the same graph, id for id
    sel1 = torch.as_tensor(zero, device=dev)
    unfilt = unf.search_unfiltered(q[sel1], k=K, ls=LS)
    same1 = torch.equal(res["post_filter"].ids[sel1], unfilt.ids)
    log(f"[slice F] gates: {row}; post_filter at selectivity 1 equals the "
        f"unfiltered traversal's ids: {same1}")
    if not same1:
        raise AssertionError("post_filter at selectivity 1 differs from the "
                             "unfiltered traversal on the same graph")
    if row["post_jag_sel1"] <= 0.9:
        raise AssertionError("post-filtering over JAG's graph at selectivity"
                             f" 1: recall {row['post_jag_sel1']:.4f} <= 0.9")
    if not row["jag_low"] > row["post_low"] + 0.15:
        raise AssertionError(f"JAG's low-selectivity recall "
                             f"{row['jag_low']:.4f} is not above "
                             f"post_filter's {row['post_low']:.4f} by more "
                             "than 0.15")
    if row["auto"] < RECALL_MIN:
        raise AssertionError(f"search_auto recall {row['auto']:.4f} < "
                             f"{RECALL_MIN}")
    # the stitched index routes each query to its label's sub-graph and
    # maps the local ids through that label's id table
    qlab = c.sift.filt.data["label"].cpu().numpy()
    sres = st.search(c.qs, c.sift.filt, k=K, ls=LS)
    for lab, (idx, gids) in st.sub.items():
        sel = torch.as_tensor(np.flatnonzero(qlab == lab), device=dev)
        r = idx.search_unfiltered(c.qs[sel], k=K, ls=LS)
        mapped = torch.where(r.ids >= 0, gids[r.ids.clamp_min(0).long()], -1)
        if not torch.equal(sres.ids[sel], mapped):
            raise AssertionError(f"stitched label {lab}: ids differ from its "
                                 "sub-index's search mapped to global ids")
    return out


def run_slice_f2(torch, np, c, model, K, LS, MI) -> dict:
    """F2, sharded serving: S = 1 adopting the union index, S = F_SHARDS on
    one card (exact routes bit for bit, graph recall per band, packed
    gathers, the shards' kernel calls replayed, shadow audits, cost
    routing at the per-shard shape, make_serve_step). Every gate raises;
    returns the report."""
    from repro_torch.core.distributed import (ShardedServeConfig,
                                              make_serve_step)
    from repro_torch.core.quantized import quantize_int8
    from repro_torch.core.recall import recall_at_k
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import Telemetry
    from repro_torch.serve import sharded as SH
    from repro_torch.serve.planner import PlannerConfig
    from repro_torch.serve.sharded import ShardedJAGIndex

    q, filt, jag, sh, S = c.q, c.ds.filt, c.jag, c.sh, F_SHARDS
    nq, gt_ids = len(q), c.gt_ids
    out = {}
    force_pre = PlannerConfig(prefilter_max_sel=1.1, postfilter_min_sel=1.2)
    fields = ("ids", "primary", "secondary", "n_expanded", "n_dist")

    def same(a, b, what, with_vlog=False):
        for f in fields + (("vlog",) if with_vlog else ()):
            x, y = getattr(a, f), getattr(b, f)
            if x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"{what}: {f} differs")

    # S = 1 adopts the union index without a rebuild
    sh1 = ShardedJAGIndex.from_shards([jag])
    if sh1.xb[0].data_ptr() != jag.xb.data_ptr():
        raise AssertionError("from_shards([jag]) copied the rows")
    for pname, planner in (("default", None), ("force-prefilter",
                                               force_pre)):
        a = jag.search_auto(q, filt, k=K, ls=LS, planner=planner)
        b = sh1.search_auto(q, filt, k=K, ls=LS, planner=planner)
        same(b, a, f"S=1 {pname}", with_vlog=planner is not None)
        if planner is None and b.vlog.shape[1] != 0:
            raise AssertionError("the sharded graph route's vlog has width "
                                 f"{b.vlog.shape[1]}")
    log("[slice F] S=1 from_shards([jag]): search_auto equals the index's "
        "bit for bit under the default and force-prefilter planners (vlog "
        "width 0 on the graph and postfilter routes)")
    del sh1

    # S shards, exact routes: every field bit for bit; the shards' kernel
    # calls kept for their plain versions; the sharded path's launches
    want = {m: jag.search_auto(q, filt, k=K, ls=LS, planner=force_pre,
                               mode=m) for m in ("per_query", "batch")}
    torch.cuda.synchronize()
    per_call = nq * (3 * K + 2) * 4
    ops.reset_launches()
    with KernelCalls(torch, ops, ("gather_dist_tile",
                                  "bitset_dist")) as calls:
        for m in ("per_query", "batch"):
            SH.reset_gathers()
            got = sh.search_auto(q, filt, k=K, ls=LS, planner=force_pre,
                                 mode=m)
            torch.cuda.synchronize()
            if SH.GATHERS != {"transfers": S, "bytes": S * per_call}:
                raise AssertionError(f"prefilter ({m}) gathers "
                                     f"{SH.GATHERS}, not {S} of {per_call}")
            same(got, want[m], f"S={S} force-prefilter {m}", with_vlog=True)
    launches = {k: ops.LAUNCHES[k] for k in ("gather_dist_tile",
                                             "bitset_dist")}
    out["launches"] = {"sharded": launches}
    log(f"[slice F] S={S} exact route (force-prefilter, per_query and "
        f"batch) equals the union index bit for bit; launches (sharded) "
        f"{launches}; {S} packed gathers of {per_call} bytes a call")
    for k_, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the sharded scans launched no {k_}")
    out["replayed"] = check_recorded(torch, ops, ref, calls.calls)
    del calls
    log(f"[slice F] the shards' kernel calls against their plain versions "
        f"(distinct signatures, max error): {out['replayed']}")
    for k_ in launches:
        if not out["replayed"][k_]["signatures"]:
            raise AssertionError(f"no {k_} call was kept")

    # S shards, the default planner: recall per routed band
    res_u, p_u = jag.search_auto(q, filt, k=K, ls=LS, return_plan=True)
    res_s, p_s = sh.search_auto(q, filt, k=K, ls=LS, return_plan=True)
    if [g.route for g in p_s.groups] != [g.route for g in p_u.groups]:
        raise AssertionError("the sharded plan differs from the union's")
    rec_u, rec_s = _f_recall(res_u, gt_ids), _f_recall(res_s, gt_ids)
    out["routed"] = {}
    for g in p_s.groups:
        ru, rs = float(rec_u[g.ids].mean()), float(rec_s[g.ids].mean())
        out["routed"][g.route] = dict(queries=int(g.ids.size), union=ru,
                                      sharded=rs)
        log(f"[slice F] S={S} {g.route}: {g.ids.size} queries, recall@{K} "
            f"sharded {rs:.4f}, union {ru:.4f}")
        if rs < ru - F_MARGIN:
            raise AssertionError(f"S={S} {g.route} recall {rs:.4f} < union "
                                 f"{ru:.4f} - {F_MARGIN}")
    for route, call in (
            ("graph", lambda: sh.executor.graph(q, filt, k=K, ls=LS,
                                                max_iters=MI)),
            ("postfilter", lambda: sh.executor.postfilter(
                q, filt, k=K, ls=LS, max_iters=MI))):
        SH.reset_gathers()
        call()
        if SH.GATHERS != {"transfers": S, "bytes": S * per_call}:
            raise AssertionError(f"{route} gathers {SH.GATHERS}")

    # telemetry: the shadow oracle over the shards' rows, shard-major
    tel = sh.attach_telemetry(Telemetry(shadow=0.05))
    sh.search_auto(q, filt, k=K, ls=LS)
    table = tel.shadow.recall_table()
    sh.attach_telemetry(None)
    pre = [r for r in table if r["route"] == "prefilter"]
    log(f"[slice F] S={S} shadow audits: {table}")
    if not pre or any(r["recall"] != 1.0 for r in pre):
        raise AssertionError(f"sharded prefilter shadow recall not 1.0: "
                             f"{pre}")
    out["shadow"] = table

    # cost routing by slice E's model at the per-shard shape
    sh.attach_cost_model(model)
    router = sh.executor.cost_router(k=K, ls=LS, filt=filt)
    if router is None or router.n != sh.n_loc:
        raise AssertionError(f"the sharded router predicts at n "
                             f"{getattr(router, 'n', None)}, not {sh.n_loc}")
    res_m, p_m = sh.search_auto(q, filt, k=K, ls=LS, return_plan=True)
    sh.attach_cost_model(None)
    counts = {g.route: int(g.ids.size) for g in p_m.groups}
    rec_m = _f_recall(res_m, gt_ids)
    out["cost_routed"] = dict(counts=counts, recall=float(rec_m.mean()))
    log(f"[slice F] S={S} routed by slice E's model at n = {sh.n_loc}: "
        f"{counts}, recall@{K} {rec_m.mean():.4f} (static plan "
        f"{ {g.route: int(g.ids.size) for g in p_s.groups} })")

    # make_serve_step over the shards' arrays, two chunkings
    n_loc = sh.n_loc
    codes, scale = quantize_int8(c.xb)
    codes = [codes[s * n_loc:(s + 1) * n_loc] for s in range(S)]
    route_g = sh.search(q, filt, k=K, ls=LS, max_iters=MI)
    rec_g = float(_f_recall(route_g, gt_ids).mean())
    out["serve_step"] = {}
    for variant in ("f32", "int8_reg"):
        runs = {}
        for chunk in (128, 64):
            step = make_serve_step(c.mesh, ShardedServeConfig(
                k=K, ls=LS, max_iters=MI, query_chunk=chunk), "subset",
                "subset", n_bits=filt.n_bits, variant=variant)
            args = (sh.graph, sh.xb if variant == "f32" else codes,
                    sh.xb_norm, sh.attr_data, sh.entry, q, filt.data)
            args += () if variant == "f32" else (scale,)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[chunk] = step(*args)
            torch.cuda.synchronize()
            runs[chunk] += (time.perf_counter() - t0,)
        (i1, p1, s1, t1), (i2, p2, s2, t2) = runs[128], runs[64]
        if not (torch.equal(i1, i2) and torch.equal(p1, p2)
                and torch.equal(s1, s2)):
            raise AssertionError(f"make_serve_step {variant}: query_chunk "
                                 "128 and 64 differ")
        rec_v = float(recall_at_k(i1.cpu().numpy(), p1.cpu().numpy() == 0.0,
                                  gt_ids).mean())
        out["serve_step"][variant] = dict(recall=rec_v, s_128=t1, s_64=t2)
        log(f"[slice F] make_serve_step {variant}: query_chunk 128 and 64 "
            f"equal bit for bit; recall@{K} {rec_v:.4f}; {t1:.2f} s and "
            f"{t2:.2f} s")
        if variant == "f32":
            agree = float((i1 == route_g.ids).all(dim=1).float().mean())
            log(f"[slice F] make_serve_step f32 against the sharded graph "
                f"route (k {K}, ls {LS}, max_iters {MI}): recall {rec_v:.4f}"
                f" vs {rec_g:.4f}, {agree:.4f} of the queries' ids equal")
            if rec_v != rec_g:
                raise AssertionError(f"make_serve_step f32 recall {rec_v} "
                                     f"differs from the graph route's "
                                     f"{rec_g}")
    return out


def run_slice_f(torch, np, dev, model, K, LS, MI, n=F_N,
                n_sift=F_SIFT_N) -> dict:
    """Slice F: the paper's baselines (F1) and sharded serving (F2) on
    their own data; ``model`` is slice E's calibrated cost model. Every
    gate raises; returns the phase's report."""
    c = build_slice_f(torch, np, dev, n=n, n_sift=n_sift)
    out = {"n": n, "n_sift": n_sift, "shards": F_SHARDS,
           "build_s": c.builds}
    out["baselines"] = run_slice_f1(torch, np, c, K, LS)
    out.update(run_slice_f2(torch, np, c, model, K, LS, MI))
    out["phase_s"] = time.perf_counter() - c.t_phase
    log(f"[slice F] {out['phase_s']:.1f} s (builds "
        f"{sum(c.builds.values()):.1f} s)")
    return out

def run_slice_g_routes(torch, arrays, dev, ds, q_all, groups, K, LS,
                       MI) -> dict:
    """Slice G, part (c): slice A's index at full width, back on the card
    from ``arrays`` (its ``_save_arrays()``, kept on the host since slice
    E: no rebuild), each route at slice A's batch group through the op
    recorder (launches, gathers and host syncs per call) and the profiler
    (device busy share, idle gaps, device kernels per iteration). Every
    gate raises; returns this part's report."""
    from repro_torch.analysis import audit as AU
    from repro_torch.core.jag import JAGIndex
    from repro_torch.kernels import ops
    from repro_torch.launch.trace_stats import (GATHER_OPS, profile, record,
                                                spec)

    t_phase = time.perf_counter()
    idx = JAGIndex.from_arrays(arrays, device=dev)
    torch.cuda.synchronize()
    out = {"restore_s": time.perf_counter() - t_phase}
    ex = idx.executor
    N = int(idx.xb.shape[0])
    adj = spec(idx.graph).key
    blocks = -(-N // 4096)

    def group(route):
        ids = torch.as_tensor(groups[route], device=q_all.device)
        return q_all[ids].contiguous(), ds.filt.take(groups[route])

    qp, fp = group("prefilter")
    qg, fg = group("graph")
    qo, fo = group("postfilter")
    routes = {
        "prefilter": (qp, lambda: ex.prefilter(qp, fp, k=K)),
        "graph:fused:f32": (qg, lambda: ex.graph(qg, fg, k=K, ls=LS,
                                                 max_iters=MI,
                                                 layout="fused")),
        "graph:default:f32": (qg, lambda: ex.graph(qg, fg, k=K, ls=LS,
                                                   max_iters=MI)),
        "postfilter": (qo, lambda: ex.postfilter(qo, fo, k=K, ls=LS,
                                                 max_iters=MI)),
    }
    out["routes"] = {}
    for name, (q, call) in routes.items():
        call()                               # its closure built, warm
        torch.cuda.synchronize()
        ops.reset_launches()
        _, recs = record(call)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        st = AU.analyze_record(recs, n_rows=N, adj=adj)
        iters = st["adjacency_gathers"]
        budget = AU.host_sync_budget(name, [iters], MI)
        aten_rows = sum(1 for r in recs if r.name in GATHER_OPS
                        and r.inputs[0].shape[:1] == (N,)
                        and r.inputs[0].key != adj)
        prof = profile(call)
        steps = iters if iters else blocks
        row = dict(
            queries=int(q.shape[0]), iterations=iters, host_syncs=st["host_syncs"],
            host_sync_budget=budget,
            gathers_per_expansion=st["gathers_per_expansion"],
            aten_row_gathers=aten_rows, f64_ops=st["f64_ops"],
            launches=launches, launches_per_step={
                k: v / steps for k, v in launches.items()},
            device_kernels=prof["kernel_launches"],
            device_kernels_per_step=prof["kernel_launches"] / steps,
            device_busy_share=prof["device_busy_share"],
            idle_gaps_us=prof["idle_gaps_us"], wall_ms=prof["wall_us"] / 1e3,
            idle_ms=prof["idle_us"] / 1e3,
            idle_at_syncs_ms=prof["idle_at_syncs_us"] / 1e3,
            runtime_syncs=prof["runtime_syncs"],
            dtoh_copies=prof["dtoh_copies"], n_ops=st["n_ops"])
        out["routes"][name] = row
        step = "expansion" if iters else "block"
        log(f"[slice G] {name} ({row['queries']} queries, "
            f"{iters or blocks} {step}s): host syncs {st['host_syncs']} a "
            f"call (budget {budget}; profiler: {prof['runtime_syncs']} "
            f"runtime syncs, {prof['dtoh_copies']} DtoH copies); "
            f"launches per {step} {row['launches_per_step']}; device kernels "
            f"{prof['kernel_launches']} ({row['device_kernels_per_step']:.1f}"
            f" per {step}); gathers per expansion "
            f"{st['gathers_per_expansion']}, aten N-row gathers {aten_rows}; "
            f"device busy {100 * prof['device_busy_share']:.1f}% of "
            f"{row['wall_ms']:.1f} ms, idle {row['idle_ms']:.1f} ms of the "
            f"trace ({row['idle_at_syncs_ms']:.1f} ms in stretches where a "
            f"sync returned), longest idle gaps us "
            f"{[round(g, 1) for g in prof['idle_gaps_us'][:3]]}")
        if st["f64_ops"]:
            raise AssertionError(f"{name}: {st['f64_ops']} f64 op(s)")
        if st["host_syncs"] > budget:
            raise AssertionError(f"{name}: {st['host_syncs']} host syncs, "
                                 f"budget {budget}")
        if prof["kernel_launches"] <= 0:
            raise AssertionError(f"{name}: the profiler saw no kernel")
        if name == "prefilter" and (
                launches.get("gather_dist_tile") != blocks
                or launches.get("bitset_dist") != blocks):
            raise AssertionError(f"prefilter launched {launches}, not "
                                 f"{blocks} of each scan kernel")
        if name == "graph:fused:f32" and (
                launches.get("fused_expand") != iters + 1
                or st["gathers_per_expansion"] != 1 or aten_rows):
            raise AssertionError(
                f"fused graph route: {launches} launches over {iters} "
                f"expansions (+1 seed fetch), {st['gathers_per_expansion']} "
                f"gathers per expansion, {aten_rows} aten N-row gathers")
        if name in ("graph:default:f32", "postfilter") and \
                st["gathers_per_expansion"] != 3:
            raise AssertionError(f"{name}: {st['gathers_per_expansion']} "
                                 "N-row gathers per expansion, not 3")

    del ex, idx
    torch.cuda.empty_cache()
    out["routes_s"] = time.perf_counter() - t_phase
    log(f"[slice G] slice A's routes {out['routes_s']:.1f} s (the index "
        f"back on the card in {out['restore_s']:.1f} s)")
    return out


def run_slice_g(kernels, routes: dict) -> dict:
    """Slice G: the port's static analysis and launch tooling on the card.
    (a) the lint over ``src/repro_torch``; (b) the route audit on the card
    at the audit size, the sharded routes over ``[cuda:0] * 8``; (c)
    ``routes``, the report of ``run_slice_g_routes``; (d) each kernel
    record's share of its bound. Every gate raises; returns the phase's
    report."""
    from repro_torch.analysis import audit as AU
    from repro_torch.analysis.lint import format_report, run_lint

    t_phase = time.perf_counter()
    out = {}
    # (a) the lint: zero unjustified findings, counts per rule
    lint = run_lint()
    for line in format_report(lint):
        log(f"[slice G] lint {line}")
    if not lint.ok:
        raise AssertionError(f"lint: {len(lint.findings)} finding(s), "
                             f"{len(lint.config_errors)} config error(s)")
    out["lint"] = lint.counts()
    # (b) the route audit on the card
    t0 = time.perf_counter()
    audit = AU.run_audit("cuda")
    for line in AU.format_report(audit):
        log(f"[slice G] {line}")
    if audit["violations"]:
        raise AssertionError(f"audit: {audit['violations']}")
    keep = ("gathers_total", "gathers_per_expansion", "host_syncs",
            "host_sync_budget", "iterations", "collectives")
    out["audit"] = {
        "s": time.perf_counter() - t0, "meta": audit["meta"],
        "routes": {n: {k: r[k] for k in keep}
                   for n, r in audit["routes"].items()},
        "sharded": {n: {k: r[k] for k in keep}
                    for n, r in audit["sharded"]["routes"].items()}}
    out.update(routes)
    # (d) each kernel record's share of its bound
    out["bound_share"] = {}
    for name, kr in kernels.items():
        kr["bound_share"] = out["bound_share"][name] = \
            kr["bound_ms"] / kr["ms"]
        log(f"[slice G] {name}: {kr['ms']:.6f} ms, bound "
            f"{kr['bound_ms']:.7f} ms ({kr['bound_by']}), "
            f"{100 * kr['bound_share']:.1f}% of its bound")
    out["phase_s"] = time.perf_counter() - t_phase + routes["routes_s"]
    log(f"[slice G] {out['phase_s']:.1f} s (audit {out['audit']['s']:.1f} "
        f"s, slice A's routes {routes['routes_s']:.1f} s)")
    return out


def _bits(torch, t):
    """A tensor's bytes, for a bit-for-bit comparison (torch.equal holds
    -0.0 equal to 0.0)."""
    return t.detach().reshape(-1).view(torch.uint8)


def run_slice_h(torch, np, dev, seed: int) -> dict:
    """Slice H: the LM training step on the card. qwen3-1.7b at its
    published width and depth, float32 masters and AdamW state from
    ``seed``, remat "full", LM_SHAPES["train_4k"] cut to H_BATCH sequences
    as H_ACCUM microbatches; the first step's loss and grad norm against
    the plain attention's within the bf16 rule; the kernel's launches; a
    checkpoint after step 2 restored onto the card bit for bit; then the
    timed steps. Every gate raises; returns the phase's report."""
    from repro_torch import configs
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.data.pipelines import lm_batch
    from repro_torch.kernels import autograd, ops, ref
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as TT
    from repro_torch.train import (OptConfig, accumulate_grads, global_norm,
                                   init_state, make_train_step)

    t_phase = time.perf_counter()
    lm = dataclasses.replace(configs.get(LM_ARCH).make_config(), remat_policy="full")
    lm32 = dataclasses.replace(lm, dtype=torch.float32)
    full = LM_SHAPES["train_4k"]
    seq, n_tok = full["seq"], H_BATCH * full["seq"]
    log(f"[slice H] {lm.name}: {lm.n_layers} layers, d_model {lm.d_model}, "
        f"vocab {lm.vocab}, {lm.param_count()} params, float32 masters and "
        f"AdamW state, remat {lm.remat_policy}; LM_SHAPES['train_4k'] batch "
        f"{full['batch']} x {seq} cut to {H_BATCH} x {seq} as "
        f"accum={H_ACCUM} microbatches of {H_BATCH // H_ACCUM}, seed {seed}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = TT.init_params(lm, gen, dev).requires_grad_(True)
    state = init_state(params)
    ocfg = OptConfig(warmup_steps=1, total_steps=10)
    step = make_train_step(lambda p, b: TT.loss_fn(lm, p, b), ocfg, H_ACCUM)

    def batch(i):
        return lm_batch(i, H_BATCH, seq, lm.vocab, seed)

    def first_grads(cfg, impl):
        """The first step's loss and grad norm, without the update."""
        ops.reset_launches()
        loss, _, grads = accumulate_grads(
            lambda p, b: TT.loss_fn(cfg, p, b, impl=impl), params, batch(0),
            H_ACCUM)
        gn = float(global_norm(grads))
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        for p in params.parameters():
            p.grad = None
        return float(loss), gn, launches

    # the yardstick: a float32 run (the split-TF32 kernel's forward), and
    # the plain bf16 attention under autograd, from the same weights
    l32, g32, n32 = first_grads(lm32, autograd)
    per_step = lm.n_layers * 2 * H_ACCUM    # forward + remat recompute
    if n32["flash_attention_f32"] != per_step or n32["flash_attention"]:
        raise AssertionError(f"float32 step launched {n32}, not "
                             f"{per_step} of flash_attention_f32")
    lp, gp, np_ = first_grads(lm, ref)
    if any(np_.values()):
        raise AssertionError(f"the plain attention launched {np_}")
    t_checks = time.perf_counter() - t_phase

    # step 1 (warm-up): the kernel's forward, the plain version's backward
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch(0))
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"[slice H] launches in step 1: {launches} (expected "
        f"{lm.n_layers} layers x (forward + remat recompute) x {H_ACCUM} "
        f"microbatches = {per_step} of flash_attention; the backward "
        "launches none)")
    if launches["flash_attention"] != per_step or \
            sum(launches.values()) != per_step:
        raise AssertionError(f"step 1 launched {launches}")
    lk, gk = float(m["loss"]), float(m["grad_norm"])
    gate = {}
    for what, k, p_, f in (("loss", lk, lp, l32), ("grad_norm", gk, gp, g32)):
        noise = abs(p_ - f)
        gate[what] = dict(kernel=k, plain=p_, float32=f, diff=abs(k - p_),
                          bf16_vs_f32=noise, limit=LM_BF16_NOISE * noise)
        log(f"[slice H] step 1 {what}: kernel {k!r}, plain {p_!r}, float32 "
            f"{f!r}; |kernel - plain| {abs(k - p_):.4g} (limit "
            f"{LM_BF16_NOISE * noise:.4g}: {LM_BF16_NOISE} x bf16 vs "
            f"float32, {noise:.4g})")
        if not (math.isfinite(k) and abs(k - p_) <= LM_BF16_NOISE * noise):
            raise AssertionError(f"step 1 {what}: the kernel's {k} against "
                                 f"the plain {p_} (limit "
                                 f"{LM_BF16_NOISE * noise})")

    # steps 2..H_STEPS + 1, timed one by one; the checkpoint after step 2
    metrics, step_s, peak = [m], [], 0
    ckpt = {}
    for i in range(1, H_STEPS + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        metrics.append(m)
        if i == 1:
            ckpt = _slice_h_checkpoint(torch, params, state, lm)
    losses = [float(x["loss"]) for x in metrics]
    norms = [float(x["grad_norm"]) for x in metrics]
    finite = all(bool(torch.isfinite(p).all()) for p in params.parameters())
    if not (finite and all(map(math.isfinite, losses + norms))):
        raise AssertionError(f"slice H: not finite (params {finite}, losses "
                             f"{losses}, grad norms {norms})")
    med = float(np.median(step_s))
    bound = RL.lm_model_flops(lm, H_BATCH, seq, "train") / RL.HW["bf16_flops"]
    log(f"[slice H] losses {losses}, grad norms {norms}")
    log(f"[slice H] step {med:.4f} s (median of {H_STEPS}: "
        f"{', '.join(f'{t:.4f}' for t in step_s)}; step 1 {t_first:.4f} s), "
        f"{n_tok / med:.1f} tokens/s, peak memory {peak / 2 ** 30:.2f} GiB "
        f"({peak / 1e9:.2f} GB); bound {bound:.4f} s "
        f"({RL.lm_model_flops(lm, H_BATCH, seq, 'train'):.4g} flops at "
        f"{RL.HW['bf16_flops']:.3g} flop/s, remat recompute not counted): "
        f"{100 * bound / med:.2f}% of it")
    del params, state, metrics, m
    torch.cuda.empty_cache()
    out = dict(arch=lm.name, batch=H_BATCH, seq=seq, accum=H_ACCUM,
               remat=lm.remat_policy, step_s=step_s, step_median_s=med,
               step1_s=t_first, tokens_per_s=n_tok / med, peak_bytes=peak,
               bound_s=bound, bound_share=bound / med, losses=losses,
               grad_norms=norms, launches=launches, f32_launches=n32,
               first_step=gate, checkpoint=ckpt, checks_s=t_checks)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice H] {out['phase_s']:.1f} s (first-step checks "
        f"{t_checks:.1f} s, checkpoint save {ckpt['save_s']:.1f} s and "
        f"restore {ckpt['restore_s']:.1f} s)")
    return out


def _slice_h_checkpoint(torch, params, state, lm) -> dict:
    """Save the live training state (under the temporary directory),
    restore it onto the card into a template that holds no memory, and
    hold every leaf against the live one bit for bit. The directory is
    removed before returning."""
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.models import transformer as TT
    from repro_torch.train import AdamWState

    live = {"params": params, "opt": state}
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _flatten(live).values())
    root = tempfile.mkdtemp(prefix="slice_h_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        log(f"[slice H] checkpoint: {n_bytes / 1e9:.2f} GB of state, "
            f"{free / 1e9:.1f} GB free where it is written")
        t0 = time.perf_counter()
        save_pytree(live, root, int(state.step), meta={"arch": lm.name})
        save_s = time.perf_counter() - t0
        meta_model = TT.LM(lm, torch.device("meta"))
        tmpl = {"params": meta_model,
                "opt": AdamWState(state.step, {n: torch.empty_like(
                    t, device="meta") for n, t in state.m.items()},
                    {n: torch.empty_like(t, device="meta")
                     for n, t in state.v.items()})}
        t0 = time.perf_counter()
        got, meta = load_pytree(tmpl, root, int(state.step),
                                device=params.embed.device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want, have = _flatten(live), _flatten(got)
    if set(want) != set(have) or meta != {"arch": lm.name}:
        raise AssertionError("checkpoint: the restored tree differs in keys")
    bad = [k for k, w in want.items()
           if have[k].device != w.device or have[k].dtype != w.dtype
           or not torch.equal(_bits(torch, have[k]), _bits(torch, w))]
    if bad:
        raise AssertionError(f"checkpoint: {len(bad)} leaves differ from the "
                             f"live state, e.g. {bad[:3]}")
    log(f"[slice H] checkpoint at step {int(state.step)}: {len(want)} leaves "
        f"saved in {save_s:.1f} s, restored onto the card in "
        f"{restore_s:.1f} s, equal to the live state bit for bit")
    del got, meta_model, tmpl
    torch.cuda.empty_cache()
    return dict(step=int(state.step), leaves=len(want), bytes=n_bytes,
                save_s=save_s, restore_s=restore_s)


class RouteLog:
    """While installed, keeps the ``Routing`` of each ``transformer.route``
    call (one a MoE layer, in layer order), so that a run's dropped tokens
    and the experts it used can be read afterwards. The calls go through
    unchanged."""

    def __init__(self, TT):
        self.TT, self.calls = TT, []

    def __enter__(self):
        self._orig = fn = self.TT.route

        def rec(*args, **kw):
            r = fn(*args, **kw)
            self.calls.append(r)
            return r
        self.TT.route = rec
        return self

    def __exit__(self, *exc):
        self.TT.route = self._orig
        return False

    def dropped(self) -> list:
        return [int((~r.keep).sum()) for r in self.calls]

    def experts_used(self) -> list:
        return [int(r.eidx.unique().numel()) for r in self.calls]

    def token_dropped(self, token: int) -> list:
        """Whether the token at flat index ``token`` was dropped, a layer."""
        return [not bool(r.keep[(r.order == token).nonzero()[0, 0]])
                for r in self.calls]


def run_slice_i(torch, np, dev, seed: int, kernels: dict) -> dict:
    """Slice I: llama4 serving on the card. llama4-scout-17b-a16e at its
    published width, cut to one iRoPE period of I_LAYERS layers, random
    weights from ``seed``; LM_SHAPES["prefill_32k"] cut to I_BATCH prompts
    of I_PROMPT tokens, then I_STEPS greedy decode steps. The kernels
    against their plain versions at the global layer's attention shape;
    in float32 the split-TF32 kernel's prefill against the plain
    attention, and a decode step against a prefill of one more token; in
    bf16 after ``cast_matrices`` the kernel's launches and logits (the
    bf16 rule), then the timed serving calls. Records each kernel's
    launches under ``llama4_launches``. Every gate raises; returns the
    phase's report."""
    from repro_torch import configs
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as TT

    def biggest(t):
        return float(t.float().abs().max())

    t_phase = time.perf_counter()
    full = configs.get(I_ARCH).make_config()
    lm = dataclasses.replace(full, n_layers=I_LAYERS)
    lm32 = dataclasses.replace(lm, dtype=torch.float32)
    B, T, C, E = I_BATCH, I_PROMPT, lm.attn_chunk, lm.n_experts
    shp = LM_SHAPES["prefill_32k"]
    # kernel launches a prefill: 2 a chunked layer (whole chunks, tail)
    want = sum(1 if TT._layer_flags(lm, i)[0] or T <= C or T % C == 0
               else 2 for i in range(lm.n_layers))
    log(f"[slice I] {lm.name}: d_model {lm.d_model}, {lm.n_heads} heads, "
        f"{lm.n_kv_heads} kv heads, head_dim {lm.hd}, d_ff {lm.d_ff}, vocab "
        f"{lm.vocab}, {E} experts top-1 with the shared expert (moe_every "
        f"{lm.moe_every}), capacity factor {lm.capacity_factor}, "
        f"attn_chunk {C}, every {lm.global_every}th layer global (NoPE), "
        f"rope_theta {lm.rope_theta}; seed {seed}")
    log(f"[slice I] depth cut: {full.n_layers} -> {lm.n_layers} layers (one "
        f"iRoPE period: layers 0-2 chunked with RoPE, layer 3 global NoPE), "
        f"{full.param_count()} -> {lm.param_count()} parameters "
        f"({lm.active_param_count()} active a token), to fit one card in "
        f"float32; shape cut: LM_SHAPES['prefill_32k'] batch {shp['batch']} "
        f"x {shp['seq']} -> {B} x {T} (one whole chunk and a tail of "
        f"{T % C}), then {I_STEPS} greedy decode steps")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    # the kernels at the global layer's attention shape (a GQA group of 5)
    shapes = ((B, lm.n_heads, T, lm.hd), (B, lm.n_kv_heads, T, lm.hd),
              (B, lm.n_kv_heads, T, lm.hd))
    fq, fk, fv = (torch.randn(sh, generator=gen, device=dev) for sh in shapes)
    ferr = {"float32": check_flash(torch, ops, ref, fq, fk, fv),
            "bfloat16": check_flash(torch, ops, ref, *(
                t.to(lm.dtype) for t in (fq, fk, fv)))}
    log(f"[slice I] flash_attention at q[{','.join(map(str, shapes[0]))}] "
        f"kv[{','.join(map(str, shapes[1]))}] against the plain version: "
        f"max |d| {ferr['bfloat16']:.4g} (bf16), {ferr['float32']:.4g} "
        "(float32)")
    del fq, fk, fv

    t0 = time.perf_counter()
    params = TT.init_params(lm, gen, dev)
    toks = torch.randint(0, lm.vocab, (B, T), generator=gen, device=dev)

    # float32: the kernel against the plain attention, sum order only
    c32 = TT.init_cache(lm32, B, T + 1, dev)
    ops.reset_launches()
    l32, c32 = TT.prefill(lm32, params, toks, c32)
    torch.cuda.synchronize()
    n32 = (ops.LAUNCHES["flash_attention_f32"], ops.LAUNCHES["flash_attention"])
    log(f"[slice I] float32 prefill: flash_attention_f32 launched {n32[0]} "
        f"times, flash_attention {n32[1]} (expected {want}, 0)")
    if n32 != (want, 0):
        raise AssertionError(f"float32 prefill launched {n32}, not "
                             f"({want}, 0)")
    l32p, _ = TT.prefill(lm32, params, toks, TT.init_cache(lm32, B, T, dev),
                         impl=ref)
    err32 = biggest(l32 - l32p)
    log(f"[slice I] float32 prefill, kernel vs plain attention: max |d| "
        f"{err32:.3g} of largest logit {biggest(l32p):.4g}")
    if err32 > LM_F32_TOL * biggest(l32p):
        raise AssertionError("float32 prefill: the kernel moves the logits "
                             f"by {err32} (> {LM_F32_TOL} of the largest)")

    # decode at position T against a prefill of T + 1 tokens. Capacity
    # makes the MoE depend on the batch: a prefill of T + 1 routes one more
    # token a lane and may drop it or displace another lane's token, where
    # a decode step routes B tokens and drops none. So the gate lifts the
    # capacity to half of one lane's tokens (capacity_factor E / 2; the
    # [E, cap, d_ff] expert batch of cap = N fits no card beside the
    # float32 weights) and holds that nothing was dropped, which makes the
    # MoE the same function of each token in both; the served capacity's
    # figure is printed beside it, with the drops that explain it.
    nxt = l32[:, :lm.vocab].argmax(-1)
    pos = torch.full((B,), T, dtype=torch.int32, device=dev)
    ld, _ = TT.decode_step(lm32, params, c32, nxt, pos)
    toks1 = torch.cat([toks, nxt[:, None]], dim=1)
    del c32
    with RouteLog(TT) as rlog:
        lb, _ = TT.prefill(lm32, params, toks1,
                           TT.init_cache(lm32, B, T + 1, dev))
    served_derr = [biggest(ld[b] - lb[b]) for b in range(B)]
    last_dropped = {b: [i for i, d in enumerate(rlog.token_dropped(
        b * (T + 1) + T)) if d] for b in range(B)}
    del rlog, lb, ld
    lift = dataclasses.replace(lm32, capacity_factor=E / 2)
    torch.cuda.empty_cache()
    c1 = TT.init_cache(lift, 1, T + 1, dev)
    with RouteLog(TT) as rlog:
        la, c1 = TT.prefill(lift, params, toks[:1], c1)
        nxt1 = la[:, :lm.vocab].argmax(-1)
        ld, _ = TT.decode_step(lift, params, c1, nxt1, pos[:1])
        del c1
        lb, _ = TT.prefill(lift, params,
                           torch.cat([toks[:1], nxt1[:, None]], 1),
                           TT.init_cache(lift, 1, T + 1, dev))
    if any(rlog.dropped()):
        raise AssertionError(f"capacity factor {E / 2} still dropped tokens "
                             f"{rlog.dropped()}: the decode check needs none")
    del rlog
    derr = biggest(ld - lb)
    log(f"[slice I] float32 decode at position {T} vs a prefill over {T + 1} "
        f"tokens, capacity lifted (factor {E / 2}, one lane, no token "
        f"dropped): max |d| {derr:.3g} of largest logit {biggest(lb):.4g} "
        f"(limit "
        f"{LM_F32_TOL} of it); at the served capacity, per lane (no gate): "
        f"{', '.join(f'{e:.3g}' for e in served_derr)}, the prefill's last "
        f"token dropped in layers {last_dropped}")
    if derr > LM_F32_TOL * biggest(lb):
        raise AssertionError(f"decode disagrees with prefill by {derr} "
                             f"(> {LM_F32_TOL} of {biggest(lb)})")
    del la, ld, lb, l32

    # bf16 serving: matrices and experts stored in bf16 (the router stays
    # float32); the kernel's launches, and its logits against the plain
    # attention within LM_BF16_NOISE x bf16's own distance to float32
    TT.cast_matrices(params, lm.dtype)
    torch.cuda.empty_cache()
    cache = TT.init_cache(lm, B, T + I_STEPS, dev)
    t_setup = time.perf_counter() - t0
    ops.reset_launches()
    with RouteLog(TT) as rlog:
        logits, cache = TT.prefill(lm, params, toks, cache)
    torch.cuda.synchronize()
    lc = dict(ops.LAUNCHES)
    dropped, used, cap = rlog.dropped(), rlog.experts_used(), \
        rlog.calls[0].cap
    del rlog
    log(f"[slice I] launches in the bf16 prefill: {lc} (expected {want} of "
        f"flash_attention: 2 a chunked layer, 1 the global one)")
    if lc["flash_attention"] != want or sum(lc.values()) != want:
        raise AssertionError(f"bf16 prefill launched {lc}, not {want} of "
                             "flash_attention and nothing else")
    kernels["flash_attention"]["llama4_launches"] = lc["flash_attention"]
    kernels["flash_attention_f32"]["llama4_launches"] = n32[0]
    log(f"[slice I] MoE: {B * T} tokens a layer at cap {cap} an expert "
        f"({E} x {cap} = {E * cap} expert rows); dropped by capacity a "
        f"layer: {dropped}; experts used a layer: {used}")
    lp, _ = TT.prefill(lm, params, toks, cache, impl=ref)
    noise = biggest(lp.float() - l32p)
    tol = LM_BF16_NOISE * noise
    err = biggest(logits - lp)
    log(f"[slice I] bf16 prefill, kernel vs plain attention: max |d| "
        f"{err:.4g} (limit {tol:.4g}: {LM_BF16_NOISE} x bf16 vs float32, "
        f"{noise:.4g})")
    if err > tol:
        raise AssertionError(f"bf16 prefill: the kernel moves the logits by "
                             f"{err} (> {tol})")
    del lp, l32p

    # serving alone from here: the prefill's second call, then the decode
    # steps; the peak covers these and nothing of the checks above
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = TT.prefill(lm, params, toks, cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    if tuple(logits.shape) != (B, lm.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are not "
                             "finite or not [B, V]")

    def decode(i, tok):
        p = torch.full((B,), T + i, dtype=torch.int32, device=dev)
        dl, _ = TT.decode_step(lm, params, cache, tok, p)
        return dl, dl[:, :lm.vocab].argmax(-1)

    t0 = time.perf_counter()
    with RouteLog(TT) as rlog:
        dl, nxt = decode(0, logits[:, :lm.vocab].argmax(-1))
    torch.cuda.synchronize()
    t_step0 = time.perf_counter() - t0
    dec_used = rlog.experts_used()
    del rlog
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(I_STEPS)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(1, I_STEPS):
        dl, nxt = decode(i, nxt)
        marks[i].record()
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / (I_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    if not bool(torch.isfinite(dl).all()):
        raise AssertionError("decode logits are not finite")
    n_tok = B * T
    log(f"[slice I] prefill {n_tok} tokens in {t_prefill * 1e3:.1f} ms: "
        f"{n_tok / t_prefill:.1f} tokens/s; decode {t_decode * 1e3:.3f} ms "
        f"per step of {B} tokens (steps 2-{I_STEPS} in one window; median "
        f"step {float(np.median(step_ms)):.3f} ms, the first step took "
        f"{t_step0 * 1e3:.1f} ms); peak memory of the prefill and decode "
        f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB)")

    # the prefill's and a window step's work against the card's bound:
    # each weight the call needs read once (the experts its tokens use;
    # the embedding is tied to the LM head), the cache written (prefill)
    # or read over the keys each layer attends to (decode, at the window's
    # middle step); the flops count the top-1 expert a token
    w_all = sum(p.numel() * p.element_size() for p in params.parameters())
    e_bytes = 3 * lm.d_model * lm.d_ff * params.layers[0].e_gate.element_size()
    kv_pos = 2 * B * lm.n_kv_heads * lm.hd * cache["k"].element_size()
    mid = T + I_STEPS // 2
    keys = sum(mid % C + 1 if (i + 1) % lm.global_every else mid + 1
               for i in range(lm.n_layers))
    roof = [
        RL.analyze("prefill", n_bytes=w_all - e_bytes * sum(
            E - u for u in used) + lm.n_layers * T * kv_pos,
            n_ops=RL.lm_model_flops(lm, B, T, "prefill"),
            rate=RL.HW["bf16_flops"], measured_s=t_prefill),
        RL.analyze("decode", n_bytes=w_all - e_bytes * sum(
            E - u for u in dec_used) + keys * kv_pos,
            n_ops=RL.lm_model_flops(lm, B, mid, "decode"),
            rate=RL.HW["bf16_flops"], measured_s=t_decode)]
    for r in roof:
        log(f"[slice I] {r.name} roofline: {r.flops:.4g} flops, "
            f"{r.bytes:.4g} bytes; compute {r.t_comp * 1e3:.4f} ms, memory "
            f"{r.t_mem * 1e3:.4f} ms, bound by {r.bottleneck}; measured "
            f"{r.measured_s * 1e3:.3f} ms, {100 * r.bound_share:.2f}% of "
            f"its bound")
    log(f"[slice I] a decode step's experts used a layer: {dec_used}; its "
        f"dense expert products read all {E} experts' "
        f"{E * e_bytes * lm.n_layers / 1e9:.2f} GB")
    del params, cache, logits, dl
    torch.cuda.empty_cache()
    out = dict(
        arch=lm.name, layers=lm.n_layers, batch=B, prompt=T, steps=I_STEPS,
        params=lm.param_count(), kernel_err=ferr, f32_launches=n32[0],
        launches=lc, f32_err=err32, decode_vs_prefill=derr,
        served_decode_vs_prefill=served_derr, last_token_dropped=last_dropped,
        bf16_err=err, bf16_vs_f32=noise, cap=cap, dropped=dropped,
        experts_used=used, decode_experts_used=dec_used,
        prefill_s=t_prefill, prefill_tokens_per_s=n_tok / t_prefill,
        decode_ms_per_step=t_decode * 1e3,
        decode_median_ms=float(np.median(step_ms)),
        decode_first_ms=t_step0 * 1e3, decode_step_ms=step_ms,
        peak_bytes=peak, setup_s=t_setup,
        roofline={r.name: dict(bound_ms=r.bound_s * 1e3, by=r.bottleneck,
                               share=r.bound_share) for r in roof})
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice I] {out['phase_s']:.1f} s (set-up and float32 checks "
        f"{t_setup:.1f} s)")
    return out


def run_slice_j(torch, np, dev, seed: int, kernels: dict) -> dict:
    """Slice J: llama4 training on the card. llama4-scout-17b-a16e at its
    published width, cut to J_LAYERS layer (chunked with RoPE, MoE with
    the shared expert), float32 masters and AdamW state from ``seed``,
    remat "full"; LM_SHAPES["train_4k"] cut to J_BATCH sequences as
    J_ACCUM microbatches. The first step's loss and grad norm against the
    plain attention's (the bf16 rule), the kernel's launches, the routing
    of the remat recompute against the forward's, then the timed steps.
    Records the launches under ``llama4_train_launches``. Every gate
    raises; returns the phase's report."""
    from repro_torch import configs
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.data.pipelines import lm_batch
    from repro_torch.kernels import autograd, ops, ref
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as TT
    from repro_torch.train import (OptConfig, accumulate_grads, global_norm,
                                   init_state, make_train_step)

    t_phase = time.perf_counter()
    full = configs.get(I_ARCH).make_config()
    lm = dataclasses.replace(full, n_layers=J_LAYERS, remat_policy="full")
    lm32 = dataclasses.replace(lm, dtype=torch.float32)
    shp = LM_SHAPES["train_4k"]
    seq, n_tok, C = shp["seq"], J_BATCH * shp["seq"], lm.attn_chunk
    n_moe = sum(lm._is_moe(i) for i in range(lm.n_layers))
    # a forward's launches: 2 on a chunked layer when the tokens hold whole
    # chunks and a tail; at seq <= attn_chunk the chunk mask is causal
    per_fwd = sum(1 if TT._layer_flags(lm, i)[0] or seq <= C or seq % C == 0
                  else 2 for i in range(lm.n_layers))
    per_step = per_fwd * 2 * J_ACCUM            # forward + remat recompute
    log(f"[slice J] {lm.name}: d_model {lm.d_model}, {lm.n_heads} heads, "
        f"{lm.n_kv_heads} kv heads, head_dim {lm.hd}, d_ff {lm.d_ff}, vocab "
        f"{lm.vocab}, {lm.n_experts} experts top-1 with the shared expert, "
        f"capacity factor {lm.capacity_factor}, attn_chunk {C}, router aux "
        f"weight {lm.router_aux_weight}; seed {seed}")
    log(f"[slice J] depth cut: {full.n_layers} -> {lm.n_layers} layer "
        f"(chunked, RoPE, MoE), {full.param_count()} -> {lm.param_count()} "
        f"parameters: float32 masters, gradients and AdamW m and v take "
        f"{16 * lm.param_count() / 1e9:.2f} GB; shape cut: "
        f"LM_SHAPES['train_4k'] batch {shp['batch']} x {seq} -> {J_BATCH} x "
        f"{seq} as accum={J_ACCUM} microbatches of {J_BATCH // J_ACCUM}, "
        f"remat {lm.remat_policy}; {per_fwd} launch a forward"
        + (f" ({seq} <= attn_chunk {C}: the chunk mask is the causal mask)"
           if seq <= C else ""))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = TT.init_params(lm, gen, dev).requires_grad_(True)
    state = init_state(params)
    ocfg = OptConfig(warmup_steps=1, total_steps=10)
    mb_metrics = []                # each microbatch's metrics (no sync)

    def loss(cfg, impl):
        def fn(p, b):
            total, m = TT.loss_fn(cfg, p, b, impl=impl)
            mb_metrics.append({k: v.detach() for k, v in m.items()})
            return total, m
        return fn

    step = make_train_step(loss(lm, autograd), ocfg, J_ACCUM)

    def batch(i):
        return lm_batch(i, J_BATCH, seq, lm.vocab, seed)

    def first_grads(cfg, impl):
        """The first step's loss and grad norm, without the update."""
        ops.reset_launches()
        l, _, grads = accumulate_grads(loss(cfg, impl), params, batch(0),
                                       J_ACCUM)
        gn = float(global_norm(grads))
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        for p in params.parameters():
            p.grad = None
        return float(l), gn, launches

    # the yardstick: float32 (the split-TF32 kernel's forward) and the plain
    # bf16 attention under autograd, from the same weights
    l32, g32, n32 = first_grads(lm32, autograd)
    if n32["flash_attention_f32"] != per_step or n32["flash_attention"]:
        raise AssertionError(f"float32 step launched {n32}, not {per_step} "
                             "of flash_attention_f32")
    lp, gp, np_ = first_grads(lm, ref)
    if any(np_.values()):
        raise AssertionError(f"the plain attention launched {np_}")
    # the routing is a function of the layer's input: one microbatch's
    # forward twice routes alike
    toks0 = torch.as_tensor(batch(0)["tokens"][:1, :-1], device=dev)
    with torch.no_grad(), RouteLog(TT) as twice:
        for _ in range(2):
            TT.forward(lm, params, toks0)
    same_twice = all(torch.equal(a.eidx, b.eidx) and torch.equal(a.keep,
                                                                 b.keep)
                     for a, b in zip(twice.calls[:n_moe],
                                     twice.calls[n_moe:]))
    del twice, toks0
    torch.cuda.empty_cache()
    t_checks = time.perf_counter() - t_phase

    # step 1 (warm-up): the kernel's forward, the plain version's backward;
    # each microbatch routes in its forward and again in the remat
    # recompute (last layer first)
    mb_metrics.clear()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouteLog(TT) as rlog:
        params, state, m = step(params, state, batch(0))
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"[slice J] launches in step 1: {launches} (expected {per_fwd} a "
        f"forward x (forward + remat recompute) x {J_ACCUM} microbatches = "
        f"{per_step} of flash_attention)")
    if launches["flash_attention"] != per_step or \
            sum(launches.values()) != per_step:
        raise AssertionError(f"step 1 launched {launches}")
    per_mb = 2 * n_moe
    if len(rlog.calls) != J_ACCUM * per_mb:
        raise AssertionError(f"{len(rlog.calls)} routings in step 1, not "
                             f"{J_ACCUM * per_mb}")
    groups = [rlog.calls[j * per_mb:(j + 1) * per_mb]
              for j in range(J_ACCUM)]
    same_recompute = [all(torch.equal(a.eidx, b.eidx)
                          and torch.equal(a.keep, b.keep)
                          for a, b in zip(g[:n_moe], g[n_moe:][::-1]))
                      for g in groups]
    dropped = [[int((~r.keep).sum()) for r in g[:n_moe]] for g in groups]
    used = [[int(r.eidx.unique().numel()) for r in g[:n_moe]] for g in groups]
    cap = rlog.calls[0].cap
    del rlog, groups
    ce = [float(x["ce"]) for x in mb_metrics]
    raux = [float(x["router_aux"]) for x in mb_metrics]
    log(f"[slice J] step 1 per microbatch: ce {ce}, router_aux {raux}; "
        f"tokens dropped by capacity (cap {cap} of {seq} tokens over "
        f"{lm.n_experts} experts) a MoE layer: {dropped}; experts used: "
        f"{used}")
    log(f"[slice J] routing: the remat recompute equals the forward "
        f"(eidx and keep) in each microbatch: {same_recompute}; one "
        f"microbatch's forward twice: {same_twice}")
    if not (all(same_recompute) and same_twice):
        raise AssertionError("a recompute routed the tokens differently")
    lk, gk = float(m["loss"]), float(m["grad_norm"])
    gate = {}
    for what, k, p_, f in (("loss", lk, lp, l32), ("grad_norm", gk, gp, g32)):
        noise = abs(p_ - f)
        gate[what] = dict(kernel=k, plain=p_, float32=f, diff=abs(k - p_),
                          bf16_vs_f32=noise, limit=LM_BF16_NOISE * noise)
        log(f"[slice J] step 1 {what}: kernel {k!r}, plain {p_!r}, float32 "
            f"{f!r}; |kernel - plain| {abs(k - p_):.4g} (limit "
            f"{LM_BF16_NOISE * noise:.4g}: {LM_BF16_NOISE} x bf16 vs "
            f"float32, {noise:.4g})")
        if not (math.isfinite(k) and abs(k - p_) <= LM_BF16_NOISE * noise):
            raise AssertionError(f"step 1 {what}: the kernel's {k} against "
                                 f"the plain {p_} (limit "
                                 f"{LM_BF16_NOISE * noise})")

    # steps 2..J_STEPS + 1, timed one by one
    metrics, step_s, peak = [m], [], 0
    for i in range(1, J_STEPS + 1):
        mb_metrics.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        metrics.append(m)
    losses = [float(x["loss"]) for x in metrics]
    norms = [float(x["grad_norm"]) for x in metrics]
    finite = all(bool(torch.isfinite(p).all()) for p in params.parameters())
    if not (finite and all(map(math.isfinite, losses + norms))):
        raise AssertionError(f"slice J: not finite (params {finite}, losses "
                             f"{losses}, grad norms {norms})")
    med = float(np.median(step_s))
    flops = RL.lm_model_flops(lm, J_BATCH, seq, "train")
    bound = flops / RL.HW["bf16_flops"]
    log(f"[slice J] losses {losses}, grad norms {norms}")
    log(f"[slice J] step {med:.4f} s (median of {J_STEPS}: "
        f"{', '.join(f'{t:.4f}' for t in step_s)}; step 1 {t_first:.4f} s), "
        f"{n_tok / med:.1f} tokens/s, peak memory {peak / 2 ** 30:.2f} GiB "
        f"({peak / 1e9:.2f} GB); bound {bound:.4f} s ({flops:.4g} flops at "
        f"{RL.HW['bf16_flops']:.3g} flop/s: the top-1 expert, the shared "
        f"expert and the router, remat recompute not counted): "
        f"{100 * bound / med:.2f}% of it")
    kernels["flash_attention"]["llama4_train_launches"] = \
        launches["flash_attention"]
    kernels["flash_attention_f32"]["llama4_train_launches"] = \
        n32["flash_attention_f32"]
    del params, state, metrics, m
    torch.cuda.empty_cache()
    out = dict(arch=lm.name, layers=lm.n_layers, params=lm.param_count(),
               batch=J_BATCH, seq=seq, accum=J_ACCUM, remat=lm.remat_policy,
               step_s=step_s, step_median_s=med, step1_s=t_first,
               tokens_per_s=n_tok / med, peak_bytes=peak, bound_s=bound,
               bound_share=bound / med, losses=losses, grad_norms=norms,
               launches=launches, f32_launches=n32, first_step=gate,
               ce=ce, router_aux=raux, cap=cap, dropped=dropped,
               experts_used=used, recompute_routes_alike=same_recompute,
               forward_twice_alike=same_twice, checks_s=t_checks)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice J] {out['phase_s']:.1f} s (first-step checks "
        f"{t_checks:.1f} s)")
    return out


def _sync_s(torch, fn):
    """Seconds of ``fn()`` on the host clock around synchronised work,
    and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, r


def run_slice_k(torch, np, dev, seed: int) -> dict:
    """Slice K: the recsys models on the card at their published tables.
    Each of K_ARCHS trains on RECSYS_SHAPES["train_batch"] (1 warm-up and
    K_STEPS timed AdamW steps, a fresh ``recsys_batch`` each), then serves
    ``forward`` at serve_p99 and serve_bulk and retrieves the top K_TOPK
    of retrieval_cand's candidates (the first rows of its table). Gates:
    every loss and parameter finite; the logloss of the first batch falls
    from before training to after it, and for the models that read dense
    features or a history (all but fm) so does the logloss of a held-out
    batch that no step trains on; the 512-row forward equals those
    rows of the bulk forward within K_SERVE_TOL of the largest; the
    retrieval's ids equal a full argsort's where the scores are distinct.
    Every gate raises; returns the phase's report."""
    from repro_torch import configs
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data.pipelines import recsys_batch
    from repro_torch.models import recsys as R
    from repro_torch.train import (OptConfig, init_state, make_eval_step,
                                   make_train_step)

    t_phase = time.perf_counter()
    n_train = RECSYS_SHAPES["train_batch"]["batch"]
    n_p99 = RECSYS_SHAPES["serve_p99"]["batch"]
    n_bulk = RECSYS_SHAPES["serve_bulk"]["batch"]
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    out = {}
    for arch in K_ARCHS:
        t_arch = time.perf_counter()
        cfg = configs.get(arch).make_config()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = R.init_params(cfg, gen, dev).requires_grad_(True)
        state = init_state(params)
        n_par = sum(p.numel() for p in params.parameters())

        def data(step, rows):
            b = recsys_batch(step, rows, cfg.n_sparse, cfg.vocabs(),
                             cfg.n_dense, seed=seed, kind=cfg.kind,
                             seq_len=cfg.seq_len)
            return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

        t0 = time.perf_counter()
        batches = [data(i, n_train) for i in range(K_STEPS + 1)]
        t_data = time.perf_counter() - t0
        log(f"[slice K] {cfg.name}: {len(cfg.vocabs())} fields over "
            f"{sum(cfg.vocabs())} table rows x {cfg.embed_dim}, mlp "
            f"{cfg.mlp_dims if cfg.kind != 'fm' else ()}"
            f"{f', attention mlp {cfg.attn_mlp_dims}, history {cfg.seq_len}' if cfg.kind == 'din' else ''}"
            f", {cfg.n_dense} dense; {n_par} parameters ("
            f"{16 * n_par / 1e9:.2f} GB with gradients and AdamW state); "
            f"{K_STEPS + 1} batches of {n_train} made in {t_data:.2f} s")

        def loss_fn(p, b):
            return R.loss_fn(cfg, p, b)
        step = make_train_step(loss_fn, OptConfig(warmup_steps=1,
                                                  total_steps=10))
        evaluate = make_eval_step(loss_fn)
        # a batch that no step trains on can lose logloss only through what
        # a fresh batch shares: dense[:, 0] (deepfm, wide_deep) and din's
        # click rate of about 1 in 7 (target id mod 7 against the history's
        # mean, which rounds to 3). fm reads no dense feature, clicks half
        # the time, and its one other signal, field 0's id mod 5, sits in
        # table rows that a fresh batch of 65,536 almost never repeats
        heldout = data(K_STEPS + 1, n_train) if cfg.kind != "fm" else None
        before = float(evaluate(params, batches[0])["loss"])
        h_before = (float(evaluate(params, heldout)["loss"])
                    if heldout is not None else None)
        t_first, (params, state, m) = _sync_s(
            torch, lambda: step(params, state, batches[0]))
        metrics, step_s = [m], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches[1:]:
            t, (params, state, m) = _sync_s(
                torch, lambda: step(params, state, b))
            step_s.append(t)
            metrics.append(m)
        peak = torch.cuda.max_memory_allocated()
        after = float(evaluate(params, batches[0])["loss"])
        h_after = (float(evaluate(params, heldout)["loss"])
                   if heldout is not None else None)
        losses = [float(x["loss"]) for x in metrics]
        finite = all(bool(torch.isfinite(p).all())
                     for p in params.parameters())
        med = float(np.median(step_s))
        log(f"[slice K] {cfg.name} train: step {med:.4f} s (median of "
            f"{K_STEPS}: {', '.join(f'{t:.4f}' for t in step_s)}; step 1 "
            f"{t_first:.4f} s), {n_train / med:.1f} examples/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB); logloss a "
            f"step {losses}; batch 0's logloss {before!r} before training, "
            f"{after!r} after; the held-out batch's "
            f"{'(fm: not gated)' if heldout is None else f'{h_before!r} before, {h_after!r} after'}")
        if not (finite and all(map(math.isfinite, losses))):
            raise AssertionError(f"{cfg.name}: not finite (params {finite}, "
                                 f"losses {losses})")
        if not after < before:
            raise AssertionError(f"{cfg.name}: batch 0's logloss did not "
                                 f"fall ({before} -> {after})")
        if heldout is not None and not h_after < h_before:
            raise AssertionError(f"{cfg.name}: the held-out batch's logloss "
                                 f"did not fall ({h_before} -> {h_after})")
        del state, batches, metrics, m, heldout
        params.requires_grad_(False)
        torch.cuda.empty_cache()

        # serving: the p99 batch's latency over K_P99_CALLS calls, then the
        # bulk batch's rows/s; the small batch is the bulk batch's head
        served = data(10_000, n_bulk)
        small = {k: v[:n_p99] for k, v in served.items()}
        with torch.no_grad():
            lat = [_sync_s(torch, lambda: R.forward(cfg, params, small))[0]
                   for _ in range(K_P99_CALLS)]
            y_small = R.forward(cfg, params, small)
            _sync_s(torch, lambda: R.forward(cfg, params, served))
            torch.cuda.reset_peak_memory_stats()
            bulk_s, y_bulk = _sync_s(
                torch, lambda: R.forward(cfg, params, served))
            serve_peak = torch.cuda.max_memory_allocated()
            head = y_bulk[:n_p99]
            serve_err = float((y_small - head).abs().max())
            serve_lim = K_SERVE_TOL * float(head.abs().max())
            # retrieval: one user's vector against the first n_cand rows
            if cfg.kind == "din":
                user = R.din_attention(params.table[small["hist_ids"][:1]
                                                    .long()],
                                       params.table[small["target_id"][:1]
                                                    .long()],
                                       params.attn_mlp,
                                       small["hist_mask"][:1])
            else:
                user = R.lookup_fields(params.table, small["sparse_ids"][:1],
                                       R.field_offsets(cfg, dev)).mean(dim=1)
            cand = params.table[:n_cand]
            ret_ms = cuda_ms(torch, lambda: R.retrieval_topk(user, cand,
                                                             K_TOPK), 20)
            scores, ids = R.retrieval_topk(user, cand, K_TOPK)
            full = R.retrieval_scores(user, cand)[0]
            order = torch.argsort(full, descending=True, stable=True)[:K_TOPK]
            vals, counts = torch.unique(full, return_counts=True)
            distinct = torch.isin(scores[0], vals[counts == 1])
            ids_ok = torch.equal(ids[0][distinct], order[distinct])
            scores_ok = torch.equal(scores[0], full[order])
        lat_ms = np.asarray(lat[10:]) * 1e3      # the first 10 warm up
        p99 = float(np.percentile(lat_ms, 99))
        log(f"[slice K] {cfg.name} serve: {n_p99} rows p50 "
            f"{float(np.median(lat_ms)):.4f} ms, p99 {p99:.4f} ms "
            f"({K_P99_CALLS - 10} calls); {n_bulk} rows in "
            f"{bulk_s * 1e3:.3f} ms: {n_bulk / bulk_s:.1f} rows/s, peak "
            f"{serve_peak / 2 ** 30:.2f} GiB; head vs bulk max |d| "
            f"{serve_err:.3g} (limit {serve_lim:.3g}); retrieval top "
            f"{K_TOPK} of {cand.shape[0]} x {cand.shape[1]} in "
            f"{ret_ms:.4f} ms, {int(distinct.sum())} distinct scores, ids "
            f"equal to a full argsort's there: {ids_ok}")
        if serve_err > serve_lim:
            raise AssertionError(f"{cfg.name}: the {n_p99}-row forward "
                                 f"differs from the bulk's by {serve_err}")
        if not (ids_ok and scores_ok):
            raise AssertionError(f"{cfg.name}: retrieval differs from a full "
                                 f"argsort (ids {ids_ok}, scores "
                                 f"{scores_ok})")
        out[cfg.name] = dict(
            params=n_par, step_s=step_s, step_median_s=med, step1_s=t_first,
            examples_per_s=n_train / med, peak_bytes=peak, losses=losses,
            batch0_logloss=[before, after],
            heldout_logloss=[h_before, h_after], p99_ms=p99,
            p50_ms=float(np.median(lat_ms)), bulk_s=bulk_s,
            bulk_rows_per_s=n_bulk / bulk_s, serve_peak_bytes=serve_peak,
            serve_err=serve_err, retrieval_ms=ret_ms,
            retrieval_distinct=int(distinct.sum()), data_s=t_data,
            arch_s=time.perf_counter() - t_arch)
        del params, served, small, y_small, y_bulk, head, user, cand, full
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice K] {out['phase_s']:.1f} s")
    return out


def run_slice_l(torch, np, dev, seed: int) -> dict:
    """Slice L: gcn-cora's model on the card at GNN_SHAPES' sizes, data
    from ``seed``: full-batch training at ogb_products (``random_graph``
    of 2,449,029 nodes and 61,859,140 edges), batched small graphs at
    molecule through ``graph_loss_fn`` (a label a graph), and sampled
    training at minibatch_lg (reddit's 232,965 nodes, its edges cut to
    L_SAMPLED_EDGES, 1,024 seeds a step with fanout (15, 10), through
    ``sampled_loss_fn``; the sampler runs on the host before the timed
    steps). 1 warm-up and L_STEPS timed AdamW steps each. Gates: every
    loss and parameter finite. Returns the phase's report."""
    from repro_torch import configs
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data import graph_sampler as GS
    from repro_torch.models import gnn as N
    from repro_torch.train import OptConfig, init_state, make_train_step

    t_phase = time.perf_counter()
    gcn = configs.get("gcn-cora")

    def on_dev(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def train(name, shape, loss_fn, batches) -> dict:
        cfg = gcn.make_config(shape)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = N.init_params(cfg, gen, dev).requires_grad_(True)
        state = init_state(params)
        step = make_train_step(lambda p, b: loss_fn(cfg, p, b),
                               OptConfig(warmup_steps=1, total_steps=10))
        torch.cuda.reset_peak_memory_stats()
        t_first, (params, state, m) = _sync_s(
            torch, lambda: step(params, state, batches[0]))
        metrics, step_s = [m], []
        for b in batches[1:]:
            t, (params, state, m) = _sync_s(
                torch, lambda: step(params, state, b))
            step_s.append(t)
            metrics.append(m)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x["loss"]) for x in metrics]
        finite = all(bool(torch.isfinite(p).all())
                     for p in params.parameters())
        med = float(np.median(step_s))
        log(f"[slice L] {name} ({shape}, d_feat {cfg.d_feat}, d_hidden "
            f"{cfg.d_hidden}, {cfg.n_classes} classes, norm {cfg.norm}): "
            f"step {med:.4f} s (median of {L_STEPS}: "
            f"{', '.join(f'{t:.4f}' for t in step_s)}; step 1 "
            f"{t_first:.4f} s), peak memory {peak / 2 ** 30:.2f} GiB "
            f"({peak / 1e9:.2f} GB); loss a step {losses}")
        if not (finite and all(map(math.isfinite, losses))):
            raise AssertionError(f"slice L {name}: not finite (params "
                                 f"{finite}, losses {losses})")
        return dict(step_s=step_s, step_median_s=med, step1_s=t_first,
                    peak_bytes=peak, losses=losses)

    out = {}
    # full batch: the whole graph every step
    shp = GNN_SHAPES["ogb_products"]
    t0 = time.perf_counter()
    g = GS.random_graph(shp["n_nodes"], shp["n_edges"], shp["d_feat"],
                        shp["n_classes"], seed=seed)
    t_gen = time.perf_counter() - t0
    n_msg = shp["n_edges"] + shp["n_nodes"]
    log(f"[slice L] ogb_products: random_graph of {g.n} nodes, "
        f"{g.edges.shape[0]} edges, {shp['d_feat']} features in "
        f"{t_gen:.1f} s on the host; the first conv gathers "
        f"{n_msg} messages (self-loops added) x {shp['d_feat']} float32, "
        f"{n_msg * shp['d_feat'] * 4 / 1e9:.2f} GB")
    full = on_dev({"feats": g.feats, "edges": g.edges, "labels": g.labels})
    del g
    out["full"] = train("full batch", "ogb_products", N.loss_fn,
                        [full] * (L_STEPS + 1))
    out["full"]["gen_s"] = t_gen
    del full
    torch.cuda.empty_cache()

    # batched small graphs: a fresh batch a step, one label a graph
    shp = GNN_SHAPES["molecule"]
    mols = []
    for i in range(L_STEPS + 1):
        b = GS.batched_molecules(shp["batch"], shp["n_nodes"], shp["n_edges"],
                                 shp["d_feat"], shp["n_classes"],
                                 seed=seed + i)
        b["labels"] = b["labels"][::shp["n_nodes"]]
        mols.append(on_dev(b))
    out["molecule"] = train("batched graphs", "molecule", N.graph_loss_fn,
                            mols)
    del mols

    # sampled: reddit's graph, the CSR and the fanout sampler on the host
    shp = GNN_SHAPES["minibatch_lg"]
    n_edges = min(shp["n_edges"], L_SAMPLED_EDGES)
    log(f"[slice L] minibatch_lg cut: {shp['n_edges']} -> {n_edges} edges "
        f"(the host's time to generate them and build the CSR)")
    t0 = time.perf_counter()
    g = GS.random_graph(shp["n_nodes"], n_edges, shp["d_feat"],
                        shp["n_classes"], seed=seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = GS.NeighborSampler(g, shp["fanout"], seed=seed)
    t_csr = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    sampled = [sampler.sample(rng.choice(g.n, shp["batch_nodes"],
                                         replace=False))
               for _ in range(L_STEPS + 1)]
    t_sample = (time.perf_counter() - t0) / len(sampled)
    real = [int(b["n_real_nodes"]) for b in sampled]
    log(f"[slice L] minibatch_lg: random_graph of {g.n} nodes, "
        f"{g.edges.shape[0]} edges, {shp['d_feat']} features in "
        f"{t_gen:.1f} s and its CSR in {t_csr:.1f} s on the host "
        f"({t_gen + t_csr:.1f} s together); {shp['batch_nodes']} seeds with "
        f"fanout {shp['fanout']}: {t_sample:.3f} s a sample on the host, "
        f"{real} real of {sampled[0]['feats'].shape[0]} padded nodes, "
        f"{sampled[0]['edges'].shape[0]} padded edges")
    del g, sampler
    out["sampled"] = train("sampled", "minibatch_lg", N.sampled_loss_fn,
                           [on_dev(b) for b in sampled])
    out["sampled"].update(gen_s=t_gen, csr_s=t_csr, sample_s=t_sample,
                          real_nodes=real)
    del sampled
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice L] {out['phase_s']:.1f} s")
    return out


M_ATTN_STEP = 2.0 ** -7        # variant vs plain: one bf16 step of each
M_ATTN_FLIP = 2.0 ** -6        # ... plus this at any output
M_ATTN_PAST = 2.0 ** -9        # share of outputs past one step (+ 1e-5)
M_LOSS_TOL = 2.0 ** -12        # first loss, variant vs plain, relative
M_TRAIN_STEPS, M_CRASH_AT = 12, 6   # slice M (e): tiny LM, crash, resume
M_RESUME_TOL = 2e-2            # last loss, resumed vs control (reference's)


def start_dryrun(out_json: str):
    """Slice M (a), started early: ``repro_torch.launch.dryrun`` over every
    cell on both meshes in a process of its own (CPU only: the meta
    device), writing its rows to ``out_json``. Returns (process, log
    path)."""
    root = Path(__file__).resolve().parent
    log_path = str(Path(out_json).with_suffix(".log"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         out_json], cwd=root, env=env, stdout=open(log_path, "w"),
        stderr=subprocess.STDOUT)
    return proc, log_path


def bf16_variant_gate(torch, got, want) -> dict:
    """The bf16-score variant's output against its plain version's, element
    by element. Both round S and p at the same points and their outputs to
    bf16, so most outputs agree within one bf16 step (2^-7 of the value,
    plus 1e-5). Where their float32 sums (another order) put a score or a
    p on either side of a bf16 rounding point, that p moves by a bf16 step
    and its row's outputs with it: every output must stay within one step
    plus M_ATTN_FLIP, and at most M_ATTN_PAST of them may pass one step.
    Returns the largest error, the largest output, the largest excess over
    one step, the share past one step and ``ok``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    step = M_ATTN_STEP * want.abs()
    excess = float((err - step).max())
    past = float((err > step + 1e-5).float().mean())
    return dict(max_abs_err=float(err.max()), largest=float(want.abs().max()),
                excess=excess, past_share=past,
                ok=bool(torch.isfinite(got).all()) and excess <= M_ATTN_FLIP
                and past <= M_ATTN_PAST)


def gate_line(g: dict) -> str:
    return (f"max |d| {g['max_abs_err']:.4g} of the largest output "
            f"{g['largest']:.4g}, largest excess over one bf16 step "
            f"{g['excess']:.4g} (limit {M_ATTN_FLIP:.4g}), share past one "
            f"step {g['past_share']:.4g} (limit {M_ATTN_PAST:.4g})")


def check_flash_bf16(torch, ops, ref, q, k, v, **flags) -> dict:
    """``bf16_variant_gate`` of the bf16-score variant against its plain
    version on q, k, v; one launch of the variant. Raises off the gate."""
    before = ops.LAUNCHES["flash_attention_bf16"]
    got = ops.flash_attention(q, k, v, **flags)
    if ops.LAUNCHES["flash_attention_bf16"] != before + 1:
        raise AssertionError(f"{flags}: flash_attention_bf16 did not launch")
    gate = bf16_variant_gate(torch, got, ref.flash_attention(q, k, v,
                                                             **flags))
    if not gate["ok"]:
        raise AssertionError(f"flash_attention_bf16 {flags}: "
                             + gate_line(gate))
    return gate


class FirstAttention:
    """While installed, keeps the inputs, flags and output of the first
    knobbed ``ops.flash_attention`` call (the main path's layer 0)."""

    def __init__(self, ops):
        self.ops, self.real, self.call = ops, ops.flash_attention, None

    def __enter__(self):
        def spy(q, k, v, **kw):
            out = self.real(q, k, v, **kw)
            if self.call is None and (kw.get("scores_bf16")
                                      or kw.get("p_bf16")):
                self.call = (q.detach(), k.detach(), v.detach(), kw, out)
            return out
        self.ops.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


def run_slice_m(torch, np, dev, seed: int, kernels: dict, dry) -> dict:
    """Slice M: the cell registry, the dry run, the perf harness and the
    training launcher (``repro_torch.configs.registry``,
    ``repro_torch.launch``). (a) the dry run's rows (started in its own
    process after the build); (b) ``perf --cell qwen3_train``, the main
    path of the bf16-score kernel variant; (c) ``jag_serve``; (d)
    ``din_train``; (e) ``launch.train --scale tiny`` crashed at step
    M_CRASH_AT, resumed, and a control run; (f) the variant against its
    plain version and SDPA at slice C's prefill shape. Every gate raises;
    returns the phase's report."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import perf
    from repro_torch.launch import roofline as RL
    from repro_torch import configs

    t_phase = time.perf_counter()
    out = {}

    # (a) the dry run: every cell on both production meshes
    proc, out_json, log_path = dry
    t0 = time.perf_counter()
    rc = proc.wait()
    wait_s = time.perf_counter() - t0
    text = Path(log_path).read_text()
    rows = json.loads(Path(out_json).read_text()) if Path(
        out_json).exists() else {"results": [], "failures": []}
    res, fails = rows["results"], rows["failures"]
    n_ok = sum(r["status"] == "ok" for r in res)
    n_an = sum(r["status"] == "analytic_only" for r in res)
    log(f"[slice M] dry run: exit {rc}, {n_ok} ok, {n_an} analytic only, "
        f"{len(fails)} failed of {len(res) + len(fails)} rows (waited "
        f"{wait_s:.1f} s at slice M)")
    for r in res:
        if r["status"] == "analytic_only" and r["mesh"] == "single":
            log(f"[slice M]   {r['arch']} x {r['shape']}: analytic only: "
                f"{r['reason']}")
    fit = {m: sorted(f"{r['arch']}:{r['shape']}" for r in res
                     if r["mesh"] == m and not r["fits"])
           for m in ("single", "multi")}
    for m, cells in fit.items():
        log(f"[slice M]   {m}: {len(cells)} cells whose state does not fit "
            f"a card: {cells}")
    # the dry run's process does not see the card, so its rows hold the
    # data sheet's 80 GB; hold the state against this card's memory too
    card = torch.cuda.get_device_properties(dev).total_memory
    on_card = {m: sorted(f"{r['arch']}:{r['shape']}" for r in res
                         if r["mesh"] == m
                         and r["state_bytes"]["total"] > card)
               for m in ("single", "multi")}
    log(f"[slice M]   against this card's {card / 2 ** 30:.2f} GiB: "
        f"{ {m: len(c) for m, c in on_card.items()} } cells do not fit")
    n_cells = sum(len(s.shapes) for s in configs.all_archs().values())
    if rc != 0 or fails or len(res) != 2 * n_cells:
        raise AssertionError(f"the dry run failed (exit {rc}, {fails}); "
                             f"its log ends: {text[-2000:]}")
    meta_s = sum(r["meta_run_s"] for r in res)
    out["dryrun"] = dict(ok=n_ok, analytic_only=n_an, failed=len(fails),
                         not_fitting=fit, not_fitting_card=on_card,
                         card_bytes=card, meta_run_s=meta_s, wait_s=wait_s,
                         rows=res)

    # (b) the main path of the variant: qwen3-1.7b training at full width
    # and depth with attn_scores_bf16 (v2) and with remat "dots" (v3)
    torch.cuda.empty_cache()
    rows_b = []
    ops.reset_launches()
    with FirstAttention(ops) as first:
        perf.lm_train_variants("qwen3-1.7b", rows_b, dev, batch=4, accum=2,
                               steps=2, seed=seed, check_plain=True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"[slice M] qwen3_train launches over both variants: {launches}")
    lm = configs.get(LM_ARCH).make_config()
    per_step = lm.n_layers * 2 * 2          # forward + recompute, accum 2
    for r in rows_b:
        la = r["launches_per_step"]
        if la != {"flash_attention_bf16": per_step}:
            raise AssertionError(f"{r['tag']}: a step launched {la}, not "
                                 f"{per_step} of flash_attention_bf16")
        diff = abs(r["losses"][0] - r["plain_loss"])
        log(f"[slice M] qwen3_train {r['tag']}: {r['s_per_step']:.4f} s a "
            f"step, {r['tokens_per_s']:.1f} tokens/s, "
            f"{100 * r['bound_share']:.2f}% of its bound, peak "
            f"{(r['peak_bytes'] or 0) / 2 ** 30:.2f} GiB; first loss "
            f"{r['losses'][0]!r} (plain attention {r['plain_loss']!r}, "
            f"|d| {diff:.4g}); losses {r['losses']}")
        if not (r["finite"] and diff <= M_LOSS_TOL * abs(r["plain_loss"])):
            raise AssertionError(f"qwen3_train {r['tag']}: losses "
                                 f"{r['losses']} vs plain {r['plain_loss']}"
                                 f" (limit {M_LOSS_TOL} of it)")
    if launches["flash_attention_bf16"] <= 0 or first.call is None:
        raise AssertionError("the variant never ran on slice M's path")
    # the first attention call of the path (layer 0 of v2's warm-up step)
    # against the plain version on its own inputs
    q, k, v, kw, got = first.call
    with torch.no_grad():
        gate = bf16_variant_gate(torch, got, ref.flash_attention(q, k, v,
                                                                 **kw))
    log(f"[slice M] qwen3_train layer 0 attention q{list(q.shape)} {kw}, "
        f"variant vs plain: " + gate_line(gate))
    if not gate["ok"]:
        raise AssertionError("qwen3_train: the main path's attention is off "
                             "the variant's gate")
    out["qwen3_train_attention"] = gate
    del q, k, v, got, first
    kernels["flash_attention_bf16"]["launches"] = \
        launches["flash_attention_bf16"]
    out["qwen3_train"] = rows_b
    torch.cuda.empty_cache()

    # (c) JAG serve_1b's five variants on one shard at its published width
    rows_c = []
    t0 = time.perf_counter()
    perf.jag_serve_variants(rows_c, dev, n_local=1 << 22, queries=256,
                            steps=2, seed=seed)
    for r in rows_c:
        log(f"[slice M] jag_serve {r['tag']}: {r['ms']:.2f} ms a step of "
            f"{r['queries']} queries, {r['qps']:.1f} QPS, "
            f"{100 * r['bound_share_fp32']:.4f}% of the FP32 flops bound "
            f"({100 * r['bound_share_bf16']:.5f}% at the bf16 peak)")
        if not r["results_ok"]:
            raise AssertionError(f"jag_serve {r['tag']}: results do not hold")
    log(f"[slice M] jag_serve {time.perf_counter() - t0:.1f} s")
    out["jag_serve"] = rows_c
    torch.cuda.empty_cache()

    # (d) din at train_batch: the table dtypes timed, the rules accounted
    rows_d = []
    perf.din_train_variants(rows_d, dev, steps=3, seed=seed)
    for r in rows_d:
        log(f"[slice M] din_train {r['tag']}: {1e3 * r['s_per_step']:.2f} "
            f"ms a step ({r['timed_as']} table), "
            f"{r['examples_per_s']:.1f} examples/s, state a card on "
            f"(16, 16) {r['state_bytes_16x16']['total'] / 2 ** 20:.1f} MiB")
        if not r["finite"]:
            raise AssertionError(f"din_train {r['tag']}: not finite")
    out["din_train"] = rows_d
    torch.cuda.empty_cache()

    # (e) the training launcher: crash at step M_CRASH_AT, resume, control
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    tmp = tempfile.mkdtemp(prefix="slice_m_train_")
    try:
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                LM_ARCH, "--scale", "tiny", "--steps", str(M_TRAIN_STEPS),
                "--ckpt-every", "4", "--device", dev.type, "--seed", str(seed)]
        run1 = base + ["--ckpt-dir", f"{tmp}/ck", "--metrics-out",
                       f"{tmp}/m1.jsonl"]
        ctrl = base + ["--ckpt-dir", f"{tmp}/ck3", "--metrics-out",
                       f"{tmp}/m3.jsonl"]
        t0 = time.perf_counter()
        # the crashed run and the control run share the card
        p1 = subprocess.Popen(run1 + ["--fail-at-step", str(M_CRASH_AT)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        p3 = subprocess.Popen(ctrl, cwd=root, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        o1, o3 = p1.communicate()[0], p3.communicate()[0]
        r2 = subprocess.run(run1, cwd=root, env=env, capture_output=True,
                            text=True)
        t_train = time.perf_counter() - t0
        if p1.returncode != 42 or p3.returncode != 0 or r2.returncode != 0:
            raise AssertionError(f"launch.train exits {p1.returncode}, "
                                 f"{r2.returncode}, {p3.returncode}: "
                                 f"{o1[-800:]} {r2.stderr[-800:]} "
                                 f"{o3[-800:]}")
        if f"resumed from step {M_CRASH_AT - M_CRASH_AT % 4}" not in \
                r2.stdout:
            raise AssertionError(f"no resume: {r2.stdout[-800:]}")
        m1 = [json.loads(x) for x in open(f"{tmp}/m1.jsonl")]
        m3 = [json.loads(x) for x in open(f"{tmp}/m3.jsonl")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    last = M_TRAIN_STEPS - 1
    l1 = [m for m in m1 if m["step"] == last][-1]["loss"]
    l3 = [m for m in m3 if m["step"] == last][-1]["loss"]
    dts = [m["dt"] for m in m3 if m["step"] > 0]
    log(f"[slice M] launch.train --scale tiny: crashed at step "
        f"{M_CRASH_AT} (exit 42), resumed from step "
        f"{M_CRASH_AT - M_CRASH_AT % 4}; last loss {l1!r} against the "
        f"control's {l3!r}: |d| {abs(l1 - l3):.4g} (limit {M_RESUME_TOL}); "
        f"control step {1e3 * float(np.median(dts)):.1f} ms (median); three "
        f"runs {t_train:.1f} s")
    if not abs(l1 - l3) < M_RESUME_TOL:
        raise AssertionError(f"resumed loss {l1} vs control {l3}")
    out["train"] = dict(resumed_loss=l1, control_loss=l3,
                        diff=abs(l1 - l3), control_step_ms=1e3 * float(
                            np.median(dts)), seconds=t_train)

    # (f) the variant against its plain version and SDPA at slice C's
    # prefill shape: attn_scores_bf16 (the main path's knob), then p_bf16
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    fshape = (LM_BATCH, lm.n_heads, LM_PROMPT, lm.hd)
    kshape = (LM_BATCH, lm.n_kv_heads, LM_PROMPT, lm.hd)
    fq, fk, fv = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                  for sh in (fshape, kshape, kshape))
    attn = dict(B=LM_BATCH, H=lm.n_heads, Hkv=lm.n_kv_heads, T=LM_PROMPT,
                D=lm.hd)
    b, o = RL.kernel_bound_ms("flash_attention_bf16", **attn)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    modes = {}
    split = ops.flash_attention(fq, fk, fv)
    for knob in ("scores_bf16", "p_bf16"):
        flags = {knob: True}
        gate = check_flash_bf16(torch, ops, ref, fq, fk, fv, **flags)
        # the split kernel keeps p to 2^-17, against the knobs' rounding
        # points: the gate must refuse it
        ctrl = bf16_variant_gate(torch, split, ref.flash_attention(
            fq, fk, fv, **flags))
        log(f"[slice M] {knob}: variant vs plain: {gate_line(gate)}; the "
            f"split kernel vs the same: {gate_line(ctrl)}")
        if ctrl["ok"]:
            raise AssertionError(f"{knob}: the split kernel passes the "
                                 "variant's gate, which then cannot tell "
                                 "the rounding points apart")
        modes[knob] = dict(
            gate, split_vs_plain=ctrl,
            ms=cuda_ms(torch, lambda: ops.flash_attention(fq, fk, fv,
                                                          **flags), 5),
            plain_ms=cuda_ms(torch, lambda: ref.flash_attention(
                fq, fk, fv, **flags), 2, warmup=1))
    del split
    split_ms = cuda_ms(torch, lambda: ops.flash_attention(fq, fk, fv), 5)
    lib = cuda_ms(torch, lambda: sdpa(fq, fk, fv, is_causal=True,
                                      enable_gqa=True), 10)
    for knob, m in modes.items():
        log(f"[slice M] flash_attention_bf16 ({knob}) "
            f"q[{','.join(map(str, fshape))}]: max_abs_err "
            f"{m['max_abs_err']:.3g} of the largest output "
            f"{m['largest']:.4g}, {m['ms']:.4f} ms (plain "
            f"{m['plain_ms']:.4f} ms, bound {b:.4f} ms by {o}, SDPA "
            f"{lib:.4f} ms, the split-p kernel {split_ms:.4f} ms)")
    sm = modes["scores_bf16"]
    kernels["flash_attention_bf16"].update(
        shape=f"q[{','.join(map(str, fshape))}] "
              f"kv[{','.join(map(str, kshape))}] bf16 causal scores_bf16",
        max_abs_err=sm["max_abs_err"], ms=sm["ms"], plain_ms=sm["plain_ms"],
        bound_ms=b, bound_by=o, library_ms=lib, p_bf16=modes["p_bf16"],
        split_kernel_ms=split_ms)
    del fq, fk, fv
    torch.cuda.empty_cache()
    out["flash_attention_bf16"] = dict(modes=modes, split_ms=split_ms,
                                       sdpa_ms=lib, bound_ms=b)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[slice M] {out['phase_s']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=500_000,
                    help="slice A database rows")
    ap.add_argument("--batch-size", type=int, default=8192,
                    help="JAGConfig.batch_size of slice A's build")
    ap.add_argument("--degree", type=int, default=128,
                    help="JAGConfig.degree of slice A's build")
    ap.add_argument("--ls-build", type=int, default=96,
                    help="JAGConfig.ls_build of slice A's build")
    ap.add_argument("--cand-pool", type=int, default=192,
                    help="JAGConfig.cand_pool of slice A's build")
    ap.add_argument("--f-n", type=int, default=F_N,
                    help="slice F's msturing_subset rows (a multiple of "
                         f"{F_SHARDS})")
    ap.add_argument("--f-sift-n", type=int, default=F_SIFT_N,
                    help="slice F's sift_like rows")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of slice C's random weights and prompts")
    ap.add_argument("--out", default=None,
                    help="also write the full report here as JSON")
    ap.add_argument("--profile", default=None,
                    help="also trace one main-path run of slice A and one "
                         "decode step of slice C with torch.profiler and "
                         "write their Chrome traces here and beside it "
                         "(.decode.json; the device busy shares in PERF.md)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.core.filters import pack_bits, onehot_words
    from repro_torch.core.ground_truth import exact_filtered_knn
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.core.recall import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as TT
    from repro_torch.serve.layout import build_layout
    from repro_torch.serve.planner import PlannerConfig, plan_per_query

    report = {"args": vars(args)}
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    dev = resolve_device("cuda")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs an sm_90 card, found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} capability {cap} | nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    report["device"] = {"kind": kind, "nvidia_smi": smi}

    # -- 2. kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    t_build = time.perf_counter() - t0
    log(f"[build] {len(paths)} kernels in {t_build:.2f} s")
    for name, out in _build.PTXAS_LOG.items():
        for fn, regs, spill in ptxas_report(out):
            log(f"[build] {name}: {fn}: {regs} registers, {spill} bytes of "
                "spill stores")
    report["kernel_build_s"] = t_build
    # slice M (a): the dry run on the meta device, in a process of its own
    # while the card works; read at slice M
    dry_json = str(Path(tempfile.mkdtemp(prefix="slice_m_dry_"))
                   / "dryrun.json")
    dry_proc, dry_log = start_dryrun(dry_json)
    atexit.register(lambda: dry_proc.poll() is None and dry_proc.kill())
    for name, opcode in (("flash_attention", "HGMMA"), ("l2dist", "HGMMA"),
                         ("flash_attention_f32", "HGMMA"),
                         ("flash_attention_f32", "HMMA")):
        n_op = _build.sass_count(name, opcode)
        log(f"[build] {name}: {n_op} {opcode} instructions in its SASS")
        if n_op == 0:
            raise AssertionError(f"{name} holds no {opcode} instruction")
        report[f"{name}_{opcode.lower()}"] = n_op

    # -- 3. kernels against their plain versions ---------------------------
    N, D, NQ, K, LS = args.n, 100, 1024, 10, 64
    MI = 2 * LS                          # search_auto's default max_iters
    t0 = time.perf_counter()
    ds = synthetic.msturing_subset(n=N, d=D, b=NQ, device=dev)
    log(f"[data] msturing_subset N={N} d={D} queries={NQ} in "
        f"{time.perf_counter() - t0:.1f} s")
    xb = torch.as_tensor(ds.xb, device=dev)
    q_all = torch.as_tensor(ds.queries, device=dev)
    pq = plan_per_query(ds.filt, ds.attr, PlannerConfig())
    groups = {g.route: g.ids for g in pq.groups}
    log("[plan] " + " ".join(f"{r}:{len(i)}" for r, i in groups.items()))
    for r in ("prefilter", "graph", "postfilter"):
        if r not in groups:
            raise AssertionError(f"slice A's plan has no {r} queries")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    gen_edge = torch.Generator(device=dev)   # edge shapes and cold batches
    gen_edge.manual_seed(1)
    kernels = {}

    def words32(shape):
        return torch.randint(0, 2 ** 32, shape, generator=gen_edge,
                             device=dev, dtype=torch.int64).to(torch.int32)

    # fused_expand: the graph group's expansion of C = R + EX neighbours
    # the overflow re-prune takes 2 rows per inserted point and batch, the
    # reference's 256 rows per batch of 128
    cfg = JAGConfig(degree=args.degree, ls_build=args.ls_build,
                    batch_size=args.batch_size, cand_pool=args.cand_pool,
                    ov_max=2 * args.batch_size)
    lay = build_layout(xb, ds.attr)
    gi = torch.as_tensor(groups["graph"], device=dev)
    Bg, C = len(gi), cfg.degree + cfg.ex_slots
    qg = q_all[gi].contiguous()
    qgn = torch.sum(qg * qg, dim=-1)
    ids = torch.randint(0, N, (Bg, C), generator=gen, device=dev,
                        dtype=torch.int32)
    err = check_fused_expand(torch, ops, ref, lay.packed, ids, qg, qgn, D)
    A = lay.n_attr_words
    # an odd row width (A = 2: 103 words, read a word at a time), ids out of
    # range and attr words that look like NaNs
    n_odd = min(N, 100_000)
    odd_words = words32((n_odd, 2))
    odd_words[0, 0] = 0x7FC00001          # 0xFFFFFFFF and 0x80000000 next
    odd_words[1, 0], odd_words[2, 1] = -1, -2 ** 31
    odd = torch.cat([lay.packed[:n_odd, :D + 1],
                     odd_words.view(torch.float32)], dim=1)
    ids_odd = torch.randint(-1, n_odd + 1, (Bg, C), generator=gen_edge,
                            device=dev, dtype=torch.int32)
    err = max(err, check_fused_expand(torch, ops, ref, odd, ids_odd, qg, qgn,
                                      D))
    del odd, odd_words, ids_odd
    # cold rows: the beam reads new rows at every expansion, so the timed
    # calls take COLD_SETS id batches in turn; the warm figure (one batch,
    # its rows left in the L2) is printed beside it
    row_bytes = Bg * C * (D + 1 + A) * 4
    id_sets = [ids] + [torch.randint(0, N, (Bg, C), generator=gen_edge,
                                     device=dev, dtype=torch.int32)
                       for _ in range(COLD_SETS - 1)]
    fe_cold = cold_ms(torch, [lambda s=s: ops.fused_expand(lay.packed, s, qg,
                                                           qgn, d=D)
                              for s in id_sets], 50)
    fe_warm = cuda_ms(torch, lambda: ops.fused_expand(lay.packed, ids, qg, qgn,
                                                      d=D), 50)
    log(f"[kernels] fused_expand: {fe_cold:.6f} ms with cold rows "
        f"({COLD_SETS} id batches in turn, {COLD_SETS * row_bytes / 1e6:.1f} "
        f"MB of rows against the {RL.HW['l2_bytes'] / 1e6:.0f} MB L2), "
        f"{fe_warm:.6f} ms warm (one batch)")
    b, o = RL.kernel_bound_ms("fused_expand", B=Bg, C=C, d=D, A=A)
    kernels["fused_expand"] = dict(
        name="fused_expand", route="cuda",
        source="src/repro_torch/csrc/fused_expand.cu",
        replaces="src/repro/kernels/fused_expand.py:49",
        shape=f"packed[{N},{D + 1 + A}] ids[{Bg},{C}]", max_abs_err=err,
        ms=fe_cold, warm_ms=fe_warm,
        plain_ms=cuda_ms(torch, lambda: ref.fused_expand(
            lay.packed, ids, qg, qgn, d=D), 10),
        bound_ms=b, bound_by=o, library_ms=None)

    # gather_dist (no caller on a path): the graph group's expansion shapes,
    # then edge shapes: single-value loads (d = 13, a table one element off
    # 16 bytes, bf16 rows of 200 bytes), ids out of range, and C above the
    # 524,280 that a grid of (B, C / 8) allowed
    def check_gather(label, table, gids, gq):
        rows = table[gids.long().clamp(0, table.shape[0] - 1)].float()
        sc = torch.sum(rows * rows, -1) + torch.sum(gq * gq, -1)[:, None]
        return check_d2(torch, f"gather_dist {label}",
                        ops.gather_dist(table, gids, gq),
                        ref.gather_dist(table, gids, gq), sc)

    err = check_gather("main", xb, ids, qg)
    ids_out = torch.randint(-1, n_odd + 1, (Bg, C), generator=gen_edge,
                            device=dev, dtype=torch.int32)
    shifted = torch.empty(n_odd * D + 1, device=dev)[1:].view(n_odd, D)
    shifted.copy_(xb[:n_odd])
    ids_big = torch.randint(-1, n_odd + 1, (1, 600_000), generator=gen_edge,
                            device=dev, dtype=torch.int32)
    for label, table, gids, gq in (
            ("d=13", xb[:n_odd, :13].contiguous(), ids_out,
             qg[:, :13].contiguous()),
            ("shifted table", shifted, ids_out, qg),
            ("bf16", xb[:n_odd].bfloat16(), ids_out, qg),
            ("C=600000 d=4", xb[:n_odd, :4].contiguous(), ids_big,
             qg[:1, :4].contiguous())):
        err = max(err, check_gather(label, table, gids, gq))
    del ids_out, shifted, ids_big
    # cold rows, as for fused_expand (the same id batches), and warm
    gd_cold = cold_ms(torch, [lambda s=s: ops.gather_dist(xb, s, qg)
                              for s in id_sets], 50)
    gd_warm = cuda_ms(torch, lambda: ops.gather_dist(xb, ids, qg), 50)
    log(f"[kernels] gather_dist: {gd_cold:.6f} ms with cold rows (the same "
        f"{COLD_SETS} id batches; fused_expand {fe_cold:.6f}), {gd_warm:.6f} "
        f"ms warm (one batch)")
    del id_sets
    b, o = RL.kernel_bound_ms("gather_dist", B=Bg, C=C, d=D)
    kernels["gather_dist"] = dict(
        name="gather_dist", route="cuda",
        source="src/repro_torch/csrc/gather_dist.cu",
        replaces="src/repro/kernels/gather_dist.py:34",
        shape=f"xb[{N},{D}] ids[{Bg},{C}]", max_abs_err=err,
        ms=gd_cold, warm_ms=gd_warm,
        plain_ms=cuda_ms(torch, lambda: ref.gather_dist(xb, ids, qg), 10),
        bound_ms=b, bound_by=o, library_ms=None)

    # l2dist (no caller on a path): every query against a scan-sized slab
    # of slice A's rows, and kernels_bench's 256 x 8192 x 128
    xl = xb[:min(N, 262_144)]

    err, share, f64 = check_l2dist(torch, ops, ref, q_all, xl)
    b, o, b32 = RL.kernel_split_bound_ms("l2dist", B=NQ, N=len(xl), d=D)
    kernels["l2dist"] = dict(
        name="l2dist", route="cuda", source="src/repro_torch/csrc/l2dist.cu",
        replaces="src/repro/kernels/l2dist.py:44",
        shape=f"q[{NQ},{D}] xb[{len(xl)},{D}]", max_abs_err=err,
        err_share=share, vs_f64=f64,
        ms=cuda_ms(torch, lambda: ops.l2dist(q_all, xl), 10),
        plain_ms=cuda_ms(torch, lambda: ref.l2dist(q_all, xl), 3),
        bound_ms=b, bound_by=o, fp32_bound_ms=b32,
        library_ms=cuda_ms(torch, lambda: torch.mm(q_all, xl.T), 10))
    qb8 = torch.randn((256, 128), generator=gen, device=dev)
    xb8 = torch.randn((8192, 128), generator=gen, device=dev)
    err8, share8, f64_8 = check_l2dist(torch, ops, ref, qb8, xb8)
    bench = dict(max_abs_err=err8, err_share=share8, vs_f64=f64_8,
                 ms=cuda_ms(torch, lambda: ops.l2dist(qb8, xb8), 50),
                 library_ms=cuda_ms(torch, lambda: torch.mm(qb8, xb8.T), 50))
    bench["bound_ms"], bench["bound_by"], bench["fp32_bound_ms"] = \
        RL.kernel_split_bound_ms("l2dist", B=256, N=8192, d=128)
    log(f"[kernels] l2dist q[256,128] xb[8192,128] (kernels_bench): "
        f"{bench['ms']:.4f} ms (bound {bench['bound_ms']:.4f} ms by "
        f"{bench['bound_by']}, FP32 rate {bench['fp32_bound_ms']:.4f} ms, "
        f"torch.mm {bench['library_ms']:.4f} ms)")
    report["l2dist_kernels_bench"] = bench
    del xl, qb8, xb8
    torch.cuda.empty_cache()

    # flash_attention: one layer of slice C's prefill
    lm = configs.get(LM_ARCH).make_config()
    fshape = (LM_BATCH, lm.n_heads, LM_PROMPT, lm.hd)
    kshape = (LM_BATCH, lm.n_kv_heads, LM_PROMPT, lm.hd)
    fq, fk, fv = (torch.randn(sh, generator=gen, device=dev).to(lm.dtype)
                  for sh in (fshape, kshape, kshape))
    ferr = check_flash(torch, ops, ref, fq, fk, fv)
    attn = dict(B=LM_BATCH, H=lm.n_heads, Hkv=lm.n_kv_heads, T=LM_PROMPT,
                D=lm.hd)
    b, o = RL.kernel_bound_ms("flash_attention", **attn)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attn.py:66",
        shape=f"q[{','.join(map(str, fshape))}] "
              f"kv[{','.join(map(str, kshape))}] bf16 causal",
        max_abs_err=ferr,
        ms=cuda_ms(torch, lambda: ops.flash_attention(fq, fk, fv), 5),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention(fq, fk, fv), 2,
                         warmup=1),
        bound_ms=b, bound_by=o,
        library_ms=cuda_ms(torch, lambda: sdpa(fq, fk, fv, is_causal=True,
                                               enable_gqa=True), 10))
    # flash_attention_f32: the float32 check prefill's attention, same shape
    fq, fk, fv = (t.float() for t in (fq, fk, fv))
    ferr = check_flash(torch, ops, ref, fq, fk, fv)
    b, o, b32 = RL.kernel_split_bound_ms("flash_attention_f32", **attn)
    kernels["flash_attention_f32"] = dict(
        name="flash_attention_f32", route="cuda",
        source="src/repro_torch/csrc/flash_attention_f32.cu",
        replaces="src/repro/kernels/flash_attn.py:66",
        shape=f"q[{','.join(map(str, fshape))}] "
              f"kv[{','.join(map(str, kshape))}] f32 causal",
        max_abs_err=ferr,
        ms=cuda_ms(torch, lambda: ops.flash_attention(fq, fk, fv), 3),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention(fq, fk, fv), 2,
                         warmup=1),
        bound_ms=b, bound_by=o, fp32_bound_ms=b32,
        library_ms=cuda_ms(torch, lambda: sdpa(fq, fk, fv, is_causal=True,
                                               enable_gqa=True), 5))
    del fq, fk, fv
    torch.cuda.empty_cache()

    # gather_dist_tile: one block of the prefilter group's scan
    block = 4096
    pi = torch.as_tensor(groups["prefilter"], device=dev)
    Bp = len(pi)
    dp = D + (-D) % 8
    xpad = torch.nn.functional.pad(xb, (0, dp - D, 0, (-N) % block))
    qp = torch.nn.functional.pad(q_all[pi], (0, dp - D)).contiguous()
    base = torch.full((Bp,), (N // block) // 2, dtype=torch.int32,
                      device=dev)
    err, bit_exact = check_scan_tile(torch, ops, ref, xpad, base, qp, block)
    # lanes with differing bases take the per-lane path
    base2 = torch.randint(0, xpad.shape[0] // block, (64,), generator=gen,
                          device=dev, dtype=torch.int32)
    err2, exact2 = check_scan_tile(torch, ops, ref, xpad, base2,
                                   qp[:64].contiguous(), block)
    err, bit_exact = max(err, err2), bit_exact and exact2
    log(f"[kernels] gather_dist_tile bit-exact with its plain version: "
        f"{bit_exact}")
    if not bit_exact:
        raise AssertionError("gather_dist_tile is not bit-exact")
    b, o = RL.kernel_bound_ms("gather_dist_tile", B=Bp, tile=block, dp=dp)
    x_tile = xpad[int(base[0]) * block:(int(base[0]) + 1) * block]
    kernels["gather_dist_tile"] = dict(
        name="gather_dist_tile", route="cuda",
        source="src/repro_torch/csrc/gather_dist_tile.cu",
        replaces="src/repro/kernels/gather_dist.py:69",
        shape=f"xb[{xpad.shape[0]},{dp}] q[{Bp},{dp}] tile={block}",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.gather_dist_tile(xpad, base, qp,
                                                       tile=block), 50),
        plain_ms=cuda_ms(torch, lambda: ref.gather_dist_tile(
            xpad, base, qp, tile=block), 3),
        bound_ms=b, bound_by=o,
        library_ms=cuda_ms(torch, lambda: torch.mm(qp, x_tile.T), 50))

    # bitset_dist: subset validity of the prefilter group on one block
    fbits = ds.filt.data["bits"][pi].contiguous()
    abits = ds.attr.data["bits"][:block].contiguous()
    W = fbits.shape[1]
    err = check_bitset(torch, ops, ref, fbits, abits)
    # rows of the output that start off a 16-byte boundary (N % 4 != 0)
    for w_edge in (1, 33):
        err = max(err, check_bitset(torch, ops, ref, words32((Bp, w_edge)),
                                    words32((block - 3, w_edge))))
    # popcounts run on their own pipe, at an eighth of the FP32 rate
    popc_rate, popc_note = popc_ops_per_s(torch)
    log(f"[kernels] popcount rate {popc_rate:.4g} /s: {popc_note}")
    report["popc_ops_per_s"] = dict(rate=popc_rate, source=popc_note)
    b, o = RL.kernel_bound_ms("bitset_dist", B=Bp, N=block, W=W,
                              popc_rate=popc_rate)
    kernels["bitset_dist"] = dict(
        name="bitset_dist", route="cuda",
        source="src/repro_torch/csrc/bitset_dist.cu",
        replaces="src/repro/kernels/bitset.py:38",
        shape=f"a[{Bp},{W}] b[{block},{W}] op=deficit", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.subset_deficit(fbits, abits), 50),
        plain_ms=cuda_ms(torch, lambda: ref.subset_deficit(fbits, abits),
                         10),
        bound_ms=b, bound_by=o, library_ms=None)
    # the Boolean call site's width: W = 2^15 / 32 = 1024 words
    satg = torch.rand((128, 1 << 15), generator=gen, device=dev) < 0.3
    sat_w = pack_bits(satg)
    hot = onehot_words(torch.randint(0, 1 << 15, (block,), generator=gen,
                                     device=dev), 1 << 15)
    check_exact(torch, "bitset_dist[deficit, W=1024]",
                ops.subset_deficit(sat_w, hot), ref.subset_deficit(sat_w, hot))
    bool_ms = cuda_ms(torch, lambda: ops.subset_deficit(sat_w, hot), 10)
    bool_plain = cuda_ms(torch, lambda: ref.subset_deficit(sat_w, hot), 3,
                         warmup=1)
    bb, bo = RL.kernel_bound_ms("bitset_dist", B=128, N=block, W=1024,
                                popc_rate=popc_rate)
    log(f"[kernels] bitset_dist deficit a[128,1024] b[{block},1024]: "
        f"{bool_ms:.4f} ms (plain {bool_plain:.4f} ms, bound {bb:.4f} ms by "
        f"{bo})")
    report["bitset_dist_boolean_width"] = dict(
        ms=bool_ms, plain_ms=bool_plain, bound_ms=bb, bound_by=bo)
    for kr in kernels.values():
        fp32 = (f", FP32 rate {kr['fp32_bound_ms']:.4f} ms"
                if "fp32_bound_ms" in kr else "")
        log(f"[kernels] {kr['name']} {kr['shape']}: max_abs_err "
            f"{kr['max_abs_err']:.3g}, {kr['ms']:.4f} ms (plain "
            f"{kr['plain_ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms by "
            f"{kr['bound_by']}{fp32}, library {kr['library_ms']})")
    del lay, xpad, satg, hot
    torch.cuda.empty_cache()

    # -- 4. slice A: build + routed serving on the card --------------------
    log(f"[slice A] build N={N} d={D} degree={cfg.degree} "
        f"ls_build={cfg.ls_build} batch_size={cfg.batch_size} "
        f"cand_pool={cfg.cand_pool} ov_max={cfg.ov_max}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = JAGIndex.build(xb, ds.attr, cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    t_idx = time.perf_counter() - t0
    stats = idx.degree_stats()
    log(f"[slice A] build {t_idx:.1f} s, degree {stats}")
    report["slice_a"] = {"n": N, "d": D, "build_s": t_idx,
                         "batch_size": cfg.batch_size, "degree": stats}

    timings = {}

    def on_group(g, res, stats, secs):
        timings[g.route] = (len(g.ids), secs)

    ops.reset_launches()
    res, p = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                             layout="fused", return_plan=True,
                             on_group=on_group)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"[slice A] launches in the main-path run: {launches}")
    for name in ("fused_expand", "gather_dist_tile", "bitset_dist"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
    for name, n_launch in launches.items():   # gather_dist, l2dist: on
        if not name.startswith("flash"):      # no path, their 0 is kept
            kernels[name]["launches"] = n_launch
    cold = {r: (n, s) for r, (n, s) in timings.items()}
    timings.clear()
    res2 = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                           layout="fused", on_group=on_group)
    torch.cuda.synchronize()
    if not torch.equal(res.ids, res2.ids):
        raise AssertionError("two runs of the main path disagree")
    qps = {r: n / s for r, (n, s) in timings.items()}
    for r, (n, s) in timings.items():
        log(f"[slice A] {r}: {n} queries, {s * 1e3:.1f} ms, "
            f"{n / s:.1f} QPS (first run {cold[r][1] * 1e3:.1f} ms)")

    if args.profile:
        report["slice_a"]["profile"] = profile_main_path(
            lambda: idx.search_auto(q_all, ds.filt, k=K, ls=LS,
                                    max_iters=MI, layout="fused"),
            args.profile)

    ids_np = res.ids.cpu().numpy()
    if ids_np.shape != (NQ, K):
        raise AssertionError(f"result shape {ids_np.shape}")
    if not bool(torch.isfinite(res.secondary[res.ids >= 0]).all()):
        raise AssertionError("non-finite distances in the result")
    gt = exact_filtered_knn(idx.xb, idx.attr, q_all, ds.filt, k=K,
                            use_kernel=True)
    # the oracle itself, on queries whose filter passes every row, against
    # one plain product over the whole database (near-ties may swap)
    allv = torch.nonzero(gt.n_dist == N).reshape(-1)[:128]
    if allv.numel() == 0:
        raise AssertionError("slice A has no query whose filter passes all")
    qa = q_all[allv]
    d2f = (idx.xb_norm[None, :] - 2.0 * (qa @ idx.xb.T)
           + torch.sum(qa * qa, -1)[:, None])
    top = torch.topk(d2f, K, largest=False).indices.cpu().numpy()
    del d2f
    g_ids = gt.ids[allv].cpu().numpy()
    agree = float(np.mean([len(set(a) & set(b)) / K
                           for a, b in zip(top, g_ids)]))
    log(f"[slice A] exact scan vs one plain product on {allv.numel()} "
        f"unfiltered queries: {agree:.4f} of the ids agree")
    if agree < 0.99:
        raise AssertionError(f"the exact scan disagrees with a plain product"
                             f" ({agree:.4f} of ids)")
    rec = recall_at_k(ids_np, res.primary.cpu().numpy() == 0.0,
                      gt.ids.cpu().numpy())
    recall = {r: float(rec[ids].mean()) for r, ids in groups.items()}
    log(f"[slice A] recall@{K} per route: {recall}")
    rg = rec[groups["graph"]]
    spread = {"zero": float((rg == 0).mean()), "below_half": float(
        (rg < 0.5).mean()), "full": float((rg == 1).mean())}
    log(f"[slice A] graph queries' recall: share at 0 {spread['zero']:.3f},"
        f" below 0.5 {spread['below_half']:.3f}, at 1 {spread['full']:.3f}")
    report["slice_a"]["graph_recall_spread"] = spread
    gsel = torch.as_tensor(groups["graph"], device=dev)
    n_exp = res.n_expanded[gsel]
    capped = float((n_exp >= MI).float().mean())
    log(f"[slice A] graph route: mean {float(n_exp.float().mean()):.1f} "
        f"expansions, {100 * capped:.1f}% of queries stopped at "
        f"max_iters = {MI}")
    report["slice_a"]["graph_expansions"] = {
        "mean": float(n_exp.float().mean()), "share_at_cap": capped}
    if not np.array_equal(ids_np[groups["prefilter"]],
                          gt.ids.cpu().numpy()[groups["prefilter"]]):
        raise AssertionError("prefilter route differs from the exact scan")
    if stats["min"] < cfg.degree * MIN_DEGREE_SHARE:
        raise AssertionError(f"the build left a row of degree {stats['min']}"
                             f" (< {cfg.degree} x {MIN_DEGREE_SHARE})")
    if recall["graph"] < RECALL_MIN:
        raise AssertionError(f"graph-route recall@{K} {recall['graph']:.4f}"
                             f" < {RECALL_MIN}")
    report["slice_a"].update(queries={r: len(i) for r, i in groups.items()},
                             qps=qps, recall=recall, launches=launches,
                             first_run_ms={r: s * 1e3
                                           for r, (_, s) in cold.items()})
    del res, res2

    # -- 5. slice D: int8 and streaming over slice A's index ----------------
    report["slice_d"] = run_slice_d(torch, np, idx, ds, q_all, gt, recall,
                                    qps, kernels, K, LS, MI)

    # -- 6. slice E: cost model, cost routing and telemetry -----------------
    report["slice_e"] = run_slice_e(torch, np, idx, ds, q_all, gt, qps, K,
                                    LS, MI)
    # slice A's index leaves the card here, as it did before slice G; slice
    # G serves it again from these host arrays after slice C
    a_arrays = idx._save_arrays()
    del idx, gt
    torch.cuda.empty_cache()

    # -- 7. slice F: the paper's baselines and sharded serving --------------
    from repro_torch.cost import from_json
    report["slice_f"] = run_slice_f(
        torch, np, dev, from_json(json.dumps(report["slice_e"]["model"])),
        K, LS, MI, n=args.f_n, n_sift=args.f_sift_n)
    torch.cuda.empty_cache()

    # -- 8. slice B: Boolean validity through the deficit kernel -----------
    t0 = time.perf_counter()
    dsb = synthetic.msturing_bool(n=100_000, d=D, b=128, n_vars=15,
                                  device=dev)
    xbb = torch.as_tensor(dsb.xb, device=dev)
    qb = torch.as_tensor(dsb.queries, device=dev)
    ops.reset_launches()
    got = exact_filtered_knn(xbb, dsb.attr, qb, dsb.filt, k=K,
                             use_kernel=True)
    torch.cuda.synchronize()
    lb = dict(ops.LAUNCHES)
    want = exact_filtered_knn(xbb, dsb.attr, qb, dsb.filt, k=K,
                              use_kernel=True, impl=ref)
    if lb["bitset_dist"] <= 0 or lb["gather_dist_tile"] <= 0:
        raise AssertionError(f"slice B skipped a kernel: {lb}")
    check_exact(torch, "slice B ids", got.ids, want.ids)
    check_exact(torch, "slice B n_dist", got.n_dist, want.n_dist)
    n_valid = int((got.ids >= 0).sum())
    log(f"[slice B] msturing_bool N=100000 prefilter scan: ids equal to the "
        f"plain scan ({n_valid} hits), launches {lb}, "
        f"{time.perf_counter() - t0:.1f} s")
    report["slice_b"] = {"launches": lb, "hits": n_valid}

    # -- 9. slice C: dense-LM serving ------------------------------------
    del xbb, qb, got, want
    torch.cuda.empty_cache()
    full = LM_SHAPES["prefill_32k"]
    log(f"[slice C] {lm.name}: {lm.n_layers} layers, d_model {lm.d_model}, "
        f"{lm.n_heads} heads, {lm.n_kv_heads} kv heads, head_dim {lm.hd}, "
        f"d_ff {lm.d_ff}, vocab {lm.vocab}, {lm.param_count()} params, "
        f"seed {args.seed}")
    log(f"[slice C] shape cut: LM_SHAPES['prefill_32k'] batch "
        f"{full['batch']} x {full['seq']} -> {LM_BATCH} x {LM_PROMPT} to fit "
        f"the script's time limit; then {LM_STEPS} greedy decode steps")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = TT.init_params(lm, gen, dev)
    toks = torch.randint(0, lm.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                         device=dev)

    def biggest(t):
        return float(t.float().abs().max())

    # float32: the kernel against the plain attention, sum order only
    lm32 = dataclasses.replace(lm, dtype=torch.float32)
    c32 = TT.init_cache(lm32, LM_BATCH, LM_PROMPT, dev)
    ops.reset_launches()
    l32, _ = TT.prefill(lm32, params, toks, c32)
    torch.cuda.synchronize()
    l32_launches = (ops.LAUNCHES["flash_attention_f32"],
                    ops.LAUNCHES["flash_attention"])
    log(f"[slice C] float32 prefill: flash_attention_f32 launched "
        f"{l32_launches[0]} times, flash_attention {l32_launches[1]}")
    if l32_launches != (lm.n_layers, 0):
        raise AssertionError(f"float32 prefill launched {l32_launches}, not "
                             f"({lm.n_layers}, 0)")
    l32p, _ = TT.prefill(lm32, params, toks, c32, impl=ref)
    del c32
    err32 = biggest(l32 - l32p)
    log(f"[slice C] float32 prefill, kernel vs plain attention: max |d| "
        f"{err32:.3g} of largest logit {biggest(l32p):.4g}")
    if err32 > LM_F32_TOL * biggest(l32p):
        raise AssertionError("float32 prefill: the kernel moves the logits "
                             f"by {err32} (> {LM_F32_TOL} of the largest)")

    # bf16 serving: matrices stored in bf16 (the float32 masters go)
    TT.cast_matrices(params, lm.dtype)
    torch.cuda.empty_cache()
    cache = TT.init_cache(lm, LM_BATCH, LM_PROMPT + LM_STEPS, dev)
    log(f"[slice C] set-up {time.perf_counter() - t0:.1f} s (init, float32 "
        f"check, cast)")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = TT.prefill(lm, params, toks, cache)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    lc = dict(ops.LAUNCHES)
    log(f"[slice C] launches in the prefill: {lc}")
    if lc["flash_attention"] != lm.n_layers or lc["flash_attention_f32"]:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{lc['flash_attention']} times, not "
                             f"{lm.n_layers}, and flash_attention_f32 "
                             f"{lc['flash_attention_f32']} times, not 0")
    # each kernel's count from the prefill that runs it: the bf16 serving
    # prefill above, the float32 check prefill for flash_attention_f32
    kernels["flash_attention"]["launches"] = lc["flash_attention"]
    kernels["flash_attention_f32"]["launches"] = l32_launches[0]
    lp, _ = TT.prefill(lm, params, toks, cache, impl=ref)
    # bf16's own error: the plain bf16 prefill against float32
    noise = biggest(lp.float() - l32p)
    tol = LM_BF16_NOISE * noise
    err = biggest(logits - lp)
    log(f"[slice C] bf16 prefill, kernel vs plain attention: max |d| "
        f"{err:.4g} (limit {tol:.4g}: {LM_BF16_NOISE} x bf16 vs float32, "
        f"{noise:.4g})")
    if err > tol:
        raise AssertionError(f"bf16 prefill: the kernel moves the logits by "
                             f"{err} (> {tol})")

    # serving alone from here: one prefill, then the decode steps; the
    # peak covers these and nothing of the checks above
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = TT.prefill(lm, params, toks, cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    if tuple(logits.shape) != (LM_BATCH, lm.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are not "
                             "finite or not [B, V]")

    def decode(i, nxt):
        pos = torch.full((LM_BATCH,), LM_PROMPT + i, dtype=torch.int32,
                         device=dev)
        dl, _ = TT.decode_step(lm, params, cache, nxt, pos)
        return dl, dl[:, :lm.vocab].argmax(-1)

    first = logits[:, :lm.vocab].argmax(-1)
    t0 = time.perf_counter()
    d0, nxt = decode(0, first)
    torch.cuda.synchronize()
    t_step0 = time.perf_counter() - t0
    # steps 2..LM_STEPS: one window, synchronised only at its two ends;
    # events between the steps give each step's interval for the median
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(LM_STEPS)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(1, LM_STEPS):
        dl, nxt = decode(i, nxt)
        marks[i].record()
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    t_decode = t_window / (LM_STEPS - 1)
    if args.profile:
        pos = torch.full((LM_BATCH,), LM_PROMPT + LM_STEPS - 1,
                         dtype=torch.int32, device=dev)
        report["slice_c_decode_profile"] = profile_main_path(
            lambda: TT.decode_step(lm, params, cache, nxt, pos),
            str(Path(args.profile).with_suffix(".decode.json")))
    if not bool(torch.isfinite(dl).all()):
        raise AssertionError("decode logits are not finite")
    cache_itemsize = cache["k"].element_size()
    del cache
    toks1 = torch.cat([toks, first[:, None]], dim=1)
    l1, _ = TT.prefill(lm, params, toks1,
                       TT.init_cache(lm, LM_BATCH, LM_PROMPT + 1, dev))
    derr = biggest(d0 - l1)
    log(f"[slice C] decode at position {LM_PROMPT} vs a prefill over "
        f"{LM_PROMPT + 1} tokens: max |d| {derr:.4g} (limit {tol:.4g})")
    if derr > tol:
        raise AssertionError(f"decode disagrees with prefill by {derr} "
                             f"(> {tol})")
    n_tok = LM_BATCH * LM_PROMPT
    log(f"[slice C] prefill {n_tok} tokens in {t_prefill * 1e3:.1f} ms: "
        f"{n_tok / t_prefill:.1f} tokens/s (first run {t_first * 1e3:.1f} "
        f"ms); decode {t_decode * 1e3:.3f} ms per step of {LM_BATCH} "
        f"tokens (steps 2-{LM_STEPS} in one window; median step "
        f"{float(np.median(step_ms)):.3f} ms, the first step took "
        f"{t_step0 * 1e3:.1f} ms); peak memory of the prefill and decode "
        f"{peak / 2 ** 30:.2f} GiB")
    # the prefill's and a window step's work against the card's bound:
    # each weight read once (the embedding is tied to the LM head), the
    # cache written (prefill) or read up to the step's position (decode,
    # at the window's middle step)
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    kv_pos = 2 * lm.n_layers * LM_BATCH * lm.n_kv_heads * lm.hd * \
        cache_itemsize
    mid = LM_PROMPT + LM_STEPS // 2
    lm_roof = [
        RL.analyze("prefill", n_bytes=w_bytes + LM_PROMPT * kv_pos,
                   n_ops=RL.lm_model_flops(lm, LM_BATCH, LM_PROMPT,
                                           "prefill"),
                   rate=RL.HW["bf16_flops"], measured_s=t_prefill),
        RL.analyze("decode", n_bytes=w_bytes + (mid + 1) * kv_pos,
                   n_ops=RL.lm_model_flops(lm, LM_BATCH, mid, "decode"),
                   rate=RL.HW["bf16_flops"], measured_s=t_decode)]
    for r in lm_roof:
        log(f"[slice C] {r.name} roofline: {r.flops:.4g} flops, "
            f"{r.bytes:.4g} bytes; compute {r.t_comp * 1e3:.4f} ms, memory "
            f"{r.t_mem * 1e3:.4f} ms, bound by {r.bottleneck}; measured "
            f"{r.measured_s * 1e3:.3f} ms, {100 * r.bound_share:.2f}% of "
            f"its bound")
    report["slice_c"] = dict(
        roofline={r.name: dict(bound_ms=r.bound_s * 1e3, by=r.bottleneck,
                               share=r.bound_share) for r in lm_roof},
        arch=lm.name, batch=LM_BATCH, prompt=LM_PROMPT, steps=LM_STEPS,
        prefill_s=t_prefill, prefill_first_s=t_first,
        prefill_tokens_per_s=n_tok / t_prefill, decode_ms_per_step=t_decode
        * 1e3, decode_median_ms=float(np.median(step_ms)),
        decode_first_ms=t_step0 * 1e3, decode_step_ms=step_ms, peak_bytes=peak,
        launches=lc, f32_launches=l32_launches[0], f32_err=err32, bf16_err=err, bf16_vs_f32=noise,
        decode_vs_prefill=derr)
    del params, logits, lp, l32, l32p, l1
    torch.cuda.empty_cache()

    # -- 10. slice G: static analysis and launch tooling --------------------
    g_routes = run_slice_g_routes(torch, a_arrays, dev, ds, q_all, groups, K,
                                  LS, MI)
    del a_arrays
    report["slice_g"] = run_slice_g(kernels, g_routes)

    # -- 11. slice H: the LM training step and checkpoints ------------------
    report["slice_h"] = run_slice_h(torch, np, dev, args.seed)
    kernels["flash_attention"]["train_launches"] = \
        report["slice_h"]["launches"]["flash_attention"]
    kernels["flash_attention_f32"]["train_launches"] = \
        report["slice_h"]["f32_launches"]["flash_attention_f32"]

    # -- 12. slice I: llama4 serving -----------------------------------------
    torch.cuda.empty_cache()
    report["slice_i"] = run_slice_i(torch, np, dev, args.seed, kernels)

    # -- 13. slice J: llama4 training ----------------------------------------
    torch.cuda.empty_cache()
    report["slice_j"] = run_slice_j(torch, np, dev, args.seed, kernels)

    # -- 14. slice K: recsys training, serving and retrieval -----------------
    report["slice_k"] = run_slice_k(torch, np, dev, args.seed)

    # -- 15. slice L: GCN training (full batch, batched graphs, sampled) -----
    report["slice_l"] = run_slice_l(torch, np, dev, args.seed)

    # -- 16. slice M: registry, dry run, perf harness, training launcher -----
    kernels["flash_attention_bf16"] = dict(
        name="flash_attention_bf16", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attn.py:66")
    report["slice_m"] = run_slice_m(torch, np, dev, args.seed, kernels,
                                    (dry_proc, dry_json, dry_log))
    shutil.rmtree(Path(dry_json).parent, ignore_errors=True)

    report["kernels"] = [kernels[n] for n in _build.KERNELS]
    report["total_s"] = time.perf_counter() - t_start
    log(f"[done] {report['total_s']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in report["kernels"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
