#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all in parallel), then:

  1. holds the timeline verdict-reduction kernel against its plain
     PyTorch version on the card, at the main path's chunk shape
     (4,096 scenarios x 240 steps x 7 tiers), with crossing edge cases;
     it times the kernel (CUDA events over 60 calls, profiler device
     time), the wrapper's host time a call (200 calls, not synchronised)
     and the plain version on the same three input sets;
  2. holds the ELL propagation kernel against its plain version on the
     card, on the paper-scale call graph (21,979 services) and the main
     path's dark sets plus the all-preemptible worst case, and on the
     same fleet with multi-hop fail-close relay chains
     (``unsafe_chain_fraction=0.3``), where the fixed point takes more
     than 2 rounds and the round count tests the kernel's double
     buffering; it times the whole fixed point (CUDA events) and its
     device time a round (profiler);
  3. runs the main path, ``SweepEngine(device="cuda").run``, on the
     paper-scale fleet over 65,536 scenarios (16 chunks of 4,096) with
     the dependency and cascade-storm stages, checks that both kernels
     were launched in that run, holds the first 4,096 scenarios against
     the port's own CPU run, times cold and warm runs, and profiles one warm run (the
     timeline reduction's device time a chunk by kernel name);
  4. holds the telemetry histogram kernel against its plain version on
     the card, exactly: one 4,000,000-record chunk from the port's
     device sampler over the paper-scale edge universe (120,827 edges),
     every record on one edge, out-of-range ids mixed in (``n_edges``
     both a multiple of 8 and not) and an empty chunk; it times the
     kernel (events and profiler), the plain version and
     ``torch.bincount`` on the same bins;
  5. runs the slice's path, detection to hardening, on the card: the
     paper-scale fleet with fail-close relay chains, ``runtime_analysis``
     (48,330,800 records in 13 chunks), the detection graph,
     ``certify``, ``plan_hardening`` and ``regression_gate`` on a
     planted critical -> preemptible fail-close edge; checks that the
     histogram and propagation kernels were launched in that run, holds
     the counts, detections, certification, plan and gate exactly
     against the port's CPU run on the same device-sampled chunks, and
     times the stages;
  6. drives the model-kernel entry point, ``repro_torch.kernels.ops``,
     at the full widths of llama3.2-3b, gemma3-4b, qwen3-1.7b and
     phi3.5-moe: rmsnorm (hidden norm and qk-norm, and mamba2-780m's
     norms at its prefill and decode shapes), flash attention
     (causal prefill, sliding window), decode attention (GQA decode,
     local and global layers, length 1 and 0 from device int32 tensors,
     a length in a default int64 tensor on the card, each such call
     also run once under ``set_sync_debug_mode("error")``, and
     command-r-plus-104b's group of 12, hymba-1.5b's 5 and
     musicgen-large's 1; each case checked to take the route its dtype
     asks for, with its split count recorded) and
     the grouped expert matmul (up and down projections), bf16 and fp32
     (fp32 also at gemma3-4b's window 1024, where the window bites),
     plus ragged edge cases (flash attention's bf16 kernel also at d 64
     and d 32, so that each of its instantiations is held), and the SSD
     chunked scan at mamba2-780m's full width (B 2 x S 4,096, H 48,
     P 64, N 128, chunk 256; fp32 and bf16), hymba-1.5b's SSM heads
     (H 50, N 16) and edges (G = H, G 4 of H 48, one chunk, strong
     decay, a near 0, ragged P, N and chunk), each case checked to take
     the ``mma`` route, its ``ssd_*`` kernels built with no spills, its
     bound that of split TF32 (three TF32 products a float32 one, a
     product of two bf16 inputs at the bf16 rate); checks that
     each of the five kernels was launched once per shape, holds every
     output against its plain version on the same inputs (and the fp32
     SSD cases against the model's ``ssd_chunked`` in float64), and
     times the kernel (CUDA events and profiler device time), the plain
     version and the PyTorch library call that computes the same
     function, where there is one;
  7. runs the mamba2-780m model through ``repro_torch.models`` at full
     width: the fp32 forward of 2 layers (B 1 x S 512) against the port's
     CPU run on the same weights; the fp32 forward of 4 layers (B 2 x S
     512, two chunks) against 512 teacher-forced decode steps; and all 48
     layers in bf16 from the port's seeded init: prefill B 2 x S 4,096
     with the counts zeroed just before and read just after (the SSD
     kernel once a layer, rmsnorm twice a layer and once more), its time
     by CUDA events, the profiler's top device ops and the SSD kernel's
     share, the peak device memory, and bf16 decode steps at B 8;

then, after every timed path and kernel above (so that those run in the
state phases 1-7 leave them, whatever the later cases allocate and
profile):

  1b. holds the timeline verdict-reduction kernel, each case exact, at
      4,099 rows (a part-filled block), 1 and 3 rows, T 1, 33 and 241,
      R 1 and 8, and on inputs whose bases lie 4 bytes past their
      allocations;
  2b. holds the ELL propagation kernel, each case exact and on the route
      its shape names, on the planner's 512-row blast-radius batch as 16
      row groups converging at different rounds (one never changing),
      its first 33 rows and first row, a graph whose n is not a multiple
      of the cluster, every slot closed, a slab that never changes, a
      graph too wide for a cluster (the rounds route), a graph that only
      a cluster of 16 CTAs holds, an out-of-range ``ell_dst`` (which
      must raise), and the host's synchronises of one call (exactly one,
      under ``set_sync_debug_mode("warn")``);
  4b. holds the histogram kernel exactly at ``n_edges`` at the buckets
      route's limit (232,448) and one past it (the global route), on
      chunks ending inside a tile, views not 16-byte aligned and one
      record.

and last, with the metrics registry on:

  8. runs the monitored temporal sweep on phase 3's fleet and grid:
     (a) ``sweep_timeline(..., return_traces=True)`` over the 65,536
     scenarios, cold and warm, with the timeline reduction counted (one
     launch a chunk of 4,096), every trace series checked for shape,
     dtype and finite values, the summary bit-identical to a traces-off
     run, and the first 4,096 rows held against the port's CPU run; (b)
     ``obs.slo.sweep_alerts`` on the card over every availability trace,
     equal to the CPU run on every row and to the float64 ``alerts_np``
     on up to 2,048 alerting rows and 512 others drawn from seed 88,
     with ``alert_quality`` against the SLA verdict; one profiled warm
     run of (a) and of (b); (c) ``sweep_with_dependency_ensemble`` on
     the first 4,096 rows, ``temporal=False`` against the CPU run (the
     propagation kernel counted) and ``temporal=True`` bit-identical to
     a ``SweepEngine`` run under the same stage seed; (d)
     ``simulate_timeline`` at the snapshot times of a traced
     ``Orchestrator.failover()`` on a 0.02-scale fleet, card against
     CPU, then ``monitor_orchestrator`` and the Prometheus / JSONL
     exports (under ``build/``) and the Chrome trace, validated;
  9. runs the control loop around the sweep on phase 3's fleet, with
     inputs from seed 99: (a) the chaos campaign (``default_rays()``,
     tol 1/256) on the fleet hardened by ``plan_hardening`` on the card,
     against the same campaign on the CPU (statuses, brackets, probe rows
     exact), a byte-identical second run, ``verify_report`` on a fresh
     card engine and a tampered report refused; (b) 65,536 joint faults
     from ``sample_faults`` on the card (marginal means within 0.01,
     rank correlations within 0.03 of the copula's) through the
     campaign's engine (16 timeline_reduce launches, one
     fixed_point_ell), the first 4,096 rows against the CPU run; (c) a
     uniform 3-region and a weighted 5-region topology through
     ``expand_failures``, the engine and ``reduce_pattern_verdicts``,
     card against CPU; (d) ``run(soft_tau=1e-3)`` on the default grid
     thresholded against the hard booleans, the hard path bit-identical
     after it, ``soft_loss`` and its gradient card against CPU,
     ``optimize_capacity(mode="both")`` improved and verified, ms a
     gradient step and a CEM generation, ``hardening_weights`` and the
     weighted plan card against CPU; (e) ``recommend_factor`` card
     against CPU on the same host draws;
 10. runs the attention, MoE and hybrid models through
     ``repro_torch.models`` at full width, inputs from seed 26: (a) fp32
     forwards with the depth cut (llama3.2-3b 2 layers B 1 x S 512,
     gemma3-4b 6 layers S 1,280 where its 1,024 window bites, hymba-1.5b
     4 layers S 1,280, phi3.5-moe 2 layers S 512), the card's hidden
     states and last-position logits against the port's CPU run on the
     same weights, and phi3.5-moe's expert ids and queue positions equal;
     (b) fp32 teacher-forced decode against the forward (llama3.2-3b 2
     layers B 2 x S 512, hymba-1.5b 4 layers S 1,280, past its window;
     llama3.2-3b with the int8 cache, S 64, held at the reference's
     0.05 of max|logit|), and one llama3.2-3b step under
     ``set_sync_debug_mode("error")``; (c) bf16 from the port's seeded
     init: the llama3.2-3b prefill of B 2 x S 4,096 through all 28
     layers (B6 28, B4 57), its decode at B 8 against a 4,352-slot cache
     at length 4,096 (B5 28 and B4 57 a step), the phi3.5-moe prefill
     through 8 layers (B7 24, B6 8, B4 17; capacity 1,280) and the
     hymba-1.5b prefill through all 32 layers (B6 32, B8 32, B4 97), each
     with the counts zeroed just before and read just after, CUDA-event
     ms, peak device memory, and one profiled run's idle share and each
     model kernel's share of device time;
 11. runs the serving plane through ``repro_torch.serving`` and the
     serve CLI, weights from seed 27: (b) the live failover drill,
     ``run_drill(DrillSpec())``, on the card (its model's d_head 16 on
     B5's float32 route; B1 once, B5 twice and B4 five times a decode
     step, every call one phase 6 holds), equal to the port's CPU run on
     the card's weights in every verdict field, the actuation log and
     the traces, with the reference test's SLA contracts (crit
     availability at its SLO, pre below crit with its alert and its
     trace below the SLO), its wall seconds, decode steps, ms a step and
     a device-traced run's idle share; (c) llama3.2-3b's published
     config (28 layers, bf16) served through the CLI's loop
     (``launch.serve.serve``: max_batch 8, prompt 16, 16 new tokens, 32
     requests cycling the tiers, ``enter_failover()`` after 16), B5 28
     and B4 57 times a decode step, every call one phase 6 holds,
     timed, profiled, peak device memory, and the same schedule at 2
     layers fp32 on the card against the port's CPU (counters exact,
     logits within 1e-4 with the CPU fed the card's tokens, greedy
     tokens equal wherever the top-2 gap exceeds 1e-3 of max|logit|);
     (d) the serve CLI (``--requests 32 --failover-at 16``) on the card
     for the eight reduced archs whose reference CLI runs, in this
     process, each one's output equal to its ``--device cpu`` run, its
     model kernels counted (command-r-plus-104b's d 8 on B5) and every
     call one phase 6 holds; llama3.2-3b's also as ``python -m
     repro_torch.launch.serve`` in a subprocess.  Phase 6 holds, drawn
     after its earlier cases, B5 at d 8, 16 and 32 (the drill's and the
     reduced configs' heads and waves, global and windowed) and at the
     served llama's 40-slot bf16 cache for waves of 1-8, B7's float32
     route at the reduced MoE slabs, and B4 at those steps' norms;
 12. runs the training path through ``repro_torch.train``, weights and
     inputs from seed 28: (a) each of B4, B6, B7 and B8 through its
     ``torch.autograd.Function`` at one full-width shape of (c): the
     forward launches the kernel once and equals the wrapper's output,
     the input gradients equal ``torch.autograd.grad`` through the plain
     version on the same card tensors bit for bit; (b) the train CLI
     (``launch.train.main``, ``--steps 3`` at ``--batch 8 --seq 64``) on
     the card for the eight reduced archs whose reference CLI runs, in
     this process, each one's first line equal to its ``--device cpu``
     run and its per-step losses within 1e-4, three steps' launches,
     every call held in phase 6 (internvl2-76b and musicgen-large raise,
     as the reference CLI does); (c) at full width, bf16, remat "full",
     B 2 x S 2,048 from ``SyntheticLMDataset``: qwen3-1.7b, all 28
     layers, the main path, through ``Trainer`` for 4 steps with its
     final checkpoint, ``maybe_resume`` into a fresh state equal to the
     trained one bit for bit, then 2 more steps from the resumed and
     from the trained state under ``torch.use_deterministic_algorithms``,
     equal bit for bit; mamba2-780m, all 48 layers, and phi3.5-moe, 2 of
     its 32 layers (the depth cut: 32 layers of bf16 parameters, grads
     and moments do not fit 80 GB), 2 Trainer steps each, checkpoint and
     resume; every parameter's gradient non-zero on step 1, the
     launches a step (each forward kernel twice under remat), every
     call held in phase 6, ms a step, tokens/s, peak memory, a profiled
     step's idle share and the checkpoint's save and load seconds; (d)
     ``tests/test_system.py``'s story on the card (a critical serving
     engine beside a preemptible trainer, the orchestrator's eviction
     hook preempting it, T1 unharmed and T5 dark, the trainer resumed
     from its checkpoint, failback) with the test's contracts, its
     verdicts equal to the CPU run's.  Phase 6 holds, drawn after its
     earlier cases, every call phase 12 makes: the full-width training
     norms and attentions and mamba2-780m's SSD, B6's float32 route at
     d 8 and 16 (causal and windowed, S not a multiple of the tile), the
     train CLI's reduced shapes (B8 on views into the conv output) and
     the story's.
 13. The mesh path over ``torch.distributed`` (seed 29), after phase
     12: (a) a live 1 x 1 mesh (a world of one through a ``FileStore``,
     NCCL) on the card, each run equal bit for bit to its run without a
     mesh: llama3.2-3b at full width (28 layers, bf16), the B 2 x S 4,096
     prefill logits and 8 decode steps at B 8 against a 4,352-slot cache
     under ``sharding_rules``; phi3.5-moe (2 layers) prefill with
     ``MoEParallel(mode="shard_map", mesh=...)`` against ``mode="auto"``;
     one qwen3-1.7b train step at phase 12c's shape under
     ``torch.use_deterministic_algorithms`` (loss, metrics and every
     leaf); the 65,536-scenario sweep with ``mesh=`` against phase 3's
     verdicts; every kernel call held in phase 6; (b) which backend lets
     2 and 4 processes share the one card: NCCL and gloo with CUDA
     tensors, each trying all_reduce (SUM, MAX), all_gather, all_to_all
     and send/recv (last: gloo's can end its process), all worlds at
     once, one line of what ran and what was refused; where all_reduce
     runs on 4 processes, llama3.2-3b's split-KV decode at full width on
     a (1, 4) mesh of them: 4 steps at B 8 from caches that (a) filled
     with a 4,096-token prefill, so every rank's 1,088-slot block holds
     live keys (the caches' sequence split four ways, the partial
     softmax merged by pmax / psum; no B5 launch), held against (a)'s
     one-rank B5 decode from the same caches within 2x a control
     measured on the same inputs (the one-rank decode with B5's plain
     version, float32 softmax as split-KV's partials); the same decode
     with the last rank's keys dropped must miss that limit; otherwise
     the line says so; (c)
     the dry run (``launch.dryrun``) on the ``meta`` device over the
     abstract (16, 16) mesh for one arch a family x four shapes (every
     cell ``ok`` or the documented ``long_500k`` skip), the roofline
     table (``launch.roofline``, lines ``roofline |``), and the cost
     recorder's FLOPs of llama3.2-3b's prefill (B 2 x S 4,096) and of
     qwen3-1.7b's train step (B 2 x S 2,048) on the card equal exactly to
     their meta runs on a (1, 1) mesh, with each one's share of peak
     (model FLOPs over CUDA-event seconds x 989e12); ``HBM_BYTES`` equal
     to the card's total memory.  The two runs are timed right after
     (a), on a quiet host; then the dry run's cells run in six worker
     processes beside the recorder runs and (b).  No kernel is added: the
     meta route launches nothing.
 14. The last four configs at their published widths (seed 30), after
     phase 13: (a) musicgen-large (2 layers, B 1 x S 512), internvl2-76b
     and command-r-plus-104b (1 layer, S 256) in float32, the card's
     hidden states and last-position logits against the port's CPU run
     on the same weights at phase 10a's tolerance (the stub frontends fed
     seeded embeddings); kimi-k2 (1 layer, all 384 experts, B 1 x S 256)
     in bf16 on both sides, held to 2x a control measured in the same
     run (the card's run with B4, B6 and B7 swapped for their plain
     versions, against the CPU run), expert ids and queue positions
     compared token by token, any token that differs required to be a
     near tie (the CPU's router logits of the swapped experts within
     twice that token's logit drift between the runs), counted, logged
     and left out of the rows held, with at least 200 of the 256 tokens
     held and the kernels' swaps at most 2x the control's; (b) the three dense configs' float32
     2-layer teacher-forced decode against their forward (2e-3 of
     max|logit|); (c) bf16 at the published widths, the depth cut only
     where one card forces it: musicgen-large all 48 layers,
     internvl2-76b 16 of 80, command-r-plus-104b 8 of 64, kimi-k2 1 of
     61, each init's peak device memory logged and held under the card's
     memory, the prefill of B 2 x S 4,096 (forward and last-position
     logits; B6 a layer, B4 twice a layer and once more, kimi-k2's B7
     three times at 384 experts x capacity 216) and, for the dense three,
     the decode at B 8 against a 4,352-slot cache (B5 a layer, B4 twice
     a layer and once more), each counted, every kernel call one that
     phase 6 holds, timed, profiled (idle share) with peak memory; (d)
     ``serving.request_campaign`` (the arrival-spike ray, tol 1/4, 3
     rounds, ``tests/test_torch_serving_campaign.py``'s small spec) on
     the card, equal ray by ray and probe by probe to the same campaign
     on the CPU with the card's pool weights copied across, and
     ``verify_report`` replaying it on the card with no mismatch.  Phase
     6 holds, drawn after its earlier cases, B5 and B6 at d 8, 24, 80, 96
     and 192 in both dtypes (B5 at groups 1, 4 and 12, B6 causal and
     windowed; every multiple of 8 from 8 to 256 runs at the smallest
     width a route is instantiated for) and every call of (c): B4 at D
     2,048 / 7,168 / 8,192 / 12,288, B6 at 32 heads of d 64 and 64 and
     96 of d 128, B5 at groups 1, 8 and 12 against the 4,352-slot cache,
     B7 at kimi-k2's 384 x 216 x 7,168 <-> 2,048 on the wgmma route.
 15. Float16 at full width (seed 31): llama3.2-3b (28 layers), mamba2-780m
     (48) and phi3.5-moe (8 of 32) with their dtype strings replaced:
     the prefill of B 2 x S 4,096 on the kernels, counted (every call one
     phase 6 holds), timed and profiled with peak memory, then held
     against the plain versions' float16 run on the same weights and
     inputs within 2x a control measured in the same run (the plain
     versions in float32 on the widened weights): hidden states, the last
     64 positions' logits, greedy tokens token by token (a differing one
     must be a near tie), and phi3.5-moe's expert swaps at most 2x the
     control's; llama3.2-3b's decode, 4 teacher-forced steps at B 8
     against a 4,352-slot float16 cache filled from the seed, held the
     same way, then timed.  Phase 6 holds, drawn last, every float16
     call of these runs and the domains the reference's kernels take:
     B5 and B6 at d 1, 4, 12, 100, 257, 320 and 512 in the three dtypes
     (B5 at a group of 8), B8 at P 128 / N 256, at chunk 2,048 and at
     chunk 12,288 with P 130 (the long chunks held to float64 alone,
     since the plain version's float32 cumsum drifts there), B4 at
     D 20,000 and 32,768.

Grades: booleans, int32 and int64 counts, min/max and first-crossing
outputs exact; float verdicts float32-tight (rtol 1e-6); the availability
integral and mean, float32 sums in another order, rtol 3e-6 (kernel) and
1e-5 (engine); the model kernels in float32 at the reference's own
tolerances (tests/test_kernels.py, rtol = atol: flash 2e-5, decode 3e-5,
grouped matmul 2e-3, rmsnorm 1e-5, SSD scan 2e-3, its state always
float32); in bfloat16 within one rounding
step of each value (2^-7 of it) plus 2^-14 of the largest |plain|, and
at most 5% of the outputs differing at all; in float16 the same at its
step, 2^-10, and the same 5%; every case whose window
bites also shows that the plain version at window -1 and +1 falls
outside its limit; decode at length 0 exactly zero; the fp32 SSD scan no
further from a float64 evaluation than its plain version (or within
1e-5 of it), and at a chunk of 2,048 or more within 1e-4 of it plus
half a rounding step of y's dtype; the model's card forward within rtol = atol = 1e-4 of the
CPU run and its teacher-forced decode within 2e-3 of max|logit| of the
forward (the CPU tests' tolerances), an int8-cache decode within 0.05
of max|logit|, expert ids and positions exact, the kernels' gradients
and the resumed training states bit for bit, and training losses card
vs CPU within 1e-4 (float32, three steps).  Any failure exits
non-zero.  The last two lines of
standard output are a JSON object of the kernels' numbers and the JSON
result line; without a CUDA device the script exits 2 and prints no
result.  It takes no arguments: the fleets, the grid, the chunk and the
number of warm runs are fixed, so every passing run is the full-size
one.
"""

from __future__ import annotations

import os

# cuBLAS's deterministic workspace (phase 12c runs under
# torch.use_deterministic_algorithms), set before torch is imported
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import cProfile
import dataclasses
import gc
import importlib
import io
import itertools
import json
import pstats
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor),
# dense bf16 and dense TF32 tensor-core peaks (the sheet's 989 TFLOP/s
# of TF32 is quoted with sparsity)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.5e12
L2_BYTES = 50e6

THRESH = 0.999
F32_TIGHT = 1e-6
AVAIL_INT_RTOL = 3e-6
AVAIL_MEAN_RTOL = 1e-5

SCENARIOS = 65_536          # 16 chunks of 4,096
REDUCE_SHAPE = (4096, 240, 7)  # one main-path chunk: scenarios, steps, tiers
WARM_RUNS = 3
RELAY_CHAIN_FRACTION = 0.3  # multi-hop case of phase 2
HIST_CHUNK = 4_000_000      # one chunk of the detector's stream (phase 4)
DETECT_SEED = 7             # the fleet and stream seed of phases 4 and 5
REDUCE_CASES_SEED = 23      # phase 1b's inputs, one seed a case from here
TRACE_SEED = 88             # phase 8: the campaign seed and sampled rows
TRACE_ROWS = 4096           # phase 8: rows held against the CPU run
ALERT_ROWS = (2048, 512)    # phase 8b: alerting rows held, other rows held
MODEL_SEED = 15             # the random inputs of phase 6
CHAOS_SEED = 99             # phase 9: the campaign seed and sampled faults
CHAOS_FAULTS = 65_536       # phase 9b: sampled joint faults (16 chunks)
MODEL7_SEED = 16            # phase 7's weights and tokens
MODEL7_TOL = 1e-4           # phase 7a, card vs CPU: tests/test_torch_models
DECODE_TOL = 2e-3           # phase 7b, of max|logit|: tests/test_models.py
PREFILL_SHAPE = (2, 4096)   # phases 7c, 10c: batch x sequence
DECODE_BATCH = 8
MODEL10_SEED = 26           # phase 10's weights and tokens, one seed a run
KVQ_REL_TOL = 0.05          # phase 10b, int8 cache, of max|logit|:
#                             tests/test_models.py
# phase 10a, card vs CPU in fp32: (config module, layers, batch, sequence)
MODEL10_CARD_CPU = (("llama3_2_3b", 2, 1, 512),
                    ("gemma3_4b", 6, 1, 1280),     # the 1,024 window bites
                    ("hymba_1_5b", 4, 1, 1280),    # global layer 0, then windows
                    ("phi3_5_moe_42b_a6_6b", 2, 1, 512))
# phase 10b, fp32 decode vs forward: (module, layers, batch, sequence,
# kv_quant, one step under set_sync_debug_mode("error"))
MODEL10_DECODE = (("llama3_2_3b", 2, 2, 512, False, True),
                  ("hymba_1_5b", 4, 1, 1280, False, False),
                  ("llama3_2_3b", 2, 2, 64, True, False))
# phase 10c, bf16 prefill of PREFILL_SHAPE: (label, module, layers, the
# launches of one run); llama3.2-3b's decode follows its prefill.  Every
# kernel call of these runs must be one that phase 6 holds against the
# plain version (its last cases: phi3.5-moe's experts at capacity 1,280,
# hymba-1.5b's attention and float32 SSD, the 4,352-slot decode cache,
# the norms).  phi3.5-moe's 32 layers do not fit 80 GB in bf16 (~2.5 GB
# a layer)
MODEL10_PREFILL = (
    ("llama3.2-3b prefill", "llama3_2_3b", 28,
     {"flash_attention": 28, "rmsnorm": 57}),
    ("phi3.5-moe prefill", "phi3_5_moe_42b_a6_6b", 8,
     {"grouped_matmul": 24, "flash_attention": 8, "rmsnorm": 17}),
    ("hymba-1.5b prefill", "hymba_1_5b", 32,
     {"flash_attention": 32, "ssd_scan": 32, "rmsnorm": 97}),
)
MODEL11_SEED = 27           # phase 11's weights, one seed a run
TRAIN_SEED = 28             # phase 12's weights and inputs
TRAIN_SHAPE = (2, 2048)     # phase 12c: batch x sequence
# phase 12c: (label, config module, layers, Trainer steps); the first is
# the main path.  phi3.5-moe keeps 2 of its 32 layers: bf16 params, grads
# and AdamW moments of 32 layers (~42 B parameters) do not fit 80 GB
TRAIN_FULL = (("qwen3-1.7b", "qwen3_1_7b", 28, 4),
              ("mamba2-780m", "mamba2_780m", 48, 2),
              ("phi3.5-moe", "phi3_5_moe_42b_a6_6b", 2, 2))
TRAIN_MORE_STEPS = 2        # phase 12c: steps after the resume, both ways
TRAIN_CLI_ARGS = ("--steps", "3")   # phase 12b, at --batch 8 --seq 64
# phase 12b / 12d, card vs CPU, per-step losses after up to 3 AdamW steps
# in float32: both run the same algorithm in float32 (no TF32) with sums
# in other orders (cuBLAS against the CPU's BLAS, the kernels against
# their plain versions, held at the reference's float32 tolerances, 1e-5
# to 2e-5, B8 in split TF32); the CPU tests hold the port to the
# reference at 1e-5 a step, and three updates may compound it
TRAIN_LOSS_RTOL = 1e-4
# phase 11c: the serve CLI's loop (launch/serve.py serve) over one engine
# serving llama3.2-3b's published config
SERVE_FULL = {"max_batch": 8, "prompt_len": 16, "max_new": 16,
              "requests": 32, "failover_at": 16}
SERVE_PARITY_LAYERS = 2     # phase 11c's fp32 card-vs-CPU schedule
# the decode steps (first, count) traced for the idle share: a steady
# window of the drill's 4,331 steps and of the served llama's 93
DRILL_WINDOW = (1000, 300)
SERVE_WINDOW = (40, 20)
TOKEN_GAP = 1e-3            # of a row's max|logit|: a top-2 gap at most
#                             this may pick another token on the CPU
# phase 11d: the reduced archs whose reference CLI runs on the CPU
# (internvl2-76b's and musicgen-large's stub frontends take embeddings,
# the CLI hands them token ids, and both packages raise)
SERVE_ARCHS = ("llama3.2-3b", "qwen3-1.7b", "command-r-plus-104b",
               "gemma3-4b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
               "hymba-1.5b", "mamba2-780m")
SERVE_CLI_ARGS = ("--requests", "32", "--failover-at", "16")
# phase 6 float32 tolerances (rtol = atol): the reference's own,
# tests/test_kernels.py
MODEL_F32_TOL = {"flash_attention": 2e-5, "decode_attention": 3e-5,
                 "grouped_matmul": 2e-3, "rmsnorm": 1e-5, "ssd_scan": 2e-3}
# B8 against the model's ssd_chunked in float64: no further from it
# than the plain float32 version, or within this much of it (both
# relative to 1 + |float64 value|)
SSD_TRUTH_FLOOR = 1e-5
# B8 at a chunk of 2,048 or more, where the plain version's float32
# cumsum drifts from float64 (3.8e-3 at chunk 2,048) past its own
# limit: held to the float64 evaluation alone, within this much (5x the
# kernel's 1.8e-5 at chunk 2,048 in float32), plus half a rounding step
# of y's dtype where y is 16-bit
SSD_LONG_CHUNK_TOL = 1e-4
HALF_STEP = {"torch.float32": 0.0, "torch.bfloat16": 2.0 ** -8,
             "torch.float16": 2.0 ** -11}
# bfloat16: kernel and plain version both compute in float32 and round
# once to bfloat16 (8 significant bits), so an output may differ by one
# rounding step, at most 2^-7 of its value; 2^-14 of the largest |plain|
# covers the float32 summation-order difference near zero.  The
# reference's flat 2e-2 is as large as a typical decode output at full
# width.  A store that truncates instead of rounding to nearest even
# moves about half the outputs by a step, so at most 5% may differ at all.
BF16_STEP = 2.0 ** -7
BF16_FLOOR = 2.0 ** -14
BF16_MAX_DIFFER = 0.05
# float16: the same rule at its own step, 2^-10 of a value (11
# significant bits); the floor as for bfloat16
F16_STEP = 2.0 ** -10
# phase 6's kernels: wrapper name, csrc source, the Pallas call it replaces
MODEL_KERNELS = (
    ("rmsnorm", "rmsnorm", "src/repro/kernels/rmsnorm.py:36"),
    ("decode_attention", "decode_attention",
     "src/repro/kernels/decode_attention.py:103"),
    ("flash_attention", "flash_attention",
     "src/repro/kernels/flash_attention.py:102"),
    ("grouped_matmul", "grouped_matmul",
     "src/repro/kernels/grouped_matmul.py:49"),
    ("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:81"),
)


# sources whose kernels may not spill (the build fails the run)
NO_SPILL = ("timeline_reduce", "fixed_point_ell", "ingest_hist", "ssd_scan")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card: CUDA events around
    ``reps`` calls after ``warmup`` calls, synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got: dict, want: dict, rtol_for: dict, where: str) -> float:
    """Two-grade comparison of host arrays; returns the largest absolute
    difference over finite float entries."""
    check(set(got) == set(want), f"{where}: keys differ "
          f"{sorted(set(got) ^ set(want))}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{where}: {k} is {g.dtype}{g.shape}, want {w.dtype}{w.shape}")
        if w.dtype.kind != "f":
            bad = int(np.count_nonzero(g != w))
            check(bad == 0, f"{where}: {k} differs in {bad} entries")
            continue
        fin = np.isfinite(w)
        check(np.array_equal(np.isfinite(g), fin)
              and np.array_equal(g[~fin], w[~fin]),
              f"{where}: {k} non-finite entries differ")
        d = np.abs(g[fin].astype(np.float64) - w[fin].astype(np.float64))
        here = float(d.max()) if d.size else 0.0
        worst = max(worst, here)
        rtol = rtol_for.get(k, 0.0)
        lim = rtol * np.abs(w[fin].astype(np.float64))
        over = int(np.count_nonzero(d > lim))
        check(over == 0, f"{where}: {k} differs beyond rtol={rtol} in "
              f"{over} entries (max abs {here:.3g})")
    return worst


# ---------------------------------------------------------------------------
# phase 1: the timeline verdict-reduction kernel
# ---------------------------------------------------------------------------


def reduce_inputs(seed: int, S: int, T: int, R: int):
    """Engine-like series from a seed, with hand-set crossing rows where
    the shape has room for them."""
    rng = np.random.default_rng(seed)
    avail = (0.999 + 0.001 * rng.random((S, T))).astype(np.float32)
    util = (rng.random((S, T)) * 1.2).astype(np.float32)
    cloud = (rng.random((S, T)) * 2e4 - 1e3).astype(np.float32)
    frac = (0.996 + 0.006 * rng.random((S, T, R))).astype(np.float32)
    frac[0] = 1.0                        # never below
    if S > 1:
        frac[1, 0] = 0.5                 # below at t=0, back at t=1
        frac[1, 1:] = 1.0
    if S > 2:
        frac[2, T // 2:, 0] = 0.5        # below from the middle to the end
        frac[2, :T // 2, 0] = 1.0
    if S > 3 and R > 1:
        frac[3, :, 1] = 1.0
        frac[3, -1, 1] = 0.5             # below at the last step only
    if S > 4 and R > 2 and T >= 40:
        frac[4, :40, 2] = 1.0            # crossing across a 32-step window
        frac[4, 30:33, 2] = 0.5
        frac[4, 33:, 2] = 1.0
    ts = (np.arange(T) * (7200.0 / T)).astype(np.float32)
    return avail, util, cloud, frac, ts


def hold_reduce(torch, args, where: str) -> tuple:
    """B1 against its plain version on the card: the five selected
    outputs exact, avail_int within AVAIL_INT_RTOL.  Returns the host
    results, the largest absolute error and the case's record."""
    from repro_torch.kernels.ufa import reduce as red
    S, T = args[0].shape
    R = args[3].shape[2]
    got = red.timeline_reduce(*args, thresh=THRESH)
    want = red.ref_timeline_reduce(*args, thresh=THRESH)
    if args[0].is_cuda:
        torch.cuda.synchronize()
    to_np = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
    got, want = to_np(got), to_np(want)
    err = compare(got, want, {"avail_int": AVAIL_INT_RTOL}, where)
    return got, err, {"label": where, "S": S, "T": T, "R": R,
                      "max_abs_err": err}


def phase_reduce(torch, device) -> dict:
    from repro_torch.kernels.ufa import reduce as red
    S, T, R = REDUCE_SHAPE
    host = reduce_inputs(12, S, T, R)
    args = [torch.from_numpy(a).to(device) for a in host]
    got, err, case = hold_reduce(torch, args, "reduce")
    check(np.isinf(got["restore_t"][0]).all() and not got["below_seen"][0].any(),
          "reduce: never-below row")
    check((got["restore_t"][1] == host[4][1]).all(), "reduce: t=0 crossing")
    check(np.isinf(got["restore_t"][2, 0]) and got["below_seen"][2, 0],
          "reduce: never-restored tier")
    check(got["restore_t"][4, 2] == host[4][33], "reduce: window crossing")
    entry = {"name": "timeline_reduce", "route": "cuda",
             "source": "src/repro_torch/csrc/timeline_reduce.cu",
             "replaces": "src/repro/kernels/ufa/reduce.py:79",
             "max_abs_err": err, "cases": [case]}
    bytes_moved = (3 * S * T + S * T * R + T) * 4 + S * (4 * 4 + R * 5)
    ops = S * T * (5 + 2 * R)
    entry["bound_by"] = ("bytes" if bytes_moved / MEM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations")
    entry["bound_ms"] = 1e3 * max(bytes_moved / MEM_BYTES_PER_S,
                                  ops / F32_OPS_PER_S)
    entry["library_ms"] = None
    if device.type != "cuda":
        return entry
    # three input sets in turn (3 x 39 MB > the 50 MB L2), so each timed
    # launch reads its inputs from device memory
    sets = itertools.cycle([args] + [[a.clone() for a in args]
                                     for _ in range(2)])
    run = lambda: red.timeline_reduce(*next(sets), thresh=THRESH)
    entry["ms"] = device_ms(torch, run, reps=60)
    entry["plain_ms"] = device_ms(torch, lambda: red.ref_timeline_reduce(
        *next(sets), thresh=THRESH), reps=10)
    dev_ms = profiled_device_ms(torch, run, 30)
    # the wrapper's host time a call: 200 calls, not synchronised
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        run()
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    log(f"reduce: {entry['ms']:.6f} ms by events (60 calls), device "
        f"{fmt_ms(dev_ms)}, wrapper host {host_us:.3f} us a call (200 "
        f"calls); plain {entry['plain_ms']:.6f} ms; bound "
        f"{entry['bound_ms']:.6f} ms ({entry['bound_by']})")
    case.update(ms=entry["ms"], device_ms=dev_ms, host_us=host_us)
    return entry


def phase_reduce_cases(torch, device) -> list:
    """B1's later cases, each exact: a part-filled block of rows, fewer
    rows than a block, T 1, 33 and 241, R 1 and 8, and inputs whose bases
    lie 4 bytes past their allocations."""
    cases = []
    shapes = ((4_099, 240, 7, "S 4,099 (a part-filled block)"),
              (1, 240, 7, "S 1"),
              (3, 240, 7, "S 3"),
              (1_001, 1, 7, "T 1"),
              (1_000, 33, 7, "T 33"),
              (1_000, 241, 7, "T 241"),
              (1_000, 240, 1, "R 1"),
              (1_002, 240, 8, "R 8"))
    for k, (S, T, R, label) in enumerate(shapes):
        host = reduce_inputs(REDUCE_CASES_SEED + k, S, T, R)
        args = [torch.from_numpy(a).to(device) for a in host]
        cases.append(hold_reduce(torch, args, f"reduce, {label}")[2])
    # contiguous views 4 bytes past their allocations' starts
    S, T, R = REDUCE_SHAPE
    host = reduce_inputs(REDUCE_CASES_SEED + len(shapes), S, T, R)
    args = []
    for a in host[:4]:
        flat = torch.empty(a.size + 1, dtype=torch.float32, device=device)
        view = flat[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        check(view.is_contiguous() and view.data_ptr() % 16 != 0
              and view.data_ptr() - flat.data_ptr() == 4,
              "reduce: the offset view")
        args.append(view)
    args.append(torch.from_numpy(host[4]).to(device))
    cases.append(hold_reduce(torch, args, "reduce, bases 4 bytes in")[2])
    return cases


# ---------------------------------------------------------------------------
# phase 2: the ELL propagation kernel
# ---------------------------------------------------------------------------


def hold_propagation(torch, device, consts, dark: np.ndarray, where: str):
    """Kernel vs plain version on one dark batch: ``broken`` and
    ``rounds`` exact.  Returns the dark tensor, the rounds and the host
    ``broken`` matrix."""
    from repro_torch.kernels.ufa import propagation as prop
    dark_d = torch.from_numpy(dark).to(device)
    got, rounds = prop.fixed_point_ell(dark_d, consts["ell_dst"],
                                       consts["ell_closed"])
    want, ref_rounds = prop.ref_fixed_point(dark_d, consts["ell_dst"],
                                            consts["ell_closed"])
    got, want = got.cpu().numpy(), want.cpu().numpy()
    check(rounds == ref_rounds, f"{where}: rounds {rounds} != {ref_rounds}")
    bad = int(np.count_nonzero(got != want))
    check(bad == 0, f"{where}: broken differs in {bad} entries")
    check((got >= dark).all() and got.sum() > dark.sum(),
          f"{where}: the fixed point must contain the dark sets and "
          "break more")
    log(f"{where}: U={dark.shape[0]} n={dark.shape[1]} "
        f"K={consts['ell_dst'].shape[1]} rounds={rounds} "
        f"broken={int(got.sum())} dark={int(dark.sum())}")
    return dark_d, rounds, got


def phase_propagation(torch, device, graph, dark: np.ndarray) -> dict:
    from repro_torch.graph.propagation import edge_consts
    from repro_torch.kernels.ufa import propagation as prop
    consts = edge_consts(graph, device)
    dark_d, rounds, _ = hold_propagation(torch, device, consts, dark,
                                         "propagation")
    U, n = dark.shape
    K = consts["ell_dst"].shape[1]
    entry = {"name": "fixed_point_ell", "route": "cuda",
             "kernel_route": prop.fixed_point_route(U, n, K),
             "source": "src/repro_torch/csrc/fixed_point_ell.cu",
             "replaces": "src/repro/kernels/ufa/propagation.py:115",
             "max_abs_err": 0.0, "cases": []}
    check(entry["kernel_route"] == "cluster",
          f"propagation: paper scale takes the {entry['kernel_route']} route")
    # the function's own bytes, each once: the dark slab and the adjacency
    # read, broken and [rounds, error] written; the operations are every
    # round's gather and OR
    bytes_moved = 2 * U * n + n * K * 5 + 8
    ops = rounds * U * n * K * 2
    entry["bound_by"] = ("bytes" if bytes_moved / MEM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations")
    entry["bound_ms"] = 1e3 * max(bytes_moved / MEM_BYTES_PER_S,
                                  ops / F32_OPS_PER_S)
    if device.type == "cuda":
        args = (dark_d, consts["ell_dst"], consts["ell_closed"])
        entry["ms"] = device_ms(torch, lambda: prop.fixed_point_ell(*args),
                                reps=20)
        entry["plain_ms"] = device_ms(
            torch, lambda: prop.ref_fixed_point(*args), reps=5)
        dev_ms = profiled_device_ms(torch,
                                    lambda: prop.fixed_point_ell(*args), 10)
        # one round of the rounds route alone, launched back to back
        # without the host's read of the changed flag: its kernel's own
        # time per round
        cur = dark_d.clone()
        nxt = torch.empty_like(cur)
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        launch = prop._lib()
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (cur.data_ptr(), nxt.data_ptr(),
                consts["ell_dst"].data_ptr(),
                consts["ell_closed"].data_ptr(), U, n, K, flag.data_ptr(),
                stream)
        round_ms = device_ms(torch, lambda: launch(*ptrs), reps=200)
        log(f"propagation: whole fixed point {entry['ms']:.6f} ms over "
            f"{rounds} rounds, one launch and one synchronise (route "
            f"{entry['kernel_route']}, {prop.fixed_point_cluster(n, K)} CTAs "
            f"a cluster); device "
            f"{fmt_ms(dev_ms)} a call = "
            f"{fmt_ms(dev_ms and dev_ms / rounds)} a round; one round of "
            f"the rounds route alone {round_ms:.6f} ms")
        log_rounds_route(torch, prop, args, rounds, "propagation")
    entry["library_ms"] = None
    return entry


def phase_multihop(torch, device, fractions, seed: int):
    """The paper-scale fleet with fail-close relay chains between
    critical services: breakage climbs several hops, one hop per Jacobi
    round, so an in-place (Gauss-Seidel) kernel would stop in fewer
    rounds than the plain version.  ``broken`` and ``rounds`` exact.
    Returns the relay graph and its device consts."""
    from repro_torch.core.service import synthesize_fleet
    from repro_torch.graph import CallGraph
    from repro_torch.graph.propagation import (edge_consts,
                                               shared_blackhole_draws)
    from repro_torch.kernels.ufa import propagation as prop
    fs = synthesize_fleet(scale=1.0, seed=7, as_arrays=True,
                          unsafe_chain_fraction=RELAY_CHAIN_FRACTION)
    fs.apply_ufa_target_classes()
    graph = CallGraph.from_fleet_state(fs)
    consts = edge_consts(graph, device)
    dark, _ = shared_blackhole_draws(graph, fractions, seed=seed)
    dark_d, rounds, _ = hold_propagation(torch, device, consts, dark,
                                         "propagation, relay chains")
    check(rounds > 2, f"propagation, relay chains: {rounds} rounds; the "
          "case needs multi-hop chains (more than 2 rounds)")
    if device.type == "cuda":
        args = (dark_d, consts["ell_dst"], consts["ell_closed"])
        ms = device_ms(torch, lambda: prop.fixed_point_ell(*args), reps=20)
        dev_ms = profiled_device_ms(torch,
                                    lambda: prop.fixed_point_ell(*args), 10)
        log(f"propagation, relay chains: whole fixed point {ms:.6f} ms over "
            f"{rounds} rounds, one launch and one synchronise; device "
            f"{fmt_ms(dev_ms)} a call = {fmt_ms(dev_ms and dev_ms / rounds)}"
            " a round")
        log_rounds_route(torch, prop, args, rounds,
                         "propagation, relay chains")
    return graph, consts


def log_rounds_route(torch, prop, args, rounds: int, where: str) -> None:
    """The same fixed point on the rounds route (the first design: a
    launch and a flag read a round), timed beside the cluster route."""
    ms = device_ms(torch, lambda: prop._rounds(*args), reps=10)
    dev_ms = profiled_device_ms(torch, lambda: prop._rounds(*args), 5)
    log(f"{where}, rounds route on the same inputs: whole fixed point "
        f"{ms:.6f} ms over {rounds} rounds; device {fmt_ms(dev_ms)} a call "
        f"= {fmt_ms(dev_ms and dev_ms / rounds)} a round")


def row_rounds(torch, consts, dark):
    """Each row's own round count, as if it were propagated alone: the
    round after the last one in which it changed (1 if it never does)."""
    ell_dst, ell_closed = consts["ell_dst"].long(), consts["ell_closed"]
    broken = dark
    last = torch.zeros(dark.shape[0], dtype=torch.int64, device=dark.device)
    for r in range(1, dark.shape[1] + 1):
        new = broken | (broken[:, ell_dst] & ell_closed[None]).any(dim=2)
        moved = (new != broken).any(dim=1)
        if not bool(moved.any()):
            break
        last[moved] = r
        broken = new
    return (last + 1).cpu().numpy()


def hold_cases(torch, device, cases) -> list:
    """B2's later cases, each exact against the plain version (``broken``
    and ``rounds``), on the route its shape names.  ``cases``: (label,
    dark, ell_dst, ell_closed, want route).  Returns the kernels line's
    case rows."""
    from repro_torch.kernels.ufa import propagation as prop
    rows = []
    for label, dark_d, ell_dst, ell_closed, route in cases:
        U, n = dark_d.shape
        K = ell_dst.shape[1]
        took = prop.fixed_point_route(U, n, K)
        check(took == route, f"propagation, {label}: the {took} route, want "
              f"{route}")
        before = prop.fixed_point_ell.launches
        got, rounds = prop.fixed_point_ell(dark_d, ell_dst, ell_closed)
        launches = prop.fixed_point_ell.launches - before
        want, ref_rounds = prop.ref_fixed_point(dark_d, ell_dst, ell_closed)
        check(rounds == ref_rounds,
              f"propagation, {label}: rounds {rounds} != {ref_rounds}")
        bad = int((got != want).sum())
        check(bad == 0, f"propagation, {label}: broken differs in {bad} "
              "entries")
        check(device.type != "cuda"
              or launches == (1 if route == "cluster" else rounds),
              f"propagation, {label}: {launches} launches for {rounds} "
              f"rounds on the {route} route")
        ctas = prop.fixed_point_cluster(n, K) if took == "cluster" else 0
        rows.append({"label": label, "U": U, "n": n, "K": K, "route": took,
                     "ctas": ctas, "rounds": rounds, "launches": launches})
        log(f"propagation, {label}: U={U} n={n} K={K} route {took} "
            f"({ctas} CTAs a cluster) rounds {rounds} launches {launches} "
            f"broken {int(got.sum())} dark {int(dark_d.sum())}: exact")
    return rows


def phase_propagation_cases(torch, device, graph, relay, consts_relay,
                            dark_main: np.ndarray, card: str) -> list:
    """B2 on the shapes the cluster route must get right, each exact: the
    planner's 512-row blast-radius batch as 16 row groups converging at
    different rounds (one group that never changes), its first 33 rows
    and its first row; a graph whose n is not a multiple of the cluster;
    every slot closed; a slab that never changes; a graph too wide for a
    cluster (the rounds route); a graph a cluster holds only in 16 CTAs
    (non-portable); then an out-of-range ``ell_dst``, which raises, and
    the host's synchronises of one call."""
    import warnings
    from repro_torch.graph.propagation import edge_consts
    from repro_torch.kernels.ufa import propagation as prop
    rng = np.random.default_rng(22)
    ell_dst, ell_closed = consts_relay["ell_dst"], consts_relay["ell_closed"]
    n = relay.n
    # candidate sources: every fail-close callee, each alone
    cands = np.unique(relay.dst[~relay.fail_open])[:2048]
    single = np.zeros((len(cands), n), bool)
    single[np.arange(len(cands)), cands] = True
    per_row = row_rounds(torch, consts_relay,
                         torch.from_numpy(single).to(device))
    levels = np.unique(per_row[per_row > 1])
    check(len(levels) >= 3, f"propagation: relay sources converge at only "
          f"{levels.tolist()} rounds")
    dark = np.zeros((512, n), bool)
    for g in range(15):  # group g: one source at its level, 31 at or below
        level = levels[g % len(levels)]
        at = cands[per_row == level]
        below = cands[per_row <= level]
        pick = np.concatenate([rng.choice(at, 1), rng.choice(below, 31)])
        dark[32 * g + np.arange(32), pick] = True
    # group 15 stays empty: it never changes (rounds 1)
    want_groups = [prop.ref_fixed_point(
        torch.from_numpy(dark[r0:r0 + 32]).to(device), ell_dst,
        ell_closed)[1] for r0 in range(0, 512, 32)]
    check(len(set(want_groups)) > 2 and want_groups[-1] == 1,
          f"propagation: the 16 groups' rounds {want_groups} must differ")
    log(f"propagation, U=512: the 16 row groups' own rounds {want_groups}")
    dark_512 = torch.from_numpy(dark).to(device)
    # a small graph, n not a multiple of 8 or 16
    n_small = 1001
    ed_small = torch.from_numpy(rng.integers(0, n_small, (n_small, 8))
                                .astype(np.int32)).to(device)
    ec_small = torch.from_numpy(rng.random((n_small, 8)) < 0.3).to(device)
    dark_small = torch.from_numpy(rng.random((40, n_small)) < 0.02).to(device)
    base = edge_consts(graph, device)
    dark_m = torch.from_numpy(dark_main).to(device)
    def padded(width):
        """The paper graph padded with open slots to ``width``."""
        pad = width - base["ell_dst"].shape[1]
        return (torch.cat([base["ell_dst"], torch.zeros(
                    (graph.n, pad), dtype=torch.int32, device=device)], dim=1),
                torch.cat([base["ell_closed"], torch.zeros(
                    (graph.n, pad), dtype=torch.bool, device=device)], dim=1))

    # padded until a CTA's share no longer fits its shared memory (K 40 at
    # paper scale): the rounds route
    K = wide = base["ell_dst"].shape[1]
    while prop.fixed_point_route(len(dark_main), graph.n, wide) == "cluster":
        wide += 8
    ed_wide, ec_wide = padded(wide)
    # padded by one step of 8 (K 24): too wide for 8 CTAs, held by 16
    ed_16, ec_16 = padded(K + 8)
    cases = [
        ("U 512, 16 groups (relay chains)", dark_512, ell_dst, ell_closed,
         "cluster"),
        ("U 33 (relay chains)", dark_512[:33], ell_dst, ell_closed,
         "cluster"),
        ("U 1 (relay chains)", dark_512[:1], ell_dst, ell_closed, "cluster"),
        ("n 1001, not a multiple of the cluster", dark_small, ed_small,
         ec_small, "cluster"),
        ("every slot closed", dark_m, base["ell_dst"],
         torch.ones_like(base["ell_closed"]), "cluster"),
        ("a slab that never changes", torch.zeros(
            (40, graph.n), dtype=torch.bool, device=device), base["ell_dst"],
         base["ell_closed"], "cluster"),
        (f"K {wide}, the rounds route", dark_m, ed_wide, ec_wide, "rounds"),
        (f"K {K + 8}, clusters of 16", dark_m, ed_16, ec_16, "cluster"),
    ]
    rows = hold_cases(torch, device, cases)
    check(rows[7]["ctas"] == 16, f"propagation, K {K + 8}: clusters of "
          f"{rows[7]['ctas']} CTAs, want 16")
    check(rows[0]["rounds"] == max(want_groups),
          "propagation, U=512: rounds is not the largest group's")
    check(rows[5]["rounds"] == 1, "propagation: a slab that never changes "
          f"took {rows[5]['rounds']} rounds")
    if device.type == "cuda":
        # an out-of-range id raises, from the device's flag, after one
        # launch
        bad = base["ell_dst"].clone()
        bad[graph.n // 2, 0] = graph.n
        before = prop.fixed_point_ell.launches
        try:
            prop.fixed_point_ell(dark_m, bad, base["ell_closed"])
            check(False, "propagation: an out-of-range ell_dst did not raise")
        except ValueError:
            pass
        check(prop.fixed_point_ell.launches == before + 1,
              "propagation: the out-of-range check is not the kernel's")
        rows.append({"label": "ell_dst out of range", "route": "cluster",
                     "raises": "ValueError", "launches": 1})
        # the host's cost: one synchronise a call on the cluster route
        prop.fixed_point_ell(dark_m, base["ell_dst"], base["ell_closed"])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                prop.fixed_point_ell(dark_m, base["ell_dst"],
                                     base["ell_closed"])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        said = [str(w.message) for w in seen
                if "called a synchronizing CUDA operation" in str(w.message)]
        syncs = len(said)
        check(syncs == 1, f"propagation: {syncs} synchronises a call, want "
              f"1: {said}")
        rows.append({"label": "synchronises a call", "syncs": syncs})
        log(f"propagation: one call makes {syncs} synchronise "
            "(set_sync_debug_mode('warn'))")
        # the planner's batch width, timed
        args = (dark_512, ell_dst, ell_closed)
        rounds = rows[0]["rounds"]
        ms = device_ms(torch, lambda: prop.fixed_point_ell(*args), 20)
        dev_ms = profiled_device_ms(
            torch, lambda: prop.fixed_point_ell(*args), 10)
        rows[0].update(ms=ms, device_ms=dev_ms)
        log(f"propagation, U 512: whole fixed point {ms:.6f} ms over "
            f"{rounds} rounds (16 groups); device {fmt_ms(dev_ms)} a call = "
            f"{fmt_ms(dev_ms and dev_ms / rounds)} a round [{card}]")
        log_rounds_route(torch, prop, args, rounds, "propagation, U 512")
        args = (dark_m, ed_16, ec_16)
        ms = device_ms(torch, lambda: prop.fixed_point_ell(*args), 20)
        dev_ms = profiled_device_ms(
            torch, lambda: prop.fixed_point_ell(*args), 10)
        rows[7].update(ms=ms, device_ms=dev_ms)
        log(f"propagation, K {K + 8}, clusters of 16: whole fixed point "
            f"{ms:.6f} ms over {rows[7]['rounds']} rounds; device "
            f"{fmt_ms(dev_ms)} a call [{card}]")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the telemetry histogram kernel
# ---------------------------------------------------------------------------


def detection_fleet():
    """The fleet of phases 4 and 5: paper scale, 10% fail-close edges
    plus critical -> critical relay chains, UFA target classes."""
    from repro_torch.core.service import synthesize_fleet
    fs = synthesize_fleet(scale=1.0, seed=DETECT_SEED, as_arrays=True,
                          unsafe_fraction=0.10, unsafe_chain_fraction=0.05)
    fs.apply_ufa_target_classes()
    return fs


def ingest_chunk(device, edges):
    """The first sampled 4M-record chunk of the detection fleet."""
    from repro_torch.core import dependency as dep
    return next(dep._iter_trace_chunks(
        edges, HIST_CHUNK, DETECT_SEED + 1, dep.AMBIENT_CALLEE_FAILURE,
        dep.AMBIENT_CALLER_ERROR, dep.PROPAGATION_PROB,
        chunk_records=HIST_CHUNK, device=device))


def hold_ingest(torch, cases: list, e, f, r, n: int, where: str):
    """B3 against its plain version on one chunk, exactly; the case is
    appended to ``cases`` with the route its ``n`` takes."""
    from repro_torch.kernels.ufa import ingest as ing
    got = ing.ingest_hist(e, f, r, n)
    want = ing.ref_ingest_hist(e, f, r, n)
    check(got.dtype == torch.int32 and got.shape == (n, 4),
          f"{where}: got {got.dtype}{tuple(got.shape)}")
    bad = int((got != want).sum())
    check(bad == 0, f"{where}: histogram differs in {bad} bins")
    kept = int(((e >= 0) & (e < n)).sum())
    check(int(got.sum()) == kept, f"{where}: counts sum to "
          f"{int(got.sum())}, want {kept}")
    cases.append({"label": where, "records": int(e.shape[0]),
                  "n_edges": n, "route": ing.ingest_hist_route(n)})
    return got


def phase_ingest(torch, device, edges) -> dict:
    """Kernel vs plain version, exact, on a sampled chunk, a one-edge
    chunk, out-of-range ids and an empty chunk; then the timings."""
    from repro_torch.kernels.ufa import ingest as ing
    n_edges = edges.n
    eid, failed, errored = ingest_chunk(device, edges)
    cases = []

    def hold(e, n, where):
        return hold_ingest(torch, cases, e, failed, errored, n, where)

    hist = hold(eid, n_edges, "ingest, sampled chunk")
    per_edge = hist.sum(dim=1)
    hot = int(per_edge.argmax())
    log(f"ingest: {HIST_CHUNK} records over {n_edges} edges, hottest edge "
        f"{hot} with {int(per_edge[hot])} records, "
        f"{int((per_edge > 0).sum())} edges seen")
    one = torch.full_like(eid, hot)
    hold(one, n_edges, "ingest, one edge")
    wild = eid.clone()
    wild[::7] = n_edges
    wild[1::11] = n_edges + 1 + torch.arange(
        len(wild[1::11]), device=device, dtype=torch.int32) % 1000
    wild[2::13] = -1
    for n in (n_edges, n_edges // 8 * 8):
        hold(wild, n, f"ingest, out-of-range ids, n_edges={n}")
    before = ing.ingest_hist.launches
    empty = ing.ingest_hist(eid[:0], failed[:0], errored[:0], n_edges)
    check(empty.shape == (n_edges, 4) and not bool(empty.any())
          and ing.ingest_hist.launches == before,
          "ingest, empty chunk: zeros without a launch")

    entry = {"name": "ingest_hist", "route": "cuda",
             "kernel_route": ing.ingest_hist_route(n_edges),
             "source": "src/repro_torch/csrc/ingest_hist.cu",
             "replaces": "src/repro/kernels/ufa/ingest.py:84",
             "max_abs_err": 0.0, "cases": cases}
    check(entry["kernel_route"] == "buckets",
          f"ingest: paper scale takes the {entry['kernel_route']} route")
    # each record read once (4 B id, 1 B + 1 B flags), the histogram
    # written once; one add per record
    bytes_moved = HIST_CHUNK * 6 + n_edges * 4 * 4
    ops = HIST_CHUNK
    entry["bound_by"] = ("bytes" if bytes_moved / MEM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations")
    entry["bound_ms"] = 1e3 * max(bytes_moved / MEM_BYTES_PER_S,
                                  ops / F32_OPS_PER_S)
    if device.type == "cuda":
        # three input sets in turn (3 x 24 MB > the 50 MB L2), so each
        # timed launch reads its records from device memory
        data = [(eid, failed, errored)] + [
            tuple(a.clone() for a in (eid, failed, errored))
            for _ in range(2)]
        sets = itertools.cycle(data)
        entry["ms"] = device_ms(torch, lambda: ing.ingest_hist(
            *next(sets), n_edges), reps=30)
        entry["plain_ms"] = device_ms(torch, lambda: ing.ref_ingest_hist(
            *next(sets), n_edges), reps=10)
        bins = itertools.cycle([e.long() * 4 + f.long() * 2 + r.long()
                                for e, f, r in data])
        entry["library_ms"] = device_ms(torch, lambda: torch.bincount(
            next(bins), minlength=4 * n_edges), reps=10)
        one_ms = device_ms(torch, lambda: ing.ingest_hist(
            one, failed, errored, n_edges), reps=10)
        by_kernel = profiled_kernels_ms(torch, lambda: ing.ingest_hist(
            *next(sets), n_edges), reps=10)
        one_by_kernel = profiled_kernels_ms(torch, lambda: ing.ingest_hist(
            one, failed, errored, n_edges), reps=10)
        dev_ms = sum(by_kernel.values()) or None
        one_dev_ms = sum(one_by_kernel.values()) or None
        for what, split in (("sampled chunk", by_kernel),
                            ("one edge", one_by_kernel)):
            log(f"ingest, {what}: device ms by kernel " + ", ".join(
                f"{k.split('(')[0]} {v:.6f}" for k, v in split.items()))
        # the global route (the first design: one global atomic a record)
        # on the same chunks
        glob = ing._lib("ingest_hist_launch")
        stream = torch.cuda.current_stream().cuda_stream
        for what, chunks in (("sampled chunk", data),
                             ("one edge", [(one, failed, errored)])):
            pick = itertools.cycle(chunks)

            def global_route():
                e, f, r = next(pick)
                out = torch.empty((n_edges, 4), dtype=torch.int32,
                                  device=device)
                check(glob(e.data_ptr(), f.data_ptr(), r.data_ptr(),
                           e.shape[0], n_edges, out.data_ptr(), stream) == 0,
                      "ingest: the global route failed to launch")
            log(f"ingest, {what}, global route on the same inputs: "
                f"{device_ms(torch, global_route, reps=10):.6f} ms (device "
                f"{fmt_ms(profiled_device_ms(torch, global_route, 5))})")
        one_lib_ms = device_ms(torch, lambda: torch.bincount(
            one.long() * 4 + failed.long() * 2 + errored.long(),
            minlength=4 * n_edges), reps=3)
        cases[0].update(ms=entry["ms"], device_ms=dev_ms,
                        library_ms=entry["library_ms"])
        cases[1].update(ms=one_ms, device_ms=one_dev_ms,
                        library_ms=one_lib_ms)
        log(f"ingest: kernel {entry['ms']:.6f} ms (device {fmt_ms(dev_ms)}; "
            f"{HIST_CHUNK / entry['ms'] / 1e6:.3f} G records/s, route "
            f"{entry['kernel_route']}), torch.bincount on the same bins "
            f"{entry['library_ms']:.6f} ms "
            f"(kernel / bincount = {entry['ms'] / entry['library_ms']:.3f}),"
            f" every record on one edge {one_ms:.6f} ms (device "
            f"{fmt_ms(one_dev_ms)}; torch.bincount {one_lib_ms:.6f} ms)")
    else:
        entry["library_ms"] = None
    return entry


def phase_ingest_cases(torch, device, edges) -> list:
    """B3's later cases, each exact, on the route its ``n_edges`` names:
    the buckets route's limit and one past it, ids on both sides of the
    range, chunks that end inside a tile or a warp's load, views that are
    not 16-byte aligned, one record."""
    from repro_torch.kernels.ufa import ingest as ing
    n_edges = edges.n
    eid, failed, errored = ingest_chunk(device, edges)
    cases = []
    gen = torch.Generator(device=device).manual_seed(DETECT_SEED + 22)
    n_big = 3_000_001
    ids = torch.randint(-100, ing.LIMIT + 100, (n_big,), generator=gen,
                        device=device, dtype=torch.int32)
    f_big = torch.rand(n_big, generator=gen, device=device) < 0.3
    r_big = torch.rand(n_big, generator=gen, device=device) < 0.3
    for n, route in ((ing.LIMIT, "buckets"), (ing.LIMIT + 1, "global")):
        check(ing.ingest_hist_route(n) == route,
              f"ingest: n_edges={n} takes the {ing.ingest_hist_route(n)} "
              f"route, want {route}")
        hold_ingest(torch, cases, ids, f_big, r_big, n,
                    f"ingest, n_edges={n} ({route}), ids in [-100, "
                    f"{ing.LIMIT + 100})")
    for N in (HIST_CHUNK - 3, 8191, 8193, 100_003, 1):
        hold_ingest(torch, cases, eid[:N], failed[:N], errored[:N],
                    n_edges, f"ingest, N={N}")
    for skip in (1, 3):
        hold_ingest(torch, cases, eid[skip:], failed[skip:],
                    errored[skip:], n_edges,
                    f"ingest, a view {skip} records in")
    return cases


# ---------------------------------------------------------------------------
# phase 5: detection to hardening
# ---------------------------------------------------------------------------


def host_ms(torch, device, fn, reps: int) -> float:
    """Mean wall milliseconds of ``fn()``, synchronised after the last."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def same_plan(a, b, where):
    check(a.hardened_edges == b.hardened_edges,
          f"{where}: hardened edges differ")
    check(a.trajectory == b.trajectory, f"{where}: trajectories differ")
    check(a.rounds == b.rounds and a.certified == b.certified,
          f"{where}: rounds {a.rounds} vs {b.rounds}, certified "
          f"{a.certified} vs {b.certified}")


def same_cert(a, b, where):
    for k in ("ok", "n_broken_critical", "n_critical", "n_dark", "rounds"):
        check(getattr(a, k) == getattr(b, k), f"{where}: {k} differs")
    for k in ("broken", "broken_critical", "multi_hop"):
        check(np.array_equal(getattr(a, k), getattr(b, k)),
              f"{where}: {k} differs")


def phase_harden(torch, device, fs, card: str) -> dict:
    """The slice's path, counted: runtime detection, the detection graph,
    certification, the hardening plan and the gate.  Then the port's CPU
    run on the same chunks and graph, exactly, and the timings."""
    from repro_torch.core import dependency as dep
    from repro_torch.graph import (blast_radius, certify, plan_hardening,
                                   regression_gate)
    from repro_torch.graph.propagation import _CHUNK
    from repro_torch.kernels.ufa.ingest import ingest_hist
    from repro_torch.kernels.ufa.propagation import fixed_point_ell

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # the path, counts zeroed just before and read just after
    ingest_hist.launches = 0
    fixed_point_ell.launches = fixed_point_ell.rounds = 0
    sync()
    t0 = time.perf_counter()
    ra = dep.runtime_analysis(fs, seed=DETECT_SEED, device=device)
    t1 = time.perf_counter()
    graph = ra["graph"]
    cert = certify(graph, device=device)
    t2 = time.perf_counter()
    plan = plan_hardening(graph, device=device)
    t3 = time.perf_counter()
    hardened = plan.graph
    crit = hardened.names[int(np.flatnonzero(hardened.critical)[0])]
    pre = hardened.names[int(np.flatnonzero(hardened.preemptible)[0])]
    planted = hardened.with_edge(crit, pre, fail_open=False)
    gate = regression_gate(hardened, planted, device=device)
    gate_self = regression_gate(hardened, hardened, device=device)
    sync()
    t4 = time.perf_counter()
    launches = {"ingest_hist": ingest_hist.launches,
                "fixed_point_ell": fixed_point_ell.launches}
    prop_rounds = fixed_point_ell.rounds
    check(launches["ingest_hist"] > 0, "detection launched no ingest_hist")
    check(launches["fixed_point_ell"] > 0,
          "certify/plan/gate launched no fixed_point_ell")
    det = ra["detector"]
    n_rec = ra["n_records"]
    check(det.n_records == n_rec, f"counts sum to {det.n_records}, "
          f"want {n_rec} records")
    check(ra["false_positives"] == 0,
          f"{ra['false_positives']} false positives")
    check(ra["missed"] == ra["missed_cold"],
          f"missed {ra['missed']} edges, only {ra['missed_cold']} cold")
    check(graph.unsafe_edge_keys() == ra["found"],
          "the detection graph is not the detections")
    check(plan.certified and certify(hardened, device=device).ok,
          "the plan does not certify")
    check(not gate.ok and gate.violations,
          "the gate passed a planted critical -> preemptible edge")
    check(gate_self.ok, "the hardened graph fails its own gate")
    log(f"harden path launches: ingest_hist {launches['ingest_hist']}, "
        f"fixed_point_ell {launches['fixed_point_ell']} (one per fixed point "
        f"on the cluster route) over {prop_rounds} rounds")
    log(f"detection: {n_rec} records over {len(det.calls)} edges, found "
        f"{len(ra['found'])} of {len(ra['truth'])} unsafe "
        f"(recall {ra['recall']:.4f}, missed {ra['missed']}, all cold), "
        f"false positives 0; certify: {cert.n_broken_critical} of "
        f"{cert.n_critical} critical broken in {cert.rounds} rounds; plan: "
        f"{plan.n_hardened} edges in {plan.rounds} rounds, certified; "
        f"gate: {len(gate.violations)} violation(s) on the planted edge")
    log(f"harden path cold: runtime_analysis {t1 - t0:.4f} s "
        f"(gen+ingest {ra['gen_ingest_s']:.4f} s, "
        f"{ra['records_per_s']:.1f} records/s), certify {1e3 * (t2 - t1):.3f}"
        f" ms, plan_hardening {t3 - t2:.4f} s, gates "
        f"{1e3 * (t4 - t3):.3f} ms [{card}]")

    # the port's CPU run on the same device-sampled chunks and graph
    t0 = time.perf_counter()
    cpu_det = dep.RuntimeFailCloseDetector(edges=det.edges, device="cpu")
    for chunk in dep._iter_trace_chunks(
            det.edges, n_rec, DETECT_SEED, dep.AMBIENT_CALLEE_FAILURE,
            dep.AMBIENT_CALLER_ERROR, dep.PROPAGATION_PROB, device=device):
        cpu_det.ingest_batch(*(c.cpu() for c in chunk))
    for k in ("calls", "callee_failures", "errors_given_failure",
              "errors_given_ok"):
        check(np.array_equal(getattr(cpu_det, k), getattr(det, k)),
              f"harden vs cpu: {k} differs")
    check(np.array_equal(cpu_det.detect_mask(), det.detect_mask()),
          "harden vs cpu: detect_mask differs")
    same_cert(certify(graph, device="cpu"), cert, "harden vs cpu, certify")
    # B2 at the widest batch the path gives it: the planner's sources
    # (preemptible callees of fail-close edges), topped up with other
    # callees to one full _CHUNK-row radius_counts batch; counts exact
    unsafe_dst = graph.dst[~graph.fail_open]
    ranked = np.unique(unsafe_dst[graph.preemptible[unsafe_dst]])
    others = np.setdiff1d(np.unique(graph.dst), ranked)
    sources = np.concatenate([ranked, others[:max(0, _CHUNK - len(ranked))]])
    radius = blast_radius(graph, sources, device=device)
    check(np.array_equal(blast_radius(graph, sources, device="cpu"), radius),
          f"harden vs cpu: blast_radius over {len(sources)} sources differs")
    plan_cpu = plan_hardening(graph, device="cpu")
    same_plan(plan_cpu, plan, "harden vs cpu, plan")
    for g_cpu, g_dev, what in (
            (regression_gate(hardened, planted, device="cpu"), gate,
             "planted"),
            (regression_gate(hardened, hardened, device="cpu"), gate_self,
             "self")):
        check((g_cpu.ok, g_cpu.new_unsafe_edges, g_cpu.violations)
              == (g_dev.ok, g_dev.new_unsafe_edges, g_dev.violations),
              f"harden vs cpu: gate ({what}) differs")
    log(f"phase 5 ok: gpu == cpu on the counts, detect_mask, certify, "
        f"blast_radius ({len(sources)} sources, {len(ranked)} ranked, max "
        f"{int(radius.max())}), plan ({plan.n_hardened} edges) and gate; "
        f"cpu run {time.perf_counter() - t0:.2f} s")

    if device.type == "cuda":
        for _ in range(2):
            sync()
            with GcTime() as gct:
                t0 = time.perf_counter()
                warm = dep.runtime_analysis(fs, seed=DETECT_SEED,
                                            device=device)
                wall = time.perf_counter() - t0
            check(warm["found"] == ra["found"], "warm run found other edges")
            log(f"runtime_analysis warm: {wall:.4f} s "
                f"({n_rec / wall:.1f} records/s end to end; gen+ingest "
                f"{warm['gen_ingest_s']:.4f} s, {warm['records_per_s']:.1f} "
                f"records/s; {gct}) [{card}]")
        detect = host_ms(torch, device, det.detect_mask, reps=5)
        cert_ms = host_ms(torch, device,
                          lambda: certify(graph, device=device), reps=5)
        gate_ms = host_ms(torch, device, lambda: regression_gate(
            hardened, planted, device=device), reps=5)
        t0 = time.perf_counter()
        plan_hardening(graph, device=device)
        plan_s = time.perf_counter() - t0
        log(f"harden path warm: detect_mask {detect:.3f} ms, certify "
            f"{cert_ms:.3f} ms, regression_gate {gate_ms:.3f} ms, "
            f"plan_hardening {plan_s:.4f} s over {plan.rounds} rounds "
            f"[{card}]")
        def run():
            return dep.runtime_analysis(fs, seed=DETECT_SEED, device=device)

        profile_run("runtime_analysis", torch, run, card)
        # the host's share: the same warm call under cProfile (which slows
        # Python calls, not device work), the functions by self time
        prof = cProfile.Profile()
        prof.enable()
        run()
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(14)
        for line in out.getvalue().splitlines():
            if line.strip():
                log("host profile runtime_analysis |", line)
    return launches


def profile_run(what: str, torch, fn, card: str, stats=None) -> dict:
    """One profiled call of ``fn``: the kernel table and the device's
    busy time against the wall.  Returns device microseconds by kernel
    name (empty when the trace holds no device time); ``stats``, a dict,
    receives ``busy_us``, ``wall_us`` and ``idle_share`` (None when not
    measured)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return profile_report(what, prof, wall_us, card, stats)


def profile_report(what: str, prof, wall_us: float, card: str,
                   stats=None) -> dict:
    """``profile_run``'s tables and returns for a finished profile and
    the wall time it covered."""
    events = prof.key_averages()
    kernels_us = {e.key: e.self_device_time_total for e in events
                  if str(e.device_type).endswith("CUDA")}
    busy_us = sum(kernels_us.values())
    if stats is not None:
        stats.update(busy_us=busy_us, wall_us=wall_us, idle_share=(
            1 - busy_us / wall_us if busy_us > 0 else None))
    table = events.table(sort_by="self_device_time_total", row_limit=25,
                         max_name_column_width=60)
    for line in table.splitlines():
        log(f"profile {what} |", line)
    if busy_us > 0:
        log(f"profile {what}: device busy {busy_us:.1f} us of "
            f"{wall_us:.1f} us wall (idle share {1 - busy_us / wall_us:.4f})"
            f" [{card}]")
        for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]:
            log(f"profile {what}: {us:12.1f} us  {name[:90]}")
    else:
        log(f"profile {what}: no device time in the trace; not measured")
    return kernels_us


class GcTime:
    """Seconds the cyclic garbage collector runs, and its full
    collections, inside a ``with`` block: the share of a timed host run
    spent freeing garbage, some of it left by earlier code (a profiler
    trace's events form reference cycles)."""

    def __enter__(self):
        self.s, self.full, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._seen)
        return self

    def _seen(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.full += info["generation"] == 2
            self._t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._seen)

    def __str__(self):
        return f"gc {self.s:.4f} s, {self.full} full"


# ---------------------------------------------------------------------------
# phase 6: the model kernels behind repro_torch.kernels.ops
# ---------------------------------------------------------------------------


def profiled_device_ms(torch, fn, reps: int):
    """Milliseconds of device time a call of ``fn`` takes, from the
    profiler: the kernels' own time, without the host's gaps between
    calls (which CUDA events around back-to-back calls include).  None
    when the trace holds no device time (not measured)."""
    us = sum(profiled_kernels_ms(torch, fn, reps).values())
    return us if us > 0 else None


def profiled_kernels_ms(torch, fn, reps: int) -> dict:
    """Device milliseconds a call of ``fn`` spends in each kernel (and
    copy or memset), by name, from the profiler; empty when the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0}


def model_limit(torch, op: str, dtype, want):
    """Per-entry limit on ``|kernel - plain|`` and its description: the
    reference's rtol = atol for float32; for bfloat16 and float16 one
    rounding step of each value plus ``BF16_FLOOR`` of the largest
    |plain|."""
    if dtype == torch.float32:
        tol = MODEL_F32_TOL[op]
        return tol + tol * want.abs(), f"rtol=atol={tol}"
    floor = BF16_FLOOR * float(want.abs().max())
    step, name = ((BF16_STEP, "2^-7") if dtype == torch.bfloat16
                  else (F16_STEP, "2^-10"))
    return (step * want.abs() + floor,
            f"{name}*|plain| + {floor:.3g} (2^-14 * max|plain|)")


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.6f} ms"


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash mask allows: the work this input
    needs, counted per (sequence, head)."""
    q = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros_like(q)
    hi = q + 1 if causal else np.full_like(q, S)
    return int((hi - lo).sum())


def experts_at_a_time(plain, n: int):
    """``plain`` on (E, C, D) x (E, D, F) inputs, run over ``n`` experts at
    a time (experts are independent): the plain B7 widens its weights to
    float32, 21 GiB for kimi-k2's 384 experts at once."""
    import torch

    def run(x, w):
        return torch.cat([plain(x[e:e + n], w[e:e + n])
                          for e in range(0, x.shape[0], n)])
    return run


def heads_at_a_time(plain, n: int):
    """``plain`` on (B, S, H, d) inputs, run over ``n`` heads at a time
    (heads are independent): the same values in less memory."""
    import torch

    def run(q, k, v, **kw):
        return torch.cat([plain(q[:, :, h:h + n], k[:, :, h:h + n],
                                v[:, :, h:h + n], **kw)
                          for h in range(0, q.shape[2], n)], dim=2)
    return run


def model_cases(torch, device):
    """Phase 6's shapes at the full widths of llama3.2-3b, gemma3-4b,
    qwen3-1.7b and phi3.5-moe.  Each case: the op, a label, the inputs
    (random, from a seed, made on the card), the plain version and the
    library call on the same inputs, bytes and operations for the bound,
    the tolerance (the reference's, tests/test_kernels.py) and the number
    of timed calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device)
    gen.manual_seed(MODEL_SEED)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16

    def mma_route(dt, d):
        # B5's and B6's route for a contiguous input (backend.head_dim_route)
        return "mma" if dt in (bf16, f16) and d % 8 == 0 and d <= 256 \
            else "fma"

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=f32).to(dtype)

    cases = []

    def add(op, label, args, kwargs, plain, library, bytes_moved, flops,
            dtype, reps, check=None, shift=None, truth=None, bf16_flops=0,
            route=None, float64_tol=None):
        cases.append(dict(op=op, label=label, args=args, kwargs=kwargs,
                          plain=plain, library=library,
                          bytes=bytes_moved, flops=flops, dtype=dtype,
                          reps=reps, check=check, shift=shift, truth=truth,
                          bf16_flops=bf16_flops, route=route,
                          float64_tol=float64_tol))

    def norm_case(label, R, D, dt):
        x, s = randn(R, D, dtype=dt), randn(D, dtype=dt)
        size = x.element_size()
        add("rmsnorm", label, (x, s), {}, ref.ref_rmsnorm,
            lambda x, s: F.rms_norm(x, (x.shape[-1],), s, 1e-6),
            2 * R * D * size + D * size, 4 * R * D, dt, 50)

    # B4: llama3.2-3b hidden norm (B 4 x S 4,096 tokens), qwen3 qk-norm;
    # mamba2-780m's norms as phase 7c gives them: ln1 and final_norm at
    # d_model 1,536 and the gated norm at d_inner 3,072, over the prefill's
    # 2 x 4,096 tokens and the decode step's batch of 8
    for label, (R, D), dt in (("llama3.2-3b hidden norm", (16384, 3072), bf16),
                              ("llama3.2-3b hidden norm", (16384, 3072), f32),
                              ("qwen3-1.7b qk-norm", (262144, 128), bf16),
                              ("edge: odd rows and width", (1001, 1001), bf16),
                              ("mamba2-780m ln1 / final_norm, prefill",
                               (8192, 1536), bf16),
                              ("mamba2-780m gated norm, prefill",
                               (8192, 3072), bf16),
                              ("mamba2-780m ln1 / final_norm, decode B 8",
                               (8, 1536), bf16),
                              ("mamba2-780m gated norm, decode B 8",
                               (8, 3072), bf16)):
        norm_case(label, R, D, dt)

    def flash_case(label, B, S, H, d, causal, window, dt, reps):
        q, k, v = (randn(B, S, H, d, dtype=dt) for _ in range(3))
        route = mma_route(dt, d)
        pos = torch.arange(S, device=device)
        allowed = pos[None, :] <= pos[:, None] if causal else \
            torch.ones((S, S), dtype=torch.bool, device=device)
        if window > 0:
            allowed &= (pos[:, None] - pos[None, :]) < window

        def sdpa(q, k, v, causal=causal, window=window, allowed=allowed):
            args = [t.transpose(1, 2) for t in (q, k, v)]
            if window > 0:
                out = F.scaled_dot_product_attention(*args, attn_mask=allowed)
            else:
                out = F.scaled_dot_product_attention(*args, is_causal=causal)
            return out.transpose(1, 2)

        # the plain version's float32 (B, H, S, S) scores, at most 32
        # heads at a time (command-r-plus-104b's 96 heads over 4,096
        # positions would take 12.9 GB a copy)
        plain = ref.ref_flash_attention if H <= 32 else \
            heads_at_a_time(ref.ref_flash_attention, 32)
        add("flash_attention", label, (q, k, v),
            {"causal": causal, "window": window}, plain, sdpa,
            4 * B * S * H * d * q.element_size(),
            4 * B * H * d * attention_pairs(S, causal, window), dt, reps,
            shift=(lambda e, a=(q, k, v), causal=causal, window=window:
                   (a, {"causal": causal, "window": window + e}))
            if 0 < window < S else None, route=route)

    # B6: llama3.2-3b prefill (KV 8 repeated to 24 heads), gemma3-4b local
    for args in (
            ("llama3.2-3b prefill", 2, 4096, 24, 128, True, 0, bf16, 5),
            ("gemma3-4b local layer", 2, 4096, 8, 256, True, 1024, bf16, 5),
            ("llama3.2-3b prefill fp32", 1, 1024, 24, 128, True, 0, f32, 5),
            ("gemma3-4b local layer fp32", 1, 2048, 8, 256, True, 1024, f32,
             5),
            ("edge: ragged S, window", 1, 1000, 4, 128, True, 100, bf16, 5),
            ("edge: ragged S, not causal", 1, 520, 2, 64, False, 0, f32, 5)):
        flash_case(*args)

    # B5: llama3.2-3b decode, gemma3-4b local and global decode, edges
    def valid_count(K, length, window):
        lo = max(0, length - window) if window > 0 else 0
        return max(0, min(length, K) - lo)

    def decode_case(label, shape, length, window, dt):
        B, H, KV, d, K = shape
        q = randn(B, H, d, dtype=dt)
        kc, vc = randn(B, K, KV, d, dtype=dt), randn(B, K, KV, d, dtype=dt)
        n_valid = valid_count(K, length, window)
        arg = (torch.tensor(length, dtype=torch.int32, device=device)
               if "device int32" in label else
               torch.tensor(length, device=device)   # torch's default int64
               if "int64 length" in label else length)
        pos = torch.arange(K, device=device)
        mask = ((pos < length) & ((length - 1 - pos) < window
                                  if window > 0 else True))[None, None, None]

        def sdpa_decode(q, kc, vc, length, window, mask=mask):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)[:, :, 0]

        size = q.element_size()
        add("decode_attention", label, (q, kc, vc, arg, window), {},
            ref.ref_decode_attention, sdpa_decode if n_valid else None,
            2 * n_valid * B * KV * d * size + 2 * B * H * d * size,
            4 * B * H * d * n_valid, dt, 50,
            check=(lambda out: not bool(out.any())) if length == 0 else None,
            shift=(lambda e, a=(q, kc, vc, arg), window=window:
                   ((*a, window + e), {}))
            if 0 < window < length else None,
            route=mma_route(dt, d))

    for args in (
            ("llama3.2-3b decode", (8, 24, 8, 128, 8192), 6000, 0, bf16),
            ("gemma3-4b local decode", (8, 8, 4, 256, 8192), 8192, 1024, bf16),
            ("gemma3-4b global decode", (8, 8, 4, 256, 8192), 8192, 0, bf16),
            ("llama3.2-3b decode, length 1 (device int32)",
             (8, 24, 8, 128, 8192), 1, 0, bf16),
            ("llama3.2-3b decode, length 0 (device int32)",
             (8, 24, 8, 128, 8192), 0, 0, bf16),
            ("llama3.2-3b decode fp32", (8, 24, 8, 128, 8192), 6000, 0, f32),
            ("gemma3-4b local decode fp32", (8, 8, 4, 256, 8192), 8192, 1024,
             f32),
            ("edge: ragged cache, window past the start",
             (2, 8, 2, 64, 1000), 777, 900, f32)):
        decode_case(*args)

    # B7: phi3.5-moe experts, 16 x 640 rows (4,096 tokens x top-2 x
    # capacity 1.25 / 16), d_model 4,096, d_ff 6,400; each case names the
    # route (kernel) its dtype, shape and alignment must take
    def gmm_case(label, E, C, D, Fo, dt, reps, route, w=None):
        x = randn(E, C, D, dtype=dt)
        w = randn(E, D, Fo, dtype=dt) if w is None else w
        plain = ref.ref_grouped_matmul if E <= 64 else \
            experts_at_a_time(ref.ref_grouped_matmul, 64)
        add("grouped_matmul", label, (x, w), {}, plain, torch.bmm, (E * C * D + E * D * Fo + E * C * Fo)
            * x.element_size(), 2 * E * C * D * Fo, dt, reps, route=route)

    for args in (
            ("phi3.5-moe expert up", 16, 640, 4096, 6400, bf16, 5, "wgmma"),
            ("phi3.5-moe expert down", 16, 640, 6400, 4096, bf16, 5,
             "wgmma"),
            ("phi3.5-moe expert up fp32", 16, 640, 4096, 6400, f32, 2,
             "fma"),
            ("edge: ragged C, D, F", 3, 50, 100, 70, bf16, 20, "mma_sync"),
            ("edge: ragged C, D, F fp32", 3, 50, 100, 70, f32, 20, "fma")):
        gmm_case(*args)

    # B8: mamba2-780m's SSD at full width (d_model 1,536, expand 2: H 48,
    # P 64, N 128, one group, chunk 256) over B 2 x S 4,096, fp32 (what the
    # model hands it) and bf16; hymba-1.5b's SSM heads (H 50, N 16); edges
    def ssd_case(label, B, S, H, G, P, N, chunk, dt_kind, a_kind, dtype,
                 reps, views=False, long_chunk=False):
        if views:
            # x, b and c as views into one conv output (G 1), the way
            # ssm_apply hands them to B8 in a float32 model
            conv = randn(B, S, H * P + 2 * N, dtype=dtype)
            x = conv[..., :H * P].reshape(B, S, H, P)
        else:
            x = randn(B, S, H, P, dtype=dtype)
        z = randn(B, S, H, dtype=f32)
        dt = F.softplus(z) + (2.0 if dt_kind == "strong" else 0.0)
        a = -torch.exp(randn(H, dtype=f32))
        if a_kind == "near 0":
            a = a * 1e-5
        if views:
            b = conv[..., H * P:H * P + N].reshape(B, S, G, N)
            c = conv[..., H * P + N:].reshape(B, S, G, N)
        else:
            b = randn(B, S, G, N, dtype=dtype)
            c = randn(B, S, G, N, dtype=dtype)
        size = x.element_size()
        tri, nc = chunk * (chunk + 1) // 2, S // chunk
        # C B^T over the causal half, once per group: the heads of a group
        # share it and only its c(c+1)/2 products take their own decay
        cb_flops = B * G * nc * 2 * tri * N
        # per head: the masked scores times dt*x, the chunk's own state,
        # and the carry-in for every chunk but the first
        head_flops = B * H * (nc * (2 * tri * P + 2 * chunk * N * P)
                              + (nc - 1) * 2 * chunk * N * P)
        bytes_moved = (2 * B * S * H * P * size + 2 * B * S * G * N * size
                       + B * S * H * 4 + H * 4 + B * H * P * N * 4)
        add("ssd_scan", label, (x, dt, a, b, c), {"chunk": chunk},
            ref.ref_ssd_scan, None, bytes_moved, cb_flops + head_flops,
            dtype, reps,
            truth=ssd_float64 if dtype == f32 or long_chunk else None,
            bf16_flops=cb_flops if dtype != f32 else 0, route="mma",
            float64_tol=SSD_LONG_CHUNK_TOL + HALF_STEP[str(dtype)]
            if long_chunk else None)

    for args in (
            ("mamba2-780m SSD", 2, 4096, 48, 1, 64, 128, 256, "", "", f32, 10),
            ("mamba2-780m SSD", 2, 4096, 48, 1, 64, 128, 256, "", "", bf16,
             10),
            ("hymba-1.5b SSM heads", 2, 4096, 50, 1, 64, 16, 256, "", "",
             bf16, 10),
            ("edge: G = H", 1, 512, 48, 48, 64, 128, 256, "", "", f32, 20),
            ("edge: one chunk", 1, 256, 48, 1, 64, 128, 256, "", "", f32, 20),
            ("edge: strong decay (dt + 2)", 1, 1024, 48, 1, 64, 128, 256,
             "strong", "", f32, 20),
            ("edge: a near 0 (a * 1e-5)", 1, 1024, 48, 1, 64, 128, 256, "",
             "near 0", f32, 20),
            ("edge: ragged P 20, N 10, chunk 48", 1, 96, 3, 1, 20, 10, 48,
             "", "", f32, 20)):
        ssd_case(*args)

    # B6's bf16 kernel at d 64 and d 32, drawn after every earlier case so
    # that those keep their inputs
    for args in (
            ("edge: ragged S, not causal, bf16", 1, 520, 2, 64, False, 0,
             bf16, 5),
            ("edge: d 32, causal, window 50, bf16", 1, 300, 3, 32, True, 50,
             bf16, 5)):
        flash_case(*args)

    # B7's wgmma route on many small experts and on ragged tiles, drawn
    # last as well.  kimi-k2 (src/repro/configs/kimi_k2_1t_a32b.py): d_model
    # 7,168, expert d_ff 2,048, C = moe_capacity at 4,096 tokens, top-8,
    # factor 1.25 (ceil(106.7) rounded up to 8); 64 of its 384 experts keep
    # w at 1.88 GB and the plain version's float32 copy at 3.8 GB.  The edge
    # leaves C, D and F ragged past the 128-row, 64-deep and 256-wide tiles.
    for args in (
            ("kimi-k2 expert up (64 of 384 experts)", 64, 112, 7168, 2048,
             bf16, 5, "wgmma"),
            ("edge: ragged C, D, F on the wgmma route", 2, 200, 1000, 520,
             bf16, 20, "wgmma")):
        gmm_case(*args)

    # B5 at more groups, drawn last too: command-r-plus-104b (96 heads
    # over 8 KV heads: group 12, above the float32 kernel's 8 heads a
    # block), hymba-1.5b (25 over 5, d 64), musicgen-large (32 over 32,
    # d 64), and the ragged edge in bf16 with a window that starts and
    # ends inside a 64-position tile
    for args in (
            ("command-r-plus-104b decode", (8, 96, 8, 128, 8192), 6000, 0,
             bf16),
            ("command-r-plus-104b decode fp32", (8, 96, 8, 128, 8192), 6000,
             0, f32),
            ("hymba-1.5b decode", (8, 25, 5, 64, 8192), 8192, 0, bf16),
            ("musicgen-large decode", (8, 32, 32, 64, 4096), 3000, 0, bf16),
            ("edge: ragged cache, window inside tiles, bf16",
             (2, 8, 2, 64, 1000), 777, 100, bf16)):
        decode_case(*args)

    # drawn after every earlier case: B8 with 1 < G < H, where each head
    # finds its group's shared C B^T by index, and B5 with its length in
    # a default-dtype (int64) tensor on the card
    ssd_case("edge: G 4 of H 48", 1, 1024, 48, 4, 64, 128, 256, "", "", f32,
             20)
    decode_case("llama3.2-3b decode, int64 length", (8, 24, 8, 128, 8192),
                6000, 0, bf16)

    # every call phase 10c's bf16 models make, at its shape, dtype and
    # options (phase 10c checks each call against these cases'
    # signatures), drawn after every earlier case: B4 over the prefill's
    # 2 x 4,096 tokens at llama3.2-3b's, phi3.5-moe's and hymba-1.5b's
    # d_model and hymba's SSM inner width, and over llama's decode batch
    for label, R, D in (("llama3.2-3b hidden norm, prefill", 8192, 3072),
                        ("llama3.2-3b hidden norm, decode B 8", 8, 3072),
                        ("phi3.5-moe hidden norm, prefill", 8192, 4096),
                        ("hymba-1.5b hidden norm, prefill", 8192, 1600),
                        ("hymba-1.5b SSM gated norm, prefill", 8192, 3200)):
        norm_case(label, R, D, bf16)
    # B6: phi3.5-moe (KV 8 repeated to 32 heads), hymba-1.5b's global
    # layer 0 and its windowed layers (KV 5 repeated to 25 heads, d 64)
    for args in (
            ("phi3.5-moe prefill", 2, 4096, 32, 128, True, 0, bf16, 5),
            ("hymba-1.5b global layer", 2, 4096, 25, 64, True, 0, bf16, 5),
            ("hymba-1.5b windowed layer", 2, 4096, 25, 64, True, 1024, bf16,
             5)):
        flash_case(*args)
    # B5 against the 4,352-slot cache of a 4,096-token prompt
    # (cache_seq_len(4096)), at the first decode step's length
    decode_case("llama3.2-3b decode, 4,352-slot cache (device int32)",
                (8, 24, 8, 128, 4352), 4097, 0, bf16)
    # B7 at the prefill's capacity: 2 x 4,096 tokens x top-2 x 1.25 / 16
    for args in (
            ("phi3.5-moe expert gate / up, capacity 1,280", 16, 1280, 4096,
             6400, bf16, 5, "wgmma"),
            ("phi3.5-moe expert down, capacity 1,280", 16, 1280, 6400, 4096,
             bf16, 5, "wgmma")):
        gmm_case(*args)
    # B8 as hymba-1.5b's bf16 model hands it: float32 inputs
    ssd_case("hymba-1.5b SSM heads fp32", 2, 4096, 50, 1, 64, 16, 256, "", "",
             f32, 10)

    # phase 11's calls, drawn after every earlier case (phase 11 checks
    # each call its drill, its full-width engine and its serve CLI runs
    # make against these cases' signatures).  B5's float32 route at small
    # head dims: d 8 and 16 at the serving drill's H 4, KV 2 against
    # caches of 16 and 48 slots at lengths 1, 5 and K; the drill's waves
    # of 1-3 at its 16 slots; d 32.  B4 at the drill's norms (d_model 64)
    for d in (8, 16):
        for K in (16, 48):
            for length in (1, 5, K):
                decode_case(f"small d: d {d}, H 4 / KV 2, K {K}, length "
                            f"{length}", (4, 4, 2, d, K), length, 0, f32)
    for B in (1, 2, 3):
        decode_case(f"serving drill, wave of {B}: d 16, K 16",
                    (B, 4, 2, 16, 16), 5, 0, f32)
    decode_case("small d: d 32, H 8 / KV 2, K 300", (4, 8, 2, 32, 300), 299,
                0, f32)
    for B in (1, 2, 3, 4):
        norm_case(f"serving drill norm, wave of {B}", B, 64, f32)
    # llama3.2-3b served at full width: B5 against the serve loop's
    # 40-slot bf16 cache (prompt 16 + 16 new + 8) and B4 over the hidden
    # state, at every wave size up to max_batch 8 (B4 at 8: above)
    for B in range(1, 9):
        decode_case(f"llama3.2-3b served, wave of {B}, 40-slot cache",
                    (B, 24, 8, 128, 40), 17, 0, bf16)
    for B in range(1, 8):
        norm_case(f"llama3.2-3b hidden norm, served wave of {B}", B, 3072,
                  bf16)
    # the serve CLI's reduced archs (phase 11d), waves of 1-4 against its
    # 20-slot caches (prompt 8 + 4 new + 8) at the last step's length 12:
    # B5 at d 16, H 4 / KV 2 and at command-r-plus-104b's d 8, H 8 / KV 2,
    # each global and with gemma3-4b's and hymba-1.5b's window 8; B7's
    # float32 route at phi3.5-moe's (4 experts) and kimi-k2's (8) reduced
    # slabs, capacity 8, d_model 64, d_ff 96; B4 over qwen3's and
    # gemma3's qk-norm rows (d_head 16) and hymba's and mamba2's SSM
    # inner width 128
    for B in range(1, 5):
        for H, d in ((4, 16), (8, 8)):
            for window in (0, 8):
                decode_case(f"serve CLI: d {d}, H {H} / KV 2, K 20, wave of "
                            f"{B}, window {window}", (B, H, 2, d, 20), 12,
                            window, f32)
    for E in (4, 8):
        for args in ((f"serve CLI: {E} experts gate / up", E, 8, 64, 96),
                     (f"serve CLI: {E} experts down", E, 8, 96, 64)):
            gmm_case(*args, f32, 20, "fma")
    for R in (2, 4, 6, 8, 12, 16):
        norm_case(f"serve CLI: qk-norm, {R} rows of 16", R, 16, f32)
    for B in range(1, 5):
        norm_case(f"serve CLI: SSM gated norm, wave of {B}", B, 128, f32)

    # phase 12's calls, drawn after every earlier case (phase 12 checks
    # each call its training runs make against these cases' signatures;
    # a training step's forward calls, recomputed under remat, are its
    # only kernel calls: the backward is the plain versions').  (c) full
    # width, B 2 x S 2,048, bf16: qwen3-1.7b's hidden norm and qk-norm (16
    # query and 8 KV heads of d 128) and its attention; mamba2-780m's
    # norms (d_model 1,536, gated 3,072) and its float32 SSD (contiguous:
    # the bf16 model's .float() copies); phi3.5-moe's hidden norm and
    # attention (32 heads); its experts at capacity 640 are held above
    for label, R, D in (("qwen3-1.7b hidden norm, train", 4096, 2048),
                        ("qwen3-1.7b q-norm, train", 65536, 128),
                        ("qwen3-1.7b k-norm, train", 32768, 128),
                        ("mamba2-780m ln1 / final_norm, train", 4096, 1536),
                        ("mamba2-780m gated norm, train", 4096, 3072),
                        ("phi3.5-moe hidden norm, train", 4096, 4096)):
        norm_case(label, R, D, bf16)
    for args in (("qwen3-1.7b train", 2, 2048, 16, 128, True, 0, bf16, 5),
                 ("phi3.5-moe train", 2, 2048, 32, 128, True, 0, bf16, 5)):
        flash_case(*args)
    ssd_case("mamba2-780m SSD, train", 2, 2048, 48, 1, 64, 128, 256, "", "",
             f32, 10)
    # B6's float32 route at d 8 and 16: causal and windowed, S not a
    # multiple of the 64-row tile
    for args in (("edge: d 8, ragged S", 1, 200, 3, 8, True, 0, f32, 20),
                 ("edge: d 8, window 50", 1, 300, 2, 8, True, 50, f32, 20),
                 ("edge: d 16, ragged S, not causal", 1, 131, 3, 16, False,
                  0, f32, 20),
                 ("edge: d 16, window 24", 2, 200, 2, 16, True, 24, f32,
                  20)):
        flash_case(*args)
    # (b) the train CLI's reduced archs (--batch 8 --seq 64), float32: B6
    # at d 16 (H 4; gemma3-4b's and hymba-1.5b's window 8) and
    # command-r-plus-104b's d 8 (H 8); B4 over the hidden state (512 x
    # 64), the qk-norm rows (q 2,048, k 1,024 of 16) and the SSM gated
    # norm (512 x 128); B7 at phi3.5-moe's 4 experts (capacity 320) and
    # kimi-k2's 8 (capacity 160); B8 at hymba-1.5b's (N 8) and
    # mamba2-780m's (N 16) SSM heads (H 8, P 16, chunk 8), x, b and c
    # views into the conv output
    for args in (("train CLI: d 16, H 4", 8, 64, 4, 16, True, 0, f32, 20),
                 ("train CLI: d 16, H 4, window 8", 8, 64, 4, 16, True, 8,
                  f32, 20),
                 ("train CLI: d 8, H 8", 8, 64, 8, 8, True, 0, f32, 20)):
        flash_case(*args)
    for label, R, D in (("train CLI: hidden norm", 512, 64),
                        ("train CLI: q-norm", 2048, 16),
                        ("train CLI: k-norm", 1024, 16),
                        ("train CLI: SSM gated norm", 512, 128)):
        norm_case(label, R, D, f32)
    for E, C in ((4, 320), (8, 160)):
        for args in ((f"train CLI: {E} experts gate / up", E, C, 64, 96),
                     (f"train CLI: {E} experts down", E, C, 96, 64)):
            gmm_case(*args, f32, 20, "fma")
    for N in (8, 16):
        ssd_case(f"train CLI: SSM heads N {N}, conv-output views", 8, 64, 8,
                 1, 16, N, 8, "", "", f32, 20, views=True)
    # (d) the paper's story: its 2-layer d_model-64 model (d_head 16)
    # trained at B 4 x S 16 (B6 d 16, B4 over 64 rows) and served from a
    # 48-slot cache in waves of 1-3 (the wave of 4 is held above)
    flash_case("system story train: d 16, H 4", 4, 16, 4, 16, True, 0, f32,
               20)
    norm_case("system story train: hidden norm", 64, 64, f32)
    for B in (1, 2, 3):
        decode_case(f"system story: wave of {B}, d 16, K 48",
                    (B, 4, 2, 16, 48), 9, 0, f32)

    # B5 and B6 across their head-dim domain (every multiple of 8 from 8
    # to 256, run at the smallest instantiated width), drawn after every
    # earlier case: d 8, 24, 80, 96 and 192 in both dtypes; B5 at groups
    # 1, 4 (windowed) and 12 over 2 KV heads, a 1,000-slot cache at length
    # 777; B6 causal and windowed over S 600 (not a multiple of the tile)
    for d in (8, 24, 80, 96, 192):
        for dt in (bf16, f32):
            for g, window in ((1, 0), (4, 300), (12, 0)):
                decode_case(f"head dim {d}: group {g}, window {window}",
                            (4, 2 * g, 2, d, 1000), 777, window, dt)
            for window in (0, 100):
                flash_case(f"head dim {d}: causal, window {window}", 1, 600,
                           4, d, True, window, dt, 5)

    # every call phase 14's bf16 runs make, drawn after every earlier case
    # (phase 14c checks each call against these cases' signatures): B4
    # over the prefill's 2 x 4,096 tokens and the decode batch of 8 at the
    # d_model of musicgen-large (2,048), internvl2-76b (8,192),
    # command-r-plus-104b (12,288) and kimi-k2 (7,168); B6 at their
    # prefills (32 heads of d 64; 64 of d 128, internvl2-76b's and
    # kimi-k2's; 96 of d 128); B5 at B 8 against the 4,352-slot cache at
    # length 4,097: groups 1 (d 64), 8 and 12 (d 128); B7 at kimi-k2's 384
    # experts, capacity 216 (2 x 4,096 tokens x top-8 x 1.25 / 384): gate
    # / up (216 x 7,168 -> 2,048) and down (216 x 2,048 -> 7,168), down's
    # weights a (384, 2,048, 7,168) view of up's 11.3 GB
    for label, D in (("musicgen-large", 2048), ("internvl2-76b", 8192),
                     ("command-r-plus-104b", 12288), ("kimi-k2", 7168)):
        norm_case(f"{label} hidden norm, prefill", 8192, D, bf16)
        if label != "kimi-k2":
            norm_case(f"{label} hidden norm, decode B 8", 8, D, bf16)
    for args in (("musicgen-large prefill", 2, 4096, 32, 64, True, 0, bf16,
                  5),
                 ("internvl2-76b / kimi-k2 prefill", 2, 4096, 64, 128, True,
                  0, bf16, 5),
                 ("command-r-plus-104b prefill", 2, 4096, 96, 128, True, 0,
                  bf16, 5)):
        flash_case(*args)
    for label, shape in (("musicgen-large", (8, 32, 32, 64, 4352)),
                         ("internvl2-76b", (8, 64, 8, 128, 4352)),
                         ("command-r-plus-104b", (8, 96, 8, 128, 4352))):
        decode_case(f"{label} decode, 4,352-slot cache (device int32)",
                    shape, 4097, 0, bf16)
    E, C, D, Fo = 384, 216, 7168, 2048
    w_up = randn(E, D, Fo)
    gmm_case("kimi-k2 expert gate / up, 384 experts, capacity 216", E, C, D,
             Fo, bf16, 5, "wgmma", w=w_up)
    gmm_case("kimi-k2 expert down, 384 experts, capacity 216", E, C, Fo, D,
             bf16, 5, "wgmma", w=w_up.view(E, Fo, D))
    del w_up

    # phase 15's calls, drawn after every earlier case (phase 15 checks
    # each call of its float16 runs against these cases' signatures).
    # (a) llama3.2-3b: B4 over the prefill's 2 x 4,096 tokens and the
    # decode batch of 8, B6 at its prefill (24 heads of d 128), B5 at B 8
    # against the 4,352-slot float16 cache at length 4,097; (b)
    # mamba2-780m: B4 at d_model 1,536 and the gated 3,072 (its SSD runs
    # in float32, as in bf16: phase 6 holds that call above); (c)
    # phi3.5-moe: B4 at 4,096, B6 at 32 heads, B7 at capacity 1,280
    for label, R, D in (("fp16 llama3.2-3b hidden norm, prefill", 8192, 3072),
                        ("fp16 llama3.2-3b hidden norm, decode B 8", 8, 3072),
                        ("fp16 mamba2-780m ln1 / final_norm, prefill", 8192,
                         1536),
                        ("fp16 mamba2-780m gated norm, prefill", 8192, 3072),
                        ("fp16 phi3.5-moe hidden norm, prefill", 8192, 4096)):
        norm_case(label, R, D, f16)
    for args in (("fp16 llama3.2-3b prefill", 2, 4096, 24, 128, True, 0,
                  f16, 5),
                 ("fp16 phi3.5-moe prefill", 2, 4096, 32, 128, True, 0, f16,
                  5)):
        flash_case(*args)
    decode_case("fp16 llama3.2-3b decode, 4,352-slot cache (device int32)",
                (8, 24, 8, 128, 4352), 4097, 0, f16)
    for args in (("fp16 phi3.5-moe expert gate / up, capacity 1,280", 16,
                  1280, 4096, 6400, f16, 5, "wgmma"),
                 ("fp16 phi3.5-moe expert down, capacity 1,280", 16, 1280,
                  6400, 4096, f16, 5, "wgmma"),
                 ("fp16 edge: ragged C, D, F", 3, 50, 100, 70, f16, 20,
                  "mma_sync")):
        gmm_case(*args)
    # (d) the domains the reference's kernels take and B4-B8 once refused
    # on the card: B6 and B5 at head dims off the multiple-of-8 grid and
    # above 256 in the three dtypes (B6 causal over S 1,000 with 8 heads;
    # B5 at a GQA group of 8 over 2 KV heads, a 4,096-slot cache at
    # length 3,000); B8 at P 128 / N 256 and at chunk 2,048, float32 and
    # float16 (and mamba2-780m's shape in float16); B4 past the one-pass
    # kernel's 16,384 at D 20,000 and 32,768
    for d in (1, 4, 12, 100, 257, 320, 512):
        for dt in (f32, bf16, f16):
            flash_case(f"open domain: head dim {d}, causal", 1, 1000, 8, d,
                       True, 0, dt, 3)
            decode_case(f"open domain: head dim {d}, group 8",
                        (4, 16, 2, d, 4096), 3000, 0, dt)
    for args in (
            ("mamba2-780m SSD, fp16", 2, 4096, 48, 1, 64, 128, 256, "", "",
             f16, 10),
            ("open domain: P 128, N 256", 1, 4096, 8, 1, 128, 256, 256, "",
             "", f32, 5),
            ("open domain: P 128, N 256, fp16", 1, 4096, 8, 1, 128, 256, 256,
             "", "", f16, 5),
            ("open domain: chunk 2,048", 1, 4096, 8, 1, 64, 128, 2048, "",
             "", f32, 5, False, True),
            ("open domain: chunk 2,048, fp16", 1, 4096, 8, 1, 64, 128, 2048,
             "", "", f16, 5, False, True),
            # past 10,240 the chunk-long arrays leave shared memory for a
            # global buffer (ssd_scan_big_floats); P 130 adds a ragged
            # 2-column block to two full ones
            ("open domain: chunk 12,288, P 130", 1, 12288, 2, 1, 130, 128,
             12288, "", "", f32, 3, False, True),
            ("open domain: chunk 12,288, P 130, fp16", 1, 12288, 2, 1, 130,
             128, 12288, "", "", f16, 3, False, True)):
        ssd_case(*args)
    for label, R, D, dt in (("open domain: D 20,000", 512, 20000, f32),
                            ("open domain: D 20,000, fp16", 512, 20000, f16),
                            ("open domain: D 32,768, fp16", 512, 32768, f16),
                            ("open domain: D 32,768, bf16", 512, 32768,
                             bf16)):
        norm_case(label, R, D, dt)
    return ops, cases


def kernel_signature(name: str, args, kwargs) -> tuple:
    """What of one model-kernel call decides the code it runs and the
    work it does: its tensors' shapes (B4's as rows x width), dtypes,
    contiguity and 16-byte alignment, and its options (B6's causal and
    window, B5's window, B8's chunk).  B5's length and B4's eps are
    data."""
    tensors = [a for a in args if hasattr(a, "shape") and a.dim() > 0]
    shapes = [tuple(a.shape) for a in tensors]
    if name == "rmsnorm":
        shapes[0] = (tensors[0].numel() // shapes[0][-1], shapes[0][-1])
    opts = {k: v for k, v in kwargs.items() if k != "eps"}
    if name == "decode_attention":
        opts["window"] = args[4] if len(args) > 4 else kwargs.get("window", 0)
    return (name, tuple(shapes), tuple(str(a.dtype) for a in tensors),
            tuple(a.is_contiguous() for a in tensors),
            tuple(a.data_ptr() % 16 == 0 for a in tensors),
            tuple(sorted(opts.items())))


def ssd_float64(x, dt, a, b, c, chunk):
    """The model's plain SSD algorithm, ``ssd_chunked``, in float64 on the
    same inputs: what B8 and its plain version are both held to for
    accuracy."""
    import torch
    from repro_torch.models.layers import ssd_chunked
    return ssd_chunked(x, dt, a, b, c, chunk, dtype=torch.float64)


def phase_model_kernels(torch, device, card: str) -> list:
    """Phase 6: every shape through ``repro_torch.kernels.ops`` with the
    counts zeroed just before and read just after; then each output held
    against the plain version on the same inputs, and the kernel, the
    plain version and the library call timed."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_nsplit, decode_attention_route)
    from repro_torch.kernels.flash_attention import flash_attention_route
    from repro_torch.kernels.grouped_matmul import grouped_matmul_route
    from repro_torch.kernels.ssd_scan import ssd_scan_route
    # the kernel each op's case must take, by op (cases name it)
    route_of = {"grouped_matmul": grouped_matmul_route,
                "decode_attention": decode_attention_route,
                "flash_attention": flash_attention_route,
                "ssd_scan": ssd_scan_route}
    ops, cases = model_cases(torch, device)
    names = tuple(name for name, _, _ in MODEL_KERNELS)
    for name in names:
        getattr(ops, name).launches = 0
    torch.cuda.synchronize()
    outs = [getattr(ops, c["op"])(*c["args"], **c["kwargs"]) for c in cases]
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in names}
    for name in names:
        n = sum(c["op"] == name for c in cases)
        check(launches[name] == n, f"phase 6: {name} launched "
              f"{launches[name]} times for {n} shapes")
    # a length tensor on the card, int32 or cast there from int64, costs
    # the decode call no host synchronisation
    for c in cases:
        if c["op"] == "decode_attention" and torch.is_tensor(c["args"][3]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                ops.decode_attention(*c["args"], **c["kwargs"])
            except RuntimeError as exc:
                raise SmokeFailure(f"decode_attention, {c['label']}: the "
                                   f"call synchronised with the host ({exc})")
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    per_case = []
    for c, out in zip(cases, outs):
        where = f"{c['op']}, {c['label']}"
        want = c["plain"](*c["args"], **c["kwargs"])
        # ssd_scan returns (y, state): each part is held to the limit of
        # its own dtype (y in x's, the state always float32)
        outs_c = out if isinstance(out, tuple) else (out,)
        wants_c = want if isinstance(want, tuple) else (want,)
        err = used = 0.0
        tols, differs = [], []
        for o, wt in zip(outs_c, wants_c):
            check(o.dtype == wt.dtype and o.shape == wt.shape,
                  f"{where}: {o.dtype}{tuple(o.shape)}, want "
                  f"{wt.dtype}{tuple(wt.shape)}")
            check(bool(torch.isfinite(o).all()), f"{where}: non-finite output")
            g, wf = o.float(), wt.float()
            diff = (g - wf).abs()
            err = max(err, float(diff.max()))
            lim, tol = model_limit(torch, c["op"], o.dtype, wf)
            over = int((diff > lim).sum())
            used = max(used, float(torch.where(lim > 0, diff / lim,
                                               diff).max()))
            differ = float((o != wt).float().mean())
            # a case with a float64 tolerance (a chunk long enough for the
            # plain version's float32 cumsum to drift from float64 past
            # the limit) is held to float64 alone, below; here its
            # distance from the plain version is only logged
            if c["float64_tol"] is not None:
                log(f"{where}: {over} entries beyond {tol} and {differ:.4f} "
                    f"of the outputs differing against the plain version, "
                    f"held to float64 instead")
                tols.append(tol)
                differs.append(differ)
                continue
            check(over == 0, f"{where}: {over} entries beyond {tol} (max "
                  f"abs err {float(diff.max()):.3g})")
            if o.dtype in (torch.bfloat16, torch.float16):
                check(differ <= BF16_MAX_DIFFER, f"{where}: {differ:.4f} of "
                      f"the outputs differ from the plain version's, more "
                      f"than {BF16_MAX_DIFFER} (a store that does not round "
                      f"to nearest even?)")
            tols.append(tol)
            differs.append(differ)
            del diff, g
        w = wants_c[0].float()
        if c["check"] is not None:
            check(c["check"](out), f"{where}: edge case check failed")
        # where the window bites, the limit must see it off by one: the
        # plain version at window -1 and +1, held to the same limit, fails
        off_by_one = None
        if c["shift"] is not None:
            lim = model_limit(torch, c["op"], outs_c[0].dtype, w)[0]
            off_by_one = []
            for e in (-1, 1):
                a, kw = c["shift"](e)
                alt = c["plain"](*a, **kw).float()
                off_by_one.append(int(((alt - w).abs() > lim).sum()))
                del alt
            check(min(off_by_one) > 0, f"{where}: the limit cannot tell "
                  f"the window from window -1 / +1 ({off_by_one})")
            del lim
        # accuracy: kernel and plain version against a float64 evaluation
        truth_err = None
        if c["truth"] is not None:
            exact = c["truth"](*c["args"], **c["kwargs"])

            def rel(parts):
                return max(float(((p.double() - t).abs() / (1 + t.abs()))
                                 .max()) for p, t in zip(parts, exact))
            truth_err = {"kernel": rel(outs_c), "plain": rel(wants_c)}
            if c["float64_tol"] is not None:
                check(truth_err["kernel"] <= c["float64_tol"],
                      f"{where}: the kernel is {truth_err['kernel']:.3g} "
                      f"from the float64 evaluation, more than "
                      f"{c['float64_tol']:.3g}")
            else:
                check(truth_err["kernel"] <= max(truth_err["plain"],
                                                 SSD_TRUTH_FLOOR),
                      f"{where}: the kernel is further from the float64 "
                      f"evaluation ({truth_err['kernel']:.3g}) than the "
                      f"plain version ({truth_err['plain']:.3g})")
            del exact
        if c["op"] == "ssd_scan":
            # the "mma" route: each float32 product as three TF32 products
            # on the tensor cores; a product of two bf16 inputs (C B^T)
            # at the card's bf16 rate
            t_ops = (3 * (c["flops"] - c["bf16_flops"]) / TF32_OPS_PER_S
                     + c["bf16_flops"] / BF16_OPS_PER_S)
        elif c["op"] == "rmsnorm":
            t_ops = c["flops"] / F32_OPS_PER_S
        else:
            # 16-bit inputs at the card's 16-bit rate, whatever route the
            # port takes: a slower route's cost is in its time, not here
            t_ops = c["flops"] / (F32_OPS_PER_S if c["dtype"] ==
                                  torch.float32 else BF16_OPS_PER_S)
        t_bytes = c["bytes"] / MEM_BYTES_PER_S
        row = {"label": c["label"], "max_abs_err": err, "tol": ", ".join(tols),
               "limit_used": used, "differ_share": differs[0],
               "window_off_by_one_over": off_by_one,
               "float64_rel_err": truth_err,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if c["route"] is not None:
            row["route"] = route_of[c["op"]](*(
                a for a in c["args"] if torch.is_tensor(a) and a.dim() > 0))
            check(row["route"] == c["route"], f"{where}: took the "
                  f"{row['route']} route, want {c['route']}")
        if c["op"] == "decode_attention":
            row["nsplit"] = decode_attention_nsplit(*c["args"][:3])
        fn = getattr(ops, c["op"])
        # inputs smaller than three L2s are cycled through three copies,
        # so that each timed call reads them from device memory
        sets = [c["args"]] + ([tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in c["args"]) for _ in range(2)]
                              if c["bytes"] < 3 * L2_BYTES else [])
        cycle = itertools.cycle(sets)
        call_kernel = lambda: fn(*next(cycle), **c["kwargs"])  # noqa: E731
        row["ms"] = device_ms(torch, call_kernel, reps=c["reps"])
        row["device_ms"] = profiled_device_ms(torch, call_kernel,
                                              reps=c["reps"])
        row["plain_ms"] = device_ms(torch, lambda: c["plain"](
            *c["args"], **c["kwargs"]), reps=max(1, c["reps"] // 5))
        if c["library"] is None:
            row["library_ms"] = lib_err = None
        else:
            lib_err = float((c["library"](*c["args"], **c["kwargs"]).float()
                             - w).abs().max())
            call = lambda: c["library"](*next(cycle), **c["kwargs"])  # noqa: E731
            row["library_ms"] = device_ms(torch, call, reps=c["reps"])
            row["library_device_ms"] = profiled_device_ms(torch, call,
                                                          reps=c["reps"])
        log(f"phase 6 {where}: kernel {row['ms']:.6f} ms (device "
            f"{fmt_ms(row['device_ms'])}), plain "
            f"{row['plain_ms']:.6f} ms, library "
            + ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.6f} ms (device "
               f"{fmt_ms(row['library_device_ms'])})")
            + f", bound {row['bound_ms']:.6f} ms ({row['bound_by']}), max "
            f"abs err {err:.3g} (limit {row['tol']}, {used:.3f} of it used, "
            f"{differs} of outputs differ, window -1/+1 over the limit "
            f"in {off_by_one}; library vs plain {lib_err}; vs float64 "
            f"{truth_err}; route {row.get('route')}, nsplit "
            f"{row.get('nsplit')}) [{card}]")
        per_case.append((c["op"], row))
        del want, w, sets, outs_c, wants_c

    entries = []
    for name, src, replaces in MODEL_KERNELS:
        rows = [r for op, r in per_case if op == name]
        head = rows[0]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{src}.cu",
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max(r["max_abs_err"] for r in rows)}
        for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            entry[k] = head[k]
        entry["cases"] = rows
        # the calls held against the plain version, for phase 10c
        entry["held"] = {kernel_signature(name, c["args"], c["kwargs"])
                         for c in cases if c["op"] == name}
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# phase 7: the mamba2-780m model (forward and decode) on the card
# ---------------------------------------------------------------------------


def to_cpu(tree):
    return to_device(tree, "cpu")


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}


def host_tokens(cfg, B: int, S: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def host_inputs(torch, cfg, B: int, S: int, seed: int):
    """A model's inputs on the host: token ids, or for a stub frontend
    (``embed_inputs=False``) standard normal embeddings (B, S, d_model)
    in the activation dtype, from ``seed``."""
    if cfg.embed_inputs:
        return torch.from_numpy(host_tokens(cfg, B, S, seed))
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    return torch.from_numpy(x.astype(np.float32)).to(cfg.adtype)


def first_layers(params: dict, n: int) -> dict:
    """The tree with its stacked layers cut to the first ``n`` (views)."""
    cut = {**params}
    cut["layers"] = _map_leaves(params["layers"], lambda t: t[:n])
    return cut


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def phase_model(torch, device, card: str) -> dict:
    """Phase 7: mamba2-780m at full width through ``repro_torch.models``.
    (a) 2 layers, fp32, B 1 x S 512: the card's forward (hidden, last
    position's logits) against the port's CPU run on the same weights;
    (b) 4 layers, fp32, B 2 x S 512 (two chunks: the carry): forward
    logits against 512 teacher-forced decode steps on the card; (c) all
    48 layers, bf16, the port's seeded init: prefill B 2 x S 4,096 with
    the kernel counts zeroed just before and read just after (B8 once a
    layer, B4 twice a layer plus the final norm), its time, the
    profiler's device ops, the peak memory, and bf16 decode at B 8."""
    from repro_torch import models
    from repro_torch.configs import mamba2_780m
    from repro_torch.kernels import ops
    full = mamba2_780m.CONFIG
    f32 = dataclasses.replace(full, param_dtype="float32",
                              activ_dtype="float32")
    out = {}

    # (a) the card against the port's CPU run
    cfg = dataclasses.replace(f32, n_layers=2)
    params = models.init_params(cfg, MODEL7_SEED, device=device)
    toks = torch.from_numpy(host_tokens(cfg, 1, 512, MODEL7_SEED))
    h, _ = models.forward(params, cfg, toks.to(device))
    last = models.logits_fn(params, cfg, h[:, -1:])
    t0 = time.perf_counter()
    cpu_params = to_cpu(params)
    h_cpu, _ = models.forward(cpu_params, cfg, toks)
    last_cpu = models.logits_fn(cpu_params, cfg, h_cpu[:, -1:])
    cpu_s = time.perf_counter() - t0
    errs = {}
    for name, got, want in (("hidden", h, h_cpu), ("logits", last, last_cpu)):
        got = got.cpu()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"phase 7a: {name} {tuple(got.shape)} or non-finite")
        d = (got - want).abs()
        over = int((d > MODEL7_TOL * (1 + want.abs())).sum())
        errs[name] = float(d.max())
        check(over == 0, f"phase 7a: {name} differs from the CPU run beyond "
              f"rtol=atol={MODEL7_TOL} in {over} entries (max abs "
              f"{errs[name]:.3g})")
    out["cpu_vs_card"] = errs
    log(f"phase 7a ok: 2-layer fp32 forward, card == CPU (max abs err hidden "
        f"{errs['hidden']:.3g}, logits {errs['logits']:.3g}; limit rtol=atol="
        f"{MODEL7_TOL}); CPU run {cpu_s:.2f} s")
    del params, cpu_params, h, h_cpu

    # (b) forward against teacher-forced decode, both on the card
    cfg = dataclasses.replace(f32, n_layers=4)
    params = models.init_params(cfg, MODEL7_SEED + 1, device=device)
    B, S = 2, 512
    toks = torch.from_numpy(host_tokens(cfg, B, S, MODEL7_SEED + 1)).to(device)
    full_logits = models.logits_fn(params, cfg,
                                   models.forward(params, cfg, toks)[0])
    state = models.init_decode_state(cfg, B, S, torch.float32, device=device)
    worst = 0.0
    t0 = time.perf_counter()
    for t in range(S):
        lg, state = models.decode_step(params, cfg, state, toks[:, t])
        worst = max(worst, float((lg - full_logits[:, t]).abs().max()))
    dec_s = time.perf_counter() - t0
    scale = float(full_logits.abs().max())
    out["decode_vs_forward"] = {"max_abs_err": worst, "max_abs_logit": scale}
    check(np.isfinite(worst) and worst <= DECODE_TOL * scale,
          f"phase 7b: teacher-forced decode differs from the forward by "
          f"{worst:.3g}, over {DECODE_TOL} x max|logit| {scale:.3g}")
    log(f"phase 7b ok: 4-layer fp32, {S} teacher-forced decode steps == "
        f"forward (max abs err {worst:.3g} = {worst / scale:.3g} of max|logit| "
        f"{scale:.3g}; limit {DECODE_TOL}); {1e3 * dec_s / S:.3f} ms a step "
        f"[{card}]")
    del params, state, full_logits

    # (c) the full model in bf16: prefill counted, timed and profiled
    params = models.init_params(full, MODEL7_SEED + 2, device=device)
    n_params = sum(v.numel() for v in _leaves(params))
    check(n_params == full.param_count(), f"phase 7c: {n_params} parameters, "
          f"want {full.param_count()}")
    B, S = PREFILL_SHAPE
    toks = torch.from_numpy(host_tokens(full, B, S, MODEL7_SEED + 2)).to(device)

    def prefill():
        h, _ = models.forward(params, full, toks)
        return h, models.logits_fn(params, full, h[:, -1:])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.ssd_scan.launches = 0
    ops.rmsnorm.launches = 0
    torch.cuda.synchronize()
    h, last = prefill()
    torch.cuda.synchronize()
    launches = {"ssd_scan": ops.ssd_scan.launches,
                "rmsnorm": ops.rmsnorm.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"ssd_scan": full.n_layers, "rmsnorm": 2 * full.n_layers + 1}
    check(launches == want, f"phase 7c: launches {launches}, want {want}")
    check(h.shape == (B, S, full.d_model) and h.dtype == torch.bfloat16
          and last.shape == (B, 1, full.vocab_size)
          and bool(torch.isfinite(h).all())
          and bool(torch.isfinite(last).all()),
          f"phase 7c: hidden {h.dtype}{tuple(h.shape)}, logits "
          f"{tuple(last.shape)}, or non-finite values")
    ms = device_ms(torch, prefill, reps=3, warmup=1)
    out["prefill"] = {"batch": B, "seq": S, "ms": ms,
                      "tokens_per_s": B * S / (ms / 1e3),
                      "peak_bytes": peak, "launches": launches,
                      "params": n_params}
    log(f"phase 7c: mamba2-780m bf16 {full.n_layers} layers, {n_params} "
        f"parameters; prefill B {B} x S {S} (forward + last-position logits)"
        f" {ms:.3f} ms = {B * S / (ms / 1e3):.1f} tokens/s; launches "
        f"{launches}; peak device memory {peak / 2**30:.3f} GiB [{card}]")
    kernels_us = profile_run("prefill", torch, prefill, card)
    busy_us = sum(kernels_us.values())
    ssd_us = sum(us for k, us in kernels_us.items() if "ssd_" in k)
    out["prefill"]["ssd_share"] = ssd_us / busy_us if busy_us > 0 else None
    log(f"profile prefill: B8 (ssd_*) {ssd_us:.1f} us of {busy_us:.1f} us "
        f"of device time [{card}]")
    del h, last

    # bf16 decode at B 8: ms a step, one token per sequence a step
    Bd = DECODE_BATCH
    state = models.init_decode_state(full, Bd, 64, device=device)
    tok = torch.from_numpy(host_tokens(full, Bd, 1, 3)[:, 0]).to(device)
    for _ in range(2):
        lg, state = models.decode_step(params, full, state, tok)
    check(bool(torch.isfinite(lg).all()) and lg.shape == (Bd, full.vocab_size),
          "phase 7c: decode logits")

    def step():
        nonlocal state
        _, state = models.decode_step(params, full, state, tok)

    step_ms = device_ms(torch, step, reps=8, warmup=0)
    out["decode"] = {"batch": Bd, "ms_per_step": step_ms,
                     "tokens_per_s": Bd / (step_ms / 1e3)}
    log(f"phase 7c: bf16 decode B {Bd}: {step_ms:.3f} ms a step "
        f"({Bd / (step_ms / 1e3):.1f} tokens/s) [{card}]")
    out["launches"] = launches
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v

# ---------------------------------------------------------------------------
# phase 8: the monitored temporal sweep
# ---------------------------------------------------------------------------


def phase_traces(torch, device, fs, graph, agg, cfg, grid: dict,
                 card: str) -> dict:
    """The per-step traces, the SLO monitor, the dependency ensemble and
    a traced failover's timeline on the card, each held against the
    port's CPU run; returns the kernels' launches by path."""
    from repro_torch import obs
    from repro_torch.core.capacity import RegionCapacity
    from repro_torch.core.omg import Orchestrator
    from repro_torch.core.scenarios import (stage_seed,
                                            sweep_with_dependency_ensemble)
    from repro_torch.core.service import synthesize_fleet
    from repro_torch.core.sweep_engine import CHUNK, SweepEngine
    from repro_torch.core.timeline_sim import (simulate_timeline,
                                               sweep_timeline)
    from repro_torch.kernels.ufa.propagation import fixed_point_ell
    from repro_torch.kernels.ufa.reduce import timeline_reduce
    from repro_torch.obs import export, slo
    from repro_torch.obs.profiler import Profiler

    n = len(grid["traffic_mult"])
    rows = min(TRACE_ROWS, n)
    head = {k: v[:rows] for k, v in grid.items()}
    rng = np.random.default_rng(TRACE_SEED)
    obs.default_registry().reset()
    obs.enable()
    prof = Profiler()
    launches = {}
    on_card = device.type == "cuda"   # a cpu rehearsal launches no kernel

    # (a) the trace sweep, counted, cold and warm
    timeline_reduce.launches = 0
    if on_card:
        torch.cuda.synchronize()
    with prof.phase("8a trace sweep cold"):
        res = sweep_timeline(cfg, grid, return_traces=True, device=device)
    launches["b1 trace sweep"] = timeline_reduce.launches
    chunks = -(-n // CHUNK) if on_card else 0
    check(timeline_reduce.launches == chunks,
          f"trace sweep: {timeline_reduce.launches} timeline_reduce "
          f"launches, want {chunks}")
    T = len(res["t"])
    for k, v in res.items():
        if k.startswith("trace_"):
            want = (n, T, 7) if k == "trace_tier_live" else (n, T)
            check(v.shape == want and v.dtype == np.float32,
                  f"trace sweep: {k} is {v.dtype}{v.shape}, want "
                  f"float32{want}")
            check(np.isfinite(v).all(), f"trace sweep: {k} not finite")
    check(len([k for k in res if k.startswith("trace_")]) == 20,
          "trace sweep: want 20 trace series")
    warm = []
    for _ in range(WARM_RUNS):
        with GcTime() as gct:
            with prof.phase("8a trace sweep warm"):
                again = sweep_timeline(cfg, grid, return_traces=True,
                                       device=device)
        warm.append(f"{prof.phases['8a trace sweep warm']:.4f} s ({gct})")
    for k in res:
        check(np.array_equal(res[k], again[k], equal_nan=True),
              f"trace sweep: {k} differs between runs")
    del again
    with prof.phase("8a summary sweep"):
        off = sweep_timeline(cfg, grid, device=device)
    check(set(res) == set(off) | {"t"} | {k for k in res
                                          if k.startswith("trace_")},
          "trace sweep: summary keys differ from the traces-off run")
    for k, v in off.items():
        check(np.array_equal(v, res[k], equal_nan=True),
              f"trace sweep: summary {k} differs from the traces-off run")
    gb = sum(v.nbytes for k, v in res.items() if k.startswith("trace_"))
    log(f"phase 8a: trace sweep {n} scenarios, {gb / 1e9:.3f} GB of "
        f"traces: cold {prof.phases['8a trace sweep cold']:.4f} s, warm "
        + ", ".join(warm) + f"; traces off "
        f"{prof.phases['8a summary sweep']:.4f} s; summary bit-identical "
        f"to the traces-off run [{card}]")
    t0 = time.perf_counter()
    cpu = sweep_timeline(cfg, head, return_traces=True, device="cpu")
    log(f"cpu trace sweep of {rows} scenarios: "
        f"{time.perf_counter() - t0:.2f} s")
    got = {k: (v if k == "t" else v[:rows]) for k, v in res.items()}
    rtol = {k: F32_TIGHT for k, v in cpu.items() if v.dtype.kind == "f"}
    rtol["availability_mean"] = AVAIL_MEAN_RTOL
    rtol["t"] = 0.0
    compare(got, cpu, rtol, "trace sweep vs cpu")
    same = sorted(k for k in cpu if np.array_equal(got[k], cpu[k],
                                                   equal_nan=True))
    log(f"phase 8a ok: gpu == cpu on the first {rows} scenarios "
        f"({len(same)} of {len(cpu)} keys bit-identical, "
        f"{sum(k.startswith('trace_') for k in same)} of 20 trace keys; "
        f"differing: {sorted(set(cpu) - set(same))})")
    del cpu, got

    # (b) the SLO burn-rate monitor over every trace
    avail, ts = res["trace_availability"], res["t"]
    a_dev = torch.from_numpy(avail).to(device)
    with prof.phase("8b sweep_alerts", sync=a_dev):
        verd = slo.sweep_alerts(a_dev, ts, device=device)
    t0 = time.perf_counter()
    verd_cpu = slo.sweep_alerts(avail, ts, device="cpu")
    cpu_s = time.perf_counter() - t0
    for k in ("alert", "t_first_alert", "rule_first_alert", "burn_peak"):
        check(verd[k].dtype == verd_cpu[k].dtype
              and np.array_equal(verd[k], verd_cpu[k]),
              f"sweep_alerts: {k} differs between the card and the cpu")
    alerting = np.flatnonzero(verd["alert"])
    quiet = np.flatnonzero(~verd["alert"])
    check(len(alerting) > 0, "sweep_alerts: no scenario alerts")
    held = np.concatenate([
        rng.choice(alerting, min(ALERT_ROWS[0], len(alerting)),
                   replace=False),
        rng.choice(quiet, min(ALERT_ROWS[1], len(quiet)), replace=False)])
    for i in held:
        want = slo.alerts_np(avail[i], ts)
        check(bool(verd["alert"][i]) == bool(want["alert"])
              and verd["t_first_alert"][i] == np.float32(
                  want["t_first_alert"])
              and verd["rule_first_alert"][i] == want["rule_first_alert"],
              f"sweep_alerts: row {i} differs from alerts_np")
        peak = np.float32(want["burn_peak"])
        check(abs(verd["burn_peak"][i] - peak) <= np.spacing(peak),
              f"sweep_alerts: row {i} burn_peak {verd['burn_peak'][i]} "
              f"against alerts_np's {want['burn_peak']}")
    quality = slo.alert_quality(verd["alert"], ~res["avail_ok"],
                                verd["t_first_alert"])
    log(f"phase 8b ok: sweep_alerts over {n} traces "
        f"{prof.phases['8b sweep_alerts']:.4f} s (cpu {cpu_s:.2f} s), card "
        f"== cpu on every row, == alerts_np on {len(held)} rows "
        f"({min(len(alerting), ALERT_ROWS[0])} alerting); "
        f"{json.dumps(quality)} [{card}]")
    del a_dev

    # where the time goes: one profiled warm run of each
    profiled = on_card
    if profiled:
        before = timeline_reduce.launches
        us = profile_run("trace sweep", torch, lambda: sweep_timeline(
            cfg, grid, return_traces=True, device=device), card)
        n_chunks = timeline_reduce.launches - before
        b1_us = sum(v for k, v in us.items() if "timeline_reduce" in k)
        log("profile trace sweep: timeline_reduce "
            + (f"{b1_us / 1e3 / n_chunks:.6f} ms device a chunk over "
               f"{n_chunks} chunks" if b1_us > 0 else "not measured")
            + f" [{card}]")
        profile_run("sweep_alerts", torch, lambda: slo.sweep_alerts(
            avail, ts, device=device), card)
    del res, avail

    # (c) the dependency ensemble on the first rows, both ways
    fixed_point_ell.launches = 0
    with prof.phase("8c ensemble"):
        ens = sweep_with_dependency_ensemble(fs, head, seed=TRACE_SEED,
                                             device=device)
    launches["b2 ensemble"] = fixed_point_ell.launches
    check(fixed_point_ell.launches > 0 or not on_card, "ensemble launched "
          "no fixed_point_ell")
    t0 = time.perf_counter()
    ens_cpu = sweep_with_dependency_ensemble(fs, head, seed=TRACE_SEED,
                                             device="cpu")
    cpu_s = time.perf_counter() - t0
    rtol = {k: F32_TIGHT for k, v in ens_cpu.items()
            if v.dtype.kind == "f" and k not in head}
    compare(ens, ens_cpu, rtol, "ensemble vs cpu")
    same = sum(np.array_equal(ens[k], ens_cpu[k]) for k in ens_cpu)
    check(ens["dep_n_broken_critical"].max() > 0, "ensemble: nothing broke")
    fixed_point_ell.launches = timeline_reduce.launches = 0
    with prof.phase("8c ensemble temporal"):
        ens_t = sweep_with_dependency_ensemble(fs, head, seed=TRACE_SEED,
                                               temporal=True, device=device)
    launches["b2 ensemble temporal"] = fixed_point_ell.launches
    launches["b1 ensemble temporal"] = timeline_reduce.launches
    check((fixed_point_ell.launches > 0 and timeline_reduce.launches > 0)
          or not on_card, "temporal ensemble launched no fixed_point_ell or timeline_reduce")
    direct = SweepEngine(agg, cfg, graph=graph,
                         seed=stage_seed(TRACE_SEED, "sweep-engine"),
                         device=device).run(head)
    check(set(direct) == set(ens_t), "temporal ensemble: keys differ")
    for k, v in direct.items():
        check(np.array_equal(v, ens_t[k], equal_nan=True),
              f"temporal ensemble: {k} differs from the direct engine run")
    log(f"phase 8c ok: ensemble of {rows} scenarios "
        f"{prof.phases['8c ensemble']:.4f} s (cpu {cpu_s:.2f} s; {same} of "
        f"{len(ens_cpu)} keys bit-identical), fixed_point_ell x"
        f"{launches['b2 ensemble']}; temporal "
        f"{prof.phases['8c ensemble temporal']:.4f} s == SweepEngine with "
        f"stage_seed({TRACE_SEED}, 'sweep-engine'), fixed_point_ell x"
        f"{launches['b2 ensemble temporal']}, timeline_reduce x"
        f"{launches['b1 ensemble temporal']} [{card}]")

    # (d) simulate_timeline at a traced failover's snapshot times
    small = synthesize_fleet(scale=0.02, seed=1)
    tracer = obs.Tracer()
    orch = Orchestrator(small, RegionCapacity.for_fleet("r", small),
                        tracer=tracer)
    tcfg = orch.timeline_config()
    rep = orch.failover()
    snap_t = orch.timeline.as_arrays()["t"]
    timeline_reduce.launches = 0
    with prof.phase("8d simulate_timeline"):
        sim = simulate_timeline(tcfg, ts=snap_t, device=device)
    launches["b1 simulate_timeline"] = timeline_reduce.launches
    check(timeline_reduce.launches == on_card, "simulate_timeline: "
          f"{timeline_reduce.launches} timeline_reduce launches, want 1")
    sim_cpu = simulate_timeline(tcfg, ts=snap_t, device="cpu")
    rtol = {k: F32_TIGHT for k, v in sim_cpu.items()
            if np.asarray(v).dtype.kind == "f"}
    rtol["availability_mean"] = AVAIL_MEAN_RTOL
    rtol["t"] = 0.0
    compare({k: np.atleast_1d(v) for k, v in sim.items()},
            {k: np.atleast_1d(v) for k, v in sim_cpu.items()}, rtol,
            "simulate_timeline vs cpu")
    check(abs(float(sim["burst_full_s"]) - rep.burst_full_at_s) <= 1e-2
          and abs(float(sim["am_done_s"]) - rep.am_migrated_at_s) <= 1e-2,
          "simulate_timeline: completion times differ from the failover's")
    mon = slo.monitor_orchestrator(small, orch)
    path = os.path.join(ROOT, "build", "phase8_metrics.prom")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    text = open(export.write_prometheus(path)).read()
    export.write_jsonl(path[:-len(".prom")] + ".jsonl",
                       meta={"phase": 8, "scenarios": n})
    problems = export.validate_prometheus(text) + \
        obs.validate_chrome_trace(tracer.to_chrome())
    check(not problems, f"phase 8 exports: {problems[:5]}")
    # cold, warm, traces off and profiled runs of n, the cpu run of rows
    metered = (2 + WARM_RUNS + profiled) * n + rows
    check(obs.value("ufa_timeline_scenarios_total") == metered,
          f"phase 8: {obs.value('ufa_timeline_scenarios_total')} timeline "
          f"scenarios metered, want {metered}")
    log(f"phase 8d ok: simulate_timeline at {len(snap_t)} snapshot times "
        f"of a {len(small)}-service failover ({len(tracer)} trace events) "
        f"{prof.phases['8d simulate_timeline']:.4f} s, card == cpu; "
        f"monitor_orchestrator alert={mon['alert']}; metrics "
        f"{len(export.parse_prometheus(text))} families [{card}]")
    obs.disable()
    return launches


# ---------------------------------------------------------------------------
# phase 9: the chaos campaign, sampled faults, topologies, the soft path
# and the optimizer, the overcommit simulator
# ---------------------------------------------------------------------------


def same_report(got, want, where: str) -> None:
    """Campaign reports at trouble-free grades: statuses, brackets, probe
    rows and every boolean exact; float verdicts rtol 1e-6,
    ``t_availability_mean`` 1e-5."""
    check((got.op_ok, got.n_evals, got.n_rounds, got.grid_equiv_evals)
          == (want.op_ok, want.n_evals, want.n_rounds,
              want.grid_equiv_evals), f"{where}: campaign totals differ")
    for g, w in zip(got.rays, want.rays):
        check((g.name, g.status, g.lo, g.hi, g.frontier_severity,
               g.counterexample, g.n_probes)
              == (w.name, w.status, w.lo, w.hi, w.frontier_severity,
                  w.counterexample, w.n_probes),
              f"{where}: ray {w.name} differs")
    check(len(got.probe_log) == len(want.probe_log),
          f"{where}: probe logs differ in length")
    for i, (g, w) in enumerate(zip(got.probe_log, want.probe_log)):
        check((g["ray"], g["severity"], g["ok"], g["row"])
              == (w["ray"], w["severity"], w["ok"], w["row"]),
              f"{where}: probe {i} differs")
        for k, v in w["verdict"].items():
            x = g["verdict"][k]
            if isinstance(v, bool) or not np.isfinite(v):
                check(x == v, f"{where}: probe {i} {k} {x} != {v}")
                continue
            rtol = AVAIL_MEAN_RTOL if k == "t_availability_mean" \
                else F32_TIGHT
            check(abs(x - v) <= rtol * abs(v),
                  f"{where}: probe {i} {k} {x} vs {v} beyond rtol {rtol}")


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


def sweep_grades(got: dict, want: dict, grid: dict, where: str) -> None:
    rtol = {k: F32_TIGHT for k, v in want.items() if v.dtype.kind == "f"}
    rtol["t_availability_mean"] = AVAIL_MEAN_RTOL
    for k in grid:
        rtol[k] = 0.0
    compare(got, want, rtol, where)


def phase_chaos(torch, device, fs, graph, eng, card) -> dict:
    """The chaos campaign, the sampled-fault sweep, N-region topologies,
    the soft path and the capacity optimizer, and the overcommit
    simulator on the card, each held against the port's CPU run; returns
    the kernels' launches by path and the phase's numbers."""
    import copy

    from repro_torch import obs
    from repro_torch.chaos import (RegionTopology, campaign_for_fleet,
                                   expand_failures, reduce_pattern_verdicts,
                                   sample_faults, verify_report)
    from repro_torch.chaos.faults import DEFAULT_CORR_PAIRS
    from repro_torch.core import overcommit_sim
    from repro_torch.core.scenarios import scenario_grid
    from repro_torch.graph import CallGraph
    from repro_torch.graph.planner import plan_hardening
    from repro_torch.kernels.ufa.propagation import fixed_point_ell
    from repro_torch.kernels.ufa.reduce import timeline_reduce
    from repro_torch.optim import capacity as cap

    on_card = device.type == "cuda"   # a cpu rehearsal launches no kernel
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    launches, out = {}, {}

    def counted(fn):
        timeline_reduce.launches = 0
        fixed_point_ell.launches = 0
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0, (timeline_reduce.launches,
                                               fixed_point_ell.launches)

    # (a) the campaign on phase 3's fleet, hardened on the card
    t0 = time.perf_counter()
    hfs = copy.deepcopy(fs)
    plan = plan_hardening(graph, device=device)
    hfs.edges.fail_open[graph.input_edge_indices(plan.hardened_edges)] = True
    camp = campaign_for_fleet(hfs, seed=CHAOS_SEED, device=device)
    log(f"phase 9a: {plan.n_hardened} edges hardened, campaign built "
        f"(placement, call graph, engine) in "
        f"{time.perf_counter() - t0:.2f} s")
    obs.default_registry().reset()
    obs.enable()
    rep, cold, (b1, b2) = counted(camp.run)
    check(obs.value("ufa_chaos_evals_total") == rep.n_evals
          and obs.value("ufa_chaos_rounds_total") == rep.n_rounds,
          "campaign: metered evals or rounds differ from the report")
    obs.disable()
    launches["b1 campaign"], launches["b2 campaign"] = b1, b2
    check((b1 > 0 and b2 > 0) or not on_card,
          f"campaign launched timeline_reduce {b1}, fixed_point_ell {b2}")
    check(rep.op_ok, "campaign: the hardened fleet fails its operating point")
    statuses = [r.status for r in rep.rays]
    check(len(rep.rays) == 8 and "localized" in statuses,
          f"campaign: rays {statuses}")
    camp2 = campaign_for_fleet(hfs, seed=CHAOS_SEED, device=device)
    rep2, warm, _ = counted(camp2.run)
    check(rep2.to_json(sort_keys=True) == rep.to_json(sort_keys=True),
          "campaign: a second run is not byte-identical")
    t0 = time.perf_counter()
    cpu_camp = campaign_for_fleet(hfs, seed=CHAOS_SEED, device="cpu")
    cpu_rep = cpu_camp.run()
    cpu_s = time.perf_counter() - t0
    same_report(rep, cpu_rep, "campaign vs cpu")
    fresh = campaign_for_fleet(hfs, seed=CHAOS_SEED, device=device)
    audit, verify_s, _ = counted(lambda: verify_report(rep, fresh.engine))
    check(audit["n_probes"] == rep.n_evals and not audit["mismatches"],
          "campaign: verify_report drifted")
    tampered = copy.deepcopy(rep)
    tampered.probe_log[-1]["verdict"]["availability"] += 0.5
    try:
        verify_report(tampered, fresh.engine)
        check(False, "campaign: verify_report passed a tampered report")
    except AssertionError:
        pass
    out["campaign"] = {
        "n_evals": rep.n_evals, "n_rounds": rep.n_rounds,
        "grid_equiv_evals": rep.grid_equiv_evals,
        "speedup_vs_grid": rep.speedup_vs_grid,
        "n_localized": rep.n_localized, "cold_s": round(cold, 4),
        "warm_s": round(warm, 4), "verify_s": round(verify_s, 4),
        "cpu_s": round(cpu_s, 2), "b1": b1, "b2": b2}
    log(f"phase 9a ok: campaign {json.dumps(out['campaign'])}; rays "
        + ", ".join(f"{r.name} {r.status}"
                    + (f" {r.frontier_severity:.4f}"
                       if r.frontier_severity is not None else "")
                    for r in rep.rays)
        + f"; card == cpu (statuses, brackets, {len(rep.probe_log)} probe "
        f"rows), byte-identical rerun, verify_report passes on a fresh "
        f"engine and refuses a tampered report [{card}]")

    # (b) sampled joint faults through the campaign's engine
    t0 = time.perf_counter()
    faults = sample_faults(CHAOS_SEED, CHAOS_FAULTS, device=device)
    sample_s = time.perf_counter() - t0
    sev, fams = faults["severity"], faults["families"]
    idx = {name: j for j, name in enumerate(fams)}
    means = sev.mean(axis=0)
    check(np.all(np.abs(means - 0.5) < 0.01),
          f"sampled faults: marginal means {means}")
    ranks = {}
    for (a, b), rho in DEFAULT_CORR_PAIRS.items():
        want = 6.0 / np.pi * np.arcsin(rho / 2.0)
        got = spearman(sev[:, idx[a]], sev[:, idx[b]])
        ranks[f"{a}~{b}"] = round(got, 4)
        check(abs(got - want) < 0.03,
              f"sampled faults: rank correlation {a}~{b} {got:.4f}, "
              f"copula {want:.4f}")
    free = spearman(sev[:, idx["preheat_stall"]],
                    sev[:, idx["burst_shortfall"]])
    ranks["preheat_stall~burst_shortfall"] = round(free, 4)
    check(abs(free) < 0.03, f"sampled faults: free pair rank {free:.4f}")
    grid = faults["grid"]
    res, cold_f, (b1, b2) = counted(lambda: camp.engine.run(grid))
    launches["b1 sampled faults"], launches["b2 sampled faults"] = b1, b2
    chunks = -(-CHAOS_FAULTS // 4096)
    check((b1 == chunks and b2 == 1) or not on_card,
          f"sampled faults: timeline_reduce {b1} (want {chunks}), "
          f"fixed_point_ell {b2} (want 1)")
    again, warm_f, _ = counted(lambda: camp.engine.run(grid))
    for k in res:
        check(np.array_equal(res[k], again[k], equal_nan=True),
              f"sampled faults: {k} differs between runs")
    rows = min(TRACE_ROWS, CHAOS_FAULTS)
    head = {k: v[:rows] for k, v in grid.items()}
    t0 = time.perf_counter()
    cpu = cpu_camp.engine.run(head)
    cpu_f = time.perf_counter() - t0
    sweep_grades({k: v[:rows] for k, v in res.items()}, cpu, head,
                 "sampled faults vs cpu")
    out["sampled faults"] = {
        "n": CHAOS_FAULTS, "sample_s": round(sample_s, 4),
        "cold_s": round(cold_f, 4), "warm_s": round(warm_f, 4),
        "scen_per_s_warm": round(CHAOS_FAULTS / warm_f, 1),
        "n_sla_ok": int((res["sla_ok"] & res["t_sla_ok"]).sum()),
        "b1": b1, "b2": b2, "cpu_s": round(cpu_f, 2), "ranks": ranks}
    log(f"phase 9b ok: sampled faults {json.dumps(out['sampled faults'])};"
        f" marginal means {np.round(means, 4).tolist()}; first {rows} rows"
        f" == cpu [{card}]")
    del res, again, faults, sev

    # (c) N-region topologies
    rng = np.random.default_rng(CHAOS_SEED)
    topo3 = RegionTopology.uniform(3)
    names = tuple(f"region-{i}" for i in range(5))
    topo5 = RegionTopology(weights=tuple(float(w) for w in
                                         rng.random(5) + 0.2), names=names)
    pats = np.array([[r in (a, b) for r in range(5)]
                     for a in range(5) for b in range(a + 1, 5)])
    topo_out = []
    for topo, failed, degr in (
            (topo3, topo3.single_failures(), None),
            (topo5, pats, rng.random(pats.shape) * 0.5)):
        tgrid, pid, rid = expand_failures(topo, failed, degr)
        gres, gpu_s, (b1, _) = counted(lambda: camp.engine.run(tgrid))
        cres = cpu_camp.engine.run(tgrid)
        sweep_grades(gres, cres, tgrid, f"topology {topo.n} vs cpu")
        g = reduce_pattern_verdicts(gres, pid, topo, rid)
        c = reduce_pattern_verdicts(cres, pid, topo, rid)
        check(np.array_equal(g["sla_ok"], c["sla_ok"])
              and np.array_equal(g["worst_region"], c["worst_region"]),
              f"topology {topo.n}: pattern verdicts differ from the cpu")
        check(np.allclose(g["availability"], c["availability"], rtol=1e-6,
                          atol=0), f"topology {topo.n}: availability")
        topo_out.append({"regions": topo.n, "patterns": len(failed),
                         "rows": len(pid), "n_ok": int(g["sla_ok"].sum()),
                         "s": round(gpu_s, 4), "b1": b1})
    out["topologies"] = topo_out
    log(f"phase 9c ok: topologies {json.dumps(topo_out)}, card == cpu "
        f"[{card}]")

    # (d) the soft path on phase 3's engine (and the campaign's, whose
    # hardened fleet passes near the availability threshold), and the
    # optimizer
    dgrid = scenario_grid()
    margins = []
    for name, e in (("phase 3", eng), ("campaign", camp.engine)):
        hard, _, _ = counted(lambda: e.run(dgrid))
        soft, soft_s, (b1, _) = counted(lambda: e.run(dgrid, soft_tau=1e-3))
        after = e.run(dgrid)
        n_bool = 0
        for k, v in hard.items():
            check(np.array_equal(v, after[k], equal_nan=True),
                  f"soft ({name}): hard {k} differs after a soft run")
            if v.dtype == np.bool_:
                n_bool += 1
                flips = np.flatnonzero((soft[k] >= 0.5) != v)
                check(flips.size == 0, f"soft ({name}): {k} thresholded "
                      f"differs from the hard verdict in rows "
                      f"{flips[:8].tolist()}")
        margins.append(float(np.abs(hard["t_availability_mean"]
                                    - (0.9997 - 5e-5)).min()))
    launches["b1 soft run"] = b1
    margin = min(margins)
    base_c = cap.DesignBase.from_fleet_state(fs)
    knobs = dict(buffer=0.6, promote=(0.4, 0.3, 0.2), overcommit=1.4,
                 ramp=0.9, evict_lambda=0.2)
    ts_np = np.asarray(eng.ts, np.float32)
    grads = {}
    for dev in (device, torch.device("cpu")):
        b = base_c.as_arrays(dev)
        cols = cap._grid_cols(cap.certification_grid(), dev)
        ts = torch.from_numpy(ts_np).to(dev)
        for tau in (1.0, 0.1):
            loss, g = cap._soft_loss_grad(
                cap.make_knobs(**knobs, device=dev), b, cols, ts,
                torch.tensor(tau, device=dev),
                torch.tensor(200.0, device=dev))
            grads[(dev.type, tau)] = (float(loss),
                                      {k: v.cpu().numpy()
                                       for k, v in g.items()})
    for tau in (1.0, 0.1):
        (lc, gc), (lp, gp) = grads[("cpu", tau)], grads[(device.type, tau)]
        check(abs(lp - lc) <= 1e-4 * abs(lc),
              f"soft_loss tau {tau}: card {lp} vs cpu {lc}")
        # at tau 1 the eviction-order and promotion components of the
        # availability term are float32 cancellation noise (tests/
        # test_torch_capacity.py says why): held where the gradient is
        # signal
        keys = ("buffer", "overcommit", "ramp") if tau == 1.0 else tuple(gc)
        for k in keys:
            check(np.allclose(gp[k], gc[k], rtol=1e-4, atol=1e-12),
                  f"soft_loss grad tau {tau} {k}: card {gp[k]} vs "
                  f"cpu {gc[k]}")
    # ms per gradient step and per CEM generation, B1 per generation
    b = base_c.as_arrays(device)
    cols = cap._grid_cols(cap.certification_grid(), device)
    ts = torch.from_numpy(ts_np).to(device)
    kn = cap.legacy_knobs(device)
    tau, pen = (torch.tensor(v, device=device) for v in (0.3, 200.0))
    cap._soft_loss_grad(kn, b, cols, ts, tau, pen)
    _, step_s, (b1_step, _) = counted(lambda: [cap._soft_loss_grad(
        kn, b, cols, ts, tau, pen) for _ in range(10)])
    n = len(cols["traffic_mult"])
    from repro_torch.core.sweep_engine import bucket_shape
    shape = bucket_shape(n)
    total = shape[0] * shape[1]
    pch = {k: torch.cat([v, v[-1:].repeat(total - n)]).reshape(shape)
           for k, v in cols.items()}
    mask = torch.zeros(total, device=device)
    mask[:n] = 1.0
    mask = mask.reshape(shape)
    pop = cap._flatten_knobs(kn)[None, :] + torch.randn(
        (48, 7), generator=torch.Generator().manual_seed(CHAOS_SEED)
    ).to(device)
    cap._cem_scores(pop, b, pch, mask, ts, pen)
    _, gen_s, (b1_gen, _) = counted(lambda: [cap._cem_scores(
        pop, b, pch, mask, ts, pen) for _ in range(3)])
    launches["b1 CEM generation"] = b1_gen // 3
    check(b1_gen // 3 == -(-48 * total // 4096) or not on_card,
          f"CEM: {b1_gen // 3} timeline_reduce launches a generation")
    opt, opt_s, (b1_opt, b2_opt) = counted(
        lambda: cap.optimize_capacity(fs, mode="both", device=device))
    v = opt.verification
    check(opt.improved and v["all_ok"],
          f"optimize_capacity: improved {opt.improved}, verification {v}")
    vd, _, (b1_v, _) = counted(lambda: cap.verify_design(
        {k: torch.as_tensor(np.asarray(x, np.float32)).to(device)
         for k, x in opt.design.items()}, device=device))
    launches["b1 verify_design"] = b1_v
    check(vd["all_ok"], "verify_design of the optimum on the card failed")
    w = cap.hardening_weights(fs, graph, device=device)
    w_cpu = cap.hardening_weights(fs, graph, device="cpu")
    check(np.allclose(w, w_cpu, rtol=1e-4, atol=0),
          "hardening_weights: card vs cpu beyond rtol 1e-4")
    fallback = bool(np.allclose(
        w, fs.spec_cores / fs.spec_cores[graph.critical].mean(), rtol=1e-6))
    t0 = time.perf_counter()
    wplan = plan_hardening(graph, service_weights=w, device=device)
    wplan_s = time.perf_counter() - t0
    cpu_plan = plan_hardening(graph, service_weights=w_cpu, device="cpu")
    same_plan(wplan, cpu_plan, "weighted plan vs cpu")
    out["soft"] = {"soft_run_s": round(soft_s, 4), "n_bool_keys": n_bool,
                   "avail_margin_min": margin, "b1": launches["b1 soft run"]}
    out["optimizer"] = {
        "start_multiple": round(opt.start_multiple, 4),
        "multiple": round(opt.provisioning_multiple, 4),
        "all_ok": v["all_ok"], "s": round(opt_s, 2),
        "ms_per_grad_step": round(step_s * 100.0, 3),
        "b1_per_grad_step": b1_step // 10,
        "ms_per_cem_generation": round(gen_s * 1e3 / 3, 3),
        "b1_per_cem_generation": b1_gen // 3, "b1": b1_opt, "b2": b2_opt,
        "t_availability_mean_min": v["t_availability_mean_min"],
        "weights_fallback": fallback, "weighted_plan_edges":
            wplan.n_hardened, "weighted_plan_s": round(wplan_s, 3)}
    log(f"phase 9d ok: soft {json.dumps(out['soft'])}: thresholded == hard "
        f"on {n_bool} boolean keys, hard path bit-identical after; "
        f"soft_loss and grad card == cpu; optimizer "
        f"{json.dumps(out['optimizer'])}; hardening_weights card == cpu, "
        f"weighted plan == cpu [{card}]")

    # (e) the overcommit simulator
    _, oc_cold, _ = counted(lambda: overcommit_sim.recommend_factor(
        device=device))
    rec, oc_warm, _ = counted(lambda: overcommit_sim.recommend_factor(
        device=device))
    rec_cpu = overcommit_sim.recommend_factor(device="cpu")
    d = np.abs(np.asarray(rec["violation_rates"])
               - np.asarray(rec_cpu["violation_rates"]))
    check(d.max() <= 1e-4 and rec["recommended"] == rec_cpu["recommended"]
          and rec["safe"] == rec_cpu["safe"],
          f"overcommit: card {rec['recommended']} vs cpu "
          f"{rec_cpu['recommended']}, rates differ by {d.max()}")
    out["overcommit"] = {"recommended": rec["recommended"],
                         "safe": rec["safe"],
                         "max_rate_diff": float(d.max()),
                         "cold_ms": round(oc_cold * 1e3, 3),
                         "warm_ms": round(oc_warm * 1e3, 3)}
    log(f"phase 9e ok: overcommit {json.dumps(out['overcommit'])}, card == "
        f"cpu on the same host draws [{card}]")
    return {"launches": launches, "numbers": out}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 10: the attention, MoE and hybrid models on the card
# ---------------------------------------------------------------------------

# the model kernels' counters and the prefix of each one's CUDA kernels in
# a profiler trace
KERNEL_PREFIX = {"rmsnorm": "rmsnorm_", "decode_attention": "decode_",
                 "flash_attention": "flash_", "grouped_matmul": "gmm_",
                 "ssd_scan": "ssd_"}


def arch_config(module: str, **changes):
    """A full config of ``repro_torch.configs`` with ``changes`` (depth
    and dtypes) applied."""
    cfg = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    return dataclasses.replace(cfg, **changes)


def fp32(module: str, n_layers: int):
    return arch_config(module, n_layers=n_layers, param_dtype="float32",
                       activ_dtype="float32")


def zero_launches(ops) -> None:
    for name in KERNEL_PREFIX:
        getattr(ops, name).launches = 0


def read_launches(ops) -> dict:
    return {name: getattr(ops, name).launches for name in KERNEL_PREFIX}


class RouteRecorder:
    """Inside a ``with`` block, records every MoE layer's expert choices
    and queue positions (as host tensors) by wrapping the layer module's
    ``moe_routing``, ``_expert_positions`` and ``_expert_positions_big``;
    with ``logits``, also each layer's router logits (float32, from the
    router's own input and weights)."""

    def __init__(self, layers, logits: bool = False):
        self.layers, self.experts, self.positions = layers, [], []
        self.keep_logits, self.logits = logits, []

    def __enter__(self):
        L = self.layers
        self._saved = (L.moe_routing, L._expert_positions,
                       L._expert_positions_big)
        routing, positions, positions_big = self._saved

        def rec_routing(router_w, x, *a, **k):
            out = routing(router_w, x, *a, **k)
            self.experts.append(out[1].cpu())
            if self.keep_logits:
                self.logits.append((x.float() @ router_w.float()).cpu())
            return out

        def recorder(fn):
            def rec(*a, **k):
                out = fn(*a, **k)
                self.positions.append(out.cpu())
                return out
            return rec

        L.moe_routing = rec_routing
        L._expert_positions = recorder(positions)
        L._expert_positions_big = recorder(positions_big)
        return self

    def __exit__(self, *exc):
        (self.layers.moe_routing, self.layers._expert_positions,
         self.layers._expert_positions_big) = self._saved


class CallRecorder:
    """Inside a ``with`` block, records the ``kernel_signature`` of every
    call the model makes to a kernel of ``kernels.ops`` by wrapping the
    module's entry points; each wrapped wrapper still keeps its own
    count."""

    def __init__(self, ops):
        self.ops, self.signatures = ops, set()

    def __enter__(self):
        self._saved = {name: getattr(self.ops, name)
                       for name in KERNEL_PREFIX}
        for name, fn in self._saved.items():
            def rec(*a, _name=name, _fn=fn, **k):
                self.signatures.add(kernel_signature(_name, a, k))
                return _fn(*a, **k)
            setattr(self.ops, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)


class OpSwap:
    """Inside a ``with`` block, ``module.name`` is ``fn``."""

    def __init__(self, module, name: str, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self._saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._saved)


def hold_card_cpu(torch, device, module: str, n_layers: int, B: int, S: int,
                  seed: int, card: str, params=None,
                  phase: str = "10a") -> dict:
    """Phase 10a for one config: the fp32 forward (hidden states and the
    last position's logits) on the card against the port's CPU run on the
    same weights (one seeded init on the card, or the first ``n_layers``
    of ``params``, copied to the host); for a MoE config also every
    layer's expert ids and queue positions, exactly."""
    from repro_torch import models
    from repro_torch.models import layers
    cfg = fp32(module, n_layers)
    params = (models.init_params(cfg, seed, device=device) if params is None
              else first_layers(params, n_layers))
    toks = host_inputs(torch, cfg, B, S, seed)
    with RouteRecorder(layers) as card_routes:
        h, _ = models.forward(params, cfg, toks.to(device))
        last = models.logits_fn(params, cfg, h[:, -1:])
    t0 = time.perf_counter()
    cpu_params = to_cpu(params)
    del params
    with RouteRecorder(layers) as cpu_routes:
        h_cpu, _ = models.forward(cpu_params, cfg, toks)
        last_cpu = models.logits_fn(cpu_params, cfg, h_cpu[:, -1:])
    cpu_s = time.perf_counter() - t0
    where = f"phase {phase} {cfg.name} {n_layers} layers B {B} x S {S}"
    errs = {}
    for name, got, want in (("hidden", h, h_cpu), ("logits", last, last_cpu)):
        got = got.cpu()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{where}: {name} {tuple(got.shape)} or non-finite")
        d = (got - want).abs()
        over = int((d > MODEL7_TOL * (1 + want.abs())).sum())
        errs[name] = float(d.max())
        check(over == 0, f"{where}: {name} differs from the CPU run beyond "
              f"rtol=atol={MODEL7_TOL} in {over} entries (max abs "
              f"{errs[name]:.3g})")
    routed = len(card_routes.experts)
    check(routed == (n_layers if cfg.is_moe else 0)
          and len(cpu_routes.experts) == routed,
          f"{where}: {routed} routed layers on the card, "
          f"{len(cpu_routes.experts)} on the CPU")
    for i in range(routed):
        for what, a, b in (("expert ids", card_routes.experts[i],
                            cpu_routes.experts[i]),
                           ("positions", card_routes.positions[i],
                            cpu_routes.positions[i])):
            check(torch.equal(a, b), f"{where}: layer {i} {what} differ "
                  f"card vs CPU in {int((a != b).sum())} of {a.numel()}")
    log(f"{where} ok: fp32 forward card == CPU (max abs err hidden "
        f"{errs['hidden']:.3g}, logits {errs['logits']:.3g}; limit "
        f"rtol=atol={MODEL7_TOL})"
        + (f"; expert ids and positions equal in {routed} layers"
           if routed else "") + f"; CPU run {cpu_s:.2f} s [{card}]")
    return {"config": cfg.name, "layers": n_layers, "batch": B, "seq": S,
            "max_abs_err": errs, "routed_layers": routed}


def decode_error(torch, models, params, cfg, toks, full_logits) -> float:
    """Max |teacher-forced decode logits - forward logits| over every
    step, from a zero float32 state.  ``toks``: (B, S) ids, or (B, S, D)
    embeddings for a stub frontend."""
    B, S = toks.shape[:2]
    state = models.init_decode_state(cfg, B, S, torch.float32,
                                     device=toks.device)
    worst = torch.zeros((), device=toks.device)
    for t in range(S):
        lg, state = models.decode_step(params, cfg, state, toks[:, t])
        worst = torch.maximum(worst, (lg - full_logits[:, t]).abs().max())
    return float(worst)


def hold_decode(torch, device, module: str, n_layers: int, B: int, S: int,
                seed: int, card: str, kv_quant: bool, sync_check: bool,
                params=None, phase: str = "10b") -> dict:
    """Phase 10b for one config: the fp32 forward's logits against S
    teacher-forced decode steps on the card (B5 each layer a step),
    within ``DECODE_TOL`` of max|logit|; with ``kv_quant`` the int8-cache
    decode within ``KVQ_REL_TOL`` of it (the reference's own
    ``test_kv_quant_decode_close_to_fp``).  ``sync_check``: one more
    step with any host synchronise an error (the cache write and B5's
    length stay on the device).  ``params``: the weights to use instead
    of a seeded init (a stub frontend's inputs are embeddings)."""
    from repro_torch import models
    cfg = fp32(module, n_layers)
    if params is None:
        params = models.init_params(cfg, seed, device=device)
    toks = host_inputs(torch, cfg, B, S, seed).to(device)
    full = models.logits_fn(params, cfg, models.forward(params, cfg, toks)[0])
    scale = float(full.abs().max())
    dcfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    t0 = time.perf_counter()
    worst = decode_error(torch, models, params, dcfg, toks, full)
    step_ms = 1e3 * (time.perf_counter() - t0) / S
    tol = KVQ_REL_TOL if kv_quant else DECODE_TOL
    where = (f"phase {phase} {cfg.name}{' kv_quant' if kv_quant else ''} "
             f"{n_layers} layers B {B} x S {S}")
    check(np.isfinite(worst) and worst <= tol * scale,
          f"{where}: teacher-forced decode differs from the forward by "
          f"{worst:.3g}, over {tol} x max|logit| {scale:.3g}")
    log(f"{where} ok: {S} teacher-forced decode steps == forward (max abs "
        f"err {worst:.3g} = {worst / scale:.3g} of max|logit| {scale:.3g}; "
        f"limit {tol}); {step_ms:.3f} ms a step [{card}]")
    out = {"config": cfg.name, "layers": n_layers, "batch": B, "seq": S,
           "kv_quant": kv_quant, "max_abs_err": worst, "max_abs_logit": scale}
    if sync_check:
        state = models.init_decode_state(cfg, B, S + 1, torch.float32,
                                         device=device, length=S)
        models.decode_step(params, cfg, state, toks[:, 0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            models.decode_step(params, cfg, state, toks[:, 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out["sync_free_step"] = True
        log(f"{where}: one decode step under set_sync_debug_mode('error') "
            f"ok (no host synchronise) [{card}]")
    return out


def timed_run(torch, ops, label: str, fn, want: dict, reps: int,
              card: str, held: set, phase: str = "10c") -> dict:
    """A counted, timed and profiled bf16 run of ``fn``: the counts
    zeroed just before one call and read just after (held to ``want``),
    every kernel call of that run found among ``held`` (the calls phase
    6 held against the plain version: the same shapes, dtypes, layout
    and options), the peak device memory of that call, CUDA-event ms
    over ``reps`` calls, and one profiled call: its device busy time,
    idle share and each model kernel's share of device time."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(ops)
    torch.cuda.synchronize()
    with CallRecorder(ops) as calls:
        out = fn()
    torch.cuda.synchronize()
    launches = read_launches(ops)
    peak = torch.cuda.max_memory_allocated()
    check(launches == want, f"phase {phase} {label}: launches {launches}, "
          f"want {want}")
    unheld = calls.signatures - held
    check(not unheld, f"phase {phase} {label}: kernel calls that phase 6 "
          f"does not hold against the plain version: {sorted(unheld)}")
    check(all(bool(torch.isfinite(t).all()) for t in out),
          f"phase {phase} {label}: non-finite outputs")
    ms = device_ms(torch, fn, reps=reps, warmup=1)
    stats = {}
    kernels_us = profile_run(label, torch, fn, card, stats)
    busy = sum(kernels_us.values())
    share = {name: (sum(us for k, us in kernels_us.items() if prefix in k)
                    / busy if busy > 0 else None)
             for name, prefix in KERNEL_PREFIX.items()}
    log(f"profile {label}: share of device time by model kernel "
        f"{json.dumps(share)} [{card}]")
    return {"ms": ms, "peak_bytes": peak, "launches": launches,
            "kernel_share": share, "idle_share": stats.get("idle_share"),
            "device_ms": busy / 1e3 if busy > 0 else None}


def phase_models(torch, device, card: str, held: set) -> dict:
    """Phase 10: llama3.2-3b, gemma3-4b, hymba-1.5b and phi3.5-moe at full
    width through ``repro_torch.models``: (a) fp32 forwards, depth cut,
    card against the port's CPU run (expert ids and positions exactly);
    (b) fp32 teacher-forced decode against the forward, llama3.2-3b also
    with the int8 cache, and one step with no host synchronise; (c) bf16
    from the port's seeded init, timed: the llama3.2-3b prefill of
    B 2 x S 4,096 (all 28 layers) and its decode at B 8 against a
    4,352-slot cache, the phi3.5-moe prefill (8 layers) and the
    hymba-1.5b prefill (all 32 layers), each with the kernel counts
    checked and every kernel call found among ``held``, the calls phase
    6 held against the plain version."""
    from repro_torch import models
    from repro_torch.configs.base import cache_seq_len
    from repro_torch.kernels import ops
    out = {"card_vs_cpu": [], "decode_vs_forward": []}
    seed = MODEL10_SEED
    for module, n_layers, B, S in MODEL10_CARD_CPU:
        seed += 1
        out["card_vs_cpu"].append(hold_card_cpu(torch, device, module,
                                                n_layers, B, S, seed, card))
        torch.cuda.empty_cache()
    for module, n_layers, B, S, kv_quant, sync_check in MODEL10_DECODE:
        seed += 1
        out["decode_vs_forward"].append(hold_decode(
            torch, device, module, n_layers, B, S, seed, card, kv_quant,
            sync_check))
        torch.cuda.empty_cache()

    B, S = PREFILL_SHAPE
    none = dict.fromkeys(KERNEL_PREFIX, 0)
    runs = {}
    for label, module, n_layers, want in MODEL10_PREFILL:
        seed += 1
        cfg = arch_config(module, n_layers=n_layers)
        params = models.init_params(cfg, seed, device=device)
        toks = torch.from_numpy(host_tokens(cfg, B, S, seed)).to(device)
        if cfg.is_moe:
            cap = models.moe_capacity(cfg, B * S)
            check(cap == 1280, f"phase 10c {label}: capacity {cap}")

        def prefill():
            h, _ = models.forward(params, cfg, toks)
            return h, models.logits_fn(params, cfg, h[:, -1:])

        row = timed_run(torch, ops, label, prefill, {**none, **want}, 3, card,
                        held)
        row.update(config=cfg.name, layers=n_layers, batch=B, seq=S,
                   tokens_per_s=B * S / (row["ms"] / 1e3))
        log(f"phase 10c {label}: {cfg.name} bf16 {n_layers} layers, prefill "
            f"B {B} x S {S} (forward + last-position logits) {row['ms']:.3f}"
            f" ms = {row['tokens_per_s']:.1f} tokens/s; peak device memory "
            f"{row['peak_bytes'] / 2**30:.3f} GiB; idle share "
            f"{row['idle_share']}; launches {row['launches']} [{card}]")
        runs[label] = row
        if label == "llama3.2-3b prefill":
            # decode at B 8 against the cache of a 4,096-token prompt
            Bd = DECODE_BATCH
            state = models.init_decode_state(cfg, Bd, cache_seq_len(S),
                                             device=device, length=S)
            tok = torch.from_numpy(host_tokens(cfg, Bd, 1, seed)[:, 0]).to(
                device)
            box = [state]

            def step():
                lg, box[0] = models.decode_step(params, cfg, box[0], tok)
                return (lg,)

            step()
            drow = timed_run(torch, ops, "llama3.2-3b decode", step,
                             {**none, "decode_attention": cfg.n_layers,
                              "rmsnorm": 2 * cfg.n_layers + 1}, 8, card,
                             held)
            drow.update(config=cfg.name, batch=Bd,
                        cache_slots=cache_seq_len(S), length=S,
                        tokens_per_s=Bd / (drow["ms"] / 1e3))
            log(f"phase 10c llama3.2-3b decode: B {Bd} against "
                f"{cache_seq_len(S)} cache slots from length {S}: "
                f"{drow['ms']:.3f} ms a step ({drow['tokens_per_s']:.1f} "
                f"tokens/s); peak device memory "
                f"{drow['peak_bytes'] / 2**30:.3f} GiB; idle share "
                f"{drow['idle_share']} [{card}]")
            runs["llama3.2-3b decode"] = drow
            del state, box
        del params
        torch.cuda.empty_cache()
    out["timed"] = runs
    return out


# ---------------------------------------------------------------------------
# phase 11: the serving plane on the card
# ---------------------------------------------------------------------------


class WindowDone(Exception):
    """Raised by a ``StepWindow(stop=True)`` hook once its window is
    traced: the rest of the run is read by nothing."""


class StepWindow:
    """The device traced over decode steps ``first`` .. ``first + count
    - 1`` of a serving run (counted over every engine whose step
    function ``hook`` wraps): the idle share of a steady window of a run
    of thousands of steps, whose whole trace would take minutes to
    read.  The window's wall runs from a synchronise before its first
    step to one after its last, scheduler rounds between steps
    included."""

    def __init__(self, torch, first: int, count: int, stop: bool = False):
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.first, self.count, self.n = torch, first, count, 0
        self.stop = stop
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.wall_us = None

    def hook(self, base):
        def step(*args):
            if self.n == self.first:
                self.torch.cuda.synchronize()
                self.prof.start()
                self.t0 = time.perf_counter()
            out = base(*args)
            self.n += 1
            if self.n == self.first + self.count:
                self.torch.cuda.synchronize()
                self.wall_us = 1e6 * (time.perf_counter() - self.t0)
                self.prof.stop()
                if self.stop:
                    raise WindowDone
            return out
        return step

    def report(self, what: str, card: str) -> dict:
        check(self.wall_us is not None, f"{what}: {self.n} decode steps, "
              f"fewer than the window's end {self.first + self.count}")
        stats = {}
        profile_report(f"{what}, decode steps {self.first}-"
                       f"{self.first + self.count - 1}", self.prof,
                       self.wall_us, card, stats)
        return stats


def drill_fields(rep) -> dict:
    """What of a ``DrillReport`` card and CPU must share exactly: every
    verdict field by tier, ``sla_ok``, ``users_served``, the actuation
    log, the per-step availability traces and the grid."""
    return {"tiers": {int(t): v.as_dict() for t, v in rep.tiers.items()},
            "sla_ok": rep.sla_ok, "users_served": rep.users_served,
            "actuation_log": [(t, int(tier), n)
                              for t, tier, n in rep.actuation_log],
            "avail_trace": {int(t): a.tolist()
                            for t, a in rep.avail_trace.items()},
            "ts": rep.ts.tolist()}


def serve_drill(torch, device, card: str, held: set) -> dict:
    """Phase 11b: ``run_drill(DrillSpec())`` on the card with the counts
    zeroed just before and read just after (the timeline simulation's B1
    once, B5 twice and B4 five times a decode step of the 2-layer model),
    every kernel call found among ``held``; the same drill on the port's
    CPU with the card's weights copied across, equal in every field; the
    reference test's SLA contracts; and one more card run traced on the
    device for the idle share, up to the end of its window."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ufa.reduce import timeline_reduce
    from repro_torch.serving import DrillSpec, run_drill
    from repro_torch.serving import workload
    spec = DrillSpec()
    engines, _ = workload.pool_for(spec, device)
    n_layers = next(iter(engines.values())).cfg.n_layers
    workload._sim_for.cache_clear()
    torch.cuda.synchronize()
    zero_launches(ops)
    timeline_reduce.launches = 0
    with CallRecorder(ops) as calls:
        t0 = time.perf_counter()
        rep = run_drill(spec, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches(ops)
    b1 = timeline_reduce.launches
    steps = launches["decode_attention"] // n_layers
    where = "phase 11b serving drill"
    check(steps > 0 and b1 == 1 and launches == {
        **dict.fromkeys(KERNEL_PREFIX, 0), "decode_attention":
        n_layers * steps, "rmsnorm": (2 * n_layers + 1) * steps},
        f"{where}: launches {launches}, timeline_reduce {b1}")
    unheld = calls.signatures - held
    check(not unheld, f"{where}: kernel calls that phase 6 does not hold "
          f"against the plain version: {sorted(unheld)}")
    log(rep.render())

    cpu_engines, _ = workload.pool_for(spec, "cpu")
    cpu_params = to_cpu(next(iter(engines.values())).params)
    for e in cpu_engines.values():
        e.params = cpu_params
    t0 = time.perf_counter()
    rep_cpu = run_drill(spec, "cpu")
    cpu_s = time.perf_counter() - t0
    got, want = drill_fields(rep), drill_fields(rep_cpu)
    for k in want:
        check(got[k] == want[k], f"{where}: {k} differs card vs CPU: "
              f"{got[k]} vs {want[k]}")
    crit, pre = rep.crit, rep.pre
    check(crit.availability >= spec.avail_slo, f"{where}: crit "
          f"availability {crit.availability} below {spec.avail_slo}")
    check(pre.availability < crit.availability, f"{where}: pre "
          f"availability {pre.availability} not below crit's")
    check(pre.slo_alert, f"{where}: the pre tier's burn-rate alert did "
          f"not fire")
    check(float(rep.avail_trace[spec.pre_tier].min()) < spec.avail_slo,
          f"{where}: the pre tier's availability trace never fell below "
          f"the SLO")

    # the traced run ends with its window (the next drill resets the
    # engines)
    window = StepWindow(torch, *DRILL_WINDOW, stop=True)
    saved = {name: e._step for name, e in engines.items()}
    try:
        for e in engines.values():
            e._step = window.hook(e._step)
        run_drill(spec, device)
    except WindowDone:
        pass
    finally:
        for name, e in engines.items():
            e._step = saved[name]
    stats = window.report("serving drill", card)
    out = {"wall_s": wall, "decode_steps": steps, "ms_a_step":
           1e3 * wall / steps, "idle_share": stats.get("idle_share"),
           "launches": launches, "timeline_reduce": b1, "cpu_s": cpu_s,
           "sla_ok": rep.sla_ok,
           "crit_availability": crit.availability,
           "pre_availability": pre.availability,
           "pre_restore_s": pre.time_to_restore_s}
    log(f"{where} ok: card == CPU in every verdict field, the actuation "
        f"log and the traces; {wall:.3f} s wall, {steps} decode steps, "
        f"{out['ms_a_step']:.3f} ms a step (scheduler included), idle "
        f"share {out['idle_share']}; CPU run {cpu_s:.3f} s; crit "
        f"availability {crit.availability:.4f} >= {spec.avail_slo}, pre "
        f"{pre.availability:.4f} with its alert, restore "
        f"{pre.time_to_restore_s:.0f} s [{card}]")
    return out


def serve_engine(torch, cfg, params, cache_dtype, step_hook=None):
    """One ``ServingEngine`` (max_batch 8, prompt 16 + 16 new + 8 cache
    slots) through the serve CLI's loop: 32 requests cycling the tiers,
    ``enter_failover()`` after 16.  ``step_hook(base)`` may wrap the
    engine's decode step."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving import ServingEngine
    S = SERVE_FULL
    eng = ServingEngine(cfg, params, max_batch=S["max_batch"],
                        max_seq=S["prompt_len"] + S["max_new"] + 8,
                        cache_dtype=cache_dtype)
    if step_hook is not None:
        eng._step = step_hook(eng._step)
    sched = serve(eng, S["requests"], S["prompt_len"], S["max_new"],
                  S["failover_at"], log=lambda *_: None)
    return eng, sched


def serve_counters(eng, sched) -> dict:
    return {"scheduler": {k: {int(t): n for t, n in v.items() if n}
                          for k, v in sched.counters.items()},
            "engine": {k: {int(t): n for t, n in v.items() if n}
                       for k, v in eng.counters.items()},
            "tokens_decoded": eng.tokens_decoded}


def serve_full_width(torch, device, card: str, held: set) -> dict:
    """Phase 11c: llama3.2-3b's published config (28 layers, bf16, from
    the port's seeded init) served through the CLI's loop with a
    failover, counted (B5 28 and B4 57 a decode step), every kernel call
    found among ``held``, timed (a warm run), its peak device memory and
    a profiled run's idle share; the same counters in a second run."""
    from repro_torch import models
    from repro_torch.kernels import ops
    cfg = arch_config("llama3_2_3b")
    params = models.init_params(cfg, MODEL11_SEED, device=device)
    where = "phase 11c llama3.2-3b served"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(ops)
    with CallRecorder(ops) as calls:
        t0 = time.perf_counter()
        eng, sched = serve_engine(torch, cfg, params, torch.bfloat16)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    launches = read_launches(ops)
    peak = torch.cuda.max_memory_allocated()
    steps = launches["decode_attention"] // cfg.n_layers
    check(steps > 0 and launches == {
        **dict.fromkeys(KERNEL_PREFIX, 0),
        "decode_attention": cfg.n_layers * steps,
        "rmsnorm": (2 * cfg.n_layers + 1) * steps},
        f"{where}: launches {launches}")
    unheld = calls.signatures - held
    check(not unheld, f"{where}: kernel calls that phase 6 does not hold "
          f"against the plain version: {sorted(unheld)}")
    counters = serve_counters(eng, sched)
    for r in [r for _, _, r in sched.events if r.state == "done"]:
        check(len(r.output) == SERVE_FULL["max_new"]
              and all(0 <= t < cfg.vocab_size for t in r.output),
              f"{where}: request {r.rid} output {r.output}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng2, sched2 = serve_engine(torch, cfg, params, torch.bfloat16)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(serve_counters(eng2, sched2) == counters,
          f"{where}: a second run's counters differ")
    window = StepWindow(torch, *SERVE_WINDOW)
    serve_engine(torch, cfg, params, torch.bfloat16, window.hook)
    stats = window.report("llama3.2-3b served", card)
    out = {"config": cfg.name, "layers": cfg.n_layers, "cold_s": cold,
           "warm_s": warm, "decode_steps": steps,
           "tokens_decoded": eng.tokens_decoded,
           "ms_a_step": 1e3 * warm / steps, "peak_bytes": peak,
           "idle_share": stats.get("idle_share"), "launches": launches,
           "counters": counters}
    log(f"{where} ok: {cfg.n_layers} layers bf16, max_batch "
        f"{SERVE_FULL['max_batch']}, prompt {SERVE_FULL['prompt_len']}, "
        f"{SERVE_FULL['max_new']} new, {SERVE_FULL['requests']} requests, "
        f"failover after {SERVE_FULL['failover_at']}: {eng.tokens_decoded} "
        f"tokens decoded in {steps} decode steps, warm {warm:.3f} s = "
        f"{out['ms_a_step']:.3f} ms a step (cold {cold:.3f} s); peak "
        f"device memory {peak / 2**30:.3f} GiB; idle share "
        f"{out['idle_share']}; launches {launches}; counters "
        f"{json.dumps(counters)} [{card}]")
    del params
    torch.cuda.empty_cache()
    return out


def serve_parity(torch, device, card: str, full_counters: dict) -> dict:
    """Phase 11c's check: the same schedule at 2 layers in float32, card
    against the port's CPU on the card's weights.  Counters exact (and
    equal to the full-width run's, which the schedule alone sets); every
    step's logits within rtol = atol = ``MODEL7_TOL`` of the CPU's, the
    CPU fed the card's tokens; each step's greedy token equal wherever
    the card's top-2 gap exceeds ``TOKEN_GAP`` of the row's max|logit|."""
    from repro_torch import models
    cfg = fp32("llama3_2_3b", SERVE_PARITY_LAYERS)
    params = models.init_params(cfg, MODEL11_SEED + 1, device=device)
    where = "phase 11c llama3.2-3b served, 2 layers fp32, card vs CPU"
    rec = []

    def record(base):
        def step(p, st, tok):
            lg, st = base(p, st, tok)
            rec.append((tok.cpu(), lg.clone()))
            return lg, st
        return step

    eng, sched = serve_engine(torch, cfg, params, torch.float32, record)
    torch.cuda.synchronize()
    cpu_params = to_cpu(params)
    del params
    seen = {"steps": 0, "worst": 0.0, "near_ties": 0, "flips": 0}

    def replay(base):
        def step(p, st, tok):
            tok_card, lg_card = rec[seen["steps"]]
            seen["steps"] += 1
            check(tok.shape == tok_card.shape, f"{where}: step "
                  f"{seen['steps']} batch {tuple(tok.shape)} vs "
                  f"{tuple(tok_card.shape)}")
            lg, st = base(p, st, tok_card)
            got = lg_card.cpu()
            d = (got - lg).abs()
            over = int((d > MODEL7_TOL * (1 + lg.abs())).sum())
            seen["worst"] = max(seen["worst"], float(d.max()))
            check(over == 0, f"{where}: step {seen['steps']} logits differ "
                  f"beyond rtol=atol={MODEL7_TOL} in {over} entries")
            top = got.topk(2, dim=-1).values
            gap = top[:, 0] - top[:, 1]
            tie = gap <= TOKEN_GAP * got.abs().max(dim=-1).values
            differ = got.argmax(-1) != lg.argmax(-1)
            seen["near_ties"] += int(tie.sum())
            seen["flips"] += int(differ.sum())
            check(not bool((differ & ~tie).any()), f"{where}: step "
                  f"{seen['steps']}: the CPU's greedy token differs where "
                  f"the card's top-2 gap exceeds {TOKEN_GAP} of max|logit|")
            return lg, st
        return step

    t0 = time.perf_counter()
    ceng, csched = serve_engine(torch, cfg, cpu_params, torch.float32,
                                replay)
    cpu_s = time.perf_counter() - t0
    check(seen["steps"] == len(rec), f"{where}: {seen['steps']} CPU steps, "
          f"{len(rec)} on the card")
    counters = serve_counters(eng, sched)
    check(serve_counters(ceng, csched) == counters,
          f"{where}: counters differ card vs CPU")
    check(counters == full_counters, f"{where}: counters differ from the "
          f"28-layer run's: {counters} vs {full_counters}")
    out = {"layers": SERVE_PARITY_LAYERS, "steps": len(rec),
           "max_abs_err": seen["worst"], "near_ties": seen["near_ties"],
           "token_flips": seen["flips"], "cpu_s": cpu_s}
    log(f"{where} ok: counters equal (and equal to the 28-layer run's); "
        f"{len(rec)} steps' logits within rtol=atol={MODEL7_TOL} (max abs "
        f"err {seen['worst']:.3g}); greedy tokens equal but at "
        f"{seen['flips']} near-tie rows of {seen['near_ties']} under a "
        f"top-2 gap of {TOKEN_GAP} of max|logit|; CPU run {cpu_s:.2f} s "
        f"[{card}]")
    del rec
    torch.cuda.empty_cache()
    return out


def cli_run(main, argv):
    """``(what main(argv) printed, what it returned)``."""
    buf = io.StringIO()
    saved = sys.stdout
    sys.stdout = buf
    try:
        result = main(argv)
    finally:
        sys.stdout = saved
    return buf.getvalue(), result


def cli_output(main, argv) -> str:
    return cli_run(main, argv)[0]


def serve_cli(torch, card: str, held: set) -> dict:
    """Phase 11d: the serve CLI (``launch.serve.main``, ``--requests 32
    --failover-at 16``) on the card for each of ``SERVE_ARCHS``, in this
    process with the counts zeroed just before and read just after and
    every kernel call found among ``held``; each run's output equal to
    the port's ``--device cpu`` run.  llama3.2-3b's also as ``python -m
    repro_torch.launch.serve`` in a subprocess on the card, started
    first, its output equal to the same CPU run."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    sub_arch = SERVE_ARCHS[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         sub_arch, *SERVE_CLI_ARGS], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        t0 = time.perf_counter()
        for arch in SERVE_ARCHS:
            where = f"phase 11d serve CLI {arch}"
            cpu = cli_output(serve.main, ["--arch", arch, *SERVE_CLI_ARGS,
                                          "--device", "cpu"])
            torch.cuda.synchronize()
            zero_launches(ops)
            with CallRecorder(ops) as calls:
                card_out = cli_output(serve.main, ["--arch", arch,
                                                   *SERVE_CLI_ARGS])
                torch.cuda.synchronize()
            launches = read_launches(ops)
            check(card_out == cpu, f"{where}: the card's output differs "
                  f"from the CPU's:\n{card_out}\nvs\n{cpu}")
            cfg = get_arch(arch).reduced
            check(launches["rmsnorm"] > 0
                  and (launches["decode_attention"] > 0) == cfg.has_attn
                  and (launches["grouped_matmul"] > 0) == cfg.is_moe,
                  f"{where}: launches {launches}")
            unheld = calls.signatures - held
            check(not unheld, f"{where}: kernel calls that phase 6 does not "
                  f"hold against the plain version: {sorted(unheld)}")
            out[arch] = {"d_head": cfg.d_head if cfg.has_attn else None,
                         "launches": launches, "output": cpu}
            log(f"{where} ok: card == --device cpu (" + "; ".join(
                line.strip() for line in cpu.rstrip("\n").split("\n")[2:])
                + f"), launches {json.dumps(launches)}, "
                f"{len(calls.signatures)} kernel signatures, each held "
                f"[{card}]")
        runs_s = time.perf_counter() - t0
        stdout, stderr = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    where = f"phase 11d serve CLI {sub_arch} (subprocess)"
    check(proc.returncode == 0, f"{where}: exit {proc.returncode}: "
          f"{stderr[-2000:]}")
    check(stdout == out[sub_arch]["output"], f"{where}: the card's output "
          f"differs from the CPU's:\n{stdout}\nvs\n"
          f"{out[sub_arch]['output']}")
    for row in out.values():
        del row["output"]
    log(f"phase 11d: {len(SERVE_ARCHS)} CLI runs on the card and on the "
        f"CPU in this process in {runs_s:.2f} s; {sub_arch}'s subprocess "
        f"on the card == its CPU run, {wall:.2f} s wall [{card}]")
    return out


def phase_serving(torch, device, card: str, held: set) -> dict:
    """Phase 11: the serving plane through ``repro_torch.serving`` and
    ``repro_torch.launch.serve`` on the card, inputs from seed 27: (b)
    the live failover drill, card == CPU, with the reference test's SLA
    contracts; (c) llama3.2-3b's published config served through the
    CLI's loop with a failover, and the same schedule at 2 layers fp32
    card against CPU; (d) the serve CLI on the card against its CPU run
    for every reduced arch the reference's CLI serves."""
    seconds = {}
    t0 = time.perf_counter()
    out = {"drill": serve_drill(torch, device, card, held)}
    seconds["drill"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["served"] = serve_full_width(torch, device, card, held)
    seconds["served"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["served_parity"] = serve_parity(torch, device, card,
                                        out["served"]["counters"])
    seconds["served_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"] = serve_cli(torch, card, held)
    seconds["cli"] = time.perf_counter() - t0
    log(f"phase 11 seconds by part: {json.dumps(seconds)}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the training path
# ---------------------------------------------------------------------------


def train_launches(cfg) -> dict:
    """Kernel launches of one train step of ``cfg``: each layer's forward
    calls (ln1, qk-norm, the SSM's gated norm, ln2 on B4; B6, B7's three
    products, B8), run twice under remat (the forward, then its
    recomputation in the backward pass), and the final norm once.  The
    backward is the plain versions' and launches nothing."""
    per = {"rmsnorm": (1 + 2 * (cfg.has_attn and cfg.qk_norm)
                       + cfg.has_ssm + cfg.has_ffn),
           "decode_attention": 0, "flash_attention": int(cfg.has_attn),
           "grouped_matmul": 3 * cfg.is_moe, "ssd_scan": int(cfg.has_ssm)}
    times = cfg.n_layers * (1 if cfg.remat == "none" else 2)
    out = {k: v * times for k, v in per.items()}
    out["rmsnorm"] += 1
    return out


def same_tree(got, want, where: str) -> int:
    """Every leaf of two trees (checkpoint paths) equal bit for bit, dtype
    and shape included; returns the number of leaves."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    g, w = _flatten_with_paths(got), _flatten_with_paths(want)
    check([p for p, _ in g] == [p for p, _ in w], f"{where}: leaf paths "
          f"differ")
    for (path, a), (_, b) in zip(g, w):
        check(a.dtype == b.dtype and a.shape == b.shape
              and bool(a.eq(b).all()), f"{where}: {path} differs")
    return len(g)


def phase_autograd(torch, device, card: str, held: set) -> dict:
    """Phase 12a: each model kernel's ``torch.autograd.Function`` on the
    card at one full-width shape of phase 12c: its forward launches the
    kernel once and equals the wrapper's output; its input gradients
    equal ``torch.autograd.grad`` through the plain version on the same
    card tensors, bit for bit (its backward is that plain version)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device)
    gen.manual_seed(TRAIN_SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=f32).to(dtype)

    B, S = TRAIN_SHAPE
    cases = (
        ("rmsnorm", "qwen3-1.7b hidden norm",
         (randn(B * S, 2048), randn(2048)), {"eps": 1e-6}, ref.ref_rmsnorm),
        ("flash_attention", "qwen3-1.7b attention",
         tuple(randn(B, S, 16, 128) for _ in range(3)),
         {"causal": True, "window": 0}, ref.ref_flash_attention),
        ("grouped_matmul", "phi3.5-moe expert gate / up",
         (randn(16, 640, 4096), randn(16, 4096, 6400)), {},
         ref.ref_grouped_matmul),
        ("ssd_scan", "mamba2-780m SSD",
         (randn(B, S, 48, 64, dtype=f32),
          F.softplus(randn(B, S, 48, dtype=f32)),
          -torch.exp(randn(48, dtype=f32)), randn(B, S, 1, 128, dtype=f32),
          randn(B, S, 1, 128, dtype=f32)), {"chunk": 256}, ref.ref_ssd_scan))
    out = {}
    for op, label, inputs, kw, plain in cases:
        where = f"phase 12a {op}, {label}"
        with torch.no_grad():
            want_y = getattr(ops, op)(*inputs, **kw)
        want_y = want_y[0] if isinstance(want_y, tuple) else want_y
        xs = [t.detach().clone().requires_grad_() for t in inputs]
        before = getattr(ops, op).launches
        torch.cuda.synchronize()
        with CallRecorder(ops) as calls:
            y = getattr(ops, op)(*xs, **kw)
        torch.cuda.synchronize()
        launched = getattr(ops, op).launches - before
        y = y[0] if isinstance(y, tuple) else y
        check(launched == 1, f"{where}: the Function's forward launched "
              f"{launched} kernels, want 1")
        check("_PlainBackward" in type(y.grad_fn).__name__,
              f"{where}: output's grad_fn is {y.grad_fn}")
        check(torch.equal(y.detach(), want_y), f"{where}: the Function's "
              f"forward differs from the wrapper's output")
        unheld = calls.signatures - held
        check(not unheld, f"{where}: kernel calls that phase 6 does not "
              f"hold against the plain version: {sorted(unheld)}")
        w = randn(*y.shape, dtype=f32)
        grads = torch.autograd.grad((y.float() * w).sum(), xs)
        ps = [t.detach().clone().requires_grad_() for t in inputs]
        yp = plain(*ps, **kw)
        yp = yp[0] if isinstance(yp, tuple) else yp
        want = torch.autograd.grad((yp.float() * w).sum(), ps)
        diffs = [float((g.float() - wg.float()).abs().max())
                 for g, wg in zip(grads, want)]
        check(all(g.dtype == wg.dtype and torch.equal(g, wg)
                  for g, wg in zip(grads, want)),
              f"{where}: gradients differ from the plain version's "
              f"(max abs {diffs})")
        out[op] = {"label": label, "launches": launched,
                   "grad_max_abs_diff": diffs}
        log(f"{where} ok: forward launched the kernel once, == the wrapper; "
            f"{len(grads)} input gradients == autograd through the plain "
            f"version (max abs diff {diffs}) [{card}]")
        del xs, ps, y, yp, grads, want, want_y
    torch.cuda.empty_cache()
    return out


def phase_train_cli(torch, card: str, held: set) -> dict:
    """Phase 12b: the train CLI (``launch.train.main``, ``--steps 3`` at
    its default ``--batch 8 --seq 64``) on the card for each reduced arch
    whose reference CLI runs, in this process under the call recorder:
    its first line and every step's loss equal to the ``--device cpu``
    run's (losses within ``TRAIN_LOSS_RTOL``), its launches three steps'
    of ``train_launches``, every kernel call held in phase 6.  The
    stub-frontend archs raise there as the reference CLI does."""
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    ckdir = os.path.join(ROOT, "build", "phase12_cli_ckpt")
    out = {}
    t0 = time.perf_counter()
    try:
        for arch in SERVE_ARCHS:
            where = f"phase 12b train CLI {arch}"
            argv = ["--arch", arch, *TRAIN_CLI_ARGS, "--ckpt-dir", ckdir]
            cpu_text, cpu_rep = cli_run(train.main, argv + ["--device",
                                                            "cpu"])
            torch.cuda.synchronize()
            zero_launches(ops)
            with CallRecorder(ops) as calls:
                card_text, rep = cli_run(train.main, argv)
                torch.cuda.synchronize()
            launches = read_launches(ops)
            cfg = get_arch(arch).reduced
            steps = int(TRAIN_CLI_ARGS[1])
            want = {k: steps * v for k, v in train_launches(cfg).items()}
            check(launches == want, f"{where}: launches {launches}, want "
                  f"{want}")
            check(card_text.split("\n")[0] == cpu_text.split("\n")[0],
                  f"{where}: first lines differ:\n{card_text}\nvs\n"
                  f"{cpu_text}")
            got, exp = np.array(rep.losses), np.array(cpu_rep.losses)
            check(got.shape == exp.shape == (steps,)
                  and np.isfinite(got).all(), f"{where}: losses {got}")
            rel = float(np.max(np.abs(got - exp) / np.abs(exp)))
            check(rel <= TRAIN_LOSS_RTOL, f"{where}: card losses {got} vs "
                  f"CPU {exp}: rel {rel:.3g} > {TRAIN_LOSS_RTOL}")
            unheld = calls.signatures - held
            check(not unheld, f"{where}: kernel calls that phase 6 does not "
                  f"hold against the plain version: {sorted(unheld)}")
            out[arch] = {"launches": launches, "loss_rel_err": rel,
                         "losses": rep.losses,
                         "same_text": card_text == cpu_text}
            log(f"{where} ok: card == --device cpu (losses "
                f"{[round(x, 6) for x in rep.losses]}, max rel err "
                f"{rel:.3g}, limit {TRAIN_LOSS_RTOL}; output text "
                f"{'equal' if card_text == cpu_text else 'differs in the last printed digit'}"
                f"), launches {json.dumps(launches)}, "
                f"{len(calls.signatures)} kernel signatures, each held "
                f"[{card}]")
        for arch in ("internvl2-76b", "musicgen-large"):
            try:
                cli_run(train.main, ["--arch", arch, "--steps", "1",
                                     "--ckpt-dir", ckdir])
            except ValueError as exc:
                check("not enough values to unpack" in str(exc),
                      f"phase 12b train CLI {arch}: raised {exc!r}")
            else:
                raise SmokeFailure(f"phase 12b train CLI {arch}: ran; the "
                                   f"reference CLI raises there")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"phase 12b: {len(SERVE_ARCHS)} train CLIs on the card and on the "
        f"CPU in {time.perf_counter() - t0:.2f} s; internvl2-76b and "
        f"musicgen-large raise as the reference CLI does [{card}]")
    return out


class StepProbe:
    """Wraps a train step: the wall ms of each call (synchronised before
    and after), its kernel counts (zeroed just before, read just after),
    the signatures of its kernel calls, and a profiled call when asked
    (``profile_next``)."""

    def __init__(self, torch, ops, step_fn, card: str):
        self.torch, self.ops, self.step_fn = torch, ops, step_fn
        self.card = card
        self.ms, self.launches, self.signatures = [], [], set()
        self.profile_next, self.profiled = None, None

    def __call__(self, state, batch):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        zero_launches(self.ops)
        label, self.profile_next = self.profile_next, None
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if label else None)
        if prof is not None:
            prof.start()
        with CallRecorder(self.ops) as calls:
            t0 = time.perf_counter()
            out = self.step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
            stats = {}
            kernels_us = profile_report(label, prof, 1e6 * wall, self.card,
                                        stats)
            busy = sum(kernels_us.values())
            stats["kernel_share"] = {
                name: (sum(us for k, us in kernels_us.items() if prefix in k)
                       / busy if busy > 0 else None)
                for name, prefix in KERNEL_PREFIX.items()}
            self.profiled = stats
        else:
            self.ms.append(1e3 * wall)
        self.launches.append(read_launches(self.ops))
        self.signatures |= calls.signatures
        return out


class SaveClock:
    """An ``AsyncCheckpointer`` with the seconds of its saves: the host
    copy (``save``) and the serialisation (the ``wait`` that follows)."""

    def __init__(self, ck):
        self.ck, self.copy_s, self.write_s = ck, 0.0, 0.0

    def save(self, *args, **kw):
        t0 = time.perf_counter()
        self.ck.save(*args, **kw)
        self.copy_s += time.perf_counter() - t0

    def wait(self):
        t0 = time.perf_counter()
        self.ck.wait()
        self.write_s += time.perf_counter() - t0


def train_full_width(torch, device, card: str, held: set, label: str,
                     module: str, layers: int, steps: int,
                     main_path: bool) -> dict:
    """Phase 12c for one config at full width, ``layers`` deep, bf16,
    its own remat, B x S = ``TRAIN_SHAPE`` from ``SyntheticLMDataset``:
    ``Trainer.run`` for ``steps`` steps with its final checkpoint (every
    parameter's gradient non-zero on step 1; launches a step
    ``train_launches``; every kernel call held in phase 6), then
    ``maybe_resume`` into a fresh state, equal to the trained one bit for
    bit.  On the main path, ``TRAIN_MORE_STEPS`` more steps from the
    resumed state and from the trained one in memory, under
    ``torch.use_deterministic_algorithms(True)``, equal bit for bit in
    losses and state; one of them profiled.  Otherwise one more step,
    profiled, from the resumed state."""
    import math
    import shutil
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.data import SyntheticLMDataset, make_train_iterator
    from repro_torch.kernels import ops
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.adamw import Optimizer
    from repro_torch.train import make_train_state, make_train_step
    from repro_torch.train.trainer import Trainer
    cfg = arch_config(module, n_layers=layers)
    where = f"phase 12c {label} ({layers} layers)"
    B, S = TRAIN_SHAPE
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=S,
                            global_batch=B, seed=TRAIN_SEED)
    opt = make_optimizer()
    zero_grads = []

    def update(grads, state, params):
        if not zero_grads:       # step 1: every leaf reached, none zero
            zero_grads.append([p for p, g in _flatten_with_paths(grads)
                               if not bool(torch.count_nonzero(g))])
        return opt.update(grads, state, params)

    step_fn, _ = make_train_step(cfg, Optimizer(opt.init, update))
    probe = StepProbe(torch, ops, step_fn, card)
    ckdir = os.path.join(ROOT, "build", f"phase12_{module}_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    res = {"config": cfg.name, "layers": layers, "of_layers":
           arch_config(module).n_layers, "batch": B, "seq": S}
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, probe, ckdir, checkpoint_every=50)
        trainer.ckpt = clock = SaveClock(AsyncCheckpointer(ckdir))
        t0 = time.perf_counter()
        # no reference to the initial state outlives its first step
        trained, rep = trainer.run(
            make_train_state(cfg, TRAIN_SEED, opt, device=device),
            make_train_iterator(ds, device=device), steps)
        run_s = time.perf_counter() - t0
        res["peak_train_bytes"] = torch.cuda.max_memory_allocated()
        check(rep.steps_done == steps and not rep.preempted,
              f"{where}: {rep}")
        check(zero_grads == [[]], f"{where}: leaves with no gradient on "
              f"step 1 (a detached kernel?): {zero_grads}")
        check(np.isfinite(rep.losses).all(), f"{where}: losses {rep.losses}")
        ln_v = math.log(cfg.vocab_size)
        check(0.8 * ln_v <= rep.losses[0] <= 1.2 * ln_v, f"{where}: first "
              f"loss {rep.losses[0]:.4f}, not near ln V = {ln_v:.4f}")
        want = train_launches(cfg)
        check(all(n == want for n in probe.launches), f"{where}: launches "
              f"a step {probe.launches}, want {want}")
        unheld = probe.signatures - held
        check(not unheld, f"{where}: kernel calls that phase 6 does not "
              f"hold against the plain version: {sorted(unheld)}")
        res.update(losses=rep.losses, launches_a_step=want,
                   launches_run={k: steps * v for k, v in want.items()},
                   step_ms=probe.ms, run_s=run_s,
                   save_copy_s=clock.copy_s, save_write_s=clock.write_s)

        fresh = make_train_state(cfg, TRAIN_SEED + 1, opt, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed, start = trainer.maybe_resume(fresh, device=device)
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
        del fresh
        check(start == steps, f"{where}: resumed at step {start}")
        res["leaves"] = same_tree(resumed, trained,
                                  f"{where}: resumed vs trained state")
        if main_path:
            def more_steps(st, profile):
                it = make_train_iterator(ds, start_step=start, device=device)
                losses = []
                for i in range(TRAIN_MORE_STEPS):
                    if profile and i == 0:
                        probe.profile_next = f"{label} train step"
                    st, m = probe(st, next(it))
                    losses.append(float(m["loss"]))
                return st, losses

            torch.use_deterministic_algorithms(True)
            try:
                st_r, loss_r = more_steps(resumed, True)
                del resumed
                st_s, loss_s = more_steps(trained, False)
                del trained
            finally:
                torch.use_deterministic_algorithms(False)
            check(loss_r == loss_s, f"{where}: losses after the resume "
                  f"{loss_r} vs straight {loss_s}")
            same_tree(st_r, st_s, f"{where}: {TRAIN_MORE_STEPS} steps after "
                      f"the resume vs straight")
            res["more_losses"] = loss_r
            del st_r, st_s
        else:
            del trained
            probe.profile_next = f"{label} train step"
            probe(resumed, next(make_train_iterator(ds, start_step=start,
                                                    device=device)))
            del resumed
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["idle_share"] = probe.profiled.get("idle_share")
        res["kernel_share"] = probe.profiled["kernel_share"]
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
    timed = probe.ms[1:steps] or probe.ms[:1]   # past the first step
    res["ms"] = float(np.mean(timed))
    res["tokens_per_s"] = B * S / (res["ms"] / 1e3)
    log(f"{where}" + (f" [depth cut: {layers} of {res['of_layers']} "
                      f"layers]" if layers < res["of_layers"] else "")
        + f" ok: {steps} Trainer steps, losses "
        f"{[round(x, 5) for x in rep.losses]}; every one of "
        f"{res['leaves']} leaves' gradients non-zero on step 1; resumed "
        f"state == trained bit for bit"
        + (f"; {TRAIN_MORE_STEPS} steps after the resume == straight bit "
           f"for bit (losses {res['more_losses']}, deterministic mode)"
           if main_path else "")
        + f"; {res['ms']:.2f} ms a step (steps {[round(x, 2) for x in probe.ms]}"
        f" ms), {res['tokens_per_s']:.1f} tokens/s, peak "
        f"{res['peak_train_bytes'] / 2 ** 30:.3f} GiB over the Trainer run "
        f"({res['peak_bytes'] / 2 ** 30:.3f} GiB over the phase), launches "
        f"a step "
        f"{json.dumps(want)}, idle share {res['idle_share']}, kernel share "
        f"{json.dumps(res['kernel_share'])}, checkpoint save "
        f"{res['save_copy_s']:.2f} s host copy + {res['save_write_s']:.2f} s "
        f"write, load {res['load_s']:.2f} s [{card}]")
    return res


def system_story(torch, device, ckdir: str) -> dict:
    """``tests/test_system.py``'s story on ``device``: a critical serving
    engine beside a preemptible trainer; the orchestrator's eviction hook
    preempts the trainer and enters failover; requests served through the
    failover; the trainer resumed from its checkpoint for 3 steps;
    failback.  Returns its verdicts and the trainer's losses."""
    from repro_torch.core.capacity import RegionCapacity
    from repro_torch.core.drills import remediate
    from repro_torch.core.omg import Orchestrator
    from repro_torch.core.service import synthesize_fleet, unsafe_edges
    from repro_torch.core.tiers import Tier
    from repro_torch.data import SyntheticLMDataset, make_train_iterator
    from repro_torch.models import LMConfig, init_params
    from repro_torch.serving import Request, ServingEngine, TieredScheduler
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.trainer import Trainer
    cfg = LMConfig(name="sys", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_head=16, d_ff=128, vocab_size=128,
                   tie_embeddings=True)
    fleet = synthesize_fleet(scale=0.02, seed=4)
    remediate(fleet, set(unsafe_edges(fleet)))
    region = RegionCapacity.for_fleet("r", fleet)
    step_fn, opt = make_train_step(cfg, n_loss_chunks=2)

    def state(seed):
        """Weights drawn on the CPU (a generator on the card draws other
        numbers), moved to ``device``: card and CPU runs hold the same."""
        p = to_device(init_params(cfg, seed, device="cpu"), device)
        return TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=device))

    engine = ServingEngine(cfg, state(TRAIN_SEED).params, max_batch=4,
                           max_seq=48)
    sched = TieredScheduler({"e": engine})
    ds = SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4,
                            seed=1)
    events = {"evicted": 0, "restored": 0}
    trainer = Trainer(cfg, step_fn, ckdir, checkpoint_every=2)
    tstate, rep0 = trainer.run(state(TRAIN_SEED), make_train_iterator(
        ds, device=device), 4)

    def on_evict(spec):
        events["evicted"] += 1
        if events["evicted"] == 1:
            trainer.request_preempt()
            sched.enter_failover()

    def on_restore(spec):
        events["restored"] += 1

    orch = Orchestrator(fleet, region, scale=0.02, on_evict=on_evict,
                        on_restore=on_restore)
    report = orch.failover(tv_failover=1.0)
    rng = np.random.default_rng(0)
    for i in range(12):
        sched.submit(Request(i, tier=Tier(i % 6),
                             prompt=list(rng.integers(0, 128, 8)),
                             max_new_tokens=2))
    for _ in range(40):
        sched.tick()
    v = {"mode": report.mode, "always_on_ok": bool(report.always_on_ok),
         "rl_rto_met": bool(report.rl_rto_met), **events,
         "t1_availability": engine.availability(Tier.T1),
         "served": {t.name: engine.counters["served"][t] for t in Tier},
         "rejected": {t.name: engine.counters["rejected"][t] for t in Tier},
         "tokens_decoded": engine.tokens_decoded,
         "steps_before": rep0.steps_done}
    sched.exit_failover()
    t2, start = trainer.maybe_resume(state(TRAIN_SEED + 7), device=device)
    v["resumed_at"] = start
    v["resumed_embed_equal"] = bool(torch.equal(t2.params["embed"],
                                                tstate.params["embed"]))
    trainer._preempt_requested = False
    t2, rep2 = trainer.run(t2, make_train_iterator(ds, start_step=start,
                                                   device=device),
                           3, start_step=start)
    v["steps_after"] = rep2.steps_done
    orch.failback()
    v["all_steady"] = all(s.placement == "steady" for s in orch.se.values())
    return {"verdicts": v, "losses": rep0.losses + rep2.losses}


def phase_system(torch, device, card: str, held: set) -> dict:
    """Phase 12d: the paper's story (``system_story``) on the card, its
    kernels counted and every call held in phase 6, with the reference
    test's contracts, its verdicts equal to the same run on the CPU and
    the trainer's losses within ``TRAIN_LOSS_RTOL``."""
    import shutil
    from repro_torch.core.tiers import Tier
    from repro_torch.kernels import ops
    base = os.path.join(ROOT, "build", "phase12_story")
    shutil.rmtree(base, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        cpu = system_story(torch, "cpu", os.path.join(base, "cpu"))
        cpu_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        zero_launches(ops)
        t0 = time.perf_counter()
        with CallRecorder(ops) as calls:
            card_run = system_story(torch, device,
                                    os.path.join(base, "card"))
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = read_launches(ops)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    v = card_run["verdicts"]
    where = "phase 12d system story"
    check(v["mode"] == "peak" and v["always_on_ok"] and v["rl_rto_met"]
          and v["evicted"] > 0 and v["restored"] > 0
          and v["t1_availability"] == 1.0 and v["served"][Tier.T5.name] == 0
          and v["resumed_at"] >= 4 and v["resumed_embed_equal"]
          and v["steps_after"] == 3 and v["all_steady"],
          f"{where}: the reference test's contracts fail on the card: {v}")
    check(v == cpu["verdicts"], f"{where}: card verdicts {v} vs CPU "
          f"{cpu['verdicts']}")
    got, exp = np.array(card_run["losses"]), np.array(cpu["losses"])
    rel = float(np.max(np.abs(got - exp) / np.abs(exp)))
    check(got.shape == exp.shape and rel <= TRAIN_LOSS_RTOL,
          f"{where}: card losses {got} vs CPU {exp} (rel {rel:.3g})")
    check(launches["rmsnorm"] > 0 and launches["flash_attention"] > 0
          and launches["decode_attention"] > 0, f"{where}: launches "
          f"{launches}")
    unheld = calls.signatures - held
    check(not unheld, f"{where}: kernel calls that phase 6 does not hold "
          f"against the plain version: {sorted(unheld)}")
    log(f"{where} ok: card verdicts == CPU's ({json.dumps(v)}), losses "
        f"within {rel:.3g} (limit {TRAIN_LOSS_RTOL}), launches "
        f"{json.dumps(launches)}, {len(calls.signatures)} kernel "
        f"signatures, each held; card {card_s:.2f} s, CPU {cpu_s:.2f} s "
        f"[{card}]")
    return {"verdicts": v, "launches": launches, "loss_rel_err": rel,
            "card_s": card_s}


def phase_training(torch, device, card: str, held: set) -> dict:
    """Phase 12: the training path on the card, weights and inputs from
    seed 28: (a) the kernels' autograd wiring, (b) the train CLI card ==
    CPU for the reduced archs, (c) qwen3-1.7b (the main path),
    mamba2-780m and phi3.5-moe at full width through ``Trainer`` with
    checkpoint and resume, (d) the paper's preempt-and-restore story."""
    log(f"phase 12: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
        f"allocated on the card by the earlier phases")
    seconds = {}
    t0 = time.perf_counter()
    out = {"autograd": phase_autograd(torch, device, card, held)}
    seconds["autograd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"] = phase_train_cli(torch, card, held)
    seconds["cli"] = time.perf_counter() - t0
    out["full"] = {}
    for i, (label, module, layers, steps) in enumerate(TRAIN_FULL):
        t0 = time.perf_counter()
        out["full"][label] = train_full_width(torch, device, card, held,
                                              label, module, layers, steps,
                                              main_path=i == 0)
        seconds[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["system"] = phase_system(torch, device, card, held)
    seconds["system"] = time.perf_counter() - t0
    out["seconds"] = seconds
    log(f"phase 12 seconds by part: {json.dumps(seconds)}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the mesh path over torch.distributed, the dry run and roofline
# ---------------------------------------------------------------------------

MESH_SEED = 29              # phase 13's weights and tokens
MESH_DECODE = (8, 8, 4352)  # phase 13a/b decode: batch, steps, cache slots
SPLITKV_STEPS = 4           # 13b: the first steps of 13a's decode tokens
SPLITKV_RANKS = 4           # phase 13b: the (1, 4) split-KV mesh
# 13b decodes after a prefill of this many tokens: past 3 x 1,088 slots,
# so each rank's block of the 4,352-slot caches holds live keys
SPLITKV_PREFILL = 4096
SPLITKV_STATE = os.path.join(ROOT, "build", "phase13b_state.pt")
PROBE_WORLDS = ((2, "nccl"), (4, "nccl"), (2, "gloo"), (4, "gloo"))
PROBE_OPS = ("all_reduce", "all_gather", "all_to_all", "send_recv")
PROBE_TIMEOUT_S = 240
# phase 13c: one arch a family for the in-phase dry run (the full table
# of ten archs x four shapes is launch/dryrun.py --all's)
DRYRUN_ARCHS = ("llama3.2-3b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                "hymba-1.5b", "internvl2-76b", "musicgen-large")
DRYRUN_WORKERS = 6          # its cells run beside 13b, in their own processes
# 13b's limit: SPLITKV_MARGIN x the distance from the one-rank B5 decode
# of the same decode with B5's plain version (a float32 softmax over the
# whole cache, rounded to bf16 as split-KV's merge is), measured on the
# same caches and tokens: the rounding two right answers differ by
SPLITKV_MARGIN = 2.0


def _probe_rank(rank: int, world: int, backend: str, store: str,
                out: str, splitkv: bool, device: str = "cuda") -> None:
    """One process of a 13b world on the card: each collective tried and
    written down as it finishes (send/recv last: gloo with CUDA tensors
    can end the process there); with ``splitkv``, llama3.2-3b's split-KV
    decode on a (1, world) mesh after the collectives it needs."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    res = {}

    def save():
        with open(f"{out}.{rank}.json", "w") as fh:
            json.dump(res, fh)

    try:
        from repro_torch.launch.mesh import init_world
        dev = init_world(store, rank, world, device, backend=backend,
                         timeout_s=60)
    except Exception as exc:
        res["init"] = f"{type(exc).__name__}: {str(exc)[:200]}"
        save()
        os._exit(0)

    def attempt(name, fn):
        try:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as exc:
            res[name] = f"{type(exc).__name__}: {str(exc)[:300]}"
        save()

    def all_reduce():
        for op, want in ((dist.ReduceOp.SUM, world * (world + 1) / 2),
                         (dist.ReduceOp.MAX, world)):
            x = torch.full((8,), float(rank + 1), device=dev)
            dist.all_reduce(x, op=op)
            assert float(x[0]) == want, (op, float(x[0]))

    def all_gather():
        x = torch.full((4,), float(rank), device=dev)
        o = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(o, x)
        assert o.view(world, 4)[:, 0].tolist() == [float(r) for r in
                                                     range(world)]

    def all_to_all():
        x = torch.arange(world, device=dev, dtype=torch.float32) + 10 * rank
        o = torch.empty_like(x)
        dist.all_to_all_single(o, x)
        assert o.tolist() == [float(10 * r + rank) for r in range(world)]

    def send_recv():
        x = torch.full((4,), float(rank), device=dev)
        if rank == 0:
            dist.send(x, 1)
        elif rank == 1:
            dist.recv(x, 0)
            assert float(x[0]) == 0.0

    attempt("all_reduce", all_reduce)
    attempt("all_gather", all_gather)
    attempt("all_to_all", all_to_all)
    if splitkv and res["all_reduce"] == "ok":
        try:
            res["splitkv"] = _splitkv_rank(torch, dev, world, out, rank)
        except Exception as exc:
            res["splitkv"] = f"{type(exc).__name__}: {str(exc)[:300]}"
        save()
    attempt("send_recv", send_recv)
    os._exit(0)


def _splitkv_rank(torch, dev, world: int, out: str, rank: int) -> dict:
    """llama3.2-3b at full width (28 layers, bf16): SPLITKV_STEPS decode
    steps from the caches 13a filled (SPLITKV_STATE), their sequence
    split over a (1, world) mesh; rank 0 writes its logits."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.ctx import sharding_rules
    from repro_torch.dist.smap import put
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import DecodeState, decode_step, init_params
    cfg = arch_config("llama3_2_3b")
    B, steps, slots = MESH_DECODE
    params = init_params(cfg, MESH_SEED, device=dev)
    toks = torch.from_numpy(host_tokens(cfg, B, steps, MESH_SEED + 1)).to(dev)
    mesh = make_local_mesh(1, world, device=dev)
    # the whole caches stay on the host (mapped from the file): only the
    # rank's block of the sequence reaches the card (four ranks share it)
    whole = DecodeState(*torch.load(SPLITKV_STATE, mmap=True))
    check(tuple(whole.k_cache.shape[1:3]) == (B, slots),
          f"13b: caches {tuple(whole.k_cache.shape)}")
    state = put(whole, shd.decode_state_shardings(cfg, mesh, B), mesh)
    state = type(state)(*(t.to(dev) for t in state))
    ops.decode_attention.launches = 0
    logits = []
    t0 = time.perf_counter()
    with torch.no_grad(), sharding_rules(mesh, param_layout="whole"):
        for t in range(SPLITKV_STEPS):
            lg, state = decode_step(params, cfg, state, toks[:, t])
            logits.append(lg.float())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rank == 0:
        torch.save(torch.stack(logits).cpu(), f"{out}.splitkv.pt")
    return {"cache_block": list(state.k_cache.shape),
            "first_slot": rank * state.k_cache.shape[2],
            "b5_launches": ops.decode_attention.launches,
            "ms_a_step": wall / SPLITKV_STEPS * 1e3}


def splitkv_inputs(torch, ops, params, cfg, device, dtoks, calls) -> dict:
    """13b's caches and references, on this process's one rank:
    MESH_DECODE's caches holding the K and V of a SPLITKV_PREFILL-token
    prefill (as B6 receives them, before their repeat to the query
    heads), saved to SPLITKV_STATE for the ranks; then SPLITKV_STEPS
    decode steps from them with B5 (the reference, its calls recorded),
    with B5's plain version (the control the limit is set from) and with
    the plain version blind to the last rank's block (a merge that
    dropped that rank's partial)."""
    from repro_torch.kernels.ref import ref_decode_attention
    from repro_torch.models import decode_step, forward, init_decode_state
    B, _, slots = MESH_DECODE
    L0 = SPLITKV_PREFILL
    group = cfg.n_heads // cfg.n_kv_heads
    state = init_decode_state(cfg, B, slots, torch.bfloat16, length=L0,
                              device=device)
    layer = iter(range(cfg.n_layers))
    b6 = ops.flash_attention

    def capture(q, k, v, **kw):
        i = next(layer)
        state.k_cache[i, :, :L0] = k[:, :, ::group]
        state.v_cache[i, :, :L0] = v[:, :, ::group]
        return b6(q, k, v, **kw)

    toks = torch.from_numpy(host_tokens(cfg, B, L0, MESH_SEED + 3))
    with torch.no_grad(), OpSwap(ops, "flash_attention", capture):
        forward(params, cfg, toks.to(device))
    check(next(layer, None) is None, "13b: the prefill skipped a layer")
    torch.save(tuple(t.cpu() for t in state), SPLITKV_STATE)
    cut = (SPLITKV_RANKS - 1) * slots // SPLITKV_RANKS

    def dropped(q, k_cache, v_cache, length, window):
        return ref_decode_attention(q, k_cache[:, :cut], v_cache[:, :cut],
                                    torch.clamp(length, max=cut), window)

    def decode(attention):
        st = state._replace(k_cache=state.k_cache.clone(),
                            v_cache=state.v_cache.clone())
        lgs = []
        with torch.no_grad(), OpSwap(ops, "decode_attention", attention):
            for t in range(SPLITKV_STEPS):
                lg, st = decode_step(params, cfg, st, dtoks[:, t])
                lgs.append(lg.float())
        return torch.stack(lgs).cpu()

    with calls:
        ref = decode(ops.decode_attention)
    plain = decode(ref_decode_attention)
    drop = decode(dropped)
    return {"ref": ref, "plain_err": float((plain - ref).abs().max()),
            "drop_err": float((drop - ref).abs().max())}


def _dryrun_cell(cell: tuple) -> tuple:
    """One 13c dry-run cell in a worker process (the meta device only)."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import dryrun
    arch_id, shape = cell
    r = dryrun.run_cell(arch_id, shape, "single", force=True)
    return arch_id, shape, r["status"], r.get("error"), r.get("trace_s")


def start_dryrun(shapes) -> tuple:
    """13c's dry-run cells on a pool of worker processes, the train cells
    (the longest: the plain SSD backward's chunk loop) first; returns
    (pool, pending result)."""
    import multiprocessing as mp
    cells = sorted(((a, s) for a in DRYRUN_ARCHS for s in shapes),
                   key=lambda c: c[1] != "train_4k")
    pool = mp.get_context("spawn").Pool(DRYRUN_WORKERS)
    return pool, pool.map_async(_dryrun_cell, cells, chunksize=1)


def probe_worlds(torch, card: str, device: str = "cuda") -> tuple:
    """13b: every PROBE_WORLDS world started at once (processes sharing
    the one card, a FileStore rendezvous each); the 4-rank gloo world
    also runs the split-KV decode.  Returns (results by world, the
    split-KV logits or None)."""
    import multiprocessing as mp
    import shutil
    ctx = mp.get_context("spawn")
    base = os.path.join(ROOT, "build", "phase13b")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    procs, names = [], []
    for world, backend in PROBE_WORLDS:
        name = f"{backend}{world}"
        names.append((name, world))
        out = os.path.join(base, name)
        for r in range(world):
            p = ctx.Process(target=_probe_rank, args=(
                r, world, backend, out + ".store", out,
                backend == "gloo" and world == SPLITKV_RANKS, device))
            p.start()
            procs.append(p)
    deadline = time.monotonic() + PROBE_TIMEOUT_S
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        time.sleep(0.2)
    stuck = sum(p.is_alive() for p in procs)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    results = {}
    for name, world in names:
        results[name] = {}
        for r in range(world):
            path = os.path.join(base, f"{name}.{r}.json")
            results[name][r] = (json.load(open(path)) if os.path.exists(path)
                                else {"process": "ended before writing"})
    sk = os.path.join(base, f"gloo{SPLITKV_RANKS}.splitkv.pt")
    logits = torch.load(sk) if os.path.exists(sk) else None
    return results, logits, stuck


def _verdict(world_res: dict, op: str) -> str:
    """"ran" when every rank ran ``op``; else the first refusal's words
    (the message's end, where NCCL names the reason), or that the
    process ended inside the op."""
    vals = [r.get(op, r.get("init", r.get(
        "process", "the process ended inside it"))) for r in
        world_res.values()]
    if all(v == "ok" for v in vals):
        return "ran"
    bad = next(v for v in vals if v != "ok")
    return "refused: " + bad.splitlines()[0][-90:]


def phase_mesh(torch, device, card: str, held: set, agg, tl_cfg, graph,
               grid: dict, sweep_res: dict) -> dict:
    """Phase 13: (a) a live 1 x 1 NCCL mesh on the card: llama3.2-3b's
    prefill and decode, phi3.5-moe's expert-parallel prefill, one
    qwen3-1.7b train step and the 65,536-scenario sweep each bit-equal to
    their runs without a mesh; (b) which backend lets 2 and 4 processes
    share the card, and split-KV decode where one does; (c) the dry run
    on meta over the (16, 16) mesh, the roofline table, and the cost
    recorder's FLOPs of two real runs == their meta runs, with their
    shares of peak."""
    import shutil
    import torch.distributed as dist
    from repro_torch.core.sweep_engine import SweepEngine
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.dist.ctx import sharding_rules
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import (HBM_BYTES, PEAK_FLOPS_BF16,
                                         init_world, make_abstract_mesh,
                                         make_local_mesh, make_world_mesh)
    from repro_torch.models import (MoEParallel, decode_step, forward,
                                    init_abstract, init_decode_state,
                                    init_params, logits_fn)
    from repro_torch.obs.cost import CostRecorder
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (make_prefill_step, make_train_state,
                                   make_train_state_abstract,
                                   make_train_step)
    out = {"seconds": {}}
    t_phase = time.perf_counter()
    store = os.path.join(ROOT, "build", "phase13a.store")
    shutil.rmtree(store, ignore_errors=True)
    if os.path.exists(store):
        os.remove(store)
    init_world(store, 0, 1, device.type)
    pool = None
    try:
        mesh = make_local_mesh(1, 1, device=device)
        check(mesh.live and mesh.size == 1, f"13a: {mesh}")
        calls = CallRecorder(ops)

        # 13a: llama3.2-3b at full width, prefill logits and decode
        t0 = time.perf_counter()
        cfg = arch_config("llama3_2_3b")
        params = init_params(cfg, MESH_SEED, device=device)
        B, S = PREFILL_SHAPE
        toks = torch.from_numpy(host_tokens(cfg, B, S, MESH_SEED)).to(device)
        with torch.no_grad(), calls:
            plain = logits_fn(params, cfg, forward(params, cfg, toks)[0])
            with sharding_rules(mesh):
                meshed = logits_fn(params, cfg, forward(params, cfg, toks)[0])
        check(torch.equal(plain, meshed), "13a: llama3.2-3b prefill logits "
              "under a 1 x 1 mesh differ from the run without one")
        del plain, meshed
        Bd, steps, slots = MESH_DECODE
        dtoks = torch.from_numpy(host_tokens(cfg, Bd, steps,
                                             MESH_SEED + 1)).to(device)

        def decode(rules):
            st = init_decode_state(cfg, Bd, slots, torch.bfloat16,
                                   device=device)
            lgs = []
            with torch.no_grad(), calls:
                for t in range(steps):
                    if rules:
                        with sharding_rules(mesh):
                            lg, st = decode_step(params, cfg, st, dtoks[:, t])
                    else:
                        lg, st = decode_step(params, cfg, st, dtoks[:, t])
                    lgs.append(lg)
            return torch.stack(lgs)

        d_plain, d_mesh = decode(False), decode(True)
        check(torch.equal(d_plain, d_mesh), "13a: llama3.2-3b decode logits "
              "under a 1 x 1 mesh differ")
        del d_plain, d_mesh
        sk_in = splitkv_inputs(torch, ops, params, cfg, device, dtoks, calls)
        out["seconds"]["13a llama"] = time.perf_counter() - t0

        # 13a: phi3.5-moe, expert-parallel dispatch against auto
        t0 = time.perf_counter()
        cfg_phi = arch_config("phi3_5_moe_42b_a6_6b", n_layers=2)
        p_phi = init_params(cfg_phi, MESH_SEED, device=device)
        ptoks = torch.from_numpy(host_tokens(cfg_phi, B, S,
                                             MESH_SEED + 2)).to(device)
        with torch.no_grad(), calls:
            h_auto, aux_auto = forward(p_phi, cfg_phi, ptoks, MoEParallel())
            h_sm, aux_sm = forward(p_phi, cfg_phi, ptoks, MoEParallel(
                mode="shard_map", fsdp_axes=("data",), mesh=mesh))
        check(torch.equal(h_auto, h_sm) and torch.equal(aux_auto, aux_sm),
              "13a: phi3.5-moe shard_map on a 1 x 1 mesh differs from auto")
        del p_phi, h_auto, h_sm
        out["seconds"]["13a phi"] = time.perf_counter() - t0

        # 13a: one qwen3-1.7b train step at phase 12c's shape
        t0 = time.perf_counter()
        cfg_q = arch_config("qwen3_1_7b")
        opt = make_optimizer()
        step, _ = make_train_step(cfg_q, opt)
        Bt, St = TRAIN_SHAPE
        ds = SyntheticLMDataset(vocab_size=cfg_q.vocab_size, seq_len=St,
                                global_batch=Bt, seed=MESH_SEED)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch(0).items()}
        state = make_train_state(cfg_q, MESH_SEED, opt, device=device)
        torch.use_deterministic_algorithms(True)
        try:
            with calls:
                st1, m1 = step(state, batch)
                with sharding_rules(mesh):
                    st2, m2 = step(state, batch)
        finally:
            torch.use_deterministic_algorithms(False)
        check(all(torch.equal(m1[k], m2[k]) for k in m1),
              f"13a: qwen3-1.7b step metrics differ: "
              f"{ {k: (float(m1[k]), float(m2[k])) for k in m1} }")
        leaves = same_tree(st2, st1, "13a: qwen3-1.7b train step under a "
                           "1 x 1 mesh")
        loss = float(m1["loss"])
        del st1, st2
        out["seconds"]["13a qwen3 step"] = time.perf_counter() - t0

        # 13a: the paper-scale sweep over a ("scenarios",) mesh of one
        t0 = time.perf_counter()
        smesh = make_world_mesh((1,), ("scenarios",), device=device)
        eng = SweepEngine(agg, tl_cfg, graph=graph, seed=0, device=device,
                          mesh=smesh)
        check(eng._shard_for((16, 4096)), "13a: an explicit mesh must shard")
        res = eng.run(grid)
        for k in sweep_res:
            check(np.array_equal(res[k], sweep_res[k], equal_nan=True),
                  f"13a: sweep {k} under a mesh differs from phase 3")
        out["seconds"]["13a sweep"] = time.perf_counter() - t0
        unheld = calls.signatures - held
        check(not unheld, f"13a: kernel calls that phase 6 does not hold "
              f"against the plain version: {sorted(unheld)}")
        log(f"phase 13a ok: 1 x 1 NCCL mesh == no mesh bit for bit: "
            f"llama3.2-3b prefill logits ({B} x {S}) and {steps} decode "
            f"steps at B {Bd}, phi3.5-moe (2 layers) shard_map == auto, "
            f"qwen3-1.7b train step ({leaves} leaves, loss {loss:.6f}), "
            f"the {len(grid['traffic_mult'])}-scenario sweep == phase 3 "
            f"({len(sweep_res)} keys) [{card}]")

        # 13c: the two real runs, each timed on a quiet host for its share
        # of peak (the dry run and the probe worlds have not started)
        t0 = time.perf_counter()
        abstract = make_abstract_mesh((1, 1))
        prefill = make_prefill_step(cfg)
        meta_toks = torch.empty((B, S), dtype=torch.int64, device="meta")
        meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                      for k, v in batch.items()}
        runs = {"llama3.2-3b prefill": (
                    lambda: prefill(init_abstract(cfg), meta_toks),
                    lambda: prefill(params, toks),
                    roofline.step_flops(cfg, "prefill", B, S)),
                "qwen3-1.7b train step": (
                    lambda: step(make_train_state_abstract(cfg_q, opt),
                                 meta_batch),
                    lambda: step(state, batch),
                    roofline.step_flops(cfg_q, "train", Bt, St))}
        shares = {}
        for label, (_, on_card, mf) in runs.items():
            ms = device_ms(torch, on_card, 3, warmup=1)
            shares[label] = {"model_flops": mf, "ms": ms}
        out["seconds"]["13c timing"] = time.perf_counter() - t0

        # 13c's dry run starts now, in worker processes on the host's
        # cores, beside the recorder runs and 13b
        from repro_torch.configs import SHAPES
        t_dry = time.perf_counter()
        pool, pending = start_dryrun(list(SHAPES))

        # 13c: the recorder on the card == on meta
        t0 = time.perf_counter()
        for label, (on_meta, on_card, mf) in runs.items():
            with CostRecorder() as rec_meta, sharding_rules(abstract):
                on_meta()
            with CostRecorder() as rec_card, sharding_rules(mesh):
                on_card()
            check(rec_meta.flops == rec_card.flops, f"13c: {label} FLOPs "
                  f"on meta {rec_meta.flops} != on the card "
                  f"{rec_card.flops}")
            ms = shares[label]["ms"]
            shares[label].update(
                flops=rec_card.flops,
                share_of_peak=mf / (ms / 1e3 * PEAK_FLOPS_BF16),
                counted_share=rec_card.flops / (ms / 1e3 * PEAK_FLOPS_BF16))
        if device.type == "cuda":
            check(HBM_BYTES == torch.cuda.get_device_properties(
                device).total_memory, "13c: launch.mesh.HBM_BYTES is not "
                  "this card's total memory")
        del params, state, runs
        out["shares"] = shares
        out["seconds"]["13c recorder"] = time.perf_counter() - t0

        # 13b: processes sharing the card, this process's cached and
        # cycle-held memory given back first
        t0 = time.perf_counter()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            log(f"phase 13b: this process holds "
                f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
                f"({torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB "
                f"reserved) as the probe worlds start")
        probed, sk_logits, stuck = probe_worlds(torch, card, device.type)
        line = {name: {op: _verdict(r, op) for op in PROBE_OPS}
                for name, r in probed.items()}
        log(f"phase 13b probe (2 and 4 processes on one card; "
            f"{stuck} killed at the {PROBE_TIMEOUT_S} s limit): "
            + json.dumps(line))
        gloo4 = probed[f"gloo{SPLITKV_RANKS}"]
        sk = [r.get("splitkv") for r in gloo4.values()]
        allowed = line[f"gloo{SPLITKV_RANKS}"]["all_reduce"] == "ran"
        out["probe"] = line
        if allowed:
            check(sk_logits is not None and all(isinstance(x, dict)
                                                for x in sk),
                  f"13b: split-KV decode did not run: {sk}")
            check(all(x["b5_launches"] == 0 for x in sk),
                  f"13b: the split-KV path launched B5: {sk}")
            ref = sk_in["ref"]
            scale = float(ref.abs().max())
            err = float((sk_logits - ref).abs().max())
            limit = SPLITKV_MARGIN * sk_in["plain_err"]
            check(sk_in["drop_err"] > limit, f"13b: the limit {limit:.4g} "
                  f"passes a merge that drops the last rank's keys "
                  f"({sk_in['drop_err']:.4g})")
            check(err <= limit, f"13b: split-KV logits differ by {err:.4g}, "
                  f"limit {limit:.4g}")
            out["splitkv"] = {"max_abs_err": err, "limit": limit,
                              "plain_err": sk_in["plain_err"],
                              "drop_err": sk_in["drop_err"],
                              "max_logit": scale, "ranks": sk}
            log(f"phase 13b ok: llama3.2-3b split-KV decode on a (1, "
                f"{SPLITKV_RANKS}) gloo mesh of {SPLITKV_RANKS} processes "
                f"on the card, {SPLITKV_STEPS} steps at B {Bd} from "
                f"{SPLITKV_PREFILL} cached tokens, cache block "
                f"{sk[0]['cache_block']} (first slots "
                f"{[x['first_slot'] for x in sk]}, all live): max |logit - "
                f"one-rank B5 logit| {err:.6g} of max|logit| {scale:.6g}; "
                f"limit {SPLITKV_MARGIN} x {sk_in['plain_err']:.6g} (B5's "
                f"plain version against B5) = {limit:.6g}; the last rank's "
                f"keys dropped: {sk_in['drop_err']:.6g}; "
                f"{sk[0]['ms_a_step']:.1f} ms a step on rank 0 [{card}]")
        else:
            log("phase 13b: no backend ran all_reduce for processes sharing "
                "the card; split-KV decode across ranks waits for a "
                "multi-GPU machine")
        if os.path.exists(SPLITKV_STATE):
            os.remove(SPLITKV_STATE)
        out["seconds"]["13b"] = time.perf_counter() - t0

        # 13c: the dry run on meta over the (16, 16) mesh, the roofline
        done = pending.get(timeout=PROBE_TIMEOUT_S)
        pool.close()
        pool.join()
        pool = None
        cells = {}
        for arch_id, shape, status, error, trace_s in done:
            cells[(arch_id, shape)] = status
            check(status == "ok" or (status == "skipped"
                                     and shape == "long_500k"),
                  f"13c: dry run {arch_id} {shape}: {error or status}")
        rows = [r for r in roofline.analyze("single")
                if r["arch"] in DRYRUN_ARCHS]
        for line_md in roofline.to_markdown(rows).splitlines():
            log(f"roofline | {line_md}")
        log("13c dry-run trace seconds: " + json.dumps(
            {f"{a} {s}": t for a, s, _, _, t in done}))
        out["seconds"]["13c dry run (from its start)"] = \
            time.perf_counter() - t_dry

        log("phase 13c ok: " + ", ".join(
            f"{k}: FLOPs meta == card {v['flops']:.6e}, {v['ms']:.3f} ms, "
            f"model FLOPs {v['model_flops']:.6e} = {v['share_of_peak']:.4f} "
            f"of peak (counted {v['counted_share']:.4f})"
            for k, v in shares.items()) + f"; dry run "
            f"{sum(s == 'ok' for s in cells.values())} ok, "
            f"{sum(s == 'skipped' for s in cells.values())} skipped [{card}]")

    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
        dist.destroy_process_group()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 13 seconds by part: {json.dumps(out['seconds'])}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the last four configs at full width, the request campaign
# ---------------------------------------------------------------------------

MODEL14_SEED = 30           # phase 14's weights and inputs, one seed a config
# (a) and (b) for the dense configs, float32, from one init of 2 layers on
# the card: (module, (a) layers, batch, sequence, (b) batch, sequence).
# (a) holds the first layers' forward card vs CPU at phase 10a's
# tolerance, (b) both layers' teacher-forced decode against the forward
MODEL14_DENSE = (("musicgen_large", 2, 1, 512, 2, 256),
                 ("internvl2_76b", 1, 1, 256, 1, 128),
                 ("command_r_plus_104b", 1, 1, 256, 1, 128))
MODEL14_FP32_LAYERS = 2
# (c) bf16 at the published widths: (label, module, layers, decode at
# DECODE_BATCH against cache_seq_len(4,096) slots).  The depth cut only
# where one card forces it: internvl2-76b 16 of 80 layers (1.71 GB a
# layer), command-r-plus-104b 8 of 64 (3.15 GB a layer beside 12.6 GB of
# embeddings and head), kimi-k2 1 of 61 (33.8 GB of expert slabs a layer)
MODEL14_BF16 = (("musicgen-large", "musicgen_large", 48, True),
                ("internvl2-76b", "internvl2_76b", 16, True),
                ("command-r-plus-104b", "command_r_plus_104b", 8, True),
                ("kimi-k2", "kimi_k2_1t_a32b", 1, False))
# (a) for kimi-k2 in bf16 on both sides (its float32 layer, 67.6 GB, does
# not fit beside its embeddings): batch x sequence, and the limit as a
# multiple of a control measured in the same run (the card's run through
# the kernels' plain versions against the CPU run)
KIMI_CARD_CPU = (1, 256)
KIMI_CONTROL_MARGIN = 2.0
# the rows that (a) must hold for kimi-k2: near ties leave the held rows,
# so a fault before the router, which raises the drift that excuses a
# swap, must not empty them.  At least this many of the 256 tokens held
# (233 on an H100 80GB HBM3 at 700 W), and the kernels' swapped tokens at
# most KIMI_CONTROL_MARGIN times the control's (17 against 16 there)
KIMI_MIN_HELD = 200
# the request campaign's small spec (tests/test_torch_serving_campaign.py)
CAMPAIGN_SPEC = {"horizon_s": 7200.0, "n_steps": 48, "ticks_per_step": 4,
                 "crit_rps": 0.03, "pre_rps": 0.02, "max_new_tokens": 2,
                 "seed": 11}


def bf16_launches(cfg) -> dict:
    """The model kernels one bf16 prefill of ``cfg`` launches: B6 a layer,
    B7 three times a MoE layer, B4 twice a layer and once more."""
    n = cfg.n_layers
    return {**dict.fromkeys(KERNEL_PREFIX, 0), "flash_attention": n,
            "grouped_matmul": 3 * n if cfg.is_moe else 0,
            "rmsnorm": 2 * n + 1}


def dense_holds(torch, device, module: str, seed: int, card: str) -> dict:
    """Phase 14a and 14b for a dense config: float32 weights of
    ``MODEL14_FP32_LAYERS`` layers drawn once on the card; (b) their
    teacher-forced decode against their forward, then (a) the forward of
    the first layers card vs CPU."""
    from repro_torch import models
    _, n_a, B_a, S_a, B_b, S_b = next(r for r in MODEL14_DENSE
                                      if r[0] == module)
    cfg = fp32(module, MODEL14_FP32_LAYERS)
    params = models.init_params(cfg, seed, device=device)
    out = {"decode_vs_forward": hold_decode(
        torch, device, module, MODEL14_FP32_LAYERS, B_b, S_b, seed, card,
        False, False, params=params, phase="14b")}
    out["card_vs_cpu"] = hold_card_cpu(torch, device, module, n_a, B_a, S_a,
                                       seed, card, params=params,
                                       phase="14a")
    del params
    torch.cuda.empty_cache()
    return out


def routes_against(r, ref, capacity: int, where: str) -> tuple:
    """Rows (tokens) of a one-layer MoE run whose expert ids and kept
    slots (queue position below ``capacity``) equal the reference run's
    (a row's output depends on nothing else of the routing), and the
    near ties that differ: a token whose ids differ must be one where the
    CPU's router logits of the swapped experts lie within twice the
    token's own logit difference between the runs (a swap its input's
    rounding explains).  Ids equal everywhere must give equal positions;
    after a swap, the positions it shifts in the two experts' queues are
    counted."""
    import torch
    ids, ids_r = r.experts[0], ref.experts[0]
    pos, pos_r = r.positions[0], ref.positions[0]
    swapped = (ids != ids_r).any(dim=1)
    if not bool(swapped.any()):
        check(torch.equal(pos, pos_r), f"{where}: equal expert ids, "
              f"positions differ")
    gaps = []
    for t in swapped.nonzero().flatten().tolist():
        lc = ref.logits[0][t]
        drift = float((r.logits[0][t] - lc).abs().max())
        for j in (ids[t] != ids_r[t]).nonzero().flatten().tolist():
            gap = abs(float(lc[ids[t, j]] - lc[ids_r[t, j]]))
            check(gap <= 2 * drift, f"{where}: token {t} slot {j} takes "
                  f"expert {int(ids[t, j])} for {int(ids_r[t, j])}, a "
                  f"logit gap {gap:.3g} beyond twice its drift {drift:.3g}"
                  f" (not a near tie)")
            gaps.append(gap)
    same = ~swapped & ((pos < capacity) == (pos_r < capacity)).all(dim=1)
    return same, {"tokens": int(ids.shape[0]),
                  "swapped_tokens": int(swapped.sum()),
                  "near_tie_gaps": gaps,
                  "positions_shifted": int((~swapped & (pos != pos_r)
                                            .any(dim=1)).sum()),
                  "rows_held": int(same.sum())}


def kimi_hold(torch, device, params, cfg, seed: int, card: str) -> dict:
    """Phase 14a for kimi-k2 (bf16, one layer of 384 experts): the
    forward's hidden states and last-position logits on the card against
    the port's CPU run on the same weights, held to KIMI_CONTROL_MARGIN
    times a control measured here: the card's run with B4, B6 and B7
    swapped for their plain versions, against the same CPU run.  Expert
    ids and queue positions are compared token by token; a token that
    differs must be a near tie (``routes_against``), is counted and
    logged, and leaves the rows held."""
    from repro_torch import models
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    B, S = KIMI_CARD_CPU
    x = host_inputs(torch, cfg, B, S, seed)
    where = f"phase 14a {cfg.name} bf16 {cfg.n_layers} layer B {B} x S {S}"

    def run(p, inputs):
        with RouteRecorder(layers, logits=True) as rr:
            h, _ = models.forward(p, cfg, inputs)
            last = models.logits_fn(p, cfg, h[:, -1:])
        return h.float().cpu().reshape(B * S, -1), last.float().cpu(), rr

    h_k, last_k, r_k = run(params, x.to(device))
    with OpSwap(ops, "rmsnorm", ref.ref_rmsnorm), \
            OpSwap(ops, "flash_attention", ref.ref_flash_attention), \
            OpSwap(ops, "grouped_matmul",
                   experts_at_a_time(ref.ref_grouped_matmul, 64)):
        h_p, last_p, r_p = run(params, x.to(device))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    h_c, last_c, r_c = run(to_cpu(params), x)
    cpu_s = time.perf_counter() - t0
    capacity = models.moe_capacity(cfg, B * S)
    same_k, routes_k = routes_against(r_k, r_c, capacity,
                                      f"{where} (kernels)")
    same_p, routes_p = routes_against(r_p, r_c, capacity,
                                      f"{where} (control)")
    rows = same_k & same_p
    lasts = rows.reshape(B, S)[:, -1]
    check(int(rows.sum()) >= KIMI_MIN_HELD and bool(lasts.all()),
          f"{where}: {int(rows.sum())} of {B * S} tokens held (at least "
          f"{KIMI_MIN_HELD} and every last position wanted)")
    check(routes_k["swapped_tokens"]
          <= KIMI_CONTROL_MARGIN * max(routes_p["swapped_tokens"], 1),
          f"{where}: the kernels swap {routes_k['swapped_tokens']} tokens' "
          f"experts, over {KIMI_CONTROL_MARGIN} x the control's "
          f"{routes_p['swapped_tokens']}")
    errs = {}
    for name, got, ctl, want, keep in (("hidden", h_k, h_p, h_c, rows),
                                       ("logits", last_k[:, 0], last_p[:, 0],
                                        last_c[:, 0], lasts)):
        check(bool(torch.isfinite(got).all()), f"{where}: {name} non-finite")
        err = float((got[keep] - want[keep]).abs().max())
        control = float((ctl[keep] - want[keep]).abs().max())
        limit = KIMI_CONTROL_MARGIN * control
        errs[name] = {"max_abs_err": err, "control": control,
                      "limit": limit, "max_abs": float(want.abs().max())}
        check(err <= limit, f"{where}: {name} differs from the CPU run by "
              f"{err:.3g}, over {KIMI_CONTROL_MARGIN} x the control "
              f"{control:.3g} (B4, B6, B7 swapped for their plain versions)")
    log(f"{where} ok: bf16 forward card == CPU within "
        f"{KIMI_CONTROL_MARGIN} x the measured control (hidden "
        f"{errs['hidden']['max_abs_err']:.3g} against control "
        f"{errs['hidden']['control']:.3g}; last-position logits "
        f"{errs['logits']['max_abs_err']:.3g} against "
        f"{errs['logits']['control']:.3g}); expert ids and positions: "
        f"kernels {routes_k['swapped_tokens']} near-tie tokens swapped "
        f"(largest logit gap {max(routes_k['near_tie_gaps'], default=0):.3g},"
        f" {routes_k['positions_shifted']} tokens' queue positions shifted), "
        f"control {routes_p['swapped_tokens']} (largest gap "
        f"{max(routes_p['near_tie_gaps'], default=0):.3g}, "
        f"{routes_p['positions_shifted']} shifted); {int(rows.sum())} of "
        f"{B * S} tokens held (ids and kept slots equal in both runs); CPU "
        f"run {cpu_s:.2f} s [{card}]")
    return {"config": cfg.name, "layers": cfg.n_layers, "batch": B,
            "seq": S, "errors": errs, "routes_kernels": routes_k,
            "routes_control": routes_p, "rows_held": int(rows.sum()),
            "cpu_s": cpu_s}


def bf16_runs(torch, device, label: str, module: str, n_layers: int,
              decode: bool, seed: int, card: str, held: set) -> tuple:
    """Phase 14c for one config: its bf16 weights at ``n_layers`` drawn on
    the card (the init's peak device memory logged), the prefill of
    PREFILL_SHAPE and, with ``decode``, the decode at DECODE_BATCH against
    a 4,352-slot cache from length 4,096, each counted, timed and
    profiled with every kernel call among ``held``.  Returns the rows and
    the weights (for kimi-k2's 14a)."""
    from repro_torch import models
    from repro_torch.configs.base import cache_seq_len
    from repro_torch.kernels import ops
    cfg = arch_config(module, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed, device=device)
    torch.cuda.synchronize()
    init = {"s": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "held_bytes": torch.cuda.memory_allocated(),
            "card_bytes": torch.cuda.get_device_properties(device)
            .total_memory}
    check(init["peak_bytes"] < init["card_bytes"], f"phase 14c {label}: "
          f"init peak over the card")
    published = arch_config(module).n_layers
    cut = "depth cut to fit one card" if n_layers < published else "no cut"
    log(f"phase 14c {label}: {cfg.name} bf16 {n_layers} of {published} "
        f"layers ({cut}), widths as published; init {init['s']:.2f} s, "
        f"peak device memory {init['peak_bytes'] / 2**30:.3f} GiB, weights "
        f"{init['held_bytes'] / 2**30:.3f} GiB of "
        f"{init['card_bytes'] / 2**30:.3f} GiB [{card}]")
    B, S = PREFILL_SHAPE
    x = host_inputs(torch, cfg, B, S, seed).to(device)
    if cfg.is_moe:
        cap = models.moe_capacity(cfg, B * S)
        check(cap == 216, f"phase 14c {label}: capacity {cap}")

    def prefill():
        h, _ = models.forward(params, cfg, x)
        return h, models.logits_fn(params, cfg, h[:, -1:])

    row = timed_run(torch, ops, f"{label} prefill", prefill,
                    bf16_launches(cfg), 3, card, held, phase="14c")
    row.update(config=cfg.name, layers=n_layers, batch=B, seq=S,
               tokens_per_s=B * S / (row["ms"] / 1e3), init=init)
    log(f"phase 14c {label} prefill: {cfg.name} bf16 {n_layers} layers, "
        f"B {B} x S {S} (forward + last-position logits) {row['ms']:.3f} ms"
        f" = {row['tokens_per_s']:.1f} tokens/s; peak device memory "
        f"{row['peak_bytes'] / 2**30:.3f} GiB; idle share "
        f"{row['idle_share']}; launches {row['launches']} [{card}]")
    rows = {f"{label} prefill": row}
    del x
    if decode:
        Bd = DECODE_BATCH
        state = models.init_decode_state(cfg, Bd, cache_seq_len(S),
                                         device=device, length=S)
        tok = host_inputs(torch, cfg, Bd, 1, seed)[:, 0].to(device)
        box = [state]

        def step():
            lg, box[0] = models.decode_step(params, cfg, box[0], tok)
            return (lg,)

        step()
        drow = timed_run(torch, ops, f"{label} decode", step,
                         {**dict.fromkeys(KERNEL_PREFIX, 0),
                          "decode_attention": n_layers,
                          "rmsnorm": 2 * n_layers + 1}, 8, card, held,
                         phase="14c")
        drow.update(config=cfg.name, layers=n_layers, batch=Bd,
                    cache_slots=cache_seq_len(S), length=S,
                    tokens_per_s=Bd / (drow["ms"] / 1e3))
        log(f"phase 14c {label} decode: B {Bd} against {cache_seq_len(S)} "
            f"cache slots from length {S}: {drow['ms']:.3f} ms a step "
            f"({drow['tokens_per_s']:.1f} tokens/s); peak device memory "
            f"{drow['peak_bytes'] / 2**30:.3f} GiB; idle share "
            f"{drow['idle_share']}; launches {drow['launches']} [{card}]")
        rows[f"{label} decode"] = drow
        del state, box
    return rows, params, cfg


def _campaign(spec, dev):
    """14d's campaign (the arrival-spike ray, tol 1/4, 3 rounds) over
    ``spec``'s drills on ``dev``: its report and seconds."""
    from repro_torch.chaos.campaign import Ray
    from repro_torch.serving import request_campaign
    t0 = time.perf_counter()
    rep = request_campaign(
        spec, rays=(Ray("arrival_spike", {"arrival_spike": 1.0}),),
        tol=1.0 / 4.0, max_rounds=3, device=dev).run()
    return rep, time.perf_counter() - t0


def _cpu_campaign(weights: str) -> tuple:
    """14d's campaign on the CPU, in a worker process beside the card's,
    its drills on the card's pool weights (saved at ``weights``)."""
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.serving import DrillSpec, workload
    spec = DrillSpec(**CAMPAIGN_SPEC)
    params = torch.load(weights)
    for e in workload.pool_for(spec, "cpu")[0].values():
        e.params = params
    return _campaign(spec, "cpu")


def phase_campaign(torch, device, card: str) -> dict:
    """Phase 14d: the request campaign (``serving.request_campaign``, the
    arrival-spike ray, tol 1/4, 3 rounds) over CAMPAIGN_SPEC's drills on
    the card, against the same campaign on the port's CPU with the card's
    pool weights copied across (run in a worker process at the same
    time; ray by ray: status, bracket, frontier severity and knobs,
    counterexample, every probe), and ``verify_report`` replaying it on
    the card through a fresh oracle with no mismatch."""
    import multiprocessing as mp
    from repro_torch.chaos import verify_report
    from repro_torch.serving import DrillSpec, drill_oracle, workload
    spec = DrillSpec(**CAMPAIGN_SPEC)
    where = "phase 14d request campaign"
    engines, _ = workload.pool_for(spec, device)
    weights = os.path.join(ROOT, "build", "phase14d_pool.pt")
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    torch.save(to_cpu(next(iter(engines.values())).params), weights)
    pool = mp.get_context("spawn").Pool(1)
    try:
        on_cpu = pool.apply_async(_cpu_campaign, (weights,))
        rep, card_s = _campaign(spec, device)
        t0 = time.perf_counter()
        replay = verify_report(rep, oracle=drill_oracle(spec, device))
        replay_s = time.perf_counter() - t0
        rep_cpu, cpu_s = on_cpu.get(timeout=900)
    finally:
        pool.close()
        pool.join()
        os.remove(weights)
    same_report(rep, rep_cpu, where)
    for g, w in zip(rep.rays, rep_cpu.rays):
        check(g.frontier_knobs() == w.frontier_knobs(),
              f"{where}: ray {w.name} frontier knobs differ")
    ray = rep.ray("arrival_spike")
    check(rep.op_ok and ray.status == "localized",
          f"{where}: {ray.status}, op_ok {rep.op_ok}")
    check(replay["n_probes"] == rep.n_evals and not replay["mismatches"],
          f"{where}: verify_report on the card: {replay}")
    log(f"{where} ok: card == CPU (status {ray.status}, frontier severity "
        f"{ray.frontier_severity}, knobs {ray.frontier_knobs()}, "
        f"counterexample {ray.counterexample}, {rep.n_evals} probes); "
        f"verify_report on the card replays {replay['n_probes']} probes "
        f"with no mismatch; card {card_s:.2f} s, CPU {cpu_s:.2f} s (a "
        f"worker process, beside the card's), replay {replay_s:.2f} s "
        f"[{card}]")
    return {"status": ray.status, "frontier_severity": ray.frontier_severity,
            "n_evals": rep.n_evals, "card_s": card_s, "cpu_s": cpu_s,
            "replay_s": replay_s}


def phase_last_configs(torch, device, card: str, held: set) -> dict:
    """Phase 14: musicgen-large, internvl2-76b, command-r-plus-104b and
    kimi-k2 at their published widths through ``repro_torch.models``: (a)
    card vs CPU, (b) decode vs forward, (c) bf16 timed runs, then (d) the
    request campaign on the card."""
    out = {"holds": {}, "timed": {}}
    seed = MODEL14_SEED
    for label, module, n_layers, decode in MODEL14_BF16:
        seed += 1
        if not arch_config(module).is_moe:
            out["holds"][label] = dense_holds(torch, device, module, seed,
                                              card)
        rows, params, cfg = bf16_runs(torch, device, label, module,
                                      n_layers, decode, seed, card, held)
        out["timed"].update(rows)
        if cfg.is_moe:
            out["holds"][label] = kimi_hold(torch, device, params, cfg, seed,
                                            card)
        del params
        torch.cuda.empty_cache()
    out["campaign"] = phase_campaign(torch, device, card)
    return out


# ---------------------------------------------------------------------------
# phase 15: float16 models at full width on the card
# ---------------------------------------------------------------------------

MODEL15_SEED = 31           # phase 15's weights and inputs, one seed a run
# (a)-(c): (label, config module, layers, decode after the prefill);
# llama3.2-3b and mamba2-780m at their published depths, phi3.5-moe at 8
# of its 32 layers, as phase 10c runs it in bf16 (32 do not fit 80 GB)
MODEL15_RUNS = (("llama3.2-3b", "llama3_2_3b", 28, True),
                ("mamba2-780m", "mamba2_780m", 48, False),
                ("phi3.5-moe", "phi3_5_moe_42b_a6_6b", 8, False))
# the kernels' float16 run against the plain versions' float16 run (same
# weights, same inputs) may differ by at most this many times the
# control, measured in the same run: the plain versions' float16 run
# against their float32 run (the float16 weights widened)
F16_CONTROL_MARGIN = 2.0
F16_LOGIT_ROWS = 64         # prefill positions a sequence whose greedy
#                             tokens are compared
F16_DECODE_STEPS = 4        # decode steps held, teacher-forced


def plain_versions(ops, ref, stack):
    """Inside ``stack`` (an ExitStack), every model kernel's wrapper in
    ``ops`` replaced by its plain version (B6 32 heads and B7 16 experts
    at a time, which compute the same values in less memory)."""
    for name, fn in (("rmsnorm", ref.ref_rmsnorm),
                     ("flash_attention",
                      heads_at_a_time(ref.ref_flash_attention, 32)),
                     ("decode_attention", ref.ref_decode_attention),
                     ("grouped_matmul",
                      experts_at_a_time(ref.ref_grouped_matmul, 16)),
                     ("ssd_scan", ref.ref_ssd_scan)):
        stack.enter_context(OpSwap(ops, name, fn))


def greedy_hold(got, want, where: str) -> dict:
    """Greedy tokens of two runs' logits, (rows, vocab), compared row by
    row: a row whose token differs must be a near tie, the two tokens'
    logits in ``want`` within twice the row's largest drift between the
    runs (a swap the rounding explains)."""
    tg, tw = got.argmax(-1), want.argmax(-1)
    drift = (got - want).abs().amax(-1)
    gaps = []
    for r in (tg != tw).nonzero().flatten().tolist():
        gap = abs(float(want[r, tg[r]] - want[r, tw[r]]))
        check(gap <= 2 * float(drift[r]), f"{where}: row {r} takes token "
              f"{int(tg[r])} for {int(tw[r])}, a logit gap {gap:.3g} beyond "
              f"twice its drift {float(drift[r]):.3g} (not a near tie)")
        gaps.append(gap)
    return {"tokens": int(tg.numel()), "differ": len(gaps),
            "near_tie_gaps": gaps}


def held_rows(ra, rb, capacity: int):
    """Tokens whose expert ids and kept slots agree in every MoE layer of
    two recorded runs (``RouteRecorder``), and the count that do not."""
    same = None
    for ia, ib, pa, pb in zip(ra.experts, rb.experts, ra.positions,
                              rb.positions):
        s = (ia == ib).all(dim=1) & ((pa < capacity) == (pb < capacity)) \
            .all(dim=1)
        same = s if same is None else same & s
    return same, int((~same).sum())


def f16_hold(torch, device, label: str, module: str, n_layers: int,
             decode: bool, seed: int, card: str, held: set) -> dict:
    """Phase 15 (a)-(c) for one config: float16 weights at full width
    drawn on the card; the prefill of PREFILL_SHAPE on the kernels,
    counted, timed and profiled with every kernel call among ``held``;
    then held against the plain versions' float16 run within
    F16_CONTROL_MARGIN times the control (their float32 run): the hidden
    states, and the greedy tokens of the last F16_LOGIT_ROWS positions
    token by token.  With ``decode``, F16_DECODE_STEPS teacher-forced
    steps at DECODE_BATCH against a 4,352-slot float16 cache filled with
    seeded values up to length 4,096, held the same way, then timed."""
    import contextlib
    from repro_torch import models
    from repro_torch.configs.base import cache_seq_len
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    cfg = arch_config(module, n_layers=n_layers, param_dtype="float16",
                      activ_dtype="float16")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activ_dtype="float32")
    where = f"phase 15 {label} fp16 {n_layers} layers"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = models.init_params(cfg, seed, device=device)
    B, S = PREFILL_SHAPE
    x = host_inputs(torch, cfg, B, S, seed).to(device)
    capacity = models.moe_capacity(cfg, B * S) if cfg.is_moe else 0
    launches = {**bf16_launches(cfg),
                "flash_attention": n_layers if cfg.has_attn else 0,
                "ssd_scan": n_layers if cfg.has_ssm else 0}

    def prefill(p, c, inputs):
        h, _ = models.forward(p, c, inputs)
        return h, models.logits_fn(p, c, h[:, -F16_LOGIT_ROWS:])

    # (the lambdas read `params` when called: once it is deleted below,
    # the float16 weights are freed for the float32 control)
    row = timed_run(torch, ops, f"{label} fp16 prefill",
                    lambda: prefill(params, cfg, x), launches, 3, card, held,
                    phase="15")
    row.update(config=cfg.name, layers=n_layers, batch=B, seq=S,
               tokens_per_s=B * S / (row["ms"] / 1e3))
    log(f"{where} prefill: B {B} x S {S} {row['ms']:.3f} ms (device "
        f"{fmt_ms(row.get('device_ms'))}) = {row['tokens_per_s']:.1f} "
        f"tokens/s; peak device memory {row['peak_bytes'] / 2**30:.3f} GiB; "
        f"idle share {row['idle_share']}; launches {row['launches']} "
        f"[{card}]")

    def recorded(p, c, inputs, plain):
        with contextlib.ExitStack() as stack:
            if plain:
                plain_versions(ops, ref, stack)
            rr = stack.enter_context(RouteRecorder(layers))
            with torch.no_grad():
                h, lg = prefill(p, c, inputs)
        out = (h.float().reshape(B * S, -1), lg.float().reshape(
            B * F16_LOGIT_ROWS, -1), rr)
        del h, lg
        return out

    h_k, l_k, r_k = recorded(params, cfg, x, False)
    h_p, l_p, r_p = recorded(params, cfg, x, True)
    steps = None
    if decode:
        Bd, slots = DECODE_BATCH, cache_seq_len(S)
        gen = torch.Generator(device=device).manual_seed(seed)
        st0 = models.init_decode_state(cfg, Bd, slots, torch.float16,
                                       length=S, device=device)
        for cache in (st0.k_cache, st0.v_cache):
            cache[:, :, :S] = torch.randn(
                cache[:, :, :S].shape, generator=gen, device=device,
                dtype=torch.float32).to(torch.float16)
        toks = host_inputs(torch, cfg, Bd, F16_DECODE_STEPS, seed + 1) \
            .to(device)

        def run_steps(p, c, st, plain):
            out = []
            with contextlib.ExitStack() as stack:
                if plain:
                    plain_versions(ops, ref, stack)
                with torch.no_grad():
                    for t in range(F16_DECODE_STEPS):
                        lg, st = models.decode_step(p, c, st, toks[:, t])
                        out.append(lg.float())
            return torch.cat(out)

        def fresh(dtype):
            return st0._replace(k_cache=st0.k_cache.to(dtype, copy=True),
                                v_cache=st0.v_cache.to(dtype, copy=True))

        steps = {"kernels": run_steps(params, cfg, fresh(torch.float16),
                                      False),
                 "plain": run_steps(params, cfg, fresh(torch.float16), True)}
    # the control: the plain versions in float32 on the widened weights
    params32 = _map_leaves(params, lambda t: t.float()
                           if t.dtype == torch.float16 else t)
    del params
    torch.cuda.empty_cache()
    h_32, l_32, r_32 = recorded(params32, cfg32, x.float() if
                                x.is_floating_point() else x, True)
    if decode:
        steps["float32"] = run_steps(params32, cfg32, fresh(torch.float32),
                                     True)
    del params32
    torch.cuda.empty_cache()
    rows = torch.ones(B * S, dtype=torch.bool)
    routes = {}
    if cfg.is_moe:
        same_k, swapped_k = held_rows(r_k, r_p, capacity)
        same_c, swapped_c = held_rows(r_p, r_32, capacity)
        rows = same_k & same_c
        routes = {"swapped_kernels": swapped_k, "swapped_control": swapped_c,
                  "rows_held": int(rows.sum())}
        check(swapped_k <= F16_CONTROL_MARGIN * max(swapped_c, 1),
              f"{where}: the kernels swap {swapped_k} tokens' experts, over "
              f"{F16_CONTROL_MARGIN} x the control's {swapped_c}")
        check(int(rows.sum()) >= B * S // 2, f"{where}: {int(rows.sum())} of "
              f"{B * S} tokens held")
    errs = {}
    last = rows.reshape(B, S)[:, -F16_LOGIT_ROWS:].reshape(-1)
    for name, got, plain, f32v, keep in (("hidden", h_k, h_p, h_32, rows),
                                         ("logits", l_k, l_p, l_32, last)):
        check(bool(torch.isfinite(got).all()) and
              bool(torch.isfinite(plain).all()),
              f"{where}: {name} non-finite (kernels or plain float16)")
        err = float((got[keep] - plain[keep]).abs().max())
        control = float((plain[keep] - f32v[keep]).abs().max())
        errs[name] = {"max_abs_err": err, "control": control,
                      "max_abs": float(f32v.abs().max())}
        check(err <= F16_CONTROL_MARGIN * control, f"{where}: {name} "
              f"kernels vs plain {err:.3g}, over {F16_CONTROL_MARGIN} x the "
              f"control {control:.3g} (plain float16 vs plain float32)")
    greedy = {"kernels": greedy_hold(l_k[last], l_p[last],
                                     f"{where} greedy tokens"),
              "control": greedy_hold(l_p[last], l_32[last],
                                     f"{where} greedy tokens (control)")}
    out = {"prefill": row, "errors": errs, "greedy": greedy,
           "routes": routes}
    log(f"{where} ok: kernels == plain versions within "
        f"{F16_CONTROL_MARGIN} x the float32 control (hidden "
        f"{errs['hidden']['max_abs_err']:.3g} against control "
        f"{errs['hidden']['control']:.3g}, last {F16_LOGIT_ROWS} positions' "
        f"logits {errs['logits']['max_abs_err']:.3g} against "
        f"{errs['logits']['control']:.3g}); greedy tokens differ at "
        f"{greedy['kernels']['differ']} of {greedy['kernels']['tokens']}, "
        f"all near ties (control {greedy['control']['differ']}); routes "
        f"{routes} [{card}]")
    if decode:
        err = float((steps["kernels"] - steps["plain"]).abs().max())
        control = float((steps["plain"] - steps["float32"]).abs().max())
        check(bool(torch.isfinite(steps["kernels"]).all()),
              f"{where} decode: non-finite logits")
        check(err <= F16_CONTROL_MARGIN * control, f"{where} decode: logits "
              f"kernels vs plain {err:.3g}, over {F16_CONTROL_MARGIN} x the "
              f"control {control:.3g}")
        dgreedy = {"kernels": greedy_hold(steps["kernels"], steps["plain"],
                                          f"{where} decode greedy tokens"),
                   "control": greedy_hold(steps["plain"], steps["float32"],
                                          f"{where} decode greedy tokens "
                                          f"(control)")}
        out["decode_hold"] = {"max_abs_err": err, "control": control,
                              "greedy": dgreedy}
        log(f"{where} decode ok: {F16_DECODE_STEPS} teacher-forced steps at "
            f"B {Bd} from length {S}, logits kernels vs plain {err:.3g} "
            f"against control {control:.3g}; greedy tokens differ at "
            f"{dgreedy['kernels']['differ']} of "
            f"{dgreedy['kernels']['tokens']} (control "
            f"{dgreedy['control']['differ']}) [{card}]")
        # timed: the kernels' step, the cache rebuilt in float16
        params = models.init_params(cfg, seed, device=device)
        box = [fresh(torch.float16)]
        tok = toks[:, 0]

        def step():
            lg, box[0] = models.decode_step(params, cfg, box[0], tok)
            return (lg,)

        with torch.no_grad():
            step()
            drow = timed_run(torch, ops, f"{label} fp16 decode", step,
                             {**dict.fromkeys(KERNEL_PREFIX, 0),
                              "decode_attention": n_layers,
                              "rmsnorm": 2 * n_layers + 1}, 8, card, held,
                             phase="15")
        drow.update(config=cfg.name, layers=n_layers, batch=Bd,
                    cache_slots=slots, length=S,
                    tokens_per_s=Bd / (drow["ms"] / 1e3))
        log(f"{where} decode: B {Bd} against {slots} cache slots from "
            f"length {S}: {drow['ms']:.3f} ms a step (device "
            f"{fmt_ms(drow.get('device_ms'))}, "
            f"{drow['tokens_per_s']:.1f} tokens/s); peak device memory "
            f"{drow['peak_bytes'] / 2**30:.3f} GiB; idle share "
            f"{drow['idle_share']}; launches {drow['launches']} [{card}]")
        out["decode"] = drow
        del params, box
    if decode:
        del st0
    torch.cuda.empty_cache()
    return out


def phase_float16(torch, device, card: str, held: set) -> dict:
    """Phase 15: llama3.2-3b (28 layers, prefill and decode), mamba2-780m
    (48 layers) and phi3.5-moe (8 layers) in float16 at full width
    (``f16_hold``); (d), the open domains at the ops level, are phase 6's
    last cases."""
    out = {}
    seed = MODEL15_SEED
    for label, module, n_layers, decode in MODEL15_RUNS:
        seed += 1
        out[label] = f16_hold(torch, device, label, module, n_layers, decode,
                              seed, card, held)
    return out


def main_grid(n: int) -> dict:
    from repro_torch.core.scenarios import scenario_grid
    from repro_torch.core.sweep_engine import tile_grid
    base = scenario_grid(evict_fraction=(0.25, 0.5, 0.75, 1.0))
    base["storm_refrac"] = np.resize(np.array([0.0, 0.1, 0.3]),
                                     len(base["traffic_mult"]))
    return tile_grid(base, n)


def check_outputs(res: dict, n: int, grid: dict):
    for k, v in res.items():
        check(len(v) == n, f"main: {k} has {len(v)} rows, want {n}")
        if k in grid:
            continue
        check(v.dtype in (np.float32, np.bool_, np.int32),
              f"main: {k} is {v.dtype}")
        # restore times are inf where the scenario never restores
        if v.dtype == np.float32 and k not in ("rl_done_s", "t_rl_done_s",
                                               "t_time_to_restore_s"):
            check(np.isfinite(v).all(), f"main: {k} has non-finite values")
    check(res["t_time_to_restore_s"].shape == (n, 7), "main: tier axis")
    check(res["dep_n_broken_critical"].max() > 0, "main: nothing broke")
    check((res["storm_broken_frac"] > 0).any(), "main: no storm stage")


def setup(torch):
    """The card, its name and power limit, and every kernel built from
    the checkout's sources (one nvcc each, all in parallel)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import resolve_device
    device = resolve_device("cuda")
    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{len(build.SOURCES)} kernels ({len(reports)} compiled now)")
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name} {entry}: {line.strip()}")
                # B1's, B2's, B3's and B8's kernels are held to no spills
                check(name not in NO_SPILL or "spill" not in line
                      or ("0 bytes spill stores" in line
                          and "0 bytes spill loads" in line),
                      f"ptxas {name} {entry}: spills ({line.strip()})")
    return device, card


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    device, card = setup(torch)
    from repro_torch.core.scenarios import FleetAggregates
    from repro_torch.core.service import synthesize_fleet
    from repro_torch.core.sweep_engine import SweepEngine
    from repro_torch.core.timeline_sim import config_for_fleet
    from repro_torch.graph import CallGraph
    from repro_torch.graph.propagation import combined_dark_uniques
    from repro_torch.kernels.backend import describe_device
    from repro_torch.kernels.ufa.propagation import fixed_point_ell
    from repro_torch.kernels.ufa.reduce import timeline_reduce

    # phase 1
    k_reduce = phase_reduce(torch, device)
    log(f"phase 1 ok: timeline_reduce kernel == plain "
        f"(max abs err {k_reduce['max_abs_err']:.3g}) "
        f"{k_reduce['ms']:.6f} ms, plain {k_reduce['plain_ms']:.6f} ms, "
        f"bound {k_reduce['bound_ms']:.6f} ms [{card}]")

    # the paper-scale fleet, graph and main-path grid
    t0 = time.perf_counter()
    fs = synthesize_fleet(scale=1.0, seed=7, as_arrays=True)
    fs.apply_ufa_target_classes()
    graph = CallGraph.from_fleet_state(fs)
    agg = FleetAggregates.from_fleet_state(fs)
    cfg = config_for_fleet(fs)
    grid = main_grid(SCENARIOS)
    log(f"fleet: {fs.n} services, {graph.n_edges} edges, "
        f"{int(graph.critical.sum())} critical, max out-degree "
        f"{int(np.diff(graph.indptr).max())}; set-up "
        f"{time.perf_counter() - t0:.2f} s")

    # phase 2: the main path's dark sets plus the all-preemptible one
    seed = 0
    eng = SweepEngine(agg, cfg, graph=graph, seed=seed, device=device)
    dark_u, _, _ = combined_dark_uniques(
        graph, grid["evict_fraction"], grid["storm_refrac"], seed=seed,
        storm_seed=eng.storm_seed)
    dark = np.concatenate([dark_u, graph.preemptible[None, :]])
    k_prop = phase_propagation(torch, device, graph, dark)
    relay, consts_relay = phase_multihop(torch, device,
                                         np.arange(1, 9) / 8.0, seed=3)
    log(f"phase 2 ok: fixed_point_ell kernel == plain (one-hop and relay "
        f"chains), {k_prop['ms']:.6f} ms, plain {k_prop['plain_ms']:.6f} ms,"
        f" bound {k_prop['bound_ms']:.6f} ms [{card}]")

    # phase 3: the main path, counts zeroed just before, read just after
    n = SCENARIOS
    timeline_reduce.launches = 0
    fixed_point_ell.launches = fixed_point_ell.rounds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(grid)
    cold = time.perf_counter() - t0
    k_reduce["launches"] = timeline_reduce.launches
    k_prop["launches"] = fixed_point_ell.launches
    check(k_reduce["launches"] > 0, "main path launched no timeline_reduce")
    check(k_prop["launches"] > 0, "main path launched no fixed_point_ell")
    log(f"main path launches: timeline_reduce {k_reduce['launches']}, "
        f"fixed_point_ell {k_prop['launches']} (one per fixed point on the "
        f"cluster route) over {fixed_point_ell.rounds} rounds")
    check_outputs(res, n, grid)
    warm, warm_gc = [], []
    for _ in range(WARM_RUNS):
        torch.cuda.synchronize()
        with GcTime() as gct:
            t0 = time.perf_counter()
            again = eng.run(grid)
            warm.append(time.perf_counter() - t0)
        warm_gc.append(str(gct))
    for k in res:
        check(np.array_equal(res[k], again[k], equal_nan=True),
              f"main: {k} differs between runs")
    log(f"main path {n} scenarios: cold {cold:.4f} s "
        f"({n / cold:.1f} scen/s), warm "
        + ", ".join(f"{w:.4f} s ({n / w:.1f} scen/s; {g})"
                    for w, g in zip(warm, warm_gc))
        + f" [{card}]")

    # the first chunk against the port's own CPU run, at the two grades
    head = {k: v[:4096] for k, v in grid.items()}
    t0 = time.perf_counter()
    cpu = SweepEngine(agg, cfg, graph=graph, seed=seed,
                      device="cpu").run(head)
    log(f"cpu reference run of {len(head['traffic_mult'])} scenarios: "
        f"{time.perf_counter() - t0:.2f} s")
    gpu_head = {k: v[:4096] for k, v in res.items()}
    rtol = {k: F32_TIGHT for k, v in cpu.items() if v.dtype.kind == "f"}
    rtol["t_availability_mean"] = AVAIL_MEAN_RTOL
    for k in grid:
        rtol.pop(k, None)
    compare(gpu_head, cpu, rtol, "main vs cpu")
    exact = sorted(k for k in cpu if np.array_equal(gpu_head[k], cpu[k],
                                                    equal_nan=True))
    log(f"phase 3 ok: gpu == cpu on the first 4096 scenarios "
        f"({len(exact)} of {len(cpu)} keys bit-identical; differing: "
        f"{sorted(set(cpu) - set(exact))})")

    # where the time goes: one profiled warm run
    before = timeline_reduce.launches
    sweep_us = profile_run("sweep", torch, lambda: eng.run(grid), card)
    chunks = timeline_reduce.launches - before
    b1_us = sum(us for name, us in sweep_us.items()
                if "timeline_reduce" in name)
    log(f"profile sweep: timeline_reduce "
        + (f"{b1_us / 1e3 / chunks:.6f} ms device a chunk over {chunks} "
           f"chunks ({b1_us:.1f} us of the run)" if b1_us > 0
           else "not measured")
        + f" [{card}]")

    # phase 4: the telemetry histogram kernel on the paper-scale universe
    from repro_torch.core.dependency import trace_edges
    t0 = time.perf_counter()
    dfs = detection_fleet()
    edges = trace_edges(dfs, seed=DETECT_SEED)
    log(f"detection fleet: {dfs.n} services, {edges.n} edges, "
        f"{int(edges.unsafe.sum())} unsafe, {int(edges.cold.sum())} cold; "
        f"set-up {time.perf_counter() - t0:.2f} s")
    k_ingest = phase_ingest(torch, device, edges)
    log(f"phase 4 ok: ingest_hist kernel == plain (exact), "
        f"{k_ingest['ms']:.6f} ms, plain {k_ingest['plain_ms']:.6f} ms, "
        f"torch.bincount {k_ingest['library_ms']:.6f} ms, bound "
        f"{k_ingest['bound_ms']:.6f} ms [{card}]")

    # phase 5: detection to hardening, counted
    # a kernel's "launches" is its count on the newest main path that runs
    # it; "launches_by_path" keeps every path's count
    launches = phase_harden(torch, device, dfs, card)
    k_ingest["launches"] = launches["ingest_hist"]
    k_prop["launches_by_path"] = {"sweep": k_prop["launches"],
                                  "harden": launches["fixed_point_ell"]}
    k_prop["launches"] = launches["fixed_point_ell"]

    # phase 6: the model kernels behind repro_torch.kernels.ops, counted
    k_model = phase_model_kernels(torch, device, card)
    log("phase 6 ok: " + ", ".join(
        f"{e['name']} x{e['launches']} == plain" for e in k_model)
        + f" at {sum(len(e['cases']) for e in k_model)} shapes [{card}]")

    # phase 7: the mamba2-780m model on the card, B8 and B4 counted
    model = phase_model(torch, device, card)
    by_name = {e["name"]: e for e in k_model}
    for name in ("ssd_scan", "rmsnorm"):
        by_name[name]["launches_by_path"] = {
            "kernels.ops (phase 6)": by_name[name]["launches"],
            "mamba2-780m prefill (phase 7c)": model["launches"][name]}
        by_name[name]["launches"] = model["launches"][name]
    log("phase 7 ok: mamba2-780m forward and decode on the card, "
        f"{json.dumps({k: model[k] for k in ('prefill', 'decode')})} "
        f"[{card}]")

    # phases 1b, 2b and 4b: B1's, B2's and B3's later cases, run after
    # every timed path and kernel above, so those run in the state the
    # earlier phases leave them
    k_reduce["cases"] += phase_reduce_cases(torch, device)
    log(f"phase 1b ok: timeline_reduce == plain in "
        f"{len(k_reduce['cases'])} cases [{card}]")
    k_prop["cases"] = phase_propagation_cases(torch, device, graph, relay,
                                              consts_relay, dark, card)
    log(f"phase 2b ok: fixed_point_ell == plain in "
        f"{len(k_prop['cases'])} later cases [{card}]")
    k_ingest["cases"] += phase_ingest_cases(torch, device, edges)
    log(f"phase 4b ok: ingest_hist == plain in {len(k_ingest['cases'])} "
        f"cases [{card}]")

    # phase 8: the monitored temporal sweep on the paper-scale fleet, the
    # traces' B1 and the ensemble's B2 counted
    t0 = time.perf_counter()
    traced = phase_traces(torch, device, fs, graph, agg, cfg, grid, card)
    log(f"phase 8 ok: {time.perf_counter() - t0:.2f} s, launches "
        f"{json.dumps(traced)} [{card}]")
    k_reduce["launches_by_path"] = {
        "sweep (phase 3)": k_reduce["launches"],
        "trace sweep (phase 8a)": traced["b1 trace sweep"],
        "temporal ensemble (phase 8c)": traced["b1 ensemble temporal"],
        "simulate_timeline (phase 8d)": traced["b1 simulate_timeline"]}
    k_reduce["launches"] = traced["b1 trace sweep"]
    k_prop["launches_by_path"].update({
        "ensemble (phase 8c)": traced["b2 ensemble"],
        "temporal ensemble (phase 8c)": traced["b2 ensemble temporal"]})
    k_prop["launches"] = traced["b2 ensemble"]

    # phase 9: the chaos campaign, sampled faults, topologies, the soft
    # path and the optimizer, the overcommit simulator, B1 and B2 counted
    t0 = time.perf_counter()
    chaos = phase_chaos(torch, device, fs, graph, eng, card)
    log(f"phase 9 ok: {time.perf_counter() - t0:.2f} s, launches "
        f"{json.dumps(chaos['launches'])} [{card}]")
    ln = chaos["launches"]
    k_reduce["launches_by_path"].update({
        "chaos campaign (phase 9a)": ln["b1 campaign"],
        "sampled faults (phase 9b)": ln["b1 sampled faults"],
        "soft run (phase 9d)": ln["b1 soft run"],
        "CEM generation (phase 9d)": ln["b1 CEM generation"],
        "verify_design (phase 9d)": ln["b1 verify_design"]})
    k_reduce["launches"] = ln["b1 campaign"]
    k_prop["launches_by_path"].update({
        "chaos campaign (phase 9a)": ln["b2 campaign"],
        "sampled faults (phase 9b)": ln["b2 sampled faults"]})
    k_prop["launches"] = ln["b2 campaign"]

    # phase 10: the attention, MoE and hybrid models, B4-B8 counted
    t0 = time.perf_counter()
    lm = phase_models(torch, device, card,
                      set().union(*(e["held"] for e in k_model)))
    timed = lm["timed"]
    log(f"phase 10 ok: {time.perf_counter() - t0:.2f} s, "
        + json.dumps({k: {m: r[m] for m in ("ms", "tokens_per_s",
                                             "peak_bytes", "idle_share",
                                             "launches")}
                      for k, r in timed.items()}) + f" [{card}]")
    for name, newest in (("rmsnorm", "llama3.2-3b prefill"),
                         ("decode_attention", "llama3.2-3b decode"),
                         ("flash_attention", "llama3.2-3b prefill"),
                         ("grouped_matmul", "phi3.5-moe prefill"),
                         ("ssd_scan", "hymba-1.5b prefill")):
        paths = by_name[name].setdefault(
            "launches_by_path", {"kernels.ops (phase 6)":
                                 by_name[name]["launches"]})
        paths.update({f"{label} (phase 10c)": row["launches"][name]
                      for label, row in timed.items()})
        by_name[name]["launches"] = timed[newest]["launches"][name]

    # phase 11: the serving plane (drill, full-width engine, CLI), B1, B4,
    # B5 and B7 counted
    t0 = time.perf_counter()
    served = phase_serving(torch, device, card,
                           set().union(*(e["held"] for e in k_model)))
    log(f"phase 11 ok: {time.perf_counter() - t0:.2f} s, "
        + json.dumps({"drill": {k: served["drill"][k] for k in (
            "wall_s", "decode_steps", "ms_a_step", "idle_share")},
            "served": {k: served["served"][k] for k in (
                "warm_s", "decode_steps", "ms_a_step", "peak_bytes",
                "idle_share")}}) + f" [{card}]")
    k_reduce["launches_by_path"]["serving drill (phase 11b)"] = \
        served["drill"]["timeline_reduce"]
    for name in ("rmsnorm", "decode_attention", "grouped_matmul"):
        paths = by_name[name]["launches_by_path"]
        for label, row in (("serving drill (phase 11b)", served["drill"]),
                           ("llama3.2-3b served (phase 11c)",
                            served["served"])):
            paths[label] = row["launches"][name]
        for arch, row in served["cli"].items():
            paths[f"serve CLI {arch} (phase 11d)"] = row["launches"][name]
    for name in ("rmsnorm", "decode_attention"):
        by_name[name]["launches"] = served["served"]["launches"][name]
    by_name["grouped_matmul"]["launches"] = \
        served["cli"]["phi3.5-moe-42b-a6.6b"]["launches"]["grouped_matmul"]

    # phase 12: the training path (autograd through B4, B6, B7, B8, the
    # train CLI, qwen3-1.7b / mamba2-780m / phi3.5-moe at full width, the
    # paper's story), B4, B5, B6, B7 and B8 counted
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trained = phase_training(torch, device, card,
                             set().union(*(e["held"] for e in k_model)))
    log(f"phase 12 ok: {time.perf_counter() - t0:.2f} s, " + json.dumps(
        {label: {k: r[k] for k in ("ms", "tokens_per_s", "peak_train_bytes",
                                   "idle_share", "save_write_s", "load_s",
                                   "launches_a_step")}
         for label, r in trained["full"].items()}) + f" [{card}]")
    main_train = {"rmsnorm": "qwen3-1.7b", "flash_attention": "qwen3-1.7b",
                  "grouped_matmul": "phi3.5-moe", "ssd_scan": "mamba2-780m"}
    for name, newest in main_train.items():
        paths = by_name[name]["launches_by_path"]
        for label, row in trained["full"].items():
            if row["launches_run"][name]:
                paths[f"{label} train, {row['layers']} layers, Trainer run "
                      f"(phase 12c)"] = row["launches_run"][name]
        for arch, row in trained["cli"].items():
            if row["launches"][name]:
                paths[f"train CLI {arch} (phase 12b)"] = row["launches"][name]
        paths["system story (phase 12d)"] = \
            trained["system"]["launches"][name]
        by_name[name]["launches"] = \
            trained["full"][newest]["launches_run"][name]
    by_name["decode_attention"]["launches_by_path"][
        "system story (phase 12d)"] = \
        trained["system"]["launches"]["decode_attention"]

    # phase 13: the mesh path over torch.distributed (1 x 1 NCCL mesh ==
    # no mesh, processes sharing the card, split-KV), the dry run and the
    # roofline; no kernel is added and the meta route launches nothing
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meshed = phase_mesh(torch, device, card,
                        set().union(*(e["held"] for e in k_model)), agg, cfg,
                        graph, grid, res)
    log(f"phase 13 ok: {time.perf_counter() - t0:.2f} s, "
        + json.dumps({"shares": meshed["shares"],
                      "probe": meshed["probe"]}) + f" [{card}]")

    # phase 14: musicgen-large, internvl2-76b, command-r-plus-104b and
    # kimi-k2 at their published widths (card vs CPU, decode vs forward,
    # bf16 timed runs), the request campaign on the card; B4-B7 counted
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    last = phase_last_configs(torch, device, card,
                              set().union(*(e["held"] for e in k_model)))
    log(f"phase 14 ok: {time.perf_counter() - t0:.2f} s, "
        + json.dumps({k: {m: r[m] for m in ("ms", "tokens_per_s",
                                             "peak_bytes", "idle_share",
                                             "launches")}
                      for k, r in last["timed"].items()}) + f" [{card}]")
    for name, newest in (("rmsnorm", "kimi-k2 prefill"),
                         ("flash_attention", "kimi-k2 prefill"),
                         ("grouped_matmul", "kimi-k2 prefill"),
                         ("decode_attention", "command-r-plus-104b decode")):
        by_name[name]["launches_by_path"].update(
            {f"{label} (phase 14c)": row["launches"][name]
             for label, row in last["timed"].items()
             if row["launches"][name]})
        by_name[name]["launches"] = last["timed"][newest]["launches"][name]

    # phase 15: llama3.2-3b, mamba2-780m and phi3.5-moe in float16 at full
    # width, each held against the plain versions within a float32
    # control; (d), the open domains at the ops level, are phase 6's last
    # cases.  B4-B8 counted
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f16 = phase_float16(torch, device, card,
                        set().union(*(e["held"] for e in k_model)))
    timed16 = {}
    for label, r in f16.items():
        timed16[f"{label} fp16 prefill"] = r["prefill"]
        if "decode" in r:
            timed16[f"{label} fp16 decode"] = r["decode"]
    log(f"phase 15 ok: {time.perf_counter() - t0:.2f} s, "
        + json.dumps({k: {m: r[m] for m in ("ms", "device_ms",
                                             "tokens_per_s", "peak_bytes",
                                             "idle_share", "launches")}
                      for k, r in timed16.items()}) + f" [{card}]")
    for name, newest in (("rmsnorm", "llama3.2-3b fp16 prefill"),
                         ("flash_attention", "llama3.2-3b fp16 prefill"),
                         ("decode_attention", "llama3.2-3b fp16 decode"),
                         ("grouped_matmul", "phi3.5-moe fp16 prefill"),
                         ("ssd_scan", "mamba2-780m fp16 prefill")):
        by_name[name]["launches_by_path"].update(
            {f"{label} (phase 15)": row["launches"][name]
             for label, row in timed16.items() if row["launches"][name]})
        by_name[name]["launches"] = timed16[newest]["launches"][name]

    kernels = [k_reduce, k_prop, k_ingest] + k_model
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "kernel_route", "launches_by_path", "cases")
    log(json.dumps({"kernels": [{k: e[k] for k in keys if k in e}
                                for e in kernels]}))
    dev = describe_device(device)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": dev["kind"],
                                           "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
