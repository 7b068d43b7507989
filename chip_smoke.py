#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It
  1. prints the card (nvidia-smi name and power limit), torch and CUDA
     versions and the TF32 switches;
  2. builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc`
     with nvcc (one process per source, in parallel), timed;
  3. holds every kernel against its plain PyTorch version on the card, at
     the main path's leaf shapes and at edge cases (ragged width, nothing
     active, only pad slots, bf16 storage, and for the paged kernels a
     shuffled page table with pages that are not resident); holds the
     kernels, each of which takes a whole tree in one launch on a leaf
     table (`mifa_aggregate`, `paged_bank_gather`, `bank_scatter`,
     `paged_bank_scatter` and the fleet scatters of step 9), against the
     per-leaf plain versions on trees of paper_mlp's six leaves, mixed
     f32/bf16 leaves, ragged widths, one leaf, nothing active and more
     leaves than one table holds (two launches), a repeated call
     bit-identical, and the four scatters' delta sums bit-equal to the
     fixed-order oracle (`bank_scatter_ordered_ref`); and times
     kernel and plain version per round of the main path beside the least
     time the card could take for the same bytes and operations (and,
     for the paged gather, one `torch.index_select` per leaf);
  4. runs the main path — the paper's experiment (`paper_mlp` at full
     width: N=100 clients, d=256, 2x128 hidden, K=5 local steps, batch 100,
     label-correlated Bernoulli availability with p_min=0.1, inv_t(1.0),
     weight decay 1e-3) for 20 rounds of `run_fl(engine="loop")` with
     `MIFA(memory="array")` and with `BankedMIFA(DenseBank())`, from the
     same initial params and participation seed, and checks the losses,
     the anchor property (both algorithms give the same trajectory) and
     that each path launched its kernel once per round, one launch for the
     tree (20 `mifa_aggregate`, 20 `bank_scatter`);
  5. runs the same 20 rounds through
     `BankedMIFA(PagedDeviceBank(page_size=8))`, after a second dense run
     that shows whether the card repeats a run bit for bit, and holds the
     paged run bit-equal to the dense one (20 `paged_bank_scatter`
     launches, no other kernel);
  6. drives eviction on the card: 40 cohorts of 64 (half hot) through a
     paged bank of 48 slots over 128 logical pages, against `DenseBank`:
     faults, evictions and re-faults, every row (through the gather kernel,
     one launch for the tree) and G_sum bit-equal;
  7. drives N = 10⁶ paper_mlp clients at full width for 8 rounds of
     `RoundRunner.step_cohort` through `ProceduralBatcher` and
     `PagedDeviceBank(page_size=8, n_slots=256)`: ms per round, the
     416,940,352-byte page pool, peak device memory, host spill, and G_sum
     against the sum of every written row;
  8. runs 5 rounds of the three bank/array algorithms on the CPU (plain
     versions) and on the card (kernels) and holds them together;
  9. holds the batched (fleet) bank kernels against their plain versions
     and, trial by trial, against the single-trial kernels and the
     fixed-order oracle (K=3 trials, C=64, a different cohort per trial
     and one trial of pads only), one leaf at a time and on the trees of
     step 3 (one launch per table of leaves, a repeated call
     bit-identical), and times them per round of the cohort fleet path,
     one launch a round;
 10. drives the paper's Figure 2 sweep as fleets
     (`benchmarks/fig2_convergence.py::run("paper_mlp", 0.1)`, seeds 0-2,
     participation seeds 100+s): MIFA(array), BiasedFedAvg,
     FedAvgSampling(S=50) and (S=100) on the update clock, FedAvgIS, and
     the cohort fleets BankedMIFA(DenseBank) and
     BankedMIFA(PagedDeviceBank(page_size=8)), 20 rounds each through
     `fleet.run_fleet`. Eval loss must fall in every trial; checked trials
     must match sequential `run_fl` runs on the card; the paged fleet must
     be bit-equal to the dense one; each batched kernel launches once per
     round (all six leaves and three trials) and `mifa_aggregate` once per
     trial per round; then the FedAvgSampling(S=50) fleet runs 10 rounds
     on the CPU and on the card, held together;
 11. runs the scan engine (`engine="scan"`, chunks of 5 rounds, each
     round a replay of one round body captured as a CUDA graph, a chunk's
     inputs staged to the card in one pinned copy): the three paper paths
     of steps 4-5 at full width, an eviction run (N=1024, cohorts of 64
     through 48 slots, chunks of one round) against the paged and
     DenseBank loops, MIFA(int8) and BankedMIFA(PagedDeviceBank(int8))
     (the quantizer's exact and statistical checks on the card first), and
     the five Figure 2 fleets without the update clock; each scan run must
     be bit-equal to its loop run and launch each kernel once a replay
     plus once in the warm-up before capture; prints scan and loop ms a
     round; then the mesh phase (`mesh_phase`, lines starting `mesh `):
     in a gloo world of one rank started from a `HashStore`, on a 1x1
     `make_host_mesh(device="cuda")`, `run_fl(engine="scan", mesh=)` of
     MIFA(array) and BankedMIFA(DenseBank) (the bank takes the run's mesh)
     and `run_fleet(engine="scan", mesh=)` of the Figure 2 dense-bank
     fleet, each bit-equal to its scan run without a mesh, with the same
     launches, and its ms a round beside that run's, then a `checkpoint=`
     MIFA(array) scan whose snapshots hold the same run's without a mesh
     member for member and a MIFA(memory="int8") scan bit-equal to its
     run without a mesh (`mesh_snapshot_runs`); profiles one scan run
     each of MIFA(array) and
     BankedMIFA(dense), holding the kernels the trace shows by name to the
     launch counters and printing the device's idle share; then runs the
     main path's MIFA(array) loop again, bit-equal to its first run;
 12. drives the scenario path (`repro_torch.scenarios`): the device surface
     of every registered process at N=100 and of Bernoulli at N=10⁶ on
     the card, 32 rounds each, array-equal to the CPU host surface; one
     draw's CUDA operations, host and device time; MIFA(array) under
     Gilbert–Elliott availability (rate 0.5, bursts of 8) drawn inside
     the round for 20 rounds on the loop and the scan (20 and 21
     `mifa_aggregate` launches, bit-equal, τ statistics equal, the masks
     those of the CPU host surface, 5 rounds card vs CPU);
     BankedMIFA(DenseBank) on both engines and BankedMIFA(PagedDeviceBank)
     on the loop under cluster outages for 20 rounds (the host surface; 20
     `bank_scatter` / `paged_bank_scatter` launches, paged bit-equal to
     dense); a 3-trial Gilbert–Elliott fleet (bursts 2, 4, 8) on both
     engines for 20 rounds, bit-equal (60 `mifa_aggregate` launches on
     the loop), and a 3-trial cohort fleet under cluster outages for 20
     rounds (20 `bank_scatter_batched`); FedAR and CAFed card vs CPU;
 13. drives the runtime simulator (`repro_torch.sim`) on the paper problem
     under the registry's cluster outages, the tiered latency fleet
     (`tiered_shifted_exponential(100, seed=0)`) and
     `benchmarks/time_to_accuracy.py`'s clock (epochs of 4 s, 0.05 s
     server overhead, 64 epochs of lookahead): MIFA(array) for 20 rounds
     (SIM_ROUNDS) under each of the five policies (WaitForAll, WaitForS S=10, Deadline
     3 s, Impatient, BufferedKofN K=10) on the heap engine and on the
     compiled engine (each round replays of the epoch-fill graph as often
     as the clock asks, then the round graph), held bit-equal (close
     times, counters, applied masks, τ; cohorts those of the host draws;
     losses and params as the scan is held); 20 / 21 `mifa_aggregate`
     launches; FedBuffAvg under BufferedKofN through `run_fl(sim=)` on
     both engines; BankedMIFA(DenseBank), (PagedDeviceBank(8)) and
     (HostBank, rows pinned) on the heap engine under Impatient for 15
     rounds (SIM_SHORT_ROUNDS, as FedBuffAvg; 15 `bank_scatter`, 15
     `paged_bank_scatter`, paged bit-equal to dense,
     host within 1e-5); one cohort round of BankedMIFA(HostBank) at N =
     10⁴ (2.03 GB of pinned rows); a K=3 simulated fleet (WaitForAll,
     Impatient, BufferedKofN) each lane against its single compiled run
     (63 `mifa_aggregate`); 5 heap rounds card vs CPU; Impatient's
     simulated seconds below WaitForAll's (the paper's claim); prints ms
     a simulated round on both engines, the sync a round and the
     simulated seconds per policy;
 14. drives durability on the card (`durability_phase`, lines starting
     `durable `): a trace synthesized with the port's `synthesize_trace`
     (N=100, 64 rounds, Gilbert–Elliott rate 0.5, bursts of 6, 10% churn)
     replayed through a window of 16 rounds: MIFA(array) and
     BankedMIFA(PagedDeviceBank) for 20 rounds on the loop and the scan
     (chunks of 5; the window re-pointed in place between chunks),
     bit-equal, masks those of the CPU host surface, reads never longer
     than the window (20 / 21 `mifa_aggregate` and `paged_bank_scatter`);
     elastic fleets over the trace (K=3, MIFA(array) and
     BankedMIFA(DenseBank), 20 rounds), scan against loop and lanes
     against sequential runs (60 / 63 `mifa_aggregate`, 20 / 21
     `bank_scatter_batched`); kill and resume of MIFA(array), MIFA(int8),
     BankedMIFA(DenseBank) and a spilling BankedMIFA(PagedDeviceBank) (30
     rounds, snapshots every 10 rounds, killed after 21, resumed from 20:
     bit-equal to the uninterrupted run, 11 launches; the paged bank's rows
     read back through `paged_bank_gather`); the million-client bank
     snapshotted after 6 rounds and restored, the next 2 rounds bit-equal;
     and
     granite-3-8b (4 layers) served from a `save_pytree` snapshot loaded
     onto the card, its tokens those of the in-memory params;
 15. holds the model zoo's kernels against their plain versions on the card:
     `flash_attention` at the served shapes (zamba2-7b: B=4, S=T=2048,
     H=KV=32, hd=112; granite-3-8b: GQA 32 over 8 heads, hd=128; gemma3-4b:
     GQA 8 over 4 heads, hd=256, global and with window 1024), ragged S,
     non-causal S != T, windows of 100 and 17 keys, f32 and bf16, no NaN;
     `ssd_scan` at zamba2-7b's and
     mamba2-1.3b's shapes (p=64, n=64 and 128, Q=256), f32, a chunk of
     96, an odd S (Q=1) and zamba2's largest |dA|; times both per call at
     the served shapes beside their bounds and,
     for attention, one `scaled_dot_product_attention` call;
 16. serves zamba2-7b at full width and depth (81 layers, bf16, random
     params) through `launch.serve.serve`: 4 prompts of 2048 tokens, 16
     greedy tokens; every prefill attention call and SSD scan must launch
     the kernels (13 and 68), decode none, no other kernel; then
     mamba2-1.3b (48 scans) and granite-3-8b cut to 4 layers (4 attention
     calls, GQA g=4), printing prefill and decode times, tok/s and the
     peak device allocation;
 17. runs zamba2-7b at full width in f32, its first 6 layers, on the card
     and on the CPU (prefill logits, every cache leaf, two decode steps),
     and its first 12 layers as 2048 prompt tokens plus 128 teacher-forced
     decode steps against one prefill of 2176 tokens;
 18. trains the zoo's text models through `launch.train.train`
     (`train_phase`, lines starting `train `): granite-3-8b at full width
     (d_model 4096, vocab 49155) cut to 2 layers, bf16, N=4 clients, K=2
     local steps of 2 x 128 tokens, 3 rounds of MIFA(array): the server
     step launches `mifa_aggregate` once a round (one leaf table) and no
     other kernel runs (the training forward is the differentiable model
     path); ms a round, tokens/s and the peak allocation; one round's
     updates through the kernel against its plain version (G bit-equal);
     one client's f32 loss and gradients (1 layer) on the card against the
     CPU; `make_train_step`'s vmap mode against its sequential mode (f32);
     zamba2-7b at full width cut to 6 layers (the shared attention block
     on the path) for 2 rounds; both with `cfg.remat` on, as their configs
     say (each layer rematerialized on the backward pass), then again
     with it off: params and losses bit-equal to the remat run, or, where
     the remat-off run does not repeat itself bit for bit, within the
     training tolerance, its own spread printed (`remat_off_check`);
 19. drives gemma3-4b (`gemma_phase`, lines starting `gemma `): times
     `flash_attention` at its two prefill shapes (global, and window 1024)
     beside its bound and one `scaled_dot_product_attention` call
     (is_causal; a boolean window mask), naming the backend sdpa ran;
     serves it at full width and depth (34 layers, 4.55 B bf16 params):
     exactly 34 attention launches a prefill (29 windowed), none in
     decode, no other kernel; runs its first 6 layers (5 local, 1 global)
     at full width in f32 on the card and on the CPU over 1100 prompt
     tokens (the rings filled past their end) and two decode steps, and
     1000 prompt tokens plus 100 decode steps (the rings wrap) against
     one prefill of 1100; trains it at full width cut to 6 layers, N=2,
     for 2 rounds (one `mifa_aggregate` launch a round), printing the
     peak allocation;
 20. drives the MoE models (`moe_phase`, lines starting `moe `):
     `flash_attention` at their prefill shape (H=KV=16, hd 128) beside
     sdpa and the bound; olmoe-1b-7b and moonshot-v1-16b-a3b served at
     full width and depth (16 and 48 launches a prefill, none in decode;
     capacity and the share of assignments dropped); olmoe's first 4
     layers in f32 card vs CPU and decode vs prefill (expert ids compared
     first, a flip allowed only at a near-tie); olmoe trained at 2 layers,
     N=4, 2 rounds, and one client's f32 gradients card vs CPU;
 21. drives MLA (`mla_phase`, lines starting `mla `): `flash_attention`
     at deepseek-v2-lite-16b's prefill shape (H=KV=16, q/k head dim 192,
     v's 128) beside sdpa and the bound; the model served at full width
     and depth (27 layers, 15.65 B bf16 params: exactly 27 launches a
     prefill, none in decode, C = 960 in prefill and 1 in decode); its
     first 4 layers (one dense, three MoE) in f32 card vs CPU (logits, the
     `c` and `pe` caches, two decode steps) and the absorbed decode
     against the decompressed prefill, each within 1e-5 of the largest
     logit; trained at 2 layers, N=4, 2 rounds (one `mifa_aggregate`
     launch a round), and one client's f32 gradients card vs CPU with the
     gaps of `w_uk`, `w_uv`, `w_kpe` and the router.
 22. drives the stub frontends (`llava_phase` and `hubert_phase`, lines
     starting `llava ` and `hubert `): `flash_attention` held against its
     plain version at llava-next-34b's prefill shape (B=4, S=T=2912 =
     2880 patches + 32 tokens, not a multiple of the tiles, H=56 over
     KV=8, g = 7, hd 128) in bf16 and f32, and timed there beside sdpa
     and the bound; llava-next-34b served at full width and depth (60
     layers, 34.39 B bf16 params: exactly 60 launches a prefill, none in
     decode, the cache sized for the patches); its first layer in f32
     card vs CPU over the patches and 16 tokens and two decode steps, and
     decode vs prefill; two rounds of `make_train_step`'s sequential mode
     at 2 layers, N=2, on 2880 patches + 128 tokens; hubert-xlarge
     (non-causal, encoder-only) scored through `make_encoder_step` at
     full width and depth, its score and one client's f32 gradients card
     vs CPU at 2 layers, and two rounds of the vmap `make_train_step` at
     HUBERT_TRAIN_LAYERS layers, N=2 (one `mifa_aggregate` launch a
     round), with
     `cfg.remat` on as its config says; in each training run the client
     inactive in round 1 keeps its stored update; then one hubert round
     at HUBERT_TRAIN_LAYERS layers from the same state with remat on and
     with it off (`remat_round_pair`): ms and peak allocation of each,
     params and G bit-equal;
 23. drives the dry-run planner (`dryrun_phase`, lines starting
     `dryrun `) in a gloo world of one on a 1x1 mesh: every plan,
     qwen1.5-110b's 2-layer `decode_32k` plan made on the card, its
     prefill with and without padded heads, the `update_spec=` round
     through `launch.specs.run_placed` bit-equal to none, and
     granite-3-8b's `train_4k` vmap step (2 layers, full width) through
     `run_placed` bit-equal to the plain step with one `mifa_aggregate`
     launch (`placed_train_step`);
 24. drives split products (`split_phase`, lines
     starting `split `): `flash_attention` against its plain version and
     timed beside sdpa at each rank's heads, then a gloo world of two
     processes on this card (`split_rank`, a 1x2 mesh) serving
     granite-3-8b (4 layers, bf16; 2 layers, f32), olmoe-1b-7b (its
     experts over `model`; 4 layers bf16, 2 layers f32) and qwen1.5-110b
     (2 layers, bf16, unpadded) at full width through
     `launch.steps.make_prefill_step(model, mesh)` and
     `make_decode_step`, each rank on its blocks, against the unsplit run
     on rank 0: logits and caches within the bounds, greedy tokens equal
     but at near-ties, one `flash_attention` launch a layer a rank, each
     rank's peak allocation, the bytes its collectives moved and its
     host-staged ms; olmoe's routing recorded on both sides, every rank's
     (E, C) tables bit-equal to rank 0's and every flip of a clean token
     at a near-tie (`routing_agreement`; in bf16 against the noise floor
     of the unsplit run in f32), the outputs held where the routing
     agreed; then, in the same world, the MIFA train step on each
     rank's blocks (`launch.steps.make_train_step(model, cfg, n, k,
     mesh=)`, split products in training; N=2, 1 round, 2 x 128 tokens,
     remat on): olmoe-1b-7b's vmap step (1 layer f32), granite-3-8b's
     (2 layers bf16),
     gemma3-4b's (2 layers bf16, the vocab-split cross-entropy) and
     granite's sequential step through the planner (2 layers bf16, K=1,
     its update constraint), each against the unsplit step run by rank 0
     alone after the split run freed its memory (params, G and the
     losses within the bounds); `mifa_aggregate` exactly once a round on
     each rank in vmap mode, on G's blocks, and one more server step (on
     seeded updates) held against `mifa_aggregate_ref` on the same blocks;
     each rank's peak
     allocation, the bytes it moved a round by kind (all-reduce,
     all-gather, relayout) and its host-staged ms a round; then, in the
     same world, the federated round on each rank's blocks
     (`run_fl(engine="scan", mesh=1x2, cfg=)`, lines `split fl `; K=2,
     2 x 128 tokens, inv_t(0.02)): olmoe-1b-7b MIFA(array) (1 layer f32,
     N=2, 2 rounds in a scan chunk of 2, Bernoulli availability),
     granite-3-8b BankedMIFA(DenseBank(mesh=, cfg=)) (2 layers bf16, N=4,
     C=2, 3 rounds: a chunk of 2, then a partial one), gemma3-4b
     MIFA(array) (2 layers bf16, vocab split, 2 rounds) and
     BankedMIFA(PagedDeviceBank) (1 layer bf16, held whole, 2 rounds),
     each against the unsplit run by rank 0 alone after (params, G or the
     bank's rows and G_sum and the losses within the bounds, n_active
     exact); every round eager (none replayed: gloo cannot be captured),
     `mifa_aggregate`, `bank_scatter` or `paged_bank_scatter` exactly once
     a round on each rank, the MIFA runs' one more server step on G's
     blocks against `mifa_aggregate_ref`, each rank's peak below the
     unsplit run's (but the paged bank's, whole on every rank), the bytes
     moved by kind and the host-staged ms a round; then the fleets on
     each rank's blocks (`run_fleet(engine="scan", mesh=1x2, cfg=)`,
     lines `split fleet `; 1 layer bf16, 2 trials under vmap, N=2, 2
     rounds): olmoe-1b-7b MIFA(array), granite-3-8b BankedMIFA(DenseBank)
     and BankedMIFA(PagedDeviceBank), the state whole on every rank, each
     against the unsplit fleet on rank 0; the bf16 MoE fleet's forward
     routing held as the serving runs' is (`split_forward_routing`; the
     f32 MoE runs are held by their f32 parity); a bf16 leaf beyond the
     bound only within twice the same rounds' own gap through the unsplit
     train step's other mode, on masks drawn anew and checked equal.
It exits non-zero on any failure. Its last two lines are one JSON object per
kernel list, then {"ok": true, "device": {...}}. It imports no JAX. Its
rows are line-buffered, each phase prints its start time (`start <phase>
at <s> s`) before it runs, and a run still going after WATCHDOG_S seconds
prints every thread's stack to stderr and exits with code 1.
"""
from __future__ import annotations

import faulthandler
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, f32 outside the tensor
# cores (the bank kernels' adds and subtracts) and dense bf16 on the tensor
# cores (flash attention and the SSD scan in bf16).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
L2_BYTES = 50e6

N_CLIENTS = 100
# flattened leaf widths of paper_mlp in leaf order: layers[0].b,
# layers[0].w (256x128), layers[1].b, layers[1].w (128x128), out.b,
# out.w (128x10)
PATH_WIDTHS = [128, 32768, 128, 16384, 10, 1280]
ROUNDS = 20
CPU_ROUNDS = 5
# the Figure 2 fleets: trials of seeds 0-2 with participation seeds 100+s
# (benchmarks/fig2_convergence.py:41); the cohort fleets and their
# sequential runs pin the cohort width at 64 (a round's |A| is about 38)
FLEET_SEEDS = (0, 1, 2)
FLEET_ROUNDS, FLEET_CPU_ROUNDS, FLEET_CAP = 20, 10, 64
# MIFA(array) and BankedMIFA(dense) agree in exact arithmetic; in fp32 the
# bank keeps G_sum incrementally while the dense step re-sums all N rows, so
# the trajectories drift apart by reduction-order rounding over the rounds.
ANCHOR_RTOL, ANCHOR_ATOL = 1e-3, 1e-5
# card vs CPU: fp32 on both, with matmuls and reductions blocked
# differently; the rounding differences pass through 25 SGD steps at
# learning rates up to 1.0 (inv_t), which moves single params by a few 1e-5
# on |params| < 0.5, while the losses stay within 1e-6
DEVICE_RTOL, DEVICE_ATOL = 1e-4, 1e-4
# kernel vs plain version. Selected and copied values (G, bank rows) must be
# bit-equal. Sums are taken in another order, which moves an f32 sum of n
# terms by up to about n·eps·Σ|terms|, so the relative tolerance applies to
# the sum of the magnitudes of the terms (plus |w| for w): f32 results
# rtol 1e-5, atol 1e-6; bf16 results may land one bf16 rounding apart,
# rtol 1e-2.
TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1e-2, 1e-2)}
# rows per page on every paged run
PAGE_SIZE = 8
# the scan engine: rounds a chunk holds (a chunk's batches of the dense
# path take 51.2 MB a round on the card; the paths' runs of ROUNDS rounds
# time their middle two chunks); rounds of each profiled scan run;
# a scan run is held bit-equal to its loop run, or else within SCAN_RTOL
# of the magnitudes of the losses and params (and the gap reported)
SCAN_CHUNK, PROFILE_ROUNDS, SCAN_RTOL = 5, 20, 1e-5
# a captured round has one shape: the scan pads every cohort to one width,
# the N-client bucket when none is pinned, while the loop pads each round
# to its own power-of-two bucket (64 mostly, 128 in the all-active round
# 0), and local training's sums group by the padded length. So the cohort
# runs that scan and the loop runs they are held to both pin SCAN_CAP
SCAN_CAP = 128
# int8 memory: its stochastic rounding moves each stored update by at most
# one quantum (absmax/127 of its row); on the CPU tests' smaller problem
# the int8 runs' losses stayed within 3.4e-3 (relative) of MIFA(array)'s
# over 20 rounds, and within 1.1e-2 over three model seeds
INT8_LOSS_RTOL = 2e-2
# eviction phase: N=1024 clients in 128 logical pages. A round's 64 ids (32
# from the hot set of ids < 128, i.e. 16 pages, and 32 uniform over the
# rest) span at most 16 + 32 = 48 pages, so 48 slots is the least that holds
# every round; 128 pages over 48 slots force evictions and re-faults
EVICT_N, EVICT_HOT, EVICT_C, EVICT_SLOTS, EVICT_ROUNDS = 1024, 128, 64, 48, 40
# million-client phase; its page pool is (n_slots+1)·page_size·d·4 bytes
# with d = sum(PATH_WIDTHS) = 50,698
MILLION_N, MILLION_C, MILLION_SLOTS, MILLION_ROUNDS = 10**6, 64, 256, 8
MILLION_POOL_BYTES = 416_940_352
# the served models: SERVE_B prompts of SERVE_PROMPT tokens, SERVE_NEW
# greedy tokens; granite-3-8b's depth cut to GRANITE_LAYERS
SERVE_B, SERVE_PROMPT, SERVE_NEW, GRANITE_LAYERS = 4, 2048, 16, 4
# card vs CPU at ZOO_CHECK_S tokens; decode vs prefill over DVP_PROMPT
# prompt tokens and DVP_STEPS decode steps (2176 = 17 chunks of 128)
ZOO_CHECK_S, DVP_PROMPT, DVP_STEPS = 512, 2048, 128
# gemma3-4b: its local layers' window; its checks at full width with the
# depth cut to GEMMA_CHECK_LAYERS (five local layers and the first global
# one), f32: card vs CPU over a prompt of GEMMA_CHECK_S > the window (the
# prefill fills the rings past their end) and two decode steps; decode vs
# prefill from GEMMA_DVP_PROMPT < the window through GEMMA_DVP_STEPS steps
# (the rings wrap during decode); GEMMA_TRAIN_ROUNDS rounds of train() at
# GEMMA_TRAIN_LAYERS with GEMMA_TRAIN_N clients: the untied 262144-token
# embedding and head (1.34 B params) put 26 B a param (G and the update
# sums in f32, a bf16 copy of weights and gradients a client) near 35 GB
# before any layer, so N=4 would not fit a card
GEMMA_WINDOW, GEMMA_CHECK_LAYERS, GEMMA_CHECK_S = 1024, 6, 1100
GEMMA_DVP_PROMPT, GEMMA_DVP_STEPS = 1000, 100
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_N, GEMMA_TRAIN_ROUNDS = 6, 2, 2
# olmoe-1b-7b's checks at full width in f32 with the depth cut to
# MOE_CHECK_LAYERS (7.5 GB of params on each side): card vs CPU over a
# prompt of MOE_CHECK_S tokens and two decode steps; decode vs prefill from
# MOE_DVP_PROMPT through MOE_DVP_STEPS steps at capacity factor E/k, where
# C = T and nothing drops (at the served factor a prefill and a decode
# step route under different capacities); MOE_TRAIN_ROUNDS rounds of
# train() at MOE_TRAIN_LAYERS with MOE_TRAIN_N clients. A routing flip
# between two runs is allowed only where the reference side's gap between
# its k-th and (k+1)-th router probability is below MOE_TIE_GAP
MOE_CHECK_LAYERS, MOE_CHECK_S = 4, 512
MOE_DVP_PROMPT, MOE_DVP_STEPS = 256, 32
MOE_TRAIN_LAYERS, MOE_TRAIN_N, MOE_TRAIN_ROUNDS = 2, 4, 2
MOE_TIE_GAP = 1e-5
# deepseek-v2-lite-16b's MLA prefill attention: B, S=T, H, KV, q/k head
# dim (nope 128 + rope 64) and v's head dim; its card vs CPU and decode vs
# prefill (MOE_CHECK_LAYERS layers, f32: layer 0 dense, then MoE) are held
# within MLA_RTOL of the largest logit
MLA_SHAPE = (SERVE_B, SERVE_PROMPT, 16, 16, 192, 128)
MLA_RTOL = 1e-5
# llava-next-34b (vision_text: the stub frontend's 2880 patch embeddings
# prepended to the text) served at SERVE_B prompts of LLAVA_PROMPT tokens
# and LLAVA_NEW greedy tokens: its prefill attends over S = T = 2912
# positions, 22.75 tiles of 128 rows, at GQA g = 56 / 8 = 7 (LLAVA_SHAPE:
# B, S, H, KV, hd). Its checks at full width in f32 with the depth cut to
# LLAVA_CHECK_LAYERS: card vs CPU over the patches, LLAVA_CHECK_PROMPT
# tokens and two decode steps, and decode vs prefill from that prompt
# through LLAVA_DVP_STEPS steps. Trained through make_train_step's
# sequential mode (its config's) at LLAVA_TRAIN_LAYERS layers, with
# LLAVA_TRAIN_N clients, one local step on one sequence of the patches and
# LLAVA_TRAIN_TEXT tokens, for STUB_TRAIN_ROUNDS rounds
LLAVA_PROMPT, LLAVA_NEW = 32, 16
LLAVA_SHAPE = (SERVE_B, 2880 + LLAVA_PROMPT, 56, 8, 128)
LLAVA_CHECK_LAYERS, LLAVA_CHECK_PROMPT, LLAVA_DVP_STEPS = 1, 16, 16
LLAVA_TRAIN_LAYERS, LLAVA_TRAIN_N, LLAVA_TRAIN_TEXT = 2, 2, 128
# hubert-xlarge (audio, encoder-only, non-causal): scored through
# make_encoder_step at full width and depth on HUBERT_SCORE_B x
# HUBERT_SCORE_S frames; card vs CPU (the score, and one client's f32
# loss and gradients) at HUBERT_CHECK_LAYERS layers; STUB_TRAIN_ROUNDS
# rounds of make_train_step's vmap mode at HUBERT_TRAIN_LAYERS with
# HUBERT_TRAIN_N clients (cut from its 16: at full depth the f32 update
# array G and the clients' f32 update sums take 5.06 GB a client each, and
# every client's bf16 weights
# and gradients and activations come on top), K = 2 local steps (its
# fl_local_steps) of HUBERT_TRAIN_MB x HUBERT_TRAIN_S frames
HUBERT_SCORE_B, HUBERT_SCORE_S, HUBERT_CHECK_LAYERS = 4, 1024, 2
HUBERT_TRAIN_N, HUBERT_TRAIN_MB, HUBERT_TRAIN_S = 2, 2, 512
# the training rounds' and the remat pair's depth: half of hubert's 48
# layers, so the remat round's params and G stay
# on the card beside the round without remat (at full depth they waited on
# the host, 75.40 GB the round without remat) and a client's G row goes to
# the host in half the time
HUBERT_TRAIN_LAYERS = 24
# the stub-frontend training rounds: every client active in round 0, only
# client 0 in round 1 (client 1's stored update must stay as round 0 left
# it)
STUB_TRAIN_ROUNDS, STUB_MASKS = 2, ((True, True), (True, False))
# kernel vs plain version, |err| <= atol + rtol·|ref| as (atol, rtol).
# Attention: f32 (2e-5, 0), FMAs and einsum sum in other orders; bf16
# (2e-2, 1e-2), the kernel rounds the probabilities to bf16 before P·V, as
# the TPU kernel does, where the plain version keeps f32, and that can move
# the bf16 output by one step, up to 2^-7 of |out|.
# The scan: |err| <= rtol · scale + 1e-6, scale being the plain version
# run on |x|, |B|, |C| (the summed magnitudes of the terms). The
# within-chunk cumsum of dA runs in another order on each side; at |cum| ~
# 200 one f32 step is 1.5e-5 and the two sums drift apart by up to about
# 1e-4, which exp(cum_i - cum_j) turns into a relative error of every term:
# f32 rtol 5e-4 (also h_final, always f32). bf16 y can land one bf16 step
# (up to 2^-7 of |y| <= scale) from the plain version's: rtol 1e-2.
ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 1e-2)}
SSD_RTOL = {torch.float32: 5e-4, torch.bfloat16: 1e-2}
# served models in f32, card against CPU and decode against prefill: max
# |d| / max |value| <= 1e-3. Both sides are f32, but zamba2's A reaches
# -112, so the within-chunk cumsum of dA reaches |cum| ~ 1e3 where one f32
# step is 1.2e-4, and exp(cum_i - cum_j) (or the decode recurrence's
# product of exp(dA)) carries that relative error into the scan
ZOO_RTOL = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# --------------------------------------------------------------------------- #
# the paper's problem, rebuilt from the port's modules
# --------------------------------------------------------------------------- #

def paper_problem(model_name: str = "paper_mlp", *, n_clients: int = N_CLIENTS,
                  p_min: float = 0.1, n_per_class: int = 500,
                  batch_size: int = 100, k_steps: int = 5, seed: int = 0,
                  device: str = "cuda"):
    """The paper §7 setup on synthetic non-iid data: N clients with 2 classes
    each, label-correlated Bernoulli availability, batch 100."""
    from repro_torch.configs import get_config
    from repro_torch.core import label_correlated_probs
    from repro_torch.data import (ClientBatcher, label_skew_partition,
                                  make_classification)
    from repro_torch.models import build_model

    cfg = get_config(model_name).replace(fl_clients=n_clients)
    model = build_model(cfg)
    X, y = make_classification(10, cfg.d_model, n_per_class, noise=1.0,
                               seed=seed)
    Xte, yte = make_classification(10, cfg.d_model, 100, noise=1.0,
                                   seed=seed + 1000)
    idx, labels = label_skew_partition(y, n_clients, seed=seed)
    probs = label_correlated_probs(labels, p_min=p_min)
    batcher = ClientBatcher(X, y, idx, batch_size=batch_size, k_steps=k_steps,
                            seed=seed)
    # the features come back as float64 under numpy 2 promotion; the
    # reference's eval feeds them through jnp.asarray, i.e. as float32
    test = {"x": torch.from_numpy(Xte).to(device, torch.float32),
            "y": torch.from_numpy(yte).to(device)}

    def eval_fn(params):
        with torch.no_grad():
            loss, _ = model.loss_fn(params, test)
            return float(loss), float(model.accuracy(params, test))

    eval_fn.eval_batch = test            # for the fleets' vmapped eval
    return model, batcher, probs, eval_fn


class TimedParticipation:
    """Bernoulli availability that stamps the host clock as each round
    starts; every round ends in a device sync (the history reads the round's
    loss), so consecutive stamps bound one whole round."""

    def __init__(self, inner):
        self.inner = inner
        self.stamps: list[float] = []

    def sample(self, t: int) -> np.ndarray:
        self.stamps.append(time.perf_counter())
        return self.inner.sample(t)


# --------------------------------------------------------------------------- #
# kernel checks and timing
# --------------------------------------------------------------------------- #

def time_round_ms(calls, iters: int = 20) -> float:
    """Device ms for one pass over `calls`, from a CUDA graph of the calls
    replayed `iters` times between CUDA events (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(set_bytes: int) -> int:
    """Input sets to cycle through so each launch finds its inputs outside
    the 50 MB L2 cache, as the round does after local training."""
    return int(min(32, max(2, math.ceil(3 * L2_BYTES / set_bytes))))


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mifa_inputs(gen, n, m, g_dtype, w_dtype, active):
    dev = "cuda"
    g = torch.randn((n, m), generator=gen, device=dev).to(g_dtype)
    u = torch.randn((n, m), generator=gen, device=dev)
    w = torch.randn((m,), generator=gen, device=dev).to(w_dtype)
    return g, u, active, w


def check_mifa(gen, active_path) -> tuple[float, list]:
    from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                    mifa_aggregate_ref)
    n, eta = N_CLIENTS, 0.07
    none_active = torch.zeros(n, dtype=torch.bool, device="cuda")
    cases = [(m, torch.float32, torch.float32, active_path, "path")
             for m in sorted(set(PATH_WIDTHS))]
    cases += [(1000, torch.float32, torch.float32, active_path, "ragged"),
              (1000, torch.float32, torch.float32, none_active, "none active"),
              (32768, torch.bfloat16, torch.float32, active_path, "bf16 G"),
              (1000, torch.bfloat16, torch.float32, active_path,
               "bf16 G ragged"),
              (1000, torch.bfloat16, torch.bfloat16, active_path,
               "bf16 G and w")]
    max_err, rows = 0.0, []
    for m, gdt, wdt, act, label in cases:
        g, u, act, w = mifa_inputs(gen, n, m, gdt, wdt, act)
        g_ref, w_ref = mifa_aggregate_ref(g, u, act, w, eta)
        g_k, w_k = mifa_aggregate(g.clone(), u, act, w, eta)
        torch.cuda.synchronize()
        check(torch.equal(g_k, g_ref), f"mifa_aggregate G differs ({label}, "
                                       f"M={m})")
        rtol, atol = TOL[wdt]
        err = (w_k.float() - w_ref.float()).abs()
        scale = w.float().abs() + eta * g_ref.float().abs().mean(0)
        check(bool((err <= atol + rtol * scale).all()),
              f"mifa_aggregate w off by {err.max().item():.3e} ({label}, "
              f"M={m})")
        max_err = max(max_err, err.max().item())
        rows.append(f"mifa_aggregate {label:<14} N={n} M={m:<6} G {gdt} "
                    f"w {wdt}: G bit-equal, max |dw| {err.max().item():.3e}")
    return max_err, rows


# the tree cases of the leaf-table kernels: name -> [(M, stored dtype, w
# dtype)]; "split" has more leaves than one table holds (64), so it takes
# two launches
F32, BF16 = torch.float32, torch.bfloat16
TREE_CASES = {
    "paper_mlp": [(m, F32, F32) for m in PATH_WIDTHS],
    "mixed": [(128, BF16, F32), (32768, F32, BF16), (1000, BF16, BF16),
              (10, F32, F32), (16384, BF16, F32)],
    "ragged": [(10, F32, F32), (1000, F32, F32)],
    "one leaf": [(32768, F32, F32)],
    "split": [((37 * j) % 300 + 1, (F32, BF16)[j % 2], F32)
              for j in range(70)]}


def n_tables(n_leaves: int) -> int:
    from repro_torch.kernels.leaf_table import MAX_LEAVES
    return -(-n_leaves // MAX_LEAVES)


def check_mifa_tree(gen, active_path) -> tuple[float, list]:
    """`mifa_aggregate_leaves` (one launch per table of leaves) against the
    per-leaf plain version on the card: G bit-equal, w within TOL, the
    launches one per table, and a repeated call bit-identical."""
    from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                    mifa_aggregate_leaves,
                                                    mifa_aggregate_ref)
    n, eta = N_CLIENTS, 0.07
    none_active = torch.zeros(n, dtype=torch.bool, device="cuda")
    cases = [(name, leaves, active_path)
             for name, leaves in TREE_CASES.items()]
    cases.append(("nothing active", TREE_CASES["paper_mlp"], none_active))
    max_err, rows = 0.0, []
    for name, leaves, act in cases:
        ins = [mifa_inputs(gen, n, m, gdt, wdt, act)
               for m, gdt, wdt in leaves]
        gs, us, ws = ([x[i] for x in ins] for i in (0, 1, 3))
        before = mifa_aggregate.launches
        g_k, w_k = mifa_aggregate_leaves([g.clone() for g in gs], us, act,
                                         ws, eta)
        g_2, w_2 = mifa_aggregate_leaves([g.clone() for g in gs], us, act,
                                         ws, eta)
        torch.cuda.synchronize()
        launches = mifa_aggregate.launches - before
        check(launches == 2 * n_tables(len(leaves)),
              f"mifa_aggregate tree {name}: {launches} launches for two "
              f"calls on {len(leaves)} leaves")
        err = 0.0
        for j, (g, u, w) in enumerate(zip(gs, us, ws)):
            g_ref, w_ref = mifa_aggregate_ref(g, u, act, w, eta)
            check(torch.equal(g_k[j], g_ref),
                  f"mifa_aggregate tree {name}: G of leaf {j} differs")
            rtol, atol = TOL[w.dtype]
            d = (w_k[j].float() - w_ref.float()).abs()
            scale = w.float().abs() + eta * g_ref.float().abs().mean(0)
            check(bool((d <= atol + rtol * scale).all()),
                  f"mifa_aggregate tree {name}: w of leaf {j} off by "
                  f"{d.max().item():.3e}")
            check(torch.equal(g_2[j], g_k[j]) and torch.equal(w_2[j],
                                                              w_k[j]),
                  f"mifa_aggregate tree {name}: a repeated call differs "
                  f"(leaf {j})")
            err = max(err, d.max().item())
        max_err = max(max_err, err)
        rows.append(f"mifa_aggregate tree {name:<14} {len(leaves)} leaves "
                    f"(M {sum(m for m, _, _ in leaves)}), |A|="
                    f"{int(act.sum())}: {launches // 2} launch(es) a call, "
                    f"G bit-equal, max |dw| {err:.3e}, repeat bit-identical")
    return max_err, rows


def time_path(kernel, plain, sets, leaf_bytes, leaf_ops,
              library=None, tree=None) -> dict:
    """Time `kernel` and `plain` (and `library`, one PyTorch call for the
    same function, where there is one) over the main path's leaves: per
    round (the 6 leaves back to back, or one call of `tree` on a set's
    per-leaf arguments where the kernel takes a whole tree in one launch)
    and per launch at each leaf's shape. `sets` holds copies of the
    per-leaf arguments, cycled so that each launch finds its inputs
    cold."""
    n = len(sets)
    fns = {"": kernel, "plain_": plain}
    if library is not None:
        fns["library_"] = library
    rounds = {k: lambda s, f=f: [f(*a) for a in s] for k, f in fns.items()}
    if tree is not None:
        rounds[""] = tree
    out = {f"{k}ms": time_round_ms([lambda s=s, f=f: f(s) for s in sets]) / n
           for k, f in rounds.items()}
    out["library_ms"] = out.get("library_ms")
    out["bound_ms"], out["bound_by"] = bound(sum(leaf_bytes), sum(leaf_ops))
    out["bytes"] = sum(leaf_bytes)
    out["leaves"] = []
    for j, m in enumerate(PATH_WIDTHS):
        leaf = {f"{k}us": time_round_ms([lambda a=s[j], f=f: f(*a)
                                         for s in sets]) / n * 1e3
                for k, f in fns.items()}
        leaf["bound_us"] = bound(leaf_bytes[j], leaf_ops[j])[0] * 1e3
        out["leaves"].append({"M": m, **leaf})
    return out


def time_mifa(gen, active_path) -> dict:
    """The dense server step on the main path: paper_mlp's six leaves at
    N=100 with this run's active mask, in one launch a round (and one
    launch per leaf for the per-launch times)."""
    from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                    mifa_aggregate_leaves,
                                                    mifa_aggregate_ref)
    n, eta = N_CLIENTS, 0.07
    n_act = int(active_path.sum())
    set_bytes = sum(2 * n * m * 4 for m in PATH_WIDTHS)
    sets = [[mifa_inputs(gen, n, m, torch.float32, torch.float32,
                         active_path) for m in PATH_WIDTHS]
            for _ in range(n_copies(set_bytes))]
    leaf_bytes = [n_act * m * 4 + (n - n_act) * m * 4   # U or G read
                  + n_act * m * 4                       # active rows of G
                  + 2 * m * 4 + n                       # w, w_new, mask
                  for m in PATH_WIDTHS]
    leaf_ops = [n * m + 2 * m for m in PATH_WIDTHS]
    # the kernel reads its rate from the card, as in the rounds
    eta_dev = torch.full((), eta, device="cuda")
    return time_path(
        lambda *a: mifa_aggregate(*a, eta_dev),
        lambda *a: mifa_aggregate_ref(*a, eta), sets, leaf_bytes, leaf_ops,
        tree=lambda s: mifa_aggregate_leaves(
            [a[0] for a in s], [a[1] for a in s], active_path,
            [a[3] for a in s], eta_dev))


def bank_inputs(gen, r, m, c, bank_dtype, ids, valid):
    bank = torch.randn((r, m), generator=gen, device="cuda").to(bank_dtype)
    u = torch.randn((c, m), generator=gen, device="cuda")
    return bank, u, ids, valid


def cohort(active_path) -> tuple[torch.Tensor, torch.Tensor]:
    """The runner's padded cohort for a mask: active ids, then pad slots at
    the dummy row N up to the power-of-two bucket."""
    from repro_torch.core.runner import pad_cohort
    padded, valid = pad_cohort(np.flatnonzero(active_path.cpu().numpy()),
                               N_CLIENTS)
    return (torch.from_numpy(padded).cuda(), torch.from_numpy(valid).cuda())


def check_bank(gen, active_path) -> tuple[float, list]:
    """`bank_scatter` on one leaf against its plain version on the card:
    rows bit-equal, dsum within TOL and bit-equal to the fixed-order
    oracle."""
    from repro_torch.kernels.bank_scatter import (bank_scatter,
                                                  bank_scatter_ordered_ref,
                                                  bank_scatter_ref)
    r = N_CLIENTS + 1
    path = cohort(active_path)
    ids, valid = path
    all_pad = (ids, torch.zeros_like(valid))
    # C=64 with 37 valid slots, then 27 pads at the dummy row N
    picks = torch.randperm(N_CLIENTS, generator=torch.Generator().manual_seed(
        37))[:37]
    c64 = cohort(torch.zeros(N_CLIENTS, dtype=torch.bool).index_fill_(
        0, picks, True))
    cases = [(m, torch.float32, path, "path")
             for m in sorted(set(PATH_WIDTHS))]
    cases += [(1000, torch.float32, path, "ragged"),
              (1000, torch.float32, all_pad, "all pad"),
              (32768, torch.float32, c64, "C=64, 37 valid"),
              (32768, torch.bfloat16, path, "bf16 bank"),
              (1000, torch.bfloat16, c64, "bf16 ragged")]
    max_err, rows = 0.0, []
    for m, bdt, (ids, val), label in cases:
        bank, u, _, _ = bank_inputs(gen, r, m, len(ids), bdt, ids, val)
        b_ref, d_ref = bank_scatter_ref(bank, u, ids, val)
        b_k, d_k = bank_scatter(bank.clone(), u, ids, val)
        torch.cuda.synchronize()
        check(torch.equal(b_k, b_ref), f"bank_scatter rows differ ({label}, "
                                       f"M={m})")
        check(torch.equal(d_k, bank_scatter_ordered_ref(bank, u, ids,
                                                        val)[1]),
              f"bank_scatter dsum is not bit-equal to the fixed-order "
              f"oracle ({label}, M={m})")
        rtol, atol = TOL[torch.float32]           # dsum is f32 for any bank
        err = (d_k - d_ref).abs()
        terms = u.to(bdt).float() - bank[ids].float()
        scale = (terms.abs() * val.reshape(-1, 1)).sum(0)
        check(bool((err <= atol + rtol * scale).all()),
              f"bank_scatter dsum off by {err.max().item():.3e} ({label}, "
              f"M={m})")
        max_err = max(max_err, err.max().item())
        rows.append(f"bank_scatter   {label:<14} R={r} C={len(ids)} "
                    f"valid={int(val.sum())} M={m:<6} bank {bdt}: rows "
                    f"bit-equal, max |d dsum| {err.max().item():.3e}, dsum "
                    f"bit-equal to the oracle")
    return max_err, rows


def time_bank(gen, active_path) -> dict:
    """The cohort bank update on the main path: paper_mlp's six leaves in
    one launch a round (and one launch per leaf for the per-launch times),
    the runner's padded cohort for this run's active mask."""
    from repro_torch.kernels.bank_scatter import (bank_scatter,
                                                  bank_scatter_leaves,
                                                  bank_scatter_ref)
    r = N_CLIENTS + 1
    ids, valid = cohort(active_path)
    c, n_valid = len(ids), int(valid.sum())
    set_bytes = sum((r + c) * m * 4 for m in PATH_WIDTHS)
    sets = [[bank_inputs(gen, r, m, c, torch.float32, ids, valid)
             for m in PATH_WIDTHS] for _ in range(n_copies(set_bytes))]
    # rows (read old, read update, write new), dsum, ids and valid
    leaf_bytes = [3 * n_valid * m * 4 + m * 4 + c * 9 for m in PATH_WIDTHS]
    leaf_ops = [2 * n_valid * m for m in PATH_WIDTHS]
    return time_path(bank_scatter, bank_scatter_ref, sets, leaf_bytes,
                     leaf_ops, tree=lambda s: bank_scatter_leaves(
                         [a[0] for a in s], [a[1] for a in s], ids, valid))


def path_table() -> tuple[torch.Tensor, int]:
    """The paged paper path's page table: N=100 clients in 13 pages of 8,
    all resident (n_slots=None), faulted in at round 0 in page order, so
    page p sits in slot p; entry 13 is the dummy page. Returns (table,
    n_slots)."""
    lp = -(-N_CLIENTS // PAGE_SIZE)
    return torch.arange(lp + 1, dtype=torch.int32, device="cuda"), lp


def path_lids(active_path) -> tuple[torch.Tensor, torch.Tensor]:
    """The runner's padded cohort as the paged bank hands it to the
    kernels: pad slots remapped to the dummy logical row."""
    ids, valid = cohort(active_path)
    dummy_lrow = -(-N_CLIENTS // PAGE_SIZE) * PAGE_SIZE
    return torch.where(ids >= N_CLIENTS, dummy_lrow, ids).int(), valid


def shuffled_layout(rng, n_valid: int, n_slots: int = 16, lp: int = 32,
                    c: int = 64):
    """A non-identity page table: 16 of 32 logical pages resident in
    shuffled slots, the others at the sentinel (the dummy slot). A cohort of
    c slots: n_valid distinct rows of resident pages, five pads at rows of
    non-resident pages (a gather reads zeros there), the rest at the dummy
    logical row. Returns (table, n_slots, lids, valid) on the card."""
    pt = np.full(lp + 1, n_slots, np.int32)
    res = rng.choice(lp, n_slots, replace=False)
    pt[res] = rng.permutation(n_slots)
    res_rows = (res[:, None] * PAGE_SIZE + np.arange(PAGE_SIZE)).ravel()
    away = np.setdiff1d(np.arange(lp), res)
    lids = np.full(c, lp * PAGE_SIZE, np.int32)
    lids[:n_valid] = rng.choice(res_rows, n_valid, replace=False)
    lids[n_valid:n_valid + 5] = away[:5] * PAGE_SIZE + 3
    return (torch.from_numpy(pt).cuda(), n_slots,
            torch.from_numpy(lids).cuda(),
            torch.from_numpy(np.arange(c) < n_valid).cuda())


def pages_inputs(gen, n_slots, m, c, dtype):
    """Random pages with the dummy page at zero, and f32 updates."""
    pages = torch.randn(((n_slots + 1) * PAGE_SIZE, m), generator=gen,
                        device="cuda").to(dtype)
    pages[n_slots * PAGE_SIZE:] = 0
    return pages, torch.randn((c, m), generator=gen, device="cuda")


def check_paged(gen, active_path) -> tuple[float, float, list]:
    """Both paged kernels against their plain versions on the card: pages
    and gathered rows bit-equal, dsum within TOL."""
    from repro_torch.kernels.paged_bank import (
        paged_bank_gather, paged_bank_gather_ref, paged_bank_scatter,
        paged_bank_scatter_ordered_ref, paged_bank_scatter_ref)
    rng = np.random.default_rng(5)
    pt, n_slots = path_table()
    path = (pt, n_slots, *path_lids(active_path))
    cases = [(m, torch.float32, path, "path")
             for m in sorted(set(PATH_WIDTHS))]
    cases += [(1000, torch.float32, shuffled_layout(rng, 37),
               "shuffled ragged"),
              (1000, torch.float32, shuffled_layout(rng, 0),
               "shuffled pad"),
              (32768, torch.float32, shuffled_layout(rng, 37),
               "C=64, 37 valid"),
              (32768, torch.bfloat16, path, "bf16 pages"),
              (1000, torch.bfloat16, shuffled_layout(rng, 37),
               "bf16 shuffled")]
    ps = PAGE_SIZE
    s_err, g_err, rows = 0.0, 0.0, []
    for m, dt, (pt, n_slots, lids, val), label in cases:
        pages, u = pages_inputs(gen, n_slots, m, len(lids), dt)
        p_ref, d_ref = paged_bank_scatter_ref(pages, u, pt, lids, val,
                                              page_size=ps)
        p_k, d_k = paged_bank_scatter(pages.clone(), u, pt, lids, val,
                                      page_size=ps)
        r_ref = paged_bank_gather_ref(pages, pt, lids, page_size=ps)
        r_k = paged_bank_gather(pages, pt, lids, page_size=ps)
        torch.cuda.synchronize()
        where = f"({label}, M={m}, {dt})"
        check(torch.equal(p_k, p_ref), f"paged_bank_scatter pages differ "
                                       f"{where}")
        check(not p_k[n_slots * ps:].any(), f"paged_bank_scatter wrote the "
                                            f"dummy page {where}")
        check(torch.equal(d_k, paged_bank_scatter_ordered_ref(
            pages, u, pt, lids, val, page_size=ps)[1]),
              f"paged_bank_scatter dsum is not bit-equal to the fixed-order "
              f"oracle {where}")
        check(torch.equal(r_k, r_ref), f"paged_bank_gather rows differ "
                                       f"{where}")
        rtol, atol = TOL[torch.float32]           # dsum is f32 for any pages
        err = (d_k - d_ref).abs()
        terms = (u.to(dt).float() - r_ref).abs() * val.reshape(-1, 1)
        check(bool((err <= atol + rtol * terms.sum(0)).all()),
              f"paged_bank_scatter dsum off by {err.max().item():.3e} "
              f"{where}")
        s_err = max(s_err, err.max().item())
        g_err = max(g_err, (r_k - r_ref).abs().max().item())
        rows.append(f"paged_bank     {label:<15} slots={n_slots} "
                    f"C={len(lids)} valid={int(val.sum())} M={m:<6} pages "
                    f"{dt}: pages and gathered rows bit-equal, max |d dsum| "
                    f"{err.max().item():.3e}, dsum bit-equal to the oracle")
    return s_err, g_err, rows


def check_gather_tree(gen, active_path) -> tuple[float, list]:
    """`paged_bank_gather_leaves` (one launch per table of leaves) against
    the per-leaf plain version on the card, on the path's page table and
    on shuffled ones with pages that are not resident: rows bit-equal, the
    rows of non-resident pages zero, the launches one per table, a repeated
    call bit-identical."""
    from repro_torch.kernels.paged_bank import (paged_bank_gather,
                                                paged_bank_gather_leaves,
                                                paged_bank_gather_ref)
    rng = np.random.default_rng(19)
    pt, n_slots = path_table()
    path = (pt, n_slots, *path_lids(active_path))
    cases = [(name, leaves, path if name == "paper_mlp"
              else shuffled_layout(rng, 37))
             for name, leaves in TREE_CASES.items()]
    cases.append(("ragged, C=200", TREE_CASES["ragged"],
                  shuffled_layout(rng, 37, c=200)))
    g_err, rows = 0.0, []
    for name, leaves, (pt, n_slots, lids, _) in cases:
        pages = [pages_inputs(gen, n_slots, m, 1, dt)[0]
                 for m, dt, _ in leaves]
        before = paged_bank_gather.launches
        r_k = paged_bank_gather_leaves(pages, pt, lids, page_size=PAGE_SIZE)
        r_2 = paged_bank_gather_leaves(pages, pt, lids, page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        launches = paged_bank_gather.launches - before
        check(launches == 2 * n_tables(len(leaves)),
              f"paged_bank_gather tree {name}: {launches} launches for two "
              f"calls on {len(leaves)} leaves")
        away = pt[lids // PAGE_SIZE] == n_slots
        for j, p in enumerate(pages):
            r_ref = paged_bank_gather_ref(p, pt, lids, page_size=PAGE_SIZE)
            check(torch.equal(r_k[j], r_ref),
                  f"paged_bank_gather tree {name}: rows of leaf {j} differ")
            check(not r_k[j][away].any(),
                  f"paged_bank_gather tree {name}: a non-resident row of "
                  f"leaf {j} is not zero")
            check(torch.equal(r_2[j], r_k[j]),
                  f"paged_bank_gather tree {name}: a repeated call differs "
                  f"(leaf {j})")
            g_err = max(g_err, (r_k[j] - r_ref).abs().max().item())
        rows.append(f"paged_bank_gather tree {name:<14} {len(leaves)} "
                    f"leaves (M {sum(m for m, _, _ in leaves)}), C="
                    f"{len(lids)}, {int(away.sum())} slots on non-resident or dummy "
                    f"pages: {launches // 2} launch(es) a call, rows "
                    f"bit-equal, repeat bit-identical")
    return g_err, rows


def check_tree_case(what, counted, stored, us, call, plain, ordered,
                    old_rows, valid, dummy_row=None) -> tuple[float, int]:
    """One tree of a single-trial scatter on the card: `call(stored, us)`
    twice, on clones of the stored leaves. Per leaf the rows bit-equal to
    `plain(s, u)`'s, dsum within TOL of it and bit-equal to
    `ordered(s, u)`'s, nothing written from `dummy_row` on, a repeated
    call bit-identical; one launch per table of leaves. Returns (max |d
    dsum| against the plain version, launches a call)."""
    before = counted.launches
    s_k, d_k = call([x.clone() for x in stored], us)
    s_2, d_2 = call([x.clone() for x in stored], us)
    torch.cuda.synchronize()
    launches = counted.launches - before
    check(launches == 2 * n_tables(len(stored)),
          f"{what}: {launches} launches for two calls on {len(stored)} "
          f"leaves")
    err = 0.0
    for j, (x, u) in enumerate(zip(stored, us)):
        where = f"{what}, leaf {j} (M={x.shape[1]}, {x.dtype})"
        x_ref, d_ref = plain(x, u)
        check(torch.equal(s_k[j], x_ref), f"{where}: rows differ")
        check(torch.equal(d_k[j], ordered(x, u)[1]),
              f"{where}: dsum is not bit-equal to the fixed-order oracle")
        check(torch.equal(s_2[j], s_k[j]) and torch.equal(d_2[j], d_k[j]),
              f"{where}: a repeated call differs")
        if dummy_row is not None:
            check(not s_k[j][dummy_row:].any(),
                  f"{where}: wrote the dummy page")
        terms = u.to(x.dtype).float() - old_rows(x)
        err = max(err, check_dsum(d_k[j][None], d_ref[None], terms[None],
                                  valid[None], where))
    return err, launches // 2


def check_scatter_trees(gen, active_path) -> tuple[float, float, list]:
    """`bank_scatter_leaves` and `paged_bank_scatter_leaves` (one launch
    per table of leaves) on the trees of TREE_CASES and on paper_mlp's tree
    with nothing active (`check_tree_case`). The dense trees take the main
    path's padded cohort, the paged ones the path's table for paper_mlp,
    else shuffled tables with pages that are not resident."""
    from repro_torch.kernels.bank_scatter import (bank_scatter,
                                                  bank_scatter_leaves,
                                                  bank_scatter_ordered_ref,
                                                  bank_scatter_ref)
    from repro_torch.kernels.paged_bank import (
        paged_bank_gather_ref, paged_bank_scatter, paged_bank_scatter_leaves,
        paged_bank_scatter_ordered_ref, paged_bank_scatter_ref)
    rng = np.random.default_rng(21)
    r, ps = N_CLIENTS + 1, PAGE_SIZE
    path = cohort(active_path)
    pt, n_slots = path_table()
    paged_path = (pt, n_slots, *path_lids(active_path))
    cases = [(name, leaves, path, paged_path if name == "paper_mlp"
              else shuffled_layout(rng, 37))
             for name, leaves in TREE_CASES.items()]
    cases.append(("nothing active", TREE_CASES["paper_mlp"],
                  (path[0], torch.zeros_like(path[1])),
                  shuffled_layout(rng, 0)))
    b_err, p_err, rows = 0.0, 0.0, []
    for name, leaves, (ids, val), (pt, slots, lids, pval) in cases:
        banks = [bank_inputs(gen, r, m, len(ids), dt, ids, val)[:2]
                 for m, dt, _ in leaves]
        err, launches = check_tree_case(
            f"bank_scatter tree {name}", bank_scatter, [b for b, _ in banks],
            [u for _, u in banks],
            lambda xs, us: bank_scatter_leaves(xs, us, ids, val),
            lambda x, u: bank_scatter_ref(x, u, ids, val),
            lambda x, u: bank_scatter_ordered_ref(x, u, ids, val),
            lambda x: x[ids].float(), val)
        b_err = max(b_err, err)
        rows.append(f"bank_scatter tree {name:<14} {len(leaves)} leaves "
                    f"(M {sum(m for m, _, _ in leaves)}), C={len(ids)}, "
                    f"valid {int(val.sum())}: {launches} launch(es) a call, "
                    f"rows bit-equal, dsum bit-equal to the oracle, repeat "
                    f"bit-identical")
        pools = [pages_inputs(gen, slots, m, len(lids), dt)
                 for m, dt, _ in leaves]
        err, launches = check_tree_case(
            f"paged_bank_scatter tree {name}", paged_bank_scatter,
            [x for x, _ in pools], [u for _, u in pools],
            lambda xs, us: paged_bank_scatter_leaves(xs, us, pt, lids, pval,
                                                     page_size=ps),
            lambda x, u: paged_bank_scatter_ref(x, u, pt, lids, pval,
                                                page_size=ps),
            lambda x, u: paged_bank_scatter_ordered_ref(x, u, pt, lids, pval,
                                                        page_size=ps),
            lambda x: paged_bank_gather_ref(x, pt, lids, page_size=ps), pval,
            dummy_row=slots * ps)
        p_err = max(p_err, err)
        rows.append(f"paged_bank_scatter tree {name:<14} {len(leaves)} "
                    f"leaves (M {sum(m for m, _, _ in leaves)}), slots="
                    f"{slots}, C={len(lids)}, valid {int(pval.sum())}: "
                    f"{launches} launch(es) a call, pages bit-equal, dsum "
                    f"bit-equal to the oracle, repeat bit-identical")
    return b_err, p_err, rows


def paged_sets(gen, active_path):
    """Per-leaf inputs of the paged paper path (pages of the N=100 bank,
    the path's page table and padded cohort), copied to cycle past L2."""
    pt, n_slots = path_table()
    lids, valid = path_lids(active_path)
    c = len(lids)
    set_bytes = sum(((n_slots + 1) * PAGE_SIZE + c) * m * 4
                    for m in PATH_WIDTHS)
    sets = [[(*pages_inputs(gen, n_slots, m, c, torch.float32), pt, lids,
              valid) for m in PATH_WIDTHS]
            for _ in range(n_copies(set_bytes))]
    return sets, c, int(valid.sum())


def time_paged_scatter(gen, active_path) -> dict:
    """The paged bank's cohort update on the paper path: paper_mlp's six
    leaves in one launch a round (and one launch per leaf for the
    per-launch times), the runner's padded cohort for this run's active
    mask."""
    from repro_torch.kernels.paged_bank import (paged_bank_scatter,
                                                paged_bank_scatter_leaves,
                                                paged_bank_scatter_ref)
    sets, c, n_valid = paged_sets(gen, active_path)
    pt, lids, valid = sets[0][0][2:]
    # rows (read old, read update, write new), dsum, lids, valid and the
    # page-table entry of each slot
    leaf_bytes = [3 * n_valid * m * 4 + m * 4 + c * 9 for m in PATH_WIDTHS]
    leaf_ops = [2 * n_valid * m for m in PATH_WIDTHS]
    return time_path(
        lambda *a: paged_bank_scatter(*a, page_size=PAGE_SIZE),
        lambda *a: paged_bank_scatter_ref(*a, page_size=PAGE_SIZE),
        sets, leaf_bytes, leaf_ops,
        tree=lambda s: paged_bank_scatter_leaves(
            [a[0] for a in s], [a[1] for a in s], pt, lids, valid,
            page_size=PAGE_SIZE))


def time_paged_gather(gen, active_path) -> dict:
    """The paged bank's row gather at the paper path's shapes (the padded
    cohort's rows of each leaf) in one launch a round (and one launch per
    leaf for the per-launch times), beside one `torch.index_select` per
    leaf on the precomputed physical rows (the library call for the same
    function)."""
    from repro_torch.kernels.paged_bank import (paged_bank_gather,
                                                paged_bank_gather_leaves,
                                                paged_bank_gather_ref,
                                                phys_rows)
    sets, c, _ = paged_sets(gen, active_path)
    sets = [[(pages, pt, lids) for pages, _, pt, lids, _ in s] for s in sets]
    pt, lids = sets[0][0][1:]
    phys = phys_rows(pt, lids, PAGE_SIZE)
    # each distinct page row read once (the pad slots all read the dummy
    # row), each output row written once as f32, the lids and the
    # page-table entry of each slot
    n_read = len(torch.unique(phys))
    leaf_bytes = [(n_read + c) * m * 4 + c * 8 for m in PATH_WIDTHS]
    return time_path(
        lambda *a: paged_bank_gather(*a, page_size=PAGE_SIZE),
        lambda *a: paged_bank_gather_ref(*a, page_size=PAGE_SIZE),
        sets, leaf_bytes, [0] * len(PATH_WIDTHS),
        library=lambda pages, *_: torch.index_select(pages, 0, phys),
        tree=lambda s: paged_bank_gather_leaves(
            [a[0] for a in s], pt, lids, page_size=PAGE_SIZE))


# --------------------------------------------------------------------------- #
# the main path
# --------------------------------------------------------------------------- #

def clone_tree(params, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda p: p.detach().to(device).clone(), params)


def run_path(name, algo, problem, params0, n_rounds, device, eval_every,
             engine="loop", cohort_capacity=None, mesh=None,
             checkpoint=None):
    """One run of the paper path; under engine="scan" the chunks hold
    SCAN_CHUNK rounds, placed on `mesh` when given, with `checkpoint`'s
    snapshots. Returns (params, history, host seconds between the
    participation draws of consecutive rounds)."""
    from repro_torch.core import BernoulliParticipation, run_fl
    from repro_torch.optim import inv_t
    model, batcher, probs, eval_fn = problem
    part = TimedParticipation(BernoulliParticipation(probs, seed=1))
    params, hist = run_fl(model=model, algo=algo, participation=part,
                          batcher=batcher, schedule=inv_t(1.0),
                          n_rounds=n_rounds, weight_decay=1e-3,
                          params=clone_tree(params0, device),
                          eval_fn=eval_fn, eval_every=eval_every,
                          engine=engine, scan_chunk=SCAN_CHUNK,
                          cohort_capacity=cohort_capacity, mesh=mesh,
                          checkpoint=checkpoint, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return params, hist, np.diff(part.stamps)


def kernel_counters() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from repro_torch.kernels.ops import launch_counters
    return launch_counters()


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_counters().items()}


def check_run(name, params, hist, dts, counts, kernel) -> str:
    """A ROUNDS-round run of the paper path: its kernel launched once per
    round (one launch for the tree) and no other kernel, finite losses and
    params, eval loss falling. Returns the run's summary line."""
    from repro_torch.tree import tree_leaves
    check(counts[kernel] == ROUNDS,
          f"{name}: {kernel} launched {counts[kernel]} times, expected one "
          f"a round, {ROUNDS}")
    others = {k: v for k, v in counts.items() if k != kernel}
    check(not any(others.values()), f"{name}: other kernels ran {others}")
    losses = np.asarray(hist.train_loss)
    check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
    check(all(math.isfinite(p.float().abs().max().item())
              for p in tree_leaves(params)), f"{name}: non-finite params")
    (t_first, el0), (t_last, el1) = hist.eval_loss[0], hist.eval_loss[-1]
    check(el1 < el0, f"{name}: eval loss {el1:.4f} at round {t_last} is "
                     f"not below {el0:.4f} at round {t_first}")
    steady = dts[10:]           # rounds 10..ROUNDS-2: past warm-up and eval
    return (f"main path {name}: {ROUNDS} rounds, median "
            f"{np.median(steady) * 1e3:.3f} ms/round (rounds 10-{ROUNDS - 2}, "
            f"host clock), mean |A(t)| {np.mean(hist.n_active):.2f}, "
            f"eval loss {el0:.4f} -> {el1:.4f}, acc "
            f"{hist.eval_acc[-1][1]:.4f}, tau_bar {hist.tau_bar:.4f}, "
            f"{kernel} launches {counts[kernel]}")


def main_path(params0, problem) -> tuple[dict, list, dict, dict]:
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import MIFA
    from repro_torch.tree import tree_leaves

    check([p.numel() for p in tree_leaves(params0)] == PATH_WIDTHS,
          "paper_mlp leaf widths changed")
    paths = {"mifa_array": (MIFA(memory="array"), "mifa_aggregate"),
             "banked_dense": (BankedMIFA(DenseBank(device="cuda")),
                              "bank_scatter")}
    launches, runs, rows, loop_ms = {}, {}, [], {}
    for name, (algo, kernel) in paths.items():
        reset_counts()
        params, hist, dts = run_path(name, algo, problem, params0, ROUNDS,
                                     "cuda", ROUNDS)
        counts = read_counts()
        launches[kernel] = counts[kernel]
        rows.append(check_run(name, params, hist, dts, counts, kernel))
        runs[name] = (params, hist)
        loop_ms[name] = float(np.median(dts[10:])) * 1e3
    a = np.asarray(runs["mifa_array"][1].train_loss)
    b = np.asarray(runs["banked_dense"][1].train_loss)
    rel = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12))
    rows.append(f"anchor: max rel train-loss gap MIFA(array) vs "
                f"BankedMIFA(dense) over {ROUNDS} rounds {rel:.3e} "
                f"(rtol {ANCHOR_RTOL}, atol {ANCHOR_ATOL})")
    check(np.allclose(a, b, rtol=ANCHOR_RTOL, atol=ANCHOR_ATOL),
          "anchor property: MIFA(array) and BankedMIFA(dense) diverge")
    check(runs["mifa_array"][1].n_active == runs["banked_dense"][1].n_active,
          "the two paths saw different masks")
    return launches, rows, runs, loop_ms


def run_gaps(run_a, run_b) -> tuple[float, float]:
    """Largest |difference| of two runs' train losses and final params."""
    from repro_torch.tree import tree_leaves
    (pa, ha), (pb, hb) = run_a, run_b
    dloss = float(np.max(np.abs(np.subtract(ha.train_loss, hb.train_loss))))
    dparam = max((x - y).abs().max().item()
                 for x, y in zip(tree_leaves(pa), tree_leaves(pb)))
    return dloss, dparam


def paged_path(params0, problem, dense) -> tuple[int, list, tuple,
                                                  float]:
    """The paper path through BankedMIFA(PagedDeviceBank(page_size=8)):
    first two BankedMIFA(DenseBank) runs are held bit-equal to each other
    (is local training on the card run-to-run deterministic?), then the
    paged run is held bit-equal to the dense one, or, if the two dense runs
    differ, within twice their gap."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    dense2 = run_path("banked_dense", BankedMIFA(DenseBank(device="cuda")),
                      problem, params0, ROUNDS, "cuda", ROUNDS)[:2]
    d_loss, d_param = run_gaps(dense, dense2)
    rows = [f"dense run-to-run: two BankedMIFA(DenseBank) runs of {ROUNDS} "
            f"rounds, max |dloss| {d_loss:.3e}, max |dparam| {d_param:.3e}"
            f" ({'bit-equal' if d_loss == d_param == 0 else 'NOT bit-equal'})"]
    bank = PagedDeviceBank(page_size=PAGE_SIZE, device="cuda")
    reset_counts()
    params, hist, dts = run_path("banked_paged", BankedMIFA(bank), problem,
                                 params0, ROUNDS, "cuda", ROUNDS)
    counts = read_counts()
    rows.append(check_run("banked_paged", params, hist, dts, counts,
                          "paged_bank_scatter")
                + f", page faults {bank.faults}, evictions {bank.evictions}")
    p_loss, p_param = run_gaps(dense, (params, hist))
    rows.append(f"paged vs dense: max |dloss| {p_loss:.3e}, max |dparam| "
                f"{p_param:.3e} over {ROUNDS} rounds")
    check(hist.n_active == dense[1].n_active,
          "the paged and dense runs saw different masks")
    check(p_loss <= 2 * d_loss and p_param <= 2 * d_param,
          f"BankedMIFA(PagedDeviceBank) is not "
          f"{'bit-equal to' if d_loss == d_param == 0 else 'as close as'} "
          f"BankedMIFA(DenseBank)")
    return (counts["paged_bank_scatter"], rows, (params, hist),
            float(np.median(dts[10:])) * 1e3)


def eviction_phase(params0) -> tuple[dict, list]:
    """Eviction on the card against DenseBank: EVICT_ROUNDS cohorts of 64
    unique ids (half from a hot set of ids < 128, half uniform over the
    rest) through a bank of EVICT_SLOTS slots of 8 rows over 128 logical
    pages, with random f32 updates drawn on the card. Every row (read
    through `gather`: the gather kernel and the spill patch) and G_sum must
    be bit-equal to the dense bank's."""
    from repro_torch.bank import DenseBank, PagedDeviceBank
    from repro_torch.tree import tree_leaves, tree_map
    n, c = EVICT_N, EVICT_C
    paged = PagedDeviceBank(page_size=PAGE_SIZE, n_slots=EVICT_SLOTS,
                            device="cuda")
    dense = DenseBank(device="cuda")
    p_state, d_state = paged.init(params0, n), dense.init(params0, n)
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)
    reset_counts()
    for _ in range(EVICT_ROUNDS):
        hot = rng.choice(EVICT_HOT, c // 2, replace=False)
        rest = rng.choice(np.setdiff1d(np.arange(n), hot), c - c // 2,
                          replace=False)
        ids = np.concatenate([hot, rest])
        upd = tree_map(lambda p: torch.randn((c,) + tuple(p.shape),
                                             generator=gen, device="cuda"),
                       params0)
        p_state = paged.scatter(p_state, ids, upd)
        d_state = dense.scatter(d_state, ids, upd)
    everyone = np.arange(n)
    p_rows, d_rows = paged.gather(p_state, everyone), dense.gather(
        d_state, everyone)
    torch.cuda.synchronize()
    counts = read_counts()
    check(paged.faults > 0 and paged.evictions > 0 and paged.refaults > 0,
          f"eviction phase did not evict and re-fault: faults "
          f"{paged.faults}, evictions {paged.evictions}, re-faults "
          f"{paged.refaults}")
    paged.check_invariants(p_state)
    check(counts["paged_bank_scatter"] == EVICT_ROUNDS
          and counts["paged_bank_gather"] == 1,
          f"eviction phase launches {counts}")
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(p_rows),
                                                tree_leaves(d_rows))),
          "eviction phase: paged rows differ from DenseBank's")
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(p_state["g_sum"]), tree_leaves(d_state["g_sum"]))),
          "eviction phase: paged G_sum differs from DenseBank's")
    check(spill_pinned(paged), "eviction phase: a spill block is not in "
                               "pinned memory")
    mem = paged.memory_bytes(p_state)
    return counts, [
        f"eviction: N={n}, page_size={PAGE_SIZE}, {paged.lp} logical pages, "
        f"n_slots={EVICT_SLOTS}, {EVICT_ROUNDS} rounds of C={c} (half hot "
        f"ids < {EVICT_HOT}): faults {paged.faults}, evictions "
        f"{paged.evictions}, re-faults {paged.refaults}, spilled pages "
        f"{paged.evictions - paged.refaults} ({mem['host']} B on the host); "
        f"all {n} rows "
        f"and G_sum bit-equal to DenseBank, invariants hold, every spill "
        f"block pinned; launches {counts}"]


def spill_pinned(bank) -> bool:
    """Every block of a paged bank's spill store is in pinned memory."""
    return all(b.is_pinned() for blocks in bank._spill.values()
               for b in blocks)


def million_runner(model, params0):
    """The million-client run: N = 10⁶ paper_mlp clients at full width,
    `ProceduralBatcher` data and BankedMIFA(PagedDeviceBank(page_size=8,
    n_slots=256)). Returns (runner, bank, draw), where draw() gives the next
    cohort: <= 64 unique ids drawn in O(C), as benchmarks/bank_scale.py
    draws them."""
    from repro_torch.bank import BankedMIFA, PagedDeviceBank
    from repro_torch.core import RoundRunner
    from repro_torch.data import ProceduralBatcher
    from repro_torch.optim import inv_t
    bank = PagedDeviceBank(page_size=PAGE_SIZE, n_slots=MILLION_SLOTS,
                           device="cuda")
    batcher = ProceduralBatcher(n_clients=MILLION_N, dim=256, n_classes=10,
                                batch_size=100, k_steps=5)
    # the procedural features are not scaled by 1/sqrt(dim) as
    # make_classification's are, and inv_t(1.0) overshoots on them in round
    # 0 (train loss ~2e4 before it recovers); inv_t(0.1) keeps the losses
    # near log(10)
    runner = RoundRunner(model=model, algo=BankedMIFA(bank), batcher=batcher,
                         schedule=inv_t(0.1), weight_decay=1e-3,
                         params=clone_tree(params0, "cuda"), device="cuda")
    rng = np.random.default_rng(0)
    return runner, bank, lambda: np.unique(
        rng.integers(0, MILLION_N, size=2 * MILLION_C))[:MILLION_C]


def million_phase(params0, model) -> tuple[dict, list]:
    """N = 10⁶ paper_mlp clients at full width through
    BankedMIFA(PagedDeviceBank(page_size=8, n_slots=256)):
    `RoundRunner.step_cohort` with 64 unique ids a round, drawn in O(C)."""
    from repro_torch.tree import tree_leaves
    n, c = MILLION_N, MILLION_C
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner, bank, draw = million_runner(model, params0)
    written, dts = set(), []
    reset_counts()
    for t in range(MILLION_ROUNDS):
        ids = draw()
        t0 = time.perf_counter()
        runner.step_cohort(t, ids)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        written.update(ids.tolist())
    in_rounds = read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = runner.state["bank"]
    mem = bank.memory_bytes(state)
    check(mem["device_pages"] == MILLION_POOL_BYTES,
          f"device_pages {mem['device_pages']} != {MILLION_POOL_BYTES}")
    check(in_rounds["paged_bank_scatter"] == MILLION_ROUNDS
          and not in_rounds["bank_scatter"]
          and not in_rounds["mifa_aggregate"]
          and not in_rounds["paged_bank_gather"],
          f"million-client rounds launched {in_rounds}")
    losses = runner.hist.train_loss
    check(bool(np.isfinite(losses).all()), "million-client: non-finite loss")
    # G_sum against the sum of every written client's final row, read
    # through the gather kernel and the spill patch; the f32 running sum
    # takes ~40 roundings per column, far inside TOL's rtol of the summed
    # magnitudes
    ids = np.fromiter(sorted(written), np.int64)
    rows = bank.gather(state, ids)
    rtol, atol = TOL[torch.float32]
    g_err = 0.0
    for g, r in zip(tree_leaves(state["g_sum"]), tree_leaves(rows)):
        err = (g.double() - r.double().sum(0)).abs()
        check(bool((err <= atol + rtol * r.double().abs().sum(0)).all()),
              f"million-client: G_sum off the sum of rows by "
              f"{err.max().item():.3e}")
        g_err = max(g_err, err.max().item())
    bank.check_invariants(state)
    check(spill_pinned(bank), "million-client: a spill block is not in "
                              "pinned memory")
    counts = read_counts()
    check(counts["paged_bank_gather"] == 1,
          f"million-client gather of the written rows: "
          f"{counts['paged_bank_gather']} gather launches, expected 1")
    d = sum(PATH_WIDTHS)
    return counts, [
        f"million clients: N={n}, paper_mlp d={d}, page_size={PAGE_SIZE}, "
        f"n_slots={MILLION_SLOTS}, {MILLION_ROUNDS} rounds of C={c} through "
        f"RoundRunner.step_cohort: median {np.median(dts) * 1e3:.3f} "
        f"ms/round (host clock, all rounds; first "
        f"{dts[0] * 1e3:.3f}, max {max(dts) * 1e3:.3f}), train loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}",
        f"million clients: memory_bytes {mem} (device_pages "
        f"{mem['device_pages']} B), peak device allocation "
        f"{peak} B (torch.cuda.max_memory_allocated), host spill "
        f"{mem['host']} B (pinned); faults {bank.faults}, evictions "
        f"{bank.evictions}, re-faults {bank.refaults}; a DenseBank for this "
        f"run would hold (N+1)*d*4 = {(n + 1) * d * 4} B = "
        f"{(n + 1) * d * 4 / 1e9:.1f} GB",
        f"million clients: G_sum vs the sum of {len(ids)} written rows "
        f"(gathered): max |err| {g_err:.3e} (rtol {rtol} of the summed "
        f"magnitudes, atol {atol}); invariants hold; launches in the rounds "
        f"{in_rounds}, with the check {counts}"]


def card_vs_cpu(params0, problem_cuda, problem_cpu) -> None:
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.core import MIFA
    from repro_torch.tree import tree_leaves
    for name, make in (("mifa_array", lambda d: MIFA(memory="array")),
                       ("banked_dense",
                        lambda d: BankedMIFA(DenseBank(device=d))),
                       ("banked_paged",
                        lambda d: BankedMIFA(PagedDeviceBank(
                            page_size=PAGE_SIZE, device=d)))):
        out = {}
        for dev, prob in (("cpu", problem_cpu), ("cuda", problem_cuda)):
            out[dev] = run_path(name, make(dev), prob, params0, CPU_ROUNDS,
                                dev, CPU_ROUNDS)
        (p_cpu, h_cpu, _), (p_gpu, h_gpu, _) = out["cpu"], out["cuda"]
        pairs = [(x, y.cpu()) for x, y in zip(tree_leaves(p_cpu),
                                               tree_leaves(p_gpu))]
        dparam = [(x - y).abs().max().item() for x, y in pairs]
        dloss = np.abs(np.subtract(h_cpu.train_loss, h_gpu.train_loss))
        print(f"card vs CPU {name}: {CPU_ROUNDS} rounds, max |dparam| per "
              f"leaf {['%.2e' % d for d in dparam]}, |dloss| per round "
              f"{['%.2e' % d for d in dloss]} (rtol {DEVICE_RTOL}, atol "
              f"{DEVICE_ATOL})")
        for x, y in pairs:
            check(torch.allclose(x, y, rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
                  f"{name}: card and CPU params differ")
        check(np.allclose(h_cpu.train_loss, h_gpu.train_loss,
                          rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
              f"{name}: card and CPU losses differ")


# --------------------------------------------------------------------------- #
# the fleet: batched kernels and the Figure 2 sweep
# --------------------------------------------------------------------------- #

def fleet_cohorts(masks, n_clients=N_CLIENTS, cap=FLEET_CAP):
    """The fleet's padded cohorts for K masks: (K, cap) ids and valid, pads
    at the dummy row, as `FleetRunner.step_cohort` pads them."""
    from repro_torch.core.runner import pad_cohort
    pairs = [pad_cohort(np.flatnonzero(m), n_clients, cap) for m in masks]
    return (torch.from_numpy(np.stack([p for p, _ in pairs])).cuda(),
            torch.from_numpy(np.stack([v for _, v in pairs])).cuda())


def check_batch_cohorts(active_path):
    """Three trials' cohorts of C=64: the path's typical mask, another mask
    of 45 clients, and only pads."""
    other = torch.zeros(N_CLIENTS, dtype=torch.bool)
    other[torch.randperm(N_CLIENTS, generator=torch.Generator().manual_seed(
        45))[:45]] = True
    none = torch.zeros(N_CLIENTS, dtype=torch.bool)
    return fleet_cohorts([active_path.cpu().numpy(), other.numpy(),
                          none.numpy()])


def check_dsum(d_k, d_ref, terms, valid, what) -> float:
    """dsum of the kernel within TOL of the plain version's, relative to
    the summed magnitudes of each trial's valid terms."""
    rtol, atol = TOL[torch.float32]
    err = (d_k - d_ref).abs()
    scale = (terms.abs() * valid.unsqueeze(-1)).sum(1)
    check(bool((err <= atol + rtol * scale).all()),
          f"{what} dsum off by {err.max().item():.3e}")
    return err.max().item()


def check_batched(gen, active_path) -> tuple[float, float, list]:
    """Both batched kernels against their plain versions and, trial by
    trial, against the single-trial kernels on the card: K=3 trials of
    C=64 with different cohorts (one only pads), the path's six widths,
    width 1000 (ragged for the vector path), bf16 storage, and for the
    paged kernel per-trial shuffled page tables with pages that are not
    resident. Rows and pages bit-equal; dsum within TOL of the plain
    version and bit-equal to the single-trial kernel and to the fixed-order
    oracle. Then the same on the trees of TREE_CASES, every leaf and trial
    in one launch per table of leaves (`check_batched_trees`)."""
    from repro_torch.kernels.bank_scatter import (bank_scatter,
                                                  bank_scatter_batched,
                                                  bank_scatter_batched_ref,
                                                  bank_scatter_ordered_ref)
    from repro_torch.kernels.paged_bank import (
        paged_bank_gather_ref, paged_bank_scatter, paged_bank_scatter_batched,
        paged_bank_scatter_batched_ref, paged_bank_scatter_ordered_ref)
    k_trials, r, ps = len(FLEET_SEEDS), N_CLIENTS + 1, PAGE_SIZE
    ids, valid = check_batch_cohorts(active_path)
    c = ids.shape[1]
    cases = [(m, torch.float32) for m in sorted(set(PATH_WIDTHS))]
    cases += [(1000, torch.float32), (32768, torch.bfloat16),
              (1000, torch.bfloat16)]
    b_err, rows = 0.0, []
    for m, dt in cases:
        banks = torch.randn((k_trials, r, m), generator=gen,
                            device="cuda").to(dt)
        u = torch.randn((k_trials, c, m), generator=gen, device="cuda")
        b_ref, d_ref = bank_scatter_batched_ref(banks, u, ids, valid)
        b_k, d_k = bank_scatter_batched(banks.clone(), u, ids, valid)
        torch.cuda.synchronize()
        where = f"(M={m}, {dt})"
        check(torch.equal(b_k, b_ref), f"bank_scatter_batched rows differ "
                                       f"{where}")
        for k in range(k_trials):
            b1, d1 = bank_scatter(banks[k].clone(), u[k], ids[k], valid[k])
            check(torch.equal(b_k[k], b1) and torch.equal(d_k[k], d1),
                  f"bank_scatter_batched trial {k} is not bit-equal to "
                  f"bank_scatter {where}")
            check(torch.equal(d_k[k], bank_scatter_ordered_ref(
                banks[k], u[k], ids[k], valid[k])[1]),
                  f"bank_scatter_batched trial {k}: dsum is not bit-equal "
                  f"to the fixed-order oracle {where}")
        terms = u.to(dt).float() - torch.stack(
            [banks[k][ids[k]] for k in range(k_trials)]).float()
        b_err = max(b_err, check_dsum(d_k, d_ref, terms, valid,
                                      f"bank_scatter_batched {where}"))
        rows.append(f"bank_scatter_batched K={k_trials} R={r} C={c} valid="
                    f"{valid.sum(1).tolist()} M={m:<6} bank {dt}: rows "
                    f"bit-equal, per trial bit-equal to bank_scatter and the "
                    f"oracle")
    # the paged kernel: the path's table in every trial, then per-trial
    # shuffled tables (16 of 32 pages resident) with 37 / 20 / 0 valid rows
    rng = np.random.default_rng(9)
    pt, n_slots = path_table()
    lids = torch.where(ids >= N_CLIENTS, n_slots * ps, ids).int()
    path = (pt.expand(k_trials, -1).contiguous(), n_slots, lids, valid)
    shuffled = [shuffled_layout(rng, n) for n in (37, 20, 0)]
    shuf = (torch.stack([s[0] for s in shuffled]), shuffled[0][1],
            torch.stack([s[2] for s in shuffled]),
            torch.stack([s[3] for s in shuffled]))
    p_err = 0.0
    for m, dt, layout, label in (
            [(m, torch.float32, path, "path") for m in sorted(
                set(PATH_WIDTHS))]
            + [(1000, torch.float32, shuf, "shuffled ragged"),
               (32768, torch.float32, shuf, "shuffled"),
               (32768, torch.bfloat16, path, "bf16 pages"),
               (1000, torch.bfloat16, shuf, "bf16 shuffled")]):
        tabs, slots, lid, val = layout
        pages = torch.stack([pages_inputs(gen, slots, m, 1, dt)[0]
                             for _ in range(k_trials)])
        u = torch.randn((k_trials, lid.shape[1], m), generator=gen,
                        device="cuda")
        p_ref, d_ref = paged_bank_scatter_batched_ref(
            pages, u, tabs, lid, val, page_size=ps)
        p_k, d_k = paged_bank_scatter_batched(pages.clone(), u, tabs, lid,
                                              val, page_size=ps)
        torch.cuda.synchronize()
        where = f"({label}, M={m}, {dt})"
        check(torch.equal(p_k, p_ref), f"paged_bank_scatter_batched pages "
                                       f"differ {where}")
        check(not p_k[:, slots * ps:].any(), f"paged_bank_scatter_batched "
                                             f"wrote a dummy page {where}")
        old = []
        for k in range(k_trials):
            p1, d1 = paged_bank_scatter(pages[k].clone(), u[k], tabs[k],
                                        lid[k], val[k], page_size=ps)
            check(torch.equal(p_k[k], p1) and torch.equal(d_k[k], d1),
                  f"paged_bank_scatter_batched trial {k} is not bit-equal "
                  f"to paged_bank_scatter {where}")
            check(torch.equal(d_k[k], paged_bank_scatter_ordered_ref(
                pages[k], u[k], tabs[k], lid[k], val[k], page_size=ps)[1]),
                  f"paged_bank_scatter_batched trial {k}: dsum is not "
                  f"bit-equal to the fixed-order oracle {where}")
            old.append(paged_bank_gather_ref(pages[k], tabs[k], lid[k],
                                             page_size=ps))
        p_err = max(p_err, check_dsum(
            d_k, d_ref, u.to(dt).float() - torch.stack(old), val,
            f"paged_bank_scatter_batched {where}"))
        rows.append(f"paged_bank_scatter_batched {label:<15} K={k_trials} "
                    f"slots={slots} C={lid.shape[1]} valid="
                    f"{val.sum(1).tolist()} M={m:<6} pages {dt}: pages "
                    f"bit-equal, per trial bit-equal to paged_bank_scatter "
                    f"and the oracle")
    tb_err, tp_err, tree_rows = check_batched_trees(gen, (ids, valid), path,
                                                    shuf)
    return max(b_err, tb_err), max(p_err, tp_err), rows + tree_rows


def check_batched_trees(gen, cohorts, path, shuf) -> tuple[float, float,
                                                            list]:
    """`bank_scatter_batched_leaves` and `paged_bank_scatter_batched_leaves`
    (one launch per table of leaves, all K trials) on the trees of
    TREE_CASES: per leaf equal to the plain version (rows and pages
    bit-equal, dsum within TOL), per trial and leaf bit-equal to
    `bank_scatter` / `paged_bank_scatter` in rows and dsum, the launches one
    per table, a repeated call bit-identical, per trial and leaf dsum
    bit-equal to the fixed-order oracle. The dense trees take the three
    cohorts of `check_batch_cohorts`; the paged ones the path's table for
    paper_mlp, else per-trial shuffled tables (`shuf`)."""
    from repro_torch.kernels.bank_scatter import (bank_scatter,
                                                  bank_scatter_batched,
                                                  bank_scatter_batched_leaves,
                                                  bank_scatter_batched_ref,
                                                  bank_scatter_ordered_ref)
    from repro_torch.kernels.paged_bank import (
        paged_bank_gather_ref, paged_bank_scatter, paged_bank_scatter_batched,
        paged_bank_scatter_batched_leaves, paged_bank_scatter_batched_ref,
        paged_bank_scatter_ordered_ref)
    k_trials, r, ps = len(FLEET_SEEDS), N_CLIENTS + 1, PAGE_SIZE
    ids, valid = cohorts
    b_err, p_err, rows = 0.0, 0.0, []
    for name, leaves in TREE_CASES.items():
        c = ids.shape[1]
        banks = [torch.randn((k_trials, r, m), generator=gen,
                             device="cuda").to(dt) for m, dt, _ in leaves]
        us = [torch.randn((k_trials, c, m), generator=gen, device="cuda")
              for m, _, _ in leaves]
        before = bank_scatter_batched.launches
        b_k, d_k = bank_scatter_batched_leaves([b.clone() for b in banks],
                                               us, ids, valid)
        b_2, d_2 = bank_scatter_batched_leaves([b.clone() for b in banks],
                                               us, ids, valid)
        torch.cuda.synchronize()
        launches = bank_scatter_batched.launches - before
        check(launches == 2 * n_tables(len(leaves)),
              f"bank_scatter_batched tree {name}: {launches} launches for "
              f"two calls on {len(leaves)} leaves")
        for j, (b, u) in enumerate(zip(banks, us)):
            where = f"tree {name}, leaf {j} (M={b.shape[2]}, {b.dtype})"
            b_ref, d_ref = bank_scatter_batched_ref(b, u, ids, valid)
            check(torch.equal(b_k[j], b_ref),
                  f"bank_scatter_batched {where}: rows differ")
            for k in range(k_trials):
                b1, d1 = bank_scatter(b[k].clone(), u[k], ids[k], valid[k])
                check(torch.equal(b_k[j][k], b1) and torch.equal(d_k[j][k],
                                                                 d1),
                      f"bank_scatter_batched {where}: trial {k} is not "
                      f"bit-equal to bank_scatter")
                check(torch.equal(d_k[j][k], bank_scatter_ordered_ref(
                    b[k], u[k], ids[k], valid[k])[1]),
                      f"bank_scatter_batched {where}: trial {k}'s dsum is "
                      f"not bit-equal to the fixed-order oracle")
            check(torch.equal(b_2[j], b_k[j]) and torch.equal(d_2[j],
                                                              d_k[j]),
                  f"bank_scatter_batched {where}: a repeated call differs")
            terms = u.to(b.dtype).float() - torch.stack(
                [b[k][ids[k]] for k in range(k_trials)]).float()
            b_err = max(b_err, check_dsum(d_k[j], d_ref, terms, valid,
                                          f"bank_scatter_batched {where}"))
        rows.append(f"bank_scatter_batched tree {name:<14} {len(leaves)} "
                    f"leaves (M {sum(m for m, _, _ in leaves)}), K="
                    f"{k_trials}, valid {valid.sum(1).tolist()}: "
                    f"{launches // 2} launch(es) a call, rows bit-equal, "
                    f"per trial and leaf bit-equal to bank_scatter and the "
                    f"oracle, repeat bit-identical")

        tabs, slots, lid, val = path if name == "paper_mlp" else shuf
        c = lid.shape[1]
        pages = [torch.stack([pages_inputs(gen, slots, m, 1, dt)[0]
                              for _ in range(k_trials)])
                 for m, dt, _ in leaves]
        us = [torch.randn((k_trials, c, m), generator=gen, device="cuda")
              for m, _, _ in leaves]
        before = paged_bank_scatter_batched.launches
        p_k, d_k = paged_bank_scatter_batched_leaves(
            [p.clone() for p in pages], us, tabs, lid, val, page_size=ps)
        p_2, d_2 = paged_bank_scatter_batched_leaves(
            [p.clone() for p in pages], us, tabs, lid, val, page_size=ps)
        torch.cuda.synchronize()
        launches = paged_bank_scatter_batched.launches - before
        check(launches == 2 * n_tables(len(leaves)),
              f"paged_bank_scatter_batched tree {name}: {launches} launches "
              f"for two calls on {len(leaves)} leaves")
        for j, (p, u) in enumerate(zip(pages, us)):
            where = f"tree {name}, leaf {j} (M={p.shape[2]}, {p.dtype})"
            p_ref, d_ref = paged_bank_scatter_batched_ref(
                p, u, tabs, lid, val, page_size=ps)
            check(torch.equal(p_k[j], p_ref),
                  f"paged_bank_scatter_batched {where}: pages differ")
            check(not p_k[j][:, slots * ps:].any(),
                  f"paged_bank_scatter_batched {where}: wrote a dummy page")
            old = []
            for k in range(k_trials):
                p1, d1 = paged_bank_scatter(p[k].clone(), u[k], tabs[k],
                                            lid[k], val[k], page_size=ps)
                check(torch.equal(p_k[j][k], p1)
                      and torch.equal(d_k[j][k], d1),
                      f"paged_bank_scatter_batched {where}: trial {k} is not "
                      f"bit-equal to paged_bank_scatter")
                check(torch.equal(d_k[j][k], paged_bank_scatter_ordered_ref(
                    p[k], u[k], tabs[k], lid[k], val[k], page_size=ps)[1]),
                      f"paged_bank_scatter_batched {where}: trial {k}'s dsum "
                      f"is not bit-equal to the fixed-order oracle")
                old.append(paged_bank_gather_ref(p[k], tabs[k], lid[k],
                                                 page_size=ps))
            check(torch.equal(p_2[j], p_k[j]) and torch.equal(d_2[j],
                                                              d_k[j]),
                  f"paged_bank_scatter_batched {where}: a repeated call "
                  f"differs")
            p_err = max(p_err, check_dsum(
                d_k[j], d_ref, u.to(p.dtype).float() - torch.stack(old), val,
                f"paged_bank_scatter_batched {where}"))
        rows.append(f"paged_bank_scatter_batched tree {name:<14} "
                    f"{len(leaves)} leaves (M {sum(m for m, _, _ in leaves)})"
                    f", K={k_trials}, slots={slots}, valid "
                    f"{val.sum(1).tolist()}: {launches // 2} launch(es) a "
                    f"call, pages bit-equal, per trial and leaf bit-equal to "
                    f"paged_bank_scatter and the oracle, repeat "
                    f"bit-identical")
    return b_err, p_err, rows


def fleet_path_cohorts(probs):
    """A typical round of the cohort fleet path: the three trials' masks
    (participation seeds 100+s) at the round among 1-21 whose summed |A|
    is the median, padded to the shared width 64."""
    from repro_torch.core import BernoulliParticipation
    parts = [BernoulliParticipation(probs, seed=100 + s) for s in FLEET_SEEDS]
    rounds = [np.stack([p.sample(t) for p in parts]) for t in range(22)][1:]
    typical = sorted(rounds, key=lambda m: m.sum())[len(rounds) // 2]
    return fleet_cohorts(typical)


def time_batched(gen, probs) -> dict:
    """Both batched kernels per round of the cohort fleet path: one call
    for paper_mlp's six leaves and all three trials (and one launch per
    leaf for the per-launch times), the trials' cohorts of a typical round
    padded to 64, the N=100 bank (dense) and its 13-page pool (paged);
    inputs cycled past L2."""
    from repro_torch.kernels.bank_scatter import (bank_scatter_batched,
                                                  bank_scatter_batched_leaves,
                                                  bank_scatter_batched_ref)
    from repro_torch.kernels.paged_bank import (
        paged_bank_scatter_batched, paged_bank_scatter_batched_leaves,
        paged_bank_scatter_batched_ref)
    ids, valid = fleet_path_cohorts(probs)
    k_trials, c = ids.shape
    n_valid = int(valid.sum())
    r = N_CLIENTS + 1
    pt, n_slots = path_table()
    pts = pt.expand(k_trials, -1).contiguous()
    lids = torch.where(ids >= N_CLIENTS, n_slots * PAGE_SIZE, ids).int()
    rp = (n_slots + 1) * PAGE_SIZE

    def sets(rows):
        set_bytes = sum(k_trials * (rows + c) * m * 4 for m in PATH_WIDTHS)
        return [[(torch.randn((k_trials, rows, m), generator=gen,
                              device="cuda"),
                  torch.randn((k_trials, c, m), generator=gen,
                              device="cuda")) for m in PATH_WIDTHS]
                for _ in range(n_copies(set_bytes))]

    # valid rows of all trials (read old, read update, write new), K dsum
    # rows, ids (or lids, page-table entries) and valid
    leaf_bytes = [3 * n_valid * m * 4 + k_trials * m * 4
                  + k_trials * c * 9 for m in PATH_WIDTHS]
    leaf_ops = [2 * n_valid * m for m in PATH_WIDTHS]
    dense = [[(b, u, ids, valid) for b, u in s] for s in sets(r)]
    paged = [[(p, u, pts, lids, valid) for p, u in s] for s in sets(rp)]
    return {
        "bank_scatter_batched": time_path(
            bank_scatter_batched, bank_scatter_batched_ref, dense,
            leaf_bytes, leaf_ops,
            tree=lambda s: bank_scatter_batched_leaves(
                [a[0] for a in s], [a[1] for a in s], ids, valid)),
        "paged_bank_scatter_batched": time_path(
            lambda *a: paged_bank_scatter_batched(*a, page_size=PAGE_SIZE),
            lambda *a: paged_bank_scatter_batched_ref(*a,
                                                      page_size=PAGE_SIZE),
            paged, leaf_bytes, leaf_ops,
            tree=lambda s: paged_bank_scatter_batched_leaves(
                [a[0] for a in s], [a[1] for a in s], pts, lids, valid,
                page_size=PAGE_SIZE)),
        "valid": valid.sum(1).tolist(), "cohort": c}


# name -> (update clock, every trial checked against its sequential run
# (else trial 0), the kernel its rounds launch)
FIG2 = {"mifa_array": (False, True, "mifa_aggregate"),
        "biased_fedavg": (False, False, None),
        "fedavg_s50": (True, True, None),
        "fedavg_s100": (True, False, None),
        "fedavg_is": (False, False, None),
        "banked_dense": (False, True, "bank_scatter_batched"),
        "banked_paged": (False, False, "paged_bank_scatter_batched")}


def fig2_algo(name, probs, device):
    """A fresh instance of a Figure 2 algorithm (fig2_convergence.py:33-39)
    and of the cohort fleets' banks (fleet_scale.py)."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.core import MIFA, BiasedFedAvg, FedAvgIS, FedAvgSampling
    return {"mifa_array": lambda: MIFA(memory="array"),
            "biased_fedavg": BiasedFedAvg,
            "fedavg_s50": lambda: FedAvgSampling(s=N_CLIENTS // 2),
            "fedavg_s100": lambda: FedAvgSampling(s=N_CLIENTS),
            "fedavg_is": lambda: FedAvgIS(tuple(probs.tolist())),
            "banked_dense": lambda: BankedMIFA(DenseBank(device=device)),
            "banked_paged": lambda: BankedMIFA(PagedDeviceBank(
                page_size=PAGE_SIZE, device=device))}[name]()


def fleet_kw(name, problem, n_rounds, device, cap=FLEET_CAP) -> dict:
    """run_fl / run_fleet arguments shared by a fleet and its sequential
    runs: the cohort algorithms pin the cohort width to `cap`."""
    from repro_torch.optim import inv_t
    model, batcher, probs, _ = problem
    clock = FIG2[name][0]
    cohort = name.startswith("banked")
    return dict(model=model, algo=fig2_algo(name, probs, device),
                batcher=batcher,
                schedule=inv_t(1.0), n_rounds=n_rounds, weight_decay=1e-3,
                uses_update_clock=clock,
                cohort_capacity=cap if cohort else None, device=device)


def run_fig2_fleet(name, problem, n_rounds, device, eval_fn=None,
                   engine="loop", cap=FLEET_CAP, mesh=None):
    """One Figure 2 algorithm as one `run_fleet` over seeds 0-2 (under
    engine="scan" in chunks of SCAN_CHUNK rounds; a cohort fleet pinned
    to width `cap`; its trial axis on `mesh` when given); returns (params,
    history, host seconds between the draws of consecutive rounds)."""
    from repro_torch.core import BernoulliParticipation
    from repro_torch.fleet import Trial, run_fleet
    probs = problem[2]
    parts = [BernoulliParticipation(probs, seed=100 + s) for s in FLEET_SEEDS]
    parts[0] = TimedParticipation(parts[0])
    trials = [Trial(seed=s, participation=p, label=f"{name}/seed{s}")
              for s, p in zip(FLEET_SEEDS, parts)]
    params, hist = run_fleet(trials=trials, eval_fn=eval_fn,
                             eval_every=n_rounds, engine=engine,
                             scan_chunk=SCAN_CHUNK, mesh=mesh,
                             **fleet_kw(name, problem, n_rounds, device,
                                        cap))
    if device == "cuda":
        torch.cuda.synchronize()
    return params, hist, np.diff(parts[0].stamps)


def run_fig2_trial(name, problem, k, n_rounds, device):
    """Trial k of a Figure 2 fleet as a sequential `run_fl`."""
    from repro_torch.core import BernoulliParticipation, run_fl
    s = FLEET_SEEDS[k]
    part = TimedParticipation(BernoulliParticipation(problem[2],
                                                     seed=100 + s))
    params, hist = run_fl(participation=part, seed=s,
                          **fleet_kw(name, problem, n_rounds, device))
    if device == "cuda":
        torch.cuda.synchronize()
    return params, hist, np.diff(part.stamps)


def trial_gaps(fleet, k, seq) -> tuple[float, float]:
    """Largest |difference| of fleet trial k and a sequential run: train
    losses and final params."""
    from repro_torch.tree import tree_index
    return run_gaps((tree_index(fleet[0], k), fleet[1].trial(k)), seq)


def fig2_phase(problem) -> tuple[dict, dict, list]:
    """The Figure 2 sweep as seven fleets of three trials, FLEET_ROUNDS
    rounds each, on the card. Returns (launches of each batched kernel in
    its fleet's run, the fleets, report rows)."""
    from repro_torch.fleet import make_fleet_eval
    from repro_torch.tree import tree_leaves, tree_stack
    model = problem[0]
    fleet_eval = make_fleet_eval(model, problem[3].eval_batch,
                                 device="cuda")
    # the trials' initial params, as FleetRunner makes them
    init_loss, _ = fleet_eval(tree_stack([
        model.init(torch.Generator().manual_seed(s), device="cuda")
        for s in FLEET_SEEDS]))
    k_trials = len(FLEET_SEEDS)
    runs, launches, rows = {}, {}, []
    for name, (clock, check_all, kernel) in FIG2.items():
        reset_counts()
        params, hist, dts = run_fig2_fleet(name, problem, FLEET_ROUNDS,
                                           "cuda", fleet_eval)
        counts = read_counts()
        want = {"mifa_aggregate": FLEET_ROUNDS * k_trials,
                "bank_scatter_batched": FLEET_ROUNDS,
                "paged_bank_scatter_batched": FLEET_ROUNDS}
        expected = {key: want[key] if key == kernel else 0 for key in counts}
        check(counts == expected, f"fleet {name}: launches {counts}, "
                                  f"expected {expected}")
        if kernel in ("bank_scatter_batched", "paged_bank_scatter_batched"):
            launches[kernel] = counts[kernel]
        st = hist.stacked()
        check(bool(np.isfinite(st["train_loss"]).all()) and all(
            bool(torch.isfinite(p).all()) for p in tree_leaves(params)),
              f"fleet {name}: non-finite losses or params")
        final = st["eval_loss"][:, -1]
        check(bool((final < init_loss).all()),
              f"fleet {name}: eval loss {final} not below the initial "
              f"{init_loss} in every trial")
        runs[name] = (params, hist, dts)
        # sequential runs of the checked trials, on the card
        seq_dts, gaps = [], []
        for k in (range(k_trials) if check_all else (0,)):
            seq = run_fig2_trial(name, problem, k, FLEET_ROUNDS, "cuda")
            seq_dts.append(np.median(seq[2][10:]))
            d_loss, d_param = trial_gaps((params, hist), k, seq[:2])
            gaps.append((d_loss, d_param))
            check(d_loss <= DEVICE_ATOL and d_param <= DEVICE_ATOL,
                  f"fleet {name} trial {k} vs its sequential run: |dloss| "
                  f"{d_loss:.3e}, |dparam| {d_param:.3e} > {DEVICE_ATOL}")
            check(hist.trial(k).n_active == seq[1].n_active
                  and hist.trial(k).global_updates == seq[1].global_updates,
                  f"fleet {name} trial {k}: masks or global updates differ "
                  "from its sequential run")
        fleet_ms = np.median(dts[10:]) * 1e3
        seq_ms = float(np.mean(seq_dts)) * 1e3
        gu = (f", global updates {st['global_updates'][:, -1].tolist()}"
              if clock else "")
        rows.append(
            f"fleet {name}: K={k_trials} x {FLEET_ROUNDS} rounds, median "
            f"{fleet_ms:.3f} ms/round (rounds 10-{FLEET_ROUNDS - 2}, host "
            f"clock) vs K x sequential {k_trials * seq_ms:.3f} ms "
            f"({seq_ms:.3f} ms/round, mean of the medians of "
            f"{len(seq_dts)} run(s)); eval loss "
            f"{[round(float(v), 4) for v in init_loss]} -> "
            f"{[round(float(v), 4) for v in final]}; vs sequential trials "
            f"{list(range(len(gaps)))}: max |dloss| "
            f"{max(g[0] for g in gaps):.3e}, max |dparam| "
            f"{max(g[1] for g in gaps):.3e}{gu}; launches {counts}")
    # the cohort fleets: paged bit-equal to dense, dense near MIFA(array)
    dense, paged = runs["banked_dense"], runs["banked_paged"]
    p_loss = float(np.abs(paged[1].stacked()["train_loss"]
                          - dense[1].stacked()["train_loss"]).max())
    p_param = max((x - y).abs().max().item() for x, y in zip(
        tree_leaves(paged[0]), tree_leaves(dense[0])))
    check(p_loss == 0 and p_param == 0,
          f"paged fleet is not bit-equal to the dense fleet: |dloss| "
          f"{p_loss:.3e}, |dparam| {p_param:.3e}")
    a = runs["mifa_array"][1].stacked()["train_loss"]
    b = runs["banked_dense"][1].stacked()["train_loss"]
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12)))
    check(np.allclose(a, b, rtol=ANCHOR_RTOL, atol=ANCHOR_ATOL),
          f"anchor property: the MIFA(array) and BankedMIFA(dense) fleets "
          f"diverge (max rel gap {rel:.3e})")
    rows.append(f"cohort fleets: BankedMIFA(PagedDeviceBank) bit-equal to "
                f"BankedMIFA(DenseBank) over {FLEET_ROUNDS} rounds x "
                f"{k_trials} trials; dense-bank fleet vs MIFA(array) fleet "
                f"max rel train-loss gap {rel:.3e} (rtol {ANCHOR_RTOL})")
    return launches, runs, rows


def fleet_card_vs_cpu(problem_cuda, problem_cpu) -> str:
    """The FedAvgSampling(S=50) fleet for FLEET_CPU_ROUNDS rounds on the
    CPU (plain versions) and on the card, held together."""
    from repro_torch.tree import tree_leaves
    (p_cpu, h_cpu, _), (p_gpu, h_gpu, _) = (
        run_fig2_fleet("fedavg_s50", prob, FLEET_CPU_ROUNDS, dev)
        for dev, prob in (("cpu", problem_cpu), ("cuda", problem_cuda)))
    s_cpu, s_gpu = h_cpu.stacked(), h_gpu.stacked()
    check((s_cpu["global_updates"] == s_gpu["global_updates"]).all()
          and (s_cpu["n_active"] == s_gpu["n_active"]).all(),
          "fleet card vs CPU: global updates or masks differ")
    check(np.allclose(s_cpu["train_loss"], s_gpu["train_loss"],
                      rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
          "fleet card vs CPU: losses differ")
    dparam = []
    for x, y in zip(tree_leaves(p_cpu), tree_leaves(p_gpu)):
        check(torch.allclose(x, y.cpu(), rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
              "fleet card vs CPU: params differ")
        dparam.append((x - y.cpu()).abs().max().item())
    dloss = np.abs(s_cpu["train_loss"] - s_gpu["train_loss"]).max()
    return (f"fleet card vs CPU fedavg_s50: K={len(FLEET_SEEDS)} x "
            f"{FLEET_CPU_ROUNDS} rounds, max |dparam| per leaf "
            f"{['%.2e' % d for d in dparam]}, max |dloss| {dloss:.2e}, "
            f"global updates {s_gpu['global_updates'][:, -1].tolist()} "
            f"(rtol {DEVICE_RTOL}, atol {DEVICE_ATOL})")


# --------------------------------------------------------------------------- #
# the scan engine: one captured round replayed a round, chunks staged
# --------------------------------------------------------------------------- #

class CohortDraws:
    """Host participation for the eviction runs: each round's mask holds
    EVICT_C unique ids, half from the hot set of ids < EVICT_HOT and half
    uniform over the rest, drawn as `eviction_phase` draws them."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def sample(self, t: int) -> np.ndarray:
        n, c = EVICT_N, EVICT_C
        hot = self.rng.choice(EVICT_HOT, c // 2, replace=False)
        rest = self.rng.choice(np.setdiff1d(np.arange(n), hot), c - c // 2,
                               replace=False)
        mask = np.zeros(n, bool)
        mask[np.concatenate([hot, rest])] = True
        return mask


def scan_equal(what, loop_run, scan_run) -> str:
    """A scan run against its loop run on the card: the same masks, and
    params and losses bit-equal, or else within SCAN_RTOL of their
    magnitudes (the gap is then reported). Returns the verdict."""
    from repro_torch.tree import tree_leaves
    d_loss, d_param = run_gaps(loop_run, scan_run)
    check(np.array_equal(np.asarray(loop_run[1].n_active),
                         np.asarray(scan_run[1].n_active)),
          f"{what}: scan and loop saw different masks")
    if d_loss == 0 and d_param == 0:
        return "bit-equal to the loop"
    p_scale = max(p.abs().max().item() for p in tree_leaves(loop_run[0]))
    l_scale = float(np.max(np.abs(loop_run[1].train_loss)))
    check(d_loss <= SCAN_RTOL * l_scale and d_param <= SCAN_RTOL * p_scale,
          f"{what}: scan off the loop by |dloss| {d_loss:.3e}, |dparam| "
          f"{d_param:.3e} (bound {SCAN_RTOL} of {l_scale:.3e}, "
          f"{p_scale:.3e})")
    return (f"NOT bit-equal to the loop: |dloss| {d_loss:.3e}, |dparam| "
            f"{d_param:.3e} (within {SCAN_RTOL} of the magnitudes)")


def scan_ms(dts, n_rounds=ROUNDS, chunk=SCAN_CHUNK) -> float:
    """Host ms a round of a scan run in chunks of `chunk` over its middle
    chunks: from the draw of round `chunk` to that of round n_rounds -
    chunk (the first chunk holds the warm-up and capture, the last the
    final reads)."""
    stamps = np.concatenate([[0.0], np.cumsum(dts)])
    a, b = chunk, n_rounds - chunk
    return float(stamps[b] - stamps[a]) / (b - a) * 1e3


def scan_phase(params0, problem, loop_runs, loop_ms) -> tuple[dict, list,
                                                               dict]:
    """The three paper paths of the main path under engine="scan" at full
    width, ROUNDS rounds in chunks of SCAN_CHUNK: each kernel launched once
    a replay plus once in the warm-up before capture, the run bit-equal to
    its loop run, and its host ms a round beside the loop's. Returns the
    launches, the report rows and the scan runs (params, history, dts)."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.core import MIFA
    paths = {"mifa_array": (lambda: MIFA(memory="array"), "mifa_aggregate"),
             "banked_dense": (lambda: BankedMIFA(DenseBank(device="cuda")),
                              "bank_scatter"),
             "banked_paged": (lambda: BankedMIFA(PagedDeviceBank(
                 page_size=PAGE_SIZE, device="cuda")),
                 "paged_bank_scatter")}
    launches, rows, runs = {}, [], {}
    for name, (make, kernel) in paths.items():
        cap = SCAN_CAP if name.startswith("banked") else None
        if cap is not None:     # the loop run at the scan's pinned width
            params, hist, dts = run_path(name, make(), problem, params0,
                                         ROUNDS, "cuda", ROUNDS,
                                         cohort_capacity=cap)
            loop_runs = {**loop_runs, name: (params, hist)}
            loop_ms = {**loop_ms, name: float(np.median(dts[10:])) * 1e3}
        reset_counts()
        params, hist, dts = run_path(name, make(), problem, params0, ROUNDS,
                                     "cuda", ROUNDS, engine="scan",
                                     cohort_capacity=cap)
        counts = read_counts()
        want = {k: ROUNDS + 1 if k == kernel else 0 for k in counts}
        check(counts == want, f"scan {name}: launches {counts}, expected "
                              f"{want} (a replay a round and the warm-up)")
        launches[kernel] = counts[kernel]
        runs[name] = (params, hist, dts)
        verdict = scan_equal(f"scan {name}", loop_runs[name],
                             (params, hist))
        width = "" if cap is None else f", cohorts pinned to {cap}"
        rows.append(f"scan {name}: {ROUNDS} rounds in chunks of "
                    f"{SCAN_CHUNK}{width}, {scan_ms(dts):.3f} ms/round (host "
                    f"clock, rounds {SCAN_CHUNK}-{ROUNDS - SCAN_CHUNK - 1}) "
                    f"vs loop {loop_ms[name]:.3f} ms/round (median, rounds "
                    f"10-{ROUNDS - 2}); {verdict}; launches {counts}")
    return launches, rows, runs


def eviction_scan_phase() -> tuple[dict, list]:
    """Eviction under engine="scan": EVICT_ROUNDS rounds of N=EVICT_N
    paper_mlp clients at full width (EVICT_C-client cohorts, half hot)
    through BankedMIFA(PagedDeviceBank(page_size=8, n_slots=48)) in chunks
    of one round (a chunk's cohort union must fit the slots), against the
    paged bank's and DenseBank's loop runs: bit-equal trajectories, and
    every row (through the gather kernel, one launch) and G_sum bit-equal
    to DenseBank's."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.core import RoundRunner
    from repro_torch.core.scan_engine import ScanDriver
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_leaves
    model, batcher, _, _ = paper_problem(n_clients=EVICT_N)

    def runner(bank):
        return RoundRunner(model=model, algo=BankedMIFA(bank),
                           batcher=batcher, schedule=inv_t(1.0),
                           weight_decay=1e-3, seed=0,
                           cohort_capacity=EVICT_C, device="cuda")

    def paged():
        return PagedDeviceBank(page_size=PAGE_SIZE, n_slots=EVICT_SLOTS,
                               device="cuda")
    loops = {}
    for name, bank in (("dense", DenseBank(device="cuda")),
                       ("paged", paged())):
        r, part = runner(bank), CohortDraws(12)
        for t in range(EVICT_ROUNDS):
            r.step(t, part.sample(t))
        loops[name] = r
    bank = paged()
    r = runner(bank)
    reset_counts()
    ScanDriver(r, scan_chunk=1).run(EVICT_ROUNDS,
                                    participation=CohortDraws(12))
    torch.cuda.synchronize()
    in_rounds = read_counts()
    check(in_rounds["paged_bank_scatter"] == EVICT_ROUNDS + 1
          and sum(in_rounds.values()) == EVICT_ROUNDS + 1,
          f"eviction scan launches {in_rounds}")
    check(bank.faults > 0 and bank.evictions > 0 and bank.refaults > 0,
          f"eviction scan did not evict and re-fault: faults {bank.faults}, "
          f"evictions {bank.evictions}, re-faults {bank.refaults}")
    bank.check_invariants(r.state["bank"])
    verdicts = [scan_equal(f"eviction scan vs {k} loop",
                           (loops[k].params, loops[k].hist),
                           (r.params, r.hist)) for k in ("paged", "dense")]
    everyone = np.arange(EVICT_N)
    dense_bank = loops["dense"].algo.bank
    rows_s = bank.gather(r.state["bank"], everyone)
    rows_d = dense_bank.gather(loops["dense"].state["bank"], everyone)
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(rows_s),
                                                tree_leaves(rows_d))),
          "eviction scan: paged rows differ from DenseBank's")
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(r.state["bank"]["g_sum"]),
        tree_leaves(loops["dense"].state["bank"]["g_sum"]))),
          "eviction scan: paged G_sum differs from DenseBank's")
    counts = read_counts()
    return counts, [
        f"eviction scan: N={EVICT_N}, {EVICT_ROUNDS} rounds of C={EVICT_C} "
        f"through PagedDeviceBank(page_size={PAGE_SIZE}, "
        f"n_slots={EVICT_SLOTS}) in chunks of 1: faults {bank.faults}, "
        f"evictions {bank.evictions}, re-faults {bank.refaults}; vs the "
        f"paged loop: {verdicts[0]}; vs the DenseBank loop: {verdicts[1]}; "
        f"all {EVICT_N} rows and G_sum bit-equal to DenseBank; launches in "
        f"the rounds {in_rounds}, with the gather {counts}"]


def check_quantizer_on_card() -> list:
    """The int8 quantizer on the card, with a CUDA generator: the scale
    equal to the CPU's, each value floor(x/scale) or one step up, the round
    trip within one quantum, the mean over 400 generator seeds within
    4·quantum/sqrt(400), zero rows exact, ±absmax at ±127."""
    from repro_torch.core import quantized_memory as qm
    x_cpu = torch.randn((N_CLIENTS, PATH_WIDTHS[1]),
                        generator=torch.Generator().manual_seed(3))
    x = x_cpu.cuda()
    q, s = qm.quantize_leaf(torch.Generator(device="cuda").manual_seed(0), x)
    _, s_cpu = qm.quantize_leaf(torch.Generator().manual_seed(0), x_cpu)
    check(torch.equal(s.cpu(), s_cpu), "int8 scale on the card != CPU")
    step = q.double() - torch.floor(x / s[:, None]).double()
    inner = q.abs() < 127
    check(bool(((step == 0) | (step == 1))[inner].all()),
          "int8 rounding left the floor/floor+1 bracket")
    err = (qm.dequantize_leaf(q, s) - x).abs()
    check(bool((err <= s[:, None] + 1e-12).all()),
          f"int8 round trip off by {err.max().item():.3e}")
    small = torch.randn((2, 24), generator=torch.Generator().manual_seed(
        7)).cuda() * 0.5
    reps = 400
    acc = torch.zeros_like(small)
    for i in range(reps):
        acc += qm.dequantize_leaf(*qm.quantize_leaf(
            torch.Generator(device="cuda").manual_seed(i), small))
    quantum = small.abs().max().item() / 127.0
    bias = (acc / reps - small).abs().max().item()
    check(bias <= 4 * quantum / math.sqrt(reps) + 1e-7,
          f"int8 rounding biased: mean off by {bias:.3e}")
    zq, zs = qm.quantize_leaf(torch.Generator(device="cuda"),
                              torch.zeros((3, 16), device="cuda"))
    check(not zq.any() and bool((zs > 0).all()), "int8 zero rows")
    cq, _ = qm.quantize_leaf(torch.Generator(device="cuda"), torch.tensor(
        [[3.0, -3.0, 1.5, 0.0]], device="cuda"))
    check(cq[0, 0].item() == 127 and cq[0, 1].item() == -127,
          "int8 absmax not at +-127")
    return [f"int8 quantizer on the card ({N_CLIENTS}x{PATH_WIDTHS[1]}): "
            f"scale equal to the CPU's, values in the floor bracket, round "
            f"trip max |err| {err.max().item():.3e} (within one quantum), "
            f"mean over {reps} seeds off by {bias:.3e} (bound "
            f"{4 * quantum / math.sqrt(reps):.3e}), zero rows exact, "
            f"+-absmax at +-127"]


def int8_phase(params0, problem, array_run) -> list:
    """int8 memory on the card at full width: the quantizer's checks;
    MIFA(int8) and BankedMIFA(PagedDeviceBank(int8)) for ROUNDS rounds on
    the loop and on the scan (the rounding drawn from the run's device
    generator, registered with the captured graph), scan bit-equal to
    loop, losses within INT8_LOSS_RTOL of MIFA(array)'s; the int8 bank's
    G_sum against the sum of its dequantized rows."""
    from repro_torch.bank import BankedMIFA, PagedDeviceBank
    from repro_torch.core import MIFA
    from repro_torch.tree import tree_leaves, tree_map
    rows = check_quantizer_on_card()
    banks = []

    def int8_bank():
        banks.append(PagedDeviceBank(page_size=PAGE_SIZE, dtype="int8",
                                     device="cuda"))
        return BankedMIFA(banks[-1])
    want = np.asarray(array_run[1].train_loss)
    for name, make in (("mifa_int8", lambda: MIFA(memory="int8")),
                       ("banked_paged_int8", int8_bank)):
        runs = {}
        cap = SCAN_CAP if name.startswith("banked") else None
        for engine in ("loop", "scan"):
            reset_counts()
            runs[engine] = run_path(name, make(), problem, params0, ROUNDS,
                                    "cuda", ROUNDS, engine=engine,
                                    cohort_capacity=cap)[:2]
            counts = read_counts()
            check(not any(counts.values()),
                  f"{name} {engine}: int8 memory launched {counts}")
        verdict = scan_equal(f"scan {name}", runs["loop"], runs["scan"])
        got = np.asarray(runs["scan"][1].train_loss)
        gap = float(np.max(np.abs(got - want)
                           / np.maximum(np.abs(want), 1e-12)))
        check(bool(np.isfinite(got).all()) and gap <= INT8_LOSS_RTOL,
              f"{name}: losses off MIFA(array)'s by {gap:.3e} (relative; "
              f"bound {INT8_LOSS_RTOL})")
        rows.append(f"{name}: {ROUNDS} rounds, scan {verdict}; max "
                    f"relative train-loss gap to MIFA(array) {gap:.3e} "
                    f"(bound {INT8_LOSS_RTOL}); eval loss "
                    f"{runs['scan'][1].eval_loss[-1][1]:.4f} vs "
                    f"{array_run[1].eval_loss[-1][1]:.4f}")
    bank = banks[-1]
    # the scan run's bank: G_sum against the sum of all rows, dequantized
    state = bank.init(params0, N_CLIENTS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(4)
    for _ in range(20):
        ids = np.sort(rng.choice(N_CLIENTS, 40, replace=False))
        upd = tree_map(lambda p: torch.randn(
            (len(ids),) + tuple(p.shape), generator=gen, device="cuda"),
            params0)
        state = bank.scatter(state, ids, upd, rng=gen)
    g_rows = bank.gather(state, np.arange(N_CLIENTS))
    rtol, atol = TOL[torch.float32]
    g_err = 0.0
    for g, r in zip(tree_leaves(state["g_sum"]), tree_leaves(g_rows)):
        err = (g.double() - r.double().sum(0)).abs()
        check(bool((err <= atol + rtol * r.double().abs().sum(0)).all()),
              f"int8 bank G_sum off the sum of its rows by "
              f"{err.max().item():.3e}")
        g_err = max(g_err, err.max().item())
    rows.append(f"PagedDeviceBank(int8): 20 scatters of 40 rows, G_sum vs "
                f"the sum of the dequantized rows max |err| {g_err:.3e} "
                f"(rtol {rtol} of the summed magnitudes)")
    return rows


# the port's CUDA kernel names, by the counter of the wrapper launching it
CUDA_NAMES = {"mifa_aggregate": "mifa_aggregate_kernel",
              "bank_scatter": "bank_scatter_kernel",
              "paged_bank_scatter": "paged_scatter_kernel"}


def profiled_scan(params0, problem) -> list:
    """One scan run each of MIFA(array) and BankedMIFA(DenseBank) of
    PROFILE_ROUNDS rounds (`ScanDriver` on a `RoundRunner`, as `run_fl`
    drives them) under torch.profiler: the kernels the trace shows by
    name, counted, must equal the launch counters (replays and the
    warm-up); the device's busy time and idle share of the run's wall
    time; the `ScanDriver`'s replays, captured graphs and bytes staged a
    chunk."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import BernoulliParticipation, MIFA, RoundRunner
    from repro_torch.core.runner import ROUND_PHASES
    from repro_torch.core.scan_engine import ScanDriver
    from repro_torch.optim import inv_t
    model, batcher, probs, _ = problem
    rows = []
    for name, algo, kernel in (
            ("mifa_array", MIFA(), "mifa_aggregate"),
            ("banked_dense", BankedMIFA(DenseBank(device="cuda")),
             "bank_scatter")):
        runner = RoundRunner(model=model, algo=algo, batcher=batcher,
                             schedule=inv_t(1.0), weight_decay=1e-3,
                             params=clone_tree(params0, "cuda"),
                             device="cuda")
        driver = ScanDriver(runner, scan_chunk=SCAN_CHUNK)
        reset_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            driver.run(PROFILE_ROUNDS,
                       participation=BernoulliParticipation(probs, seed=1))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        # device ops, without the phase ranges' totals of the kernels in
        # them (the warm-up round's), which the kernels count already
        ops = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.key not in ROUND_PHASES]
        seen = sum(e.count for e in ops if CUDA_NAMES[kernel] in e.key)
        check(seen == counts[kernel],
              f"profiled scan {name}: the trace shows {seen} "
              f"{CUDA_NAMES[kernel]} kernels, the counter {counts[kernel]}")
        check(driver.replays == PROFILE_ROUNDS,
              f"profiled scan {name}: {driver.replays} replays")
        busy = sum(e.self_device_time_total for e in ops) / 1e3
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:4]
        chunks = driver.chunks.chunks
        rows.append(
            f"profiled scan {name}: {PROFILE_ROUNDS} rounds in {chunks} "
            f"chunks, {driver.replays} replays of "
            f"{len(driver.chunks.graphs)} captured graph(s), "
            f"{driver.staged_bytes // chunks} B staged a chunk (one pinned "
            f"copy); {CUDA_NAMES[kernel]} {seen} in the trace = "
            f"{counts[kernel]} counted; device busy {busy:.2f} ms of "
            f"{wall_ms:.2f} ms wall (idle share {1 - busy / wall_ms:.3f}), "
            f"{busy / PROFILE_ROUNDS:.3f} ms a round; top "
            + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f}"
                        f" ms x{e.count}" for e in top))
    return rows


def fleet_scan_phase(problem, fleet_runs) -> tuple[dict, list, dict]:
    """The Figure 2 fleets that can scan (no update clock: the dense-mask
    MIFA(array), BiasedFedAvg and FedAvgIS fleets and both cohort fleets,
    these pinned to SCAN_CAP on the scan and on a loop run of their own)
    under engine="scan", each bit-equal to its loop fleet, with its
    kernel launched once a replay plus once in the warm-up (MIFA(array):
    once a trial). Returns the launches, the report rows and the scan
    fleets (params, history, dts)."""
    from repro_torch.fleet import make_fleet_eval
    fleet_eval = make_fleet_eval(problem[0], problem[3].eval_batch,
                                 device="cuda")
    k_trials = len(FLEET_SEEDS)
    launches, rows, runs = {}, [], {}
    for name, (clock, _, kernel) in FIG2.items():
        if clock:
            continue
        loop = fleet_runs[name]
        if name.startswith("banked"):   # the loop at the scan's width
            loop = run_fig2_fleet(name, problem, FLEET_ROUNDS, "cuda",
                                  fleet_eval, cap=SCAN_CAP)
        reset_counts()
        params, hist, dts = run_fig2_fleet(name, problem, FLEET_ROUNDS,
                                           "cuda", fleet_eval, engine="scan",
                                           cap=SCAN_CAP)
        counts = read_counts()
        per = k_trials if kernel == "mifa_aggregate" else 1
        want = {k: (FLEET_ROUNDS + 1) * per if k == kernel else 0
                for k in counts}
        check(counts == want, f"fleet scan {name}: launches {counts}, "
                              f"expected {want}")
        if kernel in ("bank_scatter_batched", "paged_bank_scatter_batched"):
            launches[kernel] = counts[kernel]
        runs[name] = (params, hist, dts)
        check(all(np.array_equal(a, b) for a, b in zip(
            [loop[1].stacked()[k] for k in ("train_loss", "n_active")],
            [hist.stacked()[k] for k in ("train_loss", "n_active")])),
              f"fleet scan {name}: losses or masks differ from the loop's")
        verdict = scan_equal(f"fleet scan {name}", loop[:2], (params, hist))
        rows.append(f"fleet scan {name}: K={k_trials} x {FLEET_ROUNDS} "
                    f"rounds in chunks of {SCAN_CHUNK}, "
                    f"{scan_ms(dts, FLEET_ROUNDS):.3f} ms/round vs loop "
                    f"{np.median(loop[2][10:]) * 1e3:.3f}; {verdict}; "
                    f"launches {counts}")
    return launches, rows, runs


# the paths the mesh phase runs on a 1x1 mesh, with the kernel each
# launches: the two single-run paths of the scan phase and one fleet
MESH_PATHS = {"mifa_array": "mifa_aggregate", "banked_dense": "bank_scatter",
              "fleet banked_dense": "bank_scatter_batched"}


def mesh_phase(params0, problem, scan_runs, fleet_scan_runs,
               smi) -> tuple[dict, list]:
    """`run_fl(mesh=)` and `run_fleet(mesh=)` on the card: a gloo world of
    one rank from a `HashStore` (no TCP rendezvous), a 1x1
    `make_host_mesh(device="cuda")`, and the scan phase's runs again on
    it: MIFA(array), BankedMIFA(DenseBank()) (a mesh-less bank, which the
    run hands its mesh) and the Figure 2 dense-bank fleet. At data extent
    1 nothing is split and no collective is issued, so each must be
    bit-equal to its scan run without a mesh, with the same launches
    (a replay a round and the warm-up). Returns the launches of each
    kernel and the report rows."""
    import torch.distributed as dist
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import MIFA
    from repro_torch.fleet import make_fleet_eval
    from repro_torch.launch.mesh import make_host_mesh
    check(not dist.is_initialized(), "mesh phase: a process group is "
                                     "already initialised")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    launches, rows = {}, []
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        fleet_eval = make_fleet_eval(problem[0], problem[3].eval_batch,
                                     device="cuda")
        for name, kernel in MESH_PATHS.items():
            reset_counts()
            if name.startswith("fleet"):
                rounds, ref = FLEET_ROUNDS, fleet_scan_runs["banked_dense"]
                params, hist, dts = run_fig2_fleet(
                    "banked_dense", problem, rounds, "cuda", fleet_eval,
                    engine="scan", cap=SCAN_CAP, mesh=mesh)
            else:
                rounds, ref = ROUNDS, scan_runs[name]
                algo = (MIFA(memory="array") if name == "mifa_array"
                        else BankedMIFA(DenseBank(device="cuda")))
                cap = SCAN_CAP if name == "banked_dense" else None
                params, hist, dts = run_path(
                    name, algo, problem, params0, rounds, "cuda", rounds,
                    engine="scan", cohort_capacity=cap, mesh=mesh)
                if name == "banked_dense":
                    check(algo.bank.mesh is mesh and algo.bank.shard is None
                          and algo.bank.n_rows == N_CLIENTS + 1,
                          "mesh banked_dense: the bank did not take the "
                          "run's 1x1 mesh as one whole block")
            counts = read_counts()
            want = {k: rounds + 1 if k == kernel else 0 for k in counts}
            check(counts == want, f"mesh {name}: launches {counts}, "
                                  f"expected {want}")
            launches[kernel] = counts[kernel]
            d_loss, d_param = run_gaps(ref[:2], (params, hist))
            check(d_loss == 0 and d_param == 0 and np.array_equal(
                np.asarray(ref[1].n_active), np.asarray(hist.n_active)),
                  f"mesh {name}: not bit-equal to its scan run without a "
                  f"mesh: |dloss| {d_loss:.3e}, |dparam| {d_param:.3e}")
            rows.append(
                f"mesh {name}: {rounds} rounds in chunks of {SCAN_CHUNK} on "
                f"a 1x1 DeviceMesh (gloo, world of 1), "
                f"{scan_ms(dts, rounds):.3f} ms/round vs "
                f"{scan_ms(ref[2], rounds):.3f} without a mesh (host clock, "
                f"rounds {SCAN_CHUNK}-{rounds - SCAN_CHUNK - 1}); bit-equal "
                f"to it; launches {counts}; {smi}")
        more, snap_launches = mesh_snapshot_runs(params0, problem, mesh, smi)
        rows += more
        launches["checkpoint"] = snap_launches
    finally:
        dist.destroy_process_group()
    rows.append(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return launches, rows


# the mesh phase's snapshot and int8 runs: MESH_SNAP_ROUNDS rounds of the
# paper path, a snapshot every MESH_SNAP_EVERY, under build/
MESH_SNAP_ROUNDS, MESH_SNAP_EVERY = 20, 10
MESH_SNAP_DIR = ROOT / "build" / "mesh_snapshots"


def snapshot_members_equal(a_path, b_path) -> tuple[bool, int]:
    """Do two run snapshots hold the same members (name, dtype, shape and
    bytes, in order)? The npz container's timestamps are not compared.
    Returns (equal, member bytes)."""
    with np.load(a_path) as a, np.load(b_path) as b:
        if a.files != b.files:
            return False, 0
        nbytes, same = 0, True
        for k in a.files:
            x, y = a[k], b[k]
            same = same and (x.dtype == y.dtype and x.shape == y.shape
                             and x.tobytes() == y.tobytes())
            nbytes += x.nbytes
    return same, nbytes


def mesh_snapshot_runs(params0, problem, mesh, smi) -> tuple[list, int]:
    """A `checkpoint=` MIFA(array) scan and a MIFA(memory="int8") scan,
    each on the 1x1 `mesh` and without one: the two runs bit-equal with
    the same launches, and each snapshot of the meshed run holding the
    unmeshed run's members byte for byte. Returns the rows and the
    meshed checkpoint run's `mifa_aggregate` launches."""
    import shutil

    from repro_torch.checkpoint import CheckpointSpec, list_checkpoints
    from repro_torch.core import MIFA
    rows = []
    shutil.rmtree(MESH_SNAP_DIR, ignore_errors=True)
    try:
        for name, memory in (("checkpoint", "array"), ("int8", "int8")):
            runs = {}
            for key, m in (("none", None), ("1x1", mesh)):
                ck = (CheckpointSpec(every=MESH_SNAP_EVERY,
                                     dir=str(MESH_SNAP_DIR / key))
                      if name == "checkpoint" else None)
                reset_counts()
                t0 = time.perf_counter()
                params, hist, _ = run_path(
                    f"mesh {name}", MIFA(memory=memory), problem, params0,
                    MESH_SNAP_ROUNDS, "cuda", MESH_SNAP_ROUNDS,
                    engine="scan", mesh=m, checkpoint=ck)
                runs[key] = (params, hist, read_counts(),
                             time.perf_counter() - t0)
            (p0, h0, c0, s0), (p1, h1, c1, s1) = runs["none"], runs["1x1"]
            check(c0 == c1, f"mesh {name}: launches {c1} on the mesh, {c0} "
                            "without")
            d_loss, d_param = run_gaps((p0, h0), (p1, h1))
            check(d_loss == 0 and d_param == 0 and np.array_equal(
                np.asarray(h0.n_active), np.asarray(h1.n_active)),
                  f"mesh {name}: not bit-equal to its run without a mesh: "
                  f"|dloss| {d_loss:.3e}, |dparam| {d_param:.3e}")
            what = f"bit-equal to it, launches {c1}"
            if name == "checkpoint":
                snaps = [list_checkpoints(str(MESH_SNAP_DIR / k))
                         for k in ("none", "1x1")]
                check([r for r, _ in snaps[0]] == [r for r, _ in snaps[1]]
                      == list(range(MESH_SNAP_EVERY, MESH_SNAP_ROUNDS + 1,
                                    MESH_SNAP_EVERY)),
                      f"mesh checkpoint: snapshots {snaps}")
                sizes = []
                for (_, a), (_, b) in zip(*snaps):
                    same, nbytes = snapshot_members_equal(a, b)
                    check(same, f"mesh checkpoint: {b} differs from {a}")
                    sizes.append(nbytes)
                what += (f"; snapshots after rounds "
                         f"{[r for r, _ in snaps[1]]} hold the unmeshed "
                         f"run's members byte for byte ({sizes} B)")
                launches = c1["mifa_aggregate"]
            rows.append(
                f"mesh {name}: MIFA(memory={memory!r}) scan, "
                f"{MESH_SNAP_ROUNDS} rounds in chunks of {SCAN_CHUNK}"
                + (f", a snapshot every {MESH_SNAP_EVERY}"
                   if name == "checkpoint" else "")
                + f", on the 1x1 mesh: {s1:.2f} s against {s0:.2f} s "
                f"without (host clock, the capture included); {what}; {smi}")
    finally:
        shutil.rmtree(MESH_SNAP_DIR, ignore_errors=True)
    return rows, launches


# --------------------------------------------------------------------------- #
# scenarios: availability sampled inside the round on the card
# --------------------------------------------------------------------------- #

# the surface checks: rounds, scenario seed, and the device count of the
# large Bernoulli check
SCEN_ROUNDS, SCEN_SEED, SCEN_BIG_N = 32, 7, 10**6
# the paths' availability: Gilbert–Elliott bursts at rate 0.5 and mean
# off-burst 8 rounds for the dense runs (bursts 2, 4 and 8 in the fleet),
# the registry's cluster outages for the cohort runs (|A| up to N, so
# they pin SCAN_CAP)
SCEN_GE, SCEN_BURSTS = {"rate": 0.5, "burst": 8.0}, (2.0, 4.0, 8.0)
# the cohort runs under cluster outages take the host surface, as the
# participation paths of steps 4-5 and 10-11 do: SCEN_COHORT_ROUNDS rounds
# hold their kernels' counts and the scan (chunks of SCAN_CHUNK; the middle
# two timed)
SCEN_COHORT_ROUNDS = 20


class TimedBatcher:
    """The problem's batcher, stamping the host clock as each round's batch
    is drawn: where a scenario run's round starts on the loop (it draws no
    host mask), and as the scan stages a chunk. Consecutive stamps of a
    loop run bound one round (each ends in a sync)."""

    def __init__(self, inner):
        self.inner = inner
        self.stamps: list[float] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def sample_round(self, t: int, client_ids=None):
        self.stamps.append(time.perf_counter())
        return self.inner.sample_round(t, client_ids=client_ids)


def scen_ge(seed: int = SCEN_SEED, burst: float = SCEN_GE["burst"]):
    from repro_torch.scenarios import make_scenario
    return make_scenario("gilbert_elliott", n=N_CLIENTS, seed=seed,
                         rate=SCEN_GE["rate"], burst=burst)


def scen_cluster(seed: int = SCEN_SEED):
    from repro_torch.scenarios import make_scenario
    return make_scenario("cluster", n=N_CLIENTS, seed=seed)


def run_scen(algo, problem, params0, scen, n_rounds, device, engine="loop",
             cap=None, chunk=SCAN_CHUNK):
    """One run of the paper problem under `scen` (evaluated at rounds 0 and
    n_rounds - 1; the scan in chunks of `chunk`); returns (params, history,
    host seconds between the batch draws of consecutive rounds)."""
    from repro_torch.core import run_fl
    from repro_torch.optim import inv_t
    model, batcher, _, eval_fn = problem
    timed = TimedBatcher(batcher)
    params, hist = run_fl(model=model, algo=algo, scenario=scen,
                          batcher=timed, schedule=inv_t(1.0),
                          n_rounds=n_rounds, weight_decay=1e-3,
                          params=clone_tree(params0, device),
                          eval_fn=eval_fn, eval_every=n_rounds,
                          engine=engine, scan_chunk=chunk,
                          cohort_capacity=cap, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return params, hist, np.diff(timed.stamps)


def scen_surface_checks() -> list:
    """The device surface on the card against the CPU's host surface:
    every registered process at N_CLIENTS and Bernoulli at SCEN_BIG_N,
    SCEN_ROUNDS rounds each (the round index a device tensor, as in a
    captured round), array-equal."""
    from repro_torch.scenarios import make_process, scenario_names
    rows = []
    ts = torch.arange(SCEN_ROUNDS, device="cuda")
    for name, n in ([(s, N_CLIENTS) for s in scenario_names()]
                    + [("bernoulli", SCEN_BIG_N)]):
        proc = make_process(name, n=n, seed=SCEN_SEED)
        fn, key = proc.sample_fn(), proc.key.cuda()
        state = proc.init_state("cuda")
        card = []
        for t in range(SCEN_ROUNDS):
            mask, state = fn(key, ts[t], state)
            card.append(mask)
        card = torch.stack(card).cpu().numpy()
        cpu = proc.host_sampler().sample_block(0, SCEN_ROUNDS)
        check(np.array_equal(card, cpu),
              f"scenario {name} N={n}: the card's masks differ from the "
              f"CPU's in {int((card != cpu).sum())} places")
        rows.append(f"{name} N={n}: {SCEN_ROUNDS} rounds of card masks "
                    f"array-equal to the CPU host surface, mean rate "
                    f"{card[1:].mean():.4f} (stationary "
                    f"{proc.stationary_rate().mean():.4f})")
    return ["scenario surfaces: " + "; ".join(rows)]


def dispatched_ops(fn) -> int:
    """The PyTorch operations `fn()` dispatches, views not counted: on the
    card each is one kernel launch (the sampler's are elementwise, arange,
    fill, stack, gather and searchsorted kernels)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def sampler_cost(name: str, n: int) -> str:
    """One draw of `name`'s device surface at n devices: its kernel
    launches, the host time of an eager draw and the device time of a
    replayed one."""
    from repro_torch.scenarios import make_process
    proc = make_process(name, n=n, seed=SCEN_SEED)
    fn, key = proc.sample_fn(), proc.key.cuda()
    state, t = proc.init_state("cuda"), torch.tensor(5, device="cuda")
    launches = dispatched_ops(lambda: fn(key, t, state))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn(key, t, state)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    dev_ms = time_round_ms([lambda: fn(key, t, state)])
    return (f"sampler {name} N={n}: {launches} kernel launches a draw, "
            f"eager {host_ms:.3f} ms a draw (host clock, launch-bound), "
            f"{dev_ms * 1e3:.2f} us device time a draw (graph replays)")


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def scen_run_row(what, n_rounds, dts, hist, counts, scan=None,
                 chunk=SCAN_CHUNK) -> str:
    loop_ms = float(np.median(dts[10:])) * 1e3
    text = (f"scenario {what}: {n_rounds} rounds, loop {loop_ms:.3f} "
            f"ms/round (median, rounds 10-{n_rounds - 2}, host clock)")
    if scan is not None:
        text += (f", scan {scan_ms(scan, n_rounds, chunk):.3f} ms/round "
                 f"(rounds {chunk}-{n_rounds - chunk - 1})")
    return (text + f", mean |A(t)| {np.mean(hist.n_active):.2f}, tau_bar "
            f"{hist.tau_bar:.4f}, tau_max {hist.tau_max}, launches "
            f"{nonzero(counts)}")


def expect_launches(what, counts, kernel, n) -> None:
    """`kernel` launched n times and no other kernel."""
    want = {k: n if k == kernel else 0 for k in counts}
    check(counts == want, f"{what}: launches {counts}, expected {want}")


def scen_expect(what, counts, kernel, n) -> None:
    expect_launches(f"scenario {what}", counts, kernel, n)


def scen_masks_match_host(what, hist, scen, n_rounds) -> None:
    """A run's masks are the CPU host surface's: n_active and the τ
    statistics of the host masks."""
    from repro_torch.core import TauStats
    masks = scen.process.host_sampler().sample_block(0, n_rounds)
    stats = TauStats(N_CLIENTS, strict=False)
    for m in masks:
        stats.update(m)
    check(hist.n_active == masks.sum(1).astype(float).tolist(),
          f"scenario {what}: |A(t)| differs from the CPU host surface's")
    check((hist.tau_bar, hist.tau_max) == (stats.tau_bar, stats.tau_max),
          f"scenario {what}: tau ({hist.tau_bar}, {hist.tau_max}) vs the "
          f"host masks' ({stats.tau_bar}, {stats.tau_max})")


def scen_card_vs_cpu(what, make, problem, problem_cpu, params0, scen,
                     rows) -> None:
    """CPU_ROUNDS rounds on the card and on the CPU, held together."""
    from repro_torch.tree import tree_leaves
    gpu = run_scen(make("cuda"), problem, params0, scen, CPU_ROUNDS,
                   "cuda")
    cpu = run_scen(make("cpu"), problem_cpu, params0, scen, CPU_ROUNDS,
                   "cpu")
    check(gpu[1].n_active == cpu[1].n_active,
          f"scenario {what}: card and CPU masks differ")
    pairs = [(x, y.cpu()) for x, y in zip(tree_leaves(cpu[0]),
                                           tree_leaves(gpu[0]))]
    for x, y in pairs:
        check(torch.allclose(x, y, rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
              f"scenario {what}: card and CPU params differ")
    check(np.allclose(cpu[1].train_loss, gpu[1].train_loss,
                      rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
          f"scenario {what}: card and CPU losses differ")
    dloss = float(np.max(np.abs(np.subtract(cpu[1].train_loss,
                                            gpu[1].train_loss))))
    dparam = max((x - y).abs().max().item() for x, y in pairs)
    rows.append(f"scenario {what} card vs CPU: {CPU_ROUNDS} rounds, the "
                f"same masks, max |dloss| {dloss:.2e}, max |dparam| "
                f"{dparam:.2e} (rtol {DEVICE_RTOL}, atol {DEVICE_ATOL})")


def run_scen_fleet(make, problem, params0, scens, n_rounds, engine,
                   cap=None):
    """A fleet of len(scens) trials, one scenario each (seeds FLEET_SEEDS,
    every trial from params0), `n_rounds` rounds; returns (params,
    history, host seconds between consecutive rounds' batch draws)."""
    from repro_torch.fleet import Trial, run_fleet
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_stack
    model, batcher, _, _ = problem
    timed = TimedBatcher(batcher)
    params, hist = run_fleet(
        model=model, algo=make(), batcher=timed, schedule=inv_t(1.0),
        n_rounds=n_rounds, weight_decay=1e-3, cohort_capacity=cap,
        trials=[Trial(seed=s, scenario=sc) for s, sc in zip(FLEET_SEEDS,
                                                             scens)],
        params=tree_stack([clone_tree(params0, "cuda")
                           for _ in scens]),
        engine=engine, scan_chunk=SCAN_CHUNK, device="cuda")
    torch.cuda.synchronize()
    return params, hist, np.diff(timed.stamps)


def scenario_phase(params0, problem, problem_cpu) -> tuple[dict, list]:
    """The scenario path on the card: the surfaces, the samplers' cost,
    MIFA(array) under Gilbert–Elliott bursts and BankedMIFA(DenseBank) /
    BankedMIFA(PagedDeviceBank) under cluster outages for ROUNDS rounds on
    the loop and the scan, a 3-trial Gilbert–Elliott fleet (bursts 2, 4,
    8) on both engines and a 3-trial cohort fleet under cluster outages,
    FedAR and CAFed card against CPU. Each count is read right after its
    run. Returns (launches of each kernel on the scenario path's loop
    runs, report rows)."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.core import MIFA, CAFed, FedAR
    laps, mark = {}, [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        laps[what] = laps.get(what, 0.0) + now - mark[0]
        mark[0] = now

    rows = scen_surface_checks()
    lap("surfaces")
    rows += [sampler_cost("gilbert_elliott", N_CLIENTS),
             sampler_cost("bernoulli", SCEN_BIG_N)]
    lap("samplers")
    launches = {}

    # MIFA(array) under Gilbert–Elliott bursts: in-round draws
    runs, counts = {}, {}
    for engine in ("loop", "scan"):
        reset_counts()
        runs[engine] = run_scen(MIFA(), problem, params0, scen_ge(), ROUNDS,
                                "cuda", engine=engine)
        counts[engine] = read_counts()
        scen_expect(f"MIFA(array) {engine}", counts[engine],
                    "mifa_aggregate", ROUNDS + (engine == "scan"))
    launches["mifa_aggregate"] = counts["loop"]["mifa_aggregate"]
    loop, scan = runs["loop"], runs["scan"]
    verdict = scan_equal("scenario MIFA(array)", loop[:2], scan[:2])
    check((loop[1].tau_bar, loop[1].tau_max)
          == (scan[1].tau_bar, scan[1].tau_max),
          "scenario MIFA(array): the scan's tau statistics differ")
    scen_masks_match_host("MIFA(array)", loop[1], scen_ge(), ROUNDS)
    rows.append(scen_run_row("MIFA(array) gilbert_elliott rate 0.5 burst 8",
                             ROUNDS, loop[2], loop[1], counts["loop"],
                             scan[2])
                + f"; scan {verdict}, tau statistics equal, scan launches "
                  f"{nonzero(counts['scan'])}")
    lap("MIFA(array) runs")
    scen_card_vs_cpu("MIFA(array)", lambda d: MIFA(), problem, problem_cpu,
                     params0, scen_ge(), rows)
    lap("card vs CPU")

    # the cohort path: the host surface, bank_scatter and its paged form
    cohort = {}
    for name, make, kernel, engines in (
            ("BankedMIFA(DenseBank)", lambda: BankedMIFA(DenseBank(
                device="cuda")), "bank_scatter", ("loop", "scan")),
            ("BankedMIFA(PagedDeviceBank)", lambda: BankedMIFA(
                PagedDeviceBank(page_size=PAGE_SIZE, device="cuda")),
             "paged_bank_scatter", ("loop",))):
        for engine in engines:
            reset_counts()
            cohort[name, engine] = run_scen(make(), problem, params0,
                                            scen_cluster(),
                                            SCEN_COHORT_ROUNDS, "cuda",
                                            engine=engine, cap=SCAN_CAP)
            counts[engine] = read_counts()
            scen_expect(f"{name} {engine}", counts[engine], kernel,
                        SCEN_COHORT_ROUNDS + (engine == "scan"))
        launches[kernel] = counts["loop"][kernel]
        run = cohort[name, "loop"]
        scen_masks_match_host(name, run[1], scen_cluster(),
                              SCEN_COHORT_ROUNDS)
        scan = cohort.get((name, "scan"))
        row = scen_run_row(f"{name} cluster", SCEN_COHORT_ROUNDS, run[2],
                           run[1], counts["loop"],
                           None if scan is None else scan[2])
        if scan is not None:
            row += ("; scan " + scan_equal(f"scenario {name}", run[:2],
                                           scan[:2])
                    + f", scan launches {nonzero(counts['scan'])}")
        rows.append(row)
    d_loss, d_param = run_gaps(cohort["BankedMIFA(DenseBank)", "loop"][:2],
                               cohort["BankedMIFA(PagedDeviceBank)",
                                      "loop"][:2])
    check(d_loss == 0 and d_param == 0,
          f"scenario cluster: the paged bank off the dense one by |dloss| "
          f"{d_loss:.3e}, |dparam| {d_param:.3e}")
    rows.append("scenario cluster: BankedMIFA(PagedDeviceBank) bit-equal "
                "to BankedMIFA(DenseBank)")
    lap("bank runs")

    # fleets: one in-round sample over three stacked Gilbert–Elliott chains,
    # and a cohort fleet on the host surfaces
    ge = [scen_ge(100 + s, b) for s, b in zip(FLEET_SEEDS, SCEN_BURSTS)]
    fleets = {}
    for engine in ("loop", "scan"):
        reset_counts()
        fleets[engine] = run_scen_fleet(MIFA, problem, params0, ge, ROUNDS,
                                        engine)
        counts = read_counts()
        per = len(FLEET_SEEDS) * (ROUNDS + (engine == "scan"))
        scen_expect(f"fleet MIFA(array) {engine}", counts, "mifa_aggregate",
                    per)
    loop, scan = fleets["loop"], fleets["scan"]
    check(all(np.array_equal(loop[1].stacked()[k], scan[1].stacked()[k])
              for k in ("train_loss", "n_active")),
          "scenario fleet: the scan's losses or masks differ")
    verdict = scan_equal("scenario fleet", loop[:2], scan[:2])
    for k, sc in enumerate(ge):
        masks = sc.process.host_sampler().sample_block(0, ROUNDS)
        check(loop[1].trial(k).n_active == masks.sum(1).astype(
            float).tolist(), f"scenario fleet trial {k}: masks differ "
                             "from the CPU host surface's")
    rows.append(
        f"scenario fleet MIFA(array), K={len(ge)} gilbert_elliott bursts "
        f"{SCEN_BURSTS}: {ROUNDS} rounds, loop "
        f"{np.median(loop[2][10:]) * 1e3:.3f} ms/round, scan "
        f"{scan_ms(scan[2], ROUNDS):.3f} ms/round (host clock); scan "
        f"{verdict}; "
        f"mean |A(t)| per trial "
        f"{np.round(loop[1].stacked()['n_active'].mean(1), 2).tolist()}; "
        f"mifa_aggregate {len(ge) * ROUNDS} on the loop, "
        f"{len(ge) * (ROUNDS + 1)} on the scan")
    reset_counts()
    clusters = [scen_cluster(100 + s) for s in FLEET_SEEDS]
    cfleet = run_scen_fleet(lambda: BankedMIFA(DenseBank(device="cuda")),
                            problem, params0, clusters, SCEN_COHORT_ROUNDS,
                            "loop", cap=SCAN_CAP)
    counts = read_counts()
    scen_expect("cohort fleet", counts, "bank_scatter_batched",
                SCEN_COHORT_ROUNDS)
    for k, sc in enumerate(clusters):
        masks = sc.process.host_sampler().sample_block(0, SCEN_COHORT_ROUNDS)
        check(cfleet[1].trial(k).n_active == masks.sum(1).astype(
            float).tolist(), f"scenario cohort fleet trial {k}: masks "
                             "differ from the CPU host surface's")
    launches["bank_scatter_batched"] = counts["bank_scatter_batched"]
    rows.append(f"scenario cohort fleet BankedMIFA(DenseBank), K=3 cluster: "
                f"{SCEN_COHORT_ROUNDS} rounds, loop "
                f"{np.median(cfleet[2][10:]) * 1e3:.3f} ms/round; launches "
                f"{nonzero(counts)}")

    lap("fleets")
    # the other algorithms, card against CPU
    scen_card_vs_cpu("FedAR", lambda d: FedAR(), problem, problem_cpu,
                     params0, scen_ge(), rows)
    scen_card_vs_cpu("CAFed", lambda d: CAFed(), problem, problem_cpu,
                     params0, scen_ge(), rows)
    lap("card vs CPU")
    rows.append(f"scenario phase: {sum(laps.values()):.1f} s ("
                + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items())
                + ")")
    return launches, rows


# --------------------------------------------------------------------------- #
# the runtime simulator: the heap engine, the compiled engine, fleets
# --------------------------------------------------------------------------- #

# benchmarks/time_to_accuracy.py's simulated clock (its SimConfig, :259)
# over the registry's cluster outages and the tiered latency fleet
SIM_CONFIG = {"epoch_s": 4.0, "server_overhead_s": 0.05,
              "max_lookahead_epochs": 64}
# the simulator's runs take SIM_ROUNDS rounds (a compiled run's middle
# chunks need three of SCAN_CHUNK), its fleet SIM_FLEET_ROUNDS, the
# FedBuffAvg and bank runs SIM_SHORT_ROUNDS (the banks' clocks are held to
# the first rounds of MIFA(array)'s under Impatient; their medians read
# rounds 10 on)
SIM_ROUNDS = SIM_FLEET_ROUNDS = 20
SIM_SHORT_ROUNDS = 15
# the host bank's timed cohort round: N clients of paper_mlp's d = 50,698
# f32 parameters, 2,027,920,000 B of rows in pinned memory
SIM_HOST_N, SIM_HOST_C = 10**4, 64


def sim_policies() -> dict:
    from repro_torch.sim import (BufferedKofN, Deadline, Impatient,
                                 WaitForAll, WaitForS)
    return {"wait_for_all": WaitForAll(), "wait_for_s": WaitForS(s=10),
            "deadline": Deadline(deadline_s=3.0), "impatient": Impatient(),
            "buffered": BufferedKofN(k=10)}


def sim_spec(policy, device="cuda"):
    from repro_torch.sim import SimConfig, SimSpec, tiered_shifted_exponential
    return SimSpec(policy, tiered_shifted_exponential(N_CLIENTS, seed=0,
                                                      device=device),
                   SimConfig(**SIM_CONFIG))


def sim_run(algo, policy, problem, params0, n_rounds, engine,
            device="cuda"):
    """One simulated run of the paper problem under cluster outages:
    engine "heap" (`FedSimEngine`) or "compiled" (`SimScanDriver`, chunks
    of SCAN_CHUNK, masks emitted). Returns (engine or driver, runner, host
    seconds between consecutive batch draws)."""
    from repro_torch.core import RoundRunner
    from repro_torch.optim import inv_t
    from repro_torch.sim import FedSimEngine, SimScanDriver
    model, batcher, _, _ = problem
    timed = TimedBatcher(batcher)
    r = RoundRunner(model=model, algo=algo, batcher=timed,
                    schedule=inv_t(1.0), weight_decay=1e-3,
                    params=clone_tree(params0, device),
                    scenario=scen_cluster(), device=device)
    sim = sim_spec(policy, device)
    if engine == "heap":
        drv = FedSimEngine(r, policy, r.scen_process.host_sampler(),
                           sim.latency, sim.config)
    else:
        drv = SimScanDriver(r, sim, scan_chunk=SCAN_CHUNK, emit_masks=True)
    drv.run(n_rounds)
    if device == "cuda":
        torch.cuda.synchronize()
    return drv, r, np.diff(timed.stamps)


def sim_equal(what, policy, heap, comp) -> str:
    """A compiled run against its heap run: close and open times, the
    counters, applied masks, τ bit-equal, the cohorts the policy's host
    draws; losses and params by `scan_equal`."""
    (eng, rh, _), (drv, rc, _) = heap, comp
    keys = ("t_open", "t_close", "n_dispatched", "n_applied", "n_late",
            "n_never")
    for a, b in zip(eng.round_log, drv.round_log):
        check(all(a[k] == b[k] for k in keys),
              f"sim {what}: round {a['round']} heap {a} compiled {b}")
    check(len(eng.round_log) == len(drv.round_log) == SIM_ROUNDS,
          f"sim {what}: {len(drv.round_log)} rounds")
    check(np.array_equal(np.stack(eng.applied_log),
                         np.stack(drv.applied_log)),
          f"sim {what}: applied masks differ")
    if not getattr(policy, "stateful", False):
        check(all(np.array_equal(c, policy.select(t, N_CLIENTS, None))
                  for t, c in enumerate(drv.cohort_log)),
              f"sim {what}: compiled cohorts differ from the host draws")
    check(rh.hist.sim_seconds == rc.hist.sim_seconds,
          f"sim {what}: close times differ")
    check(np.array_equal(rh.stats.tau, rc.stats.tau)
          and (rh.stats.tau_bar, rh.stats.tau_max, rh.stats.d_bar)
          == (rc.stats.tau_bar, rc.stats.tau_max, rc.stats.d_bar),
          f"sim {what}: tau statistics differ")
    return scan_equal(f"sim {what}", (rh.params, rh.hist),
                      (rc.params, rc.hist)).replace("the loop", "the heap")


def sim_host_round() -> str:
    """One cohort round of BankedMIFA(HostBank) at N = SIM_HOST_N clients
    of paper_mlp (`ProceduralBatcher`, SIM_HOST_C ids), timed after one
    warm-up round: rows in pinned memory, G_sum against the rows."""
    from repro_torch.bank import BankedMIFA, HostBank
    from repro_torch.core import RoundRunner
    from repro_torch.data import ProceduralBatcher
    from repro_torch.models import build_model
    from repro_torch.configs import get_config
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_leaves
    model = build_model(get_config("paper_mlp").replace(
        fl_clients=SIM_HOST_N))
    bank = HostBank(device="cuda")
    t0 = time.perf_counter()
    runner = RoundRunner(
        model=model, algo=BankedMIFA(bank), batcher=ProceduralBatcher(
            n_clients=SIM_HOST_N, dim=256, n_classes=10, batch_size=100,
            k_steps=5), schedule=inv_t(0.1), weight_decay=1e-3,
        params=model.init(0, device="cuda"), device="cuda")
    init_s = time.perf_counter() - t0
    state = runner.state["bank"]
    check(all(t.is_pinned() for t in tree_leaves(state)),
          "host bank: rows not in pinned memory")
    rng = np.random.default_rng(1)
    dts = []
    for t in range(2):
        ids = np.unique(rng.integers(0, SIM_HOST_N, 2 * SIM_HOST_C))[
            :SIM_HOST_C]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.step_cohort(t, ids)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    mem = bank.memory_bytes(state)
    rows_b = sum(t.numel() * 4 for t in tree_leaves(state["rows"]))
    check(mem["device"] == 0 and rows_b == SIM_HOST_N * sum(PATH_WIDTHS) * 4,
          f"host bank: memory_bytes {mem}")
    for g, r in zip(tree_leaves(state["g_sum"]), tree_leaves(state["rows"])):
        err = (g.double() - r.double().sum(0)).abs().max().item()
        check(err <= 1e-5 * max(r.double().abs().sum(0).max().item(), 1.0),
              f"host bank: G_sum off the sum of rows by {err:.3e}")
    return (f"sim host bank: BankedMIFA(HostBank) at N={SIM_HOST_N}, "
            f"{rows_b} B of rows in pinned memory (init {init_s:.2f} s), "
            f"one cohort round of C={SIM_HOST_C} {dts[1] * 1e3:.3f} ms "
            f"(host clock to a sync, after a warm-up round of "
            f"{dts[0] * 1e3:.3f} ms), memory_bytes {mem}")


def sim_phase(params0, problem, problem_cpu) -> tuple[dict, list]:
    """The simulator on the card (module docstring, step 13). Returns
    (launches of each kernel on the simulator's heap runs, report
    rows)."""
    from repro_torch.bank import (BankedMIFA, DenseBank, HostBank,
                                  PagedDeviceBank)
    from repro_torch.core import MIFA, FedBuffAvg, run_fl
    from repro_torch.fleet import SimTrial, run_sim_fleet
    from repro_torch.optim import inv_t
    from repro_torch.sim import SimConfig
    from repro_torch.tree import tree_leaves
    laps, mark = {}, [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        laps[what] = laps.get(what, 0.0) + now - mark[0]
        mark[0] = now

    rows, launches, seconds, ms, comp_runs = [], {}, {}, {}, {}
    sync_us, fills = [], {}
    for name, policy in sim_policies().items():
        runs, counts = {}, {}
        for engine in ("heap", "compiled"):
            reset_counts()
            runs[engine] = sim_run(MIFA(), policy, problem, params0,
                                   SIM_ROUNDS, engine)
            counts[engine] = read_counts()
            expect_launches(f"sim MIFA(array) {name} {engine}",
                            counts[engine], "mifa_aggregate",
                            SIM_ROUNDS + (engine == "compiled"))
        if name == "impatient":
            launches["mifa_aggregate"] = counts["heap"]["mifa_aggregate"]
        drv = runs["compiled"][0]
        ch = drv.chunks
        check(ch.replays == {"fill": ch.fills, "body": SIM_ROUNDS}
              and ch.syncs == SIM_ROUNDS,
              f"sim {name}: replays {ch.replays}, fills {ch.fills}, syncs "
              f"{ch.syncs}")
        fills[name] = ch.fills
        sync_us.append(ch.sync_s / ch.syncs * 1e6)
        verdict = sim_equal(f"MIFA(array) {name}", policy, runs["heap"],
                            runs["compiled"])
        hist = runs["heap"][1].hist
        seconds[name] = hist.sim_seconds[-1]
        ms[name] = (float(np.median(runs["heap"][2][10:])) * 1e3,
                    scan_ms(runs["compiled"][2], SIM_ROUNDS))
        comp_runs[name] = runs["compiled"][1]
        rows.append(
            f"sim MIFA(array) {name}: {SIM_ROUNDS} rounds, "
            f"{seconds[name]:.3f} simulated s, mean applied "
            f"{np.mean(hist.n_active):.2f}, heap {ms[name][0]:.3f} ms/round "
            f"(median, rounds 10-{SIM_ROUNDS - 2}), compiled "
            f"{ms[name][1]:.3f} ms/round (rounds {SCAN_CHUNK}-"
            f"{SIM_ROUNDS - SCAN_CHUNK - 1}), host clock; {ch.fills} epoch fills "
            f"(graph (a) replays), {ch.syncs} k0 reads, "
            f"{ch.sync_s / ch.syncs * 1e6:.1f} us each; compiled {verdict}; "
            f"mifa_aggregate heap {counts['heap']['mifa_aggregate']}, "
            f"compiled {counts['compiled']['mifa_aggregate']}")
    lap("policy runs")
    check(seconds["impatient"] < seconds["wait_for_all"],
          f"the paper's claim: Impatient took {seconds['impatient']} "
          f"simulated s, WaitForAll {seconds['wait_for_all']}")

    # FedBuffAvg under BufferedKofN through run_fl, both engines: the
    # staleness weights are the active mask (no kernel)
    model, batcher, _, _ = problem
    buf = {}
    for engine in ("loop", "scan_strict"):
        reset_counts()
        buf[engine] = run_fl(model=model, algo=FedBuffAvg(), batcher=batcher,
                             schedule=inv_t(1.0), n_rounds=SIM_SHORT_ROUNDS,
                             weight_decay=1e-3, scenario=scen_cluster(),
                             sim=sim_spec(sim_policies()["buffered"]),
                             params=clone_tree(params0, "cuda"),
                             engine=engine, scan_chunk=SCAN_CHUNK,
                             device="cuda")
        check(not any(read_counts().values()),
              f"sim FedBuffAvg {engine}: launches {nonzero(read_counts())}")
    check(buf["loop"][1].sim_seconds == buf["scan_strict"][1].sim_seconds
          and buf["loop"][1].n_active == buf["scan_strict"][1].n_active,
          "sim FedBuffAvg: close times or masks differ")
    rows.append(f"sim FedBuffAvg buffered K=10 via run_fl(sim=): "
                f"{buf['loop'][1].sim_seconds[-1]:.3f} simulated s, compiled "
                + scan_equal("sim FedBuffAvg", buf["loop"],
                             buf["scan_strict"]).replace("the loop",
                                                         "the heap"))
    lap("FedBuffAvg")

    # the cohort banks on the heap engine under Impatient
    banks = {}
    for name, make, kernel in (
            ("DenseBank", lambda: DenseBank(device="cuda"), "bank_scatter"),
            ("PagedDeviceBank", lambda: PagedDeviceBank(
                page_size=PAGE_SIZE, device="cuda"), "paged_bank_scatter"),
            ("HostBank", lambda: HostBank(device="cuda"), None)):
        reset_counts()
        algo = BankedMIFA(make())
        banks[name] = sim_run(algo, sim_policies()["impatient"], problem,
                              params0, SIM_SHORT_ROUNDS, "heap")
        counts = read_counts()
        if kernel is None:
            check(not any(counts.values()),
                  f"sim BankedMIFA(HostBank): launches {nonzero(counts)}")
            check(all(t.is_pinned() for t in tree_leaves(
                banks[name][1].state["bank"])),
                  "sim BankedMIFA(HostBank): rows not pinned")
        else:
            expect_launches(f"sim BankedMIFA({name})", counts, kernel,
                            SIM_SHORT_ROUNDS)
            launches[kernel] = counts[kernel]
        check(banks[name][1].hist.sim_seconds
              == comp_runs["impatient"].hist.sim_seconds[:SIM_SHORT_ROUNDS],
              f"sim BankedMIFA({name}): close times differ from MIFA(array)'s")
        rows.append(f"sim BankedMIFA({name}) impatient, heap: "
                    f"{SIM_SHORT_ROUNDS} "
                    f"rounds, {np.median(banks[name][2][10:]) * 1e3:.3f} "
                    f"ms/round (median, host clock); launches "
                    f"{nonzero(counts)}")
    dense = (banks["DenseBank"][1].params, banks["DenseBank"][1].hist)
    d_loss, d_param = run_gaps(dense, (banks["PagedDeviceBank"][1].params,
                                       banks["PagedDeviceBank"][1].hist))
    check(d_loss == 0 and d_param == 0,
          f"sim: the paged bank off the dense one by {d_loss:.3e}, "
          f"{d_param:.3e}")
    h_loss, h_param = run_gaps(dense, (banks["HostBank"][1].params,
                                       banks["HostBank"][1].hist))
    p_scale = max(p.abs().max().item() for p in tree_leaves(dense[0]))
    l_scale = float(np.max(np.abs(dense[1].train_loss)))
    check(h_loss <= 1e-5 * l_scale and h_param <= 1e-5 * p_scale,
          f"sim: the host bank off the dense one by {h_loss:.3e}, "
          f"{h_param:.3e}")
    rows.append(f"sim banks: PagedDeviceBank bit-equal to DenseBank; "
                f"HostBank |dloss| {h_loss:.3e}, |dparam| {h_param:.3e} "
                f"(bound 1e-5 of {l_scale:.3e}, {p_scale:.3e})")
    rows.append(sim_host_round())
    lap("banks")

    # a K=3 simulated fleet of mixed policies, every lane seed 0 from
    # params0 (model.init(0)), against the single compiled runs
    lanes = ("wait_for_all", "impatient", "buffered")
    reset_counts()
    t0 = time.perf_counter()
    fparams, fhist = run_sim_fleet(
        model=model, algo=MIFA(), batcher=batcher, schedule=inv_t(1.0),
        n_rounds=SIM_FLEET_ROUNDS, weight_decay=1e-3,
        trials=[SimTrial(seed=0, policy=sim_policies()[k],
                         scenario=scen_cluster(),
                         latency=sim_spec(None).latency) for k in lanes],
        config=SimConfig(**SIM_CONFIG), scan_chunk=SCAN_CHUNK,
        device="cuda")
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    counts = read_counts()
    expect_launches("sim fleet", counts, "mifa_aggregate",
                    len(lanes) * (SIM_FLEET_ROUNDS + 1))
    fch = fhist.sim
    check(fch.replays == {"fill": fch.fills, "body": SIM_FLEET_ROUNDS},
          f"sim fleet: replays {fch.replays}, fills {fch.fills}")
    gaps = []
    for k, name in enumerate(lanes):
        one, lane = comp_runs[name].hist, fhist.trial(k)
        check(lane.sim_seconds == one.sim_seconds[:SIM_FLEET_ROUNDS]
              and lane.n_active == one.n_active[:SIM_FLEET_ROUNDS],
              f"sim fleet lane {name}: clock or masks differ from the "
              f"single compiled run")
        gap = float(np.max(np.abs(np.subtract(
            lane.train_loss, one.train_loss[:SIM_FLEET_ROUNDS]))))
        check(gap <= SCAN_RTOL * float(np.max(np.abs(one.train_loss))),
              f"sim fleet lane {name}: losses off by {gap:.3e}")
        gaps.append(gap)
    rows.append(f"sim fleet K={len(lanes)} ({', '.join(lanes)}): "
                f"{SIM_FLEET_ROUNDS} rounds in {fleet_s:.2f} s "
                f"({fleet_s / SIM_FLEET_ROUNDS * 1e3:.3f} ms/round, host "
                f"clock, capture included), {fch.fills} fills, "
                f"{fch.sync_s / fch.syncs * 1e6:.1f} us a k0 read; every "
                f"lane's clock and masks bit-equal to its single compiled "
                f"run, |dloss| {['%.2e' % g for g in gaps]}; "
                f"mifa_aggregate {counts['mifa_aggregate']}")
    lap("fleet")

    # card against CPU: CPU_ROUNDS heap rounds under Impatient
    gpu = sim_run(MIFA(), sim_policies()["impatient"], problem, params0,
                  CPU_ROUNDS, "heap")
    cpu = sim_run(MIFA(), sim_policies()["impatient"], problem_cpu, params0,
                  CPU_ROUNDS, "heap", device="cpu")
    check(gpu[1].hist.n_active == cpu[1].hist.n_active
          and np.array_equal(np.stack(gpu[0].applied_log),
                             np.stack(cpu[0].applied_log)),
          "sim card vs CPU: masks differ")
    rel = float(np.max(np.abs(np.subtract(gpu[1].hist.sim_seconds,
                                          cpu[1].hist.sim_seconds))
                       / np.abs(cpu[1].hist.sim_seconds).clip(1e-30)))
    check(rel <= 1e-6, f"sim card vs CPU: close times off by rel {rel:.3e}")
    check(np.allclose(gpu[1].hist.train_loss, cpu[1].hist.train_loss,
                      rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
          "sim card vs CPU: losses differ")
    dloss = float(np.max(np.abs(np.subtract(gpu[1].hist.train_loss,
                                            cpu[1].hist.train_loss))))
    rows.append(f"sim card vs CPU, heap, impatient: {CPU_ROUNDS} rounds, the "
                f"same masks, close times max rel gap {rel:.2e} (bound "
                f"1e-6), |dloss| {dloss:.2e} (rtol {DEVICE_RTOL})")
    lap("card vs CPU")
    rows.append("sim simulated seconds to " + str(SIM_ROUNDS) + " rounds: "
                + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    rows.append("sim ms a simulated round (host clock), heap / compiled: "
                + ", ".join(f"{k} {a:.3f} / {b:.3f}"
                            for k, (a, b) in ms.items()))
    rows.append(f"sim sync a round (k0 read back before the fills): "
                f"{np.mean(sync_us):.1f} us mean over the five compiled "
                f"runs ({', '.join('%.1f' % u for u in sync_us)}); fills "
                f"{fills}")
    rows.append(f"sim phase: {sum(laps.values()):.1f} s ("
                + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items())
                + ")")
    return launches, rows


# --------------------------------------------------------------------------- #
# durability: trace replay, elastic fleets, kill and resume, snapshots
# --------------------------------------------------------------------------- #

# the recorded trace the phase replays: Gilbert–Elliott availability at rate
# 0.5 with off-bursts of 6 rounds and 10% of the devices departing for
# good, 64 rounds of N_CLIENTS devices, carried DUR_WINDOW rounds at a time
# (the trace runs re-point it once, at round 12; the kill/resume runs'
# chunks of DUR_KILL_CHUNK fit in it)
DUR_TRACE = {"n": N_CLIENTS, "horizon": 64, "seed": 7, "rate": 0.5,
             "burst": 6.0, "churn_frac": 0.1}
DUR_WINDOW = 12
# the trace and elastic-fleet runs take DUR_ROUNDS rounds on the scan in
# chunks of DUR_CHUNK (its timing reads the middle two of four chunks); the
# kill/resume runs DUR_KILL_ROUNDS in chunks of DUR_KILL_CHUNK; the
# million-client bank is snapshotted after DUR_MILLION_ROUNDS rounds (its
# pool of 2048 rows fills in 4, so pages spill). Cut from 20 rounds in
# chunks of 5 (window 16, departures at 16) and 6 million-client rounds,
# every check kept, to make room for the split federated rounds; the
# kill/resume runs cut from 30 rounds in chunks of 10 (snapshots every 10,
# killed after 21) to make room for the split fleets, every check kept
DUR_ROUNDS, DUR_CHUNK, DUR_KILL_ROUNDS, DUR_MILLION_ROUNDS = 16, 4, 15, 5
DUR_KILL_CHUNK = 5
# the elastic fleets over the trace: half the capacity at round 0, the rest
# arriving every 4 rounds, 10% departing at round 12 (|A| <= 55 <=
# FLEET_CAP)
DUR_ELASTIC = {"n_initial": 50, "arrive_every": 4, "depart_frac": 0.1,
               "depart_at": 12}
# kill and resume: snapshots every DUR_EVERY rounds, the killed run stops
# after DUR_KILL rounds and resumes from its round-10 snapshot to round
# DUR_KILL_ROUNDS. Round 0 of the trace is all-active, so a paged bank must
# hold every client then and never evicts under it; the paged run takes
# elastic availability over the trace instead (the rest of the capacity
# arriving every 3 rounds, 30% departing at round 10) through pages of one
# row: 67 slots hold the largest chunk's union (66 clients), 79 clients
# have come by the round-10 snapshot and 90 by round 15, so pages spill
# before it and after it
DUR_EVERY, DUR_KILL = 5, 11
KILL_ELASTIC = {"n_initial": 50, "arrive_every": 3, "depart_frac": 0.3,
                "depart_at": 10}
KILL_PAGE, KILL_SLOTS = 1, 67
DUR_DIR = ROOT / "build" / "durability"


class Stopwatch:
    """Wraps the named functions of a module while active and sums the
    host seconds of their calls, e.g. `checkpoint.run_state.save_run` as
    the scan engine calls it."""

    def __init__(self, module, *names):
        self.module, self.names = module, names
        self.seconds = {n: [] for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def timed(*a, _fn=fn, _n=n, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_n].append(time.perf_counter() - t0)
            setattr(self.module, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def trace_scen():
    from repro_torch.scenarios import Scenario, TraceReplay
    return Scenario(TraceReplay(str(DUR_DIR / "trace.npy"),
                                window=DUR_WINDOW), name="trace")


def elastic_scen(seed, **kw):
    from repro_torch.scenarios import make_scenario
    return make_scenario("elastic", n=N_CLIENTS, seed=seed,
                         inner="trace_replay",
                         inner_kwargs={"path": str(DUR_DIR / "trace.npy"),
                                       "window": DUR_WINDOW},
                         **(kw or DUR_ELASTIC))


def exact_same(what, run_a, run_b) -> None:
    """Two runs bit-equal: params, losses, masks, evals and τ."""
    d_loss, d_param = run_gaps(run_a, run_b)
    (_, ha), (_, hb) = run_a, run_b
    check(d_loss == 0 and d_param == 0 and ha.n_active == hb.n_active
          and ha.rounds == hb.rounds and ha.eval_loss == hb.eval_loss
          and (ha.tau_bar, ha.tau_max) == (hb.tau_bar, hb.tau_max),
          f"{what}: not bit-equal (|dloss| {d_loss:.3e}, |dparam| "
          f"{d_param:.3e}, rounds {len(ha.rounds)} vs {len(hb.rounds)})")


def trace_phase(params0, problem) -> tuple[dict, list]:
    """MIFA(array) under the trace on the loop and the scan (the window
    re-pointed in place between chunks), bit-equal, masks those of the CPU
    host surface, reads of the file never longer than the window; then
    BankedMIFA(PagedDeviceBank) under it on both engines."""
    from repro_torch.bank import BankedMIFA, PagedDeviceBank
    from repro_torch.core import MIFA
    from repro_torch.scenarios.trace_replay import TraceFile
    launches, rows, lengths = {}, [], []
    read_block = TraceFile.read_block

    def recording(self, t0, length):
        lengths.append(length)
        return read_block(self, t0, length)

    TraceFile.read_block = recording
    try:
        for name, make, kernel, cap in (
                ("MIFA(array)", MIFA, "mifa_aggregate", None),
                ("BankedMIFA(PagedDeviceBank)", lambda: BankedMIFA(
                    PagedDeviceBank(page_size=PAGE_SIZE, device="cuda")),
                 "paged_bank_scatter", SCAN_CAP)):
            runs, counts = {}, {}
            for engine in ("loop", "scan"):
                scen = trace_scen()
                reset_counts()
                runs[engine] = run_scen(make(), problem, params0, scen,
                                        DUR_ROUNDS, "cuda", engine, cap,
                                        DUR_CHUNK)
                counts[engine] = read_counts()
                expect_launches(f"durable trace {name} {engine}",
                                counts[engine], kernel,
                                DUR_ROUNDS + (engine == "scan"))
                scen_masks_match_host(f"durable trace {name} {engine}",
                                      runs[engine][1], scen, DUR_ROUNDS)
            launches[kernel] = counts["loop"][kernel]
            exact_same(f"durable trace {name} scan vs loop",
                       runs["loop"][:2], runs["scan"][:2])
            rows.append(scen_run_row(f"trace {name}", DUR_ROUNDS,
                                     runs["loop"][2], runs["loop"][1],
                                     counts["loop"], runs["scan"][2],
                                     DUR_CHUNK)
                        .replace("scenario ", "durable ", 1)
                        + f"; scan {nonzero(counts['scan'])}, bit-equal "
                          "to the loop, masks those of the CPU host surface")
    finally:
        TraceFile.read_block = read_block
    check(lengths and max(lengths) <= DUR_WINDOW,
          f"durable trace: a read of {max(lengths)} rounds, window "
          f"{DUR_WINDOW}")
    rows.append(f"durable trace: {len(lengths)} reads of the trace file, "
                f"longest {max(lengths)} rounds (window {DUR_WINDOW})")
    return launches, rows


def elastic_fleet_phase(problem) -> tuple[dict, list]:
    """Elastic availability over the trace as K=3 fleets of DUR_ROUNDS
    rounds, MIFA(array) and BankedMIFA(DenseBank), on both engines: scan
    against
    loop, each lane's masks those of its CPU host surface, each lane
    within DEVICE_ATOL of its sequential run."""
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import MIFA, run_fl
    from repro_torch.fleet import Trial, run_fleet
    from repro_torch.optim import inv_t
    model, batcher, _, _ = problem
    launches, rows = {}, []
    hosts = [elastic_scen(s).process.host_sampler().sample_block(
        0, DUR_ROUNDS) for s in FLEET_SEEDS]
    for name, make, kernel in (
            ("MIFA(array)", MIFA, "mifa_aggregate"),
            ("BankedMIFA(DenseBank)",
             lambda: BankedMIFA(DenseBank(device="cuda")),
             "bank_scatter_batched")):
        kw = dict(model=model, batcher=batcher, schedule=inv_t(1.0),
                  n_rounds=DUR_ROUNDS, weight_decay=1e-3,
                  cohort_capacity=FLEET_CAP, device="cuda")
        per = len(FLEET_SEEDS) if kernel == "mifa_aggregate" else 1
        runs, counts, dts = {}, {}, {}
        for engine in ("loop", "scan"):
            timed = TimedBatcher(batcher)
            reset_counts()
            runs[engine] = run_fleet(
                algo=make(), trials=[Trial(seed=s, scenario=elastic_scen(s))
                                     for s in FLEET_SEEDS],
                engine=engine, scan_chunk=DUR_CHUNK,
                **{**kw, "batcher": timed})
            torch.cuda.synchronize()
            counts[engine] = read_counts()
            dts[engine] = np.diff(timed.stamps)
            expect_launches(f"durable elastic fleet {name} {engine}",
                            counts[engine], kernel,
                            (DUR_ROUNDS + (engine == "scan")) * per)
        launches[kernel] = counts["loop"][kernel]
        verdict = scan_equal(f"durable elastic fleet {name}", runs["loop"],
                             runs["scan"])
        params, hist = runs["loop"]
        gaps = []
        for k, s in enumerate(FLEET_SEEDS):
            check(hist.trial(k).n_active
                  == hosts[k].sum(1).astype(float).tolist(),
                  f"durable elastic fleet {name} lane {k}: masks differ "
                  "from the CPU host surface's")
            seq = run_fl(algo=make(), scenario=elastic_scen(s), seed=s,
                         **kw)
            gaps.append(trial_gaps((params, hist), k, seq))
            check(max(gaps[-1]) <= DEVICE_ATOL,
                  f"durable elastic fleet {name} lane {k} vs its "
                  f"sequential run: |dloss|, |dparam| {gaps[-1]}")
        rows.append(
            f"durable elastic fleet {name}: K={len(FLEET_SEEDS)} x "
            f"{DUR_ROUNDS} rounds, loop "
            f"{np.median(dts['loop'][10:]) * 1e3:.3f} ms/round, scan "
            f"{scan_ms(dts['scan'], DUR_ROUNDS, DUR_CHUNK):.3f} ms/round; "
            f"scan {verdict}; "
            f"lanes' masks those of the CPU host surfaces (mean |A(t)| "
            f"{np.mean(hist.stacked()['n_active']):.2f}); lanes vs "
            f"sequential runs max |dloss| {max(g[0] for g in gaps):.3e}, "
            f"max |dparam| {max(g[1] for g in gaps):.3e} (atol "
            f"{DEVICE_ATOL}); launches loop {nonzero(counts['loop'])}, scan "
            f"{nonzero(counts['scan'])}")
    return launches, rows


def restored_bank(make_bank, problem, params0, cap, d):
    """A fresh runner restored from the newest snapshot in `d`; returns
    (its bank, its bank state)."""
    from repro_torch.bank import BankedMIFA
    from repro_torch.checkpoint import CheckpointSpec, restore_run
    from repro_torch.core import RoundRunner
    from repro_torch.optim import inv_t
    model, batcher, _, _ = problem
    bank = make_bank()
    runner = RoundRunner(model=model, algo=BankedMIFA(bank), batcher=batcher,
                         schedule=inv_t(1.0), weight_decay=1e-3,
                         params=clone_tree(params0, "cuda"),
                         cohort_capacity=cap, device="cuda")
    restore_run(runner, CheckpointSpec(every=DUR_EVERY, dir=str(d)))
    return bank, runner.state["bank"]


def gsum_gap(state, rows) -> float:
    """G_sum against the sum of the bank's rows, within TOL (f32)."""
    from repro_torch.tree import tree_leaves
    rtol, atol = TOL[torch.float32]
    gap = 0.0
    for g, r in zip(tree_leaves(state["g_sum"]), tree_leaves(rows)):
        err = (g.double() - r.double().sum(0)).abs()
        check(bool((err <= atol + rtol * r.double().abs().sum(0)).all()),
              f"G_sum off the sum of the rows by {err.max().item():.3e}")
        gap = max(gap, err.max().item())
    return gap


def kill_resume_phase(params0, problem) -> tuple[dict, list]:
    """Each algorithm for DUR_KILL_ROUNDS rounds on the scan (chunks of
    DUR_KILL_CHUNK, a snapshot every DUR_EVERY rounds, evals every
    DUR_EVERY), once uninterrupted, once killed after DUR_KILL rounds and
    resumed from its second snapshot: params, history and τ bit-equal. The
    paged bank's final snapshots of both runs are restored into fresh
    banks and every row read back through the gather kernel."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.checkpoint import CheckpointSpec, run_state
    from repro_torch.core import MIFA, run_fl
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_leaves
    model, batcher, _, eval_fn = problem

    def paged_bank():
        return PagedDeviceBank(page_size=KILL_PAGE, n_slots=KILL_SLOTS,
                               device="cuda")

    cases = (
        ("MIFA(array)", MIFA, trace_scen, None, "mifa_aggregate"),
        ("MIFA(int8)", lambda: MIFA(memory="int8"), trace_scen, None, None),
        ("BankedMIFA(DenseBank)",
         lambda: BankedMIFA(DenseBank(device="cuda")), trace_scen, SCAN_CAP,
         "bank_scatter"),
        (f"BankedMIFA(PagedDeviceBank(page_size={KILL_PAGE}, "
         f"n_slots={KILL_SLOTS})) under elastic trace replay",
         lambda: BankedMIFA(paged_bank()),
         lambda: elastic_scen(0, **KILL_ELASTIC), SCAN_CAP,
         "paged_bank_scatter"))
    launches, rows = {}, []
    for i, (name, make, scen, cap, kernel) in enumerate(cases):
        def run(d, n_rounds=DUR_KILL_ROUNDS, resume=False):
            reset_counts()
            out = run_fl(model=model, algo=make(), batcher=batcher,
                         scenario=scen(), schedule=inv_t(1.0),
                         n_rounds=n_rounds, weight_decay=1e-3,
                         params=clone_tree(params0, "cuda"),
                         eval_fn=eval_fn, eval_every=DUR_EVERY,
                         engine="scan_strict", scan_chunk=DUR_KILL_CHUNK,
                         cohort_capacity=cap, device="cuda",
                         checkpoint=CheckpointSpec(every=DUR_EVERY,
                                                   dir=str(d),
                                                   resume=resume))
            torch.cuda.synchronize()
            return out, read_counts()

        full_dir, killed = DUR_DIR / f"run{i}_full", DUR_DIR / f"run{i}_kill"
        full, _ = run(full_dir)
        run(killed, n_rounds=DUR_KILL)
        found = [r for r, _ in run_state.list_checkpoints(str(killed))]
        check(found == [DUR_EVERY, 2 * DUR_EVERY],
              f"durable {name}: snapshots {found} after the kill")
        snap = run_state.checkpoint_path(str(killed), 2 * DUR_EVERY)
        nbytes = os.path.getsize(snap)
        with Stopwatch(run_state, "save_run", "restore_run") as sw:
            resumed, counts = run(killed, resume=True)
        exact_same(f"durable kill/resume {name}", full, resumed)
        want = {k: 0 for k in counts}
        if kernel is not None:
            want[kernel] = DUR_KILL_ROUNDS - 2 * DUR_EVERY + 1
            launches[kernel] = counts[kernel]
        check(counts == want, f"durable resumed {name}: launches {counts}, "
                              f"expected {want}")
        extra = ""
        if kernel == "paged_bank_scatter":
            spilled = len(run_state.load_pytree(
                snap, as_torch=False)["bank"]["spill_lp"])
            check(spilled > 0, f"durable {name}: no page spilled at the "
                               "snapshot")
            ref_bank, ref_state = restored_bank(paged_bank, problem,
                                                params0, cap, full_dir)
            bank, state = restored_bank(paged_bank, problem, params0, cap,
                                        killed)
            reset_counts()
            got = bank.gather(state, np.arange(N_CLIENTS))
            launches["paged_bank_gather"] = read_counts()[
                "paged_bank_gather"]
            want_rows = ref_bank.gather(ref_state, np.arange(N_CLIENTS))
            check(all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(want_rows))),
                  f"durable {name}: restored rows differ from the "
                  "uninterrupted run's")
            extra = (f"; {spilled} pages spilled at the round-"
                     f"{2 * DUR_EVERY} snapshot and {len(bank._spill)} at "
                     f"the end (faults {bank.faults}, evictions "
                     f"{bank.evictions}); the final snapshots restored into "
                     f"fresh banks: all {N_CLIENTS} rows read through the "
                     f"gather kernel ({launches['paged_bank_gather']} "
                     f"launch) bit-equal, G_sum vs the sum of the rows "
                     f"max |err| {gsum_gap(state, got):.3e}")
        rows.append(
            f"durable kill/resume {name}: {DUR_KILL_ROUNDS} rounds on the "
            f"scan (chunks of {DUR_KILL_CHUNK}, snapshots and evals every "
            f"{DUR_EVERY}), killed after {DUR_KILL}, resumed from round "
            f"{2 * DUR_EVERY}: params, history, evals and tau bit-equal to "
            f"the uninterrupted run; snapshot {nbytes} B, save_run "
            f"{np.median(sw.seconds['save_run']) * 1e3:.3f} ms (median of "
            f"{len(sw.seconds['save_run'])}), restore_run "
            f"{sw.seconds['restore_run'][0] * 1e3:.3f} ms; resumed run "
            f"launches {nonzero(counts)}{extra}")
    return launches, rows


def million_snapshot_phase(params0, model) -> list:
    """The million-client paged bank (step 7's run, cut to
    DUR_MILLION_ROUNDS rounds) snapshotted once and restored into a fresh
    runner: the next 2 rounds bit-equal to the unrestored runner's."""
    from repro_torch.checkpoint import CheckpointSpec, restore_run, save_run
    from repro_torch.tree import tree_leaves
    runner, bank, draw = million_runner(model, params0)
    for t in range(DUR_MILLION_ROUNDS):
        runner.step_cohort(t, draw())
    torch.cuda.synchronize()
    spec = CheckpointSpec(every=1, dir=str(DUR_DIR / "million"))
    mem = bank.memory_bytes(runner.state["bank"])
    t0 = time.perf_counter()
    path = save_run(runner, spec, DUR_MILLION_ROUNDS)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    fresh, fbank, _ = million_runner(model, params0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = restore_run(fresh, spec)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(start == DUR_MILLION_ROUNDS, f"million restore at round {start}")
    check(sorted(fbank._spill) == sorted(bank._spill)
          and spill_pinned(fbank), "million restore: spill store differs "
                                   "or is not pinned")
    for t in range(DUR_MILLION_ROUNDS, DUR_MILLION_ROUNDS + 2):
        ids = draw()
        runner.step_cohort(t, ids)
        fresh.step_cohort(t, ids)
    torch.cuda.synchronize()
    check(runner.hist.train_loss == fresh.hist.train_loss
          and all(torch.equal(a, b) for a, b in zip(
              tree_leaves([runner.params, runner.state]),
              tree_leaves([fresh.params, fresh.state]))),
          "million restore: the next 2 rounds differ from the unrestored "
          "runner's")
    fbank.check_invariants(fresh.state["bank"])
    os.unlink(path)
    return [f"durable million clients: N={MILLION_N} paged bank after "
            f"{DUR_MILLION_ROUNDS} rounds (pool {mem['device_pages']} B on "
            f"the "
            f"card, spill {mem['host']} B pinned): snapshot {nbytes} B, "
            f"save_run {save_s:.3f} s ({nbytes / save_s / 1e9:.2f} GB/s), "
            f"restore_run into a fresh runner {load_s:.3f} s "
            f"({nbytes / load_s / 1e9:.2f} GB/s); the next 2 rounds "
            f"bit-equal to the unrestored runner's (params, bank pages, "
            f"page table, G_sum, losses); snapshot deleted"]


def serve_snapshot_phase() -> tuple[dict, list]:
    """granite-3-8b cut to GRANITE_LAYERS layers: its params saved with
    `save_pytree` and served through the path `--params` takes
    (`load_pytree` onto the card): the greedy tokens of the in-memory
    params, `flash_attention` launched as in the serve phase."""
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    cfg = get_config("granite_3_8b").replace(n_layers=GRANITE_LAYERS)
    kw = dict(cfg=cfg, batch=SERVE_B, prompt_len=SERVE_PROMPT,
              new_tokens=SERVE_NEW, seed=0, device="cuda")
    want = serve(**kw)["tokens"]
    params = build_model(cfg).init(0, device="cuda")
    t0 = time.perf_counter()
    path = save_pytree(str(DUR_DIR / "granite"), params)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    del params
    t0 = time.perf_counter()
    loaded = load_pytree(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reset_counts()
    out = serve(params=loaded, **kw)
    counts = read_counts()
    expect = {"flash_attention": GRANITE_LAYERS, "ssd_scan": 0}
    check(out["launches"]["prefill"] == expect
          and {k: counts[k] for k in expect} == expect,
          f"durable serve: prefill launches {out['launches']['prefill']}, "
          f"counts {counts}, expected {expect}")
    check(torch.equal(out["tokens"], want),
          "durable serve: tokens from the snapshot differ from the "
          "in-memory params'")
    os.unlink(path)
    del loaded, out
    torch.cuda.empty_cache()
    return ({"flash_attention": counts["flash_attention"]},
            [f"durable serve granite-3-8b ({GRANITE_LAYERS} layers, bf16): "
             f"save_pytree {nbytes} B in {save_s:.3f} s, load_pytree onto "
             f"the card {load_s:.3f} s; served {SERVE_B} x {SERVE_PROMPT} "
             f"prompt tokens + {SERVE_NEW} greedy tokens from the snapshot, "
             f"tokens equal to the in-memory params'; flash_attention "
             f"launches {counts['flash_attention']}"])


def durability_phase(params0, problem, problem_cpu) -> tuple[dict, list]:
    """Step 14 on the card at paper_mlp's full width: trace replay on the
    loop and the scan, elastic fleets, kill and resume of four algorithms,
    the million-client bank's snapshot and a model served from a snapshot.
    Returns (launches of each kernel on its durability run, report
    rows)."""
    from repro_torch.scenarios import synthesize_trace
    del problem_cpu
    t_start = time.perf_counter()
    shutil.rmtree(DUR_DIR, ignore_errors=True)
    synthesize_trace(str(DUR_DIR / "trace"), **DUR_TRACE)
    laps, t0 = {}, time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t0
        laps[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    launches, rows = trace_phase(params0, problem)
    lap("trace")
    more_launches, more = elastic_fleet_phase(problem)
    launches["bank_scatter_batched"] = more_launches["bank_scatter_batched"]
    rows += more
    lap("elastic")
    kill_launches, more = kill_resume_phase(params0, problem)
    launches.update({k: v for k, v in kill_launches.items()
                     if k not in launches})
    rows += more
    lap("kill/resume")
    rows += million_snapshot_phase(params0, problem[0])
    lap("million")
    serve_launches, more = serve_snapshot_phase()
    launches.update(serve_launches)
    rows += more
    lap("serve")
    shutil.rmtree(DUR_DIR, ignore_errors=True)
    missing = [k for k in DUR_FROM if not launches.get(k)]
    check(not missing, f"durability path: {missing} never launched")
    rows.append(f"durable phase: {time.perf_counter() - t_start:.1f} s ("
                + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items())
                + ")")
    return launches, rows


# which durability run each kernel's count comes from (each counted from 0
# just before it)
DUR_FROM = {
    "mifa_aggregate": f"durable MIFA(array) under trace replay, "
                      f"{DUR_ROUNDS} rounds (loop; scan: {DUR_ROUNDS + 1})",
    "bank_scatter": f"durable BankedMIFA(DenseBank) resumed on the scan "
                    f"from round {2 * DUR_EVERY} to {DUR_KILL_ROUNDS}",
    "paged_bank_scatter": f"durable BankedMIFA(PagedDeviceBank) under trace "
                          f"replay, {DUR_ROUNDS} rounds (loop; scan: "
                          f"{DUR_ROUNDS + 1})",
    "paged_bank_gather": "durable: every row of a PagedDeviceBank restored "
                         "from the resumed run's final snapshot",
    "bank_scatter_batched": f"durable elastic fleet BankedMIFA(DenseBank), "
                            f"K=3, {DUR_ROUNDS} rounds (loop; scan: "
                            f"{DUR_ROUNDS + 1})",
    "flash_attention": f"durable granite-3-8b ({GRANITE_LAYERS} layers) "
                       "served from a snapshot, prefill"}


# --------------------------------------------------------------------------- #
# the model zoo: flash_attention and ssd_scan, served models
# --------------------------------------------------------------------------- #

def attn_inputs(gen, b, s, h, kv, hd, dtype, t=None, dv=None):
    """q (b,s,h,hd), k (b,t,kv,hd), v (b,t,kv,dv): t defaults to s, dv to
    hd."""
    t = s if t is None else t
    shapes = [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, dv or hd)]
    return [torch.randn(shp, generator=gen, device="cuda").to(dtype)
            for shp in shapes]


def ssd_inputs(gen, b, s, h, p, n, dtype, large_da=False):
    """As the tests draw them: x normal, dA = -softplus(normal), B and C
    normal times 0.5; x, B, C in `dtype`, dA f32. `large_da`: dA = A·dt
    with zamba2's largest |A| (112) and dt uniform in [0.001, 0.1], its
    dt range, so |cum| reaches the hundreds within a 64-row chunk."""
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    if large_da:
        dA = -112.0 * (0.001 + 0.099 * torch.rand(
            (b, s, h), generator=gen, device="cuda"))
    else:
        dA = -torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=gen, device="cuda"))
    B, C = (0.5 * torch.randn((b, s, n), generator=gen, device="cuda")
            for _ in range(2))
    return x, dA, B.to(dtype), C.to(dtype)


def check_flash(gen) -> tuple[float, list]:
    """flash_attention against its plain version: the served models'
    shapes (zamba2-7b: H=KV=32, hd=112; granite-3-8b: GQA g=4, hd=128;
    gemma3-4b: GQA g=2, hd=256, global and window 1024; olmoe-1b-7b and
    moonshot-v1-16b-a3b: H=KV=16, hd=128; deepseek-v2-lite-16b's MLA:
    H=KV=16, hd=192, v's head dim 128), ragged S, non-causal S != T,
    small heads, windows that are not a multiple of the 64-key tile (100)
    and below one tile (17), f32 and bf16; no output may be NaN. A shape
    of six numbers gives v's head dim last."""
    bf, f32 = torch.bfloat16, torch.float32
    gemma = (SERVE_B, SERVE_PROMPT, 8, 4, 256)
    cases = [((SERVE_B, SERVE_PROMPT, 32, 32, 112), bf, True, 0,
              "zamba2 path"),
             ((SERVE_B, SERVE_PROMPT, 32, 8, 128), bf, True, 0,
              "granite path, GQA g=4"),
             ((1, 512, 32, 32, 112), f32, True, 0, "zamba2 heads f32"),
             ((1, 512, 32, 8, 128), f32, True, 0, "GQA g=4 f32"),
             ((2, 1000, 8, 2, 112), bf, True, 0, "ragged S"),
             ((2, 1000, 8, 2, 112), f32, True, 0, "ragged S f32"),
             ((2, 300, 4, 4, 64), bf, False, 0, "non-causal, T=200"),
             ((2, 96, 4, 4, 32), f32, False, 0, "smoke heads f32"),
             (gemma, bf, True, 0, "gemma3 global, hd 256"),
             (gemma, bf, True, GEMMA_WINDOW, "gemma3 local, hd 256"),
             ((1, 1500, 8, 4, 256), f32, True, 0, "hd 256 f32"),
             ((1, 1500, 8, 4, 256), f32, True, GEMMA_WINDOW,
              "gemma3 local f32"),
             ((2, 700, 8, 4, 256), bf, True, 100, "window 100"),
             ((2, 700, 8, 4, 256), f32, True, 100, "window 100 f32"),
             ((2, 333, 4, 2, 256), bf, True, 17, "window 17 < a tile"),
             ((2, 333, 4, 2, 256), f32, True, 17, "window 17 f32"),
             ((SERVE_B, SERVE_PROMPT, 16, 16, 128), bf, True, 0,
              "olmoe path"),
             ((1, 512, 16, 16, 128), f32, True, 0, "olmoe heads f32"),
             (MLA_SHAPE, bf, True, 0, "MLA path, dv 128"),
             ((1, 512, 16, 16, 192, 128), f32, True, 0, "MLA heads f32"),
             ((2, 1000, 4, 4, 192, 128), bf, True, 0, "MLA ragged S"),
             ((2, 1000, 4, 4, 192, 128), f32, True, 0, "MLA ragged S f32"),
             ((2, 300, 4, 4, 192, 128), bf, False, 0, "non-causal, dv 128"),
             ((2, 300, 4, 4, 192, 128), f32, False, 0,
              "non-causal, dv 128 f32")]
    return check_flash_cases(gen, cases)


def check_flash_cases(gen, cases) -> tuple[float, list]:
    """flash_attention against its plain version on each case of
    ((B, S, H, KV, hd[, dv]), dtype, causal, window, label): output dtype,
    shape, no NaN, |err| within ATTN_TOL; a label starting "non-causal"
    takes T=200 keys. Returns the largest |err| and a row a case."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    max_err, rows = 0.0, []
    for (b, s, h, kv, hd, *dv), dt, causal, window, label in cases:
        dv = dv[0] if dv else hd
        t = 200 if label.startswith("non-causal") else s
        q, k, v = attn_inputs(gen, b, s, h, kv, hd, dt, t, dv)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out.dtype == dt and out.shape == ref.shape,
              f"flash_attention output {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()),
              f"flash_attention: a non-finite output ({label})")
        atol, rtol = ATTN_TOL[dt]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        check(bool((diff <= atol + rtol * ref.float().abs()).all()),
              f"flash_attention off by {err:.3e} ({label})")
        max_err = max(max_err, err)
        rows.append(f"flash_attention {label:<22} B={b} S={s} T={t} H={h} "
                    f"KV={kv} hd={hd} dv={dv} {str(dt)[6:]} causal={causal} "
                    f"window={window}: max |err| {err:.3e} (atol {atol}, "
                    f"rtol {rtol})")
    return max_err, rows


def check_ssd(gen) -> tuple[float, list]:
    """ssd_scan against its plain version: the served models' shapes
    (zamba2-7b: h=112, p=64, n=64; mamba2-1.3b: h=64, n=128; Q=256), f32,
    a chunk that is not a power of two, the smoke heads, an odd prompt
    (S=129: the model's chunk falls to 1) and dA as large as zamba2's
    A = -112 makes it."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    bf, f32 = torch.bfloat16, torch.float32
    cases = [((SERVE_B, SERVE_PROMPT, 112, 64, 64), 256, bf, "zamba2 path"),
             ((SERVE_B, SERVE_PROMPT, 64, 64, 128), 256, bf, "mamba2 path"),
             ((1, 512, 112, 64, 64), 256, f32, "zamba2 heads f32"),
             ((1, 512, 64, 64, 128), 256, f32, "mamba2 heads f32"),
             ((2, 192, 4, 64, 64), 96, f32, "chunk 96"),
             ((2, 96, 8, 32, 16), 32, bf, "smoke heads"),
             ((2, 129, 8, 64, 64), 1, bf, "odd S, Q=1"),
             ((2, 129, 8, 64, 64), 1, f32, "odd S, Q=1 f32"),
             ((2, 512, 16, 64, 64), 64, bf, "large |dA|"),
             ((2, 512, 16, 64, 64), 64, f32, "large |dA| f32")]
    max_err, rows = 0.0, []
    for (b, s, h, p, n), q, dt, label in cases:
        x, dA, B, C = ssd_inputs(gen, b, s, h, p, n, dt,
                                 large_da=label.startswith("large"))
        y_ref, h_ref = ssd_scan_ref(x, dA, B, C, chunk=q)
        y_mag, h_mag = ssd_scan_ref(x.float().abs(), dA, B.float().abs(),
                                    C.float().abs(), chunk=q)
        y, hf = ssd_scan(x, dA, B, C, chunk=q)
        torch.cuda.synchronize()
        errs, rels = [], []
        for got, ref, mag, rtol in ((y, y_ref, y_mag, SSD_RTOL[dt]),
                                    (hf, h_ref, h_mag,
                                     SSD_RTOL[torch.float32])):
            err = (got.float() - ref.float()).abs()
            rel = (err / mag).max().item()
            check(bool((err <= 1e-6 + rtol * mag).all()),
                  f"ssd_scan off by {err.max().item():.3e}, {rel:.3e} of "
                  f"the summed magnitudes ({label})")
            errs.append(err.max().item())
            rels.append(rel)
        max_err = max(max_err, *errs)
        rows.append(f"ssd_scan {label:<17} b={b} S={s} h={h} p={p} n={n} "
                    f"Q={q} {str(dt)[6:]}: max |err| y {errs[0]:.3e} "
                    f"({rels[0]:.2e} of |terms|), h_final {errs[1]:.3e} "
                    f"({rels[1]:.2e}) (rtol {SSD_RTOL[dt]})")
    return max_err, rows


def flash_work(b, s, h, kv, hd, itemsize, window=0, dv=None
               ) -> tuple[int, int]:
    """Bytes (q, k at hd and v at dv read once, out at dv written once;
    dv defaults to hd) and the flops a causal call needs: Q·Kᵀ and P·V,
    2·(hd + dv) a pair, over the S(S+1)/2 pairs on or below the diagonal,
    or with a window over the sum of min(s + 1, window) pairs."""
    dv = dv or hd
    nbytes = (b * s * h * (hd + dv) + b * s * kv * (hd + dv)) * itemsize
    pairs = (s * (s + 1) // 2 if not window
             else sum(min(i + 1, window) for i in range(s)))
    return nbytes, 2 * b * h * (hd + dv) * pairs


def ssd_work(b, s, h, p, n, q, itemsize) -> tuple[int, int]:
    """Bytes (x, B, C, dA read once; y, h_final written once) and the
    flops the scan needs: C·Bᵀ once per (batch row, chunk) on the lower
    triangle; per head its masked product with x, C·hᵀ and the state
    update."""
    nc, tri = s // q, q * (q + 1) // 2
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * itemsize \
        + b * s * h * 4 + b * h * p * n * 4
    ops = b * nc * (tri * n * 2 + h * (tri * p * 2 + 4 * q * p * n))
    return nbytes, ops


def time_calls(fns: dict, sets) -> dict:
    """Device ms per call of each fn in `fns` (name -> f(*args)), cycled
    over the input `sets`, from a CUDA graph replayed between events."""
    return {name: time_round_ms([lambda a=a, f=f: f(*a) for a in sets])
            / len(sets) for name, f in fns.items()}


def sdpa_backend(*args, **kw) -> str:
    """The backend PyTorch's dispatcher picks for
    scaled_dot_product_attention(*args, **kw) (its `_fused_sdp_choice`),
    or why it could not be read."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(*args, **kw)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not read ({type(e).__name__})"


def time_flash(gen, b, s, h, kv, hd, window=0, dv=None) -> dict:
    """flash_attention at a served shape (bf16, causal, `window` > 0 for a
    sliding window, v's head dim `dv`, default hd): kernel, plain version
    and one scaled_dot_product_attention call on the same values in its
    (B,H,S,hd) layout, prepared beforehand: is_causal with GQA in place,
    or, with a window, the boolean mask of the window and k, v repeated to
    H heads. `library_backend` names the backend the library call
    dispatched to."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, ops = flash_work(b, s, h, kv, hd, 2, window, dv)
    sets = [attn_inputs(gen, b, s, h, kv, hd, torch.bfloat16, dv=dv)
            for _ in range(n_copies(nbytes))]
    t = time_calls({"ms": lambda *a: flash_attention(*a, causal=True,
                                                     window=window),
                    "plain_ms": lambda *a: flash_attention_ref(
                        *a, causal=True, window=window)}, sets)
    if window:
        mask = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
        mask = mask.triu(1 - window)
        lib_sets = [[x.transpose(1, 2).contiguous() if i == 0 else
                     x.repeat_interleave(h // kv, dim=2).transpose(1, 2)
                     .contiguous() for i, x in enumerate(st)]
                    for st in sets]
        lib_kw = {"attn_mask": mask}
    else:
        lib_sets = [[x.transpose(1, 2).contiguous() for x in st]
                    for st in sets]
        lib_kw = {"is_causal": True, "enable_gqa": kv != h}
    t["library_ms"] = time_calls({"lib": lambda *a: sdpa(*a, **lib_kw)},
                                 lib_sets)["lib"]
    t["library_backend"] = sdpa_backend(*lib_sets[0], **lib_kw)
    t["bound_ms"], t["bound_by"] = bound(nbytes, ops, BF16_OPS_PER_S)
    t.update(bytes=nbytes, ops=ops)
    return t


def time_ssd(gen, b, s, h, p, n, q) -> dict:
    """ssd_scan at a served shape (bf16): kernel and plain version. No
    single PyTorch call computes the chunked scan, so no library time. The
    bf16 kernel runs its products on the tensor cores, so the bound takes
    the flops at the bf16 rate."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    nbytes, ops = ssd_work(b, s, h, p, n, q, 2)
    sets = [ssd_inputs(gen, b, s, h, p, n, torch.bfloat16)
            for _ in range(n_copies(nbytes))]
    t = time_calls({"ms": lambda *a: ssd_scan(*a, chunk=q),
                    "plain_ms": lambda *a: ssd_scan_ref(*a, chunk=q)}, sets)
    t["library_ms"] = None
    t["bound_ms"], t["bound_by"] = bound(nbytes, ops, BF16_OPS_PER_S)
    t.update(bytes=nbytes, ops=ops)
    return t


def serve_phase(label, cfg, expect, prompt: int = SERVE_PROMPT,
                new: int = SERVE_NEW) -> tuple[dict, list]:
    """`launch.serve.serve` at SERVE_B prompts of `prompt` tokens (after
    the patches of a vision_text model) and `new` greedy tokens, every
    count set to 0 just before and read just after: prefill launches
    exactly `expect`, decode none, no other kernel runs; logits finite.
    tok/s counts text tokens, as `serve.report` does."""
    from repro_torch.launch.serve import report, serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve(cfg=cfg, batch=SERVE_B, prompt_len=prompt, new_tokens=new,
                seed=0, device="cuda")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    zero = {k: 0 for k in expect}
    check(out["launches"]["prefill"] == expect,
          f"{label} prefill launches {out['launches']['prefill']}, "
          f"expected {expect}")
    check(out["launches"]["decode"] == zero,
          f"{label} decode launched {out['launches']['decode']}")
    others = {k: v for k, v in counts.items() if k not in expect}
    check({k: counts[k] for k in expect} == expect
          and not any(others.values()), f"{label}: kernel counts {counts}")
    logits = out["logits"]
    check(tuple(logits.shape) == (SERVE_B, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"{label}: prefill logits {tuple(logits.shape)} not finite")
    check(tuple(out["tokens"].shape) == (SERVE_B, new),
          f"{label}: generated {tuple(out['tokens'].shape)}")
    rows = [f"serve {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{out['n_params']} params, {cfg.param_dtype}"]
    rows += report(out)
    rows.append(f"  prefill {out['prefill_s'] * 1e3:.3f} ms, "
                f"{SERVE_B * prompt / out['prefill_s']:.1f} tok/s; "
                f"decode {out['decode_s'] / new * 1e3:.3f} ms/token "
                f"step ({SERVE_B} sequences), "
                f"{SERVE_B * new / out['decode_s']:.1f} tok/s; peak "
                f"device allocation {peak} B")
    return counts, rows


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def zoo_f32_config(n_layers: int, arch: str = "zamba2_7b"):
    """A zoo config at full width in f32 with its depth cut to n_layers."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(
        n_layers=n_layers, param_dtype="float32", compute_dtype="float32")


class RoutingLog:
    """While active, records every call of `models.moe.route` (as
    `moe_apply` makes it): per call the expert ids (T,k), the routing
    table (E,C), whose slots below T hold the kept assignments, the gap
    between each token's k-th and (k+1)-th router probability (T,), and
    the call's whole `Routing`, left on their device."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.calls = moe, moe.route, []

        def recording(probs, top_k, capacity_factor):
            r = self.route(probs, top_k, capacity_factor)
            self.calls.append((r.expert_ids, r.table, r.top[:, top_k - 1]
                               - r.top[:, -1], r))
            return r
        moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def routing_flips(what: str, pairs) -> list:
    """Compare expert choices row by row. `pairs`: (label, ids, ids_ref,
    gap_ref) with rows aligned; a row flips where its sets of experts
    differ. A flip is allowed only at a near-tie of the reference side
    (gap below MOE_TIE_GAP); any other fails. Returns the allowed flips as
    (index of the pair, row, gap)."""
    flips = []
    for i, (label, ids, ids_ref, gap_ref) in enumerate(pairs):
        a = ids.cpu().sort(-1).values
        b = ids_ref.cpu().sort(-1).values
        for row in (a != b).any(-1).nonzero().flatten().tolist():
            gap = gap_ref[row].item()
            check(gap < MOE_TIE_GAP,
                  f"{what}: routing flip at {label} row {row}, "
                  f"{a[row].tolist()} against {b[row].tolist()}, not at a "
                  f"near-tie (gap {gap:.3e} >= {MOE_TIE_GAP})")
            flips.append((i, row, gap))
    return flips


def model_runs(cfg, s: int, seed: int) -> dict:
    """`cfg` at B=1: a prefill of s tokens (after the patches of a
    vision_text config) and two decode steps, on the card (kernels) and on
    the CPU (plain versions) from the card's params copied across. Returns
    {device: (logits of the prefill and each step, the cache, seconds, the
    MoE routing calls)}."""
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    model = build_model(cfg)
    p_gpu = model.init(seed, device="cuda")
    full, base = prompt_batch(cfg, 1, s + 2,
                              torch.Generator().manual_seed(seed), "cpu")
    toks, patches, off = full["tokens"], full.get("patches"), base - s - 2
    out = {}
    for dev in ("cuda", "cpu"):
        params = p_gpu if dev == "cuda" else tree_map(lambda t: t.cpu(),
                                                      p_gpu)
        cache = model.init_cache(1, off + s + 2, device=dev)
        t = toks.to(dev)
        batch = {"tokens": t[:, :s]}
        if patches is not None:
            batch["patches"] = patches.to(dev)
        t0 = time.perf_counter()
        with RoutingLog() as log:
            logits, _ = model.prefill(params, batch, cache)
            steps = [logits]
            for pos in range(s, s + 2):
                lg, _ = model.decode_step(params, t[:, pos:pos + 1],
                                          off + pos, cache)
                steps.append(lg)
        out[dev] = (steps, cache, time.perf_counter() - t0, log.calls)
        del params
    return out


def model_card_vs_cpu(cfg, s: int, seed: int) -> tuple:
    """`model_runs`, compared: the logits gaps (prefill, two steps), the
    worst cache leaf's gap, the leaves' shapes and the card's and the
    CPU's seconds."""
    from repro_torch.tree import tree_leaves
    out = model_runs(cfg, s, seed)
    gaps = [rel_gap(a, b) for a, b in zip(out["cuda"][0], out["cpu"][0])]
    leaves = list(zip(tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])))
    return (gaps, max(rel_gap(a, b) for a, b in leaves),
            sorted({tuple(a.shape) for a, _ in leaves}), out["cuda"][2],
            out["cpu"][2])


def model_decode_vs_prefill(cfg, prompt: int, steps: int, seed: int,
                            logs: dict | None = None) -> float:
    """`cfg` at B=1 on the card: a prefill of `prompt` tokens (after the
    patches of a vision_text config) and `steps` teacher-forced decode
    steps against one prefill of all the tokens; the last position's
    logits gap. `logs` (a dict) receives the MoE routing calls of the one
    prefill ("full") and of the split run ("split")."""
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    total = prompt + steps
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    full, base = prompt_batch(cfg, 1, total,
                              torch.Generator().manual_seed(seed), "cuda")
    toks, off = full.pop("tokens"), base - total
    extra = full
    with RoutingLog() as full_log:
        full, _ = model.prefill(params, {"tokens": toks, **extra},
                                model.init_cache(1, off + total,
                                                 device="cuda"))
    cache = model.init_cache(1, off + total, device="cuda")
    with RoutingLog() as split_log:
        model.prefill(params, {"tokens": toks[:, :prompt], **extra}, cache)
        for pos in range(prompt, total):
            logits, _ = model.decode_step(params, toks[:, pos:pos + 1],
                                          off + pos, cache)
    if logs is not None:
        logs.update(full=full_log.calls, split=split_log.calls)
    return rel_gap(logits, full)


def zoo_card_vs_cpu() -> list:
    """zamba2-7b at full width, its first 6 layers (five Mamba2 layers and
    the shared attention block), B=1, S=512, f32: prefill logits and every
    cache leaf, then two decode steps, on the card (kernels) and on the CPU
    (plain versions) from the same params."""
    gaps, cache_gap, _, _, _ = model_card_vs_cpu(zoo_f32_config(6),
                                                 ZOO_CHECK_S, 1)
    check(max(gaps) <= ZOO_RTOL and cache_gap <= ZOO_RTOL,
          f"zamba2 card vs CPU: logits gaps {gaps}, cache {cache_gap}")
    return [f"zamba2-7b card vs CPU (6 layers, full width, f32, S="
            f"{ZOO_CHECK_S}): max |dlogits| / max |logits| prefill "
            f"{gaps[0]:.3e}, decode steps {gaps[1]:.3e} {gaps[2]:.3e}; "
            f"worst cache leaf {cache_gap:.3e} (tol {ZOO_RTOL})"]


def zoo_decode_vs_prefill() -> list:
    """zamba2-7b at full width, its first 12 layers (ten Mamba2 layers and
    two insertions of the shared block), f32, on the card: a prefill of
    DVP_PROMPT tokens and DVP_STEPS teacher-forced decode steps give the
    last position's logits of one prefill of DVP_PROMPT + DVP_STEPS."""
    from repro_torch.models.ssm import ssd_chunk
    cfg = zoo_f32_config(12)
    total = DVP_PROMPT + DVP_STEPS
    chunk = ssd_chunk(total, cfg.ssm_chunk)
    check(chunk >= cfg.ssm_chunk // 2,
          f"{total} tokens would cut the SSD chunk to {chunk}")
    gap = model_decode_vs_prefill(cfg, DVP_PROMPT, DVP_STEPS, 2)
    check(gap <= ZOO_RTOL, f"zamba2 decode vs prefill gap {gap:.3e}")
    return [f"zamba2-7b decode vs prefill (12 layers, full width, f32): "
            f"prefill {DVP_PROMPT} + {DVP_STEPS} decode steps vs one "
            f"prefill of {total} (SSD chunk {chunk}): max "
            f"|dlogits| / max |logits| {gap:.3e} (tol {ZOO_RTOL})"]


def zoo_phases(gen, timing: dict) -> tuple[dict, dict, dict]:
    """The model zoo: both kernels against their plain versions and timed
    at the served shapes (their times land in `timing`), the main path of
    this slice (zamba2-7b served at full width and depth, every count set
    to 0 just before and read just after), mamba2-1.3b and granite-3-8b
    served, then the model path against the CPU and decode against
    prefill. Returns the kernels' max errors, their timed shapes and the
    main path's launches."""
    flash_err, rows = check_flash(gen)
    ssd_err, more = check_ssd(gen)
    for row in rows + more:
        print(row)
    zoo_timing = {
        "flash_attention": time_flash(gen, SERVE_B, SERVE_PROMPT, 32, 32,
                                      112),
        "ssd_scan": time_ssd(gen, SERVE_B, SERVE_PROMPT, 112, 64, 64, 256),
        "flash_attention granite": time_flash(gen, SERVE_B, SERVE_PROMPT,
                                              32, 8, 128),
        "ssd_scan mamba2": time_ssd(gen, SERVE_B, SERVE_PROMPT, 64, 64, 128,
                                    256)}
    shapes = {"flash_attention": "zamba2-7b: B=4 S=T=2048 H=KV=32 hd=112",
              "ssd_scan": "zamba2-7b: b=4 S=2048 h=112 p=64 n=64 Q=256",
              "flash_attention granite":
                  "granite-3-8b: B=4 S=T=2048 H=32 KV=8 hd=128",
              "ssd_scan mamba2": "mamba2-1.3b: b=4 S=2048 h=64 p=64 n=128 "
                                 "Q=256"}
    for name, t in zoo_timing.items():
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3:.2f} us (sdpa: "
                    f"{t['library_backend']})")
        print(f"{name.split()[0]} per call ({shapes[name]}, bf16): kernel "
              f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library {lib}, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}: {t['bytes']} bytes, {t['ops']} flops)")
    timing.update({k: zoo_timing[k] for k in ("flash_attention",
                                              "ssd_scan")})
    from repro_torch.configs import get_config
    counts, rows = serve_phase("zamba2-7b", get_config("zamba2_7b"),
                               {"flash_attention": 13, "ssd_scan": 68})
    launches = {k: counts[k] for k in ("flash_attention", "ssd_scan")}
    for row in rows:
        print(row)
    for label, cfg, expect in (
            ("mamba2-1.3b", get_config("mamba2_1_3b"),
             {"flash_attention": 0, "ssd_scan": 48}),
            (f"granite-3-8b, depth cut to {GRANITE_LAYERS}",
             get_config("granite_3_8b").replace(n_layers=GRANITE_LAYERS),
             {"flash_attention": GRANITE_LAYERS, "ssd_scan": 0})):
        for row in serve_phase(label, cfg, expect)[1]:
            print(row)
    for row in zoo_card_vs_cpu() + zoo_decode_vs_prefill():
        print(row)

    return ({"flash_attention": flash_err, "ssd_scan": ssd_err}, shapes,
            launches)


# --------------------------------------------------------------------------- #
# federated training of the zoo's text models (launch/train.py)
# --------------------------------------------------------------------------- #

# granite-3-8b at full width, its depth cut to TRAIN_LAYERS, bf16: TRAIN_N
# clients, TRAIN_K local steps of TRAIN_MB sequences of TRAIN_SEQ tokens,
# TRAIN_ROUNDS rounds of MIFA(array); zamba2-7b at full width, cut to its
# first ZAMBA_TRAIN_LAYERS (five Mamba2 layers and the shared attention
# block), for ZAMBA_TRAIN_ROUNDS rounds
TRAIN_LAYERS, TRAIN_N, TRAIN_K, TRAIN_MB, TRAIN_SEQ = 2, 4, 2, 2, 128
TRAIN_ROUNDS, ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_ROUNDS = 3, 6, 2
TRAIN_ETA0 = 0.25
TRAIN_FROM = (f"train granite-3-8b, {TRAIN_LAYERS} layers at full width, "
              f"N={TRAIN_N} K={TRAIN_K}, {TRAIN_ROUNDS} rounds of "
              "MIFA(array): one launch a round for the tree's leaf table")
# the round whose batch the in-round checks take, and their mask
TRAIN_CHECK_ROUND, TRAIN_CHECK_MASK = 3, (True, False, True, True)
# f32 model bounds (tests/test_torch_models.py), each leaf against its own
# magnitude: |d| <= MODEL_ATOL·max|ref| + MODEL_RTOL·|ref|
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5


def train_cfg(arch: str, n_layers: int, **change):
    from repro_torch.configs import get_config
    return get_config(arch).replace(n_layers=n_layers, fl_clients=TRAIN_N,
                                    fl_local_steps=TRAIN_K, **change)


def train_run(label, cfg, rounds, smi, clients=TRAIN_N
              ) -> tuple[dict, dict, list]:
    """`launch.train.train` on the card, every count set to 0 just before
    and read just after: `mifa_aggregate` once a round for each leaf table
    and no other kernel (the training forward calls none); finite losses
    and params. Prints ms a round, tokens/s and the peak allocation."""
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = train(cfg=cfg, rounds=rounds, clients=clients, k_steps=TRAIN_K,
                mb=TRAIN_MB, seq=TRAIN_SEQ, eta0=TRAIN_ETA0,
                memory="array", seed=0, device="cuda", log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(out["params"])
    expect = rounds * n_tables(len(leaves))
    others = {k: v for k, v in counts.items() if k != "mifa_aggregate"}
    check(counts["mifa_aggregate"] == expect and not any(others.values()),
          f"train {label}: kernel counts {counts}, expected "
          f"mifa_aggregate {expect} ({rounds} rounds of {len(leaves)} "
          "leaves) and nothing else")
    check(bool(np.isfinite(out["losses"]).all()),
          f"train {label}: losses {out['losses']}")
    check(all(bool(torch.isfinite(p.float()).all()) for p in leaves),
          f"train {label}: non-finite params")
    tokens = clients * TRAIN_K * TRAIN_MB * TRAIN_SEQ
    ms = [r * 1e3 for r in out["round_s"]]
    steady = float(np.median(ms[1:]))
    rows = [f"train {label}: {cfg.n_layers} layers at full width "
            f"(d_model {cfg.d_model}, vocab {cfg.vocab_size}), "
            f"{out['n_params']} params, {cfg.param_dtype}, N={clients} "
            f"K={TRAIN_K} mb={TRAIN_MB} seq={TRAIN_SEQ}, MIFA(array), "
            f"{rounds} rounds in {seconds:.3f} s",
            f"  losses {[round(x, 6) for x in out['losses']]}; "
            f"mifa_aggregate launches {counts['mifa_aggregate']} "
            f"({len(leaves)} leaves, {n_tables(len(leaves))} table)",
            f"  ms a round {[round(x, 3) for x in ms]} (host clock, each "
            f"ending in the read of its loss); rounds 1-{rounds - 1}: median "
            f"{steady:.3f} ms, {tokens / steady * 1e3:.1f} tokens/s "
            f"({tokens} tokens a round); peak device allocation {peak} B "
            f"[{smi}]"]
    return out, counts, rows


def train_round_inputs(cfg):
    """The checks' round: the batch of TRAIN_CHECK_ROUND (train()'s own
    batcher), the mask TRAIN_CHECK_MASK and that round's rate."""
    from repro_torch.data import TokenBatcher
    from repro_torch.optim import inv_t
    batcher = TokenBatcher(n_clients=TRAIN_N, vocab=cfg.vocab_size,
                           seq_len=TRAIN_SEQ, batch_size=TRAIN_MB,
                           k_steps=TRAIN_K, seed=0)
    toks = batcher.sample_round(TRAIN_CHECK_ROUND)["tokens"]
    eta = inv_t(TRAIN_ETA0)(TRAIN_CHECK_ROUND + 1)
    return ({"tokens": torch.from_numpy(toks).cuda()},
            torch.tensor(TRAIN_CHECK_MASK, device="cuda"), eta, toks)


def stale_leaf(j: int, p: torch.Tensor) -> torch.Tensor:
    """Leaf j of a stale update array (TRAIN_N, *shape), f32, drawn again
    from its seed whenever it is needed."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + j)
    return torch.randn((TRAIN_N,) + tuple(p.shape), generator=gen,
                       device="cuda")


def check_server_step(label: str, g_before, G, updates, active, params,
                      w_new, eta: float) -> tuple[float, int]:
    """The server step `mifa_aggregate_tree` just took (G written in place,
    w_new returned), leaf by leaf against `mifa_aggregate_ref` on the same
    inputs: G bit-equal, w within the `check_mifa` tolerance of the summed
    magnitudes. `g_before(j, w)` gives leaf j's G (j counts the leaves in
    `tree_map` order) as it stood before the step, (N, *w.shape) on the
    card. Returns max |dw| and the elements of
    G checked."""
    import itertools

    from repro_torch.kernels.mifa_aggregate import mifa_aggregate_ref
    from repro_torch.tree import tree_map
    n = active.numel()
    count, worst = itertools.count(), [0.0, 0]

    def verify(g_k, u, w, w_k):
        j = next(count)
        g_ref, w_ref = mifa_aggregate_ref(
            g_before(j, w).reshape(n, -1), u.reshape(n, -1), active,
            w.reshape(-1), eta)
        check(torch.equal(g_k.reshape(n, -1), g_ref),
              f"{label}: G of leaf {j} differs")
        rtol, atol = TOL[w.dtype]
        d = (w_k.reshape(-1).float() - w_ref.float()).abs()
        scale = w.reshape(-1).float().abs() + eta * g_ref.abs().mean(0)
        check(bool((d <= atol + rtol * scale).all()),
              f"{label}: w of leaf {j} off by {d.max().item():.3e}")
        worst[0] = max(worst[0], d.max().item())
        worst[1] += g_k.numel()

    tree_map(verify, G, updates, params, w_new)
    return worst[0], worst[1]


def train_kernel_check(model, params, cfg) -> tuple[float, str]:
    """(b) One round's updates of the trained granite tree (the batch of
    TRAIN_CHECK_ROUND) through `mifa_aggregate_tree` (the kernel) against
    the plain version on the same inputs (`check_server_step`)."""
    import itertools

    from repro_torch.core.local_update import client_updates
    from repro_torch.kernels.ops import mifa_aggregate_tree
    from repro_torch.tree import tree_map
    batch, active, eta, _ = train_round_inputs(cfg)
    eta_t = torch.tensor(eta, dtype=torch.float32, device="cuda")
    updates, _ = client_updates(model.loss_fn, params, batch, eta_t,
                                K=TRAIN_K)
    count = itertools.count()
    G = tree_map(lambda p: stale_leaf(next(count), p), params)
    G, w_new = mifa_aggregate_tree(G, updates, active, params, eta_t)
    torch.cuda.synchronize()
    worst, elements = check_server_step("train kernel check", stale_leaf, G,
                                        updates, active, params, w_new, eta)
    return worst, (
        f"train kernel vs plain (b): one round's updates of the trained "
        f"granite tree (batch of round {TRAIN_CHECK_ROUND}, mask "
        f"{[int(a) for a in TRAIN_CHECK_MASK]}, eta {eta}), "
        f"{elements} elements of G bit-equal, max |dw| {worst:.3e}")


def model_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| over the f32 model bound of each element, as a
    fraction of the bound (<= 1 passes), computed on a's device."""
    a, ref = a.float(), ref.to(a.device).float()
    bound = MODEL_ATOL * ref.abs().max() + MODEL_RTOL * ref.abs()
    return ((a - ref).abs() / bound.clamp(min=1e-30)).max().item()


def train_card_vs_cpu(arch: str = "granite_3_8b", label: str = "(c)",
                      n_layers: int = 1, named: tuple = ()) -> str:
    """(c) One client's loss and gradients, `arch` at full width in f32,
    its first `n_layers` layers, on the card and on the CPU from the same
    params and tokens (the first minibatch of client 0); an MoE model's
    router gradient (its first MoE layer's) and the attention leaves in
    `named` (the worst over the layers) are named in the line."""
    from torch.func import grad_and_value

    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = train_cfg(arch, n_layers, param_dtype="float32",
                    compute_dtype="float32")
    model = build_model(cfg)
    p_gpu = model.init(4, device="cuda")
    toks = torch.from_numpy(train_round_inputs(cfg)[3][0, 0])
    out = {}
    for dev, params in (("cuda", p_gpu),
                        ("cpu", tree_map(lambda t: t.cpu(), p_gpu))):
        t0 = time.perf_counter()
        g, (loss, _) = grad_and_value(model.loss_fn, has_aux=True)(
            params, {"tokens": toks.to(dev)})
        out[dev] = (loss, g, time.perf_counter() - t0)
    loss_gap = model_gap(out["cuda"][0], out["cpu"][0])
    gaps = [model_gap(a, b) for a, b in zip(tree_leaves(out["cuda"][1]),
                                            tree_leaves(out["cpu"][1]))]
    check(loss_gap <= 1 and max(gaps) <= 1,
          f"train card vs CPU ({arch}): loss {loss_gap:.3e}, gradient "
          f"leaves {[f'{x:.3e}' for x in gaps]} of the f32 model bound")
    segs = [(out["cuda"][1]["segments"][k], out["cpu"][1]["segments"][k])
            for k in out["cpu"][1]["segments"]]
    parts = []
    for name in named:
        leaf_gaps = [model_gap(a["attn"][name], b["attn"][name])
                     for a, b in segs if name in b.get("attn", {})]
        parts.append(f"{name} {max(leaf_gaps):.3e}")
    moe = [(a["moe"]["router"], b["moe"]["router"]) for a, b in segs
           if "moe" in b]
    if moe:
        parts.append(f"the router's {model_gap(*moe[0]):.3e}, max |grad| "
                     f"{moe[0][1].abs().max().item():.3e}")
    named_txt = f" ({'; '.join(parts)})" if parts else ""
    return (f"train card vs CPU {label}: {arch}, {n_layers} layer"
            f"{'s' if n_layers > 1 else ''} at full width, "
            f"f32, one client's minibatch ({TRAIN_MB} x {TRAIN_SEQ}): loss "
            f"{out['cuda'][0].item():.6f} / {out['cpu'][0].item():.6f}, "
            f"worst of {len(gaps)} gradient leaves {max(gaps):.3e} of the "
            f"bound{named_txt} (rtol {MODEL_RTOL}, atol "
            f"{MODEL_ATOL}·max|leaf|); "
            f"card {out['cuda'][2]:.3f} s, CPU {out['cpu'][2]:.3f} s")


def train_modes(params_bf16) -> str:
    """(d) `make_train_step` in vmap mode (the kernel) against sequential
    mode on the card, on an f32 copy of the trained granite tree and the
    batch of TRAIN_CHECK_ROUND: G and params at the f32 model bounds. (In
    bf16 compute the two modes' matmuls round differently, so f32.)"""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = train_cfg("granite_3_8b", TRAIN_LAYERS, param_dtype="float32",
                    compute_dtype="float32")
    params = tree_map(lambda p: p.float(), params_bf16)
    batch, active, eta, _ = train_round_inputs(cfg)
    res = {}
    for sequential in (False, True):
        c = cfg.replace(sequential_clients=sequential)
        step = make_train_step(build_model(c), c, TRAIN_N, TRAIN_K)
        G = tree_map(lambda p: torch.zeros((TRAIN_N,) + tuple(p.shape),
                                           device="cuda"), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[sequential] = step(params, G, batch, active, eta)
        torch.cuda.synchronize()
        res[sequential] += (time.perf_counter() - t0,)
        del G
    (p_v, g_v, m_v, s_v), (p_s, g_s, m_s, s_s) = res[False], res[True]
    gaps = [model_gap(a, b) for a, b in zip(
        tree_leaves(g_s) + tree_leaves(p_s), tree_leaves(g_v)
        + tree_leaves(p_v))]
    loss_gap = model_gap(m_s["loss"], m_v["loss"])
    check(max(gaps) <= 1 and loss_gap <= 1,
          f"train vmap vs sequential: loss {loss_gap:.3e}, leaves "
          f"{[f'{x:.3e}' for x in gaps]} of the f32 model bound")
    return (f"train vmap vs sequential (d): make_train_step on the granite "
            f"tree ({TRAIN_LAYERS} layers, full width, f32 copy), batch of "
            f"round {TRAIN_CHECK_ROUND}: loss {m_v['loss'].item():.6f} / "
            f"{m_s['loss'].item():.6f}, worst G or params leaf "
            f"{max(gaps):.3e} of the bound; vmap {s_v:.3f} s, sequential "
            f"{s_s:.3f} s")


def trees_equal(a, b) -> bool:
    """Every leaf of two trees of tensors bit-equal (dtype and shape
    too)."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def trees_gap(a, b) -> float:
    """The worst leaf of `a` against `b` as a fraction of the f32 model
    bound (`model_gap`)."""
    from repro_torch.tree import tree_leaves
    return max(model_gap(x, y) for x, y in zip(tree_leaves(a),
                                               tree_leaves(b)))


def remat_verdict(label: str, on, off, off_again) -> str:
    """How a remat-on result `on` stands to the remat-off result `off`
    (trees of tensors): bit-equal; or, when they differ, `off_again()` (a
    second remat-off run) must differ from `off` too (else remat moved
    the numbers) and `on` must be within the training tolerance of
    `off`, the remat-off run's own spread printed beside it."""
    if trees_equal(on, off):
        return "bit-equal to remat off"
    again = off_again()
    check(not trees_equal(again, off),
          f"{label}: remat off repeats itself bit for bit but remat on "
          f"differs from it ({trees_gap(on, off):.3e} of the bound)")
    gap, spread = trees_gap(on, off), trees_gap(again, off)
    check(gap <= 1, f"{label}: remat on {gap:.3e} of the training bound "
                    f"from remat off (remat off's own spread {spread:.3e})")
    return (f"not bit-equal, and remat off does not repeat itself: remat "
            f"on {gap:.3e} of the training bound (rtol {MODEL_RTOL}, atol "
            f"{MODEL_ATOL}·max|leaf|) from remat off, whose second run is "
            f"{spread:.3e} from its first")


def remat_off_check(label: str, cfg, rounds: int, on: dict, smi: str
                    ) -> list:
    """(f) The `train_run` that gave `on` (cfg.remat on) again with remat
    off: its rows (ms a round and the peak beside the remat run's), and
    its final params and losses held to the remat run's
    (`remat_verdict`). `on`'s params wait on the host meanwhile (popped
    from `on`), so the two runs' peaks count the same tensors."""
    from repro_torch.tree import tree_map
    check(cfg.remat, f"train {label}: the config's remat is off")
    off_cfg = cfg.replace(remat=False)
    on_params = tree_map(lambda t: t.cpu(), on.pop("params"))

    def run_off():
        out, _, rows = train_run(f"{label}, remat off", off_cfg, rounds,
                                 smi)
        return out, rows

    off, rows = run_off()

    def result(out):
        return [out["params"], torch.tensor(out["losses"])]

    on_result = [tree_map(lambda t: t.cuda(), on_params),
                 torch.tensor(on["losses"])]
    del on_params
    verdict = remat_verdict(f"train {label}", on_result, result(off),
                            lambda: result(run_off()[0]))
    rows.append(f"train {label} remat on vs off: final params and "
                f"{rounds} losses {verdict}")
    return rows


def train_phase(smi: str) -> tuple[dict, list]:
    """Federated training of the zoo's text models on the card
    (`launch.train.train`), with `cfg.remat` on as the configs say: (a)
    granite-3-8b at full width, 2 layers, the main path of this slice
    (counts read around it); (b) the kernel against its plain version
    inside the round; (c) one client's f32 loss and gradients, card
    against CPU; (d) `make_train_step`'s two modes; (e) zamba2-7b's
    hybrid training forward; (f) each of (a) and (e) again with remat off
    (`remat_off_check`). Returns (a)'s launches."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = train_cfg("granite_3_8b", TRAIN_LAYERS)
    out, counts, rows = train_run("granite-3-8b", cfg, TRAIN_ROUNDS, smi)
    err, row = train_kernel_check(build_model(out["cfg"]), out["params"],
                                  cfg)
    rows.append(row)
    rows.append(train_card_vs_cpu())
    rows.append(train_modes(out["params"]))
    rows += remat_off_check("granite-3-8b", cfg, TRAIN_ROUNDS, out, smi)
    del out
    cfg = train_cfg("zamba2_7b", ZAMBA_TRAIN_LAYERS)
    out, _, more = train_run("zamba2-7b", cfg, ZAMBA_TRAIN_ROUNDS, smi)
    rows += more
    rows += remat_off_check("zamba2-7b", cfg, ZAMBA_TRAIN_ROUNDS, out, smi)
    del out
    rows.append(f"train phase {time.perf_counter() - t0:.1f} s")
    return {"mifa_aggregate": counts["mifa_aggregate"],
            "kernel_check_err": err}, rows


# --------------------------------------------------------------------------- #
# gemma3-4b: sliding-window attention, flash_attention at head dim 256
# --------------------------------------------------------------------------- #

def gemma_card_vs_cpu() -> str:
    """gemma3-4b at full width, its first GEMMA_CHECK_LAYERS layers (five
    local, one global), f32: a prefill of GEMMA_CHECK_S > window tokens
    (the local rings filled past their end) and two decode steps, card
    against CPU (`model_card_vs_cpu`)."""
    gaps, cache_gap, shapes, card_s, cpu_s = model_card_vs_cpu(
        zoo_f32_config(GEMMA_CHECK_LAYERS, "gemma3_4b"), GEMMA_CHECK_S, 5)
    check(max(gaps) <= ZOO_RTOL and cache_gap <= ZOO_RTOL,
          f"gemma card vs CPU: logits gaps {gaps}, cache {cache_gap}")
    return (f"gemma card vs CPU ({GEMMA_CHECK_LAYERS} layers, full width, "
            f"f32, S={GEMMA_CHECK_S}, window {GEMMA_WINDOW}, cache leaves "
            f"{shapes}): max |dlogits| / max |logits| prefill "
            f"{gaps[0]:.3e}, decode steps {gaps[1]:.3e} {gaps[2]:.3e}; "
            f"worst cache leaf {cache_gap:.3e} (tol {ZOO_RTOL}); card "
            f"{card_s:.3f} s, CPU {cpu_s:.3f} s")


def gemma_decode_vs_prefill() -> str:
    """gemma3-4b at full width, GEMMA_CHECK_LAYERS layers, f32, on the
    card: GEMMA_DVP_PROMPT prompt tokens and GEMMA_DVP_STEPS decode steps
    (the local rings wrap at position 1024) against one prefill."""
    gap = model_decode_vs_prefill(
        zoo_f32_config(GEMMA_CHECK_LAYERS, "gemma3_4b"), GEMMA_DVP_PROMPT,
        GEMMA_DVP_STEPS, 6)
    check(gap <= ZOO_RTOL, f"gemma decode vs prefill gap {gap:.3e}")
    return (f"gemma decode vs prefill ({GEMMA_CHECK_LAYERS} layers, full "
            f"width, f32): prefill {GEMMA_DVP_PROMPT} + {GEMMA_DVP_STEPS} "
            f"decode steps (the {GEMMA_WINDOW}-slot rings wrap) vs one "
            f"prefill of {GEMMA_DVP_PROMPT + GEMMA_DVP_STEPS}: max "
            f"|dlogits| / max |logits| {gap:.3e} (tol {ZOO_RTOL})")


def gemma_phase(gen, smi) -> tuple[dict, list]:
    """gemma3-4b on the card: flash_attention timed at its two prefill
    shapes (global, and window 1024) beside sdpa and the bound; served at
    full width and depth (prefill launches flash_attention exactly 34
    times: 29 local layers, 5 global; decode none; no other kernel); card
    against CPU and decode against prefill at 6 layers in f32; two rounds
    of train() at full width. Returns the timings and the serve launches;
    every row starts with "gemma "."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    timing, rows = {}, []
    for label, window in (("global", 0), ("local", GEMMA_WINDOW)):
        t = time_flash(gen, SERVE_B, SERVE_PROMPT, 8, 4, 256, window)
        timing[label] = t
        rows.append(
            f"gemma flash_attention per call ({label}: B={SERVE_B} "
            f"S=T={SERVE_PROMPT} H=8 KV=4 hd=256 bf16 causal window="
            f"{window}): kernel {t['ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us, sdpa "
            f"{t['library_ms'] * 1e3:.2f} us ({t['library_backend']}), "
            f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
            f"{t['bytes']} bytes, {t['ops']} flops) [{smi}]")
    cfg = get_config("gemma3_4b")
    n_local = sum(k == "local_attn" for k in cfg.layer_kinds())
    counts, more = serve_phase("gemma3-4b", cfg,
                               {"flash_attention": cfg.n_layers,
                                "ssd_scan": 0})
    rows += [f"gemma {r}" for r in more]
    rows.append(f"gemma serve: {n_local} local layers (window "
                f"{cfg.swa_window}) and {cfg.n_layers - n_local} global, "
                f"one flash_attention launch each")
    rows.append(gemma_card_vs_cpu())
    rows.append(gemma_decode_vs_prefill())
    torch.cuda.empty_cache()
    train_cfg_g = train_cfg("gemma3_4b", GEMMA_TRAIN_LAYERS)
    rows += [f"gemma {r}" for r in train_run(
        "gemma3-4b", train_cfg_g, GEMMA_TRAIN_ROUNDS, smi,
        clients=GEMMA_TRAIN_N)[2]]
    rows.append(f"gemma phase {time.perf_counter() - t0:.1f} s")
    return {"timing": timing,
            "launches": counts["flash_attention"]}, rows


# --------------------------------------------------------------------------- #
# MoE: olmoe-1b-7b and moonshot-v1-16b-a3b (models/moe.py)
# --------------------------------------------------------------------------- #

def drop_share(calls, n_tokens: int) -> tuple[float, int]:
    """The share of assignments that found no slot, over the routing calls
    of `n_tokens` tokens, and the number of such calls."""
    ours = [(ids, table) for ids, table, *_ in calls
            if ids.shape[0] == n_tokens]
    total = sum(ids.numel() for ids, _ in ours)
    kept = sum(int((table < n_tokens).sum()) for _, table in ours)
    return 1 - kept / max(total, 1), len(ours)


def moe_layers(cfg) -> list:
    """The indices of cfg's MoE layers (those after `first_dense_layers`),
    in layer order."""
    from repro_torch.models.transformer import build_segments
    out, start = [], 0
    for seg in build_segments(cfg):
        if seg.ffn == "moe":
            out += range(start, start + seg.n_layers)
        start += seg.n_layers
    return out


def moe_serve(label: str, cfg, smi: str, tag: str = "moe"
              ) -> tuple[dict, list]:
    """`serve_phase` for an MoE model at full width and depth: exactly
    n_layers flash_attention launches a prefill, none in decode, no other
    kernel; one routing call a MoE layer; the capacity an expert has in
    prefill and in decode and the share of assignments it dropped in each
    (routing recorded, no device work added). Rows start with `tag`."""
    from repro_torch.models.moe import capacity
    with RoutingLog() as log:
        counts, rows = serve_phase(label, cfg, {
            "flash_attention": cfg.n_layers, "ssd_scan": 0})
    pre, n_pre = drop_share(log.calls, SERVE_B * SERVE_PROMPT)
    dec, n_dec = drop_share(log.calls, SERVE_B)
    n_moe = len(moe_layers(cfg))
    check(n_pre == n_moe and n_dec == n_moe * SERVE_NEW,
          f"{tag} serve {label}: {n_pre} prefill and {n_dec} decode routing "
          f"calls, expected {n_moe} and {n_moe * SERVE_NEW}")
    c_pre, c_dec = (capacity(t, cfg.top_k, cfg.n_experts,
                             cfg.moe_capacity_factor)
                    for t in (SERVE_B * SERVE_PROMPT, SERVE_B))
    rows = [f"{tag} {r}" for r in rows]
    rows.append(f"{tag} serve {label}: {n_moe} MoE layers, top {cfg.top_k} "
                f"of {cfg.n_experts} "
                f"experts, capacity factor {cfg.moe_capacity_factor}: "
                f"{c_pre} slots an expert in prefill ({SERVE_B} x "
                f"{SERVE_PROMPT} tokens), {c_dec} in decode ({SERVE_B} "
                f"tokens); dropped {pre:.6f} of prefill's assignments and "
                f"{dec:.6f} of decode's [{smi}]")
    return counts, rows


def moe_card_vs_cpu(arch: str = "olmoe_1b_7b", tag: str = "moe",
                    tol: float = ZOO_RTOL, seed: int = 7) -> str:
    """`arch` (an MoE model) at full width, its first MOE_CHECK_LAYERS
    layers, f32: `model_runs` (a prefill of MOE_CHECK_S tokens and two
    decode steps, card against CPU). Each MoE call's expert ids are
    compared first; a flip at a near-tie is allowed and printed, and what
    it reaches is not held: a prefill flip at layer l reaches every later
    layer at every position (capacity ties a layer's tokens together) and
    all logits, a flip in decode step j the later layers from its position
    on and the logits from step j on. Everything else (the logits and
    every cache leaf, layer by layer) is held at `tol`."""
    from repro_torch.models.transformer import build_segments
    from repro_torch.tree import tree_leaves
    cfg = zoo_f32_config(MOE_CHECK_LAYERS, arch)
    name = arch.replace("_", "-")
    L, S = cfg.n_layers, MOE_CHECK_S
    moe_l = moe_layers(cfg)
    M = len(moe_l)
    out = model_runs(cfg, S, seed)
    (steps_g, cache_g, card_s, calls_g), (steps_c, cache_c, cpu_s,
                                          calls_c) = out["cuda"], out["cpu"]
    check(len(calls_g) == len(calls_c) == 3 * M,
          f"{tag} card vs CPU: {len(calls_g)} / {len(calls_c)} routing "
          "calls")
    phase = ["prefill", "decode step 1", "decode step 2"]
    flips = routing_flips(f"{tag} card vs CPU", [
        (f"{phase[c // M]} layer {moe_l[c % M]}", g[0], r[0], r[2])
        for c, (g, r) in enumerate(zip(calls_g, calls_c))])
    hold = torch.ones((L, S + 2), dtype=torch.bool)
    hold_step = [True] * 3
    for c, row, _ in flips:
        step, layer = c // M, moe_l[c % M]
        hold[layer + 1:, 0 if step == 0 else S + step - 1:] = False
        for i in range(step, 3):
            hold_step[i] = False
    gaps = [rel_gap(a, b) if h else None
            for a, b, h in zip(steps_g, steps_c, hold_step)]
    cache_gap, start = 0.0, 0
    for seg in build_segments(cfg):
        n_l, key = seg.n_layers, str(seg.index)
        for a, b in zip(tree_leaves(cache_g[key]), tree_leaves(cache_c[key])):
            d = (a.float().cpu() - b.float()).abs().reshape(n_l, 1, S + 2, -1)
            d = d.amax(dim=(1, 3))[hold[start:start + n_l]]
            if d.numel():
                cache_gap = max(cache_gap,
                                (d.max() / b.float().abs().max()).item())
        start += n_l
    held = [g for g in gaps if g is not None]
    check(all(g <= tol for g in held) and cache_gap <= tol,
          f"{tag} card vs CPU: logits gaps {gaps}, cache {cache_gap}")
    n_ids = sum(g[0].numel() for g in calls_g)
    flip_txt = ("none" if not flips else "; ".join(
        f"{phase[c // M]} layer {moe_l[c % M]} row {row} (gap {gap:.3e})"
        for c, row, gap in flips))
    fmt = [("not held" if g is None else f"{g:.3e}") for g in gaps]
    return (f"{tag} card vs CPU ({name}, {L} layers, full width, f32, "
            f"S={S}): expert ids of {len(calls_g)} routing calls "
            f"({n_ids} ids) compared, flips at near-ties: {flip_txt}; max "
            f"|dlogits| / max |logits| prefill {fmt[0]}, decode steps "
            f"{fmt[1]} {fmt[2]}; worst cache leaf {cache_gap:.3e} over "
            f"{int(hold.sum())} of {hold.numel()} layer positions, leaves "
            f"{sorted({tuple(a.shape) for a in tree_leaves(cache_g)})} "
            f"(tol {tol}); card {card_s:.3f} s, CPU {cpu_s:.3f} s")


def moe_decode_vs_prefill(arch: str = "olmoe_1b_7b", tag: str = "moe",
                          tol: float = ZOO_RTOL, seed: int = 8) -> str:
    """`arch` (an MoE model) at full width, MOE_CHECK_LAYERS layers, f32,
    capacity factor E/k (C = T: nothing drops), on the card:
    MOE_DVP_PROMPT prompt tokens and MOE_DVP_STEPS decode steps against
    one prefill, held at `tol`; each token's experts compared with the
    one prefill's first (a flip at a near-tie reaches the last logits,
    which are then not held)."""
    cfg = zoo_f32_config(MOE_CHECK_LAYERS, arch)
    cfg = cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.top_k)
    L, P, n = cfg.n_layers, MOE_DVP_PROMPT, MOE_DVP_STEPS
    moe_l = moe_layers(cfg)
    M = len(moe_l)
    logs: dict = {}
    gap = model_decode_vs_prefill(cfg, P, n, seed, logs)
    full, split = logs["full"], logs["split"]
    check(len(full) == M and len(split) == M * (1 + n),
          f"{tag} decode vs prefill: {len(full)} / {len(split)} routing "
          "calls")
    check(all(int((table < ids.shape[0]).sum()) == ids.numel()
              for ids, table, *_ in full + split),
          f"{tag} decode vs prefill: an assignment dropped at C = T")
    pairs = [(f"prompt layer {moe_l[i]}", split[i][0], full[i][0][:P],
              full[i][2][:P]) for i in range(M)]
    pairs += [(f"decode step {j} layer {moe_l[i]}", split[M * (1 + j) + i][0],
               full[i][0][P + j:P + j + 1], full[i][2][P + j:P + j + 1])
              for j in range(n) for i in range(M)]
    flips = routing_flips(f"{tag} decode vs prefill", pairs)
    if not flips:
        check(gap <= tol, f"{tag} decode vs prefill gap {gap:.3e}")
    flip_txt = ("none" if not flips else "; ".join(
        f"{pairs[i][0]} row {row} (gap {g:.3e})" for i, row, g in flips))
    return (f"{tag} decode vs prefill ({arch.replace('_', '-')}, {L} "
            f"layers, full width, f32, capacity factor "
            f"{cfg.moe_capacity_factor}): prefill {P} + {n} decode steps vs "
            f"one prefill of {P + n}: experts of every token equal but "
            f"near-tie flips: {flip_txt}; max |dlogits| / max |logits| "
            f"{gap:.3e} ({'held' if not flips else 'not held'}, tol {tol})")


def moe_phase(gen, smi: str) -> tuple[dict, list]:
    """MoE on the card: flash_attention timed at olmoe-1b-7b's prefill
    shape beside sdpa and the bound; olmoe-1b-7b (16 layers) and
    moonshot-v1-16b-a3b (48 layers, 56.13 GB of bf16 params) served at full
    width and depth (`moe_serve`); olmoe card against CPU and decode
    against prefill at MOE_CHECK_LAYERS layers in f32; MOE_TRAIN_ROUNDS
    rounds of train() at MOE_TRAIN_LAYERS layers, full width, with one
    client's f32 gradients (the router's among them) card against CPU.
    Returns the timing and the launches; every row starts with "moe "."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    t = time_flash(gen, SERVE_B, SERVE_PROMPT, 16, 16, 128)
    rows = [f"moe flash_attention per call (olmoe-1b-7b and "
            f"moonshot-v1-16b-a3b: B={SERVE_B} S=T={SERVE_PROMPT} H=KV=16 "
            f"hd=128 bf16 causal): kernel {t['ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us, sdpa "
            f"{t['library_ms'] * 1e3:.2f} us ({t['library_backend']}), "
            f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
            f"{t['bytes']} bytes, {t['ops']} flops) [{smi}]"]
    launches = {}
    for arch in ("olmoe-1b-7b", "moonshot-v1-16b-a3b"):
        torch.cuda.empty_cache()
        counts, more = moe_serve(arch, get_config(arch), smi)
        launches[arch] = counts["flash_attention"]
        rows += more
    torch.cuda.empty_cache()
    rows.append(moe_card_vs_cpu())
    rows.append(moe_decode_vs_prefill())
    torch.cuda.empty_cache()
    out, counts, more = train_run(
        "olmoe-1b-7b", train_cfg("olmoe_1b_7b", MOE_TRAIN_LAYERS),
        MOE_TRAIN_ROUNDS, smi, clients=MOE_TRAIN_N)
    del out
    rows += [f"moe {r}" for r in more]
    torch.cuda.empty_cache()
    rows.append("moe " + train_card_vs_cpu("olmoe_1b_7b", "(olmoe)"))
    rows.append(f"moe phase {time.perf_counter() - t0:.1f} s")
    return {"timing": t, "launches": launches,
            "train_launches": counts["mifa_aggregate"]}, rows


# --------------------------------------------------------------------------- #
# MLA: deepseek-v2-lite-16b (models/attention.py), v's own head dim
# --------------------------------------------------------------------------- #

def mla_phase(gen, smi: str) -> tuple[dict, list]:
    """MLA on the card: flash_attention timed at deepseek-v2-lite-16b's
    prefill shape (MLA_SHAPE: hd 192, v's head dim 128) beside sdpa and
    the bound; the model served at full width and depth (`moe_serve`: 27
    launches a prefill, 26 routing calls); card against CPU (prefill
    logits, the `c` and `pe` caches, two decode steps) and the absorbed
    decode against the decompressed prefill at MOE_CHECK_LAYERS layers in
    f32, within MLA_RTOL; MOE_TRAIN_ROUNDS rounds of train() at
    MOE_TRAIN_LAYERS layers (one dense, one MoE), with one client's f32
    gradients card against CPU at those layers. Returns the timing and
    the launches; every row starts with "mla "."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    b, s, h, kv, hd, dv = MLA_SHAPE
    t = time_flash(gen, b, s, h, kv, hd, dv=dv)
    rows = [f"mla flash_attention per call (deepseek-v2-lite-16b: B={b} "
            f"S=T={s} H=KV={h} hd={hd} dv={dv} bf16 causal): kernel "
            f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
            f"sdpa {t['library_ms'] * 1e3:.2f} us ({t['library_backend']}), "
            f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
            f"{t['bytes']} bytes, {t['ops']} flops) [{smi}]"]
    torch.cuda.empty_cache()
    cfg = get_config("deepseek_v2_lite_16b")
    counts, more = moe_serve("deepseek-v2-lite-16b", cfg, smi, tag="mla")
    rows += more
    torch.cuda.empty_cache()
    rows.append(moe_card_vs_cpu("deepseek_v2_lite_16b", "mla", MLA_RTOL, 9))
    rows.append(moe_decode_vs_prefill("deepseek_v2_lite_16b", "mla",
                                      MLA_RTOL, 10))
    torch.cuda.empty_cache()
    out, train_counts, more = train_run(
        "deepseek-v2-lite-16b",
        train_cfg("deepseek_v2_lite_16b", MOE_TRAIN_LAYERS),
        MOE_TRAIN_ROUNDS, smi, clients=MOE_TRAIN_N)
    del out
    rows += [f"mla {r}" for r in more]
    torch.cuda.empty_cache()
    rows.append("mla " + train_card_vs_cpu(
        "deepseek_v2_lite_16b", "(deepseek)", MOE_TRAIN_LAYERS,
        ("w_uk", "w_uv", "w_kpe")))
    rows.append(f"mla phase {time.perf_counter() - t0:.1f} s")
    return {"timing": t, "launches": counts["flash_attention"],
            "launches_from": (
                f"deepseek-v2-lite-16b serve prefill, {SERVE_B} x "
                f"{SERVE_PROMPT} tokens, one launch a layer "
                f"({cfg.n_layers}); decode launches none"),
            "train_launches": train_counts["mifa_aggregate"]}, rows


# --------------------------------------------------------------------------- #
# the stub frontends: llava-next-34b (vision_text) and hubert-xlarge (audio)
# --------------------------------------------------------------------------- #

def stub_batch(cfg, n: int, k: int, mb: int, s: int, seed: int) -> dict:
    """A round's batch of a stub-frontend config, leaves (n, k, mb, ...)
    on the card, drawn with numpy from `seed` in the layout of the
    reference's `launch/specs.py::_train_batch`: vision_text `tokens`
    (s - n_patches of them) and `patches` x 0.02; audio `frames` and their
    `labels`. Float leaves in the compute dtype."""
    from repro_torch.models.model import DTYPES
    rng = np.random.default_rng(seed)
    cdt, lead = DTYPES[cfg.compute_dtype], (n, k, mb)
    if cfg.modality == "vision_text":
        arrays = {"tokens": rng.integers(0, cfg.vocab_size,
                                         lead + (s - cfg.n_patches,)),
                  "patches": 0.02 * rng.standard_normal(
                      lead + (cfg.n_patches, cfg.d_model), np.float32)}
    else:
        arrays = {"frames": rng.standard_normal(lead + (s, cfg.d_model),
                                                np.float32),
                  "labels": rng.integers(0, cfg.vocab_size, lead + (s,))}
    return {key: (torch.from_numpy(a.astype(np.int32)).cuda()
                  if a.dtype.kind == "i" else
                  torch.from_numpy(a).cuda().to(cdt))
            for key, a in arrays.items()}


def stub_train(label: str, cfg, n: int, mb: int, s: int, smi: str
               ) -> tuple[dict, list]:
    """STUB_TRAIN_ROUNDS MIFA(array) rounds of `make_train_step` in cfg's
    mode on the card (params from seed 0, G f32 from zeros, round r's
    batch from seed r, its mask STUB_MASKS[r], inv_t(TRAIN_ETA0)), every
    count set to 0 just before and read just after: the vmap mode
    launches `mifa_aggregate` once a round for each leaf table, the
    sequential mode (plain PyTorch, as the reference's scan) nothing;
    finite losses and params; the client inactive in round 1 keeps its
    stored update bit for bit; in vmap mode, one more round's server step
    held against the plain version (`stub_server_check`). Returns the
    counts and the rows."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_leaves, tree_map
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    k = cfg.fl_local_steps
    params = model.init(0, device="cuda")
    G = tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                       device="cuda"), params)
    step = make_train_step(model, cfg, n, k)
    n_leaves = len(tree_leaves(params))
    reset_counts()
    losses, ms, kept = [], [], None
    for r in range(STUB_TRAIN_ROUNDS):
        batch = stub_batch(cfg, n, k, mb, s, r)
        active = torch.tensor(STUB_MASKS[r], device="cuda")
        eta = torch.tensor(inv_t(TRAIN_ETA0)(r + 1), device="cuda")
        if r:
            # on the host: a client's f32 row is 5.06 GB for hubert at
            # full depth, and the round's own peak nears the card's size
            kept = [g[1].cpu() for g in tree_leaves(G)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, G, metrics = step(params, G, batch, active, eta)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        del batch
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = ({} if cfg.sequential_clients else
              {"mifa_aggregate": STUB_TRAIN_ROUNDS * n_tables(n_leaves)})
    check(nonzero(counts) == expect,
          f"train {label}: kernel counts {counts}, expected {expect}")
    check(bool(np.isfinite(losses).all()),
          f"train {label}: losses {losses}")
    check(all(bool(torch.isfinite(p.float()).all())
              for p in tree_leaves(params)), f"train {label}: non-finite "
                                             "params")
    check(all(torch.equal(a, g[1].cpu())
              for a, g in zip(kept, tree_leaves(G))),
          f"train {label}: the inactive client's stored update moved")
    tokens = n * k * mb * s
    mode = "sequential" if cfg.sequential_clients else "vmap"
    rows = [f"train {label}: make_train_step ({mode}), {cfg.n_layers} "
            f"layers at full width (d_model {cfg.d_model}, vocab "
            f"{cfg.vocab_size}), {model.param_count(params)} params, "
            f"{cfg.param_dtype}, N={n} K={k} mb={mb} S={s}, masks "
            f"{[list(map(int, m)) for m in STUB_MASKS]}",
            f"  losses {[round(x, 6) for x in losses]}; kernel launches "
            f"{nonzero(counts) or 'none'} ({n_leaves} leaves); the "
            f"inactive client's stored update bit-equal",
            f"  ms a round {[round(x, 3) for x in ms]} (host clock, each "
            f"ending in the read of its loss), {tokens} positions a round, "
            f"{tokens / ms[-1] * 1e3:.1f} a second in round 1; peak device "
            f"allocation {peak} B [{smi}]"]
    if not cfg.sequential_clients:
        del kept
        rows.append(stub_server_check(label, model, cfg, params, G,
                                      (n, k, mb, s)))
    return counts, rows


def stub_server_check(label: str, model, cfg, params, G, shape) -> str:
    """One more vmap round's server step from the trained state (the batch
    of seed STUB_TRAIN_ROUNDS, mask STUB_MASKS[1]: a client inactive, its
    stored row kept), in the two halves `make_train_step` runs:
    `client_updates`, then `mifa_aggregate_tree` (the kernel), held against
    the plain version leaf by leaf (`check_server_step`). A copy of G as
    it stood before stays on the card (f32, N x the params: 10.1 GB for
    hubert at full depth, beside its 42 GB peak in training): a copy
    through the host took most of the check's 13 s. Not counted: the
    counts were read before it."""
    from repro_torch.core.local_update import client_updates
    from repro_torch.kernels.ops import mifa_aggregate_tree
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_map
    n, k, mb, s = shape
    r = STUB_TRAIN_ROUNDS
    t0 = time.perf_counter()
    batch = stub_batch(cfg, n, k, mb, s, r)
    active = torch.tensor(STUB_MASKS[1], device="cuda")
    eta = inv_t(TRAIN_ETA0)(r + 1)
    eta_t = torch.tensor(eta, dtype=torch.float32, device="cuda")
    before = []
    tree_map(lambda g: before.append(g.clone()), G)
    updates, _ = client_updates(model.loss_fn, params, batch, eta_t, K=k)
    del batch
    G, w_new = mifa_aggregate_tree(G, updates, active, params, eta_t)
    torch.cuda.synchronize()
    worst, elements = check_server_step(
        f"train {label} server step", lambda j, w: before[j], G,
        updates, active, params, w_new, eta)
    return (f"  server step vs plain: a round from the trained state "
            f"(batch of seed {r}, mask {list(map(int, STUB_MASKS[1]))}, "
            f"eta {eta}), {len(before)} leaves at {cfg.n_layers} layers, "
            f"{elements} elements of G bit-equal, max |dw| {worst:.3e} "
            f"(bf16 tolerance {TOL[torch.bfloat16]}); "
            f"{time.perf_counter() - t0:.1f} s")


def llava_phase(gen, smi: str) -> tuple[dict, list]:
    """llava-next-34b on the card: flash_attention held against its plain
    version at the prefill's shape (LLAVA_SHAPE: g = 7, S = 2912 not a
    multiple of the tiles) in bf16 and f32, and timed there beside sdpa
    and the bound; served at full width and depth (60 launches a prefill
    over 2880 patches and LLAVA_PROMPT tokens, none in decode); card
    against CPU and decode against prefill at LLAVA_CHECK_LAYERS layers in
    f32; STUB_TRAIN_ROUNDS rounds of the sequential make_train_step at
    LLAVA_TRAIN_LAYERS layers. Returns the check's |err|, the timing and
    the launches; every row starts with "llava "."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    b, s, h, kv, hd = LLAVA_SHAPE
    err, rows = check_flash_cases(gen, [
        (LLAVA_SHAPE, torch.bfloat16, True, 0, "llava path, g=7"),
        (LLAVA_SHAPE, torch.float32, True, 0, "llava path f32")])
    t = time_flash(gen, b, s, h, kv, hd)
    rows.append(
        f"flash_attention per call (llava-next-34b: B={b} S=T={s} H={h} "
        f"KV={kv} hd={hd} bf16 causal): kernel {t['ms'] * 1e3:.2f} us, "
        f"plain {t['plain_ms'] * 1e3:.2f} us, sdpa "
        f"{t['library_ms'] * 1e3:.2f} us ({t['library_backend']}), bound "
        f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: {t['bytes']} "
        f"bytes, {t['ops']} flops) [{smi}]")
    torch.cuda.empty_cache()
    cfg = get_config("llava_next_34b")
    counts, more = serve_phase("llava-next-34b", cfg,
                               {"flash_attention": cfg.n_layers,
                                "ssd_scan": 0}, LLAVA_PROMPT, LLAVA_NEW)
    rows += more
    rows.append(f"serve llava-next-34b: each prefill attends over "
                f"{cfg.n_patches} patches + {LLAVA_PROMPT} tokens = "
                f"{cfg.n_patches + LLAVA_PROMPT} positions, the cache holds "
                f"{cfg.n_patches + LLAVA_PROMPT + LLAVA_NEW}; tok/s counts "
                "text tokens")
    torch.cuda.empty_cache()
    check_cfg = zoo_f32_config(LLAVA_CHECK_LAYERS, "llava_next_34b")
    gaps, cache_gap, shapes, card_s, cpu_s = model_card_vs_cpu(
        check_cfg, LLAVA_CHECK_PROMPT, 11)
    check(max(gaps) <= ZOO_RTOL and cache_gap <= ZOO_RTOL,
          f"llava card vs CPU: logits gaps {gaps}, cache {cache_gap}")
    rows.append(f"card vs CPU ({LLAVA_CHECK_LAYERS} layer, full width, "
                f"f32, {cfg.n_patches} patches + {LLAVA_CHECK_PROMPT} "
                f"tokens, cache leaves {shapes}): max |dlogits| / max "
                f"|logits| prefill {gaps[0]:.3e}, decode steps "
                f"{gaps[1]:.3e} {gaps[2]:.3e}; worst cache leaf "
                f"{cache_gap:.3e} (tol {ZOO_RTOL}); card {card_s:.3f} s, "
                f"CPU {cpu_s:.3f} s")
    gap = model_decode_vs_prefill(check_cfg, LLAVA_CHECK_PROMPT,
                                  LLAVA_DVP_STEPS, 12)
    check(gap <= ZOO_RTOL, f"llava decode vs prefill gap {gap:.3e}")
    rows.append(f"decode vs prefill ({LLAVA_CHECK_LAYERS} layer, full "
                f"width, f32): {cfg.n_patches} patches + "
                f"{LLAVA_CHECK_PROMPT} tokens, then {LLAVA_DVP_STEPS} decode "
                f"steps vs one prefill of {cfg.n_patches} + "
                f"{LLAVA_CHECK_PROMPT + LLAVA_DVP_STEPS}: max |dlogits| / max "
                f"|logits| {gap:.3e} (tol {ZOO_RTOL})")
    train_counts, more = stub_train(
        "llava-next-34b", cfg.replace(n_layers=LLAVA_TRAIN_LAYERS,
                                      fl_clients=LLAVA_TRAIN_N),
        LLAVA_TRAIN_N, 1, cfg.n_patches + LLAVA_TRAIN_TEXT, smi)
    rows += more
    rows.append(f"phase {time.perf_counter() - t0:.1f} s")
    return {"err": err, "timing": t, "launches": counts["flash_attention"],
            "launches_from": (
                f"llava-next-34b serve prefill, {SERVE_B} x "
                f"({cfg.n_patches} patches + {LLAVA_PROMPT} tokens), one "
                f"launch a layer ({cfg.n_layers}); decode launches none")
            }, [f"llava {r}" for r in rows]


def hubert_card_vs_cpu() -> str:
    """hubert-xlarge at full width in f32, its first HUBERT_CHECK_LAYERS
    layers: the `make_encoder_step` score of HUBERT_SCORE_B x 512 frames
    and one client's loss and gradients (a minibatch of HUBERT_TRAIN_MB x
    512 frames), on the card and on the CPU from the same params, at the
    f32 model bounds."""
    from torch.func import grad_and_value

    from repro_torch.launch.steps import make_encoder_step
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = zoo_f32_config(HUBERT_CHECK_LAYERS, "hubert_xlarge")
    model = build_model(cfg)
    p_gpu = model.init(13, device="cuda")
    score = stub_batch(cfg, 1, 1, HUBERT_SCORE_B, 512, 13)
    mb = stub_batch(cfg, 1, 1, HUBERT_TRAIN_MB, 512, 14)
    out = {}
    for dev, params in (("cuda", p_gpu),
                        ("cpu", tree_map(lambda t: t.cpu(), p_gpu))):
        t0 = time.perf_counter()
        ce = make_encoder_step(model)(
            params, {k: v[0, 0].to(dev) for k, v in score.items()})
        g, (loss, _) = grad_and_value(model.loss_fn, has_aux=True)(
            params, {k: v[0, 0].to(dev) for k, v in mb.items()})
        out[dev] = (ce, loss, g, time.perf_counter() - t0)
    ce_gap = model_gap(out["cuda"][0], out["cpu"][0])
    loss_gap = model_gap(out["cuda"][1], out["cpu"][1])
    gaps = [model_gap(a, b) for a, b in zip(tree_leaves(out["cuda"][2]),
                                            tree_leaves(out["cpu"][2]))]
    check(max(ce_gap, loss_gap, *gaps) <= 1,
          f"hubert card vs CPU: score {ce_gap:.3e}, loss {loss_gap:.3e}, "
          f"gradient leaves {[f'{x:.3e}' for x in gaps]} of the bound")
    return (f"card vs CPU ({HUBERT_CHECK_LAYERS} layers at full width, f32, "
            f"non-causal): encoder score of {HUBERT_SCORE_B} x 512 frames "
            f"{out['cuda'][0].item():.6f} / {out['cpu'][0].item():.6f} "
            f"({ce_gap:.3e} of the bound); one client's minibatch "
            f"({HUBERT_TRAIN_MB} x 512) loss {loss_gap:.3e}, worst of "
            f"{len(gaps)} gradient leaves {max(gaps):.3e} of the bound "
            f"(rtol {MODEL_RTOL}, atol {MODEL_ATOL}·max|leaf|); card "
            f"{out['cuda'][3]:.3f} s, CPU {out['cpu'][3]:.3f} s")


def remat_round_pair(label: str, cfg, n: int, mb: int, s: int, smi: str
                     ) -> list:
    """One vmap `make_train_step` round of `cfg` from params of seed 0 and
    G from zeros (the batch of seed 0, mask STUB_MASKS[0],
    inv_t(TRAIN_ETA0)) with cfg.remat on, then the same round with it
    off: each round's ms (host clock to a sync) and peak allocation, and
    the two rounds' params and G bit-equal (no MoE: nothing in the round
    sums by index, so the card repeats it bit for bit). The remat
    round's params and G stay on the card while the other round runs
    (`cfg` at HUBERT_TRAIN_LAYERS: both fit)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_map
    check(cfg.remat, f"{label}: the config's remat is off")
    k = cfg.fl_local_steps
    eta = inv_t(TRAIN_ETA0)(1)
    rows, res = [], {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        model = build_model(c)
        torch.cuda.empty_cache()
        params = model.init(0, device="cuda")
        G = tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                           device="cuda"), params)
        batch = stub_batch(c, n, k, mb, s, 0)
        active = torch.tensor(STUB_MASKS[0], device="cuda")
        step = make_train_step(model, c, n, k)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, G, metrics = step(params, G, batch, active,
                                  torch.tensor(eta, device="cuda"))
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        del batch, metrics
        rows.append(f"  remat {'on' if remat else 'off'}: one round from "
                    f"params of seed 0 and G = 0 (batch of seed 0, mask "
                    f"{list(map(int, STUB_MASKS[0]))}), {c.n_layers} "
                    f"layers, loss {loss:.6f}, {ms:.3f} ms (host clock to "
                    f"a sync), peak device allocation {peak} B, of which "
                    f"{held} B held before the round [{smi}]")
        res[remat] = [params, G]
        del params, G
    check(trees_equal(res[True], res[False]),
          f"train {label}: the remat round's params and G differ from the "
          f"round without remat ({trees_gap(res[True], res[False]):.3e} of "
          "the training bound)")
    del res
    return ([f"train {label} remat on vs off (`remat_round_pair`), N={n} "
             f"K={k} mb={mb} S={s}:"] + rows
            + ["  params and G bit-equal"])


def hubert_phase(smi: str) -> tuple[dict, list]:
    """hubert-xlarge on the card: scored through `make_encoder_step` at
    full width and depth (48 layers; the training forward, no kernel),
    card against CPU at HUBERT_CHECK_LAYERS layers in f32, and
    STUB_TRAIN_ROUNDS rounds of the vmap make_train_step at
    HUBERT_TRAIN_LAYERS layers (one `mifa_aggregate` launch a round), then
    one more round's server step against the plain version leaf by leaf,
    and the remat pair (`remat_round_pair`). Returns the training
    launches; every row starts with "hubert "."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_encoder_step
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = get_config("hubert_xlarge")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    batch = {k: v[0, 0] for k, v in stub_batch(
        cfg, 1, 1, HUBERT_SCORE_B, HUBERT_SCORE_S, 0).items()}
    score = make_encoder_step(model)
    times = []
    reset_counts()
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ce = score(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    counts = read_counts()
    check(ce.shape == () and bool(torch.isfinite(ce)),
          f"hubert score {ce}")
    check(not nonzero(counts), f"hubert score launched {counts}")
    frames = HUBERT_SCORE_B * HUBERT_SCORE_S
    rows = [f"score: make_encoder_step at full width and depth "
            f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{model.param_count(params)} params, {cfg.param_dtype}, "
            f"non-causal), {HUBERT_SCORE_B} x {HUBERT_SCORE_S} frames: CE "
            f"{ce.item():.6f}; ms {[round(x, 3) for x in times]} (host "
            f"clock to a sync; the first includes warm-up), "
            f"{frames / times[-1] * 1e3:.1f} frames/s; no kernel launch "
            f"(the training forward); peak device allocation "
            f"{torch.cuda.max_memory_allocated()} B [{smi}]"]
    del params, batch
    rows.append(hubert_card_vs_cpu())
    train_cfg = cfg.replace(fl_clients=HUBERT_TRAIN_N,
                            n_layers=HUBERT_TRAIN_LAYERS)
    train_counts, more = stub_train(
        "hubert-xlarge", train_cfg, HUBERT_TRAIN_N, HUBERT_TRAIN_MB,
        HUBERT_TRAIN_S, smi)
    rows += more
    rows += remat_round_pair("hubert-xlarge", train_cfg,
                             HUBERT_TRAIN_N, HUBERT_TRAIN_MB, HUBERT_TRAIN_S,
                             smi)
    rows.append(f"phase {time.perf_counter() - t0:.1f} s")
    return ({"train_launches": train_counts["mifa_aggregate"],
             "train_launches_from": (
                 f"make_train_step (vmap) hubert-xlarge, "
                 f"{HUBERT_TRAIN_LAYERS} layers at full width, "
                 f"N={HUBERT_TRAIN_N}, "
                 f"{STUB_TRAIN_ROUNDS} rounds of MIFA(array)")},
            [f"hubert {r}" for r in rows])


# --------------------------------------------------------------------------- #
# the dry-run planner, head padding and update_spec= on the card
# --------------------------------------------------------------------------- #

# every arch x input shape planned on both abstract production meshes: the
# reference's counts (long_500k skips the six full-attention archs, hubert
# has no decode)
DRY_PLANS = {"ok": 64, "skip": 16, "error": 0}
# qwen1.5-110b at full width with its depth cut to QWEN_LAYERS: the
# decode_32k plan's arguments (B = 128, a cache of 32768 positions) made
# on the card, held to the plan's per-rank bytes within ALLOC_SLACK a
# tensor (the caching allocator rounds a block up to 512 B and leaves a
# new segment's tail of under 2 MiB in the block), and one decode step;
# served at SERVE_B x SERVE_PROMPT with and without pad_heads, so
# flash_attention runs at QWEN_PAD_SHAPE (H 64 over KV 16, kv heads 8-15
# zero) and QWEN_SHAPE (B, S, H, KV, hd); card vs CPU padded at
# QWEN_CHECK_LAYERS layers in f32 over QWEN_CHECK_PROMPT tokens
QWEN_LAYERS, QWEN_CHECK_LAYERS, QWEN_CHECK_PROMPT = 2, 1, 16
QWEN_SHAPE = (SERVE_B, SERVE_PROMPT, 64, 8, 128)
QWEN_PAD_SHAPE = (SERVE_B, SERVE_PROMPT, 64, 16, 128)
ALLOC_SLACK = 2 << 20
# make_train_step(update_spec=) from the train_4k plan on the 1x1 mesh:
# qwen at UPDATE_LAYERS layer, UPDATE_N clients, K = 1 and one sequence of
# UPDATE_S tokens where that plan's own bytes leave UPDATE_HEADROOM of the
# card, else llava-next-34b at LLAVA_TRAIN_LAYERS layers
UPDATE_LAYERS, UPDATE_N, UPDATE_S, UPDATE_HEADROOM = 1, 2, 128, 10e9


def plan_every_pair() -> str:
    """`launch.specs.plan` for every arch x input shape on both abstract
    production meshes: the counts must be DRY_PLANS, no error."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    from repro_torch.launch.dryrun import PRODUCTION_MESHES, production_mesh
    from repro_torch.launch.specs import Skip, plan
    t0 = time.perf_counter()
    counts, errors = {"ok": 0, "skip": 0, "error": 0}, []
    for kind in PRODUCTION_MESHES:
        mesh = production_mesh(kind)
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                try:
                    p = plan(arch, shape, mesh)
                except Exception as e:  # noqa: BLE001 — counted, then fails
                    counts["error"] += 1
                    errors.append(f"{arch} {shape} {kind}: "
                                  f"{type(e).__name__}: {e}")
                    continue
                counts["skip" if isinstance(p, Skip) else "ok"] += 1
    check(counts == DRY_PLANS and not errors,
          f"dryrun plans: {counts}, expected {DRY_PLANS}; {errors[:3]}")
    return (f"plans: every arch x input shape on the 16x16 and 2x16x16 "
            f"abstract meshes: {counts['ok']} ok / {counts['skip']} skip / "
            f"{counts['error']} error in {time.perf_counter() - t0:.2f} s")


def tensor_leaves(values) -> list:
    """The tensors of a plan's argument tuple, in order."""
    from repro_torch.tree import tree_leaves
    return [t for v in values for t in tree_leaves(v)]


def qwen_cfg(n_layers: int, **change):
    from repro_torch.configs import get_config
    return get_config("qwen1_5_110b").replace(n_layers=n_layers, **change)


def qwen_decode_plan(mesh, smi: str) -> list:
    """qwen's decode_32k plan at QWEN_LAYERS layers on `mesh` (1x1 on the
    card): its arguments made on the card (params from seed 0, a zero
    cache, random tokens, the last position), `memory_allocated` held to
    the plan's per-rank bytes, and two decode steps at the last
    position."""
    from repro_torch.launch.specs import plan_config
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import per_rank_bytes
    cfg = qwen_cfg(QWEN_LAYERS)
    p = plan_config(cfg, "decode_32k", mesh)
    planned = per_rank_bytes(p.args, p.in_shardings)
    n_tensors = len(tensor_leaves(p.args))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = build_model(cfg)
    B, C = p.meta["batch"], p.meta["cache_len"]
    gen = torch.Generator().manual_seed(1)
    args = (model.init(0, device="cuda"),
            model.init_cache(B, C, device="cuda"),
            torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                          dtype=torch.int32).cuda(),
            torch.tensor(C - 1, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    check([(tuple(a.shape), a.dtype) for a in tensor_leaves(args)]
          == [(tuple(a.shape), a.dtype) for a in tensor_leaves(p.args)],
          "dryrun qwen decode: the arguments made are not the plan's")
    check(0 <= held - planned <= ALLOC_SLACK * n_tensors,
          f"dryrun qwen decode: {held} B allocated for a plan of "
          f"{planned} B in {n_tensors} tensors")
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):                    # the first, then one more
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = p.fn(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"dryrun qwen decode: logits {tuple(logits.shape)} not finite")
    del args, logits, cache
    torch.cuda.empty_cache()
    return [f"qwen1.5-110b decode_32k plan at {QWEN_LAYERS} layers, full "
            f"width, on a 1x1 DeviceMesh: {n_tensors} argument tensors, "
            f"plan {planned} B per rank, allocated {held} B (+{held - planned}"
            f" B of allocator rounding); a decode step of B={B} against a "
            f"{C}-position cache {ms[0]:.3f} ms, again {ms[1]:.3f} ms (host "
            f"clock to a sync), peak device allocation {peak} B [{smi}]"]


def check_padded_flash(gen) -> tuple[float, list]:
    """flash_attention against its plain version at qwen's padded prefill
    shape, as the padded prefill gives it (q's 64 heads, k and v's 8 real
    heads zero-padded to 16, bf16 causal), and on random values in every
    head of that shape and of the unpadded one."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    b, s, h, kv_pad, hd = QWEN_PAD_SHAPE
    kv = QWEN_SHAPE[3]
    q, k, v = attn_inputs(gen, b, s, h, kv, hd, torch.bfloat16)
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, kv_pad - kv)) for x in (k, v))
    ref = flash_attention_ref(q, k, v, causal=True)
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL[torch.bfloat16]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    check(out.dtype == torch.bfloat16 and bool(torch.isfinite(
        out.float()).all()) and bool((diff <= atol + rtol * ref.float().abs()
                                      ).all()),
          f"flash_attention at qwen's padded shape off by {err:.3e}")
    first = kv * (h // kv_pad)            # query heads on zero kv heads
    check(bool((out[:, :, first:] == 0).all()),
          "flash_attention: a query head on a zero kv head is not 0")
    rows = [f"flash_attention qwen padded (zero kv heads) B={b} S=T={s} "
            f"H={h} KV={kv_pad} ({kv} real) hd={hd} bf16 causal: max |err| "
            f"{err:.3e} (atol {atol}, rtol {rtol}); the {h - first} query "
            "heads on zero kv heads give 0"]
    more_err, more = check_flash_cases(gen, [
        (QWEN_PAD_SHAPE, torch.bfloat16, True, 0, "qwen padded, g=4"),
        (QWEN_SHAPE, torch.bfloat16, True, 0, "qwen, g=8")])
    return max(err, more_err), rows + more


def qwen_padded_serve(gen, smi: str) -> tuple[dict, list]:
    """flash_attention at qwen's padded and unpadded prefill shapes (held
    against its plain version, timed beside sdpa and the bound), qwen
    served at QWEN_LAYERS layers with and without pad_heads (2 launches a
    prefill each, counted from 0 just before), and the padded model's
    card against its CPU run."""
    from repro_torch.launch.specs import override_config
    err, rows = check_padded_flash(gen)
    timing = {}
    for label, (b, s, h, kv, hd) in (("padded", QWEN_PAD_SHAPE),
                                     ("unpadded", QWEN_SHAPE)):
        t = timing[label] = time_flash(gen, b, s, h, kv, hd)
        rows.append(
            f"flash_attention per call (qwen1.5-110b {label}: B={b} S=T={s} "
            f"H={h} KV={kv} hd={hd} bf16 causal): kernel "
            f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
            f"sdpa {t['library_ms'] * 1e3:.2f} us ({t['library_backend']}), "
            f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
            f"{t['bytes']} bytes, {t['ops']} flops) [{smi}]")
    launches = {}
    expect = {"flash_attention": QWEN_LAYERS, "ssd_scan": 0}
    for label, pad in (("padded", True), ("unpadded", False)):
        torch.cuda.empty_cache()
        counts, more = serve_phase(
            f"qwen1.5-110b {label}",
            override_config(qwen_cfg(QWEN_LAYERS), pad_heads=pad), expect)
        launches[label] = counts["flash_attention"]
        rows += more
    cfg = override_config(zoo_f32_config(QWEN_CHECK_LAYERS, "qwen1_5_110b"),
                          pad_heads=True)
    gaps, cache_gap, shapes, card_s, cpu_s = model_card_vs_cpu(
        cfg, QWEN_CHECK_PROMPT, 13)
    check(max(gaps) <= ZOO_RTOL and cache_gap <= ZOO_RTOL,
          f"qwen padded card vs CPU: logits gaps {gaps}, cache {cache_gap}")
    rows.append(f"card vs CPU, padded (H {cfg.pad_q_heads}, KV "
                f"{cfg.pad_kv_heads}; {QWEN_CHECK_LAYERS} layer, full width, "
                f"f32, {QWEN_CHECK_PROMPT} tokens, cache leaves {shapes}): "
                f"max |dlogits| / max |logits| prefill {gaps[0]:.3e}, decode "
                f"steps {gaps[1]:.3e} {gaps[2]:.3e}; worst cache leaf "
                f"{cache_gap:.3e} (tol {ZOO_RTOL}); card {card_s:.3f} s, CPU "
                f"{cpu_s:.3f} s")
    return {"err": err, "timing": timing, "launches": launches}, rows


def plan_round_batch(cfg, n: int, s: int, seed: int) -> dict:
    """One local step of one sequence a client, leaves (n, 1, 1, ...) on
    the card: tokens for a text config, `stub_batch` for the stub
    frontends."""
    if cfg.modality != "text":
        return stub_batch(cfg, n, 1, 1, s, seed)
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (n, 1, 1, s)).astype(np.int32)).cuda()}


def update_spec_round(mesh, smi: str) -> list:
    """`make_train_step(update_spec=)` as the train_4k plan builds it
    (`inner_update_constraint=True`) on the 1x1 mesh, run through the
    placed path (`launch.specs.run_placed`; its accumulator in blocks
    under the spec, each the whole leaf at extent 1): one sequential
    round (params from seed 0, G zero, client 1 inactive) bit-equal to
    the same round with update_spec=None; the first round's outputs wait
    on the host while the second runs."""
    from repro_torch.launch.specs import plan_config, run_placed
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import per_rank_bytes
    from repro_torch.tree import tree_leaves, tree_map
    cfg = qwen_cfg(UPDATE_LAYERS, fl_clients=UPDATE_N)
    p = plan_config(cfg, "train_4k", mesh, inner_update_constraint=True)
    planned = per_rank_bytes(p.args, p.in_shardings)
    free = torch.cuda.get_device_properties(0).total_memory - planned
    which = (f"qwen1.5-110b at {UPDATE_LAYERS} layer (the plan's own "
             f"{planned} B leave {free} B)")
    s = UPDATE_S
    if free < UPDATE_HEADROOM:
        from repro_torch.configs import get_config
        cfg = get_config("llava_next_34b").replace(
            n_layers=LLAVA_TRAIN_LAYERS, fl_clients=UPDATE_N)
        p = plan_config(cfg, "train_4k", mesh, inner_update_constraint=True)
        s = cfg.n_patches + LLAVA_TRAIN_TEXT
        which = (f"llava-next-34b at {LLAVA_TRAIN_LAYERS} layers (qwen's "
                 f"plan would leave {free} B)")
    def spec_step(*args):
        return run_placed(p, *args)
    model = build_model(cfg)
    n = p.meta["n_clients"]
    check(cfg.sequential_clients and n == UPDATE_N,
          f"update_spec round: plan meta {p.meta}")
    plain_step = make_train_step(model, cfg, n, 1)
    params = model.init(0, device="cuda")
    active = torch.tensor([True, False], device="cuda")
    eta = 0.05
    outs = []
    torch.cuda.reset_peak_memory_stats()
    for label, step in (("update_spec=None", plain_step),
                        ("update_spec from the plan", spec_step)):
        G = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                           device="cuda"), p.args[1])
        batch = plan_round_batch(cfg, n, s, 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, G, metrics = step(params, G, batch, active, eta)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        leaves = tree_leaves(new) + tree_leaves(G) + [metrics["loss"]]
        if outs:
            same = all(torch.equal(a, b.cuda())
                       for a, b in zip(leaves, outs[0][1]))
        else:
            same = None
            leaves = [t.cpu() for t in leaves]
        outs.append((label, leaves, ms))
        del new, G, metrics, batch
    peak = torch.cuda.max_memory_allocated()
    check(same, "update_spec round: not bit-equal to update_spec=None")
    check(bool(np.isfinite(float(outs[0][1][-1]))), "update_spec round: "
                                                   "loss not finite")
    return [f"make_train_step(update_spec=) from the train_4k plan "
            f"(inner_update_constraint) on a 1x1 DeviceMesh through "
            f"run_placed: {which}, N={n} "
            f"K=1, one sequence of {s} positions a client, client 1 "
            f"inactive: bit-equal to update_spec=None over "
            f"{len(outs[0][1])} tensors (params, G, loss "
            f"{float(outs[0][1][-1]):.6f}); rounds {outs[0][2]:.3f} and "
            f"{outs[1][2]:.3f} ms (host clock), peak device allocation "
            f"{peak} B [{smi}]"]


# granite-3-8b's train_4k plan (vmap mode, the zoo's tensor-parallel
# param specs) at PLACED_LAYERS layers of full width on the 1x1 mesh, its
# step run through launch.specs.run_placed on PLACED_N clients, K = 1 and
# one sequence of PLACED_S tokens each
PLACED_LAYERS, PLACED_N, PLACED_S = 2, 2, 128


def placed_train_step(mesh, smi: str) -> tuple[int, list]:
    """The train_4k plan's vmap step through `launch.specs.run_placed` on
    the 1x1 mesh (every block the whole leaf) against the plain
    `make_train_step` on the same params, G and batch: params, G and the
    loss bit-equal, and exactly one `mifa_aggregate` launch (the server
    step's, one a leaf table) in the placed call. Returns that count and
    the row."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import plan_config, run_placed
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.model import DTYPES
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("granite_3_8b").replace(n_layers=PLACED_LAYERS,
                                             fl_local_steps=1)
    p = plan_config(cfg, "train_4k", mesh)
    named = {a for s in tree_leaves(p.in_shardings[0]) for e in s.spec
             for a in rules._entry_axes(e)}
    check(not p.meta["sequential"] and named == {"model"},
          f"placed step: plan meta {p.meta}, param axes {named}")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    active = torch.tensor([True, False], device="cuda")
    outs, counts, times = [], [], []
    for label, step in (("plain", make_train_step(model, cfg, PLACED_N, 1)),
                        ("run_placed", lambda *a: run_placed(p, *a))):
        G = tree_map(lambda t: torch.zeros(
            (PLACED_N,) + tuple(t.shape), dtype=DTYPES[cfg.memory_dtype],
            device="cuda"), params)
        batch = plan_round_batch(cfg, PLACED_N, PLACED_S, 11)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        new, G, metrics = step(params, G, batch, active, 0.05)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        leaves = tree_leaves(new) + tree_leaves(G) + [metrics["loss"]]
        if outs:
            same = all(torch.equal(a, b) for a, b in zip(leaves, outs[0]))
        outs.append(leaves)
        del new, G, metrics, batch
    want = {k: int(k == "mifa_aggregate") for k in counts[1]}
    check(counts[1] == want and counts[0] == want,
          f"placed step: launches {counts}, expected {want} each")
    check(same, "placed step: run_placed is not bit-equal to the plain step")
    check(bool(torch.isfinite(outs[0][-1])), "placed step: loss not finite")
    n_leaves = len(tree_leaves(params))
    del outs
    return counts[1]["mifa_aggregate"], [
        f"granite-3-8b train_4k plan (vmap, tensor-parallel specs), "
        f"{PLACED_LAYERS} layers at full width, N={PLACED_N} K=1, one "
        f"sequence of {PLACED_S} tokens a client, client 1 inactive, on "
        f"the 1x1 DeviceMesh through run_placed: bit-equal to the plain "
        f"step over {2 * n_leaves + 1} tensors; mifa_aggregate launches "
        f"{counts[1]['mifa_aggregate']} (plain {counts[0]['mifa_aggregate']}"
        f"); {times[1]:.3f} ms against {times[0]:.3f} (host clock, one "
        f"call each) [{smi}]"]


def dryrun_phase(gen, smi: str) -> tuple[dict, list]:
    """The dry-run planner, head padding and update_spec= on the card
    (module constants above), in a gloo world of one rank with a 1x1
    `make_host_mesh(device="cuda")`, as `mesh_phase` builds it. Returns
    the padded flash_attention check's |err|, timing and launches; every
    row starts with "dryrun "."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    rows = [plan_every_pair()]
    check(not dist.is_initialized(), "dryrun phase: a process group is "
                                     "already initialised")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        rows += qwen_decode_plan(mesh, smi)
        out, more = qwen_padded_serve(gen, smi)
        rows += more
        torch.cuda.empty_cache()
        rows += update_spec_round(mesh, smi)
        torch.cuda.empty_cache()
        out["placed_launches"], more = placed_train_step(mesh, smi)
        rows += more
    finally:
        dist.destroy_process_group()
    rows.append(f"phase {time.perf_counter() - t0:.1f} s")
    return out, [f"dryrun {r}" for r in rows]


# --------------------------------------------------------------------------- #
# split matrix products: serving on each rank's blocks, two ranks on one card
# --------------------------------------------------------------------------- #

SPLIT_RANKS = 2
# (label, arch, layers, dtype), each at full width on a 1x2 mesh: granite's
# cache over its kv heads (KV 8 over 2 ranks) and its head whole (vocab
# 49155 is odd); olmoe's experts over `model` (32 of 64 a rank), its cache
# over its kv heads (16) and its vocab split, in bf16 and f32; qwen
# unpadded, with qkv bias and its vocab split
SPLIT_RUNS = (("granite-3-8b", "granite_3_8b", GRANITE_LAYERS, "bfloat16"),
              ("granite-3-8b", "granite_3_8b", 2, "float32"),
              ("olmoe-1b-7b", "olmoe_1b_7b", 4, "bfloat16"),
              ("olmoe-1b-7b", "olmoe_1b_7b", 2, "float32"),
              ("qwen1.5-110b", "qwen1_5_110b", QWEN_LAYERS, "bfloat16"))
# split against unsplit: tests/test_torch_models.py's bounds
SPLIT_TOL = {"bfloat16": (3e-2, 0.1), "float32": (2e-4, 2e-5)}
# routing under the split: every rank routes every token, so a rank's
# (E, C) tables are rank 0's bit for bit, but the router's input is the
# residual after split products summed in f32, so a token may route
# otherwise than in the unsplit run. A token is clean in a layer where
# nothing upstream of it diverged (`routing_agreement`): only rounding
# separates its router input in the two runs. In f32 a clean token may
# flip only where the unsplit run's gap between its k-th and (k+1)-th
# router probability is below MOE_TIE_GAP. In bf16 the rounding is the
# bf16 noise floor: the unsplit bf16 run against the same run in f32
# arithmetic (the bf16 weights upcast) moves a clean token's router
# probabilities by up to some fraction of each; the split may move them by
# at most SPLIT_FLOOR_X times that, and a clean token may flip only at a
# gap (of its k-th) below SPLIT_FLOOR_X times it. A router logit sums
# d_model products of bf16-rounded inputs and its rounding grows layer by
# layer, so no fixed fraction holds: 2^-7 of the k-th failed at olmoe's
# full width, layer 0 flipping at gaps up to 1.07e-2 (PERF.md).
# Logits and caches are held at the positions whose routing agreed in
# every layer, to SPLIT_TOL, or in bf16, where the unsplit run against f32
# is itself beyond it, to SPLIT_FLOOR_X times that gap (the rule of
# `split_train_reference`)
SPLIT_FLOOR_X = 2.0
# flash_attention at each rank's heads: (B, S, H, KV, hd), half the model's
SPLIT_SHAPES = {"granite-3-8b": (SERVE_B, SERVE_PROMPT, 16, 4, 128),
                "qwen1.5-110b": (SERVE_B, SERVE_PROMPT, 32, 4, 128),
                "olmoe-1b-7b": (SERVE_B, SERVE_PROMPT, 8, 8, 128)}
SPLIT_TIMEOUT_S = 420
SPLIT_DIR = ROOT / "build" / "split"
# the split world's queue (`split_phase`): a rank's CUDA blocks reach rank 0
# through it as CUDA IPC handles (`whole_on_rank0`); None outside the world
SPLIT_QUEUE = None


def whole_on_rank0(tree, specs, mesh):
    """On rank 0, the whole tree from every rank's blocks under `specs`
    (a tree of PartitionSpecs), assembled on the card; None on the other
    ranks. The other ranks send their blocks through SPLIT_QUEUE as CUDA
    IPC handles (both processes on one card: rank 0 reads them where they
    lie, where a gloo gather stages them through the host at about 0.4
    GB/s) and keep them until rank 0 has copied them (the barrier). For
    the checks only: no run computes with it."""
    import torch.distributed as dist
    from repro_torch.sharding.params import block_slices, whole_shape
    from repro_torch.tree import tree_map
    # in `tree_map` order, which rebuilds the tree below
    pairs = []
    tree_map(lambda b, s: pairs.append((b, s)), tree, specs)
    blocks, spec_list = [b for b, _ in pairs], [s for _, s in pairs]
    if dist.get_rank() != 0:
        SPLIT_QUEUE.put((mesh.get_coordinate(), blocks))
        dist.barrier()
        return None
    wholes = [torch.empty(whole_shape(tuple(b.shape), s, mesh),
                          dtype=b.dtype, device=b.device)
              for b, s in zip(blocks, spec_list)]
    parts = [(mesh.get_coordinate(), blocks)] + [
        SPLIT_QUEUE.get(timeout=SPLIT_TIMEOUT_S)
        for _ in range(dist.get_world_size() - 1)]
    for coord, bs in parts:
        for w, b, s in zip(wholes, bs, spec_list):
            w[block_slices(s, tuple(w.shape), mesh, coord)] = b
    torch.cuda.synchronize()
    del parts
    dist.barrier()
    it = iter(wholes)
    return tree_map(lambda _: next(it), tree)


def table_digests(calls) -> list:
    """A digest of each routing call's (E, C) table, for the every-rank
    comparison."""
    import hashlib
    return [hashlib.sha256(c[1].cpu().numpy().tobytes()).hexdigest()
            for c in calls]


def routing_view(call) -> tuple:
    """A `RoutingLog` call as `routing_agreement` reads it: each token's
    expert ids sorted (T,k), whether each of those assignments holds a
    slot (T,k), its k-th router probability and the gap to the (k+1)-th
    (T,), and the router probabilities (T,E)."""
    ids, _, gap, r = call
    ids, perm = torch.sort(ids, dim=-1)
    return (ids, torch.gather(r.kept(), 1, perm), r.top[:, ids.shape[1] - 1],
            gap, r.probs)


def routing_agreement(what: str, got: list, want: list, dtype: str,
                      forwards: list, floor: float | None = None,
                      hold: bool = True) -> tuple[dict, list]:
    """The split run's routing calls `got` against the unsplit run's
    `want` (`RoutingLog`, read through `routing_view`), call by call.
    `forwards`: (MoE layers, B, S) of each forward in order, its calls'
    tokens laid out (B, S); a decode step is a forward of S = 1 that
    follows its sequences' earlier ones.

    A token flips where its experts differ, and diverges where it flips
    or gains or loses a slot. A token is clean in a layer where no
    position of its sequence up to it diverged in an earlier layer (or an
    earlier forward): causal attention is all that carries a divergence
    to another token, and only rounding separates a clean token's router
    input in the two runs. With `hold`, a clean token's flip must be a
    near-tie of the unsplit run: in f32 a gap below MOE_TIE_GAP; in bf16
    a gap (of its k-th) below SPLIT_FLOOR_X times `floor`, the largest
    relative move of a clean token's router probabilities in the bf16
    noise floor (`bf16_floor`), which the split's own moves must stay
    under too. A flip of a token that is not clean follows from a
    divergence ("followed"). A token whose experts agree may gain or lose
    a slot only in a call with a flip. Returns (clean flips, followed
    flips, token-layers, share of the clean flips, their largest gap,
    tokens that moved slots, the largest relative move of a clean token's
    router probabilities, per layer (clean tokens, clean flips, largest
    gap, largest move), positions clean and agreed after every layer; and
    per forward (clean (B,S), agreed (B,S)) on the host)."""
    check(len(got) == len(want) == sum(f[0] for f in forwards),
          f"{what}: {len(got)} routing calls, the unsplit run "
          f"{len(want)}, expected {sum(f[0] for f in forwards)}")
    rel = dtype != "float32"
    limit = (None if not hold else SPLIT_FLOOR_X * floor if rel
             else MOE_TIE_GAP)
    flips = followed = moved = tokens = n_clean = n_agreed = 0
    worst = move = 0.0
    calls, masks, seq_dirty = iter(zip(got, want)), [], None
    per_layer: dict = {}
    for n_layers, B, S in forwards:
        if seq_dirty is None:
            seq_dirty = torch.zeros(B, dtype=torch.bool)
        div = torch.zeros((B, S), dtype=torch.bool)
        agreed = torch.ones((B, S), dtype=torch.bool)
        for layer in range(n_layers):
            (ids, kept, _, _, probs), (ids_r, kept_r, kth_r, gap_r,
                                       probs_r) = map(routing_view,
                                                      next(calls))
            dirty = (torch.cummax(div.int(), 1).values.bool()
                     | seq_dirty[:, None]).reshape(-1).to(ids.device)
            same = (ids == ids_r).all(-1)
            slots = (kept == kept_r).all(-1)
            first = ~same & ~dirty
            n = int(first.sum())
            gaps = (gap_r / kth_r if rel else gap_r)[first]
            moves = ((probs - probs_r).abs() / probs_r).amax(-1)[~dirty]
            g = float(gaps.max()) if n else 0.0
            mv = float(moves.max()) if moves.numel() else 0.0
            check(limit is None or (g < limit and (not rel or mv < limit)),
                  f"{what}: layer {layer}: {n} clean tokens flip, gaps "
                  f"{gaps.tolist()[:8]} (largest {g:.3e}), a clean token's "
                  f"router probabilities moved by up to {mv:.3e}: not all "
                  f"under the limit {limit}")
            m = int((same & ~slots).sum())
            check(m == 0 or not bool(same.all()),
                  f"{what}: layer {layer}: {m} tokens moved slots without a "
                  "flip")
            c, f, w, v = per_layer.get(layer, (0, 0, 0.0, 0.0))
            per_layer[layer] = (c + int(moves.numel()), f + n, max(w, g),
                                max(v, mv))
            worst, move = max(worst, g), max(move, mv)
            flips, moved = flips + n, moved + m
            followed += int((~same & dirty).sum())
            tokens += same.numel()
            ok = (same & slots).reshape(B, S).cpu()
            div |= ~ok
            agreed &= ok
        clean = ~(torch.cummax(div.int(), 1).values.bool()
                  | seq_dirty[:, None])
        seq_dirty = seq_dirty | div.any(1)
        masks.append((clean, agreed))
        n_clean += int(clean.sum())
        n_agreed += int(agreed.sum())
    return ({"flips": flips, "followed": followed, "tokens": tokens,
             "share": flips / tokens, "largest_gap": worst,
             "moved_slots": moved, "largest_move": move,
             "per_layer": [per_layer[k] for k in sorted(per_layer)],
             "clean": n_clean, "agreed": n_agreed, "limit": limit}, masks)


def bf16_floor(what: str, unsplit: list, f32: list, forwards: list
               ) -> tuple[dict, list]:
    """The bf16 noise floor of a run's routing: the unsplit bf16 run's
    routing calls `unsplit` against the same run's in f32 arithmetic
    (`f32`), measured by `routing_agreement` and not held. Its
    "largest_move" is the floor."""
    return routing_agreement(what, unsplit, f32, "bfloat16", forwards,
                             hold=False)


def split_forward_routing(what: str, model, split, mesh, batch,
                          dtype: str) -> dict:
    """Each rank's training forward (`loss_fn(split=)`) of one client's
    minibatch `batch` on its blocks of the params of seed 0, routing
    recorded: every rank's (E, C) tables must be rank 0's, and on rank 0
    the routing is held against the unsplit forward's
    (`routing_agreement`; in bf16 at the noise floor of the same forward
    in f32, `bf16_floor`). Returns rank 0's verdict ({} on the
    others)."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.sharding.params import take_tree
    from repro_torch.tree import tree_map
    params = model.init(0, device="cuda")
    with torch.no_grad():
        blocks = take_tree(params, split.param_specs, mesh, split=True)
        with RoutingLog() as got:
            model.loss_fn(blocks, batch, split=split)
        del blocks
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, table_digests(got.calls))
        check(all(p == parts[0] for p in parts) and parts[0],
              f"{what}: a rank's routing tables differ from rank 0's")
        out = {}
        if dist.get_rank() == 0:
            with RoutingLog() as want:
                model.loss_fn(params, batch)
            B, S = batch["tokens"].shape
            forwards = [(len(moe_layers(model.cfg)), B, S)]
            floor = None
            if dtype != "float32":
                f32 = build_model(model.cfg.replace(
                    param_dtype="float32", compute_dtype="float32"))
                with RoutingLog() as ref32:
                    f32.loss_fn(tree_map(lambda t: t.float(), params), batch)
                floor = bf16_floor(f"{what} (bf16 noise floor)", want.calls,
                                   ref32.calls, forwards)[0]
                del ref32
            out = routing_agreement(
                what, got.calls, want.calls, dtype, forwards,
                floor and floor["largest_move"])[0]
            out.update(calls=len(got.calls), floor=floor)
    del params, got
    torch.cuda.empty_cache()
    return out


def split_run(label: str, arch: str, n_layers: int, dtype: str, mesh
              ) -> dict:
    """One rank's part of a split run: `launch.steps.make_prefill_step`
    and `make_decode_step` on the mesh, this rank's blocks of the params
    drawn whole from seed 0 and cut (`sharding.params.take_tree`), a
    prefill of SERVE_B x SERVE_PROMPT tokens and SERVE_NEW greedy tokens
    from the logits gathered whole; then rank 0 runs the unsplit prefill
    and decode of the same params on the same tokens (the split run's
    greedy tokens fed back) and holds logits and caches to SPLIT_TOL. An
    MoE run records its routing on both sides (`RoutingLog`): every
    rank's tables must be rank 0's, and the outputs are held where the
    routing agreed (`split_reference`). Every count is set to 0 just
    before the split prefill and read just after it; decode launches
    none. Returns this run's numbers (rank 0: every rank's)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.params import take_tree, whole, whole_tree
    from repro_torch.tree import tree_leaves
    t_run = time.perf_counter()
    rank = dist.get_rank()
    cfg = get_config(arch).replace(n_layers=n_layers, param_dtype=dtype,
                                   compute_dtype=dtype)
    model = build_model(cfg)
    C = SERVE_PROMPT + SERVE_NEW
    step_p = make_prefill_step(model, mesh, batch=SERVE_B, cache_len=C)
    step_d = make_decode_step(model, mesh, batch=SERVE_B, cache_len=C)
    split = step_p.split
    lspec = rules.P(*rules.sanitize((rules.data_axes(mesh), rules.MODEL),
                                    (SERVE_B, cfg.vocab_size), mesh))
    batch, _ = prompt_batch(cfg, SERVE_B, SERVE_PROMPT,
                            torch.Generator().manual_seed(0), "cuda")
    params = take_tree(model.init(0, device="cuda"), split.param_specs,
                       mesh, split=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(SERVE_B, C, device="cuda", split=split)
    routes = RoutingLog()
    with routes:
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = step_p(params, cache, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_counts = read_counts()
        reset_counts()
        outs = [whole(logits, lspec, mesh, split=True)]
        toks, decode_s = [], 0.0
        for i in range(SERVE_NEW):
            toks.append(outs[-1].argmax(-1, keepdim=True).to(torch.int32))
            t0 = time.perf_counter()
            logits, cache = step_d(params, cache, toks[-1], SERVE_PROMPT + i)
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            outs.append(whole(logits, lspec, mesh, split=True))
        decode_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    mine = {"peak": peak, "prefill_counts": prefill_counts,
            "tables": table_digests(routes.calls),
            "decode_counts": decode_counts,
            "prefill_moved": dict(split.axis.moved),
            "decode_moved": {k: v / SERVE_NEW
                             for k, v in step_d.split.axis.moved.items()},
            "prefill_ms": prefill_s * 1e3,
            "decode_ms": decode_s / SERVE_NEW * 1e3,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params))}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    check(all(r["tables"] == ranks[0]["tables"] for r in ranks),
          f"split {label}: a rank's routing tables differ from rank 0's")
    got_cache = [t.cpu() for t in tree_leaves(
        whole_tree(cache, split.cache_specs, mesh, split=True))]
    layout = {i: (g.cache, g.heads, g.kv_cols, g.mlp)
              for i, g in split.segments.items()}
    del params, cache, logits
    torch.cuda.empty_cache()
    out = {"label": f"{label} {n_layers} layers {dtype}", "ranks": ranks,
           "layout": layout, "head_split": split.head,
           "embed_split": split.embed,
           "experts": sorted({g.experts for g in split.segments.values()})}
    if rank == 0:
        out.update(split_reference(model, batch, toks, outs, got_cache,
                                   dtype, C, routes.calls))
    del routes
    dist.barrier()
    out["wall_s"] = time.perf_counter() - t_run
    return out


def split_f32_run(model, params, batch, toks, C) -> tuple:
    """The unsplit prefill and decode of `params` (bf16) upcast to f32, in
    f32 arithmetic, on the split run's prompt and greedy tokens, routing
    recorded (`RoutingLog`): (its routing calls, its logits, its cache
    leaves on the host), the reference of the bf16 noise floor."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map
    f32 = build_model(model.cfg.replace(param_dtype="float32",
                                        compute_dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    cache = f32.init_cache(SERVE_B, C, device="cuda")
    with RoutingLog() as routes:
        logits, cache = f32.prefill(p32, batch, cache)
        outs = [logits]
        for i, tok in enumerate(toks):
            logits, cache = f32.decode_step(p32, tok, SERVE_PROMPT + i,
                                            cache)
            outs.append(logits)
    leaves = [t.cpu() for t in tree_leaves(cache)]
    del p32, cache
    torch.cuda.empty_cache()
    return routes.calls, outs, leaves


def split_reference(model, batch, toks, outs, got_cache, dtype, C,
                    got_routes) -> dict:
    """Rank 0's unsplit prefill and decode of the split run's params and
    tokens (module docstring of `split_run`): the largest gaps over the
    bound, the greedy tokens that differ and whether each is a near-tie
    (the split's token within the bound of the unsplit top logit). An MoE
    run's routing is held against the unsplit run's (`routing_agreement`),
    and logits, caches and greedy tokens are compared at the positions
    whose routing agreed in every layer."""
    from repro_torch.tree import tree_leaves
    rtol, atol = SPLIT_TOL[dtype]
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(SERVE_B, C, device="cuda")
    with RoutingLog() as want:
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        counts = read_counts()
        ref, decode_s = [logits], 0.0
        for i, tok in enumerate(toks):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, tok, SERVE_PROMPT + i,
                                              cache)
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            ref.append(logits)
    peak = torch.cuda.max_memory_allocated()
    # the positions (B, C) and the logits rows held: those whose routing
    # agreed in every layer (`routing_agreement`), the prefill's calls
    # first, then each decode step's; in bf16 the same gaps of the noise
    # floor (the unsplit bf16 run against it in f32) at its own
    B, S = SERVE_B, SERVE_PROMPT

    def held(masks) -> tuple:
        pos = torch.ones((B, C), dtype=torch.bool)
        rows = [torch.ones(B, dtype=torch.bool) for _ in outs]
        for i, (_, agreed) in enumerate(masks):
            pos[:, slice(0, S) if i == 0 else slice(S + i - 1, S + i)] = \
                agreed
            rows[i] = agreed[:, -1]
        return rows, pos

    def worst(a, b, keep) -> tuple[float, float]:
        a, b = a.float(), b.float().to(a.device)
        gap = torch.where(keep.to(a.device), (a - b).abs(),
                          torch.zeros((), device=a.device))
        return (float((gap / (atol + rtol * b.abs())).max()),
                float(gap.max()))

    def gaps(logits_a, logits_b, cache_a, cache_b, rows, pos) -> tuple:
        return (max(worst(a, b, k[:, None])
                    for a, b, k in zip(logits_a, logits_b, rows)),
                max(worst(a, b, pos[None, :, :, None, None])
                    for a, b in zip(cache_a, cache_b)))

    ref_cache = [t.cpu() for t in tree_leaves(cache)]
    rows_ok, pos_ok = held([])
    routing, allowed = None, (1.0, 1.0)
    if got_routes:
        n = len(moe_layers(model.cfg))
        forwards = [(n, B, S)] + [(n, B, 1)] * len(toks)
        floor = None
        if dtype != "float32":
            calls32, outs32, cache32 = split_f32_run(model, params, batch,
                                                     toks, C)
            floor, fmasks = bf16_floor(
                f"split {model.cfg.name} (bf16 noise floor)", want.calls,
                calls32, forwards)
            floor["gaps"] = gaps(ref, outs32, ref_cache, cache32,
                                 *held(fmasks))
            allowed = tuple(max(1.0, SPLIT_FLOOR_X * g[0])
                            for g in floor["gaps"])
            del outs32, cache32
        routing, masks = routing_agreement(
            f"split {model.cfg.name} {dtype}", got_routes, want.calls, dtype,
            forwards, floor and floor["largest_move"])
        routing.update(calls=len(got_routes), positions=B * (S + len(toks)),
                       floor=floor, allowed=allowed)
        rows_ok, pos_ok = held(masks)
    logit_gap, cache_gap = gaps(outs, ref, got_cache, ref_cache, rows_ok,
                                pos_ok)
    differ, ties = 0, 0
    for i, tok in enumerate(toks):
        r = ref[i].float()
        top = r.max(-1).values
        pick = r.gather(-1, tok.long()).squeeze(-1)
        for b in range(r.shape[0]):
            if int(tok[b]) != int(r[b].argmax()) and rows_ok[i][b]:
                differ += 1
                ties += bool(top[b] - pick[b] <= atol + rtol * top[b].abs())
    check(bool(all(torch.isfinite(x.float()).all() for x in outs)),
          "split: logits not finite")
    check(logit_gap[0] <= allowed[0] and cache_gap[0] <= allowed[1],
          f"split vs unsplit: logits {logit_gap}, cache {cache_gap} "
          f"(|gap| / bound, max |gap|; rtol {rtol}, atol {atol}; allowed "
          f"{allowed} of the bound)")
    check(differ == ties, f"split: {differ - ties} greedy tokens differ "
                          "from the unsplit run's beyond a near-tie")
    del params, cache
    torch.cuda.empty_cache()
    return {"logit_gap": logit_gap, "cache_gap": cache_gap,
            "tokens_differ": differ, "near_ties": ties, "routing": routing,
            "unsplit_peak": peak, "unsplit_counts": counts,
            "unsplit_prefill_ms": prefill_s * 1e3,
            "unsplit_decode_ms": decode_s / len(toks) * 1e3,
            "tokens": len(toks) * SERVE_B}


# split products in training: the MIFA train step on each rank's blocks in
# the same world, SPLIT_TRAIN_N clients of TRAIN_MB x TRAIN_SEQ tokens,
# SPLIT_TRAIN_ROUNDS rounds under SPLIT_TRAIN_MASKS. (label, arch, layers,
# dtype, sequential), each at full width on the 1x2 mesh with remat on (the
# configs' default): olmoe-1b-7b's vmap step in f32 at 1 layer, its experts
# over `model` (granite-3-8b's f32 step until olmoe's took its place: the
# f32 bound of the vmap step on the blocks is held by this one, granite's
# head whole by the bf16 one); granite-3-8b's vmap step in bf16 (its head
# whole: vocab 49155 is odd); gemma3-4b's (vocab 262144 split: the
# vocab-split cross-entropy at hd 256); granite's sequential step under its
# update constraint through the planner (K = 1). One round (two until the
# split federated runs below took its place: they chain rounds on the
# blocks, (ii) three across a chunk boundary), client 1 inactive in it
SPLIT_TRAIN_N, SPLIT_TRAIN_K, SPLIT_TRAIN_ROUNDS = 2, 2, 1
SPLIT_TRAIN_MASKS = ((True, False), (True, True))
SPLIT_TRAIN_RUNS = (
    ("olmoe-1b-7b", "olmoe_1b_7b", 1, "float32", False),
    ("granite-3-8b", "granite_3_8b", 2, "bfloat16", False),
    ("gemma3-4b", "gemma3_4b", 2, "bfloat16", False),
    ("granite-3-8b sequential", "granite_3_8b", 2, "bfloat16", True))


def split_train_cfg(arch: str, n_layers: int, dtype: str, sequential: bool):
    from repro_torch.configs import get_config
    return get_config(arch).replace(
        n_layers=n_layers, param_dtype=dtype, compute_dtype=dtype,
        memory_dtype=dtype, fl_clients=SPLIT_TRAIN_N,
        fl_local_steps=1 if sequential else SPLIT_TRAIN_K,
        sequential_clients=sequential, inner_update_constraint=sequential)


def split_train_inputs(cfg) -> list:
    """Each round's (batch on the card, active mask, eta): TokenBatcher
    streams, SPLIT_TRAIN_MASKS, inv_t(TRAIN_ETA0)."""
    from repro_torch.data import TokenBatcher
    from repro_torch.optim import inv_t
    batcher = TokenBatcher(n_clients=SPLIT_TRAIN_N, vocab=cfg.vocab_size,
                           seq_len=TRAIN_SEQ, batch_size=TRAIN_MB,
                           k_steps=cfg.fl_local_steps, seed=0)
    return [({"tokens": torch.from_numpy(
        batcher.sample_round(t)["tokens"]).cuda()},
        torch.tensor(SPLIT_TRAIN_MASKS[t], device="cuda"),
        inv_t(TRAIN_ETA0)(t + 1)) for t in range(SPLIT_TRAIN_ROUNDS)]


def split_train_zeros(cfg, specs, mesh, n_clients: int = SPLIT_TRAIN_N
                      ) -> dict:
    """Zeros of G in the memory dtype: this rank's blocks under `specs`
    (whole where `mesh` is None)."""
    from repro_torch.launch.specs import param_shapes
    from repro_torch.models.model import DTYPES
    from repro_torch.sharding.params import block_shape
    from repro_torch.tree import tree_map

    def zeros(t, s=None):
        shape = (n_clients,) + tuple(t.shape)
        if mesh is not None:
            shape = block_shape(shape, s, mesh, "cuda", split=True)
        return torch.zeros(shape, dtype=DTYPES[cfg.memory_dtype],
                           device="cuda")
    return tree_map(zeros, param_shapes(cfg), *([specs] if mesh else []))


def split_server_check(label: str, split, params, G, active,
                       eta) -> tuple[float, int]:
    """One server step on this rank's blocks as the split vmap step takes
    it (f32 updates on G's blocks, rounded to G's dtype as the step moves
    them; the params moved into G's param dims) through
    `mifa_aggregate_tree`, held against `mifa_aggregate_ref` on the same
    blocks (`check_server_step`). The updates are drawn from a seed, not
    trained: a local update and its move would take another round."""
    import torch.distributed as dist
    from repro_torch.kernels.ops import mifa_aggregate_tree
    from repro_torch.tree import tree_map
    gen = torch.Generator(device="cuda").manual_seed(dist.get_rank() + 11)
    updates = tree_map(lambda g: torch.randn(
        g.shape, generator=gen, device="cuda").to(g.dtype).float(), G)
    w = split.move_tree(tree_map(lambda x: x, params), split.param_specs,
                        split.step_specs)
    before: list = []
    tree_map(lambda g: before.append(g.clone()), G)
    G, w_new = mifa_aggregate_tree(G, updates, active, w, eta)
    torch.cuda.synchronize()
    return check_server_step(label, lambda j, _: before[j], G, updates,
                             active, w, w_new, eta)


def split_train_run(label: str, arch: str, n_layers: int, dtype: str,
                    sequential: bool, mesh) -> dict:
    """One rank's part of a split training run: the train step on the
    mesh (`launch.steps.make_train_step(model, cfg, n, k, mesh=)`; the
    sequential one planned through `launch.specs.plan_config`), this
    rank's blocks of the params drawn whole from seed 0 and cut, G zeros
    on its blocks, SPLIT_TRAIN_ROUNDS rounds, every count set to 0 just
    before each round and read just after it (`mifa_aggregate` once a
    round in vmap mode, no kernel in sequential mode); in the bf16 vmap
    run, one more server step held against its plain version on the same
    blocks. Then the params and G are gathered whole onto rank 0, every
    other rank frees its memory, and rank 0 runs the unsplit step alone
    (`split_train_reference`). Returns this run's numbers (rank 0: every
    rank's, and the comparison)."""
    import torch.distributed as dist
    from repro_torch.launch.specs import plan_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.sharding.params import take_tree
    from repro_torch.tree import tree_leaves, tree_map
    t_run = time.perf_counter()
    rank = dist.get_rank()
    cfg = split_train_cfg(arch, n_layers, dtype, sequential)
    model = build_model(cfg)
    if sequential:
        step = plan_config(cfg, "train_4k", mesh).fn
    else:
        step = make_train_step(model, cfg, SPLIT_TRAIN_N,
                               cfg.fl_local_steps, mesh=mesh)
    split = getattr(step, "split", None)
    check(split is not None, f"split train {label}: the step is not split")
    inputs = split_train_inputs(cfg)
    routing = {}
    if cfg.n_experts and dtype != "float32":
        routing = split_forward_routing(
            f"split train {label}", model, split, mesh,
            {"tokens": inputs[0][0]["tokens"][0, 0]}, dtype)
    params = take_tree(model.init(0, device="cuda"), split.param_specs,
                       mesh, split=True)
    G = split_train_zeros(cfg, split.state_specs, mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts, ms, moved, losses = [], [], [], []
    for batch, active, eta in inputs:
        before = dict(split.axis.moved)
        reset_counts()
        t0 = time.perf_counter()
        params, G, m = step(params, G, batch, active, eta)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        moved.append({k: split.axis.moved[k] - before[k] for k in before})
    peak = torch.cuda.max_memory_allocated()
    mine = {"peak": peak, "counts": counts, "ms": ms, "moved": moved,
            "losses": losses,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "g_bytes": sum(t.numel() * t.element_size()
                           for t in tree_leaves(G))}
    if not sequential and dtype == "bfloat16" and arch == "granite_3_8b":
        # on a copy of G: the kernel writes G's rows in place
        _, active, eta = inputs[-1]
        mine["server_check"] = split_server_check(
            f"split train {label} server step", split, params,
            tree_map(torch.clone, G), active, eta)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    got_p = whole_on_rank0(params, split.param_specs, mesh)
    got_G = whole_on_rank0(G, split.state_specs, mesh)
    del params, G
    torch.cuda.empty_cache()
    dist.barrier()
    out = {"label": f"{label} {n_layers} layer{'s' if n_layers > 1 else ''}"
                    f" {dtype}", "ranks": ranks, "routing": routing,
           "kv": {i: g.cache for i, g in split.segments.items()},
           "head_split": split.head, "embed_split": split.embed,
           "sequential": sequential}
    if rank == 0:
        out.update(split_train_reference(cfg, model, inputs, got_p, got_G,
                                         losses, dtype))
        del got_p, got_G
        torch.cuda.empty_cache()
    dist.barrier()
    out["wall_s"] = time.perf_counter() - t_run
    return out


def split_noise(got: list, noise: list, over: list) -> dict:
    """What a bf16 run's rows print of its noise floor: every leaf's gap
    and the noise floor's on it, the largest noise gap, and the leaves
    beyond the bound with their margin (2 x noise / gap: above 1 passes)."""
    return {"noise_gap": max(noise), "gaps": got, "noise": noise,
            "over": [(j, got[j], noise[j]) for j in over],
            "margin": min(2 * noise[j] / got[j] for j in over)}


def unsplit_train_rounds(cfg, model, inputs,
                         n_clients: int = SPLIT_TRAIN_N,
                         seed: int = 0) -> dict:
    """The unsplit train step of `cfg` over `inputs` from the split run's
    start (params from `seed`, G zeros): its params, G, losses, counts
    and ms a round, and its peak above what was allocated before it."""
    from repro_torch.launch.steps import make_train_step
    step = make_train_step(model, cfg, n_clients, cfg.fl_local_steps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed, device="cuda")
    G = split_train_zeros(cfg, None, None, n_clients)
    counts, ms, losses = [], [], []
    for batch, active, eta in inputs:
        reset_counts()
        t0 = time.perf_counter()
        params, G, m = step(params, G, batch, active, eta)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
    return {"params": params, "G": G, "losses": losses, "counts": counts,
            "ms": ms, "peak": torch.cuda.max_memory_allocated() - base}


def split_train_reference(cfg, model, inputs, got_p, got_G, losses,
                          dtype) -> dict:
    """Rank 0's unsplit train step on the split run's inputs, from the
    same params and G, against the split run gathered whole, leaf by leaf
    and the losses: f32 runs within the f32 training bound (`model_gap`);
    bf16 runs within SPLIT_TOL's bf16 bound, or, for a leaf beyond it,
    within twice the gap of the unsplit step's other mode on that leaf
    (vmap against sequential: the same round summed in another order; the
    bf16 noise floor, every leaf's printed with the margin). Its peak
    counts its own params and G but not the split run's outputs it holds
    (nor the init's generator state)."""
    from repro_torch.tree import tree_leaves
    ref = unsplit_train_rounds(cfg, model, inputs)
    rtol, atol = SPLIT_TOL[dtype]

    def gap(a, b) -> float:
        if dtype == "float32":
            return model_gap(a, b)
        a, b = a.float(), b.float()
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    def gaps(p, G, ls) -> list:
        return [gap(a, b) for a, b in zip(
            tree_leaves(p) + tree_leaves(G),
            tree_leaves(ref["params"]) + tree_leaves(ref["G"]))] + [
            gap(torch.tensor(ls), torch.tensor(ref["losses"]))]
    got = gaps(got_p, got_G, losses)
    out = {"leaf_gap": max(got[:-1]), "loss_gap": got[-1],
           "unsplit_losses": ref["losses"], "unsplit_peak": ref["peak"],
           "unsplit_counts": ref["counts"], "unsplit_ms": ref["ms"]}
    check(all(np.isfinite(losses)), f"split train: losses {losses}")
    over = [j for j, g in enumerate(got) if g > 1]
    if over and dtype != "float32":
        other = cfg.replace(sequential_clients=not cfg.sequential_clients,
                            inner_update_constraint=False)
        o = unsplit_train_rounds(other, model.__class__(other), inputs)
        noise = gaps(o["params"], o["G"], o["losses"])
        del o
        out.update(split_noise(got, noise, over))
        over = [j for j in over if got[j] > 2 * noise[j]]
    check(not over, f"split train vs unsplit: loss {got[-1]:.3e}, params "
                    f"and G leaves {[f'{x:.3e}' for x in got[:-1]]} of the "
                    f"bound; beyond it {out.get('over', over)}")
    del ref
    torch.cuda.empty_cache()
    return out


# split products in the federated round: `run_fl(engine="scan", mesh=1x2,
# cfg=)` at full width, each client's local update on the rank's blocks and
# the server step on G's or the bank rows' blocks, every round run eagerly
# (gloo cannot be captured); K = 2 local steps of 2 x 128 tokens, scan
# chunks of 2. (label, arch, layers, dtype, algorithm, N, cohort capacity,
# rounds): (i) olmoe-1b-7b MIFA(array) in f32 under Bernoulli availability
# (a round with an inactive client), its experts over `model` (granite-3-8b's
# until olmoe's took its place: the f32 bound of the round on the blocks is
# held by this one, granite's head whole by (ii) and (iv)); (ii)
# granite-3-8b BankedMIFA(DenseBank(mesh=, cfg=)) in bf16 and (iv)
# BankedMIFA(PagedDeviceBank), held whole on every rank, under
# SPLIT_FL_COHORTS; (iii) gemma3-4b MIFA(array) in bf16, the vocab split
# across the head. (ii) takes three rounds, so one run carries its state on
# the blocks across a chunk boundary and ends on a partial chunk
SPLIT_FL_K, SPLIT_FL_CHUNK, SPLIT_FL_ETA0 = 2, 2, 0.02
SPLIT_FL_RUNS = (
    ("(i) olmoe-1b-7b MIFA(array)", "olmoe_1b_7b", 1, "float32",
     "mifa_array", 2, None, 2),
    ("(ii) granite-3-8b BankedMIFA(DenseBank)", "granite_3_8b", 2,
     "bfloat16", "banked_dense", 4, 2, 3),
    ("(iii) gemma3-4b MIFA(array)", "gemma3_4b", 2, "bfloat16",
     "mifa_array", 2, None, 2),
    ("(iv) granite-3-8b BankedMIFA(PagedDeviceBank)", "granite_3_8b", 1,
     "bfloat16", "banked_paged", 4, 2, 2))
# the kernel each algorithm's server step launches, once a round a rank
SPLIT_FL_KERNEL = {"mifa_array": "mifa_aggregate",
                   "banked_dense": "bank_scatter",
                   "banked_paged": "paged_bank_scatter"}
# the dense runs' availability: Bernoulli (1.0, 0.6) of seed 1, which
# leaves client 1 out of rounds 1 and 2; the cohort runs' two of four
SPLIT_FL_PROBS, SPLIT_FL_SEED = (1.0, 0.6), 1
SPLIT_FL_COHORTS = ((True, False, True, False), (False, True, True, False),
                    (True, False, False, True))


class FixedMasks:
    """Availability of fixed masks, one a round (`.sample(t)`)."""

    def __init__(self, masks):
        self.masks = [np.asarray(m, bool) for m in masks]

    def sample(self, t: int) -> np.ndarray:
        return self.masks[t].copy()


def split_fl_setup(arch: str, n_layers: int, dtype: str, algo: str, n: int,
                   cap, rounds: int, mesh=None) -> tuple:
    """(cfg, model, run_fl's keywords but params, a fresh algorithm placed
    on `mesh`) of a split fl run."""
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.configs import get_config
    from repro_torch.core import MIFA
    from repro_torch.data import TokenBatcher
    from repro_torch.models import build_model
    from repro_torch.optim import inv_t
    cfg = get_config(arch).replace(
        n_layers=n_layers, param_dtype=dtype, compute_dtype=dtype,
        memory_dtype=dtype, fl_clients=n, fl_local_steps=SPLIT_FL_K)
    kw = dict(batcher=TokenBatcher(n_clients=n, vocab=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ, batch_size=TRAIN_MB,
                                   k_steps=SPLIT_FL_K, seed=0),
              participation=split_fl_part(cap),
              schedule=inv_t(SPLIT_FL_ETA0),
              n_rounds=rounds, engine="scan", scan_chunk=SPLIT_FL_CHUNK,
              cohort_capacity=cap, device="cuda")
    make = {"mifa_array": lambda: MIFA(memory="array", memory_dtype=dtype),
            "banked_dense": lambda: BankedMIFA(DenseBank(
                dtype=dtype, mesh=mesh, cfg=None if mesh is None else cfg,
                device="cuda")),
            "banked_paged": lambda: BankedMIFA(PagedDeviceBank(
                page_size=1, n_slots=n, dtype=dtype, device="cuda"))}[algo]
    return cfg, build_model(cfg), kw, make()


def split_fl_part(cap, s: int = 0, k: int = 0, rounds: int = 0):
    """A fresh availability process of a split fl run (`cap` None:
    Bernoulli SPLIT_FL_PROBS of seed SPLIT_FL_SEED + `s`; else
    SPLIT_FL_COHORTS, or for trial `k` of a fleet SPLIT_FLEET_COHORTS from
    k on). Bernoulli draws each round's mask from its own RNG, so every
    run of the same masks takes a process of its own."""
    from repro_torch.core import BernoulliParticipation
    if cap is None:
        return BernoulliParticipation(np.asarray(SPLIT_FL_PROBS),
                                      seed=SPLIT_FL_SEED + s)
    return FixedMasks(SPLIT_FLEET_COHORTS[k:k + rounds] if rounds
                      else SPLIT_FL_COHORTS)


class DriverLog:
    """While active, records every `ScanDriver` that `run_fl` builds."""

    def __enter__(self):
        from repro_torch.core import scan_engine
        self.drivers, self._base = [], scan_engine.ScanDriver
        log = self

        class Recorded(self._base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                log.drivers.append(self)
        scan_engine.ScanDriver = Recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.core import scan_engine
        scan_engine.ScanDriver = self._base


def split_fl_view(algo: str, bank, state, n: int) -> dict:
    """What a run compares besides its params, whole: MIFA's G, or a
    bank's first N rows (a paged bank's read back in f32) and G_sum."""
    from repro_torch.tree import tree_map
    if algo == "mifa_array":
        return {"G": state["G"]}
    if algo == "banked_paged":
        rows = bank.gather(state["bank"], np.arange(n))
    else:
        rows = tree_map(lambda r: r[:n], state["bank"]["rows"])
    return {"rows": rows, "g_sum": state["bank"]["g_sum"]}


def split_fl_whole(drv, algo, mesh) -> tuple:
    """(params, state) of a split run whole on rank 0 (`whole_on_rank0`;
    a paged bank is whole on every rank already), (None, None) on the
    other ranks: what `ScanDriver.whole_carry` gives, without gloo."""
    import torch.distributed as dist
    from repro_torch.bank.dense import DenseBank
    r = drv.r
    params = whole_on_rank0(r.params, drv.placement.param_specs, mesh)
    bank = getattr(algo, "bank", None)
    if bank is None:
        state = {"G": whole_on_rank0(r.state["G"], drv._state_specs["G"],
                                     mesh)}
    elif isinstance(bank, DenseBank):
        state = {"bank": {
            "rows": whole_on_rank0(r.state["bank"]["rows"], bank.row_specs,
                                   mesh),
            "g_sum": whole_on_rank0(r.state["bank"]["g_sum"],
                                    bank.sum_specs, mesh)}}
    else:
        state = r.state
    if dist.get_rank() != 0:
        return None, None
    return params, state


def split_fl_run(label: str, arch: str, n_layers: int, dtype: str,
                 algo: str, n: int, cap, rounds: int, mesh) -> dict:
    """One rank's part of a split federated run: `run_fl(engine="scan",
    mesh=, cfg=)` from params of seed 0, every count set to 0 just before
    it and read just after (its kernel once a round on each rank's blocks,
    nothing else), the rounds run eagerly and none replayed; for
    MIFA(array) one more server step on a copy of G's blocks against its
    plain version (`split_server_check`). Then the run is gathered whole
    onto rank 0, every other rank frees its memory, and rank 0 runs the
    unsplit run alone (`split_fl_reference`)."""
    import torch.distributed as dist
    from repro_torch.core import run_fl
    from repro_torch.tree import tree_leaves, tree_map
    t_run = time.perf_counter()
    rank = dist.get_rank()
    cfg, model, kw, fresh = split_fl_setup(arch, n_layers, dtype, algo, n,
                                           cap, rounds, mesh)
    routing = split_train_routing(f"split fl {label}", cfg, model, kw,
                                  mesh, dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with DriverLog() as log:
        reset_counts()
        t0 = time.perf_counter()
        params, hist = run_fl(model=model, algo=fresh,
                              params=model.init(0, device="cuda"),
                              mesh=mesh, cfg=cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    drv = log.drivers[-1]
    split = drv.placement.split
    check(split is not None and drv.eager,
          f"split fl {label}: the round is not split and eager")
    mine = {"peak": peak, "counts": counts, "ms": wall / rounds * 1e3,
            "moved": dict(split.axis.moved), "losses": hist.train_loss,
            "n_active": hist.n_active, "eager_rounds": drv.eager_rounds,
            "replays": drv.replays,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "state_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(drv.r.state)
                               if isinstance(t, torch.Tensor))}
    if algo == "mifa_array":
        active = torch.as_tensor(kw["participation"].sample(rounds - 1),
                                 device="cuda")
        mine["server_check"] = split_server_check(
            f"split fl {label} server step", split, params,
            tree_map(torch.clone, drv.r.state["G"]), active,
            kw["schedule"](rounds))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    t0 = time.perf_counter()
    got_p, state = split_fl_whole(drv, fresh, mesh)
    got = split_fl_view(algo, fresh.bank if algo != "mifa_array" else None,
                        state, n) if rank == 0 else None
    gather_s = time.perf_counter() - t0
    del params, state, drv, log
    # a ScanDriver's closures hold the run's carry in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out = {"label": f"{label} {n_layers} layer{'s' if n_layers > 1 else ''}"
                    f" {dtype}", "ranks": ranks, "algo": algo,
           "rounds": rounds, "head_split": split.head,
           "gather_s": gather_s, "routing": routing}
    if rank == 0:
        out.update(split_fl_reference(
            label, (arch, n_layers, dtype, algo, n, cap, rounds), got_p, got,
            hist))
        del got_p, got
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    out["wall_s"] = time.perf_counter() - t_run
    return out


def split_train_routing(what: str, cfg, model, kw, mesh, dtype: str
                        ) -> dict:
    """`split_forward_routing` of a bf16 federated run or fleet of an MoE
    config: round 0's minibatch of client 0 (its batcher's), on the blocks
    of the train step's split of `mesh`; {} without MoE or in f32, where
    the run's parity at the f32 bound already holds the routing (a flip
    beyond a near-tie moves an expert's update far past it)."""
    from repro_torch.sharding.tensor_parallel import train_split
    if not cfg.n_experts or dtype == "float32":
        return {}
    tokens = kw["batcher"].sample_round(0)["tokens"][0, 0]
    return split_forward_routing(
        what, model, train_split(cfg, mesh, cfg.fl_clients), mesh,
        {"tokens": torch.from_numpy(tokens).cuda()}, dtype)


def split_fl_reference(label: str, run: tuple, got_p, got, hist) -> dict:
    """Rank 0's unsplit `run_fl(engine="scan")` of the same run (params of
    seed 0, the same batches and masks) against the split run gathered
    whole, leaf by leaf (params, then G or the bank's rows and G_sum) and
    the losses: f32 within the f32 training bound (`model_gap`); bf16
    within SPLIT_TOL's bf16 bound or, for a leaf beyond it, within twice
    the gap of the unsplit MIFA train step's sequential mode on that leaf
    (the same rounds summed in another order, on masks drawn anew and
    checked equal to the run's; the rule of `split_train_reference`).
    n_active exact. Its peak counts its own params and state, not the
    split run's it holds."""
    from repro_torch.core import run_fl
    from repro_torch.tree import tree_leaves
    t_ref = time.perf_counter()
    arch, n_layers, dtype, algo, n, cap, rounds = run
    cfg, model, kw, fresh = split_fl_setup(*run)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with DriverLog() as log:
        reset_counts()
        t0 = time.perf_counter()
        ref_p, ref_h = run_fl(model=model, algo=fresh,
                              params=model.init(0, device="cuda"), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    drv = log.drivers[-1]
    ref = split_fl_view(algo, fresh.bank if algo != "mifa_array" else None,
                        drv.r.state, n)
    out = {"unsplit_peak": torch.cuda.max_memory_allocated() - base,
           "unsplit_counts": counts, "unsplit_replays": drv.replays,
           "unsplit_eager_rounds": drv.eager_rounds,
           "unsplit_ms": wall / rounds * 1e3,
           "unsplit_losses": ref_h.train_loss}
    # the captured round's memory pool, before the leaves are compared
    del drv, log
    gc.collect()
    torch.cuda.empty_cache()
    check(hist.n_active == ref_h.n_active and min(hist.n_active) < n,
          f"split fl {label}: n_active {hist.n_active}, unsplit "
          f"{ref_h.n_active}")
    check(all(np.isfinite(hist.train_loss)),
          f"split fl {label}: losses {hist.train_loss}")
    rtol, atol = SPLIT_TOL[dtype]

    def gap(a, b) -> float:
        if dtype == "float32":
            return model_gap(a, b)
        # in runs of 2^26 elements: a leaf of G is gigabytes in f32
        a, b, worst = a.reshape(-1), b.to(a.device).reshape(-1), 0.0
        for i in range(0, a.numel(), 1 << 26):
            x, y = a[i:i + (1 << 26)].float(), b[i:i + (1 << 26)].float()
            worst = max(worst, float(((x - y).abs() / (
                atol + rtol * y.abs())).max()))
        return worst

    def gaps(p, view, losses) -> list:
        return [gap(a, b) for a, b in zip(
            tree_leaves(p) + tree_leaves(view),
            tree_leaves(ref_p) + tree_leaves(ref))] + [
            gap(torch.tensor(losses), torch.tensor(ref_h.train_loss))]
    got_gaps = gaps(got_p, got, hist.train_loss)
    out.update(leaf_gap=max(got_gaps[:-1]), loss_gap=got_gaps[-1])
    over = [j for j, g in enumerate(got_gaps) if g > 1]
    if over and dtype != "float32":
        *seq, n_active = split_fl_sequential(cfg, model, kw, algo, n, rounds,
                                             split_fl_part(cap))
        check(n_active == hist.n_active,
              f"split fl {label}: the noise floor's n_active {n_active}, "
              f"the run's {hist.n_active}")
        noise = gaps(*seq)
        del seq
        out.update(split_noise(got_gaps, noise, over))
        over = [j for j in over if got_gaps[j] > 2 * noise[j]]
    check(not over, f"split fl {label} vs unsplit: loss {got_gaps[-1]:.3e}, "
                    f"leaves {[f'{x:.3e}' for x in got_gaps[:-1]]} of the "
                    f"bound; beyond it {out.get('over', over)}")
    del ref_p, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["reference_s"] = time.perf_counter() - t_ref
    return out


def split_fl_sequential(cfg, model, kw, algo: str, n: int,
                        rounds: int, part, seed: int = 0) -> tuple:
    """The same rounds through the unsplit MIFA train step in sequential
    mode (`make_train_step`, one client's update at a time), from params
    of `seed` and G = 0, the masks drawn from `part` (a process of its
    own, `split_fl_part`: one that a run has drawn from gives other
    masks): (params, the view a run of `algo` compares, the losses of the
    active clients, n_active a round)."""
    from repro_torch.tree import tree_map
    other = cfg.replace(sequential_clients=True)
    batcher = kw["batcher"]
    inputs = []
    for t in range(rounds):
        active = part.sample(t)
        inputs.append(({"tokens": torch.from_numpy(
            batcher.sample_round(t)["tokens"]).cuda()},
            torch.as_tensor(active, device="cuda"), kw["schedule"](t + 1)))
    seq = unsplit_train_rounds(other, model.__class__(other), inputs,
                               n_clients=n, seed=seed)
    G = seq["G"]
    view = ({"G": G} if algo == "mifa_array" else
            {"rows": G, "g_sum": tree_map(lambda g: g.float().sum(0), G)})
    return (seq["params"], view, seq["losses"],
            [float(a.sum()) for _, a, _ in inputs])


# the split fleets (`run_fleet(engine="scan", mesh=1x2, cfg=)`, every
# trial's local update on each rank's blocks under vmap over trials): (label,
# arch, layers, dtype, algorithm, clients, cohort capacity, rounds), all at
# full width with the depth cut to 1 layer, two trials of seeds
# SPLIT_FLEET_SEEDS: (i) olmoe-1b-7b MIFA(array) under Bernoulli
# availability (each trial's of seed SPLIT_FL_SEED + s: a round with an
# inactive client), its experts over `model` (granite-3-8b's until olmoe's
# took its place: granite's head whole is held by (ii) and (iii)); (ii)
# granite-3-8b BankedMIFA(DenseBank) and (iii) BankedMIFA(PagedDeviceBank),
# their rows whole on every rank, trial k taking SPLIT_FLEET_COHORTS from k
# on. A full-width olmoe fleet in f32 would not fit two ranks beside each
# other (about 35 GB a rank), so (i) is bf16.
# The state is whole on every rank (`fleet_axis_specs`), in bf16 (G, the
# rows, the pages; G_sum f32): (i)'s G is 2 trials x 2 clients x 0.60e9 x 2
# B = 4.8 GB a rank. Two ranks of (ii) at N = 4 did not fit the card beside
# each other: at C = 2 one rank held 30.7 GiB in the local update (about
# 4.2 GB a client on a rank's blocks, the head whole: granite's vocab is
# odd), at C = 1 36.2 GiB in the scatter (the rows 12.0 GB, G_sum, the
# delta sums and the new G_sum 4.8 GB each), so the cohort fleets take
# N = 2 (rows 7.2 GB), one client a round. A chunk's first state stays
# held (the runner's, until the chunk is written back) while its later
# rounds make new G_sums: at N = 2 a chunk of two rounds peaked at 32.96
# GiB a rank, 38.29 GiB reserved, 0.99 GiB of the card free; the fleets
# take chunks of SPLIT_FLEET_CHUNK rounds
SPLIT_FLEET_SEEDS, SPLIT_FLEET_CHUNK = (0, 1), 1
SPLIT_FLEET_RUNS = (
    ("(i) olmoe-1b-7b MIFA(array)", "olmoe_1b_7b", 1, "bfloat16",
     "mifa_array", 2, None, 2),
    ("(ii) granite-3-8b BankedMIFA(DenseBank)", "granite_3_8b", 1,
     "bfloat16", "banked_dense", 2, 1, 2),
    ("(iii) granite-3-8b BankedMIFA(PagedDeviceBank)", "granite_3_8b", 1,
     "bfloat16", "banked_paged", 2, 1, 2))
SPLIT_FLEET_COHORTS = ((True, False), (False, True), (True, False))
# the kernel each fleet's server step launches on every rank, and how many
# times a round: mifa_aggregate once a trial, a batched scatter once for all
SPLIT_FLEET_KERNEL = {
    "mifa_array": ("mifa_aggregate", len(SPLIT_FLEET_SEEDS)),
    "banked_dense": ("bank_scatter_batched", 1),
    "banked_paged": ("paged_bank_scatter_batched", 1)}


class FleetLog:
    """While active, records every `FleetRunner` and `FleetScanDriver`
    that `run_fleet` builds (the runner's placement kept as `placed_as`:
    `finalize` drops it once the params are whole)."""

    def __enter__(self):
        from repro_torch.fleet import executor
        self._base = executor.FleetRunner, executor.FleetScanDriver
        self.runners, self.drivers = [], []
        log = self

        class Runner(self._base[0]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.placed_as = self.placement
                log.runners.append(self)

        class Driver(self._base[1]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                log.drivers.append(self)
        executor.FleetRunner, executor.FleetScanDriver = Runner, Driver
        return self

    def __exit__(self, *exc):
        from repro_torch.fleet import executor
        executor.FleetRunner, executor.FleetScanDriver = self._base


def split_fleet_setup(arch: str, n_layers: int, dtype: str, algo: str,
                      n: int, cap, rounds: int) -> tuple:
    """(cfg, model, run_fleet's keywords but the algorithm, a fresh
    algorithm) of a split fleet: SPLIT_FLEET_SEEDS' trials, split_fl's
    batches and schedule."""
    cfg, model, kw, fresh = split_fl_setup(arch, n_layers, dtype, algo, n,
                                           cap, rounds)
    del kw["participation"]
    return cfg, model, {**kw, "trials": split_fleet_trials(cap, rounds),
                        "scan_chunk": SPLIT_FLEET_CHUNK}, fresh


def split_fleet_trials(cap, rounds: int) -> list:
    """A split fleet's trials, each of a SPLIT_FLEET_SEEDS seed with a
    fresh availability process of its own (`split_fl_part`)."""
    from repro_torch.fleet import Trial
    return [Trial(seed=s, participation=split_fl_part(cap, s, k, rounds))
            for k, s in enumerate(SPLIT_FLEET_SEEDS)]


def split_fleet_view(algo: str, bank, state, n: int) -> dict:
    """What a fleet compares besides its params, whole, (K, ...) leaves:
    G, or a bank's first N rows of every trial (a paged bank's read back)
    and G_sum."""
    from repro_torch.tree import tree_map
    if algo == "mifa_array":
        return {"G": state["G"]}
    if algo == "banked_paged":
        rows = bank.gather_fleet(state["bank"], np.tile(
            np.arange(n), (len(SPLIT_FLEET_SEEDS), 1)))
    else:
        rows = tree_map(lambda r: r[:, :n], state["bank"]["rows"])
    return {"rows": rows, "g_sum": state["bank"]["g_sum"]}


def split_fleet_run(label: str, arch: str, n_layers: int, dtype: str,
                    algo: str, n: int, cap, rounds: int, mesh) -> dict:
    """One rank's part of a split fleet: `run_fleet(engine="scan", mesh=,
    cfg=)`, every count set to 0 just before it and read just after (its
    kernel SPLIT_FLEET_KERNEL's times a round on the whole state, nothing
    else), the rounds run eagerly and none replayed; every rank returns the
    whole fleet and holds the whole state. For MIFA(array) one more server
    step of trial 0 on the whole G against its plain version. Then every
    rank but 0 frees its memory, and rank 0 runs the unsplit fleet alone
    (`split_fleet_reference`)."""
    import torch.distributed as dist
    from repro_torch.fleet import run_fleet
    from repro_torch.kernels.ops import mifa_aggregate_tree
    from repro_torch.tree import tree_index, tree_leaves, tree_map
    t_run = time.perf_counter()
    rank = dist.get_rank()
    cfg, model, kw, fresh = split_fleet_setup(arch, n_layers, dtype, algo,
                                              n, cap, rounds)
    routing = split_train_routing(f"split fleet {label}", cfg, model, kw,
                                  mesh, dtype)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FleetLog() as log:
        reset_counts()
        t0 = time.perf_counter()
        params, hist = run_fleet(model=model, algo=fresh, mesh=mesh,
                                 cfg=cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    runner, drv = log.runners[-1], log.drivers[-1]
    split = runner.placed_as.split
    check(split is not None and drv.eager,
          f"split fleet {label}: the rounds are not split and eager")
    stacked = hist.stacked()
    mine = {"peak": peak, "held": held, "counts": counts,
            "ms": wall / rounds * 1e3, "moved": dict(split.axis.moved),
            "losses": stacked["train_loss"].tolist(),
            "n_active": stacked["n_active"].tolist(),
            "eager_rounds": drv.eager_rounds, "replays": drv.replays,
            "block_bytes": sum(t.numel() * t.element_size() for t in
                               tree_leaves(runner.placed_as.place(params))),
            "state_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(runner.state)
                               if isinstance(t, torch.Tensor))}
    if algo == "mifa_array":
        # trial 0's next server step as the fleet takes it: whole params
        # and the whole G, updates drawn from a seed
        G = tree_map(torch.clone, tree_index(runner.state["G"], 0))
        active = torch.as_tensor(
            kw["trials"][0].participation.sample(rounds - 1), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(rank + 11)
        updates = tree_map(lambda g: torch.randn(
            g.shape, generator=gen, device="cuda").to(g.dtype).float(), G)
        w = tree_index(params, 0)
        before: list = []
        tree_map(lambda g: before.append(g.clone()), G)
        G, w_new = mifa_aggregate_tree(G, updates, active, w,
                                       kw["schedule"](rounds))
        torch.cuda.synchronize()
        mine["server_check"] = check_server_step(
            f"split fleet {label} server step", lambda j, _: before[j], G,
            updates, active, w, w_new, kw["schedule"](rounds))
        del G, updates, before, w, w_new
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    got = None
    if rank == 0:
        got = split_fleet_view(algo, getattr(fresh, "bank", None),
                               runner.state, n)
    del runner, drv, log, fresh
    if rank != 0:
        del params
    # a driver's closures hold the run's carry in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out = {"label": f"{label} {n_layers} layer{'s' if n_layers > 1 else ''}"
                    f" {dtype}", "ranks": ranks, "algo": algo,
           "rounds": rounds, "head_split": split.head, "routing": routing}
    if rank == 0:
        out.update(split_fleet_reference(
            label, (arch, n_layers, dtype, algo, n, cap, rounds), params,
            got, stacked))
        del params, got
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    out["wall_s"] = time.perf_counter() - t_run
    return out


def split_fleet_reference(label: str, run: tuple, got_p, got,
                          stacked) -> dict:
    """Rank 0's unsplit `run_fleet(engine="scan")` of the same fleet
    against the split fleet, leaf by leaf (params, then G or the bank's
    rows and G_sum, every trial) and the losses within SPLIT_TOL's bound
    of the run's dtype, n_active exact (a round with an inactive client in
    the dense fleet); in bf16 MIFA(array) a leaf beyond the bound within
    twice the gap of each trial's rounds through the unsplit train step's
    sequential mode (the rule of `split_fl_reference`, on masks drawn anew
    and checked equal to the trial's). Its peak counts its own params and
    state, not the split fleet's it holds."""
    from repro_torch.fleet import run_fleet
    from repro_torch.tree import tree_leaves
    t_ref = time.perf_counter()
    arch, n_layers, dtype, algo, n, cap, rounds = run
    cfg, model, kw, fresh = split_fleet_setup(*run)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FleetLog() as log:
        reset_counts()
        t0 = time.perf_counter()
        ref_p, ref_h = run_fleet(model=model, algo=fresh, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    runner, drv = log.runners[-1], log.drivers[-1]
    ref = split_fleet_view(algo, getattr(fresh, "bank", None), runner.state,
                           n)
    want = ref_h.stacked()
    out = {"unsplit_peak": torch.cuda.max_memory_allocated() - base,
           "unsplit_counts": counts, "unsplit_replays": drv.replays,
           "unsplit_eager_rounds": drv.eager_rounds,
           "unsplit_ms": wall / rounds * 1e3,
           "unsplit_losses": want["train_loss"].tolist()}
    # the captured round's memory pool, before the leaves are compared
    del runner, drv, log
    gc.collect()
    torch.cuda.empty_cache()
    check(np.array_equal(stacked["n_active"], want["n_active"])
          and (cap or stacked["n_active"].min() < n),
          f"split fleet {label}: n_active {stacked['n_active'].tolist()}, "
          f"unsplit {want['n_active'].tolist()}")
    check(np.isfinite(stacked["train_loss"]).all(),
          f"split fleet {label}: losses {stacked['train_loss'].tolist()}")
    rtol, atol = SPLIT_TOL[dtype]

    def gap(a, b) -> float:
        # in runs of 2^26 elements: a leaf of G is gigabytes in f32
        a, b, worst = a.reshape(-1), b.to(a.device).reshape(-1), 0.0
        for i in range(0, a.numel(), 1 << 26):
            x, y = a[i:i + (1 << 26)].float(), b[i:i + (1 << 26)].float()
            worst = max(worst, float(((x - y).abs() / (
                atol + rtol * y.abs())).max()))
        return worst

    gaps = [gap(a, b) for a, b in zip(
        tree_leaves(got_p) + tree_leaves(got),
        tree_leaves(ref_p) + tree_leaves(ref))]
    loss_gap = gap(torch.as_tensor(stacked["train_loss"]),
                   torch.as_tensor(want["train_loss"]))
    out.update(leaf_gap=max(gaps), loss_gap=loss_gap)
    over = [j for j, g in enumerate(gaps) if g > 1]
    if over and dtype != "float32" and algo == "mifa_array":
        # the bf16 noise floor of `split_fl_reference`: each trial's rounds
        # through the unsplit train step's sequential mode, its masks drawn
        # anew (the fleet above has drawn from `kw`'s)
        seqs = [split_fl_sequential(cfg, model, kw, algo, n, rounds,
                                    tr.participation, seed=tr.seed)
                for tr in split_fleet_trials(cap, rounds)]
        n_active = [s[3] for s in seqs]
        check(n_active == want["n_active"].tolist(),
              f"split fleet {label}: the noise floor's n_active {n_active}, "
              f"the fleet's {want['n_active'].tolist()}")
        noise = [gap(torch.stack(list(a)), b) for a, b in zip(
            zip(*[tree_leaves(s[0]) + tree_leaves(s[1]) for s in seqs]),
            tree_leaves(ref_p) + tree_leaves(ref))]
        del seqs
        out.update(split_noise(gaps, noise, over))
        over = [j for j in over if gaps[j] > 2 * noise[j]]
    check(not over and loss_gap <= 1,
          f"split fleet {label} vs unsplit: loss {loss_gap:.3e}, leaves "
          f"{[f'{x:.3e}' for x in gaps]} of the bound; beyond it "
          f"{out.get('over', over)}")
    del ref_p, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["reference_s"] = time.perf_counter() - t_ref
    return out


def split_rank(rank: int, out_dir: str, queue) -> None:
    """A rank of the split phase's world: two processes on cuda:0 that
    meet on a FileStore and talk gloo (which carries CUDA tensors through
    the host), a 1x2 `make_host_mesh(device="cuda")`, every SPLIT_RUNS,
    SPLIT_TRAIN_RUNS, SPLIT_FL_RUNS and SPLIT_FLEET_RUNS run; `queue`
    carries the checks' blocks to rank 0 (`whole_on_rank0`); rank 0 writes
    the results as JSON into `out_dir`. The rank ends when the phase's
    process does (PR_SET_PDEATHSIG), so the watchdog's exit ends it
    too."""
    import ctypes
    import signal
    from datetime import timedelta
    global SPLIT_QUEUE
    SPLIT_QUEUE = queue
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.kernels import backend
    from repro_torch.launch.mesh import make_host_mesh
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.cuda.set_device(0)
    backend.set_numerics()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"),
                                     SPLIT_RANKS),
        rank=rank, world_size=SPLIT_RANKS,
        timeout=timedelta(seconds=SPLIT_TIMEOUT_S))
    try:
        mesh = make_host_mesh(1, SPLIT_RANKS, device="cuda")
        runs = {"serve": [split_run(*run, mesh) for run in SPLIT_RUNS],
                "train": [split_train_run(*run, mesh)
                          for run in SPLIT_TRAIN_RUNS],
                "fl": [split_fl_run(*run, mesh) for run in SPLIT_FL_RUNS],
                "fleet": [split_fleet_run(*run, mesh)
                          for run in SPLIT_FLEET_RUNS]}
        if rank == 0:
            with open(os.path.join(out_dir, "split.json"), "w") as f:
                json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def split_routing_text(route: dict, dtype: str) -> str:
    """The routing verdict of `routing_agreement`, as row text."""
    layers = "; ".join(f"layer {i}: {c} clean, {f} flipping, largest gap "
                       f"{g:.3e}, move {m:.3e}"
                       for i, (c, f, g, m) in enumerate(route["per_layer"]))
    if dtype == "float32":
        limit = f"absolute gaps under {MOE_TIE_GAP}"
    else:
        fl = route["floor"]
        limit = (f"gaps of the k-th and moves under {route['limit']:.3e}, "
                 f"{SPLIT_FLOOR_X:g}x the bf16 noise floor: the unsplit bf16 "
                 f"run against itself in f32 moves a clean token's router "
                 f"probabilities by up to {fl['largest_move']:.3e} and flips "
                 f"{fl['flips']} clean token-layers at gaps up to "
                 f"{fl['largest_gap']:.3e}")
    return (f"{route['calls']} calls, every rank's (E, C) tables bit-equal "
            f"to rank 0's; clean tokens routed otherwise than in the "
            f"unsplit run {route['flips']} of {route['tokens']} token-layers "
            f"({route['share']:.3e}), largest gap {route['largest_gap']:.3e},"
            f" a clean token's router probabilities moved by up to "
            f"{route['largest_move']:.3e} ({limit}); by layer: {layers}; "
            f"flips downstream of a divergence {route['followed']}; tokens "
            f"that gained or lost a slot beside them {route['moved_slots']}")


def split_routing_row(what: str, route: dict, dtype: str) -> str:
    """The row of a training forward's routing check
    (`split_forward_routing`)."""
    return (f"{what} routing of one client's minibatch on the blocks of "
            f"the params of seed 0: {split_routing_text(route, dtype)}")


def split_noise_note(run: dict) -> str:
    """The leaves beyond the bf16 bound and the unsplit step's own other
    mode's gap on each, the smallest margin, and every leaf's pair
    (`split_noise`), or nothing."""
    if "over" not in run:
        return ""
    return (" (beyond it, (leaf, split, the unsplit step's other mode "
            "against it): " + ", ".join(
                f"({j}, {g:.3f}, {n:.3f})" for j, g, n in run["over"])
            + f"; margin {run['margin']:.3f} (2 x noise / split, the least "
            "of them); every leaf (split, noise): " + ", ".join(
                f"({g:.3f}, {n:.3f})" for g, n in zip(run["gaps"],
                                                      run["noise"])) + ")")


def split_train_rows(runs: list, smi: str) -> tuple[dict, list, float]:
    """The split training runs' checks and rows: on every rank and in the
    unsplit run, `mifa_aggregate` exactly once a round in vmap mode and no
    kernel in sequential mode. Returns (each run's launches a rank over
    its rounds, rows, the server step check's max |dw|)."""
    launches, rows, err = {}, [], 0.0
    for run, spec in zip(runs, SPLIT_TRAIN_RUNS):
        sequential = spec[4]
        label = run["label"]
        want = 0 if sequential else 1
        for c in [c for r in run["ranks"] for c in r["counts"]] + run[
                "unsplit_counts"]:
            others = {k: v for k, v in c.items() if k != "mifa_aggregate"}
            check(c["mifa_aggregate"] == want and not any(others.values()),
                  f"split train {label}: launches a round {c}, expected "
                  f"mifa_aggregate {want} and nothing else")
        launches[label] = [sum(c["mifa_aggregate"] for c in r["counts"])
                           for r in run["ranks"]]
        r0 = run["ranks"][0]
        kv = sorted(set(run["kv"].values()))
        peaks = ", ".join(f"rank {i} {r['peak']} B (params "
                          f"{r['param_bytes']} B, G {r['g_bytes']} B)"
                          for i, r in enumerate(run["ranks"]))
        rows += [
            f"train {label} on 1x{SPLIT_RANKS}, "
            f"{'sequential' if sequential else 'vmap'} (kv {kv}, head "
            f"{'vocab-split' if run['head_split'] else 'whole'}): losses "
            f"{[round(x, 6) for x in r0['losses']]}, unsplit "
            f"{[round(x, 6) for x in run['unsplit_losses']]}; params and G "
            f"vs unsplit {run['leaf_gap']:.3f} of the bound, loss "
            f"{run['loss_gap']:.3f}{split_noise_note(run)}; mifa_aggregate "
            f"launches per rank over {SPLIT_TRAIN_ROUNDS} rounds "
            f"{launches[label]}",
            f"train {label} peak allocation: split {peaks}; unsplit "
            f"{run['unsplit_peak']} B; {smi}",
            f"train {label} bytes rank 0 moved a round: {r0['moved']}",
            f"train {label} host-staged through gloo (not a speed figure): "
            f"ms a round {[round(x, 3) for x in r0['ms']]}, unsplit "
            f"{[round(x, 3) for x in run['unsplit_ms']]}; the run with its "
            f"checks {run['wall_s']:.1f} s (host clock); {smi}"]
        if run["routing"]:
            rows.append(split_routing_row(f"train {label}", run["routing"],
                                          spec[3]))
        if "server_check" in r0:
            worst, elements = r0["server_check"]
            err = max(err, worst)
            rows.append(f"train {label} server step on each rank's blocks "
                        f"of G: mifa_aggregate against mifa_aggregate_ref, "
                        f"{elements} elements of G bit-equal on rank 0, "
                        f"max |dw| {worst:.3e}")
    return launches, rows, err


def split_fl_rows(runs: list, smi: str) -> tuple[dict, list, float]:
    """The split federated runs' checks and rows: on every rank its
    kernel exactly once a round and nothing else, every round eager and
    none replayed; the unsplit run's kernel once a replay plus once in
    the warm-up before its capture. Returns (each kernel's launches a rank
    over each run's rounds, rows, the server step check's max |dw|)."""
    launches, rows, err = {}, [], 0.0
    for run, spec in zip(runs, SPLIT_FL_RUNS):
        label, rounds = run["label"], run["rounds"]
        kernel = SPLIT_FL_KERNEL[run["algo"]]
        for r in run["ranks"]:
            others = {k: v for k, v in r["counts"].items() if k != kernel}
            check(r["counts"][kernel] == rounds
                  and not any(others.values()),
                  f"split fl {label}: launches {r['counts']}, expected "
                  f"{kernel} {rounds} and nothing else")
            check(r["eager_rounds"] == rounds and r["replays"] == 0,
                  f"split fl {label}: eager rounds {r['eager_rounds']}, "
                  f"replays {r['replays']}")
        uc = run["unsplit_counts"]
        check(uc[kernel] == rounds + 1
              and not any(v for k, v in uc.items() if k != kernel)
              and run["unsplit_replays"] == rounds
              and run["unsplit_eager_rounds"] == 0,
              f"split fl {label}: unsplit launches {uc}, replays "
              f"{run['unsplit_replays']}")
        launches.setdefault(kernel, {})[label] = [
            r["counts"][kernel] for r in run["ranks"]]
        r0 = run["ranks"][0]
        peaks = ", ".join(f"rank {i} {r['peak']} B (params "
                          f"{r['param_bytes']} B, state {r['state_bytes']} "
                          f"B)" for i, r in enumerate(run["ranks"]))
        # a paged bank is whole on every rank, so only the split products'
        # runs must peak below the unsplit run
        check(run["algo"] == "banked_paged" or all(
            r["peak"] < run["unsplit_peak"] for r in run["ranks"]),
              f"split fl {label}: a rank's peak is not below the unsplit "
              f"run's: {peaks}; unsplit {run['unsplit_peak']} B")
        what = "G" if run["algo"] == "mifa_array" else "bank rows and G_sum"
        rows += [
            f"fl {label} on 1x{SPLIT_RANKS} (run_fl engine=scan, "
            f"mesh=, cfg=; head "
            f"{'vocab-split' if run['head_split'] else 'whole'}; "
            f"{spec[5]} clients, K={SPLIT_FL_K}, {rounds} rounds in chunks "
            f"of {SPLIT_FL_CHUNK}, n_active {r0['n_active']}): losses "
            f"{[round(x, 6) for x in r0['losses']]}, unsplit "
            f"{[round(x, 6) for x in run['unsplit_losses']]}; params and "
            f"{what} vs unsplit {run['leaf_gap']:.3f} of the bound, loss "
            f"{run['loss_gap']:.3f}{split_noise_note(run)}; {kernel} "
            f"launches per rank {launches[kernel][label]}; eager rounds "
            f"per rank {[r['eager_rounds'] for r in run['ranks']]}, replays "
            f"{[r['replays'] for r in run['ranks']]} (unsplit run: replays "
            f"{run['unsplit_replays']}, {kernel} {uc[kernel]} with its "
            f"warm-up)",
            f"fl {label} peak allocation: split {peaks}; unsplit "
            f"{run['unsplit_peak']} B; {smi}",
            f"fl {label} bytes rank 0 moved over {rounds} rounds: "
            f"{r0['moved']}",
            f"fl {label} host-staged through gloo (not a speed figure): ms "
            f"a round {r0['ms']:.3f} (the run's wall clock over its rounds),"
            f" unsplit {run['unsplit_ms']:.3f}; the run with its checks "
            f"{run['wall_s']:.1f} s (host clock), of which the gather onto "
            f"rank 0 {run['gather_s']:.1f} s and the unsplit run with the "
            f"comparison {run['reference_s']:.1f} s; {smi}"]
        if run["routing"]:
            rows.append(split_routing_row(f"fl {label}", run["routing"],
                                          spec[3]))
        if "server_check" in r0:
            worst, elements = r0["server_check"]
            err = max(err, worst)
            rows.append(f"fl {label} server step on each rank's blocks of G:"
                        f" mifa_aggregate against mifa_aggregate_ref, "
                        f"{elements} elements of G bit-equal on rank 0, max "
                        f"|dw| {worst:.3e}")
    return launches, rows, err


def split_fleet_rows(runs: list, smi: str) -> tuple[dict, list, float]:
    """The split fleets' checks and rows: on every rank its kernel exactly
    SPLIT_FLEET_KERNEL's times a round and nothing else, every round eager
    and none replayed, each rank's peak below the unsplit fleet's; the
    unsplit fleet's kernel as often a replay plus once more in the warm-up
    before its capture. Returns (each kernel's launches a rank over each
    fleet's rounds, rows, the server step check's max |dw|)."""
    launches, rows, err = {}, [], 0.0
    for run, spec in zip(runs, SPLIT_FLEET_RUNS):
        label, rounds = run["label"], run["rounds"]
        kernel, per_round = SPLIT_FLEET_KERNEL[run["algo"]]
        for r in run["ranks"]:
            others = {k: v for k, v in r["counts"].items() if k != kernel}
            check(r["counts"][kernel] == per_round * rounds
                  and not any(others.values()),
                  f"split fleet {label}: launches {r['counts']}, expected "
                  f"{kernel} {per_round * rounds} and nothing else")
            check(r["eager_rounds"] == rounds and r["replays"] == 0,
                  f"split fleet {label}: eager rounds {r['eager_rounds']}, "
                  f"replays {r['replays']}")
        uc = run["unsplit_counts"]
        check(uc[kernel] == per_round * (rounds + 1)
              and not any(v for k, v in uc.items() if k != kernel)
              and run["unsplit_replays"] == rounds
              and run["unsplit_eager_rounds"] == 0,
              f"split fleet {label}: unsplit launches {uc}, replays "
              f"{run['unsplit_replays']}")
        launches.setdefault(kernel, {})[label] = [
            r["counts"][kernel] for r in run["ranks"]]
        r0 = run["ranks"][0]
        peaks = ", ".join(f"rank {i} {r['peak']} B (params' blocks "
                          f"{r['block_bytes']} B, state {r['state_bytes']} "
                          f"B, {r['held']} B held before the fleet)"
                          for i, r in enumerate(run["ranks"]))
        check(all(r["peak"] < run["unsplit_peak"] for r in run["ranks"]),
              f"split fleet {label}: a rank's peak is not below the unsplit "
              f"fleet's: {peaks}; unsplit {run['unsplit_peak']} B")
        what = ("G" if run["algo"] == "mifa_array"
                else "bank rows and G_sum")
        rows += [
            f"fleet {label} on 1x{SPLIT_RANKS} (run_fleet engine=scan, "
            f"mesh=, cfg=; {len(SPLIT_FLEET_SEEDS)} trials of seeds "
            f"{list(SPLIT_FLEET_SEEDS)} under vmap; head "
            f"{'vocab-split' if run['head_split'] else 'whole'}; {spec[5]} "
            f"clients, K={SPLIT_FL_K}, {rounds} rounds in chunks of "
            f"{SPLIT_FLEET_CHUNK}, n_active {r0['n_active']}): losses "
            f"{[[round(x, 6) for x in t] for t in r0['losses']]}, unsplit "
            f"{[[round(x, 6) for x in t] for t in run['unsplit_losses']]}; "
            f"params and {what} vs unsplit {run['leaf_gap']:.3f} of the "
            f"bound, loss {run['loss_gap']:.3f}{split_noise_note(run)}; "
            f"{kernel} launches per rank "
            f"{launches[kernel][label]} on the whole state; eager rounds "
            f"per rank {[r['eager_rounds'] for r in run['ranks']]}, replays "
            f"{[r['replays'] for r in run['ranks']]} (unsplit fleet: "
            f"replays {run['unsplit_replays']}, {kernel} {uc[kernel]} with "
            f"its warm-up)",
            f"fleet {label} peak allocation: split {peaks}; unsplit "
            f"{run['unsplit_peak']} B; {smi}",
            f"fleet {label} bytes rank 0 moved over {rounds} rounds: "
            f"{r0['moved']}",
            f"fleet {label} host-staged through gloo (not a speed figure): "
            f"ms a round {r0['ms']:.3f} (the run's wall clock over its "
            f"rounds, the final gather of the params included), unsplit "
            f"{run['unsplit_ms']:.3f}; the fleet with its checks "
            f"{run['wall_s']:.1f} s (host clock), of which the unsplit "
            f"fleet with the comparison {run['reference_s']:.1f} s; {smi}"]
        if run["routing"]:
            rows.append(split_routing_row(f"fleet {label}", run["routing"],
                                          spec[3]))
        if "server_check" in r0:
            worst, elements = r0["server_check"]
            err = max(err, worst)
            rows.append(f"fleet {label} server step of trial 0 on the whole "
                        f"G: mifa_aggregate against mifa_aggregate_ref, "
                        f"{elements} elements of G bit-equal on rank 0, max "
                        f"|dw| {worst:.3e}")
    return launches, rows, err


def split_phase(gen, smi: str) -> tuple[dict, list]:
    """Split products (`sharding.tensor_parallel`): flash_attention
    against its plain version and timed beside sdpa at each rank's heads
    (SPLIT_SHAPES), then a world of SPLIT_RANKS processes on this card
    (`split_rank`, the kernels already built) serving every SPLIT_RUNS run
    on its blocks, training every SPLIT_TRAIN_RUNS step and running every
    SPLIT_FL_RUNS federated run and every SPLIT_FLEET_RUNS fleet, each
    held against the unsplit run. Returns the check's |err|, the timing
    and each run's per-rank launches; every row starts with "split "."""
    import torch.multiprocessing as mp
    t_start = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    err, rows = check_flash_cases(gen, [
        (shape, dt, True, 0, f"{name} per rank{' f32' if dt == f32 else ''}")
        for name, shape in SPLIT_SHAPES.items() for dt in (bf, f32)])
    timing = {}
    for name, shape in SPLIT_SHAPES.items():
        t = timing[name] = time_flash(gen, *shape)
        rows.append(
            f"flash_attention {name} per rank B={shape[0]} S=T={shape[1]} "
            f"H={shape[2]} KV={shape[3]} hd={shape[4]} bf16 causal: kernel "
            f"{t['ms'] * 1e3:.2f} us, sdpa ({t['library_backend']}) "
            f"{t['library_ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f}"
            f" us, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); "
            f"{smi}")
    torch.cuda.empty_cache()
    # what this process keeps on the card beside the world's two ranks
    rows.append(f"this process holds {torch.cuda.memory_allocated()} B "
                f"allocated, {torch.cuda.memory_reserved()} B reserved "
                f"while the world runs; {smi}")
    shutil.rmtree(SPLIT_DIR, ignore_errors=True)
    SPLIT_DIR.mkdir(parents=True)
    queue = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(split_rank, args=(str(SPLIT_DIR), queue),
                             nprocs=SPLIT_RANKS, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + SPLIT_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() < deadline,
                  f"split phase: the world ran past {SPLIT_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        queue.close()
    runs = json.loads((SPLIT_DIR / "split.json").read_text())
    shutil.rmtree(SPLIT_DIR, ignore_errors=True)
    train_launches, train_rows, server_err = split_train_rows(
        runs["train"], smi)
    fl_launches, fl_rows, fl_err = split_fl_rows(runs["fl"], smi)
    fleet_launches, fleet_rows, fleet_err = split_fleet_rows(runs["fleet"],
                                                            smi)
    server_err = max(server_err, fl_err, fleet_err)
    runs = runs["serve"]
    launches = {}
    for run, spec in zip(runs, SPLIT_RUNS):
        n_layers = spec[2]
        label = run["label"]
        want = {k: 0 for k in run["ranks"][0]["prefill_counts"]}
        for r in run["ranks"]:
            check(r["prefill_counts"] == {**want, "flash_attention":
                                          n_layers}
                  and r["decode_counts"] == want,
                  f"split {label}: launches prefill {r['prefill_counts']}, "
                  f"decode {r['decode_counts']}")
        check(run["unsplit_counts"]["flash_attention"] == n_layers,
              f"split {label}: unsplit launches {run['unsplit_counts']}")
        launches[label] = [r["prefill_counts"]["flash_attention"]
                           for r in run["ranks"]]
        peaks = ", ".join(f"rank {i} {r['peak']} B (params "
                          f"{r['param_bytes']} B)"
                          for i, r in enumerate(run["ranks"]))
        r0 = run["ranks"][0]
        route = run["routing"]
        if route:
            floor = ""
            if route["floor"]:
                (fl, _), (fc, _) = route["floor"]["gaps"]
                floor = (f"; the noise floor's logits {fl:.3f} and caches "
                         f"{fc:.3f} of the bound at its own agreed "
                         f"positions, so allowed {route['allowed'][0]:.3f} "
                         f"and {route['allowed'][1]:.3f}")
            rows.append(
                f"{label} routing: {split_routing_text(route, spec[3])}; "
                f"logits and caches held at the {route['agreed']} of "
                f"{route['positions']} positions whose routing agreed in "
                f"every layer{floor}")
        rows += [
            f"{label} on 1x{SPLIT_RANKS} (cache layouts "
            f"{sorted(set(v[0] for v in run['layout'].values()))}, "
            f"experts split {run['experts']}, head "
            f"{'vocab-split' if run['head_split'] else 'whole'}): logits "
            f"vs unsplit max |gap| {run['logit_gap'][1]:.3e} "
            f"({run['logit_gap'][0]:.3f} of the bound), cache "
            f"{run['cache_gap'][1]:.3e} ({run['cache_gap'][0]:.3f}); "
            f"greedy tokens differing {run['tokens_differ']} of "
            f"{run['tokens']} (near-ties {run['near_ties']}); "
            f"flash_attention launches a prefill per rank "
            f"{launches[label]}, decode 0",
            f"{label} peak allocation: split {peaks}; unsplit rank 0 "
            f"{run['unsplit_peak']} B; {smi}",
            f"{label} collectives a rank: prefill {r0['prefill_moved']} B, "
            f"decode step {r0['decode_moved']} B",
            f"{label} host-staged through gloo (not a speed figure): "
            f"prefill {r0['prefill_ms']:.3f} ms, decode "
            f"{r0['decode_ms']:.3f} ms/step; unsplit prefill "
            f"{run['unsplit_prefill_ms']:.3f} ms, decode "
            f"{run['unsplit_decode_ms']:.3f} ms/step; the run with its "
            f"checks {run['wall_s']:.1f} s (host clock); {smi}"]
    rows += train_rows + fl_rows + fleet_rows
    rows.append(f"phase {time.perf_counter() - t_start:.1f} s")
    return ({"err": err, "timing": timing, "launches": launches,
             "train_launches": train_launches, "fl_launches": fl_launches,
             "fleet_launches": fleet_launches, "server_err": server_err},
            [f"split {r}" for r in rows])


# a run still going after this many seconds prints every thread's stack
# to stderr and exits (the whole script took 580 s on an H100 host in its
# last full run, and hosts have run phases up to 1.7x slower), so a stall
# shows where and fails inside the 1200 s limit
WATCHDOG_S = 1100
T_START = time.perf_counter()


def phase_start(phase: str) -> None:
    """Print, as it happens, the seconds since the script began at which
    `phase` starts, to stdout and to stderr (where a run that is cut keeps
    only the end of stdout, stderr still shows how far each phase got)."""
    line = f"start {phase} at {time.perf_counter() - T_START:.1f} s"
    print(line)
    print(line, file=sys.stderr, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # rows reach a redirected stdout as they are printed, not when a block
    # fills, so a run that is cut still shows how far it got
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import backend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    backend.set_numerics()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, tf32 cudnn "
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    libs = backend.build_kernels()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    problem = paper_problem(device="cuda")
    params0 = problem[0].init(0, device="cuda")
    from repro_torch.core import BernoulliParticipation
    # a typical round for the kernels' timing: the median-|A| mask among
    # rounds 1-21 of the main path's participation stream
    part = BernoulliParticipation(problem[2], seed=1)
    masks = [part.sample(t) for t in range(22)][1:]
    typical = sorted(masks, key=lambda m: m.sum())[len(masks) // 2]
    active_path = torch.from_numpy(typical).cuda()

    gen = torch.Generator(device="cuda").manual_seed(0)
    mifa_err, rows = check_mifa(gen, active_path)
    tree_err, tree_rows = check_mifa_tree(gen, active_path)
    mifa_err = max(mifa_err, tree_err)
    bank_err, more = check_bank(gen, active_path)
    pscat_err, pgath_err, paged_rows = check_paged(gen, active_path)
    tb_err, tp_err, scatter_rows = check_scatter_trees(gen, active_path)
    bank_err, pscat_err = max(bank_err, tb_err), max(pscat_err, tp_err)
    tree_err, more_tree = check_gather_tree(gen, active_path)
    pgath_err = max(pgath_err, tree_err)
    bb_err, pb_err, batched_rows = check_batched(gen, active_path)
    for row in (rows + tree_rows + more + paged_rows + scatter_rows
                + more_tree + batched_rows):
        print(row)
    timing = {"mifa_aggregate": time_mifa(gen, active_path),
              "bank_scatter": time_bank(gen, active_path),
              "paged_bank_scatter": time_paged_scatter(gen, active_path),
              "paged_bank_gather": time_paged_gather(gen, active_path)}
    batched = time_batched(gen, problem[2])
    timing.update({k: batched[k] for k in ("bank_scatter_batched",
                                           "paged_bank_scatter_batched")})
    for name, t in timing.items():
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms'] * 1e3:.2f} us")
        shape = (f"K=3 trials, C={batched['cohort']}, valid "
                 f"{batched['valid']}" if name.endswith("batched")
                 else f"|A|={int(active_path.sum())}")
        print(f"{name} per round (6 leaves of paper_mlp, one launch, "
              f"{shape}): kernel {t['ms'] * 1e3:.2f} us, "
              f"plain {t['plain_ms'] * 1e3:.2f} us{lib}, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, "
              f"{t['bytes']} bytes)")
        for leaf in t["leaves"]:
            lib = ("" if "library_us" not in leaf
                   else f", library {leaf['library_us']:.2f} us")
            print(f"  {name} M={leaf['M']:<6} per launch: kernel "
                  f"{leaf['us']:.2f} us, plain {leaf['plain_us']:.2f} us"
                  f"{lib}, bound {leaf['bound_us']:.2f} us")

    phase_start("main path")
    launches, rows, main_runs, loop_ms = main_path(params0, problem)
    for row in rows:
        print(row)
    phase_start("paged path")
    (launches["paged_bank_scatter"], rows, main_runs["banked_paged"],
     loop_ms["banked_paged"]) = paged_path(params0, problem,
                                           main_runs["banked_dense"])
    for row in rows:
        print(row)
    phase_start("eviction phase")
    evict_counts, rows = eviction_phase(params0)
    for row in rows:
        print(row)
    phase_start("million phase")
    million_counts, rows = million_phase(params0, problem[0])
    for row in rows:
        print(row)
    launches["paged_bank_gather"] = (evict_counts["paged_bank_gather"]
                                     + million_counts["paged_bank_gather"])
    problem_cpu = paper_problem(device="cpu")
    phase_start("card vs CPU")
    card_vs_cpu(params0, problem, problem_cpu)
    phase_start("fig2 phase")
    fleet_launches, fleet_runs, rows = fig2_phase(problem)
    launches.update(fleet_launches)
    for row in rows:
        print(row)
    phase_start("fleet card vs CPU")
    print(fleet_card_vs_cpu(problem, problem_cpu))

    # the scan engine: the paper paths, eviction, int8 memory and the
    # fleets again, each round a replay of one captured CUDA graph
    phase_start("scan phases")
    scan_launches, rows, scan_runs = scan_phase(params0, problem, main_runs,
                                                loop_ms)
    phase_start("eviction scan")
    evict_scan_counts, more = eviction_scan_phase()
    scan_launches["paged_bank_gather"] = evict_scan_counts[
        "paged_bank_gather"]
    phase_start("fleet scan")
    fleet_scan_launches, fleet_rows, fleet_scan_runs = fleet_scan_phase(
        problem, fleet_runs)
    scan_launches.update(fleet_scan_launches)
    # meshes: the scan runs again on a 1x1 mesh, bit-equal
    phase_start("mesh phase")
    mesh_launches, mesh_rows = mesh_phase(params0, problem, scan_runs,
                                          fleet_scan_runs, smi)
    mesh_ckpt_launches = mesh_launches.pop("checkpoint")
    fleet_rows += mesh_rows
    del scan_runs, fleet_scan_runs
    phase_start("int8 and profiled scans")
    for row in (rows + more + int8_phase(params0, problem,
                                         main_runs["mifa_array"])
                + profiled_scan(params0, problem) + fleet_rows):
        print(row)
    # scenarios: availability drawn inside the round on the card
    phase_start("scenario phase")
    scen_launches, rows = scenario_phase(params0, problem, problem_cpu)
    for row in rows:
        print(row)
    # the runtime simulator: the heap and the compiled engine, fleets
    phase_start("sim phase")
    sim_launches, rows = sim_phase(params0, problem, problem_cpu)
    for row in rows:
        print(row)
    # durability: trace replay, elastic fleets, kill and resume, snapshots
    phase_start("durability phase")
    dur_launches, rows = durability_phase(params0, problem, problem_cpu)
    for row in rows:
        print(row)
    # the loop after all the captures: the main path's MIFA(array) again,
    # bit-equal to its first run
    from repro_torch.core import MIFA
    phase_start("loop after the scan phases")
    reset_counts()
    again = run_path("mifa_array", MIFA(), problem, params0, ROUNDS, "cuda",
                     ROUNDS)[:2]
    d_loss, d_param = run_gaps(main_runs["mifa_array"], again)
    check(d_loss == 0 and d_param == 0 and read_counts()["mifa_aggregate"]
          == ROUNDS, f"the loop after the scan phases: |dloss| {d_loss:.3e},"
                     f" |dparam| {d_param:.3e}, launches {read_counts()}")
    print(f"loop after the scan phases: MIFA(array) {ROUNDS} rounds "
          f"bit-equal to the main path's first run, {ROUNDS} launches")
    del fleet_runs, main_runs

    del problem, problem_cpu, params0
    torch.cuda.empty_cache()
    phase_start("zoo phases")
    zoo_errs, zoo_shapes, zoo_launches = zoo_phases(gen, timing)
    launches.update(zoo_launches)
    # federated training of the zoo's text models: granite-3-8b's rounds
    # step the server through mifa_aggregate
    torch.cuda.empty_cache()
    phase_start("train phase")
    train_launches, rows = train_phase(smi)
    for row in rows:
        print(row)
    mifa_err = max(mifa_err, train_launches.pop("kernel_check_err"))
    # gemma3-4b: flash_attention at head dim 256, global and windowed
    torch.cuda.empty_cache()
    phase_start("gemma phase")
    gemma, rows = gemma_phase(gen, smi)
    for row in rows:
        print(row)
    # MoE: olmoe-1b-7b and moonshot-v1-16b-a3b served, olmoe trained
    torch.cuda.empty_cache()
    phase_start("moe phase")
    moe, rows = moe_phase(gen, smi)
    for row in rows:
        print(row)
    # MLA: deepseek-v2-lite-16b served and trained, flash_attention with
    # v's head dim 128 beside q and k's 192
    torch.cuda.empty_cache()
    phase_start("mla phase")
    mla, rows = mla_phase(gen, smi)
    for row in rows:
        print(row)
    # the stub frontends: llava-next-34b served at full depth (the kernel
    # at g = 7 and S = 2912) and trained sequentially; hubert-xlarge scored
    # and trained through mifa_aggregate
    torch.cuda.empty_cache()
    phase_start("llava phase")
    llava, rows = llava_phase(gen, smi)
    for row in rows:
        print(row)
    torch.cuda.empty_cache()
    phase_start("hubert phase")
    hubert, rows = hubert_phase(smi)
    for row in rows:
        print(row)
    zoo_errs["flash_attention"] = max(zoo_errs["flash_attention"],
                                      llava["err"])
    # the dry-run planner: every plan, qwen1.5-110b's decode plan made on
    # the card, its prefill with padded heads, update_spec=
    torch.cuda.empty_cache()
    phase_start("dryrun phase")
    dry, rows = dryrun_phase(gen, smi)
    for row in rows:
        print(row)
    zoo_errs["flash_attention"] = max(zoo_errs["flash_attention"],
                                      dry["err"])
    # split products: granite-3-8b, olmoe-1b-7b (experts over `model`) and
    # qwen1.5-110b served, trained, run in federated rounds and fleets on
    # each rank's blocks in a world of two ranks on this card
    torch.cuda.empty_cache()
    phase_start("split phase")
    split, rows = split_phase(gen, smi)
    for row in rows:
        print(row)
    zoo_errs["flash_attention"] = max(zoo_errs["flash_attention"],
                                      split["err"])
    mifa_err = max(mifa_err, split["server_err"])

    # which run each count comes from: no path's rounds read bank rows, so
    # the gather kernel's launches are those of PagedDeviceBank.gather in
    # the two phases that check every written row
    launches_from = {
        "mifa_aggregate": f"main path MIFA(array), {ROUNDS} rounds",
        "bank_scatter": f"main path BankedMIFA(DenseBank), {ROUNDS} rounds",
        "paged_bank_scatter":
            f"paged path BankedMIFA(PagedDeviceBank), {ROUNDS} rounds",
        "paged_bank_gather": "checks only: PagedDeviceBank.gather of all "
                             "rows in the eviction and million-client "
                             "phases, one launch each",
        "bank_scatter_batched":
            f"Figure 2 fleet BankedMIFA(DenseBank), K=3, {FLEET_ROUNDS} "
            "rounds, one launch a round for the six leaves and three trials",
        "paged_bank_scatter_batched":
            f"Figure 2 fleet BankedMIFA(PagedDeviceBank), K=3, "
            f"{FLEET_ROUNDS} rounds, one launch a round for the six leaves "
            "and three trials",
        "flash_attention": f"zamba2-7b serve prefill, {SERVE_B} x "
                           f"{SERVE_PROMPT} tokens (13 shared-attention "
                           "insertions; decode launches none)",
        "ssd_scan": f"zamba2-7b serve prefill, {SERVE_B} x {SERVE_PROMPT} "
                    "tokens (68 Mamba2 layers; decode launches none)"}
    per_call = {k: zoo_shapes[k] + ", bf16" for k in zoo_launches}
    # the same paths under engine="scan": one launch a replay plus one in
    # the warm-up before capture
    scan_from = {
        "mifa_aggregate": f"scan MIFA(array), {ROUNDS} rounds",
        "bank_scatter": f"scan BankedMIFA(DenseBank), {ROUNDS} rounds",
        "paged_bank_scatter":
            f"scan BankedMIFA(PagedDeviceBank), {ROUNDS} rounds",
        "paged_bank_gather": "checks only: PagedDeviceBank.gather of all "
                             "rows after the eviction scan",
        "bank_scatter_batched":
            f"scan Figure 2 fleet BankedMIFA(DenseBank), {FLEET_ROUNDS} "
            "rounds",
        "paged_bank_scatter_batched":
            f"scan Figure 2 fleet BankedMIFA(PagedDeviceBank), "
            f"{FLEET_ROUNDS} rounds"}
    # the mesh phase's runs on a 1x1 mesh, each counted from 0 just before
    mesh_from = {
        "mifa_aggregate": f"mesh MIFA(array), 1x1 mesh, {ROUNDS} rounds "
                          "(scan)",
        "bank_scatter": f"mesh BankedMIFA(DenseBank), 1x1 mesh, {ROUNDS} "
                        "rounds (scan)",
        "bank_scatter_batched": f"mesh Figure 2 fleet BankedMIFA("
                                f"DenseBank), K=3, 1x1 mesh, "
                                f"{FLEET_ROUNDS} rounds (scan)"}
    # the scenario path's loop runs, each counted from 0 just before it
    scen_from = {
        "mifa_aggregate": f"scenario MIFA(array) under gilbert_elliott, "
                          f"{ROUNDS} rounds (loop)",
        "bank_scatter": f"scenario BankedMIFA(DenseBank) under cluster, "
                        f"{SCEN_COHORT_ROUNDS} rounds (loop)",
        "paged_bank_scatter": f"scenario BankedMIFA(PagedDeviceBank) under "
                              f"cluster, {SCEN_COHORT_ROUNDS} rounds (loop)",
        "bank_scatter_batched": f"scenario cohort fleet BankedMIFA("
                                f"DenseBank), K=3 cluster, "
                                f"{SCEN_COHORT_ROUNDS} rounds (loop)"}
    # the simulator's heap runs under Impatient, each counted from 0
    sim_from = {
        "mifa_aggregate": f"simulator MIFA(array) impatient, {SIM_ROUNDS} "
                          f"rounds (heap engine; compiled: {SIM_ROUNDS + 1}"
                          f", fleet K=3: {3 * (SIM_FLEET_ROUNDS + 1)})",
        "bank_scatter": f"simulator BankedMIFA(DenseBank) impatient, "
                        f"{SIM_SHORT_ROUNDS} rounds (heap engine)",
        "paged_bank_scatter": f"simulator BankedMIFA(PagedDeviceBank) "
                              f"impatient, {SIM_SHORT_ROUNDS} rounds (heap "
                              "engine)"}
    entries = []
    for name, src, tpu, err in (
            ("mifa_aggregate", "mifa_aggregate.cu",
             "src/repro/kernels/mifa_aggregate.py:24", mifa_err),
            ("bank_scatter", "bank_scatter.cu",
             "src/repro/kernels/bank_scatter.py:44", bank_err),
            ("paged_bank_scatter", "paged_bank.cu",
             "src/repro/kernels/bank_scatter.py:211", pscat_err),
            ("paged_bank_gather", "paged_bank.cu",
             "src/repro/kernels/bank_scatter.py:291", pgath_err),
            ("bank_scatter_batched", "bank_scatter.cu",
             "src/repro/kernels/bank_scatter.py:114", bb_err),
            ("paged_bank_scatter_batched", "paged_bank.cu",
             "src/repro/kernels/bank_scatter.py:342", pb_err),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:26",
             zoo_errs["flash_attention"]),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:25",
             zoo_errs["ssd_scan"])):
        t = timing[name]
        scan = ({"scan_launches": scan_launches[name],
                 "scan_launches_from": scan_from[name]}
                if name in scan_launches else {})
        if name in mesh_launches:
            scan.update(mesh_launches=mesh_launches[name],
                        mesh_launches_from=mesh_from[name])
        if name == "mifa_aggregate":
            # the mesh phase's checkpoint run and the dry-run phase's
            # placed train step, each counted from 0 just before it
            scan.update(
                mesh_checkpoint_launches=mesh_ckpt_launches,
                mesh_checkpoint_launches_from=(
                    f"mesh checkpoint= MIFA(array), 1x1 mesh, "
                    f"{MESH_SNAP_ROUNDS} rounds (scan), a snapshot every "
                    f"{MESH_SNAP_EVERY}"),
                placed_step_launches=dry["placed_launches"],
                placed_step_launches_from=(
                    f"granite-3-8b train_4k plan's vmap step through "
                    f"run_placed, {PLACED_LAYERS} layers at full width, "
                    f"N={PLACED_N}, 1x1 mesh, one call"),
                # the split phase's training runs on a 1x2 mesh, each
                # round counted from 0 just before it on each rank
                split_train_launches=split["train_launches"],
                split_train_launches_from=(
                    f"split train step on each of {SPLIT_RANKS} ranks, "
                    f"N={SPLIT_TRAIN_N}, {SPLIT_TRAIN_ROUNDS} rounds, the "
                    "server step on each rank's blocks of G, one launch a "
                    "round in vmap mode and none in sequential mode"))
        if name in split["fl_launches"]:
            # the split phase's federated runs on a 1x2 mesh, each counted
            # from 0 just before it on each rank
            scan.update(
                split_fl_launches=split["fl_launches"][name],
                split_fl_launches_from=(
                    f"split run_fl(engine='scan', mesh=1x{SPLIT_RANKS}, "
                    "cfg=) on each rank, the server step on the rank's "
                    "blocks (G's or the bank rows'; a paged bank whole on "
                    "every rank), one launch a round, every round eager"))
        if name in split["fleet_launches"]:
            # the split phase's fleets on a 1x2 mesh, each counted from 0
            # just before it on each rank
            scan.update(
                split_fleet_launches=split["fleet_launches"][name],
                split_fleet_launches_from=(
                    f"split run_fleet(engine='scan', mesh=1x{SPLIT_RANKS}, "
                    f"cfg=) on each rank, {len(SPLIT_FLEET_SEEDS)} trials "
                    "under vmap, the server step on the whole state: "
                    "mifa_aggregate once a trial a round, a batched scatter "
                    "once a round for every trial, every round eager"))
        if name in scen_launches:
            scan.update(scenario_launches=scen_launches[name],
                        scenario_launches_from=scen_from[name])
        if name in sim_launches:
            scan.update(sim_launches=sim_launches[name],
                        sim_launches_from=sim_from[name])
        if name in dur_launches:
            scan.update(durability_launches=dur_launches[name],
                        durability_launches_from=DUR_FROM[name])
        if name in train_launches:
            scan.update(train_launches=train_launches[name],
                        train_launches_from=TRAIN_FROM,
                        moe_train_launches=moe["train_launches"],
                        moe_train_launches_from=(
                            f"train olmoe-1b-7b, {MOE_TRAIN_LAYERS} layers "
                            f"at full width, N={MOE_TRAIN_N}, "
                            f"{MOE_TRAIN_ROUNDS} rounds of MIFA(array)"),
                        mla_train_launches=mla["train_launches"],
                        mla_train_launches_from=(
                            f"train deepseek-v2-lite-16b, {MOE_TRAIN_LAYERS} "
                            f"layers (one dense, one MoE) at full width, "
                            f"N={MOE_TRAIN_N}, {MOE_TRAIN_ROUNDS} rounds of "
                            "MIFA(array)"),
                        hubert_train_launches=hubert["train_launches"],
                        hubert_train_launches_from=hubert[
                            "train_launches_from"])
        if name == "flash_attention":
            # gemma3-4b's serve prefill, counted from 0 just before it, and
            # the kernel at its two shapes (ms, plain, bound, sdpa per call)
            scan.update(
                gemma_launches=gemma["launches"],
                gemma_launches_from=f"gemma3-4b serve prefill, {SERVE_B} x "
                                    f"{SERVE_PROMPT} tokens (29 local "
                                    "layers, window 1024, and 5 global; "
                                    "decode launches none)",
                gemma_per_call={
                    label: {k: t[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_backend")}
                    for label, t in gemma["timing"].items()},
                gemma_per_call_at=f"gemma3-4b: B={SERVE_B} S=T="
                                  f"{SERVE_PROMPT} H=8 KV=4 hd=256, bf16, "
                                  "causal; local with window 1024",
                # the MoE models' serve prefills, each counted from 0 just
                # before it, and the kernel at their shape
                moe_launches=moe["launches"],
                moe_launches_from=f"serve prefill, {SERVE_B} x "
                                  f"{SERVE_PROMPT} tokens, one launch a "
                                  "layer; decode launches none",
                moe_per_call={k: moe["timing"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_backend")},
                moe_per_call_at=f"olmoe-1b-7b, moonshot-v1-16b-a3b: B="
                                f"{SERVE_B} S=T={SERVE_PROMPT} H=KV=16 "
                                "hd=128, bf16, causal",
                # deepseek-v2-lite-16b's serve prefill (MLA, v's head dim
                # 128), counted from 0 just before it, and the kernel at
                # its shape
                mla_launches=mla["launches"],
                mla_launches_from=mla["launches_from"],
                mla_per_call={k: mla["timing"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_backend")},
                mla_per_call_at="deepseek-v2-lite-16b: B={} S=T={} H=KV={} "
                                "hd={} dv={}, bf16, causal".format(
                                    *MLA_SHAPE[:3], *MLA_SHAPE[4:]),
                # llava-next-34b's serve prefill (2880 patches and the
                # prompt), counted from 0 just before it, and the kernel at
                # its shape (GQA g = 7)
                llava_launches=llava["launches"],
                llava_launches_from=llava["launches_from"],
                llava_per_call={k: llava["timing"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_backend")},
                llava_per_call_at="llava-next-34b: B={} S=T={} H={} KV={} "
                                  "hd={}, bf16, causal".format(*LLAVA_SHAPE),
                # qwen1.5-110b's serve prefills at QWEN_LAYERS layers, with
                # and without pad_heads, each counted from 0 just before
                # it, and the kernel at the two shapes
                qwen_launches=dry["launches"],
                qwen_launches_from=f"qwen1.5-110b serve prefill, {SERVE_B} "
                                   f"x {SERVE_PROMPT} tokens, {QWEN_LAYERS} "
                                   "layers at full width, one launch a "
                                   "layer, padded (H 64, KV 16) and "
                                   "unpadded; decode launches none",
                qwen_per_call={
                    label: {k: t[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_backend")}
                    for label, t in dry["timing"].items()},
                qwen_per_call_at="qwen1.5-110b: B={} S=T={} H={} KV={} (padded"
                                 " {}) hd={}, bf16, causal".format(
                                     *QWEN_SHAPE[:4], QWEN_PAD_SHAPE[3],
                                     QWEN_SHAPE[4]),
                # the split phase's prefills on a 1x2 mesh, each counted
                # from 0 just before it on each rank, and the kernel at
                # each rank's heads
                split_launches=split["launches"],
                split_launches_from=f"split serve prefill on each of "
                                    f"{SPLIT_RANKS} ranks, {SERVE_B} x "
                                    f"{SERVE_PROMPT} tokens, one launch a "
                                    "layer on the rank's heads; decode "
                                    "launches none",
                split_per_call={
                    label: {k: t[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_backend")}
                    for label, t in split["timing"].items()},
                split_per_call_at="; ".join(
                    f"{k}: B={v[0]} S=T={v[1]} H={v[2]} KV={v[3]} hd={v[4]}"
                    for k, v in SPLIT_SHAPES.items()) + ", bf16, causal")
        if name in per_call:
            # ms, plain_ms and bound_ms are per call at the served shape
            entries.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": tpu, "launches": launches[name],
                "launches_from": launches_from[name],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "per_call_at": per_call[name],
                **scan})
            continue
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches[name],
            "launches_from": launches_from[name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # None where no single PyTorch call computes the function
            # (PERF.md); the gather's is one index_select per leaf
            "library_ms": t["library_ms"],
            # ms, plain_ms and bound_ms are per round (one launch for the
            # six leaves); this is per launch of one leaf at each leaf's
            # width
            "per_launch_us": t["leaves"], **scan})
    print(json.dumps({"kernels": entries}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
