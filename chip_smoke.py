"""Drive dfmdock_tpu_torch's main paths on one CUDA card and check its kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --only scaling,heun   # phases 1, 2, 10b and 10c alone
    python3 chip_smoke.py --only capture        # phases 1, 2 and 10d alone

The kernel route has two precisions: fast() computes in bf16, as the JAX
package's (fused_egcl in its single-pass bf16 mode, counted apart as
fused_egcl_bf16 / fused_egcl_coord_bf16), and fast(compute_dtype="float32")
is the float32 route (fused_egcl in three bf16 passes).  The float32 gates
(phase 4's F32_PARITY_REL, the bit-equal trajectories, the DockQ gates)
run on the float32 route, reached through the CLIs' `model` argument;
the CLIs' default is the bf16 route, and the bf16 phases are named below.
Phases, in order; any failure ends the run with a non-zero exit:
  1. device: the card's name and power limit;
  2. build: nvcc builds every kernel of dfmdock_tpu_torch/csrc/, in parallel;
  3. kernel checks: the edge table's bin code at every boundary (exact);
     each kernel against its plain PyTorch version on the card, at the dock
     path's shapes (P=16 poses of DB5 1AVX padded to N=448, K=60, C=256;
     three seeds) and on a small masked graph (N=64, 40 valid nodes): the
     edge table (bin ties logged per case), its bins-only mode (edge_bins,
     also bit-equal to the table's bins), edge selection (select_topk, exact,
     with a forced-tie case), the EGCL layers (masked edges' geometry
     poisoned with NaN on the small graph, two launches bit-equal) and the
     pair energy head (fused_energy, with one all-masked pose); fused_egcl's
     bf16 mode, both variants, against its plain version at dtype bf16
     (BF16_KERNEL_REL, two launches bit-equal).  Then
     select_topk, exact, at the sweep's buckets N = 512 and 768 (16 poses,
     sample_size 40 and 0) and on a 4096-node chain (one pose, 64 MB of
     dist: the widest rows the kernel takes); fused_energy, rel 1e-4, two
     launches bit-equal, the last pose all masked, on the native 1AVX
     interface mask (~0.6% kept), a dense 30% mask and C = 1024;
  4. ScoreNet parity: the forward through the kernels (card) against the
     forward through the plain versions (CPU), full width, seeded weights,
     on the float32 route: fast(f32) at t in {0.1, 0.5, 0.9} on injected
     edges, fast(f32) selecting its own edges from injected Gumbel noise,
     and fast(f32, edge_table_kernel=False),
     full forwards (energy through fused_energy); every output's error is
     printed, and a failing case relaunches each kernel call of its forward
     on the recorded inputs (the forward's output against a relaunch, two
     relaunches, the plain version) before the run fails.  Then the same
     for the DFMDock lineage (DFMDockModel, trained weights from
     ckpts/db5_holdout_dfmdock/weights.npz) at t in {0.1, 0.5}: six
     agg-only fused_egcl calls a forward, no coord or energy kernel;
  4b. the bf16 parity matrix: fast() (bf16) on the card against the eager
     float32 path on the CPU, seeded weights, N in {128, 256, 448, 640} x t
     in {0.1, 0.5, 0.9} (PARITY_TOL / PARITY_ABS, or the eager bf16 route's
     own distance from float32 times BF16_ROUTE_FACTOR: bf16_parity_phase
     says why); the trained DFMDock lineage's fast() forward against its
     eager float32 path;
  5. dock: the dock CLI in-process on 1AVX, 16 poses x 40 steps, after a
     warm-up run, at its default (bf16) and on the float32 route; steps/s,
     launches;
  6. sampler: denoising steps/s over EMSampler.sample alone (the same 16
     poses x 40 steps, no model build, file I/O or DockQ), three runs on
     each route, each a replay of the sample's captured graph;
  7. profile: torch.profiler over a 10-step sample (a replay) of the same
     complex on each route; the device's busy share, the kernels that take
     its time, and each port kernel's device time per launch;
  8. ranking dock: the dock CLI with --rank-by reranker (1 + 5 t x 4 draws
     = 21 fused_energy launches) and with --energy-draws 4; the inputs of
     the reranker run's first fused_energy call (its final poses) are kept,
     and the kernel line checks, times and bounds fused_energy on them;
  9. sweep: the sweep CLI over 1AVX, then --resume over 1AVX and 7CEI, 16
     poses x 40 steps each; wall per complex and the rows written;
  9b. trained mlsb (ckpts/db5_demo/weights.npz): the dock of 1AVX (16 poses
     x 40 steps; min-energy pick and best-of-16 DockQ beside the JAX demo's
     v5e record) and the sweep over all 24 DB5 complexes (16 poses, seed 5),
     gated against the JAX record eval_all.csv: the mean DockQ over all
     poses and the min-energy-pick mean each at least the record's less its
     bootstrap margin (quality_gate); then the same sweep on the bf16 route
     under the same gate (the record is itself a JAX bf16 run), its
     launches equal to the float32 sweep's mode for mode; then the port's
     own db5_demo weights (ckpts/db5_demo_torch, the record's 2000 epochs
     trained by the training CLI on the card) through the same bf16 sweep,
     beside the JAX-trained weights' at seed 5 with the difference, under
     the same gate (the run was found reproduced: its README), its
     launches equal to the JAX-trained sweep's mode for mode;
  9c. the DFMDock lineage: the sweep --lineage dfmdock with its trained
     weights (40 poses, seed 5) over the four complexes it was trained on,
     gated against eval_train.csv, and over the four held out, beside
     eval_holdout.csv; six fused_egcl launches per forward and no
     fused_egcl_coord or fused_energy launch; a 10-step profile at P = 16;
     then both sets on the bf16 route beside their records, ungated
     (dfmdock_sweep_phase says why);
  9d. Picard latency mode (trained mlsb, 1AVX, one pose): the dock with
     --picard-iters 10 beside the sequential --ode dock (walls); Picard at
     K = T = 40 bit-equal to K = T + 1 and to the sequential ODE run at
     its launch shape, and against the 1-pose sequential ODE from the same
     generator seed step by step, with the edges and bins of every forward
     compared (PICARD_STEP_TOL); on the bf16 route K = T bit-equal to
     K = T + 1;
 9e. PDB inputs: 1AVX's receptor and ligand written as two PDB files
     (save_pdb of the npz backbone) and docked through the CLI with the
     trained mlsb weights and --one-hot-only (16 poses x 40 steps), then a
     --csv of two rows (the npz, the PDB pair); the launch counts equal the
     --npz dock's (twice over for the CSV); wall and s per pose;
  9f. ESM2-650M at full width with seeded weights: the first 4 layers on
     the card against the CPU (rel 1e-3, TF32 off), the embed of 1AVX's
     two chains through all 33 layers (wall, peak memory);
  9g. training, mlsb: the training CLI at the demo's protocol (crop 448,
     --grad-energy --use-contrastive-loss, seed 41) cut to 9 epochs (432
     steps of the 48-row pool); steps/s, peak memory, the logged losses
     beside the JAX record's first line (v5e), one step on the card against
     the CPU (loss terms rel 1e-4, gradients rel 1e-3), the saved
     weights.npz through load_model, a 20-step profiled window on the
     captured and the eager route (idle share); the CLI trains through
     the captured step (one graph a step, its replays' launches counted),
     and two epochs of two steps with a pool refresh between, replayed
     against eager under deterministic algorithms, keep every weight
     bit-equal after every step; only select_topk may launch;
  9h. training, the DFMDock lineage: the same at its checkpoint's protocol
     (20 training complexes, --grad-energy), 2 epochs (80 steps);
  9m. bfloat16 compute on the eager route, both lineages: the training CLI
     with --compute-dtype bfloat16 at 9g's and 9h's protocols cut to one
     epoch (config.yaml records it; only select_topk may launch), one bf16
     step on the card against the CPU (BF16_TRAIN_*), the 20-step window
     of 9g/9h at bf16 (steps/s, peak memory, idle share) printed beside
     the f32 window's, and one eager predict forward of each lineage at
     ModelConfig(compute_dtype="bfloat16") (trained weights, injected
     edges) on the card against the CPU (BF16_PREDICT_REL);
 9n. the training CLI's --no-pool path (the eager loop that featurizes
     each step on the host), both lineages at 9g's and 9h's protocols cut to
     one epoch: no graph captured, only select_topk launching; its first
     step made again from the CLI's start gives the CLI's logged losses, and
     on the card against the CPU at 9g's bounds;
 9i. dp dock: the dock CLI with --dp (torch.distributed, one NCCL rank on
     the card) on 1AVX with the trained mlsb weights, 16 poses x 40 steps,
     against the plain dock at the same seed, on each route: poses,
     energies and rows bit-equal (both walls printed; every dock kernel
     must launch);
 9j. dp sweep: the sweep CLI with --dp over 1AVX and 7CEI (trained mlsb, 16
     poses): its rows equal the plain sweep's;
 9k. dp training: the training CLI with --dp --batch-size 2 (one step of a
     two-row pool of 1AVX at crop 448, one NCCL rank) against the plain CLI
     (every weight after the step bit-equal), then make_dp_train_step
     against train_step on the same two rows and generator seed (every
     gradient and metric bit-equal); the same again at --compute-dtype
     bfloat16;
 9l. remainder: compute_tm, kabsch (with and without weights), the 25-wide
     pair_features and sixd_bins_dense of 1AVX on the card against the CPU
     (1e-5, kabsch's t relative to 1 + |centroid|; bins equal but at
     boundary ties), and the full-width
     forward of parallel/dryrun.entry();
 10. kernel routes: 40-step samples of 16 poses under one generator seed
     through fast(f32), its select_kernel=True and edge_table_kernel=False
     routes, fast() (bf16) and its select_kernel=True route.  Edge selection
     has one route (select_topk, ties to the lower index), so each select
     route's trajectory must equal its precision's fast() bit for bit (a
     gate); where the bins route's and the bf16 route's leave fast(f32)'s
     is reported (these samples run eagerly: the edge recorder is Python
     called every forward);
 10b. scaling: the ScoreNet at bench.py's other pose counts, P in {40, 64,
     120} (1AVX at N = 448, seeded weights): on the float32 and the bf16
     route one forward of random poses on injected edges against the
     route's plain path on the card (the kernels' plain versions, in blocks
     of 40 poses; phase 4's tolerances, and where an output lies beyond its
     precision's bound, 4b's rule: within 2x the distance that precision
     sets itself, the float32 plain path's from its float64 evaluation, the
     eager bf16 route's from float32, on the card), and a 40-step sample,
     finite, with the P = 16 sample's launches a forward (six fused_egcl,
     one of them coord, one edge_table, one select_topk; one fused_energy
     in the final forward), its steps/s, device busy time and peak memory,
     captured (with the capture's seconds and peak) and eager beside it;
     at P = 120 every kernel against its plain version at the kernel
     checks' bounds;
 10c. Heun (--integrator heun, the probability-flow ODE with a corrector
     forward a step): 40-step samples of 16 poses on fast(f32), fast()
     and their select routes, each with 2 x 40 + 1 forwards' launches and
     each select route bit-equal to its fast(); 4 Heun steps with the clash
     force and knn-only edges from one start pose, the card's float32
     route against the CPU's plain path (every frame, the pose and the
     scores within F32_PARITY_REL; the energy and tr_update printed); the
     dock CLI with --integrator heun.
 10d. capture: the samplers as CUDA graphs (sampler/graph.py: one capture
     per shape key, replayed), each against its eager run from the same
     generator state, bit for bit in every output: EM and Heun over 40
     steps of 16 poses on the f32, bf16, select and bins routes (launches
     exact, read from the run's trace; the caller's generator as the
     eager sample leaves it, the graph's registered generator the
     helper's own in its state; a second replay equal to the eager sample
     from its state and unlike the first), the DFMDock lineage, Picard at
     K = T and T + 1, the ranking draws at two t, and the dock and sweep
     CLIs (the graph draws from the generator --seed seeds); the numbers
     at P = 16 as 10b's; the 24 DB5 complexes at one pose through EM, Heun
     and Picard (K = 10) captured, EM also eager (walls, captures: one a
     bucket, replays, peak memory, the shared pool's size).
Every sampler path but phase 10's routes and 9d's recorded runs runs as
the replay of one captured graph per shape key; run_path prints the
captures and replays of each path.  A path's launches are the kernels its
samples executed: a wrapper counts where it is called (in a capture, a
launch the graph records; a replay calls no wrapper).  The runs that feed
the kernel line and the exactly gated runs that replay each graph once
at P = 16 and up (the docks of 5, the samples and docks of 10b-10d, the
PDB dock) are traced (torch.profiler, device records): their launches are read from the
trace, less the warm-ups' that the wrappers counted, and the trace must
hold exactly what the wrappers and the graphs' records account for.
Elsewhere, in the runs that replay one graph several times (the ranking
docks of 8, 10d's ranking draws, the CSV dock: their traces came back
without some replays' records) and in the one-pose Heun parity and
Picard runs (10c's parity trace lacked a forward's first three kernels in
two calls), the launches are the wrappers'
counts less the warm-ups' and the captures' and plus each replay's
recorded launches (sampler/graph.GraphStats).
Phases 9i-9l run last, after the kernel table's timings (below).
The kernel table after phase 10 gives each kernel's time by CUDA events,
its device time (torch.profiler, from a trace that recorded every kernel a
whole number of times a call), its enqueue time on the host (host_ms:
1,000 calls with no synchronize), its plain version's time and its bound;
fused_egcl is called there as the main path calls it (its weights'
kernel-side form built once, B as bf16 in the bf16 mode).  A failing
card-vs-CPU training step (9g, 9h, 9m) is kept under
chiprun_out/train_step_failures/ and replayed in float64 before the run
fails.
Each main path (phases 5, 8, 9, 9b-9e, 9g-9k, 9m, 9n, the routes of 10, the samples
of 10b and the samples and dock of 10c) runs with the
launch counts set to 0 just before it and read just after; a kernel of the
path that did not launch (or one that must not run and did: the other
precision's fused_egcl mode, and on the DFMDock lineage the coord and
energy kernels) fails the run.  The kernel line's fused_egcl_bf16 rows
take their launches from the dock CLI's default (bf16) traced run, the
float32 rows and fused_energy from the float32 one; each row's "wrapper_launches" is what
its wrapper counted in that run (the warm-up's launches and the capture's
recorded ones), which must not be 0.  The last line is {"ok": true,
"device": {...}}; the line before it lists the kernels.  Without a CUDA card
the script exits non-zero and prints no result.  `--only PHASES` runs the
device and build phases and then only the named ones (scaling, heun,
capture), and prints neither the kernel line nor a result line.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import dataclasses
import functools
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import dfmdock_tpu_torch.models.edges as edges_mod
import dfmdock_tpu_torch.models.egnn as egnn_mod
import dfmdock_tpu_torch.models.score_net as score_net_mod
from dfmdock_tpu_torch.cli import dock, sweep, train
from dfmdock_tpu_torch.cli.common import build_sampler, load_model
from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, R3Config, SamplerConfig, SO3Config
from dfmdock_tpu_torch.data.batching import pad_complex, round_up
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.data.dataset import NPZDataset, batch_to_tensors, complex_to_batch
from dfmdock_tpu_torch.data.pdb_io import save_pdb
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.eval.tm import compute_tm
from dfmdock_tpu_torch.features.frames import pair_features, residue_frames
from dfmdock_tpu_torch.features.sixd import (
    ANGLE_BOUNDARIES,
    DIST_BOUNDARIES,
    PHI_BOUNDARIES,
    SPATIAL_DIM,
    SPATIAL_MASK_CUTOFF,
    pairwise_ca_dist,
    sixd_bins_dense,
    sixd_values_at,
)
from dfmdock_tpu_torch.geom import kabsch, random_rotation_matrix
from dfmdock_tpu_torch.features.positional import NUM_RELPOS_CLASSES
from dfmdock_tpu_torch.models.edges import sample_gumbel, select_edges, select_y
from dfmdock_tpu_torch.models.esm2 import ESM2, ESM2_650M, embed_sequence, tokenize
from dfmdock_tpu_torch.ops import _build, launch_counts
from dfmdock_tpu_torch.ops.edge_table import (
    BIN_FAMILIES,
    E_DB,
    E_OB,
    E_PB,
    E_RP,
    E_TB,
    EBIN_WIDTH,
    EGEO_WIDTH,
    bin_values,
    build_edge_table,
    build_edge_table_plain,
    edge_bins,
    edge_bins_plain,
)
from dfmdock_tpu_torch.ops.energy_head import fused_energy, fused_energy_plain
from dfmdock_tpu_torch.ops.fused_egcl import (
    fused_edge_layer,
    fused_edge_layer_plain,
    prepare_layer,
)
from dfmdock_tpu_torch.ops.select_topk import NEG_INF, select_topk, select_topk_plain
from dfmdock_tpu_torch.parallel import init_world
from dfmdock_tpu_torch.parallel.dryrun import entry
from dfmdock_tpu_torch.parallel.mesh import make_dp_train_step
from dfmdock_tpu_torch.sampler import EMSampler, PicardSampler
from dfmdock_tpu_torch.sampler import graph as graph_mod
from dfmdock_tpu_torch.sampler.em import modify_coords, randomize_pose, step_schedule
from dfmdock_tpu_torch.train.pool import PoolStep, make_training_batch, train_step, upload
from dfmdock_tpu_torch.train.trainer import make_optimizer

NPZ = os.path.join("data", "db5_npz", "1AVX.npz")
P, N_PAD, STEPS = 16, 448, 40
F32_REL = 1e-4  # kernel vs plain, max |diff| / max |plain|, float32 outputs
# fused_egcl's single-pass bf16 mode against its plain version (dtype bf16):
# both round the same values to bf16 (round to nearest), so they differ
# where the float32 sums ahead of a rounding (pre, in another order; the
# kernel's fast-math silu) tip a value across a bf16 rounding boundary, one
# bf16 step (2^-8) on that element.  A CPU emulation at the dock's shapes
# (silu perturbed by 2e-7 of itself) moves the outputs by <= 9.5e-5 of
# their largest; the float32 mode lies ~3e-3 of the largest away, so this
# tolerance tells the two modes apart.
BF16_KERNEL_REL = 1e-3
# The kernel route: fast() computes in bf16, as the JAX package's; the
# float32 kernel route is fast(compute_dtype="float32"), on which the float32
# gates (phase 4's F32_PARITY_REL, the bit-equal trajectories) and the DockQ
# gates run.
FAST_F32 = ModelConfig.fast(compute_dtype="float32")
# Kernel-path vs plain-path ScoreNet tolerances (max |diff| / max |ref|), a
# case passing on either the relative or the absolute criterion.  The port's
# own copy of bench.py's PARITY_TOL / PARITY_ABS, which were set for bf16
# kernels against the f32 path.  The absolute criterion counts only for an
# output whose largest reference value exceeds it (else a zero output would
# pass).  The port's kernels are f32, so every output must also lie within
# F32_PARITY_REL of the plain path.
PARITY_TOL = {"energy": 1e-2, "tr_score": 1e-2, "rot_score": 2e-2, "f": 5e-2,
              "ires": 1e-1}
PARITY_ABS = {"energy": 5e-3, "tr_score": 1e-3, "rot_score": 2e-3, "f": 5e-3,
              "ires": 5e-3}
F32_PARITY_REL = 1e-3
SCORE_NET_OUTPUTS = ("energy", "tr_score", "rot_score", "f", "ires")
# The bf16 parity matrix (phase 4b): fast() on the card against the eager
# float32 path on the CPU at PARITY_TOL / PARITY_ABS, as bench.py holds the
# JAX package's compiled Pallas path (BENCH_r05.json: 12 of 12; worst energy
# 9.7e-3, ires 2.3e-2): 1AVX at N = 448 and random-walk complexes at the
# other buckets, t in PARITY_T.
PARITY_NS, PARITY_T = (128, 256, 448, 640), (0.1, 0.5, 0.9)
# Where bf16 compute itself lies further from float32 than PARITY_TOL (the
# eager bf16 route, no kernel, on the same case), the kernel route is held
# within this factor of that distance: both routes round the same values
# to bf16 and differ by the ties that f32 sums in another order tip.
BF16_ROUTE_FACTOR = 2.0
# The DFMDock lineage's outputs under the tolerance of the ScoreNet output
# they stand for: its interface logits as `ires`, its confidence logit (a
# masked mean over the same pairs as the energy) as `energy`.
DFMDOCK_OUTPUTS = ("energy", "tr_score", "rot_score", "f", "ires_logits", "confidence_logits")
PARITY_ALIAS = {"ires_logits": "ires", "confidence_logits": "energy"}
# A bin may differ only where the plain version's value lies this close to
# one of its family's boundaries (rounding of atan2f/acosf/sqrtf and of the
# summation order differs between the kernel and PyTorch's own kernels).
TIE_TOL = {E_DB: 1e-4, E_OB: 1e-3, E_TB: 1e-3, E_PB: 1e-3}  # Angstrom, degrees
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM rate, FP32 rate
# outside the tensor cores (the FMAs of every kernel but fused_egcl), dense
# bf16 on the tensor cores (fused_egcl's wgmma products).
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
# fused_egcl takes each product in three bf16 passes (hi.hi + lo.hi + hi.lo)
EGCL_PASSES = 3
# The edge table's own work, counted from csrc/edge_table.cu: FP32
# operations (a multiply-add as two; a bin's guess, clamp and fix-up
# compares as eight) and special-function results (square roots, the
# reciprocal of each IEEE division, atan2f's and acosf's), where a division
# is one reciprocal and one multiply, atan2f one division and 20 operations
# and acosf one square root and 16.
# - Every edge: the CA distance (9 + 1 sqrt), its bin (8), the cutoff test
#   and the relpos class (7); edge_table also the coord-diff's
#   normalisation (a sqrt, two adds, three divisions: 5 + 4).
# - An edge kept for the angles (dist < 22 A, j != i): omega (90 + 13),
#   theta (50 + 5), phi (27 + 2), three bins (24).
# - Once per node: the virtual C-beta (33) and a row's own terms of theta
#   and phi (40 + 8).
EDGE_TABLE_OPS_PER_EDGE, EDGE_TABLE_SFU_PER_EDGE = 29, 5
EDGE_BINS_OPS_PER_EDGE, EDGE_BINS_SFU_PER_EDGE = 24, 1
EDGE_OPS_PER_KEPT_EDGE, EDGE_SFU_PER_KEPT_EDGE = 191, 20
EDGE_OPS_PER_NODE, EDGE_SFU_PER_NODE = 73, 8
# f32 operations per channel of one kept pair in csrc/energy_head.cu: the
# add, the mean's add, the centring and the variance's FMA (3), the affine
# normalisation (3), silu's exp scaling, add and product with the
# reciprocal (3), the w2 FMA (2).
ENERGY_OPS_PER_CHANNEL = 13
# Special-function work per channel of one kept pair: silu's exp and the
# reciprocal of its division.  The special-function units return 16 results
# per clock per SM (CUDA C Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) against 128 FP32 lanes of 2 FLOP, so
# their rate is FP32_FLOP_S / 16.
ENERGY_SFU_PER_CHANNEL = 2
SFU_OP_S = FP32_FLOP_S * 16 / (128 * 2)
SOURCES = {
    "edge_table": ("dfmdock_tpu_torch/csrc/edge_table.cu",
                   "dfmdock_tpu/ops/edge_table.py:218"),
    "fused_egcl": ("dfmdock_tpu_torch/csrc/fused_egcl.cu",
                   "dfmdock_tpu/ops/fused_egcl.py:216"),
    "fused_egcl_coord": ("dfmdock_tpu_torch/csrc/fused_egcl.cu",
                         "dfmdock_tpu/ops/fused_egcl.py:226"),
    "fused_egcl_bf16": ("dfmdock_tpu_torch/csrc/fused_egcl.cu",
                        "dfmdock_tpu/ops/fused_egcl.py:216"),
    "fused_egcl_coord_bf16": ("dfmdock_tpu_torch/csrc/fused_egcl.cu",
                              "dfmdock_tpu/ops/fused_egcl.py:226"),
    "fused_energy": ("dfmdock_tpu_torch/csrc/energy_head.cu",
                     "dfmdock_tpu/ops/energy_head.py:29"),
    "select_topk": ("dfmdock_tpu_torch/csrc/select_topk.cu",
                    "dfmdock_tpu/ops/select_topk.py:76"),
    "edge_bins": ("dfmdock_tpu_torch/csrc/edge_table.cu",
                  "dfmdock_tpu/ops/edge_bins.py:74"),
}
BUILD = ("edge_table", "fused_egcl", "energy_head", "select_topk")
# the kernels each main path must launch: the float32 kernel route, and the
# bf16 route (fast(), the CLIs' default), whose fused_egcl launches are
# counted apart; neither route may launch the other's fused_egcl mode
DOCK_KERNELS = ("select_topk", "edge_table", "fused_egcl", "fused_egcl_coord", "fused_energy")
DOCK_KERNELS_BF16 = ("select_topk", "edge_table", "fused_egcl_bf16", "fused_egcl_coord_bf16",
                     "fused_energy")
F32_ABSENT = ("fused_egcl_bf16", "fused_egcl_coord_bf16")
BF16_ABSENT = ("fused_egcl", "fused_egcl_coord")
ROUTE_KERNELS = {
    "fast": DOCK_KERNELS,
    "select": DOCK_KERNELS,
    "bins": ("select_topk", "edge_bins", "fused_egcl", "fused_egcl_coord", "fused_energy"),
    "fast bf16": DOCK_KERNELS_BF16,
    "select bf16": DOCK_KERNELS_BF16,
}
RERANK_T, RERANK_DRAWS, ENERGY_DRAWS = 5, 4, 4
# The scaling phase (10b): bench.py's POSE_COUNTS (16, 40, 64, 120) less the
# 16 of phases 5-10, one forward a route at SCALING_T against the route's
# plain path on the card, which runs in blocks of SCALING_PLAIN_BLOCK poses
# (the poses of a forward do not interact; the plain EGCL layer's [poses,
# N, K, C] float32 edge tensors are 3.3 GB each at P = 120)
SCALING_POSES = (40, 64, 120)
SCALING_T = 0.5
SCALING_PLAIN_BLOCK = 40
# Heun (phase 10c): the trajectory gate of tests/test_torch_ranking.py's
# test_heun_trajectory_matches_jax at full width on 1AVX: HEUN_PARITY_STEPS
# steps of the probability-flow ODE with the clash force, knn-only edges, R3
# max_sigma cut to 1 A, from 1AVX's native pose with the ligand moved by
# HEUN_SHIFT (tr_update HEUN_SHIFT, rot_update HEUN_ROT)
HEUN_PARITY_STEPS = 4
HEUN_SHIFT, HEUN_ROT = (4.0, -3.0, 2.0), (0.2, 0.1, -0.3)
# Gated: every frame, the final pose and the final forward's scores; the
# final energy and tr_update are printed beside them.  At random weights
# the energy of one pose is a mean over few pairs (~1e-2): the ~1e-2 A by
# which float32 rounding moves the pose (rot_score's floor: scaling_parity
# says why) moves it by ~4e-3 of itself
HEUN_GATED = ("pos", "tr_score", "rot_score")
HEUN_REPORTED = ("tr_update", "energy")
SWEEP_IDS = ("1AVX", "7CEI")
# The trained weights (scripts/export_torch_weights.py) and the JAX
# package's per-pose records of the same sweeps on v5e.
DEMO_NPZ = os.path.join("ckpts", "db5_demo", "weights.npz")
DEMO_RECORD = os.path.join("ckpts", "db5_demo", "eval_all.csv")
# db5_demo's protocol trained by the port (ckpts/db5_demo_torch/README.md)
DEMO_TORCH_NPZ = os.path.join("ckpts", "db5_demo_torch", "weights.npz")
DFMDOCK_NPZ = os.path.join("ckpts", "db5_holdout_dfmdock", "weights.npz")
DFMDOCK_TRAIN = ("1AVX", "1ZHI", "2SNI", "4POU")
DFMDOCK_HOLDOUT = ("1QA9", "7CEI", "2SIC", "1JPS")
DFMDOCK_POSES = 40
# the DFMDock lineage's EGNN is agg-only and its energy head plain torch
DFMDOCK_KERNELS = ("select_topk", "edge_table", "fused_egcl")
DFMDOCK_ABSENT = ("fused_egcl_coord", "fused_energy") + F32_ABSENT
DFMDOCK_KERNELS_BF16 = ("select_topk", "edge_table", "fused_egcl_bf16")
DFMDOCK_ABSENT_BF16 = ("fused_egcl_coord_bf16", "fused_energy") + BF16_ABSENT
# Quality gates against a record: the margin is the 0.1% quantile of the
# difference between two bootstrap resamples of the record (10,000 draws),
# so a port that docks like the record fails about one run in a thousand.
BOOT_DRAWS, BOOT_Q = 10_000, 0.001
ACCEPTABLE = 0.23  # DockQ of an acceptable pose (CAPRI)
# Picard at K = T against the sequential ODE on the same start and noise.
# Run with every forward at Picard's launch shape (T poses), the sequential
# ODE does the same arithmetic and must equal Picard's fixed point bit for
# bit.  The 1-pose sequential run's forward is another launch shape, so
# cuBLAS takes other GEMM tiles and sums in another order: the drift at the
# same state differs by f32 rounding, which one step turns into ~1e-5 A.
# Each step of Picard is held to PICARD_STEP_TOL on the 1-pose run's
# states, and the two trajectories to PICARD_STEP_TOL up to the first
# forward whose discrete features differ: a row's neighbour set (a kNN or
# sampled-edge near-tie) or an edge's 6D bin (a state at a bin boundary),
# which the rounding tips.  From there they are two trajectories of the
# ODE, and only with the same features throughout are the final poses
# held to PICARD_STEP_TOL.
PICARD_STEP_TOL = 1e-3  # Angstrom
# ESM2-650M's first layers on the card against the CPU, TF32 off
ESM_REL = 1e-3
# Training through the CLI at the checkpoints' protocols: the demo's
# (ckpts/db5_demo/README.md) cut to 9 epochs of its 48-row pool (432
# steps), and the DFMDock lineage's (ckpts/db5_holdout_dfmdock: 20 training
# complexes, --grad-energy) cut to 2 epochs (80 steps).  Each is gated on
# finite losses, one step on the card against the CPU (loss terms within
# TRAIN_LOSS_REL, every gradient array within TRAIN_GRAD_REL of its
# largest, with a floor of TRAIN_GRAD_FLOOR times the largest gradient of
# all), the saved weights loading bit-equal, and no kernel but select_topk
# launching (training runs the eager path; edge selection is select_topk's).
MLSB_TRAIN_FLAGS = ["--crop-size", "448", "--grad-energy", "--use-contrastive-loss",
              "--seed", "41", "--epochs", "9", "--log-every", "50"]
DFMDOCK_TRAIN_FLAGS = ["--lineage", "dfmdock", "--crop-size", "448", "--grad-energy",
                 "--exclude-ids", ",".join(DFMDOCK_HOLDOUT), "--epochs", "2",
                 "--log-every", "10"]
DEMO_METRICS = os.path.join("ckpts", "db5_demo", "metrics.jsonl")
DFMDOCK_METRICS = os.path.join("ckpts", "db5_holdout_dfmdock", "metrics.jsonl")
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-6
# where a failing card-vs-CPU training step is kept: the checkout's
# output directory (chiprun_out/, which .gitignore lists)
TRAIN_FAILURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                                 "train_step_failures")
TRAIN_ABSENT = ("edge_table", "fused_egcl", "fused_egcl_coord", "fused_energy", "edge_bins")
TRAIN_PROFILE_STEPS = 20
# The --no-pool path (9n): one epoch of each protocol, every step logged
# (rounded to 5 decimals, hence NO_POOL_LOG_ABS), select_topk launches a step
NO_POOL_EPOCHS, NO_POOL_LOG_ABS = 1, 1e-5
NO_POOL_SELECTS = {"mlsb": 2, "dfmdock": 1}
DP_CROP = 448  # the dp training step's crop (phase 9k)
# bfloat16 compute (phase 9m): the training CLI at 9g's and 9h's protocols
# cut to one epoch.  One bf16 step on the card against the CPU: each side
# rounds the same cast inputs to bf16, but the two sum the products before
# a cast in another order, so an input that lies at a bf16 rounding tie may
# round up on one side and down on the other, moving by one bf16 step (up to
# 2^-8 of it).  Loss terms are held within that step; gradients within 1e-2
# of each array's largest plus 1e-2 of the largest of all, since the
# backward rounds each cotangent to bf16 at every cast and the second-order
# backward again (tests/test_torch_bf16.py measures the same noise between
# the port and the JAX package on the CPU: loss terms <= 1.7e-3, gradients
# <= 1.2e-2 of the largest of all).  The eager predict forward at bf16 on
# the card against the CPU, every output within one bf16 step of its
# largest, num_clashes exact.
BF16 = ["--compute-dtype", "bfloat16"]
BF16_EPOCHS, BF16_LOG_EVERY = 1, 10
BF16_TRAIN_LOSS_REL, BF16_TRAIN_GRAD_REL, BF16_TRAIN_GRAD_FLOOR = 2.0**-8, 1e-2, 1e-2
BF16_PREDICT_REL = 2.0**-8


def log(msg):
    print(msg, flush=True)


def max_errs(out, ref):
    """(max |out - ref|, that over max |ref|, max |ref|)."""
    err = (out.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return err, err / (scale + 1e-30), scale


def host_ms(fn, calls=50, runs=20):
    """Enqueue time per call of `fn` (ms): the host clock over `calls`
    back-to-back calls with no synchronize, the median of `runs` such runs
    (1,000 calls), each started on an idle device so that no call waits on
    a full launch queue."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_ms(fn, reps=5, inner=10):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


@functools.cache
def port_kernels():
    """The names of the port's own CUDA kernels (csrc/'s __global__ functions)."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    return frozenset(k for f in _build.CSRC.glob("*.cu") for k in pattern.findall(f.read_text()))


def device_ms(fn, calls=10, per_kernel=False, tries=5):
    """Device time per call of `fn` (every kernel it launches, without the
    host's work) from torch.profiler over `calls` calls, after a warm-up;
    with `per_kernel`, {kernel name: ms per call} instead of the sum.  A
    trace is read only if it recorded each of the port's kernels (whose
    launches per call are fixed) a whole multiple of `calls` times, and
    each other kernel so or the same number of times as the trace before it
    (a library call whose launches vary with the data): a trace now and
    then comes back without some of its device records (a check that one
    kernel, such as an elementwise kernel launched several times a call,
    was seen `calls` times passes such a trace, and the main kernel then
    reads low).  An incomplete trace is logged and taken again, up to
    `tries` times; then the reading is NaN (per kernel: empty).  Kernels
    of one name add up."""
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    name = lambda e: e.key.replace("void ", "").replace("(anonymous namespace)::", "").split(
        "(")[0]
    fn()
    torch.cuda.synchronize()
    own = lambda e: name(e).split("::")[-1].split("<")[0] in port_kernels()
    times, last = {}, {}
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and all(e.count % calls == 0 or (not own(e) and last.get(e.key) == e.count)
                          for e in events):
            for e in events:
                times[name(e)] = times.get(name(e), 0.0) + dev_us(e) / 1e3 / calls
            break
        log(f"# device_ms: trace {attempt + 1} of {tries} incomplete (records per kernel over "
            f"{calls} calls: {', '.join(f'{name(e)[:48]} x{e.count}' for e in events)})")
        last = {e.key: e.count for e in events}
    if per_kernel:
        return times
    return sum(times.values()) if times else float("nan")


def reset_counts():
    build_edge_table.launches = 0
    fused_edge_layer.launches = 0
    fused_edge_layer.coord_launches = 0
    fused_edge_layer.bf16_launches = 0
    fused_edge_layer.bf16_coord_launches = 0
    fused_energy.launches = 0
    select_topk.launches = 0
    edge_bins.launches = 0


# each counted kernel by the name the profiler gives its launches (its
# __global__ function and template argument); fused_energy by its second
# kernel, one a call
TRACE_NAMES = (("fused_egcl_bf16_kernel<true>", "fused_egcl_coord_bf16"),
               ("fused_egcl_bf16_kernel<false>", "fused_egcl_bf16"),
               ("fused_egcl_kernel<true>", "fused_egcl_coord"),
               ("fused_egcl_kernel<false>", "fused_egcl"),
               ("edge_table_kernel<true>", "edge_table"),
               ("edge_table_kernel<false>", "edge_bins"),
               ("energy_reduce_kernel", "fused_energy"),
               ("select_topk_kernel", "select_topk"))
WRAPPER_COUNTS = {}  # each run_path run's wrapper counts, by its name


@contextlib.contextmanager
def traced_run(margin_s=0.3):
    """Trace the device's kernels over the block (torch.profiler, device
    records only) after one warm-up step of the profiler, whose records are
    dropped, with `margin_s` of idle time on each side of the block: traces
    that started right before a burst of launches, or ended right after
    the last one, came back without the first or the last kernels.  Yields
    a list that holds the trace's key_averages() once the block has
    ended."""
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: events.extend(p.key_averages())) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()  # the warm-up step ends: the traced step begins
        time.sleep(margin_s)
        yield events
        torch.cuda.synchronize()
        time.sleep(margin_s)
        prof.step()  # the traced step ends: its trace is read


def traced_launches(events) -> dict:
    """Each counted kernel's executions in a torch.profiler trace's
    key_averages() (its device records, a CUDA graph's replays included)."""
    out = dict.fromkeys(launch_counts(), 0)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        hit = next((k for key, k in TRACE_NAMES if key in e.key), None)
        if hit is not None:
            out[hit] += e.count
    return out


def run_path(name, kernels, fn, absent=(), graphs=False, trace=False):
    """Run one main path with the launch counts set to 0 just before it and
    read just after; fail if one of `kernels` did not launch, or one of
    `absent` did.  Returns (fn's result, wall seconds, launches).

    The launches are the kernels the path's samples executed: the wrappers
    count where they are called, which in a capture (sampler/graph.py)
    records a launch and executes nothing, and a replay calls no wrapper;
    so the count is the wrappers' own less what the warm-ups ran and the
    captures recorded, plus what each replay's graph recorded.  With
    `trace` the run is traced (torch.profiler, device records only) and the
    launches are read from the trace, less the warm-ups' (which the
    wrappers counted where they ran); the trace must hold exactly what the
    wrappers and the graphs account for, or the phase fails.  A traced
    run's wall includes the tracing.  With `graphs` (a training CLI run,
    whose result's "graph" says what its captured steps launched) the
    training graphs' captures and replays are accounted alike."""
    reset_counts()
    graph_mod.reset_totals()
    torch.cuda.synchronize()
    with traced_run() if trace else contextlib.nullcontext() as events:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = launch_counts()
    WRAPPER_COUNTS[name] = dict(counted)
    sampled = graph_mod.totals()
    launches = {k: v - sampled.warmup_launches.get(k, 0) - sampled.captured_launches.get(k, 0)
                + sampled.replayed_launches.get(k, 0) for k, v in counted.items()}
    if sampled.captures or sampled.replays:
        log(f"# {name}: {sampled.captures} sample graph(s) captured in "
            f"{sampled.capture_s:.3f} s, {sampled.replays} replays; the wrappers counted "
            f"{json.dumps({k: v for k, v in counted.items() if v})} (the warm-ups ran "
            f"{json.dumps(sampled.warmup_launches)}, the captures recorded "
            f"{json.dumps(sampled.captured_launches)}, the replays ran "
            f"{json.dumps(sampled.replayed_launches)})")
    if trace:
        executed = traced_launches(events)
        accounted = {k: v + sampled.warmup_launches.get(k, 0) for k, v in launches.items()}
        if executed != accounted:
            raise AssertionError(f"{name}: the trace executed {json.dumps(executed)}, the "
                                 f"wrappers and the graphs account for {json.dumps(accounted)}")
        launches = {k: v - sampled.warmup_launches.get(k, 0) for k, v in executed.items()}
        log(f"# {name}: traced, the trace executed {json.dumps({k: v for k, v in executed.items() if v})}")
    if graphs:
        g = result["graph"]
        for k in launches:
            launches[k] += g["replayed_launches"].get(k, 0) - g["captured_launches"].get(k, 0)
        log(f"# {name}: {g['captures']} captured graph(s), {g['replays']} replays; the "
            f"wrappers counted {json.dumps(counted)} (the captures' "
            f"{json.dumps(g['captured_launches'])} launched nothing; the replays launched "
            f"{json.dumps(g['replayed_launches'])})")
    for k in kernels:
        if launches[k] == 0:
            raise AssertionError(f"the {name} run launched no {k} kernel")
    for k in absent:
        if launches[k] != 0:
            raise AssertionError(f"the {name} run launched {launches[k]} {k} kernels")
    log(f"# launches in the {name} run{' (traced)' if trace else ''}: {json.dumps(launches)}")
    return result, wall, launches


def sample_forwards(steps, integrator="em"):
    """The ScoreNet forwards of one sample: one a step (two with Heun's
    corrector) and the final full forward."""
    return steps * (2 if integrator == "heun" else 1) + 1


def expected_launches(forwards, bf16=False, depth=ModelConfig().depth):
    """Each kernel's launches over `forwards` forwards of the mlsb ScoreNet
    on a kernel route, whatever the pose count (every kernel covers all the
    poses of a forward in one launch): a forward's depth - 1 agg-only
    fused_egcl layers and its coord layer (in the bf16 mode on the bf16
    route), one edge table and one select_topk; one fused_energy (a
    sample's final forward)."""
    agg, coord = (("fused_egcl_bf16", "fused_egcl_coord_bf16") if bf16
                  else ("fused_egcl", "fused_egcl_coord"))
    out = dict.fromkeys(launch_counts(), 0)
    out.update({"edge_table": forwards, "select_topk": forwards, agg: (depth - 1) * forwards,
                coord: forwards, "fused_energy": 1})
    return out


def check_launches(label, got, want):
    """Fail unless a run's launch counts are exactly `want`'s."""
    if dict(got) != want:
        raise AssertionError(f"{label}: launches {json.dumps(dict(got))}, expected "
                             f"{json.dumps(want)}")


CARD = ["card not read"]  # the card's name and power limit, as nvidia-smi gives them


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"# card: {smi}")
    log(smi)
    CARD[0] = smi
    return smi


def edge_inputs(raw, n_pad, num_poses, seed, device):
    """num_poses random start poses of one complex, their edges (from the
    port's own selection) and the batch they come from."""
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=n_pad), device)
    gen = torch.Generator(device).manual_seed(seed)
    pos, _, _ = randomize_pose(gen, batch["pos"], batch["lig_mask"],
                               batch["node_mask"], SamplerConfig(), num_poses)
    pos = pos.contiguous()
    idx, edge_mask = select_edges(pairwise_ca_dist(pos), batch["node_mask"],
                                  generator=gen)
    return batch, pos, idx, edge_mask


def check_bins(ebin_k, ebin_p, pos, idx, valid):
    """Bins of kernel and plain agree except at boundary ties.  Returns
    (ties on valid edges, mismatches on masked edges)."""
    dist, omega, theta, phi, _ = sixd_values_at(pos, idx)
    near22 = (dist - 22.0).abs() < TIE_TOL[E_DB]  # angle bins zeroed there
    fams = {E_DB: (dist, DIST_BOUNDARIES), E_OB: (omega, ANGLE_BOUNDARIES),
            E_TB: (theta, ANGLE_BOUNDARIES), E_PB: (phi, PHI_BOUNDARIES)}
    if not torch.equal(ebin_k[..., E_RP], ebin_p[..., E_RP]):  # relpos: exact
        raise AssertionError("edge_table relpos class differs from the plain version")
    ties = masked = 0
    for col, (val, bounds) in fams.items():
        mism = ebin_k[..., col] != ebin_p[..., col]
        b = torch.tensor(bounds, device=val.device)
        near = (val[..., None] - b).abs().min(-1).values < TIE_TOL[col]
        if col != E_DB:
            near = near | near22
        bad = mism & valid & ~near
        if bad.any():
            raise AssertionError(
                f"edge_table bin column {col}: {int(bad.sum())} mismatches away "
                "from any boundary on valid edges")
        ties += int((mism & valid).sum())
        masked += int((mism & ~valid).sum())
    return ties, masked


def fused_inputs(idx, edge_mask, ebin, egeo, c, seed, device):
    """Seeded a, B, tables and weights of one EGCL layer at width c."""
    g = torch.Generator().manual_seed(seed)
    p, n = ebin.shape[:2]
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(device)
    w = 1.0 / math.sqrt(c)
    a, B = r(p, n, c), r(p, n, c)
    t_sp, t_p = r(SPATIAL_DIM, c, scale=0.3), r(NUM_RELPOS_CLASSES, c, scale=0.3)
    args = (idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, r(c, scale=0.01), r(c, c, scale=w),
            r(c, scale=0.1), r(c, scale=w), r(1, scale=0.1))
    coord = (r(c, c, scale=w), r(c, scale=0.1), r(c, scale=w))
    return args, coord


def energy_inputs(batch, pos, c, seed, device):
    """Seeded hr, hl [P, N, C], the receptor x ligand pair mask within 20 A
    of these poses (the last pose's all masked), and a LayerNorm affine and
    w2 off their init values."""
    g = torch.Generator().manual_seed(seed)
    p, n = pos.shape[:2]
    r = lambda *s, scale=1.0, shift=0.0: (torch.randn(s, generator=g) * scale + shift).to(device)
    valid = batch["node_mask"].to(torch.float32)
    lig = batch["lig_mask"] * valid
    pair = ((valid - lig)[:, None] * lig[None, :]) * (pairwise_ca_dist(pos) < 20.0)
    pair[-1] = 0.0
    return (r(p, n, c), r(p, n, c), pair.contiguous(), r(c, scale=0.3, shift=1.0),
            r(c, scale=0.1), r(c, scale=0.1))


def check_bin_values(device):
    """The edge kernel's bin code (csrc/edge_table.cu's test entry) against
    the plain count(x > b), exact: every boundary of each family, its
    float32 neighbour on each side, NaN, +-inf and +-0."""
    for family, bounds in enumerate(BIN_FAMILIES):
        b = np.array(bounds, np.float32)
        x = torch.from_numpy(np.concatenate([
            b, np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
            np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)]))
        got = bin_values(x.to(device), family).cpu()
        if not torch.equal(got, bin_values(x, family)):
            raise AssertionError(f"edge_table bin code, family {family}: "
                                 f"{int((got != bin_values(x, family)).sum())} of {len(x)} "
                                 "values in another bin than the plain count")
    log("# edge_table bin code: every boundary, its neighbours, NaN, +-inf and +-0 in the "
        "plain count's bin (three families)")


def kernel_phase(raw, device):
    """Every kernel against its plain version on the card."""
    errs = {name: 0.0 for name in SOURCES}
    check_bin_values(device)
    cases = [(P, N_PAD, s, None) for s in (0, 1, 2)]
    # small masked graph: 40 valid nodes of 1AVX padded to 64
    small = dict(raw)
    for key in ("rec_x", "rec_pos"):
        small[key] = raw[key][:24]
    for key in ("lig_x", "lig_pos"):
        small[key] = raw[key][:16]
    small["rec_seq"], small["lig_seq"] = raw["rec_seq"][:24], raw["lig_seq"][:16]
    cases.append((2, 64, 3, small))
    main_inputs = None
    for num_poses, n_pad, seed, cx in cases:
        case_inputs = kernel_case(raw, device, errs, num_poses, n_pad, seed, cx)
        if main_inputs is None:
            main_inputs = case_inputs
    select_cases(raw, device, errs)
    energy_cases(raw, device, errs)
    return errs, main_inputs


def kernel_case(raw, device, errs, num_poses, n_pad, seed, cx=None):
    """One case of the kernel checks: num_poses random poses of `cx` (else
    1AVX) padded to n_pad, their edges from the port's own selection; the
    edge table and its bins-only mode, select_topk (with a forced-tie case
    at seed 0 of 1AVX), fused_energy and both fused_egcl modes, each against
    its plain version, their largest errors into `errs`.  Returns the
    case's inputs (the edge table's, the layer's, the selection's)."""
    batch, pos, idx, edge_mask = edge_inputs(cx or raw, n_pad, num_poses, seed, device)
    args = (idx, pos, batch["res_id"], batch["asym_id"])
    ebin_k, egeo_k = build_edge_table(*args, normalize=True)
    ebin_p, egeo_p = build_edge_table_plain(*args, normalize=True)
    ebin_b = edge_bins(*args)
    torch.cuda.synchronize()
    valid = edge_mask > 0.5
    ties, masked = check_bins(ebin_k, ebin_p, pos, idx, valid)
    if not torch.isfinite(egeo_k).all():
        raise AssertionError("edge_table wrote non-finite geometry")
    abs_g, rel_g, _ = max_errs(egeo_k[valid], egeo_p[valid])
    if rel_g > F32_REL:
        raise AssertionError(f"edge_table geometry rel err {rel_g:.3e}")
    errs["edge_table"] = max(errs["edge_table"], abs_g)
    log(f"# edge_table P={num_poses} N={n_pad} seed={seed}: valid edges "
        f"{int(valid.sum())}/{valid.numel()}, bin ties {ties}, masked-edge bin "
        f"diffs {masked}, geometry max abs {abs_g:.3e} rel {rel_g:.3e}")
    # bins-only mode: the same bits as the table's bins on every edge,
    # and the plain version's except at boundary ties
    errs["edge_bins"] = max(errs["edge_bins"],
                            float((ebin_b - ebin_k).abs().max()))
    if not torch.equal(ebin_b, ebin_k):
        raise AssertionError(f"edge_bins differs from build_edge_table's ebin on "
                             f"{int((ebin_b != ebin_k).sum())} entries")
    ties_b, masked_b = check_bins(ebin_b, ebin_p, pos, idx, valid)
    log(f"# edge_bins P={num_poses} N={n_pad} seed={seed}: equal to the table's "
        f"ebin; against plain: bin ties {ties_b}, masked-edge bin diffs {masked_b}")

    # edge selection on these poses with a fresh Gumbel draw: exact
    dist = pairwise_ca_dist(pos)
    y = select_y(dist, batch["node_mask"], sample_gumbel(
        dist.shape, torch.Generator(device).manual_seed(100 + seed), device))
    sel_cases = [("", dist, y)]
    if cx is None and seed == 0:  # distances rounded to 4 A: ties
        tied = torch.round(dist / 4.0) * 4.0
        sel_cases.append((" ties", tied, select_y(tied, batch["node_mask"], 0.0 * y)))
    for tag, d, yy in sel_cases:
        check_select(errs, f"{tag} P={num_poses} N={n_pad} seed={seed}", d, yy,
                     batch["node_mask"])
    check_energy(errs, f"P={num_poses} N={n_pad} seed={seed}",
                 energy_inputs(batch, pos, 256, seed, device))

    egeo_l = egeo_k
    if cx is not None:  # masked edges' geometry poisoned: selection, not * 0
        egeo_l = egeo_k.clone()
        egeo_l[~valid] = float("nan")
    layer_args, coord = fused_inputs(idx, edge_mask, ebin_k, egeo_l, 256, seed, device)
    agg_k = kernel_layer(layer_args)
    agg_c, trans_k = kernel_layer(layer_args, coord)
    agg_k2 = kernel_layer(layer_args)
    agg_c2, trans_k2 = kernel_layer(layer_args, coord)
    agg_p = fused_edge_layer_plain(*layer_args)
    agg_cp, trans_p = fused_edge_layer_plain(*layer_args, coord)
    torch.cuda.synchronize()
    if not (torch.equal(agg_k, agg_k2) and torch.equal(agg_c, agg_c2)
            and torch.equal(trans_k, trans_k2)):
        raise AssertionError("fused_egcl: two launches on the same inputs differ")
    for name, out, ref in (("fused_egcl agg", agg_k, agg_p),
                           ("fused_egcl_coord agg", agg_c, agg_cp),
                           ("fused_egcl_coord trans", trans_k, trans_p)):
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        a_err, r_err, _ = max_errs(out, ref)
        if r_err > F32_REL:
            raise AssertionError(f"{name}: rel err {r_err:.3e} > {F32_REL}")
        key = name.split()[0]
        errs[key] = max(errs[key], a_err)
        log(f"# {name} P={num_poses} N={n_pad} seed={seed}"
            f"{' (masked geometry NaN)' if cx is not None else ''}: max abs "
            f"{a_err:.3e} rel {r_err:.3e}, two launches bit-equal")
    check_egcl_bf16(errs, f"P={num_poses} N={n_pad} seed={seed}"
                    f"{' (masked geometry NaN)' if cx is not None else ''}",
                    layer_args, coord)
    return {"table": args, "layer": layer_args, "coord": coord,
            "select": (dist, y, batch["node_mask"])}


def kernel_layer(layer_args, coord=None, dtype=None):
    """fused_edge_layer's kernel on fused_edge_layer_plain's arguments
    (`coord` its coord_params): the layer's t_sp, t_p, w_l1 and w_c0
    prepared for the mode (prepare_layer), then launched."""
    w_c0 = None if coord is None else coord[0]
    prepared = prepare_layer(*layer_args[6:8], layer_args[9], w_c0, dtype)
    return fused_edge_layer(*layer_args, coord, dtype=dtype, prepared=prepared)


def check_egcl_bf16(errs, tag, layer_args, coord):
    """fused_egcl's single-pass bf16 mode, both variants, against its plain
    version at dtype bf16: rel BF16_KERNEL_REL, finite, two launches
    bit-equal; the distance to the float32 mode's output is printed."""
    bf16 = torch.bfloat16
    outs = [kernel_layer(layer_args, dtype=bf16), kernel_layer(layer_args, coord, dtype=bf16)]
    again = [kernel_layer(layer_args, dtype=bf16), kernel_layer(layer_args, coord, dtype=bf16)]
    plain = [fused_edge_layer_plain(*layer_args, dtype=bf16),
             fused_edge_layer_plain(*layer_args, coord, dtype=bf16)]
    f32 = [fused_edge_layer_plain(*layer_args), fused_edge_layer_plain(*layer_args, coord)]
    torch.cuda.synchronize()
    if not (torch.equal(outs[0], again[0])
            and all(torch.equal(a, b) for a, b in zip(outs[1], again[1]))):
        raise AssertionError("fused_egcl bf16: two launches on the same inputs differ")
    for name, out, ref, ref32 in (
            ("fused_egcl_bf16 agg", outs[0], plain[0], f32[0]),
            ("fused_egcl_coord_bf16 agg", outs[1][0], plain[1][0], f32[1][0]),
            ("fused_egcl_coord_bf16 trans", outs[1][1], plain[1][1], f32[1][1])):
        a_err, r_err, _ = max_errs(out, ref)
        if r_err > BF16_KERNEL_REL or not torch.isfinite(out).all():
            raise AssertionError(f"{name} {tag}: rel err {r_err:.3e} > {BF16_KERNEL_REL}")
        key = name.split()[0]
        errs[key] = max(errs[key], a_err)
        log(f"# {name} {tag}: max abs {a_err:.3e} rel {r_err:.3e} against the plain bf16 "
            f"version (limit {BF16_KERNEL_REL}), two launches bit-equal; the float32 mode's "
            f"plain output lies rel {max_errs(ref32, ref)[1]:.3e} away")


def check_select(errs, tag, dist, y, node_mask, knn=20, sample_size=40):
    """select_topk against select_topk_plain on the same keys: exact."""
    idx_s, em_s = select_topk(dist, y, node_mask, knn, sample_size)
    idx_sp, em_sp = select_topk_plain(dist, y, node_mask, knn, sample_size)
    torch.cuda.synchronize()
    errs["select_topk"] = max(errs["select_topk"], float((idx_s - idx_sp).abs().max()),
                              float((em_s - em_sp).abs().max()))
    if not (torch.equal(idx_s, idx_sp) and torch.equal(em_s, em_sp)):
        raise AssertionError(
            f"select_topk{tag} sample_size={sample_size} differs from its plain version: "
            f"{int((idx_s != idx_sp).sum())} idx, {int((em_s != em_sp).sum())} mask")
    log(f"# select_topk{tag} sample_size={sample_size}: idx and edge_mask equal to "
        f"plain ({int(em_s.sum())} valid edges)")


def select_cases(raw, device, errs):
    """select_topk at the sweep's buckets (1AVX padded to 512 and 768, P
    poses, sample_size 40 and 0) and on one 4096-node random-walk chain
    (4000 valid nodes): exact against the plain version."""
    for n_pad in (512, 768):
        batch = batch_to_tensors(complex_to_batch(raw, pad_to=n_pad), device)
        gen = torch.Generator(device).manual_seed(n_pad)
        pos, _, _ = randomize_pose(gen, batch["pos"], batch["lig_mask"],
                                   batch["node_mask"], SamplerConfig(), P)
        dist = pairwise_ca_dist(pos.contiguous())
        y = select_y(dist, batch["node_mask"], sample_gumbel(dist.shape, gen, device))
        for sample_size in (40, 0):
            check_select(errs, f" P={P} N={n_pad}", dist, y, batch["node_mask"],
                         sample_size=sample_size)
    n = 4096
    g = torch.Generator().manual_seed(4096)
    ca = torch.cumsum(torch.randn(n, 3, generator=g) * 2 + torch.tensor([3.8, 0.0, 0.0]),
                      0).to(device)
    dist = ((ca[:, None] - ca[None]) ** 2).sum(-1).sqrt()[None].contiguous()
    node_mask = torch.arange(n, device=device) < 4000
    y = select_y(dist, node_mask, sample_gumbel(
        dist.shape, torch.Generator(device).manual_seed(1), device))
    check_select(errs, f" chain P=1 N={n}", dist, y, node_mask)


def check_energy(errs, tag, args):
    """fused_energy against fused_energy_plain: rel F32_REL, finite, two
    launches bit-equal, the last (all-masked) pose exactly 0."""
    e_k = fused_energy(*args)
    e_k2 = fused_energy(*args)
    e_p = fused_energy_plain(*args)
    torch.cuda.synchronize()
    a_err, r_err, _ = max_errs(e_k, e_p)
    if r_err > F32_REL or not torch.isfinite(e_k).all():
        raise AssertionError(f"fused_energy {tag}: rel err {r_err:.3e} > {F32_REL}")
    if float(e_k[-1]) != 0.0 or not torch.equal(e_k, e_k2):
        raise AssertionError(f"fused_energy {tag}: the all-masked pose is not 0, or two "
                             "launches differ")
    errs["fused_energy"] = max(errs["fused_energy"], a_err)
    mask = args[2]
    b_ms, b_by = energy_bound(args)
    log(f"# fused_energy {tag} C={args[0].shape[-1]}: kept pairs {int((mask != 0).sum())} "
        f"({100 * float((mask != 0).float().mean()):.2f}%), max abs {a_err:.3e} rel "
        f"{r_err:.3e}, all-masked pose 0, two launches bit-equal; bound {b_ms:.4f} ms by {b_by}")


def energy_cases(raw, device, errs):
    """fused_energy on the native 1AVX interface mask (receptor x ligand
    within 20 A, ~0.6% of the padded pairs; P poses, C = 256), on a dense
    30% mask (4 poses) and at C = 1024 (4 poses, the interface mask).  The
    reranker run's final poses (phase 8) keep ~2%."""
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=N_PAD), device)
    native = lambda p: batch["pos"][None].expand(p, -1, -1, -1).contiguous()
    check_energy(errs, f"interface P={P} N={N_PAD}", energy_inputs(batch, native(P), 256, 11,
                                                                    device))
    hr, hl, _, ln_g, ln_b, w2 = energy_inputs(batch, native(4), 256, 12, device)
    g = torch.Generator().manual_seed(13)
    dense = (torch.rand(4, N_PAD, N_PAD, generator=g) < 0.3).float().to(device)
    dense[-1] = 0.0
    check_energy(errs, f"dense 30% P=4 N={N_PAD}", (hr, hl, dense, ln_g, ln_b, w2))
    check_energy(errs, f"interface P=4 N={N_PAD}",
                 energy_inputs(batch, native(4), 1024, 14, device))


# the kernel wrappers as the models call them: (kernel, module that calls
# it, name there, wrapper, plain version)
KERNEL_SITES = (
    ("select_topk", edges_mod, "select_topk", select_topk, select_topk_plain),
    ("edge_table", egnn_mod, "build_edge_table", build_edge_table, build_edge_table_plain),
    ("edge_bins", egnn_mod, "edge_bins", edge_bins, edge_bins_plain),
    ("fused_egcl", egnn_mod, "fused_edge_layer", fused_edge_layer, fused_edge_layer_plain),
    ("fused_energy", score_net_mod, "fused_energy", fused_energy, fused_energy_plain),
)


def _parts(out):
    return out if isinstance(out, tuple) else (out,)


@contextlib.contextmanager
def recording_kernels():
    """Every kernel call the models make inside the block, recorded as
    (kernel, args, kwargs, a copy of its outputs) in call order."""
    calls = []

    def recorder(name, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, tuple(o.clone() for o in _parts(out))))
            return out
        return rec

    for name, module, attr, fn, _ in KERNEL_SITES:
        setattr(module, attr, recorder(name, fn))
    try:
        yield calls
    finally:
        for _, module, attr, fn, _ in KERNEL_SITES:
            setattr(module, attr, fn)


def diagnose_kernels(calls):
    """Relaunch each recorded kernel call of a forward twice on its recorded
    inputs and run its plain version: is the forward's own output what a
    relaunch gives (bit for bit), are two relaunches equal, and how far is
    each from the plain version.  Prints one line per call and output and
    returns them as dicts."""
    sites = {name: (fn, plain) for name, _, _, fn, plain in KERNEL_SITES}
    layer, rows = 0, []
    for name, args, kwargs, recorded in calls:
        fn, plain = sites[name]
        with torch.no_grad():
            again, twice = _parts(fn(*args, **kwargs)), _parts(fn(*args, **kwargs))
            # the plain version computes from the raw weights (no `prepared`)
            ref = _parts(plain(*args, **{k: v for k, v in kwargs.items() if k != "prepared"}))
        torch.cuda.synchronize()
        tag = name
        if name == "fused_egcl":
            tag = f"fused_egcl layer {layer}" + (" (coord)" if len(recorded) == 2 else "")
            layer += 1
        for i, (r, a, b, p) in enumerate(zip(recorded, again, twice, ref)):
            a_err, r_err, _ = max_errs(r.cpu(), p.cpu())
            row = {"call": tag, "output": i, "recorded_is_relaunch": torch.equal(r, a),
                   "relaunch_diff": float((r.double() - a.double()).abs().max()),
                   "relaunches_equal": torch.equal(a, b), "plain_abs": a_err, "plain_rel": r_err}
            rows.append(row)
            log(f"#   diagnose {tag} output {i}: recorded == relaunch "
                f"{row['recorded_is_relaunch']} (max |diff| {row['relaunch_diff']:.3e}), two "
                f"relaunches equal {row['relaunches_equal']}, recorded vs plain max abs "
                f"{a_err:.3e} rel {r_err:.3e}")
    return rows


def parity_errors(outputs, o_k, o_p, f32=True):
    """{output: (max abs, rel, ok)} of a kernel-path forward's outputs o_k
    against the plain path's o_p (phase 4's tolerances; with `f32` also
    F32_PARITY_REL), num_clashes exact."""
    errs = {}
    for name in outputs:
        tol = PARITY_ALIAS.get(name, name)
        a_err, r_err, scale = max_errs(o_k[name].cpu(), o_p[name].cpu())
        ok = ((r_err < PARITY_TOL[tol] or a_err < PARITY_ABS[tol] < scale)
              and (r_err <= F32_PARITY_REL or not f32))
        errs[name] = (a_err, r_err, ok)
    same = torch.equal(o_k["num_clashes"].cpu(), o_p["num_clashes"].cpu())
    errs["num_clashes"] = (0.0 if same else 1.0, 0.0 if same else 1.0, same)
    return errs


def parity_check(label, outputs, net_k, net_p, batch, pos, t, kw_k, kw_p, f32=True):
    """One kernel-path forward (card) against the plain path (CPU): every
    output's error is printed; on a failure each kernel call of the forward
    is diagnosed (diagnose_kernels) before the check fails.  `f32`: the
    float32 route's bound F32_PARITY_REL applies too.  Returns (the
    forward's kernel calls, parity_errors)."""
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    with torch.no_grad(), recording_kernels() as calls:
        o_k = net_k(batch, pos, t, **kw_k)
        torch.cuda.synchronize()
    with torch.no_grad():
        o_p = net_p(cpu(batch), pos.cpu(), t, **kw_p)
    errs = parity_errors(outputs, o_k, o_p, f32)
    for name, (a_err, r_err, ok) in errs.items():
        log(f"# parity {label} t={t} {name}: max abs {a_err:.3e} rel {r_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
    failed = [name for name, (_, _, ok) in errs.items() if not ok]
    if failed:
        log(f"# parity {label} t={t} failed on {failed}: the forward's "
            f"{len(calls)} kernel calls, each relaunched and against its plain version:")
        diagnose_kernels(calls)
        raise AssertionError(f"parity failed: {label} t={t} {failed}")
    return calls, errs


def parity_inputs(raw, device):
    """Phase 4's inputs: 1AVX padded to N_PAD, its native pose and one random
    pose, their injected edges and one Gumbel draw for both."""
    batch, pos, idx, edge_mask = edge_inputs(raw, N_PAD, 2, 7, device)
    native = batch["pos"][None]
    pos = torch.cat([native, pos[:1]]).contiguous()  # native + one random pose
    idx_n, mask_n = select_edges(pairwise_ca_dist(native), batch["node_mask"],
                                 generator=torch.Generator(device).manual_seed(8))
    idx = torch.cat([idx_n, idx[:1]]).contiguous()
    edge_mask = torch.cat([mask_n, edge_mask[:1]]).contiguous()
    n = pos.shape[1]
    gumbel = sample_gumbel((2, n, n), torch.Generator(device).manual_seed(9), device)
    return batch, pos, (idx, edge_mask), gumbel


def injected(inject, edges, gumbel):
    """(card kwargs, CPU kwargs) of a forward on injected edges or noise."""
    if inject == "edges":
        return dict(edges=edges), dict(edges=tuple(e.cpu() for e in edges))
    return dict(gumbel=gumbel), dict(gumbel=gumbel.cpu())


def parity_phase(raw, device):
    """ScoreNet through the kernels (card) vs through the plain versions
    (CPU), same seeded weights, full forwards, on the float32 kernel route:
    fast(f32) and fast(f32, edge_table_kernel=False) on the same injected
    edges, fast(f32) selecting its own edges (select_topk on each side) from
    the same injected Gumbel noise."""
    batch, pos, edges, gumbel = parity_inputs(raw, device)
    routes = (
        ("fast(f32)", FAST_F32, (0.1, 0.5, 0.9), "edges"),
        ("fast(f32) selecting", FAST_F32, (0.5,), "gumbel"),
        ("fast(f32, edge_table_kernel=False)",
         dataclasses.replace(FAST_F32, edge_table_kernel=False), (0.5,), "edges"),
    )
    for label, mcfg, ts, inject in routes:
        cfg = DFMDockConfig(model=mcfg)
        net_k = load_model(None, cfg, device, seed=0)
        net_p = load_model(None, cfg, torch.device("cpu"), seed=0)
        kw_k, kw_p = injected(inject, edges, gumbel)
        reset_counts()
        for t in ts:
            parity_check(label, SCORE_NET_OUTPUTS, net_k, net_p, batch, pos, t, kw_k, kw_p)
        torch.cuda.synchronize()
        log(f"# parity {label}: kernel launches {json.dumps(launch_counts())}")


def dock_phase(out_root):
    """The dock CLI in-process: a warm-up of each route, then the timed and
    the traced (counted) runs of the CLI's default (fast(), bf16) and of the
    float32 kernel route (the API's `model`).  Returns {route: (the traced
    run's launches, the timed run's denoising steps/s)}."""
    result = {}
    for route, model, kernels, absent in (("bf16", None, DOCK_KERNELS_BF16, BF16_ABSENT),
                                          ("f32", FAST_F32, DOCK_KERNELS, F32_ABSENT)):
        dock.main(["--npz", NPZ, "--num-samples", str(P), "--num-steps", "2",
                   "--out-dir", os.path.join(out_root, f"warm_{route}")], model)
        out = os.path.join(out_root, f"dock_{route}")
        label = "dock" if model is None else "f32 dock"
        argv = ["--npz", NPZ, "--num-samples", str(P), "--num-steps", str(STEPS)]
        rows, wall, _ = run_path(f"{label} (timed)", kernels, lambda: dock.main(
            argv + ["--out-dir", out], model), absent)
        _, _, launches = run_path(label, kernels, lambda: dock.main(
            argv + ["--out-dir", out + "_traced"], model), absent, trace=True)
        with open(os.path.join(out, "metrics.csv")) as f:
            csv_rows = list(csv.DictReader(f))
        if len(csv_rows) != P or len(rows) != P:
            raise AssertionError(f"expected {P} CSV rows, got {len(csv_rows)}")
        energies = np.array([float(r["energy"]) for r in csv_rows])
        if not np.isfinite(energies).all():
            raise AssertionError("non-finite energies in the CSV")
        if not glob.glob(os.path.join(out, "1AVX_*.pdb")):
            raise AssertionError("no PDB written")
        steps_s = P * STEPS / wall
        log(f"# {label} 1AVX P={P} steps={STEPS} ({route} kernel route): wall {wall:.3f} s, "
            f"{steps_s:.2f} denoising steps/s, {wall / P:.4f} s per docked pose, "
            f"best DockQ {max(float(r['DockQ']) for r in csv_rows):.4f}")
        log(f"# {label} launches per forward: "
            f"{({k: v / (STEPS + 1) for k, v in launches.items()})}")
        result[route] = (launches, steps_s)
    return result


def sampler_phase(raw, device, reps=3):
    """Denoising steps/s over EMSampler.sample alone: P poses x STEPS steps
    and the final full forward, a synchronize on each side, after a
    warm-up; the median of `reps` runs, on the float32 kernel route and on
    fast() (bf16).  Returns {route: steps/s}."""
    rates = {}
    for route, mcfg in (("f32", FAST_F32), ("bf16", ModelConfig.fast())):
        cfg = DFMDockConfig(model=mcfg, sampler=SamplerConfig(num_steps=STEPS))
        sampler = build_sampler(load_model(None, cfg, device), cfg)
        batch = batch_to_tensors(complex_to_batch(raw), device)
        gen = torch.Generator(device).manual_seed(0)
        sampler.sample(batch, P, gen)
        stats = sampler.graphs.stats
        log(f"# sampler {route}: {stats.captures} graph captured in {stats.capture_s:.3f} s")
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sampler.sample(batch, P, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not torch.isfinite(out["energy"]).all():
                raise AssertionError("sampler: non-finite energies")
        wall = statistics.median(walls)
        rates[route] = P * STEPS / wall
        log(f"# sampler 1AVX P={P} steps={STEPS} ({route} kernel route): {rates[route]:.2f} "
            f"denoising steps/s (median of {[round(w, 4) for w in walls]} s)")
    return rates


def profile_phase(raw, device, steps=10, top=12, lineage="mlsb", ckpt=None, mcfg=FAST_F32):
    """Device time by kernel over one sample of P poses x `steps` steps (+ the
    final full forward) of a lineage's model at `mcfg` (the float32 kernel
    route, or fast()), after a warm-up sample."""
    from torch.profiler import ProfilerActivity, profile

    cfg = DFMDockConfig(model=mcfg, sampler=SamplerConfig(num_steps=steps))
    lineage_tag = f"{lineage} {mcfg.compute_dtype}"
    sampler = build_sampler(load_model(ckpt, cfg, device, lineage=lineage), cfg)
    batch = batch_to_tensors(complex_to_batch(raw), device)
    gen = torch.Generator(device).manual_seed(0)
    sampler.sample(batch, P, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.sample(batch, P, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        log("# profile: the profiler recorded no device time (not measured)")
        return
    log(f"# profile {lineage_tag} P={P} steps={steps}+final forward: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"#   {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / 1e3 / busy_ms:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")
    # device time alone, without the wrapper's host work that CUDA events
    # around the wrapper also see when the kernel is short
    for name, key in (("edge_table", "edge_table_kernel<true>"),
                      ("select_topk", "select_topk_kernel"),
                      ("fused_egcl", "fused_egcl_kernel<false>"),
                      ("fused_egcl_coord", "fused_egcl_kernel<true>"),
                      ("fused_egcl_bf16", "fused_egcl_bf16_kernel<false>"),
                      ("fused_egcl_coord_bf16", "fused_egcl_bf16_kernel<true>"),
                      ("fused_energy", "energy_")):
        hits = [e for e in kernels if key in e.key]
        launches = sum(e.count for e in hits if "reduce" not in e.key)
        if launches:
            log(f"# profile {lineage_tag} {name}: {sum(map(dev_us, hits)) / 1e3 / launches:.4f} ms "
                f"device time per launch (x{launches})")


def read_csv(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def rank_phase(out_root):
    """The dock CLI ranking its poses on the float32 kernel route: --rank-by
    reranker (features at 5 t x 4 draws, one captured graph a t) and
    --energy-draws 4.  Returns the reranker run's launches and the inputs
    of its sample's fused_energy call (the final forward at the final
    poses: the capture's call, its inputs cloned inside the graph, so the
    replay fills them), on which the kernel line times fused_energy and
    counts its bound."""
    if not os.path.exists(dock.DEFAULT_RERANKER):
        raise AssertionError(f"reranker weights missing: {dock.DEFAULT_RERANKER}")
    result, calls = None, []

    def recording(*args):
        # a sample's and a draw's forwards run as replays of captured graphs:
        # the call recorded is the capture's, whose clones the replays fill
        if torch.cuda.is_current_stream_capturing():
            calls.append(tuple(a.clone() for a in args))
        return fused_energy(*args)

    for label, flags, added, energy_launches in (
            ("rank-by reranker", ["--rank-by", "reranker"], ["rerank_score"],
             1 + RERANK_T * RERANK_DRAWS),
            ("energy-draws 4", ["--energy-draws", str(ENERGY_DRAWS)],
             ["energy_first_draw", "icons", "snorm"], 1 + ENERGY_DRAWS)):
        out = os.path.join(out_root, label.replace(" ", "_"))
        score_net_mod.fused_energy = recording if result is None else fused_energy
        try:
            _, wall, launches = run_path(label, DOCK_KERNELS, lambda: dock.main(
                ["--npz", NPZ, "--num-samples", str(P), "--num-steps", str(STEPS),
                 "--out-dir", out] + flags, FAST_F32), F32_ABSENT)
        finally:
            score_net_mod.fused_energy = fused_energy
        if launches["fused_energy"] != energy_launches:
            raise AssertionError(f"{label}: {launches['fused_energy']} fused_energy "
                                 f"launches, expected {energy_launches}")
        cols, rows = read_csv(os.path.join(out, "metrics.csv"))
        if len(rows) != P or cols[-len(added):] != added:
            raise AssertionError(f"{label}: {len(rows)} rows with columns {cols}")
        vals = np.array([[float(r[c]) for c in added + ["energy"]] for r in rows])
        if not np.isfinite(vals).all():
            raise AssertionError(f"{label}: non-finite ranking scores")
        log(f"# dock 1AVX {label} P={P} steps={STEPS}: wall {wall:.3f} s, "
            f"{P * STEPS / wall:.2f} denoising steps/s, {launches['fused_energy']} "
            f"fused_energy launches")
        if result is None:
            result = launches
    kept = [float(c[2].sum()) for c in calls]
    log(f"# rank-by reranker: fused_energy kept pairs per captured call (P={P}, N="
        f"{calls[0][2].shape[-1]}): first {kept[0]:.0f}, min {min(kept):.0f}, "
        f"max {max(kept):.0f} over {len(kept)} calls (the sample's graph and one graph a "
        f"t, each read after its last replay)")
    return result, calls[0]


def sweep_phase(out_root):
    """The sweep CLI over SWEEP_IDS on the float32 kernel route, one complex
    per call (the second through --resume): wall per complex and the rows
    written."""
    out_csv = os.path.join(out_root, "sweep.csv")
    for i, cid in enumerate(SWEEP_IDS):
        ids = ",".join(SWEEP_IDS[: i + 1])
        _, wall, _ = run_path(f"sweep {cid}", DOCK_KERNELS, lambda: sweep.main(
            ["--ids", ids, "--num-samples", str(P), "--out-csv", out_csv]
            + (["--resume"] if i else []), FAST_F32), F32_ABSENT)
        log(f"# sweep {cid} P={P} steps={STEPS}: wall {wall:.3f} s")
    _, rows = read_csv(out_csv)
    got = [r["id"] for r in rows]
    if got != [c for c in SWEEP_IDS for _ in range(P)]:
        raise AssertionError(f"sweep wrote rows for {got}")
    if not np.isfinite([float(r["energy"]) for r in rows]).all():
        raise AssertionError("sweep: non-finite energies")
    log(f"# sweep: {len(rows)} rows written for {', '.join(SWEEP_IDS)}")


def route_phase(raw, device, steps=STEPS):
    """40-step samples of P poses from one generator seed through each
    kernel route, the edges of every forward recorded: the float32 kernel
    route's fast(f32), select and bins routes, and fast() (bf16) with its
    select route.  Every route selects through select_topk, so each select
    route (the JAX config's select_kernel flag, which the port keeps only
    for equality) must reproduce its precision's fast() edges and trajectory
    bit for bit; where the bins route's torch geometry, or the bf16 route,
    leaves the float32 fast() trajectory is reported.  The samples run
    eagerly (capture=False): the recorder hooks each forward in Python,
    which a replayed graph would not call; phase 10d holds the routes'
    captured samples against eager ones.  Returns the launches of each
    route."""
    batch = batch_to_tensors(complex_to_batch(raw), device)
    out, launches, edges = {}, {}, {}
    select = score_net_mod.select_edges

    def recording(*args, **kwargs):
        result = select(*args, **kwargs)
        edges[name].append(result)
        return result

    score_net_mod.select_edges = recording
    try:
        for name, mcfg in (("fast", FAST_F32),
                           ("select", dataclasses.replace(FAST_F32, select_kernel=True)),
                           ("bins", dataclasses.replace(FAST_F32, edge_table_kernel=False)),
                           ("fast bf16", ModelConfig.fast()),
                           ("select bf16", ModelConfig.fast(select_kernel=True))):
            cfg = DFMDockConfig(model=mcfg, sampler=SamplerConfig(num_steps=steps))
            sampler = build_sampler(load_model(None, cfg, device), cfg)
            gen = torch.Generator(device).manual_seed(5)
            edges[name] = []
            out[name], wall, launches[name] = run_path(
                f"{name} route", ROUTE_KERNELS[name],
                lambda: sampler.sample(batch, P, gen, record_trajectory=True, capture=False),
                F32_ABSENT if mcfg.compute_dtype == "float32" else BF16_ABSENT)
            if not torch.isfinite(out[name]["trajectory"]).all():
                raise AssertionError(f"{name} route: non-finite trajectory")
            log(f"# {name} route P={P} steps={steps}: {P * steps / wall:.2f} steps/s (eager: "
                "the edge recorder runs in Python every forward)")
    finally:
        score_net_mod.select_edges = select
    for name, ref_name, gate in (("select", "fast", True), ("bins", "fast", False),
                                 ("select bf16", "fast bf16", True),
                                 ("fast bf16", "fast", False)):
        ref = out[ref_name]["trajectory"]
        diff = (out[name]["trajectory"] - ref).abs().amax(dim=(0, 2, 3, 4))
        moved = torch.nonzero(diff > 0)
        first = int(moved[0]) + 1 if len(moved) else None
        # the first forward whose edges (on valid slots) differ
        first_edges = n_diff = n_sets = None
        for step, ((i_a, m_a), (i_b, m_b)) in enumerate(zip(edges[ref_name], edges[name]), 1):
            valid = (m_a > 0.5) | (m_b > 0.5)
            bad = (i_a != i_b) & valid
            if bad.any() or not torch.equal(m_a, m_b):
                # slots in another order, or another set of neighbours
                sets = (torch.sort(torch.where(valid, i_a, -1), -1)[0]
                        != torch.sort(torch.where(valid, i_b, -1), -1)[0]).any(-1)
                first_edges, n_diff, n_sets = step, int(bad.sum()), int(sets.sum())
                break
        log(f"# route {'check' if gate else 'finding'}: {name} vs {ref_name} over "
            f"{steps} steps: "
            + ("identical trajectories" if first is None else
               f"poses first differ after step {first} ({float(diff[first - 1]):.3e} A, "
               f"{float(diff[-1]):.3e} A at the end)")
            + ("; identical edges in every forward" if first_edges is None else
               f"; edges first differ in forward {first_edges} ({n_diff} valid slots, "
               f"{n_sets} rows with another neighbour set)"))
        if gate and (first is not None or first_edges is not None):
            raise AssertionError(f"the {name} route's edges or trajectory differ from "
                                 f"{ref_name}'s")
    return launches


def blocked_forward(net, batch, pos, t, edges, block=SCALING_PLAIN_BLOCK):
    """`net`'s forward on injected `edges` in blocks of `block` poses, the
    outputs concatenated (each has the pose axis first)."""
    outs = []
    with torch.no_grad():
        for lo in range(0, pos.shape[0], block):
            sl = slice(lo, lo + block)
            outs.append(net(batch, pos[sl], t, edges=tuple(e[sl] for e in edges)))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the models call each kernel's plain version where
    they call its wrapper (the weights' kernel-side form, `prepared`,
    dropped): the kernel route's own arithmetic, launching no kernel, on
    any device."""
    def site(plain):
        return lambda *args, prepared=None, **kwargs: plain(*args, **kwargs)

    for _, module, attr, _, plain in KERNEL_SITES:
        setattr(module, attr, site(plain))
    try:
        yield
    finally:
        for _, module, attr, fn, _ in KERNEL_SITES:
            setattr(module, attr, fn)


def scaling_parity(label, net, batch, pos, edges, f32, floor):
    """One forward of all the poses through the kernels against the same
    route's plain path on the card (plain_kernels, in pose blocks; no
    kernel may launch), on the same injected edges.  Every output within
    PARITY_TOL / PARITY_ABS (num_clashes exact) and, on the float32 route
    (`f32`), within F32_PARITY_REL: phase 4's tolerances.  Where an output
    lies beyond the bound of its route's precision (F32_PARITY_REL; on the
    bf16 route PARITY_TOL / PARITY_ABS), it is held within
    BF16_ROUTE_FACTOR times the distance that the precision itself sets on
    the same case, as phase 4b holds the bf16 route: `floor(o_p)` returns
    two forwards (lower, reference) whose distance that is.  Every
    output's error is printed; a failing case diagnoses every kernel call
    of its forward.  Returns the failing outputs."""
    with torch.no_grad(), recording_kernels() as calls:
        o_k = net(batch, pos, SCALING_T, edges=edges)
        torch.cuda.synchronize()
    reset_counts()
    with plain_kernels():
        o_p = blocked_forward(net, batch, pos, SCALING_T, edges)
    errs = parity_errors(SCORE_NET_OUTPUTS, o_k, o_p, f32=False)
    beyond = [name for name, (_, r_err, ok) in errs.items() if name != "num_clashes"
              and (r_err > F32_PARITY_REL if f32 else not ok)]
    route = {}
    if beyond:
        o_lo, o_ref = floor(o_p)
        route = {name: max_errs(o_lo[name].cpu().double(), o_ref[name].cpu().double())[1]
                 for name in beyond}
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        raise AssertionError(f"{label}: the plain paths launched {json.dumps(launch_counts())}")
    bad = [name for name, (_, r_err, ok) in errs.items()
           if (f32 and not ok) or (name in route and r_err > BF16_ROUTE_FACTOR * route[name])
           or (name == "num_clashes" and not ok)]
    for name, (a_err, r_err, _) in errs.items():
        note = "FAIL" if name in bad and name not in route else "ok" if name not in route else (
            f"(beyond {'F32_PARITY_REL' if f32 else 'PARITY_TOL'}; the precision's own distance "
            f"{route[name]:.3e}: {'beyond' if name in bad else 'within'} {BF16_ROUTE_FACTOR}x)")
        log(f"# parity {label} t={SCALING_T} {name}: max abs {a_err:.3e} rel {r_err:.3e} {note}")
    if bad:
        diagnose_kernels(calls)
    return bad


def precision_floors(net64, eager, batch, batch64, pos, edges):
    """{route: floor} for scaling_parity: the distance each precision sets
    on these poses, the float32 route's plain path (o_p) from its float64
    evaluation (`net64`, the float32 route's net in float64, on `batch64`),
    and the eager bf16 route from the eager float32 path (`eager`: those
    two nets), each forward in pose blocks."""
    def f32(o_p):
        with plain_kernels():
            return o_p, blocked_forward(net64, batch64, pos.double(), SCALING_T,
                                        (edges[0], edges[1].double()))

    def bf16(o_p):
        o_f, o_e = (blocked_forward(n, batch, pos, SCALING_T, edges) for n in eager)
        return o_e, o_f

    return {"f32": f32, "bf16": bf16}


def sample_numbers(label, sampler, batch, p, gen, bf16):
    """A 40-step sample of `p` poses, captured (the default) and eager on
    the same sampler: the capture's first call (capture seconds, its wall,
    its peak memory and the graph pool's size: a replay allocates no more
    than its outputs), a traced replay (launches exactly the P = 16
    sample's a forward, read from the trace), a replay's device busy time
    (device_ms, one call) and a timed replay (steps/s, wall), then the same
    eager (capture=False: wall, busy time, peak memory, the same launches,
    which the wrappers count as they run).  Returns (the numbers, the
    timed replay's outputs, the traced replay's launches)."""
    kernels, absent = ((DOCK_KERNELS_BF16, BF16_ABSENT) if bf16 else (DOCK_KERNELS, F32_ABSENT))
    want = expected_launches(sample_forwards(STEPS), bf16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, first, launches = run_path(f"{label} capture", kernels,
                                  lambda: sampler.sample(batch, p, gen), absent)
    check_launches(f"{label} capture", launches, want)
    got = {"capture_s": graph_mod.totals().capture_s, "first_s": first,
           "capture_peak": torch.cuda.max_memory_allocated() / 1e9}
    got["pool"] = pool_gb(sampler.graphs)
    _, _, traced = run_path(f"{label} traced sample", kernels,
                            lambda: sampler.sample(batch, p, gen), absent, trace=True)
    check_launches(f"{label} traced sample", traced, want)
    got["busy_ms"] = device_ms(lambda: sampler.sample(batch, p, gen), calls=1)
    out, got["wall"], _ = run_path(f"{label} sample", kernels,
                                   lambda: sampler.sample(batch, p, gen), absent)
    torch.cuda.reset_peak_memory_stats()
    _, got["eager_wall"], eager_launches = run_path(
        f"{label} eager sample", kernels,
        lambda: sampler.sample(batch, p, gen, capture=False), absent)
    got["eager_peak"] = torch.cuda.max_memory_allocated() / 1e9
    check_launches(f"{label} eager sample", eager_launches, want)
    got["eager_busy_ms"] = device_ms(lambda: sampler.sample(batch, p, gen, capture=False),
                                     calls=1)
    rate = lambda wall: p * STEPS / wall
    log(f"# {label}: captured {rate(got['wall']):.2f} denoising steps/s ({STEPS} steps, wall "
        f"{got['wall']:.4f} s a sample), device busy {got['busy_ms']:.1f} ms "
        f"({100 * got['busy_ms'] / (got['wall'] * 1e3):.1f}% of the wall), peak memory "
        f"{got['capture_peak']:.3f} GB in the capture, the graph's pool "
        + ("not named by the allocator's snapshot" if got["pool"] is None
           else f"{got['pool']:.3f} GB")
        + f" (the capture took {got['capture_s']:.3f} s, its first sample "
        f"{got['first_s']:.3f} s); eager "
        f"{rate(got['eager_wall']):.2f} steps/s (wall {got['eager_wall']:.4f} s), busy "
        f"{got['eager_busy_ms']:.1f} ms "
        f"({100 * got['eager_busy_ms'] / (got['eager_wall'] * 1e3):.1f}%), peak "
        f"{got['eager_peak']:.3f} GB; {sample_forwards(STEPS)} forwards with the P={P} "
        f"sample's launches either way; card {CARD[0]}")
    return got, out, traced


def scaling_phase(raw, device, errs, route_launches=None):
    """The ScoreNet at bench.py's pose counts beyond phase 5's 16
    (SCALING_POSES), 1AVX at N_PAD, seeded weights (seed 0): at each P,
    random poses and their selected edges, then on the float32 route
    (fast(f32)) and the bf16 route (fast()) one forward against the route's
    plain path on the card (scaling_parity; the phase fails after every P
    and route if one failed) and a 40-step sample, which must be
    finite and launch each kernel as the P = 16 sample does a forward
    (expected_launches; equal to phase 10's fast routes where given), with
    its steps/s, device busy time (device_ms, one sample) and peak memory,
    captured and eager (sample_numbers); at the largest P every kernel
    against its plain version (kernel_case, the kernel checks' bounds)."""
    nets = {"f32": load_model(None, DFMDockConfig(model=FAST_F32), device, seed=0),
            "bf16": load_model(None, DFMDockConfig(model=ModelConfig.fast()), device, seed=0)}
    eager = tuple(load_model(None, DFMDockConfig(model=m), device, seed=0)
                  for m in (ModelConfig(), ModelConfig(compute_dtype="bfloat16")))
    net64 = copy.deepcopy(nets["f32"]).double()
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=N_PAD), device)
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    failed = []
    for p in SCALING_POSES:
        _, pos, idx, edge_mask = edge_inputs(raw, N_PAD, p, p, device)
        edges = (idx, edge_mask)
        floor = precision_floors(net64, eager, batch, batch64, pos, edges)
        for route, net in nets.items():
            bf16 = route == "bf16"
            label = f"scaling P={p} {route}"
            failed += [f"{label} {name}" for name in
                       scaling_parity(label, net, batch, pos, edges, not bf16, floor[route])]
            cfg = DFMDockConfig(model=ModelConfig.fast() if bf16 else FAST_F32,
                                sampler=SamplerConfig(num_steps=STEPS))
            sampler = build_sampler(net, cfg)
            gen = torch.Generator(device).manual_seed(p)
            cap, out, launches = sample_numbers(label, sampler, batch, p, gen, bf16)
            if not all(torch.isfinite(out[k]).all() for k in ("pos", "energy", "tr_score")):
                raise AssertionError(f"{label}: non-finite sample")
            if route_launches is not None:
                check_launches(f"{label} sample against the P={P} route",
                               launches, route_launches["fast bf16" if bf16 else "fast"])
        del pos, idx, edge_mask, edges, floor
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"scaling parity failed: {failed}")
    p = max(SCALING_POSES)
    kernel_case(raw, device, errs, p, N_PAD, p)
    torch.cuda.empty_cache()


@contextlib.contextmanager
def sample_captures():
    """Record, for each sample call inside that captured a graph, the
    caller's generator and the generator registered with the graph (the
    helper's own), with their states after the call."""
    records, run = [], graph_mod.SampleGraphs.run

    def recording(self, module, key, inputs, body, generator, capture=None):
        captures = self.stats.captures
        out = run(self, module, key, inputs, body, generator, capture)
        if self.stats.captures > captures:
            records.append((generator, self.generator, generator.get_state(),
                            self.generator.get_state()))
        return out

    graph_mod.SampleGraphs.run = recording
    try:
        yield records
    finally:
        graph_mod.SampleGraphs.run = run


def check_same(label, got, want):
    """Fail unless every output of `got` equals `want`'s bit for bit."""
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: outputs {sorted(got)} against {sorted(want)}")
    for k in want:
        a, b = (torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                for v in (got[k], want[k]))
        if not torch.equal(a, b):
            err = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"{label}: {k} differs from the eager sample's (max abs "
                                 f"{err:.3e})")


def check_registered(label, records, seeds=None):
    """Every captured graph's registered generator is a CUDA generator of
    the helper's own, which the replay left in the caller's generator's
    state (the caller's draws), and, with `seeds`, the caller's generator is
    seeded so."""
    for gen, own, state, own_state in records:
        if own is gen or own.device.type != "cuda" or not torch.equal(state, own_state):
            raise AssertionError(f"{label}: the registered generator is not the helper's own "
                                 f"CUDA generator in the caller's state")
        if seeds is not None and (gen.device.type != "cuda" or gen.initial_seed() not in seeds):
            raise AssertionError(f"{label}: the caller's generator is seeded "
                                 f"{gen.initial_seed()} on {gen.device}, not {seeds}")


def pool_gb(graphs):
    """The reserved bytes of a helper's shared graph pool (GB), from the
    allocator's snapshot; None where the snapshot does not name pools."""
    if graphs.backend.pool is None:
        return 0.0
    segments = torch.cuda.memory._snapshot()["segments"]
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    pool = tuple(graphs.backend.pool)
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == pool) / 1e9


CAPTURE_ROUTES = (("f32", FAST_F32, "fast"),
                  ("bf16", ModelConfig.fast(), "fast bf16"),
                  ("select", dataclasses.replace(FAST_F32, select_kernel=True), "select"),
                  ("bins", dataclasses.replace(FAST_F32, edge_table_kernel=False), "bins"))
CAPTURE_SWEEP_POSES = 1


def capture_phase(raw, device):
    """Phase 10d: the samplers as captured graphs against their eager runs.
    EM and Heun 40-step samples of P poses on the f32, bf16, select and bins
    routes (seeded weights): every output, trajectory included, bit-equal
    to the eager sample from the same generator state, launches exact (the
    captured run's read from its trace) and equal to the eager run's, the
    caller's generator left as eager leaves it (the warm-up and the capture
    draw from the helper's own generator, registered with the graph); a
    second replay equal to the eager sample from that state and unlike the
    first.  The DFMDock lineage
    (trained weights, P = 16), Picard at K = T and T + 1 (trained mlsb,
    P = 1) and the ranking draws (4 draws at two t) likewise, traced.  The
    dock and sweep CLIs' graphs draw from the generator they seed (--seed),
    their poses bit-equal to an eager sample from it.  Then the numbers at P =
    16 (sample_numbers, both routes; 10b gives P = 40, 64, 120) and the
    24-complex sweeps at P = 1 of EM, Heun and Picard (the sweep CLI's
    bucket-128 loop over cli.common.dock_complex, bf16, trained weights),
    captured, and EM also eager (each complex's poses bit-equal), with their
    walls, captures, replays, peak memory and the shared pool's size (the
    trained sweeps of phase 9 run the 24 complexes at P poses captured)."""
    batch = batch_to_tensors(complex_to_batch(raw), device)
    t0 = time.perf_counter()
    for integ, scfg in (("em", SamplerConfig(num_steps=STEPS)),
                        ("heun", SamplerConfig(num_steps=STEPS, ode=True, integrator="heun"))):
        forwards = sample_forwards(STEPS, integ)
        for route, mcfg, kernel_route in CAPTURE_ROUTES:
            label = f"capture {integ} {route}"
            bf16 = mcfg.compute_dtype == "bfloat16"
            absent = BF16_ABSENT if bf16 else F32_ABSENT
            want = expected_launches(forwards, bf16)
            if route == "bins":
                want["edge_bins"], want["edge_table"] = want["edge_table"], 0
            cfg = DFMDockConfig(model=mcfg, sampler=scfg)
            sampler = build_sampler(load_model(None, cfg, device), cfg)
            gen = torch.Generator(device)
            run = lambda **kw: sampler.sample(batch, P, gen, record_trajectory=True, **kw)
            gen.manual_seed(5)
            eager, _, eager_launches = run_path(f"{label} eager", ROUTE_KERNELS[kernel_route],
                                                lambda: run(capture=False), absent)
            eager_state = gen.get_state()
            gen.manual_seed(5)
            with sample_captures() as records:
                got, _, launches = run_path(f"{label} captured", ROUTE_KERNELS[kernel_route],
                                            run, absent, trace=True)
            check_same(label, got, eager)
            check_launches(f"{label} captured", launches, want)
            check_launches(f"{label} eager", eager_launches, want)
            check_registered(label, records, {5})
            if len(records) != 1 or not torch.equal(gen.get_state(), eager_state):
                raise AssertionError(f"{label}: {len(records)} captures; the generator after "
                                     "the replay is not where the eager sample leaves it")
            again = run()
            gen.set_state(eager_state)
            check_same(f"{label} second replay", again, run(capture=False))
            if torch.equal(again["pos"], got["pos"]):
                raise AssertionError(f"{label}: two replays in a row drew the same poses")
            log(f"# {label} P={P} steps={STEPS}: captured bit-equal to eager (every output, "
                f"trajectory included), {forwards} forwards' launches exact, the generator "
                f"as eager leaves it; the next replay differs from the first and equals the "
                f"eager sample from its state")
            del sampler
    t0 = log_since("routes", t0)
    capture_lineages(raw, device, batch)
    t0 = log_since("DFMDock, Picard and the ranking draws", t0)
    capture_clis(raw, device, batch)
    t0 = log_since("the CLIs' generator", t0)
    for route, mcfg in (("f32", FAST_F32), ("bf16", ModelConfig.fast())):
        cfg = DFMDockConfig(model=mcfg, sampler=SamplerConfig(num_steps=STEPS))
        sampler = build_sampler(load_model(None, cfg, device, seed=0), cfg)
        padded = batch_to_tensors(complex_to_batch(raw, pad_to=N_PAD), device)
        sample_numbers(f"capture numbers P={P} {route}", sampler, padded, P,
                       torch.Generator(device).manual_seed(P), route == "bf16")
    t0 = log_since(f"the numbers at P={P}", t0)
    capture_sweeps(device)
    log_since("the 24-complex sweeps", t0)


def log_since(what, t0):
    """Log the seconds since `t0` spent on `what` (phase 10d's parts); the time now."""
    now = time.perf_counter()
    log(f"# capture: {what} {now - t0:.1f} s")
    return now


def capture_lineages(raw, device, batch):
    """The DFMDock lineage (EM, P poses), Picard at K = T and K = T + 1 and
    the ranking draws: captured against eager, bit for bit."""
    cfg = DFMDockConfig(model=FAST_F32, sampler=SamplerConfig(num_steps=STEPS))
    net = load_model(DFMDOCK_NPZ, cfg, device, lineage="dfmdock")
    sampler = build_sampler(net, cfg)
    gen = lambda: torch.Generator(device).manual_seed(5)
    eager = sampler.sample(batch, P, gen(), record_trajectory=True, capture=False)
    got, _, launches = run_path("capture dfmdock", DFMDOCK_KERNELS, lambda: sampler.sample(
        batch, P, gen(), record_trajectory=True), DFMDOCK_ABSENT, trace=True)
    check_same("capture dfmdock", got, eager)
    forwards = sample_forwards(STEPS)
    check_launches("capture dfmdock", launches, {
        **dict.fromkeys(launches, 0), "select_topk": forwards, "edge_table": forwards,
        "fused_egcl": cfg.model.depth * forwards})
    log(f"# capture dfmdock P={P} steps={STEPS} (trained weights, f32 route): bit-equal to "
        f"eager, {forwards} forwards of six agg-only fused_egcl")
    del sampler, net
    cfg = DFMDockConfig(model=FAST_F32, sampler=SamplerConfig(num_steps=STEPS, ode=True))
    net = load_model(DEMO_NPZ, cfg, device)
    seq = build_sampler(net, cfg)
    pics = {}
    for k in (STEPS, STEPS + 1):
        pic = PicardSampler(net, seq.r3, seq.so3, cfg.sampler, num_iters=k)
        eager = pic.sample(batch, 1, torch.Generator(device).manual_seed(11),
                           record_trajectory=True, capture=False)
        pics[k], _, launches = run_path(f"capture Picard K={k}", DOCK_KERNELS, lambda: pic.sample(
            batch, 1, torch.Generator(device).manual_seed(11), record_trajectory=True),
            F32_ABSENT)
        check_same(f"capture Picard K={k}", pics[k], eager)
        check_launches(f"capture Picard K={k}", launches, expected_launches(k + 1))
    check_same("capture Picard K=T against K=T+1", pics[STEPS], pics[STEPS + 1])
    log(f"# capture Picard P=1 K={STEPS}, {STEPS + 1} (trained mlsb, f32): each bit-equal to "
        f"eager, K=T bit-equal to K=T+1, one graph a K ({STEPS} rounds of {STEPS} poses and "
        f"the final forward)")
    pos = pics[STEPS]["pos"].expand(P, -1, -1, -1).cpu().numpy() + np.random.RandomState(
        0).randn(P, 1, 1, 3).astype(np.float32)
    n = pos.shape[1]
    eager = {t: sweep._multi_draw_scores(net, raw, pos, n, RERANK_DRAWS, 3, device, t,
                                         capture=False) for t in (1e-5, 0.5)}
    draws = graph_mod.SampleGraphs()
    got, _, launches = run_path("capture ranking draws", DOCK_KERNELS, lambda: {
        t: sweep._multi_draw_scores(net, raw, pos, n, RERANK_DRAWS, 3, device, t, graphs=draws)
        for t in (1e-5, 0.5)}, F32_ABSENT)
    for t in eager:
        check_same(f"capture ranking draws t={t}", got[t], eager[t])
    check_launches("capture ranking draws", launches,
                   {**expected_launches(2 * RERANK_DRAWS), "fused_energy": 2 * RERANK_DRAWS})
    log(f"# capture ranking draws ({RERANK_DRAWS} draws at t = 1e-5 and 0.5, P={P}): energy, "
        "icons and snorm bit-equal to eager, one graph a t, its generator re-seeded a draw")


def capture_clis(raw, device, batch, steps=10, seed=7):
    """The dock and sweep CLIs (seeded weights, P poses, `steps` steps):
    their graph's registered generator is the helper's own, left in the
    state of the generator --seed seeds, and their poses equal an eager
    sample from it."""
    cfg = DFMDockConfig(model=FAST_F32, sampler=SamplerConfig(num_steps=steps))
    sampler = build_sampler(load_model(None, cfg, device), cfg)
    with tempfile.TemporaryDirectory() as out_root:
        for name, main, argv, pad_to in (
                ("dock", dock.main, ["--npz", NPZ, "--out-dir", out_root], None),
                ("sweep", sweep.main, ["--ids", "1AVX", "--out-csv",
                                       os.path.join(out_root, "s.csv")], 512)):
            results, module = [], sweep if name == "sweep" else dock
            orig = module.dock_complex

            def recording(*args, **kwargs):
                out = orig(*args, **kwargs)
                results.append(out[1])
                return out

            module.dock_complex = recording
            try:
                with sample_captures() as records:
                    run_path(f"capture {name} CLI", DOCK_KERNELS, lambda: main(
                        argv + ["--num-samples", str(P), "--num-steps", str(steps), "--seed",
                                str(seed)], FAST_F32), F32_ABSENT)
            finally:
                module.dock_complex = orig
            check_registered(f"capture {name} CLI", records, {seed})
            if len(records) != 1:
                raise AssertionError(f"capture {name} CLI: {len(records)} captures")
            b = batch if pad_to is None else batch_to_tensors(
                complex_to_batch(raw, pad_to=pad_to), device)
            eager = sampler.sample(b, P, torch.Generator(device).manual_seed(seed),
                                   capture=False)
            check_same(f"capture {name} CLI", {k: results[0][k] for k in eager},
                       {k: v.cpu().numpy() for k, v in eager.items()})
            log(f"# capture {name} CLI (--seed {seed}, P={P}, {steps} steps): its graph "
                f"draws from the CUDA generator --seed seeds (its state copied into the "
                f"graph's own and back); poses, energies and scores bit-equal to an eager "
                f"sample from it")


def capture_sweeps(device):
    """The 24 DB5 complexes at CAPTURE_SWEEP_POSES poses through EM, Heun
    and Picard (K = 10), as the sweep CLI docks them
    (bucket 128, one generator, bf16, trained mlsb weights), captured
    (walls, captures, replays, peak memory, the shared pool); EM at one
    pose also eagerly (its wall), each complex's outputs bit-equal."""
    from dfmdock_tpu_torch.cli.common import dock_complex

    ds = NPZDataset(os.path.join("data", "db5_npz"))
    raws = [ds.load_raw(i) for i in range(len(ds.ids))]
    for r, cid in zip(raws, ds.ids):
        r["id"] = cid
    pads = [round_up(r["rec_x"].shape[0] + r["lig_x"].shape[0], 128) for r in raws]
    poses = CAPTURE_SWEEP_POSES
    for name, scfg, iters, modes in (
            ("em", SamplerConfig(num_steps=STEPS), 0, ("captured", "eager")),
            ("heun", SamplerConfig(num_steps=STEPS, ode=True, integrator="heun"), 0,
             ("captured",)),
            ("picard", SamplerConfig(num_steps=STEPS, ode=True), 10, ("captured",))):
        cfg = DFMDockConfig(model=ModelConfig.fast(), sampler=scfg)
        net = load_model(DEMO_NPZ, cfg, device)
        sampler = build_sampler(net, cfg)
        if iters:
            sampler = PicardSampler(net, sampler.r3, sampler.so3, scfg, num_iters=iters)
        walls, results = {}, {}
        for mode in modes:
            gen = torch.Generator(device).manual_seed(5)
            sample = sampler.sample
            if mode == "eager":
                sampler.sample = functools.partial(sample, capture=False)
            torch.cuda.reset_peak_memory_stats()
            try:
                results[mode], walls[mode], _ = run_path(
                    f"capture sweep {name} P={poses} {mode}", DOCK_KERNELS_BF16, lambda: [
                        dock_complex(sampler, r, gen, poses, device, pad_to=pad)[1]
                        for r, pad in zip(raws, pads)], BF16_ABSENT)
            finally:
                sampler.sample = sample
            if mode == "captured":
                stats, peak = graph_mod.totals(), torch.cuda.max_memory_allocated() / 1e9
                pool = pool_gb(sampler.graphs)
        if "eager" in results:
            for cid, a, b in zip(ds.ids, results["captured"], results["eager"]):
                check_same(f"capture sweep {name} {cid}", a, b)
        if stats.captures != len(set(pads)) or stats.replays != len(raws):
            raise AssertionError(f"capture sweep {name}: {stats.captures} captures and "
                                 f"{stats.replays} replays for {len(raws)} complexes in "
                                 f"{len(set(pads))} buckets")
        log(f"# capture sweep {name}{f' K={iters}' if iters else ''} P={poses} over "
            f"{len(raws)} DB5 complexes (bucket 128, bf16, trained mlsb): captured wall "
            f"{walls['captured']:.3f} s ({stats.captures} captures in {stats.capture_s:.3f} s, "
            f"{stats.replays} replays)"
            + (f", eager {walls['eager']:.3f} s, every complex bit-equal" if "eager" in walls
               else "")
            + f"; peak memory {peak:.3f} GB, the shared pool "
            + ("not named by the allocator's snapshot" if pool is None else f"{pool:.3f} GB")
            + f"; card {CARD[0]}")
        del sampler, net
        torch.cuda.empty_cache()


def heun_phase(raw, device, out_root):
    """The Heun integrator (probability-flow ODE, a corrector forward a
    step) on the card: 40-step samples of P poses through fast(f32) and
    fast() (bf16) and their select_kernel=True routes, each finite with
    sample_forwards(STEPS, "heun") forwards' launches and each select route
    bit-equal to its precision's fast(); the trajectory gate of
    test_heun_trajectory_matches_jax at full width (heun_parity); and the
    dock CLI with --integrator heun on its default route, its launches
    counted as the dock phase's."""
    batch = batch_to_tensors(complex_to_batch(raw), device)
    scfg = SamplerConfig(num_steps=STEPS, ode=True, integrator="heun")
    forwards = sample_forwards(STEPS, "heun")
    out = {}
    for name, mcfg in (("heun", FAST_F32),
                       ("heun select", dataclasses.replace(FAST_F32, select_kernel=True)),
                       ("heun bf16", ModelConfig.fast()),
                       ("heun select bf16", ModelConfig.fast(select_kernel=True))):
        bf16 = mcfg.compute_dtype == "bfloat16"
        cfg = DFMDockConfig(model=mcfg, sampler=scfg)
        sampler = build_sampler(load_model(None, cfg, device), cfg)
        gen = torch.Generator(device).manual_seed(5)
        out[name], wall, launches = run_path(
            f"{name} route", DOCK_KERNELS_BF16 if bf16 else DOCK_KERNELS,
            lambda: sampler.sample(batch, P, gen, record_trajectory=True),
            BF16_ABSENT if bf16 else F32_ABSENT, trace=True)
        if not torch.isfinite(out[name]["trajectory"]).all():
            raise AssertionError(f"{name} route: non-finite trajectory")
        check_launches(f"{name} route", launches, expected_launches(forwards, bf16))
        log(f"# {name} route P={P} steps={STEPS}: {forwards} forwards, "
            f"{P * STEPS / wall:.2f} steps/s (the first sample: capture included, traced)")
    for name, ref in (("heun select", "heun"), ("heun select bf16", "heun bf16")):
        if not all(torch.equal(out[name][k], out[ref][k])
                   for k in ("trajectory", "pos", "energy", "tr_score", "rot_score")):
            raise AssertionError(f"the {name} route's trajectory differs from {ref}'s")
        log(f"# route check: {name} vs {ref} over {STEPS} Heun steps: identical "
            "trajectories, poses, energies and scores")
    diff = (out["heun bf16"]["trajectory"] - out["heun"]["trajectory"]).abs()
    log(f"# route finding: heun bf16 vs heun (f32) after {STEPS} steps: {float(diff.max()):.3e} "
        "A at most")
    heun_parity(raw, device)
    dock_out = os.path.join(out_root, "dock_heun")
    rows, wall, launches = run_path("heun dock", DOCK_KERNELS_BF16, lambda: dock.main(
        ["--npz", NPZ, "--num-samples", str(P), "--num-steps", str(STEPS), "--integrator",
         "heun", "--out-dir", dock_out]), BF16_ABSENT, trace=True)
    check_launches("heun dock", launches, expected_launches(forwards, bf16=True))
    with open(os.path.join(dock_out, "metrics.csv")) as f:
        csv_rows = list(csv.DictReader(f))
    energies = np.array([float(r["energy"]) for r in csv_rows])
    if len(csv_rows) != P or len(rows) != P or not np.isfinite(energies).all():
        raise AssertionError(f"heun dock: {len(csv_rows)} CSV rows, energies {energies}")
    log(f"# heun dock 1AVX P={P} steps={STEPS} (--integrator heun, bf16 kernel route): wall "
        f"{wall:.3f} s (traced), {P * STEPS / wall:.2f} denoising steps/s, {forwards} forwards, best "
        f"DockQ {max(float(r['DockQ']) for r in csv_rows):.4f}")


def heun_parity(raw, device):
    """HEUN_PARITY_STEPS Heun steps from one start pose (the ligand of 1AVX
    moved by HEUN_SHIFT) on the float32 kernel route with knn-only edges
    (sample_size=0), the card against the plain path on the CPU (the same
    config and seeded weights): every frame, the final pose and the final
    forward's scores within F32_PARITY_REL of the CPU side's largest
    magnitude (HEUN_GATED; HEUN_REPORTED printed), the card's launches
    those of its forwards."""
    mcfg = dataclasses.replace(FAST_F32, sample_size=0)
    scfg = SamplerConfig(num_steps=HEUN_PARITY_STEPS, ode=True, integrator="heun",
                         use_clash_force=True)
    sides = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        net = load_model(None, DFMDockConfig(model=mcfg), dev, seed=0)
        sampler = EMSampler(net, R3Diffuser(R3Config(max_sigma=1.0)), SO3Diffuser(SO3Config()),
                            scfg)
        batch = batch_to_tensors(complex_to_batch(raw), dev)
        shift = torch.tensor(HEUN_SHIFT, device=dev)
        lig = (batch["lig_mask"] > 0) & (batch["node_mask"] > 0)
        pos0 = torch.where(lig[:, None, None], batch["pos"] + shift, batch["pos"])
        init = (pos0[None], shift.reshape(1, 1, 3),
                torch.tensor(HEUN_ROT, device=dev).reshape(1, 1, 3))
        run = lambda: sampler.sample(batch, 1, torch.Generator(dev).manual_seed(0), init=init,
                                     record_trajectory=True)
        if side == "card":
            sides["card"], _, launches = run_path("heun parity", DOCK_KERNELS, run, F32_ABSENT)
            check_launches("heun parity", launches,
                           expected_launches(sample_forwards(HEUN_PARITY_STEPS, "heun")))
        else:
            sides["cpu"] = run()
            moved = float((sides["cpu"]["pos"][0] - pos0).abs().max())
            if moved <= 1e-3:
                raise AssertionError(f"heun parity: the pose moved {moved:.3e} A only")
    card = {k: v.cpu() for k, v in sides["card"].items()}
    cpu = sides["cpu"]
    frames = [(f"frame {i + 1}", card["trajectory"][:, i], cpu["trajectory"][:, i])
              for i in range(HEUN_PARITY_STEPS)]
    failed = []
    for name, a, b in frames + [(k, card[k], cpu[k]) for k in HEUN_GATED + HEUN_REPORTED]:
        a_err, r_err, scale = max_errs(a, b)
        ok = r_err <= F32_PARITY_REL
        failed += [] if ok or name in HEUN_REPORTED else [name]
        log(f"# heun parity {name}: max abs {a_err:.3e} rel {r_err:.3e} (largest {scale:.3e}) "
            + ("(reported)" if name in HEUN_REPORTED else "ok" if ok else "FAIL"))
    if failed:
        raise AssertionError(f"heun trajectory card vs CPU beyond {F32_PARITY_REL}: {failed}")
    log(f"# heun parity: {HEUN_PARITY_STEPS} steps, every frame, the pose and the scores within "
        f"{F32_PARITY_REL} of the CPU's largest (the CPU side is held to JAX by "
        "tests/test_torch_ranking.py::test_heun_trajectory_matches_jax)")


def by_complex(rows):
    """{complex id: [poses, 2] array of (DockQ, energy)} of CSV rows."""
    groups = {}
    for r in rows:
        groups.setdefault(r["id"], []).append((float(r["DockQ"]), float(r["energy"])))
    return {cid: np.array(v) for cid, v in groups.items()}


def dockq_stats(groups):
    """The sweep's quality numbers: mean DockQ over all poses, the mean of
    each complex's best, the mean of each complex's minimum-energy pick,
    and how many picks are acceptable or better (DockQ >= 0.23)."""
    picks = [g[np.argmin(g[:, 1]), 0] for g in groups.values()]
    return {"mean_all": float(np.concatenate([g[:, 0] for g in groups.values()]).mean()),
            "best_mean": float(np.mean([g[:, 0].max() for g in groups.values()])),
            "pick_mean": float(np.mean(picks)),
            "acceptable": int(sum(p >= ACCEPTABLE for p in picks))}


def bootstrap_margins(groups, seed=0):
    """The margin of each gated number: the BOOT_Q quantile of the
    difference between two independent bootstrap resamples of the record
    (each complex's poses drawn with replacement, BOOT_DRAWS times), as a
    positive distance."""
    rng = np.random.default_rng(seed)

    def resample():
        total, count, picks = 0.0, 0, 0.0
        for g in groups.values():
            i = rng.integers(0, len(g), (BOOT_DRAWS, len(g)))
            dq, e = g[i, 0], g[i, 1]
            total, count = total + dq.sum(1), count + len(g)
            picks = picks + np.take_along_axis(dq, e.argmin(1)[:, None], 1)[:, 0]
        return {"mean_all": total / count, "pick_mean": picks / len(groups)}

    a, b = resample(), resample()
    return {k: float(-np.quantile(a[k] - b[k], BOOT_Q)) for k in a}


def quality_gate(label, rows, record, ids, gate=True):
    """The port's sweep rows beside the JAX record's rows of the same
    complexes (a v5e run); with `gate`, the mean DockQ over all poses and
    the min-energy-pick mean must each reach the record's less its
    bootstrap margin."""
    with open(record) as f:
        rec = by_complex([r for r in csv.DictReader(f) if r["id"] in ids])
    port = by_complex(rows)
    if sorted(port) != sorted(rec):
        raise AssertionError(f"{label}: complexes {sorted(port)}, record {sorted(rec)}")
    s_p, s_r, margin = dockq_stats(port), dockq_stats(rec), bootstrap_margins(rec)
    n = len(next(iter(port.values())))
    log(f"# {label} ({len(port)} complexes x {n} poses) vs the JAX record {record} (v5e): "
        f"mean DockQ over all poses {s_p['mean_all']:.4f} (record {s_r['mean_all']:.4f}, "
        f"margin {margin['mean_all']:.4f}); best-of-{n} mean {s_p['best_mean']:.4f} (record "
        f"{s_r['best_mean']:.4f}); min-energy pick mean {s_p['pick_mean']:.4f} (record "
        f"{s_r['pick_mean']:.4f}, margin {margin['pick_mean']:.4f}); acceptable+ picks "
        f"{s_p['acceptable']}/{len(port)} (record {s_r['acceptable']}/{len(rec)})")
    for cid in sorted(port):
        g, r = port[cid], rec[cid]
        log(f"#   {cid}: mean {g[:, 0].mean():.3f} best {g[:, 0].max():.3f} pick "
            f"{g[np.argmin(g[:, 1]), 0]:.3f} (record {r[:, 0].mean():.3f} / {r[:, 0].max():.3f} "
            f"/ {r[np.argmin(r[:, 1]), 0]:.3f})")
    if gate:
        for k in ("mean_all", "pick_mean"):
            if s_p[k] < s_r[k] - margin[k]:
                raise AssertionError(f"{label}: {k} {s_p[k]:.4f} below the record's "
                                     f"{s_r[k]:.4f} less its margin {margin[k]:.4f}")
    return s_p


def trained_phase(out_root):
    """The trained mlsb weights (ckpts/db5_demo/weights.npz) on the float32
    kernel route: the dock of 1AVX (P poses x STEPS steps), then the sweep
    over all 24 DB5 complexes (16 poses, seed 5) gated against the JAX
    record eval_all.csv.  Returns the sweep's launches."""
    out = os.path.join(out_root, "trained_dock")
    rows, wall, _ = run_path("trained dock", DOCK_KERNELS, lambda: dock.main(
        ["--npz", NPZ, "--ckpt", DEMO_NPZ, "--num-samples", str(P), "--num-steps", str(STEPS),
         "--out-dir", out], FAST_F32), F32_ABSENT)
    e = np.array([r["energy"] for r in rows])
    dq = np.array([r["DockQ"] for r in rows])
    pick = int(np.argmin(e))
    log(f"# trained dock 1AVX P={P} steps={STEPS}: wall {wall:.3f} s; min-energy pick pose "
        f"{pick} energy {e[pick]:.4f} DockQ {dq[pick]:.3f}, best of {P} DockQ {dq.max():.3f}, "
        f"mean {dq.mean():.3f} (the JAX demo's record on v5e, ckpts/db5_demo/README.md: best "
        f"pose 5 energy -44.4894 DockQ 0.839)")
    out_csv = os.path.join(out_root, "trained_sweep.csv")
    rows, wall, launches = run_path("trained sweep", DOCK_KERNELS, lambda: sweep.main(
        ["--ckpt", DEMO_NPZ, "--num-samples", str(P), "--seed", "5", "--out-csv", out_csv],
        FAST_F32), F32_ABSENT)
    log(f"# trained sweep: {len(rows)} rows, wall {wall:.3f} s")
    quality_gate("trained mlsb sweep", rows, DEMO_RECORD, set(r["id"] for r in rows))
    return launches


def bf16_trained_phase(out_root, f32_launches):
    """The trained mlsb sweep on the sweep CLI's default route, fast() in
    bf16 (the route the JAX record eval_all.csv itself was made on, v5e):
    all 24 DB5 complexes x 16 poses, seed 5, gated by quality_gate as the
    float32 route's; its launches equal the float32 sweep's, mode for mode."""
    out_csv = os.path.join(out_root, "trained_sweep_bf16.csv")
    rows, wall, launches = run_path("trained sweep bf16", DOCK_KERNELS_BF16, lambda: sweep.main(
        ["--ckpt", DEMO_NPZ, "--num-samples", str(P), "--seed", "5", "--out-csv", out_csv]),
        BF16_ABSENT)
    log(f"# trained sweep bf16: {len(rows)} rows, wall {wall:.3f} s")
    want = {**f32_launches, "fused_egcl_bf16": f32_launches["fused_egcl"],
            "fused_egcl_coord_bf16": f32_launches["fused_egcl_coord"], "fused_egcl": 0,
            "fused_egcl_coord": 0}
    if launches != want:
        raise AssertionError(f"trained sweep bf16: launches {launches}, the float32 route's "
                             f"{f32_launches}")
    stats = quality_gate("trained mlsb sweep bf16", rows, DEMO_RECORD,
                         set(r["id"] for r in rows))
    return stats, launches


def demo_torch_phase(out_root, jax_stats, jax_launches):
    """The port's own db5_demo weights (ckpts/db5_demo_torch, 2000 epochs
    trained by the training CLI on the card) through the same sweep as
    bf16_trained_phase (default route, 24 complexes x 16 poses, seed 5),
    beside the JAX-trained weights' sweep there, gated by quality_gate
    against eval_all.csv as theirs is (the README's rule found the run
    reproduced over sweep seeds 5-14); its launches equal the
    JAX-trained sweep's, mode for mode."""
    out_csv = os.path.join(out_root, "demo_torch_sweep.csv")
    rows, wall, launches = run_path("port-trained sweep", DOCK_KERNELS_BF16, lambda: sweep.main(
        ["--ckpt", DEMO_TORCH_NPZ, "--num-samples", str(P), "--seed", "5", "--out-csv",
         out_csv]), BF16_ABSENT)
    log(f"# port-trained sweep ({DEMO_TORCH_NPZ}): {len(rows)} rows, wall {wall:.3f} s")
    if launches != jax_launches:
        raise AssertionError(f"port-trained sweep: launches {launches}, the JAX-trained "
                             f"sweep's {jax_launches}")
    stats = quality_gate("port-trained mlsb sweep", rows, DEMO_RECORD,
                         set(r["id"] for r in rows))
    log("# seed 5, JAX-trained minus port-trained: " + ", ".join(
        f"{k} {jax_stats[k] - stats[k]:+.4f} ({jax_stats[k]:.4f} - {stats[k]:.4f})"
        for k in ("mean_all", "best_mean", "pick_mean", "acceptable")))


def dfmdock_parity_phase(raw, device, mcfg=FAST_F32, ref_cfg=None):
    """The trained DFMDock-lineage weights through the kernels at `mcfg`
    (card) against the plain path (CPU) on phase 4's inputs (injected
    edges, the native pose and a random one), t in {0.1, 0.5}: the float32
    route against its own plain versions (phase 4's tolerances), or with
    `ref_cfg` (the bf16 route against the eager float32 path) at
    PARITY_TOL / PARITY_ABS alone; the forward makes six agg-only
    fused_egcl calls and none of the coord or energy kernels."""
    batch, pos, edges, gumbel = parity_inputs(raw, device)
    cfg = DFMDockConfig(model=mcfg)
    net_k = load_model(DFMDOCK_NPZ, cfg, device, lineage="dfmdock")
    net_p = load_model(DFMDOCK_NPZ, DFMDockConfig(model=ref_cfg or mcfg), torch.device("cpu"),
                       lineage="dfmdock")
    kw_k, kw_p = injected("edges", edges, gumbel)
    label = "dfmdock fast(f32)" if ref_cfg is None else "dfmdock fast() vs eager f32"
    for t in (0.1, 0.5):
        calls, _ = parity_check(label, DFMDOCK_OUTPUTS, net_k, net_p, batch, pos, t, kw_k,
                                kw_p, f32=ref_cfg is None)
        made = [(name, len(out)) for name, _, _, out in calls]
        if made != [("edge_table", 2)] + [("fused_egcl", 1)] * cfg.model.depth:
            raise AssertionError(f"dfmdock forward made kernel calls {made}")


def synthetic_complex(n_pad, seed):
    """bench.py's `_synthetic_batch`: a random-walk complex of 0.55 n_pad
    receptor and 0.38 n_pad ligand residues (generic N / CA / C offsets),
    random 1301-wide features, padded to n_pad."""
    r = np.random.RandomState(seed)
    n_rec, n_lig = int(n_pad * 0.55), int(n_pad * 0.38)
    mk = lambda ca: np.stack([ca + [-1.2, 0.8, 0.35] + r.randn(*ca.shape) * 0.05, ca,
                              ca + [1.3, 0.7, -0.4] + r.randn(*ca.shape) * 0.05], 1)
    rec_ca = np.cumsum(r.randn(n_rec, 3) * 1.5 + [3.8, 0, 0], axis=0)
    lig_ca = np.cumsum(r.randn(n_lig, 3) * 1.5 + [3.8, 0, 0], axis=0) + [12, 6, 0]
    return pad_complex(r.randn(n_rec, 1301).astype(np.float32),
                       r.randn(n_lig, 1301).astype(np.float32),
                       mk(rec_ca).astype(np.float32), mk(lig_ca).astype(np.float32),
                       pad_to=n_pad)


def bf16_parity_phase(raw, device):
    """The bf16 parity matrix: the fast() ScoreNet (bf16, the kernels) on the
    card against the eager float32 path (ModelConfig()) on the CPU, the same
    seeded weights (seed 0, as phase 4), over N in PARITY_NS x t in PARITY_T
    (1AVX's native pose at 448, bench.py's random-walk complexes at the
    others; one pose, edges selected once on the card and injected on both
    sides), num_clashes exact.  Each output of each case passes on
    PARITY_TOL / PARITY_ABS, or else within BF16_ROUTE_FACTOR times the
    distance of the eager bf16 route (ModelConfig(compute_dtype="bfloat16"),
    no kernel, on the CPU) from float32 on the same case: the distance that
    bf16 compute itself sets.  Against true float32 the bf16 products
    can turn rot_score, the direction of a torque summed over the ligand
    with much cancellation at random weights, by more than PARITY_TOL's 2e-2
    (seed 0, 1AVX: 3.2e-2 through the kernels' plain versions, 3.6e-2 on the
    eager bf16 route; the CPU), while bench.py's BENCH_r05.json reference
    ran on a TPU, whose float32 matmuls at default precision take bf16
    operands.  The counts on each criterion are printed.  Then the trained
    DFMDock lineage's fast() forward against its eager float32 path on phase
    4's inputs at PARITY_TOL / PARITY_ABS."""
    cpu = torch.device("cpu")
    net_k = load_model(None, DFMDockConfig(model=ModelConfig.fast()), device, seed=0)
    net_p = load_model(None, DFMDockConfig(model=ModelConfig()), cpu, seed=0)
    net_e = load_model(None, DFMDockConfig(model=ModelConfig(compute_dtype="bfloat16")), cpu,
                       seed=0)
    worst = {name: (0.0, "") for name in SCORE_NET_OUTPUTS}
    on_tol = on_route = 0
    for n_pad in PARITY_NS:
        cx = (complex_to_batch(raw, pad_to=n_pad) if n_pad == N_PAD
              else synthetic_complex(n_pad, seed=n_pad))
        batch = batch_to_tensors(cx, device)
        host = {k: v.cpu() for k, v in batch.items()}
        pos = batch["pos"][None].contiguous()
        edges = select_edges(pairwise_ca_dist(pos), batch["node_mask"],
                             generator=torch.Generator(device).manual_seed(7))
        host_edges = tuple(e.cpu() for e in edges)
        for t in PARITY_T:
            label = f"bf16 matrix {'1AVX' if n_pad == N_PAD else 'synth'}/{n_pad} t={t}"
            reset_counts()
            with torch.no_grad(), recording_kernels() as calls:
                o_k = net_k(batch, pos, t, edges=edges)
                torch.cuda.synchronize()
            if launch_counts()["fused_egcl_bf16"] == 0 or launch_counts()["fused_egcl"] != 0:
                raise AssertionError(f"{label}: launches {launch_counts()}")
            with torch.no_grad():
                o_p = net_p(host, pos.cpu(), t, edges=host_edges)
            errs = parity_errors(SCORE_NET_OUTPUTS, o_k, o_p, f32=False)
            off = [name for name, (_, _, ok) in errs.items() if not ok]
            route = {}
            if off and "num_clashes" not in off:
                with torch.no_grad():
                    o_e = net_e(host, pos.cpu(), t, edges=host_edges)
                route = {name: max_errs(o_e[name], o_p[name])[1] for name in off}
            bad = [name for name in off
                   if name not in route or errs[name][1] > BF16_ROUTE_FACTOR * route[name]]
            for name, (a_err, r_err, ok) in errs.items():
                note = ("" if ok else f" (eager bf16 route rel {route[name]:.3e}: "
                        f"{'within' if name not in bad else 'beyond'} {BF16_ROUTE_FACTOR}x)"
                        if name in route else " FAIL")
                log(f"# parity {label} {name}: max abs {a_err:.3e} rel {r_err:.3e} "
                    f"{'ok' if ok else ''}{note}")
                if name in worst and r_err > worst[name][0]:
                    worst[name] = (r_err, label)
            if bad:
                diagnose_kernels(calls)
                raise AssertionError(f"bf16 parity matrix failed: {label} {bad}")
            on_tol, on_route = on_tol + (not off), on_route + bool(off)
    log(f"# bf16 parity matrix (seeded weights, seed 0): {on_tol}/"
        f"{len(PARITY_NS) * len(PARITY_T)} cases pass PARITY_TOL / PARITY_ABS on every output, "
        f"{on_route} on the eager bf16 route's bound; worst rel " + ", ".join(
            f"{k} {v:.3e} ({at})" for k, (v, at) in worst.items())
        + " (the JAX package's compiled Pallas path against its TPU reference, "
        "BENCH_r05.json: 12/12, worst energy 9.7e-3, ires 2.3e-2)")
    dfmdock_parity_phase(raw, device, ModelConfig.fast(), ModelConfig())


def bucket_sizes(ids, bucket=128):
    """{id: its padded N in the sweep CLI's buckets} of DB5 complexes."""
    ds = NPZDataset(os.path.join("data", "db5_npz"))
    out = {}
    for cid in ids:
        r = ds.load_raw(ds.ids.index(cid))
        out[cid] = round_up(r["rec_x"].shape[0] + r["lig_x"].shape[0], bucket)
    return out


def dfmdock_sweep_phase(out_root, bf16=False):
    """The sweep --lineage dfmdock with its trained weights, 40 poses, seed 5:
    over the four complexes it was trained on, gated against the JAX record
    eval_train.csv, then the four it never saw beside eval_holdout.csv, on
    the float32 kernel route.  With `bf16`, the sweep CLI's default route
    (fast(), bf16), both sets beside their records with no gate: the port's
    pick mean falls under the training set's limit at half of seeds 5-12 on
    any device (ROADMAP F4), so a gate at one seed on a new route would gate
    the draw, not the route; the bf16 route's quality over seeds 5-10 is
    read by scripts/dfmdock_witness.py --sides port-cuda-bf16.  Each forward
    makes six agg-only fused_egcl launches (one edge table) of the route's
    mode and no fused_egcl_coord or fused_energy launch.  The sweep
    captures one sample graph a bucket (the pair heads' static rows)."""
    result = None
    kernels, absent = ((DFMDOCK_KERNELS_BF16, DFMDOCK_ABSENT_BF16) if bf16
                       else (DFMDOCK_KERNELS, DFMDOCK_ABSENT))
    egcl = "fused_egcl_bf16" if bf16 else "fused_egcl"
    tag = " bf16" if bf16 else ""
    for label, ids, record, gate in (
            ("train", DFMDOCK_TRAIN, "eval_train.csv", not bf16),
            ("held-out", DFMDOCK_HOLDOUT, "eval_holdout.csv", False)):
        out_csv = os.path.join(out_root, f"dfmdock_{label}{tag.strip()}.csv")
        rows, wall, launches = run_path(
            f"dfmdock sweep {label}{tag}", kernels, lambda: sweep.main(
                ["--lineage", "dfmdock", "--ckpt", DFMDOCK_NPZ, "--ids", ",".join(ids),
                 "--num-samples", str(DFMDOCK_POSES), "--seed", "5", "--out-csv", out_csv],
                None if bf16 else FAST_F32),
            absent=absent)
        if launches[egcl] != 6 * launches["edge_table"]:
            raise AssertionError(f"dfmdock sweep: {launches[egcl]} {egcl} for "
                                 f"{launches['edge_table']} forwards")
        stats, buckets = graph_mod.totals(), len(set(bucket_sizes(ids).values()))
        if stats.captures != buckets or stats.replays != len(ids):
            raise AssertionError(f"dfmdock sweep {label}{tag}: {stats.captures} captures and "
                                 f"{stats.replays} replays for {len(ids)} complexes in "
                                 f"{buckets} buckets")
        log(f"# dfmdock sweep {label}{tag} ({', '.join(ids)}) P={DFMDOCK_POSES} steps={STEPS}: "
            f"wall {wall:.3f} s, {launches['edge_table']} forwards; {stats.captures} "
            f"capture(s) for {len(ids)} complexes in {buckets} bucket(s) of 128")
        quality_gate(f"dfmdock sweep {label}{tag}", rows,
                     os.path.join("ckpts", "db5_holdout_dfmdock", record), set(ids), gate)
        result = result or launches
    return result


def picard_phase(raw, device, out_root):
    """Picard latency mode with the trained mlsb weights on 1AVX, one pose:
    the dock CLI with --picard-iters 10 beside the sequential --ode dock
    (walls); then Picard at K = T iterations against the sequential ODE from
    the same generator seed (start pose and edge noise): K = T against
    K = T + 1 (the fixed point: bit-equal), against the sequential ODE run at
    Picard's launch shape (bit-equal), one Picard round on the 1-pose
    sequential trajectory's states (PICARD_STEP_TOL), and the 1-pose
    trajectory state by state up to the first forward whose edges or bins
    differ (PICARD_STEP_TOL; with the same throughout, the final poses too)."""
    walls = {}
    for label, flags in (("picard-iters 10", ["--picard-iters", "10"]),
                         ("sequential --ode", ["--ode"])):
        out = os.path.join(out_root, label.replace(" ", "_"))
        argv = ["--npz", NPZ, "--ckpt", DEMO_NPZ, "--num-samples", "1", "--num-steps",
                str(STEPS), "--out-dir", out] + flags
        dock.main(argv, FAST_F32)  # warm-up: the first forwards at this shape
        rows, walls[label], launches = run_path(f"dock {label}", DOCK_KERNELS,
                                                lambda: dock.main(argv, FAST_F32), F32_ABSENT)
        log(f"# dock 1AVX {label} P=1 steps={STEPS}: wall {walls[label]:.3f} s, "
            f"{launches['edge_table']} forwards, DockQ {rows[0]['DockQ']:.3f}")
    log(f"# Picard latency trade (P=1): {walls['picard-iters 10']:.3f} s with 10 iterations "
        f"against {walls['sequential --ode']:.3f} s sequential")
    cfg = DFMDockConfig(model=FAST_F32, sampler=SamplerConfig(num_steps=STEPS, ode=True))
    net = load_model(DEMO_NPZ, cfg, device)
    seq_sampler = build_sampler(net, cfg)
    batch = batch_to_tensors(complex_to_batch(raw), device)
    gen = lambda: torch.Generator(device).manual_seed(11)
    picard = lambda k: PicardSampler(net, seq_sampler.r3, seq_sampler.so3, cfg.sampler,
                                     num_iters=k)
    # the edges and bins of every forward: the sequential run's T, then
    # Picard's K = T rounds (the last round's T poses: its fixed point's)
    edges, bins = [], []
    select, table = score_net_mod.select_edges, egnn_mod.build_edge_table

    def recording(record, fn):
        def call(*args, **kwargs):
            result = fn(*args, **kwargs)
            record.append(result)
            return result
        return call

    score_net_mod.select_edges = recording(edges, select)
    egnn_mod.build_edge_table = recording(bins, table)
    try:
        # eager (capture=False): the recorders run in Python every forward
        seq = seq_sampler.sample(batch, 1, gen(), record_trajectory=True, capture=False)
        seq_edges, seq_bins = edges[:STEPS], [b[0] for b in bins[:STEPS]]
        edges.clear()
        bins.clear()
        pic = picard(STEPS).sample(batch, 1, gen(), record_trajectory=True, capture=False)
        pic_edges, pic_bins = edges[STEPS - 1], bins[STEPS - 1][0]
    finally:
        score_net_mod.select_edges, egnn_mod.build_edge_table = select, table
    # K = T + 1 captured (the default) against the eager K = T
    if not torch.equal(pic["pos"], picard(STEPS + 1).sample(batch, 1, gen())["pos"]):
        raise AssertionError("Picard: K = T and K = T + 1 iterations differ (no fixed point)")
    # the start pose and each step's edge noise, drawn as both samplers draw them
    g = gen()
    pos0, _, _ = randomize_pose(g, batch["pos"], batch["lig_mask"], batch["node_mask"],
                                cfg.sampler, 1)
    n = pos0.shape[1]
    gumbel = torch.cat([sample_gumbel((1, n, n), g, device) for _ in range(STEPS)])
    ts, dt, _, _ = step_schedule(cfg.sampler)
    t_all = torch.tensor(ts, device=device)
    step = lambda x, drift, t: modify_coords(
        x, batch["lig_mask"], seq_sampler.so3.reverse_step(drift["rot_score"], t, dt, ode=True),
        seq_sampler.r3.reverse_step(drift["tr_score"], t, dt, ode=True),
        cfg.sampler.center_mode)
    batch["h0"] = net.embed_nodes(batch["x"])
    with torch.no_grad():
        # the sequential ODE with every forward at the Picard forward's launch
        # shape (T poses, step s's pose in slot s): the same arithmetic, so
        # Picard's fixed point must equal it bit for bit
        slots, x = pos0.expand(STEPS, -1, -1, -1).clone(), pos0
        for s, t in enumerate(ts):
            slots[s] = x[0]
            drift = net(batch, slots, t_all, gumbel=gumbel, scores_only=True)
            x = step(x, {k: v[s : s + 1] for k, v in drift.items()}, t)
        # the 1-pose sequential trajectory through one Picard round: every
        # step's drift at the sequential state before it, in one T-pose
        # forward, each state moved one step on its own
        seq_states = torch.cat([pos0, seq["trajectory"][0, :-1]])
        drift = net(batch, seq_states, t_all, gumbel=gumbel, scores_only=True)
        step_diff = max(float((step(seq_states[s : s + 1], {k: v[s : s + 1] for k, v in
                                                            drift.items()}, t)
                               - seq["trajectory"][:, s]).abs().max())
                        for s, t in enumerate(ts))
    same_shape = float((pic["pos"] - x).abs().max())
    # Picard's and the 1-pose run's trajectories step by step: the state
    # before each step, and the discrete features its forward took from it
    pic_states = torch.cat([pos0, pic["trajectory"][0, :-1]])
    state_diff = (pic_states - seq_states).abs().amax(dim=(1, 2, 3)).tolist()
    knn, first_flip = cfg.model.knn, None

    def discrete_diff(s):
        """What the two runs' forward s selected differently, or None: some
        row's neighbour set, else, on the same sets, some edge's bins."""
        (i_s, m_s), (i_p, m_p) = seq_edges[s], (pic_edges[0][s : s + 1],
                                                pic_edges[1][s : s + 1])
        key_s, key_p = torch.where(m_s > 0.5, i_s, n), torch.where(m_p > 0.5, i_p, n)
        o_s, o_p = torch.argsort(key_s, -1), torch.argsort(key_p, -1)
        rows = (key_s.gather(-1, o_s) != key_p.gather(-1, o_p)).any(-1)[0]
        if rows.any():
            in_knn = (torch.sort(key_s[..., :knn], -1)[0]
                      != torch.sort(key_p[..., :knn], -1)[0]).any(-1)[0]
            row = int(torch.nonzero(rows)[0])
            # the kNN cut of that row in the sequential state: ranks knn, knn + 1
            d = torch.sort(pairwise_ca_dist(seq_states[s : s + 1])[0, row]
                           .masked_fill(~batch["node_mask"], float("inf")))[0]
            return (f"{int(rows.sum())} rows with another neighbour set "
                    f"({int(in_knn.sum())} in the kNN part); row {row}'s kNN cut "
                    f"d{knn} {float(d[knn - 1]):.6f} A, d{knn + 1} {float(d[knn]):.6f} A")
        order = lambda b, o: b.gather(2, o[..., None].expand(-1, -1, -1, b.shape[-1]))
        bad = (order(seq_bins[s], o_s) != order(pic_bins[s : s + 1], o_p)) \
            & (key_s.gather(-1, o_s) < n)[..., None]
        if bad.any():
            return (f"the same neighbour sets, {int(bad.any(-1).sum())} edges in another "
                    f"bin (dist, omega, theta, phi, relpos: "
                    f"{bad.sum((0, 1, 2)).tolist()})")
        return None

    for s in range(STEPS):
        flip = discrete_diff(s)
        if flip is not None:
            first_flip = s
            break
    before = max(state_diff[: (STEPS if first_flip is None else first_flip + 1)])
    delta = float((pic["pos"] - seq["pos"]).abs().max())
    log(f"# Picard K=T={STEPS}: equal to K=T+1 bit for bit; against the sequential ODE at "
        f"the same launch shape (T poses a forward) max |diff| {same_shape:.3e} A (must be "
        f"0); one Picard round on the 1-pose sequential run's states moves each to the next "
        f"within {step_diff:.3e} A (tolerance {PICARD_STEP_TOL} A)")
    log(f"# Picard K=T vs the 1-pose sequential ODE (same start and edge noise): the states "
        f"agree within {before:.3e} A up to "
        + ("the end: every forward selected the same edges and bins" if first_flip is None
           else f"the first forward whose edges or bins differ, step {first_flip + 1}: {flip}")
        + f" (tolerance {PICARD_STEP_TOL} A); state diff by step "
        + " ".join(f"{d:.1e}" for d in state_diff)
        + f"; final pose max |diff| {delta:.3e} A")
    if same_shape != 0.0 or step_diff > PICARD_STEP_TOL or before > PICARD_STEP_TOL:
        raise AssertionError(f"Picard vs the sequential ODE: same shape {same_shape:.3e} A, "
                             f"step {step_diff:.3e} A, before the edges or bins part "
                             f"{before:.3e} A")
    if first_flip is None and delta > PICARD_STEP_TOL:
        raise AssertionError(f"Picard vs the sequential ODE: the same edges and bins, "
                             f"final poses {delta:.3e} A apart")
    # the fixed point on the bf16 route: K = T and K = T + 1 bit-equal
    cfg16 = dataclasses.replace(cfg, model=ModelConfig.fast())
    net16 = load_model(DEMO_NPZ, cfg16, device)
    picard16 = lambda k: PicardSampler(net16, seq_sampler.r3, seq_sampler.so3, cfg16.sampler,
                                       num_iters=k).sample(batch, 1, gen())["pos"]
    same, _, launches16 = run_path("Picard bf16 K=T and K=T+1", DOCK_KERNELS_BF16,
                                   lambda: torch.equal(picard16(STEPS), picard16(STEPS + 1)),
                                   BF16_ABSENT)
    if not same:
        raise AssertionError("Picard bf16: K = T and K = T + 1 iterations differ")
    log(f"# Picard bf16 (fast()) K=T={STEPS}: equal to K=T+1 bit for bit "
        f"({launches16['edge_table']} forwards in the two runs)")


def pdb_dock_phase(out_root, npz_launches):
    """The dock from PDB files: 1AVX's receptor and ligand written as two PDBs
    from the npz backbone (save_pdb), docked through the CLI with the
    trained mlsb weights and --one-hot-only (P poses x STEPS steps); then a
    --csv of two rows (the npz, the PDB pair), on the float32 kernel route.
    The forwards launch the --npz dock's kernels in the same counts (twice
    over for the CSV).  No
    DockQ gate: the zeroed ESM columns are not what the model was trained
    on."""
    raw = load_npz_complex(NPZ)
    rec, lig = os.path.join(out_root, "1AVX_r.pdb"), os.path.join(out_root, "1AVX_l.pdb")
    save_pdb(rec, raw["rec_pos"], raw["rec_seq"])
    save_pdb(lig, raw["lig_pos"], raw["lig_seq"])
    pairs = os.path.join(out_root, "pairs.csv")
    with open(pairs, "w") as f:
        f.write(f"1AVX_npz,{NPZ},-\n1AVX_pdb,{rec},{lig}\n")
    common = ["--ckpt", DEMO_NPZ, "--one-hot-only", "--num-samples", str(P),
              "--num-steps", str(STEPS)]
    for label, src, jobs in (("pdb dock", ["--pdb", rec, lig], 1),
                             ("csv dock", ["--csv", pairs], 2)):
        out = os.path.join(out_root, label.replace(" ", "_"))
        rows, wall, launches = run_path(label, DOCK_KERNELS, lambda: dock.main(
            src + common + ["--out-dir", out], FAST_F32), F32_ABSENT, trace=jobs == 1)
        want = {k: jobs * v for k, v in npz_launches.items()}
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, the --npz dock's x{jobs}: "
                                 f"{want}")
        if len(rows) != jobs * P or not np.isfinite([r["energy"] for r in rows]).all():
            raise AssertionError(f"{label}: {len(rows)} rows or non-finite energies")
        dq = [r["DockQ"] for r in rows]
        log(f"# {label} 1AVX ({jobs} job{'s' * (jobs > 1)}, --one-hot-only, trained mlsb) "
            f"P={P} steps={STEPS}: wall {wall:.3f} s, {wall / (jobs * P):.4f} s per docked "
            f"pose; launches equal the --npz dock's x{jobs}; best DockQ {max(dq):.3f} "
            f"(against the input complex; not gated)")


def esm_phase(device, ref_layers=4, reps=3):
    """ESM2-650M at full width (33 layers, 1280 hidden, 20 heads, FFN 5120)
    with seeded weights (drawn on the card): the first `ref_layers` layers
    on the card against the same layers on the CPU (rel <= ESM_REL, TF32
    off), then 1AVX's two chains embedded through all 33 layers: wall
    (synchronized, median of `reps`) and peak memory."""
    raw = load_npz_complex(NPZ)
    model = ESM2(ESM2_650M).to(device).init_weights(torch.Generator(device).manual_seed(0))
    model.eval()
    small = ESM2(dataclasses.replace(ESM2_650M, num_layers=ref_layers)).eval()
    small.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()
                           if not k.startswith("layers.") or int(k.split(".")[1]) < ref_layers})
    tokens = torch.from_numpy(tokenize(raw["rec_seq"]))
    with torch.no_grad():
        got = model(tokens.to(device), num_layers=ref_layers).cpu()
        want = small(tokens)
    a_err, r_err, _ = max_errs(got, want)
    log(f"# ESM2-650M, the first {ref_layers} layers on the card vs the CPU ({len(tokens)} "
        f"tokens): max abs {a_err:.3e} rel {r_err:.3e} (limit {ESM_REL})")
    if r_err > ESM_REL or not torch.isfinite(got).all():
        raise AssertionError(f"ESM2 card vs CPU: rel {r_err:.3e}")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps + 1):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs = [embed_sequence(model, raw[k]) for k in ("rec_seq", "lig_seq")]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for e, k in zip(embs, ("rec_seq", "lig_seq")):
        if e.shape != (len(raw[k]), 1280) or not torch.isfinite(e).all():
            raise AssertionError(f"ESM2 embedding of {k}: shape {tuple(e.shape)}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"# ESM2-650M embed of 1AVX's two chains ({len(raw['rec_seq'])} + "
        f"{len(raw['lig_seq'])} residues, 33 layers, {n_params / 1e6:.1f} M parameters, "
        f"{4 * n_params / 1e9:.2f} GB f32): {1e3 * statistics.median(walls[1:]):.2f} ms "
        f"(median of {[round(1e3 * w, 2) for w in walls[1:]]} ms; first call "
        f"{1e3 * walls[0]:.2f} ms), peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del model


def grad_errors(net_k, net_p):
    """{parameter: (max abs err, max |CPU grad|)} of two nets' gradients (a
    parameter the loss does not reach has none, read as zeros)."""
    grad = lambda p: torch.zeros_like(p, device="cpu") if p.grad is None else p.grad.cpu()
    params_p = dict(net_p.named_parameters())
    return {name: ((grad(p) - grad(params_p[name])).abs().max().item(),
                   grad(params_p[name]).abs().max().item())
            for name, p in net_k.named_parameters()}


def step_config(flags, device, compute_dtype=None):
    """The training CLI's config at `flags` with dropout 0 and kNN-only edges
    (sample_size 0), as the card-vs-CPU step check runs it; `compute_dtype`
    overrides the flags' precision."""
    cfg = train.experiment_config(train.parse_args(flags + ["--device", device.type]))
    model = dataclasses.replace(cfg.model, dropout=0.0, sample_size=0)
    if compute_dtype is not None:
        model = dataclasses.replace(model, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, model=model)


def step_row(flags, device):
    """The pool row of the card-vs-CPU step check and its perturbation."""
    args = train.parse_args(flags + ["--device", device.type])
    ds = NPZDataset(args.data_dir)
    row = make_training_batch(ds.load_raw(0), args.crop_size, round_up(args.crop_size),
                              np.random.RandomState(0))
    rng = np.random.RandomState(1)
    inj = {"t": np.float32(0.4), "tr_update": rng.randn(1, 3).astype(np.float32) * 4,
           "tr_score_gt": rng.randn(1, 3).astype(np.float32), "tr_scale": np.float32(0.3),
           "rot_update": rng.randn(1, 3).astype(np.float32) * 0.5,
           "rot_score_gt": rng.randn(1, 3).astype(np.float32), "rot_scale": np.float32(0.9)}
    return row, inj


@contextlib.contextmanager
def float32_selection():
    """Edges selected from float32 distances (and sampling keys) within the
    block: a float64 step then selects as the float32 and bf16 steps do (the
    selection gives integers), and on the card through select_topk's
    kernel, which reads float32."""
    select = edges_mod.select_topk
    edges_mod.select_topk = lambda dist, y, *a, **k: select(dist.float(), y.float(), *a, **k)
    try:
        yield
    finally:
        edges_mod.select_topk = select


def step_gradients(cfg, lineage, weights, row, inj, device, float64=False):
    """One training step (loss and backward) of `lineage` at `cfg` from
    `weights` on the pool row `row` with the perturbation `inj`: (loss
    terms, {parameter: gradient, on the CPU}), a parameter the loss does not
    reach read as zeros.  `float64`: the net, the row and the perturbation
    in float64, and float64 the default dtype of what the step makes, but
    for the edge selection (float32_selection)."""
    r3, so3 = R3Diffuser(cfg.diffuser.r3), SO3Diffuser(cfg.diffuser.so3)
    default = torch.get_default_dtype()
    if float64:
        torch.set_default_dtype(torch.float64)
    try:
        net = load_model(None, cfg, device, lineage=lineage)
        net.load_state_dict(weights)
        batch = upload(row, device)
        if float64:
            net = net.double()
            batch = {k: v.double() if torch.is_tensor(v) and v.dtype == torch.float32 else v
                     for k, v in batch.items()}
        with float32_selection() if float64 else contextlib.nullcontext():
            loss, terms = train.LOSSES[lineage](net, r3, so3, batch,
                                                torch.Generator(device).manual_seed(0),
                                                cfg.experiment, injected=inj)
            loss.backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        torch.set_default_dtype(default)
    grad = lambda p: torch.zeros_like(p, device="cpu") if p.grad is None else p.grad.cpu()
    return terms, {name: grad(p) for name, p in net.named_parameters()}


def keep_failing_step(label, lineage, flags, weights, row, inj, card, cpu, device,
                      tols=(TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR),
                      out_dir=TRAIN_FAILURE_DIR):
    """A failed card-vs-CPU step check's case, kept: the step's weights,
    pool row, perturbation, both gradient sets (`card`, `cpu`) and the
    check's `tols` to one file under `out_dir` (its path printed), then the
    step replayed in float64 on `device` and the CPU (replay_failing_step).
    Returns (path, the replay's rows, its float64 gradients by device type)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"train_step_{label.replace(' ', '_')}.pt")
    torch.save({"label": label, "lineage": lineage, "flags": flags,
                "weights": {k: v.detach().cpu() for k, v in weights.items()},
                "row": row, "inj": inj, "card": card, "cpu": cpu, "tols": tuple(tols)}, path)
    log(f"# train {label}: the failing step is kept in {path}")
    return (path, *replay_failing_step(path, device))


def replay_failing_step(path, device, worst=5):
    """The step kept in `path` replayed in float64 (compute_dtype float32,
    every product in float64) on the CPU and on `device`: the two float64
    readings' distance, then for the `worst` arrays (the largest card-vs-CPU
    gap as a multiple of the check's bound on it: grad_rel of the array's
    largest CPU gradient plus grad_floor of the largest of all) how far each
    saved gradient lies from the float64 reading of the CPU, and which side
    lies farther.
    Returns (one dict per array, {device type: float64 gradients})."""
    kept = torch.load(path, weights_only=False)
    cfg = step_config(kept["flags"], torch.device("cpu"), compute_dtype="float32")
    ref = {}
    for dev in dict.fromkeys((torch.device("cpu"), device)):
        _, ref[dev.type] = step_gradients(cfg, kept["lineage"], kept["weights"], kept["row"],
                                          kept["inj"], dev, float64=True)
    f64 = ref["cpu"]
    top = max(float(g.abs().max()) for g in f64.values())
    if device.type != "cpu":
        gap = max(float((ref[device.type][k] - g).abs().max()) for k, g in f64.items())
        log(f"# replay {kept['label']}: float64 on {device.type} against float64 on the CPU: "
            f"max abs {gap:.3e} ({gap / top:.3e} of the largest gradient)")
    card, cpu, (_, grad_rel, grad_floor) = kept["card"], kept["cpu"], kept["tols"]
    top_cpu = max(float(g.abs().max()) for g in cpu.values())
    gap = {k: float((card[k] - cpu[k]).abs().max()) for k in f64}
    bound = {k: grad_rel * float(cpu[k].abs().max()) + grad_floor * top_cpu + 1e-30 for k in f64}
    rows = []
    for k in sorted(gap, key=lambda k: gap[k] / bound[k], reverse=True)[:worst]:
        d_card = float((card[k].double() - f64[k]).abs().max())
        d_cpu = float((cpu[k].double() - f64[k]).abs().max())
        farther = "card" if d_card > d_cpu else "cpu" if d_cpu > d_card else "neither"
        largest = float(f64[k].abs().max())
        rows.append({"array": k, "largest": largest, "card_vs_cpu": gap[k],
                     "of_bound": gap[k] / bound[k], "card_vs_f64": d_card, "cpu_vs_f64": d_cpu,
                     "farther": farther})
        log(f"# replay {kept['label']} {k}: card vs CPU {gap[k]:.3e} ({gap[k] / bound[k]:.3g} "
            f"of its bound), card vs float64 {d_card:.3e}, CPU vs float64 {d_cpu:.3e} (largest "
            f"float64 gradient {largest:.3e}): farther from float64: {farther}")
    return rows, ref


def train_step_parity(label, lineage, flags, weights, device,
                      tols=(TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR), row=None):
    """One training step on the card against the same step on the CPU: the
    same weights, one pool row, an injected perturbation, dropout 0 and
    kNN-only edges (sample_size 0: the card selects through select_topk,
    the CPU through its plain version); `tols` = (loss_rel, grad_rel,
    grad_floor): the loss terms within loss_rel and every gradient within
    grad_rel of its array's largest (the floor grad_floor of the largest
    gradient of all, for arrays whose gradient is zero by construction,
    such as the bias before a GraphNorm); by default the float32 ones.
    `row`: (pool row, perturbation) in place of step_row's.  A failing step
    is kept and replayed in float64 (keep_failing_step) before the check
    fails with its own failures, whether or not the replay ran."""
    loss_rel, grad_rel, grad_floor = tols
    cfg = step_config(flags, device)
    row, inj = step_row(flags, device) if row is None else row
    terms, grads = {}, {}
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        terms[dev.type], grads[dev.type] = step_gradients(cfg, lineage, weights, row, inj, dev)
        log(f"# train {label}: one step (loss and backward) on {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    failures = []
    for k, v in terms["cpu"].items():
        a_err, r_err, _ = max_errs(terms[device.type][k].detach().cpu(), v.detach())
        log(f"# train {label} card vs CPU {k}: {float(v):.6f} rel {r_err:.3e}")
        if r_err > loss_rel and a_err > 1e-7:
            failures.append(f"train {label}: {k} card vs CPU rel {r_err:.3e}")
    errs = {name: (float((grads[device.type][name] - g).abs().max()), float(g.abs().max()))
            for name, g in grads["cpu"].items()}
    top = max(scale for _, scale in errs.values())
    rel = {name: err / (scale + 1e-30) for name, (err, scale) in errs.items()}
    for name in sorted(rel, key=rel.get, reverse=True)[:3]:
        log(f"# train {label} card vs CPU gradient of {name}: max abs {errs[name][0]:.3e}, "
            f"rel {rel[name]:.3e} of its largest {errs[name][1]:.3e}")
    failures += [f"train {label}: gradient of {name} card vs CPU max abs {err:.3e}, its "
                 f"largest {scale:.3e}" for name, (err, scale) in errs.items()
                 if err > grad_rel * scale + grad_floor * top]
    if failures:
        try:
            keep_failing_step(label, lineage, flags, weights, row, inj, grads[device.type],
                              grads["cpu"], device, tols)
        except Exception as exc:   # a diagnosis: the check's failures are what it raises
            log(f"# train {label}: keeping or replaying the failing step failed: {exc!r}")
        raise AssertionError("; ".join(failures))
    log(f"# train {label} card vs CPU: {len(errs)} gradient arrays within rel "
        f"{grad_rel} of their largest or {grad_floor} of the largest of all "
        f"({top:.3e}); worst {max(err for err, _ in errs.values()) / top:.3e} of it")


def train_rows(flags, device, count, seed=0):
    """`count` pool rows of the training data at `flags`' crop (seed `seed`),
    stacked into a device pool."""
    args = train.parse_args(flags + ["--device", device.type])
    ds = NPZDataset(args.data_dir)
    rng = np.random.RandomState(seed)
    made = [make_training_batch(ds.load_raw(i % len(ds)), args.crop_size,
                                round_up(args.crop_size), rng) for i in range(count)]
    return upload({k: np.stack([b[k] for b in made]) for k in made[0]}, device)


def pool_stepper(net, lineage, flags, device, seed, capture, loss=None):
    """A PoolStep of the trained `net` with a fresh optimizer, at the
    training CLI's `flags`, drawing from a generator seeded `seed`."""
    cfg = train.experiment_config(train.parse_args(flags + ["--device", device.type]))
    r3, so3 = R3Diffuser(cfg.diffuser.r3), SO3Diffuser(cfg.diffuser.so3)
    return PoolStep(net, r3, so3, cfg.experiment, make_optimizer(net, cfg.experiment),
                    loss or train.LOSSES[lineage], torch.Generator(device).manual_seed(seed),
                    capture=capture)


def host_launches(events, steps):
    """Kernel and graph launches the host made a step, from the profiler's
    runtime records (None where the trace holds none)."""
    calls = [e for e in events if "Launch" in e.key and e.key.startswith(("cuda", "cu"))]
    return sum(e.count for e in calls) / steps if calls else None


def train_profile(net, lineage, flags, device, steps=TRAIN_PROFILE_STEPS, distinct=4,
                  top=8):
    """The device's busy and idle share over `steps` training steps of the
    trained net (fresh optimizer) on a pool of `distinct` rows of seed 0, on
    each route: PoolStep captured (one graph replayed a step) and eager.
    The first epoch (warm-up and capture on the captured route) runs before
    the window.  Returns {route: {steps_s, idle, peak_gb, launches (device
    kernels a step), host_calls (launch calls a step), top}} (idle None
    where the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    pool = train_rows(flags, device, distinct)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    windows = {}
    for route, capture in (("captured", True), ("eager", False)):
        net.load_state_dict(state)
        stepper = pool_stepper(net, lineage, flags, device, 3, capture)
        stepper.load(pool)
        stepper.epoch()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # no host-op tracing cost
            t0 = time.perf_counter()
            done = 0
            while done < steps:
                for _ in range(min(stepper.start(), steps - done)):
                    stepper.step()
                    done += 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        w = {"steps_s": steps / wall_ms * 1e3, "idle": None,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": sum(e.count for e in kernels) / steps,
             "host_calls": host_launches(events, steps), "captures": stepper.captures,
             "device_ms": busy_ms / steps,
             "top": [(e.key, dev_us(e) / 1e3 / steps, e.count / steps)
                     for e in sorted(kernels, key=dev_us, reverse=True)[:top]]}
        windows[route] = w
        calls = "not measured" if w["host_calls"] is None else f"{w['host_calls']:.0f}"
        if busy_ms == 0:
            log(f"# train {lineage} {route} profile: the profiler recorded no device time "
                f"(not measured); {w['steps_s']:.3f} steps/s; card {CARD[0]}")
            continue
        w["idle"] = 1 - busy_ms / wall_ms
        log(f"# train {lineage} {route} profile, {steps} steps: wall {wall_ms:.1f} ms "
            f"({w['steps_s']:.3f} steps/s), device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * w['idle']:.1f}%, "
            f"{w['launches']:.0f} device kernels and {calls} host launch calls a step, "
            f"{stepper.captures} capture(s), {w['device_ms']:.3f} ms of device time a step, "
            f"peak {w['peak_gb']:.3f} GB; card {CARD[0]}")
        for key, ms, count in w["top"]:
            log(f"#   {ms:9.3f} ms/step {100 * ms / w['device_ms']:5.1f}% x{count:<7.1f} "
                f"{key[:90]} ({route}; card {CARD[0]})")
    if "indexing_backward" in " ".join(k for w in windows.values() for k, _, _ in w["top"]):
        raise AssertionError(f"train {lineage}: indexing_backward_kernel is among the top "
                             "device operations of a training step")
    return windows


def grad_gaps(net_a, net_b):
    """{parameter: (max abs gap, largest |b|)} of two nets' gradients."""
    grad = lambda p: torch.zeros_like(p) if p.grad is None else p.grad
    params_b = dict(net_b.named_parameters())
    return {name: (float((grad(p) - grad(params_b[name])).abs().max()),
                   float(grad(params_b[name]).abs().max()))
            for name, p in net_a.named_parameters()}


@contextlib.contextmanager
def deterministic(record):
    """torch.use_deterministic_algorithms within the block (warn_only): the
    ops with no deterministic CUDA path warn, and their warnings' first
    lines are added to the set `record`."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        record.update(str(w.message).splitlines()[0][:120] for w in caught
                      if "determinis" in str(w.message))
    finally:
        torch.use_deterministic_algorithms(False)


def captured_vs_eager(label, lineage, flags, weights, device, epoch_steps=2,
                      tols=(TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR)):
    """Two epochs of `epoch_steps` training steps each, replayed from the
    captured graph (warm-up, capture, replays), against as many eager
    steps, both PoolStep from the trained `weights` and one generator seed,
    with a pool refresh between the epochs (`load` of a second pool of the
    same shapes, copied into the captured buffers; the second epoch draws a
    new permutation), both under torch.use_deterministic_algorithms (the
    gathers' backward otherwise adds in any order, and Adam's first step,
    ~lr * sign(g), turns that noise into weights 2 lr apart).  Gates: the
    weights after every step bit-equal (the arrays that differ and the ops
    that warned of no deterministic path named); the last step's gradients
    bit-equal, else each array within tols' (rel of its largest, floor of
    the largest of all: 9g's step bounds); the generator's state after
    equal; two replays of one row (the second pool holds one row twice)
    rotating it differently (each replay's rotated coordinates copied into
    a buffer)."""
    with deterministic(ops := set()):
        _captured_vs_eager(label, lineage, flags, weights, device, epoch_steps, tols, ops)


def _captured_vs_eager(label, lineage, flags, weights, device, epoch_steps, tols, ops):
    grad_rel, grad_floor = tols
    pools = [train_rows(flags, device, epoch_steps, seed=5),
             {k: v[:1].expand(epoch_steps, *v.shape[1:]).contiguous()
              for k, v in train_rows(flags, device, 1, seed=6).items()}]
    cfg = train.experiment_config(train.parse_args(flags + ["--device", device.type]))
    seen = torch.zeros_like(pools[0]["pos"][0])

    def recording(net, r3, so3, batch, generator, exp, injected=None):
        seen.copy_(batch["pos"])
        return train.LOSSES[lineage](net, r3, so3, batch, generator, exp, injected)

    nets, steppers = [], []
    for capture in (True, False):
        net = load_model(None, cfg, device, lineage=lineage)
        net.load_state_dict(weights)
        nets.append(net)
        steppers.append(pool_stepper(net, lineage, flags, device, 13, capture,
                                     recording if capture else None))
    rotated, differ = [], {}
    for epoch, pool in enumerate(pools):
        for s in steppers:
            s.load(pool)
            s.start()
        for i in range(epoch_steps):
            for s in steppers:
                s.step()
                torch.cuda.synchronize()
                if s.capture:
                    rotated.append(seen.clone())
            for (name, p), q in zip(nets[0].named_parameters(), nets[1].parameters()):
                if not torch.equal(p, q):
                    differ[f"epoch {epoch} step {i} weight {name}"] = float((p - q).abs().max())
    steps = len(pools) * epoch_steps
    graph = steppers[0]
    if (graph.captures, graph.replays) != (1, steps - 1):
        raise AssertionError(f"train {label} captured vs eager: {graph.captures} captures and "
                             f"{graph.replays} replays in {steps} steps")
    if torch.equal(rotated[-1], rotated[-2]):
        raise AssertionError(f"train {label}: two replays rotated one row alike")
    gen_equal = torch.equal(graph.generator.get_state(), steppers[1].generator.get_state())
    if not gen_equal:
        raise AssertionError(f"train {label}: the generator's state after {steps - 1} replays "
                             "differs from its state after the eager steps")
    gaps = grad_gaps(nets[0], nets[1])
    top = max(scale for _, scale in gaps.values())
    bad = [f"{name} {gap:.3e} of {scale:.3e}" for name, (gap, scale) in gaps.items()
           if gap > grad_rel * scale + grad_floor * top]
    diff_grads = sorted(name for name, (gap, _) in gaps.items() if gap > 0)
    log(f"# train {label} captured vs eager, 2 epochs of {epoch_steps} steps with a pool "
        f"refresh between (1 warm-up, 1 capture, {graph.replays} replays): weights after "
        f"each step {'bit-equal' if not differ else f'differ in {len(differ)} arrays'}; last "
        f"step's gradients "
        f"{'bit-equal' if not diff_grads else 'differ in ' + ', '.join(diff_grads)}; "
        f"generator state equal; the replays' rotations of one row differ")
    for k, v in list(differ.items())[:5]:
        log(f"#   {k}: max abs {v:.3e}")
    if ops:
        log(f"# train {label}: ops without a deterministic path: {'; '.join(sorted(ops))}")
    if bad:
        raise AssertionError(f"train {label} captured vs eager: gradients beyond the step "
                             f"bounds: {'; '.join(bad)}")
    if differ:
        raise AssertionError(f"train {label} captured vs eager: the weights differ after "
                             f"{len(differ)} (step, array) pairs, first {next(iter(differ))}")


def train_phase(out_root, lineage, flags, record, device):
    """Training through the CLI at crop 448 and full width: steps/s (the
    CLI's wall, and the training loop's, which ends in a device sync), peak
    memory, the losses of each logged step beside the JAX package's first
    record line (v5e), one step on the card against the CPU, a profiled
    window, and the saved weights.npz loaded through load_model (bit-equal
    weights and forward).  The CLI trains through the captured step
    (train/pool.PoolStep: one graph a step); only select_topk may launch
    (the model's training path is eager), its launches the replays'
    included."""
    ck = os.path.join(out_root, f"train_{lineage}")
    argv = flags + ["--ckpt-dir", ck, "--device", device.type]
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = run_path(f"train {lineage}", ("select_topk",),
                                   lambda: train.main(argv), absent=TRAIN_ABSENT, graphs=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = out["steps"]
    log(f"# train {lineage} ({' '.join(flags)}): {steps} steps, CLI wall {wall:.3f} s "
        f"({steps / wall:.3f} steps/s), training loop {out['wall']:.3f} s "
        f"({steps / out['wall']:.3f} steps/s, synchronized; captured route, "
        f"{out['graph']['captures']} capture(s) in the run), peak memory {peak:.3f} GB, "
        f"{launches['select_topk'] / steps:.1f} select_topk launches a step; card {CARD[0]}")
    check_graphs(f"train {lineage}", out)
    with open(record) as f:
        first = json.loads(f.readline())
    log(f"# train {lineage}: the JAX package's record on TPU v5e ({record}), its first line: "
        + json.dumps(first))
    for r in out["rows"]:
        log(f"# train {lineage} step {r['step']} epoch {r['epoch']}: "
            + " ".join(f"{k} {v}" for k, v in r.items() if k.endswith("loss")))
        if not all(np.isfinite(v) for k, v in r.items() if k != "t"):
            raise AssertionError(f"train {lineage}: non-finite losses at step {r['step']}")
    if not out["rows"]:
        raise AssertionError(f"train {lineage}: no step logged")
    weights = {k: v.detach().cpu() for k, v in out["net"].state_dict().items()}
    train_step_parity(lineage, lineage, flags, weights, device)
    # the saved weights through load_model: the same weights, the same forward
    fast = DFMDockConfig(model=ModelConfig.fast())
    saved = load_model(os.path.join(ck, "weights.npz"), fast, device, lineage=lineage)
    mem = load_model(None, fast, device, lineage=lineage)
    mem.load_state_dict(out["net"].state_dict())
    for k, v in mem.state_dict().items():
        if not torch.equal(saved.state_dict()[k], v):
            raise AssertionError(f"train {lineage}: saved weight {k} differs")
    batch, pos, edges, _ = parity_inputs(load_npz_complex(NPZ), device)
    with torch.no_grad():
        o_s, o_m = saved(batch, pos, 0.5, edges=edges), mem(batch, pos, 0.5, edges=edges)
    for k in o_s:
        if not torch.equal(o_s[k], o_m[k]):
            raise AssertionError(f"train {lineage}: the saved weights' {k} differs")
    log(f"# train {lineage}: {ck}/weights.npz loads through load_model, bit-equal to the "
        "trained model's weights and forward (kernel path)")
    captured_vs_eager(lineage, lineage, flags, weights, device)
    window = train_profile(out["net"], lineage, flags, device)
    return steps / out["wall"], launches, weights, window


def check_graphs(label, out):
    """A training CLI run of S steps took the captured route: one warm-up
    step, one capture, S - 1 replays."""
    g, steps = out["graph"], out["steps"]
    if (g["captures"], g["replays"]) != (1, steps - 1):
        raise AssertionError(f"{label}: {g['captures']} captures and {g['replays']} replays "
                             f"in {steps} steps, expected 1 and {steps - 1}")


def first_no_pool_row(args):
    """The pool row that the training CLI's --no-pool path at `args` trains
    on first: its host RNG seeded, the epoch's permutation drawn, then the
    first complex featurized (cli/train.py)."""
    ds = NPZDataset(args.data_dir)
    idxs = np.arange(len(ds))
    if args.exclude_ids:
        excl = set(args.exclude_ids.split(","))
        idxs = np.array([i for i in idxs if ds.ids[i] not in excl])
    rng = np.random.RandomState(args.seed)
    first = int(rng.permutation(idxs)[0])
    return make_training_batch(ds.load_raw(first), args.crop_size, round_up(args.crop_size),
                               rng)


def no_pool_phase(out_root, device):
    """9n. The training CLI's --no-pool path (each step featurized on the
    host and run eagerly, the JAX package's other training loop) at 9g's
    and 9h's protocols cut to NO_POOL_EPOCHS, logging every step: no graph
    captured, only select_topk launching (NO_POOL_SELECTS a step), finite
    losses.  Its first step made again on the card from the CLI's own start
    (the seeded weights, the row its host RNG makes first, its generator's
    seed) gives the CLI's logged losses (rel TRAIN_LOSS_REL, the log's
    rounding NO_POOL_LOG_ABS); that step with step_row's injected
    perturbation on the card against the CPU at 9g's bounds
    (train_step_parity)."""
    for lineage, flags in (("mlsb", MLSB_TRAIN_FLAGS), ("dfmdock", DFMDOCK_TRAIN_FLAGS)):
        label = f"train {lineage} --no-pool"
        argv = (with_flag(with_flag(flags, "--epochs", NO_POOL_EPOCHS), "--log-every", 1)
                + ["--no-pool", "--ckpt-dir", os.path.join(out_root, f"no_pool_{lineage}"),
                   "--device", device.type])
        out, wall, launches = run_path(label, ("select_topk",), lambda: train.main(argv),
                                       absent=TRAIN_ABSENT)
        steps, g = out["steps"], out["graph"]
        if (g["captures"], g["replays"]) != (0, 0):
            raise AssertionError(f"{label}: {g['captures']} captures and {g['replays']} "
                                 "replays, expected none (the eager path)")
        if launches["select_topk"] != NO_POOL_SELECTS[lineage] * steps:
            raise AssertionError(f"{label}: {launches['select_topk']} select_topk launches in "
                                 f"{steps} steps, expected {NO_POOL_SELECTS[lineage]} a step")
        for r in out["rows"]:
            if not all(np.isfinite(v) for k, v in r.items() if k != "t"):
                raise AssertionError(f"{label}: non-finite losses at step {r['step']}")
        log(f"# {label} ({' '.join(argv[:-4])}): {steps} eager steps, CLI wall {wall:.3f} s, "
            f"training loop {out['wall']:.3f} s ({steps / out['wall']:.3f} steps/s); card "
            f"{CARD[0]}")
        args = train.parse_args(argv)
        cfg = train.experiment_config(args)
        row = first_no_pool_row(args)
        net = load_model(None, cfg, device, seed=args.seed, lineage=lineage)
        weights = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
        r3, so3 = R3Diffuser(cfg.diffuser.r3), SO3Diffuser(cfg.diffuser.so3)
        again = train_step(net, r3, so3, cfg.experiment, make_optimizer(net, cfg.experiment),
                           train.LOSSES[lineage], [upload(row, device)],
                           torch.Generator(device).manual_seed(args.seed + 1))
        logged = out["rows"][0]
        off = {k: (float(v), logged[k]) for k, v in again.items()
               if abs(float(v) - logged[k]) > TRAIN_LOSS_REL * abs(logged[k]) + NO_POOL_LOG_ABS}
        if off:
            raise AssertionError(f"{label}: its first step made again differs from the CLI's "
                                 f"logged one: {off}")
        log(f"# {label}: its first step made again on the card gives the CLI's logged losses "
            "(" + " ".join(f"{k} {logged[k]}" for k in again if k.endswith("loss")) + ")")
        train_step_parity(f"{lineage} --no-pool", lineage, flags, weights, device,
                          row=(row, step_row(flags, device)[1]))


def with_flag(flags, name, value):
    """Training flags with the value of `name` replaced."""
    i = flags.index(name)
    return flags[:i + 1] + [str(value)] + flags[i + 2:]


def bf16_train_phase(out_root, lineage, flags, weights, f32_rate, f32_window, device):
    """Training at --compute-dtype bfloat16 (the eager route's bf16 products)
    through the CLI at `flags`' protocol cut to BF16_EPOCHS, logging every
    BF16_LOG_EVERY steps: only select_topk launches, config.yaml records
    the dtype, the losses are finite; one bf16 step on the card against the CPU from the f32 run's
    trained `weights`; the 20-step window of train_profile at bf16 from
    the same weights, printed beside the f32 window's.  Returns the bf16
    window."""
    ck = os.path.join(out_root, f"train_{lineage}_bf16")
    bf_flags = with_flag(with_flag(flags, "--epochs", BF16_EPOCHS), "--log-every",
                         BF16_LOG_EVERY) + BF16
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = run_path(f"train {lineage} bf16", ("select_topk",),
                                   lambda: train.main(bf_flags + ["--ckpt-dir", ck, "--device",
                                                                  device.type]),
                                   absent=TRAIN_ABSENT, graphs=True)
    check_graphs(f"train {lineage} bf16", out)
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = out["steps"]
    with open(os.path.join(ck, "config.yaml")) as f:
        written = f.read()
    if "compute_dtype: bfloat16" not in written:
        raise AssertionError(f"train {lineage} bf16: config.yaml does not record bfloat16")
    for r in out["rows"]:
        if not all(np.isfinite(v) for k, v in r.items() if k != "t"):
            raise AssertionError(f"train {lineage} bf16: non-finite losses at step {r['step']}")
    if not out["rows"]:
        raise AssertionError(f"train {lineage} bf16: no step logged")
    log(f"# train {lineage} bf16 ({' '.join(bf_flags)}): {steps} steps, CLI wall {wall:.3f} s, "
        f"training loop {out['wall']:.3f} s ({steps / out['wall']:.3f} steps/s; f32 "
        f"{f32_rate:.3f} in 9g/9h, ratio {steps / out['wall'] / f32_rate:.3f}), peak memory "
        f"{peak:.3f} GB, {launches['select_topk'] / steps:.1f} select_topk launches a step; "
        f"last logged losses: " + " ".join(f"{k} {v:.4f}" for k, v in out["rows"][-1].items()
                                            if k.endswith("loss")))
    train_step_parity(f"{lineage} bf16", lineage, flags + BF16, weights, device,
                      tols=(BF16_TRAIN_LOSS_REL, BF16_TRAIN_GRAD_REL, BF16_TRAIN_GRAD_FLOOR))
    captured_vs_eager(f"{lineage} bf16", lineage, bf_flags, weights, device,
                      tols=(BF16_TRAIN_GRAD_REL, BF16_TRAIN_GRAD_FLOOR))
    cfg = train.experiment_config(train.parse_args(bf_flags + ["--device", device.type]))
    net = load_model(None, cfg, device, lineage=lineage)
    net.load_state_dict(weights)
    windows = train_profile(net, lineage, bf_flags, device)
    idle = lambda w: "not measured" if w["idle"] is None else f"{100 * w['idle']:.1f}%"
    for route, window in windows.items():
        f32 = f32_window[route]
        log(f"# train {lineage} {TRAIN_PROFILE_STEPS}-step window, {route}: bf16 "
            f"{window['steps_s']:.3f} steps/s, peak {window['peak_gb']:.3f} GB, idle "
            f"{idle(window)}, {window['launches']:.0f} launches a step; f32 "
            f"{f32['steps_s']:.3f} steps/s, peak {f32['peak_gb']:.3f} GB, idle {idle(f32)}, "
            f"{f32['launches']:.0f} launches a step; bf16 / f32 steps/s "
            f"{window['steps_s'] / f32['steps_s']:.3f}")
    return windows


def bf16_predict_phase(raw, device):
    """One eager predict forward of each lineage at
    ModelConfig(compute_dtype="bfloat16") (trained weights, phase 4's
    inputs: injected edges, the native pose and a random one, t = 0.5) on
    the card against the CPU: every output within BF16_PREDICT_REL of its
    largest, num_clashes exact; no kernel launches (the edges are
    injected, the route is eager)."""
    batch, pos, edges, _ = parity_inputs(raw, device)
    cfg = DFMDockConfig(model=ModelConfig(compute_dtype="bfloat16"))
    for lineage, ckpt, outputs in (("mlsb", DEMO_NPZ, SCORE_NET_OUTPUTS),
                                   ("dfmdock", DFMDOCK_NPZ, DFMDOCK_OUTPUTS)):
        net_k = load_model(ckpt, cfg, device, lineage=lineage)
        net_p = load_model(ckpt, cfg, torch.device("cpu"), lineage=lineage)
        reset_counts()
        with torch.no_grad():
            o_k = net_k(batch, pos, 0.5, edges=edges)
            o_p = net_p({k: v.cpu() for k, v in batch.items()}, pos.cpu(), 0.5,
                        edges=tuple(e.cpu() for e in edges))
        torch.cuda.synchronize()
        if any(launch_counts().values()):
            raise AssertionError(f"bf16 predict {lineage}: kernels launched {launch_counts()}")
        for name in outputs:
            a_err, r_err, _ = max_errs(o_k[name].cpu(), o_p[name])
            log(f"# bf16 predict {lineage} (eager) card vs CPU {name}: max abs {a_err:.3e} "
                f"rel {r_err:.3e}")
            if r_err > BF16_PREDICT_REL or not torch.isfinite(o_k[name]).all():
                raise AssertionError(f"bf16 predict {lineage}: {name} rel {r_err:.3e}")
        if not torch.equal(o_k["num_clashes"].cpu(), o_p["num_clashes"]):
            raise AssertionError(f"bf16 predict {lineage}: num_clashes differ")


@contextlib.contextmanager
def captured_docks():
    """Record the results of every cli.common.dock_complex call the dock
    CLI makes (its poses and energies, as numpy arrays)."""
    got, orig = [], dock.dock_complex

    def recording(*args, **kwargs):
        out = orig(*args, **kwargs)
        got.append(out[1])
        return out

    dock.dock_complex = recording
    try:
        yield got
    finally:
        dock.dock_complex = orig


def dp_dock_phase(out_root, smi):
    """The dock CLI with --dp (one NCCL rank on this card) against the plain
    dock: trained mlsb weights, 1AVX, P poses x STEPS steps, one seed, on
    the float32 kernel route and on the default fast() (bf16).  The poses,
    energies and every CSV row must be bit-equal; both walls are printed.
    The --dp runs are counted and must launch every dock kernel of their
    route.  Returns the float32 --dp run's launches."""
    argv = ["--npz", NPZ, "--ckpt", DEMO_NPZ, "--num-samples", str(P), "--num-steps",
            str(STEPS), "--seed", "7"]
    result = None
    for route, model, kernels, absent in (("f32", FAST_F32, DOCK_KERNELS, F32_ABSENT),
                                          ("bf16", None, DOCK_KERNELS_BF16, BF16_ABSENT)):
        with captured_docks() as plain:
            rows_p, wall_p, _ = run_path(f"plain dock {route} (dp reference)", kernels,
                                         lambda: dock.main(argv + ["--out-dir", os.path.join(
                                             out_root, f"dp_ref_{route}")], model), absent)
        with captured_docks() as dp:
            rows_d, wall_d, launches = run_path(f"dp dock {route}", kernels, lambda: dock.main(
                argv + ["--out-dir", os.path.join(out_root, f"dp_{route}"), "--dp"], model),
                absent)
        for k in ("pos", "energy", "num_clashes", "tr_update", "rot_update"):
            if not np.array_equal(dp[0][k], plain[0][k]):
                err = np.abs(dp[0][k].astype(np.float64) - plain[0][k]).max()
                raise AssertionError(f"dp dock {route}: {k} differs from the plain dock's (max "
                                     f"abs {err:.3e})")
        if rows_d != rows_p:
            raise AssertionError(f"dp dock {route}: the CSV rows differ from the plain dock's")
        log(f"# dp dock {route} 1AVX P={P} steps={STEPS} (NCCL, 1 rank; card {smi}): wall "
            f"{wall_d:.3f} s against the plain dock's {wall_p:.3f} s (the --dp wall includes "
            f"opening and closing the process group); poses, energies and rows bit-equal")
        result = result or launches
    return result


def dp_sweep_phase(out_root):
    """The sweep CLI with --dp over SWEEP_IDS (trained mlsb weights, P
    poses each, the float32 kernel route): every row equal to the plain
    sweep's."""
    argv = ["--ids", ",".join(SWEEP_IDS), "--ckpt", DEMO_NPZ, "--num-samples", str(P),
            "--num-steps", str(STEPS), "--seed", "3"]
    plain, wall_p, _ = run_path("plain sweep (dp reference)", DOCK_KERNELS, lambda: sweep.main(
        argv + ["--out-csv", os.path.join(out_root, "dp_ref_sweep.csv")], FAST_F32), F32_ABSENT)
    rows, wall_d, launches = run_path("dp sweep", DOCK_KERNELS, lambda: sweep.main(
        argv + ["--out-csv", os.path.join(out_root, "dp_sweep.csv"), "--dp"], FAST_F32),
        F32_ABSENT)
    if rows != plain or len(rows) != P * len(SWEEP_IDS):
        raise AssertionError(f"dp sweep: {len(rows)} rows, not equal to the plain sweep's")
    log(f"# dp sweep {','.join(SWEEP_IDS)} P={P}: wall {wall_d:.3f} s against the plain "
        f"sweep's {wall_p:.3f} s; {len(rows)} rows equal")
    return launches


def dp_train_phase(out_root, device, extra=()):
    """Data-parallel training through NCCL at one rank: the training CLI
    with --dp --batch-size 2 (two steps of a two-row pool at crop 448, the
    second replayed from its captured graphs) against the same CLI run
    without --dp (the saved weights bit-equal),
    then make_dp_train_step against train_step on the same two rows and the
    same generator seed: every gradient and metric bit-equal; `extra` adds
    training flags to both (--compute-dtype bfloat16).  Both run
    under torch.use_deterministic_algorithms (warn_only): the backward of
    an embedding-table lookup may accumulate its rows in any order, and
    then not even two plain steps agree bit for bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _dp_train_checks(out_root, device, list(extra))
    finally:
        torch.use_deterministic_algorithms(False)


def _dp_train_checks(out_root, device, extra):
    data = os.path.join(out_root, "dp_data")
    os.makedirs(data, exist_ok=True)
    shutil.copy(NPZ, os.path.join(data, "1AVX.npz"))
    tag = "".join(f"{a} " for a in extra)
    out_root = os.path.join(out_root, "_".join(["dp"] + [a.strip("-") for a in extra]))
    argv = ["--data-dir", data, "--crop-size", str(DP_CROP), "--grad-energy",
            "--use-contrastive-loss",
            "--batch-size", "2", "--pool-variants", "2", "--epochs", "2", "--log-every", "1",
            "--seed", "2"] + extra
    plain, wall_p, _ = run_path(f"plain train step {tag}(dp reference)", ("select_topk",),
                                lambda: train.main(argv + ["--ckpt-dir", os.path.join(
                                    out_root, "dp_ref_train")]), absent=TRAIN_ABSENT,
                                graphs=True)
    out, wall_d, launches = run_path(f"dp train step {tag}", ("select_topk",), lambda: train.main(
        argv + ["--ckpt-dir", os.path.join(out_root, "dp_train"), "--dp"]), absent=TRAIN_ABSENT,
        graphs=True)
    if out["steps"] != 2:
        raise AssertionError(f"dp train: {out['steps']} steps, expected 2")
    check_graphs(f"dp train {tag}", out)
    check_graphs(f"plain train {tag}(dp reference)", plain)
    for k, v in plain["net"].state_dict().items():
        if not torch.equal(out["net"].state_dict()[k], v):
            raise AssertionError(f"dp train: the weight {k} after the step differs from the "
                                 "plain step's")
    log(f"# dp train {tag}(CLI, NCCL, 1 rank): 2 steps of 2 rows at crop {DP_CROP} (the "
        f"second replayed: the forward and backward's graph, the all_reduce, the optimizer's "
        f"graph), wall "
        f"{wall_d:.3f} s "
        f"against the plain CLI's {wall_p:.3f} s; every weight after the step bit-equal")

    args = train.parse_args(argv + ["--device", device.type])
    cfg = train.experiment_config(args)
    ds = NPZDataset(data)
    rng = np.random.RandomState(0)
    rows = [upload(make_training_batch(ds.load_raw(0), DP_CROP, round_up(DP_CROP), rng), device)
            for _ in range(2)]
    r3, so3 = R3Diffuser(cfg.diffuser.r3), SO3Diffuser(cfg.diffuser.so3)
    nets, metrics = [], []
    for dp in (False, True):
        net = load_model(None, cfg, device, seed=4).train()
        opt = make_optimizer(net, cfg.experiment)
        gen = torch.Generator(device).manual_seed(9)
        if dp:
            with init_world(device) as world:
                step = make_dp_train_step(net, r3, so3, cfg.experiment, opt,
                                          train.LOSSES["mlsb"], world)
                m = step({k: torch.stack([r[k] for r in rows]) for k in rows[0]}, gen,
                         rotate=True)
        else:
            m = train_step(net, r3, so3, cfg.experiment, opt, train.LOSSES["mlsb"], rows, gen,
                           rotate=True)
        nets.append(net)
        metrics.append(m)
    errs = grad_errors(nets[1], nets[0])
    worst = max(err for err, _ in errs.values())
    if worst != 0.0:
        raise AssertionError(f"dp train: gradients differ from the plain step's (max abs "
                             f"{worst:.3e})")
    for k, v in metrics[0].items():
        if not torch.equal(metrics[1][k], v):
            raise AssertionError(f"dp train: metric {k} differs from the plain step's")
    log(f"# dp train step {tag}(make_dp_train_step, NCCL, 1 rank) vs train_step: {len(errs)} "
        f"gradient arrays and {len(metrics[0])} metrics bit-equal (loss "
        f"{float(metrics[0]['loss']):.5f})")
    return launches


def remainder_phase(raw, device):
    """The remaining modules on CUDA tensors against the same functions on
    the CPU: compute_tm (rel 1e-5), kabsch with and without weights (R
    within 1e-5 absolute, t within 1e-5 of 1 + |centroid| in Angstrom: an
    SVD on each side, and t = b_mean - R a_mean carries R's error times
    the centroid's size), pair_features (rel 1e-5),
    sixd_bins_dense on 1AVX (equal but where the CPU's angle or distance
    lies within TIE_TOL of a bin boundary), and entry()'s full-width
    forward (finite)."""
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(120, 80, 64).astype(np.float32))
    _, tm_err, _ = max_errs(compute_tm(logits.to(device)).cpu(), compute_tm(logits))
    if tm_err > 1e-5:
        raise AssertionError(f"compute_tm card vs CPU rel {tm_err:.3e}")
    pos = torch.from_numpy(np.concatenate([raw["rec_pos"], raw["lig_pos"]]))
    ca = pos[:, 1]
    moved = ca @ random_rotation_matrix(torch.Generator().manual_seed(1)).T + 3.0
    w = torch.from_numpy(rng.rand(ca.shape[0]).astype(np.float32))
    kabsch_errs = []
    for weights in (None, w):
        R_c, t_c = kabsch(ca.to(device), moved.to(device),
                          None if weights is None else weights.to(device))
        R, t = kabsch(ca, moved, weights)
        r_err = (R_c.cpu() - R).abs().max().item()
        # t = b_mean - R a_mean carries R's error times the centroid's size
        t_err = (t_c.cpu() - t).abs().max().item() / (1.0 + ca.mean(0).norm().item())
        kabsch_errs += [r_err, t_err]
        if r_err > 1e-5 or t_err > 1e-5:
            raise AssertionError(f"kabsch card vs CPU: R max abs {r_err:.3e}, t max abs "
                                 f"{t_err:.3e} of 1 + |centroid|")
    frames = residue_frames(pos)
    _, pf_err, _ = max_errs(pair_features(ca.to(device), frames.to(device)).cpu(),
                            pair_features(ca, frames))
    if pf_err > 1e-5:
        raise AssertionError(f"pair_features card vs CPU rel {pf_err:.3e}")
    bins_c = [b.cpu() for b in sixd_bins_dense(pos.to(device))]
    bins = sixd_bins_dense(pos)
    n = pos.shape[0]
    dist, omega, theta, phi, _ = sixd_values_at(
        pos, torch.arange(n, dtype=torch.int32).expand(n, n))
    ties = 0
    for name, b_c, b, v, bounds, tol in (
            ("dist", bins_c[0], bins[0], dist, DIST_BOUNDARIES, TIE_TOL[E_DB]),
            ("omega", bins_c[1], bins[1], omega, ANGLE_BOUNDARIES, TIE_TOL[E_OB]),
            ("theta", bins_c[2], bins[2], theta, ANGLE_BOUNDARIES, TIE_TOL[E_TB]),
            ("phi", bins_c[3], bins[3], phi, PHI_BOUNDARIES, TIE_TOL[E_PB])):
        diff = b_c != b
        near = (v[..., None] - torch.as_tensor(bounds, dtype=v.dtype)).abs().min(-1).values <= tol
        if name != "dist":  # an angle's bin is 0 beyond the cut-off
            near |= (dist - SPATIAL_MASK_CUTOFF).abs() <= TIE_TOL[E_DB]
        if (diff & ~near).any():
            raise AssertionError(f"sixd_bins_dense {name}: {int((diff & ~near).sum())} bins "
                                 "differ card vs CPU away from a boundary")
        ties += int(diff.sum())
    fn, args = entry(device)
    out = fn(*args)
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError("entry(): non-finite outputs")
    log(f"# remainder card vs CPU: compute_tm rel {tm_err:.3e}, kabsch R / t "
        f"{max(kabsch_errs[0::2]):.3e} / {max(kabsch_errs[1::2]):.3e}, "
        f"pair_features rel {pf_err:.3e}, sixd_bins_dense over {n}x{n} pairs of 1AVX: "
        f"{ties} bins differ, each at a boundary tie; entry() forward finite, energy "
        f"{float(out['energy'][0]):.4f}")


def select_topk_library(dist, y, node_mask, knn=20, sample_size=40):
    """The same selection through two torch.topk calls (ties in torch's
    order, not the lower index's): the yardstick of select_topk."""
    neg = torch.full_like(dist, NEG_INF)
    masked_neg = torch.where(node_mask, -dist, neg)
    vals, knn_idx = torch.topk(masked_neg, knn)
    kept = torch.where(masked_neg < vals[..., knn - 1 : knn], y, neg)
    return knn_idx, torch.topk(kept, sample_size)[1]


def bound_ms(n_bytes, n_ops, flop_s=FP32_FLOP_S, n_sfu=0):
    """(least ms, what bounds it): bytes over the HBM rate, operations over
    the rate of their units, special-function results over theirs."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_S, max(n_ops / flop_s, n_sfu / SFU_OP_S)
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def energy_bound(args):
    """fused_energy: the pair mask in, and of hr and hl only the rows that
    keep a pair (what the function needs; the kernel reads no others); the
    LN affine and w2 once, [P] out; FP32 and special-function work over the
    pairs the mask keeps."""
    hr, _, pair_mask, *_ = args
    p, _, c = hr.shape
    kept_mask = pair_mask != 0
    kept = float(kept_mask.sum())
    rows = float(kept_mask.any(-1).sum()) + float(kept_mask.any(-2).sum())
    return bound_ms(4 * (pair_mask.numel() + rows * c + 3 * c + p),
                    kept * c * ENERGY_OPS_PER_CHANNEL, n_sfu=kept * c * ENERGY_SFU_PER_CHANNEL)


def bounds(inputs):
    """Least time the card could take for each kernel's work (ms): the bytes
    the function must move (each input read once, each output written once)
    over the HBM rate, or its operations over the rate of the units that do
    them (FP32 for every kernel but fused_egcl, whose products run on the
    tensor cores in three bf16 passes, or one in its bf16 mode), whichever
    is larger."""
    table_args, layer_args = inputs["table"], inputs["layer"]
    idx = table_args[0]
    p, n, k = idx.shape
    e = p * n * k
    c = layer_args[4].shape[-1]

    # edge_table: idx in; bins and geometry out; pos, res_id, asym_id once.
    # Operations: every edge's, the kept edges' angles, every node's terms.
    # edge_bins: the same without the geometry.
    pos = table_args[1]
    rows = torch.arange(n, device=idx.device, dtype=idx.dtype)[:, None]
    kept = int(((sixd_values_at(pos, idx)[0] < 22.0) & (idx != rows)).sum())
    node_bytes = p * n * 36 + 2 * n * 4
    edge_bounds = {}
    for name, width, ops, sfu in (
            ("edge_table", EBIN_WIDTH + EGEO_WIDTH, EDGE_TABLE_OPS_PER_EDGE,
             EDGE_TABLE_SFU_PER_EDGE),
            ("edge_bins", EBIN_WIDTH, EDGE_BINS_OPS_PER_EDGE, EDGE_BINS_SFU_PER_EDGE)):
        n_bytes = e * 4 * (1 + width) + node_bytes
        n_ops = e * ops + kept * EDGE_OPS_PER_KEPT_EDGE + p * n * EDGE_OPS_PER_NODE
        n_sfu = e * sfu + kept * EDGE_SFU_PER_KEPT_EDGE + p * n * EDGE_SFU_PER_NODE
        edge_bounds[name] = bound_ms(n_bytes, n_ops, n_sfu=n_sfu)
        log(f"# bound {name}: {kept}/{e} edges kept for the angles; bytes "
            f"{n_bytes / HBM_BYTES_S * 1e3:.4f} ms ({n_bytes / 1e6:.1f} MB), FP32 "
            f"{n_ops / FP32_FLOP_S * 1e3:.4f} ms ({n_ops / 1e6:.1f} M operations), "
            f"special-function units {n_sfu / SFU_OP_S * 1e3:.4f} ms ({n_sfu / 1e6:.2f} M "
            f"results): bound by {edge_bounds[name][1]}")
    # fused_egcl: per edge idx, mask, bins, radial (+ coord-diff on the coord
    # layer); a, B in and agg out; tables and weights once.  Operations: the
    # [C] x [C, C] product per edge (twice on the coord layer), three bf16
    # passes each; the FP32 and single-pass bf16 figures are printed beside.
    tables = (SPATIAL_DIM + NUM_RELPOS_CLASSES) * c + c * c + 3 * c + 1
    base = 4 * (e * (3 + EBIN_WIDTH) + 3 * p * n * c + tables)
    coord_bytes = base + 4 * (e * 3 + c * c + 2 * c + p * n * 3)
    gemm = 2 * e * c * c
    for name, products, n_bytes in (("fused_egcl", 1, base), ("fused_egcl_coord", 2, coord_bytes)):
        ms = {rate: products * gemm / flops * 1e3 for rate, flops in (
            ("three bf16 passes", BF16_FLOP_S / EGCL_PASSES), ("FP32", FP32_FLOP_S),
            ("single-pass bf16", BF16_FLOP_S))}
        log(f"# bound {name}: {products * gemm / 1e9:.1f} GFLOP; "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; bytes {n_bytes / HBM_BYTES_S * 1e3:.4f} ms; the row's bound: three bf16 "
            "passes (the work the float32 mode does), one for the _bf16 row")
    energy = energy_bound(inputs["energy"])
    # select_topk: dist and y in (node_mask once), idx and edge_mask out;
    # operations: a selection is O(N) compares per row and phase: the kNN's
    # compare per element, then phase 2's exclusion and selection compares
    dist, _, node_mask = inputs["select"]
    rows, sn = dist.numel() // dist.shape[-1], dist.shape[-1]
    select = bound_ms(4 * 2 * dist.numel() + sn + rows * k * 8, rows * sn * 3)
    passes = BF16_FLOP_S / EGCL_PASSES
    # the bf16 mode reads B, the tables and the weights as bf16
    half = 2 * (p * n * c + (SPATIAL_DIM + NUM_RELPOS_CLASSES) * c + c * c)
    return {**edge_bounds, "fused_egcl": bound_ms(base, gemm, passes),
            "fused_egcl_coord": bound_ms(coord_bytes, 2 * gemm, passes),
            "fused_egcl_bf16": bound_ms(base - half, gemm, BF16_FLOP_S),
            "fused_egcl_coord_bf16": bound_ms(coord_bytes - half - 2 * c * c, 2 * gemm,
                                              BF16_FLOP_S),
            "fused_energy": energy, "select_topk": select,
            "kept": inputs["energy"][2] != 0}


def train_phases(out_root, device):
    """9g, 9h and 9m: training of both lineages, at float32 then bfloat16;
    then 9n, the --no-pool path.
    Returns ({lineage: CLI steps/s}, {lineage: bf16 windows})."""
    train_rates, bf16_windows = {}, {}
    for lineage, flags, record in (("mlsb", MLSB_TRAIN_FLAGS, DEMO_METRICS),
                                   ("dfmdock", DFMDOCK_TRAIN_FLAGS, DFMDOCK_METRICS)):
        t0 = time.perf_counter()
        train_rates[lineage], _, weights, window = train_phase(out_root, lineage, flags,
                                                               record, device)
        log(f"# training {lineage}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bf16_windows[lineage] = bf16_train_phase(out_root, lineage, flags, weights,
                                                 train_rates[lineage], window, device)
        log(f"# training {lineage} at bf16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    no_pool_phase(out_root, device)
    log(f"# training --no-pool: {time.perf_counter() - t0:.1f} s")
    return train_rates, bf16_windows


ONLY = ("scaling", "heun", "capture")  # the phases `--only` runs alone


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive dfmdock_tpu_torch's main paths on one "
                                 "CUDA card and check its kernels (the module docstring).")
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help=f"run the device and build phases and then only these, comma-separated "
                         f"from {', '.join(ONLY)}; no kernel line and no result line")
    args = ap.parse_args(argv)
    only = None if args.only is None else args.only.split(",")
    if only is not None and not set(only) <= set(ONLY):
        ap.error(f"--only takes {', '.join(ONLY)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
    smi = device_phase()

    t0 = time.perf_counter()
    built = _build.build(*BUILD)
    log(f"# build: {json.dumps({k: round(v, 2) for k, v in built.items()})} s per "
        f"source (parallel), {time.perf_counter() - t0:.2f} s wall")

    raw = load_npz_complex(NPZ)
    raw["id"] = "1AVX"
    if only is not None:
        run_only(only, raw, device)
        log(f"# --only {','.join(only)}: passed in {time.perf_counter() - t_start:.1f} s; "
            f"card {smi}")
        return 0
    t0 = time.perf_counter()
    errs, inputs = kernel_phase(raw, device)
    log(f"# kernel checks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    parity_phase(raw, device)
    log(f"# ScoreNet parity: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dfmdock_parity_phase(raw, device)
    log(f"# DFMDock-lineage parity: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf16_parity_phase(raw, device)
    log(f"# bf16 parity matrix and DFMDock bf16 parity: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as out_root:
        docks = dock_phase(out_root)
        launches, steps_s = docks["f32"]
        launches16, steps_s16 = docks["bf16"]
        sampler_rates = sampler_phase(raw, device)
        t0 = time.perf_counter()
        profile_phase(raw, device)
        profile_phase(raw, device, mcfg=ModelConfig.fast())
        log(f"# profiles (f32, bf16): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _, inputs["energy"] = rank_phase(out_root)
        log(f"# ranking dock: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sweep_phase(out_root)
        log(f"# sweep: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        trained_launches = trained_phase(out_root)
        log(f"# trained mlsb dock and sweep: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        demo_stats, demo_launches = bf16_trained_phase(out_root, trained_launches)
        log(f"# trained mlsb sweep bf16: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        demo_torch_phase(out_root, demo_stats, demo_launches)
        log(f"# port-trained mlsb sweep: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dfmdock_sweep_phase(out_root)
        profile_phase(raw, device, lineage="dfmdock", ckpt=DFMDOCK_NPZ)
        log(f"# DFMDock-lineage sweeps and profile: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dfmdock_sweep_phase(out_root, bf16=True)
        log(f"# DFMDock-lineage sweeps bf16: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        picard_phase(raw, device, out_root)
        log(f"# Picard: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pdb_dock_phase(out_root, launches)
        log(f"# PDB and CSV docks: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        esm_phase(device)
        log(f"# ESM2-650M: {time.perf_counter() - t0:.1f} s")
        train_rates, bf16_windows = train_phases(out_root, device)
        t0 = time.perf_counter()
        bf16_predict_phase(raw, device)
        log(f"# bf16 eager predict: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    route_launches = route_phase(raw, device)
    log(f"# kernel routes: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scaling_phase(raw, device, errs, route_launches)
    log(f"# scaling (P = {', '.join(map(str, SCALING_POSES))}): {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as out_root:
        t0 = time.perf_counter()
        heun_phase(raw, device, out_root)
        log(f"# Heun: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    capture_phase(raw, device)
    log(f"# capture: {time.perf_counter() - t0:.1f} s")

    # each kernel's launches from the main path that runs it: the dock CLI's
    # default (bf16) for the bf16 mode and the kernels both routes share, the
    # float32 dock for the float32 mode
    path_launches = {
        "edge_table": ("dock", launches16), "fused_egcl": ("f32 dock", launches),
        "fused_egcl_coord": ("f32 dock", launches),
        "fused_egcl_bf16": ("dock", launches16),
        "fused_egcl_coord_bf16": ("dock", launches16),
        "fused_energy": ("f32 dock", launches),
        "select_topk": ("dock", launches16),
        "edge_bins": ("bins route", route_launches["bins"]),
    }
    # fused_energy against its plain version on the inputs the path gave it
    e_k, e_p = fused_energy(*inputs["energy"]), fused_energy_plain(*inputs["energy"])
    a_err, r_err, _ = max_errs(e_k, e_p)
    if r_err > F32_REL or not torch.isfinite(e_k).all():
        raise AssertionError(f"fused_energy on the path's inputs: rel err {r_err:.3e}")
    errs["fused_energy"] = max(errs["fused_energy"], a_err)
    log(f"# fused_energy on the reranker run's final-pose inputs: max abs {a_err:.3e} "
        f"rel {r_err:.3e}")
    table_args, layer_args, coord = inputs["table"], inputs["layer"], inputs["coord"]
    table_kw = dict(normalize=True)
    # fused_egcl as the main path calls it: the weights' kernel-side form
    # built once (models/egnn.fused_weights), B as bf16 in the bf16 mode
    bf16 = torch.bfloat16
    layer16 = (*layer_args[:5], layer_args[5].to(bf16), *layer_args[6:])
    prep = {(dt, c0 is not None): prepare_layer(*layer_args[6:8], layer_args[9], c0, dt)
            for dt in (None, bf16) for c0 in (None, coord[0])}
    timings = {
        "edge_table": (lambda: build_edge_table(*table_args, **table_kw),
                       lambda: build_edge_table_plain(*table_args, **table_kw)),
        "fused_egcl": (lambda: fused_edge_layer(*layer_args, prepared=prep[None, False]),
                       lambda: fused_edge_layer_plain(*layer_args)),
        "fused_egcl_coord": (
            lambda: fused_edge_layer(*layer_args, coord, prepared=prep[None, True]),
            lambda: fused_edge_layer_plain(*layer_args, coord)),
        "fused_egcl_bf16": (
            lambda: fused_edge_layer(*layer16, dtype=bf16, prepared=prep[bf16, False]),
            lambda: fused_edge_layer_plain(*layer_args, dtype=bf16)),
        "fused_egcl_coord_bf16": (
            lambda: fused_edge_layer(*layer16, coord, dtype=bf16, prepared=prep[bf16, True]),
            lambda: fused_edge_layer_plain(*layer_args, coord, dtype=bf16)),
        "fused_energy": (lambda: fused_energy(*inputs["energy"]),
                         lambda: fused_energy_plain(*inputs["energy"])),
        "select_topk": (lambda: select_topk(*inputs["select"]),
                        lambda: select_topk_plain(*inputs["select"])),
        "edge_bins": (lambda: edge_bins(*table_args), lambda: edge_bins_plain(*table_args)),
    }
    # the library route the port replaced: two torch.topk (their tie order
    # is left open), timed here as a yardstick and called nowhere in the port
    library = {"select_topk": lambda: select_topk_library(*inputs["select"])}
    bound = bounds(inputs)
    kept = bound["kept"]
    log(f"# fused_energy is timed and its bound counted on the reranker run's "
        f"final-pose inputs: {int(kept.sum())} kept pairs, {int(kept.any(-1).sum())} "
        f"(pose, row) and {int(kept.any(-2).sum())} (pose, column) with a kept pair (P={P})")
    kernels = []
    for name, (kern, plain) in timings.items():
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=3, inner=3)
        lib_ms = time_ms(library[name]) if name in library else None
        b_ms, b_by = bound[name]
        path, path_counts = path_launches[name]
        if WRAPPER_COUNTS[path][name] == 0:
            raise AssertionError(f"{name}: its wrapper counted no launch in the {path} run")
        dev_ms, enqueue_ms = device_ms(kern), host_ms(kern)
        lib_note = "" if lib_ms is None else (
            f"; library {lib_ms:.4f} ms, device {device_ms(library[name]):.4f} ms")
        log(f"# {name}: {ms:.4f} ms/launch (device {dev_ms:.4f} ms, {100 * b_ms / dev_ms:.1f}% "
            f"of bound; host {enqueue_ms:.4f} ms to enqueue; plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}{lib_note}), {path_counts[name]} launches in the {path} run")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": path_counts[name],
            "wrapper_launches": WRAPPER_COUNTS[path][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "host_ms": enqueue_ms,
        })
    # the process-group phases run after the kernel timings, so that no
    # process group has been opened in the process that times the kernels
    with tempfile.TemporaryDirectory() as out_root:
        t0 = time.perf_counter()
        dp_dock_phase(out_root, smi)
        log(f"# dp dock: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_sweep_phase(out_root)
        log(f"# dp sweep: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_train_phase(out_root, device)
        dp_train_phase(out_root, device, BF16)
        log(f"# dp training (f32, bf16): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    remainder_phase(raw, device)
    log(f"# remainder: {time.perf_counter() - t0:.1f} s")
    log(f"# total {time.perf_counter() - t_start:.1f} s; card {smi}; denoising steps/s: dock "
        f"CLI {steps_s16:.2f} (default, bf16) / {steps_s:.2f} (f32), sampler "
        f"{sampler_rates['bf16']:.2f} / {sampler_rates['f32']:.2f}; "
        f"training steps/s at crop 448 (CLI, captured): mlsb {train_rates['mlsb']:.3f}, DFMDock "
        f"{train_rates['dfmdock']:.3f}; bf16 in the 20-step window (captured / eager): mlsb "
        f"{bf16_windows['mlsb']['captured']['steps_s']:.3f} / "
        f"{bf16_windows['mlsb']['eager']['steps_s']:.3f}, DFMDock "
        f"{bf16_windows['dfmdock']['captured']['steps_s']:.3f} / "
        f"{bf16_windows['dfmdock']['eager']['steps_s']:.3f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_only(only, raw, device):
    """The phases of `only` alone (`--only`), each timed."""
    if "scaling" in only:
        t0 = time.perf_counter()
        scaling_phase(raw, device, {name: 0.0 for name in SOURCES})
        log(f"# scaling (P = {', '.join(map(str, SCALING_POSES))}): "
            f"{time.perf_counter() - t0:.1f} s")
    if "heun" in only:
        with tempfile.TemporaryDirectory() as out_root:
            t0 = time.perf_counter()
            heun_phase(raw, device, out_root)
            log(f"# Heun: {time.perf_counter() - t0:.1f} s")
    if "capture" in only:
        t0 = time.perf_counter()
        capture_phase(raw, device)
        log(f"# capture: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
