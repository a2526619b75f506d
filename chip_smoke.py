#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each of which raises on failure:
  1. device  -- a CUDA card is required; print its name and power limit;
  2. build   -- compile the hand-written kernels from src/repro_torch/csrc
                and print each one's registers and spills (ptxas -v);
  3. kernels -- hold each kernel against its plain PyTorch version on the
                card, at the serving slice's shapes and more (K1 in float32
                and in bf16), and time both beside a PyTorch call where one
                computes the same function, and beside the kernel's bound;
  4. slice   -- the serving slice at micro-lm's full width, through the
                port's own entry points, with the launch counters set to 0
                just before it and read just after:
                site A prefill (Model.forward) and greedy decode, an int8
                GRNCKPT1 checkpoint, the feasibility gate on the measured
                bytes, migrate_job to site B, restore there, prefill and
                decode again; then micro-lm's prefill with its weights in
                bf16 (K1's bf16 kernel), counted the same way;
  5. checks  -- the slice's outputs against the plain path on the CPU;
  6. fleet   -- the orchestration core, three paths through the port's
                entry points with the K4 decide kernel on every tick, each
                with the launch counters set to 0 just before it and read
                just after: a paper-table6 week (ClusterSimulator), the
                100-site x 10,000-job fleet-compiled week, and the
                1,000-run batched sweep (run_cells_batched).  Their
                summaries must equal the same runs with device="cpu" (run
                first, in a spawned process beside the build; they also
                supply real decide batches for the K4 check in phase 3)
                and the fleet week the recorded
                benchmarks/BENCH_quick.json row;
  7. profile -- device busy share and top kernels of prefill and decode,
                and of a profiled rerun of each fleet path (cut in depth:
                the fleet over 2 days with 570 of its 10,000 jobs, the
                sweep over 100 of its 1,000 runs);
  8. train   -- the training slice at micro-lm's full width: the attention
                backward kernel against its plain version in float32 and
                in bf16 (and timed); two train steps on the card against
                the same two through device="cpu"; one train step of
                micro-lm in bf16 on the card against the same step through
                device="cpu", counted; the job lifecycle through Trainer (site A
                trains to step 12 with a checkpoint every 4 steps, is
                preempted, the gate reads the measured bytes, migrate_job,
                site B restores onto the card and trains to step 24) in full
                mode against an unmigrated run, and in int8 mode with
                int8-compressed gradients (its checkpoints at preemption
                and at the end only); remat "none" and "dots" against
                "full" (loss and every gradient, bit-identical), a step of
                two micro-batches against one batch, and a delta-int8
                lifecycle (a full save, a delta save, migrate_job, a
                restore with an explicit base= bit-identical to
                device="cpu"'s); launch.train.main on the default
                device; each run with the launch counters set to 0 just
                before it and held to exact counts just after; the step's
                device time, busy share and top device ops;
  9. serving -- the float32 feasibility grids (Fig. 2 phase diagram, size
                bands, utility, feasible destinations) against
                device="cpu"; the serving plane's default chunked engine
                and the host entry points, each counted: the
                inference-heavy week (~1.1 M requests, static policy)
                against BENCH_quick.json's serving_fastpath digits;
                launch.serve --green-route 64; launch.dryrun --plan against
                --device cpu;
 10. examples -- the four examples' main on the card: quickstart (one
                Algorithm-1 decision through K4), green_cluster_sim on
                train-plus-serve against --device cpu, its
                feasibility-aware run (the chunked engine with K4 on the
                card) against the recorded carbon-slo row, with its busy
                share; migrate_across_sites (its K2 launches derived from
                the leaves it serializes, its output against --device cpu),
                and train_micro_lm at micro-lm-100m's full width (K1 and
                its backward counted as derived, save times), then one
                step of that model at the example's shape on the card
                against device="cpu", profiled;
 11. archs  -- qwen3-1.7b, gemma2-2b and granite-moe-1b-a400m in bf16 at
                full width, each drawn once on the card from seed 0: served
                at full depth (prefill 2 x 512, gemma2's 1 x 4,608 so that
                its 4,096-token window cuts; greedy decode, its steps'
                logits held in float32 to the prefill of the same tokens;
                a full-mode checkpoint whose restore gives bit-identical
                logits), then cut to one layer group against device="cpu"
                (forward and one train step, every gradient leaf held;
                granite's CPU side routed as the card, its step also held
                in float32) and its bf16 decode held to its prefill
                (gemma2's 64 tokens past a window cut to 256), granite-moe's
                training lifecycle at 2 layers (migrated == unmigrated, one
                int8 save and restore), and K1 and its backward in bf16 at
                the three architectures' layer shapes, on inputs where
                softcap and window decide the answer, held to the float32
                plain version with controls and timed beside SDPA; every
                run counted and held to the launches derived for it;
 12. archs2 -- qwen2.5-32b, qwen1.5-32b, phi3.5-moe-42b-a6.6b and
                qwen2-vl-7b in bf16 at full width, each drawn once on the
                card from seed 0 (param_count, the weights' bytes and the
                card's free and peak memory printed): served at full depth
                (phi3.5-moe at 24 of its 32 layers: 83.7 GB do not fit),
                prefill 2 x 512 and greedy decode 2 x 32 + 16 (qwen2-vl on
                embeddings with M-RoPE positions of a patch grid then text),
                S_j at full depth and the gate's verdict on it; then the
                first layer groups kept and the full model freed: a float32
                copy (4 layers; qwen2-vl's whole model) decodes the served
                inputs, held to its prefill; one layer group against
                device="cpu" (forward and one train step, every gradient
                leaf; phi3.5's CPU side routed as the card, its step also in
                float32), its bf16 decode against its prefill, and a
                full-mode checkpoint, gate, migrate_job and restore at that
                depth; each model freed and the card's memory checked; then
                K1 and its backward at the four layer shapes (GQA groups 5,
                1, 4 and 7) with controls for a wrong head mapping or causal
                diagonal; every run counted as derived; then the
                launchers at full width on their default device, each
                drawing its weights on the card: launch.serve --arch
                qwen2.5-32b (the draw's seconds, the peak memory, tokens/s)
                and launch.train --arch qwen3-1.7b for 2 steps, counted;
 13. archs3 -- jamba-v0.1-52b (16 of its 32 layers: 103 GB do not fit),
                xlstm-1.3b and whisper-tiny in bf16 at full width, each
                drawn once on the card from seed 0 and freed before the
                next: jamba and xlstm served (prefill 2 x 512, greedy decode
                2 x 32 + 16) with S_j of the full depth through the gate;
                jamba's first Mamba mixer in float32, a 512-token prefill's
                state carried on by 16 decode steps against the forward over
                528, its blocks b0 (Mamba), b1 (Mamba + MoE) and b4
                (attention) each on the card against device="cpu", and a
                full checkpoint lifecycle of group 0's b0 / b1 (bf16 beside
                float32 A_log and D); xlstm's sLSTM loop timed, a float32
                copy's decode held to its prefill, one layer group against
                device="cpu" in float32, that group's training lifecycle
                (migrated == unmigrated) and an int8 save and restore of its
                sLSTM block's params; whisper's encoder over 2 x
                1,500 frames (K1 with a full mask), greedy decode from
                encdec_init_cache, a float32 copy's decode held to
                decode_train, forward and a train step against
                device="cpu", full and int8 checkpoint lifecycles; then K1
                and its backward at jamba's and whisper's layer shapes, with
                controls for a causal mask in place of the full one and for
                the ragged tail's last key cut off; every run counted;
 14. mesh   -- the sharding layer on a real 1 x 1 ('data', 'model') mesh
                over a one-rank NCCL group (launch/mesh.make_local_mesh):
                micro-lm trains unsharded to step 4, saves, migrate_job,
                Trainer.restore(shardings=...) places the state on the
                mesh and 4 more steps run on DTensors, bit-identical to an
                unmigrated, unsharded run (every leaf and the final
                checkpoint's bytes); qwen3-1.7b in bf16, its prefill of
                2 x 512 under the baseline rules and a greedy decode under
                decode-tp on DTensors, bit-identical to the same calls
                unsharded; crosspod_allgather_mean_int8 on a (1, 1, 1) pod
                mesh bit-identical to compress_roundtrip; jamba's Mamba
                block b0 and attention block b4 and xlstm's first mLSTM
                block in bf16, forward and backward over 1 x 4,096 tokens
                (train_4k's sequence, 16 chunks) on the mesh, bit-identical
                to unsharded, with their peak memory; sharded_batch;
                and one dry-run cell (qwen3-1.7b decode_32k on the 16 x 16
                fake world) in its own process: OK, its peak under the
                card's memory, its roofline terms printed; every run
                counted as derived.
Then one JSON line of per-kernel numbers, and last the ok line.  Nothing
runs on the CPU in place of the card: without a card the script exits 1.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, replace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import serializer as ser  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import active_param_count, param_count  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    flatten_with_paths, params_from_numpy, params_to_numpy, tree_map)
import numpy as np  # noqa: E402

from repro_torch.core import feasibility  # noqa: E402
from repro_torch.core import policy_kernels as pk  # noqa: E402
from repro_torch.core.serving_kernels import ChunkedServingPlane  # noqa: E402
from repro_torch.core.simulator import ClusterSimulator  # noqa: E402
from repro_torch.core.sweep import TIMING_KEYS, SweepSpec, run_cells, run_cells_batched  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.core.migration import migrate_job  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    green_cluster_sim, migrate_across_sites, quickstart, train_micro_lm)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.decide import decide_dest_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_lse_cuda)
from repro_torch.kernels.quantize import dequantize_int8_cuda, quantize_int8_cuda  # noqa: E402
from repro_torch.launch import dryrun as dryrun_launcher  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.serve import greedy_decode  # noqa: E402
from repro_torch.models import encdec as encdec_lib  # noqa: E402
from repro_torch.models import mamba as mamba_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import xlstm as xlstm_lib  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig, apply_updates, global_norm, init_opt_state)
from repro_torch.train.train_step import TrainStepConfig, make_train_step, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh  # noqa: E402
from repro_torch.optim.grad_compress import (  # noqa: E402
    compress_roundtrip, crosspod_allgather_mean_int8)
from repro_torch.parallel.compat import DTensor, distribute_tensor  # noqa: E402
from repro_torch.parallel.shards import mesh_scope  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    force_mesh_axes, logical_spec, named_shardings, param_pspecs, placements, use_rules)
from repro_torch.parallel.strategies import get_strategy  # noqa: E402
from repro_torch.data.pipeline import make_global_batch  # noqa: E402

# The slice: 8 requests of 512 prompt tokens (the synthetic LM stream), 64
# new tokens each.
BATCH, PROMPT, NEW = 8, 512, 64
BANDWIDTH_BPS, WINDOW_S = 10e9, 2.5 * 3600
# Kernel vs plain version, both float32 on the card: the kernel's 3xTF32
# products carry ~2^-22 relative error each (the plain version's IEEE
# float32 ~2^-24) and the tensor cores truncate as they accumulate; both
# sum the hd-term dot products and the softmax-weighted sums over keys in
# different orders (each ~1e-7 relative), and the kernel's 2^x differs from
# exp by a few ulp, so 1e-5 abs and rel.
FLASH_TOL = 1e-5
# bf16 kernel vs the bf16 plain version: tests/test_kernels.py's bf16 SWEEP
# tolerance (the plain version rounds scores to bf16, the kernel keeps them
# in float32; both round p and the output to bf16).
FLASH_BF16_TOL = 2e-2
# Port on the card vs the plain path on the CPU, whole model: float32
# matmuls on both sides in different summation orders over 8 layers.
MODEL_TOL = 1e-4
# bf16 prefill, card vs the CPU plain path, whole model: bf16 weights and
# activations on both sides, rounded in different places (a bf16 ulp at
# the logits' size, ~3, is 1.6e-2): the repo's bf16 tolerance.
MODEL_BF16_TOL = 2e-2
# Prefill vs step-by-step decode, the JAX package's own tolerance
# (tests/test_models.py::test_prefill_decode_equivalence).
DECODE_TOL = 2e-4

# (b, s, t, nh, nkv, hd, mask, window, softcap): the slice's shape, the
# training example's (micro-lm-100m, 2 x 64 tokens a step), the float32
# rows of tests/test_kernels.py::SWEEP, the reduced model's hd 16, and
# ragged shapes that divide no tile.
FLASH_CASES = [
    (BATCH, PROMPT, PROMPT, 6, 6, 64, "causal", 0, 0.0),
    (2, 64, 64, 8, 8, 64, "causal", 0, 0.0),
    (2, 128, 128, 4, 4, 64, "causal", 0, 0.0),
    (2, 256, 256, 4, 2, 64, "causal", 0, 0.0),
    (2, 256, 256, 8, 1, 128, "causal", 0, 0.0),
    (2, 512, 512, 4, 2, 128, "window", 128, 0.0),
    (2, 256, 256, 2, 2, 256, "window", 4096, 0.0),
    (2, 128, 128, 4, 4, 64, "full", 0, 0.0),
    (2, 256, 256, 8, 4, 64, "causal", 0, 50.0),
    (2, 12, 12, 4, 2, 16, "causal", 0, 0.0),
    (1, 200, 200, 4, 2, 32, "causal", 0, 0.0),
    (2, 77, 77, 4, 2, 16, "window", 16, 0.0),
    (1, 100, 300, 2, 1, 128, "full", 0, 0.0),
    (2, 77, 77, 4, 2, 256, "causal", 0, 0.0),  # hd 256: Q from shared memory
]
# bf16: the two bf16 rows of tests/test_kernels.py::SWEEP, the slice's
# shape, and ragged shapes (hd 16 and 256 included).
FLASH_BF16_CASES = [
    (2, 256, 256, 4, 4, 128, "causal", 0, 0.0),
    (2, 512, 512, 6, 6, 64, "window", 256, 30.0),
    (BATCH, PROMPT, PROMPT, 6, 6, 64, "causal", 0, 0.0),
    (2, 77, 77, 4, 2, 16, "window", 16, 0.0),
    (1, 100, 300, 2, 1, 256, "full", 0, 0.0),
]
RAGGED_GROUPS = (1, 3, 100, 1001)

# The attention backward in float32: K1's float32 shapes and, in float32,
# its bf16 SWEEP shapes.  In bf16: FLASH_BF16_CASES.
FLASH_BWD_CASES = FLASH_CASES + FLASH_BF16_CASES[:2]
# Attention backward vs its plain version (the autograd of the plain
# forward), both float32 on the card, as a share of the largest |gradient|
# of each of dQ, dK, dV: each gradient sums up to s * nh / nkv products over
# query rows (dK, dV) or t over keys (dQ) in another order than the plain
# version, recomputes P from K1's 3xTF32 scores and lse (~1e-6 relative),
# and takes D from K1's output; the same algorithm in float32 on the CPU
# lies within 1.5e-6 of the largest gradient, so 1e-4 leaves room for the
# kernel's sums and stays far below any real fault (a wrong mask or softcap
# term moves a gradient by its own size).
GRAD_TOL = 1e-4
# bf16 backward vs the bf16 plain version, as a share of the largest
# |gradient|: FLASH_BF16_TOL's reason (the plain version rounds scores, dP
# and the products to bf16, the kernel keeps S and dP in float32; both
# round P and dS to bf16 before the products and write bf16 gradients).
GRAD_BF16_TOL = FLASH_BF16_TOL
# lse from K1 vs the plain log-sum-exp (base 2): K1's 3xTF32 scores, its
# 2^x and its running max and sum; 1e-5 as K1's own output.
LSE_TOL = 1e-5
# The attention backward's work: 5 products of 2 hd flops per visible
# (q, k) pair (S recomputed, dP, dV, dK, dQ) = 2.5x the forward's 2.
BWD_FLOPS_PER_PAIR_HD = 10

# The training slice: micro-lm at full width, 8 sequences x 512 tokens a
# step (K1 on the shape it is measured at), remat "full", AdamW at the
# reference's default lr 3e-4 (AdamWConfig, launch/train.py) with 3 warmup
# steps.  At full width the loss falls over 24 steps at 3e-4 and not at
# 1e-3 or 3e-3 (the reduced model's test lr).  Site A trains to step 12
# with a checkpoint every 4 steps and is preempted; site B finishes at
# step 24.
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS, TRAIN_PREEMPT, TRAIN_SAVE_EVERY = 24, 12, 4
# The int8 lifecycle saves at preemption and at the end only: each int8 save
# of the training state takes ~6.6 s of zlib on the H100 machine, and every
# fourth step's one added ~26 s to the phase (PR 23).
TRAIN_INT8_SAVE_EVERY = TRAIN_STEPS + 1
TRAIN_LR, TRAIN_WARMUP = 3e-4, 3
# Card against CPU: 2 steps on 2 x 512 tokens.  Step 1 sees the same
# params: the loss is one float32 reduction over 1,024 tokens of logits
# that differ by the card's other summation order and K1's 3xTF32
# (~1e-6 relative), so 1e-5; each first-step gradient leaf within 1e-4 of
# its largest element (the attention backward's own 1e-4, through 8
# layers of float32 GEMMs that add ~1e-6), and the grad norm 1e-5.  Step 2
# starts from params one AdamW step apart: AdamW's first step moves every
# element by lr times the sign of its gradient, so an element whose
# gradient is ~0 (its sign set by rounding) may move the other way on the
# other device: loss and grad norm 1e-4.
CARD_CPU_BATCH = 2
CARD_CPU_LOSS_TOL = (1e-5, 1e-4)
CARD_CPU_GNORM_TOL = (1e-5, 1e-4)
CARD_CPU_GRAD_TOL = 1e-4
# micro-lm in bf16, one step on 2 x 512 tokens, card against CPU: bf16
# weights, activations and attention on both sides, rounded in different
# places (each bf16 rounding 2^-9 relative) and summed in different orders
# over 8 layers: the repo's bf16 tolerance (tests/test_kernels.py SWEEP),
# relative for the loss and the grad norm, and per gradient leaf as a share
# of its largest element.
CARD_CPU_BF16_TOL = 2e-2
# Migrated (full checkpoint) vs unmigrated final params: the restore is
# exact and the card runs the same kernels on the same inputs, so equal;
# 1e-6 as tests/test_system.py::test_full_migration_cycle.
MIGRATION_TOL = 1e-6
# remat "none" / "dots" against "full": the same kernels on the same inputs
# (a recompute reruns them, "dots" saves the GEMMs' outputs), so equal
# bits are expected; else each gradient leaf within 1e-6 of its max.
REMAT_TOL = 1e-6
# a step of 2 micro-batches of 4 x 512 against one batch of 8 x 512: the
# sums of the loss and the gradients split in two (card-vs-CPU tolerances)
MICRO_BATCHES = 2
# the delta-int8 lifecycle: a full save at step 4, the delta save at 8
DELTA_STEPS = 8

KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124"),
    "flash_attention_bf16": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124"),
    "quantize_int8": dict(
        route="cuda", source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:44"),
    "dequantize_int8": dict(
        route="cuda", source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:67"),
    "decide_dest": dict(
        route="cuda", source="src/repro_torch/csrc/decide.cu",
        replaces="src/repro/core/policy_kernels.py:609"),
    # no TPU kernel: the JAX package trains through XLA's autodiff of
    # flash_attention_ref (src/repro/train/train_step.py:33)
    "flash_attention_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/ref.py:17"),
    "flash_attention_bwd_bf16": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/ref.py:17"),
}
# H100 SXM data sheet (NVIDIA spec): HBM 3.35 TB/s; float32 outside the
# tensor cores 67 TFLOP/s; float64 outside the tensor cores 34 TFLOP/s;
# dense tensor cores 495 TFLOP/s TF32 and 989 TFLOP/s bf16.
HBM_BPS, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 34e12
TF32_FLOPS, BF16_FLOPS = 495e12, 989e12
# K1 float32 does each product as three TF32 products (3xTF32).
TF32_SPLIT = 3

# The orchestration slice, at the sizes of the repo's perf gate
# (benchmarks/run.py, copied here: the script imports nothing of benchmarks/).
FLEET_COMPILED_OVERRIDES = dict(n_sites=100, n_jobs=10000, arrival_skew=(1.0,) * 100)
SWEEP_BATCHED_SPEC = dict(
    scenarios=("paper-table6", "forecastable-brownouts"),
    policies=("feasibility-aware",), seeds=tuple(range(500)),
    overrides=dict(n_jobs=6, days=1, orch_dt_s=1800.0))
PROFILE_FLEET_OVERRIDES = dict(days=2, n_jobs=570)
PROFILE_SWEEP_SEEDS = 50
BENCH_QUICK = os.path.join(HERE, "benchmarks", "BENCH_quick.json")
# fleet-compiled digits the week must reproduce, rounded as benchmarks/run.py rounds them
FLEET_DIGITS = (("grid_kwh", 1), ("renewable_kwh", 1), ("grid_gco2", 1), ("grid_cost", 2),
                ("migrations", None), ("completed", None), ("rejected_actions", None))
# The serving week's digits (BENCH_quick.json "serving_fastpath") and
# train-plus-serve's ("policies" / "carbon-slo"), rounded as
# benchmarks/run.py rounds them.
SERVING_DIGITS = (("requests_arrived", None), ("requests_served", None),
                  ("requests_dropped", None), ("slo_violations", None),
                  ("latency_p95_s", 3), ("request_gco2", 1))
CARBON_SLO_DIGITS = FLEET_DIGITS + SERVING_DIGITS
# The training example at micro-lm-100m's full width (20 layers, d 512,
# 8 x 64 heads), its default batch 2 x 64 and lr 1e-3, and its default 300
# steps: its own check that the loss falls across the migration fails on
# the card at 40, 60 and 90 steps (``python -m
# repro_torch.examples.train_micro_lm --steps N``; PERF.md), so the depth is
# not cut.
EXAMPLE_STEPS = 300
# The [archs] phase: the assigned architectures the port runs, in bf16 at
# full width, their random weights drawn on the card from seed 0.
ARCHS = ("qwen3-1.7b", "gemma2-2b", "granite-moe-1b-a400m")
# Serving at full depth: a prefill of 2 x 512 tokens, gemma2's of 1 x 4,608
# so that its 4,096-token window cuts; greedy decode of 16 new tokens on a
# 2 x 32 prompt.
ARCH_PREFILL = {"gemma2-2b": (1, 4608)}
ARCH_PREFILL_DEFAULT = (2, 512)
ARCH_PROMPT, ARCH_NEW = (2, 32), 16
# Card against device="cpu": full width, depth cut to one layer group
# (gemma2: one local and one global layer), 2 x 64 tokens; bf16 on both
# sides, so the repo's bf16 tolerance (CARD_CPU_BF16_TOL) as a share of the
# largest element, for the logits as for the gradients: each of the 19-33 M
# logits is a 2,048-2,304-term dot product of a bf16 hidden state (each
# element rounded in other places on the two sides, ~2^-9 relative) with a
# table row, so the largest of their differences is the tail of that
# spread, not a bf16 step of the logit it lands on.
ARCH_CARD_CPU_SEQ = 64
# bf16 decode at one layer group: 2 x ARCH_CARD_CPU_SEQ tokens fed step by
# step, or for gemma2 one sequence of this many tokens beyond its
# 4,096-token window, so the local layer's ring-buffer cache wraps.
ARCH_PAST_WINDOW = 64
# The ring-buffer decode past the window is held at a window cut to
# CUT_DECODE_WINDOW (the prefill cut the same way): a ring buffer wraps the
# same way at any window, and gemma2's own 4,096-token window cost a
# 4,160-step decode (21-28 s); K1 at the 4,096 window stays held by
# check_arch_flash and the [archs] prefill.
CUT_DECODE_WINDOW = 256
# granite-moe's training lifecycle: full width, depth cut to 2 layers (the
# training state, bf16 params and float32 master / m / v, ~2.2 GB); site A
# trains to step 6 with a checkpoint every 3 steps and is preempted; site B
# finishes at 12.
MOE_ARCH, MOE_LIFE_LAYERS = "granite-moe-1b-a400m", 2
MOE_LIFE_STEPS, MOE_LIFE_PREEMPT, MOE_LIFE_SAVE_EVERY = 12, 6, 3
# K1 in bf16 at the architectures' own layer shapes (b, s, t, nh, nkv, hd,
# mask, window, softcap), each named by its architecture first: qwen3's
# prefill, gemma2's local and global layers over its 4,608-token prefill
# (softcap 50), granite's prefill ([archs]); then the prefills of
# [archs2]: GQA groups of 5 (qwen2.5), 1 with 40 kv heads (qwen1.5's MHA),
# 4 (phi3.5-moe) and 7 (qwen2-vl); then [archs3]'s: jamba's attention
# layers (no RoPE), whisper's encoder (1,500 frames, every query sees every
# key; 1,500 = 23 x 64 + 28, so the last key tile is ragged) and its
# decoder's self-attention over 64 tokens.
ARCH_FLASH_CASES = {
    "qwen3-1.7b": (2, 512, 512, 16, 8, 128, "causal", 0, 0.0),
    "gemma2-2b local": (1, 4608, 4608, 8, 4, 256, "window", 4096, 50.0),
    "gemma2-2b global": (1, 4608, 4608, 8, 4, 256, "causal", 0, 50.0),
    "granite-moe-1b-a400m": (2, 512, 512, 16, 8, 64, "causal", 0, 0.0),
    "qwen2.5-32b": (2, 512, 512, 40, 8, 128, "causal", 0, 0.0),
    "qwen1.5-32b": (2, 512, 512, 40, 40, 128, "causal", 0, 0.0),
    "phi3.5-moe-42b-a6.6b": (2, 512, 512, 32, 8, 128, "causal", 0, 0.0),
    "qwen2-vl-7b": (2, 512, 512, 28, 4, 128, "causal", 0, 0.0),
    "jamba-v0.1-52b": (2, 512, 512, 32, 8, 128, "causal", 0, 0.0),
    "whisper-tiny encoder": (2, 1500, 1500, 6, 6, 64, "full", 0, 0.0),
    "whisper-tiny decoder": (2, 64, 64, 6, 6, 64, "causal", 0, 0.0),
}
# These shapes are held on inputs where the softcap and the mask's edge
# decide the answer.  Q is scaled by ARCH_FLASH_Q_SCALE, so the scores
# q.k / sqrt(hd) spread with std ~8 and reach ~30, where softcap 50 takes
# 50 tanh(30 / 50) = 26.9.  Each key on the mask's edge is turned toward
# the first query row of its group's first head that must see it and the
# first that must not (ARCH_FLASH_EDGE unit vectors of those rows, ~48
# added to both scores, 37 after the cap): the key then takes most of the
# one row's weight and must take none of the other's.  Scores of ~30 in
# bf16 are rounded to 1/8, which moves their weights by up to 6%, so the
# bf16 plain version is no reference here: the kernel is held to the
# plain version in float32 on the same bf16 inputs, its output within
# FLASH_BF16_TOL of the largest |output| and each gradient within
# GRAD_BF16_TOL of its largest (the kernel keeps S and dP in float32 and
# rounds P, dS and what it writes to bf16, 2^-9 relative each).  Controls,
# on the same inputs and against the same limit: the float32 plain version
# with softcap 0, with the window one key shorter and one key longer, with
# query head h reading kv head h % nkv in place of h // group (where the
# two differ), and with the causal diagonal moved by one key either way,
# must each miss it in the output and in every gradient.  A full mask has
# no edge inside: there the last key (the ragged tail's) is turned toward
# the first query row of each group's first head, and the controls are the
# float32 plain version with a causal mask in place of the full one and
# with that last key cut off (its dk, dv rows 0).
ARCH_FLASH_Q_SCALE, ARCH_FLASH_EDGE = 8.0, 6.0
# The [archs2] phase: the rest of the attention family, in bf16 at full
# width, their random weights drawn on the card from seed 0.  Served at
# full depth, but phi3.5-moe's 83.7 GB of bf16 weights do not fit the
# card's 80 GB: its first 24 of 32 layers (62.9 GB).
ARCHS2 = ("qwen2.5-32b", "qwen1.5-32b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b")
# the launchers at full width, after [archs2]: launch.serve (batch, prompt,
# new tokens) and launch.train (steps of batch x seq tokens)
LAUNCH_SERVE_ARCH, LAUNCH_SERVE_SHAPE = "qwen2.5-32b", (2, 8, 8)
LAUNCH_TRAIN_ARCH, LAUNCH_TRAIN_STEPS, LAUNCH_TRAIN_SHAPE = "qwen3-1.7b", 2, (1, 512)
ARCH2_LAYERS = {"phi3.5-moe-42b-a6.6b": 24}
# The float32 decode check runs on a float32 copy of the first
# ARCH2_F32_GROUPS layer groups (a float32 copy of a 32 B model does not
# fit); qwen2-vl's whole float32 copy (30.5 GB) fits beside its bf16
# weights, so it is held at full depth.
ARCH2_F32_GROUPS = 4
ARCH2_F32_FULL_DEPTH = ("qwen2-vl-7b",)
# qwen2-vl's inputs: embeddings drawn as the embedding table's rows are
# (std 0.02), and M-RoPE positions of a patch grid followed by text: the
# 2 x 512 prefill a 16 x 16 grid and 256 text positions, the 2 x 32 decode
# prompt and the one-group checks a 4 x 4 grid and the rest text.
ARCH2_EMBED_STD = 0.02
ARCH2_GRID, ARCH2_SMALL_GRID = (16, 16), (4, 4)
# Card against device="cpu" at one layer group: 2 x 32 tokens, not
# [archs]' 2 x 64.  At these widths the CPU side at 2 x 64 took 10-28 s a
# bf16 step and 16 s for phi3.5-moe's float32 step on the H100 machine's
# host (the dense dispatch runs all 16 experts on every token), and the
# whole script 1,040 s of its 1,200.
ARCH2_CARD_CPU_SEQ = 32
# After a model is freed the card must hold no more than this beyond what
# it held before the model was drawn.
ARCH2_LEAK_BYTES = 1 << 30
# The [archs3] phase: the last three assigned architectures, in bf16 at full
# width, their random weights drawn on the card from seed 0.  jamba is
# served at 2 of its 4 eight-layer groups (16 layers: 14 Mamba, 2
# attention, 8 MoE; 52.1 GB): its 32 layers' 103.1 GB do not fit the card.
ARCHS3 = ("jamba-v0.1-52b", "xlstm-1.3b", "whisper-tiny")
ARCH3_LAYERS = {"jamba-v0.1-52b": 16}
# jamba's first Mamba mixer in float32 at full width over 2 x MAMBA_SEQ
# tokens (two chunks of 264), against a MAMBA_PREFILL-token prefill's state
# followed by MAMBA_SEQ - MAMBA_PREFILL decode steps: the prefill's scan
# crosses its chunk boundary and hands its conv and SSM state to decode.
# Held within DECODE_TOL of the largest |output| (the decode's recurrence
# and the doubling scan sum the same products in other orders).
MAMBA_SEQ, MAMBA_PREFILL = 528, 512
# jamba's blocks held on the card against device="cpu" one by one, in bf16
# on 2 x ARCH2_CARD_CPU_SEQ activations: b0 (Mamba + MLP), b1 (Mamba + MoE,
# the CPU routed as the card) and b4 (attention + MLP); one group of jamba
# (13 B params) is too large for a CPU step.
JAMBA_BLOCKS = (0, 1, 4)
# Its checkpoint lifecycle holds group 0's b0 / b1 without b1's experts'
# weights: they are 5.3 GB of its 6.4 GB (~16 s of save, migrate and
# restore), bf16 leaves like b0's MLP, and [archs2] checkpoints experts.
JAMBA_CKPT_DROP = ("wi", "wg", "wo")
# xlstm's training lifecycle at one layer group (7 mLSTM + 1 sLSTM, 504 M
# params; a 7.1 GB training state, ~12 s a full save on the H100 machine)
# on 2 x 64 tokens a step: site A trains to step 3 and is preempted (its
# one checkpoint: the save interval lies beyond the run); site B finishes
# at 6.  Over 4 steps the loss did not fall on the card (11.147, 11.097,
# 11.100, 11.188); over 6 it does.  Then an int8 save and restore of its
# sLSTM block's params (its training state's took 7 s of zlib).
XLSTM_LIFE_BATCH, XLSTM_LIFE_SEQ = 2, 64
XLSTM_LIFE_STEPS, XLSTM_LIFE_PREEMPT, XLSTM_LIFE_SAVE_EVERY = 6, 3, 7
# xlstm's first sLSTM layer's scan timed over 2 x this many tokens.
SLSTM_TIME_SEQ = 512
# whisper's frame embeddings (the stubbed conv frontend's output): N(0, 1).
WHISPER_FRAME_STD = 1.0
# K4 at the upper fleet shape: 131,072 jobs x 100 sites (104 padded), one cell
UPPER_JOBS, UPPER_SITES = 131072, 100
# A cell of more sites than K4 stages at a time (128): 1,024 jobs x 300 sites
WIDE_JOBS, WIDE_SITES = 1024, 300
# float64 operations per (job, site) element of the decide, comparisons
# included (the deterministic gate): tt 1, t_cost 2, energy 2, class C 1,
# time 2, avoided 3, benefit 5, validity 2, argbest 2
DECIDE_OPS = 20
STOCH_PARAMS = dict(eps=0.05, forecast_sigma_s=900.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` CUDA-event-timed calls,
    after ``warmup``.  A spin kernel is queued ahead of each timed call, so
    the host has enqueued all of ``fn``'s launches before the device reaches
    them: the events time the device's work, not the host's launch pace
    (which the slice's wall-clock numbers show).  If the device reached the
    start event before the host returned, the spin was too short: the call
    is timed again with a spin twice as long, up to ~0.5 s of spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, spin = [], 1 << 22
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            times.append(start.elapsed_time(end))
        elif spin >= 1 << 30:  # ~0.5 s of spin: fn itself waits for the device
            raise RuntimeError("timed call synchronises with the device; cannot time it")
        else:
            spin *= 2
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(gen, shape, device, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device)


# ---------------------------------------------------------------------------
# The serving slice (also run on the CPU by tests/test_torch_slice.py)
# ---------------------------------------------------------------------------


@dataclass
class SliceResult:
    logits_a: torch.Tensor
    tokens_a: torch.Tensor
    logits_b: torch.Tensor
    tokens_b: torch.Tensor
    params_b: dict
    manager: CheckpointManager
    nbytes: int
    verdict: feasibility.FeasibilityVerdict
    report: object
    prefill_a_s: float
    decode_a_s: float
    save_s: float
    migrate_s: float
    restore_s: float
    prefill_b_s: float
    decode_b_s: float


def run_slice(cfg, params, prompts, workdir, *, max_new, device,
              bandwidth_bps=BANDWIDTH_BPS, window_s=WINDOW_S) -> SliceResult:
    """Serve at site A, int8-checkpoint, gate, migrate, restore and serve
    again at site B, through the port's entry points on ``device``."""
    dev = resolve(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    model = build_model(cfg)
    cache_len = prompts.shape[1] + max_new
    clock = time.perf_counter

    def timed(fn):
        t0 = clock()
        out = fn()
        sync()
        return out, clock() - t0

    (logits_a, _), prefill_a = timed(lambda: model.forward(params, {"tokens": prompts}))
    tokens_a, decode_a = timed(lambda: greedy_decode(model, params, prompts, max_new, cache_len))
    mgr = CheckpointManager(os.path.join(workdir, "siteA"), job=cfg.name, mode="int8")
    _, save_s = timed(lambda: mgr.save(0, params))
    nbytes = mgr.latest_bytes
    verdict = feasibility.evaluate(nbytes, bandwidth_bps, window_s)
    if not bool(verdict.feasible):
        raise RuntimeError(f"feasibility gate refused {nbytes} B at {bandwidth_bps} b/s: {verdict}")
    (dst, report), migrate_s = timed(lambda: migrate_job(
        mgr, os.path.join(workdir, "siteB"), bandwidth_bps=bandwidth_bps, window_s=window_s))
    (params_b, _), restore_s = timed(lambda: dst.restore(params, device=dev))
    (logits_b, _), prefill_b = timed(lambda: model.forward(params_b, {"tokens": prompts}))
    tokens_b, decode_b = timed(lambda: greedy_decode(model, params_b, prompts, max_new, cache_len))
    return SliceResult(logits_a, tokens_a, logits_b, tokens_b, params_b, mgr, nbytes, verdict,
                       report, prefill_a, decode_a, save_s, migrate_s, restore_s, prefill_b,
                       decode_b)


def run_bf16_prefill(cfg, params, prompts, *, device):
    """Prefill (Model.forward over the prompts) of ``cfg`` served in
    bf16, the type every other assigned architecture serves in: the weights
    cast to bf16 on ``device``.  Returns (logits, seconds)."""
    dev = resolve(device)
    model = build_model(replace(cfg, dtype="bfloat16"))
    p16 = tree_map(lambda x: x.to(device=dev, dtype=torch.bfloat16), params)
    t0 = time.perf_counter()
    logits, _ = model.forward(p16, {"tokens": prompts.to(dev)})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return logits, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# The training slice (also run on the CPU by tests/test_torch_train.py)
# ---------------------------------------------------------------------------


def make_trainer(cfg, root, *, steps, save_every, mode, grad_compress, batch, seq, device,
                 preempt_at=None) -> Trainer:
    """A Trainer of ``cfg`` on the synthetic LM stream (seed 0), AdamW on
    the cosine schedule, remat "full", checkpoints under ``root``."""
    step_cfg = TrainStepConfig(opt=AdamWConfig(lr=TRAIN_LR), total_steps=steps,
                               warmup_steps=TRAIN_WARMUP, grad_compress=grad_compress,
                               remat_policy="full")
    trainer = Trainer(
        build_model(cfg), SyntheticLMDataset(cfg.vocab_size, seq, batch),
        CheckpointManager(root, job=cfg.name, mode=mode),
        TrainerConfig(total_steps=steps, save_every=save_every, log_every=1, ckpt_mode=mode,
                      step_cfg=step_cfg), device=device)
    if preempt_at is not None:
        trainer.preempt_signal = lambda step: step >= preempt_at
    return trainer


def saves_in(start: int, stop: int, save_every: int) -> int:
    """Saves Trainer.run makes from step ``start`` to ``stop``: one at every
    multiple of save_every, and one when it stops (preempted, or at the end
    of its budget)."""
    return sum(1 for st in range(start + 1, stop + 1) if st % save_every == 0) + 1


def attn_layers(cfg) -> int:
    """Layers whose self-attention runs K1 in one forward: the attention
    blocks of the layer pattern (a Mamba, mLSTM or sLSTM block runs none),
    or an encoder-decoder's encoder and decoder layers (its
    cross-attention is the plain attend_ref)."""
    if cfg.is_encdec:
        return cfg.encoder_layers + cfg.num_layers
    return cfg.num_groups * sum(kind.startswith("attn") for kind in cfg.block_pattern)


def step_launches(cfg, remat_policy: str) -> dict:
    """K1 and backward launches of one train step, from the code: K1 once
    per attention layer in the forward and once more in remat's recompute
    (its custom Function is no matmul, so "dots" reruns it too), the
    backward kernel once per attention layer; counted under the model's
    type."""
    layers = attn_layers(cfg)
    k1 = layers * (1 if remat_policy == "none" else 2)
    tag = "_bf16" if cfg.dtype == "bfloat16" else ""
    out = dict.fromkeys(ops.launch_counts(), 0)
    out.update({f"flash_attention{tag}": k1, f"flash_attention_bwd{tag}": layers})
    return out


def train_launches(cfg, trainer: Trainer, *, steps: int, saves: int = 0,
                   restores: int = 0) -> dict:
    """The launches a stretch of the training path makes, from the code:
    per step ``step_launches``, and under grad_compress K2 and K3 once per
    float grad leaf of at least one 256-element block; per int8 save K2,
    per int8 restore K3, once per float leaf of the state (params, master,
    m, v)."""
    sc = trainer.cfg.step_cfg
    state_leaves = sum(1 for _, x in flatten_with_paths(trainer.state_tree())
                       if isinstance(x, torch.Tensor) and x.is_floating_point())
    grad_leaves = sum(1 for _, x in flatten_with_paths(trainer.params)
                      if x.is_floating_point() and x.numel() >= 256)
    gc = grad_leaves * steps if sc.grad_compress else 0
    int8 = trainer.cfg.ckpt_mode != "full"
    out = {k: v * steps for k, v in step_launches(cfg, sc.remat_policy).items()}
    out.update(quantize_int8=gc + (state_leaves * saves if int8 else 0),
               dequantize_int8=gc + (state_leaves * restores if int8 else 0))
    return out


@dataclass
class TrainResult:
    mode: str
    grad_compress: bool
    history: list  # site A's rows, then site B's
    state_a: dict  # site A's state at preemption
    state_b0: dict  # site B's state just after restore
    params_b: dict
    params_ref: object  # the unmigrated run's final params (None if not run)
    manager_b: CheckpointManager
    raw_b: bytes  # the checkpoint site B restored
    launches: dict  # segment -> (counted, expected)
    steps: int  # site A trains to ``preempt``, site B on to ``steps``
    preempt: int
    nbytes: int
    verdict: feasibility.FeasibilityVerdict
    report: object
    save_s: float
    migrate_s: float
    restore_s: float
    run_a_s: float
    run_b_s: float


def run_train_lifecycle(cfg, workdir, *, mode, grad_compress, device, batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, reference=True, steps=TRAIN_STEPS, preempt=TRAIN_PREEMPT,
                        save_every=TRAIN_SAVE_EVERY) -> TrainResult:
    """Train at site A until preempted at step ``preempt`` (a checkpoint
    every ``save_every`` steps), gate on the measured checkpoint,
    migrate_job, restore at site B on ``device`` and finish there at
    ``steps``; with ``reference``, first an unmigrated run of all the steps.
    Each stretch runs with the launch counters set to 0 just before it and
    read just after, beside the counts ``train_launches`` derives for it."""
    dev = resolve(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    launches = {}

    def segment(name, fn, expect):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        dt = time.perf_counter() - t0
        launches[name] = (ops.launch_counts(), expect())
        return out, dt

    kw = dict(mode=mode, grad_compress=grad_compress, batch=batch, seq=seq, device=dev)
    params_ref = None
    if reference:
        # The run only gives params_ref, so it saves nothing: its save
        # interval lies beyond the run, and its budget one step beyond it,
        # so the save a run makes when it reaches its budget never comes
        # (the learning-rate schedule still ends at ``steps``).
        ref_tr = make_trainer(cfg, os.path.join(workdir, "unmigrated"), steps=steps,
                              save_every=steps + 1, **kw)
        ref_tr.cfg = replace(ref_tr.cfg, total_steps=steps + 1)
        segment("unmigrated", lambda: ref_tr.run(max_steps=steps), lambda: train_launches(
            cfg, ref_tr, steps=steps))
        if ref_tr.step != steps or ref_tr.saves:
            raise RuntimeError(f"unmigrated run: step {ref_tr.step}, saves {ref_tr.saves}")
        params_ref = ref_tr.params
    a = make_trainer(cfg, os.path.join(workdir, "siteA"), steps=steps, save_every=save_every,
                     preempt_at=preempt, **kw)
    status_a, run_a_s = segment("site A", a.run, lambda: train_launches(
        cfg, a, steps=preempt, saves=saves_in(0, preempt, save_every)))
    if status_a["status"] != "preempted" or status_a["step"] != preempt:
        raise RuntimeError(f"site A: {status_a}, expected preempted at step {preempt}")
    nbytes = a.ckpt.latest_bytes
    save_s = a.ckpt.latest.wall_time_s
    verdict = feasibility.evaluate(nbytes, BANDWIDTH_BPS, WINDOW_S)
    if not bool(verdict.feasible):
        raise RuntimeError(f"feasibility gate refused {nbytes} B at {BANDWIDTH_BPS} b/s: {verdict}")
    t0 = time.perf_counter()
    dst, report = migrate_job(a.ckpt, os.path.join(workdir, "siteB"),
                              bandwidth_bps=BANDWIDTH_BPS, window_s=WINDOW_S)
    migrate_s = time.perf_counter() - t0
    raw_b = dst.export_bytes()
    b = make_trainer(cfg, os.path.join(workdir, "siteB"), steps=steps, save_every=save_every,
                     **kw)
    b.ckpt = dst
    restored, restore_s = segment("site B restore", b.restore, lambda: train_launches(
        cfg, b, steps=0, restores=1))
    if restored != preempt:
        raise RuntimeError(f"site B restored step {restored}, expected {preempt}")
    state_b0 = b.state_tree()
    # Site B's save at the end of its budget is never read (the checks read
    # its params), so its budget lies one step beyond the run, as the
    # unmigrated run's does: it keeps its periodic saves only.
    b.cfg = replace(b.cfg, total_steps=steps + 1)
    status_b, run_b_s = segment("site B", lambda: b.run(max_steps=steps - preempt),
                                lambda: train_launches(cfg, b, steps=steps - preempt,
                                                       saves=saves_in(preempt, steps, save_every) - 1))
    if status_b["status"] != "done" or status_b["step"] != steps:
        raise RuntimeError(f"site B: {status_b}, expected done at step {steps}")
    return TrainResult(mode, grad_compress, a.history + b.history, a.state_tree(), state_b0,
                       b.params, params_ref, dst, raw_b, launches, steps, preempt, nbytes, verdict,
                       report, save_s, migrate_s, restore_s, run_a_s, run_b_s)


def run_train_steps(cfg, params, batches, *, device, profile=False):
    """The first batch's gradients, then one train step per batch, from
    ``params`` copied to ``device``, with the launch counters set to 0 just
    before the steps and read just after (with ``profile``, the steps run
    under torch.profiler).  Returns (grads, [metrics per step], launches,
    (wall us, device events) of the steps or None)."""
    dev = resolve(device)
    model = build_model(cfg)
    p = tree_map(lambda x: x.detach().to(dev, copy=True), params)
    step_cfg = TrainStepConfig(opt=AdamWConfig(lr=TRAIN_LR), total_steps=TRAIN_STEPS,
                               warmup_steps=TRAIN_WARMUP)
    _, grads = value_and_grad(model, p, {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()},
                              step_cfg.remat_policy)
    step = make_train_step(model, step_cfg)
    state = (p, init_opt_state(p))

    def steps():
        nonlocal state
        metrics = []
        for batch in batches:
            *state, m = step(*state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics

    ops.reset_launch_counts()
    if profile:
        metrics, wall_us, events = _profiled(steps)
        prof = (wall_us, events)
    else:
        metrics, prof = steps(), None
    return grads, metrics, ops.launch_counts(), prof


# ---------------------------------------------------------------------------
# The orchestration slice (paths also run on the CPU by the rehearsal)
# ---------------------------------------------------------------------------


def strip_timing(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in TIMING_KEYS}


def run_table6(device):
    return ClusterSimulator.from_scenario("paper-table6", "feasibility-aware",
                                          device=device).run()


def run_fleet_week(device):
    return ClusterSimulator.from_scenario(
        "forecastable-brownouts", "feasibility-aware",
        overrides=FLEET_COMPILED_OVERRIDES, device=device).run()


def run_sweep_batched(device, seeds=SWEEP_BATCHED_SPEC["seeds"]):
    spec = SweepSpec(**{**SWEEP_BATCHED_SPEC, "seeds": tuple(seeds)})
    return run_cells_batched(spec.cells(), device=device)


FLEET_PATHS = (("paper-table6 week", run_table6),
               ("fleet-compiled week", run_fleet_week),
               ("batched sweep", run_sweep_batched))


def run_fleet_jobs(device):
    return ClusterSimulator.from_scenario(
        "forecastable-brownouts", "feasibility-aware",
        overrides={**FLEET_COMPILED_OVERRIDES, **PROFILE_FLEET_OVERRIDES}, device=device).run()


# The profiled and cProfiled reruns read busy shares and the host split, not
# digits: the same paths cut in depth (the fleet over 2 days with 570 of its
# jobs, the sweep over a tenth of its runs).
PROFILE_PATHS = (("paper-table6 week", run_table6),
                 ("fleet-compiled, 2 days, 570 jobs", run_fleet_jobs),
                 ("batched sweep, 100 runs", lambda device: run_sweep_batched(
                     device, seeds=SWEEP_BATCHED_SPEC["seeds"][:PROFILE_SWEEP_SEEDS])))


def path_stats(out) -> dict:
    """Wall, ticks and decide wall of one path's result (a SimResult, or a
    SweepResult whose runs kept their results)."""
    runs = [r.result for r in out.runs] if hasattr(out, "runs") else [out]
    wall = out.wall_s if hasattr(out, "runs") else out.wall_time_s
    ticks = sum(r.ticks for r in runs)
    return dict(wall_s=wall, ticks=ticks, ticks_per_s=ticks / wall, runs=len(runs),
                decide_s=sum(r.decide_s for r in runs),
                decide_first_s=sum(r.decide_first_s for r in runs))


def same_output(name: str, got, want) -> None:
    """A card path's output against the same path on the CPU, timing
    keys aside."""
    if hasattr(got, "runs"):
        same = got.deterministic_summaries() == want.deterministic_summaries()
    else:
        same = strip_timing(got.summary()) == strip_timing(want.summary())
    if not same:
        raise RuntimeError(f"{name} on the card differs from the same run with device='cpu'")


def exactly(counts: dict, **want) -> dict:
    """Every counter 0 but ``want``'s."""
    return {**dict.fromkeys(counts, 0), **want}


def k4_only(name: str, counts: dict) -> None:
    if counts["decide_dest"] <= 0 or counts != exactly(counts, decide_dest=counts["decide_dest"]):
        raise RuntimeError(f"{name}: launch counts {counts}, expected K4 only and > 0")


def check_bench_row(r, keys, digits) -> str:
    """``r``'s numbers, rounded as benchmarks/run.py rounds them, against
    the BENCH_quick.json row at ``keys``."""
    with open(BENCH_QUICK) as f:
        row = json.load(f)
    for key in keys:
        row = row[key]
    got = {k: (round(getattr(r, k), nd) if nd is not None else getattr(r, k))
           for k, nd in digits}
    want = {k: row[k] for k, _ in digits}
    if got != want:
        raise RuntimeError(f"{'/'.join(keys)}: {got} differs from BENCH_quick.json {want}")
    return " / ".join(str(got[k]) for k, _ in digits)


def check_fleet_digits(r) -> str:
    return check_bench_row(r, ("policies", "fleet-compiled"), FLEET_DIGITS)


@contextlib.contextmanager
def largest_batch(into: dict, key: str):
    """While the block runs, keep the largest padded batch the decide path
    scores, among those the one where most rows move, with its params, as
    ``into[key]``: real ticks for the K4 checks, taken from the CPU runs."""
    scorer = pk.score_batch
    best = []

    def recording(batch, params, device=None):
        dest = scorer(batch, params, device)
        rank = (batch.bw.size, int((dest >= 0).sum()))
        if not best or rank > best[0]:
            best[:] = [rank]
            into[key] = (batch, params)
        return dest

    pk.score_batch = recording
    try:
        yield
    finally:
        pk.score_batch = scorer


def hand_batch():
    """Cells built by hand, with the destination each row must get:
    exact ties (equal benefit: the lower tt wins at a higher sid; equal
    benefit and tt: the lowest sid), a dead link row, a class-C row, a
    site without a free slot, a dark fleet, every slot full."""
    H, G = 3600.0, 1e9

    def cell(W, bw_rows, free, sizes=None):
        k, n = len(bw_rows), len(W)
        return pk.StateRows(
            sizes=np.array(sizes or [5 * G] * k), t_loads=np.full(k, 10.3),
            rem=np.full(k, 8 * H), cur_green=np.zeros(k), load_src=np.full(k, 0.5),
            s_i=np.zeros(k, dtype=np.int64), bw=np.array(bw_rows, dtype=np.float64),
            W=np.array(W), bq_load=np.full(n, 0.25), free_slots=np.array(free, dtype=np.int64))

    cells = [
        (cell([0, 6 * H, 6 * H, 6 * H],
              [[0, 1e9, 2e9, 1e9], [0, 2e9, 2e9, 2e9], [0, 0, 0, 0], [0, 1e9, 1e9, 1e9]],
              [1, 1, 1, 1], sizes=[5 * G, 5 * G, 5 * G, 40 * G]), [2, 1, -1, -1]),
        (cell([0, 7 * H, 6 * H], [[0, 2e9, 2e9]], [1, 0, 1]), [2]),
        (cell([0, 0, 0], [[0, 2e9, 2e9]], [1, 1, 1]), [-1]),
        (cell([0, 6 * H, 7 * H], [[0, 2e9, 2e9]], [0, -1, 0]), [2]),
    ]
    return pk.build_batch([c for c, _ in cells]), [e for _, e in cells]


def upper_batch(seed: int = 0, jobs: int = UPPER_JOBS, n: int = UPPER_SITES):
    """One seeded fleet cell at the upper end of the fleet regime.  Site
    windows, queue loads and link rates come from small sets, so exact
    ties in benefit and in tt are common; every site state is present
    (dark, full, dead links)."""
    rng = np.random.default_rng(seed)
    W = rng.choice([0.0, 0.0, 1800.0, 7200.0, 14400.0, 21600.0], n)
    bq = rng.choice([0.0, 0.25, 0.5, 1.0], n)
    s_i = rng.integers(0, n, jobs)
    rows = pk.StateRows(
        sizes=rng.choice([1e9, 2e9, 5e9, 20e9, 100e9], jobs) * rng.choice([1.0, 1.5], jobs),
        t_loads=np.full(jobs, 10.3), rem=rng.uniform(600.0, 86400.0, jobs),
        cur_green=W[s_i], load_src=bq[s_i], s_i=s_i,
        bw=rng.choice([0.0, 1e9, 2.5e9, 10e9], (jobs, n)), W=W, bq_load=bq,
        free_slots=rng.choice([-1, 0, 1, 2], n))
    return pk.build_batch([rows])


def check_decide(dev, captured: dict, *, upper_jobs: int = UPPER_JOBS) -> dict:
    """K4 on the card against its plain version on the card and against
    the numpy pass _score_numpy on the host: destinations exactly equal,
    on real ticks, the hand-built cells, the upper fleet batch and a cell
    of more sites than the kernel stages at a time, under
    the policy's params, the stochastic gate and min_benefit 0.  Then the
    kernel's time at the upper shape, beside its plain version and bound."""
    hand, expect = hand_batch()
    upper = upper_batch(jobs=upper_jobs)
    base = captured["paper-table6 week"][1]
    batches = [(name, captured[name][0]) for name, _ in FLEET_PATHS]
    batches += [("hand-built", hand), ("synthetic upper fleet", upper),
                ("synthetic wide cell", upper_batch(1, WIDE_JOBS, WIDE_SITES))]
    param_sets = (("policy", base), ("stochastic", replace(base, **STOCH_PARAMS)),
                  ("min_benefit 0", replace(base, min_benefit_s=0.0)))
    for name, batch in batches:
        jobs, sites = (torch.from_numpy(a).to(dev) for a in pk.pack_batch(batch))
        bw = torch.from_numpy(batch.bw).to(dev)
        moved = []
        for pname, params in param_sets:
            sc = pk.kernel_scalars(params)
            got = decide_dest_cuda(jobs, sites, bw, **sc)
            plain = ref.decide_dest_ref(jobs, sites, bw, **sc)
            host = pk._score_numpy(batch, params)
            got_h = got.cpu().numpy()
            if not torch.equal(got, plain) or not np.array_equal(got_h, host):
                raise RuntimeError(
                    f"decide_dest on {name} ({pname}) differs: {int((got != plain).sum())} rows "
                    f"from the plain version, {int((got_h != host).sum())} from _score_numpy")
            if name == "hand-built":
                for b, want in enumerate(expect):
                    if list(got_h[b, :len(want)]) != want:
                        raise RuntimeError(f"hand-built cell {b}: {got_h[b, :len(want)]} != {want}")
            moved.append(int((got_h >= 0).sum()))
        B, K, S = batch.bw.shape
        log(f"[kernels] decide_dest {name} (B {B}, K {K}, S {S}): equal to the plain version "
            f"and _score_numpy under {len(param_sets)} param sets; rows that move {moved}")

    sc = pk.kernel_scalars(base)
    for name in ("paper-table6 week", "fleet-compiled week"):
        tick = captured[name][0]
        ttensors = [torch.from_numpy(a).to(dev) for a in (*pk.pack_batch(tick), tick.bw)]
        tick_ms = time_ms(lambda: decide_dest_cuda(*ttensors, **sc))
        t_bound, t_by = decide_bound(*ttensors)
        log(f"[kernels] decide_dest at the {name} tick shape {tuple(tick.bw.shape)}: "
            f"{tick_ms * 1e3:.2f} us, bound {t_bound * 1e3:.4f} us ({t_by})")
    jobs, sites, bw = (torch.from_numpy(a).to(dev) for a in (*pk.pack_batch(upper), upper.bw))
    ms = time_ms(lambda: decide_dest_cuda(jobs, sites, bw, **sc))
    plain = time_ms(lambda: ref.decide_dest_ref(jobs, sites, bw, **sc))
    b_ms, b_by = decide_bound(jobs, sites, bw)
    log(f"[kernels] decide_dest at the upper fleet shape {tuple(bw.shape)}: {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def decide_bound(jobs, sites, bw):
    """K4's least time: its float64 inputs read once and its int64 output
    written once, or DECIDE_OPS float64 operations per element."""
    B, K, S = bw.shape
    nbytes = 8 * (jobs.numel() + sites.numel() + bw.numel() + B * K)
    return bound(nbytes, DECIDE_OPS * B * K * S, F64_FLOPS)


def run_fleet_paths(dev, cpu: dict) -> dict:
    """The three orchestration paths on ``dev``, each with the launch
    counters set to 0 just before it and read just after; outputs held
    against the CPU runs.  Returns each path's K4 launches."""
    launches = {}
    for name, fn in FLEET_PATHS:
        ops.reset_launch_counts()
        out = fn(dev)
        counts = ops.launch_counts()
        k4_only(name, counts)
        same_output(name, out, cpu[name])
        st = path_stats(out)
        extra = f"; fleet digits {check_fleet_digits(out)} as recorded" if name.startswith("fleet") else ""
        log(f"[fleet] {name}: {st['runs']} run(s), wall {st['wall_s']:.3f} s, {st['ticks']} ticks "
            f"({st['ticks_per_s']:.0f} ticks/s), decide_s {st['decide_s']:.4f}, decide_first_s "
            f"{st['decide_first_s']:.4f}, K4 launches {counts['decide_dest']}; equal to "
            f"device='cpu'{extra}")
        launches[name] = counts["decide_dest"]
    return launches


def run_cpu_paths() -> tuple:
    """The three paths with device='cpu' (the plain K4), recording the
    largest decide batch of each for the kernel checks."""
    cpu, captured = {}, {}
    for name, fn in FLEET_PATHS:
        t0 = time.perf_counter()
        with largest_batch(captured, name):
            cpu[name] = fn("cpu")
        st = path_stats(cpu[name])
        log(f"[fleet] {name} with device='cpu': {time.perf_counter() - t0:.1f} s, decide_s "
            f"{st['decide_s']:.4f} over {st['ticks']} ticks; largest decide batch "
            f"{captured[name][0].bw.shape}")
    return cpu, captured


def start_cpu_paths():
    """run_cpu_paths in a spawned process of its own, started before the
    build: its host-only weeks run beside nvcc and the kernel checks.
    Returns the future of (cpu, captured), and the pool to shut down."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool.submit(run_cpu_paths), pool


def check_spawn_pool(dev) -> None:
    """run_cells with two workers on the card spawns them (a forked child
    cannot use CUDA once the parent has): equal to the batched runner."""
    cells = SweepSpec(**{**SWEEP_BATCHED_SPEC, "seeds": (0, 1)}).cells()
    pool = run_cells(cells, workers=2, device=dev)
    if pool.deterministic_summaries() != run_cells_batched(cells, device=dev).deterministic_summaries():
        raise RuntimeError("run_cells(workers=2) on the card differs from run_cells_batched")
    log(f"[checks] run_cells with 2 spawned workers on the card equals run_cells_batched "
        f"({len(pool.runs)} runs)")


# ---------------------------------------------------------------------------
# Phases on the card
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return name


def phase_build() -> None:
    t0 = time.time()
    path = _build.build()
    _build.load()
    log(f"[build] {path.name} ready in {time.time() - t0:.1f} s")
    log_file = _build.log_path(path)
    if log_file.exists():
        lines = [ln.strip() for ln in log_file.read_text().splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln
                 or ln.startswith("built")]
        filt = shutil.which("c++filt")  # the kernels' names, demangled
        if filt:
            out = subprocess.run([filt], input="\n".join(lines), capture_output=True, text=True)
            if out.returncode == 0 and len(out.stdout.splitlines()) == len(lines):
                lines = out.stdout.splitlines()
        for line in lines:
            log(f"[build]   {line}")


def _check_flash_cases(dev, gen, cases, dtype, tol) -> float:
    worst = 0.0
    for b, s, t, nh, nkv, hd, mask, win, cap in cases:
        q = randn(gen, (b, s, nh, hd), dev).to(dtype)
        k = randn(gen, (b, t, nkv, hd), dev).to(dtype)
        v = randn(gen, (b, t, nkv, hd), dev).to(dtype)
        kw = dict(mask_kind=mask, window=win, attn_softcap=cap)
        got = flash_attention_cuda(q, k, v, **kw).float()
        want = ref.flash_attention_ref(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise RuntimeError(f"flash_attention {dtype} {(b, s, t, nh, nkv, hd, mask, win, cap)}: "
                               f"max abs err {err} beyond {tol}")
        worst = max(worst, err)
    log(f"[kernels] flash_attention {dtype}: {len(cases)} shapes within {tol} of the plain "
        f"version, max abs err {worst:.3e}")
    return worst


def check_flash(dev, gen):
    """K1 in float32 and bf16 against its plain version, then both timed at
    the slice's shape beside the plain version and SDPA on the same inputs.
    Bounds on the tensor-core route: float32 as 3 TF32 products."""
    worst = _check_flash_cases(dev, gen, FLASH_CASES, torch.float32, FLASH_TOL)
    worst_bf16 = _check_flash_cases(dev, gen, FLASH_BF16_CASES, torch.bfloat16, FLASH_BF16_TOL)

    b, s, nh, hd = BATCH, PROMPT, 6, 64
    pairs = b * nh * s * (s + 1) // 2  # causal (q, k) pairs this input needs
    out = {}
    for name, dtype, err, peak, split in (
            ("flash_attention", torch.float32, worst, TF32_FLOPS, TF32_SPLIT),
            ("flash_attention_bf16", torch.bfloat16, worst_bf16, BF16_FLOPS, 1)):
        q, k, v = (randn(gen, (b, s, nh, hd), dev).to(dtype) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: flash_attention_cuda(q, k, v))
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        b_ms, b_by = bound(4 * q.numel() * q.element_size(), split * 4 * hd * pairs, peak)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by)
    return out


def _check_bwd_cases(dev, gen, cases, dtype, tol) -> tuple:
    """The attention backward (with K1's lse) in ``dtype`` against its plain
    version in ``dtype`` on ``cases``, each gradient within ``tol`` of its
    largest element; float32 also holds K1's lse to the plain log-sum-exp.
    Returns (max abs err, largest share of the tolerance, max lse err)."""
    worst, worst_share, worst_lse = 0.0, 0.0, 0.0
    for b, s, t, nh, nkv, hd, mask, win, cap in cases:
        q, do = (randn(gen, (b, s, nh, hd), dev).to(dtype) for _ in range(2))
        k, v = (randn(gen, (b, t, nkv, hd), dev).to(dtype) for _ in range(2))
        kw = dict(mask_kind=mask, window=win, attn_softcap=cap)
        o, lse = flash_attention_lse_cuda(q, k, v, **kw)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
        torch.cuda.synchronize()
        shape = (b, s, t, nh, nkv, hd, mask, win, cap)
        if dtype == torch.float32:
            lse_err = float((lse - ref.flash_attention_lse_ref(q, k, **kw)).abs().max())
            if not lse_err <= LSE_TOL:
                raise RuntimeError(f"flash_attention lse {shape}: max abs err {lse_err} beyond {LSE_TOL}")
            worst_lse = max(worst_lse, lse_err)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.dtype != dtype:
                raise RuntimeError(f"flash_attention_bwd {name} {shape}: {g.dtype}, expected {dtype}")
            g, w = g.float(), w.float()
            err = float((g - w).abs().max())
            share = err / (tol * float(w.abs().max()))
            if not share <= 1.0:
                raise RuntimeError(f"flash_attention_bwd {dtype} {name} {shape}: max abs err {err}, "
                                   f"{100 * share:.1f}% of {tol} x max|{name}|")
            worst, worst_share = max(worst, err), max(worst_share, share)
    return worst, worst_share, worst_lse


def check_flash_bwd(dev, gen) -> dict:
    """The attention backward against its plain version, float32 on
    FLASH_BWD_CASES and bf16 on FLASH_BF16_CASES, then both timed at the
    training slice's shape beside the plain version's and SDPA's backward in
    the same type (each a forward plus backward, minus that forward) and
    the bound: float32 on operations at the 3xTF32 rate, bf16 the larger
    of its operations at the bf16 rate and its bytes."""
    worst, share, worst_lse = _check_bwd_cases(dev, gen, FLASH_BWD_CASES, torch.float32, GRAD_TOL)
    log(f"[kernels] flash_attention_bwd float32: {len(FLASH_BWD_CASES)} shapes, dQ / dK / dV within "
        f"{GRAD_TOL} x max|grad| of the plain version (max abs err {worst:.3e}, at most "
        f"{100 * share:.1f}% of the tolerance); K1's lse within {LSE_TOL} (max abs err "
        f"{worst_lse:.3e})")
    worst16, share16, _ = _check_bwd_cases(dev, gen, FLASH_BF16_CASES, torch.bfloat16, GRAD_BF16_TOL)
    log(f"[kernels] flash_attention_bwd bf16: {len(FLASH_BF16_CASES)} shapes, dQ / dK / dV within "
        f"{GRAD_BF16_TOL} x max|grad| of the bf16 plain version (max abs err {worst16:.3e}, at "
        f"most {100 * share16:.1f}% of the tolerance)")

    b, s, nh, hd = BATCH, PROMPT, 6, 64
    pairs = b * nh * s * (s + 1) // 2  # causal (q, k) pairs this input needs
    flops = BWD_FLOPS_PER_PAIR_HD * hd * pairs
    out = {}
    for name, dtype, err, peak, split in (
            ("flash_attention_bwd", torch.float32, worst, TF32_FLOPS, TF32_SPLIT),
            ("flash_attention_bwd_bf16", torch.bfloat16, worst16, BF16_FLOPS, 1)):
        q, k, v, do = (randn(gen, (b, s, nh, hd), dev).to(dtype) for _ in range(4))
        o, lse = flash_attention_lse_cuda(q, k, v)
        ms = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do))
        plain_fwd = time_ms(lambda: ref.flash_attention_ref(q, k, v))
        plain = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, do)) - plain_fwd
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        lib_fwd = time_ms(lambda: sdpa().detach())
        lib = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot)) - lib_fwd
        # q k v o do in, dq dk dv out, lse in
        nbytes = 8 * q.numel() * q.element_size() + 4 * lse.numel()
        b_ms, b_by = bound(nbytes, split * flops, peak)
        core = ""
        if dtype == torch.float32:
            core_ms, _ = bound(nbytes, flops, F32_FLOPS)
            core = f"; {core_ms:.4f} ms at the CUDA-core float32 rate ({100 * core_ms / ms:.1f}%)"
        log(f"[kernels] {name} at ({b}, {s}, {nh}, {hd}) causal: {ms:.4f} ms; plain {plain:.4f} ms, "
            f"SDPA backward {lib:.4f} ms (each its forward+backward minus its forward: "
            f"{plain_fwd:.4f} / {lib_fwd:.4f} ms); bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of it{core}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by)
    return out


def _ragged_inputs(gen, dev):
    xs = []
    for groups in RAGGED_GROUPS:
        x = randn(gen, (groups * 256,), dev, 3.0)
        if groups > 1:
            x[:256] = 0.0  # all-zero group: scale 1.0, codes 0
            # amax 127 gives scale 1.0 exactly, so x / scale lands on .5 ties
            ties = (torch.arange(256) % 254 - 127).float() + 0.5
            ties[0] = 127.0
            x[256:512] = ties.to(dev)
        xs.append(x)
    return xs


def check_quantize(dev, gen, leaves):
    flats = []
    for x in leaves:
        flat = x.reshape(-1).float()
        flats.append(torch.nn.functional.pad(flat, (0, (-flat.numel()) % 256)))
    cases = flats + _ragged_inputs(gen, dev)
    codes = []
    for x in cases:
        qk, sk = quantize_int8_cuda(x)
        qr, sr = ref.quantize_int8_ref(x)
        if not (torch.equal(qk, qr) and torch.equal(sk, sr)):
            raise RuntimeError(f"quantize_int8 differs from the plain version at n={x.numel()}: "
                               f"{int((qk != qr).sum())} codes, {int((sk != sr).sum())} scales")
        xk = dequantize_int8_cuda(qk, sk)
        if not torch.equal(xk, ref.dequantize_int8_ref(qk, sk)):
            raise RuntimeError(f"dequantize_int8 differs from the plain version at n={x.numel()}")
        codes.append((qk, sk))
    torch.cuda.synchronize()
    log(f"[kernels] quantize_int8 / dequantize_int8: bit-identical to the plain versions on "
        f"{len(flats)} micro-lm leaves and {len(RAGGED_GROUPS)} ragged group counts")

    n = sum(x.numel() for x in flats)  # one save / one restore: every leaf once
    slice_codes = codes[: len(flats)]
    q_ms = time_ms(lambda: [quantize_int8_cuda(x) for x in flats])
    q_plain = time_ms(lambda: [ref.quantize_int8_ref(x) for x in flats])
    d_ms = time_ms(lambda: [dequantize_int8_cuda(q, s) for q, s in slice_codes])
    d_plain = time_ms(lambda: [ref.dequantize_int8_ref(q, s) for q, s in slice_codes])
    d_lib = time_ms(lambda: [torch.mul(q.view(-1, 256), s.view(-1, 1)) for q, s in slice_codes])
    q_bound, q_by = bound(4 * n + n + 4 * (n // 256), n)  # one division per element
    d_bound, d_by = bound(n + 4 * (n // 256) + 4 * n, n)
    quant = dict(max_abs_err=0.0, ms=q_ms, plain_ms=q_plain, library_ms=None, bound_ms=q_bound,
                 bound_by=q_by)
    dequant = dict(max_abs_err=0.0, ms=d_ms, plain_ms=d_plain, library_ms=d_lib,
                   bound_ms=d_bound, bound_by=d_by)
    return quant, dequant


def check_slice(res: SliceResult, cfg, params, prompts, dev):
    """Outputs of the slice against the plain path on the CPU."""
    model = build_model(cfg)
    vocab = cfg.vocab_size
    for name, logits in (("site A", res.logits_a), ("site B", res.logits_b)):
        if logits.shape != (BATCH, PROMPT, vocab) or not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{name} prefill logits: shape {tuple(logits.shape)} or not finite")
    for name, toks in (("site A", res.tokens_a), ("site B", res.tokens_b)):
        if toks.shape != (BATCH, PROMPT + NEW) or not torch.equal(toks[:, :PROMPT], prompts):
            raise RuntimeError(f"{name} decode tokens: shape {tuple(toks.shape)} or prompt lost")
        if int(toks.min()) < 0 or int(toks.max()) >= vocab:
            raise RuntimeError(f"{name} decode produced out-of-vocab tokens")

    host = params_to_numpy(params)
    cpu_bytes = ser.to_bytes(ser.serialize_tree(host, mode="int8", device="cpu"))
    if res.manager.export_bytes() != cpu_bytes:
        raise RuntimeError("int8 checkpoint written on the card differs from the CPU plain path's")
    rep = res.report
    if rep.nbytes != res.nbytes or rep.workload_class != 0 or rep.feasible_in_window is not True:
        raise RuntimeError(f"migration report {rep} vs latest_bytes {res.nbytes}")
    restored_cpu, _ = res.manager.restore(host, device="cpu")
    for (path, a), (_, b) in zip(flatten_with_paths(res.params_b), flatten_with_paths(restored_cpu)):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError(f"restored leaf {'/'.join(path)} differs from the CPU plain dequantize")
    log(f"[checks] int8 checkpoint byte-identical to the CPU plain path ({len(cpu_bytes)} B); "
        f"restored params bit-identical to the CPU plain dequantize")

    # Small input at full width: the card against the CPU plain path, and
    # prefill against step-by-step decode on the card.
    small = prompts[:2, :64]
    sites = (("site A", params, params_from_numpy(host, "cpu")),
             ("site B", res.params_b, restored_cpu))
    for name, p, p_cpu in sites:
        card, _ = model.forward(p, {"tokens": small})
        plain, _ = model.forward(p_cpu, {"tokens": small.cpu()})
        err = float((card.cpu() - plain).abs().max())
        if not torch.allclose(card.cpu(), plain, atol=MODEL_TOL, rtol=MODEL_TOL):
            raise RuntimeError(f"{name} forward on the card vs the CPU plain path: {err}")
        cache = model.init_cache(small.shape[0], small.shape[1], device=dev)
        steps = []
        for i in range(small.shape[1]):
            lg, cache = model.decode_step(p, cache, {"token": small[:, i], "index": i})
            steps.append(lg)
        derr = float((torch.stack(steps, 1) - card).abs().max())
        if not torch.allclose(torch.stack(steps, 1), card, atol=DECODE_TOL, rtol=DECODE_TOL):
            raise RuntimeError(f"{name} prefill vs step-by-step decode on the card: {derr}")
        log(f"[checks] {name}: forward on the card vs CPU plain path max abs err {err:.3e} "
            f"(tol {MODEL_TOL}); prefill vs decode {derr:.3e} (tol {DECODE_TOL})")


def check_bf16_prefill(logits, cfg, params, prompts):
    """The bf16 prefill's logits against the same bf16 forward on the CPU
    plain path.  Also prints how far each of the two lies from the float32
    forward of the same bf16-rounded weights on the CPU (not a gate)."""
    if logits.shape != (BATCH, PROMPT, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"bf16 prefill logits: shape {tuple(logits.shape)} or not finite")
    host = tree_map(lambda x: x.cpu(), params)
    plain, _ = run_bf16_prefill(cfg, host, prompts.cpu(), device="cpu")
    card, plain = logits.float().cpu(), plain.float()
    diff = (card - plain).abs()
    err = float(diff.max())
    # the largest share of allclose's bound atol + rtol * |plain| that any logit uses
    share = float((diff / (MODEL_BF16_TOL * (1 + plain.abs()))).max())
    if not torch.allclose(card, plain, atol=MODEL_BF16_TOL, rtol=MODEL_BF16_TOL):
        raise RuntimeError(f"bf16 prefill on the card vs the CPU plain path: {err}")
    exact, _ = build_model(cfg).forward(tree_map(lambda x: x.to(torch.bfloat16).float(), host),
                                        {"tokens": prompts.cpu()})
    log(f"[checks] bf16 prefill logits vs the CPU plain path: max abs err {err:.3e}, at most "
        f"{100 * share:.1f}% of the bound (tol {MODEL_BF16_TOL} abs and rel); from the float32 "
        f"forward: card {float((card - exact).abs().max()):.3e}, plain "
        f"{float((plain - exact).abs().max()):.3e}")


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))


def _profiled(fn, *, host_ops: bool = True):
    """Run ``fn`` under torch.profiler; returns (its output, wall us, the
    device-side events with time: kernels and copies).  Without
    ``host_ops`` only the device is traced, which keeps a long host-bound
    run's trace small."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    return out, wall_us, events


def phase_profile_fleet(dev) -> None:
    """Device busy share of each orchestration path, from a profiled rerun
    (its launches are not counted): over the run's wall, and over the
    decide calls, the decide-heavy stretch of the run.  The paths are cut
    in depth (PROFILE_PATHS)."""
    for name, fn in PROFILE_PATHS:
        out, wall_us, events = _profiled(lambda: fn(dev))
        if not events:
            log(f"[profile] {name}: device time not measured (the profiler saw no device events)")
            continue
        busy = sum(_device_us(e) for e in events)
        st = path_stats(out)
        dec_us = (st["decide_s"] + st["decide_first_s"]) * 1e6
        log(f"[profile] {name} (profiled rerun): wall {wall_us / 1e6:.3f} s, decide "
            f"{dec_us / 1e6:.3f} s, device busy {busy / 1e3:.1f} ms = {100 * busy / wall_us:.2f}% "
            f"of wall, {100 * busy / dec_us:.2f}% of the decide calls")
        for e in sorted(events, key=_device_us, reverse=True)[:4]:
            log(f"[profile]   {_device_us(e):9.0f} us  x{e.count:<6d} {e.key[:90]}")


# The decide path's host stages, as cProfile names them: (file suffix, function).
DECIDE_STAGES = (
    ("orchestrator.py", "decide"), ("orchestrator.py", "_prep"),
    ("orchestrator.py", "_fault_bw"), ("orchestrator.py", "_commit"),
    ("policy_kernels.py", "rows_from_state"), ("policy_kernels.py", "build_batch"),
    ("policy_kernels.py", "score_batch"), ("policy_kernels.py", "pack_batch"),
    ("device.py", "resolve"), ("ops.py", "decide_dest"), ("decide.py", "decide_dest_cuda"),
    ("~", "<built-in method torch.from_numpy>"),
    ("~", "<method 'to' of 'torch._C.TensorBase' objects>"),
    ("~", "<method 'cpu' of 'torch._C.TensorBase' objects>"),
)


def phase_host_split(dev) -> None:
    """Where the host time of a decide tick goes on the card: a cProfile
    rerun of the two simulator weeks, cumulative time of each stage of the
    decide path.  cProfile slows Python code more than native code, so the
    shares, not the seconds, are what to read.  The fleet week is cut in
    depth (PROFILE_PATHS)."""
    import cProfile
    import pstats

    for name, fn in PROFILE_PATHS[:2]:
        prof = cProfile.Profile()
        prof.enable()
        fn(dev)
        prof.disable()
        stats = pstats.Stats(prof).stats
        got = {}
        for (path, _line, func), (_cc, ncalls, _tt, cum, _callers) in stats.items():
            for suffix, want in DECIDE_STAGES:
                if path.endswith(suffix) and func.startswith(want):
                    n0, c0 = got.get(want, (0, 0.0))
                    got[want] = (n0 + ncalls, c0 + cum)
        total = got.get("decide", (0, 0.0))[1]
        log(f"[profile] {name} host split of the decide calls (cProfile rerun): decide "
            f"{total:.3f} s")
        for _, want in DECIDE_STAGES[1:]:
            n, cum = got.get(want, (0, 0.0))
            log(f"[profile]   {cum:8.3f} s {100 * cum / max(total, 1e-12):5.1f}%  x{n:<6d} {want}")


def phase_profile(cfg, params, prompts, dev) -> None:
    """Device busy share and top kernels for one prefill and for 16 decode
    steps, from torch.profiler (CUPTI).  Runs after the slice: its launches
    are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = build_model(cfg)
    cache = model.init_cache(prompts.shape[0], prompts.shape[1] + NEW, device=dev)

    def prefill():
        model.forward(params, {"tokens": prompts})

    def decode():
        for i in range(16):
            model.decode_step(params, cache, {"token": prompts[:, i], "index": i})

    for name, fn in (("prefill", prefill), ("decode x16", decode)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: a CPU op's own entry repeats its kernels' time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
        busy_us = sum(_device_us(e) for e in kernels)
        if not kernels:
            log(f"[profile] {name}: device time not measured (the profiler saw no device events)")
            continue
        log(f"[profile] {name}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
            f"({100 * busy_us / wall_us:.1f}%), idle {100 * (1 - busy_us / wall_us):.1f}%")
        for e in sorted(kernels, key=_device_us, reverse=True)[:6]:
            log(f"[profile]   {_device_us(e):9.0f} us  x{e.count:<5d} {e.key[:90]}")


def check_card_vs_cpu(cfg, params, dev, *, seq=TRAIN_SEQ, steps=2, tag="[train]",
                      profile=False) -> None:
    """``steps`` train steps of ``cfg`` on CARD_CPU_BATCH x ``seq`` tokens
    from the same params on the card and through device="cpu", on the same
    batches: losses, grad norms and the first step's gradients; the card's
    launches as derived (with ``profile``, its steps' busy share)."""
    data = SyntheticLMDataset(cfg.vocab_size, seq, CARD_CPU_BATCH)
    batches = [data.batch(i) for i in range(steps)]
    t0 = time.perf_counter()
    if steps == 1:
        # the step's loss, gradients and grad norm without its AdamW update,
        # which the CPU side of one step does not need
        (loss, _), g_cpu = value_and_grad(
            build_model(cfg), tree_map(lambda x: x.detach().cpu(), params),
            {k: torch.from_numpy(v) for k, v in batches[0].items()}, "full")
        m_cpu = [{"loss": float(loss), "grad_norm": float(global_norm(g_cpu))}]
    else:
        g_cpu, m_cpu, _, _ = run_train_steps(cfg, params, batches, device="cpu")
    cpu_s = time.perf_counter() - t0
    g_card, m_card, counts, prof = run_train_steps(cfg, params, batches, device=dev,
                                                   profile=profile)
    expect = {k: v * len(batches) for k, v in step_launches(cfg, "full").items()}
    if counts != expect:
        raise RuntimeError(f"train steps: launch counts {counts}, expected {expect}")
    parts = []
    for i, (mc, mk) in enumerate(zip(m_cpu, m_card)):
        for key, tol in (("loss", CARD_CPU_LOSS_TOL[i]), ("grad_norm", CARD_CPU_GNORM_TOL[i])):
            rel = abs(mk[key] - mc[key]) / abs(mc[key])
            if not rel <= tol:
                raise RuntimeError(f"step {i + 1} {key} on the card {mk[key]} vs the CPU {mc[key]}: "
                                   f"relative {rel:.3e} beyond {tol}")
            parts.append(f"step {i + 1} {key} {mk[key]:.6f} (rel {rel:.2e} of {tol})")
    cpu_of = dict(flatten_with_paths(g_cpu))
    worst = 0.0
    for path, g in flatten_with_paths(g_card):
        want = cpu_of[path]
        share = float((g.cpu() - want).abs().max()) / (CARD_CPU_GRAD_TOL * grad_scale(path, cpu_of))
        if not share <= 1.0:
            raise RuntimeError(f"first-step gradient {'/'.join(path)} on the card vs the CPU: "
                               f"{100 * share:.1f}% of {CARD_CPU_GRAD_TOL} x its max")
        worst = max(worst, share)
    log(f"{tag} {cfg.name} card vs device='cpu', {CARD_CPU_BATCH} x {seq} tokens, {steps} step(s) "
        f"(CPU {cpu_s:.1f} s): {'; '.join(parts)}; first-step gradients within {CARD_CPU_GRAD_TOL} "
        f"x each leaf's max, at most {100 * worst:.2f}% of it; launches {counts}, as derived")
    if prof is not None:
        log_step_profile(f"{cfg.name}, {steps} train step(s) on {CARD_CPU_BATCH} x {seq} tokens",
                         *prof)


def grad_scale(path: tuple, grads_of: dict) -> float:
    """The size a gradient leaf is held against: its largest element, but
    an sLSTM block's input-gate bias's against its input-gate weights':
    the bias on every ĩ_t cancels in c_t / n_t except through n_0 = 1e-6,
    so its gradient (~1e-13) is what is left of summing terms of the
    weights' gradient's size, and rounds relative to them
    (tests/test_torch_xlstm.py)."""
    top = float(grads_of[path].abs().max())
    if path[-2:] == ("slstm", "bi"):
        top = max(top, float(grads_of[path[:-1] + ("wi",)].abs().max()))
    return top


def check_bf16_train(cfg, params, dev) -> dict:
    """One step of micro-lm in bf16 (the type every other assigned
    architecture trains in: K1 and its backward in bf16), its weights cast
    to bf16, on the card against the same step through device="cpu"
    (check_bf16_step).  Returns its launches."""
    cfg16 = replace(cfg, dtype="bfloat16")
    p16 = tree_map(lambda x: x.to(torch.bfloat16), params)
    batch = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, CARD_CPU_BATCH).batch(0)
    return check_bf16_step(cfg16, p16, dev, batch, "[train] micro-lm in bf16")


def check_bf16_step(cfg, params, dev, batch, what: str, *, moe_routes=None) -> dict:
    """One train step of the bf16 model ``cfg`` from ``params`` on the card
    against the same step's loss, gradients and grad norm through
    device="cpu", each gradient leaf in its own type (a MoE router's
    float32); the step's launches exactly as derived.  With ``moe_routes``
    (a list), the card's step records its MoE layer's expert choice there
    and the CPU side routes every token as the card did (expert_choice).
    Returns the launches."""
    card = bf16_card_step(cfg, params, dev, batch, what, moe_routes=moe_routes)
    bf16_cpu_check(cfg, tree_map(lambda x: x.cpu(), params), batch, what, *card)
    return card[2]


def bf16_card_step(cfg, params, dev, batch, what: str, *, moe_routes=None):
    """The card half of check_bf16_step: (the gradients on the host, the
    step's metrics, its launches (held as derived), the forced expert
    choice or None, each param leaf's dtype)."""
    rec = [] if moe_routes is None else moe_routes
    with expert_choice(rec) if moe_routes is not None else contextlib.nullcontext():
        g_card, (m_card,), counts, _ = run_train_steps(cfg, params, [batch], device=dev)
    force = None
    if moe_routes is not None:
        force = rec[0]
        if any(not torch.equal(r, force) for r in rec):
            raise RuntimeError(f"{what}: the card's step chose other experts in another MoE call "
                               "(one MoE layer expected)")
    expect = step_launches(cfg, "full")
    if counts != expect:
        raise RuntimeError(f"{what} train step: launch counts {counts}, expected {expect}")
    dtypes = {path: x.dtype for path, x in flatten_with_paths(params)}
    return tree_map(lambda x: x.cpu(), g_card), m_card, counts, force, dtypes


def bf16_cpu_check(cfg, host_params, batch, what: str, g_card, m_card, counts, force,
                   dtypes) -> None:
    """The CPU half of check_bf16_step, from the card half's results and
    the params on the host."""
    t0 = time.perf_counter()
    # the CPU side: the step's loss, gradients and grad norm, without its
    # AdamW update (at full width the CPU's bf16 update costs seconds)
    with expert_choice([], force=force) if force is not None else contextlib.nullcontext():
        (loss, _), g_cpu = value_and_grad(build_model(cfg), host_params,
                                          {k: torch.from_numpy(v) for k, v in batch.items()}, "full")
    m_cpu = {"loss": float(loss), "grad_norm": float(global_norm(g_cpu))}
    cpu_s = time.perf_counter() - t0
    parts = []
    for key in ("loss", "grad_norm"):
        rel = abs(m_card[key] - m_cpu[key]) / abs(m_cpu[key])
        if not rel <= CARD_CPU_BF16_TOL:
            raise RuntimeError(f"{what} step {key} on the card {m_card[key]} vs the CPU "
                               f"{m_cpu[key]}: relative {rel:.3e} beyond {CARD_CPU_BF16_TOL}")
        parts.append(f"{key} {m_card[key]:.6f} (rel {rel:.2e})")
    cpu_of = dict(flatten_with_paths(g_cpu))
    worst, worst_path = 0.0, ""
    for path, g in flatten_with_paths(g_card):
        want = cpu_of[path].float()
        if g.dtype != dtypes[path] or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{what} gradient {'/'.join(path)}: {g.dtype} or not finite")
        share = leaf_share(g, want, CARD_CPU_BF16_TOL)
        if not share <= 1.0:
            raise RuntimeError(f"{what} first-step gradient {'/'.join(path)} on the card vs the CPU: "
                               f"{100 * share:.1f}% of {CARD_CPU_BF16_TOL} x its max")
        if share > worst:
            worst, worst_path = share, "/".join(path)
    b, s = batch["labels"].shape
    routed = "; the CPU side routed as the card" if force is not None else ""
    log(f"{what}, card vs device='cpu', one step on {b} x {s} tokens (CPU {cpu_s:.1f} s{routed}): "
        f"{'; '.join(parts)}; first-step gradients within {CARD_CPU_BF16_TOL} x each leaf's max, "
        f"at most {100 * worst:.1f}% of it ({worst_path}); launches {counts}, as derived")


class CpuSides:
    """The CPU sides of card-vs-CPU checks, run one after another in a
    thread while the card goes on with the next work; ``finish`` waits for
    them and raises the first failure.  Only checks that touch no patched
    global (no MoE routing: expert_choice patches moe.topk_stable) are
    sent here."""

    def __init__(self):
        import concurrent.futures

        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.pending = []

    def submit(self, fn) -> None:
        self.pending.append(self.pool.submit(fn))

    def finish(self) -> None:
        pending, self.pending = self.pending, []
        for fut in pending:
            fut.result()


CPU_SIDES = CpuSides()


def leaf_share(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """``got``'s max abs difference from ``want`` as a share of ``tol`` x
    the largest |element| of ``want``; a leaf the loss does not reach
    (``want`` all 0: an embedding table under embeddings inputs) must be
    all 0 too, and then has share 0."""
    err = float((got.float().cpu() - want.float()).abs().max())
    top = float(want.abs().max())
    if top == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / (tol * top)


def check_train_lifecycle(res: TrainResult, tag: str = "[train]") -> dict:
    """The lifecycle's launch counts, falling loss, restored state and (full
    mode) final params against the unmigrated run.  Returns the summed
    launches of its runs."""
    total = {}
    for name, (got, want) in res.launches.items():
        if got != want:
            raise RuntimeError(f"{res.mode}: launch counts of {name} {got}, expected {want}")
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    losses = [row["loss"] for row in res.history]
    if len(losses) != res.steps or not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{res.mode}: losses {losses} do not fall")
    a_of = dict(flatten_with_paths(res.state_a))
    if res.mode == "full":
        for path, x in flatten_with_paths(res.state_b0):
            if not torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(a_of[path]).cpu()):
                raise RuntimeError(f"restored leaf {'/'.join(path)} differs from site A's state")
        restored = "equal to site A's state"
    else:
        plain = ser.deserialize_tree(ser.from_bytes(res.raw_b), res.state_a, device="cpu")
        gap = 0.0
        for (path, x), (_, y) in zip(flatten_with_paths(res.state_b0), flatten_with_paths(plain)):
            if not torch.equal(torch.as_tensor(x).cpu(), y):
                raise RuntimeError(f"restored leaf {'/'.join(path)} differs from the CPU plain "
                                   f"dequantize of the same bytes")
            if y.is_floating_point():
                gap = max(gap, float((y - torch.as_tensor(a_of[path]).cpu()).abs().max()))
        restored = (f"bit-identical to the CPU plain dequantize of the same bytes, max abs "
                    f"{gap:.3e} from site A's state")
    migrated = ""
    if res.params_ref is not None:
        ref_of = dict(flatten_with_paths(res.params_ref))
        diff = max(float((x - ref_of[path]).abs().max()) for path, x in flatten_with_paths(res.params_b))
        if res.mode == "full" and not diff <= MIGRATION_TOL:
            raise RuntimeError(f"migrated final params differ from the unmigrated run's by {diff}")
        migrated = f"; final params vs the unmigrated run: max abs diff {diff:.3e} (tol {MIGRATION_TOL})"
    v = res.verdict
    what = f"{res.mode}{' + grad_compress' if res.grad_compress else ''}"
    log(f"{tag} {what}: site A {res.preempt} steps {res.run_a_s:.2f} s, preempted; checkpoint "
        f"{res.nbytes} B saved in {res.save_s:.3f} s; gate: class {int(v.workload_class)}, "
        f"t_transfer {float(v.t_transfer_s):.4f} s, t_cost {float(v.t_cost_s):.4f} s, feasible "
        f"{bool(v.feasible)}; migrate {res.migrate_s:.3f} s; restore {res.restore_s:.3f} s, "
        f"{restored}; site B {res.steps - res.preempt} steps {res.run_b_s:.2f} s; loss "
        f"{losses[0]:.4f} -> {losses[res.preempt - 1]:.4f} -> {losses[-1]:.4f}{migrated}")
    for name, (got, _) in res.launches.items():
        log(f"{tag}   {what} {name}: launches {got}, as derived")
    return total


def run_train_launcher(cfg, workdir) -> dict:
    """launch.train.main on its default device, counted: its defaults are
    remat "full", full checkpoints and no gradient compression."""
    steps = 4
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_launcher.main(["--arch", "micro-lm", "--steps", str(steps), "--batch",
                              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", workdir])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(flash_attention=2 * cfg.num_layers * steps,
                  flash_attention_bwd=cfg.num_layers * steps)
    if rc != 0 or counts != expect:
        raise RuntimeError(f"launch.train: rc {rc}, launch counts {counts}, expected {expect}")
    log(f"[train] launch.train.main --steps {steps} on the default device: "
        f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    return counts


@contextlib.contextmanager
def step_grads():
    """The gradients every train step inside hands to AdamW
    (``train_step.apply_updates``), in a list."""
    from repro_torch.train import train_step as ts

    seen, real = [], ts.apply_updates

    def capture(params, grads, *args, **kw):
        seen.append(grads)
        return real(params, grads, *args, **kw)

    ts.apply_updates = capture
    try:
        yield seen
    finally:
        ts.apply_updates = real


def check_remat_and_microbatch(cfg, params, dev) -> dict:
    """The training paths beside remat "full" and one batch, at the slice's
    shape on the card, each counted: remat "none" and "dots", one step's
    loss and every gradient against "full"'s (bit-identical, or each leaf
    within REMAT_TOL of its max); a step of two micro-batches against the
    one-batch step (loss CARD_CPU_LOSS_TOL[0] relative, the gradients
    AdamW takes CARD_CPU_GRAD_TOL of each leaf's max).  Returns their
    launches, summed."""
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).batch(0).items()}
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    runs = {}
    for policy in ("full", "none", "dots"):
        ((loss, _), grads), counts, wall = counted(
            lambda: value_and_grad(model, params, batch, policy))
        if counts != step_launches(cfg, policy):
            raise RuntimeError(f"remat {policy!r}: launch counts {counts}, expected "
                               f"{step_launches(cfg, policy)}")
        runs[policy] = (float(loss), dict(flatten_with_paths(grads)), wall, counts)
        if policy != "full":
            add(counts)
    loss0, g0, _, _ = runs["full"]
    parts = []
    for policy in ("none", "dots"):
        loss, grads, wall, counts = runs[policy]
        same = loss == loss0 and all(torch.equal(grads[p], g) for p, g in g0.items())
        if not same:
            worst = max(float((grads[p] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                        for p, g in g0.items())
            if not (abs(loss - loss0) <= REMAT_TOL * abs(loss0) and worst <= REMAT_TOL):
                raise RuntimeError(f"remat {policy!r}: loss {loss} vs {loss0}, gradients up to "
                                   f"{worst:.3e} of their max, beyond {REMAT_TOL}")
        parts.append(f"{policy!r} ({wall:.2f} s, launches {counts}) "
                     + ("bit-identical" if same else f"within {REMAT_TOL} of each leaf's max"))
    log(f"[train] remat on {TRAIN_BATCH} x {TRAIN_SEQ} tokens, one step's loss and all "
        f"{len(g0)} gradients against 'full' ({runs['full'][2]:.2f} s): " + "; ".join(parts))

    step_cfg = dict(opt=AdamWConfig(lr=TRAIN_LR), total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP)
    out = {}
    for micro in (0, MICRO_BATCHES):
        step = make_train_step(model, TrainStepConfig(microbatch=micro, **step_cfg))
        with step_grads() as grads:
            (_, _, m), counts, wall = counted(lambda: step(params, init_opt_state(params), batch))
        expect = {k: v * max(micro, 1) for k, v in step_launches(cfg, "full").items()}
        if counts != expect:
            raise RuntimeError(f"{micro} micro-batches: launch counts {counts}, expected {expect}")
        out[micro] = (float(m["loss"]), dict(flatten_with_paths(grads[0])), wall, counts)
    add(out[MICRO_BATCHES][3])
    (l1, g1, w1, _), (l2, g2, w2, c2) = out[0], out[MICRO_BATCHES]
    rel = abs(l2 - l1) / abs(l1)
    worst = max(float((g2[p] - g).abs().max()) / (CARD_CPU_GRAD_TOL * grad_scale(p, g1))
                for p, g in g1.items())
    if not (rel <= CARD_CPU_LOSS_TOL[0] and worst <= 1.0):
        raise RuntimeError(f"{MICRO_BATCHES} micro-batches vs one batch: loss rel {rel:.3e}, "
                           f"gradients up to {100 * worst:.1f}% of {CARD_CPU_GRAD_TOL} x max")
    log(f"[train] a step of {MICRO_BATCHES} micro-batches of {TRAIN_BATCH // MICRO_BATCHES} x "
        f"{TRAIN_SEQ} ({w2:.2f} s) against one batch of {TRAIN_BATCH} ({w1:.2f} s): loss {l2:.6f} "
        f"vs {l1:.6f} (rel {rel:.2e} of {CARD_CPU_LOSS_TOL[0]}); the gradients AdamW took each "
        f"within {CARD_CPU_GRAD_TOL} x its leaf's max, at most {100 * worst:.2f}% of it; "
        f"launches {c2}, as derived")
    return total


def run_delta_lifecycle(cfg, work, dev) -> dict:
    """A delta-int8 training lifecycle through Trainer on the card: train
    to DELTA_STEPS // 2, a full save, train on to DELTA_STEPS (the budget's
    save, delta-int8 against the full one), migrate_job, and the site's
    restore with an explicit base= (the full save's state: after a second
    save a manager's own base is the newest state), counted; its leaves
    bit-identical to a restore of the same bytes with device="cpu".
    Returns the launches."""
    half = DELTA_STEPS // 2
    tr = make_trainer(cfg, os.path.join(work, "siteA"), steps=DELTA_STEPS,
                      save_every=DELTA_STEPS + 1, mode="delta-int8", grad_compress=False,
                      batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev)
    launches = {}

    def segment(name, fn, expect):
        out, got, wall = counted(fn)
        if got != expect():
            raise RuntimeError(f"[train] delta-int8 {name}: launch counts {got}, expected "
                               f"{expect()}")
        launches[name] = got
        return out, wall

    segment("steps 1-%d" % half, lambda: tr.run(max_steps=half),
            lambda: train_launches(cfg, tr, steps=half))
    full, full_s = segment("full save", lambda: tr.ckpt.save(half, tr.state_tree(), mode="full"),
                           lambda: dict.fromkeys(ops.launch_counts(), 0))
    status, run_s = segment(f"steps {half + 1}-{DELTA_STEPS} and the delta save",
                            lambda: tr.run(max_steps=half),
                            lambda: train_launches(cfg, tr, steps=half, saves=1))
    delta = tr.ckpt.latest
    if status["step"] != DELTA_STEPS or full.mode != "full" or delta.mode != "delta-int8":
        raise RuntimeError(f"[train] delta-int8 lifecycle: {status}, saves {full.mode}, "
                           f"{delta.mode}")
    dst, _ = migrate_job(tr.ckpt, os.path.join(work, "siteB"), bandwidth_bps=BANDWIDTH_BPS,
                         window_s=WINDOW_S)
    like = tr.state_tree()
    base, _ = tr.ckpt.restore(like, step=half, device="cpu")
    base = params_to_numpy(base)
    (got, _), restore_s = segment("restore", lambda: dst.restore(like, base=base, device=dev),
                                  lambda: train_launches(cfg, tr, steps=0, restores=1))
    want, _ = dst.restore(like, base=base, device="cpu")
    n = same_leaves("[train] delta-int8 restore on the card vs device='cpu'", got, want)
    log(f"[train] delta-int8 lifecycle: {half} steps, full save {full.nbytes} B "
        f"({full_s:.3f} s), {half} more steps ({run_s:.2f} s) and the delta-int8 save "
        f"{delta.nbytes} B, migrate_job, restore with base= the full save's state "
        f"({restore_s:.3f} s): all {n} leaves bit-identical to device='cpu''s restore of the "
        f"same bytes")
    for name, got in launches.items():
        log(f"[train]   delta-int8 {name}: launches {got}, as derived")
    total = {}
    for got in launches.values():
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    return total


# device op name fragments -> the training step's parts
STEP_PARTS = (("K1 forward", ("flash_fwd",)), ("K1 backward", ("flash_bwd",)),
              ("GEMMs", ("gemm", "cutlass", "xmma", "cublas")), ("copies", ("Memcpy", "Memset")))


def log_step_profile(what: str, wall_us: float, events) -> None:
    """Busy share and split of profiled train steps (``what`` names them)."""
    if not events:
        log(f"[profile] {what}: device time not measured (the profiler saw no device events)")
        return
    busy = sum(_device_us(e) for e in events)
    split = dict.fromkeys([name for name, _ in STEP_PARTS] + ["other"], 0.0)
    for e in events:
        part = next((name for name, keys in STEP_PARTS if any(k in e.key for k in keys)), "other")
        split[part] += _device_us(e)
    log(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), idle {100 * (1 - busy / wall_us):.1f}%; "
        + ", ".join(f"{name} {us / 1e3:.2f} ms ({100 * us / busy:.1f}%)" for name, us in split.items()))
    for e in sorted(events, key=_device_us, reverse=True)[:8]:
        log(f"[profile]   {_device_us(e):9.0f} us  x{e.count:<5d} {e.key[:90]}")


def phase_train_profile(cfg, params, dev) -> None:
    """The warm training step at the slice's shape: device time per step
    (CUDA events around each step, median of 5), tokens/s, AdamW's time
    alone, and torch.profiler's busy share and split of two steps."""
    model = build_model(cfg)
    step = make_train_step(model, TrainStepConfig(opt=AdamWConfig(lr=TRAIN_LR),
                                                  total_steps=TRAIN_STEPS,
                                                  warmup_steps=TRAIN_WARMUP))
    data = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    p = tree_map(lambda x: x.detach().clone(), params)
    opt = init_opt_state(p)
    for _ in range(2):
        p, opt, _ = step(p, opt, batch)
    torch.cuda.synchronize()
    times, walls = [], []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        p, opt, _ = step(p, opt, batch)
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    _, grads = value_and_grad(model, p, batch, "full")
    adamw_ms = time_ms(lambda: apply_updates(p, grads, opt, AdamWConfig(lr=TRAIN_LR), 1.0))
    log(f"[train] warm step, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat full: {step_ms:.2f} ms "
        f"(CUDA events, median of 5; host wall {statistics.median(walls):.2f} ms), "
        f"{TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3):.0f} tokens/s; AdamW alone {adamw_ms:.3f} ms")
    _, wall_us, events = _profiled(lambda: [step(p, opt, batch) for _ in range(2)])
    log_step_profile("2 train steps", wall_us, events)


def phase_train(cfg, params, dev) -> dict:
    """The training slice on the card.  Returns the launches of its counted
    runs, summed."""
    check_card_vs_cpu(cfg, params, dev)
    total = check_bf16_train(cfg, params, dev)
    for k, n in check_remat_and_microbatch(cfg, params, dev).items():
        total[k] = total.get(k, 0) + n
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        counts = run_delta_lifecycle(cfg, os.path.join(work, "delta"), dev)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        for mode, gc, reference, save_every in (("full", False, True, TRAIN_SAVE_EVERY),
                                                ("int8", True, False, TRAIN_INT8_SAVE_EVERY)):
            d = os.path.join(work, mode)
            res = run_train_lifecycle(cfg, d, mode=mode, grad_compress=gc, device=dev,
                                      reference=reference, save_every=save_every)
            counts = check_train_lifecycle(res)
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            del res
            shutil.rmtree(d)
        counts = run_train_launcher(cfg, os.path.join(work, "launcher"))
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    phase_train_profile(cfg, params, dev)
    return total


# ---------------------------------------------------------------------------
# The serving plane, the host entry points and the examples
# ---------------------------------------------------------------------------


def counted(fn):
    """``fn()`` with the launch counters set to 0 just before it and read
    just after: (its output, the counts, wall seconds)."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts(), time.perf_counter() - t0


def printed(main, argv):
    """An entry point's ``main(argv)`` with its standard output captured:
    (its return value, the text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def log_lines(tag: str, text: str) -> None:
    for line in text.rstrip("\n").splitlines():
        log(f"{tag} | {line}")


def check_feasibility_grids(dev) -> None:
    """The float32 feasibility grids (torch, no kernel of their own) on the
    card against device="cpu": the Fig. 2 phase diagram of
    benchmarks/fig2_phase.py, the size bands, the utility model and the
    feasible destinations, each exactly equal."""
    sizes, bws = np.logspace(0, 3, 25), np.logspace(-1, 2, 13)
    rng = np.random.default_rng(0)
    s_bytes = np.concatenate([[10e9, 100e9], rng.uniform(0, 300e9, 62)])
    ren, load = rng.uniform(0, 1, 64), rng.uniform(0, 1, 64)
    bw, win = rng.choice([0.0, 1e9, 2.5e9, 10e9], 64), rng.uniform(0, 6 * 3600, 64)

    def arrays(device) -> dict:
        out = {f"phase_diagram {k}": v
               for k, v in feasibility.phase_diagram(sizes, bws, device=device).items()}
        out["classify_by_size"] = feasibility.classify_by_size(s_bytes, device=device).cpu().numpy()
        out["site_utility"] = feasibility.site_utility(ren, load, device=device).cpu().numpy()
        out["feasible_destinations"] = feasibility.feasible_destinations(33e9, bw, win,
                                                                         device=device)
        return out

    card, cpu = arrays(dev), arrays("cpu")
    for name, want in cpu.items():
        if card[name].dtype != want.dtype or not np.array_equal(card[name], want):
            raise RuntimeError(f"{name} on the card differs from device='cpu'")
    log(f"[serving] float32 feasibility grids on the card equal device='cpu': {', '.join(cpu)}")


def phase_serving(dev) -> int:
    """The serving plane's default chunked engine and the host entry
    points on the card (train-plus-serve is held in phase_examples, where
    green_cluster_sim runs it).  Returns their K4 launches."""
    check_feasibility_grids(dev)
    t0 = time.perf_counter()
    sim = ClusterSimulator.from_scenario("inference-heavy", "static", device=dev)
    build_s = time.perf_counter() - t0
    if type(sim.serving) is not ChunkedServingPlane:
        raise RuntimeError(f"the serving week runs {type(sim.serving).__name__}, not the chunked plane")
    r, counts, _ = counted(sim.run)
    if any(counts.values()):
        raise RuntimeError(f"serving week: launch counts {counts}, expected none (host code)")
    digits = check_bench_row(r, ("serving_fastpath",), SERVING_DIGITS)
    log(f"[serving] inference-heavy week, static, chunked engine: {r.requests_arrived} requests, "
        f"wall {r.wall_time_s:.3f} s (set-up {build_s:.3f} s), {r.requests_arrived / r.wall_time_s:.0f} "
        f"requests/s, {r.ticks} ticks; no launch (host code); arrived / served / dropped / SLO "
        f"violations / p95 s / request gCO2 {digits} as recorded in BENCH_quick.json")

    (rc, text), counts, wall = counted(lambda: printed(serve_launcher.main, ["--green-route", "64"]))
    if rc != 0 or "served=64/64" not in text or any(counts.values()):
        raise RuntimeError(f"launch.serve --green-route 64: rc {rc}, launches {counts}:\n{text}")
    log(f"[serving] launch.serve.main --green-route 64 on the default device: {wall:.3f} s, no "
        f"launch (static policy), served 64/64")
    log_lines("[serving]", text)

    (rc, text), counts, wall = counted(lambda: printed(dryrun_launcher.main, ["--plan"]))
    _, cpu_text = printed(dryrun_launcher.main, ["--plan", "--device", "cpu"])
    if rc != 0 or text != cpu_text or counts != exactly(counts, decide_dest=1):
        raise RuntimeError(f"launch.dryrun --plan: rc {rc}, launches {counts} (expected one K4), "
                           f"output on the card\n{text}\nwith --device cpu\n{cpu_text}")
    log(f"[serving] launch.dryrun.main --plan on the default device: {wall:.3f} s, K4 launches 1; "
        f"output equal to --device cpu")
    log_lines("[serving]", text)
    return 1


def phase_launchers(dev) -> dict:
    """The launchers at full width on their default device, each drawing
    the weights there (a generator on the card, seeded by --seed /
    TrainerConfig.seed), counted: launch.serve --arch LAUNCH_SERVE_ARCH
    (its prompt goes through decode_step one token at a time, as in the
    JAX launcher: K1 bf16 = attention layers x prefills = 0), with the
    draw's seconds, the peak allocated memory and its tokens/s; launch.train
    --arch LAUNCH_TRAIN_ARCH for LAUNCH_TRAIN_STEPS steps (K1 bf16 and its
    backward as step_launches derives, and its full save at the end of its
    budget).  Run after [archs2] has freed its models.  Returns the
    launches."""
    from repro_torch.models.model import Model

    draws, real = [], Model.init

    def timed_init(self, *args, **kw):
        t0 = time.perf_counter()
        out = real(self, *args, **kw)
        torch.cuda.synchronize()
        draws.append((time.perf_counter() - t0, kw.get("generator")))
        return out

    total = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b, prompt, new = LAUNCH_SERVE_SHAPE
    Model.init = timed_init
    try:
        (rc, text), counts, wall = counted(lambda: printed(serve_launcher.main, [
            "--arch", LAUNCH_SERVE_ARCH, "--batch", str(b), "--prompt-len", str(prompt),
            "--tokens", str(new)]))
    finally:
        Model.init = real
    cfg = get_config(LAUNCH_SERVE_ARCH)
    (draw_s, gen), = draws
    if rc != 0 or counts != exactly(counts) or gen is None or gen.device.type != "cuda":
        raise RuntimeError(f"launch.serve --arch {LAUNCH_SERVE_ARCH}: rc {rc}, launches {counts} "
                           f"(expected none: attention layers {attn_layers(cfg)} x 0 prefills), "
                           f"generator {gen}:\n{text}")
    peak = torch.cuda.max_memory_allocated() - base
    rate = next((ln for ln in text.splitlines() if "tok/s" in ln), "")
    log(f"[serving] launch.serve.main --arch {LAUNCH_SERVE_ARCH} at full width on the default "
        f"device: {param_count(cfg)} params drawn on the card in {draw_s:.2f} s (generator on "
        f"{gen.device}), peak allocated {gib(peak)}; {b} x {prompt} prompt + {new} new tokens, "
        f"{wall:.2f} s in all; launches none (K1 bf16 = {attn_layers(cfg)} attention layers x 0 "
        f"prefills: the prompt runs through decode_step)")
    log_lines("[serving]", text)
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated() - base > ARCH2_LEAK_BYTES:
        raise RuntimeError(f"launch.serve --arch {LAUNCH_SERVE_ARCH} left memory allocated")

    cfg = get_config(LAUNCH_TRAIN_ARCH)
    draws.clear()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as work:
        Model.init = timed_init
        try:
            (rc, text), counts, wall = counted(lambda: printed(train_launcher.main, [
                "--arch", LAUNCH_TRAIN_ARCH, "--steps", str(LAUNCH_TRAIN_STEPS), "--batch",
                str(LAUNCH_TRAIN_SHAPE[0]), "--seq", str(LAUNCH_TRAIN_SHAPE[1]), "--ckpt-dir",
                work]))
        finally:
            Model.init = real
    expect = {k: v * LAUNCH_TRAIN_STEPS for k, v in step_launches(cfg, "full").items()}
    (draw_s, gen), = draws
    if rc != 0 or counts != expect or gen is None or gen.device.type != "cuda":
        raise RuntimeError(f"launch.train --arch {LAUNCH_TRAIN_ARCH}: rc {rc}, launches {counts}, "
                           f"expected {expect}, generator {gen}:\n{text}")
    log(f"[serving] launch.train.main --arch {LAUNCH_TRAIN_ARCH} --steps {LAUNCH_TRAIN_STEPS} at "
        f"full width on the default device, {LAUNCH_TRAIN_SHAPE[0]} x {LAUNCH_TRAIN_SHAPE[1]} "
        f"tokens a step: drawn on the card in {draw_s:.2f} s, peak allocated "
        f"{gib(torch.cuda.max_memory_allocated() - base)}, {wall:.2f} s in all with its full save; "
        f"launches {counts}, as derived")
    log_lines("[serving]", text)
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    torch.cuda.empty_cache()
    return total


def phase_examples(dev) -> dict:
    """The four examples' main on the card, each counted.  Returns their
    launches, summed."""
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    (actions, text), counts, wall = counted(lambda: printed(quickstart.main, []))
    if [str(a) for a in actions] != ["Migrate(jid=0, dest=1)"] or counts != exactly(counts, decide_dest=1):
        raise RuntimeError(f"quickstart: decision {actions}, launches {counts}")
    add(counts)
    log(f"[examples] quickstart: {wall:.3f} s; Algorithm 1 decision {actions} through K4 (1 launch)")

    # train-plus-serve under all four policies; its feasibility-aware run
    # is the serving plane's chunked engine interleaved with K4, held to
    # device="cpu" and to BENCH_quick.json's carbon-slo row
    argv = ["--scenario", "train-plus-serve"]
    ((res, text), wall_us, events), counts, wall = counted(
        lambda: _profiled(lambda: printed(green_cluster_sim.main, argv), host_ops=False))
    t0 = time.perf_counter()
    cpu_res, cpu_text = printed(green_cluster_sim.main, argv + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    k4_only("green_cluster_sim", counts)
    for name in res:
        same_output(f"green_cluster_sim {name}", res[name], cpu_res[name])
    if text != cpu_text:
        raise RuntimeError(f"green_cluster_sim output on the card\n{text}\ndiffers from --device "
                           f"cpu\n{cpu_text}")
    add(counts)
    r = res["feasibility-aware"]
    digits = check_bench_row(r, ("policies", "carbon-slo"), CARBON_SLO_DIGITS)
    busy = sum(_device_us(e) for e in events)
    busy = (f"device busy {busy / 1e3:.2f} ms = {100 * busy / wall_us:.3f}% of its wall "
            f"(device-only trace)" if events else "device time not measured (no device events)")
    log(f"[examples] green_cluster_sim --scenario train-plus-serve: {wall:.3f} s (--device cpu "
        f"{cpu_s:.3f} s), K4 launches {counts['decide_dest']}, {busy}; output and summaries "
        f"equal to --device cpu")
    log(f"[examples] train-plus-serve, feasibility-aware (green_cluster_sim's run): wall "
        f"{r.wall_time_s:.3f} s (device='cpu' {cpu_res['feasibility-aware'].wall_time_s:.3f} s), "
        f"{r.ticks} ticks, decide_s {r.decide_s:.4f}, decide_first_s {r.decide_first_s:.4f}; "
        f"{digits} as recorded in BENCH_quick.json's carbon-slo row")
    log_lines("[examples]", "\n".join(text.splitlines()[-8:]))

    cfg = get_config("micro-lm").reduced()
    params = build_model(cfg).init(0, device="cpu")
    floats = sum(1 for _, x in flatten_with_paths({"params": params, "opt": init_opt_state(params)})
                 if x.is_floating_point())
    (sizes, text), counts, wall = counted(lambda: printed(migrate_across_sites.main, []))
    _, cpu_text = printed(migrate_across_sites.main, ["--device", "cpu"])
    # K2 once per float leaf in each of four int8 encodings: serialize int8,
    # serialize delta-int8, and the manager's two saves (int8, then delta)
    expect = exactly(counts, quantize_int8=4 * floats)
    if counts != expect or text != cpu_text:
        raise RuntimeError(f"migrate_across_sites: launches {counts}, expected {expect}; output on "
                           f"the card\n{text}\nwith --device cpu\n{cpu_text}")
    add(counts)
    log(f"[examples] migrate_across_sites (reduced micro-lm, {floats} float leaves): {wall:.3f} s, "
        f"K2 launches {counts['quantize_int8']} as derived; output equal to --device cpu")
    log_lines("[examples]", text)

    cfg = get_config("micro-lm-100m")
    (out, text), counts, wall = counted(
        lambda: printed(train_micro_lm.main, ["--steps", str(EXAMPLE_STEPS)]))
    expect = {k: v * EXAMPLE_STEPS for k, v in step_launches(cfg, "full").items()}
    if counts != expect:
        raise RuntimeError(f"train_micro_lm: launch counts {counts}, expected {expect}")
    add(counts)
    log_lines("[examples]", text)
    saves = [(i.nbytes, i.wall_time_s) for i in out["saves"]]
    save_s = sum(t for _, t in saves)
    run_s = out["site_a"]["elapsed_s"] + out["site_b"]["elapsed_s"]
    step_ms = 1e3 * (run_s - save_s) / EXAMPLE_STEPS
    log(f"[examples] train_micro_lm --steps {EXAMPLE_STEPS}, {cfg.name} at full width, 2 x 64 "
        f"tokens a step: {wall:.2f} s in all, sites A + B {run_s:.2f} s; {len(saves)} full saves of "
        f"{saves[0][0]} B in {', '.join(f'{t:.3f}' for _, t in saves)} s; mean step wall without "
        f"the saves {step_ms:.1f} ms ({2 * 64 / (step_ms / 1e3):.0f} tokens/s); launches as "
        f"derived {counts}")
    # the example's model and shape on the card against the CPU (its own
    # check is only that the loss falls), and its steps' busy share
    params = build_model(cfg).init(0, device="cpu")
    check_card_vs_cpu(cfg, params, dev, seq=64, steps=1, tag="[examples]", profile=True)
    return total


# ---------------------------------------------------------------------------
# The assigned architectures: qwen3-1.7b, gemma2-2b, granite-moe-1b-a400m
# ---------------------------------------------------------------------------


def mrope_positions(b: int, grid_h: int, grid_w: int, n_text: int) -> torch.Tensor:
    """(b, grid_h * grid_w + n_text, 3) M-RoPE ids (t, h, w) of a patch
    grid followed by text, as Qwen2-VL numbers them (arXiv:2409.12191
    section 2.1): the grid's t fixed at 0, h its row, w its column; the
    text's three streams equal, counting on from the grid's largest id
    plus one."""
    rows = torch.arange(grid_h).repeat_interleave(grid_w)
    cols = torch.arange(grid_w).repeat(grid_h)
    grid = torch.stack([torch.zeros_like(rows), rows, cols], dim=-1)
    text = (max(grid_h, grid_w) + torch.arange(n_text))[:, None].expand(n_text, 3)
    return torch.cat([grid, text]).expand(b, -1, -1).contiguous()


def arch_batch(cfg, b: int, s: int, *, seed: int, grid=None) -> dict:
    """A numpy batch of ``b`` x ``s`` inputs for ``cfg``: the synthetic LM
    stream's tokens and labels, or for an embeddings-input model seeded
    embeddings (std ARCH2_EMBED_STD), M-RoPE positions of a ``grid``
    patch grid then text (mrope_positions) and the stream's labels; an
    encoder-decoder's batch also holds seeded frame embeddings (b,
    encoder_seq, d) of std WHISPER_FRAME_STD."""
    batch = SyntheticLMDataset(cfg.vocab_size, s, b, seed=seed).batch(0)
    if cfg.is_encdec:
        rng = np.random.default_rng(seed)
        frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)) * WHISPER_FRAME_STD
        return {**batch, "frames": frames.astype(np.float32)}
    if cfg.input_mode != "embeddings":
        return batch
    gh, gw = grid or ARCH2_SMALL_GRID
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((b, s, cfg.d_model)) * ARCH2_EMBED_STD).astype(np.float32)
    return {"embeds": embeds, "positions": mrope_positions(b, gh, gw, s - gh * gw).numpy(),
            "labels": batch["labels"]}


def torch_inputs(batch: dict, device="cpu") -> dict:
    """A numpy batch's model inputs (its labels left out) as tensors on
    ``device``, integer ids as int64."""
    out = {}
    for k, v in batch.items():
        if k != "labels":
            x = torch.from_numpy(v)
            out[k] = (x.long() if not x.is_floating_point() else x).to(device)
    return out


def inputs_word(cfg) -> str:
    if cfg.is_encdec:
        return "tokens on frames"
    return "embeddings" if cfg.input_mode == "embeddings" else "tokens"


@torch.inference_mode()
def decode_embeds(model, params, embeds, positions, max_new: int, tokens=None):
    """Step-by-step decode through Model.decode_step of a prompt given as
    embeddings (b, P, d), each step with its (b, 1, 3) M-RoPE positions,
    then ``max_new - 1`` tokens through the embedding table: the greedy
    (argmax) ones, or with ``tokens`` (b, max_new - 1) those.  Returns (the
    ``max_new`` greedy tokens (b, max_new), every step's logits (b, P +
    max_new - 1, vocab))."""
    b, P = embeds.shape[:2]
    n = P + max_new - 1
    cache = model.init_cache(b, n, device=embeds.device)
    steps, new = [], []
    for i in range(n):
        if i < P:
            step = {"embeds": embeds[:, i:i + 1]}
        else:
            step = {"token": new[-1] if tokens is None else tokens[:, i - P]}
        logits, cache = model.decode_step(
            params, cache, {**step, "index": i, "positions": positions[:, i:i + 1]})
        steps.append(logits)
        if i >= P - 1:
            new.append(torch.argmax(logits, dim=-1))
    return torch.stack(new, dim=1), torch.stack(steps, dim=1)


def cut_depth(cfg, params, groups: int):
    """The first ``groups`` layer groups of a model: (its config, its params,
    whose group leaves are views of the full model's)."""
    cut = replace(cfg, num_layers=groups * len(cfg.block_pattern))
    return cut, {**params, "groups": tree_map(lambda x: x[:groups], params["groups"])}


def visible_pairs(s: int, mask: str, window: int) -> int:
    """(query, key) pairs a self-attention over ``s`` positions computes."""
    if mask == "full":
        return s * s
    w = min(window, s) if mask == "window" and window > 0 else s
    return w * (w + 1) // 2 + (s - w) * w


class DecodeLogits:
    """A Model whose decode_step also keeps each step's logits, for
    greedy_decode to drive: ``logits()`` gives them as (b, steps, vocab)."""

    def __init__(self, model):
        self.model, self.steps = model, []

    def init_cache(self, *args, **kwargs):
        return self.model.init_cache(*args, **kwargs)

    def decode_step(self, params, cache, batch):
        logits, cache = self.model.decode_step(params, cache, batch)
        self.steps.append(logits)
        return logits, cache

    def logits(self) -> torch.Tensor:
        return torch.stack(self.steps, dim=1)


def decode_share(decoded: torch.Tensor, prefill: torch.Tensor) -> tuple:
    """(max abs difference of the decode steps' logits from the prefill's
    at the same positions, its share of MODEL_BF16_TOL x max|prefill logit|)."""
    err = max_diff(decoded, prefill)
    return err, err / (MODEL_BF16_TOL * float(prefill.float().abs().max()))


@dataclass
class ArchServeResult:
    logits: torch.Tensor
    logits_restored: torch.Tensor  # the prefill from the restored params
    tokens: torch.Tensor
    decode_logits: torch.Tensor  # each decode step's, (b, prompt + new - 1, vocab)
    logits_decoded: torch.Tensor  # the prefill of the decoded tokens but the last
    launches: dict  # segment -> counts
    prefill_s: float  # the second (warm) prefill
    decode_s: float
    nbytes: int
    save_s: float
    restore_s: float
    restored_equal: bool  # every leaf, dtype and bits


def run_arch_serving(cfg, params, prompts, decode_prompts, workdir, *, max_new,
                     device) -> ArchServeResult:
    """Serve ``cfg`` through the port's entry points on ``device``: prefill
    (Model.forward) twice, greedy decode of ``max_new`` tokens after
    ``decode_prompts`` (its steps' logits kept) and the prefill of the
    decoded tokens, a full-mode checkpoint of the params, its restore, and
    the prefill from the restored params; each segment with the launch
    counters set to 0 just before it and read just after.  The checkpoint
    is deleted before returning."""
    dev = resolve(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    model = build_model(cfg)
    launches = {}

    def segment(name, fn):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        launches[name] = ops.launch_counts()
        return out, time.perf_counter() - t0

    (logits, _), _ = segment("prefill", lambda: model.forward(params, {"tokens": prompts}))
    _, prefill_s = segment("prefill again", lambda: model.forward(params, {"tokens": prompts}))
    cache_len = decode_prompts.shape[1] + max_new
    rec = DecodeLogits(model)
    tokens, decode_s = segment("decode", lambda: greedy_decode(
        rec, params, decode_prompts, max_new, cache_len))
    (logits_d, _), _ = segment("prefill decoded", lambda: model.forward(
        params, {"tokens": tokens[:, :-1]}))
    root = os.path.join(workdir, cfg.name)
    mgr = CheckpointManager(root, job=cfg.name, mode="full")
    _, save_s = segment("save", lambda: mgr.save(0, params))
    (back, _), restore_s = segment("restore", lambda: mgr.restore(params, device=dev))
    (logits_b, _), _ = segment("prefill restored", lambda: model.forward(back, {"tokens": prompts}))
    equal = all(x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y)
                in zip(flatten_with_paths(back), flatten_with_paths(params)))
    nbytes = mgr.latest_bytes
    shutil.rmtree(root)
    return ArchServeResult(logits, logits_b, tokens, rec.logits(), logits_d, launches, prefill_s,
                           decode_s, nbytes, save_s, restore_s, equal)


def check_arch_serving(res: ArchServeResult, cfg, prompts, decode_prompts) -> dict:
    """Launches as derived (K1 bf16 once per layer a prefill, none in
    decode or the full-mode checkpoint), finite logits of the right shape,
    decoded tokens in the vocabulary after their prompt, and the restore
    exact: every leaf and the prefill's logits bit for bit (the decode's
    logits are held by check_arch_decode).  Returns the launches, summed."""
    total = {}
    for name, got in res.launches.items():
        k1 = attn_layers(cfg) if name.startswith("prefill") else 0
        if got != exactly(got, flash_attention_bf16=k1):
            raise RuntimeError(f"{cfg.name} {name}: launch counts {got}, expected K1 bf16 {k1} only")
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    b, s = prompts.shape
    if res.logits.shape != (b, s, cfg.vocab_size) or not bool(torch.isfinite(res.logits).all()):
        raise RuntimeError(f"{cfg.name} prefill logits: shape {tuple(res.logits.shape)} or not finite")
    n = decode_prompts.shape[1]
    toks = res.tokens
    if toks.shape != (decode_prompts.shape[0], n + ARCH_NEW) or not torch.equal(toks[:, :n], decode_prompts):
        raise RuntimeError(f"{cfg.name} decode tokens: shape {tuple(toks.shape)} or prompt lost")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise RuntimeError(f"{cfg.name} decode produced out-of-vocab tokens")
    if not res.restored_equal or not torch.equal(res.logits_restored, res.logits):
        raise RuntimeError(f"{cfg.name}: the full-mode checkpoint's restore is not exact")
    return total


@contextlib.contextmanager
def expert_choice(record: list, force=None):
    """Inside, each MoE top-k expert selection (moe.topk_stable, as
    moe.router_probs calls it) appends its (b, s, k) experts to ``record``;
    with ``force``, it picks those experts instead (a list: the i-th
    selection picks its i-th entry), each with the layer's own probability
    as its gate (renormalised by router_probs as ever)."""
    real = moe_lib.topk_stable
    calls = iter(force) if isinstance(force, list) else None

    def choose(x, k):
        if force is None:
            vals, idx = real(x, k)
        else:
            idx = (next(calls) if calls is not None else force).to(x.device)
            if idx.shape != (*x.shape[:-1], k):
                raise RuntimeError(f"forced experts {tuple(idx.shape)} for a top-{k} of {tuple(x.shape)}")
            vals = torch.gather(x, -1, idx)
        record.append(idx.cpu())
        return vals, idx

    moe_lib.topk_stable = choose
    try:
        yield
    finally:
        moe_lib.topk_stable = real


def routing_flips(card: list, cpu: list) -> int:
    """Tokens whose expert set differs between two records of
    expert_choice (their first selections)."""
    a, b = (torch.sort(r[0], dim=-1).values for r in (card, cpu))
    return int((a != b).any(-1).sum())


def check_arch_card_vs_cpu(cfg, params, dev, tag: str = "[archs]", seq: int = 0) -> dict:
    """The model cut to one layer group at full width (an encoder-decoder
    whole), on 2 x ``seq`` tokens (default ARCH_CARD_CPU_SEQ), on the card
    against device="cpu":
    the forward's logits within CARD_CPU_BF16_TOL of the largest |logit|
    (how the step's gradients are held), beside both sides' distance from
    the float32 forward of the same weights on the CPU (not a gate); then
    one train step (check_bf16_step).
    An embeddings-input model is fed embeddings and M-RoPE positions
    (arch_batch) in the forward and the step.  Returns the launches of
    both, summed."""
    cut, p = (cfg, params) if cfg.is_encdec else cut_depth(cfg, params, 1)
    seq = seq or ARCH_CARD_CPU_SEQ
    batch = arch_batch(cut, CARD_CPU_BATCH, seq, seed=0)
    inputs = torch_inputs(batch)
    model = build_model(cut)
    depth = "whole" if cut is cfg else f"cut to {cut.num_layers} layer(s)"
    what = f"{tag} {cut.name} {depth}"

    def routes(record):  # an MoE model's expert choice; nothing to patch in any other
        return expert_choice(record) if cut.moe else contextlib.nullcontext()

    def forward_check(cpu_routes, cpu32):
        """The CPU forwards (bf16, and float32 for the log) against the
        card's logits."""
        with routes(cpu_routes):
            plain, _ = model.forward(host, inputs)
        plain = plain.float()
        err, top = float((card - plain).abs().max()), float(plain.abs().max())
        share = err / (CARD_CPU_BF16_TOL * top)
        if not share <= 1.0:
            raise RuntimeError(f"{cut.name} forward on the card vs the CPU: max abs err {err}, "
                               f"{100 * share:.1f}% of {CARD_CPU_BF16_TOL} x max|logit| {top}")
        with routes(cpu32):  # an MoE layer's float32 expert choice on the CPU
            exact, _ = build_model(replace(cut, dtype="float32")).forward(
                tree_map(lambda x: x.float(), host), inputs)
        log(f"{tag} {cfg.name} {depth} at full width, {CARD_CPU_BATCH} x "
            f"{seq} {inputs_word(cut)}: forward logits vs device='cpu' max abs err {err:.3e}, "
            f"{100 * share:.1f}% of {CARD_CPU_BF16_TOL} x max|logit| ({top:.3f}); from the "
            f"float32 forward: card {float((card - exact).abs().max()):.3e}, plain "
            f"{float((plain - exact).abs().max()):.3e}; launches {counts}")

    card_routes = []
    with routes(card_routes):
        (card, _), counts, _ = counted(lambda: model.forward(p, torch_inputs(batch, dev)))
    if counts != exactly(counts, flash_attention_bf16=attn_layers(cut)):
        raise RuntimeError(f"{cut.name} forward: launch counts {counts}")
    card = card.float().cpu()
    host = tree_map(lambda x: x.cpu(), p)
    if not cut.moe:
        # no routing to patch: the CPU side runs beside the card's next work
        step = bf16_card_step(cut, p, dev, batch, what)

        def cpu_side():
            forward_check([], [])
            bf16_cpu_check(cut, host, batch, what, *step)

        if resolve(dev).type == "cuda":
            CPU_SIDES.submit(cpu_side)
        else:  # a rehearsal on the CPU, whose plain stand-ins count as launches
            cpu_side()
        return {k: counts[k] + step[2][k] for k in counts}
    cpu_routes, cpu32 = [], []
    forward_check(cpu_routes, cpu32)
    # MoE: top-k routing is discontinuous, so a token whose k-th and
    # (k+1)-th router probabilities lie closer than the two sides' bf16
    # rounding apart goes to another expert on each side, and the experts'
    # gradients then differ by that token's whole contribution.  The bf16
    # step's CPU side therefore routes every token as the card's step did,
    # each gate still its own router's probability, and every leaf is held;
    # the same step in float32, where the routing agrees unforced, is held
    # leaf by leaf as well.
    groups = cut.num_layers // len(cut.block_pattern)
    if groups * sum(tfm._is_moe_pos(cut, i) for i in range(len(cut.block_pattern))) != 1:
        raise RuntimeError(f"{what}: one MoE layer expected, so that one expert choice routes it")
    log(f"{what}: {routing_flips(card_routes, cpu_routes)} of {batch['labels'].size} tokens routed to "
        f"other experts on the card than on the CPU in bf16 (the MoE layer's top-{cut.top_k} "
        f"dispatch, unforced)")
    step = check_bf16_step(cut, p, dev, batch, what, moe_routes=[])
    total = {k: counts[k] + step[k] for k in counts}
    cut32 = replace(cut, dtype="float32")
    p32 = tree_map(lambda x: x.float(), p)
    card32 = []
    with expert_choice(card32):
        counted(lambda: build_model(cut32).forward(p32, torch_inputs(batch, dev)))
    p32 = tree_map(lambda x: x.cpu(), p32)  # check_card_vs_cpu copies it to each side
    flips32 = routing_flips(card32, cpu32)
    if flips32:
        raise RuntimeError(f"{what} in float32: {flips32} tokens routed differently")
    check_card_vs_cpu(cut32, p32, dev, seq=seq, steps=1, tag=f"{tag} float32,")
    step32 = step_launches(cut32, "full")  # check_card_vs_cpu held its launches to these
    return {k: total[k] + step32[k] for k in total}


def check_arch_decode(cfg, params, res: ArchServeResult, dev) -> dict:
    """The full-depth decode's logits, in float32: a float32 copy of the
    weights decodes the served tokens but the last step by step
    (greedy_decode fed every one), and each step's logits must equal the
    float32 prefill of the same tokens within DECODE_TOL, the reference's
    own prefill / decode tolerance.  In bf16, rounding through a full
    depth of random weights moves logits by more than MODEL_BF16_TOL of
    the largest in either path, so the served bf16 decode's and prefill's
    logits are reported, each against the float32 prefill, and the bf16
    decode is held at one layer group (check_cut_decode).  Returns the
    launches (the float32 prefill's K1)."""
    cfg32 = replace(cfg, dtype="float32")
    p32 = tree_map(lambda x: x.float(), params)
    model = build_model(cfg32)
    toks = res.tokens[:, :-1]
    rec = DecodeLogits(model)
    _, dec, _ = counted(lambda: greedy_decode(rec, p32, toks, 1, toks.shape[1] + 1))
    (want, _), pre, _ = counted(lambda: model.forward(p32, {"tokens": toks}))
    if dec != exactly(dec) or pre != exactly(pre, flash_attention=attn_layers(cfg)):
        raise RuntimeError(f"{cfg.name} float32 decode / prefill launches {dec} / {pre}")
    got = rec.logits()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=DECODE_TOL, rtol=DECODE_TOL):
        raise RuntimeError(f"{cfg.name} float32 decode vs prefill at full depth: max abs err {err} "
                           f"beyond {DECODE_TOL}")
    top = float(want.abs().max())
    log(f"[archs] {cfg.name} decode at full depth in float32: {toks.shape[0]} x {toks.shape[1]} "
        f"steps within {DECODE_TOL} of the float32 prefill of the same tokens (max abs err "
        f"{err:.3e}); served in bf16, max abs distance from that float32 prefill (max|logit| "
        f"{top:.3f}): the bf16 decode {max_diff(res.decode_logits, want):.3e}, the bf16 prefill "
        f"{max_diff(res.logits_decoded, want):.3e}, and between the two "
        f"{max_diff(res.decode_logits, res.logits_decoded):.3e}; launches {pre}")
    del p32, rec
    return pre


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in float32, on ``a``'s device."""
    return float((a.float() - b.float().to(a.device)).abs().max())


def check_cut_decode(cfg, params, dev, tag: str = "[archs]") -> dict:
    """The bf16 decode at one layer group at full width: step by step
    (greedy_decode fed every token) over 2 x ARCH_CARD_CPU_SEQ tokens, or,
    for a model with local layers, over one sequence ARCH_PAST_WINDOW
    tokens longer than its window, so the local layers' ring-buffer cache
    wraps; each step's logits within MODEL_BF16_TOL of the largest |logit|
    of the prefill of the same tokens (where K1's window cuts).  Returns
    the launches (K1 bf16 once a layer in the prefill, none in decode).  An
    embeddings-input model decodes its embeddings with their M-RoPE
    positions (arch_batch, decode_embeds)."""
    cut, p = cut_depth(cfg, params, 1)
    local = "attn_local" in cut.block_pattern
    if local:
        cut = replace(cut, sliding_window=min(cut.sliding_window, CUT_DECODE_WINDOW))
    b, n = (1, cut.sliding_window + ARCH_PAST_WINDOW) if local else (CARD_CPU_BATCH, ARCH_CARD_CPU_SEQ)
    inputs = torch_inputs(arch_batch(cut, b, n, seed=4), dev)
    model = build_model(cut)
    prefill_routes, decode_routes = [], []
    with expert_choice(prefill_routes):
        (prefill, _), pre, _ = counted(lambda: model.forward(p, inputs))

    def decode(force=None):
        with expert_choice(decode_routes, force) if cut.moe else contextlib.nullcontext():
            if "embeds" in inputs:
                (_, out), counts, wall = counted(lambda: decode_embeds(
                    model, p, inputs["embeds"], inputs["positions"], 1))
                return out, counts, wall
            rec = DecodeLogits(model)
            _, counts, wall = counted(lambda: greedy_decode(rec, p, inputs["tokens"], 1, n + 1))
            return rec.logits(), counts, wall

    decoded, dec, dec_s = decode()
    routed = ""
    if cut.moe:
        # A token whose k-th and (k+1)-th router probabilities lie closer
        # than the prefill's and the decode's bf16 roundings apart goes to
        # other experts in each, and its logits then differ by those
        # experts' whole contribution: the decode is held routed as the
        # prefill chose, step by step (the float32 decode, unforced, is
        # held by check_f32_decode or check_arch_decode).
        if len(prefill_routes) != 1 or len(decode_routes) != n:
            raise RuntimeError(f"{cut.name}: one MoE layer expected, so that one expert choice routes it")
        flips = routing_flips([prefill_routes[0]], [torch.cat(decode_routes, dim=1)])
        unforced = decode_share(decoded, prefill)[1]
        decode_routes.clear()
        decoded, dec2, _ = decode([prefill_routes[0][:, i:i + 1] for i in range(n)])
        dec = {k: dec[k] + dec2[k] for k in dec}
        routed = (f"; {flips} of {b * n} tokens routed to other experts unforced ({100 * unforced:.1f}% "
                  f"of the limit unforced), so the decode is held routed as the prefill chose")
    if dec != exactly(dec) or pre != exactly(pre, flash_attention_bf16=attn_layers(cut)):
        raise RuntimeError(f"{cut.name} decode / prefill launches {dec} / {pre}")
    err, share = decode_share(decoded, prefill)
    if not share <= 1.0:
        raise RuntimeError(f"{cut.name} bf16 decode at one layer group vs the prefill: max abs err "
                           f"{err}, {100 * share:.1f}% of {MODEL_BF16_TOL} x max|logit|")
    past = ""
    if local:
        w = cut.sliding_window
        past_err, past_share = decode_share(decoded[:, w:], prefill[:, w:])
        past = (f"; past the {w}-token window ({ARCH_PAST_WINDOW} steps) {past_err:.3e}, "
                f"{100 * past_share:.1f}%")
    log(f"{tag} {cfg.name} cut to {cut.num_layers} layer(s) at full width, bf16 decode of {b} x "
        f"{n} {inputs_word(cut)} in {dec_s:.1f} s: every step's logits within {MODEL_BF16_TOL} x max|logit| of "
        f"the prefill of the same inputs (max abs err {err:.3e}, {100 * share:.1f}% of it{past}){routed}; "
        f"launches: decode none, prefill {pre}")
    return pre


def group_params(params: dict, blocks) -> dict:
    """Layer group 0's ``blocks`` of a param tree."""
    return tree_map(lambda x: x[0], {b: params["groups"][b] for b in blocks})


def run_moe_lifecycle(cfg, dev, work) -> dict:
    """granite-moe cut to MOE_LIFE_LAYERS at full width through the
    training lifecycle (run_train_lifecycle, full mode, against an
    unmigrated run), then an int8 checkpoint lifecycle (checkpoint_round_trip)
    of site A's params at preemption, its first layer group: the whole
    training state's int8 save took 30 s of the card machine's host
    (zlib), this group's 11 s with its master, m and v; its params hold
    bf16 attention and experts beside the float32 router.  Returns the
    launches, summed."""
    cut = replace(cfg, num_layers=MOE_LIFE_LAYERS)
    d = os.path.join(work, "lifecycle")
    res = run_train_lifecycle(cut, d, mode="full", grad_compress=False, device=dev,
                              steps=MOE_LIFE_STEPS, preempt=MOE_LIFE_PREEMPT,
                              save_every=MOE_LIFE_SAVE_EVERY)
    total = check_train_lifecycle(res, tag="[archs]")
    blocks = [f"b{i}" for i in range(len(cut.block_pattern))]
    sub = group_params(res.state_a["params"], blocks)
    rt = checkpoint_round_trip(sub, cut.name, dev, os.path.join(d, "int8"), mode="int8")
    log(f"[archs] {cut.name} layer group 0 of the params at step {res.preempt} (the whole training "
        f"state {res.nbytes} B in full mode): {describe_round_trip(rt, 'int8')}; launches "
        f"{rt['launches']}, as derived")
    total = {k: total.get(k, 0) + v for k, v in rt["launches"].items()}
    del res, sub, rt
    shutil.rmtree(d)
    return total


def arch_flash_inputs(gen, case, dev) -> tuple:
    """(q, k, v, do) in bf16 on ``dev`` for K1's case ``case``: randn, q
    times ARCH_FLASH_Q_SCALE, and each key on the mask's edge turned toward
    the query row that must see it and the one that must not (the first
    head of its group), or under a full mask the last key toward the first
    row, as ARCH_FLASH_Q_SCALE's comment says."""
    b, s, t, nh, nkv, hd, mask, win, _ = case
    q = randn(gen, (b, s, nh, hd), "cpu", ARCH_FLASH_Q_SCALE)
    k, v = (randn(gen, (b, t, nkv, hd), "cpu") for _ in range(2))
    do = randn(gen, (b, s, nh, hd), "cpu")
    lead = q[:, :, ::nh // nkv]  # the first head of each group: (b, s, nkv, hd)
    unit = lead / lead.norm(dim=-1, keepdim=True)
    if mask == "full":
        k[:, t - 1] += ARCH_FLASH_EDGE * unit[:, 0]
    else:
        # distance (query - key) of the last key a row sees, and of the first it must not
        edge = (win - 1, win) if mask == "window" and win > 0 else (0, -1)
        keys = torch.arange(t)
        for d in edge:
            rows = keys + d
            ok = (rows >= 0) & (rows < s)
            k[:, keys[ok]] += ARCH_FLASH_EDGE * unit[:, rows[ok]]
    return tuple(x.to(dev, torch.bfloat16) for x in (q, k, v, do))


def _shares(got, want, tol) -> list:
    """Each of ``got``'s max abs differences from ``want`` as a share of
    ``tol`` x the largest |element| of its ``want``."""
    return [float((g.float() - w).abs().max()) / (tol * float(w.abs().max()))
            for g, w in zip(got, want)]


def control_attention(q, k, v, do, *, head_of, shift: int = 0, mask_kind: str = "causal",
                      window: int = 0, attn_softcap: float = 0.0) -> tuple:
    """A control for check_arch_flash: the float32 plain attention with
    query head h reading kv head ``head_of[h]`` and the causal diagonal
    moved by ``shift`` keys (row i sees keys j <= i + shift); its output
    and (dq, dk, dv) by autograd."""
    with torch.enable_grad():
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        ke, ve = kg[:, :, head_of], vg[:, :, head_of]  # (b, t, nh, hd)
        scores = torch.einsum("bshd,bthd->bhst", qg, ke) * (q.shape[-1] ** -0.5)
        if attn_softcap:
            scores = attn_softcap * torch.tanh(scores / attn_softcap)
        if mask_kind != "full":
            qpos = torch.arange(q.shape[1], device=q.device)[:, None]
            kpos = torch.arange(k.shape[1], device=q.device)[None, :]
            ok = kpos <= qpos + shift
            if mask_kind == "window" and window > 0:
                ok &= (qpos - kpos) < window
            scores = torch.where(ok, scores, torch.full((), ref.NEG_INF, device=q.device))
        out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), ve)
        return (out.detach(), *torch.autograd.grad(out, (qg, kg, vg), do))


def cut_last_key(f32, kw) -> tuple:
    """A control for check_arch_flash: the float32 plain attention with the
    last key and value cut off; (output, dq, dk, dv), the cut key's dk and
    dv rows 0."""
    q, k, v, do = f32
    out = ref.flash_attention_ref(q, k[:, :-1], v[:, :-1], **kw)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k[:, :-1], v[:, :-1], do, **kw)
    pad = lambda g: torch.cat([g, torch.zeros_like(g[:, :1])], dim=1)  # noqa: E731
    return out, dq, pad(dk), pad(dv)


def check_arch_flash(dev, gen, archs=ARCHS, tag: str = "[archs]") -> None:
    """K1 and its backward in bf16 at the layer shapes of ``archs``
    (ARCH_FLASH_CASES whose name starts with one), on arch_flash_inputs,
    against the plain version in float32 with the controls that show the
    check can see a wrong softcap, window, GQA head mapping, causal
    diagonal, or a full mask's mask or last key (see ARCH_FLASH_Q_SCALE);
    then each timed beside the bf16 plain version, SDPA where it computes
    the same function (causal or full, no softcap; GQA by ``enable_gqa``)
    and the bound: the larger of its bytes
    and its operations on the visible pairs at the bf16 tensor-core
    rate."""
    names = ("output", "dq", "dk", "dv")
    cases = {n: c for n, c in ARCH_FLASH_CASES.items() if n.split(" ")[0] in archs}
    if not cases:
        raise RuntimeError(f"{tag}: no K1 layer shape of {archs} in ARCH_FLASH_CASES")
    for name, case in cases.items():
        b, s, t, nh, nkv, hd, mask, win, cap = case
        q, k, v, do = arch_flash_inputs(gen, case, dev)
        kw = dict(mask_kind=mask, window=win, attn_softcap=cap)
        o, lse = flash_attention_lse_cuda(q, k, v, **kw)
        got = (flash_attention_cuda(q, k, v, **kw), *flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw))
        f32 = [x.float() for x in (q, k, v, do)]

        def plain(**over):
            kw32 = {**kw, **over}
            return (ref.flash_attention_ref(*f32[:3], **kw32), *ref.flash_attention_bwd_ref(*f32, **kw32))

        want = plain()
        torch.cuda.synchronize()
        for n, g in zip(names, got):
            if g.dtype != torch.bfloat16:
                raise RuntimeError(f"K1 bf16 {name} {case}: {n} is {g.dtype}")
        shares = _shares(got, want, FLASH_BF16_TOL)
        if not max(shares) <= 1.0:
            raise RuntimeError(f"K1 bf16 {name} {case} vs the float32 plain version: "
                               + ", ".join(f"{n} {100 * x:.1f}%" for n, x in zip(names, shares))
                               + f" of {FLASH_BF16_TOL} x its max")
        controls = {"softcap 0": lambda: plain(attn_softcap=0.0)} if cap else {}
        if mask == "window":
            controls.update({f"window {win - 1}": lambda: plain(window=win - 1),
                             f"window {win + 1}": lambda: plain(window=win + 1)})
        group = nh // nkv
        heads = torch.arange(nh, device=q.device)
        if group > 1 and nkv > 1:  # h % nkv differs from h // group
            controls[f"kv head h % {nkv} (not h // {group})"] = lambda: control_attention(
                *f32, head_of=heads % nkv, **kw)
        if mask == "causal":
            for d in (-1, 1):
                controls[f"diagonal {d:+d} key"] = lambda d=d: control_attention(
                    *f32, head_of=heads // group, shift=d, **kw)
        if mask == "full":
            controls["a causal mask"] = lambda: plain(mask_kind="causal")
            controls[f"keys cut to {t - 1}"] = lambda: cut_last_key(f32, kw)
        seen = []
        for cname, control in controls.items():
            missed = _shares(control(), want, FLASH_BF16_TOL)
            if not min(missed) > 1.0:
                raise RuntimeError(f"K1 bf16 {name} {case}: the control with {cname} stays within "
                                   f"the limit ({', '.join(f'{n} {100 * x:.1f}%' for n, x in zip(names, missed))}), "
                                   "so the check cannot see that fault")
            seen.append(f"{cname} misses it by {min(missed):.1f}x or more")
        del want
        log(f"{tag} K1 bf16 {name} {case} vs the float32 plain version (q x {ARCH_FLASH_Q_SCALE}, "
            f"mask-edge keys): " + ", ".join(f"{n} {100 * x:.1f}%" for n, x in zip(names, shares))
            + f" of {FLASH_BF16_TOL} x its max" + (f"; controls: {'; '.join(seen)}" if seen else ""))

        pairs = b * nh * visible_pairs(s, mask, win)
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, **kw))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw))
        bwd = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw))
        plain_bwd = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, do, **kw)) - plain_ms
        lib = lib_bwd = None
        if mask in ("causal", "full") and not cap:
            qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
            qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=mask == "causal", enable_gqa=True)
            lib = time_ms(lambda: sdpa().detach())
            lib_bwd = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot)) - lib
        # forward: q, k, v in, o out; backward: q, k, v, o, do, lse in, dq, dk, dv out
        f_ms, f_by = bound(2 * (2 * q.numel() + 2 * k.numel()), 4 * hd * pairs, BF16_FLOPS)
        b_ms, b_by = bound(2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
                           BWD_FLOPS_PER_PAIR_HD * hd * pairs, BF16_FLOPS)
        fmt = lambda x: "null" if x is None else f"{x:.4f}"  # noqa: E731
        log(f"{tag} K1 bf16 {name} {case}: forward {ms:.4f} ms, plain {plain_ms:.4f}, SDPA "
            f"{fmt(lib)}, bound {f_ms:.4f} ({f_by}, {100 * f_ms / ms:.1f}%); backward {bwd:.4f} ms, "
            f"plain {plain_bwd:.4f}, SDPA {fmt(lib_bwd)}, bound {b_ms:.4f} ({b_by}, "
            f"{100 * b_ms / bwd:.1f}%)")


def phase_archs(dev) -> dict:
    """qwen3-1.7b, gemma2-2b and granite-moe-1b-a400m in bf16 at full width,
    each initialised once on the card: (a) served at full depth, its decode
    held in float32, (b) cut to one layer group against device="cpu", and
    its bf16 decode held to its prefill, (c) granite-moe's training
    lifecycle; then (d) K1 at their layer shapes.  Returns the launches of
    the counted runs, summed."""
    t_phase = time.perf_counter()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_archs_") as work:
        for arch in ARCHS:
            cfg = get_config(arch)
            t0 = time.perf_counter()
            params = build_model(cfg).init(
                device=dev, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            n = sum(x.numel() for _, x in flatten_with_paths(params))
            nbytes = sum(x.numel() * x.element_size() for _, x in flatten_with_paths(params))
            if n != param_count(cfg):
                raise RuntimeError(f"{arch}: {n} params, param_count says {param_count(cfg)}")
            log(f"[archs] {arch}: {n} params ({active_param_count(cfg)} active a token; "
                f"param_count agrees), {cfg.num_layers} layers of {cfg.block_pattern}, bf16 weights "
                f"{nbytes} B, drawn on the card in {init_s:.2f} s")

            b, s = ARCH_PREFILL.get(arch, ARCH_PREFILL_DEFAULT)
            prompts = torch.from_numpy(
                SyntheticLMDataset(cfg.vocab_size, s, b, seed=1).batch(0)["tokens"]).long().to(dev)
            pb, ps = ARCH_PROMPT
            decode_prompts = torch.from_numpy(
                SyntheticLMDataset(cfg.vocab_size, ps, pb, seed=2).batch(0)["tokens"]).long().to(dev)
            res = run_arch_serving(cfg, params, prompts, decode_prompts, work, max_new=ARCH_NEW,
                                   device=dev)
            add(check_arch_serving(res, cfg, prompts, decode_prompts))
            _, wall_us, events = _profiled(
                lambda: build_model(cfg).forward(params, {"tokens": prompts}), host_ops=False)
            busy = sum(_device_us(e) for e in events)
            busy = (f"device busy {busy / 1e3:.2f} ms of a {wall_us / 1e3:.2f} ms profiled prefill "
                    f"({100 * busy / wall_us:.1f}%)" if events else
                    "device time not measured (the profiler saw no device events)")
            log(f"[archs] {arch} serving at full depth: prefill {b} x {s} {res.prefill_s * 1e3:.2f} "
                f"ms (warm; K1 bf16 {cfg.num_layers} launches), {busy}; greedy decode {pb} x "
                f"{ps} + {ARCH_NEW}: {pb * ARCH_NEW / res.decode_s:.1f} new tok/s "
                f"({(ps + ARCH_NEW - 1) / res.decode_s:.1f} steps/s, no K1 launch); full checkpoint "
                f"{res.nbytes} B saved in {res.save_s:.3f} s, restored in {res.restore_s:.3f} s, "
                f"every leaf and the prefill's logits bit-identical")
            add(check_arch_decode(cfg, params, res, dev))
            del res
            add(check_arch_card_vs_cpu(cfg, params, dev))
            add(check_cut_decode(cfg, params, dev))
            del params
            if arch == MOE_ARCH:
                add(run_moe_lifecycle(cfg, dev, work))
            torch.cuda.empty_cache()
    check_arch_flash(dev, torch.Generator().manual_seed(3))
    CPU_SIDES.finish()
    log(f"[archs] phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# The rest of the attention family: qwen2.5-32b, qwen1.5-32b,
# phi3.5-moe-42b-a6.6b, qwen2-vl-7b
# ---------------------------------------------------------------------------


@dataclass
class Arch2ServeResult:
    logits: torch.Tensor  # the first prefill's
    prefill_s: float  # the second, warm prefill's wall
    busy: str  # the profiled prefill's device busy share
    decode_in: dict  # the decode prompt: {'tokens'} or {'embeds', 'positions'}
    new: torch.Tensor  # (b, ARCH_NEW) greedy tokens
    decode_s: float
    launches: dict  # {segment: launch counts}


def run_arch2_serving(cfg, params, dev) -> Arch2ServeResult:
    """Serve ``cfg`` at its served depth through the port's entry points:
    prefill 2 x 512 (Model.forward) twice and once more profiled, then a
    greedy decode of ARCH_NEW tokens after a 2 x 32 prompt (greedy_decode;
    an embeddings-input model's prompt as embeddings through decode_embeds,
    its new tokens through the embedding table), each segment counted."""
    model = build_model(cfg)
    b, s = ARCH_PREFILL_DEFAULT
    inputs = torch_inputs(arch_batch(cfg, b, s, seed=1, grid=ARCH2_GRID), dev)
    launches = {}

    def segment(name, fn):
        out, launches[name], wall = counted(fn)
        return out, wall

    (logits, _), _ = segment("prefill", lambda: model.forward(params, inputs))
    _, prefill_s = segment("prefill again", lambda: model.forward(params, inputs))
    (_, wall_us, events), _ = segment("prefill profiled", lambda: _profiled(
        lambda: model.forward(params, inputs), host_ops=False))
    busy = sum(_device_us(e) for e in events)
    busy = (f"device busy {busy / 1e3:.2f} ms of a {wall_us / 1e3:.2f} ms profiled prefill "
            f"({100 * busy / wall_us:.1f}%)" if events else
            "device time not measured (the profiler saw no device events)")
    pb, ps = ARCH_PROMPT
    prompt = torch_inputs(arch_batch(cfg, pb, ps, seed=2), dev)
    if "embeds" in prompt:
        gh, gw = ARCH2_SMALL_GRID
        prompt["positions"] = mrope_positions(pb, gh, gw, ps + ARCH_NEW - gh * gw).to(dev)
        (new, _), decode_s = segment("decode", lambda: decode_embeds(
            model, params, prompt["embeds"], prompt["positions"], ARCH_NEW))
    else:
        toks, decode_s = segment("decode", lambda: greedy_decode(
            model, params, prompt["tokens"], ARCH_NEW, ps + ARCH_NEW))
        new = toks[:, ps:]
    return Arch2ServeResult(logits, prefill_s, busy, prompt, new, decode_s, launches)


def check_arch2_serving(res: Arch2ServeResult, cfg) -> dict:
    """Launches as derived (K1 bf16 once per layer a prefill, none in
    decode), finite logits of the right shape, and the greedy tokens in the
    vocabulary.  Returns the launches, summed."""
    total = {}
    for name, got in res.launches.items():
        k1 = attn_layers(cfg) if name.startswith("prefill") else 0
        if got != exactly(got, flash_attention_bf16=k1):
            raise RuntimeError(f"{cfg.name} {name}: launch counts {got}, expected K1 bf16 {k1} only")
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    b, s = ARCH_PREFILL_DEFAULT
    if res.logits.shape != (b, s, cfg.vocab_size) or not bool(torch.isfinite(res.logits).all()):
        raise RuntimeError(f"{cfg.name} prefill logits: shape {tuple(res.logits.shape)} or not finite")
    new = res.new
    if new.shape != (ARCH_PROMPT[0], ARCH_NEW) or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
        raise RuntimeError(f"{cfg.name} decode: tokens of shape {tuple(new.shape)} or out of the vocabulary")
    return total


def check_f32_decode(cfg, params, res: Arch2ServeResult, tag: str = "[archs2]") -> dict:
    """A float32 copy of ``params`` (the served model or its first layer
    groups) decodes the served decode's inputs step by step, its prompt and
    all but the last greedy token, and each step's logits must equal the
    float32 prefill of the same inputs within DECODE_TOL, the reference's
    own prefill / decode tolerance.  Returns the launches (the prefill's
    K1)."""
    cfg32 = replace(cfg, dtype="float32")
    p32 = tree_map(lambda x: x.float(), params)
    model = build_model(cfg32)
    fed = res.new[:, :-1]
    if "embeds" in res.decode_in:
        emb, pos = res.decode_in["embeds"], res.decode_in["positions"]
        (_, got), dec, dec_s = counted(lambda: decode_embeds(model, p32, emb, pos, ARCH_NEW, tokens=fed))
        inputs = {"embeds": torch.cat([emb.float(), p32["embed"]["table"][fed]], dim=1),
                  "positions": pos[:, :emb.shape[1] + fed.shape[1]]}
    else:
        toks = torch.cat([res.decode_in["tokens"], fed], dim=1)
        rec = DecodeLogits(model)
        _, dec, dec_s = counted(lambda: greedy_decode(rec, p32, toks, 1, toks.shape[1] + 1))
        got = rec.logits()
        inputs = {"tokens": toks}
    (want, _), pre, _ = counted(lambda: model.forward(p32, inputs))
    if dec != exactly(dec) or pre != exactly(pre, flash_attention=attn_layers(cfg)):
        raise RuntimeError(f"{cfg.name} float32 decode / prefill launches {dec} / {pre}")
    err = max_diff(got, want)
    if not torch.allclose(got, want, atol=DECODE_TOL, rtol=DECODE_TOL):
        raise RuntimeError(f"{cfg.name} float32 decode at {cfg.num_layers} layers vs its prefill: "
                           f"max abs err {err} beyond {DECODE_TOL}")
    b, n = got.shape[:2]
    log(f"{tag} {cfg.name} float32 copy at {cfg.num_layers} layers: decode of {b} x {n} steps "
        f"({inputs_word(cfg)} prompt, then the served greedy tokens) in {dec_s:.1f} s, every step "
        f"within {DECODE_TOL} of the float32 prefill of the same inputs (max abs err {err:.3e}, "
        f"max|logit| {float(want.abs().max()):.3f}); launches {pre}")
    return pre


def checkpoint_round_trip(tree, name: str, dev, root: str, mode: str = "full") -> dict:
    """``tree`` through the checkpoint lifecycle in ``mode``: a save, the
    feasibility gate on the measured bytes, migrate_job to site B and the
    restore there on the card, each counted (int8: K2 once per float leaf in
    the save and K3 once per float leaf in the restore; nothing else).  The
    restore must be bit-exact: in full mode every leaf equal to the saved
    one (its type and device too), in int8 mode to the CPU plain dequantize
    of the same bytes.  Deletes ``root``.  Returns {"back": the restored
    tree, "launches": summed, "nbytes", "verdict", "save_s", "migrate_s",
    "restore_s", "gap": the restore's max abs distance from ``tree``}."""
    mgr = CheckpointManager(os.path.join(root, "siteA"), job=name, mode=mode)
    _, saved, save_s = counted(lambda: mgr.save(0, tree))
    nbytes = mgr.latest_bytes
    v = feasibility.evaluate(nbytes, BANDWIDTH_BPS, WINDOW_S)
    if not bool(v.feasible):
        raise RuntimeError(f"feasibility gate refused {nbytes} B at {BANDWIDTH_BPS} b/s: {v}")
    (dst, _), moved, migrate_s = counted(lambda: migrate_job(
        mgr, os.path.join(root, "siteB"), bandwidth_bps=BANDWIDTH_BPS, window_s=WINDOW_S))
    (back, _), restored, restore_s = counted(lambda: dst.restore(tree, device=dev))
    floats = sum(1 for _, x in flatten_with_paths(tree)
                 if isinstance(x, torch.Tensor) and x.is_floating_point())
    k2k3 = floats if mode == "int8" else 0
    for what, got, want in (("save", saved, exactly(saved, quantize_int8=k2k3)),
                            ("migrate", moved, exactly(moved)),
                            ("restore", restored, exactly(restored, dequantize_int8=k2k3))):
        if got != want:
            raise RuntimeError(f"{name} {mode} checkpoint {what}: launch counts {got}, expected {want}")
    want = tree if mode == "full" else ser.deserialize_tree(ser.from_bytes(dst.export_bytes()), tree,
                                                           device="cpu")
    gap = 0.0
    for (path, x), (_, y), (_, z) in zip(flatten_with_paths(back), flatten_with_paths(want),
                                         flatten_with_paths(tree)):
        if x.dtype != z.dtype or x.device != z.device or not torch.equal(x, y.to(x.device)):
            raise RuntimeError(f"{name} {mode} restore of {'/'.join(path)}: {x.dtype} on {x.device} "
                               f"(saved {z.dtype} on {z.device}) or not bit-exact")
        if x.is_floating_point():
            gap = max(gap, max_diff(x, z))
    shutil.rmtree(root)
    return {"back": back, "launches": {k: saved[k] + restored[k] for k in saved}, "nbytes": nbytes,
            "verdict": v, "save_s": save_s, "migrate_s": migrate_s, "restore_s": restore_s,
            "gap": gap}


def describe_round_trip(rt: dict, mode: str) -> str:
    v = rt["verdict"]
    exact = ("every leaf bit-identical" if mode == "full" else
             f"bit-identical to the CPU plain dequantize of the same bytes, max abs "
             f"{rt['gap']:.3e} from the saved leaves")
    return (f"{mode} checkpoint {rt['nbytes']} B saved in {rt['save_s']:.3f} s; gate: class "
            f"{int(v.workload_class)}, t_transfer {float(v.t_transfer_s):.4f} s, t_cost "
            f"{float(v.t_cost_s):.4f} s, feasible True; migrate_job {rt['migrate_s']:.3f} s; "
            f"restored on the card at site B in {rt['restore_s']:.3f} s, {exact}")


def run_arch2_checkpoint(cfg, params, dev, work, tag: str = "[archs2]") -> dict:
    """The model cut to one layer group: that group's layers through the
    checkpoint lifecycle (checkpoint_round_trip, full mode; the embedding
    tables, 2.5-3.1 GB of a 32 B model's group and 6-8 s of save, migrate
    and restore on the card machine, are bf16 leaves like the layers'), and
    the prefill with the restored layers bit-identical to the prefill with
    the saved ones (K1 bf16 once an attention layer in each).  Returns the
    launches, summed."""
    cut, p = cut_depth(cfg, params, 1)
    model = build_model(cut)
    inputs = torch_inputs(arch_batch(cut, CARD_CPU_BATCH, ARCH_CARD_CPU_SEQ, seed=5), dev)
    (logits, _), pre, _ = counted(lambda: model.forward(p, inputs))
    rt = checkpoint_round_trip(p["groups"], cut.name, dev, os.path.join(work, cut.name))
    (logits_b, _), pre_b, _ = counted(lambda: model.forward({**p, "groups": rt["back"]}, inputs))
    for what, got in (("prefill", pre), ("prefill restored", pre_b)):
        if got != exactly(got, flash_attention_bf16=attn_layers(cut)):
            raise RuntimeError(f"{cut.name} checkpoint lifecycle {what}: launch counts {got}")
    if not torch.equal(logits_b, logits):
        raise RuntimeError(f"{cut.name}: the prefill from the restored params differs")
    log(f"{tag} {cfg.name} cut to {cut.num_layers} layer(s), its layers: {describe_round_trip(rt, 'full')}, and "
        f"the prefill's logits too; launches: save, migrate, restore none, each prefill K1 bf16 "
        f"{attn_layers(cut)}")
    return {k: pre[k] + pre_b[k] for k in pre}


def gib(n: float) -> str:
    return f"{n / 2 ** 30:.2f} GiB"


def draw_arch(cfg, full, dev, tag: str) -> dict:
    """``cfg``'s params in bf16, drawn on the card from seed 0 by a
    generator on the card, printed with their count, bytes, the draw's time
    and the card's free and peak memory.  The count must equal
    ``param_count``, the analytic count (a copy of the JAX package's),
    where that count is exact: it leaves out the sLSTM blocks' recurrent
    maps (and counts a second norm in every mLSTM and sLSTM block), and an
    encoder-decoder's LayerNorm biases and encoder norm
    (tests/test_torch_xlstm.py, tests/test_torch_encdec.py); there the two
    are printed side by side.  ``full`` is the config whose depth ``cfg``
    may cut."""
    torch.cuda.reset_peak_memory_stats()
    free0, card = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    params = build_model(cfg).init(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    free1, _ = torch.cuda.mem_get_info()
    peak_init = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves = [x for _, x in flatten_with_paths(params)]
    n = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    counted_n = param_count(cfg)
    exact = not (cfg.is_encdec or "slstm" in cfg.block_pattern)
    if n != counted_n and exact:
        raise RuntimeError(f"{cfg.name}: {n} params, param_count says {counted_n}")
    agrees = "param_count agrees" if n == counted_n else f"param_count says {counted_n}"
    depth = (f"{cfg.num_layers} layers" if cfg.num_layers == full.num_layers else
             f"{cfg.num_layers} of its {full.num_layers} layers (the {full.num_layers}-layer "
             f"model's {param_count(full)} params do not fit the card in bf16)")
    log(f"{tag} {cfg.name}: {n} params ({active_param_count(cfg)} active a token; {agrees}), "
        f"{depth}, bf16 weights {nbytes} B, drawn on the card in {init_s:.2f} s; card {card} B, "
        f"free {free0} B before the draw and {free1} B after; peak allocated during the draw "
        f"{peak_init} B ({gib(peak_init)}, {100 * peak_init / card:.1f}% of the card)")
    return params


def log_arch2_serving(res, cfg, tag: str) -> None:
    pb, ps = ARCH_PROMPT
    b, s = ARCH_PREFILL_DEFAULT
    card = torch.cuda.mem_get_info()[1]
    log(f"{tag} {cfg.name} serving at {cfg.num_layers} layers: prefill {b} x {s} {inputs_word(cfg)} "
        f"{res.prefill_s * 1e3:.2f} ms (warm; K1 bf16 {attn_layers(cfg)} launches), {res.busy}; "
        f"greedy decode {pb} x {ps} {inputs_word(cfg)} + {ARCH_NEW}: "
        f"{pb * ARCH_NEW / res.decode_s:.1f} new tok/s ({(ps + ARCH_NEW - 1) / res.decode_s:.1f} "
        f"steps/s, no K1 launch); peak allocated while serving "
        f"{torch.cuda.max_memory_allocated()} B "
        f"({100 * torch.cuda.max_memory_allocated() / card:.1f}% of the card)")
    torch.cuda.reset_peak_memory_stats()


def log_full_sj(cfg, full, params, tag: str) -> None:
    """S_j, the full-mode checkpoint bytes of the full-depth model (the
    served layer groups' bytes extended by the groups left out), through
    the feasibility gate."""
    sj = ser.tree_bytes(params)
    sj_full = sj
    if full.num_layers != cfg.num_layers:
        per_group = ser.tree_bytes(params["groups"]) // cfg.num_groups
        sj_full = sj + (full.num_groups - cfg.num_groups) * per_group
    v = feasibility.evaluate(sj_full, BANDWIDTH_BPS, WINDOW_S)
    served = "" if sj == sj_full else f" (the {cfg.num_layers} layers served: {sj} B)"
    log(f"{tag} {cfg.name} S_j at full depth (full mode): {sj_full} B{served}; gate at "
        f"{BANDWIDTH_BPS:.0e} b/s in a {WINDOW_S:.0f} s window: class {int(v.workload_class)}, "
        f"t_transfer {float(v.t_transfer_s):.2f} s, t_cost {float(v.t_cost_s):.2f} s, "
        f"feasible {bool(v.feasible)}")


def phase_archs2(dev) -> dict:
    """qwen2.5-32b, qwen1.5-32b, phi3.5-moe-42b-a6.6b (24 of 32 layers) and
    qwen2-vl-7b in bf16 at full width, each drawn once on the card: (a)
    served at its served depth, with the full model's S_j and the gate's
    verdict on it; then (b) the first layer groups kept (a contiguous copy)
    and the full model freed: the float32 decode, one group against
    device="cpu", its bf16 decode against its prefill, and its checkpoint
    lifecycle; each model freed before the next, and the card's memory
    checked back at the phase's start; then (c) K1 at their layer shapes.
    Returns the launches of the counted runs, summed."""
    t_phase = time.perf_counter()
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_archs2_") as work:
        for arch in ARCHS2:
            t_arch = time.perf_counter()
            full = get_config(arch)
            cfg = replace(full, num_layers=ARCH2_LAYERS.get(arch, full.num_layers))
            params = draw_arch(cfg, full, dev, "[archs2]")
            res = run_arch2_serving(cfg, params, dev)
            add(check_arch2_serving(res, cfg))
            log_arch2_serving(res, cfg, "[archs2]")
            log_full_sj(cfg, full, params, "[archs2]")

            groups = cfg.num_groups if arch in ARCH2_F32_FULL_DEPTH else ARCH2_F32_GROUPS
            cut, p = cut_depth(cfg, params, min(groups, cfg.num_groups))
            if cut.num_groups < cfg.num_groups:
                # a contiguous copy of the first groups, kept on the host while
                # the full stack is freed: the card never holds both
                p = {**p, "groups": tree_map(lambda x: x.cpu(), p["groups"])}
            del params
            torch.cuda.empty_cache()
            p = {**p, "groups": tree_map(lambda x: x.to(dev), p["groups"])}
            add(check_f32_decode(cut, p, res))
            del res
            if cut.num_groups > 1:  # the one-group checks keep the first group only
                cut, p = cut_depth(cut, p, 1)
                p = {**p, "groups": tree_map(lambda x: x.clone(), p["groups"])}
                torch.cuda.empty_cache()
            add(check_arch_card_vs_cpu(cut, p, dev, tag="[archs2]", seq=ARCH2_CARD_CPU_SEQ))
            add(check_cut_decode(cut, p, dev, tag="[archs2]"))
            add(run_arch2_checkpoint(cut, p, dev, work))
            del p
            check_freed(arch, base, t_arch, "[archs2]")
    check_arch_flash(dev, torch.Generator().manual_seed(3), ARCHS2, "[archs2]")
    CPU_SIDES.finish()
    log(f"[archs2] phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


def check_freed(name: str, base: int, t_arch: float, tag: str) -> None:
    """After a model is freed the card must hold no more than
    ARCH2_LEAK_BYTES beyond ``base``, what it held before the draw."""
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    if left > ARCH2_LEAK_BYTES:
        raise RuntimeError(f"{name}: {left} B still allocated on the card after its model was freed")
    log(f"{tag} {name}: {time.perf_counter() - t_arch:.1f} s in all; peak allocated after serving "
        f"{torch.cuda.max_memory_allocated()} B; freed: {left} B allocated beyond the phase's start, "
        f"{torch.cuda.mem_get_info()[0]} B free")


# ---------------------------------------------------------------------------
# The last three architectures: jamba-v0.1-52b, xlstm-1.3b, whisper-tiny
# ---------------------------------------------------------------------------


def check_mamba_prefill_decode(cfg, params, dev, tag: str = "[archs3]") -> None:
    """jamba's first Mamba mixer (group 0's b0), upcast to float32 at full
    width: apply_mamba over 2 x MAMBA_SEQ tokens against a MAMBA_PREFILL
    prefill (two 256-token chunks) whose state decode carries on
    step by step, within DECODE_TOL of the largest |output|.  No kernel
    runs (the scan is plain PyTorch, as in the JAX package)."""
    p = {k: v[0].float() for k, v in params["groups"]["b0"]["mamba"].items()}
    N = cfg.mamba_d_state
    x = randn(torch.Generator().manual_seed(6), (CARD_CPU_BATCH, MAMBA_SEQ, cfg.d_model), dev)

    def prefill_then_decode():
        head, state = mamba_lib.apply_mamba(p, x[:, :MAMBA_PREFILL], d_state=N, return_state=True)
        steps = [head]
        for t in range(MAMBA_PREFILL, MAMBA_SEQ):
            y, state = mamba_lib.apply_mamba_decode(p, x[:, t:t + 1], state, d_state=N)
            steps.append(y)
        return torch.cat(steps, dim=1)

    with torch.inference_mode():
        whole, c_whole, whole_s = counted(lambda: mamba_lib.apply_mamba(p, x, d_state=N))
        got, c_split, split_s = counted(prefill_then_decode)
    if c_whole != exactly(c_whole) or c_split != exactly(c_split):
        raise RuntimeError(f"Mamba mixer launches {c_whole} / {c_split}, expected none")
    err, top = max_diff(got, whole), float(whole.abs().max())
    if not err <= DECODE_TOL * top:
        raise RuntimeError(f"{cfg.name} Mamba float32: prefill {MAMBA_PREFILL} + decode vs the forward "
                           f"over {MAMBA_SEQ} tokens: max abs err {err} beyond {DECODE_TOL} x {top}")
    log(f"{tag} {cfg.name} Mamba mixer (group 0, b0) in float32 at full width: forward over "
        f"{CARD_CPU_BATCH} x {MAMBA_SEQ} tokens (2 chunks of {MAMBA_SEQ // 2}) in {whole_s * 1e3:.1f} ms; "
        f"a {MAMBA_PREFILL}-token prefill (2 chunks of 256) and {MAMBA_SEQ - MAMBA_PREFILL} decode "
        f"steps from its conv and SSM state in {split_s * 1e3:.1f} ms, within {DECODE_TOL} x "
        f"max|y| ({top:.4f}) of it (max abs err {err:.3e}, {100 * err / (DECODE_TOL * top):.1f}%); "
        f"no kernel launch")


def check_block_card_vs_cpu(cfg, params, i: int, dev, tag: str = "[archs3]") -> dict:
    """Group 0's block b<i> alone (tfm.apply_block, bf16, full width) on
    CARD_CPU_BATCH x ARCH2_CARD_CPU_SEQ seeded activations, on the card
    against device="cpu": the output within CARD_CPU_BF16_TOL of the
    largest |output| and the gradients of sum(output x a seeded cotangent)
    (plus an MoE block's aux loss) for the input and every leaf, each within
    CARD_CPU_BF16_TOL of its largest element.  An MoE block's CPU side is
    routed as the card (expert_choice).  Returns the card's launches: an
    attention block K1 and its backward once each in bf16."""
    kind, blk = cfg.block_pattern[i], f"b{i}"
    p = {k: v for k, v in tree_map(lambda x: x[0], params["groups"][blk]).items()}
    gen = torch.Generator().manual_seed(10 + i)
    shape = (CARD_CPU_BATCH, ARCH2_CARD_CPU_SEQ, cfg.d_model)
    x, cot = randn(gen, shape, "cpu").to(torch.bfloat16), randn(gen, shape, "cpu")
    positions = torch.arange(shape[1]).expand(shape[:2])

    def run(p, x, cot, positions):
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), p)
            xi = x.detach().requires_grad_(True)
            out, aux = tfm.apply_block(live, xi, kind, cfg, positions)
            loss = (out.float() * cot).sum() + (aux if aux is not None else 0.0)
            paths, leaves = zip(*flatten_with_paths(live))
            grads = torch.autograd.grad(loss, (xi, *leaves))
        return out.detach(), dict(zip((("x",), *paths), grads))

    routes = []
    with expert_choice(routes) if "moe" in p else contextlib.nullcontext():
        (out, g_card), counts, card_s = counted(lambda: run(p, x.to(dev), cot.to(dev),
                                                            positions.to(dev)))
    k1 = 1 if kind.startswith("attn") else 0
    if counts != exactly(counts, flash_attention_bf16=k1, flash_attention_bwd_bf16=k1):
        raise RuntimeError(f"{cfg.name} {blk} ({kind}) card step launches {counts}")
    t0 = time.perf_counter()
    force = routes[0] if routes else None
    with expert_choice([], force=force) if force is not None else contextlib.nullcontext():
        want, g_cpu = run(tree_map(lambda t: t.cpu(), p), x, cot, positions)
    cpu_s = time.perf_counter() - t0
    shares = {"output": leaf_share(out, want.float(), CARD_CPU_BF16_TOL)}
    shares.update({"/".join(path): leaf_share(g, g_cpu[path].float(), CARD_CPU_BF16_TOL)
                   for path, g in g_card.items()})
    worst = max(shares, key=shares.get)
    if not shares[worst] <= 1.0:
        raise RuntimeError(f"{cfg.name} {blk} ({kind}) on the card vs the CPU: {worst} "
                           f"{100 * shares[worst]:.1f}% of {CARD_CPU_BF16_TOL} x its max")
    routed = ", the CPU routed as the card" if force is not None else ""
    log(f"{tag} {cfg.name} block {blk} ({kind}{' + MoE' if 'moe' in p else ''}) at full width in bf16, "
        f"{shape[0]} x {shape[1]} activations, card ({card_s:.2f} s) vs device='cpu' ({cpu_s:.1f} s"
        f"{routed}): output {100 * shares['output']:.1f}% of {CARD_CPU_BF16_TOL} x max|output|, "
        f"{len(g_card)} gradients (the input and every leaf) each within it, at most "
        f"{100 * shares[worst]:.1f}% ({worst}); launches {counts}")
    return counts


def run_jamba(dev, work, base: int) -> dict:
    """jamba-v0.1-52b at 2 of its 4 groups in bf16: (a) served (prefill 2 x
    512, greedy decode 2 x 32 + 16), S_j of the full depth through the gate;
    (b) its first Mamba mixer's prefill and decode in float32, and blocks
    b0, b1, b4 on the card against device="cpu"; (c) a full checkpoint
    lifecycle of group 0's b0 / b1 subtree (bf16 leaves beside the float32
    A_log and D), b1's MoE experts left out (JAMBA_CKPT_DROP).  Returns the
    launches, summed."""
    t_arch = time.perf_counter()
    full = get_config(ARCHS3[0])
    cfg = replace(full, num_layers=ARCH3_LAYERS[ARCHS3[0]])
    params = draw_arch(cfg, full, dev, "[archs3]")
    res = run_arch2_serving(cfg, params, dev)
    total = check_arch2_serving(res, cfg)
    log_arch2_serving(res, cfg, "[archs3]")
    log_full_sj(cfg, full, params, "[archs3]")
    del res
    check_mamba_prefill_decode(cfg, params, dev)
    for i in JAMBA_BLOCKS:
        counts = check_block_card_vs_cpu(cfg, params, i, dev)
        total = {k: total[k] + counts[k] for k in total}
    sub = tree_map(lambda x: x[0], {blk: params["groups"][blk] for blk in ("b0", "b1")})
    sub["b1"]["moe"] = {k: v for k, v in sub["b1"]["moe"].items() if k not in JAMBA_CKPT_DROP}
    f32 = sorted("/".join(path) for path, x in flatten_with_paths(sub) if x.dtype == torch.float32)
    rt = checkpoint_round_trip(sub, f"{cfg.name}-group0-b0b1", dev, os.path.join(work, "jamba"))
    log(f"[archs3] {cfg.name} group 0's b0 / b1 subtree (bf16, and float32 {', '.join(f32)}): "
        f"{describe_round_trip(rt, 'full')}; launches none")
    del sub, rt, params
    check_freed(cfg.name, base, t_arch, "[archs3]")
    return total


def time_slstm(cfg, params, dev) -> float:
    """The first sLSTM layer's sequential scan over CARD_CPU_BATCH x
    SLSTM_TIME_SEQ tokens on the card, warm: wall ms per token.  The loop
    launches ~25 small kernels a token and waits on the host, so its wall
    is the number (CUDA events paced ahead of it cannot be: the host
    enqueues for longer than any spin)."""
    i = cfg.block_pattern.index("slstm")
    p = tree_map(lambda x: x[0], params["groups"][f"b{i}"]["slstm"])
    n = SLSTM_TIME_SEQ
    x = randn(torch.Generator().manual_seed(7), (CARD_CPU_BATCH, n, cfg.d_model), dev).to(
        torch.bfloat16)
    with torch.inference_mode():
        scan = lambda: xlstm_lib._slstm_scan(p, x, cfg.num_heads)  # noqa: E731
        counted(scan)
        _, _, wall = counted(scan)
    return 1e3 * wall / n


def run_xlstm(dev, work, base: int) -> dict:
    """xlstm-1.3b whole in bf16: (a) served (prefill 2 x 512, greedy decode
    2 x 32 + 16), S_j through the gate, the sLSTM loop's time per token;
    (b) a float32 copy decodes the served inputs, held to its prefill; (c)
    one layer group against device="cpu" (check_xlstm_card_vs_cpu); (d)
    that group's training lifecycle through Trainer, migrated against
    unmigrated, and an int8 save and restore of its sLSTM block's params.
    Returns the launches, summed (no K1: xlstm has no attention;
    K2 and K3 in (d))."""
    t_arch = time.perf_counter()
    cfg = get_config(ARCHS3[1])
    params = draw_arch(cfg, cfg, dev, "[archs3]")
    res = run_arch2_serving(cfg, params, dev)
    total = check_arch2_serving(res, cfg)
    log_arch2_serving(res, cfg, "[archs3]")
    log_full_sj(cfg, cfg, params, "[archs3]")
    log(f"[archs3] {cfg.name} sLSTM scan (one layer, {CARD_CPU_BATCH} x {SLSTM_TIME_SEQ} tokens, bf16, "
        f"warm): {time_slstm(cfg, params, dev):.3f} ms a token wall-clock "
        f"({cfg.num_groups * cfg.block_pattern.count('slstm')} such layers)")
    for counts in (check_f32_decode(cfg, params, res, tag="[archs3]"),
                   check_xlstm_card_vs_cpu(cfg, params, dev)):
        total = {k: total[k] + counts[k] for k in total}
    del res, params
    torch.cuda.empty_cache()
    cut = replace(cfg, num_layers=len(cfg.block_pattern))
    d = os.path.join(work, "xlstm")
    life = run_train_lifecycle(cut, d, mode="full", grad_compress=False, device=dev,
                               batch=XLSTM_LIFE_BATCH, seq=XLSTM_LIFE_SEQ, steps=XLSTM_LIFE_STEPS,
                               preempt=XLSTM_LIFE_PREEMPT, save_every=XLSTM_LIFE_SAVE_EVERY)
    counts = check_train_lifecycle(life, tag="[archs3]")
    total = {k: total[k] + counts[k] for k in total}
    blk = f"b{cfg.block_pattern.index('slstm')}"
    sub = group_params(life.state_a["params"], [blk])
    rt = checkpoint_round_trip(sub, f"{cut.name}-{blk}", dev, os.path.join(d, "int8"), mode="int8")
    log(f"[archs3] {cut.name} {blk} (sLSTM) params at step {life.preempt}: "
        f"{describe_round_trip(rt, 'int8')}; launches {rt['launches']}, as derived")
    total = {k: total[k] + rt["launches"][k] for k in total}
    del life, sub, rt
    shutil.rmtree(d)
    check_freed(cfg.name, base, t_arch, "[archs3]")
    return total


def check_xlstm_card_vs_cpu(cfg, params, dev, tag: str = "[archs3]") -> dict:
    """xlstm cut to one layer group (7 mLSTM + 1 sLSTM) at full width on 2 x
    ARCH2_CARD_CPU_SEQ tokens, card against device="cpu".  In bf16 the
    forward's logits land 1.02x CARD_CPU_BF16_TOL x max|logit| apart (the
    first run on the H100): the mLSTM's h = num / max(|den|, e^-m) and the
    sLSTM's 32 steps, each rounding h to bf16, carry the two sides'
    different bf16 roundings through eight blocks, as a full depth of
    attention layers does (check_arch_decode).  So the bf16 forward is
    reported, each side against the float32 forward on the CPU, and the
    one-group forward and a train step are held in float32: the logits
    within MODEL_TOL, the step by check_card_vs_cpu.  No kernel runs.
    Returns the launches."""
    cut, p = cut_depth(cfg, params, 1)
    seq = ARCH2_CARD_CPU_SEQ
    batch = arch_batch(cut, CARD_CPU_BATCH, seq, seed=0)
    inputs = torch_inputs(batch)
    (card, _), counts, _ = counted(lambda: build_model(cut).forward(p, torch_inputs(batch, dev)))
    host = tree_map(lambda x: x.cpu(), p)
    plain, _ = build_model(cut).forward(host, inputs)
    cut32 = replace(cut, dtype="float32")
    p32 = tree_map(lambda x: x.float(), host)
    model32 = build_model(cut32)
    exact, _ = model32.forward(p32, inputs)
    (card32, _), counts32, _ = counted(lambda: model32.forward(
        tree_map(lambda x: x.to(dev), p32), torch_inputs(batch, dev)))
    for c in (counts, counts32):
        if c != exactly(c):
            raise RuntimeError(f"{cut.name} forward launches {c}, expected none")
    err32 = max_diff(card32, exact)
    if not torch.allclose(card32.cpu(), exact, atol=MODEL_TOL, rtol=MODEL_TOL):
        raise RuntimeError(f"{cut.name} float32 forward on the card vs the CPU: max abs err {err32} "
                           f"beyond {MODEL_TOL}")
    top = float(exact.abs().max())
    log(f"{tag} {cfg.name} cut to {cut.num_layers} layers at full width, {CARD_CPU_BATCH} x {seq} "
        f"tokens: float32 forward on the card within {MODEL_TOL} of device='cpu' (max abs err "
        f"{err32:.3e}, max|logit| {top:.3f}); bf16 forward, card vs CPU {max_diff(card, plain):.3e} "
        f"({100 * max_diff(card, plain) / (CARD_CPU_BF16_TOL * float(plain.float().abs().max())):.1f}% "
        f"of {CARD_CPU_BF16_TOL} x max|logit|, not held), from the float32 forward: card "
        f"{max_diff(card.cpu(), exact):.3e}, plain {max_diff(plain, exact):.3e}; launches none")
    check_card_vs_cpu(cut32, p32, dev, seq=seq, steps=1, tag=f"{tag} float32,")
    return counts


class EncDecServing(DecodeLogits):
    """An encoder-decoder Model as greedy_decode drives it: its cache comes
    from encdec_init_cache over ``frames`` (the encoder, then each decoder
    layer's cross K / V), and each step's logits are kept."""

    def __init__(self, model, params, frames):
        super().__init__(model)
        self.params, self.frames = params, frames

    def init_cache(self, batch: int, max_len: int, device=None):
        with torch.inference_mode():
            return encdec_lib.encdec_init_cache(self.params, self.frames, self.model.cfg, batch,
                                                max_len)


def run_whisper(dev, work, base: int) -> dict:
    """whisper-tiny whole in bf16: (a) encode 2 x 1,500 frames (K1 with a
    full mask, a ragged last tile), then encdec_init_cache and greedy
    decode 2 x 32 + 16; (b) a float32 copy's decode of the same tokens held
    to its decode_train; (c) forward and a train step on the card against
    device="cpu" (K1's backward at the encoder's shape); (d) full and int8
    checkpoint lifecycles.  Returns the launches, summed."""
    t_arch = time.perf_counter()
    cfg = get_config(ARCHS3[2])
    params = draw_arch(cfg, cfg, dev, "[archs3]")
    model = build_model(cfg)
    pb, ps = ARCH_PROMPT
    inputs = torch_inputs(arch_batch(cfg, pb, ps, seed=2), dev)
    frames, prompt = inputs["frames"], inputs["tokens"]
    with torch.inference_mode():
        enc, c_enc, _ = counted(lambda: encdec_lib.encode(params, frames, cfg))
        _, c_enc2, enc_s = counted(lambda: encdec_lib.encode(params, frames, cfg))
    rec = EncDecServing(model, params, frames)
    toks, c_dec, dec_s = counted(lambda: greedy_decode(rec, params, prompt, ARCH_NEW, ps + ARCH_NEW))
    for what, got, k1 in (("encode", c_enc, cfg.encoder_layers), ("encode again", c_enc2, cfg.encoder_layers),
                          ("decode", c_dec, cfg.encoder_layers)):
        if got != exactly(got, flash_attention_bf16=k1):
            raise RuntimeError(f"{cfg.name} {what}: launch counts {got}, expected K1 bf16 {k1} only")
    if enc.shape != frames.shape or not bool(torch.isfinite(enc).all()):
        raise RuntimeError(f"{cfg.name} encoder output {tuple(enc.shape)} or not finite")
    new = toks[:, ps:]
    if toks.shape != (pb, ps + ARCH_NEW) or not torch.equal(toks[:, :ps], prompt) or \
            int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
        raise RuntimeError(f"{cfg.name} decode: tokens {tuple(toks.shape)}, prompt lost or out of the vocabulary")
    total = {k: c_enc[k] + c_enc2[k] + c_dec[k] for k in c_enc}
    log(f"[archs3] {cfg.name} serving: encode {pb} x {cfg.encoder_seq} frames {enc_s * 1e3:.2f} ms "
        f"(warm; K1 bf16 {cfg.encoder_layers} launches, full mask); encdec_init_cache and greedy decode "
        f"{pb} x {ps} + {ARCH_NEW} tokens in {dec_s:.3f} s ({pb * ARCH_NEW / dec_s:.1f} new tok/s, "
        f"{(ps + ARCH_NEW - 1) / dec_s:.1f} steps/s; K1 only in the cache's encode)")
    log_full_sj(cfg, cfg, params, "[archs3]")

    # (b) the float32 copy: step-by-step decode of the served tokens but the
    # last, against decode_train of the same tokens
    cfg32 = replace(cfg, dtype="float32")
    p32 = tree_map(lambda x: x.float(), params)
    model32 = build_model(cfg32)
    fed = toks[:, :-1]
    rec32 = EncDecServing(model32, p32, frames)
    _, dec32, dec32_s = counted(lambda: greedy_decode(rec32, p32, fed, 1, fed.shape[1] + 1))
    (want, _), pre32, _ = counted(lambda: model32.forward(p32, {"frames": frames, "tokens": fed}))
    if dec32 != exactly(dec32, flash_attention=cfg.encoder_layers) or \
            pre32 != exactly(pre32, flash_attention=attn_layers(cfg)):
        raise RuntimeError(f"{cfg.name} float32 decode / forward launches {dec32} / {pre32}")
    got = rec32.logits()
    err = max_diff(got, want)
    if not torch.allclose(got, want, atol=DECODE_TOL, rtol=DECODE_TOL):
        raise RuntimeError(f"{cfg.name} float32 decode vs decode_train: max abs err {err} beyond "
                           f"{DECODE_TOL}")
    log(f"[archs3] {cfg.name} float32 copy: decode of {pb} x {fed.shape[1]} tokens (the served ones) "
        f"in {dec32_s:.1f} s, every step within {DECODE_TOL} of decode_train of the same tokens "
        f"(max abs err {err:.3e}, max|logit| {float(want.abs().max()):.3f}); launches {pre32}")
    for counts in (dec32, pre32):
        total = {k: total[k] + counts[k] for k in total}
    del p32, rec32, want, got

    counts = check_arch_card_vs_cpu(cfg, params, dev, tag="[archs3]", seq=ARCH_PROMPT[1])
    total = {k: total[k] + counts[k] for k in total}
    for mode in ("full", "int8"):
        rt = checkpoint_round_trip(params, cfg.name, dev, os.path.join(work, f"whisper-{mode}"), mode=mode)
        log(f"[archs3] {cfg.name}: {describe_round_trip(rt, mode)}; launches {rt['launches']}, as derived")
        total = {k: total[k] + rt["launches"][k] for k in total}
    del params, rt
    check_freed(cfg.name, base, t_arch, "[archs3]")
    return total


def phase_archs3(dev) -> dict:
    """jamba-v0.1-52b (16 of 32 layers), xlstm-1.3b and whisper-tiny in
    bf16 at full width, each drawn once on the card from seed 0 and freed
    before the next (run_jamba, run_xlstm, run_whisper); then K1 and its
    backward at jamba's and whisper's layer shapes.  Returns the launches
    of the counted runs, summed."""
    t_phase = time.perf_counter()
    total = {}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_archs3_") as work:
        for run in (run_jamba, run_xlstm, run_whisper):
            for k, n in run(dev, work, base).items():
                total[k] = total.get(k, 0) + n
    check_arch_flash(dev, torch.Generator().manual_seed(3), ARCHS3, "[archs3]")
    CPU_SIDES.finish()
    log(f"[archs3] phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# [mesh]: the sharding layer on a real 1 x 1 mesh (DTensors on the card)
# ---------------------------------------------------------------------------

MESH_STEPS, MESH_PREEMPT = 8, 4  # micro-lm: site A to step 4, site B (on the mesh) to 8
MESH_ARCH = "qwen3-1.7b"
MESH_PREFILL_BATCH, MESH_PREFILL_SEQ = 2, 512
MESH_PROMPT, MESH_NEW = 16, 8  # greedy decode of 2 x 16 prompt tokens + 8 new
MESH_DRYRUN = ("qwen3-1.7b", "decode_32k", "single")
# the recurrent mixers on channel blocks, at train_4k's sequence (16 Mamba
# / mLSTM chunks), and an attention block beside them: (arch, block)
MESH_BLOCKS = (("jamba-v0.1-52b", 0), ("jamba-v0.1-52b", 4), ("xlstm-1.3b", 0))
MESH_BLOCK_SEQ = 4096


def shard_tree(tree, mesh, rules=None):
    """Every leaf of a param tree placed on ``mesh`` by ``param_pspecs``
    under ``rules`` (each rank keeps its shard of the same tensor)."""
    specs = param_pspecs(tree, rules, mesh)

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(x[k], spec[k]) for k in x}
        return distribute_tensor(x, mesh, placements(spec, mesh), src_data_rank=None)

    return place(tree, specs)


def full_values(tree):
    """A tree's leaves as whole tensors (DTensors gathered)."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def same_leaves(what: str, got, want) -> int:
    """Every leaf of ``got`` (gathered) bit-identical to ``want``'s; returns
    the count of leaves."""
    want_of = dict(flatten_with_paths(want))
    n = 0
    for path, x in flatten_with_paths(full_values(got)):
        y = want_of[path]
        if isinstance(x, torch.Tensor) and not torch.equal(x, torch.as_tensor(y).to(x.device)):
            raise RuntimeError(f"{what}: leaf {'/'.join(path)} differs, max abs "
                               f"{float((x.float() - y.float()).abs().max())}")
        n += 1
    return n


def run_mesh_lifecycle(mesh, dev, work) -> dict:
    """micro-lm at full width: site A trains unsharded to step MESH_PREEMPT
    and is preempted (a full save), migrate_job, then site B restores onto
    the 1 x 1 mesh (``Trainer.restore(shardings=...)``, the elastic
    restore) and trains on DTensors to MESH_STEPS; the final state must be
    bit-identical to an unmigrated, unsharded run's.  Each stretch is
    counted against ``train_launches``.  Returns the launches."""
    cfg = get_config("micro-lm")
    kw = dict(mode="full", grad_compress=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev)
    launches = {}

    def segment(name, fn, expect):
        out, got, wall = counted(fn)
        if got != expect():
            raise RuntimeError(f"[mesh] micro-lm {name}: launch counts {got}, expected {expect()}")
        launches[name] = got
        return out, wall

    ref_tr = make_trainer(cfg, os.path.join(work, "unmigrated"), steps=MESH_STEPS,
                          save_every=MESH_STEPS + 1, **kw)
    segment("unmigrated", ref_tr.run, lambda: train_launches(
        cfg, ref_tr, steps=MESH_STEPS, saves=1))
    a = make_trainer(cfg, os.path.join(work, "siteA"), steps=MESH_STEPS, save_every=MESH_STEPS + 1,
                     preempt_at=MESH_PREEMPT, **kw)
    status_a, run_a_s = segment("site A", a.run, lambda: train_launches(
        cfg, a, steps=MESH_PREEMPT, saves=1))
    if status_a["status"] != "preempted" or status_a["step"] != MESH_PREEMPT:
        raise RuntimeError(f"[mesh] site A: {status_a}")
    dst, _ = migrate_job(a.ckpt, os.path.join(work, "siteB"), bandwidth_bps=BANDWIDTH_BPS,
                         window_s=WINDOW_S)
    b = make_trainer(cfg, os.path.join(work, "siteB"), steps=MESH_STEPS, save_every=MESH_STEPS + 1,
                     **kw)
    b.ckpt = dst
    b.init_state()
    shardings = named_shardings(param_pspecs(b.state_tree(), mesh=mesh), mesh)
    step, restore_s = segment("site B restore", lambda: b.restore(shardings=shardings),
                              lambda: train_launches(cfg, b, steps=0, restores=1))
    if step != MESH_PREEMPT:
        raise RuntimeError(f"[mesh] site B restored step {step}, expected {MESH_PREEMPT}")
    kinds = {type(x).__name__ for _, x in flatten_with_paths(b.params)}
    if kinds != {"DTensor"}:
        raise RuntimeError(f"[mesh] restored params are {kinds}, not DTensors")
    n0 = same_leaves("[mesh] state restored onto the mesh vs site A's",
                     {"params": b.params, "opt": b.opt_state}, {"params": a.params, "opt": a.opt_state})
    status_b, run_b_s = segment("site B on the mesh", b.run, lambda: train_launches(
        cfg, b, steps=MESH_STEPS - MESH_PREEMPT, saves=1))
    if status_b["step"] != MESH_STEPS:
        raise RuntimeError(f"[mesh] site B: {status_b}")
    n = same_leaves("[mesh] migrated, sharded final state vs the unmigrated, unsharded run's",
                    {"params": b.params, "opt": b.opt_state},
                    {"params": ref_tr.params, "opt": ref_tr.opt_state})
    if open(b.ckpt.latest.path, "rb").read() != open(ref_tr.ckpt.latest.path, "rb").read():
        raise RuntimeError("[mesh] site B's checkpoint of the sharded state differs from the "
                           "unmigrated run's bytes")
    losses = [row["loss"] for row in a.history + b.history]
    log(f"[mesh] micro-lm lifecycle: site A {MESH_PREEMPT} steps unsharded ({run_a_s:.2f} s), "
        f"full save, migrate_job, Trainer.restore(shardings=...) onto the 1 x 1 mesh "
        f"({restore_s:.3f} s; {n0} leaves equal to site A's), site B "
        f"{MESH_STEPS - MESH_PREEMPT} steps on DTensors ({run_b_s:.2f} s); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; all {n} leaves of params and optimizer state bit-identical to the "
        f"unmigrated, unsharded run's, and its final checkpoint ({b.ckpt.latest.nbytes} B) "
        f"byte-identical")
    for name, got in launches.items():
        log(f"[mesh]   {name}: launches {got}, as derived")
    total = {}
    for got in launches.values():
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    return total


def run_mesh_qwen3(mesh, dev) -> dict:
    """qwen3-1.7b in bf16, drawn on the card: the prefill of 2 x 512 tokens
    on the mesh under the baseline rules and a greedy decode under
    decode-tp, each bit-identical to the same call unsharded; the sharded
    calls counted (K1 bf16 once a layer in the prefill, none in decode).
    Returns their launches."""
    cfg = get_config(MESH_ARCH)
    model = build_model(cfg)
    params = model.init(device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    data = SyntheticLMDataset(cfg.vocab_size, MESH_PREFILL_SEQ, MESH_PREFILL_BATCH, seed=5)
    host = data.batch(0)
    toks = torch.from_numpy(host["tokens"]).to(dev)
    names = tuple(mesh.mesh_dim_names)
    want, _ = model.forward(params, {"tokens": toks})
    with use_rules(get_strategy("baseline")), force_mesh_axes(names):
        dparams = shard_tree(params, mesh)
        dbatch = make_global_batch({"tokens": host["tokens"]}, mesh,
                                   {"tokens": logical_spec("batch", "seq")})
        (got, _), pre, pre_s = counted(lambda: model.forward(dparams, dbatch))
    if not isinstance(got, DTensor) or not torch.equal(got.full_tensor(), want):
        raise RuntimeError(f"[mesh] {cfg.name} sharded prefill differs from the unsharded one")
    if pre != exactly(pre, flash_attention_bf16=attn_layers(cfg)):
        raise RuntimeError(f"[mesh] {cfg.name} sharded prefill launches {pre}")
    del dparams, got, want
    prompt = toks[:, :MESH_PROMPT]
    cache_len = MESH_PROMPT + MESH_NEW

    def decode(p, cache):
        tok, outs, logits_all = prompt[:, 0], [prompt[:, 0]], []
        for i in range(cache_len - 1):
            logits, cache = model.decode_step(p, cache, {"token": tok, "index": i})
            logits = logits.full_tensor() if isinstance(logits, DTensor) else logits
            logits_all.append(logits)
            nxt = torch.argmax(logits, dim=-1).to(prompt.dtype)
            tok = prompt[:, i + 1] if i + 1 < MESH_PROMPT else nxt
            outs.append(tok)
        return torch.stack(outs, 1), torch.stack(logits_all, 1)

    want_toks, want_logits = decode(params, model.init_cache(prompt.shape[0], cache_len, device=dev))
    with use_rules(get_strategy("decode-tp")), force_mesh_axes(names):
        dparams = shard_tree(params, mesh)
        specs, pspecs = model.cache_specs(prompt.shape[0], cache_len)
        zeros = tfm.zeros_like_specs(specs, dev)
        cache = {blk: {k: distribute_tensor(zeros[blk][k], mesh, placements(
            logical_spec(*pspecs[blk][k]), mesh), src_data_rank=None) for k in zeros[blk]}
            for blk in zeros}
        (got_toks, got_logits), dec, dec_s = counted(lambda: decode(dparams, cache))
    if not (torch.equal(got_toks, want_toks) and torch.equal(got_logits, want_logits)):
        raise RuntimeError(f"[mesh] {cfg.name} sharded decode differs from the unsharded one")
    if dec != exactly(dec):
        raise RuntimeError(f"[mesh] {cfg.name} sharded decode launches {dec}")
    log(f"[mesh] {cfg.name} bf16 on the 1 x 1 mesh: prefill of {MESH_PREFILL_BATCH} x "
        f"{MESH_PREFILL_SEQ} tokens under the baseline rules ({pre_s * 1e3:.1f} ms, first call) "
        f"and greedy decode of {prompt.shape[0]} x {MESH_PROMPT} + {MESH_NEW} tokens under decode-tp "
        f"({dec_s:.2f} s, {(cache_len - 1) / dec_s:.1f} steps/s) bit-identical to the same calls "
        f"unsharded; launches: prefill {pre}, decode none")
    del dparams, params, cache
    torch.cuda.empty_cache()
    return pre


def run_mesh_blocks(mesh, dev) -> dict:
    """Each of MESH_BLOCKS drawn on the card at full width in bf16: its
    forward and backward over 1 x MESH_BLOCK_SEQ tokens unsharded, then on
    the 1 x 1 mesh (Mamba and the mLSTM through on_channel_shards, the
    attention through K1 on local shards), the output and the gradients of
    x and of every param bit-identical; each run counted (K1 bf16 and its
    backward once in an attention block) and its peak allocated memory
    printed.  Returns the launches."""
    total = {}
    names = tuple(mesh.mesh_dim_names)
    for arch, i in MESH_BLOCKS:
        cfg = get_config(arch)
        kind = cfg.block_pattern[i]
        gen = torch.Generator(device=dev).manual_seed(40 + i)
        p = tfm.init_block(gen, cfg, kind, tfm._is_moe_pos(cfg, i), dev)
        x = torch.randn((1, MESH_BLOCK_SEQ, cfg.d_model), generator=gen, device=dev).to(
            torch.bfloat16)
        cot = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
        positions = torch.arange(MESH_BLOCK_SEQ, device=dev)[None]
        expect = (dict(flash_attention_bf16=1, flash_attention_bwd_bf16=1)
                  if kind.startswith("attn") else {})

        def run(p, x, cot):
            live = tree_map(lambda t: t.detach().requires_grad_(True), p)
            xl = x.detach().requires_grad_(True)
            with torch.enable_grad(), mesh_scope(live):
                out, _ = tfm.apply_block(live, xl, kind, cfg, positions)
                leaves = [t for _, t in flatten_with_paths(live)]
                grads = torch.autograd.grad(out, [xl] + leaves, grad_outputs=cot)
            return [out.detach()] + list(grads)

        def measured(fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out, counts, wall = counted(fn)
            if counts != exactly(counts, **expect):
                raise RuntimeError(f"[mesh] {arch} b{i} ({kind}): launch counts {counts}, "
                                   f"expected {expect or 'none'}")
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            return out, counts, wall, torch.cuda.max_memory_allocated() - before

        want, counts, wall_u, peak_u = measured(lambda: run(p, x, cot))
        with force_mesh_axes(names):
            dp = shard_tree({"b": p}, mesh)["b"]
            dx = distribute_tensor(x, mesh, placements(logical_spec("batch", "seq", None), mesh),
                                   src_data_rank=None)
        got, _, wall_d, peak_d = measured(lambda: run(dp, dx, DTensor.from_local(
            cot, mesh, dx.placements, run_check=False)))
        got = [g.full_tensor() if isinstance(g, DTensor) else g for g in got]
        for j, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                what = "output" if j == 0 else "grad of x" if j == 1 else f"grad {j - 2}"
                raise RuntimeError(f"[mesh] {arch} b{i} ({kind}) on the mesh: its {what} differs "
                                   f"from unsharded by {float((a.float() - b.float()).abs().max())}")
        log(f"[mesh] {arch} block b{i} ({kind}) in bf16, forward and backward over 1 x "
            f"{MESH_BLOCK_SEQ} tokens: unsharded {wall_u:.3f} s, peak allocated {gib(peak_u)}; on "
            f"the 1 x 1 mesh {wall_d:.3f} s, peak allocated {gib(peak_d)}; output and all "
            f"{len(want) - 1} gradients bit-identical; launches {counts} each")
        del p, dp, want, got
        torch.cuda.empty_cache()
    return total


def run_mesh_crosspod(dev) -> dict:
    """crosspod_allgather_mean_int8 over micro-lm's gradients on a (1, 1, 1)
    ('pod', 'data', 'model') mesh: bit-identical to compress_roundtrip (one
    pod), counted (K2 once per float leaf of at least one block, K3 once per
    such leaf and pod).  Returns its launches."""
    cfg = get_config("micro-lm")
    model = build_model(cfg)
    params = model.init(3, device=dev)
    host = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, CARD_CPU_BATCH, seed=2).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    _, grads = value_and_grad(model, params, batch, "full")
    pods = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    want = compress_roundtrip(grads)
    got, counts, wall = counted(lambda: crosspod_allgather_mean_int8(grads, pods))
    n = same_leaves("[mesh] crosspod_allgather_mean_int8 vs compress_roundtrip", got, want)
    big = sum(1 for _, g in flatten_with_paths(grads) if g.is_floating_point() and g.numel() >= 256)
    if counts != exactly(counts, quantize_int8=big, dequantize_int8=big):
        raise RuntimeError(f"[mesh] crosspod launches {counts}, expected {big} K2 and {big} K3")
    log(f"[mesh] crosspod_allgather_mean_int8 over micro-lm's gradients on a (1, 1, 1) pod mesh "
        f"({wall * 1e3:.1f} ms): all {n} leaves bit-identical to compress_roundtrip; launches "
        f"{counts}, as derived")
    return counts


def start_mesh_dryrun():
    """Start ``python -m repro_torch.launch.dryrun`` on one cell in its own
    process (its fake 256-rank world is process-global; it traces with
    fake tensors and launches nothing, so it runs beside the phase's card
    work).  Returns (the process, its start time, its record's path)."""
    arch, shape, mesh = MESH_DRYRUN
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out_dir = os.path.join(HERE, "build", "dryrun")
    path = dryrun_launcher.artifact_path(out_dir, "baseline", mesh, arch, shape)
    if os.path.exists(path):
        os.remove(path)
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape, "--mesh", mesh, "--out", out_dir],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return proc, time.perf_counter(), path


def check_mesh_dryrun(started) -> dict:
    """The dry-run cell's record: status OK and a peak per device under the
    card's memory.  Returns the record."""
    proc, t0, path = started
    arch, shape, mesh = MESH_DRYRUN
    out, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(path):
        raise RuntimeError(f"[mesh] dryrun {arch} {shape} exited {proc.returncode}: "
                           f"{out[-1500:]} {err[-1500:]}")
    with open(path) as f:
        rec = json.load(f)
    card = torch.cuda.get_device_properties(0).total_memory
    if rec["status"] != "OK" or not rec["memory"]["peak_bytes"] < card:
        raise RuntimeError(f"[mesh] dryrun {arch} {shape}: {rec}")
    log(f"[mesh] dryrun {arch} {shape} on the {mesh} mesh ({rec['n_chips']} fake ranks, "
        f"{rec['device']} fake tensors; its process ran {wall:.1f} s beside the phase, the trace "
        f"{rec['lower_compile_s']} s): {rec['status']}; per device "
        f"{rec['hlo_flops_per_device']:.4e} FLOP, {rec['hlo_bytes_per_device']:.4e} B (unfused), "
        f"collectives {rec['collectives']}, arguments {rec['memory']['argument_bytes']} B, peak "
        f"{rec['memory']['peak_bytes']} B (card {card} B); roofline terms from NVIDIA's spec: "
        f"compute {rec['t_compute_s']:.6f} s, memory {rec['t_memory_s']:.6f} s, collective "
        f"{rec['t_collective_s']:.6f} s, bound by {rec['bottleneck']}")
    return rec


def phase_mesh(dev) -> dict:
    """The sharding layer on the card: a real 1 x 1 ('data', 'model') mesh
    over a one-rank process group (make_local_mesh), where every shard is
    the whole tensor, so the DTensor programs run the same kernels as the
    unsharded ones and must give the same bits: micro-lm's lifecycle
    restored onto the mesh (run_mesh_lifecycle), qwen3-1.7b's sharded
    prefill and decode (run_mesh_qwen3), the int8 cross-pod all-gather
    (run_mesh_crosspod), sharded_batch, and one dry-run cell in its own
    process, started first and run beside the rest (start_mesh_dryrun,
    check_mesh_dryrun).  Returns the launches of the counted runs,
    summed."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    dryrun = start_mesh_dryrun()
    mesh = make_local_mesh()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as work:
            add(run_mesh_lifecycle(mesh, dev, work))
        add(run_mesh_qwen3(mesh, dev))
        add(run_mesh_blocks(mesh, dev))
        add(run_mesh_crosspod(dev))
        data = SyntheticLMDataset(512, 64, 4, seed=9)
        with force_mesh_axes(tuple(mesh.mesh_dim_names)):
            sharded = data.sharded_batch(3, mesh, logical_spec("batch", "seq"))
        for k, v in data.batch(3).items():
            if not torch.equal(sharded[k].full_tensor().cpu(), torch.from_numpy(v)):
                raise RuntimeError(f"[mesh] sharded_batch {k} differs from batch(3)")
        log("[mesh] sharded_batch(3): DTensors whose full values equal batch(3)")
        check_mesh_dryrun(dryrun)
    finally:
        dist.destroy_process_group()
        if dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()
    log(f"[mesh] phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


def main() -> int:
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        log(f"[time] {what} done, {time.perf_counter() - t_start:.1f} s since the start")

    kind = phase_device()
    dev = resolve("cuda")
    cpu_paths, pool = start_cpu_paths()
    phase_build()

    gen = torch.Generator().manual_seed(0)
    cfg = get_config("micro-lm")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    n_params = sum(x.numel() for _, x in flatten_with_paths(params))
    leaves = [x for _, x in flatten_with_paths(params)]
    stats = check_flash(dev, gen)
    stats.update(check_flash_bwd(dev, gen))
    stats["quantize_int8"], stats["dequantize_int8"] = check_quantize(dev, gen, leaves)
    cpu, captured = cpu_paths.result()
    pool.shutdown()
    stats["decide_dest"] = check_decide(dev, captured)
    stamp("build and kernels")
    for name, st in stats.items():
        lib = "null" if st["library_ms"] is None else f"{st['library_ms']:.4f}"
        log(f"[kernels] {name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {st['bound_ms']:.4f} ms ({st['bound_by']})")

    data = SyntheticLMDataset(cfg.vocab_size, PROMPT, BATCH, seed=1)
    prompts = torch.from_numpy(data.batch(0)["tokens"]).long().to(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        ops.reset_launch_counts()
        res = run_slice(cfg, params, prompts, work, max_new=NEW, device=dev)
        launches = ops.launch_counts()
        expect = dict.fromkeys(launches, 0)
        expect.update(flash_attention=2 * cfg.num_layers, quantize_int8=len(leaves),
                      dequantize_int8=len(leaves))
        if launches != expect:
            raise RuntimeError(f"launch counts of the slice {launches}, expected {expect}")
        log(f"[slice] micro-lm, {n_params} params, {BATCH} requests x {PROMPT} prompt + {NEW} "
            f"new tokens; launches {launches}")
        for site, pre, dec in (("A", res.prefill_a_s, res.decode_a_s),
                               ("B", res.prefill_b_s, res.decode_b_s)):
            log(f"[slice] site {site}: prefill {pre * 1e3:.2f} ms; decode "
                f"{BATCH * NEW / dec:.1f} new tok/s ({(PROMPT + NEW - 1) / dec:.1f} steps/s, "
                f"{dec:.3f} s)")
        v = res.verdict
        log(f"[slice] int8 checkpoint {res.nbytes} B saved in {res.save_s:.3f} s; gate: class "
            f"{int(v.workload_class)}, t_transfer {float(v.t_transfer_s):.4f} s, t_cost "
            f"{float(v.t_cost_s):.4f} s, feasible {bool(v.feasible)}; migrate {res.migrate_s:.3f} s; "
            f"restore {res.restore_s:.3f} s")
        check_slice(res, cfg, params, prompts, dev)
    ops.reset_launch_counts()
    logits16, prefill16_s = run_bf16_prefill(cfg, params, prompts, device=dev)
    counts16 = ops.launch_counts()
    expect16 = dict.fromkeys(counts16, 0)
    expect16["flash_attention_bf16"] = cfg.num_layers
    if counts16 != expect16:
        raise RuntimeError(f"launch counts of the bf16 prefill {counts16}, expected {expect16}")
    launches["flash_attention_bf16"] = counts16["flash_attention_bf16"]
    check_bf16_prefill(logits16, cfg, params, prompts)
    log(f"[slice] micro-lm in bf16: prefill of {BATCH} x {PROMPT} tokens {prefill16_s * 1e3:.2f} ms "
        f"(first call); launches {counts16}")
    stamp("slice")
    fleet_launches = run_fleet_paths(dev, cpu)
    launches["decide_dest"] = sum(fleet_launches.values())
    check_spawn_pool(dev)
    phase_profile(cfg, params, prompts, dev)
    phase_profile_fleet(dev)
    phase_host_split(dev)
    stamp("fleet and profile")
    train = phase_train(cfg, params, dev)
    for name in ("flash_attention", "flash_attention_bf16", "quantize_int8", "dequantize_int8"):
        launches[name] += train[name]
    for name in ("flash_attention_bwd", "flash_attention_bwd_bf16"):
        launches[name] = train[name]
    log(f"[train] launches of the training runs {train}")
    stamp("train")
    launches["decide_dest"] += phase_serving(dev)
    stamp("serving")
    examples = phase_examples(dev)
    for name, n in examples.items():
        launches[name] += n
    log(f"[examples] launches of the examples {examples}; all counted paths {launches}")
    stamp("examples")
    archs = phase_archs(dev)
    for name, n in archs.items():
        launches[name] += n
    log(f"[archs] launches of the architectures' runs {archs}; all counted paths {launches}")
    archs2 = phase_archs2(dev)
    for name, n in archs2.items():
        launches[name] += n
    log(f"[archs2] launches of the architectures' runs {archs2}; all counted paths {launches}")
    stamp("archs and archs2")
    launchers = phase_launchers(dev)
    for name, n in launchers.items():
        launches[name] += n
    log(f"[serving] launches of the launchers at full width {launchers}; all counted paths "
        f"{launches}")
    stamp("launchers")
    archs3 = phase_archs3(dev)
    for name, n in archs3.items():
        launches[name] += n
    log(f"[archs3] launches of the architectures' runs {archs3}; all counted paths {launches}")
    stamp("archs3")
    mesh = phase_mesh(dev)
    for name, n in mesh.items():
        launches[name] += n
    log(f"[mesh] launches of the mesh runs {mesh}; all counted paths {launches}")
    stamp("mesh")

    rows = []
    for name, st in stats.items():
        rows.append(dict(name=name, **KERNELS[name], launches=launches[name],
                         max_abs_err=st["max_abs_err"], max_err=st["max_abs_err"],
                         ms=st["ms"], kernel_ms=st["ms"], plain_ms=st["plain_ms"],
                         bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                         library_ms=st["library_ms"]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
