#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sgmse_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero, and only a run that
passes them all prints the final ``{"ok": true, ...}`` line:

1. card identity (``nvidia-smi`` name and power limit); no CUDA -> fail;
2. build the hand-written kernels from ``sgmse_tpu_torch/csrc``;
3. for the full-width flagship NCSN++ (B=4, F=T=256; ``ncsnpp_v2`` makes the
   same calls) and the full-width ``ncsnpp_48k`` (F=768, T=256): hold each
   kernel against its plain PyTorch version at every call signature the
   network gives it (group_norm_act with and without its pre-bias, upfirdn2d
   single and paired), in float32 and bfloat16; check that group_norm_act
   repeats bit for bit; check each library yardstick against the plain
   version of the function it computes; then time kernel, plain and library
   in bfloat16 as device time (CUDA graphs of 25 back-to-back calls,
   ``sgmse_tpu_torch.kernel_times``) beside each call's byte/operation bound;
4. the same two networks' full forward (seeded weights) through the kernels
   and through the plain versions, float32: relative error, and the launch
   counts per forward (flagship 24 upfirdn2d and 109 group_norm_act; 48 kHz
   12 and 100);
5. the flagship main path through the entry point ``sgmse_tpu_torch.enhance``
   on four 2.04-s wavs (PC N=30, ald corrector, bf16), with the launch counts
   of that run; then the same path on a short input through the kernels and
   through the plain versions, which must agree;
6. the Schroedinger-bridge path through the entry point with ``--config``
   (``ncsnpp_v2`` + SBVE, data prediction, the flagship's weights; bf16, four
   2.04-s wavs, ``--N 30`` which the bridge ignores: 50 NFE); then its ``sde``
   variant on a short input, kernels against plain;
7. the 48 kHz path through the entry point with ``--config`` (``ncsnpp_48k``
   with the 48 kHz STFT and SDE constants; four 2.04-s 48 kHz wavs, F=768,
   PC N=30 + ald, bf16);
8. the remaining samplers on a short input with the flagship's weights,
   float32, kernels against plain: the probability-flow ODE by rk4 (N=4) and
   by rk45 (``max_steps`` bounded: random weights make the ODE stiff),
   euler_maruyama + langevin, and ``--chunk_seconds`` on a 5-s wav;
9. training the flagship at the JAX CLI's defaults (B=8, F=T=256, float32,
   remat off): (a) every kernel call signature of a train step, forward and
   backward (K1, the K1 adjoint, K2, K2b), kernel against plain in float32
   and bfloat16, K2 and K2b bit for bit, the library yardsticks checked, and
   float32 device times per train step; (b) one full-width train step through
   the kernels and through the plain versions: the loss and every
   parameter's gradient agree, then its steps/s, peak memory and device
   breakdown (``nfe_profile.train_step_profile``) with PyTorch's default
   cuDNN TF32, as ``train.main`` runs; (c) every trainable parameter gets a
   finite, non-zero gradient through the kernels; (d)
   ``sgmse_tpu_torch.train.main`` (``python -m sgmse_tpu_torch.train``) on a
   seeded dataset of 80 train and 2 valid 2.04-s wavs for 10 steps with
   validation and the evaluation on 2 files, a resume from ``last`` for 2 more
   with the validation loss only, and ``enhance.main --ckpt`` on that
   checkpoint; (e) 5 steps in bfloat16. Every batch of (d) and (e) must come
   from the native batch loader (``data/native.py``);
10. training the Schroedinger bridge at full width with the recipe's flags
   (``ncsnpp_v2`` + SBVE, data prediction, ``--pesq_weight 5e-4``,
   ``--batch_size 16``): (a) the PESQ loss on the card (with TF32 allowed for
   float32 products) against the same function on the CPU at B=16 crops of
   32,640 samples, its value and its gradient, and its device ms and launches
   per forward+backward call; (b) every kernel call signature of a B=16 train
   step, as in 9a; (c) one full-width bridge step (B=8) through the kernels
   and through the plain versions, the loss and every leaf's gradient, the
   PESQ term non-zero, then its B=16 step profile with PyTorch's default
   cuDNN TF32; (d) ``train.main`` with the recipe's flags on phase 9's
   dataset for 10 steps with validation and the evaluation on 2 files (the
   bridge's ode sampler, 50 NFE), every batch from the native loader; (e) the
   run's ``last`` exported to a Lightning ``.ckpt`` and imported back
   (``convert``): weights bit for bit, the same config, and ``enhance.main
   --ckpt`` on both directories gives identical wavs;
11. the serving path (``python -m sgmse_tpu_torch.serve``: ``BatchingEnhancer``
   and its HTTP front end) with the flagship's weights, bf16, PC N=30 + ald
   (60 NFE a batch), under a watchdog: (a) in a fresh process, 8 threads make
   its first K1 (pair) and K2 launches at once, each on its own stream, in
   float32 and bfloat16 (``sgmse_tpu_torch.first_launch``): each within phase
   3's tolerances, the counters exact; (b) ``build_enhancer`` with
   ``--batch_size 8 --max_delay_ms 100 --warm_seconds 2.04 4.08``, and
   ``--max_seconds 5 --chunk_seconds 2.04`` (cut from 30 and 10 to keep the
   phase short); K1 and K2 against their plain versions as in phase 3
   (untimed) at every call signature of every (bucket, power-of-two batch)
   shape the requests below can be served at, buckets 128-512 frames and
   batches 1-8; warmed up on its executors' streams; eight 2.04-s requests
   run as one batch, equal within SERVE_TOL to ``model.enhance`` of the same
   batch with batch 0's generator; (c) HTTP on 127.0.0.1: 1.0, 2.04 and
   3.5-s requests and a 6-s one on the long path, each answered 200 with a
   WAV of its length; /healthz, /stats; (d) a closed burst of 32 requests of
   1.0-4.08 s with 1 executor and with 4, which take turns per network
   evaluation (audio-s/wall-s, requests/s, batch fill, launch counts exact);
   with 4 executors and with 1, a 1.0-s request sent just after a 6-s one on
   the long path: how long each waited for its answer; B=8 forwards from one
   thread and from two threads on two streams without turns, timed, then
   traced: how the streams' kernels overlapped, K2's cooperative launches
   among them (``nfe_profile.stream_overlap``); then
   ``serve_latency.run_rate`` at 50% and 90% of the 4-executor burst's
   requests/s for 15 s each (p50/p95/p99 overall and per bucket, 503s; every
   request must succeed at 50%); the phase's peak memory, no request failed;
12. the remaining NCSN++ branches and DCUNet: (a) the full-width 48 kHz net
   with residual pyramids (``ncsnpp_48k --progressive residual
   --progressive_input residual``, F=768; each pyramid level is K6, cuDNN and
   one K1 pass at up = down = 1) and the full-width ``ncsnpp`` variant (DDPM
   blocks, cat combine, no FIR, elu: K2 without SiLU) as phase 3 holds the
   flagship: every call signature kernel against plain in f32 and bf16, timed
   in bf16; every call signature of the residual net's B=8 train step (the K1
   adjoint at up = down = 1, K2b), as phase 9a; (b) the residual net's forward
   at B=4 and one B=8 f32 train step through the kernels against the plain
   versions, with the launch counts (24 K1 of which 12 K6 passes, 101 K2 per
   forward), then the net through ``enhance.main --config`` on four 2.04-s
   48 kHz wavs (PC N=30 + ald, bf16); (c) the variant's forward, kernels
   against plain; (d) DCUNet (DilDCUNet-v2, n_fft 512, the JAX CLI's
   defaults, bN; no hand-written kernel, every count must stay 0):
   ``enhance.main --config`` on four 2.04-s wavs in bf16 and in f32, bf16
   against f32 on one evaluation, the CbN variant on a short input and its
   batch coupling, ``nfe_profile`` of one B=4 bf16 evaluation
   (``chiprun_out/dcunet_nfe_trace.json``), ``train.main`` at B=8 on phase
   9's dataset for 10 steps with validation, a train-step profile, the
   device time of its bN statistics against three other ways of taking
   them (``bn_statistics_cost``), a resume
   from ``last`` whose first step starts from the saved BatchNorm statistics
   bit for bit, ``enhance.main --ckpt``, and ``last`` through a Lightning
   ``.ckpt`` and back (weights, EMA and statistics bit for bit, identical
   wavs). ``python3 chip_smoke.py --only 12`` runs phases 1-2 and 12 alone
   and prints no contract lines;
13. data parallelism (``sgmse_tpu_torch.parallel``): (a) ``train.main`` at
   the JAX defaults (B=8, f32) for 10 steps on phase 9's dataset alone and as
   the one rank of an NCCL group (``--num_processes 1 --process_id 0
   --coordinator_address 127.0.0.1:<free port>``: the data-parallel path,
   whose one all-reduce of the gradients runs in a group of one too), cuDNN
   deterministic in both: parameters and EMA bit for bit; then both steps'
   profiles (``nfe_profile.train_step_profile``, the group's with its NCCL
   kernels): the reduction's overhead in device busy ms and launches; (b) two ranks
   on the one card, gloo on CUDA tensors (a test arrangement: NCCL refuses
   two ranks on one device), 3 full-width flagship steps at B=4 each against
   one process at B=8 on the same rows with the same draws: the ranks'
   parameters bit for bit, the global losses within 1e-6 relative, each
   leaf's first-step gradient within 1e-5 of its max|g|; (c) the same for
   DCUNet bN (phase 12's DilDCUNet-v2), one step: the running statistics
   within 1e-5 of their scale, the gradients within 1e-2 of each leaf's
   max|g| and the loss within 1e-4 (``tests/test_torch_dcunet_train.py``'s
   tolerances); (d) ``enhance`` through two worker processes on ``cuda:0``
   (``parallel.pool``), B=4 and B=3, f32 and bf16, PC N=5 + ald on 1-s
   inputs: each worker's rows bit for bit the one-device call on them with
   the padded batch's draws, and in f32 within 1e-5 of max|out| of one
   device on the whole zero-padded batch (in bf16 one device alone moves by
   ~2e-2 between batches of 2 and 4, printed); the workers' launch counts
   read from them; then, in f32 at B=3 (a zero row pads the batch and enters
   the statistics), what couples a batch's rows, reduced over the workers'
   gloo group: PC N=5 + ``langevin``, the rk45 ODE (``max_steps`` 4) and
   DCUNet-CbN (phase 12's DilDCUNet-v2 with CbN) through two workers, each
   within 1e-5 of max|out| of one device on the zero-padded batch with the
   same NFE, each worker making the same collectives (their count and host
   ms per batch printed); (e) ``serve.build_enhancer``
   with ``--data_parallel`` on the same two workers: a burst of 8 requests,
   each answer against ``model.enhance`` of its batch; then a line on what
   one card cannot verify. ``--only 13`` runs phases 1-2 and 13;
14. the host side and the learn demo's net (``sgmse_tpu_torch.tools``): (a)
   every K1 and K2 call signature of the demo net's forward (nf 32, ch_mult
   1 1 2 2, one res-block per level, F=T=256) at B=8, the enhancement's
   batch, and every K1, K1-adjoint, K2 and K2b signature of its B=16 train
   step, kernel against plain in f32 and bf16 with phases 3 and 9a's
   tolerances (forward timed in bf16, the step in f32), its forward through
   the kernels against plain with the launch counts (12 K1 and 45 K2 per
   forward; 12 K1, 9 K1 adjoints, 45 K2 and 45 K2b per step); (b) the learn
   demo cut to about two minutes (``DEMO_CUT``: 320 steps of the 1,024-file
   corpus, 5 validations with 2 eval files) through
   ``python -m sgmse_tpu_torch.tools.learn_demo``'s ``main``: the corpus,
   ``train.main``, ``enhance.main`` of the 16 test files with ``best_pesq``
   and ``calc_metrics``, with PyTorch's default cuDNN TF32; finite metrics,
   a validation loss that falls from the first validation to the last, every
   training and validation batch from the native loader, and the launch
   counts of the run's train steps and network evaluations exact; the
   enhanced-vs-noisy deltas printed; (c) ``tools.bf16_quality`` on (b)'s
   ``best_pesq``, the 16 test files in f32 and bf16: mean and largest
   deltas. ``--only 14`` runs phases 1-2 and 14.

Each entry-point path is driven with the launch counters set to 0 just before
it and read just after. The seconds of each phase are printed before the
kernels line. Details go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
B = 4
WAV_SECONDS = 2.04  # 256 STFT frames at hop 128 (16 kHz) and at hop 384 (48 kHz)
SEED = 0
# Tolerances, relative to max|plain| of each comparison.
TOL = {
    # f32: sums of <= 16 taps, or group statistics, in another order.
    ("upfirdn2d", "float32"): 1e-5,
    ("group_norm_act", "float32"): 2e-5,
    # bf16: both round the same float32 value once; they differ where the
    # order of a float32 sum moves it across a rounding boundary: one bf16 step.
    ("upfirdn2d", "bfloat16"): 2.0**-7,
    ("group_norm_act", "bfloat16"): 2.0**-7,
}
# The backward kernels: the K1 adjoint as K1; K2b's float32 outputs (dgamma, dbeta, and
# all of them for float32 inputs) 1e-4, its sums running over up to B*H*W = 524,288
# terms per channel in another order; any bfloat16 output one bf16 step.
GRAD_TOL_F32 = {"upfirdn2d_adjoint": 1e-5, "group_norm_act_bwd": 1e-4}
FORWARD_TOL = 1e-3     # full f32 forward, kernels vs plain, relative to max|plain|
ENHANCE_TOL = 1e-3     # short f32 enhance, kernels vs plain, relative to max|plain|
TRAIN_STEP_TOL = 1e-3  # full f32 train step, kernels vs plain: the loss, and each leaf's
                       # gradient relative to its max|plain|
KEY_BIAS_TOL = 1e-4    # the attention key biases' gradient, exactly 0 (softmax invariance):
                       # rounding noise, relative to the largest gradient of the network
KERNELS = ("upfirdn2d", "upfirdn2d_adjoint", "group_norm_act", "group_norm_act_bwd")
TRAIN_B = 8
# Per train step (remat off): K1 on the 12 res-block pairs and 12 pyramid calls, its adjoint
# on the pairs and the 6 output-pyramid upsamplings (the input pyramid acts on the network
# input, which needs no gradient), K2 and K2b on every norm.
TRAIN_LAUNCHES = {"upfirdn2d": 24, "upfirdn2d_adjoint": 18, "group_norm_act": 109,
                  "group_norm_act_bwd": 109}
TRAIN_FILES, VALID_FILES, TRAIN_STEPS, RESUME_STEPS, BF16_STEPS = 80, 2, 10, 2, 5
EVAL_NFE = 60  # the in-training evaluation: PC, N = sde.N = 30, ald
# The Schroedinger-bridge recipe (phase 10): its flags, its batch, the kernels-vs-plain
# step's batch (phase 9b's, to bound the plain route's memory), its evaluation's NFE.
BRIDGE = dict(backbone="ncsnpp_v2", sde="sbve", loss_type="data_prediction", pesq_weight=5e-4)
BRIDGE_B, BRIDGE_STEP_B, BRIDGE_EVAL_NFE = 16, 8, 50
# The PESQ loss on the card against the CPU: the loss relative to max|loss|, the gradient
# relative to max|g| (cuFFT against pocketfft, float32 sums in another order).
PESQ_LOSS_TOL, PESQ_GRAD_TOL = 1e-4, 1e-3
PESQ_REPS, PESQ_TRACED = 20, 5
# Per network evaluation: launches, group_norm_act with/without SiLU, with the pre-bias,
# parameters. The 48 kHz net keeps the middle block's attention, whose norm has no SiLU.
NETS = {
    "ncsnpp": dict(launches={"upfirdn2d": 24, "group_norm_act": 109}, silu_split=[105, 4],
                   pre_bias=49, params=65_590_822),
    "ncsnpp_48k": dict(launches={"upfirdn2d": 12, "group_norm_act": 100}, silu_split=[99, 1],
                       pre_bias=49, params=64_739_854),
}
# Phase 12: the 48 kHz net with residual pyramids (each pyramid level one K6, i.e. cuDNN
# and one K1 pass at up = down = 1: 6 down, 6 up) and the full-width ncsnpp variant (DDPM
# blocks, cat combine, no FIR, elu: K2 without SiLU, no K1); names of kernel_times.VARIANTS.
NETS["48k_residual"] = dict(launches={"upfirdn2d": 24, "group_norm_act": 101},
                            silu_split=[100, 1], pre_bias=49, params=70_351_118, k6=12)
NETS["ncsnpp_variant"] = dict(launches={"upfirdn2d": 0, "group_norm_act": 85},
                              silu_split=[0, 85], pre_bias=37, params=64_250_918, k6=0)
# A B=8 train step of the residual net: its K1 adjoints are the 12 res-block pairs', the 6
# output-pyramid levels' and 5 of the 6 input-pyramid levels' (the first acts on the input).
RESIDUAL_TRAIN_LAUNCHES = {"upfirdn2d": 24, "upfirdn2d_adjoint": 23, "group_norm_act": 101,
                           "group_norm_act_bwd": 101}
CONFIG_48K = dict(n_fft=1534, hop_length=384, spec_factor=0.065, spec_abs_exponent=0.667,
                  sigma_min=0.1, sigma_max=1.0, theta=2.0, sr=48000)
# DCUNet (phase 12d): DilDCUNet-v2 at n_fft 512 with the JAX CLI's defaults
# (nfe_profile.DCUNET), 3,531,970 parameters and 3,328 BatchNorm statistics; it runs no
# hand-written kernel. Its short CbN check, its train-step batch and its bf16/f32 NFE.
DCUNET_PARAMS, DCUNET_STATS = 3_531_970, 3_328
DCUNET_TRAIN_B = 8
DCUNET_BF16_F32_TOL = 0.1  # bf16 against f32 output on one evaluation, relative to max|f32|
RK45_MAX_STEPS = 4
# Phase 14: the learn demo's net (kernel_times.VARIANTS["learn_demo"]), its launches per
# forward and per train step (as its dispatchers record them on the CPU), the enhancement's
# and the training's batch, the cut recipe (about two minutes), and each validation's network
# evaluations (the valid loss on one batch of the 16 valid files, and PC N=30 + ald on the 2
# eval files, one batch).
NETS["learn_demo"] = dict(launches={"upfirdn2d": 12, "group_norm_act": 45}, silu_split=[44, 1],
                          pre_bias=20, params=1_377_050, k6=0)
DEMO_TRAIN_LAUNCHES = {"upfirdn2d": 12, "upfirdn2d_adjoint": 9, "group_norm_act": 45,
                       "group_norm_act_bwd": 45}
DEMO_ENHANCE_B, DEMO_TRAIN_B = 8, 16
DEMO_CUT = ["--num_train", "1024", "--max_steps", "320", "--num_eval_files", "2",
            "--no_profile"]
DEMO_VALIDATION_FORWARDS = 1 + EVAL_NFE
# Phase 11, serving: the flags of python -m sgmse_tpu_torch.serve (--max_seconds and
# --chunk_seconds cut from 30 and 10 s, so that a 6-s request takes the long path in a short
# phase), the NFE of a batch (PC N=30 + ald), the served batch against model.enhance of the
# same batch and generator on another stream (the same kernels on the same inputs; relative
# to max|x|), the requests of the HTTP check, the closed burst and the open-loop rates (as
# shares of the 4-executor burst's requests/s).
SERVE_FLAGS = ["--batch_size", "8", "--max_delay_ms", "100", "--warm_seconds", "2.04", "4.08",
               "--max_seconds", "5", "--chunk_seconds", "2.04", "--precision", "bfloat16"]
SERVE_NFE = 60
SERVE_TOL = 1e-5
HTTP_SECONDS = (1.0, 2.04, 3.5, 6.0)
BURST_SECONDS, BURST_REQUESTS = (1.0, 2.04, 3.0, 4.08), 32
OPEN_LOOP_SHARES, OPEN_LOOP_S = (0.5, 0.9), 15.0
FIRST_LAUNCH_THREADS = 8
OVERLAP_B, OVERLAP_FORWARDS = 8, 2  # two streams, each this many B=8 forwards, profiled
HOL_LONG_S, HOL_SHORT_S, HOL_GAP_S = 6.0, 1.0, 0.2  # a short request behind a long-path one
SERVE_WATCHDOG_S = 900  # phase 11 fails, and the script exits, if it runs longer
# Phase 13, data parallelism: 13a's train.main runs (steps of the flagship at B=8), 13b's
# two-rank flagship steps (B=4 per rank) against one process at B=8, 13c's DCUNet bN step
# likewise; the tolerances (the loss relative, each leaf's gradient relative to its max|g|,
# DCUNet's statistics to their scale, after tests/test_torch_dcunet_train.py: its
# DilDCUNet-v2 train-mode gradient 1e-2, its loss 1e-4); 13d/13e's short enhance through
# two workers on the one card against one device (relative to max|out|), and their N.
DP_TRAIN_STEPS, DP_TWO_RANK_STEPS = 10, 3
DP_LOSS_RTOL, DP_GRAD_TOL = 1e-6, 1e-5
DCUNET_DP_LOSS_RTOL, DCUNET_DP_GRAD_TOL, DCUNET_DP_STATS_TOL = 1e-4, 1e-2, 1e-5
DP_TOL, DP_N, DP_SERVE_REQUESTS = 1e-5, 5, 8
DP_COUPLED_B = 3  # 13d's coupled paths: two workers hold 2 rows each, one of them padding
ONE_CARD_LIMITS = ("13: one card cannot verify NCCL across cards (13a is a world of one; 13b "
                   "and 13c put two gloo ranks on one card, a test arrangement), the time of "
                   "the gradient all-reduce over NVLink (it runs after the backward, with no "
                   "overlap; a world of one moves no bytes between cards), "
                   "or how the speed scales with N (13d and 13e share one card between two "
                   "workers)")
REPLACES = {
    "upfirdn2d": ("sgmse_tpu_torch/csrc/upfirdn2d.cu", "sgmse_tpu/ops/upfirdn2d.py:84"),
    "upfirdn2d_adjoint": ("sgmse_tpu_torch/csrc/upfirdn2d.cu", "sgmse_tpu/ops/upfirdn2d.py:84"),
    "group_norm_act": ("sgmse_tpu_torch/csrc/group_norm_act.cu",
                       "sgmse_tpu/models/blocks.py:157"),
    "group_norm_act_bwd": ("sgmse_tpu_torch/csrc/group_norm_act_bwd.cu",
                           "sgmse_tpu/models/blocks.py:157"),
}


def card_identity() -> str:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; this script "
                           "runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return card


def counters():
    from sgmse_tpu_torch.ops import group_norm as gn
    from sgmse_tpu_torch.ops import upfirdn2d as ufd

    k1 = ufd.upfirdn2d_cuda
    return {"upfirdn2d": k1.launches, "upfirdn2d_adjoint": k1.adjoint_launches,
            "group_norm_act": gn.group_norm_act_cuda.launches,
            "group_norm_act_bwd": gn.group_norm_act_bwd_cuda.launches}


def reset_counters():
    from sgmse_tpu_torch.ops import group_norm as gn
    from sgmse_tpu_torch.ops import upfirdn2d as ufd

    ufd.upfirdn2d_cuda.launches = ufd.upfirdn2d_cuda.adjoint_launches = 0
    gn.group_norm_act_cuda.launches = gn.group_norm_act_bwd_cuda.launches = 0


def expect(per_call, n=1):
    """Launch counts of every kernel for ``n`` times ``per_call`` (0 where absent)."""
    return {k: per_call.get(k, 0) * n for k in KERNELS}


def add(*counts):
    return {k: sum(c[k] for c in counts) for k in KERNELS}


def as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def rel_check(what, got, ref, tol_rel):
    """max |got - ref| over the tuple's tensors; raise past tol_rel * max|ref|."""
    got, ref = as_tuple(got), as_tuple(ref)
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{what}: gave {tuple(g.shape)} {g.dtype}, plain "
                                 f"{tuple(r.shape)} {r.dtype}")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.float().abs().max().item() for r in ref)
    if not err <= tol_rel * scale:
        raise AssertionError(f"{what}: max |diff| {err} > {tol_rel} * {scale}")
    return err, scale


def check_kernels(counts, dev, backbone, timed=True):
    """Phase 3: every recorded signature, kernel vs plain in float32 and
    bfloat16, bit-for-bit repeats of group_norm_act, each library yardstick vs
    the plain version of its function; with ``timed``, bf16 device times and
    bounds."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for (name, sig), per_forward in counts.items():
        for dtype in (torch.float32, torch.bfloat16):
            case = kt.make_case(name, sig, dtype, dev, gen)
            dt = case["dtype"]
            tol = TOL[(name, dt)]
            got, ref = case["kernel"](), case["plain"]()
            torch.cuda.synchronize()
            err, scale = rel_check(f"{name} {case['sig']} {dt}", got, ref, tol)
            if name == "group_norm_act" and not torch.equal(got, case["kernel"]()):
                raise AssertionError(f"{name} {case['sig']} {dt}: two runs differ")
            row = dict(backbone=backbone, name=name, sig=case["sig"], dtype=dt,
                       per_forward=per_forward, max_abs_err=err, max_abs_ref=scale,
                       tol=tol * scale)
            if "library" in case:
                row["library_err"], _ = rel_check(f"{name} library {case['sig']} {dt}",
                                                  case["library"](), case["library_ref"](), tol)
            if timed and dtype == torch.bfloat16:  # the main path's dtype
                times = kt.time_case(case)
                row.update({k: times[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "bytes", "ops")})
            rows.append(row)
            del case, got, ref
        torch.cuda.empty_cache()
    return rows


def network_checks(backbone, dev, report, batch=B):
    """Phases 3 and 4 (and 12a-c, 14a) for one full-width net of NETS (a
    backbone, or a kernel_times.VARIANTS name) at ``batch``: kernel checks and
    timings at its call signatures, then its forward through the kernels
    against the plain versions. Returns (model, kernel rows)."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt

    net = NETS[backbone]
    arch, settings = kt.VARIANTS.get(backbone, (backbone, {}))
    model = kt.full_model(dev, backbone=arch, **settings)
    n_params = sum(p.numel() for p in model.parameters())
    x, y, t = kt.network_inputs(dev, kt.BINS[arch], batch=batch)
    with torch.inference_mode():
        with kt.routed(calls=[], plain=True) as calls:
            out_plain = model.dnn(x, y, t)
    counts = kt.per_forward(calls)
    k6 = sum(1 for n, sig in calls if n == "upfirdn2d" and sig[1:3] == (1, 1))
    if k6 != net.get("k6", 0):
        raise AssertionError(f"{backbone}: {k6} K6 FIR passes per forward, expected "
                             f"{net.get('k6', 0)}")
    rows = check_kernels(counts, dev, backbone)
    n_sigs = {k: sum(1 for n, _ in counts if n == k) for k in net["launches"]}
    print(f"{backbone} kernel checks: {len(rows)} passed over {n_sigs} call signatures (f32, "
          f"bf16; group_norm_act repeats bit for bit; library yardsticks agree), "
          f"tolerances {TOL}")
    for r in rows:
        if "ms" in r:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {r['name']:15s} x{r['per_forward']} {r['sig']}: bf16 device "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library {lib}, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']})")

    gn_sigs = [s for n, s in calls if n == "group_norm_act"]
    silu_split = [sum(1 for s in gn_sigs if s[3] == flag) for flag in (True, False)]
    with_bias = sum(1 for s in gn_sigs if s[4])
    reset_counters()
    with torch.inference_mode():
        out_kernel = model.dnn(x, y, t)
    torch.cuda.synchronize()
    moved = counters()
    rel = ((out_kernel - out_plain).abs().max() / out_plain.abs().max()).item()
    print(f"{backbone} full forward: {n_params} params, B={batch} F={x.shape[2]} T={x.shape[3]} "
          f"f32, kernels vs plain rel err {rel:.3e} (bound {FORWARD_TOL}); launches {moved} "
          f"({k6} of upfirdn2d K6 FIR passes at up = down = 1), group_norm_act with/without "
          f"SiLU {silu_split}, with the temb pre-bias {with_bias}")
    if n_params != net["params"]:
        raise AssertionError(f"{backbone}: expected {net['params']} params, got {n_params}")
    if not (torch.isfinite(out_kernel).all() and rel <= FORWARD_TOL):
        raise AssertionError(f"{backbone} forward: kernels vs plain rel err {rel} > {FORWARD_TOL}")
    expected = (expect(net["launches"]), net["silu_split"], net["pre_bias"])
    if (moved, silu_split, with_bias) != expected:
        raise AssertionError(f"{backbone}: launches per forward {moved}, SiLU split "
                             f"{silu_split}, pre-bias {with_bias}; expected {expected}")
    report[f"forward_{backbone}"] = dict(params=n_params, rel_err=rel, launches=moved,
                                         silu_split=silu_split, pre_bias=with_bias, k6=k6)
    del out_plain, out_kernel
    return model, rows


def summarize(rows, train_rows, bridge_rows, residual_train_rows, launches_by_path,
              demo_train_rows=()):
    """The kernels line: K1 and K2 per network evaluation of the flagship
    (bf16 device times, B=4), the backward kernels per train step (float32,
    B=8); every kernel's per-train-step sums also under ``per_train_step``,
    those of the bridge's B=16 step under ``per_bridge_train_step``, those of
    phase 12's and 14's nets per evaluation under ``per_nfe_<net>``, those of
    the 48 kHz residual net's B=8 step under ``per_48k_residual_train_step``
    and those of the learn demo's B=16 step under
    ``per_learn_demo_train_step``."""
    from sgmse_tpu_torch import kernel_times as kt

    sums = {bb: kt.per_nfe([r for r in rows if "ms" in r and r["backbone"] == bb])
            for bb in NETS}
    train_sums = kt.per_nfe([r for r in train_rows if "ms" in r])
    bridge_sums = kt.per_nfe([r for r in bridge_rows if "ms" in r])
    residual_sums = kt.per_nfe([r for r in residual_train_rows if "ms" in r])
    demo_sums = kt.per_nfe([r for r in demo_train_rows if "ms" in r])
    out = []
    for name in REPLACES:
        mine = [r for r in rows + train_rows + bridge_rows + residual_train_rows
                + list(demo_train_rows) if r["name"] == name]
        source, replaces = REPLACES[name]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(path[name] for path in launches_by_path.values()),
            launches_by_path={p: path[name] for p, path in launches_by_path.items()},
            max_abs_err=max(r["max_abs_err"] for r in mine if r["dtype"] == "float32"),
            max_abs_err_bf16=max(r["max_abs_err"] for r in mine if r["dtype"] == "bfloat16"))
        per_step = {k: v for k, v in train_sums[name].items() if k != "launches_per_nfe"}
        per_step["launches_per_train_step"] = train_sums[name]["launches_per_nfe"]
        entry["per_bridge_train_step"] = {k: v for k, v in bridge_sums[name].items()
                                          if k not in ("launches_per_nfe", "library_note")}
        entry["per_bridge_train_step"]["launches_per_train_step"] = \
            bridge_sums[name]["launches_per_nfe"]
        if name in sums["ncsnpp"]:  # per network evaluation of the flagship
            entry.update(sums["ncsnpp"][name], per_train_step=per_step,
                         per_nfe_48k={k: v for k, v in sums["ncsnpp_48k"][name].items()
                                      if k != "library_note"})
        else:  # per train step
            entry.update(per_step)
        for net in ("48k_residual", "ncsnpp_variant", "learn_demo"):
            if name in sums[net]:
                entry[f"per_nfe_{net}"] = {k: v for k, v in sums[net][name].items()
                                           if k != "library_note"}
        if name in residual_sums:
            entry["per_48k_residual_train_step"] = {
                k: v for k, v in residual_sums[name].items() if k != "library_note"}
        if name in demo_sums:
            entry["per_learn_demo_train_step"] = {
                k: v for k, v in demo_sums[name].items() if k != "library_note"}
        out.append(entry)
    return out


def check_outputs(what, name, got, ref):
    """Each output of a kernel against the plain version's, with the tolerance
    of its dtype (GRAD_TOL_F32 / TOL); returns (max |diff|, max |ref|)."""
    import torch

    errs, scales = [], []
    for g, r in zip(as_tuple(got), as_tuple(ref)):
        dt = str(r.dtype).split(".")[-1]
        tol = TOL[(name, dt)] if name in ("upfirdn2d", "group_norm_act") else (
            GRAD_TOL_F32[name] if r.dtype == torch.float32 else 2.0**-7)
        err, scale = rel_check(what, g, r, tol)
        errs.append(err)
        scales.append(scale)
    return max(errs), max(scales)


def train_kernel_checks(dev, report, backbone="ncsnpp", batch=TRAIN_B, tag="train",
                        launches=TRAIN_LAUNCHES):
    """Phases 9a, 10b and 12a: every kernel call signature of a full-width
    train step of ``backbone`` (or of a kernel_times.VARIANTS name) at
    ``batch``, kernel vs plain in float32 and bfloat16, bit-for-bit repeats of
    K2 and K2b, the library yardsticks, and float32 device times."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt

    arch, settings = kt.VARIANTS.get(backbone, (backbone, {}))
    model = kt.full_model(dev, backbone=arch, **settings)
    reset_counters()
    fwd, bwd = kt.record_train_calls(model, dev, batch,  # through the kernels
                                     f_bins=kt.BINS.get(arch, kt.F_BINS))
    torch.cuda.synchronize()
    moved = counters()
    del model
    torch.cuda.empty_cache()
    if moved != launches:
        raise AssertionError(f"{tag} step launches {moved}, expected {launches}")
    counts = kt.per_forward(fwd + bwd)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for (name, sig), per_step in counts.items():
        for dtype in (torch.float32, torch.bfloat16):
            case = kt.make_case(name, sig, dtype, dev, gen)
            what = f"{tag} {name} {case['sig']} {case['dtype']}"
            got, ref = case["kernel"](), case["plain"]()
            torch.cuda.synchronize()
            err, scale = check_outputs(what, name, got, ref)
            if name.startswith("group_norm_act"):
                again = case["kernel"]()
                if not all(torch.equal(a, b) for a, b in zip(as_tuple(got), as_tuple(again))):
                    raise AssertionError(f"{what}: two runs differ")
            row = dict(name=name, sig=case["sig"], dtype=case["dtype"], per_forward=per_step,
                       max_abs_err=err, max_abs_ref=scale)
            if "library" in case:
                row["library_err"], _ = check_outputs(f"{what} library", name,
                                                      case["library"](), case["library_ref"]())
            if dtype == torch.float32:  # the training dtype of the JAX defaults
                times = kt.time_case(case)
                row.update({k: times[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "bytes", "ops")})
            rows.append(row)
            del case, got, ref
        torch.cuda.empty_cache()
    sums = kt.per_nfe([r for r in rows if "ms" in r])
    print(f"{tag} kernel checks: {len(rows)} passed over {len(counts)} call signatures of a "
          f"B={batch} {backbone} train step (f32, bf16; K2 and K2b repeat bit for bit; "
          f"yardsticks agree), launches per step {moved}")
    for name, v in sums.items():
        lib = "-" if v["library_ms"] is None else f"{v['library_ms']:.3f}"
        print(f"  {name:18s} x{v['launches_per_nfe']} per step: f32 device {v['ms']:.3f} ms, "
              f"plain {v['plain_ms']:.3f}, library {lib}, bound {v['bound_ms']:.3f} "
              f"({v['bound_by']})")
    for r in rows:
        if "ms" in r and r["name"] in ("upfirdn2d_adjoint", "group_norm_act_bwd"):
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"    {r['name']:18s} x{r['per_forward']} {r['sig']}: {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f}, library {lib}, bound {r['bound_ms']:.4f}")
    report[f"{tag}_kernel_checks"] = rows
    return rows


def step_against_plain(model, dev, batch, what, launches=TRAIN_LAUNCHES, f_bins=None,
                       plain_remat=False):
    """One full-width float32 train step of ``model`` (seeded t and z, on
    ``f_bins`` frequency bins, default kernel_times.F_BINS) through the
    kernels against the plain versions: the loss and every leaf's gradient
    within TRAIN_STEP_TOL, the key biases at rounding level, every trainable
    leaf finite and non-zero, ``launches`` launches. With ``plain_remat`` the
    plain route recomputes each res-block in the backward (the same function
    and gradients, a fraction of the memory: the plain GroupNorm keeps float32
    intermediates, and a B=8 48 kHz step does not fit in 80 GB without it)."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt

    f_bins = f_bins or kt.F_BINS
    x, y, _ = kt.network_inputs(dev, f_bins, batch)
    rng = np.random.default_rng(SEED + 1)
    shape = (batch, 1, f_bins, kt.T_FRAMES)
    t = torch.from_numpy(rng.uniform(0.03, 1.0, batch).astype(np.float32)).to(dev)
    z = torch.from_numpy(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                          / np.sqrt(2)).astype(np.complex64)).to(dev)
    names, params = zip(*[(n, p) for n, p in model.dnn.named_parameters() if p.requires_grad])
    reset_counters()
    loss = model.step_loss(x, y, t=t, z=z)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    moved = counters()
    remat = model.dnn.remat
    model.dnn.remat = remat or plain_remat
    try:
        with kt.routed(plain=True):
            loss_ref = model.step_loss(x, y, t=t, z=z)
            refs = torch.autograd.grad(loss_ref, params)
    finally:
        model.dnn.remat = remat
    loss, loss_ref = loss.item(), loss_ref.item()
    scale = max(r.abs().max().item() for r in refs)
    worst, key_bias = (0.0, None), 0.0
    for name, g, r in zip(names, grads, refs):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: gradient of {name} is not finite")
        if name.endswith("NIN_1.b"):  # exactly zero: rounding noise on both routes
            key_bias = max(key_bias, g.abs().max().item() / scale, r.abs().max().item() / scale)
            continue
        if not g.abs().max().item() > 0:
            raise AssertionError(f"{what}: {name} gets no gradient through the kernels")
        rel = ((g - r).abs().max() / r.abs().max()).item()
        worst = max(worst, (rel, name))
    n_params = sum(p.numel() for p in params)
    print(f"{what} B={batch} f32 ({n_params} trainable params in {len(params)} leaves): "
          f"loss {loss:.6f}, plain {loss_ref:.6f}; worst leaf gradient rel err {worst[0]:.3e} "
          f"({worst[1]}; bound {TRAIN_STEP_TOL}); key-bias noise {key_bias:.1e} of max|g|; "
          f"every trainable leaf finite and non-zero through the kernels; launches {moved}")
    if (abs(loss - loss_ref) > TRAIN_STEP_TOL * abs(loss_ref) or worst[0] > TRAIN_STEP_TOL
            or key_bias > KEY_BIAS_TOL):
        raise AssertionError(f"{what}: kernels and plain versions disagree")
    if moved != launches:
        raise AssertionError(f"{what} launches {moved}, expected {launches}")
    del grads, refs
    torch.cuda.empty_cache()
    return dict(loss=loss, loss_plain=loss_ref, worst_leaf=worst, key_bias_noise=key_bias,
                launches=moved, inputs=(x, y, t, z))


def profile_step(model, out_dir, batch, what):
    """``nfe_profile.train_step_profile`` with PyTorch's default cuDNN TF32, as
    ``train.main`` runs; K2b must run one kernel per call."""
    from sgmse_tpu_torch import nfe_profile

    with cudnn_tf32():
        prof = nfe_profile.train_step_profile(model, out_dir, batch)
    print(f"{what} profile, B={batch}, cuDNN TF32 on: {prof['steps_per_s']:.3f} steps/s, "
          f"{prof['samples_per_s']:.2f} samples/s (wall {prof['wall_ms']:.1f} ms per step), "
          f"device busy {prof['busy_ms']:.1f} ms, idle {prof['idle_share_untraced']:.1%} "
          f"untraced, {prof['launches']:.0f} launches, peak {prof['peak_gib']:.2f} GiB; kinds "
          + ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in prof["kinds"].items()))
    k2b = prof["kinds"].get("K2b group_norm_act_bwd", dict(ms=0.0, launches=0.0))
    per_call = k2b["launches"] / TRAIN_LAUNCHES["group_norm_act_bwd"]
    print(f"K2b in the profiled step: {k2b['ms']:.3f} ms of device time, {k2b['launches']:.0f} "
          f"kernels for {TRAIN_LAUNCHES['group_norm_act_bwd']} calls ({per_call:g} per call)")
    if per_call != 1:
        raise AssertionError(f"K2b ran {per_call:g} kernels per call, expected one")
    return prof


def train_step_checks(dev, report):
    """Phases 9b and 9c: one full-width float32 flagship train step's loss and
    gradients through the kernels against the plain versions; then the step's
    steps/s, peak memory and device breakdown."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt

    model = kt.full_model(dev).train()
    step = step_against_plain(model, dev, TRAIN_B, "train step")
    del step["inputs"]
    report["train_step"] = dict(step, profile=profile_step(model, OUT_DIR, TRAIN_B,
                                                           "train step"))
    del model
    torch.cuda.empty_cache()


def bridge_model(dev):
    """The recipe's full-width ScoreModel with seeded weights (init_scale 1, so
    that every layer contributes), in train mode."""
    import torch
    from sgmse_tpu_torch.model import ScoreModel

    model = ScoreModel(**BRIDGE, init_scale=1.0)
    model.init_params(torch.Generator().manual_seed(SEED))
    return model.to(dev, memory_format=torch.channels_last).train()


def pesq_speech(batch, length):
    """Seeded (clean, degraded) float32 pairs: harmonic 'speech' under a
    syllable-rate envelope, and the same at 0-30 dB SNR of white noise."""
    rng = np.random.default_rng(SEED + 2)
    n = np.arange(length) / 16000
    ref = []
    for _ in range(batch):
        f0 = rng.uniform(90.0, 250.0)
        x = sum(np.sin(2 * np.pi * f0 * h * n) / h for h in range(1, 8))
        x *= 0.5 * (1.0 + np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * n))
        ref.append(0.3 * x / np.abs(x).max())
    ref = np.stack(ref)
    snr = np.linspace(30.0, 0.0, batch)[:, None]
    sigma = np.sqrt(np.mean(ref ** 2, -1, keepdims=True) / 10 ** (snr / 10))
    deg = ref + sigma * rng.standard_normal(ref.shape)
    return ref.astype(np.float32), deg.astype(np.float32)


def pesq_checks(dev, report):
    """Phase 10a: the PESQ loss and its gradient in ``deg`` on the card (TF32
    allowed for float32 products, which the loss must not take) against the
    CPU, at B=16 crops of the recipe's 32,640 samples; its device time and
    launches per forward+backward call."""
    import torch
    from sgmse_tpu_torch import nfe_profile
    from sgmse_tpu_torch.model import ScoreModel
    from sgmse_tpu_torch.utils.pesq_loss import PesqLoss

    length = ScoreModel(**BRIDGE).spec.target_len
    ref, deg = pesq_speech(BRIDGE_B, length)
    loss_fn = PesqLoss(1.0)

    def call(device):
        r = torch.from_numpy(ref).to(device)
        d = torch.from_numpy(deg).to(device).requires_grad_()
        loss = loss_fn(r, d)
        return loss, torch.autograd.grad(loss.sum(), d)[0]

    loss_cpu, g_cpu = call("cpu")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss, g = (v.cpu() for v in call(dev))
        for _ in range(3):
            call(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PESQ_REPS):
            call(dev)
        end.record()
        torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / PESQ_REPS
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PESQ_TRACED):
                call(dev)
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    trace = OUT_DIR / "pesq_trace.json"
    prof.export_chrome_trace(str(trace))
    traced = nfe_profile.breakdown(json.loads(trace.read_text())["traceEvents"], PESQ_TRACED)
    loss_err = ((loss - loss_cpu).abs().max() / loss_cpu.abs().max()).item()
    grad_err = ((g - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f"PESQ loss B={BRIDGE_B} x {length} samples, card (TF32 allowed) vs CPU: loss "
          f"{[round(v, 5) for v in loss.tolist()]}, rel err {loss_err:.2e} (bound "
          f"{PESQ_LOSS_TOL}); gradient rel err {grad_err:.2e} of max|g| {g_cpu.abs().max():.3e} "
          f"(bound {PESQ_GRAD_TOL}); per forward+backward call: device busy "
          f"{traced['busy_ms']:.3f} ms, {traced['launches']:.0f} launches, wall {wall_ms:.3f} ms")
    if not (torch.isfinite(g).all() and loss_err <= PESQ_LOSS_TOL and grad_err <= PESQ_GRAD_TOL
            and g_cpu.abs().max() > 0):
        raise AssertionError("PESQ loss: card and CPU disagree")
    report["pesq_loss"] = dict(loss=loss.tolist(), loss_rel_err=loss_err, grad_rel_err=grad_err,
                               wall_ms=wall_ms, **traced)
    return report["pesq_loss"]


def bridge_step_checks(dev, report):
    """Phase 10c: one full-width bridge step (B=8) through the kernels against
    the plain versions, with the PESQ term's value; then the recipe's B=16
    step profile."""
    import torch

    model = bridge_model(dev)
    step = step_against_plain(model, dev, BRIDGE_STEP_B, "bridge step")
    x, y, t, z = step.pop("inputs")
    with torch.no_grad():
        mean, std = model.sde.marginal_prob(x, y, t)
        x_hat = model(mean + std[:, None, None, None] * z, y, t)
        n = model.spec.target_len
        term = model._pesq_loss(model.to_audio(x[:, 0], n), model.to_audio(x_hat[:, 0], n))
    term = term.mean().item()
    print(f"  PESQ term of the bridge step: {term:.6f} (x pesq_weight {BRIDGE['pesq_weight']} "
          f"= {BRIDGE['pesq_weight'] * term:.3e} of the loss {step['loss']:.6f})")
    if not (np.isfinite(term) and term > 0):
        raise AssertionError(f"bridge step: PESQ term {term}")
    del x, y, t, z, x_hat
    torch.cuda.empty_cache()
    report["bridge_step"] = dict(step, pesq_term=term, profile=profile_step(
        model, OUT_DIR / "bridge", BRIDGE_B, "bridge step"))
    del model
    torch.cuda.empty_cache()
    return report["bridge_step"]


def write_train_set(root: Path):
    """Seeded clean/noisy pairs of 2.04 s (the 256-frame crop) in the default
    layout: TRAIN_FILES for training, VALID_FILES for validation."""
    from sgmse_tpu_torch.data.wav import write_wav

    rng = np.random.default_rng(SEED)
    n = np.arange(round(WAV_SECONDS * 16000)) / 16000
    for subset, count in (("train", TRAIN_FILES), ("valid", VALID_FILES)):
        for kind in ("clean", "noisy"):
            (root / subset / kind).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            f0 = rng.uniform(90.0, 250.0)
            clean = sum(np.sin(2 * np.pi * f0 * h * n) / h for h in range(1, 8))
            clean *= 0.5 * (1.0 + np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * n))
            clean = 0.3 * clean / np.abs(clean).max()
            noisy = clean + 0.05 * rng.standard_normal(n.shape)
            write_wav(root / subset / "clean" / f"u{i:03d}.wav", clean.astype(np.float32), 16000)
            write_wav(root / subset / "noisy" / f"u{i:03d}.wav", noisy.astype(np.float32), 16000)


@contextlib.contextmanager
def cudnn_tf32():
    """PyTorch's default cuDNN TF32 for the duration, as ``train.main`` runs
    (the kernel checks keep float32 strict)."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def train_run(argv, what, steps, per_validation, validations=1, per_step=TRAIN_LAUNCHES):
    """``train.main(argv)`` with the counters set to 0 just before and read
    just after: ``steps`` train steps of ``per_step`` launches and
    ``validations`` validations of ``per_validation`` launches each, every
    batch (the train steps' and one of the 2 valid files per validation)
    served by the native loader."""
    import torch
    from sgmse_tpu_torch import train
    from sgmse_tpu_torch.data import native

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    served = dict(native.SERVED)
    stats = train.main(argv)
    launches = counters()
    served = {k: v - served[k] for k, v in native.SERVED.items()}
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    losses = [v for _, v in stats["history"]]
    print(f"{what}: {stats['step']} steps in {stats['fit_s']:.1f} s with validation, "
          f"peak {stats['peak_gib']:.2f} GiB, losses {[round(v, 3) for v in losses]}, "
          f"metrics {stats['metrics']}, launches {launches} (per train step "
          f"{per_step} x {steps} + validation {per_validation} x {validations}); "
          f"batches served {served}")
    expected = add(expect(per_step, steps), expect(per_validation, validations))
    if launches != expected or len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{what}: launches {launches} (expected {expected}), "
                             f"losses {losses}")
    if served != {"native": steps + validations, "python": 0}:
        raise AssertionError(f"{what}: batches served {served}, expected "
                             f"{steps + validations} from the native loader and none else")
    return dict(stats, launches=launches, batches_served=served)


def train_entry_point(tmp: Path, report, launches_by_path):
    """Phases 9d and 9e: ``train.main`` (``python -m sgmse_tpu_torch.train``) at
    the JAX defaults, its resume and ``enhance.main --ckpt`` on its checkpoint,
    then a short bfloat16 run; each with the counters set to 0 just before.
    They run as a user runs them, with PyTorch's default cuDNN TF32."""
    from sgmse_tpu_torch import enhance

    root = tmp / "train_set"
    write_train_set(root)
    argv = ["--base_dir", str(root), "--log_dir", str(tmp / "train_logs"), "--nolog",
            "--num_workers", "4"]
    valid_loss = NETS["ncsnpp"]["launches"]  # one batch of the 2 valid files
    validation = {k: v * (1 + EVAL_NFE) for k, v in valid_loss.items()}  # valid loss + eval

    def run(what, extra, steps, valid):
        return train_run(argv + extra, what, steps, valid)

    main_run = run("train entry point", ["--max_steps", str(TRAIN_STEPS), "--num_eval_files",
                                         str(VALID_FILES)], TRAIN_STEPS, validation)
    ckpt_dir = Path(main_run["ckpt_dir"])
    made = sorted(p.name for p in ckpt_dir.iterdir())
    if made != ["best_pesq", "best_si_sdr", "last"]:
        raise AssertionError(f"train entry point wrote {made}")
    logged = [json.loads(line) for line in
              next((tmp / "train_logs" / "sgmse").glob("version_*/metrics.jsonl"))
              .read_text().splitlines()]
    rate = [r["samples_per_sec"] for r in logged if "samples_per_sec" in r]
    print(f"  logged over the {TRAIN_STEPS} steps (the first step's set-up and the data loading "
          f"included): {rate} samples/s, {[r / TRAIN_B for r in rate]} steps/s; checkpoints "
          f"{made}")
    main_run["logged_samples_per_sec"] = rate
    resumed = run("train resume", ["--max_steps", str(TRAIN_STEPS + RESUME_STEPS),
                                   "--num_eval_files", "0", "--ckpt", str(ckpt_dir / "last")],
                  RESUME_STEPS, valid_loss)
    if not resumed["step"] == resumed["num_updates"] == TRAIN_STEPS + RESUME_STEPS:
        raise AssertionError(f"resume: step {resumed['step']}, num_updates "
                             f"{resumed['num_updates']}")
    reset_counters()
    out_dir = tmp / "train_enhanced"
    es = enhance.main(["--test_dir", str(root / "valid" / "noisy"), "--enhanced_dir",
                       str(out_dir), "--ckpt", str(Path(resumed["ckpt_dir"]) / "last"),
                       "--batch_size", "2", "--N", "30", "--timeit"])
    launches = counters()
    evals = es["nfe"] + es["warmup_nfe"]
    print(f"enhance --ckpt of the resumed run: {es['files']} files, NFE {es['nfe']} "
          f"(+{es['warmup_nfe']}), {es['audio_s_per_wall_s']:.3f} audio-s/wall-s, launches "
          f"{launches}")
    if (es["files"] != VALID_FILES or not es["all_finite"] or es["nfe"] != EVAL_NFE
            or launches != expect(NETS["ncsnpp"]["launches"], evals)):
        raise AssertionError(f"enhance --ckpt: {es}, launches {launches}")
    bf16 = run("train bf16", ["--max_steps", str(BF16_STEPS), "--num_eval_files", "0",
                              "--precision", "bfloat16"], BF16_STEPS, valid_loss)
    launches_by_path.update(train=main_run["launches"], train_resume=resumed["launches"],
                            train_enhance=launches, train_bf16=bf16["launches"])
    report["train_entry_point"] = dict(main=main_run, resume=resumed, enhance=es, bf16=bf16)


def bridge_entry_point(tmp: Path, report, launches_by_path):
    """Phases 10d and 10e: ``train.main`` with the bridge recipe's flags on
    phase 9's dataset, then its ``last`` exported to a Lightning ``.ckpt`` and
    imported back, and ``enhance.main --ckpt`` on both directories."""
    import torch
    from sgmse_tpu_torch import checkpoint, convert, enhance

    argv = ["--base_dir", str(tmp / "train_set"), "--log_dir", str(tmp / "bridge_logs"),
            "--nolog", "--num_workers", "4", "--backbone", BRIDGE["backbone"], "--sde",
            BRIDGE["sde"], "--loss_type", BRIDGE["loss_type"], "--pesq_weight",
            str(BRIDGE["pesq_weight"]), "--batch_size", str(BRIDGE_B), "--max_steps",
            str(TRAIN_STEPS), "--num_eval_files", str(VALID_FILES)]
    epochs = -(-TRAIN_STEPS // (TRAIN_FILES // BRIDGE_B))  # one validation per epoch
    validation = {k: v * (1 + BRIDGE_EVAL_NFE) for k, v in NETS["ncsnpp"]["launches"].items()}
    run = train_run(argv, "bridge train entry point", TRAIN_STEPS, validation, epochs)
    launches_by_path["bridge_train"] = run["launches"]
    last = Path(run["ckpt_dir"]) / "last"

    ckpt = convert.export_lightning_checkpoint(last, tmp / "bridge.ckpt")
    convert.convert_lightning_checkpoint(tmp / "bridge.ckpt", tmp / "bridge_imported")
    (s0, c0), (s1, c1) = (checkpoint.load_checkpoint(d) for d in (last, tmp / "bridge_imported"))
    for key in ("params", "ema_params"):
        if list(s0[key]) != list(s1[key]) or not all(
                torch.equal(s0[key][n], s1[key][n]) for n in s0[key]):
            raise AssertionError(f"bridge checkpoint: {key} changed through the .ckpt")
    bins = c0["n_fft"] // 2 + 1
    if c1 != dict(c0, image_size=bins) or (s1["step"], s1["num_updates"]) != (
            s0["step"], s0["step"]):
        raise AssertionError(f"bridge checkpoint: config or step changed through the .ckpt: "
                             f"{c0} -> {c1}, {s0['step']} -> {s1['step']}")
    outs, enhance_launches = [], []
    for i, ckpt_dir in enumerate((last, tmp / "bridge_imported")):
        reset_counters()
        stats = enhance.main(["--test_dir", str(tmp / "noisy_16000"), "--enhanced_dir",
                              str(tmp / f"bridge_enhanced_{i}"), "--ckpt", str(ckpt_dir),
                              "--batch_size", str(B), "--seed", "3"])
        launches = counters()
        if stats["nfe"] != BRIDGE_EVAL_NFE or launches != expect(NETS["ncsnpp"]["launches"],
                                                                 BRIDGE_EVAL_NFE):
            raise AssertionError(f"bridge enhance --ckpt: NFE {stats['nfe']}, launches "
                                 f"{launches}")
        enhance_launches.append(launches)
        outs.append([p.read_bytes() for p in sorted((tmp / f"bridge_enhanced_{i}").glob("*.wav"))])
    launches_by_path["bridge_enhance"] = add(*enhance_launches)
    print(f"bridge checkpoint: {len(ckpt['state_dict'])} tensors and "
          f"{len(ckpt['ema']['shadow_params'])} EMA shadows exported to a Lightning .ckpt "
          f"(image_size {ckpt['hyper_parameters']['image_size']}) and imported: weights and EMA "
          f"bit for bit, config equal; enhance --ckpt on both: {len(outs[0])} wavs, "
          f"{BRIDGE_EVAL_NFE} NFE each, identical {outs[0] == outs[1]}")
    if len(outs[0]) != B or outs[0] != outs[1]:
        raise AssertionError("bridge checkpoint: enhance --ckpt of the exported and re-imported "
                             "checkpoint differs from the original's")
    report["bridge_entry_point"] = dict(train=run, ckpt_tensors=len(ckpt["state_dict"]),
                                        ema_shadows=len(ckpt["ema"]["shadow_params"]))


def write_wavs(dirname: Path, sr: int, seconds: float = WAV_SECONDS, n_files: int = B):
    """Seeded noisy harmonic 'speech' with a syllable-rate envelope."""
    from sgmse_tpu_torch.data.wav import write_wav

    rng = np.random.default_rng(SEED)
    length = round(seconds * sr)
    n = np.arange(length) / sr
    dirname.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        f0 = 110.0 + 40.0 * i
        speech = sum(np.sin(2 * np.pi * f0 * h * n) / h for h in range(1, 8))
        speech *= 0.5 * (1.0 + np.sin(2 * np.pi * 3.0 * n))
        noisy = 0.2 * speech / np.abs(speech).max() + 0.05 * rng.standard_normal(length)
        write_wav(dirname / f"utt{i}.wav", noisy.astype(np.float32), sr)
    return length


def entry_point(tmp: Path, name: str, argv, sr: int, length: int, nfe: int, per_forward):
    """Drive ``enhance.main`` on ``tmp/noisy_<sr>`` with the counters set to 0
    just before and read just after; check the wavs, the NFE and the launches."""
    import torch
    from sgmse_tpu_torch import enhance
    from sgmse_tpu_torch.data.wav import read_wav

    out_dir = tmp / f"enhanced_{name}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    stats = enhance.main(["--test_dir", str(tmp / f"noisy_{sr}"), "--enhanced_dir", str(out_dir),
                          *argv])
    launches = counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    wavs = [read_wav(p) for p in sorted(out_dir.glob("*.wav"))]
    evals = stats["nfe"] + stats["warmup_nfe"]
    print(f"{name} path: {stats['audio_s_per_wall_s']:.3f} audio-s/wall-s (RTF "
          f"{stats['rtf']:.4f}, wall {stats['wall_s']:.3f} s for {stats['audio_s']:.2f} audio-s), "
          f"NFE {stats['nfe']} (+{stats['warmup_nfe']} warm-up), peak memory {peak_gib:.2f} GiB, "
          f"launches {launches}")
    if len(wavs) != B or any(w_sr != sr or w.shape != (1, length) or not np.isfinite(w).all()
                             for w, w_sr in wavs):
        raise AssertionError(f"{name}: expected {B} finite wavs of {length} samples at {sr} Hz, "
                             f"got {[(w.shape, w_sr) for w, w_sr in wavs]}")
    if not stats["all_finite"] or stats["nfe"] != nfe:
        raise AssertionError(f"{name}: finite={stats['all_finite']}, NFE {stats['nfe']} != {nfe}")
    expected = expect(per_forward, evals)
    if launches != expected:
        raise AssertionError(f"{name} launches {launches}, expected {expected}")
    return dict(stats, peak_gib=peak_gib, launches=launches), [w[0] for w, _ in wavs]


def against_plain(what, run):
    """``run()`` -> (waveform, nfe) through the kernels and through the plain
    versions (same generator seed); they must agree within ENHANCE_TOL."""
    from sgmse_tpu_torch import kernel_times as kt

    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        got, nfe = run()
        with kt.routed(plain=True):
            ref, nfe_ref = run()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    notes = sorted({str(w.message).split(";")[0] for w in warned})
    print(f"{what}, kernels vs plain: rel err {rel:.3e} (bound {ENHANCE_TOL}), NFE {nfe}"
          + (f" (plain {nfe_ref})" if nfe_ref != nfe else "") + "".join(f"; {n}" for n in notes))
    if nfe != nfe_ref or not (np.isfinite(got).all() and rel <= ENHANCE_TOL):
        raise AssertionError(f"{what}: rel err {rel} > {ENHANCE_TOL} or NFE {nfe} != {nfe_ref}")
    return dict(rel_err=rel, nfe=nfe, warnings=notes)


def speech(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A seeded noisy harmonic 'speech' waveform under a syllable-rate envelope."""
    rng = np.random.default_rng(seed)
    n = np.arange(round(seconds * sr)) / sr
    x = sum(np.sin(2 * np.pi * rng.uniform(90.0, 250.0) * h * n) / h for h in range(1, 8))
    x *= 0.5 * (1.0 + np.sin(2 * np.pi * 3.0 * n))
    return (0.2 * x / np.abs(x).max() + 0.05 * rng.standard_normal(n.size)).astype(np.float32)


def wav_bytes(y, sr: int) -> bytes:
    from sgmse_tpu_torch.data.wav import write_wav

    buf = io.BytesIO()
    write_wav(buf, y, sr)
    return buf.getvalue()


def http(url: str, body=None, timeout: float = 300.0):
    """(status, body) of a GET, or of a POST of ``body``."""
    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def first_launch_check(report):
    """Phase 11a: a fresh process whose first K1 and K2 launches come from
    FIRST_LAUNCH_THREADS threads at once (``sgmse_tpu_torch.first_launch``)."""
    res = subprocess.run([sys.executable, "-m", "sgmse_tpu_torch.first_launch", "--threads",
                          str(FIRST_LAUNCH_THREADS)], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    lines = res.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    print(f"serve 11a: first K1 (pair) and K2 launches of a fresh process from "
          f"{FIRST_LAUNCH_THREADS} threads at once, each on its own stream, f32 and bf16 at "
          f"{out.get('shape')}: launches {out.get('launches')} (expected "
          f"{out.get('expected_launches')}), worst rel err {out.get('worst_rel_err')}, "
          f"errors {out.get('errors')}")
    if res.returncode != 0 or not out.get("ok"):
        raise AssertionError(f"first launches from threads: rc {res.returncode}\n"
                             f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    report["serve_first_launch"] = out


def serve_kernel_checks(model, shapes, dev, report):
    """Phase 11b: K1 and K2 against their plain versions, as in phase 3 but
    untimed, at every call signature of the network at each served ``(batch,
    frames)`` shape, recorded from a forward through the plain versions."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt

    counts = {}
    for batch, frames in sorted(shapes):
        inputs = kt.network_inputs(dev, kt.F_BINS, batch, frames)
        with torch.inference_mode(), kt.routed(calls=[], plain=True) as calls:
            model.dnn(*inputs)
        for key, n in kt.per_forward(calls).items():
            counts.setdefault(key, n)
        del inputs
    rows = check_kernels(counts, dev, "ncsnpp", timed=False)
    worst = {}
    for r in rows:
        key = f"{r['name']} {r['dtype']}"
        worst[key] = max(worst.get(key, 0.0), r["max_abs_err"] / r["max_abs_ref"])
    print(f"serve 11b kernel checks: {len(rows)} passed over {len(counts)} call signatures of "
          f"the served shapes {sorted(shapes)} (batch, frames), f32 and bf16 at phase 3's "
          f"tolerances; worst error relative to max|plain| {worst}")
    report["serve_kernel_checks"] = dict(shapes=sorted(shapes), signatures=len(counts),
                                         checks=len(rows), worst_rel=worst)
    return rows


def head_of_line(enhancers, sr):
    """Phase 11d: a HOL_LONG_S request on the long path, and HOL_GAP_S later a
    HOL_SHORT_S one, through each enhancer; the seconds from each one's submit
    to its answer."""
    long_wav, short_wav = speech(HOL_LONG_S, sr, SEED + 50), speech(HOL_SHORT_S, sr, SEED + 51)
    out = {}
    for workers, e in enhancers:
        t0 = time.perf_counter()
        f_long = e.submit(long_wav)
        time.sleep(HOL_GAP_S)
        t1 = time.perf_counter()
        f_short = e.submit(short_wav)
        short = f_short.result(timeout=600)
        short_s = time.perf_counter() - t1
        long_out = f_long.result(timeout=600)
        long_s = time.perf_counter() - t0
        for got, wav in ((short, short_wav), (long_out, long_wav)):
            if got.shape != wav.shape or not np.isfinite(got).all():
                raise AssertionError(f"serve head of line: {got.shape} for {wav.shape}")
        out[workers] = dict(short_s=short_s, long_s=long_s)
        print(f"serve 11d head of line with {workers} executor(s): a {HOL_SHORT_S}-s request "
              f"sent {HOL_GAP_S} s after a {HOL_LONG_S}-s one on the long path answered in "
              f"{short_s:.3f} s, the long one in {long_s:.3f} s")
    return out


def burst(enh, wavs, sr):
    """Phase 11d: submit every request at once, wait for all; the counters set
    to 0 just before and read just after."""
    import torch

    before = enh.stats()
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    futs = [enh.submit(w) for w in wavs]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    launches = counters()
    after = enh.stats()
    batches = after["batches"] - before["batches"]
    rows = after["batched_rows"] - before["batched_rows"]
    if any(o.shape != w.shape or not np.isfinite(o).all() for o, w in zip(outs, wavs)):
        raise AssertionError("serve burst: an answer has the wrong length or is not finite")
    expected = expect(NETS["ncsnpp"]["launches"], SERVE_NFE * batches)
    if (launches != expected or rows != len(wavs) or after["errors"]
            or after["long_requests"] != before["long_requests"]):
        raise AssertionError(f"serve burst: launches {launches} (expected {expected} for "
                             f"{batches} batches), rows {rows}, stats {after}")
    audio_s = sum(len(w) for w in wavs) / sr
    return dict(wall_s=wall, audio_s=audio_s, audio_s_per_wall_s=audio_s / wall,
                requests_per_s=len(wavs) / wall, batches=batches, mean_batch_fill=rows / batches,
                launches=launches)


def forwards_on_streams(model, inputs, threads: int, forwards: int, profile=None) -> float:
    """``threads`` threads, each on its own stream, warm up once and then run
    ``forwards`` forwards of ``model`` together; the wall seconds from their
    start to the last one's end. ``profile`` (a torch.profiler.profile) is
    entered just before they start and left after the end."""
    import torch

    ready, go = threading.Barrier(threads + 1), threading.Barrier(threads + 1)
    errors = []

    def body():
        try:
            stream = torch.cuda.Stream(model.device)
            with torch.cuda.stream(stream), torch.inference_mode():
                model(*inputs)
                stream.synchronize()
                ready.wait()
                go.wait()
                for _ in range(forwards):
                    model(*inputs)
                stream.synchronize()
        except BaseException as e:  # noqa: BLE001 - raised below
            ready.abort()
            go.abort()
            errors.append(e)

    pool = [threading.Thread(target=body) for _ in range(threads)]
    for th in pool:
        th.start()
    ready.wait()
    with profile if profile is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        go.wait()
        for th in pool:
            th.join(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall


def stream_overlap_check(model, report):
    """Phase 11d: OVERLAP_FORWARDS x 2 forwards of the served network at
    B=OVERLAP_B from one thread, and from two threads on two streams at once
    (untimed by the profiler, then traced): their wall times, the share of
    device-busy time with both streams' kernels running, and how many of K2's
    cooperative launches ran beside a kernel of the other stream."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt, nfe_profile

    inputs = kt.network_inputs(model.device, kt.F_BINS, OVERLAP_B)
    torch.cuda.synchronize()
    one = forwards_on_streams(model, inputs, 1, 2 * OVERLAP_FORWARDS)
    two = forwards_on_streams(model, inputs, 2, OVERLAP_FORWARDS)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    forwards_on_streams(model, inputs, 2, OVERLAP_FORWARDS, prof)
    trace = OUT_DIR / "serve_streams_trace.json"
    prof.export_chrome_trace(str(trace))
    got = nfe_profile.stream_overlap(json.loads(trace.read_text())["traceEvents"])
    got.update(one_thread_s=one, two_threads_s=two)
    print(f"serve 11d streams: {2 * OVERLAP_FORWARDS} B={OVERLAP_B} bf16 forwards from one thread "
          f"{one:.3f} s, from two threads on two streams {two:.3f} s; traced: {got['streams']} "
          f"streams, busy {got['busy_ms']:.3f} ms, both streams at once "
          f"{got['concurrent_ms']:.3f} ms ({got['concurrent_share']:.1%}); K2 "
          f"{got['keyed_overlapped']} of {got['keyed']} launches beside the other stream's "
          f"kernels")
    report["serve_streams"] = got
    return got


def serve_path(tmp: Path, weights: Path, report, launches_by_path):
    """Phase 11: the serving path on the card (see the module's docstring)."""
    import torch
    from http.server import ThreadingHTTPServer
    from sgmse_tpu_torch import serve, serve_latency
    from sgmse_tpu_torch.data.wav import read_wav

    first_launch_check(report)
    args = serve.build_parser().parse_args(["--weights", str(weights), *SERVE_FLAGS])
    model, enh, sr = serve.build_enhancer(args)
    buckets = serve.warm_buckets(enh, args.warm_seconds, sr)
    # Every shape the dispatcher can launch for the requests below: their
    # buckets (the long path's chunks included) at every power-of-two batch.
    frames = set(buckets) | {enh.bucket_for(round(s * sr)) for s in
                             (*HTTP_SECONDS, *BURST_SECONDS, HOL_SHORT_S, args.chunk_seconds)}
    rows_per_batch = [1 << i for i in range(serve._next_pow2(enh.max_batch).bit_length())]
    rows = serve_kernel_checks(model, {(b, f) for f in frames - {None} for b in rows_per_batch},
                               model.device, report)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    warm_nfe = enh.warmup(buckets)
    print(f"serve 11b: warm-up of buckets {buckets} x batches 1-8 on {len(enh._workers)} "
          f"streams, {warm_nfe} NFE each, {time.time() - t0:.1f} s")

    wavs = [speech(WAV_SECONDS, sr, SEED + 20 + i) for i in range(8)]
    served = np.stack([f.result(timeout=300) for f in [enh.submit(w) for w in wavs]])
    stats = enh.stats()
    yb = np.stack(wavs)
    if (stats["batches"], stats["batched_rows"]) != (1, 8) or yb.shape[1] != \
            enh.samples_for_bucket(enh.bucket_for(yb.shape[1])):
        raise AssertionError(f"serve: eight 2.04-s requests did not run as one full batch: "
                             f"{stats}, {yb.shape}")
    direct = model.enhance(yb, generator=enh.generator(0), pad_mode=enh.pad_mode,
                           **enh.sampler_kwargs)
    rel = float(np.abs(served - direct).max() / np.abs(direct).max())
    bitwise = bool(np.array_equal(served, direct))
    print(f"serve 11b: batch 0 (8 x 2.04 s) served on an executor's stream against "
          f"model.enhance of the same batch and generator on the default stream: rel err "
          f"{rel:.3e} (bound {SERVE_TOL}), bit for bit {bitwise}")
    if not (np.isfinite(served).all() and rel <= SERVE_TOL):
        raise AssertionError(f"serve: the served batch differs from the direct one: {rel}")
    report["serve_batch"] = dict(rel_err=rel, bitwise=bitwise, warm_nfe=warm_nfe)

    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(enh, sr))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    single = None
    try:
        answers = {}
        asks = [threading.Thread(target=lambda s=s, i=i: answers.__setitem__(
            s, http(url + "/enhance", wav_bytes(speech(s, sr, SEED + 30 + i), sr))))
            for i, s in enumerate(HTTP_SECONDS)]
        for th in asks:
            th.start()
        for th in asks:
            th.join(timeout=600)
        got = {}
        for s in HTTP_SECONDS:
            status, body = answers.get(s, (None, b""))
            out, out_sr = read_wav(io.BytesIO(body)) if status == 200 else (np.zeros((0, 0)), 0)
            got[s] = (status, out.shape)
            if status != 200 or out_sr != sr or out.shape != (1, round(s * sr)) or \
                    not np.isfinite(out).all():
                raise AssertionError(f"serve HTTP: {s}-s request answered {status}, "
                                     f"{out.shape} at {out_sr} Hz: {body[:300]!r}")
        health = json.loads(http(url + "/healthz")[1])
        stats = json.loads(http(url + "/stats")[1])
        print(f"serve 11c: HTTP {', '.join(f'{s} s -> {st} {sh}' for s, (st, sh) in got.items())}; "
              f"/healthz {health}; /stats long_requests {stats['long_requests']}, batches "
              f"{stats['batches']}, errors {stats['errors']}")
        if health != {"status": "ok"} or stats["long_requests"] != 1 or stats["errors"]:
            raise AssertionError(f"serve HTTP: /healthz {health}, /stats {stats}")
        report["serve_http"] = dict(answers={str(s): v for s, v in got.items()}, stats=stats)

        burst_wavs = [speech(BURST_SECONDS[i % len(BURST_SECONDS)], sr, SEED + 40 + i)
                      for i in range(BURST_REQUESTS)]
        burst_buckets = sorted({enh.bucket_for(len(w)) for w in burst_wavs})
        single = serve.BatchingEnhancer(
            model, max_batch=enh.max_batch, max_delay_ms=args.max_delay_ms,
            max_seconds=args.max_seconds, sampler_kwargs=enh.sampler_kwargs,
            pad_mode=enh.pad_mode, seed=args.seed, chunk_seconds=args.chunk_seconds,
            max_pending=args.max_pending, execute_workers=1)
        bursts = {}
        for workers, e in ((1, single), (4, enh)):
            e.warmup(burst_buckets, [enh.max_batch])
            bursts[workers] = b = burst(e, burst_wavs, sr)
            print(f"serve 11d: closed burst of {BURST_REQUESTS} requests ({BURST_SECONDS} s) with "
                  f"{workers} executor(s): {b['audio_s_per_wall_s']:.3f} audio-s/wall-s, "
                  f"{b['requests_per_s']:.3f} requests/s, wall {b['wall_s']:.3f} s, "
                  f"{b['batches']} batches, mean fill {b['mean_batch_fill']:.2f}, launches "
                  f"{b['launches']}")
        launches_by_path["serve"] = add(bursts[1]["launches"], bursts[4]["launches"])
        report["serve_burst"] = bursts
        report["serve_head_of_line"] = head_of_line(((4, enh), (1, single)), sr)
        stream_overlap_check(model, report)

        bodies = [wav_bytes(w, sr) for w in burst_wavs[:len(BURST_SECONDS)]]
        labels = [f"{s:.2f}s" for s in BURST_SECONDS]
        report["serve_open_loop"] = {}
        for share in OPEN_LOOP_SHARES:
            rate = share * bursts[4]["requests_per_s"]
            r = serve_latency.run_rate(url, bodies, labels, rate, OPEN_LOOP_S, timeout=120.0)
            report["serve_open_loop"][str(share)] = r
            per = "; ".join(f"{k} p50 {v['p50_ms']} p95 {v['p95_ms']} p99 {v['p99_ms']} ok "
                            f"{v['ok']}/{v['sent']}" for k, v in r["per_bucket"].items())
            print(f"serve 11d: open loop at {share:.0%} of the burst's requests/s ({rate:.3f}/s, "
                  f"{OPEN_LOOP_S:.0f} s): ok {r['ok']}/{r['sent']}, 503s {r['rejected']}, failed "
                  f"{r['failed']}, p50 {r['p50_ms']} ms, p95 {r['p95_ms']}, p99 {r['p99_ms']}, "
                  f"{r['throughput_rps']:.3f} answers/s; per bucket: {per}")
        half = report["serve_open_loop"][str(OPEN_LOOP_SHARES[0])]
        if half["ok"] != half["sent"]:
            raise AssertionError(f"serve open loop at {OPEN_LOOP_SHARES[0]:.0%}: {half}")
        stats = enh.stats()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"serve 11: peak device memory {peak:.2f} GiB; stats {stats}")
        if stats["errors"]:
            raise AssertionError(f"serve: {stats['errors']} requests failed")
        report["serve_stats"], report["serve_peak_gib"] = stats, peak
    finally:
        server.shutdown()
        server.server_close()
        if single is not None:
            single.close()
        enh.close()
    del model
    torch.cuda.empty_cache()
    return rows


def residual_checks(tmp: Path, report, launches_by_path, dev):
    """Phases 12a-c: the 48 kHz net with residual pyramids and the ncsnpp
    variant at full width: their kernel signatures against the plain versions
    (K1 at up = down = 1, K2 without SiLU) and timed, their forwards through
    the kernels against the plain versions; every call signature of the
    residual net's B=8 train step (the K1 adjoint at up = down = 1, K2b) and
    that step against the plain versions; the residual net through the entry
    point with ``--config`` (four 2.04-s 48 kHz wavs, PC N=30 + ald, bf16).
    Returns (kernel rows, train kernel rows)."""
    import torch
    from sgmse_tpu_torch import convert, kernel_times as kt
    from sgmse_tpu_torch.model import ScoreModel

    arch, settings = kt.VARIANTS["48k_residual"]
    model, rows = network_checks("48k_residual", dev, report)
    weights = tmp / "weights_48k_residual.npz"
    convert.save_npz(weights, convert.jax_tree_from_state_dict(model.dnn.state_dict()))
    del model
    torch.cuda.empty_cache()
    model, variant_rows = network_checks("ncsnpp_variant", dev, report)
    del model
    torch.cuda.empty_cache()
    train_rows = train_kernel_checks(dev, report, "48k_residual", TRAIN_B, "48k residual train",
                                     RESIDUAL_TRAIN_LAUNCHES)
    model = kt.full_model(dev, backbone=arch, **settings).train()
    step = step_against_plain(model, dev, TRAIN_B, "48k residual train step",
                              RESIDUAL_TRAIN_LAUNCHES, kt.BINS[arch], plain_remat=True)
    del step["inputs"], model
    torch.cuda.empty_cache()
    report["residual_train_step"] = step

    config = ScoreModel(arch, "ouve", **CONFIG_48K, **settings).config_dict()
    (tmp / "k48_residual.json").write_text(json.dumps(config))
    length = write_wavs(tmp / "noisy_48000", 48000)
    with cudnn_tf32():
        report["path_48k_residual"], _ = entry_point(
            tmp, "48k_residual", ["--weights", str(weights), "--config",
                                  str(tmp / "k48_residual.json"), "--batch_size", "4", "--N",
                                  "30", "--corrector", "ald", "--snr", "0.5", "--precision",
                                  "bfloat16", "--timeit"],
            48000, length, 60, NETS["48k_residual"]["launches"])
    launches_by_path["48k_residual"] = report["path_48k_residual"]["launches"]
    return rows + variant_rows, train_rows


def dcunet_model(dev, **overrides):
    """DilDCUNet-v2 as the JAX training CLI builds it at n_fft 512
    (``nfe_profile.DCUNET``) with seeded weights; two train-mode forwards on
    seeded inputs move its BatchNorm statistics off their initial values."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt
    from sgmse_tpu_torch.model import ScoreModel
    from sgmse_tpu_torch.nfe_profile import DCUNET, DCUNET_BINS

    model = ScoreModel("dcunet", "ouve", **DCUNET, **overrides)
    model.init_params(torch.Generator().manual_seed(SEED))
    model = model.to(dev, memory_format=torch.channels_last).train()
    x, y, t = kt.network_inputs(dev, DCUNET_BINS)
    with torch.no_grad():
        for _ in range(2):
            model.dnn(x, y, t)
    return model.eval()


def bn_statistics_cost(dev) -> dict:
    """Device busy ms, forward and backward, of DCUNet bN's train-mode
    statistics (``models/dcunet.py`` ``BatchStatistics``: float64 sums, a
    one-pass float32 backward) against three other ways of taking them: the
    earlier float32 means of x and x^2, Welford's float32 pass
    (``torch.var_mean``) and autograd through the float64 sums, on the
    inputs of every bN of one train-mode forward at the B=DCUNET_TRAIN_B
    step's shapes, all profiled in this call."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt
    from sgmse_tpu_torch import nfe_profile
    from sgmse_tpu_torch.models.dcunet import BatchNormOnReIm, BatchStatistics

    model = dcunet_model(dev).train()
    inputs = []
    hooks = [m.register_forward_hook(lambda _m, args, _out: inputs.append(args[0].detach()))
             for m in model.dnn.modules() if isinstance(m, BatchNormOnReIm)]
    x, y, t = kt.network_inputs(dev, nfe_profile.DCUNET_BINS, batch=DCUNET_TRAIN_B,
                                frames=model.spec.num_frames)
    with torch.no_grad():
        model.dnn(x, y, t)
    for h in hooks:
        h.remove()
    del model
    dims = (1, 3, 4)

    def moments(v, dtype):  # E[x^2] - E[x]^2 from sums in ``dtype``
        sums = torch.stack([v.sum(dim=dims, dtype=dtype), (v * v).sum(dim=dims, dtype=dtype)])
        mean, mean_sq = sums / (v.shape[1] * v.shape[3] * v.shape[4])
        return mean.float(), torch.clamp_min(mean_sq - mean * mean, 0.0).float()

    def welford(v):
        var, mean = torch.var_mean(v, dim=dims, correction=0)
        return mean, var

    ways = {"module": BatchStatistics.apply, "float32_moments": lambda v: moments(v, torch.float32),
            "welford": welford, "float64_sums_autograd": lambda v: moments(v, torch.float64)}

    def statistics(way):
        for a in inputs:
            mean, var = way(a.view(2, a.shape[0] // 2, *a.shape[1:]).requires_grad_())
            (mean.sum() + var.sum()).backward()

    out = dict(layers=len(inputs))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, way in ways.items():
        statistics(way)  # warm-up
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            statistics(way)
            torch.cuda.synchronize()
        trace = OUT_DIR / "bn_statistics_trace.json"
        prof.export_chrome_trace(str(trace))
        b = nfe_profile.breakdown(json.loads(trace.read_text())["traceEvents"], 1)
        trace.unlink()
        out[name] = dict(busy_ms=b["busy_ms"], launches=b["launches"])
    del inputs
    torch.cuda.empty_cache()
    return out


def dcunet_checks(tmp: Path, report, launches_by_path, dev):
    """Phase 12d: DCUNet. The entry point with ``--config`` (four 2.04-s wavs,
    PC N=30 + ald) in bfloat16 and float32; bf16 against f32 on one
    evaluation; the CbN variant on a short input (and its batch coupling);
    ``nfe_profile`` of one B=4 bf16 evaluation; ``train.main`` at B=8 on phase
    9's dataset for 10 steps with validation, a train-step profile; a resume
    from ``last`` whose first step starts from the saved statistics bit for
    bit; ``enhance.main --ckpt``; and ``last`` through a Lightning ``.ckpt``
    and back: weights, EMA and statistics bit for bit, identical wavs. DCUNet
    runs no hand-written kernel: every count must stay 0."""
    import torch
    from sgmse_tpu_torch import checkpoint, convert, enhance, nfe_profile, train
    from sgmse_tpu_torch import kernel_times as kt
    from sgmse_tpu_torch.nfe_profile import DCUNET_BINS

    model = dcunet_model(dev)
    n_params = sum(p.numel() for p in model.dnn.parameters())
    n_stats = sum(b.numel() for b in model.dnn.buffers())
    if (n_params, n_stats) != (DCUNET_PARAMS, DCUNET_STATS):
        raise AssertionError(f"DCUNet: {n_params} params, {n_stats} statistics")
    weights, config = tmp / "dcunet.npz", tmp / "dcunet.json"
    convert.save_npz(weights, convert.jax_variables_from_state_dict(model.dnn.state_dict()))
    config.write_text(json.dumps(model.config_dict()))
    length = write_wavs(tmp / "noisy_16000", 16000)
    none = {k: 0 for k in NETS["ncsnpp"]["launches"]}
    with cudnn_tf32():
        for precision in ("bfloat16", "float32"):
            report[f"dcunet_{precision}"], _ = entry_point(
                tmp, f"dcunet_{precision}",
                ["--weights", str(weights), "--config", str(config), "--batch_size", "4", "--N",
                 "30", "--corrector", "ald", "--snr", "0.5", "--precision", precision,
                 "--timeit"], 16000, length, 60, none)
            launches_by_path[f"dcunet_{precision}"] = report[f"dcunet_{precision}"]["launches"]

    x, y, t = kt.network_inputs(dev, DCUNET_BINS)
    bf16 = dcunet_model(dev, precision="bfloat16")
    with torch.inference_mode():
        out32, out16 = model(x, y, t), bf16(x, y, t)
    rel = ((out16 - out32).abs().max() / out32.abs().max()).item()
    print(f"DCUNet B={B} F={DCUNET_BINS} T={kt.T_FRAMES}: {n_params} params, {n_stats} BatchNorm "
          f"statistics; bf16 vs f32 output rel err {rel:.3e} (bound {DCUNET_BF16_F32_TOL})")
    if not (torch.isfinite(torch.view_as_real(out16)).all() and rel <= DCUNET_BF16_F32_TOL):
        raise AssertionError(f"DCUNet bf16 vs f32: {rel}")
    prof = nfe_profile.evaluation_profile(bf16, x, y, t, OUT_DIR, "dcunet_nfe_trace.json")
    prof["epilogue_bound"] = nfe_profile.dcunet_epilogue_bound(bf16, x, y, t)
    print(f"DCUNet evaluation profile, B={B} bf16: wall {prof['wall_ms']:.2f} ms per NFE, device "
          f"busy {prof['busy_ms']:.2f} ms (idle {prof['idle_share_untraced']:.1%} untraced), "
          f"{prof['launches']:.0f} launches; kinds "
          + ", ".join(f"{k} {v['ms']:.2f} ms/{v['launches']:.0f}" for k, v in prof["kinds"].items())
          + f"; the {prof['epilogue_bound']['blocks']} block epilogues' byte bound (K7) "
          f"{prof['epilogue_bound']['bound_ms']:.3f} ms")
    report["dcunet_nfe_profile"] = prof
    report["dcunet_bf16_vs_f32"] = rel
    del bf16, out32, out16

    cbn = dcunet_model(dev, dcunet_norm_type="CbN")
    short = speech(1.0, 16000, SEED + 5)
    with cudnn_tf32():
        got, nfe, _ = cbn.enhance(short, generator=torch.Generator(device=dev).manual_seed(1),
                                  N=5, timeit=True)
        with torch.inference_mode():
            pair = cbn(x[:2], y[:2], t[:2])[:1]
            alone = cbn(x[:1], y[:1], t[:1])
    coupling = ((pair - alone).abs().max() / alone.abs().max()).item()
    print(f"DCUNet CbN: short enhance {got.shape[0]} samples, NFE {nfe}, finite "
          f"{bool(np.isfinite(got).all())}; row 0 alone vs beside row 1 differs by {coupling:.3e} "
          f"of max|out| (batch statistics in eval mode, as in the JAX package)")
    if not (np.isfinite(got).all() and got.shape == short.shape and coupling > 0):
        raise AssertionError("DCUNet CbN: short enhance not finite, or no batch coupling")
    report["dcunet_cbn"] = dict(nfe=nfe, batch_coupling=coupling)
    del cbn, model
    torch.cuda.empty_cache()

    root = tmp / "train_set"
    if not root.exists():
        write_train_set(root)
    argv = ["--base_dir", str(root), "--log_dir", str(tmp / "dcunet_logs"), "--nolog",
            "--num_workers", "4", "--backbone", "dcunet", "--n_fft", "512", "--hop_length",
            "128", "--batch_size", str(DCUNET_TRAIN_B)]
    with cudnn_tf32():
        run = train_run(argv + ["--max_steps", str(TRAIN_STEPS), "--num_eval_files",
                                str(VALID_FILES)], "DCUNet train entry point", TRAIN_STEPS,
                        none, per_step=none)
        last = Path(run["ckpt_dir"]) / "last"
        saved, saved_config = checkpoint.load_checkpoint(last)
        if len(saved.get("model_state", {})) != 4 * 11:
            raise AssertionError(f"DCUNet last: model_state {list(saved.get('model_state', {}))}")
        seen, step = [], train.train_step

        def first_step(model, state, *args, **kwargs):
            if not seen:
                seen.append({n: b.detach().cpu().clone() for n, b in model.dnn.named_buffers()})
            return step(model, state, *args, **kwargs)

        train.train_step = first_step
        try:
            resumed = train_run(argv + ["--max_steps", str(TRAIN_STEPS + RESUME_STEPS),
                                        "--num_eval_files", "0", "--ckpt", str(last)],
                                "DCUNet train resume", RESUME_STEPS, none, per_step=none)
        finally:
            train.train_step = step
        restored = seen and all(torch.equal(seen[0][n], v)
                                for n, v in saved["model_state"].items())
        print(f"DCUNet resume: the first step after the resume starts from the saved statistics "
              f"bit for bit: {bool(restored)}")
        if not restored or resumed["step"] != TRAIN_STEPS + RESUME_STEPS:
            raise AssertionError("DCUNet resume: statistics not restored")
        profile = nfe_profile.train_step_profile(dcunet_model(dev).train(), OUT_DIR,
                                                 DCUNET_TRAIN_B,
                                                 trace_name="dcunet_train_trace.json")
        print(f"DCUNet train step profile, B={DCUNET_TRAIN_B} f32, cuDNN TF32 on: "
              f"{profile['steps_per_s']:.2f} steps/s, device busy {profile['busy_ms']:.1f} ms "
              f"(idle {profile['idle_share_untraced']:.1%} untraced), {profile['launches']:.0f} "
              f"launches, peak {profile['peak_gib']:.2f} GiB; kinds "
              + ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in profile["kinds"].items()))
        bn_cost = bn_statistics_cost(dev)
        print(f"DCUNet bN train statistics of one B={DCUNET_TRAIN_B} step ({bn_cost['layers']} "
              f"bN layers, forward and backward, device busy): the module's (float64 sums, "
              f"one-pass backward) {bn_cost['module']['busy_ms']:.3f} ms, float32 E[x^2] - "
              f"E[x]^2 (the earlier way) {bn_cost['float32_moments']['busy_ms']:.3f} ms, Welford "
              f"{bn_cost['welford']['busy_ms']:.3f} ms, autograd through float64 sums "
              f"{bn_cost['float64_sums_autograd']['busy_ms']:.3f} ms, against the step's "
              f"{profile['busy_ms']:.1f} ms")

        last = Path(resumed["ckpt_dir"]) / "last"
        ckpt = convert.export_lightning_checkpoint(last, tmp / "dcunet.ckpt")
        convert.convert_lightning_checkpoint(tmp / "dcunet.ckpt", tmp / "dcunet_imported")
        (s0, c0), (s1, c1) = (checkpoint.load_checkpoint(d) for d in (last, tmp / "dcunet_imported"))
        for key in ("params", "ema_params", "model_state"):
            if list(s0[key]) != list(s1[key]) or not all(
                    torch.equal(s0[key][n], s1[key][n]) for n in s0[key]):
                raise AssertionError(f"DCUNet checkpoint: {key} changed through the .ckpt")
        if c1 != c0:
            raise AssertionError(f"DCUNet checkpoint: config changed: {c0} -> {c1}")
        outs, enhance_launches = [], {}
        for i, ckpt_dir in enumerate((last, tmp / "dcunet_imported")):
            reset_counters()
            stats = enhance.main(["--test_dir", str(root / "valid" / "noisy"), "--enhanced_dir",
                                  str(tmp / f"dcunet_enhanced_{i}"), "--ckpt", str(ckpt_dir),
                                  "--batch_size", "2", "--N", "30", "--seed", "3"])
            enhance_launches[f"dcunet_enhance_ckpt_{i}"] = counters()
            if stats["nfe"] != EVAL_NFE or not stats["all_finite"]:
                raise AssertionError(f"DCUNet enhance --ckpt: {stats}")
            outs.append([p.read_bytes() for p in sorted((tmp / f"dcunet_enhanced_{i}").glob("*.wav"))])
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in ckpt["state_dict"])
    print(f"DCUNet checkpoint: {len(ckpt['state_dict'])} tensors ({n_stats} running-statistics "
          f"tensors) and {len(ckpt['ema']['shadow_params'])} EMA shadows to a Lightning .ckpt "
          f"and back: weights, EMA and statistics bit for bit, config equal; enhance --ckpt on "
          f"both: {len(outs[0])} wavs, {EVAL_NFE} NFE each, identical {outs[0] == outs[1]}")
    if len(outs[0]) != VALID_FILES or outs[0] != outs[1]:
        raise AssertionError("DCUNet checkpoint: enhance --ckpt differs after the round trip")
    launches_by_path.update(dcunet_train=run["launches"], dcunet_resume=resumed["launches"],
                            **enhance_launches)
    for name in ("dcunet_bfloat16", "dcunet_float32", "dcunet_train", "dcunet_resume",
                 *enhance_launches):
        if any(launches_by_path[name].values()):
            raise AssertionError(f"{name}: DCUNet launched a hand-written kernel: "
                                 f"{launches_by_path[name]}")
    report["dcunet_train"] = dict(train=run, resume=resumed, profile=profile, bn_cost=bn_cost,
                                  ckpt_tensors=len(ckpt["state_dict"]))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def world_of_one(dev):
    """A process group of this process alone, NCCL, for the duration."""
    import torch
    from sgmse_tpu_torch import parallel

    parallel.init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, dev)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the duration: two runs of the same
    steps then give the same bits (some weight-gradient algorithms add in an
    order that varies from run to run)."""
    import torch

    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def dp_world_of_one(tmp: Path, report, launches_by_path, dev):
    """Phase 13a: ``train.main`` at the JAX defaults (B=8, f32, PyTorch's
    default TF32) for DP_TRAIN_STEPS steps on phase 9's dataset, once alone and
    once as the one rank of an NCCL group (the bootstrap flags): the final
    parameters, EMA and state bit for bit; then both steps' profiles, the
    group's with its gradient all-reduce's NCCL kernels."""
    import torch
    from sgmse_tpu_torch import checkpoint, nfe_profile
    from sgmse_tpu_torch import kernel_times as kt

    root = tmp / "train_set"
    if not root.exists():
        write_train_set(root)
    base = ["--base_dir", str(root), "--nolog", "--num_workers", "4", "--max_steps",
            str(DP_TRAIN_STEPS), "--num_eval_files", "0", "--seed", str(SEED)]
    valid_loss = NETS["ncsnpp"]["launches"]
    runs = {}
    with cudnn_tf32(), cudnn_deterministic():
        runs["alone"] = train_run(base + ["--log_dir", str(tmp / "dp_alone")],
                                  "13a train.main alone", DP_TRAIN_STEPS, valid_loss)
        runs["group"] = train_run(base + ["--log_dir", str(tmp / "dp_nccl"), "--num_processes",
                                        "1", "--process_id", "0", "--coordinator_address",
                                        f"127.0.0.1:{free_port()}"],
                                "13a train.main as a world of one (NCCL)", DP_TRAIN_STEPS,
                                valid_loss)
    trees = {k: checkpoint.load_checkpoint(Path(r["ckpt_dir"]) / "last")[0]
             for k, r in runs.items()}
    differ = [f"{part}/{n}" for part in ("params", "ema_params")
              for n, t in trees["alone"][part].items()
              if not torch.equal(t, trees["group"][part][n])]
    same = runs["alone"]["state_sha256"] == runs["group"]["state_sha256"]
    print(f"13a: {DP_TRAIN_STEPS} steps alone and as a world of one: losses "
          f"{[round(v, 6) for _, v in runs['alone']['history']]} and "
          f"{[round(v, 6) for _, v in runs['group']['history']]}; parameters and EMA bit for bit: "
          f"{not differ and same} ({len(trees['alone']['params'])} leaves each)")
    if differ or not same or runs["alone"]["history"] != runs["group"]["history"]:
        raise AssertionError(f"13a: the world of one differs from the plain run: {differ[:5]}")
    launches_by_path["dp_train"] = runs["group"]["launches"]
    profiles = {}
    with cudnn_tf32():
        model = kt.full_model(dev).train()
        profiles["alone"] = nfe_profile.train_step_profile(model, OUT_DIR, TRAIN_B,
                                                           trace_name="dp_alone_trace.json")
        with world_of_one(dev):
            profiles["group"] = nfe_profile.train_step_profile(
                model, OUT_DIR, TRAIN_B, trace_name="dp_trace.json")
        del model
    torch.cuda.empty_cache()
    for k, p in profiles.items():
        nccl = p["kinds"].get("NCCL collectives", dict(ms=0.0, launches=0.0))
        print(f"13a step profile {k}, B={TRAIN_B}: {p['wall_ms']:.1f} ms wall, device busy "
              f"{p['busy_ms']:.2f} ms, {p['launches']:.0f} launches, NCCL {nccl['ms']:.3f} ms "
              f"in {nccl['launches']:.0f} kernels, peak {p['peak_gib']:.2f} GiB")
    extra = profiles["group"]["busy_ms"] - profiles["alone"]["busy_ms"]
    print(f"13a data-parallel overhead (world of one): {extra:+.3f} ms busy on "
          f"{profiles['alone']['busy_ms']:.2f} ({extra / profiles['alone']['busy_ms']:+.2%}), "
          f"{profiles['group']['launches'] - profiles['alone']['launches']:+.0f} launches")
    report["dp_world_of_one"] = dict(runs={k: {key: r[key] for key in (
        "history", "state_sha256", "launches", "fit_s")} for k, r in runs.items()},
        profiles=profiles, busy_ms_overhead=extra)


def _run_steps(model, x, y, steps, rank, world, ref_path=None):
    """``steps`` train steps of ``model`` on this rank's rows of the global
    waveform batch (x, y), the draws from one seeded generator: the losses,
    the first step's gradients and model state (or, given ``ref_path``, each
    leaf's error against the ones saved there, relative to its max|ref|, the
    attention key biases against the largest gradient), the launches and a
    digest of the final parameters."""
    import hashlib

    import torch
    from sgmse_tpu_torch import train

    dev = model.device
    state = train.create_train_state(model, torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b = x.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    xr, yr = (torch.from_numpy(a[rows]).to(dev) for a in (x, y))
    losses, first = [], None
    reset_counters()
    for step in range(steps):
        loss, grads = train.compute_gradients(model, state, xr, yr, gen)
        losses.append(loss.item())
        train.apply_gradients(state, grads, model.ema_decay)  # averages grads over the ranks
        if step == 0:
            first = dict(grads={n: g.detach().cpu() for n, g in grads.items()},
                         stats={n: t.detach().cpu() for n, t in state.model_state.items()})
    torch.cuda.synchronize()
    launches = counters()
    digest = hashlib.sha256()
    for n, p in state.params.items():
        digest.update(n.encode() + p.detach().cpu().numpy().tobytes())
    out = dict(losses=losses, launches=launches, digest=digest.hexdigest())
    if ref_path is None:
        return out, first
    ref = torch.load(ref_path)
    largest = max(g.abs().max().item() for g in ref["grads"].values())

    def rel(n, g):
        err = (g - ref["grads"][n]).abs().max().item()
        scale = largest if n.endswith("NIN_1.b") else ref["grads"][n].abs().max().item()
        return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))

    out["grad_err"] = {n: rel(n, g) for n, g in first["grads"].items()}
    out["stats_err"] = {n: (t - ref["stats"][n]).abs().max().item() for n, t in
                        first["stats"].items()}
    return out, None


def two_rank_entry(rank, world, init_method, kind, x, y, steps, ref_path):
    """Phases 13b and 13c: one of two ranks on the one card, gloo on CUDA
    tensors (a test arrangement: NCCL refuses two ranks on one device). The
    model is built before the group starts, so that its construction reduces
    nothing."""
    import torch
    from sgmse_tpu_torch import kernels, parallel

    torch.backends.cudnn.allow_tf32 = False  # as the one-process run in the parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = False  # see two_ranks
    dev = torch.device("cuda", 0)
    kernels.lib()
    model = (full_flagship(dev) if kind == "ncsnpp" else dcunet_model(dev)).train()
    parallel.init_process_group(init_method, world, rank, dev, backend="gloo")
    return _run_steps(model, x, y, steps, rank, world, ref_path)[0]


def full_flagship(dev):
    """The flagship as ``train.main`` builds it (the DDPM init, init_scale 0,
    drawn again by ``create_train_state``). kernel_times.full_model's init_scale
    1 makes the first Adam step (about lr * sign(g) on every weight) multiply
    the loss by ~14, so that the sign of the gradients that round near zero
    moves the next loss by ~1e-6 (PERF.md §6)."""
    import torch
    from sgmse_tpu_torch.model import ScoreModel

    return ScoreModel("ncsnpp", "ouve").to(dev, memory_format=torch.channels_last)


def two_ranks(tmp: Path, report, dev, kind, steps):
    """Phase 13b (``ncsnpp``) or 13c (``dcunet``): two gloo ranks at B=4 each
    against one process at B=8 on the same rows with the same draws."""
    import torch
    from sgmse_tpu_torch.parallel import dist as pdist

    rng = np.random.default_rng(SEED + 13)
    shape = (2 * B, 255 * 128)  # 256 frames at hop 128
    x = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    model = (full_flagship(dev) if kind == "ncsnpp" else dcunet_model(dev)).train()
    # Both sides convolve without cuDNN (im2col and cuBLAS, f32): cuDNN picks its
    # weight-gradient algorithm by batch size, and at B=4 against B=8 (TF32 off) the
    # flagship's first convolution's gradient differed by 5.7e-5 of its max|g| in a first
    # call, which says nothing about the ranks' reduction.
    torch.backends.cudnn.enabled = False
    try:
        alone, first = _run_steps(model, x, y, steps, 0, 1)
    finally:
        torch.backends.cudnn.enabled = True
    del model
    torch.cuda.empty_cache()
    ref_path = tmp / f"two_rank_ref_{kind}.pt"
    torch.save(first, ref_path)
    del first
    t0 = time.time()
    ranks = pdist.spawn(two_rank_entry, 2, (kind, x, y, steps, str(ref_path)), timeout=600)
    global_losses = [float(np.mean(v)) for v in zip(*(r["losses"] for r in ranks))]
    loss_err = max(abs(g - a) / abs(a) for g, a in zip(global_losses, alone["losses"]))
    worst = sorted(((e, n) for r in ranks for n, e in r["grad_err"].items()), reverse=True)
    grad_err = (worst[0][1], worst[0][0])
    spread = {f"> {t:g}": sum(e > t for e, _ in worst) // 2 for t in (1e-3, 1e-4, 1e-5)}
    print(f"  the worst leaves of the ranks' gradients against one process: "
          f"{[(n, f'{e:.2e}') for e, n in worst[:8:2]]}; leaves of {len(worst) // 2} {spread}")
    loss_tol, grad_tol = ((DP_LOSS_RTOL, DP_GRAD_TOL) if kind == "ncsnpp"
                          else (DCUNET_DP_LOSS_RTOL, DCUNET_DP_GRAD_TOL))
    what = "13b flagship" if kind == "ncsnpp" else "13c DCUNet bN"
    stats = ""
    if kind == "dcunet":  # each BatchNorm's (re or im) mean and var against their scale
        scale = {}
        for n, t in torch.load(ref_path)["stats"].items():
            norm = n.rsplit(".", 1)[0]
            scale[norm] = max(scale.get(norm, 0.0), t.abs().max().item())
        stats_err = max(e / scale[n.rsplit(".", 1)[0]]
                        for r in ranks for n, e in r["stats_err"].items())
        stats = (f"; running statistics {stats_err:.2e} of their scale (bound "
                 f"{DCUNET_DP_STATS_TOL})")
    print(f"{what}: two gloo ranks on one card, B={B} each, {steps} step(s), against one "
          f"process at B={2 * B} ({time.time() - t0:.1f} s with the ranks' start): global "
          f"losses {global_losses} vs {alone['losses']} (worst {loss_err:.2e}, bound {loss_tol}); "
          f"worst first-step leaf gradient {grad_err[1]:.2e} ({grad_err[0]}; bound {grad_tol})"
          f"{stats}; the ranks' parameters bit for bit: {ranks[0]['digest'] == ranks[1]['digest']}"
          f"; launches per rank {ranks[0]['launches']}")
    if (ranks[0]["digest"] != ranks[1]["digest"] or loss_err > loss_tol
            or grad_err[1] > grad_tol or (kind == "dcunet" and stats_err > DCUNET_DP_STATS_TOL)):
        raise AssertionError(f"{what}: two ranks differ from one process")
    report[f"two_ranks_{kind}"] = dict(global_losses=global_losses, alone=alone["losses"],
                                       loss_err=loss_err, grad_err=grad_err,
                                       rank_launches=[r["launches"] for r in ranks])


def data_parallel_enhance(report, launches_by_path, dev):
    """Phase 13d: ``enhance`` through two workers on the one card
    (``parallel.pool``, the device list ``["cuda:0", "cuda:0"]``), at B=4 and
    B=3, f32 and bf16, PC N=DP_N + ald on 1-s inputs: each worker's rows
    equal, bit for bit, the one-device call on those rows with the padded
    batch's draws (``parallel.global_rows``); in f32 the output is within
    DP_TOL of the one-device call on the whole zero-padded batch. In bf16 the
    one device alone moves by ~2e-2 between a batch of 2 and one of 4 (its
    kernels and cuDNN's algorithms differ with the batch; ten evaluations of
    a random net amplify it), which the line prints beside the workers'. The
    workers' launches are read from them."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt
    from sgmse_tpu_torch.model import ScoreModel
    from sgmse_tpu_torch.parallel import global_rows
    from sgmse_tpu_torch.parallel.pool import DataParallelModel

    weights = kt.full_model("cpu").dnn.state_dict()
    wavs = np.stack([speech(1.0, 16000, SEED + 130 + i) for i in range(B)])
    total = {k: 0 for k in KERNELS}
    report["dp_enhance"] = {}

    def seeded():
        return torch.Generator(dev).manual_seed(SEED)

    for precision in ("float32", "bfloat16"):
        model = ScoreModel("ncsnpp", "ouve", precision=precision)
        model.dnn.load_state_dict(weights)
        t0 = time.time()
        with DataParallelModel(model.eval(), ["cuda:0", "cuda:0"]) as dp:
            started = time.time() - t0
            model = model.to(dev, memory_format=torch.channels_last)
            for batch in (B, B - 1):
                y = wavs[:batch]
                padded = np.concatenate([y, np.zeros((batch % 2, y.shape[1]), np.float32)])
                dp.launch_counts(reset=True)
                t1 = time.time()
                out = dp.enhance(y, generator=seeded(), N=DP_N)
                wall = time.time() - t1
                launches = dp.launch_counts()
                whole = model.enhance(padded, generator=seeded(), N=DP_N)
                rows = len(padded) // 2
                blocks = []
                for i in range(2):
                    with global_rows(i, 2):
                        blocks.append(model.enhance(padded[i * rows:(i + 1) * rows],
                                                    generator=seeded(), N=DP_N))
                blocks = np.concatenate(blocks)
                scale = np.abs(whole).max()
                rel = float(np.abs(out - whole[:batch]).max() / scale)
                rel_blocks = float(np.abs(blocks - whole).max() / scale)
                split = float(np.abs(out - blocks[:batch]).max())
                expected = expect(NETS["ncsnpp"]["launches"], 2 * 2 * DP_N)
                print(f"13d enhance --data_parallel, {precision}, B={batch}: two workers on one "
                      f"card against one device on each worker's rows: max |diff| {split} "
                      f"(bit for bit); against one device on the zero-padded batch {rel:.2e} "
                      f"of max|out| (bound {DP_TOL} in float32), where one device on the "
                      f"two halves differs by {rel_blocks:.2e}; {wall:.2f} s; the workers' "
                      f"launches {launches}; workers started in {started:.1f} s")
                if (split != 0 or (precision == "float32" and rel > DP_TOL)
                        or launches != expected or not np.isfinite(out).all()):
                    raise AssertionError(f"13d {precision} B={batch}: split {split}, rel {rel}, "
                                         f"launches {launches} (expected {expected})")
                total = add(total, launches)
                report["dp_enhance"][f"{precision}_B{batch}"] = dict(
                    rel_err=rel, rel_err_one_device_halves=rel_blocks, split_max_abs=split,
                    wall_s=wall, launches=launches)
            if precision == "float32":
                y = wavs[:DP_COUPLED_B]
                for what, kw in (("langevin", dict(N=DP_N, corrector="langevin")),
                                 ("rk45", dict(sampler_type="ode", method="rk45",
                                               max_steps=RK45_MAX_STEPS))):
                    report["dp_enhance"][what] = coupled_check(dp, model, y, what, kw, seeded)
        del model
        torch.cuda.empty_cache()
    launches_by_path["dp_enhance"] = total
    report["dp_enhance"]["cbn"] = data_parallel_cbn(dev)


def coupled_check(dp, model, y, what, kw, seeded):
    """13d: ``dp.enhance`` of ``y`` (f32) on a path that couples the batch's
    rows against ``model.enhance`` on one device of the zero-padded batch:
    within DP_TOL of max|out|, the same NFE, the same collectives on each
    worker (their count and host ms printed; the time with gloo on CUDA
    tensors includes the copies to the host and the wait for the stream)."""
    import torch

    padded = np.concatenate([y, np.zeros((len(y) % 2, y.shape[1]), np.float32)])
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="ODE sampler hit max_steps")
        dp.enhance(y, generator=seeded(), **kw)  # the workers' first run of this path
        dp.collective_counts(reset=True)
        t0 = time.time()
        out, nfe, _ = dp.enhance(y, generator=seeded(), timeit=True, **kw)
        wall = time.time() - t0
        collectives = dp.collective_counts()
        t0 = time.time()
        ref, ref_nfe, _ = model.enhance(padded, generator=seeded(), timeit=True, **kw)
        torch.cuda.synchronize()
        one_wall = time.time() - t0
    rel = float(np.abs(out - ref[:len(y)]).max() / np.abs(ref).max())
    calls = [c["calls"] for c in collectives]
    host_ms = max(c["seconds"] for c in collectives) * 1e3
    steps = f", {(nfe - 3) // 6} rk45 steps on both" if what == "rk45" else ""
    print(f"13d {what} --data_parallel, float32, B={len(y)} over two workers on one card: "
          f"{rel:.2e} of max|out| against one device on the zero-padded batch (bound "
          f"{DP_TOL}); NFE {nfe} (one device {ref_nfe}){steps}; {calls[0]} collectives per "
          f"worker per batch, {host_ms:.1f} ms in them (host clock, gloo on CUDA tensors); "
          f"{wall:.2f} s through the workers, {one_wall:.2f} s on one device")
    if (rel > DP_TOL or nfe != ref_nfe or len(set(calls)) != 1 or calls[0] == 0
            or not np.isfinite(out).all()):
        raise AssertionError(f"13d {what}: rel {rel}, NFE {nfe} vs {ref_nfe}, collectives "
                             f"{collectives}")
    return dict(rel_err=rel, nfe=nfe, collectives=calls[0], collective_ms=host_ms, wall_s=wall,
                one_device_wall_s=one_wall)


def data_parallel_cbn(dev):
    """13d: DCUNet with CbN (phase 12's DilDCUNet-v2, f32, seeded) through two
    workers on ``cuda:0``, PC N=DP_N + ald on DP_COUPLED_B 1-s inputs: its
    batch statistics reduced over the workers (two all-reduces per CbN layer
    per evaluation), against one device on the zero-padded batch."""
    import torch
    from sgmse_tpu_torch.parallel.pool import DataParallelModel

    cbn = dcunet_model(dev, dcunet_norm_type="CbN")
    y = np.stack([speech(1.0, 16000, SEED + 150 + i) for i in range(DP_COUPLED_B)])
    t0 = time.time()
    with DataParallelModel(cbn, ["cuda:0", "cuda:0"]) as dp:
        started = time.time() - t0
        result = coupled_check(dp, cbn, y, "DCUNet-CbN", dict(N=DP_N), lambda: torch.Generator(
            dev).manual_seed(SEED))
    print(f"13d DCUNet-CbN: workers started in {started:.1f} s; "
          f"{result['collectives'] / result['nfe']:.0f} collectives per evaluation")
    del cbn
    torch.cuda.empty_cache()
    return result


def data_parallel_serve(tmp: Path, report, launches_by_path, dev):
    """Phase 13e: ``serve.build_enhancer(--data_parallel)`` with two workers on
    the one card: a burst of DP_SERVE_REQUESTS 1-s requests, one batch, every
    answer against ``model.enhance`` of that batch with its generator."""
    import torch
    from sgmse_tpu_torch import convert, serve
    from sgmse_tpu_torch import kernel_times as kt

    model = kt.full_model(dev)
    weights = tmp / "dp_weights.npz"
    convert.save_npz(weights, convert.jax_tree_from_state_dict(model.dnn.state_dict()))
    flags = ["--weights", str(weights), "--batch_size", str(DP_SERVE_REQUESTS), "--max_delay_ms",
             "2000", "--N", str(DP_N), "--data_parallel"]
    built, enh, sr = serve.build_enhancer(serve.build_parser().parse_args(flags),
                                          device=["cuda:0", "cuda:0"])
    with enh:
        bucket = enh.bucket_for(16000)
        enh.warmup([bucket], [DP_SERVE_REQUESTS])
        wavs = [speech(1.0, sr, SEED + 140 + i) for i in range(DP_SERVE_REQUESTS)]
        built.launch_counts(reset=True)
        t0 = time.perf_counter()
        outs = [f.result(timeout=600) for f in [enh.submit(w) for w in wavs]]
        wall = time.perf_counter() - t0
        launches = built.launch_counts()
        stats = enh.stats()
        n = enh.samples_for_bucket(bucket)
        batch = np.zeros((DP_SERVE_REQUESTS, n), np.float32)
        for i, w in enumerate(wavs):
            batch[i, :len(w)] = w
        ref = model.eval().enhance(batch, generator=enh.generator(0), sde=built.sde,
                                   pad_mode=enh.pad_mode, **enh.sampler_kwargs)
    rel = max(float(np.abs(o - r[:len(o)]).max() / np.abs(r).max()) for o, r in zip(outs, ref))
    single = report.get("serve_burst", {}).get(4)
    print(f"13e serve --data_parallel: {DP_SERVE_REQUESTS} requests of 1 s in {stats['batches']} "
          f"batch(es), {DP_SERVE_REQUESTS / wall:.3f} requests/s (f32, N={DP_N}; phase 11's "
          f"single-card burst: "
          + (f"{single['requests_per_s']:.3f} requests/s, bf16, N=30" if single else
             "not measured in this run")
          + f"; a check of function, not a scaling figure); every answer against the direct "
          f"call: {rel:.2e} of max|out| (bound {DP_TOL}); the workers' launches {launches}")
    expected = expect(NETS["ncsnpp"]["launches"], 2 * 2 * DP_N * stats["batches"])
    if rel > DP_TOL or stats["batches"] != 1 or stats["errors"] or launches != expected:
        raise AssertionError(f"13e: rel {rel}, stats {stats}, launches {launches} "
                             f"(expected {expected})")
    launches_by_path["dp_serve"] = launches
    report["dp_serve"] = dict(rel_err=rel, requests_per_s=DP_SERVE_REQUESTS / wall,
                              launches=launches)
    del model
    torch.cuda.empty_cache()


def phase_13(tmp: Path, report, launches_by_path, dev, lap):
    """Phase 13: data parallelism (13a-e), then what one card cannot verify."""
    dp_world_of_one(tmp, report, launches_by_path, dev)
    lap("13a data-parallel world of one")
    two_ranks(tmp, report, dev, "ncsnpp", DP_TWO_RANK_STEPS)
    lap("13b two ranks")
    two_ranks(tmp, report, dev, "dcunet", 1)
    lap("13c DCUNet two ranks")
    data_parallel_enhance(report, launches_by_path, dev)
    lap("13d enhance --data_parallel")
    data_parallel_serve(tmp, report, launches_by_path, dev)
    lap("13e serve --data_parallel")
    print(ONE_CARD_LIMITS)


def learn_demo_cut(tmp: Path, report, launches_by_path):
    """Phase 14b: the learn demo cut to DEMO_CUT through ``tools.learn_demo``,
    with the counters set to 0 just before and read just after. Returns its
    result (its ``workdir`` holds the corpus and the checkpoints)."""
    import torch
    from sgmse_tpu_torch.data import native
    from sgmse_tpu_torch.tools import learn_demo

    print(f"14b learn demo, cut: {' '.join(DEMO_CUT)} (the full recipe: 3,200 steps, 8 eval "
          f"files, 50 validations; python -m sgmse_tpu_torch.tools.learn_demo)")
    torch.cuda.synchronize()
    reset_counters()
    served = dict(native.SERVED)
    with cudnn_tf32():
        r = learn_demo.main([str(tmp / "learn_demo"), *DEMO_CUT])
    torch.cuda.synchronize()
    launches = counters()
    served = {k: v - served[k] for k, v in native.SERVED.items()}
    journey = r["validations"]
    forwards = (len(journey) * DEMO_VALIDATION_FORWARDS + r["enhance_warmup_nfe"]
                + r["enhance_nfe"])
    expected = add(expect(DEMO_TRAIN_LAUNCHES, r["steps"]),
                   expect(NETS["learn_demo"]["launches"], forwards))
    losses = [v["valid_loss"] for v in journey]
    finite = all(np.isfinite(v) for g in ("noisy", "enhanced", "delta") for v in r[g].values())
    print(f"14b: {r['steps']} steps, {len(journey)} validations (valid_loss "
          f"{[round(v, 4) for v in losses]}), best_pesq at step {r['best_pesq_step']}; noisy "
          f"{r['noisy']}, enhanced {r['enhanced']}, delta {r['delta']}; "
          f"{r['train_steps_per_s']:.2f} steps/s with validation, enhancement "
          f"{r['enhance_audio_s_per_wall_s']:.2f} audio-s/wall-s; launches {launches} "
          f"(expected {expected}: {r['steps']} steps, {forwards} evaluations); batches served "
          f"{served}")
    if (launches != expected or not finite or len(losses) < 2 or not losses[-1] < losses[0]
            or served != {"native": r["steps"] + len(journey), "python": 0}):
        raise AssertionError(f"14b: launches {launches} (expected {expected}), finite {finite}, "
                             f"valid losses {losses}, batches served {served}")
    launches_by_path["learn_demo"] = launches
    report["learn_demo_cut"] = dict(r, launches=launches, batches_served=served)
    return r


def phase_14(tmp: Path, report, launches_by_path, dev, lap):
    """Phase 14: the learn demo's kernel signatures (14a), the cut demo (14b)
    and bf16 against f32 on its checkpoint (14c). Returns the kernel rows of
    the forward and of the train step."""
    import torch
    from sgmse_tpu_torch.tools import bf16_quality

    model, rows = network_checks("learn_demo", dev, report, batch=DEMO_ENHANCE_B)
    del model
    torch.cuda.empty_cache()
    train_rows = train_kernel_checks(dev, report, "learn_demo", DEMO_TRAIN_B, "demo_train",
                                     DEMO_TRAIN_LAUNCHES)
    lap("14a learn demo kernels")
    r = learn_demo_cut(tmp, report, launches_by_path)
    lap("14b learn demo, cut")
    ds = Path(r["workdir"]) / "ds" / "test"
    with cudnn_tf32():
        q = bf16_quality.main(["--ckpt", r["best_pesq"], "--test_dir", str(ds / "noisy"),
                               "--clean_dir", str(ds / "clean"), "--workdir",
                               str(tmp / "bf16_quality")])
    print(f"14c bf16 against f32 on the cut demo's best_pesq, {len(q['files']['float32'])} "
          f"test files: mean delta (PESQ, SI-SDR, ESTOI) {q['mean_delta']}, largest "
          f"{q['max_abs_delta']}; audio-s/wall-s {q['audio_s_per_wall_s']}")
    if not np.isfinite(q["mean_delta"]).all() or len(q["files"]["float32"]) != 16:
        raise AssertionError(f"14c: {q['mean_delta']}")
    report["bf16_quality_cut"] = {k: v for k, v in q.items() if k != "files"}
    lap("14c bf16 quality")
    return rows, train_rows


def phase_12(tmp: Path, report, launches_by_path, dev, lap):
    """Phase 12: 12a-c (``residual_checks``), then 12d (``dcunet_checks``).
    Returns the kernel rows and the residual net's train kernel rows."""
    rows, train_rows = residual_checks(tmp, report, launches_by_path, dev)
    report["kernel_checks_12"] = rows
    lap("12a-c 48 kHz residual, ncsnpp variant")
    dcunet_checks(tmp, report, launches_by_path, dev)
    lap("12d DCUNet")
    return rows, train_rows


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--only", choices=("12", "13", "14"), default=None,
                        help="run phases 1-2 and this phase only, and print no contract lines "
                             "(a quicker check of one phase)")
    only = parser.parse_args(argv).only
    phases, t_phase = {}, time.time()

    def lap(name):
        nonlocal t_phase
        now = time.time()
        phases[name] = round(now - t_phase, 1)
        t_phase = now

    card = card_identity()
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    OUT_DIR.mkdir(exist_ok=True)
    report = {"card": card, "device": torch.cuda.get_device_name(0)}

    # --- 2. build -------------------------------------------------------------------------
    from sgmse_tpu_torch import kernels

    t0 = time.time()
    so = kernels.build()
    kernels.lib()
    report["build_s"] = time.time() - t0
    print(f"build: {report['build_s']:.1f} s -> {so.relative_to(ROOT)}")
    (OUT_DIR / "build.log").write_text((so.parent / "build.log").read_text()
                                       if (so.parent / "build.log").exists() else "cached\n")
    lap("1-2 card, build")

    # --- 3-4. kernels vs plain at every full-width signature; full forwards ----------------
    from sgmse_tpu_torch import convert, kernel_times as kt
    from sgmse_tpu_torch.model import ScoreModel

    launches_by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if only is not None:
            {"12": phase_12, "13": phase_13, "14": phase_14}[only](tmp, report, launches_by_path,
                                                                   dev, lap)
            print(f"phase seconds: {phases}, total {sum(phases.values()):.1f}")
            (OUT_DIR / f"chip_smoke_{only}.json").write_text(json.dumps(report, indent=1,
                                                                        default=str))
            return
        model, rows = network_checks("ncsnpp", dev, report)
        model_48k, rows_48k = network_checks("ncsnpp_48k", dev, report)
        rows += rows_48k
        report["kernel_checks"] = rows
        weights, weights_48k = tmp / "weights.npz", tmp / "weights_48k.npz"
        convert.save_npz(weights, convert.jax_tree_from_state_dict(model.dnn.state_dict()))
        convert.save_npz(weights_48k,
                         convert.jax_tree_from_state_dict(model_48k.dnn.state_dict()))
        del model_48k  # off the card before the timed paths
        torch.cuda.empty_cache()
        len_16k, len_48k = write_wavs(tmp / "noisy_16000", 16000), write_wavs(tmp / "noisy_48000",
                                                                              48000)
        lap("3-4 kernels, forwards")

        # --- 5. flagship main path through the entry point --------------------------------
        report["main_path"], wavs = entry_point(
            tmp, "main", ["--weights", str(weights), "--batch_size", "4", "--N", "30",
                          "--corrector", "ald", "--snr", "0.5", "--precision", "bfloat16",
                          "--timeit"], 16000, len_16k, 60, NETS["ncsnpp"]["launches"])
        launches_by_path["main"] = report["main_path"]["launches"]
        short = np.asarray(wavs[0][:16000], np.float32)

        def seeded(seed):
            return torch.Generator(device=dev).manual_seed(seed)

        report["short_enhance"] = against_plain("short PC enhance", lambda: model.enhance(
            short, generator=seeded(1), N=5, corrector="ald", snr=0.5, timeit=True)[:2])
        lap("5 main path")

        # --- 6. Schroedinger-bridge path -----------------------------------------------------
        sb_config = ScoreModel("ncsnpp_v2", "sbve", loss_type="data_prediction").config_dict()
        (tmp / "sb.json").write_text(json.dumps(sb_config))
        report["sb_path"], _ = entry_point(
            tmp, "sb", ["--weights", str(weights), "--config", str(tmp / "sb.json"),
                        "--batch_size", "4", "--N", "30", "--precision", "bfloat16", "--timeit"],
            16000, len_16k, 50, NETS["ncsnpp"]["launches"])
        launches_by_path["sb"] = report["sb_path"]["launches"]
        sb_model = ScoreModel.from_config(sb_config)
        sb_model.dnn.load_state_dict(model.dnn.state_dict())
        sb_model = sb_model.to(dev, memory_format=torch.channels_last).eval()
        report["sb_sde_short"] = against_plain("short SB sde enhance", lambda: sb_model.enhance(
            short, generator=seeded(2), sampler_type="sde", pad_mode="reflection",
            timeit=True)[:2])
        del sb_model
        lap("6 bridge")

        # --- 7. 48 kHz path ---------------------------------------------------------------
        config_48k = ScoreModel("ncsnpp_48k", "ouve", **CONFIG_48K).config_dict()
        (tmp / "k48.json").write_text(json.dumps(config_48k))
        spec_48k = ScoreModel.from_config(config_48k).spec
        frames = 1 + len_48k // spec_48k.hop_length
        if (spec_48k.num_freqs, frames) != (kt.BINS["ncsnpp_48k"], kt.T_FRAMES):
            raise AssertionError(f"48 kHz input is F={spec_48k.num_freqs} T={frames}")
        report["path_48k"], _ = entry_point(
            tmp, "48k", ["--weights", str(weights_48k), "--config", str(tmp / "k48.json"),
                         "--batch_size", "4", "--N", "30", "--corrector", "ald", "--snr", "0.5",
                         "--precision", "bfloat16", "--timeit"],
            48000, len_48k, 60, NETS["ncsnpp_48k"]["launches"])
        report["path_48k"]["F"], report["path_48k"]["T"] = spec_48k.num_freqs, frames
        launches_by_path["48k"] = report["path_48k"]["launches"]
        lap("7 48 kHz")

        # --- 8. the remaining samplers, short input, f32, kernels vs plain ----------------
        samplers = {
            "ode rk4 N=4": dict(sampler_type="ode", method="rk4", N=4),
            f"ode rk45 max_steps={RK45_MAX_STEPS}": dict(sampler_type="ode", method="rk45",
                                                         max_steps=RK45_MAX_STEPS),
            "euler_maruyama + langevin N=5": dict(predictor="euler_maruyama",
                                                  corrector="langevin", N=5),
        }
        report["samplers"] = {}
        for i, (what, kw) in enumerate(samplers.items()):
            report["samplers"][what] = against_plain(what, lambda: model.enhance(
                short, generator=seeded(3 + i), timeit=True, **kw)[:2])
        if report["samplers"]["ode rk4 N=4"]["nfe"] != 17:
            raise AssertionError("rk4 with N=4 must make 17 evaluations")

        from sgmse_tpu_torch import enhance
        from sgmse_tpu_torch.data.wav import read_wav

        long_dir = tmp / "long"
        len_5s = write_wavs(long_dir / "noisy", 16000, seconds=5.0, n_files=1)
        stats = enhance.main(["--test_dir", str(long_dir / "noisy"), "--enhanced_dir",
                              str(long_dir / "out"), "--weights", str(weights), "--N", "5",
                              "--chunk_seconds", "2", "--timeit"])
        out, _ = read_wav(long_dir / "out" / "utt0.wav")
        print(f"--chunk_seconds 2 on a 5-s wav: {stats['audio_s_per_wall_s']:.3f} audio-s/wall-s, "
              f"NFE {stats['nfe']} (3 chunks of N=5 + ald), output {out.shape[1]} samples")
        if out.shape != (1, len_5s) or not np.isfinite(out).all() or stats["nfe"] != 3 * 10:
            raise AssertionError(f"--chunk_seconds: output {out.shape}, NFE {stats['nfe']}")
        long_wav = read_wav(long_dir / "noisy" / "utt0.wav")[0][0]
        report["chunked"] = dict(stats, enhance_long=against_plain(
            "enhance_long of 5 s in 2-s chunks", lambda: model.enhance_long(
                long_wav, chunk_seconds=2.0, generator=seeded(7), N=5, timeit=True)[:2]))
        lap("8 samplers")

        # --- 9. training ------------------------------------------------------------------
        del model
        torch.cuda.empty_cache()
        train_rows = train_kernel_checks(dev, report)
        lap("9a backward kernels")
        train_step_checks(dev, report)
        lap("9b-c train step")
        with cudnn_tf32():
            train_entry_point(tmp, report, launches_by_path)
        lap("9d-e train entry point")

        # --- 10. training the Schroedinger bridge ------------------------------------
        pesq = pesq_checks(dev, report)
        lap("10a PESQ loss")
        bridge_rows = train_kernel_checks(dev, report, "ncsnpp_v2", BRIDGE_B, "bridge")
        lap("10b bridge kernels")
        step = bridge_step_checks(dev, report)
        share = pesq["busy_ms"] / step["profile"]["busy_ms"]
        print(f"PESQ loss in the B={BRIDGE_B} bridge step: {pesq['busy_ms']:.3f} of "
              f"{step['profile']['busy_ms']:.1f} ms device busy ({share:.2%}), "
              f"{pesq['launches']:.0f} of {step['profile']['launches']:.0f} launches")
        report["pesq_share_of_bridge_step"] = share
        lap("10c bridge step")
        with cudnn_tf32():
            bridge_entry_point(tmp, report, launches_by_path)
        lap("10d-e bridge entry point")

        # --- 11. the serving path -------------------------------------------------------
        def hung():
            print(f"chip_smoke: phase 11 ran past its watchdog of {SERVE_WATCHDOG_S} s",
                  file=sys.stderr, flush=True)
            os._exit(3)

        watchdog = threading.Timer(SERVE_WATCHDOG_S, hung)
        watchdog.daemon = True
        watchdog.start()
        with cudnn_tf32():
            rows += serve_path(tmp, weights, report, launches_by_path)
        watchdog.cancel()
        lap("11 serving")

        # --- 12. the remaining NCSN++ branches and DCUNet ------------------------------
        residual_rows, residual_train_rows = phase_12(tmp, report, launches_by_path, dev, lap)
        rows += residual_rows

        # --- 13. data parallelism ---------------------------------------------------------
        phase_13(tmp, report, launches_by_path, dev, lap)

        # --- 14. the host side: the learn demo ------------------------------------------
        t14 = time.time()
        demo_rows, demo_train_rows = phase_14(tmp, report, launches_by_path, dev, lap)
        rows += demo_rows
        print(f"phase 14: {time.time() - t14:.1f} s")

    summary = summarize(rows, train_rows, bridge_rows, residual_train_rows, launches_by_path,
                        demo_train_rows)
    report["kernels"], report["phase_s"] = summary, phases
    print(f"phase seconds: {phases}, total {sum(phases.values()):.1f}")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(sys.argv[1:])
