#!/usr/bin/env python3
"""Drive the PyTorch port's codec, codec CLI, train step, trainer, vmapped
grid tuner, data parallelism and examples on one CUDA card and hold its
kernels against their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100:
the kernels are built for sm_90a). Phases, one JSON line each:

1. env      the card (nvidia-smi name and power limit), versions, the
            kernels' build (all sources compiled at once, one nvcc each).
   combine_build  every instance of csrc/sccn_combine.cu's kernels, read
            back from the library with cuobjdump: registers, stack and local
            memory, and a census of its SASS (FFMA, LDS.128, other shared
            loads, barriers, MUFU, STL/LDL). None may spill.
2. kernel   each CUDA kernel against its plain torch version on the card,
            on synthetic inputs at its main-path shape, in fp32 and bf16,
            with times (CUDA events, median of 30 after warm-up) for the
            kernel, the plain version and one PyTorch library call where
            one computes the same function, and the bound: the attention
            forward at the codec's shape (two calls bit for bit; its split
            count, blocks, and the device ms of its split and merge kernels
            from torch.profiler), the attention backward at the
            train step's (two calls bit for bit; its split count, blocks,
            the device ms of each of its four kernels, and SDPA's backward
            alone beside SDPA forward + backward), the binary-Gumbel
            sampler at the train step's logits (and its generator's
            statistics over 4M draws), the fixed- and learned-stretch Hard
            Concrete samplers at their train steps' log-alpha (and the
            gates' clip statistics), each with its kernel's device ms
            (torch.profiler) and its uniforms bit-equal to the Philox
            stream also at ragged lengths; then the three samplers'
            backward kernels (train and eval, fp32 and bf16) against their
            plain versions, two calls bit for bit.
   sampler_launch  the launch floor (an empty launch by events and by the
            profiler) and each sampler's backward at its train shape as the
            step runs it (its autograd Function): events, launches, device
            ms.
   kernel_combine  the fused SCCN combine's forward and backward kernels
            against the plain version and its autograd at the train step's
            two fused ranks (rank 3: M=2, 77,520 rows; rank 2: M=3, 18,240
            rows), a ragged M=1 case and the n=32 packed step's three fused
            ranks (M=3, 7,936 and 8,192 rows; M=2, 4,096), fp32 and bf16,
            with times and bounds,
            two calls bit for bit, each kernel's device ms (torch.profiler),
            and each kernel's blocks and longest row range.
   combine_diag  benchmarks/kernel_diag.py's ladder on the card: the packed
            kernels' parity (512 rows, fp32, forward and six cotangents), then
            at its default shape (bf16, M=2, 1,860,480 rows) every variant's
            kernel against its plain version and the times of the forward
            rungs (copy, matmul, nogelu, full, packed, plain) and the
            gradient rungs (packed, full, plain autograd).
   pqmf_synthesis  row 12, the PQMF synthesis kernel and its adjoint at the
            train step's shape (128 x 4,000 frames of 16 bands, 413 taps),
            fp32 and bf16: against cuDNN's conv_transpose1d and conv1d and
            the fp64 host synthesis (no larger error than cuDNN's), two calls
            bit for bit, times beside the bounds, registers and spills.
3. serve    the flagship-width codec (n=20, 16 bands, C=64, 6 SCCN
            layers, seeded random weights): a warm-up request and three
            timed ones of 8 clips x 64,000 samples, each encode -> pack ->
            unpack -> decode plus one reconstruct. Launch counters are
            zeroed just before and read just after.
   kernel   again, on the attention inputs of one more main-path decode.
4. trace    one decode under torch.profiler: device busy share, top ops.
5. parity   the card's weights copied to a CPU model; the plain path's
            logits, latent and waveform against the card's.
6. train    the flagship train step (fp32, B=16 anchors x G=3 clips of
            64,000 samples, two-group Adam, clipping): one warm-up and 10
            timed steps, launch counters zeroed just before and read just
            after (the sampler's forward and backward kernels once a step);
            then 3 bf16 steps, counted the same way.
   kernel   the attention forward and backward on the inputs (and the
            output gradient) captured from one more train step.
   trace    one train step under torch.profiler.
7. train_parity  one step's loss and gradients on the card against the
            CPU plain path on the same weights and uniforms (B=2, G=3).
8. train_hc  BASELINE config 3: the fixed-stretch Hard Concrete model
            with the straight-through hard path, fp32, B=32 anchors x G=1,
            a warm-up and 5 timed steps, counters zeroed just before and
            read just after; then one step under torch.profiler.
9. train_hc_learned  the learned-stretch model (soft, B=16 x G=3, L0
            weight 0.01): a warm-up and 3 timed steps, counters as above.
10. encode_hc  BASELINE config 1: batch-1 eval encodes of the hard model
            with Bernoulli draws; one 8-clip codec request.
11. train_parity_hc, train_parity_hc_learned  train_parity for the two
            Hard Concrete models (B=2; G=1 and G=3), with injected
            relaxation and Bernoulli uniforms whose every gate and draw
            clears a stated margin; the encoder masks equal bit for bit.
12. train_fused  the flagship Gumbel step with every SCCN layer switched to
            fused_combine: a warm-up and 5 timed steps (row 6 and row 7 each
            launched exactly 12 times a step), one profiled step, one step
            fused against unfused on the same weights, batch and uniforms
            (train_parity's bounds), and one 8-clip decode's waveform fused
            against unfused on one shared latent. Every earlier phase
            launches the combine kernels (rows 6-10) zero times.
13. train_packed  the n=32 packed model (ranks 2-3 packed to 512 and
            256 rows; 1,264 attention keys), fp32, B=16 x G=3: a warm-up and
            5 timed steps, rows 1, 2, 3 and 3's backward once a step; rows 1
            and 2 on the step's attention inputs; one profiled step. The
            packed path builds no dense membership of a packed rank.
14. train_packed_fused  the same with fused_combine on every layer (rows 6
            and 7 at ranks 1-3: 18 launches each a step), then one step
            fused against unfused on a fresh model, cuDNN deterministic:
            the loss and the surrogate as train_fused, the step's own
            cotangent pulled back through both (2e-4 a leaf, 2e-2 as a
            whole), the whole gradient at 2e-2 where it is conditioned; and
            the unfused step's repeatability, cuDNN deterministic and not.
15. train_parity_packed  train_parity for the packed model, with uniforms
            whose packed sets cannot change between card and CPU.
   packed_repeat  two identical packed train steps (fp32, B=16 x G=3,
            cuDNN deterministic) on two copies of one seeded model: the loss,
            every gradient leaf and the parameters after 4 steps equal bit
            for bit (the packed gathers' backwards sum in a fixed order);
            the step median and one profiled step's device ms.
16. serve_packed  the packed codec: 3 timed requests of 8 clips, 5,181 wire
            bytes a clip, the latent bit for bit through the wire, row 1
            once a decode, the waveform against the CPU's.
17. baseline2  BASELINE config 2 (max_rank=1, batch 8, eval forward plus
            autoencoder_loss, 20 timed calls; 190 attention keys) against
            the CPU.
18. train_parity_jk, train_jk  the flagship step with the jumping-knowledge
            SCCN: one step card vs CPU (B=2), then 3 timed steps of B=16 x
            G=3.
19. data     the data layer: a synthetic corpus of 1,024 + 16 notes; six
            WAVs (16 kHz, 32 kHz, stereo) through preprocess_split, each
            decoded by the native parser and held against scipy's decode;
            compute_distances on the card over the 1,024 clips (tile 64,
            five scales: 523,776 pairs; wall time, pairs/s, peak memory;
            one tile pair under torch.profiler), 16 entries against
            spectral_distance on the card and a 32-clip block against the
            CPU, zero diagonal, symmetry, neighbor rows;
            the contrastive dataset (G = 3, epoch 1) through batch_iterator
            and prefetch_to_device into a warm-up and 3 timed flagship
            train steps, counters as in train; index_iterator's rows
            gathered on the card against batch_iterator's batch, bit for
            bit; one eval step on held-out clips; the hybrid STFT against
            fft on the card, value and gradient.
20. trainer_main  the port's main() in-process at the flagship width
            (main's defaults: G = 12, batch 4, accumulation 4, fp32) on a
            synthetic corpus of 64 + 12 notes: the precompute, a 2 x 1 x 1
            grid tuned one epoch a combo, 2 epochs with validation,
            checkpoints (best, latest, epoch_0, best_tuning, the combos'),
            train_log.jsonl and sample dumps, then train.resume=true to 3
            epochs (one more, no rotation). The files, their sidecars'
            keys, finite losses, and rows 1-3 once a trainer step (row 1
            also once an eval forward), counters zeroed just before each
            run and read just after; step ms (CUDA events around each
            step, no added synchronisation), epoch and validate s, sync and
            async checkpoint writes (s, MB), the waits for an async save,
            peak memory.
21. trainer_resume  Trainer.train() for 3 epochs against 2 epochs, a new
            model and trainer, and train(resume=True) to 3, on 28 + 4
            clips, cuDNN deterministic: losses, best epoch, every parameter
            and moment equal bit for bit; then the same for the n=32 packed
            model at the repo's best geometry (trainer_resume_packed).
22. epoch_b128  BASELINE config 4: the precompute of 2,048 synthetic clips
            (tile 64), then one warm-up step and Trainer.train_epoch at
            B = 128 x G = 6, bf16, on the device corpus (16 steps): clips/s
            over the epoch's wall (ended by its loss copy), peak memory,
            launches a step, one step under torch.profiler.
23. codec_cli  the port's codec CLI (codec_cli.main, in-process, on the
            card): 8 clips of 64,000 samples written as WAVs, encode ->
            .tac -> decode, twice each, for the flagship (--params) and the
            n=32 packed model (a Trainer checkpoint whose sidecar alone
            gives the geometry): the header, the bits against a direct
            encode, the waveform against a direct Codec decode (one int16
            step), row 1 once a decode and nothing else; clips/s.
24. tuner    benchmarks/full_recipe.py's tune stage through
            Trainer.tune_hyperparameters_vmapped at full width: the 8-combo
            grid, B = 8 x G = 12, bf16, the device corpus, scanned (88 + 10
            clips, 1 epoch): grid-step ms (CUDA events), rows 1 and 2 once
            each a grid step over K*B = 64 elements, peak memory, one grid
            step profiled (busy share); rows 1 and 2 against their plain
            versions on the folded bf16 inputs one more grid step hands
            them; then the production train step of one combo (the
            sequential tuner's unit), 10 timed steps.
25. tuner_parity  one K = 2 grid step (fp32, B=2, G=3, cuDNN
            deterministic) against two single-combo steps of the port on
            the same weights and uniforms, at train_parity's bounds.
   flat_adam  make_optimizer(flat_groups=True) against the per-leaf
            optimizer, both through the multi-tensor clip + Adam kernels,
            and the per-leaf optimizer on the plain path, on the flagship's
            parameters, the same gradients for 3 updates (accumulation 1
            and 4, one update clipped): the layouts' parameters and moments
            bit for bit, the kernels' bit for bit against the plain path's
            before the clip and within a stated bound from it; each applied
            update's launches and device ms (torch.profiler), all three;
            one update's ms (CUDA events), kernels and plain path.
   examples  examples/torch_train_synthetic.py (32 clips, 1 epoch, its
            bf16 B = 16 settings) and examples/torch_codec_roundtrip.py
            (fresh n=20 weights: 775 wire bytes; --packed from an n=32
            checkpoint: 5,181) through their main, in-process: finite
            losses and waveforms, rows 1-3 once a step, row 1 once a
            decode; counters zeroed just before each run.
26. dp_philox  rows 3-5 at [16, 6195], fp32 and bf16, drawing a
            data-parallel rank's 8 rows with first = its first row x 6,195
            (row 8, and row 1: an odd start): the rows of the first = 0
            draw bit for bit, the uniforms the plain Philox stream from
            first bit for bit, the output its plain relaxation; times
            (events) at first 0, 8 x 6,195 and 6,195.
27. dp1      data parallelism over NCCL at world size 1: the Trainer with
            data_parallel (the replicated corpus, then shard_corpus) at
            trainer_main's settings, 2 epochs on 28 + 4 clips, cuDNN
            deterministic, against the run without it: every loss, the best
            epoch, every parameter and moment bit for bit; rows 1-3 once a
            trainer step; step ms by events. The vmapped tuner on a mesh of
            one against the tuner without one, bit for bit.
28. dp2      two processes on the one card over gloo (NCCL refuses two
            ranks on a device), the flagship step at full width, global
            B = 16 x G = 3 (8 a rank), 3 steps over the replicated corpus,
            against the world-1 step on the same weights and seed: losses,
            masks, the whole gradient where conditioned, every leaf of the
            surrogate, the accumulator; rows 1-3 once a rank a step; step
            ms (events) and the gradient's all-reduce alone (host clock).
            A rank that fails or outlives its deadline fails the run.
29. profiler  how many kernel profiles the run took, and which of them
            recorded no device activity at first and were taken again.
30. kernels  one line per kernel: route, source, launches (rows 1 and 2:
            trainer_main's first run + the codec CLI's runs + the tuner's
            run + dp1's data-parallel run + dp2's two ranks + the examples;
            row 3 and 3's backward, and the multi-tensor Adam (it replaces
            no TPU kernel): trainer_main's first run + dp1's + dp2's + the
            train example's; the others
            their train step; combine_diag's ladder for rows 8-10), error,
            times (at its train step's shape; the ladder's for rows 8-10).
            The samplers' backward kernels stand in the line under the JAX
            VJPs they replace (_bg_bwd, _hc_bwd, _hcl_bwd).

Then the nvidia-smi line and, last, {"ok": true, "device": ...}. Any failed
check exits non-zero before the last line. Without a card it exits 2.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 511990
DEVICE = "cuda"
FLAGSHIP = dict(num_vertices=20, num_bands=16, sccn_hidden_dim=64, n_sccn_layers=6)
NUM_SAMPLES = 64000
CLIPS = 8
REQUESTS = 3
# Attention at the codec's shape: B=8 clips, Q=250 queries, M=190+1140+4845
# rank 1-3 keys, C=64 channels in H=4 heads of D=16.
ATTN = dict(b=8, q=250, m=6175, c=64, h=4)
# Stated tolerances. Kernel vs plain, fp32: both sum in fp32 and differ in
# order only. bf16: both round one fp32 output to bf16, at most one ulp
# apart (2^-7 at |o| < 1, 2^-6 below 2). L (log-sum-exp) in fp32.
TOL_FP32 = 1e-5
TOL_BF16 = 2.0 ** -6
# The train step's soft latent makes every one of the 6,175 keys active, so
# each output sums 6,175 fp32 terms, online (kernel) against two-pass
# (plain): measured 7.4e-6 on an H100 (PERF.md).
TOL_FP32_DENSE = 5e-5
TOL_LSE = 1e-4
# Card vs CPU plain path, flagship model: logits within LOGIT_TOL; latent
# bits may differ only where the logit is within LOGIT_TOL of 0.5; the
# waveform decoded from one shared latent within WAVE_TOL.
LOGIT_TOL = 1e-3
WAVE_TOL = 1e-3
# Seeded random weights give a complex sparser than trained models reach.
# Raising the last encoder bias by LOGIT_SHIFT gives about 90 edges, 60
# triangles and 2 tetrahedra per clip (the serve phase reports the counts),
# the density trained models pass through (README.md: triangles/tetrahedra
# expand to 188/44 early in training, then prune to ~52/2).
LOGIT_SHIFT = 0.5
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, bf16 tensor FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# The train step (bench.py's flagship step at a batch one card's memory
# and this script's time allow): B anchors, each with a positive and a
# negative, at temperature 1 and accumulation 1.
TRAIN_B = 16
TRAIN_G = 3
TRAIN_STEPS = 10
BF16_STEPS = 3
TEMPERATURE = 1.0
# Attention backward, kernel vs plain: dq, dk, dv within this fraction of
# each gradient's largest element. fp32: sums of up to M products in other
# orders; bf16: both round the same fp32 sums to bf16 once (2^-7 relative).
TOL_BWD = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# Sampler, kernel vs plain on the kernel's own uniforms (which equal the
# plain Philox stream bit for bit): s in [0, 1]; fp32 log/log1p/exp
# rounding; bf16 output one ulp below 1 (2^-8).
TOL_SAMPLER = {"float32": 2e-6, "bfloat16": 2.0 ** -8}
SAMPLER_DRAWS = 1 << 22
# Ragged lengths for the samplers' uniforms: word j of Philox group g must
# reach element 4g + j where the length is not a multiple of four.
RAGGED_SHAPES = ((4097,), (3, 37))
# The samplers' backward kernels against their plain versions (the same
# operations in the same order; the plain version on the card divides by a
# Python scalar as a product with its reciprocal): da within this fraction
# of its largest element (bf16: one ulp). A stretch row's column sum adds R
# rows in P slices, then the P partials, in the same order on both sides:
# within (R + P + SUM_TERM_ULPS) 2^-24 of the sum of |term| (each addition
# rounds within 2^-24 of the running sum; the terms differ by a few ulps).
TOL_SAMPLER_BWD = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
SUM_TERM_ULPS = 8
# Operations per element of the backward kernels at the fp32 rate outside
# the tensor cores: Gumbel 2 s (1 - s) / T times ct; fixed the recovery of
# s, the mask and four products; learned that, a log, a log1p, three
# divides and the three column terms.
SAMPLER_BWD_OPS = {"binary_gumbel_bwd": 6.0, "hard_concrete_bwd": 12.0, "hard_concrete_learned_bwd": 60.0}
# Train parity, card vs CPU plain path, B=2, G=3, full width. The loss and
# its components: fp32 on both, cuDNN/cuBLAS/cuFFT against oneDNN/pocketfft
# sums. The gradient as a whole: relative L2 over every leaf; the spectral
# loss's log term weighs STFT bins by 1/(|S| + 1e-7), so bins of the
# smooth random-weight reconstruction that sit at fp32 round-off steer the
# gradient with their round-off (see tests/test_torch_training.py). Every
# leaf on its own: through a surrogate (the same forward with the spectral
# distance replaced by a fixed linear functional of the reconstruction),
# within SURROGATE_TOL of the gradient's largest element.
# Measured on an H100 (PERF.md): loss 2.3e-6, gradient 2.2e-3, surrogate
# leaves 2.4e-5; the bounds leave a decade or more.
PARITY_LOSS_RTOL = 1e-4
PARITY_GRAD_REL_L2 = 2e-2
SURROGATE_TOL = 2e-4
# A real gradient further than PARITY_GRAD_REL_L2 from the CPU's fails
# unless the CPU's own gradient moves by more than PARITY_GRAD_REL_L2 when
# the batch is nudged by FLOOR_NUDGE (relative): then the real gradient
# carries no fp32-stable information at these inputs (the soft Hard
# Concrete step at beta = 2/3 moves by ~40% on the card's host, PERF.md),
# and the step is held by its loss, its masks and every leaf of the
# surrogate.
FLOOR_NUDGE = 1e-6

# The Hard Concrete paths. BASELINE config 3 (benchmarks/run_all.py:158):
# the fixed stretch with the straight-through hard path, B=32 anchors x
# G=1 (no contrastive term), temperature 1; the recipe's --learned-hc
# model: the learned per-rank stretch, soft, B=16 x G=3, the expected-L0
# term weighted 0.01.
HC_MODEL = dict(sampler="hard_concrete", hard=True)
HC_LEARNED_MODEL = dict(sampler="hard_concrete", learned_hc=True)
HC_B, HC_G, HC_STEPS = 32, 1, 5
HC_LEARNED_STEPS = 3
HC_L0_PENALTY = 0.01
# The kernel phase: Louizos et al.'s beta = 2/3; the gate statistics over
# 4M draws at log-alpha 0 (P(z = 0) = P(z = 1) = sigmoid(beta log(1/11))).
HC_BETA = 2.0 / 3.0
HC_DRAWS = 1 << 22
# About 45 operations per gate (a quarter of a Philox block, log, log1p,
# exp, a divide, the stretch and the clip).
HC_OPS_PER_ELEMENT = 45.0
# BASELINE config 1 (benchmarks/run_all.py:89): a batch-1 encode in eval
# with a generator (the hard path's Bernoulli draws), ENCODE_CALLS times.
ENCODE_CALLS = 20
# Card vs CPU parity of a Hard Concrete or hard step: every pre-clip gate
# and every Bernoulli draw must clear this margin (logits differ by ~4e-6
# card vs CPU, and a pre-clip gate moves by at most 0.3x its logit), else
# the next seed is tried, up to HC_SEED_TRIES. A packed soft step keeps the
# rows of highest rectified probability: the K-th and (K+1)-th select keys
# of every packed rank must clear it too, else a row could change sides.
HC_MARGIN = 1e-5
HC_SEED_TRIES = 20

# The fused SCCN combine (rows 6-10). The train step decodes B=16 anchors:
# rank 3 has 16 x 4,845 = 77,520 rows and M=2 messages, rank 2 16 x 1,140 =
# 18,240 rows and M=3; ranks 0 and 1 stay below MIN_FUSED_ROWS. A ragged
# M=1 case (4,097 rows: one row past 64 full tiles) covers the rest. The
# n=32 packed step's fused ranks: rank 1 16 x 496 rows, rank 2 16 x 512
# (M=3 each), rank 3 16 x 256 (M=2).
COMBINE_SHAPES = ((2, TRAIN_B * 4845), (3, TRAIN_B * 1140), (1, 4097),
                  (3, TRAIN_B * 496), (3, TRAIN_B * 512), (2, TRAIN_B * 256))
COMBINE_C = 64
# Kernel vs plain, relative to each output's largest element. fp32: the same
# operations in other summation orders (y 1e-5; every gradient, a sum over up
# to 77,520 rows for the weights, 1e-4). bf16: the plain version rounds each
# of its ops to bf16 (about six roundings of 2^-9 between a carrier and y,
# about ten on the way to a gradient), the kernel only its outputs and the
# three product operands of the TPU kernel's cast points: 2^-5 bounds both.
TOL_COMBINE = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -5, 2.0 ** -5)}
# About 4C^2 + 16C operations per row and message (two [C, C] products, the
# gelu, the score, the softmax and the weighted sum); the backward three
# times as many; the no-gelu ablation 4C^2 + 6C, the matmul one 2C^2 + 2C,
# the copy one C.
COMBINE_OPS = {"full": 4 * 64 * 64 + 16 * 64, "nogelu": 4 * 64 * 64 + 6 * 64,
               "matmul": 2 * 64 * 64 + 2 * 64, "copy": 64}
# benchmarks/kernel_diag.py's ladder at its default shape (:477-486): bf16,
# M=2, C=64, 384 x 4,845 rows; its parity (:427-465) at 512 rows in fp32,
# forward within 1e-5 and the six cotangents within 1e-4 of their largest
# elements.
DIAG_ROWS = 384 * 4845
DIAG_PARITY_ROWS = 512
TOL_DIAG_PARITY = (1e-5, 1e-4)
# train_fused: the flagship Gumbel step with every layer fused. Ranks 2 and
# 3 of each of the 6 layers clear MIN_FUSED_ROWS: 12 launches each of row 6
# and row 7 per step. The decode check: one 8-clip decode, fused against
# unfused on one latent, within DECODE_FUSED_TOL.
TRAIN_FUSED_STEPS = 5
FUSED_RANK_LAYERS = 12
DECODE_FUSED_TOL = 1e-4
# The n=32 packed model, the repo's best trained geometry
# (benchmarks/capacity_n32_c64_packed/checkpoints/best.extra.json): 32
# vertices, 16 bands, C=64, 6 layers, Gumbel, soft, max_active_vertices 32,
# ranks 2-3 packed to 512 and 256 rows. 32 + 496 + 4,960 + 35,960 = 41,448
# simplices (5,181 wire bytes a clip); the decoder attends over 496 + 512 +
# 256 = 1,264 keys. At B=16 ranks 1-3 have 7,936, 8,192 and 4,096 rows, each
# at least MIN_FUSED_ROWS: with fused_combine, 3 ranks x 6 layers = 18
# launches of rows 6 and 7 a step. The dense ranks' memberships (v2e) are
# the only ones built: e2t and t2tt, 10 and 713 MB in fp32, never.
PACKED = dict(num_vertices=32, num_bands=16, sccn_hidden_dim=64, n_sccn_layers=6)
PACKED_OPTIONS = dict(max_active_vertices=32, pack_capacities=(0, 0, 512, 256))
PACKED_STEPS = 5
PACKED_KEYS = 496 + 512 + 256
PACKED_WIRE_BYTES = 5181
PACKED_FUSED_RANK_LAYERS = 18
# packed_repeat: timed train steps after the warm-up, per model; the
# packed step's earlier medians and device ms (train_packed, cuDNN
# default, H100 80GB HBM3 at 700 W), printed beside it.
PACKED_REPEAT_STEPS = 3
EARLIER_PACKED_STEP = dict(step_ms_median=[168.6, 219.5], device_ms=[45.2, 45.9])
# BASELINE config 2 (benchmarks/run_all.py:125-150, BASELINE.md:43): the
# flagship width with max_rank=1 (vertices and edges: 190 attention keys),
# batch 8, the eval forward plus autoencoder_loss, BASELINE2_CALLS times.
BASELINE2_OPTIONS = dict(max_rank=1)
BASELINE2_CALLS = 20
BASELINE2_KEYS = 190
# The flagship step with the jumping-knowledge SCCN (a 2-layer LSTM over the
# 6 layers' outputs, per simplex).
JK_OPTIONS = dict(use_jumping_knowledge=True)
JK_STEPS = 3
# The data phase. The corpus: DataConfig.num_train_samples
# (topo_audio_autoencoder_tpu/config.py:22) synthetic 4 s notes, the
# reference's 1,024 files, and one held-out eval batch. The precompute: the
# JAX package's tile of 64 (136 tile pairs, 523,776 distinct pairs) and its
# five scales. The dataset: the flagship's group, anchor + positive + one
# negative (G = 3), at epoch 1 of the curriculum.
# flat_adam: applied updates per accumulation setting.
FLAT_ADAM_UPDATES = 3
# The multi-tensor clip + Adam against the plain path where the clip engages:
# the norm is summed in another order (~1e-6 apart in fp32); a moment within
# this share of its leaf's largest, a parameter beyond one fp32 spacing at its
# own magnitude (its sum's rounding) within this share of its leaf's largest
# change (tests/test_torch_kernels.py's ADAM_CLIP_RTOL).
ADAM_CLIP_RTOL = 1e-4
# Its bytes an element: the norm reads the gradient, the update reads the
# gradient, the parameter and two moments and writes the last three.
ADAM_BYTES_PER_ELEMENT = 4 + 7 * 4
# pqmf_synthesis (row 12): the train step's synthesis, 128 clips of 4,000
# frames of 16 bands, 413 taps; the clips held against the fp64 host
# synthesis; the kernels against cuDNN in fp32 (TF32 off: the two differ in
# their order of summation only), relative L2.
PQMF_SHAPE = (128, 4000, 16)
PQMF_FP64_CLIPS = 4
TOL_PQMF_FP32 = 1e-5
# examples: torch_train_synthetic's clips (B = 16: 2 steps), the n=20 wire.
EXAMPLE_CLIPS = 32
EXAMPLE_WIRE_BYTES = 775
DATA_N = 1024
DATA_TILE = 64
DATA_STEPS = 3
DATA_PAIRS_CHECKED = 16
DATA_BLOCK = 32
# A matrix entry against spectral_distance on the card, and a 32-clip
# block against the same computation on the CPU: tests/test_data.py's
# bound for an entry against the direct distance (rtol, atol).
TOL_DIST = (1e-3, 1e-4)
# WAV decode, native against scipy's load_wav: the same int16 / 32768 (and
# two-channel mean) at 16 kHz; the 32 kHz file's linear 2:1 resample against
# scipy's polyphase filter on a 440 + 1320 Hz tone, away from the first and
# last WAV_EDGE samples (the filter's zero-padded edges); a 16 kHz file
# against the float clip written, int16 quantization (|x| / 32768 + 2^-16).
TOL_WAV_DECODE = 1e-6
TOL_WAV_RESAMPLED = 1e-3
WAV_EDGE = 100
TOL_WAV_QUANT = 1e-4
# spectral_distance with the hybrid STFT against fft on the card: the same
# forward (value, relative); the backward is the DFT as matmuls, so the
# gradient within the matmul method's bound, relative to its largest element
# (tests/test_torch_losses.py: GRAD_RTOL).
TOL_HYBRID = (1e-5, 1e-3)
# The training shell. trainer_main: main()'s defaults (the flagship,
# ContrastiveConfig's G = 12, batch 4, accumulation 4, fp32) on a synthetic
# corpus of DataConfig.num_train_samples = 64 (+ val_ratio 0.2: 76 clips,
# 63 train and 13 val), a 2 x 1 x 1 grid tuned one epoch a combo, then 2
# epochs, then one more by train.resume=true.
TRAINER_N = 64
TRAINER_ARGS = {
    "data.num_train_samples": TRAINER_N, "data.clip_samples": NUM_SAMPLES, "train.max_epochs": 2,
    "run_tuning": "true", "train.tuning_epochs": 1, "grid.encoder_lr": "0.001,0.0005",
    "grid.decoder_lr": "0.0001", "grid.complexity_penalty": "0.1",
}
TRAINER_TRAIN, TRAINER_VAL = 63, 13  # main's split of the 76 clips
TRAINER_BATCHES = TRAINER_TRAIN // 4, -(-TRAINER_VAL // 4)  # steps an epoch, batches a validate
# trainer_resume: 32 clips (28 train: 7 steps an epoch, so accumulation 4
# leaves a part-filled accumulator in the epoch-2 checkpoint; 4 val), an
# uninterrupted 3-epoch run against one killed after 2 and resumed.
RESUME_TRAIN, RESUME_VAL, RESUME_EPOCHS = 28, 4, 3
# epoch_b128: BASELINE config 4 (benchmarks/run_all.py:190-246): 2,048
# synthetic clips, the precompute at tile 64, 4 negatives (G = 6), B = 128,
# bf16, no accumulation, the device corpus; one warm-up step, then one epoch.
B128_N, B128_B, B128_NEGATIVES = 2048, 128, 4
# codec_cli: the port's CLI in-process on the card (no --device: the card),
# CLIPS clips of 64,000 samples through WAV files (the clips scaled by
# CLI_GAIN to stay inside int16), encode and decode CLI_RUNS times each (the
# first run builds the caches): the flagship from a save_params directory,
# the n=32 packed model from a Trainer checkpoint whose sidecar alone gives
# the geometry. The CLI's waveform against a direct Codec decode of the
# same bits: one int16 step (the WAV container's quantization).
CLI_RUNS = 2
CLI_GAIN = 0.5
TOL_INT16 = 2.0 / 32768.0
# tuner: benchmarks/full_recipe.py's tune stage (:314-336) at full width:
# the 8-combo grid, B = min(8, batch) = 8, G = 12 (ContrastiveConfig's
# default), the device corpus, scan_steps 16, bf16 (the recipe's dtype off
# the CPU); cut in scale only: 88 training clips for the recipe's 512 (11
# grid steps in one scanned segment, the first warms up) + 10 val (1 val
# batch), 1 tuning epoch for 5. Then TUNE_SEQ_STEPS timed steps of the
# production train step (the sequential tuner's, one combo) after a warm-up.
TUNE_GRID = {"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-3, 3e-4], "complexity_penalty": [0.05, 0.1]}
TUNE_TRAIN, TUNE_VAL, TUNE_B, TUNE_SCAN = 88, 10, 8, 16
TUNE_SEQ_STEPS = 10
# tuner_parity: one K = 2 grid step (fp32, B = 2 x G = 3, dropout off,
# cuDNN deterministic) against two single-combo steps of the port on the
# same weights and uniforms, at train_parity's bounds (loss, the whole
# gradient where conditioned, every surrogate leaf).
PARITY_GRID = {"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-4], "complexity_penalty": [0.1]}
# Data parallelism. dp_philox: rows 3-5 at [16, 6195], fp32 and bf16, a
# rank's 8 rows drawn with first = its first row x 6,195: row 8 (rank 1 of
# 2) and row 1 (first = 6,195, odd: every other Hard Concrete thread's pair
# crosses two Philox groups), against those rows of the first = 0 draw.
DP_FIRST_ROWS = (8, 1)
# dp1: Trainer(data_parallel=True) over NCCL at world size 1, at
# trainer_main's settings (TrainerConfig's defaults: G = 12, batch 4,
# accumulation 4, fp32) on trainer_resume's 28 + 4 clips for 2 epochs,
# cuDNN deterministic, with the replicated and the sharded corpus, against
# the same run without data parallelism; then the vmapped tuner on a mesh of
# one against the tuner without it (tuner_parity's grid and batch, 2 grid
# steps, dropout on).
DP1_EPOCHS = 2
# dp2: two processes on the one card over gloo (NCCL refuses two ranks on
# one device), the flagship step at full width, fp32, global B = 16 x G = 3
# (8 a rank), the replicated corpus, DP2_STEPS steps with accumulation 4 (no
# update within them, so every step's loss is held), against the world-1
# step on the same weights and seed, with train_parity's bounds.
DP2_B, DP2_STEPS, DP2_RANKS = 16, 3, 2
DP_TIMEOUT_S = 300  # every collective of dp2
DP2_JOIN_S = 600  # the children's deadline

# The kernels a Gumbel step launches once each, beside the attention's.
GUMBEL_EXPECT = {"binary_gumbel": 1, "binary_gumbel_bwd": 1}
# Row 12: the synthesis once a decode, its adjoint once a backward.
PQMF_KERNELS = ("pqmf_synthesis", "pqmf_synthesis_adjoint")
PQMF_PER_STEP = dict.fromkeys(PQMF_KERNELS, 1)
# Once a vmapped grid step, over every combo: rows 1, 2 and 12 both ways.
GRID_STEP_KERNELS = ("masked_attention_fwd", "masked_attention_bwd", *PQMF_KERNELS)
# The Hard Concrete kernels, forward and backward (rows 4 and 5).
HC_KERNELS = ("hard_concrete", "hard_concrete_bwd", "hard_concrete_learned", "hard_concrete_learned_bwd")
COMBINE_KERNELS = ("sccn_combine_fwd", "sccn_combine_bwd", "sccn_combine_packed_fwd",
                   "sccn_combine_packed_bwd", "sccn_combine_copy", "sccn_combine_matmul",
                   "sccn_combine_nogelu")


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up.

    Before each call the stream is given a ~2 ms spin kernel, so the host
    has enqueued the call before the start event runs: the time is the
    device's, without the wrapper's Python overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(q, mask, h: int, dtype_name: str) -> tuple[float, str]:
    """Least time for this run's attention: each input read once, each
    output written once, and the operations on the active keys only (the
    kernel neither loads nor scores a masked key)."""
    b, tq, c = q.shape
    active = int((mask > 0).sum().item())
    elt = q.element_size()
    nbytes = (
        q.numel() * elt  # q
        + 2 * active * c * elt  # active rows of K and V
        + mask.numel() * 4  # mask
        + q.numel() * elt  # out
        + b * h * tq * 4  # lse
    )
    flops = 4.0 * tq * c * active  # QK^T and PV, 2 FLOP per FMA, all heads
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# The profiles of this run: how many, which had to be taken again (no
# device activity at all), and which lost some of their device events.
PROFILES = {"profiles": 0, "retried": [], "lost_events": []}
# Host seconds of sleep that widen each profile's window on both sides. In
# H100 runs a profile's device timestamps sat up to ~5 ms off its launches'
# host timestamps, and the profiler drops the device events that then fall
# outside its window: a profile of a few microsecond kernels lost one or
# all of them (PERF.md).
PROFILE_PAD_S = 0.02


def device_rows(prof) -> list:
    """The key averages of ``prof`` that ran on the card: kernels, copies
    and sets, without the device-side rows of ``record_function``
    annotations (the port's ``taa.*`` spans), which are ranges and not
    work."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_events(torch, fn, what: str, reps: int = 20) -> list:
    """The device events (torch.profiler's key averages) of ``reps`` calls
    of ``fn``, after one call outside the profile, in a window widened by
    PROFILE_PAD_S on each side. A profile that recorded no device activity
    at all is taken once more and recorded in PROFILES, which the run
    prints; a second empty profile fails the check. A profile that lost
    some events (a kernel counted a number of times that is not a whole
    multiple of ``reps``) is recorded there too; ``per_call_ms`` then
    averages over the launches it kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    PROFILES["profiles"] += 1
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        device = device_rows(prof)
        if any(e.self_device_time_total > 0 for e in device):
            counts = {e.key[:60]: e.count for e in device}
            if any(c % reps for c in counts.values()):
                PROFILES["lost_events"].append({"what": what, "reps": reps, "counts": counts})
            return device
        if attempt == 0:
            PROFILES["retried"].append(what)
        print(f"chip_smoke: {what}: the profile recorded no device activity (attempt {attempt + 1})",
              file=sys.stderr, flush=True)
    check(False, f"{what}: two profiles recorded no device activity")


def launches_per_call(e, reps: int) -> int:
    """How many times one call launches the kernel of key-average ``e``."""
    return max(1, round(e.count / reps))


def per_call_ms(e, reps: int) -> float:
    """Device ms per call of the kernel of key-average ``e``: its mean over
    the launches the profile kept, times its launches per call."""
    return e.self_device_time_total / 1e3 / e.count * launches_per_call(e, reps)


def kernel_ms(torch, fn, kernels, what: str, reps: int = 20) -> dict:
    """Device ms per call of each named kernel that ``fn`` launches, from
    torch.profiler over ``reps`` calls (``device_events``; a kernel's name
    matches where it is a substring of the profiler's key). A named kernel
    without device time fails the check."""
    ms = dict.fromkeys(kernels, 0.0)
    for e in device_events(torch, fn, what, reps):
        for kernel in ms:
            if kernel in e.key:
                ms[kernel] += per_call_ms(e, reps)
    check(all(t > 0 for t in ms.values()), f"{what}: profiler shows no device time per kernel {ms}")
    return ms


def fwd_kernel_ms(torch, fn) -> dict:
    """The forward's two kernels: the split over keys and the merge."""
    return kernel_ms(torch, fn, ("attn_fwd_partial", "attn_fwd_merge"), "attention fwd")


def csrc_kernels(name: str) -> tuple:
    """The __global__ functions of the port's csrc/<name>.cu, in source order."""
    from topo_audio_autoencoder_torch import cuda_build

    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    return tuple(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(", src))


def bwd_kernel_ms(torch, fn) -> dict:
    """The backward's kernels, each of csrc/masked_attention_bwd.cu's by name
    (one call launches each once)."""
    return kernel_ms(torch, fn, csrc_kernels("masked_attention_bwd"), "attention bwd")


def combine_kernel_ms(torch, fn) -> dict:
    """The fused combine's kernels, each of csrc/sccn_combine.cu's by name:
    ``fn`` runs one forward and one backward call."""
    return kernel_ms(torch, fn, csrc_kernels("sccn_combine"), "sccn combine")


def measure_attention(torch, attention, q, k, v, mask, h: int, tol: float) -> dict:
    """The kernel against the plain version on the same inputs, two calls
    bit for bit, and the times of the kernel (and of its merge pass), the
    plain version and one library call."""
    import torch.nn.functional as F

    b, tq, c = q.shape
    name = str(q.dtype).removeprefix("torch.")
    out, lse = attention.attention_fwd(q, k, v, mask, h)
    again, again_lse = attention.attention_fwd(q, k, v, mask, h)
    torch.cuda.synchronize()
    check(torch.equal(out, again) and torch.equal(lse, again_lse),
          f"attention {name}: two calls on the same inputs differ")
    want, want_lse = attention.attention_fwd_plain(q, k, v, mask, h)
    valid = mask.sum(dim=-1) > 0
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse[valid] - want_lse[valid]).abs().max().item()
    check(out.shape == q.shape and out.dtype == q.dtype, f"attention {name}: output shape/dtype")
    check(bool((out[~valid] == 0).all()), f"attention {name}: fully masked element not exactly zero")
    check(bool(torch.isinf(lse[~valid]).all()), f"attention {name}: fully masked lse not +inf")
    check(err <= tol, f"attention {name}: max abs err {err} > {tol}")
    check(lse_err <= TOL_LSE, f"attention {name}: lse err {lse_err} > {TOL_LSE}")

    # One PyTorch library call computing the same function: a yardstick
    # only, never called by the port (it gives NaN where all keys are masked).
    qh, kh, vh = (t.view(t.shape[0], t.shape[1], h, c // h).transpose(1, 2) for t in (q, k, v))
    bool_mask = (mask > 0)[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask)

    lib_out = library().transpose(1, 2).reshape(b, tq, c)
    lib_err = (lib_out[valid].float() - want[valid].float()).abs().max().item()
    bound_ms, bound_by = attention_bound(q, mask, h, name)
    splits, blocks = attention.fwd_plan(q, k, h)
    per_kernel = fwd_kernel_ms(torch, lambda: attention.attention_fwd(q, k, v, mask, h))
    return dict(
        dtype=name, max_abs_err=err, tol=tol, lse_max_abs_err=lse_err,
        library_max_abs_err=lib_err, splits=splits, blocks=blocks,
        partial_ms=per_kernel["attn_fwd_partial"], merge_ms=per_kernel["attn_fwd_merge"],
        ms=time_ms(lambda: attention.attention_fwd(q, k, v, mask, h)),
        plain_ms=time_ms(lambda: attention.attention_fwd_plain(q, k, v, mask, h)),
        library_ms=time_ms(library),
        bound_ms=bound_ms, bound_by=bound_by,
        active_keys=int((mask > 0).sum().item()), keys=int(mask.numel()),
    )


def phase_kernel(torch, attention) -> None:
    """Synthetic inputs at the codec's attention shape: about 40% active
    keys, element 0 fully masked, element 1 with a single active key."""
    dev = torch.device(DEVICE)
    b, tq, m, c, h = (ATTN[k] for k in ("b", "q", "m", "c", "h"))
    rng = np.random.default_rng(SEED)
    base = [rng.standard_normal(s).astype(np.float32) for s in ((b, tq, c), (b, m, c), (b, m, c))]
    mask_np = (rng.uniform(size=(b, m)) < 0.4).astype(np.float32)
    mask_np[0] = 0.0
    mask_np[1] = 0.0
    mask_np[1, 4321] = 1.0
    mask = torch.from_numpy(mask_np).to(dev)
    results = []
    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in base)
        results.append(measure_attention(torch, attention, q, k, v, mask, h, tol))
        out = attention.fused_masked_attention(q, k, v, mask, h)
        single = (out[1].float() - v[1, 4321].float()).abs().max().item()
        check(single <= tol, f"attention {dtype}: single-key element err {single}")
    emit("kernel", kernel="masked_attention_fwd", inputs="synthetic", shape=ATTN, results=results)


def attention_bwd_bound(q, mask, h: int, dtype_name: str) -> tuple[float, str]:
    """Least time for this run's attention backward: q, O, dO and dq, the
    active rows of K and V, all of dK and dV, the mask and L, each moved
    once; S, dP, dV, dK and dQ on the active keys (10 Q C FLOP per active
    key over all heads)."""
    b, tq, c = q.shape
    m = mask.shape[1]
    active = int((mask > 0).sum().item())
    elt = q.element_size()
    nbytes = (
        4 * q.numel() * elt  # q, O, dO in; dq out
        + 2 * active * c * elt  # active rows of K and V
        + 2 * b * m * c * elt  # dK and dV out (masked rows as zeros)
        + mask.numel() * 4 + b * h * tq * 4  # mask, L
    )
    flops = 10.0 * tq * c * active
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def measure_attention_bwd(torch, attention, q, k, v, mask, dout, h: int) -> dict:
    """The backward kernels against the plain backward on the same inputs;
    masked dK/dV rows and a fully masked element's gradients exactly zero;
    two calls bit for bit; times of the kernels (the whole call and each
    kernel), the plain version, SDPA forward + backward and SDPA's backward
    alone."""
    import torch.nn.functional as F

    b, tq, c = q.shape
    name = str(q.dtype).removeprefix("torch.")
    out, lse = attention.attention_fwd(q, k, v, mask, h)
    got = attention.attention_bwd(q, k, v, mask, out, lse, dout, h)
    again = attention.attention_bwd(q, k, v, mask, out, lse, dout, h)
    torch.cuda.synchronize()
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"attention bwd {name}: two calls on the same inputs differ")
    want = attention.attention_bwd_plain(q, k, v, mask, out, lse, dout, h)
    errs, rels = {}, {}
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == q.dtype, f"attention bwd {name}: {key} shape/dtype")
        errs[key] = (g.float() - w.float()).abs().max().item()
        rels[key] = errs[key] / max(w.float().abs().max().item(), 1e-30)
        check(rels[key] <= TOL_BWD[name], f"attention bwd {name}: {key} rel err {rels[key]}")
    dq, dk, dv = got
    masked = mask == 0
    check(bool((dk[masked] == 0).all() and (dv[masked] == 0).all()),
          f"attention bwd {name}: masked dk/dv rows not exactly zero")
    empty = mask.sum(dim=-1) == 0
    check(bool((dq[empty] == 0).all()), f"attention bwd {name}: fully masked element's dq not zero")

    # SDPA through autograd: a yardstick only, never called by the port.
    # forward + backward, and the backward alone on one saved forward.
    qh, kh, vh = (t.view(t.shape[0], t.shape[1], h, c // h).transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    doh = dout.view(b, tq, h, c // h).transpose(1, 2)
    bool_mask = (mask > 0)[:, None, None, :]

    def library():
        o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask)
        return torch.autograd.grad(o, (qh, kh, vh), doh)

    saved = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask)

    def library_bwd():
        return torch.autograd.grad(saved, (qh, kh, vh), doh, retain_graph=True)

    bound_ms, bound_by = attention_bwd_bound(q, mask, h, name)
    # A parent tree, unpacked to compare with, may predate the split backward.
    plan = getattr(attention, "bwd_plan", None)
    splits, blocks = plan(q, k, h) if plan else (None, None)
    call = lambda: attention.attention_bwd(q, k, v, mask, out, lse, dout, h)  # noqa: E731
    return dict(
        dtype=name, max_abs_err=max(errs.values()), max_abs_err_by_grad=errs, rel_err=rels,
        tol_rel=TOL_BWD[name], splits=splits, blocks=blocks, per_kernel_ms=bwd_kernel_ms(torch, call),
        ms=time_ms(call),
        plain_ms=time_ms(lambda: attention.attention_bwd_plain(q, k, v, mask, out, lse, dout, h)),
        library_ms=time_ms(library), library_bwd_ms=time_ms(library_bwd),
        bound_ms=bound_ms, bound_by=bound_by,
        active_keys=int((mask > 0).sum().item()), keys=int(mask.numel()),
    )


def synthetic_attention(torch, b: int, dtypes, seed: int):
    """[B, 250, 64] queries, [B, 6175, 64] keys/values/dO at the flagship
    shape: about 40% active keys, element 0 fully masked, element 1 a
    single active key (4321)."""
    dev = torch.device(DEVICE)
    tq, m, c = ATTN["q"], ATTN["m"], ATTN["c"]
    rng = np.random.default_rng(seed)
    base = [rng.standard_normal(s).astype(np.float32) for s in ((b, tq, c), (b, m, c), (b, m, c), (b, tq, c))]
    mask_np = (rng.uniform(size=(b, m)) < 0.4).astype(np.float32)
    mask_np[0] = 0.0
    mask_np[1] = 0.0
    mask_np[1, 4321] = 1.0
    mask = torch.from_numpy(mask_np).to(dev)
    for dtype in dtypes:
        yield (*(torch.from_numpy(a).to(dev, dtype) for a in base), mask)


def phase_kernel_bwd(torch, attention) -> None:
    """The attention backward on synthetic inputs at the train step's shape."""
    h = ATTN["h"]
    results = []
    for q, k, v, dout, mask in synthetic_attention(torch, TRAIN_B, (torch.float32, torch.bfloat16), SEED + 1):
        results.append(measure_attention_bwd(torch, attention, q, k, v, mask, dout, h))
    emit("kernel", kernel="masked_attention_bwd", inputs="synthetic",
         shape=dict(ATTN, b=TRAIN_B), results=results)


def sampler_bound(n: int, elt: int) -> tuple[float, str]:
    """Least time for one sampler pass over n logits: read the logits and
    write s once; about 40 operations per element (a quarter of one
    Philox4x32-10 block, the logistic transform, the sigmoid) at the fp32
    rate outside the tensor cores."""
    t_bytes = 2 * n * elt / HBM_BPS
    t_ops = 40.0 * n / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_sampler(torch, fused, n_simplices: int) -> dict:
    """The binary-Gumbel kernel at the train step's logits [16, 6195]: s
    against the plain relaxation of the kernel's own uniforms, which must
    equal the plain Philox stream bit for bit; reproducibility; the
    uniforms' statistics over 4M draws. No single PyTorch call computes
    this function, so there is no library time."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 2)
    shape = (TRAIN_B, n_simplices)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        logits = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32)).to(dev, dtype)
        s, u = fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED, offset=7, return_noise=True)
        torch.cuda.synchronize()
        want_u = fused.philox_uniform(logits.numel(), SEED, 7, dev).reshape(shape)
        check(torch.equal(u, want_u), f"sampler {name}: kernel uniforms differ from the Philox stream")
        want = fused.binary_gumbel_plain(logits, u, TEMPERATURE)
        err = (s.float() - want.float()).abs().max().item()
        check(s.dtype == dtype and s.shape == logits.shape, f"sampler {name}: shape/dtype")
        check(err <= TOL_SAMPLER[name], f"sampler {name}: max abs err {err} > {TOL_SAMPLER[name]}")
        again = fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED, offset=7)
        other = fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED + 1, offset=7)
        check(torch.equal(again, s), f"sampler {name}: the same (seed, offset) does not reproduce")
        check(not torch.equal(other, s), f"sampler {name}: another seed gives the same sample")
        noise_s = fused.binary_gumbel_sample(logits, TEMPERATURE, noise=u)
        check((noise_s.float() - want.float()).abs().max().item() <= TOL_SAMPLER[name],
              f"sampler {name}: the injected-noise entry point disagrees")

        def plain():
            uu = fused.philox_uniform(logits.numel(), SEED, 7, dev).reshape(shape)
            return fused.binary_gumbel_plain(logits, uu, TEMPERATURE)

        def sample():
            return fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED, offset=7)

        bound_ms, bound_by = sampler_bound(logits.numel(), logits.element_size())
        results.append(dict(
            dtype=name, max_abs_err=err, tol=TOL_SAMPLER[name], ms=time_ms(sample),
            device_ms=kernel_ms(torch, sample, ("philox_kernel",), f"binary_gumbel {name}")["philox_kernel"],
            plain_ms=time_ms(plain), library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        ))
    for shape in RAGGED_SHAPES:
        x = torch.linspace(-3.0, 3.0, math.prod(shape), device=dev).reshape(shape)
        _, u = fused.binary_gumbel_sample(x, TEMPERATURE, seed=SEED, offset=5, return_noise=True)
        check(torch.equal(u, fused.philox_uniform(x.numel(), SEED, 5, dev).reshape(shape)),
              f"sampler {shape}: kernel uniforms differ from the Philox stream at a ragged length")
    _, u = fused.binary_gumbel_sample(torch.zeros(SAMPLER_DRAWS, device=dev), 1.0, seed=SEED + 3,
                                      return_noise=True)
    n = u.numel()
    mean_tol = 5 * (1 / 12) ** 0.5 / n ** 0.5  # 5 standard errors
    frac_tol = 5 * 0.5 / n ** 0.5
    mean = u.mean().item()
    below = (u < 0.5).float().mean().item()
    check(abs(mean - 0.5) <= mean_tol, f"sampler uniforms: mean {mean}")
    check(abs(below - 0.5) <= frac_tol, f"sampler uniforms: fraction below 0.5 {below}")
    check(u.min().item() >= np.float32(1e-6) and u.max().item() <= np.float32(1 - 1e-6), "uniforms out of range")
    emit("kernel", kernel="binary_gumbel", inputs="synthetic", shape=list(shape), results=results,
         ragged_uniforms_equal=[list(r) for r in RAGGED_SHAPES],
         uniforms=dict(draws=n, mean=mean, mean_tol=mean_tol, frac_below_half=below, frac_tol=frac_tol))
    return results[0]


def make_clips(batch: int, seed: int) -> np.ndarray:
    """[B, 1, 64000] float32: a few sines plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(NUM_SAMPLES) / 16000.0
    freqs = rng.uniform(60.0, 6000.0, size=(batch, 4, 1))
    amps = rng.uniform(0.05, 0.4, size=(batch, 4, 1))
    x = (amps * np.sin(2 * np.pi * freqs * t)).sum(axis=1)
    x += 0.02 * rng.standard_normal((batch, NUM_SAMPLES))
    return x[:, None, :].astype(np.float32)


def phase_serve(torch, port, counters) -> tuple:
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    with torch.no_grad():
        model.encoder.mlp2.bias += LOGIT_SHIFT
    codec = port.Codec(model, device=DEVICE)
    n = FLAGSHIP["num_vertices"]
    for c in counters.values():
        c.launches = 0  # just before the serve path
    decoder_calls = 0
    timed = []
    for i in range(REQUESTS + 1):  # request 0 warms up
        x = make_clips(CLIPS, SEED + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latent = codec.encode(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wire = port.pack_latent(latent)
        back = port.unpack_latent(wire, n)
        t2 = time.perf_counter()
        y = codec.decode(back, NUM_SAMPLES)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec = codec.reconstruct(x)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        decoder_calls += 2
        check(wire.shape == (CLIPS, math.ceil(sum(model.tables.sizes) / 8)), "wire size")
        for a, b in zip(latent.ranks, back.ranks):
            check(torch.equal(a.cpu(), b), "latent does not round-trip bit-exactly")
        for w in (y, rec):
            check(tuple(w.shape) == (CLIPS, 1, NUM_SAMPLES), f"waveform shape {tuple(w.shape)}")
            check(bool(torch.isfinite(w).all()), "non-finite waveform")
        if i > 0:
            timed.append(dict(
                encode_ms=(t1 - t0) * 1e3, pack_unpack_ms=(t2 - t1) * 1e3,
                decode_ms=(t3 - t2) * 1e3, reconstruct_ms=(t4 - t3) * 1e3,
                active=[float(r.sum(dim=-1).mean()) for r in latent.ranks],
            ))
    counts = {name: c.launches for name, c in counters.items()}  # just after the serve path
    launches = counts["masked_attention_fwd"]
    check(launches == decoder_calls, f"attention launches {launches} != decoder calls {decoder_calls}")
    check(counts["pqmf_synthesis"] == decoder_calls,
          f"synthesis launches {counts['pqmf_synthesis']} != decoder calls {decoder_calls}")
    check(all(n == 0 for name, n in counts.items() if name not in ("masked_attention_fwd", "pqmf_synthesis")),
          f"the eval path launched training kernels: {counts}")
    enc = statistics.median(t["encode_ms"] for t in timed)
    dec = statistics.median(t["decode_ms"] for t in timed)
    emit(
        "serve", config=FLAGSHIP, clips=CLIPS, samples=NUM_SAMPLES, requests=timed,
        encode_ms=enc, decode_ms=dec, clips_per_s=CLIPS / ((enc + dec) / 1e3),
        wire_bytes_per_clip=int(wire.shape[1]), attention_launches=launches,
        launches=counts, decoder_calls=decoder_calls, num_params=model.num_params(),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    return model, codec


def phase_main_attention(torch, attention, model, codec) -> dict:
    """The kernel on the attention inputs of one more decode of the main
    path (captured after its launch counts were read)."""
    ca = model.decoder.cross_attention
    captured = {}

    def grab(module, args):
        captured["args"] = tuple(a.detach().clone() for a in args)

    handle = ca.register_forward_pre_hook(grab)
    try:
        codec.decode(codec.encode(make_clips(CLIPS, SEED)), NUM_SAMPLES)
    finally:
        handle.remove()
    query, keys, values, mask = captured["args"]
    with torch.inference_mode():
        q, k, v = ca.q_proj(query), ca.k_proj(keys), ca.v_proj(values)
        result = measure_attention(torch, attention, q, k, v, mask, ca.num_heads, TOL_FP32)
    emit("kernel", kernel="masked_attention_fwd", inputs="main path decode",
         shape=dict(b=q.shape[0], q=q.shape[1], m=k.shape[1], c=q.shape[2], h=ca.num_heads),
         results=[result])
    return result


def phase_trace(torch, codec) -> None:
    """Where one decode of 8 clips spends device time (torch.profiler):
    device busy share, and the top ops by inclusive and kernels by self
    device time. Recorded, not checked."""
    from torch.profiler import ProfilerActivity, profile

    latent = codec.encode(make_clips(CLIPS, SEED))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        codec.decode(latent, NUM_SAMPLES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(
        (e for e in device_rows(prof) if e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted(
        (e for e in events if e.key.startswith("aten::") and e.device_time_total > 0),
        key=lambda e: -e.device_time_total,
    )
    emit(
        "trace", what="one Codec.decode of 8 clips under torch.profiler",
        wall_ms_profiled=wall_ms, device_ms=device_ms, kernel_launches=sum(e.count for e in kernels),
        device_busy_share_profiled=device_ms / wall_ms,
        top_ops=[(e.key, e.device_time_total / 1e3, e.count) for e in ops[:12]],
        top_kernels=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels[:12]],
    )


def phase_parity(torch, port, model, codec) -> None:
    """The card's weights on a CPU model; plain path vs the card."""
    x = make_clips(2, SEED + 100)
    cpu_model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 1, device="cpu")
    cpu_codec = port.Codec(cpu_model, {k: t.cpu() for k, t in model.state_dict().items()}, device="cpu")
    with torch.inference_mode():
        gpu_enc = model.encode(torch.from_numpy(x).to(DEVICE))
        cpu_enc = cpu_model.encode(torch.from_numpy(x))
    logits = cpu_enc.logits.numpy()
    logit_err = float(np.abs(gpu_enc.logits.cpu().numpy() - logits).max())
    check(logit_err <= LOGIT_TOL, f"logits card vs cpu: {logit_err} > {LOGIT_TOL}")
    # Bits before the rectifier: a flip is allowed only where the CPU's
    # logit lies within LOGIT_TOL of the threshold.
    bias = np.zeros_like(logits)
    bias[:, : FLAGSHIP["num_vertices"]] = float(model.encoder.vertex_bias.detach().relu())
    raw_cpu = logits + bias > 0.5
    raw_gpu = gpu_enc.logits.cpu().numpy() + bias > 0.5
    near = np.abs(logits + bias - 0.5) <= LOGIT_TOL
    flipped = raw_cpu != raw_gpu
    check(not (flipped & ~near).any(), "latent bits flip away from the threshold")
    if not flipped.any():
        for a, b in zip(gpu_enc.probs.ranks, cpu_enc.probs.ranks):
            check(torch.equal(a.cpu(), b), "rectified latents differ with equal raw bits")
    latent = port.SimplicialLatent(*cpu_enc.probs.ranks)
    wave_gpu = codec.decode(latent, NUM_SAMPLES).cpu().numpy()
    wave_cpu = cpu_codec.decode(latent, NUM_SAMPLES).numpy()
    wave_err = float(np.abs(wave_gpu - wave_cpu).max())
    check(np.isfinite(wave_cpu).all(), "non-finite CPU waveform")
    check(wave_err <= WAVE_TOL, f"decode card vs cpu: {wave_err} > {WAVE_TOL}")
    rec_err = None
    if not flipped.any():
        rec_gpu = codec.reconstruct(x).cpu().numpy()
        rec_cpu = cpu_codec.reconstruct(x).numpy()
        rec_err = float(np.abs(rec_gpu - rec_cpu).max())
        check(rec_err <= WAVE_TOL, f"reconstruct card vs cpu: {rec_err} > {WAVE_TOL}")
    emit(
        "parity", clips=2, logit_max_abs_err=logit_err, logit_tol=LOGIT_TOL,
        bits_flipped=int(flipped.sum()), bits_near_threshold=int(near.sum()),
        decode_max_abs_err=wave_err, reconstruct_max_abs_err=rec_err, wave_tol=WAVE_TOL,
        wave_max_abs=float(np.abs(wave_cpu).max()),
    )


def train_batch(seed: int, b: int) -> np.ndarray:
    """[B, G, 1, 64000]: anchor, positive and negative clips, made as the
    serve phase makes its clips."""
    return make_clips(b * TRAIN_G, seed).reshape(b, TRAIN_G, 1, NUM_SAMPLES)


def timed_steps(torch, step, state, batches, counters):
    """Runs the batches through the step (the first warms up), the launch
    counters zeroed just before and read just after; every loss component
    of every step must be finite. Returns (state, step ms, components,
    launches)."""
    for c in counters.values():
        c.launches = 0  # just before the main path
    times, metrics = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, TEMPERATURE, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = {name: c.launches for name, c in counters.items()}  # just after
    components = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, comp in enumerate(components):
        check(all(math.isfinite(v) for v in comp.values()), f"train step {i}: non-finite loss {comp}")
    return state, times, components, launches


def phase_train(torch, port, counters) -> tuple:
    """The flagship train step at full width, fp32: a warm-up step and
    TRAIN_STEPS timed ones, then BF16_STEPS bf16 steps. Every loss
    component of every step must be finite."""
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    opt = port.make_optimizer(accumulate_grad_batches=1)
    state = port.create_train_state(model, opt)
    step = port.make_train_step(model, opt)
    batches = [torch.from_numpy(train_batch(SEED + 300 + i, TRAIN_B)).to(DEVICE)
               for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, times, components, launches = timed_steps(torch, step, state, batches, counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(batches)
    per_step = {name: n / steps for name, n in launches.items()}
    check(launches["binary_gumbel"] == steps and launches["binary_gumbel_bwd"] == steps,
          f"sampler launches {launches} for {steps} steps")
    check(launches["masked_attention_fwd"] == steps, f"attention fwd launches {launches} for {steps} steps")
    check(launches["masked_attention_bwd"] >= steps, f"attention bwd launches {launches} for {steps} steps")
    check(all(launches[k] == 0 for k in HC_KERNELS), f"the Gumbel step launched a Hard Concrete kernel: {launches}")
    check(all(launches[k] == 0 for k in COMBINE_KERNELS), f"the unfused step launched a combine kernel: {launches}")
    check(all(launches[k] == steps for k in PQMF_KERNELS), f"synthesis launches {launches} for {steps} steps")
    step_ms = statistics.median(times[1:])

    bf16_opt = port.make_optimizer(accumulate_grad_batches=1)
    bf16_step = port.make_train_step(model, bf16_opt, compute_dtype=torch.bfloat16)
    _, bf16_times, bf16_components, bf16_launches = timed_steps(
        torch, bf16_step, port.create_train_state(model, bf16_opt), batches[:BF16_STEPS], counters)
    check(bf16_launches["binary_gumbel"] == BF16_STEPS and bf16_launches["binary_gumbel_bwd"] == BF16_STEPS
          and all(bf16_launches[k] == 0 for k in HC_KERNELS)
          and all(bf16_launches[k] == BF16_STEPS for k in PQMF_KERNELS), f"bf16 step launches {bf16_launches}")
    check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in model.parameters()),
          "master parameters not finite fp32 after the bf16 steps")
    emit(
        "train", config=FLAGSHIP, anchors=TRAIN_B, group=TRAIN_G, samples=NUM_SAMPLES,
        dtype="float32", temperature=TEMPERATURE, steps_timed=TRAIN_STEPS, step_ms=times,
        step_ms_median=step_ms, anchors_per_s=TRAIN_B / (step_ms / 1e3),
        clips_per_s=TRAIN_B * TRAIN_G / (step_ms / 1e3), components=components,
        launches=launches, launches_per_step=per_step, peak_mem_gib=peak_gib,
        num_params=model.num_params(),
        bf16=dict(step_ms=bf16_times, components=bf16_components, launches=bf16_launches),
    )
    return model, state, step, batches[0], launches


def phase_train_kernels(torch, attention, model, state, step, batch, inputs="main path train step") -> tuple:
    """The attention forward and backward kernels on the inputs of one more
    train step's cross-attention: q, k, v, the mask, and the gradient dO
    that reached the attention output (captured after the launch counts
    were read)."""
    ca = model.decoder.cross_attention
    cap = {}
    hooks = [
        ca.register_forward_pre_hook(lambda m, args: cap.__setitem__("mask", args[3].detach().clone())),
        ca.q_proj.register_forward_hook(lambda m, a, o: cap.__setitem__("q", o.detach().clone())),
        ca.k_proj.register_forward_hook(lambda m, a, o: cap.__setitem__("k", o.detach().clone())),
        ca.v_proj.register_forward_hook(lambda m, a, o: cap.__setitem__("v", o.detach().clone())),
        ca.out_proj.register_full_backward_hook(
            lambda m, gin, gout: cap.__setitem__("dout", gin[0].detach().clone())),
    ]
    try:
        step(state, batch, TEMPERATURE, SEED)
        torch.cuda.synchronize()
    finally:
        for hk in hooks:
            hk.remove()
    q, k, v, mask, dout = (cap[n].contiguous() for n in ("q", "k", "v", "mask", "dout"))
    shape = dict(b=q.shape[0], q=q.shape[1], m=k.shape[1], c=q.shape[2], h=ca.num_heads)
    with torch.inference_mode():
        fwd = measure_attention(torch, attention, q, k, v, mask, ca.num_heads, TOL_FP32_DENSE)
    bwd = measure_attention_bwd(torch, attention, q, k, v, mask, dout, ca.num_heads)
    emit("kernel", kernel="masked_attention_fwd", inputs=inputs, shape=shape, results=[fwd])
    emit("kernel", kernel="masked_attention_bwd", inputs=inputs, shape=shape, results=[bwd])
    return fwd, bwd


def phase_train_trace(torch, state, step, batch, what="one flagship train step (fp32, B=16, G=3)") -> None:
    """Where one train step spends device time."""
    trace_call(torch, lambda: step(state, batch, TEMPERATURE, SEED), what)


def profile_call(torch, fn) -> tuple:
    """One call of ``fn`` under torch.profiler: (the wall, device time,
    launches and busy share; the aten ops and the kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(
        (e for e in device_rows(prof) if e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted(
        (e for e in events if e.key.startswith("aten::") and e.device_time_total > 0),
        key=lambda e: -e.device_time_total,
    )
    fields = dict(
        wall_ms_profiled=wall_ms, device_ms=device_ms, kernel_launches=sum(e.count for e in kernels),
        device_busy_share_profiled=device_ms / wall_ms,
    )
    return fields, ops, kernels


def trace_call(torch, fn, what: str) -> dict:
    """Where one call of ``fn`` spends device time (torch.profiler): device
    busy share, top ops and kernels. Recorded, not checked; returns the
    wall, device time, launches and busy share."""
    fields, ops, kernels = profile_call(torch, fn)
    emit(
        "trace", what=f"{what} under torch.profiler", **fields,
        top_ops=[(e.key, e.device_time_total / 1e3, e.count) for e in ops[:15]],
        top_kernels=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels[:15]],
    )
    return fields


def surrogate(torch, model, batch, noise, w, hard_noise=None):
    """The train objective's forward with the spectral distance replaced by
    <recon, w>: well conditioned in every gradient leaf. G = 1 drops the
    contrastive term; the expected-L0 term (zero for the Gumbel sampler)
    is added. Returns the value and the encoder output."""
    from topo_audio_autoencoder_torch.models.encoder import (
        info_nce_loss,
        rank_diversity_entropy,
        vertex_count_penalty,
    )

    b, g, _, t = batch.shape
    flat = batch.reshape(b * g, 1, t)
    logits = model.encoder.compute_logits(model.pqmf(flat).transpose(-1, -2), True)
    contrastive = info_nce_loss(logits.reshape(b, g, -1)) if g >= 3 else 0.0
    enc = model.encoder.generate_complex(logits.reshape(b, g, -1)[:, 0], TEMPERATURE, True, noise=noise,
                                         hard_noise=hard_noise)
    recon = model.decode(enc, t // model.num_bands, True)
    reg = rank_diversity_entropy(enc.rectified).mean() + vertex_count_penalty(
        enc.rectified.vertices, model.min_active_vertices, model.max_active_vertices).mean()
    return (recon * w).sum() + contrastive + reg + enc.l0.mean(), enc, recon


def step_cotangent(torch, model, batch, noise, weights):
    """The train loss's gradient with respect to the reconstruction at
    ``model``'s forward on ``batch`` and ``noise``: the cotangent that the
    step's backward pulls through the decoder. The surrogate with this w
    has the real step's gradient through the reconstruction, with the
    spectral loss's ill-conditioned Jacobian evaluated once and shared."""
    from topo_audio_autoencoder_torch.training.losses import autoencoder_loss

    with torch.no_grad():
        _, enc, recon = surrogate(torch, model, batch, noise, 0.0)
    recon = recon.detach().requires_grad_()
    zeros = torch.zeros(recon.shape[0], device=recon.device)
    total, _ = autoencoder_loss(recon, batch[:, 0], {"binary_entropy": zeros, "diversity": zeros}, enc.valid,
                                weights)
    return torch.autograd.grad(total, recon)[0]


def hc_bound(n: int, elt: int, row_bytes: int = 0) -> tuple[float, str]:
    """Least time for one Hard Concrete pass over n gates: read log-alpha
    and write z once (and the three fp32 stretch rows once), about
    HC_OPS_PER_ELEMENT operations per gate at the fp32 rate outside the
    tensor cores."""
    t_bytes = (2 * n * elt + row_bytes) / HBM_BPS
    t_ops = HC_OPS_PER_ELEMENT * n / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def stretch_rows(torch, cols: int, rng):
    """Per-simplex (beta, gamma, zeta) rows around the fixed stretch, as a
    learned model's drift, fp32 on the card."""
    rows = (rng.uniform(0.4, 1.0, cols), -rng.uniform(0.05, 0.2, cols), 1.0 + rng.uniform(0.05, 0.2, cols))
    return [torch.from_numpy(r.astype(np.float32)).to(DEVICE) for r in rows]


def phase_kernel_hc(torch, hc, fused, n_simplices: int) -> dict:
    """Rows 4 and 5 at their train steps' log-alpha ([32, 6195] fixed,
    [16, 6195] learned), fp32 and bf16: z against the plain version on the
    kernel's own uniforms (equal to the plain Philox stream bit for bit);
    both clips occur and are exact; reproducibility; the injected-uniforms
    entry; the learned kernel with rows of the fixed stretch equal to the
    fixed kernel bit for bit; then the gate statistics over 4M draws. No
    single PyTorch call computes either function: no library time."""
    from topo_audio_autoencoder_torch.ops.samplers import hard_concrete_l0_penalty

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 6)
    rows = stretch_rows(torch, n_simplices, rng)
    fixed_rows = [torch.full((n_simplices,), v, device=dev) for v in (HC_BETA, -0.1, 1.1)]
    out = {}
    for kernel, b in (("hard_concrete", HC_B), ("hard_concrete_learned", TRAIN_B)):
        shape = (b, n_simplices)
        results = []
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            a = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32)).to(dev, dtype)
            if kernel == "hard_concrete":
                def sample(a=a, **kw):
                    return hc.hard_concrete_sample(a, HC_BETA, **kw)

                def plain(u, a=a):
                    return hc.hard_concrete_plain(a, u, HC_BETA)

                row_bytes = 0
            else:
                def sample(a=a, **kw):
                    return hc.hard_concrete_learned_sample(a, *rows, **kw)

                def plain(u, a=a):
                    return hc.hard_concrete_learned_plain(a, u, *rows)

                row_bytes = 3 * n_simplices * 4
                same = torch.equal(hc.hard_concrete_learned_sample(a, *fixed_rows, seed=SEED),
                                   hc.hard_concrete_sample(a, HC_BETA, seed=SEED))
                check(same, f"{kernel} {name}: rows of the fixed stretch differ from the fixed kernel")
            z, u = sample(seed=SEED, offset=11, return_noise=True)
            torch.cuda.synchronize()
            check(torch.equal(u, fused.philox_uniform(a.numel(), SEED, 11, dev).reshape(shape)),
                  f"{kernel} {name}: kernel uniforms differ from the Philox stream")
            want = plain(u)
            err = (z.float() - want.float()).abs().max().item()
            check(z.dtype == dtype and z.shape == a.shape, f"{kernel} {name}: shape/dtype")
            check(err <= TOL_SAMPLER[name], f"{kernel} {name}: max abs err {err} > {TOL_SAMPLER[name]}")
            check(bool(((z >= 0) & (z <= 1)).all()), f"{kernel} {name}: a gate outside [0, 1]")
            zeros, ones = (z == 0).float().mean().item(), (z == 1).float().mean().item()
            check(zeros > 0 and ones > 0, f"{kernel} {name}: no exact clip to 0 or 1")
            check(torch.equal(sample(seed=SEED, offset=11), z), f"{kernel} {name}: (seed, offset) does not reproduce")
            check(not torch.equal(sample(seed=SEED + 1, offset=11), z), f"{kernel} {name}: another seed, same gates")
            check((sample(noise=u).float() - want.float()).abs().max().item() <= TOL_SAMPLER[name],
                  f"{kernel} {name}: the injected-noise entry point disagrees")

            def plain_full(a=a, plain=plain):
                return plain(fused.philox_uniform(a.numel(), SEED, 11, dev).reshape(a.shape))

            def timed(sample=sample):
                return sample(seed=SEED, offset=11)

            bound_ms, bound_by = hc_bound(a.numel(), a.element_size(), row_bytes)
            results.append(dict(
                dtype=name, max_abs_err=err, tol=TOL_SAMPLER[name], frac_zero=zeros, frac_one=ones,
                ms=time_ms(timed), device_ms=kernel_ms(torch, timed, ("philox_kernel",), f"{kernel} {name}")["philox_kernel"],
                plain_ms=time_ms(plain_full), library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            ))
        for ragged in RAGGED_SHAPES:
            x = torch.linspace(-3.0, 3.0, math.prod(ragged), device=dev).reshape(ragged)
            if kernel == "hard_concrete":
                _, u = hc.hard_concrete_sample(x, HC_BETA, seed=SEED, offset=5, return_noise=True)
            else:
                ragged_rows = stretch_rows(torch, ragged[-1], rng)
                _, u = hc.hard_concrete_learned_sample(x, *ragged_rows, seed=SEED, offset=5, return_noise=True)
            check(torch.equal(u, fused.philox_uniform(x.numel(), SEED, 5, dev).reshape(ragged)),
                  f"{kernel} {ragged}: kernel uniforms differ from the Philox stream at a ragged length")
        emit("kernel", kernel=kernel, inputs="synthetic", shape=list(shape), results=results,
             ragged_uniforms_equal=[list(r) for r in RAGGED_SHAPES])
        out[kernel] = results[0]
    z = hc.hard_concrete_sample(torch.zeros(HC_DRAWS, device=dev), HC_BETA, seed=SEED + 3)
    p = 1.0 / (1.0 + math.exp(-HC_BETA * math.log(1.0 / 11.0)))
    tol = 5 * math.sqrt(p * (1 - p) / HC_DRAWS)  # 5 standard errors
    zeros, ones, nonzero = ((z == 0).float().mean().item(), (z == 1).float().mean().item(),
                            (z > 0).float().mean().item())
    l0 = hard_concrete_l0_penalty(torch.zeros(1, device=dev), HC_BETA).item()
    check(abs(zeros - p) <= tol, f"hard_concrete gates: fraction exactly 0 {zeros}, want {p} +- {tol}")
    check(abs(ones - p) <= tol, f"hard_concrete gates: fraction exactly 1 {ones}, want {p} +- {tol}")
    check(abs(nonzero - l0) <= tol, f"hard_concrete gates: P(z > 0) {nonzero} against the L0 term {l0}")
    emit("kernel", kernel="hard_concrete", inputs="gate statistics", draws=HC_DRAWS, beta=HC_BETA,
         frac_zero=zeros, frac_one=ones, expected=p, tol=tol, frac_nonzero=nonzero, l0_term=l0)
    return out


def sampler_bwd_bound(kernel: str, n: int, elt: int, ct_elt: int, cols: int = 0) -> tuple[float, str]:
    """Least time for one backward pass over n elements: read the residual
    and the cotangent and write the gradient once (the learned kernel also
    reads its three fp32 rows and writes three fp32 column sums), and
    SAMPLER_BWD_OPS[kernel] operations per element at the fp32 rate."""
    t_bytes = (n * (2 * elt + ct_elt) + 6 * cols * 4) / HBM_BPS
    t_ops = SAMPLER_BWD_OPS[kernel] * n / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def col_sum_excess(torch, hc, got, want, terms) -> float:
    """How far a column sum exceeds its stated bound (<= 0: within it)."""
    rows = terms.numel() // terms.shape[-1]
    bound = (rows + len(hc.row_slices(rows)) + SUM_TERM_ULPS) * 2.0 ** -24 * hc.column_sums(terms.abs())
    return ((got.float() - want.float()).abs() - bound).max().item()


def phase_kernel_sampler_bwd(torch, fused, hc, n_simplices: int) -> dict:
    """The samplers' backward kernels at their train steps' shapes (Gumbel
    [16, 6195], fixed [32, 6195], learned [16, 6195]), fp32 and bf16,
    train and eval for the Hard Concrete ones, on the sampler kernels' own
    outputs and a normal cotangent: each against its plain version
    (TOL_SAMPLER_BWD; the learned column sums within their bound), one
    launch a call, two calls bit for bit, with event ms, device ms
    (profiler), the plain version's ms and the bound. No single PyTorch call
    computes these functions: no library time."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 9)
    rows = stretch_rows(torch, n_simplices, rng)
    out = {}
    for kernel, b, modes in (("binary_gumbel_bwd", TRAIN_B, (True,)), ("hard_concrete_bwd", HC_B, (True, False)),
                             ("hard_concrete_learned_bwd", TRAIN_B, (True, False))):
        results = []
        for training in modes:
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).removeprefix("torch.")
                a = torch.from_numpy(rng.normal(0.5, 2.0, (b, n_simplices)).astype(np.float32)).to(dev, dtype)
                ct = torch.from_numpy(rng.standard_normal((b, n_simplices)).astype(np.float32)).to(dev, dtype)
                if kernel == "binary_gumbel_bwd":
                    x = fused.binary_gumbel_sample(a, TEMPERATURE, seed=SEED)

                    def run(x=x, ct=ct):
                        return (fused.binary_gumbel_bwd(x, ct, TEMPERATURE),)

                    def plain(x=x, ct=ct):
                        return (fused.binary_gumbel_bwd_plain(x, ct, TEMPERATURE),)
                elif kernel == "hard_concrete_bwd":
                    x = hc.hard_concrete_sample(a, HC_BETA, seed=SEED)

                    def run(x=x, ct=ct, training=training):
                        return (hc.hard_concrete_bwd(x, ct, HC_BETA, training),)

                    def plain(x=x, ct=ct, training=training):
                        return (hc.hard_concrete_bwd_plain(x, ct, HC_BETA, training),)
                else:
                    x = hc.hard_concrete_learned_sample(a, *rows, seed=SEED)

                    def run(x=x, ct=ct, training=training):
                        return hc.hard_concrete_learned_bwd(x, ct, *rows, training)

                    def plain(x=x, ct=ct, training=training):
                        return hc.hard_concrete_learned_bwd_plain(x, ct, *rows, training)
                wrapper = getattr(fused if kernel == "binary_gumbel_bwd" else hc, kernel)
                before = wrapper.launches
                got = run()
                torch.cuda.synchronize()
                check(wrapper.launches == before + 1, f"{kernel} {name}: {wrapper.launches - before} launches a call")
                want = plain()
                check(got[0].dtype == dtype and got[0].shape == x.shape, f"{kernel} {name}: shape/dtype")
                scale = want[0].float().abs().max().item()
                err = (got[0].float() - want[0].float()).abs().max().item()
                check(err <= TOL_SAMPLER_BWD[name] * scale,
                      f"{kernel} {name} training={training}: max abs err {err} > {TOL_SAMPLER_BWD[name]} x {scale}")
                sums = {}
                if kernel == "hard_concrete_learned_bwd":
                    _, tb, tg, tz = hc.hard_concrete_learned_terms(x, ct, *rows, training)
                    if training:
                        sums["dbeta"] = col_sum_excess(torch, hc, got[1], want[1], tb)
                    else:
                        check(bool((got[1] == 0).all()), f"{kernel} {name}: dbeta is not 0 in eval")
                    sums["dgamma"] = col_sum_excess(torch, hc, got[2], want[2], tg)
                    sums["dzeta"] = col_sum_excess(torch, hc, got[3], want[3], tz)
                    check(all(e <= 0 for e in sums.values()), f"{kernel} {name}: a column sum over its bound {sums}")
                check(all(torch.equal(g, h) for g, h in zip(got, run())), f"{kernel} {name}: two calls differ")
                bound_ms, bound_by = sampler_bwd_bound(kernel, x.numel(), x.element_size(), ct.element_size(),
                                                       n_simplices if kernel == "hard_concrete_learned_bwd" else 0)
                results.append(dict(
                    dtype=name, training=training, max_abs_err=err, largest=scale, tol=TOL_SAMPLER_BWD[name],
                    col_sum_excess=sums, ms=time_ms(run),
                    device_ms=kernel_ms(torch, run, ("bwd_kernel",), f"{kernel} {name}")["bwd_kernel"],
                    plain_ms=time_ms(plain), library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                ))
        emit("kernel", kernel=kernel, inputs="synthetic", shape=[b, n_simplices], results=results)
        out[kernel] = results[0]
    return out


def phase_sampler_launch(torch, fused, hc, n_simplices: int) -> dict:
    """The launch floor, and each sampler's backward as the train step runs
    it, at its train step's shape, fp32 and bf16: the backward of its
    autograd Function (``torch.autograd.grad`` on a fixed cotangent) by
    events, its launches per call and their summed device ms (profiler).
    The floor is ``time_ms`` of ``torch.cuda._sleep(0)``, one empty launch,
    and its device ms: a yardstick the port never calls. The forward
    kernels' times are in the kernel phases' lines."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 8)
    reps = 20
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    floor_device_ms = sum(per_call_ms(e, reps)
                          for e in device_events(torch, lambda: torch.cuda._sleep(0), "launch floor", reps))
    rows = stretch_rows(torch, n_simplices, rng)
    results = []
    for sampler, b in (("binary_gumbel", TRAIN_B), ("hard_concrete", HC_B), ("hard_concrete_learned", TRAIN_B)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            x = torch.from_numpy(rng.normal(0.5, 2.0, (b, n_simplices)).astype(np.float32)).to(dev, dtype)
            gen = torch.Generator().manual_seed(SEED)
            leaves = [x.detach().clone().requires_grad_(True)]
            if sampler == "binary_gumbel":
                out = fused.binary_gumbel_fused_diff(leaves[0], gen, TEMPERATURE)
            elif sampler == "hard_concrete":
                out = hc.hard_concrete_fused_diff(leaves[0], gen, HC_BETA)
            else:
                leaves += [r.to(dtype).requires_grad_(True) for r in rows]
                out = hc.hard_concrete_fused_learned_diff(leaves[0], gen, *leaves[1:])
            ct = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).to(dev, dtype)

            def bwd(out=out, leaves=leaves, ct=ct):
                return torch.autograd.grad(out, leaves, ct, retain_graph=True)

            events = device_events(torch, bwd, f"{sampler} {name} backward", reps)
            results.append(dict(
                sampler=sampler, dtype=name, shape=[b, n_simplices], bwd_ms=time_ms(bwd),
                bwd_launches=sum(launches_per_call(e, reps) for e in events),
                bwd_device_ms=sum(per_call_ms(e, reps) for e in events),
                bwd_kernels=sorted({e.key[:60] for e in events}),
            ))
    emit("sampler_launch", floor_ms=floor_ms, floor_device_ms=floor_device_ms, results=results)
    return {(r["sampler"], r["dtype"]): r for r in results}


def phase_train_model(torch, port, counters, phase, options, b, g, steps, weights, expect, config=FLAGSHIP,
                      fused=False) -> tuple:
    """A train step of ``config`` with ``options`` at full width, fp32 (with
    ``fused``, every SCCN layer's combine fused): a warm-up step and
    ``steps`` timed ones. The attention forward and backward must launch
    once a step, each kernel of ``expect`` (name: launches a step) as often
    as it says, and no other sampler or combine kernel at all."""
    model = port.AudioAutoencoder.create(**config, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE, **options)
    if fused:
        set_fused_combine(model, True)
    opt = port.make_optimizer(accumulate_grad_batches=1)
    state = port.create_train_state(model, opt)
    step = port.make_train_step(model, opt, weights)
    batches = [torch.from_numpy(make_clips(b * g, SEED + 500 + i).reshape(b, g, 1, NUM_SAMPLES)).to(DEVICE)
               for i in range(steps + 1)]
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("encoder.hc_")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, times, components, launches = timed_steps(torch, step, state, batches, counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n = len(batches)
    for name, per_step in {"masked_attention_fwd": 1, "masked_attention_bwd": 1, **PQMF_PER_STEP, **expect}.items():
        check(launches[name] == per_step * n, f"{phase}: {name} launched {launches[name]} times in {n} steps")
    for name in ("binary_gumbel", "binary_gumbel_bwd", *HC_KERNELS, *COMBINE_KERNELS):
        if name not in expect:
            check(launches[name] == 0, f"{phase}: {name} launched {launches[name]} times")
    params = dict(model.named_parameters())
    for name, old in before.items():
        check(not torch.equal(params[name].detach(), old) and bool(torch.isfinite(params[name]).all()),
              f"{phase}: the stretch leaf {name} did not move or is not finite")
    step_ms = statistics.median(times[1:])
    with torch.no_grad():
        enc = model.encode(batches[0][:, 0], TEMPERATURE, train=True,
                           generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    keys = enc.masks[1:]
    emit(
        phase, config=config, options=options, fused_combine=fused, anchors=b, group=g, samples=NUM_SAMPLES,
        dtype="float32", temperature=TEMPERATURE, l0_penalty=weights.l0_penalty, steps_timed=steps,
        step_ms=times, step_ms_median=step_ms, step_ms_spread=[min(times[1:]), max(times[1:])],
        anchors_per_s=b / (step_ms / 1e3), clips_per_s=b * g / (step_ms / 1e3),
        components=components, launches=launches, launches_per_step={k: v / n for k, v in launches.items()},
        peak_mem_gib=peak_gib, num_params=model.num_params(),
        active_attention_keys_per_clip=float(sum(m.sum() for m in keys)) / b,
        attention_keys_per_clip=sum(int(m.shape[-1]) for m in keys),
        stretch={k: params[k].detach().cpu().tolist() for k in before},
    )
    return model, state, step, batches[0], launches


def phase_encode_hc(torch, port, counters) -> None:
    """BASELINE config 1: the fixed-stretch hard model encodes one clip in
    eval with a generator (the hard path's Bernoulli draws), ENCODE_CALLS
    times; then one 8-clip codec request, whose latent round-trips the
    wire bit-exactly (the eval latent is binary up to the straight-through
    sum's ulp, and the wire carries its 0.5 threshold)."""
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 7, device=DEVICE,
                                         **HC_MODEL)
    x = torch.from_numpy(make_clips(1, SEED + 600)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for c in counters.values():
        c.launches = 0  # just before the encode path
    times = []
    with torch.inference_mode():
        for _ in range(ENCODE_CALLS + 1):  # the first warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = model.encode(x, TEMPERATURE, train=False, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    encode_launches = {name: c.launches for name, c in counters.items()}  # just after
    check(all(n == 0 for n in encode_launches.values()), f"an eval encode launched a kernel: {encode_launches}")
    for r in enc.probs.ranks:
        check(bool(((r - r.round()).abs() <= 1e-6).all()), "hard eval latent not binary to an ulp")
    check(bool(enc.valid.all()), "hard eval encode: no active vertex")

    codec = port.Codec(model, device=DEVICE)
    clips = make_clips(CLIPS, SEED + 601)
    for c in counters.values():
        c.launches = 0  # just before the codec request
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latent = codec.encode(clips)
    wire = port.pack_latent(latent)
    back = port.unpack_latent(wire, FLAGSHIP["num_vertices"])
    y = codec.decode(back, NUM_SAMPLES)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    request_launches = {name: c.launches for name, c in counters.items()}  # just after
    check(request_launches["masked_attention_fwd"] == request_launches["pqmf_synthesis"] == 1
          and sum(request_launches.values()) == 2,
          f"codec request launches {request_launches}")
    check(np.array_equal(port.pack_latent(back), wire), "wire bytes do not round-trip")
    for a, b in zip(latent.ranks, back.ranks):
        check(torch.equal((a.cpu() >= 0.5).float(), b), "latent does not round-trip the wire bit-exactly")
        check(float((a.cpu() - b).abs().max()) <= 1e-6, "hard latent differs from its wire bits by more than an ulp")
    check(tuple(y.shape) == (CLIPS, 1, NUM_SAMPLES) and bool(torch.isfinite(y).all()), "codec waveform")
    emit(
        "encode_hc", config=FLAGSHIP, options=HC_MODEL, clips=1, calls=ENCODE_CALLS, encode_ms=times[1:],
        encode_ms_p50=statistics.median(times[1:]), launches=encode_launches,
        active=[float(r.sum()) for r in enc.probs.ranks],
        request=dict(clips=CLIPS, ms=request_ms, launches=request_launches, wire_bytes_per_clip=int(wire.shape[1]),
                     active=[float(r.sum(dim=-1).mean()) for r in latent.ranks]),
    )




def parity_inputs(torch, cpu, batch, options):
    """The injected uniforms of a parity step: the relaxation's [2, S] and,
    for a hard model, the four per-rank Bernoulli draws, and the weights w
    of the surrogate. For a Hard Concrete, hard or packed model the seed is
    the first (from SEED + 5 up) whose every pre-clip gate, every draw and
    every packed rank's K-th select key clears HC_MARGIN on the CPU: within
    rounding of the clip, a gate is exactly 0 on one side and ~1e-8 on the
    other and flips an attention key; a key within rounding of the K-th
    changes the packed set. Returns (noise, hard_noise, w, margins)."""
    hc = options.get("sampler") == "hard_concrete"
    hard = options.get("hard", False)
    caps = options.get("pack_capacities")
    s_total = cpu.tables.total_simplices
    if hc or hard or caps:
        b, g, _, t = batch.shape
        with torch.no_grad():
            logits = cpu.encoder.compute_logits(cpu.pqmf(batch.reshape(b * g, 1, t)).transpose(-1, -2), True)
        anchors = logits.reshape(b, g, -1)[:, 0]
        biased = anchors.double().clone()
        biased[:, : cpu.tables.num_vertices] += float(cpu.encoder.vertex_bias.detach().relu())
        if options.get("learned_hc"):
            with torch.no_grad():
                stretch = [r.double() for r in cpu.encoder._hc_stretch(torch.float32)]
        else:
            stretch = (TEMPERATURE, -0.1, 1.1)
    for attempt in range(HC_SEED_TRIES):
        rng = np.random.default_rng(SEED + 5 + 1000 * attempt)
        noise = torch.from_numpy(rng.uniform(1e-6, 1 - 1e-6, (2, s_total)).astype(np.float32))
        hard_noise = None
        if hard:
            hard_noise = [torch.from_numpy(rng.uniform(size=(2, n)).astype(np.float32)) for n in cpu.tables.sizes]
        w = torch.from_numpy(rng.standard_normal((2, 1, NUM_SAMPLES)).astype(np.float32))
        margins = {}
        if hc:
            u = noise.double()
            beta, gamma, zeta = stretch
            pre = torch.sigmoid((torch.log(u) - torch.log1p(-u) + biased) / beta) * (zeta - gamma) + gamma
            margins["clip"] = float(torch.minimum(pre.abs(), (pre - 1).abs()).min())
        if hard or caps:
            with torch.no_grad():
                enc = cpu.encoder.generate_complex(anchors, TEMPERATURE, True, noise=noise, hard_noise=hard_noise)
        if hard:
            margins["draw"] = min(float((h.double() - p.double()).abs().min())
                                  for h, p in zip(hard_noise, enc.rectified.ranks))
        if caps:
            margins["select"] = select_margin(enc.rectified, caps)
        if all(m > HC_MARGIN for m in margins.values()):
            margins["seed_attempt"] = attempt
            return noise, hard_noise, w, margins
    raise CheckFailed(f"no parity seed in {HC_SEED_TRIES} clears the mask margin {HC_MARGIN}: {margins}")


def select_margin(rectified, caps) -> float:
    """The smallest gap between the K-th and (K+1)-th select keys (mask +
    rectified probability, in their dtype, as the encoder forms them) of
    any packed rank and anchor of a soft model."""
    gaps = []
    for p, cap in zip(rectified.ranks, caps):
        if cap and cap < p.shape[-1]:
            top = ((p > 0).to(p.dtype) + p).double().sort(dim=-1, descending=True).values
            gaps.append(float((top[:, cap - 1] - top[:, cap]).min()))
    return min(gaps)


def phase_train_parity(torch, port, training, phase="train_parity", options=None, group=TRAIN_G,
                       weights=None, config=FLAGSHIP) -> None:
    """One train step's loss and gradients on the card against the CPU plain
    path: the same weights (dropout off), batch and injected uniforms (the
    relaxation's and, for a hard model, the Bernoulli draws'); and the
    encoder's masks equal bit for bit."""
    options = options or {}
    weights = weights or training.LossWeights()
    gpu = port.AudioAutoencoder.create(**config, num_samples=NUM_SAMPLES, seed=SEED + 2,
                                       device=DEVICE, dropout=0.0, **options)
    cpu = port.AudioAutoencoder.create(**config, num_samples=NUM_SAMPLES, seed=SEED + 3,
                                       device="cpu", dropout=0.0, **options)
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    batch = torch.from_numpy(make_clips(2 * group, SEED + 400).reshape(2, group, 1, NUM_SAMPLES))
    noise, hard_noise, w, margins = parity_inputs(torch, cpu, batch, options)

    def run(model, device):
        hn = None if hard_noise is None else [h.to(device) for h in hard_noise]
        total, comps, grads = training.make_loss_and_grads(model, weights)(
            batch.to(device), TEMPERATURE, SEED, 0, noise.to(device), hn)
        names, params = zip(*model.named_parameters())
        val, enc, _ = surrogate(torch, model, batch.to(device), noise.to(device), w.to(device), hn)
        sgrads = dict(zip(names, torch.autograd.grad(val, params)))
        return (float(total), {k: float(v) for k, v in comps.items()},
                {n: g.cpu().double() for n, g in grads.items()}, val.item(),
                {n: g.detach().cpu().double() for n, g in sgrads.items()}, [m.cpu() for m in enc.masks])

    g_total, g_comps, g_grads, g_val, g_sgrads, g_masks = run(gpu, DEVICE)
    c_total, c_comps, c_grads, c_val, c_sgrads, c_masks = run(cpu, "cpu")
    flips = sum(int((a != b).sum()) for a, b in zip(g_masks, c_masks))
    loss_err = abs(g_total - c_total) / abs(c_total)
    comp_err = {k: abs(g_comps[k] - c_comps[k]) / max(abs(c_comps[k]), 1e-6) for k in c_comps}

    def l2(ts):
        return math.sqrt(sum(float((t ** 2).sum()) for t in ts))

    check(g_grads.keys() == c_grads.keys(), "gradient leaves differ")
    check(all(bool(torch.isfinite(g).all()) for g in g_grads.values()), "non-finite card gradient")
    grad_err = l2(g_grads[n] - c_grads[n] for n in c_grads) / l2(c_grads.values())
    floor = None
    if grad_err > PARITY_GRAD_REL_L2:  # is the real gradient conditioned here?
        nudged = training.make_loss_and_grads(cpu, weights)(
            batch * np.float32(1 + FLOOR_NUDGE), TEMPERATURE, SEED, 0, noise, hard_noise)[2]
        floor = l2(nudged[n].double() - c_grads[n] for n in c_grads) / l2(c_grads.values())
    conditioned = floor is None or floor <= PARITY_GRAD_REL_L2
    scale = max(float(g.abs().max()) for g in c_sgrads.values())
    leaf_err = {n: float((g_sgrads[n] - c_sgrads[n]).abs().max()) / scale for n in c_sgrads}
    worst = max(leaf_err, key=leaf_err.get)
    sur_err = abs(g_val - c_val) / abs(c_val)
    emit(
        phase, config=config, options=options, anchors=2, group=group, leaves=len(c_grads),
        loss_rel_err=loss_err, component_rel_err=comp_err, loss_rtol=PARITY_LOSS_RTOL,
        grad_rel_l2=grad_err, grad_rel_l2_tol=PARITY_GRAD_REL_L2, grad_cpu_floor_rel_l2=floor,
        floor_nudge=FLOOR_NUDGE, grad_conditioned=conditioned,
        surrogate_value_rel_err=sur_err, surrogate_leaf_max_err=leaf_err[worst], surrogate_worst_leaf=worst,
        surrogate_tol=SURROGATE_TOL, grad_scale=scale,
        worst_leaves=sorted(leaf_err.items(), key=lambda kv: -kv[1])[:5],
        mask_bits=sum(int(m.numel()) for m in c_masks), mask_bits_differing=flips,
        active_mask_bits=sum(int(m.sum()) for m in c_masks), margins=margins, margin_required=HC_MARGIN,
    )
    check(flips == 0, f"{phase}: {flips} encoder mask bits differ card vs cpu (margins {margins})")
    check(loss_err <= PARITY_LOSS_RTOL, f"{phase}: train loss card vs cpu: rel {loss_err}")
    check(max(comp_err.values()) <= PARITY_LOSS_RTOL, f"{phase}: loss components card vs cpu: {comp_err}")
    check(grad_err <= PARITY_GRAD_REL_L2 or not conditioned,
          f"{phase}: train gradient card vs cpu: rel L2 {grad_err} (CPU nudge floor {floor})")
    check(leaf_err[worst] <= SURROGATE_TOL, f"{phase}: surrogate gradient leaf {worst}: {leaf_err[worst]}")


def roofline(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """The larger of the bytes over HBM_BPS and the operations over the
    dtype's peak, in ms, and which one it is."""
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def combine_bound(variant: str, m: int, rows: int, elt: int, dtype_name: str,
                  backward: bool = False) -> tuple[float, str]:
    """Least time for one combine variant: the carriers, x (and dy) read
    once, y (or dcar and dx) written once, the weights (and their
    gradients) once; COMBINE_OPS operations per row and message, three
    times as many backward."""
    c = COMBINE_C
    weights = {"copy": 0, "matmul": m * c * c}.get(variant, m * c * c + c * c + 2 * c)
    if backward:
        nbytes = ((2 * m + 3) * rows * c + 2 * weights) * elt
        flops = 3.0 * rows * m * COMBINE_OPS[variant]
    else:
        nbytes = ((m + 2) * rows * c + weights) * elt
        flops = float(rows) * m * COMBINE_OPS[variant]
    return roofline(nbytes, flops, dtype_name)


def combine_inputs(torch, m: int, rows: int, dtype, seed: int):
    """kernel_diag.make_inputs' scales, made on the card from a seed: M
    carriers, x and dy ~ N(0, 1) of [rows, C]; v, w1, b1, w2 ~ 0.1 N(0, 1)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def t(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(dtype)

    c = COMBINE_C
    car = tuple(t((rows, c)) for _ in range(m))
    return car, t((rows, c)), t((m, c, c), 0.1), t((c, c), 0.1), t((c,), 0.1), t((c, 1), 0.1), t((rows, c))


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error over the largest |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


# An instance of csrc/sccn_combine.cu's kernels in a mangled name: the kernel,
# its type and, for the combine kernels, M and the Mode.
COMBINE_INSTANCE = re.compile(r"(combine_fwd_kernel|combine_bwd_kernel|reduce_partials)I(f|13__nv_bfloat16)"
                              r"(?:Li(\d)ELi(\d)E)?")


def combine_instance(mangled: str):
    found = COMBINE_INSTANCE.search(mangled)
    if found is None:
        return None
    kernel, elt, m, mode = found.groups()
    dtype = "float32" if elt == "f" else "bfloat16"
    return f"{kernel}<{dtype}" + (f", M={m}, mode={mode}>" if m else ">")


def sass_census(sass: str) -> dict:
    """Per kernel instance of a cuobjdump -sass listing: its instructions,
    FFMA, 16-byte shared loads (LDS.128), other shared loads, barriers, the
    MUFU.EX2 / MUFU.RCP / MUFU.TANH of its exp, tanhf and divisions, and its
    local-memory stores and loads (STL, LDL: register spills)."""
    census, name = {}, None
    for line in sass.splitlines():
        header = re.search(r"Function : (\S+)", line)
        if header:
            name = combine_instance(header.group(1))
            if name is not None:
                census[name] = dict.fromkeys(("instructions", "ffma", "lds128", "lds_other", "bar", "mufu_ex2",
                                              "mufu_rcp", "mufu_tanh", "stl", "ldl"), 0)
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is None or op is None:
            continue
        op = op.group(1)
        counts = census[name]
        counts["instructions"] += 1
        counts["ffma"] += op.startswith("FFMA")
        counts["lds128"] += op.startswith("LDS") and ".128" in op
        counts["lds_other"] += op.startswith("LDS") and ".128" not in op
        counts["bar"] += op.startswith("BAR")
        counts["mufu_ex2"] += op == "MUFU.EX2"
        counts["mufu_rcp"] += op == "MUFU.RCP"
        counts["mufu_tanh"] += op == "MUFU.TANH"
        counts["stl"] += op.startswith("STL")
        counts["ldl"] += op.startswith("LDL")
    return census


def resource_usage(listing: str, instance=combine_instance) -> dict:
    """Per kernel instance (``instance`` of its mangled name) of a cuobjdump
    -res-usage listing: registers, stack and local-memory bytes per thread."""
    usage, name = {}, None
    for line in listing.splitlines():
        header = re.search(r"Function (\S+?):", line)
        if header:
            name = instance(header.group(1))
            continue
        found = {key: re.search(rf"\b{key}:(\d+)", line) for key in ("REG", "STACK", "LOCAL")}
        if name is not None and all(found.values()):
            usage[name] = dict(registers=int(found["REG"].group(1)), stack_bytes=int(found["STACK"].group(1)),
                               local_bytes=int(found["LOCAL"].group(1)))
            name = None
    return usage


def cuobjdump_listing(name: str, flag: str) -> str:
    """cuobjdump's ``flag`` listing of the library built from csrc/<name>.cu."""
    from topo_audio_autoencoder_torch import cuda_build

    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), flag, str(cuda_build.library_path(name))], capture_output=True,
                          text=True, timeout=120, check=True).stdout


# An instance of csrc/pqmf_synthesis.cu's kernel in a mangled name: its type,
# outputs a thread and direction.
PQMF_INSTANCE = re.compile(r"synthesis_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E")


def pqmf_instance(mangled: str):
    found = PQMF_INSTANCE.search(mangled)
    if found is None:
        return None
    elt, outputs, adjoint = found.groups()
    direction = ("forward", "adjoint")[int(adjoint)]
    return f"synthesis_kernel<{'float32' if elt == 'f' else 'bfloat16'}, R={outputs}, {direction}>"


def phase_combine_build() -> None:
    """csrc/sccn_combine.cu as built, read back from the library with
    cuobjdump, so that a library built by an earlier run is read too: each
    kernel instance's registers, stack and local memory (-res-usage) and
    its SASS census (-sass). Fails if any instance spills: local memory in
    its resource usage, or an STL or LDL in its SASS."""
    usage = resource_usage(cuobjdump_listing("sccn_combine", "-res-usage"))
    census = sass_census(cuobjdump_listing("sccn_combine", "-sass"))
    check(bool(census) and usage.keys() == census.keys(),
          f"cuobjdump: resource usage for {sorted(usage)}, SASS for {sorted(census)}")
    spills = {k: dict(local_bytes=usage[k]["local_bytes"], stl=c["stl"], ldl=c["ldl"])
              for k, c in census.items() if usage[k]["local_bytes"] or c["stl"] or c["ldl"]}
    check(not spills, f"sccn_combine kernels spill: {spills}")
    emit("combine_build", usage=usage, sass=census)


def phase_kernel_combine(torch, sc) -> dict:
    """Rows 6 and 7 against message_combine_reference and autograd through
    it, on the same inputs, at COMBINE_SHAPES in fp32 and bf16. bf16 also
    reports both sides' error against the plain version in fp32 on the
    same bf16 inputs. No single PyTorch call computes this function: no
    library time. Returns the rank-3 fp32 results."""
    results = []
    for m, rows in COMBINE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            car, x, v, w1, b1, w2, dy = combine_inputs(torch, m, rows, dtype, SEED + 7 + m)
            args = (car, x, v, w1, b1, w2)
            y = sc.combine_fwd(*args)
            dcar, *grads = sc.combine_bwd(*args, dy)
            again = sc.combine_fwd(*args)
            again_dcar, *again_grads = sc.combine_bwd(*args, dy)
            torch.cuda.synchronize()
            check(torch.equal(y, again), f"combine fwd M={m} {name}: two calls on the same inputs differ")
            check(all(torch.equal(a, b) for a, b in zip((*dcar, *grads), (*again_dcar, *again_grads))),
                  f"combine bwd M={m} {name}: two calls on the same inputs differ")
            del again, again_dcar, again_grads
            want_y = sc.message_combine_reference(*args)
            want_dcar, *want_grads = sc.combine_bwd_plain(*args, dy)
            fwd_tol, bwd_tol = TOL_COMBINE[name]
            check(y.dtype == dtype and y.shape == x.shape, f"combine fwd {name}: shape/dtype")
            y_err, y_rel = rel_err(y, want_y)
            check(y_rel <= fwd_tol, f"combine fwd M={m} {name}: rel err {y_rel} > {fwd_tol}")
            names = [f"dcar{i}" for i in range(m)] + ["dx", "dv", "dw1", "db1", "dw2"]
            bwd = {}
            for key, g, w in zip(names, (*dcar, *grads), (*want_dcar, *want_grads)):
                check(g.dtype == w.dtype and g.shape == w.shape, f"combine bwd {name}: {key} shape/dtype")
                bwd[key] = rel_err(g, w)
                check(bwd[key][1] <= bwd_tol, f"combine bwd M={m} {name}: {key} rel err {bwd[key][1]} > {bwd_tol}")
            extra = {}
            if dtype == torch.bfloat16:  # which side is nearer the fp32 function of the same inputs
                exact = sc.message_combine_reference(*(t.float() if torch.is_tensor(t) else tuple(c.float() for c in t)
                                                       for t in args))
                extra = dict(kernel_rel_err_vs_fp32_plain=rel_err(y, exact)[1],
                             plain_rel_err_vs_fp32_plain=rel_err(want_y, exact)[1])
            plan = {}
            for key, backward in (("fwd", False), ("bwd", True)):
                blocks = sc.kernel_blocks(rows, m, dtype, backward=backward)
                longest = max(end - start for start, end in sc.combine_row_ranges(rows, blocks))
                plan[key] = dict(blocks=blocks, longest_range_rows=longest)
            per_kernel = combine_kernel_ms(torch, lambda: (sc.combine_fwd(*args), sc.combine_bwd(*args, dy)))
            elt = x.element_size()
            f_bound, f_by = combine_bound("full", m, rows, elt, name)
            b_bound, b_by = combine_bound("full", m, rows, elt, name, backward=True)
            results.append(dict(
                m=m, rows=rows, dtype=name, per_kernel_ms=per_kernel,
                fwd=dict(**plan["fwd"], max_abs_err=y_err, rel_err=y_rel, tol_rel=fwd_tol,
                         ms=time_ms(lambda: sc.combine_fwd(*args)),
                         plain_ms=time_ms(lambda: sc.message_combine_reference(*args)),
                         library_ms=None, bound_ms=f_bound, bound_by=f_by, **extra),
                bwd=dict(**plan["bwd"], max_abs_err=max(e for e, _ in bwd.values()), rel_err={k: r for k, (_, r) in bwd.items()},
                         tol_rel=bwd_tol, ms=time_ms(lambda: sc.combine_bwd(*args, dy)),
                         plain_ms=time_ms(lambda: sc.combine_bwd_plain(*args, dy)),
                         library_ms=None, bound_ms=b_bound, bound_by=b_by),
            ))
            del car, x, v, w1, b1, w2, dy, args, y, dcar, grads, want_y, want_dcar, want_grads
    emit("kernel_combine", kernel="sccn_combine_fwd/bwd", inputs="synthetic", c=COMBINE_C, results=results)
    return results[0]


def phase_combine_diag(torch, sc, cd, counters) -> tuple:
    """kernel_diag on the card. Parity first (its parity(): the packed
    forward against message_combine_reference at 512 rows in fp32, and
    all six cotangents of sum(y^2) through packed_combine against autograd
    through the reference; each ablation against its plain version). Then,
    at the ladder's shape, every variant's kernel against its plain version;
    then, the counters zeroed just before, the timed rungs. Returns the
    per-kernel results and the ladder's launches."""
    f32, bf16 = torch.float32, torch.bfloat16
    car, x, v, w1, b1, w2, _ = combine_inputs(torch, 2, DIAG_PARITY_ROWS, f32, SEED + 20)
    car = torch.stack(car)
    parity = {"fwd": rel_err(cd.packed_combine_fwd(car, x, v, w1, b1, w2),
                             sc.message_combine_reference(tuple(car), x, v, w1, b1, w2))[1]}
    check(parity["fwd"] <= TOL_DIAG_PARITY[0], f"packed fwd parity {parity['fwd']}")
    leaves = [t.clone().requires_grad_(True) for t in (car, x, v, w1, b1, w2)]
    got = torch.autograd.grad((cd.packed_combine(*leaves) ** 2).sum(), leaves)
    ref = [t.clone().requires_grad_(True) for t in (car, x, v, w1, b1, w2)]
    want = torch.autograd.grad((sc.message_combine_reference(tuple(ref[0]), *ref[1:]) ** 2).sum(), ref)
    for key, g, w in zip(("dcar", "dx", "dv", "dw1", "db1", "dw2"), got, want):
        parity[key] = rel_err(g, w)[1]
        check(parity[key] <= TOL_DIAG_PARITY[1], f"packed grad parity {key}: {parity[key]}")
    ablations = {
        "copy": (cd.combine_copy, cd.combine_copy_plain, (car, x)),
        "matmul": (cd.combine_matmul, cd.combine_matmul_plain, (car, x, v)),
        "nogelu": (cd.combine_nogelu, cd.combine_nogelu_plain, (car, x, v, w1, b1, w2)),
    }
    for key, (kernel, plain, args) in ablations.items():
        parity[key] = rel_err(kernel(*args), plain(*args))[1]
        check(parity[key] <= TOL_COMBINE["float32"][0], f"{key} fp32 parity {parity[key]}")

    rows = DIAG_ROWS
    car, x, v, w1, b1, w2, dy = combine_inputs(torch, 2, rows, bf16, SEED + 21)
    car = torch.stack(car)
    full = (car, x, v, w1, b1, w2)
    variants = {  # name: (kernel, plain, args, kernel counter, bound variant, backward)
        "copy": (cd.combine_copy, cd.combine_copy_plain, (car, x), "sccn_combine_copy", "copy", False),
        "matmul": (cd.combine_matmul, cd.combine_matmul_plain, (car, x, v), "sccn_combine_matmul", "matmul", False),
        "nogelu": (cd.combine_nogelu, cd.combine_nogelu_plain, full, "sccn_combine_nogelu", "nogelu", False),
        "packed": (cd.packed_combine_fwd, cd.packed_combine_plain, full, "sccn_combine_packed_fwd", "full", False),
        "packed_bwd": (cd.packed_combine_bwd, cd.packed_combine_bwd_plain, (*full, dy), "sccn_combine_packed_bwd",
                       "full", True),
    }
    errs = {}
    for key, (kernel, plain, args, _, _, backward) in variants.items():
        got, want = kernel(*args), plain(*args)
        pairs = zip(got, want) if backward else [(got, want)]
        errs[key] = max((rel_err(g, w) for g, w in pairs), key=lambda e: e[1])
        tol = TOL_COMBINE["bfloat16"][1 if backward else 0]
        check(errs[key][1] <= tol, f"{key} bf16 at the ladder's shape: rel err {errs[key][1]} > {tol}")
        del got, want
    torch.cuda.synchronize()

    def grad_of(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in full]

        def run():
            return torch.autograd.grad(fn(*leaves).float().sum(), leaves)
        return run

    for c in counters.values():
        c.launches = 0  # just before the ladder
    forward = {}
    for key in ("copy", "matmul", "nogelu"):
        kernel, _, args, _, variant, _ = variants[key]
        forward[key] = dict(ms=time_ms(lambda: kernel(*args)),
                            bound_ms=combine_bound(variant, 2, rows, 2, "bfloat16")[0])
    forward["full"] = dict(ms=time_ms(lambda: sc.combine_fwd(tuple(car), x, v, w1, b1, w2)),
                           bound_ms=combine_bound("full", 2, rows, 2, "bfloat16")[0])
    forward["packed"] = dict(ms=time_ms(lambda: cd.packed_combine_fwd(*full)), bound_ms=forward["full"]["bound_ms"])
    forward["plain"] = dict(ms=time_ms(lambda: sc.message_combine_reference(tuple(car), x, v, w1, b1, w2)))
    grad = {
        "packed": dict(ms=time_ms(grad_of(cd.packed_combine), reps=10, warmup=2)),
        "full": dict(ms=time_ms(grad_of(lambda c, *a: sc.fused_message_combine(tuple(c), *a)), reps=10, warmup=2)),
        "plain": dict(ms=time_ms(grad_of(lambda c, *a: sc.message_combine_reference(tuple(c), *a)), reps=10,
                                 warmup=2)),
    }
    packed_bwd_ms = time_ms(lambda: cd.packed_combine_bwd(*full, dy), reps=10, warmup=2)
    launches = {name: counters[name].launches for name in COMBINE_KERNELS}  # just after the ladder
    check(all(launches[name] > 0 for name in COMBINE_KERNELS[2:]), f"a diagnostic kernel never launched: {launches}")

    per_kernel = {}
    for key, (_, plain, args, counter, variant, backward) in variants.items():
        bound_ms, bound_by = combine_bound(variant, 2, rows, 2, "bfloat16", backward)
        per_kernel[counter] = dict(
            max_abs_err=errs[key][0], rel_err=errs[key][1],
            ms=packed_bwd_ms if backward else forward[key]["ms"],
            plain_ms=time_ms(lambda: plain(*args), reps=10, warmup=2),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )
    emit("combine_diag", rows=rows, m=2, c=COMBINE_C, dtype="bfloat16",
         carrier_bytes=car.numel() * car.element_size(), parity_rows=DIAG_PARITY_ROWS,
         parity_rel_err=parity, parity_tol=TOL_DIAG_PARITY, forward=forward, grad=grad,
         kernels=per_kernel, launches=launches)
    return per_kernel, launches


def set_fused_combine(model, on: bool) -> None:
    """Switch every SCCN layer of a built model: the counterpart of
    constructing GradientSCCNLayer(fused_combine=True)."""
    from topo_audio_autoencoder_torch.models.sccn import GradientSCCNLayer

    layers = [m for m in model.modules() if isinstance(m, GradientSCCNLayer)]
    check(len(layers) == FLAGSHIP["n_sccn_layers"], f"found {len(layers)} SCCN layers")
    for layer in layers:
        layer.fused_combine = on


def fused_step_parity(torch, training, counters, model, batch, rank_layers, phase, packed=False) -> dict:
    """One step fused against unfused on one card: ``model``, ``batch`` and
    injected uniforms shared; the loss, its components, the gradient and
    every leaf of the surrogate within train_parity's bounds. Fused, rows 6
    and 7 launch ``rank_layers`` times in each pass (the step's forward and
    backward, the surrogate's forward and backward); unfused, never.

    ``packed``: the packed step's whole gradient is not stable at fp32 (a
    1e-6 nudge of the batch moves it by 1e-2 to 1, PERF.md §6), so there
    cuDNN runs its deterministic algorithms, a second surrogate whose w is
    the real loss's gradient at the unfused reconstruction
    (``step_cotangent``; the real gradient on every decoder leaf) is held
    leaf by leaf at SURROGATE_TOL and as a whole at PARITY_GRAD_REL_L2, and
    the whole gradient within PARITY_GRAD_REL_L2 only where it is conditioned
    (train_parity's rule: unless the unfused gradient moves by more than
    PARITY_GRAD_REL_L2 under the nudge). It also reads the unfused
    gradient's repeatability over two runs, with cuDNN deterministic and
    with its default algorithms. Returns the errors and readings."""
    rng = np.random.default_rng(SEED + 8)
    b = batch.shape[0]
    noise = torch.from_numpy(rng.uniform(1e-6, 1 - 1e-6, (b, model.tables.total_simplices))
                             .astype(np.float32)).to(DEVICE)
    w = torch.from_numpy(rng.standard_normal((b, 1, NUM_SAMPLES)).astype(np.float32)).to(DEVICE)
    names, params = zip(*model.named_parameters())
    loss_and_grads = training.make_loss_and_grads(model)

    def l2(ts):
        return math.sqrt(sum(float((t ** 2).sum()) for t in ts))

    def rel(a, ref):
        return l2(a[k] - ref[k] for k in ref) / l2(ref.values())

    def unfused_grads(scale=1.0):
        set_fused_combine(model, False)
        grads = loss_and_grads(batch * np.float32(scale), TEMPERATURE, SEED, 0, noise)[2]
        return {k: g.double() for k, g in grads.items()}

    def leaf_errs(got, want):
        scale = max(float(g.abs().max()) for g in want.values())
        errs = {k: float((got[k] - want[k]).abs().max()) / scale for k in want}
        worst = max(errs, key=errs.get)
        return worst, errs[worst]

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    if packed:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        ws = {"surrogate": w}
        if packed:
            set_fused_combine(model, False)
            ws["cotangent"] = step_cotangent(torch, model, batch, noise, training.LossWeights())
        runs = {}
        for fused in (True, False):
            set_fused_combine(model, fused)
            for c in counters.values():
                c.launches = 0
            total, comps, grads = loss_and_grads(batch, TEMPERATURE, SEED, 0, noise)
            sgrads = {}
            for name, wt in ws.items():
                val, _, _ = surrogate(torch, model, batch, noise, wt)
                sgrads[name] = dict(zip(names, (g.double() for g in torch.autograd.grad(val, params))))
            torch.cuda.synchronize()
            runs[fused] = dict(total=float(total), comps={k: float(v) for k, v in comps.items()},
                               grads={k: g.double() for k, g in grads.items()}, sgrads=sgrads,
                               launches=counters["sccn_combine_fwd"].launches + counters["sccn_combine_bwd"].launches)
        f, u = runs[True], runs[False]
        grad_err = rel(f["grads"], u["grads"])
        readings = {}
        floor = None
        if packed:
            readings["repeat_rel_l2_cudnn_deterministic"] = rel(unfused_grads(), u["grads"])
            floor = rel(unfused_grads(1 + FLOOR_NUDGE), u["grads"])
            cudnn.deterministic, cudnn.benchmark = saved
            first = unfused_grads()
            readings["repeat_rel_l2_cudnn_default"] = rel(unfused_grads(), first)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        set_fused_combine(model, False)
    check(f["launches"] == 2 * (1 + len(ws)) * rank_layers and u["launches"] == 0,
          f"{phase}: fused/unfused parity launches {f['launches']}, {u['launches']}")
    loss_err = abs(f["total"] - u["total"]) / abs(u["total"])
    comp_err = {k: abs(f["comps"][k] - u["comps"][k]) / max(abs(u["comps"][k]), 1e-6) for k in u["comps"]}
    leaf = {name: leaf_errs(f["sgrads"][name], u["sgrads"][name]) for name in ws}
    check(loss_err <= PARITY_LOSS_RTOL and max(comp_err.values()) <= PARITY_LOSS_RTOL,
          f"{phase} parity: loss {loss_err}, components {comp_err}")
    if packed:
        readings.update(grad_floor_rel_l2=floor, floor_nudge=FLOOR_NUDGE,
                        grad_conditioned=floor <= PARITY_GRAD_REL_L2, cudnn_deterministic=True,
                        cotangent_leaf_max_err=leaf["cotangent"][1], cotangent_worst_leaf=leaf["cotangent"][0],
                        cotangent_grad_rel_l2=rel(f["sgrads"]["cotangent"], u["sgrads"]["cotangent"]))
        check(grad_err <= PARITY_GRAD_REL_L2 or floor > PARITY_GRAD_REL_L2,
              f"{phase} parity: gradient rel L2 {grad_err} (nudge floor {floor})")
        check(readings["cotangent_grad_rel_l2"] <= PARITY_GRAD_REL_L2,
              f"{phase} parity: cotangent gradient rel L2 {readings['cotangent_grad_rel_l2']}")
    else:
        check(grad_err <= PARITY_GRAD_REL_L2, f"{phase} parity: gradient rel L2 {grad_err}")
    for name, (worst, err) in leaf.items():
        check(err <= SURROGATE_TOL, f"{phase} parity: {name} leaf {worst}: {err}")
    return dict(
        leaves=len(u["grads"]), loss_rel_err=loss_err, component_rel_err=comp_err, loss_rtol=PARITY_LOSS_RTOL,
        grad_rel_l2=grad_err, grad_rel_l2_tol=PARITY_GRAD_REL_L2, surrogate_leaf_max_err=leaf["surrogate"][1],
        surrogate_worst_leaf=leaf["surrogate"][0], surrogate_tol=SURROGATE_TOL, parity_launches=f["launches"],
        **readings,
    )


def phase_train_fused(torch, port, training, counters) -> dict:
    """The flagship Gumbel step with fused_combine on every layer: a warm-up
    and TRAIN_FUSED_STEPS timed steps on the train phase's batches, one
    profiled step; one step fused against unfused on the same card,
    weights, batch and injected uniforms (loss, gradient, surrogate
    leaves, train_parity's bounds); one 8-clip decode fused against
    unfused on one latent. Returns the timed steps' launches."""
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    set_fused_combine(model, True)
    opt = port.make_optimizer(accumulate_grad_batches=1)
    state = port.create_train_state(model, opt)
    step = port.make_train_step(model, opt)
    batches = [torch.from_numpy(train_batch(SEED + 300 + i, TRAIN_B)).to(DEVICE)
               for i in range(TRAIN_FUSED_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, times, components, launches = timed_steps(torch, step, state, batches, counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n = len(batches)
    for name in ("sccn_combine_fwd", "sccn_combine_bwd"):
        check(launches[name] == FUSED_RANK_LAYERS * n, f"train_fused: {name} launched {launches[name]} in {n} steps")
    for name in ("binary_gumbel", "binary_gumbel_bwd", "masked_attention_fwd", "masked_attention_bwd", *PQMF_KERNELS):
        check(launches[name] == n, f"train_fused: {name} launched {launches[name]} in {n} steps")
    for name in (*HC_KERNELS, *COMBINE_KERNELS[2:]):
        check(launches[name] == 0, f"train_fused: {name} launched {launches[name]} times")
    step_ms = statistics.median(times[1:])
    emit(
        "train_fused", config=FLAGSHIP, fused_combine=True, anchors=TRAIN_B, group=TRAIN_G, samples=NUM_SAMPLES,
        dtype="float32", steps_timed=TRAIN_FUSED_STEPS, step_ms=times, step_ms_median=step_ms,
        anchors_per_s=TRAIN_B / (step_ms / 1e3), components=components, launches=launches,
        launches_per_step={k: v / n for k, v in launches.items()}, peak_mem_gib=peak_gib,
    )
    phase_train_trace(torch, state, step, batches[0],
                      what="one flagship train step with fused_combine (fp32, B=16, G=3)")
    del model, state, step, opt
    torch.cuda.empty_cache()

    # Fused against unfused: one model (dropout off), the same batch and uniforms.
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 2, device=DEVICE,
                                         dropout=0.0)
    parity = fused_step_parity(torch, training, counters, model, batches[0], FUSED_RANK_LAYERS, "train_fused")

    # One 8-clip decode, fused against unfused, on one shared latent.
    codec = port.Codec(model, device=DEVICE)
    latent = codec.encode(make_clips(CLIPS, SEED + 700))
    waves = {}
    decode_launches = {}
    for fused in (True, False):
        set_fused_combine(model, fused)
        for c in counters.values():
            c.launches = 0
        waves[fused] = codec.decode(latent, NUM_SAMPLES)
        torch.cuda.synchronize()
        decode_launches[fused] = {k: counters[k].launches for k in ("sccn_combine_fwd", "sccn_combine_bwd")}
    check(decode_launches[True] == {"sccn_combine_fwd": FUSED_RANK_LAYERS, "sccn_combine_bwd": 0}
          and decode_launches[False] == {"sccn_combine_fwd": 0, "sccn_combine_bwd": 0},
          f"decode launches {decode_launches}")
    check(bool(torch.isfinite(waves[True]).all()), "fused decode: non-finite waveform")
    wave_err = (waves[True] - waves[False]).abs().max().item()
    check(wave_err <= DECODE_FUSED_TOL, f"fused decode vs unfused: {wave_err} > {DECODE_FUSED_TOL}")
    emit(
        "train_fused_parity", anchors=TRAIN_B, group=TRAIN_G, **parity,
        decode_clips=CLIPS, decode_max_abs_err=wave_err, decode_tol=DECODE_FUSED_TOL,
        decode_wave_max_abs=waves[False].abs().max().item(), decode_launches=decode_launches,
    )
    return launches


def packed_memberships() -> list:
    """The dense memberships built so far for the n=32 complex, as (rank,
    device): the packed path may build v2e (rank 1) only."""
    from topo_audio_autoencoder_torch.topology.builder import built_memberships

    built = built_memberships(PACKED["num_vertices"])
    check(all(rank == 1 for rank, _ in built), f"the packed path built a dense packed-rank membership: {built}")
    return built


def phase_train_packed(torch, port, attention, training, counters) -> None:
    """The n=32 packed model's train step (fp32, B=16 x G=3): a warm-up and
    PACKED_STEPS timed steps, rows 1, 2, 3 and 3's backward once a step; rows
    1 and 2 on this step's attention inputs (1,264 keys); one profiled step;
    the dense memberships it built."""
    model, state, step, batch, _ = phase_train_model(
        torch, port, counters, "train_packed", PACKED_OPTIONS, TRAIN_B, TRAIN_G, PACKED_STEPS,
        training.LossWeights(), GUMBEL_EXPECT, config=PACKED)
    fwd, _ = phase_train_kernels(torch, attention, model, state, step, batch, inputs="packed train step (n=32)")
    check(fwd["keys"] == TRAIN_B * PACKED_KEYS, f"train_packed: {fwd['keys']} attention keys")
    phase_train_trace(torch, state, step, batch, what="one n=32 packed train step (fp32, B=16, G=3)")
    emit("packed_memberships", after="train_packed", built=packed_memberships())


def phase_train_packed_fused(torch, port, training, counters) -> None:
    """The packed step with fused_combine on every layer: ranks 1-3 of each
    of the 6 layers clear MIN_FUSED_ROWS, so rows 6 and 7 launch 18 times a
    step; then one step fused against unfused on a fresh model and the
    first batch (fused_step_parity's packed rule)."""
    per_step = {**GUMBEL_EXPECT, "sccn_combine_fwd": PACKED_FUSED_RANK_LAYERS,
                "sccn_combine_bwd": PACKED_FUSED_RANK_LAYERS}
    model, _, _, batch, _ = phase_train_model(
        torch, port, counters, "train_packed_fused", PACKED_OPTIONS, TRAIN_B, TRAIN_G, PACKED_STEPS,
        training.LossWeights(), per_step, config=PACKED, fused=True)
    del model
    torch.cuda.empty_cache()
    # Fused against unfused, as train_fused: a fresh model (dropout off).
    model = port.AudioAutoencoder.create(**PACKED, **PACKED_OPTIONS, num_samples=NUM_SAMPLES, seed=SEED + 2,
                                         device=DEVICE, dropout=0.0)
    parity = fused_step_parity(torch, training, counters, model, batch, PACKED_FUSED_RANK_LAYERS,
                               "train_packed_fused", packed=True)
    emit("train_packed_fused_parity", anchors=TRAIN_B, group=TRAIN_G, **parity)


def phase_serve_packed(torch, port, counters) -> None:
    """The n=32 packed codec: a warm-up request and REQUESTS timed ones of 8
    clips, encode -> pack_latent (5,181 bytes a clip) -> unpack_latent ->
    decode. The latent round-trips the wire bit for bit; every active
    triangle and tetrahedron fits its capacity (packing is exact, whatever
    the order of equal keys); row 1 launches once a decode and nothing else
    launches; the last decode's waveform on the card against the CPU plain
    path's on the same latent and weights."""
    model = port.AudioAutoencoder.create(**PACKED, **PACKED_OPTIONS, num_samples=NUM_SAMPLES, seed=SEED,
                                         device=DEVICE)
    with torch.no_grad():
        model.encoder.mlp2.bias += LOGIT_SHIFT
    codec = port.Codec(model, device=DEVICE)
    caps = PACKED_OPTIONS["pack_capacities"]
    for c in counters.values():
        c.launches = 0  # just before the serve path
    timed = []
    for i in range(REQUESTS + 1):  # request 0 warms up
        x = make_clips(CLIPS, SEED + 800 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latent = codec.encode(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wire = port.pack_latent(latent)
        back = port.unpack_latent(wire, PACKED["num_vertices"])
        t2 = time.perf_counter()
        y = codec.decode(back, NUM_SAMPLES)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        check(wire.shape == (CLIPS, PACKED_WIRE_BYTES), f"serve_packed: wire shape {wire.shape}")
        for a, b in zip(latent.ranks, back.ranks):
            check(torch.equal(a.cpu(), b), "serve_packed: latent does not round-trip bit-exactly")
        active = [int(r.sum(dim=-1).max()) for r in latent.ranks]
        check(all(not cap or a <= cap for a, cap in zip(active, caps)),
              f"serve_packed: active rows {active} over the capacities {caps}")
        check(tuple(y.shape) == (CLIPS, 1, NUM_SAMPLES) and bool(torch.isfinite(y).all()), "serve_packed: waveform")
        if i > 0:
            timed.append(dict(encode_ms=(t1 - t0) * 1e3, pack_unpack_ms=(t2 - t1) * 1e3,
                              decode_ms=(t3 - t2) * 1e3, active_max=active,
                              active_mean=[float(r.sum(dim=-1).mean()) for r in latent.ranks]))
    counts = {name: c.launches for name, c in counters.items()}  # just after the serve path
    check(counts["masked_attention_fwd"] == counts["pqmf_synthesis"] == REQUESTS + 1
          and sum(counts.values()) == 2 * (REQUESTS + 1),
          f"serve_packed: launches {counts} for {REQUESTS + 1} decodes")
    cpu = port.AudioAutoencoder.create(**PACKED, **PACKED_OPTIONS, num_samples=NUM_SAMPLES, seed=SEED + 1,
                                       device="cpu")
    cpu_codec = port.Codec(cpu, {k: t.cpu() for k, t in model.state_dict().items()}, device="cpu")
    wave_cpu = cpu_codec.decode(back, NUM_SAMPLES)
    wave_err = (y.cpu() - wave_cpu).abs().max().item()
    check(wave_err <= WAVE_TOL, f"serve_packed: decode card vs cpu {wave_err} > {WAVE_TOL}")
    enc = statistics.median(t["encode_ms"] for t in timed)
    dec = statistics.median(t["decode_ms"] for t in timed)
    emit(
        "serve_packed", config=PACKED, options=PACKED_OPTIONS, clips=CLIPS, samples=NUM_SAMPLES, requests=timed,
        encode_ms=enc, decode_ms=dec, clips_per_s=CLIPS / ((enc + dec) / 1e3),
        wire_bytes_per_clip=int(wire.shape[1]), attention_keys=PACKED_KEYS, launches=counts,
        decode_max_abs_err=wave_err, wave_tol=WAVE_TOL, wave_max_abs=wave_cpu.abs().max().item(),
        num_params=model.num_params(), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )


def phase_baseline2(torch, port, counters) -> None:
    """BASELINE config 2: the flagship width with max_rank=1, batch 8, the
    eval forward plus autoencoder_loss, BASELINE2_CALLS timed calls after a
    warm-up; row 1 once a call over 190 keys, nothing else. The card's
    latent, loss and waveform against the CPU plain path's (same weights and
    clips); latent bits may differ only where a logit lies within LOGIT_TOL
    of the threshold, and then the waveform is compared on one shared
    latent."""
    from topo_audio_autoencoder_torch.training.losses import autoencoder_loss

    model = port.AudioAutoencoder.create(**FLAGSHIP, **BASELINE2_OPTIONS, num_samples=NUM_SAMPLES, seed=SEED,
                                         device=DEVICE)
    cpu = port.AudioAutoencoder.create(**FLAGSHIP, **BASELINE2_OPTIONS, num_samples=NUM_SAMPLES, seed=SEED + 1,
                                       device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    x = torch.from_numpy(make_clips(CLIPS, SEED + 900))
    xg = x.to(DEVICE)

    def forward(m, xx):
        with torch.inference_mode():
            out = m(xx, TEMPERATURE, train=False)
            total, _ = autoencoder_loss(out.waveform, xx, out.aux, out.valid)
        return out, total

    for c in counters.values():
        c.launches = 0  # just before the main path
    times = []
    for _ in range(BASELINE2_CALLS + 1):  # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, total = forward(model, xg)
        loss = float(total)
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {name: c.launches for name, c in counters.items()}  # just after
    check(counts["masked_attention_fwd"] == counts["pqmf_synthesis"] == BASELINE2_CALLS + 1
          and sum(counts.values()) == 2 * (BASELINE2_CALLS + 1),
          f"baseline2: launches {counts}")
    keys = sum(int(m.shape[-1]) for m in out.encoder_output.masks[1:])
    check(keys == BASELINE2_KEYS and model.tables.sizes == (20, 190, 0, 0), f"baseline2: {keys} attention keys")
    check(math.isfinite(loss) and bool(torch.isfinite(out.waveform).all()), "baseline2: non-finite output")
    cpu_out, cpu_total = forward(cpu, x)
    logits = cpu_out.encoder_output.logits.numpy()
    logit_err = float(np.abs(out.encoder_output.logits.cpu().numpy() - logits).max())
    check(logit_err <= LOGIT_TOL, f"baseline2: logits card vs cpu {logit_err}")
    flips = sum(int((a.cpu() != b).sum()) for a, b in zip(out.encoder_output.probs.ranks, cpu_out.encoder_output.probs.ranks))
    if flips == 0:
        loss_err = abs(loss - float(cpu_total)) / abs(float(cpu_total))
        wave_err = (out.waveform.cpu() - cpu_out.waveform).abs().max().item()
        check(loss_err <= PARITY_LOSS_RTOL, f"baseline2: loss card vs cpu rel {loss_err}")
    else:  # a flip is allowed only at the threshold; hold the decoder on the CPU's latent
        bias = np.zeros_like(logits)
        bias[:, : FLAGSHIP["num_vertices"]] = float(model.encoder.vertex_bias.detach().relu())
        near = np.abs(logits + bias - 0.5) <= LOGIT_TOL
        flipped = (out.encoder_output.logits.cpu().numpy() + bias > 0.5) != (logits + bias > 0.5)
        check(not (flipped & ~near).any(), "baseline2: latent bits flip away from the threshold")
        loss_err = None
        with torch.inference_mode():
            latent = cpu_out.encoder_output.probs
            wave_err = (model.decode_from_probs(type(latent)(*(r.to(DEVICE) for r in latent.ranks)),
                                                NUM_SAMPLES // FLAGSHIP["num_bands"]).cpu()
                        - cpu.decode_from_probs(latent, NUM_SAMPLES // FLAGSHIP["num_bands"])).abs().max().item()
    check(wave_err <= WAVE_TOL, f"baseline2: waveform card vs cpu {wave_err} > {WAVE_TOL}")
    p50 = statistics.median(times[1:])
    emit(
        "baseline2", config=FLAGSHIP, options=BASELINE2_OPTIONS, clips=CLIPS, calls=BASELINE2_CALLS,
        forward_loss_ms=times[1:], p50_ms=p50, clips_per_s=CLIPS / (p50 / 1e3), loss=loss, attention_keys=keys,
        active=[float(r.sum(dim=-1).mean()) for r in out.encoder_output.probs.ranks], launches=counts,
        logit_max_abs_err=logit_err, bits_flipped=flips, loss_rel_err=loss_err, loss_rtol=PARITY_LOSS_RTOL,
        wave_max_abs_err=wave_err, wave_tol=WAVE_TOL, num_params=model.num_params(),
    )


def data_wavs(d: Path, corpus: np.ndarray) -> list:
    """Six WAVs for preprocess_split: four 16 kHz mono clips of the corpus,
    one 32 kHz tone (440 + 1320 Hz) and one 16 kHz stereo pair, int16."""
    from scipy.io import wavfile
    from topo_audio_autoencoder_torch import data

    paths = []
    for i in range(4):
        paths.append(d / f"mono16k_{i}.wav")
        data.save_wav(paths[-1], corpus[i], 16000)
    t = np.arange(2 * NUM_SAMPLES) / 32000.0
    paths.append(d / "tone32k.wav")
    data.save_wav(paths[-1], 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1320 * t + 1.0), 32000)
    paths.append(d / "stereo16k.wav")
    wavfile.write(paths[-1], 16000, (np.stack([corpus[4], -0.5 * corpus[5]], 1) * 32767).astype(np.int16))
    return paths


def phase_data_wav(torch, data, native_loader, corpus, d: Path) -> None:
    """WAVs through preprocess_split and load_split: every file decoded by
    the native parser (the packed row equals load_wav_native's, bit for
    bit), the result against scipy's load_wav within the stated bounds."""
    paths = data_wavs(d, corpus)
    t0 = time.perf_counter()
    packed = data.preprocess_split(paths, d / "out", "wav", 16000, NUM_SAMPLES)
    preprocess_s = time.perf_counter() - t0
    loaded = data.load_split(d / "out", "wav")
    check(isinstance(loaded, np.memmap) and np.array_equal(loaded, packed), "load_split differs from the packed array")
    manifest = json.loads((d / "out" / "wav_manifest.json").read_text())
    check(manifest == [p.stem for p in paths], f"manifest {manifest}")
    errs = {}
    for row, p in zip(packed, paths):
        native = native_loader.load_wav_native(p, NUM_SAMPLES, 16000)
        check(native is not None, f"the native parser refused {p.name}")
        check(np.array_equal(row[: len(native)], native) and not row[len(native):].any(),
              f"{p.name}: the packed row is not the native decode")
        ref = data.load_wav(p)[:NUM_SAMPLES]
        check(len(ref) == len(native), f"{p.name}: {len(native)} native samples against scipy's {len(ref)}")
        if p.name.startswith("tone32k"):
            err = float(np.abs(native - ref)[WAV_EDGE:-WAV_EDGE].max())
            check(err <= TOL_WAV_RESAMPLED, f"{p.name}: resampled {err} from scipy's")
        else:
            err = float(np.abs(native - ref).max())
            check(err <= TOL_WAV_DECODE, f"{p.name}: decoded {err} from scipy's")
        errs[p.name] = err
    quant = float(np.abs(packed[:4] - corpus[:4]).max())
    check(quant <= TOL_WAV_QUANT, f"16 kHz clips {quant} from the float clips written")
    emit("data_wav", files=[p.name for p in paths], native_decoded=len(paths), preprocess_s=preprocess_s,
         max_abs_err_vs_scipy=errs, tol_decode=TOL_WAV_DECODE, tol_resampled=TOL_WAV_RESAMPLED,
         resampled_edge_excluded=WAV_EDGE, quantization_err=quant, tol_quant=TOL_WAV_QUANT)


def phase_data_precompute(torch, data, stft, train: np.ndarray, d: Path) -> dict:
    """compute_distances on the card over the corpus: wall time, pairs/s,
    peak memory; entries against spectral_distance on the card, a block
    against the CPU, the diagonal, the mirror and every neighbor row."""
    n = len(train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dists = data.compute_distances(train, save_path=d / "distances.npz", tile=DATA_TILE)
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    mat, nb = dists["distances"], dists["neighbors"]
    pairs = n * (n - 1) // 2
    tiles = -(-n // DATA_TILE)
    check(mat.shape == (n, n) and bool(np.isfinite(mat).all()), f"distance matrix {mat.shape}, not finite")
    check(bool((np.diag(mat) == 0).all()), "the diagonal is not zero")
    check(np.array_equal(mat, mat.T), "the matrix is not symmetric")
    expect = np.broadcast_to(np.arange(n), (n, n))[~np.eye(n, dtype=bool)].reshape(n, n - 1)
    check(nb.shape == (n, n - 1) and np.array_equal(np.sort(nb, axis=1), expect),
          "a neighbor row is not a permutation of the other rows")
    t0 = time.perf_counter()
    check(np.array_equal(data.sort_neighbors(mat), nb), "neighbors differ from sort_neighbors(distances)")
    sort_s = time.perf_counter() - t0
    loaded = data.load_distances(d / "distances.npz")
    check(all(np.array_equal(loaded[k], dists[k]) for k in dists), "the .npz does not load back")

    tile_pair = [torch.from_numpy(train[k * DATA_TILE:(k + 1) * DATA_TILE]).to(DEVICE) for k in (0, 1)]
    with torch.no_grad():
        trace_call(torch, lambda: stft.spectral_distance_matrix_block(*tile_pair),
                   f"one {DATA_TILE} x {DATA_TILE} tile pair of the precompute (five scales)")
    rng = np.random.default_rng(SEED + 12)
    i = rng.integers(0, n, DATA_PAIRS_CHECKED)
    j = (i + rng.integers(1, n, DATA_PAIRS_CHECKED)) % n
    i, j = np.minimum(i, j), np.maximum(i, j)  # d(i, j) with i < j is the reference for both entries
    with torch.no_grad():
        direct = stft.spectral_distance(torch.from_numpy(train[i]).to(DEVICE),
                                        torch.from_numpy(train[j]).to(DEVICE)).cpu().numpy()
        block_cpu = stft.spectral_distance_matrix_block(
            torch.from_numpy(train[:DATA_BLOCK]), torch.from_numpy(train[DATA_BLOCK:2 * DATA_BLOCK])).numpy()
    rtol, atol = TOL_DIST
    got = mat[i, j]
    entry_err = float(np.abs(got - direct).max())
    check(bool(np.all(np.abs(got - direct) <= atol + rtol * np.abs(direct))),
          f"entries against spectral_distance: max abs err {entry_err}")
    block = mat[:DATA_BLOCK, DATA_BLOCK:2 * DATA_BLOCK]
    block_err = float(np.abs(block - block_cpu).max())
    check(bool(np.all(np.abs(block - block_cpu) <= atol + rtol * np.abs(block_cpu))),
          f"a {DATA_BLOCK}-clip block against the CPU: max abs err {block_err}")
    emit("data_precompute", clips=n, samples=train.shape[1], tile=DATA_TILE,
         tile_pairs=tiles * (tiles + 1) // 2, pairs=pairs, wall_s=wall_s, pairs_per_s=pairs / wall_s,
         peak_mem_gib=peak_gib, sort_s=sort_s, entries_checked=DATA_PAIRS_CHECKED,
         entry_max_abs_err=entry_err, entry_max_rel_err=float((np.abs(got - direct) / np.abs(direct)).max()),
         block=DATA_BLOCK, block_max_abs_err=block_err,
         block_max_rel_err=float((np.abs(block - block_cpu) / np.abs(block_cpu)).max()), tol=TOL_DIST,
         distance_range=[float(mat[~np.eye(n, dtype=bool)].min()), float(mat.max())])
    return dists


def phase_data_train(torch, port, data, counters, train: np.ndarray, held_out: np.ndarray, neighbors) -> None:
    """The contrastive dataset at G = 3, epoch 1, through batch_iterator and
    prefetch_to_device into a warm-up and DATA_STEPS timed flagship train
    steps (fp32), counters as the train phase; index_iterator's rows
    gathered on the card equal batch_iterator's first batch; one eval step
    on held-out clips."""
    ds = data.NSynthDataset(train, neighbors, train=True, config=data.ContrastiveConfig(num_negative_samples=1),
                            seed=SEED)
    ds.set_epoch(1)
    check(ds.group_size == TRAIN_G, f"group size {ds.group_size}")
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    opt = port.make_optimizer(accumulate_grad_batches=1)
    state = port.create_train_state(model, opt)
    step = port.make_train_step(model, opt)
    fetch_ms, seen = [], []

    def fed():
        it = data.prefetch_to_device(data.batch_iterator(ds, TRAIN_B, seed=SEED, epoch=1), size=2)
        try:
            for _ in range(DATA_STEPS + 1):
                t0 = time.perf_counter()
                batch = next(it)
                fetch_ms.append((time.perf_counter() - t0) * 1e3)
                seen.append(batch)
                yield batch
        finally:
            it.close()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, times, components, launches = timed_steps(torch, step, state, fed(), counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = DATA_STEPS + 1
    check(len(times) == steps, f"{len(times)} data-fed steps ran, not {steps}")
    check(all(b.shape == (TRAIN_B, TRAIN_G, 1, NUM_SAMPLES) and b.device.type == "cuda"
              and b.dtype == torch.float32 for b in seen), f"batches {[tuple(b.shape) for b in seen]}")
    for name in ("binary_gumbel", "binary_gumbel_bwd", "masked_attention_fwd", *PQMF_KERNELS):
        check(launches[name] == steps, f"data: {name} launched {launches[name]} times in {steps} steps")
    check(launches["masked_attention_bwd"] >= steps, f"data: attention bwd launches {launches} for {steps} steps")
    check(all(launches[k] == 0 for k in (*HC_KERNELS, *COMBINE_KERNELS)), f"data: other kernels launched {launches}")

    corpus_dev = torch.from_numpy(train).to(DEVICE)
    idx = next(data.index_iterator(ds, TRAIN_B, seed=SEED, epoch=1))
    gathered = corpus_dev[torch.from_numpy(idx).to(DEVICE).long()][:, :, None, :]
    check(torch.equal(gathered, seen[0]), "index_iterator's rows gathered on the card differ from batch_iterator's")

    eval_ds = data.NSynthDataset(held_out, train=False)
    eval_batch = next(data.prefetch_to_device(data.batch_iterator(eval_ds, TRAIN_B, shuffle=False)))
    check(eval_batch.shape == (TRAIN_B, 1, NUM_SAMPLES), f"eval batch {tuple(eval_batch.shape)}")
    total, eval_components = port.make_eval_step(model)(eval_batch)
    eval_values = {k: torch.as_tensor(v).detach().cpu() for k, v in eval_components.items()}
    check(math.isfinite(float(total)) and all(bool(torch.isfinite(v).all()) for v in eval_values.values()),
          f"eval step: non-finite loss {float(total)}")
    step_ms = statistics.median(times[1:])
    emit("data_train", config=FLAGSHIP, anchors=TRAIN_B, group=TRAIN_G, epoch=1,
         negative_offset=ds.current_negative_offset, steps_timed=DATA_STEPS, step_ms=times,
         step_ms_median=step_ms, step_ms_spread=[min(times[1:]), max(times[1:])],
         anchors_per_s=TRAIN_B / (step_ms / 1e3), fetch_ms=fetch_ms, components=components,
         launches=launches, peak_mem_gib=peak_gib, index_gather_equal=True,
         eval_total=float(total), eval_components={k: v.tolist() for k, v in eval_values.items()})


def phase_data_hybrid(torch, stft, train: np.ndarray) -> None:
    """spectral_distance with the hybrid STFT against fft on the card, on
    two flagship clips against two others: value and gradient, and each
    method's forward + backward time."""
    x = torch.from_numpy(train[:2]).to(DEVICE)
    y = torch.from_numpy(train[2:4]).to(DEVICE)

    def run(method):
        xr = x.clone().requires_grad_(True)
        dist = stft.spectral_distance(xr, y, method=method)
        dist.sum().backward()
        return dist.detach(), xr.grad

    (v_fft, g_fft), (v_hyb, g_hyb) = run("fft"), run("hybrid")
    value_err = float(((v_hyb - v_fft).abs() / v_fft.abs()).max())
    grad_err = float((g_hyb - g_fft).abs().max() / g_fft.abs().max())
    check(value_err <= TOL_HYBRID[0], f"hybrid value {value_err} from fft's")
    check(grad_err <= TOL_HYBRID[1], f"hybrid gradient {grad_err} of the largest element from fft's")
    emit("data_hybrid", clips=2, samples=NUM_SAMPLES, value_rel_err=value_err, grad_rel_err=grad_err,
         tol=TOL_HYBRID, fft_fwd_bwd_ms=time_ms(lambda: run("fft"), reps=10, warmup=2),
         hybrid_fwd_bwd_ms=time_ms(lambda: run("hybrid"), reps=10, warmup=2))


def phase_data(torch, port, counters) -> None:
    """The data layer on the card: a synthetic corpus, WAVs through the
    native decoder, the distance precompute, the contrastive dataset into
    flagship train steps and an eval step, and the hybrid STFT."""
    from topo_audio_autoencoder_torch import data
    from topo_audio_autoencoder_torch.data import native_loader
    from topo_audio_autoencoder_torch.ops import stft

    t0 = time.perf_counter()
    corpus = data.synth_corpus(DATA_N + TRAIN_B, NUM_SAMPLES, seed=SEED)
    emit("data_corpus", clips=len(corpus), train=DATA_N, held_out=TRAIN_B, samples=NUM_SAMPLES,
         synth_s=time.perf_counter() - t0, native_library=str(native_loader.get_lib()._name))
    train, held_out = corpus[:DATA_N], corpus[DATA_N:]
    with tempfile.TemporaryDirectory() as tmp:
        phase_data_wav(torch, data, native_loader, corpus, Path(tmp))
        dists = phase_data_precompute(torch, data, stft, train, Path(tmp))
    torch.cuda.empty_cache()
    phase_data_train(torch, port, data, counters, train, held_out, dists["neighbors"])
    torch.cuda.empty_cache()
    phase_data_hybrid(torch, stft, train)


class TrainerProbe:
    """Times the trainer's parts from outside while a run goes through
    its entry points, adding no synchronisation to its loop: each step
    between two CUDA events recorded on the stream before and after it
    (read after the run), each epoch and each validate on the host clock
    (an epoch ends with its one loss copy, a validate with its per-clip
    copy), each checkpoint call (a sync save whole; an async one until
    the thread starts), each write of CheckpointManager.save (whichever
    thread runs it) with its file's size, and each wait in
    finish_checkpoints for an async save still in flight."""

    def __init__(self, torch):
        from topo_audio_autoencoder_torch.training import checkpoint, trainer

        self.torch = torch
        self.targets = [(trainer.Trainer, name) for name in
                        ("_build", "train_epoch", "validate", "save_checkpoint", "finish_checkpoints")]
        self.targets.append((checkpoint.CheckpointManager, "save"))
        self.steps, self.epochs, self.validates, self.calls, self.writes, self.waits = [], [], [], [], [], []

    def __enter__(self):
        import threading

        torch, probe = self.torch, self
        self.saved = [(cls, name, getattr(cls, name)) for cls, name in self.targets]
        orig = {name: fn for _, name, fn in self.saved}

        def timed_build(self, *a, **k):
            orig["_build"](self, *a, **k)
            inner = self.train_step

            def step(*args):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(*args)
                end.record()
                probe.steps.append((start, end))
                return out

            self.train_step = step

        def timed(record, fn, what=None):
            def run(self, *a, **k):
                t0 = time.perf_counter()
                out = fn(self, *a, **k)
                record.append({"s": time.perf_counter() - t0, **(what(self, a, k) if what else {})})
                return out
            return run

        def write_info(self, a, k):
            path = self._path(a[0]) / "state.pt"
            return {"name": a[0], "mb": path.stat().st_size / 1e6, "thread": threading.current_thread().name}

        def call_info(self, a, k):
            return {"names": a[0] if isinstance(a[0], str) else list(a[0]), "block": k.get("block", True)}

        def wait(self):
            t0, busy = time.perf_counter(), self._ckpt_thread is not None
            orig["finish_checkpoints"](self)
            if busy:
                probe.waits.append(time.perf_counter() - t0)

        patched = {
            "_build": timed_build, "train_epoch": timed(self.epochs, orig["train_epoch"]),
            "validate": timed(self.validates, orig["validate"]),
            "save_checkpoint": timed(self.calls, orig["save_checkpoint"], call_info), "finish_checkpoints": wait,
            "save": timed(self.writes, orig["save"], write_info),
        }
        for cls, name, _ in self.saved:
            setattr(cls, name, patched[name])
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)

    def summary(self) -> dict:
        self.torch.cuda.synchronize()
        step_ms = [s.elapsed_time(e) for s, e in self.steps]
        sync = [w for w in self.writes if w["thread"] == "MainThread"]
        async_writes = [w for w in self.writes if w["thread"] != "MainThread"]
        return dict(
            timed_steps=len(step_ms), step_ms_median=statistics.median(step_ms),
            step_ms_spread=[min(step_ms), max(step_ms)],
            epoch_s=[e["s"] for e in self.epochs], validate_s=[v["s"] for v in self.validates],
            sync_save=dict(writes=len(sync), s_median=statistics.median(w["s"] for w in sync),
                           mb=sync[0]["mb"]) if sync else None,
            async_save=dict(calls=[c for c in self.calls if not c["block"]],
                            writes=[{k: w[k] for k in ("name", "s", "mb")} for w in async_writes],
                            finish_waits_s=self.waits),
        )


def main_args(d: Path, **over) -> list:
    """main()'s command line for a run under ``d``; data.data_path names an
    empty directory, so main makes the synthetic corpus."""
    (d / "nodata").mkdir(parents=True, exist_ok=True)
    args = {"data.data_path": d / "nodata", "data.output_dir": d / "out",
            "data.precomputed_path": d / "pre" / "distances.npz", "train.checkpoint_dir": d / "ckpt",
            **TRAINER_ARGS, **over}
    return [f"{k}={v}" for k, v in args.items()]


def trainer_launch_check(what: str, launches: dict, steps: int, eval_calls: int) -> None:
    """Rows 2, 3, 3's backward and 12's adjoint once a trainer step; rows
    1 and 12 once a step and once an eval forward (each validate batch,
    each dump); no other sampler or combine kernel."""
    want = {"masked_attention_fwd": steps + eval_calls, "masked_attention_bwd": steps,
            "binary_gumbel": steps, "binary_gumbel_bwd": steps,
            "pqmf_synthesis": steps + eval_calls, "pqmf_synthesis_adjoint": steps}
    for name, n in want.items():
        check(launches[name] == n, f"{what}: {name} launched {launches[name]} times, not {n} "
                                   f"({steps} steps, {eval_calls} eval forwards)")
    check(all(launches[k] == 0 for k in (*HC_KERNELS, *COMBINE_KERNELS)), f"{what}: other kernels {launches}")


def phase_trainer_main(torch, port, counters) -> dict:
    """``main`` in-process at the flagship width: a synthetic corpus, the
    precompute, the 2 x 1 x 1 grid tuned one epoch a combo, 2 epochs with
    validation, checkpoints, the log and dumps; then ``train.resume=true``
    to 3 epochs. Checks the files, the losses and rows 1-3 per step."""
    from topo_audio_autoencoder_torch import main as port_main

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ckpt = d / "ckpt"
        for c in counters.values():
            c.launches = 0  # just before the main path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with TrainerProbe(torch) as probe:
            port_main.main(main_args(d))
        wall_s = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}  # just after
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        metrics = json.loads((ckpt / "metrics.json").read_text())
        steps = len(metrics["iteration_losses"])
        dumps = sorted(ckpt.glob("samples/*/metadata_*.json"))
        check(steps == 4 * TRAINER_BATCHES[0], f"trainer_main: {steps} steps in 2 tuning and 2 main epochs")
        trainer_launch_check("trainer_main", launches, steps, len(probe.validates) * TRAINER_BATCHES[1] + len(dumps))
        losses = metrics["iteration_losses"] + metrics["train_losses"] + metrics["val_losses"]
        check(len(metrics["train_losses"]) == 2 and all(math.isfinite(v) for v in losses),
              f"trainer_main: losses {metrics['train_losses']}, {metrics['val_losses']}")
        for name in ("best", "latest", "epoch_0", "best_tuning", "e0.001_d0.0001_c0.1/epoch_0",
                     "e0.0005_d0.0001_c0.1/epoch_0"):
            check((ckpt / name / "state.pt").exists(), f"trainer_main: no checkpoint {name}")
        for name in ("best", "latest", "epoch_0"):
            extra = json.loads((ckpt / f"{name}.extra.json").read_text())
            check(set(extra) == {"encoder_lr", "decoder_lr", "complexity_penalty", "model", "train_state"}
                  and set(extra["train_state"]) == {"epoch", "metrics", "dataset_epoch", "rng_key"}
                  and [extra["model"][k] for k in ("vertices", "hidden", "layers")]
                  == [FLAGSHIP[k] for k in ("num_vertices", "sccn_hidden_dim", "n_sccn_layers")],
                  f"trainer_main: sidecar {name}: {sorted(extra)}")
        check(set(json.loads((ckpt / "best_tuning.extra.json").read_text())) ==
              {"encoder_lr", "decoder_lr", "complexity_penalty", "model"}, "trainer_main: best_tuning sidecar")
        log = [json.loads(x) for x in (ckpt / "train_log.jsonl").read_text().splitlines()]
        check(log and all("grad_norms" in r and math.isfinite(r["total_loss"]) for r in log),
              "trainer_main: train_log.jsonl without grad norms or finite losses")
        first = ckpt / "samples" / "epoch_0_iter_0"
        check(sorted(x.name for x in first.iterdir()) == ["input_0.wav", "metadata_0.json", "output_0.wav"],
              f"trainer_main: samples dump {sorted(x.name for x in first.iterdir())}")
        run = probe.summary()

        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with TrainerProbe(torch) as probe2:
            port_main.main(main_args(d, **{"train.resume": "true", "train.max_epochs": 3}))
        resume_s = time.perf_counter() - t0
        launches2 = {name: c.launches for name, c in counters.items()}
        m3 = json.loads((ckpt / "metrics.json").read_text())
        steps2 = len(m3["iteration_losses"]) - steps
        dumps2 = len(list(ckpt.glob("samples/*/metadata_*.json"))) - len(dumps)
        check(len(m3["train_losses"]) == 3 and m3["train_losses"][:2] == metrics["train_losses"]
              and len(probe2.epochs) == 1 and steps2 == TRAINER_BATCHES[0], f"trainer_main resume: {m3['train_losses']}")
        check(not (d / "ckpt_old").exists() and (ckpt / "best_tuning").exists(), "trainer_main: resume rotated")
        trainer_launch_check("trainer_main resume", launches2, steps2, len(probe2.validates) * TRAINER_BATCHES[1] + dumps2)
        emit("trainer_main", config=FLAGSHIP, args=TRAINER_ARGS, batch=4, group=12, accumulate=4, dtype="float32",
             wall_s=wall_s, steps=steps, launches=launches, peak_mem_gib=peak_gib, **run,
             train_losses=metrics["train_losses"], val_losses=metrics["val_losses"],
             best_params=metrics["best_params"], best_epoch=metrics["best_epoch"],
             dumps=len(dumps), log_records=len(log),
             resume=dict(wall_s=resume_s, steps=steps2, launches=launches2, train_losses=m3["train_losses"],
                         val_losses=m3["val_losses"], **probe2.summary()))
    return launches


def phase_trainer_resume(torch, port, counters) -> None:
    """Trainer.train() for 3 epochs uninterrupted against 2 epochs, a
    fresh model and trainer (as a new process would build them), and
    train(resume=True) to 3, cuDNN deterministic, for the flagship and for
    the n=32 packed model at the repo's best geometry: every loss, the best
    epoch, every parameter and moment equal bit for bit."""
    from topo_audio_autoencoder_torch import data

    corpus = data.synth_corpus(RESUME_TRAIN + RESUME_VAL, NUM_SAMPLES, seed=SEED + 40)
    dists = data.compute_distances(corpus[:RESUME_TRAIN], tile=DATA_TILE)
    train = data.NSynthDataset(corpus[:RESUME_TRAIN], dists["neighbors"], train=True, seed=SEED)
    val = data.NSynthDataset(corpus[RESUME_TRAIN:])
    for phase, config, options in (("trainer_resume", FLAGSHIP, {}),
                                   ("trainer_resume_packed", PACKED, PACKED_OPTIONS)):
        resume_runs(torch, port, phase, train, val, config, options)


def resume_runs(torch, port, phase, train, val, config, options) -> None:
    """trainer_resume's three runs of one model on the same clips, and
    their checks."""
    from topo_audio_autoencoder_torch.training import Trainer, TrainerConfig

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, epochs, directory, resume in (("full", RESUME_EPOCHS, "full", False),
                                                    ("killed", RESUME_EPOCHS - 1, "kill", False),
                                                    ("resumed", RESUME_EPOCHS, "kill", True)):
                train.set_epoch(0)
                model = port.AudioAutoencoder.create(**config, **options, num_samples=NUM_SAMPLES, seed=SEED + 41,
                                                     device=DEVICE)
                trainer = Trainer(model, train, val,
                                  config=TrainerConfig(checkpoint_dir=str(Path(tmp) / directory),
                                                       max_epochs=epochs))
                t0 = time.perf_counter()
                m = trainer.train(resume=resume)
                opt = trainer.state.opt_state
                runs[name] = dict(
                    s=time.perf_counter() - t0, metrics=m,
                    params={n: p.detach().cpu() for n, p in model.named_parameters()},
                    moments={n: (opt.mu[n].cpu(), opt.nu[n].cpu()) for n in opt.mu},
                    counters=(opt.count, opt.mini_step, trainer.state.step), offset=train.current_negative_offset)
                if name == "killed":
                    saved = port.CheckpointManager(Path(tmp) / "kill").restore("latest")["opt_state"]
                    check(saved["mini_step"] == 2 * (RESUME_TRAIN // 4) % 4 and len(saved["acc"]) > 0,
                          f"{phase}: the killed run's accumulator {saved['mini_step']}")
                del model, trainer
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    full, res = runs["full"], runs["resumed"]
    fm, rm = full["metrics"], res["metrics"]
    differ = sorted(n for n in full["params"] if not torch.equal(full["params"][n], res["params"][n]))
    moments_differ = sorted(n for n in full["moments"]
                            if not all(torch.equal(a, b) for a, b in zip(full["moments"][n], res["moments"][n])))
    emit(phase, config=config, options=options, clips=dict(train=RESUME_TRAIN, val=RESUME_VAL),
         epochs=RESUME_EPOCHS, cudnn_deterministic=True, seconds={k: r["s"] for k, r in runs.items()},
         val_losses={k: r["metrics"].val_losses for k, r in runs.items()},
         train_losses={k: r["metrics"].train_losses for k, r in runs.items()},
         best_epoch={k: r["metrics"].best_epoch for k, r in runs.items()},
         counters={k: r["counters"] for k, r in runs.items()}, negative_offset=full["offset"],
         n_params=len(full["params"]), params_differ=differ[:10], n_params_differ=len(differ),
         moments_differ=moments_differ[:10],
         max_param_abs_diff=max((float((full["params"][n] - res["params"][n]).abs().max()) for n in differ),
                                default=0.0))
    check(all(math.isfinite(v) for v in fm.iteration_losses + fm.val_losses), f"{phase}: non-finite loss")
    check(rm.val_losses == fm.val_losses and rm.train_losses == fm.train_losses
          and rm.iteration_losses == fm.iteration_losses, f"{phase}: the resumed losses differ")
    check(rm.best_epoch == fm.best_epoch and res["counters"] == full["counters"], f"{phase}: best epoch")
    check(not differ and not moments_differ, f"{phase}: {len(differ)} parameters differ, "
                                             f"{len(moments_differ)} moments differ")


def phase_epoch_b128(torch, port, counters) -> None:
    """BASELINE config 4: the precompute of 2,048 synthetic clips at tile
    64, then Trainer.train_epoch over them at B = 128 x G = 6, bf16, on the
    device corpus: one warm-up step, then the epoch (16 steps) on the host
    clock, ended by its loss copy; clips/s, peak memory, launches a step;
    one more step under torch.profiler."""
    from topo_audio_autoencoder_torch import data
    from topo_audio_autoencoder_torch.training import Trainer, TrainerConfig, anneal_temperature

    t0 = time.perf_counter()
    corpus = data.synth_corpus(B128_N, NUM_SAMPLES, seed=SEED + 50)
    synth_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dists = data.compute_distances(corpus, tile=DATA_TILE)
    precompute_s = time.perf_counter() - t0
    ds = data.NSynthDataset(corpus, dists["neighbors"], train=True,
                            config=data.ContrastiveConfig(num_negative_samples=B128_NEGATIVES))
    check(ds.group_size == B128_NEGATIVES + 2, f"epoch_b128: group {ds.group_size}")
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, ds, data.NSynthDataset(corpus[:B128_B]), config=TrainerConfig(
            checkpoint_dir=tmp, batch_size=B128_B, compute_dtype="bfloat16", accumulate_grad_batches=1,
            device_corpus=True, dump_audio=False, checkpoint_every_iters=0))
        trainer.state = trainer.init_state()
        first = next(data.index_iterator(ds, B128_B, seed=trainer.cfg.seed, epoch=0))
        temp = anneal_temperature(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, first, temp, trainer.run_seed)  # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        for c in counters.values():
            c.launches = 0  # just before the main path
        t0 = time.perf_counter()
        loss = trainer.train_epoch(0)  # ends with the epoch's loss copy
        epoch_s = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}  # just after
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        steps = B128_N // B128_B
        check(len(trainer.metrics.iteration_losses) == steps and math.isfinite(loss)
              and all(math.isfinite(v) for v in trainer.metrics.iteration_losses),
              f"epoch_b128: losses {trainer.metrics.iteration_losses}")
        trainer_launch_check("epoch_b128", launches, steps, 0)
        profiled = trace_call(torch, lambda: trainer.train_step(trainer.state, first, temp, trainer.run_seed),
                              f"one BASELINE config 4 step (bf16, B={B128_B}, G={B128_NEGATIVES + 2})")
    emit("epoch_b128", config=FLAGSHIP, clips=B128_N, batch=B128_B, group=B128_NEGATIVES + 2, dtype="bfloat16",
         steps=steps, synth_s=synth_s, precompute_s=precompute_s, warmup_s=warm_s, epoch_s=epoch_s,
         clips_per_s=steps * B128_B / epoch_s, step_ms_mean=epoch_s / steps * 1e3, loss=loss,
         peak_mem_gib=peak_gib, launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
         device_busy_share_profiled=profiled["device_busy_share_profiled"], profiled_step=profiled)


def phase_codec_cli(torch, port, counters) -> dict:
    """The port's codec CLI on the card through WAV files: encode and
    decode CLI_RUNS times each, for the flagship (``--params``) and the n=32
    packed model (``--checkpoint``, geometry from the sidecar alone).
    Checks the header, the bits against a direct encode of the same WAV
    windows, the CLI's waveform against a direct Codec decode of the same
    bits (one int16 step), and row 1 once a decode batch and nothing else
    launched. Returns row 1's launches over every CLI run."""
    import contextlib
    import io

    from topo_audio_autoencoder_torch import codec_cli
    from topo_audio_autoencoder_torch.data.preprocess import load_wav, save_wav

    total = dict.fromkeys(counters, 0)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for name, config, options in (("flagship", FLAGSHIP, {}), ("packed", PACKED, PACKED_OPTIONS)):
            model = port.AudioAutoencoder.create(**config, **options, num_samples=NUM_SAMPLES, seed=SEED,
                                                 device=DEVICE)
            with torch.no_grad():
                model.encoder.mlp2.bias += LOGIT_SHIFT
            if name == "flagship":
                port.save_params(d / "params", model.state_dict())
                source = ["--params", str(d / "params")]
            else:
                port.CheckpointManager(d / "ckpt").save(
                    "best", {"params": {n: p.detach() for n, p in model.named_parameters()}, "step": 0},
                    extra={"encoder_lr": 1e-3, "decoder_lr": 1e-4, "complexity_penalty": 0.1,
                           "model": model.geometry()})
                source = ["--checkpoint", str(d / "ckpt")]
            wavs = []
            for i, clip in enumerate(make_clips(CLIPS, SEED + 900) * CLI_GAIN):
                wavs.append(str(d / name / f"clip_{i}.wav"))
                save_wav(wavs[-1], clip[0])
            runs = []
            for r in range(CLI_RUNS):
                tac, out_dir = d / name / f"run_{r}.tac", d / name / f"decoded_{r}"
                run = {}
                for cmd, args in (("encode", ["encode", str(tac), *wavs, "--clip-samples", str(NUM_SAMPLES)]),
                                  ("decode", ["decode", str(tac), str(out_dir)])):
                    for c in counters.values():
                        c.launches = 0  # just before the CLI's path
                    printed = io.StringIO()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(printed):
                        codec_cli.main([*args, *source, "--batch", str(CLIPS)])
                    torch.cuda.synchronize()
                    run[f"{cmd}_s"] = time.perf_counter() - t0
                    run[f"{cmd}_launches"] = {k: c.launches for k, c in counters.items()}  # just after
                    run[f"{cmd}_report"] = json.loads(printed.getvalue().strip().splitlines()[-1])
                    for k in total:
                        total[k] += run[f"{cmd}_launches"][k]
                check(sum(run["encode_launches"].values()) == 0, f"codec_cli {name}: encode launched {run}")
                check(run["decode_launches"]["masked_attention_fwd"] == run["decode_launches"]["pqmf_synthesis"] == 1
                      and sum(run["decode_launches"].values()) == 2, f"codec_cli {name}: decode launches {run}")
                runs.append(run)
            bits, header = codec_cli.read_tac(tac)
            n = config["num_vertices"]
            want_header = {"vertices": n, "bands": config["num_bands"], "hidden": config["sccn_hidden_dim"],
                           "layers": config["n_sccn_layers"], "num_clips": CLIPS, "num_samples": NUM_SAMPLES}
            check({k: header[k] for k in want_header} == want_header and "pack_capacities" not in header,
                  f"codec_cli {name}: header {header}")
            check(bits.shape == (CLIPS, math.ceil(sum(model.tables.sizes) / 8)), f"codec_cli {name}: {bits.shape}")
            check(name != "packed" or bits.shape[1] == PACKED_WIRE_BYTES, f"codec_cli: packed wire {bits.shape}")
            codec = port.Codec(model, device=DEVICE)
            windows, _ = codec_cli._load_windows(wavs, NUM_SAMPLES, 16000)
            direct_bits = port.pack_latent(codec.encode(windows))
            check(np.array_equal(direct_bits, bits), f"codec_cli {name}: the CLI's bits differ from a direct encode")
            direct = codec.decode(port.unpack_latent(bits, n), NUM_SAMPLES).cpu().numpy()
            err = max(float(np.abs(load_wav(out_dir / f"clip_{i}.wav") - np.clip(direct[i, 0], -1.0, 1.0)).max())
                      for i in range(CLIPS))
            check(err <= TOL_INT16, f"codec_cli {name}: CLI decode vs Codec.decode {err} > {TOL_INT16}")
            check(bool(np.isfinite(direct).all()) and float(np.abs(direct).max()) > 1e-3,
                  f"codec_cli {name}: waveform")
            last = runs[-1]
            results[name] = dict(
                source=source[0], runs=runs, clips=CLIPS, bytes_per_clip=int(bits.shape[1]),
                active_bits=int(np.unpackbits(bits, axis=-1).sum()), decode_vs_codec_max_abs_err=err,
                encode_clips_per_s=CLIPS / last["encode_s"], decode_clips_per_s=CLIPS / last["decode_s"])
            del model, codec
            torch.cuda.empty_cache()
    emit("codec_cli", samples=NUM_SAMPLES, tol=TOL_INT16, **results)
    return total


class GridProbe:
    """Times each VmappedGridTuner.grid_step from outside while the tune
    runs through Trainer.tune_hyperparameters_vmapped: CUDA events recorded
    on the stream before and after each call (no added synchronisation),
    the launch counters' change across each call, and the last call's
    arguments, for a profile after the run."""

    def __init__(self, torch, counters):
        from topo_audio_autoencoder_torch.training import tuner

        self.torch, self.counters, self.cls = torch, counters, tuner.VmappedGridTuner
        self.steps, self.deltas, self.last = [], [], None

    def __enter__(self):
        torch, probe, inner = self.torch, self, self.cls.grid_step
        self.inner = inner

        def grid_step(tuner, state, batch, *args, **kw):
            before = {k: c.launches for k, c in probe.counters.items()}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(tuner, state, batch, *args, **kw)
            end.record()
            probe.steps.append((start, end))
            probe.deltas.append({k: c.launches - before[k] for k, c in probe.counters.items()})
            probe.last = (tuner, state, batch, args, kw)
            return out

        self.cls.grid_step = grid_step
        return self

    def __exit__(self, *exc):
        self.cls.grid_step = self.inner

    def step_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.steps]


def phase_tuner(torch, port, counters) -> dict:
    """The full recipe's tune stage through Trainer.tune_hyperparameters_vmapped
    at full width (TUNE_GRID, B = 8 x G = 12, bf16, the device corpus,
    scanned): grid-step ms (events), rows 1 and 2 once each a grid step
    over K*B elements, row 1 once a val batch, no other kernel (the tuner
    runs the plain sampler), peak memory, the winner adopted and saved;
    one more grid step profiled (busy share), and one whose folded
    attention inputs hold rows 1 and 2 against their plain versions; then
    the production train step that the sequential tuner runs K times per
    grid step. Returns the tune's launches."""
    from topo_audio_autoencoder_torch import data
    from topo_audio_autoencoder_torch.training import Trainer, TrainerConfig

    k = math.prod(len(v) for v in TUNE_GRID.values())
    corpus = data.synth_corpus(TUNE_TRAIN + TUNE_VAL, NUM_SAMPLES, seed=SEED + 60)
    dists = data.compute_distances(corpus[:TUNE_TRAIN], tile=DATA_TILE)
    train = data.NSynthDataset(corpus[:TUNE_TRAIN], dists["neighbors"], train=True)
    val = data.NSynthDataset(corpus[TUNE_TRAIN:])
    g, batch = train.group_size, TUNE_B
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 61, device=DEVICE)
    tmp = tempfile.TemporaryDirectory()
    trainer = Trainer(model, train, val, config=TrainerConfig(
        checkpoint_dir=tmp.name, batch_size=batch, tuning_epochs=1, compute_dtype="bfloat16",
        scan_steps=TUNE_SCAN, dump_audio=False, checkpoint_every_iters=0))
    for c in counters.values():
        c.launches = 0  # just before the tune
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with GridProbe(torch, counters) as probe:
        best = trainer.tune_hyperparameters_vmapped(TUNE_GRID)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}  # just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = probe.step_ms()
    steps = TUNE_TRAIN // batch
    val_batches = TUNE_VAL // batch
    check(len(step_ms) == steps, f"tuner: {len(step_ms)} grid steps, not {steps}")
    for i, delta in enumerate(probe.deltas):
        check(all(delta[k] == 1 for k in GRID_STEP_KERNELS) and sum(delta.values()) == 4,
              f"tuner: grid step {i} launched {delta}")
    check(launches["masked_attention_fwd"] == launches["pqmf_synthesis"] == steps + val_batches
          and launches["masked_attention_bwd"] == launches["pqmf_synthesis_adjoint"] == steps
          and sum(launches.values()) == 4 * steps + 2 * val_batches, f"tuner: launches {launches}")
    check(best in [dict(zip(("encoder_lr", "decoder_lr", "complexity_penalty"), c))
                   for c in itertools.product(*TUNE_GRID.values())], f"tuner: best {best}")
    check(trainer.metrics.best_params == best and (Path(tmp.name) / "best_tuning" / "state.pt").exists(),
          "tuner: best_tuning not written")
    check(all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters()), "tuner: adopted parameters")
    tuner, state, gbatch, args, kw = probe.last
    check(tuple(gbatch.shape) == (batch, g, 1, NUM_SAMPLES), f"tuner: grid batch {tuple(gbatch.shape)}")
    profiled = trace_call(torch, lambda: tuner.grid_step(state, gbatch, *args, **kw),
                          f"one vmapped grid step (K={k}, bf16, B={batch}, G={g})")
    grid_attention(torch, tuner, state, gbatch, args, kw, k * batch)
    del tuner, state, probe
    # The sequential tuner's unit: the production step (one combo) on the
    # same index batches.
    idx = list(data.index_iterator(train, batch, seed=trainer.cfg.seed, epoch=0))
    temp = port.anneal_temperature(0)
    trainer.state = trainer.init_state()
    seq = []
    for i in range(TUNE_SEQ_STEPS + 1):  # the first warms up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(trainer.state, idx[i % len(idx)], temp, trainer.run_seed)
        end.record()
        seq.append((start, end))
    torch.cuda.synchronize()
    seq_ms = [s.elapsed_time(e) for s, e in seq]
    grid_ms = statistics.median(step_ms[1:])
    single_ms = statistics.median(seq_ms[1:])
    tmp.cleanup()
    emit("tuner", config=FLAGSHIP, grid=TUNE_GRID, combos=k, batch=batch, group=g, dtype="bfloat16",
         clips=dict(train=TUNE_TRAIN, val=TUNE_VAL), scan_steps=TUNE_SCAN, wall_s=wall_s, best=best,
         grid_step_ms=step_ms, grid_step_ms_median=grid_ms, launches=launches,
         attention_elements=k * batch, peak_mem_gib=peak_gib,
         device_busy_share_profiled=profiled["device_busy_share_profiled"], profiled_step=profiled,
         sequential_step_ms=seq_ms, sequential_step_ms_median=single_ms,
         sequential_grid_ms=k * single_ms, speedup_vs_sequential=k * single_ms / grid_ms)
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def bf16_tol(values) -> float:
    """TOL_BF16 at the largest output these values allow: an attention
    output is a convex combination of rows of V, and one bf16 ulp doubles
    with each binade above |o| = 2 (TOL_BF16's range)."""
    top = float(values.float().abs().max())
    return TOL_BF16 * 2.0 ** max(0, math.ceil(math.log2(top / 2))) if top > 0 else TOL_BF16


def grid_attention(torch, tuner, state, batch, args, kw, elements: int) -> None:
    """Rows 1 and 2 on the inputs one more vmapped grid step hands them:
    MaskedAttention's forward and backward are wrapped to keep q, k, v, the
    mask and dO as the vmap rule's fold gives them ([K*B, ...], bf16, the
    mask copied K times where it is not vmapped); then each kernel is held
    against its plain version on those tensors (forward at bf16_tol,
    backward at TOL_BWD's bf16 bound)."""
    from unittest import mock

    from topo_audio_autoencoder_torch.ops import attention

    fn = attention.MaskedAttention
    inner_fwd, inner_bwd = fn.forward, fn.backward
    cap = {}

    def forward(query, keys, values, key_mask, num_heads):
        cap.update(q=query.detach().clone(), k=keys.detach().clone(), v=values.detach().clone(),
                   mask=key_mask.detach().clone(), h=num_heads, calls=cap.get("calls", 0) + 1)
        return inner_fwd(query, keys, values, key_mask, num_heads)

    def backward(ctx, dout, dlse):
        cap["dout"] = dout.detach().clone()
        return inner_bwd(ctx, dout, dlse)

    with mock.patch.object(fn, "forward", staticmethod(forward)), \
            mock.patch.object(fn, "backward", staticmethod(backward)):
        tuner.grid_step(state, batch, *args, **kw)
        torch.cuda.synchronize()
    h = cap["h"]
    q, k, v, mask = (cap[n].contiguous() for n in ("q", "k", "v", "mask"))
    dout = cap["dout"].to(q.dtype).contiguous()
    check(cap["calls"] == 1 and q.shape[0] == elements and q.dtype == torch.bfloat16,
          f"tuner attention: {cap['calls']} forward calls, q {tuple(q.shape)} {q.dtype}, not one over {elements}")
    shape = dict(b=q.shape[0], q=q.shape[1], m=k.shape[1], c=q.shape[2], h=h)
    with torch.inference_mode():
        fwd = measure_attention(torch, attention, q, k, v, mask, h, bf16_tol(v))
    bwd = measure_attention_bwd(torch, attention, q, k, v, mask, dout, h)
    emit("kernel", kernel="masked_attention_fwd", inputs="vmapped grid step", shape=shape, results=[fwd])
    emit("kernel", kernel="masked_attention_bwd", inputs="vmapped grid step", shape=shape, results=[bwd])


def phase_tuner_parity(torch, port, training, counters) -> None:
    """One K = 2 grid step on the card against two single-combo steps of the
    port (``make_loss_and_grads`` on a model holding that combo's weights)
    on the same batch and uniforms, cuDNN deterministic: each combo's loss,
    its whole gradient where conditioned (train_parity's nudge rule, here
    on the card), and every leaf of the surrogate (the grid with its loss
    replaced by train_parity's surrogate); rows 1 and 2 once each a grid
    step over 4 elements."""
    from unittest import mock

    from topo_audio_autoencoder_torch.training import tuner as tuner_mod

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 62, device=DEVICE,
                                             dropout=0.0)
        tuner = tuner_mod.VmappedGridTuner(model)
        state = tuner.init_grid(PARITY_GRID, seed=SEED + 63)
        k = state.encoder_lr.shape[0]
        rng = np.random.default_rng(SEED + 64)
        batch = torch.from_numpy(make_clips(2 * TRAIN_G, SEED + 410).reshape(2, TRAIN_G, 1, NUM_SAMPLES)).to(DEVICE)
        noise = torch.from_numpy(rng.uniform(1e-6, 1 - 1e-6, (k, 2, model.tables.total_simplices))
                                 .astype(np.float32)).to(DEVICE)
        w = torch.from_numpy(rng.standard_normal((2, 1, NUM_SAMPLES)).astype(np.float32)).to(DEVICE)

        def sur_loss(recon, target, aux, valid, weights, contrastive=None, **kw):
            val = (recon * w).sum() + aux["binary_entropy"].mean() + aux["diversity"].mean()
            return (val + contrastive if contrastive is not None else val), {}

        deltas = []
        for c in counters.values():
            c.launches = 0
        losses, grads = tuner.loss_and_grads(state, batch, TEMPERATURE, noise={"noise": noise})
        deltas.append({n: c.launches for n, c in counters.items()})
        for c in counters.values():
            c.launches = 0
        with mock.patch.object(tuner_mod, "autoencoder_loss", sur_loss):
            sur_vals, sur_grads = tuner.loss_and_grads(state, batch, TEMPERATURE, noise={"noise": noise})
        deltas.append({n: c.launches for n, c in counters.items()})
        combos = []
        for i in range(k):
            single = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 65, device=DEVICE,
                                                  dropout=0.0, use_fused_sampler=False)
            with torch.no_grad():
                for n, p in single.named_parameters():
                    p.copy_(state.params[n][i])
            weights = training.LossWeights(complexity_penalty=float(state.complexity_penalty[i]))
            total, _, want = training.make_loss_and_grads(single, weights)(batch, TEMPERATURE, SEED, 0, noise[i])

            def l2(ts):
                return math.sqrt(sum(float((t.double() ** 2).sum()) for t in ts))

            grad_err = l2(grads[n][i] - want[n] for n in want) / l2(want.values())
            floor = None
            if grad_err > PARITY_GRAD_REL_L2:
                nudged = training.make_loss_and_grads(single, weights)(
                    batch * (1 + FLOOR_NUDGE), TEMPERATURE, SEED, 0, noise[i])[2]
                floor = l2(nudged[n] - want[n] for n in want) / l2(want.values())
            names, params = zip(*single.named_parameters())
            val, _, _ = surrogate(torch, single, batch, noise[i], w)
            sgrads = dict(zip(names, torch.autograd.grad(val, params)))
            scale = max(float(gr.abs().max()) for gr in sgrads.values())
            leaf_err = {n: float((sur_grads[n][i] - sgrads[n]).abs().max()) / scale for n in names}
            worst = max(leaf_err, key=leaf_err.get)
            combos.append(dict(
                loss=float(losses[i]), loss_rel_err=abs(float(losses[i]) - float(total)) / abs(float(total)),
                grad_rel_l2=grad_err, grad_nudge_floor=floor, grad_conditioned=floor is None or floor <= PARITY_GRAD_REL_L2,
                surrogate_value_rel_err=abs(float(sur_vals[i]) - float(val.detach())) / abs(float(val.detach())),
                surrogate_leaf_max_err=leaf_err[worst], surrogate_worst_leaf=worst))
            del single
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit("tuner_parity", config=FLAGSHIP, grid=PARITY_GRID, anchors=2, group=TRAIN_G, cudnn_deterministic=True,
         combos=combos, launches=deltas, loss_rtol=PARITY_LOSS_RTOL, grad_rel_l2_tol=PARITY_GRAD_REL_L2,
         surrogate_tol=SURROGATE_TOL)
    for i, c in enumerate(combos):
        check(c["loss_rel_err"] <= PARITY_LOSS_RTOL, f"tuner_parity combo {i}: loss {c}")
        check(c["grad_rel_l2"] <= PARITY_GRAD_REL_L2 or not c["grad_conditioned"], f"tuner_parity combo {i}: {c}")
        check(c["surrogate_value_rel_err"] <= PARITY_LOSS_RTOL and c["surrogate_leaf_max_err"] <= SURROGATE_TOL,
              f"tuner_parity combo {i}: surrogate {c}")
    for delta in deltas:
        check(all(delta[k] == 1 for k in GRID_STEP_KERNELS) and sum(delta.values()) == 4,
              f"tuner_parity: a grid step launched {delta}")


def phase_dp_philox(torch, fused, hc, n_simplices: int) -> dict:
    """Rows 3-5 drawing a data-parallel rank's rows: at [16, 6195], fp32 and
    bf16, the 8 rows from row r (first = r x 6,195) must equal rows r..r+7
    of the first = 0 draw bit for bit (output and uniforms: the kernels are
    elementwise), the uniforms the plain ``philox_uniform(first=)`` bit for
    bit, and the output its plain relaxation within the kernel phases'
    tolerance (torch's log and sigmoid are not the kernels' logf and expf).
    Times (CUDA events, the kernel phases' method) at [16, 6195] with first
    0, 8 x 6,195 and 6,195."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 80)
    rows = stretch_rows(torch, n_simplices, rng)
    samplers = {
        "binary_gumbel": (lambda x, **kw: fused.binary_gumbel_sample(x, TEMPERATURE, **kw),
                          lambda x, u: fused.binary_gumbel_plain(x, u, TEMPERATURE), None),
        "hard_concrete": (lambda x, **kw: hc.hard_concrete_sample(x, HC_BETA, **kw),
                          lambda x, u: hc.hard_concrete_plain(x, u, HC_BETA), 0),
        "hard_concrete_learned": (lambda x, **kw: hc.hard_concrete_learned_sample(x, *rows, **kw),
                                  lambda x, u: hc.hard_concrete_learned_plain(x, u, *rows), 3 * n_simplices * 4),
    }
    half = TRAIN_B // 2
    out = {}
    for kernel, (sample, plain, row_bytes) in samplers.items():
        results = []
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            x = torch.from_numpy(rng.normal(0.5, 2.0, (TRAIN_B, n_simplices)).astype(np.float32)).to(dev, dtype)
            whole, u_whole = sample(x, seed=SEED, offset=13, return_noise=True)
            err = 0.0
            for r in DP_FIRST_ROWS:
                block = x[r : r + half].contiguous()
                first = r * n_simplices
                got, u = sample(block, seed=SEED, offset=13, first=first, return_noise=True)
                torch.cuda.synchronize()
                check(torch.equal(u, u_whole[r : r + half]) and torch.equal(got, whole[r : r + half]),
                      f"dp_philox {kernel} {name}: rows {r}.. with first={first} differ from the global draw")
                want_u = fused.philox_uniform(block.numel(), SEED, 13, dev, first).reshape(block.shape)
                check(torch.equal(u, want_u), f"dp_philox {kernel} {name}: uniforms from first={first} differ "
                                              "from the plain Philox stream")
                err = max(err, (got.float() - plain(block, u).float()).abs().max().item())
            check(err <= TOL_SAMPLER[name], f"dp_philox {kernel} {name}: max abs err {err} > {TOL_SAMPLER[name]}")
            ms = {f"first_{f}": time_ms(lambda f=f: sample(x, seed=SEED, offset=13, first=f))
                  for f in (0, half * n_simplices, n_simplices)}

            def plain_call():
                u = fused.philox_uniform(x.numel(), SEED, 13, dev, n_simplices).reshape(x.shape)
                return plain(x, u)

            n, elt = x.numel(), x.element_size()
            bound_ms, bound_by = sampler_bound(n, elt) if row_bytes is None else hc_bound(n, elt, row_bytes)
            results.append(dict(dtype=name, max_abs_err=err, tol=TOL_SAMPLER[name], ms=ms, plain_ms=time_ms(plain_call),
                                bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        out[kernel] = results
    emit("dp_philox", shape=[TRAIN_B, n_simplices], rank_rows=half, first_rows=list(DP_FIRST_ROWS),
         rows_bit_for_bit=True, uniforms_bit_for_bit=True, results=out)
    return out


def run_state(trainer) -> dict:
    """A finished run's state on the host: parameters, moments, counters."""
    opt = trainer.state.opt_state
    return dict(params={n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
                moments={n: (opt.mu[n].cpu(), opt.nu[n].cpu()) for n in opt.mu},
                counters=(opt.count, opt.mini_step, trainer.state.step))


def differing(a: dict, b: dict) -> list:
    """The names whose tensors (or tuples of tensors) differ in any bit."""
    import torch

    def same(x, y):
        return all(map(torch.equal, x, y)) if isinstance(x, tuple) else torch.equal(x, y)

    return sorted(n for n in a if not same(a[n], b[n]))


def phase_dp1(torch, port, counters) -> dict:
    """Data parallelism over NCCL at world size 1 (one card): the Trainer
    with data_parallel (the replicated corpus, then shard_corpus) against
    the same run without it, cuDNN deterministic; every loss, the best
    epoch, every parameter and moment equal bit for bit (an all-reduce over
    one rank changes no bit); rows 1-3 once a trainer step (row 1 also once
    an eval forward), counted over the replicated run; step ms by events.
    Then the vmapped tuner on a mesh of one against the tuner without one:
    the same grid-step losses and parameters bit for bit."""
    from topo_audio_autoencoder_torch import data
    from topo_audio_autoencoder_torch.parallel import make_mesh
    from topo_audio_autoencoder_torch.training import Trainer, TrainerConfig
    from topo_audio_autoencoder_torch.training.tuner import VmappedGridTuner

    corpus = data.synth_corpus(RESUME_TRAIN + RESUME_VAL, NUM_SAMPLES, seed=SEED + 81)
    dists = data.compute_distances(corpus[:RESUME_TRAIN], tile=DATA_TILE)
    train = data.NSynthDataset(corpus[:RESUME_TRAIN], dists["neighbors"], train=True, seed=SEED)
    val = data.NSynthDataset(corpus[RESUME_TRAIN:])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs, launches = {}, None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, kw in (("single", {}), ("dp", dict(data_parallel=True)),
                             ("dp_shard", dict(data_parallel=True, shard_corpus=True))):
                train.set_epoch(0)
                model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 82,
                                                     device=DEVICE)
                ckpt = Path(tmp) / name
                with TrainerProbe(torch) as probe:  # around the Trainer: it times the steps _build makes
                    trainer = Trainer(model, train, val,
                                      config=TrainerConfig(checkpoint_dir=str(ckpt), max_epochs=DP1_EPOCHS, **kw))
                    for c in counters.values():
                        c.launches = 0  # just before the main path
                    t0 = time.perf_counter()
                    m = trainer.train()
                    wall = time.perf_counter() - t0
                mesh = trainer.mesh
                if name == "dp":
                    launches = {n: c.launches for n, c in counters.items()}  # just after
                    steps = len(m.iteration_losses)
                    dumps = len(list(ckpt.glob("samples/*/metadata_*.json")))
                    trainer_launch_check("dp1", launches, steps, len(probe.validates) + dumps)
                runs[name] = dict(s=wall, metrics=m, probe=probe.summary(), **run_state(trainer),
                                  mesh=None if mesh is None else dict(backend=mesh.backend, size=mesh.size,
                                                                      rank=mesh.rank, device=str(mesh.device)))
                if mesh is not None:
                    mesh.close()
                del model, trainer
                torch.cuda.empty_cache()
        model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 83, device=DEVICE)
        batch = torch.from_numpy(train_batch(SEED + 84, 2)).to(DEVICE)
        tunes = {}
        for name in ("single", "mesh"):
            mesh = make_mesh(1) if name == "mesh" else None
            tuner = VmappedGridTuner(model, mesh=mesh)
            state = tuner.init_grid(PARITY_GRID, seed=SEED + 85)
            losses = []
            for _ in range(2):
                state, loss = tuner.grid_step(state, batch, TEMPERATURE, SEED)
                losses.append(loss.cpu())
            tunes[name] = dict(losses=torch.stack(losses), params={n: p.cpu() for n, p in state.params.items()})
            if mesh is not None:
                tunes[name]["backend"] = mesh.backend
                mesh.close()
            del tuner, state
        del model
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    single = runs["single"]
    compared = {}
    for name in ("dp", "dp_shard"):
        run = runs[name]
        compared[name] = dict(
            losses_equal=all(getattr(run["metrics"], k) == getattr(single["metrics"], k)
                             for k in ("iteration_losses", "train_losses", "val_losses")),
            best_epoch=run["metrics"].best_epoch, counters=run["counters"], mesh=run["mesh"],
            params_differ=differing(run["params"], single["params"])[:10],
            moments_differ=differing(run["moments"], single["moments"])[:10],
            seconds=run["s"], step_ms_median=run["probe"]["step_ms_median"],
            step_ms_spread=run["probe"]["step_ms_spread"])
    tune_equal = (torch.equal(tunes["mesh"]["losses"], tunes["single"]["losses"])
                  and not differing(tunes["mesh"]["params"], tunes["single"]["params"]))
    emit("dp1", config=FLAGSHIP, clips=dict(train=RESUME_TRAIN, val=RESUME_VAL), epochs=DP1_EPOCHS, batch=4, group=12,
         accumulate=4, dtype="float32", cudnn_deterministic=True, launches=launches,
         single=dict(seconds=single["s"], step_ms_median=single["probe"]["step_ms_median"],
                     step_ms_spread=single["probe"]["step_ms_spread"], best_epoch=single["metrics"].best_epoch,
                     train_losses=single["metrics"].train_losses, val_losses=single["metrics"].val_losses),
         runs=compared, tuner=dict(grid=PARITY_GRID, anchors=2, steps=2, backend=tunes["mesh"]["backend"],
                                   losses=tunes["mesh"]["losses"].tolist(), bit_for_bit=tune_equal))
    check(all(math.isfinite(v) for v in single["metrics"].iteration_losses + single["metrics"].val_losses),
          "dp1: non-finite loss")
    for name, c in compared.items():
        check(c["mesh"]["backend"] == "nccl" and c["mesh"]["size"] == 1, f"dp1 {name}: mesh {c['mesh']}")
        check(c["losses_equal"] and c["best_epoch"] == single["metrics"].best_epoch
              and c["counters"] == single["counters"], f"dp1 {name}: the losses or counters differ from the run "
                                                       f"without data parallelism")
        check(not c["params_differ"] and not c["moments_differ"],
              f"dp1 {name}: parameters {c['params_differ']} or moments {c['moments_differ']} differ")
    check(tune_equal, "dp1: the tuner on a mesh of one differs from the tuner without one")
    return launches


def dp2_run(torch, model, mesh, corpus: np.ndarray, idx: np.ndarray, w: np.ndarray, counters) -> dict:
    """The dp2 work of one process (``mesh`` None: the world-1 reference):
    the first step's loss, components, gradient and encoder masks
    (``make_loss_and_grads``), the gradient of train_parity's surrogate
    through the same step (the spectral distance replaced by the mean over
    the clips of <recon, w>, so that the ranks' mean is the batch's), then
    DP2_STEPS indexed steps over the replicated corpus (each timed by CUDA
    events, the launch counters zeroed just before and read just after)
    and the accumulator they leave; with a mesh, the all-reduce of the
    gradient alone, timed."""
    from unittest import mock

    from topo_audio_autoencoder_torch import training
    from topo_audio_autoencoder_torch.models import encoder as encoder_mod
    from topo_audio_autoencoder_torch.parallel import mean_over_ranks, shard_batch
    from topo_audio_autoencoder_torch.training import train_step as train_step_mod

    device = next(model.parameters()).device
    corpus_dev = torch.from_numpy(corpus).to(device)
    batch = train_step_mod.gather_batch(corpus_dev, shard_batch(torch.from_numpy(idx[0]), mesh))
    masks, generate = [], encoder_mod.AudioEncoder.generate_complex

    def recorded(self, *a, **k):
        out = generate(self, *a, **k)
        masks.append([m.detach().cpu() for m in out.masks])
        return out

    with mock.patch.object(encoder_mod.AudioEncoder, "generate_complex", recorded):
        total, comps, grads = training.make_loss_and_grads(model, mesh=mesh)(batch, TEMPERATURE, SEED, 0)
    w_rows = shard_batch(torch.from_numpy(w), mesh).to(device)

    def surrogate_loss(recon, target, aux, valid, weights, contrastive=None, **kw):
        val = (recon[:, 0] * w_rows[:, 0]).sum(-1).mean() + aux["binary_entropy"].mean() + aux["diversity"].mean()
        val = val + contrastive if contrastive is not None else val
        return val, {"total_loss": val}

    with mock.patch.object(train_step_mod, "autoencoder_loss", surrogate_loss):
        sur_val, _, sur_grads = training.make_loss_and_grads(model, mesh=mesh)(batch, TEMPERATURE, SEED, 0)
    opt = training.make_optimizer()  # accumulation 4: no update within DP2_STEPS steps
    step = training.make_indexed_train_step(model, opt, corpus_dev, mesh=mesh)
    state = training.create_train_state(model, opt)
    for c in counters.values():
        c.launches = 0  # just before the main path
    events, metrics = [], []
    for i in range(DP2_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, torch.from_numpy(idx[i]), TEMPERATURE, SEED)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}  # just after
    collective_ms = []  # host clock: gloo blocks the host until its copies back are done
    if mesh is not None:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean_over_ranks(list(grads.values()), mesh)
            torch.cuda.synchronize()
            collective_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(total=float(total), comps={k: float(v) for k, v in comps.items()},
                grads={n: g.cpu() for n, g in grads.items()}, masks=masks[0], surrogate=float(sur_val),
                surrogate_grads={n: g.cpu() for n, g in sur_grads.items()},
                losses=[{k: float(v) for k, v in m.items()} for m in metrics],
                acc={n: t.cpu() for n, t in state.opt_state.acc.items()}, mini_step=state.opt_state.mini_step,
                step_ms=[s.elapsed_time(e) for s, e in events], launches=launches, collective_ms=collective_ms,
                grad_bytes=sum(g.numel() * 4 for g in grads.values()))


def dp2_rank(rank: int, tmp: str) -> None:
    """One dp2 rank, in a process of its own: the card, a gloo group made
    through a file in ``tmp``, the mesh that adopts it, the weights from
    ``tmp``; saves what ``dp2_run`` returns (or the traceback) and whether
    JAX was imported."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    out = {}
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank, world_size=DP2_RANKS,
                                timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        try:
            import topo_audio_autoencoder_torch as port
            from topo_audio_autoencoder_torch.parallel import make_mesh, replicate

            mesh = make_mesh(DP2_RANKS)
            inputs = torch.load(Path(tmp) / "dp2_inputs.pt", weights_only=False)
            model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 90,
                                                 device=mesh.device)
            model.load_state_dict(inputs["state_dict"])
            replicate(model, mesh)
            out = dp2_run(torch, model, mesh, inputs["corpus"], inputs["idx"], inputs["w"], launch_counters())
            out["mesh"] = dict(backend=mesh.backend, size=mesh.size, rank=mesh.rank, device=str(mesh.device))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    out["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    torch.save(out, Path(tmp) / f"dp2_{rank}.pt")


def phase_dp2(torch, port, training, counters) -> dict:
    """Two ranks on the one card over gloo against the world-1 step on the
    same weights, batch and seed: every step's loss (no update within the
    steps), the encoder masks of the first step bit for bit (each rank's
    rows of the global draw), the whole gradient (train_parity's bounds,
    the conditioning read from a 1e-6 nudge of the reference's batch), the
    accumulator the steps leave, rows 1-3 once a rank a step. The ranks are
    spawned processes with a deadline; a hung or failed rank fails the
    phase. Returns the launches summed over the ranks."""
    import multiprocessing

    from topo_audio_autoencoder_torch.training.train_step import gather_batch

    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 90, device=DEVICE)
    n_clips = DP2_B * TRAIN_G
    corpus = make_clips(n_clips, SEED + 91)[:, 0]
    rng = np.random.default_rng(SEED + 92)
    idx = np.stack([rng.permutation(n_clips).reshape(DP2_B, TRAIN_G) for _ in range(DP2_STEPS)])
    w = rng.standard_normal((DP2_B, 1, NUM_SAMPLES)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(state_dict={k: v.cpu() for k, v in model.state_dict().items()}, corpus=corpus, idx=idx,
                        w=w), Path(tmp) / "dp2_inputs.pt")
        nudged = training.make_loss_and_grads(model)(
            gather_batch(torch.from_numpy(corpus).to(DEVICE), torch.from_numpy(idx[0])) * np.float32(1 + FLOOR_NUDGE),
            TEMPERATURE, SEED, 0)[2]
        ref = dp2_run(torch, model, None, corpus, idx, w, counters)
        del model
        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=dp2_rank, args=(r, tmp), daemon=True) for r in range(DP2_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP2_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        wall = time.perf_counter() - t0
        check(not hung, f"dp2: ranks {hung} still running after {DP2_JOIN_S} s")
        outs = []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"dp2_{r}.pt"
            check(path.exists(), f"dp2: rank {r} exited {p.exitcode} without a result")
            outs.append(torch.load(path, weights_only=False))
    for r, o in enumerate(outs):
        check("error" not in o, f"dp2: rank {r} failed:\n{o.get('error')}")
        check(not o["jax_imported"], f"dp2: rank {r} imported JAX")

    def l2(ts):
        return math.sqrt(sum(float((t.double() ** 2).sum()) for t in ts))

    want = ref["grads"]
    grad_err = l2(outs[0]["grads"][n] - want[n] for n in want) / l2(want.values())
    floor = l2(nudged[n].cpu() - want[n] for n in want) / l2(want.values())
    conditioned = floor <= PARITY_GRAD_REL_L2
    acc_err = l2(outs[0]["acc"][n] - ref["acc"][n] for n in want) / l2(ref["acc"].values())
    loss_err = max(abs(o["losses"][i][k] - ref["losses"][i][k]) / max(abs(ref["losses"][i][k]), 1e-6)
                   for o in outs for i in range(DP2_STEPS) for k in ref["losses"][i] if k != "grad_norms")
    first_err = max(abs(o["total"] - ref["total"]) / abs(ref["total"]) for o in outs)
    scale = max(float(g.abs().max()) for g in ref["surrogate_grads"].values())
    leaf_err = {n: float((outs[0]["surrogate_grads"][n] - g).abs().max()) / scale
                for n, g in ref["surrogate_grads"].items()}
    worst = max(leaf_err, key=leaf_err.get)
    sur_err = max(abs(o["surrogate"] - ref["surrogate"]) / abs(ref["surrogate"]) for o in outs)
    masks = [torch.cat([o["masks"][k] for o in outs]) for k in range(len(ref["masks"]))]
    flips = sum(int((a != b).sum()) for a, b in zip(masks, ref["masks"]))
    same_on_ranks = not differing(outs[0]["grads"], outs[1]["grads"])
    per_rank = [dict(mesh=o["mesh"], step_ms=o["step_ms"], step_ms_median=statistics.median(o["step_ms"]),
                     collective_ms=o["collective_ms"], launches={k: v for k, v in o["launches"].items() if v})
                for o in outs]
    emit("dp2", config=FLAGSHIP, ranks=DP2_RANKS, backend="gloo", global_batch=DP2_B, group=TRAIN_G, dtype="float32",
         steps=DP2_STEPS, accumulate=4, wall_s=wall, grad_bytes=outs[0]["grad_bytes"], per_rank=per_rank,
         reference=dict(step_ms=ref["step_ms"], step_ms_median=statistics.median(ref["step_ms"])),
         loss_rel_err=loss_err, first_loss_rel_err=first_err, loss_rtol=PARITY_LOSS_RTOL,
         grad_rel_l2=grad_err, grad_nudge_floor=floor, grad_conditioned=conditioned,
         grad_rel_l2_tol=PARITY_GRAD_REL_L2, accumulator_rel_l2=acc_err, grads_equal_on_ranks=same_on_ranks,
         surrogate_value_rel_err=sur_err, surrogate_leaf_max_err=leaf_err[worst], surrogate_worst_leaf=worst,
         surrogate_tol=SURROGATE_TOL,
         mask_bits=sum(int(m.numel()) for m in masks), mask_bits_differing=flips,
         active_mask_bits=sum(int(m.sum()) for m in masks))
    check(flips == 0, f"dp2: {flips} encoder mask bits differ from the world-1 step")
    check(first_err <= PARITY_LOSS_RTOL and loss_err <= PARITY_LOSS_RTOL,
          f"dp2: loss {first_err}, step losses {loss_err} against the world-1 step")
    check(same_on_ranks, "dp2: the ranks hold different averaged gradients")
    check(sur_err <= PARITY_LOSS_RTOL and leaf_err[worst] <= SURROGATE_TOL,
          f"dp2: surrogate value {sur_err}, leaf {worst} {leaf_err[worst]} against the world-1 step")
    check(grad_err <= PARITY_GRAD_REL_L2 or not conditioned, f"dp2: gradient rel L2 {grad_err} (nudge floor {floor})")
    check(acc_err <= PARITY_GRAD_REL_L2 or not conditioned, f"dp2: accumulator rel L2 {acc_err} (nudge floor {floor})")
    check(all(o["mini_step"] == DP2_STEPS for o in (ref, *outs)), "dp2: the accumulator's micro-step count")
    for r, o in enumerate(outs):
        want_launches = {n: DP2_STEPS for n in ("masked_attention_fwd", "masked_attention_bwd", *GUMBEL_EXPECT,
                                                *PQMF_KERNELS)}
        got = {k: v for k, v in o["launches"].items() if v}
        check(got == want_launches, f"dp2 rank {r}: launched {got}, not {want_launches}")
    return {n: sum(o["launches"][n] for o in outs) for n in outs[0]["launches"]}


def phase_packed_repeat(torch, port, training, counters) -> None:
    """Two identical n=32 packed train steps (fp32, B=16 x G=3, cuDNN
    deterministic): two copies of one seeded model each take the step's forward
    and backward on the same batch and then PACKED_REPEAT_STEPS train steps
    on the same batches; the loss, every gradient leaf, every step's loss
    components and the updated parameters must be equal bit for bit. The
    step median (host clock) and one profiled step's device ms, beside
    the packed step's earlier range on an H100 80GB HBM3 at 700 W, cuDNN
    default (EARLIER_PACKED_STEP)."""
    batches = [torch.from_numpy(make_clips(TRAIN_B * TRAIN_G, SEED + 700 + i)
                                .reshape(TRAIN_B, TRAIN_G, 1, NUM_SAMPLES)).to(DEVICE)
               for i in range(PACKED_REPEAT_STEPS + 1)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    model = port.AudioAutoencoder.create(**PACKED, **PACKED_OPTIONS, num_samples=NUM_SAMPLES, seed=SEED + 60,
                                         device=DEVICE)
    models = [model, copy.deepcopy(model)]
    del model
    try:
        while models:
            model = models.pop(0)
            total, _, grads = training.make_loss_and_grads(model)(batches[0], TEMPERATURE, SEED, 0)
            grads = {n: g.cpu() for n, g in grads.items()}
            opt = port.make_optimizer(accumulate_grad_batches=1)
            state, step = port.create_train_state(model, opt), port.make_train_step(model, opt)
            state, times, components, launches = timed_steps(torch, step, state, batches, counters)
            runs.append(dict(total=float(total), grads=grads, times=times, components=components,
                             launches=launches,
                             params={n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}))
            if len(runs) == 2:
                profiled = trace_call(torch, lambda: step(state, batches[0], TEMPERATURE, SEED),
                                      "one n=32 packed train step (fp32, B=16, G=3, cuDNN deterministic)")
            del model, opt, state, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = runs
    grads_differ = sorted(n for n in a["grads"] if not torch.equal(a["grads"][n], b["grads"][n]))
    params_differ = sorted(n for n in a["params"] if not torch.equal(a["params"][n], b["params"][n]))
    flat = [torch.cat([r["grads"][n].reshape(-1) for n in a["grads"]]) for r in runs]
    times = a["times"][1:] + b["times"][1:]
    emit("packed_repeat", config=PACKED, options=PACKED_OPTIONS, anchors=TRAIN_B, group=TRAIN_G, dtype="float32",
         cudnn_deterministic=True, steps=len(batches), losses=[r["total"] for r in runs],
         grad_leaves=len(a["grads"]), grads_differ=grads_differ[:10], n_grads_differ=len(grads_differ),
         grad_rel_l2=float((flat[0] - flat[1]).norm() / flat[0].norm()),
         params_differ=params_differ[:10], n_params_differ=len(params_differ),
         step_ms=[r["times"] for r in runs], step_ms_median=statistics.median(times),
         step_ms_spread=[min(times), max(times)], device_ms=profiled["device_ms"],
         kernel_launches=profiled["kernel_launches"], launches=a["launches"],
         earlier_train_packed=EARLIER_PACKED_STEP)
    check(a["total"] == b["total"] and a["components"] == b["components"], "packed_repeat: the losses differ")
    check(not grads_differ, f"packed_repeat: {len(grads_differ)} gradient leaves differ: {grads_differ[:5]}")
    check(not params_differ, f"packed_repeat: {len(params_differ)} parameters differ after the steps")
    for name, per_step in {"masked_attention_fwd": 1, "masked_attention_bwd": 1, **GUMBEL_EXPECT,
                           **PQMF_PER_STEP}.items():
        check(a["launches"][name] == per_step * len(batches),
              f"packed_repeat: {name} launched {a['launches'][name]} times in {len(batches)} steps")


def phase_flat_adam(torch, port) -> dict:
    """make_optimizer(flat_groups=True) against the per-leaf optimizer, both
    through the multi-tensor clip + Adam kernels, and the per-leaf
    optimizer on the plain path (ops.multi_tensor_adam.clip_adam_plain, the
    update as it was before the kernels), on the flagship's parameters: the
    same gradients (seeded normals on the card; one update's micro-steps
    1e5 times larger, so that its clip fires) through the three for
    FLAT_ADAM_UPDATES updates, with accumulation 1 and 4. The two layouts'
    parameters and moments equal bit for bit; the kernels' equal the plain
    path's bit for bit before the clipped update and within ADAM_CLIP_RTOL
    from it (the norm's order of summation); each applied update's kernel
    launches and device ms (torch.profiler) for the three, recorded; then
    one update's ms (CUDA events) through the kernels and the plain path,
    beside the kernels' bound. Returns the kernels' result for the kernels
    line."""
    from unittest import mock

    from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta
    from topo_audio_autoencoder_torch.training import train_step as ts

    record = {}
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 70, device=DEVICE)
    # per leaf and flat through the kernels (equal bit for bit after each
    # accumulation setting, or the run fails), per leaf on the plain path
    # (set to the kernels' parameters before each setting)
    models = [model, copy.deepcopy(model), copy.deepcopy(model)]
    layouts = ("per_leaf", "flat", "plain")
    worst = 0.0
    for accumulate in (1, 4):
        models[2].load_state_dict(models[0].state_dict())
        start = {n: p.detach().clone() for n, p in models[0].named_parameters()}
        opts = [port.make_optimizer(accumulate_grad_batches=accumulate, flat_groups=flat)
                for flat in (False, True, False)]
        states = [opt.init(m) for opt, m in zip(opts, models)]
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 71)
        per_update = {layout: [] for layout in layouts}
        norms, plain_gaps = [], []
        for i in range(FLAT_ADAM_UPDATES * accumulate):
            scale = 1e2 if i // accumulate == 1 else 1e-3
            grads = {n: torch.randn(p.shape, generator=gen, device=DEVICE) * scale
                     for n, p in models[0].named_parameters()}
            norms.append(float(torch.sqrt(sum((g * g).sum() for g in grads.values()))))
            for layout, opt, state, m in zip(layouts, opts, states, models):
                given = {n: g.clone() for n, g in grads.items()}
                with (mock.patch.object(ts, "multi_tensor_clip_adam", mta.clip_adam_plain) if layout == "plain"
                      else contextlib.nullcontext()):
                    if i % accumulate == accumulate - 1:
                        before = mta.multi_tensor_clip_adam.launches
                        fields, _, _ = profile_call(torch, padded(torch, lambda: opt.update(given, state, m)))
                        per_update[layout].append({**{k: fields[k] for k in ("device_ms", "kernel_launches")},
                                                   "wrapper_launches": mta.multi_tensor_clip_adam.launches - before})
                    else:
                        opt.update(given, state, m)
            if i % accumulate == accumulate - 1:
                plain_gaps.append(optimizer_gap(torch, models[0], models[2], states[0], states[2], start))
        torch.cuda.synchronize()
        per_leaf, flat, plain = states
        params_differ = [n for (n, p), q in zip(models[0].named_parameters(), models[1].parameters())
                         if not torch.equal(p, q)]
        groups = opts[1].groups(dict(models[0].named_parameters()))
        moments_differ = [(g, what) for g, names in groups.items() for what in ("mu", "nu")
                          if not torch.equal(getattr(flat, what)[g],
                                             torch.cat([getattr(per_leaf, what)[n].reshape(-1) for n in names]))]
        record[accumulate] = dict(updates=per_update, grad_norms=norms, params_differ=params_differ[:10],
                                  moments_differ=moments_differ, count=(per_leaf.count, flat.count, plain.count),
                                  kernels_against_plain=plain_gaps)
        check(not params_differ and not moments_differ,
              f"flat_adam (accumulation {accumulate}): parameters {params_differ[:5]} or moments "
              f"{moments_differ} differ")
        check(per_leaf.count == flat.count == plain.count == FLAT_ADAM_UPDATES
              and max(norms) > opts[0].max_norm > min(norms),
              f"flat_adam: counts {per_leaf.count}, {flat.count}, {plain.count}; norms {min(norms)}-{max(norms)}")
        check(plain_gaps[0]["leaves_differ"] == 0,
              f"flat_adam (accumulation {accumulate}): the kernels' first update differs from the plain path's "
              f"in {plain_gaps[0]['leaves_differ']} leaves")
        check(all(g["worst"] <= ADAM_CLIP_RTOL for g in plain_gaps),
              f"flat_adam (accumulation {accumulate}): the kernels against the plain path {plain_gaps}")
        check(all(u["wrapper_launches"] == 2 for layout in ("per_leaf", "flat")
                  for u in per_update[layout]) and all(u["wrapper_launches"] == 0 for u in per_update["plain"]),
              f"flat_adam: launches an update {per_update}")
        worst = max(worst, *(g["worst"] for g in plain_gaps))
        del opts, states
    # One update's ms by events at accumulation 1, kernels and plain path.
    opt = port.make_optimizer(accumulate_grad_batches=1)
    state = opt.init(models[0])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 72)
    grads = {n: torch.randn(p.shape, generator=gen, device=DEVICE) * 1e-3 for n, p in models[0].named_parameters()}
    ms = time_ms(lambda: opt.update(grads, state, models[0]))
    with mock.patch.object(ts, "multi_tensor_clip_adam", mta.clip_adam_plain):
        plain_ms = time_ms(lambda: opt.update(grads, state, models[0]), reps=10, warmup=2)
    elements = sum(p.numel() for p in models[0].parameters())
    bound_ms = elements * ADAM_BYTES_PER_ELEMENT / HBM_BPS * 1e3
    result = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                  library_ms=None)
    emit("flat_adam", config=FLAGSHIP, leaves=len(groups["encoder"]) + len(groups["decoder"]),
         groups={g: len(n) for g, n in groups.items()}, updates=FLAT_ADAM_UPDATES, elements=elements,
         runs={f"accumulate_{k}": v for k, v in record.items()}, clip_rtol=ADAM_CLIP_RTOL, **result)
    return result


def phase_pqmf_synthesis(torch, built) -> tuple:
    """Row 12: the PQMF synthesis kernel and its adjoint
    (csrc/pqmf_synthesis.cu) at the train step's shape (PQMF_SHAPE), fp32
    and bf16: against cuDNN (the inverse as it was: conv_transpose1d, the
    crop and the scale; its adjoint conv1d on the padded gradient) over the
    whole batch: fp32 within TOL_PQMF_FP32 relative L2 of cuDNN, two calls
    bit for bit; on the first PQMF_FP64_CLIPS clips, against the fp64 host
    synthesis (_np_synthesis) and its adjoint (M * _np_analysis), where each
    kernel's max and mean error must be no larger than cuDNN's (the plain
    versions' errors are reported beside them). Times (CUDA events, median
    of 30 behind a spin kernel) of each kernel, the plain versions and
    cuDNN, beside the bounds (bytes: input and output once; operations: 2 N
    FLOP an output sample, on the fp32 CUDA cores and on the bf16 tensor
    cores; the bound is the larger of the bytes and the operations at the
    input type's rate); each kernel instance's registers and local memory
    (none may spill) and the build's ptxas report. Returns the bf16
    forward's and adjoint's results for the kernels line."""
    import torch.nn.functional as F

    from topo_audio_autoencoder_torch.ops import pqmf

    b, length, m = PQMF_SHAPE
    bank = pqmf.PQMF(100.0, m).to(DEVICE)
    n = bank.taps
    pad = n // 2
    offsets, shift = pqmf.synthesis_offsets(m, n)
    k = PQMF_FP64_CLIPS
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 80)
    flops = 2.0 * b * length * m * n
    runs, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        sub = torch.randn(b, length, m, generator=gen, device=DEVICE).to(dtype)
        gy = torch.randn(b, length * m, generator=gen, device=DEVICE).to(dtype)
        z, gy_frames = sub.transpose(1, 2), gy.view(b, length, m)
        w = bank.filters.to(dtype)
        table = bank.kernel_table(dtype, DEVICE)

        def fwd():
            return bank.inverse(z)

        def bwd():
            return pqmf.synthesis_adjoint(gy_frames, table, shift)

        def library_fwd():
            return F.conv_transpose1d(z, w, stride=m)[..., pad:pad + length * m] * float(m)

        def library_bwd():
            return F.conv1d(F.pad(gy[:, None], (pad, n - pad - m)), w, stride=m) * float(m)

        y, y_again, gz, gz_again = fwd(), fwd(), bwd(), bwd()
        want_y, want_gz = library_fwd(), library_bwd().transpose(1, 2)
        torch.cuda.synchronize()
        check(torch.equal(y, y_again) and torch.equal(gz, gz_again),
              f"pqmf_synthesis {name}: two calls on the same inputs differ")
        check(y.shape == (b, 1, length * m) and gz.shape == (b, length, m) and y.dtype == gz.dtype == dtype,
              f"pqmf_synthesis {name}: shapes {tuple(y.shape)}, {tuple(gz.shape)}")
        hk = bank.filters.reshape(m, n).to(dtype).double().cpu().numpy()
        exact_y = torch.from_numpy(np.stack([pqmf._np_synthesis(c, hk, m) for c in z[:k].double().cpu().numpy()]))
        exact_gz = torch.from_numpy(np.stack([m * pqmf._np_analysis(g, hk, m).T
                                              for g in gy[:k].double().cpu().numpy()]))
        plain_y = pqmf.synthesis_plain(sub[:k], table, shift).reshape(k, length * m)
        plain_gz = pqmf.synthesis_adjoint_plain(gy_frames[:k], table, shift)
        errors = {}
        for what, got, want, plain, exact in (("fwd", y[:, 0], want_y[:, 0], plain_y, exact_y),
                                              ("bwd", gz, want_gz, plain_gz, exact_gz)):
            kernel_err = (got[:k].double().cpu() - exact).abs()
            library_err = (want[:k].double().cpu() - exact).abs()
            plain_err = (plain.double().cpu() - exact).abs()
            errors[what] = dict(kernel_max=float(kernel_err.max()), kernel_mean=float(kernel_err.mean()),
                                library_max=float(library_err.max()), library_mean=float(library_err.mean()),
                                plain_max=float(plain_err.max()), plain_mean=float(plain_err.mean()),
                                rel_l2_to_library=float((got.double() - want.double()).norm() / want.double().norm()))
        for what, e in errors.items():
            check(e["kernel_max"] <= e["library_max"] and e["kernel_mean"] <= e["library_mean"],
                  f"pqmf_synthesis {name} {what}: error against fp64 {e}, above cuDNN's")
            if dtype == torch.float32:
                check(e["rel_l2_to_library"] <= TOL_PQMF_FP32,
                      f"pqmf_synthesis {name} {what}: {e['rel_l2_to_library']} from cuDNN")
        del y_again, gz_again, want_y, want_gz, plain_y, plain_gz
        elt = sub.element_size()
        nbytes = 2.0 * b * length * m * elt + table.numel() * 4
        bounds = dict(bytes_ms=nbytes / HBM_BPS * 1e3, fp32_cores_ms=flops / PEAK_FLOPS["float32"] * 1e3,
                      bf16_tensor_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3)
        ops_ms = bounds["fp32_cores_ms" if dtype == torch.float32 else "bf16_tensor_ms"]
        bound_ms, bound_by = max((bounds["bytes_ms"], "bytes"), (ops_ms, "operations"))
        times = dict(fwd_ms=time_ms(fwd), bwd_ms=time_ms(bwd),
                     plain_fwd_ms=time_ms(lambda: pqmf.synthesis_plain(sub, table, shift), reps=10, warmup=2),
                     plain_bwd_ms=time_ms(lambda: pqmf.synthesis_adjoint_plain(gy_frames, table, shift), reps=10,
                                          warmup=2),
                     library_fwd_ms=time_ms(library_fwd), library_bwd_ms=time_ms(library_bwd))
        runs[name] = dict(errors=errors, bounds=bounds, **times)
        rows[name] = {
            what: dict(max_abs_err=errors[what]["kernel_max"], ms=times[f"{what}_ms"],
                       plain_ms=times[f"plain_{what}_ms"], bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=times[f"library_{what}_ms"])
            for what in ("fwd", "bwd")}
        del sub, gy, z, gy_frames, y, gz
    usage = resource_usage(cuobjdump_listing("pqmf_synthesis", "-res-usage"), pqmf_instance)
    spills = {name: u for name, u in usage.items() if u["local_bytes"]}
    check(bool(usage) and not spills, f"pqmf_synthesis kernels: {len(usage)} instances read, spills {spills}")
    report = built.get("pqmf_synthesis", {}).get("ptxas", "")
    emit("pqmf_synthesis", shape=dict(batch=b, frames=length, bands=m, taps=n, offsets=offsets, shift=shift),
         flops=flops, fp64_clips=k, runs=runs, usage=usage,
         ptxas=[line.strip() for line in report.splitlines() if "registers" in line or "spill" in line])
    return rows["bfloat16"]["fwd"], rows["bfloat16"]["bwd"]


def padded(torch, fn):
    """``fn`` between PROFILE_PAD_S of host sleep on each side, its device
    work finished before the second: a profile of it keeps the device
    events of a call far shorter than the clocks' offset."""

    def call():
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)

    return call


def optimizer_gap(torch, model, plain_model, state, plain_state, start) -> dict:
    """The kernels' optimizer (``model``, ``state``, per leaf) against the
    plain path's: the leaves whose parameter or moments differ at all, and
    the worst relative gap: a moment's over its leaf's largest, a
    parameter's beyond one fp32 spacing at its magnitude (its sum's
    rounding) over its leaf's largest change since ``start``."""
    differ, worst = 0, 0.0
    for (n, p), q in zip(model.named_parameters(), plain_model.parameters()):
        p, q = p.detach(), q.detach()
        if all(torch.equal(a, b) for a, b in ((p, q), (state.mu[n], plain_state.mu[n]),
                                              (state.nu[n], plain_state.nu[n]))):
            continue
        differ += 1
        spacing = torch.nextafter(q.abs(), torch.full_like(q, math.inf)) - q.abs()
        gaps = [((p - q).abs() - spacing).clamp(min=0).max() / (q - start[n]).abs().max()]
        gaps += [(a - b).abs().max() / b.abs().max() for a, b in ((state.mu[n], plain_state.mu[n]),
                                                                   (state.nu[n], plain_state.nu[n]))]
        worst = max(worst, *(float(g) for g in gaps))
    return {"leaves_differ": differ, "worst": worst}


def phase_examples(torch, port, counters) -> dict:
    """Both examples in-process on the card through their ``main``:
    examples/torch_train_synthetic.py on EXAMPLE_CLIPS clips for 1 epoch
    (its settings: bf16, B = 16, accumulation 1, the device corpus; rows
    1-3 once a step, row 1 also once an eval forward), then
    examples/torch_codec_roundtrip.py with fresh weights (n=20: 775 wire
    bytes) and with --packed from an n=32 packed Trainer-layout checkpoint
    (5,181 bytes): finite losses and waveforms; counters zeroed just
    before each run and read just after. Returns the runs' launches."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import torch_codec_roundtrip
    import torch_train_synthetic

    total = {name: 0 for name in counters}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        cwd = Path.cwd()
        for c in counters.values():
            c.launches = 0  # just before the main path
        t0 = time.perf_counter()
        with TrainerProbe(torch) as probe:
            try:
                os.chdir(tmp)
                metrics = torch_train_synthetic.main([str(EXAMPLE_CLIPS), "1"])
            finally:
                os.chdir(cwd)
        wall_s = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}  # just after
        ckpt = Path(tmp) / "checkpoints_synthetic_torch"
        dumps = len(list(ckpt.glob("samples/*/metadata_*.json")))
        steps = len(probe.steps)
        check(steps == EXAMPLE_CLIPS // 16 and len(metrics.train_losses) == 1
              and all(math.isfinite(v) for v in metrics.iteration_losses + metrics.val_losses)
              and (ckpt / "best" / "state.pt").exists(),
              f"examples: torch_train_synthetic: {steps} steps, losses {metrics.train_losses}, {metrics.val_losses}")
        trainer_launch_check("examples: torch_train_synthetic", launches, steps,
                             len(probe.validates) * -(-max(8, EXAMPLE_CLIPS // 8) // 16) + dumps)
        results["torch_train_synthetic"] = dict(
            clips=EXAMPLE_CLIPS, epochs=1, wall_s=wall_s, steps=steps, train_losses=metrics.train_losses,
            val_losses=metrics.val_losses, best_val_loss=metrics.best_val_loss, launches=launches,
            **probe.summary())
        for name in total:
            total[name] += launches[name]

        n32 = Path(tmp) / "n32"
        model = port.AudioAutoencoder.create(**PACKED, **PACKED_OPTIONS, num_samples=NUM_SAMPLES, seed=SEED + 80,
                                             device=DEVICE)
        port.CheckpointManager(n32).save("best", {"params": model.state_dict()}, extra={"model": model.geometry()})
        del model
        for what, argv, wire in (("fresh", [], EXAMPLE_WIRE_BYTES), ("packed", [str(n32), "--packed"],
                                                                      PACKED_WIRE_BYTES)):
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            out = torch_codec_roundtrip.main(argv)
            torch.cuda.synchronize()
            launches = {name: c.launches for name, c in counters.items()}
            check(out["wire_bytes"] == wire and out["finite"] and tuple(out["waveform"].shape) == (1, 1, NUM_SAMPLES),
                  f"examples: torch_codec_roundtrip {what}: {out['wire_bytes']} bytes, finite {out['finite']}")
            check(launches["masked_attention_fwd"] == launches["pqmf_synthesis"] == 1
                  and sum(launches.values()) == 2,
                  f"examples: torch_codec_roundtrip {what}: launches {launches}")
            results[f"torch_codec_roundtrip_{what}"] = dict(
                wall_s=time.perf_counter() - t0, bits=out["bits"], wire_bytes=out["wire_bytes"],
                spectral_distance=out["spectral_distance"], launches=launches)
            for name in total:
                total[name] += launches[name]
    emit("examples", **results)
    return total


def kernel_entry(name, source, replaces, launches, result) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": result["max_abs_err"], "ms": result["ms"],
        "plain_ms": result["plain_ms"], "bound_ms": result["bound_ms"],
        "bound_by": result["bound_by"], "library_ms": result["library_ms"],
    }


def launch_counters() -> dict:
    """Every kernel wrapper by the name its kernels line gives it; each
    counts its launches in ``.launches``."""
    from topo_audio_autoencoder_torch.ops import attention
    from topo_audio_autoencoder_torch.ops import combine_diag as cd
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc
    from topo_audio_autoencoder_torch.ops import fused_samplers as fused
    from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta
    from topo_audio_autoencoder_torch.ops import pqmf
    from topo_audio_autoencoder_torch.ops import sccn_combine as sc

    return {
        "masked_attention_fwd": attention.attention_fwd,
        "masked_attention_bwd": attention.attention_bwd,
        "binary_gumbel": fused.binary_gumbel_sample,
        "binary_gumbel_bwd": fused.binary_gumbel_bwd,
        "hard_concrete": hc.hard_concrete_sample,
        "hard_concrete_bwd": hc.hard_concrete_bwd,
        "hard_concrete_learned": hc.hard_concrete_learned_sample,
        "hard_concrete_learned_bwd": hc.hard_concrete_learned_bwd,
        "sccn_combine_fwd": sc.combine_fwd,
        "sccn_combine_bwd": sc.combine_bwd,
        "sccn_combine_packed_fwd": cd.packed_combine_fwd,
        "sccn_combine_packed_bwd": cd.packed_combine_bwd,
        "sccn_combine_copy": cd.combine_copy,
        "sccn_combine_matmul": cd.combine_matmul,
        "sccn_combine_nogelu": cd.combine_nogelu,
        "multi_tensor_adam": mta.multi_tensor_clip_adam,
        "pqmf_synthesis": pqmf.synthesis,
        "pqmf_synthesis_adjoint": pqmf.synthesis_adjoint,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    try:
        import topo_audio_autoencoder_torch as port
        from topo_audio_autoencoder_torch import cuda_build, training
        from topo_audio_autoencoder_torch.ops import attention
        from topo_audio_autoencoder_torch.ops import combine_diag as cd
        from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc
        from topo_audio_autoencoder_torch.ops import fused_samplers as fused
        from topo_audio_autoencoder_torch.ops import sccn_combine as sc
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repo root", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = cuda_build.build()
    build_s = time.perf_counter() - t0
    emit(
        "env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(),
        build_s=build_s, built=built,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    counters = launch_counters()
    try:
        phase_combine_build()
        phase_kernel(torch, attention)
        phase_kernel_bwd(torch, attention)
        n = FLAGSHIP["num_vertices"]
        n_simplices = sum(math.comb(n, k) for k in range(1, 5))
        sampler = phase_kernel_sampler(torch, fused, n_simplices)
        hc_kernels = phase_kernel_hc(torch, hc, fused, n_simplices)
        sampler_bwd = phase_kernel_sampler_bwd(torch, fused, hc, n_simplices)
        phase_sampler_launch(torch, fused, hc, n_simplices)
        combine = phase_kernel_combine(torch, sc)
        diag, diag_launches = phase_combine_diag(torch, sc, cd, counters)
        pqmf_fwd, pqmf_bwd = phase_pqmf_synthesis(torch, built)
        torch.cuda.empty_cache()
        model, codec = phase_serve(torch, port, counters)
        phase_main_attention(torch, attention, model, codec)
        phase_trace(torch, codec)
        phase_parity(torch, port, model, codec)
        del model, codec
        tmodel, tstate, tstep, tbatch, _ = phase_train(torch, port, counters)
        fwd, bwd = phase_train_kernels(torch, attention, tmodel, tstate, tstep, tbatch)
        phase_train_trace(torch, tstate, tstep, tbatch)
        del tmodel, tstate, tstep
        torch.cuda.empty_cache()
        phase_train_parity(torch, port, training)
        hmodel, hstate, hstep, hbatch, hc_launches = phase_train_model(
            torch, port, counters, "train_hc", HC_MODEL, HC_B, HC_G, HC_STEPS, training.LossWeights(),
            {"hard_concrete": 1, "hard_concrete_bwd": 1})
        phase_train_trace(torch, hstate, hstep, hbatch, what="one Hard Concrete hard train step (fp32, B=32, G=1)")
        del hmodel, hstate, hstep
        torch.cuda.empty_cache()
        _, _, _, _, learned_launches = phase_train_model(
            torch, port, counters, "train_hc_learned", HC_LEARNED_MODEL, TRAIN_B, TRAIN_G, HC_LEARNED_STEPS,
            training.LossWeights(l0_penalty=HC_L0_PENALTY),
            {"hard_concrete_learned": 1, "hard_concrete_learned_bwd": 1})
        torch.cuda.empty_cache()
        phase_encode_hc(torch, port, counters)
        phase_train_parity(torch, port, training, "train_parity_hc", HC_MODEL, group=HC_G)
        phase_train_parity(torch, port, training, "train_parity_hc_learned", HC_LEARNED_MODEL,
                           weights=training.LossWeights(l0_penalty=HC_L0_PENALTY))
        torch.cuda.empty_cache()
        fused_launches = phase_train_fused(torch, port, training, counters)
        torch.cuda.empty_cache()
        phase_train_packed(torch, port, attention, training, counters)
        torch.cuda.empty_cache()
        phase_train_packed_fused(torch, port, training, counters)
        torch.cuda.empty_cache()
        phase_train_parity(torch, port, training, "train_parity_packed", PACKED_OPTIONS, config=PACKED)
        torch.cuda.empty_cache()
        phase_packed_repeat(torch, port, training, counters)
        torch.cuda.empty_cache()
        phase_serve_packed(torch, port, counters)
        emit("packed_memberships", after="serve_packed", built=packed_memberships())
        torch.cuda.empty_cache()
        phase_baseline2(torch, port, counters)
        phase_train_parity(torch, port, training, "train_parity_jk", JK_OPTIONS)
        phase_train_model(torch, port, counters, "train_jk", JK_OPTIONS, TRAIN_B, TRAIN_G, JK_STEPS,
                          training.LossWeights(), GUMBEL_EXPECT)
        torch.cuda.empty_cache()
        phase_data(torch, port, counters)
        torch.cuda.empty_cache()
        trainer_launches = phase_trainer_main(torch, port, counters)
        torch.cuda.empty_cache()
        phase_trainer_resume(torch, port, counters)
        torch.cuda.empty_cache()
        phase_epoch_b128(torch, port, counters)
        torch.cuda.empty_cache()
        cli_launches = phase_codec_cli(torch, port, counters)
        tuner_launches = phase_tuner(torch, port, counters)
        phase_tuner_parity(torch, port, training, counters)
        torch.cuda.empty_cache()
        adam = phase_flat_adam(torch, port)
        example_launches = phase_examples(torch, port, counters)
        torch.cuda.empty_cache()
        phase_dp_philox(torch, fused, hc, n_simplices)
        dp1_launches = phase_dp1(torch, port, counters)
        dp2_launches = phase_dp2(torch, port, training, counters)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    emit("profiler", **PROFILES)
    csrc = "topo_audio_autoencoder_torch/csrc/"
    # The main paths, each counted from zero: trainer_main, the codec CLI
    # and the vmapped tuner (rows 1, 2 and 12), data parallelism's Trainer
    # over NCCL (dp1) and the two gloo ranks' steps (dp2), and the two
    # examples (rows 1-3 and 12).
    path_launches = {name: trainer_launches[name] + dp1_launches[name] + dp2_launches[name]
                     + example_launches[name]
                     for name in ("masked_attention_fwd", "masked_attention_bwd", *GUMBEL_EXPECT,
                                  "multi_tensor_adam", *PQMF_KERNELS)}
    for name in ("masked_attention_fwd", "masked_attention_bwd", *PQMF_KERNELS):
        path_launches[name] += cli_launches[name] + tuner_launches[name]
    print(json.dumps({"kernels": [
        kernel_entry("masked_attention_fwd", csrc + "masked_attention_fwd.cu",
                     "topo_audio_autoencoder_tpu/ops/attention.py:54",
                     path_launches["masked_attention_fwd"], fwd),
        kernel_entry("masked_attention_bwd", csrc + "masked_attention_bwd.cu",
                     "topo_audio_autoencoder_tpu/ops/attention.py:122",
                     path_launches["masked_attention_bwd"], bwd),
        kernel_entry("binary_gumbel", csrc + "binary_gumbel.cu",
                     "topo_audio_autoencoder_tpu/ops/pallas_kernels.py:216",
                     path_launches["binary_gumbel"], sampler),
        kernel_entry("hard_concrete", csrc + "hard_concrete.cu",
                     "topo_audio_autoencoder_tpu/ops/pallas_kernels.py:61",
                     hc_launches["hard_concrete"], hc_kernels["hard_concrete"]),
        kernel_entry("hard_concrete_learned", csrc + "hard_concrete.cu",
                     "topo_audio_autoencoder_tpu/ops/pallas_kernels.py:127",
                     learned_launches["hard_concrete_learned"], hc_kernels["hard_concrete_learned"]),
        kernel_entry("binary_gumbel_bwd", csrc + "binary_gumbel.cu",
                     "topo_audio_autoencoder_tpu/ops/pallas_kernels.py:286",
                     path_launches["binary_gumbel_bwd"], sampler_bwd["binary_gumbel_bwd"]),
        kernel_entry("hard_concrete_bwd", csrc + "hard_concrete.cu",
                     "topo_audio_autoencoder_tpu/ops/pallas_kernels.py:317",
                     hc_launches["hard_concrete_bwd"], sampler_bwd["hard_concrete_bwd"]),
        kernel_entry("hard_concrete_learned_bwd", csrc + "hard_concrete.cu",
                     "topo_audio_autoencoder_tpu/ops/pallas_kernels.py:367",
                     learned_launches["hard_concrete_learned_bwd"], sampler_bwd["hard_concrete_learned_bwd"]),
        kernel_entry("sccn_combine_fwd", csrc + "sccn_combine.cu", "topo_audio_autoencoder_tpu/ops/sccn_combine.py:90",
                     fused_launches["sccn_combine_fwd"], combine["fwd"]),
        kernel_entry("sccn_combine_bwd", csrc + "sccn_combine.cu", "topo_audio_autoencoder_tpu/ops/sccn_combine.py:128",
                     fused_launches["sccn_combine_bwd"], combine["bwd"]),
        *(kernel_entry(name, csrc + "sccn_combine.cu", "benchmarks/kernel_diag.py:" + line, diag_launches[name],
                       diag[name])
          for name, line in (("sccn_combine_packed_fwd", "125"), ("sccn_combine_packed_bwd", "166"),
                             ("sccn_combine_copy", "73"), ("sccn_combine_matmul", "80"),
                             ("sccn_combine_nogelu", "92"))),
        kernel_entry("multi_tensor_adam", csrc + "multi_tensor_adam.cu", None,
                     path_launches["multi_tensor_adam"], adam),
        kernel_entry("pqmf_synthesis", csrc + "pqmf_synthesis.cu", None, path_launches["pqmf_synthesis"], pqmf_fwd),
        kernel_entry("pqmf_synthesis_adjoint", csrc + "pqmf_synthesis.cu", None,
                     path_launches["pqmf_synthesis_adjoint"], pqmf_bwd),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
