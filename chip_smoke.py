#!/usr/bin/env python3
"""Drive the PyTorch port (nf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which exits non-zero when it fails:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the path from nf_tpu_torch/csrc/ (one nvcc
     per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card, with
     weights, ActNorm parameters and running statistics moved off
     identity by a seed:
       RealNVP and Glow fused stack: D = 2, 32 couplings, F = 32,
         B = 8192, and a ragged D = 3, n = 4, F = 64, B = 1000 (the
         tensor-core kernel), and D = 2, n = 4, F = 128, B = 1000 (the
         FFMA kernel that wider stacks keep);
       Flow++: 32 couplings, F = 32, K = 8, B = 8192, and a ragged
         n = 4, F = 64, K = 4, B = 1000;
       ResFlow (LipSwish betas also drawn from U(0.5, 1.5)): 'unbias'
         D = 2, 32 blocks, F = 32, B = 8192, the forward (fwd_ld) and
         the inverse (solve_ld) of its latent; the same with 'exact' for
         the solve alone; a ragged D = 3, n = 4, F = 64, B = 1000, D = 2,
         n = 4, F = 128, B = 1000 and the widest tiling, D = 2, n = 4,
         F = 256, B = 1000 (fragments streamed), for all three variants
         (the solve on fused_resflow_solve_kernel, a warp per 8 samples,
         up to F = 64, on the tiled variant at 128 and 256); with each
         solve's trip count per block and the probes' series lengths
         printed;
     forward z atol/rtol 1e-4, logdet atol 1e-3 (f32 sums in another
     order, compounded through 32 couplings); the Flow++ inverse runs on
     the forward's latent of the same data, as tests/test_pallas.py
     inverts the chain's output, with x atol 1e-2 and logdet atol 5e-3:
     the kernel's and the plain version's Newton solves meet the same
     root only within XTOL = 1e-5 per coupling, and 32 couplings of
     random weights expand that (max|dx| 4.8e-3 and max|dlogdet| 3.9e-3
     on an H100, where the plain version's own round trip x -> z -> x
     misses x by as much; the line "plain round trip" prints it); the
     ResFlow inverse x and logdet atol 1e-3 (the kernels stop each fixed
     point per 16-sample tile, the solve up to F = 64 per warp of 8
     samples, the plain version on the whole batch);
     the RealNVP and Glow stacks past the FFMA block at its usual tiling,
     shapes nf_tpu fuses (RealNVP D = 213 and Glow D = 111 at F = 32,
     RealNVP D = 29 and Glow D = 27 at F = 256, two couplings, B = 1000),
     through eval_program: each call one launch of the FFMA kernel on its
     16-sample tiling (at F = 32 of the cluster kernel, the faster there),
     never the eager chain, at the tolerances above;
     the wide paths (wide_paths), at B = 1000 through the entry points a
     user calls, each call's launches counted (one, on its kernel and
     path, the launch span's name) and held against its plain version at the
     tolerances above: RealNVP and Glow at D = 400 and 1024, F = 32, and
     RealNVP at D = 400 and 63 (BSDS300's patches), F = 256, two couplings
     (the cluster kernel: 4 blocks share 48 samples, 32 for Glow at D =
     1024, each holding its rows of the x tile in shared memory), through
     eval_program;
     ResFlow at (D, F) = (2, 512) and (16, 64), two blocks (the wide
     kernel, csrc/fused_resflow_wide.cu), fwd_ld and solve_ld through
     eval_program and the solve through the 'exact' program's inverse,
     each at the plan WIDE_RESFLOW_PLANS pins (clusters of 2 reading
     W2t's slabs from L2, 16 samples a cluster; one block holding all of
     W2t, 8 samples), printed with the rest of the plan; attention at (64, 256, 192)
     and (64, 64, 512) (the wide kernel, past D = 128) through
     ops.attention.attention, with PyTorch's SDPA within the same, and
     GatedAttn at filters = 768 (Flow++'s image couplings at
     base_filters = 768) on (16, 16, 16, 8) against the same module on
     the CPU within 1e-4; and every phase-3 and phase-4 case on the kernel
     and tiling it ran on before the wide paths (the tensor-core stack and the 16-sample
     ResFlow tiles at the headline, the warp solve, the FFMA TILES
     tiling, the one-pass attention in phase 6);
  4. the main path, for "realnvp", "glow", "flow++" and "resflow" in turn:
     build_model(name, (2,), "2d") on the card -> init(generator) ->
     (Glow / Flow++: ActNorm moved off identity by the seed) ->
     eval_program -> log_prob(x) and sample(8192), with every launch
     counter set to 0 just before and read just after (one launch of that
     model's kernel per call, none of any other), and the outputs checked
     (finite, round trip, against the eager chain on 256 samples: both
     draw ResFlow's probes for 256 samples from a generator seeded 0);
     then ResFlow with logdet="exact": one solve launch per inverse, none
     for the forward (the eager chain), against the eager chain;
     then MAF and Planar 2-D (D = 2, 32 layers, B = 8192; Planar's u, w,
     b and MAF's running statistics moved off init by the seed): the
     eager chain on the card, no launch of any kernel of the port (nf_tpu
     runs no Pallas kernel there), the outputs finite, the round trip
     within 1e-3, log p on 256 samples within 1e-4 of its largest
     magnitude of the same state's on the CPU (both also printed against
     the CPU's float64);
     then run.debug on the served path (debug_phase, its wall time
     printed): the RealNVP 2-D program with check_chain's probes raises
     FloatingPointError naming layer0:BatchNorm.forward on a batch of
     8192 with one NaN row, launching no fused_stack kernel (the eager
     chain), and serves finite rows as the same model's fused kernel
     does (both log p within 1e-4 of its largest magnitude of the same
     state's in float64 on the CPU); untagged, one fused_stack_fwd and one
     fused_stack_inv launch for log_prob and sample; then a model of
     the caller's own, registered with models.register and built by
     build_model: Squeeze1d -> 8 x [BatchNorm -> AffineCoupling, F = 32]
     -> Unsqueeze1d at D = 4, served on the eager chain (no launch), log p
     on 256 samples within 1e-4 of its largest magnitude of the same
     state's on the CPU;
     the coupling kernels (forward, inverse, backward) at (1024, 512),
     (1024, 1536) and a ragged (1000, 384), gain 0.7 and bias -0.1: y
     and x atol/rtol 1e-5, the row log-dets atol 1e-4 (up to 1536 terms
     summed in another order),
     gz0 and graw atol/rtol 1e-5, dgain and dbias rtol 1e-4 (B x N terms),
     and each coupling kernel's kernels per call at (1024, 512), counted
     as the kernel nodes of a CUDA graph of 20 calls (one, or the run
     fails);
     attention_fwd at (4096, L, 8), L = 256, 64, 16 (flowpp-img32x1's
     calls), (4096, 256, 12) (base_filters = 48), a ragged (1000, 49, 8),
     (64, 100, 32), (64, 1500, 8), (64, 100, 128) and (4, 16, 6): out
     atol/rtol 1e-5 against the plain version, and PyTorch's SDPA within
     the same;
     mix_log_cdf_inverse at (1024, 512, K = 8), a ragged (1000, 300,
     K = 5), K = 1 (300, 200), K = 33 (128, 384) and K = 64 (256, 512),
     inputs as tests/test_pallas.py: x atol/rtol 1e-4, log-det atol 1e-3,
     two launches bit for bit the same, the round trip to x within 1e-3
     on every element where the plain version's own holds (all of them
     past K = 1; at K = 1 a y rounded next to 0 or 1 loses x in the thin
     tail of a single logistic, for the plain version alike, and the run
     fails if that leaves out more than 0.1 % of the elements);
  5. the image main paths, bench.py's image zoo at full width (layers =
     32, base_filters = 32, 161 couplings): realnvp-img32x1 (32x32x1,
     6,818,978 parameters, halves 512 wide) and glow-img32x3 (32x32x3,
     8,380,754 parameters, an ActNorm and a PLU 1x1 conv before each
     coupling, halves 1536 wide), each:
     build_model on the card -> Trainer(seed 0).init_state on a batch of
     uniform(0.05, 0.95) pixels -> train_steps, K = 2 Adam steps at
     B = 1024 -> eval_program -> log_prob(1024 samples) and sample(1024),
     with the launch counters set to 0 just before and read just after
     each call (161 coupling_fwd per forward, 161 coupling_bwd per train
     step, 161 coupling_inv per inverse, no other kernel); the losses
     checked finite, the round trip printed; the peak memory of the train
     steps; log p and the first step's gradients on 64 samples
     (glow-img32x3: 16) held against the same model on the CPU (state
     copied after init_state),
     in f32 and in float64: log p within 1e-4 of its largest magnitude of
     the CPU's f32; the gradients within twice the CPU's own f32 error,
     both measured as relative L2 distance to the float64 gradients.
     cuDNN and the CPU sum each 3x3 conv in another order, and at random
     init the 161 couplings amplify f32 rounding: the CPU's f32 gradients
     are themselves several percent from float64 (8.6 % at base_filters
     = 8 on a CPU), so two f32 runs can only be held to the same error;
  6. the image Flow++ main path, flowpp-img32x1 (nf_tpu's Flow++ image
     model at its defaults at 32x32x1: 161 couplings, 20,461,106
     parameters): build_model on the card -> init(generator) -> ActNorm
     and the 1x1 convs moved off init by the seed -> eval_program (the
     eager chain) -> log_prob(1024 pixels) and sample(1024), each call's
     launches counted (161 attention_fwd, 64 / 64 / 33 at L = 256 / 64 /
     16, no other kernel); the outputs finite, the round trip on the
     data's latent printed (at random init the 161 couplings contract the
     data by about e^-11 per dimension, so the whole inverse expands each
     Newton solve's XTOL residual to O(1), on any device and in float64);
     on 16 samples against the same model on the CPU (state copied): log p
     within 1e-4 of its largest magnitude, and each of the 488 layers'
     inverse of its own output within 1e-3 of the CPU's and of its input;
     then mix_log_cdf_inverse through its entry point at (1024, 512,
     K = 8), one launch, the round trip within 1e-3;
  7. FFJORD and Flow++ variational dequantization, which run no kernel of
     the port (nf_tpu runs no Pallas kernel there), every call's launches
     counted (none, or flowpp-img32x1's 161 attention_fwd per forward):
     (a) FFJORD 2-D at the density zoo's shape (NETWORK_DEFAULTS["ffjord"]:
     3 x [ActNorm -> CNF], dopri5 at rtol / atol 1e-4, the adjoint,
     Hutchinson, base_filters 32): build_model on the card ->
     Trainer(seed 0).init_state on 1,024 samples of nf_tpu's "circles"
     density (made with numpy) -> train_steps, K = 4 Adam steps at
     B = 1024 -> eval_program -> log_prob(8192) and sample(8192); the
     losses and outputs finite, the round trip x -> z -> x within 1e-3 (two
     dopri5 solves at 1e-4); against the same state on the CPU, the CNFs'
     probes drawn on the CPU and injected on both: log p on 256 samples
     within 1e-4 of its largest magnitude, the first step's gradients no
     further from float64 than twice the CPU's own f32 error; printed: the
     wall ms per direction over 5 calls and fwd_inv_samples_per_s =
     8192 / (t_fwd + t_inv), the train step's wall ms,
     train_samples_per_s and peak memory, the dynamics evaluations and
     accepted / rejected steps per solve, and a profiled window's device
     idle share (a forward and a train step);
     (b) rk4, midpoint, bosha3, trace="exact" and backprop="normal" on the
     trained state at B = 8192: one forward and one inverse each, finite,
     log p on 256 samples against the CPU as in (a), the inverse of 256
     latents within 1e-3 of the CPU's (an accept decision at err ~ 1 can
     flip between two f32 sums, and the solves then differ by the solver's
     tolerance); 'normal' also one step's gradients against the adjoint's
     on the card, relative L2 within 1e-2 (the adjoint solves its backward
     on its own steps), printed;
     (c) FFJORD's image opt-in (allow_image), 16x16x1, 1 layer,
     base_filters 32, B = 64: one forward and one inverse, log p against
     the CPU as in (a), the round trip within 1e-3;
     (d) flowpp-img32x1 with var_dequant=True at full width (161
     couplings): Trainer.init_state -> K = 2 Adam steps at B = 256 (a cut
     from 1,024: the steps peak at 23.5 GiB at 256 on an H100, so 1,024
     would not fit 80 GB), its peak memory, the losses finite, the ELBO terms printed
     (-log q(u|x) and D log 256), Trainer.log_prob with a generator, an
     EvalProgram's forward raising ValueError (no generator), and the
     first step's log p and gradients on 4 samples against the CPU with
     the same injected dequantization noise, as in (a); then the trained
     state saved by save_checkpoint and scored by the held-out evaluator
     (nf_tpu_torch/evaluate.py: heldout_image_nll, network="flow++",
     vardequant=True, scan=False, remat=False, 1 draw of the 2,048
     synthetic held-out images in batches of 256), its attention_fwd
     launches counted (161 for init_state's forward, 161 per batch), the
     result finite and its discrete bits/dim 8 above the continuous;
  8. ResFlow training, no kernel of the port while it trains (nf_tpu's
     runs no Pallas kernel there), every call's launches counted:
     (a) ResFlow 2-D at the density zoo's shape (NETWORK_DEFAULTS
     ["resflow"]: 32 x [ActNorm -> i-ResNet block], F = 32, coeff 0.9,
     'unbias'): build_model on the card -> Trainer(seed 0).init_state on
     1,024 "circles" samples -> train_steps, K = 8 Adam steps at B = 1024
     (bench.py:35-36; the memory-saved Function, one power iteration per
     step) -> u, v and the LipSwish betas checked moved off their values
     after init_state -> eval_program -> log_prob(8192) and sample(8192),
     one fwd_ld and one solve_ld launch, the round trip within 1e-3; both
     kernels held against their plain versions on the trained weights
     (the limits of phase 3); the first step's log p (and eval log p
     through the program) on 256 samples of init_state's weights against
     the CPU, the training draws and the serving probes drawn on the CPU
     and injected on both: within 1e-4 of the largest |log p|, the
     gradients' relative L2 to float64 within twice the CPU's own or
     1e-5, whichever is larger;
     (b) resflow-img32x1: build_model("resflow", (32, 32, 1), "image")
     with the zoo's config and allow_image (32 conv blocks on 16x16x4,
     width 32, 371,136 parameters) -> init_state -> K = 4 Adam steps at
     B = 1024 -> eval_program (the eager chain) -> log_prob(1024) and
     sample(1024); the round trip within 1e-3 (nf_tpu's own), the inverse
     of 16 latents against the CPU's within 1e-3 with the same probes, and
     the parity checks of (a) on 16 samples;
     each printed with ms per Adam step, train_samples_per_s, the steps'
     peak memory, ms per direction, the serving rate, the fixed-point
     trips per block of an inverse, the series lengths the training drew
     and the serving probes', and a profiled step's (and image forward's)
     device idle share and longest kernels;
  9. nf_tpu's production image shape: realnvp-img32x1 and glow-img32x3
     built as bench.py:239-243 builds them (scan=True, remat=True: each
     32-coupling stage folded into 16 ScannedChain blocks, the last stage
     16 blocks and a plain tail of one coupling), each: build_model ->
     Trainer.init_state (161 coupling_fwd) -> the first step's gradients
     and buffers on the same weights and batch against the unrolled,
     non-rematted model (cuDNN deterministic: relative L2 within 1e-6,
     the buffers equal, moved once) -> K = 2 Adam steps at B = 1024 (321
     coupling_fwd and 161 coupling_bwd per step: every rematted coupling's
     forward runs again in the backward, the tail's once) with their peak
     memory -> eval_program -> log_prob / sample at B = 1024 (161
     coupling_fwd / coupling_inv), the round trip within 1e-3 (nf_tpu's
     own); then realnvp-img32x1 with compute_dtype="bfloat16" (scan +
     remat) the same way, its first loss within 5e-2 (relative) of the
     f32 model's on the same weights and batch, its trained log p on 16
     samples within 1e-2 of the largest |log p| of the CPU port's bf16
     path, and one forward with matmul_precision="bfloat16" against f32
     (the largest difference printed, the precision set back to f32
     after); then a checkpoint round trip: realnvp-img32x1 (scan + remat)
     trains 2 steps and saves in nf_tpu's format, a fresh model loads the
     file (its fingerprint the port's), and step 3 on both (cuDNN
     deterministic) leaves the same parameters, buffers and Adam moments
     within 1e-6 (bitwise printed);
 10. the training CLI (nf_tpu_torch/main.py), in a temporary working
     directory: (a) main(["network=realnvp", "run.distrib=mnist",
     "run.dequantize=true", "train.steps=4", "run.display=1",
     "run.seed=0"]) on the card: realnvp-img32x1 at full width and the
     CLI's default train.samples = 1024 on the synthetic MNIST images
     (no data files: nf_tpu's fallback), its launches counted (for each
     of the chain's 161 couplings one coupling_fwd in init_state, one
     coupling_fwd and one coupling_bwd per step, and one coupling_inv for
     the report's 64 samples at step 1, no other kernel); the three image
     metric tags in metrics.jsonl, every value finite; the report's
     y_data_000001.jpg and y_image_000001.jpg and their _latest copies
     read by the port's own JPEG header parse (SOI, SOF0 265 x 265 x 1,
     EOI); then train.steps=6 run.resume=auto, which must re-enter the run
     directory (init_state's forward, two steps and the step-5 report
     counted the same way, its files at step 5), and latest.npz loaded
     back through the port at step 6, log p of 64 pixels finite;
     utils/profiling.trace round one forward of the reloaded model, its
     trace file written and naming launch.coupling_fwd; the host's ms per
     FlowDataLoader.next_batch at 1024 rows (moons, and synthetic MNIST
     dequantized) printed beside the data tier; (b) main(["network=realnvp",
     "run.distrib=moons", "run.display=0.6", "run.seed=0",
     "train.steps=60"]) (RealNVP 2-D at the default width, B = 1024: the
     eager chain trains, no kernel), its four report panels at step 1
     read back (600 x 600 x 3), the data tier and the ms per step between
     the metric records of steps 1 and 60 printed; (c) the same
     overrides through "python -m nf_tpu_torch.parallel.launch
     nf_tpu_torch/main.py" in a subprocess (300 s limit) under RANK=0
     WORLD_SIZE=1 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=<free>:
     a one-rank NCCL group, which forms no mesh (nf_tpu's main.py forms
     one only past one device): 0 all-reduces and 0 broadcasts, the
     losses (b)'s bit for bit; (d) a one-rank NCCL group in this process
     and Trainer(mesh=make_mesh()) on RealNVP 2-D at the default width,
     5 Adam steps on moons at B = 1024 (the gradient all-reduce, the
     reduced batch moments and the init broadcast on the card) against
     the plain Trainer's steps: losses and every parameter and buffer
     bit for bit; (e) the held-out evaluators (nf_tpu_torch/evaluate.py)
     on the checkpoints (a) and (b) wrote: heldout_nll("realnvp", (b)'s
     latest.npz, "moons") over the 16,384 held-out rows on the card, no
     kernel launched (the eager chain, as nf_tpu's Trainer.log_prob), and
     the same on the CPU, within 1e-5 relative; heldout_image_nll on
     (a)'s latest.npz (step 6, trained unrolled: scan=False, remat=False)
     over the 2,048 held-out images and 1 uniform dequantization (the
     evaluator's default is 4; one keeps the phase inside the script's
     time), its coupling_fwd launches exactly 161 x (1 + 8) (init_state's
     forward, then 8 batches of 256 per draw) and no other kernel, the
     first 16 images of draw 0 scored again on the CPU from the same
     file, within 1e-4 of the largest |log p|; nats, both bits/dim and the
     seconds printed;
 11. time each kernel (CUDA events over back-to-back launches, warm L2 as
     in a serving loop, the RealNVP and Glow stacks also in a CUDA graph
     and by their profiler records; the coupling kernels by their own
     device time per launch, the mean over a profiler window's records,
     over 8 input sets cycled, 67 MB, past the 50 MB L2; attention and the
     mixture inverse, their plain versions, the coupling kernels' plain
     versions and SDPA by calls captured in a CUDA graph, warm), its plain
     version (the coupling kernels at both image tiers' shapes) and, per
     model, the serving rate fwd_inv_samples_per_s =
     8192 / (t_fwd + t_inv), bench.py's definition; print one main_path
     line per model, its device idle share from its kernels' launches
     (the wrappers' counts) times their ms over the wall time (RealNVP and
     Glow also with the host's own cost per EvalProgram call and per
     kernel-wrapper call, timed up to the last call's return before a
     synchronize), MAF's and Planar's (the eager chain: wall ms per call
     over 5 calls), the ResFlow 'exact' program's wall time per direction
     and its device idle share (profiler records, with the share of the
     solve launches the profiler kept); for each image
     tier eval_fwd_inv_samples_per_s = 1024 / (t_fwd + t_inv) and
     train_samples_per_s = K B / t_chunk
     (bench.py:269, :327) and the same for phase 9's three trainings
     beside the unrolled tier's numbers of this run, each with its device
     idle share and the
     coupling kernels' share of device time; for flowpp-img32x1
     eval_fwd_inv_samples_per_s with its device idle share and the
     attention kernels' share of device time (these from profiler
     records, each with the share of the kernel's launches the profiler
     kept a record of); attention's entry summed
     over a pass's 161 calls, beside SDPA's time (library_ms); then the
     kernels line with each kernel's bounds (bound_ms with every
     multiply-add at the f32 FFMA rate, bound_tc_ms with them on the tensor
     cores in 3xTF32 at 165 TFLOP/s) and its share of the bound of the units
     it runs its products on, which fails the run above 1; the ResFlow
     entries also give their launch's blocks and the blocks one SM holds;
     the series kernels' the warps on the least loaded SM, which fails the
     run below 8, the solve kernel's its block's warps, ring slots and the
     weight bytes copied from L2 into shared memory per call, and the run
     fails unless its blocks fit one wave with a block on every SM; the
     mixture inverse's entry its registers, blocks per SM, rows per block
     and the lane slots its warps run under lane refill
     (warp_newton_evaluations) beside one element per lane's; the
     RealNVP and Glow entries their kernel variant, the blocks one SM
     holds and the bytes of weights copied from L2 into shared memory per
     direction; the coupling kernels their kernels per call (counted in
     phase 3); the wide paths' entries (fused_stack_wide_*,
     fused_stack_glow_wide_*, fused_resflow_wide_*, attention_fwd_wide):
     each shape's kernel (its launches in a CUDA graph, graph_ms, and
     back to back), plain version and (attention) SDPA timed by
     CUDA events, summed per kernel with per_shape beside, launches from
     their phase-3 run; the ResFlow ones also each shape's plan (phase 3
     prints beside it the plan's count of weight bytes read from L2 a
     call, planned_l2_weight_bytes: fused_resflow.wide_weight_bytes, not
     a measurement), and their share is against the tensor-core bound;
     and utils/profiling.roofline_estimate of the RealNVP 2-D serving pair
     (forward and inverse at B = 8192, 32 couplings), counted on the CPU,
     beside stack_work's count and the kernels' and the EvalProgram's
     measured time on the card;
 12. print {"ok": true, "device": {...}} as the last line.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8192
SEED = 0
Z_TOL = dict(atol=1e-4, rtol=1e-4)
LD_ATOL = 1e-3
# Flow++ inverse: two Newton solves agree within XTOL per coupling,
# expanded through 32 couplings (see phase 3 above)
FLOWPP_INV_X_ATOL = 1e-2
FLOWPP_INV_LD_ATOL = 5e-3
# ResFlow inverse: the kernel stops each fixed point per tile, the plain
# version on the whole batch; both only below ftol = 1e-4 (see phase 3)
RESFLOW_INV_ATOL = 1e-3
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
F32_FLOPS = 67e12
# f32-accurate products on the tensor cores: 3xTF32 is three TF32
# products at 495 TFLOP/s for each f32 product
TC_F32_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
SMS = 132
# special-function unit results per SM and clock, compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table)
SFU_PER_SM_CLOCK = 16
PLAIN_ITERS = 10
EXACT_ITERS = 10  # calls per direction timed of the ResFlow 'exact' program
# the image main paths: bench.py's image zoo at full width (bench.py:57-64),
# each with the samples held against the same model on the CPU
IMG_DIMS = (32, 32, 1)
IMG_BATCH = 1024
IMG_TRAIN_CHUNK = 2      # Adam steps a train chunk of the image tiers
IMG_COUPLINGS = 161
IMAGE_TIERS = [
    dict(label="realnvp-img32x1", network="realnvp", dims=IMG_DIMS, params=6_818_978,
         parity=64),
    dict(label="glow-img32x3", network="glow", dims=(32, 32, 3), params=8_380_754,
         parity=16)]
IMG_LOGP_RTOL = 1e-4     # of the largest |log p|
IMG_GRAD_FACTOR = 2.0    # the card's f32 gradient error over the CPU's
IMG_ITERS = 2            # calls per direction timed, after one warm-up call
IMG_TRAIN_TIMED = 1      # train chunks timed (the main path has warmed the step)
COUPLING_CASES = [(1024, 512), (1024, 1536), (1000, 384)]
COUPLING_WIDTHS = {"realnvp-img32x1": 512, "glow-img32x3": 1536}   # each tier's halves
COUPLING_TOL = dict(atol=1e-5, rtol=1e-5)
COUPLING_LD_ATOL = 1e-4
COUPLING_SUM_RTOL = 1e-4
COUPLING_SETS = 8        # input sets cycled when timing: 8 x 8.4 MB > 50 MB of L2
COUPLING_ITERS = 200
# the image Flow++ main path: flowpp-img32x1, nf_tpu's Flow++ image model at
# its defaults (nf_tpu/config.py:75-79: layers 32, mixtures 8,
# base_filters 32) at 32x32x1
FLOWPP_IMG_PARAMS = 20_461_106
FLOWPP_IMG_LENGTHS = {256: 64, 64: 64, 16: 33}   # attention calls per pass, by L
FLOWPP_IMG_PARITY = 16   # samples held against the same model on the CPU
# a layer's inverse, card vs CPU and against its input: each Newton solve
# stops within XTOL = 1e-5 of the root, its conditioner rounded otherwise
FLOWPP_IMG_INV_ATOL = 1e-3
FLOWPP_IMG_ITERS = 2     # calls per direction timed (the main path has warmed both)
ATTN_HEADS_BH = IMG_BATCH * 4    # B * heads: (4096, L, 8) on the main path
ATTN_CASES = [(ATTN_HEADS_BH, 256, 8), (ATTN_HEADS_BH, 64, 8), (ATTN_HEADS_BH, 16, 8),
              (ATTN_HEADS_BH, 256, 12), (1000, 49, 8), (64, 100, 32), (64, 1500, 8),
              (64, 100, 128), (4, 16, 6)]
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_ITERS = 20
# the mixture-CDF inverse: inputs and tolerances as tests/test_pallas.py
MIX_CASES = [(1024, 512, 8), (1000, 300, 5), (300, 200, 1), (128, 384, 33), (256, 512, 64)]
MIX_X_TOL = dict(atol=1e-4, rtol=1e-4)
MIX_LD_ATOL = 1e-3
MIX_ROUND_TRIP_ATOL = 1e-3
MIX_ITERS = 20

KERNEL_SOURCES = {
    "fused_stack_fwd": ("nf_tpu_torch/csrc/fused_stack_mma.cu",
                        "nf_tpu/ops/pallas/fused_stack.py:397"),
    "fused_stack_inv": ("nf_tpu_torch/csrc/fused_stack_mma.cu",
                        "nf_tpu/ops/pallas/fused_stack.py:422"),
    "fused_stack_glow_fwd": ("nf_tpu_torch/csrc/fused_stack_mma.cu",
                             "nf_tpu/ops/pallas/fused_stack.py:397"),
    "fused_stack_glow_inv": ("nf_tpu_torch/csrc/fused_stack_mma.cu",
                             "nf_tpu/ops/pallas/fused_stack.py:422"),
    "fused_flowpp_fwd": ("nf_tpu_torch/csrc/fused_flowpp.cu",
                         "nf_tpu/ops/pallas/fused_flowpp.py:312"),
    "fused_flowpp_inv": ("nf_tpu_torch/csrc/fused_flowpp.cu",
                         "nf_tpu/ops/pallas/fused_flowpp.py:328"),
    "fused_resflow_fwd_ld": ("nf_tpu_torch/csrc/fused_resflow.cu",
                             "nf_tpu/ops/pallas/fused_resflow.py:455"),
    "fused_resflow_solve_ld": ("nf_tpu_torch/csrc/fused_resflow.cu",
                               "nf_tpu/ops/pallas/fused_resflow.py:306"),
    "fused_resflow_solve": ("nf_tpu_torch/csrc/fused_resflow.cu",
                            "nf_tpu/ops/pallas/fused_resflow.py:184"),
    "coupling_fwd": ("nf_tpu_torch/csrc/coupling.cu", "nf_tpu/ops/pallas/coupling.py:34"),
    "coupling_inv": ("nf_tpu_torch/csrc/coupling.cu", "nf_tpu/ops/pallas/coupling.py:42"),
    "coupling_bwd": ("nf_tpu_torch/csrc/coupling.cu", "nf_tpu/ops/pallas/coupling.py:99"),
    "attention_fwd": ("nf_tpu_torch/csrc/attention.cu", "nf_tpu/ops/pallas/attention.py:42"),
    "mix_log_cdf_inverse": ("nf_tpu_torch/csrc/mixlogcdf.cu",
                            "nf_tpu/ops/pallas/mixlogcdf.py:51"),
    # the wide paths: the stack's cluster kernel, the ResFlow wide kernel
    # and the attention wide kernel, each under its own name here
    # (their wrappers count them under the names above; the launch spans
    # name the path)
    "fused_stack_wide_fwd": ("nf_tpu_torch/csrc/fused_stack_wide.cu",
                             "nf_tpu/ops/pallas/fused_stack.py:397"),
    "fused_stack_wide_inv": ("nf_tpu_torch/csrc/fused_stack_wide.cu",
                             "nf_tpu/ops/pallas/fused_stack.py:422"),
    "fused_stack_glow_wide_fwd": ("nf_tpu_torch/csrc/fused_stack_wide.cu",
                                  "nf_tpu/ops/pallas/fused_stack.py:397"),
    "fused_stack_glow_wide_inv": ("nf_tpu_torch/csrc/fused_stack_wide.cu",
                                  "nf_tpu/ops/pallas/fused_stack.py:422"),
    "fused_resflow_wide_fwd_ld": ("nf_tpu_torch/csrc/fused_resflow_wide.cu",
                                  "nf_tpu/ops/pallas/fused_resflow.py:455"),
    "fused_resflow_wide_solve_ld": ("nf_tpu_torch/csrc/fused_resflow_wide.cu",
                                    "nf_tpu/ops/pallas/fused_resflow.py:306"),
    "fused_resflow_wide_solve": ("nf_tpu_torch/csrc/fused_resflow_wide.cu",
                                 "nf_tpu/ops/pallas/fused_resflow.py:184"),
    "attention_fwd_wide": ("nf_tpu_torch/csrc/attention_wide.cu",
                           "nf_tpu/ops/pallas/attention.py:42"),
}
# each wide path's kernel name, by the name its wrapper counts it under
WIDE_NAMES = {"fused_stack_fwd": "fused_stack_wide_fwd", "fused_stack_inv": "fused_stack_wide_inv",
              "fused_stack_glow_fwd": "fused_stack_glow_wide_fwd",
              "fused_stack_glow_inv": "fused_stack_glow_wide_inv",
              "fused_resflow_fwd_ld": "fused_resflow_wide_fwd_ld",
              "fused_resflow_solve_ld": "fused_resflow_wide_solve_ld",
              "fused_resflow_solve": "fused_resflow_wide_solve",
              "attention_fwd": "attention_fwd_wide"}
# kernels whose F x F or attention products run on the tensor cores (3xTF32)
TENSOR_CORE_KERNELS = {"attention_fwd", "attention_fwd_wide", "fused_resflow_fwd_ld",
                       "fused_resflow_solve_ld",
                       "fused_resflow_solve", "fused_stack_fwd", "fused_stack_inv",
                       "fused_stack_glow_fwd", "fused_stack_glow_inv",
                       "fused_resflow_wide_fwd_ld", "fused_resflow_wide_solve_ld",
                       "fused_resflow_wide_solve"}
MODELS = {"realnvp": ("fused_stack_fwd", "fused_stack_inv"),
          "glow": ("fused_stack_glow_fwd", "fused_stack_glow_inv"),
          "flow++": ("fused_flowpp_fwd", "fused_flowpp_inv"),
          "resflow": ("fused_resflow_fwd_ld", "fused_resflow_solve_ld")}
# the fused RealNVP / Glow stack past its FFMA block at TILES' sample count,
# shapes nf_tpu fuses (model, D, couplings, F): the 16-sample tiling, at
# F = 32 the cluster kernel
WIDE_STACK_CASES = [("realnvp", 213, 2, 32), ("glow", 111, 2, 32), ("realnvp", 29, 2, 256),
                    ("glow", 27, 2, 256)]
WIDE_STACK_BATCH = 1000
# the wide paths, at B = WIDE_BATCH through eval_program (attention through
# its op and GatedAttn): the stack past the 16-sample tiling too (the
# cluster kernel; D = 63 at F = 256 a 63-dimensional tabular density such
# as BSDS300's patches), ResFlow past F = 256 or D = 8 (the wide kernel;
# (D, blocks, F)), attention past D = 128 (the wide kernel; (B * heads, L,
# D): GatedAttn's 4 heads at base_filters 768, 2048)
PAST_BLOCK_STACK_CASES = [("realnvp", 400, 2, 32), ("glow", 400, 2, 32),
                          ("realnvp", 1024, 2, 32), ("glow", 1024, 2, 32),
                          ("realnvp", 400, 2, 256), ("realnvp", 63, 2, 256)]
WIDE_RESFLOW_CASES = [(2, 2, 512), (16, 2, 64)]
# the plans wide_plan gives them at B = WIDE_BATCH: (cluster size, samples a
# cluster, where W2t lives); resflow_wide_probe.py clusters chose them
WIDE_RESFLOW_PLANS = {(2, 512): (2, 16, "streamed"), (16, 64): (1, 8, "one block")}
WIDE_ATTN_CASES = [(64, 256, 192), (64, 64, 512)]
WIDE_BATCH = 1000
WIDE_ITERS = 10          # kernel launches timed per shape (plain versions: 3)
# the 2-D models that run no kernel, as in nf_tpu (bench.py:41-46): the
# eager chain on the card
EAGER_MODELS = ("maf", "planar")
EAGER_PARITY = 256       # samples held against the same model on the CPU
# of the largest |log p|, as phase 5 holds the image tiers: through MAF's
# 32 layers the CPU's own f32 log p is 1.95e-4 from float64 at |log p| = 160
EAGER_LOGP_RTOL = 1e-4
EAGER_ITERS = 5          # calls per direction timed, after 3 warm-up calls
# ResFlow kernel checks: (estimator, D, blocks, F, B, directions)
RESFLOW_CASES = [("unbias", 2, 32, 32, BATCH, ("forward", "inverse")),
                 ("exact", 2, 32, 32, BATCH, ("solve",)),
                 ("unbias", 3, 4, 64, 1000, ("forward", "inverse", "solve")),
                 ("unbias", 2, 4, 128, 1000, ("forward", "inverse", "solve")),
                 ("unbias", 2, 4, 256, 1000, ("forward", "inverse", "solve"))]
RESFLOW_NAMES = {"forward": "fused_resflow_fwd_ld", "inverse": "fused_resflow_solve_ld",
                 "solve": "fused_resflow_solve"}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


@torch.no_grad()
def perturb(model, g, device):
    """Move ActNorm shift / log-scale and the running statistics off
    identity, so the host folding has teeth, and draw LipSwish betas from
    U(0.5, 1.5)."""
    from nf_tpu_torch.nets.spectral import LipSwish

    D = model.dims[-1]
    for name, p in model.named_parameters():
        if name.endswith((".log_scale", ".bias")) and p.dim() == 1 and p.numel() == D:
            p.copy_(0.3 * torch.randn(p.shape, generator=g, device=device))
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.3 * torch.randn(buf.shape, generator=g, device=device))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=g, device=device))
    for m in model.modules():
        if isinstance(m, LipSwish):
            m.beta.copy_(0.5 + torch.rand(m.beta.shape, generator=g, device=device))


@torch.no_grad()
def perturb_planar(model, g, device):
    """Planar u, w and b drawn from N(0, 0.5^2), so layers with w.u < -1
    take the u_hat constraint."""
    from nf_tpu_torch.bijectors.planar import PlanarTransform

    for m in model.modules():
        if isinstance(m, PlanarTransform):
            for p in (m.u, m.w, m.b):
                p.copy_(0.5 * torch.randn(p.shape, generator=g, device=device))


def perturbed_program(name, D, layers, F, device, seed, K=8, logdet="unbias"):
    """Serving program of a density model with random weights moved off
    their init values."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model(name, (D,), "2d",
                        NetworkConfig(layers=layers, base_filters=F, mixtures=K, logdet=logdet),
                        device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    params = model.init(g)
    perturb(model, g, device)
    return model, model.eval_program(params), g


def device_ms(fn, iters):
    for _ in range(3):
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


def enqueue_ms(fn, iters, warmup=3):
    """The host's own cost per call: ``iters`` calls timed on the host clock
    up to the last one's return, before the synchronize, so the card's time
    does not count as long as the launch queue does not fill."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def wall_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_window(fn, iters, modules, warmup=True, cpu=True):
    """torch.profiler (CPU and CUDA activity, or CUDA alone) over ``iters``
    calls after one warm-up: (the window's wall time in us, {kernel name:
    its own device time in us}, {kernel name: records kept}, the launches
    the wrappers of ``modules`` counted in the window).  User annotations
    (``Optimizer.step#...``) are left out: their device ranges span kernels
    counted on their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    reset_all(modules)
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return (wall_us, {e.key: e.self_device_time_total for e in events},
            {e.key: e.count for e in events},
            sum(n for m in modules for n in m.LAUNCHES.values()))


def device_busy(fn, iters, modules, mine):
    """(share of a profiler window of ``iters`` calls in which the card
    runs a kernel: the kernel records' device time over the window's wall
    time; the share of the launches of ``modules``' kernels, named by
    ``mine``, that the profiler kept a record of).  The profiler adds host
    cost and may drop records (see kernel_ms), so the idle share it gives
    is an upper bound.  The share is None when the trace holds no device
    time."""
    wall_us, kernels, records, launched = profile_window(fn, iters, modules)
    busy_us = sum(kernels.values())
    kept = sum(n for k, n in records.items() if any(m in k for m in mine))
    return (busy_us / wall_us if busy_us > 0 else None), kept / max(launched, 1)


def launch_busy(fn, iters, modules, launches_of, ms_of):
    """Share of a window of ``iters`` calls in which the card runs the
    port's kernels, without the profiler: each kernel's launches in the
    window (the wrappers' counts) times its ms on the kernels line, over
    the window's wall time.  The run fails if a kernel launched there has
    no ms.  Other device work is not counted, so the idle share is an
    upper bound."""
    fn()
    torch.cuda.synchronize()
    reset_all(modules)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms_ = (time.perf_counter() - t0) * 1e3
    launched = {k: n for k, n in launches_of().items() if n}
    check(set(launched) <= set(ms_of), f"no kernel ms for {sorted(set(launched) - set(ms_of))}")
    return sum(n * ms_of[k] for k, n in launched.items()) / wall_ms_


def graph_ms(fn, iters):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events, so no host cost counts."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters, name):
    """Device time of one launch of the kernel whose name holds ``name``:
    the mean over the records a profiler window (CPU and CUDA activity) of
    ``iters`` calls kept.  Late in a long process the profiler on the
    H100's host keeps only some records (as few as a quarter of 20 short
    launches), so this reads a mean, never a sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    check(bool(times), f"no {name} kernel in the profiler window")
    return sum(times) / len(times) / 1e3


def graph_nodes(fn, calls):
    """The node types of ``calls`` calls of ``fn`` captured in one CUDA
    graph, read from the graph with the driver API (cuGraphGetNodes,
    cuGraphNodeGetType; 0 is a kernel node), so no profiler is involved.
    ``fn`` first runs once on the capture stream, so state it keeps per
    stream (the coupling backward's ticket) exists before the capture."""
    import ctypes

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        types.append(kind.value)
    graph.reset()
    return types


def kernels_per_call(fn, calls):
    """Kernels ``fn`` launches per call: the kernel nodes of ``calls``
    calls captured in one CUDA graph (graph_nodes)."""
    return graph_nodes(fn, calls).count(0) / calls


def stack_work(stack, batch):
    """Operations and bytes one direction of the RealNVP / Glow fused stack
    needs: the conditioner's multiply-adds (2 flops each) and elementwise
    operations at the model's own width F, the Glow mix's D*D
    multiply-adds, and each input / weight read and each output written
    once."""
    spec = stack.spec
    D, F = spec.dim, spec.filters
    mac = elem = 0
    for c in range(spec.n_repeats):
        out, inp = spec.halves[c % 2]
        mac += 2 * (inp * F + 4 * F * F + 2 * out * F + (D * D if spec.has_mix else 0))
        # norm 2D; biases 5F + 2out; BN affine + ReLU 15F; residual 2F;
        # coupling tanh, gain, bias, exp, mul, add, logdet sum 7out
        elem += 2 * D + 22 * F + 9 * out
    weights = sum(t.numel() for p in stack.packed for k, t in p.items()
                  if k not in ("prei", "mixi"))
    bytes_ = 4 * (2 * batch * D + batch + weights)
    return {"flop": batch * (mac + elem), "mac_flop": batch * mac, "elem": batch * elem,
            "transcendental": 0, "bytes": bytes_}


def newton_evaluation_counter():
    """A stand-in for fused_flowpp's mixture inverse that counts how many
    mixture evaluations the kernel's Newton does on these inputs: an
    element evaluates once per trip until it is done, and once more after
    the last trip if it never is.  Each call records (evaluations, what
    the kernel's warps run: a warp holds 32 / LANES consecutive samples and
    runs its slowest one's count for each, what its blocks run: a block of
    SAMPLES samples meets a barrier per coupling, so it takes as long as
    its slowest sample)."""
    from nf_tpu_torch.bijectors import mixlogcdf as mlc
    from nf_tpu_torch.ops.cuda.fused_flowpp import LANES, SAMPLES

    def slowest(evals, n):
        padded = torch.nn.functional.pad(evals, (0, -evals.numel() % n))
        return n * int(padded.view(-1, n).amax(1).sum())

    counts = []

    def counting_inverse(y, logpi, mu, s):
        x = torch.zeros_like(y)
        lo, hi = torch.full_like(y, -mlc.SPAN), torch.full_like(y, mlc.SPAN)
        dxold = torch.full_like(y, 2.0 * mlc.SPAN)
        active = torch.ones_like(y, dtype=torch.bool)
        evals = torch.zeros_like(y, dtype=torch.int64)
        for _ in range(mlc.N_ITERS):
            evals += active
            u, v, logpdf = mlc._mix_logit_parts(x, logpi, mu, s)
            f = (u - v) - y
            lo = torch.where(f < 0, x, lo)
            hi = torch.where(f >= 0, x, hi)
            df = torch.clamp(torch.exp(logpdf - u - v), min=mlc.TINY)
            dx = f / df
            xn = x - dx
            use_bis = ((xn <= lo) | (xn >= hi) | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                       | ~torch.isfinite(xn))
            done = (torch.abs(dx) <= mlc.XTOL) | ((hi - lo) <= mlc.XTOL)
            active &= ~done
            dx = torch.where(use_bis, (hi - lo) * 0.5, dx)
            xn = torch.where(use_bis, (lo + hi) * 0.5, xn)
            x = torch.where(done, x, xn)
            dxold = torch.where(done, torch.zeros_like(dx), dx)
        evals += active
        counts.append((int(evals.sum()), slowest(evals, 32 // LANES), slowest(evals, SAMPLES)))
        return mlc.mix_log_cdf_logit_inverse(y, logpi, mu, s)

    return counting_inverse, counts


def flowpp_work(stack, x, inverse):
    """Operations and bytes one direction of the Flow++ stack needs on
    these inputs.  Per sample and coupling: F + 5F^2 + (2+3K)F multiply-adds
    and about 30F + 15K + 20 other f32 operations; transcendentals are
    exp / expm1 / log / log1p / tanh / sigmoid / rsqrt, counted one each:
    6F + 2K + 5 in the conditioner and head, and 5K + 3 per mixture
    evaluation (exp(-|z|) and log1p per component, three log-sum-exps'
    exp per component and log).  The forward evaluates the mixture once;
    the inverse as often as its Newton needs on these inputs (counted by
    replaying the solve in the plain version), each with about 12K + 15
    more f32 operations."""
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff

    spec = stack.spec
    F, K, n = spec.filters, spec.n_mixtures, spec.n_repeats
    B = x.shape[0]
    if inverse:
        counter, counts = newton_evaluation_counter()
        original = ff.mix_log_cdf_logit_inverse
        ff.mix_log_cdf_logit_inverse = counter
        try:
            ff.fused_flowpp_reference(stack.packed, stack.const_ld, x, "inverse")
        finally:
            ff.mix_log_cdf_logit_inverse = original
        evaluations = sum(c[0] for c in counts)
        warp_evaluations = sum(c[1] for c in counts)
        block_evaluations = sum(c[2] for c in counts)
    else:
        evaluations = warp_evaluations = block_evaluations = B * n
    mac = B * n * (F + 5 * F * F + (2 + 3 * K) * F)
    elem = B * n * (30 * F + 15 * K + 20) + evaluations * (12 * K + 15)
    trans = B * n * (6 * F + 2 * K + 5) + evaluations * (5 * K + 3)
    weights = sum(t.numel() for p in stack.packed for k, t in p.items() if k != "prei")
    return {"flop": 2 * mac + elem, "mac_flop": 2 * mac, "elem": elem,
            "transcendental": trans, "bytes": 4 * (2 * B * 2 + B + weights),
            "mixture_evaluations": evaluations, "warp_mixture_evaluations": warp_evaluations,
            "block_mixture_evaluations": block_evaluations}


def resflow_work(spec, packed, B, direction, n_terms=None, trips=None):
    """Operations and bytes one call of a ResFlow kernel variant needs on
    these inputs.  Per sample and block:
      a hidden evaluation of g (D F + F^2 multiply-adds; 2F sigmoids, one
      exp each; 6 f32 operations per feature: bias, beta a, the sigmoid's
      add and division, a s, / 1.1), and 6 more per feature for the
      LipSwish' masks where the series needs them; g's output layer, F D
      multiply-adds and D bias adds.  The forward evaluates g once; the
      solve `it` times, `it` the block's trip count on the whole batch
      (``trips``, replayed by the plain version: what nf_tpu's kernel runs
      with its one tile of 8192 samples; this kernel's 16-sample
      tiles stop no later), plus the hidden layers once more for the masks
      (solve_ld); each solve trip also takes 3D operations for the
      residual test and D for x = z - g;
      the series: sum_s n_terms[s] J^T products, each 2 D F + F^2 + D
      multiply-adds (the last D the dot with the probe), 2F mask products,
      one exp2 and one multiply-add for the coefficient; 4 operations for
      the mean over the probes;
      ActNorm: D exps and 2D operations; the forward's residual D.
    Bytes: x, y, the log-det and the probes once each, every weight once."""
    D, F, n = spec.dim, spec.filters, spec.n_repeats
    logdet = direction != "solve"
    if direction == "forward":
        evals = B * n
        step_elem = B * n * D
    else:
        evals = B * sum(trips)
        step_elem = evals * 4 * D
    hidden = evals + (B * n if direction == "inverse" else 0)
    masked = B * n if logdet else 0
    products = B * n * int(sum(int(t) for t in n_terms)) if logdet else 0
    mac = hidden * (D * F + F * F) + evals * F * D + products * (2 * D * F + F * F + D)
    elem = (hidden * 2 * 6 * F + masked * 2 * 6 * F + evals * D + products * (2 * F + 1)
            + masked * 4 + B * n * 2 * D + step_elem)
    trans = hidden * 2 * F + B * n * D + products
    weights = sum(packed[k].numel() for k in ("an_s", "an_b", "w1t", "b1", "w2t", "b2",
                                              "w3t", "b3", "beta"))
    reads = 2 * B * D + (B + 4 * B * D if logdet else 0)
    return {"flop": 2 * mac + elem, "mac_flop": 2 * mac, "elem": elem,
            "transcendental": trans, "bytes": 4 * (reads + weights),
            "g_evaluations": evals, "series_products": products}


def resflow_pairing(probes):
    """How the series kernels split the probes over a group's two warps
    (fused_resflow.probe_pairs): the probes per warp, the 8-column terms
    a block runs (its busier warp's), and the mean over the two warps."""
    from nf_tpu_torch.ops.cuda.fused_resflow import probe_pairs

    if probes is None:
        return {}
    nt = [int(n) for n in probes[1]]
    a, d, b, c = probe_pairs(nt)
    return {"probe_pairs": [[a, d], [b, c]],
            "block_terms": max(nt[a] + nt[d], nt[b] + nt[c]),
            "mean_warp_terms": sum(nt) / 2}


def source_line(path, marker):
    """``path:line`` of the first line of ``path`` that holds ``marker``."""
    with open(path) as f:
        for number, line in enumerate(f, 1):
            if marker in line:
                return f"{path}:{number}"
    raise SmokeFailure(f"{marker!r} not found in {path}")


def resflow_occupancy(rf, kw, direction, n):
    """The main path's launch of a ResFlow kernel on this card: its blocks at
    B = BATCH, how many one SM holds at once (occupancy API), and for the
    series kernels the warps that leaves on the least loaded SM when the
    blocks are dealt evenly over the SMs, as one wave is (the run fails
    below 8).  The solve kernel (a warp per 8 samples, 1024 warps at
    B = 8192) must fit one wave with a block on every SM; its entry also
    gives its block's warps, ring slots and the weight bytes its producer
    warps copy from L2 into shared memory per call."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if direction == "solve" and rf.solve_kernel(kw.fp) == "warp":
        blocks = rf.solve_blocks(BATCH)
        per_sm = rf.solve_blocks_per_sm(kw.fp, kw.dp)
        check(sms <= blocks <= per_sm * sms,
              f"resflow solve: {blocks} blocks, {per_sm} per SM on {sms} SMs: not one wave "
              f"with a block on every SM")
        return {"source": source_line(KERNEL_SOURCES["fused_resflow_solve"][0],
                                      "fused_resflow_solve_kernel(const SolveParams"),
                "kernel_variant": "warp", "grid_blocks": blocks, "grid_blocks_per_sm": per_sm,
                "sms": sms, "block_warps": rf.SOLVE_WARPS + 1,
                "consumer_warps": rf.SOLVE_WARPS * blocks, "ring_slots": rf.solve_slots(kw.fp),
                "smem_bytes": rf.solve_smem_bytes(kw.fp, kw.dp),
                "l2_to_sm_weight_bytes": rf.solve_weight_bytes_to_sm(kw, n, BATCH),
                "one_wave": True}
    blocks = -(-BATCH // rf.SAMPLES)
    per_sm = rf.blocks_per_sm(kw.fp, kw.dp, direction)
    least = rf.WARPS * min(per_sm, blocks // sms)
    check(least >= 8, f"resflow {direction}: {least} warps on the least loaded SM "
                      f"({blocks} blocks, {per_sm} per SM)")
    return {"kernel_variant": "tile", "grid_blocks": blocks, "grid_blocks_per_sm": per_sm,
            "sms": sms, "min_warps_per_sm": least, "one_wave": blocks <= per_sm * sms}


def bound_of(work, sfu_per_s, tensor_cores=False):
    """The least time in ms: the largest of f32 operations, transcendentals
    on the SFUs, and bytes, each at its peak rate.  With ``tensor_cores``
    the multiply-adds' flops (``mac_flop``) run at the f32-accurate 3xTF32
    rate and only the other f32 operations at the FFMA rate."""
    flop_s = work["flop"] / F32_FLOPS
    if tensor_cores:
        flop_s = max(work["mac_flop"] / TC_F32_FLOPS,
                     (work["flop"] - work["mac_flop"]) / F32_FLOPS)
    times = {"operations": max(flop_s, work["transcendental"] / sfu_per_s),
             "bytes": work["bytes"] / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def coupling_work(B, N, backward):
    """Operations and bytes of one coupling kernel call on (B, N) halves,
    every input read once and every output written once.  Per element:
    forward / inverse 5 f32 operations (s = tanh * gain + bias, the
    transform's multiply-add, the row sum) and 2 transcendentals (tanh,
    exp); 4 (B, N) tensors and the log-det move.  Backward: 13 operations
    (s, ds, gz0, graw, the two partial sums) and the same 2
    transcendentals; gy, z0, raw_s in, gz0 and graw out, gld, dgain and
    dbias."""
    if backward:
        return {"flop": 13 * B * N, "mac_flop": 0, "elem": 13 * B * N,
                "transcendental": 2 * B * N, "bytes": 4 * (5 * B * N + B + 4)}
    return {"flop": 5 * B * N, "mac_flop": 0, "elem": 5 * B * N,
            "transcendental": 2 * B * N, "bytes": 4 * (4 * B * N + B + 2)}


def coupling_inputs(B, N, g, device):
    """(z0, t, raw_s, gain, bias, gy, gld) with gain and bias off zero."""
    z0, t, raw, gy = (torch.randn(B, N, generator=g, device=device) for _ in range(4))
    gld = torch.randn(B, generator=g, device=device)
    return (z0, t, raw, torch.tensor([0.7], device=device), torch.tensor([-0.1], device=device),
            gy, gld)


def max_diff(a, b):
    return float((a - b).abs().max())


def check_coupling_kernels(tc, device, errs):
    """The three coupling kernels against their plain versions, and their
    kernels per call at the main path's shape, counted in a CUDA graph:
    {name: kernels per call}; the run fails unless each call is one kernel
    and its wrapper counted its own kernel's launch at every call."""
    z0, t, raw, gain, bias, gy, gld = coupling_inputs(
        IMG_BATCH, 512, torch.Generator(device=device).manual_seed(SEED + 2), device)
    per_call = {}
    for name, kname, call in (
            ("coupling_fwd", "coupling_kernel", lambda: tc.launch(z0, t, raw, gain, bias, False)),
            ("coupling_inv", "coupling_kernel", lambda: tc.launch(z0, t, raw, gain, bias, True)),
            ("coupling_bwd", "coupling_bwd_kernel",
             lambda: tc.launch_bwd(z0, raw, gain, bias, gy, gld))):
        reset_all((tc,))
        per_call[name] = kernels_per_call(call, 20)
        print(f"{name}: {per_call[name]} kernels per call, {tc.LAUNCHES[name]} of 21 calls "
              f"launching {kname}")
        check(per_call[name] == 1 and tc.LAUNCHES[name] == 21,
              f"{name}: {per_call[name]} kernels per call, not one")
    g = torch.Generator(device=device).manual_seed(SEED)
    for B, N in COUPLING_CASES:
        z0, t, raw, gain, bias, gy, gld = coupling_inputs(B, N, g, device)
        y, ld = tc.launch(z0, t, raw, gain, bias, inverse=False)
        x, ldi = tc.launch(y, t, raw, gain, bias, inverse=True)
        gz0, graw, dgain, dbias = tc.launch_bwd(z0, raw, gain, bias, gy, gld)
        torch.cuda.synchronize()
        yr, ldr = tc.coupling_fwd_reference(z0, t, raw, gain, bias)
        xr, ldir = tc.coupling_inv_reference(y, t, raw, gain, bias)
        gz0r, _, grawr, dgainr, dbiasr = tc.coupling_bwd_reference(z0, raw, gain, bias, gy, gld)
        rel = [float((a - b).abs() / b.abs()) for a, b in ((dgain, dgainr), (dbias, dbiasr))]
        print(f"check coupling B={B} N={N}: fwd max|dy|={max_diff(y, yr):.3e} "
              f"max|dld|={max_diff(ld, ldr):.3e}; inv max|dx|={max_diff(x, xr):.3e} "
              f"max|dld|={max_diff(ldi, ldir):.3e}; bwd max|dgz0|={max_diff(gz0, gz0r):.3e} "
              f"max|dgraw|={max_diff(graw, grawr):.3e} rel dgain={rel[0]:.3e} "
              f"rel dbias={rel[1]:.3e}")
        for out, want, ldo, ldw, name in ((y, yr, ld, ldr, "coupling_fwd"),
                                          (x, xr, ldi, ldir, "coupling_inv")):
            check(bool(torch.isfinite(out).all() and torch.isfinite(ldo).all()),
                  f"{name}: non-finite output")
            check(torch.allclose(out, want, **COUPLING_TOL), f"{name} B={B} N={N}: output off")
            check(max_diff(ldo, ldw) <= COUPLING_LD_ATOL, f"{name} B={B} N={N}: logdet off")
            errs[name] = max(errs[name], max_diff(out, want), max_diff(ldo, ldw))
        check(torch.allclose(gz0, gz0r, **COUPLING_TOL) and torch.allclose(graw, grawr,
                                                                            **COUPLING_TOL),
              f"coupling_bwd B={B} N={N}: gz0 / graw off")
        check(max(rel) <= COUPLING_SUM_RTOL, f"coupling_bwd B={B} N={N}: dgain / dbias off {rel}")
        errs["coupling_bwd"] = max(errs["coupling_bwd"], max_diff(gz0, gz0r),
                                   max_diff(graw, grawr), max_diff(dgain, dgainr),
                                   max_diff(dbias, dbiasr))
    return per_call


def check_wide_stacks(fs, device, counters, launches_of, errs):
    """RealNVP / Glow stacks past the FFMA block at TILES' sample count,
    through eval_program on the card: each call one launch of the FFMA
    kernel on the 16-sample tiling, or at CLUSTER_PAST_TILES' widths (F =
    32 here) of the cluster kernel (never the eager chain), against the
    plain version; the cluster kernel's errors go to its wide entry."""
    from nf_tpu_torch.utils import tracing

    for name, D, layers, F in WIDE_STACK_CASES:
        _, prog, g = perturbed_program(name, D, layers, F, device, SEED + D)
        stack = prog.stack
        cluster = fs.padded_width(F) in fs.CLUSTER_PAST_TILES[name == "glow"]
        path, tile = ("ffma_cluster", (48, fs.CLUSTER)) if cluster else ("ffma_narrow",
                                                                         fs.NARROW_TILE)
        check(isinstance(stack, fs.PackedStack) and stack.variant == "ffma"
              and (stack.kernel.path, stack.kernel.tile) == (path, tile),
              f"{name} D={D} F={F}: not on {path} at {tile}")
        x = torch.randn(WIDE_STACK_BATCH, D, generator=g, device=device)
        for direction, kname in zip(("forward", "inverse"), MODELS[name]):
            reset_all(counters)
            with tracing.recording() as spans:
                y, ld = getattr(prog, direction)(x)
            torch.cuda.synchronize()
            got = {k: v for k, v in launches_of().items() if v}
            check(got == {kname: 1} and launch_paths(spans) == {path: 1},
                  f"{name} D={D} {direction}: launches {got}, {launch_paths(spans)}")
            yr, ldr = fs.fused_stack_reference(stack.packed, stack.const_ld, x, direction)
            ey, eld = max_diff(y, yr), max_diff(ld, ldr)
            print(f"check {kname} D={D} n={layers} F={F} B={WIDE_STACK_BATCH} ({path}, "
                  f"{tile[0]} samples a {'cluster' if cluster else 'block'}, "
                  f"{fs.smem_bytes(stack.kernel.fp, tile[0], D, stack.spec.has_mix, cluster)} "
                  f"bytes of shared memory a block): max|dz|={ey:.3e} max|dlogdet|={eld:.3e}")
            check(torch.allclose(y, yr, **Z_TOL), f"{kname} D={D}: z off by {ey}")
            check(eld <= LD_ATOL, f"{kname} D={D}: logdet off by {eld}")
            entry = WIDE_NAMES[kname] if cluster else kname
            errs[entry] = max(errs[entry], ey, eld)


def wide_paths(fs, rf, ca, ta, device, counters, launches_of, errs):
    """The wide paths through the entry points a user calls, each call with
    every launch counter set to 0 just before and read just after:
      the RealNVP / Glow stack past the 16-sample tiling
      (PAST_BLOCK_STACK_CASES): build_model -> eval_program -> forward and
      inverse at B = WIDE_BATCH, one launch of the cluster kernel each (48
      samples a cluster of 4 blocks, wide_plan's);
      ResFlow past F = 256 or D = 8 (WIDE_RESFLOW_CASES): eval_program's
      forward and inverse ('unbias': fwd_ld, solve_ld) and the 'exact'
      program's inverse (the solve, then the eager chain at the solved x),
      one launch of the wide kernel each, at wide_plan's plan
      (WIDE_RESFLOW_PLANS);
      attention past D = 128 (WIDE_ATTN_CASES): ops.attention.attention,
      one launch of the wide kernel, and GatedAttn at filters = 4 D
      (nets/gated.py, as Flow++'s image couplings call it) at the first.
    Each held against its plain version on the same inputs (the stacks z
    1e-4 and log-det 1e-3, the ResFlow inverse 1e-3, attention 1e-5 and
    PyTorch's SDPA within the same; GatedAttn against the same module on
    the CPU, 1e-4).  Returns ({wide name: launches}, the timing records)."""
    import copy

    from nf_tpu_torch.utils import tracing

    import torch.nn.functional as F_

    from nf_tpu_torch.nets.gated import GatedAttn
    from nf_tpu_torch.ops.estimators import eval_probes

    launches = dict.fromkeys(WIDE_NAMES.values(), 0)
    records = []

    def counted(what, fn, base, path):
        reset_all(counters)
        with tracing.recording() as spans:
            out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in launches_of().items() if v}
        check(got == {base: 1} and launch_paths(spans) == {path: 1},
              f"{what}: launches {got}, by path {launch_paths(spans)}")
        launches[WIDE_NAMES[base]] += 1
        return out

    for name, D, layers, F in PAST_BLOCK_STACK_CASES:
        _, prog, g = perturbed_program(name, D, layers, F, device, SEED + D + F)
        stack = prog.stack
        check(isinstance(stack, fs.PackedStack) and stack.variant == "ffma"
              and stack.kernel.path == "ffma_cluster"
              and stack.kernel.tile == (fs.wide_plan(D, F, name == "glow"), fs.CLUSTER)
              and fs.CLUSTER == 4 and stack.kernel.tile[0] in (48, 32),
              f"{name} D={D} F={F}: not on the cluster kernel, or at {stack.kernel.tile}")
        x = torch.randn(WIDE_BATCH, D, generator=g, device=device)
        for direction, base in zip(("forward", "inverse"), MODELS[name]):
            y, ld = counted(f"{name} D={D} F={F} {direction}",
                            lambda: getattr(prog, direction)(x), base, "ffma_cluster")
            yr, ldr = fs.fused_stack_reference(stack.packed, stack.const_ld, x, direction)
            ey, eld = max_diff(y, yr), max_diff(ld, ldr)
            kname = WIDE_NAMES[base]
            inv = direction == "inverse"
            S, C = stack.kernel.tile
            print(f"check {kname} D={D} n={layers} F={F} B={WIDE_BATCH} (cluster of {C}, "
                  f"{S} samples, {fs.member_rows(D)} rows and "
                  f"{fs.smem_bytes(stack.kernel.fp, S, D, stack.spec.has_mix, True)} bytes of "
                  f"shared memory a block, {-(-WIDE_BATCH // S)} clusters): "
                  f"max|dz|={ey:.3e} max|dlogdet|={eld:.3e}")
            check(bool(torch.isfinite(y).all() and torch.isfinite(ld).all()),
                  f"{kname} D={D}: non-finite output")
            check(torch.allclose(y, yr, **Z_TOL), f"{kname} D={D} F={F}: z off by {ey}")
            check(eld <= LD_ATOL, f"{kname} D={D} F={F}: logdet off by {eld}")
            errs[kname] = max(errs[kname], ey, eld)
            records.append(dict(
                name=kname, shape=[WIDE_BATCH, D, F, layers],
                call=lambda st=stack, inp=x, i=inv: fs.launch(st, inp, i),
                plain=lambda st=stack, inp=x, d=direction: fs.fused_stack_reference(
                    st.packed, st.const_ld, inp, d),
                work=stack_work(stack, WIDE_BATCH)))

    for D, layers, F in WIDE_RESFLOW_CASES:
        _, prog, g = perturbed_program("resflow", D, layers, F, device, SEED + D + F)
        _, exact, _ = perturbed_program("resflow", D, layers, F, device, SEED + D + F,
                                        logdet="exact")
        for st in (prog.stack, exact.stack):
            check(rf.kernel_path(st.spec) == "wide" and isinstance(st.kernel, rf.WideWeights),
                  f"resflow D={D} F={F}: not on the wide kernel")
        plan = rf.wide_plan(F, D, WIDE_BATCH, cluster=prog.stack.kernel.cluster)
        want = WIDE_RESFLOW_PLANS[(D, F)]
        got = (plan.cluster, plan.samples, plan.residency)
        check(got == want and plan.smem_bytes <= rf.SMEM_LIMIT
              and exact.stack.kernel.cluster == plan.cluster,
              f"resflow wide D={D} F={F}: plan {got}, {plan.smem_bytes} bytes, not {want}")
        x = torch.randn(WIDE_BATCH, D, generator=g, device=device)
        probes = eval_probes("unbias", WIDE_BATCH, D, device)
        w2 = (f"{plan.residency} ({'its slabs' if plan.cluster > 1 else 'all of it'} in shared "
              f"memory)" if plan.w2_res else f"{plan.residency} from L2")
        print(f"resflow wide D={D} n={layers} F={F} B={WIDE_BATCH}: n_terms="
              f"{probes[1].tolist()}; plan: clusters of {plan.cluster} ("
              f"{plan.clusters(WIDE_BATCH)} of them), {plan.samples} samples a cluster, W2t {w2}, "
              f"W1t {'staged' if plan.w1_res else 'from L2'}, W3t "
              f"{'staged' if plan.w3_res else 'from L2'}, vectors in "
              f"{'shared memory' if plan.vec_smem else 'device scratch'}, chunks of "
              f"{plan.chunk} columns and {plan.kchunk} rows, {plan.smem_bytes} bytes of "
              f"shared memory a member")
        z, ld = counted(f"resflow D={D} F={F} forward", lambda: prog.forward(x),
                        "fused_resflow_fwd_ld", "wide")
        zr, ldr = rf.fused_resflow_fwd_logdet_reference(prog.stack.spec, prog.stack.packed, x,
                                                        probes)
        xi, ldi = counted(f"resflow D={D} F={F} inverse", lambda: prog.inverse(zr),
                          "fused_resflow_solve_ld", "wide")
        trips_ld = []
        xr, ldir = rf.fused_resflow_solve_logdet_reference(prog.stack.spec, prog.stack.packed,
                                                           zr, probes, trips_ld)
        ze = rf.fused_resflow_fwd_logdet_reference(exact.stack.spec, exact.stack.packed, x,
                                                   probes)[0]
        xs, _ = counted(f"resflow D={D} F={F} exact inverse", lambda: exact.inverse(ze),
                        "fused_resflow_solve", "wide")
        trips = []
        xsr = rf.fused_resflow_solve_reference(exact.stack.spec, exact.stack.packed, ze, trips)
        for base, got, want, tol in (
                ("fused_resflow_fwd_ld", (z, ld), (zr, ldr), None),
                ("fused_resflow_solve_ld", (xi, ldi), (xr, ldir), RESFLOW_INV_ATOL),
                ("fused_resflow_solve", (xs,), (xsr,), RESFLOW_INV_ATOL)):
            kname = WIDE_NAMES[base]
            e = [max_diff(a, b) for a, b in zip(got, want)]
            print(f"check {kname} D={D} n={layers} F={F} B={WIDE_BATCH}: max|dz|={e[0]:.3e}"
                  + (f" max|dlogdet|={e[1]:.3e}" if len(e) > 1 else "")
                  + ("" if tol is None else f"; trips per block (plain, whole batch): "
                     f"{(trips_ld if len(e) > 1 else trips)}"))
            check(all(bool(torch.isfinite(t).all()) for t in got), f"{kname}: non-finite")
            if tol is None:
                check(torch.allclose(z, zr, **Z_TOL) and e[1] <= LD_ATOL,
                      f"{kname} D={D} F={F}: off by {e}")
            else:
                check(max(e) <= tol, f"{kname} D={D} F={F}: off by {e}")
            errs[kname] = max(errs[kname], *e)
        planned = {}
        for direction, st, inp, pr, tr in (("forward", prog.stack, x, probes, None),
                                           ("inverse", prog.stack, zr, probes, trips_ld),
                                           ("solve", exact.stack, ze, None, trips)):
            plain = {"forward": lambda st=st, inp=inp, pr=pr:
                     rf.fused_resflow_fwd_logdet_reference(st.spec, st.packed, inp, pr),
                     "inverse": lambda st=st, inp=inp, pr=pr:
                     rf.fused_resflow_solve_logdet_reference(st.spec, st.packed, inp, pr),
                     "solve": lambda st=st, inp=inp:
                     rf.fused_resflow_solve_reference(st.spec, st.packed, inp)}[direction]
            planned[WIDE_NAMES[RESFLOW_NAMES[direction]]] = rf.wide_weight_bytes(
                plan, layers, WIDE_BATCH,
                rf.wide_chains(plan, direction, layers, None if pr is None else pr[1], tr))
            records.append(dict(
                name=WIDE_NAMES[RESFLOW_NAMES[direction]], shape=[WIDE_BATCH, D, F, layers],
                call=lambda st=st, inp=inp, d=direction, pr=pr: rf.launch(st, inp, d, pr),
                plain=plain,
                work=resflow_work(st.spec, st.packed, WIDE_BATCH, direction,
                                  None if pr is None else pr[1], tr),
                extra={"plan": {"cluster": plan.cluster, "samples": plan.samples,
                                "clusters": plan.clusters(WIDE_BATCH),
                                "residency": plan.residency, "w1_staged": plan.w1_res,
                                "w3_staged": plan.w3_res, "vectors_in_smem": plan.vec_smem,
                                "chunk": plan.chunk, "kchunk": plan.kchunk,
                                "smem_bytes": plan.smem_bytes}}))
        print(f"resflow wide D={D} n={layers} F={F} B={WIDE_BATCH}: the plan's count of "
              f"weight bytes read from L2 a call (fused_resflow.wide_weight_bytes, not a "
              f"measurement; the solves' trip counts the plain version's over the whole "
              f"batch): planned_l2_weight_bytes={json.dumps(planned)}")

    g = torch.Generator(device=device).manual_seed(SEED + 7)
    for i, (BH, L, D) in enumerate(WIDE_ATTN_CASES):
        q, k, v = (torch.randn(BH, L, D, generator=g, device=device) for _ in range(3))
        out = counted(f"attention ({BH}, {L}, {D})", lambda: ta.attention(q, k, v),
                      "attention_fwd", "wide")
        want = ta.attention_reference(q, k, v)
        lib = F_.scaled_dot_product_attention(q, k, v)
        e, e_lib = max_diff(out, want), max_diff(lib, want)
        rt, kt = ca.wide_tiling(L, D)
        print(f"check attention_fwd_wide BH={BH} L={L} D={D} ({ca.grid(BH, L, D)} blocks of "
              f"{16 * rt} query rows, {kt} keys a tile, {ca.smem_bytes(L, D)} bytes of shared "
              f"memory): max|dout|={e:.3e} (SDPA "
              f"against the plain version {e_lib:.3e})")
        check(bool(torch.isfinite(out).all()), "attention_fwd_wide: non-finite output")
        check(torch.allclose(out, want, **ATTN_TOL), f"attention_fwd_wide D={D}: off by {e}")
        check(torch.allclose(lib, want, **ATTN_TOL), f"SDPA D={D}: off by {e_lib}")
        errs["attention_fwd_wide"] = max(errs["attention_fwd_wide"], e)
        records.append(dict(
            name="attention_fwd_wide", shape=[BH, L, D],
            call=lambda q=q, k=k, v=v: ca.launch(q, k, v),
            plain=lambda q=q, k=k, v=v: ta.attention_reference(q, k, v),
            library=lambda q=q, k=k, v=v: F_.scaled_dot_product_attention(q, k, v),
            work=attention_work(BH, L, D)))
        if i == 0:
            side = int(round(math.sqrt(L)))
            net = GatedAttn((side, side, 8), filters=4 * D, device=device)
            net.init(torch.Generator(device=device).manual_seed(SEED + 8))
            xa = torch.randn(BH // 4, side, side, 8, generator=g, device=device)
            with torch.no_grad():
                ya = counted(f"GatedAttn filters={4 * D} on ({BH // 4}, {side}, {side}, 8)",
                             lambda: net(xa), "attention_fwd", "wide")
                yc = copy.deepcopy(net).cpu()(xa.cpu())
            ea = max_diff(ya.cpu(), yc)
            print(f"check GatedAttn filters={4 * D} ({BH // 4}, {side}, {side}, 8) on the "
                  f"card against the CPU: max|dy|={ea:.3e}")
            check(ea <= 1e-4, f"GatedAttn filters={4 * D}: off the CPU by {ea}")
    return launches, records


def wide_entries(records, launches, errs, sfu_per_s):
    """The kernels line's entries of the wide paths: per kernel name its
    shapes' times (WIDE_ITERS launches captured in a CUDA graph, graph_ms,
    with event_ms beside: the same launches back to back, host cost
    included; the plain versions over 3 calls; SDPA's where one call
    computes the same) and works,
    summed, each shape also on its own under per_shape."""
    by_name = {}
    for r in records:
        by_name.setdefault(r["name"], []).append(r)
    entries = []
    for name, recs in by_name.items():
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        work = dict.fromkeys(("flop", "mac_flop", "elem", "transcendental", "bytes"), 0)
        per_shape = []
        for r in recs:
            t = {"ms": graph_ms(r["call"], WIDE_ITERS), "plain_ms": device_ms(r["plain"], 3),
                 "library_ms": device_ms(r["library"], WIDE_ITERS) if "library" in r else None,
                 "event_ms": device_ms(r["call"], WIDE_ITERS)}
            bound, by = bound_of(r["work"], sfu_per_s)
            bound_tc, by_tc = bound_of(r["work"], sfu_per_s, tensor_cores=True)
            per_shape.append({"shape": r["shape"], **t, "bound_ms": bound, "bound_by": by,
                              "bound_tc_ms": bound_tc, "bound_tc_by": by_tc,
                              **r.get("extra", {})})
            for key in total:
                total[key] += t[key] or 0.0
            for key in work:
                work[key] += r["work"][key]
        library = "library" in recs[0]
        entries.append(kernel_entry(
            name, launches, errs, work, sfu_per_s, total["ms"], total["plain_ms"],
            library_ms=total["library_ms"] if library else None,
            library_note=("torch.nn.functional.scaled_dot_product_attention, f32" if library
                          else "no single PyTorch call computes the whole stack"),
            shape="summed over per_shape", per_shape=per_shape,
            launches_note="launches: the wide path's run through its entry points "
                          "(wide_paths), not the headline main path",
            timing=f"ms: {WIDE_ITERS} launches per shape captured in one CUDA graph and "
                   "replayed between CUDA events (graph_ms: no host cost), summed; per_shape's "
                   "event_ms the same launches back to back (host cost included where it "
                   "exceeds the kernel's); plain_ms 3 calls"))
    return entries


def eager_main_path(name, device, counters, launches_of):
    """MAF or Planar 2-D (bench.py:41-46's shape: D = 2, 32 layers) through
    build_model -> init -> eval_program -> log_prob / sample on the card,
    with no launch of any port kernel; the outputs finite, the round trip,
    and log p against the same state on the CPU.  Returns (program, data,
    latent) for the timing phase."""
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name=name, **NETWORK_DEFAULTS[name])
    model = build_model(name, (2,), "2d", cfg)
    check(model.device.type == "cuda", "build_model did not default to the card")
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.init(gen)
    perturb(model, gen, device)
    perturb_planar(model, gen, device)
    prog = model.eval_program()
    check(prog.stack is None, f"{name}: a fused kernel matched")
    x = torch.randn(BATCH, 2, generator=gen, device=device)
    reset_all(counters)
    log_px = prog.log_prob(x)
    y_s, log_py = prog.sample(BATCH, gen)
    torch.cuda.synchronize()
    got = {k: v for k, v in launches_of().items() if v}
    print(f"main path {name} launches: {got}")
    check(not got, f"{name}: launched {got}")
    check(log_px.shape == (BATCH,) and y_s.shape == (BATCH, 2) and log_py.shape == (BATCH,),
          f"{name}: main path output shapes")
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"{name} {what}: non-finite values")
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    rt, ld_sum = max_diff(xr, x), float((ld + ldi).abs().max())
    n = EAGER_PARITY
    xs = x[:n].cpu()
    lp = {}
    for dtype in (torch.float32, torch.float64):
        cpu = build_model(name, (2,), "2d", cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        with torch.no_grad():
            lp[dtype] = cpu.to(dtype).eval().log_prob(xs.to(dtype)).double()
    card = log_px[:n].cpu().double()
    diff, top = max_diff(card, lp[torch.float32]), float(lp[torch.float64].abs().max())
    print(f"{name} round trip: max|x - inv(fwd(x))|={rt:.3e} max|ld_fwd + ld_inv|={ld_sum:.3e};"
          f" card vs CPU, {n} samples: max|dlog p|={diff:.3e} (max|log p|={top:.1f}; to "
          f"float64: card {max_diff(card, lp[torch.float64]):.3e}, CPU "
          f"{max_diff(lp[torch.float32], lp[torch.float64]):.3e})")
    check(rt < 1e-3 and ld_sum < 1e-3, f"{name}: round trip")
    check(diff <= EAGER_LOGP_RTOL * top, f"{name}: log p on the card disagrees with the CPU")
    return prog, x, z


def debug_phase(device, counters, launches_of):
    """run.debug on the served path, and a registered model of the
    caller's own (see phase 4 above)."""
    from nf_tpu_torch.bijectors import AffineCoupling, BatchNorm, Squeeze1d, Unsqueeze1d
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.core import Chain
    from nf_tpu_torch.models import FlowModel, build_model, register
    from nf_tpu_torch.utils.debug import check_chain

    t0 = time.perf_counter()
    fwd_name, inv_name = MODELS["realnvp"]
    cfg = NetworkConfig(name="realnvp", **NETWORK_DEFAULTS["realnvp"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(BATCH, 2, generator=gen, device=device)
    bad = x.clone()
    bad[BATCH // 2, 0] = float("nan")
    log_p = {}
    for tagged in (True, False):
        model = build_model("realnvp", (2,), "2d", cfg)
        g = torch.Generator(device=device).manual_seed(SEED + 1)
        params = model.init(g)
        perturb(model, g, device)
        if tagged:
            check_chain(model.bijector)
        prog = model.eval_program(params)
        check((prog.stack is None) == tagged,
              f"debug: the {'tagged' if tagged else 'untagged'} program's path")
        reset_all(counters)
        if tagged:
            try:
                prog.log_prob(bad)
                raised = ""
            except FloatingPointError as e:
                raised = str(e)
        log_p[tagged] = prog.log_prob(x)
        y_s, log_py = prog.sample(BATCH, gen)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launches_of().items() if v}
        if tagged:
            print(f"debug: the tagged program raised {raised!r}; launches {counts}")
            check(raised.startswith("non-finite output in layer0:BatchNorm.forward"),
                  f"debug: the tagged program raised {raised!r}")
            check(not counts, f"debug: the tagged program launched {counts}")
        else:
            print(f"debug: the untagged program's launches {counts}")
            check(counts == {fwd_name: 1, inv_name: 1},
                  f"debug: the untagged program launched {counts}")
    # both against the same state in float64 on the CPU
    cpu = build_model("realnvp", (2,), "2d", cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        lp64 = cpu.double().eval().log_prob(x.cpu().double())
    top = float(lp64.abs().max())
    errs = [max_diff(log_p[tagged].cpu().double(), lp64) for tagged in (True, False)]
    print(f"debug: {BATCH} samples, max|log p|={top:.1f}: probed chain vs fused kernel "
          f"max|dlog p|={max_diff(log_p[True], log_p[False]):.3e}; to float64 on the CPU: "
          f"chain {errs[0]:.3e}, kernel {errs[1]:.3e}")
    check(bool(torch.isfinite(log_p[True]).all() and torch.isfinite(y_s).all()
               and torch.isfinite(log_py).all()), "debug: the probed program's outputs")
    check(max(errs) <= EAGER_LOGP_RTOL * top,
          "debug: the probed chain or the fused kernel is off the CPU's float64")

    name, D, F = "squeeze1d-realnvp", 4, cfg.base_filters

    def builder(dims, datatype=None, cfg=None, device=None):
        layers = [l for i in range(8) for l in (
            BatchNorm(dims[-1], affine=False, device=device),
            AffineCoupling(dims, odd=i % 2 != 0, base_filters=F, device=device))]
        return FlowModel(name, Chain([Squeeze1d()] + layers + [Unsqueeze1d()]), dims, device)

    register(name, builder)
    model = build_model(name, (D,), "2d")
    check(model.device.type == "cuda", f"{name}: build_model did not default to the card")
    model.init(gen)
    perturb(model, gen, device)
    prog = model.eval_program()
    x = torch.randn(BATCH, D, generator=gen, device=device)
    reset_all(counters)
    log_px = prog.log_prob(x)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches_of().items() if v}
    check(prog.stack is None and not counts, f"{name}: launched {counts}")
    check(log_px.shape == (BATCH,) and bool(torch.isfinite(log_px).all()),
          f"{name}: log p shape or values")
    cpu = build_model(name, (D,), "2d", device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = cpu.eval_program().log_prob(x[:EAGER_PARITY].cpu())
    diff, top = max_diff(log_px[:EAGER_PARITY].cpu(), want), float(want.abs().max())
    print(f"{name}: card vs CPU, {EAGER_PARITY} samples: max|dlog p|={diff:.3e} "
          f"(max|log p|={top:.1f})")
    check(diff <= EAGER_LOGP_RTOL * top, f"{name}: log p on the card disagrees with the CPU")
    print(f"debug phase took {time.perf_counter() - t0:.1f} s")


def counted_call(what, fn, want, counters, launches_of, totals):
    """fn() with every launch counter set to 0 just before and read just
    after; fails unless the kernels launched are exactly ``want``.  Adds the
    counts to ``totals``."""
    reset_all(counters)
    out = fn()
    torch.cuda.synchronize()
    counts = launches_of()
    got = {k: v for k, v in counts.items() if v}
    print(f"main path {what} launches: {got}")
    check(got == want, f"{what}: expected {want}, got {got}")
    for k, v in counts.items():
        totals[k] += v
    return out


def image_model(cfg, device, state=None, dims=IMG_DIMS):
    from nf_tpu_torch.models import build_model

    model = build_model(cfg.name, dims, "image", cfg, device=device)
    if state is not None:
        model.load_state_dict(state)
    return model


def image_cpu_parity(tier, cfg, state, xs):
    """Eval-mode log p and one train-mode gradient on ``xs`` for the same
    state on the card (f32) and on the CPU (plain versions, f32 and
    float64)."""
    label = tier["label"]
    logp, grads = {}, {}
    runs = {"card": ("cuda", torch.float32), "cpu": ("cpu", torch.float32),
            "cpu64": ("cpu", torch.float64)}
    for run, (device, dtype) in runs.items():
        model = image_model(cfg, device, state, tier["dims"]).to(dtype).eval()
        x = xs.to(device=device, dtype=dtype)
        with torch.no_grad():
            logp[run] = model.log_prob(x).cpu().double()
        model.train()
        (-model.log_prob(x).mean()).backward()
        grads[run] = torch.cat([p.grad.reshape(-1).cpu().double() for p in model.parameters()])

    def rel_l2(run):
        return float((grads[run] - grads["cpu64"]).norm() / grads["cpu64"].norm())

    out = {"samples": xs.shape[0],
           "logp_max_abs_diff": max_diff(logp["card"], logp["cpu"]),
           "logp_max_abs": float(logp["cpu"].abs().max()),
           "logp_f64_max_abs_diff": {r: max_diff(logp[r], logp["cpu64"]) for r in ("card", "cpu")},
           "grad_rel_l2_card_vs_cpu": float((grads["card"] - grads["cpu"]).norm()
                                            / grads["cpu"].norm()),
           "grad_rel_l2_to_f64": {r: rel_l2(r) for r in ("card", "cpu")},
           "grad_max_abs": float(grads["cpu64"].abs().max())}
    print(f"{label} card vs CPU, {xs.shape[0]} samples: max|dlog p|="
          f"{out['logp_max_abs_diff']:.3e} (max|log p|={out['logp_max_abs']:.1f}; to float64: "
          f"card {out['logp_f64_max_abs_diff']['card']:.3e}, CPU "
          f"{out['logp_f64_max_abs_diff']['cpu']:.3e}); gradients relative L2 card vs CPU "
          f"{out['grad_rel_l2_card_vs_cpu']:.3e}, to float64: card "
          f"{out['grad_rel_l2_to_f64']['card']:.3e}, CPU {out['grad_rel_l2_to_f64']['cpu']:.3e}")
    check(out["logp_max_abs_diff"] <= IMG_LOGP_RTOL * out["logp_max_abs"],
          f"{label}: log p on the card disagrees with the CPU")
    check(out["grad_rel_l2_to_f64"]["card"]
          <= IMG_GRAD_FACTOR * out["grad_rel_l2_to_f64"]["cpu"],
          f"{label}: gradients on the card are less accurate than the CPU's")
    return out


def image_main_path(tier, device, counters, launches_of):
    """One image tier of IMAGE_TIERS through Trainer and EvalProgram, each
    call's launches counted.  Returns what the timing phase needs."""
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.train import Trainer

    label, dims = tier["label"], tier["dims"]
    cfg = NetworkConfig(name=tier["network"], layers=32)
    model = image_model(cfg, None, dims=dims)
    n_couplings = sum(isinstance(m, AffineCoupling) for m in model.modules())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{label}: {n_couplings} couplings, {n_params} parameters")
    check(model.device.type == "cuda", "build_model did not default to the card")
    check((n_couplings, n_params) == (IMG_COUPLINGS, tier["params"]),
          f"{label} has {n_couplings} couplings and {n_params} parameters")
    gen = torch.Generator(device=device).manual_seed(SEED)

    def pixels(*shape):   # as bench.py:248-259 makes its batches
        return 0.05 + 0.9 * torch.rand(shape, generator=gen, device=device)

    batch0 = pixels(IMG_BATCH, *dims)
    chunk = pixels(IMG_TRAIN_CHUNK, IMG_BATCH, *dims)
    x = pixels(IMG_BATCH, *dims)
    trainer = Trainer(model, OptimizerConfig(), seed=SEED)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    n = IMG_COUPLINGS

    def counted(what, fn, want):
        return counted_call(f"{label} {what}", fn, want, counters, launches_of, totals)

    ts = counted("init_state", lambda: trainer.init_state(batch0), {"coupling_fwd": n})
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    K = IMG_TRAIN_CHUNK
    ts, losses = counted(f"train_steps K={K}", lambda: trainer.train_steps(ts, chunk),
                         {"coupling_fwd": K * n, "coupling_bwd": K * n})
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    print(f"{label} losses (nats per sample) {losses}; train peak memory "
          f"{peak / 2**30:.2f} GiB")
    check(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss")
    prog = model.eval_program()
    log_px = counted("log_prob", lambda: prog.log_prob(x), {"coupling_fwd": n})
    y_s, log_py = counted("sample", lambda: prog.sample(IMG_BATCH, gen), {"coupling_inv": n})
    check(log_px.shape == (IMG_BATCH,) and y_s.shape == (IMG_BATCH,) + dims
          and log_py.shape == (IMG_BATCH,), f"{label}: main path output shapes")
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"{label} {what}: non-finite values")
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    err = (xr - x).abs()
    round_trip = {"max": float(err.max()), "median": float(err.median()),
                  "ld_max": max_diff(ld, -ldi), "ld_max_abs": float(ld.abs().max())}
    print(f"{label} round trip: max|x - inv(fwd(x))|={round_trip['max']:.3e} "
          f"median {round_trip['median']:.3e}; max|ld_fwd + ld_inv|={round_trip['ld_max']:.3e} "
          f"(max|ld|={round_trip['ld_max_abs']:.1f})")
    check(bool(torch.isfinite(z).all() and torch.isfinite(xr).all()),
          f"{label}: non-finite round trip")
    t0 = time.perf_counter()
    parity = image_cpu_parity(tier, cfg, state, x[:tier["parity"]])
    print(f"card vs CPU parity took {time.perf_counter() - t0:.1f} s")
    return dict(tier=tier, model=model, prog=prog, trainer=trainer, ts=ts, chunk=chunk, x=x,
                z=z, totals=totals, losses=losses, peak=peak, round_trip=round_trip,
                parity=parity, n_params=n_params)


COUPLING_KERNELS = ("coupling_kernel", "coupling_bwd_kernel")


def device_breakdown(wall_us, kernels, records, launched, calls, mine=COUPLING_KERNELS,
                     label="coupling"):
    """A profile window's device idle share, the named kernels' share of its
    device time and the share of their launches (the wrappers' counts) the
    profiler kept a record of, and its six longest kernels in ms per
    call."""
    total = sum(kernels.values())
    ours = sum(v for k, v in kernels.items() if any(n in k for n in mine))
    kept = sum(n for k, n in records.items() if any(m in k for m in mine))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"device_idle_share": 1.0 - total / wall_us,
            "device_ms_per_call": total / calls / 1e3,
            f"{label}_device_share": ours / total,
            f"{label}_records_kept": kept / max(launched, 1),
            "top_kernels_ms_per_call": [[k[:100], v / calls / 1e3] for k, v in top]}


def image_timing(img, smi, tc):
    """The image model's serving and training rates, idle shares, the
    coupling kernels' share of device time and the longest kernels;
    prints its main_path line and returns it."""
    prog, trainer, x, z = img["prog"], img["trainer"], img["x"], img["z"]
    # the main path warmed both directions; the windows record CUDA
    # activity alone, as scan_timing's, so the image lines' idle shares
    # compare
    t_fwd = wall_ms(lambda: prog.forward(x), IMG_ITERS, warmup=1)
    t_inv = wall_ms(lambda: prog.inverse(z), IMG_ITERS, warmup=1)
    eval_profile = device_breakdown(*profile_window(
        lambda: (prog.forward(x), prog.inverse(z)), 1, (tc,), warmup=False, cpu=False), 1)
    state = {"ts": img["ts"]}

    def chunk():
        state["ts"], _ = trainer.train_steps(state["ts"], img["chunk"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IMG_TRAIN_TIMED):
        chunk()
    torch.cuda.synchronize()
    t_chunk = (time.perf_counter() - t0) * 1e3 / IMG_TRAIN_TIMED
    train_profile = device_breakdown(*profile_window(   # the chunk warmed the step
        lambda: trainer.train_step(state["ts"], img["chunk"][0]), 1, (tc,), warmup=False,
        cpu=False), 1)
    K, B = IMG_TRAIN_CHUNK, IMG_BATCH
    tier = img["tier"]
    line = {
        "model": f"{tier['label']}: {'x'.join(map(str, tier['dims']))} image, "
                 f"{IMG_COUPLINGS} couplings, base_filters=32, {img['n_params']} parameters",
        "batch": B, "train_chunk": K,
        "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
        "eval_fwd_inv_samples_per_s": B / ((t_fwd + t_inv) / 1e3),
        "eval_profile_fwd_inv_pair": eval_profile,
        "train_chunk_ms": t_chunk, "train_step_ms": t_chunk / K,
        "train_samples_per_s": K * B / (t_chunk / 1e3),
        "train_profile_step": train_profile,
        "train_peak_memory_bytes": img["peak"], "losses": img["losses"],
        "round_trip": img["round_trip"], "cpu_parity": img["parity"], "card": smi}
    print(json.dumps({"main_path": line}))
    return line


def coupling_entries(tc, launches, errs, sfu_per_s, device, per_call):
    """The three coupling kernels' entries on the kernels line, timed at
    each image tier's shape, (1024, 512) and (1024, 1536), over input sets
    cycled past L2: the entry's own numbers at (1024, 512), the other
    tier's under its label; with their kernels per call from
    check_coupling_kernels."""
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    calls = {
        "coupling_fwd": (lambda a: tc.launch(*a[:5], inverse=False),
                         lambda a: tc.coupling_fwd_reference(*a[:5])),
        "coupling_inv": (lambda a: tc.launch(*a[:5], inverse=True),
                         lambda a: tc.coupling_inv_reference(*a[:5])),
        "coupling_bwd": (lambda a: tc.launch_bwd(a[0], a[2], a[3], a[4], a[5], a[6]),
                         lambda a: tc.coupling_bwd_reference(a[0], a[2], a[3], a[4], a[5],
                                                             a[6]))}
    timed = {}
    for label, N in COUPLING_WIDTHS.items():
        sets = [coupling_inputs(IMG_BATCH, N, g, device) for _ in range(COUPLING_SETS)]
        for name, (kernel, plain) in calls.items():
            cycle = itertools.cycle(sets)
            kname = "coupling_bwd_kernel" if name == "coupling_bwd" else "coupling_kernel"
            work = coupling_work(IMG_BATCH, N, name == "coupling_bwd")
            bound, bound_by = bound_of(work, sfu_per_s)
            ms = kernel_ms(lambda: kernel(next(cycle)), COUPLING_ITERS, kname)
            timed[label, name] = dict(
                shape=[IMG_BATCH, N], ms=ms,
                plain_ms=graph_ms(lambda: plain(next(cycle)), COUPLING_ITERS),
                event_ms=device_ms(lambda: kernel(next(cycle)), COUPLING_ITERS),
                bound_ms=bound, bound_by=bound_by, share=bound / ms, work=work)
        del sets
    entries = []
    for name in calls:
        main = timed["realnvp-img32x1", name]
        other = {k: v for k, v in timed["glow-img32x3", name].items() if k != "work"}
        entries.append(kernel_entry(
            name, launches, errs, main["work"], sfu_per_s, main["ms"], main["plain_ms"],
            shape=main["shape"], event_ms=main["event_ms"],
            timing="ms: the kernel's own device time per launch (profiler, the mean over "
                   "its records); plain_ms: device time per call, 200 calls in one CUDA "
                   "graph between CUDA events; event_ms: CUDA events over back-to-back "
                   "calls, host cost included",
            library_note="no single PyTorch call computes the coupling transform",
            calls_per_pass=IMG_COUPLINGS, kernels_per_call=per_call[name],
            **{"glow-img32x3": other}))
    return entries


def stack_entry(fs, name, stack, inp, inv, plain_ms, launches, errs, sfu_per_s):
    """A RealNVP / Glow fused-stack kernel's entry at the main path's shape:
    ms by CUDA events over 200 back-to-back launches (as every earlier
    run timed it), graph_ms over 200 launches in one CUDA graph (no host
    cost), profiler_ms the mean of its profiler records; its variant, and
    for the tensor-core kernel the blocks an SM holds and the weight bytes
    copied from L2 into shared memory per direction."""
    spec, kw = stack.spec, stack.kernel
    call = lambda: fs.launch(stack, inp, inv)  # noqa: E731
    extra = {"kernel_variant": stack.variant, "graph_ms": graph_ms(call, 200),
             "profiler_ms": kernel_ms(call, 200, "fused_stack"),
             "timing": "ms: CUDA events over 200 back-to-back launches; graph_ms: 200 "
                       "launches in one CUDA graph between CUDA events; profiler_ms: the "
                       "mean of the kernel's profiler records over 200 launches"}
    if stack.variant == "mma":
        extra.update(
            blocks=-(-BATCH // fs.MMA_SAMPLES), block_warps=fs.MMA_WARPS + 1,
            blocks_per_sm=fs.mma_blocks_per_sm(kw, spec.has_mix, inv),
            l2_to_sm_weight_bytes=fs.weight_bytes_to_sm(kw, spec.n_repeats, BATCH),
            smem_bytes=kw.layout.smem_bytes)
    return kernel_entry(name, launches, errs, stack_work(stack, BATCH), sfu_per_s,
                        device_ms(call, 200), plain_ms, couplings=spec.n_repeats,
                        filters=spec.filters, **extra)


def kernel_entry(name, launches, errs, work, sfu_per_s, ms, plain_ms, **extra):
    """One kernel's entry on the kernels line: its measured times, its
    launches on the main path, its largest error against the plain
    version, and the bounds its work gives: ``bound_ms`` with every
    multiply-add at the FFMA rate, ``bound_tc_ms`` with them on the tensor
    cores in 3xTF32.  ``share`` is the bound of the units the kernel runs
    its products on over its time; the run fails if it reads over 1."""
    source, replaces = KERNEL_SOURCES[name]
    bound, bound_by = bound_of(work, sfu_per_s)
    bound_tc, bound_tc_by = bound_of(work, sfu_per_s, tensor_cores=True)
    units = "tensor_cores" if name in TENSOR_CORE_KERNELS else "fp32"
    share = (bound_tc if units == "tensor_cores" else bound) / ms
    check(share <= 1.0, f"{name}: {ms} ms is below its {units} bound: the work count is wrong")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": errs[name],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "bound_tc_ms": bound_tc, "bound_tc_by": bound_tc_by, "products_on": units,
        "share": share, "library_ms": None,
        "library_note": "no single PyTorch call computes the whole stack",
        "f32_ms": work["flop"] / F32_FLOPS * 1e3,
        "sfu_ms": work["transcendental"] / sfu_per_s * 1e3,
        "bytes_ms": work["bytes"] / HBM_BYTES_PER_S * 1e3,
        "flop": work["flop"], "transcendental": work["transcendental"],
        "bytes": work["bytes"], "shape": [BATCH, 2], **extra}


# --------------------------------------------------------------------------
# attention and the mixture-CDF inverse (image Flow++)
# --------------------------------------------------------------------------
def attention_work(BH, L, D):
    """One attention call on (BH, L, D): 2 L^2 D multiply-adds for q k^T and
    as many for p v per slice, 3 f32 operations (max, subtract, normalise)
    and one exp per score; q, k, v read and out written once (as
    scripts/unported_kernel_bounds.py counts them)."""
    scores = BH * L * L
    mac = 2 * 2 * BH * L * L * D
    return {"flop": mac + 3 * scores, "mac_flop": mac, "elem": 3 * scores,
            "transcendental": scores, "bytes": 4 * 4 * BH * L * D}


def check_attention_kernel(ca, ta, device, errs):
    """attention_fwd against its plain version and PyTorch's SDPA."""
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    for BH, L, D in ATTN_CASES:
        q, k, v = (torch.randn(BH, L, D, generator=g, device=device) for _ in range(3))
        out = ca.launch(q, k, v)
        torch.cuda.synchronize()
        want = ta.attention_reference(q, k, v)
        lib = F.scaled_dot_product_attention(q, k, v)
        e, e_lib = max_diff(out, want), max_diff(lib, want)
        print(f"check attention_fwd BH={BH} L={L} D={D}: max|dout|={e:.3e} "
              f"(SDPA against the plain version {e_lib:.3e})")
        check(bool(torch.isfinite(out).all()), "attention_fwd: non-finite output")
        check(torch.allclose(out, want, **ATTN_TOL), f"attention_fwd L={L} D={D}: off by {e}")
        check(torch.allclose(lib, want, **ATTN_TOL), f"SDPA L={L} D={D}: off by {e_lib}")
        errs["attention_fwd"] = max(errs["attention_fwd"], e)


def mix_inputs(B, N, K, g, device):
    """As tests/test_pallas.py: x = 2 N(0, 1), logpi = log_softmax(N(0, 1)),
    mu = N(0, 1), s = 0.3 N(0, 1); y = mix_log_cdf_forward(x)."""
    from nf_tpu_torch.bijectors.mixlogcdf import mix_log_cdf_forward

    x = 2.0 * torch.randn(B, N, generator=g, device=device)
    logpi = torch.log_softmax(torch.randn(B, N, K, generator=g, device=device), dim=-1)
    mu = torch.randn(B, N, K, generator=g, device=device)
    s = 0.3 * torch.randn(B, N, K, generator=g, device=device)
    y, _ = mix_log_cdf_forward(x, logpi, mu, s)
    return x, y, logpi, mu, s


def mixlogcdf_work(B, N, K, evaluations):
    """Operations and bytes of one mixture-inverse call on these inputs.
    Per element: exp(logpi) and exp(-s) per component and two logs (2K + 2
    transcendentals); per Newton evaluation K exps (one sigmoid each) and
    one log, about 11K + 20 f32 operations (the sigmoid's add and
    division, the CDF and pdf sums, the step, its tests); the log-det per
    component an exp and a log1p (softplus) and the log-sum-exp's exp, about
    10 f32 operations, then a log and the row sum.  Bytes: y and the three
    (B, N, K) tensors read, x and the log-det written, once each."""
    elements = B * N
    elem = evaluations * (11 * K + 20) + elements * (10 * K + 3)
    trans = elements * (2 * K + 2) + evaluations * (K + 1) + elements * (3 * K + 1)
    return {"flop": elem, "mac_flop": 0, "elem": elem, "transcendental": trans,
            "bytes": 4 * (elements * (2 + 3 * K) + B), "newton_evaluations": evaluations}


def check_mixlogcdf_kernel(cm, mlc, device, errs):
    """mix_log_cdf_inverse against its plain version, and the round trip."""
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    for B, N, K in MIX_CASES:
        x, y, logpi, mu, s = mix_inputs(B, N, K, g, device)
        xk, ldk = cm.launch(y, logpi, mu, s)
        again = cm.launch(y, logpi, mu, s)
        torch.cuda.synchronize()
        xr, ldr = mlc.mix_log_cdf_inverse_reference(y, logpi, mu, s)
        # the round trip where f32 keeps x: a y rounded next to 0 or 1 loses
        # x where the mixture's tail is thin, for the plain version alike (at
        # K = 1 on a few elements in 10^4); past K = 1 on every element
        kept = (xr - x).abs() <= MIX_ROUND_TRIP_ATOL
        ex, eld, rt = max_diff(xk, xr), max_diff(ldk, ldr), max_diff(xk[kept], x[kept])
        print(f"check mix_log_cdf_inverse B={B} N={N} K={K}: max|dx|={ex:.3e} "
              f"max|dlogdet|={eld:.3e}; round trip max|x - inv(fwd(x))|={rt:.3e} on the "
              f"{int(kept.sum())} of {kept.numel()} elements where the plain version's holds "
              f"(plain on all {max_diff(xr, x):.3e})")
        check(bool(torch.isfinite(xk).all() and torch.isfinite(ldk).all()),
              "mix_log_cdf_inverse: non-finite output")
        check(torch.allclose(xk, xr, **MIX_X_TOL), f"mix_log_cdf_inverse K={K}: x off by {ex}")
        check(eld <= MIX_LD_ATOL, f"mix_log_cdf_inverse K={K}: logdet off by {eld}")
        check(bool(kept.all()) or (K == 1 and float(kept.float().mean()) >= 0.999),
              f"mix_log_cdf_inverse K={K}: the plain version's round trip fails on "
              f"{int((~kept).sum())} elements")
        check(rt <= MIX_ROUND_TRIP_ATOL, f"mix_log_cdf_inverse K={K}: round trip {rt}")
        check(torch.equal(again[0], xk) and torch.equal(again[1], ldk),
              f"mix_log_cdf_inverse K={K}: two launches differ")
        errs["mix_log_cdf_inverse"] = max(errs["mix_log_cdf_inverse"], ex, eld)


@torch.no_grad()
def perturb_flowpp_image(model, g):
    """ActNorm shift and log-scale off identity, and each 1x1 conv's
    log-diagonal off its orthogonal init, from the seed."""
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1
    from nf_tpu_torch.bijectors.norm import ActNorm

    for m in model.modules():
        if isinstance(m, ActNorm):
            for p in (m.log_scale, m.bias):
                p.copy_(0.1 * torch.randn(p.shape, generator=g, device=g.device))
        elif isinstance(m, InvertibleConv1x1):
            m.log_s.add_(0.05 * torch.randn(m.log_s.shape, generator=g, device=g.device))


def flowpp_image_config():
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig

    return NetworkConfig(name="flow++", **NETWORK_DEFAULTS["flow++"])


def flowpp_image_main_path(device, counters, launches_of, ca):
    """flowpp-img32x1 through EvalProgram's eager chain, each call's
    launches counted (161 attention_fwd, 64 / 64 / 33 by L, nothing else);
    log p and the inverse held against the same model on the CPU."""
    from nf_tpu_torch.utils import tracing

    from nf_tpu_torch.bijectors.flowpp_coupling import MixLogAttnCoupling

    cfg = flowpp_image_config()
    model = image_model(cfg, None)
    n_couplings = sum(isinstance(m, MixLogAttnCoupling) for m in model.modules())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"flowpp-img32x1: {len(model.bijector.layers)} layers, {n_couplings} couplings, "
          f"{n_params} parameters")
    check(model.device.type == "cuda", "build_model did not default to the card")
    check((n_couplings, n_params) == (IMG_COUPLINGS, FLOWPP_IMG_PARAMS),
          f"flowpp-img32x1 has {n_couplings} couplings and {n_params} parameters")
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.init(gen)
    perturb_flowpp_image(model, gen)
    prog = model.eval_program()
    check(prog.stack is None, "flowpp-img32x1 should run the eager chain")
    x = 0.05 + 0.9 * torch.rand((IMG_BATCH,) + IMG_DIMS, generator=gen, device=device)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    want = {"attention_fwd": IMG_COUPLINGS}

    def counted(what, fn):
        with tracing.recording() as spans:
            out, by_len = launches_by_length(ca, lambda: counted_call(
                f"flowpp-img32x1 {what}", fn, want, counters, launches_of, totals))
        print(f"  attention_fwd launches by L: {by_len}")
        check(by_len == FLOWPP_IMG_LENGTHS, f"flowpp-img32x1 {what}: attention by L {by_len}")
        check(launch_paths(spans) == {"one_pass": IMG_COUPLINGS},
              f"flowpp-img32x1 {what}: attention off its one-pass kernel: "
              f"{launch_paths(spans)}")
        return out

    t0 = time.perf_counter()
    log_px = counted("log_prob", lambda: prog.log_prob(x))
    y_s, log_py = counted("sample", lambda: prog.sample(IMG_BATCH, gen))
    print(f"flowpp-img32x1 log_prob + sample took {time.perf_counter() - t0:.1f} s")
    check(log_px.shape == (IMG_BATCH,) and y_s.shape == (IMG_BATCH,) + IMG_DIMS
          and log_py.shape == (IMG_BATCH,), "flowpp-img32x1: main path output shapes")
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"flowpp-img32x1 {what}: non-finite values")
    print(f"flowpp-img32x1 log p of the pixels: mean {float(log_px.mean()):.2f}, "
          f"range [{float(log_px.min()):.2f}, {float(log_px.max()):.2f}]")
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    check(bool(torch.isfinite(z).all() and torch.isfinite(xr).all()),
          "flowpp-img32x1: non-finite round trip")
    err = (xr - x).abs()
    round_trip = {"max": float(err.max()), "median": float(err.median()),
                  "ld_max": max_diff(ld, -ldi), "ld_max_abs": float(ld.abs().max())}
    print(f"flowpp-img32x1 round trip on the data's latent: max|x - inv(fwd(x))|="
          f"{round_trip['max']:.3e} median {round_trip['median']:.3e}; "
          f"max|ld_fwd + ld_inv|={round_trip['ld_max']:.3e} "
          f"(max|ld|={round_trip['ld_max_abs']:.1f})")

    # the same state on the CPU, on a few samples (its Newton loop is slow).
    # The whole inverse is not comparable: at random init the 161 couplings
    # contract the data by about e^-11 per dimension (log-det near -11,000),
    # so the inverse expands each Newton solve's XTOL = 1e-5 residual to
    # O(1), in float64 as in f32, on either device.  Each layer's inverse of
    # its own output is well posed: it is held on the card and the CPU.
    t0 = time.perf_counter()
    n = FLOWPP_IMG_PARITY
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    cpu = image_model(cfg, "cpu", state).eval()
    with torch.no_grad():
        lp_cpu = cpu.log_prob(x[:n].cpu()).double()
        h = x[:n]
        layer_x = layer_ld = layer_rt = 0.0
        for card_layer, cpu_layer in zip(model.bijector.layers, cpu.bijector.layers):
            y, _ = card_layer(h)
            xi, ldi_layer = card_layer.inverse(y)
            xc, ldc = cpu_layer.inverse(y.cpu())
            layer_x = max(layer_x, max_diff(xi.cpu(), xc))
            layer_ld = max(layer_ld, max_diff(ldi_layer.cpu(), ldc))
            layer_rt = max(layer_rt, max_diff(xi, h))
            h = y
    lp_card = prog.log_prob(x[:n]).cpu().double()
    parity = {"samples": n, "logp_max_abs_diff": max_diff(lp_card, lp_cpu),
              "logp_max_abs": float(lp_cpu.abs().max()),
              "layer_inverse_x_max_abs_diff": layer_x, "layer_inverse_ld_max_abs_diff": layer_ld,
              "layer_round_trip_max": layer_rt}
    print(f"flowpp-img32x1 card vs CPU, {n} samples: "
          f"max|dlog p|={parity['logp_max_abs_diff']:.3e} "
          f"(max|log p|={parity['logp_max_abs']:.1f}); each of the "
          f"{len(model.bijector.layers)} layers' inverse of its own output: card vs CPU "
          f"max|dx|={layer_x:.3e} max|dlogdet|={layer_ld:.3e}, card round trip "
          f"max|dx|={layer_rt:.3e}; took {time.perf_counter() - t0:.1f} s")
    check(parity["logp_max_abs_diff"] <= IMG_LOGP_RTOL * parity["logp_max_abs"],
          "flowpp-img32x1: log p on the card disagrees with the CPU")
    check(layer_x <= FLOWPP_IMG_INV_ATOL and layer_rt <= FLOWPP_IMG_INV_ATOL,
          "flowpp-img32x1: a layer's inverse on the card disagrees with the CPU or its input")
    return dict(prog=prog, x=x, z=z, totals=totals, round_trip=round_trip, parity=parity,
                n_params=n_params)


def mixlogcdf_main_path(device, counters, launches_of):
    """The mixture inverse through its entry point,
    bijectors.mixlogcdf.mix_log_cdf_inverse, at (1024, 512, K = 8): one
    launch of its kernel, nothing else."""
    from nf_tpu_torch.bijectors.mixlogcdf import mix_log_cdf_inverse

    g = torch.Generator(device=device).manual_seed(SEED + 4)
    B, N, K = MIX_CASES[0]
    inputs = mix_inputs(B, N, K, g, device)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    xk, ld = counted_call("mix_log_cdf_inverse", lambda: mix_log_cdf_inverse(*inputs[1:]),
                          {"mix_log_cdf_inverse": 1}, counters, launches_of, totals)
    check(bool(torch.isfinite(xk).all() and torch.isfinite(ld).all())
          and max_diff(xk, inputs[0]) <= MIX_ROUND_TRIP_ATOL,
          "mix_log_cdf_inverse entry point: round trip")
    return inputs, totals


def flowpp_image_timing(fp, smi, ca):
    """flowpp-img32x1's serving rate, device idle share and the attention
    kernels' share of device time."""
    prog, x, z = fp["prog"], fp["x"], fp["z"]
    t0 = time.perf_counter()
    t_fwd = wall_ms(lambda: prog.forward(x), FLOWPP_IMG_ITERS, warmup=0)
    t_inv = wall_ms(lambda: prog.inverse(z), FLOWPP_IMG_ITERS, warmup=0)
    t1 = time.perf_counter()
    # one pair, CUDA activity only: a pair is about 200,000 ATen ops
    profile = device_breakdown(
        *profile_window(lambda: (prog.forward(x), prog.inverse(z)), 1, (ca,), warmup=False,
                        cpu=False), 1, mine=("attention_fwd_kernel",), label="attention")
    print(f"flowpp-img32x1 timing: wall {t1 - t0:.1f} s, profiled pair "
          f"{time.perf_counter() - t1:.1f} s")
    print(json.dumps({"main_path": {
        "model": f"flowpp-img32x1: {'x'.join(map(str, IMG_DIMS))} image, {IMG_COUPLINGS} "
                 f"couplings, base_filters=32, mixtures=8, {fp['n_params']} parameters",
        "batch": IMG_BATCH, "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
        "eval_fwd_inv_samples_per_s": IMG_BATCH / ((t_fwd + t_inv) / 1e3),
        "eval_profile_fwd_inv_pair": profile, "round_trip": fp["round_trip"],
        "cpu_parity": fp["parity"], "card": smi}}))


def attention_entry(ca, ta, launches, errs, sfu_per_s, device):
    """attention_fwd's entry on the kernels line, per pass of
    flowpp-img32x1: each time summed over its 64 / 64 / 33 calls at
    (4096, L, 8), L = 256 / 64 / 16, each call timed by its kernels' own
    device time (warm L2, as the chain hands the kernel what it just
    wrote)."""
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(SEED + 5)
    per_len, total = {}, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "event_ms": 0.0}
    work = dict.fromkeys(("flop", "mac_flop", "elem", "transcendental", "bytes"), 0)
    for L, calls in FLOWPP_IMG_LENGTHS.items():
        q, k, v = (torch.randn(ATTN_HEADS_BH, L, 8, generator=g, device=device)
                   for _ in range(3))
        w = attention_work(ATTN_HEADS_BH, L, 8)
        bound, by = bound_of(w, sfu_per_s)
        bound_tc, by_tc = bound_of(w, sfu_per_s, tensor_cores=True)
        t = {"ms": graph_ms(lambda: ca.launch(q, k, v), ATTN_ITERS),
             "plain_ms": graph_ms(lambda: ta.attention_reference(q, k, v), ATTN_ITERS),
             "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                    ATTN_ITERS),
             "event_ms": device_ms(lambda: ca.launch(q, k, v), ATTN_ITERS)}
        per_len[L] = {"calls_per_pass": calls, "shape": [ATTN_HEADS_BH, L, 8], **t,
                      "bound_ms": bound, "bound_by": by, "bound_tc_ms": bound_tc,
                      "bound_tc_by": by_tc, "share": bound_tc / t["ms"]}
        check(per_len[L]["share"] <= 1.0, f"attention_fwd L={L}: below its bound")
        for key in total:
            total[key] += calls * t[key]
        for key in work:
            work[key] += calls * w[key]
    return kernel_entry(
        "attention_fwd", launches, errs, work, sfu_per_s, total["ms"], total["plain_ms"],
        library_ms=total["library_ms"], event_ms=total["event_ms"],
        library_note="torch.nn.functional.scaled_dot_product_attention, f32",
        shape="per pass of flowpp-img32x1: " + " + ".join(
            f"{calls} x ({ATTN_HEADS_BH}, {L}, 8)" for L, calls in FLOWPP_IMG_LENGTHS.items()),
        per_length=per_len,
        timing="ms, plain_ms, library_ms: device time per call, 20 calls in one CUDA graph "
               "between CUDA events, warm L2, summed per pass; event_ms: CUDA events over "
               "back-to-back calls, host cost included")


def mixlogcdf_entry(cm, mlc, launches, errs, sfu_per_s, inputs):
    """mix_log_cdf_inverse's entry at (1024, 512, 8), its bound counted from
    the Newton evaluations these inputs need."""
    _, y, logpi, mu, s = inputs
    B, N, K = logpi.shape
    counts = []
    mlc._newton_solve(y, logpi, mu, s, evaluations=counts)
    evals = counts[0].cpu()
    lanes = torch.nn.functional.pad(evals.reshape(-1), (0, -evals.numel() % 32))
    work = mixlogcdf_work(B, N, K, int(evals.sum()))
    registers, per_sm, _ = cm.kernel_info(K)
    rows = cm.launch_rows(y, K)
    return kernel_entry(
        "mix_log_cdf_inverse", launches, errs, work, sfu_per_s,
        graph_ms(lambda: cm.launch(y, logpi, mu, s), MIX_ITERS),
        graph_ms(lambda: mlc.mix_log_cdf_inverse_reference(y, logpi, mu, s), 3),
        event_ms=device_ms(lambda: cm.launch(y, logpi, mu, s), MIX_ITERS),
        library_note="no single PyTorch call inverts a mixture CDF",
        shape=[B, N, K], newton_evaluations=work["newton_evaluations"],
        newton_evaluations_mean=float(evals.double().mean()),
        warp_newton_evaluations=cm.warp_evaluations(evals, rows),
        lockstep_warp_newton_evaluations=32 * int(lanes.view(-1, 32).amax(1).sum()),
        registers=registers, blocks_per_sm=per_sm, block_warps=cm.WARPS,
        warps_per_sm=per_sm * cm.WARPS, rows_per_block=rows, blocks=-(-B // rows),
        schedule="warp_newton_evaluations: 32 lane slots per trip of every warp under lane "
                 "refill (ops/cuda/mixlogcdf.py part_trips); lockstep_...: the same if each "
                 "lane took one element and its warp waited for the slowest",
        timing="ms, plain_ms: device time per call in one CUDA graph between CUDA events; "
               "event_ms: CUDA events over back-to-back calls, host cost included")



def ptxas_summary(log):
    """One line per kernel instantiation from nvcc's -Xptxas -v output:
    its template arguments, registers and spill bytes."""
    out, args, spill = [], "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?kernelI(\w*?)EEv", line)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)", m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"<{args}> {m.group(1)} registers, {spill}")
    return out


# --------------------------------------------------------------------------
# FFJORD and Flow++ variational dequantization: no kernel of the port
# --------------------------------------------------------------------------
FFJORD_TRAIN_BATCH = 1024   # bench.py:36 TRAIN_BATCH
FFJORD_TRAIN_CHUNK = 4
FFJORD_PARITY = 256         # samples held against the same state on the CPU
FFJORD_ITERS = 5            # calls per direction timed, after one warm-up
FFJORD_ROUND_TRIP_ATOL = 1e-3   # two dopri5 solves at rtol / atol 1e-4
FFJORD_LOGP_RTOL = 1e-4     # of the largest |log p|
# the inverse's x, card vs CPU: f32 sums in another order can flip an
# accept decision at err ~ 1, and the two solves then differ by the
# solver's tolerance
FFJORD_INV_ATOL = 1e-3
# backprop 'normal' against the adjoint: the adjoint solves its backward on
# its own steps, so the two differ by the solver's tolerance (relative L2)
FFJORD_NORMAL_REL = 1e-2
FFJORD_VARIANTS = [("rk4", dict(solver="rk4")), ("midpoint", dict(solver="midpoint")),
                   ("bosha3", dict(solver="bosha3")), ("trace=exact", dict(trace="exact")),
                   ("backprop=normal", dict(backprop="normal"))]
FFJORD_IMG_DIMS = (16, 16, 1)
FFJORD_IMG_BATCH = 64
# flowpp-img32x1 with variational dequantization: training at B = 256, a
# cut from bench.py's 1024 (23.5 GiB at 256 on an H100; 1024 would not fit)
VD_BATCH = 256
VD_TRAIN_CHUNK = 2
VD_PARITY = 4


def circles(n, rng):
    """nf_tpu's default toy density (nf_tpu/data/toy.py sample_circles):
    two concentric circles, radii 1.0 / 0.5, noise 0.08, scaled by 0.6."""
    n_out = n // 2
    t = rng.uniform(0.0, 2 * math.pi, size=n)
    r = np.where(np.arange(n) < n_out, 1.0, 0.5)
    x = r * np.cos(t) + rng.normal(0.0, 0.08, size=n)
    y = r * np.sin(t) + rng.normal(0.0, 0.08, size=n)
    return (np.stack([x, y], axis=1) * 0.6).astype(np.float32)


def cnfs_of(model):
    from nf_tpu_torch.bijectors.cnf import CNF

    return [m for m in model.modules() if isinstance(m, CNF)]


def inject_probes(model, probes):
    """Each CNF's probes (a list, one per CNF, or None to draw again)."""
    for i, m in enumerate(cnfs_of(model)):
        m.injected_probes = None if probes is None else probes[i]


def solve_stats(model, reset=False):
    """The CNFs' solve counts summed: solves, dynamics evaluations,
    accepted and rejected steps."""
    from nf_tpu_torch.ops.odeint import SolveStats

    total = SolveStats()
    for m in cnfs_of(model):
        total.add(m.stats)
        if reset:
            m.stats = SolveStats()
    return total.__dict__


def per_solve(stats):
    n = max(stats["solves"], 1)
    return {"solves": stats["solves"],
            **{f"{k}_per_solve": stats[k] / n for k in ("evaluations", "accepted", "rejected")}}


def profiled_idle(fn):
    """A profiled window of one call (CUDA activity only): the device idle
    share, its device ms, the kernel records kept and the six longest
    kernels' device ms.  An upper bound of the idle share: the profiler
    may drop records (see kernel_ms)."""
    wall_us, kernels, records, _ = profile_window(fn, 1, (), warmup=False, cpu=False)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"device_idle_share": None if busy <= 0 else 1.0 - busy / wall_us,
            "window_wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
            "kernel_records": sum(records.values()),
            "top_kernels_ms": [[k[:100], v / 1e3] for k, v in top]}


def parity_runs(make_model, state, body, card):
    """``body(model, device, dtype)`` for the same state on the card (f32,
    ``card`` the device) and on the CPU (f32 and float64)."""
    out = {}
    for run, (device, dtype) in {"card": (card, torch.float32), "cpu": ("cpu", torch.float32),
                                 "cpu64": ("cpu", torch.float64)}.items():
        model = make_model(device)
        model.load_state_dict(state)
        out[run] = body(model.to(dtype), device, dtype)
    return out


def held_logp_and_grads(label, logp, grads):
    """log p card vs CPU within FFJORD_LOGP_RTOL of the largest |log p|,
    the card's gradients no further from float64 than IMG_GRAD_FACTOR times
    the CPU's (relative L2), both printed against float64."""
    def rel_l2(run):
        return float((grads[run] - grads["cpu64"]).norm() / grads["cpu64"].norm())

    out = {"logp_max_abs_diff": max_diff(logp["card"], logp["cpu"]),
           "logp_max_abs": float(logp["cpu64"].abs().max()),
           "logp_f64_max_abs_diff": {r: max_diff(logp[r], logp["cpu64"]) for r in ("card", "cpu")}}
    if grads:
        out["grad_rel_l2_to_f64"] = {r: rel_l2(r) for r in ("card", "cpu")}
    print(f"{label} card vs CPU: max|dlog p|={out['logp_max_abs_diff']:.3e} (max|log p|="
          f"{out['logp_max_abs']:.2f}; to float64: card {out['logp_f64_max_abs_diff']['card']:.3e},"
          f" CPU {out['logp_f64_max_abs_diff']['cpu']:.3e})"
          + (f"; gradients relative L2 to float64: card {out['grad_rel_l2_to_f64']['card']:.3e},"
             f" CPU {out['grad_rel_l2_to_f64']['cpu']:.3e}" if grads else ""))
    check(out["logp_max_abs_diff"] <= FFJORD_LOGP_RTOL * out["logp_max_abs"],
          f"{label}: log p on the card disagrees with the CPU")
    if grads:
        check(out["grad_rel_l2_to_f64"]["card"] <= IMG_GRAD_FACTOR
              * out["grad_rel_l2_to_f64"]["cpu"],
              f"{label}: gradients on the card are less accurate than the CPU's")
    return out


def ffjord_probes(n_cnfs, shape, n_probes, seed):
    """Probes drawn on the CPU from a seeded generator, one set per CNF."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((n_probes,) + tuple(shape), generator=g) for _ in range(n_cnfs)]


def flat_grads(model):
    return torch.cat([p.grad.reshape(-1).cpu().double() for p in model.parameters()])


def ffjord_cpu_parity(label, cfg, dims, datatype, state, xs, card, grads=True):
    """Eval-mode log p (4 injected probes per CNF) and, with ``grads``, one
    train-mode gradient (1 injected probe per CNF) on ``xs`` for the same
    state on the card and on the CPU in f32 and float64."""
    from nf_tpu_torch.models import build_model

    n = len(cnfs_of(build_model("ffjord", dims, datatype, cfg, device="cpu")))
    eval_v = ffjord_probes(n, xs.shape, 4, SEED + 11)
    train_v = ffjord_probes(n, xs.shape, 1, SEED + 12)
    logp, grad = {}, {}

    def body(model, device, dtype):
        x = xs.to(device=device, dtype=dtype)
        inject_probes(model, eval_v)
        with torch.no_grad():
            lp = model.eval().log_prob(x).cpu().double()
        g = None
        if grads:
            inject_probes(model, train_v)
            model.train()
            (-model.log_prob(x).mean()).backward()
            g = flat_grads(model)
        return lp, g

    out = parity_runs(lambda d: build_model("ffjord", dims, datatype, cfg, device=d), state,
                      body, card)
    for run, (lp, g) in out.items():
        logp[run], grad[run] = lp, g
    return held_logp_and_grads(label, logp, grad if grads else {})


def ffjord_main_path(device, counters, launches_of, smi):
    """FFJORD 2-D at the density zoo's shape (NETWORK_DEFAULTS["ffjord"]:
    3 x [ActNorm -> CNF], dopri5 at rtol / atol 1e-4, the adjoint,
    Hutchinson, base_filters 32) through Trainer and EvalProgram on the
    card, no launch of any port kernel; then the other solvers and traces,
    and the image opt-in.  Prints its main_path lines."""
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    cfg = NetworkConfig(name="ffjord", **NETWORK_DEFAULTS["ffjord"])
    model = build_model("ffjord", (2,), "2d", cfg)
    check(model.device.type == "cuda", "build_model did not default to the card")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ffjord 2d: {len(cnfs_of(model))} CNFs, {n_params} parameters, times "
          f"{cnfs_of(model)[0].times.tolist()}")
    rng = np.random.default_rng(SEED)
    B, K = FFJORD_TRAIN_BATCH, FFJORD_TRAIN_CHUNK
    batch0 = torch.from_numpy(circles(B, rng)).to(device)
    chunk = torch.from_numpy(circles(K * B, rng).reshape(K, B, 2)).to(device)
    x = torch.from_numpy(circles(BATCH, rng)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer = Trainer(model, OptimizerConfig(), seed=SEED)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)

    def counted(what, fn):
        return counted_call(f"ffjord {what}", fn, {}, counters, launches_of, totals)

    solve_stats(model, reset=True)
    t0 = time.perf_counter()
    ts = counted("init_state", lambda: trainer.init_state(batch0))
    t_init = (time.perf_counter() - t0) * 1e3
    init_stats = solve_stats(model, reset=True)
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts, losses = counted(f"train_steps K={K}", lambda: trainer.train_steps(ts, chunk))
    t_chunk = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    train_stats = solve_stats(model, reset=True)
    losses = losses.tolist()
    print(f"ffjord losses (nats per sample) {losses}; {t_chunk / K:.1f} ms per Adam step at "
          f"B={B}; train peak memory {peak / 2**30:.3f} GiB; solves {per_solve(train_stats)}")
    check(all(math.isfinite(v) for v in losses), "ffjord: non-finite loss")
    train_profile = profiled_idle(lambda: trainer.train_step(ts, chunk[0]))
    solve_stats(model, reset=True)
    prog = model.eval_program()
    check(prog.stack is None, "ffjord: a fused kernel matched")
    log_px = counted("log_prob", lambda: prog.log_prob(x))
    y_s, log_py = counted("sample", lambda: prog.sample(BATCH, gen))
    check(log_px.shape == (BATCH,) and y_s.shape == (BATCH, 2) and log_py.shape == (BATCH,),
          "ffjord: main path output shapes")
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"ffjord {what}: non-finite values")
    solve_stats(model, reset=True)
    z, ld = prog.forward(x)
    fwd_stats = solve_stats(model, reset=True)
    xr, ldi = prog.inverse(z)
    inv_stats = solve_stats(model, reset=True)
    rt, ld_sum = max_diff(xr, x), max_diff(ld, -ldi)
    print(f"ffjord round trip: max|x - inv(fwd(x))|={rt:.3e} max|ld_fwd + ld_inv|={ld_sum:.3e};"
          f" forward {per_solve(fwd_stats)}, inverse {per_solve(inv_stats)}")
    check(rt < FFJORD_ROUND_TRIP_ATOL, "ffjord: round trip")
    t_fwd = wall_ms(lambda: prog.forward(x), FFJORD_ITERS, warmup=1)
    t_inv = wall_ms(lambda: prog.inverse(z), FFJORD_ITERS, warmup=1)
    eval_profile = profiled_idle(lambda: prog.forward(x))
    t0 = time.perf_counter()
    parity = ffjord_cpu_parity("ffjord", cfg, (2,), "2d", state, x[:FFJORD_PARITY].cpu(),
                               device)
    print(f"card vs CPU parity took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"main_path": {
        "model": f"ffjord 2d, 3 x [ActNorm -> CNF], dopri5 rtol/atol 1e-4, adjoint, "
                 f"hutchinson, base_filters 32, {n_params} parameters: the eager chain (no "
                 f"kernel of the port, as nf_tpu runs no Pallas kernel there)",
        "batch": BATCH, "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
        "calls": FFJORD_ITERS, "fwd_inv_samples_per_s": BATCH / ((t_fwd + t_inv) / 1e3),
        "forward_solves": per_solve(fwd_stats), "inverse_solves": per_solve(inv_stats),
        "eval_profile_forward": eval_profile,
        "train_batch": B, "train_chunk": K, "init_state_ms": t_init,
        "init_state_solves": per_solve(init_stats),
        "train_chunk_ms": t_chunk, "train_step_ms": t_chunk / K,
        "train_samples_per_s": K * B / (t_chunk / 1e3), "train_solves": per_solve(train_stats),
        "train_profile_step": train_profile, "train_peak_memory_bytes": peak,
        "losses": losses, "round_trip": {"max": rt, "ld_max": ld_sum},
        "cpu_parity": parity, "card": smi}}))
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ffjord_variants(cfg, trained, x, device, counters, launches_of, totals, smi)
    ffjord_image(device, counters, launches_of, totals, smi)


def ffjord_variants(cfg, state, x, device, counters, launches_of, totals, smi):
    """The other solvers and traces on the trained state at B = 8192: one
    forward and one inverse each, finite, against the CPU on 256 samples;
    backprop 'normal' also one step's gradients against the adjoint's."""
    from nf_tpu_torch.models import build_model

    n = FFJORD_PARITY
    xs = x[:n].cpu()
    cpu_state = {k: v.cpu() for k, v in state.items()}
    for label, kw in FFJORD_VARIANTS:
        vcfg = dataclasses.replace(cfg, **kw)
        model = build_model("ffjord", (2,), "2d", vcfg)
        model.load_state_dict(state)
        prog = model.eval_program()
        t0 = time.perf_counter()
        z, ld = counted_call(f"ffjord {label} forward", lambda: prog.forward(x), {}, counters,
                             launches_of, totals)
        t_fwd = (time.perf_counter() - t0) * 1e3
        fwd_stats = solve_stats(model, reset=True)
        t0 = time.perf_counter()
        xr, ldi = counted_call(f"ffjord {label} inverse", lambda: prog.inverse(z), {}, counters,
                               launches_of, totals)
        t_inv = (time.perf_counter() - t0) * 1e3
        inv_stats = solve_stats(model, reset=True)
        for t, what in ((z, "z"), (ld, "logdet"), (xr, "x"), (ldi, "inverse logdet")):
            check(bool(torch.isfinite(t).all()), f"ffjord {label} {what}: non-finite values")
        parity = ffjord_cpu_parity(f"ffjord {label}", vcfg, (2,), "2d", cpu_state, xs, device,
                                   grads=False)
        # the inverse of the same 256 latents on both devices
        eval_v = ffjord_probes(3, xs.shape, 4, SEED + 13)
        inv = {}
        for dev in (device, "cpu"):
            m = build_model("ffjord", (2,), "2d", vcfg, device=dev)
            m.load_state_dict(state)
            inject_probes(m, eval_v)
            with torch.no_grad():
                inv[dev] = m.eval().inverse(z[:n].to(dev))[0].cpu()
        e_inv = max_diff(inv[device], inv["cpu"])
        line = {"variant": label, "batch": BATCH, "forward_ms": t_fwd, "inverse_ms": t_inv,
                "forward_solves": per_solve(fwd_stats), "inverse_solves": per_solve(inv_stats),
                "round_trip_max": max_diff(xr, x), "cpu_parity": parity,
                "inverse_card_vs_cpu_max_abs": e_inv}
        check(e_inv <= FFJORD_INV_ATOL, f"ffjord {label}: inverse on the card disagrees")
        if kw.get("backprop") == "normal":
            train_v = ffjord_probes(3, xs.shape, 1, SEED + 14)
            grads = {}
            for bp, c in (("normal", vcfg), ("adjoint", cfg)):
                m = build_model("ffjord", (2,), "2d", c)
                m.load_state_dict(state)
                inject_probes(m, train_v)
                m.train()
                (-m.log_prob(xs.to(device)).mean()).backward()
                grads[bp] = flat_grads(m)
            rel = float((grads["normal"] - grads["adjoint"]).norm() / grads["adjoint"].norm())
            line["normal_vs_adjoint_grad_rel_l2"] = rel
            check(rel <= FFJORD_NORMAL_REL, f"ffjord: normal and adjoint gradients {rel}")
        print(json.dumps({"ffjord_variant": {**line, "card": smi}}))


def ffjord_image(device, counters, launches_of, totals, smi):
    """FFJORD's image opt-in (allow_image): Logit then 1 x [ActNorm -> CNF
    with the conv ODENet], base_filters 32, at 16x16x1, B = 64: one forward
    and one inverse on the card, log p against the CPU."""
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="ffjord", **{**NETWORK_DEFAULTS["ffjord"], "layers": 1,
                                          "allow_image": True})
    dims = FFJORD_IMG_DIMS
    model = build_model("ffjord", dims, "image", cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.init(gen)
    x = 0.05 + 0.9 * torch.rand((FFJORD_IMG_BATCH,) + dims, generator=gen, device=device)
    model.data_dependent_init(x)
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    prog = model.eval_program()
    solve_stats(model, reset=True)
    t0 = time.perf_counter()
    z, ld = counted_call("ffjord image forward", lambda: prog.forward(x), {}, counters,
                         launches_of, totals)
    t_fwd = (time.perf_counter() - t0) * 1e3
    fwd_stats = solve_stats(model, reset=True)
    t0 = time.perf_counter()
    xr, ldi = counted_call("ffjord image inverse", lambda: prog.inverse(z), {}, counters,
                           launches_of, totals)
    t_inv = (time.perf_counter() - t0) * 1e3
    inv_stats = solve_stats(model, reset=True)
    for t, what in ((z, "z"), (ld, "logdet"), (xr, "x"), (ldi, "inverse logdet")):
        check(bool(torch.isfinite(t).all()), f"ffjord image {what}: non-finite values")
    rt = max_diff(xr, x)
    parity = ffjord_cpu_parity("ffjord image 16x16x1", cfg, dims, "image", state, x.cpu(),
                               device, grads=False)
    print(json.dumps({"ffjord_image": {
        "model": "ffjord image 16x16x1 (allow_image): Logit -> 1 x [ActNorm -> CNF, conv "
                 "ODENet], dopri5 rtol/atol 1e-4, hutchinson, base_filters 32",
        "batch": FFJORD_IMG_BATCH, "forward_ms": t_fwd, "inverse_ms": t_inv,
        "forward_solves": per_solve(fwd_stats), "inverse_solves": per_solve(inv_stats),
        "round_trip_max": rt, "cpu_parity": parity, "card": smi}}))
    check(rt < FFJORD_ROUND_TRIP_ATOL, "ffjord image: round trip")


def vardequant_main_path(device, counters, launches_of, smi):
    """flowpp-img32x1 with var_dequant=True at full width: Trainer.init_state
    -> K = 2 Adam steps at B = 256 -> Trainer.log_prob with a generator;
    an EvalProgram raises ValueError (no generator); the first step's loss
    and gradients on 4 samples against the CPU with the same injected
    dequantization noise."""
    from nf_tpu_torch.bijectors.flowpp_coupling import MixLogAttnCoupling
    from nf_tpu_torch.bijectors.vardequant import VariationalDequant
    from nf_tpu_torch.config import OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    cfg = dataclasses.replace(flowpp_image_config(), var_dequant=True)
    model = image_model(cfg, None)
    head = model.bijector.layers[0]
    n_couplings = sum(isinstance(m, MixLogAttnCoupling) for m in model.modules())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"flowpp-img32x1 var_dequant: {n_couplings} couplings, {n_params} parameters "
          f"({sum(p.numel() for p in head.parameters())} in the dequantization head)")
    check(isinstance(head, VariationalDequant) and n_couplings == IMG_COUPLINGS,
          "flowpp-img32x1 var_dequant: structure")
    gen = torch.Generator(device=device).manual_seed(SEED)
    B, K = VD_BATCH, VD_TRAIN_CHUNK

    def pixels(*shape):
        return 0.05 + 0.9 * torch.rand(shape, generator=gen, device=device)

    batch0, chunk, x = pixels(B, *IMG_DIMS), pixels(K, B, *IMG_DIMS), pixels(B, *IMG_DIMS)
    trainer = Trainer(model, OptimizerConfig(), seed=SEED)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    n = IMG_COUPLINGS

    def counted(what, fn, want):
        return counted_call(f"flowpp-img32x1 var_dequant {what}", fn, want, counters,
                            launches_of, totals)

    t0 = time.perf_counter()
    ts = counted("init_state", lambda: trainer.init_state(batch0), {"attention_fwd": n})
    t_init = (time.perf_counter() - t0) * 1e3
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts, losses = counted(f"train_steps K={K}", lambda: trainer.train_steps(ts, chunk),
                         {"attention_fwd": K * n})
    t_chunk = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    check(all(math.isfinite(v) for v in losses), "flowpp-img32x1 var_dequant: non-finite loss")
    d = math.prod(IMG_DIMS)
    with torch.no_grad():
        model.eval()
        _, head_ld = head(x, torch.Generator(device=device).manual_seed(SEED + 1))
    neg_logq = float((head_ld + d * math.log(256)).mean())
    print(f"flowpp-img32x1 var_dequant losses {losses}; {t_chunk / K:.1f} ms per Adam step at "
          f"B={B}; train peak memory {peak / 2**30:.2f} GiB; ELBO terms per sample: "
          f"-log q(u|x) = {neg_logq:.2f}, D log 256 = {d * math.log(256):.2f}")
    lp = counted("Trainer.log_prob", lambda: trainer.log_prob(
        ts, x, torch.Generator(device=device).manual_seed(SEED + 2)), {"attention_fwd": n})
    check(lp.shape == (B,) and bool(torch.isfinite(lp).all()),
          "flowpp-img32x1 var_dequant: Trainer.log_prob")
    try:
        model.eval_program().forward(x)
        check(False, "flowpp-img32x1 var_dequant: an EvalProgram drew no noise and did not "
                     "raise")
    except ValueError as e:
        print(f"eval_program(...).forward raises ValueError: {e}")
    t0 = time.perf_counter()
    xs = x[:VD_PARITY].cpu()
    eps = torch.randn(xs.shape, generator=torch.Generator().manual_seed(SEED + 3))
    loss, logp, grads = {}, {}, {}

    def body(model, device, dtype):
        model.bijector.layers[0].injected_eps = eps
        model.train()
        lp = model.log_prob(xs.to(device=device, dtype=dtype),
                            torch.Generator(device=device).manual_seed(0))
        (-lp.mean()).backward()
        return lp.detach().cpu().double(), flat_grads(model)

    out = parity_runs(lambda dev: image_model(cfg, dev), state, body, device)
    for run, (lp_, g) in out.items():
        logp[run], grads[run] = lp_, g
    parity = held_logp_and_grads("flowpp-img32x1 var_dequant (train mode, first step)", logp,
                                 grads)
    print(f"card vs CPU parity took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"main_path": {
        "model": f"flowpp-img32x1 with var_dequant: 32x32x1, {n_couplings} couplings, "
                 f"{n_params} parameters",
        "train_batch": B, "train_chunk": K, "init_state_ms": t_init,
        "train_chunk_ms": t_chunk, "train_step_ms": t_chunk / K,
        "train_samples_per_s": K * B / (t_chunk / 1e3), "train_peak_memory_bytes": peak,
        "losses": losses, "elbo_neg_log_q": neg_logq, "elbo_d_log_256": d * math.log(256),
        "attention_launches": totals["attention_fwd"], "cpu_parity": parity, "card": smi}}))
    return vardequant_evaluation(model, ts, counted)


def vardequant_evaluation(model, ts, counted):
    """The trained var_dequant state saved, then scored by the held-out
    evaluator; returns its attention_fwd launches."""
    from nf_tpu_torch import evaluate as ev
    from nf_tpu_torch.train import save_checkpoint

    n = IMG_COUPLINGS
    label = "evaluate heldout_image_nll flowpp-img32x1 var_dequant"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "latest.npz")
        save_checkpoint(path, model, ts)
        t0 = time.perf_counter()
        want = n * (1 + ev.N_HELDOUT // ev.IMAGE_BATCH)
        r = counted("heldout_image_nll", lambda: ev.heldout_image_nll(
            path, network="flow++", vardequant=True, scan=False, remat=False, draws=1),
            {"attention_fwd": want})
        seconds = time.perf_counter() - t0
    print(image_bits_line(label, r, seconds) + f"; {want} attention_fwd launches, {n} a pass "
          f"as phase 6's served pass")
    check_image_bits(label, r, VD_TRAIN_CHUNK, 1)
    check(r["vardequant"] is True, f"{label}: {r}")
    print(json.dumps({"evaluate_vardequant": {**r, "wall_s": seconds,
                                              "attention_launches": want}}))
    return want


# --------------------------------------------------------------------------
# ResFlow training (2-D and the image branch): no kernel of the port while
# it trains; the trained 2-D state is served by the fused ResFlow kernels
# --------------------------------------------------------------------------
RF_TRAIN_BATCH = 1024    # bench.py:36 TRAIN_BATCH
RF_TRAIN_CHUNK = 8       # bench.py:35 TRAIN_CHUNK
RF_PARITY = 256          # samples held against the same state on the CPU
RF_ITERS = 20            # calls per direction timed of the trained 2-D program
# gradients card vs CPU float64, relative L2: within twice the CPU's own f32
# distance, or this, whichever is larger (both are near f32 rounding)
RF_GRAD_REL_FLOOR = 1e-5
# resflow-img32x1: build_model("resflow", (32, 32, 1), "image") with the zoo's
# ResFlow config and allow_image (32 conv blocks on 16x16x4, width 32)
RF_IMG_DIMS = (32, 32, 1)
RF_IMG_PARAMS = 371_136
RF_IMG_BATCH = 1024
RF_IMG_TRAIN_CHUNK = 4
RF_IMG_PARITY = 16
RF_IMG_ITERS = 2         # calls per direction timed, after one warm-up
RF_IMG_ROUND_TRIP_ATOL = 1e-3   # nf_tpu's own (tests/test_zoo_image_optin.py:30)


class SeriesRecorder:
    """Records, while in use, the series lengths each training block draws
    (``draw_train_probes``) and the fixed-point trips of each block's
    solve; the library's functions are restored on exit."""

    def __enter__(self):
        from nf_tpu_torch.bijectors.iresblock import InvertibleResBlock
        from nf_tpu_torch.ops import estimators as est

        self.train_lengths, self.trips = [], []
        self._draw, self._solve = est.draw_train_probes, InvertibleResBlock.solve

        def draw(shape, generator):
            d = self._draw(shape, generator)
            self.train_lengths.append((d[0][0], d[1][0]))
            return d

        def solve(block, z):
            x, it = self._solve(block, z)
            self.trips.append(it)
            return x, it

        est.draw_train_probes, InvertibleResBlock.solve = draw, solve
        return self

    def __exit__(self, *exc):
        from nf_tpu_torch.bijectors.iresblock import InvertibleResBlock
        from nf_tpu_torch.ops import estimators as est

        est.draw_train_probes, InvertibleResBlock.solve = self._draw, self._solve

    def lengths_summary(self):
        if not self.train_lengths:
            return None
        v, g = (np.array(c, dtype=np.float64) for c in zip(*self.train_lengths))
        return {"draws": len(v), "value_mean": float(v.mean()), "value_max": int(v.max()),
                "neumann_mean": float(g.mean()), "neumann_max": int(g.max())}


def resflow_blocks(model):
    from nf_tpu_torch.bijectors.iresblock import InvertibleResBlock

    return [m for m in model.modules() if isinstance(m, InvertibleResBlock)]


def resflow_cpu_parity(label, make_model, state, xs, inner, card):
    """log p in eval (the serving probes drawn on the CPU and handed to
    both) and the first train step's log p and gradients (each block's two
    training draws injected on both) on ``xs`` for the same state on the
    card and on the CPU in f32 and float64: eval and train log p within
    IMG_LOGP_RTOL of the largest |log p|, the gradients' relative L2 to
    float64 within max(IMG_GRAD_FACTOR x the CPU's, RF_GRAD_REL_FLOOR)."""
    from nf_tpu_torch.ops.estimators import draw_train_probes, draw_unbias_probes

    g = torch.Generator().manual_seed(SEED + 21)
    n_blocks = len(resflow_blocks(make_model("cpu")))
    shape = (xs.shape[0],) + tuple(inner)
    V, n_terms = draw_unbias_probes(xs.shape[0], math.prod(inner), g)
    probes = (V.reshape((V.shape[0],) + shape), n_terms)
    draws = [draw_train_probes(shape, g) for _ in range(n_blocks)]

    def body(model, device, dtype):
        x = xs.to(device=device, dtype=dtype)
        lp_eval = None
        if dtype == torch.float32:     # the serving program computes in f32
            prog = model.eval_program(probes=(probes[0].to(device), probes[1]))
            lp_eval = prog.log_prob(x).cpu().double()
        for b, d in zip(resflow_blocks(model), draws):
            b.injected_train_probes = d
        model.train()
        lp = model.log_prob(x)
        (-lp.mean()).backward()
        return lp_eval, lp.detach().cpu().double(), flat_grads(model)

    out = parity_runs(make_model, state, body, card)
    lp_eval, lp, grads = ({r: o[i] for r, o in out.items()} for i in range(3))
    top = max(float(lp["cpu"].abs().max()), float(lp_eval["cpu"].abs().max()))
    rel = {r: float((grads[r] - grads["cpu64"]).norm() / grads["cpu64"].norm())
           for r in ("card", "cpu")}
    res = {"samples": xs.shape[0],
           "eval_logp_max_abs_diff": max_diff(lp_eval["card"], lp_eval["cpu"]),
           "train_logp_max_abs_diff": max_diff(lp["card"], lp["cpu"]), "logp_max_abs": top,
           "logp_f64_max_abs_diff": {r: max_diff(lp[r], lp["cpu64"]) for r in ("card", "cpu")},
           "grad_rel_l2_to_f64": rel}
    print(f"{label} card vs CPU, {xs.shape[0]} samples: eval max|dlog p|="
          f"{res['eval_logp_max_abs_diff']:.3e}, first step max|dlog p|="
          f"{res['train_logp_max_abs_diff']:.3e} (max|log p|={top:.2f}); gradients relative "
          f"L2 to float64: card {rel['card']:.3e}, CPU {rel['cpu']:.3e}")
    check(max(res["eval_logp_max_abs_diff"], res["train_logp_max_abs_diff"])
          <= IMG_LOGP_RTOL * top, f"{label}: log p on the card disagrees with the CPU")
    check(rel["card"] <= max(IMG_GRAD_FACTOR * rel["cpu"], RF_GRAD_REL_FLOOR),
          f"{label}: gradients on the card are less accurate than the CPU's")
    return res


def moved_off(state0, model, suffixes):
    """How many of the buffers / parameters ending in ``suffixes`` moved."""
    now = model.state_dict()
    names = [k for k in state0 if k.endswith(suffixes)]
    return sum(not torch.equal(now[k].cpu(), state0[k]) for k in names), len(names)


def resflow_train_main_path(device, counters, launches_of, smi, rf, errs):
    """ResFlow 2-D at the zoo's shape (NETWORK_DEFAULTS["resflow"]: 32 x
    [ActNorm -> i-ResNet block], F = 32, coeff 0.9, 'unbias'): Trainer ->
    K = 8 Adam steps at B = 1024 (no kernel launch: training is the eager
    chain with the memory-saved Function, as nf_tpu's runs no Pallas
    kernel) -> eval_program at B = 8192 through the fused fwd_ld /
    solve_ld kernels, each held against its plain version on the trained
    weights; then resflow-img32x1 trains and serves (the eager chain).
    Returns the fused kernels' launch counts of the served calls."""
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    cfg = NetworkConfig(name="resflow", **NETWORK_DEFAULTS["resflow"])
    model = build_model("resflow", (2,), "2d", cfg)
    check(model.device.type == "cuda", "build_model did not default to the card")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"resflow 2d training: {len(resflow_blocks(model))} blocks, {n_params} parameters")
    rng = np.random.default_rng(SEED + 5)
    B, K = RF_TRAIN_BATCH, RF_TRAIN_CHUNK
    batch0 = torch.from_numpy(circles(B, rng)).to(device)
    # shuffled: circles() puts the outer circle's samples first
    chunk = torch.from_numpy(rng.permutation(circles(K * B, rng)).reshape(K, B, 2)).to(device)
    x = torch.from_numpy(circles(BATCH, rng)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer = Trainer(model, OptimizerConfig(), seed=SEED)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    fwd_name, inv_name = MODELS["resflow"]

    def counted(what, fn, want):
        return counted_call(f"resflow {what}", fn, want, counters, launches_of, totals)

    ts = counted("init_state", lambda: trainer.init_state(batch0), {})
    state0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    with SeriesRecorder() as rec:
        t0 = time.perf_counter()
        ts, losses = counted(f"train_steps K={K}", lambda: trainer.train_steps(ts, chunk), {})
        t_chunk = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    moved = {s: moved_off(state0, model, (s,)) for s in (".u", ".v", ".beta")}
    print(f"resflow 2d losses {losses}; {t_chunk / K:.1f} ms per Adam step at B={B}; train "
          f"peak memory {peak / 2**30:.3f} GiB; series lengths {rec.lengths_summary()}; "
          f"moved off init (moved, of): {moved}")
    check(all(math.isfinite(v) for v in losses), "resflow 2d: non-finite loss")
    check(all(m == n and n > 0 for m, n in moved.values()),
          f"resflow 2d: training left u, v or the betas at init: {moved}")

    prog = model.eval_program()
    check(isinstance(prog.stack, rf.PackedResFlow), "resflow 2d: the trained stack missed "
                                                    "its fused kernel")
    log_px = counted("trained log_prob", lambda: prog.log_prob(x), {fwd_name: 1})
    y_s, log_py = counted("trained sample", lambda: prog.sample(BATCH, gen), {inv_name: 1})
    check(log_px.shape == (BATCH,) and y_s.shape == (BATCH, 2) and log_py.shape == (BATCH,),
          "resflow 2d trained: main path output shapes")
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"resflow 2d trained {what}: non-finite values")
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    rt, ld_sum = max_diff(xr, x), max_diff(ld, -ldi)
    check(rt < RESFLOW_INV_ATOL and ld_sum < RESFLOW_INV_ATOL, "resflow 2d trained: round trip")
    # the kernels against their plain versions on the trained weights
    stack, probes = prog.stack, prog._probes(x)
    zr, ldr = rf.fused_resflow_fwd_logdet_reference(stack.spec, stack.packed, x, probes)
    zk, ldk = rf.launch(stack, x, "forward", probes)
    trips = []
    xw, ldiw = rf.fused_resflow_solve_logdet_reference(stack.spec, stack.packed, zr, probes,
                                                       trips)
    xk, ldik = rf.launch(stack, zr, "inverse", probes)
    torch.cuda.synchronize()
    e = {fwd_name: (max_diff(zk, zr), max_diff(ldk, ldr)),
         inv_name: (max_diff(xk, xw), max_diff(ldik, ldiw))}
    print(f"check on the trained weights: {fwd_name} max|dz|={e[fwd_name][0]:.3e} "
          f"max|dlogdet|={e[fwd_name][1]:.3e}; {inv_name} max|dx|={e[inv_name][0]:.3e} "
          f"max|dlogdet|={e[inv_name][1]:.3e}; trips per block (plain, whole batch) {trips}; "
          f"serving n_terms {probes[1].tolist()}")
    check(torch.allclose(zk, zr, **Z_TOL) and e[fwd_name][1] <= LD_ATOL,
          f"{fwd_name}: disagrees with its plain version on the trained weights")
    check(max(e[inv_name]) <= RESFLOW_INV_ATOL,
          f"{inv_name}: disagrees with its plain version on the trained weights")
    for name, pair in e.items():
        errs[name] = max(errs[name], *pair)
    t_fwd = wall_ms(lambda: prog.forward(x), RF_ITERS)
    t_inv = wall_ms(lambda: prog.inverse(z), RF_ITERS)
    t0 = time.perf_counter()
    parity = resflow_cpu_parity(
        "resflow 2d (init_state's weights)",
        lambda d: build_model("resflow", (2,), "2d", cfg, device=d), state0,
        x[:RF_PARITY].cpu(), (2,), device)
    print(f"card vs CPU parity took {time.perf_counter() - t0:.1f} s")
    train_profile = profiled_idle(lambda: trainer.train_step(ts, chunk[0]))
    print(json.dumps({"main_path": {
        "model": f"resflow 2d trained, {len(resflow_blocks(model))} blocks, F=32, "
                 f"logdet=unbias, {n_params} parameters: trains on the eager chain with the "
                 f"memory-saved Function, serves through {fwd_name} / {inv_name}",
        "batch": BATCH, "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
        "calls": RF_ITERS, "fwd_inv_samples_per_s": BATCH / ((t_fwd + t_inv) / 1e3),
        "solve_trips_per_block": trips[::-1], "serving_n_terms": probes[1].tolist(),
        "train_batch": B, "train_chunk": K, "train_chunk_ms": t_chunk,
        "train_step_ms": t_chunk / K, "train_samples_per_s": K * B / (t_chunk / 1e3),
        "train_peak_memory_bytes": peak, "train_series_lengths": rec.lengths_summary(),
        "train_profile_step": train_profile, "losses": losses, "moved_off_init": moved,
        "round_trip": {"max": rt, "ld_max": ld_sum},
        "trained_kernel_vs_plain": {k: list(v) for k, v in e.items()},
        "cpu_parity": parity, "card": smi}}))
    resflow_image_main_path(device, counters, launches_of, smi)
    return {k: totals[k] for k in (fwd_name, inv_name)}


def resflow_image_main_path(device, counters, launches_of, smi):
    """resflow-img32x1 (allow_image) through Trainer -> K = 4 Adam steps at
    B = 1024 -> eval_program -> log_prob / sample at B = 1024, the eager
    chain (no fused spec matches image dims, as in nf_tpu), no launch of
    any port kernel; against the CPU on 16 samples with injected probes."""
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    cfg = NetworkConfig(name="resflow", **{**NETWORK_DEFAULTS["resflow"], "allow_image": True})
    dims = RF_IMG_DIMS
    inner = (dims[0] // 2, dims[1] // 2, 4 * dims[2])
    model = build_model("resflow", dims, "image", cfg)
    n_blocks = len(resflow_blocks(model))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"resflow-img32x1: {n_blocks} conv blocks on {inner}, {n_params} parameters")
    check((n_blocks, n_params) == (32, RF_IMG_PARAMS),
          f"resflow-img32x1 has {n_blocks} blocks and {n_params} parameters")
    gen = torch.Generator(device=device).manual_seed(SEED)
    B, K = RF_IMG_BATCH, RF_IMG_TRAIN_CHUNK

    def pixels(*shape):
        return 0.05 + 0.9 * torch.rand(shape, generator=gen, device=device)

    batch0, chunk, x = pixels(B, *dims), pixels(K, B, *dims), pixels(B, *dims)
    trainer = Trainer(model, OptimizerConfig(), seed=SEED)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)

    def counted(what, fn):
        return counted_call(f"resflow-img32x1 {what}", fn, {}, counters, launches_of, totals)

    t0 = time.perf_counter()
    ts = counted("init_state", lambda: trainer.init_state(batch0))
    t_init = (time.perf_counter() - t0) * 1e3
    state0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    with SeriesRecorder() as rec:
        t0 = time.perf_counter()
        ts, losses = counted(f"train_steps K={K}", lambda: trainer.train_steps(ts, chunk))
        t_chunk = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    moved = {s: moved_off(state0, model, (s,)) for s in (".u", ".v", ".beta")}
    print(f"resflow-img32x1 losses {losses}; {t_chunk / K:.1f} ms per Adam step at B={B}; "
          f"train peak memory {peak / 2**30:.3f} GiB; series lengths "
          f"{rec.lengths_summary()}; moved off init: {moved}")
    check(all(math.isfinite(v) for v in losses), "resflow-img32x1: non-finite loss")
    check(all(m == n and n > 0 for m, n in moved.values()),
          f"resflow-img32x1: training left u, v or the betas at init: {moved}")
    prog = model.eval_program()
    check(prog.stack is None, "resflow-img32x1: a fused kernel matched")
    with SeriesRecorder() as rec_eval:
        log_px = counted("log_prob", lambda: prog.log_prob(x))
        y_s, log_py = counted("sample", lambda: prog.sample(B, gen))
    sample_trips = rec_eval.trips
    check(log_px.shape == (B,) and y_s.shape == (B,) + dims and log_py.shape == (B,),
          "resflow-img32x1: main path output shapes")
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"resflow-img32x1 {what}: non-finite values")
    t_fwd = wall_ms(lambda: prog.forward(x), RF_IMG_ITERS, warmup=1)
    z, ld = prog.forward(x)
    with SeriesRecorder() as rec_inv:
        xr, ldi = prog.inverse(z)
    t_inv = wall_ms(lambda: prog.inverse(z), RF_IMG_ITERS, warmup=1)
    rt, ld_sum = max_diff(xr, x), max_diff(ld, -ldi)
    print(f"resflow-img32x1 round trip: max|x - inv(fwd(x))|={rt:.3e} max|ld_fwd + ld_inv|="
          f"{ld_sum:.3e}; fixed-point trips per block (inverse of the data's latent) "
          f"{rec_inv.trips[::-1]}; of the sample's {sample_trips[::-1]}")
    check(rt < RF_IMG_ROUND_TRIP_ATOL, "resflow-img32x1: round trip")
    # the inverse of the same 16 latents on both devices, the probes injected
    n = RF_IMG_PARITY
    V, n_terms = prog._probes(z[:n])
    inv = {}
    for dev in (device, "cpu"):
        m = build_model("resflow", dims, "image", cfg, device=dev)
        m.load_state_dict(model.state_dict())
        inv[dev] = m.eval_program(probes=(V.to(dev), n_terms)).inverse(z[:n].to(dev))[0].cpu()
    e_inv = max_diff(inv[device], inv["cpu"])
    print(f"resflow-img32x1 inverse card vs CPU, {n} latents: max|dx|={e_inv:.3e}")
    check(e_inv <= RESFLOW_INV_ATOL, "resflow-img32x1: inverse on the card disagrees")
    t0 = time.perf_counter()
    parity = resflow_cpu_parity(
        "resflow-img32x1 (init_state's weights)",
        lambda d: build_model("resflow", dims, "image", cfg, device=d), state0,
        x[:n].cpu(), inner, device)
    print(f"card vs CPU parity took {time.perf_counter() - t0:.1f} s")
    eval_profile = profiled_idle(lambda: prog.forward(x))
    train_profile = profiled_idle(lambda: trainer.train_step(ts, chunk[0]))
    print(json.dumps({"main_path": {
        "model": f"resflow-img32x1 (allow_image): Logit -> Squeeze2d -> {n_blocks} x "
                 f"[ActNorm({inner[2]}) -> InvertibleResConv2d({inner[2]}, {inner[2]}, width "
                 f"{cfg.base_filters}, spatial {inner[0]}x{inner[1]})] -> Unsqueeze2d, "
                 f"{n_params} parameters: the eager chain (no kernel of the port, as nf_tpu "
                 f"runs no Pallas kernel there)",
        "batch": B, "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
        "calls": RF_IMG_ITERS, "eval_fwd_inv_samples_per_s": B / ((t_fwd + t_inv) / 1e3),
        "solve_trips_per_block": rec_inv.trips[::-1],
        "serving_n_terms": prog._probes(x)[1].tolist(), "eval_profile_forward": eval_profile,
        "train_batch": B, "train_chunk": K, "init_state_ms": t_init,
        "train_chunk_ms": t_chunk, "train_step_ms": t_chunk / K,
        "train_samples_per_s": K * B / (t_chunk / 1e3), "train_peak_memory_bytes": peak,
        "train_series_lengths": rec.lengths_summary(), "train_profile_step": train_profile,
        "losses": losses, "moved_off_init": moved, "round_trip": {"max": rt, "ld_max": ld_sum},
        "inverse_card_vs_cpu_max_abs": e_inv, "cpu_parity": parity, "card": smi}}))


# ---- phase 9: nf_tpu's production image shape (bench.py:239-243 builds every
# image tier with scan=True, remat=True): the image tiers folded into
# ScannedChain blocks, each block rematerialized
SCAN_FWD_PER_STEP = 2 * IMG_COUPLINGS - 1   # 321: the forward and the recompute of the
SCAN_BWD_PER_STEP = IMG_COUPLINGS           # 160 rematted couplings, the tail's once
SCAN_GRAD_REL = 1e-6     # remat and scan against the unrolled step, cuDNN deterministic
ROUND_TRIP_ATOL = 1e-3   # nf_tpu's own (tests/test_zoo_image_optin.py:30), in float64
ROUND_TRIP_FACTOR = 2.0  # the card's f32 round trip over the CPU's on the same samples
ROUND_TRIP_SAMPLES = 16
BF16_LOSS_REL = 5e-2     # the first bf16 loss against the f32 model's, of |loss|
BF16_LOGP_REL = 1e-2     # bf16 log p, card vs CPU, of the largest |log p|
BF16_PARITY = 16
CKPT_ATOL = 1e-6         # step 3 after a save and load against step 3 run on


class deterministic_cudnn:
    """cuDNN's deterministic algorithms for the block."""

    def __enter__(self):
        self.was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.was


def scan_config(network, **kw):
    from nf_tpu_torch.config import NetworkConfig

    return NetworkConfig(name=network, layers=32, scan=True, remat=True, **kw)


def copy_state(model, state):
    """``state`` (tensors in module order) into ``model``: an unrolled and a
    scanned model hold the same layers in the same order."""
    with torch.no_grad():
        for dst, src in zip(model.state_dict().values(), state, strict=True):
            dst.copy_(src)


def one_step_grads(cfg, dims, state, batch, device):
    """A fresh model of ``cfg`` on ``state``: one train-mode loss and
    backward on ``batch`` (no update) under deterministic cuDNN; returns
    (loss, the gradients flat, the buffers before and after it)."""
    model = image_model(cfg, device, dims=dims)
    copy_state(model, state)
    before = [b.detach().clone() for b in model.buffers()]
    model.train()
    with deterministic_cudnn():
        loss = -model.log_prob(batch).mean()
        loss.backward()
    grads = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    buffers = [b.detach().clone() for b in model.buffers()]
    loss = float(loss.detach())
    del model
    torch.cuda.empty_cache()
    return loss, grads, before, buffers


def remat_grad_check(tier, cfg, state, batch, device):
    """The first step's gradients and buffers of the scan + remat model
    against the unrolled, non-rematted model on the same weights and
    batch: the same kernels on the same inputs (cuDNN deterministic), so
    the gradients agree within SCAN_GRAD_REL and the batch-norm running
    statistics and ActNorm state move once, as the unrolled step moves
    them."""
    from nf_tpu_torch.config import NetworkConfig

    label = tier["label"]
    plain = NetworkConfig(name=tier["network"], layers=32)
    ref_loss, ref, _, ref_bufs = one_step_grads(plain, tier["dims"], state, batch, device)
    loss, got, before, bufs = one_step_grads(cfg, tier["dims"], state, batch, device)
    rel = float((got - ref).norm() / ref.norm())
    buf_diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(bufs, ref_bufs))
    moved = sum(not torch.equal(a, b) for a, b in zip(bufs, before))
    out = {"grad_rel_l2": rel, "grad_max_abs_diff": float((got - ref).abs().max()),
           "grads_bitwise": bool(torch.equal(got, ref)), "buffers_max_abs_diff": buf_diff,
           "buffers_moved": moved, "buffers": len(bufs), "loss": loss,
           "unrolled_loss": ref_loss}
    print(f"{label} scan+remat vs unrolled, first step on the same weights and batch "
          f"(cuDNN deterministic): gradients relative L2 {rel:.3e} (bitwise "
          f"{out['grads_bitwise']}), buffers max|d| {buf_diff:.3e} ({moved} of {len(bufs)} "
          f"moved by the step), loss {loss:.6f} vs {ref_loss:.6f}")
    check(rel <= SCAN_GRAD_REL, f"{label}: scan+remat gradients differ from the unrolled step")
    check(buf_diff == 0.0 and moved > 0,
          f"{label}: scan+remat buffers do not move as the unrolled step moves them")
    return out


def scan_remat_main_path(tier, device, counters, launches_of, cfg_kw=None, tag="scan+remat",
                         grad_check=True):
    """One image tier built as bench.py builds it (scan=True, remat=True)
    through Trainer and EvalProgram, each call's launches counted: 161
    coupling_fwd per init_state and per forward, 321 coupling_fwd and 161
    coupling_bwd per Adam step, 161 coupling_inv per inverse.  Returns
    what the timing phase needs."""
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.config import OptimizerConfig
    from nf_tpu_torch.train import Trainer

    label, dims = f"{tier['label']} {tag}", tier["dims"]
    cfg = scan_config(tier["network"], **(cfg_kw or {}))
    model = image_model(cfg, None, dims=dims)
    n_couplings = sum(isinstance(m, AffineCoupling) for m in model.modules())
    n_params = sum(p.numel() for p in model.parameters())
    blocks = sum(type(m).__name__ == "ScannedChain" for m in model.modules())
    print(f"{label}: {n_couplings} couplings, {n_params} parameters, {blocks} scanned stages")
    check(model.device.type == "cuda", "build_model did not default to the card")
    check((n_couplings, n_params) == (IMG_COUPLINGS, tier["params"]),
          f"{label} has {n_couplings} couplings and {n_params} parameters")
    gen = torch.Generator(device=device).manual_seed(SEED)

    def pixels(*shape):   # as bench.py:248-259 makes its batches
        return 0.05 + 0.9 * torch.rand(shape, generator=gen, device=device)

    batch0 = pixels(IMG_BATCH, *dims)
    chunk = pixels(IMG_TRAIN_CHUNK, IMG_BATCH, *dims)
    x = pixels(IMG_BATCH, *dims)
    trainer = Trainer(model, OptimizerConfig(), seed=SEED)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    n, K = IMG_COUPLINGS, IMG_TRAIN_CHUNK

    def counted(what, fn, want):
        return counted_call(f"{label} {what}", fn, want, counters, launches_of, totals)

    ts = counted("init_state", lambda: trainer.init_state(batch0), {"coupling_fwd": n})
    state = [t.detach().clone() for t in model.state_dict().values()]
    grads = (remat_grad_check(tier, cfg, state, chunk[0], device) if grad_check else None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()      # counted_call ends in a synchronize
    ts, losses = counted(f"train_steps K={K}", lambda: trainer.train_steps(ts, chunk),
                         {"coupling_fwd": K * SCAN_FWD_PER_STEP,
                          "coupling_bwd": K * SCAN_BWD_PER_STEP})
    t_chunk = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    print(f"{label} losses {losses}; train peak memory {peak / 2**30:.2f} GiB")
    check(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss")
    prog = model.eval_program()
    check(prog.stack is None, f"{label}: an image model matched a fused stack")
    log_px = counted("log_prob", lambda: prog.log_prob(x), {"coupling_fwd": n})
    y_s, log_py = counted("sample", lambda: prog.sample(IMG_BATCH, gen), {"coupling_inv": n})
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"{label} {what}: non-finite values")
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    round_trip = {"max": float((xr - x).abs().max()), "ld_max": max_diff(ld, -ldi),
                  "ld_max_abs": float(ld.abs().max())}
    print(f"{label} round trip: max|x - inv(fwd(x))|={round_trip['max']:.3e} "
          f"max|ld_fwd + ld_inv|={round_trip['ld_max']:.3e}")
    round_trip.update(cpu_round_trip(label, model, cfg, dims, x, xr))
    return dict(tier=tier, label=label, model=model, prog=prog, trainer=trainer, ts=ts,
                chunk=chunk, x=x, z=z, totals=totals, losses=losses, peak=peak,
                t_chunk=t_chunk, round_trip=round_trip, parity=grads, n_params=n_params,
                state=state, cfg=cfg)


def scan_timing(img, unrolled, smi, tc):
    """A phase 9 training's rates beside the unrolled tier's of this run:
    ms per Adam step from the main path's K = 2 steps (timed there, after
    init_state warmed the forward), one more call per direction (the main
    path warmed both), and one profiled step's device idle share (CUDA
    activity alone); prints its main_path line."""
    prog, trainer, x, z = img["prog"], img["trainer"], img["x"], img["z"]
    t_fwd = wall_ms(lambda: prog.forward(x), 1, warmup=0)
    t_inv = wall_ms(lambda: prog.inverse(z), 1, warmup=0)
    step = device_breakdown(*profile_window(
        lambda: trainer.train_step(img["ts"], img["chunk"][0]), 1, (tc,), warmup=False,
        cpu=False), 1)
    K, B = IMG_TRAIN_CHUNK, IMG_BATCH
    tier = img["tier"]
    line = {
        "model": f"{img['label']}: {'x'.join(map(str, tier['dims']))} image, "
                 f"{IMG_COUPLINGS} couplings, base_filters=32, {img['n_params']} parameters, "
                 f"scan=True, remat=True (bench.py:239-243)",
        "batch": B, "train_chunk": K,
        "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
        "eval_fwd_inv_samples_per_s": B / ((t_fwd + t_inv) / 1e3),
        "train_chunk_ms": img["t_chunk"], "train_step_ms": img["t_chunk"] / K,
        "train_samples_per_s": K * B / (img["t_chunk"] / 1e3),
        "train_profile_step": step, "train_peak_memory_bytes": img["peak"],
        "losses": img["losses"], "round_trip": img["round_trip"],
        ("bf16_checks" if "bf16" in img["label"] else "remat_grad_check"): img["parity"],
        "unrolled_this_run": {k: unrolled[k] for k in (
            "train_step_ms", "train_samples_per_s", "train_peak_memory_bytes",
            "eval_program_forward_ms", "eval_program_inverse_ms",
            "eval_fwd_inv_samples_per_s")} | {
            "train_device_idle_share": unrolled["train_profile_step"]["device_idle_share"]},
        "card": smi}
    print(json.dumps({"main_path": line}))


def cpu_round_trip(label, model, cfg, dims, x, xr):
    """The round trip x -> z -> x of the trained state on ROUND_TRIP_SAMPLES
    samples on the CPU in f32 and float64: float64 within ROUND_TRIP_ATOL
    (the model is invertible; at full depth f32 rounding, amplified
    through the 161 inverses, dominates the f32 round trip), and the
    card's f32 round trip on the same samples within ROUND_TRIP_FACTOR of
    the CPU's f32 one or within ROUND_TRIP_ATOL."""
    n = ROUND_TRIP_SAMPLES
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = {"card_f32_samples": float((xr[:n] - x[:n]).abs().max())}
    for name, dtype in (("cpu_f32", torch.float32), ("cpu_f64", torch.float64)):
        cpu = image_model(cfg, "cpu", state, dims).to(dtype).eval()
        xs = x[:n].cpu().to(dtype)
        with torch.no_grad():
            z, _ = cpu(xs)
            out[name] = float((cpu.inverse(z)[0] - xs).abs().max())
    print(f"{label} round trip on {n} samples: card f32 {out['card_f32_samples']:.3e}, CPU f32 "
          f"{out['cpu_f32']:.3e}, CPU float64 {out['cpu_f64']:.3e}")
    check(out["cpu_f64"] <= ROUND_TRIP_ATOL, f"{label}: float64 round trip")
    check(out["card_f32_samples"] <= max(ROUND_TRIP_FACTOR * out["cpu_f32"], ROUND_TRIP_ATOL),
          f"{label}: the card's round trip is less accurate than the CPU's")
    return out


def bf16_checks(img, device):
    """realnvp-img32x1 with compute_dtype="bfloat16": the first step's loss
    against the f32 model's on the same weights and batch (BF16_LOSS_REL),
    the trained state's log p on BF16_PARITY samples against the CPU
    port's bf16 path (BF16_LOGP_REL of the largest |log p|), then one
    forward with matmul_precision="bfloat16" against f32 on the init
    weights (the largest difference printed)."""
    from nf_tpu_torch.ops.precision import set_matmul_precision

    tier, label, x = img["tier"], img["label"], img["x"]
    f32_cfg = scan_config(tier["network"])
    f32 = image_model(f32_cfg, device, dims=tier["dims"])
    copy_state(f32, img["state"])
    f32.train()
    with torch.no_grad():
        loss32 = float(-f32.log_prob(img["chunk"][0]).mean())
    loss_rel = abs(img["losses"][0] - loss32) / abs(loss32)
    print(f"{label}: first loss {img['losses'][0]:.6f} against the f32 model's {loss32:.6f} "
          f"(relative {loss_rel:.3e})")
    check(loss_rel <= BF16_LOSS_REL, f"{label}: bf16 loss far from f32")
    n = BF16_PARITY
    card = img["prog"].log_prob(x[:n]).double().cpu()
    cpu = image_model(img["cfg"], "cpu", {k: v.cpu() for k, v in img["model"].state_dict().items()},
                      dims=tier["dims"])
    t0 = time.perf_counter()
    lp_cpu = cpu.eval_program().log_prob(x[:n].cpu()).double()
    diff, top = max_diff(card, lp_cpu), float(lp_cpu.abs().max())
    print(f"{label} card vs CPU bf16, {n} samples: max|dlog p|={diff:.3e} (max|log p|={top:.1f};"
          f" {time.perf_counter() - t0:.1f} s on the CPU)")
    check(diff <= BF16_LOGP_REL * top, f"{label}: bf16 log p on the card disagrees with the CPU")
    # matmul_precision="bfloat16": the f32 model's products on bf16 operands
    f32.eval()
    copy_state(f32, img["state"])
    with torch.no_grad():
        z32, ld32 = f32(x)
    mp = image_model(scan_config(tier["network"], matmul_precision="bfloat16"), device,
                     dims=tier["dims"])
    try:
        copy_state(mp, img["state"])
        with torch.no_grad():
            zb, ldb = mp.eval()(x)
    finally:
        set_matmul_precision(None)
    matmul = {"z_max_abs_diff": max_diff(zb, z32), "logdet_max_abs_diff": max_diff(ldb, ld32),
              "logdet_max_abs": float(ld32.abs().max())}
    print(f"realnvp-img32x1 matmul_precision=bfloat16 forward against f32 (init weights, "
          f"B={IMG_BATCH}): max|dz|={matmul['z_max_abs_diff']:.3e} max|dlogdet|="
          f"{matmul['logdet_max_abs_diff']:.3e} (max|logdet|={matmul['logdet_max_abs']:.1f})")
    check(bool(torch.isfinite(zb).all() and torch.isfinite(ldb).all()),
          "matmul_precision=bfloat16: non-finite forward")
    check(matmul["z_max_abs_diff"] > 0.0, "matmul_precision=bfloat16 changed nothing")
    del f32, mp, cpu
    torch.cuda.empty_cache()
    return {"first_loss_f32": loss32, "first_loss_rel_diff": loss_rel,
            "cpu_bf16_logp_max_abs_diff": diff, "cpu_bf16_logp_max_abs": top,
            "matmul_precision_bf16": matmul}


def checkpoint_round_trip(tier, device):
    """realnvp-img32x1 (scan + remat) trains 2 steps and saves; a fresh
    model loads the file; step 3 on both (cuDNN deterministic) leaves the
    same parameters, buffers and optimizer state (CKPT_ATOL; bitwise
    printed), and the file's fingerprint is the one the port computes."""
    from nf_tpu_torch.config import OptimizerConfig
    from nf_tpu_torch.train import Trainer, load_checkpoint, save_checkpoint
    from nf_tpu_torch.train.checkpoint import structure_fingerprint, train_state_tree

    cfg = scan_config(tier["network"])
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    batches = 0.05 + 0.9 * torch.rand((4, IMG_BATCH) + tier["dims"], generator=gen,
                                      device=device)
    model = image_model(cfg, device, dims=tier["dims"])
    trainer = Trainer(model, OptimizerConfig(), seed=SEED)
    ts = trainer.init_state(batches[0])
    ts, _ = trainer.train_steps(ts, batches[1:3])
    fresh = image_model(cfg, device, dims=tier["dims"])
    ftrainer = Trainer(fresh, OptimizerConfig(), seed=SEED + 1)
    fts = ftrainer.init_state()
    with tempfile.TemporaryDirectory() as folder:
        path = f"{folder}/realnvp-img32x1.npz"
        t0 = time.perf_counter()
        save_checkpoint(path, model, ts)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = load_checkpoint(path, fresh, fts)
        t_load = time.perf_counter() - t0
        with np.load(path) as data:
            saved = json.loads(str(data["__structure__"]))
            n_leaves = len(data.files) - 2
        size = os.path.getsize(path)
    check(step == 2 and fts.step == 2, f"checkpoint: resumed at step {step}")
    check(saved == structure_fingerprint(train_state_tree(fresh, fts)),
          "checkpoint: the file's fingerprint is not the port's")
    with deterministic_cudnn():
        ts, loss_a = trainer.train_step(ts, batches[3])
        fts, loss_b = ftrainer.train_step(fts, batches[3])
    pairs = list(zip(model.state_dict().values(), fresh.state_dict().values()))
    pairs += [(ts.optimizer.state[p][k], fts.optimizer.state[q][k])
              for p, q in zip(model.parameters(), fresh.parameters())
              for k in ("exp_avg", "exp_avg_sq")]
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs) and torch.equal(loss_a, loss_b)
    out = {"leaves": n_leaves, "file_bytes": size, "save_s": t_save, "load_s": t_load,
           "step3_max_abs_diff": diff, "step3_bitwise": bitwise,
           "loss3": [float(loss_a), float(loss_b)]}
    print(f"checkpoint round trip, realnvp-img32x1 scan+remat: {n_leaves} leaves, {size} bytes, "
          f"save {t_save:.2f} s, load {t_load:.2f} s; step 3 after the load against step 3 run "
          f"on (cuDNN deterministic): max|d| {diff:.3e}, bitwise {bitwise}")
    check(diff <= CKPT_ATOL, "checkpoint: step 3 after a load differs")
    del model, fresh
    torch.cuda.empty_cache()
    return out


def production_shape_phase(device, counters, launches_of):
    """Phase 9: realnvp-img32x1 and glow-img32x3 with scan=True, remat=True,
    realnvp-img32x1 in bf16, and a checkpoint round trip.  Returns the
    tiers for the timing phase and the coupling launches counted."""
    t0 = time.perf_counter()
    imgs = [scan_remat_main_path(tier, device, counters, launches_of) for tier in IMAGE_TIERS]
    bf16 = scan_remat_main_path(IMAGE_TIERS[0], device, counters, launches_of,
                                cfg_kw=dict(compute_dtype="bfloat16"),
                                tag="scan+remat bf16", grad_check=False)
    bf16["parity"] = bf16_checks(bf16, device)
    imgs.append(bf16)
    ckpt = checkpoint_round_trip(IMAGE_TIERS[0], device)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    totals = {k: sum(img["totals"][k] for img in imgs) for k in KERNEL_SOURCES}
    return imgs, ckpt, totals


# --------------------------------------------------------------------------
# the training CLI (nf_tpu_torch/main.py): the data tier, the run loop with
# resume, and a one-rank NCCL group through the launcher
# --------------------------------------------------------------------------
CLI_IMAGE = ["network=realnvp", "run.distrib=mnist", "run.dequantize=true", "run.display=1",
             "run.seed=0"]           # realnvp-img32x1, train.samples 1024 (the CLI's default)
CLI_STEPS, CLI_RESUMED = 4, 6
CLI_MOONS = ["network=realnvp", "run.distrib=moons", "run.display=0.6", "run.seed=0",
             "train.steps=60"]       # metric records and reports at steps 1 and 60
CLI_MOONS_PANELS = ("y_data", "z_sample", "y_sample", "y_dist")
CLI_IMAGE_GRID = (8 * 33 + 1, 8 * 33 + 1, 1)   # 64 images of 32 x 32 x 1, 8 a row
CLI_MESH_STEPS = 5                   # Trainer(mesh=make_mesh()) on one NCCL rank
CLI_IMAGE_TAGS = {"image/train/loss", "image/train/bits_per_dim",
                  "image/train/bits_per_dim_discrete"}
CLI_CHILD_TIMEOUT = 300
CLI_LOADER_BATCHES = 64              # batches timed per data set (host time)
EVAL_NLL_RTOL = 1e-5                 # the held-out NLL, card against the CPU
EVAL_CPU_IMAGES = 16                 # held-out images of draw 0 scored on the CPU too
EVAL_IMAGE_DRAWS = 1                 # uniform dequantizations of the held-out images


def cli_records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def cli_ms_per_step(recs):
    """ms per step between the first and the last loss record (the metric
    records' host times)."""
    loss = [r for r in recs if r["tag"].endswith("/train/loss")]
    return (loss[-1]["t"] - loss[0]["t"]) * 1e3 / (loss[-1]["step"] - loss[0]["step"])


def report_files(run_dir, names, step, shape):
    """Read each report panel's JPEG (the step's and the _latest copy) with
    the port's header parse; returns their sizes in bytes."""
    from nf_tpu_torch.utils import jpeg

    sizes = {}
    for name in names:
        for tag in (f"{step:06d}", "latest"):
            path = os.path.join(run_dir, f"{name}_{tag}.jpg")
            check(os.path.exists(path), f"cli report: no {os.path.basename(path)}")
            with open(path, "rb") as f:
                raw = f.read()
            got = jpeg.read_header(raw)
            check(got == shape, f"cli report: {os.path.basename(path)} is {got}, not {shape}")
            sizes[os.path.basename(path)] = len(raw)
    return sizes


def trace_names_coupling(model, trainer, ts, x, folder):
    """utils/profiling.trace round one forward of ``model``: the trace file
    written, and the coupling forward named in it."""
    from nf_tpu_torch.utils import profiling

    with profiling.trace(folder) as prof:
        trainer.log_prob(ts, x)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    named = sum(e.get("name") == "launch.coupling_fwd" for e in events)
    check(named > 0, f"trace: {prof.trace_path} does not name launch.coupling_fwd")
    return {"file_bytes": os.path.getsize(prof.trace_path), "events": len(events),
            "coupling_fwd_ranges": named}


def mesh_trainer_bitwise(device):
    """A one-rank NCCL group in this process: Trainer(mesh=make_mesh()) on
    RealNVP 2-D at the default width against the plain Trainer, the same
    steps on moons; returns the losses and the collectives counted."""
    import torch.distributed as dist

    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig, OptimizerConfig
    from nf_tpu_torch.data import FlowDataLoader
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.parallel import COLLECTIVES, init_distributed, make_mesh
    from nf_tpu_torch.train import Trainer

    dl = FlowDataLoader("moons", batch_size=1024, seed=0)
    batches = [dl.next_batch() for _ in range(CLI_MESH_STEPS + 1)]
    cfg = NetworkConfig(name="realnvp", **NETWORK_DEFAULTS["realnvp"])
    check(init_distributed(None, f"tcp://127.0.0.1:{free_port()}", 0, 1),
          "mesh trainer: no process group")
    try:
        check(dist.get_backend() == "nccl", f"mesh trainer: backend {dist.get_backend()}")
        runs = {}
        for label, mesh in (("plain", None), ("mesh", make_mesh())):
            before = dict(COLLECTIVES)
            model = build_model("realnvp", (2,), "2d", cfg, device=device)
            tr = Trainer(model, OptimizerConfig(), mesh=mesh, seed=SEED)
            ts = tr.init_state(batches[0])
            losses = []
            for b in batches[1:]:
                ts, loss = tr.train_step(ts, b)
                losses.append(float(loss))
            runs[label] = (losses, {k: t.clone() for k, t in model.state_dict().items()},
                           {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES})
    finally:
        dist.destroy_process_group()
    (plain, ps, _), (meshed, ms, counted) = runs["plain"], runs["mesh"]
    same = all(torch.equal(ps[k], ms[k]) for k in ps)
    print(f"mesh trainer (one NCCL rank, RealNVP 2-D, {CLI_MESH_STEPS} steps at B = 1024): "
          f"losses {meshed} against the plain {plain}; state bit for bit {same}; "
          f"collectives {counted}")
    check(meshed == plain and same, "mesh trainer: not the plain steps bit for bit")
    check(counted["all_reduce"] > 0 and counted["broadcast"] > 0,
          f"mesh trainer: the collectives did not run ({counted})")
    return {"losses": meshed, "plain_losses": plain, "collectives": counted,
            "state_bitwise": same}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LogProbRecorder:
    """Records, while in use, the batch and the result of the first
    ``Trainer.log_prob`` call; the method is restored on exit."""

    def __enter__(self):
        from nf_tpu_torch.train import Trainer

        self.first = None
        self._log_prob = log_prob = Trainer.log_prob

        def recorded(trainer, ts, batch, generator=None):
            out = log_prob(trainer, ts, batch, generator)
            if self.first is None:
                self.first = (torch.as_tensor(batch).float().cpu(), out.cpu())
            return out

        Trainer.log_prob = recorded
        return self

    def __exit__(self, *exc):
        from nf_tpu_torch.train import Trainer

        Trainer.log_prob = self._log_prob


def image_bits_line(label, r, seconds):
    return (f"{label}: {r['n_heldout']} held-out images, {r['noise_draws']} draw(s), step "
            f"{r['trained_steps']}: {r['heldout_nll_nats']:.4f} nats, "
            f"{r['bits_per_dim_continuous']:.6f} bits/dim continuous, "
            f"{r['bits_per_dim_discrete']:.6f} discrete; {seconds:.1f} s "
            f"({r['eval_minutes'] * 60:.1f} s scoring)")


def check_image_bits(label, r, trained_steps, draws):
    numbers = [r["heldout_nll_nats"], r["bits_per_dim_continuous"],
               r["bits_per_dim_discrete"], *r["heldout_nll_per_draw"]]
    check(all(math.isfinite(v) for v in numbers), f"{label}: non-finite result {r}")
    check(r["trained_steps"] == trained_steps and r["noise_draws"] == draws
          and len(r["heldout_nll_per_draw"]) == draws, f"{label}: {r}")
    offset = r["bits_per_dim_discrete"] - r["bits_per_dim_continuous"]
    check(abs(offset - 8.0) < 1e-9, f"{label}: discrete - continuous bits/dim = {offset}")


def evaluator_phase(image_ckpt, moons_ckpt, n, device, counters, launches_of, totals):
    """Phase 10 (e): the held-out evaluators on the CLI's checkpoints."""
    from nf_tpu_torch import evaluate as ev

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    card = counted_call("evaluate heldout_nll realnvp moons",
                        lambda: ev.heldout_nll("realnvp", moons_ckpt, "moons"), {}, counters,
                        launches_of, totals)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = ev.heldout_nll("realnvp", moons_ckpt, "moons", device="cpu")
    t_cpu = time.perf_counter() - t0
    a, b = card["heldout_nll_nats"], cpu["heldout_nll_nats"]
    rel = abs(a - b) / abs(b)
    print(f"evaluate heldout_nll realnvp moons (step {card['steps']}): {ev.HELDOUT_N} rows, "
          f"{a:.6f} nats on the card in {t_card:.1f} s, {b:.6f} on the CPU in {t_cpu:.1f} s, "
          f"relative difference {rel:.3e}")
    check(math.isfinite(a) and card["steps"] == cpu["steps"] == 60,
          f"evaluate moons: {card}")
    check(rel <= EVAL_NLL_RTOL, f"evaluate moons: card and CPU NLL {rel:.3e} apart")

    batches = ev.N_HELDOUT // ev.IMAGE_BATCH
    t0 = time.perf_counter()
    with LogProbRecorder() as rec:
        img = counted_call(
            "evaluate heldout_image_nll realnvp-img32x1",
            lambda: ev.heldout_image_nll(image_ckpt, draws=EVAL_IMAGE_DRAWS, scan=False,
                                         remat=False),
            {"coupling_fwd": n * (1 + batches * EVAL_IMAGE_DRAWS)}, counters, launches_of,
            totals)
    t_img = time.perf_counter() - t0
    label = "evaluate heldout_image_nll realnvp-img32x1"
    print(image_bits_line(label, img, t_img))
    check_image_bits(label, img, CLI_RESUMED, EVAL_IMAGE_DRAWS)
    check(img["n_heldout"] == 2048, f"{label}: {img['n_heldout']} images")
    # the first batch of draw 0 again on the CPU, from the same file
    batch, card_lp = rec.first
    t0 = time.perf_counter()
    trainer, ts, _ = ev.restore("realnvp", IMG_DIMS, "image",
                                ev.image_config("realnvp", scan=False, remat=False), None,
                                image_ckpt, "cpu")
    cpu_lp = trainer.log_prob(ts, batch[:EVAL_CPU_IMAGES])
    card_lp = card_lp[:EVAL_CPU_IMAGES]
    err = float((card_lp - cpu_lp).abs().max())
    scale = float(cpu_lp.abs().max())
    print(f"{label}: the first {EVAL_CPU_IMAGES} images of draw 0, card against CPU: "
          f"max|dlog p| {err:.3e} at max|log p| {scale:.1f} ({err / scale:.3e} of it; "
          f"{time.perf_counter() - t0:.1f} s)")
    check(bool(torch.isfinite(card_lp).all()) and err <= IMG_LOGP_RTOL * scale,
          f"{label}: card and CPU log p {err} apart")
    out = {"moons": {"card": card, "cpu": cpu, "rel_diff": rel, "card_s": t_card,
                     "cpu_s": t_cpu},
           "realnvp_img32x1": {**img, "wall_s": t_img, "cpu_max_abs_diff": err,
                               "cpu_max_abs_logp": scale},
           "phase_s": time.perf_counter() - t_phase}
    print(f"phase 10 (e) (the held-out evaluators) took {out['phase_s']:.1f} s")
    return out


def cli_phase(device, counters, launches_of):
    """Phase 10: the training CLI on the card.  (a) realnvp-img32x1 on the
    synthetic MNIST images through nf_tpu_torch.main.main, its coupling
    launches counted against the chain's couplings, then resumed;
    (b) RealNVP 2-D on moons at the default width for 100 steps; (c) the
    same through the launcher in a one-rank NCCL group, a subprocess.
    Returns the coupling launches counted and the phase's numbers."""
    from nf_tpu_torch import main as cli
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.config import OptimizerConfig, parse_cli
    from nf_tpu_torch.data import FlowDataLoader, native
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer, load_checkpoint

    t_phase = time.perf_counter()
    tier = "native" if native.available() else "numpy"
    cfg = parse_cli(CLI_IMAGE).network
    n = sum(isinstance(m, AffineCoupling)
            for m in build_model("realnvp", IMG_DIMS, "image", cfg, device="cpu").modules())
    check(n == IMG_COUPLINGS, f"cli: realnvp-img32x1 has {n} couplings")
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    out = {"data_tier": tier}
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            # the host's time per batch, on the synthetic images the CLI runs on
            loader_ms = {}
            for name, kw in (("moons", {}), ("mnist", dict(dequantize=True))):
                dl = FlowDataLoader(name, batch_size=1024, seed=0, **kw)
                dl.next_batch()
                t0 = time.perf_counter()
                for _ in range(CLI_LOADER_BATCHES):
                    dl.next_batch()
                loader_ms[name] = (time.perf_counter() - t0) * 1e3 / CLI_LOADER_BATCHES
            out["next_batch_ms_at_1024"] = loader_ms
            print(f"cli data tier {tier}: FlowDataLoader.next_batch at 1024 rows "
                  f"{loader_ms['moons']:.3f} ms (moons), {loader_ms['mnist']:.3f} ms (synthetic "
                  f"MNIST, dequantized)")

            # (a) the image tier: init_state's forward, then a forward and a
            # backward per step, for every coupling of the chain
            runs = []
            for extra, steps, start in (([f"train.steps={CLI_STEPS}"], CLI_STEPS, 0),
                                        ([f"train.steps={CLI_RESUMED}", "run.resume=auto"],
                                         CLI_RESUMED - CLI_STEPS, CLI_STEPS)):
                t0 = time.perf_counter()
                # the report samples 64 images at the run's first step
                run_dir = counted_call(
                    f"cli realnvp-img32x1 steps {start}->{start + steps}",
                    lambda: cli.main(CLI_IMAGE + extra),
                    {"coupling_fwd": n * (1 + steps), "coupling_bwd": n * steps,
                     "coupling_inv": n},
                    counters, launches_of, totals)
                runs.append((run_dir, time.perf_counter() - t0))
            (run_dir, t_first), (again, t_again) = runs
            check(again == run_dir, f"cli: run.resume=auto went to {again}, not {run_dir}")
            jpegs = {**report_files(run_dir, ("y_data", "y_image"), 1, CLI_IMAGE_GRID),
                     **report_files(run_dir, ("y_data", "y_image"), CLI_STEPS + 1,
                                    CLI_IMAGE_GRID)}
            recs = cli_records(run_dir)
            check({r["tag"] for r in recs} == CLI_IMAGE_TAGS, "cli: the image metric tags")
            check([r["step"] for r in recs if r["tag"] == "image/train/loss"]
                  == [1, CLI_STEPS + 1], "cli: the loss records' steps")
            check(all(math.isfinite(r["value"]) for r in recs), "cli: a non-finite metric")
            path = os.path.join(run_dir, "latest.npz")
            model = build_model("realnvp", IMG_DIMS, "image", cfg, device=device)
            trainer = Trainer(model, OptimizerConfig(), seed=SEED)
            ts = trainer.init_state()
            step = load_checkpoint(path, model, ts)
            x = 0.05 + 0.9 * torch.rand((64,) + IMG_DIMS, device=device,
                                        generator=torch.Generator(device=device).manual_seed(7))
            logp = trainer.log_prob(ts, x)
            check(step == CLI_RESUMED and bool(torch.isfinite(logp).all()),
                  f"cli: latest.npz at step {step}, log p finite {bool(torch.isfinite(logp).all())}")
            traced = trace_names_coupling(model, trainer, ts, x, os.path.join(work, "trace"))
            out["image"] = {"run_s": [t_first, t_again], "records": recs,
                            "latest_step": step, "file_bytes": os.path.getsize(path),
                            "reloaded_logp_mean": float(logp.mean()), "report_jpegs": jpegs,
                            "trace": traced}
            print(f"cli realnvp-img32x1: {CLI_STEPS} steps in {t_first:.1f} s, resumed to "
                  f"{CLI_RESUMED} in {t_again:.1f} s (the same run directory); metrics "
                  f"{[(r['tag'], r['step'], round(r['value'], 4)) for r in recs]}; latest.npz "
                  f"step {step}, log p of 64 pixels {float(logp.mean()):.1f} on reload; report "
                  f"files {jpegs}; trace of one forward {traced}")
            del model, trainer, ts
            torch.cuda.empty_cache()

            # (b) RealNVP 2-D on moons at the default width, no kernel (the
            # eager chain trains, as in nf_tpu)
            t0 = time.perf_counter()
            plain_dir = counted_call("cli realnvp 2d moons", lambda: cli.main(CLI_MOONS), {},
                                     counters, launches_of, totals)
            t_plain = time.perf_counter() - t0
            plain = cli_records(plain_dir)
            check(len(plain) >= 2 and all(math.isfinite(r["value"]) for r in plain),
                  f"cli moons: records {plain}")
            moons_jpegs = report_files(plain_dir, CLI_MOONS_PANELS, 1, (600, 600, 3))

            # (c) the same through the launcher, a one-rank NCCL group
            rank_dir = os.path.join(work, "rank")
            os.makedirs(rank_dir)
            env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                       PYTHONPATH=os.pathsep.join(
                           [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                     if p]))
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, "-m", "nf_tpu_torch.parallel.launch",
                 os.path.join(ROOT, "nf_tpu_torch", "main.py")] + CLI_MOONS,
                cwd=rank_dir, env=env, capture_output=True, text=True, timeout=CLI_CHILD_TIMEOUT)
            t_child = time.perf_counter() - t0
            if child.returncode != 0:
                print(child.stdout[-4000:], child.stderr[-4000:], file=sys.stderr)
            check(child.returncode == 0, f"cli launch: exit {child.returncode}")
            group = re.search(r"process group: backend (\w+), world (\d+), (\d+) all-reduces, "
                              r"(\d+) broadcasts", child.stdout)
            check(group is not None, "cli launch: the child printed no process group line")
            backend, world, reduces, broadcasts = group.groups()
            check((backend, world) == ("nccl", "1"), f"cli launch: {backend}, world {world}")
            check((reduces, broadcasts) == ("0", "0"),
                  f"cli launch: one rank formed a mesh ({reduces} all-reduces, {broadcasts} "
                  f"broadcasts)")
            ranked_dir = [os.path.join(rank_dir, "logs", d)
                          for d in os.listdir(os.path.join(rank_dir, "logs"))]
            check(len(ranked_dir) == 1, f"cli launch: run directories {ranked_dir}")
            ranked = cli_records(ranked_dir[0])
            check([(r["tag"], r["step"]) for r in ranked] == [(r["tag"], r["step"]) for r in plain],
                  "cli launch: other metric records than the plain run's")
            a = np.array([r["value"] for r in plain])
            b = np.array([r["value"] for r in ranked])
            rel = float(np.max(np.abs(a - b) / np.abs(a)))
            tier_line = re.search(r"data tier (\w+)", child.stdout)
            out["moons"] = {
                "plain": {"run_s": t_plain, "ms_per_step": cli_ms_per_step(plain),
                          "records": plain, "report_jpegs": moons_jpegs},
                "one_rank_nccl": {"run_s": t_child, "ms_per_step": cli_ms_per_step(ranked),
                                  "records": ranked, "backend": backend, "world": int(world),
                                  "all_reduces": int(reduces), "broadcasts": int(broadcasts),
                                  "data_tier": tier_line and tier_line.group(1),
                                  "max_rel_loss_diff": rel}}
            print(f"cli realnvp 2d moons (data tier {tier}): plain {t_plain:.1f} s, "
                  f"{cli_ms_per_step(plain):.2f} ms per step; one-rank NCCL through the launcher "
                  f"{t_child:.1f} s, {cli_ms_per_step(ranked):.2f} ms per step, backend {backend}, "
                  f"world {world}, {reduces} all-reduces, {broadcasts} broadcasts; losses "
                  f"{a.tolist()} against {b.tolist()}, max rel diff {rel:.3e}")
            check(rel == 0.0, f"cli launch: losses off by {rel} (relative), not bit for bit")
            out["evaluate"] = evaluator_phase(path, os.path.join(plain_dir, "latest.npz"), n,
                                              device, counters, launches_of, totals)
        finally:
            os.chdir(here)
    # (d) Trainer(mesh=make_mesh()) on one NCCL rank, bit for bit the plain steps
    out["mesh_trainer"] = mesh_trainer_bitwise(device)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 10 took {out['phase_s']:.1f} s")
    return totals, out


def serving_roofline(prog, x, zin, t_fwd, t_inv, kernel_fwd_ms, kernel_inv_ms, smi):
    """utils/profiling.roofline_estimate of the RealNVP 2-D serving pair
    (forward of x, inverse of zin), counted on a CPU copy of the program's
    model (the plain versions' work), beside stack_work's count of the two
    kernel calls and the card's measured times."""
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.utils import profiling

    cfg = NetworkConfig(name="realnvp", **NETWORK_DEFAULTS["realnvp"])
    cpu = build_model("realnvp", (2,), "2d", cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in prog.model.state_dict().items()})
    cpu.eval()
    xc, zc = x.cpu(), zin.cpu()
    t0 = time.perf_counter()
    est = profiling.roofline_estimate(lambda a, b: (cpu(a), cpu.inverse(b)), xc, zc,
                                      measured_seconds=(kernel_fwd_ms + kernel_inv_ms) / 1e3)
    count_s = time.perf_counter() - t0
    work = stack_work(prog.stack, BATCH)
    scanned = profiling.model_flops(cpu, xc)["flops"] + profiling.model_flops(
        cpu, zc, "inverse")["flops"]
    check(math.isfinite(est["flops"]) and est["flops"] > 0, "roofline: no flops counted")
    line = {"model": f"realnvp 2d, {prog.stack.spec.n_repeats} couplings, "
                     f"F={prog.stack.spec.filters}, forward + inverse", "batch": BATCH,
            **est, "model_flops_fwd_plus_inv": scanned,
            "stack_work_flop_fwd_plus_inv": 2 * work["flop"],
            "stack_work_bytes_fwd_plus_inv": 2 * work["bytes"],
            "kernel_ms_fwd_plus_inv": kernel_fwd_ms + kernel_inv_ms,
            "eval_program_ms_fwd_plus_inv": t_fwd + t_inv,
            "eval_program_flops_per_s": est["flops"] / ((t_fwd + t_inv) / 1e3),
            "counted_on": "cpu (the plain versions), "
                          f"{count_s:.1f} s", "card": smi}
    print(json.dumps({"roofline": line}))
    return line


def reset_all(modules):
    for m in modules:
        m.reset_launches()


def launch_paths(spans) -> dict:
    """{kernel path: launches} over a recording's launch spans named
    ``launch.<LAUNCHES key>.<path>`` (utils/tracing.py)."""
    paths = {}
    for name, n in spans.counts("launch.").items():
        if name.count(".") == 2:
            path = name.rsplit(".", 1)[1]
            paths[path] = paths.get(path, 0) + n
    return paths


def launches_by_length(ca, fn):
    """(fn(), {L: attention launches}): the attention wrapper's launches
    in fn counted by sequence length."""
    by_len, launch = {}, ca.launch

    def counting(q, k, v):
        by_len[q.shape[1]] = by_len.get(q.shape[1], 0) + 1
        return launch(q, k, v)

    ca.launch = counting
    try:
        return fn(), by_len
    finally:
        ca.launch = launch


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from nf_tpu_torch.bijectors import mixlogcdf as mlc
    from nf_tpu_torch.ops import attention as ta
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import attention as ca
    from nf_tpu_torch.ops.cuda import coupling as tc
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff
    from nf_tpu_torch.ops.cuda import fused_resflow as rf
    from nf_tpu_torch.ops.cuda import fused_stack as fs
    from nf_tpu_torch.ops.cuda import mixlogcdf as cm
    from nf_tpu_torch.ops.estimators import draw_unbias_probes, eval_probes
    from nf_tpu_torch.ops.math import standard_normal_logprob
    from nf_tpu_torch.utils import tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = (fs, ff, rf, tc, ca, cm)
    launches_of = lambda: {k: v for m in counters for k, v in m.LAUNCHES.items()}  # noqa: E731

    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip().splitlines()[0]
    sfu_per_s = SMS * SFU_PER_SM_CLOCK * float(clock) * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          f"max SM clock {clock} MHz")

    # ---- 2. build every kernel of the path
    t0 = t_start = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        for line in ptxas_summary(path.with_suffix(".log").read_text()):
            print(f"  {name}: {line}")

    # ---- 3. kernels against their plain versions
    errs = {k: 0.0 for k in KERNEL_SOURCES}
    cases = [("realnvp", 2, 32, 32, BATCH, 8), ("realnvp", 3, 4, 64, 1000, 8),
             ("realnvp", 2, 4, 128, 1000, 8),
             ("glow", 2, 32, 32, BATCH, 8), ("glow", 3, 4, 64, 1000, 8),
             ("glow", 2, 4, 128, 1000, 8),
             ("flow++", 2, 32, 32, BATCH, 8), ("flow++", 2, 4, 64, 1000, 4)]
    for model_name, D, layers, F, B, K in cases:
        _, prog, g = perturbed_program(model_name, D, layers, F, dev, SEED + D, K)
        stack = prog.stack
        flowpp = model_name == "flow++"
        mod = ff if flowpp else fs
        reference = ff.fused_flowpp_reference if flowpp else fs.fused_stack_reference
        x = torch.randn(B, D, generator=g, device=dev)
        inp = x
        for direction, name in zip(("forward", "inverse"), MODELS[model_name]):
            y, ld = mod.launch(stack, inp, direction == "inverse")
            torch.cuda.synchronize()
            yr, ldr = reference(stack.packed, stack.const_ld, inp, direction)
            if flowpp:
                # random weights make the inverse of a random latent
                # ill-conditioned (|d x / d z| up to e^21): invert the
                # forward's latent of x instead
                inp = yr
            ey = float((y - yr).abs().max())
            eld = float((ld - ldr).abs().max())
            print(f"check {name} D={D} n={layers} F={F}{f' K={K}' if flowpp else ''} B={B}"
                  f"{'' if flowpp else f' ({stack.variant})'}: "
                  f"max|dz|={ey:.3e} max|dlogdet|={eld:.3e}")
            if not flowpp:
                # the tilings these ran on before the wide paths: the tensor-core kernel up
                # to F = 64, the FFMA kernel at TILES' F = 128 tiling past it
                check(stack.variant == ("mma" if F <= 64 else "ffma")
                      and (F <= 64 or (stack.kernel.path, stack.kernel.tile)
                           == ("ffma", fs.TILES[128])),
                      f"{name} D={D} F={F}: off its tiling")
            check(torch.isfinite(y).all() and torch.isfinite(ld).all(),
                  f"{name}: non-finite output")
            if flowpp and direction == "inverse":
                print(f"  plain round trip: max|x - inv(fwd(x))|="
                      f"{float((yr - x).abs().max()):.3e}")
                check(ey <= FLOWPP_INV_X_ATOL, f"{name}: x off by {ey}")
                check(eld <= FLOWPP_INV_LD_ATOL, f"{name}: logdet off by {eld}")
            else:
                check(torch.allclose(y, yr, **Z_TOL), f"{name} D={D}: z off by {ey}")
                check(eld <= LD_ATOL, f"{name} D={D}: logdet off by {eld}")
            errs[name] = max(errs[name], ey, eld)

    check_wide_stacks(fs, dev, counters, launches_of, errs)
    print(f"phase 3 (the wide paths) starts at {time.perf_counter() - t_start:.1f} s")
    wide_launches, wide_records = wide_paths(fs, rf, ca, ta, dev, counters, launches_of, errs)

    for estimator, D, layers, F, B, directions in RESFLOW_CASES:
        _, prog, g = perturbed_program("resflow", D, layers, F, dev, SEED + D, logdet=estimator)
        stack = prog.stack
        spec = stack.spec
        x = torch.randn(B, D, generator=g, device=dev)
        probes = draw_unbias_probes(B, D, g)
        print(f"resflow {estimator} D={D} n={layers} F={F} B={B}: the probes' series "
              f"lengths n_terms={probes[1].tolist()}")
        zr, ldr = rf.fused_resflow_fwd_logdet_reference(spec, stack.packed, x, probes)
        for direction in directions:
            name = RESFLOW_NAMES[direction]
            inp = x if direction == "forward" else zr
            got = rf.launch(stack, inp, direction, probes)
            torch.cuda.synchronize()
            trips = []
            if direction == "forward":
                want = (zr, ldr)
            elif direction == "inverse":
                want = rf.fused_resflow_solve_logdet_reference(spec, stack.packed, zr, probes,
                                                               trips)
            else:
                got = (got,)
                want = (rf.fused_resflow_solve_reference(spec, stack.packed, zr, trips),)
            ey = float((got[0] - want[0]).abs().max())
            eld = float((got[1] - want[1]).abs().max()) if len(got) > 1 else 0.0
            kernel = f" ({rf.solve_kernel(stack.kernel.fp)})" if direction == "solve" else ""
            print(f"check {name}{kernel} {estimator} D={D} n={layers} F={F} B={B}: "
                  f"max|dz|={ey:.3e} max|dlogdet|={eld:.3e}")
            check(all(bool(torch.isfinite(t).all()) for t in got), f"{name}: non-finite output")
            if direction == "forward":
                check(torch.allclose(got[0], want[0], **Z_TOL), f"{name} D={D}: z off by {ey}")
                check(eld <= LD_ATOL, f"{name} D={D}: logdet off by {eld}")
            else:
                print(f"  trips per block, walk order (plain version, whole batch): {trips}; "
                      f"plain round trip "
                      f"max|x - inv(fwd(x))|={float((want[0] - x).abs().max()):.3e}")
                check(ey <= RESFLOW_INV_ATOL, f"{name} D={D}: x off by {ey}")
                check(eld <= RESFLOW_INV_ATOL, f"{name} D={D}: logdet off by {eld}")
            errs[name] = max(errs[name], ey, eld)
    coupling_per_call = check_coupling_kernels(tc, dev, errs)
    check_attention_kernel(ca, ta, dev, errs)
    check_mixlogcdf_kernel(cm, mlc, dev, errs)

    # ---- 4. the main path, through the entry points a user calls
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import build_model

    programs = {}
    launches = {}
    for model_name, (fwd_name, inv_name) in MODELS.items():
        cfg = NetworkConfig(name=model_name, **NETWORK_DEFAULTS[model_name])
        model = build_model(model_name, (2,), "2d", cfg)
        check(model.device.type == "cuda", "build_model did not default to the card")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = model.init(gen)
        if model_name != "realnvp":
            perturb(model, gen, dev)
        prog = model.eval_program(params)
        check(prog.stack is not None, f"{model_name} missed its fused kernel")
        x = torch.randn(BATCH, 2, generator=gen, device=dev)

        reset_all(counters)
        with tracing.recording() as spans:
            log_px = prog.log_prob(x)
            y_s, log_py = prog.sample(BATCH, gen)
        torch.cuda.synchronize()
        counts = launches_of()
        print(f"main path {model_name} launches: { {k: v for k, v in counts.items() if v} }")
        check(counts == {k: int(k in (fwd_name, inv_name)) for k in counts},
              f"{model_name}: expected one launch of its kernel per call, got {counts}")
        # the headline keeps its kernels and tilings: the tensor-core
        # stack, the 16-sample ResFlow series tiles at (FP, DP) = (32, 2)
        paths = launch_paths(spans)
        want = {"realnvp": {"mma": 2}, "glow": {"mma": 2}, "flow++": {},
                "resflow": {"tile": 2}}[model_name]
        tiling = {"realnvp": lambda st: st.variant == "mma" and st.kernel.layout.fp == 32,
                  "glow": lambda st: st.variant == "mma" and st.kernel.layout.fp == 32,
                  "flow++": lambda st: True,
                  "resflow": lambda st: (rf.kernel_path(st.spec), st.kernel.fp, st.kernel.dp)
                  == ("tile", 32, 2)}[model_name](prog.stack)
        check(paths == want and tiling,
              f"{model_name}: off its kernel or tiling: launches by path {paths}")
        launches.update({fwd_name: counts[fwd_name], inv_name: counts[inv_name]})

        check(log_px.shape == (BATCH,) and y_s.shape == (BATCH, 2)
              and log_py.shape == (BATCH,), f"{model_name}: main path output shapes")
        for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
            check(bool(torch.isfinite(t).all()), f"{model_name} {what}: non-finite values")
        z, ld = prog.forward(x)
        xr, ldi = prog.inverse(z)
        rt = float((xr - x).abs().max())
        ld_sum = float((ld + ldi).abs().max())
        print(f"{model_name} round trip: max|x - inv(fwd(x))|={rt:.3e} "
              f"max|ld_fwd + ld_inv|={ld_sum:.3e}")
        rt_tol = FLOWPP_INV_X_ATOL if model_name == "flow++" else 1e-3
        ld_tol = FLOWPP_INV_LD_ATOL if model_name == "flow++" else 1e-3
        if model_name == "resflow":
            rt_tol = ld_tol = RESFLOW_INV_ATOL
        check(rt < rt_tol and ld_sum < ld_tol, f"{model_name}: round trip")
        with torch.no_grad():
            # the eager chain, cuBLAS f32; ResFlow's blocks draw their probes
            # for 256 samples from a generator seeded 0, as the program does
            zc, ldc = model(x[:256])
        lp_small = float((prog.log_prob(x[:256])
                          - (standard_normal_logprob(zc) + ldc)).abs().max())
        print(f"{model_name} eager chain vs serving program, 256 samples: "
              f"max|dlog p|={lp_small:.3e} max|dz|={float((z[:256] - zc).abs().max()):.3e}")
        check(torch.allclose(z[:256], zc, **Z_TOL) and lp_small <= LD_ATOL,
              f"{model_name}: serving program disagrees with the eager chain")
        programs[model_name] = (prog, x, gen)

    # ResFlow with logdet="exact": the forward is the eager chain, the
    # inverse one solve launch and a chain forward at the solved x
    cfg = NetworkConfig(name="resflow", **{**NETWORK_DEFAULTS["resflow"], "logdet": "exact"})
    model = build_model("resflow", (2,), "2d", cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(gen)
    perturb(model, gen, dev)
    exact = model.eval_program(params)
    x = torch.randn(BATCH, 2, generator=gen, device=dev)
    reset_all(counters)
    with tracing.recording() as spans:
        z, ld = exact.forward(x)
        xr, ldi = exact.inverse(z)
    torch.cuda.synchronize()
    counts = launches_of()
    print(f"main path resflow exact launches: { {k: v for k, v in counts.items() if v} }")
    check(counts == {k: int(k == "fused_resflow_solve") for k in counts}
          and launch_paths(spans) == {"warp": 1},
          f"resflow exact: expected one solve launch (the warp kernel) per inverse, got "
          f"{counts}, {launch_paths(spans)}")
    launches["fused_resflow_solve"] = counts["fused_resflow_solve"]
    rt, ld_sum = float((xr - x).abs().max()), float((ld + ldi).abs().max())
    with torch.no_grad():
        xc, ldic = model.inverse(z[:256])
    e_x, e_ld = float((xr[:256] - xc).abs().max()), float((ldi[:256] - ldic).abs().max())
    print(f"resflow exact round trip: max|x - inv(fwd(x))|={rt:.3e} max|ld_fwd + ld_inv|="
          f"{ld_sum:.3e}; against the eager chain's inverse, 256 samples: max|dx|={e_x:.3e} "
          f"max|dlogdet|={e_ld:.3e}")
    check(bool(torch.isfinite(xr).all() and torch.isfinite(ldi).all()),
          "resflow exact: non-finite")
    check(rt < RESFLOW_INV_ATOL and ld_sum < RESFLOW_INV_ATOL, "resflow exact: round trip")
    check(e_x < RESFLOW_INV_ATOL and e_ld < RESFLOW_INV_ATOL,
          "resflow exact: serving program disagrees with the eager chain")

    # MAF and Planar: the eager chain on the card, no kernel of the port
    eager = {name: eager_main_path(name, dev, counters, launches_of) for name in EAGER_MODELS}
    debug_phase(dev, counters, launches_of)

    # ---- 5. the image main paths: training and serving
    images = []
    for tier in IMAGE_TIERS:
        print(f"phase 5 (image main path, {tier['label']}) starts at "
              f"{time.perf_counter() - t_start:.1f} s")
        images.append(image_main_path(tier, dev, counters, launches_of))
    launches.update({k: sum(img["totals"][k] for img in images) for k in tc.LAUNCHES})
    print(f"phase 6 (image Flow++ main path) starts at {time.perf_counter() - t_start:.1f} s")
    fp = flowpp_image_main_path(dev, counters, launches_of, ca)
    launches["attention_fwd"] = fp["totals"]["attention_fwd"]
    mix_main, mix_totals = mixlogcdf_main_path(dev, counters, launches_of)
    launches["mix_log_cdf_inverse"] = mix_totals["mix_log_cdf_inverse"]
    print(f"phase 7 (FFJORD) starts at {time.perf_counter() - t_start:.1f} s")
    ffjord_main_path(dev, counters, launches_of, smi)
    print(f"phase 7 (flowpp-img32x1 var_dequant) starts at "
          f"{time.perf_counter() - t_start:.1f} s")
    launches["attention_fwd"] += vardequant_main_path(dev, counters, launches_of, smi)
    print(f"phase 8 (ResFlow training) starts at {time.perf_counter() - t_start:.1f} s")
    for k, v in resflow_train_main_path(dev, counters, launches_of, smi, rf, errs).items():
        launches[k] += v
    print(f"phase 9 (scan + remat, bf16, checkpoints) starts at "
          f"{time.perf_counter() - t_start:.1f} s")
    scanned, ckpt, totals = production_shape_phase(dev, counters, launches_of)
    for k, v in totals.items():
        if v:
            launches[k] += v
    print(f"phase 10 (the CLI) starts at {time.perf_counter() - t_start:.1f} s")
    totals, cli_out = cli_phase(dev, counters, launches_of)
    for k, v in totals.items():
        if v:
            launches[k] += v
    print(f"phase 11 (timing) starts at {time.perf_counter() - t_start:.1f} s")

    # ---- 11. timing and bounds
    kernels = []
    for model_name, (prog, x, gen) in programs.items():
        stack = prog.stack
        spec = stack.spec
        zin = torch.randn(BATCH, 2, generator=gen, device=dev)
        if model_name == "resflow":
            probes = eval_probes("unbias", BATCH, 2, dev)
            print(f"resflow main path: the port's n_terms={probes[1].tolist()}")
            z_ex = torch.randn(BATCH, 2, generator=gen, device=dev)
            plain_of = {
                "forward": lambda sp, pk, x_, pr_, _: rf.fused_resflow_fwd_logdet_reference(
                    sp, pk, x_, pr_),
                "inverse": rf.fused_resflow_solve_logdet_reference,
                "solve": lambda sp, pk, z_, _, tr: rf.fused_resflow_solve_reference(sp, pk, z_,
                                                                                    tr)}
            for st, direction, inp, pr in ((stack, "forward", x, probes),
                                           (stack, "inverse", zin, probes),
                                           (exact.stack, "solve", z_ex, None)):
                trips = []
                plain_of[direction](st.spec, st.packed, inp, pr, trips)
                work = resflow_work(st.spec, st.packed, BATCH, direction,
                                    None if pr is None else pr[1], trips)
                kernels.append(kernel_entry(
                    RESFLOW_NAMES[direction], launches, errs, work, sfu_per_s,
                    device_ms(lambda: rf.launch(st, inp, direction, pr), 200),
                    device_ms(lambda: plain_of[direction](st.spec, st.packed, inp, pr, None),
                              PLAIN_ITERS),
                    blocks=st.spec.n_repeats, filters=st.spec.filters,
                    estimator=st.spec.estimator, g_evaluations=work["g_evaluations"],
                    series_products=work["series_products"],
                    solve_trips_per_block=trips[::-1] if trips else None,
                    **resflow_pairing(pr),
                    **resflow_occupancy(rf, st.kernel, direction, st.spec.n_repeats)))
            desc = (f"resflow 2d, {spec.n_repeats} blocks, F={spec.filters}, "
                    f"logdet={spec.estimator}")
        else:
            flowpp = model_name == "flow++"
            mod = ff if flowpp else fs
            reference = ff.fused_flowpp_reference if flowpp else fs.fused_stack_reference
            for name, inv, inp in ((MODELS[model_name][0], False, x),
                                   (MODELS[model_name][1], True, zin)):
                direction = "inverse" if inv else "forward"
                plain_ms = device_ms(lambda: reference(stack.packed, stack.const_ld, inp,
                                                       direction), PLAIN_ITERS)
                if not flowpp:
                    kernels.append(stack_entry(fs, name, stack, inp, inv, plain_ms, launches,
                                               errs, sfu_per_s))
                    continue
                work = flowpp_work(stack, inp, inv)
                kernels.append(kernel_entry(
                    name, launches, errs, work, sfu_per_s,
                    device_ms(lambda: mod.launch(stack, inp, inv), 200), plain_ms,
                    couplings=spec.n_repeats, filters=spec.filters, mixtures=spec.n_mixtures,
                    mixture_evaluations=work["mixture_evaluations"],
                    warp_mixture_evaluations=work["warp_mixture_evaluations"],
                    block_mixture_evaluations=work["block_mixture_evaluations"]))
            desc = (f"{model_name} 2d, {spec.n_repeats} couplings, F={spec.filters}"
                    + (f", K={spec.n_mixtures}" if flowpp else ""))
        t_fwd = wall_ms(lambda: prog.forward(x), 200)
        t_inv = wall_ms(lambda: prog.inverse(zin), 200)
        if model_name == "realnvp":
            serving_roofline(prog, x, zin, t_fwd, t_inv, kernels[-2]["ms"], kernels[-1]["ms"],
                             smi)
        busy = launch_busy(lambda: (prog.forward(x), prog.inverse(zin)), 50, counters,
                           launches_of, {e["name"]: e["ms"] for e in kernels})
        host = {}
        if model_name in ("realnvp", "glow"):
            k_fwd, k_inv = (e["ms"] for e in kernels[-2:])
            host = {"kernel_forward_ms": k_fwd, "kernel_inverse_ms": k_inv,
                    "wall_less_kernel_ms": [t_fwd - k_fwd, t_inv - k_inv],
                    "host_enqueue_ms": [enqueue_ms(lambda: prog.forward(x), 100),
                                        enqueue_ms(lambda: prog.inverse(zin), 100)],
                    "launch_enqueue_ms": [
                        enqueue_ms(lambda: fs.launch(stack, x, False), 100),
                        enqueue_ms(lambda: fs.launch(stack, zin, True), 100)],
                    "host_note": "host_enqueue_ms: the host's own cost per EvalProgram "
                                 "call (100 calls, no synchronize); launch_enqueue_ms the "
                                 "same for the kernel wrapper alone; the card waits on the "
                                 "host where these exceed the kernel's ms"}
        print(json.dumps({"main_path": {
            "model": desc, "batch": BATCH,
            "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
            "fwd_inv_samples_per_s": BATCH / ((t_fwd + t_inv) / 1e3),
            "device_idle_share": 1.0 - busy,
            "idle_note": "1 - the kernels' launches in 50 fwd+inv pairs times their ms, "
                         "over the pairs' wall time (no profiler)", **host,
            "card": smi}}))
        if model_name == "resflow":
            busy, kept = device_busy(lambda: (exact.forward(x), exact.inverse(z_ex)),
                                     EXACT_ITERS // 3, (rf,), ("fused_resflow",))
            print(json.dumps({"resflow_exact": {
                "model": f"resflow 2d, {exact.stack.spec.n_repeats} blocks, logdet=exact",
                "batch": BATCH,
                "eval_program_forward_ms": wall_ms(lambda: exact.forward(x), EXACT_ITERS),
                "eval_program_inverse_ms": wall_ms(lambda: exact.inverse(z_ex), EXACT_ITERS),
                "calls": EXACT_ITERS,
                "device_idle_share": None if busy is None else 1.0 - busy,
                "solve_records_kept": kept, "card": smi}}))
    for name, (prog, x, z) in eager.items():
        t_fwd = wall_ms(lambda: prog.forward(x), EAGER_ITERS)
        t_inv = wall_ms(lambda: prog.inverse(z), EAGER_ITERS)
        print(json.dumps({"main_path": {
            "model": f"{name} 2d, 32 layers: the eager chain (no kernel of the port, as "
                     "nf_tpu runs no Pallas kernel there)",
            "batch": BATCH, "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
            "calls": EAGER_ITERS, "fwd_inv_samples_per_s": BATCH / ((t_fwd + t_inv) / 1e3),
            "card": smi}}))
    t_img = time.perf_counter()
    unrolled = {img["tier"]["label"]: image_timing(img, smi, tc) for img in images}
    for img in scanned:
        scan_timing(img, unrolled[img["tier"]["label"]], smi, tc)
    print(json.dumps({"checkpoint": {**ckpt, "card": smi}}))
    print(json.dumps({"cli": {**cli_out, "card": smi}}))
    kernels += coupling_entries(tc, launches, errs, sfu_per_s, dev, coupling_per_call)
    print(f"image timing took {time.perf_counter() - t_img:.1f} s")
    t_img = time.perf_counter()
    flowpp_image_timing(fp, smi, ca)
    kernels.append(attention_entry(ca, ta, launches, errs, sfu_per_s, dev))
    kernels.append(mixlogcdf_entry(cm, mlc, launches, errs, sfu_per_s, mix_main))
    t_wide = time.perf_counter()
    kernels += wide_entries(wide_records, wide_launches, errs, sfu_per_s)
    print(f"wide paths' timing took {time.perf_counter() - t_wide:.1f} s")
    print(f"image Flow++ timing took {time.perf_counter() - t_img:.1f} s; the run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
