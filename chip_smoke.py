#!/usr/bin/env python3
"""Drive the PyTorch port, ``sinddm_tpu_torch``, on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``, and imports nothing of JAX or of ``sinddm_tpu``. Phases,
each of which exits non-zero when it fails:

1. identify the card; turn TF32 off so the plain versions are true fp32;
2. build the CUDA kernels from ``sinddm_tpu_torch/csrc`` for sm_90a; check
   with ``cuobjdump -sass`` that every instantiation of the conv block's
   3x3 kernel holds tensor-core ``HMMA`` instructions (TF32 in fp32, BF16 in
   bf16), so no stage runs on the SIMT cores;
3. hold each kernel against its plain version at the main path's shapes
   (the four dim=160 blocks at 16x186x248, fp32 and bf16; the depthwise
   kernel at each of its walk calls there, C = 3 / 80 / 160 with the block's
   per-batch vector, fp32 and bf16, and its launch plan; the eight view-warp
   kernels at 16 images x 8 views of 224x298 from 186x248x3, value and image
   gradient; win3 also against the exact warp) and at ragged shapes
   (1x19x21; a 300-row source), and, for every warp kernel, one launch
   that mixes views with coords scattered over the whole source (so the
   whole-image adjoint takes both its shared-memory box and its direct
   branch: checked from its patch plan), flat coords, and 37x45 frames;
4. time each kernel with CUDA events beside its bound, its plain version
   and, where there is one, the one PyTorch call that computes it
   (``F.conv2d`` with groups, ``F.grid_sample``; for win3 the library call
   computes the exact warp, not the split one); a conv block also beside
   its four bounds (fp32 SIMT, TF32, 3xTF32, bf16) and cuDNN's time for its
   two 3x3 products alone (no single call computes a block); the depthwise
   kernel at C = 3 / 80 / 160, fp32 and bf16; the five warp forwards and
   the three patch adjoints (whole-image, windowed and win3) also as the
   kernel alone (their C entry, no wrapper), at one launch of the guided
   path and with all 256 views of a step in one launch;
   print the patch adjoints' plan (patches that sum in the
   shared-memory box or scatter directly, global atomics of each); check
   with torch.profiler that the win3 entry is one launch;
5. sample the full 5-scale balloons pyramid at dim=160, batch 16, fp32,
   with seeded random weights, through the kernels: check shapes, finite
   values and the launch counts; profile a second walk (device time by
   kernel, the depthwise kernels' share, idle share); compare one finest-scale denoiser call, and a
   batch-2 walk, with the plain path;
6. the CLIP-guided path: ``clip_content`` (strength 0.3, fill factor 0.3) on
   the same pyramid and denoiser with a seeded random ViT-B/32 at its
   published widths, batch 16, 16 views in chunks of 8: 143 guided steps.
   Check shapes, values, the guided-step counts and the launch counts;
   profile a few guided steps; run one guidance iteration through each of
   the other four forward kernels (and their adjoints), and two whole guided
   steps, against the same computation through the plain warp; one guidance
   iteration and a profile of a few guided steps with the bf16 vision tower
   against the fp32 one;
7. ``clip_roi`` on the same denoiser and ViT-B/32: a 96x128 box of a seeded
   186x248 image, batch 16, 100 ascent iterations through the whole-image
   warp kernels (``--warp_impl pallas``), then 3 denoising steps at the finest
   scale. Check shape, values, the score trace and the launch counts; hold
   one ascent iteration against the plain warp; profile a few iterations;
8. training: (a) ``--mode train`` through the CLI at dim=160, batch 32, on
   a seeded synthetic 248x186 image (the balloons geometry; its rescale
   losses computed), 40 steps with a milestone every 20 (checkpoints,
   loss JSON, the EMA's scale-0 samples through kernels 1 and 2, the
   post-train walk; finite losses and launch counts checked): the JAX
   CLI's default, grouped chunks (cut at the milestones: every scale 4
   times a chunk, checked) as CUDA-graph replays, then a resume with
   ``--load_milestone -1``, then ``--steps_per_chunk 0`` and ``--fused_mode
   padded``; one step against the same step in float64
   (``step_vs_float64``) at the coarsest and the finest scale over a few
   seeds, and its control, a step in TF32; (b) a graph trainer against an
   eager one, step by step at every scale and on the padded canvas, with
   an lr milestone inside the replays of each: the draws equal, the losses
   and the parameters, the graph pool's size and the captures' seconds;
   and its controls, a graph trainer with a fault planted in its captures
   (gradients not zeroed, the lr a number, the generator not registered),
   each of which must break a bound or fail to capture; (c) a padded step against the true-shape step at
   every scale; (d) the step time of every scale per step, in an eager
   chunk and as graph replays, the peak memory, profiles of per-step steps
   and of replays at the coarsest and the finest scale (idle share, kernels
   a step) and one profiled step by group; (e) a graph run's checkpoint
   resumed by a new trainer, and through a CPU trainer and back; (f)
   ``--precompile`` from a cold build directory, then warm. cuDNN's TF32 is
   on in this phase, PyTorch's default, so the trainer's own scope is what
   keeps its steps, and its captures, in fp32;
9. image-to-image and ROI on the trained balloons-120k EMA weights
   (``weights/balloons-120k-ema.npz``, ``--load_checkpoint``): through the CLI
   at dim=160, batch 16, fp32, on phase 8's seeded 248x186 image with a
   seeded 300x200 input (capped to 273x182 by ``auto_scale``, so kernels 1-2
   run at a ragged full-width shape) and a seeded mask:
   ``--mode harmonization`` (5 steps), ``--mode style_transfer`` (15 steps)
   and ``--mode roi`` (one source box, two target boxes, the balloons step
   counts). Check the JAX CLI's files and their shapes, finite values, the
   harmonization composite equal to the input where the dilated mask is 0,
   and the launch counts; time each run, its library call alone
   (``image2image``, ``roi_guided_sampling``) and the host preparation (PIL,
   dilation, histogram) alone; hold a batch-2 style transfer (trained
   weights) and a batch-2 ``roi`` walk (phase 5's random weights) through the
   kernels against the plain block, and print the trained ``roi`` walk's
   difference beside its sensitivity to a 1e-6 change of its first draw;
   time one denoiser call at the i2i shape and at 16x186x248; check that a
   ``--profile`` trace of a style transfer names kernels 1 and 2;
10. the bucketed guided walk (``--bucketed_guidance``): one denoiser call in
   the valid-mask mode (a 133x177 region of 16x186x248, kernels 1-2 with the
   mask between their launches) against the valid crop and the plain mask
   mode, zero outside, and its time beside the crop's and the full canvas's;
   ``clip_content`` at batch 16 on phase 6's pyramid, denoiser and ViT-B/32
   with every via scale on the 186x248 canvas: shapes, values, n_guided and
   the launches of kernels 1, 2, 6 and 7 equal to phase 6's, its wall beside
   phase 6's and a per-scale walk's right after it; a batch-2
   ``clip_style_trans`` bucketed against per-scale on the same draws, beside
   the per-scale walk against itself and a control on other draws that must
   break the checks; where the valid region is smaller than the canvas, the
   unguided bucketed via scales at batch 2 through the kernels against the
   plain block, and at the 133x177 scale on the 186x248 canvas one guidance
   iteration and two guided steps with kernels 7 and 6 against the
   matrix-product warp; the vision tower's attention share (one iteration
   with ``attn_impl="skip"``); the SIFID feature maps (conv proxy, Inception
   stem, CLIP tokens and patch embedding) on the card against the CPU;
11. the ('data', 'spatial') mesh (``sinddm_tpu_torch/parallel``): worker
   processes of the port (``chip_smoke.py --mesh-worker``) share the card
   as a world of two ranks over gloo (NCCL takes one rank a card), once as
   ``data=2`` and once as ``spatial=2``, each against the single process on
   the same seeds, computed here: (a) phase 5's B=16 walk, with the walls,
   the gather's time a denoiser call and summed over one more split walk
   (CUDA events) and the launches of kernels 1 and 2 per rank; (b) three train steps at dim 160, batch 32 (s
   = 0, 4, 4), then a grouped chunk of a step a scale (uncaptured in a
   world): the losses and the parameters against the single process's,
   the parameters bit-equal across ranks, and a batch-8 step against
   float64 at s = 0 and 4; (c) under ``data=2``, one guidance iteration at
   batch 16 and a batch-4 ``clip_content`` walk (launches of kernels 1, 2,
   6, 7 per rank), held by ``walk_stats`` beside the single walk against
   itself and a control on other draws; (d) ``--mode sample --mesh_data 2``
   through the CLI on two processes against one; (e) a one-rank NCCL world
   on the card running the port's gather and gradient all-reduce;
12. the dot-formulated denoiser executor (``models/fast_denoiser.py``,
   ``make_model_fn(model, "fp32_dot" | "bf16_dot")``: every conv as matrix
   products a tap, cuBLAS's, no kernel of its own) on phase 5's pyramid and
   weights: (a) one finest-scale call, ``fp32_dot`` against the plain path
   and the kernel path and ``bf16_dot`` against the plain path, with
   cuBLAS's TF32 on around them so the executor's own fp32 scope is what
   holds, and a control with that scope taken out, which must break the
   fp32 bound; (b) the batch-2 walk under ``fp32_dot`` on phase 5's draws
   against phase 5's kernel walk; (c) the l3 block through the dot path
   beside kernels 2 + 1 and cuDNN's two 3x3 products, fp32 and bf16, one
   finest call of each executor (its kernel launches, counted as the
   kernel nodes of a CUDA graph that captures it, its device time and
   where that goes), and the B=16 walk through each, with the peak GB
   above what is held.

The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``; the ``[paths]`` line
before them holds the walks' times (phase 9's under ``i2i_roi``, phase 10's
under ``bucketed``, phase 11's under ``mesh``, phase 12's under ``dot``).

Tolerances (max |kernel - plain| against the plain version's values):
  * fp32 conv block: atol 2e-4 + rtol 2e-4 per element -- the kernel sums
    the same fp32 products in another order than cuDNN;
  * bf16 conv block: max error <= 2e-2 of max |plain| -- both round h1, g
    and the output to bf16, and a sum-order difference can flip a rounding;
  * depthwise against a float64 plain version on the same values: fp32 atol
    1e-5, the bound the JAX package holds its TPU kernel to; bf16 within
    half a bf16 ulp of the exact value, + 1e-4 for the fp32 sum (the sum is
    rounded once, and a rounding tie may go either way);
  * finest-scale denoiser call (four blocks chained): 1e-4 of max |plain|;
    the same for the dot executor's ``fp32_dot`` call against the plain and
    the kernel call (its TF32 control must exceed it), and 5e-2 of max
    |plain| for ``bf16_dot`` (the JAX package's bound,
    tests/test_fast_denoiser.py); its batch-2 walk 2e-3 absolute against
    phase 5's kernel walk, as below;
  * batch-2 walk, 246 chained denoiser calls: 2e-3 absolute on [-1, 1]; the
    same for the batch-2 style transfer (15 calls, trained weights) and ROI
    walk (246, random weights) of phase 9. On the trained weights the ROI
    walk amplifies any difference (a 1e-6 change of its first draw reached
    2.2e-2 by scale 3 on the H100), so its kernel-vs-plain difference is
    printed beside that control, not bounded;
  * the harmonization composite where the dilated mask is exactly 0: equal
    to the input, bit for bit;
  * the mask-mode denoiser call (phase 10) against the valid crop and the
    plain mask mode: 1e-4 of max |plain|, exactly 0 outside the region;
  * a batch-2 guided walk against another on the same draws (phase 10): the
    finest scale's share of elements over 0.1 at most WALK_SHARE, the least
    per-sample cosine (of the updates from the injected image, for
    clip_style_trans) at least WALK_COS, the clip scores within
    WALK_SCORE_REL relative. The walks do not repeat (the adjoint's atomics),
    so these hold the walk's statistics, not its elements: the per-scale walk
    against itself reads the same, and a walk on other draws must break them;
  * the unguided bucketed via scales at batch 2 (146 chained denoiser calls
    on valid crops of the canvas) against the plain block: 2e-3 absolute at
    every scale, the state exactly 0 outside the valid region; the guidance
    iteration and the two guided steps at a via scale: the GUIDE bounds
    below, as at the finest scale, the mask's differences and covered share
    taken over the valid region, x and the mask exactly 0 outside it;
  * the SIFID feature maps on the card against the CPU (TF32 off): 1e-4 of
    max |feature|, the SIFID of two samples within 1e-3 relative;
  * phase 11, a world against the single process on the same seeds: the
    walk 2e-3 absolute (the batch-2 walk's bound; it read 0.0), every rank
    equal; a train step's loss TRAIN_LOSS_TOL relative (the chunk's after
    them GRAPH_LOSS_TOL, the scales equal), the parameters after
    two steps within 1e-2 lr for all but TRAIN_UPDATE_SHARE of the elements,
    bit-equal across ranks after three, the step against float64 phase 8's
    bounds; the guidance iteration the GUIDE bounds; the batch-4 guided walk
    the MESH_WALK bounds, which the single walk against itself must hold and
    a control on other draws must break; the CLI's PNGs within one 8-bit
    level, one set, from the primary alone;
  * view-warp kernels against ``bilinear_sample_mm`` (TF32 off): value atol
    1e-5, image gradient 1e-5 of max |gradient| -- the same fp32 products in
    another order, the adjoint's atomics in an order that changes per run;
    win3 against ``bilinear_sample_split3`` (the same bf16 splits in matrix
    products) the same bounds, and against ``bilinear_sample_mm`` the bounds
    of the JAX package's test (tests/test_pallas_warp.py
    test_windowed_split3_close_to_exact): value atol 3e-4, gradient 7e-5 of
    max |gradient| (2e-3 on a gradient of max ~30);
  * one guidance iteration (warp, colour ops, ViT-B/32 forward and backward)
    through a warp kernel against the same through the plain warp: gradient
    within GUIDE_TOL of max |gradient| for all but GUIDE_OUTLIERS of the
    elements, a cosine of at least GUIDE_COS, the loss within 1e-4. The
    views differ by ~1e-7; the tower carries that to the gradient, and a
    view pixel that close to a kink of the colour ops (a clip bound, a hue
    sector edge) takes the other branch, which moves the four source pixels
    under it. Half of the walk's output sits exactly on a clip bound, where
    the two paths' last bits decide the branch, so the worst element is
    printed, not bounded: over 40 inputs (guided_check_spread.py, H100) it
    reached 0.11 of max |gradient|, and 16 inputs went past 0.05;
  * the first whole guided step (the hook), which fixes the edit mask: the
    mask equal except at most 0.1% of the pixels (an energy within rounding
    of the quantile), and each sample's update (x out - x in) with a cosine
    of at least GUIDE_COS to the plain path's. x itself is not bounded
    there: the step soft-thresholds the gradient at its per-sample energy
    quantile q and rescales it by |x m| / |g m|, so a kink that moves q
    shifts every masked pixel of that sample, and the share of x over 1e-4
    has a tail past 0.1% (2.3e-3 in one H100 run);
  * the next guided step, with that mask (every later step of a walk): x
    within 1e-4 absolute for all but GUIDE_OUTLIERS of the elements (the
    same kinks);
  * one guidance iteration with the bf16 vision tower against the fp32 one:
    finite, the loss within 2e-2 relative (bf16 keeps ~3 digits); the
    gradients' cosine is printed, not bounded;
  * a graph trainer against an eager trainer from the same seed (batch 32,
    6 steps a scale and 6 padded steps): the draws (t, noise, the padded
    scale) equal, each loss within GRAPH_LOSS_TOL relative (two eager
    trainers differ too: cuDNN's backward is not bitwise repeatable, and
    Adam carries the last bits to ~1e-5 in six steps), the parameters
    within 1e-2 lr for all but TRAIN_UPDATE_SHARE of the elements, an lr
    milestone crossed inside the replays; a graph trainer with a fault
    planted in its captures must break one of these bounds or fail to
    capture; a checkpoint's resume: the scales equal, the losses GRAPH_LOSS_TOL;
  * a padded step against the true-shape step on the same valid-region
    draws (batch 8): the loss within TRAIN_LOSS_TOL relative, the gradients
    within TRAIN_GRAD_TOL of the largest (cuDNN picks its algorithms by
    shape, the canvas's others);
  * one train step, fp32 in the trainer's scope, against float64 (batch 8,
    dim 160, the same weights and draws): the loss within 1e-5 relative,
    the largest gradient error within 1e-4 of the largest gradient, and
    each parameter's change within 1e-2 lr for all but 0.1% of the
    elements (Adam's first step is about lr times the gradient's sign, so
    a gradient near zero may move its element by up to 2 lr; the largest
    error is printed). Over 5 seeds at s = 0 and 4 in one H100 run the
    worst were 5.4e-7, 2.3e-5 and 6.3e-5, the largest change error 1.79
    lr; the control, the same step in TF32, read a gradient error of
    4.6e-4 / 4.3e-4 at s = 0 / 4 (PERF.md).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Balloons: the JAX package's reference image is 248x186 (W, H). Sampling
# needs only the pyramid geometry and the four rescale losses, not the
# pixels; the losses are the golden values of tests/test_pyramid.py (the
# reference's uint8-wraparound semantics).
BALLOONS_WH = (248, 186)
BALLOONS_LOSSES = (1.0871835898797855, 0.7771932694518568, 0.5452509776707822, 0.3865868564044144)
BALLOONS_SIZES_HW = [(48, 64), (67, 90), (94, 126), (133, 177), (186, 248)]
BALLOONS_T_IDEAL = (100, 52, 41, 31, 22)
DIM = 160
BATCH = 16
BLOCKS = (("l1", 3, 80), ("l2", 80, 160), ("l3", 160, 160), ("l4", 160, 80))
DW_CHANNELS = (3, DIM // 2, DIM)  # the depthwise kernel's C at l1, l2, l3 / l4
RAGGED_HW = (19, 21)
N_AUG, VIEW_CHUNK = 16, 8
STRENGTH, FILL_FACTOR, STOP_GUIDANCE = 0.3, 0.3, 3
GUIDE_TOL, GUIDE_OUTLIERS, GUIDE_COS = 1e-5, 1e-3, 0.999
WARP_REPLACES = {  # C entry -> the TPU kernel's pallas_call
    "whole_fwd": "sinddm_tpu/ops/pallas_warp.py:160",
    "whole_bwd": "sinddm_tpu/ops/pallas_warp.py:198",
    "win_fwd": "sinddm_tpu/ops/pallas_warp.py:402",
    "winx_fwd": "sinddm_tpu/ops/pallas_warp.py:546",
    "winb_fwd": "sinddm_tpu/ops/pallas_warp.py:641",
    "win_bwd": "sinddm_tpu/ops/pallas_warp.py:441",
    "win3_fwd": "sinddm_tpu/ops/pallas_warp.py:824",
    "win3_bwd": "sinddm_tpu/ops/pallas_warp.py:864",
}
# the JAX package's win3 gradient error through Mosaic on the TPU (max |dg| on max |g|)
TPU_WIN3_GRAD_ERR = (7.43, 30.4)
# phase 10: the valid region of the mask-mode denoiser call (the 133x177 scale
# on the 186x248 canvas); the guided checks of a batch-2 walk against another
# on the same draws (finest share of elements over 0.1, least per-sample
# cosine, clip-score relative difference: over 6 inputs of
# guided_check_spread.py --walks and one run of this script on an H100,
# bucketed vs per-scale clip_style_trans read <= 0.361, >= 0.957, <= 3.4e-3,
# the per-scale walk against itself <= 0.328, >= 0.966, <= 2.4e-3, a walk on
# other draws >= 0.857, <= 0.310, >= 1.6e-2)
MASK_VALID_HW = (133, 177)
WALK_SHARE, WALK_COS, WALK_SCORE_REL = 0.5, 0.9, 1e-2
ROI_BOX = (48, 64, 96, 128)  # y x h w: a quarter of the 186x248 image, views of 224x298
# the train phase: the CLI's default batch, steps to two milestones; one step
# against float64 at a smaller batch over a few seeds, and its bounds
TRAIN_BATCH, TRAIN_STEPS = 32, 40
# graph against eager: steps at each scale (the first GRAPH_WARMUP_STEPS of a
# shape eager, then replays); steps timed a scale; steps a profile
GRAPH_CHECK_STEPS, TRAIN_TIME_STEPS, TRAIN_PROFILE_STEPS = 6, 5, 3
# a free-running graph chunk's losses against the eager chunk's: the card's
# cuDNN backward is not bitwise repeatable (two eager steps from one state
# differ by ~1e-7 at the second step), and Adam carries that to ~1e-5 within
# six steps (1.3e-5 on an H100 80GB HBM3 at 700 W); a wrong step (stale draws, lr or Adam
# count, unzeroed gradients) moves a loss or the parameters by far more, as
# (b)'s controls, which plant such faults, show
GRAPH_LOSS_TOL = 1e-4
# (b)'s lr milestones, one inside the grouped replays (steps 10-29), one
# inside the padded replays (32-35), and the faults its controls plant
GRAPH_CHECK_MILESTONES = (20, 34)
GRAPH_FAULTS = ("unzeroed", "baked_lr", "unregistered")
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEEDS = 8, 5
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_UPDATE_SHARE = 1e-5, 1e-4, 1e-3
# phase 9: the trained weights, a seeded i2i input (W x H) with a mask box
# (rows, columns of the input), the CLI's default starting steps, and the
# ROI boxes (y x h w) inside the 186x248 image
EMA_NPZ = Path("weights") / "balloons-120k-ema.npz"
I2I_WH = (300, 200)
MASK_BOX = (slice(60, 120), slice(110, 190))
START_T = {"harmonization": 5, "style_transfer": 15}
ROI_TARGET, ROI_BBS = (40, 60, 60, 80), ((10, 10, 50, 70), (110, 150, 60, 80))
# phase 11: the worlds (name, data, spatial), two ranks on the one card; the
# guided walk's batch and seed (its control takes the next seed) and the
# checks of a walk on the same draws against the single process's (finest
# share of elements over 0.1, least per-sample cosine, clip-score relative
# difference: over 3 inputs of guided_check_spread.py --mesh_walks and one
# run of phase 11 on an H100, the batch-4 clip_content walk against itself
# read <= 0.070, >= 0.9940, <= 3.1e-4, split over data 0.071, 0.9942,
# 3.2e-4, a walk on other draws >= 0.447, <= 0.842, >= 1.98e-2)
MESH_WORLDS = (("data", 2, 1), ("spatial", 1, 2))
MESH_GUIDED_BATCH, MESH_WALK_SEED = 4, 30
MESH_WALK_SHARE, MESH_WALK_COS, MESH_WALK_SCORE_REL = 0.2, 0.98, 5e-3

def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def block_inputs(gen, b, h, w, c, co, dtype):
    """Seeded block inputs, weights fan-in scaled so activations stay O(1)."""
    def n(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    proj = c != co
    return (
        n(b, h, w, c).to(dtype), n(b, c, scale=0.2),
        n(5, 5, c, scale=0.2), n(c, scale=0.1),
        n(3, 3, c, co, scale=(9 * c) ** -0.5), n(co, scale=0.1),
        n(3, 3, co, co, scale=(9 * co) ** -0.5), n(co, scale=0.1),
        n(c, co, scale=c ** -0.5) if proj else None, n(co, scale=0.1) if proj else None,
    )


def dw_inputs(gen, shape, dtype, with_vec=True):
    """Seeded depthwise inputs (x, weights, bias, the block's per-batch vec) of one type."""
    b, c = shape[0], shape[-1]
    n = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device="cuda") * scale).to(dtype)  # noqa: E731
    return n(*shape), n(5, 5, c, scale=0.2), n(c, scale=0.1), n(b, c, scale=0.2) if with_vec else None


def dw_err(out, x, wdw, bias, vec):
    """Max |kernel - float64 plain version| on the same values, and whether
    it is within the bound of its type."""
    from sinddm_tpu_torch.ops.dw_conv import depthwise_conv5x5_reference

    ref = depthwise_conv5x5_reference(*(None if t is None else t.double() for t in (x, wdw, bias, vec)))
    d = (out.double() - ref).abs()
    ok = d.max().item() <= 1e-5 if out.dtype == torch.float32 else bool((d <= 1e-4 + 2.0**-8 * ref.abs()).all())
    return d.max().item(), ok


def block_work(b, h, w, c, co, itemsize):
    """FLOPs and bytes one conv block must do (inputs read once, output written once)."""
    from sinddm_tpu_torch.utils.flops import block_flops_per_pixel

    proj = c != co
    px = b * h * w
    flops = px * block_flops_per_pixel(c, co)
    params = 26 * c + 9 * c * co + co + 9 * co * co + co + ((c + 1) * co if proj else 0)
    nbytes = itemsize * (px * (c + co) + b * c + params)
    return flops, nbytes


def bound(flops, nbytes, flop_rate, mem_rate):
    t_ops, t_mem = flops / flop_rate, nbytes / mem_rate
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def err_stats(out, ref):
    d = (out.float() - ref.float()).abs()
    ref_max = ref.float().abs().max().item()
    max_abs = d.max().item()
    return d, max_abs, max_abs / max(ref_max, 1e-30)


def warp_work(b, n, h, w, c, adjoint, split3=False):
    """FLOPs and bytes one warp launch must do: coords read, the source read
    (fp32, or win3's two bf16 planes: the same bytes) and the samples written
    (forward), or the cotangent read and the image gradient zeroed and
    written (adjoint)."""
    img_bytes = 4 * b * h * w * c
    nbytes = b * n * (8 + 4 * c) + (2 * img_bytes if adjoint else img_bytes)
    # two hat rows a pixel; four weighted taps a channel, or win3's three
    # two-term dots at each of two columns (25) / split products at four taps (22)
    per_c = (22 if adjoint else 25) if split3 else 8
    return b * n * (12 + per_c * c), nbytes


def plain_warp(img, coords, fill, one=None):
    """The plain version at the kernels' batching: ``one`` (bilinear_sample_mm
    unless given) an image."""
    from sinddm_tpu_torch.ops.warp import bilinear_sample_mm

    one = one or bilinear_sample_mm
    return torch.stack([one(img[b], coords[b], fill) for b in range(img.shape[0])])


def grid_sample_inputs(img, coords):
    """The same sampling as one ``F.grid_sample`` call (fill 0): NCHW input,
    all views of an image as one tall grid, coordinates normalised for
    align_corners=True."""
    b, h, w, c = img.shape
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=img.device)
    grid = coords.reshape(b, -1, coords.shape[-2], 2) * scale - 1.0
    return img.permute(0, 3, 1, 2).contiguous(), grid.contiguous()


def run_kernel(build, entry, img, coords, fill, ct=None):
    """A launcher of one C entry on buffers made here, without the wrapper's
    checks, copies and allocation: the kernel alone. ``entry`` is a forward
    (``whole_fwd``, ``win_fwd``, ``winx_fwd``, ``winb_fwd``, ``win3_fwd``;
    fill ``fill``) or a patch adjoint, ``whole_bwd``, ``win_bwd`` or
    ``win3_bwd`` (cotangent ``ct``, frames as wide as ``coords``' last
    sample axis). Fails unless a first launch returns success."""
    from sinddm_tpu_torch.ops.warp_sample import adjoint_patch

    b, h, w, c = img.shape
    coords3 = coords.reshape(b, -1, 2).contiguous()
    n = coords3.shape[1]
    fn = getattr(build.library("warp_sample"), f"sinddm_warp_{entry}")
    stream = torch.cuda.current_stream(img.device).cuda_stream
    if entry.endswith("_bwd"):
        src, out, frame_w = ct.reshape(b, n, c).contiguous(), torch.empty_like(img), coords.shape[-2]
        args = (b, h, w, c, n, frame_w, adjoint_patch(n, frame_w)[1])
    else:
        src, out, args = img, torch.empty((b, n, c), device=img.device), (fill, b, h, w, c, n)

    def launch():  # holds src, coords3 and out for as long as it is timed
        return fn(src.data_ptr(), coords3.data_ptr(), out.data_ptr(), *args, img.device.index or 0, stream)

    err = launch()
    torch.cuda.synchronize()
    if err != 0:
        fail(f"the {entry} C entry returned cudaError {err}")
    return launch


def patch_plan(plan):
    """One line of ``whole_adjoint_patches``' reckoning."""
    total = plan["shared_atomics"] + plan["direct_atomics"]
    return (f"patches of {plan['patch'][0]}x{plan['patch'][1]} samples: {plan['shared']} sum in the shared-memory box, "
            f"{plan['direct']} scatter directly, {plan['empty']} empty; global atomics {plan['shared_atomics']} (box "
            f"flush) + {plan['direct_atomics']} (direct) = {total}, against {plan['per_sample_atomics']} from a thread "
            f"a sample ({total / max(plan['per_sample_atomics'], 1):.3f} of them)")


def share_over(diff, tol):
    return (diff > tol).float().mean().item()


def iteration_check(label, loss_k, grad_k, loss_p, grad_p, extra=""):
    """Print one guidance iteration against another (GUIDE tolerances) and
    return whether it passes, the gradients' cosine and the printed numbers."""
    g_max = grad_p.abs().max().item()
    diff = (grad_k - grad_p).abs()
    over, worst = share_over(diff, GUIDE_TOL * g_max), diff.max().item()
    cos = ((grad_k * grad_p).sum() / (grad_k.norm() * grad_p.norm())).item()
    ok = over <= GUIDE_OUTLIERS and cos >= GUIDE_COS and abs(loss_k.item() - loss_p.item()) <= 1e-4
    summary = (f"loss {loss_k.item():.6f} vs {loss_p.item():.6f} grad: median |diff| {diff.median().item():.3e} "
               f"share over {GUIDE_TOL:g}*max|g| {over:.3e} (<= {GUIDE_OUTLIERS:g}) cosine {cos:.8f} "
               f"(>= {GUIDE_COS:g}) worst {worst:.3e} of max|g| {g_max:.3e} ({worst / g_max:.3e})")
    say(f"[{label}] {summary} {extra}{'ok' if ok else 'over the GUIDE bounds'}")
    return ok, cos, summary


def profile_walk(run):
    """Device time by kernel over one call of ``run`` (torch.profiler, CUDA
    activity), and the device's idle share of the profiled window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in by_name.values())
    window = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    return by_name, busy, window


OTHER = "other (elementwise, softmax, norms, sort)"


def kernel_group(kname: str) -> str:
    """The PERF.md group of a device kernel, by its name."""
    low = kname.lower()
    if "sinddm" in low and "warp_" in low:
        return "warp adjoint" if "_bwd" in low else "warp forward"
    if "sinddm" in low:
        return "denoiser conv kernels"
    if any(t in low for t in ("gemm", "cutlass", "gemv", "cublas", "nvjet", "xmma")):
        return "matrix products (tower)"
    return OTHER


def profile_groups(tag, what, unit, n, run):
    """Profile ``run`` (``n`` units of work) and print device time by group
    and the top kernels; returns {group: ms a unit} or None."""
    prof = profile_walk(run)
    if prof is None:
        say(f"[{tag}] torch.profiler recorded no device activity: breakdown not measured")
        return None
    by_name, busy, window = prof
    groups = dict.fromkeys(("warp forward", "warp adjoint", "denoiser conv kernels", "matrix products (tower)", OTHER), 0.0)
    for kname, (us, _) in by_name.items():
        groups[kernel_group(kname)] += us
    say(f"[{tag}] {what}: device busy_ms {busy / 1e3:.1f} kernel-window_ms {window / 1e3:.1f} "
        f"idle_share {1 - busy / window:.4f} kernels {sum(c for _, c in by_name.values())}")
    for gname, us in groups.items():
        say(f"[{tag}] {us / busy:7.2%} {us / n / 1e3:10.2f} ms/{unit}  {gname}")
    for kname, (us, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"[{tag}] {us / busy:7.2%} {us / 1e3:10.1f} ms {c:6d}x {kname[:110]}")
    return {g: us / n / 1e3 for g, us in groups.items()} | {"busy_ms_per_" + unit: busy / n / 1e3,
                                                          "idle_share": 1 - busy / window}


def tensor_core_check(build) -> None:
    """Fail unless the SASS of every instantiation of the conv block's 3x3
    kernels holds tensor-core instructions of its type: HMMA (``mma.sync``,
    TF32 for fp32, BF16 for bf16), or HGMMA TF32 (``wgmma``) for the fp32
    stages of ``conv3x3_tc_kernel_sm90``: the stages run on the tensor
    cores, not the SIMT cores."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-sass", str(build.library_path("conv_block"))],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass of the conv_block library failed: {res.stderr.strip()[-500:]}")
    forms, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            forms[fn] = collections.Counter()
        elif fn is not None:
            forms[fn].update(re.findall(r"\bH(?:G)?MMA\.[\w.]+", line))
    convs = {f: c for f, c in forms.items() if "conv3x3" in f}
    for f, c in convs.items():
        say(f"[sass conv_block] {f}: {dict(c) if c else 'no HMMA'}")
    want = lambda f: "BF16" if "bfloat16" in f else "TF32"  # noqa: E731
    op = lambda f: "HGMMA" if "sm90" in f else "HMMA"  # noqa: E731
    bad = [f for f, c in convs.items() if not any(form.startswith(op(f)) and want(f) in form for form in c)]
    if len(convs) < 12 or bad:
        fail(f"conv_block's 3x3 kernels without tensor-core HMMA ({len(convs)} found): {bad}")


def synthetic_dataset():
    """A temporary folder under ``build/`` (removed with the returned handle)
    holding ``data/synthetic.png``: seeded uniform noise at the balloons
    size, 248x186. Returns (handle, the data folder)."""
    import tempfile

    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=work)
    data = Path(tmp.name) / "data"
    data.mkdir()
    synthetic_image(data)
    return tmp, data


def run_cli(tag, argv):
    """One ``cli.run`` (what ``cli.main`` calls) with its output echoed
    under ``tag``: (its outputs, wall seconds ending in a synchronize, the
    conv_block and dw_conv launches it made, its printed text)."""
    import io

    from sinddm_tpu_torch import cli
    from sinddm_tpu_torch.ops import conv_block as cb, dw_conv as dw

    buf = io.StringIO()
    cb.launches = dw.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        outs = cli.run(cli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"[{tag}] {line}")
    return outs, wall, {"conv_block": cb.launches, "dw_conv": dw.launches}, text


def i2i_roi_phase() -> dict:
    """Phase 9: harmonization, style transfer and ROI-guided generation
    through the CLI on the trained balloons weights, at dim 160, batch 16;
    their files, values, launches and times; a batch-2 style transfer and
    ROI walk against the plain block; a profile trace of a style transfer."""
    import numpy as np
    from PIL import Image

    from sinddm_tpu_torch.apps.i2i import image2image, prepare_i2i
    from sinddm_tpu_torch.apps.roi import roi_guided_sampling
    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.ops import conv_block as cb
    from sinddm_tpu_torch.pyramid import build_pyramid, load_external_image
    from sinddm_tpu_torch.schedules import make_schedules

    weights = ROOT / EMA_NPZ
    if not weights.is_file():
        fail(f"the trained weights {weights} are missing")
    tmp, data = synthetic_dataset()
    (data / "i2i").mkdir()
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, I2I_WH[::-1] + (3,), dtype=np.uint8)).save(data / "i2i" / "input.png")
    mask_u8 = np.zeros(I2I_WH[::-1] + (3,), np.uint8)
    mask_u8[MASK_BOX] = 255
    Image.fromarray(mask_u8).save(data / "i2i" / "mask.png")
    out = Path(tmp.name) / "results"
    base = ["--dataset_folder", str(data), "--image_name", "synthetic.png", "--results_folder", str(out),
            "--dim", str(DIM), "--sample_batch_size", str(BATCH), "--load_checkpoint", str(weights),
            "--input_image", "input.png", "--harm_mask", "mask.png"]
    roi_argv = ["--target_roi", *map(str, ROI_TARGET)] + [a for bb in ROI_BBS for a in ("--roi_bb", *map(str, bb))]
    # the walk takes the balloons step counts (the synthetic image's rescale
    # losses give others), so it is phase 5's walk with the pastes
    roi_argv += ["--sample_t_list", *map(str, BALLOONS_T_IDEAL[1:])]

    pyramid = build_pyramid(str(data / "synthetic.png"))
    n = pyramid.n_scales
    h_fin, w_fin = pyramid.sizes_hw[-1]
    inp = load_external_image(str(data / "i2i" / "input.png"), auto_scale=50000)
    h_in, w_in = inp.shape[:2]
    if (h_in, w_in) in pyramid.sizes_hw:
        fail(f"the i2i input {h_in}x{w_in} is a pyramid size")
    record = {"input_hw": [h_in, w_in]}
    sched = make_schedules(timesteps=100, scale_losses=pyramid.rescale_losses, n_scales=n, device="cuda")
    trained = denoiser_from_flax(str(weights), device="cuda")

    def walk_s(run):
        """The walk alone, the library call the CLI makes, up to a synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def grid_size(w, h):  # save_image's 4-column grid of BATCH samples, 2 px padding
        return (2 + 4 * (w + 2), 2 + (BATCH // 4) * (h + 2))

    def check_png(path, size):
        if not path.is_file():
            fail(f"the CLI wrote no {path.relative_to(out)}")
        if Image.open(path).size != size:
            fail(f"{path.relative_to(out)} is {Image.open(path).size}, not {size}")

    for mode, start_t in START_T.items():
        scope = f"phase9_{mode}"
        (final,), wall, launches, _ = run_cli(f"{mode} cli", ["--mode", mode, "--scope", scope] + base)
        # the host preparation alone, as the CLI makes it from the same files:
        # the input read and capped; the mask read, resized and dilated, or the
        # input's histogram matched
        t0 = time.perf_counter()
        prep_in = load_external_image(str(data / "i2i" / "input.png"), auto_scale=50000)
        mask01 = (np.asarray(Image.open(data / "i2i" / "mask.png").convert("RGB"), np.float32) / 255.0
                  if mode == "harmonization" else None)
        _, mask = prepare_i2i(pyramid, prep_in, mode=mode, start_s=n - 1, mask_img=mask01,
                              use_hist=mode == "style_transfer")
        prep_s = time.perf_counter() - t0
        expect = {"conv_block": start_t * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": start_t * 4}
        say(f"[i2i {mode}] batch {BATCH} dim {DIM} fp32 trained balloons-120k EMA input {w_in}x{h_in} start_t {start_t}: "
            f"wall_s {wall:.3f} (the CLI run: pyramid, weights, input, mask, walk, PNGs) host_prep_s {prep_s:.4f} "
            f"(its input and mask steps alone) launches {launches}")
        if launches != expect:
            fail(f"--mode {mode} launch counts {launches} != expected {expect}")
        if tuple(final.shape) != (BATCH, h_in, w_in, 3) or not bool(torch.isfinite(final).all()):
            fail(f"--mode {mode}: final {tuple(final.shape)} or non-finite values")
        if final.min().item() < 0.0 or final.max().item() > 1.0:
            fail(f"--mode {mode}: the final composite leaves [0, 1]")
        folder = out / scope
        check_png(folder / "i2i_final_samples" / f"input_i2i_{mode}.png", grid_size(w_in, h_in))
        for b in range(BATCH):
            check_png(folder / "unbatched_i2i_input" / f"out_b{b}.png", (w_in, h_in))
        i2i_walk_s = walk_s(lambda: image2image(
            trained, sched, pyramid, prep_in, mode=mode, mask_img=mask01, start_s=n - 1,
            custom_t=[0] * (n - 1) + [start_t], batch_size=BATCH, generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda"))
        say(f"[i2i {mode}] the image2image call alone (host preparation included) wall_s {i2i_walk_s:.3f}; the CLI's "
            f"rest (pyramid, weights, PNGs) {wall - i2i_walk_s:.3f} s")
        record[mode] = {"wall_s": wall, "host_prep_s": prep_s, "image2image_s": i2i_walk_s, "launches": launches}
        if mode == "harmonization":
            zero = torch.as_tensor(mask[:, :, 0] == 0.0, device="cuda")
            share = zero.float().mean().item()
            input01 = ((torch.as_tensor(inp, device="cuda") + 1.0) * 0.5).clamp(0.0, 1.0)
            same = bool(torch.equal(final[:, zero], input01[zero].expand(BATCH, -1, -1)))
            say(f"[check harmonization composite] where the dilated mask is 0 ({share:.4f} of the pixels) the output "
                f"equals the input bit for bit: {'ok' if same else 'FAIL'}")
            if not (same and 0.0 < share < 1.0):
                fail("the harmonization composite differs from the input where the dilated mask is 0")
            record[mode]["mask_zero_share"] = share

    outs, wall, launches, _ = run_cli("roi cli", ["--mode", "roi", "--scope", "phase9_roi"] + base + roi_argv)
    calls = sum(BALLOONS_T_IDEAL)
    expect = {"conv_block": calls * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": calls * 4}
    say(f"[roi walk] batch {BATCH} dim {DIM} fp32 trained balloons-120k EMA target {ROI_TARGET} boxes {ROI_BBS} "
        f"steps {list(BALLOONS_T_IDEAL)} denoiser_calls {calls} wall_s {wall:.3f} (the CLI run) launches {launches}")
    if launches != expect:
        fail(f"--mode roi launch counts {launches} != expected {expect}")
    for o, (h, w) in zip(outs, pyramid.sizes_hw):
        if tuple(o.shape) != (BATCH, h, w, 3) or not bool(torch.isfinite(o).all()) or o.abs().max().item() > 1 + 1e-5:
            fail(f"--mode roi output at {h}x{w}: shape {tuple(o.shape)}, non-finite or outside [-1, 1]")
    check_png(out / "phase9_roi" / "roi_patches.png", (w_fin, h_fin))
    check_png(out / "phase9_roi" / "final_samples" / "roi_out.png", grid_size(w_fin, h_fin))
    roi_walk_s = walk_s(lambda: roi_guided_sampling(
        trained, sched, pyramid, target_roi=ROI_TARGET, roi_bb_list=ROI_BBS, custom_t_list=BALLOONS_T_IDEAL[1:],
        batch_size=BATCH, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    say(f"[roi walk] the roi_guided_sampling call alone wall_s {roi_walk_s:.3f}; the CLI's rest (pyramid, weights, "
        f"preview, PNGs) {wall - roi_walk_s:.3f} s")
    record["roi"] = {"wall_s": wall, "walk_s": roi_walk_s, "launches": launches}

    # batch-2 walks through the kernels against the plain block, under the same
    # seeded noise, within 2e-3: a style transfer on the trained weights, and
    # the ROI walk on phase 5's seeded random weights. On the trained weights
    # the ROI walk carries a difference at scale 0 to O(0.1) at the finest
    # scale, kernel or not: a 1e-6 relative change of its first draw grows
    # ~10^4-fold by scale 3 (PERF.md). So there its difference is printed
    # beside that control, as a finding, and not bounded.
    seeded = denoiser_from_flax(random_flax_params(dim=DIM, seed=0), device="cuda")

    def noise(seed, rel=0.0):
        """Seeded draws; with ``rel``, the first one scaled by 1 + rel."""
        gen, first = torch.Generator(device="cuda").manual_seed(seed), [True]

        def draw(shape):
            x = torch.randn(shape, generator=gen, device="cuda")
            if first[0] and rel:
                x = x * (1.0 + rel)
            first[0] = False
            return x
        return draw

    def style(fn, rel=0.0):
        return [image2image(fn, sched, pyramid, inp, mode="style_transfer", start_s=n - 1,
                            custom_t=[0] * (n - 1) + [START_T["style_transfer"]], batch_size=2,
                            noise_fn=noise(3, rel), device="cuda")[0]]

    def roi(fn, rel=0.0):
        return roi_guided_sampling(fn, sched, pyramid, target_roi=ROI_TARGET, roi_bb_list=ROI_BBS,
                                   custom_t_list=BALLOONS_T_IDEAL[1:], batch_size=2, noise_fn=noise(3, rel),
                                   device="cuda")

    def plain(model):
        return lambda x, t, s_: model.run(x, t, s_, cb.conv_block_reference)

    def diffs(a, b):
        torch.cuda.synchronize()
        return [(x - y).abs().max().item() for x, y in zip(a, b)]

    for what, run, model, weights_name in (("style_transfer", style, trained, "trained balloons-120k"),
                                           ("roi", roi, seeded, "phase 5's seeded random")):
        got = run(model)
        max_abs = diffs(got, run(plain(model)))[-1]
        ok = max_abs <= 2e-3 and bool(torch.isfinite(got[-1]).all())
        say(f"[check {what} batch 2 on the {weights_name} weights, kernel vs plain] final max_abs {max_abs:.3e} "
            f"(atol 2e-3) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the batch-2 {what} through the kernels disagrees with the plain block")
        record[what]["batch2_vs_plain"] = max_abs
    got, ref = roi(trained), roi(plain(trained))
    kernel_vs_plain, control = diffs(got, ref), diffs(ref, roi(plain(trained), 1e-6))
    say(f"[finding roi batch 2 on the trained weights] per-scale max_abs kernel vs plain "
        f"{[f'{d:.3e}' for d in kernel_vs_plain]}; plain vs plain with its first draw x (1 + 1e-6) "
        f"{[f'{d:.3e}' for d in control]} (not bounded: the walk amplifies any difference)")
    record["roi"]["trained_batch2_vs_plain"], record["roi"]["trained_first_draw_1e-6"] = kernel_vs_plain, control

    # one denoiser call (batch 16, CUDA events) at the i2i input's shape and at
    # the pyramid's finest
    gen = torch.Generator(device="cuda").manual_seed(4)
    record["denoiser_call_ms"] = {}
    for hw in ((h_in, w_in), (h_fin, w_fin)):
        x = torch.randn((BATCH,) + hw + (3,), generator=gen, device="cuda")
        t = torch.full((BATCH,), 10, dtype=torch.long, device="cuda")
        with torch.no_grad():
            record["denoiser_call_ms"][f"{hw[0]}x{hw[1]}"] = time_ms(lambda: trained(x, t, float(n - 1)), reps=10)
    say(f"[time denoiser call batch {BATCH} dim {DIM} fp32] ms {record['denoiser_call_ms']}")

    # a --profile run: its trace must name kernels 1 and 2
    prof_dir = Path(tmp.name) / "profile"
    run_cli("style_transfer --profile", ["--mode", "style_transfer", "--scope", "phase9_profile",
                                         "--profile", str(prof_dir)] + base)
    traces = list(prof_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"--profile wrote {len(traces)} traces, not one")
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    found = {k: sorted(nm for nm in names if k in nm)[:2] for k in ("conv3x3_tc_kernel", "dw5x5_ring_kernel")}
    say(f"[check style_transfer --profile] trace {traces[0].name} {traces[0].stat().st_size} B, {len(names)} names; "
        f"kernels 1-2 in it: {found}")
    if not all(found.values()):
        fail(f"the --profile trace names no {[k for k, v in found.items() if not v]}")
    tmp.cleanup()
    return record


def train_phase(results) -> dict:
    """Phase 8: ``--mode train`` through the CLI at full width on a seeded
    synthetic 248x186 image (the balloons geometry, rescale losses
    computed): the JAX CLI's default (grouped chunks, CUDA-graph replays),
    a resume, ``--steps_per_chunk 0`` and ``--fused_mode padded``; one step
    against float64; the graph chunks against the eager chunks; the padded
    step against the true-shape step; the step time and memory of every
    scale, per step, in an eager chunk and in graph replays; a graph run's
    checkpoint resumed; ``--precompile``. cuDNN's TF32 is on here,
    PyTorch's default, so it is the trainer's own scope that keeps its steps
    (and its captures) in fp32."""
    import numpy as np

    from sinddm_tpu_torch.ops import conv_block as cb
    from sinddm_tpu_torch.pyramid import build_pyramid
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.training import trainer as trainer_mod
    from sinddm_tpu_torch.training.trainer import step_vs_float64

    tmp, data = synthetic_dataset()
    out = Path(tmp.name) / "results"
    argv = ["--mode", "train", "--dataset_folder", str(data), "--image_name", "synthetic.png",
            "--results_folder", str(out), "--dim", str(DIM), "--train_batch_size", str(TRAIN_BATCH),
            "--save_and_sample_every", str(TRAIN_STEPS // 2), "--avg_window", "10", "--sample_batch_size",
            str(BATCH)]
    pyramid = build_pyramid(str(data / "synthetic.png"))
    n = pyramid.n_scales
    sched = make_schedules(timesteps=100, scale_losses=pyramid.rescale_losses, n_scales=n, device="cuda")
    sizes_hw = [tuple(hw) for hw in pyramid.sizes_hw]
    if sizes_hw != BALLOONS_SIZES_HW:
        fail(f"the synthetic image's pyramid {sizes_hw} != the balloons geometry {BALLOONS_SIZES_HW}")
    # the kernels ran in the milestones' scale-0 samples and the post-train walk
    calls = 2 * sched.num_timesteps + sum(sched.num_timesteps_ideal)
    expect = {"conv_block": calls * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": calls * 4}

    def drive(scope, extra, what):
        """One --mode train run to TRAIN_STEPS with milestones every
        TRAIN_STEPS // 2: files, finite window losses, the launches of the
        kernels (the sampling only: a train step launches none), and the
        scales visited in each chunk (a milestone ends a chunk)."""
        torch.cuda.reset_peak_memory_stats()
        _, wall, launches, text = run_cli(f"train cli {scope}", argv + ["--scope", scope] + extra)
        losses = [float(m) for m in re.findall(r"^step:\d+ loss:(\S+)", text, re.M)]
        folder = out / scope
        ckpt = torch.load(folder / "model-2.pt", map_location="cpu", weights_only=True)
        half = TRAIN_STEPS // 2
        counts = [np.bincount(ckpt["running_scale"][i : i + half], minlength=n).tolist()
                  for i in (0, half)]
        say(f"[train] --mode train {what}: dim {DIM} batch {TRAIN_BATCH} {TRAIN_STEPS} steps wall_s {wall:.3f} "
            f"(milestones, their samples and the post-train walk included) losses {losses} visits per scale in "
            f"steps 0-{half - 1}, {half}-{TRAIN_STEPS - 1}: {counts} peak_GB "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches {launches}")
        if len(losses) != TRAIN_STEPS // 10 or not all(np.isfinite(losses)):
            fail(f"--mode train {what} logged {losses}: not {TRAIN_STEPS // 10} finite window losses")
        for name in ("model-1.pt", "model-2.pt", "model-2.loss.json", "sample-1.png", "sample-2.png"):
            if not (folder / name).exists():
                fail(f"--mode train {what} wrote no {name}")
        if ckpt["step"] != TRAIN_STEPS or not {"model", "ema", "sched", "opt", "rng"} <= set(ckpt):
            fail(f"{what}: model-2.pt holds step {ckpt['step']} and keys {sorted(ckpt)}")
        if launches != expect:
            fail(f"--mode train {what} launch counts {launches} != expected {expect}")
        return {"wall_s": wall, "losses": losses, "visits": counts}, text

    # (a) the JAX CLI's default, then a resume, the per-step path and the padded chunks
    drives = {}
    drives["grouped"], _ = drive("train", ["--train_num_steps", str(TRAIN_STEPS)],
                                 "(JAX default: --steps_per_chunk 100 --fused_mode grouped)")
    if any(len(set(c)) != 1 for c in drives["grouped"]["visits"]):
        fail(f"a grouped chunk visited the scales unequally: {drives['grouped']['visits']}")
    torch.cuda.reset_peak_memory_stats()
    _, r_wall, _, r_text = run_cli("train cli train", argv + ["--scope", "train", "--train_num_steps",
                                                             str(TRAIN_STEPS + 10), "--load_milestone", "-1"])
    r_losses = [float(m) for m in re.findall(r"^step:\d+ loss:(\S+)", r_text, re.M)]
    say(f"[train resume] --load_milestone -1 to step {TRAIN_STEPS + 10}: wall_s {r_wall:.3f} losses {r_losses}")
    if f"resumed at step {TRAIN_STEPS}" not in r_text or len(r_losses) != 1 or not np.isfinite(r_losses[0]):
        fail("--load_milestone -1 did not resume at the last milestone's step")
    drives["per_step"], _ = drive("train_per_step", ["--train_num_steps", str(TRAIN_STEPS), "--steps_per_chunk", "0"],
                                  "--steps_per_chunk 0")
    drives["padded"], _ = drive("train_padded", ["--train_num_steps", str(TRAIN_STEPS), "--fused_mode", "padded"],
                                "--fused_mode padded")
    wall, losses = drives["grouped"]["wall_s"], drives["grouped"]["losses"]

    new_trainer = functools.partial(train_trainer, sched, pyramid, Path(tmp.name))

    # one step against float64, at the coarsest and the finest scale; the
    # bounds hold the spread measured over seeds (PERF.md). Then the
    # control: the same comparison with the trainer's fp32 scope taken away,
    # so cuDNN runs the step in TF32; it must break a bound, or the bounds
    # cannot tell a TF32 step from an fp32 one
    def check(s, seed):  # a fresh trainer each: its first step, from seeded weights
        trainer = new_trainer("check", batch=TRAIN_CHECK_BATCH, seed=seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x_orig = trainer.data_list[s][0]
        t = torch.randint(0, sched.num_timesteps_trained[s], (TRAIN_CHECK_BATCH,), generator=gen, device="cuda")
        noise = torch.randn((TRAIN_CHECK_BATCH,) + tuple(x_orig.shape[1:]), generator=gen, device="cuda")
        e = step_vs_float64(trainer, s, [t], [noise])
        ok = (e["loss_rel"] <= TRAIN_LOSS_TOL and e["grad_rel"] <= TRAIN_GRAD_TOL
              and e["change_share"] <= TRAIN_UPDATE_SHARE)
        return e, ok

    def show(what, s, seed, e, ok):
        say(f"[check train step {what} vs float64 s={s} {sizes_hw[s]} batch {TRAIN_CHECK_BATCH} seed {seed}] loss "
            f"rel {e['loss_rel']:.3e} (<= {TRAIN_LOSS_TOL:g}) max|dg|/max|g| {e['grad_rel']:.3e} "
            f"(<= {TRAIN_GRAD_TOL:g}) param change: max err {e['change_max_lr']:.3e} lr, share over 1e-2 lr "
            f"{e['change_share']:.3e} (<= {TRAIN_UPDATE_SHARE:g}) {'within' if ok else 'OUT OF'} bounds")

    errors, control = {}, {}
    for s in (0, n - 1):
        for seed in range(TRAIN_CHECK_SEEDS):
            e, ok = check(s, seed)
            show("fp32", s, seed, e, ok)
            if not ok:
                fail(f"a train step at s={s} disagrees with float64")
            errors[s] = {k: max(v, errors.get(s, {}).get(k, 0.0)) for k, v in e.items()}
        fp32_scope = trainer_mod.fp32_convs
        trainer_mod.fp32_convs = contextlib.nullcontext  # the control: cuDNN's TF32 left on
        try:
            control[s], ok = check(s, 0)
        finally:
            trainer_mod.fp32_convs = fp32_scope
        show("TF32 (control)", s, 0, control[s], ok)
        if ok:
            fail(f"a TF32 train step at s={s} passes the fp32 step's bounds: they cannot tell the two apart")

    # (b)-(e) in a child process: they hold a graph pool of ~35 GB beside a
    # trainer's eager steps, and the child's exit hands all of it back for
    # the phases after this one. This process's cache goes back first
    held = release_cache("the train worker")
    checks = run_train_worker(Path(tmp.name))

    # (f) --precompile from a cold build directory, then warm
    precompile = precompile_check(data, Path(tmp.name))
    tmp.cleanup()
    return {"wall_s": wall, "losses": losses, "resume_wall_s": r_wall, "drives": drives, "vs_float64": errors,
            "tf32_control_vs_float64": control, "held_before_worker": held, **checks, "precompile": precompile}


def train_trainer(sched, pyramid, work, folder, batch=TRAIN_BATCH, seed=0, **cfg):
    """Phase 8's trainer on the card: dim 160, the JAX CLI's training
    defaults but the batch (and the ``TrainConfig`` fields in ``cfg``),
    results under ``work / folder``."""
    from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    return MultiscaleTrainer(SinDDMNet(dim=DIM, device="cuda"), sched, pyramid,
                             TrainConfig(train_batch_size=batch, **cfg), DiffusionConfig(), Path(work) / folder,
                             seed=seed, device="cuda")


def release_cache(what: str) -> dict:
    """Hand this process's cached device memory back before ``what``: the
    free blocks and cuBLAS's workspaces. cuBLAS keeps one workspace for
    each stream and thread for the life of the process, and the segment a
    workspace was cut from cannot be freed, so a train step's backward can
    leave GBs reserved that no tensor uses. Prints and returns what this
    process still holds."""
    torch.cuda.synchronize()
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    held = {"reserved_GB": torch.cuda.memory_reserved() / 1e9, "allocated_GB": torch.cuda.memory_allocated() / 1e9,
            "graph_pool_GB": graph_pool_gb(), "card_free_GB": torch.cuda.mem_get_info()[0] / 1e9}
    say(f"[memory] before {what} this process holds {held['reserved_GB']:.2f} GB ({held['allocated_GB']:.2f} "
        f"allocated, {held['graph_pool_GB']:.2f} in graph pools); the card has {held['card_free_GB']:.2f} GB free")
    return held


def run_train_worker(work) -> dict:
    """Phase 8 (b)-(e) in ``chip_smoke.py --train-worker WORK``: its lines
    print here; it fails the phase by exiting non-zero; its numbers come
    back in ``WORK/train_worker.json``."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train-worker", str(work)],
                              cwd=ROOT, timeout=900)
    except subprocess.TimeoutExpired:
        fail("phase 8's train worker ran past 900 s")
    if proc.returncode != 0:
        fail(f"phase 8's train worker exited {proc.returncode}")
    out = json.loads((Path(work) / "train_worker.json").read_text())
    say(f"[train worker] (b)-(e) in {time.perf_counter() - t0:.1f} s")
    return out


def train_worker(argv) -> None:
    """``chip_smoke.py --train-worker WORK``: phase 8's graph checks on the
    seeded synthetic image written into WORK, with phase 8's TF32 setting
    (on, so the trainer's own scope keeps fp32): (b) the graph chunks
    against the eager chunks, (d) the step times, (c) the padded step
    against the true-shape step, (e) a graph run's checkpoint resumed; the
    numbers into WORK/train_worker.json. One trainer at a time on the card,
    each dropped before the next is made."""
    work = Path(argv[0])
    sys.path.insert(0, str(ROOT))
    from sinddm_tpu_torch.pyramid import build_pyramid
    from sinddm_tpu_torch.schedules import make_schedules

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    pyramid = build_pyramid(str(synthetic_image(work)))
    n = pyramid.n_scales
    sched = make_schedules(timesteps=100, scale_losses=pyramid.rescale_losses, n_scales=n, device="cuda")
    sizes_hw = [tuple(hw) for hw in pyramid.sizes_hw]

    new_trainer = functools.partial(train_trainer, sched, pyramid, work)

    def release():
        torch.cuda.synchronize()
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()  # see release_cache
        torch.cuda.empty_cache()

    # (b) the graph trainer's steps, then (d) the step times on it (the three
    # executors on one trainer run the same cuDNN plans); then the eager
    # trainer's same steps from the same seed, held against them. One
    # trainer at a time: the graphs' pool is ~35 GB
    plan = graph_plan(n)
    graph_tr = new_trainer("graph", sched_milestones=GRAPH_CHECK_MILESTONES)
    lr = float(graph_tr.opt.param_groups[0]["lr"])
    torch.cuda.reset_peak_memory_stats()
    graph_run = run_plan(graph_tr, plan, sizes_hw)
    pool = {"graphs": len(graph_tr._graphs), "graph_pool_GB": graph_pool_gb(),
            "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
            "capture_s": {"/".join(map(str, k)): v for k, v in graph_tr.capture_seconds.items()}}
    say(f"[train graphs] capture seconds (synchronize, gc, the step's host work, instantiate) {pool['capture_s']}")
    say(f"[train graphs] {pool['graphs']} graphs alive (five scales, the canvas) in one pool of "
        f"{pool['graph_pool_GB']:.2f} GB; peak allocated {pool['peak_allocated_GB']:.2f} GB (the per-step "
        f"path's finest step: 27.67 GB, PERF.md)")
    out = train_step_times(graph_tr, n, sizes_hw)
    del graph_tr
    release()
    eager_tr = new_trainer("eager", sched_milestones=GRAPH_CHECK_MILESTONES)
    eager_tr.use_graphs = False
    eager_run = run_plan(eager_tr, plan, sizes_hw)
    del eager_tr
    release()
    out["graph_vs_eager"] = graph_vs_eager(graph_run, eager_run, n, sizes_hw, lr) | pool
    out["graph_fault_controls"] = graph_fault_controls(new_trainer, plan, eager_run, n, sizes_hw, lr, release)
    # (c) the padded step against the true-shape step on the same draws
    out["padded_vs_true_shape"] = padded_vs_true_shape(new_trainer, n, sizes_hw)
    release()
    # (e) a graph run's checkpoint resumed, on the card and through the CPU
    out["graph_resume"] = graph_resume(new_trainer, n, release)
    (work / "train_worker.json").write_text(json.dumps(out, default=str))


def plant_graph_fault(tr, fault: str) -> None:
    """Plant ``fault`` in the captures of graph trainer ``tr``, a control of
    the graph-vs-eager bounds: ``unzeroed``, the graph does not zero the
    gradients (each replay adds to the last step's); ``baked_lr``, the
    learning rate is a number at capture (the replays keep it past a
    milestone); ``unregistered``, the device generator is not registered
    with the graph."""
    capture, graph_cls = tr._capture, torch.cuda.CUDAGraph

    class Unregistered(graph_cls):
        def register_generator_state(self, generator):
            pass

    def planted(step_fn):
        group = tr.opt.param_groups[0]
        lr = group["lr"]
        if fault == "unzeroed":
            tr.opt.zero_grad = lambda set_to_none=True: None
        elif fault == "baked_lr":
            group["lr"] = float(lr)
        elif fault == "unregistered":
            torch.cuda.CUDAGraph = Unregistered
        else:
            raise ValueError(f"no fault {fault!r}")
        try:
            return capture(step_fn)
        finally:
            tr.opt.__dict__.pop("zero_grad", None)
            group["lr"] = lr
            torch.cuda.CUDAGraph = graph_cls

    tr._capture = planted


def graph_fault_controls(new_trainer, plan, eager_run, n, sizes_hw, lr, release) -> dict:
    """Phase 8 (b)'s controls: its grouped steps (the lr milestone inside
    the replays) on a graph trainer with each of GRAPH_FAULTS planted in its
    captures, against the eager run. Each must break GRAPH_LOSS_TOL, the
    parameter bound or the equal draws, or fail to capture."""
    grouped = [step for step in plan if step[0] != "padded"]
    out = {}
    for fault in GRAPH_FAULTS:
        tr = new_trainer("fault", sched_milestones=GRAPH_CHECK_MILESTONES)
        plant_graph_fault(tr, fault)
        try:
            run = run_plan(tr, grouped, sizes_hw)
        except RuntimeError as e:
            r = {"raised": str(e).strip().splitlines()[0][:160]}
            caught = True
            shown = f"the capture raised: {r['raised']}"
        else:
            pairs = [(g, e) for s in range(n) for g, e in zip(run["rows"][s], eager_run["rows"][s])]
            off = torch.cat([((g - e).abs() / lr).flatten()
                             for g, e in zip(run["params"]["grouped"], eager_run["params"]["grouped"])])
            r = {"loss_rel": max(abs(g[0] - e[0]) / abs(e[0]) for g, e in pairs),
                 "draws_equal": all(torch.equal(g[1], e[1]) and torch.equal(g[2], e[2]) for g, e in pairs),
                 "param_share": share_over(off, 1e-2), "param_max_lr": off.max().item()}
            caught = (r["loss_rel"] > GRAPH_LOSS_TOL or r["param_share"] > TRAIN_UPDATE_SHARE
                      or not r["draws_equal"])
            shown = (f"largest loss rel {r['loss_rel']:.3e} (bound {GRAPH_LOSS_TOL:g}), parameters share over "
                     f"1e-2 lr {r['param_share']:.3e} (bound {TRAIN_UPDATE_SHARE:g}), largest "
                     f"{r['param_max_lr']:.3e} lr, draws equal {r['draws_equal']}")
        say(f"[check train graph vs eager, control: {fault} planted in the captures] {shown} "
            f"{'caught' if caught else 'FAIL: within every bound'}")
        if not caught:
            fail(f"a graph trainer with {fault} planted passes the graph-vs-eager bounds")
        out[fault] = r
        del tr
        release()
    return out


def record_draws(store):
    """Patch the port's draw functions (``training_draws``, ``canvas_draws``)
    to keep what the last call of each function at each noise shape
    returned in ``store[(name, shape)]``; returns the undo. A captured
    step's draws are its graph's tensors, which each replay rewrites."""
    from sinddm_tpu_torch.diffusion import core

    originals = {name: getattr(core, name) for name in ("training_draws", "canvas_draws")}

    def wrap(name, fn):
        def recorded(*args, **kw):
            t, noise = fn(*args, **kw)
            store[(name, tuple(noise.shape))] = (t, noise)
            return t, noise
        return recorded

    for name, fn in originals.items():
        setattr(core, name, wrap(name, fn))
    return lambda: [setattr(core, name, fn) for name, fn in originals.items()]


@torch.no_grad()  # no autograd graph on a trainer's parameters: it would break that trainer's next capture
def params_off_in_lr(a, b, lr) -> torch.Tensor:
    """|a - b| / lr over every parameter of two models, flattened."""
    return torch.cat([((p - q).abs() / lr).flatten() for p, q in zip(a.parameters(), b.parameters())])


def graph_pool_gb() -> float:
    """GB of the caching allocator's segments outside its default pool: the
    CUDA graphs' private pools."""
    segments = torch.cuda.memory._snapshot()["segments"]
    return sum(seg["total_size"] for seg in segments if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def graph_plan(n) -> list:
    """Phase 8 (b)'s steps, (scale or "padded", count): GRAPH_WARMUP_STEPS at
    every scale (the warm-up), GRAPH_CHECK_STEPS - GRAPH_WARMUP_STEPS more
    at every scale (a graph trainer captures the five scales' graphs, the
    largest first, and replays them), then GRAPH_CHECK_STEPS padded steps
    (warm-up, the canvas's capture, replays)."""
    from sinddm_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS

    return ([(s, GRAPH_WARMUP_STEPS) for s in range(n)]
            + [(s, GRAPH_CHECK_STEPS - GRAPH_WARMUP_STEPS) for s in range(n)] + [("padded", GRAPH_CHECK_STEPS)])


def run_plan(tr, plan, sizes_hw) -> dict:
    """``plan``'s steps on trainer ``tr``, one a call: each step's loss and
    draws (t, the noise; copied to the host) and the parameters after the
    grouped and after the padded steps."""
    store = {}
    rows = collections.defaultdict(list)
    params = {}
    for i, (s, k) in enumerate(plan):
        h, w = sizes_hw[-1 if s == "padded" else s]
        key = ("canvas_draws" if s == "padded" else "training_draws", (TRAIN_BATCH, h, w, 3))
        for _ in range(k):
            undo = record_draws(store)
            try:
                loss = torch.from_numpy(tr.train_chunk(1))[0] if s == "padded" else tr.train_scale(s, 1)[0]
            finally:
                undo()
            t, noise = store[key]  # a captured step's are its graph's tensors, this replay's draws
            rows[s].append((loss.item(), t.cpu(), noise.cpu()))
        if i in (len(plan) - 2, len(plan) - 1):  # the grouped steps, then the padded ones, done
            params["padded" if s == "padded" else "grouped"] = [p.detach().cpu().clone() for p in tr.model.parameters()]
    return {"rows": rows, "params": params, "scales": list(tr.running_scale),
            "captured": sorted("/".join(map(str, k)) for k in tr._graphs)}


def graph_vs_eager(graph_run, eager_run, n, sizes_hw, lr) -> dict:
    """Phase 8 (b): the graph trainer's run of ``graph_plan`` against an
    eager trainer's from the same seed: each step's loss (relative error)
    and draws (t, the noise and, padded, the scale: equal), and the
    parameters after the grouped and after the padded steps."""
    from sinddm_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS

    out = {"steps": GRAPH_CHECK_STEPS, "warmup_steps": GRAPH_WARMUP_STEPS, "scales": {},
           "captured": graph_run["captured"]}
    scales_equal = graph_run["scales"] == eager_run["scales"]
    all_ok = scales_equal
    for s in list(range(n)) + ["padded"]:
        pairs = list(zip(graph_run["rows"][s], eager_run["rows"][s]))
        r = {"loss_rel": [abs(g[0] - e[0]) / abs(e[0]) for g, e in pairs],
             "t_diff": max((g[1] - e[1]).abs().max().item() for g, e in pairs),
             "noise_diff": max((g[2] - e[2]).abs().max().item() for g, e in pairs),
             "captured": ("canvas" if s == "padded" else f"scale/{s}") in graph_run["captured"]}
        ok = r["captured"] and r["t_diff"] == 0 and r["noise_diff"] == 0 and max(r["loss_rel"]) <= GRAPH_LOSS_TOL
        all_ok &= ok
        where = f"s={s} {sizes_hw[s]}" if s != "padded" else f"padded canvas {sizes_hw[-1]}"
        say(f"[check train graph vs eager {where} batch {TRAIN_BATCH}, {GRAPH_CHECK_STEPS} steps, the first "
            f"{GRAPH_WARMUP_STEPS} eager warm-up] loss rel per step {[f'{v:.2e}' for v in r['loss_rel']]} "
            f"(<= {GRAPH_LOSS_TOL:g}) max |t diff| {r['t_diff']} max |noise diff| {r['noise_diff']:.3e} (== 0) "
            f"graph captured {r['captured']} {'ok' if ok else 'FAIL'}")
        out["scales"][str(s)] = r
    for name in ("grouped", "padded"):
        off = torch.cat([((g - e).abs() / lr).flatten()
                         for g, e in zip(graph_run["params"][name], eager_run["params"][name])])
        p = {"max_lr": off.max().item(), "share": share_over(off, 1e-2)}
        ok = p["share"] <= TRAIN_UPDATE_SHARE
        all_ok &= ok
        say(f"[check train graph vs eager parameters after the {name} steps] max diff {p['max_lr']:.3e} lr, share "
            f"over 1e-2 lr {p['share']:.3e} (<= {TRAIN_UPDATE_SHARE:g}); scales visited equal {scales_equal} "
            f"{'ok' if ok else 'FAIL'}")
        out[f"params_after_{name}"] = p
    if not all_ok:
        fail("a graph chunk disagrees with the eager chunk")
    return out


def padded_vs_true_shape(new_trainer, n, sizes_hw) -> dict:
    """Phase 8 (c): at each scale one padded step (the scale a device
    tensor, the canvas in the mask mode) against one true-shape step from
    the same parameters, on the canvas draws' valid region, at batch
    TRAIN_CHECK_BATCH: the loss's relative error and the largest gradient
    error over the largest gradient."""
    padded, true_shape = new_trainer("padded_check", batch=TRAIN_CHECK_BATCH), new_trainer(
        "true_check", batch=TRAIN_CHECK_BATCH)
    start = {k: v.clone() for k, v in padded.model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    hm, wm = sizes_hw[-1]
    out = {}
    for s in range(n):
        h, w = sizes_hw[s]
        padded.model.load_state_dict(start)
        true_shape.model.load_state_dict(start)
        t = torch.randint(0, 100, (TRAIN_CHECK_BATCH,), generator=gen, device="cuda")
        noise = torch.randn((TRAIN_CHECK_BATCH, hm, wm, 3), generator=gen, device="cuda")
        loss_p, _ = padded._step(torch.tensor(s, device="cuda"), t=[t], noise=[noise])
        loss_t, _ = true_shape._step(s, t=[t], noise=[noise[:, :h, :w].contiguous()])
        g_max = max(p.grad.abs().max().item() for p in true_shape.model.parameters())
        g_err = max((p.grad - q.grad).abs().max().item()
                    for p, q in zip(padded.model.parameters(), true_shape.model.parameters()))
        r = {"loss_rel": abs(loss_p.item() - loss_t.item()) / abs(loss_t.item()), "grad_rel": g_err / g_max}
        ok = r["loss_rel"] <= TRAIN_LOSS_TOL and r["grad_rel"] <= TRAIN_GRAD_TOL
        say(f"[check train padded vs true shape s={s} {h}x{w} on the {hm}x{wm} canvas, batch {TRAIN_CHECK_BATCH}] "
            f"loss rel {r['loss_rel']:.3e} (<= {TRAIN_LOSS_TOL:g}) max|dg|/max|g| {r['grad_rel']:.3e} "
            f"(<= {TRAIN_GRAD_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the padded step at s={s} disagrees with the true-shape step")
        out[s] = r
    return out


def train_step_times(graph_tr, n, sizes_hw) -> dict:
    """Phase 8 (d): ms a step at every scale, batch TRAIN_BATCH (CUDA
    events), all on the one trainer whose graphs (b) captured, so that the
    three run the same cuDNN plans: ``train_step`` (one step a call, the loss
    fetched each), an eager chunk (``train_scale`` with ``use_graphs`` off)
    and graph replays; the peak memory of a per-step step; profiles of
    TRAIN_PROFILE_STEPS steps at the coarsest and the finest scale, per
    step against graph replays (device busy time, idle share, kernels a
    step), and the finest per-step step by kernel group."""
    from sinddm_tpu_torch.utils.flops import denoiser_flops_per_pixel

    def eager_chunk(s, k):
        graph_tr.use_graphs = False
        try:
            graph_tr.train_scale(s, k)
        finally:
            graph_tr.use_graphs = True

    ms = {"per_step": {}, "eager_chunk": {}, "graph": {}}
    peak_gb = {}
    for s in range(n):
        graph_tr.train_step(s=s)
        torch.cuda.reset_peak_memory_stats()
        ms["per_step"][s] = time_ms(lambda: graph_tr.train_step(s=s), reps=TRAIN_TIME_STEPS, warm=1)
        peak_gb[s] = torch.cuda.max_memory_allocated() / 1e9
        ms["eager_chunk"][s] = time_ms(lambda: eager_chunk(s, TRAIN_TIME_STEPS), reps=1, warm=0) / TRAIN_TIME_STEPS
        ms["graph"][s] = time_ms(lambda: graph_tr.train_scale(s, TRAIN_TIME_STEPS), reps=1, warm=0) / TRAIN_TIME_STEPS
        h, w = sizes_hw[s]
        flops = 3 * TRAIN_BATCH * h * w * denoiser_flops_per_pixel(DIM)
        say(f"[time train step s={s} {h}x{w} batch {TRAIN_BATCH} fp32, TF32 off] ms per step {ms['per_step'][s]:.2f} "
            f"eager chunk {ms['eager_chunk'][s]:.2f} graph replay {ms['graph'][s]:.2f} "
            f"(graph / per step {ms['graph'][s] / ms['per_step'][s]:.4f}) peak_GB {peak_gb[s]:.2f} TFLOP "
            f"{flops / 1e12:.3f} (3x the forward's) TFLOP/s per step {flops / ms['per_step'][s] / 1e9:.2f} graph "
            f"{flops / ms['graph'][s] / 1e9:.2f}")
    mean = {k: sum(v.values()) / n for k, v in ms.items()}
    say(f"[time train step] mean over the uniform scale draw: per step {mean['per_step']:.2f} ms, eager chunk "
        f"{mean['eager_chunk']:.2f} ms, graph replay {mean['graph']:.2f} ms")
    profiles = {}
    for s in (0, n - 1):
        for name, run in (("per_step", lambda: [graph_tr.train_step(s=s) for _ in range(TRAIN_PROFILE_STEPS)]),
                          ("graph", lambda: graph_tr.train_scale(s, TRAIN_PROFILE_STEPS))):
            prof = profile_walk(run)
            if prof is None:
                say(f"[profile train {name} s={s}] torch.profiler recorded no device activity: not measured")
                continue
            by_name, busy, window = prof
            kernels = sum(c for _, c in by_name.values()) / TRAIN_PROFILE_STEPS
            profiles[f"{name}_s{s}"] = {"busy_ms_per_step": busy / 1e3 / TRAIN_PROFILE_STEPS,
                                        "idle_share": 1 - busy / window, "kernels_per_step": kernels}
            say(f"[profile train {name} s={s} {sizes_hw[s]}] {TRAIN_PROFILE_STEPS} steps: device busy_ms a step "
                f"{busy / 1e3 / TRAIN_PROFILE_STEPS:.2f} window_ms {window / 1e3:.2f} idle_share "
                f"{1 - busy / window:.4f} kernels a step {kernels:.1f}")
    groups = profile_train_step(lambda: graph_tr.train_step(s=n - 1))
    return {"step_ms": ms["per_step"], "mean_step_ms": mean["per_step"], "eager_chunk_step_ms": ms["eager_chunk"],
            "graph_step_ms": ms["graph"], "mean_step_ms_by_executor": mean, "peak_GB": peak_gb,
            "step_profiles": profiles, "finest_step_profile_ms": groups}


def graph_resume(new_trainer, n, release) -> dict:
    """Phase 8 (e): a graph trainer's chunk, a checkpoint, another chunk; a
    new graph trainer loads the checkpoint and runs that chunk: the same
    scales, the losses within GRAPH_LOSS_TOL; the checkpoint through a CPU
    trainer (loaded, saved again) and back onto the card keeps the
    parameters, Adam's state and the scale order."""
    import numpy as np

    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    first = new_trainer("resume")
    first.train_chunk_grouped(2 * n)
    path = first.save(1)
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    losses = first.train_chunk_grouped(2 * n)
    scales, pyramid, cfg, diff_cfg, folder = (first.running_scale, first.pyramid, first.cfg, first.diff_cfg,
                                              first.results_folder)
    del first
    release()
    resumed = new_trainer("resume_b", seed=3)
    resumed.load_path(path)
    again = resumed.train_chunk_grouped(2 * n)
    rel = float(np.max(np.abs(again - losses) / np.abs(losses)))
    same = resumed.running_scale == scales
    del resumed
    release()
    cpu_sched = make_schedules(timesteps=100, scale_losses=pyramid.rescale_losses, n_scales=n, device="cpu")
    cpu = MultiscaleTrainer(SinDDMNet(dim=DIM, device="cpu"), cpu_sched, pyramid, cfg, diff_cfg, folder / "cpu",
                            seed=4, device="cpu")
    cpu.load_path(path)
    back_path = cpu.save(1)
    back = new_trainer("resume_c", seed=5)
    back.load_path(back_path)
    params_equal = all(torch.equal(back.model.state_dict()[k], v) for k, v in saved.items())
    adam_equal = all(torch.equal(back.opt.state[p]["exp_avg_sq"].cpu(), cpu.opt.state[q]["exp_avg_sq"])
                     for p, q in zip(back.model.parameters(), cpu.model.parameters()))
    back.train_chunk_grouped(2 * n)
    back_same = back.running_scale == scales
    ok = rel <= GRAPH_LOSS_TOL and same and params_equal and adam_equal and back_same
    say(f"[check train resume] a graph run's chunk after its checkpoint, resumed by a new graph trainer: scales "
        f"equal {same}, loss rel {rel:.3e} (<= {GRAPH_LOSS_TOL:g}); through a CPU trainer and back: parameters "
        f"equal {params_equal}, Adam's state equal {adam_equal}, scales equal {back_same} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("a graph run's checkpoint did not resume the same chunks")
    return {"loss_rel": rel, "scales_equal": same, "cpu_round_trip": params_equal and adam_equal and back_same}


def precompile_check(data, work) -> dict:
    """Phase 8 (f): ``--mode sample --precompile`` at batch 2 with the build
    directory pointed at an empty folder (a cold build of every kernel, all
    nvcc jobs at once), then again (warm)."""
    from sinddm_tpu_torch.ops import _build

    argv = ["--mode", "sample", "--precompile", "--dataset_folder", str(data), "--image_name", "synthetic.png",
            "--results_folder", str(work / "precompile"), "--dim", str(DIM), "--sample_batch_size", "2"]
    saved_dir = _build.BUILD_DIR
    _build.BUILD_DIR = work / "kernels_cold"
    out = {}
    try:
        for what in ("cold", "warm"):
            _, wall, _, text = run_cli(f"precompile {what}", argv)
            found = re.findall(r"^precompile: built the CUDA kernels in (\S+) s", text, re.M)
            if not found:
                fail(f"--precompile ({what}) printed no build time")
            out[what] = {"build_s": float(found[0]), "wall_s": wall}
        built = sorted(p.name.split("-")[0] for p in _build.BUILD_DIR.glob("*.so"))
    finally:
        _build.BUILD_DIR = saved_dir
    say(f"[precompile] --mode sample --precompile batch 2: cold build_s {out['cold']['build_s']:.2f} (wall_s "
        f"{out['cold']['wall_s']:.2f}), warm build_s {out['warm']['build_s']:.2f} (wall_s {out['warm']['wall_s']:.2f}); "
        f"libraries built {built}")
    if built != sorted(_build.KERNELS) or out["warm"]["build_s"] >= out["cold"]["build_s"]:
        fail(f"--precompile built {built}, cold {out['cold']} warm {out['warm']}")
    return out


def profile_train_step(run):
    """Device time of one train step by kernel (torch.profiler), grouped:
    cuDNN's convolutions (with their FFT and layout kernels) and cuBLAS's
    products, forward and backward; the rest."""
    prof = profile_walk(run)
    if prof is None:
        say("[profile train] torch.profiler recorded no device activity: breakdown not measured")
        return None
    by_name, busy, window = prof
    say(f"[profile train] one step at the finest scale: device busy_ms {busy / 1e3:.1f} kernel-window_ms "
        f"{window / 1e3:.1f} idle_share {1 - busy / window:.4f} kernels {sum(n for _, n in by_name.values())}")
    groups = collections.Counter()
    for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        low = kname.lower()
        g = ("convolutions and matrix products (cuDNN, cuBLAS)"
             if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "winograd", "dgrad", "wgrad", "fprop",
                                       "cutlass", "sm90", "gemm", "nvjet", "fft", "complex"))
             else "elementwise, reductions, Adam")
        groups[g] += us / 1e3
    for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        say(f"[profile train] {us / busy:7.2%} {us / 1e3:10.2f} ms {n:5d}x {kname[:110]}")
    for g, ms in groups.items():
        say(f"[profile train] group {g}: {ms:.2f} ms ({ms * 1e3 / busy:.2%})")
    return dict(groups) | {"busy_ms": busy / 1e3, "idle_share": 1 - busy / window}


def guided_walk(model, sched, pyramid, clip_model, batch, seed, mode_cfg, *, bucketed,
                warp_impl=None, custom_t_list=None, record=None, replay=None, sharding=None):
    """One guided walk (``clip_sampling``) at ``batch`` from a generator seeded
    with ``seed``; with ``record`` (an empty list) its noise and loss draws are
    kept there, with ``replay`` (such a list) they are taken from it; split
    over a mesh with ``sharding``. Returns (outputs, aux, wall seconds ending
    in a synchronize)."""
    from sinddm_tpu_torch.apps.clip_apps import clip_sampling
    from sinddm_tpu_torch.guidance import clip_extractor as ce

    g = torch.Generator(device="cuda").manual_seed(seed)
    ex = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, generator=g, warp_impl=warp_impl)
    kw = {}
    if record is not None:
        noise, draws = [], []
        kw["noise_fn"] = lambda shape: noise.append(torch.randn(shape, generator=g, device="cuda")) or noise[-1]
        kw["draw_fn"] = lambda b, k: draws.append(ex.draw(b, k)) or draws[-1]
        record.extend([noise, draws])
    if replay is not None:
        noise, draws = list(replay[0]), list(replay[1])
        kw["noise_fn"] = lambda shape: noise.pop(0)
        kw["draw_fn"] = lambda b, k: draws.pop(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, aux = clip_sampling(model, sched, pyramid, ex, sample_batch_size=batch, stop_guidance=STOP_GUIDANCE,
                              reblurring=False, bucketed=bucketed, custom_t_list=custom_t_list,
                              generator=g, sharding=sharding, device="cuda", **mode_cfg, **kw)
    torch.cuda.synchronize()
    return outs, aux, time.perf_counter() - t0


def walk_stats(ours, theirs, start=None, scale=-1) -> dict:
    """The guided checks of a walk against another: at ``scale`` (the finest)
    the share of elements over 0.1 and the least per-sample cosine of the two
    outputs (of their updates ``out - start`` when ``start`` is given); the
    largest relative difference of the clip-score traces over every guided
    scale."""
    (outs_a, aux_a, _), (outs_b, aux_b, _) = ours, theirs
    a, b = outs_a[scale], outs_b[scale]
    if start is not None:
        a, b = a - start, b - start
    fa, fb = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    cos = ((fa * fb).sum(1) / (fa.norm(dim=1) * fb.norm(dim=1))).min().item()
    score = 0.0
    for p, q in zip(aux_a, aux_b):
        if isinstance(p, dict) and p.get("n_guided"):
            sp, sq = p["clip_score"][: p["n_guided"]], q["clip_score"][: q["n_guided"]]
            score = max(score, ((sp - sq).abs() / sq.abs()).max().item())
    return {"share_over_0.1": share_over((outs_a[scale] - outs_b[scale]).abs(), 0.1), "cosine": cos,
            "score_rel": score}


def bucketed_phase(model, sched, pyramid, clip_model, mode_cfg, per_scale) -> dict:
    """Phase 10: the bucketed guided walk (``--bucketed_guidance``) and the
    modules of its slice on the card. ``per_scale`` is phase 6's record of
    the per-scale walk: its wall, n_guided and launches."""
    from sinddm_tpu_torch import metrics as tm
    from sinddm_tpu_torch.apps.clip_apps import clip_mode_config
    from sinddm_tpu_torch.diffusion.bucketed import place_on_canvas, sample_via_scale_bucketed
    from sinddm_tpu_torch.guidance import clip_extractor as ce, clip_guidance as cg
    from sinddm_tpu_torch.models import inception as ti
    from sinddm_tpu_torch.models.clip.convert import random_clip_params
    from sinddm_tpu_torch.models.clip.model import VIT_B_32
    from sinddm_tpu_torch.ops import conv_block as cb, dw_conv as dw, warp_sample as ws
    from sinddm_tpu_torch.pyramid import Pyramid

    n = pyramid.n_scales
    sizes_hw = list(pyramid.sizes_hw)
    h_fin, w_fin = sizes_hw[-1]
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}

    # the valid-mask denoiser call: a 133x177 region of a 16x186x248 canvas
    # through kernels 1-2 (the stage entries, the mask applied between the
    # launches), against the plain block in the mask mode and the valid crop
    vh, vw = MASK_VALID_HW
    with torch.no_grad():
        x = torch.randn((BATCH, h_fin, w_fin, 3), generator=gen, device="cuda")
        t = torch.full((BATCH,), 10, dtype=torch.long, device="cuda")
        mask = torch.zeros((BATCH, h_fin, w_fin), device="cuda")
        mask[:, :vh, :vw] = 1.0
        cb.launches = dw.launches = 0
        out_mask = model(x, t, 4.0, mask=mask)
        torch.cuda.synchronize()
        m_launches = {"conv_block": cb.launches, "dw_conv": dw.launches}
        out_plain = model.run(x, t, 4.0, cb.conv_block_reference, mask)
        out_crop = model(x[:, :vh, :vw].contiguous(), t, 4.0)
        torch.cuda.synchronize()
    _, _, rel_crop = err_stats(out_mask[:, :vh, :vw], out_crop)
    _, _, rel_plain = err_stats(out_mask, out_plain)
    outside = max(out_mask[:, vh:].abs().max().item(), out_mask[:, :, vw:].abs().max().item())
    ms = {k: time_ms(fn, 5) for k, fn in (("mask", lambda: model(x, t, 4.0, mask=mask)),
                                           ("crop", lambda: model(x[:, :vh, :vw].contiguous(), t, 4.0)),
                                           ("full", lambda: model(x, t, 4.0)))}
    ok = rel_crop <= 1e-4 and rel_plain <= 1e-4 and outside == 0.0 and m_launches == {
        "conv_block": 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": 4}
    say(f"[check denoiser mask mode {BATCH}x{h_fin}x{w_fin} valid {vh}x{vw}] vs the crop rel {rel_crop:.3e}, vs the "
        f"plain mask mode rel {rel_plain:.3e} (<= 1e-4 * max|plain|), max |out| outside {outside} (0), launches "
        f"{m_launches}; ms mask {ms['mask']:.3f} crop {ms['crop']:.3f} full canvas {ms['full']:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the denoiser's mask mode through the kernels disagrees with the crop or the plain mask mode")
    out["mask_call"] = {"rel_crop": rel_crop, "rel_plain": rel_plain, **{f"{k}_ms": v for k, v in ms.items()}}
    del x, mask, out_mask, out_plain, out_crop

    # the bucketed clip_content walk at batch 16, as phase 6 ran the per-scale one
    cb.launches = dw.launches = 0
    ws.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    outs, aux, wall = guided_walk(model, sched, pyramid, clip_model, BATCH, 0, mode_cfg, bucketed=True)
    launches = {"conv_block": cb.launches, "dw_conv": dw.launches, **ws.launches}
    n_guided = tuple(0 if a is None else a["n_guided"] for a in aux)
    say(f"[bucketed walk] clip_content batch {BATCH} on the {h_fin}x{w_fin} canvas: n_guided {list(n_guided)} "
        f"wall_s {wall:.3f} beside the per-scale walk's {per_scale['wall_s']:.3f} (phase 6, this run; "
        f"{wall / per_scale['wall_s']:.4f}x) peak_GB {torch.cuda.max_memory_allocated() / 1e9:.2f} launches {launches}")
    if n_guided != per_scale["n_guided"]:
        fail(f"bucketed n_guided {n_guided} != the per-scale walk's {per_scale['n_guided']}")
    if launches != per_scale["launches"] or not all(launches[k] for k in ("conv_block", "dw_conv", "winx_fwd",
                                                                           "win_bwd")):
        fail(f"bucketed launch counts {launches} != the per-scale walk's {per_scale['launches']}")
    for o, a, n_g, (h, w) in zip(outs, aux, n_guided, sizes_hw):
        if tuple(o.shape) != (BATCH, h, w, 3) or not bool(torch.isfinite(o).all()) or o.abs().max().item() > 1.0:
            fail(f"bucketed output at {h}x{w}: shape {tuple(o.shape)}, non-finite values or outside [-1, 1]")
        if a is not None:
            sc = a["clip_score"]
            if not (bool(torch.isfinite(sc).all()) and bool((sc[:n_g] != 0).all()) and not bool(sc[n_g:].any())):
                fail(f"bucketed clip_score at {h}x{w}: the first {n_g} rows must be scores, the rest zeros")
    finest = outs[-1]
    del outs, aux
    # the per-scale walk once more, warm as the bucketed one was (phase 6's is
    # the first guided walk of the run)
    _, _, again = guided_walk(model, sched, pyramid, clip_model, BATCH, 0, mode_cfg, bucketed=False)
    say(f"[bucketed walk] wall_s bucketed {wall:.3f}, per-scale {again:.3f} right after it, per-scale "
        f"{per_scale['wall_s']:.3f} in phase 6 ({wall / again:.4f}x the walk after it)")
    out.update(wall_s=wall, per_scale_wall_s=per_scale["wall_s"], per_scale_after_s=again, launches=launches)

    # clip_style_trans at batch 2: its one denoised scale is the canvas, so the
    # bucketed walk is the per-scale walk's process; the same draws in both.
    # The adjoint's atomics reorder run to run, so the walks are held with
    # the guided checks, beside a second per-scale walk on the same draws and
    # a control on other draws, which must break them
    images = tuple((torch.rand((h, w, 3), generator=gen, device="cuda") * 2 - 1).cpu().numpy() for h, w in sizes_hw)
    pyr = Pyramid(sizes_hw=pyramid.sizes_hw, sizes_wh=pyramid.sizes_wh, images=images, recon_images=(),
                  rescale_losses=pyramid.rescale_losses, scale_factor=pyramid.scale_factor, n_scales=n)
    st_cfg = clip_mode_config("clip_style_trans", "Fire in the Forest", None, None, n)
    start = F.interpolate(torch.as_tensor(images[n - 2], device="cuda").permute(2, 0, 1)[None], size=(h_fin, w_fin),
                          mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    rec = []
    st = dict(model=model, sched=sched, pyramid=pyr, clip_model=clip_model, batch=2, mode_cfg=st_cfg)
    ref = guided_walk(seed=20, bucketed=False, record=rec, **st)
    runs = {"bucketed": guided_walk(seed=20, bucketed=True, replay=rec, **st),
            "per-scale again": guided_walk(seed=20, bucketed=False, replay=rec, **st),
            "control, other draws": guided_walk(seed=21, bucketed=True, **st)}
    stats = {k: walk_stats(v, ref, start) for k, v in runs.items()}
    held = lambda r: (r["share_over_0.1"] <= WALK_SHARE and r["cosine"] >= WALK_COS  # noqa: E731
                      and r["score_rel"] <= WALK_SCORE_REL)
    for k, r in stats.items():
        say(f"[check clip_style_trans batch 2, {k} vs per-scale] finest share over 0.1 {r['share_over_0.1']:.4f} "
            f"(<= {WALK_SHARE}) update cosine, least of a sample {r['cosine']:.6f} (>= {WALK_COS}) clip score "
            f"relative {r['score_rel']:.3e} (<= {WALK_SCORE_REL}) {'held' if held(r) else 'not held'}")
    if not (held(stats["bucketed"]) and held(stats["per-scale again"])) or held(stats["control, other draws"]):
        fail("bucketed clip_style_trans: the walk on the same draws is off the per-scale walk, or the control on "
             "other draws is not")
    out["style_trans"] = stats

    # the via scales below the finest, where the valid region is smaller than
    # the canvas. (a) The unguided bucketed via scales at batch 2 from one
    # scale-0 image: the denoiser on each valid crop through kernels 1-2
    # against the plain block, on the same draws
    plain_fn = lambda x, t, s: model.run(x, t, s, cb.conv_block_reference)  # noqa: E731
    x0 = torch.rand((2,) + tuple(sizes_hw[0]) + (3,), generator=gen, device="cuda") * 2 - 1
    t_list = [int(v) for v in sched.num_timesteps_ideal[1:]]
    chains = {}
    for path, fn in (("kernel", model), ("plain", plain_fn)):
        cb.launches = dw.launches = 0
        g = torch.Generator(device="cuda").manual_seed(40)
        prev, prev_hw, chains[path] = place_on_canvas(x0, (h_fin, w_fin)), sizes_hw[0], []
        with torch.no_grad():
            for s in range(1, n):
                prev, _, _ = sample_via_scale_bucketed(
                    fn, sched, prev, prev_valid_hw=prev_hw, cur_valid_hw=sizes_hw[s], s=s, total_t=t_list[s - 1],
                    reblurring=True, generator=g, device="cuda")
                prev_hw = sizes_hw[s]
                chains[path].append(prev)
        torch.cuda.synchronize()
        if path == "kernel":
            c_launches = {"conv_block": cb.launches, "dw_conv": dw.launches}
    calls = sum(t_list)
    errs = [(k - p).abs().max().item() for k, p in zip(chains["kernel"], chains["plain"])]
    outside = max(c[:, h:].abs().max().item() + c[:, :, w:].abs().max().item()
                  for path in chains for c, (h, w) in zip(chains[path][:-1], sizes_hw[1:-1]))
    ok = (max(errs) <= 2e-3 and outside == 0.0 and all(bool(torch.isfinite(c).all()) for c in chains["kernel"])
          and c_launches == {"conv_block": calls * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": calls * 4})
    say(f"[check unguided bucketed via scales batch 2, kernel vs plain] max_abs by scale "
        f"{' '.join(f'{h}x{w} {e:.3e}' for (h, w), e in zip(sizes_hw[1:], errs))} (atol 2e-3) max |state| outside "
        f"the valid region {outside} (0) launches {c_launches} ({calls} denoiser calls) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the bucketed via scales through the kernels disagree with the plain block")
    out["via_scales_max_abs"] = dict(zip([f"{h}x{w}" for h, w in sizes_hw[1:]], errs))
    del chains

    # (b) guidance at the 133x177 scale on the 186x248 canvas, at batch 16:
    # the views cropped from the valid region into the canvas's frame through
    # kernel 7, read past the valid edge, and the adjoint through kernel 6,
    # against the matrix-product warp on the same draws; one iteration, then
    # the first guided step (the masked quantile fixes the edit mask) and the
    # next one with that mask, held as phase 6 holds them at the finest scale
    s_v = n - 2
    vh, vw = sizes_hw[s_v]
    frame_hw = ce.resize_output_size(h_fin, w_fin)
    src = F.interpolate(finest.permute(0, 3, 1, 2), size=(vh, vw), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    x_recon = place_on_canvas(src + 0.05 * torch.randn(src.shape, generator=gen, device="cuda"), (h_fin, w_fin))
    kernel_ex = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK,
                                 generator=torch.Generator(device="cuda").manual_seed(41))
    plain_ex = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, warp_impl="mm")
    text_hr = kernel_ex.get_text_embedding(mode_cfg["text_input"], ce.get_augmentations_template("hr"))
    region = dict(valid_hw=(vh, vw), frame_hw=frame_hw)
    draws = kernel_ex.draw(BATCH, text_hr.shape[0])
    x01 = (x_recon.clamp(-1.0, 1.0) + 1.0) * 0.5
    ws.reset_launches()
    with torch.no_grad():
        loss_k, grad_k = kernel_ex.clip_loss_and_grad(x01, text_hr, draws, **region)
        torch.cuda.synchronize()
        v_launches = dict(ws.launches)
        loss_p, grad_p = plain_ex.clip_loss_and_grad(x01, text_hr, draws, **region)
        torch.cuda.synchronize()
    n_chunks = N_AUG // kernel_ex._chunk_size()
    want = {**dict.fromkeys(v_launches, 0), "winx_fwd": n_chunks, "win_bwd": n_chunks}
    ok, _, summary = iteration_check(f"check guidance iteration at {vh}x{vw} on the {h_fin}x{w_fin} canvas, frame "
                                     f"{frame_hw[0]}x{frame_hw[1]}, kernels vs mm", loss_k, grad_k, loss_p, grad_p,
                                     extra=f"launches {v_launches} ")
    if not ok or v_launches != want or ws.launches != want:
        fail(f"the guidance iteration at a via scale through kernels 6-7 disagrees with the plain warp, or its "
             f"launches {v_launches} / {dict(ws.launches)} != {want}: {summary}")
    hook_kw = dict(s=s_v, n_scales=n, sub_iters=1, strength=STRENGTH, quantile=1.0 - FILL_FACTOR, llambda=0.2,
                   stop_guidance=STOP_GUIDANCE, **region)

    def via_step(t_step, carry, step_draws):
        res = {}
        for path, ex in (("kernel", kernel_ex), ("plain", plain_ex)):
            fn = cg.make_clip_guidance(ex, text_hr, draw_fn=lambda b, k: step_draws, **hook_kw)
            with torch.no_grad():
                res[path] = fn(x_recon, None, t_step, s_v, carry)
        torch.cuda.synchronize()
        (xk, ck, _), (xp, cp, _) = res["kernel"], res["plain"]
        zero_out = all(t[:, vh:].abs().max().item() == 0 and t[:, :, vw:].abs().max().item() == 0
                       for t in (xk, xp, ck.mask.float(), cp.mask.float()))
        return xk, ck, xp, cp, zero_out

    xk, ck, xp, cp, zero_out = via_step(10, cg.init_clip_carry(BATCH, (h_fin, w_fin)), draws)
    mask_off = (ck.mask[:, :vh, :vw] != cp.mask[:, :vh, :vw]).float().mean().item()
    covered = ck.mask[:, :vh, :vw].float().mean().item()
    x_in = x_recon.clamp(-1.0, 1.0)
    uk, up = (xk - x_in).reshape(BATCH, -1), (xp - x_in).reshape(BATCH, -1)
    cos = ((uk * up).sum(1) / (uk.norm(dim=1) * up.norm(dim=1))).min().item()
    ok = (mask_off <= 1e-3 and ck.has_mask and abs(covered - FILL_FACTOR) <= 0.01 and cos >= GUIDE_COS and zero_out
          and bool(torch.isfinite(xk).all()))
    say(f"[check first guided step at {vh}x{vw} on the canvas, kernels vs mm] mask differs at {mask_off:.3e} of the "
        f"valid pixels (<= 1e-3) covered share of the valid region {covered:.4f} (fill factor {FILL_FACTOR}, within "
        f"0.01) update cosine, least of a sample {cos:.9f} (>= {GUIDE_COS:g}) x and mask zero outside the valid "
        f"region: {zero_out} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the first guided step at a via scale through kernels 6-7 disagrees with the plain warp")
    xk, _, xp, _, zero_out = via_step(9, ck, kernel_ex.draw(BATCH, text_hr.shape[0]))
    over = share_over((xk - xp).abs(), 1e-4)
    ok = over <= GUIDE_OUTLIERS and zero_out
    say(f"[check guided step with the mask at {vh}x{vw} on the canvas, kernels vs mm] x share over 1e-4 {over:.3e} "
        f"(<= {GUIDE_OUTLIERS:g}) worst {(xk - xp).abs().max().item():.3e} zero outside the valid region: "
        f"{zero_out} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the guided step with the mask at a via scale through kernels 6-7 disagrees with the plain warp")
    out["via_guidance"] = dict(mask_off=mask_off, covered=covered, update_cos=cos, masked_x_share=over)
    del x_recon, xk, xp, ck, cp

    # the vision tower's attention share (CLIPConfig attn_impl "skip": v in
    # place of the attention): that guidance iteration with the same weights,
    # timed beside the full one
    skip_ex = ce.ClipExtractor(random_clip_params(dataclasses.replace(VIT_B_32, attn_impl="skip"), seed=0,
                                                  device="cuda"), n_aug=N_AUG, view_chunk=VIEW_CHUNK)

    def timed_iteration(ex):
        with torch.no_grad():
            return time_ms(lambda: ex.clip_loss_and_grad(x01, text_hr, draws, **region), 3)

    it_ms = {"einsum": timed_iteration(kernel_ex), "skip": timed_iteration(skip_ex)}
    share = 1.0 - it_ms["skip"] / it_ms["einsum"]
    say(f"[time guidance iteration batch {BATCH} x {N_AUG} views, attention] ms with the attention "
        f"{it_ms['einsum']:.3f} with v in its place (attn_impl skip) {it_ms['skip']:.3f}: the attention's share "
        f"{share:.4f}")
    out["attention_share"] = dict(it_ms, share=share)

    # the metric extractors on the card against the CPU (TF32 off in their scope)
    img, other = finest[0], finest[1]
    cpu_clip = copy.deepcopy(clip_model).cpu()
    inc = ti.random_inception_params(seed=0, device="cuda")
    inc_cpu = {k: {kk: v.cpu() for kk, v in layer.items()} for k, layer in inc.items()}
    pairs = {
        "conv proxy": (tm.conv_feature_extractor(device="cuda"), tm.conv_feature_extractor(device="cpu")),
        "inception block0": (tm.inception_feature_extractor(inc), tm.inception_feature_extractor(inc_cpu)),
        "clip tokens": (tm.clip_feature_extractor(clip_model), tm.clip_feature_extractor(cpu_clip)),
        "clip conv1": (tm.clip_feature_extractor(clip_model, "conv1"), tm.clip_feature_extractor(cpu_clip, "conv1")),
    }
    out["metrics"] = {}
    for name, (card_fn, cpu_fn) in pairs.items():
        _, _, rel = err_stats(card_fn(img).cpu(), cpu_fn(img.cpu()))
        d_card, d_cpu = tm.sifid(other, img, card_fn), tm.sifid(other.cpu(), img.cpu(), cpu_fn)
        ok = rel <= 1e-4 and abs(d_card - d_cpu) <= 1e-3 * abs(d_cpu)
        say(f"[check metrics {name}, card vs CPU] features rel {rel:.3e} (<= 1e-4 * max) sifid of two bucketed "
            f"samples {d_card:.6f} vs {d_cpu:.6f} (1e-3 relative) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the {name} features on the card disagree with the CPU")
        out["metrics"][name] = {"features_rel": rel, "sifid": d_card}
    return out


def mesh_objects():
    """Phase 5's objects, made anew from their seeds (a worker of phase 11
    builds them as the parent does): the balloons geometry, schedules, the
    dim-160 denoiser on seed 0, phase 6's pyramid and mode, the walk's
    arguments."""
    from sinddm_tpu_torch.apps.clip_apps import clip_mode_config
    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.pyramid import Pyramid, compute_pyramid_geometry
    from sinddm_tpu_torch.schedules import make_schedules

    _, sizes_wh, factor, n = compute_pyramid_geometry(BALLOONS_WH)
    sizes_hw = [(h, w) for (w, h) in sizes_wh]
    sched = make_schedules(timesteps=100, scale_losses=BALLOONS_LOSSES, n_scales=n, device="cuda")
    model = denoiser_from_flax(random_flax_params(dim=DIM, seed=0), device="cuda")
    pyramid = Pyramid(sizes_hw=tuple(sizes_hw), sizes_wh=tuple(sizes_wh), images=(), recon_images=(),
                      rescale_losses=BALLOONS_LOSSES, scale_factor=factor, n_scales=n)
    mode_cfg = clip_mode_config("clip_content", "Fire in the Forest", STRENGTH, FILL_FACTOR, n)
    walk = dict(scale_factor=factor, n_scales=n, custom_sample=True, device="cuda")
    return model, sched, sizes_hw, pyramid, mode_cfg, walk


def launch_counts():
    from sinddm_tpu_torch.ops import conv_block as cb, dw_conv as dw, warp_sample as ws

    return {"conv_block": cb.launches, "dw_conv": dw.launches, "winx_fwd": ws.launches["winx_fwd"],
            "win_bwd": ws.launches["win_bwd"]}


def reset_launches():
    from sinddm_tpu_torch.ops import conv_block as cb, dw_conv as dw, warp_sample as ws

    cb.launches = dw.launches = 0
    ws.reset_launches()


def mesh_walk(model, sched, sizes_hw, walk, sharding=None):
    """Phase 5's B=16 walk (seed 0): (outputs, wall seconds, launches)."""
    from sinddm_tpu_torch.apps.sampling import sample_scales

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = sample_scales(model, sched, sizes_hw, batch_size=BATCH, generator=torch.Generator(device="cuda").manual_seed(0),
                         sharding=sharding, **walk)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, launch_counts()


def mesh_train(tmp_dir, mesh=None) -> dict:
    """Three train steps at dim 160, batch TRAIN_BATCH on phase 8's seeded
    image (s = 0, the finest, the finest), with the parameters after the
    second and the third, then a grouped chunk of a step at each scale;
    and, under a mesh, one step at batch
    TRAIN_CHECK_BATCH against float64 at the coarsest and the finest scale."""
    from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.pyramid import build_pyramid
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer, step_vs_float64

    pyramid = build_pyramid(str(synthetic_image(tmp_dir)))
    n = pyramid.n_scales
    sched = make_schedules(timesteps=100, scale_losses=pyramid.rescale_losses, n_scales=n, device="cuda")
    tr = MultiscaleTrainer(SinDDMNet(dim=DIM, device="cuda"), sched, pyramid, TrainConfig(train_batch_size=TRAIN_BATCH),
                           DiffusionConfig(), Path(tmp_dir) / "train", seed=0, device="cuda", mesh=mesh)
    snap = lambda: {k: v.detach().clone() for k, v in tr.model.state_dict().items()}  # noqa: E731
    out = {"losses": [], "ms": []}
    for i, s in enumerate((0, n - 1, n - 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["losses"].append(tr.train_step(s=s))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i >= 1:
            out[f"p{i + 1}"] = snap()
    out["lr"] = float(tr.opt.param_groups[0]["lr"])
    # then a grouped chunk, a step at each scale (uncaptured under a mesh)
    out["chunk_losses"] = tr.train_chunk_grouped(n).tolist()
    out["chunk_scales"] = tr.running_scale[3:]
    if mesh is not None:
        out["vs_float64"] = {}
        for s in (0, n - 1):
            check = MultiscaleTrainer(SinDDMNet(dim=DIM, device="cuda"), sched, pyramid,
                                      TrainConfig(train_batch_size=TRAIN_CHECK_BATCH), DiffusionConfig(),
                                      Path(tmp_dir) / "check", seed=0, device="cuda", mesh=mesh)
            gen = torch.Generator(device="cuda").manual_seed(s)
            x_orig = check.data_list[s][0]
            t = torch.randint(0, sched.num_timesteps_trained[s], (TRAIN_CHECK_BATCH,), generator=gen, device="cuda")
            noise = torch.randn((TRAIN_CHECK_BATCH,) + tuple(x_orig.shape[1:]), generator=gen, device="cuda")
            out["vs_float64"][s] = step_vs_float64(check, s, [t], [noise])
            del check
    return out


def synthetic_image(folder) -> Path:
    """``synthetic_dataset``'s seeded 248x186 image, written into ``folder``."""
    import numpy as np
    from PIL import Image

    path = Path(folder) / "synthetic.png"
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, BALLOONS_WH[::-1] + (3,), dtype=np.uint8)).save(path)
    return path


def mesh_guidance(clip_model, mode_cfg, pyramid, model, sched, sharding=None) -> dict:
    """One guidance iteration at batch 16, full width (seeded x and draws),
    and the batch-MESH_GUIDED_BATCH ``clip_content`` walk on seed
    MESH_WALK_SEED."""
    from sinddm_tpu_torch.guidance import clip_extractor as ce
    from sinddm_tpu_torch.guidance.clip_guidance import clip_loss_and_grad

    h_fin, w_fin = BALLOONS_SIZES_HW[-1]
    gen = torch.Generator(device="cuda").manual_seed(60)
    ex = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, generator=gen)
    text = ex.get_text_embedding(mode_cfg["text_input"], ce.get_augmentations_template("hr"))
    x01 = torch.rand((BATCH, h_fin, w_fin, 3), generator=gen, device="cuda")
    draws = ex.draw(BATCH, text.shape[0])
    reset_launches()
    with torch.no_grad():
        loss, grad = clip_loss_and_grad(ex, x01, text, draws, sharding)
    torch.cuda.synchronize()
    out = {"loss": loss, "grad": grad, "iteration_launches": launch_counts()}
    reset_launches()
    outs, aux, wall = guided_walk(model, sched, pyramid, clip_model, MESH_GUIDED_BATCH, MESH_WALK_SEED, mode_cfg,
                                  bucketed=False, sharding=sharding)
    out["walk"] = (outs, [a if a is None else {"clip_score": a["clip_score"], "n_guided": a["n_guided"]}
                          for a in aux], wall)
    out["walk_launches"] = launch_counts()
    return out


def mesh_worker(argv) -> None:
    """One rank of phase 11: ``chip_smoke.py --mesh-worker PORT RANK DATA
    SPATIAL OUT_DIR``. Joins the world (two ranks on one card: gloo), runs
    the unguided walk, the train steps and, with data > 1, the guidance
    checks, each split over the mesh, and writes what it measured to
    ``OUT_DIR/rank{RANK}.pt``."""
    import tempfile

    port, rank, data, spatial = (int(v) for v in argv[:4])
    out_dir = Path(argv[4])
    sys.path.insert(0, str(ROOT))
    from sinddm_tpu_torch.models.clip.convert import random_clip_params
    from sinddm_tpu_torch.models.clip.model import VIT_B_32
    from sinddm_tpu_torch.parallel import distributed, mesh as mesh_module
    from sinddm_tpu_torch.parallel.mesh import batch_sharding, gather_block, make_mesh, split_range

    torch.backends.cudnn.allow_tf32 = False  # as phase 1 leaves it in the parent
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", data * spatial, rank, device="cuda")
    try:
        distributed.build_kernels_once()
        mesh = make_mesh(spatial=spatial, data=data)
        sharding = batch_sharding(mesh)
        model, sched, sizes_hw, pyramid, mode_cfg, walk = mesh_objects()
        res = {"runtime": distributed.runtime()._asdict(), "coords": mesh.coords}
        mesh_walk(model, sched, sizes_hw, walk, sharding)  # warm: cuDNN, the allocator
        distributed.barrier()
        outs, wall, launches = mesh_walk(model, sched, sizes_hw, walk, sharding)
        res["walk"] = {"outs": outs, "wall_s": wall, "launches": launches}
        # every gather of one more split walk, each between two CUDA events
        # (a walk of its own, so that the events stay out of the wall above)
        events = []

        def timed_gather(*args):
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
            result = gather_block(*args)
            pair[1].record()
            events.append(pair)
            return result

        mesh_module.gather_block = timed_gather
        try:
            mesh_walk(model, sched, sizes_hw, walk, sharding)
        finally:
            mesh_module.gather_block = gather_block
        torch.cuda.synchronize()
        res["walk_gathers"] = {"calls": len(events), "ms": sum(a.elapsed_time(b) for a, b in events)}
        # the gather of one finest-scale denoiser call: this rank's block of 16x186x248x3
        h_fin, w_fin = sizes_hw[-1]
        (b0, b1), (r0, r1) = (split_range(n, *sharding.parts(i)) for i, n in enumerate((BATCH, h_fin)))
        block = torch.randn((b1 - b0, r1 - r0, w_fin, 3), device="cuda")
        distributed.barrier()
        res["gather_ms"] = time_ms(lambda: gather_block(block, (BATCH, h_fin, w_fin, 3),
                                                        (slice(b0, b1), slice(r0, r1)), mesh.group("data", "spatial")),
                                   reps=20)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            res["train"] = mesh_train(tmp, mesh)
        if data > 1:
            clip_model = random_clip_params(VIT_B_32, seed=0, device="cuda")
            res["guided"] = mesh_guidance(clip_model, mode_cfg, pyramid, model, sched, sharding)
        torch.save(res, out_dir / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(tag, argvs, timeout) -> list:
    """Start one process per argv together, wait for all (killing the rest
    when one overruns), echo each one's output under ``tag``; fail if any
    exits non-zero. Returns their outputs."""
    procs = [subprocess.Popen(a, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines()[-40:]:
            say(f"[{tag} rank {r}] {line}")
        if p.returncode != 0:
            fail(f"{tag}: rank {r} exited {p.returncode}")
    return texts


def mesh_phase() -> dict:
    """Phase 11: the ('data', 'spatial') mesh. Two worker processes of the
    port share the card over gloo; each check holds the world against the
    single process, computed here on the same seeds."""
    import tempfile

    import numpy as np
    from PIL import Image

    from sinddm_tpu_torch.models.clip.convert import random_clip_params
    from sinddm_tpu_torch.models.clip.model import VIT_B_32
    from sinddm_tpu_torch.parallel import distributed
    from sinddm_tpu_torch.parallel.mesh import gather_block

    t_phase = time.perf_counter()
    out = {"held_at_start": release_cache("phase 11")}
    model, sched, sizes_hw, pyramid, mode_cfg, walk = mesh_objects()
    clip_model = random_clip_params(VIT_B_32, seed=0, device="cuda")
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=work)
    base = Path(tmp.name)

    # the single process, on the workers' seeds
    mesh_walk(model, sched, sizes_hw, walk)
    single_outs, single_wall, single_launches = mesh_walk(model, sched, sizes_hw, walk)
    (base / "single").mkdir()
    single_train = mesh_train(base / "single")
    single_guided = mesh_guidance(clip_model, mode_cfg, pyramid, model, sched)
    controls = {
        "single again": guided_walk(model, sched, pyramid, clip_model, MESH_GUIDED_BATCH, MESH_WALK_SEED, mode_cfg,
                                    bucketed=False),
        "control, other draws": guided_walk(model, sched, pyramid, clip_model, MESH_GUIDED_BATCH,
                                            MESH_WALK_SEED + 1, mode_cfg, bucketed=False),
    }
    out["held_beside_the_worlds"] = release_cache("the worlds")

    worlds = {}
    for name, data, spatial in MESH_WORLDS:
        folder = base / name
        folder.mkdir()
        port = free_port()
        t0 = time.perf_counter()
        spawn_world(f"mesh {name}", [[sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker", str(port), str(r),
                                      str(data), str(spatial), str(folder)] for r in range(data * spatial)], 600)
        worlds[name] = [torch.load(folder / f"rank{r}.pt", map_location="cuda", weights_only=False)
                        for r in range(data * spatial)]
        say(f"[mesh {name}] world of {data * spatial} ranks ({data} x {spatial}): {time.perf_counter() - t0:.1f} s "
            f"from spawn to exit; runtime {[w['runtime'] for w in worlds[name]]}")

    # (a) the unguided walk
    out["walk"] = {"single_wall_s": single_wall}
    for name, ranks in worlds.items():
        diffs = [max((a - b).abs().max().item() for a, b in zip(r["walk"]["outs"], single_outs)) for r in ranks]
        same = all(torch.equal(a, b) for r in ranks[1:] for a, b in zip(r["walk"]["outs"], ranks[0]["walk"]["outs"]))
        launches = [r["walk"]["launches"] for r in ranks]
        ok = max(diffs) <= 2e-3 and same and all(lc == single_launches for lc in launches)
        say(f"[check mesh walk {name} batch {BATCH} dim {DIM}] max |world - single| by rank {diffs} (atol 2e-3), "
            f"ranks equal {same}; wall_s by rank {[round(r['walk']['wall_s'], 3) for r in ranks]} beside the "
            f"single process's {single_wall:.3f} (two ranks share one card: not a scaling number); gather ms a "
            f"denoiser call by rank {[round(r['gather_ms'], 3) for r in ranks]} (CUDA events, 16x186x248x3 fp32 "
            f"all-reduce over gloo); all gathers of a split walk by rank "
            f"{[(r['walk_gathers']['calls'], round(r['walk_gathers']['ms'], 1)) for r in ranks]} (calls, ms; CUDA "
            f"events, a walk of their own); launches by rank {launches} (single {single_launches}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the {name} walk is off the single process's, or its ranks disagree, or a kernel was not launched")
        out["walk"][name] = {"max_abs": max(diffs), "wall_s": [r["walk"]["wall_s"] for r in ranks],
                             "gather_ms": [r["gather_ms"] for r in ranks],
                             "walk_gathers": [r["walk_gathers"] for r in ranks], "launches": launches}

    # (b) the train steps
    out["train"] = {"single_ms": single_train["ms"]}
    lr = single_train["lr"]
    for name, ranks in worlds.items():
        tr = ranks[0]["train"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tr["losses"], single_train["losses"]))
        # the chunk's steps 4-8 carry the first three's last-bit differences: the free-running bound
        chunk_rel = max(abs(a - b) / abs(b) for a, b in zip(tr["chunk_losses"], single_train["chunk_losses"]))
        chunk_ok = tr["chunk_scales"] == single_train["chunk_scales"] and chunk_rel <= GRAPH_LOSS_TOL
        change = torch.cat([((tr["p2"][k] - single_train["p2"][k]).abs() / lr).flatten() for k in tr["p2"]])
        share = share_over(change, 1e-2)
        bit_equal = all(torch.equal(r["train"]["p3"][k], tr["p3"][k]) for r in ranks[1:] for k in tr["p3"])
        f64 = {s: max((r["train"]["vs_float64"][s] for r in ranks), key=lambda e: e["grad_rel"])
               for s in tr["vs_float64"]}
        f64_ok = all(e["loss_rel"] <= TRAIN_LOSS_TOL and e["grad_rel"] <= TRAIN_GRAD_TOL
                     and e["change_share"] <= TRAIN_UPDATE_SHARE for e in f64.values())
        ok = loss_rel <= TRAIN_LOSS_TOL and share <= TRAIN_UPDATE_SHARE and bit_equal and f64_ok and chunk_ok
        say(f"[check mesh train {name} dim {DIM} batch {TRAIN_BATCH}, s = 0, 4, 4, then a grouped chunk of "
            f"{len(tr['chunk_scales'])} steps (scales equal {tr['chunk_scales'] == single_train['chunk_scales']}, "
            f"loss rel {chunk_rel:.3e} <= {GRAPH_LOSS_TOL:g})] loss rel to the single process "
            f"{loss_rel:.3e} (<= {TRAIN_LOSS_TOL:g}); parameters after two steps: largest difference "
            f"{change.max().item():.3e} lr, share over 1e-2 lr {share:.3e} (<= {TRAIN_UPDATE_SHARE:g}); after three "
            f"steps bit-equal across ranks {bit_equal}; step ms by rank {[[round(v, 1) for v in r['train']['ms']] for r in ranks]} "
            f"(single {[round(v, 1) for v in single_train['ms']]}); one step at batch {TRAIN_CHECK_BATCH} vs float64: "
            + "; ".join(f"s={s} loss rel {e['loss_rel']:.3e} max|dg|/max|g| {e['grad_rel']:.3e} (<= {TRAIN_GRAD_TOL:g}) "
                        f"change share {e['change_share']:.3e}" for s, e in f64.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the {name} world's train steps are off the single process's or float64's, or its ranks disagree")
        out["train"][name] = {"loss_rel": loss_rel, "chunk_loss_rel": chunk_rel, "change_max_lr": change.max().item(),
                              "change_share": share,
                              "vs_float64": f64, "ms": [r["train"]["ms"] for r in ranks]}

    # (c) guidance, data = 2
    ranks = worlds["data"]
    for r_i, r in enumerate(ranks):
        ok, _, summary = iteration_check(f"check mesh guidance iteration data rank {r_i} vs single", r["guided"]["loss"],
                                         r["guided"]["grad"], single_guided["loss"], single_guided["grad"],
                                         extra=f"launches {r['guided']['iteration_launches']} ")
        if not ok:
            fail(f"the guidance iteration split over data is off the single process's: {summary}")
    ref = single_guided["walk"]
    stats = {"world (rank 0)": walk_stats(ranks[0]["guided"]["walk"], ref),
             **{k: walk_stats(v, ref) for k, v in controls.items()}}
    held = lambda r: (r["share_over_0.1"] <= MESH_WALK_SHARE and r["cosine"] >= MESH_WALK_COS  # noqa: E731
                      and r["score_rel"] <= MESH_WALK_SCORE_REL)
    for k, r in stats.items():
        say(f"[check mesh clip_content batch {MESH_GUIDED_BATCH}, {k} vs single] finest share over 0.1 "
            f"{r['share_over_0.1']:.4f} (<= {MESH_WALK_SHARE}) least per-sample cosine {r['cosine']:.6f} "
            f"(>= {MESH_WALK_COS}) clip score relative {r['score_rel']:.3e} (<= {MESH_WALK_SCORE_REL}) "
            f"{'held' if held(r) else 'not held'}")
    w_launch = [r["guided"]["walk_launches"] for r in ranks]
    walls = [r["guided"]["walk"][2] for r in ranks]
    say(f"[mesh clip_content walk] wall_s by rank {[round(v, 3) for v in walls]} beside the single process's "
        f"{ref[2]:.3f}; launches by rank {w_launch} (single {single_guided['walk_launches']})")
    if not (held(stats["world (rank 0)"]) and held(stats["single again"])) or held(stats["control, other draws"]):
        fail("the clip_content walk split over data is off the single process's, or the control on other draws is not")
    if any(lc != single_guided["walk_launches"] for lc in w_launch):
        fail(f"a rank's guided-walk launches {w_launch} differ from the single walk's {single_guided['walk_launches']}")
    out["guided"] = {"walk": stats, "wall_s": walls, "single_wall_s": ref[2], "launches": w_launch}

    # (d) the CLI: --mode sample --mesh_data 2 on two processes against one
    data = base / "cli_data"
    data.mkdir()
    synthetic_image(data)
    argv = ["--mode", "sample", "--dataset_folder", str(data), "--image_name", "synthetic.png", "--dim", str(DIM)]
    _, cli_wall, _, _ = run_cli("mesh cli single", argv + ["--results_folder", str(base / "cli_single")])
    port = free_port()
    t0 = time.perf_counter()
    texts = spawn_world("mesh cli", [[sys.executable, "-m", "sinddm_tpu_torch.cli", *argv, "--results_folder",
                                      str(base / "cli_world"), "--coordinator", f"127.0.0.1:{port}",
                                      "--num_processes", "2", "--process_id", str(r), "--mesh_data", "2"]
                                     for r in range(2)], 600)
    world_wall = time.perf_counter() - t0
    unstamped = lambda p: re.sub(r"_sample_[^/]+?(\.png$|/)", r"_sample\1", p)  # noqa: E731
    files = {k: sorted((p.relative_to(base / k / "forest").as_posix() for p in (base / k / "forest").rglob("*.png")),
                       key=unstamped) for k in ("cli_single", "cli_world")}
    worst = max(int(np.abs(np.asarray(Image.open(base / "cli_single" / "forest" / a), np.int16)
                           - np.asarray(Image.open(base / "cli_world" / "forest" / b), np.int16)).max())
                for a, b in zip(files["cli_single"], files["cli_world"]))
    ok = (list(map(unstamped, files["cli_single"])) == list(map(unstamped, files["cli_world"]))
          and len(files["cli_single"]) == len(sizes_hw) + BATCH and worst <= 1
          and "saved 5 scales" in texts[0] and "saved" not in texts[1] and "backend gloo" in texts[0])
    say(f"[check mesh cli --mode sample --mesh_data 2] files {len(files['cli_world'])} from the primary alone, the "
        f"single process's names {list(map(unstamped, files['cli_single'])) == list(map(unstamped, files['cli_world']))}; "
        f"largest 8-bit difference {worst} (<= 1: the walk's 2e-3 on [-1, 1] may round a value the other way); "
        f"wall_s single {cli_wall:.3f} (in this process), world {world_wall:.3f} (two processes from spawn to exit) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the two-process CLI's files are not the single process's")
    out["cli"] = {"worst_u8": worst, "single_wall_s": cli_wall, "world_wall_s": world_wall}

    # (e) NCCL: a one-rank world on the card runs the gather and the
    # gradient all-reduce the port uses
    if not distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda"):
        fail("a one-rank world did not start")
    try:
        import torch.distributed as dist

        backend = distributed.runtime().backend
        x = torch.randn((BATCH,) + tuple(sizes_hw[-1]) + (3,), generator=torch.Generator(device="cuda").manual_seed(3),
                        device="cuda")
        gathered = gather_block(x, x.shape, (slice(0, BATCH),), dist.group.WORLD)
        flat = torch.randn(1_000_000, device="cuda")
        summed = flat.clone()
        dist.all_reduce(summed)
        ms = time_ms(lambda: gather_block(x, x.shape, (slice(0, BATCH),), dist.group.WORLD), reps=20)
        ok = backend == "nccl" and torch.equal(gathered, x) and torch.equal(summed, flat)
        say(f"[check mesh nccl] one-rank world backend {backend}: the gather of 16x186x248x3 and a gradient "
            f"all-reduce return their input {'ok' if ok else 'FAIL'}; gather ms {ms:.3f} (CUDA events)")
        if not ok:
            fail("the one-rank NCCL world does not run the port's collectives")
        out["nccl"] = {"backend": backend, "gather_ms": ms}
    finally:
        distributed.shutdown()
    tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[mesh] phase 11 took {out['phase_s']:.1f} s")
    return out


def graph_launches(run) -> int:
    """The kernels one call of ``run`` launches: the kernel nodes of a CUDA
    graph that captures it (after a warm call). torch.profiler's count is
    not used for this: it also records kernels still running from the work
    queued before it, and in a process that has profiled before it has
    dropped a whole call's kernels."""
    import ctypes

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        run()
    driver = ctypes.CDLL("libcuda.so.1")
    driver.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    driver.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle, n = graph.raw_cuda_graph(), ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if driver.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if driver.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def dot_phase(model, sched, sizes_hw, walk, kernel_walk_b2, gen) -> dict:
    """Phase 12: the dot-formulated denoiser executor
    (``models/fast_denoiser.py``, ``make_model_fn(model, "fp32_dot" |
    "bf16_dot")``) on phase 5's pyramid and weights, beside kernels 1-2:
    (a) one finest-scale call against the plain path and the kernel path,
    and its TF32 control; (b) the batch-2 walk on phase 5's draws against
    phase 5's kernel walk; (c) times, peak memory and launches a call."""
    from sinddm_tpu_torch.apps.sampling import make_model_fn, sample_scales
    from sinddm_tpu_torch.models import fast_denoiser as fd
    from sinddm_tpu_torch.models.denoiser import compute_cond_vec
    from sinddm_tpu_torch.ops import conv_block as cb

    t_phase = time.perf_counter()
    h, w = BALLOONS_SIZES_HW[-1]
    dot = {name: make_model_fn(model, name) for name in ("fp32_dot", "bf16_dot")}
    mm = torch.backends.cuda.matmul
    out = {}

    # (a) one finest-scale call. cuBLAS's TF32 is on around the dot calls, so
    # the executor's own scope is what keeps fp32_dot's products fp32; the
    # control takes that scope out and must break the fp32 bound
    with torch.no_grad():
        x = torch.randn((BATCH, h, w, 3), generator=gen, device="cuda")
        t = torch.full((BATCH,), 10, dtype=torch.long, device="cuda")
        plain, kernel = model.run(x, t, 4.0, cb.conv_block_reference), model(x, t, 4.0)
        scope = fd.matmul_precision
        mm.allow_tf32 = True
        try:
            calls = {name: fn(x, t, 4.0) for name, fn in dot.items()}
            fd.matmul_precision = lambda *a: contextlib.nullcontext()
            calls["fp32_dot TF32 (control)"] = dot["fp32_dot"](x, t, 4.0)
        finally:
            fd.matmul_precision = scope
            mm.allow_tf32 = False
        torch.cuda.synchronize()
    checks = (("fp32_dot", plain, "plain", 1e-4), ("fp32_dot", kernel, "kernel", 1e-4),
              ("bf16_dot", plain, "plain", 5e-2), ("fp32_dot TF32 (control)", plain, "plain", 1e-4))
    out["call"] = {}
    for name, ref, ref_name, tol in checks:
        _, max_abs, rel = err_stats(calls[name], ref)
        control = "control" in name
        ok = (rel > tol) if control else (rel <= tol and bool(torch.isfinite(calls[name]).all()))
        say(f"[check dot {name} vs {ref_name} {BATCH}x{h}x{w} dim={DIM}] max_abs {max_abs:.3e} rel {rel:.3e} "
            f"({'must exceed' if control else '<='} {tol:g} * max|{ref_name}|) {'ok' if ok else 'FAIL'}")
        out["call"][f"{name} vs {ref_name}"] = rel
        if not ok:
            fail(f"the dot executor's call, {name} against the {ref_name} path: rel {rel:.3e} against {tol:g}"
                 + (": the fp32 bound cannot tell TF32 from fp32" if control else ""))
    del x, plain, kernel, calls

    # (b) the batch-2 walk through make_model_fn on phase 5's draws
    ours = sample_scales(dot["fp32_dot"], sched, sizes_hw, batch_size=2,
                         generator=torch.Generator(device="cuda").manual_seed(1), **walk)[-1]
    max_abs = (ours - kernel_walk_b2).abs().max().item()
    ok = max_abs <= 2e-3
    say(f"[check dot walk batch 2, fp32_dot vs kernel] final-scale max_abs {max_abs:.3e} (atol 2e-3) "
        f"{'ok' if ok else 'FAIL'}")
    out["walk_b2_max_abs"] = max_abs
    if not ok:
        fail("the walk through the dot executor disagrees with the kernel walk")

    def peak_gb(run, held):
        """The peak GB ``run`` allocates above what was held before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - held) / 1e9

    # (c) the l3 block: the dot path beside kernels 2 + 1 and cuDNN's two 3x3 products
    out["l3_block"] = {}
    with torch.no_grad():
        x3 = torch.randn((BATCH, h, w, DIM), generator=gen, device="cuda")
        cond = compute_cond_vec(model, torch.full((BATCH,), 10, device="cuda"), 4.0)
        for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            xd, cd = x3.to(dtype), cond.to(dtype)
            args = model.l3.block_args(xd, cd)
            held = torch.cuda.memory_allocated()
            dot_ms = time_ms(lambda: fd.block_dot(model.l3, xd, cd, dtype), reps=3, warm=1)
            dot_gb = peak_gb(lambda: fd.block_dot(model.l3, xd, cd, dtype), held)
            k_ms = time_ms(lambda: cb.conv_block(*args), reps=10)
            k_gb = peak_gb(lambda: cb.conv_block(*args), held)
            w1, w2 = (wt.to(dtype).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
                      for wt in (model.l3.net_conv1.weight, model.l3.net_conv2.weight))
            h1, g = (xd.permute(0, 3, 1, 2), torch.randn_like(xd).permute(0, 3, 1, 2))
            lib_ms = time_ms(lambda: (F.conv2d(h1, w1, padding=1), F.conv2d(g, w2, padding=1)), reps=10)
            say(f"[time dot l3 block {dname} {BATCH}x{h}x{w}x{DIM}] dot_ms {dot_ms:.3f} kernels_1_2_ms {k_ms:.3f} "
                f"({dot_ms / k_ms:.2f}x) cudnn_3x3_products_ms {lib_ms:.3f} | peak GB above held: dot {dot_gb:.3f} "
                f"kernels {k_gb:.3f}")
            out["l3_block"][dname] = dict(dot_ms=dot_ms, kernels_ms=k_ms, cudnn_3x3_products_ms=lib_ms,
                                          dot_peak_GB=dot_gb, kernels_peak_GB=k_gb)
            del xd, cd, args, w1, w2, h1, g
        del x3

    # (c) one finest-scale call of each executor: its kernel launches, its
    # device ms (CUDA events) and where that time goes (torch.profiler)
    out["call_launches"], out["call_ms"] = {}, {}
    x = torch.randn((BATCH, h, w, 3), generator=gen, device="cuda")
    t = torch.full((BATCH,), 10, dtype=torch.long, device="cuda")
    for name, fn in (("kernel", model), *dot.items()):
        with torch.no_grad():
            n = graph_launches(lambda: fn(x, t, 4.0))
            ms = time_ms(lambda: fn(x, t, 4.0), reps=3)
            prof = profile_walk(lambda: fn(x, t, 4.0))
        say(f"[time dot {name} call {BATCH}x{h}x{w}] launches {n} ms {ms:.2f}")
        out["call_launches"][name], out["call_ms"][name] = n, ms
        if prof is None:
            say(f"[profile dot {name}] torch.profiler recorded no device activity: breakdown not measured")
            continue
        by_name, busy, _ = prof
        for kname, (us, _) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            say(f"[profile dot {name}] {us / busy:7.2%} of device time {kname[:100]}")
    del x, t

    # (c) the B=16 walk through each executor, the kernel path first
    out["walk"] = {}
    for name, fn in (("kernel", model), *dot.items()):
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = sample_scales(fn, sched, sizes_hw, batch_size=BATCH,
                             generator=torch.Generator(device="cuda").manual_seed(0), **walk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        if not all(bool(torch.isfinite(o).all()) for o in outs) or tuple(outs[-1].shape) != (BATCH, h, w, 3):
            fail(f"the B={BATCH} walk through {name} gave non-finite values or shape {tuple(outs[-1].shape)}")
        say(f"[walk dot {name}] batch {BATCH} dim {DIM} wall_s {wall:.3f} peak GB above held {peak:.3f}")
        out["walk"][name] = dict(wall_s=wall, peak_GB=peak)
        del outs
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[dot] phase 12 took {out['phase_s']:.1f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (ROOT / "sinddm_tpu_torch" / "csrc").is_dir():
        fail(f"run from the root of a checkout: {ROOT / 'sinddm_tpu_torch'} is missing")
    sys.path.insert(0, str(ROOT))

    from sinddm_tpu_torch.apps.clip_apps import (
        ROI_ASCENT_ITERS,
        ROI_DENOISING_STEPS,
        ROI_STRENGTH,
        _clip_roi_ascent,
        clip_mode_config,
        clip_roi_sampling,
        clip_sampling,
    )
    from sinddm_tpu_torch.apps.sampling import sample_scales
    from sinddm_tpu_torch.diffusion.core import sample_via_scale
    from sinddm_tpu_torch.guidance import clip_extractor as ce, clip_guidance as cg
    from sinddm_tpu_torch.models.clip.convert import random_clip_params
    from sinddm_tpu_torch.models.clip.model import VIT_B_32
    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.ops import _build, conv_block as cb, dw_conv as dw, warp as wp, warp_sample as ws
    from sinddm_tpu_torch.pyramid import Pyramid, compute_pyramid_geometry
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.utils.flops import peaks_for, sample_pyramid_flops

    t_start = time.perf_counter()

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[card] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"python {sys.version.split()[0]} | peaks {peaks}")

    # ---- 2. build ---------------------------------------------------------
    secs = _build.build()
    say(f"[build] nvcc seconds {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    for kname in _build.KERNELS:
        log = _build.library_path(kname).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"[ptxas {kname}] {line.strip()}")
    tensor_core_check(_build)

    gen = torch.Generator(device="cuda").manual_seed(0)
    h_fin, w_fin = BALLOONS_SIZES_HW[-1]
    results = {}

    # ---- 3. kernels against their plain versions ---------------------------
    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for shape_name, (b, h, w) in (("full", (BATCH, h_fin, w_fin)), ("ragged", (1,) + RAGGED_HW)):
            for bname, c, co in BLOCKS:
                args = block_inputs(gen, b, h, w, c, co, dtype)
                out = cb.conv_block(*args)
                ref = cb.conv_block_reference(*args)
                torch.cuda.synchronize()
                d, max_abs, rel = err_stats(out, ref)
                if dtype == torch.float32:
                    ok = bool((d <= 2e-4 + 2e-4 * ref.float().abs()).all())
                    tol = "atol 2e-4 + rtol 2e-4"
                else:
                    ok = rel <= 2e-2
                    tol = "max err <= 2e-2 * max|plain|"
                say(f"[check conv_block {dname} {shape_name} {bname} {b}x{h}x{w} {c}->{co}] "
                    f"max_abs {max_abs:.3e} rel {rel:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"conv_block {dname} {bname} {shape_name} disagrees with its plain version")
                if (dname, shape_name, bname) == ("fp32", "full", "l3"):
                    results["conv_block_err"] = max_abs
                del args, out, ref, d

    # the depthwise kernel at each of its walk calls (with the block's vector)
    # and at ragged shapes without one, fp32 and bf16; and its launch plan
    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for shape, with_vec in [((BATCH, h_fin, w_fin, c), True) for c in DW_CHANNELS] + [
                ((1,) + RAGGED_HW + (c,), False) for c in (3, DIM)]:
            args = dw_inputs(gen, shape, dtype, with_vec)
            out = dw.depthwise_conv5x5(*args)
            torch.cuda.synchronize()
            max_abs, ok = dw_err(out, *args)
            say(f"[check dw_conv {dname} {'x'.join(map(str, shape))}{' +vec' if with_vec else ''}] max_abs "
                f"{max_abs:.3e} vs float64 ({'atol 1e-5' if dtype == torch.float32 else '<= 1e-4 + 2^-8 |exact|'}) "
                f"kernel {dw.dw_plan(shape, dtype)['kernel']} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"dw_conv {dname} {shape} disagrees with its float64 plain version")
            if (dname, shape) == ("fp32", (BATCH, h_fin, w_fin, DIM)):
                results["dw_err"] = max_abs
            del args, out
    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for what, shape in (("l3", (BATCH, h_fin, w_fin, DIM)),
                            ("smallest scale l2", (BATCH,) + BALLOONS_SIZES_HW[0] + (DIM // 2,)),
                            ("smallest scale l3", (BATCH,) + BALLOONS_SIZES_HW[0] + (DIM,))):
            say(f"[plan dw_conv {dname} {what} {'x'.join(map(str, shape))}] {json.dumps(dw.dw_plan(shape, dtype))}")

    # view-warp kernels, value and image gradient: the main path's launch (16
    # images, one chunk of 8 views of 224x298, homographies from the port's
    # augmentation, fill 1) and a hard case (a 300-row source, taller than the
    # TPU kernels take; coords over -0.2 .. 1.3 of it, and a 40-degree rotation)
    frame = ce.resize_output_size(h_fin, w_fin)
    view_draws = ce.draw_view_params(BATCH, N_AUG, gen, "cuda")
    warp_img = torch.rand((BATCH, h_fin, w_fin, 3), generator=gen, device="cuda")

    def view_coords(lo, hi):
        m = ce.view_matrices(view_draws.views(lo, hi), range(lo, hi), (h_fin, w_fin), frame)
        return wp.homography_coords(m, frame)

    tall = torch.rand((1, 300, 23, 3), generator=gen, device="cuda")
    spread = (torch.rand((17, 13, 2), generator=gen, device="cuda") * 1.5 - 0.2) * torch.tensor([23.0, 300.0], device="cuda")
    rotated = wp.homography_coords(
        wp.crop_resize_matrix(0.0, 0.0, 300.0, 23.0, (17, 13), device="cuda")
        @ wp.affine_matrix(torch.tensor(40.0, device="cuda"), (0.0, 0.0), (17, 13)), (17, 13))
    # the warp kernels' other cases: one launch with views and coords
    # scattered over the whole source; flat coords; 37x45 frames, where a run
    # of 1024 samples ends inside an image
    main_coords = view_coords(0, VIEW_CHUNK)
    scattered = (torch.rand((BATCH, 1) + frame + (2,), generator=gen, device="cuda") * 1.5 - 0.2) * torch.tensor(
        [float(w_fin), float(h_fin)], device="cuda")
    small_img = torch.rand((BATCH, 30, 36, 3), generator=gen, device="cuda")
    small_views = wp.homography_coords(ce.view_matrices(view_draws.views(0, 2), range(2), (30, 36), (37, 45)), (37, 45))
    warp_cases = (("main", warp_img, main_coords, 1.0),
                  ("ragged", tall, torch.stack([spread, rotated])[None], 0.5),
                  ("mixed", warp_img, torch.cat([view_coords(0, 1), scattered], dim=1), 1.0),
                  ("flat", warp_img, main_coords.reshape(BATCH, -1, 2), 1.0),
                  ("frame 37x45", small_img, small_views, 0.0))
    results["warp_err"] = {}
    for case, img, coords, fill in warp_cases:
        coords3 = coords.reshape(img.shape[0], -1, 2)
        plan = ws.whole_adjoint_patches(coords3, coords.shape[-2], img.shape[1:3], 3)
        for entry in ("whole_bwd", "win3_bwd"):  # one patch body: the same patches, boxes and branches
            say(f"[plan warp {entry} {case}] {patch_plan(plan)}")
        if case == "mixed" and not (plan["shared"] and plan["direct"]):
            fail(f"the mixed case does not reach both branches of the whole-image adjoint: {plan}")
        ct = torch.randn(coords.shape[:-1] + (3,), generator=gen, device="cuda")
        x_ref = img.clone().requires_grad_(True)
        ref = plain_warp(x_ref, coords, fill)
        (g_ref,) = torch.autograd.grad(ref, x_ref, ct)
        g_max = g_ref.abs().max().item()
        for variant, fn in ws.FORWARDS.items():
            x_in = img.clone().requires_grad_(True)
            out = fn(x_in, coords, fill)
            (g_out,) = torch.autograd.grad(out, x_in, ct)
            torch.cuda.synchronize()
            v_err, g_err = (out - ref).abs().max().item(), (g_out - g_ref).abs().max().item()
            ok = v_err <= 1e-5 and g_err <= 1e-5 * g_max
            say(f"[check warp {variant} {case} img {'x'.join(map(str, img.shape))} coords "
                f"{'x'.join(map(str, coords.shape))} fill {fill}] value max_abs {v_err:.3e} (atol 1e-5) "
                f"grad max_abs {g_err:.3e} of max|g| {g_max:.3e} (<= 1e-5 * max|g|) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"warp kernel {variant} ({case}) disagrees with its plain version")
            if case == "main":
                bwd = f"{ws.ADJOINT[variant]}_bwd"
                results["warp_err"][f"{variant}_fwd"] = v_err
                results["warp_err"][bwd] = max(results["warp_err"].get(bwd, 0.0), g_err)
        # win3 against its plain version (the same splits as matrix products)
        # and against the exact warp, at the JAX test's bounds
        x_s3 = img.clone().requires_grad_(True)
        ref3 = plain_warp(x_s3, coords, fill, ws.bilinear_sample_split3)
        (g_ref3,) = torch.autograd.grad(ref3, x_s3, ct)
        x_in = img.clone().requires_grad_(True)
        out = ws.bilinear_sample_pallas_win3(x_in, coords, fill)
        (g_out,) = torch.autograd.grad(out, x_in, ct)
        torch.cuda.synchronize()
        v_err, g_err = (out - ref3).abs().max().item(), (g_out - g_ref3).abs().max().item()
        e_err, eg_err = (out - ref).abs().max().item(), (g_out - g_ref).abs().max().item()
        ok = (v_err <= 1e-5 and g_err <= 1e-5 * g_ref3.abs().max().item()
              and e_err <= 3e-4 and eg_err <= 7e-5 * g_max)
        say(f"[check warp win3 {case} img {'x'.join(map(str, img.shape))} coords {'x'.join(map(str, coords.shape))} "
            f"fill {fill}] vs split3 plain: value max_abs {v_err:.3e} (atol 1e-5) grad max_abs {g_err:.3e} "
            f"(<= 1e-5 * max|g|) | vs exact fp32: value max_abs {e_err:.3e} (atol 3e-4) grad max_abs "
            f"{eg_err:.3e} of max|g| {g_max:.3e}, ratio {eg_err / g_max:.3e} (<= 7e-5; the TPU kernel's "
            f"{TPU_WIN3_GRAD_ERR[0]} / {TPU_WIN3_GRAD_ERR[1]} = {TPU_WIN3_GRAD_ERR[0] / TPU_WIN3_GRAD_ERR[1]:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"warp kernel win3 ({case}) disagrees with its plain version or leaves the bf16x3 bound")
        if case == "main":
            results["warp_err"]["win3_fwd"], results["warp_err"]["win3_bwd"] = v_err, g_err
            results["win3_vs_exact"] = dict(value=e_err, grad=eg_err, grad_max=g_max)
        del ct, x_ref, ref, g_ref, x_s3, ref3, g_ref3, x_in, out, g_out, coords3

    # ---- 4. times at the main path's shapes ---------------------------------
    # a block's bound: its operations on the tensor cores (fp32 as 3xTF32,
    # three TF32 products; bf16 one product) or its bytes, whichever is longer
    for dtype, dname, rate in ((torch.float32, "fp32", peaks["tf32"] / 3), (torch.bfloat16, "bf16", peaks["bf16"])):
        for bname, c, co in BLOCKS:
            args = block_inputs(gen, BATCH, h_fin, w_fin, c, co, dtype)
            k_ms = time_ms(lambda: cb.conv_block(*args), reps=10)
            p_ms = time_ms(lambda: cb.conv_block_reference(*args), reps=5)
            flops, nbytes = block_work(BATCH, h_fin, w_fin, c, co, args[0].element_size())
            b_ms, b_by = bound(flops, nbytes, rate, peaks["mem"])
            ops_ms = {k: flops / peaks[k] * 1e3 for k in ("fp32", "tf32", "bf16")}
            ops_ms["3xtf32"] = 3 * ops_ms["tf32"]
            # cuDNN's two 3x3 products alone (channels-last, TF32 off), not the block
            nchw = lambda ch: args[0].new_empty(BATCH, h_fin, w_fin, ch).normal_(generator=gen).permute(0, 3, 1, 2)  # noqa: E731
            oihw = lambda w: w.to(dtype).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)  # noqa: E731
            h1_cl, g_cl, w1_cl, w2_cl = nchw(c), nchw(co), oihw(args[4]), oihw(args[6])
            lib_ms = time_ms(lambda: (F.conv2d(h1_cl, w1_cl, padding=1), F.conv2d(g_cl, w2_cl, padding=1)), reps=10)
            say(f"[time conv_block {dname} {bname} {BATCH}x{h_fin}x{w_fin} {c}->{co}] kernel_ms {k_ms:.4f} "
                f"plain_ms {p_ms:.4f} GFLOP {flops / 1e9:.2f} GB {nbytes / 1e9:.4f} bound_ms {b_ms:.4f} ({b_by}, "
                f"{'3xTF32' if dtype == torch.float32 else 'bf16'}) share of the bound {b_ms / k_ms:.3f} | operations "
                f"alone: fp32_SIMT_ms {ops_ms['fp32']:.4f} TF32_ms {ops_ms['tf32']:.4f} 3xTF32_ms {ops_ms['3xtf32']:.4f} "
                f"bf16_ms {ops_ms['bf16']:.4f} | TFLOP/s {flops / k_ms / 1e9:.2f} | cudnn_3x3_products_ms {lib_ms:.4f} "
                f"(F.conv2d channels-last, TF32 off: cuDNN's two 3x3 products alone, not the block)")
            if (dname, bname) == ("fp32", "l3"):
                results["conv_block"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                             cudnn_3x3_products_ms=lib_ms,
                                             shape=f"{BATCH}x{h_fin}x{w_fin}x{c}->{co} fp32")
            del args, h1_cl, g_cl, w1_cl, w2_cl

    # the depthwise kernel at each walk call at 16x186x248 (the block's call,
    # with its vector), beside its bytes bound, its plain version and one
    # F.conv2d (groups=C, channels-last, + bias: no vector)
    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for c in DW_CHANNELS:
            x, wdw, bias, vec = dw_inputs(gen, (BATCH, h_fin, w_fin, c), dtype)
            w_lib = wdw.permute(2, 0, 1)[:, None].contiguous()
            x_lib = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
            k_ms = time_ms(lambda: dw.depthwise_conv5x5(x, wdw, bias, vec), reps=20)
            p_ms = time_ms(lambda: dw.depthwise_conv5x5_reference(x, wdw, bias, vec), reps=5)
            l_ms = time_ms(lambda: F.conv2d(x_lib, w_lib, bias, padding=2, groups=c), reps=20)
            n_el = x.numel()
            flops, nbytes = 2 * 25 * n_el, x.element_size() * (2 * n_el + 26 * c + BATCH * c)
            b_ms, b_by = bound(flops, nbytes, peaks["fp32"], peaks["mem"])
            shape = f"{BATCH}x{h_fin}x{w_fin}x{c} {dname} +vec"
            say(f"[time dw_conv {shape}] kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
                f"GFLOP {flops / 1e9:.2f} GB {nbytes / 1e9:.4f} bound_ms {b_ms:.4f} ({b_by}) share of the bound "
                f"{b_ms / k_ms:.3f} GB/s {nbytes / k_ms / 1e6:.1f} kernel {dw.dw_plan(x.shape, dtype)['kernel']}")
            if (dname, c) == ("fp32", DIM):
                results["dw_conv"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                                          shape=shape)
            del x, x_lib, wdw, w_lib, bias, vec

    # the warp kernels: one launch of the main path (16 images x 8 views), and
    # all 256 views of a guided step in one launch
    results["warp"] = {}
    for n_views in (VIEW_CHUNK, N_AUG):
        coords = view_coords(0, n_views)
        n_px = n_views * frame[0] * frame[1]
        shape = f"img {BATCH}x{h_fin}x{w_fin}x3, {n_views} views of {frame[0]}x{frame[1]} an image, fp32"
        ct = torch.randn(coords.shape[:-1] + (3,), generator=gen, device="cuda")
        x_lib, grid = grid_sample_inputs(warp_img, coords)
        x_lib.requires_grad_(True)
        lib_out = F.grid_sample(x_lib, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        ct_lib = ct.reshape(BATCH, -1, frame[1], 3).permute(0, 3, 1, 2).contiguous()
        x_plain = warp_img.clone().requires_grad_(True)
        plain_out = plain_warp(x_plain, coords, 1.0)
        with torch.no_grad():
            lib_f = time_ms(lambda: F.grid_sample(x_lib, grid, mode="bilinear", padding_mode="zeros",
                                                  align_corners=True), reps=10)
            plain_f = time_ms(lambda: plain_warp(warp_img, coords, 1.0), reps=2, warm=1)
        lib_b = time_ms(lambda: torch.autograd.grad(lib_out, x_lib, ct_lib, retain_graph=True), reps=10)
        plain_b = time_ms(lambda: torch.autograd.grad(plain_out, x_plain, ct, retain_graph=True), reps=2, warm=1)
        coords3 = coords.reshape(BATCH, -1, 2)
        timed = [(f"{v}_fwd", (lambda fn=fn: fn(warp_img, coords, 1.0)), plain_f, lib_f) for v, fn in ws.FORWARDS.items()]
        # win3 beside its own plain version; its adjoint beside the other two
        # patch adjoints (kernels 4 and 6), at one launch of the path and at 256 views
        x_s3 = warp_img.clone().requires_grad_(True)
        out_s3 = plain_warp(x_s3, coords, 1.0, ws.bilinear_sample_split3)
        with torch.no_grad():
            plain3_f = time_ms(lambda: plain_warp(warp_img, coords, 1.0, ws.bilinear_sample_split3), reps=2, warm=1)
        plain3_b = time_ms(lambda: torch.autograd.grad(out_s3, x_s3, ct, retain_graph=True), reps=2, warm=1)
        del x_s3, out_s3
        timed.append(("win3_fwd", lambda: ws.bilinear_sample_pallas_win3(warp_img, coords, 1.0), plain3_f, lib_f))
        timed += [(f"{a}_bwd", (lambda a=a: ws.warp_adjoint(ct, coords3, warp_img.shape, a, frame[1])),
                   plain3_b if a == "win3" else plain_b, lib_b) for a in ("whole", "win", "win3")]
        for entry, run, p_ms, l_ms in timed:
            with torch.no_grad():
                k_ms = time_ms(run, reps=20)
            flops, nbytes = warp_work(BATCH, n_px, h_fin, w_fin, 3, adjoint=entry.endswith("_bwd"),
                                      split3=entry.startswith("win3"))
            b_ms, b_by = bound(flops, nbytes, peaks["fp32"], peaks["mem"])
            alone_ms = time_ms(run_kernel(_build, entry, warp_img, coords, 1.0, ct), reps=20)  # its C entry
            say(f"[time warp {entry} {shape}] kernel_ms {k_ms:.4f} kernel_alone_ms {alone_ms:.4f} plain_ms {p_ms:.4f} "
                f"library_ms {l_ms:.4f} MFLOP {flops / 1e6:.1f} MB {nbytes / 1e6:.1f} bound_ms {b_ms:.4f} ({b_by}) share of the bound "
                f"{b_ms / k_ms:.3f} GB/s {nbytes / k_ms / 1e6:.1f}")
            record = dict(ms=k_ms, kernel_alone_ms=alone_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                          bound_by=b_by, shape=shape)
            if n_views == VIEW_CHUNK:
                results["warp"][entry] = record
            elif entry.endswith("_bwd"):
                results.setdefault("warp_256_views", {})[entry] = {k: record[k] for k in ("ms", "kernel_alone_ms")}
        plan = ws.whole_adjoint_patches(coords3, frame[1], (h_fin, w_fin), 3)
        for entry in ("whole_bwd", "win_bwd", "win3_bwd"):  # one patch body, one plan
            say(f"[plan warp {entry} {shape}] {patch_plan(plan)}")
        if n_views == VIEW_CHUNK:  # the win3 entry is one launch: the split happens in the kernel
            prof = profile_walk(lambda: ws.bilinear_sample_pallas_win3(warp_img, coords, 1.0))
            if prof is None:
                fail("torch.profiler recorded no device activity over a win3 entry call")
            names = {k: n for k, (_, n) in prof[0].items()}
            say(f"[check warp win3 entry launches] device kernels of one call: {names} (1 expected)")
            if sum(names.values()) != 1:
                fail(f"the win3 entry launches {sum(names.values())} kernels, not one: {names}")
        del coords, ct, x_lib, grid, lib_out, ct_lib, x_plain, plain_out, coords3, timed
    ws.reset_launches()

    # ---- 5. the main path ----------------------------------------------------
    _, sizes_wh, factor, n_scales = compute_pyramid_geometry(BALLOONS_WH)
    sizes_hw = [(h, w) for (w, h) in sizes_wh]
    if sizes_hw != BALLOONS_SIZES_HW:
        fail(f"balloons geometry {sizes_hw} != {BALLOONS_SIZES_HW}")
    sched = make_schedules(timesteps=100, scale_losses=BALLOONS_LOSSES, n_scales=n_scales, device="cuda")
    if sched.num_timesteps_ideal != BALLOONS_T_IDEAL:
        fail(f"num_timesteps_ideal {sched.num_timesteps_ideal} != {BALLOONS_T_IDEAL}")
    model = denoiser_from_flax(random_flax_params(dim=DIM, seed=0), device="cuda")
    plain_fn = lambda x, t, s: model.run(x, t, s, cb.conv_block_reference)  # noqa: E731

    with torch.no_grad():
        x = torch.randn((BATCH, h_fin, w_fin, 3), generator=gen, device="cuda")
        t = torch.full((BATCH,), 10, dtype=torch.long, device="cuda")
        out_k, out_p = model(x, t, 4.0), plain_fn(x, t, 4.0)
        torch.cuda.synchronize()
    _, max_abs, rel = err_stats(out_k, out_p)
    ok = rel <= 1e-4
    say(f"[check denoiser fp32 {BATCH}x{h_fin}x{w_fin} dim={DIM}] max_abs {max_abs:.3e} rel {rel:.3e} "
        f"(<= 1e-4 * max|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("denoiser call through the kernels disagrees with the plain path")

    walk = dict(scale_factor=factor, n_scales=n_scales, custom_sample=True, device="cuda")
    cb.launches = 0
    dw.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = sample_scales(model, sched, sizes_hw, batch_size=BATCH,
                         generator=torch.Generator(device="cuda").manual_seed(0), **walk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv_block": cb.launches, "dw_conv": dw.launches}

    calls = sum(sched.num_timesteps_ideal)
    expect = {"conv_block": calls * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": calls * 4}
    walk_flops = sample_pyramid_flops(sizes_hw, sched.num_timesteps_ideal[1:], BATCH, DIM,
                                      sched.num_timesteps_ideal[0])
    say(f"[walk] batch {BATCH} dim {DIM} fp32 scales {sizes_hw} steps {list(sched.num_timesteps_ideal)} "
        f"denoiser_calls {calls} wall_s {wall:.3f} TFLOP {walk_flops / 1e12:.2f} "
        f"TFLOP/s {walk_flops / wall / 1e12:.2f} launches {launches}")
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    for out, (h, w) in zip(outs, sizes_hw):
        if tuple(out.shape) != (BATCH, h, w, 3):
            fail(f"output shape {tuple(out.shape)} != {(BATCH, h, w, 3)}")
        if not bool(torch.isfinite(out).all()):
            fail(f"non-finite values at {h}x{w}")
        if out.abs().max().item() > 1.0 + 1e-5:
            fail(f"output at {h}x{w} leaves [-1, 1]: {out.abs().max().item()}")

    # where the walk's device time goes: a second, profiled walk
    prof = profile_walk(lambda: sample_scales(
        model, sched, sizes_hw, batch_size=BATCH,
        generator=torch.Generator(device="cuda").manual_seed(0), **walk))
    if prof is None:
        say("[profile] torch.profiler recorded no device activity: breakdown not measured")
    else:
        by_name, busy, window = prof
        say(f"[profile] walk device busy_ms {busy / 1e3:.1f} kernel-window_ms {window / 1e3:.1f} "
            f"idle_share {1 - busy / window:.4f} kernels {sum(n for _, n in by_name.values())}")
        for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            say(f"[profile] {us / busy:7.2%} {us / 1e3:10.1f} ms {n:6d}x {kname[:110]}")
        for kname in sorted({k for k in by_name if "dw5x5" in k}):
            us, n = by_name[kname]
            say(f"[profile dw_conv] {us / busy:7.2%} of device time {us / 1e3:10.1f} ms {n:6d}x {kname[:110]}")

    small = {}
    for path, fn in (("kernel", model), ("plain", plain_fn)):
        small[path] = sample_scales(fn, sched, sizes_hw, batch_size=2,
                                    generator=torch.Generator(device="cuda").manual_seed(1), **walk)[-1]
    torch.cuda.synchronize()
    max_abs = (small["kernel"] - small["plain"]).abs().max().item()
    ok = max_abs <= 2e-3
    say(f"[check walk batch 2, kernel vs plain] final-scale max_abs {max_abs:.3e} (atol 2e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("walk through the kernels disagrees with the plain walk")

    # ---- 6. the guided path ----------------------------------------------------
    clip_model = random_clip_params(VIT_B_32, seed=0, device="cuda")
    pyramid = Pyramid(sizes_hw=tuple(sizes_hw), sizes_wh=tuple(sizes_wh), images=(), recon_images=(),
                      rescale_losses=BALLOONS_LOSSES, scale_factor=factor, n_scales=n_scales)
    guide_gen = torch.Generator(device="cuda").manual_seed(0)
    extractor = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, generator=guide_gen)
    n_chunks = N_AUG // extractor._chunk_size()
    mode_cfg = clip_mode_config("clip_content", "Fire in the Forest", STRENGTH, FILL_FACTOR, n_scales)

    cb.launches = 0
    dw.launches = 0
    ws.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_outs, g_aux = clip_sampling(model, sched, pyramid, extractor, sample_batch_size=BATCH,
                                  stop_guidance=STOP_GUIDANCE, reblurring=False, generator=guide_gen,
                                  device="cuda", **mode_cfg)
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_launches = {"conv_block": cb.launches, "dw_conv": dw.launches, **ws.launches}
    n_guided = tuple(0 if a is None else a["n_guided"] for a in g_aux)
    steps = sum(n_guided)
    g_expect = {**expect, **dict.fromkeys(ws.launches, 0), "winx_fwd": steps * n_chunks, "win_bwd": steps * n_chunks}
    say(f"[guided walk] clip_content strength {STRENGTH} fill_factor {FILL_FACTOR} batch {BATCH} dim {DIM} "
        f"ViT-B/32 (random, seed 0) n_aug {N_AUG} view_chunk {VIEW_CHUNK} fp32: n_guided {list(n_guided)} "
        f"guided_steps {steps} wall_s {g_wall:.3f} s_per_guided_step {(g_wall - wall) / steps:.4f} "
        f"(walk time above the un-guided walk's, a step) peak_GB {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"launches {g_launches}")
    if n_guided != (0, 52, 41, 31, 19):
        fail(f"n_guided {n_guided} != (0, 52, 41, 31, 19)")
    if g_launches != g_expect:
        fail(f"guided launch counts {g_launches} != expected {g_expect}")
    per_scale = {"wall_s": g_wall, "n_guided": n_guided, "launches": dict(g_launches)}
    for out, a, n_g, (h, w) in zip(g_outs, g_aux, n_guided, sizes_hw):
        if tuple(out.shape) != (BATCH, h, w, 3) or not bool(torch.isfinite(out).all()):
            fail(f"guided output at {h}x{w}: shape {tuple(out.shape)} or non-finite values")
        if out.abs().max().item() > 1.0 + 1e-5:
            fail(f"guided output at {h}x{w} leaves [-1, 1]: {out.abs().max().item()}")
        if a is not None:
            sc = a["clip_score"]
            if not (bool(torch.isfinite(sc).all()) and bool((sc[:n_g] != 0).all()) and not bool(sc[n_g:].any())):
                fail(f"clip_score at {h}x{w}: the first {n_g} rows must be scores, the rest zeros")
            say(f"[guided walk] scale {h}x{w}: clip_score first {sc[0, 0].item():.4f} last {sc[n_g - 1, 0].item():.4f}")

    # where a guided step's device time goes: four guided steps at the finest scale
    text_hr = extractor.get_text_embedding(mode_cfg["text_input"], ce.get_augmentations_template("hr"))
    hook_kw = dict(s=n_scales - 1, n_scales=n_scales, sub_iters=1, strength=STRENGTH,
                   quantile=1.0 - FILL_FACTOR, llambda=0.2)

    def guided_steps(n, ex=extractor):
        fn = cg.make_clip_guidance(ex, text_hr, stop_guidance=0, **hook_kw)
        with torch.no_grad():
            sample_via_scale(model, sched, g_outs[-1], s=n_scales - 1, total_t=n, reblurring=False,
                             generator=guide_gen, guidance_fn=fn,
                             guidance_carry=cg.init_clip_carry(BATCH, (h_fin, w_fin)))

    guided_steps(1)
    results["guided_step"] = profile_groups("profile guided", f"4 guided steps at {h_fin}x{w_fin}", "step", 4,
                                            lambda: guided_steps(4))

    # one guidance iteration (views, tower, backward) through each of the other
    # four forward kernels, against the same iteration through its plain
    # version (win3's: the same splits as matrix products, "mm_split3")
    x01 = (g_outs[-1].clamp(-1.0, 1.0) + 1.0) * 0.5
    draws = extractor.draw(BATCH, text_hr.shape[0])

    def iteration(impl, model_=clip_model):
        with torch.no_grad():
            out = ce.ClipExtractor(model_, n_aug=N_AUG, view_chunk=VIEW_CHUNK,
                                   warp_impl=impl).clip_loss_and_grad(x01, text_hr, draws)
        torch.cuda.synchronize()
        return out

    plain = {"mm": iteration("mm"), "mm_split3": iteration("mm_split3")}
    plain_ex = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, warp_impl="mm")
    for impl, variant in (("pallas_win", "win"), ("pallas_winb", "winb"), ("pallas_winx", "winx"),
                          ("pallas", "whole"), ("pallas_win3", "win3")):
        entry, adjoint = f"{variant}_fwd", f"{ws.ADJOINT[variant]}_bwd"
        ws.reset_launches()
        loss_k, grad_k = iteration(impl)
        want = {**dict.fromkeys(ws.launches, 0), entry: n_chunks, adjoint: n_chunks}
        if ws.launches != want:
            fail(f"--warp_impl {impl}: launches {ws.launches} != {want}")
        # the paths of the records: winx and win_bwd the guided walk, whole clip_roi (phase 7),
        # win, winb and win3 (with its adjoint) this iteration
        if variant in ("win", "winb", "win3"):
            g_launches[entry] = ws.launches[entry]
        if variant == "win3":
            g_launches[adjoint] = ws.launches[adjoint]
        plain_impl = "mm_split3" if variant == "win3" else "mm"
        ok, _, summary = iteration_check(f"check guidance iteration --warp_impl {impl} vs {plain_impl}", loss_k,
                                         grad_k, *plain[plain_impl], extra=f"launches {ws.launches} ")
        if not ok:
            fail(f"a guidance iteration through {impl} disagrees with its plain version: {summary}")
        if variant == "win3":
            # the split's own error, through the colour ops and the tower: a finding, bounded loosely
            _, cos, _ = iteration_check("finding: guidance iteration --warp_impl pallas_win3 vs exact mm", loss_k,
                                        grad_k, *plain["mm"])
            rel = abs(loss_k.item() - plain["mm"][0].item()) / abs(plain["mm"][0].item())
            results["win3_iteration"] = dict(loss_rel=rel, grad_cos=cos)
            if not (rel <= 1e-4 and cos >= 0.99):
                fail(f"win3's guidance iteration is off the exact one: loss {rel:.3e} relative, cosine {cos:.6f}")

    # two whole guided steps, the hook: kernel (winx, the default) against
    # plain. The first fixes the edit mask; the second, like every later step
    # of a walk, runs with that mask (the kernel path's, given to both).
    x_recon = g_outs[-1] + 0.05 * torch.randn(g_outs[-1].shape, generator=gen, device="cuda")

    def hook_step(t_step, carry, step_draws):
        out = {}
        for path, ex in (("kernel", extractor), ("plain", plain_ex)):
            fn = cg.make_clip_guidance(ex, text_hr, stop_guidance=STOP_GUIDANCE,
                                       draw_fn=lambda b, n: step_draws, **hook_kw)
            with torch.no_grad():
                out[path] = fn(x_recon, None, t_step, n_scales - 1, carry)
        torch.cuda.synchronize()
        (xk, ck, _), (xp, cp, _) = out["kernel"], out["plain"]
        diff = (xk - xp).abs()
        in_range = bool(torch.isfinite(xk).all()) and xk.abs().max().item() <= 1.0
        return xk, ck, xp, cp, share_over(diff, 1e-4), diff.max().item(), in_range

    def step_check(label, held, line):
        bad = [what for what, ok in held.items() if not ok]
        say(f"[check {label}, kernel vs plain] {line} {'FAIL: ' + ', '.join(bad) if bad else 'ok'}")
        if bad:
            fail(f"the {label} through the kernels disagrees with the plain warp: {', '.join(bad)}")

    xk, ck, xp, cp, over, worst, in_range = hook_step(10, cg.init_clip_carry(BATCH, (h_fin, w_fin)), draws)
    mask_off = (ck.mask != cp.mask).float().mean().item()
    covered = ck.mask.mean().item()
    x_in = x_recon.clamp(-1.0, 1.0)
    uk, up = (xk - x_in).reshape(BATCH, -1), (xp - x_in).reshape(BATCH, -1)
    cos = ((uk * up).sum(1) / (uk.norm(dim=1) * up.norm(dim=1))).min().item()
    step_check("first guided step", {
        f"mask differs at {mask_off:.3e} of pixels": mask_off <= 1e-3,
        f"covered share {covered:.4f}": ck.has_mask and abs(covered - FILL_FACTOR) <= 0.01,
        f"update cosine {cos:.6f}": cos >= GUIDE_COS,
        "x non-finite or outside [-1, 1]": in_range,
    }, f"mask differs at {mask_off:.3e} of pixels (<= 1e-3) covered share {covered:.4f} (fill factor "
       f"{FILL_FACTOR}) update cosine, least of a sample {cos:.9f} (>= {GUIDE_COS:g}); finding: x share "
       f"over 1e-4 {over:.3e} worst {worst:.3e}")
    _, _, _, _, over, worst, in_range = hook_step(9, ck, extractor.draw(BATCH, text_hr.shape[0]))
    step_check("guided step with the mask", {
        f"x share over 1e-4 {over:.3e}": over <= GUIDE_OUTLIERS,
        "x non-finite or outside [-1, 1]": in_range,
    }, f"x share over 1e-4 {over:.3e} (<= {GUIDE_OUTLIERS:g}) worst {worst:.3e}")

    # the bf16 vision tower (--clip_dtype bfloat16): the same weights, its
    # matrix products on the bf16 tensor cores; one guidance iteration against
    # the fp32 tower's, and a profile of guided steps
    bf16_model = random_clip_params(dataclasses.replace(VIT_B_32, compute_dtype="bfloat16"), seed=0, device="cuda")
    bf16_ex = ce.ClipExtractor(bf16_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, generator=guide_gen)
    loss_f, grad_f = iteration(None)
    loss_b, grad_b = iteration(None, bf16_model)
    rel = abs(loss_b.item() - loss_f.item()) / abs(loss_f.item())
    cos = ((grad_b * grad_f).sum() / (grad_b.norm() * grad_f.norm())).item()
    ok = bool(torch.isfinite(loss_b)) and bool(torch.isfinite(grad_b).all()) and rel <= 2e-2
    say(f"[check guidance iteration bf16 tower vs fp32 tower] loss {loss_b.item():.6f} vs {loss_f.item():.6f} "
        f"relative {rel:.3e} (<= 2e-2) gradient cosine {cos:.6f} max|g| {grad_b.abs().max().item():.3e} vs "
        f"{grad_f.abs().max().item():.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the bf16 tower's guidance iteration is not finite or its loss is off the fp32 tower's")
    results["bf16_tower"] = dict(loss_rel=rel, grad_cos=cos)
    guided_steps(1, bf16_ex)
    results["bf16_step"] = profile_groups("profile guided bf16", f"4 guided steps at {h_fin}x{w_fin}, bf16 tower",
                                          "step", 4, lambda: guided_steps(4, bf16_ex))
    del bf16_model, bf16_ex, grad_f, grad_b

    # ---- 7. the clip_roi path ----------------------------------------------------
    # a seeded image at each pyramid size (clip_roi edits the finest); the box is
    # a quarter of it, so its views are 224x298 as in phase 6
    roi_pyr = Pyramid(
        sizes_hw=tuple(sizes_hw), sizes_wh=tuple(sizes_wh),
        images=tuple((torch.rand((h, w, 3), generator=gen, device="cuda") * 2 - 1).cpu().numpy() for h, w in sizes_hw),
        recon_images=(), rescale_losses=BALLOONS_LOSSES, scale_factor=factor, n_scales=n_scales)
    roi_ex = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, warp_impl="pallas", generator=guide_gen)
    roi_text = "Fire in the Forest"
    cb.launches = 0
    dw.launches = 0
    ws.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roi_out, roi_scores, _ = clip_roi_sampling(
        model, sched, roi_pyr, roi_ex, text_input=roi_text, strength=ROI_STRENGTH, sample_batch_size=BATCH,
        num_clip_iters=ROI_ASCENT_ITERS, num_denoising_steps=ROI_DENOISING_STEPS, clip_roi_bb=ROI_BOX,
        generator=guide_gen, device="cuda")
    torch.cuda.synchronize()
    roi_wall = time.perf_counter() - t0
    roi_peak = torch.cuda.max_memory_allocated() / 1e9
    r_launches = {"conv_block": cb.launches, "dw_conv": dw.launches, **ws.launches}
    r_expect = {"conv_block": ROI_DENOISING_STEPS * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": ROI_DENOISING_STEPS * 4,
                **dict.fromkeys(ws.launches, 0), "whole_fwd": ROI_ASCENT_ITERS * n_chunks,
                "whole_bwd": ROI_ASCENT_ITERS * n_chunks}
    say(f"[clip_roi walk] box {ROI_BOX} of {h_fin}x{w_fin} batch {BATCH} dim {DIM} ViT-B/32 (random, seed 0) n_aug "
        f"{N_AUG} view_chunk {VIEW_CHUNK} --warp_impl pallas fp32: {ROI_ASCENT_ITERS} ascent iterations + "
        f"{ROI_DENOISING_STEPS} denoising steps wall_s {roi_wall:.3f} s_per_iteration {roi_wall / ROI_ASCENT_ITERS:.4f} "
        f"(the walk's wall over its iterations) peak_GB {roi_peak:.2f} score first {roi_scores[0].item():.4f} last "
        f"{roi_scores[-1].item():.4f} launches {r_launches}")
    if r_launches != r_expect:
        fail(f"clip_roi launch counts {r_launches} != expected {r_expect}")
    if tuple(roi_out.shape) != (BATCH, h_fin, w_fin, 3) or not bool(torch.isfinite(roi_out).all()):
        fail(f"clip_roi output: shape {tuple(roi_out.shape)} or non-finite values")
    if roi_out.abs().max().item() > 1.0 + 1e-5:
        fail(f"clip_roi output leaves [-1, 1]: {roi_out.abs().max().item()}")
    if tuple(roi_scores.shape) != (ROI_ASCENT_ITERS,) or not bool(torch.isfinite(roi_scores).all()):
        fail(f"clip_roi score trace: shape {tuple(roi_scores.shape)} or non-finite values")
    g_launches["whole_fwd"], g_launches["whole_bwd"] = r_launches["whole_fwd"], r_launches["whole_bwd"]

    # one ascent iteration through kernels 3-4 against the plain warp, on the box
    y, x, h, w = ROI_BOX
    finest = torch.as_tensor(roi_pyr.images[-1], device="cuda")
    patch = finest[None, y : y + h, x : x + w].expand(BATCH, h, w, 3).contiguous()
    text_lr = roi_ex.get_text_embedding(roi_text, ce.get_augmentations_template("lr"))
    roi_draws = roi_ex.draw(BATCH, text_lr.shape[0])
    with torch.no_grad():
        roi_k = roi_ex.clip_loss_and_grad((patch + 1) * 0.5, text_lr, roi_draws)
        roi_p = plain_ex.clip_loss_and_grad((patch + 1) * 0.5, text_lr, roi_draws)
    torch.cuda.synchronize()
    ok, _, summary = iteration_check("check clip_roi ascent iteration --warp_impl pallas vs mm", *roi_k, *roi_p)
    if not ok:
        fail(f"a clip_roi ascent iteration through kernels 3-4 disagrees with the plain warp: {summary}")
    _clip_roi_ascent(roi_ex, patch, text_lr, 1, ROI_STRENGTH)
    results["roi_iteration"] = profile_groups(
        "profile clip_roi", f"3 ascent iterations on the {h}x{w} box", "iteration", 3,
        lambda: _clip_roi_ascent(roi_ex, patch, text_lr, 3, ROI_STRENGTH))
    del patch, roi_k, roi_p

    # ---- 8. training -----------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the trainer's own scope keeps its steps fp32
    results["train"] = train_phase(results)
    torch.backends.cudnn.allow_tf32 = False

    # ---- 9. image-to-image and ROI -----------------------------------------------
    results["i2i_roi"] = i2i_roi_phase()

    # ---- 10. the bucketed guided walk ----------------------------------------------
    results["bucketed"] = bucketed_phase(model, sched, pyramid, clip_model, mode_cfg, per_scale)

    # ---- 11. the mesh ---------------------------------------------------------------
    torch.cuda.empty_cache()
    results["mesh"] = mesh_phase()

    # ---- 12. the dot-formulated denoiser executor -------------------------------------
    results["dot"] = dot_phase(model, sched, sizes_hw, walk, small["kernel"], gen)

    # ---- records ---------------------------------------------------------------
    replaces = {
        "conv_block": "sinddm_tpu/ops/pallas_conv.py:234",
        "dw_conv": "sinddm_tpu/ops/pallas_dw.py:93",
    }
    kernels = []
    for kname, err_key in (("conv_block", "conv_block_err"), ("dw_conv", "dw_err")):
        r = results[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"sinddm_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": results[err_key], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            **({"cudnn_3x3_products_ms": r["cudnn_3x3_products_ms"]} if kname == "conv_block" else {}),
        })
    for entry, where in WARP_REPLACES.items():
        r = results["warp"][entry]
        kernels.append({
            "name": f"warp_{entry}", "route": "cuda", "source": "sinddm_tpu_torch/csrc/warp_sample.cu",
            "replaces": where, "launches": g_launches[entry],
            "max_abs_err": results["warp_err"][entry], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "kernel_alone_ms": r["kernel_alone_ms"],
        })
    # the paths' record: walk times, device time by group a guided step or an
    # ascent iteration (ms), and the reduced-precision findings
    say("[paths] " + json.dumps({
        "sample_walk_s": wall, "clip_content_walk_s": g_wall, "clip_roi_walk_s": roi_wall,
        "clip_roi_s_per_iteration": roi_wall / ROI_ASCENT_ITERS, "clip_roi_peak_GB": roi_peak,
        "guided_step_fp32": results["guided_step"], "guided_step_bf16": results["bf16_step"],
        "clip_roi_iteration": results["roi_iteration"], "bf16_tower_vs_fp32": results["bf16_tower"],
        "win3_vs_exact": results["win3_vs_exact"], "win3_iteration_vs_exact": results["win3_iteration"],
        "warp_adjoints_256_views": results["warp_256_views"], "train": results["train"],
        "i2i_roi": results["i2i_roi"], "bucketed": results["bucketed"], "mesh": results["mesh"],
        "dot": results["dot"],
    }))
    say(f"[done] total_s {time.perf_counter() - t_start:.1f}")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--train-worker"]:
        train_worker(sys.argv[2:])
    else:
        main()
