#!/usr/bin/env python3
"""Drive the PyTorch port, ``sinddm_tpu_torch``, on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``, and imports nothing of JAX or of ``sinddm_tpu``. Phases,
each of which exits non-zero when it fails:

1. identify the card; turn TF32 off so the plain versions are true fp32;
2. build the CUDA kernels from ``sinddm_tpu_torch/csrc`` for sm_90a;
3. hold each kernel against its plain version at the main path's shapes
   (the four dim=160 blocks at 16x186x248, fp32 and bf16; the eight view-warp
   kernels at 16 images x 8 views of 224x298 from 186x248x3, value and image
   gradient; win3 also against the exact warp) and at ragged shapes
   (1x19x21; a 300-row source), and, for the run kernels (win, winx, win3)
   and the others alike, one launch that mixes views with coords scattered
   over the whole source (so the whole-image adjoint takes both its
   shared-memory box and its direct branch: checked from its patch plan),
   flat coords, and 37x45 frames;
4. time each kernel with CUDA events beside its bound, its plain version
   and, where there is one, the one PyTorch call that computes it
   (``F.conv2d`` with groups, ``F.grid_sample``; for win3 the library call
   computes the exact warp, not the split one); win, winx, win3 and the
   whole-image adjoint also as the kernel alone (their C entry, no wrapper);
   print the whole-image adjoint's patch plan (patches that sum in the
   shared-memory box or scatter directly, global atomics of each); check
   with torch.profiler that the win3 entry is one launch;
5. sample the full 5-scale balloons pyramid at dim=160, batch 16, fp32,
   with seeded random weights, through the kernels: check shapes, finite
   values and the launch counts; profile a second walk (device time by
   kernel, idle share); compare one finest-scale denoiser call, and a
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
   one ascent iteration against the plain warp; profile a few iterations.

The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.

Tolerances (max |kernel - plain| against the plain version's values):
  * fp32 conv block: atol 2e-4 + rtol 2e-4 per element -- the kernel sums
    the same fp32 products in another order than cuDNN;
  * bf16 conv block: max error <= 2e-2 of max |plain| -- both round h1, g
    and the output to bf16, and a sum-order difference can flip a rounding;
  * depthwise (fp32) against a float64 plain version: atol 1e-5, the bound
    the JAX package holds its TPU kernel to;
  * finest-scale denoiser call (four blocks chained): 1e-4 of max |plain|;
  * batch-2 walk, 246 chained denoiser calls: 2e-3 absolute on [-1, 1];
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
    gradients' cosine is printed, not bounded.
"""

from __future__ import annotations

import dataclasses
import json
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
ROI_BOX = (48, 64, 96, 128)  # y x h w: a quarter of the 186x248 image, views of 224x298

# Dense peak rates (NVIDIA data sheets): fp32 SIMT, TF32 and bf16 tensor
# cores in FLOP/s, device memory in B/s.
PEAKS = {
    "SXM": dict(fp32=67e12, tf32=495e12, bf16=989e12, mem=3.35e12),
    "PCIe": dict(fp32=51e12, tf32=378e12, bf16=756e12, mem=2.0e12),
}


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


def block_work(b, h, w, c, co, itemsize):
    """FLOPs and bytes one conv block must do (inputs read once, output written once)."""
    proj = c != co
    px = b * h * w
    flops = 2 * px * (25 * c + 9 * c * co + 9 * co * co + (c * co if proj else 0))
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
    checks, copies and allocation: the kernel alone. ``entry`` is a run
    forward (``win_fwd``, ``winx_fwd``, ``win3_fwd``; fill ``fill``) or
    ``whole_bwd`` (cotangent ``ct``, frames as wide as ``coords``' last sample
    axis). Fails unless a first launch returns success."""
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
    peaks = PEAKS["PCIe" if "PCIe" in kind else "SXM"]
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

    for shape in ((BATCH, h_fin, w_fin, DIM), (BATCH, h_fin, w_fin, DIM // 2), (1,) + RAGGED_HW + (3,)):
        x = torch.randn(shape, generator=gen, device="cuda")
        wdw = torch.randn((5, 5, shape[-1]), generator=gen, device="cuda") * 0.2
        bias = torch.randn((shape[-1],), generator=gen, device="cuda") * 0.1
        out = dw.depthwise_conv5x5(x, wdw, bias)
        ref = dw.depthwise_conv5x5_reference(x.double(), wdw.double(), bias.double())
        torch.cuda.synchronize()
        _, max_abs, rel = err_stats(out, ref)
        ok = max_abs <= 1e-5
        say(f"[check dw_conv fp32 {'x'.join(map(str, shape))}] max_abs {max_abs:.3e} vs float64 "
            f"(atol 1e-5) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("dw_conv disagrees with its float64 plain version")
        if shape[-1] == DIM:
            results["dw_err"] = max_abs
        del x, out, ref

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
    # the run kernels' (winx, win3) other cases: one launch with views and
    # coords scattered over the whole source; flat coords; 37x45 frames, where
    # a run of 1024 samples ends inside an image
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
        say(f"[plan warp whole_bwd {case}] {patch_plan(plan)}")
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
    for dtype, dname, rate in ((torch.float32, "fp32", peaks["fp32"]), (torch.bfloat16, "bf16", peaks["bf16"])):
        for bname, c, co in BLOCKS:
            args = block_inputs(gen, BATCH, h_fin, w_fin, c, co, dtype)
            k_ms = time_ms(lambda: cb.conv_block(*args), reps=10)
            p_ms = time_ms(lambda: cb.conv_block_reference(*args), reps=5)
            flops, nbytes = block_work(BATCH, h_fin, w_fin, c, co, args[0].element_size())
            b_ms, b_by = bound(flops, nbytes, rate, peaks["mem"])
            tf32_ms = flops / peaks["tf32"] * 1e3
            say(f"[time conv_block {dname} {bname} {BATCH}x{h_fin}x{w_fin} {c}->{co}] kernel_ms {k_ms:.4f} "
                f"plain_ms {p_ms:.4f} GFLOP {flops / 1e9:.2f} GB {nbytes / 1e9:.4f} bound_ms {b_ms:.4f} "
                f"({b_by}) TF32_bound_ms {tf32_ms:.4f} TFLOP/s {flops / k_ms / 1e9:.2f}")
            if (dname, bname) == ("fp32", "l3"):
                results["conv_block"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                             shape=f"{BATCH}x{h_fin}x{w_fin}x{c}->{co} fp32")
            del args

    x = torch.randn((BATCH, h_fin, w_fin, DIM), generator=gen, device="cuda")
    wdw = torch.randn((5, 5, DIM), generator=gen, device="cuda") * 0.2
    bias = torch.randn((DIM,), generator=gen, device="cuda") * 0.1
    w_lib = wdw.permute(2, 0, 1)[:, None].contiguous()
    x_lib = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    k_ms = time_ms(lambda: dw.depthwise_conv5x5(x, wdw, bias), reps=20)
    p_ms = time_ms(lambda: dw.depthwise_conv5x5_reference(x, wdw, bias), reps=20)
    l_ms = time_ms(lambda: F.conv2d(x_lib, w_lib, bias, padding=2, groups=DIM), reps=20)
    n_el = x.numel()
    flops, nbytes = 2 * 25 * n_el, 4 * (2 * n_el + 26 * DIM)
    b_ms, b_by = bound(flops, nbytes, peaks["fp32"], peaks["mem"])
    say(f"[time dw_conv fp32 {BATCH}x{h_fin}x{w_fin}x{DIM}] kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
        f"library_ms {l_ms:.4f} GFLOP {flops / 1e9:.2f} GB {nbytes / 1e9:.4f} bound_ms {b_ms:.4f} ({b_by}) "
        f"GB/s {nbytes / k_ms / 1e6:.1f}")
    results["dw_conv"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                              shape=f"{BATCH}x{h_fin}x{w_fin}x{DIM} fp32")
    del x, x_lib

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
        timed += [(f"{a}_bwd", (lambda a=a: ws.warp_adjoint(ct, coords3, warp_img.shape, a, frame[1])), plain_b,
                   lib_b) for a in ("whole", "win")]
        if n_views == VIEW_CHUNK:  # win3 beside its own plain version, at one launch of the path
            x_s3 = warp_img.clone().requires_grad_(True)
            out_s3 = plain_warp(x_s3, coords, 1.0, ws.bilinear_sample_split3)
            with torch.no_grad():
                plain3_f = time_ms(lambda: plain_warp(warp_img, coords, 1.0, ws.bilinear_sample_split3), reps=2, warm=1)
            plain3_b = time_ms(lambda: torch.autograd.grad(out_s3, x_s3, ct, retain_graph=True), reps=2, warm=1)
            del x_s3, out_s3
            timed += [("win3_fwd", lambda: ws.bilinear_sample_pallas_win3(warp_img, coords, 1.0), plain3_f, lib_f),
                      ("win3_bwd", lambda: ws.warp_adjoint(ct, coords3, warp_img.shape, "win3"), plain3_b, lib_b)]
        for entry, run, p_ms, l_ms in timed:
            with torch.no_grad():
                k_ms = time_ms(run, reps=20)
            flops, nbytes = warp_work(BATCH, n_px, h_fin, w_fin, 3, adjoint=entry.endswith("_bwd"),
                                      split3=entry.startswith("win3"))
            b_ms, b_by = bound(flops, nbytes, peaks["fp32"], peaks["mem"])
            alone = ""
            if entry == "whole_bwd" or (entry.endswith("_fwd") and entry[:-4] in ws.RUN_KERNELS):
                alone_ms = time_ms(run_kernel(_build, entry, warp_img, coords, 1.0, ct), reps=20)  # its C entry
                alone = f"kernel_alone_ms {alone_ms:.4f} "
            say(f"[time warp {entry} {shape}] kernel_ms {k_ms:.4f} {alone}plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
                f"MFLOP {flops / 1e6:.1f} MB {nbytes / 1e6:.1f} bound_ms {b_ms:.4f} ({b_by}) share of the bound "
                f"{b_ms / k_ms:.3f} GB/s {nbytes / k_ms / 1e6:.1f}")
            if n_views == VIEW_CHUNK:
                results["warp"][entry] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                                              bound_by=b_by, shape=shape)
                if alone:
                    results["warp"][entry]["kernel_alone_ms"] = alone_ms
        plan = ws.whole_adjoint_patches(coords3, frame[1], (h_fin, w_fin), 3)
        say(f"[plan warp whole_bwd {shape}] {patch_plan(plan)}")
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
    walk_flops = sum(  # four blocks and the final 1x1 conv per denoiser call
        t_n * (sum(block_work(BATCH, h, w, c, co, 4)[0] for _, c, co in BLOCKS)
               + 2 * BATCH * h * w * (DIM // 2) * 3)
        for t_n, (h, w) in zip(sched.num_timesteps_ideal, sizes_hw)
    )
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

    # ---- 8. records -----------------------------------------------------------
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
        })
    for entry, where in WARP_REPLACES.items():
        r = results["warp"][entry]
        kernels.append({
            "name": f"warp_{entry}", "route": "cuda", "source": "sinddm_tpu_torch/csrc/warp_sample.cu",
            "replaces": where, "launches": g_launches[entry],
            "max_abs_err": results["warp_err"][entry], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], **({"kernel_alone_ms": r["kernel_alone_ms"]} if "kernel_alone_ms" in r else {}),
        })
    # the paths' record: walk times, device time by group a guided step or an
    # ascent iteration (ms), and the reduced-precision findings
    say("[paths] " + json.dumps({
        "sample_walk_s": wall, "clip_content_walk_s": g_wall, "clip_roi_walk_s": roi_wall,
        "clip_roi_s_per_iteration": roi_wall / ROI_ASCENT_ITERS, "clip_roi_peak_GB": roi_peak,
        "guided_step_fp32": results["guided_step"], "guided_step_bf16": results["bf16_step"],
        "clip_roi_iteration": results["roi_iteration"], "bf16_tower_vs_fp32": results["bf16_tower"],
        "win3_vs_exact": results["win3_vs_exact"], "win3_iteration_vs_exact": results["win3_iteration"],
    }))
    say(f"[done] total_s {time.perf_counter() - t_start:.1f}")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
