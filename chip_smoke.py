#!/usr/bin/env python3
"""Drive the PyTorch port, ``sinddm_tpu_torch``, on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``, and imports nothing of JAX or of ``sinddm_tpu``. Phases,
each of which exits non-zero when it fails:

1. identify the card; turn TF32 off so the plain versions are true fp32;
2. build the CUDA kernels from ``sinddm_tpu_torch/csrc`` for sm_90a;
3. hold each kernel against its plain version at the main path's shapes
   (the four dim=160 blocks at 16x186x248, fp32 and bf16; the four view-warp
   kernels at 16 images x 8 views of 224x298 from 186x248x3, value and image
   gradient) and at ragged shapes (1x19x21; a 300-row source);
4. time each kernel with CUDA events beside its bound, its plain version
   and, where there is one, the one PyTorch call that computes it
   (``F.conv2d`` with groups, ``F.grid_sample``);
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
   the other two warp kernels, and one whole guided step, against the same
   computation through the plain warp.

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
  * one guidance iteration (warp, colour ops, ViT-B/32 forward and backward)
    through a warp kernel against the same through the plain warp: gradient
    within GUIDE_TOL of max |gradient| for all but GUIDE_OUTLIERS of the
    elements and within GUIDE_WORST of it everywhere. The views differ by
    ~1e-7; the tower carries that to the gradient, and a view pixel that
    close to a kink of the colour ops (a clip bound, a hue sector edge)
    takes the other branch, which moves the four source pixels under it;
  * one whole guided step (the hook): x within 1e-4 absolute for all but
    GUIDE_OUTLIERS of the elements (the same kinks), the mask equal except
    at most 0.1% of the pixels (an energy within rounding of the quantile).
"""

from __future__ import annotations

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
GUIDE_TOL, GUIDE_OUTLIERS, GUIDE_WORST = 1e-5, 1e-3, 5e-2
WARP_REPLACES = {  # C entry -> the TPU kernel's pallas_call
    "win_fwd": "sinddm_tpu/ops/pallas_warp.py:402",
    "winx_fwd": "sinddm_tpu/ops/pallas_warp.py:546",
    "winb_fwd": "sinddm_tpu/ops/pallas_warp.py:641",
    "win_bwd": "sinddm_tpu/ops/pallas_warp.py:441",
}

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


def warp_work(b, n, h, w, c, adjoint):
    """FLOPs and bytes one warp launch must do: coords read, the source read
    and the samples written (forward), or the cotangent read and the image
    gradient zeroed and written (adjoint)."""
    img_bytes = 4 * b * h * w * c
    nbytes = b * n * (8 + 4 * c) + (2 * img_bytes if adjoint else img_bytes)
    flops = b * n * (12 + 8 * c)  # two hat rows a pixel, four weighted taps a channel
    return flops, nbytes


def plain_warp(img, coords, fill):
    """The plain version at the kernels' batching: bilinear_sample_mm an image."""
    from sinddm_tpu_torch.ops.warp import bilinear_sample_mm

    return torch.stack([bilinear_sample_mm(img[b], coords[b], fill) for b in range(img.shape[0])])


def grid_sample_inputs(img, coords):
    """The same sampling as one ``F.grid_sample`` call (fill 0): NCHW input,
    all views of an image as one tall grid, coordinates normalised for
    align_corners=True."""
    b, h, w, c = img.shape
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=img.device)
    grid = coords.reshape(b, -1, coords.shape[-2], 2) * scale - 1.0
    return img.permute(0, 3, 1, 2).contiguous(), grid.contiguous()


def share_over(diff, tol):
    return (diff > tol).float().mean().item()


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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (ROOT / "sinddm_tpu_torch" / "csrc").is_dir():
        fail(f"run from the root of a checkout: {ROOT / 'sinddm_tpu_torch'} is missing")
    sys.path.insert(0, str(ROOT))

    from sinddm_tpu_torch.apps.clip_apps import clip_mode_config, clip_sampling
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
    warp_cases = (("main", warp_img, view_coords(0, VIEW_CHUNK), 1.0),
                  ("ragged", tall, torch.stack([spread, rotated])[None], 0.5))
    results["warp_err"] = {}
    for case, img, coords, fill in warp_cases:
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
                results["warp_err"][f"{variant}_fwd"] = v_err
                results["warp_err"]["win_bwd"] = max(results["warp_err"].get("win_bwd", 0.0), g_err)
        del ct, x_ref, ref, g_ref

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
        timed.append(("win_bwd", lambda: ws.warp_adjoint(ct, coords3, warp_img.shape), plain_b, lib_b))
        for entry, run, p_ms, l_ms in timed:
            with torch.no_grad():
                k_ms = time_ms(run, reps=20)
            flops, nbytes = warp_work(BATCH, n_px, h_fin, w_fin, 3, adjoint=entry == "win_bwd")
            b_ms, b_by = bound(flops, nbytes, peaks["fp32"], peaks["mem"])
            say(f"[time warp {entry} {shape}] kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
                f"MFLOP {flops / 1e6:.1f} MB {nbytes / 1e6:.1f} bound_ms {b_ms:.4f} ({b_by}) GB/s {nbytes / k_ms / 1e6:.1f}")
            if n_views == VIEW_CHUNK:
                results["warp"][entry] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                                              bound_by=b_by, shape=shape)
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
    g_expect = {**expect, "win_fwd": 0, "winx_fwd": steps * n_chunks, "winb_fwd": 0, "win_bwd": steps * n_chunks}
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

    def guided_steps(n):
        fn = cg.make_clip_guidance(extractor, text_hr, stop_guidance=0, **hook_kw)
        with torch.no_grad():
            sample_via_scale(model, sched, g_outs[-1], s=n_scales - 1, total_t=n, reblurring=False,
                             generator=guide_gen, guidance_fn=fn,
                             guidance_carry=cg.init_clip_carry(BATCH, (h_fin, w_fin)))

    guided_steps(1)
    prof = profile_walk(lambda: guided_steps(4))
    if prof is None:
        say("[profile guided] torch.profiler recorded no device activity: breakdown not measured")
    else:
        by_name, busy, window = prof
        groups = {"warp forward": 0.0, "warp adjoint": 0.0, "denoiser conv kernels": 0.0,
                  "matrix products (tower)": 0.0, "other (elementwise, softmax, norms, sort)": 0.0}
        for kname, (us, _) in by_name.items():
            low = kname.lower()
            key = ("warp adjoint" if "warp_win_bwd" in low else
                   "warp forward" if "warp_win" in low else
                   "denoiser conv kernels" if "sinddm" in low else
                   "matrix products (tower)" if any(t in low for t in ("gemm", "cutlass", "gemv", "cublas")) else
                   "other (elementwise, softmax, norms, sort)")
            groups[key] += us
        say(f"[profile guided] 4 guided steps at {h_fin}x{w_fin}: device busy_ms {busy / 1e3:.1f} kernel-window_ms "
            f"{window / 1e3:.1f} idle_share {1 - busy / window:.4f} kernels {sum(n for _, n in by_name.values())}")
        for gname, us in groups.items():
            say(f"[profile guided] {us / busy:7.2%} {us / 4e3:10.2f} ms/step  {gname}")
        for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            say(f"[profile guided] {us / busy:7.2%} {us / 1e3:10.1f} ms {n:6d}x {kname[:110]}")

    # one guidance iteration (views, tower, backward) through each of the other
    # two forward kernels, against the same iteration through the plain warp
    x01 = (g_outs[-1].clamp(-1.0, 1.0) + 1.0) * 0.5
    draws = extractor.draw(BATCH, text_hr.shape[0])
    plain_ex = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK, warp_impl="mm")
    with torch.no_grad():
        loss_p, grad_p = plain_ex.clip_loss_and_grad(x01, text_hr, draws)
    g_max = grad_p.abs().max().item()
    for impl, entry in (("pallas_win", "win_fwd"), ("pallas_winb", "winb_fwd"), ("pallas_winx", "winx_fwd")):
        ws.reset_launches()
        with torch.no_grad():
            loss_k, grad_k = ce.ClipExtractor(clip_model, n_aug=N_AUG, view_chunk=VIEW_CHUNK,
                                              warp_impl=impl).clip_loss_and_grad(x01, text_hr, draws)
        torch.cuda.synchronize()
        want = {**dict.fromkeys(ws.launches, 0), entry: n_chunks, "win_bwd": n_chunks}
        if ws.launches != want:
            fail(f"--warp_impl {impl}: launches {ws.launches} != {want}")
        if entry != "winx_fwd":  # winx's and the adjoint's counts are the guided walk's
            g_launches[entry] = ws.launches[entry]
        diff = (grad_k - grad_p).abs()
        over, worst = share_over(diff, GUIDE_TOL * g_max), diff.max().item()
        ok = over <= GUIDE_OUTLIERS and worst <= GUIDE_WORST * g_max and abs(loss_k.item() - loss_p.item()) <= 1e-4
        say(f"[check guidance iteration --warp_impl {impl} vs plain] loss {loss_k.item():.6f} vs {loss_p.item():.6f} "
            f"grad: median |diff| {diff.median().item():.3e} share over {GUIDE_TOL:g}*max|g| {over:.3e} "
            f"(<= {GUIDE_OUTLIERS:g}) worst {worst:.3e} of max|g| {g_max:.3e} (<= {GUIDE_WORST:g}*max|g|) "
            f"launches {ws.launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"a guidance iteration through {impl} disagrees with the plain warp")

    # one whole guided step, the hook: kernel (winx, the default) against plain
    x_recon = g_outs[-1] + 0.05 * torch.randn(g_outs[-1].shape, generator=gen, device="cuda")
    hook = {}
    for path, ex in (("kernel", extractor), ("plain", plain_ex)):
        fn = cg.make_clip_guidance(ex, text_hr, stop_guidance=STOP_GUIDANCE, draw_fn=lambda b, n: draws, **hook_kw)
        with torch.no_grad():
            hook[path] = fn(x_recon, None, 10, n_scales - 1, cg.init_clip_carry(BATCH, (h_fin, w_fin)))
    torch.cuda.synchronize()
    (xk, ck, _), (xp, cp, _) = hook["kernel"], hook["plain"]
    diff = (xk - xp).abs()
    over, worst = share_over(diff, 1e-4), diff.max().item()
    mask_off = (ck.mask != cp.mask).float().mean().item()
    covered = ck.mask.mean().item()
    ok = (over <= GUIDE_OUTLIERS and mask_off <= 1e-3 and ck.has_mask and abs(covered - FILL_FACTOR) <= 0.01
          and bool(torch.isfinite(xk).all()) and xk.abs().max().item() <= 1.0)
    say(f"[check guided step, kernel vs plain] x share over 1e-4 {over:.3e} (<= {GUIDE_OUTLIERS:g}) worst {worst:.3e} "
        f"mask differs at {mask_off:.3e} of pixels (<= 1e-3) covered share {covered:.4f} "
        f"(fill factor {FILL_FACTOR}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("a guided step through the kernels disagrees with the plain warp")

    # ---- 7. records -----------------------------------------------------------
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
            "shape": r["shape"],
        })
    say(f"[done] total_s {time.perf_counter() - t_start:.1f}")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
