#!/usr/bin/env python3
"""Drive the PyTorch port, ``sinddm_tpu_torch``, on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``, and imports nothing of JAX or of ``sinddm_tpu``. Phases,
each of which exits non-zero when it fails:

1. identify the card; turn TF32 off so the plain versions are true fp32;
2. build both CUDA kernels from ``sinddm_tpu_torch/csrc`` for sm_90a;
3. hold each kernel against its plain version at the main path's shapes
   (the four dim=160 blocks at 16x186x248, fp32 and bf16) and at a ragged
   1x19x21 shape;
4. time each kernel with CUDA events beside its bound, its plain version
   and, for the depthwise kernel, the one PyTorch call that computes it;
5. sample the full 5-scale balloons pyramid at dim=160, batch 16, fp32,
   with seeded random weights, through the kernels: check shapes, finite
   values and the launch counts; profile a second walk (device time by
   kernel, idle share); compare one finest-scale denoiser call, and a
   batch-2 walk, with the plain path.

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
  * batch-2 walk, 246 chained denoiser calls: 2e-3 absolute on [-1, 1].
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

    from sinddm_tpu_torch.apps.sampling import sample_scales
    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.ops import _build, conv_block as cb, dw_conv as dw
    from sinddm_tpu_torch.pyramid import compute_pyramid_geometry
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

    # ---- 6. records -----------------------------------------------------------
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
    say(f"[done] total_s {time.perf_counter() - t_start:.1f}")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
