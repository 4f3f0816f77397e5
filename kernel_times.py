#!/usr/bin/env python3
"""Time the port's depthwise kernel and its three warp adjoint kernels on
one NVIDIA card, through their public wrappers.

    python3 kernel_times.py [--root CHECKOUT] [--reps N]

``--root`` is the root of the checkout whose ``sinddm_tpu_torch`` is timed
(default: this file's directory). The wrappers it calls,
``depthwise_conv5x5`` and ``warp_adjoint``, take the same arguments in every
version of the port since the adjoints took frames, so two checkouts (a
change and its parent, each unpacked with ``git archive``) can be timed in
turns, parent / change / change / parent, on one card.

It times each call two ways, after two warm calls: ``ms``, CUDA events
around ``--reps`` back-to-back calls (the stream's time, which holds the
host's launch gaps where a call is shorter than its launch), and
``device_ms``, the device time of what the calls launched (the activity
``torch.profiler`` records on the card), a call:

* ``depthwise_conv5x5`` at each call of the batch-16 balloons walk, its 5
  scales from 48x64 to 186x248 with C = 3 / 80 / 160 and the conv block's
  per-batch vector, fp32 and bf16, beside its bytes bound (each input read
  once, the output written once, at the card's memory rate);
* ``warp_adjoint`` with the ``win``, the ``whole`` and the ``win3`` kernel
  (kernels 6, 4 and 10) at the guided path's launch (16 images 186x248x3, 8 views of 224x298 an image, views
  drawn and warped as the guidance draws them) and with all 16 views of a
  step in one launch.

It needs ``nvcc`` and a card, imports nothing of JAX, and prints one JSON
object as its last line: ``{"card": ..., "root": ..., "dw_conv": {...},
"warp_adjoint": {...}}``, milliseconds by call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

BATCH, DIM = 16, 160
SCALES_HW = [(48, 64), (67, 90), (94, 126), (133, 177), (186, 248)]  # the balloons pyramid
HW = SCALES_HW[-1]
N_AUG, VIEW_CHUNK = 16, 8
MEM_RATE = {"SXM": 3.35e12, "PCIe": 2.0e12}  # B/s, NVIDIA data sheets


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


def device_ms(fn, reps: int) -> float:
    """Device time a call of ``fn``: its kernels' durations (torch.profiler,
    CUDA activity) over ``reps`` calls, without the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        sys.exit("kernel_times: torch.profiler recorded no device activity")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: torch.cuda.is_available() is False: this script needs a CUDA card")
    root = args.root.resolve()
    if not (root / "sinddm_tpu_torch" / "csrc").is_dir():
        sys.exit(f"kernel_times: {root} is not the root of a checkout of the port")
    sys.path.insert(0, str(root))
    from sinddm_tpu_torch.guidance import clip_extractor as ce
    from sinddm_tpu_torch.ops import _build, dw_conv as dw, warp as wp, warp_sample as ws

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    mem_rate = MEM_RATE["PCIe" if "PCIe" in torch.cuda.get_device_name(0) else "SXM"]
    _build.build()
    print(f"[card] {card} | root {root} | torch {torch.__version__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"card": card, "root": str(root), "dw_conv": {}, "warp_adjoint": {}}

    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for (h, w), c in [(hw, c) for hw in SCALES_HW for c in (3, DIM // 2, DIM)]:
            def n(*shape, scale=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

            x, wdw, bias, vec = n(BATCH, h, w, c), n(5, 5, c, scale=0.2), n(c, scale=0.1), n(BATCH, c, scale=0.2)
            call = lambda: dw.depthwise_conv5x5(x, wdw, bias, vec)  # noqa: E731
            ms, dev = time_ms(call, args.reps), device_ms(call, args.reps)
            bound_ms = x.element_size() * (2 * x.numel() + 26 * c + BATCH * c) / mem_rate * 1e3
            key = f"{BATCH}x{h}x{w}x{c} {dname} +vec"
            record["dw_conv"][key] = {"ms": ms, "device_ms": dev, "bound_ms": bound_ms}
            print(f"[time dw_conv {key}] ms {ms:.4f} device_ms {dev:.4f} bound_ms {bound_ms:.4f} "
                  f"share of the bound {bound_ms / dev:.3f}", flush=True)

    frame = ce.resize_output_size(*HW)
    draws = ce.draw_view_params(BATCH, N_AUG, gen, "cuda")
    img_shape = (BATCH, *HW, 3)
    for n_views in (VIEW_CHUNK, N_AUG):
        m = ce.view_matrices(draws.views(0, n_views), range(n_views), HW, frame)
        coords3 = wp.homography_coords(m, frame).reshape(BATCH, -1, 2)
        ct = torch.randn(coords3.shape[:-1] + (3,), generator=gen, device="cuda")
        for variant in ("win", "whole", "win3"):
            call = lambda: ws.warp_adjoint(ct, coords3, img_shape, variant, frame[1])  # noqa: E731
            ms, dev = time_ms(call, args.reps), device_ms(call, args.reps)
            key = f"{variant} {n_views} views"
            record["warp_adjoint"][key] = {"ms": ms, "device_ms": dev}
            print(f"[time warp_adjoint {key} of {frame[0]}x{frame[1]}, img {'x'.join(map(str, img_shape))}] "
                  f"ms {ms:.4f} device_ms {dev:.4f}", flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
