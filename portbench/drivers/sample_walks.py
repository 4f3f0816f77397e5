"""Traffic driver: back-to-back pyramid walks (``--mode sample``), one
caller who waits for each batch.

A unit is one walk of ``batch`` images through the program's
``apps/sampling.py`` ``sample_scales`` (kernels 1-2 on the card), its noise
drawn through ``noise_fn`` from a device generator seeded for that walk,
and ends in a synchronize. The check draws one walk of the window from the
seed, frees the program, runs the plain reference walk on the same noise
and compares every scale's output, all of its images, by the mean gap.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from portbench.harness import load_reference
from portbench.yardstick.seeds import sub_seed
from portbench.yardstick.weights import make_weights

KERNEL1, KERNEL2 = "conv3x3_tc_kernel", "dw5x5"


def walk_gaps(outs, want) -> Dict[str, float]:
    """Two walks' gap over every scale's output: the mean over all their
    elements, and the widest (infinite where their scales or shapes differ)."""
    if len(outs) != len(want) or any(o.shape != r.shape for o, r in zip(outs, want)):
        return {"mean": float("inf"), "widest": float("inf")}
    total = sum(float((o.double() - r.double()).abs().sum()) for o, r in zip(outs, want))
    return {"mean": total / sum(o.numel() for o in outs),
            "widest": max(float((o - r).abs().max()) for o, r in zip(outs, want))}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, log: Callable[[str], None]):
        self.cfg, self.traffic, self.seed, self.device, self.log = config, traffic, int(seed), device, log
        self.ref = load_reference(config)
        self.batch = int(traffic["batch"])
        self.walks = []  # each walk's per-scale outputs, kept to the end of the run
        self.spans = []  # ("denoiser", B, H, W) a denoiser call, recorded as the program is called
        self.unit_attempted = 0

    # ---- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from sinddm_tpu_torch.apps.sampling import sample_scales
        from sinddm_tpu_torch.models.denoiser import SinDDMNet
        from sinddm_tpu_torch.ops import _build
        from sinddm_tpu_torch.pyramid import compute_pyramid_geometry
        from sinddm_tpu_torch.schedules import make_schedules

        cfg = self.cfg
        t0 = time.perf_counter()
        if torch.device(self.device).type == "cuda":
            _build.build(("conv_block", "dw_conv"))
        t1 = time.perf_counter()
        _, sizes_wh, factor, n = compute_pyramid_geometry(tuple(cfg["image_wh"]), cfg["scale_factor"],
                                                          cfg["auto_scale"])
        self.sizes_hw = [(h, w) for (w, h) in sizes_wh]
        self.sched = make_schedules(timesteps=cfg["timesteps"], scale_losses=cfg["rescale_losses"], n_scales=n,
                                    device=self.device)
        self.weights = make_weights(sub_seed(self.seed, "weights"), cfg, self.device)
        self.model = SinDDMNet(dim=cfg["dim"], channels=cfg["channels"],
                               compute_dtype=getattr(torch, self.traffic["compute_dtype"]), device=self.device)
        self.model.load_state_dict(self.weights, strict=True)
        self.model.eval().requires_grad_(False)
        self.sample_scales = sample_scales
        self.walk_kw = dict(scale_factor=factor, n_scales=n, custom_sample=True, omega=cfg["omega"],
                            reblurring=cfg["reblurring"], device=self.device)
        t2 = time.perf_counter()
        self._walk(-1)  # every shape of the traffic, once
        self.log(f"[portbench] set-up s: kernels {t1 - t0:.3f}, model and inputs {t2 - t1:.3f}, warm-up walk "
                 f"{time.perf_counter() - t2:.3f}")
        self.walks.clear()
        self.spans.clear()

    def model_fn(self, x, t, s):
        self.spans.append(("denoiser",) + tuple(x.shape[:3]))
        return self.model(x, t, s)

    def noise_fn(self, index: int):
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "walk", index))
        return lambda shape: torch.randn(shape, generator=g, device=self.device)

    def _walk(self, index: int):
        outs = self.sample_scales(self.model_fn, self.sched, self.sizes_hw, batch_size=self.batch,
                                  noise_fn=self.noise_fn(index), **self.walk_kw)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        return outs

    # ---- the window --------------------------------------------------------
    def unit(self) -> None:
        self.walks.append(self._walk(len(self.walks)))
        self.unit_attempted = self.batch

    def counters(self) -> Dict[str, int]:
        from sinddm_tpu_torch.ops import conv_block, dw_conv

        return {"conv_block": conv_block.launches, "dw_conv": dw_conv.launches}

    def trace_complete(self, trace, counters: Dict[str, int]) -> bool:
        """Whether the trace holds every launch of kernels 1 and 2 that the
        program's counters saw."""
        k1 = trace.count_where(lambda n: KERNEL1 in n)
        k2 = trace.count_where(lambda n: KERNEL2 in n)
        self.log(f"[portbench] traced launches: kernel 1 {k1} (counter {counters['conv_block']}), "
                 f"kernel 2 {k2} (counter {counters['dw_conv']})")
        return k1 == counters["conv_block"] and k2 == counters["dw_conv"]

    def failed(self) -> int:
        """Images of the window whose finest output is not finite or leaves [-1, 1]."""
        bad = 0
        for outs in self.walks:
            x = outs[-1].reshape(outs[-1].shape[0], -1)
            bad += int((~(torch.isfinite(x).all(1) & (x.abs() <= 1.0).all(1))).sum())
        return bad

    def end_to_end(self, window_s: float, units: int) -> Dict[str, float]:
        return {"sample_images_per_s": units * self.batch / window_s}

    # ---- the check ---------------------------------------------------------
    def check(self) -> Dict[str, float]:
        """The mean gap, over every scale and every element of all the images
        of the walk drawn from the seed, between the program's output and the
        reference's (the widest gap goes to the log: it swings from seed to
        seed by its nature, 60x over 18 seeds, and its control readings
        overlap the program's tail)."""
        k = int(np.random.default_rng(sub_seed(self.seed, "sample")).integers(len(self.walks)))
        outs = self.walks[k]
        self.walks, self.model = None, None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        gaps = walk_gaps(outs, self.reference_walk(k))
        self.log(f"[portbench] walk {k}: gap to the reference, mean {gaps['mean']!r}, widest {gaps['widest']!r}")
        return {"walk_mean_gap": gaps["mean"]}

    def reference_walk(self, index: int, tf32: bool = False, step_fault=None, net_wrap=None):
        """The plain reference's walk on the noise of walk ``index``; with
        ``tf32`` the control, with ``step_fault`` / ``net_wrap`` a planted
        fault (``calibrate.py``)."""
        cfg, ref = self.cfg, self.ref
        geo = ref.geometry(cfg["image_wh"], cfg["scale_factor"], cfg["auto_scale"])
        sch = ref.schedules(cfg["timesteps"], cfg["rescale_losses"], self.device)
        plain = lambda x, t, s: ref.denoise(self.weights, x, t, s, cfg["blocks"])  # noqa: E731
        net = plain if net_wrap is None else (lambda x, t, s: net_wrap(x, t, s, plain))  # noqa: E731
        with ref.precision(tf32):
            return ref.walk(net, sch, geo["sizes_hw"], self.batch, self.noise_fn(index), channels=cfg["channels"],
                            omega=cfg["omega"], device=self.device, step_fault=step_fault)
