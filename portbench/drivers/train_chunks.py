"""Traffic driver: back-to-back training chunks (``--mode train``'s loop
without its checkpoints), one trainer on one card.

Set-up builds one ``MultiscaleTrainer`` on the seeded training pyramid,
loads the benchmark's weights into it, and runs two short grouped chunks
through the window's own call: the first gives every scale its eager
warm-up steps, the second captures every scale's step as a CUDA graph and
replays each once. A unit is one grouped chunk of ``steps_per_chunk``
steps, ``steps_per_chunk / n_scales`` at each scale in the trainer's
shuffled order, every step a replay of those graphs; the chunk's losses
are fetched at its end.

The check follows the set-up's steps in the plain reference from the
benchmark's weights, on the same scales and draws, at the traffic's batch
and the scales' true sizes, and compares two stages of them:

* the start: the first three steps (eager, before capture);
* the replays: the second chunk, one replay of every scale's graph, from
  wherever the reference's own steps have brought it.

Each compares the steps' losses, the first step's gradient as Adam got it
(worked out from its first moment before and after the step), and the
parameters' change over the stage, by the worst leaf.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.harness import load_reference
from portbench.yardstick.images import training_pyramid
from portbench.yardstick.seeds import sub_seed
from portbench.yardstick.weights import make_weights

CHECK_STEPS = 3
# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
QUIET_LEAF = 1e-3
STAGES = ("start", "replay")
NUMBERS = ("loss_gap", "grad_gap", "update_gap")


def leaf_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median leaf."""
    names = [k for k in want if keep is None or k in keep]
    ref_norm = {k: float(want[k].double().norm()) for k in names}
    median = float(np.median(list(ref_norm.values())))
    return max(abs(float(prog[k].double().norm()) - ref_norm[k]) / max(ref_norm[k], median, 1e-30)
               for k in names)


def stage_gaps(prog: dict, want: dict) -> Dict[str, float]:
    """The check's numbers for one stage: the worst step's loss gap relative
    to the reference's, and by the worst leaf the first step's gradient and
    the parameters' change over the stage (each side's end less its own
    start). ``prog`` and ``want`` hold ``scales``, ``losses``, ``grad`` (the
    first step's), ``p0`` and ``p_end``; on other scales every number is
    infinite. Leaves whose reference gradient is under :data:`QUIET_LEAF` of
    the median leaf's are left out of the change (``quiet_leaves`` counts
    them, for the log)."""
    if list(prog["scales"]) != list(want["scales"]):
        return dict(dict.fromkeys(NUMBERS, float("inf")), quiet_leaves=0)
    g_ref = want["grad"]
    quiet = float(np.median([float(g.norm()) for g in g_ref.values()])) * QUIET_LEAF
    moved = {k for k, g in g_ref.items() if float(g.norm()) >= quiet}
    change = lambda side: {k: side["p_end"][k] - side["p0"][k] for k in g_ref}  # noqa: E731
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])),
        "grad_gap": leaf_gap(prog["grad"], g_ref),
        "update_gap": leaf_gap(change(prog), change(want), moved),
        "quiet_leaves": len(g_ref) - len(moved),
    }


def check_numbers(prog: dict, want: dict, log=None) -> Dict[str, float]:
    """The compared numbers of both stages, by the names of the cell's
    limits: the start's plain, the replays' prefixed ``replay_``."""
    out = {}
    for tag in STAGES:
        gaps = stage_gaps(prog[tag], want[tag])
        if log:
            log(f"[portbench] {tag} (scales {prog[tag]['scales']}, reference {want[tag]['scales']}): {gaps}; "
                f"program losses {prog[tag]['losses']} reference {want[tag]['losses']}")
        out.update({(k if tag == "start" else f"{tag}_{k}"): gaps[k] for k in NUMBERS})
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, log: Callable[[str], None]):
        self.cfg, self.traffic, self.seed, self.device, self.log = config, traffic, int(seed), device, log
        self.ref = load_reference(config)
        self.batch = int(traffic["batch"])
        self.chunk = int(traffic["steps_per_chunk"])
        if traffic["fused_mode"] != "grouped":
            raise ValueError(f"the train_chunks driver runs grouped chunks, not {traffic['fused_mode']!r}")
        self.trainer_seed = sub_seed(self.seed, "trainer")
        self.sizes_hw = [tuple(v) for v in config["sizes_hw"]]
        self.spans: List[tuple] = []  # ("train_step", s, B, H, W) a step, from the trainer's own scale record
        self.losses: List[np.ndarray] = []
        self.unit_attempted = 0
        self.prog: Dict[str, dict] = {"start": {}, "replay": {}}

    def inputs(self) -> None:
        """The benchmark's weights and training pyramid, from the seed."""
        cfg = self.cfg
        self.weights = make_weights(sub_seed(self.seed, "weights"), cfg, self.device)
        self.images, self.recons = training_pyramid(sub_seed(self.seed, "data"), cfg["image_wh"], self.sizes_hw,
                                                    cfg["channels"], self.device)

    # ---- set-up ------------------------------------------------------------
    def setup(self) -> None:
        t_import = time.perf_counter()
        from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
        from sinddm_tpu_torch.models.denoiser import SinDDMNet
        from sinddm_tpu_torch.pyramid import Pyramid
        from sinddm_tpu_torch.schedules import make_schedules
        from sinddm_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS, MultiscaleTrainer

        cfg = self.cfg
        t0 = time.perf_counter()
        n = len(self.sizes_hw)
        self.inputs()
        t_images = time.perf_counter()
        pyramid = Pyramid(sizes_hw=tuple(self.sizes_hw), sizes_wh=tuple((w, h) for h, w in self.sizes_hw),
                          images=tuple(x[0].cpu().numpy() for x in self.images),
                          recon_images=tuple(x[0].cpu().numpy() for x in self.recons),
                          rescale_losses=tuple(cfg["rescale_losses"]), scale_factor=cfg["scale_factor"], n_scales=n)
        sched = make_schedules(timesteps=cfg["timesteps"], scale_losses=cfg["rescale_losses"], n_scales=n,
                               device=self.device)
        tr_cfg = cfg["train"]
        train_cfg = TrainConfig(train_batch_size=self.batch, train_lr=tr_cfg["lr"],
                                sched_milestones=tuple(tr_cfg["sched_milestones"]), lr_gamma=tr_cfg["lr_gamma"],
                                steps_per_chunk=self.chunk, fused_mode="grouped")
        self.folder = tempfile.mkdtemp(prefix="portbench-train-")
        self.trainer = tr = MultiscaleTrainer(
            SinDDMNet(dim=cfg["dim"], channels=cfg["channels"], device=self.device), sched, pyramid, train_cfg,
            DiffusionConfig(loss_type=cfg["loss_type"]), self.folder, seed=self.trainer_seed, device=self.device)
        t_trainer = time.perf_counter()
        tr.model.load_state_dict(self.weights, strict=True)
        tr.ema_model.load_state_dict(self.weights, strict=True)
        start, replay = self.prog["start"], self.prog["replay"]
        start["p0"] = self.weights

        seen = {"steps": 0}

        def after_step(opt, args, kwargs):  # the start's state, as Adam leaves it after each eager step
            seen["steps"] += 1
            if seen["steps"] == 1:
                start["grad"] = self._grad(None)
            if seen["steps"] == CHECK_STEPS:
                start["p_end"] = self._params()
                hook.remove()

        hook = tr.opt.register_step_post_hook(after_step)
        t1 = time.perf_counter()
        # the window's own call, short: every scale's eager warm-up steps,
        # then a chunk whose first step captures every scale's graph and
        # whose steps replay each once
        self.chunks = [GRAPH_WARMUP_STEPS * n, n]
        first = tr.train_chunk_grouped(self.chunks[0])
        start.update(losses=[float(v) for v in first[:CHECK_STEPS]], scales=tr.running_scale[:CHECK_STEPS])
        t2 = time.perf_counter()
        replay.update(p0=self._params(), m0=self._moments("exp_avg"))
        own = tr.train_scale

        def train_scale(s, k):  # the first replay's gradient, as Adam got it
            losses = own(s, k)
            if "grad" not in replay:
                replay["grad"] = self._grad(replay["m0"])
            return losses
        tr.train_scale = train_scale
        second = tr.train_chunk_grouped(self.chunks[1])
        del tr.train_scale
        replay.update(losses=[float(v) for v in second], scales=tr.running_scale[self.chunks[0]:],
                      p_end=self._params())
        del replay["m0"]
        t3 = time.perf_counter()
        self.log(f"[portbench] set-up s: the program's imports {t0 - t_import:.3f}, the inputs {t_images - t0:.3f}, "
                 f"the trainer {t_trainer - t_images:.3f}, weights {t1 - t_trainer:.3f}, "
                 f"eager warm-up chunk {t2 - t1:.3f}, "
                 f"capture chunk {t3 - t2:.3f} (captures {sum(tr.capture_seconds.values()):.3f}); the start's "
                 f"scales {start['scales']}, the replays' {replay['scales']}")

    def _params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone() for k, p in self.trainer.model.named_parameters()}

    def _moments(self, key: str) -> Dict[str, torch.Tensor]:
        opt = self.trainer.opt
        return {k: opt.state[p][key].detach().clone() for k, p in self.trainer.model.named_parameters()}

    def _grad(self, m0) -> Dict[str, torch.Tensor]:
        """The gradient of the step Adam just took: (m - beta1 m0) / (1 - beta1)
        from its first moment after the step and ``m0`` before it (zero at the start)."""
        beta1 = self.cfg["train"]["betas"][0]
        m1 = self._moments("exp_avg")
        return {k: (m - (0.0 if m0 is None else beta1 * m0[k])) / (1 - beta1) for k, m in m1.items()}

    # ---- the window --------------------------------------------------------
    def unit(self) -> None:
        tr = self.trainer
        done = len(tr.running_scale)
        self.losses.append(tr.train_chunk_grouped(self.chunk))
        for s in tr.running_scale[done:]:
            self.spans.append(("train_step", s, self.batch) + tuple(self.sizes_hw[s]))
        self.unit_attempted = self.chunk

    def counters(self) -> Dict[str, int]:
        return {"steps": self.trainer.step}

    def trace_complete(self, trace, counters: Dict[str, int]) -> bool:
        """Whether the trace holds a graph launch for every step the trainer
        counted, and device operations."""
        launches = sum(1 for h in trace.host if h[2] == "cudaGraphLaunch")
        self.log(f"[portbench] traced graph launches {launches} for {counters['steps']} steps, "
                 f"{len(trace.ops)} device operations")
        if not self.trainer.use_graphs:
            return len(trace.ops) > 0 or torch.device(self.device).type != "cuda"
        return launches == counters["steps"] and len(trace.ops) > 0

    def failed(self) -> int:
        return int(sum((~np.isfinite(v)).sum() for v in self.losses))

    def end_to_end(self, window_s: float, units: int) -> Dict[str, float]:
        return {"train_step_ms": 1e3 * window_s / (units * self.chunk)}

    # ---- the check ---------------------------------------------------------
    def check(self) -> Dict[str, float]:
        self.trainer = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.folder, ignore_errors=True)
        return check_numbers(self.prog, self.reference(), self.log)

    # ---- the reference -----------------------------------------------------
    def draws(self, seed: int):
        """The reference's draws of a step: t over the scale's trained range
        (every scale trains all T steps), then the noise, from one device
        generator seeded as the trainer seeds its own."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        T = self.cfg["timesteps"]

        def draw(s):
            h, w = self.sizes_hw[s]
            t = torch.randint(0, T, (self.batch,), generator=g, device=self.device)
            return t, torch.randn((self.batch, h, w, self.cfg["channels"]), generator=g, device=self.device)
        return draw

    def reference(self, tf32: bool = False, rows=None) -> dict:
        """The set-up's steps in the reference from the benchmark's weights:
        the scales of its two chunks in the trainer's order, on the trainer's
        draws. Returns the stages in the form the check takes the program's
        (so a reference run can stand in the program's place, as the control
        and the planted faults of ``calibrate.py`` do): each one's scales,
        losses, first gradient, first and last parameters."""
        ref, cfg = self.ref, self.cfg
        sch = ref.schedules(cfg["timesteps"], cfg["rescale_losses"], self.device)
        scales = ref.chunk_scales(self.trainer_seed, len(self.sizes_hw), self.chunks)
        cuts = {"start": (0, CHECK_STEPS), "warm-up": (CHECK_STEPS, self.chunks[0]),
                "replay": (self.chunks[0], sum(self.chunks))}
        draw = self.draws(self.trainer_seed + 2)
        images = list(zip(self.images, self.recons))
        params, state, out = self.weights, None, {}
        with ref.precision(tf32):
            for tag, (a, b) in cuts.items():
                got = ref.train_steps(params, cfg["blocks"], sch, images, scales[a:b], draw, cfg["train"],
                                      state=state, rows=rows)
                out[tag] = {"scales": scales[a:b], "losses": got["losses"],
                            "grad": got["grads"][0] if got["grads"] else None, "p0": params, "p_end": got["params"]}
                params, state = got["params"], got["state"]
        return out
