"""CLIP-guided application modes: content, style generation, style transfer
(port of ``sinddm_tpu/apps/clip_apps.py``, the per-scale walk).

* clip_content: guidance at every scale except 0 (sub_iters [0,1,1,...]),
  the user's strength / fill_factor, llambda 0.2, stop_guidance 3, reblur off;
* clip_style_gen / clip_style_trans: guidance at the finest scale only
  (sub_iters [0,...,0,1]), strength 0.3, quantile 0 (the whole image),
  llambda 0.05; style_trans starts from the training image at scale
  n_scales-2 instead of noise.

``clip_roi`` and the shape-bucketed guided walk are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sinddm_tpu_torch.apps.sampling import sample_scales
from sinddm_tpu_torch.diffusion.core import ModelFn, NoiseFn
from sinddm_tpu_torch.guidance.clip_extractor import ClipExtractor, get_augmentations_template
from sinddm_tpu_torch.guidance.clip_guidance import (
    DrawFn,
    init_clip_carry,
    make_clip_guidance,
    resize_guidance_carry,
)
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import Schedules


def _n_guided_steps(s: int, total_t: int, sub_iters: int, n_scales: int,
                    stop_guidance: int, t_min: int) -> int:
    """How many steps of scale s really run CLIP guidance. The sampler emits a
    clip_score row per step, zeros on the gated ones (the last
    ``stop_guidance`` steps of the finest scale); t descends from
    ``total_t - 1``, so the real scores are the first ``n_guided`` rows."""
    if sub_iters <= 0:
        return 0
    gate = stop_guidance if s == n_scales - 1 else 0
    return max(total_t - max(t_min, gate), 0)


def clip_sampling(
    model_fn: ModelFn,
    sched: Schedules,
    pyramid: Pyramid,
    extractor: ClipExtractor,
    *,
    text_input: str,
    strength: float,
    sample_batch_size: int = 16,
    custom_t_list: Optional[Sequence[int]] = None,
    guidance_sub_iters: Optional[Sequence[int]] = None,
    quantile: float = 0.8,
    stop_guidance: int = 3,
    scale_mul: Tuple[float, float] = (1.0, 1.0),
    llambda: float = 0.0,
    start_noise: bool = True,
    reblurring: bool = False,
    omega: float = 0.0,
    sample_limited_t: bool = False,
    collect_interm: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    draw_fn: Optional[DrawFn] = None,
    device="cuda",
) -> Tuple[List[torch.Tensor], List[Any]]:
    """Returns (per-scale outputs, per-scale aux with clip scores).

    The sampler's noise comes from ``noise_fn`` or ``generator``; the
    guidance draws from ``draw_fn`` or the extractor's generator. Each
    guided scale's aux holds ``"clip_score"`` [n_steps, sub_iters] and
    ``"n_guided"``, the count of leading rows that are real scores.
    ``sample_limited_t`` stops each scale's chain at
    ``num_timesteps_ideal[s+1]``; ``collect_interm`` stacks the per-step
    states under ``"interm"``.
    """
    n = pyramid.n_scales
    if guidance_sub_iters is None:
        guidance_sub_iters = list(reversed(range(n)))
    embeds_hr = extractor.get_text_embedding(text_input, get_augmentations_template("hr"))
    embeds_lr = extractor.get_text_embedding(text_input, get_augmentations_template("lr"))

    def guidance_factory(s, size_hw):
        carry = init_clip_carry(sample_batch_size, size_hw, device=device)
        fn = make_clip_guidance(
            extractor, embeds_hr if s > 0 else embeds_lr, s=s, n_scales=n,
            sub_iters=int(guidance_sub_iters[s]), strength=strength, quantile=quantile,
            llambda=llambda, stop_guidance=stop_guidance, draw_fn=draw_fn,
        )
        return fn, carry

    def carry_transform(s, carry, size_hw):
        # resize the guidance state to the incoming scale; a mask carried
        # into scale 0 is dropped
        return resize_guidance_carry(carry, size_hw, drop_mask=(s == 0))

    aux: List[Any] = []
    common = dict(
        scale_factor=pyramid.scale_factor, n_scales=n, batch_size=sample_batch_size,
        scale_mul=scale_mul, custom_t_list=custom_t_list, reblurring=reblurring, omega=omega,
        sample_limited_t=sample_limited_t, guidance_factory=guidance_factory,
        carry_transform=carry_transform, collect_aux=aux, collect_interm=collect_interm,
        generator=generator, noise_fn=noise_fn, device=device,
    )
    if not start_noise:  # clip_style_trans: inject the training image
        scale_ids = [n - 2, n - 1]
        outputs = sample_scales(
            model_fn, sched, pyramid.sizes_hw, custom_scales=scale_ids,
            custom_image_size_idxs=scale_ids, custom_sample=True, start_noise=False,
            start_image=pyramid.images[n - 2], **common,
        )
    else:
        scale_ids = list(range(n))
        outputs = sample_scales(model_fn, sched, pyramid.sizes_hw, custom_sample=False, **common)

    # annotate each guided aux with its real guided-step count, so that a
    # consumer (run_clip_mode's clip_score trace) can drop the gated zeros
    t_resolved = list(custom_t_list) if custom_t_list is not None else list(sched.num_timesteps_ideal[1:])
    for s_id, a in zip(scale_ids, aux):
        if isinstance(a, dict) and "clip_score" in a:
            total_s = int(sched.num_timesteps) if s_id == 0 else int(t_resolved[s_id - 1])
            t_min_s = int(sched.num_timesteps_ideal[s_id + 1]) if (sample_limited_t and s_id < n - 1) else 0
            a["n_guided"] = _n_guided_steps(
                s_id, total_s, int(guidance_sub_iters[s_id]), n, stop_guidance, t_min_s)
    return outputs, aux


NO_WEIGHTS_MESSAGE = (
    "CLIP modes need a ViT-B/32 checkpoint: pass --clip_weights, or "
    "drop the file at one of the sniffed paths (SINDDM_CLIP_WEIGHTS, "
    "checkpoints/ViT-B-32.pt, ~/.cache/clip/ViT-B-32.pt — see "
    "docs/REAL_CLIP.md; this environment cannot download it)."
)


def clip_mode_config(mode: str, clip_text: str, strength: Optional[float],
                     fill_factor: Optional[float], n_scales: int) -> dict:
    """The ``clip_sampling`` arguments of a CLI mode."""
    if mode == "clip_content":
        for name, value in (("--strength", strength), ("--fill_factor", fill_factor)):
            if value is None or not 0 <= value <= 1:
                raise ValueError(f"clip_content needs {name} in [0, 1], got {value}")
        return dict(
            text_input=clip_text, strength=strength, quantile=1.0 - fill_factor,
            guidance_sub_iters=[0] + [1] * (n_scales - 1), llambda=0.2, start_noise=True,
        )
    if mode in ("clip_style_gen", "clip_style_trans"):
        return dict(
            text_input=clip_text + " Style", strength=0.3, quantile=0.0,
            guidance_sub_iters=[0] * (n_scales - 1) + [1], llambda=0.05,
            start_noise=mode == "clip_style_gen",
        )
    raise NotImplementedError(f"mode {mode!r} is not ported yet")


def run_clip_mode(args, model_fn: ModelFn, sched: Schedules, pyramid: Pyramid,
                  generator: Optional[torch.Generator], sample_t_list, scale_mul,
                  results_folder, device) -> List[torch.Tensor]:
    """CLI dispatcher for ``clip_content`` / ``clip_style_gen`` /
    ``clip_style_trans``: loads the tower, samples, writes one PNG grid a
    scale under ``final_samples/`` and the clip-score trace (``clip_score.png``
    where matplotlib is installed, else ``clip_score.npy``)."""
    from sinddm_tpu_torch.models.clip.convert import find_clip_weights, load_clip
    from sinddm_tpu_torch.ops.image_io import save_image

    weights = args.clip_weights or find_clip_weights()
    if not weights:
        raise SystemExit(NO_WEIGHTS_MESSAGE)
    extractor = ClipExtractor(
        load_clip(weights, device=device), n_aug=args.n_aug,
        view_chunk=args.clip_view_chunk or None, warp_impl=args.warp_impl, generator=generator,
    )
    cfg = clip_mode_config(args.mode, args.clip_text, args.strength, args.fill_factor, pyramid.n_scales)
    outputs, aux = clip_sampling(
        model_fn, sched, pyramid, extractor, sample_batch_size=args.sample_batch_size,
        custom_t_list=sample_t_list, stop_guidance=3, scale_mul=scale_mul, reblurring=False,
        omega=args.omega, sample_limited_t=args.sample_limited_t, generator=generator,
        device=device, **cfg,
    )
    out_dir = Path(results_folder) / "final_samples"
    desc = f"{args.mode}_{args.clip_text.replace(' ', '_')}"
    for i, out in enumerate(outputs):
        save_image((out + 1) * 0.5, out_dir / f"{desc}_s{i}.png")
    # the clip-score trace keeps only the scores that were computed: each
    # scale's rows are cut to its annotated count
    parts = [
        a["clip_score"][: a["n_guided"]].reshape(-1).cpu().numpy()
        for a in aux if isinstance(a, dict) and "clip_score" in a and a["n_guided"] > 0
    ]
    scores = np.concatenate(parts or [np.zeros(1)])
    try:
        import matplotlib
    except ImportError:
        np.save(str(Path(results_folder) / "clip_score.npy"), scores)
    else:
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plt.figure(figsize=(16, 8))
        plt.plot(scores)
        plt.grid(True)
        plt.savefig(str(Path(results_folder) / "clip_score.png"))
        plt.close()
    print(f"saved CLIP results to {out_dir}")
    return outputs
