"""CLIP-guided application modes: content, style generation, style transfer
and ROI editing (port of ``sinddm_tpu/apps/clip_apps.py``).

* clip_content: guidance at every scale except 0 (sub_iters [0,1,1,...]),
  the user's strength / fill_factor, llambda 0.2, stop_guidance 3, reblur off;
* clip_style_gen / clip_style_trans: guidance at the finest scale only
  (sub_iters [0,...,0,1]), strength 0.3, quantile 0 (the whole image),
  llambda 0.05; style_trans starts from the training image at scale
  n_scales-2 instead of noise;
* clip_roi: 100 iterations of normalised CLIP-score ascent on a box of the
  finest training image, pasted back, then 3 denoising steps at the finest
  scale.

The guided walk runs per scale (each scale at its own size), or bucketed
(``bucketed=True``, ``--bucketed_guidance``): every via scale on the finest
scale's canvas, as :mod:`sinddm_tpu_torch.diffusion.bucketed` sets out.

Under a mesh (``sharding``) the denoiser is split over both axes
(:func:`~sinddm_tpu_torch.parallel.mesh.split_model_fn`; in the bucketed walk
on each valid crop) and the CLIP loss over ``data``
(:func:`~sinddm_tpu_torch.guidance.clip_guidance.clip_loss_and_grad`); every
rank draws the whole batch's noise and view draws and returns the whole
outputs and scores.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sinddm_tpu_torch.apps.sampling import sample_scales, save_interm_scales
from sinddm_tpu_torch.diffusion.bucketed import (
    dynamic_resize_into_canvas,
    place_on_canvas,
    sample_via_scale_bucketed,
)
from sinddm_tpu_torch.diffusion.core import ModelFn, NoiseFn, make_noise_fn, sample_scale0, sample_via_scale
from sinddm_tpu_torch.guidance.clip_extractor import (
    ClipExtractor,
    get_augmentations_template,
    resize_output_size,
)
from sinddm_tpu_torch.guidance.clip_guidance import (
    ClipCarry,
    DrawFn,
    clip_loss_and_grad,
    init_clip_carry,
    make_clip_guidance,
    resize_guidance_carry,
)
from sinddm_tpu_torch.parallel import distributed
from sinddm_tpu_torch.parallel.mesh import NamedSharding, require_named_sharding, split_model_fn
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
    bucketed: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    draw_fn: Optional[DrawFn] = None,
    sharding: Optional[NamedSharding] = None,
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

    ``bucketed`` runs the via scales through :func:`clip_sampling_bucketed`.
    It samples the same process with
    other draws: they are canvas-shaped, and a guided scale below the
    finest frames its views as the canvas does. ``sharding`` splits the
    walk over a mesh (module docstring).
    """
    sharding = require_named_sharding(sharding)
    n = pyramid.n_scales
    if guidance_sub_iters is None:
        guidance_sub_iters = list(reversed(range(n)))
    embeds_hr = extractor.get_text_embedding(text_input, get_augmentations_template("hr"))
    embeds_lr = extractor.get_text_embedding(text_input, get_augmentations_template("lr"))
    if bucketed:
        return clip_sampling_bucketed(
            model_fn, sched, pyramid, extractor, embeds_hr=embeds_hr, embeds_lr=embeds_lr, strength=strength,
            sample_batch_size=sample_batch_size, custom_t_list=custom_t_list,
            guidance_sub_iters=guidance_sub_iters, quantile=quantile, stop_guidance=stop_guidance,
            llambda=llambda, scale_mul=scale_mul, reblurring=reblurring, omega=omega, start_noise=start_noise,
            sample_limited_t=sample_limited_t, collect_interm=collect_interm,
            generator=generator, noise_fn=noise_fn, draw_fn=draw_fn, sharding=sharding, device=device,
        )

    def guidance_factory(s, size_hw):
        carry = init_clip_carry(sample_batch_size, size_hw, device=device)
        fn = make_clip_guidance(
            extractor, embeds_hr if s > 0 else embeds_lr, s=s, n_scales=n,
            sub_iters=int(guidance_sub_iters[s]), strength=strength, quantile=quantile,
            llambda=llambda, stop_guidance=stop_guidance, draw_fn=draw_fn, sharding=sharding,
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
        generator=generator, noise_fn=noise_fn, sharding=sharding, device=device,
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


def clip_sampling_bucketed(
    model_fn: ModelFn,
    sched: Schedules,
    pyramid: Pyramid,
    extractor: ClipExtractor,
    *,
    embeds_hr: torch.Tensor,
    embeds_lr: torch.Tensor,
    strength: float,
    sample_batch_size: int,
    custom_t_list: Optional[Sequence[int]],
    guidance_sub_iters: Sequence[int],
    quantile: float,
    stop_guidance: int,
    llambda: float,
    scale_mul: Tuple[float, float] = (1.0, 1.0),
    reblurring: bool = False,
    omega: float = 0.0,
    start_noise: bool = True,
    sample_limited_t: bool = False,
    collect_interm: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    draw_fn: Optional[DrawFn] = None,
    sharding: Optional[NamedSharding] = None,
    device="cuda",
) -> Tuple[List[torch.Tensor], List[Any]]:
    """The guided pyramid with every via scale on the finest scale's canvas
    (after ``scale_mul``), its views in the canvas's frame.

    Scale 0 runs the usual scale-0 sampler at its own size. With
    ``start_noise=False`` (clip_style_trans) the training image at scale
    n-2 is placed on the canvas and only the finest scale is denoised. A
    guided scale 0's carry (edit mask and last guided estimate) is lifted
    onto the canvas, not reset; each via scale resizes the carry valid
    region to valid region as it enters. Every via scale's aux holds
    ``"clip_score"`` (a row a step; zeros where unguided) and
    ``"n_guided"``; ``"interm"`` frames are cropped to the scale's size.
    Under ``sharding`` the denoiser is split on each scale's valid crop.
    """
    sharding = require_named_sharding(sharding)
    if sharding is not None:
        model_fn = split_model_fn(model_fn, sharding)
    n = pyramid.n_scales
    if custom_t_list is None:
        custom_t_list = list(sched.num_timesteps_ideal[1:])
    if noise_fn is None:
        noise_fn = make_noise_fn(generator, device)
    sizes = [(int(h * scale_mul[0]), int(w * scale_mul[1])) for h, w in pyramid.sizes_hw]
    canvas = sizes[-1]
    frame_hw = resize_output_size(*canvas)
    b = sample_batch_size
    hook_kw = dict(n_scales=n, strength=strength, quantile=quantile, llambda=llambda,
                   stop_guidance=stop_guidance, draw_fn=draw_fn, sharding=sharding)

    def t_min_of(s: int) -> int:
        return int(sched.num_timesteps_ideal[s + 1]) if (sample_limited_t and s < n - 1) else 0

    with torch.no_grad():
        carry = None
        if start_noise:
            h0, w0 = sizes[0]
            gfn0 = make_clip_guidance(extractor, embeds_lr, s=0, sub_iters=int(guidance_sub_iters[0]), **hook_kw)
            x0, carry0, aux0 = sample_scale0(
                model_fn, sched, (b, h0, w0, 3), s=0, t_min=t_min_of(0), omega=omega, noise_fn=noise_fn,
                device=device, guidance_fn=gfn0,
                guidance_carry=init_clip_carry(b, (h0, w0), device=device) if gfn0 else None,
                collect_interm=collect_interm,
            )
            if isinstance(aux0, dict) and "clip_score" in aux0:
                aux0["n_guided"] = _n_guided_steps(0, int(sched.num_timesteps), int(guidance_sub_iters[0]), n,
                                                   stop_guidance, t_min_of(0))
            outputs, aux = [x0], [aux0]
            prev_valid = (h0, w0)
            via_scales = list(range(1, n))
            if gfn0 is not None:  # lift the guided scale 0's carry onto the canvas
                carry = ClipCarry(place_on_canvas(carry0.mask, canvas),
                                  place_on_canvas(carry0.x_recon_prev, canvas), carry0.has_mask)
        else:
            img = torch.as_tensor(np.asarray(pyramid.images[n - 2]), dtype=torch.float32, device=device)
            x0 = img[None].expand((b,) + tuple(img.shape)).contiguous()
            outputs, aux = [x0], [None]
            prev_valid = tuple(img.shape[:2])
            via_scales = [n - 1]
        if carry is None:
            carry = init_clip_carry(b, canvas, device=device)
        prev_canvas = place_on_canvas(x0, canvas)

        for s in via_scales:
            hs, ws = sizes[s]
            sub_iters = int(guidance_sub_iters[s])
            total_t, t_min = int(custom_t_list[s - 1]), t_min_of(s)
            gfn = make_clip_guidance(extractor, embeds_hr, s=s, sub_iters=sub_iters, valid_hw=(hs, ws),
                                     frame_hw=frame_hw, **hook_kw)
            carry = ClipCarry(dynamic_resize_into_canvas(carry.mask, prev_valid, (hs, ws)),
                              dynamic_resize_into_canvas(carry.x_recon_prev, prev_valid, (hs, ws)), carry.has_mask)
            x, carry, part = sample_via_scale_bucketed(
                model_fn, sched, prev_canvas, prev_valid_hw=prev_valid, cur_valid_hw=(hs, ws), s=s,
                total_t=total_t, t_min=t_min, reblurring=reblurring, omega=omega, guidance_fn=gfn,
                guidance_carry=carry, collect_interm=collect_interm, noise_fn=noise_fn, device=device,
            )
            part = part or {}
            aux_s = {
                "clip_score": part.get("clip_score", torch.zeros((max(total_t - t_min, 0), 1), device=x.device)),
                "n_guided": _n_guided_steps(s, total_t, sub_iters, n, stop_guidance, t_min),
            }
            if "interm" in part:
                aux_s["interm"] = part["interm"][:, :, :hs, :ws]
            prev_canvas = x
            prev_valid = (hs, ws)
            outputs.append(x[:, :hs, :ws].contiguous())
            aux.append(aux_s)
    return outputs, aux


# clip_roi as the CLI runs it (the JAX package's values): ascent
# iterations, ascent strength, denoising steps at the finest scale
ROI_ASCENT_ITERS, ROI_STRENGTH, ROI_DENOISING_STEPS = 100, 0.1, 3


def _clip_roi_ascent(
    extractor: ClipExtractor,
    patch: torch.Tensor,
    text_embeds: torch.Tensor,
    n_iters: int,
    strength: float,
    collect_interm: bool = False,
    draw_fn: Optional[DrawFn] = None,
    sharding: Optional[NamedSharding] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``n_iters`` steps of normalised CLIP-score ascent on ``patch`` [B, h, w, 3]
    in [-1, 1]: each step takes the score (minus the CLIP loss of the patch
    in [0, 1]) and its gradient g, moves the patch by ``strength * |x| / |g| * g``
    (norms per image) and clamps it to [-1, 1]. The clamp lies outside the
    gradient, so ``torch.clamp`` is exact here.

    Returns (patch, scores [n_iters], the pre-update patch of every step
    [n_iters, B, h, w, 3] when ``collect_interm``, else None). The loss draws
    come from ``draw_fn(batch, n_templates)`` or the extractor's generator;
    ``sharding`` splits the loss over its ``data`` axis."""
    draw = draw_fn or extractor.draw
    x = patch
    scores, frames = [], []
    with torch.no_grad():
        for _ in range(n_iters):
            loss, g01 = clip_loss_and_grad(extractor, (x + 1.0) * 0.5, text_embeds,
                                           draw(x.shape[0], text_embeds.shape[0]), sharding)
            grad = -0.5 * g01  # the score's gradient in x: x01 = (x + 1) / 2
            norm_x = x.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
            norm_g = grad.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
            scores.append(-loss)
            if collect_interm:
                frames.append(x)
            x = (x + strength * (norm_x / norm_g.clamp_min(1e-12)) * grad).clamp(-1.0, 1.0)
    score_trace = torch.stack(scores) if scores else patch.new_zeros((0,))
    return x, score_trace, (torch.stack(frames) if frames else None)


def clip_roi_sampling(
    model_fn: ModelFn,
    sched: Schedules,
    pyramid: Pyramid,
    extractor: ClipExtractor,
    *,
    text_input: str,
    strength: float = 0.1,
    sample_batch_size: int = 16,
    num_clip_iters: int = 100,
    num_denoising_steps: int = 3,
    clip_roi_bb: Sequence[int] = (0, 0, 32, 32),
    omega: float = 0.0,
    collect_interm: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    draw_fn: Optional[DrawFn] = None,
    sharding: Optional[NamedSharding] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (final [B, H, W, 3] in [-1, 1], ascent scores [n_iters], interm).

    The finest training image, broadcast to the batch, has its box
    ``clip_roi_bb`` (y, x, h, w) edited by :func:`_clip_roi_ascent` against the
    "lr" text templates; the edited image is denoised ``num_denoising_steps``
    steps at the finest scale (no reblurring, down to t = 0). With
    ``collect_interm`` the third output holds the ascent's per-step patches
    (``"ascent"``) and the denoising steps' states (``"denoise"``), else it is
    None. Noise from ``noise_fn`` or ``generator``, loss draws from
    ``draw_fn`` or the extractor's generator. ``sharding`` splits the ascent's
    loss over ``data`` and the denoiser over the mesh."""
    sharding = require_named_sharding(sharding)
    if sharding is not None:
        model_fn = split_model_fn(model_fn, sharding)
    n = pyramid.n_scales
    embeds = extractor.get_text_embedding(text_input, get_augmentations_template("lr"))
    finest = torch.as_tensor(np.asarray(pyramid.images[n - 1]), dtype=torch.float32, device=device)
    image = finest[None].expand((sample_batch_size,) + tuple(finest.shape)).clone()
    y, x, h, w = (int(v) for v in clip_roi_bb)
    patch, scores, ascent = _clip_roi_ascent(
        extractor, image[:, y : y + h, x : x + w].clone(), embeds, num_clip_iters, strength,
        collect_interm=collect_interm, draw_fn=draw_fn, sharding=sharding)
    image[:, y : y + h, x : x + w] = patch
    with torch.no_grad():
        final, _, aux = sample_via_scale(
            model_fn, sched, image, s=n - 1, total_t=int(num_denoising_steps), t_min=0,
            reblurring=False, omega=omega, generator=generator, noise_fn=noise_fn,
            collect_interm=collect_interm)
    interm = None
    if collect_interm:
        interm = {"ascent": ascent, "denoise": aux.get("interm") if aux else None}
    return final, scores, interm


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


def _roi_box(args, n_scales: int) -> List[int]:
    """clip_roi's box (y, x, h, w): ``--target_roi``, or drawn with OpenCV's
    selector on the finest pyramid image saved beside the dataset
    (``--interactive``; cv2 is imported only then)."""
    if args.interactive:
        import os

        import cv2

        img_path = os.path.join(args.dataset_folder, f"scale_{n_scales - 1}",
                                args.image_name.rsplit(".", 1)[0] + ".png")
        r = cv2.selectROI(cv2.imread(img_path))
        return [r[1], r[0], r[3], r[2]]
    if args.target_roi is None:
        raise SystemExit("clip_roi needs --target_roi (y x h w) or --interactive")
    return list(args.target_roi)


def run_clip_mode(args, model_fn: ModelFn, sched: Schedules, pyramid: Pyramid,
                  generator: Optional[torch.Generator], sample_t_list, scale_mul,
                  results_folder, device, sharding: Optional[NamedSharding] = None) -> List[torch.Tensor]:
    """CLI dispatcher for the four CLIP modes: loads the tower, samples and
    writes PNGs under ``final_samples/``. ``clip_content`` / ``clip_style_*``
    write one grid a scale and the clip-score trace (``clip_score.png`` where
    matplotlib is installed, else ``clip_score.npy``); ``clip_roi`` writes
    ``clip_roi_{text}.png``. ``--save_interm`` adds the per-step frames
    (``interm_samples_scale_{s}/``, and ``interm_samples_clip_roi/`` for
    ``clip_roi``). Under ``sharding`` the walk is split over the mesh and
    only the primary rank writes files."""
    from sinddm_tpu_torch.models.clip.convert import find_clip_weights, load_clip
    from sinddm_tpu_torch.ops.image_io import save_image, save_interm_frames

    weights = args.clip_weights or find_clip_weights()
    if not weights:
        raise SystemExit(NO_WEIGHTS_MESSAGE)
    clip_dtype = None if args.clip_dtype == "float32" else args.clip_dtype
    extractor = ClipExtractor(
        load_clip(weights, device=device, compute_dtype=clip_dtype), n_aug=args.n_aug,
        view_chunk=args.clip_view_chunk or None, warp_precision=args.warp_precision,
        warp_impl=args.warp_impl, generator=generator,
    )
    n = pyramid.n_scales
    out_dir = Path(results_folder) / "final_samples"

    if args.mode == "clip_roi":
        final, _, interm = clip_roi_sampling(
            model_fn, sched, pyramid, extractor, text_input=args.clip_text, strength=ROI_STRENGTH,
            sample_batch_size=args.sample_batch_size, num_clip_iters=ROI_ASCENT_ITERS,
            num_denoising_steps=ROI_DENOISING_STEPS,
            clip_roi_bb=_roi_box(args, n), omega=args.omega, collect_interm=args.save_interm,
            generator=generator, sharding=sharding, device=device,
        )
        if not distributed.is_primary():
            return [final]
        if interm is not None:
            for i, frame in enumerate(interm["ascent"]):
                save_image((frame.clamp(-1.0, 1.0) + 1.0) * 0.5,
                           Path(results_folder) / "interm_samples_clip_roi" / f"iter_{i}.png")
            if interm["denoise"] is not None:
                save_interm_frames(interm["denoise"], Path(results_folder) / f"interm_samples_scale_{n - 1}",
                                   s=n - 1)
        save_image((final + 1) * 0.5, out_dir / f"clip_roi_{args.clip_text.replace(' ', '_')}.png")
        print(f"saved CLIP results to {out_dir}")
        return [final]

    cfg = clip_mode_config(args.mode, args.clip_text, args.strength, args.fill_factor, n)
    outputs, aux = clip_sampling(
        model_fn, sched, pyramid, extractor, sample_batch_size=args.sample_batch_size,
        custom_t_list=sample_t_list, stop_guidance=3, scale_mul=scale_mul, reblurring=False,
        omega=args.omega, sample_limited_t=args.sample_limited_t, collect_interm=args.save_interm,
        bucketed=args.bucketed_guidance,
        generator=generator, sharding=sharding, device=device, **cfg,
    )
    if not distributed.is_primary():
        return outputs
    desc = f"{args.mode}_{args.clip_text.replace(' ', '_')}"
    if args.save_interm:
        # style_trans's first output is the injected image at scale n-2
        scales = list(range(n)) if cfg["start_noise"] else [n - 2, n - 1]
        save_interm_scales(aux, scales, sched, n, args.sample_limited_t, results_folder)
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
