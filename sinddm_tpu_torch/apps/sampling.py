"""Cascaded multi-scale sampling, the pyramid walk (port of ``sinddm_tpu/apps/sampling.py``).

Scale 0 is sampled from pure noise (or a start image is injected); each
finer scale bilinearly upsamples the previous output, re-noises it part
way and denoises it with the reblurring sampler.

``sharding`` (a :class:`~sinddm_tpu_torch.parallel.mesh.NamedSharding`
over a world of ranks) splits the denoiser's batch rows over ``data`` and
its image rows over ``spatial`` (:func:`~sinddm_tpu_torch.parallel.mesh.split_model_fn`).
Every rank holds the whole state, draws the whole noise from its own
generator, seeded as the others are, and returns the whole outputs: a world
makes the single process's draws and its outputs. The JAX package returns a
sharded global array that its ``fetch`` gathers.

The JAX ``sample_scales`` option ``precompile`` (warming JAX's per-scale
compile cache) has no counterpart here: PyTorch runs eagerly. Nor has
``guidance_params``, which keeps the CLIP tower out of the compiled
program's constants: here the guidance hook simply holds its tower. Its
executor options (``use_pallas``, ``fast_mode``) become the ``model_fn``
that :func:`make_model_fn` returns: the model itself runs the kernels on
the card, so ``use_pallas`` has nothing left to select.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sinddm_tpu_torch.diffusion.core import (
    ModelFn,
    NoiseFn,
    make_noise_fn,
    sample_scale0,
    sample_via_scale,
)
from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.models.fast_denoiser import apply_denoiser_dot
from sinddm_tpu_torch.ops import conv_block, dw_conv
from sinddm_tpu_torch.ops.resize import resize_bilinear
from sinddm_tpu_torch.parallel.mesh import NamedSharding, require_named_sharding, split_model_fn
from sinddm_tpu_torch.schedules import Schedules
from sinddm_tpu_torch.utils.profiling import span


FAST_MODES = {"fp32_dot": torch.float32, "bf16_dot": torch.bfloat16}


def make_model_fn(model: SinDDMNet, fast_mode: Optional[str] = None) -> ModelFn:
    """The denoiser executor of a walk: ``model`` itself (kernels 1-2 on
    the card, their plain versions on the CPU), or with ``fast_mode``
    ("fp32_dot" / "bf16_dot") the dot-formulated executor over its parameters
    (:func:`~sinddm_tpu_torch.models.fast_denoiser.apply_denoiser_dot`)."""
    if fast_mode is None:
        return model
    if fast_mode not in FAST_MODES:
        raise ValueError(f"unknown fast_mode {fast_mode!r}: one of {sorted(FAST_MODES)} or None")
    dt = FAST_MODES[fast_mode]
    return lambda x, t, s: apply_denoiser_dot(model, x, t, s, compute_dtype=dt)


def _kernel_launches() -> dict:
    """The launch counters of kernels 1 and 2, read at a scale span's edges;
    kernel 1's launches on wgmma among them."""
    return {"conv_block.launches": conv_block.launches, "conv_block.wgmma_launches": conv_block.wgmma_launches,
            "dw_conv.launches": dw_conv.launches}


def via_scale_size(
    sizes_hw: Sequence[Tuple[int, int]],
    *,
    s: int,
    n_scales: int,
    scale_factor: float,
    scale_mul: Tuple[float, float] = (1.0, 1.0),
    custom_sample: bool = False,
    custom_img_size_idx: int = 0,
    custom_image_size: Optional[Tuple[int, int]] = None,
) -> Tuple[int, int]:
    """Target (H, W) of a via-scale step."""
    if custom_sample:
        if custom_img_size_idx >= n_scales:  # extrapolate past the pyramid
            size = sizes_hw[n_scales - 1]
            factor = scale_factor ** (custom_img_size_idx + 1 - n_scales)
            size = (int(size[0] * factor), int(size[1] * factor))
        else:
            size = sizes_hw[custom_img_size_idx]
    else:
        size = sizes_hw[s]
    image_size = (int(size[0] * scale_mul[0]), int(size[1] * scale_mul[1]))
    if custom_image_size is not None:
        image_size = custom_image_size
    return image_size


def sample_scales(
    model_fn: ModelFn,
    sched: Schedules,
    sizes_hw: Sequence[Tuple[int, int]],
    *,
    scale_factor: float,
    n_scales: int,
    batch_size: int = 16,
    scale_mul: Tuple[float, float] = (1.0, 1.0),
    custom_t_list: Optional[Sequence[int]] = None,
    custom_scales: Optional[Sequence[int]] = None,
    custom_image_size_idxs: Optional[Sequence[int]] = None,
    custom_sample: bool = False,
    start_noise: bool = True,
    start_image: Optional[np.ndarray] = None,
    reblurring: bool = True,
    sample_limited_t: bool = False,
    omega: float = 0.0,
    guidance_factory: Optional[Callable[[int, Tuple[int, int]], Tuple[Any, Any]]] = None,
    carry_transform: Optional[Callable[[int, Any, Tuple[int, int]], Any]] = None,
    collect_aux: Optional[List[Any]] = None,
    collect_interm: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    sharding: Optional[NamedSharding] = None,
    device="cuda",
) -> List[torch.Tensor]:
    """Run the full pyramid; returns the per-scale outputs [B, H, W, 3].

    ``model_fn(x, t, s)`` is the denoiser (a :class:`SinDDMNet`).
    ``start_image`` (float [-1, 1] HWC) is injected at ``custom_scales[0]``
    when ``start_noise`` is False. ``collect_interm`` stacks every
    intermediate state of each scale into its ``collect_aux`` entry under
    ``"interm"``. Noise comes from ``noise_fn`` when given, else from
    ``generator`` on ``device``.

    ``guidance_factory(s, size_hw) -> (guidance_fn, init_carry)`` builds the
    guidance hook of a scale (CLIP) from the scale and its size alone; state
    flows through the carry, which ``carry_transform(s, carry, size_hw)``
    resizes on the way into each finer scale. A scale whose hook is None
    passes the carry on untouched. Each scale's ``collect_aux`` entry then
    also holds the hook's aux, stacked over the steps (``"clip_score"``).

    ``sharding`` splits each denoiser call over the mesh (module docstring);
    a hook that splits its own work takes the sharding from its factory.
    """
    sharding = require_named_sharding(sharding)
    if sharding is not None:
        model_fn = split_model_fn(model_fn, sharding)
    if custom_t_list is None:
        custom_t_list = list(sched.num_timesteps_ideal[1:])
    if custom_scales is None:
        custom_scales = list(range(n_scales))
    if custom_image_size_idxs is None:
        custom_image_size_idxs = list(range(n_scales))
    if noise_fn is None:
        noise_fn = make_noise_fn(generator, device)

    def t_min_of(s: int) -> int:
        if sample_limited_t and s < n_scales - 1:
            return sched.num_timesteps_ideal[s + 1]
        return 0

    def hook(s: int, carry: Any, size_hw: Tuple[int, int]):
        """This scale's guidance hook, and the carry it starts from."""
        if guidance_factory is None:
            return None, carry
        fn, init_carry = guidance_factory(s, size_hw)
        return fn, (carry if carry is not None else init_carry)

    outputs: List[torch.Tensor] = []
    gcarry: Any = None
    with torch.no_grad(), span("sinddm.walk", batch=batch_size, n_scales=len(custom_scales)):
        for i, s in enumerate(int(v) for v in custom_scales):
            aux = None
            if i == 0 and start_noise:
                size0 = sizes_hw[custom_image_size_idxs[0]]
                hw = (int(size0[0] * scale_mul[0]), int(size0[1] * scale_mul[1]))
                steps = sched.num_timesteps - t_min_of(s)
            elif i == 0:
                if start_image is None:
                    raise ValueError("start_noise=False needs start_image")
                hw, steps = tuple(np.shape(start_image)[:2]), 0
            else:
                hw = via_scale_size(
                    sizes_hw, s=s, n_scales=n_scales, scale_factor=scale_factor,
                    scale_mul=scale_mul, custom_sample=custom_sample,
                    custom_img_size_idx=int(custom_image_size_idxs[i]),
                )
                steps = int(custom_t_list[s - 1]) - t_min_of(s)
            with span("sinddm.scale", counters=_kernel_launches, s=s, H=hw[0], W=hw[1], steps=steps):
                if i == 0 and start_noise:
                    gfn, gcarry = hook(s, gcarry, hw)
                    x, gcarry, aux = sample_scale0(
                        model_fn, sched, (batch_size, hw[0], hw[1], 3), s=s,
                        t_min=t_min_of(s), omega=omega, noise_fn=noise_fn,
                        device=device, guidance_fn=gfn, guidance_carry=gcarry,
                        collect_interm=collect_interm,
                    )
                elif i == 0:
                    img = torch.as_tensor(np.asarray(start_image), dtype=torch.float32, device=device)
                    x = img[None].expand((batch_size,) + tuple(img.shape)).contiguous()
                else:
                    if carry_transform is not None and gcarry is not None:
                        gcarry = carry_transform(s, gcarry, hw)
                    gfn, gcarry = hook(s, gcarry, hw)
                    x, gcarry, aux = sample_via_scale(
                        model_fn, sched, resize_bilinear(outputs[-1], hw), s=s,
                        total_t=int(custom_t_list[s - 1]), t_min=t_min_of(s),
                        reblurring=reblurring, omega=omega, noise_fn=noise_fn,
                        guidance_fn=gfn, guidance_carry=gcarry,
                        collect_interm=collect_interm,
                    )
            if collect_aux is not None:
                collect_aux.append(aux)
            outputs.append(x)
    return outputs


def save_interm_scales(aux: Sequence[Any], scales: Sequence[int], sched: Schedules, n_scales: int,
                       sample_limited_t: bool, results_folder) -> None:
    """Write each scale's collected frames (``aux[i]["interm"]``, scale
    ``scales[i]``) as ``interm_samples_scale_{s}/output_t-{t:03}_s-{s}.png``,
    t counting down to the scale's last step; entries without frames are
    skipped."""
    from pathlib import Path

    from sinddm_tpu_torch.ops.image_io import save_interm_frames

    for s, a in zip(scales, aux):
        if not isinstance(a, dict) or a.get("interm") is None:
            continue
        t_min = int(sched.num_timesteps_ideal[s + 1]) if (sample_limited_t and s < n_scales - 1) else 0
        save_interm_frames(a["interm"], Path(results_folder) / f"interm_samples_scale_{s}", s=s, t_min=t_min)
