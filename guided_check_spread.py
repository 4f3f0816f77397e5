#!/usr/bin/env python3
"""Spread of ``chip_smoke.py``'s phase-6 path checks over many inputs.

The guided walk does not repeat from run to run: the warp adjoint's atomics
add in a new order each time, and 143 guided steps carry that last-bit
difference to O(1) changes in the output. So each run of ``chip_smoke.py``
hands the checks that read the walk's output a new input, and a bound there
must hold over the inputs, not over one run. This script runs the walk once
(as phase 6 does: balloons geometry, dim=160, batch 16, random ViT-B/32) and
then, for each of ``--inputs`` inputs (fresh view draws; the walk's output,
with seeded noise for the hook), measures the kernel path (``winx``, the
default) against the plain warp (``mm``):

* one guidance iteration: the share of gradient elements over
  GUIDE_TOL·max|g|, the worst element over max|g|, the cosine, the loss;
* the first guided step (it fixes the edit mask): the share of x over 1e-4,
  the share of pixels where the masks differ, the least per-sample cosine of
  the update x_out - x_in;
* the next guided step, with that mask: the share of x over 1e-4.

With ``--walks K`` it also measures phase 10's walk checks over K inputs
(new draws each): a batch-2 ``clip_style_trans`` walk bucketed against
per-scale on the same draws, the per-scale walk against itself, and a
control on other draws (which must break the bounds). With
``--mesh_walks K``, phase 11's: the batch-4 ``clip_content`` walk against
itself on the same seed, and a control on another seed.

It prints one line an input, then for each quantity its least, median and
largest value and the number of inputs past each bound chip_smoke.py has
held it to. Needs one CUDA card and nvcc, as chip_smoke.py does:

    python3 guided_check_spread.py [--inputs 40] [--walks 0] [--mesh_walks 0]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# quantity -> bounds to count: (name, limit, "max" if values above fail, "min" if below)
BOUNDS = {
    "iter_share": [("GUIDE_OUTLIERS", 1e-3, "max")],
    "iter_worst": [("former GUIDE_WORST", 5e-2, "max")],
    "iter_cos": [("GUIDE_COS", 0.999, "min")],
    "iter_loss_diff": [("loss", 1e-4, "max")],
    "first_x_share": [("former x bound of the first step", 1e-3, "max")],
    "first_mask_off": [("mask", 1e-3, "max")],
    "first_update_cos": [("GUIDE_COS", 0.999, "min")],
    "masked_x_share": [("GUIDE_OUTLIERS", 1e-3, "max")],
}
# phase 10's walk checks (chip_smoke.py WALK_*); the control on other draws must be past one
WALK_BOUNDS = {"share_over_0.1": ("WALK_SHARE", "max"), "cosine": ("WALK_COS", "min"),
               "score_rel": ("WALK_SCORE_REL", "max")}
WALK_PAIRS = ("style_trans bucketed", "style_trans repeat", "style_trans control")
# phase 11's (chip_smoke.py MESH_WALK_*)
MESH_WALK_PAIRS = ("content repeat", "content control")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--inputs", type=int, default=40)
    parser.add_argument("--walks", type=int, default=0)
    parser.add_argument("--mesh_walks", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sinddm_tpu_torch.apps.clip_apps import clip_mode_config, clip_sampling
    from sinddm_tpu_torch.guidance import clip_extractor as ce, clip_guidance as cg
    from sinddm_tpu_torch.models.clip.convert import random_clip_params
    from sinddm_tpu_torch.models.clip.model import VIT_B_32
    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.ops import _build
    from sinddm_tpu_torch.pyramid import Pyramid, compute_pyramid_geometry
    from sinddm_tpu_torch.schedules import make_schedules

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _, sizes_wh, factor, n_scales = compute_pyramid_geometry(cs.BALLOONS_WH)
    sizes_hw = [(h, w) for (w, h) in sizes_wh]
    sched = make_schedules(timesteps=100, scale_losses=cs.BALLOONS_LOSSES, n_scales=n_scales, device="cuda")
    model = denoiser_from_flax(random_flax_params(dim=cs.DIM, seed=0), device="cuda")
    clip_model = random_clip_params(VIT_B_32, seed=0, device="cuda")
    pyramid = Pyramid(sizes_hw=tuple(sizes_hw), sizes_wh=tuple(sizes_wh), images=(), recon_images=(),
                      rescale_losses=cs.BALLOONS_LOSSES, scale_factor=factor, n_scales=n_scales)
    mode_cfg = clip_mode_config("clip_content", "Fire in the Forest", cs.STRENGTH, cs.FILL_FACTOR, n_scales)
    b = cs.BATCH
    h_fin, w_fin = sizes_hw[-1]
    hook_kw = dict(s=n_scales - 1, n_scales=n_scales, sub_iters=1, strength=cs.STRENGTH,
                   quantile=1.0 - cs.FILL_FACTOR, llambda=0.2)

    for name, (const, side) in WALK_BOUNDS.items():
        for pair in WALK_PAIRS:
            BOUNDS[f"{pair} {name}"] = [(const, getattr(cs, const), side)]
        for pair in MESH_WALK_PAIRS:
            BOUNDS[f"{pair} {name}"] = [(f"MESH_{const}", getattr(cs, f"MESH_{const}"), side)]
    values = {k: [] for k in BOUNDS}
    images = tuple((torch.rand((h, w, 3), generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
                    * 2 - 1).cpu().numpy() for h, w in sizes_hw)
    st = dict(model=model, sched=sched, clip_model=clip_model, batch=2,
              pyramid=Pyramid(sizes_hw=tuple(sizes_hw), sizes_wh=tuple(sizes_wh), images=images, recon_images=(),
                              rescale_losses=cs.BALLOONS_LOSSES, scale_factor=factor, n_scales=n_scales),
              mode_cfg=clip_mode_config("clip_style_trans", "Fire in the Forest", None, None, n_scales))
    start = torch.nn.functional.interpolate(
        torch.as_tensor(images[-2], device="cuda").permute(2, 0, 1)[None], size=sizes_hw[-1], mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0)
    for i in range(args.walks):
        rec = []
        ref = cs.guided_walk(seed=1000 + i, bucketed=False, record=rec, **st)
        row = {"style_trans bucketed": cs.guided_walk(seed=1000 + i, bucketed=True, replay=rec, **st),
               "style_trans repeat": cs.guided_walk(seed=1000 + i, bucketed=False, replay=rec, **st),
               "style_trans control": cs.guided_walk(seed=2000 + i, bucketed=True, **st)}
        row = {k: cs.walk_stats(v, ref, start) for k, v in row.items()}
        for pair, r in row.items():
            for name, v in r.items():
                values[f"{pair} {name}"].append(v)
        print(f"[walks {i}] " + " ".join(f"{pair}: " + " ".join(f"{k} {v:.6g}" for k, v in r.items()) + ";"
                                         for pair, r in row.items()), flush=True)
    content = dict(model=model, sched=sched, clip_model=clip_model, batch=cs.MESH_GUIDED_BATCH, pyramid=pyramid,
                   mode_cfg=mode_cfg, bucketed=False)
    for i in range(args.mesh_walks):
        ref = cs.guided_walk(seed=3000 + i, **content)
        row = {"content repeat": cs.walk_stats(cs.guided_walk(seed=3000 + i, **content), ref),
               "content control": cs.walk_stats(cs.guided_walk(seed=4000 + i, **content), ref)}
        for pair, r in row.items():
            for name, v in r.items():
                values[f"{pair} {name}"].append(v)
        print(f"[mesh walks {i}] wall {ref[2]:.2f} s " + " ".join(
            f"{pair}: " + " ".join(f"{k} {v:.6g}" for k, v in r.items()) + ";" for pair, r in row.items()), flush=True)
    if args.inputs == 0:
        _summary(values, t0)
        return

    guide_gen = torch.Generator(device="cuda").manual_seed(0)
    extractor = ce.ClipExtractor(clip_model, n_aug=cs.N_AUG, view_chunk=cs.VIEW_CHUNK, generator=guide_gen)
    plain_ex = ce.ClipExtractor(clip_model, n_aug=cs.N_AUG, view_chunk=cs.VIEW_CHUNK, warp_impl="mm")
    g_outs, _ = clip_sampling(model, sched, pyramid, extractor, sample_batch_size=b,
                              stop_guidance=cs.STOP_GUIDANCE, reblurring=False, generator=guide_gen,
                              device="cuda", **mode_cfg)
    fin = g_outs[-1]
    text_hr = extractor.get_text_embedding(mode_cfg["text_input"], ce.get_augmentations_template("hr"))
    print(f"[walk] {time.perf_counter() - t0:.1f} s; share of the output on the clip bound "
          f"{(fin.abs() >= 1.0).float().mean().item():.4f}", flush=True)

    def hook_pair(x_recon, t_step, carry, draws):
        out = []
        for ex in (extractor, plain_ex):
            fn = cg.make_clip_guidance(ex, text_hr, stop_guidance=cs.STOP_GUIDANCE,
                                       draw_fn=lambda bb, n: draws, **hook_kw)
            with torch.no_grad():
                out.append(fn(x_recon, None, t_step, n_scales - 1, carry))
        return out

    for i in range(args.inputs):
        draws = extractor.draw(b, text_hr.shape[0])
        x01 = (fin.clamp(-1.0, 1.0) + 1.0) * 0.5
        with torch.no_grad():
            loss_k, grad_k = extractor.clip_loss_and_grad(x01, text_hr, draws)
            loss_p, grad_p = plain_ex.clip_loss_and_grad(x01, text_hr, draws)
        g_max = grad_p.abs().max().item()
        diff = (grad_k - grad_p).abs()
        row = dict(iter_share=cs.share_over(diff, cs.GUIDE_TOL * g_max), iter_worst=diff.max().item() / g_max,
                   iter_cos=((grad_k * grad_p).sum() / (grad_k.norm() * grad_p.norm())).item(),
                   iter_loss_diff=abs(loss_k.item() - loss_p.item()))

        noise_gen = torch.Generator(device="cuda").manual_seed(i)
        x_recon = fin + 0.05 * torch.randn(fin.shape, generator=noise_gen, device="cuda")
        x_in = x_recon.clamp(-1.0, 1.0)
        (xk, ck, _), (xp, cp, _) = hook_pair(x_recon, 10, cg.init_clip_carry(b, (h_fin, w_fin)), draws)
        uk, up = (xk - x_in).reshape(b, -1), (xp - x_in).reshape(b, -1)
        row.update(first_x_share=cs.share_over((xk - xp).abs(), 1e-4),
                   first_mask_off=(ck.mask != cp.mask).float().mean().item(),
                   first_update_cos=((uk * up).sum(1) / (uk.norm(dim=1) * up.norm(dim=1))).min().item())
        (xk, _, _), (xp, _, _) = hook_pair(x_recon, 9, ck, extractor.draw(b, text_hr.shape[0]))
        row["masked_x_share"] = cs.share_over((xk - xp).abs(), 1e-4)
        for k, v in row.items():
            values[k].append(v)
        print(f"[input {i}] " + " ".join(f"{k} {v:.9g}" for k, v in row.items()), flush=True)

    _summary(values, t0)


def _summary(values, t0) -> None:
    """For each measured quantity: its least, median and largest value and
    the inputs past each bound."""
    for k, vs in values.items():
        if not vs:
            continue
        s = sorted(vs)
        past = ", ".join(f"past {name} ({lim:g}): {sum(v > lim if side == 'max' else v < lim for v in vs)}"
                         for name, lim, side in BOUNDS[k])
        print(f"[spread] {k}: least {s[0]:.9g} median {s[len(s) // 2]:.9g} largest {s[-1]:.9g} "
              f"over {len(s)} inputs; {past}", flush=True)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
