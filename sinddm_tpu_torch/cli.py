"""Command line of the port: ``python -m sinddm_tpu_torch.cli --mode sample``
and the CLIP-guided modes ``clip_content``, ``clip_style_gen``,
``clip_style_trans`` and ``clip_roi`` (``--target_roi y x h w`` or
``--interactive``).

Takes the flags of ``sinddm_tpu.cli`` for these modes with the same
defaults and help (``--save_interm``, ``--clip_dtype``, ``--warp_precision``,
``--warp_impl`` among them), plus ``--load_checkpoint`` (an ``.npz`` of the
JAX package's denoiser parameters, ``/``-joined keys; without it the weights
are random from ``--seed``) and ``--device`` (default ``cuda``). Writes the
same ``final_samples/`` and ``interm_samples_*/`` files as the JAX CLI. A
CLIP mode needs a ViT-B/32 checkpoint (``--clip_weights`` or one of the
sniffed paths) and stops without one. The other modes arrive with their
slices.
"""

from __future__ import annotations

import argparse
import datetime
import os
from pathlib import Path


CLIP_MODES = ("clip_content", "clip_style_gen", "clip_style_trans", "clip_roi")


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sinddm_tpu_torch")
    p.add_argument("--mode", required=True, choices=["sample", *CLIP_MODES])
    p.add_argument("--scope", default="forest", help="run name under --results_folder")
    p.add_argument("--dataset_folder", default="./datasets/forest/")
    p.add_argument("--image_name", default="forest.jpeg")
    p.add_argument("--results_folder", default="./results/")
    p.add_argument("--dim", default=160, type=int)
    p.add_argument("--timesteps", default=100, type=int)
    p.add_argument("--scale_factor", default=1.411, type=float)
    p.add_argument("--sample_batch_size", default=16, type=int)
    p.add_argument("--scale_mul", nargs="+", default=[1, 1], type=float)
    p.add_argument("--sample_t_list", nargs="+", type=int)
    p.add_argument("--sample_limited_t", action="store_true")
    p.add_argument("--omega", default=0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--load_checkpoint", default=None,
                   help=".npz of the denoiser's parameters in the JAX package's "
                        "layout, '/'-joined keys (e.g. l3/net_conv1/kernel)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument("--target_roi", nargs=4, type=int,
                   help="source ROI box 'y x h w' (headless)")
    p.add_argument("--interactive", action="store_true",
                   help="use the OpenCV ROI selector instead of flags")
    p.add_argument("--save_interm", action="store_true",
                   help="dump every intermediate denoised state as PNG grids under "
                        "interm_samples_scale_{s}/ (and interm_samples_clip_roi/ for "
                        "clip_roi) -- all sampling modes")
    # clip
    p.add_argument("--clip_text", default="Fire in the Forest")
    p.add_argument("--fill_factor", type=float)
    p.add_argument("--strength", type=float)
    p.add_argument("--clip_weights", default=None,
                   help="path to CLIP ViT-B/32 weights (OpenAI .pt archive or a state dict)")
    p.add_argument("--clip_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="CLIP vision-tower compute dtype (bfloat16: the tower's matrix "
                        "products on the bf16 tensor cores, parameters and LayerNorms fp32)")
    p.add_argument("--warp_precision", default="highest", choices=["highest", "high"],
                   help="precision of the matrix-product view warp (--warp_impl mm, and "
                        "the CPU path): 'highest' is fp32-exact vs the gather path; 'high' "
                        "runs its products in TF32 on a CUDA device. The warp kernels "
                        "ignore it")
    p.add_argument("--n_aug", type=_positive_int, default=16,
                   help="augmented CLIP views per guided image")
    p.add_argument("--clip_view_chunk", type=int, default=8,
                   help="guidance views encoded and differentiated per sequential "
                        "chunk (0 = all at once)")
    p.add_argument("--warp_impl", default=None,
                   choices=["mm", "pallas", "pallas_win", "pallas_winx", "pallas_winb"],
                   help="guidance view-warp executor (default: the 'pallas_winx' CUDA "
                        "kernel on a CUDA device, the matrix-product version on the "
                        "CPU). 'mm' forces the matrix-product version; 'pallas' (whole "
                        "image), 'pallas_win' and 'pallas_winb' are the other kernels of "
                        "sinddm_tpu_torch/csrc/warp_sample.cu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    run(args)


def run(args) -> list:
    import torch

    from sinddm_tpu_torch.apps.sampling import sample_scales, save_interm_scales
    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.ops.image_io import save_image
    from sinddm_tpu_torch.pyramid import build_pyramid
    from sinddm_tpu_torch.schedules import make_schedules

    device = torch.device(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.compute_dtype]
    results_folder = Path(args.results_folder) / args.scope
    pyramid = build_pyramid(
        os.path.join(args.dataset_folder, args.image_name),
        scale_factor=args.scale_factor,
        auto_scale=50000,
        save_to=args.dataset_folder if os.access(args.dataset_folder, os.W_OK) else None,
    )
    sched = make_schedules(
        timesteps=args.timesteps, scale_losses=pyramid.rescale_losses,
        n_scales=pyramid.n_scales, device=device,
    )
    tree = args.load_checkpoint or random_flax_params(dim=args.dim, seed=args.seed)
    model = denoiser_from_flax(tree, compute_dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed + 777)

    if args.mode in CLIP_MODES:
        from sinddm_tpu_torch.apps.clip_apps import run_clip_mode

        return run_clip_mode(
            args, model, sched, pyramid, generator, args.sample_t_list,
            (args.scale_mul[0], args.scale_mul[1]), results_folder, device,
        )

    interm_aux = [] if args.save_interm else None
    outs = sample_scales(
        model, sched, pyramid.sizes_hw,
        scale_factor=pyramid.scale_factor, n_scales=pyramid.n_scales,
        batch_size=args.sample_batch_size,
        scale_mul=(args.scale_mul[0], args.scale_mul[1]),
        custom_t_list=args.sample_t_list, sample_limited_t=args.sample_limited_t,
        omega=args.omega, custom_sample=True, collect_aux=interm_aux,
        collect_interm=args.save_interm, generator=generator, device=device,
    )
    if interm_aux is not None:
        save_interm_scales(interm_aux, range(len(interm_aux)), sched, pyramid.n_scales,
                           args.sample_limited_t, results_folder)
    desc = "sample"
    stamp = str(datetime.datetime.now()).replace(":", "_").replace(" ", "_")
    for i, out in enumerate(outs):
        save_image((out + 1) * 0.5, results_folder / "final_samples" / f"out_s{i}_{desc}_{stamp}.png")
    unb = results_folder / f"final_samples_unbatched_{desc}_{stamp}"
    fin01 = (outs[-1] + 1) * 0.5
    for b in range(fin01.shape[0]):
        save_image(fin01[b], unb / f"out_b{b}.png")
    print(f"saved {len(outs)} scales to {results_folder / 'final_samples'}")
    return outs


if __name__ == "__main__":
    main()
