"""Command line of the port: ``python -m sinddm_tpu_torch.cli --mode train``,
``--mode sample`` and the CLIP-guided modes ``clip_content``,
``clip_style_gen``, ``clip_style_trans`` and ``clip_roi`` (``--target_roi y
x h w`` or ``--interactive``).

Takes the flags of ``sinddm_tpu.cli`` for these modes with the same
defaults and help (the training flags, ``--save_interm``, ``--clip_dtype``,
``--warp_precision``, ``--warp_impl`` among them), plus ``--load_checkpoint``
(an ``.npz`` of the JAX package's denoiser parameters, ``/``-joined keys)
and ``--device`` (default ``cuda``). Weights come from
``--load_reference_ckpt`` (a reference ``model-{milestone}.pt``, the
format ``--mode train`` writes), ``--load_checkpoint``, or
``--load_milestone`` (``model-{milestone}.pt`` of the results folder, -1 the
latest); without any, ``--mode train`` starts from flax's initial
distributions and the other modes sample random weights from ``--seed``.
``--mode train`` trains in float32 (``--compute_dtype bfloat16`` is
refused there), writes ``model-{milestone}.pt``, its loss JSON and
``sample-{milestone}.png`` at every milestone, and walks the pyramid after
training. Writes the same ``final_samples/`` and ``interm_samples_*/`` files
as the JAX CLI. A CLIP mode needs a ViT-B/32 checkpoint (``--clip_weights``
or one of the sniffed paths) and stops without one.

Not taken: ``--steps_per_chunk`` and ``--fused_mode`` (they fuse training
steps into one XLA call; the port runs a step a call), and the mesh flags
(``--coordinator``, ``--num_processes``, ``--process_id``, ``--mesh_data``,
``--mesh_spatial``: the port runs on one card). The other modes arrive with
their slices.
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
    p.add_argument("--mode", required=True, choices=["train", "sample", *CLIP_MODES])
    p.add_argument("--scope", default="forest", help="run name under --results_folder")
    p.add_argument("--dataset_folder", default="./datasets/forest/")
    p.add_argument("--image_name", default="forest.jpeg")
    p.add_argument("--results_folder", default="./results/")
    p.add_argument("--dim", default=160, type=int)
    p.add_argument("--timesteps", default=100, type=int)
    p.add_argument("--scale_factor", default=1.411, type=float)
    # training
    p.add_argument("--train_batch_size", default=32, type=int)
    p.add_argument("--grad_accumulate", default=1, type=int)
    p.add_argument("--train_num_steps", default=120001, type=int)
    p.add_argument("--save_and_sample_every", default=10000, type=int)
    p.add_argument("--avg_window", default=100, type=int)
    p.add_argument("--train_lr", default=1e-3, type=float)
    p.add_argument("--sched_k_milestones", nargs="+", default=[20, 40, 70, 80, 90, 110], type=int)
    p.add_argument("--load_milestone", default=0, type=int)
    p.add_argument("--loss_factor", default=1, type=float)
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
    p.add_argument("--load_reference_ckpt", default=None,
                   help="import a reference PyTorch model-{milestone}.pt "
                        "(denoiser + EMA weights) instead of --load_milestone")
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
    from sinddm_tpu_torch.models.convert_reference import load_reference_checkpoint
    from sinddm_tpu_torch.ops.image_io import save_image
    from sinddm_tpu_torch.pyramid import build_pyramid
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.training.trainer import checkpoint_path

    if args.mode == "train" and args.compute_dtype != "float32":
        raise SystemExit("--mode train trains in float32; --compute_dtype bfloat16 is for the sampling modes")
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
        n_scales=pyramid.n_scales, loss_factor=args.loss_factor, device=device,
    )
    generator = torch.Generator(device=device).manual_seed(args.seed + 777)

    def run_sample(model, desc: str) -> list:
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
        stamp = str(datetime.datetime.now()).replace(":", "_").replace(" ", "_")
        for i, out in enumerate(outs):
            save_image((out + 1) * 0.5, results_folder / "final_samples" / f"out_s{i}_{desc}_{stamp}.png")
        unb = results_folder / f"final_samples_unbatched_{desc}_{stamp}"
        fin01 = (outs[-1] + 1) * 0.5
        for b in range(fin01.shape[0]):
            save_image(fin01[b], unb / f"out_b{b}.png")
        print(f"saved {len(outs)} scales to {results_folder / 'final_samples'}")
        return outs

    if args.mode == "train":
        return run_sample(_train(args, sched, pyramid, results_folder, device), "post_train")

    if args.load_reference_ckpt:
        _, tree, step = load_reference_checkpoint(args.load_reference_ckpt)
        print(f"imported reference checkpoint at step {step}")
    elif args.load_checkpoint:
        tree = args.load_checkpoint
    elif args.load_milestone > 0 or args.load_milestone == -1:
        _, tree, _ = load_reference_checkpoint(checkpoint_path(results_folder, args.load_milestone))
    else:
        tree = random_flax_params(dim=args.dim, seed=args.seed)
    model = denoiser_from_flax(tree, compute_dtype=dtype, device=device)

    if args.mode in CLIP_MODES:
        from sinddm_tpu_torch.apps.clip_apps import run_clip_mode

        return run_clip_mode(
            args, model, sched, pyramid, generator, args.sample_t_list,
            (args.scale_mul[0], args.scale_mul[1]), results_folder, device,
        )
    return run_sample(model, "sample")


def _train(args, sched, pyramid, results_folder, device):
    """--mode train: build the trainer, restore what the flags name, train,
    and return the EMA denoiser. Every milestone writes 16 scale-0 samples
    of the EMA weights as ``sample-{milestone}.png``."""
    import torch

    from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
    from sinddm_tpu_torch.diffusion.core import sample_scale0
    from sinddm_tpu_torch.models.convert import denoiser_params_from_flax
    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.ops.image_io import save_image
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    train_cfg = TrainConfig(
        train_batch_size=args.train_batch_size, train_lr=args.train_lr, train_num_steps=args.train_num_steps,
        grad_accumulate=args.grad_accumulate, save_and_sample_every=args.save_and_sample_every,
        avg_window=args.avg_window, sched_milestones=tuple(v * 1000 for v in args.sched_k_milestones),
    )
    diff_cfg = DiffusionConfig(timesteps=args.timesteps, scale_factor=args.scale_factor,
                               loss_factor=args.loss_factor, sample_limited_t=args.sample_limited_t,
                               omega=args.omega)
    trainer = MultiscaleTrainer(SinDDMNet(dim=args.dim, device=device), sched, pyramid, train_cfg, diff_cfg,
                                results_folder, seed=args.seed, device=device)
    if args.load_reference_ckpt:
        trainer.load_path(args.load_reference_ckpt)
        print(f"imported reference checkpoint at step {trainer.step}")
    elif args.load_checkpoint:
        params = denoiser_params_from_flax(args.load_checkpoint)
        trainer.model.load_state_dict(params, strict=True)
        trainer.ema_model.load_state_dict(params, strict=True)
    elif args.load_milestone > 0 or args.load_milestone == -1:
        trainer.load(args.load_milestone)
        print(f"resumed at step {trainer.step}")

    def on_milestone(milestone, tr):
        h0, w0 = pyramid.sizes_hw[0]
        with torch.no_grad():
            x, _, _ = sample_scale0(tr.ema_model, sched, (16, h0, w0, 3), s=0, t_min=0, omega=args.omega,
                                    generator=torch.Generator(device=device).manual_seed(milestone),
                                    device=device)
        save_image((x + 1) * 0.5, results_folder / f"sample-{milestone}.png")

    trainer.train(on_milestone=on_milestone)
    return trainer.ema_model


if __name__ == "__main__":
    main()
