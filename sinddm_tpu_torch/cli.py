"""Command line of the port: ``python -m sinddm_tpu_torch.cli --mode M``, for
every mode of the JAX CLI: ``train``, ``sample``, the CLIP-guided modes
``clip_content``, ``clip_style_gen``, ``clip_style_trans`` and ``clip_roi``
(``--target_roi y x h w`` or ``--interactive``), the image-to-image modes
``harmonization`` and ``style_transfer`` (``--input_image`` and, for
harmonization, ``--harm_mask``, both read from ``{dataset_folder}/i2i/``),
and ``roi`` (``--target_roi`` and one ``--roi_bb y x h w`` a target box, or
``--interactive`` with ``--roi_n_tar`` boxes).

Takes the flags of ``sinddm_tpu.cli`` for these modes with the same
defaults and help (the training flags, ``--save_interm``, ``--clip_dtype``,
``--warp_precision``, ``--warp_impl`` among them), plus ``--load_checkpoint``
(an ``.npz`` of the JAX package's denoiser parameters, ``/``-joined keys,
such as ``weights/balloons-120k-ema.npz``) and ``--device`` (default
``cuda``). ``--device_num N`` selects ``cuda:N`` and is refused with
``--device cpu``. ``--profile DIR`` wraps the mode in a ``torch.profiler``
trace written under DIR. Weights come from ``--load_reference_ckpt`` (a
reference ``model-{milestone}.pt``, the format ``--mode train`` writes),
``--load_checkpoint``, or ``--load_milestone`` (``model-{milestone}.pt`` of
the results folder, -1 the latest); without any, ``--mode train`` starts from
flax's initial distributions and the other modes sample random weights from
``--seed``. ``--mode train`` trains in float32 (``--compute_dtype bfloat16``
is refused there), writes ``model-{milestone}.pt``, its loss JSON and
``sample-{milestone}.png`` at every milestone, and walks the pyramid after
training. Writes the same files as the JAX CLI (``final_samples/``,
``i2i_final_samples/``, ``unbatched_i2i_*/``, ``roi_patches.png``,
``interm_samples_*/``). A CLIP mode needs a ViT-B/32 checkpoint
(``--clip_weights`` or one of the sniffed paths) and stops without one.

``--steps_per_chunk`` and ``--fused_mode`` keep the JAX CLI's defaults and
meanings: ``--mode train`` runs chunks of 100 steps, each visiting every
scale in equal counts at its true shape (``grouped``), or on one padded
canvas with the scale drawn on the card (``padded``); on the card a chunk's
steps are CUDA-graph replays (``training/trainer.py``). ``--steps_per_chunk
0`` trains step by step. ``--precompile`` builds every CUDA kernel before the
mode runs, one ``nvcc`` a source, all at once, and prints the build's
seconds: the port's counterpart of compiling the sampler's executables
ahead of the walk (PyTorch compiles nothing else); without it a kernel is
built at its first use. The port's parser takes every flag of the JAX CLI.

A world of ranks, one process a card: every process runs the same command
line with ``--coordinator host:port --num_processes N --process_id i`` (or
the ``SINDDM_*`` environment, or under ``torchrun``), and ``--mesh_data D
--mesh_spatial S`` lays the ranks out as the JAX CLI lays devices; the
world must be exactly ``D * S`` ranks. The world is joined before anything
touches CUDA (``parallel/distributed.py`` sets out the backend rule: NCCL
with a card a rank, gloo where ranks share a card, gloo on the CPU with
``--device cpu``). The local rank picks the card, so ``--device_num`` is
refused in a world. Every rank runs the mode, split over the mesh
(``parallel/mesh.py``); only rank 0 writes files, and ``--profile DIR``
writes one trace a rank under ``DIR/rank{r}``.

``--bucketed_guidance`` runs the via scales of ``clip_content`` and
``clip_style_*`` on the finest scale's canvas
(``sinddm_tpu_torch/diffusion/bucketed.py``). ``--guidance_seg_len N`` is
taken so that the JAX CLI's command lines run, and changes nothing: the JAX
CLI cuts each chain into device calls of N steps, while the port runs a step
a call already. A negative N is refused (the JAX CLI takes it and samples
nothing).
"""

from __future__ import annotations

import argparse
import datetime
import os
from pathlib import Path


CLIP_MODES = ("clip_content", "clip_style_gen", "clip_style_trans", "clip_roi")
I2I_MODES = ("harmonization", "style_transfer")


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def _non_negative_int(v: str) -> int:
    n = int(v)
    if n < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sinddm_tpu_torch")
    p.add_argument("--mode", required=True, choices=["train", "sample", *CLIP_MODES, *I2I_MODES, "roi"])
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
    p.add_argument("--steps_per_chunk", default=100, type=int,
                   help="train steps a chunk, one loss fetch a chunk; on a CUDA card each step a "
                        "CUDA-graph replay (0 = per-step)")
    p.add_argument("--fused_mode", default="grouped", choices=["grouped", "padded"],
                   help="chunk strategy (see TrainConfig): per-scale sub-chunks at true shapes, or "
                        "one padded canvas with the scale drawn on the device")
    p.add_argument("--precompile", action="store_true",
                   help="build every CUDA kernel (one nvcc a source, all at once) before the mode "
                        "runs, and print the seconds; without it a kernel is built at its first use")
    p.add_argument("--load_checkpoint", default=None,
                   help=".npz of the denoiser's parameters in the JAX package's "
                        "layout, '/'-joined keys (e.g. l3/net_conv1/kernel)")
    p.add_argument("--load_reference_ckpt", default=None,
                   help="import a reference PyTorch model-{milestone}.pt "
                        "(denoiser + EMA weights) instead of --load_milestone")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument("--device_num", default=0, type=int,
                   help="index of the CUDA card to run on (cuda:N, the reference's main.py:53 "
                        "meaning); refused with --device cpu")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: rank 0's rendezvous address host:port; every "
                        "process runs the same CLI with --num_processes/--process_id (or "
                        "SINDDM_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID env, or torchrun's) and "
                        "the mesh spans all ranks, one a card (parallel/distributed.py)")
    p.add_argument("--num_processes", default=None, type=int,
                   help="multi-process: total number of processes (ranks)")
    p.add_argument("--process_id", default=None, type=int,
                   help="multi-process: this process's index (its rank)")
    p.add_argument("--mesh_data", default=1, type=int,
                   help="ranks on the 'data' (batch) mesh axis; "
                        "mesh_data*mesh_spatial ranks are used (1 1 = no mesh)")
    p.add_argument("--mesh_spatial", default=1, type=int,
                   help="ranks on the 'spatial' (image H) mesh axis")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the mode (host, and the card's kernels "
                        "on a CUDA device) into DIR (open with TensorBoard)")
    # i2i
    p.add_argument("--input_image", default="seascape_composite_dragon.png")
    p.add_argument("--start_t_harm", default=5, type=int)
    p.add_argument("--start_t_style", default=15, type=int)
    p.add_argument("--harm_mask", default="seascape_mask_dragon.png")
    # roi
    p.add_argument("--roi_n_tar", default=1, type=int)
    p.add_argument("--roi_bb", nargs="+", type=int, action="append",
                   help="target ROI box 'y x h w' (repeatable; headless)")
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
    p.add_argument("--bucketed_guidance", action="store_true",
                   help="run every guided via scale on the finest-scale canvas, the JAX "
                        "package's shape-bucketed walk (clip_content and clip_style_*, "
                        "clip_style_trans's injection included). The same sampling process "
                        "with other noise draws than the per-scale walk (they are drawn at "
                        "the canvas's shape), and scales below the finest frame their CLIP "
                        "views as the finest scale does: per-sample outputs differ, "
                        "distributions match. The denoiser runs on each scale's valid crop")
    p.add_argument("--guidance_seg_len", type=_non_negative_int, default=0,
                   help="accepted for the JAX CLI's command lines and ignored: there it "
                        "caps each device call at N denoise steps (0 = the whole scale a "
                        "call); the port runs one step a call already")
    return p


def main(argv=None) -> None:
    from sinddm_tpu_torch.parallel import distributed

    args = build_parser().parse_args(argv)
    try:
        run(args)
    finally:
        distributed.shutdown()


def run(args) -> list:
    """Run the mode that ``args`` names; returns its outputs on the device
    (the per-scale outputs in [-1, 1]; for harmonization and style transfer
    the final composite in [0, 1]). Joins the world that the flags or the
    environment name first (and stays in it: :func:`main` leaves it)."""
    import torch

    from sinddm_tpu_torch.config import MeshConfig
    from sinddm_tpu_torch.parallel import distributed
    from sinddm_tpu_torch.parallel.mesh import batch_sharding

    # the world first: an NCCL rank binds its card before anything touches CUDA
    try:
        in_world = distributed.initialize(args.coordinator, args.num_processes, args.process_id, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    device = torch.device(args.device)
    if in_world:
        if args.device_num:
            raise SystemExit("--device_num is refused in a world of ranks: each rank's local rank picks its card")
        device = distributed.runtime().device
    elif args.device_num:
        if device.type != "cuda":
            raise SystemExit("--device_num selects a CUDA card; it cannot be combined with --device cpu")
        device = torch.device("cuda", args.device_num)
    if args.precompile:
        _precompile(device, in_world)
    mesh_cfg = MeshConfig(data=args.mesh_data, spatial=args.mesh_spatial)
    try:
        mesh = mesh_cfg.build()
        if args.mode == "train":
            mesh_cfg.validate_batch(args.train_batch_size, "--train_batch_size")
        mesh_cfg.validate_batch(args.sample_batch_size, "--sample_batch_size")
    except ValueError as e:
        raise SystemExit(str(e))
    sharding = None
    if mesh is not None:
        import torch.distributed as dist

        cards = [None] * mesh.size
        dist.all_gather_object(cards, f"{os.uname().nodename}:{device}")
        if distributed.is_primary():
            print(f"mesh: {mesh.shape} backend {distributed.runtime().backend} ranks->cards "
                  f"{dict(enumerate(cards))}", flush=True)
        distributed.build_kernels_once()
        sharding = batch_sharding(mesh)
    if not args.profile:
        return _run_mode(args, device, sharding)
    from sinddm_tpu_torch.utils.profiling import trace

    with trace(args.profile, device):
        outs = _run_mode(args, device, sharding)
    print(f"profiler trace written to {args.profile}")
    return outs


def _precompile(device, in_world: bool) -> None:
    """--precompile: build every CUDA kernel before the mode runs (all
    ``nvcc`` jobs at once; in a world, local rank 0 builds while the others
    wait) and print the seconds it took. The CPU runs the plain versions and
    builds nothing."""
    import time

    from sinddm_tpu_torch.ops import _build
    from sinddm_tpu_torch.parallel import distributed

    if device.type != "cuda":
        print("precompile: nothing to build on the CPU (the kernels' plain versions run there)")
        return
    t0 = time.perf_counter()
    if in_world:
        distributed.build_kernels_once()
    else:
        _build.build()
    print(f"precompile: built the CUDA kernels in {time.perf_counter() - t0:.2f} s")


def _run_mode(args, device, sharding=None) -> list:
    import torch

    from sinddm_tpu_torch.apps.sampling import sample_scales, save_interm_scales
    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.models.convert_reference import load_reference_checkpoint
    from sinddm_tpu_torch.ops.image_io import save_image
    from sinddm_tpu_torch.parallel import distributed
    from sinddm_tpu_torch.pyramid import build_pyramid
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.training.trainer import checkpoint_path

    if args.mode == "train" and args.compute_dtype != "float32":
        raise SystemExit("--mode train trains in float32; --compute_dtype bfloat16 is for the sampling modes")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.compute_dtype]
    results_folder = Path(args.results_folder) / args.scope
    primary = distributed.is_primary()
    pyramid = build_pyramid(
        os.path.join(args.dataset_folder, args.image_name),
        scale_factor=args.scale_factor,
        auto_scale=50000,
        save_to=args.dataset_folder if primary and os.access(args.dataset_folder, os.W_OK) else None,
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
            collect_interm=args.save_interm, generator=generator, sharding=sharding, device=device,
        )
        if not primary:
            return outs
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
        return run_sample(_train(args, sched, pyramid, results_folder, device, sharding), "post_train")

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
            (args.scale_mul[0], args.scale_mul[1]), results_folder, device, sharding,
        )
    if args.mode in I2I_MODES:
        return _i2i(args, model, sched, pyramid, generator, results_folder, device, sharding)
    if args.mode == "roi":
        return _roi(args, model, sched, pyramid, generator, results_folder, device, sharding)
    return run_sample(model, "sample")


def _i2i(args, model, sched, pyramid, generator, results_folder, device, sharding=None) -> list:
    """--mode harmonization / style_transfer: the input (and the mask) from
    ``{dataset_folder}/i2i/``, injected at the finest scale with
    ``--start_t_harm`` / ``--start_t_style`` steps; writes the batch grid
    ``i2i_final_samples/{stem}_i2i_{mode}.png`` and each sample as
    ``unbatched_i2i_{stem}/out_b{b}.png``."""
    import numpy as np

    from sinddm_tpu_torch.apps.i2i import image2image
    from sinddm_tpu_torch.apps.sampling import save_interm_scales
    from sinddm_tpu_torch.ops.image_io import save_image
    from sinddm_tpu_torch.parallel import distributed
    from sinddm_tpu_torch.pyramid import load_external_image

    i2i_folder = os.path.join(args.dataset_folder, "i2i")
    input_img = load_external_image(os.path.join(i2i_folder, args.input_image), auto_scale=50000)
    mask_img = None
    if args.mode == "harmonization":
        from PIL import Image

        mask_img = np.asarray(Image.open(os.path.join(i2i_folder, args.harm_mask)).convert("RGB"),
                              np.float32) / 255.0
    start_t = args.start_t_harm if args.mode == "harmonization" else args.start_t_style
    n = pyramid.n_scales
    interm_aux = [] if args.save_interm else None
    final, _ = image2image(
        model, sched, pyramid, input_img, mode=args.mode, mask_img=mask_img, start_s=n - 1,
        custom_t=[0] * (n - 1) + [start_t], batch_size=args.sample_batch_size, omega=args.omega,
        sample_limited_t=args.sample_limited_t, collect_aux=interm_aux, collect_interm=args.save_interm,
        generator=generator, sharding=sharding, device=device,
    )
    if not distributed.is_primary():
        return [final]
    if interm_aux is not None:
        save_interm_scales(interm_aux, [n - 1], sched, n, args.sample_limited_t, results_folder)
    out_dir = results_folder / "i2i_final_samples"
    stem = args.input_image.rsplit(".", 1)[0]
    final_host = final.cpu()
    save_image(final_host, out_dir / f"{stem}_i2i_{args.mode}.png")
    for b in range(final_host.shape[0]):
        save_image(final_host[b], results_folder / f"unbatched_i2i_{stem}" / f"out_b{b}.png")
    print(f"saved i2i results to {out_dir}")
    return [final]


def _roi(args, model, sched, pyramid, generator, results_folder, device, sharding=None) -> list:
    """--mode roi: the source box (``--target_roi``) pasted into each target
    box (``--roi_bb``, on the ``--scale_mul``-enlarged canvas) at every scale
    below the finest, or both drawn with OpenCV's selector
    (``--interactive``); writes the ``roi_patches.png`` preview and
    ``final_samples/roi_out.png``."""
    import numpy as np
    from PIL import Image

    from sinddm_tpu_torch.apps.clip_apps import _roi_box
    from sinddm_tpu_torch.apps.roi import roi_guided_sampling
    from sinddm_tpu_torch.apps.sampling import save_interm_scales
    from sinddm_tpu_torch.ops.image_io import save_image, to_uint8
    from sinddm_tpu_torch.parallel import distributed

    if not args.interactive and (args.target_roi is None or not args.roi_bb):
        raise SystemExit("--roi mode needs --target_roi and --roi_bb (or --interactive)")
    n = pyramid.n_scales
    scale_mul = (args.scale_mul[0], args.scale_mul[1])
    h_fin, w_fin = pyramid.sizes_hw[n - 1]
    canvas_h, canvas_w = int(h_fin * scale_mul[0]), int(w_fin * scale_mul[1])
    target_roi = _roi_box(args, n)
    if args.interactive:
        import cv2

        empty = np.ones((canvas_h, canvas_w, 3))
        roi_bb_list = []
        for _ in range(args.roi_n_tar):
            r = cv2.selectROI(empty)
            roi_bb_list.append([r[1], r[0], r[3], r[2]])
    else:
        roi_bb_list = [list(bb) for bb in args.roi_bb]

    # the preview: the source patch nearest-resized into each target box of an empty canvas
    src01 = (np.asarray(pyramid.images[n - 1]) + 1.0) * 0.5
    ty, tx, th, tw = (int(v) for v in target_roi)
    patch_u8 = Image.fromarray(to_uint8(src01[ty : ty + th, tx : tx + tw, :]))
    preview = np.ones((canvas_h, canvas_w, 3), np.float32)
    for bb in roi_bb_list:
        y, x, h, w = (int(v) for v in bb)
        preview[y : y + h, x : x + w, :] = np.asarray(patch_u8.resize((w, h), Image.NEAREST), np.float32) / 255.0
    primary = distributed.is_primary()
    if primary:
        save_image(preview, results_folder / "roi_patches.png")

    interm_aux = [] if args.save_interm else None
    outs = roi_guided_sampling(
        model, sched, pyramid, target_roi=target_roi, roi_bb_list=roi_bb_list,
        custom_t_list=args.sample_t_list, batch_size=args.sample_batch_size, scale_mul=scale_mul,
        omega=args.omega, sample_limited_t=args.sample_limited_t, collect_aux=interm_aux,
        collect_interm=args.save_interm, generator=generator, sharding=sharding, device=device,
    )
    if not primary:
        return outs
    if interm_aux is not None:
        save_interm_scales(interm_aux, range(n), sched, n, args.sample_limited_t, results_folder)
    out_dir = results_folder / "final_samples"
    save_image((outs[-1] + 1) * 0.5, out_dir / "roi_out.png")
    print(f"saved ROI results to {out_dir}")
    return outs


def _train(args, sched, pyramid, results_folder, device, sharding=None):
    """--mode train: build the trainer, restore what the flags name, train
    (in chunks unless ``--steps_per_chunk 0``), and return the EMA denoiser. Every milestone writes 16 scale-0 samples
    of the EMA weights as ``sample-{milestone}.png`` (the primary rank
    alone, in a world, which also alone logs)."""
    import torch

    from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
    from sinddm_tpu_torch.diffusion.core import sample_scale0
    from sinddm_tpu_torch.models.convert import denoiser_params_from_flax
    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.ops.image_io import save_image
    from sinddm_tpu_torch.parallel import distributed
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    train_cfg = TrainConfig(
        train_batch_size=args.train_batch_size, train_lr=args.train_lr, train_num_steps=args.train_num_steps,
        grad_accumulate=args.grad_accumulate, save_and_sample_every=args.save_and_sample_every,
        avg_window=args.avg_window, sched_milestones=tuple(v * 1000 for v in args.sched_k_milestones),
        steps_per_chunk=args.steps_per_chunk, fused_mode=args.fused_mode,
    )
    diff_cfg = DiffusionConfig(timesteps=args.timesteps, scale_factor=args.scale_factor,
                               loss_factor=args.loss_factor, sample_limited_t=args.sample_limited_t,
                               omega=args.omega)
    trainer = MultiscaleTrainer(SinDDMNet(dim=args.dim, device=device), sched, pyramid, train_cfg, diff_cfg,
                                results_folder, seed=args.seed, device=device,
                                mesh=None if sharding is None else sharding.mesh)
    primary = distributed.is_primary()
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
        if not primary:
            return
        h0, w0 = pyramid.sizes_hw[0]
        with torch.no_grad():
            x, _, _ = sample_scale0(tr.ema_model, sched, (16, h0, w0, 3), s=0, t_min=0, omega=args.omega,
                                    generator=torch.Generator(device=device).manual_seed(milestone),
                                    device=device)
        save_image((x + 1) * 0.5, results_folder / f"sample-{milestone}.png")

    trainer.train(fused=args.steps_per_chunk > 0, on_milestone=on_milestone,
                  log_fn=print if primary else (lambda _: None))
    return trainer.ema_model


if __name__ == "__main__":
    main()
