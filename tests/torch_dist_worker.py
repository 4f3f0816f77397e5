"""One rank of a gloo world on the CPU, for ``tests/test_torch_parallel.py``.

    python tests/torch_dist_worker.py PORT RANK WORLD DATA SPATIAL OUT_DIR CHECK[,CHECK...]

Joins a world of WORLD ranks at ``127.0.0.1:PORT`` through the port's own
``parallel.distributed.initialize`` (``device="cpu"``: gloo), builds the
DATA x SPATIAL mesh and runs each named check, split over the mesh and, on
rank 0, also as one process computes it (the same code without a mesh).
Every rank writes what it computed to ``OUT_DIR/rank{RANK}.pt``; the test
compares. Imports no JAX. Not collected by pytest (no ``test_`` prefix).

Checks:

* ``split``: the denoiser (dim 8) split over both axes on an uneven batch
  and height; and, as a control, this rank's block computed alone with a
  halo one row short;
* ``sample``: ``sample_scales`` on a 3-scale pyramid at dim 8;
* ``train``: three train steps at ``l1`` and at ``l1_pred_img``, the first
  with injected draws (the whole batch's ``t[0] = 0`` and a non-zero first
  row on the other batch part); and that first step again from flax
  parameters, its loss and gradients kept for the JAX package's step;
* ``chunk``: a grouped chunk of 3 steps and a padded chunk of 2, from one
  trainer each;
* ``clip``: one CLIP loss and gradient with a two-layer CLIP;
* ``guided``: the per-scale and the bucketed guided walk with that CLIP,
  batch 2 (the CPU's CLIP path is slow: about a second an image a call).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig  # noqa: E402
from sinddm_tpu_torch.models.convert import (  # noqa: E402
    denoiser_from_flax,
    denoiser_params_from_flax,
    random_flax_params,
)
from sinddm_tpu_torch.models.denoiser import RECEPTIVE_RADIUS, SinDDMNet  # noqa: E402
from sinddm_tpu_torch.parallel import distributed  # noqa: E402
from sinddm_tpu_torch.parallel.mesh import (  # noqa: E402
    batch_sharding,
    halo_slab,
    make_mesh,
    split_model_fn,
    split_range,
)
from sinddm_tpu_torch.pyramid import Pyramid  # noqa: E402
from sinddm_tpu_torch.schedules import make_schedules  # noqa: E402

SIZES_HW = ((40, 30), (56, 42), (79, 60))
LOSSES = (0.31, 0.22)
T = 10
GUIDED_T = 6
DIM = 8
# a two-layer CLIP with 32-pixel patches (tests/torch_clip_draws.py GUIDANCE_CLIP)
GUIDANCE_CLIP = dict(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=64,
                     vision_patch_size=32, context_length=77, vocab_size=49408,
                     transformer_width=32, transformer_heads=2, transformer_layers=2)


def pyramid(seed=0) -> Pyramid:
    rng = np.random.default_rng(seed)
    images = tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in SIZES_HW)
    recon = (images[0],) + tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in SIZES_HW[1:])
    return Pyramid(sizes_hw=SIZES_HW, sizes_wh=tuple((w, h) for h, w in SIZES_HW), images=images,
                   recon_images=recon, rescale_losses=LOSSES, scale_factor=1.41, n_scales=3)


def check_split(sharding, rank) -> dict:
    model = denoiser_from_flax(random_flax_params(dim=DIM, seed=3), device="cpu")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 45, 13, 3)).astype(np.float32))
    t = torch.tensor([3, 70, 12])
    s = torch.full((3,), 1.0)
    b0, b1 = split_range(x.shape[0], *sharding.parts(0))
    lo, hi, in_lo, in_hi = halo_slab(x.shape[1], *sharding.parts(1), RECEPTIVE_RADIUS - 1)
    with torch.no_grad():
        out = {"split": split_model_fn(model, sharding)(x, t, s),
               "short_halo": (slice(b0, b1), slice(lo, hi),
                              model(x[b0:b1, in_lo:in_hi], t[b0:b1], s[b0:b1])[:, lo - in_lo : hi - in_lo])}
        if rank == 0:
            out["single"] = model(x, t, s)
    return out


def sample_kwargs():
    return dict(scale_factor=1.41, n_scales=3, batch_size=4, custom_sample=True, custom_t_list=[3, 3],
                device="cpu")


def check_sample(sharding, rank) -> dict:
    from sinddm_tpu_torch.apps.sampling import sample_scales

    model = denoiser_from_flax(random_flax_params(dim=DIM, seed=5), device="cpu")
    sched = make_schedules(timesteps=T, scale_losses=LOSSES, n_scales=3, device="cpu")

    def run(sh):
        return sample_scales(model, sched, SIZES_HW, generator=torch.Generator().manual_seed(7), sharding=sh,
                             **sample_kwargs())

    out = {"split": run(sharding)}
    if rank == 0:
        out["single"] = run(None)
    return out


TRAIN_PARAMS_SEED = 12


def train_draws():
    """The first train step's draws at the finest scale, batch 4: the whole
    batch's t[0] is 0, the other batch part's first row is not."""
    noise = np.random.default_rng(6).standard_normal((4,) + SIZES_HW[2] + (3,)).astype(np.float32)
    return np.asarray([0, 40, 17, 3]), noise


def check_train(mesh, rank, tmp: Path) -> dict:
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    sched = make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3, device="cpu")
    cfg = TrainConfig(train_batch_size=4)
    t0, n0 = (torch.from_numpy(a) for a in train_draws())
    out = {}
    for loss_type in ("l1", "l1_pred_img"):
        def trainer(m, folder):
            return MultiscaleTrainer(SinDDMNet(dim=DIM, device="cpu"), sched, pyramid(), cfg,
                                     DiffusionConfig(loss_type=loss_type), folder, seed=0, device="cpu", mesh=m)

        def run(m, folder):
            tr = trainer(m, folder)
            losses = [tr.train_step(s=2, t=[t0], noise=[n0]), tr.train_step(s=1), tr.train_step(s=0)]
            return {"losses": losses, "params": {k: v.detach().clone() for k, v in tr.model.state_dict().items()}}

        def first_step_from_flax(m, folder):
            tr = trainer(m, folder)
            start = denoiser_params_from_flax(random_flax_params(dim=DIM, seed=TRAIN_PARAMS_SEED))
            tr.model.load_state_dict(start)
            tr.ema_model.load_state_dict(start)
            loss = tr.train_step(s=2, t=[t0], noise=[n0])
            return {"loss": loss, "grads": {k: p.grad.clone() for k, p in tr.model.named_parameters()}}

        out[loss_type] = {"split": run(mesh, tmp / f"split{rank}"),
                          "split_from_flax": first_step_from_flax(mesh, tmp / f"flax{rank}")}
        if rank == 0:
            out[loss_type]["single"] = run(None, tmp / "single")
    return out


def check_chunk(mesh, rank, tmp: Path) -> dict:
    """A grouped chunk (a step at each scale, in the ``_rng``'s order) and
    a padded chunk (scales drawn on the device), split over the mesh and, on
    rank 0, as one process runs them."""
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    sched = make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3, device="cpu")

    def run(m, folder, mode):
        tr = MultiscaleTrainer(SinDDMNet(dim=DIM, device="cpu"), sched, pyramid(), TrainConfig(train_batch_size=4),
                               DiffusionConfig(), folder, seed=0, device="cpu", mesh=m)
        losses = tr.train_chunk_grouped(3) if mode == "grouped" else tr.train_chunk(2)
        return {"losses": losses.tolist(), "scales": list(tr.running_scale),
                "params": {k: v.detach().clone() for k, v in tr.model.state_dict().items()}}

    out = {}
    for mode in ("grouped", "padded"):
        out[mode] = {"split": run(mesh, tmp / f"chunk{rank}", mode)}
        if rank == 0:
            out[mode]["single"] = run(None, tmp / "chunk_single", mode)
    return out


def _guidance_setup():
    from sinddm_tpu_torch.guidance.clip_extractor import ClipExtractor
    from sinddm_tpu_torch.models.clip.convert import clip_from_state_dict, random_clip_state_dict
    from sinddm_tpu_torch.models.clip.model import CLIPConfig

    cfg = CLIPConfig(**GUIDANCE_CLIP)
    clip = clip_from_state_dict(random_clip_state_dict(cfg, 0), cfg, device="cpu")
    return lambda gen: ClipExtractor(clip, n_aug=2, generator=gen)


def check_clip(sharding, rank) -> dict:
    """One CLIP loss and gradient of a batch of 3 (an uneven split), split over ``data``."""
    from sinddm_tpu_torch.guidance.clip_extractor import get_augmentations_template
    from sinddm_tpu_torch.guidance.clip_guidance import clip_loss_and_grad

    ex = _guidance_setup()(torch.Generator().manual_seed(1))
    x01 = torch.rand((3,) + SIZES_HW[0] + (3,), generator=torch.Generator().manual_seed(2))
    embeds = ex.get_text_embedding("a photo", get_augmentations_template("lr"))
    draws = ex.draw(3, embeds.shape[0])
    with torch.no_grad():
        out = {"split": clip_loss_and_grad(ex, x01, embeds, draws, sharding)}
        if rank == 0:
            out["single"] = ex.clip_loss_and_grad(x01, embeds, draws)
    return out


def check_guided(sharding, rank) -> dict:
    """Both guided walks split over ``data``; rank 0 runs the per-scale walk
    as one process, rank 1 the bucketed one (each alone, no collective)."""
    from sinddm_tpu_torch.apps.clip_apps import clip_sampling

    extractor = _guidance_setup()
    model = denoiser_from_flax(random_flax_params(dim=DIM, seed=8), device="cpu")
    sched = make_schedules(timesteps=GUIDED_T, scale_losses=LOSSES, n_scales=3, device="cpu")

    def run(sh, bucketed):
        gen = torch.Generator().manual_seed(11)
        outs, aux = clip_sampling(model, sched, pyramid(), extractor(gen), text_input="a photo", strength=0.2,
                                  sample_batch_size=2, custom_t_list=[2, 2], guidance_sub_iters=[0, 1, 1],
                                  quantile=0.5, llambda=0.1, stop_guidance=1, bucketed=bucketed,
                                  generator=gen, sharding=sh, device="cpu")
        return {"outs": outs, "scores": [a["clip_score"][: a["n_guided"]] for a in aux[1:]]}

    out = {name: {"split": run(sharding, bucketed)} for name, bucketed in (("per_scale", False), ("bucketed", True))}
    name, bucketed = (("per_scale", False), ("bucketed", True))[rank % 2]
    out[name]["single"] = run(None, bucketed)
    return out


def main(argv) -> None:
    port, rank, world, data, spatial = (int(v) for v in argv[:5])
    out_dir, checks = Path(argv[5]), argv[6].split(",")
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(spatial=spatial, data=data)
        sharding = batch_sharding(mesh)
        result = {"coords": mesh.coords, "rows": distributed.local_batch_slice(5, mesh)}
        for check in checks:
            if check == "split":
                result[check] = check_split(sharding, rank)
            elif check == "sample":
                result[check] = check_sample(sharding, rank)
            elif check == "train":
                result[check] = check_train(mesh, rank, out_dir)
            elif check == "chunk":
                result[check] = check_chunk(mesh, rank, out_dir)
            elif check == "clip":
                result[check] = check_clip(sharding, rank)
            elif check == "guided":
                result[check] = check_guided(sharding, rank)
            else:
                raise ValueError(f"unknown check {check!r}")
        torch.save(result, out_dir / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
