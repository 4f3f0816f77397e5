"""The guided slice as a whole: port == JAX package under replayed draws.

One guided via-scale loop at the finest scale of a tiny pyramid (6 steps:
three guided, then the three that ``stop_guidance`` gates off), tiny CLIP,
``n_aug=2``. The JAX sampler's noise and the guidance's draws are re-derived
from its key (``sample_via_scale`` splits once for the forward noise, then
once a step; with a hook, ``p_sample_step`` splits the step's key again into
the noise key and the hook's key, and the hook splits once a sub-iteration)
and handed to the port. Final x: atol 1e-3 for all but 0.5% of the elements,
5e-2 for every element (branch edges of the colour pipeline, see
``assert_close_but_for_branch_flips``); masks equal up to 0.5% of the pixels.

``clip_roi`` the same way: two ascent iterations on a 12x16 box (views of
224x298, as on the card) with the JAX draws, scores rtol 2e-3; the whole
``clip_roi_sampling`` (ascent, paste, 3 denoising steps with the JAX noise)
likewise. The ascent takes steps of ~0.3 normalised by the gradient's norm,
so the few flipped gradient elements of the first step move the whole second
step a little: the patch within 1e-3 for all but 3% of the elements and
within 2e-2 everywhere.

Also: ``_n_guided_steps``, the walk-level plumbing of ``clip_sampling`` (carry
across scales, ``n_guided``), and the CLI on the CPU with a tiny state dict,
``--save_interm`` and ``--mode clip_roi`` included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_sd_util import make_torch_clip_state_dict
from sinddm_tpu.apps.clip_apps import _clip_roi_ascent as jax_clip_roi_ascent
from sinddm_tpu.apps.clip_apps import _n_guided_steps as jax_n_guided_steps
from sinddm_tpu.apps.clip_apps import clip_roi_sampling as jax_clip_roi_sampling
from sinddm_tpu.diffusion.core import sample_via_scale as jax_sample_via_scale
from sinddm_tpu.guidance import clip_extractor as jce
from sinddm_tpu.guidance import clip_guidance as jcg
from sinddm_tpu.models import SinDDMNet as FlaxSinDDMNet
from sinddm_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig
from sinddm_tpu.schedules import make_schedules as jax_make_schedules
from sinddm_tpu_torch import cli
from sinddm_tpu_torch.apps.clip_apps import (
    NO_WEIGHTS_MESSAGE,
    _clip_roi_ascent,
    _n_guided_steps,
    clip_mode_config,
    clip_roi_sampling,
    clip_sampling,
)
from sinddm_tpu_torch.diffusion.core import sample_via_scale
from sinddm_tpu_torch.guidance import clip_extractor as tce
from sinddm_tpu_torch.guidance import clip_guidance as tcg
from sinddm_tpu_torch.models.clip import model as tmodel
from sinddm_tpu_torch.models.clip.convert import random_clip_params
from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import make_schedules
from torch_clip_draws import (
    GUIDANCE_CLIP,
    assert_close_but_for_branch_flips,
    guidance_towers,
    loss_draws_from_key,
    one_torch_thread,  # noqa: F401  (fixture)
)

T, N_SCALES, SCALE_LOSSES = 20, 3, [0.35, 0.2]
B, N_AUG, HW = 2, 2, (20, 27)
TOTAL_T, STOP = 6, 3

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_guided_via_scale_loop_matches_jax():
    params = random_flax_params(dim=16, seed=7)
    flax_model = FlaxSinDDMNet(dim=16)
    jax_fn = lambda x, t, s: flax_model.apply({"params": params}, x, t, s)  # noqa: E731
    model = denoiser_from_flax(params, device="cpu")
    sched_j = jax_make_schedules(timesteps=T, scale_losses=SCALE_LOSSES, n_scales=N_SCALES)
    sched_t = make_schedules(timesteps=T, scale_losses=SCALE_LOSSES, n_scales=N_SCALES, device="cpu")

    jmod, variables, tmod = guidance_towers(seed=6)
    jex = jce.ClipExtractor(jmod, variables, n_aug=N_AUG, view_chunk=None)
    tex = tce.ClipExtractor(tmod, n_aug=N_AUG, view_chunk=1)
    rng = np.random.default_rng(0)
    text = rng.standard_normal((5, 32)).astype(np.float32)
    img_prev = rng.uniform(-1, 1, (B,) + HW + (3,)).astype(np.float32)
    s = N_SCALES - 1
    kw = dict(s=s, n_scales=N_SCALES, sub_iters=1, strength=0.3, quantile=0.7, llambda=0.2, stop_guidance=STOP)
    key = jax.random.PRNGKey(31)

    jfn = jcg.make_clip_guidance(jex, jnp.asarray(text), **kw)
    jx, jcarry, jaux = jax_sample_via_scale(
        jax_fn, sched_j, jnp.asarray(img_prev), key, s=s, total_t=TOTAL_T, reblurring=False,
        guidance_fn=jfn, guidance_carry=jcg.init_clip_carry(B, HW))

    shape = (B,) + HW + (3,)
    k, kn = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(kn, shape, jnp.float32))]
    draws = []
    for t in range(TOTAL_T - 1, -1, -1):
        k, sub = jax.random.split(k)
        k_noise, gkey = jax.random.split(sub)
        noise.append(np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))
        if t >= STOP:
            draws.append(loss_draws_from_key(jax.random.split(gkey)[1], B, N_AUG, text.shape[0]))

    def noise_fn(shp):
        assert tuple(shp) == shape
        return torch.tensor(noise.pop(0))

    tfn = tcg.make_clip_guidance(tex, torch.tensor(text), draw_fn=lambda b, n: draws.pop(0), **kw)
    with torch.no_grad():
        tx, tcarry, taux = sample_via_scale(
            model, sched_t, torch.tensor(img_prev), s=s, total_t=TOTAL_T, reblurring=False,
            noise_fn=noise_fn, guidance_fn=tfn, guidance_carry=tcg.init_clip_carry(B, HW, device="cpu"))
    assert not noise and not draws  # every draw consumed, in order

    assert_close_but_for_branch_flips(tx.numpy(), jx, 1e-3, 0.005, 5e-2)
    assert float((tcarry.mask.numpy() != np.asarray(jcarry.mask)).mean()) <= 0.005
    assert tcarry.has_mask and 0.2 < float(tcarry.mask.mean()) < 0.4  # ~ fill factor 0.3
    assert taux["clip_score"].shape == (TOTAL_T, 1) == np.asarray(jaux["clip_score"]).shape
    n_guided = _n_guided_steps(s, TOTAL_T, 1, N_SCALES, STOP, 0)
    assert n_guided == TOTAL_T - STOP
    np.testing.assert_allclose(taux["clip_score"].numpy()[:n_guided], np.asarray(jaux["clip_score"])[:n_guided], rtol=2e-3)
    assert not taux["clip_score"][n_guided:].any() and not np.asarray(jaux["clip_score"])[n_guided:].any()


@pytest.mark.parametrize("s", [0, 1, 4])
@pytest.mark.parametrize("total_t,sub_iters,stop,t_min", [(52, 1, 3, 0), (22, 1, 3, 0), (22, 0, 3, 0),
                                                          (22, 2, 3, 10), (2, 1, 3, 0), (100, 1, 0, 52)])
def test_n_guided_steps_matches_jax(s, total_t, sub_iters, stop, t_min):
    assert _n_guided_steps(s, total_t, sub_iters, 5, stop, t_min) == jax_n_guided_steps(s, total_t, sub_iters, 5, stop, t_min)


def _tiny_pyramid():
    sizes = ((24, 32), (34, 45), (48, 64))
    rng = np.random.default_rng(0)
    imgs = tuple(rng.uniform(-1, 1, s + (3,)).astype(np.float32) for s in sizes)
    return Pyramid(sizes_hw=sizes, sizes_wh=tuple((w, h) for h, w in sizes), images=imgs, recon_images=imgs,
                   rescale_losses=(0.35, 0.2), scale_factor=1.411, n_scales=3)


@pytest.mark.parametrize("mode", ["clip_content", "clip_style_gen", "clip_style_trans"])
def test_clip_sampling_walk_plumbing(mode):
    """The walk on the CPU with seeded generators: which scales are guided,
    the carry across scales, the n_guided annotation, outputs in [-1, 1]."""
    pyr = _tiny_pyramid()
    sched = make_schedules(timesteps=10, scale_losses=[0.35, 0.2], n_scales=3, device="cpu")
    model = denoiser_from_flax(random_flax_params(dim=16, seed=1), device="cpu")
    g = torch.Generator().manual_seed(0)
    ex = tce.ClipExtractor(random_clip_params(tmodel.CLIPConfig(**GUIDANCE_CLIP), seed=0, device="cpu"),
                           n_aug=2, view_chunk=1, generator=g)
    cfg = clip_mode_config(mode, "fire", 0.3, 0.3, 3)
    outs, aux = clip_sampling(model, sched, pyr, ex, sample_batch_size=2, custom_t_list=[5, 5],
                              generator=g, device="cpu", **cfg)
    scale_ids = [1, 2] if mode == "clip_style_trans" else [0, 1, 2]
    assert [tuple(o.shape) for o in outs] == [(2,) + pyr.sizes_hw[i] + (3,) for i in scale_ids]
    want = {"clip_content": {0: None, 1: 5, 2: 2}, "clip_style_gen": {0: None, 1: None, 2: 2},
            "clip_style_trans": {1: None, 2: 2}}[mode]
    for i, a in zip(scale_ids, aux):
        if want[i] is None:
            assert a is None
        else:
            assert a["n_guided"] == want[i] and a["clip_score"].shape == (5, 1)
            assert bool((a["clip_score"][: want[i]] != 0).all()) and not a["clip_score"][want[i]:].any()
    assert torch.isfinite(outs[-1]).all() and float(outs[-1].abs().max()) <= 1.0
    if mode == "clip_style_trans":
        np.testing.assert_array_equal(outs[0][1].numpy(), pyr.images[1])


ROI = (5, 8, 12, 16)  # y x h w in the tiny pyramid's 48x64 finest image: views of 224x298
ROI_TOL, ROI_SHARE, ROI_WORST = 1e-3, 0.03, 2e-2


@pytest.fixture(scope="module")
def roi_setup():
    """One JAX extractor for both clip_roi tests: its jitted ascent (static in
    the extractor, the iteration count and the strength) compiles once."""
    jmod, variables, tmod = guidance_towers(seed=8)
    jex = jce.ClipExtractor(jmod, variables, n_aug=N_AUG, view_chunk=None)
    tex = tce.ClipExtractor(tmod, n_aug=N_AUG, view_chunk=1)
    return jex, tex, _tiny_pyramid()


def _ascent_draws(ka, n_iters, n_templates):
    return [loss_draws_from_key(k, B, N_AUG, n_templates) for k in jax.random.split(ka, n_iters)]


def test_clip_roi_ascent_matches_jax(roi_setup):
    jex, tex, pyr = roi_setup
    embeds = jex.get_text_embedding("fire", jce.get_augmentations_template("lr"))
    y, x, h, w = ROI
    patch = np.broadcast_to(pyr.images[-1][None], (B,) + pyr.images[-1].shape)[:, y : y + h, x : x + w]
    key = jax.random.PRNGKey(41)
    jp, jscores, jframes = jax_clip_roi_ascent(jex, jnp.asarray(patch), embeds, jex.variables, key, 2, 0.1,
                                               collect_interm=True)
    draws = _ascent_draws(key, 2, embeds.shape[0])
    tp, tscores, tframes = _clip_roi_ascent(tex, torch.tensor(np.ascontiguousarray(patch)), torch.tensor(np.asarray(embeds)),
                                            2, 0.1, collect_interm=True, draw_fn=lambda b, n: draws.pop(0))
    assert not draws and tscores.shape == (2,) and tframes.shape == (2, B, h, w, 3)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=2e-3)
    np.testing.assert_array_equal(tframes[0].numpy(), patch)
    assert_close_but_for_branch_flips(tframes[1].numpy(), jframes[1], ROI_TOL, ROI_SHARE, ROI_WORST)
    assert_close_but_for_branch_flips(tp.numpy(), jp, ROI_TOL, ROI_SHARE, ROI_WORST)
    assert float(tp.abs().max()) <= 1.0 and not torch.equal(tp, tframes[1])


def test_clip_roi_sampling_matches_jax(roi_setup):
    """Ascent, paste and the 3-step denoise at the finest scale, with the JAX
    draws and noise re-derived from its key (split into the ascent's and the
    denoise's)."""
    jex, tex, pyr = roi_setup
    params = random_flax_params(dim=16, seed=7)
    sched_j = jax_make_schedules(timesteps=10, scale_losses=[0.35, 0.2], n_scales=3)
    sched_t = make_schedules(timesteps=10, scale_losses=[0.35, 0.2], n_scales=3, device="cpu")
    key = jax.random.PRNGKey(43)
    kw = dict(text_input="fire", strength=0.1, sample_batch_size=B, num_clip_iters=2, num_denoising_steps=3,
              clip_roi_bb=ROI, collect_interm=True)
    jfinal, jscores, jinterm = jax_clip_roi_sampling(FlaxSinDDMNet(dim=16), params, sched_j, pyr, jex, key, **kw)

    _, ka, ks = jax.random.split(key, 3)
    draws = _ascent_draws(ka, 2, len(jce.get_augmentations_template("lr")))
    shape = (B,) + pyr.sizes_hw[-1] + (3,)
    k, kn = jax.random.split(ks)
    noise = [np.asarray(jax.random.normal(kn, shape, jnp.float32))]
    for _ in range(3):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    final, scores, interm = clip_roi_sampling(
        denoiser_from_flax(params, device="cpu"), sched_t, pyr, tex, draw_fn=lambda b, n: draws.pop(0),
        noise_fn=lambda shp: torch.tensor(noise.pop(0)), device="cpu", **kw)
    assert not draws and not noise
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=2e-3)
    assert tuple(interm["ascent"].shape) == (2, B, ROI[2], ROI[3], 3) and tuple(interm["denoise"].shape) == (3,) + shape
    assert_close_but_for_branch_flips(interm["denoise"].numpy(), jinterm["denoise"], ROI_TOL, ROI_SHARE, ROI_WORST)
    assert_close_but_for_branch_flips(final.numpy(), jfinal, ROI_TOL, ROI_SHARE, ROI_WORST)
    assert final.shape == shape and torch.isfinite(final).all() and float(final.abs().max()) <= 1.0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_clip_cli_data")
    img = np.random.default_rng(0).uniform(0, 255, (96, 128, 3)).astype(np.uint8)
    Image.fromarray(img).save(folder / "tiny.png")
    # widths that survive the loader's head rule (width // 64), patch 32
    sd = make_torch_clip_state_dict(JaxCLIPConfig(**{**GUIDANCE_CLIP, "transformer_width": 64, "transformer_heads": 1}), seed=2)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, folder / "clip_sd.pt")
    return folder


def _argv(dataset, out, mode):
    return ["--mode", mode, "--device", "cpu", "--dataset_folder", str(dataset), "--image_name", "tiny.png",
            "--results_folder", str(out), "--scope", "tiny", "--dim", "16", "--timesteps", "10",
            "--sample_batch_size", "1", "--sample_t_list", "2", "5", "--n_aug", "2",
            "--clip_view_chunk", "1", "--clip_text", "fire"]


@pytest.mark.parametrize("mode,extra", [("clip_style_gen", []), ("clip_content", ["--strength", "0.3", "--fill_factor", "0.3"])])
def test_cli_clip_mode_writes_files(dataset, tmp_path, mode, extra):
    outs = cli.run(cli.build_parser().parse_args(
        _argv(dataset, tmp_path, mode) + ["--clip_weights", str(dataset / "clip_sd.pt")] + extra))
    assert [tuple(o.shape) for o in outs] == [(1, 48, 64, 3), (1, 68, 91, 3), (1, 96, 128, 3)]
    names = sorted(p.name for p in (tmp_path / "tiny" / "final_samples").iterdir())
    assert names == [f"{mode}_fire_s{i}.png" for i in range(3)]
    assert (tmp_path / "tiny" / "clip_score.png").exists() or (tmp_path / "tiny" / "clip_score.npy").exists()


def test_cli_clip_roi_writes_the_jax_file_names(dataset, tmp_path, monkeypatch):
    """Three ascent iterations in place of the CLI's 100 (each ~0.5 s on one
    CPU thread); the file names are the JAX CLI's."""
    from sinddm_tpu_torch.apps import clip_apps

    assert (clip_apps.ROI_ASCENT_ITERS, clip_apps.ROI_STRENGTH, clip_apps.ROI_DENOISING_STEPS) == (100, 0.1, 3)
    monkeypatch.setattr(clip_apps, "ROI_ASCENT_ITERS", 3)
    outs = cli.run(cli.build_parser().parse_args(
        _argv(dataset, tmp_path, "clip_roi")
        + ["--clip_weights", str(dataset / "clip_sd.pt"), "--target_roi", "10", "12", "24", "32", "--save_interm"]))
    assert [tuple(o.shape) for o in outs] == [(1, 96, 128, 3)]
    assert torch.isfinite(outs[0]).all() and float(outs[0].abs().max()) <= 1.0
    run = tmp_path / "tiny"
    assert sorted(p.name for p in (run / "final_samples").iterdir()) == ["clip_roi_fire.png"]
    assert sorted(p.name for p in (run / "interm_samples_clip_roi").iterdir()) == sorted(f"iter_{i}.png" for i in range(3))
    assert sorted(p.name for p in (run / "interm_samples_scale_2").iterdir()) == [f"output_t-{t:03d}_s-2.png" for t in range(3)]
    with pytest.raises(SystemExit, match="target_roi"):
        cli.run(cli.build_parser().parse_args(_argv(dataset, tmp_path, "clip_roi") + ["--clip_weights", str(dataset / "clip_sd.pt")]))


def test_cli_clip_mode_stops_without_weights(dataset, tmp_path, monkeypatch):
    monkeypatch.delenv("SINDDM_CLIP_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(SystemExit) as info:
        cli.run(cli.build_parser().parse_args(_argv(dataset, tmp_path, "clip_style_trans")))
    assert str(info.value) == NO_WEIGHTS_MESSAGE and "ViT-B/32" in NO_WEIGHTS_MESSAGE
    import types

    from sinddm_tpu.apps.clip_apps import run_clip_mode as jax_run_clip_mode

    with pytest.raises(SystemExit) as theirs:  # the JAX package stops at the same check, before it reads anything else
        jax_run_clip_mode(types.SimpleNamespace(clip_weights=None), None, None, None, None, None, None, None, tmp_path)
    assert str(info.value) == str(theirs.value)


@pytest.mark.parametrize("strength,fill_factor", [(None, 0.3), (0.3, None), (1.5, 0.3), (0.3, -0.1)])
def test_clip_content_needs_strength_and_fill_factor_in_range(strength, fill_factor):
    with pytest.raises(ValueError, match="clip_content needs"):
        clip_mode_config("clip_content", "fire", strength, fill_factor, 5)


def test_cli_clip_flags_keep_the_jax_defaults():
    from sinddm_tpu.cli import build_parser as jax_build_parser

    ours = vars(cli.build_parser().parse_args(["--mode", "clip_content"]))
    theirs = vars(jax_build_parser().parse_args(["--mode", "clip_content"]))
    for flag in ("clip_text", "strength", "fill_factor", "clip_weights", "n_aug", "clip_view_chunk", "warp_impl",
                 "clip_dtype", "warp_precision", "target_roi", "interactive", "save_interm"):
        assert ours[flag] == theirs[flag], flag
    jax_actions = {a.dest: a for a in jax_build_parser()._actions}
    for a in cli.build_parser()._actions:
        if a.dest in ("clip_dtype", "warp_precision", "target_roi", "interactive", "mode"):
            assert a.choices == jax_actions[a.dest].choices or (a.dest == "mode" and set(a.choices) < set(jax_actions["mode"].choices)), a.dest
    assert {"pallas", "pallas_win", "pallas_winx", "pallas_winb", "mm"} == set(
        next(a for a in cli.build_parser()._actions if a.dest == "warp_impl").choices)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--mode", "clip_content", "--n_aug", "0"])
