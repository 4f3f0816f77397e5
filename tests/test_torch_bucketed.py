"""The bucketed guided walk: port == the JAX package's shape-bucketed walk.

* ``dynamic_resize_into_canvas`` (up- and down-sizing, atol 1e-6) and the
  masked quantile of ``thresholded_grad(valid_mask=, n_valid=)`` (masks
  equal, the sparse gradient atol 1e-6) against the JAX functions;
* the denoiser's valid-mask mode against ``SinDDMNet.apply(..., mask=)`` on a
  24x32 canvas with a 17x23 valid region (atol 3e-4 + rtol 3e-4, the bound of
  ``test_torch_denoiser.py``), and the valid crop against the mask mode
  (atol 1e-5, zeros outside);
* one unguided via scale, reblurring and ``t_min`` on, against JAX
  ``jit_bucketed_scale`` with the canvas-shaped draws replayed from its key
  (atol 1e-5);
* the guided walk (``clip_content``, ``clip_style_gen``, ``clip_style_trans``'s
  injection, and a guided scale 0 whose carry is lifted onto the canvas)
  against the JAX ``clip_sampling(bucketed=True)`` with its noise, view and
  loss draws replayed: each scale's output within 1e-3 for all but 0.5% of
  the elements and 5e-2 everywhere (``assert_close_but_for_branch_flips``),
  scores rtol 2e-3, the JAX package's padded score rows zero;
* ``--guidance_seg_len`` taken and changing nothing (the CLI's outputs
  equal, bit for bit); the CLI's two flags against the JAX parser's;
  ``--bucketed_guidance --guidance_seg_len`` through the CLI writes the JAX
  CLI's files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_sd_util import make_torch_clip_state_dict
from sinddm_tpu.apps.clip_apps import clip_sampling as jax_clip_sampling
from sinddm_tpu.diffusion import bucketed as jb
from sinddm_tpu.guidance import clip_extractor as jce
from sinddm_tpu.guidance.clip_guidance import thresholded_grad as jax_thresholded_grad
from sinddm_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig
from sinddm_tpu_torch import cli
from sinddm_tpu_torch.apps.clip_apps import clip_sampling
from sinddm_tpu_torch.diffusion import bucketed as tb
from sinddm_tpu_torch.guidance import clip_extractor as tce
from sinddm_tpu_torch.guidance.clip_guidance import thresholded_grad
from torch_clip_draws import (
    GUIDANCE_CLIP,
    assert_close_but_for_branch_flips,
    guidance_towers,
    loss_draws_from_key,
    one_torch_thread,  # noqa: F401  (fixture)
)
from torch_walk_draws import BATCH, SIZES_HW, T, NoiseQueue, replay_draws, tiny_models, tiny_pyramids

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CANVAS = SIZES_HW[-1]  # (24, 32)
N_AUG, T_LIST, STOP = 2, (4, 4), 2
# strength 0.05: at 0.3 the JAX walk itself moves 34% of the finest scale's
# elements by over 1e-3 when its weights move by 1e-6 (relative)
HOOK = dict(strength=0.05, quantile=0.7, llambda=0.2, stop_guidance=STOP)


@pytest.mark.parametrize("src,dst", [((12, 16), (17, 23)), ((17, 23), (24, 32)), ((24, 32), (12, 16)),
                                     ((17, 23), (9, 30)), ((5, 7), (5, 7))])
def test_dynamic_resize_into_canvas_matches_jax(src, dst):
    x = np.random.default_rng(1).uniform(-1, 1, (2,) + CANVAS + (3,)).astype(np.float32)
    x[:, src[0]:], x[:, :, src[1]:] = 0.0, 0.0
    ours = tb.dynamic_resize_into_canvas(torch.tensor(x), src, dst).numpy()
    theirs = np.asarray(jb.dynamic_resize_into_canvas(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(ours, theirs, atol=1e-6)
    assert not ours[:, dst[0]:].any() and not ours[:, :, dst[1]:].any()


def test_place_on_canvas_and_valid_mask_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 17, 23, 3)).astype(np.float32)
    np.testing.assert_array_equal(tb.place_on_canvas(torch.tensor(x), CANVAS).numpy(),
                                  np.asarray(jb.place_on_canvas(jnp.asarray(x), CANVAS)))
    np.testing.assert_array_equal(tb.valid_mask_2d(CANVAS, (17, 23), device="cpu").numpy(),
                                  np.asarray(jb.valid_mask_2d(CANVAS, jnp.asarray([17, 23]))))


@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_masked_quantile_matches_jax(q):
    """10 x 13 valid pixels of a 14 x 16 canvas: q = 0.5 lands on a .5
    virtual index, where JAX's 'nearest' rounds down."""
    grad = np.zeros((3, 14, 16, 3), np.float32)
    grad[:, :10, :13] = np.random.default_rng(0).normal(size=(3, 10, 13, 3))
    grad[:, 10:, :] = 5.0  # large energies outside: they must not move the quantile
    vm = np.zeros((14, 16), bool)
    vm[:10, :13] = True
    sparse, mask = thresholded_grad(torch.tensor(grad), q, valid_mask=torch.tensor(vm), n_valid=130)
    jsparse, jmask = jax_thresholded_grad(jnp.asarray(grad), q, valid_mask=jnp.asarray(vm), n_valid=jnp.asarray(130))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse), atol=1e-6)
    assert not mask.numpy()[:, 10:].any() and not sparse.numpy()[:, :, 13:].any()


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def test_mask_mode_matches_flax_and_the_crop(models):
    flax_model, params, _, port, _ = models
    rng = np.random.default_rng(4)
    x = np.zeros((2,) + CANVAS + (3,), np.float32)
    x[:, :17, :23] = rng.standard_normal((2, 17, 23, 3))
    x[:, 17:, :] = rng.standard_normal((2, 7, 32, 3))  # the mask must zero what lies outside
    mask = np.zeros((2,) + CANVAS, np.float32)
    mask[:, :17, :23] = 1.0
    t = np.asarray([3, 11])
    theirs = np.asarray(flax_model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(2.0),
                                         mask=jnp.asarray(mask)))
    with torch.no_grad():
        ours = port(torch.tensor(x), torch.tensor(t), 2.0, mask=torch.tensor(mask)).numpy()
        crop = port(torch.tensor(x[:, :17, :23]).contiguous(), torch.tensor(t), 2.0).numpy()
    np.testing.assert_allclose(ours, theirs, atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(ours[:, :17, :23], crop, atol=1e-5)
    assert not ours[:, 17:].any() and not ours[:, :, 23:].any()


@pytest.fixture(scope="module")
def towers():
    """One JAX extractor for every JAX walk of the module, so that its jitted
    bucketed scale (static in the extractor and the hook's constants)
    compiles once for all of them."""
    jmod, variables, tmod = guidance_towers(seed=6)
    return (jce.ClipExtractor(jmod, variables, n_aug=N_AUG, view_chunk=None),
            tce.ClipExtractor(tmod, n_aug=N_AUG, view_chunk=1))


def test_unguided_bucketed_via_scale_matches_jax(models, towers):
    """Scale 2 of a 3-scale walk from scale 1's output (17x23 on the 24x32
    canvas), reblurring on, t_min 2: the JAX scan runs T_LIST[1] + 2 steps,
    the last ones skipped."""
    flax_model, params, sched_j, port, sched_t = models
    jex, _ = towers
    prev = np.zeros((BATCH,) + CANVAS + (3,), np.float32)
    prev[:, :17, :23] = np.random.default_rng(5).uniform(-1, 1, (BATCH, 17, 23, 3))
    key, total_t, t_min = jax.random.PRNGKey(9), 6, 2
    x, _, _, _, _ = jb.jit_bucketed_scale(
        flax_model, params, sched_j, jnp.asarray(prev), None, key, jnp.asarray([17, 23]), jnp.asarray(CANVAS),
        jnp.asarray(2), jnp.asarray(total_t), jnp.zeros((1, 32)), None, None, None, jnp.asarray(t_min),
        extractor=jex, max_t=8, sub_iters=0, n_scales=3, frame_hw=(224, 298), reblurring=True, **HOOK)
    draws = NoiseQueue(replay_draws(key, (BATCH,) + CANVAS + (3,), total_t - t_min))
    with torch.no_grad():
        ours, _, aux = tb.sample_via_scale_bucketed(
            port, sched_t, torch.tensor(prev), prev_valid_hw=(17, 23), cur_valid_hw=CANVAS, s=2, total_t=total_t,
            t_min=t_min, reblurring=True, noise_fn=draws, collect_interm=True, device="cpu")
    assert not draws.q and aux["interm"].shape == (total_t - t_min, BATCH) + CANVAS + (3,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(x), atol=1e-5)


def _replay_walk(key, mode, n_hr, n_lr, sub0, with_scale0=True):
    """The JAX bucketed walk's draws in the port's order: (noise, loss draws);
    without scale 0's when ``with_scale0`` is False."""
    noise, draws = [], []
    canvas = (BATCH,) + CANVAS + (3,)

    def scale(k, shape, total_t, guided, s):
        noise.extend(replay_draws(k, shape, total_t, guided=guided))
        if guided:
            k, _ = jax.random.split(k)
            for j in range(total_t):
                k, sub = jax.random.split(k)
                t = total_t - 1 - j
                if s < 2 or t >= STOP:
                    draws.append(loss_draws_from_key(jax.random.split(jax.random.split(sub)[1])[1], BATCH, N_AUG,
                                                     n_lr if s == 0 else n_hr))

    if mode == "clip_style_trans":
        key, _ = jax.random.split(key)
        key, sub = jax.random.split(key)
        scale(sub, canvas, T_LIST[1], True, 2)
        return noise, draws
    key, k0 = jax.random.split(key)
    if with_scale0:
        scale(k0, (BATCH,) + SIZES_HW[0] + (3,), T, sub0 > 0, 0)
    for s in (1, 2):
        key, sub = jax.random.split(key)
        scale(sub, canvas, T_LIST[s - 1], mode != "clip_style_gen" or s == 2, s)
    return noise, draws


WALKS = {  # mode -> (guidance_sub_iters, start_noise)
    "clip_content": ([0, 1, 1], True),
    "clip_style_gen": ([0, 0, 1], True),
    "clip_style_trans": ([0, 0, 1], False),
    "guided_scale0": ([1, 1, 1], True),
}


def _scale0_result():
    """A guided scale 0's result, made up from a seed: its output, and a carry
    whose edit mask covers ~30% of the pixels."""
    rng = np.random.default_rng(8)
    hw = SIZES_HW[0]
    x0 = rng.uniform(-1, 1, (BATCH,) + hw + (3,)).astype(np.float32)
    mask = (rng.uniform(size=(BATCH,) + hw + (1,)) < 0.3).astype(np.float32)
    prev = rng.uniform(-1, 1, (BATCH,) + hw + (3,)).astype(np.float32)
    scores = -rng.uniform(2, 3, (T, 1)).astype(np.float32)
    return x0, mask, prev, scores


@pytest.mark.parametrize("mode", sorted(WALKS))
def test_guided_bucketed_walk_matches_jax(models, towers, mode, monkeypatch):
    """A guided scale 0 (``guided_scale0``) runs 20 guided steps, and that
    walk is chaotic: the JAX walk itself moves 27-37% of its elements by over
    1e-3 when its weights move by 1e-6 (relative). There both packages take
    one made-up scale-0 result, so what is held is the lift of its carry
    onto the canvas (the edit mask is kept, not made anew) and the via
    scales after it."""
    flax_model, params, sched_j, port, sched_t = models
    jex, tex = towers
    pyr_j, pyr_t = tiny_pyramids()
    sub_iters, start_noise = WALKS[mode]
    key = jax.random.PRNGKey(17)
    kw = dict(text_input="fire", sample_batch_size=BATCH, custom_t_list=list(T_LIST), guidance_sub_iters=sub_iters,
              start_noise=start_noise, **HOOK)
    injected = mode == "guided_scale0"
    if injected:
        from sinddm_tpu.apps import sampling as jax_sampling
        from sinddm_tpu.guidance.clip_guidance import ClipCarry as JaxClipCarry
        from sinddm_tpu_torch.apps import clip_apps
        from sinddm_tpu_torch.guidance.clip_guidance import ClipCarry

        x0, mask, prev, scores = _scale0_result()
        monkeypatch.setattr(jax_sampling, "jit_sample_scale0", lambda *a, **k: (
            jnp.asarray(x0), JaxClipCarry(jnp.asarray(mask), jnp.asarray(prev), jnp.asarray(True)),
            {"clip_score": jnp.asarray(scores)}))
        monkeypatch.setattr(clip_apps, "sample_scale0", lambda *a, **k: (
            torch.tensor(x0), ClipCarry(torch.tensor(mask), torch.tensor(prev), True),
            {"clip_score": torch.tensor(scores)}))
    jouts, jaux = jax_clip_sampling(flax_model, params, sched_j, pyr_j, jex, key, bucketed=True, **kw)
    noise, draws = _replay_walk(key, mode, len(jce.TEMPLATES_HR), len(jce.TEMPLATES_LR), sub_iters[0],
                                with_scale0=not injected)
    queue = NoiseQueue(noise)
    outs, aux = clip_sampling(port, sched_t, pyr_t, tex, bucketed=True, noise_fn=queue,
                              draw_fn=lambda b, n: draws.pop(0), device="cpu", **kw)
    assert not queue.q and not draws  # every draw consumed, in order
    assert len(outs) == len(jouts) and len(aux) == len(jaux)
    for o, jo, a, ja in zip(outs, jouts, aux, jaux):
        assert o.shape == tuple(jo.shape)
        assert_close_but_for_branch_flips(o.numpy(), jo, 1e-3, 0.005, 5e-2)
        if not isinstance(ja, dict) or "clip_score" not in ja:  # unguided scale 0, or the injected image
            assert a is None
            continue
        ng = ja["n_guided"]
        assert a["n_guided"] == ng
        js = np.asarray(ja["clip_score"])
        np.testing.assert_allclose(a["clip_score"][:ng].numpy(), js[:ng], rtol=2e-3)
        assert not a["clip_score"][ng:].any() and not js[ng:].any()
    if mode == "guided_scale0":  # scale 0's edit mask entered the via walk: scale 1 guided with it
        assert aux[0]["n_guided"] == T and aux[1]["n_guided"] == T_LIST[0]


def test_segmented_walk_equals_the_single_call(dataset, tmp_path):
    """``--guidance_seg_len 2`` (the JAX CLI's segments of 2 steps) is taken
    and changes nothing: the CLI's outputs equal those of the single call,
    bit for bit."""
    outs = []
    for extra in ([], ["--guidance_seg_len", "2"]):
        argv = ["--mode", "clip_content", "--device", "cpu", "--dataset_folder", str(dataset), "--image_name",
                "tiny.png", "--results_folder", str(tmp_path / f"run{len(outs)}"), "--scope", "tiny", "--dim", "16",
                "--timesteps", "10", "--sample_batch_size", "1", "--sample_t_list", "3", "3", "--n_aug", "2",
                "--clip_view_chunk", "1", "--clip_text", "fire", "--clip_weights", str(dataset / "clip_sd.pt"),
                "--strength", "0.3", "--fill_factor", "0.3", "--bucketed_guidance"] + extra
        outs.append(cli.run(cli.build_parser().parse_args(argv)))
    assert len(outs[0]) == len(outs[1]) == 3
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_cli_flags_match_the_jax_parser():
    from sinddm_tpu.cli import build_parser as jax_build_parser

    for argv in ([], ["--bucketed_guidance"], ["--bucketed_guidance", "--guidance_seg_len", "16"]):
        ours = vars(cli.build_parser().parse_args(["--mode", "clip_content"] + argv))
        theirs = vars(jax_build_parser().parse_args(["--mode", "clip_content"] + argv))
        for flag in ("bucketed_guidance", "guidance_seg_len"):
            assert ours[flag] == theirs[flag] and type(ours[flag]) is type(theirs[flag]), (flag, argv)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--mode", "clip_content", "--guidance_seg_len", "-1"])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_bucketed_cli_data")
    img = np.random.default_rng(0).uniform(0, 255, (96, 128, 3)).astype(np.uint8)
    Image.fromarray(img).save(folder / "tiny.png")
    sd = make_torch_clip_state_dict(JaxCLIPConfig(**{**GUIDANCE_CLIP, "transformer_width": 64,
                                                     "transformer_heads": 1}), seed=2)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, folder / "clip_sd.pt")
    return folder


@pytest.mark.parametrize("mode", ["clip_content", "clip_style_trans"])
def test_cli_bucketed_writes_the_jax_files(dataset, tmp_path, mode):
    argv = ["--mode", mode, "--device", "cpu", "--dataset_folder", str(dataset), "--image_name", "tiny.png",
            "--results_folder", str(tmp_path), "--scope", "tiny", "--dim", "16", "--timesteps", "10",
            "--sample_batch_size", "1", "--sample_t_list", "2", "3", "--n_aug", "2", "--clip_view_chunk", "1",
            "--clip_text", "fire", "--clip_weights", str(dataset / "clip_sd.pt"), "--strength", "0.3",
            "--fill_factor", "0.3", "--bucketed_guidance", "--guidance_seg_len", "2", "--save_interm"]
    outs = cli.run(cli.build_parser().parse_args(argv))
    sizes = [(48, 64), (68, 91), (96, 128)]
    scales = [0, 1, 2] if mode == "clip_content" else [1, 2]
    assert [tuple(o.shape) for o in outs] == [(1,) + sizes[s] + (3,) for s in scales]
    assert all(torch.isfinite(o).all() and float(o.abs().max()) <= 1.0 for o in outs)
    run = tmp_path / "tiny"
    assert sorted(p.name for p in (run / "final_samples").iterdir()) == [f"{mode}_fire_s{i}.png"
                                                                        for i in range(len(scales))]
    assert (run / "clip_score.png").exists() or (run / "clip_score.npy").exists()
    assert sorted(p.name for p in (run / "interm_samples_scale_2").iterdir()) == [
        f"output_t-{t:03d}_s-2.png" for t in range(3)]
    for i, s in enumerate(scales):  # every scale's frames cropped to its size, as its output is
        frames = run / f"interm_samples_scale_{s}"
        if frames.exists():
            size = Image.open(run / "final_samples" / f"{mode}_fire_s{i}.png").size
            assert [Image.open(f).size for f in frames.iterdir()] == [size] * len(list(frames.iterdir()))
