"""Shared test helper: the JAX guidance pipeline's random draws, re-derived
from its documented key splits and packed as the port's draw tensors.

``sinddm_tpu/guidance/clip_extractor.py`` fans a loss key out as
``kn, ki, ka = split(key, 3)`` (template count, template indices, views);
``ka`` into one key an image, each into ``2 * n_aug`` keys (the first n_aug
for the crops, the rest for the augmentations); a crop key gives the scale
and, through ``split(fold_in(kc, 1))``, the two offsets; an augmentation key
splits into 13, one a draw, in the order of ``ViewDraws``' fields.
"""

import jax
import numpy as np
import pytest
import torch

from sinddm_tpu.models.clip import model as jmodel
from sinddm_tpu.models.clip.convert import convert_state_dict
from sinddm_tpu_torch.guidance.clip_extractor import LossDraws, ViewDraws
from sinddm_tpu_torch.models.clip import model as tmodel
from sinddm_tpu_torch.models.clip.convert import clip_from_state_dict, random_clip_state_dict

@pytest.fixture(scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread for a test module. The suite runs in
    several worker processes beside JAX's own thread pools; with every
    process spinning a thread per core, the small ops of a guided step take
    a hundred times longer than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# A CLIP for the guidance tests: two layers, and patch 32, so that a 224 x ~300
# view is 63 tokens (tiny_clip_config's patch 8 makes it 1036, and the JAX
# side's attention backward on the CPU then dominates the test run).
GUIDANCE_CLIP = dict(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=64,
                     vision_patch_size=32, context_length=77, vocab_size=49408,
                     transformer_width=32, transformer_heads=2, transformer_layers=2)


def guidance_towers(seed: int):
    """(flax CLIPModel, its variables, the port's CLIPModel on the CPU) with
    the same seeded weights: one OpenAI-named numpy state dict, converted by
    each package's own converter."""
    sd = random_clip_state_dict(tmodel.CLIPConfig(**GUIDANCE_CLIP), seed)
    jcfg = jmodel.CLIPConfig(**GUIDANCE_CLIP)
    variables = {"params": jax.tree.map(np.asarray, convert_state_dict(sd, jcfg))}
    return jmodel.CLIPModel(jcfg), variables, clip_from_state_dict(sd, tmodel.CLIPConfig(**GUIDANCE_CLIP), device="cpu")


def _view(kc, ka):
    ky, kx = jax.random.split(jax.random.fold_in(kc, 1))
    k = jax.random.split(ka, 13)
    u = jax.random.uniform
    return dict(
        crop_scale=u(kc, minval=0.6, maxval=1.0), crop_uy=u(ky), crop_ux=u(kx),
        flip_u=u(k[0]), affine_u=u(k[1]), angle=u(k[2], minval=-15.0, maxval=15.0),
        tx=u(k[3], minval=-0.1, maxval=0.1), ty=u(k[4], minval=-0.1, maxval=0.1),
        persp_u=u(k[5]), persp_dx=u(k[6], (4,)), persp_dy=u(k[7], (4,)),
        jitter_u=u(k[8]), gray_u=u(k[9]), jitter_f=u(k[10], (4,), minval=0.9, maxval=1.1),
        hue=u(k[11], minval=-0.1, maxval=0.1), perm=jax.random.permutation(k[12], 4),
    )


def view_draws_from_keys(kcs, kas) -> ViewDraws:
    """Per-view key arrays [B, V, ...] -> the port's ViewDraws."""
    rows = [[_view(kcs[b][v], kas[b][v]) for v in range(len(kcs[b]))] for b in range(len(kcs))]
    fields = {}
    for name in ViewDraws._fields:
        arr = np.stack([np.stack([np.asarray(r[name]) for r in row]) for row in rows])
        fields[name] = torch.tensor(arr.astype(np.int64 if name == "perm" else np.float32))
    return ViewDraws(**fields)


def view_draws_from_key(key, batch: int, n_aug: int) -> ViewDraws:
    """The draws of ``ClipExtractor.embed_image_views(x01, key)``."""
    perk = [jax.random.split(k, 2 * n_aug) for k in jax.random.split(key, batch)]
    return view_draws_from_keys([p[:n_aug] for p in perk], [p[n_aug:] for p in perk])


def loss_draws_from_key(key, batch: int, n_aug: int, n_templates: int) -> LossDraws:
    """The draws of ``ClipExtractor.calculate_clip_loss(x01, text_embeds, key)``."""
    kn, ki, ka = jax.random.split(key, 3)
    n_sel = jax.random.randint(kn, (), 1, n_templates + 1)
    idx = jax.random.randint(ki, (n_templates,), 0, n_templates)
    return LossDraws(torch.tensor(int(n_sel)), torch.tensor(np.asarray(idx).astype(np.int64)),
                     view_draws_from_key(ka, batch, n_aug))


def assert_close_but_for_branch_flips(ours, theirs, tol, outlier_share, outlier_tol):
    """``|ours - theirs| <= tol`` for all but a share ``outlier_share`` of the
    elements, and ``<= outlier_tol`` for every element.

    Why a few elements may differ: the colour pipeline is piecewise smooth (a
    clip bound, a hue sector edge, the channel that holds the maximum). The
    two packages compute a view pixel to ~1e-6 of each other; a pixel that
    close to an edge takes the other branch in the other package, its
    derivative jumps, and the four source pixels under it move with it. Both
    gradients are right for the values their package computed.
    """
    diff = np.abs(np.asarray(ours) - np.asarray(theirs))
    share = float((diff > tol).mean())
    assert share <= outlier_share, f"{share:.4%} of elements differ by more than {tol:g} (max {diff.max():g})"
    assert diff.max() <= outlier_tol, f"max difference {diff.max():g} > {outlier_tol:g}"
