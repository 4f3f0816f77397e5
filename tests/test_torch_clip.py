"""The port's CLIP == the JAX package's CLIP, on the same weights and inputs.

* tokenizer: the same ids, with the standard ``re`` in place of ``regex``;
* tiny towers (``tiny_clip_config``) with the flax weights converted by
  ``clip_from_flax``: image and text embeddings atol 1e-4, a non-square
  input (position embedding resized bicubically, flattened transposed), the
  image gradient atol 1e-4;
* the bf16 vision tower (``compute_dtype="bfloat16"``) against the JAX
  tower with the same setting: image embeddings atol 2.5e-2 (max |embedding|
  ~2.6) and image gradient atol 3e-2 (max ~1.7) -- one-ulp bf16 rounding
  differences (the two frameworks round the same products, but a sum of
  another order flips a rounding now and then) carried through the tower
  reach ~1e-2, as far as bf16 lies from fp32; the text tower stays fp32,
  atol 1e-4;
* ``attn_impl="skip"`` (the vision tower's attention returns v) against the
  JAX tower with the same setting, atol 1e-4, and unlike the einsum tower;
* the bicubic resize matrix against ``jax.image.resize``, atol 1e-6;
* a torch-layout state dict saved to disk loads through ``load_clip``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_sd_util import cli_tiny_clip_config, make_torch_clip_state_dict
from sinddm_tpu.models.clip import model as jmodel
from sinddm_tpu.models.clip.convert import convert_state_dict
from sinddm_tpu.models.clip.convert import random_clip_params as jax_random_clip_params
from sinddm_tpu.models.clip.tokenizer import tokenize as jax_tokenize
from sinddm_tpu_torch.models.clip import model as tmodel
from sinddm_tpu_torch.models.clip.convert import (
    clip_from_flax,
    config_from_state_dict,
    load_clip,
    random_clip_params,
    random_clip_state_dict,
    state_dict_from_flax,
)
from sinddm_tpu_torch.models.clip.tokenizer import split_words, tokenize

TEXTS = [
    "Fire in the Forest", "a photo of a cat's toy, isn't it?", "high quality image of 3 dogs & 12 cats!!!",
    "café au lait — naïve façade", "it's 9:30pm... we'll go; they've left", "hello<|endoftext|>world",
    "  spaced\tout\n text ", "ünïcödé ² ½ ٣ 数字 and emoji 🙂!", "I'M SHOUTING 'RE 'LL 'D", "x" * 60, "{}.", "",
]


def test_tokenizer_ids_match_jax():
    np.testing.assert_array_equal(tokenize(TEXTS), jax_tokenize(TEXTS))
    assert tokenize("a").dtype == np.int32 and tokenize("a").shape == (1, 77)
    with pytest.raises(RuntimeError):
        tokenize("word " * 100)
    np.testing.assert_array_equal(tokenize("word " * 100, truncate=True), jax_tokenize("word " * 100, truncate=True))


def test_split_words_alternation():
    assert split_words("it's 42!'s") == ["it", "'s", "4", "2", "!'", "s"]
    assert split_words("<|startoftext|>ab") == ["<|startoftext|>", "ab"]


def _cfgs(tiny=None):
    j = tiny or jmodel.tiny_clip_config()
    t = tmodel.CLIPConfig(**{f.name: getattr(j, f.name) for f in dataclasses.fields(tmodel.CLIPConfig)})
    return j, t


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = _cfgs()
    jmod, variables = jax_random_clip_params(jcfg, seed=3)
    variables = jax.tree.map(np.asarray, variables)
    return jmod, variables, clip_from_flax(variables, tcfg, device="cpu")


def test_configs_match_jax():
    assert _cfgs()[1] == tmodel.tiny_clip_config()
    assert _cfgs(jmodel.VIT_B_32)[1] == tmodel.VIT_B_32
    assert (tmodel.CLIP_MEAN, tmodel.CLIP_STD) == (jmodel.CLIP_MEAN, jmodel.CLIP_STD)


@pytest.mark.parametrize("hw", [(32, 48), (56, 40)])
def test_image_embedding_and_gradient_match_jax(towers, hw):
    """Wide and tall: the position embedding resized, and flattened
    transposed both ways (the square case runs in the text / tokens test)."""
    jmod, variables, tmod = towers
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2,) + hw + (3,)).astype(np.float32)
    tgt = rng.standard_normal((2, 32)).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    ours = tmod.encode_image(tmodel.clip_normalize(tx))
    (ours * torch.tensor(tgt)).sum().backward()
    jfn = lambda v: jmod.apply(variables, jmodel.clip_normalize(v), method=jmod.encode_image)  # noqa: E731
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(jfn(jnp.asarray(x))), atol=1e-4)
    g = jax.grad(lambda v: jnp.sum(jfn(v) * tgt))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), atol=1e-4)


def test_text_embedding_and_tokens_match_jax(towers):
    jmod, variables, tmod = towers
    toks = tokenize(TEXTS[:4])
    with torch.no_grad():
        ours = tmod.encode_text(torch.from_numpy(toks).long())
        x = torch.tensor(np.random.default_rng(1).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
        patch = tmod.encode_image_tokens(x)
        logits, logits_t = tmod(x, torch.from_numpy(toks).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(toks), method=jmod.encode_text)), atol=1e-4)
    np.testing.assert_allclose(patch.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(x.numpy()), method=jmod.encode_image_tokens)), atol=1e-4)
    jl, _ = jmod.apply(variables, jnp.asarray(x.numpy()), jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-3)
    torch.testing.assert_close(logits_t, logits.T)


def test_bf16_vision_tower_matches_jax(towers):
    jcfg, tcfg = _cfgs(dataclasses.replace(jmodel.tiny_clip_config(), compute_dtype="bfloat16"))
    jmod = jmodel.CLIPModel(jcfg)
    _, variables, tmod32 = towers
    tmod = clip_from_flax(variables, tcfg, device="cpu")
    assert tmod.cfg.vision_dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in tmod.parameters())
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    tgt = rng.standard_normal((2, 32)).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    ours = tmod.encode_image(tmodel.clip_normalize(tx))
    assert ours.dtype == torch.float32
    (ours * torch.tensor(tgt)).sum().backward()
    jfn = lambda v: jmod.apply(variables, jmodel.clip_normalize(v), method=jmod.encode_image)  # noqa: E731
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(jfn(jnp.asarray(x))), atol=2.5e-2)
    g = jax.grad(lambda v: jnp.sum(jfn(v) * tgt))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), atol=3e-2)
    with torch.no_grad():  # bf16 really ran: the fp32 tower is 1e-5 off JAX's fp32, this 1e-3 and more
        assert (ours - tmod32.encode_image(tmodel.clip_normalize(torch.tensor(x)))).abs().max() > 1e-3
        toks = tokenize(TEXTS[:2])
        text = tmod.encode_text(torch.from_numpy(toks).long())
    np.testing.assert_allclose(text.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(toks), method=jmod.encode_text)), atol=1e-4)


def test_attn_skip_matches_jax(towers):
    """The experiment switch: v in place of the attention, in the vision
    tower only; the text tower keeps its attention."""
    jcfg, tcfg = _cfgs(dataclasses.replace(jmodel.tiny_clip_config(), attn_impl="skip"))
    jmod = jmodel.CLIPModel(jcfg)
    _, variables, tmod32 = towers
    tmod = clip_from_flax(variables, tcfg, device="cpu")
    x = np.random.default_rng(5).uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    toks = tokenize(TEXTS[:2])
    with torch.no_grad():
        ours = tmod.encode_image(tmodel.clip_normalize(torch.tensor(x)))
        einsum = tmod32.encode_image(tmodel.clip_normalize(torch.tensor(x)))
        text, text32 = (m.encode_text(torch.from_numpy(toks).long()) for m in (tmod, tmod32))
    theirs = jmod.apply(variables, jmodel.clip_normalize(jnp.asarray(x)), method=jmod.encode_image)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)
    assert (ours - einsum).abs().max() > 1e-2
    torch.testing.assert_close(text, text32)
    with pytest.raises(ValueError, match="attn_impl"):
        clip_from_flax(variables, dataclasses.replace(tcfg, attn_impl="flash"), device="cpu")


@pytest.mark.parametrize("n_in,n_out", [(7, 9), (7, 10), (4, 6), (4, 3), (7, 7)])
def test_bicubic_resize_matrix_matches_jax_image_resize(n_in, n_out):
    eye = jnp.eye(n_in, dtype=jnp.float32)
    theirs = jax.image.resize(eye, (n_in, n_out), method="bicubic")  # column j resized = row weights
    np.testing.assert_allclose(tmodel.bicubic_resize_matrix(n_in, n_out).numpy(), np.asarray(theirs), atol=1e-6)


def test_pos_embedding_224x298_matches_jax():
    """The main path's view frame: a 7x7 grid to (9, 7), flattened transposed."""
    pos = np.random.default_rng(2).standard_normal((50, 16)).astype(np.float32)
    ours = tmodel.interpolate_pos_embedding(torch.tensor(pos), 224, 298, 32)
    theirs = jmodel._interpolate_pos_embedding(jnp.asarray(pos), 224, 298, 32)
    assert ours.shape == (64, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_state_dict_round_trip_and_load_clip(tmp_path):
    """A torch-layout checkpoint on disk -> ``load_clip`` (config read from
    the shapes) agrees with the JAX package's conversion of the same file."""
    jcfg, _ = _cfgs(cli_tiny_clip_config())
    sd = make_torch_clip_state_dict(jcfg, seed=1)
    path = tmp_path / "clip_sd.pt"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    tmod = load_clip(str(path), device="cpu")
    assert config_from_state_dict(sd) == _cfgs(cli_tiny_clip_config())[1]
    assert load_clip(str(path), device="cpu", compute_dtype="bfloat16").cfg.compute_dtype == "bfloat16"
    variables = {"params": jax.tree.map(np.asarray, convert_state_dict(sd, jcfg))}
    x = np.random.default_rng(3).uniform(-1, 1, (1, 32, 40, 3)).astype(np.float32)
    with torch.no_grad():
        ours = tmod.encode_image(torch.tensor(x))
    jmod = jmodel.CLIPModel(jcfg)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(x), method=jmod.encode_image)), atol=1e-4)
    back = state_dict_from_flax(variables)  # the inverse conversion restores the file's arrays
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32).reshape(back[k].shape))
    assert all(not p.requires_grad for p in tmod.parameters())


def test_random_clip_params_is_seeded_and_finite():
    cfg = tmodel.tiny_clip_config()
    a, b = random_clip_state_dict(cfg, seed=5), random_clip_state_dict(cfg, seed=5)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    model = random_clip_params(cfg, seed=5, device="cpu")
    with torch.no_grad():
        emb = model.encode_image(torch.zeros(1, 32, 40, 3))
    assert emb.shape == (1, 32) and torch.isfinite(emb).all()
