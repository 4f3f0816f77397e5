"""The port's SIFID / FID machinery and feature maps == the JAX package's.

* ``patch_feature_stats`` and ``frechet_distance`` on the same features: the
  distance within 1e-6 (relative); ``sifid`` / ``sifid_batch`` end to end
  with the default conv proxy within 1e-4 relative (the features differ by
  float32 rounding of two convolution routines);
* the three extractors with the weights carried across: features within
  1e-4 of max |feature| -- the conv proxy at its defaults is the JAX
  package's own map (``weights/sifid-proxy-conv-64x2-seed0.npz``, written by
  ``export_weights.py --sifid_proxy``), and at other settings takes the JAX
  package's kernels; the Inception stem (block0 / block1) on the same
  seeded random parameters; CLIP ``tokens`` and ``conv1`` on a tiny tower;
* ``inception_params_from_state_dict`` on a synthetic torchvision state dict
  (extra keys ignored) equal to the JAX converter's, and ``load_inception``
  from a file; ``find_inception_weights`` finds none here.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu import metrics as jm
from sinddm_tpu.models import inception as ji
from sinddm_tpu.models.clip import model as jclip
from sinddm_tpu.models.clip.convert import random_clip_params as jax_random_clip_params
from sinddm_tpu_torch import metrics as tm
from sinddm_tpu_torch.models import inception as ti
from sinddm_tpu_torch.models.clip import model as tclip
from sinddm_tpu_torch.models.clip.convert import clip_from_flax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from export_weights import sifid_proxy_kernels  # noqa: E402  (the JAX package's draw of the kernels)

FEATURE_TOL = 1e-4  # of max |feature|


def _images(seed, n=1, hw=(40, 52)):
    return np.random.default_rng(seed).uniform(-1, 1, (n,) + hw + (3,)).astype(np.float32)


def _close_features(ours, theirs):
    ours, theirs = ours.detach().cpu().numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= FEATURE_TOL * np.abs(theirs).max()


def test_stats_and_frechet_distance_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(300, 12)), rng.normal(0.3, 1.2, size=(250, 12))
    for ours, theirs in zip(tm.patch_feature_stats(a), jm.patch_feature_stats(a)):
        np.testing.assert_array_equal(ours, theirs)
    d_ours = tm.frechet_distance(*tm.patch_feature_stats(a), *tm.patch_feature_stats(b))
    d_theirs = jm.frechet_distance(*jm.patch_feature_stats(a), *jm.patch_feature_stats(b))
    assert abs(d_ours - d_theirs) <= 1e-6 * abs(d_theirs) and d_ours > 0
    assert abs(tm.frechet_distance(*tm.patch_feature_stats(a), *tm.patch_feature_stats(a))) < 1e-8


def test_conv_proxy_at_its_defaults_is_the_jax_map():
    img = _images(1)[0]
    _close_features(tm.conv_feature_extractor(device="cpu")(img), jm.conv_feature_extractor()(jnp.asarray(img)))
    drawn = sifid_proxy_kernels()
    with np.load(tm.SIFID_PROXY_NPZ) as z:
        assert sorted(z.files) == ["conv0", "conv1"]
        for name in z.files:
            np.testing.assert_array_equal(z[name], drawn[name])


def test_conv_proxy_takes_carried_kernels():
    img = _images(2, hw=(30, 33))[0]
    kernels = sifid_proxy_kernels(dim=16, depth=3, seed=5)
    ours = tm.conv_feature_extractor(16, 3, 5, kernels=[kernels[f"conv{d}"] for d in range(3)], device="cpu")
    _close_features(ours(torch.tensor(img)), jm.conv_feature_extractor(16, 3, 5)(jnp.asarray(img)))
    own = tm.conv_feature_extractor(16, 3, 5, device="cpu")(img)  # the port's own draw: same family, other kernels
    assert own.shape == (24 * 27, 16) and torch.isfinite(own).all()


def test_sifid_and_batch_match_jax():
    real, fakes = _images(3)[0], _images(4, n=3)
    ours = tm.sifid_batch(real, fakes, tm.conv_feature_extractor(device="cpu"))
    theirs = jm.sifid_batch(real, fakes, jm.conv_feature_extractor())
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert tm.sifid(real, real, tm.conv_feature_extractor(device="cpu")) == pytest.approx(0.0, abs=1e-6)
    assert (ours > 0).all()


@pytest.mark.parametrize("block", ["block0", "block1"])
def test_inception_extractor_matches_jax(block):
    img = _images(5, hw=(75, 83))[0]
    ours = tm.inception_feature_extractor(ti.random_inception_params(seed=2, device="cpu"), block)(img)
    theirs = jm.inception_feature_extractor(ji.random_inception_params(seed=2), block)(jnp.asarray(img))
    _close_features(ours, theirs)
    assert ours.shape[-1] == {"block0": 64, "block1": 192}[block]


def _torchvision_stem_state_dict(seed):
    """A state dict with torchvision ``inception_v3``'s stem names and
    layouts (OIHW kernels), plus a key of a later layer."""
    rng = np.random.default_rng(seed)
    sd, c_in = {}, 3
    for name, k, _, _, c_out in ti.STEM_SPEC:
        sd[f"{name}.conv.weight"] = rng.normal(0, 0.2, (c_out, c_in, k, k)).astype(np.float32)
        sd[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
        sd[f"{name}.bn.bias"] = rng.normal(0, 0.1, c_out).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = rng.normal(0, 0.3, c_out).astype(np.float32)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
        c_in = c_out
    sd["Mixed_5b.branch1x1.conv.weight"] = np.zeros((64, 192, 1, 1), np.float32)
    return sd


def test_inception_params_from_state_dict_and_load(tmp_path):
    sd = _torchvision_stem_state_dict(6)
    ours = ti.inception_params_from_state_dict(sd, device="cpu")
    theirs = ji.inception_params_from_state_dict(sd)
    assert ours.keys() == theirs.keys() == {name for name, *_ in ti.STEM_SPEC}
    for name in ours:
        for k in ours[name]:
            np.testing.assert_array_equal(ours[name][k].numpy(), np.asarray(theirs[name][k]))
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, tmp_path / "inception_v3.pt")
    loaded = ti.load_inception(str(tmp_path / "inception_v3.pt"), device="cpu")
    x01 = np.random.default_rng(7).uniform(0, 1, (1, 61, 70, 3)).astype(np.float32)
    ours_f = ti.inception_stem_features(loaded, torch.tensor(x01), block="block1")
    _close_features(ours_f, ji.inception_stem_features(theirs, jnp.asarray(x01), block="block1"))


def test_find_inception_weights_finds_none_here(monkeypatch, tmp_path):
    monkeypatch.delenv("SINDDM_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert ti.find_inception_weights() is None
    (tmp_path / "w.pt").write_bytes(b"")
    monkeypatch.setenv("SINDDM_INCEPTION_WEIGHTS", str(tmp_path / "w.pt"))
    assert ti.find_inception_weights() == str(tmp_path / "w.pt")


@pytest.fixture(scope="module")
def towers():
    jcfg = jclip.tiny_clip_config()
    jmod, variables = jax_random_clip_params(jcfg, seed=3)
    variables = jax.tree.map(np.asarray, variables)
    tcfg = tclip.CLIPConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tclip.CLIPConfig)})
    return jmod, variables, clip_from_flax(variables, tcfg, device="cpu")


@pytest.mark.parametrize("feature", ["tokens", "conv1"])
def test_clip_extractors_match_jax(towers, feature):
    jmod, variables, tmod = towers
    img = _images(8, hw=(32, 48))[0]
    ours = tm.clip_feature_extractor(tmod, feature)(img)
    theirs = jm.clip_feature_extractor(jmod, variables, feature)(jnp.asarray(img))
    _close_features(ours, theirs)
    with pytest.raises(ValueError):
        tm.clip_feature_extractor(tmod, "cls")


def test_extractors_scope_tf32_off_and_restore_it():
    matmul = torch.backends.cuda.matmul
    old = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
        with tm.true_fp32():
            assert not matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
