"""Port denoiser == the JAX package's ``SinDDMNet.apply`` and
``apply_denoiser_pallas`` (interpret mode), on random weights at dim=16 and
on the trained ``checkpoints/balloons-120k`` EMA weights at dim=160; the
committed ``weights/balloons-120k-ema.npz`` (``export_weights.py``) is that
EMA tree, bit for bit."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.models.denoiser import SinDDMNet as FlaxSinDDMNet
from sinddm_tpu.models.denoiser import apply_denoiser_pallas
from sinddm_tpu.models.denoiser import compute_cond_vec as jax_cond_vec
from sinddm_tpu.models.denoiser import sinusoidal_pos_emb as jax_pos_emb
from sinddm_tpu_torch.models.convert import (
    denoiser_from_flax,
    denoiser_params_from_flax,
    flatten_tree,
    random_flax_params,
)
from sinddm_tpu_torch.models.denoiser import SinDDMNet, compute_cond_vec, sinusoidal_pos_emb
from sinddm_tpu_torch.ops import conv_block as cb

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "balloons-120k"
EMA_NPZ = Path(__file__).resolve().parents[1] / "weights" / "balloons-120k-ema.npz"


@pytest.fixture(scope="module")
def dim16():
    # seeded numpy weights in the flax layout (test_random_flax_params_have_the_flax_layout)
    x = np.random.default_rng(1).standard_normal((2, 20, 28, 3)).astype(np.float32)
    return FlaxSinDDMNet(dim=16), random_flax_params(dim=16, seed=0), x


def test_random_dim16_matches_flax_and_pallas(dim16):
    model, params, x = dim16
    t = np.asarray([7, 42])
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(1.0)))
    pallas = np.asarray(apply_denoiser_pallas(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(1.0),
                                              interpret=True))
    port = denoiser_from_flax(params, device="cpu")
    cb.launches = 0
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), 1.0).numpy()
    assert cb.launches == 0
    np.testing.assert_allclose(out, ref, atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(out, pallas, atol=3e-4, rtol=3e-4)


def test_npz_tree_loads_the_same(dim16, tmp_path):
    _, params, _ = dim16
    path = tmp_path / "ema.npz"
    np.savez(path, **flatten_tree(params))
    a, b = denoiser_params_from_flax(params), denoiser_params_from_flax(path)
    assert a.keys() == b.keys() == SinDDMNet(dim=16, device="cpu").state_dict().keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # Dense kernels are transposed into nn.Linear, convs keep HWIO
    np.testing.assert_array_equal(a["time_mlp1.weight"].numpy(), params["time_mlp1"]["kernel"].T)
    np.testing.assert_array_equal(a["l2.net_conv1.weight"].numpy(), params["l2"]["net_conv1"]["kernel"])


def test_pos_emb_and_cond_vec_match(dim16):
    _, params, _ = dim16
    t = np.asarray([0.0, 5.0, 99.0], np.float32)
    np.testing.assert_allclose(sinusoidal_pos_emb(torch.from_numpy(t), 32).numpy(),
                               np.asarray(jax_pos_emb(jnp.asarray(t), 32)), atol=1e-5)
    port = denoiser_from_flax(params, device="cpu")
    with torch.no_grad():
        ours = compute_cond_vec(port, torch.tensor([3, 70]), 2.0).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_cond_vec(params, jnp.asarray([3, 70]), 2.0)),
                               atol=1e-5, rtol=1e-5)


def test_bf16_compute_dtype_close_to_flax(dim16):
    """bf16 activations and weights, fp32 sums: within 5e-2 of max |output|
    of the flax bf16 network (the two round at different places)."""
    _, params, x = dim16
    t = np.asarray([7, 42])
    ref = np.asarray(FlaxSinDDMNet(dim=16, compute_dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(1.0)))
    port = denoiser_from_flax(params, compute_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), 1.0)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 5e-2 * np.abs(ref).max()


def test_random_flax_params_have_the_flax_layout():
    shapes = jax.eval_shape(FlaxSinDDMNet(dim=16).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)), jnp.asarray(0.0))["params"]
    theirs = {k: v.shape for k, v in flatten_tree(jax.tree.map(lambda v: np.zeros(v.shape, v.dtype), shapes)).items()}
    ours = {k: v.shape for k, v in flatten_tree(random_flax_params(dim=16, seed=3)).items()}
    assert ours == theirs


def _restore_ema(path: Path):
    import orbax.checkpoint as ocp
    from jax.sharding import SingleDeviceSharding

    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(path)
    tree = getattr(meta, "item_metadata", meta)
    tree = getattr(tree, "tree", tree)
    cpu0 = SingleDeviceSharding(jax.devices("cpu")[0])  # the stored shardings name a TPU
    template = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu0), tree)
    return jax.tree.map(np.asarray, ckptr.restore(path, template)["ema"])


@pytest.fixture(scope="module")
def balloons_ema():
    return _restore_ema(CKPT)


def test_committed_balloons_npz_equals_the_orbax_ema(balloons_ema):
    flat = flatten_tree(balloons_ema)
    with np.load(EMA_NPZ) as npz:
        assert sorted(npz.files) == sorted(flat)
        for k, v in flat.items():
            assert npz[k].dtype == v.dtype == np.float32 and npz[k].shape == v.shape, k
            np.testing.assert_array_equal(npz[k], v, err_msg=k)
    assert set(denoiser_params_from_flax(EMA_NPZ)) == set(SinDDMNet(dim=160, device="cpu").state_dict())


def test_balloons_120k_ema_dim160_matches_flax(balloons_ema):
    ema = balloons_ema
    assert ema["l2"]["net_conv2"]["kernel"].shape == (3, 3, 160, 160)
    x = np.random.default_rng(5).standard_normal((2, 12, 16, 3)).astype(np.float32)
    t = np.asarray([5, 60])
    ref = np.asarray(FlaxSinDDMNet(dim=160).apply({"params": ema}, jnp.asarray(x), jnp.asarray(t),
                                                  jnp.asarray(2.0)))
    port = denoiser_from_flax(ema, device="cpu")
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), 2.0).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-4, rtol=3e-4)
