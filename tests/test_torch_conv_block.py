"""Port conv block and depthwise conv == the JAX package's Pallas kernels
(run in interpret mode on the CPU) and their XLA twins.

The port's wrappers take their plain-PyTorch versions on CPU tensors; the
CUDA kernels themselves are held against those plain versions on the card
by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.ops.pallas_conv import conv_block_reference as jax_conv_block_reference
from sinddm_tpu.ops.pallas_conv import fused_conv_block
from sinddm_tpu.ops.pallas_dw import depthwise_conv5x5 as jax_depthwise
from sinddm_tpu_torch.ops import conv_block as cb
from sinddm_tpu_torch.ops import dw_conv as dw


def _block(seed, b, h, w, c, co, identity):
    rng = np.random.default_rng(seed)
    n = lambda *shape, scale=0.2: (rng.standard_normal(shape) * scale).astype(np.float32)  # noqa: E731
    return (
        n(b, h, w, c, scale=1.0), n(b, c), n(5, 5, c), n(c), n(3, 3, c, co), n(co),
        n(3, 3, co, co), n(co), None if identity else n(c, co), None if identity else n(co),
    )


def _jax(args, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


def _torch(args, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in args]


@pytest.mark.parametrize(
    "b,h,w,c,co,identity",
    [
        (2, 16, 24, 8, 16, False),   # expanding block with residual projection
        (1, 24, 16, 16, 16, True),   # identity residual
        (1, 19, 21, 8, 8, True),     # H, W not tile multiples
    ],
)
def test_matches_pallas_interpret(b, h, w, c, co, identity):
    args = _block(0, b, h, w, c, co, identity)
    theirs = np.asarray(fused_conv_block(*_jax(args), interpret=True))
    cb.launches = 0
    ours = cb.conv_block(*_torch(args))
    assert cb.launches == 0  # CPU tensors take the plain version
    assert ours.shape == (b, h, w, co) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("c,co", [(3, 8), (3, 80)])
def test_three_channel_input_matches_xla_twin(c, co):
    """l1's 3-channel input, which the JAX package sent to its XLA twin."""
    args = _block(1, 2, 13, 17, c, co, False)
    theirs = np.asarray(jax_conv_block_reference(*_jax(args)))
    ours = cb.conv_block_reference(*_torch(args))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=2e-4, rtol=2e-4)


def test_bf16_rounds_like_the_pallas_kernel():
    """bf16 inputs: h1 and g rounded to bf16 before each product, fp32 sums.
    Tolerance: max error <= 2e-2 of max |output| (a sum-order difference
    can flip one bf16 rounding)."""
    args = _block(2, 1, 8, 8, 8, 16, False)
    theirs = np.asarray(fused_conv_block(*_jax(args, jnp.bfloat16), interpret=True), np.float32)
    ours = cb.conv_block(*_torch(args, torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    err = np.abs(ours.float().numpy() - theirs).max()
    assert err <= 2e-2 * np.abs(theirs).max(), err


def test_depthwise_matches_pallas_and_float64_oracle():
    rng = np.random.default_rng(3)
    B, H, W, C = 2, 20, 28, 8
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    wdw = (rng.standard_normal((5, 5, C)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    theirs = np.asarray(jax_depthwise(jnp.asarray(x), jnp.asarray(wdw), jnp.asarray(bias),
                                      tile_h=8, interpret=True))
    xpad = np.pad(x.astype(np.float64), ((0, 0), (2, 2), (2, 2), (0, 0)))
    oracle = np.zeros((B, H, W, C)) + bias.astype(np.float64)
    for di in range(5):
        for dj in range(5):
            oracle += xpad[:, di : di + H, dj : dj + W, :] * wdw[di, dj].astype(np.float64)
    dw.launches = 0
    ours = dw.depthwise_conv5x5(*map(torch.from_numpy, (x, wdw, bias)))
    assert dw.launches == 0
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), oracle, atol=1e-5)
    f64 = dw.depthwise_conv5x5_reference(*(torch.from_numpy(a).double() for a in (x, wdw, bias)))
    np.testing.assert_allclose(f64.numpy(), oracle, atol=1e-12)


def test_depthwise_vec_is_the_blocks_first_stage():
    """dw5x5 + bias + per-batch vec == the first stage of the JAX twin."""
    import jax

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    wdw, bias, vec = (rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((5, 5, 8), (8,), (2, 8)))
    theirs = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wdw)[:, :, None, :], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=8,
    ) + bias + vec[:, None, None, :]
    ours = dw.depthwise_conv5x5(*map(torch.from_numpy, (x, wdw, bias, vec)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_wrappers_check_shapes_and_types():
    args = _torch(_block(5, 1, 6, 6, 8, 16, False))
    bad = list(args)
    bad[4] = bad[4][:, :, :4]  # w1 with the wrong input width
    with pytest.raises(ValueError):
        cb.conv_block(*bad)
    with pytest.raises(ValueError):  # identity residual needs C == Co
        cb.conv_block(*args[:8], None, None)
    with pytest.raises(TypeError):
        cb.conv_block(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        dw.depthwise_conv5x5(args[0], args[2][:3], args[3])
    with pytest.raises(TypeError):
        dw.depthwise_conv5x5(args[0].double(), args[2].double(), args[3].double())
