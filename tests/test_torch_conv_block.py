"""Port conv block and depthwise conv == the JAX package's Pallas kernels
(run in interpret mode on the CPU) and their XLA twins.

The port's wrappers take their plain-PyTorch versions on CPU tensors; the
CUDA kernels themselves are held against those plain versions on the card
by ``chip_smoke.py``. The fp32 kernel's 3xTF32 arithmetic is emulated here
(``conv_block.tf32_rna``, ``_stage_3xtf32``) to show on the CPU that it keeps the
fp32 bound and that single-pass TF32 does not.
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
from torch_clip_draws import one_torch_thread  # noqa: F401  (fixture)


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


# ragged shapes for the depthwise kernel's launch plan: W and H of 1 and
# under the 5x5 window, strips past W, a last channel slab that is partial
# (C = 24, 80 in bf16), C = 3 (the scalar kernel) and the walk's smallest call
DW_PLAN_SHAPES = [(2, 1, 1, 4), (1, 2, 21, 8), (2, 5, 33, 80), (1, 37, 130, 24), (3, 130, 1, 16),
                  (2, 19, 21, 3), (16, 48, 64, 80)]


def _cdiv(a, b):
    return -(-a // b)


def _dw_block(plan, shape, i):
    """Block ``i`` of a rolling-row plan, decoded as csrc/dw_conv.cu decodes
    ``blockIdx.x`` (slab fastest, then strip, segment, image): its image and
    the half-open row, column and channel ranges of the outputs it writes."""
    _, h, w, c = shape
    slab, i = i % plan["slabs"], i // plan["slabs"]
    strip, i = i % plan["strips"], i // plan["strips"]
    seg, b = i % plan["segments"], i // plan["segments"]
    y0, x0, c0 = seg * plan["seg_rows"], strip * plan["strip"], slab * plan["slab"]
    return b, (y0, min(h, y0 + plan["seg_rows"])), (x0, min(w, x0 + plan["strip"])), (c0, min(c, c0 + plan["slab"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", DW_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dw_plan_covers_every_output_once(shape, dtype):
    """``dw_plan``, the depthwise kernel's launch arithmetic: the blocks of
    the rolling-row kernel, decoded as the kernel decodes ``blockIdx.x``,
    write every output exactly once, none is empty and none holds more than
    a segment x strip x slab, so the input a block stages (its rows and
    columns and two past them on each side, the part outside the image
    zero-filled) fits its ring row of strip + 4 pixels."""
    b, h, w, c = shape
    plan = dw.dw_plan(shape, dtype)
    if c * torch.empty((), dtype=dtype).element_size() % 16:
        assert plan["kernel"] == "dw5x5_kernel" and plan["blocks"] * plan["threads"] >= b * h * w * c
        return
    assert plan["kernel"] == "dw5x5_ring_kernel"
    assert (plan["slab"], plan["strip"], plan["threads"]) == (dw.SLAB, dw.GROUPS * dw.COLS, dw.SLAB // 2 * dw.GROUPS)
    hits = torch.zeros(shape, dtype=torch.int32)
    for i in range(plan["blocks"]):
        bi, (y0, y1), (x0, x1), (c0, c1) = _dw_block(plan, shape, i)
        assert 0 <= bi < b and 0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w and 0 <= c0 < c1 <= c
        assert y1 - y0 <= plan["seg_rows"] and x1 - x0 <= plan["strip"] and c1 - c0 <= plan["slab"]
        hits[bi, y0:y1, x0:x1, c0:c1] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dw_plan_fills_the_card_at_every_walk_call(dtype):
    """Every depthwise call of the batch-16 balloons walk (5 scales, C = 3,
    80, 160): C = 3 takes the scalar kernel; the others cut their rows into
    the segments that give the fewest waves x input rows a block (against
    every other cut), and their last wave holds at least 80% of a wave's
    blocks, so the card is not left idle at the tail."""
    for h, w in [(48, 64), (67, 90), (94, 126), (133, 177), (186, 248)]:
        for c in (3, 80, 160):
            plan = dw.dw_plan((16, h, w, c), dtype)
            if c == 3:
                assert plan["kernel"] == "dw5x5_kernel"
                continue
            base = 16 * plan["slabs"] * plan["strips"]
            cost = {}
            for n in range(1, _cdiv(h, dw.MIN_ROWS) + 1):
                rows = _cdiv(h, n)
                cost[rows] = _cdiv(base * _cdiv(h, rows), plan["slots"]) * (rows + 4)
            assert cost[plan["seg_rows"]] == min(cost.values())
            assert plan["blocks"] == base * _cdiv(h, plan["seg_rows"])
            assert plan["blocks"] >= 0.8 * plan["waves"] * plan["slots"]
    l3 = dw.dw_plan((16, 186, 248, 160), dtype)
    assert (l3["slabs"], l3["strips"], l3["threads"], l3["slots"]) == (5, 8, 128, 528)


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


def _stage_3xtf32(x, w, split=True):
    """One 3x3 'SAME' product as the kernel forms it in fp32: K in chunks of
    8 channels, the 9 taps of a chunk in turn, each operand split as
    hi = rna(a), lo = rna(a - hi), and lo*hi, hi*lo, hi*hi added in that
    order (lo*lo dropped) into the chunk's partial sum, which is then added
    to the running sum; ``split=False`` is single-pass TF32 (hi*hi)."""
    b, h, wd, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b * h * wd, w.shape[-1]), dtype=torch.float32)
    for k0 in range(0, c, 8):
        part = torch.zeros_like(acc)
        for t in range(9):
            dy, dx = divmod(t, 3)
            a = xp[:, dy : dy + h, dx : dx + wd, k0 : k0 + 8].reshape(-1, min(8, c - k0))
            bw = w[dy, dx, k0 : k0 + 8]
            a_hi, b_hi = cb.tf32_rna(a), cb.tf32_rna(bw)
            if split:
                part += cb.tf32_rna(a - a_hi) @ b_hi
                part += a_hi @ cb.tf32_rna(bw - b_hi)
            part += a_hi @ b_hi
        acc += part
    return acc.reshape(b, h, wd, -1)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0**-10  # a TF32 value: the last stored bit set
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), one + 2.0**-11, 1.0 + 2.0**-12,
                      1.0 + 2.0**-11 - 2.0**-23, 3.0, 0.0], dtype=torch.float32)
    want = [one, -one, 1.0 + 2.0**-9, 1.0, 1.0, 3.0, 0.0]  # ties go away from zero
    assert cb.tf32_rna(x).tolist() == want


def test_3xtf32_stage_keeps_the_fp32_bound_where_tf32_does_not(one_torch_thread):  # noqa: F811
    """conv1 + bias + GELU at l3's K (160 -> 160, K = 1440), fan-in-scaled
    weights as chip_smoke.py's, against conv_block_reference's stage: the
    reference block with a delta dw kernel (h1 = x), a delta W2 and a zero
    projection returns gelu(conv3x3(x, W1) + b1) exactly. The emulated
    3xTF32 stage is held at a tenth of the card's fp32 bound (atol 2e-4 +
    rtol 2e-4); single-pass TF32 leaves the whole bound on this seed."""
    c = co = 160
    rng = np.random.default_rng(8)
    f = lambda *shape, scale=1.0: torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))  # noqa: E731
    x, w1, b1 = f(2, 4, 6, c), f(3, 3, c, co, scale=(9 * c) ** -0.5), f(co, scale=0.1)
    wdw = torch.zeros((5, 5, c))
    wdw[2, 2] = 1.0
    w2 = torch.zeros((3, 3, co, co))
    w2[1, 1] = torch.eye(co)
    ref = cb.conv_block_reference(x, torch.zeros((2, c)), wdw, torch.zeros(c), w1, b1, w2,
                                  torch.zeros(co), torch.zeros((c, co)), torch.zeros(co))
    tol = 2e-4 + 2e-4 * ref.abs()
    ratio = {}
    for split in (True, False):
        out = cb.gelu(_stage_3xtf32(x, w1, split) + b1)
        ratio[split] = ((out - ref).abs() / tol).max().item()
    print(f"max |emulated - reference| / (2e-4 + 2e-4 |reference|): 3xTF32 {ratio[True]:.3e}, "
          f"single-pass TF32 {ratio[False]:.3e}")
    assert ratio[True] <= 0.1, ratio
    assert ratio[False] > 1.0, ratio


def _kernel_tf32_bits(x: np.ndarray) -> np.ndarray:
    """The kernels' ``tf32_rna`` on the bit pattern, in uint32 arithmetic."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).astype(np.uint32)


@pytest.mark.parametrize("taps,c,co", [(9, 160, 160), (9, 12, 24), (9, 90, 100), (1, 3, 80), (9, 8, 8)])
def test_split_weights_round_like_the_kernel_and_lie_k_major(taps, c, co):
    """hi = rna(w) bit for bit as the kernel rounds, lo = rna(w - hi),
    hi + lo within TF32's residual of w, and the layout K-major:
    [Co tile of 80][chunk of 8 channels][tap][hi, lo][n8 group][k4 half][8 outputs][4 inputs],
    zero past C and Co."""
    rng = np.random.default_rng(taps * 1000 + c + co)
    w = (rng.standard_normal((taps, c, co)) * 0.05).astype(np.float32)
    w[0, 0, 0] = 1.0 + 2.0**-11  # a tie: away from zero
    split = cb.split_weights_kmajor(torch.from_numpy(w))
    nt, kc = -(-co // 80), -(-c // 8)
    assert tuple(split.shape) == (nt, kc, taps, 2, 10, 2, 8, 4) and split.dtype == torch.float32
    # back to [taps, K, N] from (nt, kc, tap, h, j, k4, n8, k)
    flat = split.permute(3, 2, 1, 5, 7, 0, 4, 6).reshape(2, taps, 8 * kc, 80 * nt).numpy()
    hi, lo = flat[0, :, :c, :co], flat[1, :, :c, :co]
    assert np.array_equal(hi.view(np.uint32), _kernel_tf32_bits(w))
    assert np.array_equal(lo.view(np.uint32), _kernel_tf32_bits(w - hi))
    assert hi[0, 0, 0] == 1.0 + 2.0**-10
    assert np.all(np.abs(w - (hi + lo)) <= 2.0**-21 * np.abs(w))
    assert not flat[:, :, c:, :].any() and not flat[:, :, :, co:].any()
    # one slab: output channel n, input channel k of (tile 0, chunk 0, tap 0, hi)
    n, k = min(co, 80) - 1, min(c, 8) - 1
    assert split[0, 0, 0, 0, n // 8, k // 4, n % 8, k % 4] == hi[0, k, n]


def test_split_weights_are_cached_per_weight_version():
    """Built once per weight version: the same tensor and a fresh view of it
    (the projection's reshape) hit the cache; an in-place update of the base
    (``_version``) and a new tensor split again."""
    rng = np.random.default_rng(3)
    w1 = torch.from_numpy(rng.standard_normal((3, 3, 16, 24)).astype(np.float32))
    wres = torch.from_numpy(rng.standard_normal((1, 1, 16, 24)).astype(np.float32))
    first = cb.split_weights(w1)
    assert cb.split_weights(w1) is first
    res_first = cb.split_weights(wres.reshape(16, 24))
    assert cb.split_weights(wres.reshape(16, 24)) is res_first
    w1.add_(1.0)
    again = cb.split_weights(w1)
    assert again is not first and not torch.equal(again, first)
    assert torch.equal(again, cb.split_weights_kmajor(w1.reshape(9, 16, 24)))
    wres.mul_(2.0)
    assert cb.split_weights(wres.reshape(16, 24)) is not res_first
    fresh = w1.clone()
    assert cb.split_weights(fresh) is not again and torch.equal(cb.split_weights(fresh), again)


@pytest.mark.parametrize("c,co,want", [
    # the walk's stages, (3x3 input channels, Co): l1's conv1 alone stays on mma.sync
    (3, 80, False), (80, 80, True), (80, 160, True), (160, 160, True), (160, 80, True),
    # the test shapes
    (12, 24, False), (90, 90, False), (16, 100, False), (16, 8, True), (8, 24, True), (12, 8, False),
    (100, 100, False)])
def test_wgmma_route_takes_channel_counts_in_eights(c, co, want):
    assert cb.wgmma_route(c, co, torch.float32) is want
    assert cb.wgmma_route(c, co, torch.bfloat16) is False
