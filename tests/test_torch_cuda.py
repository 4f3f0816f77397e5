"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where there is no CUDA device. On a
machine with one (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The shapes here are small and ragged on purpose (W and H of 1, channel
counts that are not multiples of the kernels' chunks and tiles); the full
dim=160 shapes of the sampling path are checked by ``chip_smoke.py``.
Tolerances as there: fp32 atol 2e-4 + rtol 2e-4 (sum order); bf16 max
error <= 2e-2 of max |plain|; dw against float64 atol 1e-5; the warp kernels
against their plain version (``bilinear_sample_mm``; for win3
``bilinear_sample_split3``): value atol 1e-5, image gradient 1e-5 of max
|gradient| (the adjoints' atomics sum in an order that changes from run to
run); win3 against the exact warp at the JAX package's bounds, value 3e-4
and gradient 7e-5 of max |gradient|.
"""

import pytest
import torch

from sinddm_tpu_torch.ops import conv_block as cb
from sinddm_tpu_torch.ops import dw_conv as dw
from sinddm_tpu_torch.ops import warp_sample as ws
from sinddm_tpu_torch.ops.warp import bilinear_sample_mm, warp_homography

WARP_CASES = [(1, 19, 23, 3, 1, 17, 13, 0.5), (2, 21, 25, 3, 3, 26, 30, 0.0), (1, 300, 23, 3, 2, 17, 13, 0.5),
              (3, 1, 1, 1, 2, 5, 7, 1.0), (2, 7, 40, 5, 1, 1, 1, 0.25), (1, 33, 9, 4, 4, 12, 3, 1.0)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _block(gen, b, h, w, c, co, dtype):
    def n(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    proj = c != co
    return (
        n(b, h, w, c).to(dtype), n(b, c, scale=0.2), n(5, 5, c, scale=0.2), n(c, scale=0.1),
        n(3, 3, c, co, scale=(9 * c) ** -0.5), n(co, scale=0.1),
        n(3, 3, co, co, scale=(9 * co) ** -0.5), n(co, scale=0.1),
        n(c, co, scale=c ** -0.5) if proj else None, n(co, scale=0.1) if proj else None,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c,co",
    [(1, 1, 1, 3, 80), (2, 7, 9, 8, 16), (1, 19, 21, 160, 160), (3, 8, 16, 80, 160),
     (1, 5, 33, 12, 24), (2, 17, 3, 16, 8), (1, 9, 250, 160, 80)],
)
def test_conv_block_matches_plain(gen, b, h, w, c, co, dtype):
    args = _block(gen, b, h, w, c, co, dtype)
    cb.launches = dw.launches = 0
    out = cb.conv_block(*args)
    assert (cb.launches, dw.launches) == (cb.LAUNCHES_PER_BLOCK, 1)
    ref = cb.conv_block_reference(*args)
    torch.cuda.synchronize()
    assert out.shape == (b, h, w, co) and out.dtype == dtype and out.is_cuda
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("shape", [(1, 1, 1, 3), (2, 19, 21, 8), (1, 6, 130, 160), (3, 2, 5, 80)])
@pytest.mark.parametrize("with_vec", [False, True])
def test_dw_matches_float64(gen, shape, with_vec):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda")
    wdw = torch.randn((5, 5, c), generator=gen, device="cuda") * 0.2
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    vec = torch.randn((shape[0], c), generator=gen, device="cuda") * 0.2 if with_vec else None
    dw.launches = 0
    out = dw.depthwise_conv5x5(x, wdw, bias, vec)
    assert dw.launches == 1
    ref = dw.depthwise_conv5x5_reference(
        x.double(), wdw.double(), bias.double(), None if vec is None else vec.double())
    torch.testing.assert_close(out.double(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dw_vector_and_scalar_paths_agree(gen, dtype):
    """C % 4 == 0 with aligned pointers takes the vector kernel; the same
    input 4 bytes off alignment takes the scalar one. Same sums, same order."""
    shape = (2, 11, 37, 80)
    buf = torch.randn(1 + torch.Size(shape).numel(), generator=gen, device="cuda").to(dtype)
    aligned = buf[:-1].view(shape)
    shifted = buf[1:].view(shape)
    assert shifted.data_ptr() % 16 != 0
    wdw = (torch.randn((5, 5, 80), generator=gen, device="cuda") * 0.2).to(dtype)
    bias = (torch.randn((80,), generator=gen, device="cuda") * 0.1).to(dtype)
    vec = (torch.randn((2, 80), generator=gen, device="cuda") * 0.2).to(dtype)
    shifted_copy = shifted.clone()  # aligned storage, same values
    torch.testing.assert_close(dw.depthwise_conv5x5(shifted, wdw, bias, vec),
                               dw.depthwise_conv5x5(shifted_copy, wdw, bias, vec), atol=0, rtol=0)
    ref = dw.depthwise_conv5x5_reference(aligned, wdw, bias, vec)
    err = (dw.depthwise_conv5x5(aligned, wdw, bias, vec).float() - ref.float()).abs().max().item()
    assert err <= (1e-5 if dtype == torch.float32 else 2e-2 * ref.float().abs().max().item())


def test_wrappers_raise_instead_of_falling_back(gen):
    args = list(_block(gen, 1, 6, 6, 8, 16, torch.float32))
    cb.launches = dw.launches = 0
    with pytest.raises(TypeError):
        cb.conv_block(args[0].double(), *args[1:])
    with pytest.raises(ValueError):  # a non-contiguous input
        cb.conv_block(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):  # weights on another device
        cb.conv_block(args[0], args[1], args[2].cpu(), *args[3:])
    with pytest.raises(TypeError):
        dw.depthwise_conv5x5(args[0].double(), args[2].double(), args[3].double())
    with pytest.raises(ValueError):  # dw weights must have x's type
        dw.depthwise_conv5x5(args[0], args[2].bfloat16(), args[3])
    assert (cb.launches, dw.launches) == (0, 0)


def _warp_case(gen, b, h, w, c, v, oh, ow):
    img = torch.rand((b, h, w, c), generator=gen, device="cuda")
    span = torch.tensor([w, h], device="cuda", dtype=torch.float32)
    coords = (torch.rand((b, v, oh, ow, 2), generator=gen, device="cuda") * 1.5 - 0.2) * span
    return img, coords, torch.randn((b, v, oh, ow, c), generator=gen, device="cuda")


def _value_and_grad(fn, img, coords, fill, ct):
    x = img.clone().requires_grad_(True)
    out = fn(x, coords, fill)
    return out, torch.autograd.grad(out, x, ct)[0]


def _per_image(one, img, coords, fill, ct):
    return _value_and_grad(lambda x, c, f: torch.stack([one(x[i], c[i], f) for i in range(x.shape[0])]),
                           img, coords, fill, ct)


@pytest.mark.parametrize("variant", ["whole", "win", "winx", "winb"])
@pytest.mark.parametrize("b,h,w,c,v,oh,ow,fill", WARP_CASES)
def test_warp_kernels_match_plain(gen, variant, b, h, w, c, v, oh, ow, fill):
    """Value and image gradient; coords span -0.2 .. 1.3 of the source, so
    taps fall inside, on the border and outside. Sources of one pixel, of
    300 rows (more than the TPU kernels take), channel counts other than 3."""
    img, coords, ct = _warp_case(gen, b, h, w, c, v, oh, ow)
    ws.reset_launches()
    out, grad = _value_and_grad(ws.FORWARDS[variant], img, coords, fill, ct)
    assert ws.launches == {**dict.fromkeys(ws.launches, 0), f"{variant}_fwd": 1, f"{ws.ADJOINT[variant]}_bwd": 1}
    ref, gref = _per_image(bilinear_sample_mm, img, coords, fill, ct)
    torch.cuda.synchronize()
    assert out.shape == (b, v, oh, ow, c) and out.is_cuda
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert (grad - gref).abs().max().item() <= 1e-5 * max(gref.abs().max().item(), 1.0)


@pytest.mark.parametrize("b,h,w,c,v,oh,ow,fill", WARP_CASES)
def test_win3_kernels_match_split3_plain_and_stay_near_exact(gen, b, h, w, c, v, oh, ow, fill):
    img, coords, ct = _warp_case(gen, b, h, w, c, v, oh, ow)
    ws.reset_launches()
    out, grad = _value_and_grad(ws.bilinear_sample_pallas_win3, img, coords, fill, ct)
    assert ws.launches == {**dict.fromkeys(ws.launches, 0), "win3_fwd": 1, "win3_bwd": 1}
    ref, gref = _per_image(ws.bilinear_sample_split3, img, coords, fill, ct)
    exact, gexact = _per_image(bilinear_sample_mm, img, coords, fill, ct)
    torch.cuda.synchronize()
    g_max = max(gref.abs().max().item(), 1.0)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert (grad - gref).abs().max().item() <= 1e-5 * g_max
    torch.testing.assert_close(out, exact, atol=3e-4, rtol=0)
    assert (grad - gexact).abs().max().item() <= 7e-5 * g_max


def _run_case(gen, case, c):
    """(img, coords, fill) for the run kernels (win, winx, win3) and the
    whole-image warp with its patch adjoint, two images: the
    path's views of a 120x160 source (224x298 frames); coords scattered over
    -0.2 .. 1.3 of a 300-row source; both in one launch; 37x45 frames (a
    run of 1024 samples ends inside an image); the views as flat coords."""
    from sinddm_tpu_torch.guidance import clip_extractor as ce
    from sinddm_tpu_torch.ops.warp import homography_coords

    def views(src_hw, frame, n_views=2):
        m = ce.view_matrices(ce.draw_view_params(2, n_views, gen, "cuda"), range(n_views), src_hw, frame)
        return homography_coords(m, frame)

    def scattered(src_hw, frame):
        span = torch.tensor([src_hw[1], src_hw[0]], device="cuda", dtype=torch.float32)
        return (torch.rand((2, 1) + frame + (2,), generator=gen, device="cuda") * 1.5 - 0.2) * span

    src_hw = {"views": (120, 160), "scattered": (300, 40), "mixed": (186, 248), "frame37x45": (30, 36),
              "flat": (120, 160)}[case]
    img = torch.rand((2,) + src_hw + (c,), generator=gen, device="cuda")
    frame = ce.resize_output_size(*src_hw)
    if case == "views":
        return img, views(src_hw, frame), 1.0
    if case == "flat":
        return img, views(src_hw, frame).reshape(2, -1, 2), 1.0
    if case == "scattered":
        return img, scattered(src_hw, (40, 50)), 0.5
    if case == "mixed":
        return img, torch.cat([views(src_hw, frame, 1), scattered(src_hw, frame)], dim=1), 1.0
    return img, views(src_hw, (37, 45)), 0.0


@pytest.mark.parametrize("c", [1, 3, 4, 5, 65])
@pytest.mark.parametrize("case", ["views", "scattered", "mixed", "frame37x45", "flat"])
@pytest.mark.parametrize("variant", ["win", "winx", "win3", "whole"])
def test_run_kernels_match_plain(gen, variant, case, c):
    """win, winx and win3 run a block on 1024 consecutive samples of an
    image, a thread on 8 samples; the whole-image adjoint runs a block on a
    2-D patch of a view (1 x 1024 samples on flat coords). Value and image
    gradient against the plain versions at the bounds above, C = 3 (the
    kernels' compiled case) and others, up to 65 (outputs written straight
    from the thread, not staged). The whole-image adjoint takes its
    shared-memory box wherever a patch's box fits, and the scattered and
    mixed cases reach its branch for a box that does not fit (asserted from
    its patch plan)."""
    img, coords, fill = _run_case(gen, case, c)
    if variant == "whole":
        plan = ws.whole_adjoint_patches(coords.reshape(2, -1, 2), coords.shape[-2], img.shape[1:3], c)
        if case in ("scattered", "mixed"):
            assert plan["direct"] > 0
        if case != "scattered" and c == 3:
            assert plan["shared"] > 0
    fn = ws.FORWARDS.get(variant, ws.bilinear_sample_pallas_win3)
    ct = torch.randn(coords.shape[:-1] + (c,), generator=gen, device="cuda")
    ws.reset_launches()
    out, grad = _value_and_grad(fn, img, coords, fill, ct)
    assert ws.launches == {**dict.fromkeys(ws.launches, 0), f"{variant}_fwd": 1, f"{ws.ADJOINT[variant]}_bwd": 1}
    plain = ws.bilinear_sample_split3 if variant == "win3" else bilinear_sample_mm
    ref, gref = _per_image(plain, img, coords, fill, ct)
    torch.cuda.synchronize()
    assert out.shape == coords.shape[:-1] + (c,)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    g_max = max(gref.abs().max().item(), 1.0)
    assert (grad - gref).abs().max().item() <= 1e-5 * g_max
    if variant == "win3":
        exact, gexact = _per_image(bilinear_sample_mm, img, coords, fill, ct)
        torch.testing.assert_close(out, exact, atol=3e-4, rtol=0)
        assert (grad - gexact).abs().max().item() <= 7e-5 * g_max


@pytest.mark.parametrize("variant", ["win", "winx", "win3", "whole"])
def test_run_kernels_take_unaligned_coords_and_outputs(gen, variant):
    """Coords 4 bytes off the 8 the kernels load them at (the run forwards
    and the whole-image adjoint), and 1111-sample images of 3 channels, so
    each image's outputs start at another alignment (the stores' scalar head
    and tail); value and image gradient."""
    shape = (3, 57, 61, 3)
    img = torch.rand(shape, generator=gen, device="cuda")
    views = (torch.rand((3, 11, 101, 2), generator=gen, device="cuda") * torch.tensor([61.0, 57.0], device="cuda"))
    cbuf = torch.empty(1 + views.numel(), device="cuda")
    coords = cbuf[1:].view(views.shape)
    coords.copy_(views)
    assert coords.data_ptr() % 8
    fn = ws.FORWARDS.get(variant, ws.bilinear_sample_pallas_win3)
    plain = ws.bilinear_sample_split3 if variant == "win3" else bilinear_sample_mm
    ct = torch.randn(views.shape[:-1] + (3,), generator=gen, device="cuda")
    out, grad = _value_and_grad(fn, img, coords, 1.0, ct)
    ref, gref = _per_image(plain, img, views, 1.0, ct)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert (grad - gref).abs().max().item() <= 1e-5 * max(gref.abs().max().item(), 1.0)
    torch.testing.assert_close(fn(img, views, 1.0), out, atol=0, rtol=0)


def test_warp_unbatched_far_coords_and_dispatch(gen):
    """One image with coords [..., 2]; coords far outside (and NaN-free
    infinities) give pure fill; warp_homography sends a CUDA image on the
    guidance path through the winx kernel."""
    img = torch.rand((11, 14, 3), generator=gen, device="cuda")
    coords = torch.tensor([[-1e9, 3.0], [5.0, 1e9], [float("inf"), 2.0], [-1.0, -1.0], [14.0, 11.0]], device="cuda")
    for fn in (*ws.FORWARDS.values(), ws.bilinear_sample_pallas_win3):
        out = fn(img, coords, 0.75)
        assert out.shape == (5, 3) and torch.equal(out, torch.full_like(out, 0.75))
    m = torch.tensor([[0.9, 0.05, 1.0], [-0.04, 1.1, -2.0], [1e-4, -2e-4, 1.0]], device="cuda")
    ws.reset_launches()
    out = warp_homography(img, m, (9, 12), fill=1.0, mm_adjoint=True)
    assert ws.launches["winx_fwd"] == 1
    plain = warp_homography(img, m, (9, 12), fill=1.0, impl="mm")
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=0)
    for impl, entry, tol in (("pallas", "whole_fwd", 1e-5), ("pallas_win3", "win3_fwd", 3e-4)):
        ws.reset_launches()
        torch.testing.assert_close(warp_homography(img, m, (9, 12), fill=1.0, impl=impl), plain, atol=tol, rtol=0)
        assert ws.launches[entry] == 1


def test_mm_precision_is_scoped_to_the_call(gen):
    """'high' runs the matrix-product warp in TF32 (close to fp32, not equal)
    and leaves the global switch as it found it."""
    img = torch.rand((40, 52, 3), generator=gen, device="cuda")
    coords = torch.rand((30, 20, 2), generator=gen, device="cuda") * torch.tensor([52.0, 40.0], device="cuda")
    ct = torch.randn((30, 20, 3), generator=gen, device="cuda")
    exact, g_exact = _value_and_grad(bilinear_sample_mm, img, coords, 0.0, ct)
    before = torch.backends.cuda.matmul.allow_tf32
    high, g_high = _value_and_grad(lambda x, c, f: bilinear_sample_mm(x, c, f, "high"), img, coords, 0.0, ct)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    torch.testing.assert_close(high, exact, atol=5e-3, rtol=0)
    torch.testing.assert_close(g_high, g_exact, atol=1e-2, rtol=0)
    assert not torch.equal(high, exact)


def test_warp_wrappers_raise_instead_of_falling_back(gen):
    img = torch.rand((2, 8, 9, 3), generator=gen, device="cuda")
    coords = torch.rand((2, 4, 5, 2), generator=gen, device="cuda")
    ws.reset_launches()
    with pytest.raises(TypeError):
        ws.bilinear_sample_pallas_winx(img.double(), coords.double())
    with pytest.raises(ValueError):  # coords on another device
        ws.bilinear_sample_pallas_winx(img, coords.cpu())
    with pytest.raises(ValueError):  # coords of another batch
        ws.bilinear_sample_pallas_winx(img, coords[:1])
    assert all(n == 0 for n in ws.launches.values())
