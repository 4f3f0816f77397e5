"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where there is no CUDA device. On a
machine with one (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The shapes here are small and ragged on purpose (W and H of 1, channel
counts that are not multiples of the kernels' chunks and tiles); the full
dim=160 shapes of the sampling path are checked by ``chip_smoke.py``.
Tolerances as there: fp32 atol 2e-4 + rtol 2e-4 (sum order); bf16 max
error <= 2e-2 of max |plain|; dw against float64 atol 1e-5 (bf16: half a
bf16 ulp of the exact value, + 1e-4 for the fp32 sum); the warp kernels
against their plain version (``bilinear_sample_mm``; for win3
``bilinear_sample_split3``): value atol 1e-5, image gradient 1e-5 of max
|gradient| (the adjoints' atomics sum in an order that changes from run to
run); win3 against the exact warp at the JAX package's bounds, value 3e-4
and gradient 7e-5 of max |gradient|; the win3 adjoint also against its
plain version in float64 at 1e-5 of max |gradient| and against the
windowed adjoint on the same coords at 7e-5. Training, in the trainer's
fp32 scope with cuDNN's TF32 otherwise on (PyTorch's default), against
float64 on the card: the differentiable block's values within 1e-5 of max
|value| and its gradients within 1e-4 of each max |gradient|; one train
step's loss within 1e-5 relative, its gradients within 1e-4 of max
|gradient| and every parameter's change within 1e-2 lr for all but 0.1% of
the elements (Adam's first step is about lr times the gradient's sign,
which a gradient near zero may flip). The control: the same step without
the trainer's scope, in TF32, breaks one of those bounds. Training chunks
replaying CUDA graphs against the eager chunks from the same seed: the
losses within 1e-4 relative, the parameters within 0.25 lr (the two
drift through cuDNN's non-repeatable backward). An i2i walk and a
ROI walk at dim 16 through the kernels against the same walks through the
plain conv block, under the same seeded noise: 2e-3 absolute, the bound of
a batch-2 walk in ``chip_smoke.py``.
"""

import contextlib

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
     (1, 5, 33, 12, 24), (2, 17, 3, 16, 8), (1, 9, 250, 160, 80),
     # the walk's widths, a few rows each (ragged in H and W)
     (1, 9, 64, 160, 160), (1, 10, 90, 80, 160), (1, 3, 126, 160, 80), (1, 7, 177, 160, 160),
     (1, 2, 248, 3, 80),
     # l1's C = 3 -> 80 and l4's 160 -> 80, both through the projection
     (2, 11, 20, 3, 80), (2, 5, 17, 160, 80),
     # Co not a multiple of the 80-channel tile: 100 takes 16-byte copies, 90 plain loads
     (1, 6, 20, 16, 100), (1, 6, 20, 90, 90),
     # C = 12: 16-byte copies in fp32, plain loads in bf16
     (2, 9, 19, 12, 12),
     # batch > 1 with several chunks in the ring
     (4, 9, 17, 80, 80)],
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,c,co,vh,vw,mb", [
    (2, 11, 20, 3, 80, 7, 13, 2), (1, 10, 90, 80, 160, 10, 61, 1), (2, 9, 64, 160, 160, 5, 64, 1),
    (1, 6, 20, 90, 90, 6, 9, 1)])
def test_conv_block_mask_mode_matches_plain(gen, b, h, w, c, co, vh, vw, mb, dtype):
    """The valid-mask mode: the two 3x3 stages through their own entries, the
    mask between the launches; against the plain block in the mask mode,
    and against the block on the valid crop there (with mask batch 1 and B)."""
    args = _block(gen, b, h, w, c, co, dtype)
    mask = torch.zeros((mb, h, w, 1), dtype=dtype, device="cuda")
    mask[:, :vh, :vw] = 1
    cb.launches = dw.launches = 0
    out = cb.conv_block(*args, mask=mask)
    assert (cb.launches, dw.launches) == (cb.LAUNCHES_PER_BLOCK, 1)
    ref = cb.conv_block_reference(*args, mask=mask)
    crop = cb.conv_block((args[0] * mask)[:, :vh, :vw].contiguous(), *args[1:])
    torch.cuda.synchronize()
    assert out.shape == (b, h, w, co) and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(out[:, :vh, :vw], crop, atol=2e-4, rtol=2e-4)
    else:
        for a, r in ((out, ref), (out[:, :vh, :vw], crop)):
            assert (a.float() - r.float()).abs().max().item() <= 2e-2 * r.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shifted", ["x", "w1", "wres"])
def test_conv_block_copy_and_plain_staging_agree(gen, shifted, dtype):
    """A tensor 16-byte aligned with a channel count the copies take is
    staged by cp.async; the same values at an address 4 bytes (fp32) / 2
    bytes (bf16) off are staged by plain loads. The products see the same
    shared-memory tile, so the outputs are equal."""
    args = list(_block(gen, 2, 9, 19, 16, 24, dtype))
    index = {"x": 0, "w1": 4, "wres": 8}[shifted]
    t = args[index].to(dtype)
    buf = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")
    buf[1:] = t.reshape(-1)
    off = buf[1:].view(t.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    aligned = list(args)
    aligned[index] = t.clone()
    args[index] = off
    torch.testing.assert_close(cb.conv_block(*args), cb.conv_block(*aligned), atol=0, rtol=0)


# the walk's four blocks at rows of its coarsest (48x64) and finest (186x248)
# scale, ragged in H and W, B = 1
WGMMA_CASES = [(b, h, w, c, co) for (c, co) in ((3, 80), (80, 160), (160, 160), (160, 80))
               for (b, h, w) in ((2, 5, 64), (1, 9, 248), (1, 19, 21), (1, 3, 7))]


@pytest.mark.parametrize("b,h,w,c,co", WGMMA_CASES)
def test_wgmma_stages_match_float64_and_mma_sync(gen, monkeypatch, b, h, w, c, co):
    """The fp32 stages on wgmma against the block in float64, and against the
    same stages through the mma.sync kernel on the same inputs: within the
    fp32 bound, and no worse than 1.5x the mma.sync kernel's largest error.
    Stages whose channel counts the route rule takes run on wgmma (l1's
    conv1, C = 3, stays on mma.sync)."""
    args = _block(gen, b, h, w, c, co, torch.float32)
    ref = cb.conv_block_train(*[None if t is None else t.double() for t in args])
    cb.launches = cb.wgmma_launches = 0
    new = cb.conv_block(*args)
    assert (cb.launches, cb.wgmma_launches) == (2, 1 + cb.wgmma_route(c, co, torch.float32))
    monkeypatch.setattr(cb, "wgmma_route", lambda *shape: False)
    old = cb.conv_block(*args)
    assert (cb.launches, cb.wgmma_launches) == (4, 1 + (c % 8 == 0))
    torch.cuda.synchronize()
    err_new = (new.double() - ref).abs().max().item()
    err_old = (old.double() - ref).abs().max().item()
    torch.testing.assert_close(new.double(), ref, atol=2e-4, rtol=2e-4)
    assert err_new <= 1.5 * err_old + 1e-12, (err_new, err_old)


def test_walk_runs_seven_of_eight_stages_on_wgmma(gen):
    """A dim-16 walk (blocks 3 -> 8 -> 16 -> 16 -> 8): every stage but l1's
    conv1 runs on wgmma, and kernel 1's launch count is what it was."""
    from sinddm_tpu_torch.apps.sampling import sample_scales

    pyr, sched, paths = _dim16_walk(gen)
    calls = []

    def model_fn(x, t, s):
        calls.append(s)
        return paths["kernel"](x, t, s)

    cb.launches = cb.wgmma_launches = 0
    outs = sample_scales(model_fn, sched, pyr.sizes_hw, scale_factor=pyr.scale_factor, n_scales=3, batch_size=2,
                         generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[-1]).all()) and len(calls) > 3
    assert cb.launches == len(calls) * 4 * cb.LAUNCHES_PER_BLOCK
    assert cb.wgmma_launches * 8 == cb.launches * 7


# and shapes that cross the rolling-row kernel's edges: W and H of 1 and
# under the window, strips past W (32 columns), a partial last channel slab
# (C = 80: slabs of 32), several segments (H = 37, 130); C = 7, and C = 4 in
# bf16, take the scalar kernel
DW_SHAPES = [(1, 1, 1, 3), (2, 19, 21, 8), (1, 6, 130, 160), (3, 2, 5, 80)] + [
    (2, h, w, c) for h in (1, 2, 5, 37, 130) for w in (1, 21, 33, 130) for c in (4, 8, 80, 160, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", DW_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_vec", [False, True])
def test_dw_matches_float64(gen, shape, with_vec, dtype):
    """Against the float64 plain version on the same (rounded) values: fp32
    atol 1e-5; bf16 within half a bf16 ulp of the exact value, + 1e-4 for
    the fp32 sum (a rounding tie may go either way)."""
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    wdw = (torch.randn((5, 5, c), generator=gen, device="cuda") * 0.2).to(dtype)
    bias = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
    vec = (torch.randn((shape[0], c), generator=gen, device="cuda") * 0.2).to(dtype) if with_vec else None
    dw.launches = 0
    out = dw.depthwise_conv5x5(x, wdw, bias, vec)
    assert dw.launches == 1 and out.dtype == dtype
    ref = dw.depthwise_conv5x5_reference(
        x.double(), wdw.double(), bias.double(), None if vec is None else vec.double())
    d = (out.double() - ref).abs()
    if dtype == torch.float32:
        assert d.max().item() <= 1e-5
    else:
        assert bool((d <= 1e-4 + 2.0**-8 * ref.abs()).all())
    if shape[1] == 130 and c in (80, 160):
        plan = dw.dw_plan(shape, dtype)
        assert plan["kernel"] == "dw5x5_ring_kernel" and plan["segments"] > 1 and plan["slabs"] > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dw_vector_and_scalar_paths_agree(gen, dtype):
    """C * itemsize % 16 == 0 with aligned pointers takes the rolling-row
    kernel; the same input 4 bytes off alignment takes the scalar one. Same
    sums, same order."""
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
    """(img, coords, fill) for the run kernels (every forward) and the
    whole-image patch adjoint, two images: the path's views of a 120x160
    source (224x298 frames); coords scattered over
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
@pytest.mark.parametrize("variant", ["win", "winx", "win3", "whole", "winb"])
def test_run_kernels_match_plain(gen, variant, case, c):
    """Every forward runs a block on 1024 consecutive samples of an
    image, a thread on 8 samples; the whole-image adjoint runs a block on a
    2-D patch of a view (1 x 1024 samples on flat coords). Value and image
    gradient against the plain versions at the bounds above, C = 3 (the
    kernels' compiled case) and others, up to 65 (outputs written straight
    from the thread, not staged). The whole-image adjoint takes its
    shared-memory box wherever a patch's box fits, and the scattered and
    mixed cases reach its branch for a box that does not fit (asserted from
    its patch plan); so does the windowed adjoint (win, winx and winb's),
    which runs the same patch body in its own kernel and gives the
    whole-image adjoint's gradient on the same coords."""
    img, coords, fill = _run_case(gen, case, c)
    if ws.ADJOINT[variant] in ("whole", "win"):
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
    if ws.ADJOINT[variant] == "win":
        g_whole = ws.warp_adjoint(ct, coords.reshape(2, -1, 2), img.shape, "whole", coords.shape[-2])
        assert (grad - g_whole).abs().max().item() <= 1e-5 * g_max


@pytest.mark.parametrize("variant", ["win", "winx", "win3", "whole", "winb"])
def test_run_kernels_take_unaligned_coords_and_outputs(gen, variant):
    """Coords 4 bytes off the 8 the kernels load them at (the forwards and
    the whole-image adjoint), and 1111-sample images of 3 channels, so
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


def _split3_adjoint_f64(ct, coords3, img_shape):
    """win3's adjoint as its plain version forms it (the hat matrices with
    the TPU kernel's weights, A * ct in fp32, both factors split into bf16
    parts), the three products and their sums in float64."""
    from sinddm_tpu_torch.ops.warp import _soft_onehots

    b, h, w, c = img_shape
    out = torch.zeros(img_shape, dtype=torch.float64, device=ct.device)
    for i in range(b):
        A, B, _ = _soft_onehots(coords3[i], h, w)
        b_hi, b_lo = (t.double() for t in ws._split_bf16(B))
        for ch in range(c):
            g_hi, g_lo = (t.double() for t in ws._split_bf16(A * ct[i, :, ch : ch + 1]))
            out[i, :, :, ch] = (g_hi.T @ b_hi + g_hi.T @ b_lo) + g_lo.T @ b_hi
    return out


@pytest.mark.parametrize("c", [1, 3, 4, 65])
@pytest.mark.parametrize("case", ["views", "scattered", "mixed", "frame37x45", "flat"])
def test_win3_adjoint_matches_float64_and_the_windowed_adjoint(gen, case, c):
    """Kernel 10 runs the patch body with split terms: its shared-memory box
    where a patch's box fits, its direct branch where it does not (the
    scattered and mixed cases, asserted from the plan), on flat coords, 37x45
    frames and a 300-row source; against the split3 adjoint in float64 and
    against the windowed adjoint (exact terms) on the same coords."""
    img, coords, _ = _run_case(gen, case, c)
    coords3, frame_w = coords.reshape(2, -1, 2), coords.shape[-2]
    plan = ws.whole_adjoint_patches(coords3, frame_w, img.shape[1:3], c)
    if case in ("scattered", "mixed"):
        assert plan["direct"] > 0
    if case != "scattered" and c == 3:
        assert plan["shared"] > 0
    ct = torch.randn(coords3.shape[:-1] + (c,), generator=gen, device="cuda")
    ws.reset_launches()
    grad = ws.warp_adjoint(ct, coords3, img.shape, "win3", frame_w)
    assert ws.launches == {**dict.fromkeys(ws.launches, 0), "win3_bwd": 1}
    ref = _split3_adjoint_f64(ct, coords3, img.shape)
    g_win = ws.warp_adjoint(ct, coords3, img.shape, "win", frame_w)
    g_max = max(ref.abs().max().item(), 1.0)
    assert (grad.double() - ref).abs().max().item() <= 1e-5 * g_max
    assert (grad - g_win).abs().max().item() <= 7e-5 * g_max


def _block_args(gen, b, h, w, c, co):
    args = list(_block(gen, b, h, w, c, co, torch.float32))
    return [None if a is None else a.requires_grad_(True) for a in args]


@pytest.mark.parametrize("b,h,w,c,co", [(2, 19, 21, 3, 80), (2, 24, 32, 80, 160), (1, 17, 33, 160, 160),
                                         (2, 12, 16, 160, 80)])
def test_train_block_matches_float64(gen, monkeypatch, b, h, w, c, co):
    """The differentiable block (cuDNN's convolutions in the trainer's fp32
    scope) against the same block in float64: its values and the gradients
    of its input and every weight."""
    from sinddm_tpu_torch.ops.conv_block import conv_block_train
    from sinddm_tpu_torch.training.trainer import fp32_convs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default: the scope keeps fp32
    args = _block_args(gen, b, h, w, c, co)
    args64 = [None if a is None else a.detach().double().requires_grad_(True) for a in args]
    ct = torch.randn((b, h, w, co), generator=gen, device="cuda")
    with fp32_convs():
        out = conv_block_train(*args)
        out.backward(ct)
    out64 = conv_block_train(*args64)
    out64.backward(ct.double())
    assert (out.double() - out64).abs().max().item() <= 1e-5 * out64.abs().max().item()
    for a, a64 in zip(args, args64):
        if a is not None:
            assert (a.grad.double() - a64.grad).abs().max().item() <= 1e-4 * a64.grad.abs().max().item()


def _dim16_trainer(tmp_path, **cfg):
    import numpy as np

    from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.pyramid import Pyramid
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    sizes = ((24, 32), (34, 45), (48, 64))
    rng = np.random.default_rng(0)
    images = tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in sizes)
    pyr = Pyramid(sizes_hw=sizes, sizes_wh=tuple((w_, h_) for h_, w_ in sizes), images=images,
                  recon_images=images, rescale_losses=(0.3, 0.2), scale_factor=1.41, n_scales=3)
    sched = make_schedules(timesteps=100, scale_losses=(0.3, 0.2), n_scales=3, device="cuda")
    return MultiscaleTrainer(SinDDMNet(dim=16, device="cuda"), sched, pyr, TrainConfig(train_batch_size=4, **cfg),
                             DiffusionConfig(), tmp_path, seed=1, device="cuda")


def _step_errors(gen, tmp_path, s):
    from sinddm_tpu_torch.training.trainer import step_vs_float64

    tr = _dim16_trainer(tmp_path)
    t = torch.randint(0, 100, (4,), generator=gen, device="cuda")
    noise = torch.randn((4,) + tuple(tr.data_list[s][0].shape[1:]), generator=gen, device="cuda")
    return step_vs_float64(tr, s, [t], [noise])


def _within_step_bounds(e):
    return e["loss_rel"] <= 1e-5 and e["grad_rel"] <= 1e-4 and e["change_share"] <= 1e-3


@pytest.mark.parametrize("s", [0, 2])
def test_train_step_matches_float64(gen, tmp_path, monkeypatch, s):
    """One step of the trainer at dim 16 against the same step in float64
    from the same weights and draws: loss, gradients and Adam's parameter
    changes. cuDNN's TF32 is on, PyTorch's default, so the trainer's own
    scope is what keeps the step in fp32."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    e = _step_errors(gen, tmp_path, s)
    assert _within_step_bounds(e), e


@pytest.mark.parametrize("s", [0, 2])
def test_train_step_bounds_catch_tf32(gen, tmp_path, monkeypatch, s):
    """The control of the test above: with the trainer's fp32 scope taken
    away, cuDNN runs the step in TF32, and the comparison breaks a bound."""
    from sinddm_tpu_torch.training import trainer as trainer_mod

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(trainer_mod, "fp32_convs", contextlib.nullcontext)
    e = _step_errors(gen, tmp_path, s)
    assert not _within_step_bounds(e), e


def _graph_vs_eager(tmp_path, fused_mode, fault=None):
    """Two chunks of 12 steps at dim 16, with an lr milestone at step 16
    (inside the second chunk, where every step is a replay), on a trainer
    replaying CUDA graphs (a shape's first two steps eager, then the
    capture; ``fault`` planted in its captures as ``chip_smoke.py`` plants
    it) and on an eager one from the same seed. Returns the largest loss
    error (relative), the largest parameter difference (in the initial
    lr), whether the scales were the same, and the shapes captured."""
    import sys
    from pathlib import Path

    import numpy as np

    graph, eager = (_dim16_trainer(tmp_path / name, sched_milestones=(16,)) for name in ("graph", "eager"))
    eager.use_graphs = False
    if fault is not None:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        from chip_smoke import plant_graph_fault

        plant_graph_fault(graph, fault)
    rel = 0.0
    for _ in range(2):
        a, b = ((tr.train_chunk_grouped(12) if fused_mode == "grouped" else tr.train_chunk(12))
                for tr in (graph, eager))
        rel = max(rel, float(np.max(np.abs(a - b) / np.abs(b))))
    lr_now = float(eager.opt.param_groups[0]["lr"])
    assert lr_now == pytest.approx(eager.cfg.train_lr * eager.cfg.lr_gamma)  # the milestone was crossed
    with torch.no_grad():
        off = torch.cat([((p - q).abs() / eager.cfg.train_lr).flatten()
                         for p, q in zip(graph.model.parameters(), eager.model.parameters())])
    return rel, off.max().item(), graph.running_scale == eager.running_scale, set(graph._graphs)


@pytest.mark.parametrize("fused_mode", ["grouped", "padded"])
def test_graph_chunks_match_the_eager_chunks(gen, tmp_path, fused_mode):
    """``_graph_vs_eager``: the same scales, each loss within 1e-4 relative
    and every parameter within 0.25 lr. The two drift apart: cuDNN's
    backward is not bitwise repeatable, and over 24 steps Adam carried that
    to 1.4e-5 of a loss and 0.072 lr of a parameter at this size (H100
    80GB HBM3, 700 W), where a wrong step (stale draws or lr, a stale Adam
    count, unzeroed gradients) moves a loss by far more and a parameter by
    about lr (the control below). A graph is captured for each scale
    (grouped) or the canvas (padded)."""
    rel, off, same, captured = _graph_vs_eager(tmp_path, fused_mode)
    assert rel <= 1e-4 and off <= 0.25 and same, (rel, off, same)
    assert captured == ({("scale", s) for s in range(3)} if fused_mode == "grouped" else {("canvas",)})


@pytest.mark.parametrize("fault", ["unzeroed", "baked_lr", "unregistered"])
@pytest.mark.parametrize("fused_mode", ["grouped", "padded"])
def test_graph_chunk_bounds_catch_planted_faults(gen, tmp_path, fused_mode, fault):
    """The control of the test above: a graph trainer whose captures do not
    zero the gradients, bake in the lr (the milestone is lost), or leave
    the device generator unregistered either fails to capture or breaks
    one of its bounds."""
    try:
        rel, off, same, _ = _graph_vs_eager(tmp_path, fused_mode, fault)
    except RuntimeError:  # the capture refused the step
        return
    assert rel > 1e-4 or off > 0.25 or not same, (rel, off, same)


def _dim16_walk(gen):
    """A 3-scale pyramid of seeded images, its schedules and a seeded dim-16
    denoiser on the card, with the same network through the plain block."""
    import numpy as np

    from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
    from sinddm_tpu_torch.pyramid import Pyramid
    from sinddm_tpu_torch.schedules import make_schedules

    sizes = ((24, 32), (34, 45), (48, 64))
    rng = np.random.default_rng(0)
    images = tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in sizes)
    pyr = Pyramid(sizes_hw=sizes, sizes_wh=tuple((w_, h_) for h_, w_ in sizes), images=images,
                  recon_images=images, rescale_losses=(0.3, 0.2), scale_factor=1.41, n_scales=3)
    sched = make_schedules(timesteps=100, scale_losses=(0.3, 0.2), n_scales=3, device="cuda")
    model = denoiser_from_flax(random_flax_params(dim=16, seed=3), device="cuda")
    return pyr, sched, {"kernel": model, "plain": lambda x, t, s_: model.run(x, t, s_, cb.conv_block_reference)}


def _walk_both(paths, run):
    """``run(model_fn, generator)`` through the kernels and through the plain
    block, from the same seed; the kernel run's launch counts."""
    out = {}
    for name, fn in paths.items():
        cb.launches = dw.launches = 0
        out[name] = run(fn, torch.Generator(device="cuda").manual_seed(5))
        if name == "kernel":
            launches = {"conv_block": cb.launches, "dw_conv": dw.launches}
    torch.cuda.synchronize()
    return out, launches


@pytest.mark.parametrize("mode", ["harmonization", "style_transfer"])
def test_i2i_walk_kernels_match_plain(gen, mode):
    import numpy as np

    from sinddm_tpu_torch.apps.i2i import image2image

    pyr, sched, paths = _dim16_walk(gen)
    rng = np.random.default_rng(1)
    input_img = rng.uniform(-1, 1, (41, 57, 3)).astype(np.float32)  # no pyramid size
    mask = np.zeros((41, 57, 3), np.float32)
    mask[10:20, 30:45] = 1.0
    custom_t = [0, 6, 5]
    out, launches = _walk_both(paths, lambda fn, g: image2image(
        fn, sched, pyr, input_img, mode=mode, mask_img=mask, start_s=1, custom_t=custom_t, batch_size=2,
        generator=g, device="cuda"))
    calls = sum(custom_t[1:])
    assert launches == {"conv_block": calls * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": calls * 4}
    (fk, ok), (fp, op) = out["kernel"], out["plain"]
    assert fk.shape == (2, 41, 57, 3) and bool(torch.isfinite(fk).all())
    assert (fk - fp).abs().max().item() <= 2e-3
    for a, b in zip(ok, op):
        assert (a - b).abs().max().item() <= 2e-3


def test_roi_walk_kernels_match_plain(gen):
    from sinddm_tpu_torch.apps.roi import roi_guided_sampling

    pyr, sched, paths = _dim16_walk(gen)
    out, launches = _walk_both(paths, lambda fn, g: roi_guided_sampling(
        fn, sched, pyr, target_roi=[4, 6, 20, 24], roi_bb_list=[[24, 30, 16, 20], [2, 40, 10, 12]], batch_size=2,
        scale_mul=(1.0, 1.5), generator=g, device="cuda"))
    calls = sum(sched.num_timesteps_ideal)
    assert launches == {"conv_block": calls * 4 * cb.LAUNCHES_PER_BLOCK, "dw_conv": calls * 4}
    for a, b in zip(out["kernel"], out["plain"]):
        assert bool(torch.isfinite(a).all()) and (a - b).abs().max().item() <= 2e-3
