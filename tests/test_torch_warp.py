"""The port's warps == the JAX package's, on the same numpy inputs.

* ``bilinear_sample`` (gather) and ``bilinear_sample_mm`` against
  ``sinddm_tpu.ops.warp``: value atol 1e-5, gradients atol 1e-4.
* ``ops/warp_sample.py`` (on the CPU: the kernels' plain version, through the
  kernels' own entry points and batching) against the Pallas kernels it
  replaces, run in interpret mode as ``tests/test_pallas_warp.py`` runs them:
  value atol 1e-5, image gradient atol 1e-4; fills 0 / 0.5, out-of-bounds
  coordinates, batched views, the tall-source and rotation cases.
* the split-bf16x3 entry ``bilinear_sample_pallas_win3`` (on the CPU its plain
  version ``bilinear_sample_split3``) against the JAX win3 in interpret mode:
  value and image gradient atol 1e-5 (the same bf16 splits, fp32 sums in
  another order); against the exact gather at the JAX test's bounds (value
  3e-4, gradient 2e-3), and never equal to the exact warp.
* ``precision`` of the matrix-product warp: every setting gives the JAX
  package's values and gradients on the CPU, where it changes nothing.
* matrix builders and colour ops: atol 1e-6 (the perspective matrix, a
  product with an inverse, atol 1e-5 + rtol 1e-5; colour-op gradients 1e-4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.ops import pallas_warp as jpw
from sinddm_tpu.ops import warp as jw
from sinddm_tpu_torch.ops import warp as tw
from sinddm_tpu_torch.ops import warp_sample as ws

JAX_KERNELS = {
    "whole": jpw.bilinear_sample_pallas,
    "win": jpw.bilinear_sample_pallas_win,
    "winx": jpw.bilinear_sample_pallas_winx,
    "winb": jpw.bilinear_sample_pallas_winb,
}


def _coords(rng, hw, src_hw, spread=1.3):
    """In-bounds, boundary and out-of-bounds sample points, (x, y)."""
    (h, w), (H, W) = hw, src_hw
    x = rng.uniform(-0.2 * W, spread * W, (h, w))
    y = rng.uniform(-0.2 * H, spread * H, (h, w))
    return np.stack([x, y], axis=-1).astype(np.float32)


def _case(seed, src_hw, hw, c=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, src_hw + (c,)).astype(np.float32)
    return img, _coords(rng, hw, src_hw), rng.standard_normal(hw + (c,)).astype(np.float32)


def _torch_value_and_grads(fn, img, coords, tgt, coords_grad=False):
    ti = torch.tensor(img, requires_grad=True)
    tc = torch.tensor(coords, requires_grad=coords_grad)
    out = fn(ti, tc)
    ((out - torch.tensor(tgt)) ** 2).sum().backward()
    return out.detach().numpy(), ti.grad.numpy(), (tc.grad.numpy() if coords_grad else None)


@pytest.mark.parametrize("fill", [0.0, 0.5])
def test_gather_matches_jax(fill):
    img, coords, tgt = _case(0, (19, 23), (17, 13))
    ours, g_img, g_coords = _torch_value_and_grads(
        lambda i, c: tw.bilinear_sample(i, c, fill), img, coords, tgt, coords_grad=True)
    loss = lambda i, c: jnp.sum((jw.bilinear_sample(i, c, fill=fill) - tgt) ** 2)  # noqa: E731
    np.testing.assert_allclose(ours, np.asarray(jw.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), fill=fill)), atol=1e-5)
    j_img, j_coords = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(coords))
    np.testing.assert_allclose(g_img, np.asarray(j_img), atol=1e-4)
    np.testing.assert_allclose(g_coords, np.asarray(j_coords), atol=1e-4)


@pytest.mark.parametrize("fill", [0.0, 0.5])
def test_mm_matches_jax_and_gives_no_coords_gradient(fill):
    img, coords, tgt = _case(1, (19, 23), (17, 13))
    ours, g_img, _ = _torch_value_and_grads(lambda i, c: tw.bilinear_sample_mm(i, c, fill), img, coords, tgt)
    theirs = jw.bilinear_sample_mm(jnp.asarray(img), jnp.asarray(coords), fill)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-5)
    j_img = jax.grad(lambda i: jnp.sum((jw.bilinear_sample_mm(i, jnp.asarray(coords), fill) - tgt) ** 2))(jnp.asarray(img))
    np.testing.assert_allclose(g_img, np.asarray(j_img), atol=1e-4)
    tc = torch.tensor(coords, requires_grad=True)
    out = tw.bilinear_sample_mm(torch.tensor(img, requires_grad=True), tc, fill)
    out.sum().backward()
    assert tc.grad is None
    with pytest.raises(TypeError):
        tw.bilinear_sample_mm(torch.tensor(img).double(), torch.tensor(coords).double())


@pytest.mark.parametrize("variant,fill", [("whole", 0.0), ("whole", 0.5), ("win", 0.5), ("winx", 0.0),
                                          ("winx", 0.5), ("winb", 0.5)])
def test_kernel_entry_matches_pallas_interpret(variant, fill):
    img, coords, tgt = _case(2, (19, 23), (17, 13))
    ours, g_img, _ = _torch_value_and_grads(lambda i, c: ws.FORWARDS[variant](i, c, fill), img, coords, tgt)
    fn = JAX_KERNELS[variant]
    theirs = fn(jnp.asarray(img), jnp.asarray(coords), fill, True)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-5)
    j_img = jax.grad(lambda i: jnp.sum((fn(i, jnp.asarray(coords), fill, True) - tgt) ** 2))(jnp.asarray(img))
    np.testing.assert_allclose(g_img, np.asarray(j_img), atol=1e-4)


@pytest.mark.parametrize("variant", list(JAX_KERNELS))
def test_kernel_entry_batched_views_matches_vmapped_pallas(variant):
    """Images x views in one call, more than one 512-pixel TPU tile a view:
    the gradient sums over the views of each image, as autodiff of the JAX
    ``vmap`` does."""
    rng = np.random.default_rng(3)
    B, V = 2, 3
    imgs = rng.uniform(0, 1, (B, 21, 25, 3)).astype(np.float32)
    coords = np.stack([np.stack([_coords(rng, (26, 30), (21, 25)) for _ in range(V)]) for _ in range(B)])
    ti = torch.tensor(imgs, requires_grad=True)
    out = ws.FORWARDS[variant](ti, torch.tensor(coords), 0.0)
    assert out.shape == (B, V, 26, 30, 3)
    (out ** 2).sum().backward()
    fn = JAX_KERNELS[variant]
    jviews = lambda im, cs: jax.vmap(lambda c: fn(im, c, 0.0, True))(cs)  # noqa: E731
    for b in range(B):
        np.testing.assert_allclose(out[b].detach().numpy(), np.asarray(jviews(jnp.asarray(imgs[b]), jnp.asarray(coords[b]))), atol=1e-5)
        g = jax.grad(lambda im: jnp.sum(jviews(im, jnp.asarray(coords[b])) ** 2))(jnp.asarray(imgs[b]))
        np.testing.assert_allclose(ti.grad[b].numpy(), np.asarray(g), atol=1e-4)


def test_tall_source_matches_pallas_overflow_branch():
    """H = 186 > one 128-row TPU window: most tiles take the Pallas kernel's
    second-window branch."""
    img, coords, tgt = _case(9, (186, 37), (40, 16))
    ours, g_img, _ = _torch_value_and_grads(lambda i, c: ws.bilinear_sample_pallas_win(i, c, 0.25), img, coords, tgt)
    fn = jpw.bilinear_sample_pallas_win
    np.testing.assert_allclose(ours, np.asarray(fn(jnp.asarray(img), jnp.asarray(coords), 0.25, True)), atol=1e-5)
    j_img = jax.grad(lambda i: jnp.sum((fn(i, jnp.asarray(coords), 0.25, True) - tgt) ** 2))(jnp.asarray(img))
    np.testing.assert_allclose(g_img, np.asarray(j_img), atol=1e-4)


def test_rotation_homography_matches_pallas():
    """A 90-degree-like map: an output x-run sweeps the source's rows."""
    H, W = 150, 40
    img = np.random.default_rng(12).uniform(0, 1, (H, W, 3)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(30, dtype=np.float32), np.arange(170, dtype=np.float32), indexing="ij")
    coords = np.stack([ys * 0.9 + 2.0, xs * 0.87 + 1.0], axis=-1)
    ours = ws.bilinear_sample_pallas_win(torch.tensor(img), torch.tensor(coords), 0.0)
    theirs = jpw.bilinear_sample_pallas_win(jnp.asarray(img), jnp.asarray(coords), 0.0, True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_source_taller_than_the_tpu_limit():
    """A 300-row source, which the TPU kernels refuse: the port takes it, and
    agrees with the gather."""
    img, coords, _ = _case(4, (300, 23), (17, 13))
    with pytest.raises(ValueError, match="overflow window"):
        jpw.bilinear_sample_pallas_win(jnp.asarray(img), jnp.asarray(coords), 0.0, True)
    for fn in ws.FORWARDS.values():
        ours = fn(torch.tensor(img), torch.tensor(coords), 0.5)
        np.testing.assert_allclose(ours.numpy(), np.asarray(jw.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), fill=0.5)), atol=1e-5)


@pytest.mark.parametrize("src_hw,hw", [((19, 23), (17, 13)), ((186, 37), (40, 16))])
def test_win3_entry_matches_pallas_win3_interpret(src_hw, hw):
    """The second case takes the TPU kernel's second-window branch."""
    img, coords, tgt = _case(10, src_hw, hw)
    ours, g_img, _ = _torch_value_and_grads(lambda i, c: ws.bilinear_sample_pallas_win3(i, c, 0.25), img, coords, tgt)
    fn = jpw.bilinear_sample_pallas_win3
    np.testing.assert_allclose(ours, np.asarray(fn(jnp.asarray(img), jnp.asarray(coords), 0.25, True)), atol=1e-5)
    j_img = jax.grad(lambda i: jnp.sum((fn(i, jnp.asarray(coords), 0.25, True) - tgt) ** 2))(jnp.asarray(img))
    np.testing.assert_allclose(g_img, np.asarray(j_img), atol=1e-5)


def test_win3_close_to_exact_but_not_exact():
    """The JAX test's case and bounds (tests/test_pallas_warp.py
    test_windowed_split3_close_to_exact); and some element differs from the
    exact warp, so the split cannot silently become the exact path."""
    img = np.asarray(jax.random.uniform(jax.random.PRNGKey(13), (186, 37, 3)))
    coords = _coords(np.random.default_rng(14), (40, 16), (186, 37), spread=1.2)
    tgt = np.asarray(jax.random.normal(jax.random.PRNGKey(15), (40, 16, 3)))
    ours, g_img, _ = _torch_value_and_grads(lambda i, c: ws.bilinear_sample_pallas_win3(i, c, 0.25), img, coords, tgt)
    exact = jw.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), fill=0.25)
    np.testing.assert_allclose(ours, np.asarray(exact), atol=3e-4)
    g_ref = jax.grad(lambda i: jnp.sum((jw.bilinear_sample(i, jnp.asarray(coords), fill=0.25) - tgt) ** 2))(jnp.asarray(img))
    np.testing.assert_allclose(g_img, np.asarray(g_ref), atol=2e-3)
    mm, g_mm, _ = _torch_value_and_grads(lambda i, c: tw.bilinear_sample_mm(i, c, 0.25), img, coords, tgt)
    assert (ours != mm).any() and (g_img != g_mm).any()
    assert ws.bilinear_sample_split3 is not tw.bilinear_sample_mm


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_mm_precision_matches_jax_and_changes_nothing_on_the_cpu(precision):
    img, coords, tgt = _case(11, (19, 23), (17, 13))
    ours, g_img, _ = _torch_value_and_grads(lambda i, c: tw.bilinear_sample_mm(i, c, 0.5, precision), img, coords, tgt)
    plain, g_plain, _ = _torch_value_and_grads(lambda i, c: tw.bilinear_sample_mm(i, c, 0.5), img, coords, tgt)
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(g_img, g_plain)
    jfn = lambda i: jw.bilinear_sample_mm(i, jnp.asarray(coords), 0.5, precision)  # noqa: E731
    np.testing.assert_allclose(ours, np.asarray(jfn(jnp.asarray(img))), atol=1e-5)
    j_img = jax.grad(lambda i: jnp.sum((jfn(i) - tgt) ** 2))(jnp.asarray(img))
    np.testing.assert_allclose(g_img, np.asarray(j_img), atol=1e-4)
    m = torch.tensor(_homography(np.random.default_rng(3)))
    torch.testing.assert_close(
        tw.warp_homography(torch.tensor(img), m, (9, 11), mm_adjoint=True, precision=precision),
        tw.warp_homography(torch.tensor(img), m, (9, 11), mm_adjoint=True), atol=0, rtol=0)
    with pytest.raises(ValueError, match="precision"):
        tw.bilinear_sample_mm(torch.tensor(img), torch.tensor(coords), 0.0, "fast")


def test_wrapper_rejects_what_the_kernels_do_not_take():
    img, coords = torch.zeros(5, 6, 3), torch.zeros(4, 4, 2)
    with pytest.raises(TypeError):
        ws.bilinear_sample_pallas_winx(img.double(), coords.double())
    with pytest.raises(ValueError):
        ws.bilinear_sample_pallas_winx(img, torch.zeros(4, 4, 3))
    with pytest.raises(ValueError):  # batch of images, coords of another batch
        ws.bilinear_sample_pallas_winx(torch.zeros(2, 5, 6, 3), torch.zeros(3, 4, 4, 2))
    with pytest.raises(ValueError):  # the adjoint is a kernel only
        ws.warp_adjoint(torch.zeros(1, 16, 3), torch.zeros(1, 16, 2), (1, 5, 6, 3))
    assert all(v == 0 for v in ws.launches.values())


@pytest.mark.parametrize("variant", ["win", "winx", "win3"])
def test_run_entries_take_flat_and_batched_coords_as_pallas(variant):
    """Flat coords [N, 2] (one row) and a batch [B, N, 2] give the Pallas
    kernel's values on the same samples, in interpret mode."""
    img, coords, _ = _case(16, (19, 23), (17, 13))
    img2 = np.stack([img, img[::-1].copy()])
    flat = coords.reshape(-1, 2)
    entry = ws.bilinear_sample_pallas_win3 if variant == "win3" else ws.FORWARDS[variant]
    jfn = jpw.bilinear_sample_pallas_win3 if variant == "win3" else JAX_KERNELS[variant]
    ours = entry(torch.tensor(img), torch.tensor(flat), 0.5)
    assert ours.shape == (17 * 13, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jfn(jnp.asarray(img), jnp.asarray(coords), 0.5, True)).reshape(-1, 3), atol=1e-5)
    both = entry(torch.tensor(img2), torch.tensor(np.stack([flat, flat[::-1].copy()])), 0.5)
    for b in range(2):
        theirs = jfn(jnp.asarray(img2[b]), jnp.asarray(flat if b == 0 else flat[::-1].copy()), 0.5, True)
        np.testing.assert_allclose(both[b].numpy(), np.asarray(theirs), atol=1e-5)


@pytest.mark.parametrize("variant", ["win", "winx", "win3"])
def test_run_entries_take_many_channels_as_pallas(variant):
    """No channel limit: 65 channels on a CPU tensor give the Pallas kernel's
    values, in interpret mode."""
    img, coords, _ = _case(17, (11, 13), (5, 7), c=65)
    entry = ws.bilinear_sample_pallas_win3 if variant == "win3" else ws.FORWARDS[variant]
    jfn = jpw.bilinear_sample_pallas_win3 if variant == "win3" else JAX_KERNELS[variant]
    ours = entry(torch.tensor(img), torch.tensor(coords), 0.5)
    assert ours.shape == (5, 7, 65)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jfn(jnp.asarray(img), jnp.asarray(coords), 0.5, True)), atol=1e-5)


def _taps(v, n):
    """The source indices of a coordinate's weighted taps along an axis of n."""
    if not -1 < v < n:
        return []
    i = math.floor(v)
    return [t for t, ok in ((i, i >= 0), (i + 1, i + 1 <= n - 1 and v != i)) if ok]


def _plan_by_loop(coords3, frame_w, hw, c):
    """``whole_adjoint_patches`` one patch and one sample at a time."""
    b, n = coords3.shape[:2]
    ph, pw = ws.adjoint_patch(n, frame_w)
    rows = n // frame_w
    plan = dict.fromkeys(("shared", "direct", "empty", "shared_atomics", "direct_atomics", "per_sample_atomics"), 0)
    for i in range(b):
        for r0 in range(0, rows, ph):
            for c0 in range(0, frame_w, pw):
                terms = [(yy, xx) for r in range(r0, min(r0 + ph, rows)) for col in range(c0, min(c0 + pw, frame_w))
                         for x, y in [coords3[i, r * frame_w + col].tolist()]
                         for yy in _taps(y, hw[0]) for xx in _taps(x, hw[1])]
                plan["per_sample_atomics"] += len(terms) * c
                if not terms:
                    plan["empty"] += 1
                    continue
                ys, xs = zip(*terms)
                if (max(ys) - min(ys) + 1) * (max(xs) - min(xs) + 1) * c <= ws.BOX_FLOATS:
                    plan["shared"] += 1
                    plan["shared_atomics"] += len(set(terms)) * c
                else:
                    plan["direct"] += 1
                    plan["direct_atomics"] += len(terms) * c
    return plan


@pytest.mark.parametrize("layout,c", [("frames", 3), ("frames", 5), ("flat", 3)])
def test_whole_adjoint_patch_plan_matches_a_loop(layout, c):
    """The whole-image adjoint's host-side logic: the frame width the entries
    read from coords, the patch shape, and the reckoning of which patches sum
    in the shared-memory box and which scatter directly (a view's
    magnified, rotated grid fits; coords scattered over a 60x80 source do
    not), against a plain loop over patches and samples."""
    rng = np.random.default_rng(18)
    rows, cols = np.meshgrid(np.arange(37.0), np.arange(45.0), indexing="ij")
    view = np.stack([0.55 * cols + 0.1 * rows + 3.0, 0.5 * rows - 0.05 * cols + 2.0], axis=-1)
    scattered = rng.uniform(-0.2, 1.3, (37, 45, 2)) * [80.0, 60.0]
    coords = torch.tensor(np.stack([np.stack([view, scattered]), np.stack([scattered, view + 10.5])]), dtype=torch.float32)
    if layout == "flat":
        coords = coords.reshape(2, -1, 2)
    img4, coords3, frame_w = ws._check(torch.zeros(2, 60, 80, c), coords)
    assert frame_w == (45 if layout == "frames" else 2 * 37 * 45) and coords3.shape == (2, 2 * 37 * 45, 2)
    assert ws.adjoint_patch(coords3.shape[1], frame_w) == ((32, 32) if layout == "frames" else (1, 1024))
    assert ws.adjoint_patch(8 * 224 * 298, 298) == (32, 32) and ws.adjoint_patch(3 * 7, 7) == (4, 256)
    plan = ws.whole_adjoint_patches(coords3, frame_w, (60, 80), c)
    assert plan.pop("patch") == ws.adjoint_patch(coords3.shape[1], frame_w)
    assert plan == _plan_by_loop(coords3, frame_w, (60, 80), c)
    assert plan["direct"] > 0 and (plan["shared"] > 0 or layout == "flat")
    assert ws._check(torch.zeros(5, 6, 3), torch.zeros(2))[2] == 1
    with pytest.raises(ValueError, match="frame width"):
        ws.warp_adjoint(torch.zeros(1, 16, 3), torch.zeros(1, 16, 2), (1, 5, 6, 3), "whole", 5)


def _homography(rng):
    m = np.eye(3, dtype=np.float32) + rng.normal(0, 0.05, (3, 3)).astype(np.float32)
    m[2, :2] = rng.normal(0, 1e-3, 2)
    m[:2, 2] = rng.uniform(-3, 3, 2)
    return m


@pytest.mark.parametrize("mode", ["gather", "mm", "pallas_winx"])
def test_warp_homography_matches_jax(mode):
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (23, 31, 3)).astype(np.float32)
    m = _homography(rng)
    kw = {"gather": {}, "mm": dict(mm_adjoint=True), "pallas_winx": dict(impl="pallas_winx")}[mode]
    ours = tw.warp_homography(torch.tensor(img), torch.tensor(m), (20, 27), fill=1.0, **kw)
    theirs = jw.warp_homography(jnp.asarray(img), jnp.asarray(m), (20, 27), fill=1.0, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)  # coords round at ~3e-5 px


def test_warp_homography_batched_and_dispatch():
    rng = np.random.default_rng(6)
    imgs = torch.tensor(rng.uniform(0, 1, (2, 12, 15, 3)).astype(np.float32))
    ms = torch.tensor(np.stack([np.stack([_homography(rng) for _ in range(3)]) for _ in range(2)]))
    out = tw.warp_homography(imgs, ms, (9, 11), fill=0.5, mm_adjoint=True)
    assert out.shape == (2, 3, 9, 11, 3)
    for b in range(2):
        for v in range(3):
            one = tw.warp_homography(imgs[b], ms[b, v], (9, 11), fill=0.5, mm_adjoint=True)
            torch.testing.assert_close(out[b, v], one, atol=1e-6, rtol=0)
    for impl in ("pallas", "pallas_win", "pallas_winx", "pallas_winb", "mm"):
        torch.testing.assert_close(tw.warp_homography(imgs, ms, (9, 11), fill=0.5, impl=impl), out, atol=1e-5, rtol=0)
    win3 = tw.warp_homography(imgs, ms, (9, 11), fill=0.5, impl="pallas_win3")
    torch.testing.assert_close(win3, out, atol=3e-4, rtol=0)
    assert not torch.equal(win3, out)
    torch.testing.assert_close(tw.warp_homography(imgs, ms, (9, 11), fill=0.5, impl="mm_split3"), win3, atol=0, rtol=0)
    with pytest.raises(ValueError):
        tw.warp_homography(imgs, ms, (9, 11), impl="nope")


def test_matrix_builders_match_jax():
    rng = np.random.default_rng(7)
    n = 5
    y0, x0 = rng.uniform(0, 5, n).astype(np.float32), rng.uniform(0, 5, n).astype(np.float32)
    ch, cw = rng.uniform(8, 20, n).astype(np.float32), rng.uniform(8, 20, n).astype(np.float32)
    ang = rng.uniform(-15, 15, n).astype(np.float32)
    tx, ty = rng.uniform(-3, 3, n).astype(np.float32), rng.uniform(-3, 3, n).astype(np.float32)
    corners = np.asarray([[0, 0], [30, 0], [30, 22], [0, 22]], np.float32)
    ends = corners[None] + rng.uniform(0, 5, (n, 4, 2)).astype(np.float32) * np.asarray([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    t = torch.tensor
    crop = tw.crop_resize_matrix(t(y0), t(x0), t(ch), t(cw), (24, 32))
    aff = tw.affine_matrix(t(ang), (t(tx), t(ty)), (23, 31))
    persp = tw.perspective_matrix(t(corners).expand(n, 4, 2), t(ends))
    for i in range(n):
        np.testing.assert_allclose(crop[i].numpy(), np.asarray(jw.crop_resize_matrix(y0[i], x0[i], ch[i], cw[i], (24, 32))), atol=1e-6)
        np.testing.assert_allclose(aff[i].numpy(), np.asarray(jw.affine_matrix(ang[i], (tx[i], ty[i]), (23, 31))), atol=1e-6)
        np.testing.assert_allclose(persp[i].numpy(), np.asarray(jw.perspective_matrix(corners, ends[i])), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.hflip_matrix(31).numpy(), np.asarray(jw.hflip_matrix(31)), atol=0)
    np.testing.assert_allclose(tw.crop_resize_matrix(0.0, 0.0, 19.0, 23.0, (24, 32)).numpy(),
                               np.asarray(jw.crop_resize_matrix(0.0, 0.0, 19.0, 23.0, (24, 32))), atol=1e-6)


@pytest.mark.parametrize("op,factor", [("adjust_brightness", 1.07), ("adjust_contrast", 0.93),
                                       ("adjust_saturation", 1.09), ("adjust_hue", -0.08),
                                       ("adjust_hue", 0.06), ("rgb_to_grayscale", None)])
def test_colour_ops_match_jax_value_and_gradient(op, factor):
    x = np.random.default_rng(8).uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    x[0, 0, 0] = [1.0, 1.0, 1.0]  # a saturated pixel and a gray one: ties in max / clip
    x[0, 0, 1] = [0.3, 0.3, 0.3]
    x[0, 0, 2] = [0.0, 0.5, 1.0]
    args = () if factor is None else (factor,)
    tx = torch.tensor(x, requires_grad=True)
    ours = getattr(tw, op)(tx, *args)
    (ours ** 2).sum().backward()
    jfn = getattr(jw, op)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(jfn(jnp.asarray(x), *args)), atol=1e-6)
    g = jax.grad(lambda v: jnp.sum(jfn(v, *args) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), atol=1e-4)


def test_clip01_has_jnp_clip_gradient():
    x = np.asarray([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    tx = torch.tensor(x, requires_grad=True)
    tw.clip01(tx).sum().backward()
    g = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray(x))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(g))
    np.testing.assert_array_equal(tx.grad.numpy(), [0.0, 0.5, 1.0, 0.5, 0.0])
