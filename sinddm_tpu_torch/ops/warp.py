"""Differentiable homography warps and colour ops (port of ``sinddm_tpu/ops/warp.py``).

CLIP guidance differentiates through its stochastic augmentations. Each
view's whole spatial pipeline (crop, resize, flip, affine, perspective) is
one 3x3 homography, followed by one bilinear sample with constant fill.

Conventions, as in the JAX package: homogeneous coordinates (x, y, 1) in
pixels, pixel centres at integers; a matrix maps OUTPUT pixel coordinates to
INPUT sample coordinates. A tap outside the image is dropped, not
renormalised, and its weight goes to ``fill``.

Where the JAX functions are written for one view and vmapped, these take
leading batch dimensions: matrices are ``[..., 3, 3]``, and
:func:`warp_homography` takes one image ``[H, W, C]`` with one matrix
``[3, 3]``, or images ``[B, H, W, C]`` with matrices ``[B, V, 3, 3]``.

Three samplers compute the same function:

* :func:`bilinear_sample`: a 4-tap gather, differentiable in the image and
  the coordinates;
* :func:`bilinear_sample_mm`: hat-function matrices and matrix products in
  both directions (fp32 only), gradient to the image only. It is the plain
  version of the CUDA kernels in :mod:`sinddm_tpu_torch.ops.warp_sample`:
  CPU tensors and the tests take it, a CUDA tensor on the guidance path
  does not. Its ``precision`` is that of its matrix products on a CUDA
  device: "highest" true fp32, "high" / "default" TF32, for that call only;
* the kernels themselves (``impl`` ``pallas`` / ``pallas_win`` /
  ``pallas_winx`` / ``pallas_winb``, named after the TPU kernels they
  replace), and ``pallas_win3``, which splits the products into bf16 parts
  and is about 1e-5 relative off the others; its plain version
  (:func:`~sinddm_tpu_torch.ops.warp_sample.bilinear_sample_split3`) is
  ``impl="mm_split3"``.

The JAX module's import-time environment switches are TPU experiment
hatches; here the implementation is chosen by the ``impl`` argument and the
precision by the ``precision`` argument only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

# impl name -> entry of ops/warp_sample.py
KERNEL_IMPLS = {
    "pallas": "bilinear_sample_pallas",
    "pallas_win": "bilinear_sample_pallas_win",
    "pallas_winx": "bilinear_sample_pallas_winx",
    "pallas_winb": "bilinear_sample_pallas_winb",
    "pallas_win3": "bilinear_sample_pallas_win3",
}
PRECISIONS = ("highest", "high", "default")


class _Clip01(torch.autograd.Function):
    """``clamp(x, 0, 1)`` with the gradient of ``jnp.clip``: 1 inside, 0
    outside, one half where x sits exactly on a bound (``torch.clamp``
    passes 1 there). Guidance sees saturated pixels, so the tie is common."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo = ((x >= 0).to(g.dtype) + (x > 0).to(g.dtype)) * 0.5
        hi = ((x <= 1).to(g.dtype) + (x < 1).to(g.dtype)) * 0.5
        return g * lo * hi


def clip01(x: torch.Tensor) -> torch.Tensor:
    return _Clip01.apply(x)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Sample img [H, W, C] at coords [..., 2] (x, y); constant fill outside.
    A 4-tap gather, differentiable in ``img`` and ``coords``."""
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        v = flat[idx.reshape(-1)].reshape(idx.shape + (C,))
        return torch.where(inb[..., None], v, torch.as_tensor(fill, dtype=img.dtype, device=img.device))

    return (
        tap(x0, y0) * (wx0 * wy0)[..., None]
        + tap(x1, y0) * (wx1 * wy0)[..., None]
        + tap(x0, y1) * (wx0 * wy1)[..., None]
        + tap(x1, y1) * (wx1 * wy1)[..., None]
    )


@contextlib.contextmanager
def matmul_precision(precision: Optional[str], device: torch.device):
    """Matrix products on ``device`` inside the block: "highest" (or None) in
    true fp32, "high" / "default" in TF32 on a CUDA device (the nearest of
    the card's modes to the TPU's fewer-pass products). The switch is set
    for the block and restored after it; on the CPU nothing changes, as on
    JAX's CPU backend."""
    name = precision or "highest"
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: one of {PRECISIONS}")
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _soft_onehots(coords: torch.Tensor, H: int, W: int):
    """Flattened A [N, H] / B [N, W] hat-function tap matrices and the
    in-bounds tap mass ``cover`` [N]: A[q, y] = relu(1 - |y_q - y|)."""
    x = coords[..., 0].reshape(-1)
    y = coords[..., 1].reshape(-1)
    ys = torch.arange(H, dtype=coords.dtype, device=coords.device)
    xs = torch.arange(W, dtype=coords.dtype, device=coords.device)
    A = (1.0 - (y[:, None] - ys[None, :]).abs()).clamp_min(0.0)
    B = (1.0 - (x[:, None] - xs[None, :]).abs()).clamp_min(0.0)
    return A, B, A.sum(-1) * B.sum(-1)


class _BilinearSampleMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, coords, fill, precision):
        H, W, C = img.shape
        A, B, cover = _soft_onehots(coords, H, W)
        # one [N, H] x [H, W] product a channel, then the column taps as a
        # product and a sum over W
        with matmul_precision(precision, img.device):
            val = torch.stack([((A @ img[:, :, c]) * B).sum(-1) for c in range(C)], dim=-1)
        out = val + (1.0 - cover)[:, None] * fill
        ctx.save_for_backward(coords)
        ctx.hw = (H, W)
        ctx.precision = precision
        return out.reshape(coords.shape[:-1] + (C,))

    @staticmethod
    def backward(ctx, ct):
        (coords,) = ctx.saved_tensors
        H, W = ctx.hw
        C = ct.shape[-1]
        A, B, _ = _soft_onehots(coords, H, W)
        ct_flat = ct.reshape(-1, C)
        with matmul_precision(ctx.precision, ct.device):
            ct_img = torch.stack([(A * ct_flat[:, c : c + 1]).T @ B for c in range(C)], dim=-1)
        return ct_img, None, None, None


def bilinear_sample_mm(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0,
                       precision: Optional[str] = None) -> torch.Tensor:
    """:func:`bilinear_sample` by matrix products, forward and adjoint:

        forward:  out[q, c] = sum_X B[q, X] (A @ img[:, :, c])[q, X] + fill (1 - cover[q])
        adjoint:  ct_img[:, :, c] = (A * ct[:, c])^T @ B

    fp32-exact up to summation order against the gather at ``precision``
    "highest" (None); "high" / "default" run the products in TF32 on a CUDA
    device (:func:`matmul_precision`). NOT differentiable in ``coords`` or
    ``fill`` (their gradients are None): guidance differentiates the image
    only, the homographies are random draws."""
    if img.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"bilinear_sample_mm is fp32 only, got {img.dtype}, {coords.dtype}")
    return _BilinearSampleMM.apply(img, coords, float(fill), precision)


def homography_coords(matrix: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Source sample coordinates [..., h, w, 2] (x, y) of every output pixel
    under out->in homographies [..., 3, 3], with the perspective divide."""
    h, w = out_hw
    dev, dt = matrix.device, matrix.dtype
    ys = torch.arange(h, dtype=dt, device=dev)[:, None]
    xs = torch.arange(w, dtype=dt, device=dev)[None, :]
    m = matrix[..., None, None, :, :]  # [..., 1, 1, 3, 3]

    def row(i):
        return m[..., i, 0] * xs + m[..., i, 1] * ys + m[..., i, 2]

    sx, sy, sw = row(0), row(1), row(2)
    den = sw.abs().clamp_min(1e-8)
    sign = torch.sign(sw)
    return torch.stack([sx / den * sign, sy / den * sign], dim=-1)


def warp_homography(
    img: torch.Tensor,
    matrix: torch.Tensor,
    out_hw: Tuple[int, int],
    fill: float = 0.0,
    mm_adjoint: bool = False,
    precision: Optional[str] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Warp by out->in homographies: img [H, W, C] with matrix [3, 3] gives
    [h, w, C]; img [B, H, W, C] with matrix [B, V, 3, 3] gives [B, V, h, w, C].

    ``mm_adjoint=True`` is the guidance path (gradient to the image only, none
    to ``matrix``): a CUDA image goes through the ``pallas_winx`` kernel, a
    CPU image through :func:`bilinear_sample_mm` at ``precision``. ``impl``
    picks explicitly: ``"mm"`` the matrix-product version, ``"mm_split3"``
    the matrix-product version of ``pallas_win3``'s split arithmetic,
    ``"pallas"`` / ``"pallas_win"`` / ``"pallas_winx"`` / ``"pallas_winb"`` /
    ``"pallas_win3"`` a kernel of :mod:`~sinddm_tpu_torch.ops.warp_sample`
    (on a CPU tensor its plain version; the kernels ignore ``precision``).
    Without either, the 4-tap gather runs and ``matrix`` gets a gradient too.
    """
    batched = img.ndim == 4
    if batched != (matrix.ndim == 4):
        raise ValueError(f"img {tuple(img.shape)} does not go with matrix {tuple(matrix.shape)}")
    src = homography_coords(matrix, out_hw)
    if impl is None and mm_adjoint and img.is_cuda:
        impl = "pallas_winx"
    if impl in KERNEL_IMPLS:
        from sinddm_tpu_torch.ops import warp_sample

        return getattr(warp_sample, KERNEL_IMPLS[impl])(img, src, fill)
    if impl == "mm_split3":
        from sinddm_tpu_torch.ops.warp_sample import bilinear_sample_split3

        one = lambda i, c: bilinear_sample_split3(i, c, fill)  # noqa: E731
    elif impl not in (None, "mm"):
        raise ValueError(f"unknown warp impl {impl!r}")
    elif mm_adjoint or impl == "mm":
        one = lambda i, c: bilinear_sample_mm(i, c, fill, precision)  # noqa: E731
    else:
        one = lambda i, c: bilinear_sample(i, c, fill)  # noqa: E731
    if not batched:
        return one(img, src)
    return torch.stack([one(img[b], src[b]) for b in range(img.shape[0])])


# ---------------------------------------------------------------------------
# matrix builders (all return out->in maps, [..., 3, 3])
# ---------------------------------------------------------------------------


def _rows(rows, device=None) -> torch.Tensor:
    """3x3 matrices from nine entries, each a Python number or a tensor; the
    tensors' broadcast shape is the batch shape. Numbers become device fills
    (no host-to-device copy) beside a tensor entry."""
    vals = [v for r in rows for v in r]
    tensors = [v for v in vals if isinstance(v, torch.Tensor)]
    if not tensors:
        return torch.tensor(rows, dtype=torch.float32, device=device)
    shape = torch.broadcast_shapes(*[v.shape for v in tensors])
    ref = tensors[0]
    flat = [v.expand(shape) if isinstance(v, torch.Tensor) else ref.new_full(shape, float(v)) for v in vals]
    return torch.stack(flat, dim=-1).reshape(tuple(shape) + (3, 3))


def crop_resize_matrix(y0, x0, crop_h, crop_w, out_hw: Tuple[int, int], device=None) -> torch.Tensor:
    """Crop [y0, x0, crop_h, crop_w], then resize to ``out_hw`` with
    half-pixel centres: in = (out + 0.5) * scale - 0.5 + offset. The crop may
    be numbers (one matrix, on ``device``) or tensors of one batch shape."""
    h, w = out_hw
    sy, sx = crop_h / h, crop_w / w
    return _rows([[sx, 0.0, x0 + 0.5 * sx - 0.5], [0.0, sy, y0 + 0.5 * sy - 0.5], [0.0, 0.0, 1.0]],
                 device=device)


def hflip_matrix(w: int, device=None) -> torch.Tensor:
    return torch.tensor([[-1.0, 0.0, float(w - 1)], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], device=device)


def affine_matrix(angle_deg, translate_xy, hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse map of a rotation about the image centre plus a translation
    (torchvision RandomAffine: rotate, then translate)."""
    h, w = hw
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    angle_deg = torch.as_tensor(angle_deg, dtype=torch.float32)
    tx, ty = translate_xy
    a = -angle_deg * math.pi / 180.0  # inverse rotation
    cos, sin = torch.cos(a), torch.sin(a)
    return _rows([
        [cos, -sin, cx - cos * (cx + tx) + sin * (cy + ty)],
        [sin, cos, cy - sin * (cx + tx) - cos * (cy + ty)],
        [0.0, 0.0, 1.0],
    ])


def _unit_square_to_quad(quad: torch.Tensor) -> torch.Tensor:
    """Closed-form homography of the unit square onto quads [..., 4, 2]:
    (0,0)->q0, (1,0)->q1, (1,1)->q2, (0,1)->q3."""
    x0, y0 = quad[..., 0, 0], quad[..., 0, 1]
    x1, y1 = quad[..., 1, 0], quad[..., 1, 1]
    x2, y2 = quad[..., 2, 0], quad[..., 2, 1]
    x3, y3 = quad[..., 3, 0], quad[..., 3, 1]
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den
    return _rows([
        [x1 - x0 + g * x1, x3 - x0 + h * x3, x0],
        [y1 - y0 + g * y1, y3 - y0 + h * y3, y0],
        [g, h, torch.ones_like(g)],
    ])


def _mat3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate over determinant), batched."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = _rows([
        [A, -(b * i - c * h), b * f - c * e],
        [B, a * i - c * g, -(a * f - c * d)],
        [C, -(a * h - b * g), a * e - b * d],
    ])
    return adj / det[..., None, None]


def perspective_matrix(startpoints: torch.Tensor, endpoints: torch.Tensor) -> torch.Tensor:
    """Homography M with M @ end ~ start (out->in) from 4 point pairs
    [..., 4, 2]: (unit->start) @ (unit->end)^-1, no linear solve."""
    h_start = _unit_square_to_quad(startpoints.to(torch.float32))
    h_end = _unit_square_to_quad(endpoints.to(torch.float32))
    return h_start @ _mat3_inverse(h_end)


# ---------------------------------------------------------------------------
# colour ops (differentiable; torchvision formulas). x is [..., H, W, 3]; a
# factor is a float or a tensor that broadcasts against x.
# ---------------------------------------------------------------------------

_GRAY_W = (0.2989, 0.587, 0.114)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)
    return (x * w).sum(-1, keepdim=True)


def adjust_brightness(x, f):
    return clip01(x * f)


def adjust_contrast(x, f):
    mean = rgb_to_grayscale(x).mean(dim=(-3, -2, -1), keepdim=True)
    return clip01(mean + f * (x - mean))


def adjust_saturation(x, f):
    g = rgb_to_grayscale(x)
    return clip01(g + f * (x - g))


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(-1)  # amax / amin split a tie's gradient evenly, as jnp.max does
    minc = x.amin(-1)
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / maxc.clamp_min(1e-8), torch.zeros_like(maxc))
    dc = deltac.clamp_min(1e-8)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.long(), 6)

    def pick(options):  # options[k] where i == k
        return torch.stack(options, dim=-1).gather(-1, i[..., None])[..., 0]

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]), pick([p, p, t, v, v, q])], dim=-1)


def adjust_hue(x, factor):
    """Shift hue by ``factor`` in [-0.5, 0.5] (HSV round trip). A tensor
    factor broadcasts against x[..., 0]."""
    h, s, v = _rgb_to_hsv(clip01(x))
    h = torch.remainder(h + factor, 1.0)
    return _hsv_to_rgb(h, s, v)
