"""The bilinear view warp as CUDA kernels (port of ``sinddm_tpu/ops/pallas_warp.py``).

Each entry keeps the name of the TPU entry it replaces and runs through its
own forward kernel of ``csrc/warp_sample.cu``:

* :func:`bilinear_sample_pallas` (the whole-image kernel) interpolates
  along y first and sums over x last; its own adjoint kernel;
* :func:`bilinear_sample_pallas_win`, the same order in its own kernel;
* :func:`bilinear_sample_pallas_winx` interpolates along x first and sums
  over y last (another fp32 summation order); the guidance default on a
  CUDA tensor;
* :func:`bilinear_sample_pallas_winb`, ``winx``'s order in its own kernel
  (the TPU kernel batches a pixel's channels into one contraction; every
  forward here computes a sample's channels in one thread);
* :func:`bilinear_sample_pallas_win3` is ``win`` with the products split
  into bf16 parts (three bf16 x bf16 products, fp32 sums); its own adjoint
  kernel splits both factors the same way.

``win``, ``winx`` and ``winb`` share one adjoint kernel, as the TPU kernels
do. All but ``win3`` compute :func:`sinddm_tpu_torch.ops.warp.bilinear_sample_mm`
(constant fill outside, out-of-range taps dropped, gradient to the image
only), which is their plain version; ``win3``'s plain version is
:func:`bilinear_sample_split3`, the same splits in dense matrix products.

Where the JAX functions take one image and are vmapped over views and
images, these are batched in one launch: ``img [H, W, C]`` with ``coords
[..., 2]``, or ``img [B, H, W, C]`` with ``coords [B, ..., 2]`` (all views of
image b behind index b); the output is ``coords.shape[:-1] + (C,)`` and the
adjoint sums over every view of an image. The TPU kernels' limits (H <= 256,
4 MB of source) do not apply.

Every forward runs a block on a run of consecutive samples of one image, a
thread on several samples with their channels; it loads coords as
``float2``, so they are handed over 8-byte aligned. The three adjoints
(the whole-image one, the windowed one of ``win``, ``winx`` and ``winb``,
and ``win3``'s, whose terms are split products) run one body in three
kernels: a block on a 2-D patch of a view (the frame width is the last
sample axis of ``coords``; flat coords are one row) sums the patch's terms
in a shared-memory box over the source pixels they touch and adds the box
to the gradient with one coalesced atomic an element, or, where the box
does not fit (coords scattered over the source), adds each term to the
gradient directly (:func:`whole_adjoint_patches` reckons which, for any
of them).

On a CPU tensor each entry runs its plain version; on a CUDA tensor it
launches its kernel or raises. The adjoints accumulate with ``atomicAdd``, so
their sums come in an order that changes from run to run: they agree with the
plain versions to about 1e-5 of max |gradient|, and are not bit-reproducible.
"""

from __future__ import annotations

import torch

from sinddm_tpu_torch.ops import _build
from sinddm_tpu_torch.ops.warp import _soft_onehots, bilinear_sample_mm

# kernel launches by C entry; reset by the caller
launches = {
    "whole_fwd": 0, "whole_bwd": 0, "win_fwd": 0, "winx_fwd": 0, "winb_fwd": 0, "win_bwd": 0,
    "win3_fwd": 0, "win3_bwd": 0,
}
# the adjoint kernel of each forward
ADJOINT = {"whole": "whole", "win": "win", "winx": "win", "winb": "win", "win3": "win3"}
# samples a block of the patch adjoints (whole, win, win3), and the floats its
# shared-memory box holds (csrc/warp_sample.cu kPatch, kBoxFloats)
PATCH, BOX_FLOATS = 1024, 8192


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _split_bf16(x: torch.Tensor):
    """x = hi + lo with hi = bf16(x), lo = bf16(x - hi), both back in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


class _BilinearSampleSplit3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, coords, fill):
        H, W, C = img.shape
        A, B, cover = _soft_onehots(coords, H, W)
        a_hi, a_lo = _split_bf16(A)
        i_hi, i_lo = _split_bf16(img)
        # the row products as three bf16 x bf16 matrix products (each product
        # exact in fp32, TF32 or not), summed as the TPU kernel sums them;
        # the column weights unsplit
        val = torch.stack([
            (((a_hi @ i_hi[:, :, c] + a_hi @ i_lo[:, :, c]) + a_lo @ i_hi[:, :, c]) * B).sum(-1)
            for c in range(C)
        ], dim=-1)
        ctx.save_for_backward(coords)
        ctx.hw = (H, W)
        return (val + (1.0 - cover)[:, None] * fill).reshape(coords.shape[:-1] + (C,))

    @staticmethod
    def backward(ctx, ct):
        (coords,) = ctx.saved_tensors
        H, W = ctx.hw
        C = ct.shape[-1]
        A, B, _ = _soft_onehots(coords, H, W)
        b_hi, b_lo = _split_bf16(B)
        ct_flat = ct.reshape(-1, C)
        planes = []
        for c in range(C):
            g_hi, g_lo = _split_bf16(A * ct_flat[:, c : c + 1])  # A * ct in fp32, then split
            planes.append((g_hi.T @ b_hi + g_hi.T @ b_lo) + g_lo.T @ b_hi)
        return torch.stack(planes, dim=-1), None, None


def bilinear_sample_split3(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`bilinear_sample_pallas_win3`: img [H, W, C]
    at coords [..., 2] with the row products split into bf16 parts,

        forward:  out[q, c] = sum_X B[q, X] (A_hi I_hi + A_hi I_lo + A_lo I_hi)[q, X] + fill (1 - cover[q])
        adjoint:  ct_img[:, :, c] = G_hi^T B_hi + G_hi^T B_lo + G_lo^T B_hi,  G = A * ct[:, c]

    with v_hi = bf16(v), v_lo = bf16(v - v_hi). About 1e-5 relative to the
    exact warp, and not equal to it. Gradient to the image only."""
    if img.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"bilinear_sample_split3 is fp32 only, got {img.dtype}, {coords.dtype}")
    return _BilinearSampleSplit3.apply(img, coords, float(fill))


def _check(img: torch.Tensor, coords: torch.Tensor):
    """Validate and return (img4 [B,H,W,C], coords3 [B,N,2], frame width):
    the frame width is the last sample axis of ``coords`` (1 if it has none)."""
    if img.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the warp runs on cuda or cpu tensors, got {img.device}")
    if img.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"the warp takes float32, got {img.dtype} and {coords.dtype}")
    if coords.device != img.device:
        raise ValueError(f"coords on {coords.device}, img on {img.device}")
    if coords.shape[-1] != 2:
        raise ValueError(f"coords must end in (x, y), got {tuple(coords.shape)}")
    if img.ndim == 3:
        img4, coords3, axes = img[None], coords.reshape(1, -1, 2), coords.shape[:-1]
    elif img.ndim == 4 and coords.ndim >= 2 and coords.shape[0] == img.shape[0]:
        img4, coords3, axes = img, coords.reshape(img.shape[0], -1, 2), coords.shape[1:-1]
    else:
        raise ValueError(f"img {tuple(img.shape)} does not go with coords {tuple(coords.shape)}")
    if coords3.shape[1] * img4.shape[0] * img4.shape[3] >= 2**31 or img4.numel() >= 2**31:
        raise ValueError("warp shapes overflow int32 indexing")
    return img4, coords3, max(axes[-1], 1) if axes else 1


def _plain(variant: str, img4: torch.Tensor, coords3: torch.Tensor, fill: float) -> torch.Tensor:
    one = bilinear_sample_split3 if variant == "win3" else bilinear_sample_mm
    return torch.stack([one(img4[b], coords3[b], fill) for b in range(img4.shape[0])])


def _float2(coords3: torch.Tensor) -> torch.Tensor:
    """Contiguous coords at an 8-byte address, copied where they are not: the
    forwards and the patch adjoints load (x, y) as one float2."""
    coords3 = coords3.contiguous()
    return coords3.clone() if coords3.data_ptr() % 8 else coords3


def adjoint_patch(n: int, frame_w: int):
    """(rows, columns) of the frame that a block of a patch adjoint (whole,
    win) takes, for ``n`` samples an image in frames ``frame_w`` wide: PATCH
    samples, 32 x 32, or as many columns as the frame's rows leave room for
    (1 x 1024 on a one-row frame, flat coords)."""
    rows = max(n // frame_w, 1)
    ph = min(32, 1 << (rows - 1).bit_length())
    return ph, PATCH // ph


def _hat_taps(v: torch.Tensor, n: int):
    """csrc/warp_sample.cu hat_taps on a tensor: the two tap indices (clamped)
    and whether each carries weight."""
    inside = (v > -1) & (v < n)
    f = torch.floor(torch.where(inside, v, torch.zeros_like(v)))
    i = f.to(torch.int64)
    w1 = inside & (v != f) & (i + 1 <= n - 1)
    return i.clamp_min(0), (i + 1).clamp(0, n - 1), inside & (i >= 0), w1


def whole_adjoint_patches(coords3: torch.Tensor, frame_w: int, hw, c: int) -> dict:
    """How a patch adjoint kernel (the whole-image one, or win's, which runs
    the same body) takes these coords [B, N, 2], the
    samples in frames ``frame_w`` wide, on a source ``hw`` of ``c`` channels,
    reckoned with tensor ops as the kernel decides: its patches (``patch``,
    rows x columns), how many sum in the shared-memory box (``shared``), how
    many add their terms to the gradient directly (``direct``) and how many
    have no weighted tap (``empty``); the global atomics of each kind
    (``shared_atomics``: a channel of each box pixel some term touches, as
    the flush skips zero sums; ``direct_atomics``: a channel of each term);
    and ``per_sample_atomics``, the terms x c that a thread a sample adds."""
    b, n = coords3.shape[:2]
    h, w = hw
    ph, pw = adjoint_patch(n, frame_w)
    rows = n // frame_w
    tr, tc = -(-rows // ph), -(-frame_w // pw)
    grid = torch.full((b, tr * ph, tc * pw, 2), -2.0, device=coords3.device)
    grid[:, :rows, :frame_w] = coords3.reshape(b, rows, frame_w, 2)
    # [b * patches, samples of a patch, 2]
    grid = grid.reshape(b, tr, ph, tc, pw, 2).transpose(2, 3).reshape(b * tr * tc, ph * pw, 2)
    y0, y1, wy0, wy1 = _hat_taps(grid[..., 1], h)
    x0, x1, wx0, wx1 = _hat_taps(grid[..., 0], w)
    live = (wy0 | wy1) & (wx0 | wx1)
    big = torch.iinfo(torch.int64).max
    x_lo = torch.where(live, torch.where(wx0, x0, x1), big).amin(1)
    x_hi = torch.where(live, torch.where(wx1, x1, x0), -1).amax(1)
    y_lo = torch.where(live, torch.where(wy0, y0, y1), big).amin(1)
    y_hi = torch.where(live, torch.where(wy1, y1, y0), -1).amax(1)
    empty = x_hi < 0
    fits = ~empty & ((x_hi - x_lo + 1) * (y_hi - y_lo + 1) * c <= BOX_FLOATS)
    # every term: (patch, pixel) for each tap pair that carries weight
    patch = torch.arange(grid.shape[0], device=grid.device)[:, None].expand_as(y0)
    keys, in_box = [], []
    for yy, wy in ((y0, wy0), (y1, wy1)):
        for xx, wx in ((x0, wx0), (x1, wx1)):
            term = wy & wx
            keys.append((patch * (h * w) + yy * w + xx)[term])
            in_box.append(fits[:, None].expand_as(term)[term])
    keys, in_box = torch.cat(keys), torch.cat(in_box)
    return {
        "patch": (ph, pw), "shared": int(fits.sum()), "direct": int((~fits & ~empty).sum()),
        "empty": int(empty.sum()), "shared_atomics": int(torch.unique(keys[in_box]).numel()) * c,
        "direct_atomics": int((~in_box).sum()) * c, "per_sample_atomics": keys.numel() * c,
    }


def _launch_forward(variant: str, img4: torch.Tensor, coords3: torch.Tensor, fill: float) -> torch.Tensor:
    b, h, w, c = img4.shape
    n = coords3.shape[1]
    img4 = img4.contiguous()
    coords3 = _float2(coords3)
    out = torch.empty((b, n, c), dtype=torch.float32, device=img4.device)
    lib = _build.library("warp_sample")
    err = getattr(lib, f"sinddm_warp_{variant}_fwd")(
        img4.data_ptr(), coords3.data_ptr(), out.data_ptr(), float(fill), b, h, w, c, n,
        img4.device.index or 0, torch.cuda.current_stream(img4.device).cuda_stream,
    )
    _build.check(lib, err, f"bilinear_sample_pallas_{variant}")
    launches[f"{variant}_fwd"] += 1
    return out


def warp_adjoint(ct: torch.Tensor, coords3: torch.Tensor, img_shape, variant: str = "win",
                 frame_w=None) -> torch.Tensor:
    """Image gradient [B, H, W, C] of the warp for cotangent ``ct`` [B, N, C]
    at ``coords3`` [B, N, 2], summed over all N samples of each image, by the
    adjoint kernel ``variant`` (``whole``, ``win`` or ``win3``). The kernel
    zeroes the gradient and scatters into it with ``atomicAdd``. It takes
    the samples as frames ``frame_w`` wide (it must divide N; None: one row
    of N) and works on 2-D patches of them."""
    b, h, w, c = img_shape
    n = coords3.shape[1]
    frame_w = max(n, 1) if frame_w is None else frame_w
    if frame_w <= 0 or n % frame_w:
        raise ValueError(f"frame width {frame_w} does not divide the {n} samples an image")
    if not ct.is_cuda:
        raise ValueError("warp_adjoint launches a kernel: it takes CUDA tensors")
    ct = ct.reshape(b, n, c).to(torch.float32).contiguous()
    coords3 = _float2(coords3)
    gimg = torch.empty((b, h, w, c), dtype=torch.float32, device=ct.device)
    lib = _build.library("warp_sample")
    err = getattr(lib, f"sinddm_warp_{variant}_bwd")(
        ct.data_ptr(), coords3.data_ptr(), gimg.data_ptr(), b, h, w, c, n, frame_w,
        adjoint_patch(n, frame_w)[1], ct.device.index or 0, torch.cuda.current_stream(ct.device).cuda_stream,
    )
    _build.check(lib, err, f"bilinear_sample_pallas_{variant} adjoint")
    launches[f"{variant}_bwd"] += 1
    return gimg


class _WarpSample(torch.autograd.Function):
    """Forward by the named kernel, backward by its adjoint kernel; no
    gradient to the coordinates or the fill."""

    @staticmethod
    def forward(ctx, img4, coords3, fill, variant, frame_w):
        ctx.save_for_backward(coords3)
        ctx.img_shape = tuple(img4.shape)
        ctx.variant, ctx.frame_w = variant, frame_w
        return _launch_forward(variant, img4, coords3, fill)

    @staticmethod
    def backward(ctx, ct):
        (coords3,) = ctx.saved_tensors
        gimg = warp_adjoint(ct, coords3, ctx.img_shape, ADJOINT[ctx.variant], ctx.frame_w)
        return gimg, None, None, None, None


def _sample(variant: str, img: torch.Tensor, coords: torch.Tensor, fill: float) -> torch.Tensor:
    img4, coords3, frame_w = _check(img, coords)
    if img4.device.type == "cpu":
        out = _plain(variant, img4, coords3, float(fill))
    else:
        out = _WarpSample.apply(img4, coords3.detach(), float(fill), variant, frame_w)
    return out.reshape(coords.shape[:-1] + (img4.shape[3],))


def bilinear_sample_pallas(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """The whole-image warp, rows first (TPU ``_fwd_kernel``)."""
    return _sample("whole", img, coords, fill)


def bilinear_sample_pallas_win(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """The warp with rows interpolated first (TPU ``_fwd_kernel_win``)."""
    return _sample("win", img, coords, fill)


def bilinear_sample_pallas_winx(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """The warp with columns interpolated first (TPU ``_fwd_kernel_winx``)."""
    return _sample("winx", img, coords, fill)


def bilinear_sample_pallas_winb(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """``winx``'s order in its own kernel (TPU ``_fwd_kernel_winb``)."""
    return _sample("winb", img, coords, fill)


def bilinear_sample_pallas_win3(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """``win`` with split-bf16x3 products (TPU ``_fwd_kernel_win3``): about
    1e-5 relative to the exact warp; its plain version is
    :func:`bilinear_sample_split3`."""
    return _sample("win3", img, coords, fill)


# the entries that compute the exact fp32 warp (plain version bilinear_sample_mm)
FORWARDS = {
    "whole": bilinear_sample_pallas,
    "win": bilinear_sample_pallas_win,
    "winx": bilinear_sample_pallas_winx,
    "winb": bilinear_sample_pallas_winb,
}
