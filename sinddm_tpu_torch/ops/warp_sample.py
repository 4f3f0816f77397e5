"""The bilinear view warp as CUDA kernels (port of ``sinddm_tpu/ops/pallas_warp.py``).

:func:`bilinear_sample_pallas_win`, :func:`bilinear_sample_pallas_winx` and
:func:`bilinear_sample_pallas_winb` keep the names of the TPU entries they
replace. Each computes :func:`sinddm_tpu_torch.ops.warp.bilinear_sample_mm`
(constant fill outside, out-of-range taps dropped, gradient to the image
only) through its own kernel of ``csrc/warp_sample.cu``; the three share one
adjoint kernel, as the TPU kernels do. How the forwards differ:

* ``win``  interpolates along y first and sums over x last;
* ``winx`` interpolates along x first and sums over y last (another fp32
  summation order); the guidance default on a CUDA tensor;
* ``winb`` is ``winx`` with all channels of a pixel in one thread.

Where the JAX functions take one image and are vmapped over views and
images, these are batched in one launch: ``img [H, W, C]`` with ``coords
[..., 2]``, or ``img [B, H, W, C]`` with ``coords [B, ..., 2]`` (all views of
image b behind index b); the output is ``coords.shape[:-1] + (C,)`` and the
adjoint sums over every view of an image. The TPU kernels' limits (H <= 256,
4 MB of source) do not apply.

On a CPU tensor each entry runs the plain version; on a CUDA tensor it
launches its kernel or raises. The adjoint accumulates with ``atomicAdd``, so
its sums come in an order that changes from run to run: it agrees with the
plain version to about 1e-5 of max |gradient|, and is not bit-reproducible.
"""

from __future__ import annotations

import torch

from sinddm_tpu_torch.ops import _build
from sinddm_tpu_torch.ops.warp import bilinear_sample_mm

# kernel launches by C entry; reset by the caller
launches = {"win_fwd": 0, "winx_fwd": 0, "winb_fwd": 0, "win_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(img: torch.Tensor, coords: torch.Tensor):
    """Validate and return (img4 [B,H,W,C], coords3 [B,N,2])."""
    if img.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the warp runs on cuda or cpu tensors, got {img.device}")
    if img.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"the warp takes float32, got {img.dtype} and {coords.dtype}")
    if coords.device != img.device:
        raise ValueError(f"coords on {coords.device}, img on {img.device}")
    if coords.shape[-1] != 2:
        raise ValueError(f"coords must end in (x, y), got {tuple(coords.shape)}")
    if img.ndim == 3:
        img4, coords3 = img[None], coords.reshape(1, -1, 2)
    elif img.ndim == 4 and coords.ndim >= 2 and coords.shape[0] == img.shape[0]:
        img4, coords3 = img, coords.reshape(img.shape[0], -1, 2)
    else:
        raise ValueError(f"img {tuple(img.shape)} does not go with coords {tuple(coords.shape)}")
    if coords3.shape[1] * img4.shape[0] * img4.shape[3] >= 2**31 or img4.numel() >= 2**31:
        raise ValueError("warp shapes overflow int32 indexing")
    return img4, coords3


def _plain(img4: torch.Tensor, coords3: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.stack([bilinear_sample_mm(img4[b], coords3[b], fill) for b in range(img4.shape[0])])


def _launch_forward(variant: str, img4: torch.Tensor, coords3: torch.Tensor, fill: float) -> torch.Tensor:
    b, h, w, c = img4.shape
    n = coords3.shape[1]
    img4, coords3 = img4.contiguous(), coords3.contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=img4.device)
    lib = _build.library("warp_sample")
    err = getattr(lib, f"sinddm_warp_{variant}_fwd")(
        img4.data_ptr(), coords3.data_ptr(), out.data_ptr(), float(fill), b, h, w, c, n,
        img4.device.index or 0, torch.cuda.current_stream(img4.device).cuda_stream,
    )
    _build.check(lib, err, f"bilinear_sample_pallas_{variant}")
    launches[f"{variant}_fwd"] += 1
    return out


def warp_adjoint(ct: torch.Tensor, coords3: torch.Tensor, img_shape) -> torch.Tensor:
    """Image gradient [B, H, W, C] of the warp for cotangent ``ct`` [B, N, C]
    at ``coords3`` [B, N, 2], summed over all N samples of each image. The
    kernel zeroes the gradient and scatters into it with ``atomicAdd``."""
    b, h, w, c = img_shape
    n = coords3.shape[1]
    if not ct.is_cuda:
        raise ValueError("warp_adjoint launches a kernel: it takes CUDA tensors")
    ct = ct.reshape(b, n, c).to(torch.float32).contiguous()
    coords3 = coords3.contiguous()
    gimg = torch.empty((b, h, w, c), dtype=torch.float32, device=ct.device)
    lib = _build.library("warp_sample")
    err = lib.sinddm_warp_win_bwd(
        ct.data_ptr(), coords3.data_ptr(), gimg.data_ptr(), b, h, w, c, n,
        ct.device.index or 0, torch.cuda.current_stream(ct.device).cuda_stream,
    )
    _build.check(lib, err, "bilinear_sample_pallas adjoint")
    launches["win_bwd"] += 1
    return gimg


class _WarpSample(torch.autograd.Function):
    """Forward by the named kernel, backward by the shared adjoint kernel;
    no gradient to the coordinates or the fill."""

    @staticmethod
    def forward(ctx, img4, coords3, fill, variant):
        ctx.save_for_backward(coords3)
        ctx.img_shape = tuple(img4.shape)
        return _launch_forward(variant, img4, coords3, fill)

    @staticmethod
    def backward(ctx, ct):
        (coords3,) = ctx.saved_tensors
        return warp_adjoint(ct, coords3, ctx.img_shape), None, None, None


def _sample(variant: str, img: torch.Tensor, coords: torch.Tensor, fill: float) -> torch.Tensor:
    img4, coords3 = _check(img, coords)
    if img4.device.type == "cpu":
        out = _plain(img4, coords3, float(fill))
    else:
        out = _WarpSample.apply(img4, coords3.detach(), float(fill), variant)
    return out.reshape(coords.shape[:-1] + (img4.shape[3],))


def bilinear_sample_pallas_win(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """The warp with rows interpolated first (TPU ``_fwd_kernel_win``)."""
    return _sample("win", img, coords, fill)


def bilinear_sample_pallas_winx(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """The warp with columns interpolated first (TPU ``_fwd_kernel_winx``)."""
    return _sample("winx", img, coords, fill)


def bilinear_sample_pallas_winb(img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """``winx`` with a pixel's channels in one thread (TPU ``_fwd_kernel_winb``)."""
    return _sample("winb", img, coords, fill)


FORWARDS = {
    "win": bilinear_sample_pallas_win,
    "winx": bilinear_sample_pallas_winx,
    "winb": bilinear_sample_pallas_winb,
}
