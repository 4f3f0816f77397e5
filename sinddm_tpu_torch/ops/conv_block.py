"""The SinDDM conv block: CUDA kernel wrapper and its plain-PyTorch version.

Port of ``sinddm_tpu/ops/pallas_conv.py`` (``fused_conv_block`` /
``_conv_block_kernel``). One block of the denoiser is

    h1  = dw_conv5x5(x) + bias_dw + cond          # cond: per-batch [C]
    g   = gelu(conv3x3(h1, W1) + b1)
    out = conv3x3(g, W2) + b2 + (x @ Wres + bres | x)

with every convolution 'SAME' (zero padding). With a valid ``mask``
([B or 1, H, W, 1] of 0 / 1, the denoiser's valid-mask mode), x, h1 and g
are multiplied by it before they enter a convolution, so a padded canvas
computes on its valid region what the valid crop alone would. On a CUDA tensor,
:func:`conv_block` runs three launches: ``h1`` is the depthwise kernel of
:mod:`sinddm_tpu_torch.ops.dw_conv` (counted there), and the two 3x3
stages are ``csrc/conv_block.cu`` on the tensor cores (counted here; see
the note in that file): 3xTF32 in float32, through warpgroup ``wgmma``
where :func:`wgmma_route` takes the stage's channel counts, with the
weights split once into TF32 hi / lo (:func:`split_weights`), else
``mma.sync``; bf16 ``mma.sync`` in bfloat16. On a CPU tensor it runs
:func:`conv_block_reference`. Layout is NHWC for activations and HWIO for
weights, the JAX package's.

:func:`conv_block_train` is the block as the JAX package trains it (flax
``nn.Conv`` under autograd): the same function in PyTorch's convolutions,
differentiable, in the input's type. The kernels have no backward, and the
JAX package's kernel has none either (``ops/pallas_conv.py`` defines no
``custom_vjp``), so training runs this block.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from sinddm_tpu_torch.ops import _build
from sinddm_tpu_torch.ops.dw_conv import KERNEL_DTYPES, depthwise_conv5x5

LAUNCHES_PER_BLOCK = 2  # conv1+bias+GELU, conv2+bias+residual (dw_conv adds one more)
launches = 0  # kernel launches made by conv_block; reset by the caller
wgmma_launches = 0  # of those, the fp32 stages on wgmma (conv3x3_tc_kernel_sm90)
WGMMA_TILE_N = 80  # output channels a block of the wgmma kernel (csrc/conv_block.cu wg::kTN)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def _block(x, cond, wdw, bdw, w1, b1, w2, b2, wres, bres, rnd, mask=None) -> torch.Tensor:
    """The block's stages as ``F.conv2d`` calls in x's type (the depthwise
    5x5 with ``groups = C``), the depthwise and GELU stages' outputs passed
    through ``rnd`` before the next product, and multiplied by ``mask``
    when there is one."""
    c = x.shape[-1]
    m = (lambda t: t) if mask is None else (lambda t: t * mask.permute(0, 3, 1, 2))  # noqa: E731
    xc = m(x.permute(0, 3, 1, 2))  # NCHW view of NHWC memory (channels-last)
    h = m(rnd(F.conv2d(xc, wdw.permute(2, 0, 1)[:, None], bdw, padding=2, groups=c) + cond[:, :, None, None]))
    h = m(rnd(gelu(F.conv2d(h, w1.permute(3, 2, 0, 1), b1, padding=1))))
    h = F.conv2d(h, w2.permute(3, 2, 0, 1), b2, padding=1)
    res = xc if wres is None else F.conv2d(xc, wres.t()[:, :, None, None], bres)
    return (h + res).permute(0, 2, 3, 1)


def conv_block_train(
    x, cond, wdw, bdw, w1, b1, w2, b2, wres, bres, mask=None
) -> torch.Tensor:
    """The block with :func:`conv_block`'s signature under autograd, every
    stage in x's type (float32 to train; float64 as the oracle) with no
    rounding in between. On a CUDA tensor these are cuDNN's convolutions,
    in TF32 where the caller lets cuDNN take it
    (``torch.backends.cudnn.allow_tf32``).

    In the valid-mask mode (the padded training chunk), the mask multiplies
    x on entry and h1 and g between the stages, inside the autograd graph.
    So on the valid region the output, and everywhere the parameters'
    gradients, equal those of the block run on the valid crop at its true
    shape, for a gradient of the output that is 0 outside the region: the
    masks give each convolution the zeros that 'SAME' padding gives the
    crop."""
    return _block(x, cond, wdw, bdw, w1, b1, w2, b2, wres, bres, rnd=lambda t: t, mask=mask)


def conv_block_reference(
    x, cond, wdw, bdw, w1, b1, w2, b2, wres, bres, mask=None
) -> torch.Tensor:
    """Plain-PyTorch version of :func:`conv_block`, same signature and shapes.

    Weights are rounded to the input type and every product is taken in
    float32, as the kernels do; in bf16 the intermediates h1 and g are
    rounded to bf16 before the next product, as the TPU kernel does. In
    float32 this is :func:`conv_block_train`.
    """
    dt = x.dtype
    f = lambda t: None if t is None else t.to(dt).float()  # noqa: E731
    out = _block(x.float(), f(cond), f(wdw), f(bdw), f(w1), f(b1), f(w2), f(b2), f(wres), f(bres),
                 rnd=lambda t: t.to(dt).float(), mask=f(mask))
    return out.to(dt).contiguous()


def wgmma_route(c_in: int, co: int, dtype: torch.dtype) -> bool:
    """Whether a 3x3 stage with ``c_in`` input channels and ``co`` outputs
    runs on the wgmma kernel: float32, both counts multiples of 8 (the K
    chunk; 16-byte copies of the stage's input, pairs of outputs). In the
    walk, every stage but l1's conv1 (C = 3); bf16 and every other shape
    take the ``mma.sync`` kernel."""
    return dtype == torch.float32 and c_in % 8 == 0 and co % 8 == 0


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` and the kernels' ``tf32_rna``
    round, bit for bit: to the nearest value with 10 stored mantissa bits,
    ties away from zero. Adding half a TF32 unit to the sign-magnitude
    pattern and clearing the 13 low bits does both."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_weights_kmajor(w: torch.Tensor) -> torch.Tensor:
    """The wgmma kernel's B operand for weights ``w`` [taps, C, Co]
    (the 3x3 stage's [9, C, Co], the projection's [1, C, Co]), float32:
    hi = rna(w), lo = rna(w - hi), laid out as
    [ceil(Co / 80), ceil(C / 8), taps, 2 (hi, lo), 80 / 8, 2, 8, 4]: per
    tile of 80 output channels, chunk of 8 input channels, tap and half,
    the 8 x 16-byte core matrices of a K-major slab (n8 group, k4 half,
    the group's 8 output channels, 4 input channels), zero past C and Co."""
    taps, c, co = w.shape
    kc, nt = -(-c // 8), -(-co // WGMMA_TILE_N)
    wp = w.new_zeros((taps, 8 * kc, WGMMA_TILE_N * nt), dtype=torch.float32)
    wp[:, :c, :co] = w
    hi = tf32_rna(wp)
    lo = tf32_rna(wp - hi)
    s = torch.stack((hi, lo)).view(2, taps, kc, 2, 4, nt, WGMMA_TILE_N // 8, 8)
    return s.permute(5, 2, 1, 0, 6, 3, 7, 4).contiguous()  # (nt, kc, taps, h, j, k4, n8, k)


# split_weights' cache: id of the tensor, or of a view's base with the view's
# geometry -> (a weak reference to the base, its version when split, the split)
_splits: Dict[tuple, tuple] = {}


def split_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`split_weights_kmajor` of ``w`` ([3, 3, C, Co] or [C, Co]),
    built once per weight version: cached on the tensor (a view by its
    base) and its ``_version``, so an in-place update, a new load or a new
    tensor splits again, and a walk's steps after the first add no launch."""
    base = w._base
    if base is None:
        base, key = w, id(w)
    else:
        key = (id(base), w.shape, w.stride(), w.storage_offset())
    hit = _splits.get(key)
    if hit is not None and hit[0]() is base and hit[1] == base._version:
        return hit[2]
    version = base._version
    split = split_weights_kmajor(w.reshape(-1, *w.shape[-2:]).float())
    _splits[key] = (weakref.ref(base, lambda _, k=key: _splits.pop(k, None)), version, split)
    return split


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def conv_block(
    x: torch.Tensor,  # [B, H, W, C]
    cond: torch.Tensor,  # [B, C], already projected for this block
    wdw: torch.Tensor,  # [5, 5, C]
    bdw: torch.Tensor,  # [C]
    w1: torch.Tensor,  # [3, 3, C, Co]
    b1: torch.Tensor,  # [Co]
    w2: torch.Tensor,  # [3, 3, Co, Co]
    b2: torch.Tensor,  # [Co]
    wres: Optional[torch.Tensor],  # [C, Co], or None for the identity
    bres: Optional[torch.Tensor],  # [Co], or None
    mask: Optional[torch.Tensor] = None,  # [B or 1, H, W, 1] of 0 / 1, or None
) -> torch.Tensor:
    """One conv block, [B, H, W, C] -> [B, H, W, Co].

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernels or raises; it never falls back. Weights are cast to the input
    type (float32, or bfloat16 with float32 accumulation), as the TPU
    kernel casts them. With ``mask``, x is multiplied by it on entry and h1
    and g between the launches.
    """
    global launches, wgmma_launches
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"conv_block runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"conv_block takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    co = w1.shape[-1]
    expect = {
        "cond": (cond, (b, c)), "wdw": (wdw, (5, 5, c)), "bdw": (bdw, (c,)),
        "w1": (w1, (3, 3, c, co)), "b1": (b1, (co,)), "w2": (w2, (3, 3, co, co)),
        "b2": (b2, (co,)),
    }
    if wres is None:
        if c != co:
            raise ValueError(f"identity residual needs C == Co, got {c} -> {co}")
    else:
        expect.update(wres=(wres, (c, co)), bres=(bres, (co,)))
    for name, (t, shape) in expect.items():
        if t is None or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}")
    if mask is not None and (mask.ndim != 4 or mask.shape[0] not in (1, b) or tuple(mask.shape[1:]) != (h, w, 1)
                             or mask.device != x.device):
        raise ValueError(f"mask must be [{b} or 1, {h}, {w}, 1] on {x.device}, got {tuple(mask.shape)}")
    if b * h * w * max(c, co) >= 2**31:
        raise ValueError(f"activation of {b}x{h}x{w}x{max(c, co)} overflows int32 indexing")
    if x.device.type == "cpu":
        return conv_block_reference(x, cond, wdw, bdw, w1, b1, w2, b2, wres, bres, mask)

    prep = lambda t: None if t is None else t.to(x.dtype).contiguous()  # noqa: E731
    cond, wdw, bdw, w1, b1, w2, b2, wres, bres, mask = (
        prep(t) for t in (cond, wdw, bdw, w1, b1, w2, b2, wres, bres, mask)
    )
    if mask is not None:
        x = x * mask
    h1 = depthwise_conv5x5(x, wdw, bdw, cond)
    g = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    out = torch.empty_like(g)
    lib = _build.library("conv_block")
    dname, dev = KERNEL_DTYPES[x.dtype], x.device.index or 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if mask is not None:
        h1.mul_(mask)
    entry = f"sinddm_conv_stage1_{dname}"
    if wgmma_route(c, co, x.dtype):
        entry, w1 = entry + "_wgmma", split_weights(w1)
        wgmma_launches += 1
    err = getattr(lib, entry)(_ptr(h1), _ptr(w1), _ptr(b1), _ptr(g), b, h, w, c, co, dev, stream)
    _build.check(lib, err, "conv_block stage 1")
    if mask is not None:
        g.mul_(mask)
    entry = f"sinddm_conv_stage2_{dname}"
    if wgmma_route(co, co, x.dtype):
        entry, w2 = entry + "_wgmma", split_weights(w2)
        wres = None if wres is None else split_weights(wres)
        wgmma_launches += 1
    err = getattr(lib, entry)(
        _ptr(g), _ptr(w2), _ptr(b2), _ptr(x), _ptr(wres), _ptr(bres), _ptr(out), b, h, w, c, co, dev, stream)
    _build.check(lib, err, "conv_block stage 2")
    launches += LAUNCHES_PER_BLOCK
    return out
