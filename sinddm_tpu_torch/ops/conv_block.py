"""The SinDDM conv block: CUDA kernel wrapper and its plain-PyTorch version.

Port of ``sinddm_tpu/ops/pallas_conv.py`` (``fused_conv_block`` /
``_conv_block_kernel``). One block of the denoiser is

    h1  = dw_conv5x5(x) + bias_dw + cond          # cond: per-batch [C]
    g   = gelu(conv3x3(h1, W1) + b1)
    out = conv3x3(g, W2) + b2 + (x @ Wres + bres | x)

with every convolution 'SAME' (zero padding). On a CUDA tensor,
:func:`conv_block` runs three launches: ``h1`` is the depthwise kernel of
:mod:`sinddm_tpu_torch.ops.dw_conv` (counted there), and the two 3x3
stages are ``csrc/conv_block.cu`` (counted here; see the note in that
file). On a CPU tensor it runs :func:`conv_block_reference`. Layout is
NHWC for activations and HWIO for weights, the JAX package's, so the
kernels read the weights as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sinddm_tpu_torch.ops import _build
from sinddm_tpu_torch.ops.dw_conv import (
    KERNEL_DTYPES,
    depthwise_conv5x5,
    depthwise_conv5x5_reference,
)

LAUNCHES_PER_BLOCK = 2  # conv1+bias+GELU, conv2+bias+residual (dw_conv adds one more)
launches = 0  # kernel launches made by conv_block; reset by the caller


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def conv_block_reference(
    x, cond, wdw, bdw, w1, b1, w2, b2, wres, bres
) -> torch.Tensor:
    """Plain-PyTorch version of :func:`conv_block`, same signature and shapes.

    Weights are rounded to the input type and every product is taken in
    float32, as the kernels do; in bf16 the intermediates h1 and g are
    rounded to bf16 before the next product, as the TPU kernel does.
    """
    dt = x.dtype
    f = lambda t: t.to(dt).float()  # noqa: E731
    h = depthwise_conv5x5_reference(x, wdw, bdw, cond).float().permute(0, 3, 1, 2)
    h = F.conv2d(h, f(w1).permute(3, 2, 0, 1), f(b1), padding=1)
    h = gelu(h).to(dt).float()
    h = F.conv2d(h, f(w2).permute(3, 2, 0, 1), f(b2), padding=1)
    xc = x.float().permute(0, 3, 1, 2)
    if wres is None:
        res = xc
    else:
        res = F.conv2d(xc, f(wres).t()[:, :, None, None], f(bres))
    return (h + res).permute(0, 2, 3, 1).to(dt).contiguous()


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
) -> torch.Tensor:
    """One conv block, [B, H, W, C] -> [B, H, W, Co].

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernels or raises; it never falls back. Weights are cast to the input
    type (float32, or bfloat16 with float32 accumulation), as the TPU
    kernel casts them.
    """
    global launches
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
    if b * h * w * max(c, co) >= 2**31:
        raise ValueError(f"activation of {b}x{h}x{w}x{max(c, co)} overflows int32 indexing")
    if x.device.type == "cpu":
        return conv_block_reference(x, cond, wdw, bdw, w1, b1, w2, b2, wres, bres)

    prep = lambda t: None if t is None else t.to(x.dtype).contiguous()  # noqa: E731
    cond, wdw, bdw, w1, b1, w2, b2, wres, bres = (
        prep(t) for t in (cond, wdw, bdw, w1, b1, w2, b2, wres, bres)
    )
    h1 = depthwise_conv5x5(x, wdw, bdw, cond)
    g = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    out = torch.empty_like(g)
    lib = _build.library("conv_block")
    err = getattr(lib, f"sinddm_conv_block_{KERNEL_DTYPES[x.dtype]}")(
        _ptr(h1), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(x), _ptr(wres), _ptr(bres),
        _ptr(g), _ptr(out), b, h, w, c, co, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "conv_block")
    launches += LAUNCHES_PER_BLOCK
    return out
