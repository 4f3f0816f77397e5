"""SAME 5x5 depthwise convolution + bias with true fp32 accumulation.

Port of ``sinddm_tpu/ops/pallas_dw.py`` (``depthwise_conv5x5`` /
``_dw_kernel``): 25 fp32 FMAs per output, never TF32. The same kernel,
given the optional per-batch ``vec``, is the first stage of the conv block
(``dw5x5(x) + bias + cond``; see :mod:`sinddm_tpu_torch.ops.conv_block`),
and so runs on the sampling path. On a CUDA tensor,
:func:`depthwise_conv5x5` launches ``csrc/dw_conv.cu``; on a CPU tensor it
runs :func:`depthwise_conv5x5_reference`. NHWC activations, [5, 5, C]
weights.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sinddm_tpu_torch.ops import _build

launches = 0  # kernel launches made by depthwise_conv5x5; reset by the caller

# the kernels' types, and the suffix of their C entries
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def depthwise_conv5x5_reference(
    x: torch.Tensor, wdw: torch.Tensor, bias: torch.Tensor, vec: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain-PyTorch version: weights rounded to the input type, the sum
    taken in float32 (float64 for a float64 input, the oracle), the result
    rounded to the input type."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    f = lambda t: t.to(dt).to(acc)  # noqa: E731
    y = F.conv2d(
        x.to(acc).permute(0, 3, 1, 2), f(wdw).permute(2, 0, 1)[:, None], f(bias),
        padding=2, groups=x.shape[-1],
    )
    if vec is not None:
        y = y + f(vec)[:, :, None, None]
    return y.permute(0, 2, 3, 1).to(dt).contiguous()


def depthwise_conv5x5(
    x: torch.Tensor, wdw: torch.Tensor, bias: torch.Tensor, vec: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, C]: dw5x5(x) + bias (+ vec[:, None, None, :]).

    float32 is the true-fp32 path; bfloat16 (the conv block's bf16 mode)
    sums in float32 and rounds once. Weights, bias and ``vec`` must have
    x's type. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises.
    """
    global launches
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"depthwise_conv5x5 runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"depthwise_conv5x5 takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    args = [("wdw", wdw, (5, 5, c)), ("bias", bias, (c,))]
    if vec is not None:
        args.append(("vec", vec, (b, c)))
    for name, t, shape in args:
        if tuple(t.shape) != shape or t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {shape} {x.dtype} on {x.device}")
    if x.numel() >= 2**31:
        raise ValueError(f"{tuple(x.shape)} overflows int32 indexing")
    if x.device.type == "cpu":
        return depthwise_conv5x5_reference(x, wdw, bias, vec)
    wdw, bias = wdw.contiguous(), bias.contiguous()
    vec = None if vec is None else vec.contiguous()
    out = torch.empty_like(x)
    lib = _build.library("dw_conv")
    err = getattr(lib, f"sinddm_dw_conv5x5_{KERNEL_DTYPES[x.dtype]}")(
        x.data_ptr(), wdw.data_ptr(), bias.data_ptr(),
        None if vec is None else vec.data_ptr(), out.data_ptr(),
        b, h, w, c, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "depthwise_conv5x5")
    launches += 1
    return out
