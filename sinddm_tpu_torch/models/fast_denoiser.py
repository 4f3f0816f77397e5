"""The denoiser's convolutions as explicit matrix products (port of ``sinddm_tpu/models/fast_denoiser.py``).

A second executor of :class:`~sinddm_tpu_torch.models.denoiser.SinDDMNet`
over the same parameters: every 3x3 (and 1x1) convolution becomes one
matrix product a kernel tap on a shifted slice of the padded input, summed
in float32 (:func:`conv2d_dot`); the depthwise 5x5 becomes 25 shifted
float32 multiply-adds (:func:`depthwise5x5_shifted`). Each shifted slice is
copied before its product, as in the JAX module, so the formulation moves
the activation through memory once a tap.

* ``compute_dtype=torch.float32`` reproduces the model's forward to the
  order of its sums; on a CUDA device its products run in true fp32, TF32
  off for the call (:func:`~sinddm_tpu_torch.ops.warp.matmul_precision`);
* ``compute_dtype=torch.bfloat16`` casts activations and weights to bf16
  and keeps float32 sums, as ``preferred_element_type=float32`` does: on
  a CUDA device the bf16 products run through ``torch.mm(...,
  out_dtype=torch.float32)``; on the CPU, which lacks that product, the
  bf16 operands are widened to float32 first, and a product of two bf16
  values is exact in float32.

No hand-written kernel runs here: the products are cuBLAS's on the card.
The executor runs on the device of its inputs. The sampling walk reaches it
through :func:`sinddm_tpu_torch.apps.sampling.make_model_fn` with
``fast_mode="fp32_dot"`` or ``"bf16_dot"``; as in the JAX package, no CLI
flag selects it.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from sinddm_tpu_torch.models.denoiser import ConvBlock, SinDDMNet, compute_cond_vec
from sinddm_tpu_torch.ops.conv_block import gelu
from sinddm_tpu_torch.ops.warp import matmul_precision


def _dot(x2d: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """``x2d @ w2d`` with float32 products and sums, from float32 or bf16 operands."""
    if x2d.dtype == torch.float32:
        return x2d @ w2d
    if x2d.is_cuda:
        return torch.mm(x2d, w2d, out_dtype=torch.float32)
    return x2d.float() @ w2d.float()


def conv2d_dot(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """'SAME' KxK conv as K*K shifted matrix products. x [B,H,W,Cin], w
    [K,K,Cin,Cout] (HWIO), b [Cout]; the float32 sum plus the float32 bias,
    cast back to x's type."""
    bsz, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    acc = None
    for di in range(kh):
        for dj in range(kw):
            y = _dot(xp[:, di : di + h, dj : dj + wd, :].reshape(-1, cin), w[di, dj])
            acc = y if acc is None else acc.add_(y)
    out = acc + b.float()
    return out.reshape(bsz, h, wd, cout).to(x.dtype)


def depthwise5x5_shifted(x: torch.Tensor, wdw: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """'SAME' depthwise 5x5 as 25 shifted float32 multiply-adds. x
    [B,H,W,C], wdw [5,5,C], b [C]; cast back to x's type."""
    _, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 2, 2, 2, 2))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for di in range(5):
        for dj in range(5):
            acc.addcmul_(xp[:, di : di + h, dj : dj + wd, :].float(), wdw[di, dj].float())
    return (acc + b.float()).to(x.dtype)


def _dense(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A Linear layer in ``dt`` with float32 sums and the float32 bias, cast to ``dt``."""
    return (_dot(x.to(dt), layer.weight.to(dt).t()) + layer.bias.float()).to(dt)


def block_dot(block: ConvBlock, x: torch.Tensor, cond: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """One conv block of the network in ``dt`` (x already in ``dt``; ``cond``
    the network's condition vector in ``dt``)."""
    h = depthwise5x5_shifted(x, block.ds_conv.weight[:, :, 0, :].to(dt), block.ds_conv.bias)
    c = _dense(block.cond_mlp, gelu(cond), dt)
    c = _dense(block.cond_proj, c, dt)
    h = h + c[:, None, None, :]
    h = conv2d_dot(h, block.net_conv1.weight.to(dt), block.net_conv1.bias)
    h = gelu(h)
    h = conv2d_dot(h, block.net_conv2.weight.to(dt), block.net_conv2.bias)
    res = block.res_conv
    return h + (x if res is None else conv2d_dot(x, res.weight.to(dt), res.bias))


def apply_denoiser_dot(
    model: SinDDMNet,
    x: torch.Tensor,
    time: torch.Tensor,
    scale: Union[float, torch.Tensor],
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``model``'s forward with dot-formulated convolutions, over its own
    parameters; returns x's type."""
    dt = compute_dtype
    in_dtype = x.dtype
    with matmul_precision("highest", x.device):
        x = x.to(dt)
        cond = compute_cond_vec(model, time, scale).to(dt)
        for block in (model.l1, model.l2, model.l3, model.l4):
            x = block_dot(block, x, cond, dt)
        fc = model.final_conv
        out = conv2d_dot(x, fc.weight.to(dt), fc.bias)
    return out.to(in_dtype)
