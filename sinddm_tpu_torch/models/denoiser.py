"""The SinDDM denoiser as PyTorch modules (port of ``sinddm_tpu/models/denoiser.py``).

* fully convolutional, NHWC: channels 3 -> dim/2 -> dim -> dim -> dim/2 -> 3
  (dim = 160 by default);
* each block: depthwise 5x5, plus a per-block projection of the
  conditioning vector, then 3x3 -> GELU -> 3x3, plus a 1x1 residual (or
  the identity); the whole block is one call of
  :func:`sinddm_tpu_torch.ops.conv_block.conv_block`, which launches the
  CUDA kernel on the card and runs the plain version on the CPU;
* conditioning: 32-d sinusoidal embeddings of timestep t and scale s,
  concatenated, through Linear(64->128) -> GELU -> Linear(128->32). The
  condition MLPs and the final 1x1 conv (dim/2 -> 3) are plain PyTorch.

Parameter names and conv-kernel layouts are the JAX package's: convs keep
flax's HWIO ``weight`` ([kh, kw, Cin, Cout]; the depthwise conv
[5, 5, 1, C]), which is the layout the kernel reads; Dense layers are
``nn.Linear`` ([out, in]). :mod:`sinddm_tpu_torch.models.convert` maps a
flax parameter tree onto these modules.

``compute_dtype`` is float32 (default) or bfloat16: activations and
weights are cast to it at use and the conv blocks accumulate in float32;
the output is returned in the input's type.

The valid-mask mode (``mask``, [B, H, W] or [B or 1, H, W, 1] of 0 / 1):
each block's input, its depthwise stage's output and its GELU's output are
multiplied by the mask, and so are the input and the output of the final
1x1 conv. Every convolution then sees zeros outside the valid region, as
'SAME' padding gives the valid crop alone: on a padded canvas the network
computes the crop's output on the valid region and zeros elsewhere.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from sinddm_tpu_torch.ops.conv_block import conv_block, gelu
from sinddm_tpu_torch.utils.profiling import span

TIME_DIM = 32

# How many rows (and columns) away an output pixel reads its input: each of
# the four blocks convolves 5x5 (radius 2), then 3x3 twice (1 + 1), its
# residual 1x1 reading the block's input at the pixel itself; the final conv
# is 1x1. 4 x (2 + 1 + 1) = 16, a 33-pixel receptive field (the JAX
# package's mesh docstring says 35, which would be 17). A split call
# (parallel/mesh.py split_model_fn) reads this many halo rows each side.
RECEPTIVE_RADIUS = 4 * (2 + 1 + 1)


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of a [B] vector -> [B, dim] float32:
    freqs = exp(-log(10000) * arange(dim/2) / (dim/2 - 1)), cat(sin, cos)."""
    half_dim = dim // 2
    emb = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=x.device) * -emb)
    args = x.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Conv(nn.Module):
    """Convolution parameters in flax's HWIO layout: ``weight`` [kh, kw, Cin, Cout]."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, *, device=None, dtype=None):
        super().__init__()
        kw_ = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty((kh, kw, cin, cout), **kw_))
        self.bias = nn.Parameter(torch.empty((cout,), **kw_))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        fan_in = self.weight.shape[0] * self.weight.shape[1] * self.weight.shape[2]
        nn.init.normal_(self.weight, std=fan_in ** -0.5)
        nn.init.zeros_(self.bias)


def _linear(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class ConvBlock(nn.Module):
    """The parameters of one SinDDM conv block, [B,H,W,dim] -> [B,H,W,dim_out];
    :meth:`block_args` gives the call of :func:`conv_block` that computes it."""

    def __init__(self, dim: int, dim_out: int, *, device=None):
        super().__init__()
        kw = dict(device=device)
        self.ds_conv = Conv(5, 5, 1, dim, **kw)  # depthwise: one 5x5 filter per channel
        self.cond_mlp = nn.Linear(TIME_DIM, TIME_DIM, **kw)
        self.cond_proj = nn.Linear(TIME_DIM, dim, **kw)
        self.net_conv1 = Conv(3, 3, dim, dim_out, **kw)
        self.net_conv2 = Conv(3, 3, dim_out, dim_out, **kw)
        self.res_conv = Conv(1, 1, dim, dim_out, **kw) if dim != dim_out else None

    def block_args(self, x: torch.Tensor, cond: torch.Tensor) -> tuple:
        """The arguments of :func:`conv_block` for input ``x`` and the
        network's condition vector ``cond``."""
        dt = x.dtype
        c = _linear(self.cond_mlp, gelu(cond), dt)
        c = _linear(self.cond_proj, c, dt)
        dim, dim_out = self.net_conv1.weight.shape[2:]
        res = self.res_conv
        return (
            x, c,
            self.ds_conv.weight.reshape(5, 5, dim), self.ds_conv.bias,
            self.net_conv1.weight, self.net_conv1.bias,
            self.net_conv2.weight, self.net_conv2.bias,
            None if res is None else res.weight.reshape(dim, dim_out),
            None if res is None else res.bias,
        )


class SinDDMNet(nn.Module):
    """(t, s)-conditioned fully-convolutional denoiser.

    forward(x [B,H,W,C], t [B], s scalar or [B]) -> eps_pred [B,H,W,C].
    """

    def __init__(
        self,
        dim: int = 160,
        out_dim: Optional[int] = None,
        channels: int = 3,
        compute_dtype: torch.dtype = torch.float32,
        *,
        device="cuda",
    ):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        kw = dict(device=device)
        half_dim = int(dim / 2)
        self.time_mlp1 = nn.Linear(2 * TIME_DIM, TIME_DIM * 4, **kw)
        self.time_mlp2 = nn.Linear(TIME_DIM * 4, TIME_DIM, **kw)
        self.l1 = ConvBlock(channels, half_dim, **kw)
        self.l2 = ConvBlock(half_dim, dim, **kw)
        self.l3 = ConvBlock(dim, dim, **kw)
        self.l4 = ConvBlock(dim, half_dim, **kw)
        self.final_conv = Conv(1, 1, half_dim, out_dim if out_dim is not None else channels, **kw)

    def forward(self, x: torch.Tensor, time: torch.Tensor, scale: Union[float, torch.Tensor],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.run(x, time, scale, conv_block, mask)

    def run(self, x, time, scale, block_fn, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The forward pass with every conv block computed by ``block_fn``
        (:func:`conv_block`, its plain version to compare against, or
        :func:`~sinddm_tpu_torch.ops.conv_block.conv_block_train` to train),
        in the valid-mask mode when ``mask`` is given."""
        with span("sinddm.denoiser", B=x.shape[0], H=x.shape[1], W=x.shape[2]):
            in_dtype = x.dtype
            dt = self.compute_dtype
            cond = compute_cond_vec(self, time, scale)
            h = x.to(dt).contiguous()
            kw = {}
            if mask is not None:
                mask = mask.to(dt)
                kw["mask"] = (mask[..., None] if mask.ndim == 3 else mask).contiguous()
            for block in (self.l1, self.l2, self.l3, self.l4):
                h = block_fn(*block.block_args(h, cond), **kw)
            fc = self.final_conv
            if mask is not None:
                h = h * kw["mask"]
            out = h @ fc.weight.reshape(fc.weight.shape[2:]).to(dt) + fc.bias.to(dt)
            if mask is not None:
                out = out * kw["mask"]
            return out.to(in_dtype)


def compute_cond_vec(
    model: SinDDMNet, time: torch.Tensor, scale: Union[float, torch.Tensor]
) -> torch.Tensor:
    """The (t, s) conditioning MLP of ``model`` -> [B, 32] in its compute type."""
    dt = model.compute_dtype
    t_emb = sinusoidal_pos_emb(time, TIME_DIM)
    if isinstance(scale, torch.Tensor):
        s_vec = scale.to(device=t_emb.device, dtype=torch.float32).expand(t_emb.shape[0])
    else:  # a fill, not a host-to-device copy (which syncs)
        s_vec = torch.full((t_emb.shape[0],), float(scale), device=t_emb.device)
    s_emb = sinusoidal_pos_emb(s_vec, TIME_DIM)
    ts = torch.cat([t_emb, s_emb], dim=-1)
    cond = gelu(_linear(model.time_mlp1, ts, dt))
    return _linear(model.time_mlp2, cond, dt)
