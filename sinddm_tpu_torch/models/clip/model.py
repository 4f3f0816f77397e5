"""CLIP (ViT + text transformer) with an interpolatable position embedding
(port of ``sinddm_tpu/models/clip/model.py``).

OpenAI CLIP ViT-B/32, plus the modification the guidance stack depends on:
the vision position embedding is resized bicubically so the encoder takes
any input resolution. The resized grid is flattened transposed relative to
the patch tokens for non-square inputs, a quirk of the original code that
the JAX package replicates and this port keeps.

Modules and parameters carry the names of OpenAI's state dict
(``visual.conv1.weight``, ``visual.transformer.resblocks.0.attn.in_proj_weight``,
``token_embedding.weight``, ...), so a checkpoint loads strictly. Images
are NHWC ``[B, H, W, 3]``, already CLIP-normalised, as in the JAX package.
By default everything runs in fp32: the patch embedding is a matrix product
over unfolded patches (no cuDNN convolution, hence no TF32), attention is
plain matmul / softmax, as the JAX package leaves it to XLA.
``CLIPConfig(compute_dtype="bfloat16")`` runs the vision tower's matrix
products (patch embedding, projections, attention, MLP) and what lies between
them in bf16, as flax's ``dtype=bfloat16`` layers do; parameters stay fp32,
the LayerNorms and the residual stream run in fp32, and the text tower is
untouched. ``CLIPConfig(attn_impl="skip")`` is the JAX package's
experiment switch: the vision tower's attention returns v in place of
softmax(q k^T / sqrt(d)) v. It is wrong by design, and exists only to
measure what share of the tower's time the attention takes.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # 'bfloat16': the vision tower's matrix products in bf16 with fp32
    # parameters and fp32 LayerNorms; None / 'float32': all fp32
    compute_dtype: Optional[str] = None
    # the vision tower's attention: 'einsum', softmax(q k^T / sqrt(d)) v, or
    # 'skip', v alone -- numerically wrong, for measuring attention's share
    attn_impl: str = "einsum"

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def vision_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


VIT_B_32 = CLIPConfig()

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def tiny_clip_config() -> CLIPConfig:
    """A miniature CLIP for tests (the JAX package's ``tiny_clip_config``)."""
    return CLIPConfig(
        embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
        vision_patch_size=8, context_length=77, vocab_size=49408,
        transformer_width=32, transformer_heads=2, transformer_layers=2,
    )


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A dense layer computed in ``dtype`` (inputs and fp32 parameters cast to
    it), as a flax ``Dense(dtype=...)``; a no-op cast in fp32."""
    return nn.functional.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))


class MultiheadAttention(nn.Module):
    """Fused qkv projection + output projection, ``nn.MultiheadAttention``'s
    parameter names and layout; computed in ``dtype``."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32, attn_impl: str = "einsum"):
        super().__init__()
        if attn_impl not in ("einsum", "skip"):
            raise ValueError(f"attn_impl must be 'einsum' or 'skip', got {attn_impl!r}")
        self.heads = heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, W = x.shape
        hd = W // self.heads
        qkv = _linear(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        if self.attn_impl == "skip":
            out = v
        else:
            attn = q @ k.transpose(-1, -2) / math.sqrt(hd)
            if mask is not None:
                attn = attn + mask
            out = torch.softmax(attn, dim=-1) @ v
        return _linear(out.transpose(1, 2).reshape(B, L, W), self.out_proj.weight, self.out_proj.bias, self.dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block; the LayerNorms run on the fp32 residual stream, the
    attention and MLP in ``dtype``, whose output the residual add widens back."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32, attn_impl: str = "einsum"):
        super().__init__()
        self.dtype = dtype
        self.attn = MultiheadAttention(width, heads, dtype, attn_impl)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, width * 4)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(width * 4, width)),
        ]))
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        fc, proj = self.mlp.c_fc, self.mlp.c_proj
        h = self.mlp.gelu(_linear(self.ln_2(x), fc.weight, fc.bias, self.dtype))
        return x + _linear(h, proj.weight, proj.bias, self.dtype)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "einsum"):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads, dtype, attn_impl)
                                        for _ in range(layers)])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def bicubic_resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize(..., "bicubic")`` along
    one axis: half-pixel centres, Keys kernel (a = -0.5; ``F.interpolate``
    uses -0.75), widened when shrinking (antialias), each column renormalised
    over the taps that exist."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embedding(pos: torch.Tensor, h: int, w: int, patch_size: int) -> torch.Tensor:
    """Resize the [N+1, width] position embedding to an h x w image. The
    side x side grid is resized to (w // ps, h // ps) and flattened in that
    order: transposed relative to the patch tokens when h != w."""
    n = pos.shape[0] - 1
    side = int(math.sqrt(n))
    hp, wp = h // patch_size, w // patch_size
    if hp * wp == n and h == w:
        return pos
    grid = pos[1:].reshape(side, side, -1)
    if wp != side:
        grid = torch.einsum("io,ijc->ojc", bicubic_resize_matrix(side, wp, pos.device).to(grid.dtype), grid)
    if hp != side:
        grid = torch.einsum("jo,ijc->ioc", bicubic_resize_matrix(side, hp, pos.device).to(grid.dtype), grid)
    return torch.cat([pos[:1], grid.reshape(wp * hp, -1)], dim=0)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        width, ps = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = nn.Conv2d(3, width, ps, stride=ps, bias=False)  # holds the weight; see forward
        scale = width ** -0.5
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn((cfg.image_resolution // ps) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, cfg.vision_layers, cfg.vision_heads, cfg.vision_dtype, cfg.attn_impl)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(scale * torch.randn(width, cfg.embed_dim))

    def forward(self, x: torch.Tensor, return_tokens: bool = False) -> torch.Tensor:
        """x [B, H, W, 3] -> [B, embed_dim]; with ``return_tokens`` the
        post-transformer patch tokens [B, Hp*Wp, width] (no CLS, no proj)."""
        B, H, W, _ = x.shape
        ps, width = self.cfg.vision_patch_size, self.cfg.vision_width
        hp, wp = H // ps, W // ps
        # the stride-ps VALID convolution as one matrix product over patches,
        # in the tower's compute type, widened to fp32 after
        dt = self.cfg.vision_dtype
        patches = x[:, : hp * ps, : wp * ps].reshape(B, hp, ps, wp, ps, 3).permute(0, 1, 3, 2, 4, 5)
        kernel = self.conv1.weight.permute(2, 3, 1, 0).reshape(ps * ps * 3, width)
        x = (patches.reshape(B, hp * wp, ps * ps * 3).to(dt) @ kernel.to(dt)).float()
        cls = self.class_embedding.expand(B, 1, width)
        x = torch.cat([cls, x], dim=1)
        x = x + interpolate_pos_embedding(self.positional_embedding, H, W, ps)[None]
        x = self.transformer(self.ln_pre(x))
        if return_tokens:
            return x[:, 1:, :]
        return self.ln_post(x[:, 0, :]) @ self.proj


class CLIPModel(nn.Module):
    """Image and text encoders: :meth:`encode_image`, :meth:`encode_text`."""

    def __init__(self, cfg: CLIPConfig = VIT_B_32):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg)
        self.transformer = Transformer(cfg.transformer_width, cfg.transformer_layers, cfg.transformer_heads)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.transformer_width)
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(cfg.context_length, cfg.transformer_width))
        self.ln_final = nn.LayerNorm(cfg.transformer_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            cfg.transformer_width ** -0.5 * torch.randn(cfg.transformer_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_image_tokens(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images, return_tokens=True)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens)  # [B, L, W]
        L = x.shape[1]
        x = x + self.positional_embedding[None, :L]
        mask = torch.full((L, L), float("-inf"), device=x.device).triu(1)
        x = self.ln_final(self.transformer(x, mask))
        eot = tokens.argmax(dim=-1)  # EOT is the highest id in each row
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        logits = self.logit_scale.exp() * img @ txt.T
        return logits, logits.T


def clip_normalize(x01: torch.Tensor) -> torch.Tensor:
    """Normalise [B, H, W, 3] images in [0, 1] with the CLIP mean / std (the
    constants are device fills: no host-to-device copy on the guided path)."""
    mean = torch.stack([x01.new_full((), m) for m in CLIP_MEAN])
    std = torch.stack([x01.new_full((), v) for v in CLIP_STD])
    return (x01 - mean) / std
