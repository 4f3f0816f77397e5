"""Closed-form FLOP counts and utilization against the H100's peaks (port of
``sinddm_tpu/utils/flops.py``).

Counts algebraic multiply-add FLOPs (2 a MAC) of the hot computations, so
that a time can be read as a rate and a share of the card's peak.
Elementwise, softmax and layer-norm work is left out (the MFU convention),
as are the per-batch condition MLPs (~1e-5 of the conv work). The counts
are the JAX package's, unchanged.

Peaks (:data:`PEAKS`), dense, from NVIDIA's data sheets, for the two forms
of the H100: the SXM card ("NVIDIA H100 80GB HBM3", power limit 700 W):
989 TFLOP/s bf16 and 495 TF32 on the tensor cores, 67 fp32 on the SIMT
cores, 3.35 TB/s of device memory; the PCIe card: 756, 378, 51 and 2.0
TB/s. :func:`peaks_for` picks one from the card's name. A card held below
its maximum power limit runs slower under load than these peaks assume.
The fp32 path of the conv block (kernel 1) runs 3xTF32, three TF32
products a product, so its ceiling is the TF32 rate / 3 (165 TFLOP/s on
the SXM card): ``mfu_vs_fp32_eff_peak`` is against that rate, as the JAX
package's was against the MXU's bf16 / 3.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# FLOP/s of fp32 on the SIMT cores, TF32 and bf16 on the tensor cores; B/s of device memory
PEAKS = {
    "SXM": dict(fp32=67e12, tf32=495e12, bf16=989e12, mem=3.35e12),
    "PCIe": dict(fp32=51e12, tf32=378e12, bf16=756e12, mem=2.0e12),
}


def peaks_for(card_name: str) -> dict:
    """The peaks of the H100 that ``card_name`` (``torch.cuda.get_device_name``) names."""
    return PEAKS["PCIe" if "PCIe" in card_name else "SXM"]


def block_flops_per_pixel(c_in: int, c_out: int) -> float:
    """Forward FLOPs an output pixel of one conv block: a 5x5 depthwise, two
    3x3 convs and, where the widths differ, a 1x1 residual."""
    f = 2 * 25 * c_in  # 5x5 depthwise
    f += 2 * 9 * c_in * c_out  # net_conv1
    f += 2 * 9 * c_out * c_out  # net_conv2
    if c_in != c_out:
        f += 2 * c_in * c_out  # res_conv 1x1
    return float(f)


def denoiser_flops_per_pixel(dim: int, channels: int = 3) -> float:
    """Forward FLOPs an output pixel of SinDDMNet: four conv blocks (C ->
    D/2 -> D -> D -> D/2) and the final 1x1."""
    half = dim // 2
    widths = ((channels, half), (half, dim), (dim, dim), (dim, half))
    return float(sum(block_flops_per_pixel(c, co) for c, co in widths) + 2 * half * channels)


def sample_pyramid_flops(sizes_hw: Sequence[Tuple[int, int]], t_list: Sequence[int], batch: int, dim: int,
                         timesteps: int = 100) -> float:
    """Forward FLOPs of one pyramid walk: scale 0 runs ``timesteps`` steps,
    via scale s ``t_list[s-1]``, one denoiser call a step."""
    per_px = denoiser_flops_per_pixel(dim)
    total = timesteps * batch * sizes_hw[0][0] * sizes_hw[0][1] * per_px
    for s in range(1, len(sizes_hw)):
        h, w = sizes_hw[s]
        total += int(t_list[s - 1]) * batch * h * w * per_px
    return float(total)


def train_step_flops(sizes_hw: Sequence[Tuple[int, int]], batch: int, dim: int) -> float:
    """Mean FLOPs of a train step over the uniform scale draw (forward and
    backward ~ 3x the forward)."""
    per_px = denoiser_flops_per_pixel(dim)
    mean_px = sum(h * w for h, w in sizes_hw) / len(sizes_hw)
    return float(3 * batch * mean_px * per_px)


def vit_b32_flops(image_hw: Tuple[int, int] = (224, 224)) -> float:
    """Forward FLOPs of one CLIP ViT-B/32 image: width 768, 12 layers, patch
    32, n = 1 + HW / 32^2 tokens; a layer's projections 8 n d^2, attention
    4 n^2 d, MLP 16 n d^2; plus the patch embedding."""
    d, layers, patch = 768, 12, 32
    n = 1 + (image_hw[0] // patch) * (image_hw[1] // patch)
    per_layer = 2 * n * d * d * (4 + 8) + 4 * n * n * d
    embed = 2 * (n - 1) * 3 * patch * patch * d
    return float(layers * per_layer + embed)


def warp_mm_flops(n_out: int, src_hw: Tuple[int, int], channels: int = 3) -> float:
    """One matrix-product warp forward (``ops/warp.py`` ``bilinear_sample_mm``):
    2 N H W + 2 N W a channel; the adjoint costs the same again."""
    h, w = src_hw
    return float(channels * (2 * n_out * h * w + 2 * n_out * w))


def mfu_fields(total_flops: float, seconds: float, peaks: dict = PEAKS["SXM"]) -> dict:
    """The utilization of a measured (FLOPs, seconds): the JAX package's keys,
    against ``peaks``' bf16 rate and its 3xTF32 fp32 ceiling (TF32 / 3)."""
    tps = total_flops / max(seconds, 1e-12)
    return {
        "model_tflops": round(total_flops / 1e12, 2),
        "tflops_per_s": round(tps / 1e12, 2),
        "mfu_vs_bf16_peak": round(tps / peaks["bf16"], 4),
        "mfu_vs_fp32_eff_peak": round(tps / (peaks["tf32"] / 3.0), 4),
    }
