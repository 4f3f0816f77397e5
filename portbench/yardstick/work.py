"""The work the program must do, counted from shapes, and the card's peaks.

A frozen copy of the arithmetic the repository had when the benchmark was
written (``sinddm_tpu_torch/utils/flops.py``, ``chip_smoke.py``
``block_work`` / ``warp_work``), so that a later change to the program
cannot move the yardstick. FLOPs are algebraic multiply-adds (2 a MAC);
elementwise work, softmax, norms and the condition MLPs are left out.
Bytes count every input read once and every output written once.

Peaks (NVIDIA's data sheets, dense, at the card's full power limit): the
SXM H100 ("NVIDIA H100 80GB HBM3", 700 W) 989 TFLOP/s bf16 and 495 TF32 on
the tensor cores, 67 fp32 on the SIMT cores, 3.35 TB/s; the PCIe card 756,
378, 51 and 2.0 TB/s.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAKS = {
    "SXM": dict(fp32=67e12, tf32=495e12, bf16=989e12, mem=3.35e12),
    "PCIe": dict(fp32=51e12, tf32=378e12, bf16=756e12, mem=2.0e12),
}


def peaks_for(card_name: str) -> dict:
    """The peaks of the H100 that ``card_name`` (``torch.cuda.get_device_name``) names."""
    return PEAKS["PCIe" if "PCIe" in card_name else "SXM"]


def block_flops_per_pixel(c_in: int, c_out: int) -> float:
    """Forward FLOPs an output pixel of one conv block: the 5x5 depthwise,
    two 3x3 convs and, where the widths differ, the 1x1 residual."""
    f = 2 * 25 * c_in + 2 * 9 * c_in * c_out + 2 * 9 * c_out * c_out
    if c_in != c_out:
        f += 2 * c_in * c_out
    return float(f)


def denoiser_flops_per_pixel(blocks: Sequence[Sequence[int]], channels: int = 3) -> float:
    """Forward FLOPs an output pixel of the denoiser: its blocks and the final 1x1."""
    return float(sum(block_flops_per_pixel(c, co) for c, co in blocks) + 2 * blocks[-1][1] * channels)


def sample_pyramid_flops(sizes_hw: Sequence[Tuple[int, int]], t_list: Sequence[int], batch: int,
                         blocks, timesteps: int = 100) -> float:
    """Forward FLOPs of one pyramid walk: ``timesteps`` denoiser calls at
    scale 0, ``t_list[s - 1]`` at scale s."""
    per_px = denoiser_flops_per_pixel(blocks)
    total = timesteps * batch * sizes_hw[0][0] * sizes_hw[0][1] * per_px
    for s in range(1, len(sizes_hw)):
        h, w = sizes_hw[s]
        total += int(t_list[s - 1]) * batch * h * w * per_px
    return float(total)


def train_step_flops(sizes_hw: Sequence[Tuple[int, int]], batch: int, blocks) -> float:
    """Mean FLOPs of a train step over a uniform scale draw: 3x the forward."""
    mean_px = sum(h * w for h, w in sizes_hw) / len(sizes_hw)
    return float(3 * batch * mean_px * denoiser_flops_per_pixel(blocks))


def block_work(b: int, h: int, w: int, c: int, co: int, itemsize: int) -> Tuple[float, float]:
    """FLOPs and bytes one whole conv block must do (input read once, output
    written once, its parameters and condition read once)."""
    px = b * h * w
    params = 26 * c + 9 * c * co + co + 9 * co * co + co + ((c + 1) * co if c != co else 0)
    return px * block_flops_per_pixel(c, co), float(itemsize * (px * (c + co) + b * c + params))


def conv3x3_stage_work(b: int, h: int, w: int, c: int, co: int, itemsize: int) -> Tuple[float, float]:
    """FLOPs and bytes of kernel 1's two launches for one block: stage 1
    reads the depthwise output (C) and writes GELU(conv1) (Co); stage 2
    reads that and the block's input (the residual), writes the block's
    output; each reads its weights and biases once."""
    px = b * h * w
    proj = c != co
    flops = px * (2 * 9 * c * co + 2 * 9 * co * co + (2 * c * co if proj else 0))
    stage1 = px * (c + co) + 9 * c * co + co
    stage2 = px * (co + c + co) + 9 * co * co + co + ((c + 1) * co if proj else 0)
    return float(flops), float(itemsize * (stage1 + stage2))


def dw_work(b: int, h: int, w: int, c: int, itemsize: int) -> Tuple[float, float]:
    """FLOPs and bytes of one launch of kernel 2 (the 5x5 depthwise with its
    bias and the block's condition): the input read and the output written
    once, the 25 taps, the bias and the [B, C] condition."""
    px = b * h * w
    return float(2 * 25 * c * px), float(itemsize * (2 * px * c + 26 * c + b * c))


def vit_b32_flops(image_hw: Tuple[int, int] = (224, 224)) -> float:
    """Forward FLOPs of one CLIP ViT-B/32 image: width 768, 12 layers, patch
    32, n = 1 + HW / 32^2 tokens; a layer's projections and MLP 24 n d^2,
    attention 4 n^2 d; plus the patch embedding."""
    d, layers, patch = 768, 12, 32
    n = 1 + (image_hw[0] // patch) * (image_hw[1] // patch)
    per_layer = 2 * n * d * d * (4 + 8) + 4 * n * n * d
    return float(layers * per_layer + 2 * (n - 1) * 3 * patch * patch * d)


def warp_work(b: int, n: int, h: int, w: int, c: int, adjoint: bool, split3: bool = False) -> Tuple[float, float]:
    """FLOPs and bytes of one view-warp launch: coords read, the source read
    (forward) or the cotangent read and the image gradient zeroed and
    written (adjoint), the samples written (forward)."""
    img_bytes = 4 * b * h * w * c
    nbytes = b * n * (8 + 4 * c) + (2 * img_bytes if adjoint else img_bytes)
    per_c = (22 if adjoint else 25) if split3 else 8
    return float(b * n * (12 + per_c * c)), float(nbytes)


def roofline_share(flops: float, nbytes: float, seconds: float, peaks: dict, rate: str = "bf16") -> Tuple[float, str]:
    """The least time the card could take (the larger of FLOPs over the
    ``rate`` peak and bytes over the memory peak) over ``seconds``, and which
    of the two bounds it."""
    t_ops, t_mem = flops / peaks[rate], nbytes / peaks["mem"]
    return max(t_ops, t_mem) / seconds, ("operations" if t_ops >= t_mem else "bytes")
