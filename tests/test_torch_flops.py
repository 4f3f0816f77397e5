"""The port's FLOP counts == the JAX package's, exactly; ``mfu_fields`` has
the JAX package's keys, against the peaks of the H100 the card's name picks
(SXM: bf16 989 TFLOP/s dense, the fp32 path's 3xTF32 ceiling 495 / 3)."""

import pytest

from sinddm_tpu.utils import flops as jf
from sinddm_tpu_torch.utils import flops as tf

BALLOONS = [(48, 64), (67, 90), (94, 126), (133, 177), (186, 248)]


@pytest.mark.parametrize("dim,channels", [(160, 3), (64, 3), (16, 1), (161, 4)])
def test_denoiser_flops_per_pixel_match_jax(dim, channels):
    assert tf.denoiser_flops_per_pixel(dim, channels) == jf.denoiser_flops_per_pixel(dim, channels)


@pytest.mark.parametrize("sizes,t_list,batch,dim,timesteps", [
    (BALLOONS, [52, 41, 31, 22], 16, 160, 100), (BALLOONS[:3], [5, 7], 1, 16, 10), ([(12, 16)], [], 2, 8, 4)])
def test_pyramid_and_train_flops_match_jax(sizes, t_list, batch, dim, timesteps):
    assert tf.sample_pyramid_flops(sizes, t_list, batch, dim, timesteps) == jf.sample_pyramid_flops(
        sizes, t_list, batch, dim, timesteps)
    assert tf.train_step_flops(sizes, batch, dim) == jf.train_step_flops(sizes, batch, dim)


@pytest.mark.parametrize("hw", [(224, 224), (224, 298), (298, 224), (31, 64)])
def test_vit_and_warp_flops_match_jax(hw):
    assert tf.vit_b32_flops(hw) == jf.vit_b32_flops(hw)
    assert tf.warp_mm_flops(8 * hw[0] * hw[1], (186, 248)) == jf.warp_mm_flops(8 * hw[0] * hw[1], (186, 248))
    assert tf.warp_mm_flops(100, hw, 1) == jf.warp_mm_flops(100, hw, 1)


@pytest.mark.parametrize("card,peaks", [("NVIDIA H100 80GB HBM3", (67e12, 495e12, 989e12, 3.35e12)),
                                         ("NVIDIA H100 PCIe", (51e12, 378e12, 756e12, 2.0e12))])
def test_mfu_fields_against_the_h100(card, peaks):
    chosen = tf.peaks_for(card)
    assert (chosen["fp32"], chosen["tf32"], chosen["bf16"], chosen["mem"]) == peaks
    ours, theirs = tf.mfu_fields(98.08e12, 2.114, chosen), jf.mfu_fields(98.08e12, 2.114)
    assert ours.keys() == theirs.keys()
    assert ours["model_tflops"] == theirs["model_tflops"] == 98.08
    assert ours["tflops_per_s"] == theirs["tflops_per_s"] == round(98.08 / 2.114, 2)
    assert ours["mfu_vs_bf16_peak"] == round(98.08e12 / 2.114 / peaks[2], 4)
    assert ours["mfu_vs_fp32_eff_peak"] == round(98.08e12 / 2.114 / (peaks[1] / 3), 4)
    assert tf.mfu_fields(98.08e12, 2.114) == tf.mfu_fields(98.08e12, 2.114, tf.PEAKS["SXM"])
