"""The frozen arithmetic of ``yardstick/work.py`` against hand counts."""

import pytest

from portbench.yardstick import work

BLOCKS = [[3, 80], [80, 160], [160, 160], [160, 80]]
SIZES = [(48, 64), (67, 90), (94, 126), (133, 177), (186, 248)]


def test_a_walk_is_98_08_tflop():
    # per pixel: l1 2*25*3 + 2*9*3*80 + 2*9*80*80 + 2*3*80, l2 ..., final 2*80*3
    per_px = ((150 + 4320 + 115200 + 480) + (4000 + 230400 + 460800 + 25600) + (8000 + 460800 + 460800)
              + (8000 + 230400 + 115200 + 25600) + 480)
    assert work.denoiser_flops_per_pixel(BLOCKS) == per_px
    px_calls = 100 * 48 * 64 + 52 * 67 * 90 + 41 * 94 * 126 + 31 * 133 * 177 + 22 * 186 * 248
    assert work.sample_pyramid_flops(SIZES, (52, 41, 31, 22), 16, BLOCKS) == 16 * px_calls * per_px
    assert work.sample_pyramid_flops(SIZES, (52, 41, 31, 22), 16, BLOCKS) / 1e12 == pytest.approx(98.08, abs=0.005)


def test_a_mean_train_step_is_3_74_tflop():
    assert work.train_step_flops(SIZES, 32, BLOCKS) / 1e12 == pytest.approx(3.74, abs=0.005)


def test_the_warp_launch_moves_179_7_and_188_6_mb():
    n = 8 * 224 * 298  # 8 views of 224x298 an image
    fwd, adj = work.warp_work(16, n, 186, 248, 3, False)[1], work.warp_work(16, n, 186, 248, 3, True)[1]
    assert fwd == 16 * n * 20 + 4 * 16 * 186 * 248 * 3
    assert (fwd / 1e6, adj / 1e6) == (pytest.approx(179.7, abs=0.05), pytest.approx(188.6, abs=0.05))


def test_the_conv_stages_and_the_depthwise_add_up_to_the_block():
    for c, co in BLOCKS:
        f1, _ = work.conv3x3_stage_work(2, 5, 7, c, co, 4)
        f2, _ = work.dw_work(2, 5, 7, c, 4)
        assert f1 + f2 == work.block_work(2, 5, 7, c, co, 4)[0]


def test_peaks_and_roofline():
    sxm = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert sxm["bf16"] == 989e12 and sxm["mem"] == 3.35e12
    assert work.peaks_for("NVIDIA H100 PCIe")["bf16"] == 756e12
    share, bound = work.roofline_share(989e12, 1.0, 2.0, sxm)
    assert (share, bound) == (0.5, "operations")
    assert work.roofline_share(1.0, 3.35e12, 4.0, sxm) == (0.25, "bytes")
