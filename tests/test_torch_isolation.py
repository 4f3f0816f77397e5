"""The port stands alone and defaults to the card.

* No file of ``sinddm_tpu_torch/``, nor ``chip_smoke.py``,
  ``guided_check_spread.py``, ``kernel_times.py`` or the gloo worker of the
  mesh tests (``tests/torch_dist_worker.py``), imports JAX, flax, optax,
  orbax, the third-party ``regex`` or the JAX package.
* Every entry point runs on ``cuda`` unless given ``device="cpu"``: on
  this CUDA-less build each raises instead of running on the CPU (the
  bucketed walk, its via-scale sampler, the metric extractors and joining
  a world of ranks among them).
* ``chip_smoke.py``, ``guided_check_spread.py`` and ``kernel_times.py``
  fail, printing no result, where there is no card.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sinddm_tpu_torch import cli
from sinddm_tpu_torch.apps.clip_apps import clip_sampling
from sinddm_tpu_torch.apps.i2i import image2image
from sinddm_tpu_torch.apps.roi import roi_guided_sampling
from sinddm_tpu_torch.apps.sampling import sample_scales
from sinddm_tpu_torch.diffusion.bucketed import sample_via_scale_bucketed
from sinddm_tpu_torch.diffusion.core import sample_scale0
from sinddm_tpu_torch.guidance.roi import make_roi_guidance
from sinddm_tpu_torch.guidance.clip_guidance import init_clip_carry
from sinddm_tpu_torch.metrics import conv_feature_extractor
from sinddm_tpu_torch.models.inception import STEM_SPEC, inception_params_from_state_dict, random_inception_params
from sinddm_tpu_torch.models.clip.convert import clip_from_state_dict, random_clip_params, random_clip_state_dict
from sinddm_tpu_torch.models.clip.model import tiny_clip_config
from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.parallel import distributed
from sinddm_tpu_torch.schedules import make_schedules
from sinddm_tpu_torch.utils.profiling import trace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "regex", "sinddm_tpu"}
SOURCES = sorted((ROOT / "sinddm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "guided_check_spread.py", ROOT / "kernel_times.py",
    ROOT / "tests" / "torch_dist_worker.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_scan_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"chip_smoke.py", "guided_check_spread.py", "kernel_times.py", "sinddm_tpu_torch/ops/conv_block.py", "sinddm_tpu_torch/cli.py",
            "sinddm_tpu_torch/apps/sampling.py", "sinddm_tpu_torch/ops/warp.py",
            "sinddm_tpu_torch/ops/warp_sample.py", "sinddm_tpu_torch/models/clip/model.py",
            "sinddm_tpu_torch/models/clip/tokenizer.py", "sinddm_tpu_torch/models/clip/convert.py",
            "sinddm_tpu_torch/guidance/clip_extractor.py", "sinddm_tpu_torch/guidance/clip_guidance.py",
            "sinddm_tpu_torch/apps/clip_apps.py", "sinddm_tpu_torch/ops/image.py", "sinddm_tpu_torch/apps/i2i.py",
            "sinddm_tpu_torch/guidance/roi.py", "sinddm_tpu_torch/apps/roi.py",
            "sinddm_tpu_torch/utils/profiling.py", "sinddm_tpu_torch/diffusion/bucketed.py",
            "sinddm_tpu_torch/metrics.py", "sinddm_tpu_torch/models/inception.py", "sinddm_tpu_torch/utils/flops.py",
            "sinddm_tpu_torch/ops/augment_extra.py", "sinddm_tpu_torch/parallel/mesh.py",
            "sinddm_tpu_torch/parallel/distributed.py", "tests/torch_dist_worker.py"} <= names


def test_tokenizer_reads_its_own_table_with_the_standard_library():
    from sinddm_tpu_torch.models.clip import tokenizer

    roots = set(_imported_roots(Path(tokenizer.__file__)))
    assert "regex" not in roots and "re" in roots
    table = Path(tokenizer.DEFAULT_BPE_PATH)
    assert table.is_file() and ROOT / "sinddm_tpu_torch" in table.parents


_CPU_SCHED = dict(timesteps=4, scale_losses=[0.5], n_scales=2)

ENTRY_POINTS = {
    "make_schedules": lambda: make_schedules(**_CPU_SCHED),
    "SinDDMNet": lambda: SinDDMNet(dim=16),
    "denoiser_from_flax": lambda: denoiser_from_flax(random_flax_params(dim=16)),
    "sample_scale0": lambda: sample_scale0(
        lambda x, t, s: x, make_schedules(device="cpu", **_CPU_SCHED), (1, 8, 8, 3)),
    "sample_scales": lambda: sample_scales(
        lambda x, t, s: x, make_schedules(device="cpu", **_CPU_SCHED), [(8, 8), (11, 11)],
        scale_factor=1.411, n_scales=2, batch_size=1),
    "init_clip_carry": lambda: init_clip_carry(1, (8, 8)),
    "random_clip_params": lambda: random_clip_params(tiny_clip_config()),
    "clip_from_state_dict": lambda: clip_from_state_dict(random_clip_state_dict(tiny_clip_config()), tiny_clip_config()),
    "clip_sampling": lambda: _clip_sampling_without_device(),
    "clip_sampling_bucketed": lambda: _clip_sampling_without_device(bucketed=True),
    "sample_via_scale_bucketed": lambda: sample_via_scale_bucketed(
        lambda x, t, s: x, make_schedules(device="cpu", **_CPU_SCHED), torch.zeros((1, 11, 11, 3)),
        prev_valid_hw=(8, 8), cur_valid_hw=(11, 11), s=1, total_t=2),
    "conv_feature_extractor": lambda: conv_feature_extractor(),
    "random_inception_params": lambda: random_inception_params(),
    "inception_params_from_state_dict": lambda: inception_params_from_state_dict({
        f"{name}.{k}": np.zeros((co, 1, 1, 1) if k == "conv.weight" else (co,), np.float32)
        for name, _, _, _, co in STEM_SPEC
        for k in ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")}),
    "image2image": lambda: image2image(lambda x, t, s: x, make_schedules(device="cpu", **_CPU_SCHED), _cpu_pyramid(),
                                       np.zeros((8, 8, 3), np.float32), mode="style_transfer", batch_size=1),
    "roi_guided_sampling": lambda: roi_guided_sampling(
        lambda x, t, s: x, make_schedules(device="cpu", **_CPU_SCHED), _cpu_pyramid(), target_roi=[0, 0, 4, 4],
        roi_bb_list=[[2, 2, 4, 4]], batch_size=1),
    "make_roi_guidance": lambda: make_roi_guidance(_cpu_pyramid().images, [0, 0, 4, 4], [[2, 2, 4, 4]],
                                                   scale_factor=1.411, n_scales=2, s=0),
    "profiling.trace": lambda: trace("unused").__enter__(),
    # a world asked for on the card needs a card: it never falls back to the CPU
    "distributed.initialize": lambda: distributed.initialize("127.0.0.1:1", 2, 0),
}


def _cpu_pyramid():
    from sinddm_tpu_torch.pyramid import Pyramid

    sizes = ((8, 8), (11, 11))
    imgs = tuple(np.zeros(s + (3,), np.float32) for s in sizes)
    return Pyramid(sizes_hw=sizes, sizes_wh=sizes, images=imgs, recon_images=imgs,
                   rescale_losses=(0.5,), scale_factor=1.411, n_scales=2)


def _clip_sampling_without_device(bucketed=False):
    """A CPU tower, schedules and pyramid, but no ``device``: the walk itself
    must reach for the card."""
    from sinddm_tpu_torch.guidance.clip_extractor import ClipExtractor

    ex = ClipExtractor(random_clip_params(tiny_clip_config(), device="cpu"), n_aug=1)
    return clip_sampling(lambda x, t, s: x, make_schedules(device="cpu", **_CPU_SCHED), _cpu_pyramid(), ex,
                         text_input="x", strength=0.3, sample_batch_size=1, guidance_sub_iters=[0, 1],
                         bucketed=bucketed)


def _cli_without_device(tmp_path, mode="sample"):
    img = np.random.default_rng(0).uniform(0, 255, (96, 128, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    cli.main(["--mode", mode, "--dataset_folder", str(tmp_path), "--image_name", "img.png",
              "--results_folder", str(tmp_path), "--dim", "16", "--timesteps", "4"])


CLI_MODES = {"cli": "sample", "cli_clip_style_gen": "clip_style_gen"}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS) + sorted(CLI_MODES))
def test_entry_points_default_to_cuda(name, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises((RuntimeError, AssertionError)) as info:
        if name in CLI_MODES:
            _cli_without_device(tmp_path, CLI_MODES[name])
        else:
            ENTRY_POINTS[name]()
    assert "CUDA" in str(info.value) or "cuda" in str(info.value)


def test_chip_smoke_fails_alone_without_a_card(tmp_path):
    """The script alone in an empty directory, on this CUDA-less build: it
    must exit non-zero and print no result (the CUDA check comes first,
    the checkout check right after it)."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_guided_check_spread_fails_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "guided_check_spread.py"), "--inputs", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "[spread]" not in proc.stdout and "needs a CUDA card" in proc.stderr


def test_kernel_times_fails_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "kernel_times.py")], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"dw_conv"' not in proc.stdout and "needs a CUDA card" in proc.stderr
