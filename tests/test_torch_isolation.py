"""The port stands alone and defaults to the card.

* No file of ``sinddm_tpu_torch/`` nor ``chip_smoke.py`` imports JAX,
  flax, optax, orbax or the JAX package.
* Every entry point runs on ``cuda`` unless given ``device="cpu"``: on
  this CUDA-less build each raises instead of running on the CPU.
* ``chip_smoke.py`` fails, printing no result, where there is no card.
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
from sinddm_tpu_torch.apps.sampling import sample_scales
from sinddm_tpu_torch.diffusion.core import sample_scale0
from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.schedules import make_schedules

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sinddm_tpu"}
SOURCES = sorted((ROOT / "sinddm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    assert {"chip_smoke.py", "sinddm_tpu_torch/ops/conv_block.py", "sinddm_tpu_torch/cli.py",
            "sinddm_tpu_torch/apps/sampling.py"} <= names


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
}


def _cli_without_device(tmp_path):
    img = np.random.default_rng(0).uniform(0, 255, (96, 128, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    cli.main(["--mode", "sample", "--dataset_folder", str(tmp_path), "--image_name", "img.png",
              "--results_folder", str(tmp_path), "--dim", "16", "--timesteps", "4"])


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS) + ["cli"])
def test_entry_points_default_to_cuda(name, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises((RuntimeError, AssertionError)) as info:
        _cli_without_device(tmp_path) if name == "cli" else ENTRY_POINTS[name]()
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
