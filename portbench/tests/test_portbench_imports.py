"""What the benchmark loads, and what it does without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "sinddm_tpu")

CHECK = """
import sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from portbench import harness, calibrate
from portbench.yardstick import trace, work
for name in ("sample-b16-fp32", "train-b32-graph"):
    f = harness.cell_files(harness.Path({root!r}), name)
    harness.load_module(f.driver_path, "d_" + name)
    for path in f.readers.values():
        harness.load_module(path, "m_" + path.stem.replace(".", "_"))
from portbench_tiny import run_tiny
for name in ("sample-b16-fp32", "train-b32-graph"):
    assert run_tiny(name)["correct"]
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(top))
"""


def test_no_jax_and_no_jax_package_after_the_harness_runs():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", CHECK.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"))],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(res.stdout.split())
    assert "sinddm_tpu_torch" in top and "portbench" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "sinddm_tpu_torch_x", sys.modules["os"])
    assert "sinddm_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["os"])
    assert "jax.numpy" in harness.forbidden_modules()


# run.py past its look for a card, each cell's run on the CPU at the tiny
# size, with a driver whose check loads a module named as JAX is
LOADS_LATE = """
import runpy, sys, torch
sys.path[:0] = [{root!r}, {tests!r}, {stubs!r}]
torch.set_num_threads(1)
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
from portbench import harness
from portbench_tiny import tiny_files
real = harness.run_cell

def on_the_cpu(root, workload, **kw):
    files = tiny_files(workload)
    files.driver_path = harness.Path({driver!r})
    return real(root, workload, **dict(kw, device="cpu", files=files))
harness.run_cell = on_the_cpu
sys.argv = ["run.py", "--workload", "sample-b16-fp32", "--seed", "2147483999", "--seconds", "0.5", "--trace", "0"]
runpy.run_path({run!r}, run_name="__main__")
"""
LATE_DRIVER = """
from portbench.harness import HERE, load_module
base = load_module(HERE / "drivers" / "sample_walks.py", "portbench_driver_base")


class Driver(base.Driver):
    def check(self):
        {load}
        return super().check()
"""


@pytest.mark.parametrize("load", ["import jax", "pass"])
def test_jax_loaded_by_the_check_stops_the_run_with_no_result(load, tmp_path):
    (tmp_path / "stubs" / "jax").mkdir(parents=True)
    (tmp_path / "stubs" / "jax" / "__init__.py").write_text("")
    driver = tmp_path / "late_driver.py"
    driver.write_text(LATE_DRIVER.format(load=load))
    script = LOADS_LATE.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"), stubs=str(tmp_path / "stubs"),
                               driver=str(driver), run=str(ROOT / "portbench" / "run.py"))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    lines = res.stdout.strip().splitlines()
    if load == "pass":  # the same run without the import prints its result
        assert res.returncode == 0 and json.loads(lines[-1])["correct"] is True, res.stderr[-3000:]
    else:
        assert res.returncode != 0 and not any(line.startswith("{") for line in lines)
        assert "'jax'" in res.stderr and "after the check" in res.stderr


def run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "sample-b16-fp32", "--seed",
                           str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, env=env, timeout=300)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    res = run(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_with_only_the_benchmark_files_it_exits_non_zero_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
