"""On the card (skips without one): the control of each cell, and each
planted fault, at the cell's own size, breaks at least one of the cell's
limits (``calibrate.py``).

    python3 -m pytest -p no:cacheprovider portbench/tests/test_portbench_card.py -q
"""

import json
from pathlib import Path

import pytest

from portbench import calibrate

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda
SEED = 2**31 + 1234567


def limits(cell):
    return json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())


def test_the_walk_control_breaks_the_limit(cuda, tmp_path):
    out = tmp_path / "cal.jsonl"
    assert calibrate.main(["--workload", "sample-b16-fp32", "--seeds", str(SEED), "--out", str(out)]) == 0
    row = json.loads(out.read_text().splitlines()[0])
    limit = limits("sample-b16-fp32")["walk_mean_gap"]
    assert row["control_tf32"]["mean"] > limit
    assert all(row[k]["mean"] > limit for k in ("fault_unchanged", "fault_altered", "fault_half_batch"))


def test_the_train_control_breaks_a_limit(cuda, tmp_path):
    out = tmp_path / "cal.jsonl"
    assert calibrate.main(["--workload", "train-b32-graph", "--seeds", str(SEED), "--out", str(out)]) == 0
    row = json.loads(out.read_text().splitlines()[0])
    lim = limits("train-b32-graph")
    assert any(row["control_tf32"][k] > v for k, v in lim.items())
    assert any(row["fault_half_batch"][k] > v for k, v in lim.items())
    assert all(v > lim[k] for k, v in row["fault_unchanged"].items())
