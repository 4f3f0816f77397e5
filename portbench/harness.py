"""The harness: finds a cell's files by name, runs its set-up, the measured
window, the traced unit and the check, and builds the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's sizes (the configuration's ``file``);
* ``traffic/<traffic>.json``: the mix's parameters and the name of its driver;
* ``drivers/<driver>.py``: the code that runs one kind of traffic (a class
  ``Driver``; ``README.md`` lists what it offers);
* ``limits/<cell>.json``: each number the cell's check compares, with its limit;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

Nothing here imports the program; the drivers do.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional, Tuple

from portbench.yardstick import trace as tr, work

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sinddm_tpu")
CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH")


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file at ``path`` under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(config: dict) -> ModuleType:
    """The configuration's plain reference, the file its ``reference``
    names from the checkout's root."""
    path = HERE.parent / config["reference"]
    return load_module(path, "portbench_reference_" + path.stem)


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(root: Path, workload: str, bench: Optional[dict] = None) -> SimpleNamespace:
    """Everything a cell needs, found by name: its entry, its configuration
    (file and entry), its traffic, its limits, its driver's path, its
    end-to-end and per-layer metric entries and their readers' paths."""
    bench = bench if bench is not None else read_json(root / "BENCHMARK.json")
    here = Path(root) / HERE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: one of {sorted(cells)}")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = read_json(here / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return SimpleNamespace(
        cell=cell, config_entry=config_entry, config=read_json(root / config_entry["file"]), traffic=traffic,
        limits=read_json(here / "limits" / f"{workload}.json"),
        driver_path=here / "drivers" / f"{traffic['driver']}.py",
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: here / "metrics" / f"{m['name']}.py" for m in per_layer},
    )


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (``build/``, which git ignores); the program's own kernels build into
    ``build/kernels/`` by themselves."""
    base = root / "build" / "portbench-cache"
    for var in CACHE_VARS:
        path = base / var.lower()
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is, whole, one of :data:`FORBIDDEN`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def refuse_forbidden(when: str) -> None:
    """Stop the run, with no result, where JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: modules of JAX or the JAX package are loaded {when}: {found}")


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each compared number beside its limit; correct when every limit has
    its number, and each is finite and at most its limit."""
    checks = {name: {"value": values.get(name, math.nan), "limit": limit} for name, limit in limits.items()}
    ok = set(values) == set(limits) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                             for c in checks.values())
    return ok, checks


def run_cell(root: Path, workload: str, *, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None, files: Optional[SimpleNamespace] = None, log=None) -> dict:
    """One run of a cell: set-up, the window, with ``trace`` the traced
    unit, the check. Returns the result line as a dict (``checks`` last)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    f = files or cell_files(root, workload)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = load_module(f.driver_path, f"portbench_driver_{f.traffic['driver']}").Driver(
        f.config, f.traffic, seed, device, log)

    t_driver = time.perf_counter()
    driver.setup()
    sync()
    setup_s = time.perf_counter() - t0
    log(f"[portbench] set-up before the driver's (imports, CUDA) {t_driver - t0:.3f} s")
    log(f"[portbench] {workload} seed {seed}: set-up {setup_s:.3f} s")

    attempted = 0
    unit_seconds = []  # the host seconds of each unit of the window
    w0 = time.perf_counter()
    while not unit_seconds or time.perf_counter() - w0 < seconds:
        u0 = time.perf_counter()
        driver.unit()
        unit_seconds.append(time.perf_counter() - u0)
        attempted += driver.unit_attempted
    window_s, units = time.perf_counter() - w0, len(unit_seconds)
    # the traced unit comes after the window, so that no unit whose host
    # time a reader takes runs after the profiler has been on; a trace that
    # misses operations the counters saw is taken again, up to three times
    traced = None
    for attempt in range(3 if trace else 0):
        span0, counters0 = len(driver.spans), driver.counters()
        t = tr.profile(driver.unit, sync)
        attempted += driver.unit_attempted
        spans, counters = driver.spans[span0:], {k: v - counters0[k] for k, v in driver.counters().items()}
        if driver.trace_complete(t, counters):
            traced = (t, spans, counters)
            break
        log(f"[portbench] traced unit {attempt + 1} misses operations the counters saw ({counters})")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    refuse_forbidden("after the window")
    if trace and traced is None:
        raise RuntimeError("no traced unit held every operation the counters saw")
    failed = driver.failed()
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    log(f"[portbench] window {window_s:.3f} s, {units} units, peak {peak} B")

    breakdown = None
    if trace:
        t, spans, counters = traced
        ctx = SimpleNamespace(trace=t, spans=spans, counters=counters, unit_seconds=unit_seconds, config=f.config,
                              traffic=f.traffic, peaks=work.peaks_for(name), log=log)
        metrics = {}
        for m in f.per_layer:
            value = load_module(f.readers[m["name"]], "portbench_metric_" + m["name"].replace(".", "_")).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": t.busy_s, "window_s": t.window_s}
        breakdown = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    else:
        values = dict(driver.end_to_end(window_s, units), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in f.end_to_end}
        device_info = {}

    correct, checks = judge(driver.check(), f.limits)
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1 if cuda else 0,
                      "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    refuse_forbidden("after the check")
    return out
