"""The readings a cell's limits are set from, beside the program's own:
the control and the planted faults, each the reference put in the
program's place, at the cell's own size.

    python3 portbench/calibrate.py --workload NAME --seeds 11 12 13 [--out FILE]

* ``sample-b16-fp32``: the control is the reference walk with TF32 on
  (the nearest precision below the configuration's fp32); the faults are a
  step that returns its state unchanged (the last step of the finest
  scale), half of the batch left out (the denoiser's output zero for the
  second half, as if those rows were never computed) and an answer altered
  where it is produced (one image's last step returned negated). Each is
  held against the plain reference walk on the same noise.
* ``train-b32-graph``: the control is the set-up's steps (the start's
  three, the warm-up's, one replay at each scale) with TF32 on; the fault
  is half of the batch left out, the loss the mean over the first half.
  Both stages of each are held against the plain reference's steps. A state
  left unchanged reads 1 by the update's measure and needs no run.

Prints one JSON line a seed and writes them to ``--out``. Needs the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda"


def sample_readings(driver) -> dict:
    import torch

    from portbench.drivers.sample_walks import walk_gaps

    b = driver.batch
    base = driver.reference_walk(0)
    out = {"control_tf32": walk_gaps(driver.reference_walk(0, tf32=True), base)}
    last = len(base) - 1
    out["fault_unchanged"] = walk_gaps(driver.reference_walk(
        0, step_fault=lambda s, t, x, y: x if (s == last and t == 0) else y), base)

    def altered(s, t, x, y):
        if s == last and t == 0:
            y = y.clone()
            y[0] = -y[0]
        return y
    out["fault_altered"] = walk_gaps(driver.reference_walk(0, step_fault=altered), base)

    def half(x, t, s, net):
        eps = net(x, t, s)
        return torch.cat([eps[: b // 2], torch.zeros_like(eps[b // 2:])])
    out["fault_half_batch"] = walk_gaps(driver.reference_walk(0, net_wrap=half), base)
    return out


def train_readings(driver) -> dict:
    from portbench.drivers.train_chunks import check_numbers

    base = driver.reference()
    out = {"control_tf32": check_numbers(driver.reference(tf32=True), base),
           "fault_half_batch": check_numbers(driver.reference(rows=slice(0, driver.batch // 2)), base)}
    unchanged = {tag: dict(stage, p_end=stage["p0"]) for tag, stage in base.items()}
    out["fault_unchanged"] = {k: v for k, v in check_numbers(unchanged, base).items() if k.endswith("update_gap")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.yardstick.seeds import sub_seed
    from portbench.yardstick.weights import make_weights

    harness.set_cache_dirs(ROOT)
    f = harness.cell_files(ROOT, args.workload)
    mod = harness.load_module(f.driver_path, "portbench_driver_" + f.traffic["driver"])
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        d = mod.Driver(f.config, f.traffic, seed, DEVICE, lambda m: print(m, file=sys.stderr))
        if f.traffic["driver"] == "train_chunks":
            from sinddm_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS

            d.inputs()
            d.chunks = [GRAPH_WARMUP_STEPS * len(d.sizes_hw), len(d.sizes_hw)]  # the set-up's two chunks
            readings = train_readings(d)
        else:
            d.weights = make_weights(sub_seed(seed, "weights"), f.config, DEVICE)
            readings = sample_readings(d)
        row = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **readings}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
