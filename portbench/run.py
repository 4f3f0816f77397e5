"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers the check
compared, each beside its limit. Exits non-zero, printing no result, when
there is no CUDA card (or fewer than the cell asks for), when the program
cannot be imported, or when JAX or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import harness

    files = harness.cell_files(ROOT, args.workload)
    harness.set_cache_dirs(ROOT)
    import torch

    chips = int(files.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           t0=T0, files=files)
    print(json.dumps(out), flush=True)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
