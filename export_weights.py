#!/usr/bin/env python3
"""Export a trained orbax checkpoint's EMA denoiser as a flat ``.npz`` that
the PyTorch port loads.

    JAX_PLATFORMS=cpu python3 export_weights.py [--checkpoint checkpoints/balloons-120k]
                                                [--out weights/balloons-120k-ema.npz]

The orbax trees under ``checkpoints/`` hold the JAX package's whole train
state (parameters, EMA, optimizer; ~16 MB each). The port samples the EMA
parameters alone, which this script writes with ``/``-joined flax keys
(``l3/net_conv1/kernel``), the layout ``sinddm_tpu_torch.models.convert``
reads and ``python -m sinddm_tpu_torch.cli --load_checkpoint`` takes. The
arrays are stored as they are restored, float32, bit for bit.

It imports JAX and orbax, so it runs where they are installed;
the port itself never imports them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def restore_ema(path: Path) -> dict:
    """The EMA parameter tree of an orbax checkpoint, restored on the CPU."""
    import jax
    import orbax.checkpoint as ocp
    from jax.sharding import SingleDeviceSharding

    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(path)
    tree = getattr(meta, "item_metadata", meta)
    tree = getattr(tree, "tree", tree)
    cpu0 = SingleDeviceSharding(jax.devices("cpu")[0])  # the stored shardings name a TPU
    template = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu0), tree)
    return jax.tree.map(np.asarray, ckptr.restore(path, template)["ema"])


def main(argv=None) -> None:
    from sinddm_tpu_torch.models.convert import flatten_tree

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", default=str(ROOT / "checkpoints" / "balloons-120k"))
    p.add_argument("--out", default=str(ROOT / "weights" / "balloons-120k-ema.npz"))
    args = p.parse_args(argv)
    flat = flatten_tree(restore_ema(Path(args.checkpoint).resolve()))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat)
    print(f"wrote {len(flat)} arrays, {sum(a.nbytes for a in flat.values())} bytes, to {out}")


if __name__ == "__main__":
    main()
