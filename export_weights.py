#!/usr/bin/env python3
"""Export a trained orbax checkpoint's EMA denoiser as a flat ``.npz`` that
the PyTorch port loads; or, with ``--sifid_proxy``, the JAX package's SIFID
proxy feature map.

    JAX_PLATFORMS=cpu python3 export_weights.py [--checkpoint checkpoints/balloons-120k]
                                                [--out weights/balloons-120k-ema.npz]
    JAX_PLATFORMS=cpu python3 export_weights.py --sifid_proxy
                                                [--out weights/sifid-proxy-conv-64x2-seed0.npz]

The orbax trees under ``checkpoints/`` hold the JAX package's whole train
state (parameters, EMA, optimizer; ~16 MB each). The port samples the EMA
parameters alone, which this script writes with ``/``-joined flax keys
(``l3/net_conv1/kernel``), the layout ``sinddm_tpu_torch.models.convert``
reads and ``python -m sinddm_tpu_torch.cli --load_checkpoint`` takes. The
arrays are stored as they are restored, float32, bit for bit.

``--sifid_proxy`` writes the two HWIO kernels (``conv0`` [3, 3, 3, 64],
``conv1`` [3, 3, 64, 64]) that ``sinddm_tpu.metrics.conv_feature_extractor()``
draws with ``jax.random`` at its defaults (seed 0, dim 64, depth 2), so that
the port's ``sinddm_tpu_torch.metrics.conv_feature_extractor()`` is the same
feature map and its SIFIDs sit on the scale of the JAX package's records.

It imports JAX (and orbax for a checkpoint), so it runs where they are
installed; the port itself never imports them.
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


def sifid_proxy_kernels(dim: int = 64, depth: int = 2, seed: int = 0) -> dict:
    """The kernels of ``sinddm_tpu.metrics.conv_feature_extractor(dim, depth,
    seed)``, drawn as it draws them."""
    import jax

    keys = jax.random.split(jax.random.PRNGKey(seed), depth)
    out, cin = {}, 3
    for d in range(depth):
        out[f"conv{d}"] = np.asarray(jax.random.normal(keys[d], (3, 3, cin, dim)) / np.sqrt(9 * cin), np.float32)
        cin = dim
    return out


def main(argv=None) -> None:
    from sinddm_tpu_torch.models.convert import flatten_tree

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", default=str(ROOT / "checkpoints" / "balloons-120k"))
    p.add_argument("--sifid_proxy", action="store_true",
                   help="write the JAX package's SIFID proxy kernels in place of a checkpoint's EMA")
    p.add_argument("--out", default=None,
                   help="default weights/balloons-120k-ema.npz, or weights/sifid-proxy-conv-64x2-seed0.npz "
                        "with --sifid_proxy")
    args = p.parse_args(argv)
    if args.sifid_proxy:
        flat = sifid_proxy_kernels()
        default = ROOT / "weights" / "sifid-proxy-conv-64x2-seed0.npz"
    else:
        flat = flatten_tree(restore_ema(Path(args.checkpoint).resolve()))
        default = ROOT / "weights" / "balloons-120k-ema.npz"
    out = Path(args.out) if args.out else default
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat)
    print(f"wrote {len(flat)} arrays, {sum(a.nbytes for a in flat.values())} bytes, to {out}")


if __name__ == "__main__":
    main()
