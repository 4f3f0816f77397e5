"""Map the JAX package's denoiser parameters onto :class:`SinDDMNet`.

The input is the flax parameter tree of ``sinddm_tpu.models.SinDDMNet``
(for a trained checkpoint, its ``ema`` subtree), either as nested dicts of
arrays or flat, with ``/``-joined keys such as ``l3/net_conv1/kernel``
(the form of an ``.npz`` export). Layouts:

  ``{l*/ds_conv, l*/net_conv*, l*/res_conv, final_conv}/kernel``
      HWIO ([5,5,1,C], [3,3,Ci,Co], [1,1,Ci,Co]) -> ``.weight`` unchanged;
      the port keeps HWIO because it is the layout its kernel reads;
  ``{time_mlp*, l*/cond_mlp, l*/cond_proj}/kernel`` ([in, out]) ->
      ``nn.Linear.weight`` ([out, in]), transposed;
  every ``bias`` -> ``.bias``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from sinddm_tpu_torch.models.denoiser import TIME_DIM, SinDDMNet

_DENSE = ("time_mlp1", "time_mlp2", "cond_mlp", "cond_proj")


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def _as_flat(tree: Union[str, Path, Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    if isinstance(tree, (str, Path)):
        with np.load(tree) as npz:
            return {k: np.asarray(npz[k]) for k in npz.files}
    return flatten_tree(tree)


def denoiser_params_from_flax(tree: Union[str, Path, Mapping[str, Any]]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested, flat ``/``-keyed, or an ``.npz`` path)
    -> float32 CPU state dict of :class:`SinDDMNet`."""
    state: Dict[str, torch.Tensor] = {}
    for key, arr in _as_flat(tree).items():
        *path, leaf = key.split("/")
        arr = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            name = "weight"
            if path[-1] in _DENSE:
                arr = arr.T
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unexpected parameter {key!r}")
        state[".".join(path + [name])] = torch.tensor(arr)
    return state


def denoiser_from_flax(
    tree: Union[str, Path, Mapping[str, Any]],
    *,
    compute_dtype: torch.dtype = torch.float32,
    device="cuda",
) -> SinDDMNet:
    """Build a :class:`SinDDMNet` whose widths are read from the tree and
    load it strictly."""
    state = denoiser_params_from_flax(tree)
    dim = state["l2.net_conv1.weight"].shape[-1]
    channels = state["l1.ds_conv.weight"].shape[-1]
    out_dim = state["final_conv.weight"].shape[-1]
    model = SinDDMNet(dim=dim, out_dim=out_dim, channels=channels,
                      compute_dtype=compute_dtype, device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()


def random_flax_params(dim: int = 160, channels: int = 3, seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the flax tree layout (fan-in scaled
    normal kernels, small normal biases), for runs without a checkpoint."""
    rng = np.random.default_rng(seed)

    def dense(cin, cout):
        return {"kernel": (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(cout)).astype(np.float32)}

    def conv(k, cin, cout, groups=1):
        fan_in = k * k * cin // groups
        shape = (k, k, cin // groups, cout)
        return {"kernel": (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(cout)).astype(np.float32)}

    def block(cin, cout):
        p = {
            "ds_conv": conv(5, cin, cin, groups=cin),
            "cond_mlp": dense(TIME_DIM, TIME_DIM),
            "cond_proj": dense(TIME_DIM, cin),
            "net_conv1": conv(3, cin, cout),
            "net_conv2": conv(3, cout, cout),
        }
        if cin != cout:
            p["res_conv"] = conv(1, cin, cout)
        return p

    half = int(dim / 2)
    return {
        "time_mlp1": dense(2 * TIME_DIM, 4 * TIME_DIM),
        "time_mlp2": dense(4 * TIME_DIM, TIME_DIM),
        "l1": block(channels, half),
        "l2": block(half, dim),
        "l3": block(dim, dim),
        "l4": block(dim, half),
        "final_conv": conv(1, half, channels),
    }
