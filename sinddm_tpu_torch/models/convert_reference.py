"""Read reference (PyTorch) SinDDM checkpoints into the port.

Port of ``sinddm_tpu/models/convert_reference.py``, torch to torch. The
reference trainer saves ``model-{milestone}.pt`` holding ``{'step',
'model', 'ema', 'sched', ...}``, where ``model`` and ``ema`` are state dicts
of ``MultiScaleGaussianDiffusion``: the denoiser's weights under the
``denoise_fn.`` prefix and its schedule buffers (betas, gammas, ...;
recomputed by :func:`sinddm_tpu_torch.schedules.make_schedules`, not
read). Those state dicts become the JAX package's flax parameter tree,
which :func:`sinddm_tpu_torch.models.convert.denoiser_from_flax` loads.
Layout map (torch OIHW / [out, in] -> flax HWIO / [in, out]):

  denoise_fn.time_mlp.{0,2}       -> time_mlp{1,2}         (Linear, W.T)
  denoise_fn.l{i}.mlp.1           -> l{i}/cond_mlp         (Linear, W.T)
  denoise_fn.l{i}.time_reshape    -> l{i}/cond_proj        (1x1 conv == Linear)
  denoise_fn.l{i}.ds_conv         -> l{i}/ds_conv          ([C,1,5,5] -> [5,5,1,C])
  denoise_fn.l{i}.net.{0,2}       -> l{i}/net_conv{1,2}    ([O,I,3,3] -> [3,3,I,O])
  denoise_fn.l{i}.res_conv        -> l{i}/res_conv         (absent when identity)
  denoise_fn.final_conv.0         -> final_conv

:mod:`sinddm_tpu_torch.models.export_reference` writes the same layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _lin(sd, key):
    out = {"kernel": np.ascontiguousarray(sd[f"{key}.weight"].T)}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _conv(sd, key):
    return {"kernel": np.ascontiguousarray(sd[f"{key}.weight"].transpose(2, 3, 1, 0)), "bias": sd[f"{key}.bias"]}


def _conv1x1_as_dense(sd, key):
    return {"kernel": np.ascontiguousarray(sd[f"{key}.weight"][:, :, 0, 0].T), "bias": sd[f"{key}.bias"]}


def denoiser_params_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference ``MultiScaleGaussianDiffusion`` or bare ``SinDDMNet`` state
    dict -> the flax parameter tree of the denoiser (float32 numpy)."""
    sd = {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32) for k, v in sd.items()}
    prefix = "denoise_fn." if any(k.startswith("denoise_fn.") for k in sd) else ""

    def g(key):
        return f"{prefix}{key}"

    params: Dict[str, Any] = {
        "time_mlp1": _lin(sd, g("time_mlp.0")),
        "time_mlp2": _lin(sd, g("time_mlp.2")),
        "final_conv": _conv(sd, g("final_conv.0")),
    }
    for i in (1, 2, 3, 4):
        name = f"l{i}"
        block = {
            "cond_mlp": _lin(sd, g(f"{name}.mlp.1")),
            "cond_proj": _conv1x1_as_dense(sd, g(f"{name}.time_reshape")),
            "ds_conv": _conv(sd, g(f"{name}.ds_conv")),
            "net_conv1": _conv(sd, g(f"{name}.net.0")),
            "net_conv2": _conv(sd, g(f"{name}.net.2")),
        }
        if f"{g(name)}.res_conv.weight" in sd:
            block["res_conv"] = _conv(sd, g(f"{name}.res_conv"))
        params[name] = block
    return params


def read_checkpoint(path) -> dict:
    """The payload of a ``model-{milestone}.pt`` on the CPU (tensors, numbers,
    lists and state dicts only: read with ``weights_only``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(path) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """A reference ``model-{milestone}.pt`` -> (params, ema_params, step),
    the parameter trees in the flax layout."""
    data = read_checkpoint(path)
    return (denoiser_params_from_state_dict(data["model"]), denoiser_params_from_state_dict(data["ema"]),
            int(data.get("step", 0)))
