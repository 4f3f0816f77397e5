"""The InceptionV3 stem, the feature map of paper-exact SIFID (port of
``sinddm_tpu/models/inception.py``).

SIFID takes the Fréchet distance of InceptionV3 patch features at the first
pool's output (64-d, pytorch-fid's "block 0"), at the image's own
resolution. The stem, with torchvision ``inception_v3``'s layer names and
geometry:

  Conv2d_1a_3x3 (3->32, s2)  -> Conv2d_2a_3x3 (32->32) ->
  Conv2d_2b_3x3 (32->64, p1) -> max-pool 3, s2            = block0 (64-d)
  Conv2d_3b_1x1 (64->80)     -> Conv2d_4a_3x3 (80->192) ->
  max-pool 3, s2                                          = block1 (192-d)

Each conv is torchvision's ``BasicConv2d``: a conv without bias, an
inference BatchNorm (eps 1e-3) and a ReLU. Parameters are a dict by layer
name of ``kernel`` (HWIO, the JAX package's layout) and ``bn_gamma``,
``bn_beta``, ``bn_mean``, ``bn_var``. Real weights load from a torchvision
state dict (:func:`load_inception`, at the places
:func:`find_inception_weights` sniffs); none is in the repo, and none is
fetched.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3  # torchvision BasicConv2d's BatchNorm2d(eps=0.001)

# (name, kernel, stride, padding, c_out)
STEM_SPEC: Tuple[Tuple[str, int, int, int, int], ...] = (
    ("Conv2d_1a_3x3", 3, 2, 0, 32),
    ("Conv2d_2a_3x3", 3, 1, 0, 32),
    ("Conv2d_2b_3x3", 3, 1, 1, 64),
    # --- max-pool (block0: 64-d) ---
    ("Conv2d_3b_1x1", 1, 1, 0, 80),
    ("Conv2d_4a_3x3", 3, 1, 0, 192),
    # --- max-pool (block1: 192-d) ---
)

Params = Dict[str, Dict[str, torch.Tensor]]


def _basic_conv(x: torch.Tensor, p: Mapping[str, torch.Tensor], stride: int, pad: int) -> torch.Tensor:
    """Conv (no bias) + inference BatchNorm + ReLU on NCHW x."""
    x = F.conv2d(x, p["kernel"].permute(3, 2, 0, 1), stride=stride, padding=pad)
    scale = p["bn_gamma"] / torch.sqrt(p["bn_var"] + BN_EPS)
    x = (x - p["bn_mean"][:, None, None]) * scale[:, None, None] + p["bn_beta"][:, None, None]
    return torch.relu(x)


def inception_stem_features(params: Params, x01: torch.Tensor, *, block: str = "block0") -> torch.Tensor:
    """[B, H, W, 3] images in [0, 1] -> the stem's feature map [B, H', W', D]
    (``block0``, 64-d, or ``block1``, 192-d). The input is scaled to 2x - 1,
    as pytorch-fid does."""
    if block not in ("block0", "block1"):
        raise ValueError(f"block must be 'block0' or 'block1', got {block!r}")
    x = (2.0 * x01 - 1.0).permute(0, 3, 1, 2)
    for name, _, stride, pad, _ in STEM_SPEC[:3]:
        x = _basic_conv(x, params[name], stride, pad)
    x = F.max_pool2d(x, 3, 2)
    if block == "block1":
        for name, _, stride, pad, _ in STEM_SPEC[3:]:
            x = _basic_conv(x, params[name], stride, pad)
        x = F.max_pool2d(x, 3, 2)
    return x.permute(0, 2, 3, 1)


def _to_device(tree: Mapping[str, Mapping[str, Any]], device) -> Params:
    return {name: {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device) for k, v in layer.items()}
            for name, layer in tree.items()}


def random_inception_params(seed: int = 0, device="cuda") -> Params:
    """Stem parameters drawn from numpy's generator (seed): kernels N(0, 1 /
    (k k cin)), BatchNorm scale and variance U(0.5, 1.5), shift and mean
    N(0, 0.1). The JAX package's ``random_inception_params`` draws the same
    numbers in the same order."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    c_in = 3
    for name, k, _, _, c_out in STEM_SPEC:
        tree[name] = {
            "kernel": rng.normal(0, 1.0 / np.sqrt(k * k * c_in), (k, k, c_in, c_out)),
            "bn_gamma": rng.uniform(0.5, 1.5, (c_out,)),
            "bn_beta": rng.normal(0, 0.1, (c_out,)),
            "bn_mean": rng.normal(0, 0.1, (c_out,)),
            "bn_var": rng.uniform(0.5, 1.5, (c_out,)),
        }
        c_in = c_out
    return _to_device(tree, device)


def inception_params_from_state_dict(sd: Mapping[str, Any], device="cuda") -> Params:
    """A torchvision ``inception_v3`` state dict (tensors or arrays; other
    keys ignored) -> the stem's parameters, kernels OIHW -> HWIO."""
    arr = lambda k: np.asarray(sd[k].detach().cpu() if isinstance(sd[k], torch.Tensor) else sd[k])  # noqa: E731
    tree = {}
    for name, _, _, _, _ in STEM_SPEC:
        tree[name] = {
            "kernel": np.ascontiguousarray(arr(f"{name}.conv.weight").transpose(2, 3, 1, 0)),
            "bn_gamma": arr(f"{name}.bn.weight"),
            "bn_beta": arr(f"{name}.bn.bias"),
            "bn_mean": arr(f"{name}.bn.running_mean"),
            "bn_var": arr(f"{name}.bn.running_var"),
        }
    return _to_device(tree, device)


def load_inception(path: str, device="cuda") -> Params:
    """The stem's parameters from a torch ``inception_v3`` checkpoint file
    (a state dict, or a pickled module)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(data, "state_dict"):
        data = data.state_dict()
    return inception_params_from_state_dict({k: v.float() for k, v in data.items() if hasattr(v, "float")}, device)


def find_inception_weights() -> Optional[str]:
    """An InceptionV3 checkpoint at the sniffed places, else None:
    ``$SINDDM_INCEPTION_WEIGHTS``, ``<repo>/checkpoints/inception_v3.pt`` /
    ``.pth``, torch hub's cache (``~/.cache/torch/hub/checkpoints/``)."""
    repo = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    candidates = [
        os.environ.get("SINDDM_INCEPTION_WEIGHTS"),
        os.path.join(repo, "checkpoints", "inception_v3.pt"),
        os.path.join(repo, "checkpoints", "inception_v3.pth"),
        os.path.expanduser("~/.cache/torch/hub/checkpoints/inception_v3_google-0cc3c7bd.pth"),
    ]
    return next((c for c in candidates if c and os.path.isfile(c)), None)
