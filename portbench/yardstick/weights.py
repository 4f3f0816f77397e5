"""The denoiser's weights, made on the device from the seed.

One ``torch.randn`` call on a generator of the device fills every leaf; a
kernel is scaled to std 1/sqrt(fan_in) (the variance SinDDM's
initialisation gives it), a bias to std :data:`BIAS_STD`, so that every
bias path carries a value. Names and layouts are the SinDDM network's as
the program and the reference both take them: convolutions HWIO
(``[kh, kw, Cin, Cout]``, the depthwise ``[5, 5, 1, C]``), dense layers
``[out, in]``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

BIAS_STD = 0.05


def leaves(blocks: Sequence[Sequence[int]], time_dim: int, channels: int) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan_in) of every leaf of the network with these
    blocks' widths, time embedding width and image channels; fan_in 0 marks
    a bias."""
    if blocks[0][0] != channels:
        raise ValueError(f"the first block takes {blocks[0][0]} channels, the images have {channels}")
    td = time_dim
    out = [("time_mlp1.weight", (4 * td, 2 * td), 2 * td), ("time_mlp1.bias", (4 * td,), 0),
           ("time_mlp2.weight", (td, 4 * td), 4 * td), ("time_mlp2.bias", (td,), 0)]
    for i, (c, co) in enumerate(blocks):
        p = f"l{i + 1}."
        out += [(p + "ds_conv.weight", (5, 5, 1, c), 25), (p + "ds_conv.bias", (c,), 0),
                (p + "cond_mlp.weight", (td, td), td), (p + "cond_mlp.bias", (td,), 0),
                (p + "cond_proj.weight", (c, td), td), (p + "cond_proj.bias", (c,), 0),
                (p + "net_conv1.weight", (3, 3, c, co), 9 * c), (p + "net_conv1.bias", (co,), 0),
                (p + "net_conv2.weight", (3, 3, co, co), 9 * co), (p + "net_conv2.bias", (co,), 0)]
        if c != co:
            out += [(p + "res_conv.weight", (1, 1, c, co), c), (p + "res_conv.bias", (co,), 0)]
    last = blocks[-1][1]
    out += [("final_conv.weight", (1, 1, last, channels), last), ("final_conv.bias", (channels,), 0)]
    return out


def make_weights(seed: int, config: dict, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the configuration's network (its ``blocks``,
    ``time_dim`` and ``channels``) from one draw of a generator on
    ``device`` seeded ``seed``."""
    spec = leaves(config["blocks"], config["time_dim"], config["channels"])
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan_in in spec:
        n = math.prod(shape)
        std = BIAS_STD if fan_in == 0 else fan_in ** -0.5
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    return out
