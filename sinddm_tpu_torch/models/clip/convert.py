"""CLIP weights for :class:`~sinddm_tpu_torch.models.clip.model.CLIPModel`
(port of ``sinddm_tpu/models/clip/convert.py``).

The module's parameters carry OpenAI's state-dict names, so a checkpoint
(the original TorchScript archive or a plain state dict) loads strictly.
:func:`clip_from_flax` takes the JAX package's flax parameter tree instead
(the inverse of its ``convert_state_dict``), which is how the tests give
both packages the same weights. :func:`random_clip_state_dict` makes a
seeded random tower of the right shapes for runs without the 150M-parameter
file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sinddm_tpu_torch.models.clip.model import CLIPConfig, CLIPModel


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu")
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: torch.as_tensor(v).float() for k, v in sd.items()}


def config_from_state_dict(sd: Mapping[str, Any]) -> CLIPConfig:
    """Infer the config from the shapes, as OpenAI's ``build_model`` does."""
    conv1 = sd["visual.conv1.weight"]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    width_t = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=grid * conv1.shape[-1],
        vision_layers=len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}),
        vision_width=conv1.shape[0],
        vision_patch_size=conv1.shape[-1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width_t,
        transformer_heads=width_t // 64,
        transformer_layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
    )


def clip_from_state_dict(sd: Mapping[str, Any], cfg: Optional[CLIPConfig] = None, device="cuda",
                         compute_dtype: Optional[str] = None) -> CLIPModel:
    """Frozen :class:`CLIPModel` with fp32 parameters on ``device`` from an
    OpenAI-named state dict (arrays or tensors). ``compute_dtype="bfloat16"``
    runs the vision tower's matrix products in bf16 (``CLIPConfig``). Entries
    the module has no use for (``input_resolution``, ``context_length``,
    ``vocab_size``) are ignored."""
    cfg = cfg or config_from_state_dict(sd)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = CLIPModel(cfg)
    own = model.state_dict()
    state = {k: torch.tensor(np.asarray(v), dtype=torch.float32).reshape(own[k].shape)
             for k, v in sd.items() if k in own}
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False).eval().to(device)


def _block_from_flax(tree: Mapping[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    a = lambda v: np.asarray(v, np.float32)  # noqa: E731
    for ln in ("ln_1", "ln_2"):
        out[f"{prefix}.{ln}.weight"] = a(tree[ln]["scale"])
        out[f"{prefix}.{ln}.bias"] = a(tree[ln]["bias"])
    out[f"{prefix}.attn.in_proj_weight"] = a(tree["attn"]["in_proj"]["kernel"]).T
    out[f"{prefix}.attn.in_proj_bias"] = a(tree["attn"]["in_proj"]["bias"])
    out[f"{prefix}.attn.out_proj.weight"] = a(tree["attn"]["out_proj"]["kernel"]).T
    out[f"{prefix}.attn.out_proj.bias"] = a(tree["attn"]["out_proj"]["bias"])
    for fc in ("c_fc", "c_proj"):
        out[f"{prefix}.mlp.{fc}.weight"] = a(tree[fc]["kernel"]).T
        out[f"{prefix}.mlp.{fc}.bias"] = a(tree[fc]["bias"])


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's flax CLIP tree (``{"params": ...}`` or the params
    themselves, leaves convertible by ``np.asarray``) -> OpenAI-named arrays."""
    p = variables.get("params", variables)
    a = lambda v: np.asarray(v, np.float32)  # noqa: E731
    vis = p["visual"]
    sd: Dict[str, np.ndarray] = {
        "visual.conv1.weight": a(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1),  # HWIO -> OIHW
        "visual.class_embedding": a(vis["class_embedding"]),
        "visual.positional_embedding": a(vis["positional_embedding"]),
        "visual.ln_pre.weight": a(vis["ln_pre"]["scale"]),
        "visual.ln_pre.bias": a(vis["ln_pre"]["bias"]),
        "visual.ln_post.weight": a(vis["ln_post"]["scale"]),
        "visual.ln_post.bias": a(vis["ln_post"]["bias"]),
        "visual.proj": a(vis["proj"]),
        "token_embedding.weight": a(p["token_embedding"]["embedding"]),
        "positional_embedding": a(p["positional_embedding"]),
        "ln_final.weight": a(p["ln_final"]["scale"]),
        "ln_final.bias": a(p["ln_final"]["bias"]),
        "text_projection": a(p["text_projection"]),
        "logit_scale": a(p["logit_scale"]),
    }
    for tower, tree in (("visual.transformer", vis["transformer"]), ("transformer", p["transformer"])):
        for name, block in tree.items():
            _block_from_flax(block, f"{tower}.resblocks.{name.split('_')[1]}", sd)
    return sd


def clip_from_flax(variables: Mapping[str, Any], cfg: CLIPConfig, device="cuda") -> CLIPModel:
    """:class:`CLIPModel` with the weights of the JAX package's flax tree.
    ``cfg`` is explicit: the head counts cannot be read from the shapes of a
    tiny test tower."""
    return clip_from_state_dict(state_dict_from_flax(variables), cfg, device=device)


def load_clip(path: str, device="cuda", compute_dtype: Optional[str] = None) -> CLIPModel:
    """Load an OpenAI CLIP checkpoint (TorchScript archive or state dict);
    ``compute_dtype="bfloat16"`` for the bf16 vision tower."""
    return clip_from_state_dict(load_torch_state_dict(path), device=device, compute_dtype=compute_dtype)


def find_clip_weights() -> Optional[str]:
    """A real ViT-B/32 checkpoint at the documented places, else None:
    ``$SINDDM_CLIP_WEIGHTS``, ``<repo>/checkpoints/ViT-B-32.pt``,
    ``~/.cache/clip/ViT-B-32.pt`` (see ``docs/REAL_CLIP.md``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.abspath(os.path.join(here, "..", "..", ".."))
    candidates = [
        os.environ.get("SINDDM_CLIP_WEIGHTS"),
        os.path.join(repo, "checkpoints", "ViT-B-32.pt"),
        os.path.expanduser("~/.cache/clip/ViT-B-32.pt"),
    ]
    return next((c for c in candidates if c and os.path.isfile(c)), None)


def random_clip_state_dict(cfg: CLIPConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random weights of the right shapes, OpenAI-named: fan-in
    scaled projections, unit LayerNorms, so activations stay O(1)."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    W, V, ps = cfg.vision_width, cfg.transformer_width, cfg.vision_patch_size
    grid = cfg.image_resolution // ps
    sd = {
        "visual.conv1.weight": n(W, 3, ps, ps, scale=(3 * ps * ps) ** -0.5),
        "visual.class_embedding": n(W, scale=W ** -0.5),
        "visual.positional_embedding": n(grid * grid + 1, W, scale=W ** -0.5),
        "visual.proj": n(W, cfg.embed_dim, scale=W ** -0.5),
        "positional_embedding": n(cfg.context_length, V, scale=0.01),
        "text_projection": n(V, cfg.embed_dim, scale=V ** -0.5),
        "logit_scale": np.float32(np.log(1 / 0.07)),
        "token_embedding.weight": n(cfg.vocab_size, V, scale=0.02),
    }
    for ln, width in (("visual.ln_pre", W), ("visual.ln_post", W), ("ln_final", V)):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = np.ones(width, np.float32), np.zeros(width, np.float32)
    for tower, layers, width in (("visual.transformer", cfg.vision_layers, W),
                                 ("transformer", cfg.transformer_layers, V)):
        for i in range(layers):
            p = f"{tower}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = np.ones(width, np.float32), np.zeros(width, np.float32)
            sd[f"{p}.attn.in_proj_weight"] = n(3 * width, width, scale=width ** -0.5)
            sd[f"{p}.attn.in_proj_bias"] = np.zeros(3 * width, np.float32)
            sd[f"{p}.attn.out_proj.weight"] = n(width, width, scale=width ** -0.5)
            sd[f"{p}.attn.out_proj.bias"] = np.zeros(width, np.float32)
            sd[f"{p}.mlp.c_fc.weight"] = n(4 * width, width, scale=width ** -0.5)
            sd[f"{p}.mlp.c_fc.bias"] = np.zeros(4 * width, np.float32)
            sd[f"{p}.mlp.c_proj.weight"] = n(width, 4 * width, scale=(4 * width) ** -0.5)
            sd[f"{p}.mlp.c_proj.bias"] = np.zeros(width, np.float32)
    return sd


def random_clip_params(cfg: CLIPConfig, seed: int = 0, device="cuda") -> CLIPModel:
    """A :class:`CLIPModel` with :func:`random_clip_state_dict` weights."""
    return clip_from_state_dict(random_clip_state_dict(cfg, seed), cfg, device=device)
