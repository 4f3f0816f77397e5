"""Output-fidelity metrics: SIFID / FID with pluggable features (port of
``sinddm_tpu/metrics.py``).

SIFID (single-image FID, SinGAN's and the SinDDM paper's metric) is the
Fréchet distance between the patch-feature statistics of the real image and
of a generated sample.

* :func:`frechet_distance` (the FID formula; the square root through the
  eigendecomposition of a symmetric product, no scipy), :func:`patch_feature_stats`,
  :func:`sifid` and :func:`sifid_batch`: numpy in float64, this package's
  own copy of the JAX package's;
* feature maps ``feature_fn(img [H, W, 3] in [-1, 1]) -> [N, D]``:
  :func:`conv_feature_extractor` (a fixed random conv net, a proxy that
  needs no trained weights), :func:`inception_feature_extractor` (the
  InceptionV3 stem, the paper's layer; ``models/inception.py``) and
  :func:`clip_feature_extractor` (CLIP ViT patch tokens, or its patch
  embedding alone).

A feature map runs on its weights' device and takes a numpy array or a
tensor. Its convolutions and products run in true fp32: cuDNN would take
TF32 for fp32 convolutions by default on the card, which moves features
by ~1e-3 and is not the JAX package's arithmetic.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FeatureFn = Callable[[torch.Tensor], torch.Tensor]  # [H, W, 3] -> [N, D]

# the JAX package's conv_feature_extractor() at its defaults (seed 0, dim 64,
# depth 2): its two HWIO kernels, drawn with jax.random, exported by
# export_weights.py --sifid_proxy
SIFID_PROXY_NPZ = Path(__file__).resolve().parents[1] / "weights" / "sifid-proxy-conv-64x2-seed0.npz"
SIFID_PROXY_DEFAULTS = (64, 2, 0)  # dim, depth, seed


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), in float64."""
    mu1, mu2, sigma1, sigma2 = (np.asarray(a, np.float64) for a in (mu1, mu2, sigma1, sigma2))
    diff = mu1 - mu2
    # sqrtm(S1 S2) has the trace of sqrtm(sqrt(S1) S2 sqrt(S1)), which is symmetric PSD
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    tr_covmean = np.sum(np.sqrt(np.maximum(np.linalg.eigvalsh(inner), 0.0)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(a)
    w = np.maximum(w, 0.0)
    return (v * np.sqrt(w)) @ v.T


def patch_feature_stats(feats) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] features -> (mean [D], covariance [D, D]) in float64."""
    feats = np.asarray(feats, np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def _features(feature_fn: FeatureFn, img) -> np.ndarray:
    return feature_fn(img).detach().cpu().numpy()


def sifid(real_img, fake_img, feature_fn: FeatureFn) -> float:
    """Single-image FID between two images' patch features (images [H, W, 3]
    in [-1, 1], numpy or tensors)."""
    return frechet_distance(*patch_feature_stats(_features(feature_fn, real_img)),
                            *patch_feature_stats(_features(feature_fn, fake_img)))


def sifid_batch(real_img, fake_batch, feature_fn: FeatureFn) -> np.ndarray:
    """SIFID of each sample of [B, H, W, 3] against the real image."""
    return np.asarray([sifid(real_img, fake_batch[b], feature_fn) for b in range(len(fake_batch))])


@contextlib.contextmanager
def true_fp32():
    """cuDNN's convolutions and cuBLAS's products in true fp32 (TF32 off) for
    a scope; the switches are restored after it."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = old


def _as_image(img, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img,
                           dtype=torch.float32).to(device)


def _conv(x: torch.Tensor, kernel_hwio: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC x, HWIO kernel -> NHWC, through ``F.conv2d``."""
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel_hwio.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def sifid_proxy_kernels(dim: int = 64, depth: int = 2, seed: int = 0, device="cuda") -> list:
    """The conv proxy's HWIO kernels: at the defaults the JAX package's
    (``SIFID_PROXY_NPZ``); otherwise N(0, 1) / sqrt(9 cin) from a
    ``torch.Generator`` seeded with ``seed`` (a map of the same family, not
    the JAX package's draw)."""
    if (dim, depth, seed) == SIFID_PROXY_DEFAULTS:
        with np.load(SIFID_PROXY_NPZ) as z:
            arrays = [z[f"conv{d}"] for d in range(depth)]
        return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]
    gen = torch.Generator().manual_seed(seed)
    out, cin = [], 3
    for _ in range(depth):
        out.append((torch.randn((3, 3, cin, dim), generator=gen) / np.sqrt(9 * cin)).to(device))
        cin = dim
    return out


def conv_feature_extractor(dim: int = 64, depth: int = 2, seed: int = 0,
                           kernels: Optional[Sequence] = None, device="cuda") -> FeatureFn:
    """A fixed random conv feature map (a SIFID proxy that needs no trained
    weights): ``depth`` stages of a VALID 3x3 conv to ``dim`` channels and a
    leaky ReLU (0.2), stride 1. ``kernels`` (HWIO arrays) override
    :func:`sifid_proxy_kernels`, whose defaults are the JAX package's map,
    so SIFIDs sit on the scale of its records."""
    ks = [torch.as_tensor(np.asarray(k) if not isinstance(k, torch.Tensor) else k, dtype=torch.float32).to(device)
          for k in (kernels if kernels is not None else sifid_proxy_kernels(dim, depth, seed, device))]

    def feature_fn(img) -> torch.Tensor:
        x = _as_image(img, ks[0].device)[None]
        with torch.no_grad(), true_fp32():
            for k in ks:
                x = F.leaky_relu(_conv(x, k), 0.2)
        return x[0].reshape(-1, x.shape[-1])

    return feature_fn


def inception_feature_extractor(inception_params, block: str = "block0") -> FeatureFn:
    """The InceptionV3 stem's features as the SIFID map: ``block0`` (64-d,
    the first pool's output, the layer SIFID is defined on) or ``block1``
    (192-d). ``inception_params`` from ``models/inception.py``
    (:func:`~sinddm_tpu_torch.models.inception.load_inception` or
    ``random_inception_params``)."""
    from sinddm_tpu_torch.models.inception import inception_stem_features

    device = next(iter(inception_params.values()))["kernel"].device

    def feature_fn(img) -> torch.Tensor:
        x01 = ((_as_image(img, device) + 1.0) * 0.5).clamp(0.0, 1.0)[None]
        with torch.no_grad(), true_fp32():
            feats = inception_stem_features(inception_params, x01, block=block)
        return feats[0].reshape(-1, feats.shape[-1])

    return feature_fn


def clip_feature_extractor(clip_model, feature: str = "tokens") -> FeatureFn:
    """Patch features of a frozen CLIP ViT as the SIFID map: ``"tokens"``,
    the post-transformer patch tokens (``encode_image_tokens``), or
    ``"conv1"``, the patch embedding alone (one product over the patches).
    ``encode_image`` pools to one embedding and leaves no population."""
    from sinddm_tpu_torch.models.clip.model import clip_normalize

    if feature not in ("tokens", "conv1"):
        raise ValueError(f"feature must be 'tokens' or 'conv1', got {feature!r}")
    device = clip_model.visual.proj.device

    def feature_fn(img) -> torch.Tensor:
        x = clip_normalize(((_as_image(img, device) + 1.0) * 0.5).clamp(0.0, 1.0)[None])
        with torch.no_grad(), true_fp32():
            if feature == "tokens":
                return clip_model.encode_image_tokens(x)[0]
            ps = clip_model.cfg.vision_patch_size
            patches = _conv(x, clip_model.visual.conv1.weight.permute(2, 3, 1, 0), stride=ps)
        return patches[0].reshape(-1, patches.shape[-1])

    return feature_fn
