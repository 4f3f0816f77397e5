"""Host-side image operations: mask dilation and histogram matching (port of
``sinddm_tpu/ops/image.py``).

The JAX package builds these on ``scipy.ndimage``; the port imports numpy
only, so the two scipy calls are written out here:

* ``dilate_mask``: binary dilation with a disk (radius 7 for harmonization,
  20 for editing) as an OR of zero-padded shifted copies, one per offset of
  the disk; then scipy's ``gaussian_filter(sigma=5, mode="nearest",
  truncate=4.0)`` in float64, as two separable 41-tap passes (rows, then
  columns) over edge-padded copies, summed in scipy's order; then a min-max
  rescale.
* ``match_histograms``: per-channel quantile mapping, scikit-image's
  algorithm (unique values + CDF interpolation), as in the JAX package.

They run on the host before sampling and prepare constant inputs.
"""

from __future__ import annotations

import numpy as np

GAUSS_SIGMA, GAUSS_TRUNCATE = 5, 4.0


def disk(radius: int) -> np.ndarray:
    """Boolean disk structuring element (skimage.morphology.disk parity)."""
    y, x = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y) <= radius * radius


def _binary_dilation(m: np.ndarray, element: np.ndarray) -> np.ndarray:
    """``scipy.ndimage.binary_dilation(m, structure=element)`` for a
    symmetric, odd-sized element: outside the image counts as False."""
    r = element.shape[0] // 2
    h, w = m.shape
    padded = np.pad(m, r)
    out = np.zeros_like(m)
    for dy, dx in zip(*np.nonzero(element)):
        out |= padded[dy : dy + h, dx : dx + w]
    return out


def _gaussian_pass(m: np.ndarray, axis: int) -> np.ndarray:
    """``scipy.ndimage.gaussian_filter1d(m, GAUSS_SIGMA, axis, mode="nearest",
    truncate=GAUSS_TRUNCATE)`` on float64: the symmetric kernel summed as
    scipy's ``NI_Correlate1D`` sums it, the centre tap first, then each pair
    of taps from the outermost in."""
    radius = int(GAUSS_TRUNCATE * GAUSS_SIGMA + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (GAUSS_SIGMA * GAUSS_SIGMA) * x ** 2)
    phi = phi / phi.sum()
    m = np.moveaxis(m, axis, 0)
    n = m.shape[0]
    padded = np.pad(m, [(radius, radius)] + [(0, 0)] * (m.ndim - 1), mode="edge")
    out = padded[radius : radius + n] * phi[radius]
    for j in range(radius, 0, -1):
        out += (padded[radius - j : radius - j + n] + padded[radius + j : radius + j + n]) * phi[radius - j]
    return np.moveaxis(out, 0, axis)


def dilate_mask(mask_hwc: np.ndarray, mode: str = "harmonization") -> np.ndarray:
    """Dilate + feather a binary mask.

    Args:
      mask_hwc: [H, W, C] float mask in [0, 1] (channel 0 is used).
    Returns:
      [H, W, 1] float32 mask in [0, 1].
    """
    if mode == "harmonization":
        element = disk(7)
    elif mode == "editing":
        element = disk(20)
    else:
        raise ValueError(f"unknown dilate mode {mode!r}")
    m = np.asarray(mask_hwc)[:, :, 0]
    m = _binary_dilation(m.astype(bool), element).astype(np.float64)
    m = _gaussian_pass(_gaussian_pass(m, 0), 1)
    m = (m - m.min()) / (m.max() - m.min())
    return m[:, :, None].astype(np.float32)


def _match_channel(source: np.ndarray, template: np.ndarray) -> np.ndarray:
    """scikit-image _match_cumulative_cdf semantics for one channel."""
    src_values, src_unique_indices, src_counts = np.unique(
        source.ravel(), return_inverse=True, return_counts=True
    )
    tmpl_values, tmpl_counts = np.unique(template.ravel(), return_counts=True)
    src_quantiles = np.cumsum(src_counts) / source.size
    tmpl_quantiles = np.cumsum(tmpl_counts) / template.size
    interp = np.interp(src_quantiles, tmpl_quantiles, tmpl_values)
    return interp[src_unique_indices].reshape(source.shape)


def match_histograms(image: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching of [H, W, C] arrays (channel_axis=2),
    returned in ``image``'s dtype."""
    image = np.asarray(image)
    reference = np.asarray(reference)
    if image.shape[-1] != reference.shape[-1]:
        raise ValueError("channel count mismatch")
    out = np.empty_like(image, dtype=np.float64)
    for c in range(image.shape[-1]):
        out[..., c] = _match_channel(image[..., c], reference[..., c])
    return out.astype(image.dtype)
