"""sinddm_tpu_torch — SinDDM training and sampling (plain, CLIP-guided, image-to-image, ROI) in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``sinddm_tpu`` (which stays the reference).
Module names mirror the JAX package's, so each counterpart is easy to
find. Layout is NHWC at every public function, as in the JAX package.
Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
pass ``device="cpu"`` to run the plain-PyTorch versions of the kernels.

This package imports ``torch``, numpy and the standard library only (PIL
lazily, where images are read or written), never JAX or ``sinddm_tpu``.
"""

__version__ = "0.1.0"
