"""The denoiser and the converter from the JAX package's parameters."""
