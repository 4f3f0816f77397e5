"""The pyramid sampler and the applications built on it (CLIP modes, i2i, ROI)."""
