"""The pyramid sampler."""
