"""Operators: the CUDA kernels' wrappers with their plain versions, resizing and image IO."""
