"""Tracing and timing hooks."""
