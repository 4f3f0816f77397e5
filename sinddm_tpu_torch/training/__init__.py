"""The multiscale trainer."""
