"""Optimizers of the port, and the compressed gradient all-reduce."""
