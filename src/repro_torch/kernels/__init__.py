"""Attention kernels of the port: hand-written CUDA for Hopper (`csrc/`),
their Python wrappers, and their plain PyTorch versions (`ref.py`)."""
