"""Kernels of the port (attention, grouped expert matmul, SSD scan):
hand-written CUDA for Hopper (`csrc/`), their Python wrappers, and their
plain PyTorch versions (`ref.py`)."""
