"""PyTorch/CUDA port of the JAX package `repro`, for one NVIDIA H100.

The port imports `torch` and nothing of JAX or of the JAX package. Its
entry points (`build_model`, `init_params`, `init_cache`, `ServeEngine`)
run on the card unless the caller passes `device="cpu"`; on the CPU every
kernel is replaced by its plain PyTorch version (`kernels/ref.py`).
"""
