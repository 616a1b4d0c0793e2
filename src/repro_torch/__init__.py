"""PyTorch/CUDA port of the MoSKA system (``repro``'s counterpart).

Mirrors the reference package's module names. Plain tensor code is
PyTorch; the Pallas kernels of the main path are hand-written CUDA kernels
for Hopper (``kernels/csrc``), launched for CUDA tensors, with plain
PyTorch versions for CPU tensors (``kernels/ref.py``).
"""
