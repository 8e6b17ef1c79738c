"""bevformer-torch: BEVFormer inference in PyTorch with hand-written CUDA
kernels for Hopper (H100).

A port of the JAX package `bevformer_tpu`, which stays the reference. It
imports torch and numpy only. Each kernel wrapper in `kernels` runs its CUDA
kernel for a CUDA tensor and its plain PyTorch version for a CPU tensor.
"""

__version__ = "0.1.0"
