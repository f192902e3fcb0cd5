"""CUDA kernels (csrc/), their build step and PyTorch wrappers."""
