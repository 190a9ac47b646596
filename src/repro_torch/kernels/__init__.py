"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``kernels/fused/`` holds the producer kernels with a PWL epilogue; the CUDA
sources are in ``repro_torch/csrc/`` and are built by :mod:`._build` at
first use on a CUDA host.
"""
