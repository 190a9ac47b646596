"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``kernels/fused/`` holds the producer kernels with a PWL epilogue;
:mod:`.ops` the standalone PWL activation (non-uniform and uniform, kernels
in :mod:`.pwl_act`) and :mod:`.ref` its plain oracles.  The CUDA sources are
in ``repro_torch/csrc/`` and are built by :mod:`._build` at first use on a
CUDA host.
"""
