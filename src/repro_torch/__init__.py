"""repro_torch: Flex-SFU (non-uniform PWL activation approximation) in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The PyTorch port of the JAX/Pallas package ``repro``.  It keeps that
package's layout (``core/``, ``sfu/``, ``kernels/fused/``, ``models/``,
``configs/``, ``serving/``, ``launch/``) and its tensor layouts at public
functions, and imports nothing of it.

Every kernel wrapper takes its plain PyTorch version for a tensor on the
CPU and launches its CUDA kernel for a tensor on a GPU; there is no
fallback between the two.  Entry points run on ``cuda`` unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"
