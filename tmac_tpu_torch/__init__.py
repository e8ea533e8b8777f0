"""PyTorch/CUDA port of the tmac_tpu inference engine.

The JAX package ``tmac_tpu`` is the reference; this package imports
nothing from it.  Kernels are hand-written CUDA for Hopper (``ops/cuda``),
built with nvcc at first use; on CPU tensors each kernel's wrapper runs
its plain PyTorch version.
"""

from tmac_tpu_torch.ops.qgemm import QuantizedTensor, qgemm

__all__ = ["QuantizedTensor", "qgemm"]
