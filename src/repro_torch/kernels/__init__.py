"""Hand-written Hopper kernels of the port, each beside its plain version.

Each kernel lives in ``<name>/``: the CUDA source (``<name>.cu``), its
``ctypes`` wrapper (``cuda.py``, which counts launches), the plain PyTorch
version (``ref.py``) and the dispatcher (``ops.py``: the kernel for CUDA
tensors, the plain version for CPU tensors).  ``build.py`` compiles the
sources with nvcc on first use.

  radix_partition   shuffle bucketize (stable rank in bucket + histogram)

The JAX package's other Pallas kernels (segmented_sum, flash_attention,
ssd_scan) are not on this port's path yet.
"""

from .radix_partition import (radix_partition, radix_partition_cuda,
                              radix_partition_ref)

#: every CUDA kernel wrapper of the port (each carries ``launches``)
CUDA_KERNELS = (radix_partition_cuda,)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in CUDA_KERNELS:
        k.launches = 0


__all__ = ["CUDA_KERNELS", "radix_partition", "radix_partition_cuda",
           "radix_partition_ref", "reset_launches"]
