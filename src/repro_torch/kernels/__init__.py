"""Hand-written Hopper kernels of the port, each beside its plain version.

Each kernel lives in ``<name>/``: the CUDA source (``<name>.cu``), its
``ctypes`` wrapper (``cuda.py``, which counts launches), the plain PyTorch
version (``ref.py``, and ``ops.ssd_scan_chunked`` for the SSD scan) and the
dispatcher (``ops.py``: the kernel for CUDA tensors, the plain version for
CPU tensors).  ``build.py`` compiles the sources with nvcc on first use.
On the model's path (flash attention, the SSD scan, radix partition) the
kernel is a PyTorch operator, ``torch.ops.repro_torch.<name>``, defined
in ``ops.py`` at import (nothing built): its CUDA implementation is the
wrapper, its fake implementation gives the outputs' shapes and raises the
launch's ``ValueError``s, and flash and the SSD scan register their FLOP
formulas, so the dry run (``launch/dryrun.py``) takes every call on fake
card tensors.  The segmented sum is off that path and stays a wrapper.

  radix_partition   shuffle bucketize (stable rank in bucket + histogram)
  segmented_reduce  groupby sum / count / size (segmented sum over runs)
  flash_attention   causal GQA attention forward (online softmax)
  ssd_scan          Mamba-2 SSD chunked scan (+ final state); its gradient
                    is the plain version's (``ssd_scan.ops.SsdScanKernel``)
"""

from .flash_attention import (attention_ref, flash_attention,
                              flash_attention_cuda)
from .radix_partition import (radix_partition, radix_partition_cuda,
                              radix_partition_ref)
from .segmented_reduce import (segmented_sum, segmented_sum_cuda,
                               segmented_sum_ref)
from .ssd_scan import (ssd_scan, ssd_scan_backward, ssd_scan_chunked,
                       ssd_scan_cuda, ssd_scan_ref)

#: every CUDA kernel wrapper of the port (each carries ``launches``)
CUDA_KERNELS = (radix_partition_cuda, segmented_sum_cuda,
                flash_attention_cuda, ssd_scan_cuda)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in CUDA_KERNELS:
        k.reset()


__all__ = ["CUDA_KERNELS", "attention_ref", "flash_attention",
           "flash_attention_cuda", "radix_partition", "radix_partition_cuda",
           "radix_partition_ref", "reset_launches", "segmented_sum",
           "segmented_sum_cuda", "segmented_sum_ref", "ssd_scan",
           "ssd_scan_backward", "ssd_scan_chunked", "ssd_scan_cuda",
           "ssd_scan_ref"]
