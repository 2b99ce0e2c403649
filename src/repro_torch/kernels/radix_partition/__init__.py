from .cuda import radix_partition_cuda
from .ops import radix_partition
from .ref import (radix_partition_blocked, radix_partition_dense,
                  radix_partition_ref)

__all__ = ["radix_partition", "radix_partition_blocked",
           "radix_partition_cuda", "radix_partition_dense",
           "radix_partition_ref"]
