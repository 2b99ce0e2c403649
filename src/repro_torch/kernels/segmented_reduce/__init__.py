from .cuda import segmented_sum_cuda
from .ops import segmented_sum
from .ref import segmented_sum_ref

__all__ = ["segmented_sum", "segmented_sum_cuda", "segmented_sum_ref"]
