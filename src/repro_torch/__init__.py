"""PyTorch + CUDA port of the CylonFlow dataframe engine (``repro``).

Same module layout as the JAX package; ranks are stacked along a leading
axis of every tensor on one device.  ``df`` is the lazy DataFrame
frontend, over numeric and dictionary-encoded string columns.  The
shuffle's bucketize and the groupby's sums run as hand-written Hopper
kernels (``kernels.radix_partition``, ``kernels.segmented_reduce``).  The
model stack serves the dense and SSM families (``models``, ``serve``,
``launch.serve``) with hand-written flash-attention and SSD-scan kernels,
and trains them (``train``, ``launch.train``) on batches that the §IV-C
preprocessing application (``data``) hands over through a ``CylonStore``.
Entry points run on ``cuda`` unless the caller asks for the CPU.  This
package imports neither ``jax`` nor ``repro``.
"""

from .core import CylonEnv, DistTable, Plan, execute
from .expr import col, lit

__all__ = ["CylonEnv", "DistTable", "Plan", "col", "execute", "lit"]
