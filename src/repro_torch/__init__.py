"""PyTorch + CUDA port of the CylonFlow dataframe engine (``repro``).

Same module layout as the JAX package; ranks are stacked along a leading
axis of every tensor on one device, and the shuffle's bucketize runs as a
hand-written Hopper kernel (``kernels.radix_partition``).  The model stack
serves the dense and SSM families (``models``, ``serve``,
``launch.serve``) with hand-written flash-attention and SSD-scan kernels.
Entry points run on ``cuda`` unless the caller asks for the CPU.  This
package imports neither ``jax`` nor ``repro``.
"""

from .core import CylonEnv, DistTable, Plan, execute
from .expr import col, lit

__all__ = ["CylonEnv", "DistTable", "Plan", "col", "execute", "lit"]
