"""Compute kernels: vector math, stateless sampling, intersection, binning.

These are the device equivalents of the reference's vectorized-NumPy
hot paths (SURVEY.md §2.2, §2.4, §2.6) — pure jax functions designed to be
fused by XLA.
"""

from . import vector      # noqa: F401
from . import sampling    # noqa: F401
