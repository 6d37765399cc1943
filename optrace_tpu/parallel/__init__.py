"""Sharded execution over device meshes (SURVEY.md §2.10, §5).

The workload is embarrassingly parallel over rays; the only cross-shard
reductions are detector-tile accumulation, spectrum histograms, warning
counters and (in the differentiable path) parameter gradients — all psum.
"""

from .render import make_sharded_render, make_fused_render, default_mesh  # noqa: F401
from .checkpoint import RenderCheckpoint  # noqa: F401
