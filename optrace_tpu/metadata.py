"""Package metadata (role of reference optrace/metadata.py)."""

name = "optrace_tpu"
version = "0.1.0"
__version__ = version
author = "optrace_tpu developers"
license = "MIT"
documentation = "README.md"
description = ("Differentiable sequential raytracing, spectral "
               "image rendering and optical analysis built on JAX/XLA")
