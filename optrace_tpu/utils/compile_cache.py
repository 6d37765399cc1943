"""Persistent XLA compile cache location shared by the launchers."""

import os


def enable_compile_cache(checkout_dir: str) -> str:
    """Keep JAX's persistent compile cache in ``$JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads the variable itself), else in
    ``<checkout_dir>/.jax_cache``. Creates the directory; returns its path."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(checkout_dir, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    os.makedirs(path, exist_ok=True)
    return path
