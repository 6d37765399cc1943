"""Host/device array-namespace dispatch.

Small evaluation helpers (index models, spectra, observers, illuminants)
are called both inside jit (traced/device inputs — must stay jnp) and
host-side during scene building, catalog loading and import-time preset
construction (plain numpy/python inputs). Routing host inputs through
numpy keeps scene building free of device dispatches: each tiny device op
costs a dispatch plus one XLA compile per distinct shape, which thousands
of small evaluations during a scene build would pay.
"""

import jax
import numpy as np
import jax.numpy as jnp


def is_device(*vals) -> bool:
    """True when any input is a jax array or tracer."""
    return any(isinstance(v, (jax.Array, jax.core.Tracer)) for v in vals)


def get_xp(*vals):
    """jnp when any input is traced/on-device, else numpy."""
    return jnp if is_device(*vals) else np
