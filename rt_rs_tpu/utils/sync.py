"""Host<->device synchronization for timing.

The reference measures pure GPU compute-pass time with timestamp
queries (``src/lib/timing.rs:221-300``).  JAX dispatches asynchronously,
so every timed region ends by waiting for its result.
"""

from __future__ import annotations


def device_sync(x) -> None:
    """Block the host until ``x`` (an array or pytree) has been computed."""
    import jax

    jax.block_until_ready(x)
