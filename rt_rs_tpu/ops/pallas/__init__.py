"""Pallas kernels of the hot path, and the one place that picks their route.

Every ``pl.pallas_call`` in the package asks :func:`kernel_mode` how to
run: compiled through Triton on a GPU, or in the Pallas interpreter on
the CPU (the test suite).  No other platform has a route; asking on one
is an error rather than a silent fallback to the interpreter.
"""

from __future__ import annotations

import jax

TRITON = "triton"
INTERPRET = "interpret"


def kernel_mode(platform: str | None = None) -> str:
    """The kernel route for ``platform`` (default: JAX's default backend).

    ``"triton"`` on ``gpu`` (compiled Pallas through Triton) and
    ``"interpret"`` on ``cpu`` (the Pallas interpreter); any other
    platform raises."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return TRITON
    if platform == "cpu":
        return INTERPRET
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r} "
        "(supported: gpu -> Triton, cpu -> interpreter)"
    )
