"""Acceleration-backend registry.

Mirrors the reference's set of ``IntrsHandler`` implementations
(``src/lib/handlers/mod.rs``): ``blank``, ``naive``, ``bvh``,
``rf_bvh`` — plus additions (``pbvh`` packet tracer, ``lbvh``
on-device build).
"""

from __future__ import annotations

from typing import Any, Callable

from rt_rs_tpu.handlers.base import IntrsHandler, IntrsStats

_REGISTRY: dict[str, Callable[..., IntrsHandler]] = {}


def register(name: str, factory: Callable[..., IntrsHandler]) -> None:
    _REGISTRY[name] = factory


def get_handler(name: str, **kwargs: Any) -> IntrsHandler:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown handler {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)


def _register_builtin() -> None:
    # Unconditional imports: every backend depends only on jax/numpy.
    # (Bring-up-era try/except here masked real import breakage as
    # "unknown handler" — a refactor typo in packet_trace.py would
    # silently drop pbvh from the registry.)
    from rt_rs_tpu.handlers.blank import BlankIntrs
    from rt_rs_tpu.handlers.bvh import BvhIntrs
    from rt_rs_tpu.handlers.lbvh import LbvhIntrs
    from rt_rs_tpu.handlers.naive import BasicIntrs
    from rt_rs_tpu.handlers.pbvh import PacketBvhIntrs
    from rt_rs_tpu.handlers.rf import RfBvhIntrs

    register("blank", BlankIntrs)
    register("naive", BasicIntrs)
    register("bvh", BvhIntrs)
    register("rf_bvh", RfBvhIntrs)
    register("pbvh", PacketBvhIntrs)
    register("lbvh", LbvhIntrs)


_register_builtin()

__all__ = [
    "IntrsHandler",
    "IntrsStats",
    "get_handler",
    "register",
    "available",
]
