"""Brute-force backend: every ray tests every primitive.

Parity with ``BasicIntrs`` (``src/lib/handlers/basic.rs:81-106``): a
linear pass over all prims, skipping the null sentinel and the excluded
prim, keeping the strictly-closest hit in the open
``(t_min, t_max)`` window.

Design: rather than a per-ray loop, the batch streams prim chunks
through a ``lax.scan`` of all-pairs Möller–Trumbore lattices
(``rt_rs_tpu.ops.intersect.closest_hit_bruteforce``) — elementwise work
with no gathers and no divergence.
"""

from __future__ import annotations

from functools import partial
from typing import Any

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu.ops.intersect import closest_hit_bruteforce
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import SceneArrays


class BasicIntrs(IntrsHandler):
    name = "Naive"

    def __init__(self, chunk: int = 128):
        self.chunk = chunk

    def build(self, scene: Scene, arrays: SceneArrays):
        return None, arrays

    def stats(self, accel: Any) -> IntrsStats:
        return IntrsStats(name="Naive", size=0)

    def intersect_fn(self, accel, arrays, cfg: ComputeConfig):
        return partial(
            _naive_intersect,
            arrays.pa,
            arrays.pb,
            arrays.pc,
            t_min=cfg.t_min,
            t_max=cfg.t_max,
            eps=cfg.eps,
            chunk=self.chunk,
        )


def _naive_intersect(pa, pb, pc, o, d, excl, valid, t_cap=None, *, t_min, t_max, eps, chunk):
    return closest_hit_bruteforce(
        o, d, pa, pb, pc, excl, t_min=t_min, t_max=t_max, eps=eps, chunk=chunk
    )
