"""LBVH backend: fully on-device build.

No reference counterpart — the reference always builds its BVH on the
CPU (``src/lib/bvh/aabb.rs``).  This backend sorts primitives by Morton
code and chunks them for the packet tracer entirely with device ops, so
acceleration "construction" is part of the jitted computation:

* static scenes: build once at handler setup (device);
* dynamic scenes: :func:`build_accel_device` is jit-traceable — call it
  inside the frame step with updated vertex positions for a true
  per-frame rebuild/refit (see ``tests/test_lbvh.py`` and
  ``rt_rs_tpu.renderer.DynamicRenderer``).

The sorted order plays the role of the reference's leaf-contiguous
reorder (``bvh.rs:103-110``); Morton-adjacent prims are spatially local
so the packet chunks stay tight.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu.ops.lbvh import morton_codes, morton_order
from rt_rs_tpu.ops.pallas.packet_trace import (
    TUNED_RAY_TILE,
    TUNED_TRI_CHUNK,
    TriChunks,
    build_tri_chunks,
    chunk_footprint,
    packet_closest_hit,
    packet_closest_hit_tiled,
    tag_refine,
)
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import SceneArrays


def build_accel_device(
    arrays: SceneArrays,
    tri_chunk: int = TUNED_TRI_CHUNK,
) -> tuple[TriChunks, SceneArrays]:
    """On-device LBVH 'build': Morton-sort the prims, permute the scene
    arrays, chunk.  Jit-traceable; call per frame for dynamic scenes."""
    pa, pb, pc = arrays.pa[1:], arrays.pb[1:], arrays.pc[1:]
    third = jnp.float32(1.0 / 3.0)
    cent = (pa + pb + pc) * third
    lo = jnp.min(jnp.minimum(jnp.minimum(pa, pb), pc), axis=0)
    hi = jnp.max(jnp.maximum(jnp.maximum(pa, pb), pc), axis=0)
    codes = morton_codes(cent, lo, hi)
    order = morton_order(codes)  # [P]

    perm = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), order.astype(jnp.int32) + 1]
    )
    arrays = dataclasses.replace(
        arrays,
        prim_mat=arrays.prim_mat[perm],
        pa=arrays.pa[perm],
        pb=arrays.pb[perm],
        pc=arrays.pc[perm],
        na=arrays.na[perm],
        nb=arrays.nb[perm],
        nc=arrays.nc[perm],
        shade_table=arrays.shade_table[perm],
    )
    chunks = build_tri_chunks(
        arrays.pa, arrays.pb, arrays.pc, tri_chunk=tri_chunk
    )
    return chunks, arrays


class LbvhIntrs(IntrsHandler):
    """Static-scene LBVH handler on the tuned packet configuration: the
    same tiled and any-hit entries as the pbvh handler, so the
    Renderer's fast paths apply unchanged."""

    name = "LBVH"

    def __init__(
        self,
        tri_chunk: int | None = None,
        ray_tile: int | None = None,
        refine: str = "bounces",
    ):
        self.tri_chunk = (
            TUNED_TRI_CHUNK if tri_chunk is None else tri_chunk
        )
        self.ray_tile = TUNED_RAY_TILE if ray_tile is None else ray_tile
        # Per-ray cull refinement for divergent secondary batches —
        # same policy knob as PacketBvhIntrs ("off"/"bounces"/"all").
        if refine not in ("off", "bounces", "all"):
            raise ValueError(f"unknown refine mode {refine!r}")
        self.refine = refine

    @property
    def block_lanes(self) -> int:
        """Rays per packet tile (sizes the Renderer's pixel-block)."""
        return self.ray_tile

    def build(self, scene: Scene, arrays: SceneArrays):
        return jax.jit(
            partial(build_accel_device, tri_chunk=self.tri_chunk)
        )(arrays)

    def stats(self, accel: TriChunks) -> IntrsStats:
        return IntrsStats(name="LBVH", size=chunk_footprint(accel))

    def intersect_fn(self, accel: TriChunks, arrays: SceneArrays, cfg: ComputeConfig):
        return partial(
            packet_closest_hit,
            accel,
            t_min=cfg.t_min,
            t_max=cfg.t_max,
            eps=cfg.eps,
            ray_tile=self.ray_tile,
        )

    def _tiled(self, accel, cfg: ComputeConfig, **fixed):
        return tag_refine(
            partial(
                packet_closest_hit_tiled,
                accel,
                t_min=cfg.t_min,
                t_max=cfg.t_max,
                eps=cfg.eps,
                **fixed,
            ),
            self.refine,
        )

    def intersect_tiled_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        return self._tiled(accel, cfg)

    def intersect_tiled_anyhit_fn(self, accel, arrays, cfg: ComputeConfig):
        return self._tiled(accel, cfg, any_hit=True)
