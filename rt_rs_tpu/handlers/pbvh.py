"""Packet-BVH backend: the flagship path (Pallas packet kernel).

Functionally equivalent to the ``bvh`` backend (same BVH build, same
leaf reorder, same closest-hit semantics — verified against ``naive``
in ``tests/test_pbvh.py``), but intersection runs through
:mod:`rt_rs_tpu.ops.pallas.packet_trace`: conservative interval culling
of leaf-ordered triangle chunks per ray tile, then a loop over each
tile's compacted chunk list (the Pallas kernel, or its plain ``lax``
twin).

The ``bvh`` handler remains the reference-parity backend (stackless
threaded traversal, and the loader for precomputed ``*.bvh.json``
checkpoints).
"""

from __future__ import annotations

from functools import partial

from rt_rs_tpu.bvh import BvhData, build_bvh
from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu.handlers.bvh import reorder_scene_arrays
from rt_rs_tpu.ops.pallas.packet_trace import (
    TUNED_RAY_TILE as DEFAULT_RAY_TILE,
    TUNED_TRI_CHUNK as DEFAULT_TRI_CHUNK,
    DualTriChunks,
    build_tri_chunks,
    chunk_footprint,
    flat_table,
    packet_closest_hit,
    packet_closest_hit_tiled,
    tag_refine,
)
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import SceneArrays


class PacketBvhIntrs(IntrsHandler):
    name = "Packet-BVH"

    def __init__(
        self,
        eps: float = 0.02,
        target_item_count: int = 2,
        data: BvhData | None = None,
        path: str | None = None,
        cull_block: int | None = None,
        ray_tile: int | None = None,
        tri_chunk: int | None = None,
        tri_chunk_fine: int | None = None,
        refine: str = "bounces",
        loop: str = "kernel",
    ):
        """``refine``: per-ray cull refinement policy —
        "bounces" (default) lets trace_tiled enable it on
        secondary/shadow batches, where tile-interval culling collapses
        under ray divergence; "all" forces it on every call; "off"
        disables it.  ``tri_chunk_fine`` adds a second, finer chunk
        table that serves the refined batches (see DualTriChunks).
        ``loop`` picks the chunk loop: "kernel" (Pallas) or "lax"."""
        self.eps = eps
        self.target_item_count = target_item_count
        self._data = data
        if path is not None:
            self._data = BvhData.load(path)
        self.cull_block = cull_block
        self.ray_tile = ray_tile
        self.tri_chunk = tri_chunk
        self.tri_chunk_fine = tri_chunk_fine
        if refine not in ("off", "bounces", "all"):
            raise ValueError(f"unknown refine mode {refine!r}")
        self.refine = refine
        if loop not in ("kernel", "lax"):
            raise ValueError(f"unknown chunk loop {loop!r}")
        self.loop = loop
        self.bvh_data: BvhData | None = self._data

    @property
    def block_lanes(self) -> int:
        """Rays per packet tile — the Renderer sizes its pixel-block
        swizzle to put exactly one 2-D block in each tile."""
        return DEFAULT_RAY_TILE if self.ray_tile is None else self.ray_tile

    def build(self, scene: Scene, arrays: SceneArrays):
        data = self._data
        if data is None:
            data = build_bvh(
                scene, eps=self.eps, target_item_count=self.target_item_count
            )
        self.bvh_data = data
        arrays = reorder_scene_arrays(arrays, data.indices)
        tri_chunk = (
            DEFAULT_TRI_CHUNK if self.tri_chunk is None else self.tri_chunk
        )
        chunks = build_tri_chunks(
            arrays.pa, arrays.pb, arrays.pc, tri_chunk=tri_chunk
        )
        if self.tri_chunk_fine is None:
            return chunks, arrays
        fine = build_tri_chunks(
            arrays.pa, arrays.pb, arrays.pc, tri_chunk=self.tri_chunk_fine
        )
        return DualTriChunks(coarse=chunks, fine=fine), arrays

    def stats(self, accel) -> IntrsStats:
        return IntrsStats(name="Packet-BVH", size=chunk_footprint(accel))

    def _kwargs(self, cfg: ComputeConfig) -> dict:
        kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps, loop=self.loop)
        if self.cull_block is not None:
            kw["cull_block"] = self.cull_block
        return kw

    def intersect_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        return partial(
            packet_closest_hit,
            flat_table(accel),  # the AoS adapter has no refine split
            ray_tile=self.block_lanes,
            **self._kwargs(cfg),
        )

    def _tiled(self, accel, cfg: ComputeConfig, **fixed):
        kw = dict(self._kwargs(cfg), **fixed)
        if not isinstance(accel, DualTriChunks):
            return tag_refine(
                partial(packet_closest_hit_tiled, accel, **kw), self.refine
            )
        # Refine-keyed table dispatch: primaries (refine=False) sweep the
        # coarse table, per-ray-refined bounce/shadow batches the fine
        # one (bit-consistent — see DualTriChunks).
        coarse = partial(packet_closest_hit_tiled, accel.coarse, **kw)
        fine = partial(packet_closest_hit_tiled, accel.fine, **kw)

        def fn(payload, valid, t_cap=None, refine=False, **call_kw):
            tbl = fine if refine else coarse
            return tbl(payload, valid, t_cap, refine=refine, **call_kw)

        return tag_refine(fn, self.refine)

    def intersect_tiled_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        return self._tiled(accel, cfg)

    def intersect_tiled_anyhit_fn(self, accel, arrays, cfg: ComputeConfig):
        return self._tiled(accel, cfg, any_hit=True)
