"""RF-BVH backend: reduced-footprint 16-byte nodes.

Parity with ``RfBvhIntrs`` (``src/lib/handlers/rf.rs``): the BVH is
built with ``target_item_count = 4`` (rf.rs:64), packed into the
16-byte record format of :mod:`rt_rs_tpu.bvh.rf` (f16 bounds, tagged
internal/leaf records, 8-slot u16 leaf payloads, interleaved), and the
reported footprint is ``16 B x records`` (rf.rs:216-219) — this is the
memory-vs-speed trade the reference study measures (pdf §4.1-4.2).

Unlike the plain ``bvh`` backend the RF *record format* does not
assume reordered prims (the reference's RF handler leaves
``scene.prims`` untouched); leaves address prims by id through the
payload slots, with 0 = empty (rf.rs:429-441).  The threaded backend
preserves that exactly.  The packet backend reorders the scene arrays
to leaf order internally (invisible to the format/footprint story, and
it avoids a per-call id remap); hit ids
are then leaf-space rows of the *returned* arrays, exactly like
``handlers/bvh.py``.

Traversal: the same stackless threaded walk as ``handlers/bvh.py``,
with two RF-specific differences — node bounds are the *unpacked f16*
values (so the f16 precision loss is honestly part of the measured
backend, exactly as in the reference's ``unpack2x16float`` path,
rf.rs:400-427), and leaf iteration reads prim ids from the payload
table instead of a contiguous range.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rt_rs_tpu.bvh import BvhData, build_bvh
from rt_rs_tpu.bvh.rf import RfData, pack_rf, unpack_rf
from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu.handlers.bvh import AUTO_BACKEND, _node_slab, packet_tiled_fn
from rt_rs_tpu.ops.intersect import tri_intersect_pairs
from rt_rs_tpu.ops.pallas.packet_trace import (
    TUNED_RAY_TILE,
    TUNED_TRI_CHUNK,
    build_tri_chunks,
    packet_closest_hit,
)
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import SceneArrays


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RfAccel:
    """Accel pytree for RfBvhIntrs: packed-record traversal arrays plus
    the optional packet chunk table (kept here, not on the handler
    instance, so one handler instance can serve multiple scenes)."""

    records: "RfArrays"
    chunks: object = None  # TriChunks | None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RfArrays:
    node_min: jax.Array  # [N, 3] float32 (f16-roundtripped, conservative)
    node_max: jax.Array  # [N, 3]
    hit_link: jax.Array  # [N] int32
    miss_link: jax.Array  # [N] int32
    payload: jax.Array  # [N * 8] int32 prim ids (+1 space; 0 = empty)
    leaf_count: jax.Array  # [N] int32
    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    footprint: int = dataclasses.field(metadata=dict(static=True))


class RfBvhIntrs(IntrsHandler):
    name = "RF-BVH"

    def __init__(
        self,
        eps: float = 0.02,
        target_item_count: int = 4,
        backend: str = "auto",
        refine: str = "bounces",
    ):
        """``RfBvhConfig`` parity: ``Eps(f32)`` or default eps = 0.02
        (rf.rs:16-19, 30-37); the item count is fixed at 4 in the
        reference (rf.rs:64) but exposed here for experiments.

        ``backend``: ``"threaded"`` walks the packed records with the
        f16 bounds (the format-faithful path), ``"packet"`` routes
        intersection through the packet tracer over leaf-reordered
        scene arrays (identical images; the packed records still define
        footprint + structure), ``"auto"`` is ``bvh.AUTO_BACKEND``."""
        self.eps = eps
        self.target_item_count = target_item_count
        self.backend = backend
        self.bvh_data: BvhData | None = None
        self.rf_data: RfData | None = None
        # Per-ray cull refinement policy for the packet backend
        # ("off"/"bounces"/"all" — see PacketBvhIntrs).
        if refine not in ("off", "bounces", "all"):
            raise ValueError(f"unknown refine mode {refine!r}")
        self.refine = refine

    @property
    def block_lanes(self) -> int:
        """Rays per packet tile when the packet backend is active; the
        Renderer sizes its pixel-block swizzle to it (harmless for the
        threaded fallback, which is order-invariant)."""
        return TUNED_RAY_TILE

    def build(self, scene: Scene, arrays: SceneArrays):
        data = build_bvh(
            scene, eps=self.eps, target_item_count=self.target_item_count
        )
        self.bvh_data = data
        cover_min, cover_max = data.cover_bounds(scene)
        rf = pack_rf(data, cover_min, cover_max)
        self.rf_data = rf

        # Unpack through the 16-byte format so traversal sees exactly
        # the f16 bounds + payload ids the packed records hold.
        un = unpack_rf(rf)
        # Map record-space rows back to node space (skip payload rows).
        node_rows = np.where(~un["is_payload"])[0]
        assert node_rows.size == data.num_nodes
        bmin = un["bmin"][node_rows]
        bmax = un["bmax"][node_rows]
        payload = un["leaf_prims"][node_rows]  # [N, 8]

        if self.backend not in ("auto", "packet", "threaded"):
            raise ValueError(f"unknown rf_bvh backend {self.backend!r}")
        backend = AUTO_BACKEND if self.backend == "auto" else self.backend
        chunks = None
        if backend == "packet":
            from rt_rs_tpu.handlers.bvh import reorder_scene_arrays

            # Leaf-reorder the scene arrays (internal to the packet
            # path; the RF records/footprint are unaffected) so the
            # chunk-space ids ARE the scene-array rows — no per-call
            # remap gathers.
            arrays = reorder_scene_arrays(arrays, data.indices)
            chunks = build_tri_chunks(
                arrays.pa, arrays.pb, arrays.pc, tri_chunk=TUNED_TRI_CHUNK
            )

        hit_link, miss_link = data.escape_links()
        records = RfArrays(
            node_min=jnp.asarray(bmin),
            node_max=jnp.asarray(bmax),
            hit_link=jnp.asarray(hit_link),
            miss_link=jnp.asarray(miss_link),
            payload=jnp.asarray(payload.reshape(-1).astype(np.int32)),
            leaf_count=jnp.asarray(data.item_count.astype(np.int32)),
            num_nodes=data.num_nodes,
            footprint=rf.byte_size(),
        )
        accel = RfAccel(records=records, chunks=chunks)
        # arrays are leaf-reordered iff the packet backend is active;
        # the threaded path keeps rf.rs's untouched prim order.
        return accel, arrays

    def stats(self, accel: RfAccel) -> IntrsStats:
        return IntrsStats(name="RF-BVH", size=accel.records.footprint)

    def intersect_fn(self, accel: RfAccel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.chunks is not None:
            # arrays were leaf-reordered in build(), so chunk-space ids
            # line up with the scene arrays — excl/pid need no remap.
            return partial(
                packet_closest_hit,
                accel.chunks,
                t_min=cfg.t_min,
                t_max=cfg.t_max,
                eps=cfg.eps,
                ray_tile=TUNED_RAY_TILE,
            )
        return partial(
            _rf_intersect,
            accel.records,
            arrays.pa,
            arrays.pb,
            arrays.pc,
            t_min=cfg.t_min,
            t_max=cfg.t_max,
            eps=cfg.eps,
        )

    def intersect_tiled_fn(
        self, accel: RfAccel, arrays: SceneArrays, cfg: ComputeConfig
    ):
        if accel.chunks is not None:
            return packet_tiled_fn(accel.chunks, cfg, self.refine)
        return super().intersect_tiled_fn(accel, arrays, cfg)

    def intersect_tiled_anyhit_fn(
        self, accel: RfAccel, arrays: SceneArrays, cfg: ComputeConfig
    ):
        if accel.chunks is None:
            return None
        return packet_tiled_fn(accel.chunks, cfg, self.refine, any_hit=True)


def _rf_intersect(
    accel: RfArrays,
    pa: jax.Array,
    pb: jax.Array,
    pc: jax.Array,
    o: jax.Array,
    d: jax.Array,
    excl: jax.Array,
    valid: jax.Array,
    t_cap: jax.Array | None = None,
    *,
    t_min: float,
    t_max: float,
    eps: float,
):
    """Threaded traversal with payload-table leaf lookup (see
    handlers/bvh.py for the cursor scheme)."""
    n = o.shape[0]
    end = accel.num_nodes
    miss_t = jnp.float32(t_max + 1.0)
    inv_d = 1.0 / d

    def cond(state):
        idx, leaf_left, _, _, _ = state
        return jnp.any((idx < end) | (leaf_left > 0))

    def body(state):
        idx, leaf_left, leaf_ptr, best_t, best_id = state

        testing = leaf_left > 0
        pid = accel.payload[jnp.where(testing, leaf_ptr, 0)]
        on = testing & (pid != excl) & (pid != 0)
        pid_safe = jnp.where(on, pid, 0)
        t = tri_intersect_pairs(
            o, d, pa[pid_safe], pb[pid_safe], pc[pid_safe],
            t_min=t_min, t_max=t_max, eps=eps,
        )
        better = on & (t > t_min) & (t < t_max) & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_id = jnp.where(better, pid_safe, best_id)
        leaf_ptr = jnp.where(testing, leaf_ptr + 1, leaf_ptr)
        leaf_left = jnp.where(testing, leaf_left - 1, leaf_left)

        stepping = (~testing) & (idx < end)
        safe = jnp.where(stepping, idx, 0)
        near, far = _node_slab(
            o, inv_d, accel.node_min[safe], accel.node_max[safe]
        )
        hit = stepping & (near <= far) & (far >= t_min) & (near <= best_t)

        count = accel.leaf_count[safe]
        enter_leaf = hit & (count > 0)
        leaf_left = jnp.where(enter_leaf, count, leaf_left)
        leaf_ptr = jnp.where(enter_leaf, safe * 8, leaf_ptr)

        nxt = jnp.where(hit, accel.hit_link[safe], accel.miss_link[safe])
        idx = jnp.where(stepping, nxt, idx)
        return idx, leaf_left, leaf_ptr, best_t, best_id

    # Carries derive from inputs (shard_map axis-varyingness).
    zero_i = jnp.zeros_like(d[:, 0], dtype=jnp.int32)
    init = (
        jnp.where(valid, 0, end).astype(jnp.int32) + zero_i,
        zero_i,
        zero_i,
        jnp.full_like(d[:, 0], miss_t),
        zero_i,
    )
    _, _, _, best_t, best_id = jax.lax.while_loop(cond, body, init)
    return best_t, best_id
