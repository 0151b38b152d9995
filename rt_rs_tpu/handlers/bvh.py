"""BVH backend: flat-array bounding volume hierarchy.

Parity with ``BvhIntrs`` (``src/lib/handlers/bvh.rs``):

* configuration mirrors ``BvhConfig`` — precomputed checkpoint bytes /
  runtime ``eps`` / defaults (``bvh.rs:12-16``, default ``eps = 0.02``,
  ``target_item_count = 2``, ``bvh.rs:31-39, 82``);
* the scene's primitive arrays are reordered so every leaf's triangles
  are contiguous (``bvh.rs:103-110``);
* the 48-byte-per-node footprint is reported via stats
  (``bvh.rs:160-163``).

Data-parallel redesign of the traversal: the reference shader walks the
tree with a per-thread private stack sized to the *node count*
(``bvh.rs:168-187, 303-350``).  Here traversal is **stackless and
threaded**: the preorder flatten yields ``hit_link``/``miss_link``
escape indices (see ``rt_rs_tpu.bvh.BvhData.escape_links``), so each
ray carries a single monotonically-increasing node cursor.  The whole
ray batch steps in lockstep inside one ``lax.while_loop`` — no stack
memory, no divergent push/pop, static shapes throughout.

Two deliberate behavior fixes vs the reference (see PARITY.md):

* the reference's slab test neutralizes its own y/z constraints via
  ``min(…, -1e38)`` / ``max(…, +1e38)`` (``bvh.rs:258-265``) and
  therefore never culls a node; ours culls correctly (identical
  images, orders of magnitude faster);
* the reference indexes leaf prims off-by-one into the GPU prim buffer
  (it uploads prims *before* the leaf reorder, ``state/mod.rs:328`` vs
  ``:362``, and ignores the +1 shift of the null sentinel); ours
  accounts for the sentinel.
"""

from __future__ import annotations

import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rt_rs_tpu.bvh import BvhData, build_bvh
from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu.ops.intersect import tri_intersect_pairs
from rt_rs_tpu.ops.pallas.packet_trace import (
    TUNED_RAY_TILE,
    TUNED_TRI_CHUNK,
    build_tri_chunks,
    packet_closest_hit,
    packet_closest_hit_tiled,
    tag_refine,
)
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import SceneArrays


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BvhArrays:
    """Device-resident flattened BVH (the group(3) bind equivalent)."""

    node_min: jax.Array  # [N, 3] float32
    node_max: jax.Array  # [N, 3] float32
    hit_link: jax.Array  # [N] int32 (leaf -> escape, interior -> fst)
    miss_link: jax.Array  # [N] int32 (escape; num_nodes = END)
    leaf_start: jax.Array  # [N] int32 first prim id (reordered, +1 for null)
    leaf_count: jax.Array  # [N] int32 (0 = interior)
    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    max_leaf: int = dataclasses.field(metadata=dict(static=True))
    max_depth: int = dataclasses.field(metadata=dict(static=True))
    footprint: int = dataclasses.field(metadata=dict(static=True))


def reorder_scene_arrays(arrays: SceneArrays, indices: np.ndarray) -> SceneArrays:
    """Apply the leaf-contiguous prim permutation (bvh.rs:103-110),
    keeping the null sentinel at row 0 and accounting for its +1
    offset (the fix of the reference's off-by-one)."""
    perm = np.concatenate([[0], np.asarray(indices, dtype=np.int64) + 1])
    perm_j = jnp.asarray(perm)
    return dataclasses.replace(
        arrays,
        prim_mat=arrays.prim_mat[perm_j],
        pa=arrays.pa[perm_j],
        pb=arrays.pb[perm_j],
        pc=arrays.pc[perm_j],
        na=arrays.na[perm_j],
        nb=arrays.nb[perm_j],
        nc=arrays.nc[perm_j],
        shade_table=arrays.shade_table[perm_j],
    )


def accel_from_bvh_data(data: BvhData, scene: Scene) -> BvhArrays:
    hit_link, miss_link = data.escape_links()
    # Traverse on recomputed covering bounds, NOT the stored ones: the
    # reference's in-place shrink leaves stored bounds that don't cover
    # their subtree geometry (see BvhData.cover_bounds / PARITY.md).
    cover_min, cover_max = data.cover_bounds(scene)
    return BvhArrays(
        node_min=jnp.asarray(cover_min),
        node_max=jnp.asarray(cover_max),
        hit_link=jnp.asarray(hit_link),
        miss_link=jnp.asarray(miss_link),
        leaf_start=jnp.asarray(data.item_idx.astype(np.int32) + 1),
        leaf_count=jnp.asarray(data.item_count.astype(np.int32)),
        num_nodes=data.num_nodes,
        max_leaf=int(data.item_count.max()) if data.num_nodes else 0,
        max_depth=data.max_depth(),
        footprint=data.byte_size(),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BvhAccel:
    """Accel pytree for BvhIntrs: the node structure plus the optional
    packet chunk table (kept here, NOT on the handler instance, so one
    handler can serve multiple Renderers/scenes safely)."""

    nodes: BvhArrays
    chunks: object = None  # TriChunks | None


# What ``backend="auto"`` means for ``bvh`` and ``rf_bvh``: the
# threaded XLA traversal or the packet tracer over the same leaf order.
# Chosen by frame time on an NVIDIA H100 (PERF.md).
AUTO_BACKEND = "packet"


class BvhIntrs(IntrsHandler):
    name = "BVH"

    def __init__(
        self,
        eps: float = 0.02,
        target_item_count: int = 2,
        data: BvhData | None = None,
        path: str | None = None,
        backend: str = "auto",
        refine: str = "bounces",
    ):
        """``BvhConfig`` parity: ``path``/``data`` = ``Bytes`` (a
        precomputed checkpoint, bvh.rs:54-64), ``eps`` = ``Runtime``,
        neither = ``Default``.

        ``backend``: ``"threaded"`` (the stackless link walk in plain
        XLA), ``"packet"`` (route intersection through the packet tracer
        over the SAME leaf-ordered prims — the BVH/checkpoint still
        supplies the ordering), or ``"auto"`` (``AUTO_BACKEND``).

        ``refine``: per-ray cull refinement policy for the packet
        backend ("off"/"bounces"/"all" — see PacketBvhIntrs)."""
        self.eps = eps
        self.target_item_count = target_item_count
        self._data = data
        if path is not None:
            with open(path, "r") as f:
                self._data = BvhData.from_json(json.load(f))
        self.bvh_data: BvhData | None = self._data
        self.backend = backend
        if refine not in ("off", "bounces", "all"):
            raise ValueError(f"unknown refine mode {refine!r}")
        self.refine = refine

    def _use_packet(self) -> bool:
        if self.backend not in ("auto", "packet", "threaded"):
            raise ValueError(f"unknown bvh backend {self.backend!r}")
        backend = AUTO_BACKEND if self.backend == "auto" else self.backend
        return backend == "packet"

    @property
    def block_lanes(self) -> int:
        """Rays per packet tile when the packet backend is active; the
        Renderer sizes its pixel-block swizzle to it (harmless for the
        threaded fallback, which is order-invariant)."""
        return TUNED_RAY_TILE

    def build(self, scene: Scene, arrays: SceneArrays):
        data = self._data
        if data is None:
            data = build_bvh(
                scene, eps=self.eps, target_item_count=self.target_item_count
            )
        self.bvh_data = data
        nodes = accel_from_bvh_data(data, scene)
        arrays = reorder_scene_arrays(arrays, data.indices)
        chunks = None
        if self._use_packet():
            chunks = build_tri_chunks(
                arrays.pa, arrays.pb, arrays.pc, tri_chunk=TUNED_TRI_CHUNK
            )
        return BvhAccel(nodes=nodes, chunks=chunks), arrays

    def stats(self, accel: BvhAccel) -> IntrsStats:
        return IntrsStats(name="BVH", size=accel.nodes.footprint)

    def intersect_fn(self, accel: BvhAccel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.chunks is not None:
            return partial(
                packet_closest_hit,
                accel.chunks,
                t_min=cfg.t_min,
                t_max=cfg.t_max,
                eps=cfg.eps,
                ray_tile=TUNED_RAY_TILE,
            )
        return partial(
            _bvh_intersect,
            accel.nodes,
            arrays.pa,
            arrays.pb,
            arrays.pc,
            t_min=cfg.t_min,
            t_max=cfg.t_max,
            eps=cfg.eps,
        )

    def intersect_tiled_fn(
        self, accel: BvhAccel, arrays: SceneArrays, cfg: ComputeConfig
    ):
        if accel.chunks is not None:
            return packet_tiled_fn(accel.chunks, cfg, self.refine)
        return super().intersect_tiled_fn(accel, arrays, cfg)

    def intersect_tiled_anyhit_fn(
        self, accel: BvhAccel, arrays: SceneArrays, cfg: ComputeConfig
    ):
        if accel.chunks is None:
            return None
        return packet_tiled_fn(accel.chunks, cfg, self.refine, any_hit=True)


def packet_tiled_fn(chunks, cfg: ComputeConfig, refine: str, **fixed):
    """The packet tracer's tiled entry over ``chunks``, tagged with the
    refine policy — the packet backend of ``bvh`` and ``rf_bvh``."""
    return tag_refine(
        partial(
            packet_closest_hit_tiled,
            chunks,
            t_min=cfg.t_min,
            t_max=cfg.t_max,
            eps=cfg.eps,
            **fixed,
        ),
        refine,
    )


def _node_slab(o, inv_d, bmin, bmax):
    """Vector slab test vs per-ray node bounds [N, 3] -> (near, far).

    Conservative wobble: the reference's absolute ``EPS = 2e-6``
    (bvh.rs:246) plus a relative term so large scenes don't lose hits
    to f32 rounding (pure inflation — never culls a true hit)."""
    wob = 2e-6 + 1e-5 * jnp.maximum(jnp.abs(bmin), jnp.abs(bmax))
    t0 = (bmin - wob - o) * inv_d
    t1 = (bmax + wob - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    lo = jnp.where(jnp.isnan(lo), -jnp.inf, lo)
    hi = jnp.where(jnp.isnan(hi), jnp.inf, hi)
    return jnp.max(lo, axis=-1), jnp.min(hi, axis=-1)


def _bvh_intersect(
    accel: BvhArrays,
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
    """Threaded (stackless) BVH traversal over the whole ray batch.

    Per while-iteration a ray does exactly ONE unit of work: either
    advances its node cursor (slab test + link follow) or tests one
    prim of the leaf it last entered (a `leaf_left` countdown).  This
    keeps the compiled step small and uniform — total iterations =
    max over rays of (nodes visited + prims tested) — instead of
    unrolling worst-case leaf sizes into every step.
    """
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
        # --- leaf phase: test one prim for rays inside a leaf --------
        pid = leaf_ptr
        on = testing & (pid != excl)
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

        # --- node phase: rays not in a leaf advance their cursor -----
        stepping = (~testing) & (idx < end)
        safe = jnp.where(stepping, idx, 0)
        bmin = accel.node_min[safe]  # [N, 3]
        bmax = accel.node_max[safe]
        near, far = _node_slab(o, inv_d, bmin, bmax)
        # Cull: missed box, box entirely behind t_min, or box entirely
        # beyond the current best hit (ordered-traversal pruning).
        hit = stepping & (near <= far) & (far >= t_min) & (near <= best_t)

        count = accel.leaf_count[safe]
        enter_leaf = hit & (count > 0)
        leaf_left = jnp.where(enter_leaf, count, leaf_left)
        leaf_ptr = jnp.where(enter_leaf, accel.leaf_start[safe], leaf_ptr)

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
