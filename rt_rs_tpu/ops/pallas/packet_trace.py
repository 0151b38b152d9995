"""Packet ray tracing: ray tiles vs leaf-ordered triangle chunks.

This replaces the reference's per-thread BVH stack walk
(``src/lib/handlers/bvh.rs:303-350``) with a data-parallel cull plus a
short loop per ray tile:

* Primitives are kept in BVH leaf order (the reference's reorder,
  ``bvh.rs:103-110``) and grouped into *chunks* of ``tc`` consecutive
  triangles; consecutive leaves are spatially adjacent, so chunk AABBs
  stay tight.  The table is compact and component-major: ``[9, Nc*tc]``
  float32 (corner ``a``, edges ``e1 = b - a`` and ``e2 = c - a``), so the
  ``tc`` values of one component of one chunk are contiguous.
* Rays travel in *tiles* of ``r`` rays, component-major ``[8, T, r]``
  (ox, oy, oz, dx, dy, dz, exclusion id, occlusion cap).
* Which chunks a tile must test is decided outside the loop by
  conservative interval arithmetic (per-tile ray bounds vs chunk AABBs,
  a dense ``[T, Nc]`` mask in plain jitted JAX), then compacted into a
  per-tile ascending chunk list and a count.
* The loop over each tile's list runs either as the Pallas kernel
  (:func:`_packet_kernel`: one program per ``R`` rays of a tile, the
  running best hit in registers, chunks streamed from device memory;
  compiled through Triton on a GPU, interpreted on the CPU) or as the
  plain ``lax`` loop (:func:`_lax_chunk_loop`: one global loop over list
  position that gathers every tile's next chunk) — the reference the
  kernel is tested against.

Correctness: culling is conservative (interval bounds plus wobble cover
every ray in the tile; a chunk's AABB covers its triangles), so the loop
sees a superset of the prims any ray could hit, and the per-pair test is
the exact Möller–Trumbore of :mod:`rt_rs_tpu.ops.intersect`.  Both loops
keep the lexicographically smallest ``(t, prim id)`` — the naive loop's
first-strictly-smaller rule — so they agree with the ``naive`` backend
(``tests/test_pbvh.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from rt_rs_tpu.ops.pallas import INTERPRET, kernel_mode

NCOMP = 9  # a.xyz, e1.xyz, e2.xyz per triangle
RAY_TILE = 128  # default rays per tile of the AoS entry
TRI_CHUNK = 8  # default triangles per chunk of the table builder
# Handler defaults.  Chunk height and tile width set the cull
# granularity (one list entry per (tile, chunk) pair); the kernel's own
# launch shape below is independent of both.  Chosen on an NVIDIA H100
# (80 GB HBM3) at a 700 W power limit; see PERF.md.
TUNED_TRI_CHUNK = 64
TUNED_RAY_TILE = 256
# Kernel launch shape: rays per Triton program (a power of two dividing
# the tile width), triangles per inner step (a power of two dividing the
# chunk height), and Triton's warps and pipeline stages.  Chosen on an
# NVIDIA H100 (80 GB HBM3) at a 700 W power limit; see PERF.md.
RAYS_PER_PROGRAM = 128
TRIS_PER_STEP = 8
NUM_WARPS = 4
NUM_STAGES = 1
# Chunk counts are padded to a multiple of CHUNK_ALIGN so the cull can
# run at any block granularity dividing it.  Padded chunks have zero
# components (det = 0 -> always miss) and inverted bounds (culled).
CHUNK_ALIGN = 32
# Chunks per cull block (>1 = interval culling and the compaction
# argsort run at [T, Nc/CULL_BLOCK] granularity and the loop sweeps
# whole blocks).  1 = exact per-chunk culling.
CULL_BLOCK = 1
# Tiles per block of the per-ray cull's lax.map (bounds its [B, r, Nc]
# temporaries); ray-tile counts are padded to a multiple of it.
TILE_GROUP = 32
REFINE_SUB = 1  # default refine granularity: 1 = exact per-ray slabs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriChunks:
    """Leaf-ordered triangle soup in chunked, compact SoA layout.

    ``comp`` is ``[9, Nc * tc]`` float32: components (ax, ay, az, e1x,
    e1y, e1z, e2x, e2y, e2z) x triangle; chunk ``c`` is columns
    ``c*tc .. c*tc+tc-1``.  Edge vectors are precomputed (the reference
    recomputes them per ray per test, bvh.rs:206-207).

    ``bmin``/``bmax`` are ``[Nc, 3]`` chunk AABBs.  Triangle ``i`` of the
    table (column ``i``) has prim id ``i + 1`` (reordered, null-prefixed
    id space)."""

    comp: jax.Array  # [9, Nc * tc] float32
    bmin: jax.Array  # [Nc, 3] float32
    bmax: jax.Array  # [Nc, 3] float32
    num_chunks: int = dataclasses.field(metadata=dict(static=True))

    @property
    def tri_chunk(self) -> int:
        """Triangles per chunk."""
        return int(self.comp.shape[1]) // self.num_chunks


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DualTriChunks:
    """Two chunk tables over the SAME dense leaf order at different
    granularities: ``coarse`` (amortizes per-entry cost on coherent
    primaries) and ``fine`` (smaller tc — per-ray refine culls divergent
    bounce/shadow batches tighter per swept triangle).  Because packing
    is dense, a triangle's prim id (``1 + column``) is IDENTICAL in both
    tables and the per-(tri, ray) arithmetic does not depend on tc — so
    the dispatch choice (by the trace_tiled ``refine`` flag) is
    unobservable in outputs."""

    coarse: TriChunks
    fine: TriChunks


def build_tri_chunks(pa, pb, pc, tri_chunk: int = TRI_CHUNK) -> TriChunks:
    """Pack reordered prim corners into a chunk table (jit-traceable).

    Inputs are the per-prim corners INCLUDING the null sentinel row 0,
    which is excluded here.  The triangle count is padded to whole
    chunks and the chunk count to a multiple of ``CHUNK_ALIGN``; padded
    triangles are degenerate (never hit) and never enlarge bounds."""
    pa = jnp.asarray(pa, jnp.float32)[1:]
    pb = jnp.asarray(pb, jnp.float32)[1:]
    pc = jnp.asarray(pc, jnp.float32)[1:]
    p = pa.shape[0]
    nc = max(1, -(-p // tri_chunk))
    nc = -(-nc // CHUNK_ALIGN) * CHUNK_ALIGN
    pad = nc * tri_chunk - p

    def padz(x):
        return jnp.pad(x, ((0, pad), (0, 0)))

    pa_, pb_, pc_ = padz(pa), padz(pb), padz(pc)
    comp = jnp.concatenate([pa_, pb_ - pa_, pc_ - pa_], axis=1).T  # [9, P]

    big = jnp.float32(np.finfo(np.float32).max)
    tri_min = jnp.minimum(jnp.minimum(pa_, pb_), pc_)
    tri_max = jnp.maximum(jnp.maximum(pa_, pb_), pc_)
    if pad:
        real = (jnp.arange(nc * tri_chunk) < p)[:, None]
        tri_min = jnp.where(real, tri_min, big)
        tri_max = jnp.where(real, tri_max, -big)
    return TriChunks(
        comp=comp,
        bmin=tri_min.reshape(nc, tri_chunk, 3).min(axis=1),
        bmax=tri_max.reshape(nc, tri_chunk, 3).max(axis=1),
        num_chunks=nc,
    )


def chunk_footprint(accel) -> int:
    """Device bytes of a chunk table (components + bounds); Dual
    tables count both members."""
    if isinstance(accel, DualTriChunks):
        return chunk_footprint(accel.coarse) + chunk_footprint(accel.fine)
    return int(
        np.prod(accel.comp.shape) * 4 + np.prod(accel.bmin.shape) * 4 * 2
    )


def flat_table(accel, pad_multiple: int = 1) -> TriChunks:
    """The single chunk table behind an accel (Dual -> its coarse
    member, the fine table being a twin over the same id space), with
    never-hit chunks appended so the chunk count divides
    ``pad_multiple`` (the scene-parallel sharder needs equal slices)."""
    if isinstance(accel, DualTriChunks):
        accel = accel.coarse
    if not isinstance(accel, TriChunks):
        raise TypeError(f"no chunk table behind {type(accel).__name__}")
    nc = accel.num_chunks
    extra = -(-nc // pad_multiple) * pad_multiple - nc
    if extra == 0:
        return accel
    big = jnp.float32(np.finfo(np.float32).max)
    return TriChunks(
        comp=jnp.pad(accel.comp, ((0, 0), (0, extra * accel.tri_chunk))),
        bmin=jnp.concatenate([accel.bmin, jnp.full((extra, 3), big)]),
        bmax=jnp.concatenate([accel.bmax, jnp.full((extra, 3), -big)]),
        num_chunks=nc + extra,
    )


# ----------------------------------------------------------------------
# Conservative chunk culling (plain jitted JAX)


def _interval_mul(u_lo, u_hi, i_lo, i_hi):
    """Interval product bounds; NaN (0 * inf) resolves conservatively."""
    cands = [u_lo * i_lo, u_lo * i_hi, u_hi * i_lo, u_hi * i_hi]
    lo = cands[0]
    hi = cands[0]
    for c in cands[1:]:
        lo = jnp.minimum(lo, c)
        hi = jnp.maximum(hi, c)
    lo = jnp.where(jnp.isnan(lo), -jnp.inf, lo)
    hi = jnp.where(jnp.isnan(hi), jnp.inf, hi)
    return lo, hi


def chunk_overlap_mask_cm(
    o3: jax.Array,  # [3, T, r] component-major origins
    inv3: jax.Array,  # [3, T, r]
    ray_valid: jax.Array,  # [T, r] bool
    bmin: jax.Array,  # [Nc, 3]
    bmax: jax.Array,  # [Nc, 3]
    *,
    t_min: float,
    t_max: float,
    t_cap: jax.Array | None = None,  # [T, r] per-ray upper bound
) -> jax.Array:
    """Conservative [T, Nc] mask: False only if NO ray in the tile can
    hit the chunk's AABB within the t-window.  Each tile's rays are
    wrapped in one origin / inverse-direction interval box."""
    big = jnp.float32(3.0e38)
    v = ray_valid[None, :, :]
    o_lo = jnp.min(jnp.where(v, o3, big), axis=2).T  # [T, 3]
    o_hi = jnp.max(jnp.where(v, o3, -big), axis=2).T
    i_lo = jnp.min(jnp.where(v, inv3, big), axis=2).T
    i_hi = jnp.max(jnp.where(v, inv3, -big), axis=2).T

    wob = 2e-6 + 1e-5 * jnp.maximum(jnp.abs(bmin), jnp.abs(bmax))  # [Nc, 3]
    lo_b = bmin - wob
    hi_b = bmax + wob
    # Accumulate per axis to keep live temporaries at [T, Nc].
    n_tiles = o_lo.shape[0]
    near_lb = jnp.full((n_tiles, bmin.shape[0]), -jnp.inf, dtype=jnp.float32)
    far_ub = jnp.full((n_tiles, bmin.shape[0]), jnp.inf, dtype=jnp.float32)
    for ax in range(3):
        a_lo = lo_b[None, :, ax] - o_hi[:, None, ax]  # [T, Nc]
        a_hi = lo_b[None, :, ax] - o_lo[:, None, ax]
        b_lo = hi_b[None, :, ax] - o_hi[:, None, ax]
        b_hi = hi_b[None, :, ax] - o_lo[:, None, ax]
        il = i_lo[:, None, ax]
        ih = i_hi[:, None, ax]
        p0_lo, p0_hi = _interval_mul(a_lo, a_hi, il, ih)  # t0 bounds
        p1_lo, p1_hi = _interval_mul(b_lo, b_hi, il, ih)  # t1 bounds
        near_lb = jnp.maximum(near_lb, jnp.minimum(p0_lo, p1_lo))
        far_ub = jnp.minimum(far_ub, jnp.maximum(p0_hi, p1_hi))
    any_ray = jnp.any(ray_valid, axis=1)[:, None]
    # Padded chunks carry inverted bounds (min > max); the slab test
    # alone would NOT reject them (entry -inf / exit +inf), so cull
    # them explicitly.
    nonempty = jnp.all(bmin <= bmax, axis=-1)[None, :]  # [1, Nc]
    if t_cap is None:
        cap = jnp.float32(t_max)
    else:
        # A chunk entirely beyond every live ray's cap (its light, for
        # shadow rays) cannot matter; conservative: max over live rays.
        cap = jnp.minimum(
            jnp.max(jnp.where(ray_valid, t_cap, -jnp.inf), axis=1),
            t_max,
        )[:, None]
    return (
        any_ray
        & nonempty
        & (near_lb <= far_ub)
        & (far_ub >= t_min)
        & (near_lb <= cap)
    )


def chunk_overlap_mask_perray_cm(
    o3: jax.Array,  # [3, T, r] component-major origins
    inv3: jax.Array,  # [3, T, r]
    ray_valid: jax.Array,  # [T, r] bool
    bmin: jax.Array,
    bmax: jax.Array,
    *,
    t_min: float,
    t_max: float,
    t_cap: jax.Array | None = None,  # [T, r]
    tile_block: int = TILE_GROUP,
) -> jax.Array:
    """Per-ray slab culling, OR-reduced over each tile's live rays ->
    [T, Nc] — the pass behind ``refine=True``.

    The interval cull wraps ALL of a tile's rays in one box; when the
    rays diverge (reflected directions fan out across the scene) that
    box covers everything and the cull collapses.  Here every ray runs
    its own slab test and a chunk survives iff ANY live ray's
    [near, far] interval overlaps it — the same conservativeness
    guarantee (identical wobble-inflated bounds), far tighter lists
    under divergence.  Rays with a cap (shadow rays: their light
    distance) cull against their OWN cap.

    Zero direction components give ``inf`` inverses; they are clamped
    to +-1e30, which preserves the parallel-ray verdict exactly without
    the 0*inf NaNs of the raw slab test.

    Processed in ``tile_block``-tile batches via ``lax.map`` so live
    temporaries stay at [B, r, Nc]; blocks with no live ray skip the
    lattice."""
    t_tiles, r = ray_valid.shape
    nc = bmin.shape[0]
    wob = 2e-6 + 1e-5 * jnp.maximum(jnp.abs(bmin), jnp.abs(bmax))
    lo_b = (bmin - wob).T  # [3, Nc]
    hi_b = (bmax + wob).T
    nonempty = jnp.all(bmin <= bmax, axis=-1)  # [Nc] (padded chunks)
    inv = jnp.clip(inv3, -1e30, 1e30)
    if t_cap is None:
        cap = jnp.full((t_tiles, r), t_max, jnp.float32)
    else:
        cap = jnp.minimum(t_cap, jnp.float32(t_max))
    if t_tiles % tile_block:
        raise ValueError(
            f"tile count {t_tiles} not a multiple of {tile_block}"
        )
    nb = t_tiles // tile_block

    def compute(o, iv, vld, cp):
        near = jnp.full((tile_block, r, nc), -jnp.inf, jnp.float32)
        far = jnp.full((tile_block, r, nc), jnp.inf, jnp.float32)
        for ax in range(3):
            ob = o[ax][:, :, None]  # [B, r, 1]
            ib = iv[ax][:, :, None]
            q0 = (lo_b[ax][None, None, :] - ob) * ib  # [B, r, Nc]
            q1 = (hi_b[ax][None, None, :] - ob) * ib
            near = jnp.maximum(near, jnp.minimum(q0, q1))
            far = jnp.minimum(far, jnp.maximum(q0, q1))
        ok = (
            vld[:, :, None]
            & (near <= far)
            & (far >= t_min)
            & (near <= cp[:, :, None])
        )
        return jnp.any(ok, axis=1)  # [B, Nc]

    def block(args):
        o, iv, vld, cp, live = args
        return jax.lax.cond(
            live,
            lambda: compute(o, iv, vld, cp),
            lambda: jnp.zeros((tile_block, nc), bool),
        )

    v_b = ray_valid.reshape(nb, tile_block, r)
    out = jax.lax.map(
        block,
        (
            o3.reshape(3, nb, tile_block, r).transpose(1, 0, 2, 3),
            inv.reshape(3, nb, tile_block, r).transpose(1, 0, 2, 3),
            v_b,
            cap.reshape(nb, tile_block, r),
            v_b.reshape(nb, tile_block * r).any(axis=1),
        ),
    )
    return out.reshape(t_tiles, nc) & nonempty[None, :]


def chunk_overlap_mask_subgroup_cm(
    o3: jax.Array,  # [3, T, r] component-major origins
    inv3: jax.Array,  # [3, T, r]
    ray_valid: jax.Array,  # [T, r] bool
    bmin: jax.Array,
    bmax: jax.Array,
    *,
    t_min: float,
    t_max: float,
    t_cap: jax.Array | None = None,  # [T, r]
    sub: int = 8,
) -> jax.Array:
    """Interval culling at ``sub``-ray granularity, OR-reduced back to
    tiles -> [T, Nc] (``refine=n`` for n > 1).

    Reshapes each ray tile into ``r/sub`` pseudo-tiles of ``sub``
    consecutive rays and runs the ordinary tile-interval cull on them;
    it inherits that cull's conservativeness proof verbatim."""
    t_tiles, r = ray_valid.shape
    if r % sub:
        raise ValueError(f"ray_tile {r} not a multiple of sub {sub}")
    g = r // sub
    ov = chunk_overlap_mask_cm(
        o3.reshape(3, t_tiles * g, sub),
        inv3.reshape(3, t_tiles * g, sub),
        ray_valid.reshape(t_tiles * g, sub),
        bmin, bmax,
        t_min=t_min, t_max=t_max,
        t_cap=None if t_cap is None else t_cap.reshape(t_tiles * g, sub),
    )  # [T*g, Nc]
    return ov.reshape(t_tiles, g, -1).any(axis=1)


def chunk_lists(
    chunks: TriChunks,
    payload: jax.Array,  # [8, T, r]
    valid: jax.Array,  # [T, r]
    t_cap: jax.Array | None,
    *,
    t_min: float,
    t_max: float,
    cull_block: int = CULL_BLOCK,
    refine: bool | int = False,
) -> tuple[jax.Array, jax.Array]:
    """Cull and compact -> (ids [T, Nc] int32, counts [T] int32).

    Row ``t`` of ``ids`` lists, in ascending order, the chunks tile
    ``t`` must test; entries at and beyond ``counts[t]`` are padding.
    ``refine``: False/0 = tile-interval cull; 1 (or True, the default
    granularity ``REFINE_SUB``) = exact per-ray slabs; n > 1 = interval
    cull at n-ray subgroups."""
    nc = chunks.num_chunks
    if nc % cull_block:
        raise ValueError(
            f"chunk count {nc} not divisible by cull_block {cull_block} "
            f"(builders pad to CHUNK_ALIGN={CHUNK_ALIGN})"
        )
    nb = nc // cull_block
    t_tiles = valid.shape[0]
    inv3 = 1.0 / payload[3:6]
    if cull_block > 1:
        blk_min = jnp.min(chunks.bmin.reshape(nb, cull_block, 3), axis=1)
        blk_max = jnp.max(chunks.bmax.reshape(nb, cull_block, 3), axis=1)
    else:
        blk_min, blk_max = chunks.bmin, chunks.bmax
    window = dict(t_min=t_min, t_max=t_max, t_cap=t_cap)
    n_sub = (REFINE_SUB if refine is True else int(refine)) if refine else 0
    if n_sub == 1:
        overlap = chunk_overlap_mask_perray_cm(
            payload[0:3], inv3, valid, blk_min, blk_max, **window
        )
    elif n_sub > 1:
        overlap = chunk_overlap_mask_subgroup_cm(
            payload[0:3], inv3, valid, blk_min, blk_max, sub=n_sub, **window
        )
    else:
        overlap = chunk_overlap_mask_cm(
            payload[0:3], inv3, valid, blk_min, blk_max, **window
        )  # [T, Nb]
    # Stable argsort puts overlapping blocks first, ascending; each
    # block then expands to its cull_block consecutive chunk ids.
    order = jnp.argsort(~overlap, axis=1, stable=True).astype(jnp.int32)
    counts = jnp.sum(overlap, axis=1, dtype=jnp.int32) * cull_block
    if cull_block > 1:
        order = (
            order[:, :, None] * cull_block
            + jnp.arange(cull_block, dtype=jnp.int32)[None, None, :]
        ).reshape(t_tiles, nc)
    return order, counts


# ----------------------------------------------------------------------
# The chunk loop: Pallas kernel and plain-lax reference


def mt_chunk_test(
    tri,  # 9 arrays broadcastable to (S, R): a.xyz, e1.xyz, e2.xyz
    ox, oy, oz, dx, dy, dz,  # ray components broadcastable to (S, R)
    pid,  # the triangles' prim ids as f32 (exact < 2^24)
    excl,  # the rays' exclusion ids as f32
    *,
    t_min: float,
    t_max: float,
    eps: float,
):
    """The Möller–Trumbore (triangles x rays) lattice shared by the
    kernel and the ``lax`` loop, kept in one body so their arithmetic
    cannot drift.  Returns ``(ok, w)``: hit mask and distances
    (garbage where ``~ok``)."""
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = tri

    # p = cross(d, e2)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    # tvec = o - a
    tx = ox - ax
    ty = oy - ay
    tz = oz - az
    # q = cross(tvec, e1)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x

    det = e1x * px + e1y * py + e1z * pz
    u = tx * px + ty * py + tz * pz
    v = dx * qx + dy * qy + dz * qz

    # Two-sided branch folded by sign flip: multiplying u/v by
    # sign(det) is exact (x * +-1) and maps both determinant branches
    # of basic.rs:56-70 onto one comparison set.
    sgn = jnp.sign(det)
    adet = jnp.abs(det)
    su = u * sgn
    sv = v * sgn
    ok = (
        (adet > eps)
        & (su >= 0.0)
        & (su <= adet)
        & (sv >= 0.0)
        & (su + sv <= adet)
    )
    w = (e2x * qx + e2y * qy + e2z * qz) / jnp.where(ok, det, 1.0)
    # Strict window (the naive replace semantics, basic.rs:95-101).
    ok = ok & (w > t_min) & (w < t_max)
    ok = ok & (pid != excl)
    return ok, w


def _packet_kernel(
    counts_ref,  # [T] int32: list length per tile
    ids_ref,  # [T, Nc] int32: compacted ascending chunk ids
    comp_ref,  # [9, Nc*tc] f32: the chunk table
    pay_ref,  # (8, R) block: this program's rays
    *out_refs,  # closest: t (R,), id (R,); any-hit: blocked (R,)
    tc: int,
    step: int,
    t_min: float,
    t_max: float,
    eps: float,
    any_hit: bool,
):
    """One program: ``R`` rays of tile ``program_id(0)`` against that
    tile's chunk list, ``step`` triangles per inner iteration.  The
    running best per (triangle slot, ray) stays in registers; the
    final reduction keeps the smallest prim id among equal ``t``."""
    tile = pl.program_id(0)
    ox, oy, oz, dx, dy, dz, excl = (pay_ref[c][None, :] for c in range(7))
    n_entries = counts_ref[tile]
    slot = jnp.arange(step, dtype=jnp.int32)
    miss = jnp.float32(t_max + 1.0)
    r = pay_ref.shape[1]

    def sweep(update, init):
        # Outer loop over the tile's list entries, inner loop over the
        # chunk's triangles ``step`` at a time.
        def entry(k, carry):
            c0 = ids_ref[tile, k] * tc

            def sub(j, carry):
                base = pl.multiple_of(c0 + j * step, step)
                tri = tuple(
                    comp_ref[i, pl.ds(base, step)][:, None]
                    for i in range(NCOMP)
                )
                pid = (slot + (base + 1)).astype(jnp.float32)[:, None]
                ok, w = mt_chunk_test(
                    tri, ox, oy, oz, dx, dy, dz, pid, excl,
                    t_min=t_min, t_max=t_max, eps=eps,
                )
                return update(ok, w, pid, carry)

            return jax.lax.fori_loop(0, tc // step, sub, carry)

        return jax.lax.fori_loop(0, n_entries, entry, init)

    if any_hit:
        cap = pay_ref[7][None, :]
        # Blocked iff ANY hit lies inside (t_min, cap): min(t) < cap iff
        # some t < cap, so this equals closest-hit-then-compare.
        blk = sweep(
            lambda ok, w, pid, blk: jnp.where(
                ok & (w < cap), jnp.float32(1.0), blk
            ),
            jnp.zeros((step, r), jnp.float32),
        )
        out_refs[0][...] = (jnp.max(blk, axis=0) > 0.0).astype(jnp.int32)
        return

    def closest(ok, w, pid, carry):
        bt, bid = carry
        w = jnp.where(ok, w, miss)
        better = w < bt  # ascending ids: ties keep the earlier prim
        return jnp.where(better, w, bt), jnp.where(better, pid, bid)

    bt, bid = sweep(
        closest,
        (jnp.full((step, r), miss), jnp.zeros((step, r), jnp.float32)),
    )
    best = jnp.min(bt, axis=0)
    best_id = jnp.min(
        jnp.where(bt == best[None, :], bid, jnp.float32(3.0e38)), axis=0
    )
    out_refs[0][...] = best
    out_refs[1][...] = jnp.where(best <= t_max, best_id, 0.0).astype(
        jnp.int32
    )


def _kernel_chunk_loop(
    chunks: TriChunks,
    ids: jax.Array,
    counts: jax.Array,
    payload: jax.Array,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    any_hit: bool,
    rays_per_program: int,
    tris_per_step: int,
):
    """The chunk loop as one Pallas call: grid (tiles, r / R)."""
    t_tiles, r = payload.shape[1:]
    tc = chunks.tri_chunk
    rp = min(rays_per_program, r)
    step = min(tris_per_step, tc)
    if r % rp or tc % step:
        raise ValueError(
            f"rays per program {rp} must divide the tile width {r} and "
            f"triangles per step {step} the chunk height {tc}"
        )
    mode = kernel_mode()
    kernel = partial(
        _packet_kernel, tc=tc, step=step,
        t_min=t_min, t_max=t_max, eps=eps, any_hit=any_hit,
    )
    ray_spec = pl.BlockSpec((None, rp), lambda t, j: (t, j))
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((t_tiles, r), jnp.int32)]
    else:
        out_shape = [
            jax.ShapeDtypeStruct((t_tiles, r), jnp.float32),
            jax.ShapeDtypeStruct((t_tiles, r), jnp.int32),
        ]
    whole = lambda shape: pl.BlockSpec(shape, lambda t, j: (0,) * len(shape))
    outs = pl.pallas_call(
        kernel,
        grid=(t_tiles, r // rp),
        in_specs=[
            whole(counts.shape),
            whole(ids.shape),
            whole(chunks.comp.shape),
            pl.BlockSpec((8, None, rp), lambda t, j: (0, t, j)),
        ],
        out_specs=[ray_spec] * len(out_shape),
        out_shape=out_shape,
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        backend="triton",
        interpret=mode == INTERPRET,
        name="packet_any_hit" if any_hit else "packet_closest_hit",
    )(counts, ids, chunks.comp, payload)
    if any_hit:
        return outs[0] > 0
    return outs[0], outs[1]


def _lax_chunk_loop(
    chunks: TriChunks,
    ids: jax.Array,
    counts: jax.Array,
    payload: jax.Array,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    any_hit: bool,
):
    """The chunk loop in plain ``lax``: one loop over list position;
    step ``k`` gathers every tile's ``k``-th chunk and tests it against
    the tile's rays ([T, tc, r] lattice, reduced over the chunk at once
    to the lexicographic (t, id) minimum).  Same lists, same arithmetic
    and the same winner as the kernel."""
    tc = chunks.tri_chunk
    ox, oy, oz, dx, dy, dz, excl = (payload[c][:, None, :] for c in range(7))
    miss = jnp.float32(t_max + 1.0)
    slot = jnp.arange(tc, dtype=jnp.int32)

    def test(k):
        cols = ids[:, k][:, None] * tc + slot[None, :]  # [T, tc]
        tri = tuple(chunks.comp[j][cols][:, :, None] for j in range(NCOMP))
        pid = (cols + 1).astype(jnp.float32)[:, :, None]
        ok, w = mt_chunk_test(
            tri, ox, oy, oz, dx, dy, dz, pid, excl,
            t_min=t_min, t_max=t_max, eps=eps,
        )
        return ok & (k < counts)[:, None, None], w, pid

    n_iter = jnp.max(counts)
    if any_hit:
        cap = payload[7][:, None, :]

        def body(k, blk):
            ok, w, _ = test(k)
            return blk | jnp.any(ok & (w < cap), axis=1)

        return jax.lax.fori_loop(
            0, n_iter, body, jnp.zeros(payload.shape[1:], bool)
        )

    def body(k, carry):
        bt, bid = carry
        ok, w, pid = test(k)
        w = jnp.where(ok, w, miss)
        wmin = jnp.min(w, axis=1)
        pmin = jnp.min(
            jnp.where(w == wmin[:, None, :], pid, jnp.float32(3.0e38)),
            axis=1,
        )
        better = wmin < bt  # earlier chunks hold smaller ids
        return jnp.where(better, wmin, bt), jnp.where(better, pmin, bid)

    bt, bid = jax.lax.fori_loop(
        0, n_iter, body,
        (
            jnp.full(payload.shape[1:], miss),
            jnp.zeros(payload.shape[1:], jnp.float32),
        ),
    )
    return bt, jnp.where(bt <= t_max, bid, 0.0).astype(jnp.int32)


def packet_closest_hit_tiled(
    chunks: TriChunks,
    payload: jax.Array,  # [8, T, r] f32 component-major ray tiles
    valid: jax.Array,  # [T, r] bool
    t_cap: jax.Array | None = None,  # [T, r]
    *,
    t_min: float,
    t_max: float,
    eps: float,
    cull_block: int = CULL_BLOCK,
    any_hit: bool = False,
    refine: bool | int = False,
    loop: str = "kernel",
    rays_per_program: int = RAYS_PER_PROGRAM,
    tris_per_step: int = TRIS_PER_STEP,
):
    """Closest hit over component-major ray tiles -> (t [T, r],
    pid [T, r]); misses have pid 0 and t > t_max.

    ``t_cap`` tightens culling only: hits beyond a ray's cap may or may
    not be reported.  ``any_hit`` returns one blocked mask [T, r] bool
    instead: True iff some primitive (other than the ray's exclusion)
    lies within (t_min, cap), the cap read from payload row 7 — the
    shadow-ray form.  ``refine`` picks the cull (see
    :func:`chunk_lists`).  ``loop`` picks the chunk loop: ``"kernel"``
    (the Pallas kernel) or ``"lax"`` (the plain reference).  Outputs
    for invalid rays are unspecified."""
    if chunks.num_chunks * chunks.tri_chunk + 1 >= 1 << 24:
        # Prim ids travel as f32 in the loop; keep them exact.
        raise ValueError(
            "prim ids exceed f32 exact-integer range (2^24); scene too "
            "large for exact exclusion/hit ids"
        )
    if loop not in ("kernel", "lax"):
        raise ValueError(f"unknown chunk loop {loop!r}")
    with jax.named_scope("cull"):
        ids, counts = chunk_lists(
            chunks, payload, valid, t_cap,
            t_min=t_min, t_max=t_max, cull_block=cull_block, refine=refine,
        )
    window = dict(t_min=t_min, t_max=t_max, eps=eps, any_hit=any_hit)
    with jax.named_scope("intersect"):
        if loop == "kernel":
            return _kernel_chunk_loop(
                chunks, ids, counts, payload,
                rays_per_program=rays_per_program,
                tris_per_step=tris_per_step, **window,
            )
        return _lax_chunk_loop(chunks, ids, counts, payload, **window)


def packet_closest_hit(
    chunks: TriChunks,
    o: jax.Array,  # [N, 3]
    d: jax.Array,  # [N, 3]
    excl: jax.Array,  # [N] int32
    valid: jax.Array | None = None,  # [N] bool live-ray mask
    t_cap: jax.Array | None = None,  # [N] per-ray t upper bound (culling)
    *,
    t_min: float,
    t_max: float,
    eps: float,
    ray_tile: int = RAY_TILE,
    **kwargs,
) -> tuple[jax.Array, jax.Array]:
    """:func:`packet_closest_hit_tiled` over an AoS ray batch ->
    (t [N], pid [N]): pads the rays to whole tile groups and lays them
    out component-major.  Extra keywords pass through."""
    n = o.shape[0]
    t_tiles = max(1, -(-n // ray_tile))
    t_tiles = -(-t_tiles // TILE_GROUP) * TILE_GROUP
    n_pad = t_tiles * ray_tile

    def tiles(x):
        x = jnp.pad(x, ((0, n_pad - n),) + ((0, 0),) * (x.ndim - 1))
        return x.reshape((t_tiles, ray_tile) + x.shape[1:])

    if valid is None:
        valid = jnp.ones((n,), dtype=bool)
    payload = jnp.concatenate(
        [
            tiles(o).transpose(2, 0, 1),  # [3, T, r]
            tiles(d).transpose(2, 0, 1),
            tiles(excl)[None].astype(jnp.float32),
            jnp.zeros((1, t_tiles, ray_tile), dtype=jnp.float32),
        ],
        axis=0,
    )
    out_t, out_id = packet_closest_hit_tiled(
        chunks, payload, tiles(valid),
        None if t_cap is None else tiles(t_cap),
        t_min=t_min, t_max=t_max, eps=eps, **kwargs,
    )
    return out_t.reshape(n_pad)[:n], out_id.reshape(n_pad)[:n]


def tag_refine(fn, mode: str):
    """Mark a tiled-entry callable with the refine policy so
    ``ops.shade.trace_tiled`` can opt bounce/shadow batches into the
    per-ray cull: bake ``refine=True`` for mode ``"all"`` (call-site
    kwargs still override) and advertise support for ``"bounces"``.
    Shared by every backend that exposes tiled entries."""
    if mode not in ("off", "bounces", "all"):
        raise ValueError(f"unknown refine mode {mode!r}")
    if mode == "all":
        fn = partial(fn, refine=True)
    fn.supports_refine = mode != "off"
    return fn
