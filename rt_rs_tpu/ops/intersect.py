"""Ray-triangle and ray-AABB intersection (batched, jittable).

Semantics are matched op-for-op with the reference WGSL:

* Möller–Trumbore with the two-sided determinant branches and
  ``config.eps`` dead zone — ``src/lib/handlers/basic.rs:43-79`` (the
  identical code is embedded in the BVH handlers,
  ``src/lib/handlers/bvh.rs:205-240``).
* Slab test with the ``EPS = 2e-6`` bound wobble —
  ``src/lib/handlers/bvh.rs:248-268``.  NOTE: the reference's
  ``collides`` clamps the y/z slab contributions through
  ``min(..., -1e38)`` / ``max(..., +1e38)``, which makes them no-ops for
  finite inputs — its BVH traversal therefore never culls anything
  (conservatively correct, catastrophically slow).  We implement the
  *intended* slab test; this changes no image (culling only removes
  provably-missed nodes) and is the first reason this rebuild is fast.

Missing intersections are encoded exactly like ``intrs_empty``
(``compute.wgsl:185-187``): ``t = t_max + 1`` and prim id ``0`` (the
null sentinel).

Design note: everything here is expressed over *batches* — rays
``[N, 3]`` against triangle chunks ``[C, 3]`` producing ``[N, C]``
lattices of elementwise math.  There is no per-ray control
flow; validity is a mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Reference slab-test wobble (handlers/bvh.rs:246) .
SLAB_EPS = 0.000002


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross(ax, ay, az, bx, by, bz):
    return (
        ay * bz - az * by,
        az * bx - ax * bz,
        ax * by - ay * bx,
    )


def tri_intersect(
    o: jax.Array,  # [N, 3] ray origins
    d: jax.Array,  # [N, 3] ray directions
    pa: jax.Array,  # [C, 3] triangle corner a
    pb: jax.Array,  # [C, 3] corner b
    pc: jax.Array,  # [C, 3] corner c
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> jax.Array:
    """All-pairs Möller–Trumbore: returns ``t`` of shape ``[N, C]``.

    Misses hold ``t_max + 1``.  Comparison semantics follow
    ``basic.rs:43-79`` exactly (two-sided, non-strict u/v bounds within
    each determinant branch, ``w`` window non-strict).
    """
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # [N,1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    ax, ay, az = pa[:, 0][None, :], pa[:, 1][None, :], pa[:, 2][None, :]  # [1,C]
    e1x = pb[:, 0][None, :] - ax
    e1y = pb[:, 1][None, :] - ay
    e1z = pb[:, 2][None, :] - az
    e2x = pc[:, 0][None, :] - ax
    e2y = pc[:, 1][None, :] - ay
    e2z = pc[:, 2][None, :] - az

    # p = cross(dir, e2): [N, C]
    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)
    # t = origin - a: [N, C]
    tx, ty, tz = ox - ax, oy - ay, oz - az
    # q = cross(t, e1)
    qx, qy, qz = _cross(tx, ty, tz, e1x, e1y, e1z)

    det = _dot(e1x, e1y, e1z, px, py, pz)
    u = _dot(tx, ty, tz, px, py, pz)
    v = _dot(dx, dy, dz, qx, qy, qz)

    pos = det > eps
    neg = det < -eps
    ok_pos = pos & (u >= 0.0) & (u <= det) & (v >= 0.0) & (u + v <= det)
    ok_neg = neg & (u <= 0.0) & (u >= det) & (v <= 0.0) & (u + v >= det)
    ok = ok_pos | ok_neg

    w = _dot(e2x, e2y, e2z, qx, qy, qz) / jnp.where(ok, det, 1.0)
    ok = ok & (w <= t_max) & (w >= t_min)

    return jnp.where(ok, w, t_max + 1.0)


def tri_intersect_pairs(
    o: jax.Array,  # [N, 3]
    d: jax.Array,  # [N, 3]
    pa: jax.Array,  # [N, 3] per-ray triangle corners
    pb: jax.Array,
    pc: jax.Array,
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> jax.Array:
    """Elementwise Möller–Trumbore: ray i vs triangle i -> t [N].

    Same semantics as :func:`tri_intersect`; used by BVH leaf testing
    where each ray has already been matched with a candidate prim.
    """
    e1 = pb - pa
    e2 = pc - pa
    p = jnp.cross(d, e2)
    tvec = o - pa
    q = jnp.cross(tvec, e1)

    det = jnp.sum(e1 * p, axis=-1)
    u = jnp.sum(tvec * p, axis=-1)
    v = jnp.sum(d * q, axis=-1)

    pos = det > eps
    neg = det < -eps
    ok = (pos & (u >= 0.0) & (u <= det) & (v >= 0.0) & (u + v <= det)) | (
        neg & (u <= 0.0) & (u >= det) & (v <= 0.0) & (u + v >= det)
    )
    w = jnp.sum(e2 * q, axis=-1) / jnp.where(ok, det, 1.0)
    ok = ok & (w <= t_max) & (w >= t_min)
    return jnp.where(ok, w, t_max + 1.0)


def closest_hit_bruteforce(
    o: jax.Array,  # [N, 3]
    d: jax.Array,  # [N, 3]
    pa: jax.Array,  # [P, 3] (row 0 = null sentinel)
    pb: jax.Array,
    pc: jax.Array,
    excl: jax.Array,  # [N] int32 prim id to exclude (0 = none)
    *,
    t_min: float,
    t_max: float,
    eps: float,
    chunk: int = 128,
) -> tuple[jax.Array, jax.Array]:
    """Closest hit over *all* prims — the ``BasicIntrs`` equivalent
    (``basic.rs:81-106``).

    Scans prim chunks with a ``lax.scan`` so live memory stays at
    ``O(N * chunk)``.  Prim 0 (null) is never hit; the ``excl`` prim is
    skipped (shadow-ray self-exclusion, ``compute.wgsl:202``).

    Returns ``(t [N], prim_id [N])`` with the miss encoding.
    """
    n = o.shape[0]
    p = pa.shape[0]
    # Pad prim arrays to a chunk multiple with degenerate (never-hit) tris.
    p_pad = ((p + chunk - 1) // chunk) * chunk
    pad = p_pad - p

    def pad3(a):
        return jnp.pad(a, ((0, pad), (0, 0)))

    pa_, pb_, pc_ = pad3(pa), pad3(pb), pad3(pc)
    n_chunks = p_pad // chunk

    pa_c = pa_.reshape(n_chunks, chunk, 3)
    pb_c = pb_.reshape(n_chunks, chunk, 3)
    pc_c = pc_.reshape(n_chunks, chunk, 3)

    miss_t = jnp.float32(t_max + 1.0)
    # Derive carries from inputs so the axis-varyingness matches under
    # shard_map (a constant init is unvarying; the body output varies).
    init = (
        jnp.full_like(d[:, 0], miss_t),
        jnp.zeros_like(d[:, 0], dtype=jnp.int32),
    )

    def body(carry, inputs):
        best_t, best_id = carry
        ci, cpa, cpb, cpc = inputs
        t = tri_intersect(
            o, d, cpa, cpb, cpc, t_min=t_min, t_max=t_max, eps=eps
        )  # [N, chunk]
        ids = ci * chunk + jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        # Mask: skip null prim (id 0), padding (id >= p), and excluded prim.
        live = (ids >= 1) & (ids < p) & (ids != excl[:, None])
        # The naive loop replaces on strictly-smaller t within the open
        # (t_min, t_max) window (basic.rs:95-101).
        t = jnp.where(live & (t > t_min) & (t < t_max), t, miss_t)
        c_arg = jnp.argmin(t, axis=1)
        c_t = jnp.take_along_axis(t, c_arg[:, None], axis=1)[:, 0]
        c_id = (ci * chunk + c_arg).astype(jnp.int32)
        better = c_t < best_t
        return (
            (jnp.where(better, c_t, best_t), jnp.where(better, c_id, best_id)),
            None,
        )

    (best_t, best_id), _ = jax.lax.scan(
        body,
        init,
        (jnp.arange(n_chunks, dtype=jnp.int32), pa_c, pb_c, pc_c),
    )
    best_id = jnp.where(best_t <= t_max, best_id, 0)
    return best_t, best_id


def slab_test(
    o: jax.Array,  # [N, 3]
    inv_d: jax.Array,  # [N, 3] precomputed 1/d (+-inf where d == 0)
    bmin: jax.Array,  # [3] node bounds
    bmax: jax.Array,  # [3]
) -> jax.Array:
    """Intended ray-AABB slab test (see module docstring) -> bool [N].

    Includes the reference's ``EPS`` bound wobble.  NaNs from
    ``0 * inf`` (origin exactly on a slab of a flat box) resolve
    conservatively to "hit".
    """
    t0 = (bmin[None, :] - SLAB_EPS - o) * inv_d  # [N, 3]
    t1 = (bmax[None, :] + SLAB_EPS - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    lo = jnp.where(jnp.isnan(lo), -jnp.inf, lo)
    hi = jnp.where(jnp.isnan(hi), jnp.inf, hi)
    t_near = jnp.max(lo, axis=1)
    t_far = jnp.min(hi, axis=1)
    return t_near <= t_far
