"""Camera ray generation and the Blinn/Phong bounce-lighting loop.

Op-for-op parity with ``src/lib/shaders/compute.wgsl``:

* ``camera_ray`` — pinhole with up = +Y and the -0.5 NDC offset
  (compute.wgsl:103-118);
* ``hit`` — barycentric position/normal interpolation *including the
  reference's a/b/c corner rotation* (compute.wgsl:120-151: ``b`` is
  read from corner ``a``, ``c`` from ``b``, ``a`` from ``c``);
* ``lighting_diffuse`` / ``lighting_spec`` (compute.wgsl:160-175);
* ``shadowed`` with the 0.001 normal offset (compute.wgsl:189-212);
* the bounce loop: per-bounce closest hit, optional camera headlight,
  per-light shadow rays, ``color += mat.color*diffuse*albedo.x +
  white*spec*albedo.y``, attenuated by the *current* material's
  ``albedo.z`` for bounce > 0, perfect mirror continuation
  (compute.wgsl:219-280).

Where the WGSL runs this per pixel with ``break`` on miss, this
version runs the whole ray batch with an ``active`` mask — dead rays
simply stop contributing (static shapes; no data-dependent control
flow, so XLA fuses the entire bounce loop into one program).

Shadow rays for all L lights are traced in ONE batched intersect call of
shape ``[L * N]`` (light-major, so each light's rays stay contiguous and
packet-coherent) instead of the reference's per-light sequential loop.

The ``intersect_fn`` argument abstracts the acceleration backend (the
``IntrsHandler::logic`` splice point, ``src/lib/handlers/mod.rs:52-67``):
``intersect_fn(o, d, excl) -> (t, prim_id)`` closest-hit over ``[N]``
rays.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.scene.arrays import SceneArrays

# (origins [N,3], dirs [N,3], excl prim [N], valid [N], *, t_cap=None)
#   -> (t [N], prim [N])
# `valid` marks live rays: results for invalid rays are unspecified (the
# caller masks them); backends use it to keep dead rays from polluting
# packet coherence.  `t_cap` (optional [N] float32 keyword) is a per-ray
# upper bound used only to tighten culling: hits beyond a ray's cap may
# or may not be reported.  Every backend MUST accept the keyword (shadow
# passes always pass it).
IntersectFn = Callable[..., tuple[jax.Array, jax.Array]]


def _normalize(v: jax.Array) -> jax.Array:
    return v * jax.lax.rsqrt(jnp.sum(v * v, axis=-1, keepdims=True))


def _reflect(e: jax.Array, n: jax.Array) -> jax.Array:
    """WGSL ``reflect(e, n) = e - 2 * dot(e, n) * n``."""
    return e - 2.0 * jnp.sum(e * n, axis=-1, keepdims=True) * n


def padded_block_dims(
    width: int, rows: int, block: tuple[int, int]
) -> tuple[int, int]:
    """(rows, width) padded up to multiples of the block shape."""
    bh, bw = block
    return -(-rows // bh) * bh, -(-width // bw) * bw


def _blockify(grid: jax.Array, block: tuple[int, int]) -> jax.Array:
    """Flatten a padded [Rp, Wp] grid in (block-row, block-col,
    in-block-row, in-block-col) order — pure reshape/transpose."""
    bh, bw = block
    rp, wp = grid.shape
    return (
        grid.reshape(rp // bh, bh, wp // bw, bw)
        .transpose(0, 2, 1, 3)
        .reshape(-1)
    )


def unblock_colors(
    color: jax.Array,  # [Rp*Wp, 3] in block order
    width: int,
    rows: int,
    block: tuple[int, int],
) -> jax.Array:
    """Invert the block ordering -> [rows, width, 3] raster image."""
    bh, bw = block
    rp, wp = padded_block_dims(width, rows, block)
    img = (
        color.reshape(rp // bh, wp // bw, bh, bw, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(rp, wp, 3)
    )
    return img[:rows, :width]


def _pixel_grid(
    width: int,
    height: int,
    rows: int,
    y_offset: jax.Array | int,
    block: tuple[int, int] | None,
) -> tuple[jax.Array, jax.Array, int]:
    """Normalized pixel coordinates for a band of the image ->
    (norm_x [N], norm_y [N], n_pixels), in raster order (``block``
    None) or pixel-block order.  Shared by :func:`camera_rays` and
    :func:`camera_ray_tiles` so the two layouts stay bit-identical
    per ray.  Block padding duplicates clamped border pixels (same
    float coordinates -> identical ray math); ``unblock_colors`` crops
    them away."""
    xs = (jnp.arange(width, dtype=jnp.float32) / width) - 0.5
    ys = (
        (jnp.arange(rows, dtype=jnp.float32) + y_offset) / height
    ) - 0.5
    if block is None:
        return jnp.tile(xs, rows), jnp.repeat(ys, width), rows * width
    rp, wp = padded_block_dims(width, rows, block)
    xi = jnp.minimum(jnp.arange(wp), width - 1)
    yi = jnp.minimum(jnp.arange(rp), rows - 1)
    norm_x = _blockify(jnp.broadcast_to(xs[xi][None, :], (rp, wp)), block)
    norm_y = _blockify(jnp.broadcast_to(ys[yi][:, None], (rp, wp)), block)
    return norm_x, norm_y, rp * wp


def camera_rays(
    camera_pos: jax.Array,  # [3]
    camera_at: jax.Array,  # [3]
    width: int,
    height: int,
    y_offset: jax.Array | int = 0,
    rows: int | None = None,
    block: tuple[int, int] | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Primary rays for every pixel -> (origins [R*W, 3], dirs [R*W, 3]).

    Row-major pixel order: ray ``y * width + x`` corresponds to WGSL
    invocation ``id.xy = (x, y)`` (compute.wgsl:284-293).

    ``y_offset``/``rows`` select a horizontal band of the image — the
    unit of multi-chip sharding (each device renders its own band; see
    :mod:`rt_rs_tpu.parallel`).  Defaults cover the full frame.

    ``block=(bh, bw)`` emits rays in 2-D pixel-block order instead of
    raster order (undo with :func:`unblock_colors`).  Per-ray values are
    bit-identical either way; the point is packet shape: a 128-ray
    packet tile becomes a compact bh x bw pixel block instead of a
    128 x 1 strip, so the tile's frustum (and every secondary packet's
    origin bound) tightens and conservative chunk culling sheds more
    work.  Dimensions that don't divide the block
    are padded with clamped edge rays and cropped by
    ``unblock_colors``.
    """
    if rows is None:
        rows = height
    dir_ = _normalize((camera_at - camera_pos)[None, :])[0]
    up = jnp.array([0.0, 1.0, 0.0], dtype=jnp.float32)
    right = jnp.cross(dir_, up)

    norm_x, norm_y, _ = _pixel_grid(width, height, rows, y_offset, block)

    pt = (
        right[None, :] * norm_x[:, None]
        + up[None, :] * norm_y[:, None]
        + camera_pos[None, :]
        + dir_[None, :]
    )
    d = _normalize(pt - camera_pos[None, :])
    o = jnp.broadcast_to(camera_pos[None, :], d.shape)
    return o, d


def hit_surface(
    scene: SceneArrays,
    prim_id: jax.Array,  # [N]
    o: jax.Array,  # [N, 3]
    d: jax.Array,  # [N, 3]
    t: jax.Array,  # [N]
) -> tuple[jax.Array, jax.Array]:
    """Reference ``hit()`` -> (at [N, 3], normal [N, 3]).

    Keeps the corner rotation of compute.wgsl:122-126; implemented on
    the combined shade-table row (one gather)."""
    return _hit_from_rows(scene.shade_table[prim_id], o, d, t)


def _hit_from_rows(
    row: jax.Array,  # [N, 32] gathered shade-table rows
    o: jax.Array,
    d: jax.Array,
    t: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """``hit_surface`` on pre-gathered rows (same corner rotation)."""
    at = o + d * t[:, None]
    b = row[:, 0:3]   # pa
    c = row[:, 3:6]   # pb
    a = row[:, 6:9]   # pc

    v0 = b - a
    v1 = c - a
    v2 = at - a

    d00 = jnp.sum(v0 * v0, axis=-1)
    d01 = jnp.sum(v0 * v1, axis=-1)
    d11 = jnp.sum(v1 * v1, axis=-1)
    d20 = jnp.sum(v2 * v0, axis=-1)
    d21 = jnp.sum(v2 * v1, axis=-1)

    denom = d00 * d11 - d01 * d01
    denom = jnp.where(denom == 0.0, 1.0, denom)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w

    normal = (
        row[:, 9:12] * v[:, None]
        + row[:, 12:15] * w[:, None]
        + row[:, 15:18] * u[:, None]
    )
    return at, _normalize(normal)


def _light_terms(
    light_pos: jax.Array,  # [N, 3] (already broadcast per ray)
    strength: jax.Array,  # [N]
    at: jax.Array,  # [N, 3]
    normal: jax.Array,  # [N, 3]
    ray_dir: jax.Array,  # [N, 3] current ray direction
    spec_pow: jax.Array,  # [N]
) -> tuple[jax.Array, jax.Array]:
    """(diffuse, spec) intensities (compute.wgsl:160-175)."""
    light_dir = _normalize(light_pos - at)
    diffuse = strength * jnp.maximum(
        0.0, jnp.sum(light_dir * normal, axis=-1)
    )
    refl = _reflect(-light_dir, normal)
    spec = jnp.sum(-refl * ray_dir, axis=-1)
    spec = jnp.power(jnp.maximum(0.0, spec), spec_pow) * strength
    return diffuse, spec


def compacting(intersect_fn: IntersectFn) -> IntersectFn:
    """Wrap a closest-hit so live rays are packed contiguously first.

    After a bounce most rays are dead (~89% of teatime pixels miss);
    without compaction they still occupy packet tiles.  A stable
    partition keeps neighboring live rays adjacent (preserving the
    spatial coherence packets rely on), the backend traces the packed
    batch, and results scatter back.  This is the wavefront
    "compaction between bounces" of the BASELINE design; the reference
    has no analogue (SIMT threads simply diverge).

    It is OFF by default (``trace(..., compact=False)``): an on-device
    sort over every ray of the batch costs more than the coherence it
    buys, since the packet tracer already skips dead tiles via the
    validity mask and static shapes keep the tile count fixed.
    """

    def wrapped(o, d, excl, valid, t_cap=None):
        order = jnp.argsort(~valid, stable=True)
        inv = jnp.argsort(order, stable=True)
        t, pid = intersect_fn(
            o[order], d[order], excl[order], valid[order],
            t_cap=None if t_cap is None else t_cap[order],
        )
        return t[inv], pid[inv]

    return wrapped


def render(
    scene: SceneArrays,
    intersect_fn: IntersectFn,
    cfg: ComputeConfig,
    camera_pos: jax.Array,  # [3]
    camera_at: jax.Array,  # [3]
    width: int,
    height: int,
    compact: bool = False,
    block: tuple[int, int] | None = None,
) -> jax.Array:
    """Full frame -> color [H, W, 3] float32 (unclamped, like the
    rgba8unorm store input of compute.wgsl:291).

    ``block`` traces rays in pixel-block order (see
    :func:`camera_rays`); the output image is identical either way."""
    o, d = camera_rays(camera_pos, camera_at, width, height, block=block)
    color = trace(scene, intersect_fn, cfg, o, d, compact=compact)
    if block is not None:
        return unblock_colors(color, width, height, block)
    return color.reshape(height, width, 3)


def trace(
    scene: SceneArrays,
    intersect_fn: IntersectFn,
    cfg: ComputeConfig,
    o: jax.Array,  # [N, 3]
    d: jax.Array,  # [N, 3]
    compact: bool = False,
) -> jax.Array:
    """The ``lighting`` bounce loop (compute.wgsl:219-280) over a ray
    batch -> color [N, 3].

    Wavefront restructuring: each bounce's shadow rays (all lights) and
    the NEXT bounce's reflection rays depend only on the current hit,
    so they are traced in ONE fused intersect call of (K+1)*N rays —
    fewer kernel launches and culling preludes than the reference's
    sequential per-light loop + per-bounce intersect.

    ``compact`` packs live rays before every secondary intersect (see
    :func:`compacting`); primary rays are already dense."""
    n = o.shape[0]
    secondary_fn = compacting(intersect_fn) if compact else intersect_fn
    color = jnp.zeros((n, 3), dtype=jnp.float32)
    active = jnp.ones((n,), dtype=bool)
    camera_origin = o  # headlight position (compute.wgsl:237)

    ray_o, ray_d = o, d

    num_lights = scene.num_lights
    use_headlight = cfg.camera_light_source > 0.0

    t, prim_id = intersect_fn(
        ray_o, ray_d, jnp.zeros((n,), dtype=jnp.int32), active
    )

    for bounce in range(cfg.bounces):
        prim_id = jnp.where(active, prim_id, 0)
        # ONE [N, 32] row gather supplies everything about the hit prim
        # (corners, normals, material; see SceneArrays.shade_table).
        row = scene.shade_table[prim_id]
        valid = (
            (row[:, 25] != -1.0) & (t < cfg.t_max) & (t > cfg.t_min)
        )
        active = active & valid

        mat_color = row[:, 18:21]
        mat_albedo = row[:, 21:24]
        mat_spec = row[:, 24]

        at, normal = _hit_from_rows(row, ray_o, ray_d, t)
        cur_d = ray_d  # this bounce's direction (used by specular)

        # Assemble the light set: scene lights (+ optional headlight).
        light_positions = []
        light_strengths = []
        if use_headlight:
            light_positions.append(camera_origin)
            light_strengths.append(
                jnp.full((n,), cfg.camera_light_source, dtype=jnp.float32)
            )
        for j in range(num_lights):
            light_positions.append(
                jnp.broadcast_to(scene.light_pos[j][None, :], (n, 3))
            )
            light_strengths.append(
                jnp.broadcast_to(scene.light_strength[j], (n,))
            )
        k = len(light_positions)

        # Shadow-ray geometry (compute.wgsl:189-212).
        if k:
            lp = jnp.stack(light_positions)  # [K, N, 3]
            ls = jnp.stack(light_strengths)  # [K, N]
            delta = lp - at[None, :, :]
            light_dist = jnp.sqrt(jnp.sum(delta * delta, axis=-1))  # [K, N]
            light_dir = _normalize(delta)
            side = jnp.sum(light_dir * normal[None, :, :], axis=-1)
            s_off = (
                jnp.where(side[..., None] < 0.0, -0.001, 0.001)
                * normal[None, :, :]
            )
            shadow_o = (at[None, :, :] + s_off).reshape(k * n, 3)
            shadow_d = light_dir.reshape(k * n, 3)
            shadow_excl = jnp.broadcast_to(prim_id[None, :], (k, n)).reshape(
                k * n
            )
            shadow_valid = jnp.broadcast_to(active[None, :], (k, n)).reshape(
                k * n
            )
            shadow_cap = light_dist.reshape(k * n)

        last = bounce + 1 >= cfg.bounces
        if not last:
            # Reflection continuation (compute.wgsl:267-276).
            refl_dir = _normalize(_reflect(cur_d, normal))
            r_side = jnp.sum(refl_dir * normal, axis=-1)
            r_off = jnp.where(r_side[:, None] < 0.0, -0.001, 0.001) * normal
            next_o = at + r_off
            next_d = refl_dir

        # ONE fused secondary trace: K*N shadow rays + N reflection rays.
        if k and not last:
            all_o = jnp.concatenate([shadow_o, next_o])
            all_d = jnp.concatenate([shadow_d, next_d])
            all_excl = jnp.concatenate(
                [shadow_excl, jnp.zeros((n,), dtype=shadow_excl.dtype)]
            )
            all_valid = jnp.concatenate([shadow_valid, active])
            all_cap = jnp.concatenate(
                [shadow_cap, jnp.full((n,), cfg.t_max, dtype=jnp.float32)]
            )
            st, sid = secondary_fn(
                all_o, all_d, all_excl, all_valid, t_cap=all_cap
            )
            sh_t, sh_id = st[: k * n], sid[: k * n]
            t, prim_id = st[k * n :], sid[k * n :]
            ray_o, ray_d = next_o, next_d
        elif k:
            sh_t, sh_id = secondary_fn(
                shadow_o, shadow_d, shadow_excl, shadow_valid,
                t_cap=shadow_cap,
            )
        elif not last:
            t, prim_id = secondary_fn(
                next_o, next_d, jnp.zeros((n,), dtype=jnp.int32), active
            )
            ray_o, ray_d = next_o, next_d

        diffuse = jnp.zeros((n,), dtype=jnp.float32)
        spec = jnp.zeros((n,), dtype=jnp.float32)
        if k:
            if scene.no_negative_materials:
                real = sh_id != 0
            else:
                real = scene.prim_mat[sh_id] != -1
            sh_valid = real & (sh_t < cfg.t_max) & (sh_t > cfg.t_min)
            # |shadow_hit.at - origin| == t (compute.wgsl:206).
            shadowed = (
                sh_valid.reshape(k, n)
                & (sh_t.reshape(k, n) < light_dist)
            )
            for ki in range(k):
                diff_k, spec_k = _light_terms(
                    lp[ki], ls[ki], at, normal, cur_d, mat_spec
                )
                lit = (~shadowed[ki]) & (ls[ki] > 0.0)
                diffuse = diffuse + jnp.where(lit, diff_k, 0.0)
                spec = spec + jnp.where(lit, spec_k, 0.0)

        color_temp = (
            mat_color * (diffuse * mat_albedo[:, 0])[:, None]
            + (spec * mat_albedo[:, 1])[:, None]
        )
        scale = 1.0 if bounce == 0 else mat_albedo[:, 2][:, None]
        contrib = color_temp * scale
        color = color + jnp.where(active[:, None], contrib, 0.0)

    return color


# ----------------------------------------------------------------------
# Tiled frame path: component-major ray tiles end to end.
#
# The XLA bounce loop above is the semantic reference (oracle-verified).
# Its [N, 3] arrays and per-bounce reshapes are replaced below by the
# packet tracer's native layout ([8, T, r]: components first, rays
# last), with per-bounce shading as whole-array elementwise math
# (rt_rs_tpu/ops/shade_tile.py).  Same math op-for-op; outputs agree
# with trace() to ~1 ULP (tests/test_shade_tiled.py).

# Tiled intersect: fn(payload [8,T,r], valid [T,r], t_cap=None [T,r])
#   -> (t [T,r], pid [T,r]); payload row 6 carries the exclusion id.
TiledIntersectFn = Callable[..., tuple[jax.Array, jax.Array]]


def camera_ray_tiles(
    camera_pos: jax.Array,  # [3]
    camera_at: jax.Array,  # [3]
    width: int,
    height: int,
    ray_tile: int,
    y_offset: jax.Array | int = 0,
    rows: int | None = None,
    block: tuple[int, int] | None = None,
) -> tuple[jax.Array, jax.Array, int]:
    """Primary rays as component-major tiles.

    -> (payload [8, T, r], valid [T, r], n_pixels) where ``T`` is padded
    to a multiple of the packet tracer's TILE_GROUP and ``n_pixels`` is the
    block-padded pixel count (= what :func:`unblock_colors` consumes).
    Per-ray values are bit-identical to :func:`camera_rays`; only the
    memory layout differs (no [N, 3] arrays are materialized).
    """
    from rt_rs_tpu.ops.pallas.packet_trace import TILE_GROUP

    if rows is None:
        rows = height
    dir_ = _normalize((camera_at - camera_pos)[None, :])[0]
    up = jnp.array([0.0, 1.0, 0.0], dtype=jnp.float32)
    right = jnp.cross(dir_, up)

    norm_x, norm_y, n_pixels = _pixel_grid(
        width, height, rows, y_offset, block
    )

    t_tiles = -(-n_pixels // ray_tile)
    t_tiles = -(-t_tiles // TILE_GROUP) * TILE_GROUP
    n_pad = t_tiles * ray_tile
    norm_x = jnp.pad(norm_x, (0, n_pad - n_pixels))
    norm_y = jnp.pad(norm_y, (0, n_pad - n_pixels))

    # Same per-component arithmetic as camera_rays (pt - pos, then
    # v * rsqrt(sum v^2)), on [N]-shaped arrays (full lanes).
    px = right[0] * norm_x + up[0] * norm_y + camera_pos[0] + dir_[0]
    py = right[1] * norm_x + up[1] * norm_y + camera_pos[1] + dir_[1]
    pz = right[2] * norm_x + up[2] * norm_y + camera_pos[2] + dir_[2]
    vx = px - camera_pos[0]
    vy = py - camera_pos[1]
    vz = pz - camera_pos[2]
    rinv = jax.lax.rsqrt(vx * vx + vy * vy + vz * vz)
    shape = (1, t_tiles, ray_tile)
    payload = jnp.concatenate(
        [
            jnp.broadcast_to(camera_pos[0], shape),
            jnp.broadcast_to(camera_pos[1], shape),
            jnp.broadcast_to(camera_pos[2], shape),
            (vx * rinv).reshape(shape),
            (vy * rinv).reshape(shape),
            (vz * rinv).reshape(shape),
            jnp.zeros(shape, dtype=jnp.float32),  # excl
            jnp.zeros(shape, dtype=jnp.float32),
        ],
        axis=0,
    )
    valid = (
        jnp.arange(n_pad, dtype=jnp.int32) < n_pixels
    ).reshape(t_tiles, ray_tile)
    return payload, valid, n_pixels


def _invert_perm(perm: jax.Array) -> jax.Array:
    """Inverse of a permutation [T] int32 via one scatter."""
    n = perm.shape[0]
    return (
        jnp.zeros((n,), jnp.int32)
        .at[perm]
        .set(jnp.arange(n, dtype=jnp.int32))
    )


def trace_tiled(
    scene: SceneArrays,
    intersect_fn: TiledIntersectFn,
    cfg: ComputeConfig,
    payload: jax.Array,  # [8, T, r] primary rays
    valid: jax.Array,  # [T, r]
    camera_pos: jax.Array,  # [3] (headlight position)
    intersect_anyhit_fn: TiledIntersectFn | None = None,
    shadow_cull: bool = True,
    retile: bool = False,
    narrow: int | None = None,
) -> jax.Array:
    """The bounce loop over component-major ray tiles -> color [3, T, r].

    Semantics identical to :func:`trace` (same light order: headlight
    first); requires ``scene.no_negative_materials`` (shadow validity
    via ``pid != 0``).  Hit rows come from ONE [N, 32] shade-table
    gather per bounce.

    ``intersect_anyhit_fn`` (when the backend provides one) traces each
    bounce's shadow rays as an occlusion-only call and the next
    bounce's rays as their own closest-hit call.  Without it, the
    shadow and next-bounce rays share one closest-hit call.

    ``shadow_cull`` (default on) drops shadow rays whose light cannot
    contribute whatever the occlusion verdict is (back-facing diffuse
    AND zero specular — shade_pre's per-light contribution mask): the
    verdict of such a ray is multiplied by exactly-zero terms in
    shade_post, so removing it from the intersect batch is
    output-exact while the cull prunes the dropped rays' chunk work.

    ``retile`` (live-tile compaction between bounces): after each
    bounce's liveness update, whole ray tiles are permuted so tiles
    with a live ray pack to the FRONT (a stable [T]-element argsort —
    spatial order among live tiles is preserved), leaving the dead
    tiles as one contiguous tail.  Tile membership is unchanged (whole
    tiles move), so every per-tile cull set is IDENTICAL and outputs
    match retile=False up to XLA fusion (~1 ULP).  Color contributions
    are gathered back through the composed tile permutation.

    ``narrow`` (lane count, e.g. 128): secondary/shadow intersect
    calls run on split ray tiles — [.., T, r] reshaped to
    [.., T*m, narrow] (ray order is row-major preserved, tile t
    becomes m consecutive sub-tiles), so divergent batches cull over
    narrower ray unions; outputs reshape back exactly.  Primaries are
    never split."""
    from rt_rs_tpu.ops.shade_tile import shade_post, shade_pre

    if not scene.no_negative_materials:
        # Must survive python -O: shade_post's pid != 0 shadow test
        # would silently treat negative-material prims as occluders.
        raise ValueError(
            "trace_tiled requires scene.no_negative_materials; use the "
            "XLA trace() path for scenes with negative materials"
        )
    t_tiles, r = valid.shape
    light_rows = []
    if cfg.camera_light_source > 0.0:
        light_rows.append(
            jnp.concatenate(
                [
                    camera_pos.astype(jnp.float32),
                    jnp.full((1,), cfg.camera_light_source, jnp.float32),
                ]
            )
        )
    for j in range(scene.num_lights):
        light_rows.append(
            jnp.concatenate(
                [
                    scene.light_pos[j].astype(jnp.float32),
                    scene.light_strength[j].reshape(1).astype(jnp.float32),
                ]
            )
        )
    k = len(light_rows)
    color = jnp.zeros((3, t_tiles, r), dtype=jnp.float32)
    if k == 0:
        # No light sources at all: every bounce contributes zero
        # (ambience is dead config, exactly like the reference shader).
        return color
    lights = jnp.stack(light_rows)  # [k, 4]
    table = scene.shade_table

    def narrowed(fn):
        """Tile split for one intersect call (``narrow``): inputs
        [.., T', r] -> [.., T'*m, narrow], outputs reshaped back."""
        if fn is None or narrow is None or r <= narrow:
            return fn
        if r % narrow:
            raise ValueError(f"narrow={narrow} must divide ray_tile={r}")
        m = r // narrow

        def split(x):
            if x is None:
                return None
            if x.ndim == 2:
                return x.reshape(x.shape[0] * m, narrow)
            return x.reshape(x.shape[0], x.shape[1] * m, narrow)

        def unsplit(x):
            if x.ndim == 2:
                return x.reshape(x.shape[0] // m, r)
            return x.reshape(x.shape[0], x.shape[1] // m, r)

        def fn2(payload, valid, t_cap=None, **kw):
            out = fn(split(payload), split(valid), t_cap=split(t_cap), **kw)
            if isinstance(out, tuple):
                return tuple(unsplit(o) for o in out)
            return unsplit(out)

        fn2.supports_refine = getattr(fn, "supports_refine", False)
        return fn2

    def secondary(fn, *args, **kw):
        # Secondary/shadow batches opt into the per-ray cull refinement
        # when the backend supports it: reflected directions diverge
        # within a tile, collapsing the interval cull.  Primaries stay
        # on the cheaper interval cull (coherent rays).
        if getattr(fn, "supports_refine", False):
            kw["refine"] = True
        return fn(*args, **kw)

    def liveness(t, pid, active, pay, o2c):
        """Per-bounce validity update, optional live-tile compaction
        (``retile``) and the hit rows.  Under retile the permutation is
        applied BEFORE the row gather.  Validity via ``pid != 0`` is
        exactly the ``rows[25] != -1`` test (no_negative_materials is
        required above: only the null sentinel row 0 has material -1)."""
        pid = jnp.where(active, pid, 0)
        active = active & (pid != 0) & (t < cfg.t_max) & (t > cfg.t_min)
        if retile:
            perm = jnp.argsort(
                ~jnp.any(active, axis=1), stable=True
            ).astype(jnp.int32)
            inv = _invert_perm(perm)
            o2c = inv if o2c is None else jnp.take(inv, o2c)
            t = jnp.take(t, perm, axis=0)
            pid = jnp.take(pid, perm, axis=0)
            active = jnp.take(active, perm, axis=0)
            pay = jnp.take(pay, perm, axis=1)
        with jax.named_scope("shade"):
            rows = table[pid.reshape(-1)].T.reshape(32, t_tiles, r)
        return t, pid, rows, active, pay, o2c

    def add_color(color, contrib, o2c):
        """Accumulate a bounce's contribution (in that bounce's tile
        order) into the original-order image: a bijective tile
        permutation maps every tile somewhere, so one [T]-index gather
        restores original order."""
        if o2c is None:
            return color + contrib
        return color + jnp.take(contrib, o2c, axis=1)

    def shadow_valids(active, cmasks):
        if not shadow_cull:
            return [active] * k
        return [active & (m > 0.0) for m in cmasks]

    n_intersect_fn = narrowed(intersect_fn)
    n_anyhit_fn = narrowed(intersect_anyhit_fn)

    t, pid = intersect_fn(payload, valid)
    t, pid, rows, active, payload, o2c = liveness(
        t, pid, valid, payload, None
    )
    sh_pays, caps, cmasks, nxt = shade_pre(
        rows, payload, t, pid.astype(jnp.float32), lights,
        emit_next=cfg.bounces > 1,
    )

    for bounce in range(cfg.bounces):
        last = bounce + 1 >= cfg.bounces
        sh_valids = shadow_valids(active, cmasks)
        if intersect_anyhit_fn is not None:
            blocked = secondary(
                n_anyhit_fn,
                jnp.concatenate(sh_pays, axis=1),
                jnp.concatenate(sh_valids),
                t_cap=jnp.concatenate(caps),
            )
            sh_t = blocked.reshape(k, t_tiles, r).astype(jnp.float32)
            sh_id = sh_t
            if not last:
                t2, pid2 = secondary(n_intersect_fn, nxt, active)
        else:
            tail_cap = [jnp.full((t_tiles, r), cfg.t_max, jnp.float32)]
            st, sid = secondary(
                n_intersect_fn,
                jnp.concatenate(sh_pays + ([] if last else [nxt]), axis=1),
                jnp.concatenate(sh_valids + ([] if last else [active])),
                t_cap=jnp.concatenate(caps + ([] if last else tail_cap)),
            )
            sh_t = st[: k * t_tiles].reshape(k, t_tiles, r)
            sh_id = sid[: k * t_tiles].reshape(k, t_tiles, r)
            if not last:
                t2, pid2 = st[k * t_tiles :], sid[k * t_tiles :]

        color = add_color(
            color,
            shade_post(
                rows, payload, t, active,
                sh_t, sh_id.astype(jnp.float32), jnp.stack(caps), lights,
                first_bounce=bounce == 0,
                t_min=cfg.t_min, t_max=cfg.t_max,
                blocked_mode=intersect_anyhit_fn is not None,
            ),
            o2c,
        )
        if last:
            break
        # liveness may retile the NEXT bounce's state; this bounce's
        # shade_post above ran in the CURRENT order (o2c).
        t, pid, rows, active, payload, o2c = liveness(
            t2, pid2, active, nxt, o2c
        )
        sh_pays, caps, cmasks, nxt = shade_pre(
            rows, payload, t, pid.astype(jnp.float32), lights,
            emit_next=bounce + 2 < cfg.bounces,
        )

    return color


def render_tiled(
    scene: SceneArrays,
    intersect_fn: TiledIntersectFn,
    cfg: ComputeConfig,
    camera_pos: jax.Array,
    camera_at: jax.Array,
    width: int,
    height: int,
    ray_tile: int,
    block: tuple[int, int] | None = None,
    intersect_anyhit_fn: TiledIntersectFn | None = None,
    shadow_cull: bool = True,
    retile: bool = False,
    narrow: int | None = None,
) -> jax.Array:
    """Full frame via the tiled path -> color [H, W, 3] float32.

    Output matches :func:`render` to ~1 ULP (FMA contraction)."""
    payload, valid, n_pixels = camera_ray_tiles(
        camera_pos, camera_at, width, height, ray_tile, block=block
    )
    color = trace_tiled(
        scene, intersect_fn, cfg, payload, valid, camera_pos,
        intersect_anyhit_fn=intersect_anyhit_fn,
        shadow_cull=shadow_cull, retile=retile, narrow=narrow,
    )
    flat = color.reshape(3, -1)[:, :n_pixels].T  # [n_pixels, 3]
    if block is not None:
        return unblock_colors(flat, width, height, block)
    return flat.reshape(height, width, 3)
