"""Per-bounce shading over component-major ray tiles, in plain ``jnp``.

The tiled frame path (:func:`rt_rs_tpu.ops.shade.trace_tiled`) keeps
rays in the packet tracer's layout end to end: every per-ray quantity is
a ``[T, r]`` array and every vector a ``[C, T, r]`` stack of them, so the
bounce's shading is elementwise math on whole arrays — barycentric
normal interpolation, Blinn/Phong terms, shadow/reflection ray
construction, color accumulation (compute.wgsl:120-280) — which XLA
fuses into a few kernels.

Each bounce is split at its intersect call:

* :func:`shade_pre` — hit position + interpolated normal, then the
  shadow ray payload/cap per light and the reflection continuation
  payload (compute.wgsl:189-212, 267-276).
* :func:`shade_post` — shadow verdicts, per-light diffuse/specular,
  color contribution (compute.wgsl:219-265).

Numerical parity: op-for-op the same f32 operations as the XLA
reference bounce loop (:func:`rt_rs_tpu.ops.shade.trace`, itself
oracle-verified); outputs agree to ~1 ULP (tests/test_shade_tiled.py).
Values for dead rays are garbage; every consumer masks by validity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _hit_normal(C, o, d, t):
    """at + interpolated unit normal, op-for-op the XLA
    ``_hit_from_rows`` (shade.py; compute.wgsl:120-151 incl. the corner
    rotation already baked into the shade-table column order).  ``C(c)``
    reads shade-table column ``c`` of the hit prims."""
    ox, oy, oz = o
    dx, dy, dz = d
    hx = ox + dx * t
    hy = oy + dy * t
    hz = oz + dz * t
    bx, by, bz = C(0), C(1), C(2)
    cx, cy, cz = C(3), C(4), C(5)
    ax, ay, az = C(6), C(7), C(8)
    v0x, v0y, v0z = bx - ax, by - ay, bz - az
    v1x, v1y, v1z = cx - ax, cy - ay, cz - az
    v2x, v2y, v2z = hx - ax, hy - ay, hz - az
    d00 = v0x * v0x + v0y * v0y + v0z * v0z
    d01 = v0x * v1x + v0y * v1y + v0z * v1z
    d11 = v1x * v1x + v1y * v1y + v1z * v1z
    d20 = v2x * v0x + v2y * v0y + v2z * v0z
    d21 = v2x * v1x + v2y * v1y + v2z * v1z
    denom = d00 * d11 - d01 * d01
    denom = jnp.where(denom == 0.0, 1.0, denom)
    vv = (d11 * d20 - d01 * d21) / denom
    ww = (d00 * d21 - d01 * d20) / denom
    uu = 1.0 - vv - ww
    nx = C(9) * vv + C(12) * ww + C(15) * uu
    ny = C(10) * vv + C(13) * ww + C(16) * uu
    nz = C(11) * vv + C(14) * ww + C(17) * uu
    rn = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz)
    return (hx, hy, hz), (nx * rn, ny * rn, nz * rn)


def _offset(side, v):
    """The reference's 0.001 surface offset toward ``side``'s sign."""
    return jnp.where(side < 0.0, jnp.float32(-0.001), jnp.float32(0.001)) * v


@jax.named_scope("shade")
def shade_pre(
    rows: jax.Array,  # [32, T, r] shade-table columns of the hit prims
    payload: jax.Array,  # [8, T, r] current rays
    t: jax.Array,  # [T, r]
    pid_f: jax.Array,  # [T, r] f32 hit prim ids
    lights: jax.Array,  # [k, 4] (pos xyz, strength); headlight first
    emit_next: bool,
):
    """-> (shadow payloads [k][8,T,r], caps [k][T,r], contribution
    masks [k][T,r] f32 1.0/0.0, next [8,T,r] | None).

    Shadow payload row 7 carries the ray's occlusion bound (its light
    distance) for the any-hit tracer.  A mask of 0.0 means this light
    cannot contribute to the ray's color whatever the shadow verdict is
    (back-facing diffuse AND zero specular) — the caller drops those
    shadow rays from the intersect batch (zero-contribution cull)."""
    C = lambda c: rows[c]
    o = (payload[0], payload[1], payload[2])
    d = (payload[3], payload[4], payload[5])
    (hx, hy, hz), (nx, ny, nz) = _hit_normal(C, o, d, t)
    dx, dy, dz = d
    spec_pow = C(24)

    sh_pays, caps, masks = [], [], []
    for li in range(int(lights.shape[0])):
        lx, ly, lz, ls = lights[li, 0], lights[li, 1], lights[li, 2], lights[li, 3]
        ddx, ddy, ddz = lx - hx, ly - hy, lz - hz
        s = ddx * ddx + ddy * ddy + ddz * ddz
        dist = jnp.sqrt(s)
        inv = jax.lax.rsqrt(s)
        ux, uy, uz = ddx * inv, ddy * inv, ddz * inv
        side = ux * nx + uy * ny + uz * nz
        sh_pays.append(
            jnp.stack(
                [
                    hx + _offset(side, nx),
                    hy + _offset(side, ny),
                    hz + _offset(side, nz),
                    ux, uy, uz, pid_f, dist,
                ]
            )
        )
        caps.append(dist)
        # Zero-contribution shadow cull: the blocked verdict is
        # unobservable when BOTH of shade_post's terms for this light
        # are zero — diffuse needs side > 0, specular needs sdot > 0
        # (pow(0, p) == 0 for p > 0; p <= 0 keeps the ray since
        # pow(0, 0) == 1), and either needs strength > 0.  sdot uses
        # shade_post's op sequence (compute.wgsl:160-175).
        eux, euy, euz = -ux, -uy, -uz
        den = eux * nx + euy * ny + euz * nz
        rfx = eux - 2.0 * den * nx
        rfy = euy - 2.0 * den * ny
        rfz = euz - 2.0 * den * nz
        sdot = (-rfx) * dx + (-rfy) * dy + (-rfz) * dz
        need = (ls > 0.0) & ((side > 0.0) | (sdot > 0.0) | (spec_pow <= 0.0))
        masks.append(need.astype(jnp.float32))

    nxt = None
    if emit_next:
        # reflect(d, n) = d - 2 dot(d, n) n, normalized
        # (compute.wgsl:267-276).
        dn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * dn * nx
        ry = dy - 2.0 * dn * ny
        rz = dz - 2.0 * dn * nz
        rr = jax.lax.rsqrt(rx * rx + ry * ry + rz * rz)
        rx, ry, rz = rx * rr, ry * rr, rz * rr
        rside = rx * nx + ry * ny + rz * nz
        zero = jnp.zeros_like(rx)
        nxt = jnp.stack(
            [
                hx + _offset(rside, nx),
                hy + _offset(rside, ny),
                hz + _offset(rside, nz),
                rx, ry, rz, zero, zero,
            ]
        )
    return sh_pays, caps, masks, nxt


@jax.named_scope("shade")
def shade_post(
    rows: jax.Array,  # [32, T, r]
    payload: jax.Array,  # [8, T, r] this bounce's rays
    t: jax.Array,  # [T, r]
    active: jax.Array,  # [T, r] bool
    sh_t: jax.Array,  # [k, T, r] — or the any-hit blocked mask (f32)
    sh_id_f: jax.Array,  # [k, T, r] f32 (ignored in blocked_mode)
    caps: jax.Array,  # [k, T, r] shade_pre's light distances
    lights: jax.Array,  # [k, 4]
    first_bounce: bool,
    t_min: float,
    t_max: float,
    blocked_mode: bool = False,
) -> jax.Array:
    """-> color contribution [3, T, r] (active-masked, scaled).

    The closest-hit shadow verdict compares against ``caps`` — the same
    value the any-hit tracer capped with."""
    C = lambda c: rows[c]
    o = (payload[0], payload[1], payload[2])
    d = (payload[3], payload[4], payload[5])
    (hx, hy, hz), (nx, ny, nz) = _hit_normal(C, o, d, t)
    dx, dy, dz = d
    spec_pow = C(24)

    diffuse = jnp.zeros_like(t)
    spec = jnp.zeros_like(t)
    for li in range(int(lights.shape[0])):
        lx, ly, lz, ls = lights[li, 0], lights[li, 1], lights[li, 2], lights[li, 3]
        ddx, ddy, ddz = lx - hx, ly - hy, lz - hz
        s = ddx * ddx + ddy * ddy + ddz * ddz
        inv = jax.lax.rsqrt(s)
        ux, uy, uz = ddx * inv, ddy * inv, ddz * inv
        if blocked_mode:
            # The any-hit tracer already applied the full occlusion
            # predicate per ray.
            shadowed = sh_t[li] > 0.0
        else:
            shadowed = (
                (sh_id_f[li] != 0.0)
                & (sh_t[li] < t_max)
                & (sh_t[li] > t_min)
                & (sh_t[li] < caps[li])
            )
        lit = (~shadowed) & (ls > 0.0)
        # diffuse (compute.wgsl:160-166)
        dterm = ls * jnp.maximum(0.0, ux * nx + uy * ny + uz * nz)
        # specular via reflect(-u, n) (compute.wgsl:168-175)
        eux, euy, euz = -ux, -uy, -uz
        den = eux * nx + euy * ny + euz * nz
        rx = eux - 2.0 * den * nx
        ry = euy - 2.0 * den * ny
        rz = euz - 2.0 * den * nz
        sdot = (-rx) * dx + (-ry) * dy + (-rz) * dz
        sterm = jnp.power(jnp.maximum(0.0, sdot), spec_pow) * ls
        diffuse = diffuse + jnp.where(lit, dterm, 0.0)
        spec = spec + jnp.where(lit, sterm, 0.0)

    da = diffuse * C(21)
    sa = spec * C(22)
    # albedo.z attenuation for bounce > 0 (compute.wgsl:258-265)
    scale = jnp.float32(1.0) if first_bounce else C(23)
    return jnp.stack(
        [jnp.where(active, (C(18 + c) * da + sa) * scale, 0.0) for c in range(3)]
    )
