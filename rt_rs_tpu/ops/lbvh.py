"""On-device LBVH construction (Morton codes + sort + Karras emit).

The reference builds its BVH recursively on the CPU and uploads it
(``src/lib/bvh/aabb.rs``); for runtime/dynamic scenes the answer
here is a linear BVH built *on device* inside the jitted step
(BASELINE.json north star):

1. quantize triangle centroids to a 30-bit Morton code (10 bits/axis);
2. sort prims by code (``jnp.argsort`` — XLA's on-device sort);
3. emit the radix-tree hierarchy with Karras' parallel algorithm
   (per-internal-node prefix ranges; no sequential dependency);
4. refit AABBs bottom-up with a fixed number of union sweeps.

For the Pallas packet backend the sorted order is the entire product:
chunks of 8 Morton-consecutive prims are spatially local, so "build"
collapses to sort + chunk-bound computation — all device ops, cheap
enough to run per frame for animated geometry.  The full hierarchy
(3-4) feeds hierarchy-based backends and validation tests.

All functions are jit-traceable with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _expand_bits_10(v: jax.Array) -> jax.Array:
    """Spread 10 bits to every 3rd position (u32)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(
    centroids: jax.Array,  # [P, 3] float32
    lo: jax.Array,  # [3]
    hi: jax.Array,  # [3]
) -> jax.Array:
    """30-bit Morton codes (x major, then y, z) -> uint32 [P]."""
    extent = jnp.maximum(hi - lo, 1e-30)
    q = jnp.clip(
        ((centroids - lo[None, :]) / extent[None, :]) * 1024.0, 0.0, 1023.0
    ).astype(jnp.uint32)
    sx = _expand_bits_10(q[:, 0])
    sy = _expand_bits_10(q[:, 1])
    sz = _expand_bits_10(q[:, 2])
    return (sx << 2) | (sy << 1) | sz


def morton_order(codes: jax.Array) -> jax.Array:
    """Stable sort permutation -> int32 [P]."""
    return jnp.argsort(codes, stable=True).astype(jnp.int32)


def _clz32(v: jax.Array) -> jax.Array:
    """Count leading zeros of uint32 (bit-smear + popcount)."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    # popcount
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (((v + (v >> 4)) & 0x0F0F0F0F) * 0x01010101) >> 24
    return (32 - v).astype(jnp.int32)


def karras_hierarchy(codes_sorted: jax.Array):
    """Parallel radix-tree emit (Karras 2012) over sorted codes.

    Returns ``(left, right, left_leaf, right_leaf, parent_leaf,
    parent_internal)``: ``left/right [P-1]`` child indices,
    ``left_leaf/right_leaf [P-1]`` bool (child is a leaf), and parent
    pointers for bottom-up refit.  Duplicate codes are disambiguated by
    index (the standard ``code << 32 | i`` trick, realized here as a
    two-level (code, index) comparison).
    """
    n = codes_sorted.shape[0]
    if n < 2:
        z = jnp.zeros((0,), jnp.int32)
        f = jnp.zeros((0,), bool)
        return z, z, f, f, jnp.zeros((n,), jnp.int32), jnp.zeros((0,), jnp.int32)

    codes = codes_sorted.astype(jnp.uint32)
    idx32 = jnp.arange(n, dtype=jnp.uint32)

    def delta(i, j):
        """Common-prefix length of keys i and j (64-bit conceptual key:
        code in the high half, index in the low half); -1 outside."""
        valid = (j >= 0) & (j < n)
        jc = jnp.clip(j, 0, n - 1)
        ci = codes[i]
        cj = codes[jc]
        x = ci ^ cj
        d_code = _clz32(x)
        # Equal codes: continue into the index bits.
        x2 = idx32[i] ^ idx32[jc]
        d_idx = 32 + _clz32(x2)
        d = jnp.where(x == 0, d_idx, d_code)
        return jnp.where(valid, d, -1)

    i = jnp.arange(n - 1, dtype=jnp.int32)
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Exponential search for the range length upper bound.
    def lmax_body(_, lmax):
        probe = delta(i, i + lmax * d) > delta_min
        return jnp.where(probe, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(
        0, 32, lmax_body, jnp.full((n - 1,), 2, dtype=jnp.int32)
    )

    # Binary search the exact other end j.
    def l_body(k, carry):
        l, t = carry
        t = jnp.maximum(t // 2, 1)
        probe = delta(i, i + (l + t) * d) > delta_min
        l = jnp.where(probe, l + t, l)
        return l, t

    l, _ = jax.lax.fori_loop(
        0, 32, l_body, (jnp.zeros((n - 1,), jnp.int32), lmax)
    )
    j = i + l * d
    delta_node = delta(i, j)

    # Split search: s += t for t = ceil(l/2), ceil(l/4), ... while the
    # prefix stays longer than delta_node.
    s = jnp.zeros((n - 1,), jnp.int32)
    div = jnp.full((n - 1,), 2, dtype=jnp.int32)

    def split_body(k, carry):
        s, div = carry
        t = (l + div - 1) // div
        probe = delta(i, i + (s + t) * d) > delta_node
        s = jnp.where(probe & (t >= 1), s + t, s)
        # Clamp the doubling: 32 unguarded doublings overflow int32
        # (div -> INT_MIN -> 0, making t an s32 division by zero whose
        # result is backend-defined).  Once div > l the probe term is
        # t=1 forever, so the clamp changes no iteration's outcome.
        return s, jnp.minimum(div * 2, jnp.int32(1 << 30))

    s, _ = jax.lax.fori_loop(0, 32, split_body, (s, div))

    gamma = i + s * d + jnp.minimum(d, 0)
    left = gamma
    right = gamma + 1
    left_leaf = jnp.minimum(i, j) == gamma
    right_leaf = jnp.maximum(i, j) == gamma + 1

    # Parent pointers (masked scatters; misses target index n -> drop).
    parent_leaf = (
        jnp.zeros((n,), jnp.int32)
        .at[jnp.where(left_leaf, left, n)]
        .set(i, mode="drop")
        .at[jnp.where(right_leaf, right, n)]
        .set(i, mode="drop")
    )
    parent_internal = (
        jnp.zeros((n - 1,), jnp.int32)
        .at[jnp.where(~left_leaf, left, n - 1)]
        .set(i, mode="drop")
        .at[jnp.where(~right_leaf, right, n - 1)]
        .set(i, mode="drop")
    )
    return left, right, left_leaf, right_leaf, parent_leaf, parent_internal


def refit_bounds(
    left, right, left_leaf, right_leaf,
    leaf_min: jax.Array,  # [P, 3] sorted-leaf bounds
    leaf_max: jax.Array,
    sweeps: int = 64,
):
    """Bottom-up AABB refit by repeated union sweeps (log-depth
    convergence; ``sweeps`` bounds the tree depth)."""
    n1 = left.shape[0]
    big = jnp.float32(3.0e38)
    node_min = jnp.full((n1, 3), big)
    node_max = jnp.full((n1, 3), -big)

    def sweep(_, carry):
        nmin, nmax = carry
        lmin = jnp.where(left_leaf[:, None], leaf_min[left], nmin[left])
        lmax = jnp.where(left_leaf[:, None], leaf_max[left], nmax[left])
        rmin = jnp.where(right_leaf[:, None], leaf_min[right], nmin[right])
        rmax = jnp.where(right_leaf[:, None], leaf_max[right], nmax[right])
        return (
            jnp.minimum(lmin, rmin),
            jnp.maximum(lmax, rmax),
        )

    node_min, node_max = jax.lax.fori_loop(
        0, sweeps, sweep, (node_min, node_max)
    )
    return node_min, node_max
