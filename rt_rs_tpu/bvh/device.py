"""On-device LBVH construction of checkpoint-compatible trees.

The reference can only build its BVH recursively on the CPU and ships
``precompute`` to amortize that cost into a ``*.bvh.json`` checkpoint
(``src/tools/precompute.rs:5-65``).  Here the heavy phases run on the
device — Morton codes, the sort, Karras' parallel hierarchy emit and the
bottom-up AABB refit (``rt_rs_tpu.ops.lbvh``) — and only the final
preorder flatten (a pointer-chasing serialization, inherently
sequential) happens on the host.  The result is a regular
:class:`~rt_rs_tpu.bvh.BvhData`: loadable by the ``bvh``/``pbvh``
handlers, serializable to the reference's checkpoint JSON, one prim per
leaf.

This is the consumer of ``karras_hierarchy``/``refit_bounds``; exposed
to users as ``python -m rt_rs_tpu.tools.precompute --device``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rt_rs_tpu.bvh import BvhData
from rt_rs_tpu.ops.lbvh import karras_hierarchy, morton_codes, morton_order, refit_bounds


@jax.jit
def _device_phases(a: jax.Array, b: jax.Array, c: jax.Array):
    """Device part: corners [P, 3] -> (order, left, right, left_leaf,
    right_leaf, node_min, node_max, leaf_min, leaf_max)."""
    third = jnp.float32(1.0 / 3.0)
    cent = (a + b + c) * third
    lo = jnp.min(jnp.minimum(jnp.minimum(a, b), c), axis=0)
    hi = jnp.max(jnp.maximum(jnp.maximum(a, b), c), axis=0)
    codes = morton_codes(cent, lo, hi)
    order = morton_order(codes)
    codes_sorted = codes[order]

    left, right, left_leaf, right_leaf, _, _ = karras_hierarchy(codes_sorted)

    tri_min = jnp.minimum(jnp.minimum(a, b), c)[order]
    tri_max = jnp.maximum(jnp.maximum(a, b), c)[order]
    node_min, node_max = refit_bounds(
        left, right, left_leaf, right_leaf, tri_min, tri_max
    )
    return order, left, right, left_leaf, right_leaf, node_min, node_max, tri_min, tri_max


def build_bvh_device(scene) -> BvhData:
    """Scene -> flattened one-prim-per-leaf LBVH, built on device."""
    verts = jnp.asarray(scene.vert_pos, jnp.float32)
    idx = jnp.asarray(scene.prim_indices.astype(np.int32))
    p = int(idx.shape[0])
    if p == 0:
        raise ValueError("cannot build a BVH for a scene with no prims")
    a, b, c = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]

    (order, left, right, left_leaf, right_leaf,
     node_min, node_max, leaf_min, leaf_max) = map(
        np.asarray, _device_phases(a, b, c)
    )

    if p == 1:
        return BvhData(
            fst=np.zeros(1, np.uint32),
            snd=np.zeros(1, np.uint32),
            item_idx=np.zeros(1, np.uint32),
            item_count=np.ones(1, np.uint32),
            bounds_min=leaf_min.astype(np.float32),
            bounds_max=leaf_max.astype(np.float32),
            indices=order.astype(np.uint32),
        )

    # Preorder flatten (host): Karras internal node 0 is the root;
    # leaves are the Morton-sorted prims.  The same parent-slot patching
    # as BvhData.from_tree keeps the reference's preorder invariant
    # (children at strictly larger indices), so escape_links and the
    # handlers work unchanged.
    n = 2 * p - 1
    fst = np.zeros(n, np.uint32)
    snd = np.zeros(n, np.uint32)
    item_idx = np.zeros(n, np.uint32)
    item_count = np.zeros(n, np.uint32)
    bmin = np.zeros((n, 3), np.float32)
    bmax = np.zeros((n, 3), np.float32)
    indices = np.zeros(p, np.uint32)

    cursor = 0  # next node slot
    emitted = 0  # prims emitted into `indices`

    def alloc(node: int, leaf: bool) -> int:
        nonlocal cursor, emitted
        slot = cursor
        cursor += 1
        if leaf:
            item_idx[slot] = emitted
            item_count[slot] = 1
            indices[emitted] = order[node]
            emitted += 1
            bmin[slot] = leaf_min[node]
            bmax[slot] = leaf_max[node]
        else:
            bmin[slot] = node_min[node]
            bmax[slot] = node_max[node]
        return slot

    stack: list[tuple[int, bool, int, str]] = []
    root_slot = alloc(0, False)
    stack.append((int(right[0]), bool(right_leaf[0]), root_slot, "snd"))
    stack.append((int(left[0]), bool(left_leaf[0]), root_slot, "fst"))
    while stack:
        node, leaf, parent, side = stack.pop()
        slot = alloc(node, leaf)
        if side == "fst":
            fst[parent] = slot
        else:
            snd[parent] = slot
        if not leaf:
            stack.append((int(right[node]), bool(right_leaf[node]), slot, "snd"))
            stack.append((int(left[node]), bool(left_leaf[node]), slot, "fst"))

    assert cursor == n and emitted == p
    return BvhData(
        fst=fst, snd=snd, item_idx=item_idx, item_count=item_count,
        bounds_min=bmin, bounds_max=bmax, indices=indices,
    )
