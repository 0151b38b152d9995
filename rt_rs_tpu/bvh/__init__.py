"""Flattened BVH data (the ``*.bvh.json`` checkpoint format).

``BvhData`` is the exact analogue of the reference's flattened tree
(``src/lib/bvh/mod.rs:11-27``): a preorder-DFS array of nodes
``{fst, snd, item_idx, item_count, bounds{min, max}}`` plus the
``indices`` permutation listing each leaf's prims contiguously.  The
JSON schema round-trips byte-compatibly with files produced by the
reference's ``precompute`` tool (``scenes/teatime.bvh.json``).

Addition: because the flatten order is preorder, every
node's *escape* target (where traversal resumes after skipping or
finishing the node's subtree) has a strictly larger index.  We derive
``hit_link`` / ``miss_link`` arrays that turn the per-thread stack DFS
of the reference shader (``handlers/bvh.rs:303-350``) into a stackless
threaded traversal: one index register per ray, monotonically
increasing — ideal for a vectorized wavefront (no stack memory, no
divergent push/pop, guaranteed termination in <= N steps).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

import numpy as np

from rt_rs_tpu.bvh.builder import Aabb, build_aabb_tree  # noqa: F401
from rt_rs_tpu.geom import f32_json as _f32j


@dataclasses.dataclass
class BvhData:
    """SoA form of ``Vec<AabbUniform>`` + ``Vec<u32>`` (bvh/mod.rs:24-27)."""

    fst: np.ndarray  # [N] uint32
    snd: np.ndarray  # [N] uint32
    item_idx: np.ndarray  # [N] uint32 (offset into `indices`)
    item_count: np.ndarray  # [N] uint32 (0 = interior)
    bounds_min: np.ndarray  # [N, 3] float32
    bounds_max: np.ndarray  # [N, 3] float32
    indices: np.ndarray  # [I] uint32 (prim permutation, leaf-contiguous)

    @property
    def num_nodes(self) -> int:
        return int(self.fst.shape[0])

    # ------------------------------------------------------------------
    # Flatten (bvh/mod.rs:29-64): preorder DFS, children patched in.

    @classmethod
    def from_tree(cls, root: Aabb) -> "BvhData":
        fst: list[int] = []
        snd: list[int] = []
        item_idx: list[int] = []
        item_count: list[int] = []
        bmin: list[np.ndarray] = []
        bmax: list[np.ndarray] = []
        indices: list[int] = []

        # Iterative DFS to avoid Python recursion limits on deep trees.
        # Stack entries: (node, parent_slot) where parent_slot is
        # (parent_index, "fst"|"snd") to patch after allocation.
        def alloc(node: Aabb) -> int:
            uniform = len(fst)
            fst.append(0)
            snd.append(0)
            item_idx.append(len(indices))
            item_count.append(len(node.items))
            bmin.append(node.bounds_min)
            bmax.append(node.bounds_max)
            indices.extend(int(i) for i in node.items)
            return uniform

        stack: list[tuple[Aabb, int, str]] = []
        root_idx = alloc(root)
        if root.snd is not None:
            stack.append((root.snd, root_idx, "snd"))
        if root.fst is not None:
            stack.append((root.fst, root_idx, "fst"))
        # NOTE: the reference recursion emits fst's subtree fully before
        # snd; with a LIFO we push snd first.  But children must be
        # patched in the order visited, and snd of a node is emitted
        # after fst's *entire subtree* — a plain LIFO gives exactly the
        # reference's preorder.
        while stack:
            node, parent, slot = stack.pop()
            idx = alloc(node)
            if slot == "fst":
                fst[parent] = idx
            else:
                snd[parent] = idx
            if node.snd is not None:
                stack.append((node.snd, idx, "snd"))
            if node.fst is not None:
                stack.append((node.fst, idx, "fst"))

        return cls(
            fst=np.array(fst, dtype=np.uint32),
            snd=np.array(snd, dtype=np.uint32),
            item_idx=np.array(item_idx, dtype=np.uint32),
            item_count=np.array(item_count, dtype=np.uint32),
            bounds_min=np.stack(bmin).astype(np.float32),
            bounds_max=np.stack(bmax).astype(np.float32),
            indices=np.array(indices, dtype=np.uint32),
        )

    # ------------------------------------------------------------------
    # JSON serde (bvh/mod.rs:21-27 derive; format of scenes/*.bvh.json)

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "BvhData":
        uniforms = data["uniforms"]
        n = len(uniforms)
        out = cls(
            fst=np.zeros(n, dtype=np.uint32),
            snd=np.zeros(n, dtype=np.uint32),
            item_idx=np.zeros(n, dtype=np.uint32),
            item_count=np.zeros(n, dtype=np.uint32),
            bounds_min=np.zeros((n, 3), dtype=np.float32),
            bounds_max=np.zeros((n, 3), dtype=np.float32),
            indices=np.array(data["indices"], dtype=np.uint32),
        )
        for i, u in enumerate(uniforms):
            out.fst[i] = u["fst"]
            out.snd[i] = u["snd"]
            out.item_idx[i] = u["item_idx"]
            out.item_count[i] = u["item_count"]
            out.bounds_min[i] = u["bounds"]["min"]
            out.bounds_max[i] = u["bounds"]["max"]
        return out

    def to_json(self) -> dict[str, Any]:
        return {
            "uniforms": [
                {
                    "fst": int(self.fst[i]),
                    "snd": int(self.snd[i]),
                    "item_idx": int(self.item_idx[i]),
                    "item_count": int(self.item_count[i]),
                    "bounds": {
                        "min": [_f32j(x) for x in self.bounds_min[i]],
                        "max": [_f32j(x) for x in self.bounds_max[i]],
                    },
                }
                for i in range(self.num_nodes)
            ],
            "indices": [int(i) for i in self.indices],
        }

    @classmethod
    def load(cls, path: str) -> "BvhData":
        with open(path, "r") as f:
            return cls.from_json(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    # ------------------------------------------------------------------
    # Derived structure

    def is_leaf(self) -> np.ndarray:
        """Leaf <=> item_count > 0 (bvh/mod.rs flatten invariant)."""
        return self.item_count > 0

    def escape_links(self) -> tuple[np.ndarray, np.ndarray]:
        """Threaded-traversal links -> (hit_link, miss_link), both [N]
        int32 with ``num_nodes`` as the END sentinel.

        ``miss_link[i]`` = node to visit when i's box is missed (i's
        preorder successor skipping its subtree).  ``hit_link[i]`` =
        node after entering i: ``fst`` for interior nodes, the escape
        for leaves.
        """
        n = self.num_nodes
        end = n
        miss = np.full(n, end, dtype=np.int64)
        # Children of node i escape to: fst -> snd, snd -> miss[i].
        leaf = self.is_leaf()
        order: list[int] = [0]
        # Propagate down a preorder walk (children have larger indices,
        # so a simple stack works).
        stack = [0]
        while stack:
            i = stack.pop()
            if not leaf[i]:
                f, s = int(self.fst[i]), int(self.snd[i])
                miss[f] = s
                miss[s] = miss[i]
                stack.append(f)
                stack.append(s)
        hit = np.where(leaf, miss, self.fst.astype(np.int64))
        return hit.astype(np.int32), miss.astype(np.int32)

    def cover_bounds(self, scene) -> tuple[np.ndarray, np.ndarray]:
        """Conservative per-node bounds that truly cover subtree
        geometry -> (cover_min [N,3], cover_max [N,3]) float32.

        The reference's in-place shrink (aabb.rs:221-229) stores node
        bounds that may NOT contain their children's geometry (it never
        refits after shrinking).  Its traversal is immune because its
        slab test never culls (see PARITY.md); ours culls for real, so
        traversal uses these recomputed bounds: leaf = vertex extrema of
        its prims, interior = union of child covers.  Stored bounds are
        untouched (checkpoint-format parity).
        """
        verts = scene.vert_pos.astype(np.float32)
        idx = scene.prim_indices.astype(np.int64)
        n = self.num_nodes
        fmax = np.float32(np.finfo(np.float32).max)
        cover_min = np.full((n, 3), fmax, dtype=np.float32)
        cover_max = np.full((n, 3), -fmax, dtype=np.float32)
        if idx.shape[0]:
            a, b, c = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
            pmin = np.minimum(np.minimum(a, b), c)
            pmax = np.maximum(np.maximum(a, b), c)
            leaf = self.is_leaf()
            # Preorder => children have larger indices; sweep backwards.
            for i in range(n - 1, -1, -1):
                if leaf[i]:
                    lo = int(self.item_idx[i])
                    hi = lo + int(self.item_count[i])
                    prims = self.indices[lo:hi].astype(np.int64)
                    prims = prims[prims < idx.shape[0]]
                    if prims.size:
                        cover_min[i] = pmin[prims].min(axis=0)
                        cover_max[i] = pmax[prims].max(axis=0)
                else:
                    f, s = int(self.fst[i]), int(self.snd[i])
                    cover_min[i] = np.minimum(cover_min[f], cover_min[s])
                    cover_max[i] = np.maximum(cover_max[f], cover_max[s])
        return cover_min, cover_max

    def max_depth(self) -> int:
        """Maximum tree depth (for fixed stack sizing in kernels)."""
        n = self.num_nodes
        depth = np.zeros(n, dtype=np.int64)
        leaf = self.is_leaf()
        best = 1
        stack = [0]
        while stack:
            i = stack.pop()
            if not leaf[i]:
                f, s = int(self.fst[i]), int(self.snd[i])
                depth[f] = depth[s] = depth[i] + 1
                best = max(best, int(depth[f]) + 1)
                stack.append(f)
                stack.append(s)
        return best

    def byte_size(self) -> int:
        """GPU-footprint parity: 48 B per ``AabbUniform``
        (bvh/mod.rs:11-17), as reported by ``IntrsStats``
        (handlers/bvh.rs:160-163)."""
        return 48 * self.num_nodes


def build_bvh(
    scene,
    eps: float = 0.02,
    target_item_count: int = 2,
) -> BvhData:
    """Scene -> flattened BVH (reference ``Aabb::from_scene`` +
    ``BvhData::new``; defaults from handlers/bvh.rs:33, 82).

    Uses the native C++ builder when built (bit-identical output,
    ~70x faster; ``RT_NATIVE=0`` forces the NumPy oracle)."""
    if scene.num_prims:
        from rt_rs_tpu.native import bindings

        if bindings.available():
            built = bindings.bvh_build_native(
                scene.vert_pos, scene.prim_indices, eps, target_item_count
            )
            if built is not None:
                return BvhData(**built)
    root = build_aabb_tree(scene, eps=eps, target_item_count=target_item_count)
    return BvhData.from_tree(root)


__all__ = ["BvhData", "build_bvh", "Aabb", "build_aabb_tree"]
