"""Device-resident scene arrays (the bind-group(2) equivalent).

The reference uploads five buffers — camera UBO + prims / vertices /
lights / materials storage buffers (``src/lib/scene/mod.rs:133-272``).
The layout here is a pytree of SoA ``jax.Array``s with two
deliberate differences:

* Per-primitive corner data is pre-gathered: ``pa/pb/pc`` (positions)
  and ``na/nb/nc`` (normals) are contiguous ``[P, 3]`` arrays, so hot
  kernels never perform ``prim -> vertex`` index chasing (the WGSL does
  this gather per ray per test, ``compute.wgsl:124-126, 144-146``;
  here it is hoisted to pack time since the mesh is static per frame).
* The null/miss sentinel prim (material ``-1``) occupies row 0, same
  convention as ``scene/mod.rs:161-166``, so "prim id 0" always means
  miss and gathers need no bounds branches.

The camera is intentionally *not* part of this pytree — it changes every
frame (orbit), so it is a separate small argument to the jitted step,
mirroring the reference's live camera buffer writes
(``state/mod.rs:718-728``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def intersect_indices(prim_indices: np.ndarray) -> np.ndarray:
    """Vertex-index triples as seen by the INTERSECTION path: each later
    exact duplicate of an earlier ordered triple is collapsed to a
    zero-area ``(a, a, a)`` triangle.

    The reference's shadow/bounce self-exclusion compares the excluded
    prim's vertex-index TRIPLE, not its prim id
    (``handlers/basic.rs:87-91``: a candidate is tested only if ANY of
    a/b/c differs), so an exact duplicate triangle (same ordered triple
    under a different prim id) is (1) excluded together with its twin
    and (2) never otherwise observable — identical corner data gives a
    bit-identical ``t``, and the strict ``<`` replace in the ascending
    scan (``compute.wgsl`` / ``basic.rs:95-104``) keeps the
    first-scanned copy, so the lower prim id always wins the tie.

    Collapsing the later copy to a degenerate triangle (Möller–Trumbore
    ``det == 0`` → the eps dead zone → guaranteed miss in every backend,
    including padding slots, which already rely on this) therefore
    reproduces the reference's triple semantics EXACTLY while every
    backend keeps its zero-cost prim-id exclusion: the collapsed copy
    never hits (so the lower id wins closest-hit ties, and its id can
    never become an exclusion key), and excluding the canonical copy by
    id excludes "all prims with that triple" because the others cannot
    hit.  ``(a, a, a)`` rather than all-zeros keeps the slot's corners
    at a real mesh vertex so chunk/leaf bounds stay local.  Identity
    (same object returned) when there are no duplicates — the case for
    every bundled scene and every OBJ import (importers never emit
    duplicate faces).  Gated against the triple-faithful oracle by
    tests/test_duplicates.py.
    """
    idx = np.asarray(prim_indices)
    if idx.shape[0] < 2:
        return idx
    _, first = np.unique(idx, axis=0, return_index=True)
    if first.shape[0] == idx.shape[0]:
        return idx
    canon = np.zeros(idx.shape[0], dtype=bool)
    canon[first] = True
    out = idx.copy()
    out[~canon, 1] = out[~canon, 0]
    out[~canon, 2] = out[~canon, 0]
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneArrays:
    # Per-prim (row 0 = null sentinel): material id, corner positions,
    # corner normals.  [P, 3] float32 / [P] int32.
    prim_mat: jax.Array
    pa: jax.Array
    pb: jax.Array
    pc: jax.Array
    na: jax.Array
    nb: jax.Array
    nc: jax.Array
    # Lights: [L, 3] / [L]
    light_pos: jax.Array
    light_strength: jax.Array
    # Materials: [M, 3] / [M, 3] / [M]  (M >= 1; padded with a dummy)
    mat_color: jax.Array
    mat_albedo: jax.Array
    mat_spec: jax.Array
    # Combined per-prim shading row [P, 32] float32: everything the
    # bounce loop needs about a hit prim in ONE gather (one [N,32]
    # row gather instead of ten separate [N,3] ones).  Layout: pa pb pc na nb nc
    # mat_color mat_albedo (3 each) | mat_spec | prim_mat | pad.
    shade_table: jax.Array
    # True if no *real* prim carries material -1 (all bundled scenes):
    # lets validity checks use `prim_id != 0` instead of a gather.
    no_negative_materials: bool = dataclasses.field(
        metadata=dict(static=True), default=True
    )

    @property
    def num_prims(self) -> int:
        """Prim count *including* the null sentinel at row 0."""
        return int(self.prim_mat.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.light_strength.shape[0])

    @classmethod
    def from_scene(cls, scene) -> "SceneArrays":
        p = scene.num_prims
        # Duplicate-triple collapse (reference triple-based
        # self-exclusion, see intersect_indices): affects only scenes
        # with exact duplicate triangles — identity for every bundled
        # scene and OBJ import.
        idx = intersect_indices(scene.prim_indices).astype(np.int64)
        vp = scene.vert_pos.astype(np.float32)
        vn = scene.vert_norm.astype(np.float32)

        def corner(arr: np.ndarray, c: int) -> np.ndarray:
            out = np.zeros((p + 1, 3), dtype=np.float32)
            if p:
                out[1:] = arr[idx[:, c]]
            return out

        prim_mat = np.full((p + 1,), -1, dtype=np.int32)
        if p:
            prim_mat[1:] = scene.prim_material

        m = scene.mat_color.shape[0]
        mat_color = scene.mat_color.astype(np.float32)
        mat_albedo = scene.mat_albedo.astype(np.float32)
        mat_spec = scene.mat_spec.astype(np.float32)
        if m == 0:
            mat_color = np.zeros((1, 3), dtype=np.float32)
            mat_albedo = np.zeros((1, 3), dtype=np.float32)
            mat_spec = np.zeros((1,), dtype=np.float32)

        pa_, pb_, pc_ = corner(vp, 0), corner(vp, 1), corner(vp, 2)
        na_, nb_, nc_ = corner(vn, 0), corner(vn, 1), corner(vn, 2)
        mat_id = np.maximum(prim_mat, 0)
        table = np.zeros((p + 1, 32), dtype=np.float32)
        table[:, 0:3] = pa_
        table[:, 3:6] = pb_
        table[:, 6:9] = pc_
        table[:, 9:12] = na_
        table[:, 12:15] = nb_
        table[:, 15:18] = nc_
        table[:, 18:21] = mat_color[mat_id]
        table[:, 21:24] = mat_albedo[mat_id]
        table[:, 24] = mat_spec[mat_id]
        table[:, 25] = prim_mat.astype(np.float32)

        return cls(
            prim_mat=jnp.asarray(prim_mat),
            pa=jnp.asarray(pa_),
            pb=jnp.asarray(pb_),
            pc=jnp.asarray(pc_),
            na=jnp.asarray(na_),
            nb=jnp.asarray(nb_),
            nc=jnp.asarray(nc_),
            light_pos=jnp.asarray(scene.light_pos.astype(np.float32).reshape(-1, 3)),
            light_strength=jnp.asarray(scene.light_strength.astype(np.float32)),
            mat_color=jnp.asarray(mat_color),
            mat_albedo=jnp.asarray(mat_albedo),
            mat_spec=jnp.asarray(mat_spec),
            shade_table=jnp.asarray(table),
            no_negative_materials=bool((prim_mat[1:] >= 0).all()) if p else True,
        )

    def rebuild_shade_table(self) -> "SceneArrays":
        """Recompute ``shade_table`` from the (possibly updated) per-prim
        arrays — jit-traceable, for dynamic-geometry paths."""
        mat_id = jnp.maximum(self.prim_mat, 0)
        p1 = self.prim_mat.shape[0]
        table = jnp.concatenate(
            [
                self.pa, self.pb, self.pc,
                self.na, self.nb, self.nc,
                self.mat_color[mat_id],
                self.mat_albedo[mat_id],
                self.mat_spec[mat_id][:, None],
                self.prim_mat.astype(jnp.float32)[:, None],
                jnp.zeros((p1, 6), dtype=jnp.float32),
            ],
            axis=1,
        )
        return dataclasses.replace(self, shade_table=table)

    def byte_size(self) -> int:
        """Total geometry bytes, for `IntrsStats`-style reporting."""
        return sum(
            int(np.prod(f.shape)) * f.dtype.itemsize
            for f in jax.tree_util.tree_leaves(self)
        )
