"""Native C++ components vs the NumPy oracles (bit-exactness)."""

import numpy as np
import pytest

from rt_rs_tpu.bvh import BvhData, build_aabb_tree
from rt_rs_tpu.native import bindings
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.obj import _load_obj_py, load_obj

pytestmark = pytest.mark.skipif(
    not bindings.available(), reason="native library not built"
)


@pytest.fixture(scope="module")
def teatime_scene(scenes_dir):
    return Scene.load(str(scenes_dir / "teatime.json"))


@pytest.mark.reference
def test_native_bvh_bit_exact_vs_python(teatime_scene):
    for eps, target in [(0.02, 2), (1.95, 2), (0.02, 4)]:
        py = BvhData.from_tree(
            build_aabb_tree(teatime_scene, eps=eps, target_item_count=target)
        )
        nb = bindings.bvh_build_native(
            teatime_scene.vert_pos, teatime_scene.prim_indices, eps, target
        )
        np.testing.assert_array_equal(nb["fst"], py.fst)
        np.testing.assert_array_equal(nb["snd"], py.snd)
        np.testing.assert_array_equal(nb["item_idx"], py.item_idx)
        np.testing.assert_array_equal(nb["item_count"], py.item_count)
        np.testing.assert_array_equal(nb["bounds_min"], py.bounds_min)
        np.testing.assert_array_equal(nb["bounds_max"], py.bounds_max)
        np.testing.assert_array_equal(nb["indices"], py.indices)


@pytest.mark.reference
def test_native_bvh_matches_shipped_checkpoint(teatime_scene, scenes_dir):
    ref = BvhData.load(str(scenes_dir / "teatime.bvh.json"))
    nb = bindings.bvh_build_native(
        teatime_scene.vert_pos, teatime_scene.prim_indices, 1.95, 2
    )
    np.testing.assert_array_equal(nb["fst"], ref.fst)
    np.testing.assert_array_equal(nb["bounds_min"], ref.bounds_min)
    np.testing.assert_array_equal(nb["indices"], ref.indices)


@pytest.mark.reference
@pytest.mark.parametrize(
    "mesh", ["tetrahedron", "dodecahedron", "teapot", "shuttle", "cessna"]
)
def test_native_obj_matches_python(meshes_dir, mesh):
    path = str(meshes_dir / f"{mesh}.obj")
    py = _load_obj_py(path)
    native = load_obj(path)
    np.testing.assert_allclose(native.positions, py.positions)
    if py.normals.size:
        np.testing.assert_allclose(native.normals, py.normals)
    py_tris = list(py.triangles())
    na_tris = list(native.triangles())
    assert len(py_tris) == len(na_tris)
    for (pi, pn), (ni, nn) in zip(py_tris, na_tris):
        assert pi == ni
        for a, b in zip(pn, nn):
            if a is None:
                assert b is None
            else:
                np.testing.assert_allclose(a, b)


@pytest.mark.reference
def test_native_scene_build_equivalent(meshes_dir):
    """End-to-end: add_mesh through native vs python loaders gives
    identical scenes."""
    import os

    path = str(meshes_dir / "teapot.obj")
    s_native = Scene.empty()
    s_native.add_mesh(load_obj(path), 0)
    os.environ["RT_NATIVE"] = "0"
    try:
        s_py = Scene.empty()
        s_py.add_mesh(load_obj(path), 0)
    finally:
        os.environ["RT_NATIVE"] = "1"
    np.testing.assert_array_equal(s_native.prim_indices, s_py.prim_indices)
    np.testing.assert_array_equal(s_native.vert_pos, s_py.vert_pos)
    np.testing.assert_array_equal(s_native.vert_norm, s_py.vert_norm)
