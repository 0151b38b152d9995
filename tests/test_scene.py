"""Scene JSON serde + OBJ import tests (reference format parity)."""

import json

import numpy as np
import pytest

from rt_rs_tpu.geom import SceneFormatError
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.obj import load_obj


@pytest.mark.reference
def test_load_default_scene(scenes_dir):
    scene = Scene.load(str(scenes_dir / "default.json"))
    assert scene.num_prims == 40  # tetrahedron (4) + dodecahedron (36)
    assert scene.num_vertices > 0
    assert scene.camera.pos == (0.0, 0.0, -10.0)
    assert scene.camera_controller.kind == "Orbit"
    assert scene.mat_color.shape[0] >= 1


@pytest.mark.reference
def test_load_teatime_scene(scenes_dir):
    scene = Scene.load(str(scenes_dir / "teatime.json"))
    assert scene.num_prims == 6320
    assert scene.num_vertices == 3241
    assert scene.light_pos.shape == (2, 3)
    assert scene.camera.pos == (50.0, 10.0, 0.0)


def test_roundtrip(small_scene, tmp_path):
    scene = small_scene
    out = tmp_path / "roundtrip.json"
    scene.save(str(out))
    again = Scene.load(str(out))
    np.testing.assert_array_equal(scene.prim_indices, again.prim_indices)
    np.testing.assert_array_equal(scene.prim_material, again.prim_material)
    np.testing.assert_array_equal(scene.vert_pos, again.vert_pos)
    np.testing.assert_array_equal(scene.vert_norm, again.vert_norm)
    np.testing.assert_array_equal(scene.mat_albedo, again.mat_albedo)
    # The JSON tree has the reference schema and re-serializes exactly.
    with open(out) as f:
        tree = json.load(f)
    assert set(tree.keys()) == {
        "camera", "camera_controller", "prims", "vertices", "lights",
        "materials",
    }
    assert again.to_json() == tree


def test_invalid_length_rejected():
    with pytest.raises(SceneFormatError):
        Scene.from_json(
            {
                "camera": {"pos": [0, 0], "at": [0, 0, 0]},
                "camera_controller": "Fixed",
                "prims": [],
                "vertices": [],
                "lights": [],
                "materials": [],
            }
        )


@pytest.mark.reference
def test_obj_import_tetrahedron(meshes_dir):
    scene = Scene.empty()
    obj = load_obj(str(meshes_dir / "tetrahedron.obj"))
    scene.add_mesh(obj, material=1)
    assert scene.num_prims == 4
    assert scene.num_vertices == 4
    # All generated normals are unit length.
    mags = np.linalg.norm(scene.vert_norm, axis=1)
    np.testing.assert_allclose(mags, 1.0, atol=1e-5)
    assert (scene.prim_material == 1).all()


@pytest.mark.reference
def test_obj_import_matches_default_scene(scenes_dir, meshes_dir):
    """Rebuilding the default scene's tetrahedron from the OBJ must
    reproduce the prims/vertices stored in default.json (which the
    reference's construct tool generated with the same algorithm)."""
    ref = Scene.load(str(scenes_dir / "default.json"))
    scene = Scene.empty()
    scene.add_mesh(load_obj(str(meshes_dir / "tetrahedron.obj")), material=1)
    n = scene.num_vertices
    # The tetrahedron occupies the first 4 prims / vertices of default.json.
    np.testing.assert_array_equal(
        scene.prim_indices, ref.prim_indices[: scene.num_prims]
    )
    np.testing.assert_allclose(scene.vert_pos, ref.vert_pos[:n], rtol=1e-6)
    np.testing.assert_allclose(
        scene.vert_norm, ref.vert_norm[:n], rtol=1e-4, atol=1e-6
    )


@pytest.mark.reference
def test_obj_import_teapot_matches_teatime(scenes_dir, meshes_dir):
    ref = Scene.load(str(scenes_dir / "teatime.json"))
    scene = Scene.empty()
    scene.add_mesh(load_obj(str(meshes_dir / "teapot.obj")), material=0)
    assert scene.num_prims == ref.num_prims
    assert scene.num_vertices == ref.num_vertices
    np.testing.assert_array_equal(scene.prim_indices, ref.prim_indices)
    np.testing.assert_allclose(scene.vert_pos, ref.vert_pos, rtol=1e-6)
    np.testing.assert_allclose(
        scene.vert_norm, ref.vert_norm, rtol=1e-3, atol=1e-5
    )


def test_unloaded_scene():
    """Scene.unloaded() is the pack_unloaded placeholder
    (scene/mod.rs:115-131): one degenerate prim, zero light, renders
    black; serializing it is an error (the reference's unreachable!)."""
    import numpy as np
    import pytest

    from rt_rs_tpu.scene import Scene, SceneFormatError

    s = Scene.unloaded()
    assert s.is_unloaded
    assert s.num_prims == 1 and s.num_vertices == 1
    assert float(s.light_strength[0]) == 0.0
    arrays = s.pack()
    assert arrays.no_negative_materials
    with pytest.raises(SceneFormatError):
        s.to_json()
    # A loaded scene is never flagged unloaded.
    assert not Scene.empty().is_unloaded


def test_generated_scenes_deterministic():
    """The seed decides everything: same seed, same scene; another seed,
    another scene of the same size."""
    from rt_rs_tpu.scene.procedural import base_scene

    a, b, c = base_scene(0), base_scene(0), base_scene(1)
    assert a.to_json() == b.to_json()
    assert c.num_prims == a.num_prims
    assert not np.array_equal(a.vert_pos, c.vert_pos)


def test_generated_scene_sizes():
    from rt_rs_tpu.scene.procedural import (
        BASE_TRIS,
        LARGE_COPIES,
        base_scene,
        large_scene,
        small_scene,
    )

    base = base_scene(0)
    assert base.num_prims == BASE_TRIS == 6320
    assert base.light_pos.shape == (2, 3)
    assert large_scene(0).num_prims == LARGE_COPIES * BASE_TRIS == 50560
    assert small_scene(0).num_prims == 50


def test_generated_scene_is_well_formed():
    """Finite unit normals, indices in range, no negative material, a
    reflective albedo.z on every material (bounces do real work)."""
    from rt_rs_tpu.scene.procedural import base_scene

    s = base_scene(3)
    assert np.isfinite(s.vert_pos).all()
    np.testing.assert_allclose(np.linalg.norm(s.vert_norm, axis=1), 1.0, rtol=1e-5)
    assert s.prim_indices.max() < s.num_vertices
    assert (s.prim_material >= 0).all()
    assert (s.mat_albedo[:, 2] > 0.2).all()
    assert s.pack().no_negative_materials


def test_base_scene_path_written_once(monkeypatch, tmp_path):
    """The generated base scene is written as JSON inside the checkout
    on first use and loads back as the same scene."""
    from rt_rs_tpu.scene import procedural
    from rt_rs_tpu.utils import cache

    monkeypatch.setattr(cache, "CHECKOUT", str(tmp_path))
    path = procedural.base_scene_path(0)
    assert path.startswith(str(tmp_path)) and path.endswith(".json")
    mtime = (tmp_path / "scenes" / "base_seed0.json").stat().st_mtime_ns
    assert procedural.base_scene_path(0) == path
    assert (tmp_path / "scenes" / "base_seed0.json").stat().st_mtime_ns == mtime
    assert Scene.load(path).to_json() == procedural.base_scene(0).to_json()
