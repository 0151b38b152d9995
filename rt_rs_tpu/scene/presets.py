"""Scene recipes shared by the tests, ``chip_smoke.py`` and ``bench.py``.

The benchmark and smoke scenes themselves are generated from a seed in
:mod:`rt_rs_tpu.scene.procedural`; this module holds the recipes around
them and the reference-file scenes of the golden tests:

* ``tiled_copies`` — a scene's geometry replicated at offsets (the
  large-scene recipe);
* ``ghost_scene(-1)`` — a real ``material = -1`` prim, which routes
  the renderer down the XLA ``shade.render`` fallback (the reference's
  miss-sentinel semantics, ``src/lib/scene/mod.rs:161-166`` +
  ``compute.wgsl:185-187``: blocks camera rays, casts no shadow);
* ``mesh_scene`` / ``tiled_teapots`` / ``golden_set`` — scenes built
  from the reference project's own OBJ meshes and scene JSONs (the
  golden images of ``tests/test_goldens.py``); they need a checkout of
  the reference and are used only by ``reference``-marked tests.
"""

from __future__ import annotations

import numpy as np

from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.camera import CameraController, CameraUniform

# mesh -> (camera position, bounces); the camera frames the whole
# model (the matrix test asserts a non-black naive render).
MESH_VIEWS = {
    "dodecahedron": ((0.0, 0.0, -6.0), 2),
    "magnolia": ((0.0, 0.0, -180.0), 2),
    "shuttle": ((0.0, 6.0, -25.0), 4),
    "cessna": ((0.0, 10.0, -60.0), 4),
}


def mesh_scene(
    name: str,
    meshes_dir: str,
    lights: bool = True,
) -> tuple[Scene, int]:
    """A bundled OBJ mesh under two lights -> (scene, bounces)."""
    from rt_rs_tpu.scene.obj import load_obj

    campos, bounces = MESH_VIEWS[name]
    scene = Scene.empty(
        camera=CameraUniform(campos, (0.0, 0.0, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    scene.mat_color = np.array([[0.5, 0.1, 0.1]], dtype=np.float32)
    scene.mat_albedo = np.array([[0.9, 0.1, 0.3]], dtype=np.float32)
    scene.mat_spec = np.array([10.0], dtype=np.float32)
    if lights:
        scene.light_pos = np.array(
            [[30.0, 40.0, -20.0], [-25.0, 30.0, 25.0]], dtype=np.float32
        )
        scene.light_strength = np.array([1.6, 1.2], dtype=np.float32)
    scene.add_mesh(load_obj(f"{meshes_dir}/{name}.obj"), 0)
    return scene, bounces


def ghost_scene(ghost_material: int) -> Scene:
    """A lit wall plus a 'ghost' triangle between the light and the
    wall's center (and across part of the camera's view).  With
    ``ghost_material = -1`` the ghost blocks camera rays but passes
    light (the reference's negative-material semantics); with a real
    material it shadows the wall instead."""
    scene = Scene.empty(
        camera=CameraUniform((0.0, 0.0, -4.0), (0.0, 0.0, 2.0))
    )
    scene.vert_pos = np.array(
        [
            # wall (big triangle at z = 2, facing the camera; -3.3 so
            # no pixel row lands exactly on the bottom edge — pixel
            # row 0 maps to y = -3.0 at z = 2, a knife-edge hit where
            # f32 and the f64 oracle legitimately disagree)
            [-4.0, -3.3, 2.0], [4.0, -3.3, 2.0], [0.3, 5.0, 2.0],
            # ghost (small triangle at z = 0)
            [1.5, -1.0, 0.0], [3.0, -1.0, 0.0], [2.2, 1.0, 0.0],
        ],
        dtype=np.float32,
    )
    scene.vert_norm = np.tile(
        np.array([[0.0, 0.0, -1.0]], dtype=np.float32), (6, 1)
    )
    scene.prim_indices = np.array(
        [[0, 1, 2], [3, 4, 5]], dtype=np.uint32
    )
    scene.prim_material = np.array([0, ghost_material], dtype=np.int32)
    scene.light_pos = np.array([[4.0, 0.0, -2.0]], dtype=np.float32)
    scene.light_strength = np.array([1.5], dtype=np.float32)
    scene.mat_color = np.array(
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2]], dtype=np.float32
    )
    scene.mat_albedo = np.array(
        [[1.0, 0.5, 0.5], [1.0, 0.5, 0.5]], dtype=np.float32
    )
    scene.mat_spec = np.array([8.0, 8.0], dtype=np.float32)
    return scene


def tiled_copies(base: Scene, offsets) -> Scene:
    """``base``'s geometry replicated at ``offsets`` (camera, lights
    and materials carried over) — the large-scene recipe."""
    big = Scene.empty()
    big.camera = base.camera
    big.camera_controller = base.camera_controller
    big.light_pos = base.light_pos
    big.light_strength = base.light_strength
    big.mat_color = base.mat_color
    big.mat_albedo = base.mat_albedo
    big.mat_spec = base.mat_spec
    nv = base.vert_pos.shape[0]
    vp, vn, pi, pm = [], [], [], []
    for i, off in enumerate(offsets):
        vp.append(base.vert_pos + np.asarray(off, np.float32))
        vn.append(base.vert_norm)
        pi.append(base.prim_indices + i * nv)
        pm.append(base.prim_material)
    big.vert_pos = np.concatenate(vp)
    big.vert_norm = np.concatenate(vn)
    big.prim_indices = np.concatenate(pi)
    big.prim_material = np.concatenate(pm)
    return big


def tiled_teapots(n: int, scenes_dir: str) -> Scene:
    """``n`` teatime teapots in a row (n=3 -> 18,960 prims)."""
    base = Scene.load(f"{scenes_dir}/teatime.json")
    step = 8.0
    offsets = [
        ((i - (n - 1) / 2.0) * step, 0.0, 0.0) for i in range(n)
    ]
    return tiled_copies(base, offsets)


def golden_set(
    meshes_dir: str, scenes_dir: str
) -> dict[str, tuple[Scene, int]]:
    """name -> (scene, bounces) for every golden beyond the two
    shipped JSON scenes (those load directly from ``scenes_dir``)."""
    return {
        "cessna": mesh_scene("cessna", meshes_dir),
        "shuttle": mesh_scene("shuttle", meshes_dir),
        "ghost": (ghost_scene(-1), 4),
        "teapots3": (tiled_teapots(3, scenes_dir), 4),
    }
