"""Cross-handler image equivalence over the full bundled-mesh matrix.

Covers the BASELINE.json configs: dodecahedron + magnolia with on-device
LBVH (no precomputed BVH), shuttle + cessna multi-bounce, plus the two
shipped scenes.  Every accelerated backend must reproduce the naive
brute-force image exactly (same math, superset-tested prims).
"""

import numpy as np
import pytest

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.renderer import Renderer
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.camera import CameraController, CameraUniform
from rt_rs_tpu.scene.obj import load_obj

W, H = 32, 24

pytestmark = pytest.mark.reference


def _mesh_scene(meshes_dir, name, camera_pos, bounces_lights=True):
    scene = Scene.empty(
        camera=CameraUniform(camera_pos, (0.0, 0.0, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    scene.mat_color = np.array([[0.5, 0.1, 0.1]], dtype=np.float32)
    scene.mat_albedo = np.array([[0.9, 0.1, 0.3]], dtype=np.float32)
    scene.mat_spec = np.array([10.0], dtype=np.float32)
    if bounces_lights:
        scene.light_pos = np.array(
            [[30.0, 40.0, -20.0], [-25.0, 30.0, 25.0]], dtype=np.float32
        )
        scene.light_strength = np.array([1.6, 1.2], dtype=np.float32)
    scene.add_mesh(load_obj(str(meshes_dir / f"{name}.obj")), 0)
    return scene


CASES = [
    # (mesh, camera distance scale, bounces)
    ("dodecahedron", (0.0, 0.0, -6.0), 2),
    ("magnolia", (0.0, 0.0, -180.0), 2),
    ("shuttle", (0.0, 6.0, -25.0), 4),
    ("cessna", (0.0, 10.0, -60.0), 4),
]


@pytest.mark.parametrize("mesh,campos,bounces", CASES)
def test_handlers_agree(meshes_dir, mesh, campos, bounces):
    scene = _mesh_scene(meshes_dir, mesh, campos)
    cfg = Config(
        compute=ComputeConfig(bounces=bounces),
        resolution=Resolution.sized(W, H),
    )
    ref = np.asarray(
        Renderer(scene, config=cfg, handler="naive").render_frame()
    )
    assert ref.any(), f"{mesh}: naive render is all black (bad camera?)"
    from rt_rs_tpu.bvh.rf import RfFormatError

    for handler, kwargs in [
        ("bvh", {}),
        ("rf_bvh", {}),
        ("pbvh", {}),
        ("lbvh", {}),
    ]:
        try:
            got = np.asarray(
                Renderer(
                    scene, config=cfg, handler=handler, handler_kwargs=kwargs
                ).render_frame()
            )
        except RfFormatError:
            # Genuine RF structural limit (<= 8 prims/leaf, pdf §3.2.2):
            # cessna has a >8-triangle unsplittable cluster.  The
            # reference panics on the same input (rf.rs:113 underflow).
            assert handler == "rf_bvh" and mesh == "cessna"
            continue
        # atol 5e-4: the all-pairs vs elementwise Möller–Trumbore paths
        # differ in f32 op order; multi-bounce specular chains amplify
        # last-ulp t differences on a handful of silhouette pixels.
        np.testing.assert_allclose(
            got, ref, atol=5e-4,
            err_msg=f"{mesh}: handler {handler} diverges from naive",
        )


def test_mesh_sizes(meshes_dir):
    """Sanity: bundled mesh scale matches the SURVEY inventory."""
    sizes = {}
    for mesh in ("tetrahedron", "dodecahedron", "shuttle", "magnolia",
                 "teapot", "cessna"):
        s = Scene.empty()
        s.add_mesh(load_obj(str(meshes_dir / f"{mesh}.obj")), 0)
        sizes[mesh] = s.num_prims
    assert sizes["tetrahedron"] == 4
    assert sizes["dodecahedron"] == 36
    assert sizes["teapot"] == 6320  # triangulated quads
    assert sizes["cessna"] > 3000
