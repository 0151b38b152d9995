"""The negative-material fallback path.

The reference's miss sentinel is a null prim with ``material = -1``
(``src/lib/scene/mod.rs:161-166``), and the shader treats ANY
negative-material hit as invalid (``compute.wgsl:185-187`` via
``intrs_valid``): such a prim still wins the closest-hit race, so it
*blocks the camera* (the bounce loop stops, nothing behind it shades),
but it casts NO shadow (the shadow test's closest hit is invalid ->
not shadowed).  Scenes containing a real negative-material prim must
take the XLA ``shade.render`` path (``renderer.py`` ``_render_jit``'s
else-branch, ``DynamicRenderer``'s step, and ``make_sharded_render``'s
non-tiled arm) — these tests pin all three against the oracle.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.parallel import image_mesh, make_sharded_render
from rt_rs_tpu.renderer import DynamicRenderer, Renderer
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.camera import CameraUniform

from .oracle import Oracle

W, H = 32, 24


def ghost_scene(ghost_material: int) -> Scene:
    """A lit wall plus a 'ghost' triangle between the light and the
    wall's center (and across part of the camera's view).  With
    ``ghost_material = -1`` the ghost blocks camera rays but passes
    light; with a real material it shadows the wall instead."""
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


@pytest.fixture(scope="module")
def neg_scene():
    return ghost_scene(-1)


@pytest.fixture(scope="module")
def oracle_image(neg_scene):
    return Oracle(neg_scene, ComputeConfig()).render(
        W, H, neg_scene.camera.pos, neg_scene.camera.at
    )


@pytest.fixture(scope="module")
def naive_image(neg_scene):
    r = Renderer(
        neg_scene,
        config=Config(resolution=Resolution.sized(W, H)),
        handler="naive",
    )
    # The scene must actually select the fallback branch.
    assert not r.arrays.no_negative_materials
    return np.asarray(r.render_frame())


def test_pack_flags_negative_materials(neg_scene):
    assert not neg_scene.pack().no_negative_materials
    assert ghost_scene(1).pack().no_negative_materials


def test_negative_material_matches_oracle(naive_image, oracle_image):
    diff = np.abs(naive_image - oracle_image)
    assert np.quantile(diff, 0.99) < 2e-3, (
        f"p99 diff {np.quantile(diff, 0.99)}, max {diff.max()}"
    )
    assert diff.max() < 0.1


def test_ghost_blocks_camera_but_not_light(neg_scene, naive_image):
    """The two unique semantics of a negative-material prim, checked
    against the positive-ghost twin of the same geometry."""
    pos_image = np.asarray(
        Renderer(
            ghost_scene(1),
            config=Config(resolution=Resolution.sized(W, H)),
            handler="naive",
        ).render_frame()
    )
    # 1. Camera blocking: some wall pixels are lit in the positive twin
    #    (the ghost shades there) but BLACK in the negative scene (the
    #    ghost is the closest hit and is invalid -> bounce loop stops).
    blocked = (naive_image.sum(-1) == 0.0) & (pos_image.sum(-1) > 0.0)
    assert blocked.any(), "ghost did not block any camera rays"
    # 2. Shadow transparency: wall pixels the positive ghost shadows
    #    are brighter in the negative scene (its closest shadow hit is
    #    invalid -> not shadowed).  Restrict to pixels visible in both.
    both = (naive_image.sum(-1) > 0.0) & (pos_image.sum(-1) > 0.0)
    brighter = both & (
        naive_image.sum(-1) > pos_image.sum(-1) + 1e-4
    )
    assert brighter.any(), "ghost still cast a shadow"


def test_accelerated_handlers_match_naive(neg_scene, naive_image):
    for handler in ("bvh", "rf_bvh", "pbvh"):
        frame = np.asarray(
            Renderer(
                neg_scene,
                config=Config(resolution=Resolution.sized(W, H)),
                handler=handler,
            ).render_frame()
        )
        np.testing.assert_allclose(
            frame, naive_image, atol=2e-6, err_msg=handler
        )


def test_dynamic_renderer_negative_material(neg_scene, naive_image):
    """DynamicRenderer's step must take its XLA branch
    (renderer.py step(): not arrays.no_negative_materials)."""
    dr = DynamicRenderer(
        neg_scene, config=Config(resolution=Resolution.sized(W, H))
    )
    frame = np.asarray(
        dr.render_frame(neg_scene.vert_pos, neg_scene.vert_norm)
    )
    np.testing.assert_allclose(frame, naive_image, atol=2e-6)


def test_sharded_render_negative_material(neg_scene, naive_image):
    """make_sharded_render's non-tiled arm (parallel/__init__.py)."""
    cfg = ComputeConfig()
    handler = get_handler("naive")
    arrays = neg_scene.pack()
    accel, arrays = handler.build(neg_scene, arrays)
    assert not arrays.no_negative_materials
    fn = make_sharded_render(
        handler, accel, arrays, cfg, W, H, image_mesh(8)
    )
    frame, _ = fn(
        jnp.asarray(neg_scene.camera.pos, jnp.float32),
        jnp.asarray(neg_scene.camera.at, jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(frame), naive_image, atol=1e-5)


def test_trace_tiled_rejects_negative_materials(neg_scene):
    from rt_rs_tpu.ops import shade

    arrays = neg_scene.pack()
    payload, valid, _ = shade.camera_ray_tiles(
        jnp.asarray(neg_scene.camera.pos, jnp.float32),
        jnp.asarray(neg_scene.camera.at, jnp.float32),
        W, H, 128,
    )
    with pytest.raises(ValueError, match="negative"):
        shade.trace_tiled(
            arrays, None, ComputeConfig(), payload, valid,
            jnp.asarray(neg_scene.camera.pos, jnp.float32),
        )
