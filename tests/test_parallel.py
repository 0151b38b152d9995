"""Multi-device sharding on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.parallel import (
    hybrid_mesh,
    image_mesh,
    make_sharded_render,
)
from rt_rs_tpu.renderer import Renderer

import jax.numpy as jnp


@pytest.fixture(scope="module")
def default_scene(base_scene):
    return base_scene


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single(default_scene):
    w, h = 32, 24  # h divides 8
    cfg = ComputeConfig()
    handler = get_handler("naive")
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)

    mesh = image_mesh(8)
    fn = make_sharded_render(handler, accel, arrays, cfg, w, h, mesh)
    frame, lum = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    frame = np.asarray(frame)
    assert frame.shape == (h, w, 3)

    single = np.asarray(
        Renderer(
            default_scene,
            config=Config(resolution=Resolution.sized(w, h)),
            handler="naive",
        ).render_frame()
    )
    np.testing.assert_allclose(frame, single, atol=1e-5)
    # Metering psum agrees with the host-side mean luminance.
    expect = float(
        (single @ np.array([0.2126, 0.7152, 0.0722], np.float32)).mean()
    )
    assert float(lum) == pytest.approx(expect, rel=1e-4)


def test_sharded_packet_kernel_matches_single(default_scene):
    """The Pallas packet kernel (pbvh, interpreted on CPU) under
    shard_map over the full 8-device mesh."""
    w, h = 64, 64  # h divides 8
    cfg = ComputeConfig(bounces=2)
    handler = get_handler("pbvh")
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)

    mesh = image_mesh(8)
    fn = make_sharded_render(handler, accel, arrays, cfg, w, h, mesh)
    frame, _ = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    frame = np.asarray(frame)
    assert frame.shape == (h, w, 3)

    single = np.asarray(
        Renderer(
            default_scene,
            config=Config(
                compute=cfg, resolution=Resolution.sized(w, h)
            ),
            handler="pbvh",
        ).render_frame()
    )
    np.testing.assert_allclose(frame, single, atol=1e-5)


def test_sharded_render_two_devices(default_scene):
    w, h = 16, 8
    cfg = ComputeConfig(bounces=2)
    handler = get_handler("naive")
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)
    mesh = image_mesh(2)
    fn = make_sharded_render(handler, accel, arrays, cfg, w, h, mesh)
    frame, _ = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    assert np.asarray(frame).shape == (h, w, 3)


def test_height_must_divide(default_scene):
    cfg = ComputeConfig()
    handler = get_handler("naive")
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)
    with pytest.raises(ValueError):
        make_sharded_render(handler, accel, arrays, cfg, 16, 9, image_mesh(8))


def test_sharded_anyhit_path_matches_single(default_scene):
    """The tiled + any-hit shadow branch under shard_map equals the
    single-device render; wg-hint block tuning is honored via
    `resolution`."""
    w, h = 64, 64
    cfg = ComputeConfig(bounces=2)
    handler = get_handler("pbvh")
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)

    mesh = image_mesh(8)
    fn = make_sharded_render(
        handler, accel, arrays, cfg, w, h, mesh,
        resolution=Resolution.fixed(w, h, 16),
    )
    frame, _ = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    frame = np.asarray(frame)

    single = np.asarray(
        Renderer(
            default_scene,
            config=Config(compute=cfg, resolution=Resolution.sized(w, h)),
            handler="pbvh",
        ).render_frame()
    )
    np.testing.assert_allclose(frame, single, atol=1e-5)


def _single_frame(scene, cfg, w, h, **hkw):
    return np.asarray(
        Renderer(
            scene,
            config=Config(compute=cfg, resolution=Resolution.sized(w, h)),
            handler="pbvh",
            handler_kwargs=hkw,
        ).render_frame()
    )


def test_scene_parallel_matches_single(default_scene):
    """2-D mesh (2 bands x 4 scene shards): the chunk table splits
    across the scene axis and per-call pmin/psum merges reproduce the
    sequential semantics, with bounces so exclusion ids cross the
    shard shift."""
    w, h = 64, 32
    cfg = ComputeConfig(bounces=2)
    handler = get_handler("pbvh", tri_chunk=8)
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)

    mesh = hybrid_mesh(2, 4)
    fn = make_sharded_render(handler, accel, arrays, cfg, w, h, mesh)
    frame, _ = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    single = _single_frame(default_scene, cfg, w, h, tri_chunk=8)
    np.testing.assert_allclose(np.asarray(frame), single, atol=1e-5)


def test_scene_parallel_four_bands_matches_single(default_scene):
    """4 bands x 2 shards, on the plain-lax chunk loop."""
    w, h = 64, 32
    cfg = ComputeConfig(bounces=2)
    handler = get_handler("pbvh", tri_chunk=8, loop="lax")
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)

    mesh = hybrid_mesh(4, 2)
    fn = make_sharded_render(handler, accel, arrays, cfg, w, h, mesh)
    frame, _ = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    single = _single_frame(default_scene, cfg, w, h, tri_chunk=8)
    np.testing.assert_allclose(np.asarray(frame), single, atol=1e-5)


def test_scene_parallel_requires_packet_table(default_scene):
    """Backends without a flat chunk table can't shard the scene axis."""
    cfg = ComputeConfig()
    handler = get_handler("naive")
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)
    with pytest.raises(TypeError):
        make_sharded_render(
            handler, accel, arrays, cfg, 16, 8, hybrid_mesh(2, 4)
        )


def test_scene_parallel_nondividing_shards(default_scene):
    """3 shards over a 800-chunk table forces tail padding (pad to 801,
    267 chunks/shard) — pad chunks must never hit or shift ids."""
    w, h = 32, 16
    cfg = ComputeConfig(bounces=2)
    handler = get_handler("pbvh", tri_chunk=8)
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)
    assert accel.num_chunks % 3

    mesh = hybrid_mesh(1, 3)
    fn = make_sharded_render(handler, accel, arrays, cfg, w, h, mesh)
    frame, _ = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    single = _single_frame(default_scene, cfg, w, h, tri_chunk=8)
    np.testing.assert_allclose(np.asarray(frame), single, atol=1e-5)


def test_scene_parallel_dual_table_shards_coarse(default_scene):
    """A handler with dual tables shards its coarse table; frames match
    the single-device dual render."""
    w, h = 32, 16
    cfg = ComputeConfig(bounces=2)
    handler = get_handler("pbvh", tri_chunk_fine=16)
    arrays = default_scene.pack()
    accel, arrays = handler.build(default_scene, arrays)
    fn = make_sharded_render(
        handler, accel, arrays, cfg, w, h, hybrid_mesh(2, 2)
    )
    frame, _ = fn(
        jnp.asarray(default_scene.camera.pos, jnp.float32),
        jnp.asarray(default_scene.camera.at, jnp.float32),
    )
    single = _single_frame(default_scene, cfg, w, h, tri_chunk_fine=16)
    np.testing.assert_allclose(np.asarray(frame), single, atol=1e-5)
