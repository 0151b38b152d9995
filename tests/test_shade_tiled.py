"""Tiled frame path (component-major ray tiles + jnp shading) vs the XLA
reference bounce loop, on the generated base scene — same math, ~1 ULP
drift allowed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.ops import shade
from rt_rs_tpu.ops.shade_tile import shade_post, shade_pre
from rt_rs_tpu.renderer import Renderer


@pytest.fixture(scope="module")
def pbvh_built(base_scene):
    h = get_handler("pbvh")
    accel, arr2 = h.build(base_scene, base_scene.pack())
    return h, accel, arr2


def _camera(scene):
    return (
        jnp.asarray(scene.camera.pos, jnp.float32),
        jnp.asarray(scene.camera.at, jnp.float32),
    )


def _both_renders(scene, handler_name, cfg, W, H, block, ray_tile=128):
    arrays = scene.pack()
    h = get_handler(handler_name)
    accel, arr2 = h.build(scene, arrays)
    pos, at = _camera(scene)
    old = shade.render(
        arr2, h.intersect_fn(accel, arr2, cfg), cfg, pos, at, W, H,
        block=block,
    )
    new = shade.render_tiled(
        arr2, h.intersect_tiled_fn(accel, arr2, cfg), cfg, pos, at, W, H,
        ray_tile=ray_tile, block=block,
    )
    return np.asarray(old), np.asarray(new)


def _tiled(scene, built, cfg, **kw):
    h, accel, arr2 = built
    pos, at = _camera(scene)
    return np.asarray(
        shade.render_tiled(
            arr2, h.intersect_tiled_fn(accel, arr2, cfg), cfg, pos, at,
            48, 32, ray_tile=128, block=(8, 16), **kw,
        )
    )


def test_tiled_matches_reference_default(base_scene):
    old, new = _both_renders(
        base_scene, "naive", ComputeConfig(), 32, 24, (8, 16)
    )
    np.testing.assert_allclose(new, old, atol=2e-6)


def test_tiled_matches_reference_full_fidelity(base_scene):
    # 4 bounces, 2 shadow-rayed lights, packet backend.
    old, new = _both_renders(
        base_scene, "pbvh", ComputeConfig(), 48, 32, (8, 16)
    )
    np.testing.assert_allclose(new, old, atol=2e-5)


def test_tiled_headlight(base_scene):
    cfg = dataclasses.replace(ComputeConfig(), camera_light_source=1.5)
    old, new = _both_renders(base_scene, "naive", cfg, 32, 16, (8, 16))
    np.testing.assert_allclose(new, old, atol=2e-5)


def test_tiled_no_block_raster_order(base_scene):
    old, new = _both_renders(base_scene, "naive", ComputeConfig(), 40, 24, None)
    np.testing.assert_allclose(new, old, atol=2e-6)


def test_tiled_odd_size_padding(base_scene):
    # Sizes that don't divide the block or tile: padding + crop parity.
    old, new = _both_renders(base_scene, "naive", ComputeConfig(), 37, 23, (8, 16))
    np.testing.assert_allclose(new, old, atol=2e-6)


@pytest.mark.parametrize("bounces", [1, 2])
def test_tiled_few_bounces(base_scene, bounces):
    """bounces=1 (no continuation ray) and bounces=2 agree with the XLA
    reference — the one-bounce case checks the jnp shading against
    shade.trace directly."""
    cfg = dataclasses.replace(ComputeConfig(), bounces=bounces)
    old, new = _both_renders(base_scene, "pbvh", cfg, 48, 32, (8, 16))
    np.testing.assert_allclose(new, old, atol=2e-5)


def test_anyhit_shadow_matches_closest(base_scene, pbvh_built):
    """Any-hit shadow verdicts (occlusion bound in payload row 7) give
    the identical image: min(t) < d iff any t < d."""
    h, accel, arr2 = pbvh_built
    cfg = ComputeConfig()
    np.testing.assert_array_equal(
        _tiled(
            base_scene, pbvh_built, cfg,
            intersect_anyhit_fn=h.intersect_tiled_anyhit_fn(accel, arr2, cfg),
        ),
        _tiled(base_scene, pbvh_built, cfg),
    )


def test_renderer_uses_tiled_path(base_scene):
    """End-to-end Renderer equality across a handler with a native tiled
    entry and one using the AoS adapter."""
    cfg = Config(resolution=Resolution.sized(48, 32))
    f_naive = np.asarray(
        Renderer(base_scene, config=cfg, handler="naive").render_frame()
    )
    f_pbvh = np.asarray(
        Renderer(base_scene, config=cfg, handler="pbvh").render_frame()
    )
    np.testing.assert_allclose(f_pbvh, f_naive, atol=1e-5)


@pytest.mark.parametrize("anyhit", [False, True])
def test_shadow_cull_bit_exact(base_scene, pbvh_built, anyhit):
    """Dropping zero-contribution shadow rays (back-facing diffuse AND
    zero specular -> the occlusion verdict is multiplied by exactly
    zero) must not change a single pixel, with the shared closest-hit
    call and with the any-hit call."""
    h, accel, arr2 = pbvh_built
    cfg = ComputeConfig()
    kw = {}
    if anyhit:
        kw["intersect_anyhit_fn"] = h.intersect_tiled_anyhit_fn(accel, arr2, cfg)
    np.testing.assert_array_equal(
        _tiled(base_scene, pbvh_built, cfg, shadow_cull=True, **kw),
        _tiled(base_scene, pbvh_built, cfg, shadow_cull=False, **kw),
    )


def _first_hit(scene, built):
    h, accel, arr2 = built
    cfg = ComputeConfig()
    pos, at = _camera(scene)
    payload, valid, _ = shade.camera_ray_tiles(pos, at, 48, 32, 128, block=(8, 16))
    t, pid = h.intersect_tiled_fn(accel, arr2, cfg)(payload, valid)
    rows = arr2.shade_table[pid.reshape(-1)].T.reshape(32, *t.shape)
    active = valid & (pid != 0) & (t < cfg.t_max) & (t > cfg.t_min)
    lights = jnp.concatenate(
        [arr2.light_pos, arr2.light_strength[:, None]], axis=1
    ).astype(jnp.float32)
    return cfg, payload, t, pid, rows, active, lights


def test_shadow_cull_culls_something(base_scene, pbvh_built):
    """The contribution masks must actually drop rays on real geometry
    (a torus' far side back-faces each light) — guards against the
    mask degenerating to all-ones and the cull silently dying."""
    _, payload, t, pid, rows, active, lights = _first_hit(base_scene, pbvh_built)
    _, _, masks, _ = shade_pre(
        rows, payload, t, pid.astype(jnp.float32), lights, emit_next=False
    )
    live = np.asarray(active)
    kept = np.asarray(jnp.stack(masks) > 0.0) & live[None]
    assert 0 < kept.sum() < live.sum() * len(masks)  # some culled, not all


def test_shade_pre_matches_xla_hit(base_scene, pbvh_built):
    """shade_pre's shadow and reflection rays are built from the same hit
    point and normal as the XLA reference (shade._hit_from_rows)."""
    cfg, payload, t, pid, rows, active, lights = _first_hit(
        base_scene, pbvh_built
    )
    sh, caps, _, nxt = shade_pre(
        rows, payload, t, pid.astype(jnp.float32), lights, emit_next=True
    )
    live = np.asarray(active).reshape(-1)
    o = payload[0:3].reshape(3, -1).T
    d = payload[3:6].reshape(3, -1).T
    at, normal = shade._hit_from_rows(rows.reshape(32, -1).T, o, d, t.reshape(-1))
    at, normal = np.asarray(at)[live], np.asarray(normal)[live]
    for k in range(len(sh)):
        shadow_o = np.asarray(sh[k][0:3].reshape(3, -1).T)[live]
        # The origin is the hit point pushed 0.001 along +-normal.
        off = np.abs(np.sum((shadow_o - at) * normal, axis=1))
        np.testing.assert_allclose(off, 1e-3, atol=2e-5)
        lp = np.asarray(lights[k, :3])
        np.testing.assert_allclose(
            np.asarray(caps[k]).reshape(-1)[live],
            np.linalg.norm(lp - at, axis=1), rtol=1e-5,
        )
    refl = np.asarray(nxt[3:6].reshape(3, -1).T)[live]
    dd = np.asarray(d)[live]
    want = dd - 2.0 * np.sum(dd * normal, axis=1, keepdims=True) * normal
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(refl, want, atol=2e-5)


def test_shade_post_dead_rays_contribute_nothing(base_scene, pbvh_built):
    """shade_post masks by ``active``: dead rays add exactly zero."""
    cfg, payload, t, pid, rows, active, lights = _first_hit(
        base_scene, pbvh_built
    )
    k = lights.shape[0]
    zeros = jnp.zeros((k,) + t.shape, jnp.float32)
    color = shade_post(
        rows, payload, t, active, zeros, zeros,
        jnp.full((k,) + t.shape, 1e3, jnp.float32), lights,
        first_bounce=True, t_min=cfg.t_min, t_max=cfg.t_max,
    )
    color = np.asarray(color)
    assert (color[:, ~np.asarray(active)] == 0.0).all()
    assert color[:, np.asarray(active)].sum() > 0.0
