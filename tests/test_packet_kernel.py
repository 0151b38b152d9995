"""The packet chunk loop: the Pallas kernel (Triton route, interpreted on
the CPU) and its plain-lax twin against brute force, the route picker,
and the wrapper's launch-shape checks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.ops import shade
from rt_rs_tpu.ops.intersect import closest_hit_bruteforce
from rt_rs_tpu.ops.pallas import kernel_mode
from rt_rs_tpu.ops.pallas.packet_trace import chunk_lists, packet_closest_hit_tiled

CFG = ComputeConfig()
WIN = dict(t_min=CFG.t_min, t_max=CFG.t_max, eps=CFG.eps)


@pytest.fixture(scope="module")
def built(base_scene):
    """(chunk table, leaf-ordered arrays) of the base scene."""
    return get_handler("pbvh").build(base_scene, base_scene.pack())


@pytest.fixture(scope="module")
def rays(base_scene):
    """Camera rays of a 64x48 frame in 256-ray tiles, with every tile
    past the 12 the frame needs turned into rays far outside the scene
    pointing away (list length 0), a random exclusion id per ray and a
    random occlusion cap in payload row 7."""
    pos = jnp.asarray(base_scene.camera.pos, jnp.float32)
    at = jnp.asarray(base_scene.camera.at, jnp.float32)
    payload, valid, n_pixels = shade.camera_ray_tiles(
        pos, at, 64, 48, 256, block=(16, 16)
    )
    t_tiles, r = valid.shape
    live = n_pixels // r
    rng = np.random.default_rng(3)
    away = np.zeros((8, t_tiles - live, r), np.float32)
    away[0:3] = 500.0
    away[3:6] = 1.0 / np.sqrt(3.0)
    payload = payload.at[:, live:].set(jnp.asarray(away))
    valid = jnp.ones_like(valid)
    excl = rng.integers(0, 6321, (t_tiles, r)).astype(np.float32)
    cap = rng.uniform(0.5, 40.0, (t_tiles, r)).astype(np.float32)
    payload = payload.at[6].set(jnp.asarray(excl)).at[7].set(jnp.asarray(cap))
    return payload, valid, live


@pytest.fixture(scope="module")
def brute(built, rays):
    """Brute-force closest hits (t, id) for every ray, and the any-hit
    verdict against the payload's cap."""
    _, arrays = built
    payload, _, _ = rays
    o = payload[0:3].reshape(3, -1).T
    d = payload[3:6].reshape(3, -1).T
    excl = payload[6].reshape(-1).astype(jnp.int32)
    t, pid = closest_hit_bruteforce(
        o, d, arrays.pa, arrays.pb, arrays.pc, excl, chunk=128, **WIN
    )
    shape = payload.shape[1:]
    t = np.asarray(t).reshape(shape)
    pid = np.asarray(pid).reshape(shape)
    blocked = (pid > 0) & (t < np.asarray(payload[7]))
    return t, pid, blocked


def _check_closest(out, brute):
    t, pid = (np.asarray(x) for x in out)
    t0, pid0, _ = brute
    hit = (pid0 > 0) & (pid > 0)
    # Knife-edge ties may flip under a different FMA contraction.
    assert (pid == pid0).mean() >= 0.9999
    np.testing.assert_allclose(t[hit], t0[hit], rtol=1e-5)


def test_empty_lists_exist(built, rays):
    """The fixture really holds tiles with no chunk to test."""
    accel, _ = built
    payload, valid, live = rays
    ids, counts = chunk_lists(accel, payload, valid, None, **dict(
        t_min=CFG.t_min, t_max=CFG.t_max))
    counts = np.asarray(counts)
    assert (counts[live:] == 0).all() and (counts[:live] > 0).all()
    ids = np.asarray(ids)
    for t in range(live):  # each list is ascending and in range
        row = ids[t, : counts[t]]
        assert (np.diff(row) > 0).all() and row.max() < accel.num_chunks


@pytest.mark.parametrize(
    "rays_per_program,tris_per_step", [(64, 8), (128, 16), (256, 64)]
)
def test_kernel_closest_matches_brute_force(
    built, rays, brute, rays_per_program, tris_per_step
):
    accel, _ = built
    payload, valid, _ = rays
    out = packet_closest_hit_tiled(
        accel, payload, valid, rays_per_program=rays_per_program,
        tris_per_step=tris_per_step, **WIN,
    )
    _check_closest(out, brute)


@pytest.mark.parametrize(
    "rays_per_program,tris_per_step", [(64, 16), (128, 8), (256, 32)]
)
def test_kernel_any_hit_matches_brute_force(
    built, rays, brute, rays_per_program, tris_per_step
):
    accel, _ = built
    payload, valid, _ = rays
    blocked = packet_closest_hit_tiled(
        accel, payload, valid, any_hit=True,
        rays_per_program=rays_per_program, tris_per_step=tris_per_step,
        **WIN,
    )
    np.testing.assert_array_equal(np.asarray(blocked), brute[2])


@pytest.mark.parametrize("any_hit", [False, True])
def test_lax_loop_matches_brute_force(built, rays, brute, any_hit):
    accel, _ = built
    payload, valid, _ = rays
    out = packet_closest_hit_tiled(
        accel, payload, valid, any_hit=any_hit, loop="lax", **WIN
    )
    if any_hit:
        np.testing.assert_array_equal(np.asarray(out), brute[2])
    else:
        _check_closest(out, brute)


@pytest.mark.parametrize("refine", [True, 8])
def test_kernel_refined_lists_match_lax(built, rays, refine):
    """With the per-ray cull (the bounce/shadow configuration) or the
    8-ray subgroup interval cull the two loops still agree exactly."""
    accel, _ = built
    payload, valid, _ = rays
    kw = dict(refine=refine, t_cap=payload[7], **WIN)
    t0, i0 = packet_closest_hit_tiled(accel, payload, valid, loop="lax", **kw)
    t1, i1 = packet_closest_hit_tiled(accel, payload, valid, **kw)
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t0))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))


def test_launch_shape_must_divide(built, rays):
    accel, _ = built
    payload, valid, _ = rays
    with pytest.raises(ValueError, match="must divide"):
        packet_closest_hit_tiled(
            accel, payload, valid, tris_per_step=48, **WIN
        )
    with pytest.raises(ValueError, match="unknown chunk loop"):
        packet_closest_hit_tiled(accel, payload, valid, loop="scan", **WIN)


def test_kernel_mode_routes():
    assert kernel_mode("gpu") == "triton"
    assert kernel_mode("cpu") == "interpret"
    assert kernel_mode() == kernel_mode(jax.default_backend())


@pytest.mark.parametrize("platform", ["rocm", "metal", "iree"])
def test_kernel_mode_raises_elsewhere(platform):
    with pytest.raises(RuntimeError, match="no Pallas kernel route"):
        kernel_mode(platform)


@pytest.mark.gpu
def test_compiled_kernel_matches_lax_on_gpu(gpu, built, rays):
    """The Triton-compiled kernel against the lax loop on the card."""
    assert kernel_mode() == "triton"
    accel, _ = built
    payload, valid, _ = rays
    t0, i0 = packet_closest_hit_tiled(accel, payload, valid, loop="lax", **WIN)
    t1, i1 = jax.jit(
        lambda p, v: packet_closest_hit_tiled(accel, p, v, **WIN)
    )(payload, valid)
    hit = np.asarray(i0) > 0
    np.testing.assert_allclose(
        np.asarray(t1)[hit], np.asarray(t0)[hit], rtol=1e-5
    )
    assert (np.asarray(i1) == np.asarray(i0)).mean() >= 0.9999
