"""Randomized robustness: all backends vs naive on random triangle
soups and degenerate inputs."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.scene import Scene


def _random_scene(rng, n_tris, scale=5.0, degenerate_frac=0.0):
    scene = Scene.empty()
    verts = rng.normal(size=(n_tris * 3, 3), scale=scale).astype(np.float32)
    if degenerate_frac > 0:
        # Collapse some triangles to points/lines.
        k = int(n_tris * degenerate_frac)
        for t in rng.choice(n_tris, size=k, replace=False):
            verts[t * 3 + 1] = verts[t * 3]
    scene.vert_pos = verts
    scene.vert_norm = np.tile(
        np.array([[0, 1, 0]], np.float32), (n_tris * 3, 1)
    )
    scene.prim_indices = np.arange(n_tris * 3, dtype=np.uint32).reshape(-1, 3)
    scene.prim_material = np.zeros(n_tris, dtype=np.int32)
    scene.mat_color = np.array([[1.0, 1.0, 1.0]], np.float32)
    scene.mat_albedo = np.array([[1.0, 0.0, 0.0]], np.float32)
    scene.mat_spec = np.array([1.0], np.float32)
    return scene


HANDLERS = [
    ("bvh", {}),
    ("rf_bvh", {}),
    ("pbvh", {}),
    ("lbvh", {}),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_tris", [1, 7, 33, 200])
def test_random_soup_all_backends(seed, n_tris):
    rng = np.random.default_rng(seed * 100 + n_tris)
    scene = _random_scene(rng, n_tris)
    cfg = ComputeConfig()
    arrays = scene.pack()

    naive = get_handler("naive")
    _, na = naive.build(scene, arrays)
    nf = naive.intersect_fn(None, na, cfg)

    rays = 64
    o = rng.normal(size=(rays, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((rays,), dtype=jnp.int32)
    ones = jnp.ones((rays,), dtype=bool)
    t0, _ = nf(jnp.asarray(o), jnp.asarray(d), excl, ones)

    from rt_rs_tpu.bvh.rf import RfFormatError

    for name, kwargs in HANDLERS:
        h = get_handler(name, **kwargs)
        try:
            accel, ha = h.build(scene, arrays)
        except RfFormatError:
            continue  # legitimate format limit on unsplittable clusters
        hf = h.intersect_fn(accel, ha, cfg)
        t1, _ = hf(jnp.asarray(o), jnp.asarray(d), excl, ones)
        np.testing.assert_allclose(
            np.asarray(t1), np.asarray(t0), rtol=1e-4,
            err_msg=f"{name} diverges (seed {seed}, {n_tris} tris)",
        )


def test_degenerate_triangles():
    """Zero-area triangles must never hit and never crash a backend."""
    rng = np.random.default_rng(42)
    scene = _random_scene(rng, 50, degenerate_frac=0.3)
    cfg = ComputeConfig()
    arrays = scene.pack()
    rays = 64
    o = rng.normal(size=(rays, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((rays,), dtype=jnp.int32)
    ones = jnp.ones((rays,), dtype=bool)

    naive = get_handler("naive")
    _, na = naive.build(scene, arrays)
    t0, _ = naive.intersect_fn(None, na, cfg)(
        jnp.asarray(o), jnp.asarray(d), excl, ones
    )
    for name, kwargs in HANDLERS:
        if name == "rf_bvh":
            continue  # coincident clusters may exceed the 8-slot leaf
        h = get_handler(name, **kwargs)
        accel, ha = h.build(scene, arrays)
        t1, _ = h.intersect_fn(accel, ha, cfg)(
            jnp.asarray(o), jnp.asarray(d), excl, ones
        )
        np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-4)


def test_vmem_guard():
    """No on-chip-memory cap is left: a soup past the old 12,288-triangle
    limit builds ONE flat chunk table and traces like naive."""
    from rt_rs_tpu.ops.pallas.packet_trace import TriChunks

    rng = np.random.default_rng(7)
    scene = _random_scene(rng, 13000)
    arrays = scene.pack()
    h = get_handler("pbvh")
    accel, ha = h.build(scene, arrays)
    assert isinstance(accel, TriChunks)
    assert accel.num_chunks * accel.tri_chunk >= 13000
    cfg = ComputeConfig()
    o = rng.uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((256,), jnp.int32)
    ones = jnp.ones((256,), bool)
    t1, i1 = h.intersect_fn(accel, ha, cfg)(
        jnp.asarray(o), jnp.asarray(d), excl, ones
    )
    nv = get_handler("naive")
    _, na = nv.build(scene, scene.pack())
    t0, _ = nv.intersect_fn(None, na, cfg)(
        jnp.asarray(o), jnp.asarray(d), excl, ones
    )
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-4)
