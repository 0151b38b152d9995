"""Batched intersection vs the scalar oracle."""

import numpy as np
import pytest

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.ops.intersect import closest_hit_bruteforce, slab_test, tri_intersect

from .oracle import Oracle

import jax.numpy as jnp


@pytest.fixture(scope="module")
def default_scene(small_scene):
    """The generated 50-triangle scene."""
    return small_scene


def _random_rays(rng, n, spread=4.0):
    o = rng.normal(size=(n, 3), scale=spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_tri_intersect_matches_oracle(default_scene):
    cfg = ComputeConfig()
    oracle = Oracle(default_scene, cfg)
    arrays = default_scene.pack()
    rng = np.random.default_rng(0)
    o, d = _random_rays(rng, 64)

    t = np.asarray(
        tri_intersect(
            jnp.asarray(o),
            jnp.asarray(d),
            arrays.pa,
            arrays.pb,
            arrays.pc,
            t_min=cfg.t_min,
            t_max=cfg.t_max,
            eps=cfg.eps,
        )
    )
    p = arrays.pa.shape[0]
    for i in range(16):
        for s in range(1, p):
            w = oracle.intrs_tri(o[i].astype(np.float64), d[i].astype(np.float64), s)
            if w is None:
                assert t[i, s] == pytest.approx(cfg.t_max + 1.0)
            else:
                assert t[i, s] == pytest.approx(w, rel=1e-4)


def test_closest_hit_matches_oracle(default_scene):
    cfg = ComputeConfig()
    oracle = Oracle(default_scene, cfg)
    arrays = default_scene.pack()
    rng = np.random.default_rng(1)
    o, d = _random_rays(rng, 128)

    t, pid = closest_hit_bruteforce(
        jnp.asarray(o),
        jnp.asarray(d),
        arrays.pa,
        arrays.pb,
        arrays.pc,
        jnp.zeros((128,), dtype=jnp.int32),
        t_min=cfg.t_min,
        t_max=cfg.t_max,
        eps=cfg.eps,
        chunk=16,  # force multiple chunks
    )
    t, pid = np.asarray(t), np.asarray(pid)
    for i in range(128):
        ot, os_ = oracle.intrs(o[i].astype(np.float64), d[i].astype(np.float64), 0)
        if os_ == 0:
            assert pid[i] == 0
        else:
            assert pid[i] == os_, f"ray {i}: got prim {pid[i]}, want {os_}"
            assert t[i] == pytest.approx(ot, rel=1e-4)


def test_exclusion(default_scene):
    """The excl prim must be skipped (shadow-ray self-exclusion)."""
    cfg = ComputeConfig()
    arrays = default_scene.pack()
    rng = np.random.default_rng(2)
    o, d = _random_rays(rng, 64)
    t0, p0 = closest_hit_bruteforce(
        jnp.asarray(o), jnp.asarray(d),
        arrays.pa, arrays.pb, arrays.pc,
        jnp.zeros((64,), dtype=jnp.int32),
        t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps,
    )
    # Exclude each ray's own hit; the same prim must not be reported again.
    t1, p1 = closest_hit_bruteforce(
        jnp.asarray(o), jnp.asarray(d),
        arrays.pa, arrays.pb, arrays.pc,
        p0,
        t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps,
    )
    p0, p1 = np.asarray(p0), np.asarray(p1)
    hits = p0 != 0
    assert (p1[hits] != p0[hits]).all()


def test_slab_test_basic():
    o = jnp.asarray(np.array([[0.0, 0.0, -5.0]] * 3, dtype=np.float32))
    d = np.array(
        [[0, 0, 1.0], [0, 1.0, 0], [0, 0, -1.0]], dtype=np.float32
    )
    with np.errstate(divide="ignore"):  # axis-aligned dirs -> inf inv
        inv = jnp.asarray(1.0 / d)
    bmin = jnp.asarray(np.array([-1.0, -1.0, -1.0], dtype=np.float32))
    bmax = jnp.asarray(np.array([1.0, 1.0, 1.0], dtype=np.float32))
    hit = np.asarray(slab_test(o, inv, bmin, bmax))
    assert hit.tolist() == [True, False, True]  # backwards t still intersects line
