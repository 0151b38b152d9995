"""End-to-end render vs the scalar oracle (the minimum slice gate)."""

import numpy as np
import pytest

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.renderer import Renderer

from .oracle import FastOracle, Oracle

W, H = 32, 24


@pytest.fixture(scope="module")
def default_scene(small_scene):
    """The generated 50-triangle scene."""
    return small_scene


@pytest.fixture(scope="module")
def oracle_image(default_scene):
    cfg = ComputeConfig()
    oracle = Oracle(default_scene, cfg)
    return oracle.render(W, H, default_scene.camera.pos, default_scene.camera.at)


def test_naive_render_matches_oracle(default_scene, oracle_image):
    r = Renderer(
        default_scene,
        config=Config(resolution=Resolution.sized(W, H)),
        handler="naive",
    )
    frame = np.asarray(r.render_frame())
    assert frame.shape == (H, W, 3)
    # f32 vs f64 and op-order differences allow small drift; the image
    # must agree to ~1e-3 in linear color nearly everywhere.
    diff = np.abs(frame - oracle_image)
    assert np.quantile(diff, 0.99) < 2e-3, (
        f"p99 diff {np.quantile(diff, 0.99)}, max {diff.max()}"
    )
    assert diff.max() < 0.1


def test_fast_oracle_matches_scalar(default_scene, oracle_image):
    """FastOracle (prim-vectorized) carries the scalar oracle's
    authority to scenes where the per-prim Python loop is too slow
    (the base scene below).  Contract: identical hit selection on random rays;
    t and the rendered image within a few ULP (BLAS FMA contraction in
    ``np.dot`` — see the FastOracle docstring)."""
    cfg = ComputeConfig()
    scalar = Oracle(default_scene, cfg)
    fast = FastOracle(default_scene, cfg)
    rng = np.random.default_rng(7)
    for _ in range(300):
        o = rng.normal(size=3) * 3.0
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        t1, s1 = scalar.intrs(o, d, 0)
        t2, s2 = fast.intrs(o, d, 0)
        assert s1 == s2
        assert abs(t1 - t2) <= 1e-12 * max(1.0, abs(t1))
    img = fast.render(
        W, H, default_scene.camera.pos, default_scene.camera.at
    )
    assert np.abs(img - oracle_image).max() < 1e-6


def test_naive_matches_oracle_teatime_64x64(base_scene):
    """Oracle-vs-naive on study-scale geometry (the generated base
    scene: 6,320 prims, 2 lights, shadow rays + bounces) at 64x64 — the
    full-fidelity semantic gate the 32x24 small-scene check can't
    provide."""
    scene = base_scene
    cfg = ComputeConfig()
    oracle_img = FastOracle(scene, cfg).render(
        64, 64, scene.camera.pos, scene.camera.at
    )
    r = Renderer(
        scene,
        config=Config(resolution=Resolution.sized(64, 64)),
        handler="naive",
    )
    frame = np.asarray(r.render_frame())
    diff = np.abs(frame - oracle_img)
    assert np.quantile(diff, 0.99) < 2e-3, (
        f"p99 diff {np.quantile(diff, 0.99)}, max {diff.max()}"
    )
    assert diff.max() < 0.1


def test_blank_render_is_black(default_scene):
    r = Renderer(
        default_scene,
        config=Config(resolution=Resolution.sized(W, H)),
        handler="blank",
    )
    frame = np.asarray(r.render_frame())
    assert (frame == 0.0).all()


def test_render_nonempty(default_scene):
    r = Renderer(
        default_scene,
        config=Config(resolution=Resolution.sized(W, H)),
        handler="naive",
    )
    img = r.render_image()
    assert img.dtype == np.uint8
    assert img.any(), "render produced an all-black image"


def test_orbit_changes_frame(default_scene):
    r = Renderer(
        default_scene,
        config=Config(resolution=Resolution.sized(W, H)),
        handler="naive",
    )
    f0 = np.asarray(r.render_frame())
    r.orbit(10.0)
    f1 = np.asarray(r.render_frame())
    assert not np.allclose(f0, f1)
