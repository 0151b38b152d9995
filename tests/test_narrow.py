"""Tile narrowing for secondary calls (trace_tiled narrow=).

The split is a pure reshape (ray order preserved row-major) and the
per-ray intersect math is unchanged; only the per-sub-tile cull sets
differ — conservatively, so each ray's candidate set still contains
its true closest hit and the (t, smallest-pid) winner is identical.
Frames must therefore match narrow=None on both the any-hit path
(pbvh) and the shared closest-hit path (naive, no any-hit entry).
"""

import numpy as np
import pytest

from rt_rs_tpu.config import Config, Resolution
from rt_rs_tpu.renderer import Renderer


@pytest.fixture(scope="module")
def teatime(base_scene):
    scene = base_scene.__class__(**vars(base_scene))
    scene.camera = scene.camera.orbited(25.0)  # side-on (divergent bounces)
    return scene


@pytest.mark.parametrize("anyhit", [True, False])
def test_narrow_bit_exact(teatime, anyhit):
    kw = dict(
        config=Config(resolution=Resolution.sized(64, 48)),
        handler="pbvh" if anyhit else "naive",
        block=(16, 16),
    )
    base = np.asarray(
        Renderer(teatime, **kw).render_frame(block=False)
    )
    nw = np.asarray(
        Renderer(teatime, narrow=128, **kw).render_frame(block=False)
    )
    assert base.any(), "all-black frame"
    np.testing.assert_allclose(nw, base, atol=1e-6)


def test_narrow_must_divide(teatime):
    r = Renderer(
        teatime,
        config=Config(resolution=Resolution.sized(64, 48)),
        handler="pbvh",
        narrow=96,
    )
    with pytest.raises(ValueError, match="narrow"):
        r.render_frame(block=False)
