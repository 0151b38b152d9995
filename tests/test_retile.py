"""Between-bounce live-tile compaction (shade.trace_tiled retile=).

Whole tiles move, so every per-tile cull set is identical and frames
must match retile=False, on both the any-hit path (pbvh) and the
shared closest-hit path (naive, no any-hit entry).
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


def _frame(scene, **kw):
    return np.asarray(
        Renderer(
            scene, config=Config(resolution=Resolution.sized(64, 48)), **kw
        ).render_frame(block=False)
    )


@pytest.mark.parametrize("anyhit", [True, False])
def test_retile_bit_exact(teatime, anyhit):
    handler = "pbvh" if anyhit else "naive"
    base = _frame(teatime, handler=handler, retile=False)
    rt = _frame(teatime, handler=handler, retile=True)
    assert base.any(), "all-black frame"
    np.testing.assert_allclose(rt, base, atol=1e-6)


def test_retile_with_narrow(teatime):
    """Compaction and tile narrowing compose."""
    base = _frame(teatime, handler="pbvh")
    both = _frame(teatime, handler="pbvh", retile=True, narrow=128)
    np.testing.assert_allclose(both, base, atol=1e-6)
