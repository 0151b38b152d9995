"""Camera-headlight path (config.camera_light_source) vs the oracle.

The headlight is OFF by default (strength 0, mod.rs:129) so no other
test exercises compute.wgsl:236-244.
"""

import numpy as np
import pytest

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.renderer import Renderer

from .oracle import Oracle

W, H = 24, 16


@pytest.fixture(scope="module")
def default_scene(small_scene):
    """The generated 50-triangle scene."""
    return small_scene


def test_headlight_matches_oracle(default_scene):
    cfg = ComputeConfig(camera_light_source=2.0, bounces=2)
    oracle = Oracle(default_scene, cfg)
    golden = oracle.render(
        W, H, default_scene.camera.pos, default_scene.camera.at
    )
    frame = np.asarray(
        Renderer(
            default_scene,
            config=Config(compute=cfg, resolution=Resolution.sized(W, H)),
            handler="naive",
        ).render_frame()
    )
    diff = np.abs(frame - golden)
    assert np.quantile(diff, 0.99) < 2e-3
    assert diff.max() < 0.1


def test_headlight_brightens(default_scene):
    base = np.asarray(
        Renderer(
            default_scene,
            config=Config(resolution=Resolution.sized(W, H)),
            handler="naive",
        ).render_frame()
    )
    lit = np.asarray(
        Renderer(
            default_scene,
            config=Config(
                compute=ComputeConfig(camera_light_source=2.0),
                resolution=Resolution.sized(W, H),
            ),
            handler="naive",
        ).render_frame()
    )
    assert lit.sum() > base.sum()
    assert (lit + 1e-6 >= base - 1e-5).all()  # headlight only adds light
