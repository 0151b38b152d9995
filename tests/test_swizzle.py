"""Pixel-block packet ordering must be a no-op on the image.

``shade.camera_rays(block=...)`` + ``shade.unblock_colors`` reorder the
ray batch so each 128-ray packet tile covers a compact 2-D pixel block
(tighter tile frusta -> cheaper chunk culling).  Per-ray math
is op-identical — outside jit the frames match bit-for-bit — but under
``jax.jit`` XLA's fusion may contract mul+add chains into FMAs
differently for the two graph shapes, so the jitted contract is
"identical to ~1 ULP in ray directions" (measured: <= 6e-6 in final
colors on CPU).  Sizes that don't divide the
block are padded with duplicated edge rays and cropped.
"""

import numpy as np
import pytest

from rt_rs_tpu.config import Config, Resolution
from rt_rs_tpu.ops import shade
from rt_rs_tpu.renderer import Renderer


@pytest.fixture(scope="module")
def default_scene(small_scene):
    """The generated 50-triangle scene."""
    return small_scene


@pytest.mark.parametrize("block", [(8, 16), (16, 8), (4, 32)])
@pytest.mark.parametrize("size", [(128, 64), (101, 67), (7, 5)])
def test_block_rays_are_a_permutation(default_scene, block, size):
    import jax.numpy as jnp

    w, h = size
    pos = jnp.asarray(default_scene.camera.pos, jnp.float32)
    at = jnp.asarray(default_scene.camera.at, jnp.float32)
    o0, d0 = shade.camera_rays(pos, at, w, h)
    ob, db = shade.camera_rays(pos, at, w, h, block=block)
    # Unswizzling the blocked dirs (as 3-channel "colors") must
    # reproduce the raster grid exactly.
    img0 = np.asarray(d0).reshape(h, w, 3)
    imgb = np.asarray(shade.unblock_colors(db, w, h, block))
    assert np.array_equal(img0, imgb)
    assert np.array_equal(
        np.asarray(o0).reshape(h, w, 3),
        np.asarray(shade.unblock_colors(ob, w, h, block)),
    )


@pytest.mark.parametrize("handler,kwargs", [
    ("naive", {}),
    ("pbvh", {}),
])
def test_render_bit_identical_with_block(default_scene, handler, kwargs):
    frames = {}
    for block in [None, (8, 16)]:
        r = Renderer(
            default_scene,
            config=Config(resolution=Resolution.sized(101, 67)),
            handler=handler,
            handler_kwargs=kwargs,
            block=block,
        )
        frames[block] = np.asarray(r.render_frame(block=False))
    # ~1 ULP in ray dirs from jit FMA contraction; nothing visible.
    assert np.allclose(frames[None], frames[(8, 16)], atol=2e-5)
    u8 = {
        k: np.round(np.clip(v, 0.0, 1.0) * 255.0).astype(int)
        for k, v in frames.items()
    }
    assert np.abs(u8[None] - u8[(8, 16)]).max() <= 1
