"""Chained animate (Renderer.animate(chain=K)): K frames per dispatch
with the orbit advanced in-graph (amortizes the per-dispatch host
cost).

Contract pinned here: frame 0 of a chain matches the unchained render
(same camera inputs through the same jitted graph); later frames use
the f32 in-graph orbit (host f64 twin is CameraUniform.orbited) so
they track the host loop within float tolerance; the HOST camera stays
canonical (bit-identical to the unchained loop after any number of
frames); on_frame sees every frame exactly once, in order.
"""

import numpy as np

from rt_rs_tpu.config import Config, Resolution
from rt_rs_tpu.renderer import Renderer

KW = dict(
    config=Config(resolution=Resolution.sized(32, 24)),
    handler="bvh",
)


def _collect(r, frames, chain):
    got = {}
    r.animate(
        frames,
        on_frame=lambda i, f, dt: got.__setitem__(i, np.asarray(f)),
        sync_every=3,
        chain=chain,
    )
    return got


def test_chain_matches_loop(small_scene):
    scene = small_scene
    loop = _collect(Renderer(scene, **KW), 5, chain=None)
    chained = _collect(Renderer(scene, **KW), 5, chain=2)
    assert sorted(chained) == list(range(5)) == sorted(loop)
    # Frame 0: same camera input -> same graph output.
    np.testing.assert_allclose(chained[0], loop[0], atol=1e-6)
    # Later frames: in-graph f32 orbit vs host f64 — float-tolerance
    # agreement (the camera re-syncs to host math every dispatch).
    for i in range(1, 5):
        assert np.abs(chained[i] - loop[i]).max() < 1e-3, i


def test_chain_host_camera_canonical(small_scene):
    scene = small_scene
    a = Renderer(scene, **KW)
    b = Renderer(scene, **KW)
    a.animate(5, sync_every=2, chain=None)
    b.animate(5, sync_every=2, chain=3)  # 5 % 3 != 0: partial chain
    assert a.camera.pos == b.camera.pos
    assert a.camera.at == b.camera.at


# ----------------------------------------------------------------------
# DynamicRenderer.animate(chain=K): same contract over per-frame
# geometry — the host stacks each chain's vertex arrays and one
# dispatch runs K rebuild+trace steps.

def _wobble(scene, i):
    vp = np.asarray(scene.vert_pos, np.float32).copy()
    vp[:, 1] += 0.01 * np.float32(i)
    return vp


def _collect_dynamic(scene, frames, chain):
    from rt_rs_tpu.renderer import DynamicRenderer

    dr = DynamicRenderer(
        scene, config=Config(resolution=Resolution.sized(32, 24))
    )
    got = {}
    calls = []

    def vfn(i):
        calls.append(i)
        return _wobble(scene, i)

    dr.animate(
        frames,
        on_frame=lambda i, f, dt: got.__setitem__(i, np.asarray(f)),
        sync_every=3,
        vertex_fn=vfn,
        chain=chain,
    )
    return got, calls, dr


def test_dynamic_chain_matches_loop(small_scene):
    scene = small_scene
    loop, lcalls, a = _collect_dynamic(scene, 5, chain=None)
    chained, ccalls, b = _collect_dynamic(scene, 5, chain=2)
    assert sorted(chained) == list(range(5)) == sorted(loop)
    # vertex_fn is never called with an out-of-range index (partial
    # final chain re-renders the last frame's geometry).
    assert set(ccalls) <= set(range(5))
    np.testing.assert_allclose(chained[0], loop[0], atol=1e-6)
    for i in range(1, 5):
        assert np.abs(chained[i] - loop[i]).max() < 1e-3, i
    # Host camera stays canonical across both paths.
    assert a.camera.pos == b.camera.pos
