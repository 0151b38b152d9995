"""Duplicate-triangle (vertex-index triple) exclusion semantics.

The reference's shadow/bounce self-exclusion compares the excluded
prim's VERTEX-INDEX TRIPLE, not its prim id
(``src/lib/handlers/basic.rs:87-91``: a candidate is tested only if ANY
of a/b/c differs), so an exact duplicate triangle is excluded together
with its twin and — because identical corners give a bit-identical
``t`` and the ascending scan's strict ``<`` keeps the first copy
(``basic.rs:95-104``) — the duplicate is never otherwise observable:
a duplicated scene renders exactly like its de-duplicated twin.

The equivalent here is pack-time: ``intersect_indices``
(scene/arrays.py) collapses each later duplicate to a zero-area
``(a, a, a)`` triangle so every backend's zero-cost prim-id exclusion
reproduces the triple semantics exactly.  These tests pin that against
``tests/oracle.py`` (whose ``intrs`` transcribes the triple
comparison faithfully) and against the de-duplicated twin scene across
the naive / packet / bvh / dynamic paths.  Closes the one intentional
micro-divergence PARITY.md carried since round 1.
"""

import numpy as np
import pytest

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.renderer import DynamicRenderer, Renderer
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import intersect_indices
from rt_rs_tpu.scene.camera import CameraUniform

from .oracle import Oracle

W, H = 32, 24


def blocker_scene(copies: int, dup_material: int = 1) -> Scene:
    """A lit wall plus a blocker triangle between the light and the
    wall (shadow-casting, camera-visible), with the blocker prim
    repeated ``copies`` times.  Later copies carry ``dup_material`` so
    winner semantics (first copy shades) are observable."""
    scene = Scene.empty(
        camera=CameraUniform((0.0, 0.0, -4.0), (0.0, 0.0, 2.0))
    )
    scene.vert_pos = np.array(
        [
            [-4.0, -3.3, 2.0], [4.0, -3.3, 2.0], [0.3, 5.0, 2.0],
            [1.5, -1.0, 0.0], [3.0, -1.0, 0.0], [2.2, 1.0, 0.0],
        ],
        dtype=np.float32,
    )
    scene.vert_norm = np.tile(
        np.array([[0.0, 0.0, -1.0]], dtype=np.float32), (6, 1)
    )
    scene.prim_indices = np.array(
        [[0, 1, 2]] + [[3, 4, 5]] * copies, dtype=np.uint32
    )
    scene.prim_material = np.array(
        [0] + [1] + [dup_material] * (copies - 1), dtype=np.int32
    )[: copies + 1]
    scene.light_pos = np.array([[4.0, 0.0, -2.0]], dtype=np.float32)
    scene.light_strength = np.array([1.5], dtype=np.float32)
    scene.mat_color = np.array(
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.1, 0.1, 0.9]],
        dtype=np.float32,
    )
    scene.mat_albedo = np.array(
        [[1.0, 0.5, 0.5], [1.0, 0.5, 0.5], [0.3, 0.9, 0.2]],
        dtype=np.float32,
    )
    scene.mat_spec = np.array([8.0, 8.0, 2.0], dtype=np.float32)
    return scene


def render(scene: Scene, handler: str) -> np.ndarray:
    return np.asarray(
        Renderer(
            scene,
            config=Config(resolution=Resolution.sized(W, H)),
            handler=handler,
        ).render_frame()
    )


def test_intersect_indices_identity_without_duplicates():
    idx = np.array([[0, 1, 2], [3, 4, 5], [1, 2, 0]], dtype=np.uint32)
    # Rotated triples are NOT duplicates (the reference compares
    # componentwise), and the no-duplicate case returns the input
    # object untouched.
    assert intersect_indices(idx) is idx


def test_intersect_indices_collapses_later_copies():
    idx = np.array(
        [[3, 4, 5], [0, 1, 2], [3, 4, 5], [0, 1, 2], [6, 7, 8]],
        dtype=np.uint32,
    )
    out = intersect_indices(idx)
    np.testing.assert_array_equal(
        out,
        [[3, 4, 5], [0, 1, 2], [3, 3, 3], [0, 0, 0], [6, 7, 8]],
    )
    # Input is never mutated.
    assert idx[2, 1] == 4


def test_pack_degenerates_duplicate_rows():
    arrays = blocker_scene(3).pack()
    # Prim rows 3 and 4 (null sentinel at 0) are the later copies:
    # all three corners collapse to vertex 3 of the mesh.
    for row in (3, 4):
        np.testing.assert_array_equal(
            np.asarray(arrays.pa[row]), [1.5, -1.0, 0.0]
        )
        np.testing.assert_array_equal(
            np.asarray(arrays.pa[row]), np.asarray(arrays.pb[row])
        )
        np.testing.assert_array_equal(
            np.asarray(arrays.pa[row]), np.asarray(arrays.pc[row])
        )
    # The canonical copy (row 2) keeps its real corners.
    np.testing.assert_array_equal(
        np.asarray(arrays.pb[2]), [3.0, -1.0, 0.0]
    )


@pytest.fixture(scope="module")
def single_image():
    return render(blocker_scene(1), "naive")


def test_duplicates_render_like_single_copy(single_image):
    """Reference triple semantics: duplicated scene == de-duplicated
    twin, on every backend (the duplicate even has a DIFFERENT
    material — the first-scanned copy must win)."""
    dup = blocker_scene(3, dup_material=2)
    # lbvh included: its on-device build Morton-sorts the UNcollapsed
    # prim_indices (bvh/device.py) but intersects the packed collapsed
    # corners, so duplicates must still be unobservable (ADVICE r4).
    for handler in ("naive", "bvh", "rf_bvh", "pbvh", "lbvh"):
        np.testing.assert_allclose(
            render(dup, handler), single_image, atol=2e-6,
            err_msg=handler,
        )


def test_duplicates_match_triple_faithful_oracle():
    """tests/oracle.py transcribes basic.rs:87-91's triple comparison;
    the production pack-time collapse must agree with it on a scene
    where the two exclusion rules could differ."""
    dup = blocker_scene(2, dup_material=2)
    oracle = Oracle(dup, ComputeConfig()).render(
        W, H, dup.camera.pos, dup.camera.at
    )
    img = render(dup, "naive")
    diff = np.abs(img - oracle)
    assert np.quantile(diff, 0.99) < 2e-3, (
        f"p99 diff {np.quantile(diff, 0.99)}, max {diff.max()}"
    )
    assert diff.max() < 0.1


@pytest.mark.parametrize("refit", [False, True])
def test_dynamic_renderer_duplicates(single_image, refit):
    """DynamicRenderer's per-frame corner gathers go through the same
    collapsed index triples (renderer.py) — in rebuild mode AND in
    refit mode, which bakes a rest-pose Morton permutation over the
    collapsed triples (ADVICE r4)."""
    dup = blocker_scene(3, dup_material=2)
    dr = DynamicRenderer(
        dup, config=Config(resolution=Resolution.sized(W, H)), refit=refit
    )
    frame = np.asarray(dr.render_frame(dup.vert_pos, dup.vert_norm))
    np.testing.assert_allclose(frame, single_image, atol=2e-6)


@pytest.mark.parametrize("handler,kwargs", [
    ("naive", {}),
    ("bvh", {}),
    ("rf_bvh", {}),
    ("pbvh", {}),
    ("lbvh", {}),
])
def test_degenerate_slots_never_hit(handler, kwargs):
    """The pack-time collapse relies on packed ``(a, a, a)`` rows being
    guaranteed misses in EVERY intersector (zero-area -> |det| below
    the eps dead zone).  Pin that directly (ADVICE r4): fire rays at
    the blocker, exclude the canonical copy, and the next hit must be
    the WALL behind it — if a degenerate duplicate slot could hit, it
    would win with the blocker's own (smaller) t."""
    from rt_rs_tpu.handlers import get_handler

    scene = blocker_scene(3, dup_material=2)
    h = get_handler(handler, **kwargs)
    accel, arrays = h.build(scene, scene.pack())
    fn = h.intersect_fn(accel, arrays, ComputeConfig())

    origin = np.array([0.0, 0.0, -4.0], np.float32)
    # A blocker-interior point whose continuation (x=2.7, y=-1.35 at
    # z=2) also lands inside the wall triangle.
    target = np.array([1.8, -0.9, 0.0], np.float32)
    d = target - origin
    d /= np.linalg.norm(d)
    n = 8
    o = np.tile(origin, (n, 1))
    dirs = np.tile(d.astype(np.float32), (n, 1))
    valid = np.ones(n, bool)

    t1, id1 = fn(o, dirs, np.zeros(n, np.int32), valid)
    t1, id1 = np.asarray(t1), np.asarray(id1)
    hit1 = np.asarray(arrays.pa)[id1[0]]
    # First hit is the (non-degenerate) blocker at z == 0.
    assert id1[0] > 0
    assert not np.allclose(
        np.asarray(arrays.pa)[id1[0]], np.asarray(arrays.pb)[id1[0]]
    ), "hit a degenerate (a,a,a) slot"
    assert abs(hit1[2]) < 1e-5, f"first hit not the blocker: {hit1}"

    t2, id2 = fn(o, dirs, id1.astype(np.int32), valid)
    t2, id2 = np.asarray(t2), np.asarray(id2)
    hit2 = np.asarray(arrays.pa)[id2[0]]
    # With the canonical copy excluded, only the degenerate duplicates
    # remain at the blocker's location — the hit must fall through to
    # the wall at z == 2.
    assert id2[0] > 0 and id2[0] != id1[0]
    assert abs(hit2[2] - 2.0) < 1e-5, f"second hit not the wall: {hit2}"
    assert t2[0] > t1[0] + 1.0
