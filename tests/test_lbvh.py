"""On-device LBVH: Morton codes, Karras hierarchy, handler, dynamics."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.ops.lbvh import (
    karras_hierarchy,
    morton_codes,
    morton_order,
    refit_bounds,
)
from rt_rs_tpu.renderer import DynamicRenderer, Renderer
from rt_rs_tpu.scene.procedural import base_scene as make_base_scene


@pytest.fixture(scope="module")
def default_scene(base_scene):
    return base_scene


@pytest.fixture(scope="module")
def teatime_scene():
    """A second generated scene (another seed, same scale)."""
    return make_base_scene(1)


def test_morton_codes_basic():
    lo = jnp.zeros(3)
    hi = jnp.ones(3)
    pts = jnp.asarray(
        np.array(
            [[0, 0, 0], [1, 1, 1], [0.999, 0, 0], [0, 0.999, 0], [0, 0, 0.999]],
            dtype=np.float32,
        )
    )
    codes = np.asarray(morton_codes(pts, lo, hi))
    assert codes[0] == 0
    assert codes[1] == 0x3FFFFFFF  # all 30 bits set
    # x contributes the highest interleaved bit.
    assert codes[2] > codes[3] > codes[4]


def test_morton_order_is_permutation(teatime_scene):
    arrays = teatime_scene.pack()
    pa, pb, pc = arrays.pa[1:], arrays.pb[1:], arrays.pc[1:]
    cent = np.asarray((pa + pb + pc) / 3.0)
    codes = morton_codes(
        jnp.asarray(cent),
        jnp.asarray(cent.min(0)),
        jnp.asarray(cent.max(0)),
    )
    order = np.asarray(morton_order(codes))
    assert sorted(order.tolist()) == list(range(cent.shape[0]))
    assert np.all(np.diff(np.asarray(codes)[order].astype(np.int64)) >= 0)


def test_karras_hierarchy_structure(teatime_scene):
    """Radix-tree invariants: walking from the root reaches every leaf
    exactly once; refit bounds cover leaf bounds."""
    arrays = teatime_scene.pack()
    pa, pb, pc = arrays.pa[1:], arrays.pb[1:], arrays.pc[1:]
    cent = (pa + pb + pc) / 3.0
    lo = jnp.min(cent, axis=0)
    hi = jnp.max(cent, axis=0)
    codes = morton_codes(cent, lo, hi)
    order = morton_order(codes)
    codes_sorted = codes[order]

    left, right, left_leaf, right_leaf, _, _ = karras_hierarchy(codes_sorted)
    n = codes_sorted.shape[0]
    left, right = np.asarray(left), np.asarray(right)
    l_leaf, r_leaf = np.asarray(left_leaf), np.asarray(right_leaf)

    seen_leaves = np.zeros(n, dtype=int)
    seen_internal = np.zeros(n - 1, dtype=int)
    stack = [0]
    while stack:
        node = stack.pop()
        seen_internal[node] += 1
        for child, is_leaf in ((left[node], l_leaf[node]),
                               (right[node], r_leaf[node])):
            if is_leaf:
                seen_leaves[child] += 1
            else:
                stack.append(child)
    assert (seen_leaves == 1).all()
    assert (seen_internal == 1).all()

    # Bounds refit covers every leaf under every ancestor.
    tri_min = np.minimum(np.minimum(np.asarray(pa), np.asarray(pb)), np.asarray(pc))
    tri_max = np.maximum(np.maximum(np.asarray(pa), np.asarray(pb)), np.asarray(pc))
    o = np.asarray(order)
    nmin, nmax = refit_bounds(
        jnp.asarray(left), jnp.asarray(right),
        jnp.asarray(l_leaf), jnp.asarray(r_leaf),
        jnp.asarray(tri_min[o]), jnp.asarray(tri_max[o]),
    )
    nmin, nmax = np.asarray(nmin), np.asarray(nmax)
    # Root (internal 0) covers everything.
    assert (nmin[0] <= tri_min.min(0) + 1e-6).all()
    assert (nmax[0] >= tri_max.max(0) - 1e-6).all()


def _compare(scene, rays=128, seed=21):
    cfg = ComputeConfig()
    arrays = scene.pack()
    naive = get_handler("naive")
    _, na = naive.build(scene, arrays)
    naive_fn = naive.intersect_fn(None, na, cfg)
    h = get_handler("lbvh")
    accel, ha = h.build(scene, arrays)
    h_fn = h.intersect_fn(accel, ha, cfg)

    rng = np.random.default_rng(seed)
    o = rng.normal(size=(rays, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((rays,), dtype=jnp.int32)
    ones = jnp.ones((rays,), dtype=bool)
    t0, _ = naive_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    t1, _ = h_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-5)


def test_lbvh_matches_naive_default(default_scene):
    _compare(default_scene)


def test_lbvh_matches_naive_teatime(teatime_scene):
    _compare(teatime_scene, rays=96, seed=22)


def test_device_built_bvh_data(teatime_scene):
    """build_bvh_device (Morton + Karras emit + refit on device, host
    preorder flatten) yields a structurally valid, checkpoint-
    serializable BvhData the handlers can consume."""
    import json
    import tempfile

    from rt_rs_tpu.bvh.device import build_bvh_device

    data = build_bvh_device(teatime_scene)
    p = teatime_scene.num_prims
    assert data.num_nodes == 2 * p - 1
    # Every prim in exactly one leaf.
    assert sorted(data.indices.tolist()) == list(range(p))
    leaf = data.is_leaf()
    assert int(leaf.sum()) == p
    assert (data.item_count[leaf] == 1).all()
    # Preorder invariant: children at strictly larger indices.
    interior = ~leaf
    assert (data.fst[interior] > np.arange(data.num_nodes)[interior]).all()
    assert (data.snd[interior] > np.arange(data.num_nodes)[interior]).all()
    # Refit bounds cover children.
    for name in ("fst", "snd"):
        ch = getattr(data, name)[interior]
        assert (
            data.bounds_min[interior] <= data.bounds_min[ch] + 1e-6
        ).all()
        assert (
            data.bounds_max[interior] >= data.bounds_max[ch] - 1e-6
        ).all()
    # Checkpoint round-trip.
    with tempfile.NamedTemporaryFile("w+", suffix=".bvh.json") as f:
        data.save(f.name)
        loaded = type(data).load(f.name)
        json.load(open(f.name))  # valid JSON
    np.testing.assert_array_equal(loaded.indices, data.indices)
    np.testing.assert_array_equal(loaded.fst, data.fst)


def test_device_built_bvh_renders(default_scene):
    """The device-built tree drives both the threaded and packet
    handlers to naive-equal images."""
    from rt_rs_tpu.bvh.device import build_bvh_device

    data = build_bvh_device(default_scene)
    w, h = 32, 24
    cfg = Config(resolution=Resolution.sized(w, h))
    ref = np.asarray(
        Renderer(default_scene, config=cfg, handler="naive").render_frame()
    )
    for handler, kwargs in (
        ("bvh", dict(data=data)),
        ("pbvh", dict(data=data)),
    ):
        img = np.asarray(
            Renderer(
                default_scene, config=cfg, handler=handler,
                handler_kwargs=kwargs,
            ).render_frame()
        )
        np.testing.assert_allclose(img, ref, atol=1e-5)


def test_dynamic_refit_matches_rebuild(default_scene):
    """refit=True (frozen rest-pose order, per-frame bounds only) must
    render identically to the full per-frame rebuild."""
    w, h = 32, 24
    cfg = Config(resolution=Resolution.sized(w, h))
    dyn_refit = DynamicRenderer(
        default_scene, config=cfg, refit=True
    )
    dyn_full = DynamicRenderer(default_scene, config=cfg)
    shift = np.array([0.4, 0.2, -0.3], dtype=np.float32)
    moved = default_scene.vert_pos + shift
    np.testing.assert_allclose(
        np.asarray(dyn_refit.render_frame(moved)),
        np.asarray(dyn_full.render_frame(moved)),
        atol=1e-5,
    )


def test_dynamic_rebuild(default_scene):
    """Moving the geometry and rebuilding on-device must equal a
    from-scratch render of the moved scene."""
    w, h = 32, 24
    dyn = DynamicRenderer(
        default_scene,
        config=Config(resolution=Resolution.sized(w, h)),
    )
    shift = np.array([0.5, -0.25, 0.3], dtype=np.float32)
    moved = default_scene.vert_pos + shift

    frame_dyn = np.asarray(dyn.render_frame(moved))

    import copy

    moved_scene = copy.deepcopy(default_scene)
    moved_scene.vert_pos = moved
    frame_ref = np.asarray(
        Renderer(
            moved_scene,
            config=Config(resolution=Resolution.sized(w, h)),
            handler="naive",
        ).render_frame()
    )
    np.testing.assert_allclose(frame_dyn, frame_ref, atol=1e-5)

    # And animating back to the original matches the static render.
    frame_back = np.asarray(dyn.render_frame(default_scene.vert_pos))
    frame_static = np.asarray(
        Renderer(
            default_scene,
            config=Config(resolution=Resolution.sized(w, h)),
            handler="naive",
        ).render_frame()
    )
    np.testing.assert_allclose(frame_back, frame_static, atol=1e-5)


def test_lbvh_tiled_and_anyhit_match(teatime_scene):
    """The lbvh handler exposes the same tiled and any-hit entries as
    pbvh on the tuned configuration; the any-hit shadow path renders
    the identical image."""
    from rt_rs_tpu.ops import shade

    cfg = ComputeConfig()
    arrays = teatime_scene.pack()
    h = get_handler("lbvh")
    assert h.block_lanes == 256  # tuned ray tile
    accel, arr2 = h.build(teatime_scene, arrays)
    assert accel.tri_chunk == 64  # tuned chunk height

    pos = jnp.asarray(teatime_scene.camera.pos, jnp.float32)
    at = jnp.asarray(teatime_scene.camera.at, jnp.float32)
    anyhit_fn = h.intersect_tiled_anyhit_fn(accel, arr2, cfg)
    assert anyhit_fn is not None
    base = shade.render_tiled(
        arr2, h.intersect_tiled_fn(accel, arr2, cfg), cfg, pos, at,
        48, 32, ray_tile=256, block=(16, 16),
    )
    fast = shade.render_tiled(
        arr2, h.intersect_tiled_fn(accel, arr2, cfg), cfg, pos, at,
        48, 32, ray_tile=256, block=(16, 16),
        intersect_anyhit_fn=anyhit_fn,
    )
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(base))


def test_lbvh_renderer_matches_naive(default_scene):
    """End-to-end Renderer equality on the lbvh tiled path."""
    cfg = Config(resolution=Resolution.sized(48, 32))
    ref = np.asarray(
        Renderer(default_scene, config=cfg, handler="naive").render_frame()
    )
    img = np.asarray(
        Renderer(default_scene, config=cfg, handler="lbvh").render_frame()
    )
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_dynamic_refine_off_matches(default_scene):
    """DynamicRenderer's per-ray cull of bounce/shadow batches is exact:
    frames with it off agree (rebuild and refit)."""
    cfg = Config(resolution=Resolution.sized(32, 24))
    base = np.asarray(
        DynamicRenderer(default_scene, config=cfg).render_frame(
            default_scene.vert_pos
        )
    )
    for refit in (False, True):
        dyn = DynamicRenderer(
            default_scene, config=cfg, refit=refit, refine=False
        )
        np.testing.assert_allclose(
            np.asarray(dyn.render_frame(default_scene.vert_pos)), base,
            atol=2e-6,
        )


def test_dynamic_nonfinite_normals_stay_local(default_scene):
    """Non-finite per-frame normals (the degenerate-face import
    outcome) render: NaN stays confined to pixels hitting the
    degenerate prim, the rest of the frame still renders lit
    geometry."""
    cfg = Config(resolution=Resolution.sized(32, 24))
    dyn = DynamicRenderer(default_scene, config=cfg)
    vp = np.asarray(default_scene.vert_pos, np.float32)
    bad_norm = np.asarray(default_scene.vert_norm, np.float32).copy()
    bad_norm[4] = np.nan
    frame = np.asarray(dyn.render_frame(vp, bad_norm))
    assert np.nan_to_num(frame).sum() > 0
    assert np.isfinite(frame).mean() > 0.9


@pytest.mark.parametrize("tri_chunk", [16, 64])
def test_lbvh_tri_chunk_variants(teatime_scene, tri_chunk):
    """Any chunk height builds one flat compact table with the same
    triangles."""
    from rt_rs_tpu.handlers.lbvh import LbvhIntrs

    arrays = teatime_scene.pack()
    acc, _ = LbvhIntrs(tri_chunk=tri_chunk).build(teatime_scene, arrays)
    assert acc.tri_chunk == tri_chunk
    assert acc.comp.shape == (9, acc.num_chunks * tri_chunk)
    assert acc.num_chunks * tri_chunk >= teatime_scene.num_prims
