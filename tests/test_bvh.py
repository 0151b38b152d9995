"""BVH builder, checkpoint parity, and traversal equivalence tests."""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from rt_rs_tpu.bvh import BvhData, build_bvh
from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.renderer import Renderer
from rt_rs_tpu.scene import Scene


@pytest.fixture(scope="module")
def default_scene(small_scene):
    """The generated 50-triangle scene."""
    return small_scene


@pytest.fixture(scope="module")
def teatime_scene(base_scene):
    """The generated study-scale scene (6,320 triangles)."""
    return base_scene


@pytest.fixture(scope="module")
def reference_teatime(scenes_dir):
    """The reference's own teatime.json (``reference`` tests only)."""
    return Scene.load(str(scenes_dir / "teatime.json"))


@pytest.mark.reference
def test_teatime_checkpoint_bit_exact(reference_teatime, scenes_dir):
    """Building teatime.json with eps=1.95/target=2 must reproduce the
    shipped teatime.bvh.json bit-for-bit (validates the f32 split
    semantics of aabb.rs:149-248 + flatten order of bvh/mod.rs:29-64)."""
    ref = BvhData.load(str(scenes_dir / "teatime.bvh.json"))
    ours = build_bvh(reference_teatime, eps=1.95, target_item_count=2)
    assert ours.num_nodes == ref.num_nodes == 4951
    np.testing.assert_array_equal(ours.fst, ref.fst)
    np.testing.assert_array_equal(ours.snd, ref.snd)
    np.testing.assert_array_equal(ours.item_idx, ref.item_idx)
    np.testing.assert_array_equal(ours.item_count, ref.item_count)
    np.testing.assert_array_equal(ours.bounds_min, ref.bounds_min)
    np.testing.assert_array_equal(ours.bounds_max, ref.bounds_max)
    np.testing.assert_array_equal(ours.indices, ref.indices)


def test_bvh_invariants(default_scene):
    data = build_bvh(default_scene, eps=0.02, target_item_count=2)
    p = default_scene.num_prims
    # Every prim appears in exactly one leaf.
    assert sorted(data.indices.tolist()) == list(range(p))
    leaf = data.item_count > 0
    # Leaves and interiors partition; interior children are valid.
    # NOTE: the reference's *stored* bounds deliberately do NOT nest
    # (the in-place shrink of aabb.rs:221-229 never refits), which is
    # why traversal uses recomputed cover bounds instead.
    for i in range(data.num_nodes):
        if leaf[i]:
            assert data.fst[i] == 0 and data.snd[i] == 0
        else:
            f, s = int(data.fst[i]), int(data.snd[i])
            assert 0 < f < data.num_nodes and 0 < s < data.num_nodes

    # Cover bounds DO nest and truly cover all leaf geometry.
    cmin, cmax = data.cover_bounds(default_scene)
    verts = default_scene.vert_pos
    idx = default_scene.prim_indices.astype(np.int64)
    for i in range(data.num_nodes):
        if leaf[i]:
            lo = int(data.item_idx[i])
            hi = lo + int(data.item_count[i])
            for p in data.indices[lo:hi]:
                tri = verts[idx[int(p)]]
                assert (tri >= cmin[i] - 1e-6).all()
                assert (tri <= cmax[i] + 1e-6).all()
        else:
            f, s = int(data.fst[i]), int(data.snd[i])
            for c in (f, s):
                assert (cmin[c] >= cmin[i] - 1e-6).all()
                assert (cmax[c] <= cmax[i] + 1e-6).all()


def test_escape_links(default_scene):
    data = build_bvh(default_scene, eps=0.02, target_item_count=2)
    hit, miss = data.escape_links()
    n = data.num_nodes
    leaf = data.is_leaf()
    # Links always move forward in preorder (monotone traversal).
    for i in range(n):
        assert miss[i] > i
        if leaf[i]:
            assert hit[i] == miss[i]
        else:
            assert hit[i] == data.fst[i] > i
    # Walking hit-links from the root visits every node exactly once.
    visited = []
    i = 0
    while i < n:
        visited.append(i)
        i = int(hit[i])
        # hit-chain alone only descends the fst spine; do full check:
    # Full preorder walk: always-enter (hit) on interiors covers all.
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    while stack:
        i = stack.pop()
        seen[i] = True
        if not leaf[i]:
            stack.extend((int(data.fst[i]), int(data.snd[i])))
    assert seen.all()


def test_bvh_json_roundtrip(default_scene, tmp_path):
    data = build_bvh(default_scene, eps=0.02, target_item_count=2)
    path = tmp_path / "out.bvh.json"
    data.save(str(path))
    again = BvhData.load(str(path))
    np.testing.assert_array_equal(data.fst, again.fst)
    np.testing.assert_array_equal(data.bounds_min, again.bounds_min)
    np.testing.assert_array_equal(data.indices, again.indices)
    # Schema identical to the reference checkpoint format.
    with open(path) as f:
        tree = json.load(f)
    assert set(tree.keys()) == {"uniforms", "indices"}
    assert set(tree["uniforms"][0].keys()) == {
        "fst", "snd", "item_idx", "item_count", "bounds"
    }


def _compare_intersect(scene, handler_name, rays=256, seed=3, **kwargs):
    """BVH closest-hit must match naive brute force on random rays."""
    cfg = ComputeConfig()
    arrays = scene.pack()

    naive = get_handler("naive")
    _, naive_arrays = naive.build(scene, arrays)
    naive_fn = naive.intersect_fn(None, naive_arrays, cfg)

    h = get_handler(handler_name, **kwargs)
    accel, h_arrays = h.build(scene, arrays)
    h_fn = h.intersect_fn(accel, h_arrays, cfg)

    rng = np.random.default_rng(seed)
    o = rng.normal(size=(rays, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((rays,), dtype=jnp.int32)

    ones = jnp.ones((o.shape[0],), dtype=bool)
    t0, id0 = naive_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    t1, id1 = h_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-5)
    # Hit/miss agreement.
    assert ((np.asarray(id1) == 0) == (np.asarray(id0) == 0)).all()


@pytest.mark.parametrize("backend", ["threaded", "packet"])
def test_bvh_matches_naive_default(default_scene, backend):
    _compare_intersect(default_scene, "bvh", backend=backend)


def test_bvh_matches_naive_teatime(teatime_scene):
    _compare_intersect(teatime_scene, "bvh", rays=128, seed=4)


@pytest.mark.reference
def test_bvh_precomputed_checkpoint(reference_teatime, scenes_dir):
    """Loading the shipped checkpoint must work and agree with naive
    (BvhConfig::Bytes path, bvh.rs:54-64)."""
    _compare_intersect(
        reference_teatime, "bvh", rays=64, seed=5,
        path=str(scenes_dir / "teatime.bvh.json"),
    )


def test_bvh_render_matches_naive(teatime_scene):
    cfg = Config(resolution=Resolution.sized(48, 32))
    f_naive = np.asarray(
        Renderer(teatime_scene, config=cfg, handler="naive").render_frame()
    )
    f_bvh = np.asarray(
        Renderer(teatime_scene, config=cfg, handler="bvh").render_frame()
    )
    np.testing.assert_allclose(f_bvh, f_naive, atol=1e-5)


def test_bvh_packet_backend_matches_threaded(default_scene):
    """backend='packet' (the packet tracer behind --handler-bvh) must give
    the same closest hits as the threaded walk, ids included (same
    leaf-ordered prim space)."""
    cfg = ComputeConfig()
    arrays = default_scene.pack()
    ht = get_handler("bvh", backend="threaded")
    at_, aa = ht.build(default_scene, arrays)
    ft = ht.intersect_fn(at_, aa, cfg)
    hp = get_handler("bvh", backend="packet")
    ap_, ab = hp.build(default_scene, arrays)
    fp = hp.intersect_fn(ap_, ab, cfg)

    rng = np.random.default_rng(31)
    o = rng.normal(size=(128, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((128,), dtype=jnp.int32)
    ones = jnp.ones((128,), dtype=bool)
    t0, i0 = ft(jnp.asarray(o), jnp.asarray(d), excl, ones)
    t1, i1 = fp(jnp.asarray(o), jnp.asarray(d), excl, ones)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))


def test_bvh_stats(default_scene):
    h = get_handler("bvh")
    accel, _ = h.build(default_scene, default_scene.pack())
    stats = h.stats(accel)
    assert stats.name == "BVH"
    assert stats.size == 48 * accel.nodes.num_nodes  # 48 B/node (bvh/mod.rs:11-17)


def test_handler_instance_reuse_across_scenes(default_scene, teatime_scene):
    """One handler instance serving two Renderers must not cross-wire
    accel state (chunks live in the accel pytree, not on the handler)."""
    h = get_handler("bvh", backend="packet")
    a1, arr1 = h.build(default_scene, default_scene.pack())
    a2, arr2 = h.build(teatime_scene, teatime_scene.pack())
    cfg = ComputeConfig()
    f1 = h.intersect_fn(a1, arr1, cfg)
    rng = np.random.default_rng(41)
    o = rng.normal(size=(64, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((64,), dtype=jnp.int32)
    ones = jnp.ones((64,), dtype=bool)
    t1, _ = f1(jnp.asarray(o), jnp.asarray(d), excl, ones)
    # Reference: a fresh handler on scene 1 only.
    href = get_handler("bvh", backend="packet")
    aref, arrref = href.build(default_scene, default_scene.pack())
    tref, _ = href.intersect_fn(aref, arrref, cfg)(
        jnp.asarray(o), jnp.asarray(d), excl, ones
    )
    np.testing.assert_allclose(np.asarray(t1), np.asarray(tref), rtol=1e-6)


def test_bvh_packet_render_matches_naive(teatime_scene):
    """Full render through the bvh handler's PACKET backend (tiled +
    per-ray refine tags) must match naive — covers the refine-tagged
    tiled/any-hit entries the AoS test cannot."""
    cfg = Config(resolution=Resolution.sized(48, 32))
    f_naive = np.asarray(
        Renderer(teatime_scene, config=cfg, handler="naive").render_frame()
    )
    for refine in ("bounces", "all", "off"):
        f_p = np.asarray(
            Renderer(
                teatime_scene, config=cfg, handler="bvh",
                handler_kwargs=dict(backend="packet", refine=refine),
            ).render_frame()
        )
        np.testing.assert_allclose(f_p, f_naive, atol=1e-5)
