"""RF-BVH packing format and traversal equivalence tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_rs_tpu.bvh import build_bvh
from rt_rs_tpu.bvh.rf import (
    MAX_LEAF_ITEMS,
    RfFormatError,
    pack2x16,
    pack_rf,
    unpack2x16,
    unpack_rf,
)
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


def test_pack2x16_roundtrip():
    rng = np.random.default_rng(0)
    vals = rng.normal(scale=30, size=(64,)).astype(np.float32)
    lo, hi = vals[:32], vals[32:]
    u = pack2x16(lo, hi)
    lo2, hi2 = unpack2x16(u)
    np.testing.assert_array_equal(lo2, lo.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(hi2, hi.astype(np.float16).astype(np.float32))


def test_rf_pack_structure(teatime_scene):
    """Record layout matches rf.rs:94-158: every leaf record is
    followed by its payload; internal tags hold record indices of
    children; MSB marks leaves."""
    data = build_bvh(teatime_scene, eps=0.02, target_item_count=4)
    rf = pack_rf(data)
    n_leaves = int((data.item_count > 0).sum())
    assert rf.num_records == data.num_nodes + n_leaves
    assert rf.byte_size() == 16 * rf.num_records

    un = unpack_rf(rf)
    # Walk the packed tree from record 0; count reachable nodes/leaves.
    seen_nodes = 0
    seen_prims = []
    stack = [0]
    while stack:
        r = stack.pop()
        seen_nodes += 1
        if un["is_leaf"][r]:
            for pid in un["leaf_prims"][r]:
                if pid != 0:
                    seen_prims.append(int(pid) - 1)  # back to 0-based
        else:
            stack.append(int(un["fst"][r]))
            stack.append(int(un["snd"][r]))
    assert seen_nodes == data.num_nodes
    assert sorted(seen_prims) == list(range(teatime_scene.num_prims))


def test_rf_f16_bounds_conservative(teatime_scene):
    """Packed f16 bounds must contain the full-precision cover bounds
    (outward rounding; PARITY.md)."""
    data = build_bvh(teatime_scene, eps=0.02, target_item_count=4)
    cmin, cmax = data.cover_bounds(teatime_scene)
    rf = pack_rf(data, cmin, cmax)
    un = unpack_rf(rf)
    rows = np.where(~un["is_payload"])[0]
    assert (un["bmin"][rows] <= cmin + 1e-6).all()
    assert (un["bmax"][rows] >= cmax - 1e-6).all()


def test_rf_limits():
    # A leaf with >8 prims must be rejected (pdf p.13 §3.2.2).
    scene = Scene.empty()
    rng = np.random.default_rng(1)
    # 16 tiny coincident triangles cannot be split spatially -> one leaf.
    verts = rng.normal(size=(3, 3)).astype(np.float32) * 1e-6
    scene.vert_pos = np.tile(verts, (16, 1)).astype(np.float32)
    scene.vert_norm = np.zeros_like(scene.vert_pos)
    scene.prim_indices = np.arange(48, dtype=np.uint32).reshape(16, 3)
    scene.prim_material = np.zeros(16, dtype=np.int32)
    data = build_bvh(scene, eps=0.02, target_item_count=4)
    if int(data.item_count.max()) > MAX_LEAF_ITEMS:
        with pytest.raises(RfFormatError):
            pack_rf(data)


def _compare(scene, rays=128, seed=11, backend="threaded"):
    cfg = ComputeConfig()
    arrays = scene.pack()
    naive = get_handler("naive")
    _, na = naive.build(scene, arrays)
    naive_fn = naive.intersect_fn(None, na, cfg)
    h = get_handler("rf_bvh", backend=backend)
    accel, ha = h.build(scene, arrays)
    h_fn = h.intersect_fn(accel, ha, cfg)

    rng = np.random.default_rng(seed)
    o = rng.normal(size=(rays, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((rays,), dtype=jnp.int32)
    ones = jnp.ones((rays,), dtype=bool)

    t0, id0 = naive_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    t1, id1 = h_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-5)
    if backend == "threaded":
        # RF does not reorder prims, so ids must agree exactly on hits.
        np.testing.assert_array_equal(np.asarray(id1), np.asarray(id0))
    else:
        # The packet backend answers in leaf order: map back.
        perm = np.concatenate([[0], np.asarray(h.bvh_data.indices) + 1])
        np.testing.assert_array_equal(perm[np.asarray(id1)], np.asarray(id0))


@pytest.mark.parametrize("backend", ["threaded", "packet"])
def test_rf_matches_naive_default(default_scene, backend):
    _compare(default_scene, backend=backend)


def test_rf_matches_naive_teatime(teatime_scene):
    _compare(teatime_scene, rays=96, seed=12)


def test_rf_render_matches_naive(default_scene):
    cfg = Config(resolution=Resolution.sized(32, 24))
    f_naive = np.asarray(
        Renderer(default_scene, config=cfg, handler="naive").render_frame()
    )
    f_rf = np.asarray(
        Renderer(default_scene, config=cfg, handler="rf_bvh").render_frame()
    )
    np.testing.assert_allclose(f_rf, f_naive, atol=1e-5)


def test_rf_packet_backend_matches_threaded(teatime_scene):
    cfg = ComputeConfig()
    arrays = teatime_scene.pack()
    ht = get_handler("rf_bvh", backend="threaded")
    at_, aa = ht.build(teatime_scene, arrays)
    ft = ht.intersect_fn(at_, aa, cfg)
    hp = get_handler("rf_bvh", backend="packet")
    ap_, ab = hp.build(teatime_scene, arrays)
    fp = hp.intersect_fn(ap_, ab, cfg)

    rng = np.random.default_rng(33)
    o = rng.normal(size=(96, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = jnp.zeros((96,), dtype=jnp.int32)
    ones = jnp.ones((96,), dtype=bool)
    t0, i0 = ft(jnp.asarray(o), jnp.asarray(d), excl, ones)
    t1, i1 = fp(jnp.asarray(o), jnp.asarray(d), excl, ones)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-5)
    # Packet ids are rows of the packet build's (leaf-reordered) arrays;
    # translate to the threaded handler's original prim space.
    perm = np.concatenate([[0], np.asarray(hp.bvh_data.indices) + 1])
    np.testing.assert_array_equal(perm[np.asarray(i1)], np.asarray(i0))
    # Self-exclusion works in the packet's own id space.
    t2, i2 = fp(jnp.asarray(o), jnp.asarray(d), i1, ones)
    hits = np.asarray(i1) != 0
    assert (np.asarray(i2)[hits] != np.asarray(i1)[hits]).all()


@pytest.mark.reference
def test_rf_footprint_matches_published(reference_teatime):
    """The study's memory table (pdf p.19 §4.1 Fig. 8): teatime BVH
    +381,840 B, RF-BVH +110,528 B.  Our builds reproduce both exactly
    (48 B x 7,955 nodes at target=2; 16 B x 6,908 records at
    target=4)."""
    bvh = get_handler("bvh")  # defaults: eps=0.02, target=2
    rf = get_handler("rf_bvh")  # defaults: eps=0.02, target=4
    arrays = reference_teatime.pack()
    a_bvh, _ = bvh.build(reference_teatime, arrays)
    a_rf, _ = rf.build(reference_teatime, arrays)
    assert bvh.stats(a_bvh).size == 381840
    assert rf.stats(a_rf).size == 110528


def test_rf_packet_render_matches_naive(teatime_scene):
    """Full render through the rf_bvh handler's PACKET backend (tiled +
    per-ray refine tags) must match naive."""
    cfg = Config(resolution=Resolution.sized(48, 32))
    f_naive = np.asarray(
        Renderer(teatime_scene, config=cfg, handler="naive").render_frame()
    )
    for refine in ("bounces", "off"):
        f_p = np.asarray(
            Renderer(
                teatime_scene, config=cfg, handler="rf_bvh",
                handler_kwargs=dict(backend="packet", refine=refine),
            ).render_frame()
        )
        np.testing.assert_allclose(f_p, f_naive, atol=1e-5)
