"""Packet-BVH equivalence tests (Pallas kernel in interpret mode on CPU),
on the generated base scene."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.ops.pallas.packet_trace import (
    DualTriChunks,
    TriChunks,
    chunk_overlap_mask_cm,
    chunk_overlap_mask_perray_cm,
    packet_closest_hit_tiled,
)
from rt_rs_tpu.renderer import Renderer

RES = Config(resolution=Resolution.sized(48, 32))


def _rand_rays(rng, n, scale=8.0):
    o = rng.normal(size=(n, 3), scale=scale).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _rand_payload(rng, t_tiles=32, r=256, scale=5.0):
    o = rng.normal(size=(3, t_tiles, r), scale=scale).astype(np.float32)
    d = rng.normal(size=(3, t_tiles, r)).astype(np.float32)
    payload = jnp.concatenate(
        [jnp.asarray(o), jnp.asarray(d), jnp.zeros((2, t_tiles, r), jnp.float32)]
    )
    return payload, jnp.asarray(rng.random((t_tiles, r)) > 0.3)


def _compare(scene, rays=256, seed=7, **handler_kw):
    cfg = ComputeConfig()
    arrays = scene.pack()

    naive = get_handler("naive")
    _, na = naive.build(scene, arrays)
    naive_fn = naive.intersect_fn(None, na, cfg)

    h = get_handler("pbvh", **handler_kw)
    accel, ha = h.build(scene, arrays)
    h_fn = h.intersect_fn(accel, ha, cfg)

    rng = np.random.default_rng(seed)
    o, d = _rand_rays(rng, rays)
    excl = jnp.zeros((rays,), dtype=jnp.int32)
    ones = jnp.ones((rays,), dtype=bool)
    t0, id0 = naive_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    t1, id1 = h_fn(jnp.asarray(o), jnp.asarray(d), excl, ones)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-5)
    assert ((np.asarray(id1) == 0) == (np.asarray(id0) == 0)).all()


def _frame(scene, handler, cfg=RES, **handler_kw):
    return np.asarray(
        Renderer(
            scene, config=cfg, handler=handler, handler_kwargs=handler_kw
        ).render_frame()
    )


@pytest.fixture(scope="module")
def naive_frame(base_scene):
    return _frame(base_scene, "naive")


@pytest.fixture(scope="module")
def accel(base_scene):
    return get_handler("pbvh").build(base_scene, base_scene.pack())[0]


def test_pbvh_matches_naive_default(base_scene):
    _compare(base_scene)


@pytest.mark.parametrize("cull_block", [1, 4, 32])
def test_pbvh_cull_block_granularities(base_scene, cull_block):
    """Culling granularity is a perf knob only — results are exact at
    every block size (1 = per-chunk, 32 = CHUNK_ALIGN)."""
    _compare(base_scene, seed=11, cull_block=cull_block)


def test_pbvh_matches_naive_lax_loop(base_scene):
    """The plain-lax chunk loop behind the same handler."""
    _compare(base_scene, rays=128, seed=8, loop="lax")


def test_pbvh_render_matches_naive(base_scene, naive_frame):
    np.testing.assert_allclose(
        _frame(base_scene, "pbvh"), naive_frame, atol=1e-5
    )


def test_pbvh_render_lax_loop_matches_kernel(base_scene):
    """The kernel and the lax loop see the same lists and keep the same
    winner: whole frames agree exactly."""
    np.testing.assert_array_equal(
        _frame(base_scene, "pbvh", loop="lax"), _frame(base_scene, "pbvh")
    )


def test_chunk_bounds_cover(accel):
    """Every triangle's vertices lie inside its chunk AABB, and the
    table is the compact [9, Nc * tc] layout."""
    tc = accel.tri_chunk
    comp = np.asarray(accel.comp)
    assert comp.shape == (9, accel.num_chunks * tc)
    tri = comp.T.reshape(accel.num_chunks, tc, 9)
    a = tri[:, :, 0:3]
    b = a + tri[:, :, 3:6]
    c = a + tri[:, :, 6:9]
    real = np.abs(tri).sum(axis=2) > 0  # padded triangles are all-zero
    bmin = np.asarray(accel.bmin)
    bmax = np.asarray(accel.bmax)
    for corner in (a, b, c):
        lo = np.where(real[..., None], corner, np.inf).min(axis=1)
        hi = np.where(real[..., None], corner, -np.inf).max(axis=1)
        has = real.any(axis=1)
        assert (lo[has] >= bmin[has] - 1e-4).all()
        assert (hi[has] <= bmax[has] + 1e-4).all()


def test_overlap_mask_conservative(accel):
    """Culled (tile, chunk) pairs truly have no per-ray slab hits."""
    from rt_rs_tpu.ops.intersect import slab_test

    rng = np.random.default_rng(9)
    o, d = _rand_rays(rng, 128)
    valid = jnp.ones((1, 128), dtype=bool)
    mask = np.asarray(
        chunk_overlap_mask_cm(
            jnp.asarray(o.T)[:, None, :], jnp.asarray(1.0 / d.T)[:, None, :],
            valid, accel.bmin, accel.bmax, t_min=0.01, t_max=1000.0,
        )
    )[0]
    for c in range(accel.num_chunks):
        if (np.asarray(accel.bmin[c]) > np.asarray(accel.bmax[c])).any():
            # Padded chunks (inverted bounds) must always be culled; the
            # raw slab test passes them through (entry -inf / exit +inf).
            assert not mask[c], f"empty pad chunk {c} not culled"
        elif not mask[c]:
            per_ray = np.asarray(
                slab_test(
                    jnp.asarray(o), jnp.asarray(1.0 / d),
                    accel.bmin[c], accel.bmax[c],
                )
            )
            assert not per_ray.any(), f"chunk {c} culled but has slab hits"


# ----------------------------------------------------------------------
# Per-ray cull refinement (refine=True paths)


def test_refine_masks_agree_and_subset(accel):
    """The per-ray mask is a subset of the tile-interval mask (the
    per-ray slab for any live ray is contained in the tile's interval
    product) while still covering every actual hit."""
    cfg = ComputeConfig()
    rng = np.random.default_rng(11)
    payload, valid = _rand_payload(rng)
    payload = payload.at[3, :, ::9].set(0.0)  # axis-parallel rays
    cap = jnp.asarray(rng.uniform(1.0, 60.0, valid.shape).astype(np.float32))
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, t_cap=cap)
    ov_r = chunk_overlap_mask_perray_cm(
        payload[0:3], 1.0 / payload[3:6], valid, accel.bmin, accel.bmax, **kw
    )
    ov_int = chunk_overlap_mask_cm(
        payload[0:3], 1.0 / payload[3:6], valid, accel.bmin, accel.bmax, **kw
    )
    assert not np.any(np.asarray(ov_r) & ~np.asarray(ov_int))

    # Conservativeness: every sub-cap hit of the unrefined trace must
    # still be found with refine on.
    win = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
    t0, i0 = packet_closest_hit_tiled(accel, payload, valid, cap, **win)
    t1, i1 = packet_closest_hit_tiled(
        accel, payload, valid, cap, refine=True, **win
    )
    below = np.asarray(valid) & (np.asarray(t0) < np.asarray(cap))
    np.testing.assert_array_equal(np.asarray(t1)[below], np.asarray(t0)[below])
    np.testing.assert_array_equal(np.asarray(i1)[below], np.asarray(i0)[below])


@pytest.mark.parametrize("refine", ["off", "bounces", "all"])
def test_refine_render_equal(base_scene, refine, naive_frame):
    """Full jitted frames agree across refine modes to the suite's
    cross-path tolerance (the cull is exact; under jit the extra cull
    shifts XLA fusion boundaries in surrounding glue at the ~1-ULP
    level — same class as trace() vs trace_tiled())."""
    np.testing.assert_allclose(
        _frame(base_scene, "pbvh", refine=refine), naive_frame,
        rtol=1e-5, atol=1e-5,
    )


def test_refine_trace_bit_exact(base_scene):
    """Outside jit (eager trace_tiled), refine modes ARE bit-exact:
    the refinement only prunes chunks the rays cannot hit, and the
    per-chunk math is untouched."""
    from rt_rs_tpu.ops import shade

    cfg = ComputeConfig(bounces=2)
    arrays = base_scene.pack()
    colors = {}
    for mode in ("off", "all"):
        h = get_handler("pbvh", refine=mode)
        accel, arr2 = h.build(base_scene, arrays)
        pos = jnp.asarray(base_scene.camera.pos, jnp.float32)
        at = jnp.asarray(base_scene.camera.at, jnp.float32)
        payload, valid, _ = shade.camera_ray_tiles(
            pos, at, 48, 32, 256, block=(16, 16)
        )
        colors[mode] = np.asarray(
            shade.trace_tiled(
                arr2, h.intersect_tiled_fn(accel, arr2, cfg), cfg,
                payload, valid, pos,
            )
        )
    np.testing.assert_array_equal(colors["all"], colors["off"])


@pytest.mark.parametrize("tri_chunk", [16, 32])
def test_pbvh_render_tri_chunk_variants(base_scene, naive_frame, tri_chunk):
    """tri_chunk is a perf knob only — full renders match naive at
    every chunk height."""
    np.testing.assert_allclose(
        _frame(base_scene, "pbvh", tri_chunk=tri_chunk), naive_frame,
        atol=1e-5,
    )


def test_dual_tables_dispatch(base_scene):
    """Dual tables: the refine-keyed dispatch routes refine batches to
    the fine table and primaries to the coarse one, with results equal
    to the single tables (prim ids are tc-invariant in dense leaf
    order, and refinement only prunes unhittable chunks)."""
    cfg = ComputeConfig()
    h = get_handler("pbvh", tri_chunk_fine=16)
    dual, arr2 = h.build(base_scene, base_scene.pack())
    assert isinstance(dual, DualTriChunks)
    assert isinstance(dual.fine, TriChunks) and dual.fine.tri_chunk == 16
    assert h.stats(dual).size > get_handler("pbvh").stats(dual.coarse).size
    tiso = h.intersect_tiled_fn(dual, arr2, cfg)
    ah = h.intersect_tiled_anyhit_fn(dual, arr2, cfg)
    assert tiso.supports_refine and ah.supports_refine

    rng = np.random.default_rng(7)
    payload, valid = _rand_payload(rng)
    payload = payload.at[7].set(30.0)  # any-hit occlusion bound
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
    v = np.asarray(valid)
    for refine, tbl in ((False, dual.coarse), (True, dual.fine)):
        t0, i0 = packet_closest_hit_tiled(tbl, payload, valid, refine=refine, **kw)
        t1, i1 = tiso(payload, valid, refine=refine)
        np.testing.assert_array_equal(np.asarray(t1)[v], np.asarray(t0)[v])
        np.testing.assert_array_equal(np.asarray(i1)[v], np.asarray(i0)[v])
        b0 = packet_closest_hit_tiled(
            tbl, payload, valid, any_hit=True, refine=refine, **kw
        )
        b1 = ah(payload, valid, refine=refine)
        np.testing.assert_array_equal(np.asarray(b1)[v], np.asarray(b0)[v])


def test_pbvh_dual_tables_bit_exact(base_scene):
    """Dual-granularity tables must not change a single pixel."""
    np.testing.assert_array_equal(
        _frame(base_scene, "pbvh", tri_chunk_fine=16),
        _frame(base_scene, "pbvh"),
    )


def test_nonfinite_normals_stay_local(base_scene):
    """Degenerate geometry imports with NaN smooth normals (reference
    parity — v3.rs normalize divides by a zero magnitude).  NaN must
    reach exactly the pixels the naive path puts it on, not whole
    tiles."""
    scene = base_scene.__class__(**vars(base_scene))
    scene.vert_norm = base_scene.vert_norm.copy()
    scene.vert_norm[4] = np.nan  # a vertex of the first torus
    cfg = Config(
        compute=ComputeConfig(bounces=2), resolution=Resolution.sized(48, 32)
    )
    f_p = _frame(scene, "pbvh", cfg=cfg)
    f_n = _frame(scene, "naive", cfg=cfg)
    # assert_allclose treats NaN as equal only where both are NaN.
    np.testing.assert_allclose(f_p, f_n, atol=1e-5)
    assert np.nan_to_num(f_p).sum() > 0
