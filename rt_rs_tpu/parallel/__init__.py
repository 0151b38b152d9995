"""Multi-device scaling: image bands x scene shards over a device mesh.

The reference is strictly single-GPU — its only parallelism is the 2-D
compute dispatch grid (``src/lib/state/mod.rs:704-708``; SURVEY.md §2).
Here SPMD runs over a ``jax.sharding.Mesh`` with up to two axes:

* the **ray/image axis** (``"rays"``) is the data-parallel axis: each
  device row renders a horizontal band of the frame (camera rays are
  generated per band, so no ray data ever moves between devices);
* the **scene axis** (``"scene"``, optional) is the tensor-parallel
  analogue: the flat triangle-chunk table splits evenly across it, each
  device intersects its band's rays against only its shard, and the
  per-call merge is a handful of collectives — ``pmin`` on t (+ a
  lexicographic prim-id tie-break reproducing the sequential
  first-strictly-smaller semantics) and ``psum`` for any-hit
  occlusion.  Scene arrays for SHADING replicate (KBs); only the
  intersection working set shards;
* the remaining per-frame collective is an optional ``pmean`` of
  luminance statistics (exposure metering).

The mesh follows the algorithm alone: on cards joined all to all
(NVLink) no device order is assumed.  Works on any mesh whose rays axis
divides the image height; tested on the 8-device virtual CPU mesh in
both 1-D and 2-D shapes (``tests/test_parallel.py``) and rehearsed by
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from rt_rs_tpu.config import ComputeConfig
from rt_rs_tpu.handlers.base import IntrsHandler
from rt_rs_tpu.ops import shade
from rt_rs_tpu.scene.arrays import SceneArrays

RAY_AXIS = "rays"
SCENE_AXIS = "scene"


def image_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D mesh over the ray/image axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (RAY_AXIS,))


def hybrid_mesh(n_bands: int, n_shards: int) -> Mesh:
    """A 2-D (image bands x scene shards) mesh over the first
    ``n_bands * n_shards`` devices."""
    devices = jax.devices()[: n_bands * n_shards]
    if len(devices) < n_bands * n_shards:
        raise ValueError(
            f"need {n_bands * n_shards} devices, have {len(devices)}"
        )
    return Mesh(
        np.array(devices).reshape(n_bands, n_shards),
        (RAY_AXIS, SCENE_AXIS),
    )


def _make_scene_parallel_fns(
    local,
    cfg: ComputeConfig,
    tris_per_shard: int,
    *,
    refine_mode: str,
    cull_block: int | None,
    loop: str,
):
    """Per-shard intersect fns + cross-shard merges (shard_map body).

    ``local`` is this device's slice of the flat chunk table with
    LOCAL prim ids (1..tris_per_shard).  The global id base is traced
    (``axis_index * tris_per_shard``): exclusion ids shift into local
    space before the tracer, hit ids shift back out after.  Merge: min-t
    wins, ties keep the smallest global prim id (= the earlier
    shard/prim, the naive loop's first-strictly-smaller rule); any-hit
    ORs."""
    from rt_rs_tpu.ops.pallas.packet_trace import (
        packet_closest_hit_tiled,
        tag_refine,
    )

    kwargs: dict[str, Any] = dict(
        t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps, loop=loop
    )
    if cull_block is not None:
        kwargs["cull_block"] = cull_block
    base = partial(packet_closest_hit_tiled, local, **kwargs)

    def shard_base_i32():
        return jax.lax.axis_index(SCENE_AXIS).astype(jnp.int32) * jnp.int32(
            tris_per_shard
        )

    def shift_payload(payload):
        # Exclusion ids (payload row 6) are global; the local tracer
        # compares against local ids.  Ids are exact integers in f32
        # (< 2^24, guarded by the caller), so the shift is exact; ids
        # belonging to other shards land out of local range and match
        # nothing (exactly right).
        return payload.at[6].add(-shard_base_i32().astype(jnp.float32))

    def closest(payload, valid, t_cap=None, refine=False):
        t, pid = base(shift_payload(payload), valid, t_cap, refine=refine)
        pid_g = jnp.where(pid > 0, pid + shard_base_i32(), 0)
        t_g = jax.lax.pmin(t, SCENE_AXIS)
        big = jnp.int32(np.iinfo(np.int32).max)
        cand = jnp.where((t == t_g) & (pid_g > 0), pid_g, big)
        pid_w = jax.lax.pmin(cand, SCENE_AXIS)
        return t_g, jnp.where(pid_w == big, 0, pid_w)

    def anyhit(payload, valid, t_cap=None, refine=False):
        b = base(
            shift_payload(payload), valid, t_cap, any_hit=True, refine=refine
        )
        # Outputs are unspecified for invalid rays — mask before the
        # cross-shard OR.
        b = b & valid
        return jax.lax.psum(b.astype(jnp.int32), SCENE_AXIS) > 0

    return tag_refine(closest, refine_mode), tag_refine(anyhit, refine_mode)


def make_sharded_render(
    handler: IntrsHandler,
    accel: Any,
    arrays: SceneArrays,
    cfg: ComputeConfig,
    width: int,
    height: int,
    mesh: Mesh,
    with_metering: bool = True,
    resolution=None,
):
    """Build a jitted multi-device render step.

    Returns ``fn(camera_pos, camera_at) -> (frame [H, W, 3],
    mean_luminance [])`` with the frame sharded over image bands on
    ``mesh`` and the luminance pmean-reduced across devices.

    Per band the step takes the SAME branches as the single-device
    ``Renderer._render_jit`` (the handler's tiled and any-hit entries).
    ``resolution`` (a :class:`rt_rs_tpu.config.Resolution`) supplies
    the user's ``wg`` pixel-block tuning; default wg=16.

    A mesh with a ``"scene"`` axis additionally shards the triangle
    chunk table across that axis (see the module docstring); this
    requires a packet-table backend (an accel that flattens to
    :class:`TriChunks` — pbvh/lbvh) and the tiled frame path.
    """
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if RAY_AXIS not in axis_sizes:
        raise ValueError(f"mesh must carry a {RAY_AXIS!r} axis")
    n_dev = axis_sizes[RAY_AXIS]
    n_shards = axis_sizes.get(SCENE_AXIS, 1)
    if height % n_dev != 0:
        raise ValueError(
            f"image height {height} must divide over {n_dev} band devices"
        )
    rows_per_dev = height // n_dev
    scene_parallel = n_shards > 1

    ray_tile = getattr(handler, "block_lanes", 128)
    use_tiled = arrays.no_negative_materials
    flat_tbl = None
    if scene_parallel:
        from rt_rs_tpu.ops.pallas.packet_trace import TriChunks, flat_table

        if not use_tiled:
            raise ValueError(
                "scene-parallel rendering requires the tiled frame path "
                "(no negative materials)"
            )
        # The flat chunk table, padded with never-hit chunks at the
        # tail so every shard gets an equal slice (each a cull_block
        # multiple — the tracer's only chunk-count requirement).
        cull_block = getattr(handler, "cull_block", None)
        flat_tbl = flat_table(accel, pad_multiple=n_shards * (cull_block or 1))
        nc_local = flat_tbl.num_chunks // n_shards
        tris_per_shard = nc_local * flat_tbl.tri_chunk
        if tris_per_shard * n_shards + 1 >= 1 << 24:
            raise ValueError(
                "prim ids exceed f32 exact-integer range (2^24)"
            )
        refine_mode = getattr(handler, "refine", "off")
    elif use_tiled:
        intersect_t = handler.intersect_tiled_fn(accel, arrays, cfg)
        anyhit_t = handler.intersect_tiled_anyhit_fn(accel, arrays, cfg)
    else:
        intersect = handler.intersect_fn(accel, arrays, cfg)

    # Pixel-block packet order within each device's band (bit-identical
    # output, tighter packet frusta; see shade.camera_rays), sized to
    # the handler's rays-per-tile, honoring the caller's wg hint.
    from rt_rs_tpu.config import Resolution

    blk = (resolution or Resolution()).block(ray_tile)

    def band_render(row0, camera_pos, camera_at, *tbl_args):
        # row0: [1] per-device band start (sharded scalar).
        if use_tiled:
            if scene_parallel:
                # tbl_args[0] is this device's chunk-table slice; its
                # static num_chunks still reads the global count.
                local = dataclasses.replace(
                    tbl_args[0], num_chunks=nc_local
                )
                i_fn, a_fn = _make_scene_parallel_fns(
                    local, cfg, tris_per_shard,
                    refine_mode=refine_mode, cull_block=cull_block,
                    loop=getattr(handler, "loop", "kernel"),
                )
            else:
                i_fn, a_fn = intersect_t, anyhit_t
            payload, valid, n_pixels = shade.camera_ray_tiles(
                camera_pos, camera_at, width, height, ray_tile,
                y_offset=row0[0], rows=rows_per_dev, block=blk,
            )
            color = shade.trace_tiled(
                arrays, i_fn, cfg, payload, valid, camera_pos,
                intersect_anyhit_fn=a_fn,
            )
            flat = color.reshape(3, -1)[:, :n_pixels].T
            band = shade.unblock_colors(flat, width, rows_per_dev, blk)
        else:
            o, d = shade.camera_rays(
                camera_pos, camera_at, width, height,
                y_offset=row0[0], rows=rows_per_dev, block=blk,
            )
            color = shade.trace(arrays, intersect, cfg, o, d)
            band = shade.unblock_colors(color, width, rows_per_dev, blk)
        if with_metering:
            # Cross-device collective: global mean luminance for
            # exposure metering (full f32: no TF32 rounding on GPUs).
            lum = jnp.mean(
                jnp.dot(
                    band,
                    jnp.array([0.2126, 0.7152, 0.0722], jnp.float32),
                    precision="highest",
                )
            )
            lum = jax.lax.pmean(lum, RAY_AXIS)
        else:
            lum = jnp.float32(0.0)
        return band, lum

    in_specs = [P(RAY_AXIS), P(), P()]
    call_extra = ()
    if scene_parallel:
        # Split the chunk table's chunk axis across the scene shards
        # (columns of comp, rows of the bounds); static metadata
        # (num_chunks) rides along unsplit.
        in_specs.append(
            TriChunks(
                comp=P(None, SCENE_AXIS),
                bmin=P(SCENE_AXIS),
                bmax=P(SCENE_AXIS),
                num_chunks=flat_tbl.num_chunks,
            )
        )
        call_extra = (flat_tbl,)
    sharded = shard_map(
        band_render,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(RAY_AXIS), P()),
        # pallas_call out_shapes carry no varying-mesh-axes metadata;
        # skip the vma check (specs above are the contract).
        check_vma=False,
    )

    row0 = jnp.arange(n_dev, dtype=jnp.int32) * rows_per_dev

    @jax.jit
    def render(camera_pos, camera_at):
        frame, lum = sharded(row0, camera_pos, camera_at, *call_extra)
        return frame, lum[0] if lum.ndim else lum

    return render


def sharded_render_scene(
    scene,
    handler: IntrsHandler,
    cfg: ComputeConfig,
    width: int,
    height: int,
    mesh: Mesh | None = None,
):
    """Convenience: pack + build + sharded render of one frame."""
    mesh = mesh or image_mesh()
    arrays = scene.pack()
    accel, arrays = handler.build(scene, arrays)
    fn = make_sharded_render(
        handler, accel, arrays, cfg, width, height, mesh
    )
    frame, lum = fn(
        jnp.asarray(scene.camera.pos, jnp.float32),
        jnp.asarray(scene.camera.at, jnp.float32),
    )
    return frame, lum
