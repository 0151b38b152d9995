"""The frame engine — the reference's ``State`` + event-loop analogue.

The reference's ``State`` owns wgpu device/queue, builds bind groups and
pipelines, and dispatches one compute pass per frame
(``src/lib/state/mod.rs:191-743``, loop in ``src/lib/mod.rs:203-424``).
In JAX there is no pipeline/bind-group machinery to manage: ``Renderer``
packs the scene once, lets the handler build its acceleration arrays,
and compiles ONE jitted function that turns (camera, scene arrays,
accel) into a frame.  Per-frame "uniform updates" (camera orbit, config
changes) are just new arguments; XLA caches the executable per static
config (the codegen-splice equivalent of ``shaders/mod.rs:31-83``).

There is no swapchain: frames come back as numpy images (headless PNG /
animation writing — the render.wgsl blit has no meaning here).  The
interactive path lives in :mod:`rt_rs_tpu.web`.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from rt_rs_tpu.config import ComputeConfig, Config
from rt_rs_tpu.handlers import get_handler
from rt_rs_tpu.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu.ops import shade
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.scene.arrays import SceneArrays
from rt_rs_tpu.utils.sync import device_sync

# Chunk height for per-frame (dynamic) accel builds.
DYNAMIC_TRI_CHUNK = 64


def retile_default(n_pixels: int) -> bool:
    """Default for the between-bounce live-tile compaction
    (``shade.trace_tiled(retile=)``): off at every size."""
    return False


# Packet rays are generated in pixel-block order (shade.camera_rays
# block=): a packet tile covers a compact 2-D pixel block instead of a
# raster strip.  Output is bit-identical; tile frusta (and secondary-
# packet origin bounds) tighten, so chunk culling sheds real work.
# The shape comes from Resolution.block(handler.block_lanes); see
# Renderer.__init__.


def _orbit_f32(pos: jax.Array, at: jax.Array, mult) -> jax.Array:
    """In-graph f32 twin of ``CameraUniform.orbited`` (camera.rs:
    177-189; host math is f64) — used by ``Renderer.animate(chain=)``
    to advance the orbit between chained frames inside one dispatch."""
    from rt_rs_tpu.scene.camera import ORBIT_RATE

    x = pos[0] - at[0]
    z = pos[2] - at[2]
    theta = jnp.arctan2(z, x) + ORBIT_RATE * mult
    r = jnp.sqrt(x * x + z * z)
    return jnp.stack(
        [at[0] + r * jnp.cos(theta), pos[1], at[2] + r * jnp.sin(theta)]
    )


@partial(
    jax.jit,
    static_argnames=(
        "handler", "cfg", "width", "height", "block", "shadow_cull",
        "retile", "narrow",
    ),
)
def _render_jit(
    arrays: SceneArrays,
    accel: Any,
    camera_pos: jax.Array,
    camera_at: jax.Array,
    *,
    handler: IntrsHandler,
    cfg: ComputeConfig,
    width: int,
    height: int,
    block: tuple[int, int] | None,
    shadow_cull: bool = True,
    retile: bool = False,
    narrow: int | None = None,
) -> jax.Array:
    if arrays.no_negative_materials:
        # Tiled frame path: rays stay in the packet tracer's
        # component-major layout end to end.
        return shade.render_tiled(
            arrays,
            handler.intersect_tiled_fn(accel, arrays, cfg),
            cfg,
            camera_pos,
            camera_at,
            width,
            height,
            ray_tile=getattr(handler, "block_lanes", 128),
            block=block,
            intersect_anyhit_fn=handler.intersect_tiled_anyhit_fn(
                accel, arrays, cfg
            ),
            shadow_cull=shadow_cull,
            retile=retile,
            narrow=narrow,
        )
    # Scenes with real negative-material prims need the gather-based
    # shadow validity check — the XLA reference path.
    intersect = handler.intersect_fn(accel, arrays, cfg)
    return shade.render(
        arrays, intersect, cfg, camera_pos, camera_at, width, height,
        block=block,
    )


class Renderer:
    """Owns packed scene + accel arrays and the compiled frame fn."""

    def __init__(
        self,
        scene: Scene,
        config: Config | None = None,
        handler: str | IntrsHandler = "bvh",
        handler_kwargs: dict[str, Any] | None = None,
        size: tuple[int, int] | None = None,
        block: tuple[int, int] | None | str = "auto",
        shadow_cull: bool = True,
        retile: bool | None = None,
        narrow: int | None = None,
    ):
        """``shadow_cull=False`` disables the zero-contribution
        shadow-ray cull (output-exact either way — shade.trace_tiled);
        ``retile`` packs live ray tiles to the front between bounces
        (output-exact, see shade.trace_tiled; None = the default);
        ``narrow`` splits secondary ray tiles (shade.trace_tiled)."""
        self.scene = scene
        self.shadow_cull = shadow_cull
        self.retile = retile
        self.narrow = narrow
        self._chain_cache: dict[int, Any] = {}
        self.config = config or Config()
        if isinstance(handler, IntrsHandler):
            self.handler = handler
        else:
            self.handler = get_handler(handler, **(handler_kwargs or {}))
        # "auto" derives the packet pixel-block from the config's
        # workgroup hint (Resolution.block(), the reference's wg()
        # analogue) sized to the handler's rays-per-tile — 16x16 for
        # the 256-ray default, (8, 16) for 128-ray tiles.
        if block == "auto":
            lanes = getattr(self.handler, "block_lanes", 128)
            self.block = self.config.resolution.block(lanes)
        else:
            self.block = block

        self.width, self.height = (
            size if size is not None else self.config.resolution.size()
        )

        arrays = scene.pack()
        self.accel, self.arrays = self.handler.build(scene, arrays)
        self.stats: IntrsStats = self.handler.stats(self.accel)

        self.camera = scene.camera
        self.camera_controller = scene.camera_controller
        if tuple(self.camera.pos) == tuple(self.camera.at) and not getattr(
            scene, "is_unloaded", False
        ):
            # (The unloaded placeholder scene renders black regardless —
            # its NaN rays all miss the degenerate prim — so no warning.)
            # pos == at normalizes a zero vector into NaN ray
            # directions; NaNs defeat conservative culling, so frames
            # are both garbage AND much slower.
            import warnings

            warnings.warn(
                "camera pos == at: ray directions will be NaN "
                "(the reference renders garbage here too); set a "
                "real camera on the scene",
                stacklevel=2,
            )

    # ------------------------------------------------------------------

    def render_frame(self, block: bool = True) -> jax.Array:
        """Render one frame -> [H, W, 3] float32 device array."""
        out = _render_jit(
            self.arrays,
            self.accel,
            jnp.asarray(self.camera.pos, dtype=jnp.float32),
            jnp.asarray(self.camera.at, dtype=jnp.float32),
            handler=self.handler,
            cfg=self.config.compute,
            width=self.width,
            height=self.height,
            block=self.block,
            shadow_cull=self.shadow_cull,
            narrow=self.narrow,
            retile=(
                retile_default(self.width * self.height)
                if self.retile is None
                else self.retile
            ),
        )
        if block:
            device_sync(out)
        return out

    def render_image(self) -> np.ndarray:
        """One frame as uint8 RGB (the rgba8unorm store,
        compute.wgsl:291: clamp to [0,1], round to 8 bits)."""
        # block=False: np.asarray is itself the fence.
        frame = np.asarray(self.render_frame(block=False))
        return np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)

    def orbit(self, mult: float) -> None:
        """Advance the orbit camera by ``0.0314 * mult`` radians
        (camera.rs:177-189)."""
        self.camera = self.camera.orbited(mult)

    def update_config(self, compute: ComputeConfig) -> None:
        """Live compute-config swap (``State::update_config``,
        state/mod.rs:731-743).  Changing static fields recompiles."""
        self.config = Config(
            compute=compute, resolution=self.config.resolution, fps=self.config.fps
        )

    def animate(
        self,
        frames: int,
        orbit_mult: float = 1.0,
        on_frame: Callable[[int, np.ndarray, float], None] | None = None,
        sync_every: int = 20,
        chain: int | None = None,
    ) -> list[float]:
        """Render ``frames`` orbit steps; returns per-frame seconds.

        This is the study's benchmark protocol driver: N frames averaged
        over camera orbit rotations (pdf p.19 §4.2).

        Timing syncs the device every ``sync_every`` frames and
        amortizes the elapsed time over the chained frames, so the
        host's per-frame dispatch overlaps device work the way the
        reference's timestamp queries see it (timing.rs:221-300).
        ``sync_every=1`` recovers strict per-frame latency measurement.
        Unsynced frames stay live on the device, so memory holds
        ``sync_every`` frames (~24 MB each at 1080p).

        ``chain`` (e.g. 16) renders that many frames per DISPATCH with
        the orbit advanced in-graph, amortizing the per-dispatch host
        cost at small frame sizes.  The in-graph orbit is the f32 twin
        of ``CameraUniform.orbited`` (f64 host math), so chained frames
        1..k-1 see a camera a few ULP off the host loop's; the host
        camera is re-synced exactly every dispatch, bounding the drift
        to one chain."""
        if chain is not None and chain > 1:
            return self._animate_chained(
                frames, orbit_mult, on_frame, sync_every, chain
            )
        return _animate_loop(
            lambda i: self.render_frame(block=False),
            self.orbit, frames, orbit_mult, on_frame, sync_every,
        )

    def _chained_fn(self, k: int):
        """jit a k-frame render graph (one dispatch, orbit in-graph)."""
        cached = self._chain_cache.get(k)
        if cached is not None:
            return cached
        kw = dict(
            handler=self.handler, cfg=self.config.compute,
            width=self.width, height=self.height, block=self.block,
            shadow_cull=self.shadow_cull, narrow=self.narrow,
            retile=(
                retile_default(self.width * self.height)
                if self.retile is None
                else self.retile
            ),
        )

        @jax.jit
        def chained(arrays, accel, pos, at, mult):
            outs = []
            for _ in range(k):
                outs.append(_render_jit(arrays, accel, pos, at, **kw))
                pos = _orbit_f32(pos, at, mult)
            return jnp.stack(outs), pos

        self._chain_cache[k] = chained
        return chained

    def _animate_chained(
        self, frames, orbit_mult, on_frame, sync_every, k
    ) -> list[float]:
        mult = jnp.float32(orbit_mult)
        at = jnp.asarray(self.camera.at, jnp.float32)
        times: list[float] = []
        pending: list[jax.Array] = []  # stacked [k', H, W, 3] batches
        done = 0
        t0 = time.perf_counter()
        while done < frames:
            fn = self._chained_fn(k)
            pos = jnp.asarray(self.camera.pos, jnp.float32)
            stacked, _ = fn(self.arrays, self.accel, pos, at, mult)
            m = min(k, frames - done)
            pending.append(stacked[:m])
            # Host camera stays canonical (f64 orbit math): re-sync it
            # for the consumed frames so in-graph f32 drift never
            # crosses a dispatch boundary.
            for _ in range(m):
                self.orbit(orbit_mult)
            done += m
            n_pend = sum(p.shape[0] for p in pending)
            if n_pend >= sync_every or done >= frames:
                device_sync(stacked)
                dt = (time.perf_counter() - t0) / n_pend
                times.extend([dt] * n_pend)
                if on_frame is not None:
                    base = done - n_pend
                    i = 0
                    for p in pending:
                        for j in range(p.shape[0]):
                            on_frame(base + i, p[j], dt)
                            i += 1
                pending = []
                t0 = time.perf_counter()
        return times


def _animate_loop(
    render_one: Callable[[int], jax.Array],
    orbit: Callable[[float], None],
    frames: int,
    orbit_mult: float,
    on_frame: Callable[[int, jax.Array, float], None] | None,
    sync_every: int,
) -> list[float]:
    """The shared animate/benchmark frame loop (see Renderer.animate
    for the sync-cadence rationale)."""
    times: list[float] = []
    pending: list[jax.Array] = []
    t0 = time.perf_counter()
    for i in range(frames):
        frame = render_one(i)
        pending.append(frame)
        if len(pending) >= sync_every or i == frames - 1:
            device_sync(frame)
            dt = (time.perf_counter() - t0) / len(pending)
            times.extend([dt] * len(pending))
            if on_frame is not None:
                # Device arrays on purpose: converting every frame
                # to numpy would drag full images through the host
                # link inside the timed loop; callbacks that want
                # pixels call np.asarray themselves.
                base = i + 1 - len(pending)
                for j, f in enumerate(pending):
                    on_frame(base + j, f, dt)
            pending = []
            t0 = time.perf_counter()
        orbit(orbit_mult)
    return times


class DynamicRenderer:
    """Animated-geometry rendering with per-frame on-device rebuild.

    The whole frame step — corner gathers from the new vertex
    positions, LBVH Morton sort + chunking, packet tracing, shading —
    is ONE jitted function of the vertex array, so a dynamic scene
    stays on-chip end to end (the BASELINE.json "animated teapot with
    per-frame BVH refit" config).
    """

    def __init__(
        self,
        scene: Scene,
        config: Config | None = None,
        size: tuple[int, int] | None = None,
        refit: bool = False,
        tri_chunk: int | None = None,
        refine: bool = True,
    ):
        """``tri_chunk`` overrides the chunk height (refit mode may
        prefer smaller chunks when the geometry drifts far from the
        rest pose, since stale Morton order loosens big-chunk bounds).

        ``refit=True`` freezes the Morton order at the rest pose and
        per-frame steps only recompute chunk bounds — a true
        refit-without-resort.  A stale order only loosens culling
        (bounds are recomputed from the CURRENT vertices, so results
        stay exact); re-create the renderer if the geometry drifts far
        from the rest pose.  ``refine=False`` turns off the per-ray
        cull of bounce/shadow batches."""
        import dataclasses as _dc

        from rt_rs_tpu.handlers.lbvh import build_accel_device
        from rt_rs_tpu.handlers.pbvh import DEFAULT_RAY_TILE
        from rt_rs_tpu.ops.pallas.packet_trace import (
            build_tri_chunks,
            packet_closest_hit,
            packet_closest_hit_tiled,
        )

        self.scene = scene
        self.config = config or Config()
        self.width, self.height = (
            size if size is not None else self.config.resolution.size()
        )
        self.camera = scene.camera

        base = scene.pack()
        # Same duplicate-triple collapse the static pack applies
        # (scene/arrays.py intersect_indices): topology is static, so
        # the per-frame corner gathers below inherit the reference's
        # triple-based self-exclusion semantics at zero cost.
        from rt_rs_tpu.scene.arrays import intersect_indices

        prim_idx = jnp.asarray(
            intersect_indices(scene.prim_indices).astype(np.int32)
        )
        if refit:
            # One-time sort at the rest pose; bake the permutation into
            # prim_idx/prim_mat so frame steps skip sort + 8-array
            # permute entirely.
            from rt_rs_tpu.ops.lbvh import morton_codes, morton_order

            a, b, c = base.pa[1:], base.pb[1:], base.pc[1:]
            cent = (a + b + c) * jnp.float32(1.0 / 3.0)
            lo = jnp.min(jnp.minimum(jnp.minimum(a, b), c), axis=0)
            hi = jnp.max(jnp.maximum(jnp.maximum(a, b), c), axis=0)
            order = morton_order(morton_codes(cent, lo, hi))
            prim_idx = prim_idx[order]
            perm = jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), order.astype(jnp.int32) + 1]
            )
            base = _dc.replace(base, prim_mat=base.prim_mat[perm])
        cfg = self.config.compute
        width, height = self.width, self.height
        # ONE effective chunk height for every build (the step body
        # closes over this value).
        tc = DYNAMIC_TRI_CHUNK if tri_chunk is None else tri_chunk

        def step(vert_pos, vert_norm, camera_pos, camera_at):
            def corner(arr, c):
                rows = arr[prim_idx[:, c]]
                return jnp.concatenate(
                    [jnp.zeros((1, 3), jnp.float32), rows], axis=0
                )

            arrays = _dc.replace(
                base,
                pa=corner(vert_pos, 0),
                pb=corner(vert_pos, 1),
                pc=corner(vert_pos, 2),
                na=corner(vert_norm, 0),
                nb=corner(vert_norm, 1),
                nc=corner(vert_norm, 2),
            ).rebuild_shade_table()
            if refit:
                accel = build_tri_chunks(
                    arrays.pa, arrays.pb, arrays.pc, tri_chunk=tc
                )
            else:
                accel, arrays = build_accel_device(arrays, tri_chunk=tc)
            blk = self.config.resolution.block(DEFAULT_RAY_TILE)
            window = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
            if arrays.no_negative_materials:
                kern = partial(packet_closest_hit_tiled, accel, **window)
                # Per-ray cull refinement on bounce/shadow batches
                # (trace_tiled keys off this tag).
                kern.supports_refine = refine
                anyhit = partial(kern, any_hit=True)
                anyhit.supports_refine = refine
                return shade.render_tiled(
                    arrays, kern, cfg, camera_pos, camera_at,
                    width, height,
                    ray_tile=DEFAULT_RAY_TILE, block=blk,
                    intersect_anyhit_fn=anyhit,
                )
            # Real negative-material prims need the gather-based shadow
            # validity check — the XLA reference path.
            intersect = partial(
                packet_closest_hit, accel, ray_tile=DEFAULT_RAY_TILE, **window
            )
            return shade.render(
                arrays, intersect, cfg, camera_pos, camera_at,
                width, height, block=blk,
            )

        self._step = jax.jit(step)
        self._step_body = step  # unjitted: chained dispatch traces it
        self._chain_cache: dict[int, Any] = {}
        # Renderer-parity surface state (orbit/animate/stats).
        self._rest_arrays = base
        self._tri_chunk = tc
        self._refit = refit
        self._stats: IntrsStats | None = None

    # ------------------------------------------------------------------
    # Renderer-parity surface: orbit/animate/render_image/stats make the
    # dynamic path drive the same benchmark protocol as the static one
    # (timing.run_benchmark_protocol; the reference's event-loop pacing,
    # src/lib/mod.rs:324-417).

    @property
    def stats(self) -> IntrsStats:
        """Chunk-table byte footprint at the rest pose (IntrsStats
        analogue, handlers/mod.rs:47-50).  Shapes are static across
        frames, so the rest-pose build's footprint is THE footprint."""
        if self._stats is None:
            from rt_rs_tpu.ops.pallas.packet_trace import (
                build_tri_chunks,
                chunk_footprint,
            )

            base = self._rest_arrays
            accel = build_tri_chunks(
                base.pa, base.pb, base.pc, tri_chunk=self._tri_chunk
            )
            self._stats = IntrsStats(
                name=f"LBVH-{'refit' if self._refit else 'rebuild'}",
                size=chunk_footprint(accel),
            )
        return self._stats

    def orbit(self, mult: float) -> None:
        """Advance the orbit camera by ``0.0314 * mult`` radians
        (camera.rs:177-189)."""
        self.camera = self.camera.orbited(mult)

    def render_image(self, vert_pos=None, vert_norm=None) -> np.ndarray:
        """One frame as uint8 RGB (see Renderer.render_image)."""
        frame = np.asarray(
            self.render_frame(vert_pos, vert_norm, block=False)
        )
        return np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)

    def animate(
        self,
        frames: int,
        orbit_mult: float = 1.0,
        on_frame: Callable[[int, np.ndarray, float], None] | None = None,
        sync_every: int = 20,
        vertex_fn: Callable[[int], Any] | None = None,
        chain: int | None = None,
    ) -> list[float]:
        """Render ``frames`` orbit steps with per-frame rebuild/refit;
        returns per-frame seconds (sync cadence as Renderer.animate).

        ``vertex_fn(i)`` supplies frame ``i``'s geometry as
        ``vert_pos`` or ``(vert_pos, vert_norm)``; default is the rest
        pose (the accel rebuild still runs every frame — BASELINE
        config 5's cost profile).

        ``chain`` (e.g. 16) renders that many frames per DISPATCH, the
        dynamic twin of ``Renderer.animate(chain=)``: the host stacks
        the chain's vertex arrays to ``[k, V, 3]`` (KBs/frame — cheap
        against the per-dispatch host cost it amortizes) and ONE
        jitted graph runs the k rebuild+trace steps with the orbit
        advanced in-graph (f32 twin; the host camera is re-synced
        every dispatch, same drift contract as the static chain —
        tests/test_chain.py)."""
        if chain is not None and chain > 1:
            return self._animate_chained(
                frames, orbit_mult, on_frame, sync_every, chain,
                vertex_fn,
            )

        def render_one(i: int) -> jax.Array:
            v = vertex_fn(i) if vertex_fn is not None else None
            vp, vn = v if isinstance(v, tuple) else (v, None)
            return self.render_frame(vp, vn, block=False)

        return _animate_loop(
            render_one, self.orbit, frames, orbit_mult, on_frame,
            sync_every,
        )

    def _chained_fn(self, k: int):
        """jit a k-frame dynamic graph: k (rebuild/refit + trace)
        steps per dispatch over stacked [k, V, 3] vertices, orbit
        advanced in-graph (see Renderer._chained_fn)."""
        cached = self._chain_cache.get(k)
        if cached is not None:
            return cached
        step = self._step_body

        @jax.jit
        def chained(vp, vn, pos, at, mult):
            outs = []
            for i in range(k):
                outs.append(step(vp[i], vn[i], pos, at))
                pos = _orbit_f32(pos, at, mult)
            return jnp.stack(outs), pos

        self._chain_cache[k] = chained
        return chained

    def _animate_chained(
        self, frames, orbit_mult, on_frame, sync_every, k, vertex_fn
    ) -> list[float]:
        fn = self._chained_fn(k)
        rest_vp = np.asarray(self.scene.vert_pos, np.float32)
        rest_vn = np.asarray(self.scene.vert_norm, np.float32)

        def frame_verts(i: int) -> tuple[np.ndarray, np.ndarray]:
            v = vertex_fn(i) if vertex_fn is not None else None
            vp, vn = v if isinstance(v, tuple) else (v, None)
            return (
                rest_vp if vp is None else np.asarray(vp, np.float32),
                rest_vn if vn is None else np.asarray(vn, np.float32),
            )

        mult = jnp.float32(orbit_mult)
        at = jnp.asarray(self.camera.at, jnp.float32)
        times: list[float] = []
        pending: list[jax.Array] = []
        done = 0
        t0 = time.perf_counter()
        while done < frames:
            # Partial final chain: overflow slots re-render the last
            # frame's geometry (discarded) — vertex_fn is never called
            # with an out-of-range index.
            pairs = [
                frame_verts(min(done + i, frames - 1)) for i in range(k)
            ]
            vp = np.stack([p[0] for p in pairs])
            vn = np.stack([p[1] for p in pairs])
            pos = jnp.asarray(self.camera.pos, jnp.float32)
            stacked, _ = fn(
                jnp.asarray(vp), jnp.asarray(vn), pos, at, mult
            )
            m = min(k, frames - done)
            pending.append(stacked[:m])
            for _ in range(m):
                self.orbit(orbit_mult)
            done += m
            n_pend = sum(p.shape[0] for p in pending)
            if n_pend >= sync_every or done >= frames:
                device_sync(stacked)
                dt = (time.perf_counter() - t0) / n_pend
                times.extend([dt] * n_pend)
                if on_frame is not None:
                    base = done - n_pend
                    i = 0
                    for p in pending:
                        for j in range(p.shape[0]):
                            on_frame(base + i, p[j], dt)
                            i += 1
                pending = []
                t0 = time.perf_counter()
        return times

    def render_frame(
        self, vert_pos=None, vert_norm=None, block: bool = True
    ) -> jax.Array:
        """Render one frame of the given geometry (rest pose when
        ``vert_pos`` is None) -> [H, W, 3] float32 device array."""
        if vert_pos is None:
            vert_pos = self.scene.vert_pos
        if vert_norm is None:
            vert_norm = self.scene.vert_norm
        out = self._step(
            jnp.asarray(vert_pos, jnp.float32),
            jnp.asarray(vert_norm, jnp.float32),
            jnp.asarray(self.camera.pos, jnp.float32),
            jnp.asarray(self.camera.at, jnp.float32),
        )
        if block:
            device_sync(out)
        return out


def run_headless(
    scene_path: str,
    handler: str = "bvh",
    handler_kwargs: dict[str, Any] | None = None,
    config: Config | None = None,
    size: tuple[int, int] | None = None,
    frames: int = 1,
    out_path: str | None = None,
) -> Renderer:
    """Load a scene JSON and render; the ``demo`` binary analogue
    (``src/demo.rs``)."""
    scene = Scene.load(scene_path)
    renderer = Renderer(
        scene,
        config=config,
        handler=handler,
        handler_kwargs=handler_kwargs,
        size=size,
    )
    image = None
    for _ in range(frames):
        image = renderer.render_image()
        renderer.orbit(1.0)
    if out_path is not None and image is not None:
        from rt_rs_tpu.utils.image import write_png

        write_png(out_path, image)
    return renderer
