"""Full-featured runner — parity with ``src/tools/load.rs``.

Handler flags mirror the reference exactly (load.rs:148-192):

* ``--handler-naive``
* ``--handler-bvh [EPS | PATH]`` — bare = defaults; a float = runtime
  eps; anything else = path to a precomputed ``*.bvh.json``
* ``--handler-bvh-rf [EPS]``
* *no handler flag* = the Blank (no-op) baseline, like the reference
* ``--handler-pbvh [EPS]`` — the packet tracer backend (addition)

Headless additions (no winit window on an accelerator host): ``--frames N``
renders N orbit-stepped frames, ``--out`` writes the last frame as PNG,
``--benchmark`` runs the study protocol and writes ``benchmark.png``
(BenchScheduler parity).
"""

from __future__ import annotations

import argparse
import os

from rt_rs_tpu.config import ComputeConfig, Config, Resolution


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="load", description=__doc__)
    p.add_argument(
        "--path", default=None,
        help="scene JSON (default: the generated base scene, seed 0)",
    )
    p.add_argument("--handler-naive", action="store_true")
    p.add_argument("--handler-bvh", nargs="*", default=None,
                   metavar="EPS|PATH")
    p.add_argument("--handler-bvh-rf", nargs="*", type=float, default=None,
                   metavar="EPS")
    p.add_argument("--handler-pbvh", nargs="*", default=None,
                   metavar="EPS")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--width", "-w", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--workgroup-size", type=int)
    p.add_argument("--fps", type=int)
    p.add_argument("--bounces", type=int)
    p.add_argument("--camera-light-strength", type=float)
    p.add_argument("--ambience", type=float)
    # Headless extensions
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", default=None, help="PNG path for the last frame")
    p.add_argument("--bench-frames", type=int, default=200)
    p.add_argument(
        "--gif", default=None, metavar="PATH",
        help="render one full camera orbit as an animated GIF",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the run into DIR "
        "(the GPU-timestamp-query analogue, SURVEY §5)",
    )
    # Multi-chip surface (parallel.make_sharded_render; no reference
    # counterpart — the reference is single-GPU, its only parallelism
    # is the dispatch grid, state/mod.rs:704-708).
    p.add_argument(
        "--bands", type=int, default=None, metavar="N",
        help="shard the image over N devices (data-parallel rows axis)",
    )
    p.add_argument(
        "--shards", type=int, default=None, metavar="M",
        help="additionally shard the triangle chunk table over M "
        "devices per band (scene-parallel axis; needs a packet-table "
        "handler, e.g. --handler-pbvh)",
    )
    # Dynamic-geometry surface (renderer.DynamicRenderer; BASELINE
    # config 5 "animated teapot with per-frame refit").
    p.add_argument(
        "--dynamic", action="store_true",
        help="per-frame on-device accel REBUILD of animated geometry "
        "(1%%-amplitude vertex wobble over the orbit)",
    )
    p.add_argument(
        "--refit", action="store_true",
        help="like --dynamic but refit-only: Morton order frozen at "
        "the rest pose, per-frame bounds recompute (implies --dynamic)",
    )
    return p


def pick_handler(args) -> tuple[str, dict]:
    if args.handler_naive:
        return "naive", {}
    if args.handler_bvh is not None:
        if len(args.handler_bvh) == 0:
            return "bvh", {}
        arg = args.handler_bvh[0]
        try:
            return "bvh", {"eps": float(arg)}
        except ValueError:
            if os.path.exists(arg):
                return "bvh", {"path": arg}
            raise SystemExit(
                "--handler-bvh requires either:\n"
                "  - The path to a precomputed BVH file\n"
                "  - An epsilon value (f32)"
            )
    if args.handler_bvh_rf is not None:
        if len(args.handler_bvh_rf) == 0:
            return "rf_bvh", {}
        return "rf_bvh", {"eps": args.handler_bvh_rf[0]}
    if args.handler_pbvh is not None:
        if len(args.handler_pbvh) == 0:
            return "pbvh", {}
        try:
            return "pbvh", {"eps": float(args.handler_pbvh[0])}
        except ValueError:
            raise SystemExit(
                "--handler-pbvh takes an optional epsilon value (f32)"
            )
    return "blank", {}  # reference default (load.rs:189-192)


def make_dynamic(args, config):
    """--dynamic/--refit: the per-frame rebuild/refit engine
    (BASELINE config 5 as a CLI call)."""
    from rt_rs_tpu.renderer import DynamicRenderer
    from rt_rs_tpu.scene import Scene

    return DynamicRenderer(
        Scene.load(args.path), config=config, refit=args.refit
    )


def dynamic_wobble(scene):
    """1%-amplitude breathing of the rest pose (the dynamic benchmark
    deformation)."""
    import math

    import numpy as np

    rest = scene.vert_pos.astype(np.float32)

    def fn(i: int):
        return rest * np.float32(1.0 + 0.01 * math.sin(i * 0.3))

    return fn


def run_sharded(args, config, handler_name: str, handler_kwargs: dict) -> int:
    """--bands/--shards: multi-device rendering over a device mesh
    (parallel.make_sharded_render; bands = data-parallel image rows,
    shards = scene-parallel chunk-table slices)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rt_rs_tpu.handlers import get_handler
    from rt_rs_tpu.parallel import (
        hybrid_mesh,
        image_mesh,
        make_sharded_render,
    )
    from rt_rs_tpu.scene import Scene
    from rt_rs_tpu.utils.image import write_png
    from rt_rs_tpu.utils.sync import device_sync

    bands = args.bands or 1
    shards = args.shards or 1
    if bands * shards > len(jax.devices()):
        raise SystemExit(
            f"--bands {bands} x --shards {shards} needs "
            f"{bands * shards} devices; jax sees {len(jax.devices())} "
            "(for CPU testing set "
            "XLA_FLAGS=--xla_force_host_platform_device_count=N)"
        )
    mesh = hybrid_mesh(bands, shards) if shards > 1 else image_mesh(bands)

    scene = Scene.load(args.path)
    width, height = config.resolution.size()
    handler = get_handler(handler_name, **handler_kwargs)
    arrays = scene.pack()
    accel, arrays = handler.build(scene, arrays)
    stats = handler.stats(accel)
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    print(f"handler: {stats.name} ({stats.size} B) on mesh {shape}")

    fn = make_sharded_render(
        handler, accel, arrays, config.compute, width, height, mesh,
        resolution=config.resolution,
    )
    camera = scene.camera
    frame = lum = None
    t0 = time.perf_counter()
    for _ in range(args.frames):
        frame, lum = fn(
            jnp.asarray(camera.pos, jnp.float32),
            jnp.asarray(camera.at, jnp.float32),
        )
        camera = camera.orbited(1.0)
    device_sync(frame)
    dt = (time.perf_counter() - t0) / max(args.frames, 1) * 1e3
    print(
        f"{args.frames} frames, {dt:.2f} ms/frame (incl. compile), "
        f"mean luminance {float(lum):.4f}"
    )
    if args.out and frame is not None:
        img = np.round(np.clip(np.asarray(frame), 0.0, 1.0) * 255.0)
        write_png(args.out, img.astype(np.uint8))
        print(f"wrote {args.out}")
    return 0


def main(argv: list[str] | None = None) -> int:
    import contextlib

    import numpy as np

    from rt_rs_tpu.renderer import Renderer
    from rt_rs_tpu.scene import Scene
    from rt_rs_tpu.utils.cache import enable_compile_cache
    from rt_rs_tpu.utils.image import write_png
    from rt_rs_tpu.utils.log import init_logging

    init_logging()
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    if args.path is None:
        from rt_rs_tpu.scene.procedural import base_scene_path

        args.path = base_scene_path()

    # Resolution forms (load.rs:117-128).
    if args.width and args.height and args.workgroup_size:
        res = Resolution.fixed(args.width, args.height, args.workgroup_size)
    elif args.width and args.height:
        res = Resolution.sized(args.width, args.height)
    elif args.workgroup_size:
        res = Resolution.dynamic(args.workgroup_size)
    else:
        res = Resolution()

    defaults = ComputeConfig()
    compute = ComputeConfig(
        bounces=args.bounces if args.bounces is not None else defaults.bounces,
        camera_light_source=(
            args.camera_light_strength
            if args.camera_light_strength is not None
            else defaults.camera_light_source
        ),
        ambience=args.ambience if args.ambience is not None else defaults.ambience,
    )
    config = Config(
        compute=compute, resolution=res, fps=args.fps if args.fps else 60
    )

    handler, kwargs = pick_handler(args)

    if args.bands or args.shards:
        return run_sharded(args, config, handler, kwargs)

    if args.dynamic or args.refit:
        renderer = make_dynamic(args, config)
    else:
        renderer = Renderer(
            Scene.load(args.path), config=config, handler=handler,
            handler_kwargs=kwargs,
        )
    print(f"handler: {renderer.stats.name} ({renderer.stats.size} B)")

    if args.profile:
        import jax

        profile_cm = jax.profiler.trace(args.profile)
    else:
        profile_cm = contextlib.nullcontext()

    with profile_cm:
        if args.benchmark:
            from rt_rs_tpu.timing import run_benchmark_protocol

            sched, mean_ms = run_benchmark_protocol(
                renderer, frames=args.bench_frames
            )
            print(
                f"avg frame time over {args.bench_frames} frames: "
                f"{mean_ms:.3f} ms"
            )
            print("chart: benchmark.png")
            return 0

        if args.gif:
            from rt_rs_tpu.utils.animation import render_orbit_gif

            times = render_orbit_gif(
                renderer, args.gif, frames=max(args.frames, 24)
            )
            print(
                f"wrote {args.gif} "
                f"({len(times)} frames, avg {np.mean(times) * 1e3:.1f} ms)"
            )
            return 0

        image = None
        vfn = (
            dynamic_wobble(renderer.scene)
            if (args.dynamic or args.refit)
            else None
        )
        for i in range(args.frames):
            image = (
                renderer.render_image(vfn(i)) if vfn
                else renderer.render_image()
            )
            renderer.orbit(1.0)
        if args.out and image is not None:
            write_png(args.out, image)
            print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
