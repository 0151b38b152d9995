"""Frame-time benchmark on one NVIDIA GPU: ``python bench.py``.

Reproduces the reference study's protocol — a 6,320-triangle scene,
384x288, 4 bounces, 2 shadow-rayed lights, frames averaged over a camera
orbit (pdf p.19 §4.2) — on the generated base scene with the ``pbvh``
handler, and also reports 1920x1080.  Before timing it cross-checks the
compiled paths against the brute-force ``naive`` handler on the card.

Baseline: the reference's best handler (RfBvhIntrs) at 214.569 ms per
compute pass on the same protocol (RX 580; BASELINE.md).

Each size is measured REPEATS times, interleaved; the headline is the
per-size median and the JSON carries the spread.  Every timed region
ends in ``block_until_ready``.

``--compare`` instead times the three intersection paths of the
translation study — ``pbvh`` with the Pallas kernel, ``pbvh`` with the
plain-``lax`` chunk loop, and ``bvh`` with the threaded XLA traversal —
plus ``pbvh`` without the any-hit shadow call, at 384x288 and 1920x1080
on the base scene and 640x480 on the 50,560-triangle scene.
``--trace DIR`` writes a ``jax.profiler`` trace of 1080p ``pbvh`` frames
to DIR and prints the device time by span (``cull``, ``intersect``,
``shade``, other) and the device idle share.

Prints the device and card first; the last line is ONE JSON object.
Without a GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REF_FRAME_MS = 214.569  # RF-BVH, 384x288, 4 bounces (pdf p.19 §4.2.2)
REPEATS = 3
BOUNCES = 4
N_LIGHTS = 2
SIZES = {"384": (384, 288, 60), "1080": (1920, 1080, 12)}


def make_renderer(scene, width, height, handler="pbvh", **kw):
    import jax

    from rt_rs_tpu.config import Config, Resolution
    from rt_rs_tpu.renderer import Renderer

    r = Renderer(
        scene,
        config=Config(resolution=Resolution.sized(width, height)),
        handler=handler,
        **kw,
    )
    jax.block_until_ready(r.render_frame(block=False))  # compile + warm
    return r


def orbit_ms(r, frames: int, rotations: float = 1.0) -> float:
    """Mean ms/frame over ``frames`` spread across ``rotations`` full
    camera orbits (the study averages over whole rotations, pdf §4.2),
    frames dispatched back to back with one wait at the end."""
    import jax

    mult = rotations * 2.0 * math.pi / frames / 0.0314
    t0 = time.perf_counter()
    out = None
    for _ in range(frames):
        out = r.render_frame(block=False)
        r.orbit(mult)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / frames * 1e3


def median_frame_ms(r, n: int = 5) -> float:
    """Median of ``n`` single-frame latencies (each ends in
    block_until_ready)."""
    import jax

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(r.render_frame(block=False))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def naive_check(scene) -> bool:
    """Compiled paths vs brute force on the card: pbvh, bvh, rf_bvh and
    lbvh frames at 384x288 against naive (chip_smoke.py's tolerance)."""
    ref = np.asarray(make_renderer(scene, 384, 288, "naive").render_frame())
    ok = True
    for handler in ("pbvh", "bvh", "rf_bvh", "lbvh"):
        img = np.asarray(make_renderer(scene, 384, 288, handler).render_frame())
        d = np.abs(img - ref).max(axis=-1)
        good = d.mean() <= 1e-4 and np.mean(d > 1e-2) <= 1e-4
        if not good:
            print(f"# {handler} vs naive FAIL: mean {d.mean():.2e}", flush=True)
        ok &= bool(good)
    return ok


def protocol(scene) -> dict:
    """The study protocol at 384x288 and 1920x1080 -> JSON fields."""
    rs = {k: make_renderer(scene, w, h) for k, (w, h, _) in SIZES.items()}
    samples: dict[str, list[float]] = {k: [] for k in SIZES}
    for _ in range(REPEATS):
        for k, (_, _, frames) in SIZES.items():
            samples[k].append(orbit_ms(rs[k], frames))
    med = {k: float(np.median(v)) for k, v in samples.items()}
    ms_384, ms_1080 = med["384"], med["1080"]
    px_1080 = 1920 * 1080
    return {
        "metric": (
            f"base scene 384x288 4-bounce pbvh frame time, median of "
            f"{REPEATS} interleaved orbit repeats (1080p: {ms_1080:.3f} ms "
            f"= {px_1080 / (ms_1080 * 1e-3) / 1e6:.1f} Mrays/s "
            f"primary-equivalent)"
        ),
        "value": ms_384,
        "unit": "ms/frame",
        # >1 means faster than the reference's best handler on the same
        # protocol (RF-BVH, 214.569 ms on RX 580).
        "vs_baseline": REF_FRAME_MS / ms_384,
        "ms_1080": ms_1080,
        "samples_ms": samples,
    }


def _no_anyhit(handler):
    """A copy of ``handler`` whose frames trace shadow rays with the
    shared closest-hit call instead of the any-hit call."""
    import copy

    class NoAnyHit(type(handler)):
        def intersect_tiled_anyhit_fn(self, *args):
            return None

    h = copy.copy(handler)
    h.__class__ = NoAnyHit
    return h


def compare(seed: int) -> dict:
    """Median frame ms of each path at the three sizes (interleaved
    repeats, one Renderer per cell compiled up front)."""
    from rt_rs_tpu.handlers import get_handler
    from rt_rs_tpu.scene.procedural import base_scene, large_scene

    base, large = base_scene(seed), large_scene(seed)
    cells = {
        "base 384x288": (base, 384, 288),
        "base 1920x1080": (base, 1920, 1080),
        "large 640x480": (large, 640, 480),
    }
    paths = {
        "pbvh kernel": lambda: get_handler("pbvh"),
        "pbvh lax": lambda: get_handler("pbvh", loop="lax"),
        "bvh threaded": lambda: get_handler("bvh", backend="threaded"),
        "pbvh kernel, no any-hit": lambda: _no_anyhit(get_handler("pbvh")),
    }
    rs = {}
    for cell, (scene, w, h) in cells.items():
        for path, make in paths.items():
            t0 = time.perf_counter()
            rs[cell, path] = make_renderer(scene, w, h, make())
            print(f"# compiled {cell} / {path} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {f"{c} / {p}": [] for c, p in rs}
    for _ in range(REPEATS):
        for (cell, path), r in rs.items():
            out[f"{cell} / {path}"].append(median_frame_ms(r))
    for key, v in out.items():
        print(f"# {key}: median {np.median(v):.3f} ms (repeats {v})", flush=True)
    return {k: float(np.median(v)) for k, v in out.items()}


def trace(seed: int, out_dir: str) -> dict:
    """Profile 1080p pbvh frames; device time by span and idle share."""
    import jax

    from rt_rs_tpu.scene.procedural import base_scene
    from rt_rs_tpu.utils.trace import device_breakdown

    r = make_renderer(base_scene(seed), 1920, 1080)
    for _ in range(3):
        jax.block_until_ready(r.render_frame(block=False))
    t0 = time.perf_counter()
    for _ in range(3):
        jax.block_until_ready(r.render_frame(block=False))
    frame_ms = (time.perf_counter() - t0) / 3 * 1e3
    with jax.profiler.trace(out_dir):
        for _ in range(3):
            jax.block_until_ready(r.render_frame(block=False))
    shares = device_breakdown(out_dir)
    shares["frame_ms_untraced"] = frame_ms
    shares["busy_ms_per_frame"] = shares["busy_ms"] / 3
    for k, v in shares.items():
        print(f"# trace {k}: {v}", flush=True)
    return shares


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare", action="store_true")
    p.add_argument("--trace", metavar="DIR")
    args = p.parse_args()
    if args.trace:
        # Plain kernel launches (no CUDA command buffers), so every
        # device event carries its op's scope path for utils/trace.py.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
        ).strip()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from rt_rs_tpu.scene.procedural import base_scene
    from rt_rs_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    print(f"# device {device}", flush=True)
    if args.compare:
        result = {"compare_ms": compare(args.seed)}
    elif args.trace:
        result = {"trace_1080": trace(args.seed, args.trace)}
    else:
        scene = base_scene(args.seed)
        result = {"correct": naive_check(scene), **protocol(scene)}
    result["device"] = device
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
