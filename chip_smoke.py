"""Smoke test of the renderer on one NVIDIA GPU: ``python chip_smoke.py``.

Drives the main path through the entry points a user calls (``Renderer``,
``DynamicRenderer``, ``parallel.make_sharded_render``) on the generated
scenes, with every Pallas kernel compiled through Triton, and checks
each result against the repository's plain references:

1. kernels at real widths — the packet kernel (closest-hit and any-hit)
   on the 1920x1080 primary and first-bounce batches of the base scene
   against the plain-``lax`` chunk loop and brute force; the ``jnp``
   shading against the XLA bounce loop (``shade.trace``) on one bounce;
   ``memory_analysis()`` of the compiled 1080p frame;
2. frames — ``pbvh``, ``bvh``, ``rf_bvh`` and ``lbvh`` at 384x288 and
   ``pbvh`` at 1920x1080 against ``naive``, a few 1080p orbit frames;
3. large — the 50,560-triangle scene at 640x480 through ``pbvh`` and the
   threaded ``bvh`` traversal, against each other;
4. dynamic — ``DynamicRenderer`` rebuild and refit frames against a
   static ``pbvh`` render of the same geometry.

``--four-cards`` runs only the image-band x scene-shard path (2 x 2 mesh
over four cards) on the large scene at 1920x1080 against the one-card
frame of the same camera.

Tolerances: per-ray ``t`` within 1e-5 relative of the reference and the
same prim id for >= 99.99% of rays (knife-edge ties can flip under FMA
contraction); images within a mean absolute difference of 1e-4 with at
most 0.01% of pixels off by more than 1e-2.  The luminance metering of
the sharded path runs its dot product at ``precision="highest"``.

Any failed check raises; the last line of a passing run is one JSON
object with the device JAX reports.  Without a GPU it exits non-zero
before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T_RTOL = 1e-5
ID_AGREE = 0.9999
IMG_MEAN = 1e-4
IMG_FRAC = 1e-4  # share of pixels allowed above IMG_PIX
IMG_PIX = 1e-2
FULL = (1920, 1080)
STUDY = (384, 288)
LARGE = (640, 480)


def log(msg: str) -> None:
    print(msg, flush=True)


def check_rays(name, got, ref, valid=None):
    """Per-ray closest hits (t, id) against a reference."""
    import numpy as np

    t, pid = (np.asarray(x).reshape(-1) for x in got)
    t0, pid0 = (np.asarray(x).reshape(-1) for x in ref)
    keep = np.ones_like(pid, bool) if valid is None else np.asarray(valid).reshape(-1)
    agree = float(np.mean(pid[keep] == pid0[keep]))
    both = keep & (pid > 0) & (pid0 > 0)
    rel = float(np.max(np.abs(t[both] - t0[both]) / np.abs(t0[both]))) if both.any() else 0.0
    log(f"  {name}: {int(keep.sum())} rays, id agreement {agree:.6f}, max t rel {rel:.2e}")
    assert agree >= ID_AGREE, f"{name}: id agreement {agree} < {ID_AGREE}"
    assert rel <= T_RTOL, f"{name}: t relative error {rel} > {T_RTOL}"


def check_mask(name, got, ref, valid):
    import numpy as np

    keep = np.asarray(valid)
    agree = float(np.mean(np.asarray(got)[keep] == np.asarray(ref)[keep]))
    log(f"  {name}: {int(keep.sum())} rays, verdict agreement {agree:.6f}")
    assert agree >= ID_AGREE, f"{name}: agreement {agree} < {ID_AGREE}"


def check_image(name, img, ref):
    import numpy as np

    img, ref = np.asarray(img), np.asarray(ref)
    assert img.shape == ref.shape, (img.shape, ref.shape)
    assert np.isfinite(img).all(), f"{name}: non-finite pixels"
    d = np.abs(img - ref).max(axis=-1)
    mean, frac = float(d.mean()), float(np.mean(d > IMG_PIX))
    log(f"  {name}: mean |d| {mean:.2e}, pixels > {IMG_PIX}: {frac:.2e}")
    assert mean <= IMG_MEAN, f"{name}: mean abs diff {mean} > {IMG_MEAN}"
    assert frac <= IMG_FRAC, f"{name}: {frac} of pixels differ by > {IMG_PIX}"
    assert ref.mean() > 0.01, f"{name}: reference frame is black"


def timed_frames(renderer, n: int):
    """(first-call seconds incl. compile, median ms of n more frames)."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    jax.block_until_ready(renderer.render_frame(block=False))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render_frame(block=False))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)) * 1e3


def frame(scene, handler, w, h, n=3, **kw):
    from rt_rs_tpu import Renderer
    from rt_rs_tpu.config import Config, Resolution

    r = Renderer(scene, config=Config(resolution=Resolution.sized(w, h)),
                 handler=handler, **kw)
    first, ms = timed_frames(r, n)
    log(f"  {handler} {w}x{h}: first frame {first:.1f} s (compile), {ms:.2f} ms/frame")
    return r, r.render_frame()


def phase_kernels(base):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rt_rs_tpu.config import ComputeConfig
    from rt_rs_tpu.handlers import get_handler
    from rt_rs_tpu.ops import shade
    from rt_rs_tpu.ops.intersect import closest_hit_bruteforce
    from rt_rs_tpu.ops.pallas import kernel_mode
    from rt_rs_tpu.ops.pallas.packet_trace import packet_closest_hit_tiled
    from rt_rs_tpu.ops.shade_tile import shade_pre

    log(f"phase 1: kernels at {FULL[0]}x{FULL[1]}")
    assert kernel_mode() == "triton", kernel_mode()
    cfg = ComputeConfig()
    win = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
    h = get_handler("pbvh")
    accel, arrays = h.build(base, base.pack())
    pos = jnp.asarray(base.camera.pos, jnp.float32)
    at = jnp.asarray(base.camera.at, jnp.float32)
    payload, valid, _ = shade.camera_ray_tiles(pos, at, *FULL, 256, block=(16, 16))

    def traced(p, v, c, **kw):
        return packet_closest_hit_tiled(accel, p, v, c, **win, **kw)

    kernel = jax.jit(lambda p, v, c, refine: traced(p, v, c, refine=refine),
                     static_argnames="refine")
    lax = jax.jit(lambda p, v, c, refine: traced(p, v, c, refine=refine, loop="lax"),
                  static_argnames="refine")
    anyk = jax.jit(lambda p, v, c: traced(p, v, c, refine=True, any_hit=True))
    anyl = jax.jit(lambda p, v, c: traced(p, v, c, refine=True, any_hit=True, loop="lax"))
    brute = jax.jit(lambda o, d, ex: closest_hit_bruteforce(
        o, d, arrays.pa, arrays.pb, arrays.pc, ex, chunk=128, **win))

    def naive(p):
        o = p[0:3].reshape(3, -1).T
        d = p[3:6].reshape(3, -1).T
        return brute(o, d, p[6].reshape(-1).astype(jnp.int32))

    t, pid = kernel(payload, valid, None, refine=False)
    check_rays("primary kernel vs lax", (t, pid), lax(payload, valid, None, refine=False), valid)
    check_rays("primary kernel vs brute force", (t, pid), naive(payload), valid)

    # First-bounce batches: reflection rays and shadow rays (any-hit).
    active = valid & (pid != 0) & (t < cfg.t_max) & (t > cfg.t_min)
    rows = arrays.shade_table[jnp.where(active, pid, 0).reshape(-1)].T.reshape(32, *t.shape)
    lights = jnp.concatenate([arrays.light_pos, arrays.light_strength[:, None]], axis=1)
    sh, caps, masks, nxt = shade_pre(rows, payload, t, pid.astype(jnp.float32), lights,
                                     emit_next=True)
    tb, ib = kernel(nxt, active, None, refine=True)
    check_rays("bounce kernel vs lax", (tb, ib), lax(nxt, active, None, refine=True), active)
    check_rays("bounce kernel vs brute force", (tb, ib), naive(nxt), active)
    sh_pay = jnp.concatenate(sh, axis=1)
    sh_valid = jnp.concatenate([active & (m > 0) for m in masks])
    sh_cap = jnp.concatenate(caps)
    blk = anyk(sh_pay, sh_valid, sh_cap)
    check_mask("shadow any-hit kernel vs lax", blk, anyl(sh_pay, sh_valid, sh_cap), sh_valid)
    ts, ids = naive(sh_pay)
    want = (np.asarray(ids) > 0) & (np.asarray(ts) < np.asarray(sh_pay[7]).reshape(-1))
    check_mask("shadow any-hit kernel vs brute force", blk,
               want.reshape(blk.shape), sh_valid)

    # jnp shading vs the XLA bounce loop on one bounce.
    one = ComputeConfig(bounces=1)
    tiled = jax.jit(lambda p, a: shade.render_tiled(
        arrays, h.intersect_tiled_fn(accel, arrays, one), one, p, a,
        *FULL, ray_tile=256, block=(16, 16)))
    ref = jax.jit(lambda p, a: shade.render(
        arrays, h.intersect_fn(accel, arrays, one), one, p, a, *FULL,
        block=(16, 16)))
    check_image("one-bounce jnp shading vs shade.trace", tiled(pos, at), ref(pos, at))


def phase_frames(base):
    import jax.numpy as jnp
    import numpy as np

    from rt_rs_tpu.renderer import _render_jit

    log("phase 2: frames")
    _, ref = frame(base, "naive", *STUDY, n=1)
    for handler in ("pbvh", "bvh", "rf_bvh", "lbvh"):
        _, img = frame(base, handler, *STUDY)
        check_image(f"{handler} {STUDY[0]}x{STUDY[1]} vs naive", img, ref)
    _, ref = frame(base, "naive", *FULL, n=1)
    r, img = frame(base, "pbvh", *FULL)
    check_image(f"pbvh {FULL[0]}x{FULL[1]} vs naive", img, ref)
    compiled = _render_jit.lower(
        r.arrays, r.accel,
        jnp.asarray(r.camera.pos, jnp.float32), jnp.asarray(r.camera.at, jnp.float32),
        handler=r.handler, cfg=r.config.compute, width=r.width, height=r.height,
        block=r.block,
    ).compile()
    log(f"  memory_analysis (pbvh {FULL[0]}x{FULL[1]} frame): {compiled.memory_analysis()}")
    for i in range(3):
        r.orbit(40.0)
        img = np.asarray(r.render_frame())
        assert np.isfinite(img).all() and img.mean() > 0.01, f"orbit frame {i} black"
    log(f"  3 orbit frames at {FULL[0]}x{FULL[1]}: mean {img.mean():.4f}")


def phase_large(large):
    log(f"phase 3: large scene ({large.num_prims} triangles) at {LARGE[0]}x{LARGE[1]}")
    _, a = frame(large, "pbvh", *LARGE)
    _, b = frame(large, "bvh", *LARGE, handler_kwargs={"backend": "threaded"})
    check_image("pbvh vs threaded bvh", a, b)


def phase_dynamic(base):
    import numpy as np

    from rt_rs_tpu.config import Config, Resolution
    from rt_rs_tpu.renderer import DynamicRenderer

    log(f"phase 4: dynamic geometry at {STUDY[0]}x{STUDY[1]}")
    moved = base.__class__(**vars(base))
    moved.vert_pos = (base.vert_pos * np.float32(1.01)).astype(np.float32)
    _, ref = frame(moved, "pbvh", *STUDY, n=1)
    cfg = Config(resolution=Resolution.sized(*STUDY))
    for refit in (False, True):
        dyn = DynamicRenderer(base, config=cfg, refit=refit)
        t0 = time.perf_counter()
        img = dyn.render_frame(moved.vert_pos)
        first = time.perf_counter() - t0
        dyn.render_frame(base.vert_pos)
        t0 = time.perf_counter()
        img = dyn.render_frame(moved.vert_pos)
        ms = (time.perf_counter() - t0) * 1e3
        name = "refit" if refit else "rebuild"
        log(f"  dynamic {name}: first frame {first:.1f} s, {ms:.2f} ms/frame")
        check_image(f"dynamic {name} vs static pbvh", img, ref)


def phase_four_cards(large):
    import jax
    import jax.numpy as jnp

    from rt_rs_tpu.config import ComputeConfig
    from rt_rs_tpu.handlers import get_handler
    from rt_rs_tpu.parallel import hybrid_mesh, make_sharded_render

    log(f"phase 5: 2 bands x 2 scene shards on four cards, large scene at {FULL[0]}x{FULL[1]}")
    assert len(jax.devices()) >= 4, f"need four cards, have {len(jax.devices())}"
    _, ref = frame(large, "pbvh", *FULL, n=1)
    handler = get_handler("pbvh")
    accel, arrays = handler.build(large, large.pack())
    fn = make_sharded_render(handler, accel, arrays, ComputeConfig(), *FULL,
                             hybrid_mesh(2, 2))
    pos = jnp.asarray(large.camera.pos, jnp.float32)
    at = jnp.asarray(large.camera.at, jnp.float32)
    t0 = time.perf_counter()
    img, lum = jax.block_until_ready(fn(pos, at))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(3):
        img, lum = fn(pos, at)
    jax.block_until_ready(img)
    ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"  sharded: first frame {first:.1f} s, {ms:.2f} ms/frame, mean luminance {float(lum):.4f}")
    check_image("2x2 sharded vs one card", img, ref)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 2 x 2 band/shard path on four cards")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rt_rs_tpu.scene.procedural import base_scene, large_scene
    from rt_rs_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards(large_scene(args.seed))
    else:
        base = base_scene(args.seed)
        phase_kernels(base)
        phase_frames(base)
        phase_large(large_scene(args.seed))
        phase_dynamic(base)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    for line in card:
        log(line)
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
