"""Minimal demo — parity with ``src/demo.rs``: a scene (default: the
generated base scene) with
the naive handler at 60 fps, Dynamic(16) resolution; renders a few
orbit frames and writes ``demo.png``."""

from __future__ import annotations

import argparse

from rt_rs_tpu.config import Config, Resolution
from rt_rs_tpu.renderer import Renderer
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.utils.image import write_png


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="demo", description=__doc__)
    p.add_argument(
        "--path", default=None,
        help="scene JSON (default: the generated base scene, seed 0)",
    )
    p.add_argument("--out", default="demo.png")
    p.add_argument("--frames", type=int, default=3)
    args = p.parse_args(argv)
    if args.path is None:
        from rt_rs_tpu.scene.procedural import base_scene_path

        args.path = base_scene_path()

    renderer = Renderer(
        Scene.load(args.path),
        config=Config(resolution=Resolution.sized(640, 480)),
        handler="naive",
    )
    image = None
    for _ in range(args.frames):
        image = renderer.render_image()
        renderer.orbit(1.0)
    write_png(args.out, image)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
