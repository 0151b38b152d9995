"""``python -m rt_rs_tpu.web [--path scene.json]``

``--unloaded --scene-dir DIR`` starts without a scene (the reference
wasm app's ``Scene::Unloaded`` start state): a black placeholder frame
until a scene button is pressed.
"""

import argparse

from rt_rs_tpu.web import serve


def main() -> int:
    p = argparse.ArgumentParser(prog="rt_rs_tpu.web")
    p.add_argument(
        "--path", default=None,
        help="scene JSON (default: the generated base scene, seed 0)",
    )
    p.add_argument(
        "--unloaded", action="store_true",
        help="start with no scene loaded (pick one in the browser)",
    )
    p.add_argument(
        "--scene-dir", default=None,
        help="directory of scene JSONs (default: --path's directory)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--handler", default="pbvh")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    args = p.parse_args()
    if args.path is None:
        from rt_rs_tpu.scene.procedural import base_scene_path

        args.path = base_scene_path()
    from rt_rs_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    scene_dir = args.scene_dir
    if args.unloaded and scene_dir is None:
        import os

        scene_dir = os.path.dirname(args.path)
    serve(
        None if args.unloaded else args.path,
        scene_dir=scene_dir,
        host=args.host, port=args.port, handler=args.handler,
        size=(args.width, args.height),
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
