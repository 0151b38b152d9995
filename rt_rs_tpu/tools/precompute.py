"""Ahead-of-time BVH construction — parity with
``src/tools/precompute.rs``: scene JSON -> ``*.bvh.json`` checkpoint
("reducing start up time", pdf p.24 §B.3), consumed by
``load --handler-bvh <path>``.

    python -m rt_rs_tpu.tools.precompute --scene scenes/teatime.json \
        --item-count 2 --out teatime.bvh.json
"""

from __future__ import annotations

import argparse

from rt_rs_tpu.bvh import build_bvh
from rt_rs_tpu.scene import Scene


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="precompute", description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--scene", required=True)
    p.add_argument("--eps", type=float, default=0.02)  # BvhIntrs default
    p.add_argument("--item-count", type=int, default=None)
    p.add_argument(
        "--device",
        action="store_true",
        help="build on the accelerator (Morton sort + Karras hierarchy "
        "emit + parallel refit; one prim per leaf — --eps/--item-count "
        "do not apply). An addition; the checkpoint format is "
        "identical.",
    )
    args = p.parse_args(argv)

    scene = Scene.load(args.scene)
    if args.device:
        from rt_rs_tpu.bvh.device import build_bvh_device

        data = build_bvh_device(scene)
    else:
        if args.item_count is None:
            p.error("--item-count is required (unless --device)")
        data = build_bvh(
            scene, eps=args.eps, target_item_count=args.item_count
        )
    data.save(args.out)  # compact JSON, like serde_json::to_string
    print(
        f"{args.out}: {data.num_nodes} nodes, {data.indices.size} indices, "
        f"{data.byte_size()} B on-device"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
