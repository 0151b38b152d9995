"""Golden-image regression gates on the reference project's scenes.

The goldens were rendered with the naive (brute-force) backend —
itself oracle-verified in test_render.py — on CPU at 64x48 from the
reference's scene JSONs and OBJ meshes (the scene set lives in
rt_rs_tpu/scene/presets.py).  They pin those files' bits, so every test
here is ``reference``-marked and skips without RT_RS_REFERENCE.

Beyond the two shipped JSON scenes the set pins the special branches:
cessna (NaN-normal degenerate geometry; multi-light), shuttle (second
multi-light mesh), ghost (a real material=-1 prim -> the XLA
shade.render fallback), teapots3 (18,960 prims in one chunk table).
"""

import numpy as np
import pytest

from rt_rs_tpu.config import ComputeConfig, Config, Resolution
from rt_rs_tpu.renderer import Renderer
from rt_rs_tpu.scene import Scene, presets
from rt_rs_tpu.utils.image import read_png

GOLDENS = "tests/goldens"
W, H = 64, 48


def _check(img, name):
    golden = read_png(f"{GOLDENS}/{name}_{W}x{H}.png")
    # 8-bit output; tolerate 1 count of rounding jitter on a handful of
    # pixels (backend op-order differences).
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert diff.max() <= 2, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.02, f"{(diff > 0).mean():.3%} pixels differ"


def _render(scene, bounces, handler, kwargs):
    r = Renderer(
        scene,
        config=Config(
            compute=ComputeConfig(bounces=bounces),
            resolution=Resolution.sized(W, H),
        ),
        handler=handler,
        handler_kwargs=kwargs,
    )
    return r.render_image()


pytestmark = pytest.mark.reference

# The full handler matrix.  Non-applicable cell: (cessna, rf_bvh) — a
# >8-prim unsplittable cluster the RF format cannot represent (the
# reference panics on the same input, rf.rs:113).
MATRIX = [
    ("naive", {}),
    ("bvh", {"backend": "threaded"}),
    ("rf_bvh", {"backend": "threaded"}),
    ("pbvh", {}),
    ("lbvh", {}),
]


@pytest.mark.parametrize("name", ["default", "teatime"])
@pytest.mark.parametrize("handler,kwargs", MATRIX)
def test_golden(scenes_dir, name, handler, kwargs):
    scene = Scene.load(str(scenes_dir / f"{name}.json"))
    _check(_render(scene, 4, handler, kwargs), name)


@pytest.mark.parametrize("name", ["cessna", "shuttle", "ghost"])
@pytest.mark.parametrize("handler,kwargs", MATRIX)
def test_golden_presets(meshes_dir, scenes_dir, name, handler, kwargs):
    if name == "cessna" and handler == "rf_bvh":
        from rt_rs_tpu.bvh.rf import RfFormatError

        with pytest.raises(RfFormatError):
            _render(
                presets.golden_set(
                    meshes_dir=str(meshes_dir), scenes_dir=str(scenes_dir)
                )[name][0],
                4, handler, kwargs,
            )
        return
    scene, bounces = presets.golden_set(
        meshes_dir=str(meshes_dir), scenes_dir=str(scenes_dir)
    )[name]
    _check(_render(scene, bounces, handler, kwargs), name)


def test_golden_ghost_fallback_branch(meshes_dir, scenes_dir):
    """The ghost golden must actually exercise the negative-material
    XLA fallback (renderer._render_jit's else-branch)."""
    scene = presets.ghost_scene(-1)
    assert not scene.pack().no_negative_materials
    _check(_render(scene, 4, "pbvh", {}), "ghost")


def test_golden_large_table(scenes_dir):
    """teapots3 (18,960 prims) builds ONE chunk table and reproduces the
    naive golden through it."""
    from rt_rs_tpu.ops.pallas.packet_trace import TriChunks

    scene = presets.tiled_teapots(3, scenes_dir=str(scenes_dir))
    r = Renderer(
        scene, config=Config(resolution=Resolution.sized(W, H)),
        handler="pbvh",
    )
    assert isinstance(r.accel, TriChunks)
    _check(r.render_image(), "teapots3")
