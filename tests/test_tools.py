"""CLI tools tests (construct / precompute / load / demo parity)."""

import json

import numpy as np
import pytest

from rt_rs_tpu.bvh import BvhData
from rt_rs_tpu.scene import Scene
from rt_rs_tpu.tools import construct, load, precompute


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory, small_scene):
    """The generated small scene as a scene JSON file."""
    path = tmp_path_factory.mktemp("scenes") / "small.json"
    small_scene.save(str(path))
    return str(path)


@pytest.mark.reference
def test_construct_roundtrip(tmp_path, meshes_dir):
    out = tmp_path / "scene.json"
    rc = construct.main([
        "--out", str(out),
        "--model", str(meshes_dir / "tetrahedron.obj"), "default",
        "--light", "10", "10", "-10", "1.5",
        "--camera-pos", "0", "0", "-10", "0", "0", "0",
        "--camera-orbit",
    ])
    assert rc == 0
    scene = Scene.load(str(out))
    assert scene.num_prims == 4
    assert scene.camera_controller.kind == "Orbit"
    # Default red material inserted at 0 (construct.rs:129-137).
    np.testing.assert_allclose(scene.mat_color[0], [0.5, 0.1, 0.1])
    # 'default' model -> material 0 (construct.rs:177-180).
    assert (scene.prim_material == 0).all()
    assert scene.light_strength[0] == pytest.approx(1.5)


@pytest.mark.reference
def test_construct_reproduces_teatime(tmp_path, meshes_dir, scenes_dir):
    """construct with teatime's parameters reproduces the shipped scene
    exactly (prims/verts/lights/materials/camera)."""
    out = tmp_path / "teatime.json"
    rc = construct.main([
        "--out", str(out),
        "--model", str(meshes_dir / "teapot.obj"), "default",
        "--light", "50", "0", "0", "1.8",
        "--light", "0", "50", "0", "1.2",
        "--camera-pos", "50", "10", "0", "0", "0", "0",
        "--camera-orbit",
    ])
    assert rc == 0
    # The ENTIRE JSON tree matches the shipped scene — including every
    # last-ULP float of the angle-weighted normals (the generation
    # pipeline is f32 in the reference's exact fold order).
    with open(out) as f:
        ours = json.load(f)
    with open(scenes_dir / "teatime.json") as f:
        ref = json.load(f)
    assert ours == ref


@pytest.mark.reference
def test_precompute_matches_shipped(tmp_path, scenes_dir):
    out = tmp_path / "t.bvh.json"
    rc = precompute.main([
        "--scene", str(scenes_dir / "teatime.json"),
        "--eps", "1.95", "--item-count", "2",
        "--out", str(out),
    ])
    assert rc == 0
    ours = BvhData.load(str(out))
    ref = BvhData.load(str(scenes_dir / "teatime.bvh.json"))
    np.testing.assert_array_equal(ours.fst, ref.fst)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    np.testing.assert_array_equal(ours.bounds_min, ref.bounds_min)


def test_load_handler_selection():
    args = load.build_parser().parse_args([])
    assert load.pick_handler(args) == ("blank", {})
    args = load.build_parser().parse_args(["--handler-naive"])
    assert load.pick_handler(args) == ("naive", {})
    args = load.build_parser().parse_args(["--handler-bvh"])
    assert load.pick_handler(args) == ("bvh", {})
    args = load.build_parser().parse_args(["--handler-bvh", "0.5"])
    assert load.pick_handler(args) == ("bvh", {"eps": 0.5})
    args = load.build_parser().parse_args(["--handler-bvh-rf", "0.1"])
    assert load.pick_handler(args) == ("rf_bvh", {"eps": 0.1})
    args = load.build_parser().parse_args(["--handler-pbvh"])
    assert load.pick_handler(args) == ("pbvh", {})


@pytest.mark.reference
def test_load_bvh_path_selection(scenes_dir):
    path = str(scenes_dir / "teatime.bvh.json")
    args = load.build_parser().parse_args(["--handler-bvh", path])
    assert load.pick_handler(args) == ("bvh", {"path": path})
    args = load.build_parser().parse_args(["--handler-bvh", "/nope/missing"])
    with pytest.raises(SystemExit):
        load.pick_handler(args)


def test_load_end_to_end(tmp_path, scene_path):
    out = tmp_path / "frame.png"
    rc = load.main([
        "--path", scene_path,
        "--handler-naive",
        "--width", "32", "--height", "24",
        "--frames", "2", "--out", str(out),
    ])
    assert rc == 0
    assert out.exists()
    from rt_rs_tpu.utils.image import read_png

    img = read_png(str(out))
    assert img.shape == (24, 32, 3)
    assert img.any()


def test_benchmark_protocol_writes_chart(tmp_path, scene_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = load.main([
        "--path", scene_path,
        "--handler-naive",
        "--width", "16", "--height", "16",
        "--benchmark", "--bench-frames", "20",
    ])
    assert rc == 0
    assert (tmp_path / "benchmark.png").exists()


def test_load_sharded_matches_single_chip(tmp_path, scene_path):
    """--bands/--shards (the multi-device CLI surface): the sharded
    frame equals the single-device one bit-for-bit on the virtual CPU
    mesh."""
    from rt_rs_tpu.utils.image import read_png

    single = tmp_path / "single.png"
    rc = load.main([
        "--path", scene_path,
        "--handler-pbvh",
        "--width", "64", "--height", "48",
        "--frames", "1", "--out", str(single),
    ])
    assert rc == 0
    sharded = tmp_path / "sharded.png"
    rc = load.main([
        "--path", scene_path,
        "--handler-pbvh",
        "--width", "64", "--height", "48",
        "--frames", "1", "--out", str(sharded),
        "--bands", "2", "--shards", "2",
    ])
    assert rc == 0
    a, b = read_png(str(single)), read_png(str(sharded))
    assert a.any()
    np.testing.assert_array_equal(b, a)


def test_load_dynamic_refit(tmp_path, scene_path):
    """--refit (BASELINE config 5 as a CLI call): per-frame refit of
    wobbled geometry renders a non-empty frame."""
    from rt_rs_tpu.utils.image import read_png

    out = tmp_path / "dyn.png"
    rc = load.main([
        "--path", scene_path,
        "--refit",
        "--width", "32", "--height", "24",
        "--frames", "2", "--out", str(out),
    ])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (24, 32, 3)
    assert img.any()


def test_dynamic_benchmark_protocol(tmp_path, scene_path, monkeypatch):
    """DynamicRenderer drives the study benchmark protocol (stats /
    render_frame / animate parity with Renderer)."""
    monkeypatch.chdir(tmp_path)
    rc = load.main([
        "--path", scene_path,
        "--dynamic",
        "--width", "16", "--height", "16",
        "--benchmark", "--bench-frames", "10",
    ])
    assert rc == 0
    assert (tmp_path / "benchmark.png").exists()


def test_debug_tree_check(capsys, small_scene):
    """`debug_tree --check`: 0 violations on a healthy build; corrupted
    trees are caught (the v3-based invariant validator)."""
    from rt_rs_tpu.bvh import build_bvh
    from rt_rs_tpu.tools.debug_tree import check_tree

    scene = small_scene
    data = build_bvh(scene, eps=0.02, target_item_count=2)
    assert check_tree(data, scene) == 0
    out = capsys.readouterr().out
    assert "0 violations" in out
    assert "degenerate" in out  # v3 geometry stats printed

    # Corrupt the leaf ranges (drop a slot): must be flagged.
    import dataclasses
    import numpy as np

    leaf = int(np.nonzero(np.asarray(data.item_count) > 0)[0][0])
    counts = np.asarray(data.item_count).copy()
    counts[leaf] -= 1
    bad = dataclasses.replace(data, item_count=counts)
    assert check_tree(bad, None) > 0


def test_load_default_path_is_generated(tmp_path, monkeypatch):
    """Without --path the tools render the generated base scene, written
    inside the checkout."""
    from rt_rs_tpu.scene import procedural
    from rt_rs_tpu.utils import cache

    monkeypatch.setattr(cache, "CHECKOUT", str(tmp_path))
    out = tmp_path / "frame.png"
    rc = load.main([
        "--handler-naive", "--width", "16", "--height", "12",
        "--bounces", "1", "--out", str(out),
    ])
    assert rc == 0 and out.exists()
    assert (tmp_path / "scenes" / "base_seed0.json").exists()
    assert procedural.base_scene_path(0).startswith(str(tmp_path))


def test_compile_cache_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    without it the cache is the fixed <checkout>/.jax_cache."""
    import jax

    from rt_rs_tpu.utils import cache

    monkeypatch.setattr(cache, "CHECKOUT", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert cache.enable_compile_cache() == "/elsewhere"
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        path = cache.enable_compile_cache()
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
