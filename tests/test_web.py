"""Web viewer server tests (L7 parity: live updates, error recovery)."""

import json
import threading
import urllib.request

import pytest

from rt_rs_tpu.web import WebState, make_server


@pytest.fixture(scope="module")
def scenes_dir(tmp_path_factory):
    """A scene directory of generated scenes: ``default`` (the 50-triangle
    scene) and ``teatime`` (the same scene, another seed)."""
    from rt_rs_tpu.scene.procedural import small_scene

    d = tmp_path_factory.mktemp("web_scenes")
    small_scene(0).save(str(d / "default.json"))
    small_scene(1).save(str(d / "teatime.json"))
    return d


@pytest.fixture(scope="module")
def server(scenes_dir):
    state = WebState(
        str(scenes_dir / "default.json"),
        handler="naive",
        size=(32, 24),
    )
    srv = make_server(state, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, state
    srv.shutdown()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.read()


def _post(base, path, body=b"{}"):
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_index_and_scenes(server):
    base, _ = server
    status, body = _get(base, "/")
    assert status == 200 and b"rt_rs_tpu viewer" in body
    status, body = _get(base, "/scenes")
    names = json.loads(body)
    assert "default" in names and "teatime" in names
    # bvh checkpoints are not scenes
    assert not any(n.endswith(".bvh") for n in names)


def test_frame_png(server):
    base, _ = server
    status, body = _get(base, "/frame.png")
    assert status == 200
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    status, body = _get(base, "/status")
    s = json.loads(body)
    assert s["handler"] == "Naive"
    assert s["frame_ms"] > 0


def test_scene_switch_and_failure_recovery(server):
    base, state = server
    # Invalid scene: next frame keeps the old scene + error note
    # (web.rs:128-139 parity).
    _post(base, "/scene?name=does_not_exist")
    _get(base, "/frame.png")
    s = json.loads(_get(base, "/status")[1])
    assert "failed to load scene" in s["note"]
    before = state.renderer.scene.num_prims
    assert before == 50  # still default.json

    # Valid switch works and clears the note.
    _post(base, "/scene?name=default")
    _get(base, "/frame.png")
    s = json.loads(_get(base, "/status")[1])
    assert s["note"] == ""


def test_config_update(server):
    base, state = server
    _post(base, "/config", json.dumps({"bounces": 1}).encode())
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 1
    # partial update keeps defaults (serde(default) parity)
    assert state.renderer.config.compute.t_max == 1000.0


def test_viewport_update(server):
    base, state = server
    _post(
        base, "/viewport",
        json.dumps({"width": 16, "height": 12}).encode(),
    )
    status, body = _get(base, "/frame.png")
    assert status == 200
    assert state.renderer.width == 16 and state.renderer.height == 12


def test_viewport_bounds_rejected(server):
    """Out-of-range viewports are rejected at POST time (huge values
    would OOM the host; zero/negative would fail the Renderer rebuild)
    and the live renderer is untouched."""
    import urllib.error

    base, state = server
    w0, h0 = state.renderer.width, state.renderer.height
    for bad in (
        {"width": 0, "height": 240},
        {"width": 320, "height": -8},
        {"width": 65536, "height": 240},
    ):
        req = urllib.request.Request(
            base + "/viewport", data=json.dumps(bad).encode(), method="POST"
        )
        try:
            urllib.request.urlopen(req)
            raise AssertionError(f"viewport {bad} was accepted")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    _get(base, "/frame.png")
    assert (state.renderer.width, state.renderer.height) == (w0, h0)


def test_orbit_keys(server):
    base, state = server
    cam_before = state.renderer.camera.pos
    _post(base, "/key", json.dumps({"key": "left", "pressed": True}).encode())
    _get(base, "/frame.png")
    _get(base, "/frame.png")
    _post(base, "/key", json.dumps({"key": "left", "pressed": False}).encode())
    cam_after = state.renderer.camera.pos
    assert cam_before != cam_after


def test_config_survives_viewport_and_scene_switch(server):
    """Live config updates must persist across renderer rebuilds
    (review finding: _apply_updates used a stale self.config)."""
    base, state = server
    _post(base, "/config", json.dumps({"bounces": 3}).encode())
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 3
    _post(base, "/viewport", json.dumps({"width": 20, "height": 16}).encode())
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 3
    _post(base, "/scene?name=default")
    _get(base, "/frame.png")
    assert state.renderer.config.compute.bounces == 3


def test_unloaded_start(scenes_dir):
    """scene_path=None starts the viewer unloaded (Scene::Unloaded,
    scene/mod.rs:16-27 + pack_unloaded :115-131): black frames until a
    scene is picked, then a normal load."""
    state = WebState(
        None, scene_dir=str(scenes_dir), handler="naive", size=(16, 12)
    )
    assert state.renderer.scene.is_unloaded
    png = state.render_frame_png()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    from rt_rs_tpu.utils.image import decode_png

    img = decode_png(png)
    assert (img == 0).all()  # placeholder renders pure black
    # Loading a real scene replaces the placeholder.
    state._pending_scene = "default"
    state.render_frame_png()
    assert not state.renderer.scene.is_unloaded
    assert state.renderer.scene.num_prims == 50


def test_frame_pacing_gate(scenes_dir):
    """DefaultScheduler gates per-request renders (the reference's
    scheduler.ready() check): requests faster than the configured fps
    are served the cached frame without re-rendering."""
    from rt_rs_tpu.config import Config, Resolution

    state = WebState(
        str(scenes_dir / "default.json"),
        handler="naive",
        size=(16, 12),
        config=Config(resolution=Resolution.sized(16, 12), fps=1),
    )
    png1 = state.render_frame_png()
    ms1 = state.frame_ms
    png2 = state.render_frame_png()  # within the 1 fps window
    assert png2 is png1  # cache hit, no render dispatched
    assert state.frame_ms == ms1
    # Pending updates force a render even inside the window.
    state._pending_config = {"bounces": 1}
    state.render_frame_png()
    assert state.renderer.config.compute.bounces == 1


def test_scene_name_traversal_rejected(server):
    base, state = server
    import urllib.error
    import urllib.parse

    bad = urllib.parse.quote("../../etc/passwd")
    req = urllib.request.Request(
        base + f"/scene?name={bad}", data=b"", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
