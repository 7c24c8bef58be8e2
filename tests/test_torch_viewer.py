"""``Viewer``, its scripted interaction and the web viewer of the port
against the JAX package's on the CPU, on ``primitive://cube`` scenes.

Tolerances: the dashboard's instance (or class) quadrant equal; the RGB,
normal and coordinate quadrants within 1 LSB on >= 99% of their pixels and
within 13 LSB on all of them (the rgb bound of ``test_torch_render_pass``;
ROADMAP C-5: the packages differ in the last bits where XLA contracts
multiply-adds). The coordinate quadrant stretches each channel's range to
[0, 255]: where a channel is nearly constant (the top face alone, its z
within 3e-7) it amplifies rounding noise to full scale in both packages,
so there the coordinates themselves are held (1e-5) and the quadrant is
the JAX colorizer applied to the port's coordinates. ``play_script`` with
the JAX test's script: the same events seen, the camera pose within 1e-5
after each event, ``sim_iteration`` equal and the falling cube's z within
1e-5. ``run()`` without a display writes the dashboard as a PNG that reads
back bitwise. The web viewer: the 8 cases of ``tests/test_viewer_web.py``
against the port's server, and ``_ViewerState.handle_event``'s JSON equal
to the JAX package's for the same events."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
import torch_port_scene  # noqa: F401  (one torch thread per xdist worker)
from stillleben_tpu import viewer as jviewer
from stillleben_tpu import viewer_web as jweb
from stillleben_tpu_torch import viewer as pviewer
from stillleben_tpu_torch import viewer_web as pweb
from stillleben_tpu_torch.assets.image import decode_png_samples, read_png_samples


@pytest.fixture(scope="module", autouse=True)
def cpu_context():
    sl.init(device="cpu")


@pytest.fixture(autouse=True)
def native_cooker(monkeypatch):
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1")


def _cube_scene(pkg, size, eye, target, z=0.0, physics=False, class_index=0):
    mesh = pkg.Mesh("primitive://cube", physics=physics)
    mesh.class_index = class_index
    scene = pkg.Scene(size)
    obj = pkg.Object(mesh)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = z
    obj.set_pose(T)
    scene.add_object(obj)
    scene.set_camera_look_at(eye, target)
    return scene


def _hold_dashboard(a, b, H, W, coords=True):
    """The dashboard ``b`` (port) against ``a`` (JAX), by the module's
    rule; returns the share of pixels within 1 LSB per quadrant."""
    assert a.shape == b.shape == (2 * H, 2 * W, 3) and b.dtype == np.uint8
    assert np.array_equal(a[H:, :W], b[H:, :W]), "instance / class quadrant"
    shares = {}
    for name, q in (("rgb", np.s_[:H, :W]), ("normals", np.s_[:H, W:]), ("coords", np.s_[H:, W:])):
        if name == "coords" and not coords:
            continue
        d = np.abs(a[q].astype(np.int32) - b[q].astype(np.int32)).max(-1)
        shares[name] = float((d <= 1).mean())
        assert shares[name] >= 0.99 and d.max() <= 13, (name, shares[name], d.max())
    return shares


@pytest.mark.parametrize("shading,instances", [("pbr", True), ("flat", False)])
def test_dashboard_matches_jax(shading, instances):
    """Three faces in view: every quadrant by the dashboard rule."""
    scenes = [_cube_scene(pkg, (64, 48), [3.0, 2.0, 3.0], [0.0, 0.0, 0.0], class_index=2)
              for pkg in (jsl, sl)]
    views = jviewer.Viewer(scenes[0]), pviewer.Viewer(scenes[1])
    for v in views:
        v.shading, v.show_instances = shading, instances
    a, b = (v.dashboard() for v in views)
    _hold_dashboard(a, b, 48, 64)
    assert b[48:, :64].any() and b[:48, :64].std() > 1.0


def test_dashboard_top_view_coordinates():
    """The web viewer's scene: the top face alone. Its coordinates within
    1e-5; the coordinate quadrant is the colorizer of the port's own
    coordinates; every other quadrant by the dashboard rule."""
    scenes = [_cube_scene(pkg, (64, 48), [0.8, 0.6, 1.5], [0.0, 0.0, 0.0]) for pkg in (jsl, sl)]
    a, b = jviewer.Viewer(scenes[0]).dashboard(), pviewer.Viewer(scenes[1]).dashboard()
    _hold_dashboard(a, b, 48, 64, coords=False)
    jr, pr = jsl.RenderPass().render(scenes[0]), sl.RenderPass().render(scenes[1])
    valid = np.asarray(jr.instance_index()) != 0
    assert np.array_equal(valid, pr.instance_index().numpy() != 0)
    coords = pr.coordinates().numpy()
    np.testing.assert_allclose(coords[valid], np.asarray(jr.coordinates())[valid], atol=1e-5)
    assert np.ptp(coords[valid][:, 2]) < 1e-6  # the channel the colorizer stretches
    expected = (jviewer._colorize_coords(coords, valid) * 255).astype(np.uint8)
    assert np.array_equal(b[48:, 64:], expected)


def test_colorizers_match_jax():
    rng = np.random.default_rng(0)
    inst = rng.integers(0, 6, size=(12, 16)).astype(np.uint16)
    assert np.array_equal(pviewer._colorize_instances(inst), jviewer._colorize_instances(inst))
    coords = rng.normal(size=(12, 16, 3)).astype(np.float32)
    assert np.array_equal(pviewer._colorize_coords(coords, inst > 0),
                          jviewer._colorize_coords(coords, inst > 0))


def _script_scene(pkg):
    return _cube_scene(pkg, (48, 48), [3.0, 0.0, 1.0], [0.0, 0.0, 0.5], z=0.6, physics=True)


def test_play_script_matches_jax():
    """``tests/test_tools.py::test_viewer_play_script``'s script in both
    packages."""
    runs = []
    for pkg, mod in ((jsl, jviewer), (sl, pviewer)):
        scene = _script_scene(pkg)
        v = mod.Viewer(scene)
        W, H = scene.viewport
        events = [
            ("drag", (W, H), (int(W * 1.6), H), 5),  # orbit
            ("scroll", 2),                            # zoom in
            ("key", " "),                             # run physics
            ("frames", 5),                            # cube falls
            ("key", "i"),                             # class segmentation
            ("key", "m"),                             # flat shading
            ("key", "o"),                             # SSAO off
            ("key", "q"),                             # not a control: no frame
        ]
        seen, cams = [], []

        def cb(ev, img, scene=scene):
            seen.append(ev[0])
            cams.append(scene.camera_pose())

        frames = v.play_script(events, frame_cb=cb)
        runs.append((seen, cams, frames, v, scene))
    (sj, cj, fj, vj, scj), (sp, cp, fp, vp, scp) = runs
    assert sp == sj == ["drag", "scroll", "key", "frames", "key", "key", "key"]
    for a, b in zip(cj, cp):
        np.testing.assert_allclose(b, a, atol=1e-5)
    assert vp.sim_iteration == vj.sim_iteration == 5
    assert (vp.shading, vp.ssao_enabled, vp.show_instances) == ("flat", False, False)
    np.testing.assert_allclose(scp.objects[0].pose()[2, 3], scj.objects[0].pose()[2, 3], atol=1e-5)
    assert scp.objects[0].pose()[2, 3] < 0.6 - 1e-3
    assert len(fp) == len(fj) == 7 and all(f.shape == (96, 96, 3) for f in fp)
    for a, b in zip(fj, fp):
        _hold_dashboard(a, b, 48, 48)
    assert any((fp[i] != fp[i + 1]).any() for i in range(len(fp) - 1))
    with pytest.raises(ValueError, match="unknown viewer script event"):
        vp.play_script([("nope",)])


def test_run_headless_writes_the_dashboard(tmp_path, monkeypatch, capsys):
    """Without a display ``run`` takes the headless branch: the PNG holds the
    dashboard bit for bit, and a failing render raises."""
    monkeypatch.delenv("DISPLAY", raising=False)
    scene = _cube_scene(sl, (40, 30), [3.0, 2.0, 3.0], [0.0, 0.0, 0.0])
    v = sl.Viewer(scene)
    path = str(tmp_path / "dash.png")
    v.run(path)
    assert "headless" in capsys.readouterr().out
    back = read_png_samples(path).samples.reshape(60, 80, 3)
    assert np.array_equal(back, v.dashboard())

    def broken(*a, **k):
        raise RuntimeError("render failed")

    monkeypatch.setattr(v, "dashboard", broken)
    with pytest.raises(RuntimeError, match="render failed"):
        v.run(str(tmp_path / "never.png"))


def test_viewer_controls():
    """The controls as in ``test_viewer_interactive_controls`` (a paused
    step is a no-op, reset, shading cycle, exposure, the status line, the
    render pass kept per (shading, SSAO))."""
    scene = _script_scene(sl)
    v = sl.Viewer(scene)
    T = scene.objects[0].pose()
    v.step()
    assert np.array_equal(scene.objects[0].pose(), T)
    v.toggle_simulation()
    for _ in range(3):
        v.step()
    assert scene.objects[0].pose()[2, 3] < T[2, 3] - 1e-4 and v.sim_iteration == 3
    assert "running: 3" in v._status_line()
    v.reset_objects()
    assert np.array_equal(scene.objects[0].pose(), T) and v.sim_iteration == 0
    v.cycle_shading()
    assert v.shading == "flat"
    v.adjust_exposure(+1.0)
    assert scene.manual_exposure == 2.0
    assert v._get_render_pass() is v._get_render_pass()
    rp = v._get_render_pass()
    v.ssao_enabled = False
    assert v._get_render_pass() is not rp and v._rp_key == ("flat", False)
    assert v.handle_key("x") is False


# -- the web viewer ------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    scene = _cube_scene(sl, (64, 48), [0.8, 0.6, 1.5], [0.0, 0.0, 0.0], physics=True)
    srv = sl.Viewer(scene).serve(port=0, block=False)  # ephemeral port
    yield srv
    srv.close()


def _get(srv, path):
    with urllib.request.urlopen(srv.url.rstrip("/") + path, timeout=60) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _event(srv, ev):
    req = urllib.request.Request(srv.url.rstrip("/") + "/event", data=json.dumps(ev).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_web_index_page(server):
    status, ctype, body = _get(server, "/")
    assert status == 200 and "text/html" in ctype
    assert b"stillleben_tpu viewer" in body
    assert b"/frame.png" in body and b"/event" in body
    assert body == jweb._PAGE.encode()


def test_web_frame_png_renders(server):
    status, ctype, body = _get(server, "/frame.png?seq=0")
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    png = decode_png_samples(body)
    img = png.samples.reshape(96, 128, 3)
    assert img.any()
    assert np.array_equal(img, server.state.viewer.dashboard())


def test_web_frame_cache_reuses_png(server):
    a = _get(server, "/frame.png")[2]
    b = _get(server, "/frame.png")[2]
    assert a == b  # same seq -> cached bytes, no re-render


def test_web_drag_writes_camera_back(server):
    scene = server.state.viewer.scene
    before = scene.camera_pose()
    seq0 = _event(server, {"type": "tick"})["seq"]
    _event(server, {"type": "drag_start", "x": 30.0, "y": 40.0})
    out = _event(server, {"type": "drag", "x": 90.0, "y": 60.0})
    _event(server, {"type": "drag_end"})
    assert out["seq"] > seq0
    assert not np.allclose(before, scene.camera_pose())


def test_web_scroll_dollies(server):
    scene = server.state.viewer.scene
    before = scene.camera_pose()[:3, 3]
    _event(server, {"type": "scroll", "n": 2})
    assert not np.allclose(before, scene.camera_pose()[:3, 3])


def test_web_key_controls_roundtrip(server):
    v = server.state.viewer
    exp0 = v.scene.manual_exposure
    out = _event(server, {"type": "key", "key": "+"})
    assert v.scene.manual_exposure != exp0
    assert "ssao=on" in out["status"] or "ssao=off" in out["status"]
    ssao0 = v.ssao_enabled
    _event(server, {"type": "key", "key": "o"})
    assert v.ssao_enabled is (not ssao0)
    _event(server, {"type": "key", "key": "o"})  # restore


def test_web_tick_steps_physics_when_running(server):
    v = server.state.viewer
    it0 = v.sim_iteration
    _event(server, {"type": "key", "key": " "})  # run
    _event(server, {"type": "tick"})
    assert v.sim_iteration == it0 + 1
    _event(server, {"type": "key", "key": " "})  # pause
    seq = _event(server, {"type": "tick"})["seq"]
    assert _event(server, {"type": "tick"})["seq"] == seq  # paused: no frames


def test_web_bad_routes(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/nope")
    assert ei.value.code == 404
    req = urllib.request.Request(server.url + "event", data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_handle_event_matches_jax():
    """The same events through both packages' ``_ViewerState`` (no server):
    equal replies, camera poses within 1e-5, the same physics state."""
    states = []
    for pkg, mod, web in ((jsl, jviewer, jweb), (sl, pviewer, pweb)):
        scene = _cube_scene(pkg, (64, 48), [0.8, 0.6, 1.5], [0.0, 0.0, 0.0], z=0.3, physics=True)
        states.append(web._ViewerState(mod.Viewer(scene)))
    events = [
        {"type": "tick"}, {"type": "drag_start", "x": 30.0, "y": 40.0},
        {"type": "drag", "x": 90.0, "y": 60.0}, {"type": "drag", "x": 90.0, "y": 60.0},
        {"type": "drag_end"}, {"type": "drag", "x": 10.0, "y": 10.0},
        {"type": "scroll", "n": 2}, {"type": "scroll", "n": -1}, {"type": "scroll", "n": 0},
        {"type": "key", "key": "+"}, {"type": "key", "key": "o"}, {"type": "key", "key": "i"},
        {"type": "key", "key": "m"}, {"type": "key", "key": "?"}, {"type": "key", "key": " "},
        {"type": "tick"}, {"type": "tick"}, {"type": "key", "key": "r"}, {"type": "nothing"},
    ]
    for ev in events:
        outs = [s.handle_event(dict(ev)) for s in states]
        assert outs[0] == outs[1], ev
        cams = [s.viewer.scene.camera_pose() for s in states]
        np.testing.assert_allclose(cams[1], cams[0], atol=1e-5)
        np.testing.assert_allclose(states[1].viewer.scene.objects[0].pose(),
                                   states[0].viewer.scene.objects[0].pose(), atol=1e-5)
    assert states[1].viewer.sim_iteration == states[0].viewer.sim_iteration == 0  # after "r"


def test_callback_app_state_and_app_server():
    """The generic window (``CallbackAppState`` + ``AppServer``): arrows map
    to matplotlib key names, the frame is the render function's PNG."""
    keys = []
    img = np.zeros((4, 6, 3), np.uint8)
    state = pweb.CallbackAppState(lambda: img, lambda k: keys.append(k) or True, lambda: "st")
    out = state.handle_event({"type": "key", "key": "ArrowLeft", "shift": True})
    assert out == {"seq": 1, "status": "st"} and keys == ["shift+left"]
    srv = pweb.AppServer(state, port=0).start()
    try:
        body = _get(srv, "/frame.png")[2]
        assert np.array_equal(decode_png_samples(body).samples.reshape(4, 6, 3), img)
        assert json.loads(_get(srv, "/state")[2]) == {"seq": 1, "status": "st"}
    finally:
        srv.close()
