"""Browser front-end for the :class:`~stillleben_tpu_torch.viewer.Viewer`: a
real interactive viewer window on headless hosts.

Counterpart of ``stillleben_tpu/viewer_web.py``, on the stdlib's
``http.server``; frames are encoded by the port's PNG encoder. Renders run
on the server's request threads, under the state's lock, on the context's
device.

The reference viewer is an X11 window with an imgui dashboard
(reference src/viewer.cpp: arcball camera writeback, physics controls,
shading/exposure/segmentation toggles). A GPU host is often a remote,
display-less machine, so the equivalent here serves the same dashboard +
controls over HTTP to any browser:

* the 2x2 dashboard (RGB / normals / instances / coordinates) streams as
  PNG frames re-rendered on state changes only,
* mouse drag on the canvas drives the SAME :class:`ArcBall` as the
  matplotlib window (camera pose written back into the scene),
* the wheel dollies, and the keyboard controls are identical
  (``space``/``r``/``t``/``m``/``o``/``i``/``+``/``-`` — see
  ``Viewer.handle_key``),
* a 10 Hz tick advances physics while "run simulation" is on (the
  reference's 25 FPS timer loop, viewer.cpp draw loop).

Everything is stdlib (``http.server`` + a lock around the viewer); no new
dependencies. Start with ``sl.Viewer(scene).serve()`` or
``sl.view(scene, web=True)``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .assets.image import encode_png

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>stillleben_tpu viewer</title>
<style>
 body { margin: 0; background: #111; color: #ddd;
        font: 13px/1.4 system-ui, sans-serif; }
 #bar { padding: 6px 10px; background: #1b1b1b; white-space: pre; }
 #frame { display: block; max-width: 100vw; cursor: grab; }
 kbd { background: #333; border-radius: 3px; padding: 0 4px; }
</style></head><body>
<div id="bar">connecting…</div>
<img id="frame" draggable="false">
<script>
const img = document.getElementById('frame');
const bar = document.getElementById('bar');
let seq = -1, dragging = false, inflight = false, queued = null;

async function post(ev) {
  // serialize events: drags arrive faster than renders complete
  if (inflight) { queued = ev; return; }
  inflight = true;
  try {
    const r = await fetch('/event', {method: 'POST', body: JSON.stringify(ev)});
    apply(await r.json());
  } finally {
    inflight = false;
    if (queued !== null) { const q = queued; queued = null; post(q); }
  }
}
function apply(state) {
  bar.textContent = state.status;
  if (state.seq !== seq) { seq = state.seq; img.src = '/frame.png?seq=' + seq; }
}
function pos(e) {
  const r = img.getBoundingClientRect();
  // event coords scaled to the dashboard's pixel grid (the arcball's window)
  return {x: (e.clientX - r.left) * (img.naturalWidth / r.width),
          y: (e.clientY - r.top) * (img.naturalHeight / r.height)};
}
img.addEventListener('mousedown', e => {
  dragging = true; img.style.cursor = 'grabbing';
  post({type: 'drag_start', ...pos(e)}); e.preventDefault();
});
window.addEventListener('mousemove', e => {
  if (dragging) post({type: 'drag', ...pos(e)});
});
window.addEventListener('mouseup', () => {
  if (dragging) { dragging = false; img.style.cursor = 'grab';
                  post({type: 'drag_end'}); }
});
img.addEventListener('wheel', e => {
  post({type: 'scroll', n: e.deltaY < 0 ? 1 : -1}); e.preventDefault();
});
window.addEventListener('keydown', e => {
  if (e.target.tagName !== 'INPUT')
    post({type: 'key', key: e.key, shift: e.shiftKey});
});
setInterval(() => post({type: 'tick'}), 100);
post({type: 'tick'});
</script></body></html>"""


class _ViewerState:
    """Shared server state: the viewer, its arcball, and a frame cache keyed
    by a sequence number so unchanged frames are never re-rendered."""

    def __init__(self, viewer):
        self.viewer = viewer
        self.lock = threading.Lock()
        self.ball = viewer._make_arcball()
        self.seq = 0
        self._png_seq = -1
        self._png = b""

    def bump(self):
        self.seq += 1

    def status(self) -> str:
        return self.viewer._status_line()

    def frame_png(self) -> bytes:
        with self.lock:
            if self._png_seq != self.seq:
                self._png = encode_png(self.viewer.dashboard())
                self._png_seq = self.seq
            return self._png

    def handle_event(self, ev: dict) -> dict:
        v = self.viewer
        with self.lock:
            t = ev.get("type")
            if t == "drag_start":
                self.ball.start(float(ev["x"]), float(ev["y"]))
            elif t == "drag":
                if self.ball.drag(float(ev["x"]), float(ev["y"])):
                    v.scene.set_camera_pose(self.ball.camera_pose())
                    self.bump()
            elif t == "drag_end":
                self.ball.stop()
            elif t == "scroll":
                n = int(ev.get("n", 0))
                for _ in range(abs(n)):
                    self.ball.zoom(1.1 if n > 0 else 1 / 1.1)
                if n:
                    v.scene.set_camera_pose(self.ball.camera_pose())
                    self.bump()
            elif t == "key":
                key = ev.get("key", "")
                if key == "t":
                    v.tabletop_step_visualization()
                    self.bump()
                elif v.handle_key(key):
                    self.bump()
            elif t == "tick":
                if v.run_simulation:
                    v.step()
                    self.bump()
            return {"seq": self.seq, "status": v._status_line()}


def _make_handler(state: _ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *_a):  # quiet: the terminal is the program's log
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif self.path.startswith("/frame.png"):
                self._send(200, state.frame_png(), "image/png")
            elif self.path.startswith("/state"):
                with state.lock:
                    body = json.dumps(
                        {"seq": state.seq, "status": state.status()}
                    ).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/event":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", "0"))
            try:
                ev = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._send(400, b"bad json", "text/plain")
                return
            try:
                out = state.handle_event(ev)
            except Exception as e:  # surface to the page, keep serving
                self._send(
                    500, json.dumps({"error": str(e)}).encode(),
                    "application/json",
                )
                return
            self._send(200, json.dumps(out).encode(), "application/json")

    return Handler


class CallbackAppState:
    """Adapter so simple key-driven tools (align_mesh ``--web``) get the same
    HTTP window: ``render_fn() -> uint8 image``, ``on_key(key) -> bool``
    (True = state changed, re-render), ``status_fn() -> str``. Browser arrow
    keys arrive as ``left``/``shift+left`` etc. (matplotlib key names, so the
    matplotlib window and the web window share one handler)."""

    _ARROWS = {"ArrowLeft": "left", "ArrowRight": "right",
               "ArrowUp": "up", "ArrowDown": "down"}

    def __init__(self, render_fn, on_key, status_fn):
        self.render_fn = render_fn
        self.on_key = on_key
        self.status_fn = status_fn
        self.lock = threading.Lock()
        self.seq = 0
        self._png_seq = -1
        self._png = b""

    def status(self) -> str:
        return self.status_fn()

    def frame_png(self) -> bytes:
        with self.lock:
            if self._png_seq != self.seq:
                self._png = encode_png(self.render_fn())
                self._png_seq = self.seq
            return self._png

    def handle_event(self, ev: dict) -> dict:
        with self.lock:
            if ev.get("type") == "key":
                key = self._ARROWS.get(ev.get("key", ""), ev.get("key", ""))
                if ev.get("shift") and key in ("left", "right", "up", "down"):
                    key = "shift+" + key
                if self.on_key(key):
                    self.seq += 1
            return {"seq": self.seq, "status": self.status_fn()}


class AppServer:
    """Generic HTTP window around any state object exposing ``frame_png()``
    and ``handle_event(ev) -> {"seq", "status"}`` (ViewerServer's engine)."""

    def __init__(self, state, host: str = "127.0.0.1", port: int = 8645):
        self.state = state
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(state))
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        print(f"stillleben_tpu viewer: {self.url}  (ctrl-c to stop)")
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class ViewerServer(AppServer):
    """HTTP wrapper around a Viewer; ``.port`` is bound at construction so
    callers (and tests) can pass ``port=0`` for an ephemeral port."""

    def __init__(self, viewer, host: str = "127.0.0.1", port: int = 8645):
        super().__init__(_ViewerState(viewer), host, port)
