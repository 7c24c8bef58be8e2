"""Interactive viewer (reference src/viewer.cpp + python ``sl.view(scene)``).

Counterpart of ``stillleben_tpu/viewer.py``. The viewer renders through
``RenderPass`` on the context's device (the card: the camera and shadow
passes launch the cell-raster kernel) and reads the result tensors to host
numpy for its dashboard. The headless ``run()`` writes the PNG with the
port's own encoder; the window imports matplotlib only when it opens.

The reference opens an X11 window with an imgui dashboard: a 2x2 grid of
RGB / normals / instance segmentation / object coordinates, physics controls
("Reset objects", "Run physics freely", tabletop-sim step visualization),
shading combo, exposure slider, instances/classes checkbox, and an arcball
camera whose pose writes back into the scene (src/viewer.cpp:534-760,
src/utils/arc_ball.cpp).

This viewer provides the same controls on headless hosts:

* **Interactive** (display present): a matplotlib window with the 2x2
  dashboard, arcball drag on any quadrant (pose written back to the scene),
  scroll-wheel dolly, and keyboard controls —
  ``space`` run/pause physics, ``r`` reset objects, ``t`` tabletop-sim step
  visualization, ``m`` shading mode cycle, ``o`` SSAO toggle, ``i``
  instances/classes toggle, ``+``/``-`` exposure.
* **Headless**: the same Viewer object is fully scriptable (``step()``,
  ``reset_objects()``, ``toggle_simulation()``, ...) and ``run()`` falls back
  to writing the dashboard PNG.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from .assets.image import write_png


def _colorize_instances(inst: np.ndarray) -> np.ndarray:
    """Stable per-instance colors (golden-ratio hue walk — the role of
    ViewerShader's per-index colorization, viewer_shader.frag:22-54)."""
    import colorsys

    out = np.zeros(inst.shape + (3,), np.float32)
    for idx in np.unique(inst):
        if idx == 0:
            continue
        h = (idx * 0.61803398875) % 1.0
        out[inst == idx] = colorsys.hsv_to_rgb(h, 0.8, 1.0)
    return out


def _colorize_coords(coords: np.ndarray, valid: np.ndarray) -> np.ndarray:
    c = np.where(valid[..., None], coords, 0.0)
    lo = c.min(axis=(0, 1), keepdims=True)
    hi = c.max(axis=(0, 1), keepdims=True)
    rng = np.where(hi - lo < 1e-9, 1.0, hi - lo)
    return np.where(valid[..., None], (c - lo) / rng, 0.0)


class Viewer:
    """Scriptable core + optional matplotlib front-end."""

    SHADING_MODES = ("pbr", "flat")
    SIM_DT = 1.0 / 25.0 / 4.0  # the reference's substep (scene.cpp:682-684)

    def __init__(self, scene):
        self.scene = scene
        self.shading = "pbr"
        self.ssao_enabled = True
        self.show_instances = True  # vs class segmentation
        self.run_simulation = False
        self.sim_iteration = 0
        self._initial_poses = [o.pose() for o in scene.objects]
        self._render_pass = None
        self._rp_key = None

    # -- physics controls (reference viewer.cpp menu) -----------------------------

    def reset_objects(self) -> None:
        """'Reset objects' button: restore the poses at viewer start."""
        for o, p in zip(self.scene.objects, self._initial_poses):
            o.set_pose(p)
        self.sim_iteration = 0

    def toggle_simulation(self) -> None:
        self.run_simulation = not self.run_simulation

    def step(self) -> None:
        """One frame: advance physics if running (4 substeps per displayed
        frame like the reference's 25 FPS loop)."""
        if self.run_simulation:
            for _ in range(4):
                self.scene.simulate(self.SIM_DT)
            self.sim_iteration += 1

    def tabletop_step_visualization(self, callback=None) -> None:
        """Run simulate_tabletop_scene with per-iteration pose writeback
        (the reference's visCallback path, scene.cpp:612-759)."""
        def cb(i):
            self.sim_iteration = i
            if callback is not None:
                callback(i)

        self.scene.simulate_tabletop_scene(vis_cb=cb)

    def cycle_shading(self) -> None:
        i = self.SHADING_MODES.index(self.shading)
        self.shading = self.SHADING_MODES[(i + 1) % len(self.SHADING_MODES)]

    def adjust_exposure(self, delta: float) -> None:
        e = self.scene.manual_exposure
        e = 1.0 if e < 0 else e
        self.scene.manual_exposure = max(0.01, e * (2.0 ** delta))

    # -- rendering ------------------------------------------------------------------

    def _get_render_pass(self):
        from .render.render_pass import RenderPass

        key = (self.shading, self.ssao_enabled)
        if self._render_pass is None or self._rp_key != key:
            self._render_pass = RenderPass(
                shading=self.shading, ssao=self.ssao_enabled
            )
            self._rp_key = key
        return self._render_pass

    def dashboard(self) -> np.ndarray:
        """Render the 2x2 dashboard image (H*2, W*2, 3) uint8."""
        res = self._get_render_pass().render(self.scene)
        rgb = res.rgb().cpu().numpy()[..., :3]
        normals = res.normals().cpu().numpy()
        seg = (res.instance_index() if self.show_instances else res.class_index()).cpu().numpy()
        coords = res.coordinates().cpu().numpy()
        valid = res.instance_index().cpu().numpy() != 0

        n_img = np.where(
            valid[..., None], (normals[..., :3] * 0.5 + 0.5) * 255, 0
        ).astype(np.uint8)
        i_img = (_colorize_instances(seg) * 255).astype(np.uint8)
        c_img = (_colorize_coords(coords, valid) * 255).astype(np.uint8)

        top = np.concatenate([rgb, n_img], axis=1)
        bottom = np.concatenate([i_img, c_img], axis=1)
        return np.concatenate([top, bottom], axis=0)

    # -- interaction core (shared by the window loop and scripted replay) ---------

    def _make_arcball(self):
        """Arcball around the scene content, seeded from the current camera
        (reference viewer.cpp arcball over the framebuffer)."""
        from .utils.arcball import ArcBall

        centers = [o.pose()[:3, 3] for o in self.scene.objects]
        center = np.mean(centers, axis=0) if centers else np.zeros(3)
        cam = self.scene.camera_pose()
        W, H = self.scene.viewport
        return ArcBall(cam[:3, 3], center, -cam[:3, 1], (2 * W, 2 * H))

    def handle_key(self, key: str) -> bool:
        """One keyboard control (the reference viewer's imgui menu actions,
        viewer.cpp). Returns True when the key changed viewer state."""
        if key == " ":
            self.toggle_simulation()
        elif key == "r":
            self.reset_objects()
        elif key == "t":
            self.tabletop_step_visualization()
        elif key == "m":
            self.cycle_shading()
        elif key == "o":
            self.ssao_enabled = not self.ssao_enabled
        elif key == "i":
            self.show_instances = not self.show_instances
        elif key in ("+", "="):
            self.adjust_exposure(0.5)
        elif key == "-":
            self.adjust_exposure(-0.5)
        else:
            return False
        return True

    def play_script(self, events, frame_cb=None):
        """Drive the viewer through a saved interaction script — the headless
        equivalent of the window event loop, running the SAME handlers
        (arcball drag/zoom, keyboard controls, physics stepping). Events:

        - ``("key", k)``: keyboard control (see handle_key)
        - ``("drag", (x0, y0), (x1, y1), steps)``: arcball mouse drag
        - ``("scroll", n)``: n zoom clicks (negative = out)
        - ``("frames", n)``: n timer ticks (physics advances when running)

        Returns the list of dashboard frames rendered after each
        state-changing event (``frame_cb(event, frame)`` is called per frame).
        """
        ball = self._make_arcball()
        frames = []

        def emit(ev):
            img = self.dashboard()
            frames.append(img)
            if frame_cb is not None:
                frame_cb(ev, img)

        for ev in events:
            kind = ev[0]
            if kind == "key":
                if self.handle_key(ev[1]):
                    emit(ev)
            elif kind == "drag":
                (x0, y0), (x1, y1), steps = ev[1], ev[2], ev[3]
                ball.start(x0, y0)
                moved = False
                for s in range(1, steps + 1):
                    f = s / steps
                    moved |= bool(
                        ball.drag(x0 + (x1 - x0) * f, y0 + (y1 - y0) * f)
                    )
                ball.stop()
                if moved:
                    self.scene.set_camera_pose(ball.camera_pose())
                    emit(ev)
            elif kind == "scroll":
                n = ev[1]
                for _ in range(abs(n)):
                    ball.zoom(1.1 if n > 0 else 1 / 1.1)
                self.scene.set_camera_pose(ball.camera_pose())
                emit(ev)
            elif kind == "frames":
                for _ in range(ev[1]):
                    self.step()
                emit(ev)
            else:
                raise ValueError(f"unknown viewer script event: {ev!r}")
        return frames

    # -- interactive front-end --------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 8645, block: bool = True):
        """Serve the interactive viewer window over HTTP (the headless-host
        equivalent of the reference's X11 window — see viewer_web.py).
        ``block=False`` starts a daemon thread and returns the server."""
        from .viewer_web import ViewerServer

        srv = ViewerServer(self, host, port)
        if block:
            srv.serve_forever()
        else:
            srv.start()
        return srv

    def run(self, out_path: str | None = None):
        """Interactive window when a display exists; PNG fallback otherwise."""
        if bool(os.environ.get("DISPLAY")):
            try:
                return self._run_window()
            except Exception as e:  # no usable backend — fall through
                print(f"Viewer: interactive backend unavailable ({e})")
        img = self.dashboard()
        out_path = out_path or os.path.join(tempfile.gettempdir(), "stillleben_tpu_viewer.png")
        write_png(out_path, img)
        print(f"Viewer (headless): dashboard written to {out_path}")

    def _run_window(self):
        plt = _window_backend()
        ball = self._make_arcball()

        fig, ax = plt.subplots(figsize=(12, 9))
        fig.canvas.manager.set_window_title("stillleben_tpu viewer")
        im = ax.imshow(self.dashboard())
        ax.axis("off")
        status = ax.set_title(self._status_line())
        dirty = {"flag": False}

        def redraw():
            im.set_data(self.dashboard())
            status.set_text(self._status_line())
            fig.canvas.draw_idle()

        def on_press(ev):
            if ev.x is not None:
                ball.start(ev.x, fig.bbox.height - ev.y)

        def on_move(ev):
            if ev.button == 1 and ev.x is not None:
                if ball.drag(ev.x, fig.bbox.height - ev.y):
                    self.scene.set_camera_pose(ball.camera_pose())
                    dirty["flag"] = True

        def on_release(_ev):
            ball.stop()

        def on_scroll(ev):
            ball.zoom(1.1 if ev.button == "up" else 1 / 1.1)
            self.scene.set_camera_pose(ball.camera_pose())
            dirty["flag"] = True

        def on_key(ev):
            if ev.key == "t":  # live per-iteration redraw needs the window cb
                self.tabletop_step_visualization(callback=lambda i: redraw())
                dirty["flag"] = True
            elif self.handle_key(ev.key or ""):
                dirty["flag"] = True

        def on_timer():
            if self.run_simulation:
                self.step()
                dirty["flag"] = True
            if dirty["flag"]:
                dirty["flag"] = False
                redraw()

        fig.canvas.mpl_connect("button_press_event", on_press)
        fig.canvas.mpl_connect("motion_notify_event", on_move)
        fig.canvas.mpl_connect("button_release_event", on_release)
        fig.canvas.mpl_connect("scroll_event", on_scroll)
        fig.canvas.mpl_connect("key_press_event", on_key)
        timer = fig.canvas.new_timer(interval=40)  # the reference's 25 FPS
        timer.add_callback(on_timer)
        timer.start()
        plt.show()

    def _status_line(self) -> str:
        run = f"running: {self.sim_iteration}" if self.run_simulation else "paused"
        return (
            f"RGB | normals / {'instances' if self.show_instances else 'classes'}"
            f" | coords — {self.shading}, ssao={'on' if self.ssao_enabled else 'off'},"
            f" physics {run}  [space/r/t/m/o/i/+/-]"
        )


def _window_backend():
    """matplotlib's pyplot on the Tk backend: the window path of ``Viewer``
    and of the alignment tool (``tools/align_mesh.py``)."""
    import matplotlib

    matplotlib.use("TkAgg")
    import matplotlib.pyplot as plt

    return plt


def view(scene, web: bool = False, port: int = 8645):
    """(reference python/src/py_viewer.cpp ``sl.view``); ``web=True`` serves
    the interactive window over HTTP instead of opening a local one."""
    if web:
        Viewer(scene).serve(port=port)
    else:
        Viewer(scene).run()
