"""Author ``<mesh>.pretransform`` sidecar files (``tools/align_mesh.py`` on
the port): a batch command line and an interactive alignment session.

Batch: compose the rotations (x, then y, then z), the uniform scale and the
translation, then ``--diagonal`` and ``--center``; ``Mesh.pretransform``
checks the scale is uniform; ``--write`` writes the sidecar next to the
mesh (else a dry run):

    python -m stillleben_tpu_torch.tools.align_mesh model.obj --rot-x 90 \
        --scale 0.001 --center --write [--device cuda]

``--interactive`` opens the port's ``Viewer`` window path (matplotlib)
with the alignment keys; ``--web`` serves the same session over HTTP
(``viewer_web.AppServer`` with a ``CallbackAppState``):

    axis select  x / y / z
    rotate       left / right (5 deg), shift+left/right (90 deg)
    translate    up / down (1 cm), shift+up/down (10 cm) along the axis
    scale        + / -  (x1.1 each)
    center bbox  c       unit-diagonal scale  u
    write        w       print matrix  p

Each frame is ``debug.render_debug_image``: the mesh with its axes.
"""

from __future__ import annotations

import argparse

import numpy as np


def _rotation(axis: int, degrees: float) -> np.ndarray:
    import torch

    from ..core import math as m

    fn = (m.rotation_x, m.rotation_y, m.rotation_z)[axis]
    return fn(torch.tensor(np.deg2rad(degrees), dtype=torch.float32)).numpy()[:3, :3]


def compose(rot_x: float = 0.0, rot_y: float = 0.0, rot_z: float = 0.0,
            translate=(0.0, 0.0, 0.0), scale: float = 1.0) -> np.ndarray:
    """The batch pretransform before ``--diagonal`` / ``--center``:
    ``Rz @ Ry @ Rx`` times the scale, then the translation."""
    R = _rotation(2, rot_z) @ _rotation(1, rot_y) @ _rotation(0, rot_x)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R * scale
    T[:3, 3] = translate
    return T


def write_pretransform(mesh_path: str, P: np.ndarray) -> str:
    out = str(mesh_path) + ".pretransform"
    with open(out, "w") as f:
        for row in P:
            f.write(" ".join(f"{v:.8g}" for v in row) + "\n")
    print(f"wrote {out}")
    return out


class AlignSession:
    """The interactive alignment's operations (each composed to the LEFT of
    the current pretransform, i.e. applied after it), its keys, and its
    render."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis = 2  # z

    def _compose(self, D: np.ndarray) -> None:
        self.mesh.pretransform = D.astype(np.float32) @ self.mesh.pretransform

    def rotate(self, axis: int, degrees: float) -> None:
        D = np.eye(4, dtype=np.float32)
        D[:3, :3] = _rotation(axis, degrees)
        self._compose(D)

    def translate(self, axis: int, dist: float) -> None:
        D = np.eye(4, dtype=np.float32)
        D[axis, 3] = dist
        self._compose(D)

    def scale(self, factor: float) -> None:
        D = np.eye(4, dtype=np.float32) * factor
        D[3, 3] = 1.0
        self._compose(D)

    def center_bbox(self) -> None:
        self.mesh.center_bbox()

    def unit_diagonal(self) -> None:
        self.mesh.scale_to_bbox_diagonal(1.0)

    def write(self) -> str:
        return write_pretransform(self.mesh.filename, self.mesh.pretransform)

    def handle_key(self, k: str) -> bool:
        """One keyboard edit; True when the state changed (render again)."""
        if k in ("x", "y", "z"):
            self.axis = "xyz".index(k)
        elif k == "left":
            self.rotate(self.axis, -5.0)
        elif k == "right":
            self.rotate(self.axis, 5.0)
        elif k == "shift+left":
            self.rotate(self.axis, -90.0)
        elif k == "shift+right":
            self.rotate(self.axis, 90.0)
        elif k == "up":
            self.translate(self.axis, 0.01)
        elif k == "down":
            self.translate(self.axis, -0.01)
        elif k == "shift+up":
            self.translate(self.axis, 0.1)
        elif k == "shift+down":
            self.translate(self.axis, -0.1)
        elif k in ("+", "="):
            self.scale(1.1)
        elif k == "-":
            self.scale(1 / 1.1)
        elif k == "c":
            self.center_bbox()
        elif k == "u":
            self.unit_diagonal()
        elif k == "w":
            self.write()
        elif k == "p":
            print(self.mesh.pretransform)
            return False
        else:
            return False
        return True

    def render(self, size=(480, 480)) -> np.ndarray:
        """The mesh and its axes at the current pretransform, (H, W, 3) uint8:
        the mesh alone, seen from (1.8, 1.2, 0.9) bbox diagonals, a random
        light."""
        import stillleben_tpu_torch as sl

        from ..debug import render_debug_image

        scene = sl.Scene(size)
        scene.add_object(sl.Object(self.mesh))
        d = max(self.mesh.bbox.diagonal, 1e-3)
        scene.set_camera_look_at([1.8 * d, 1.2 * d, 0.9 * d], [0, 0, 0])
        scene.choose_random_light_direction()
        self._scene = scene
        return render_debug_image(scene)[..., :3].cpu().numpy()

    def run_window(self):
        """The ``Viewer`` window path: a matplotlib window whose keys edit
        the pretransform."""
        from ..viewer import _window_backend

        plt = _window_backend()
        fig, ax = plt.subplots(figsize=(8, 8))
        im = ax.imshow(self.render())
        ax.axis("off")
        title = ax.set_title(self._status())

        def on_key(ev):
            if self.handle_key(ev.key or ""):
                im.set_data(self.render())
                title.set_text(self._status())
                fig.canvas.draw_idle()

        fig.canvas.mpl_connect("key_press_event", on_key)
        plt.show()

    def run_web(self, port: int = 8646, block: bool = True):
        """Serve the session over HTTP (the same keys as ``run_window``)."""
        from ..viewer_web import AppServer, CallbackAppState

        srv = AppServer(CallbackAppState(self.render, self.handle_key, self._status), port=port)
        if block:
            srv.serve_forever()
        else:
            srv.start()
        return srv

    def _status(self) -> str:
        b = self.mesh.bbox
        return (
            f"align_mesh — axis: {'xyz'[self.axis]}  diag: {b.diagonal:.4f}\n"
            "x/y/z axis · arrows rotate/translate (shift=coarse) · +/- scale ·"
            " c center · u unit-diag · w write"
        )


def main(argv=None):
    import stillleben_tpu_torch as sl

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("mesh")
    parser.add_argument("--rot-x", type=float, default=0.0, help="degrees")
    parser.add_argument("--rot-y", type=float, default=0.0)
    parser.add_argument("--rot-z", type=float, default=0.0)
    parser.add_argument("--translate", type=float, nargs=3, default=[0, 0, 0])
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--center", action="store_true",
                        help="center the bbox after the transform")
    parser.add_argument("--diagonal", type=float,
                        help="scale so the bbox diagonal equals this")
    parser.add_argument("--write", action="store_true",
                        help="write <mesh>.pretransform (else dry run)")
    parser.add_argument("--interactive", action="store_true",
                        help="open the visual alignment window")
    parser.add_argument("--web", action="store_true",
                        help="serve the alignment window over HTTP (headless hosts)")
    parser.add_argument("--port", type=int, default=8646)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    sl.init(device=args.device)
    mesh = sl.Mesh(args.mesh, physics=False)
    mesh.pretransform = compose(args.rot_x, args.rot_y, args.rot_z, args.translate, args.scale)
    if args.diagonal:
        mesh.scale_to_bbox_diagonal(args.diagonal)
    if args.center:
        mesh.center_bbox()

    P = mesh.pretransform
    print("pretransform:")
    print(P)
    print("bbox:", mesh.bbox)

    if args.web:
        AlignSession(mesh).run_web(port=args.port)
        return mesh
    if args.interactive:
        AlignSession(mesh).run_window()
        return mesh
    if args.write:
        write_pretransform(args.mesh, P)
    else:
        print("(dry run — pass --write to save)")
    return mesh


if __name__ == "__main__":
    main()
