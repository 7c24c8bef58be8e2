"""Scripted viewer demonstration (``tools/viewer_demo.py`` on the port):
drives ``Viewer`` through a saved interaction script (arcball drags,
zoom, keyboard controls, physics stepping) headless and writes the
dashboard frames.

    python -m stillleben_tpu_torch.tools.viewer_demo [out_dir] [--size 256] \
        [--device cuda]

Writes out_dir/frame_NN.png and a contact-sheet strip
(``contact_sheet.png``) through the port's ``encode_png``, and prints one
line per frame with the viewer state it produced.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def demo_script(W, H):
    """The JAX script's interaction (tools/viewer_demo.py:25-40); coordinates
    in the arcball's (2W, 2H) screen space."""
    return [
        ("drag", (W, H), (int(W * 1.5), H), 8),          # orbit right
        ("drag", (W, H), (W, int(H * 0.6)), 6),          # orbit up
        ("scroll", 3),                                   # zoom in
        ("key", " "),                                    # start physics
        ("frames", 10),                                  # let it run
        ("key", " "),                                    # pause
        ("key", "m"),                                    # flat shading
        ("key", "m"),                                    # back to pbr
        ("key", "i"),                                    # class segmentation
        ("key", "+"),                                    # exposure up
        ("key", "r"),                                    # reset objects
        ("scroll", -2),                                  # zoom out
    ]


def build_scene(size: int):
    """Cube, sphere, cube settled on the table, seed 7, a random camera."""
    import stillleben_tpu_torch as sl

    scene = sl.Scene((size, size))
    scene.seed(7)
    scene.ambient_light = (0.3, 0.3, 0.3)
    cube = sl.Mesh("primitive://cube")
    cube.scale_to_bbox_diagonal(0.2)
    sphere = sl.Mesh("primitive://sphere")
    sphere.scale_to_bbox_diagonal(0.18)
    for m in (cube, sphere, cube):
        scene.add_object(sl.Object(m))
    scene.simulate_tabletop_scene()
    scene.choose_random_camera_pose()
    return scene


def play(scene, out_dir: str, out=print) -> list[np.ndarray]:
    """Play ``demo_script`` on a ``Viewer`` of ``scene``, writing each frame
    and the strip of the first six; returns the frames."""
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.image import encode_png
    from stillleben_tpu_torch.assets.writers import atomic_write

    os.makedirs(out_dir, exist_ok=True)
    v = sl.Viewer(scene)
    W, H = scene.viewport
    idx = {"i": 0}

    def save(ev, img):
        atomic_write(os.path.join(out_dir, f"frame_{idx['i']:02d}.png"), encode_png(img))
        out(f"  [{idx['i']:02d}] {ev[0]:<7} -> {v._status_line()}")
        idx["i"] += 1

    frames = v.play_script(demo_script(W, H), frame_cb=save)
    strip = np.concatenate(frames[: min(6, len(frames))], axis=1)
    atomic_write(os.path.join(out_dir, "contact_sheet.png"), encode_png(strip))
    out(f"viewer_demo: {len(frames)} frames -> {out_dir}")
    return frames


def main(argv=None):
    import stillleben_tpu_torch as sl

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("out_dir", nargs="?", default="viewer_demo")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sl.init(device=args.device)
    return play(build_scene(args.size), args.out_dir)


if __name__ == "__main__":
    main()
