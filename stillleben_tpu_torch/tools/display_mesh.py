"""Render a mesh file from a turntable of viewpoints and write a PNG
contact sheet (``tools/display_mesh.py`` on the port).

    python -m stillleben_tpu_torch.tools.display_mesh MESH [--views 4] \
        [--size 256] [--out display_mesh.png] [--physics] [--device cuda]

``--physics`` also writes the collision hulls beside ``--out``
(``Mesh.dump_physics_meshes``). The sheet is written by the port's
``encode_png``.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np


def turntable(mesh, views: int = 4, size: int = 256):
    """(the sheet (size, views * size, 3) uint8, the scene): ``RenderPass(
    ssao=False)`` of the centred mesh from ``views`` eyes on a circle at 1.2
    times the distance that fits its diameter, 0.4 of it up."""
    import stillleben_tpu_torch as sl

    mesh.center_bbox()
    diameter = mesh.bbox.diagonal
    scene = sl.Scene((size, size))
    scene.add_object(sl.Object(mesh))
    scene.choose_random_light_direction()
    rp = sl.RenderPass(ssao=False)
    dist = scene.min_dist_for_object_diameter(diameter) * 1.2
    tiles = []
    for i in range(views):
        a = 2 * np.pi * i / views
        eye = np.array([np.cos(a) * dist, np.sin(a) * dist, 0.4 * dist])
        scene.set_camera_look_at(eye, [0, 0, 0])
        tiles.append(rp.render(scene).rgb()[..., :3].cpu().numpy())
    return np.concatenate(tiles, axis=1), scene


def main(argv=None):
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.image import encode_png
    from stillleben_tpu_torch.assets.writers import atomic_write

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("mesh", help="mesh file (.gltf/.glb/.obj/.ply/...)")
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--out", default="display_mesh.png")
    parser.add_argument("--physics", action="store_true",
                        help="also dump collision hulls next to --out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    sl.init(device=args.device)
    mesh = sl.Mesh(args.mesh, physics=args.physics)
    sheet, _ = turntable(mesh, args.views, args.size)
    atomic_write(args.out, encode_png(np.ascontiguousarray(sheet)))
    print(f"wrote {args.out} ({args.views} views, diameter {mesh.bbox.diagonal:.3f})")
    if args.physics:
        prefix = str(pathlib.Path(args.out).with_suffix("")) + "_hull_"
        mesh.dump_physics_meshes(prefix)
        print(f"wrote collision hulls to {prefix}*.obj")
    return sheet


if __name__ == "__main__":
    main()
