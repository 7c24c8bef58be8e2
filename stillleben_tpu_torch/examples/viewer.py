"""Interactive viewer example (counterpart of ``examples/viewer.py``).

Four procedural blobs (the JAX example's bunny is not in the repository)
settled on the table and shown in ``sl.view``: a local window when a
display exists, else the headless dashboard PNG. ``--web [PORT]`` serves
the interactive window over HTTP instead.

    python -m stillleben_tpu_torch.examples.viewer [--device cpu] [--web [PORT]]
"""

from __future__ import annotations

import argparse
import shutil
import tempfile


def build_scene(device: str = "cuda", size: tuple[int, int] = (640, 480), objects: int = 4,
                subdiv: int = 6):
    """The settled, lit scene the viewer shows."""
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.procedural import write_meshes

    sl.init(device=device)
    meshes = tempfile.mkdtemp(prefix="sl_example_")
    mesh = sl.Mesh(write_meshes(meshes, subdiv=subdiv)["blob"])
    shutil.rmtree(meshes, ignore_errors=True)
    mesh.scale_to_bbox_diagonal(0.5)

    scene = sl.Scene(size)
    scene.seed(0)
    for _ in range(objects):
        scene.add_object(sl.Object(mesh))

    scene.simulate_tabletop_scene()
    scene.choose_random_light_direction()
    return scene


def main(argv=None):
    import stillleben_tpu_torch as sl

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--web", type=int, nargs="?", const=8645, default=None, metavar="PORT")
    parser.add_argument("--size", type=int, nargs=2, default=(640, 480), metavar=("W", "H"))
    parser.add_argument("--objects", type=int, default=4)
    parser.add_argument("--subdiv", type=int, default=6, help="the blob's subdivisions")
    parser.add_argument("--out", default=None, help="the headless dashboard's PNG")
    a = parser.parse_args(argv)
    scene = build_scene(a.device, tuple(a.size), a.objects, a.subdiv)
    if a.web is not None:
        sl.view(scene, web=True, port=a.web)
    else:
        sl.Viewer(scene).run(a.out)
    return scene


if __name__ == "__main__":
    main()
