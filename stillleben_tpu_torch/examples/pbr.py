"""PBR heap with IBL lighting (counterpart of ``examples/pbr.py``).

The JAX example heaps the Stanford bunny, which is not in the repository:
this one heaps the in-repo procedural blob (``assets/procedural.py``). The
settled heap of ``PBR_OBJECTS`` blobs (8) is lit by an sIBL light map when
``PBR_IBL`` names one, else by a random directional light, rendered at
640x480 (``PBR_FULL``: 1920x1080; ``--size W H`` sets another) and
written as JPEG by the port's encoder. The environment variables are the
JAX example's.

    python -m stillleben_tpu_torch.examples.pbr [--device cpu] [--out pbr.jpeg]
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import tempfile

import numpy as np


def run(out: str = "pbr.jpeg", device: str = "cuda", objects: int = 8,
        size: tuple[int, int] = (640, 480), ibl: str | None = None, subdiv: int = 6) -> str:
    """Build, settle, light, render and save the heap; returns ``out``."""
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.jpeg import encode_jpeg
    from stillleben_tpu_torch.assets.procedural import write_meshes

    sl.init(device=device)
    rng = random.Random(0)
    meshes = tempfile.mkdtemp(prefix="sl_example_")
    mesh = sl.Mesh(write_meshes(meshes, subdiv=subdiv)["blob"])
    shutil.rmtree(meshes, ignore_errors=True)
    mesh.scale_to_bbox_diagonal(0.5)

    scene = sl.Scene(tuple(size))
    scene.seed(0)
    for _ in range(objects):
        obj = sl.Object(mesh)
        obj.metallic = rng.random()
        obj.roughness = rng.random()
        scene.add_object(obj)

    # let them fall in a heap
    scene.simulate_tabletop_scene()

    # lighting: sIBL environment map if given, else a random directional light
    if ibl:
        scene.light_map = sl.LightMap(ibl, device=device)
    else:
        scene.choose_random_light_direction()

    scene.background_plane_size = np.array([3.0, 3.0])
    scene.background_color = np.array([0.1, 0.1, 0.1, 1.0])

    if os.environ.get("DISPLAY"):
        sl.view(scene)

    result = sl.RenderPass().render(scene)
    print("Resulting RGB frame:", tuple(result.rgb().shape))
    print("Resulting segmentation frame:", tuple(result.instance_index().shape))
    with open(out, "wb") as f:
        f.write(encode_jpeg(result.rgb()[..., :3].cpu().numpy()))
    print(f"wrote {out}")
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="pbr.jpeg")
    parser.add_argument("--size", type=int, nargs=2, metavar=("W", "H"),
                        help="render size (default 640x480, or 1920x1080 with PBR_FULL)")
    parser.add_argument("--subdiv", type=int, default=6, help="the blob's subdivisions")
    a = parser.parse_args(argv)
    size = a.size or ((1920, 1080) if os.environ.get("PBR_FULL") else (640, 480))
    return run(a.out, a.device, int(os.environ.get("PBR_OBJECTS", "8")), size,
               os.environ.get("PBR_IBL"), a.subdiv)


if __name__ == "__main__":
    main()
