"""The bench's "textured" composition on the port (``bench.py:57-136``).

Cube 0.2, sphere 0.15 and a dense mesh 0.25 (bounding-box diagonals, the
dense mesh centred), in the order ``[d, c, s] x 3 + [c]``, classes 1, 2, 3
for the dense mesh, cube and sphere, metallic and roughness drawn from
``default_rng(7)``; the synthetic sky (``procedural.sky_equirect``) with
the bench's one sun as the light map, and a 3 x 3 m background plane with
the 512^2 checker. The bench's dense mesh is the scanned bunny, which the
repository does not hold: the default here is the procedural blob of
81,920 faces (the textured one, its hulls cooked as one convex hull, as
``chip_smoke.py``'s bench-full configuration loads it); a path takes any
mesh file (the bunny where it exists).

The procedural meshes are written under the package's ``_build/tools``.
"""

from __future__ import annotations

import os

import numpy as np

from ..assets.native_build import BUILD_DIR

WIDTH, HEIGHT = 640, 480
N_OBJECTS = 10
SUBDIV = 6  # the procedural blob: 20 * 4^6 = 81,920 faces
# the sky's sun (bench.py:122-124)
SUN_DIRECTION = np.array([0.3, 0.5, -0.8], np.float32) / np.float32(np.linalg.norm([0.3, 0.5, -0.8]))
SUN_COLOR = np.array([3.0, 2.8, 2.5], np.float32)
MESH_DIR = os.path.join(BUILD_DIR, "tools", "meshes")


def load_meshes(dense: str | None = None, subdiv: int = SUBDIV):
    """(dense, cube, sphere, name of the dense mesh), scaled as the bench
    scales them. ``dense``: a mesh file, else the procedural blob."""
    from ..assets.mesh import Mesh
    from ..assets.procedural import write_meshes

    paths = write_meshes(MESH_DIR, subdiv=subdiv, seed=0)
    if dense is None:
        name = f"the procedural blob ({20 * 4 ** subdiv} faces)"
        mesh = Mesh(paths["blob_textured"], flags=Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL)
    else:
        name = dense
        mesh = Mesh(dense)
    mesh.center_bbox()
    mesh.scale_to_bbox_diagonal(0.25)
    cube = Mesh("primitive://cube")
    cube.scale_to_bbox_diagonal(0.2)
    sphere = Mesh("primitive://sphere")
    sphere.scale_to_bbox_diagonal(0.15)
    for i, m in enumerate((mesh, cube, sphere)):
        m.class_index = i + 1
    return mesh, cube, sphere, name


def add_objects(scene, meshes, object_cls) -> None:
    """The bench's objects of ``meshes`` = (dense, cube, sphere) in its order,
    with its seeded metallic and roughness overrides (bench.py:113-119);
    ``object_cls`` is the package's ``Object``."""
    dense, cube, sphere = meshes
    rng = np.random.default_rng(7)
    for mesh in ([dense, cube, sphere] * 3 + [cube])[:N_OBJECTS]:
        o = object_cls(mesh)
        o.metallic = float(rng.random())
        o.roughness = float(rng.random())
        scene.add_object(o)


def compose(meshes, device: str, size: tuple[int, int] = (WIDTH, HEIGHT)):
    """The scene of ``meshes`` = (dense, cube, sphere): the bench's order,
    overrides, light map and plane."""
    from ..assets.procedural import checker_texture, sky_equirect
    from ..assets.texture import Texture2D
    from ..render.light_map import LightMap
    from ..scene.scene import Object, Scene

    scene = Scene(size)
    scene.seed(0)
    add_objects(scene, meshes, Object)
    scene.light_map = LightMap.from_equirect(sky_equirect(), lights=[(SUN_DIRECTION, SUN_COLOR)],
                                             device=device)
    scene.background_plane_size = np.array([3.0, 3.0], np.float32)
    scene.background_plane_texture = Texture2D(checker_texture())
    return scene


def build_template(device: str = "cuda", dense: str | None = None):
    """``bench.build_template("textured")`` on the port: (template, name of
    the dense mesh)."""
    from ..context import init
    from ..parallel.batch import template_from_scene

    init(device=device)
    *meshes, name = load_meshes(dense)
    return template_from_scene(compose(meshes, device), device), name
