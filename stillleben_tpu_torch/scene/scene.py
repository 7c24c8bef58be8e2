"""A minimal host scene: what a batch template reads, and nothing else.

Holds objects (``assets.mesh.Mesh`` meshes with pose,
instance index, PBR overrides, shadow flag, static flag and mass
properties), the viewport and projection, lights, ambient light,
background colour and exposure, with the reference's defaults
(``stillleben_tpu/scene/scene.py:52-83``). ``compile_physics`` ports
``Scene._compile`` (:299-373) and ``default_floor`` ports
``Scene._default_floor`` (:408-411). The public ``Scene``/``Object`` API,
simulation calls and serialization are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..physics.bodies import (
    DEFAULT_DENSITY,
    aggregate_mass_properties,
    transform_hull,
    transform_mass_properties,
)
from ..physics.contacts import Floor, make_floor
from ..physics.tabletop import FLOOR_TOP_Z
from ..render.camera import DEFAULT_HFOV_DEG, projection_from_fov

NUM_LIGHTS = 3  # reference include/stillleben/common.h:17
# default physics material: a copy of stillleben_tpu/context.py:31-33
# (reference src/context.cpp:250-252)
DEFAULT_STATIC_FRICTION = 0.3
DEFAULT_DYNAMIC_FRICTION = 0.2
DEFAULT_RESTITUTION = 0.1


@dataclass
class Object:
    """A mesh instance: the fields of ``stillleben_tpu.Object`` a template
    reads. ``metallic``/``roughness`` of -1 mean no override. The physics
    material and density are the reference defaults."""

    mesh: object
    pose: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    instance_index: int = 0
    static: bool = False
    metallic: float = -1.0
    roughness: float = -1.0
    casts_shadows: bool = True

    def mass_properties(self):
        """(mass, com, inertia) in the mesh frame, pretransform applied."""
        self.mesh.load_physics()
        mass, com, inertia = aggregate_mass_properties(self.mesh._physics.hulls, DEFAULT_DENSITY)
        return transform_mass_properties(mass, com, inertia, self.mesh.pretransform)


class Scene:
    def __init__(self, viewport: tuple[int, int] = (640, 480)):
        """``viewport`` is (W, H), as in the reference's python binding."""
        self.viewport = (int(viewport[0]), int(viewport[1]))
        self.camera_pose = np.eye(4, dtype=np.float32)
        self.projection = projection_from_fov(
            math.radians(DEFAULT_HFOV_DEG), *self.viewport, device="cpu"
        ).numpy()
        self.objects: list[Object] = []
        self.light_directions = np.zeros((NUM_LIGHTS, 3), np.float32)
        self.light_colors = np.zeros((NUM_LIGHTS, 3), np.float32)
        self.light_colors[0] = 300.0  # radiance units (scene.h:226-230)
        self.ambient_light = np.zeros(3, np.float32)
        self.background_color = np.ones(4, np.float32)
        self.manual_exposure = -1.0

    def add_object(self, obj: Object) -> None:
        """Appends; an instance index of 0 becomes the 1-based position
        (reference src/scene.cpp:279-289)."""
        self.objects.append(obj)
        if obj.instance_index == 0:
            obj.instance_index = len(self.objects)

    def compile_physics(self) -> dict:
        """Padded physics arrays of the object set (scene.py:299-373), as
        numpy: hull lists, body parameters and tabletop geometry."""
        nb = max(len(self.objects), 1)
        hull_lists = []
        inv_mass = np.zeros(nb, np.float32)
        inv_inertia = np.tile(np.eye(3, dtype=np.float32), (nb, 1, 1))
        com = np.zeros((nb, 3), np.float32)
        friction = np.full(nb, 0.5, np.float32)
        friction_static = np.full(nb, 0.5, np.float32)
        restitution = np.zeros(nb, np.float32)
        vel_limit = np.full(nb, np.float32(3.4e38), np.float32)
        valid = np.zeros(nb, bool)
        kinematic = np.zeros(nb, bool)
        diameter = np.zeros(nb, np.float32)
        bbox_center = np.zeros((nb, 3), np.float32)
        dynamic = np.zeros(nb, bool)
        for i, o in enumerate(self.objects):
            o.mesh.load_physics()
            P = o.mesh.pretransform
            hull_lists.append([transform_hull(h, P) for h in o.mesh._physics.hulls])
            mass, c, inertia = o.mass_properties()
            if not o.static and mass > 0:
                inv_mass[i] = 1.0 / mass
                inv_inertia[i] = np.linalg.inv(inertia + 1e-12 * np.eye(3)).astype(np.float32)
            com[i] = c
            friction[i] = DEFAULT_DYNAMIC_FRICTION
            friction_static[i] = DEFAULT_STATIC_FRICTION
            restitution[i] = DEFAULT_RESTITUTION
            valid[i] = True
            kinematic[i] = o.static
            bbox = o.mesh.bbox
            diameter[i] = bbox.diagonal
            bbox_center[i] = bbox.center
            dynamic[i] = not o.static
        if not self.objects:
            hull_lists.append([])
        return dict(
            hull_lists=hull_lists,
            body_params=dict(
                inv_mass=inv_mass, inv_inertia_body=inv_inertia, com=com,
                friction=friction, friction_static=friction_static,
                restitution=restitution, linear_velocity_limit=vel_limit,
                valid=valid, kinematic=kinematic,
            ),
            tabletop_geom=dict(diameter=diameter, bbox_center=bbox_center, dynamic=dynamic),
        )

    def all_dynamic(self) -> bool:
        return all(not o.static for o in self.objects)

    def default_floor(self, device="cuda") -> Floor:
        """The tabletop floor, present only when every object is dynamic
        (scene.py:408-411)."""
        return make_floor(height=FLOOR_TOP_Z, enabled=self.all_dynamic(), friction=0.5,
                          restitution=0.0, device=device)
